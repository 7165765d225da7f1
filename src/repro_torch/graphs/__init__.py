"""Graph substrate: padded/bucketed batch layouts, the paper datasets, the
streamed power-law generator and its loader, the chunk partitioners and the
halo/ego/bucket helpers."""

from repro_torch.graphs.data import (
    BucketedGraphBatch,
    DegreeBucket,
    GraphBatch,
    build_graph_batch,
    pad_graph,
    stack_graphs,
    subgraph,
    validate_graph,
)
from repro_torch.graphs.datasets import (
    DATASETS,
    SKEWED_DATASETS,
    STREAMED_DATASETS,
    DoubleBufferedLoader,
    StreamedPowerlaw,
    load_dataset,
    open_streamed,
)
from repro_torch.graphs.partition import (
    bucketize_stacked,
    degree_bucket_widths,
    degree_bucketed_layout,
    ego_subgraph,
    expand_halo,
    streamed_plan,
)

__all__ = [
    "GraphBatch",
    "BucketedGraphBatch",
    "DegreeBucket",
    "build_graph_batch",
    "subgraph",
    "pad_graph",
    "stack_graphs",
    "validate_graph",
    "load_dataset",
    "open_streamed",
    "streamed_plan",
    "DATASETS",
    "SKEWED_DATASETS",
    "STREAMED_DATASETS",
    "StreamedPowerlaw",
    "DoubleBufferedLoader",
    "expand_halo",
    "ego_subgraph",
    "degree_bucket_widths",
    "degree_bucketed_layout",
    "bucketize_stacked",
]
