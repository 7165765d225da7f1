"""Per-stage roofline accounting for the GNN pipeline's aggregation layouts.

Counterpart of ``repro.roofline.stage_report``. For each pipeline stage
the analytic *roof* is the floor cost of the stage's layers if aggregation
touched only the graph's LIVE edge slots (``_layer_roof``, the reference's
arithmetic, copied as it is). The padded layout materializes ``n_pad ·
max_deg`` slots per chunk; the degree-bucketed layout ``Σ rows_b ·
width_b``.

The reference sets the roof beside FLOPs and bytes walked out of XLA's
optimized HLO, which has no counterpart here. Instead, each row carries
the stage slice's (``make_gnn_stage_slices``) device time per chunk,
``measured_ms``, taken with CUDA events over CUDA-graph replays of the
slice over every chunk; ``roof_ms``, the larger of the roof's FLOPs over
the card's fp32 rate and its bytes over its memory rate (``HW``); and
``roof_share = roof_ms / measured_ms``. On the CPU the three are None: no
CPU time stands in for a device metric.

Everything is per (stage, chunk): the stage program processes one chunk per
dispatch, so live-slot counts are averaged over chunks.
"""

from __future__ import annotations

import torch

from repro_torch.graphs.data import BucketedGraphBatch, to_numpy
from repro_torch.models.gnn.net import (
    GNNModel,
    activation_widths,
    chunk_keys,
    make_gnn_stage_slices,
)
from repro_torch.roofline.analysis import HW

_F32 = 4  # bytes; the framework's layers run f32


def layout_slots(graph) -> int:
    """Neighbor slots the aggregation layout materializes per chunk:
    ``n_pad · max_deg`` for the padded layout, ``Σ rows_b · width_b`` for a
    degree-bucketed wrapper."""
    if isinstance(graph, BucketedGraphBatch):
        return int(sum(b.rows * b.width for b in graph.buckets))
    return int(graph.neighbors.shape[-2] * graph.neighbors.shape[-1])


def live_slots(graph) -> float:
    """Mean live (mask-True) neighbor slots per chunk — the roof's edge
    count: no layout can aggregate fewer slots and stay exact."""
    msk = to_numpy(graph.mask)
    chunks = msk.shape[0] if msk.ndim == 3 else 1
    return float(msk.sum()) / chunks


def _layer_roof(params: dict, n: int, live: float) -> tuple[float, float]:
    """(flops, bytes) floor for one layer at ``live`` aggregated slots.

    Recognizes the framework's layer param shapes: a 2-D ``w`` is a
    GCN/GraphConv-style transform + weighted-sum aggregate; a 3-D ``w`` is
    the multi-head GAT (transform, per-edge score, masked softmax,
    aggregate). Param-less layers (dropout/elu/log_softmax) are elementwise
    and contribute no flops floor.
    """
    w = params.get("w") if isinstance(params, dict) else None
    if w is None:
        return 0.0, 0.0
    if w.ndim == 2:
        d_in, d_out = w.shape
        flops = 2.0 * n * d_in * d_out + 2.0 * live * d_out
        byts = _F32 * (n * d_in + d_in * d_out + live * d_out + n * d_out)
        return flops, byts
    heads, d_in, d_out = w.shape
    flops = (
        2.0 * n * d_in * heads * d_out  # feature transform
        + 4.0 * n * heads * d_out  # a_src/a_dst score projections
        + 6.0 * live * heads  # leaky-relu + masked softmax per edge
        + 2.0 * live * heads * d_out  # attention-weighted aggregate
    )
    byts = _F32 * (
        n * d_in + heads * d_in * d_out + live * heads * (d_out + 1) + n * heads * d_out
    )
    return flops, byts


def device_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device ms per ``fn()`` call on the current CUDA device: ``iters``
    calls captured in a CUDA graph (after three warm-up calls on a side
    stream), the graph replayed ``reps`` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def stage_report(
    model: GNNModel,
    params: list,
    graph,
    balance: tuple[int, ...],
    *,
    train: bool = False,
) -> list[dict]:
    """Measured-vs-roof rows, one per pipeline stage.

    ``graph`` is a chunk-stacked batch (padded ``GraphBatch`` or its
    ``BucketedGraphBatch`` wrapper, leaves ``(chunks, n_pad, ...)``) on the
    params' device. Each stage slice is timed on that card (``device_ms``,
    its rates those of the card's own name) over every chunk, its input
    the previous stage's output on that chunk; the roof comes from
    ``_layer_roof`` at the graph's live slot count."""
    bounds = []
    lo = 0
    for b in balance:
        bounds.append((lo, lo + b))
        lo += b
    chunks = graph.features.shape[0]
    graphs = [graph.chunk(c) for c in range(chunks)]
    widths = activation_widths(model, params, graphs[0])
    slices = make_gnn_stage_slices(
        model, bounds, widths, graphs, chunk_keys(None, len(model.layers)), train=train
    )
    n_pad = graph.features.shape[1]
    live = live_slots(graph)
    device = graph.features.device
    card = HW.of(torch.cuda.get_device_name(device)) if device.type == "cuda" else None

    rows = []
    h_in = [None] * chunks  # each chunk's input to the stage being timed
    for s, fn in enumerate(slices):
        roof_flops = roof_bytes = 0.0
        for i in range(*bounds[s]):
            f, b = _layer_roof(params[i], n_pad, live)
            roof_flops += f
            roof_bytes += b
        row = {
            "stage": s,
            "layers": [model.layers[i].name for i in range(*bounds[s])],
            "roof_flops": roof_flops,
            "roof_bytes": roof_bytes,
            "measured_ms": None,
            "roof_ms": None,
            "roof_share": None,
        }
        with torch.no_grad():
            if card is not None:

                def every_chunk(fn=fn, h_in=list(h_in)):
                    for c in range(chunks):
                        fn(params, c, h_in[c])

                with torch.cuda.device(device):
                    row["measured_ms"] = device_ms(every_chunk, iters=10) / chunks
                row["roof_ms"] = max(roof_flops / card.fp32_flops,
                                     roof_bytes / card.hbm_bw) * 1e3
                row["roof_share"] = row["roof_ms"] / row["measured_ms"]
            h_in = [fn(params, c, h_in[c]) for c in range(chunks)]
        rows.append(row)
    return rows


def sparse_stage_report(
    model: GNNModel,
    params: list,
    padded_graph,
    bucketed_graph,
    balance: tuple[int, ...],
) -> dict:
    """The fig-row payload: per-stage measured-vs-roof for the padded layout
    next to the degree-bucketed one, plus the slot accounting that explains
    the gap (live edge slots vs each layout's materialized slots)."""
    padded = stage_report(model, params, padded_graph, balance)
    bucketed = stage_report(model, params, bucketed_graph, balance)
    slots = {
        "live": live_slots(padded_graph),
        "padded": layout_slots(padded_graph),
        "bucketed": layout_slots(bucketed_graph),
    }
    stages = [
        {
            "stage": p["stage"],
            "layers": p["layers"],
            "roof_flops": p["roof_flops"],
            "roof_bytes": p["roof_bytes"],
            "roof_ms": p["roof_ms"],
            "padded": {k: p[k] for k in ("measured_ms", "roof_share")},
            "bucketed": {k: b[k] for k in ("measured_ms", "roof_share")},
        }
        for p, b in zip(padded, bucketed)
    ]
    return {"slots": slots, "stages": stages}
