"""Micro-batching strategies for graph GPipe (paper §6–7 + §8 fixes).

Counterpart of ``repro.core.microbatch``. A strategy turns (graph, chunks)
into a list of ``MicroBatch`` items, each a self-contained sub-graph plus a
``core_mask`` selecting the nodes whose loss contributes:

  * ``sequential`` — the paper's behaviour (index split; cross-chunk edges
    silently dropped → Fig 4 accuracy collapse). Faithful baseline.
  * ``random``     — permuted index split; same information loss, controls
    for index locality.
  * ``greedy``     — edge-cut-aware partitioner (METIS stand-in).
  * ``halo``       — chunks carry their k-hop halo; aggregation is exact, so
    the accumulated gradient equals the full batch's.
  * ``sign``       — SIGN precompute; raises here as in the JAX package
    (``graphs/sign.py`` comes with a later slice).

Sub-graph construction runs in numpy on the host and is charged to
``rebuild_seconds`` (the paper's Fig 3 overhead).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.graphs import partition as P
from repro_torch.graphs.data import GraphBatch, pad_graph, stack_graphs, subgraph

STRATEGIES = ("sequential", "random", "greedy", "halo", "sign")


# eq=False: tensor fields have no truth value; identity is the contract
@dataclasses.dataclass(frozen=True, eq=False)
class MicroBatch:
    """One pipeline chunk: a sub-graph plus the mask of rows whose loss
    counts (halo rows ride along for exactness but never contribute)."""

    graph: GraphBatch
    core_mask: torch.Tensor  # (n_chunk,) bool — True where loss counts

    @property
    def num_nodes(self) -> int:
        """Node count of this chunk's sub-graph (halo included)."""
        return self.graph.num_nodes


@dataclasses.dataclass(frozen=True, eq=False)
class StackedPlan:
    """A MicroBatchPlan as one uniform-shape batch: every chunk padded to the
    same node count and neighbor width, then stacked on a leading chunk
    axis (the layout eval programs and ``bucketize_stacked`` take)."""

    graph: GraphBatch  # fields (chunks, n_pad, ...)
    core_mask: torch.Tensor  # (chunks, n_pad) bool
    chunks: int
    n_pad: int  # padded node count per chunk
    max_deg: int  # padded neighbor width per chunk


@dataclasses.dataclass
class MicroBatchPlan:
    """The partitioner's output: the ordered chunk list plus the accounting
    (rebuild cost, edge cut), with a lazily built stacked view."""

    strategy: str
    chunks: int
    batches: list[MicroBatch]
    rebuild_seconds: float  # host-side sub-graph construction cost (Fig 3)
    edge_cut: float  # fraction of edges lost (0 for halo)
    # init=False keeps the cache out of dataclasses.replace(): a replaced
    # plan starts with a fresh cache instead of one built from old batches
    _stacked: StackedPlan | None = dataclasses.field(
        default=None, repr=False, compare=False, init=False
    )

    def stacked(self) -> StackedPlan:
        """Emit (and cache) the stacked uniform-shape view: node counts and
        ``max_deg`` padded to the per-plan maxima."""
        if self._stacked is None:
            n_pad = max(mb.num_nodes for mb in self.batches)
            max_deg = max(mb.graph.max_degree for mb in self.batches)
            graphs, cores = [], []
            for mb in self.batches:
                graphs.append(pad_graph(mb.graph, n_pad, max_deg))
                pad = n_pad - mb.core_mask.shape[0]
                cores.append(
                    torch.nn.functional.pad(mb.core_mask, (0, pad)) if pad else mb.core_mask
                )
            self._stacked = StackedPlan(
                graph=stack_graphs(graphs),
                core_mask=torch.stack(cores),
                chunks=self.chunks,
                n_pad=n_pad,
                max_deg=max_deg,
            )
        return self._stacked


def make_plan(
    g: GraphBatch,
    chunks: int,
    *,
    strategy: str = "sequential",
    halo_hops: int = 2,
    seed: int = 0,
    pad_to_max: bool = True,
) -> MicroBatchPlan:
    """Build the micro-batch plan. ``pad_to_max`` pads every chunk to the
    largest chunk's node count so all chunks share one shape."""
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown strategy {strategy!r}; have {STRATEGIES}")
    if strategy == "sign":
        raise ValueError(
            "sign microbatching needs graphs/sign.py, which is not ported yet "
            "(see ROADMAP queue 1, item 4)"
        )

    t0 = time.perf_counter()
    if strategy == "random":
        parts = P.random_partition(g.num_nodes, chunks, seed=seed)
    elif strategy == "greedy":
        parts = P.greedy_partition(g, chunks, seed=seed)
    else:  # sequential, halo
        parts = P.sequential_partition(g.num_nodes, chunks)

    specs: list[tuple[np.ndarray, np.ndarray]] = []
    for part in parts:
        if strategy == "halo":
            specs.append(P.expand_halo(g, part, halo_hops))
        else:
            specs.append((part, np.ones(len(part), dtype=bool)))

    pad_n = max(len(nodes) for nodes, _ in specs) if pad_to_max else None
    batches: list[MicroBatch] = []
    for nodes, core in specs:
        if pad_n is not None:
            nodes, core = P.pad_partition(nodes, core, pad_n)
        # padded duplicates of node 0 must not train/eval either
        batches.append(
            MicroBatch(graph=subgraph(g, nodes), core_mask=torch.from_numpy(core).to(g.device))
        )
    rebuild_s = time.perf_counter() - t0

    cut = 0.0 if strategy == "halo" else P.edge_cut_fraction(g, parts)
    return MicroBatchPlan(
        strategy=strategy,
        chunks=chunks,
        batches=batches,
        rebuild_seconds=rebuild_s,
        edge_cut=cut,
    )
