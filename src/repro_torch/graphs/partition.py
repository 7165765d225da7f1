"""Node partitioners, halo expansion, ego-subgraphs and the degree-bucketed
aggregation layout.

Counterpart of ``repro.graphs.partition``. ``sequential`` is the paper's
§6/§7.3 behaviour: GPipe splits the node-index tensor by position, so chunk
boundaries cut edges arbitrarily. ``greedy`` is an edge-cut-aware
partitioner (METIS stand-in). ``expand_halo`` grows a chunk by its k-hop
neighborhood so message passing stays exact.

``degree_bucketed_layout`` re-tiles the padded ``(n, max_deg)`` neighbor
matrix into geometric degree buckets (widths 8/16/32/…/max_deg): each row
moves to the narrowest bucket its live slot count fits, so aggregation work
scales with the degree distribution instead of the single worst-case degree;
``bucketize_stacked`` does it for a chunk-stacked batch with one set of
bucket capacities shared by every chunk. ``streamed_plan`` chunks a
streamed power-law graph (``graphs.datasets.open_streamed``) without ever
building it whole. All of it is host-side numpy, like ``subgraph``, and
gives the JAX package's arrays exactly.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.graphs.data import (
    BucketedGraphBatch,
    DegreeBucket,
    GraphBatch,
    subgraph,
    to_numpy,
)


def sequential_partition(num_nodes: int, chunks: int) -> list[np.ndarray]:
    """Index-sequential split — exactly what torchgpipe does to a tensor."""
    return [np.asarray(p) for p in np.array_split(np.arange(num_nodes), chunks)]


def random_partition(num_nodes: int, chunks: int, *, seed: int = 0) -> list[np.ndarray]:
    """Uniformly random node split — the locality-free baseline the greedy
    partitioner is compared against."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes)
    return [np.sort(p) for p in np.array_split(perm, chunks)]


def _adjacency_sets(g: GraphBatch) -> list[set[int]]:
    nbr = to_numpy(g.neighbors)
    msk = to_numpy(g.mask)
    return [
        set(int(j) for j, m in zip(nbr[i], msk[i]) if m and j != i)
        for i in range(nbr.shape[0])
    ]


def greedy_partition(g: GraphBatch, chunks: int, *, seed: int = 0) -> list[np.ndarray]:
    """Greedy BFS-grown balanced partitions (edge-cut-aware METIS stand-in).

    Grows each part from a random seed by BFS, preferring frontier nodes, so
    intra-part connectivity is much higher than an index split."""
    n = g.num_nodes
    adj = _adjacency_sets(g)
    rng = np.random.default_rng(seed)
    target = [len(p) for p in np.array_split(np.arange(n), chunks)]
    unassigned = set(range(n))
    parts: list[list[int]] = []
    order = rng.permutation(n)
    cursor = 0
    for c in range(chunks):
        part: list[int] = []
        frontier: list[int] = []
        while len(part) < target[c] and unassigned:
            if not frontier:
                # pick a fresh unassigned seed
                while cursor < n and order[cursor] not in unassigned:
                    cursor += 1
                if cursor >= n:
                    frontier = [next(iter(unassigned))]
                else:
                    frontier = [int(order[cursor])]
            node = frontier.pop()
            if node not in unassigned:
                continue
            unassigned.discard(node)
            part.append(node)
            frontier.extend(j for j in adj[node] if j in unassigned)
        parts.append(part)
    # dump any stragglers into the last part
    parts[-1].extend(unassigned)
    return [np.sort(np.array(p, dtype=np.int64)) for p in parts]


def pad_partition(
    nodes: np.ndarray, core: np.ndarray, n_pad: int
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a chunk's (nodes, core_mask) spec to ``n_pad`` entries by repeating
    node 0 with core_mask False — the padded duplicates lose their edges in
    ``subgraph()``'s remap and their loss mask is off, so they are inert.
    Uniform chunk sizes let every chunk share one shape."""
    extra = n_pad - len(nodes)
    if extra < 0:
        raise ValueError(f"chunk of {len(nodes)} nodes exceeds pad target {n_pad}")
    if extra == 0:
        return nodes, core
    nodes = np.concatenate([nodes, np.zeros(extra, dtype=nodes.dtype)])
    core = np.concatenate([core, np.zeros(extra, dtype=bool)])
    return nodes, core


def edge_cut_fraction(g: GraphBatch, parts: list[np.ndarray]) -> float:
    """Fraction of (directed, non-self) edge slots crossing part boundaries —
    the information the paper's sequential split throws away."""
    owner = np.empty(g.num_nodes, dtype=np.int64)
    for pid, p in enumerate(parts):
        owner[p] = pid
    nbr = to_numpy(g.neighbors)
    msk = to_numpy(g.mask).copy()
    msk[:, 0] = False  # ignore self-loops
    src_owner = np.broadcast_to(owner[:, None], nbr.shape)
    cut = (owner[nbr] != src_owner) & msk
    total = msk.sum()
    return float(cut.sum()) / float(max(total, 1))


def expand_halo(g: GraphBatch, core: np.ndarray, hops: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (nodes, core_mask): ``core`` plus its ``hops``-hop neighborhood.

    ``core_mask[i]`` is True iff nodes[i] is a core node. With hops == model
    receptive depth, aggregation on the halo'd sub-graph is exact for every
    core node."""
    nbr = to_numpy(g.neighbors)
    msk = to_numpy(g.mask)
    current = np.zeros(g.num_nodes, dtype=bool)
    current[core] = True
    reach = current.copy()
    for _ in range(hops):
        sel = np.flatnonzero(reach)
        hop = nbr[sel][msk[sel]]
        nxt = reach.copy()
        nxt[hop] = True
        reach = nxt
    nodes = np.flatnonzero(reach)
    core_mask = current[nodes]
    return nodes, core_mask


def ego_subgraph(g: GraphBatch, seeds, hops: int) -> tuple[GraphBatch, np.ndarray]:
    """The ``hops``-hop ego-subgraph around ``seeds`` plus the seeds' local
    row indices — the serving frontend's extraction step. With ``hops`` >=
    the model's receptive depth the halo is lossless."""
    seeds = np.asarray(seeds)
    nodes, _ = expand_halo(g, seeds, hops)
    sub = subgraph(g, nodes)
    # expand_halo's nodes are sorted ascending (flatnonzero)
    rows = np.searchsorted(nodes, seeds)
    return sub, rows


def degree_bucket_widths(max_deg: int, *, base: int = 8) -> tuple[int, ...]:
    """Geometric bucket-width ladder ``(base, 2·base, …, max_deg)``; the
    layout width ``max_deg`` is always the last rung."""
    if max_deg <= 0:
        raise ValueError(f"max_deg must be positive, got {max_deg}")
    widths: list[int] = []
    w = base
    while w < max_deg:
        widths.append(w)
        w *= 2
    widths.append(max_deg)
    return tuple(widths)


def degree_bucketed_layout(
    g: GraphBatch,
    widths: tuple[int, ...] | None = None,
    *,
    row_capacities: tuple[int, ...] | None = None,
    block: int = 8,
) -> BucketedGraphBatch:
    """Permute rows into degree buckets; carry the permutation + inverse.

    Each row's live slots are first compacted leftward (``subgraph()`` can
    leave holes), then the row goes to the narrowest bucket whose width
    covers its slot count (slot-less rows land in bucket 0 as inert rows).
    Each bucket is padded to a row capacity — a multiple of ``block``, or
    the caller's ``row_capacities``. ``row_node`` maps bucket row ->
    original row, ``gather_rows`` original row -> bucket-concat row.
    """
    nbr = to_numpy(g.neighbors)
    msk = to_numpy(g.mask)
    nrm = to_numpy(g.norm)
    n, max_deg = nbr.shape
    if widths is None:
        widths = degree_bucket_widths(max_deg)
    if widths[-1] < max_deg:
        raise ValueError(f"last bucket width {widths[-1]} < layout width {max_deg}")
    if row_capacities is not None and len(row_capacities) != len(widths):
        raise ValueError("row_capacities must match widths")

    # stable argsort of ~mask keeps live-slot order (self-loop first)
    order = np.argsort(~msk, axis=1, kind="stable")
    nbr = np.take_along_axis(nbr, order, axis=1)
    nrm = np.take_along_axis(nrm, order, axis=1)
    msk = np.take_along_axis(msk, order, axis=1)
    slots = msk.sum(axis=1)

    bucket_of = np.searchsorted(np.asarray(widths), slots)

    dev = g.device
    buckets: list[DegreeBucket] = []
    gather = np.zeros(n, dtype=np.int32)
    offset = 0
    for b, wb in enumerate(widths):
        rows = np.flatnonzero(bucket_of == b)
        if row_capacities is not None:
            cap = int(row_capacities[b])
        else:
            cap = -(-len(rows) // block) * block if len(rows) else 0
        if cap < len(rows):
            raise ValueError(f"bucket {b}: capacity {cap} < {len(rows)} rows")
        b_nbr = np.zeros((cap, wb), dtype=np.int32)
        b_nrm = np.zeros((cap, wb), dtype=nrm.dtype)
        b_msk = np.zeros((cap, wb), dtype=bool)
        b_row = np.zeros(cap, dtype=np.int32)
        b_nbr[: len(rows)] = nbr[rows, :wb]
        b_nrm[: len(rows)] = nrm[rows, :wb]
        b_msk[: len(rows)] = msk[rows, :wb]
        b_row[: len(rows)] = rows
        gather[rows] = offset + np.arange(len(rows), dtype=np.int32)
        buckets.append(
            DegreeBucket(
                neighbors=torch.from_numpy(b_nbr).to(dev),
                norm=torch.from_numpy(b_nrm).to(dev),
                mask=torch.from_numpy(b_msk).to(dev),
                row_node=torch.from_numpy(b_row).to(dev),
            )
        )
        offset += cap
    return BucketedGraphBatch(
        base=g, buckets=tuple(buckets), gather_rows=torch.from_numpy(gather).to(dev)
    )


def bucketize_stacked(
    g: GraphBatch, *, widths: tuple[int, ...] | None = None, block: int = 8
) -> BucketedGraphBatch:
    """Bucketize a chunk-stacked graph (leading ``chunks`` axis on every field).

    All chunks share one set of bucket row capacities (the per-bucket max
    over chunks, rounded up to ``block``), so every chunk's tiles have the
    same shapes and stack into ``(chunks, rows_b, width_b)`` tensors; take
    one chunk back out with ``BucketedGraphBatch.chunk``.
    """
    msk = to_numpy(g.mask)  # (chunks, n_pad, max_deg)
    chunks, _, max_deg = msk.shape
    if widths is None:
        widths = degree_bucket_widths(max_deg)
    slots = msk.sum(axis=2)  # (chunks, n_pad)
    bucket_of = np.searchsorted(np.asarray(widths), slots)
    caps = []
    for b in range(len(widths)):
        most = int((bucket_of == b).sum(axis=1).max())
        caps.append(-(-most // block) * block if most else 0)
    caps = tuple(caps)

    per_chunk = [
        degree_bucketed_layout(g.chunk(c), widths, row_capacities=caps, block=block)
        for c in range(chunks)
    ]
    stacked_buckets = tuple(
        DegreeBucket(
            neighbors=torch.stack([pc.buckets[b].neighbors for pc in per_chunk]),
            norm=torch.stack([pc.buckets[b].norm for pc in per_chunk]),
            mask=torch.stack([pc.buckets[b].mask for pc in per_chunk]),
            row_node=torch.stack([pc.buckets[b].row_node for pc in per_chunk]),
        )
        for b in range(len(widths))
    )
    gather = torch.stack([pc.gather_rows for pc in per_chunk])
    return BucketedGraphBatch(base=g, buckets=stacked_buckets, gather_rows=gather)


def streamed_plan(ds, chunks: int, *, max_degree: int | None = None):
    """Micro-batch plan over a ``StreamedPowerlaw``: ``chunks`` contiguous
    node ranges, each materialized on the host by ``ds.chunk_batch``, so the
    whole graph never exists in memory. The streamed analogue of
    ``make_plan(strategy="sequential")``: the same lossy boundaries, all-core
    masks and plan container. ``edge_cut`` comes from the generator's drop
    counts (edges with exactly one endpoint inside a chunk)."""
    from repro_torch.core.microbatch import MicroBatch, MicroBatchPlan

    t0 = time.perf_counter()
    batches, kept, dropped = [], 0, 0
    for lo, hi in ds.chunk_ranges(chunks):
        g = ds.chunk_batch(lo, hi, max_degree=max_degree)
        _, d = ds.chunk_edges(lo, hi)
        kept += (int(g.mask.sum()) - g.num_nodes) // 2  # directed slots, no self-loops
        dropped += d
        batches.append(MicroBatch(graph=g, core_mask=torch.ones(g.num_nodes, dtype=torch.bool)))
    return MicroBatchPlan(
        strategy="streamed",
        chunks=chunks,
        batches=batches,
        rebuild_seconds=time.perf_counter() - t0,
        edge_cut=float(dropped) / float(max(kept + dropped, 1)),
    )
