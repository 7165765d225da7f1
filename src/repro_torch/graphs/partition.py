"""Halo expansion, ego-subgraphs and the degree-bucketed aggregation layout.

Counterpart of ``repro.graphs.partition`` (the serving slice's part; the
partitioners and ``bucketize_stacked`` come with the training slice).

``degree_bucketed_layout`` re-tiles the padded ``(n, max_deg)`` neighbor
matrix into geometric degree buckets (widths 8/16/32/…/max_deg): each row
moves to the narrowest bucket its live slot count fits, so aggregation work
scales with the degree distribution instead of the single worst-case degree.
All of it is host-side numpy, like ``subgraph``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.data import (
    BucketedGraphBatch,
    DegreeBucket,
    GraphBatch,
    subgraph,
    to_numpy,
)


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
