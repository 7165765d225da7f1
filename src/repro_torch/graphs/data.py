"""Graph containers in the padded-neighbor layout, as tensors.

Counterpart of ``repro.graphs.data``. Every node's neighborhood is padded to
a fixed width ``max_deg``:

    neighbors : (n, max_deg) int32   — column j is the j-th neighbor of node i
    mask      : (n, max_deg) bool    — False on padding slots
    norm      : (n, max_deg) float32 — GCN symmetric-normalization 1/sqrt(d_i d_j)

Slot 0 holds the self-loop. Construction (``build_graph_batch``,
``subgraph``) runs in numpy on the host and computes ``norm`` in float64
before the cast, exactly as the JAX package does, so the arrays are equal
bit for bit. ``stack_graphs`` adds a leading chunk axis to equal-shape
batches; ``GraphBatch.chunk`` takes one back out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_FIELDS = (
    "features",
    "neighbors",
    "mask",
    "norm",
    "labels",
    "train_mask",
    "val_mask",
    "test_mask",
    "node_ids",
)


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A (sub)graph in padded-neighbor layout; optionally chunk-stacked
    (every field then carries a leading ``chunks`` axis)."""

    features: torch.Tensor  # (n, d) float32
    neighbors: torch.Tensor  # (n, max_deg) int32, local indices; 0 on padding
    mask: torch.Tensor  # (n, max_deg) bool
    norm: torch.Tensor  # (n, max_deg) float32 GCN coefficients
    labels: torch.Tensor  # (n,) int32
    train_mask: torch.Tensor  # (n,) bool
    val_mask: torch.Tensor  # (n,) bool
    test_mask: torch.Tensor  # (n,) bool
    node_ids: torch.Tensor  # (n,) int32 global ids
    num_classes: int = 2

    @property
    def num_nodes(self) -> int:
        """Rows in the batch (padding rows included once padded)."""
        return self.features.shape[-2]

    @property
    def max_degree(self) -> int:
        """Width of the padded neighbor table (slot 0 is the self-loop)."""
        return self.neighbors.shape[-1]

    @property
    def num_features(self) -> int:
        """Feature dimensionality."""
        return self.features.shape[-1]

    @property
    def device(self) -> torch.device:
        """Device every field lives on."""
        return self.features.device

    def _map(self, fn) -> "GraphBatch":
        return GraphBatch(
            **{f: fn(getattr(self, f)) for f in _FIELDS}, num_classes=self.num_classes
        )

    def to(self, device) -> "GraphBatch":
        """The same batch with every field on ``device``."""
        return self._map(lambda t: t.to(device))

    def chunk(self, i: int) -> "GraphBatch":
        """Chunk ``i`` of a chunk-stacked batch."""
        return self._map(lambda t: t[i])


@dataclasses.dataclass(frozen=True)
class DegreeBucket:
    """One degree bucket: a dense ``(rows_b, width_b)`` neighbor tile.

    Padding rows are inert (mask all False, norm 0); ``neighbors`` indexes
    the ORIGINAL node numbering and ``row_node`` names the original row each
    tile row holds.
    """

    neighbors: torch.Tensor  # (rows_b, width_b) int32
    norm: torch.Tensor  # (rows_b, width_b) float32
    mask: torch.Tensor  # (rows_b, width_b) bool
    row_node: torch.Tensor  # (rows_b,) int32

    @property
    def width(self) -> int:
        """Neighbor-slot width of this bucket's tile."""
        return self.neighbors.shape[-1]

    @property
    def rows(self) -> int:
        """Row capacity of this bucket's tile (padding rows included)."""
        return self.neighbors.shape[-2]

    def to(self, device) -> "DegreeBucket":
        """The same bucket on ``device``."""
        return DegreeBucket(*(t.to(device) for t in dataclasses.astuple(self)))


@dataclasses.dataclass(frozen=True)
class BucketedGraphBatch:
    """A GraphBatch plus its degree-bucketed aggregation layout.

    Attribute access falls through to ``base``, so consumers of the padded
    layout work unchanged while the kernel backend picks up ``buckets`` /
    ``gather_rows`` (node i's output lives at concat-row ``gather_rows[i]``).
    """

    base: GraphBatch
    buckets: tuple[DegreeBucket, ...]
    gather_rows: torch.Tensor  # (n,) int32 into the bucket-concat row space

    def __getattr__(self, name):
        # only reached when normal lookup fails -> delegate to the base batch
        return getattr(object.__getattribute__(self, "base"), name)

    def to(self, device) -> "BucketedGraphBatch":
        """The same layout with every tensor on ``device``."""
        return BucketedGraphBatch(
            self.base.to(device),
            tuple(b.to(device) for b in self.buckets),
            self.gather_rows.to(device),
        )


def stack_graphs(graphs) -> GraphBatch:
    """Stack equal-shape batches along a new leading chunk axis."""
    graphs = list(graphs)
    return GraphBatch(
        **{f: torch.stack([getattr(g, f) for g in graphs]) for f in _FIELDS},
        num_classes=graphs[0].num_classes,
    )


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy view (or copy, for a device tensor) of ``t``; callers
    only read it."""
    return t.detach().cpu().numpy()


def _edges_to_adj_lists(num_nodes: int, edges: np.ndarray) -> list[list[int]]:
    """Undirected edge list (m, 2) -> per-node sorted neighbor lists."""
    adj: list[set[int]] = [set() for _ in range(num_nodes)]
    for a, b in edges:
        a, b = int(a), int(b)
        if a == b:
            continue
        adj[a].add(b)
        adj[b].add(a)
    return [sorted(s) for s in adj]


def build_graph_batch(
    features: np.ndarray,
    edges: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    *,
    train_mask: np.ndarray | None = None,
    val_mask: np.ndarray | None = None,
    test_mask: np.ndarray | None = None,
    max_degree: int | None = None,
    dtype: torch.dtype = torch.float32,
) -> GraphBatch:
    """Build a GraphBatch (on the CPU) from a numpy undirected edge list.

    ``max_degree`` caps the padded width (excess neighbors dropped
    deterministically, highest-index first); default is the true max degree.
    Slot 0 always holds the self-loop.
    """
    n = features.shape[0]
    adj = _edges_to_adj_lists(n, edges)
    true_max = max((len(a) for a in adj), default=0)
    width = 1 + (true_max if max_degree is None else min(max_degree, true_max))

    neighbors = np.zeros((n, width), dtype=np.int32)
    mask = np.zeros((n, width), dtype=bool)
    deg = np.array([len(a) for a in adj], dtype=np.float64) + 1.0  # self-loop

    for i, nbrs in enumerate(adj):
        nbrs = nbrs[: width - 1]
        neighbors[i, 0] = i
        mask[i, 0] = True
        neighbors[i, 1 : 1 + len(nbrs)] = nbrs
        mask[i, 1 : 1 + len(nbrs)] = True

    # GCN symmetric normalization over the self-looped graph, in float64
    inv_sqrt = 1.0 / np.sqrt(deg)
    norm = inv_sqrt[:, None] * inv_sqrt[neighbors] * mask

    def _m(m):
        return torch.from_numpy(
            np.ones(n, dtype=bool) if m is None else np.asarray(m, dtype=bool)
        )

    return GraphBatch(
        features=torch.as_tensor(np.asarray(features), dtype=dtype),
        neighbors=torch.from_numpy(neighbors),
        mask=torch.from_numpy(mask),
        norm=torch.from_numpy(norm).to(dtype),
        labels=torch.as_tensor(np.asarray(labels), dtype=torch.int32),
        train_mask=_m(train_mask),
        val_mask=_m(val_mask),
        test_mask=_m(test_mask),
        node_ids=torch.arange(n, dtype=torch.int32),
        num_classes=int(num_classes),
    )


def subgraph(g: GraphBatch, node_idx: np.ndarray) -> GraphBatch:
    """Re-build the sub-graph induced by ``node_idx`` (the paper's §6 step).

    Every edge with an endpoint outside ``node_idx`` is dropped; kept slots
    keep their column, so the mask may have holes. Host-side numpy, like
    the JAX counterpart; the result lives on ``g``'s device.
    """
    node_idx = np.asarray(node_idx)
    n_sub = node_idx.shape[0]
    old_neighbors = to_numpy(g.neighbors)[node_idx]
    old_mask = to_numpy(g.mask)[node_idx]

    # global -> local remap; -1 marks "outside the chunk"
    remap = -np.ones(g.num_nodes, dtype=np.int64)
    remap[node_idx] = np.arange(n_sub)

    local = remap[old_neighbors]
    keep = old_mask & (local >= 0)
    local = np.where(keep, local, 0)

    deg = keep.sum(axis=1).astype(np.float64)  # includes self-loop
    inv_sqrt = np.zeros_like(deg)
    nz = deg > 0
    inv_sqrt[nz] = 1.0 / np.sqrt(deg[nz])
    norm = inv_sqrt[:, None] * inv_sqrt[local] * keep

    idx = torch.from_numpy(node_idx.astype(np.int64)).to(g.device)
    dev = g.device
    return GraphBatch(
        features=g.features[idx],
        neighbors=torch.from_numpy(local.astype(np.int32)).to(dev),
        mask=torch.from_numpy(keep).to(dev),
        norm=torch.from_numpy(norm).to(device=dev, dtype=g.norm.dtype),
        labels=g.labels[idx],
        train_mask=g.train_mask[idx],
        val_mask=g.val_mask[idx],
        test_mask=g.test_mask[idx],
        node_ids=g.node_ids[idx],
        num_classes=g.num_classes,
    )


def _pad_to(t: torch.Tensor, shape: tuple[int, ...], fill=0) -> torch.Tensor:
    out = torch.full(shape, fill, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, s) for s in t.shape)] = t
    return out


def pad_graph(g: GraphBatch, n_pad: int, max_deg: int) -> GraphBatch:
    """Pad a (sub)graph to exactly ``n_pad`` nodes and ``max_deg`` neighbor
    slots so chunks of different sizes stack into one uniform shape.

    Extra rows are isolated non-nodes (mask False everywhere, so even the
    self-loop is absent; zero norm, label 0, split masks False, node_id -1).
    Extra neighbor columns are padding slots (mask False, norm 0).
    """
    n, w = g.num_nodes, g.max_degree
    if n_pad < n or max_deg < w:
        raise ValueError(f"pad target ({n_pad}, {max_deg}) smaller than graph ({n}, {w})")
    if n_pad == n and max_deg == w:
        return g

    def rows(t, fill=0):
        return _pad_to(t, (n_pad,) + tuple(t.shape[1:]), fill)

    def slots(t):
        return _pad_to(t, (n_pad, max_deg))

    return GraphBatch(
        features=rows(g.features),
        neighbors=slots(g.neighbors),
        mask=slots(g.mask),
        norm=slots(g.norm),
        labels=rows(g.labels),
        train_mask=rows(g.train_mask),
        val_mask=rows(g.val_mask),
        test_mask=rows(g.test_mask),
        node_ids=rows(g.node_ids, fill=-1),
        num_classes=g.num_classes,
    )


def validate_graph(g: GraphBatch) -> None:
    """Structural invariants (used by tests and the data pipeline); raises
    ``ValueError`` on the first one that fails."""
    n, w = g.neighbors.shape
    shapes = {
        "mask": (g.mask.shape, (n, w)),
        "norm": (g.norm.shape, (n, w)),
        "features rows": (g.features.shape[:1], (n,)),
        "labels": (g.labels.shape, (n,)),
    }
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name} shape {tuple(got)} != {want}")
    nbr, msk = to_numpy(g.neighbors), to_numpy(g.mask)
    if nbr.size and (nbr.min() < 0 or nbr.max() >= max(n, 1)):
        raise ValueError("neighbor index out of range")
    if np.any(to_numpy(g.norm)[~msk] != 0):
        raise ValueError("norm must be 0 on padding")
    # self-loop in slot 0 wherever the node has any edge slot at all
    has_any = msk.any(axis=1)
    if not np.all(nbr[has_any, 0] == np.arange(n)[has_any]):
        raise ValueError("slot 0 must be the self-loop")
