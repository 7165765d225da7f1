"""Synthetic, stat-matched citation-network and power-law datasets.

Counterpart of ``repro.graphs.datasets``: the in-memory registries, the
streamed power-law graphs (``open_streamed``) and the double-buffered
host-to-device loader. The generators are numpy and draw from the same
``SeedSequence`` streams in the same order as the JAX package's, so every
array equals its counterpart bit for bit.

Cora/CiteSeer/PubMed match the paper's §5 statistics (nodes / undirected
edges / feature dim / classes) with a planted-partition topology and
TF-IDF-like class-correlated sparse features; splits follow the standard
semi-supervised protocol (20 train nodes per class, 500 val, 1000 test).
"""

from __future__ import annotations

import dataclasses
import functools
import zlib

import numpy as np
import torch

from repro_torch.graphs.data import GraphBatch, build_graph_batch

# name: (num_nodes, num_undirected_edges, num_features, num_classes)
DATASETS: dict[str, tuple[int, int, int, int]] = {
    "cora": (2708, 5429, 1433, 7),
    "citeseer": (3312, 4732, 3703, 6),
    "pubmed": (19717, 44338, 500, 3),
    "reddit-mini": (8192, 131072, 300, 50),
    "karate": (34, 78, 34, 2),
}

# Power-law (Zipf) degree graphs: max_deg ≫ median_deg, the fixtures for the
# degree-bucketed sparse path.
# name: (num_nodes, num_features, num_classes, zipf_a, deg_cap)
SKEWED_DATASETS: dict[str, tuple[int, int, int, float, int]] = {
    "skewed-powerlaw": (8192, 64, 16, 1.7, 1024),
    "skewed-mini": (256, 16, 4, 1.7, 96),
}


def _powerlaw_edges(
    rng: np.random.Generator,
    labels: np.ndarray,
    *,
    zipf_a: float,
    deg_cap: int,
    p_intra: float,
) -> np.ndarray:
    """Undirected edges with Zipf-distributed target degrees (capped), each
    partner within-class with probability ``p_intra``."""
    n = labels.shape[0]
    by_class = [np.flatnonzero(labels == c) for c in range(labels.max() + 1)]
    target = np.minimum(rng.zipf(zipf_a, size=n), min(deg_cap, n - 1))
    edges: set[tuple[int, int]] = set()
    for i in range(n):
        want = int(target[i])
        intra = rng.random(want) < p_intra
        members = by_class[labels[i]]
        for k in range(want):
            j = int(members[rng.integers(0, len(members))]) if intra[k] else int(rng.integers(0, n))
            if i == j:
                continue
            edges.add((min(i, j), max(i, j)))
    return np.array(sorted(edges), dtype=np.int64)


def _planted_edges(rng: np.random.Generator, labels: np.ndarray, m: int, p_intra: float) -> np.ndarray:
    """Sample ~m unique undirected edges, p_intra of them within-class."""
    n = labels.shape[0]
    by_class = [np.flatnonzero(labels == c) for c in range(labels.max() + 1)]
    edges: set[tuple[int, int]] = set()
    while len(edges) < m:
        want = m - len(edges)
        intra = rng.random(want) < p_intra
        a = rng.integers(0, n, size=want)
        b = np.empty(want, dtype=np.int64)
        for k in range(want):
            if intra[k]:
                members = by_class[labels[a[k]]]
                b[k] = members[rng.integers(0, len(members))]
            else:
                b[k] = rng.integers(0, n)
        for x, y in zip(a, b):
            if x == y:
                continue
            edges.add((int(min(x, y)), int(max(x, y))))
    return np.array(sorted(edges), dtype=np.int64)[:m]


def _tfidf_features(
    rng: np.random.Generator,
    labels: np.ndarray,
    num_features: int,
    *,
    words_per_doc: int = 24,
    on_topic_frac: float = 0.17,
) -> np.ndarray:
    """Sparse bag-of-words-ish features with per-class topic vocabularies,
    row-normalized; the weak on-topic share makes aggregation necessary."""
    n = labels.shape[0]
    c = labels.max() + 1
    feats = np.zeros((n, num_features), dtype=np.float32)
    topic_size = max(4, num_features // (2 * c))
    topics = [rng.choice(num_features, size=topic_size, replace=False) for _ in range(c)]
    for i in range(n):
        k_topic = max(1, int(round(words_per_doc * on_topic_frac)))
        on_topic = topics[labels[i]][rng.integers(0, topic_size, size=k_topic)]
        off_topic = rng.integers(0, num_features, size=words_per_doc - k_topic)
        idx = np.concatenate([on_topic, off_topic])
        vals = rng.random(idx.shape[0]).astype(np.float32) + 0.5
        feats[i, idx] = vals
    row = feats.sum(axis=1, keepdims=True)
    row[row == 0] = 1.0
    return feats / row


def _standard_split(
    rng: np.random.Generator, labels: np.ndarray, *, per_class: int = 20, n_val: int = 500, n_test: int = 1000
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kipf & Welling split; tiny graphs keep ≥2/3 of each class out of train."""
    n = labels.shape[0]
    c = labels.max() + 1
    train = np.zeros(n, dtype=bool)
    for cls in range(c):
        members = np.flatnonzero(labels == cls)
        take = min(per_class, max(1, len(members) // 3))
        train[rng.choice(members, size=take, replace=False)] = True
    rest = np.flatnonzero(~train)
    rest = rng.permutation(rest)
    n_val = min(n_val, max(0, len(rest) - 1))
    n_test = min(n_test, max(0, len(rest) - n_val))
    val = np.zeros(n, dtype=bool)
    test = np.zeros(n, dtype=bool)
    val[rest[:n_val]] = True
    test[rest[n_val : n_val + n_test]] = True
    return train, val, test


def load_dataset(
    name: str,
    *,
    seed: int = 0,
    max_degree: int | None = None,
    p_intra: float = 0.9,
) -> GraphBatch:
    """Generate the stat-matched synthetic dataset ``name`` deterministically
    (on the CPU; move it with ``.to(device)``)."""
    if name not in DATASETS and name not in SKEWED_DATASETS:
        raise KeyError(
            f"unknown dataset {name!r}; have {sorted(DATASETS) + sorted(SKEWED_DATASETS)}"
        )
    # crc32, not hash(): str hashing is salted per process
    name_key = zlib.crc32(name.encode()) & 0xFFFF
    rng = np.random.default_rng(np.random.SeedSequence([name_key, seed]))
    if name in SKEWED_DATASETS:
        n, d, c, zipf_a, deg_cap = SKEWED_DATASETS[name]
        labels = rng.integers(0, c, size=n).astype(np.int64)
        edges = _powerlaw_edges(rng, labels, zipf_a=zipf_a, deg_cap=deg_cap, p_intra=p_intra)
    else:
        n, m, d, c = DATASETS[name]
        labels = rng.integers(0, c, size=n).astype(np.int64)
        edges = _planted_edges(rng, labels, m, p_intra)
    feats = _tfidf_features(rng, labels, d)
    train, val, test = _standard_split(rng, labels)
    return build_graph_batch(
        feats,
        edges,
        labels,
        c,
        train_mask=train,
        val_mask=val,
        test_mask=test,
        max_degree=max_degree,
    )


# ------------------------------------------------ streamed power-law graphs --
#
# The registries above generate the whole graph from one rng stream, so every
# node's data depends on every draw before it. The streamed generator is
# random-access by block: each block of ``block_size`` nodes owns an rng
# seeded ``[name_key, seed, block]`` and draws, in a fixed order, its labels,
# its nodes' out-edges, its features and its split coins. Any node range is
# materialized from the blocks it overlaps, never the whole graph, and a
# range's edge set is the restriction of any containing range's edge set.
# Intra-class partners come from the node's own block, so edge generation
# never needs another block's labels.

# name: (num_nodes, num_features, num_classes, zipf_a, deg_cap)
STREAMED_DATASETS: dict[str, tuple[int, int, int, float, int]] = {
    "powerlaw-64k": (65_536, 64, 16, 1.7, 48),
    "powerlaw-256k": (262_144, 64, 16, 1.7, 48),
    "powerlaw-1m": (1_048_576, 64, 16, 1.7, 48),
}

# third SeedSequence word of the stream shared across blocks (the class topic
# vocabularies); it sits outside the block-index range
_TOPIC_SALT = 0x7F000001


def _padded_rows_from_edges(
    n: int, edges: np.ndarray, max_degree: int | None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized twin of ``build_graph_batch``'s padded layout: unique
    undirected ``edges`` (m, 2) without self-loops -> numpy ``(neighbors,
    mask, norm)`` with the self-loop in slot 0, neighbors ascending,
    truncation keeping the lowest-index neighbors, and the GCN norm from the
    untruncated degree."""
    if len(edges):
        directed = np.concatenate([edges, edges[:, ::-1]])
        order = np.lexsort((directed[:, 1], directed[:, 0]))
        src, dst = directed[order, 0], directed[order, 1]
    else:
        src = dst = np.zeros(0, dtype=np.int64)
    deg_full = np.bincount(src, minlength=n)
    true_max = int(deg_full.max(initial=0))
    width = 1 + (true_max if max_degree is None else min(max_degree, true_max))

    # rank of each directed edge in its source's sorted run; the first
    # width - 1 are kept (build_graph_batch drops the highest indices)
    starts = np.concatenate([[0], np.cumsum(deg_full)[:-1]])
    rank = np.arange(len(src)) - starts[src]
    keep = rank < width - 1

    neighbors = np.zeros((n, width), dtype=np.int32)
    mask = np.zeros((n, width), dtype=bool)
    neighbors[:, 0] = np.arange(n)
    mask[:, 0] = True
    neighbors[src[keep], 1 + rank[keep]] = dst[keep]
    mask[src[keep], 1 + rank[keep]] = True

    inv_sqrt = 1.0 / np.sqrt(deg_full + 1.0)  # self-looped, untruncated
    norm = inv_sqrt[:, None] * inv_sqrt[neighbors] * mask
    return neighbors, mask, norm.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class StreamedPowerlaw:
    """A power-law graph generated lazily, one node block at a time.

    ``chunk_batch(lo, hi)`` materializes only the blocks overlapping
    ``[lo, hi)`` and returns a host ``GraphBatch`` of that range with
    boundary-crossing edges dropped (the paper's lossy sequential split,
    applied at generation time)."""

    name: str
    num_nodes: int
    num_features: int
    num_classes: int
    zipf_a: float
    deg_cap: int
    seed: int = 0
    block_size: int = 4096
    p_intra: float = 0.9

    @property
    def num_blocks(self) -> int:
        """Generator blocks covering the node axis (the last may be short)."""
        return -(-self.num_nodes // self.block_size)

    @property
    def _name_key(self) -> int:
        return zlib.crc32(self.name.encode()) & 0xFFFF

    def _block_rng(self, block: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self._name_key, self.seed, block]))

    @functools.cached_property
    def _topics(self) -> np.ndarray:
        """Per-class topic vocabularies shared by every block, from a stream
        of their own so blocks stay random-access."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self._name_key, self.seed, _TOPIC_SALT])
        )
        topic_size = max(4, self.num_features // (2 * self.num_classes))
        return np.stack([
            rng.choice(self.num_features, size=topic_size, replace=False)
            for _ in range(self.num_classes)
        ])

    def generate_block(self, block: int):
        """One block's node data, drawn in a fixed order from the block's rng
        (labels, out-edges, features, split coins): ``(labels, edges,
        features, train, val, test)``, ``edges`` (m, 2) unique undirected
        pairs in global indices whose source lies in this block."""
        if not 0 <= block < self.num_blocks:
            raise IndexError(f"block {block} out of range [0, {self.num_blocks})")
        rng = self._block_rng(block)
        lo = block * self.block_size
        nb = min(self.block_size, self.num_nodes - lo)

        labels = rng.integers(0, self.num_classes, size=nb).astype(np.int64)

        # Zipf out-degrees: each source repeated by its degree, one
        # intra/inter coin per slot, intra partners from the block's class
        target = np.minimum(rng.zipf(self.zipf_a, size=nb), min(self.deg_cap, self.num_nodes - 1))
        src_local = np.repeat(np.arange(nb), target)
        total = int(target.sum())
        intra = rng.random(total) < self.p_intra
        partners = rng.integers(0, self.num_nodes, size=total)
        src_labels = labels[src_local]
        for c in range(self.num_classes):
            sel = intra & (src_labels == c)
            if not sel.any():
                continue
            members = np.flatnonzero(labels == c) + lo
            partners[sel] = members[rng.integers(0, len(members), size=int(sel.sum()))]
        src = src_local + lo
        a, b = np.minimum(src, partners), np.maximum(src, partners)
        keep = a != b
        edges = (
            np.unique(np.stack([a[keep], b[keep]], axis=1), axis=0)
            if keep.any()
            else np.zeros((0, 2), dtype=np.int64)
        )

        # the _tfidf_features recipe, vectorized over the shared topics
        words, on_topic_frac = 24, 0.17
        k_topic = max(1, int(round(words * on_topic_frac)))
        topics = self._topics
        on = topics[labels[:, None], rng.integers(0, topics.shape[1], size=(nb, k_topic))]
        off = rng.integers(0, self.num_features, size=(nb, words - k_topic))
        idx = np.concatenate([on, off], axis=1)
        vals = (rng.random((nb, words)) + 0.5).astype(np.float32)
        feats = np.zeros((nb, self.num_features), dtype=np.float32)
        feats[np.arange(nb)[:, None], idx] = vals
        row = feats.sum(axis=1, keepdims=True)
        row[row == 0] = 1.0
        feats /= row

        # one uniform coin per node (the 20-per-class protocol needs every label)
        u = rng.random(nb)
        train = u < 0.10
        val = (u >= 0.10) & (u < 0.15)
        test = (u >= 0.15) & (u < 0.20)
        return labels, edges, feats, train, val, test

    def chunk_ranges(self, chunks: int) -> list[tuple[int, int]]:
        """``chunks`` near-equal contiguous node ranges covering the graph."""
        bounds = np.linspace(0, self.num_nodes, chunks + 1).astype(np.int64)
        return [(int(bounds[i]), int(bounds[i + 1])) for i in range(chunks)]

    @functools.cached_property
    def _edge_memo(self) -> dict:
        # a plan asks for a range's edges twice (batch and cut accounting)
        return {}

    def chunk_edges(self, lo: int, hi: int) -> tuple[np.ndarray, int]:
        """Edges of ``[lo, hi)`` in local indices, and the count of generated
        edges dropped for crossing the range boundary (the edge-cut
        numerator). Only the blocks overlapping the range are generated."""
        if not 0 <= lo < hi <= self.num_nodes:
            raise ValueError(f"bad chunk range [{lo}, {hi}) for {self.num_nodes} nodes")
        hit = self._edge_memo.get((lo, hi))
        if hit is not None:
            return hit
        parts, dropped = [], 0
        for blk in range(lo // self.block_size, -(-hi // self.block_size)):
            _, edges, *_ = self.generate_block(blk)
            within = (edges >= lo) & (edges < hi)
            touches = within.any(axis=1) if len(edges) else np.zeros(0, bool)
            inside = within.all(axis=1) if len(edges) else touches
            dropped += int(touches.sum() - inside.sum())
            parts.append(edges[inside])
        kept = np.concatenate(parts) if parts else np.zeros((0, 2), dtype=np.int64)
        # adjacent blocks can both source an edge that lands in the range
        kept = np.unique(kept, axis=0) if len(kept) else kept
        self._edge_memo[(lo, hi)] = (kept - lo, dropped)
        return kept - lo, dropped

    def chunk_batch(self, lo: int, hi: int, *, max_degree: int | None = None) -> GraphBatch:
        """Node range ``[lo, hi)`` as a host (CPU) ``GraphBatch``, boundary-
        crossing edges dropped; ``max_degree`` caps the padded neighbor
        width as ``build_graph_batch``'s parameter does."""
        feats, labels, train, val, test = [], [], [], [], []
        for blk in range(lo // self.block_size, -(-hi // self.block_size)):
            blk_lo = blk * self.block_size
            lab, _, f, tr, va, te = self.generate_block(blk)
            s = slice(max(lo - blk_lo, 0), min(hi - blk_lo, len(lab)))
            feats.append(f[s])
            labels.append(lab[s])
            train.append(tr[s])
            val.append(va[s])
            test.append(te[s])
        edges, _ = self.chunk_edges(lo, hi)
        neighbors, mask, norm = _padded_rows_from_edges(hi - lo, edges, max_degree)
        return GraphBatch(
            features=torch.from_numpy(np.concatenate(feats)),
            neighbors=torch.from_numpy(neighbors),
            mask=torch.from_numpy(mask),
            norm=torch.from_numpy(norm),
            labels=torch.from_numpy(np.concatenate(labels).astype(np.int32)),
            train_mask=torch.from_numpy(np.concatenate(train)),
            val_mask=torch.from_numpy(np.concatenate(val)),
            test_mask=torch.from_numpy(np.concatenate(test)),
            node_ids=torch.arange(lo, hi, dtype=torch.int32),
            num_classes=self.num_classes,
        )


def open_streamed(
    name: str,
    *,
    seed: int = 0,
    num_nodes: int | None = None,
    block_size: int = 4096,
    p_intra: float = 0.9,
) -> StreamedPowerlaw:
    """Open a ``STREAMED_DATASETS`` entry as a lazy block generator.
    ``num_nodes`` overrides the registry size; ``block_size`` never changes
    the data of a block-aligned range."""
    if name not in STREAMED_DATASETS:
        raise KeyError(f"unknown streamed dataset {name!r}; have {sorted(STREAMED_DATASETS)}")
    n, d, c, zipf_a, deg_cap = STREAMED_DATASETS[name]
    return StreamedPowerlaw(
        name=name,
        num_nodes=n if num_nodes is None else num_nodes,
        num_features=d,
        num_classes=c,
        zipf_a=zipf_a,
        deg_cap=deg_cap,
        seed=seed,
        block_size=block_size,
        p_intra=p_intra,
    )


class DoubleBufferedLoader:
    """Iterate host items (tensors, dataclasses of tensors such as
    ``GraphBatch`` and ``BucketedGraphBatch``, and tuples, lists or dicts of
    them) as items on ``device``, with item t+1's copy already issued when
    item t is handed over: two items in flight, never the whole stream.

    On a card each host item is pinned, copied with ``non_blocking=True`` on
    a dedicated copy stream, and an event is recorded behind its copies.
    Before an item is handed over, the consumer's current stream waits on
    that event and every copied tensor is ``record_stream``-ed on it, so the
    caching allocator does not reuse a buffer the consumer still reads. The
    pinned host item is held until its event has completed. With
    ``device="cpu"`` items pass through as they are."""

    def __init__(self, source, device="cuda"):
        self._source = source
        self._device = torch.device(device)
        self.copy_stream = None  # created when iteration starts on a card

    def __iter__(self):
        from repro_torch.core.cuda_graph import map_tensors, tree_tensors

        on_card = self._device.type == "cuda"
        # the dedicated copy stream, kept on the loader for its callers to see
        copy_stream = self.copy_stream = torch.cuda.Stream(self._device) if on_card else None
        in_flight: list = []  # (event, pinned host item) until its copy is done

        def put(item):
            if not on_card:  # CPU tensors stay where they are, unpinned
                return map_tensors(lambda t: t.to(self._device), item), None
            pinned = map_tensors(lambda t: t if t.is_pinned() else t.pin_memory(), item)
            with torch.cuda.stream(copy_stream):
                moved = map_tensors(lambda t: t.to(self._device, non_blocking=True), pinned)
                done = torch.cuda.Event()
                done.record(copy_stream)
            in_flight[:] = [(e, p) for e, p in in_flight if not e.query()]
            in_flight.append((done, pinned))
            return moved, done

        def hand_over(entry):
            moved, done = entry
            if done is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(done)
                for t in tree_tensors(moved):
                    t.record_stream(consumer)
            return moved

        it = iter(self._source)
        try:
            try:
                nxt = put(next(it))
            except StopIteration:
                return
            for item in it:
                cur, nxt = nxt, put(item)
                yield hand_over(cur)
            yield hand_over(nxt)
        finally:
            for done, _ in in_flight:
                done.synchronize()
