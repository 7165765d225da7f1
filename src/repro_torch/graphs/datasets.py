"""Synthetic, stat-matched citation-network and power-law datasets.

Counterpart of ``repro.graphs.datasets`` (the in-memory registries; the
streamed generators come with a later slice). The generators are numpy and
draw from the same ``SeedSequence([crc32(name) & 0xFFFF, seed])`` stream in
the same order, so every array equals the JAX package's bit for bit.

Cora/CiteSeer/PubMed match the paper's §5 statistics (nodes / undirected
edges / feature dim / classes) with a planted-partition topology and
TF-IDF-like class-correlated sparse features; splits follow the standard
semi-supervised protocol (20 train nodes per class, 500 val, 1000 test).
"""

from __future__ import annotations

import zlib

import numpy as np

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
