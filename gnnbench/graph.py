"""The benchmark's traffic generator: a power-law graph drawn from a seed.

A copy of the numpy generator behind ``repro_torch.graphs.open_streamed``
(``StreamedPowerlaw.generate_block``), kept here so that the graph a cell
trains on is the benchmark's and not the program's; a CPU test holds the two
equal array for array. The graph is random-access by block: each block of
``block_size`` nodes draws from its own ``SeedSequence([name_key, seed,
block])`` its labels, its nodes' out-edges (Zipf degrees, capped; partners
within the node's class with probability ``p_intra``, drawn from the node's
own block), its TF-IDF-like features and its split coins.

``Traffic`` reads a traffic file (``gnnbench/traffic/<name>.json``): how
the graph is drawn (its degree law, block size, intra-class share and seed)
and how a training cell splits it (``chunks``, ``max_degree``), one epoch a
step. The graph's shape (``num_nodes``, ``num_features``,
``num_classes``) is the configuration's, which states it beside the
published graph it stands for. The graph is the cell's dataset and its seed
is the traffic's: every run trains the same graph, as a user's runs do, and
a run's ``--seed`` draws its weights and dropout masks. (With the graph
drawn from ``--seed`` too, a step's time on one H100 followed the seed's
graph: 7.31-7.65 s across six seeds of a 2^20-node graph against 0.1%
between two runs of one seed.) Nothing here
imports the program.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import zlib
from pathlib import Path

import numpy as np

# third SeedSequence word of the stream shared across blocks (the class topic
# vocabularies); it sits outside the block-index range
_TOPIC_SALT = 0x7F000001

# drawn as the traffic says; shaped as the configuration says
DRAW_KEYS = ("name", "zipf_a", "deg_cap", "seed", "block_size", "p_intra")
SHAPE_KEYS = ("num_nodes", "num_features", "num_classes")


@dataclasses.dataclass(frozen=True)
class PowerlawGraph:
    """One graph: ``block(b)`` gives block ``b``'s ``(labels, edges,
    features, train, val, test)``, drawn once and kept; ``edges`` are (m, 2)
    unique undirected pairs ``a < b`` in global indices whose source lies in
    the block (an edge drawn by both of its ends appears in both blocks)."""

    name: str
    num_nodes: int
    num_features: int
    num_classes: int
    zipf_a: float
    deg_cap: int
    seed: int
    block_size: int = 4096
    p_intra: float = 0.9

    @property
    def num_blocks(self) -> int:
        return -(-self.num_nodes // self.block_size)

    @property
    def name_key(self) -> int:
        # crc32, not hash(): str hashing is salted per process
        return zlib.crc32(self.name.encode()) & 0xFFFF

    @functools.cached_property
    def _topics(self) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.name_key, self.seed, _TOPIC_SALT]))
        topic_size = max(4, self.num_features // (2 * self.num_classes))
        return np.stack([rng.choice(self.num_features, size=topic_size, replace=False)
                         for _ in range(self.num_classes)])

    @functools.cached_property
    def _blocks(self) -> dict:
        return {}

    def block(self, b: int):
        if b not in self._blocks:
            self._blocks[b] = self._draw_block(b)
        return self._blocks[b]

    def _draw_block(self, b: int):
        if not 0 <= b < self.num_blocks:
            raise IndexError(f"block {b} out of range [0, {self.num_blocks})")
        rng = np.random.default_rng(np.random.SeedSequence([self.name_key, self.seed, b]))
        lo = b * self.block_size
        nb = min(self.block_size, self.num_nodes - lo)

        labels = rng.integers(0, self.num_classes, size=nb).astype(np.int64)

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
        a, bb = np.minimum(src, partners), np.maximum(src, partners)
        keep = a != bb
        # the program's np.unique(axis=0) of the (a, b) rows, as one sort of
        # int64 keys a·N + b: the same rows in the same order, a tenth of the time
        key = np.unique(a[keep] * np.int64(self.num_nodes) + bb[keep])
        edges = np.stack([key // self.num_nodes, key % self.num_nodes], axis=1)

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

        u = rng.random(nb)
        train = u < 0.10
        val = (u >= 0.10) & (u < 0.15)
        test = (u >= 0.15) & (u < 0.20)
        return labels, edges, feats, train, val, test

    def draw(self) -> "PowerlawGraph":
        """Draw every block now (the cell's set-up); returns ``self``."""
        for b in range(self.num_blocks):
            self.block(b)
        return self

    def nodes(self, lo: int, hi: int):
        """``(labels, features, train)`` of nodes ``[lo, hi)``."""
        parts = [[], [], []]
        for b in range(lo // self.block_size, -(-hi // self.block_size)):
            labels, _, feats, train, _, _ = self.block(b)
            s = slice(max(lo - b * self.block_size, 0), min(hi - b * self.block_size, len(labels)))
            for out, x in zip(parts, (labels, feats, train)):
                out.append(x[s])
        return tuple(np.concatenate(p) for p in parts)

    def edges_within(self, lo: int, hi: int) -> np.ndarray:
        """The undirected edges with both ends in ``[lo, hi)``, each once, as
        (m, 2) local indices ``a < b``."""
        found = []
        # an edge is drawn by one of its ends, so only blocks of the range hold it
        for b in range(lo // self.block_size, -(-hi // self.block_size)):
            e = self.block(b)[1]
            inside = (e[:, 0] >= lo) & (e[:, 1] < hi)
            found.append(e[inside] - lo)
        e = np.concatenate(found) if found else np.zeros((0, 2), dtype=np.int64)
        n = hi - lo
        key = np.unique(e[:, 0] * n + e[:, 1])
        return np.stack([key // n, key % n], axis=1)


@dataclasses.dataclass(frozen=True)
class Traffic:
    """A traffic file with its configuration's graph shape: the graph's
    parameters (``graph``) and its split into ``chunks`` sequential node
    ranges padded to ``max_degree`` neighbor slots."""

    name: str
    graph: dict
    chunks: int
    max_degree: int

    @classmethod
    def load(cls, path: Path, config: dict, overrides: dict | None = None) -> "Traffic":
        spec = json.loads(Path(path).read_text())
        graph = {k: spec["graph"][k] for k in DRAW_KEYS}
        graph.update((k, config[k]) for k in SHAPE_KEYS)
        graph.update((overrides or {}).get("graph", {}))
        return cls(name=Path(path).stem, graph=graph,
                   chunks=int(spec["chunks"]), max_degree=int(spec["max_degree"]))

    def make_graph(self) -> PowerlawGraph:
        return PowerlawGraph(**self.graph)

    def chunk_ranges(self) -> list[tuple[int, int]]:
        """``chunks`` near-equal contiguous node ranges covering the graph."""
        bounds = np.linspace(0, self.graph["num_nodes"], self.chunks + 1).astype(np.int64)
        return [(int(bounds[i]), int(bounds[i + 1])) for i in range(self.chunks)]
