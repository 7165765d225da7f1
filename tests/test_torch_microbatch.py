"""The port's partitioners, micro-batch plans and stacked bucket layout
against the JAX package's: exact equality (host-side numpy on both sides,
so node sets, core masks, sub-graph arrays and bucket tiles match bit for
bit), on karate, cora and skewed-mini."""
# ruff: noqa: E402

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX package is the reference
import repro.graphs as jg
from repro.core import microbatch as jmb
from repro.graphs import partition as jpart
import repro_torch.graphs as tg
from repro_torch.core import microbatch as tmb
from repro_torch.graphs import partition as tpart

FIELDS = ("features", "neighbors", "mask", "norm", "labels", "train_mask",
          "val_mask", "test_mask", "node_ids")
DATASETS = ("karate", "cora", "skewed-mini")
STRATEGIES = ("sequential", "random", "greedy", "halo")


def equal(t, j, what=""):
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def graph_equal(t, j):
    for f in FIELDS:
        equal(getattr(t, f), getattr(j, f), f)


@pytest.fixture(scope="module")
def graphs():
    return {name: (tg.load_dataset(name), jg.load_dataset(name)) for name in DATASETS}


@pytest.fixture(scope="module")
def plans(graphs):
    """(port plan, JAX plan) by (dataset, strategy), built once per module."""
    cache = {}

    def get(name, strategy):
        if (name, strategy) not in cache:
            t, j = graphs[name]
            cache[name, strategy] = (tmb.make_plan(t, 4, strategy=strategy, seed=2),
                                     jmb.make_plan(j, 4, strategy=strategy, seed=2))
        return cache[name, strategy]

    return get


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("chunks", [2, 4])
def test_partitions_and_edge_cut_exact(graphs, name, chunks):
    t, j = graphs[name]
    n = t.num_nodes
    cases = [
        (tpart.sequential_partition(n, chunks), jpart.sequential_partition(n, chunks)),
        (tpart.random_partition(n, chunks, seed=3), jpart.random_partition(n, chunks, seed=3)),
        (tpart.greedy_partition(t, chunks, seed=1), jpart.greedy_partition(j, chunks, seed=1)),
    ]
    for tparts, jparts in cases:
        assert len(tparts) == len(jparts) == chunks
        for a, b in zip(tparts, jparts):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert tpart.edge_cut_fraction(t, tparts) == jpart.edge_cut_fraction(j, jparts)


def test_pad_partition_exact_and_rejects_oversize():
    nodes, core = np.array([4, 7, 9]), np.array([True, False, True])
    for a, b in zip(tpart.pad_partition(nodes, core, 6), jpart.pad_partition(nodes, core, 6)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    with pytest.raises(ValueError, match="exceeds pad target"):
        tpart.pad_partition(nodes, core, 2)


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_make_plan_chunks_and_core_masks_exact(plans, name, strategy):
    tp, jp = plans(name, strategy)
    assert (tp.strategy, tp.chunks, len(tp.batches)) == (jp.strategy, jp.chunks, len(jp.batches))
    assert tp.edge_cut == jp.edge_cut
    assert tp.rebuild_seconds > 0
    for tb, jb in zip(tp.batches, jp.batches):
        graph_equal(tb.graph, jb.graph)
        equal(tb.core_mask, jb.core_mask, "core_mask")
    ts, js = tp.stacked(), jp.stacked()
    assert (ts.chunks, ts.n_pad, ts.max_deg) == (js.chunks, js.n_pad, js.max_deg)
    graph_equal(ts.graph, js.graph)
    equal(ts.core_mask, js.core_mask, "stacked core_mask")
    assert tp.stacked() is ts  # cached


def test_halo_is_lossless_and_sequential_cuts_edges(graphs):
    t, _ = graphs["cora"]
    assert tmb.make_plan(t, 4, strategy="halo").edge_cut == 0.0
    assert tmb.make_plan(t, 4, strategy="sequential").edge_cut > 0.3
    unpadded = tmb.make_plan(t, 3, strategy="sequential", pad_to_max=False)
    assert sum(mb.num_nodes for mb in unpadded.batches) == t.num_nodes


def test_unknown_and_sign_strategies_raise(graphs):
    t, _ = graphs["karate"]
    with pytest.raises(KeyError, match="unknown strategy"):
        tmb.make_plan(t, 2, strategy="nope")
    with pytest.raises(ValueError, match="sign"):
        tmb.make_plan(t, 2, strategy="sign")


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("strategy", ["sequential", "halo"])
def test_bucketize_stacked_exact_and_chunks_slice(plans, name, strategy):
    tp, jp = plans(name, strategy)
    tsg, jsg = tp.stacked().graph, jp.stacked().graph
    tl, jl = tpart.bucketize_stacked(tsg), jpart.bucketize_stacked(jsg)
    assert len(tl.buckets) == len(jl.buckets)
    for tb, jb in zip(tl.buckets, jl.buckets):
        for f in ("neighbors", "norm", "mask", "row_node"):
            equal(getattr(tb, f), getattr(jb, f), f)
    equal(tl.gather_rows, jl.gather_rows, "gather_rows")
    # every chunk's tiles share one shape; chunk(c) is that chunk's own layout
    for c in range(4):
        chunk = tl.chunk(c)
        graph_equal(chunk.base, type(jsg)(**{
            f: np.asarray(getattr(jsg, f))[c] for f in FIELDS}, num_classes=jsg.num_classes))
        own = tpart.degree_bucketed_layout(
            tsg.chunk(c), tuple(b.width for b in tl.buckets),
            row_capacities=tuple(b.rows for b in chunk.buckets))
        for a, b in zip(chunk.buckets, own.buckets):
            assert torch.equal(a.neighbors, b.neighbors) and torch.equal(a.norm, b.norm)
        assert torch.equal(chunk.gather_rows, own.gather_rows)
