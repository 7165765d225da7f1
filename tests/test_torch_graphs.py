"""The port's graph substrate against the JAX package's: datasets, subgraphs,
padding, ego-subgraphs and the degree-bucketed layout must give arrays that
are exactly equal (numpy generation and host-side layout on both sides)."""
# ruff: noqa: E402

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the JAX package is the reference
import repro.graphs as jg
from repro.graphs import data as jdata
from repro.graphs import partition as jpart
import repro_torch.graphs as tg
from repro_torch.graphs import data as tdata
from repro_torch.graphs import partition as tpart

FIELDS = ("features", "neighbors", "mask", "norm", "labels", "train_mask",
          "val_mask", "test_mask", "node_ids")


def assert_graph_equal(t, j):
    for f in FIELDS:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype, f
        assert a.shape == b.shape, f
        assert np.array_equal(a, b), f
    assert t.num_classes == j.num_classes


def assert_layout_equal(t, j):
    assert len(t.buckets) == len(j.buckets)
    for tb, jb in zip(t.buckets, j.buckets):
        for f in ("neighbors", "norm", "mask", "row_node"):
            a, b = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(t.gather_rows.numpy(), np.asarray(j.gather_rows))


@pytest.fixture(scope="module")
def graphs():
    return {name: (tg.load_dataset(name), jg.load_dataset(name))
            for name in ("karate", "cora", "skewed-mini")}


@pytest.mark.parametrize("name", ["karate", "cora", "skewed-mini"])
def test_load_dataset_exact(graphs, name):
    t, j = graphs[name]
    assert_graph_equal(t, j)
    tdata.validate_graph(t)


def test_load_dataset_max_degree_cap_exact():
    assert_graph_equal(tg.load_dataset("karate", max_degree=4, seed=3),
                       jg.load_dataset("karate", max_degree=4, seed=3))


def test_unknown_dataset_raises():
    with pytest.raises(KeyError, match="unknown dataset"):
        tg.load_dataset("nope")


@pytest.mark.parametrize("name", ["karate", "cora"])
def test_subgraph_and_pad_exact(graphs, name):
    t, j = graphs[name]
    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(t.num_nodes, size=t.num_nodes // 3, replace=False))
    ts, js = tdata.subgraph(t, idx), jdata.subgraph(j, idx)
    assert_graph_equal(ts, js)
    # subgraph() leaves holes: the mask is not a prefix
    m = ts.mask.numpy()
    assert (m[:, :-1] < m[:, 1:]).any()
    n_pad, w_pad = ts.num_nodes + 5, ts.max_degree + 3
    assert_graph_equal(tdata.pad_graph(ts, n_pad, w_pad), jdata.pad_graph(js, n_pad, w_pad))
    with pytest.raises(ValueError):
        tdata.pad_graph(ts, ts.num_nodes - 1, w_pad)


@pytest.mark.parametrize("seeds", [[0], [0, 33], [5, 6, 7]])
def test_ego_subgraph_exact(graphs, seeds):
    t, j = graphs["karate"]
    (ts, trows), (js, jrows) = tpart.ego_subgraph(t, seeds, 2), jpart.ego_subgraph(j, seeds, 2)
    assert_graph_equal(ts, js)
    assert np.array_equal(trows, jrows)
    assert list(ts.node_ids.numpy()[trows]) == seeds


def test_expand_halo_exact(graphs):
    t, j = graphs["cora"]
    core = np.arange(0, 200, 7)
    for hops in (0, 1, 2):
        tn, tc = tpart.expand_halo(t, core, hops)
        jn, jc = jpart.expand_halo(j, core, hops)
        assert np.array_equal(tn, jn) and np.array_equal(tc, jc)


@pytest.mark.parametrize("name", ["karate", "cora", "skewed-mini"])
def test_degree_bucketed_layout_exact(graphs, name):
    t, j = graphs[name]
    assert tpart.degree_bucket_widths(t.max_degree) == jpart.degree_bucket_widths(j.max_degree)
    assert_layout_equal(tpart.degree_bucketed_layout(t), jpart.degree_bucketed_layout(j))


def test_degree_bucketed_layout_of_holed_padded_subgraph_exact(graphs):
    t, j = graphs["cora"]
    idx = np.arange(0, t.num_nodes, 3)
    ts = tdata.pad_graph(tdata.subgraph(t, idx), len(idx) + 13, t.max_degree)
    js = jdata.pad_graph(jdata.subgraph(j, idx), len(idx) + 13, j.max_degree)
    caps = tuple(b.rows + 8 for b in tpart.degree_bucketed_layout(ts).buckets)
    assert_layout_equal(tpart.degree_bucketed_layout(ts, row_capacities=caps),
                        jpart.degree_bucketed_layout(js, row_capacities=caps))
    with pytest.raises(ValueError):
        tpart.degree_bucketed_layout(ts, row_capacities=(1,) * len(caps))


def test_bucketed_batch_delegates_and_moves(graphs):
    t, _ = graphs["skewed-mini"]
    layout = tpart.degree_bucketed_layout(t)
    assert layout.num_nodes == t.num_nodes and layout.features is t.features
    moved = layout.to("cpu")
    assert moved.buckets[0].rows == layout.buckets[0].rows
    # gather_rows and row_node are mutually inverse on real rows
    concat = torch.cat([b.row_node for b in layout.buckets])
    assert torch.equal(concat[layout.gather_rows.long()], torch.arange(t.num_nodes, dtype=torch.int32))


def test_stack_and_chunk_roundtrip(graphs):
    t, _ = graphs["karate"]
    subs = [tdata.pad_graph(tpart.ego_subgraph(t, [s], 2)[0], t.num_nodes, t.max_degree)
            for s in (0, 10, 20)]
    stacked = tdata.stack_graphs(subs)
    assert stacked.features.shape[0] == 3 and stacked.num_nodes == t.num_nodes
    for i, s in enumerate(subs):
        assert_graph_equal(stacked.chunk(i), s)


def test_validate_graph_rejects_broken_self_loop(graphs):
    t, _ = graphs["karate"]
    nbr = t.neighbors.clone()
    nbr[3, 0] = 4
    import dataclasses

    with pytest.raises(ValueError, match="self-loop"):
        tdata.validate_graph(dataclasses.replace(t, neighbors=nbr))
