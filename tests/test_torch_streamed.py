"""Streamed power-law graphs, their plan, the double-buffered loader and
one-card data parallelism in the port, on the CPU at small sizes.

Generation, plans and padded rows must equal the JAX package's exactly
(ints, bools and float32 bits). Inside the port, ``data_parallel=2`` must
give updates bit-identical to ``data_parallel=1`` and to host fill-drain,
with dropout on, for every scheduled executor; against the JAX compiled
engine at ``data_parallel=2`` on one CPU device (its single-replica
fallback) it is held within rtol/atol 1e-5 with dropout 0. The bit-identity
tests run under ``torch.use_deterministic_algorithms(True)``: the plain
backward's neighbor-gather index-put on the CPU sums in a thread-dependent
order at these sizes, even between two runs of one engine.
"""
# ruff: noqa: E402

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests

from _hypothesis_compat import given, settings, st  # optional-hypothesis shim

import repro.graphs as jg
from repro.core.pipeline import GPipeConfig as JConfig
from repro.core.pipeline import make_engine as j_make_engine
from repro.graphs import datasets as jds
from repro.launch import train as jlaunch
from repro.models.gnn import net as jnet
from repro.train import optimizer as jopt
import repro_torch.graphs as tg
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.core.schedule import Placement
from repro_torch.graphs import datasets as tds
from repro_torch.launch import train as tlaunch
from repro_torch.models.gnn import net as tnet
from repro_torch.models.gnn.convert import params_from_jax
from repro_torch.train import optimizer as topt

FIELDS = ("features", "neighbors", "mask", "norm", "labels", "train_mask", "val_mask",
          "test_mask", "node_ids")
TOL = dict(rtol=1e-5, atol=1e-5)


def same(got, want):
    """Exact equality, dtype and bits included, of a port array and a JAX one."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


def assert_batches_equal(tgraph, jgraph):
    for f in FIELDS:
        assert same(getattr(tgraph, f), getattr(jgraph, f)), f
    assert tgraph.num_classes == jgraph.num_classes


@pytest.fixture(scope="module")
def small():
    kw = dict(num_nodes=2048, block_size=512)
    return tg.open_streamed("powerlaw-64k", **kw), jg.open_streamed("powerlaw-64k", **kw)


# ------------------------------------------------------------ generation --


def test_registry_and_opening_match_jax():
    assert tg.STREAMED_DATASETS == jg.STREAMED_DATASETS
    assert tds._TOPIC_SALT == jds._TOPIC_SALT
    for name in tg.STREAMED_DATASETS:
        assert dataclasses.asdict(tg.open_streamed(name)) == dataclasses.asdict(
            jg.open_streamed(name))
    with pytest.raises(KeyError, match="unknown streamed dataset"):
        tg.open_streamed("powerlaw-2m")


@pytest.mark.parametrize("block", [0, 1, 3])
def test_generate_block_equals_jax(small, block):
    t, j = small
    for got, want in zip(t.generate_block(block), j.generate_block(block)):
        assert same(got, want)
    assert same(t._topics, j._topics)
    with pytest.raises(IndexError):
        t.generate_block(t.num_blocks)


@pytest.mark.parametrize("lo, hi", [(0, 512), (512, 1536), (100, 900), (1000, 2048), (0, 2048)])
def test_chunk_edges_and_batch_equal_jax(small, lo, hi):
    """Block-aligned and unaligned ranges: kept edges, drop counts and every
    field of the host batch (labels int32, node ids ``arange(lo, hi)``)."""
    t, j = small
    (t_edges, t_drop), (j_edges, j_drop) = t.chunk_edges(lo, hi), j.chunk_edges(lo, hi)
    assert same(t_edges, j_edges) and t_drop == j_drop
    for cap in (None, 16):
        tgraph = t.chunk_batch(lo, hi, max_degree=cap)
        assert_batches_equal(tgraph, j.chunk_batch(lo, hi, max_degree=cap))
        assert tgraph.device.type == "cpu" and tgraph.labels.dtype == torch.int32
        assert torch.equal(tgraph.node_ids, torch.arange(lo, hi, dtype=torch.int32))
    tg.validate_graph(tgraph)


def test_bad_ranges_raise_as_in_jax(small):
    t, _ = small
    for lo, hi in ((5, 5), (-1, 4), (0, t.num_nodes + 1)):
        with pytest.raises(ValueError, match="bad chunk range"):
            t.chunk_edges(lo, hi)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 60), st.integers(0, 150),
       st.sampled_from([None, 1, 3, 8]))
def test_padded_rows_from_edges_equal_jax(seed, n, m, cap):
    """Unique undirected edges without self-loops -> the same neighbors,
    mask and norm bits as the JAX twin, and as ``build_graph_batch``."""
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, n, size=(m, 2))
    pairs = np.sort(pairs[pairs[:, 0] != pairs[:, 1]], axis=1)
    edges = np.unique(pairs, axis=0) if len(pairs) else np.zeros((0, 2), dtype=np.int64)
    got = tds._padded_rows_from_edges(n, edges, cap)
    for a, b in zip(got, jds._padded_rows_from_edges(n, edges, cap)):
        assert same(a, b)
    assert isinstance(got[0], np.ndarray)
    ref = tg.build_graph_batch(np.zeros((n, 2), np.float32), edges, np.zeros(n, np.int64), 2,
                               max_degree=cap)
    assert np.array_equal(ref.neighbors.numpy(), got[0])
    assert np.array_equal(ref.mask.numpy(), got[1])
    assert same(ref.norm, got[2])


def test_seed_and_size_overrides(small):
    t, j = small
    assert t.num_nodes == 2048 and t.num_blocks == 4
    other = tg.open_streamed("powerlaw-64k", num_nodes=2048, block_size=512, seed=1)
    assert not np.array_equal(other.chunk_edges(0, 512)[0], t.chunk_edges(0, 512)[0])
    jother = jg.open_streamed("powerlaw-64k", num_nodes=2048, block_size=512, seed=1)
    assert_batches_equal(other.chunk_batch(300, 700), jother.chunk_batch(300, 700))


# ----------------------------------------------------------------- plans --


def test_streamed_plan_at_registry_size_equals_jax():
    """``streamed_plan(open_streamed("powerlaw-64k"), 8, max_degree=32)``:
    the edge cut and every field of every batch, at 65,536 nodes."""
    tplan = tg.streamed_plan(tg.open_streamed("powerlaw-64k"), 8, max_degree=32)
    jplan = jg.streamed_plan(jg.open_streamed("powerlaw-64k"), 8, max_degree=32)
    assert tplan.strategy == jplan.strategy == "streamed"
    assert tplan.chunks == jplan.chunks == 8 and tplan.edge_cut == jplan.edge_cut
    assert tplan.rebuild_seconds > 0
    for tb, jb in zip(tplan.batches, jplan.batches, strict=True):
        assert_batches_equal(tb.graph, jb.graph)
        assert same(tb.core_mask, jb.core_mask) and bool(tb.core_mask.all())
    stacked = tplan.stacked()
    assert stacked.graph.features.shape == (8, 8192, 64) and stacked.max_deg == 33


def test_streamed_plan_with_more_chunks_than_nodes_raises():
    ds = tg.open_streamed("powerlaw-64k", num_nodes=16, block_size=8)
    with pytest.raises(ValueError, match="bad chunk range"):
        tg.streamed_plan(ds, 17)


# ---------------------------------------------------------------- loader --


def test_loader_keeps_order_and_reads_one_item_ahead():
    pulled = []

    def source():
        for i in range(4):
            pulled.append(i)
            yield {"x": torch.full((3,), float(i)), "pair": (torch.arange(i + 1), i)}

    it = iter(tds.DoubleBufferedLoader(source(), device="cpu"))
    first = next(it)
    assert pulled == [0, 1]  # item t+1 read (and its copy issued) before t is handed over
    rest = list(it)
    assert pulled == [0, 1, 2, 3]
    items = [first, *rest]
    for i, item in enumerate(items):
        assert torch.equal(item["x"], torch.full((3,), float(i)))
        assert torch.equal(item["pair"][0], torch.arange(i + 1)) and item["pair"][1] == i
        assert not item["x"].is_pinned()


def test_loader_moves_graph_batches_and_passes_an_empty_source(small):
    t, _ = small
    batches = [t.chunk_batch(lo, hi) for lo, hi in t.chunk_ranges(3)]
    out = list(tg.DoubleBufferedLoader(iter(batches), device="cpu"))
    assert len(out) == 3
    for got, want in zip(out, batches):
        assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in FIELDS)
    assert list(tg.DoubleBufferedLoader([], device="cpu")) == []
    assert tds.DoubleBufferedLoader([])._device == torch.device("cuda")


# ---------------------------------------------------- data parallelism --


def _dp_fixture(chunks, kind="gcn"):
    """The reference's data-parallel fixture: 512 streamed nodes in blocks
    of 256, ``max_degree=16``, the GCN at hidden 16 and depth 2 (no dropout);
    ``kind="gat"`` is the paper GAT with dropout on, over the same plan."""
    plan = tg.streamed_plan(tg.open_streamed("powerlaw-64k", num_nodes=512, block_size=256),
                            chunks, max_degree=16)
    g0 = plan.batches[0].graph
    if kind == "gat":
        return plan, tnet.build_paper_gat(g0.num_features, g0.num_classes), (3, 3)
    return plan, tnet.build_gnn("gcn", g0.num_features, g0.num_classes, hidden=16, depth=2), (2, 2)


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _steps(model, plan, params, **config):
    eng = make_engine(model, GPipeConfig(chunks=plan.chunks, device="cpu", **config))
    opt = topt.adam(1e-2)
    state = opt.init(params)
    losses = []
    for step in range(2):
        params, state, loss = eng.train_step(params, state, plan, 42 + step, opt)
        losses.append(loss)
    return params, losses, eng


def test_data_parallel_validation():
    plan, model, balance = _dp_fixture(3)
    with pytest.raises(ValueError, match="data_parallel must be >= 1"):
        make_engine(model, GPipeConfig(balance=balance, chunks=4, engine="compiled",
                                       data_parallel=0, device="cpu"))
    with pytest.raises(ValueError, match="host"):
        make_engine(model, GPipeConfig(balance=balance, chunks=4, engine="host",
                                       data_parallel=2, device="cpu"))
    eng = make_engine(model, GPipeConfig(balance=balance, chunks=3, engine="compiled",
                                         schedule="1f1b", data_parallel=2, device="cpu"))
    assert eng.describe()["data_parallel"] == 2 and eng._data_parallel_active is False
    params = model.init_params(0)
    opt = topt.adam(1e-2)
    with pytest.raises(ValueError, match="split evenly"):
        eng.train_step(params, opt.init(params), plan, 0, opt)
    one = make_engine(model, GPipeConfig(balance=balance, chunks=3, engine="compiled",
                                         device="cpu"))
    assert "data_parallel" not in one.describe()


@pytest.mark.parametrize("kind", ["gcn", "gat"])
@pytest.mark.parametrize("schedule, rotation", [("fill_drain", 1), ("1f1b", None),
                                                ("zb-h1", None)])
def test_data_parallel_bit_identical_to_one_replica_and_host(deterministic, kind, schedule,
                                                            rotation):
    """Two steps: ``data_parallel=2`` gives ``data_parallel=1``'s losses and
    params bit for bit, and the host fill-drain's, with the GAT's dropout on
    (keyed masks) and fill-drain on a rotated ring."""
    plan, model, balance = _dp_fixture(4, kind)
    params = model.init_params(0)
    placement = None if rotation is None else Placement.ring(2, rotation=rotation)
    want, want_losses, _ = _steps(model, plan, params, balance=balance)
    runs = [_steps(model, plan, params, balance=balance, engine="compiled", schedule=schedule,
                   placement=placement, data_parallel=dp) for dp in (1, 2)]
    for got, losses, eng in runs:
        assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
        assert all(torch.equal(a[k], b[k]) for a, b in zip(got, want) for k in a)
        assert eng._data_parallel_active is False


def test_data_parallel_keeps_the_full_grid_on_a_plan_with_a_dead_chunk(deterministic):
    """A chunk with no training node: ``data_parallel=1`` drops its ticks,
    ``data_parallel=2`` runs them; the update is the same."""
    plan, model, balance = _dp_fixture(4)
    dead = dataclasses.replace(plan.batches[3].graph,
                               train_mask=torch.zeros_like(plan.batches[3].graph.train_mask))
    plan = dataclasses.replace(plan, batches=[*plan.batches[:3],
                                              dataclasses.replace(plan.batches[3], graph=dead)])
    params = model.init_params(0)
    ticks = []
    results = []
    for dp in (1, 2):
        eng = make_engine(model, GPipeConfig(balance=balance, chunks=4, engine="compiled",
                                             schedule="1f1b", data_parallel=dp, device="cpu"))
        opt = topt.adam(1e-2)
        stats: dict = {}
        results.append(eng.train_step(params, opt.init(params), plan, 7, opt, stats=stats))
        ticks.append(stats["num_ticks"])
    assert ticks[0] < ticks[1]
    (p1, _, l1), (p2, _, l2) = results
    assert torch.equal(l1, l2)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(p1, p2) for k in a)


def test_data_parallel_matches_jax_compiled_engine():
    """The port's ``data_parallel=2`` compiled 1F1B against the JAX compiled
    engine at ``data_parallel=2`` on one CPU device, 2 steps from the same
    params: losses and params within 1e-5."""
    plan, model, balance = _dp_fixture(4)
    jplan = jg.streamed_plan(jg.open_streamed("powerlaw-64k", num_nodes=512, block_size=256),
                             4, max_degree=16)
    g0 = jplan.batches[0].graph
    jm = jnet.build_gnn("gcn", g0.num_features, g0.num_classes, hidden=16, depth=2)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jeng = j_make_engine(jm, JConfig(engine="compiled", balance=balance, chunks=4,
                                     schedule="1f1b", data_parallel=2))
    teng = make_engine(model, GPipeConfig(engine="compiled", balance=balance, chunks=4,
                                          schedule="1f1b", data_parallel=2, device="cpu"))
    jo, to = jopt.adam(1e-2), topt.adam(1e-2)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(2):
        jp, js, jloss = jeng.train_step(jp, js, jplan, jax.random.PRNGKey(step), jo)
        tp, ts, tloss = teng.train_step(tp, ts, plan, step, to)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
        for t_layer, j_layer in zip(tp, jp):
            for k in t_layer:
                np.testing.assert_allclose(t_layer[k].numpy(), np.asarray(j_layer[k]), **TOL)
    assert jeng._data_parallel_active is teng._data_parallel_active is False


# ------------------------------------------------------------- the CLI --

CLI = ["--mode", "gnn", "--dataset", "powerlaw-64k", "--num-nodes", "4096", "--max-degree",
       "16", "--stages", "2", "--chunks", "4", "--epochs", "2", "--log-every", "0"]


@pytest.fixture(scope="module")
def jax_cli_result():
    """The JAX ``run_gnn`` on the same flags (one epoch: edge cut, chunks,
    mode and keys do not depend on it)."""
    args = types.SimpleNamespace(
        dataset="powerlaw-64k", num_nodes=4096, max_degree=16, stages=2, chunks=4, epochs=1,
        log_every=0, seed=0, strategy="sequential", engine="host", schedule="fill_drain",
        partition="uniform", placement=None, pipe_devices=None, backend="padded",
        data_parallel=1, overlap="off", auto=False, auto_budget=None, dry_run=False)
    return jlaunch.run_gnn(args)


@pytest.mark.parametrize("engine", ["host", "compiled"])
def test_train_cli_trains_a_streamed_graph(capsys, jax_cli_result, engine):
    out = tlaunch.main([*CLI, "--device", "cpu", "--engine", engine])
    assert out["mode"] == jax_cli_result["mode"] == "gpipe-streamed"
    assert out["edge_cut"] == jax_cli_result["edge_cut"]
    assert out["chunks"] == jax_cli_result["chunks"] == 4
    assert set(jax_cli_result) <= set(out)
    assert np.isfinite(out["epoch_losses"]).all() and np.isfinite(out["val_acc"])
    assert out["engine"] == engine and "strategy=streamed" in capsys.readouterr().out


def test_train_cli_streamed_refusals():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(CLI)
    with pytest.raises(ValueError, match="requires the pipeline path"):
        tlaunch.main([*CLI, "--stages", "1", "--device", "cpu"])
    with pytest.raises(ValueError, match="no full-graph batch"):
        tlaunch.main([*CLI, "--auto", "--device", "cpu"])
