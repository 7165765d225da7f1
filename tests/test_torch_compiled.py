"""The compiled single-program engine of the port, on the CPU at small sizes.

Inside the port, the compiled engine must give updates, losses and evals
bit-identical to the host engine's fill-drain, with dropout on, for every
schedule and rotated placement. Against the JAX package it is held to the
JAX ``CompiledGNNPipeline`` on one CPU device (its lanes executor; fill-drain
there runs the fused chunk scan) with params from ``params_from_jax`` and
dropout 0: params, losses and eval log-probs within rtol/atol 1e-5 (the two
frameworks sum in other orders). Layout data (stage widths, the lowered
timeline's accounting) must match exactly.
"""
# ruff: noqa: E402

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests

import repro.graphs as jg
from repro.core import microbatch as jmb
from repro.core import schedule as jsched
from repro.core.pipeline import GPipeConfig as JConfig
from repro.core.pipeline import make_engine as j_make_engine
from repro.models.gnn import net as jnet
from repro.train import optimizer as jopt
import repro_torch.graphs as tg
from repro_torch.core import microbatch as tmb
from repro_torch.core import schedule as tsched
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.core.schedule import Placement
from repro_torch.core.spmd_pipe import (
    _eval_out_slot,
    spmd_pipeline_scheduled_eval_lanes,
    spmd_pipeline_scheduled_lanes,
)
from repro_torch.graphs import partition as tpart
from repro_torch.graphs.data import subgraph
from repro_torch.launch import train as tlaunch
from repro_torch.models.gnn import net as tnet
from repro_torch.models.gnn.convert import params_from_jax
from repro_torch.train import optimizer as topt

TOL = dict(rtol=1e-5, atol=1e-5)
SCHEDULES = ("fill_drain", "gpipe", "1f1b", "interleaved", "zb-h1", "zb-v")
BALANCE = (2, 1, 1, 2)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def trees_equal(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


@pytest.fixture(scope="module")
def karate():
    return tg.load_dataset("karate")


def _model(kind, g):
    """The compiled engine's test models, dropout on where the backend has it."""
    if kind == "gat-padded":
        return tnet.build_paper_gat(g.num_features, g.num_classes), BALANCE, "padded"
    if kind == "gat-kernel":  # the fused kernel takes no attention dropout
        return (tnet.build_paper_gat(g.num_features, g.num_classes, backend="kernel",
                                     attn_dropout=0.0), BALANCE, "kernel")
    return (tnet.build_imbalanced_gcn(g.num_features, g.num_classes, hidden=(32, 32, 8),
                                      backend="kernel"), (2, 1, 1, 1), "kernel")


def _train(model, balance, backend, plan, *, engine, schedule="fill_drain", placement=None,
           steps=3, stats=None):
    nd = 2 if schedule in ("interleaved", "zb-v") else None
    eng = make_engine(model, GPipeConfig(balance=balance, chunks=plan.chunks, schedule=schedule,
                                         num_devices=nd, placement=placement, engine=engine,
                                         backend=backend, device="cpu"))
    opt = topt.adam(5e-3, weight_decay=5e-4)
    params = model.init_params(0)
    state = opt.init(params)
    losses = []
    for step in range(steps):
        params, state, loss = eng.train_step(params, state, plan, 11 + step, opt, stats=stats)
        losses.append(loss)
    return params, losses, eng


_HOST: dict = {}


def _host_run(kind, g, plan):
    if kind not in _HOST:
        model, balance, backend = _model(kind, g)
        _HOST[kind] = _train(model, balance, backend, plan, engine="host")
    return _HOST[kind]


# ------------------------------------------- (a) bit-identical to host --


@pytest.mark.parametrize("schedule, placement", [
    *[(s, None) for s in SCHEDULES],
    ("fill_drain", Placement.ring(4, rotation=1)),
    ("1f1b", Placement.ring(4, rotation=3)),
])
@pytest.mark.parametrize("kind", ["gat-padded", "gat-kernel", "imbalanced-gcn"])
def test_compiled_bit_identical_to_host_fill_drain(karate, kind, schedule, placement):
    """Three steps with dropout on (keyed masks; the recomputes redraw them):
    every schedule and rotated ring gives the host fill-drain's losses and
    params bit for bit."""
    plan = tmb.make_plan(karate, 4, strategy="halo")
    want_params, want_losses, _ = _host_run(kind, karate, plan)
    model, balance, backend = _model(kind, karate)
    params, losses, eng = _train(model, balance, backend, plan, engine="compiled",
                                 schedule=schedule, placement=placement)
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
    assert trees_equal(params, want_params)
    if placement is not None:
        assert eng.describe()["placement"] == list(placement.stage_to_device)


def test_compiled_evaluate_bit_identical_to_host_and_train_cli(karate):
    """The compiled eval program over a plan equals the host engine's bit for
    bit, and ``--engine compiled`` trains through the CLI with the host run's
    epoch losses."""
    plan = tmb.make_plan(karate, 4, strategy="halo")
    model, balance, backend = _model("gat-padded", karate)
    params = model.init_params(3)
    evals = [make_engine(model, GPipeConfig(balance=balance, chunks=4, engine=e, device="cpu"))
             .evaluate(params, plan) for e in ("host", "compiled")]
    assert all(torch.equal(evals[0][k], evals[1][k]) for k in evals[0])
    argv = ["--dataset", "karate", "--stages", "4", "--chunks", "4", "--strategy", "halo",
            "--epochs", "3", "--log-every", "0", "--device", "cpu", "--schedule", "1f1b"]
    host = tlaunch.main([*argv, "--engine", "host"])
    comp = tlaunch.main([*argv, "--engine", "compiled"])
    assert comp["engine"] == "compiled" and comp["epoch_losses"] == host["epoch_losses"]
    assert comp["peak_live_activations"] == 9 and np.isfinite(comp["val_acc"])


# ------------------------------------------- (b) against the JAX engine --


@pytest.fixture(scope="module")
def jax_case():
    tgraph, jgraph = tg.load_dataset("karate"), jg.load_dataset("karate")
    kw = dict(feat_dropout=0.0, attn_dropout=0.0)
    jm = jnet.build_paper_gat(jgraph.num_features, jgraph.num_classes, **kw)
    tm = tnet.build_paper_gat(tgraph.num_features, tgraph.num_classes, **kw)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    plans = (jmb.make_plan(jgraph, 4, strategy="halo"), tmb.make_plan(tgraph, 4, strategy="halo"))
    return jm, tm, jparams, params, plans


@pytest.mark.parametrize("schedule", ["fill_drain", "1f1b", "zb-h1", "interleaved"])
def test_compiled_three_steps_and_eval_match_jax_compiled(jax_case, schedule):
    jm, tm, jp, tp, (jplan, tplan) = jax_case
    nd = 2 if schedule == "interleaved" else None
    jeng = j_make_engine(jm, JConfig(balance=BALANCE, chunks=4, schedule=schedule,
                                     num_devices=nd, engine="compiled"))
    teng = make_engine(tm, GPipeConfig(balance=BALANCE, chunks=4, schedule=schedule,
                                       num_devices=nd, engine="compiled", device="cpu"))
    jo, to = jopt.adam(5e-3, weight_decay=5e-4), topt.adam(5e-3, weight_decay=5e-4)
    js, ts = jo.init(jp), to.init(tp)
    jstats, tstats = {}, {}
    for step in range(3):
        jp, js, jloss = jeng.train_step(jp, js, jplan, jax.random.PRNGKey(step), jo, stats=jstats)
        tp, ts, tloss = teng.train_step(tp, ts, tplan, step, to, stats=tstats)
        close(tloss, jloss)
        for t_layer, j_layer in zip(tp, jp):
            for k in t_layer:
                close(t_layer[k], j_layer[k])
    jgraph, tgraph = jplan.stacked().graph, tplan.stacked().graph
    close(teng.compile_eval(tp, tgraph)(tgraph), jeng.compile_eval(jp, jgraph)(jgraph))
    if schedule != "fill_drain":  # the JAX fill-drain is a fused scan: no stash
        for key in ("measured_peak_live_activations", "stash_slots_per_device",
                    "w_slots_per_device", "num_ticks"):
            assert tstats[key] == jstats[key], key


def test_stage_widths_and_slices_match_jax_and_compose_to_apply(karate):
    jgraph = jg.load_dataset("karate")
    for jm, tm in (
        (jnet.build_paper_gat(34, 2), tnet.build_paper_gat(34, 2)),
        (jnet.build_gnn("gcn", 34, 2, hidden=16, depth=3), tnet.build_gnn("gcn", 34, 2, hidden=16,
                                                                          depth=3)),
    ):
        jparams = jm.init_params(jax.random.PRNGKey(1))
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        widths = tnet.activation_widths(tm, params, karate)
        assert widths == jnet.activation_widths(jm, jparams, jgraph)
        n = len(tm.layers)
        bounds = [(0, 2), (2, 3), (3, n)]
        assert tnet.travel_width(bounds, widths) == jnet.travel_width(bounds, widths)
        # the slices chained over the wire give the full forward, with dropout on
        slices = tnet.make_gnn_stage_slices(tm, bounds, widths, [karate], tnet.chunk_keys(7, n))
        h = None
        for s in range(len(bounds)):
            h = slices[s](params, 0, h)
        want = tm.apply(params, karate, rng=tnet.fold_in(7, 0), train=True)
        assert h.shape == (karate.num_nodes, tnet.travel_width(bounds, widths))
        assert torch.equal(h[:, : widths[-1]], want)


# ------------------------------------------------ (c) stash accounting --


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_stats_equal_the_reference_lowering(karate, schedule):
    plan = tmb.make_plan(karate, 4, strategy="halo")
    model, balance, backend = _model("gat-padded", karate)
    stats: dict = {}
    _train(model, balance, backend, plan, engine="compiled", schedule=schedule, steps=1,
           stats=stats)
    nd = 2 if schedule in ("interleaved", "zb-v") else None
    items = jsched.get_schedule(schedule, num_devices=nd).timeline(4, 4)
    want = jsched.lower_timeline(items, 4, 4)
    got = tsched.lower_timeline(tsched.get_schedule(schedule, num_devices=nd).timeline(4, 4), 4, 4)
    for name in ("phase", "stage", "chunk", "work_fslot", "in_fslot", "work_bslot", "in_bslot",
                 "work_wslot", "store_wslot"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert stats["measured_peak_live_activations"] == want.peak_live_stash
    assert stats["stash_slots_per_device"] == want.n_fslots
    assert stats["w_slots_per_device"] == want.n_wslots
    assert stats["num_ticks"] == want.num_ticks and stats["wire_latency"] == 1
    assert stats["engine"] == "compiled" and stats["bubble_fraction"] >= 0


# ------------------------------------------------- (d) empty chunks --


def _plan_with_empty_chunk(g, chunks=3):
    """A halo plan plus one chunk with no core node: all pad rows, count 0."""
    plan = tmb.make_plan(g, chunks, strategy="halo", halo_hops=2)
    n_pad = max(mb.num_nodes for mb in plan.batches)
    nodes, core = tpart.pad_partition(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool), n_pad)
    empty = tmb.MicroBatch(graph=subgraph(g, nodes), core_mask=torch.from_numpy(core))
    return dataclasses.replace(plan, chunks=chunks + 1, batches=plan.batches + [empty])


@pytest.mark.parametrize("schedule", ["fill_drain", "1f1b", "zb-h1"])
def test_empty_chunk_is_skipped_with_the_same_update(karate, schedule):
    ragged = _plan_with_empty_chunk(karate)
    model, balance, backend = _model("gat-padded", karate)
    want_params, want_losses, _ = _train(model, balance, backend, ragged, engine="host", steps=2)
    stats: dict = {}
    params, losses, _ = _train(model, balance, backend, ragged, engine="compiled",
                               schedule=schedule, steps=2, stats=stats)
    assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
    assert trees_equal(params, want_params)
    # the empty chunk's ticks are gone: fewer than the full timeline's, and
    # under 1F1B exactly the clean 3-chunk plan's
    full = tsched.lower_timeline(tsched.get_schedule(schedule).timeline(4, 4), 4, 4)
    assert stats["num_ticks"] < full.num_ticks
    if schedule == "1f1b":
        clean: dict = {}
        _train(model, balance, backend, tmb.make_plan(karate, 3, strategy="halo", halo_hops=2),
               engine="compiled", schedule=schedule, steps=1, stats=clean)
        assert stats["num_ticks"] == clean["num_ticks"]


def test_ragged_plan_runs_on_its_stacked_chunks(karate):
    """Chunks of different node counts cannot share a wire: the compiled
    engine runs the plan's stacked (padded) chunks and keeps the host's
    update (padding rows are isolated)."""
    plan = tmb.make_plan(karate, 3, strategy="sequential", pad_to_max=False)
    assert len({mb.num_nodes for mb in plan.batches}) > 1
    model, balance, backend = _model("gat-padded", karate)
    want_params, want_losses, _ = _train(model, balance, backend, plan, engine="host", steps=2)
    params, losses, _ = _train(model, balance, backend, plan, engine="compiled",
                               schedule="1f1b", steps=2)
    for a, b in zip(losses, want_losses):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for got, want in zip(params, want_params):
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)


# ------------------------------------------------ (e) eval programs --


def test_eval_program_binds_params_once_and_caches_per_shape(karate):
    plan = tmb.make_plan(karate, 2, strategy="halo")
    model, balance, backend = _model("gat-padded", karate)
    eng = make_engine(model, GPipeConfig(balance=(3, 3), chunks=2, engine="compiled",
                                         device="cpu"))
    params = model.init_params(0)
    graph = plan.stacked().graph
    prog = eng.compile_eval(params, graph)
    placed = prog._bound[1]
    assert eng.compile_eval(params, graph) is prog and prog._bound[1] is placed
    first, again = eng.evaluate(params, plan), eng.evaluate(params, plan)
    assert all(torch.equal(first[k], again[k]) for k in first)
    out = prog(graph)
    assert out.shape == (2, graph.num_nodes, karate.num_classes) and not out.requires_grad
    with pytest.raises(ValueError, match="batch shape"):
        prog(tmb.make_plan(karate, 3, strategy="halo").stacked().graph)


def test_eval_executor_writes_only_last_stage_outputs():
    items = tsched.forward_timeline(3, 4)
    lowered = tsched.lower_timeline(items, 3, 4, forward_only=True)
    slots = _eval_out_slot(lowered)
    assert sorted(slots[slots != 4].tolist()) == [0, 1, 2, 3]
    # work_fn: stage s adds s + 1 to the chunk's value; stage 0 starts at the chunk id
    out = spmd_pipeline_scheduled_eval_lanes(
        lambda phase, s, c, h: (torch.full((2, 3), float(c)) if h is None else h) + s + 1,
        lowered, wire_like=torch.zeros(2, 3),
    )
    assert torch.equal(out, torch.arange(4.0)[:, None, None].expand(4, 2, 3) + 6)


# ------------------------------------------------------- (f) refusals --


def test_unported_options_and_illegal_combinations_raise(karate):
    model, _, _ = _model("gat-padded", karate)

    def engine(**kw):
        return make_engine(model, GPipeConfig(**{"balance": BALANCE, "chunks": 4,
                                                 "device": "cpu", **kw}))

    assert engine(engine="compiled", data_parallel=2).describe()["data_parallel"] == 2
    assert engine(engine="compiled", overlap="double-buffer").name == "compiled"
    with pytest.raises(ValueError, match="data_parallel"):
        engine(engine="compiled", data_parallel=0)
    with pytest.raises(ValueError, match="overlap"):
        engine(engine="compiled", overlap="eager")
    with pytest.raises(ValueError, match="host"):
        engine(engine="host", data_parallel=2)
    with pytest.raises(ValueError, match="host"):
        engine(engine="host", overlap="async")
    # interleaved needs chunks divisible by its devices: raised at the lowering
    plan = tmb.make_plan(karate, 3, strategy="sequential")
    eng = engine(engine="compiled", chunks=3, schedule="interleaved", num_devices=2)
    opt = topt.adam(1e-2)
    params = model.init_params(0)
    with pytest.raises(ValueError):
        eng.train_step(params, opt.init(params), plan, 0, opt)
    # wire latency 2: the train lanes run the double-buffered wires (here a
    # toy forward-only work fn over a 1F1B timeline); the eval lanes refuse it
    items = tsched.retime_timeline(tsched.get_schedule("1f1b").timeline(4, 4), 4, 4,
                                   wire_latency=2)
    lowered = tsched.lower_timeline(items, 4, 4, wire_latency=2)

    def work(phase, s, c, h, ct, w):
        # stage s's input is c + s; its cotangent out adds its input to the one in
        if phase == tsched.PHASE_FWD:
            return (torch.full((2, 2), float(c)) if h is None else h) + 1, None, None, None, \
                None, None
        if s == 0:
            return None, None, None, [{"g": ct}], None, None
        d_h = (torch.zeros(2, 2) if ct is None else ct) + h
        return None, d_h, None, None, (h.sum() if s == 3 else None), torch.ones(())

    grads, loss, count = spmd_pipeline_scheduled_lanes(
        work, lowered, wire_like=torch.zeros(2, 2), grads_like=[{"g": torch.zeros(2, 2)}])
    assert float(loss) == sum(4.0 * (c + 3) for c in range(4)) and float(count) == 4
    assert torch.equal(grads[0]["g"], torch.full((2, 2), sum(3.0 * c + 6 for c in range(4))))
    fwd = tsched.lower_timeline(tsched.forward_timeline(3, 4), 3, 4, forward_only=True)
    with pytest.raises(ValueError, match="wire latency 1"):
        spmd_pipeline_scheduled_eval_lanes(None, dataclasses.replace(fwd, wire_latency=2),
                                           wire_like=torch.zeros(2, 3))


def test_optimizer_state_lives_on_the_params_device(karate):
    params = [{"w": torch.zeros(2, 2, device="meta")}, {}]
    for opt in (topt.adam(1e-2), topt.sgd(0.1), topt.sgd(0.1, momentum=0.9)):
        state = opt.init(params)
        step = state.step if isinstance(state, topt.AdamState) else state["step"]
        assert step.device.type == "meta" and step.dtype == torch.int32
    sched = topt.adam(topt.cosine_schedule(1.0, warmup=2, total=4))
    p = [{"w": torch.ones(3)}]
    state = sched.init(p)
    for _ in range(3):
        _, state = sched.update([{"w": torch.ones(3)}], state, p)
    assert int(state.step) == 3
