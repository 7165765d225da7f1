"""Training in the port against the JAX package: models, optimizer, the host
GPipe engine and the training entry point, on the CPU at small sizes.

Inputs come from numpy seeds and params from the JAX model's own init
(``params_from_jax``); dropout is 0 wherever the two frameworks meet, since
``jax.random`` bits cannot be reproduced. Tolerance across frameworks:
rtol/atol 1e-5 (the two sum in other orders). Inside the port, every
schedule must give updates bit-identical to fill-drain, with dropout on.
"""
# ruff: noqa: E402

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp

import repro.graphs as jg
from repro.core import microbatch as jmb
from repro.core.pipeline import GPipeConfig as JConfig
from repro.core.pipeline import make_engine as j_make_engine
from repro.graphs import partition as jpart
from repro.models.gnn import net as jnet
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
import repro_torch.graphs as tg
from repro_torch.core import microbatch as tmb
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.graphs import partition as tpart
from repro_torch.launch import train as tlaunch
from repro_torch.models.gnn import net as tnet
from repro_torch.models.gnn.convert import params_from_jax
from repro_torch.train import losses as tlosses
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

TOL = dict(rtol=1e-5, atol=1e-5)
SCHEDULES = ("fill_drain", "gpipe", "1f1b", "interleaved", "zb-h1", "zb-v")


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def trees_close(t, j, **tol):
    assert len(t) == len(j)
    for tp, jp in zip(t, j):
        assert set(tp) == set(jp)
        for k in tp:
            close(tp[k].detach(), jp[k], **tol)


def trees_equal(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def jax_params(model, seed=0):
    leaves = model.init_params(jax.random.PRNGKey(seed))
    return leaves, params_from_jax(jax.tree_util.tree_map(np.asarray, leaves))


def builders(kind, g, backend):
    """(JAX model, port model) pairs with dropout off."""
    jb = "pallas" if backend == "kernel" else backend
    if kind == "gat":
        kw = dict(feat_dropout=0.0, attn_dropout=0.0)
        return (jnet.build_paper_gat(g.num_features, g.num_classes, backend=jb, **kw),
                tnet.build_paper_gat(g.num_features, g.num_classes, backend=backend, **kw))
    if kind == "gcn":
        kw = dict(hidden=16, depth=3)
        return (jnet.build_gnn("gcn", g.num_features, g.num_classes, backend=jb, **kw),
                tnet.build_gnn("gcn", g.num_features, g.num_classes, backend=backend, **kw))
    kw = dict(hidden=(32, 32, 8))
    return (jnet.build_imbalanced_gcn(g.num_features, g.num_classes, backend=jb, **kw),
            tnet.build_imbalanced_gcn(g.num_features, g.num_classes, backend=backend, **kw))


@pytest.fixture(scope="module")
def karate():
    return tg.load_dataset("karate"), jg.load_dataset("karate")


@pytest.fixture(scope="module")
def skewed():
    return tg.load_dataset("skewed-mini"), jg.load_dataset("skewed-mini")


# ------------------------------------------------------------- models --


@pytest.mark.parametrize("kind, backend", [
    ("gat", "padded"), ("gat", "kernel"), ("gcn", "padded"), ("gcn", "kernel"),
    ("imbalanced", "kernel"),
])
def test_logits_and_param_grads_match_jax(karate, kind, backend):
    tgraph, jgraph = karate
    if backend == "kernel":  # the bucketed layout on both sides
        tgraph, jgraph = tpart.degree_bucketed_layout(tgraph), jpart.degree_bucketed_layout(jgraph)
    jm, tm = builders(kind, tgraph, backend)
    jleaves, params = jax_params(jm)

    def jloss(p):
        logp = jm.apply(p, jgraph, train=False)
        return jlosses.masked_nll(logp, jgraph.labels, jgraph.train_mask), logp

    (_, jlogp), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jleaves)
    leaves = topt.requires_grad_leaves(params)
    logp = tm.apply(leaves, tgraph, train=False)
    loss = tlosses.masked_nll(logp, tgraph.labels, tgraph.train_mask)
    close(logp.detach(), jlogp)
    trees_close(topt.tree_grad(loss, leaves), jgrads)


def test_build_gnn_kinds_and_layer_names():
    m = tnet.build_gnn("gcn", 10, 3, hidden=8, depth=2)
    assert [layer.name for layer in m.layers] == ["gcn_0", "elu", "gcn_1", "log_softmax"]
    assert tnet.build_gnn("gat", 10, 3).layers[1].name == "gat_0"
    with pytest.raises(NotImplementedError, match="item 5"):
        tnet.build_gnn("graphconv", 10, 3)
    with pytest.raises(KeyError):
        tnet.build_gnn("nope", 10, 3)
    im = tnet.build_imbalanced_gcn(10, 3)
    assert [tuple(p["w"].shape) for p in im.init_params(0) if p] == [
        (10, 256), (256, 256), (256, 32), (32, 32), (32, 32), (32, 32), (32, 3)]


def test_dropout_keys_redraw_the_same_masks():
    g = tg.load_dataset("karate")
    m = tnet.build_paper_gat(g.num_features, g.num_classes)
    p = m.init_params(0)
    a = m.apply(p, g, rng=5, train=True)
    assert torch.equal(a, m.apply(p, g, rng=5, train=True))
    assert not torch.equal(a, m.apply(p, g, rng=6, train=True))
    assert tnet.fold_in(5, 0) != tnet.fold_in(5, 1) != tnet.fold_in(6, 0)


# ---------------------------------------------------------- optimizer --


@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
def test_adam_steps_match_jax(weight_decay):
    rng = np.random.default_rng(0)
    shapes = [{"w": (5, 3), "b": (3,)}, {}, {"w": (3, 2)}]
    params = [{k: rng.standard_normal(s).astype(np.float32) for k, s in d.items()} for d in shapes]
    grads = [[{k: rng.standard_normal(s).astype(np.float32) for k, s in d.items()} for d in shapes]
             for _ in range(2)]
    jo, to = jopt.adam(5e-3, weight_decay=weight_decay), topt.adam(5e-3, weight_decay=weight_decay)
    jp = [{k: jnp.asarray(v) for k, v in d.items()} for d in params]
    tp = params_from_jax(params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update([{k: jnp.asarray(v) for k, v in d.items()} for d in g], js, jp)
        tu, ts = to.update(params_from_jax(g), ts, tp)
        trees_close(tu, ju, rtol=1e-6, atol=1e-9)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        trees_close(tp, jp, rtol=1e-6, atol=1e-9)
    assert int(ts.step) == int(js.step) == 2
    trees_close(ts.mu, js.mu, rtol=1e-6, atol=1e-9)
    trees_close(ts.nu, js.nu, rtol=1e-6, atol=1e-9)


def test_sgd_clip_and_cosine_match_jax():
    rng = np.random.default_rng(1)
    p = [{"w": rng.standard_normal((4, 4)).astype(np.float32)}]
    g = [{"w": 10 * rng.standard_normal((4, 4)).astype(np.float32)}]
    jp, tp = [{"w": jnp.asarray(p[0]["w"])}], params_from_jax(p)
    jg_, tg_ = [{"w": jnp.asarray(g[0]["w"])}], params_from_jax(g)
    for mom in (0.0, 0.9):
        jo, to = jopt.sgd(0.1, momentum=mom), topt.sgd(0.1, momentum=mom)
        ju, _ = jo.update(jg_, jo.init(jp), jp)
        tu, _ = to.update(tg_, to.init(tp), tp)
        trees_close(tu, ju)
    jc, jn = jopt.clip_by_global_norm(jg_, 1.0)
    tc, tn = topt.clip_by_global_norm(tg_, 1.0)
    close(tn, jn)
    trees_close(tc, jc)
    js, ts = jopt.cosine_schedule(1.0, warmup=3, total=10), topt.cosine_schedule(1.0, warmup=3, total=10)
    for step in (0, 2, 3, 7, 12):
        close(ts(torch.tensor(step)), js(jnp.asarray(step)))


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((9, 4)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels = rng.integers(0, 4, 9).astype(np.int32)
    mask = rng.random(9) > 0.4
    t = [torch.from_numpy(x) for x in (logp, labels, mask)]
    close(tlosses.masked_nll(*t), jlosses.masked_nll(logp, labels, mask))
    close(tlosses.masked_accuracy(*t), jlosses.masked_accuracy(logp, labels, mask))
    close(tlosses.softmax_xent(torch.from_numpy(logits), t[1], mask=t[2].float()),
          jlosses.softmax_xent(logits, labels, mask=mask.astype(np.float32)))
    close(tlosses.softmax_xent(torch.from_numpy(logits), t[1]),
          jlosses.softmax_xent(logits, labels))


# ------------------------------------------------------------- engine --


def _engine_pair(jm, tm, balance, chunks, backend="padded", schedule="fill_drain"):
    nd = 2 if schedule in ("interleaved", "zb-v") else None
    jb = "pallas" if backend == "kernel" else backend
    jeng = j_make_engine(jm, JConfig(balance=balance, chunks=chunks, backend=jb))
    teng = make_engine(tm, GPipeConfig(balance=balance, chunks=chunks, schedule=schedule,
                                       num_devices=nd, backend=backend, device="cpu"))
    return jeng, teng


def test_host_fill_drain_three_steps_match_jax_on_karate_halo(karate):
    tgraph, jgraph = karate
    jm, tm = builders("gat", tgraph, "padded")
    jeng, teng = _engine_pair(jm, tm, (2, 1, 1, 2), 4)
    jplan = jmb.make_plan(jgraph, 4, strategy="halo")
    tplan = tmb.make_plan(tgraph, 4, strategy="halo")
    jp, tp = jax_params(jm)
    jo, to = jopt.adam(5e-3, weight_decay=5e-4), topt.adam(5e-3, weight_decay=5e-4)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        jp, js, jloss = jeng.train_step(jp, js, jplan, jax.random.PRNGKey(step), jo)
        tp, ts, tloss = teng.train_step(tp, ts, tplan, step, to)
        close(tloss, jloss)
        trees_close(tp, jp)


def test_host_kernel_backend_gcn_step_matches_jax_pallas(karate):
    """The bucketed layout (shared capacities) through the engine: one
    fig3-shaped GCN step against the JAX host engine's pallas backend."""
    tgraph, jgraph = karate
    jm = jnet.build_gnn("gcn", jgraph.num_features, jgraph.num_classes, hidden=32, depth=2,
                        backend="pallas")
    tm = tnet.build_gnn("gcn", tgraph.num_features, tgraph.num_classes, hidden=32, depth=2,
                        backend="kernel")
    jeng, teng = _engine_pair(jm, tm, (2, 2), 2, backend="kernel")
    jp, tp = jax_params(jm)
    jo, to = jopt.adam(1e-2), topt.adam(1e-2)
    jp1, _, jloss = jeng.train_step(jp, jo.init(jp), jmb.make_plan(jgraph, 2), jax.random.PRNGKey(1), jo)
    tp1, _, tloss = teng.train_step(tp, to.init(tp), tmb.make_plan(tgraph, 2), 1, to)
    close(tloss, jloss)
    trees_close(tp1, jp1)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kind", ["gat-dropout", "gcn-kernel"])
def test_every_schedule_bit_identical_to_fill_drain(karate, skewed, schedule, kind):
    if kind == "gat-dropout":  # feature and attention dropout on: keyed masks
        g = karate[0]
        model = tnet.build_paper_gat(g.num_features, g.num_classes)
        balance, backend, plan = (2, 1, 1, 2), "padded", tmb.make_plan(g, 4, strategy="halo")
    else:
        g = skewed[0]
        model = tnet.build_gnn("gcn", g.num_features, g.num_classes, hidden=16, depth=2,
                               backend="kernel")
        balance, backend, plan = (2, 2), "kernel", tmb.make_plan(g, 4)
    opt = topt.adam(5e-3, weight_decay=5e-4)
    runs = {}
    for name in ("fill_drain", schedule):
        nd = 2 if name in ("interleaved", "zb-v") else None
        eng = make_engine(model, GPipeConfig(balance=balance, chunks=4, schedule=name,
                                             num_devices=nd, backend=backend, device="cpu"))
        params = model.init_params(0)
        state = opt.init(params)
        stats, record = {}, []
        for step in range(2):
            params, state, loss = eng.train_step(params, state, plan, 11 + step, opt,
                                                 stats=stats, record=record)
        runs[name] = (params, loss)
        assert len(record) == 2 * len(eng.schedule.timeline(len(balance), 4))
        assert stats["measured_peak_live_activations"] >= 1
    assert trees_equal(runs["fill_drain"][0], runs[schedule][0])
    assert torch.equal(runs["fill_drain"][1], runs[schedule][1])


def test_recompute_redraws_dropout_masks_one_chunk_equals_full_batch(karate):
    """With one chunk the pipeline step is the full-batch step: the same
    dropout keys (chunk 0's fold) give the same update only if the
    backward's recompute redraws the forward's masks."""
    g = karate[0]
    m = tnet.build_paper_gat(g.num_features, g.num_classes)
    opt = topt.adam(5e-3, weight_decay=5e-4)
    params = m.init_params(1)
    eng = make_engine(m, GPipeConfig(balance=(2, 1, 1, 2), chunks=1, device="cpu"))
    p_pipe, _, loss_pipe = eng.train_step(params, opt.init(params), tmb.make_plan(g, 1), 9, opt)
    step = tloop.make_train_step(m, opt)
    p_full, _, loss_full = step(params, opt.init(params), g, tnet.fold_in(9, 0))
    close(loss_pipe, loss_full, rtol=1e-6, atol=1e-7)
    trees_close(p_pipe, p_full, rtol=1e-6, atol=1e-7)
    p_other, _, _ = step(params, opt.init(params), g, tnet.fold_in(9, 1))
    assert not trees_equal(p_other, p_full)


def test_engine_evaluate_on_halo_plan_equals_full_batch_eval(karate):
    g = karate[0]
    for backend in ("padded", "kernel"):
        m = tnet.build_paper_gat(g.num_features, g.num_classes, backend=backend, attn_dropout=0.0)
        eng = make_engine(m, GPipeConfig(balance=(3, 3), chunks=4, backend=backend, device="cpu"))
        params = m.init_params(2)
        got = eng.evaluate(params, tmb.make_plan(g, 4, strategy="halo"))
        want = tloop.make_eval(m)(params, g)
        for k in want:
            close(got[k], want[k], rtol=1e-6, atol=1e-6)
    d = eng.describe()
    assert d["engine"] == "host" and d["balance"] == [3, 3] and d["schedule"] == "fill_drain"


def test_placement_relabels_timeline_and_keeps_update(karate):
    from repro_torch.core.schedule import Placement

    g = karate[0]
    m = tnet.build_paper_gat(g.num_features, g.num_classes)
    plan, opt = tmb.make_plan(g, 2, strategy="halo"), topt.sgd(0.1)
    outs = []
    for placement in (None, Placement.ring(4, rotation=1)):
        eng = make_engine(m, GPipeConfig(balance=(2, 1, 1, 2), chunks=2, schedule="1f1b",
                                         placement=placement, device="cpu"))
        params = m.init_params(0)
        outs.append(eng.train_step(params, opt.init(params), plan, 3, opt)[0])
    assert trees_equal(*outs)
    assert eng.describe()["placement"] == [1, 2, 3, 0]
    with pytest.raises(ValueError, match="placement spans"):
        make_engine(m, GPipeConfig(balance=(2, 1, 1, 2), chunks=2, device="cpu",
                                   placement=Placement.ring(4, 2)))


# ----------------------------------------------- the paper's claims --


def _args(**kw):
    base = dict(mode="gnn", dataset="karate", backend="padded", strategy="sequential",
                stages=1, chunks=1, epochs=60, seed=0, log_every=0, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_single_device_gat_learns_karate():
    g = tg.load_dataset("karate")
    res = tloop.train(tnet.build_paper_gat(g.num_features, g.num_classes), g, epochs=60)
    assert res.train_acc >= 0.9
    assert res.val_acc >= 0.6
    assert len(res.epoch_times_s) == 60 and res.avg_epoch_s > 0


def test_paper_claim_sequential_chunking_cuts_edges_and_halo_recovers():
    full = tlaunch.run_gnn(_args())
    seq4 = tlaunch.run_gnn(_args(stages=4, chunks=4, strategy="sequential"))
    halo4 = tlaunch.run_gnn(_args(stages=4, chunks=4, strategy="halo"))
    assert seq4["edge_cut"] > 0.3 and halo4["edge_cut"] == 0.0
    assert halo4["val_acc"] >= full["val_acc"] - 0.1
    assert np.isfinite(seq4["train_loss"]) and seq4["bubble_fraction"] == pytest.approx(3 / 7)


def test_gcn_single_device_train_with_kernel_backend_on_cpu():
    g = tg.load_dataset("karate")
    m = tnet.build_gnn("gcn", g.num_features, g.num_classes, hidden=16, backend="kernel")
    res = tloop.train(m, g, epochs=30, lr=1e-2)
    assert res.train_acc >= 0.9


def test_train_cli_trains_on_cpu_and_targets_cuda_by_default(capsys):
    argv = ["--mode", "gnn", "--dataset", "karate", "--stages", "4", "--chunks", "4",
            "--strategy", "halo", "--epochs", "3", "--log-every", "0"]
    out = tlaunch.main([*argv, "--device", "cpu", "--backend", "pallas", "--schedule", "zb-h1"])
    printed = capsys.readouterr().out
    assert "attention dropout disabled" in printed and str(out) in printed
    assert out["schedule"] == "zb-h1" and out["device"] == "cpu"
    assert {"val_acc", "bubble_fraction", "median_epoch_s", "edge_cut"} <= set(out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(argv)


@pytest.mark.parametrize("argv, match", [
    (["--mode", "lm"], "item 16"),
    (["--dataset", "powerlaw-64k"], "item 12"),
    (["--partition", "profiled"], "item 10"),
    (["--auto"], "item 10"),
    (["--engine", "compiled"], "item 9"),
])
def test_train_cli_unported_paths_raise_by_item(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        tlaunch.main(["--dataset", "karate", "--stages", "4", "--epochs", "1", "--device", "cpu",
                      *argv])
