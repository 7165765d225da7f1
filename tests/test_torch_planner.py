"""The port's cost model and ``--auto`` planner against the JAX package's,
on the CPU.

Given the same injected per-layer costs, ``choose_balance``,
``predicted_balance_time`` and ``plan_pipeline``'s ranked table (``table()``
rows and ``format_table`` text) must equal the reference's exactly: ties,
budget truncation and memory pruning included. The port's profiler is run
for real on a karate chunk, and its cache keys must never equal the
reference's.
"""
# ruff: noqa: E402

import dataclasses
import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX side of the parity tests

from repro.core import autotune as jauto
from repro.core import costmodel as jcost
from repro.core.schedule import get_schedule as j_get_schedule
import repro_torch.graphs as tg
from repro_torch.core import autotune as tauto
from repro_torch.core import costmodel as tcost
from repro_torch.core import microbatch as tmb
from repro_torch.core.cli import PipelineCLIConfig
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.core.schedule import get_schedule
from repro_torch.launch import serve_gnn as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models.gnn import net as tnet

CHUNKS = tauto.DEFAULT_CHUNK_COUNTS


def _costs(mod, fwd, scale_b=1.0, scale_w=1.0):
    return mod.LayerCosts(
        names=tuple(f"l{i}" for i in range(len(fwd))),
        fwd=tuple(fwd),
        bwd=tuple(f * (scale_b + scale_w) for f in fwd),
        bwd_b=tuple(f * scale_b for f in fwd),
        bwd_w=tuple(f * scale_w for f in fwd),
    )


def _profiles(mod, name):
    """Per chunk count, one cost table of the named profile."""
    rng = np.random.default_rng(3)
    out = {}
    for c in CHUNKS:
        if name == "uniform":  # shape-invariant: ties everywhere
            fwd, sb, sw = [1e-3] * 6, 1.0, 1.0
        elif name == "w-light":
            fwd, sb, sw = [2e-3 / c, 1e-3, 1e-3, 1e-3, 1e-3, 2e-3], 0.9, 0.1
        else:  # measured-looking: a heavy input layer, noisy tail
            fwd = list(rng.uniform(1e-4, 1e-3, 6) / c)
            fwd[1] *= 8
            sb, sw = 1.1, 0.7
        out[c] = _costs(mod, fwd, sb, sw)
    return out


def _namespace(cli, **extra):
    """An argparse-shaped namespace of ``cli``'s flags plus ``extra``."""
    return types.SimpleNamespace(**dataclasses.asdict(cli), **extra)


def _stub_model(n_layers=6):
    return types.SimpleNamespace(
        layers=[types.SimpleNamespace(name=f"l{i}") for i in range(n_layers)]
    )


# ------------------------------------------------------ the partitioner --


@pytest.mark.parametrize("schedule, kw", [
    ("fill_drain", {}), ("1f1b", {}), ("interleaved", {"num_devices": 2}), ("zb-h1", {}),
    ("zb-v", {"num_devices": 2}),
])
@pytest.mark.parametrize("profile", ["uniform", "w-light", "measured"])
def test_choose_balance_and_predicted_time_equal_the_reference(schedule, kw, profile):
    jc, tc = _profiles(jcost, profile)[4], _profiles(tcost, profile)[4]
    js, ts = j_get_schedule(schedule, **kw), get_schedule(schedule, **kw)
    for bal in tcost.enumerate_balances(6, 4):
        assert tcost.predicted_balance_time(tc, bal, ts, 4, transfer_cost=1e-5) == \
            jcost.predicted_balance_time(jc, bal, js, 4, transfer_cost=1e-5)
    assert tcost.choose_balance(tc, 4, ts, 4) == jcost.choose_balance(jc, 4, js, 4)
    assert list(tcost.enumerate_balances(6, 3)) == list(jcost.enumerate_balances(6, 3))
    assert tcost.uniform_balance(6, 4) == jcost.uniform_balance(6, 4)


def test_layer_costs_validation_and_table():
    c = _costs(tcost, [1.0, 2.0, 3.0, 4.0])
    assert c.stage_costs((1, 3)) == ([1.0, 9.0], [2.0, 18.0])
    assert c.table() == _costs(jcost, [1.0, 2.0, 3.0, 4.0]).table()
    with pytest.raises(ValueError):
        c.stage_costs((2, 3))
    with pytest.raises(ValueError, match="max_candidates"):
        tcost.choose_balance(_costs(tcost, [1.0] * 40), 20, get_schedule("1f1b"), 4,
                             max_candidates=10)
    with pytest.raises(ValueError):
        tcost.uniform_balance(3, 4)


# ----------------------------------------------------------- the planner --


@pytest.mark.parametrize("cons", [
    {},  # ties: the documented total order decides
    {"budget": 40},  # budget truncation
    {"max_live_activations": 8},  # memory pruning
    {"budget": 150, "max_live_activations": 8, "transfer_cost": 1e-4},
    {"num_stages": 3, "max_devices": 2, "rotations": False},
    {"schedules": ("zb-h1", "1f1b"), "chunk_counts": (2, 4)},
])
@pytest.mark.parametrize("profile", ["uniform", "w-light", "measured"])
def test_plan_table_equals_the_reference(cons, profile):
    jp = jauto.plan_pipeline(_stub_model(), None, jauto.PlanConstraints(**cons), params=(),
                             costs_by_chunks=_profiles(jcost, profile))
    tp = tauto.plan_pipeline(_stub_model(), None, tauto.PlanConstraints(**cons), params=(),
                             costs_by_chunks=_profiles(tcost, profile), device="cpu")
    assert tp.table() == jp.table()
    assert tp.format_table(limit=None) == jp.format_table(limit=None)
    assert tp.format_table() == jp.format_table()
    assert (tp.schedule, tp.chunks, tp.balance, tp.num_devices, tp.predicted_step_s,
            tp.evaluated, tp.truncated) == (jp.schedule, jp.chunks, jp.balance,
                                            jp.num_devices, jp.predicted_step_s,
                                            jp.evaluated, jp.truncated)
    assert (tp.placement is None) == (jp.placement is None)


def test_plan_refusals_match_the_reference():
    costs = _profiles(tcost, "uniform")
    with pytest.raises(ValueError, match="peak_live"):
        tauto.plan_pipeline(_stub_model(), None, tauto.PlanConstraints(max_live_activations=0),
                            params=(), costs_by_chunks=costs)
    with pytest.raises(ValueError, match="no costs_by_chunks entry"):
        tauto.plan_pipeline(_stub_model(), None, params=(),
                            costs_by_chunks={4: costs[4]})
    with pytest.raises(ValueError, match="num_stages"):
        tauto.plan_pipeline(_stub_model(), None, tauto.PlanConstraints(num_stages=7),
                            params=(), costs_by_chunks=costs)


def test_make_engine_accepts_a_plan_and_to_config_overrides():
    g = tg.load_dataset("karate")
    m = tnet.build_paper_gat(g.num_features, g.num_classes)
    plan = tauto.plan_pipeline(m, None, params=(), costs_by_chunks=_profiles(tcost, "uniform"),
                               engine="host", device="cpu")
    pipe = make_engine(m, plan)
    assert pipe.describe()["engine"] == "host" and pipe.describe()["schedule"] == plan.schedule
    cfg = plan.to_config(engine="compiled")
    assert isinstance(cfg, GPipeConfig) and cfg.engine == "compiled" and cfg.device == "cpu"
    assert cfg.balance == plan.balance and cfg.chunks == plan.chunks
    with pytest.raises(TypeError, match="PipelinePlan"):
        make_engine(m, {"balance": (6,)})


# ------------------------------------------------------------ profiling --


@pytest.fixture(scope="module")
def karate_chunk():
    g = tg.load_dataset("karate")
    return g, tmb.make_plan(g, 2, strategy="sequential").stacked().graph.chunk(0)


@pytest.mark.parametrize("kind", ["gat", "gatedgraphconv"])
def test_profiler_names_every_layer_with_positive_times(karate_chunk, kind):
    g, chunk = karate_chunk
    m = tnet.build_gnn(kind, g.num_features, g.num_classes, hidden=8)
    costs = tcost.profile_layer_costs(m, m.init_params(0), chunk, repeats=1, warmup=0)
    assert costs.names == tuple(layer.name for layer in m.layers)
    for field in ("fwd", "bwd", "bwd_b", "bwd_w"):
        assert len(getattr(costs, field)) == len(m.layers)
        assert all(t > 0 for t in getattr(costs, field)), field


def test_fingerprint_differs_from_the_reference_and_sidecar_round_trips(
        karate_chunk, tmp_path, monkeypatch):
    g, chunk = karate_chunk
    m = tnet.build_paper_gat(g.num_features, g.num_classes)
    params = m.init_params(0)
    # the reference's key for the same (model, chunk, backend): it reads
    # only layer names, leaf shapes and dtypes, and the chunk's shapes
    jparams = [{k: v.numpy() for k, v in p.items()} for p in params]
    jchunk = types.SimpleNamespace(features=chunk.features.numpy(),
                                   neighbors=chunk.neighbors.numpy())
    for backend in ("padded", "pallas"):
        key = tcost.profile_fingerprint(m, params, chunk, backend)
        assert key != jcost.profile_fingerprint(m, jparams, jchunk, backend)
        assert key == tcost.profile_fingerprint(m, params, chunk, backend)
    assert tcost.profile_fingerprint(m, params, chunk, "padded") != \
        tcost.profile_fingerprint(m, params, chunk, "dense")

    path = str(tmp_path / "costs.json")
    key = tcost.profile_fingerprint(m, params, chunk, "padded")
    tcost._PROFILE_CACHE.pop(key, None)
    c1 = tcost.cached_profile_layer_costs(m, params, chunk, cache_path=path, repeats=1, warmup=0)
    with open(path) as f:
        assert key in json.load(f)
    tcost._PROFILE_CACHE.clear()  # a fresh process
    monkeypatch.setattr(tcost, "profile_layer_costs",
                        lambda *a, **k: pytest.fail("re-profiled despite the sidecar"))
    c2 = tcost.cached_profile_layer_costs(m, params, chunk, cache_path=path)
    assert (c1.names, c1.fwd, c1.bwd, c1.bwd_b, c1.bwd_w) == \
        (c2.names, c2.fwd, c2.bwd, c2.bwd_b, c2.bwd_w)
    monkeypatch.undo()
    with open(path, "w") as f:  # corrupt: ignored, the profiler is the fallback
        f.write("{not json")
    tcost._PROFILE_CACHE.clear()
    c3 = tcost.cached_profile_layer_costs(m, params, chunk, cache_path=path, repeats=1, warmup=0)
    assert c3.names == c1.names


# ---------------------------------------------------------- entry points --


def test_train_auto_dry_run_prints_the_reference_table(capsys):
    """``--auto --dry-run`` through ``run_gnn`` with injected costs prints
    the ranked table the reference's planner gives for the same costs."""
    costs = _profiles(tcost, "measured")
    ns = _namespace(PipelineCLIConfig(stages=4, auto=True, dry_run=True, device="cpu"),
        mode="gnn", dataset="karate", strategy="sequential", epochs=2, seed=0, log_every=0,
        costs_by_chunks=costs)
    out = tlaunch.run_gnn(ns)
    text = capsys.readouterr().out
    want = jauto.plan_pipeline(_stub_model(), None, params=(),
                               costs_by_chunks=_profiles(jcost, "measured"))
    assert want.format_table(limit=10) in text
    assert out == {"mode": "auto-dry-run", "schedule": want.schedule, "chunks": want.chunks,
                   "balance": list(want.balance), "predicted_step_s": want.predicted_step_s,
                   "evaluated": want.evaluated, "layer_costs": costs[want.chunks].table()}


def test_train_auto_trains_the_pick_on_cpu(capsys):
    costs = _profiles(tcost, "w-light")
    ns = _namespace(PipelineCLIConfig(stages=4, auto=True, auto_budget=60, device="cpu"),
        mode="gnn", dataset="karate", strategy="halo", epochs=2, seed=0, log_every=0,
        costs_by_chunks=costs)
    out = tlaunch.run_gnn(ns)
    plan = tauto.plan_pipeline(_stub_model(), None, tauto.PlanConstraints(budget=60),
                               params=(), costs_by_chunks=costs)
    assert out["partition"] == "auto" and out["predicted_step_s"] == plan.predicted_step_s
    assert (out["schedule"], out["chunks"], tuple(out["balance"])) == (
        plan.schedule, plan.chunks, plan.balance)
    assert "(budget-truncated)" in capsys.readouterr().out


def test_serve_auto_dry_run_profiles_on_cpu(capsys):
    args = tserve.build_parser().parse_args(
        ["--dataset", "karate", "--device", "cpu", "--auto", "--dry-run", "--auto-budget", "30"])
    out = tserve.run(args)
    assert out["mode"] == "auto-dry-run" and sum(out["balance"]) == 6
    assert "[auto] evaluated 30 candidates (budget-truncated)" in capsys.readouterr().out
