"""The port's pipeline across ranks, on the CPU over gloo.

The reference's multi-device GNN tests (``tests/test_engine.py``
``test_compiled_engine_matches_host_multidevice``,
``test_double_buffer_bit_identical_multidevice``,
``test_pallas_backend_matches_padded_multidevice``,
``test_data_parallel_mesh_multidevice`` and ``tests/test_serve_gnn.py``
``test_served_path_multidevice``) and its placed host test, as
multi-process tests: one spawn per world size (4 ranks, then 2) runs every
case of that world and returns the results to this process, which holds
them against the port's one-process host fill-drain (bit for bit: every
rank, every schedule, dropout on), against one-process serving and, with
dropout 0, against the JAX one-device ``CompiledGNNPipeline`` (1e-5).
Every rank and the one-process side run with ``torch.set_num_threads(1)``
and deterministic algorithms: the CPU index-put sums in a thread-dependent
order otherwise. Each world joins with a timeout, so a hang fails instead
of stalling the suite. The launchers run once each under ``torchrun``.

The planner on ranks (``--auto``, ``--partition profiled``) runs in the
same two worlds: through ``run_gnn`` and ``serve_gnn.run`` with injected
costs and really profiled, every rank's table digest equal, the profiler
called on rank 0 alone, and every update equal to the one-process host
fill-drain under the balance and chunks the plan chose.
"""

import ast
import contextlib
import dataclasses
import datetime
import io
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro_torch.graphs as tg
from repro_torch.core import autotune as tauto
from repro_torch.core import costmodel as tcost
from repro_torch.core import microbatch as tmb
from repro_torch.core import ranks
from repro_torch.core.cli import PipelineCLIConfig
from repro_torch.core.overlap_report import capture_rank_reports
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.core.schedule import Placement
from repro_torch.launch import serve_gnn as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models.gnn import net as tnet
from repro_torch.train import optimizer as topt

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD_TIMEOUT_S = 120.0  # a world's spawn, all its cases included
GROUP_TIMEOUT_S = 60.0
TOL = dict(rtol=1e-5, atol=1e-5)
BALANCE = (2, 1, 1, 2)
STEPS = 3
WORLD4 = ("fill_drain", "1f1b", "zb-h1")
WORLD2 = ("interleaved", "zb-v")
KARATE_ARGS = ["--dataset", "karate", "--stages", "4", "--chunks", "4", "--strategy", "halo",
               "--epochs", "3", "--log-every", "0", "--device", "cpu", "--engine", "compiled",
               "--schedule", "1f1b"]
SERVE_ARGS = ["--dataset", "karate", "--duration", "1", "--verify", "--device", "cpu",
              "--backend", "kernel"]


@contextlib.contextmanager
def one_thread():
    """One intra-op thread and deterministic algorithms, as every rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(threads)


def trees_equal(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


# --------------------------------------------------------------- the cases --


def gat(backend="padded", dropout=True, attn_dropout=True):
    g = tg.load_dataset("karate")
    kw = {} if dropout else dict(feat_dropout=0.0, attn_dropout=0.0)
    if backend == "kernel" or not attn_dropout:
        kw["attn_dropout"] = 0.0  # the fused kernel takes no attention dropout
    return tnet.build_paper_gat(g.num_features, g.num_classes, backend=backend, **kw), \
        tmb.make_plan(g, 4, strategy="halo")


def train(model, plan, balance=BALANCE, params=None, **kw):
    """``STEPS`` steps from ``params`` (the model's seed-0 init by default):
    ``(params, losses, eval dict, describe())``."""
    eng = make_engine(model, GPipeConfig(balance=balance, chunks=plan.chunks, device="cpu", **kw))
    opt = topt.adam(5e-3, weight_decay=5e-4)
    params = model.init_params(0) if params is None else params
    state, losses = opt.init(params), []
    for step in range(STEPS):
        params, state, loss = eng.train_step(params, state, plan, 11 + step, opt)
        losses.append(loss)
    return params, losses, eng.evaluate(params, plan), eng.describe()


def gcn_grid():
    plan = tg.streamed_plan(tg.open_streamed("powerlaw-64k", num_nodes=512, block_size=256), 4,
                            max_degree=16)
    g0 = plan.batches[0].graph
    return tnet.build_gnn("gcn", g0.num_features, g0.num_classes, hidden=16, depth=2), plan


def serve_queries():
    g = tg.load_dataset("karate")
    model, _ = gat("kernel")
    queries = tserve.synth_queries(g, 40, qps=400.0, link_frac=0.25, seed=0)
    return g, model, queries


def serve(lockstep=None):
    """Rank 0's (or one process's) answers to ``serve_queries`` on the
    compiled engine: ``{qid: logp}``."""
    g, model, queries = serve_queries()
    engine = make_engine(model, GPipeConfig(balance=BALANCE, chunks=4, engine="compiled",
                                            backend="kernel", device="cpu"))
    server = tserve.GNNServer(engine, model.init_params(0), g, lockstep=lockstep)
    for q in queries[:1]:
        server.warm(server.prepare(q).bucket, server.prepare(q))
    if lockstep is None:
        results = tserve.serve(server, queries, max_wait_s=0.01)
    else:
        results = tserve.serve_on_ranks(server, queries, max_wait_s=0.01)
    return {r.query.qid: r.logp for r in results}


# --------------------------------------------------- the planner on ranks --

GAT_HEAVY = (1e-5, 1e-3, 1e-5, 1e-5, 8e-4, 1e-5)  # per-layer fwd seconds a chunk: the GAT layers


def injected_costs():
    """Per chunk count, a cost table whose two GAT layers dominate: a
    deterministic pick that is not the uniform balance."""
    return {c: tcost.LayerCosts(
        names=("dropout_0", "gat_0", "elu", "dropout_1", "gat_1", "log_softmax"),
        fwd=tuple(f / c for f in GAT_HEAVY), bwd=tuple(2 * f / c for f in GAT_HEAVY),
        bwd_b=tuple(1.2 * f / c for f in GAT_HEAVY), bwd_w=tuple(0.8 * f / c for f in GAT_HEAVY))
        for c in tauto.DEFAULT_CHUNK_COUNTS}


def plan_args(argv, costs=None):
    """``run_gnn``'s namespace for karate, 3 epochs, on the compiled
    engine, with ``argv`` and injected ``costs_by_chunks``."""
    ns = tlaunch.build_parser().parse_args(
        ["--dataset", "karate", "--strategy", "halo", "--epochs", "3", "--log-every", "0",
         "--device", "cpu", "--engine", "compiled", "--stages", "4", *argv])
    if costs is not None:
        ns.costs_by_chunks = costs
    return ns


@contextlib.contextmanager
def counted_profiles(calls: list):
    """Count ``profile_layer_costs`` calls into ``calls`` (the in-process
    profile cache emptied first, so a profile is really taken)."""
    real = tcost.profile_layer_costs
    tcost._PROFILE_CACHE.clear()

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    tcost.profile_layer_costs = counting
    try:
        yield
    finally:
        tcost.profile_layer_costs = real


def planned(fn, *args):
    """``fn(*args)`` with its standard output and profiler calls caught:
    ``(result or the ValueError's message, printed text, profiles taken)``."""
    calls, text = [], io.StringIO()
    with counted_profiles(calls), contextlib.redirect_stdout(text):
        try:
            out = fn(*args)
        except ValueError as err:
            out = str(err)
    return out, text.getvalue(), len(calls)


def plan_engine_run(cli):
    """The planner's pick from injected costs (``plan_for_cli`` on this
    world), trained 3 steps on the compiled engine: ``train``'s result and
    the plan's (schedule, chunks, balance, rotation)."""
    model, _ = gat()
    plan = tauto.plan_for_cli(model, None, cli, costs_by_chunks=injected_costs(), device="cpu")
    g = tg.load_dataset("karate")
    res = train(model, tmb.make_plan(g, plan.chunks, strategy="halo"), balance=plan.balance,
                schedule=plan.schedule, num_devices=plan.num_devices, placement=plan.placement,
                engine="compiled")
    rotation = plan.placement.stage_to_device if plan.placement is not None else None
    return res, (plan.schedule, plan.chunks, plan.balance, rotation)


def planner_cases(world: int) -> dict:
    """The planner on this world's ranks: the CLI with injected and real
    profiles, the pick on the engine, and a world no candidate fits."""
    out = {}
    costs = injected_costs()
    out["auto cli"] = planned(tlaunch.run_gnn, plan_args(["--auto"], costs))
    out["auto profiled"] = planned(tlaunch.run_gnn, plan_args(["--auto"]))
    out["auto dry-run"] = planned(tlaunch.run_gnn, plan_args(["--auto", "--dry-run"], costs))
    flags = ["--partition", "profiled", "--stages", "4", "--chunks", "4"] + (
        ["--schedule", "1f1b"] if world == 4 else ["--schedule", "interleaved"])
    out["profiled cli"] = planned(tlaunch.run_gnn, plan_args(flags))
    out["auto engine"] = plan_engine_run(PipelineCLIConfig(stages=4, auto=True, device="cpu",
                                                           engine="compiled"))
    out["refuse-auto"] = planned(tlaunch.run_gnn, plan_args(
        ["--auto", "--stages", "6" if world == 4 else "3"], costs))
    if world == 4:
        serve_ns = tserve.build_parser().parse_args([*SERVE_ARGS, "--auto", "--duration", "0.5"])
        serve_ns.costs_by_chunks = costs
        out["auto serve"] = planned(tserve.run, serve_ns)
    return out


def host_fill_drain_cli(out: dict) -> dict:
    """The one-process host fill-drain under a ranked run's chosen balance
    and chunks, through ``run_gnn``'s own epoch loop: its result dict."""
    ns = plan_args([])
    g = tg.load_dataset("karate")
    model = tnet.build_paper_gat(g.num_features, g.num_classes)
    plan = tmb.make_plan(g, out["chunks"], strategy="halo", halo_hops=2, seed=0)
    cli = dataclasses.replace(PipelineCLIConfig.from_args(ns), engine="host",
                              schedule="fill_drain", chunks=out["chunks"])
    pipe = make_engine(model, cli.gpipe_config(tuple(out["balance"]), device="cpu"))
    return tlaunch._train_pipeline(ns, g, model, plan, pipe, cli=cli,
                                   balance=tuple(out["balance"]))


def refusal(fn) -> str | None:
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None


def _world_cases(world: int, jax_params):
    """Every case of one world; the rank's results by case name."""
    out = {}
    if world == 2:
        for schedule in WORLD2:
            out[schedule] = train(*gat(), schedule=schedule, num_devices=2, engine="compiled")
        model, plan = gat()
        eng = make_engine(model, GPipeConfig(balance=BALANCE, chunks=plan.chunks, device="cpu",
                                             schedule="zb-v", num_devices=2, engine="compiled"))
        opt, params = topt.adam(5e-3), model.init_params(0)
        state = opt.init(params)
        with tempfile.TemporaryDirectory() as trace_dir:
            out["reports"] = capture_rank_reports(
                lambda: eng.train_step(params, state, plan, 11, opt), trace_dir=trace_dir)
        out["refuse-world"] = refusal(lambda: train(model, plan, engine="compiled"))
        out["refuse-host"] = refusal(lambda: tlaunch.main([*KARATE_ARGS, "--engine", "host"]))
        out.update(planner_cases(world))
        return out
    for schedule in WORLD4:
        out[schedule] = train(*gat(), schedule=schedule, engine="compiled")
    out["1f1b double-buffer"] = train(*gat(), schedule="1f1b", engine="compiled",
                                      overlap="double-buffer")
    out["zb-h1 placed"] = train(*gat(), schedule="zb-h1", engine="compiled",
                                placement=Placement.ring(4, rotation=2, device_order=(2, 0, 3, 1)))
    out["zb-h1 kernel"] = train(*gat("kernel"), schedule="zb-h1", engine="compiled",
                                backend="kernel")
    if jax_params is not None:
        out["1f1b jax"] = train(*gat(dropout=False), params=jax_params, schedule="1f1b",
                                engine="compiled")
    for overlap in ("off", "double-buffer"):
        out[f"grid {overlap}"] = train(*gcn_grid(), balance=(2, 2), schedule="1f1b",
                                       engine="compiled", data_parallel=2, overlap=overlap)
    out["serve"] = serve(tserve.RankLockstep(4, "cpu"))
    model, plan = gat()
    out["refuse-world"] = refusal(lambda: train(model, plan, balance=(2, 2, 2),
                                                engine="compiled"))
    out.update(planner_cases(world))
    return out


def _rank_main(rank: int, world: int, port: int, out_dir: str, jax_params):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        results = _world_cases(world, jax_params)
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(world: int, jax_params=None) -> list:
    """Spawn ``world`` ranks running ``_world_cases``; each rank's results.
    The spawn is joined with a deadline: a hang fails, and no rank
    outlives the call."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank_main, args=(world, _free_port(), out_dir, jax_params),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise AssertionError(f"the {world}-rank world ran past {WORLD_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


# ------------------------------------------------------------ the fixtures --


def _jax_params():
    """The JAX paper GAT's seed-0 params (dropout 0) on the port's side,
    and the JAX one-device compiled engine's 3-step 1F1B params; None
    without JAX."""
    try:
        import jax
    except ImportError:
        return None, None
    import repro.graphs as jg
    from repro.core import microbatch as jmb
    from repro.core.pipeline import GPipeConfig as JConfig
    from repro.core.pipeline import make_engine as j_make_engine
    from repro.models.gnn import net as jnet
    from repro.train import optimizer as jopt
    from repro_torch.models.gnn.convert import params_from_jax

    jgraph = jg.load_dataset("karate")
    jm = jnet.build_paper_gat(jgraph.num_features, jgraph.num_classes, feat_dropout=0.0,
                              attn_dropout=0.0)
    jp = jm.init_params(jax.random.PRNGKey(0))
    start = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jeng = j_make_engine(jm, JConfig(balance=BALANCE, chunks=4, schedule="1f1b",
                                     engine="compiled"))
    jo = jopt.adam(5e-3, weight_decay=5e-4)
    js = jo.init(jp)
    plan = jmb.make_plan(jgraph, 4, strategy="halo")
    for step in range(STEPS):
        jp, js, _ = jeng.train_step(jp, js, plan, jax.random.PRNGKey(step), jo)
    return start, jp


@pytest.fixture(scope="module")
def worlds():
    """The CLI drives (started first, beside the spawns), the 4- and 2-rank
    worlds, and the one-process results they are held against."""
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
    cli = {name: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", module, *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
        for name, module, argv in (("train", "repro_torch.launch.train", KARATE_ARGS),
                                   ("serve", "repro_torch.launch.serve_gnn", SERVE_ARGS))}
    try:
        jax_start, jax_end = _jax_params()
        with one_thread():
            four = run_world(4, jax_start)
            two = run_world(2)
            host = train(*gat(), engine="host")
            alone = {
                "kernel": train(*gat("kernel"), engine="host"),
                "padded": train(*gat(attn_dropout=False), engine="host"),
                "grid": train(*gcn_grid(), balance=(2, 2), schedule="1f1b", engine="compiled"),
                "serve": serve(),
                "cli": tlaunch.main(KARATE_ARGS),
            }
            planned = {}
            g = tg.load_dataset("karate")
            for world, results in (("four", four), ("two", two)):
                for case in PLANNED:
                    planned[(world, case)] = host_fill_drain_cli(results[0][case][0])
                _, chunks, balance, _ = results[0]["auto engine"][1]
                model, _ = gat()
                planned[(world, "auto engine")] = train(
                    model, tmb.make_plan(g, chunks, strategy="halo"), balance=balance,
                    engine="host")
        outputs = {}
        for name, proc in cli.items():
            out, _ = proc.communicate(timeout=WORLD_TIMEOUT_S)
            outputs[name] = (proc.returncode, out)
    finally:
        for proc in cli.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"four": four, "two": two, "host": host, "alone": alone, "cli": outputs,
            "jax": jax_end, "planned host": planned}


# --------------------------------------------------------------- the tests --


def test_host_engine_devices_placement_matches_fill_drain():
    """The placed host engine (the reference's ``test_engine.py:318-335``):
    zb-h1 on ``devices`` under a rotated, reordered ring, bit-identical to
    the unplaced host fill-drain."""
    with one_thread():
        want = train(*gat(), engine="host")
        placement = Placement.ring(4, rotation=2, device_order=(2, 0, 3, 1))
        got = train(*gat(), engine="host", schedule="zb-h1", devices=("cpu",) * 4,
                    placement=placement)
    assert trees_equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert got[3]["devices"] == ["cpu"] * 4


def test_host_devices_follow_the_placement():
    model, _ = gat()
    eng = make_engine(model, GPipeConfig(
        balance=BALANCE, chunks=4, devices=("cpu:0", "cpu:1", "cpu:2", "cpu:3"), device="cpu",
        placement=Placement.ring(4, rotation=2, device_order=(2, 0, 3, 1))))
    # stage s at ring position (s + 2) % 4, that position on device_order's card
    assert [str(d) for d in eng._stage_devices] == ["cpu:3", "cpu:1", "cpu:2", "cpu:0"]
    with pytest.raises(ValueError, match="devices"):
        make_engine(model, GPipeConfig(balance=BALANCE, chunks=4, engine="compiled",
                                       devices=("cpu",) * 4, device="cpu"))


@pytest.mark.parametrize("schedule, world", [*[(s, "four") for s in WORLD4],
                                             *[(s, "two") for s in WORLD2]])
def test_ring_bit_identical_to_host_fill_drain(worlds, schedule, world):
    """Every rank's params, losses and eval after 3 steps with dropout on
    equal the one-process host fill-drain's bit for bit."""
    want_p, want_l, want_e, _ = worlds["host"]
    for rank, results in enumerate(worlds[world]):
        params, losses, ev, desc = results[schedule]
        assert desc["ranks"]["position"] == rank
        assert trees_equal(params, want_p), (schedule, rank)
        assert all(torch.equal(a, b) for a, b in zip(losses, want_l)), (schedule, rank)
        assert all(torch.equal(ev[k], want_e[k]) for k in want_e), (schedule, rank)


def test_ring_placement_picks_the_ranks(worlds):
    """A rotated, reordered ring: position d on rank ``device_order[d]``,
    the update still bit-identical."""
    want_p = worlds["host"][0]
    for rank, results in enumerate(worlds["four"]):
        params, _, _, desc = results["zb-h1 placed"]
        assert desc["ranks"]["rows"] == [[2, 0, 3, 1]]
        assert [2, 0, 3, 1][desc["ranks"]["position"]] == rank
        assert trees_equal(params, want_p)


def test_ring_double_buffer_bit_identical_to_off(worlds):
    for results in worlds["four"]:
        off, db = results["1f1b"], results["1f1b double-buffer"]
        assert trees_equal(db[0], off[0])
        assert all(torch.equal(a, b) for a, b in zip(db[1], off[1]))


def test_ring_kernel_backend_matches_padded(worlds):
    """The kernel backend (its plain versions on the CPU, over the bucketed
    layout) on the ring: bit-identical to its host fill-drain, and within
    1e-5 of the padded host run (attention dropout 0 on both)."""
    want_p, want_l = worlds["alone"]["kernel"][:2]
    padded_p, padded_l = worlds["alone"]["padded"][:2]
    for results in worlds["four"]:
        params, losses, _, _ = results["zb-h1 kernel"]
        assert trees_equal(params, want_p)
        assert all(torch.equal(a, b) for a, b in zip(losses, want_l))
        for t_layer, p_layer in zip(params, padded_p):
            for k in t_layer:
                np.testing.assert_allclose(t_layer[k].numpy(), p_layer[k].numpy(), **TOL)
        np.testing.assert_allclose([float(x) for x in losses], [float(x) for x in padded_l],
                                   **TOL)


def test_ring_matches_jax_one_device_compiled(worlds):
    """Dropout 0, JAX params: every rank's 1F1B params after 3 steps within
    1e-5 of the JAX one-device ``CompiledGNNPipeline``'s."""
    if worlds["jax"] is None:
        pytest.skip("JAX is not installed")
    for results in worlds["four"]:
        params = results["1f1b jax"][0]
        for t_layer, j_layer in zip(params, worlds["jax"]):
            for k in t_layer:
                np.testing.assert_allclose(t_layer[k].numpy(), np.asarray(j_layer[k]), **TOL)


def test_grid_bit_identical_to_data_parallel_1(worlds):
    """2 replicas x 2-stage ring on 4 ranks, off and double-buffered: the
    update and eval equal ``data_parallel`` 1 on one process bit for bit."""
    want_p, want_l, want_e, _ = worlds["alone"]["grid"]
    for rank, results in enumerate(worlds["four"]):
        for overlap in ("off", "double-buffer"):
            params, losses, ev, desc = results[f"grid {overlap}"]
            assert desc["ranks"]["data_parallel"] == 2 and desc["ranks"]["replica"] == rank // 2
            assert trees_equal(params, want_p), (rank, overlap)
            assert all(torch.equal(a, b) for a, b in zip(losses, want_l))
            assert all(torch.equal(ev[k], want_e[k]) for k in want_e)


def test_served_on_ranks_matches_one_process(worlds):
    """Rank 0 answers every query, bitwise as a one-process server does and
    within 1e-5 of the full-graph forward; the other ranks answer none."""
    got, want = worlds["four"][0]["serve"], worlds["alone"]["serve"]
    assert sorted(got) == sorted(want) == list(range(40))
    assert all(np.array_equal(got[q], want[q]) for q in want)
    assert all(results["serve"] == {} for results in worlds["four"][1:])
    g, model, queries = serve_queries()
    with torch.inference_mode():
        full = model.apply(model.init_params(0), g, train=False).numpy()
    for q in queries:
        np.testing.assert_allclose(got[q.qid], full[list(q.seeds)], **TOL)


def test_refusals_under_a_group(worlds):
    """A world that is neither the ring nor data_parallel x ring, and the
    host engine under torchrun, raise ValueError on every rank; ``--auto``
    is no longer refused there, but a world that no candidate's ring fits
    raises on every rank, before any profile."""
    for results in worlds["four"]:
        assert "world size 4 is neither the ring's 3 ranks" in results["refuse-world"]
    for world, key in (("four", "6 devices > max_devices 4"), ("two", "3 devices > max_devices 2")):
        for results in worlds[world]:
            msg, _, profiles = results["refuse-auto"]
            assert isinstance(msg, str) and "every candidate was pruned" in msg, msg
            assert key in msg and "positions < the" in msg and profiles == 0
    for results in worlds["two"]:
        assert "world size 2 is neither the ring's 4 ranks" in results["refuse-world"]
        assert "--engine host under torchrun" in results["refuse-host"]


PLANNED = ("auto cli", "auto profiled", "profiled cli")


@pytest.mark.parametrize("world", ["four", "two"])
@pytest.mark.parametrize("case", [*PLANNED, "auto dry-run"])
def test_planner_on_ranks_one_table(worlds, world, case):
    """``--auto`` (injected and profiled costs, and ``--dry-run``) and
    ``--partition profiled`` on the ring: every rank returns the same
    table digest and pick, rank 0 alone prints the table, and rank 0 alone
    calls the profiler (never, with injected costs)."""
    results = [r[case] for r in worlds[world]]
    outs = [out for out, _, _ in results]
    assert all(isinstance(o, dict) for o in outs), outs
    assert len({o["plan_sha"] for o in outs}) == 1
    assert all((o["balance"], o["chunks"]) == (outs[0]["balance"], outs[0]["chunks"])
               for o in outs)
    marker = "[auto] evaluated" if case != "profiled cli" else "[gnn] profiled balance="
    texts = [text for _, text, _ in results]
    assert marker in texts[0] and not any(marker in t for t in texts[1:])
    profiles = [n for _, _, n in results]
    assert profiles[1:] == [0] * (len(results) - 1)
    assert profiles[0] == (0 if case in ("auto cli", "auto dry-run") else profiles[0])
    if case in ("auto profiled", "profiled cli"):
        assert profiles[0] > 0
    ring = 4 if world == "four" else 2
    if case != "profiled cli":
        assert outs[0]["schedule"] in (("fill_drain", "1f1b", "zb-h1") if ring == 4
                                       else ("interleaved", "zb-v"))


@pytest.mark.parametrize("world", ["four", "two"])
@pytest.mark.parametrize("case", PLANNED)
def test_planner_on_ranks_matches_host_fill_drain(worlds, world, case):
    """Each rank's losses under the planned pipeline equal the one-process
    host fill-drain's under the chosen balance and chunks, bit for bit."""
    outs = [r[case][0] for r in worlds[world]]
    want = worlds["planned host"][(world, case)]
    for out in outs:
        assert out["epoch_losses"] == want["epoch_losses"], (world, case)
        assert out["ranks"] == len(outs)


@pytest.mark.parametrize("world", ["four", "two"])
def test_planned_engine_bit_identical_to_host_fill_drain(worlds, world):
    """The injected costs' pick (``plan_for_cli`` on the ranks): a balance
    other than the uniform one, on a ring as wide as the world, and every
    rank's params, losses and eval after 3 steps equal the one-process host
    fill-drain's under that balance bit for bit."""
    picks = {r["auto engine"][1] for r in worlds[world]}
    assert len(picks) == 1
    (schedule, chunks, balance, _), = picks
    assert balance != BALANCE
    want_p, want_l, want_e, _ = worlds["planned host"][(world, "auto engine")]
    for results in worlds[world]:
        params, losses, ev, desc = results["auto engine"][0]
        assert desc["ranks"]["ring"] == (4 if world == "four" else 2)
        assert trees_equal(params, want_p)
        assert all(torch.equal(a, b) for a, b in zip(losses, want_l))
        assert all(torch.equal(ev[k], want_e[k]) for k in want_e)


def test_auto_serve_on_ranks(worlds):
    """``serve_gnn --auto`` on four ranks: rank 0 serves every query on the
    planned pipeline, bit-identical to the full-graph forward (``--verify``),
    the others follow its batches."""
    first, *rest = (r["auto serve"] for r in worlds["four"])
    summary, text, profiles = first
    assert summary["partition"] == "auto" and summary["verify_mismatches"] == 0, summary
    assert "[auto] evaluated" in text and profiles == 0
    assert all("followed_batches" in out and "[auto]" not in t for out, t, _ in rest)


def test_rank_reports_gathered_on_rank_0(worlds):
    """Every rank traces its own ring step; rank 0 alone gets the reports,
    one per rank in rank order, to print them."""
    first, second = (results["reports"] for results in worlds["two"])
    assert second is None
    assert [rep["rank"] for rep in first] == [0, 1]
    for rep in first:
        assert rep["step_us"] > 0 and rep["trace_dir"].endswith(f"rank{rep['rank']}")
        # a CPU trace holds no device event, so no NCCL kernel either
        assert rep["collective_time_us"] == 0.0 and rep["num_collective_events"] == 0


def test_rank_grid_needs_a_group():
    assert not ranks.active() and ranks.join("cpu") is None and ranks.world_size() == 1
    with pytest.raises(RuntimeError, match="process group"):
        ranks.RankGrid(1, 4)


def test_train_cli_under_torchrun(worlds):
    """``torchrun ... -m repro_torch.launch.train --device cpu``: rank 0
    alone prints the result dict, with the one-process run's losses."""
    rc, out = worlds["cli"]["train"]
    assert rc == 0, out
    dicts = [ast.literal_eval(line) for line in out.splitlines() if line.startswith("{'mode'")]
    assert len(dicts) == 1, out
    assert dicts[0]["ranks"] == 4
    assert dicts[0]["epoch_losses"] == worlds["alone"]["cli"]["epoch_losses"]


def test_serve_cli_under_torchrun(worlds):
    rc, out = worlds["cli"]["serve"]
    assert rc == 0, out
    verify = [line for line in out.splitlines() if line.startswith("[serve] verify")]
    assert len(verify) == 1 and ", 0 beyond" in verify[0], out
