"""The double-buffered wires (``--overlap``) and the overlap report of the
port, on the CPU at small sizes.

Inside the port, the compiled engine at wire latency 2 (``double-buffer``
and ``async``, which runs the same program) must give updates and losses
bit-identical to ``off`` and to the host engine's fill-drain, with dropout
on, for every schedule, a ragged plan with an empty chunk included.
Against the JAX package: the JAX ``CompiledGNNPipeline(overlap=
"double-buffer")`` on one CPU device, 3 steps at dropout 0, within rtol/atol
1e-5 (the two frameworks sum in other orders); the lanes executor alone
against JAX's ``spmd_pipeline_scheduled_lanes`` on the same retimed
lowering with a toy work function whose values are small integers and
halves, so the two must agree exactly. The overlap report's interval
arithmetic must equal the reference's exactly.
"""
# ruff: noqa: E402

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp

import repro.graphs as jg
from repro.core import microbatch as jmb
from repro.core import overlap_report as jrep
from repro.core import schedule as jsched
from repro.core.pipeline import GPipeConfig as JConfig
from repro.core.pipeline import make_engine as j_make_engine
from repro.core.spmd_pipe import spmd_pipeline_scheduled_lanes as j_lanes
from repro.models.gnn import net as jnet
from repro.train import optimizer as jopt
import repro_torch.graphs as tg
from repro_torch.core import microbatch as tmb
from repro_torch.core import overlap_report as trep
from repro_torch.core import schedule as tsched
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.core.spmd_pipe import spmd_pipeline_scheduled_lanes
from repro_torch.graphs import partition as tpart
from repro_torch.graphs.data import subgraph
from repro_torch.models.gnn import net as tnet
from repro_torch.models.gnn.convert import params_from_jax
from repro_torch.train import optimizer as topt

TOL = dict(rtol=1e-5, atol=1e-5)
BALANCE = (2, 1, 1, 2)
SCHEDULES = ("fill_drain", "1f1b", "zb-h1", "interleaved")


def trees_equal(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


@pytest.fixture(autouse=True)
def deterministic():
    """Bit-identity at cora's size needs it: the plain backward's index-put
    sums in a thread-dependent order on the CPU."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.fixture(scope="module")
def graphs():
    return {"karate": tg.load_dataset("karate"), "cora": tg.load_dataset("cora")}


def _train(g, plan, *, engine, schedule="fill_drain", overlap="off", steps=2, stats=None):
    """``steps`` Adam steps of the paper GAT (feature and attention dropout
    on) from seed-0 params; returns (params, losses)."""
    model = tnet.build_paper_gat(g.num_features, g.num_classes)
    nd = 2 if schedule == "interleaved" else None
    eng = make_engine(model, GPipeConfig(balance=BALANCE, chunks=plan.chunks, schedule=schedule,
                                         num_devices=nd, engine=engine, overlap=overlap,
                                         device="cpu"))
    opt = topt.adam(5e-3, weight_decay=5e-4)
    params = model.init_params(0)
    state = opt.init(params)
    losses = []
    for step in range(steps):
        params, state, loss = eng.train_step(params, state, plan, 31 + step, opt, stats=stats)
        losses.append(loss)
    return params, losses


_RUNS: dict = {}


def _cached(key, fn):
    if key not in _RUNS:
        _RUNS[key] = fn()
    return _RUNS[key]


# ------------------------------------- bit-identical to off and to host --


@pytest.mark.parametrize("overlap", ["double-buffer", "async"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("dataset", ["karate", "cora"])
def test_overlap_bit_identical_to_off_and_host_fill_drain(graphs, dataset, schedule, overlap):
    g = graphs[dataset]
    plan = _cached(("plan", dataset), lambda: tmb.make_plan(g, 4, strategy="halo"))
    host = _cached(("host", dataset), lambda: _train(g, plan, engine="host"))
    off_stats: dict = {}
    off = _cached(("off", dataset, schedule),
                  lambda: (_train(g, plan, engine="compiled", schedule=schedule,
                                  stats=off_stats), off_stats))
    stats: dict = {}
    params, losses = _train(g, plan, engine="compiled", schedule=schedule, overlap=overlap,
                            stats=stats)
    for want_params, want_losses in (host, off[0]):
        assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
        assert trees_equal(params, want_params)
    assert stats["wire_latency"] == 2 and off[1]["wire_latency"] == 1
    assert stats["num_ticks"] > off[1]["num_ticks"]


def _plan_with_empty_chunk(g, chunks=3):
    """A halo plan plus one chunk with no core node: all pad rows, count 0."""
    plan = tmb.make_plan(g, chunks, strategy="halo", halo_hops=2)
    n_pad = max(mb.num_nodes for mb in plan.batches)
    nodes, core = tpart.pad_partition(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool), n_pad)
    empty = tmb.MicroBatch(graph=subgraph(g, nodes), core_mask=torch.from_numpy(core))
    return dataclasses.replace(plan, chunks=chunks + 1, batches=plan.batches + [empty])


@pytest.mark.parametrize("schedule", ["1f1b", "zb-h1"])
def test_double_buffer_composes_with_the_empty_chunk_skip(graphs, schedule):
    """The port of the reference's ``test_empty_chunk_skips_its_ticks``: a
    ragged plan with a trailing empty chunk runs its double-buffered step in
    fewer ticks than the full retimed timeline (under 1F1B, exactly the
    clean 3-chunk plan's), with the update of ``off`` and of host
    fill-drain on the same ragged plan."""
    g = graphs["karate"]
    ragged = _plan_with_empty_chunk(g)
    clean = tmb.make_plan(g, 3, strategy="halo", halo_hops=2)
    want_params, want_losses = _train(g, ragged, engine="host")
    runs, stats = {}, {}
    for overlap in ("off", "double-buffer"):
        stats[overlap] = {}
        runs[overlap] = _train(g, ragged, engine="compiled", schedule=schedule,
                               overlap=overlap, stats=stats[overlap])
    stats["clean"] = {}
    _train(g, clean, engine="compiled", schedule=schedule, overlap="double-buffer", steps=1,
           stats=stats["clean"])
    for params, losses in runs.values():
        assert all(torch.equal(a, b) for a, b in zip(losses, want_losses))
        assert trees_equal(params, want_params)
    if schedule == "1f1b":
        assert stats["double-buffer"]["num_ticks"] == stats["clean"]["num_ticks"]
    full = tsched.lower_timeline(
        tsched.retime_timeline(tsched.get_schedule(schedule).timeline(4, 4), 4, 4), 4, 4,
        wire_latency=2)
    assert stats["double-buffer"]["num_ticks"] < full.num_ticks


# ------------------------------------------------ against the JAX engine --


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


@pytest.mark.parametrize("schedule", ["fill_drain", "1f1b", "zb-h1"])
def test_double_buffer_three_steps_match_jax_compiled(jax_case, schedule):
    jm, tm, jp, tp, (jplan, tplan) = jax_case
    kw = dict(balance=BALANCE, chunks=4, schedule=schedule, engine="compiled",
              overlap="double-buffer")
    jeng, teng = j_make_engine(jm, JConfig(**kw)), make_engine(tm, GPipeConfig(**kw, device="cpu"))
    jo, to = jopt.adam(5e-3, weight_decay=5e-4), topt.adam(5e-3, weight_decay=5e-4)
    js, ts = jo.init(jp), to.init(tp)
    jstats, tstats = {}, {}
    for step in range(3):
        jp, js, jloss = jeng.train_step(jp, js, jplan, jax.random.PRNGKey(step), jo, stats=jstats)
        tp, ts, tloss = teng.train_step(tp, ts, tplan, step, to, stats=tstats)
        np.testing.assert_allclose(np.asarray(tloss), np.asarray(jloss), **TOL)
        for t_layer, j_layer in zip(tp, jp):
            for k in t_layer:
                np.testing.assert_allclose(np.asarray(t_layer[k]), np.asarray(j_layer[k]), **TOL)
    for key in ("num_ticks", "wire_latency", "stash_slots_per_device", "w_slots_per_device"):
        assert tstats[key] == jstats[key], key


def _toy_lowering(lib, schedule):
    items = lib.get_schedule(schedule).timeline(4, 6)
    return lib.lower_timeline(lib.retime_timeline(items, 4, 6, wire_latency=2), 4, 6,
                              wire_latency=2)


def _t_toy(phase, s, c, h, ct, w):
    """The toy work: values stay small integers and halves, exact in f32."""
    h = torch.zeros(2, 3) if (h is None or s == 0) else h
    ct = torch.zeros(2, 3) if (ct is None or s == 3) else ct
    if phase == tsched.PHASE_FWD:
        return h * 1.5 + c + s, None, None, None, None, None
    last = s == 3
    loss = (h.sum(), torch.ones(())) if last else (None, None)
    d_h = None if s == 0 else ct * 0.5 + h + s
    grads = [None] * 4
    if phase == tsched.PHASE_BWD:
        grads[s] = {"g": h + ct}
        return None, d_h, None, grads, *loss
    if phase == tsched.PHASE_BWD_B:
        return None, d_h, (h, ct), None, *loss
    grads[s] = {"g": w[0] + w[1]}
    return None, None, None, grads, None, None


def _j_toy(phase, stage, chunk, h, ct, w):
    zero = jnp.zeros((2, 3), jnp.float32)
    h = jnp.where(stage == 0, zero, h)
    ct = jnp.where(stage == 3, zero, ct)
    fwd, bwd, b_half, w_half = (phase == p for p in (jsched.PHASE_FWD, jsched.PHASE_BWD,
                                                     jsched.PHASE_BWD_B, jsched.PHASE_BWD_W))
    y = jnp.where(fwd, h * 1.5 + chunk + stage, zero)
    d_h = jnp.where(bwd | b_half, ct * 0.5 + h + stage, zero)
    w_out = (jnp.where(b_half, h, zero), jnp.where(b_half, ct, zero))
    g = jnp.where(bwd, h + ct, jnp.where(w_half, w[0] + w[1], zero))
    grads = [{"g": jnp.where(stage == s, g, zero)} for s in range(4)]
    last = (stage == 3) & (bwd | b_half)
    return (y, d_h, w_out, grads, jnp.where(last, h.sum(), 0.0),
            jnp.where(last, 1.0, 0.0).astype(jnp.float32))


@pytest.mark.parametrize("schedule", ["1f1b", "zb-h1"])
def test_lanes_executor_matches_jax_lanes_at_latency_2(schedule):
    got_low, want_low = _toy_lowering(tsched, schedule), _toy_lowering(jsched, schedule)
    for name in ("phase", "stage", "chunk", "work_fslot", "in_fslot", "work_bslot", "in_bslot",
                 "work_wslot", "store_wslot"):
        assert np.array_equal(getattr(got_low, name), getattr(want_low, name)), name
    grads, loss, count = spmd_pipeline_scheduled_lanes(
        _t_toy, got_low, wire_like=torch.zeros(2, 3),
        grads_like=[{"g": torch.zeros(2, 3)} for _ in range(4)])
    j_grads, j_loss, j_count = j_lanes(
        _j_toy, want_low, wire_like=jnp.zeros((2, 3), jnp.float32),
        grads_like=[{"g": jnp.zeros((2, 3), jnp.float32)} for _ in range(4)])
    assert float(loss) == float(j_loss) and float(count) == float(j_count) == 6
    for t_g, j_g in zip(grads, j_grads):
        assert np.array_equal(t_g["g"].numpy(), np.asarray(j_g["g"]))
    assert float(loss) > 0 and any(float(g["g"].abs().sum()) > 0 for g in grads)


# ----------------------------------------------------- the overlap report --


def _ev(cat, ts, dur, *, pid=0, stream=7, name="k"):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": stream, "ts": ts, "dur": dur,
            "args": {"stream": stream}}


def test_overlap_counts_copies_hidden_by_kernels_of_the_same_device():
    events = [
        _ev("gpu_memcpy", 0, 10, stream=13, name="Memcpy DtoD (Device -> Device)"),
        _ev("kernel", 5, 20, stream=7),  # same device, another stream: hides 5 us
        _ev("kernel", 0, 10, pid=1, stream=7),  # another device: hides nothing
        _ev("gpu_memset", 0, 10, stream=7, name="Memset (Device)"),  # no compute
        _ev("cpu_op", 0, 10, stream=1, name="aten::copy_"),  # host side: ignored
    ]
    r = trep.overlap_from_events(events)
    assert r["collective_time_us"] == 10 and r["overlapped_time_us"] == 5
    assert r["overlap_fraction"] == 0.5
    assert (r["num_collective_events"], r["num_compute_events"]) == (1, 2)
    assert r["compute_time_us"] == 30


def test_overlap_streams_nccl_and_the_no_copy_case():
    # a copy on the wire stream is hidden by kernels of any other stream;
    # an NCCL kernel is communication however it is named otherwise
    events = [
        _ev("gpu_memcpy", 0, 4, stream=13),
        _ev("gpu_memcpy", 10, 4, stream=13),
        _ev("kernel", 1, 2, stream=20),
        _ev("kernel", 9, 10, stream=7),
        _ev("kernel", 30, 10, stream=21, name="ncclDevKernel_SendRecv"),
    ]
    r = trep.overlap_from_events(events)
    assert r["num_collective_events"] == 3 and r["collective_time_us"] == 18
    assert r["overlapped_time_us"] == 6 and r["overlap_fraction"] == 6 / 18
    none = trep.overlap_from_events([_ev("kernel", 0, 5), _ev("kernel", 5, 5, stream=9)])
    assert none["overlap_fraction"] == 0.0 and none["num_collective_events"] == 0
    assert set(none) == set(jrep.overlap_from_events([]))


def test_overlap_names_the_wire_by_its_stream_id():
    # with the wire stream named, a copy on another stream (a bank) is not
    # communication, and anything on the wire stream is, a copy kernel too
    events = [
        _ev("gpu_memcpy", 0, 4, stream=13),
        _ev("kernel", 10, 4, stream=13, name="copy_kernel"),
        _ev("gpu_memcpy", 20, 4, stream=7),
        _ev("kernel", 2, 10, stream=7),
        _ev("kernel", 20, 4, stream=7),
    ]
    r = trep.overlap_from_events(events, wire_streams={13})
    assert (r["num_collective_events"], r["num_compute_events"]) == (2, 2)
    assert r["collective_time_us"] == 8 and r["overlapped_time_us"] == 4
    assert r["overlap_fraction"] == 0.5 and r["compute_time_us"] == 14
    copies = trep.overlap_from_events(events)  # no stream named: every device copy
    assert copies["num_collective_events"] == 2 and copies["num_compute_events"] == 3


def test_probe_streams_follows_the_correlation_ids():
    def host(cat, name, ts, dur, corr=None, tid=1):
        args = {} if corr is None else {"correlation": corr}
        return {"ph": "X", "cat": cat, "name": name, "pid": 5, "tid": tid, "ts": ts,
                "dur": dur, "args": args}

    def dev(cat, ts, stream, corr):
        return {**_ev(cat, ts, 1, stream=stream), "args": {"stream": stream, "correlation": corr}}

    events = [
        host("user_annotation", trep.WIRE_PROBE, 100, 10),
        host("cuda_runtime", "cudaLaunchKernel", 102, 2, corr=1),  # inside: the probe
        host("cuda_runtime", "cudaLaunchKernel", 120, 2, corr=2),  # after the range
        host("cuda_runtime", "cudaMemcpyAsync", 104, 2, corr=3, tid=2),  # another thread
        dev("kernel", 130, 21, 1),
        dev("kernel", 131, 7, 2),
        dev("gpu_memcpy", 132, 9, 3),
    ]
    assert trep.probe_streams(events) == ({21}, {1})
    assert trep.probe_streams(events[1:]) == (set(), set())


intervals = st.lists(st.tuples(st.floats(0, 1e3, allow_nan=False),
                               st.floats(0, 50, allow_nan=False)), max_size=12)


@settings(max_examples=60, deadline=None)
@given(intervals, intervals)
def test_interval_arithmetic_equals_the_reference(a, b):
    a = [(s, s + d) for s, d in a]
    b = [(s, s + d) for s, d in b]
    assert trep._union(a) == jrep._union(a)
    ua = jrep._union(a)
    assert trep._intersect_len(b, ua) == jrep._intersect_len(b, ua)


def test_capture_overlap_report_on_cpu(tmp_path):
    g = tg.load_dataset("karate")
    plan = tmb.make_plan(g, 4, strategy="halo")
    model = tnet.build_paper_gat(g.num_features, g.num_classes)
    eng = make_engine(model, GPipeConfig(balance=BALANCE, chunks=4, schedule="1f1b",
                                         engine="compiled", overlap="double-buffer",
                                         device="cpu"))
    opt = topt.adam(5e-3)
    params = model.init_params(0)
    state = opt.init(params)
    eng.train_step(params, state, plan, 1, opt)  # built before the traced step
    r = trep.capture_overlap_report(lambda: eng.train_step(params, state, plan, 2, opt),
                                    trace_dir=str(tmp_path))
    assert set(jrep.overlap_from_events([])) <= set(r) and r["trace_dir"] == str(tmp_path)
    assert r["overlap_fraction"] == 0.0  # the CPU trace holds no device event
    assert len(trep.load_trace_events(str(tmp_path))) > 0


def test_capture_overlap_report_raises_when_the_profiler_fails(monkeypatch, tmp_path):
    import torch.profiler

    def broken(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        trep.capture_overlap_report(lambda: None)
    with pytest.raises(FileNotFoundError):
        trep.load_trace_events(str(tmp_path))
