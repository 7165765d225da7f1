"""The port's paper GAT and serving path against the JAX package's.

Params cross over through ``params_from_jax``; the JAX side runs its public
ops (the jnp oracles on the CPU). Logits agree within rtol 1e-5 / atol 1e-5
(summation order differs between the two frameworks' matmuls and einsums)
and served argmax predictions are identical.
"""
# ruff: noqa: E402

import argparse
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests

from repro.core.cli import PipelineCLIConfig as JCLIConfig
from repro.core.pipeline import make_engine as j_make_engine
from repro.graphs import load_dataset as j_load
from repro.graphs.partition import degree_bucketed_layout as j_layout
from repro.launch import serve_gnn as jserve
from repro.models.gnn.net import build_paper_gat as j_build
from repro_torch.core.cli import PipelineCLIConfig, resolve_device
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.graphs import load_dataset
from repro_torch.graphs.partition import degree_bucketed_layout
from repro_torch.launch import serve_gnn as tserve
from repro_torch.models.gnn.convert import params_from_jax
from repro_torch.models.gnn.layers import gat_layer
from repro_torch.models.gnn.net import build_paper_gat

RTOL = ATOL = 1e-5


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _jax_apply(jm):
    return jax.jit(lambda p, g: jm.apply(p, g, train=False))


@pytest.fixture(scope="module")
def cora():
    g, jg = load_dataset("cora"), j_load("cora")
    jm = j_build(jg.num_features, jg.num_classes, backend="pallas")
    jparams = jm.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return g, jg, jm, jparams, params


@pytest.fixture(scope="module")
def cora_cases(cora):
    """(port graph, JAX logits) for the full cora graph and a padded, holed
    two-seed ego batch."""
    g, jg, jm, jparams, _ = cora
    sub, _ = tserve.ego_subgraph(g, [5, 900], 2)
    jsub, _ = jserve.ego_subgraph(jg, [5, 900], 2)
    apply = _jax_apply(jm)
    return [(g, apply(jparams, jg)),
            (tserve.pad_graph(sub, 128, g.max_degree),
             apply(jparams, jserve.pad_graph(jsub, 128, jg.max_degree)))]


# ------------------------------------------------------------------ model --


def test_params_from_jax_keeps_names_and_shapes(cora):
    _, _, _, jparams, params = cora
    assert [sorted(p) for p in params] == [sorted(p) for p in jparams]
    for tp, jp in zip(params, jparams):
        for k in tp:
            assert tp[k].dtype == torch.float32
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k]))
    assert tuple(params[1]["w"].shape) == (8, 1433, 8) and tuple(params[4]["b"].shape) == (8, 7)


@pytest.mark.parametrize("backend", ["padded", "kernel", "pallas"])
def test_paper_gat_apply_matches_jax(cora, cora_cases, backend):
    g, params = cora[0], cora[4]
    tm = build_paper_gat(g.num_features, g.num_classes, backend=backend)
    for tgraph, want in cora_cases:
        with torch.inference_mode():
            got = tm.apply(params, tgraph, train=False)
        close(got, want)
        assert torch.isfinite(got).all()


def test_kernel_backend_over_buckets_matches_jax():
    g, jg = load_dataset("skewed-mini"), j_load("skewed-mini")
    jm = j_build(jg.num_features, jg.num_classes, backend="pallas")
    jparams = jm.init_params(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    tm = build_paper_gat(g.num_features, g.num_classes, backend="kernel")
    got = tm.apply(params, degree_bucketed_layout(g), train=False)
    close(got, _jax_apply(jm)(jparams, j_layout(jg)))
    close(got, build_paper_gat(g.num_features, g.num_classes).apply(params, g))


def test_kernel_backend_rejects_attention_dropout_in_training(cora):
    g, _, _, _, params = cora
    with pytest.raises(ValueError, match="attention dropout"):
        gat_layer(params[1], g, g.features, attn_dropout=0.6, train=True,
                  generator=torch.Generator().manual_seed(0), backend="kernel")
    # eval and rate 0 are fine; the padded backend trains with dropout
    gat_layer(params[1], g, g.features, attn_dropout=0.6, train=False, backend="kernel")
    out = gat_layer(params[1], g, g.features, attn_dropout=0.6, train=True,
                    generator=torch.Generator().manual_seed(0), backend="padded")
    assert out.shape == (g.num_nodes, 64)
    with pytest.raises(ValueError, match="unknown GAT backend"):
        build_paper_gat(4, 2, backend="sparse")


def test_port_init_is_seeded_and_shaped():
    m = build_paper_gat(34, 2)
    a, b = m.init_params(3), m.init_params(3)
    assert all(torch.equal(a[i][k], b[i][k]) for i in range(len(a)) for k in a[i])
    assert tuple(a[1]["a_src"].shape) == (8, 8) and tuple(a[4]["w"].shape) == (8, 64, 2)


# ---------------------------------------------------------------- serving --


def _servers(cora, chunks):
    g, jg, jm, jparams, params = cora
    jcfg = JCLIConfig(engine="host", stages=4, chunks=chunks, backend="pallas").gpipe_config()
    jsrv = jserve.GNNServer(j_make_engine(jm, jcfg), jparams, jg, hops=2)
    tm = build_paper_gat(g.num_features, g.num_classes, backend="kernel")
    tcfg = PipelineCLIConfig(stages=4, chunks=chunks, backend="kernel", device="cpu").gpipe_config()
    tsrv = tserve.GNNServer(make_engine(tm, tcfg), params, g, hops=2)
    return jsrv, tsrv


# query seeds whose streams hold link queries and land in one shape bucket
@pytest.mark.parametrize("chunks, seed", [(2, 3), (4, 6)])
def test_served_logp_matches_jax_server(cora, chunks, seed):
    g, jg = cora[0], cora[1]
    tq = tserve.synth_queries(g, 5, qps=50.0, link_frac=0.4, seed=seed)
    jq = jserve.synth_queries(jg, 5, qps=50.0, link_frac=0.4, seed=seed)
    assert sum(q.kind == "link" for q in tq) >= 2
    assert [(q.kind, q.u, q.v, q.arrival_s) for q in tq] == [(q.kind, q.u, q.v, q.arrival_s) for q in jq]
    jsrv, tsrv = _servers(cora, chunks)
    tprep = [tsrv.prepare(q) for q in tq]
    jprep = [jsrv.prepare(q) for q in jq]
    for tp, jp in zip(tprep, jprep):
        assert (tp.bucket, tp.rows, tp.ego_nodes) == (jp.bucket, jp.rows, jp.ego_nodes)
    # group by bucket, dispatch full batches and a trailing partial one
    n_checked = 0
    for bucket in sorted({p.bucket for p in tprep}):
        ti = [i for i, p in enumerate(tprep) if p.bucket == bucket]
        for k in range(0, len(ti), chunks):
            idx = ti[k : k + chunks]
            got = tsrv.execute([tprep[i] for i in idx])
            want = jsrv.execute([jprep[i] for i in idx])
            for a, b in zip(got, want):
                close(a.logp, b.logp)
                assert a.pred == b.pred and a.query.qid == b.query.qid
                n_checked += 1
    assert n_checked == 5
    occ = tsrv.occupancy()
    assert sum(v["queries"] for v in occ.values()) == 5


def test_partial_batch_and_bucket_checks(cora):
    _, tsrv = _servers(cora, 4)
    p = tsrv.prepare(tserve.Query(0, "node", 17))
    (res,) = tsrv.execute([p])
    full = tsrv.engine.model.apply(tsrv.params, cora[0], train=False)
    assert np.array_equal(res.logp, full[[17]].numpy())
    assert tsrv.occupancy()[64]["occupancy"] == 0.25
    with pytest.raises(ValueError):
        tsrv.execute([p] * 5)


def test_shape_buckets_ladder(cora):
    b = tserve.ShapeBuckets.geometric(cora[0])
    assert b.sizes == (64, 128, 256, 512, 1024, 2048, 2708)
    assert b.bucket_of(64) == 0 and b.bucket_of(65) == 1 and b.size_of(6) == 2708
    with pytest.raises(ValueError):
        b.bucket_of(3000)


def test_serve_driver_on_cpu_writes_jax_summary_keys(tmp_path):
    args = tserve.build_parser().parse_args([
        "--dataset", "karate", "--qps", "100", "--duration", "0.2", "--backend", "pallas",
        "--verify", "--device", "cpu", "--json-out", str(tmp_path),
    ])
    summary = tserve.run(args)
    assert summary["verify_mismatches"] == 0 and summary["queries"] == 20
    jax_keys = {"dataset", "engine", "schedule", "chunks", "stages", "hops", "qps", "queries",
                "achieved_qps", "p50_s", "p99_s", "mean_s", "eval_call_s", "occupancy",
                "buckets", "verify_mismatches", "verify_exact", "verify_max_diff"}
    assert jax_keys <= set(summary)
    rows = json.loads((tmp_path / "BENCH_serve.json").read_text())["rows"]
    assert list(rows) == ["serving/karate/compiled/qps100"]
    assert "counts" in json.loads((tmp_path / "latency_hist.json").read_text())


# ------------------------------------------------------------ entry rules --


def test_no_card_means_raise_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device("cuda")
    args = tserve.build_parser().parse_args(["--dataset", "karate", "--duration", "0.1"])
    assert args.device == "cuda" and args.engine == "compiled"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run(args)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("flags, name", [
    (["--overlap", "double-buffer"], "--overlap"),
])
def test_unported_flags_raise_by_name(flags, name):
    """The flag that used to raise (``--overlap``, item 13) now serves
    karate, every served row verified: eval runs at wire latency 1 whatever
    the overlap mode."""
    args = tserve.build_parser().parse_args([
        "--dataset", "karate", "--qps", "100", "--duration", "0.1", "--verify", "--device",
        "cpu", *flags])
    assert PipelineCLIConfig.from_args(args).overlap == flags[1]
    summary = tserve.run(args)
    assert summary["verify_mismatches"] == 0 and summary["queries"] == 10
    assert summary["overlap"] == flags[1] and summary["engine"] == "compiled"


def test_data_parallel_flag_serves_on_the_compiled_engine():
    """``--data-parallel 2`` as the JAX launcher takes it: the compiled
    engine's eval programs are unaffected and serve every query verified;
    the host engine refuses it."""
    argv = ["--dataset", "karate", "--qps", "100", "--duration", "0.1", "--verify", "--device",
            "cpu", "--data-parallel", "2"]
    summary = tserve.run(tserve.build_parser().parse_args(argv))
    assert summary["verify_mismatches"] == 0 and summary["queries"] == 10
    with pytest.raises(ValueError, match="host"):
        tserve.run(tserve.build_parser().parse_args([*argv, "--engine", "host"]))


@pytest.mark.parametrize("flags", [
    ["--auto"],
    ["--auto", "--auto-budget", "5", "--backend", "pallas"],
    ["--partition", "profiled", "--backend", "kernel"],
    ["--backend", "dense"],
])
def test_planner_and_dense_flags_serve_on_cpu(capsys, flags):
    """The flags that used to raise serve karate on the CPU, every served
    row verified against the full-graph forward: ``--auto`` on the plan it
    ranked first (``--auto-budget`` truncating the ranking), ``--partition
    profiled`` on its measured balance, ``--backend dense`` over a dense
    adjacency."""
    args = tserve.build_parser().parse_args([
        "--dataset", "karate", "--qps", "100", "--duration", "0.1", "--verify", "--device",
        "cpu", *flags])
    summary = tserve.run(args)
    printed = capsys.readouterr().out
    assert summary["verify_mismatches"] == 0 and summary["queries"] == 10
    assert sum(summary["balance"]) == 6 and summary["backend"] == args.backend
    if "--auto" in flags:
        assert summary["partition"] == "auto" and "[auto] evaluated" in printed
        assert ("(budget-truncated)" in printed) == ("--auto-budget" in flags)
    elif "--partition" in flags:
        assert summary["partition"] == "profiled" and "[gnn] per-layer profile" in printed
    else:
        assert summary["balance"] == [2, 1, 1, 2]


def test_compiled_engine_and_train_step_raise_with_roadmap_item():
    """The compiled engine builds, with data parallelism too (one device runs
    one replica) and with overlap (item 13), whose served eval program gives
    the overlap-off engine's log-probs bit for bit."""
    m = build_paper_gat(34, 2)
    eng = make_engine(m, GPipeConfig(balance=(2, 1, 1, 2), chunks=2, engine="compiled", device="cpu"))
    assert eng.name == "compiled" and eng.describe()["engine"] == "compiled"
    dp = make_engine(m, GPipeConfig(balance=(2, 1, 1, 2), chunks=2, engine="compiled",
                                    device="cpu", data_parallel=2))
    assert dp.describe()["data_parallel"] == 2 and not dp._data_parallel_active
    ov = make_engine(m, GPipeConfig(balance=(2, 1, 1, 2), chunks=2, engine="compiled",
                                    device="cpu", overlap="double-buffer"))
    g = load_dataset("karate")
    server = tserve.GNNServer(ov, m.init_params(0), g, hops=2,
                              buckets=tserve.ShapeBuckets.geometric(g))
    prepared = [server.prepare(tserve.Query(i, "node", u)) for i, u in enumerate((0, 33))]
    batch = tserve.stack_graphs([p.graph for p in prepared])
    got = ov.compile_eval(m.init_params(0), batch)(batch)
    assert torch.equal(got, eng.compile_eval(m.init_params(0), batch)(batch))
    with pytest.raises(ValueError, match="balance"):
        make_engine(m, GPipeConfig(balance=(2, 2), chunks=2, device="cpu"))
    assert [eng.stage_params(list(range(6)), s) for s in range(4)] == [[0, 1], [2], [3], [4, 5]]


def test_eval_program_binds_params_once(cora):
    g = cora[0]
    m = build_paper_gat(g.num_features, g.num_classes)
    eng = make_engine(m, GPipeConfig(balance=(3, 3), chunks=2, device="cpu"))
    params = m.init_params(0)
    sub = tserve.pad_graph(tserve.ego_subgraph(g, [3], 2)[0], 64, g.max_degree)
    batch = tserve.stack_graphs([sub, sub])
    prog = eng.compile_eval(params, batch)
    placed = prog._bound[1]
    assert eng.compile_eval(params, batch) is prog and prog._bound[1] is placed
    out = prog(batch)
    assert out.shape == (2, 64, g.num_classes) and not out.requires_grad
    with pytest.raises(ValueError, match="batch shape"):
        prog(tserve.stack_graphs([sub]))


def test_cli_namespace_matches_jax_flag_names():
    """The JAX serving command lines parse unchanged (plus --device)."""
    ap = argparse.ArgumentParser()
    from repro_torch.core.cli import add_pipeline_args

    add_pipeline_args(ap, engine="host", chunks=4, stages=4)
    args = ap.parse_args(["--engine", "host", "--stages", "4", "--chunks", "4",
                          "--backend", "pallas", "--schedule", "1f1b"])
    cfg = PipelineCLIConfig.from_args(args)
    assert (cfg.backend, cfg.schedule, cfg.device) == ("pallas", "1f1b", "cuda")
