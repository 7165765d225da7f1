"""The hand-written CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips without a card; run them on one with

    python -m pytest -m gpu tests/test_torch_*.py

This file needs no JAX (the card's machine has none), so it holds all the
port's card tests. Tolerance: rtol/atol 1e-5 — the kernels sum in another
order than the plain versions' einsums; fully-masked GAT rows and
all-zero-norm SpMM rows must be exactly 0. A kernel-backend GCN step is held
to the padded backend at 2e-4 in its loss and update (the tolerance of
``benchmarks/fig3.py``), and each gradient leaf within 1e-5 of its largest
entry.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core.microbatch import make_plan
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.graphs import data as tdata
from repro_torch.graphs import load_dataset, partition as tpart
from repro_torch.kernels.gat_edge import kernel as K
from repro_torch.kernels.gat_edge import ops as tops
from repro_torch.kernels.gat_edge import ref as tref
from repro_torch.kernels.spmm import kernel as SK
from repro_torch.kernels.spmm import ops as sops
from repro_torch.kernels.spmm import ref as sref
from repro_torch.launch import serve_gnn as tserve
from repro_torch.models.gnn.net import build_gnn
from repro_torch.train import optimizer as topt

H = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    # deterministic cuBLAS for the bit-identity test; read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def holed():
    """A padded karate subgraph: holes in the mask, 6 fully-masked rows."""
    g = load_dataset("karate")
    sub = tdata.subgraph(g, np.arange(0, g.num_nodes, 2))
    return tdata.pad_graph(sub, sub.num_nodes + 6, g.max_degree)


def layer_inputs(n, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, H, f)).astype(np.float32),
            rng.standard_normal((n, H)).astype(np.float32),
            rng.standard_normal((n, H)).astype(np.float32))


def _bucket_args(layout):
    return ([b.neighbors for b in layout.buckets], [b.mask for b in layout.buckets],
            [b.row_node for b in layout.buckets], layout.gather_rows)



def _cuda_inputs(dev, n, f, seed=0):
    return tuple(torch.from_numpy(x).to(dev) for x in layer_inputs(n, f, seed))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [8, 7, 3, 16, 40])
def test_padded_kernel_matches_plain_on_card(cuda, holed, f):
    g = load_dataset("cora").to(cuda)
    for graph in (g, holed.to(cuda)):
        x = _cuda_inputs(cuda, graph.num_nodes, f)
        before = K.gat_aggregate_kernel.launches
        got = K.gat_aggregate_kernel(*x, graph.neighbors, graph.mask)
        torch.cuda.synchronize()
        assert K.gat_aggregate_kernel.launches == before + 1
        want = tref.gat_edge_ref(*x, graph.neighbors, graph.mask)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        dead = ~graph.mask.any(1)
        assert (got[dead] == 0).all()


@pytest.mark.gpu
def test_bucket_kernel_matches_plain_on_card(cuda):
    g = load_dataset("skewed-mini").to(cuda)
    layout = tpart.degree_bucketed_layout(g)
    x = _cuda_inputs(cuda, g.num_nodes, 16)
    for b in layout.buckets:
        for r in (b.rows, max(b.rows - 3, 0), 1):  # ragged R, down to one row
            args = (b.neighbors[:r].contiguous(), b.mask[:r].contiguous(),
                    b.row_node[:r].contiguous())
            got = K.bucket_gat_kernel(*x, *args)
            torch.testing.assert_close(got, tref.gat_edge_ref(*x, *args), rtol=1e-5, atol=1e-5)
    empty = K.bucket_gat_kernel(*x, layout.buckets[0].neighbors[:0], layout.buckets[0].mask[:0],
                                layout.buckets[0].row_node[:0])
    assert empty.shape == (0, H, 16)


@pytest.mark.gpu
def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda, holed):
    g = holed.to(cuda)
    hw, s_src, s_dst = _cuda_inputs(cuda, g.num_nodes, 8)
    with pytest.raises(TypeError):
        K.gat_aggregate_kernel(hw.double(), s_src, s_dst, g.neighbors, g.mask)
    with pytest.raises(ValueError, match="contiguous"):
        K.gat_aggregate_kernel(hw.transpose(0, 1).contiguous().transpose(0, 1),
                               s_src, s_dst, g.neighbors, g.mask)
    with pytest.raises(TypeError):
        K.gat_aggregate_kernel(hw, s_src, s_dst, g.neighbors.long(), g.mask)
    with pytest.raises(ValueError, match="one device"):
        K.gat_aggregate_kernel(hw, s_src, s_dst, g.neighbors.cpu(), g.mask)


@pytest.mark.gpu
def test_ops_on_card_launch_kernel_and_match_cpu(cuda):
    g = load_dataset("skewed-mini")
    layout = tpart.degree_bucketed_layout(g)
    x = tuple(map(torch.from_numpy, layer_inputs(g.num_nodes, 8, seed=8)))
    want = tops.bucketed_gat_aggregate(*x, *_bucket_args(layout))
    lc = layout.to(cuda)
    before = K.bucket_gat_kernel.launches
    got = tops.bucketed_gat_aggregate(*(t.to(cuda) for t in x), *_bucket_args(lc))
    assert K.bucket_gat_kernel.launches == before + sum(1 for b in lc.buckets if b.rows)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    # backward on the card recomputes through the plain version
    leaves = [t.to(cuda).requires_grad_(True) for t in x]
    out = tops.gat_aggregate(*leaves, g.neighbors.to(cuda), g.mask.to(cuda))
    out.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)



@pytest.mark.gpu
def test_serving_on_card_goes_through_kernel(cuda):
    args = tserve.build_parser().parse_args([
        "--dataset", "karate", "--qps", "100", "--duration", "0.3", "--backend", "kernel",
        "--verify", "--verify-atol", "1e-5", "--device", "cuda",
    ])
    K.gat_aggregate_kernel.launches = 0
    summary = tserve.run(args)
    calls = sum(v["batches"] for v in summary["buckets"].values())
    calls += tserve.WARM_CALLS * summary["warm_buckets"]
    assert summary["verify_mismatches"] == 0
    assert K.gat_aggregate_kernel.launches == 2 * summary["chunks"] * calls + 2


# ------------------------------------------------------------------ SpMM --


def _spmm_hw(dev, n, f, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [256, 32, 16, 7, 1])
def test_padded_spmm_kernel_matches_plain_on_card(cuda, holed, f):
    for graph in (load_dataset("cora").to(cuda), holed.to(cuda)):
        hw = _spmm_hw(cuda, graph.num_nodes, f, seed=f)
        before = SK.padded_spmm_kernel.launches
        got = SK.padded_spmm_kernel(hw, graph.neighbors, graph.norm)
        torch.cuda.synchronize()
        assert SK.padded_spmm_kernel.launches == before + 1
        torch.testing.assert_close(got, sref.padded_spmm_ref(hw, graph.neighbors, graph.norm),
                                   rtol=1e-5, atol=1e-5)
        dead = (graph.norm == 0).all(1)
        assert (got[dead] == 0).all()


@pytest.mark.gpu
def test_bucket_spmm_kernel_edges_on_card(cuda):
    g = load_dataset("skewed-mini").to(cuda)
    layout = tpart.degree_bucketed_layout(g)
    hw = _spmm_hw(cuda, g.num_nodes, 16)
    for b in layout.buckets:
        for r in (b.rows, max(b.rows - 3, 0), 1):  # ragged R, down to one row
            nbr, nrm = b.neighbors[:r].contiguous(), b.norm[:r].contiguous()
            torch.testing.assert_close(SK.bucket_spmm_kernel(hw, nbr, nrm),
                                       sref.padded_spmm_ref(hw, nbr, nrm), rtol=1e-5, atol=1e-5)
    before = SK.bucket_spmm_kernel.launches
    empty = SK.bucket_spmm_kernel(hw, layout.buckets[0].neighbors[:0], layout.buckets[0].norm[:0])
    assert empty.shape == (0, 16) and SK.bucket_spmm_kernel.launches == before
    w1 = SK.padded_spmm_kernel(hw, g.neighbors[:, :1].contiguous(), g.norm[:, :1].contiguous())
    torch.testing.assert_close(w1, g.norm[:, :1] * hw, rtol=1e-5, atol=1e-5)
    bad = g.neighbors.clone()
    bad[3, 1] = -1
    out = SK.padded_spmm_kernel(hw, bad, g.norm)
    torch.cuda.synchronize()
    assert out[3].isnan().all() and out[4].isfinite().all()
    with pytest.raises(TypeError):
        SK.padded_spmm_kernel(hw.double(), g.neighbors, g.norm)
    with pytest.raises(ValueError, match="contiguous"):
        SK.padded_spmm_kernel(hw, g.neighbors, g.norm.t().contiguous().t())
    with pytest.raises(ValueError, match="one device"):
        SK.padded_spmm_kernel(hw, g.neighbors.cpu(), g.norm)


@pytest.mark.gpu
def test_spmm_ops_on_card_launch_kernel_and_match_cpu(cuda):
    g = load_dataset("skewed-mini")
    layout = tpart.degree_bucketed_layout(g)
    hw = torch.from_numpy(np.random.default_rng(3).standard_normal((g.num_nodes, 8)).astype(np.float32))
    nbrs, nrms = [b.neighbors for b in layout.buckets], [b.norm for b in layout.buckets]
    want = sops.bucketed_spmm(hw, nbrs, nrms, layout.gather_rows)
    lc = layout.to(cuda)
    before = SK.bucket_spmm_kernel.launches
    leaf = hw.to(cuda).requires_grad_(True)
    got = sops.bucketed_spmm(leaf, [b.neighbors for b in lc.buckets],
                             [b.norm for b in lc.buckets], lc.gather_rows)
    assert SK.bucket_spmm_kernel.launches == before + sum(1 for b in lc.buckets if b.rows)
    torch.testing.assert_close(got.detach().cpu(), want, rtol=1e-5, atol=1e-5)
    got.sum().backward()  # the backward recomputes through the plain version
    assert torch.isfinite(leaf.grad).all()


@pytest.mark.gpu
def test_kernel_backend_gcn_train_step_on_card(cuda):
    g = load_dataset("skewed-mini")
    plan = make_plan(g, 2, strategy="sequential")
    models = {b: build_gnn("gcn", g.num_features, g.num_classes, hidden=32, depth=2, backend=b)
              for b in ("padded", "kernel")}
    opt = topt.adam(1e-2)
    params = models["kernel"].init_params(0, device=cuda)
    layout = tpart.bucketize_stacked(plan.stacked().graph)
    tiles = sum(1 for b in layout.buckets if b.rows)
    torch.use_deterministic_algorithms(True)
    try:
        out = {}
        for backend, schedule in (("padded", "fill_drain"), ("kernel", "fill_drain"),
                                  ("kernel", "1f1b")):
            seen = []  # the reduced gradients Adam is handed

            def update(grads, state, p, seen=seen):
                seen.append(topt.tree_map(torch.clone, grads))
                return opt.update(grads, state, p)

            eng = make_engine(models[backend], GPipeConfig(
                balance=(2, 2), chunks=2, schedule=schedule, backend=backend, device="cuda"))
            before = SK.bucket_spmm_kernel.launches
            new, _, loss = eng.train_step(params, opt.init(params), plan, 1,
                                          topt.Optimizer(init=opt.init, update=update))
            out[backend, schedule] = new, loss, seen[0]
            launched = SK.bucket_spmm_kernel.launches - before
            assert launched == (0 if backend == "padded" else 2 * 2 * tiles * 2)
    finally:
        torch.use_deterministic_algorithms(False)
    k, p, k2 = out["kernel", "fill_drain"], out["padded", "fill_drain"], out["kernel", "1f1b"]
    torch.testing.assert_close(k[1], p[1], rtol=0, atol=2e-4)
    assert torch.equal(k[1], k2[1])
    for i in range(len(k[0])):
        for key in k[0][i]:
            torch.testing.assert_close(k[0][i][key], p[0][i][key], rtol=0, atol=2e-4)
            assert torch.equal(k[0][i][key], k2[0][i][key])
            grad, want = k[2][i][key], p[2][i][key]
            assert float((grad - want).abs().max()) <= 1e-5 * float(want.abs().max())
            assert torch.equal(grad, k2[2][i][key])
