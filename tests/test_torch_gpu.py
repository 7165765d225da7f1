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
entry. The flash kernel is held at 1e-5 (2e-2 in bf16) and the SSD kernel
at atol 1e-4, the JAX package's SSD tolerance; smoke-size LM serving on the
card at 1e-4 against the same params on the CPU. The compiled engine's
captured steps are held bit for bit to its eager program and to the host
engine, under deterministic algorithms, and a streamed plan's step at
``data_parallel=2`` to ``data_parallel=1``; the double-buffered step (its
wire copies on a stream of their own) to ``off`` and to host fill-drain. The double-buffered loader's
copies must come from pinned memory, on a stream of their own, and arrive
bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core.microbatch import make_plan
from repro_torch.core.pipeline import GPipeConfig, make_engine
from repro_torch.graphs import data as tdata
from repro_torch.graphs import DoubleBufferedLoader, load_dataset, open_streamed, streamed_plan
from repro_torch.graphs import partition as tpart
from repro_torch.kernels.gat_edge import kernel as K
from repro_torch.kernels.gat_edge import ops as tops
from repro_torch.kernels.gat_edge import ref as tref
from repro_torch.kernels.spmm import kernel as SK
from repro_torch.kernels.spmm import ops as sops
from repro_torch.kernels.spmm import ref as sref
from repro_torch.launch import serve_gnn as tserve
from repro_torch.kernels.flash import kernel as FK
from repro_torch.kernels.flash.ref import flash_attention_ref
from repro_torch.kernels.ssd import kernel as SSK
from repro_torch.kernels.ssd.ops import ssd as ssd_op
from repro_torch.kernels.ssd.ref import ssd_chunk_scan
from repro_torch.launch import serve as lm_serve
from repro_torch.models.gnn.net import build_gnn, build_paper_gat, chunk_keys
from repro_torch.models.transformer import moe as tmoe
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
@pytest.mark.parametrize("heads,f", [(8, 16), (8, 7), (1, 64), (8, 8), (3, 5), (40, 5)])
def test_bucket_kernel_heads_and_widths_on_card(cuda, heads, f):
    """One warp per row for all heads: H x F above 32 columns (8 x 16), the
    paper's second layer (8 x 7), one wide head (1 x 64), heads that are not
    a power of two, and 40 heads (a full block of 32 and a short one, whose
    column passes differ); every skewed-powerlaw bucket up to
    W 558 (rows split over warps), with holes in the mask, a fully masked
    row (exactly 0) and, in a copy, an out-of-range index (a NaN row). Two
    calls are bit-identical."""
    g = load_dataset("skewed-powerlaw").to(cuda)
    rng = np.random.default_rng(heads * 100 + f)
    x = tuple(torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.standard_normal((g.num_nodes, heads, f)), rng.standard_normal((g.num_nodes, heads)),
        rng.standard_normal((g.num_nodes, heads))))
    for b in tpart.degree_bucketed_layout(g).buckets:
        mask = b.mask.clone()
        mask[:, 1::3] = False  # holes
        mask[0] = False  # a fully masked row
        args = (b.neighbors, mask.contiguous(), b.row_node)
        got = K.bucket_gat_kernel(*x, *args)
        again = K.bucket_gat_kernel(*x, *args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        torch.testing.assert_close(got, tref.gat_edge_ref(*x, *args), rtol=1e-5, atol=1e-5)
        assert (got[~mask.any(1)] == 0).all()
        bad, live = b.neighbors.clone(), mask.clone()
        bad[1, -1], live[1, -1] = g.num_nodes, True
        out = K.bucket_gat_kernel(*x, bad, live, b.row_node)
        torch.cuda.synchronize()
        assert out[1].isnan().all() and out[torch.arange(b.rows, device=cuda) != 1].isfinite().all()
    b = tpart.degree_bucketed_layout(g).buckets[0]
    before = K.bucket_gat_kernel.launches
    empty = K.bucket_gat_kernel(*x, b.neighbors[:0], b.mask[:0], b.row_node[:0])
    assert empty.shape == (0, heads, f) and K.bucket_gat_kernel.launches == before


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
    """Both engines serve through the kernel. The host engine launches it on
    every call; the compiled engine records it twice a bucket (the graph's
    warm-up and its capture), and its replays launch it without counting."""
    for engine in ("host", "compiled"):
        args = tserve.build_parser().parse_args([
            "--dataset", "karate", "--qps", "100", "--duration", "0.3", "--backend", "kernel",
            "--verify", "--verify-atol", "1e-5", "--device", "cuda", "--engine", engine,
        ])
        K.gat_aggregate_kernel.launches = 0
        summary = tserve.run(args)
        if engine == "host":
            calls = sum(v["batches"] for v in summary["buckets"].values())
            calls += tserve.WARM_CALLS * summary["warm_buckets"]
        else:
            calls = 2 * summary["warm_buckets"]
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
@pytest.mark.parametrize("w", [1, 31, 33, 129])
@pytest.mark.parametrize("r", [1, 40, 48, 8192])
def test_spmm_kernel_interleaved_zero_norm_slots_on_card(cuda, r, w):
    """Live slots interleaved with zero-norm ones (not trailing), at widths
    around a 32-slot group and the row counts of the fig3 plan's wide
    buckets (40, 48), where a row's slots are split over warps, and of the
    padded layout (8192); every fifth row all zero. Twice, bit-identical."""
    rng = np.random.default_rng(r * 1000 + w)
    nbr = torch.from_numpy(rng.integers(0, 8192, (r, w)).astype(np.int32)).to(cuda)
    nrm = rng.uniform(0.1, 1.0, (r, w)).astype(np.float32)
    nrm[:, 1::2] = 0.0
    nrm[::5] = 0.0
    nrm = torch.from_numpy(nrm).to(cuda)
    hw = _spmm_hw(cuda, 8192, 32, seed=w)
    got = SK.bucket_spmm_kernel(hw, nbr, nrm)
    again = SK.bucket_spmm_kernel(hw, nbr, nrm)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, sref.padded_spmm_ref(hw, nbr, nrm), rtol=1e-5, atol=1e-5)
    assert (got[(nrm == 0).all(1)] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [48, 8192])  # a split wide bucket, the padded layout
def test_spmm_kernel_out_of_range_in_padding_slot_gives_nan_row(cuda, rows):
    g = load_dataset("skewed-powerlaw", max_degree=128).to(cuda)
    nbr, nrm = g.neighbors[:rows].clone(), g.norm[:rows].clone()
    nbr[5, -1], nrm[5, -1] = g.num_nodes, 0.0  # only a zero-norm padding slot is bad
    hw = _spmm_hw(cuda, g.num_nodes, 16)
    out = SK.bucket_spmm_kernel(hw, nbr, nrm)
    torch.cuda.synchronize()
    assert out[5].isnan().all()
    assert out[torch.arange(rows, device=cuda) != 5].isfinite().all()


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


# ------------------------------------------------ flash attention, SSD --
# The two LM-serving kernels against their plain versions on the card, on
# phase 2's edge cases of chip_smoke.py: flash at atol/rtol 1e-5 (bf16 at
# 2e-2), SSD's y and final state at atol 1e-4 (the JAX package's SSD
# tolerance). Inputs are numpy draws at unit scale (flash) and at the JAX
# SSD tests' scales.


def _flash_inputs(dev, b, s, h, kv, hd, hd_v=None, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd if hd_v is None else hd_v))
    return tuple(torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(dev, dtype)
                 for sh in shapes)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,hd,hd_v,window,cap", [
    (4, 512, 32, 32, 128, None, 0, 0.0),  # the codeqwen prefill's launch shape
    (1, 256, 32, 16, 64, None, 0, 0.0),
    (2, 128, 8, 1, 32, None, 0, 0.0),
    (1, 512, 4, 2, 128, None, 128, 0.0),
    (1, 192, 4, 2, 64, None, 0, 50.0),
    (2, 64, 4, 4, 32, None, 0, 0.0),
    (1, 200, 4, 2, 64, None, 48, 30.0),
    (1, 513, 8, 8, 128, None, 0, 0.0),
    (2, 96, 4, 2, 48, 16, 0, 0.0),
    (1, 70, 2, 1, 256, 256, 0, 0.0),
    (2, 256, 14, 2, 128, None, 0, 0.0),  # arctic's grouping of 7 query heads
    (2, 300, 8, 8, 192, 128, 0, 0.0),  # MLA's q/k and v head dims
])
def test_flash_kernel_matches_plain_on_card(cuda, b, s, h, kv, hd, hd_v, window, cap):
    q, k, v = _flash_inputs(cuda, b, s, h, kv, hd, hd_v, seed=s + h)
    before = FK.flash_attention_kernel.launches
    got = FK.flash_attention_kernel(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert FK.flash_attention_kernel.launches == before + 1
    want = flash_attention_ref(q, k, v, window=window, softcap=cap)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 513])
@pytest.mark.parametrize("hd,hd_v", [(64, 64), (128, 128), (128, 64), (256, 256)])
def test_flash_kernel_tilings_on_card(cuda, s, hd, hd_v):
    """S around the 16-row warp tiles, the 16/32/64-key KV tiles and the
    64/128-row query tiles, at every head-dim configuration."""
    q, k, v = _flash_inputs(cuda, 2, s, 8, 4, hd, hd_v, seed=s + hd + hd_v)
    got = FK.flash_attention_kernel(q, k, v)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,h,kv,hd,window,cap", [
    (300, 8, 4, 128, 100, 0.0),  # a window crossing KV and query tile edges
    (257, 8, 4, 64, 40, 30.0),  # window and softcap
    (256, 32, 8, 128, 0, 0.0),  # GQA 32/8
    (129, 4, 2, 256, 0, 50.0),
])
def test_flash_kernel_window_softcap_gqa_on_card(cuda, dtype, tol, s, h, kv, hd, window, cap):
    q, k, v = _flash_inputs(cuda, 2, s, h, kv, hd, dtype=dtype, seed=s + window)
    got = FK.flash_attention_kernel(q, k, v, window=window, softcap=cap)
    assert got.dtype == dtype
    want = flash_attention_ref(q, k, v, window=window, softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_kernel_bf16_on_card(cuda):
    q, k, v = _flash_inputs(cuda, 2, 300, 8, 2, 128, dtype=torch.bfloat16, seed=1)
    got = FK.flash_attention_kernel(q, k, v)
    assert got.dtype == torch.bfloat16
    want = flash_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_flash_kernel_rejects_bad_inputs_on_card(cuda):
    q, k, v = _flash_inputs(cuda, 1, 64, 4, 3, 32)
    with pytest.raises(ValueError, match="group"):
        FK.flash_attention_kernel(q, k, v)
    q, k, v = _flash_inputs(cuda, 1, 64, 4, 2, 32)
    with pytest.raises(ValueError, match="contiguous"):
        FK.flash_attention_kernel(q.transpose(1, 2), k, v)
    with pytest.raises(TypeError):
        FK.flash_attention_kernel(q.half(), k.half(), v.half())


def _t_row(dev, s, s_front):
    """m-rope's t-row (``model.make_positions``): the frontend rows at 0,
    then 1, 2, ... for the text."""
    idx = torch.arange(s, dtype=torch.int32)
    return torch.where(idx < s_front, 0, idx - s_front + 1).to(torch.int32).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,s_front,window", [
    (4, 512, 12, 2, 128, 128, 0),  # qwen2-vl's prefill launch
    (4, 256, 12, 2, 128, 64, 0),  # qwen2-vl's training launch
    (2, 300, 8, 2, 128, 100, 0),  # a prefix that ends inside a KV tile
    (2, 300, 8, 2, 128, 100, 40),  # a prefix and a window
    (2, 257, 8, 4, 64, 33, 20),
    (1, 200, 4, 2, 256, 50, 0),
    (2, 70, 4, 2, 128, 70, 0),  # all frontend: every row sees every row
])
def test_flash_kernel_masks_by_positions_on_card(cuda, dtype, tol, b, s, h, kv, hd, s_front,
                                                 window):
    q, k, v = _flash_inputs(cuda, b, s, h, kv, hd, dtype=dtype, seed=s + s_front)
    pos = _t_row(cuda, s, s_front)
    before = FK.flash_attention_kernel.launches
    got = FK.flash_attention_kernel(q, k, v, window=window, q_pos=pos, kv_pos=pos)
    torch.cuda.synchronize()
    assert FK.flash_attention_kernel.launches == before + 1
    want = flash_attention_ref(q, k, v, window=window, q_pos=pos, kv_pos=pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("s,window", [(300, 0), (513, 60)])
def test_flash_kernel_masks_by_repeated_positions_on_card(cuda, s, window):
    """Sorted random positions with runs of equal values, Sq != Skv."""
    rng = np.random.default_rng(s)
    q, k, v = _flash_inputs(cuda, 2, s, 8, 2, 128, seed=s)
    k, v = k[:, : s - 37].contiguous(), v[:, : s - 37].contiguous()
    q_pos = torch.from_numpy(np.sort(rng.integers(0, s // 3, s)).astype(np.int32)).to(cuda)
    kv_pos = torch.from_numpy(np.sort(rng.integers(0, s // 3, s - 37)).astype(np.int32)).to(cuda)
    got = FK.flash_attention_kernel(q, k, v, window=window, q_pos=q_pos, kv_pos=kv_pos)
    want = flash_attention_ref(q, k, v, window=window, q_pos=q_pos, kv_pos=kv_pos)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hd,window", [(512, 128, 0), (300, 64, 100), (129, 256, 0)])
def test_flash_kernel_arange_positions_equal_the_index_path_on_card(cuda, dtype, s, hd, window):
    """Positions arange(S) give the null-pointer (index) launch's output bit
    for bit: the same tiles, in the same order, with the same mask."""
    q, k, v = _flash_inputs(cuda, 2, s, 8, 4, hd, dtype=dtype, seed=s)
    pos = torch.arange(s, dtype=torch.int32, device=cuda)
    index = FK.flash_attention_kernel(q, k, v, window=window)
    by_pos = FK.flash_attention_kernel(q, k, v, window=window, q_pos=pos, kv_pos=pos)
    assert torch.equal(index, by_pos)


@pytest.mark.gpu
def test_flash_kernel_rejects_bad_positions_on_card(cuda):
    q, k, v = _flash_inputs(cuda, 1, 64, 4, 2, 32)
    pos = torch.arange(64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="decreases"):
        FK.flash_attention_kernel(q, k, v, q_pos=pos.flip(0).contiguous(), kv_pos=pos)
    with pytest.raises(ValueError, match="both"):
        FK.flash_attention_kernel(q, k, v, q_pos=pos)
    with pytest.raises(TypeError):
        FK.flash_attention_kernel(q, k, v, q_pos=pos.long(), kv_pos=pos.long())
    with pytest.raises(ValueError, match="shape"):
        FK.flash_attention_kernel(q, k, v, q_pos=pos[:32], kv_pos=pos)


def _ssd_inputs(dev, b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1
    A = -np.exp(np.linspace(0.0, 2.0, h))
    B = rng.standard_normal((b, s, n)) * 0.3
    C = rng.standard_normal((b, s, n)) * 0.3
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, dt, A, B, C))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk,loga_scale", [
    (4, 512, 24, 64, 128, 128, 1.0),  # the mamba2-130m prefill's launch shape
    (2, 64, 24, 64, 128, 128, 1.0),
    (2, 200, 24, 64, 128, 128, 1.0),
    (2, 512, 4, 64, 128, 32, 1.0),
    (1, 77, 3, 8, 16, 16, 1.0),
    # the chunk-parallel design's edges: S = 1 (one chunk of one token), S <
    # chunk, 16 chunks through the state pass, strong decay (loga << 0, exp
    # of la underflows), b h chunks = 45 blocks (not a multiple of 132)
    (2, 1, 24, 64, 128, 128, 1.0),
    (2, 77, 24, 64, 128, 128, 1.0),
    (1, 2048, 8, 64, 128, 128, 1.0),
    (2, 512, 24, 64, 128, 128, 40.0),
    (3, 300, 5, 64, 128, 128, 1.0),
])
def test_ssd_kernel_matches_plain_on_card(cuda, b, s, h, p, n, chunk, loga_scale):
    x, dt, A, B, C = _ssd_inputs(cuda, b, s, h, p, n, seed=s)
    loga = (dt * A * loga_scale).contiguous()
    before = SSK.ssd_kernel.launches
    y, state = SSK.ssd_kernel(x, dt, loga, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert SSK.ssd_kernel.launches == before + 1
    want_y, want_state = ssd_chunk_scan(x, dt, loga, B, C, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    torch.testing.assert_close(y, want_y, rtol=0, atol=1e-4)
    torch.testing.assert_close(state, want_state, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_ssd_kernel_rejects_untiled_shapes_on_card(cuda):
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 64, 2, 96, 16)
    with pytest.raises(ValueError, match="head dim"):
        SSK.ssd_kernel(x, dt, (dt * A).contiguous(), B, C, chunk=32)
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 64, 2, 8, 16)
    with pytest.raises(ValueError, match="chunk"):
        SSK.ssd_kernel(x, dt, (dt * A).contiguous(), B, C, chunk=256)


@pytest.mark.gpu
def test_ssd_op_on_card_refuses_nonzero_h0(cuda):
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 64, 2, 8, 16)
    zero = torch.zeros((1, 2, 8, 16), device=cuda)
    y, _ = ssd_op(x, dt, A, B, C, 16, zero)  # an all-zero h0 is the kernel's own start
    torch.testing.assert_close(y, ssd_op(x, dt, A, B, C, 16)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="zero state"):
        ssd_op(x, dt, A, B, C, 16, zero + 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mamba2-130m", "musicgen-large",
                                  "qwen2-vl-2b"])
def test_lm_serving_on_card_goes_through_kernels(cuda, arch):
    """Smoke-size serving on the card launches its kernel once per layer and
    micro-batch in the prefill, and decodes the same tokens as the CPU."""
    args = lm_serve.build_parser().parse_args(
        ["--arch", arch, "--prompt-len", "80", "--decode-steps", "3", "--batch", "4"])
    wrapper = SSK.ssd_kernel if arch == "mamba2-130m" else FK.flash_attention_kernel
    wrapper.launches = 0
    served = lm_serve.serve(args)
    layers = served.cfg.num_layers
    assert wrapper.launches == layers * args.chunks
    front = None if served.frontend_embeds is None else served.frontend_embeds.cpu()
    cpu_gen = lm_serve.generate(served.cfg, served.topo, _tree_to(served.params, "cpu"),
                                served.prompt.cpu(), args.decode_steps, front)
    torch.testing.assert_close(served.generation.prefill_logits.cpu(), cpu_gen.prefill_logits,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(served.generation.tokens, cpu_gen.tokens)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b", "qwen2-vl-2b"])
def test_lm_train_step_on_card_matches_cpu(cuda, arch):
    """A smoke-size train step on the card (its forward and recompute through
    the kernels) gives the CPU step's loss at 1e-4 from the same params and
    batch."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import train as lm_train
    from repro_torch.models.transformer import model as TM

    args = lm_train.build_parser().parse_args(
        ["--mode", "lm", "--arch", arch, "--steps", "1", "--seq", "64", "--batch", "4",
         "--stages", "2", "--chunks", "2", "--log-every", "0"])
    cfg = get_arch(arch, smoke=True)
    params = TM.init_params(cfg, seed=0, num_stages=2, device=cuda)
    cpu_params = _tree_to(params, "cpu")
    SSK.ssd_kernel.launches = FK.flash_attention_kernel.launches = 0
    trained = lm_train.train_lm(cfg, args)
    layers = {"ssd": trained.topo.num_micro * cfg.num_layers, "flash": 0}
    if arch == "zamba2-7b":  # one mamba slot and one shared-block application
        layers = {"ssd": trained.topo.num_micro, "flash": trained.topo.num_micro}
    if arch == "qwen2-vl-2b":  # attention slots only, masked by m-rope's t-row
        layers = {"ssd": 0, "flash": trained.topo.num_micro * cfg.num_layers}
    # forward and recompute: two calls per slot and micro-batch
    assert SSK.ssd_kernel.launches == 2 * layers["ssd"]
    assert FK.flash_attention_kernel.launches == 2 * layers["flash"]
    step = TM.make_train_step(cfg, trained.topo, ShapeConfig("t", 64, 4, "train"), lr=args.lr)
    batch = lm_train.lm_batch(cfg, args, 0, "cpu")
    _, _, metrics = step(cpu_params, step.optimizer.init(cpu_params), batch)
    assert abs(trained.losses[0] - float(metrics["loss"])) <= 1e-4 * abs(float(metrics["loss"]))


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ------------------------------------------------- the compiled engine --
# Each compiled train step is one CUDA-graph replay. It must equal the same
# program run eagerly on the card, and the host engine's update, bit for bit
# under deterministic algorithms, with dropout on: every replay reseeds its
# draw sites from the step's key.


def _compiled_case(backend):
    g = load_dataset("karate")
    kw = {"attn_dropout": 0.0} if backend == "kernel" else {}
    model = build_paper_gat(g.num_features, g.num_classes, backend=backend, **kw)
    return model, make_plan(g, 4, strategy="halo")


def _steps(eng, model, plan, opt, keys, dev):
    params = model.init_params(0, device=dev)
    state, losses = opt.init(params), []
    for key in keys:
        params, state, loss = eng.train_step(params, state, plan, key, opt)
        losses.append(loss.clone())
    return [{k: v.clone() for k, v in p.items()} for p in params], losses


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["padded", "kernel"])
def test_compiled_captured_step_equals_eager_program_on_card(cuda, backend):
    model, plan = _compiled_case(backend)
    opt = topt.adam(5e-3, weight_decay=5e-4)
    eng = make_engine(model, GPipeConfig(balance=(2, 1, 1, 2), chunks=4, schedule="1f1b",
                                         engine="compiled", backend=backend, device="cuda"))
    torch.use_deterministic_algorithms(True)
    try:
        captured, c_losses = _steps(eng, model, plan, opt, (11, 12, 13), cuda)
        params = model.init_params(0, device=cuda)
        program, graphs, masks = eng.step_program(params, plan, opt)
        state = opt.init(params)
        for i, key in enumerate((11, 12, 13)):
            params, state, loss = program(params, state, graphs, masks,
                                          chunk_keys(key, len(model.layers)))
            assert torch.equal(loss, c_losses[i])
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(captured, params) for k in a)
    assert eng.graphs_captured == 1
    (entry,) = program.captures.values()
    launched = entry[1].captured.launches
    if backend == "kernel":
        layout = tpart.bucketize_stacked(plan.stacked().graph)
        tiles = sum(1 for b in layout.buckets if b.rows)
        assert launched == {"bucket_gat_kernel": 2 * 2 * tiles * 4}
    else:
        assert launched == {}


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["fill_drain", "zb-h1", "interleaved"])
def test_compiled_replays_redraw_the_host_masks_on_card(cuda, schedule):
    model, plan = _compiled_case("padded")  # feature and attention dropout on
    opt = topt.adam(5e-3, weight_decay=5e-4)
    nd = 2 if schedule == "interleaved" else None
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for engine in ("host", "compiled"):
            eng = make_engine(model, GPipeConfig(
                balance=(2, 1, 1, 2), chunks=4, engine=engine, device="cuda",
                schedule="fill_drain" if engine == "host" else schedule, num_devices=nd))
            runs[engine] = _steps(eng, model, plan, opt, (21, 22, 23), cuda)
        comp = make_engine(model, GPipeConfig(balance=(2, 1, 1, 2), chunks=4, engine="compiled",
                                              device="cuda"))
        host = make_engine(model, GPipeConfig(balance=(2, 1, 1, 2), chunks=4, device="cuda"))
        params = runs["host"][0]
        evals = [e.evaluate(params, plan) for e in (host, comp, comp)]
    finally:
        torch.use_deterministic_algorithms(False)
    (hp, hl), (cp, cl) = runs["host"], runs["compiled"]
    assert all(torch.equal(a, b) for a, b in zip(hl, cl)) and not torch.equal(hl[0], hl[1])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(hp, cp) for k in a)
    assert all(torch.equal(evals[0][k], e[k]) for e in evals[1:] for k in evals[0])
    assert comp.graphs_captured == 1  # one eval graph, replayed twice


@pytest.mark.gpu
def test_compiled_double_buffer_replay_bitwise_and_forked_on_card(cuda, tmp_path):
    """``overlap="double-buffer"``: the captured 1f1b step (its wire posts
    forked to a stream of their own inside the capture) gives the update of
    ``off`` and of host fill_drain bit for bit, and one profiled replay
    keeps the fork: its device copies and kernels run on more than one
    stream. (Whether a copy overlaps a kernel is timing: karate's kernels
    are a few microseconds; the smoke's cora step checks that some do.) The
    same step program run eagerly posts on the engine's wire stream, which
    the report names by its id and which runs nothing but the posts."""
    from repro_torch.core.overlap_report import (
        capture_overlap_report,
        load_trace_events,
        probe_streams,
    )

    model, plan = _compiled_case("padded")  # feature and attention dropout on
    opt = topt.adam(5e-3, weight_decay=5e-4)
    runs, engines = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, engine, schedule, overlap in (("host", "host", "fill_drain", "off"),
                                                ("off", "compiled", "1f1b", "off"),
                                                ("double", "compiled", "1f1b", "double-buffer")):
            engines[name] = make_engine(model, GPipeConfig(
                balance=(2, 1, 1, 2), chunks=4, engine=engine, schedule=schedule,
                overlap=overlap, device="cuda"))
            runs[name] = _steps(engines[name], model, plan, opt, (41, 42), cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    (hp, hl) = runs["host"]
    for name in ("off", "double"):
        p, losses = runs[name]
        assert all(torch.equal(a, b) for a, b in zip(hl, losses)), name
        assert all(torch.equal(a[k], b[k]) for a, b in zip(hp, p) for k in a), name
    eng = engines["double"]
    assert eng.wire_stream is not None and eng.graphs_captured == 1
    params = model.init_params(0, device=cuda)
    state = opt.init(params)
    report = capture_overlap_report(lambda: eng.train_step(params, state, plan, 43, opt),
                                    trace_dir=str(tmp_path))
    events = load_trace_events(str(tmp_path))
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert copies and kernels and report["num_collective_events"] == len(copies)
    assert report["collective_time_us"] > 0 and report["num_compute_events"] > 0
    assert len({e["args"]["stream"] for e in copies + kernels}) > 1
    assert any(c["args"]["stream"] != k["args"]["stream"] for c in copies for k in kernels)
    # the same program run eagerly keeps the wire stream: its posts sit there alone
    program, graphs, masks = eng.step_program(params, plan, opt)
    keys = chunk_keys(44, len(model.layers))
    wire = capture_overlap_report(lambda: program(params, state, graphs, masks, keys),
                                  wire_stream=eng.wire_stream, trace_dir=str(tmp_path / "eager"))
    events = load_trace_events(str(tmp_path / "eager"))
    _, probe = probe_streams(events)
    on_wire = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and e["args"].get("stream") in wire["wire_streams"]
               and e["args"].get("correlation") not in probe]
    assert len(wire["wire_streams"]) == 1 and wire["num_compute_events"] > 0
    assert on_wire and wire["num_collective_events"] == len(on_wire)
    assert all(e["cat"] == "gpu_memcpy" for e in on_wire)


# ------------------------- the zoo, dense, SIGN, checkpoints, the planner --


def _zoo_model(kind, backend):
    g = load_dataset("karate")
    if kind == "gat":
        return g, build_paper_gat(g.num_features, g.num_classes, backend=backend)
    return g, build_gnn(kind, g.num_features, g.num_classes, hidden=16, backend=backend)


@pytest.mark.gpu
@pytest.mark.parametrize("kind, backend", [
    ("graphconv", "padded"), ("gatedgraphconv", "kernel"), ("gat", "dense"),
])
def test_zoo_compiled_replays_equal_host_on_card(cuda, kind, backend):
    """GraphConv, GatedGraphConv (its projections on the SpMM kernel) and
    the dense GAT with dropout on: compiled replays bit-identical to the
    host fill-drain steps under deterministic algorithms."""
    from repro_torch.core.costmodel import uniform_balance

    g, model = _zoo_model(kind, backend)
    plan = make_plan(g, 4, strategy="halo")
    balance = uniform_balance(len(model.layers), 4)
    opt = topt.adam(5e-3, weight_decay=5e-4)
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for engine in ("host", "compiled"):
            eng = make_engine(model, GPipeConfig(balance=balance, chunks=4, engine=engine,
                                                 backend=backend, device="cuda"))
            runs[engine] = _steps(eng, model, plan, opt, (31, 32, 33), cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    (hp, hl), (cp, cl) = runs["host"], runs["compiled"]
    assert all(torch.equal(a, b) for a, b in zip(hl, cl))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(hp, cp) for k in a)
    assert all(torch.isfinite(v).all() for p in cp for v in p.values())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gat", "gcn", "graphconv", "gatedgraphconv"])
def test_dense_backend_matches_padded_on_card(cuda, kind):
    """Dropout 0 (the two backends draw masks of different shapes): loss and
    each gradient leaf within 1e-5 of that leaf's largest entry."""
    g = load_dataset("karate").to(cuda)
    grads = {}
    for backend in ("padded", "dense"):
        if kind == "gat":
            m = build_paper_gat(g.num_features, g.num_classes, backend=backend,
                                feat_dropout=0.0, attn_dropout=0.0)
        else:
            m = build_gnn(kind, g.num_features, g.num_classes, hidden=16, backend=backend)
        leaves = topt.requires_grad_leaves(m.init_params(0, device=cuda))
        logp = m.apply(leaves, g)
        loss = -(logp[g.train_mask].gather(1, g.labels[g.train_mask].long()[:, None])).mean()
        grads[backend] = (loss.detach(), topt.tree_grad(loss, leaves))
    (lp, gp), (ld, gd) = grads["padded"], grads["dense"]
    assert abs(float(lp - ld)) <= 1e-5 * max(1.0, abs(float(lp)))
    for a, b in zip(topt.tree_leaves(gd), topt.tree_leaves(gp)):
        assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1e-30)


@pytest.mark.gpu
def test_sign_on_card_matches_cpu_and_checkpoint_round_trips(cuda, tmp_path):
    from repro_torch.graphs.sign import as_sign_graph
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint, tree_like

    g = load_dataset("cora")
    got, want = as_sign_graph(g.to(cuda), hops=2).features.cpu(), as_sign_graph(g).features
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    m = build_paper_gat(g.num_features, g.num_classes)
    params = m.init_params(0, device=cuda)
    state = topt.adam(5e-3).init(params)
    tree = {"params": params, "opt": state}
    save_checkpoint(str(tmp_path), tree, step=5)
    loaded, meta = load_checkpoint(str(tmp_path), device=cuda)
    back = tree_like(tree, loaded)
    assert meta["step"] == 5 and back["opt"].step.device.type == "cuda"
    assert all(torch.equal(a[k], b[k]) for a, b in zip(params, back["params"]) for k in a)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(state.mu, back["opt"].mu) for k in a)


@pytest.mark.gpu
def test_planner_profiles_on_card(cuda, capsys):
    """``--auto --dry-run`` and ``--partition profiled`` on the card: every
    layer timed, the ranked table printed, the picked balance trained."""
    from repro_torch.core.costmodel import profile_fingerprint, profile_layer_costs
    from repro_torch.launch import train as tlaunch

    g = load_dataset("karate")
    chunk = make_plan(g, 2).stacked().graph.chunk(0).to(cuda)
    m = build_paper_gat(g.num_features, g.num_classes, backend="kernel", attn_dropout=0.0)
    params = m.init_params(0, device=cuda)
    costs = profile_layer_costs(m, params, chunk, repeats=2, warmup=1)
    assert all(t > 0 for t in costs.fwd + costs.bwd + costs.bwd_b + costs.bwd_w)
    assert profile_fingerprint(m, params, chunk, "kernel") != profile_fingerprint(
        m, [{k: v.cpu() for k, v in p.items()} for p in params], chunk.to("cpu"), "kernel")
    base = ["--dataset", "karate", "--stages", "4", "--chunks", "4", "--epochs", "2",
            "--log-every", "0", "--backend", "kernel"]
    out = tlaunch.main([*base, "--auto", "--dry-run"])
    assert out["mode"] == "auto-dry-run" and "[auto] evaluated" in capsys.readouterr().out
    out = tlaunch.main([*base, "--partition", "profiled", "--schedule", "1f1b"])
    assert out["device"].startswith("cuda") and sum(out["balance"]) == 6


# ------------------------------------- streamed graphs, data parallelism --


@pytest.mark.gpu
def test_loader_copies_pinned_on_a_side_stream_on_card(cuda):
    from torch.profiler import ProfilerActivity, profile

    plan = streamed_plan(open_streamed("powerlaw-64k", num_nodes=8192), 4, max_degree=16)
    host = [mb.graph for mb in plan.batches]
    loader = DoubleBufferedLoader(host)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = []
        for g in loader:
            assert g.device.type == "cuda"
            g.features.sum()  # consumer work on the current stream
            got.append(g)
        torch.cuda.synchronize()
    assert loader.copy_stream is not None
    assert loader.copy_stream != torch.cuda.current_stream()
    for g, want in zip(got, host, strict=True):
        for f in ("features", "neighbors", "mask", "norm", "labels", "train_mask", "node_ids"):
            assert torch.equal(getattr(g, f).cpu(), getattr(want, f))
    copies = [e.key for e in prof.key_averages() if "Memcpy HtoD" in e.key]
    assert copies and all("Pinned" in k for k in copies), copies


@pytest.mark.gpu
def test_streamed_compiled_step_data_parallel_bitwise_on_card(cuda):
    plan = streamed_plan(open_streamed("powerlaw-64k", num_nodes=2048, block_size=512), 4,
                         max_degree=16)
    g0 = plan.batches[0].graph
    model = build_gnn("gcn", g0.num_features, g0.num_classes, hidden=16, depth=2,
                      backend="kernel")
    opt = topt.adam(1e-2)
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for dp in (1, 2):
            eng = make_engine(model, GPipeConfig(balance=(2, 2), chunks=4, schedule="1f1b",
                                                 engine="compiled", backend="kernel",
                                                 device="cuda", data_parallel=dp))
            runs.append(_steps(eng, model, plan, opt, (5, 6), cuda))
            assert eng._data_parallel_active is False and eng.graphs_captured == 1
    finally:
        torch.use_deterministic_algorithms(False)
    (p1, l1), (p2, l2) = runs
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(p1, p2) for k in a)


@pytest.mark.gpu
@pytest.mark.parametrize("router_kind,shared,dense", [("softmax", 0, True), ("sigmoid", 1, False)])
def test_moe_apply_deterministic_on_card(cuda, router_kind, shared, dense):
    """The MoE layer (arctic's and deepseek's kinds, at a capacity that
    drops tokens) on the card: output and gradients within 1e-5 of the CPU's
    from the same params, and under deterministic algorithms two forward
    and backward passes bit-identical (the combine is a gather, the
    gathers' backward a deterministic index-put)."""
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, 64, 32, num_experts=8, num_shared=shared, dense_residual=dense,
                      router_kind=router_kind)
    x = torch.randn((96, 64), generator=gen)
    r = torch.randn((96, 64), generator=gen)
    kw = dict(num_experts=8, k=2, router_kind=router_kind, capacity_factor=0.5)

    def run(dev):
        leaves = topt.tree_map(lambda t: t.detach().to(dev).requires_grad_(True), p)
        xd = x.detach().to(dev).requires_grad_(True)
        out, _ = tmoe.moe_apply(leaves, xd, **kw)
        (out * r.to(dev)).sum().backward()
        grads = [g for g in topt.tree_leaves(topt.tree_map(lambda t: t.grad, leaves))
                 if g is not None]
        return [out.detach(), xd.grad, *grads]

    want = run("cpu")
    torch.use_deterministic_algorithms(True)
    try:
        first, again = run(cuda), run(cuda)
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))
    for got, ref in zip(first, want, strict=True):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mamba2-130m", "qwen2-vl-2b"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_meta_counts_equal_card_counts(cuda, arch, kind):
    """``roofline.counter.OpCounter`` over one smoke-size step (B 4, S 64, 2
    micro-batches) on the card and on meta: aten FLOPs and bytes equal op for
    op, kernel calls equal to the wrappers' launch counts, the kernels'
    operations equal. (The peak is held at full width in the smoke's phase
    19: at this size the allocator's 512-byte rounding of small blocks
    weighs.)"""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.dryrun import build_step, count_step
    from repro_torch.models.transformer.model import Topology

    cfg = get_arch(arch, smoke=True)
    shape = ShapeConfig("x", 80 if kind == "decode" else 64, 4, kind)
    topo = Topology(num_stages=1, num_micro=2)
    wrappers = {"flash_attention_kernel": FK.flash_attention_kernel, "ssd_kernel": SSK.ssd_kernel}
    step, inputs = build_step(cfg, shape, topo, device=cuda)
    torch.cuda.synchronize()
    before = {name: w.launches for name, w in wrappers.items()}
    card = count_step(step, inputs)
    torch.cuda.synchronize()
    launched = {name: w.launches - before[name] for name, w in wrappers.items()}
    meta = count_step(*build_step(cfg, shape, topo, device="meta"))
    assert dict(meta.flops_by_op) == dict(card.flops_by_op)
    assert dict(meta.bytes_by_op) == dict(card.bytes_by_op)
    assert meta.kernel_calls == card.kernel_calls == {k: v for k, v in launched.items() if v}
    assert meta.kernel_ops == card.kernel_ops and meta.kernel_bytes == card.kernel_bytes
