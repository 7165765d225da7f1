"""The hand-written CUDA kernel on the card, against its plain version.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips without a card; run them on one with

    python -m pytest -m gpu tests/test_torch_*.py

This file needs no JAX (the card's machine has none), so it holds all the
port's card tests. Tolerance: rtol/atol 1e-5 — the kernel sums in another
order than the plain version's einsum; fully-masked rows must be exactly 0.
"""

import numpy as np
import pytest
import torch

from repro_torch.graphs import data as tdata
from repro_torch.graphs import load_dataset, partition as tpart
from repro_torch.kernels.gat_edge import kernel as K
from repro_torch.kernels.gat_edge import ops as tops
from repro_torch.kernels.gat_edge import ref as tref
from repro_torch.launch import serve_gnn as tserve

H = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
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
