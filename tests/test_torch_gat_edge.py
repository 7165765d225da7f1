"""The port's GAT aggregation (plain versions, ops, gradients) against the
JAX package's oracles and ops; the CUDA kernel against its plain version
under the ``gpu`` marker.

The kernel itself runs only on the card: its tests are in
``test_torch_gpu.py``, which needs no JAX.

Tolerance: rtol 1e-5 / atol 1e-6 across frameworks — the summation order
differs between the einsums of the two packages (and the kernel's loops),
so results agree to float32 rounding, not bit for bit. Fully-masked rows
must be exactly 0 everywhere.
"""
# ruff: noqa: E402

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp

from repro.kernels.gat_edge import ops as jops
from repro.kernels.gat_edge import ref as jref
from repro_torch.graphs import data as tdata
from repro_torch.graphs import load_dataset, partition as tpart
from repro_torch.kernels import _build, takes_kernel
from repro_torch.kernels.gat_edge import kernel as K
from repro_torch.kernels.gat_edge import ops as tops
from repro_torch.kernels.gat_edge import ref as tref

RTOL, ATOL = 1e-5, 1e-6
H = 4


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def holed():
    """A padded karate subgraph: the mask has holes and the padding rows
    are fully masked."""
    g = load_dataset("karate")
    sub = tdata.subgraph(g, np.arange(0, g.num_nodes, 2))
    padded = tdata.pad_graph(sub, sub.num_nodes + 6, g.max_degree)
    m = padded.mask.numpy()
    assert (m[:, :-1] < m[:, 1:]).any() and (~m.any(1)).sum() == 6
    return padded


def layer_inputs(n, f, seed=0):
    rng = np.random.default_rng(seed)
    hw = rng.standard_normal((n, H, f)).astype(np.float32)
    s_src = rng.standard_normal((n, H)).astype(np.float32)
    s_dst = rng.standard_normal((n, H)).astype(np.float32)
    return hw, s_src, s_dst


# ---------------------------------------------------- plain vs JAX oracles --


@pytest.mark.parametrize("f", [8, 7, 3])
def test_gat_aggregate_ref_matches_jax_oracle(holed, f):
    n, d = holed.neighbors.shape
    rng = np.random.default_rng(f)
    nbr_hw = rng.standard_normal((H, n, d, f)).astype(np.float32)
    s_self = rng.standard_normal((H, n)).astype(np.float32)
    s_nbr = rng.standard_normal((H, n, d)).astype(np.float32)
    mask = holed.mask.numpy()
    got = tref.gat_aggregate_ref(*map(torch.from_numpy, (nbr_hw, s_self, s_nbr)), holed.mask)
    want = jref.gat_aggregate_ref(nbr_hw, s_self, s_nbr, mask)
    close(got, want)
    assert (got.numpy()[:, ~mask.any(1)] == 0).all()


def test_bucket_gat_ref_matches_jax_oracle():
    g = load_dataset("skewed-mini")
    layout = tpart.degree_bucketed_layout(g)
    rng = np.random.default_rng(1)
    hw_heads = rng.standard_normal((H, g.num_nodes, 5)).astype(np.float32)
    for b in layout.buckets:
        r, w = b.neighbors.shape
        s_self = rng.standard_normal((H, r)).astype(np.float32)
        s_nbr = rng.standard_normal((H, r, w)).astype(np.float32)
        got = tref.bucket_gat_ref(torch.from_numpy(hw_heads), b.neighbors,
                                  torch.from_numpy(s_self), torch.from_numpy(s_nbr), b.mask)
        want = jref.bucket_gat_ref(hw_heads, b.neighbors.numpy(), s_self, s_nbr, b.mask.numpy())
        close(got, want)


@pytest.mark.parametrize("f", [8, 7])
def test_op_level_plain_matches_jax_ops(holed, f):
    hw, s_src, s_dst = layer_inputs(holed.num_nodes, f)
    got = tref.gat_edge_ref(*map(torch.from_numpy, (hw, s_src, s_dst)), holed.neighbors, holed.mask)
    want = jops.gat_aggregate(hw, s_src, s_dst, holed.neighbors.numpy(), holed.mask.numpy(), 0.2)
    close(got, want)
    dead = ~holed.mask.numpy().any(1)
    assert (got.numpy()[dead] == 0).all() and (np.asarray(want)[dead] == 0).all()


def test_op_level_plain_with_row_node_is_a_row_gather(holed):
    hw, s_src, s_dst = map(torch.from_numpy, layer_inputs(holed.num_nodes, 6))
    full = tref.gat_edge_ref(hw, s_src, s_dst, holed.neighbors, holed.mask)
    rows = torch.tensor([3, 0, 7, 7], dtype=torch.int32)
    part = tref.gat_edge_ref(hw, s_src, s_dst, holed.neighbors[rows.long()],
                             holed.mask[rows.long()], rows)
    assert torch.equal(part, full[rows.long()])


# ------------------------------------------------------- ops vs JAX ops --


@pytest.mark.parametrize("slope", [0.2, 0.01])
def test_gat_aggregate_op_matches_jax(holed, slope):
    hw, s_src, s_dst = layer_inputs(holed.num_nodes, 8, seed=2)
    got = tops.gat_aggregate(*map(torch.from_numpy, (hw, s_src, s_dst)),
                             holed.neighbors, holed.mask, slope)
    want = jops.gat_aggregate(hw, s_src, s_dst, holed.neighbors.numpy(), holed.mask.numpy(), slope)
    close(got, want)
    assert (got.numpy()[~holed.mask.numpy().any(1)] == 0).all()


def _bucket_args(layout):
    return ([b.neighbors for b in layout.buckets], [b.mask for b in layout.buckets],
            [b.row_node for b in layout.buckets], layout.gather_rows)


def _jax_bucket_args(layout):
    nbrs, msks, rows, gather = _bucket_args(layout)
    return (tuple(jnp.asarray(t.numpy()) for t in nbrs), tuple(jnp.asarray(t.numpy()) for t in msks),
            tuple(jnp.asarray(t.numpy()) for t in rows), jnp.asarray(gather.numpy()))


@pytest.mark.parametrize("name", ["skewed-mini", "holed"])
def test_bucketed_op_matches_jax_and_padded(holed, name):
    g = load_dataset("skewed-mini") if name == "skewed-mini" else holed
    caps = None
    if name == "holed":  # one empty bucket, padded row capacities
        widths = (4, 8, g.max_degree)
        layout = tpart.degree_bucketed_layout(g, widths)
        caps = tuple(b.rows + 8 if b.rows else 0 for b in layout.buckets)
        layout = tpart.degree_bucketed_layout(g, widths, row_capacities=caps)
        assert any(b.rows == 0 for b in layout.buckets)
    else:
        layout = tpart.degree_bucketed_layout(g)
    hw, s_src, s_dst = layer_inputs(g.num_nodes, 16, seed=3)
    tin = tuple(map(torch.from_numpy, (hw, s_src, s_dst)))
    got = tops.bucketed_gat_aggregate(*tin, *_bucket_args(layout), 0.2)
    want = jops.bucketed_gat_aggregate(hw, s_src, s_dst, *_jax_bucket_args(layout), 0.2)
    close(got, want)
    close(got, tops.gat_aggregate(*tin, g.neighbors, g.mask, 0.2))


# ----------------------------------------------------------- gradients --


def _jax_vjp(fn, a, b, c, ct):
    """Cotangents of ``fn`` at (a, b, c), jitted (eager custom-vjp dispatch
    is slow)."""
    return jax.jit(lambda a, b, c, ct: jax.vjp(fn, a, b, c)[1](ct))(a, b, c, ct)


def test_gat_aggregate_grad_matches_jax_vjp(holed):
    hw, s_src, s_dst = layer_inputs(holed.num_nodes, 5, seed=4)
    ct = np.random.default_rng(5).standard_normal(hw.shape).astype(np.float32)
    nbr, mask = holed.neighbors.numpy(), holed.mask.numpy()
    want = _jax_vjp(lambda a, b, c: jops.gat_aggregate(a, b, c, nbr, mask, 0.2),
                    hw, s_src, s_dst, ct)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (hw, s_src, s_dst)]
    out = tops.gat_aggregate(*leaves, holed.neighbors, holed.mask)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for a, b in zip(got, want):
        close(a, b)


def test_bucketed_grad_matches_jax_vjp():
    g = load_dataset("skewed-mini")
    layout = tpart.degree_bucketed_layout(g)
    hw, s_src, s_dst = layer_inputs(g.num_nodes, 4, seed=6)
    ct = np.random.default_rng(7).standard_normal(hw.shape).astype(np.float32)
    jargs = _jax_bucket_args(layout)
    want = _jax_vjp(lambda a, b, c: jops.bucketed_gat_aggregate(a, b, c, *jargs, 0.2),
                    hw, s_src, s_dst, ct)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (hw, s_src, s_dst)]
    out = tops.bucketed_gat_aggregate(*leaves, *_bucket_args(layout))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for a, b in zip(got, want):
        close(a, b)


# -------------------------------------------------- runtime policy (CPU) --


def test_wrappers_take_plain_version_on_cpu_without_counting(holed):
    hw, s_src, s_dst = map(torch.from_numpy, layer_inputs(holed.num_nodes, 8))
    before = (K.gat_aggregate_kernel.launches, K.bucket_gat_kernel.launches)
    out = K.gat_aggregate_kernel(hw, s_src, s_dst, holed.neighbors, holed.mask)
    assert torch.equal(out, tref.gat_edge_ref(hw, s_src, s_dst, holed.neighbors, holed.mask))
    rows = torch.arange(5, dtype=torch.int32)
    out = K.bucket_gat_kernel(hw, s_src, s_dst, holed.neighbors[:5], holed.mask[:5], rows)
    assert out.shape == (5, H, 8)
    assert (K.gat_aggregate_kernel.launches, K.bucket_gat_kernel.launches) == before


def test_takes_kernel_routes_by_device():
    cpu = torch.zeros(2)
    assert takes_kernel(cpu, None) is False
    with pytest.raises(ValueError, match="no kernel"):
        takes_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="one device"):
        takes_kernel(cpu, torch.zeros(2, device="meta"))


def test_build_flags_and_source_keep_precise_exp():
    """The tolerance above assumes the precise ``expf``: no fast-math
    intrinsics or flags, and the sm_90a target."""
    src = K.SOURCE.read_text()
    assert "__expf" not in src and "expf(" in src
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
