"""The port's SpMM (GCN aggregation): plain versions, ops and their
gradients against the JAX package's oracles and ops on the CPU; the CUDA
kernel against its plain version is in ``test_torch_gpu.py`` (card only).

Tolerance: rtol/atol 1e-5 across frameworks — the two einsums sum in other
orders, so results agree to float32 rounding, not bit for bit. Rows whose
norms are all 0 must be exactly 0 everywhere.
"""
# ruff: noqa: E402

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp

from repro.kernels.spmm import ops as jops
from repro.kernels.spmm import ref as jref
from repro_torch.graphs import data as tdata
from repro_torch.graphs import load_dataset, partition as tpart
from repro_torch.kernels import _build, takes_kernel
from repro_torch.kernels.spmm import kernel as K
from repro_torch.kernels.spmm import ops as tops
from repro_torch.kernels.spmm import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def features(n, f, seed=0):
    return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)


@pytest.fixture(scope="module")
def holed():
    """A padded karate subgraph: holes in the mask, 6 all-zero-norm rows."""
    g = load_dataset("karate")
    sub = tdata.subgraph(g, np.arange(0, g.num_nodes, 2))
    return tdata.pad_graph(sub, sub.num_nodes + 6, g.max_degree)


@pytest.fixture(scope="module")
def skew_layout():
    g = load_dataset("skewed-mini")
    return g, tpart.degree_bucketed_layout(g)


def _tiles(layout):
    return ([b.neighbors for b in layout.buckets], [b.norm for b in layout.buckets])


@pytest.mark.parametrize("name, f", [("cora", 7), ("cora", 32), ("karate", 16)])
def test_padded_spmm_ref_matches_jax_oracle(name, f):
    g = load_dataset(name)
    hw = features(g.num_nodes, f, seed=f)
    got = tref.padded_spmm_ref(torch.from_numpy(hw), g.neighbors, g.norm)
    close(got, jref.padded_spmm_ref(hw, g.neighbors.numpy(), g.norm.numpy()))


def test_padded_spmm_ref_zero_norm_rows_exactly_zero(holed):
    hw = features(holed.num_nodes, 5)
    got = tref.padded_spmm_ref(torch.from_numpy(hw), holed.neighbors, holed.norm).numpy()
    close(got, jref.padded_spmm_ref(hw, holed.neighbors.numpy(), holed.norm.numpy()))
    dead = ~holed.mask.numpy().any(1)
    assert dead.sum() == 6 and (got[dead] == 0).all()


@pytest.mark.parametrize("f", [4, 16])
def test_bucketed_spmm_ref_matches_jax_oracle(skew_layout, f):
    g, layout = skew_layout
    hw = features(g.num_nodes, f, seed=1)
    nbrs, nrms = _tiles(layout)
    got = tref.bucketed_spmm_ref(torch.from_numpy(hw), nbrs, nrms, layout.gather_rows)
    want = jref.bucketed_spmm_ref(hw, tuple(n.numpy() for n in nbrs),
                                  tuple(n.numpy() for n in nrms), layout.gather_rows.numpy())
    close(got, want)
    # the bucketed layout computes the padded layout's function
    close(got, tref.padded_spmm_ref(torch.from_numpy(hw), g.neighbors, g.norm))


def test_padded_op_forward_and_grads_match_jax(holed):
    hw = features(holed.num_nodes, 6, seed=2)
    ct = features(holed.num_nodes, 6, seed=3)
    nbr, nrm = holed.neighbors, holed.norm
    t_hw = torch.from_numpy(hw).requires_grad_(True)
    t_nrm = nrm.clone().requires_grad_(True)
    out = tops.padded_spmm(t_hw, nbr, t_nrm)
    out.backward(torch.from_numpy(ct))
    j_out, vjp = jax.vjp(lambda a, w: jops.padded_spmm(a, jnp.asarray(nbr.numpy()), w),
                         jnp.asarray(hw), jnp.asarray(nrm.numpy()))
    d_hw, d_nrm = vjp(jnp.asarray(ct))
    close(out.detach(), j_out)
    close(t_hw.grad, d_hw)
    close(t_nrm.grad, d_nrm)


def test_bucketed_op_forward_and_grads_match_jax(skew_layout):
    g, layout = skew_layout
    hw = features(g.num_nodes, 8, seed=4)
    ct = features(g.num_nodes, 8, seed=5)
    nbrs, nrms = _tiles(layout)
    t_hw = torch.from_numpy(hw).requires_grad_(True)
    t_nrms = [n.clone().requires_grad_(True) for n in nrms]
    out = tops.bucketed_spmm(t_hw, nbrs, t_nrms, layout.gather_rows)
    out.backward(torch.from_numpy(ct))
    j_nbrs = tuple(jnp.asarray(n.numpy()) for n in nbrs)
    j_rows = jnp.asarray(layout.gather_rows.numpy())

    @jax.jit
    def j_fwd_bwd(a, w, c):
        out, vjp = jax.vjp(lambda a, w: jops.bucketed_spmm(a, j_nbrs, w, j_rows), a, w)
        return out, vjp(c)

    j_out, (d_hw, d_nrms) = j_fwd_bwd(jnp.asarray(hw), tuple(jnp.asarray(n.numpy()) for n in nrms),
                                      jnp.asarray(ct))
    close(out.detach(), j_out)
    close(t_hw.grad, d_hw)
    assert len(d_nrms) == len(t_nrms)
    for t, j in zip(t_nrms, d_nrms):
        close(t.grad, j)


def test_ops_skip_unwanted_norm_grads_and_empty_buckets(skew_layout):
    g, layout = skew_layout
    hw = torch.from_numpy(features(g.num_nodes, 3)).requires_grad_(True)
    nbrs, nrms = _tiles(layout)
    nbrs = [*nbrs, torch.zeros((0, 4), dtype=torch.int32)]
    nrms = [*nrms, torch.zeros((0, 4))]
    out = tops.bucketed_spmm(hw, nbrs, nrms, layout.gather_rows)
    out.sum().backward()
    assert hw.grad is not None and all(n.grad is None for n in nrms)
    with pytest.raises(ValueError, match="tiles"):
        tops.bucketed_spmm(hw, nbrs, nrms[:-1], layout.gather_rows)


def test_cpu_tensors_take_the_plain_version_without_a_build(holed, monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the kernel must not build for CPU tensors")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(K, "load_library", no_build)
    hw = torch.from_numpy(features(holed.num_nodes, 4))
    before = (K.padded_spmm_kernel.launches, K.bucket_spmm_kernel.launches)
    got = K.padded_spmm_kernel(hw, holed.neighbors, holed.norm)
    assert torch.equal(got, tref.padded_spmm_ref(hw, holed.neighbors, holed.norm))
    tile = K.bucket_spmm_kernel(hw, holed.neighbors[:5], holed.norm[:5])
    assert tile.shape == (5, 4)
    assert (K.padded_spmm_kernel.launches, K.bucket_spmm_kernel.launches) == before
    assert not takes_kernel(hw, holed.neighbors)
    with pytest.raises(ValueError, match="one device"):
        takes_kernel(hw, holed.neighbors.to("meta"))
