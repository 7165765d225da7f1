"""The SSD chunk scan in the port against the JAX package.

The port's plain version (``repro_torch.kernels.ssd.ref.ssd_chunk_scan``,
the route a CPU tensor takes through the kernel wrapper and the ``ssd`` op)
is held — output y and final state — against the JAX ``ssd`` op (its Pallas
kernel in interpret mode; y only), ``ssd_chunked`` and the sequential
``ssd_reference``. Inputs are numpy draws from a seed at the JAX tests'
scales. Tolerance 1e-4, the JAX package's own SSD tolerance (f32 sums over
chunk-long products in another order). The CUDA kernel is held against the
plain version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.models.transformer.ssm import ssd_chunked as jax_chunked
from repro.models.transformer.ssm import ssd_reference as jax_reference
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunk_scan
from repro_torch.models.transformer.ssm import ssd_chunked, ssd_reference

ATOL = 1e-4


def inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1).astype(np.float32)
    A = (-np.exp(np.linspace(0.0, 2.0, h))).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,chunk,h,p,n", [(64, 16, 3, 8, 16), (96, 32, 2, 4, 8),
                                           (128, 128, 2, 16, 32)])
def test_plain_matches_jax_pallas_op(s, chunk, h, p, n):
    arrays = inputs(2, s, h, p, n, seed=s + chunk)
    y, state = ssd(*t(*arrays), chunk)
    close(y, jax_ssd(*map(jnp.asarray, arrays), chunk))
    _, want_state = jax_chunked(*map(jnp.asarray, arrays), chunk=chunk)
    close(state, want_state)


@pytest.mark.parametrize("s,chunk", [(64, 16), (40, 16), (33, 32), (7, 8)])
def test_plain_matches_chunked_and_reference(s, chunk):
    arrays = inputs(2, s, 3, 8, 16, seed=s)
    jarr = tuple(map(jnp.asarray, arrays))
    y, state = ssd(*t(*arrays), chunk)
    for want_y, want_state in (jax_chunked(*jarr, chunk=chunk), jax_reference(*jarr)):
        close(y, want_y)
        close(state, want_state)
    ref_y, ref_state = ssd_reference(*t(*arrays))
    close(y, ref_y)
    close(state, ref_state)
    ch_y, ch_state = ssd_chunked(*t(*arrays), chunk=chunk)
    assert torch.equal(y, ch_y) and torch.equal(state, ch_state)


def test_h0_on_the_plain_route():
    arrays = inputs(2, 40, 3, 8, 16, seed=11)
    h0 = (np.random.default_rng(12).standard_normal((2, 3, 8, 16)) * 0.5).astype(np.float32)
    y, state = ssd(*t(*arrays), 16, torch.from_numpy(h0))
    want_y, want_state = jax_chunked(*map(jnp.asarray, arrays), chunk=16, h0=jnp.asarray(h0))
    close(y, want_y)
    close(state, want_state)
    ref_y, ref_state = ssd_reference(*t(*arrays), h0=torch.from_numpy(h0))
    close(y, ref_y)
    close(state, ref_state)


def test_op_gradient_matches_jax():
    arrays = inputs(1, 64, 2, 4, 8, seed=13)
    ct = np.random.default_rng(14).standard_normal((1, 64, 2, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_ssd(*a, 16), *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(ct))
    leaves = [a.requires_grad_() for a in t(*arrays)]
    y, _ = ssd(*leaves, 16)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(ct))
    for g, w in zip(got, want):
        close(g, w)


def test_wrapper_takes_plain_version_on_cpu():
    x, dt, A, B, C = t(*inputs(1, 50, 2, 8, 16, seed=15))
    loga = dt * A
    before = K.ssd_kernel.launches
    got = K.ssd_kernel(x, dt, loga, B, C, chunk=16)
    assert K.ssd_kernel.launches == before
    want = ssd_chunk_scan(x, dt, loga, B, C, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
