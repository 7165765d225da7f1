"""The SSD chunk scan in the port against the JAX package.

The port's plain version (``repro_torch.kernels.ssd.ref.ssd_chunk_scan``,
the route a CPU tensor takes through the kernel wrapper and the ``ssd`` op)
is held — output y and final state — against the JAX ``ssd`` op (its Pallas
kernel in interpret mode; y only), ``ssd_chunked`` and the sequential
``ssd_reference``. Inputs are numpy draws from a seed at the JAX tests'
scales. Tolerance 1e-4, the JAX package's own SSD tolerance (f32 sums over
chunk-long products in another order). The CUDA kernel is held against the
plain version on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``);
here its arithmetic is emulated with numpy (the chunk-parallel decomposition
in the kernel's order, 3xTF32 products) and held to the same tolerance.
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


def test_plain_gradient_finite_under_strong_decay():
    """A chunk of 128 at dt·A near -10 a step: above the diagonal la_i - la_j
    reaches ~1270, whose exp overflows. The causal mask sits inside the exp,
    so the masked entries take exp(-inf) = 0 and a zero gradient: every
    gradient stays finite (masking after the exp gave inf x 0 = NaN), and
    the output equals the sequential reference's."""
    x, dt, A, B, C = t(*inputs(1, 128, 2, 4, 8, seed=16))
    A = torch.full((2,), -100.0)
    leaves = [a.requires_grad_() for a in (x, dt, B, C)]
    y, state = ssd_chunked(leaves[0], leaves[1], A, leaves[2], leaves[3], chunk=128)
    grads = torch.autograd.grad((y.sum(), state.sum()), leaves)
    assert all(bool(g.isfinite().all()) for g in grads)
    ref_y, ref_state = ssd_reference(x.detach(), dt.detach(), A, B.detach(), C.detach())
    close(y.detach(), ref_y)
    close(state.detach(), ref_state)


def test_wrapper_takes_plain_version_on_cpu():
    x, dt, A, B, C = t(*inputs(1, 50, 2, 8, 16, seed=15))
    loga = dt * A
    before = K.ssd_kernel.launches
    got = K.ssd_kernel(x, dt, loga, B, C, chunk=16)
    assert K.ssd_kernel.launches == before
    want = ssd_chunk_scan(x, dt, loga, B, C, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------- the kernel's decomposition --
# csrc/ssd.cu runs the SSD chunk-parallel, in three launches: (1) each chunk's
# state contribution S_c = (x dt exp(la_Q - la))^T . B, (2) the state pass
# H_c+1 = exp(la_Q) H_c + S_c from H_0 = 0, (3) y = exp(la) (C . H_c^T) +
# ((C . B^T) o causal decay) . (x dt). Its products are 3xTF32 on the tensor
# cores: x = big + small with big = x truncated to TF32 (10 mantissa bits)
# and small = x - big, which the tensor cores read truncated to TF32, and a
# product a_small.b_big + a_big.b_small + a_big.b_big accumulated in fp32
# (emulated here with float64 sums). Emulated in that order it must hold the
# plain version and the
# JAX package at 1e-4 on the mamba2-130m prefill's launch shape and on a
# ragged S. A single TF32 pass is recorded beside it: it uses far more than a
# quarter of the tolerance (many times all of it at the prefill shape), so
# the kernel does not use one.


def _tf32(x):
    """x truncated to TF32: the low 13 mantissa bits cleared."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def _tf32_matmul(a, b, passes):
    """Batched a @ b from TF32 products (fp32 accumulation, summed in float64)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    terms = [(a_big, b_big)] if passes == 1 else [(a_small, b_big), (a_big, b_small), (a_big, b_big)]
    return sum(np.matmul(x.astype(np.float64), y.astype(np.float64)) for x, y in terms
               ).astype(np.float32)


def _emulated_kernel(x, dt, loga, B, C, chunk, passes):
    b, s, h, p = x.shape
    n, q = B.shape[-1], chunk
    nc = -(-s // q)

    def pad(a):  # a ragged last chunk reads as zeros past S
        return np.concatenate([a, np.zeros((b, nc * q - s) + a.shape[2:], np.float32)], axis=1)

    x, dt, loga, B, C = map(pad, (x, dt, loga, B, C))
    xc = x.reshape(b, nc, q, h, p).transpose(0, 3, 1, 2, 4)  # (b, h, nc, q, p)
    dtc = dt.reshape(b, nc, q, h).transpose(0, 3, 1, 2)
    la = np.cumsum(loga.reshape(b, nc, q, h).transpose(0, 3, 1, 2), axis=-1, dtype=np.float32)
    Bc = np.broadcast_to(B.reshape(b, 1, nc, q, n), (b, h, nc, q, n))
    Cc = np.broadcast_to(C.reshape(b, 1, nc, q, n), (b, h, nc, q, n))
    last = la[..., -1:]
    xd = xc * dtc[..., None]
    # 1. chunk states
    states = _tf32_matmul(np.swapaxes(xd * np.exp(last - la)[..., None], -1, -2), Bc, passes)
    decay = np.exp(last[..., 0])
    # 2. the state pass: states[c] becomes the state entering chunk c
    run = np.zeros((b, h, p, n), np.float32)
    for c in range(nc):
        states[:, :, c], run = run, decay[:, :, c, None, None] * run + states[:, :, c]
    # 3. output
    y = _tf32_matmul(Cc, np.swapaxes(states, -1, -2), passes) * np.exp(la)[..., None]
    causal = np.tril(np.ones((q, q), dtype=bool))
    gap = np.where(causal, la[..., :, None] - la[..., None, :], np.float32(0.0))
    g = np.where(causal, _tf32_matmul(Cc, np.swapaxes(Bc, -1, -2), passes) * np.exp(gap),
                 np.float32(0.0))
    y = y + _tf32_matmul(g, xd, passes)
    return y.transpose(0, 2, 3, 1, 4).reshape(b, nc * q, h, p)[:, :s], run


@pytest.mark.parametrize("b,s,passes", [(4, 512, 3), (2, 200, 3), (4, 512, 1)])
def test_kernel_decomposition_holds_plain_and_jax(b, s, passes):
    """The mamba2-130m prefill's launch shape (24 heads, P 64, N 128, chunk
    128) and a ragged S; y and the final state."""
    arrays = inputs(b, s, 24, 64, 128, seed=s + passes)
    x, dt, A, B, C = arrays
    loga = dt * A
    y, state = _emulated_kernel(x, dt, loga, B, C, 128, passes)
    want_y, want_state = ssd_chunk_scan(*t(x, dt, loga, B, C), chunk=128)
    if passes == 1:  # recorded, not used: the share of the tolerance it takes
        used = max(np.abs(y - want_y.numpy()).max(), np.abs(state - want_state.numpy()).max()) / ATOL
        assert used > 0.25, f"one TF32 pass uses {used:.3f} of the tolerance"
        return
    close(y, want_y)
    close(state, want_state)
    jarr = tuple(map(jnp.asarray, arrays))
    jax_y, jax_state = jax_chunked(*jarr, chunk=128)
    close(y, jax_y)
    close(state, jax_state)
    if s % 128 == 0:  # the Pallas kernel takes whole chunks
        close(y, jax_ssd(*jarr, 128))


def test_kernel_source_multiplies_on_tensor_cores_with_precise_exp():
    """The emulation above is of the tensor-core scheme: the CUDA source
    issues its products as TF32 mma.sync, keeps the precise expf (no
    fast-math intrinsics), and is built for sm_90a."""
    from repro_torch.kernels import _build

    src = K.SOURCE.read_text()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "__expf" not in src and "expf(" in src
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
