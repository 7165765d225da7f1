"""Flash attention in the port against the JAX package.

The port's plain version (``repro_torch.kernels.flash.ref``, the route a CPU
tensor takes through the kernel wrapper and the op) is held against the JAX
flash op itself (its Pallas kernel in interpret mode), the JAX
``blocked_attention`` and ``naive_attention``, and the port's own quadratic
oracle. Inputs are numpy draws from a seed, handed to both frameworks.
Tolerance 1e-5 (float32; the blocked and naive forms sum in other orders).
The CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``); here its numeric schemes
(3xTF32 for fp32, P split into two bf16 parts for bf16) are emulated with
numpy, and its choice of instance (``kernel.route``) is held for every arch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.ops import flash_attention as jax_flash
from repro.kernels.flash.ref import naive_attention as jax_naive
from repro.models.transformer.attention import blocked_attention as jax_blocked
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels import bf16_ulps
from repro_torch.kernels.flash import kernel as K
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.flash.ref import flash_attention_ref
from repro_torch.models.transformer.attention import blocked_attention, naive_attention

ATOL = RTOL = 1e-5


def qkv(b, s, h, kv, hd, hd_v=None, seed=0):
    rng = np.random.default_rng(seed)
    hd_v = hd if hd_v is None else hd_v
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd_v)).astype(np.float32))


def t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=RTOL)


@pytest.mark.parametrize("b,s,h,kv,hd,window,cap", [
    (1, 128, 4, 2, 32, 0, 0.0),
    (2, 256, 2, 1, 16, 64, 0.0),
    (1, 128, 4, 4, 32, 0, 50.0),
])
def test_plain_matches_jax_pallas_op(b, s, h, kv, hd, window, cap):
    q, k, v = qkv(b, s, h, kv, hd, seed=s + h)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window, cap, 128, 128)
    close(flash_attention(*t(q, k, v), window, cap), want)


# every (H, KV) grouping, window, softcap and ragged S, each met twice
@pytest.mark.parametrize("h,kv,window,cap,s", [
    (4, 4, 0, 0.0, 64), (4, 2, 16, 0.0, 45), (8, 1, 0, 50.0, 100), (4, 2, 24, 30.0, 100),
    (8, 1, 16, 0.0, 64), (4, 4, 0, 50.0, 45), (4, 2, 0, 0.0, 100), (8, 1, 24, 30.0, 45),
])
def test_plain_matches_oracles(h, kv, window, cap, s):
    q, k, v = qkv(2, s, h, kv, 16, seed=h * 10 + kv + s)
    pos = np.arange(s, dtype=np.int32)
    got = flash_attention_ref(*t(q, k, v), window=window, softcap=cap, kv_block=32)
    tp = torch.from_numpy(pos).long()
    close(got, naive_attention(*t(q, k, v), q_pos=tp, kv_pos=tp, window=window, attn_softcap=cap))
    jq, jk, jv, jpos = map(jnp.asarray, (q, k, v, pos))
    close(got, jax_naive(jq, jk, jv, q_pos=jpos, kv_pos=jpos, window=window, attn_softcap=cap))
    close(got, jax_blocked(jq, jk, jv, q_pos=jpos, kv_pos=jpos, window=window,
                           attn_softcap=cap, kv_block=32))


def test_blocked_matches_jax_at_other_positions():
    """Decode-style positions (queries at the end of a longer key run)."""
    q, k, v = qkv(1, 40, 4, 2, 16, seed=3)
    q = q[:, :8]
    q_pos, kv_pos = np.arange(32, 40, dtype=np.int32), np.arange(40, dtype=np.int32)
    got = blocked_attention(*t(q, k, v), q_pos=torch.from_numpy(q_pos).long(),
                            kv_pos=torch.from_numpy(kv_pos).long(), window=12, kv_block=16)
    want = jax_blocked(*map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(q_pos),
                       kv_pos=jnp.asarray(kv_pos), window=12, kv_block=16)
    close(got, want)


def test_plain_vdim_differs():
    """K and V head dims differ (the JAX test_flash_mla_style_vdim)."""
    q, k, v = qkv(2, 128, 4, 2, 24, hd_v=16, seed=5)
    got = flash_attention(*t(q, k, v))
    assert got.shape == (2, 128, 4, 16)
    close(got, jax_flash(*map(jnp.asarray, (q, k, v))))


def test_op_gradient_matches_jax():
    q, k, v = qkv(1, 128, 4, 2, 16, seed=7)
    ct = np.random.default_rng(8).standard_normal((1, 128, 4, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, 32, 20.0), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(ct))
    leaves = [x.requires_grad_() for x in t(q, k, v)]
    out = flash_attention(*leaves, 32, 20.0)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for g, w in zip(got, want):
        close(g, w)


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = t(*qkv(1, 70, 4, 2, 16, seed=9))
    before = K.flash_attention_kernel.launches
    got = K.flash_attention_kernel(q, k, v, window=8, softcap=10.0)
    assert K.flash_attention_kernel.launches == before
    assert torch.equal(got, flash_attention_ref(q, k, v, window=8, softcap=10.0))


def test_wrapper_rejects_mixed_devices():
    q, k, v = t(*qkv(1, 8, 2, 1, 8))
    with pytest.raises(ValueError, match="one device"):
        K.flash_attention_kernel(q, k.to("meta"), v)


# ---------------------------------------------- the kernel's numeric scheme --
# The CUDA kernel multiplies fp32 operands on the tensor cores as 3xTF32:
# x = big + small with big = tf32(x), small = tf32(x - big), and a product
# a_small.b_big + a_big.b_small + a_big.b_big accumulated in fp32, for S = Q.K^T
# and for P.V. Emulated here with numpy (TF32: 10 mantissa bits, rounded to
# nearest even), it must hold the plain version at 1e-5 on the codeqwen head
# shape (hd 128, S 512), where a single TF32 pass must not.


def _tf32(x):
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + np.uint32(0xFFF) + ((u >> 13) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def _tf32_matmul(a, b, passes):
    """a @ b from TF32 products (fp32 accumulation, summed here in float64)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    terms = [(a_big, b_big)] if passes == 1 else [(a_small, b_big), (a_big, b_small), (a_big, b_big)]
    return sum(x.astype(np.float64) @ y.astype(np.float64) for x, y in terms).astype(np.float32)


def _emulated_attention(q, k, v, passes):
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    scale = np.float32(1.0) / np.sqrt(np.float32(hd))
    causal = np.tril(np.ones((s, s), dtype=bool))
    out = np.empty((b, s, h, v.shape[-1]), dtype=np.float32)
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // kvh)
            sc = _tf32_matmul(q[bi, :, hi], k[bi, :, kv].T, passes) * scale
            sc = np.where(causal, sc, np.float32(-2e38))
            p = np.where(causal, np.exp(sc - sc.max(axis=1, keepdims=True)), np.float32(0.0))
            out[bi, :, hi] = _tf32_matmul(p, v[bi, :, kv], passes) / p.sum(axis=1, keepdims=True)
    return out


@pytest.mark.parametrize("passes", [3, 1])
def test_three_tf32_split_holds_plain_version(passes):
    q, k, v = qkv(1, 512, 2, 1, 128, seed=11)
    got = _emulated_attention(q, k, v, passes)
    want = flash_attention_ref(*t(q, k, v)).numpy()
    if passes == 3:
        close(got, want)
    else:  # one TF32 pass keeps ~11 bits: the 1e-5 parity fails, as it must
        assert not np.allclose(got, want, atol=ATOL, rtol=RTOL)


# The bf16 instances take S = Q.K^T exactly (bf16 products, fp32 sums), p =
# exp(s scale - m) (the kernel's ex2.approx of it), and multiply P.V as two
# bf16 products, lo.V and hi.V, with hi = bf16(p) and lo = bf16(p - hi),
# so that P stays fp32-accurate as the TPU kernel keeps it. Emulated here
# (products summed in float64), the split holds the plain version on the same
# bf16 inputs within one bf16 ulp (``kernels.bf16_ulps``); P rounded to bf16
# once must not.


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).bfloat16().float().numpy()


def _emulated_bf16_attention(q, k, v, split):
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    scale = np.float32(1.0 / np.sqrt(hd))
    causal = np.tril(np.ones((s, s), dtype=bool))
    out = np.empty((b, s, h, v.shape[-1]), dtype=np.float32)
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // kvh)
            sc = (q[bi, :, hi].astype(np.float64) @ k[bi, :, kv].T.astype(np.float64))
            x = np.where(causal, sc.astype(np.float32) * scale, np.float32(-2e38))
            p = np.where(causal, np.exp(x - x.max(axis=1, keepdims=True)), np.float32(0.0))
            high = _bf16(p)
            parts = [_bf16(p - high), high] if split else [high]
            o = sum(part.astype(np.float64) @ v[bi, :, kv].astype(np.float64) for part in parts)
            out[bi, :, hi] = o / p.astype(np.float32).sum(axis=1, keepdims=True)
    return torch.from_numpy(out).bfloat16()


@pytest.mark.parametrize("split", [True, False])
def test_bf16_split_holds_plain_version(split):
    q, k, v = (_bf16(a) for a in qkv(1, 512, 2, 1, 128, seed=12))
    got = _emulated_bf16_attention(q, k, v, split)
    ulps = float(bf16_ulps(got, flash_attention_ref(*(torch.from_numpy(a).bfloat16()
                                                      for a in (q, k, v)))).max())
    assert (ulps <= 1.0) == split


def test_order_check_refuses_decreasing_positions():
    """``check_order`` takes repeated and rising positions (an m-rope t-row)
    and a vector of one, and refuses a decrease anywhere."""
    from repro_torch.kernels.flash.kernel import check_order

    check_order("q_pos", torch.tensor([0, 0, 0, 1, 2, 2, 3], dtype=torch.int32))
    check_order("q_pos", torch.tensor([7], dtype=torch.int32))
    for bad in ([1, 0], [0, 0, 1, 2, 1], [0, 1, 2, 3, 4, 5, 6, -1]):
        with pytest.raises(ValueError, match="kv_pos decreases"):
            check_order("kv_pos", torch.tensor(bad, dtype=torch.int32))


# ------------------------------------------------- the instance a launch takes --
# (heads, kv heads, hd, hd_v) of every registered arch's attention launches at
# full width (MLA: q/k nope + rope, v its own dim), None without attention
ATTENTION_DIMS = {
    "arctic-480b": (56, 8, 128, 128), "codeqwen1.5-7b": (32, 32, 128, 128),
    "deepseek-v3-671b": (128, 128, 192, 128), "gemma2-27b": (32, 16, 128, 128),
    "glm4-9b": (32, 2, 128, 128), "mamba2-130m": None, "musicgen-large": (32, 32, 64, 64),
    "qwen2-vl-2b": (12, 2, 128, 128), "qwen2.5-32b": (40, 8, 128, 128),
    "zamba2-7b": (32, 32, 112, 112),
}


def _attention_dims(cfg):
    if cfg.attn_kind == "none":
        return None
    if cfg.attn_kind == "mla":
        return (cfg.num_heads, cfg.num_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                cfg.v_head_dim)
    return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.head_dim


@pytest.mark.parametrize("arch", list_archs())
def test_route_of_every_arch(arch):
    """Every arch's bf16 attention launch at full width takes the wgmma
    instances (TMA takes head dims that are multiples of 8 from aligned
    bases); the same dims from a misaligned base, or an hd TMA cannot
    stride, take mma.sync; float32 takes the fp32 instances."""
    dims = _attention_dims(get_arch(arch))
    assert dims == ATTENTION_DIMS[arch]
    if dims is None:  # no attention layer: no flash launch to route
        assert get_arch(arch).num_heads == 0
        return
    h, kv, hd, hd_v = dims
    assert h % kv == 0 and max(hd, hd_v) <= K.MAX_HEAD_DIM
    assert K.route(torch.bfloat16, hd, hd_v) == "wgmma"
    assert K.route(torch.bfloat16, hd, hd_v, aligned=False) == "mma.sync"
    assert K.route(torch.bfloat16, hd + 4, hd_v) == "mma.sync"
    assert K.route(torch.bfloat16, hd, hd_v - 2) == "mma.sync"
    assert K.route(torch.float32, hd, hd_v) == "fp32"
