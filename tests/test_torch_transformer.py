"""The port's LM transformer (serving half) against the JAX package.

Parameters come from the JAX ``init_params`` through ``params_from_jax``;
activations are numpy draws from a seed. Module by module at 1e-5; the
whole prefill (last-token logits and every cache leaf) and one decode step
against the JAX ``make_prefill_step`` / ``make_serve_step`` at 1e-4 (two
layers of f32 matmuls and a vocab-wide head summed in other orders). The
JAX steps run on a 1x1 mesh with ``Auto`` axes: jax 0.9's ``make_mesh``
defaults to ``Explicit`` axes, which the steps' sharding constraints refuse.
Inside the port, 2 stages equal 1 bit for bit (the same ops on the same
rows), and 2 micro-batches equal 1 within 1e-6 (matmuls over other row
counts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ShapeConfig as JShape
from repro.configs import get_arch as jax_arch
from repro.models.transformer import blocks as JB
from repro.models.transformer import model as JM
from repro.models.transformer.attention import decode_attention as jax_decode_attention
from repro.models.transformer.common import apply_rope as jax_rope
from repro.models.transformer.common import rms_norm as jax_rms
from repro.models.transformer.ffn import ffn_apply as jax_ffn
from repro.models.transformer.ffn import ffn_init as jax_ffn_init
from repro.models.transformer.ssm import mamba2_apply as jax_mamba
from repro.models.transformer.ssm import mamba2_init as jax_mamba_init
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch.serve import splice
from repro_torch.models.transformer import blocks as TB
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.attention import decode_attention
from repro_torch.models.transformer.common import apply_rope, rms_norm
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.models.transformer.ffn import ffn_apply
from repro_torch.models.transformer.ssm import mamba2_apply

ATOL = 1e-5
STEP_ATOL = 1e-4
SERVE_ARCHS = ["codeqwen1.5-7b", "gemma2-27b", "mamba2-130m"]
PROMPT, BATCH = 96, 4  # longer than gemma2's smoke window of 64


def rng_array(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=atol)


def close_tree(got: dict, want: dict, atol):
    assert set(got) == set(want)
    for name in got:
        if isinstance(got[name], dict):
            close_tree(got[name], want[name], atol)
        else:
            assert tuple(got[name].shape) == tuple(np.shape(want[name])), name
            close(got[name], want[name], atol)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


# ------------------------------------------------------------- modules --


def test_rms_norm_and_rope():
    x, scale = rng_array((3, 9, 4, 16), 0), rng_array((16,), 1, 0.1)
    close(rms_norm(torch.from_numpy(x), torch.from_numpy(scale), eps=1e-6),
          jax_rms(jnp.asarray(x), jnp.asarray(scale), eps=1e-6))
    pos = np.arange(40, 49, dtype=np.int32)
    for theta in (1e4, 1e6):
        close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), theta=theta),
              jax_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_ffn(kind):
    p = to_np(jax_ffn_init(jax.random.PRNGKey(0), 32, 64, kind=kind, dtype=jnp.float32))
    x = rng_array((2, 5, 32), 2)
    close(ffn_apply(params_from_jax(p), torch.from_numpy(x), kind=kind),
          jax_ffn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), kind=kind))


@pytest.mark.parametrize("window,cap", [(0, 0.0), (8, 0.0), (0, 50.0)])
def test_decode_attention(window, cap):
    q, k, v = rng_array((2, 4, 16), 3), rng_array((2, 20, 2, 16), 4), rng_array((2, 20, 2, 16), 5)
    cur = 25  # ring of 20 slots past its first wrap
    kv_pos = np.asarray(TB.ring_positions(cur, 20))
    np.testing.assert_array_equal(kv_pos, np.asarray(JB.ring_positions(jnp.asarray(cur), 20)))
    got = decode_attention(*([torch.from_numpy(a)] for a in (q, k, v, kv_pos)), cur,
                           window=window, attn_softcap=cap)[0]
    want = jax_decode_attention(*map(jnp.asarray, (q, k, v, kv_pos)), jnp.asarray(cur),
                                window=window, attn_softcap=cap)
    close(got, want)


def _mamba_args(cfg):
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state,
                chunk=cfg.ssm_chunk)


def test_mamba2_apply_prefill_and_decode():
    cfg = get_arch("mamba2-130m", smoke=True)
    p = to_np(jax_mamba_init(jax.random.PRNGKey(1), cfg.d_model, expand=cfg.ssm_expand,
                             head_dim=cfg.ssm_head_dim, n_state=cfg.ssm_state,
                             conv_width=cfg.ssm_conv_width, dtype=jnp.float32))
    pj, pt = jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)
    x = rng_array((2, 40, cfg.d_model), 6)  # ragged: 40 tokens, chunk 32
    y, (ssm, conv) = mamba2_apply(pt, torch.from_numpy(x), **_mamba_args(cfg))
    want_y, (want_ssm, want_conv) = jax_mamba(pj, jnp.asarray(x), **_mamba_args(cfg))
    for got, want in ((y, want_y), (ssm, want_ssm), (conv, want_conv)):
        close(got, want)
    x1 = rng_array((2, 1, cfg.d_model), 7)
    y1, (ssm1, conv1) = mamba2_apply(pt, torch.from_numpy(x1), ssm_state=ssm, conv_state=conv,
                                     decode=True, **_mamba_args(cfg))
    want1 = jax_mamba(pj, jnp.asarray(x1), ssm_state=want_ssm, conv_state=want_conv,
                      decode=True, **_mamba_args(cfg))
    for got, want in ((y1, want1[0]), (ssm1, want1[1][0]), (conv1, want1[1][1])):
        close(got, want)


@pytest.mark.parametrize("arch,window", [("codeqwen1.5-7b", 0), ("gemma2-27b", 16)])
def test_attention_blocks(arch, window):
    cfg = get_arch(arch, smoke=True)
    lp = to_np(JB.init_block(jax_arch(arch, smoke=True), jax.random.PRNGKey(2), dtype=jnp.float32))
    lpj, lpt = jax.tree_util.tree_map(jnp.asarray, lp), params_from_jax(lp)
    s, w = 40, 48
    h = rng_array((2, s, cfg.d_model), 8)
    ex = {"active": 1.0, "window": window}
    jex = {"active": jnp.asarray(1.0), "window": jnp.asarray(window)}
    cache = TB.init_attn_cache(cfg, 2, s)
    got, cache = TB.block_prefill(cfg, lpt, ex, torch.from_numpy(h), cache,
                                  positions=torch.arange(s), kv_block=16)
    want, jcache = JB.block_prefill(jax_arch(arch, smoke=True), lpj, jex, jnp.asarray(h),
                                    JB.init_attn_cache(cfg, 2, s, dtype=jnp.float32),
                                    positions=jnp.arange(s), kv_block=16)
    close(got, want)
    close_tree(cache, jcache, ATOL)

    # decode the next token into a wider ring
    dcache = TB.init_attn_cache(cfg, 2, w)
    for name in dcache:
        dcache[name][:, :s] = cache[name]
    jdcache = {k: jnp.zeros((2, w) + v.shape[2:], jnp.float32).at[:, :s].set(v)
               for k, v in jcache.items()}
    h1 = rng_array((2, 1, cfg.d_model), 9)
    got1, dcache = TB.block_decode(cfg, lpt, ex, torch.from_numpy(h1), dcache, cur_pos=s)
    want1, jdcache = JB.block_decode(jax_arch(arch, smoke=True), lpj, jex, jnp.asarray(h1),
                                     jdcache, cur_pos=jnp.asarray(s))
    close(got1, want1)
    close_tree(dcache, jdcache, ATOL)

    # a padding slot is the identity and leaves its cache alone
    before = {k: v.clone() for k, v in dcache.items()}
    same, dcache = TB.block_decode(cfg, lpt, {"active": 0.0, "window": 0},
                                   torch.from_numpy(h1), dcache, cur_pos=s + 1)
    assert torch.equal(same, torch.from_numpy(h1))
    assert all(torch.equal(dcache[k], before[k]) for k in before)


def test_mamba_blocks():
    cfg = get_arch("mamba2-130m", smoke=True)
    jcfg = jax_arch("mamba2-130m", smoke=True)
    lp = to_np(JB.init_mamba_block(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32))
    lpj, lpt = jax.tree_util.tree_map(jnp.asarray, lp), params_from_jax(lp)
    ex, jex = {"active": 1.0, "window": 0}, {"active": jnp.asarray(1.0), "window": jnp.asarray(0)}
    h = rng_array((2, 64, cfg.d_model), 10)
    got, cache = TB.mamba_block_prefill(cfg, lpt, ex, torch.from_numpy(h),
                                        TB.init_mamba_cache(cfg, 2))
    want, jcache = JB.mamba_block_prefill(jcfg, lpj, jex, jnp.asarray(h),
                                          JB.init_mamba_cache(jcfg, 2, dtype=jnp.float32))
    close(got, want)
    close_tree(cache, jcache, ATOL)
    h1 = rng_array((2, 1, cfg.d_model), 11)
    got1, cache = TB.mamba_block_decode(cfg, lpt, ex, torch.from_numpy(h1), cache)
    want1, jcache = JB.mamba_block_decode(jcfg, lpj, jex, jnp.asarray(h1), jcache)
    close(got1, want1)
    close_tree(cache, jcache, ATOL)


# --------------------------------------------------------- whole steps --


def jax_params(arch, num_stages=1):
    cfg = jax_arch(arch, smoke=True)
    return to_np(JM.init_params(cfg, jax.random.PRNGKey(0), num_stages=num_stages,
                                dtype=jnp.float32))


def prompt_tokens(cfg, seed=0):
    from repro.data.tokens import token_batch

    return token_batch(batch=BATCH, seq=PROMPT, vocab=cfg.vocab_size, seed=seed)[:, :-1]


def jax_steps(arch, mesh, num_micro=2):
    """JAX prefill -> splice -> one decode step, as ``repro.launch.serve``
    runs them: (prefill logits, prefill cache, next token, decode cache)."""
    cfg = jax_arch(arch, smoke=True)
    topo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=num_micro)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(arch))
    part = JM.make_prefill_step(cfg, topo, JShape("p", PROMPT, BATCH, "prefill"), mesh,
                                dtype=jnp.float32)
    sart = JM.make_serve_step(cfg, topo, JShape("d", PROMPT + 16, BATCH, "decode"), mesh,
                              dtype=jnp.float32)
    zeros = lambda art: jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                               art.abstract_inputs[1])
    logits, pcache = jax.jit(part.fn)(params, zeros(part),
                                      {"tokens": jnp.asarray(prompt_tokens(cfg))})

    def jsplice(dst, src):
        if dst.ndim >= 5 and src.shape[:3] == dst.shape[:3]:
            return dst.at[:, :, :, :, :src.shape[4]].set(src)
        return src

    dcache = jax.tree_util.tree_map(jsplice, zeros(sart), pcache)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    nxt, dcache = jax.jit(sart.fn)(params, dcache, {"tokens": tok, "pos": jnp.asarray(PROMPT)})
    return to_np(logits), to_np(pcache), np.asarray(nxt), to_np(dcache)


def port_steps(arch, topo, params=None):
    cfg = get_arch(arch, smoke=True)
    params = params_from_jax(jax_params(arch)) if params is None else params
    pshape = ShapeConfig("p", PROMPT, BATCH, "prefill")
    dshape = ShapeConfig("d", PROMPT + 16, BATCH, "decode")
    tokens = torch.from_numpy(prompt_tokens(cfg).astype(np.int64))
    with torch.inference_mode():
        logits, pcache = TM.make_prefill_step(cfg, topo, pshape)(
            params, TM.init_cache(cfg, topo, pshape), {"tokens": tokens})
        dcache = splice(TM.init_cache(cfg, topo, dshape), pcache)
        tok = logits.argmax(dim=-1).to(torch.int32)
        nxt, dcache, dlogits = TM.make_serve_step(cfg, topo, dshape)(
            params, dcache, {"tokens": tok, "pos": PROMPT})
    return logits, pcache, nxt, dcache, dlogits


def top2_gap(logits):
    top = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_match_jax_steps(arch, mesh):
    logits, pcache, nxt, dcache, dlogits = port_steps(arch, TM.Topology(1, 2))
    j_logits, j_pcache, j_nxt, j_dcache = jax_steps(arch, mesh)
    close(logits, j_logits, STEP_ATOL)
    close_tree(pcache, j_pcache, STEP_ATOL)
    close_tree(dcache, j_dcache, STEP_ATOL)
    # greedy tokens agree wherever the top two logits are not a near tie
    clear = top2_gap(j_logits) > 1e-3
    np.testing.assert_array_equal(logits.argmax(-1).numpy()[clear], j_logits.argmax(-1)[clear])
    clear = top2_gap(dlogits) > 1e-3
    assert clear.any()
    np.testing.assert_array_equal(nxt.numpy()[clear], j_nxt[clear])


def _restack(params, num_stages):
    """1-stage params (1, L, ...) as ``num_stages`` stages of L/num_stages
    layers, padded with zero slots to a whole number per stage."""
    def one(a):
        layers = a.shape[1]
        per = -(-layers // num_stages)
        pad = torch.zeros((per * num_stages - layers, *a.shape[2:]), dtype=a.dtype)
        return torch.cat([a[0], pad]).reshape(num_stages, per, *a.shape[2:])

    return dict(params, blocks={k: _tree_map(one, v) if isinstance(v, dict) else one(v)
                                for k, v in params["blocks"].items()})


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch,stages", [("codeqwen1.5-7b", 2), ("mamba2-130m", 2),
                                         ("gemma2-27b", 3)])
def test_stages_bit_identical(arch, stages):
    """Layers split over stages (3 stages of 2 layers: one padding slot)
    give the same logits, cache entries and next tokens bit for bit."""
    params = params_from_jax(jax_params(arch))
    one = port_steps(arch, TM.Topology(1, 2), params)
    many = port_steps(arch, TM.Topology(stages, 2), _restack(params, stages))
    assert torch.equal(one[0], many[0]) and torch.equal(one[2], many[2])
    assert torch.equal(one[4], many[4])
    for c1, cs in ((one[1], many[1]), (one[3], many[3])):
        for name in c1:
            # (S, nm, per, ...) -> (nm, layers, ...), dropping padding slots
            flat = cs[name].transpose(0, 1).flatten(1, 2)[:, :c1[name].shape[2]]
            assert torch.equal(flat, c1[name][0]), name


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_micro_batches_match(arch):
    params = params_from_jax(jax_params(arch))
    one = port_steps(arch, TM.Topology(1, 1), params)
    two = port_steps(arch, TM.Topology(1, 2), params)
    close(two[0], one[0], 1e-6)
    close(two[4], one[4], 1e-6)
    assert torch.equal(two[2], one[2])
    for c1, c2 in ((one[1], two[1]), (one[3], two[3])):
        for name in c1:
            # (1, nm, per, b_mb, ...) -> (per, B, ...)
            close(c2[name][0].transpose(0, 1).flatten(1, 2), c1[name][0, 0], 1e-6)


def test_padding_slot_extras_match_jax():
    for arch in SERVE_ARCHS:
        for stages in (1, 2, 3):
            want = JM.make_extras(jax_arch(arch, smoke=True), stages)
            got = TM.make_extras(get_arch(arch, smoke=True), stages)
            for key in ("active", "window"):
                np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def test_init_params_shapes_match_jax():
    for arch in SERVE_ARCHS:
        for stages in (1, 2):
            want = jax.eval_shape(lambda k: JM.init_params(
                jax_arch(arch, smoke=True), k, num_stages=stages, dtype=jnp.float32),
                jax.random.PRNGKey(0))
            got = TM.init_params(get_arch(arch, smoke=True), seed=0, num_stages=stages)
            assert jax.tree_util.tree_map(lambda a: tuple(a.shape), want) == \
                _tree_map(lambda t: tuple(t.shape), got)
