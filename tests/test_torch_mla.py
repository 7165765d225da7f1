"""MLA attention (deepseek-v3-671b) against the JAX block functions, at
smoke size on the CPU (4 heads, q_lora 48, kv_lora 32, head dims 32 + 16
for q and k and 32 for v).

From the JAX ``init_attn_params`` carried across by ``params_from_jax``,
within 1e-5: ``attn_apply`` over a whole sequence (the flash op's plain
version at q/k head dim 48 and v head dim 32) and the compressed cache
entry it returns (``ckv`` ‖ the rotated ``k_rope``); ``attn_decode_apply``
against a ring cache past its first wrap, output and cache; and the
model's cache layout (``init_cache``) against the JAX ``abstract_cache``,
exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp

from repro.configs import ShapeConfig as JShape
from repro.configs import get_arch as jax_arch
from repro.models.transformer import blocks as JB
from repro.models.transformer import model as JM
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.models.transformer import blocks as TB
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.convert import params_from_jax

ATOL = 1e-5
ARCH = "deepseek-v3-671b"
B, S, W, CUR = 2, 24, 20, 27  # decode: a 20-slot ring past its first wrap


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size ops on one intra-op thread: the suite's parallel workers
    oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rng_array(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=atol)


def attn_params():
    """(JAX config, port config, JAX params, port params). The zero-init
    norm scales are drawn, so that they matter."""
    jcfg, cfg = jax_arch(ARCH, smoke=True), get_arch(ARCH, smoke=True)
    p = jax.tree_util.tree_map(np.asarray, JB.init_attn_params(jcfg, jax.random.PRNGKey(7),
                                                               dtype=jnp.float32))
    for name, seed in (("ln_q", 8), ("ln_kv", 9)):
        p[name] = rng_array(p[name].shape, seed, 0.1)
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)


def test_attn_apply_and_cache_entry_match_jax():
    jcfg, cfg, jp, tp = attn_params()
    h = rng_array((B, S, cfg.d_model), 1)
    want, j_entry = JB.attn_apply(jcfg, jp, jnp.asarray(h), positions=jnp.arange(S),
                                  window=0, return_cache=True)
    got, entry = TB.attn_apply(cfg, tp, torch.from_numpy(h),
                               positions=torch.arange(S, dtype=torch.int32), window=0,
                               kv_block=8, return_cache=True)
    close(got, want)
    assert set(entry) == set(j_entry) == {"ckv"}
    assert entry["ckv"].shape == (B, S, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    close(entry["ckv"], j_entry["ckv"])


def test_decode_matches_jax():
    """One token at position 27 against a 20-slot compressed cache of drawn
    entries (positions 8..26): output, and the cache with the new entry
    written into slot 27 mod 20, in place."""
    jcfg, cfg, jp, tp = attn_params()
    h = rng_array((B, 1, cfg.d_model), 2)
    cache = rng_array((B, W, cfg.kv_lora_rank + cfg.qk_rope_head_dim), 3)
    want, j_cache = JB.attn_decode_apply(jcfg, jp, jnp.asarray(h), {"ckv": jnp.asarray(cache)},
                                         cur_pos=jnp.asarray(CUR), window=0)
    t_cache = {"ckv": torch.from_numpy(cache.copy())}
    got, out_cache = TB.attn_decode_apply(cfg, tp, torch.from_numpy(h), t_cache, cur_pos=CUR,
                                          window=0)
    close(got, want)
    assert out_cache["ckv"] is t_cache["ckv"]
    close(out_cache["ckv"], j_cache["ckv"])
    untouched = np.arange(W) != CUR % W
    np.testing.assert_array_equal(out_cache["ckv"].numpy()[:, untouched], cache[:, untouched])


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_cache_layout_matches_jax(kind):
    cfg = get_arch(ARCH, smoke=True)
    jtopo = JM.Topology(num_stages=2, fsdp_size=1, num_micro=2)
    want, _ = JM.abstract_cache(jax_arch(ARCH, smoke=True), jtopo, JShape("c", S, 4, kind))
    got = TM.init_cache(cfg, TM.Topology(2, 2), ShapeConfig("c", S, 4, kind))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
