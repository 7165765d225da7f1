"""The port's LM serving driver (``repro_torch.launch.serve``).

At smoke size on the CPU: the driver's accounting; its greedy tokens
against a greedy loop over the JAX package's own prefill and serve steps
from the same (JAX-initialized) params; its refusal to run without a card
unless ``--device cpu`` is given; and the MoE archs (arctic-480b,
deepseek-v3-671b with MLA) served through the CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import ShapeConfig as JShape
from repro.configs import get_arch as jax_arch
from repro.data.tokens import token_batch as jax_token_batch
from repro.models.transformer import model as JM
from repro_torch.configs import get_arch
from repro_torch.launch import serve as S
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.convert import params_from_jax

MOE_ARCHS = ["deepseek-v3-671b", "arctic-480b"]


def args(*extra):
    return S.build_parser().parse_args(
        ["--prompt-len", "32", "--decode-steps", "4", "--batch", "4", *extra])


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mamba2-130m", "zamba2-7b",
                                  "musicgen-large", "qwen2-vl-2b"])
def test_run_on_cpu_counts_tokens(arch, capsys):
    out = S.run(args("--arch", arch, "--device", "cpu"))
    assert out["tokens_generated"] == 4 * (4 + 1)
    assert out["arch"] == arch and out["device"] == "cpu" and out["peak_mem_gb"] is None
    shapes = jax.eval_shape(lambda k: JM.init_params(jax_arch(arch, smoke=True), k,
                                                     num_stages=1), jax.random.PRNGKey(0))
    assert out["params"] == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert out["tokens_per_s"] > 0 and len(out["sample"]) == 5
    assert str(out["tokens_generated"]) in capsys.readouterr().out


def jax_greedy(arch, params, prompt, steps):
    """The JAX driver's loop: prefill, splice, ``steps`` serve steps."""
    cfg = jax_arch(arch, smoke=True)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    topo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=2)
    b, plen = prompt.shape
    part = JM.make_prefill_step(cfg, topo, JShape("p", plen, b, "prefill"), mesh,
                                dtype=jnp.float32)
    sart = JM.make_serve_step(cfg, topo, JShape("d", plen + steps + 16, b, "decode"), mesh,
                              dtype=jnp.float32)
    zeros = lambda art: jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                               art.abstract_inputs[1])
    logits, pcache = jax.jit(part.fn)(params, zeros(part), {"tokens": jnp.asarray(prompt)})
    dcache = jax.tree_util.tree_map(
        lambda d, s: d.at[:, :, :, :, :s.shape[4]].set(s) if d.ndim >= 5 else s,
        zeros(sart), pcache)
    step = jax.jit(sart.fn)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out = [np.asarray(tok)]
    for i in range(steps):
        tok, dcache = step(params, dcache, {"tokens": tok, "pos": jnp.asarray(plen + i)})
        out.append(np.asarray(tok))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "gemma2-27b", "mamba2-130m", *MOE_ARCHS])
def test_tokens_match_jax_greedy_loop(arch):
    jcfg = jax_arch(arch, smoke=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), num_stages=1, dtype=jnp.float32)
    prompt = jax_token_batch(batch=4, seq=32, vocab=jcfg.vocab_size, seed=0)[:, :-1]
    want = jax_greedy(arch, jparams, prompt, 4)
    gen = S.generate(get_arch(arch, smoke=True), TM.Topology(1, 2),
                     params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                     torch.from_numpy(prompt.astype(np.int64)), 4)
    assert gen.tokens.shape == want.shape == (4, 5)
    np.testing.assert_array_equal(gen.tokens, want)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        S.run(args("--arch", "codeqwen1.5-7b"))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_unsupported_archs_name_their_roadmap_item(arch, capsys):
    """The MoE archs serve through the CLI on the CPU at smoke size: the
    tokens generated, the JAX init's parameter count (experts, router and
    its bias, MLA's projections, the multi-token-prediction head), the
    summary printed. Their greedy tokens are held against the JAX loop in
    ``tests/test_torch_moe.py``."""
    out = S.run(args("--arch", arch, "--device", "cpu"))
    assert out["arch"] == arch and out["tokens_generated"] == 4 * (4 + 1)
    shapes = jax.eval_shape(lambda k: JM.init_params(jax_arch(arch, smoke=True), k,
                                                     num_stages=1), jax.random.PRNGKey(0))
    assert out["params"] == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert len(out["sample"]) == 5 and str(out["tokens_generated"]) in capsys.readouterr().out
