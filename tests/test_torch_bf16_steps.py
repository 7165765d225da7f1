"""The port's LM steps at the reference's own dtype, bf16, against the JAX
package's bf16 steps, on the CPU at smoke size.

The reference builds ``make_prefill_step``, ``make_serve_step`` and
``make_train_step`` at ``dtype=jnp.bfloat16`` by default: bf16 params,
caches and activations; norms, rope, the SSD scan, attention and the logits
in float32, cast back; Adam's moments float32. Both packages start from
the reference's bf16 ``init_params``, carried across bit for bit by
``params_from_jax``. The two frameworks round their bf16 products and sums
in different orders, so the comparisons are in bf16's terms:

* a prefill of 32 rows and one decode step: the prefill's logits within
  ``LOGIT_FRAC`` of the largest reference logit, its greedy tokens equal
  wherever the reference's top-2 gap exceeds twice that, and the decode
  step's next tokens (the reference's serve step returns no logits) equal
  wherever the port's top-2 gap does;
* the first train step: the loss within ``LOSS_RTOL`` relative, and
  Adam's first moment (0.1 g) within ``MU_FRAC`` of each leaf's largest
  entry.

The JAX steps run on a 1x1 ``Auto`` mesh (jax 0.9's default ``Explicit``
axes make their sharding constraints fail), compiled with XLA's cheaper
backend passes; torch runs on one intra-op thread.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import ShapeConfig as JShape
from repro.configs import get_arch as jax_arch
from repro.data.tokens import token_batch
from repro.models.transformer import model as JM
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.launch import serve as tserve
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.convert import params_from_jax

BATCH, PROMPT, MICRO, SEQ, LOSS_CHUNKS, LR = 4, 32, 2, 32, 4, 3e-4
LOGIT_FRAC = 0.02  # of the largest reference logit
LOSS_RTOL = 5e-4
MU_FRAC = 0.05  # of each leaf's largest entry
JIT_OPTIONS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SERVE_ARCHS = ["codeqwen1.5-7b", "gemma2-27b", "mamba2-130m", "zamba2-7b", "deepseek-v3-671b",
               "qwen2-vl-2b"]
TRAIN_ARCHS = ["codeqwen1.5-7b", "mamba2-130m", "arctic-480b"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def compiled(art, *args):
    return jax.jit(art.fn).lower(*args).compile(compiler_options=JIT_OPTIONS)


def jax_params(arch, topo_stages=1):
    """The reference's bf16 init (its default dtype) and the port's copy."""
    jp = JM.init_params(jax_arch(arch, smoke=True), jax.random.PRNGKey(0), num_stages=topo_stages)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def frontend_rows(cfg):
    return int(PROMPT * cfg.frontend_frac) if cfg.frontend != "none" else 0


def jax_serve(arch, jp, prompt, front):
    """The reference's prefill of ``PROMPT`` rows (frontend rows first) and
    one decode step after it, at bf16: (prefill logits, the prefill's
    greedy tokens, the decode step's next tokens)."""
    cfg = jax_arch(arch, smoke=True)
    topo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=MICRO)
    part = JM.make_prefill_step(cfg, topo, JShape("p", PROMPT, BATCH, "prefill"), mesh())
    sart = JM.make_serve_step(cfg, topo, JShape("d", PROMPT + 17, BATCH, "decode"), mesh())
    zeros = lambda art: jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                               art.abstract_inputs[1])
    batch = {"tokens": jnp.asarray(prompt)}
    if front is not None:
        batch["frontend_embeds"] = jnp.asarray(front, jnp.bfloat16)
    pcache = zeros(part)
    logits, pcache = compiled(part, jp, pcache, batch)(jp, pcache, batch)
    dcache = jax.tree_util.tree_map(
        lambda d, s: d.at[:, :, :, :, :s.shape[4]].set(s) if d.ndim >= 5 else s,
        zeros(sart), pcache)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    # the reference's serve step returns its next tokens, not their logits
    dbatch = {"tokens": tok, "pos": jnp.asarray(PROMPT, jnp.int32)}
    next_tok, _ = compiled(sart, jp, dcache, dbatch)(jp, dcache, dbatch)
    return np.asarray(logits, np.float32), np.asarray(tok), np.asarray(next_tok)


def assert_logits_close(got, want, what):
    limit = LOGIT_FRAC * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= limit, f"{what}: max |logit diff| {err:.4g} > {limit:.4g}"
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * limit
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear], err_msg=what)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_bf16_prefill_and_decode_match_jax(arch):
    """bf16 prefill logits within ``LOGIT_FRAC`` of the reference's, its
    greedy token, and the next token of one decode step (equal where the
    prefill's top-2 gap is clear)."""
    jp, tp = jax_params(arch)
    cfg = get_arch(arch, smoke=True)
    s_front = frontend_rows(cfg)
    prompt = token_batch(batch=BATCH, seq=PROMPT, vocab=cfg.vocab_size, seed=0)[
        :, :PROMPT - s_front]
    front = None if not s_front else (np.random.default_rng(0).standard_normal(
        (BATCH, s_front, cfg.d_model)) * 0.02).astype(np.float32)
    want_logits, want_tok, want_next = jax_serve(arch, jp, prompt, front)
    gen = tserve.generate(cfg, TM.Topology(num_stages=1, num_micro=MICRO), tp,
                          torch.from_numpy(prompt.astype(np.int64)), 1,
                          None if front is None else torch.from_numpy(front).to(torch.bfloat16))
    assert gen.prefill_logits.dtype == torch.float32
    got = gen.prefill_logits.numpy()
    assert_logits_close(got, want_logits, f"{arch} prefill")
    top2 = np.sort(want_logits, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_FRAC * float(np.abs(want_logits).max())
    if clear.all():  # the decode step read the same token: its next token is held too
        np.testing.assert_array_equal(gen.tokens[:, 0], want_tok)
        dl = gen.first_decode_logits.numpy()
        dclear = np.ptp(np.sort(dl, axis=-1)[:, -2:], axis=-1) > 2 * LOGIT_FRAC * float(
            np.abs(dl).max())
        np.testing.assert_array_equal(gen.tokens[:, 1][dclear], want_next[dclear])


def jax_train_first(arch, jp):
    """The reference's first bf16 train step: (loss, μ as numpy leaves)."""
    cfg = jax_arch(arch, smoke=True)
    topo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=MICRO, loss_chunks=LOSS_CHUNKS)
    art = JM.make_train_step(cfg, topo, JShape("t", SEQ, BATCH, "train"), mesh(), lr=LR)
    opt = art.meta["optimizer"].init(jp)
    batch = {"tokens": jnp.asarray(token_batch(batch=BATCH, seq=SEQ, vocab=cfg.vocab_size,
                                               seed=0, step=0))}
    params, opt, m = compiled(art, jp, opt, batch)(jp, opt, batch)
    return float(m["loss"]), jax.tree_util.tree_map(np.asarray, opt.mu), \
        jax.tree_util.tree_map(lambda a: str(a.dtype), params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_first_train_step_matches_jax(arch):
    """From the reference's bf16 params: the step-1 loss within
    ``LOSS_RTOL``, Adam's μ (float32 on both sides) within ``MU_FRAC`` of
    each leaf's largest entry, and the updated params still bf16 leaf for
    leaf where the reference's are."""
    jp, tp = jax_params(arch)
    want_loss, want_mu, want_dtypes = jax_train_first(arch, jp)
    cfg = get_arch(arch, smoke=True)
    topo = TM.Topology(num_stages=1, num_micro=MICRO, loss_chunks=LOSS_CHUNKS)
    step = TM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), lr=LR)
    batch = {"tokens": torch.from_numpy(token_batch(batch=BATCH, seq=SEQ, vocab=cfg.vocab_size,
                                                    seed=0, step=0))}
    params, opt, m = step(tp, step.optimizer.init(tp), batch)
    loss = float(m["loss"])
    assert m["loss"].dtype == torch.float32
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss), (loss, want_loss)
    got_mu = _flat(opt.mu)
    for name, want in _flat(want_mu).items():
        got = got_mu[name]
        assert got.dtype == torch.float32, name
        scale = float(np.abs(want).max())
        err = float(np.abs(got.numpy() - want).max())
        assert err <= MU_FRAC * scale or (scale == 0 and err == 0), (name, err, scale)
    got_dtypes = {k: str(v.dtype).replace("torch.", "") for k, v in _flat(params).items()}
    assert got_dtypes == _flat(want_dtypes)


def test_bf16_params_from_jax_keep_their_bits():
    """The reference's bf16 init arrives bit for bit (its bits viewed as
    int16 on both sides); float32 leaves as before."""
    jp, tp = jax_params("deepseek-v3-671b")
    want = _flat(jax.tree_util.tree_map(np.asarray, jp))
    got = _flat(tp)
    assert want.keys() == got.keys()
    for name, a in want.items():
        t = got[name]
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16),
                                          err_msg=name)
        else:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy(), a.astype(np.float32), err_msg=name)
    assert any(a.dtype.name == "bfloat16" for a in want.values())
    assert any(a.dtype == np.float32 for a in want.values())  # the router's leaves
