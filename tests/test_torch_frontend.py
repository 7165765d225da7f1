"""The modality-frontend archs (musicgen-large, qwen2-vl-2b) and m-rope
against the JAX package, at smoke size (2 layers, d 128) on the CPU.

From the JAX ``init_params`` carried across by ``params_from_jax``, with the
JAX steps on a 1x1 mesh with ``Auto`` axes: ``apply_mrope`` (1e-5);
``make_positions``, ``batch_specs``, ``labels_from_batch`` and
``model_flops`` exactly; the flash op's plain version masked by the m-rope
t-row against the JAX ``blocked_attention`` (1e-5); each arch's prefill
(logits and every cache leaf) and one decode step against
``make_prefill_step`` / ``make_serve_step`` (1e-4); three training steps
against ``make_train_step`` at the tolerances of
``tests/test_torch_lm_train.py``. And the reference's own m-rope
inconsistency, pinned: qwen2-vl's decode rotates the new token by its
absolute index, its fresh prefill by t, so the two disagree in the JAX
package itself, and the port reproduces both numbers (musicgen's agree).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import ShapeConfig as JShape
from repro.configs import get_arch as jax_arch
from repro.configs import list_archs as jax_archs
from repro.data.tokens import frontend_embeds as jax_frontend_embeds
from repro.data.tokens import token_batch
from repro.models.transformer import model as JM
from repro.models.transformer.attention import blocked_attention as jax_blocked
from repro.models.transformer.common import apply_mrope as jax_mrope
from repro.roofline.analysis import model_flops as jax_model_flops
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.kernels.flash.ref import flash_attention_ref
from repro_torch.launch import serve as S
from repro_torch.launch import train as tlaunch
from repro_torch.launch.serve import splice
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.common import apply_mrope
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.roofline import model_flops

ATOL = 1e-5
STEP_ATOL = 1e-4
LOSS_RTOL, MOMENT_TOL, LOSSES_ATOL = 1e-5, 1e-5, 1e-4  # tests/test_torch_lm_train.py:38-42
ARCHS = ["musicgen-large", "qwen2-vl-2b"]
PROMPT, BATCH, MICRO = 96, 4, 2  # 24 frontend rows, 72 tokens
SEQ, STEPS, LR = 64, 3, 3e-4  # training: 16 frontend rows
# the JAX steps are compiled once: XLA's cheaper backend passes halve it
JIT_OPTIONS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size ops on one intra-op thread: the suite's parallel workers
    oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def rng_array(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=atol)


def flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().numpy().copy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    return out


@functools.cache
def jax_params(arch):
    cfg = jax_arch(arch, smoke=True)
    return jax.tree_util.tree_map(np.asarray, JM.init_params(
        cfg, jax.random.PRNGKey(0), num_stages=1, dtype=jnp.float32))


def prompt(arch, plen=PROMPT):
    """``launch.serve``'s prompt at ``plen`` rows: (tokens, frontend)."""
    cfg = jax_arch(arch, smoke=True)
    s_front = int(plen * cfg.frontend_frac)
    toks = token_batch(batch=BATCH, seq=plen - s_front, vocab=cfg.vocab_size, seed=0)
    front = jax_frontend_embeds(batch=BATCH, seq=s_front, d_model=cfg.d_model, seed=0)
    return toks[:, :-1][:, :plen - s_front], front


# ------------------------------------------------------------- modules --


@pytest.mark.parametrize("pos_shape", [(3, 9), (3, 2, 9)])
def test_apply_mrope_matches_jax(pos_shape):
    x = rng_array((2, 9, 4, 16), 0)
    pos = np.random.default_rng(1).integers(0, 50, pos_shape).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        want = jax_mrope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
        got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta=theta)
        close(got, want, ATOL)


@pytest.mark.parametrize("arch", ARCHS + ["codeqwen1.5-7b"])
def test_make_positions_match_jax_exactly(arch):
    for seq in (1, 4, 7, 64, 96, 97, 512, 513):
        want = np.asarray(JM.make_positions(jax_arch(arch, smoke=True), seq))
        got = TM.make_positions(get_arch(arch, smoke=True), seq)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # the flash kernel's mask order: the m-rope t-row never decreases,
        # the rope positions are the index path's arange
        if got.ndim == 2:
            assert (np.diff(got[0].numpy()) >= 0).all()
        else:
            np.testing.assert_array_equal(got.numpy(), np.arange(seq))


@pytest.mark.parametrize("arch", ARCHS + ["codeqwen1.5-7b"])
def test_attn_apply_masks_by_the_t_row_only_on_mrope(arch, monkeypatch):
    """m-rope archs hand the flash op their t-row, checked in the model
    (``ordered``); the others hand it nothing, so the kernel takes its index
    path."""
    from repro_torch.models.transformer import blocks as TB

    cfg = get_arch(arch, smoke=True)
    seen = []

    def record(q, k, v, window, softcap, kv_block, **kw):
        seen.append(kw)
        return flash_attention_ref(q, k, v, window=window, softcap=softcap,
                                   q_pos=kw["q_pos"], kv_pos=kw["kv_pos"])

    monkeypatch.setattr(TB, "flash_attention", record)
    lp = TB.init_block(cfg, torch.Generator().manual_seed(0))
    pos = TM.make_positions(cfg, 32)
    TB.attn_apply(cfg, lp["attn"], torch.randn(1, 32, cfg.d_model), positions=pos, window=0)
    (kw,) = seen
    assert kw["ordered"] is True
    if cfg.rope_kind == "mrope":
        assert kw["q_pos"] is kw["kv_pos"] and torch.equal(kw["q_pos"], pos[0])
    else:
        assert kw["q_pos"] is None and kw["kv_pos"] is None


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_and_labels_match_jax(arch):
    jcfg, cfg = jax_arch(arch, smoke=True), get_arch(arch, smoke=True)
    for seq in (SEQ, PROMPT, 97):
        for kind in ("train", "prefill", "decode"):
            want, _ = JM.batch_specs(jcfg, JShape("s", seq, BATCH, kind), JM.Topology(1))
            got = TM.batch_specs(cfg, ShapeConfig("s", seq, BATCH, kind))
            assert {k: tuple(v.shape) for k, v in want.items()} == \
                {k: v[0] for k, v in got.items()}
        # train tokens: the text columns and the labels' shift
        toks = token_batch(batch=BATCH, seq=seq - int(seq * cfg.frontend_frac),
                           vocab=cfg.vocab_size, seed=0)
        toks[1, 5] = -1  # an ignored label
        labels, mask = TM.labels_from_batch({"tokens": torch.from_numpy(toks)}, seq)
        j_labels, j_mask = JM._labels_from_batch(jcfg, {"tokens": jnp.asarray(toks)}, seq)
        assert labels.shape == (BATCH, seq)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))


@pytest.mark.parametrize("window", [0, 20])
def test_flash_plain_version_masks_by_the_t_row_as_jax(window):
    """The frontend rows (t = 0) see each other both ways; text row i sees
    the frontend and the earlier text."""
    cfg = get_arch("qwen2-vl-2b", smoke=True)
    s, h, kv, hd = 96, 4, 2, 32
    q, k, v = (rng_array(shape, seed) for shape, seed in
               (((2, s, h, hd), 2), ((2, s, kv, hd), 3), ((2, s, kv, hd), 4)))
    t_row = TM.make_positions(cfg, s)[0]
    want = jax_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_pos=jnp.asarray(t_row.numpy()), kv_pos=jnp.asarray(t_row.numpy()),
                       window=window, kv_block=32)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              window=window, kv_block=32, q_pos=t_row, kv_pos=t_row)
    close(got, want, ATOL)
    index = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                window=window, kv_block=32)
    assert not torch.allclose(got[:, :23], index[:, :23])  # the prefix is not index-causal


@pytest.mark.parametrize("arch", jax_archs())
def test_model_flops_match_jax_exactly(arch):
    for kind in ("train", "prefill", "decode"):
        shape = (JShape("s", 512, 8, kind), ShapeConfig("s", 512, 8, kind))
        want = jax_model_flops(jax_arch(arch), shape[0], training=kind == "train")
        assert model_flops(get_arch(arch), shape[1], training=kind == "train") == want


# --------------------------------------------------------- whole steps --


@functools.cache
def jax_serve(arch, plen=PROMPT, decode=True):
    """JAX prefill at ``plen`` rows -> splice -> one decode step at position
    ``plen``: (prefill logits, prefill cache, next tokens, decode cache)."""
    cfg = jax_arch(arch, smoke=True)
    topo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=MICRO)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(arch))
    toks, front = prompt(arch, PROMPT)
    if plen == PROMPT + 1:  # the prompt plus a token: a fresh prefill one row longer
        toks = np.concatenate([toks, toks[:, :1]], axis=1)
    part = JM.make_prefill_step(cfg, topo, JShape("p", plen, BATCH, "prefill"), mesh(),
                                dtype=jnp.float32)
    zeros = lambda art: jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                               art.abstract_inputs[1])
    batch = {"tokens": jnp.asarray(toks), "frontend_embeds": jnp.asarray(front)}
    logits, pcache = jax.jit(part.fn)(params, zeros(part), batch)
    if not decode:
        return np.asarray(logits), jax.tree_util.tree_map(np.asarray, pcache)
    sart = JM.make_serve_step(cfg, topo, JShape("d", plen + 16, BATCH, "decode"), mesh(),
                              dtype=jnp.float32)
    dcache = jax.tree_util.tree_map(
        lambda d, s: d.at[:, :, :, :, :s.shape[4]].set(s) if d.ndim >= 5 else s,
        zeros(sart), pcache)
    nxt, dcache = jax.jit(sart.fn)(params, dcache, {"tokens": jnp.asarray(toks[:, 0]),
                                                    "pos": jnp.asarray(plen)})
    return (np.asarray(logits), jax.tree_util.tree_map(np.asarray, pcache), np.asarray(nxt),
            jax.tree_util.tree_map(np.asarray, dcache))


def port_serve(arch, plen=PROMPT, positions=None):
    """The port's prefill (at ``positions`` when given) -> splice -> one
    decode step, as ``jax_serve``; plus the decode step's logits."""
    cfg = get_arch(arch, smoke=True)
    topo = TM.Topology(1, MICRO)
    params = params_from_jax(jax_params(arch))
    toks, front = prompt(arch, PROMPT)
    if plen == PROMPT + 1:
        toks = np.concatenate([toks, toks[:, :1]], axis=1)
    pshape = ShapeConfig("p", plen, BATCH, "prefill")
    dshape = ShapeConfig("d", plen + 16, BATCH, "decode")
    batch = {"tokens": torch.from_numpy(toks.astype(np.int64)),
             "frontend_embeds": torch.from_numpy(front)}
    with torch.inference_mode():
        if positions is None:
            logits, pcache = TM.make_prefill_step(cfg, topo, pshape)(
                params, TM.init_cache(cfg, topo, pshape), batch)
        else:
            logits, pcache = TM._prefill(cfg, topo, TM.make_extras(cfg, 1), params,
                                         TM.init_cache(cfg, topo, pshape), batch, plen,
                                         torch.from_numpy(positions))
        dcache = splice(TM.init_cache(cfg, topo, dshape), pcache)
        nxt, dcache, dlogits = TM.make_serve_step(cfg, topo, dshape)(
            params, dcache, {"tokens": torch.from_numpy(toks[:, 0]).int(), "pos": plen})
    return logits, pcache, nxt, dcache, dlogits


def close_tree(got: dict, want: dict, atol):
    assert set(got) == set(want)
    for name in got:
        assert tuple(got[name].shape) == tuple(np.shape(want[name])), name
        close(got[name], want[name], atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_steps(arch):
    logits, pcache, nxt, dcache, dlogits = port_serve(arch)
    j_logits, j_pcache, j_nxt, j_dcache = jax_serve(arch)
    close(logits, j_logits, STEP_ATOL)
    close_tree(pcache, j_pcache, STEP_ATOL)
    close_tree(dcache, j_dcache, STEP_ATOL)
    top = np.sort(dlogits.numpy(), axis=-1)[:, -2:]
    clear = top[:, 1] - top[:, 0] > 1e-3  # greedy tokens agree where no near tie
    assert clear.any()
    np.testing.assert_array_equal(nxt.numpy()[clear], j_nxt[clear])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_vs_fresh_prefill_as_in_the_reference(arch):
    """The cache row that one decode step at position 96 writes, against a
    fresh 97-row prefill's: equal on musicgen (plain rope), 0.1 and more
    apart on qwen2-vl in the JAX package itself (the decode rotates by the
    absolute index 96, the prefill by t = 96 - 24 + 1 = 73), and the port
    gives both sides the reference's numbers. A fresh prefill at the
    decode's own positions (``make_positions(96)``, then 96 on all three
    axes) agrees with the port's decode."""
    cfg = get_arch(arch, smoke=True)
    j_dcache = jax_serve(arch)[3]
    j_fresh = jax_serve(arch, PROMPT + 1, decode=False)[1]
    _, _, _, dcache, _ = port_serve(arch)
    _, fresh, _, _, _ = port_serve(arch, PROMPT + 1)
    row = lambda c: np.asarray(c["k"])[..., PROMPT, :, :]  # (S, nm, slots, b_mb, KV, hd)
    j_gap = float(np.abs(row(j_dcache) - row(j_fresh)).max())
    gap = float(np.abs(row(dcache) - row(fresh)).max())
    assert abs(gap - j_gap) <= STEP_ATOL
    close(row(dcache), row(j_dcache), STEP_ATOL)
    close(row(fresh), row(j_fresh), STEP_ATOL)
    if cfg.rope_kind == "mrope":
        assert j_gap > 0.1
        pos = np.concatenate([TM.make_positions(cfg, PROMPT).numpy(),
                              np.full((3, 1), PROMPT, np.int32)], axis=1)
        _, own, _, _, _ = port_serve(arch, PROMPT + 1, positions=pos)
        close(row(own), row(dcache), STEP_ATOL)
    else:
        assert j_gap <= STEP_ATOL


def train_batches(arch):
    """The ``--mode lm`` launcher's batches of ``STEPS`` steps: the frontend
    embeddings seeded by the step index, as the JAX launcher seeds them."""
    args = tlaunch.build_parser().parse_args(["--mode", "lm", "--seq", str(SEQ), "--batch",
                                              str(BATCH)])
    return [tlaunch.lm_batch(get_arch(arch, smoke=True), args, i, "cpu") for i in range(STEPS)]


def test_train_batches_are_the_reference_launchers():
    cfg = jax_arch("qwen2-vl-2b", smoke=True)
    for i, batch in enumerate(train_batches("qwen2-vl-2b")):
        np.testing.assert_array_equal(batch["tokens"].numpy(), token_batch(
            batch=BATCH, seq=SEQ - 16, vocab=cfg.vocab_size, seed=0, step=i))
        np.testing.assert_array_equal(batch["frontend_embeds"].numpy(), jax_frontend_embeds(
            batch=BATCH, seq=16, d_model=cfg.d_model, seed=i))


@functools.cache
def jax_train(arch):
    """The JAX train step over ``STEPS`` steps: (losses, μ and ν after step 1)."""
    cfg = jax_arch(arch, smoke=True)
    topo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=MICRO, loss_chunks=4)
    art = JM.make_train_step(cfg, topo, JShape("t", SEQ, BATCH, "train"), mesh(), lr=LR,
                             dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params(arch))
    opt = art.meta["optimizer"].init(params)
    batches = [{k: jnp.asarray(v.numpy()) for k, v in b.items()} for b in train_batches(arch)]
    step = jax.jit(art.fn).lower(params, opt, batches[0]).compile(compiler_options=JIT_OPTIONS)
    losses = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, batches[i])
        losses.append(float(m["loss"]))
        if i == 0:
            mu, nu = flat(opt.mu), flat(opt.nu)
    return losses, mu, nu


def moments_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[name] - w).max())
        assert err <= MOMENT_TOL * scale, f"{name}: {err} > {MOMENT_TOL} x {scale}"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    """Three steps on the launcher's batches against the JAX step: the
    step-1 loss within 1e-5 relative, Adam's moments after step 1 within
    1e-5 of each leaf's largest entry, the three losses within 1e-4."""
    j_losses, j_mu, j_nu = jax_train(arch)
    cfg = get_arch(arch, smoke=True)
    topo = TM.Topology(num_stages=1, num_micro=MICRO, loss_chunks=4)
    step = TM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), lr=LR)
    params = params_from_jax(jax_params(arch))
    opt = step.optimizer.init(params)
    losses = []
    for i, batch in enumerate(train_batches(arch)):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            moments_close(flat(opt.mu), j_mu)
            moments_close(flat(opt.nu), j_nu)
    assert abs(losses[0] - j_losses[0]) <= LOSS_RTOL * abs(j_losses[0])
    np.testing.assert_allclose(losses, j_losses, atol=LOSSES_ATOL, rtol=0)


# ------------------------------------------------------- the launchers --


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_draws_the_reference_prompt(arch):
    """``launch.serve`` at smoke size: tokens and frontend rows as the JAX
    launcher draws them, and greedy tokens from its prefill and decode."""
    served = S.serve(S.build_parser().parse_args([
        "--arch", arch, "--prompt-len", str(PROMPT), "--decode-steps", "2", "--batch",
        str(BATCH), "--device", "cpu"]))
    toks, front = prompt(arch)
    np.testing.assert_array_equal(served.prompt.numpy(), toks)
    np.testing.assert_array_equal(served.frontend_embeds.numpy(), front)
    assert served.prompt_len == PROMPT and set(served.batch()) == {"tokens", "frontend_embeds"}
    assert served.generation.tokens.shape == (BATCH, 3)
    assert served.summary["tokens_generated"] == BATCH * 3


@pytest.mark.parametrize("bad,match", [("shape", "positions of shape"),
                                       ("order", "positions decreases")])
def test_prefill_at_given_positions_checks_shape_and_order(bad, match):
    cfg = get_arch("qwen2-vl-2b", smoke=True)
    topo = TM.Topology(1, MICRO)
    shape = ShapeConfig("p", PROMPT, BATCH, "prefill")
    toks, front = prompt("qwen2-vl-2b")
    batch = {"tokens": torch.from_numpy(toks.astype(np.int64)),
             "frontend_embeds": torch.from_numpy(front)}
    pos = TM.make_positions(cfg, PROMPT)
    if bad == "shape":
        pos = pos[0]
    else:
        pos[0, -1] = 0  # the last text row's t below the one before it
    with pytest.raises(ValueError, match=match):
        TM._prefill(cfg, topo, TM.make_extras(cfg, 1), TM.init_params(cfg),
                    TM.init_cache(cfg, topo, shape), batch, PROMPT, pos)
