"""The port's zamba2 hybrid stage against the JAX package: groups of Mamba2
slots, each followed by one application of the weight-shared attention block.

Parameters come from the JAX ``init_params`` through ``params_from_jax``.
The layout (slot plan, extras, param and cache shapes) equals the JAX one
exactly; the prefill (last-token logits and every cache leaf) and one decode
step match the JAX steps at 1e-4, as ``test_torch_transformer.py`` holds
the other archs; the train step (seq 64, batch 4, 2 micro-batches) matches
the JAX ``make_train_step`` — step-1 loss within 1e-5 relative, Adam's μ and
ν after step 1 within 1e-5 of each leaf's largest entry (exact zeros on
padding slots), three steps' losses within 1e-4 — at the smoke config and
at 7 layers in groups of 3, where the shared block runs twice per
micro-batch and a mamba slot and an attention slot are padding. The JAX
steps run on a 1x1 mesh with ``Auto`` axes. Inside the port, 2 stages equal
1 bit for bit under deterministic algorithms, and the interleaved schedule
is refused as the reference refuses it.
"""

import dataclasses
import functools

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
from repro_torch.launch import train as tlaunch
from repro_torch.launch.serve import splice
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.train.optimizer import tree_map

ARCH = "zamba2-7b"
STEP_ATOL = 1e-4  # prefill and decode
PROMPT, BATCH = 96, 4
SEQ, MICRO, LOSS_CHUNKS, LR, STEPS = 64, 2, 4, 3e-4, 3
LOSS_RTOL, MOMENT_TOL, LOSSES_ATOL = 1e-5, 1e-5, 1e-4
# each JAX step is compiled once: XLA's cheaper backend passes halve the
# compile, the file's largest cost
JIT_OPTIONS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# 7 slots in groups of 3: 5 mamba slots, the shared block after slots 2
# and 5, then a padding mamba slot and a padding attention slot
GROUPED = (("num_layers", 7), ("hybrid_attn_every", 3))


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size ops on one intra-op thread: the suite's parallel workers
    oversubscribe the cores otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def configs(**override):
    return (dataclasses.replace(jax_arch(ARCH, smoke=True), **override),
            dataclasses.replace(get_arch(ARCH, smoke=True), **override))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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


def shapes(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict of arrays, tensors or
    shape structs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
    return out


def close_flat(got: dict, want: dict, atol):
    assert set(got) == set(want)
    for name in got:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=atol, err_msg=name)


# --------------------------------------------------------------- layout --


@pytest.mark.parametrize("smoke", [True, False])
def test_layout_matches_jax(smoke):
    jcfg, cfg = jax_arch(ARCH, smoke=smoke), get_arch(ARCH, smoke=smoke)
    for stages in (1, 2, 3):
        assert TM.stacked_shape_plan(cfg, stages) == JM.stacked_shape_plan(jcfg, stages)
        want, got = flat(JM.make_extras(jcfg, stages)), flat(TM.make_extras(cfg, stages))
        assert set(got) == set(want)
        for name in got:
            np.testing.assert_array_equal(got[name], want[name])
    for stages in (1, 2):
        if smoke:  # the full config's 5.9e9 params are not drawn here
            want = jax.eval_shape(lambda k: JM.init_params(
                jcfg, k, num_stages=stages, dtype=jnp.float32), jax.random.PRNGKey(0))
            got = TM.init_params(cfg, seed=0, num_stages=stages)
            assert shapes(got) == shapes(want)
        for kind, seq in (("prefill", 32), ("decode", 48)):
            topo = TM.Topology(num_stages=stages, num_micro=2)
            jtopo = JM.Topology(num_stages=stages, fsdp_size=1, num_micro=2)
            want, _ = JM.abstract_cache(jcfg, jtopo, JShape("c", seq, 4, kind), dtype=jnp.float32)
            got = TM.init_cache(cfg, topo, ShapeConfig("c", seq, 4, kind), device="meta")
            assert shapes(got) == shapes(want)


# ------------------------------------------------------ prefill, decode --


def jax_params(num_stages=1, cfg=None):
    cfg = jax_arch(ARCH, smoke=True) if cfg is None else cfg
    return to_np(JM.init_params(cfg, jax.random.PRNGKey(0), num_stages=num_stages,
                                dtype=jnp.float32))


def prompt_tokens(vocab):
    return token_batch(batch=BATCH, seq=PROMPT, vocab=vocab, seed=0)[:, :-1]


def jax_serve(mesh):
    """JAX prefill -> splice -> one decode step: (prefill logits, prefill
    cache, next token, decode cache)."""
    cfg = jax_arch(ARCH, smoke=True)
    topo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=2)
    params = jax.tree_util.tree_map(jnp.asarray, jax_params())
    part = JM.make_prefill_step(cfg, topo, JShape("p", PROMPT, BATCH, "prefill"), mesh,
                                dtype=jnp.float32)
    sart = JM.make_serve_step(cfg, topo, JShape("d", PROMPT + 16, BATCH, "decode"), mesh,
                              dtype=jnp.float32)
    zeros = lambda art: jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                               art.abstract_inputs[1])
    batch = {"tokens": jnp.asarray(prompt_tokens(cfg.vocab_size))}
    logits, pcache = jax.jit(part.fn).lower(params, zeros(part), batch).compile(
        compiler_options=JIT_OPTIONS)(params, zeros(part), batch)

    def jsplice(dst, src):
        if dst.ndim >= 5 and src.shape[:3] == dst.shape[:3]:
            return dst.at[:, :, :, :, :src.shape[4]].set(src)
        return src

    dcache = jax.tree_util.tree_map(jsplice, zeros(sart), pcache)
    batch = {"tokens": jnp.argmax(logits, axis=-1).astype(jnp.int32), "pos": jnp.asarray(PROMPT)}
    nxt, dcache = jax.jit(sart.fn).lower(params, dcache, batch).compile(
        compiler_options=JIT_OPTIONS)(params, dcache, batch)
    return np.asarray(logits), flat(pcache), np.asarray(nxt), flat(dcache)


def port_serve(topo, params):
    cfg = get_arch(ARCH, smoke=True)
    pshape = ShapeConfig("p", PROMPT, BATCH, "prefill")
    dshape = ShapeConfig("d", PROMPT + 16, BATCH, "decode")
    toks = torch.from_numpy(prompt_tokens(cfg.vocab_size).astype(np.int64))
    with torch.inference_mode():
        logits, pcache = TM.make_prefill_step(cfg, topo, pshape)(
            params, TM.init_cache(cfg, topo, pshape), {"tokens": toks})
        pflat = flat(pcache)
        dcache = splice(TM.init_cache(cfg, topo, dshape), pcache)
        tok = logits.argmax(dim=-1).to(torch.int32)
        nxt, dcache, dlogits = TM.make_serve_step(cfg, topo, dshape)(
            params, dcache, {"tokens": tok, "pos": PROMPT})
    return logits.numpy(), pflat, nxt.numpy(), flat(dcache), dlogits.numpy()


def test_prefill_and_decode_match_jax(mesh):
    logits, pcache, nxt, dcache, dlogits = port_serve(TM.Topology(1, 2),
                                                      params_from_jax(jax_params()))
    j_logits, j_pcache, j_nxt, j_dcache = jax_serve(mesh)
    np.testing.assert_allclose(logits, j_logits, atol=STEP_ATOL, rtol=STEP_ATOL)
    close_flat(pcache, j_pcache, STEP_ATOL)
    close_flat(dcache, j_dcache, STEP_ATOL)
    assert {"mamba/ssm", "mamba/conv", "attn/k", "attn/v"} == set(pcache)
    # greedy tokens agree wherever the top two logits are not a near tie
    top = np.sort(dlogits, axis=-1)[:, -2:]
    clear = top[:, 1] - top[:, 0] > 1e-3
    assert clear.any()
    np.testing.assert_array_equal(nxt[clear], j_nxt[clear])


def restack(params: dict, num_stages: int) -> dict:
    """1-stage hybrid params as ``num_stages`` stages: the mamba slots of
    stage 0 first, zero slots after (the smoke's 2 slots fill stage 0's one
    group; the other stages are padding)."""
    def one(a):
        return torch.cat([a, torch.zeros((num_stages - 1, *a.shape[1:]), dtype=a.dtype)])

    return dict(params, blocks=tree_map(one, params["blocks"]))


def test_stages_bit_identical():
    """The smoke's group (one mamba slot, the shared block) on stage 0 of 2,
    stage 1 all padding: prefill, decode and three train steps equal the
    1-stage run bit for bit, and stage 1's moments are zeros."""
    cfg = get_arch(ARCH, smoke=True)
    assert TM.stacked_shape_plan(cfg, 2)["mamba_per_stage"] == 1
    base = TM.init_params(cfg, seed=4)
    one = port_serve(TM.Topology(1, 2), base)
    two = port_serve(TM.Topology(2, 2), restack(base, 2))
    for a, b in zip(one, two):
        if isinstance(a, dict):
            for name in a:  # (S, nm, slots, ...): stage 0 of the 2-stage cache
                assert np.array_equal(a[name][0], b[name][0]), name
        else:
            assert np.array_equal(a, b)
    t1 = port_train(cfg, topology(1), tree_map(torch.clone, base))
    t2 = port_train(cfg, topology(2), restack(base, 2))
    assert t1[0] == t2[0]
    for a, b in ((t1[1], t2[1]), (flat(t1[3]), flat(t2[3]))):
        for name in a:
            got = b[name][:1] if name.startswith("blocks/") else b[name]
            assert np.array_equal(a[name], got), name
    assert not any(v[1:].any() for k, v in t2[1].items() if k.startswith("blocks/"))


# ---------------------------------------------------------------- train --


def tokens(vocab, step):
    return token_batch(batch=BATCH, seq=SEQ, vocab=vocab, seed=0, step=step)


def topology(stages=1, schedule="fill_drain", num_virtual=1):
    return TM.Topology(num_stages=stages, num_micro=MICRO, loss_chunks=LOSS_CHUNKS,
                       schedule=schedule, num_virtual=num_virtual)


@functools.cache
def jax_train(override=()):
    cfg = configs(**dict(override))[0]
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    topo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=MICRO, loss_chunks=LOSS_CHUNKS)
    art = JM.make_train_step(cfg, topo, JShape("t", SEQ, BATCH, "train"), mesh, lr=LR,
                             dtype=jnp.float32)
    params = JM.init_params(cfg, jax.random.PRNGKey(0), num_stages=1, dtype=jnp.float32)
    p0 = to_np(params)
    opt = art.meta["optimizer"].init(params)
    batches = [{"tokens": jnp.asarray(tokens(cfg.vocab_size, i))} for i in range(STEPS)]
    step = jax.jit(art.fn).lower(params, opt, batches[0]).compile(compiler_options=JIT_OPTIONS)
    losses = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, batches[i])
        losses.append(float(m["loss"]))
        if i == 0:
            mu, nu = flat(opt.mu), flat(opt.nu)
    return p0, losses, mu, nu


def port_train(cfg, topo, params):
    step = TM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), lr=LR)
    opt = step.optimizer.init(params)
    losses = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(tokens(cfg.vocab_size, i))})
        losses.append(float(m["loss"]))
        if i == 0:
            mu, nu = flat(opt.mu), flat(opt.nu)
    return losses, mu, nu, params


def moments_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        scale, err = float(np.abs(w).max()), float(np.abs(got[name] - w).max())
        if scale == 0.0:
            assert err == 0.0, f"{name}: zero in the reference, {err} here"
        else:
            assert err <= MOMENT_TOL * scale, f"{name}: {err} > {MOMENT_TOL} x {scale}"


@pytest.mark.parametrize("override", [(), GROUPED], ids=["smoke", "grouped-padded"])
def test_train_step_matches_jax(override):
    p0, j_losses, j_mu, j_nu = jax_train(override)
    cfg = configs(**dict(override))[1]
    losses, mu, nu, _ = port_train(cfg, topology(), params_from_jax(p0))
    assert abs(losses[0] - j_losses[0]) <= LOSS_RTOL * abs(j_losses[0])
    moments_close(mu, j_mu)
    moments_close(nu, j_nu)
    np.testing.assert_allclose(losses, j_losses, atol=LOSSES_ATOL, rtol=0)
    if override:
        # the padding mamba slot (the 6th) and the shared block's gradient
        # summed over its two applications per micro-batch
        assert not mu["blocks/mamba/in_proj"][0, 5].any() and mu["blocks/mamba/in_proj"][0, 4].any()
        assert np.abs(mu["shared_attn/attn/w_q"]).max() > 0


def test_interleaved_is_refused_as_the_reference():
    cfg = get_arch(ARCH, smoke=True)
    with pytest.raises(NotImplementedError, match="zamba2-style hybrid stages run fill_drain"):
        TM.make_train_step(cfg, topology(2, "interleaved", 2),
                           ShapeConfig("t", SEQ, BATCH, "train"))
    with pytest.raises(NotImplementedError, match="homogeneous block stack"):
        tlaunch.main(["--mode", "lm", "--arch", ARCH, "--device", "cpu", "--steps", "1",
                      "--seq", "32", "--batch", "4", "--stages", "2", "--chunks", "2",
                      "--schedule", "interleaved"])


def test_cli_trains_zamba2_on_cpu():
    out = tlaunch.main(["--mode", "lm", "--arch", ARCH, "--device", "cpu", "--steps", "2",
                        "--seq", "32", "--batch", "4", "--chunks", "2", "--log-every", "0"])
    assert out["arch"] == ARCH and np.isfinite([out["first_loss"], out["last_loss"]]).all()
    shapes = jax.eval_shape(lambda k: JM.init_params(jax_arch(ARCH, smoke=True), k,
                                                     num_stages=1), jax.random.PRNGKey(0))
    assert out["params"] == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
