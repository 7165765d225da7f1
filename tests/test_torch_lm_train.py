"""The port's LM training step (``--mode lm``) against the JAX package.

At smoke size (seq 64, batch 4, 2 micro-batches, 4 loss chunks, Adam at lr
3e-4) from the JAX ``init_params`` carried across by ``params_from_jax``:
the step-1 loss within 1e-5 relative; Adam's moments after step 1 (μ = 0.1
g, ν = 0.001 g²) within 1e-5 of each leaf's largest entry, padding-slot
leaves included (exact zeros there); three steps' losses within 1e-4. The
JAX step runs on a 1x1 mesh with ``Auto`` axes (jax 0.9's default
``Explicit`` axes make its sharding constraints fail), at one stage, or
interleaved with 2 virtual stages on its one device (``num_stages=2`` under
fill_drain needs two devices). Inside the port, under deterministic
algorithms (the embedding's index-put sums in a thread-dependent order on
the CPU): 2 and 3 stages equal 1 bit for bit, ``remat`` on equals off bit
for bit, and interleaved equals fill_drain within 1e-6.
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
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.train.optimizer import tree_map

SEQ, BATCH, MICRO, LOSS_CHUNKS, LR, STEPS = 64, 4, 2, 4, 3e-4, 3
LOSS_RTOL = 1e-5  # step 1
MOMENT_TOL = 1e-5  # of each leaf's largest entry
LOSSES_ATOL = 1e-4  # three steps
INTERLEAVED_ATOL = 1e-6
# the JAX steps are compiled once and run 3 times: XLA's cheaper backend
# passes halve the compile, the suite's largest cost here
JIT_OPTIONS = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
TRAIN_ARCHS = ["mamba2-130m", "codeqwen1.5-7b", "gemma2-27b", "glm4-9b", "arctic-480b",
               "deepseek-v3-671b"]


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


def configs(arch, **override):
    """(JAX config, port config) at smoke size, with ``override`` applied
    to both."""
    return (dataclasses.replace(jax_arch(arch, smoke=True), **override),
            dataclasses.replace(get_arch(arch, smoke=True), **override))


def tokens(vocab, step):
    return token_batch(batch=BATCH, seq=SEQ, vocab=vocab, seed=0, step=step)


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
def jax_run(arch, stages=1, schedule="fill_drain", num_virtual=1, override=()):
    """The JAX train step over ``STEPS`` steps: (initial params as numpy,
    losses, μ after step 1, ν after step 1)."""
    cfg = configs(arch, **dict(override))[0]
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    topo = JM.Topology(num_stages=stages, fsdp_size=1, num_micro=MICRO, loss_chunks=LOSS_CHUNKS,
                       schedule=schedule, num_virtual=num_virtual)
    art = JM.make_train_step(cfg, topo, JShape("t", SEQ, BATCH, "train"), mesh, lr=LR,
                             dtype=jnp.float32)
    params = JM.init_params(cfg, jax.random.PRNGKey(0), num_stages=stages, dtype=jnp.float32)
    p0 = flat_tree(params)
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


def flat_tree(params):
    """JAX params as a nested dict of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, params)


def port_run(cfg, topo, params, steps=STEPS):
    """The port's train step over ``steps`` steps from ``params`` (updated
    in place): (losses, μ and ν after step 1, final params)."""
    step = TM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), lr=LR)
    opt = step.optimizer.init(params)
    losses = []
    for i in range(steps):
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(tokens(cfg.vocab_size, i))})
        losses.append(float(m["loss"]))
        if i == 0:
            mu, nu = flat(opt.mu), flat(opt.nu)
    return losses, mu, nu, params


def topology(stages=1, schedule="fill_drain", num_virtual=1, remat=True):
    return TM.Topology(num_stages=stages, num_micro=MICRO, loss_chunks=LOSS_CHUNKS,
                       schedule=schedule, num_virtual=num_virtual, remat=remat)


def moments_close(got: dict, want: dict):
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        scale = float(np.abs(w).max())
        err = float(np.abs(got[name] - w).max())
        if scale == 0.0:
            assert err == 0.0, f"{name}: zero in the reference, {err} here"
        else:
            assert err <= MOMENT_TOL * scale, f"{name}: {err} > {MOMENT_TOL} x {scale}"


def assert_matches_jax(jax_result, port_result):
    _, j_losses, j_mu, j_nu = jax_result
    losses, mu, nu, _ = port_result
    assert abs(losses[0] - j_losses[0]) <= LOSS_RTOL * abs(j_losses[0])
    moments_close(mu, j_mu)
    moments_close(nu, j_nu)
    np.testing.assert_allclose(losses, j_losses, atol=LOSSES_ATOL, rtol=0)
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_jax(arch):
    want = jax_run(arch)
    got = port_run(get_arch(arch, smoke=True), topology(), params_from_jax(want[0]))
    assert_matches_jax(want, got)


def test_interleaved_matches_jax_with_a_padding_slot():
    """3 mamba layers over 2 virtual stages of 2 slots: the last slot is
    padding, its moments exact zeros on both sides."""
    override = (("num_layers", 3),)
    want = jax_run("mamba2-130m", 2, "interleaved", 2, override)
    cfg = configs("mamba2-130m", num_layers=3)[1]
    got = port_run(cfg, topology(2, "interleaved", 2), params_from_jax(want[0]))
    assert_matches_jax(want, got)
    pad = got[1]["blocks/mamba/in_proj"][1, 1]
    assert pad.shape == (cfg.d_model, pad.shape[-1]) and not pad.any()


def restack(params: dict, num_stages: int) -> dict:
    """1-stage params (1, L, ...) as ``num_stages`` stages of L/num_stages
    slots, padded with zero slots to a whole number per stage."""
    def one(a):
        layers = a.shape[1]
        per = -(-layers // num_stages)
        pad = torch.zeros((per * num_stages - layers, *a.shape[2:]), dtype=a.dtype)
        return torch.cat([a[0], pad]).reshape(num_stages, per, *a.shape[2:])

    return dict(params, blocks=tree_map(one, params["blocks"]))


def unstack(tree: dict, layers: int) -> dict:
    """The inverse of ``restack`` on a flat {path: array} dict."""
    return {k: (v.reshape(1, -1, *v.shape[2:])[:, :layers] if k.startswith("blocks/") else v)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch,stages", [("mamba2-130m", 2), ("codeqwen1.5-7b", 2),
                                         ("gemma2-27b", 3), ("arctic-480b", 2)])
def test_stages_bit_identical(arch, stages):
    """Slots split over stages (3 stages of 1 slot: one padding slot) give
    the same losses, update and moments bit for bit; the padding slot's
    moments are zeros. On arctic the MoE routes each micro-batch alike
    either way."""
    cfg = get_arch(arch, smoke=True)
    base = TM.init_params(cfg, seed=1)
    one = port_run(cfg, topology(), tree_map(torch.clone, base))
    many = port_run(cfg, topology(stages), restack(base, stages))
    assert one[0] == many[0]
    for a, b in ((one[1], unstack(many[1], cfg.num_layers)),
                 (flat(one[3]), unstack(flat(many[3]), cfg.num_layers))):
        assert set(a) == set(b)
        for name in a:
            assert np.array_equal(a[name], b[name]), name
    if stages * -(-cfg.num_layers // stages) > cfg.num_layers:
        pad = {k: v.reshape(-1, *v.shape[2:])[cfg.num_layers:] for k, v in many[1].items()
               if k.startswith("blocks/")}
        assert pad and not any(v.any() for v in pad.values())


@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma2-27b"])
def test_remat_bit_identical(arch):
    cfg = get_arch(arch, smoke=True)
    base = TM.init_params(cfg, seed=2, num_stages=2)
    on = port_run(cfg, topology(2, remat=True), tree_map(torch.clone, base))
    off = port_run(cfg, topology(2, remat=False), base)
    assert on[0] == off[0]
    for a, b in ((on[1], off[1]), (on[2], off[2]), (flat(on[3]), flat(off[3]))):
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("arch", ["mamba2-130m", "codeqwen1.5-7b"])
def test_interleaved_equals_fill_drain(arch):
    cfg = get_arch(arch, smoke=True)
    base = TM.init_params(cfg, seed=3, num_stages=2)
    fd = port_run(cfg, topology(2), tree_map(torch.clone, base))
    il = port_run(cfg, topology(2, "interleaved", 2), base)
    np.testing.assert_allclose(il[0], fd[0], atol=INTERLEAVED_ATOL, rtol=0)
    a, b = flat(il[3]), flat(fd[3])
    for name in a:
        np.testing.assert_allclose(a[name], b[name], atol=INTERLEAVED_ATOL, rtol=0)


def test_interleaved_order_is_the_reference_tick_order():
    """Every (virtual stage, micro-batch) once, each micro-batch's stages in
    order; one ring position walks stage-major, two interleave."""
    assert TM._interleaved_order(1, 2, 3) == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    order = TM._interleaved_order(2, 2, 2)
    assert order == [(0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (2, 1), (3, 0), (3, 1)]
    for d, v, c in ((2, 3, 2), (3, 2, 4), (1, 4, 1)):
        order = TM._interleaved_order(d, v, c)
        assert sorted(order) == [(s, m) for s in range(d * v) for m in range(c)]
        for m in range(c):
            assert [s for s, mm in order if mm == m] == list(range(d * v))


def test_batch_specs_and_labels_match_jax():
    jcfg, cfg = configs("codeqwen1.5-7b")
    topo = JM.Topology(num_stages=1)
    for kind in ("train", "prefill", "decode"):
        want, _ = JM.batch_specs(jcfg, JShape("s", SEQ, BATCH, kind), topo)
        got = TM.batch_specs(cfg, ShapeConfig("s", SEQ, BATCH, kind))
        assert {k: tuple(v.shape) for k, v in want.items()} == {k: v[0] for k, v in got.items()}
    toks = tokens(cfg.vocab_size, 0)
    toks[1, 5] = -1  # an ignored label
    labels, mask = TM.labels_from_batch({"tokens": torch.from_numpy(toks)}, SEQ)
    j_labels, j_mask = JM._labels_from_batch(jcfg, {"tokens": jnp.asarray(toks)}, SEQ)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_labels))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-2b"])
def test_cli_lm_trains_the_frontend_archs(arch, capsys):
    """``--mode lm`` at smoke size on the frontend archs: finite losses, the
    JAX init's parameter count, the summary printed."""
    out = tlaunch.main(["--mode", "lm", "--arch", arch, "--device", "cpu", "--steps", "3",
                        "--seq", "64", "--batch", "4", "--log-every", "0"])
    assert out["arch"] == arch and np.isfinite([out["first_loss"], out["last_loss"]]).all()
    shapes = jax.eval_shape(lambda k: JM.init_params(jax_arch(arch, smoke=True), k,
                                                     num_stages=1), jax.random.PRNGKey(0))
    assert out["params"] == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert str(out) in capsys.readouterr().out


def test_cli_lm_returns_the_reference_keys(capsys):
    out = tlaunch.main(["--mode", "lm", "--arch", "mamba2-130m", "--device", "cpu", "--steps",
                        "3", "--seq", "64", "--batch", "4"])
    assert {"arch", "first_loss", "last_loss", "improved", "avg_step_s"} <= set(out)
    assert out["arch"] == "mamba2-130m" and out["device"] == "cpu"
    assert out["peak_mem_gb"] is None and out["device_name"] == "cpu"
    assert np.isfinite([out["first_loss"], out["last_loss"]]).all()
    shapes = jax.eval_shape(lambda k: JM.init_params(jax_arch("mamba2-130m", smoke=True), k,
                                                     num_stages=1), jax.random.PRNGKey(0))
    assert out["params"] == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert str(out) in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--mode", "lm", "--steps", "1"])


@pytest.mark.parametrize("argv, error, match", [
    (["--schedule", "1f1b"], ValueError, "supports fill_drain|interleaved"),
    (["--chunks", "3"], ValueError, "must divide the per-device batch"),
    (["--stages", "2", "--schedule", "interleaved", "--pipe-devices", "3"], ValueError,
     "must divide --stages"),
])
def test_cli_lm_refuses_as_the_reference(argv, error, match):
    with pytest.raises(error, match=match):
        tlaunch.main(["--mode", "lm", "--device", "cpu", "--steps", "1", "--seq", "16",
                      "--batch", "4", *argv])
