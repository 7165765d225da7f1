"""The port at the reference's own dtype, bf16: leaf dtypes, bit-identity
inside the port, and the dry run's count.

The reference builds its LM steps at ``dtype=jnp.bfloat16`` by default
(``make_train_step``, ``make_serve_step``, ``make_prefill_step``,
``init_params``, ``abstract_cache``): params, caches and activations bf16;
the router's weights and bias, Mamba's ``A_log``/``dt_bias``/``D`` and
``ssm`` state, Adam's moments and the loss float32. On the CPU at smoke
size, with no compile (``jax.eval_shape``):

* for every arch, the dtype of every leaf of the params, the prefill and
  decode caches, Adam's state and each step's outputs equals the
  reference's, the port's steps run on the meta device;
* inside the port at bf16 params, under deterministic algorithms on one
  thread: 2 stages give 1 stage's losses, params and moments bit for bit,
  and interleaved (2 virtual stages) gives fill_drain's;
* the dry run counts at bf16 by default: its param and cache bytes equal
  the reference's abstract inputs' bytes at full width, its bf16 products
  are priced at the bf16 rate and its float32 ones at the fp32 rate.

The bf16 steps' numbers against the reference's are held in
``tests/test_torch_bf16_steps.py``; the ring and data-axis spawns hold
bf16 bit for bit across ranks (``tests/test_torch_lm_ranks.py``,
``tests/test_torch_lm_data.py``).
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
from repro.train import optimizer as jopt
from repro_torch.configs import SHAPES, ShapeConfig, get_arch, list_archs
from repro_torch.launch import dryrun
from repro_torch.models.transformer import model as TM
from repro_torch.roofline import analysis as tana
from repro_torch.train.optimizer import tree_leaves, tree_map

BATCH, SEQ, MICRO, LOSS_CHUNKS = 4, 32, 2, 4
CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def dtypes(tree) -> dict:
    """{path: dtype name} of a nested dict of tensors or JAX shapes."""
    return {k: str(v.dtype).replace("torch.", "") for k, v in _flat(tree).items()}


def shapes(kind):
    return SEQ + 16 if kind == "decode" else SEQ


@pytest.mark.parametrize("arch", list_archs())
def test_leaf_dtypes_match_the_reference(arch):
    """Params, caches, Adam's state and the steps' outputs: the same dtype
    leaf for leaf as the reference's at its default (bf16)."""
    jcfg, cfg = jax_arch(arch, smoke=True), get_arch(arch, smoke=True)
    jtopo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=MICRO, loss_chunks=LOSS_CHUNKS)
    topo = TM.Topology(num_stages=1, num_micro=MICRO, loss_chunks=LOSS_CHUNKS)
    for kind, make in (("train", JM.make_train_step), ("prefill", JM.make_prefill_step),
                       ("decode", JM.make_serve_step)):
        art = make(jcfg, jtopo, JShape("s", shapes(kind), BATCH, kind), mesh())
        want_in = art.abstract_inputs
        want_out = jax.eval_shape(art.fn, *want_in)
        step, got_in = dryrun.build_step(cfg, ShapeConfig("s", shapes(kind), BATCH, kind), topo)
        assert dtypes(got_in[0]) == dtypes(want_in[0]), (kind, "params")
        batch_want = {k: v for k, v in want_in[2].items() if k != "frontend_embeds"}
        batch_got = {k: v for k, v in got_in[2].items() if k != "frontend_embeds" and k != "pos"}
        assert dtypes(batch_got) == {k: v for k, v in dtypes(batch_want).items() if k != "pos"}
        if "frontend_embeds" in want_in[2]:
            assert got_in[2]["frontend_embeds"].dtype == torch.bfloat16
        out = step(*got_in)
        if kind == "train":
            state = got_in[1]
            assert dtypes({"mu": state.mu, "nu": state.nu}) == \
                dtypes({"mu": want_in[1].mu, "nu": want_in[1].nu})
            assert state.step.dtype == torch.int32 and want_in[1].step.dtype == jnp.int32
            want_state = jax.eval_shape(jopt.adam(1e-4).init, want_in[0])
            assert dtypes({"mu": want_state.mu}) == dtypes({"mu": state.mu})
            params, opt_state, metrics = out
            assert dtypes(params) == dtypes(want_out[0])
            assert dtypes({"mu": opt_state.mu, "nu": opt_state.nu}) == \
                dtypes({"mu": want_out[1].mu, "nu": want_out[1].nu})
            assert metrics["loss"].dtype == torch.float32 == \
                getattr(torch, str(want_out[2]["loss"].dtype))
        else:
            assert dtypes(got_in[1]) == dtypes(want_in[1]), (kind, "cache")
            if kind == "prefill":
                logits, cache = out
                assert str(want_out[0].dtype) == "float32" and logits.dtype == torch.float32
            else:
                tokens, cache, logits = out
                assert str(want_out[0].dtype) == "int32" and tokens.dtype == torch.int32
                assert logits.dtype == torch.float32
            assert dtypes(cache) == dtypes(want_out[1]), (kind, "cache out")


def restack(params: dict, num_stages: int) -> dict:
    """1-stage params (1, L, ...) as ``num_stages`` stages of L/num_stages
    slots (L a multiple of num_stages)."""
    one = lambda a: a[0].reshape(num_stages, a.shape[1] // num_stages, *a.shape[2:]).clone()
    return dict(tree_map(torch.clone, params), blocks=tree_map(one, params["blocks"]))


def run(cfg, topo, params, steps=2):
    """``steps`` train steps from ``params``: (losses, params, Adam's state)."""
    step = TM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), lr=3e-4)
    opt, losses = step.optimizer.init(params), []
    for i in range(steps):
        batch = {"tokens": torch.from_numpy(token_batch(batch=BATCH, seq=SEQ,
                                                        vocab=cfg.vocab_size, seed=0, step=i))}
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].clone())
    return losses, params, opt


def same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mamba2-130m"])
def test_bf16_stages_and_schedules_bit_identical(arch):
    """bf16 params: 2 stages against 1 (the same rows restacked), and
    interleaved with 2 virtual stages against fill_drain on 2: losses,
    params and Adam's moments bit for bit."""
    torch.use_deterministic_algorithms(True)
    try:
        cfg = get_arch(arch, smoke=True)
        topo = lambda stages, **kw: TM.Topology(num_stages=stages, num_micro=MICRO,
                                                loss_chunks=LOSS_CHUNKS, **kw)
        base = TM.init_params(cfg, seed=1, dtype=torch.bfloat16)
        kinds = dtypes(base)
        one = run(cfg, topo(1), tree_map(torch.clone, base))
        two = run(cfg, topo(2), restack(base, 2))
        inter = run(cfg, topo(2, schedule="interleaved", num_virtual=2), restack(base, 2))
    finally:
        torch.use_deterministic_algorithms(False)
    assert dtypes(one[1]) == kinds and "bfloat16" in kinds.values()
    assert all(torch.isfinite(x).all() for x in one[0])
    for got in (two, inter):
        assert all(torch.equal(a, b) for a, b in zip(one[0], got[0]))
        assert same(restack(one[1], 2), got[1])
        for part in ("mu", "nu"):
            assert same(restack(getattr(one[2], part), 2), getattr(got[2], part))


def _bytes(tree) -> int:
    return sum(int(np.prod(v.shape)) * np.dtype(v.dtype).itemsize for v in _flat(tree).values())


def test_dryrun_counts_at_bf16_by_default():
    """codeqwen1.5-7b x decode_32k at full width on meta: the params and the
    cache in bf16 (the ``ssm``-free cache all bf16), their bytes those of
    the reference's abstract inputs at its default; the bf16 products (the
    projections, the head) priced at 989 TFLOP/s, the float32 ones (the
    decode's attention over the cache, upcast as in the reference) at the
    fp32 rate."""
    arch, shape = "codeqwen1.5-7b", SHAPES["decode_32k"]
    cfg = get_arch(arch)
    topo = dryrun.topology_for(cfg, shape)
    _, (params, cache, _) = dryrun.build_step(cfg, shape, topo)
    jtopo = JM.Topology(num_stages=16, fsdp_size=1, num_micro=topo.num_micro)
    want_params = JM._abstract_params(jax_arch(arch), jtopo)
    want_cache, _ = JM.abstract_cache(jax_arch(arch), jtopo, JShape("d", shape.seq_len,
                                                                  shape.global_batch, "decode"))
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    assert nbytes(params) == _bytes(want_params)
    assert nbytes(cache) == _bytes(want_cache)
    assert {t.dtype for t in tree_leaves(cache)} == {torch.bfloat16}

    r = dryrun.run_one("codeqwen1.5-7b", "decode_32k", out_dir=None, verbose=False)
    by_dtype = r["flops"]["by_dtype"]
    assert r["dtype"] == "bfloat16" and set(by_dtype) == {"bfloat16", "float32"}
    assert sum(by_dtype.values()) == r["flops"]["aten"] and by_dtype["bfloat16"] > 0
    hw = tana.HW.of(CARD)
    assert hw.bf16_flops == 989e12
    want = by_dtype["bfloat16"] / hw.bf16_flops + by_dtype["float32"] / hw.fp32_flops
    assert r["roofline"]["compute_s"] == pytest.approx(want, rel=1e-12)
    fp32 = dryrun.run_one("codeqwen1.5-7b", "decode_32k", out_dir=None, verbose=False,
                          dtype=torch.float32)
    assert set(fp32["flops"]["by_dtype"]) == {"float32"}
    assert fp32["memory"]["entry_bytes"] > 1.9 * r["memory"]["entry_bytes"]
