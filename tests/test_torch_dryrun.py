"""The port's one-card dry run (``repro_torch.launch.dryrun``) and the parts
it reads, against the JAX package.

* ``roofline.counter.OpCounter`` against the reference's HLO walk
  (``repro.roofline.hlo_walk.analyze_hlo``): the walker's own test
  functions (a product, a loop of 10, 3 x 4 nested loops) count the same
  FLOPs exactly; and the smoke codeqwen1.5-7b steps (B 4, S 64, 2
  micro-batches, float32) against the walk of the reference's steps
  compiled on a 1x1 ``Auto`` mesh: the prefill's aten FLOPs equal the walk
  less the reference's padded blocked attention, the decode's equal it,
  and the train step's differ by one named residual (below).
* A meta run's aten part equals a CPU run's, op for op, for the prefill,
  decode and train steps of codeqwen1.5-7b, mamba2-130m and
  deepseek-v3-671b.
* ``abstract_params`` against ``init_params`` (smoke) and the reference's
  ``_abstract_params`` (every arch at full width); the long-context extras,
  cache plan and decode against the reference's ``seq_shard_decode``;
  ``topology_for``, ``roofline_report`` and the render against the
  reference's; the CLI; the kernels' meta route; and the kernel costs
  pinned to the bounds PERF.md §6 prints.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX side of the parity tests
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import SHAPES as JSHAPES
from repro.configs import ShapeConfig as JShape
from repro.configs import get_arch as jax_arch
from repro.models.transformer import model as JM
from repro.roofline import analysis as jana
from repro.roofline import render as jrender
from repro.roofline.hlo_walk import analyze_hlo
from repro_torch.configs import SHAPES, ShapeConfig, get_arch, list_archs
from repro_torch.kernels import host_values
from repro_torch.kernels.flash import kernel as FK
from repro_torch.kernels.flash.ref import flash_attention_ref
from repro_torch.kernels.gat_edge import kernel as GK
from repro_torch.kernels.ssd import kernel as SSK
from repro_torch.launch import dryrun
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.roofline import analysis as tana
from repro_torch.roofline import kernel_cost, render
from repro_torch.roofline.counter import OpCounter

ROOT = Path(__file__).resolve().parents[1]
B, S, MICRO = 4, 64, 2
CARD = "NVIDIA H100 80GB HBM3"


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


def count(fn, *args, resident=()):
    with OpCounter(resident) as c:
        fn(*args)
    return c


# ------------------------------------------------- the counter vs the walk --


def _walk(fn, *shapes):
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*specs).compile().as_text())["flops"]


def test_counter_counts_plain_product_as_the_walk():
    m, k, n = 64, 32, 16
    a, b = torch.zeros(m, k), torch.zeros(k, n)
    assert count(lambda: a @ b).aten_flops == _walk(lambda x, y: x @ y, (m, k), (k, n)) \
        == 2 * m * k * n


def test_counter_sees_every_loop_iteration():
    """The walk multiplies a ``while`` body by its trip count; the counter
    sees each iteration's product."""
    m = 32

    def jfn(a, w):
        out, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), a, None, length=10)
        return out

    def tfn(a, w):
        for _ in range(10):
            a = torch.tanh(a @ w)
        return a

    got = count(tfn, torch.zeros(m, m), torch.zeros(m, m)).aten_flops
    assert got == _walk(jfn, (m, m), (m, m)) == 10 * 2 * m ** 3


def test_counter_nested_loops():
    m = 16

    def jfn(a, w):
        def outer(c, _):
            c, _ = jax.lax.scan(lambda ci, _: (ci @ w, None), c, None, length=3)
            return c, None
        out, _ = jax.lax.scan(outer, a, None, length=4)
        return out

    def tfn(a, w):
        for _ in range(4):
            for _ in range(3):
                a = a @ w
        return a

    got = count(tfn, torch.zeros(m, m), torch.zeros(m, m)).aten_flops
    assert got == _walk(jfn, (m, m), (m, m)) == 12 * 2 * m ** 3


# ------------------------------------------- step FLOPs vs the reference --


def _reference_walk(arch, kind, seq):
    cfg = jax_arch(arch, smoke=True)
    make = {"prefill": JM.make_prefill_step, "decode": JM.make_serve_step,
            "train": JM.make_train_step}[kind]
    art = make(cfg, JM.Topology(num_stages=1, fsdp_size=1, num_micro=MICRO),
               JShape("x", seq, B, kind), mesh(), dtype=jnp.float32)
    return analyze_hlo(jax.jit(art.fn).lower(*art.abstract_inputs).compile().as_text())["flops"]


def _port_count(arch, kind, seq, device="cpu", early_stop=True):
    cfg = get_arch(arch, smoke=True)
    step, inputs = dryrun.build_step(cfg, ShapeConfig("x", seq, B, kind),
                                     TM.Topology(num_stages=1, num_micro=MICRO), device=device)
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        return count(step, *inputs, resident=inputs)


def _padded_attention_flops(cfg, seq, kv_block=512):
    """The reference's ``blocked_attention`` pads the keys to its KV block
    and computes every block: 2·B·H·Sq·Skv_pad·(hd + hd_v) a layer."""
    skv_pad = -(-seq // kv_block) * kv_block
    return cfg.num_layers * 2 * B * cfg.num_heads * seq * skv_pad * 2 * cfg.head_dim


def test_prefill_flops_equal_the_walk_less_padded_attention():
    cfg = get_arch("codeqwen1.5-7b", smoke=True)
    walk = _reference_walk("codeqwen1.5-7b", "prefill", S)
    c = _port_count("codeqwen1.5-7b", "prefill", S)
    assert c.aten_flops == walk - _padded_attention_flops(cfg, S) == 168_296_448
    assert dict(c.flops_by_op) == {"aten.mm": 168_296_448}
    assert c.kernel_calls == {"flash_attention_kernel": cfg.num_layers * MICRO}


def test_decode_flops_equal_the_walk():
    walk = _reference_walk("codeqwen1.5-7b", "decode", S + 16)
    c = _port_count("codeqwen1.5-7b", "decode", S + 16)
    assert c.aten_flops == walk == 3_538_944
    assert not c.kernel_calls


def test_train_flops_equal_the_walk_but_one_named_residual():
    """The reference's attention is counted 4 times a layer (forward,
    recompute, two backward products) at its padded width; the port's
    forward and recompute run the flash kernel and its backward the plain
    version's products (``aten.bmm``). Outside attention, the port does
    one product fewer per (stage, micro-batch): non-reentrant
    ``torch.utils.checkpoint`` stops its recompute early, once the last
    tensor the backward needs is rebuilt, so each checkpointed stage's last
    FFN down-projection, whose output no backward reads, is not recomputed:
    2·B_mb·S·d_ff·d per micro-batch, 2·B·S·d_ff·d in all (16,777,216 here,
    which equals B·S·d·V at this size, since d_ff = V / 2). Without the
    early stop the residual is 0."""
    cfg = get_arch("codeqwen1.5-7b", smoke=True)
    walk = _reference_walk("codeqwen1.5-7b", "train", S)
    outside = walk - 4 * _padded_attention_flops(cfg, S)
    residual = 2 * B * S * cfg.d_ff * cfg.d_model
    assert residual == 16_777_216 == B * S * cfg.d_model * cfg.vocab_size
    c = _port_count("codeqwen1.5-7b", "train", S)
    assert c.flops_by_op["aten.mm"] + residual == outside == 805_306_368
    assert c.kernel_calls == {"flash_attention_kernel": 2 * cfg.num_layers * MICRO}
    full = _port_count("codeqwen1.5-7b", "train", S, early_stop=False)
    assert full.flops_by_op["aten.mm"] == outside


# ------------------------------------------------------- meta against CPU --


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "mamba2-130m", "deepseek-v3-671b"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_meta_counts_equal_cpu_counts(arch, kind):
    seq = S + 16 if kind == "decode" else S
    cpu, meta = (_port_count(arch, kind, seq, device=d) for d in ("cpu", "meta"))
    assert dict(meta.flops_by_op) == dict(cpu.flops_by_op)
    assert dict(meta.bytes_by_op) == dict(cpu.bytes_by_op)
    assert meta.kernel_calls == cpu.kernel_calls
    assert meta.kernel_ops == cpu.kernel_ops and meta.kernel_bytes == cpu.kernel_bytes
    assert meta.entry_bytes == cpu.entry_bytes
    assert meta.collective_totals()["total"] == 0


def test_meta_counts_mrope_pairs_from_the_attached_positions():
    """m-rope masks flash by the t-row, whose values a meta tensor lacks:
    ``make_positions`` attaches them, so the meta count of pairs equals the
    CPU's (which reads the tensor)."""
    cpu, meta = (_port_count("qwen2-vl-2b", "prefill", S, device=d) for d in ("cpu", "meta"))
    assert meta.kernel_ops == cpu.kernel_ops and meta.aten_flops == cpu.aten_flops
    cfg = get_arch("qwen2-vl-2b", smoke=True)
    pos = TM.make_positions(cfg, S, device="meta")
    np.testing.assert_array_equal(host_values(pos[0]), TM.make_positions(cfg, S)[0].numpy())


def test_peak_counts_live_storages():
    """Entry bytes, a temporary, its release: the peak is the high-water mark."""
    a = torch.empty(1024, device="meta")
    with OpCounter([a]) as c:
        b = a * 2  # 4 KiB more
        del b
        d = a + 1
    assert c.entry_bytes == 4096 and c.peak_bytes == 8192 and c.live_bytes == 8192
    del d


# --------------------------------------------------------- abstract params --


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_match_init_and_the_reference(arch):
    cfg = get_arch(arch, smoke=True)
    meta = TM.abstract_params(cfg, 2)
    assert all(v.is_meta for v in _leaves(meta))
    assert _shapes(meta) == _shapes(TM.init_params(cfg, num_stages=2))
    full = TM.abstract_params(get_arch(arch), 16)
    ref = JM._abstract_params(jax_arch(arch), JM.Topology(num_stages=16), jnp.float32)
    ref = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)), ref)
    assert _shapes(full) == _flat(ref)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


# ------------------------------------------------------------ long context --


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("arch", list_archs())
def test_long_context_extras_and_cache_plan_equal_the_reference(arch):
    shape = SHAPES["long_500k"]
    ttopo = dryrun.topology_for(get_arch(arch), shape)
    jtopo = JM.Topology(num_stages=16, fsdp_size=1, num_micro=1,
                        seq_shard_decode=ttopo.long_context)
    assert ttopo.long_context == (get_arch(arch).arch_type != "ssm")
    got = TM.make_extras(get_arch(arch), 16, long_context=True)
    want = _np(JM.make_extras(jax_arch(arch), 16, long_context=True))
    for (k, a), (_, b) in zip(sorted(_flat(got).items()), sorted(_flat(want).items())):
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert TM.cache_plan(get_arch(arch), ttopo, shape) == \
        JM.cache_plan(jax_arch(arch), jtopo, JSHAPES["long_500k"])


def test_long_context_decode_past_the_window_matches_seq_shard_decode():
    """Smoke codeqwen1.5-7b with ``long_context_window`` 16, batch 1: 24
    decode steps from an empty ring (it wraps after 16), the same tokens fed
    to both. The reference's serve step (``seq_shard_decode=True``,
    ``fsdp_size=1``, 1x1 ``Auto`` mesh) returns its greedy token and cache,
    not its logits: each step's token equal, each layer's ring within 1e-5
    after every step, and the same slots written. The ring's values are not
    held bit for bit: the two packages' float32 K/V projections round
    differently (224 of the 256 values written at position 0 differ, by at
    most 1.5e-7)."""
    arch, window, steps = "codeqwen1.5-7b", 16, 24
    jcfg = dataclasses.replace(jax_arch(arch, smoke=True), long_context_window=window)
    tcfg = dataclasses.replace(get_arch(arch, smoke=True), long_context_window=window)
    jshape, tshape = JShape("d", 4096, 1, "decode"), ShapeConfig("d", 4096, 1, "decode")
    jtopo = JM.Topology(num_stages=1, fsdp_size=1, num_micro=1, seq_shard_decode=True)
    ttopo = TM.Topology(num_stages=1, num_micro=1, long_context=True)
    assert TM.cache_plan(tcfg, ttopo, tshape)["w_local"] == window
    art = JM.make_serve_step(jcfg, jtopo, jshape, mesh(), dtype=jnp.float32)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), num_stages=1, dtype=jnp.float32)
    jcache = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), art.abstract_inputs[1])
    params = params_from_jax(_np(jparams))
    cache = TM.init_cache(tcfg, ttopo, tshape)
    step, jstep = TM.make_serve_step(tcfg, ttopo, tshape), jax.jit(art.fn)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, steps).astype(np.int32)
    for pos in range(steps):
        tok, cache, _ = step(params, cache, {"tokens": torch.tensor(toks[pos:pos + 1]),
                                             "pos": pos})
        jtok, jcache = jstep(jparams, jcache, {"tokens": jnp.asarray(toks[pos:pos + 1]),
                                               "pos": jnp.asarray(pos, jnp.int32)})
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        for name in ("k", "v"):
            got, want = cache[name].numpy(), np.asarray(jcache[name])
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(got != 0, want != 0)
    assert cache["k"].shape[4] == window


# ---------------------------------------------------- topology and report --


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module. It sets ``XLA_FLAGS`` to 512 host
    devices at import; the backend is started first (so the flag has no
    effect here) and the variable restored after."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


@pytest.mark.parametrize("arch", list_archs())
def test_topology_for_matches_the_reference(arch, jdryrun):
    for name, shape in SHAPES.items():
        got = dryrun.topology_for(get_arch(arch), shape)
        want = jdryrun.topology_for(jax_arch(arch), JSHAPES[name], multi_pod=False)
        assert (got.num_stages, got.remat, got.loss_chunks, got.kv_block, got.long_context) == \
            (want.num_stages, want.remat, want.loss_chunks, want.kv_block, want.seq_shard_decode)
        # one card has no data axis: min(target, batch), not min(target, batch / 16)
        if name == "prefill_32k":
            assert (got.num_micro, want.num_micro) == (4, 2)
        else:
            assert got.num_micro == want.num_micro


def test_multi_card_flags_raise():
    for flags in (["--multi-pod"], ["--moe-mode", "a2a"], ["--no-zero3"]):
        with pytest.raises(NotImplementedError, match="item 9"):
            dryrun.main(["--arch", "codeqwen1.5-7b", "--shape", "decode_32k", *flags])


def _reference_hw(hw):
    """The reference's ``HW`` holding the port card's rates: its peak at the
    fp32 rate, one link at the NVLink rate."""
    return jana.HW(peak_flops=hw.fp32_flops, hbm_bw=hw.hbm_bw, ici_bw=hw.nvlink_bw, ici_links=1)


def _report(**kw):
    hw = tana.HW.of(CARD)
    coll = tana.collective_bytes({"all-reduce": 3 * 2**30, "all-gather": 2**28})
    args = dict(device_bytes=7.5e12, device_collective=coll, chips=1, model_flops_global=2e15,
                **kw)
    return (tana.roofline_report(aten_flops=1.34e15, kernel_ops={}, hw=hw, **args),
            jana.roofline_report(device_flops=1.34e15, hw=_reference_hw(hw), **args))


def test_roofline_report_and_render_equal_the_reference():
    got, want = _report()
    assert got.keys() == want.keys()
    assert got.pop("collective_breakdown") == want.pop("collective_breakdown") == \
        {"all-reduce": 3 * 2**30, "all-gather": 2**28}
    assert got == pytest.approx(want, rel=1e-12)
    rows = [{"arch": "a", "shape": "s", "mesh": "1 card", "roofline": got}]
    assert render.roofline_table(rows) == jrender.roofline_table(rows, mesh="1 card")
    # a kernel's operations count at the TF32 rate, three products each
    hw = tana.HW.of(CARD)
    with_kernel = tana.roofline_report(aten_flops=0, kernel_ops={"flash": 1e12},
                                       device_bytes=0, device_collective=tana.collective_bytes({}),
                                       chips=1, model_flops_global=1.0, hw=hw)
    assert with_kernel["compute_s"] == pytest.approx(3e12 / hw.tf32_flops)


def test_dryrun_cli_writes_its_report(tmp_path):
    """Full width on meta, no card: codeqwen1.5-7b × decode_32k."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "codeqwen1.5-7b", "--shape", "decode_32k", "--out", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    (path,) = tmp_path.glob("*.json")
    r = json.loads(path.read_text())
    cfg = get_arch("codeqwen1.5-7b")
    # the ring: 32 layers x 128 rows x (32768 + 16) slots x 32 kv heads x 128 x (k, v), fp32
    ring = 32 * 128 * (32768 + 16) * cfg.num_kv_heads * cfg.head_dim * 2 * 4
    assert r["memory"]["entry_bytes"] >= ring and not r["memory"]["fits"]
    assert r["memory"]["card_gib"] == 80.0
    assert r["roofline"]["dominant"] == "memory_s" and r["flops"]["aten"] > 0
    assert r["kernel_calls"] == {} and r["collective_bytes"]["total"] == 0
    assert r["roofline"]["model_flops_global"] == tana.model_flops(cfg, SHAPES["decode_32k"],
                                                                   training=False)
    table = render.dryrun_table([r])
    assert "codeqwen1.5-7b | decode_32k | 4 |" in table and "| no |" in table


# ------------------------------------------------------------- meta route --


def test_meta_route_is_taken_for_meta_tensors_only():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 4, 16)).astype(np.float32))
               for _ in range(3))
    before = FK.flash_attention_kernel.launches
    out = FK.flash_attention_kernel(*(t.to("meta") for t in (q, k, v)), window=8)
    assert out.is_meta and out.shape == (2, 40, 4, 16)
    cpu = FK.flash_attention_kernel(q, k, v, window=8)
    torch.testing.assert_close(cpu, flash_attention_ref(q, k, v, window=8), rtol=0, atol=0)
    x = torch.zeros((1, 200, 3, 8), device="meta")
    y, state = SSK.ssd_kernel(x, *(torch.zeros((1, 200, 3), device="meta"),) * 2,
                              *(torch.zeros((1, 200, 5), device="meta"),) * 2, chunk=64)
    assert y.is_meta and y.shape == x.shape and state.shape == (1, 3, 8, 5)
    assert FK.flash_attention_kernel.launches == before
    with pytest.raises(ValueError, match="meta"):  # the GNN kernels have no meta route
        GK.gat_aggregate_kernel(*(torch.zeros(s, device="meta") for s in ((5, 2, 3), (5, 2),
                                                                           (5, 2))),
                                torch.zeros((5, 4), dtype=torch.int32, device="meta"),
                                torch.zeros((5, 4), dtype=torch.bool, device="meta"))


def test_counter_attributes_kernel_calls_on_every_route():
    q = torch.zeros((2, 40, 4, 16))
    for dev in ("cpu", "meta"):
        qq = q.to(dev)
        with OpCounter() as c:
            FK.flash_attention_kernel(qq, qq, qq)
        assert c.kernel_calls == {"flash_attention_kernel": 1} and c.aten_flops == 0
        assert c.kernel_ops["flash_attention_kernel"] == \
            kernel_cost.flash_cost(2, 40, 40, 4, 4, 16, 16, 4)[0]


# ------------------------------------------------------------- kernel costs --


@pytest.mark.parametrize("label, cost, bound_ms", [
    ("codeqwen flash 4 x 512, 32/32, hd 128",
     kernel_cost.flash_cost(4, 512, 512, 32, 32, 128, 128, 4), "0.052569"),
    ("deepseek MLA 4 x 512, 128/128, 192/128",
     kernel_cost.flash_cost(4, 512, 512, 128, 128, 192, 128, 4), "0.262440"),
    ("mamba2 SSD 4 x 512, 24 heads, P 64, N 128",
     kernel_cost.ssd_cost(4, 512, 24, 64, 128, 128), "0.017139"),
    ("zamba2 SSD 4 x 512, 112 heads, P 64, N 64",
     kernel_cost.ssd_cost(4, 512, 112, 64, 64, 128), "0.045731"),
])
def test_kernel_costs_give_the_printed_bounds(label, cost, bound_ms):
    """PERF.md §6's bounds at the main-path shapes, to the printed digits."""
    assert f"{max(kernel_cost.bound(*cost, tana.HW.of(CARD))) * 1e3:.6f}" == bound_ms, label


def test_flash_pairs_closed_form_equals_the_row_loop():
    def loop(sq, skv, window):
        total = 0
        for i in range(sq):
            lo = max(0, i - window + 1) if window > 0 else 0
            total += max(0, min(i, skv - 1) - lo + 1)
        return total

    for sq in (0, 1, 7, 64, 65, 130):
        for skv in (1, 7, 64, 100):
            for window in (0, 1, 5, 64, 200):
                assert kernel_cost.flash_pairs(sq, skv, window) == loop(sq, skv, window)
    pos = np.array([0, 0, 0, 1, 2, 3], np.int32)
    assert kernel_cost.flash_pairs(6, 6, 0, pos, pos) == 3 * 3 + 4 + 5 + 6
