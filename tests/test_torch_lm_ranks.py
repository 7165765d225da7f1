"""The port's LM stage ring across ranks, on the CPU over gloo.

The reference runs its LM steps as one program over a ``("data", "model")``
mesh: ``spmd_pipeline`` and ``spmd_pipeline_interleaved``
(``repro/core/spmd_pipe.py:88,194``) behind ``make_train_step``,
``make_prefill_step`` and ``make_serve_step``. The port runs one stage ring
position per rank (``Topology.ring``). One spawn per world size (4 ranks,
then 2) runs every case of that world and returns the results to this
process, which holds them bit for bit against the port's one-process step
at the same ``Topology``: losses, updated params and Adam's moments after
training (every arch family: mamba2, dense GQA, gemma2's windows and
softcap, deepseek's MoE, MLA and multi-token-prediction head, qwen2-vl's
frontend rows and m-rope, the zamba2 hybrid's shared block; a padding
slot; remat off; interleaved with 2 virtual stages a rank), and the
prefill logits, the decode logits and tokens and every cache row after a
prefill and 4 decode steps; on 2 ranks also codeqwen's training (fill_drain
and interleaved, 2 virtual stages a rank) and zamba2's serving at bf16
params (the reference's dtype: bf16 hops, float32 loss and
moments). The 2-rank ring also starts from the JAX
package's params and matches the reference's own 2-device steps, run in a
subprocess on a 1x2 ``Auto`` mesh of forced host devices: gemma2-27b's
train step (step-1 loss within 1e-5 relative, Adam's moments within 1e-5
of each leaf's largest entry, three losses within 1e-4) and codeqwen's
prefill with greedy decode (tokens equal). Every rank and the one-process
side run with one torch thread and deterministic algorithms; each world
joins with a timeout, so a hang fails instead of stalling the suite. The
two LM launchers run once each under ``torchrun`` on 2 ranks, and the
training launcher with ``--stages 2`` on the 4 ranks, 2 data replicas of
the ring (``tests/test_torch_lm_data.py`` holds the data axis itself).
"""

import ast
import dataclasses
import datetime
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.core import ranks
from repro_torch.core.overlap_report import capture_rank_reports
from repro_torch.core.spmd_pipe import StageRing
from repro_torch.data.tokens import token_batch
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.launch.train import lm_batch
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.train.optimizer import tree_leaves, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD_TIMEOUT_S = 150.0  # a world's spawn, all its cases included
GROUP_TIMEOUT_S = 60.0
SEQ, BATCH, MICRO, LOSS_CHUNKS, LR, STEPS = 32, 4, 2, 4, 3e-4, 2
PROMPT, DECODE = 32, 4
JAX_STEPS = 3
LOSS_RTOL, MOMENT_TOL, LOSSES_ATOL = 1e-5, 1e-5, 1e-4  # tests/test_torch_lm_train.py's
TRAIN_ARCHS = ["mamba2-130m", "codeqwen1.5-7b", "gemma2-27b", "deepseek-v3-671b", "qwen2-vl-2b",
               "zamba2-7b"]
SERVE_ARCHS = ["codeqwen1.5-7b", "mamba2-130m", "zamba2-7b", "deepseek-v3-671b"]
INTERLEAVED_ARCHS = ["codeqwen1.5-7b", "mamba2-130m"]
CLI_SERVE = ["-m", "repro_torch.launch.serve", "--arch", "codeqwen1.5-7b", "--stages", "2",
             "--prompt-len", "32", "--decode-steps", "7", "--batch", "4", "--device", "cpu"]
CLI_TRAIN = ["-m", "repro_torch.launch.train", "--mode", "lm", "--arch", "gemma2-27b",
             "--stages", "2", "--chunks", "2", "--steps", "3", "--seq", "32", "--batch", "4",
             "--log-every", "0", "--device", "cpu"]


def config(arch, layers=None):
    """The smoke config with enough layers that each of 4 ranks holds a
    slot (zamba2: a mamba slot and the shared block's slot each)."""
    cfg = get_arch(arch, smoke=True)
    if layers is None:
        layers = 8 if cfg.arch_type == "hybrid" else 4
    return dataclasses.replace(cfg, num_layers=layers)


def topology(stages, ring=None, schedule="fill_drain", num_virtual=1, remat=True):
    return TM.Topology(num_stages=stages, num_micro=MICRO, loss_chunks=LOSS_CHUNKS,
                       schedule=schedule, num_virtual=num_virtual, remat=remat, ring=ring)


def own_params(cfg, topo, seed=0, dtype=torch.float32):
    """This process's params: every stage in one process, a ring
    position's own rows (drawn from (seed, stage) alone) on a rank."""
    stages = None if topo.ring is None else TM.held_stages(topo, topo.ring.position)
    return TM.init_params(cfg, seed=seed, num_stages=topo.num_stages, stages=stages, dtype=dtype)


def train(cfg, topo, params=None, steps=STEPS, dtype=torch.float32):
    """``steps`` train steps from params in ``dtype``: losses, params and
    Adam's moments after them, and the moments after step 1."""
    step = TM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), lr=LR)
    params = own_params(cfg, topo, dtype=dtype) if params is None else params
    opt = step.optimizer.init(params)
    losses, first = [], None
    for i in range(steps):
        batch = lm_batch(cfg, Namespace(seq=SEQ, batch=BATCH, seed=0), i, "cpu")
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].clone())
        if i == 0:
            first = (tree_map(torch.clone, opt.mu), tree_map(torch.clone, opt.nu))
    return {"losses": losses, "params": params, "mu": opt.mu, "nu": opt.nu, "first": first}


def serve(cfg, topo, params=None, dtype=torch.float32):
    """A prefill of ``PROMPT`` tokens, its cache spliced into the decode
    cache, then ``DECODE`` greedy steps (params and caches in ``dtype``):
    every logit, token and cache."""
    params = own_params(cfg, topo, dtype=dtype) if params is None else params
    prompt = torch.from_numpy(token_batch(batch=BATCH, seq=PROMPT, vocab=cfg.vocab_size,
                                          seed=0)[:, :PROMPT].astype(np.int64))
    pshape = ShapeConfig("p", PROMPT, BATCH, "prefill")
    dshape = ShapeConfig("d", PROMPT + DECODE + 16, BATCH, "decode")
    prefill = TM.make_prefill_step(cfg, topo, pshape)
    step = TM.make_serve_step(cfg, topo, dshape)
    with torch.inference_mode():
        logits, pcache = prefill(params, TM.init_cache(cfg, topo, pshape, dtype=dtype),
                                 {"tokens": prompt})
        dcache = tserve.splice(TM.init_cache(cfg, topo, dshape, dtype=dtype), pcache)
        tok = logits.argmax(-1).to(torch.int32)
        all_logits, tokens = [logits], [tok]
        for i in range(DECODE):
            tok, dcache, logits = step(params, dcache, {"tokens": tok, "pos": PROMPT + i})
            all_logits.append(logits)
            tokens.append(tok)
    return {"logits": torch.stack(all_logits), "tokens": torch.stack(tokens, 1),
            "pcache": pcache, "dcache": dcache}


def decode_long(cfg, topo, steps=20):
    """``steps`` greedy decode steps from a zero cache, every layer on its
    long-context window (``Topology.long_context``): the cache's ring wraps
    after the window. Every step's logits and the last cache."""
    params = own_params(cfg, topo)
    shape = ShapeConfig("d", steps, BATCH, "decode")
    step = TM.make_serve_step(cfg, topo, shape)
    cache = TM.init_cache(cfg, topo, shape)
    tok = torch.zeros(BATCH, dtype=torch.int32)
    logits = []
    with torch.inference_mode():
        for i in range(steps):
            tok, cache, out = step(params, cache, {"tokens": tok, "pos": i})
            logits.append(out)
    return {"logits": torch.stack(logits), "cache": cache}


def long_context(ring=None):
    """gemma2-27b's smoke config with a 16-slot long-context window, and its
    long-context decode topology on 4 stages."""
    cfg = dataclasses.replace(config("gemma2-27b"), long_context_window=16)
    return cfg, TM.Topology(num_stages=4, num_micro=MICRO, long_context=True, ring=ring)


def refusal(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as err:
        return type(err).__name__, str(err)
    return None


# --------------------------------------------------------------- the worlds --


def _world_cases(world: int, jax_in):
    grid = ranks.RankGrid(1, world)
    out = {}
    if world == 4:
        for arch in TRAIN_ARCHS:
            out[f"train {arch}"] = train(config(arch), topology(4, grid))
        out["train padding"] = train(config("codeqwen1.5-7b", 7), topology(4, grid))
        out["train remat off"] = train(config("gemma2-27b"), topology(4, grid, remat=False))
        for arch in SERVE_ARCHS:
            out[f"serve {arch}"] = serve(config(arch), topology(4, grid))
        out["decode long"] = decode_long(*long_context(grid))
        base = ["--mode", "lm", "--device", "cpu", "--steps", "1", "--seq", "16",
                "--batch", "4", "--log-every", "0"]
        out["data axis"] = tlaunch.main([*base, "--stages", "2"])
        out["refuse world"] = refusal(lambda: tserve.main(
            ["--device", "cpu", "--stages", "3", "--prompt-len", "16", "--batch", "4"]))
        out["refuse micro"] = refusal(lambda: TM.make_train_step(
            config("codeqwen1.5-7b"), topology(8, grid, "interleaved", 2),
            ShapeConfig("t", SEQ, BATCH, "train")))
        return out
    for arch in INTERLEAVED_ARCHS:
        out[f"interleaved {arch}"] = train(config(arch), topology(4, grid, "interleaved", 2))
    out["bf16 train"] = train(config("codeqwen1.5-7b"), topology(2, grid), dtype=torch.bfloat16)
    out["bf16 serve"] = serve(config("zamba2-7b"), topology(2, grid), dtype=torch.bfloat16)
    out["bf16 interleaved"] = train(config("codeqwen1.5-7b"), topology(4, grid, "interleaved", 2),
                                    dtype=torch.bfloat16)
    jtrain, jserve = jax_in
    topo = topology(2, grid)
    if jtrain is not None:
        shard = lambda tree: TM.position_shard(params_from_jax(tree), topo, grid.position)
        out["jax train"] = train(get_arch("gemma2-27b", smoke=True), topo,
                                 shard(jtrain["params"]), JAX_STEPS)
        prompt = torch.from_numpy(jserve["prompt"].astype(np.int64))
        out["jax serve"] = tserve.generate(get_arch("codeqwen1.5-7b", smoke=True), topo,
                                           shard(jserve["params"]), prompt, DECODE).tokens
    cfg = get_arch("codeqwen1.5-7b", smoke=True)
    step = TM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), lr=LR)
    params = own_params(cfg, topo)
    opt = step.optimizer.init(params)
    batch = lm_batch(cfg, Namespace(seq=SEQ, batch=BATCH, seed=0), 0, "cpu")
    with tempfile.TemporaryDirectory() as trace_dir:
        out["reports"] = capture_rank_reports(lambda: step(params, opt, batch),
                                              trace_dir=trace_dir)
    return out


def _rank_main(rank: int, world: int, port: int, out_dir: str, jax_in):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        results = _world_cases(world, jax_in)
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_world(world: int, out_dir: str, jax_in=None):
    return mp.start_processes(_rank_main, args=(world, _free_port(), out_dir, jax_in),
                              nprocs=world, join=False, start_method="spawn")


def finish_world(ctx, world: int, out_dir: str, deadline: float) -> list:
    """Join a spawned world by ``deadline`` (a hang fails, and no rank
    outlives the call); each rank's results."""
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise AssertionError(f"the {world}-rank world ran past its deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# The reference's 2-device steps, in a process of their own: the forced host
# device count must be set before JAX starts.
JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import ShapeConfig, get_arch
from repro.data.tokens import token_batch
from repro.models.transformer import model as JM
SEQ, BATCH, MICRO, LOSS_CHUNKS, LR, STEPS, PROMPT, DECODE = {consts}
JIT = {{"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}}
mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
cfg = get_arch("gemma2-27b", smoke=True)
topo = JM.Topology(num_stages=2, fsdp_size=1, num_micro=MICRO, loss_chunks=LOSS_CHUNKS)
art = JM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), mesh, lr=LR,
                         dtype=jnp.float32)
params = JM.init_params(cfg, jax.random.PRNGKey(0), num_stages=2, dtype=jnp.float32)
train = {{"params": tree(params), "losses": []}}
opt = art.meta["optimizer"].init(params)
batches = [{{"tokens": jnp.asarray(token_batch(batch=BATCH, seq=SEQ, vocab=cfg.vocab_size,
                                              seed=0, step=i))}} for i in range(STEPS)]
step = jax.jit(art.fn).lower(params, opt, batches[0]).compile(compiler_options=JIT)
for i in range(STEPS):
    params, opt, m = step(params, opt, batches[i])
    train["losses"].append(float(m["loss"]))
    if i == 0:
        train["mu"], train["nu"] = tree(opt.mu), tree(opt.nu)
cfg = get_arch("codeqwen1.5-7b", smoke=True)
topo = JM.Topology(num_stages=2, fsdp_size=1, num_micro=MICRO)
part = JM.make_prefill_step(cfg, topo, ShapeConfig("p", PROMPT, BATCH, "prefill"), mesh,
                            dtype=jnp.float32)
sart = JM.make_serve_step(cfg, topo, ShapeConfig("d", PROMPT + DECODE + 16, BATCH, "decode"),
                          mesh, dtype=jnp.float32)
params = JM.init_params(cfg, jax.random.PRNGKey(0), num_stages=2, dtype=jnp.float32)
prompt = token_batch(batch=BATCH, seq=PROMPT + 1, vocab=cfg.vocab_size, seed=0)[:, :PROMPT]
zeros = lambda art: jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                           art.abstract_inputs[1])
logits, pcache = jax.jit(part.fn)(params, zeros(part), {{"tokens": jnp.asarray(prompt)}})
dcache = jax.tree_util.tree_map(
    lambda d, s: d.at[:, :, :, :, :s.shape[4]].set(s) if d.ndim >= 5 else s, zeros(sart), pcache)
serve_step = jax.jit(sart.fn)
tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
tokens = [np.asarray(tok)]
for i in range(DECODE):
    tok, dcache = serve_step(params, dcache, {{"tokens": tok, "pos": jnp.asarray(PROMPT + i)}})
    tokens.append(np.asarray(tok))
serve = {{"params": tree(params), "prompt": prompt, "tokens": np.stack(tokens, axis=1)}}
with open(sys.argv[1], "wb") as f:
    pickle.dump((train, serve), f)
"""


def _start_jax(path: str, env: dict):
    """The reference's steps in a subprocess; None without JAX."""
    try:
        import jax  # noqa: F401
    except ImportError:
        return None
    consts = (SEQ, BATCH, MICRO, LOSS_CHUNKS, LR, JAX_STEPS, PROMPT, DECODE)
    return subprocess.Popen([sys.executable, "-c", JAX_SCRIPT.format(consts=consts), path],
                            env={**env, "JAX_PLATFORMS": "cpu"}, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


class _OneThread:
    """One intra-op thread and deterministic algorithms, as every rank runs."""

    def __enter__(self):
        self.threads = torch.get_num_threads()
        torch.set_num_threads(1)
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        torch.set_num_threads(self.threads)


@pytest.fixture(scope="module")
def worlds():
    """The launchers under torchrun and the JAX subprocess (started first,
    beside the spawns), the 4- and 2-rank worlds, and the one-process
    results they are held against."""
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
    cli = {name: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, argv in (("serve", CLI_SERVE), ("train", CLI_TRAIN))}
    tmp = tempfile.TemporaryDirectory()
    jax_path = os.path.join(tmp.name, "jax.pkl")
    jax_proc = _start_jax(jax_path, env)
    procs = [*cli.values(), *([jax_proc] if jax_proc else [])]
    try:
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        four_dir, two_dir = (os.path.join(tmp.name, n) for n in ("four", "two"))
        os.makedirs(four_dir)
        os.makedirs(two_dir)
        four = start_world(4, four_dir)
        alone = {}
        with _OneThread():
            for arch in TRAIN_ARCHS:
                alone[f"train {arch}"] = train(config(arch), topology(4))
            alone["train padding"] = train(config("codeqwen1.5-7b", 7), topology(4))
            alone["train remat off"] = train(config("gemma2-27b"), topology(4, remat=False))
            alone["train remat on"] = train(config("gemma2-27b"), topology(4))
            for arch in SERVE_ARCHS:
                alone[f"serve {arch}"] = serve(config(arch), topology(4))
            alone["decode long"] = decode_long(*long_context())
            for arch in INTERLEAVED_ARCHS:
                alone[f"interleaved {arch}"] = train(config(arch),
                                                     topology(4, None, "interleaved", 2))
            alone["bf16 train"] = train(config("codeqwen1.5-7b"), topology(2),
                                        dtype=torch.bfloat16)
            alone["bf16 serve"] = serve(config("zamba2-7b"), topology(2), dtype=torch.bfloat16)
            alone["bf16 interleaved"] = train(config("codeqwen1.5-7b"),
                                              topology(4, None, "interleaved", 2),
                                              dtype=torch.bfloat16)
        jax_out = None
        if jax_proc is not None:
            log, _ = jax_proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert jax_proc.returncode == 0, log
            with open(jax_path, "rb") as f:
                jax_out = pickle.load(f)
        two = start_world(2, two_dir, jax_out or (None, None))
        results = {"four": finish_world(four, 4, four_dir, deadline),
                   "two": finish_world(two, 2, two_dir, deadline)}
        with _OneThread():  # the launchers' runs in one process, at the same topology
            alone["cli serve"] = tserve.serve(tserve.build_parser().parse_args(CLI_SERVE[2:]))
            alone["cli train"] = tlaunch.train_lm(get_arch("gemma2-27b", smoke=True),
                                                  tlaunch.build_parser().parse_args(CLI_TRAIN[2:]))
        outputs = {}
        for name, proc in cli.items():
            out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outputs[name] = (proc.returncode, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.cleanup()
    return {**results, "alone": alone, "cli": outputs, "jax": jax_out}


# --------------------------------------------------------------- the tests --


def rows_of(tree, topo, position):
    """A one-process tree's rows of ``position`` (params, moments, caches)."""
    stages = TM.held_stages(topo, position)
    return tree_map(lambda a: a[stages], tree) if "blocks" not in tree \
        else TM.position_shard(tree, topo, position)


def trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def assert_train_equal(got, want, topo, position, case):
    assert all(torch.equal(a, b) for a, b in zip(got["losses"], want["losses"])), case
    for name in ("params", "mu", "nu"):
        assert trees_equal(got[name], TM.position_shard(want[name], topo, position)), (case, name)


@pytest.mark.parametrize("case", [f"train {a}" for a in TRAIN_ARCHS]
                         + ["train padding", "train remat off"])
def test_ring_training_bit_identical(worlds, case):
    """4 ranks under fill_drain, 2 steps: every rank's losses, updated rows
    and replicated leaves, and Adam's moments equal the one-process step's
    at the same Topology bit for bit (zamba2's shared block too: both sides
    sum its per-stage gradients in ascending stage order)."""
    topo = topology(4)
    for rank, results in enumerate(worlds["four"]):
        assert_train_equal(results[case], worlds["alone"][case], topo, rank, (case, rank))


def test_ring_remat_on_equals_off(worlds):
    on, off = worlds["alone"]["train remat on"], worlds["four"][0]["train remat off"]
    assert all(torch.equal(a, b) for a, b in zip(on["losses"], off["losses"]))
    assert trees_equal(TM.position_shard(on["params"], topology(4), 0), off["params"])


def test_ring_padding_slot_stays_zero(worlds):
    """7 layers on 4 stages of 2 slots: the last rank's second slot is
    padding, its moments exact zeros."""
    mu = worlds["four"][3]["train padding"]["mu"]["blocks"]
    assert all(not a[0, 1].any() for a in tree_leaves(mu))
    assert any(a[0, 0].any() for a in tree_leaves(mu))


@pytest.mark.parametrize("arch", INTERLEAVED_ARCHS)
def test_ring_interleaved_bit_identical(worlds, arch):
    """2 ranks, 2 virtual stages each (stages {v·2 + d}): bit for bit the
    one-process interleaved step's."""
    topo = topology(4, None, "interleaved", 2)
    for rank, results in enumerate(worlds["two"]):
        assert_train_equal(results[f"interleaved {arch}"], worlds["alone"][f"interleaved {arch}"],
                           topo, rank, (arch, rank))


def test_ring_bf16_bit_identical(worlds):
    """At bf16 params on 2 ranks (bf16 hops, float32 loss and moments):
    codeqwen's 2 train steps (losses, params, moments) and zamba2's prefill
    and decode (logits, tokens, every cache row: bf16 k/v and conv, float32
    ssm state) equal one process's bit for bit."""
    topo = topology(2)
    for rank, results in enumerate(worlds["two"]):
        got, want = results["bf16 train"], worlds["alone"]["bf16 train"]
        assert all(p.dtype == torch.bfloat16 for p in tree_leaves(got["params"]))
        assert all(m.dtype == torch.float32 for m in tree_leaves(got["mu"]))
        assert_train_equal(got, want, topo, rank, ("bf16", rank))
        got, want = results["bf16 serve"], worlds["alone"]["bf16 serve"]
        assert torch.equal(got["logits"], want["logits"]), rank
        assert torch.equal(got["tokens"], want["tokens"]), rank
        for name in ("pcache", "dcache"):
            assert trees_equal(got[name], rows_of(want[name], topo, rank)), (rank, name)


def test_ring_bf16_interleaved_bit_identical(worlds):
    """codeqwen at bf16 params on 2 ranks of 2 virtual stages each (the
    interleaved ring's bf16 hops): 2 train steps' losses, each rank's rows
    of the params (bf16) and of Adam's moments (float32) equal the
    one-process interleaved step's bit for bit."""
    topo = topology(4, None, "interleaved", 2)
    want = worlds["alone"]["bf16 interleaved"]
    for rank, results in enumerate(worlds["two"]):
        got = results["bf16 interleaved"]
        assert all(p.dtype == torch.bfloat16 for p in tree_leaves(got["params"]))
        assert all(m.dtype == torch.float32 for m in tree_leaves(got["mu"]))
        assert_train_equal(got, want, topo, rank, ("bf16 interleaved", rank))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_ring_serving_bit_identical(worlds, arch):
    """A prefill and 4 decode steps on 4 ranks: every rank's prefill and
    decode logits and tokens, and its rows of the prefill and decode caches
    (attention k/v, mamba ssm/conv, MLA's ckv), equal one process's."""
    want, topo = worlds["alone"][f"serve {arch}"], topology(4)
    for rank, results in enumerate(worlds["four"]):
        got = results[f"serve {arch}"]
        assert torch.equal(got["logits"], want["logits"]), rank
        assert torch.equal(got["tokens"], want["tokens"]), rank
        for name in ("pcache", "dcache"):
            assert trees_equal(got[name], rows_of(want[name], topo, rank)), (rank, name)


def test_ring_long_context_decode_bit_identical(worlds):
    """20 decode steps over a 16-slot long-context ring on 4 ranks: every
    step's logits and each rank's cache rows equal one process's."""
    want, topo = worlds["alone"]["decode long"], long_context()[1]
    for rank, results in enumerate(worlds["four"]):
        got = results["decode long"]
        assert torch.equal(got["logits"], want["logits"]), rank
        assert trees_equal(got["cache"], rows_of(want["cache"], topo, rank)), rank


def test_ring_matches_jax_two_device_train(worlds):
    """gemma2-27b on 2 ranks from the JAX params: the reference's 2-device
    train step's loss, moments and three losses."""
    if worlds["jax"] is None:
        pytest.skip("JAX is not installed")
    want = worlds["jax"][0]
    topo = topology(2)
    for rank, results in enumerate(worlds["two"]):
        got = results["jax train"]
        losses = [float(x) for x in got["losses"]]
        assert abs(losses[0] - want["losses"][0]) <= LOSS_RTOL * abs(want["losses"][0])
        np.testing.assert_allclose(losses, want["losses"], atol=LOSSES_ATOL, rtol=0)
        for name, jtree in zip(("mu", "nu"), (want["mu"], want["nu"])):
            mine = tree_leaves(got["first"][0 if name == "mu" else 1])
            ref = tree_leaves(TM.position_shard(params_from_jax(jtree), topo, rank))
            assert len(mine) == len(ref)
            for a, b in zip(mine, ref):
                scale = float(b.abs().max())
                assert float((a - b).abs().max()) <= MOMENT_TOL * scale, (rank, name)


def test_ring_matches_jax_two_device_greedy_decode(worlds):
    if worlds["jax"] is None:
        pytest.skip("JAX is not installed")
    want = worlds["jax"][1]["tokens"]
    for results in worlds["two"]:
        np.testing.assert_array_equal(results["jax serve"], want)


def test_ring_world_of_two_rings_joins_the_data_axis(worlds):
    """On 4 ranks ``--stages 2`` is 2 data replicas of a 2-stage ring: the
    launcher joins ``RankGrid(2, 2)`` and trains, every rank alike."""
    got = [results["data axis"] for results in worlds["four"]]
    assert all(g["ranks"] == 4 and g["data_parallel"] == 2 for g in got)
    assert all(g["losses"] == got[0]["losses"] for g in got)


@pytest.mark.parametrize("case, error, match", [
    ("refuse world", "ValueError", "cannot hold a stage ring of 3 positions"),
    ("refuse micro", "ValueError", r"needs num_micro \(2\) >= physical stage devices \(4\)"),
])
def test_ring_refusals(worlds, case, error, match):
    """On 4 ranks: ``--stages 3`` fits no ring; interleaved needs as many
    micro-batches as ring positions. Every rank raises."""
    import re

    for results in worlds["four"]:
        got = results[case]
        assert got is not None and got[0] == error and re.search(match, got[1]), got


def test_lm_rank_reports_gathered_on_rank_0(worlds):
    first, second = (results["reports"] for results in worlds["two"])
    assert second is None and [rep["rank"] for rep in first] == [0, 1]
    assert all(rep["step_us"] > 0 and rep["num_collective_events"] == 0 for rep in first)


def _result_dicts(out, key):
    return [ast.literal_eval(line) for line in out.splitlines() if line.startswith(key)]


def test_serve_cli_under_torchrun(worlds):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --stages 2
    --device cpu``: rank 0 alone prints, with the one-process tokens."""
    rc, out = worlds["cli"]["serve"]
    assert rc == 0, out
    dicts = _result_dicts(out, "{'arch'")
    assert len(dicts) == 1, out
    want = worlds["alone"]["cli serve"].summary
    assert dicts[0]["ranks"] == 2 and dicts[0]["sample"] == want["sample"]
    assert dicts[0]["params"] == want["params"] and len(dicts[0]["peak_mem_gb_per_rank"]) == 2


def test_train_cli_under_torchrun(worlds):
    rc, out = worlds["cli"]["train"]
    assert rc == 0, out
    dicts = _result_dicts(out, "{'arch'")
    assert len(dicts) == 1, out
    want = worlds["alone"]["cli train"]
    assert dicts[0]["ranks"] == 2 and dicts[0]["losses"] == want.losses
    assert dicts[0]["params"] == want.summary["params"]


# ------------------------------------------------------- one process only --


def test_stage_ring_ticks_hold_every_item_once():
    """Each (virtual stage, micro-batch) once; a micro-batch's stages in
    order, each one tick after the last; a stage's micro-batches in
    ascending order (so the backward, in reverse, sums them descending)."""
    for D, V, C in ((4, 1, 2), (2, 2, 2), (2, 3, 4), (3, 2, 3)):
        ring = StageRing(D, V, C)
        at = {ring.item(t, d): t for t in range(ring.num_ticks) for d in range(D)
              if ring.item(t, d) is not None}
        assert sorted(at) == [(k, m) for k in range(D * V) for m in range(C)]
        for k in range(1, D * V):
            for m in range(C):
                assert at[(k, m)] > at[(k - 1, m)]
        for k in range(D * V):
            assert [at[(k, m)] for m in range(C)] == sorted(at[(k, m)] for m in range(C))
    with pytest.raises(ValueError, match="num_micro"):
        StageRing(4, 2, 2)


def test_held_stages_and_shards():
    """A position's rows: {d} under fill-drain, {v·D + d} interleaved;
    ``init_params(stages=...)`` draws exactly those rows of the full
    init, and ``position_shard`` takes them from a full tree."""
    cfg = config("codeqwen1.5-7b", 8)
    assert TM.held_stages(topology(4), 2) == [2]
    topo = topology(8, None, "interleaved", 2)
    assert TM.held_stages(topo, 1) == [1, 5]
    full = TM.init_params(cfg, seed=3, num_stages=8)
    for d in range(4):
        part = TM.init_params(cfg, seed=3, num_stages=8, stages=TM.held_stages(topo, d))
        assert trees_equal(part, TM.position_shard(full, topo, d))
    assert TM.stage_seed(3, 1) != TM.stage_seed(3, 2) != TM.stage_seed(4, 1)


def test_ring_world_checks_before_joining(monkeypatch):
    """The launchers' world checks read ``WORLD_SIZE`` before any group
    exists: a world that is no multiple of the ring raises, a multiple
    joins ``RankGrid(world / positions, positions)``, one process runs."""
    from repro_torch.core import cli

    assert cli.join_lm_ring(4, "cpu") == (None, None)
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="cannot hold a stage ring of 3"):
        cli.join_lm_ring(3, "cpu")
    assert not ranks.active()
    monkeypatch.setattr(cli.ranks, "join", lambda device: ("joined", device))
    monkeypatch.setattr(cli.ranks, "RankGrid", lambda dp, D: ("grid", dp, D))
    assert cli.join_lm_ring(2, "cpu") == (("joined", "cpu"), ("grid", 2, 2))
    assert cli.join_lm_ring(4, "cpu") == (("joined", "cpu"), ("grid", 1, 4))


class _Position0:
    """Ring position 0 of a 4-rank grid, for a step that refuses before any hop."""

    D, dp, position = 4, 1, 0


def test_ring_step_refuses_a_whole_tree():
    """A ring position's step refuses the whole 4-stage tree: it holds one
    stage's rows (``position_shard``, ``init_params(stages=...)``)."""
    cfg = config("codeqwen1.5-7b")
    shape = ShapeConfig("p", 8, 4, "prefill")
    params = TM.init_params(cfg, num_stages=4)
    topo = TM.Topology(4, 2, ring=_Position0())
    cache = TM.init_cache(cfg, topo, shape)
    assert {a.shape[0] for a in tree_leaves(cache)} == {1}
    with pytest.raises(ValueError, match="ring position 0 holds 1"):
        TM.make_prefill_step(cfg, topo, shape)(params, cache, {"tokens": torch.zeros(
            (4, 8), dtype=torch.int64)})
    with pytest.raises(ValueError, match="ring position 0 holds 1"):
        TM.make_train_step(cfg, topo, ShapeConfig("t", 8, 4, "train"))(
            params, None, {"tokens": torch.zeros((4, 9), dtype=torch.int64)})
