"""The port's LM data axis, on the CPU over gloo.

The reference runs its LM steps over a ``("data", "model")`` mesh whose
"data" axis is its ``fsdp`` axis: the batch split over it, ZeRO-3-split
block leaves gathered per layer, ZeRO-1-split ``embed``/``head`` moments,
MoE's experts split over it (``gathered`` and ``a2a`` modes) and, under
``seq_shard_decode``, the long-context decode's ring. The port runs it on a
``RankGrid(dp, D)`` of ranks (``Topology(data=dp, ring=grid)``), or every
replica in one process (``Topology(data=dp)``), a data-axis collective
there being the same ordered local sum or concatenation.

One spawn of 4 ranks (dp 2 x D 2) and one of 2 (dp 2 x D 1) run every case
of their world and return the results to this process, which holds them
bit for bit against the one-process step at the same ``Topology``: losses,
each rank's shard of the params and of Adam's moments (codeqwen with ZeRO-3
on and off and interleaved, zamba2's shared block, arctic's MoE gathered
and a2a, deepseek's MLA and multi-token-prediction head), the prefill and
decode logits, tokens and cache shards, the sequence-sharded
long-context decode, and at bf16 params (the reference's dtype) codeqwen's
training, arctic's serving under ``a2a`` and the long-context decode. The
same 4-rank grid also starts from params given to
the reference's dp 2 steps, run in a subprocess on an ``Auto`` (2, 2) mesh
of 4 forced host devices: losses and Adam's first moments at
``tests/test_torch_lm_train.py``'s tolerances, greedy tokens equal, and
the 24-step decode over a 16-slot long-context ring split over the data
axis (tokens equal, the same ring slots written), and codeqwen's first
train step at bf16 against the reference's at its default
``dtype=jnp.bfloat16`` from the same values rounded to bf16 (the loss
within 5e-4 relative, Adam's first moment within 0.05 of each leaf's
largest entry, ``tests/test_torch_bf16_steps.py``'s limits). In one process: the
dense dp 2 step against dp 1 at those tolerances, the sharded draws, the
collectives, and the leaf layout of every arch at full size against the
reference's ``param_layout`` and ``moment_specs``, exactly. Every rank and
the one-process side run with one torch thread and deterministic
algorithms; each world joins with a timeout, so a hang fails instead of
stalling the suite.

The pod axis (``Topology.pods``, the reference's ``pod_axis``) runs in the
same 4-rank world on two more grids: pods 2 x data 1 x D 2 and pods 2 x
data 2 x D 1, bit for bit against the one-process ``Topology(pods=2)``
(training, serving, the long-context decode replicated across pods), and
against the reference's step on a (pod 2, data 1, model 2) ``Auto`` mesh.
The same world counts one train step of each rank under ``OpCounter`` on
gloo; this process counts the same rank's step on meta in a fake world
(``launch.dryrun.count_on_grid``): op for op the same.
"""

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
from repro_torch.core.data_group import DataGroup, fanout, ordered_sum
from repro_torch.data.tokens import token_batch
from repro_torch.launch import dryrun
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import lm_batch
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.convert import params_from_jax
from repro_torch.train.optimizer import tree_leaves, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD_TIMEOUT_S = 150.0  # a world's spawn, all its cases included
GROUP_TIMEOUT_S = 60.0
SEQ, BATCH, MICRO, LOSS_CHUNKS, LR, STEPS = 32, 8, 2, 4, 3e-4, 2
PROMPT, DECODE, LONG, WINDOW = 32, 4, 24, 16
LOSS_RTOL, MOMENT_TOL, LOSSES_ATOL = 1e-5, 1e-5, 1e-4  # tests/test_torch_lm_train.py's
BF16_LOSS_RTOL, BF16_MU_FRAC = 5e-4, 0.05  # tests/test_torch_bf16_steps.py's
# (case, arch, Topology fields): the 4-rank grid's training cases
GRID_TRAIN = [
    ("codeqwen zero3", "codeqwen1.5-7b", {}),
    ("codeqwen zero1", "codeqwen1.5-7b", {"zero3": False}),
    ("codeqwen interleaved", "codeqwen1.5-7b",
     {"num_stages": 4, "schedule": "interleaved", "num_virtual": 2}),
    ("zamba2 shared block", "zamba2-7b", {}),
    ("arctic gathered", "arctic-480b", {}),
    ("arctic a2a", "arctic-480b", {"moe_mode": "a2a"}),
    ("deepseek gathered", "deepseek-v3-671b", {}),
]
GRID_SERVE = ["qwen2.5-32b", "deepseek-v3-671b"]
# the 2-rank grid's (dp 2 x D 1)
PAIR_TRAIN = [("codeqwen zero3", "codeqwen1.5-7b", {}), ("arctic a2a", "arctic-480b",
                                                        {"moe_mode": "a2a"})]
PAIR_SERVE = ["codeqwen1.5-7b"]
# (case, arch, Topology fields) held against the reference's dp 2 steps
JAX_TRAIN = [
    ("zero3", "codeqwen1.5-7b", {}),
    ("zero1", "codeqwen1.5-7b", {"zero3": False}),
    ("gathered", "arctic-480b", {}),
    ("a2a", "arctic-480b", {"moe_mode": "a2a"}),
]
# (case, arch, Topology fields, (pods, data, D)): the pod grids of the 4-rank world
POD_TRAIN = [
    ("codeqwen pods", "codeqwen1.5-7b", {}, (2, 1, 2)),
    ("codeqwen pods zero3", "codeqwen1.5-7b", {}, (2, 2, 1)),
    ("arctic pods a2a", "arctic-480b", {"moe_mode": "a2a"}, (2, 2, 1)),
]
# (name, (pods, data, D)): the grids whose ranks count a train step on gloo and on meta
COUNT_GRIDS = [("dp", (1, 2, 2)), ("pods", (2, 1, 2))]
COUNT_SHAPE = ShapeConfig("t", SEQ, BATCH, "train")
LAYOUT_ARCHS = ["codeqwen1.5-7b", "qwen2.5-32b", "gemma2-27b", "glm4-9b", "mamba2-130m",
                "zamba2-7b", "arctic-480b", "deepseek-v3-671b", "musicgen-large", "qwen2-vl-2b"]


def config(arch, **override):
    """The smoke config with a slot for each of 4 stages (zamba2: a mamba
    slot and the shared block's slot each)."""
    cfg = get_arch(arch, smoke=True)
    layers = 8 if cfg.arch_type == "hybrid" else 4
    return dataclasses.replace(cfg, num_layers=layers, **override)


def topology(D, ring=None, **fields):
    fields = {"num_stages": D, "num_micro": MICRO, "loss_chunks": LOSS_CHUNKS, **fields}
    return TM.Topology(data=2, ring=ring, **fields)


def own_params(cfg, topo, seed=0, dtype=torch.float32):
    """This process's params: the whole tree in one process, a rank's
    stage rows of its data shard (drawn from (seed, stage, shard)) on a
    rank."""
    grid = topo.ring
    if grid is None:
        return TM.init_params(cfg, seed=seed, num_stages=topo.num_stages, topo=topo, dtype=dtype)
    return TM.init_params(cfg, seed=seed, num_stages=topo.num_stages, topo=topo,
                          stages=TM.held_stages(topo, grid.position), data_rank=grid.replica,
                          dtype=dtype)


def shard(tree, cfg, topo, grid, moments=False):
    """A whole tree's copy on ``grid``'s rank (the whole tree without one)."""
    if grid is None:
        return tree
    return TM.grid_shard(tree, cfg, topo, grid.position, grid.replica, moments=moments)


def train(cfg, topo, params=None, steps=STEPS, dtype=torch.float32):
    """``steps`` train steps from params in ``dtype``: losses (then step
    1's batch's again, with the trained params: ``step.loss``), params and
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
            first = tree_map(torch.clone, opt.mu)
    again = step.loss(params, lm_batch(cfg, Namespace(seq=SEQ, batch=BATCH, seed=0), 0, "cpu"))
    return {"losses": [*losses, again], "params": params, "mu": opt.mu, "nu": opt.nu,
            "first": first}


def serve(cfg, topo, params=None, prompt=None, dtype=torch.float32):
    """A prefill of ``PROMPT`` tokens, its cache spliced into the decode
    cache, then ``DECODE`` greedy steps (params and caches in ``dtype``):
    every logit, token and cache."""
    params = own_params(cfg, topo, dtype=dtype) if params is None else params
    if prompt is None:
        prompt = token_batch(batch=BATCH, seq=PROMPT, vocab=cfg.vocab_size, seed=0)[:, :PROMPT]
    prompt = torch.from_numpy(prompt.astype(np.int64))
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


def long_config():
    return dataclasses.replace(get_arch("codeqwen1.5-7b", smoke=True), long_context_window=WINDOW)


def decode_long(cfg, topo, params=None, steps=LONG, dtype=torch.float32):
    """``steps`` greedy decode steps of one row from a zero cache, every
    layer on its long-context window over a ring split over the data axis
    (``Topology.seq_shard``), params and cache in ``dtype``: every step's
    logits and tokens, the cache."""
    params = own_params(cfg, topo, dtype=dtype) if params is None else params
    shape = ShapeConfig("d", steps, 1, "decode")
    step = TM.make_serve_step(cfg, topo, shape)
    cache = TM.init_cache(cfg, topo, shape, dtype=dtype)
    tok = torch.zeros(1, dtype=torch.int32)
    logits, tokens = [], []
    with torch.inference_mode():
        for i in range(steps):
            tok, cache, out = step(params, cache, {"tokens": tok, "pos": i})
            logits.append(out)
            tokens.append(tok)
    return {"logits": torch.stack(logits), "tokens": torch.stack(tokens), "cache": cache}


def long_topology(ring=None):
    return TM.Topology(num_stages=2, num_micro=1, long_context=True, data=2, ring=ring)


def pod_topology(grid_shape, ring=None, **fields):
    """A pod grid's ``Topology``: ``(pods, data, D)``."""
    pods, data, D = grid_shape
    fields = {"num_stages": D, "num_micro": MICRO, "loss_chunks": LOSS_CHUNKS, **fields}
    return TM.Topology(pods=pods, data=data, ring=ring, **fields)


def pod_long_topology(ring=None):
    return TM.Topology(num_stages=2, num_micro=1, long_context=True, pods=2, ring=ring)


def count_topology(grid_shape, ring=None):
    return pod_topology(grid_shape, ring)


def count_train(cfg, topo):
    """One train step of this rank (or process) counted under ``OpCounter``
    (``launch.dryrun.build_step`` on the CPU): aten FLOPs and bytes by op,
    kernel calls and work, collectives by kind."""
    step, inputs = dryrun.build_step(cfg, COUNT_SHAPE, topo, device="cpu", dtype=torch.float32)
    return counts_of(dryrun.count_step(step, inputs))


def counts_of(counter):
    return {"flops": dict(counter.flops_by_op), "bytes": dict(counter.bytes_by_op),
            "calls": dict(counter.kernel_calls), "kernel_ops": dict(counter.kernel_ops),
            "kernel_bytes": dict(counter.kernel_bytes), "collectives": dict(counter.collectives)}


def jax_params():
    """The whole trees the reference's steps and the grid start from: the
    port's own data-split draws, as numpy."""
    out = {}
    for arch in ("codeqwen1.5-7b", "arctic-480b"):
        cfg = get_arch(arch, smoke=True)
        tree = TM.init_params(cfg, seed=1, num_stages=2, topo=topology(2))
        out[arch] = TM._with_paths(lambda _, a: a.numpy(), tree)
    return out


def as_dtypes(tree, like):
    """``tree``'s values cast to the dtypes of ``like``'s leaves at the same
    paths (float32 to bf16 rounds to nearest even, as JAX's ``astype``)."""
    return tree_map(lambda a, b: a.to(b.dtype), tree, like)


def jax_prompt():
    vocab = get_arch("codeqwen1.5-7b", smoke=True).vocab_size
    return token_batch(batch=BATCH, seq=PROMPT + 1, vocab=vocab, seed=0)[:, :PROMPT]


# --------------------------------------------------------------- the worlds --


def _cases(grid, D, jax_in):
    out = {}
    train_cases, serve_archs = (GRID_TRAIN, GRID_SERVE) if D == 2 else (PAIR_TRAIN, PAIR_SERVE)
    for name, arch, fields in train_cases:
        out[f"train {name}"] = train(config(arch), topology(D, grid, **fields))
    for arch in serve_archs:
        out[f"serve {arch}"] = serve(config(arch), topology(D, grid))
    if D == 2:
        out["decode long"] = decode_long(long_config(), long_topology(grid))
        out["bf16 train"] = train(config("codeqwen1.5-7b"), topology(2, grid),
                                  dtype=torch.bfloat16)
        out["bf16 serve a2a"] = serve(config("arctic-480b", num_experts=8),
                                      topology(2, grid, moe_mode="a2a"), dtype=torch.bfloat16)
        out["bf16 decode long"] = decode_long(long_config(), long_topology(grid),
                                              dtype=torch.bfloat16)
    if jax_in is not None:
        for name, arch, fields in JAX_TRAIN:
            cfg, topo = get_arch(arch, smoke=True), topology(2, grid, **fields)
            out[f"jax {name}"] = train(cfg, topo, shard(params_from_jax(jax_in[arch]), cfg, topo,
                                                        grid))
        cfg, topo = get_arch("codeqwen1.5-7b", smoke=True), topology(2, grid)
        own = shard(params_from_jax(jax_in["codeqwen1.5-7b"]), cfg, topo, grid)
        out["jax serve"] = serve(cfg, topo, own, jax_prompt())["tokens"]
        out["jax long"] = decode_long(long_config(), long_topology(grid), own)
        whole = as_dtypes(params_from_jax(jax_in["codeqwen1.5-7b"]),
                          TM.abstract_params(cfg, 2, torch.bfloat16))
        out["jax bf16"] = train(cfg, topo, shard(whole, cfg, topo, grid))
    return out


def _pod_cases(grids, jax_in):
    """The pod grids' cases: ``grids`` maps a ``(pods, data, D)`` shape to
    this rank's ``RankGrid`` of it (None in one process)."""
    out = {}
    for name, arch, fields, shape in POD_TRAIN:
        out[f"train {name}"] = train(config(arch), pod_topology(shape, grids[shape], **fields))
    out["serve pods"] = serve(config("codeqwen1.5-7b"), pod_topology((2, 1, 2), grids[(2, 1, 2)]))
    out["decode long pods"] = decode_long(long_config(), pod_long_topology(grids[(2, 1, 2)]))
    if jax_in is not None:
        cfg = get_arch("codeqwen1.5-7b", smoke=True)
        topo = pod_topology((2, 1, 2), grids[(2, 1, 2)])
        whole = params_from_jax(jax_in["codeqwen1.5-7b"])
        grid = grids[(2, 1, 2)]
        own = whole if grid is None else TM.position_shard(whole, topo, grid.position)
        out["jax pods"] = train(cfg, topo, own)
    return out


def _rank_main(rank: int, world: int, port: int, out_dir: str, jax_in):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        grid = ranks.RankGrid(2, world // 2)
        results = _cases(grid, world // 2, jax_in)
        results["place"] = (grid.position, grid.replica)
        if world == 4:
            grids = {shape: ranks.RankGrid(shape[1], shape[2], pods=shape[0])
                     for shape in ((2, 1, 2), (2, 2, 1))}
            results.update(_pod_cases(grids, jax_in))
            results["pod places"] = {shape: (g.pod, g.replica, g.position)
                                     for shape, g in grids.items()}
            cfg = config("codeqwen1.5-7b")
            for name, shape in COUNT_GRIDS:
                cgrid = grids[shape] if shape[0] > 1 else grid
                results[f"count {name}"] = count_train(cfg, count_topology(shape, cgrid))
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


# The reference's dp 2 steps, in a process of their own: the forced host
# device count must be set before JAX starts. Its abstract_cache gives a
# sequence-sharded cache leaf the per-device w_local slots as its global
# width (each device then holding w_local / fsdp); the long decode hands
# its step a cache of w_total slots, so that each device holds its
# w_local = w_total / fsdp, as its attn_decode_apply reads them.
JAX_SCRIPT = r"""
import dataclasses, os, pickle, sys
# one compute thread: the suite's workers share the cores
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import ShapeConfig, get_arch
from repro.data.tokens import token_batch
from repro.models.transformer import model as JM
SEQ, BATCH, MICRO, LOSS_CHUNKS, LR, STEPS, PROMPT, DECODE, LONG, WINDOW = {consts}
JIT = {{"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}}
with open(sys.argv[1], "rb") as f:
    inputs = pickle.load(f)
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
dev = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
out = {{}}
for name, arch, fields in inputs["train"]:
    cfg = get_arch(arch, smoke=True)
    topo = JM.Topology(num_stages=2, fsdp_size=2, num_micro=MICRO, loss_chunks=LOSS_CHUNKS,
                       **fields)
    art = JM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), mesh, lr=LR,
                             dtype=jnp.float32)
    params = dev(inputs["params"][arch])
    opt = art.meta["optimizer"].init(params)
    batches = [{{"tokens": jnp.asarray(token_batch(batch=BATCH, seq=SEQ, vocab=cfg.vocab_size,
                                                  seed=0, step=i))}} for i in range(STEPS)]
    step = jax.jit(art.fn).lower(params, opt, batches[0]).compile(compiler_options=JIT)
    res = {{"losses": []}}
    for i in range(STEPS):
        params, opt, m = step(params, opt, batches[i])
        res["losses"].append(float(m["loss"]))
        if i == 0:
            res["mu"] = tree(opt.mu)
    out[name] = res
# the dp 2 step at the reference's default dtype (bf16 params, float32 moments
# and loss) from the same values rounded to bf16
cfg = get_arch("codeqwen1.5-7b", smoke=True)
topo = JM.Topology(num_stages=2, fsdp_size=2, num_micro=MICRO, loss_chunks=LOSS_CHUNKS)
art = JM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), mesh, lr=LR)
params = jax.tree_util.tree_map(lambda a, s: jnp.asarray(a).astype(s.dtype),
                                inputs["params"]["codeqwen1.5-7b"], JM._abstract_params(cfg, topo))
opt = art.meta["optimizer"].init(params)
batch = {{"tokens": jnp.asarray(token_batch(batch=BATCH, seq=SEQ, vocab=cfg.vocab_size, seed=0,
                                           step=0))}}
params, opt, m = jax.jit(art.fn).lower(params, opt, batch).compile(compiler_options=JIT)(
    params, opt, batch)
out["bf16"] = {{"loss": float(m["loss"]), "mu": tree(opt.mu)}}
# the pod axis: (pod 2, data 1, model 2), the batch split over (pod, data)
try:
    cfg = get_arch("codeqwen1.5-7b", smoke=True)
    pmesh = jax.make_mesh((2, 1, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    topo = JM.Topology(num_stages=2, fsdp_size=1, pod_axis="pod", num_micro=MICRO,
                       loss_chunks=LOSS_CHUNKS)
    art = JM.make_train_step(cfg, topo, ShapeConfig("t", SEQ, BATCH, "train"), pmesh, lr=LR,
                             dtype=jnp.float32)
    params = dev(inputs["params"]["codeqwen1.5-7b"])
    opt = art.meta["optimizer"].init(params)
    batches = [{{"tokens": jnp.asarray(token_batch(batch=BATCH, seq=SEQ, vocab=cfg.vocab_size,
                                                  seed=0, step=i))}} for i in range(STEPS)]
    step = jax.jit(art.fn).lower(params, opt, batches[0]).compile(compiler_options=JIT)
    res = {{"losses": []}}
    for i in range(STEPS):
        params, opt, m = step(params, opt, batches[i])
        res["losses"].append(float(m["loss"]))
        if i == 0:
            res["mu"] = tree(opt.mu)
    out["pods"] = res
except Exception as err:  # the reference's failure is reported, not hidden
    out["pods"] = {{"error": f"{{type(err).__name__}}: {{err}}"}}
cfg = get_arch("codeqwen1.5-7b", smoke=True)
topo = JM.Topology(num_stages=2, fsdp_size=2, num_micro=MICRO)
params = dev(inputs["params"]["codeqwen1.5-7b"])
part = JM.make_prefill_step(cfg, topo, ShapeConfig("p", PROMPT, BATCH, "prefill"), mesh,
                            dtype=jnp.float32)
sart = JM.make_serve_step(cfg, topo, ShapeConfig("d", PROMPT + DECODE + 16, BATCH, "decode"),
                          mesh, dtype=jnp.float32)
zeros = lambda art: jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                           art.abstract_inputs[1])
logits, pcache = jax.jit(part.fn)(params, zeros(part), {{"tokens": jnp.asarray(inputs["prompt"])}})
dcache = jax.tree_util.tree_map(
    lambda d, s: d.at[:, :, :, :, :s.shape[4]].set(s) if d.ndim >= 5 else s, zeros(sart), pcache)
serve_step = jax.jit(sart.fn)
tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
tokens = [np.asarray(tok)]
for i in range(DECODE):
    tok, dcache = serve_step(params, dcache, {{"tokens": tok, "pos": jnp.asarray(PROMPT + i)}})
    tokens.append(np.asarray(tok))
out["serve"] = np.stack(tokens, axis=1)
cfg = dataclasses.replace(cfg, long_context_window=WINDOW)
topo = JM.Topology(num_stages=2, fsdp_size=2, num_micro=1, seq_shard_decode=True)
sart = JM.make_serve_step(cfg, topo, ShapeConfig("d", LONG, 1, "decode"), mesh,
                          dtype=jnp.float32)
cache = jax.tree_util.tree_map(
    lambda s: jnp.zeros((*s.shape[:4], 2 * s.shape[4], *s.shape[5:]), s.dtype),
    sart.abstract_inputs[1])
step = jax.jit(sart.fn)
tok = jnp.zeros((1,), jnp.int32)
tokens = []
for i in range(LONG):
    tok, cache = step(params, cache, {{"tokens": tok, "pos": jnp.asarray(i)}})
    tokens.append(np.asarray(tok))
out["long"] = {{"tokens": np.stack(tokens), "cache": tree(cache)}}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _start_jax(tmp: str, params: dict, env: dict):
    """The reference's steps in a subprocess; None without JAX."""
    try:
        import jax  # noqa: F401
    except ImportError:
        return None
    src = os.path.join(tmp, "jax_in.pkl")
    with open(src, "wb") as f:
        pickle.dump({"params": params, "train": JAX_TRAIN, "prompt": jax_prompt()}, f)
    consts = (SEQ, BATCH, MICRO, LOSS_CHUNKS, LR, STEPS, PROMPT, DECODE, LONG, WINDOW)
    return subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT.format(consts=consts), src,
         os.path.join(tmp, "jax_out.pkl")],
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
    """The JAX subprocess and the 4- and 2-rank worlds, started together,
    and the one-process results they are held against."""
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{os.environ.get('PYTHONPATH', '')}"}
    tmp = tempfile.TemporaryDirectory()
    params = jax_params()
    jax_proc = _start_jax(tmp.name, params, env)
    try:
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        four_dir, two_dir = (os.path.join(tmp.name, n) for n in ("four", "two"))
        os.makedirs(four_dir)
        os.makedirs(two_dir)
        four = start_world(4, four_dir, params)
        two = start_world(2, two_dir)
        alone = {}
        with _OneThread():
            for D in (2, 1):
                alone[D] = _cases(None, D, params if D == 2 else None)
            cfg = config("codeqwen1.5-7b")
            base = TM.init_params(cfg, num_stages=2, topo=topology(2))
            alone["dp1"] = train(cfg, TM.Topology(num_stages=2, num_micro=MICRO,
                                                  loss_chunks=LOSS_CHUNKS),
                                 tree_map(torch.clone, base))
            alone["dp2"] = train(cfg, topology(2), base)
            alone["pods"] = _pod_cases({(2, 1, 2): None, (2, 2, 1): None}, params)
            meta = {}
            for name, shape in COUNT_GRIDS:
                for rank in range(4):
                    _, counter = dryrun.count_on_grid(
                        cfg, COUNT_SHAPE, pods=shape[0], data=shape[1], stages=shape[2],
                        rank=rank, topology=lambda g, shape=shape: count_topology(shape, g),
                        dtype=torch.float32)
                    meta[(name, rank)] = counts_of(counter)
            alone["meta counts"] = meta
        jax_out = None
        if jax_proc is not None:
            log, _ = jax_proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert jax_proc.returncode == 0, log
            with open(os.path.join(tmp.name, "jax_out.pkl"), "rb") as f:
                jax_out = pickle.load(f)
        results = {"four": finish_world(four, 4, four_dir, deadline),
                   "two": finish_world(two, 2, two_dir, deadline)}
    finally:
        if jax_proc is not None and jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
        tmp.cleanup()
    return {**results, "alone": alone, "jax": jax_out}


# --------------------------------------------------------------- the tests --


def trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.shape == y.shape and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def cache_shard(tree, topo, position, replica, seq):
    """A rank's part of a one-process cache: its stage row, then its
    micro-batch rows, or with ``seq`` its ring slots of the attention
    leaves."""
    rows = tree_map(lambda a: a[[position]], tree)
    if seq:
        cut = lambda path, a: TM._cut(a, 4, 2, replica) if path[-1] in ("k", "v", "ckv") else a
    else:
        cut = lambda path, a: TM._cut(a, 3, 2, replica)
    return TM._with_paths(cut, rows)


def assert_train_equal(got, want, cfg, topo, place, case):
    position, replica = place
    assert all(torch.equal(a, b) for a, b in zip(got["losses"], want["losses"])), case
    for name in ("params", "mu", "nu"):
        mine = TM.grid_shard(want[name], cfg, topo, position, replica, moments=name != "params")
        assert trees_equal(got[name], mine), (case, name)


@pytest.mark.parametrize("case, arch, fields", GRID_TRAIN)
def test_grid_training_bit_identical(worlds, case, arch, fields):
    """dp 2 x D 2, 2 steps: every rank's losses, its shard of the params
    and of Adam's moments (ZeRO-3 leaves, expert leaves, ZeRO-1 ``embed``/
    ``head`` moment rows) equal the one-process ``Topology(data=2)`` step's
    bit for bit."""
    topo = topology(2, **fields)
    for results in worlds["four"]:
        assert_train_equal(results[f"train {case}"], worlds["alone"][2][f"train {case}"],
                           config(arch), topo, results["place"], (case, results["place"]))


def test_grid_bf16_training_bit_identical(worlds):
    """dp 2 x D 2 at bf16 params (ZeRO-3's gathers and the gradients'
    reduce-scatters in bf16, the loss and Adam's moments float32), 2 steps:
    every rank's losses and shards equal the one-process step's bit for
    bit."""
    topo = topology(2)
    for results in worlds["four"]:
        got = results["bf16 train"]
        assert all(p.dtype == torch.bfloat16 for p in tree_leaves(got["params"]))
        assert_train_equal(got, worlds["alone"][2]["bf16 train"], config("codeqwen1.5-7b"), topo,
                           results["place"], ("bf16", results["place"]))


def test_grid_bf16_serving_bit_identical(worlds):
    """arctic's MoE at 8 experts under ``a2a`` on dp 2 x D 2 at bf16 params
    and caches (the exchange's buffers bf16, the logits float32): a prefill
    and 4 decode steps, every rank's logits and tokens and its rows of the
    caches equal one process's bit for bit."""
    want = worlds["alone"][2]["bf16 serve a2a"]
    for results in worlds["four"]:
        got, (position, replica) = results["bf16 serve a2a"], results["place"]
        assert got["logits"].dtype == torch.float32
        assert torch.equal(got["logits"], want["logits"]), results["place"]
        assert torch.equal(got["tokens"], want["tokens"]), results["place"]
        for name in ("pcache", "dcache"):
            assert {a.dtype for a in tree_leaves(got[name])} == {torch.bfloat16}
            mine = cache_shard(want[name], topology(2), position, replica, seq=False)
            assert trees_equal(got[name], mine), (results["place"], name)


def test_grid_bf16_long_context_decode_bit_identical(worlds):
    """The sequence-sharded long-context decode at bf16 params and cache:
    every step's logits and tokens and each rank's ring slots equal one
    process's bit for bit."""
    want = worlds["alone"][2]["bf16 decode long"]
    for results in worlds["four"]:
        got, (position, replica) = results["bf16 decode long"], results["place"]
        assert torch.equal(got["logits"], want["logits"]), results["place"]
        assert torch.equal(got["tokens"], want["tokens"]), results["place"]
        assert {a.dtype for a in tree_leaves(got["cache"])} == {torch.bfloat16}
        mine = cache_shard(want["cache"], long_topology(), position, replica, seq=True)
        assert trees_equal(got["cache"], mine), results["place"]


@pytest.mark.parametrize("case, arch, fields", PAIR_TRAIN)
def test_pair_training_bit_identical(worlds, case, arch, fields):
    """dp 2 x D 1: each rank is one whole stage of one replica."""
    topo = topology(1, **fields)
    for results in worlds["two"]:
        assert_train_equal(results[f"train {case}"], worlds["alone"][1][f"train {case}"],
                           config(arch), topo, results["place"], (case, results["place"]))


@pytest.mark.parametrize("world, D, arch", [("four", 2, a) for a in GRID_SERVE]
                         + [("two", 1, a) for a in PAIR_SERVE])
def test_grid_serving_bit_identical(worlds, world, D, arch):
    """A prefill and 4 decode steps of 8 rows, 4 a replica: every rank's
    logits and tokens (the whole batch's) and its rows of the prefill and
    decode caches equal one process's."""
    want = worlds["alone"][D][f"serve {arch}"]
    for results in worlds[world]:
        got, (position, replica) = results[f"serve {arch}"], results["place"]
        assert torch.equal(got["logits"], want["logits"]), results["place"]
        assert torch.equal(got["tokens"], want["tokens"]), results["place"]
        for name in ("pcache", "dcache"):
            mine = cache_shard(want[name], topology(D), position, replica, seq=False)
            assert trees_equal(got[name], mine), (results["place"], name)


def test_grid_long_context_decode_bit_identical(worlds):
    """24 steps of one row over a 16-slot ring, 8 slots a replica: every
    step's logits and tokens and each rank's ring slots equal one
    process's."""
    want = worlds["alone"][2]["decode long"]
    for results in worlds["four"]:
        got, (position, replica) = results["decode long"], results["place"]
        assert torch.equal(got["logits"], want["logits"]), results["place"]
        assert torch.equal(got["tokens"], want["tokens"]), results["place"]
        mine = cache_shard(want["cache"], long_topology(), position, replica, seq=True)
        assert trees_equal(got["cache"], mine), results["place"]


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, (*path, k)) if isinstance(v, dict) else {(*path, k): v})
    return out


@pytest.mark.parametrize("case, arch, fields", JAX_TRAIN)
def test_grid_matches_jax_dp2_train(worlds, case, arch, fields):
    """From the same params, 2 steps on the dp 2 x D 2 grid against the
    reference's dp 2 step: the step-1 loss within 1e-5 relative, both
    losses within 1e-4, and every rank's shard of Adam's first moment after
    step 1 within 1e-5 of each leaf's largest entry."""
    if worlds["jax"] is None:
        pytest.skip("JAX is not installed")
    want = worlds["jax"][case]
    cfg, topo = get_arch(arch, smoke=True), topology(2, **fields)
    for results in worlds["four"]:
        got = results[f"jax {case}"]
        losses = [float(x) for x in got["losses"][:STEPS]]
        assert abs(losses[0] - want["losses"][0]) <= LOSS_RTOL * abs(want["losses"][0])
        np.testing.assert_allclose(losses, want["losses"], atol=LOSSES_ATOL, rtol=0)
        position, replica = results["place"]
        ref = _flat(TM.grid_shard(params_from_jax(want["mu"]), cfg, topo, position, replica,
                                  moments=True))
        mine = _flat(got["first"])
        assert set(mine) == set(ref)
        for path, b in ref.items():
            a = mine[path]
            assert a.shape == b.shape, path
            assert float((a - b).abs().max()) <= MOMENT_TOL * float(b.abs().max()), path


def test_grid_bf16_matches_jax_dp2_train(worlds):
    """From the same values rounded to bf16, the dp 2 x D 2 grid's first
    bf16 train step against the reference's dp 2 step at its default
    ``dtype=jnp.bfloat16``: the loss within ``BF16_LOSS_RTOL`` relative,
    and every rank's shard of Adam's first moment (float32 on both sides)
    within ``BF16_MU_FRAC`` of each leaf's largest entry."""
    if worlds["jax"] is None:
        pytest.skip("JAX is not installed")
    want = worlds["jax"]["bf16"]
    cfg, topo = get_arch("codeqwen1.5-7b", smoke=True), topology(2)
    for results in worlds["four"]:
        got = results["jax bf16"]
        assert all(p.dtype == torch.bfloat16 for p in tree_leaves(got["params"]))
        loss = float(got["losses"][0])
        assert abs(loss - want["loss"]) <= BF16_LOSS_RTOL * abs(want["loss"])
        position, replica = results["place"]
        ref = _flat(TM.grid_shard(params_from_jax(want["mu"]), cfg, topo, position, replica,
                                  moments=True))
        mine = _flat(got["first"])
        assert set(mine) == set(ref)
        for path, b in ref.items():
            a = mine[path]
            assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, path
            assert float((a - b).abs().max()) <= BF16_MU_FRAC * float(b.abs().max()), path


def test_grid_matches_jax_dp2_greedy_decode(worlds):
    if worlds["jax"] is None:
        pytest.skip("JAX is not installed")
    for results in worlds["four"]:
        np.testing.assert_array_equal(results["jax serve"].numpy(), worlds["jax"]["serve"])


def test_grid_matches_jax_sequence_sharded_decode(worlds):
    """The reference's ``seq_shard_decode`` over 24 steps: the same tokens,
    and each rank's ring slots are the reference's: the same slots written
    (nonzero), the same entries within 1e-5."""
    if worlds["jax"] is None:
        pytest.skip("JAX is not installed")
    want = worlds["jax"]["long"]
    cache = params_from_jax(want["cache"])
    for results in worlds["four"]:
        got, (position, replica) = results["jax long"], results["place"]
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
        ref = cache_shard(cache, long_topology(), position, replica, seq=True)
        for name in ("k", "v"):
            a, b = got["cache"][name], ref[name]
            assert a.shape == b.shape
            written = lambda t: t.abs().sum(dim=(0, 1, 2, 3, 5, 6)) > 0
            assert torch.equal(written(a), written(b)) and bool(written(a).any())
            assert float((a - b).abs().max()) <= 1e-5


def test_dense_dp2_matches_dp1(worlds):
    """The same params and batches at dp 2 and dp 1 in one process: the
    step-1 loss within 1e-5 relative, the losses within 1e-4, Adam's first
    moment within 1e-5 of each leaf's largest entry."""
    one, two = worlds["alone"]["dp1"], worlds["alone"]["dp2"]
    l1, l2 = ([float(x) for x in r["losses"][:STEPS]] for r in (one, two))
    assert abs(l2[0] - l1[0]) <= LOSS_RTOL * abs(l1[0])
    np.testing.assert_allclose(l2, l1, atol=LOSSES_ATOL, rtol=0)
    for a, b in zip(tree_leaves(two["first"]), tree_leaves(one["first"])):
        assert float((a - b).abs().max()) <= MOMENT_TOL * float(b.abs().max())


def pod_shard(tree, cfg, topo, place, moments=False):
    """A pod grid rank's part of a one-process tree: every pod holds the
    same, so its (position, replica) shard."""
    _, replica, position = place
    return TM.grid_shard(tree, cfg, topo, position, replica, moments=moments) \
        if topo.data > 1 else TM.position_shard(tree, topo, position)


@pytest.mark.parametrize("case, arch, fields, shape", POD_TRAIN)
def test_pod_training_bit_identical(worlds, case, arch, fields, shape):
    """pods 2 x data 1 x D 2 and pods 2 x data 2 x D 1 on 4 ranks, 2
    steps: every rank's losses and its shard of the params and of Adam's
    moments (the same in both pods) equal the one-process
    ``Topology(pods=2)`` step's bit for bit; arctic's a2a exchange runs
    over the data axis alone."""
    cfg, topo = config(arch), pod_topology(shape, **fields)
    want = worlds["alone"]["pods"][f"train {case}"]
    pods = set()
    for results in worlds["four"]:
        got, place = results[f"train {case}"], results["pod places"][shape]
        pods.add(place[0])
        assert all(torch.equal(a, b) for a, b in zip(got["losses"], want["losses"])), place
        for name in ("params", "mu", "nu"):
            assert trees_equal(got[name], pod_shard(want[name], cfg, topo, place,
                                                    moments=name != "params")), (place, name)
    assert pods == {0, 1}


def test_pod_serving_bit_identical(worlds):
    """A prefill and 4 decode steps of 8 rows, 4 a pod: every rank's logits
    and tokens (the whole batch's) and its rows of the caches (its pod's
    rows of each micro-batch) equal one process's; the long-context decode's
    one row, replicated across pods, equals one process's on every rank."""
    want = worlds["alone"]["pods"]["serve pods"]
    long_want = worlds["alone"]["pods"]["decode long pods"]
    for results in worlds["four"]:
        got, (pod, _, position) = results["serve pods"], results["pod places"][(2, 1, 2)]
        assert torch.equal(got["logits"], want["logits"]) and \
            torch.equal(got["tokens"], want["tokens"])
        for name in ("pcache", "dcache"):
            mine = cache_shard(want[name], topology(2), position, pod, seq=False)
            assert trees_equal(got[name], mine), (pod, position, name)
        long_got = results["decode long pods"]
        assert torch.equal(long_got["logits"], long_want["logits"])
        rows = tree_map(lambda a: a[[position]], long_want["cache"])
        assert trees_equal(long_got["cache"], rows)


def test_pods_match_jax_pod_mesh_train(worlds):
    """From the same params, 2 steps on pods 2 x data 1 x D 2 against the
    reference's step on a (pod 2, data 1, model 2) mesh: the step-1 loss
    within 1e-5 relative, both losses within 1e-4, Adam's first moment
    after step 1 within 1e-5 of each leaf's largest entry; and every rank
    bit for bit the one-process ``Topology(pods=2)`` from those params."""
    if worlds["jax"] is None:
        pytest.skip("JAX is not installed")
    want = worlds["jax"]["pods"]
    if "error" in want:
        pytest.skip(f"the reference's pod-mesh train step fails here (ROADMAP queue 3): "
                    f"{want['error']}")
    cfg, topo = get_arch("codeqwen1.5-7b", smoke=True), pod_topology((2, 1, 2))
    alone = worlds["alone"]["pods"]["jax pods"]
    ref = params_from_jax(want["mu"])
    for results in worlds["four"]:
        got, place = results["jax pods"], results["pod places"][(2, 1, 2)]
        assert all(torch.equal(a, b) for a, b in zip(got["losses"], alone["losses"]))
        losses = [float(x) for x in got["losses"][:STEPS]]
        assert abs(losses[0] - want["losses"][0]) <= LOSS_RTOL * abs(want["losses"][0])
        np.testing.assert_allclose(losses, want["losses"], atol=LOSSES_ATOL, rtol=0)
        mine = _flat(got["first"])
        shard = _flat(pod_shard(ref, cfg, topo, place, moments=True))
        assert set(mine) == set(shard)
        for path, b in shard.items():
            a = mine[path]
            assert a.shape == b.shape, path
            assert float((a - b).abs().max()) <= MOMENT_TOL * float(b.abs().max()), path


@pytest.mark.parametrize("grid", [name for name, _ in COUNT_GRIDS])
def test_rank_count_on_gloo_equals_meta_fake_world(worlds, grid):
    """Each rank's train step counted under ``OpCounter`` on gloo equals
    the same rank's step counted on meta in a fake world of 4
    (``dryrun.count_on_grid``), op for op: aten FLOPs and bytes by op,
    kernel calls and work, and collectives by kind, some of each kind the
    grid issues."""
    for rank, results in enumerate(worlds["four"]):
        got, want = results[f"count {grid}"], worlds["alone"]["meta counts"][(grid, rank)]
        assert got == want, (grid, rank)
        coll = got["collectives"]
        assert coll["collective-permute"] > 0 and coll["all-reduce"] > 0
        assert coll["all-gather"] > 0
        if grid == "dp":
            assert coll["all-to-all"] > 0  # the ZeRO-3 gradient's reduce-scatter


# ------------------------------------------------------- one process only --


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_leaf_layout_matches_jax(arch):
    """At full size, ``fsdp_size`` 2, ZeRO-3 on and off: ``param_layout``'s
    specs and gather mask and ``moment_specs`` equal the reference's."""
    jax = pytest.importorskip("jax")
    from jax.sharding import PartitionSpec

    from repro.configs import get_arch as jax_arch
    from repro.models.transformer import model as JM

    spec = lambda t: jax.tree_util.tree_map(tuple, t,
                                            is_leaf=lambda x: isinstance(x, PartitionSpec))
    for zero3 in (True, False):
        jtopo = JM.Topology(num_stages=2, fsdp_size=2, zero3=zero3)
        shapes = JM._abstract_params(jax_arch(arch, smoke=False), jtopo, jax.numpy.float32)
        specs, gather = JM.param_layout(jax_arch(arch, smoke=False), shapes, jtopo)
        moments = JM.moment_specs(jax_arch(arch, smoke=False), shapes, jtopo)
        cfg, topo = get_arch(arch, smoke=False), TM.Topology(num_stages=2, data=2, zero3=zero3)
        mine = TM.abstract_params(cfg, 2)
        tspecs, tgather = TM.param_layout(cfg, mine, topo)
        assert tspecs == spec(specs), zero3
        assert tgather == jax.tree_util.tree_map(bool, gather), zero3
        assert TM.moment_specs(cfg, mine, topo) == spec(moments), zero3


@pytest.mark.parametrize("arch, fields", [("codeqwen1.5-7b", {}), ("arctic-480b",
                                                                     {"zero3": False}),
                                          ("zamba2-7b", {})])
def test_rank_draws_its_shard_of_the_one_process_tree(arch, fields):
    """``init_params(stages=..., data_rank=r)`` draws exactly rank r's rows
    of the one-process tree (``grid_shard``); no rank draws a whole split
    leaf."""
    cfg = config(arch)
    topo = topology(2, **fields)
    full = TM.init_params(cfg, seed=3, num_stages=2, topo=topo)
    dims = TM.leaf_layout(cfg, topo).params
    for position in range(2):
        for r in range(2):
            part = TM.init_params(cfg, seed=3, num_stages=2, topo=topo,
                                  stages=[position], data_rank=r)
            assert trees_equal(part, TM.grid_shard(full, cfg, topo, position, r))
            for a, d, f in zip(tree_leaves(part), tree_leaves(dims), tree_leaves(full)):
                assert d is None or 2 * a.shape[d] == f.shape[d]


def test_one_process_collectives():
    """``DataGroup``'s collectives over 3 replicas in one process, forward
    and backward: gather concatenates and reduce-scatters the gradient,
    scatter_sum reduce-scatters and all-gathers the gradient, exchange
    all-to-alls both ways, each sum in ascending replica order; fanout sums
    its copies' gradients in index order."""
    group = DataGroup(3)
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 4, generator=gen, requires_grad=True) for _ in range(3)]
    ws = [torch.randn(6, 4, generator=gen) for _ in range(3)]
    outs = group.gather(xs)
    assert all(torch.equal(o, torch.cat(xs)) for o in outs)
    torch.autograd.backward(outs, ws)
    for r, x in enumerate(xs):
        assert torch.equal(x.grad, ordered_sum([w[2 * r:2 * r + 2] for w in ws]))
    ys = [torch.randn(6, 4, generator=gen, requires_grad=True) for _ in range(3)]
    outs = group.scatter_sum(ys)
    for r, o in enumerate(outs):
        assert torch.equal(o, ordered_sum([y[2 * r:2 * r + 2] for y in ys]))
    gs = [torch.randn(2, 4, generator=gen) for _ in range(3)]
    torch.autograd.backward(outs, gs)
    assert all(torch.equal(y.grad, torch.cat(gs)) for y in ys)
    zs = [torch.randn(3, 5, generator=gen, requires_grad=True) for _ in range(3)]
    outs = group.exchange(zs)
    for r, o in enumerate(outs):
        assert torch.equal(o, torch.stack([z[r] for z in zs]))
    torch.autograd.backward(outs, [o.detach() * 2 for o in outs])
    assert all(torch.equal(z.grad, 2 * z.detach()) for z in zs)
    x = torch.randn(4, generator=gen, requires_grad=True)
    a, b, c = fanout(x, 3)
    (a * 1.5 + b * 2.5 + c * 3.5).sum().backward()
    assert torch.equal(x.grad, ordered_sum([torch.full((4,), v) for v in (1.5, 2.5, 3.5)]))
    assert group.sum([torch.ones(2)] * 3)[0].tolist() == [3.0, 3.0]


def test_data_axis_refusals():
    """Experts that do not split over the data axis, an unknown MoE mode,
    and a ring grid of another data width raise ``ValueError``."""
    with pytest.raises(ValueError, match="experts do not split"):
        TM.make_train_step(config("arctic-480b"), TM.Topology(num_stages=2, data=3),
                           ShapeConfig("t", SEQ, 6, "train"))
    with pytest.raises(ValueError, match="moe_mode"):
        TM.make_train_step(config("arctic-480b"), topology(2, moe_mode="ring"),
                           ShapeConfig("t", SEQ, BATCH, "train"))

    class Grid:
        D, dp, position, replica = 2, 1, 0, 0

    with pytest.raises(ValueError, match="rank grid of 1"):
        TM.make_serve_step(config("codeqwen1.5-7b"), topology(2, Grid()),
                           ShapeConfig("d", 8, BATCH, "decode"))
