"""Dry run: count every (arch × shape) step on the meta device and record
its memory, counted work and three-term roofline, on one card or for one
rank of the reference's production grids. Counterpart of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch codeqwen1.5-7b \\
        --shape train_4k [--mesh 1card|16x16] [--multi-pod] [--out reports/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16

The reference lowers and compiles each step on 512 placeholder devices and
reads XLA's memory and cost analyses and its HLO walk. The port builds the
step's params, optimizer state, cache and batch on the ``meta`` device at
the reference's own dtype, bfloat16 (its step builders' default, which its
dry run keeps): params, caches and activations in bfloat16, Adam's moments
and the Mamba ``ssm`` state in float32, as the reference has them. It runs
the step once under ``roofline.counter.OpCounter``: shapes only, no data,
no card. The flash and SSD wrappers take their meta route (checks and
allocations, no launch) and report their kernel's cost. ``build_step`` and
``run_one`` take ``dtype=torch.float32`` for the dtype the launchers run.

``--mesh 1card`` (the default) counts the whole 16-stage model at full
width and depth on one card: the port's answer to "what fits one card".
``--mesh 16x16`` counts one rank's program of the reference's production
grid, 16 data replicas x 16 stages (``launch/mesh.py``'s shape), and
``--multi-pod`` (``2x16x16``) adds the pod axis: 2 pods of that grid. The
process joins a fake world of 256 or 512 ranks on the meta device
(``torch.testing._internal.distributed.fake_pg``, whose collectives move
nothing), builds the rank's ``RankGrid``, and runs that rank's step: its
stage's rows of its data shard, its cache rows, its collectives, which the
counter counts by kind. By default the rank is 0 (ring position 0 of
replica 0 of pod 0; ``--position`` picks another position of that ring).
That is the reference's per-device peak, FLOPs, bytes and collective bytes,
for one device. ``--moe-mode a2a`` and ``--no-zero3`` need the data axis,
so they run on a grid only.

Each combination writes one JSON, ``<arch>__<shape>__<mesh>.json``: the
peak of live bytes and whether it fits the card's memory, the counted FLOPs
(aten and per kernel) and bytes, the kernel calls, ``collective_bytes`` and
``roofline`` (``roofline_report`` at the H100's data-sheet rates,
``CARD``: bf16 products at the bf16 rate), with ``model_flops``. These are
predictions, not measurements. The exit code is non-zero if any requested
combination fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_arch, get_shape, list_archs
from repro_torch.core.ranks import RankGrid
from repro_torch.models.transformer.model import (
    Topology, abstract_params, batch_specs, grid_shard, init_cache, init_params,
    make_prefill_step, make_serve_step, make_train_step,
)
from repro_torch.roofline.analysis import HW, collective_bytes, model_flops, roofline_report
from repro_torch.roofline.counter import OpCounter

CARD = "NVIDIA H100 80GB HBM3"  # the card whose data-sheet rates and memory the roofline uses
# the reference's production grids (``repro/launch/mesh.py``): (pods, data, stages)
GRIDS = {"16x16": (1, 16, 16), "2x16x16": (2, 16, 16)}
MESHES = ("1card", *GRIDS)
DATA_AXIS = "needs the data axis of a grid (--mesh 16x16 or --multi-pod), not one card"


def mesh_of(mesh: str | None, multi_pod: bool) -> str:
    """The mesh the flags name: ``--multi-pod`` is ``2x16x16``, else
    ``--mesh`` (default ``1card``)."""
    if multi_pod:
        if mesh == "1card":
            raise ValueError(f"--multi-pod {DATA_AXIS}: it is the 2x16x16 grid")
        return "2x16x16"
    return mesh or "1card"


def topology_for(cfg, shape, *, mesh: str = "1card", num_micro: int | None = None,
                 remat: bool = True, moe_mode: str = "gathered", zero3: bool = True,
                 ring=None) -> Topology:
    """The reference's topology (``repro/launch/dryrun.py:41``): 16 stages,
    remat, 8 loss chunks, and the long-context decode under the reference's
    rule (decode, global batch 1, not an SSM). On a grid (``16x16``,
    ``2x16x16``) it is the reference's field for field: data 16, the pods,
    ``moe_mode``, ``zero3``, and ``num_micro`` = min(target, global batch /
    (16 · pods)); ``ring`` is the rank's ``RankGrid``. On one card there is
    no data axis: ``num_micro`` is min(target, global batch), the same for
    train_4k (16), decode_32k (4) and long_500k (1), but 4 micro-batches
    for prefill_32k where the reference has 2; ``moe_mode`` a2a and
    ``zero3`` off raise ``ValueError``."""
    if mesh not in MESHES:
        raise ValueError(f"mesh must be one of {MESHES}, got {mesh!r}")
    pods, data = GRIDS[mesh][:2] if mesh in GRIDS else (1, 1)
    if data == 1:
        if moe_mode != "gathered":
            raise ValueError(f"--moe-mode {moe_mode} {DATA_AXIS}")
        if not zero3:
            raise ValueError(f"--no-zero3 {DATA_AXIS}")
    if num_micro is None:
        target = {"train": 16, "prefill": 4, "decode": 4}[shape.kind]
        num_micro = max(min(target, shape.global_batch // (data * pods)), 1)
    long_context = shape.kind == "decode" and shape.global_batch == 1 and cfg.arch_type != "ssm"
    grid = {} if data == 1 else dict(data=data, pods=pods, moe_mode=moe_mode, zero3=zero3,
                                     ring=ring)
    return Topology(num_stages=16, num_micro=num_micro, remat=remat, loss_chunks=8,
                    long_context=long_context, **grid)


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A process group of ``world`` ranks in which this process is
    ``rank``, on the fake backend (``cpu:fake,meta:fake``: collectives and
    point-to-point ops on meta tensors move nothing), destroyed on exit.
    Raises if a process group exists already, or if torch's fake backend
    (a private module) is missing: the grid dry run never falls back to
    counting one card."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("a process group exists already: the grid dry run joins a fake "
                           "world of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as err:
        raise RuntimeError("the grid dry run needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") from err
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_step(cfg, shape, topo, *, device="meta", dtype=torch.bfloat16):
    """``(step, inputs)``: the step of ``shape.kind`` and its arguments —
    params (``abstract_params`` on meta) and cache in ``dtype``, the Adam
    state (training: float32 moments) or the cache (serving) and the batch
    — on ``device``. On a rank of a grid
    (``topo.ring``) the params are its ``grid_shard``, the state and cache
    its own rows, the batch the whole one, as every rank is handed. A
    decode batch's ``pos`` is the last position of ``shape.seq_len``, a
    Python int."""
    if device == "meta":
        params = abstract_params(cfg, topo.num_stages, dtype)
    else:
        params = init_params(cfg, num_stages=topo.num_stages, dtype=dtype, device=device)
    grid = topo.ring
    if grid is not None:
        params = grid_shard(params, cfg, topo, grid.position, grid.replica)
    batch = {name: torch.zeros(spec_shape, dtype=spec_dtype, device=device)
             for name, (spec_shape, spec_dtype) in batch_specs(cfg, shape, dtype).items()}
    if shape.kind == "train":
        step = make_train_step(cfg, topo, shape)
        return step, (params, step.optimizer.init(params), batch)
    cache = init_cache(cfg, topo, shape, dtype=dtype, device=device)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, topo, shape), (params, cache, batch)
    batch["pos"] = shape.seq_len - 1
    return make_serve_step(cfg, topo, shape), (params, cache, batch)


def count_step(step, inputs) -> OpCounter:
    """Run ``step(*inputs)`` once under an ``OpCounter`` whose resident bytes
    are ``inputs``; the counter."""
    counter = OpCounter(resident=inputs)
    with counter:
        step(*inputs)
    return counter


def count_on_grid(cfg, shape, *, pods: int, data: int, stages: int, rank: int,
                  topology, dtype=torch.bfloat16) -> tuple[Topology, OpCounter]:
    """Rank ``rank``'s step of a ``pods`` x ``data`` x ``stages`` grid
    counted on meta at ``dtype``, in a fake world of that many ranks:
    ``topology(grid)`` gives its ``Topology`` on the rank's ``RankGrid``.
    ``(the topology, the counter)``."""
    with fake_world(pods * data * stages, rank):
        grid = RankGrid(data, stages, pods=pods)
        topo = topology(grid)
        step, inputs = build_step(cfg, shape, topo, dtype=dtype)
        return topo, count_step(step, inputs)


def run_one(arch: str, shape_name: str, *, out_dir: str | None, mesh: str = "1card",
            position: int = 0, num_micro: int | None = None, remat: bool = True,
            moe_mode: str = "gathered", zero3: bool = True, verbose: bool = True,
            tag: str = "", dtype=torch.bfloat16) -> dict:
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    hw = HW.of(CARD)
    t0 = time.perf_counter()
    if mesh == "1card":
        topo = topology_for(cfg, shape, num_micro=num_micro, remat=remat, moe_mode=moe_mode,
                            zero3=zero3)
        step, inputs = build_step(cfg, shape, topo, dtype=dtype)
        counter = count_step(step, inputs)
        del step, inputs
        chips, where = 1, f"one {hw.name}"
    else:  # the rank at ring position ``position`` of replica 0 of pod 0
        pods, data, stages = GRIDS[mesh]
        if not 0 <= position < stages:
            raise ValueError(f"--position must be in 0..{stages - 1}, got {position}")
        topo, counter = count_on_grid(
            cfg, shape, pods=pods, data=data, stages=stages, rank=position,
            topology=lambda grid: topology_for(cfg, shape, mesh=mesh, num_micro=num_micro,
                                               remat=remat, moe_mode=moe_mode, zero3=zero3,
                                               ring=grid), dtype=dtype)
        chips, where = pods * data * stages, f"rank {position} of {mesh} ({hw.name}s)"
    count_s = time.perf_counter() - t0
    counts = counter.report()
    coll = collective_bytes(counts["collectives"])
    device_bytes = counts["bytes"]["aten"] + sum(counts["bytes"]["kernels"].values())
    mf = model_flops(cfg, shape, training=shape.kind == "train")
    report = roofline_report(aten_flops=counts["flops"]["aten"],
                             kernel_ops=counts["flops"]["kernels"], device_bytes=device_bytes,
                             device_collective=coll, chips=chips, model_flops_global=mf, hw=hw,
                             aten_flops_by_dtype=counts["flops"]["by_dtype"],
                             kernel_ops_by_precision=counts["flops"]["kernels_by_precision"])
    peak = counts["memory"]["peak_bytes"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "1 card" if mesh == "1card" else mesh,
        "card": hw.name,
        "chips": chips,
        "kind": shape.kind,
        "dtype": str(dtype).replace("torch.", ""),
        "num_micro": topo.num_micro,
        "num_stages": topo.num_stages,
        "long_context": topo.long_context,
        "seq_shard_decode": topo.seq_shard,
        "moe_mode": topo.moe_mode,
        "zero3": topo.zero3,
        "remat": topo.remat,
        "tag": tag,
        "count_s": round(count_s, 1),
        "memory": {
            "entry_bytes": counts["memory"]["entry_bytes"],
            "peak_bytes": peak,
            "peak_estimate_gib": round(peak / 2**30, 3),
            "card_bytes": hw.hbm_bytes,
            "card_gib": round(hw.hbm_bytes / 2**30, 3),
            "fits": peak <= hw.hbm_bytes,
        },
        "flops": counts["flops"],
        "bytes": {**counts["bytes"], "total": device_bytes},
        "kernel_calls": counts["kernel_calls"],
        "collective_bytes": coll,
        "roofline": report,
        "ok": True,
    }
    if mesh != "1card":
        result.update(rank=position, data=topo.data, pods=topo.pods)
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} on {where} (meta): counted in "
              f"{count_s:.1f} s, peak {result['memory']['peak_estimate_gib']} GiB "
              f"({'fits' if result['memory']['fits'] else 'does not fit'} "
              f"{result['memory']['card_gib']} GiB), aten {counts['flops']['aten']:.4g} FLOPs, "
              f"kernels {counts['flops']['kernels']}, {device_bytes:.4g} B moved, calls "
              f"{counts['kernel_calls']}, collectives {coll['total']:.4g} B, dominant "
              f"{report['dominant']} ({report['bound_s']:.4g} s)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1)
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None, choices=list(MESHES),
                    help="1card (default): the whole model on one card; 16x16: one rank "
                         "of the reference's 16 data x 16 stage grid")
    ap.add_argument("--multi-pod", action="store_true", help="the 2x16x16 grid (2 pods)")
    ap.add_argument("--position", type=int, default=0,
                    help="a grid's ring position to count (replica 0 of pod 0)")
    ap.add_argument("--moe-mode", default="gathered", choices=["gathered", "a2a"])
    ap.add_argument("--no-zero3", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--num-micro", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="reports/dryrun_torch")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.all:
        combos = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("give --arch and --shape, or --all")
        combos = [(args.arch, args.shape)]
    mesh = mesh_of(args.mesh, args.multi_pod)
    # flags that need the data axis refuse on one card before any step is built
    topology_for(get_arch(combos[0][0]), get_shape(combos[0][1]), mesh=mesh,
                 moe_mode=args.moe_mode, zero3=not args.no_zero3)
    failures = []
    t0 = time.perf_counter()
    for arch, shape in combos:
        try:
            run_one(arch, shape, out_dir=args.out, mesh=mesh, position=args.position,
                    num_micro=args.num_micro, remat=not args.no_remat, moe_mode=args.moe_mode,
                    zero3=not args.no_zero3, tag=args.tag)
        except Exception as e:  # noqa: BLE001 — report and continue
            failures.append((arch, shape, repr(e)))
            print(f"[dryrun] FAIL {arch} × {shape}: {e}")
            traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} failures: {[(a, s) for a, s, _ in failures]}")
        raise SystemExit(1)
    print(f"[dryrun] all {len(combos)} combinations counted on meta ({mesh}) in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
