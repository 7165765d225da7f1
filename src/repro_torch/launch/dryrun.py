"""One-card dry run: count every (arch × shape) step on the meta device and
record its memory, counted work and three-term roofline. Counterpart of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch codeqwen1.5-7b \\
        --shape train_4k [--out reports/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each step on 512 placeholder devices and
reads XLA's memory and cost analyses and its HLO walk. The port builds the
step's params, optimizer state, cache and batch on the ``meta`` device in
float32 (the dtype its launchers run), at full width and depth, and runs
the step once under ``roofline.counter.OpCounter``: shapes only, no data,
no card. The flash and SSD wrappers take their meta route (checks and
allocations, no launch) and report their kernel's cost. Each combination
writes one JSON: the peak of live bytes and whether it fits the card's
memory, the counted FLOPs (aten and per kernel) and bytes, the kernel
calls, ``collective_bytes`` and ``roofline`` (``roofline_report`` at the
H100's data-sheet rates, ``CARD``), with ``model_flops``.
These are predictions, not measurements. The exit code is non-zero if any
requested combination fails.

``--multi-pod``, ``--moe-mode a2a`` and ``--no-zero3`` describe several
cards (a second pod, expert parallelism, unsharded replicas over a data
axis); each raises ``NotImplementedError`` (ROADMAP queue 1 item 9(c)).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_arch, get_shape, list_archs
from repro_torch.models.transformer.model import (
    Topology, abstract_params, batch_specs, init_cache, init_params, make_prefill_step,
    make_serve_step, make_train_step,
)
from repro_torch.roofline.analysis import HW, collective_bytes, model_flops, roofline_report
from repro_torch.roofline.counter import OpCounter

CARD = "NVIDIA H100 80GB HBM3"  # the card whose data-sheet rates and memory the roofline uses
MULTI_CARD = "needs more than one card (ROADMAP queue 1 item 9(c))"


def topology_for(cfg, shape, *, num_micro: int | None = None, remat: bool = True,
                 multi_pod: bool = False, moe_mode: str = "gathered",
                 zero3: bool = True) -> Topology:
    """The reference's topology (``repro/launch/dryrun.py:41``) on one card:
    16 stages, remat, 8 loss chunks, and the long-context decode under the
    reference's rule (decode, global batch 1, not an SSM). One card has no
    data axis, so ``num_micro`` is min(target, global batch) where the
    reference takes min(target, global batch / 16): the same for
    train_4k (16), decode_32k (4) and long_500k (1), but 4 micro-batches for
    prefill_32k where the reference has 2."""
    if multi_pod:
        raise NotImplementedError(f"--multi-pod {MULTI_CARD}")
    if moe_mode != "gathered":
        raise NotImplementedError(f"--moe-mode {moe_mode} {MULTI_CARD}")
    if not zero3:
        raise NotImplementedError(f"--no-zero3 {MULTI_CARD}")
    if num_micro is None:
        target = {"train": 16, "prefill": 4, "decode": 4}[shape.kind]
        num_micro = max(min(target, shape.global_batch), 1)
    long_context = shape.kind == "decode" and shape.global_batch == 1 and cfg.arch_type != "ssm"
    return Topology(num_stages=16, num_micro=num_micro, remat=remat, loss_chunks=8,
                    long_context=long_context)


def build_step(cfg, shape, topo, *, device="meta", dtype=torch.float32):
    """``(step, inputs)``: the step of ``shape.kind`` and its arguments —
    params (``abstract_params`` on meta), the Adam state (training) or the
    cache (serving) and the batch — on ``device``. A decode batch's
    ``pos`` is the last position of ``shape.seq_len``, a Python int."""
    if device == "meta":
        params = abstract_params(cfg, topo.num_stages, dtype)
    else:
        params = init_params(cfg, num_stages=topo.num_stages, dtype=dtype, device=device)
    batch = {name: torch.zeros(spec_shape, dtype=spec_dtype, device=device)
             for name, (spec_shape, spec_dtype) in batch_specs(cfg, shape).items()}
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


def run_one(arch: str, shape_name: str, *, out_dir: str | None, num_micro: int | None = None,
            remat: bool = True, multi_pod: bool = False, moe_mode: str = "gathered",
            zero3: bool = True, verbose: bool = True, tag: str = "") -> dict:
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    hw = HW.of(CARD)
    topo = topology_for(cfg, shape, num_micro=num_micro, remat=remat, multi_pod=multi_pod,
                        moe_mode=moe_mode, zero3=zero3)
    t0 = time.perf_counter()
    step, inputs = build_step(cfg, shape, topo)
    counter = count_step(step, inputs)
    del step, inputs
    count_s = time.perf_counter() - t0
    counts = counter.report()
    coll = collective_bytes(counts["collectives"])
    device_bytes = counts["bytes"]["aten"] + sum(counts["bytes"]["kernels"].values())
    mf = model_flops(cfg, shape, training=shape.kind == "train")
    report = roofline_report(aten_flops=counts["flops"]["aten"],
                             kernel_ops=counts["flops"]["kernels"], device_bytes=device_bytes,
                             device_collective=coll, chips=1, model_flops_global=mf, hw=hw)
    peak = counts["memory"]["peak_bytes"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "1 card",
        "card": hw.name,
        "chips": 1,
        "kind": shape.kind,
        "num_micro": topo.num_micro,
        "num_stages": topo.num_stages,
        "long_context": topo.long_context,
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
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} on one {hw.name} (meta): counted in "
              f"{count_s:.1f} s, peak {result['memory']['peak_estimate_gib']} GiB "
              f"({'fits' if result['memory']['fits'] else 'does not fit'} "
              f"{result['memory']['card_gib']} GiB), aten {counts['flops']['aten']:.4g} FLOPs, "
              f"kernels {counts['flops']['kernels']}, {device_bytes:.4g} B moved, calls "
              f"{counts['kernel_calls']}, dominant {report['dominant']} "
              f"({report['bound_s']:.4g} s)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__1card{suffix}.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1)
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
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
    # the flags of several cards refuse before any step is built
    topology_for(get_arch(combos[0][0]), get_shape(combos[0][1]), multi_pod=args.multi_pod,
                 moe_mode=args.moe_mode, zero3=not args.no_zero3)
    failures = []
    t0 = time.perf_counter()
    for arch, shape in combos:
        try:
            run_one(arch, shape, out_dir=args.out, num_micro=args.num_micro,
                    remat=not args.no_remat, tag=args.tag)
        except Exception as e:  # noqa: BLE001 — report and continue
            failures.append((arch, shape, repr(e)))
            print(f"[dryrun] FAIL {arch} × {shape}: {e}")
            traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} failures: {[(a, s) for a, s, _ in failures]}")
        raise SystemExit(1)
    print(f"[dryrun] all {len(combos)} combinations counted on meta in "
          f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
