"""The paper's experiment in miniature, on ``repro_torch``: GPipe the GAT
across 4 stages and compare micro-batching strategies — the faithful lossy
``sequential`` split vs the exact ``halo`` batching — then the same model
under each pipeline schedule (fill-drain / 1F1B / interleaved): validation
accuracy is identical by construction while the bubble fraction and
live-activation footprint shrink. Finally the halo config reruns on the
compiled engine (one CUDA-graph replay a step on the card), under 1F1B,
ZB-H1, ZB-V and the ``--auto`` planner. Counterpart of
``examples/pipeline_parallel_gnn.py``.

    PYTHONPATH=src python examples/torch/pipeline_parallel_gnn.py [--dataset cora] [--device cpu]

``--device`` defaults to ``cuda``.
"""

import argparse

from repro_torch.core.schedule import get_schedule
from repro_torch.launch.train import build_parser, run_gnn


def print_schedule_matrix(stages=4, pipe_devices=2, chunk_counts=(2, 4, 8)):
    """Bubble fraction / peak live activations per (schedule, chunks)."""
    print(f"\nschedule matrix (S={stages} stages, interleaved on "
          f"D={pipe_devices} devices => V={stages // pipe_devices} virtual/device):")
    print(f"  {'schedule':<12} {'chunks':>6} {'ticks':>6} {'bubble':>8} {'peak_live':>10}")
    for name, kw in (("fill_drain", {}), ("1f1b", {}),
                     ("interleaved", {"num_devices": pipe_devices}),
                     ("zb-h1", {}),
                     ("zb-v", {"num_devices": pipe_devices})):
        sched = get_schedule(name, **kw)
        for chunks in chunk_counts:
            try:
                d = sched.describe(stages, chunks)
            except ValueError:
                continue  # interleaved needs chunks % devices == 0
            print(f"  {name:<12} {chunks:>6} {d['ticks']:>6} "
                  f"{d['bubble_fraction']:>8.3f} {d['peak_live_activations']:>10}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    def run(*, strategy="sequential", stages=1, chunks=1, **flags):
        argv = ["--mode", "gnn", "--dataset", args.dataset, "--strategy", strategy,
                "--epochs", str(args.epochs), "--seed", "0", "--log-every", "0",
                "--stages", str(stages), "--chunks", str(chunks), "--pipe-devices", "2",
                "--device", args.device]
        for name, value in flags.items():
            flag = "--" + name.replace("_", "-")
            argv += [flag] if value is True else [flag, str(value)]
        return run_gnn(build_parser().parse_args(argv))

    print("== full batch (single device) ==")
    full = run()
    print("== GPipe 4 stages, 4 chunks, SEQUENTIAL split (paper-faithful) ==")
    seq = run(stages=4, chunks=4, strategy="sequential")
    print("== GPipe 4 stages, 4 chunks, HALO batching (beyond-paper fix) ==")
    halo = run(stages=4, chunks=4, strategy="halo")
    print("== same halo config under 1F1B (identical update, less memory) ==")
    halo_1f1b = run(stages=4, chunks=4, strategy="halo", schedule="1f1b")
    print("== ... and interleaved 1F1B (2 devices x 2 virtual stages) ==")
    halo_il = run(stages=4, chunks=4, strategy="halo", schedule="interleaved")
    print("== same halo config on the COMPILED engine (one program a step) ==")
    halo_c = run(stages=4, chunks=4, strategy="halo", engine="compiled")
    print("== ... and 1F1B INSIDE the compiled program (scheduled executor) ==")
    halo_c1 = run(stages=4, chunks=4, strategy="halo", engine="compiled", schedule="1f1b")
    print("== ... and zero-bubble ZB-H1 (split B/W backward, deferred weight grads) ==")
    halo_zb = run(stages=4, chunks=4, strategy="halo", engine="compiled", schedule="zb-h1")
    print("== ... and ZB-V (split backward + 2 virtual stages/device) ==")
    halo_zbv = run(stages=4, chunks=4, strategy="halo", engine="compiled", schedule="zb-v")
    print("== --auto: the planner picks schedule/chunks/balance/placement ==")
    auto = run(stages=4, strategy="halo", engine="compiled", auto=True)

    print("\nsummary (val accuracy):")
    print(f"  full batch               {full['val_acc']:.3f}")
    print(f"  gpipe sequential         {seq['val_acc']:.3f}   edges lost: {seq['edge_cut']:.0%}")
    print(f"  gpipe halo               {halo['val_acc']:.3f}   edges lost: 0%")
    print(f"  gpipe halo / 1f1b        {halo_1f1b['val_acc']:.3f}   "
          f"peak_live {halo_1f1b['peak_live_activations']} vs {halo['peak_live_activations']}")
    print(f"  gpipe halo / interleaved {halo_il['val_acc']:.3f}   "
          f"bubble {halo_il['bubble_fraction']:.3f} vs {halo['bubble_fraction']:.3f}")
    print(f"  compiled engine (halo)   {halo_c['val_acc']:.3f}   "
          f"epoch {halo_c['avg_epoch_s'] * 1e3:.0f}ms vs host {halo['avg_epoch_s'] * 1e3:.0f}ms")
    print(f"  compiled halo / 1f1b     {halo_c1['val_acc']:.3f}   "
          f"peak_live {halo_c1['peak_live_activations']} "
          f"(stash accounting) vs fill-drain {4 * 4}")
    print(f"  compiled halo / zb-h1    {halo_zb['val_acc']:.3f}   "
          f"bubble {halo_zb['bubble_fraction']:.3f} vs 1f1b "
          f"{halo_c1['bubble_fraction']:.3f}, peak_live "
          f"{halo_zb['peak_live_activations']}")
    print(f"  compiled halo / zb-v     {halo_zbv['val_acc']:.3f}   "
          f"bubble {halo_zbv['bubble_fraction']:.3f} "
          f"(2 virtual stages/device + split B/W)")
    print(f"  compiled halo / --auto   {auto['val_acc']:.3f}   "
          f"picked {auto['schedule']}/chunks{auto['chunks']} "
          f"predicted {auto['predicted_step_s'] * 1e3:.1f}ms "
          f"measured {auto['median_epoch_s'] * 1e3:.1f}ms")
    print_schedule_matrix()
    return {"full": full, "sequential": seq, "halo": halo, "auto": auto}


if __name__ == "__main__":
    main()
