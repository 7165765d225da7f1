"""End-to-end training entry point on a CUDA card (``--mode gnn``).

    PYTHONPATH=src python -m repro_torch.launch.train --mode gnn \\
        --dataset cora --epochs 300 --stages 4 --chunks 4 \\
        --strategy halo --schedule 1f1b --backend pallas

Counterpart of ``repro.launch.train``: the paper's experiment, GAT node
classification on the citation datasets, single-device (``--stages 1``,
``train.loop.train``) or pipelined on the host GPipe engine with a chunking
strategy (paper-faithful ``sequential`` or exact ``halo``) under any
``--schedule``. Under ``--backend pallas``/``kernel`` the GAT aggregation
runs the hand-written CUDA kernel (the bucket kernel on the pipeline's
degree-bucketed chunks, the padded one in the full-graph eval), with
attention dropout off. It prints the JAX launcher's result dict and runs on
``cuda`` unless ``--device cpu`` is given; with no card it raises.

Not ported yet, and raising by name: streamed datasets (ROADMAP queue 1,
item 12), ``--engine compiled`` (item 9), ``--auto`` and ``--partition
profiled`` (item 10), ``--mode lm`` (item 16).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.cli import PipelineCLIConfig, add_pipeline_args, resolve_device

# the JAX package's streamed power-law graphs (graphs/datasets.py)
STREAMED_DATASETS = ("powerlaw-64k", "powerlaw-256k", "powerlaw-1m")


def run_gnn(args) -> dict:
    """Train the paper GAT as the flags say; returns (and prints) the
    result dict."""
    from repro_torch.core.microbatch import make_plan
    from repro_torch.core.pipeline import make_engine
    from repro_torch.graphs.datasets import load_dataset
    from repro_torch.models.gnn.net import build_paper_gat
    from repro_torch.train.loop import train

    if args.dataset in STREAMED_DATASETS:
        raise NotImplementedError(
            f"streamed dataset {args.dataset!r} is not ported to repro_torch yet "
            "(ROADMAP queue 1, item 12)"
        )
    # the flag bundle first: unported flags and a missing card raise before
    # any work
    cli = PipelineCLIConfig.from_args(args)
    device = resolve_device(cli.device)
    host_graph = load_dataset(args.dataset, seed=args.seed)  # plans are built on the host
    g = host_graph.to(device)
    gat_kwargs = {}
    if args.backend in ("pallas", "kernel"):
        # the fused GAT kernel is deterministic; training it with the
        # paper's attention dropout would raise in gat_layer — opt out
        # explicitly and say so, instead of silently zeroing the rate
        print(f"[gnn] {args.backend} backend: attention dropout disabled "
              "(fused kernel is deterministic)")
        gat_kwargs["attn_dropout"] = 0.0
    model = build_paper_gat(g.num_features, g.num_classes, backend=args.backend, **gat_kwargs)

    if args.stages <= 1:
        res = train(model, g, epochs=args.epochs, seed=args.seed, log_every=args.log_every)
        out = {
            "mode": "single",
            "val_acc": res.val_acc,
            "test_acc": res.test_acc,
            "train_loss": res.train_loss,
            "avg_epoch_s": res.avg_epoch_s,
            "first_epoch_s": res.first_epoch_s,
            "device": str(device),
        }
        print(out)
        return out

    plan = make_plan(host_graph, args.chunks, strategy=args.strategy, halo_hops=2, seed=args.seed)
    balance = cli.uniform_balance()
    pipe = make_engine(model, cli.gpipe_config(balance))
    print(f"[gnn] engine={cli.engine} device={device} stages={args.stages} chunks={args.chunks} "
          f"strategy={plan.strategy} schedule={cli.schedule} balance={balance} "
          f"edge_cut={plan.edge_cut:.3f} rebuild_s={plan.rebuild_seconds:.3f} "
          f"bubble={pipe.describe()['bubble_fraction']:.2f}")
    return _train_pipeline(args, g, model, plan, pipe, cli=cli, balance=balance)


def _train_pipeline(args, g, model, plan, pipe, *, cli, balance) -> dict:
    """Epochs over ``pipe.train_step`` with the full-graph ``make_eval``,
    and the result dict the JAX launcher prints."""
    from repro_torch.models.gnn.net import fold_in
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import make_eval, synchronize

    params = pipe.init_params(args.seed)
    optimizer = opt_lib.adam(5e-3, weight_decay=5e-4)
    opt_state = optimizer.init(params)
    evaluate = make_eval(model)

    times, losses = [], []
    sched_stats: dict = {}
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        params, opt_state, loss = pipe.train_step(
            params, opt_state, plan, fold_in(args.seed, epoch), optimizer,
            stats=sched_stats if epoch == 0 else None,
        )
        synchronize(pipe.device)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if args.log_every and epoch % args.log_every == 0:
            m = evaluate(params, g)
            print(f"epoch {epoch:4d} loss {float(loss):.4f} val {float(m['val_acc']):.3f}")
    m = evaluate(params, g)
    out = {
        "mode": f"gpipe-{plan.strategy}",
        "engine": cli.engine,
        "schedule": cli.schedule,
        "partition": cli.partition,
        "balance": list(balance),
        "chunks": args.chunks,
        "edge_cut": plan.edge_cut,
        "bubble_fraction": sched_stats.get("bubble_fraction"),
        "peak_live_activations": sched_stats.get("measured_peak_live_activations"),
        "peak_live_accounted": sched_stats.get("peak_live_activations"),
        "train_loss": float(m["train_loss"]),
        "train_acc": float(m["train_acc"]),
        "val_acc": float(m["val_acc"]),
        "test_acc": float(m["test_acc"]),
        "first_epoch_s": times[0],
        "avg_epoch_s": float(np.mean(times[1:])) if len(times) > 1 else times[0],
        # the median is the typical step; a few host hiccups inflate the mean
        "median_epoch_s": float(np.median(times[1:])) if len(times) > 1 else times[0],
        "rebuild_s": plan.rebuild_seconds,
        "epoch_losses": losses,
        "device": str(pipe.device),
    }
    print(out)
    return out


def build_parser() -> argparse.ArgumentParser:
    """The entry point's flags: the JAX launcher's ``--mode gnn`` set plus
    ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["gnn", "lm"], default="gnn")
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--strategy", default="sequential")
    # --engine/--schedule/--stages/--chunks/--pipe-devices/--partition/
    # --placement/--backend/--device
    add_pipeline_args(ap)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "lm":
        raise NotImplementedError(
            "--mode lm (the transformer pool) is not ported to repro_torch yet "
            "(ROADMAP queue 1, item 16)"
        )
    return run_gnn(args)


if __name__ == "__main__":
    main()
