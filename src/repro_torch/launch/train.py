"""End-to-end training entry point on a CUDA card (``--mode gnn``).

    PYTHONPATH=src python -m repro_torch.launch.train --mode gnn \\
        --dataset cora --epochs 300 --stages 4 --chunks 4 \\
        --strategy halo --schedule 1f1b --backend pallas

Counterpart of ``repro.launch.train``: the paper's experiment, GAT node
classification on the citation datasets, single-device (``--stages 1``,
``train.loop.train``) or pipelined with a chunking strategy (paper-faithful
``sequential`` or exact ``halo``) under any ``--schedule``, on the host
GPipe engine or, with ``--engine compiled``, as one CUDA-graph replay per
step (evaluated through the engine's compiled eval program over the plan,
as the JAX launcher does). Under ``--backend pallas``/``kernel`` the GAT aggregation
runs the hand-written CUDA kernel (the bucket kernel on the pipeline's
degree-bucketed chunks, the padded one in the full-graph eval), with
attention dropout off; ``--backend dense`` aggregates over a masked (n, n)
adjacency. ``--partition profiled`` measures each layer's cost on the card
and picks the balance that minimizes the schedule's predicted step;
``--auto`` plans schedule, chunks, balance and placement at once
(``--dry-run`` prints the ranked table and stops). It prints the JAX
launcher's result dict and runs on ``cuda`` unless ``--device cpu`` is
given; with no card it raises.

The streamed power-law graphs (``--dataset powerlaw-64k``/``-256k``/``-1m``,
``--num-nodes``, ``--max-degree``) train on the pipeline path only: the plan
is generated chunk by chunk on the host (``streamed_plan``), the model takes
its shapes from the first chunk, ``--strategy`` is ignored, and both engines
evaluate over the plan, since no full graph exists:

    PYTHONPATH=src python -m repro_torch.launch.train --mode gnn \
        --dataset powerlaw-1m --stages 4 --chunks 8 --backend pallas \
        --engine compiled

Across cards, ``torchrun`` starts one process per card and the compiled
engine runs one ring position per rank (``core.ranks``; NCCL, or gloo with
``--device cpu``), bit-identical to one card; rank 0 prints the result:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --mode gnn --dataset cora --stages 4 --chunks 8 --backend pallas \
        --engine compiled --schedule 1f1b

``--mode lm`` trains the LM pool (``run_lm``, the JAX launcher's other
mode; default arch mamba2-130m) on synthetic token batches: the dense GQA
archs, musicgen-large and qwen2-vl-2b (precomputed frontend embeddings
ahead of the tokens; qwen2-vl with m-rope), mamba2-130m, the zamba2
hybrid, and the MoE archs arctic-480b and deepseek-v3-671b (MLA and the
multi-token-prediction head), under ``--schedule fill_drain`` or
``interleaved`` (``--stages`` virtual stages walked on the one card). Its
archs run their smoke config unless ``--full-arch`` is given; on the card
attention runs the flash kernel and Mamba's scan the SSD kernel, in the
forward and in each recompute:

    PYTHONPATH=src python -m repro_torch.launch.train --mode lm \
        --arch mamba2-130m --full-arch --stages 2 --chunks 2 --steps 50

Under torchrun the LM step runs one ring position per rank
(``core.cli.join_lm_ring``): the world must be a multiple dp of the ring's
positions, ``--stages`` under fill_drain or ``--pipe-devices`` (default:
the largest divisor of ``--stages`` the world holds, as the reference
picks it) under interleaved, each rank then holding virtual stages
{v·D + d}. dp > 1 is the reference's data axis: replica r trains rows
``[r·B/dp, (r+1)·B/dp)`` of each batch, with ZeRO-3-split blocks and
ZeRO-1-split ``embed``/``head`` moments, and MoE in its ``gathered`` mode
(the reference launcher's defaults). Each rank draws and trains only its
own rows and shards, bit for bit the one-process step's; rank 0 prints the
result:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --mode lm --arch codeqwen1.5-7b --full-arch --stages 4 --chunks 4 --steps 4
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --mode lm --arch codeqwen1.5-7b --stages 2 --steps 3 --seq 64 --batch 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core import ranks
from repro_torch.core.cli import (
    PipelineCLIConfig,
    add_pipeline_args,
    join_lm_ring,
    join_ranks,
    log_overlap,
    resolve_device,
)


def run_gnn(args) -> dict:
    """Train the paper GAT as the flags say; returns (and, on rank 0 or
    alone, prints) the result dict. Under torchrun (``WORLD_SIZE`` > 1)
    every rank joins the process group and the compiled engine runs one
    ring position per rank (``core.ranks``)."""
    # the flag bundle first: unported flags and a missing card raise before
    # any work
    cli = PipelineCLIConfig.from_args(args)
    joined = join_ranks(cli)
    try:
        return _run_gnn(args, cli, joined)
    finally:
        ranks.leave(joined)


def _run_gnn(args, cli, joined) -> dict:
    from repro_torch.core.microbatch import make_plan
    from repro_torch.core.pipeline import make_engine
    from repro_torch.graphs import STREAMED_DATASETS, load_dataset, open_streamed, streamed_plan
    from repro_torch.models.gnn.net import build_paper_gat
    from repro_torch.train.loop import train

    device = joined.device if joined is not None else resolve_device(cli.device)
    if ranks.is_leader():
        log_overlap(cli)
    streamed = args.dataset in STREAMED_DATASETS
    if streamed:
        # a streamed graph never exists whole: the pipeline path is its only
        # consumer, chunks are generated block by block on the host, and
        # evaluation runs over the plan
        if args.stages <= 1:
            raise ValueError(
                f"streamed dataset {args.dataset!r} requires the pipeline path (--stages > 1)"
            )
        if cli.auto:
            raise ValueError(
                "--auto profiles representative chunks of the full graph; "
                "streamed datasets have no full-graph batch to plan over"
            )
        stream_plan = streamed_plan(
            open_streamed(args.dataset, seed=args.seed, num_nodes=args.num_nodes),
            args.chunks,
            max_degree=args.max_degree,
        )
        host_graph = g = stream_plan.batches[0].graph  # the model's shapes only
    else:
        host_graph = load_dataset(args.dataset, seed=args.seed)  # plans are built on the host
        g = host_graph.to(device)
    gat_kwargs = {}
    if args.backend in ("pallas", "kernel"):
        # the fused GAT kernel is deterministic; training it with the
        # paper's attention dropout would raise in gat_layer — opt out
        # explicitly and say so, instead of silently zeroing the rate
        if ranks.is_leader():
            print(f"[gnn] {args.backend} backend: attention dropout disabled "
                  "(fused kernel is deterministic)")
        gat_kwargs["attn_dropout"] = 0.0
    model = build_paper_gat(g.num_features, g.num_classes, backend=args.backend, **gat_kwargs)

    if args.stages <= 1:
        if joined is not None:
            raise ValueError("--stages 1 trains on one device; under torchrun pass --stages > 1")
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

    if cli.auto:
        # self-tuning planner: profile -> enumerate -> predict -> pick; the
        # pick overrides --schedule/--chunks/--partition/--placement. On
        # ranks rank 0 profiles and every rank takes the same plan.
        from repro_torch.core.autotune import plan_for_cli

        auto_plan = plan_for_cli(
            model, host_graph, cli,
            strategy=args.strategy,
            seed=args.seed,
            cache_path=getattr(args, "cost_cache", None),
            costs_by_chunks=getattr(args, "costs_by_chunks", None),
            device=device,
        )
        table_sha = table_digest(auto_plan.table())
        if ranks.is_leader():
            if auto_plan.costs is not None:
                _print_costs(auto_plan.costs, f"chunks={auto_plan.chunks}")
            print(auto_plan.format_table(limit=10))
        if cli.dry_run:
            out = {
                "mode": "auto-dry-run",
                "schedule": auto_plan.schedule,
                "chunks": auto_plan.chunks,
                "balance": list(auto_plan.balance),
                "predicted_step_s": auto_plan.predicted_step_s,
                "evaluated": auto_plan.evaluated,
                # the pick's per-layer costs (seconds per chunk)
                "layer_costs": auto_plan.costs.table() if auto_plan.costs else None,
            }
            if ranks.active():
                out.update(ranks=ranks.world_size(), plan_sha=table_sha)
            if ranks.is_leader():
                print(out)
            return out
        cli = dataclasses.replace(cli, schedule=auto_plan.schedule, chunks=auto_plan.chunks,
                                  partition="auto")
        plan = make_plan(host_graph, auto_plan.chunks, strategy=args.strategy, halo_hops=2,
                         seed=args.seed)
        pipe = make_engine(model, auto_plan.to_config(device=str(device)))
        _log_engine(cli, device, plan, pipe, auto_plan.balance,
                    f" predicted_step={auto_plan.predicted_step_s * 1e3:.2f}ms")
        return _train_pipeline(args, g, model, plan, pipe, cli=cli, balance=auto_plan.balance,
                               predicted_step_s=auto_plan.predicted_step_s,
                               plan_sha=table_sha)

    if streamed:
        plan = stream_plan
    else:
        plan = make_plan(host_graph, args.chunks, strategy=args.strategy, halo_hops=2,
                         seed=args.seed)
    plan_sha = predicted = None
    if cli.partition == "profiled":
        balance, plan_sha, predicted = profiled_balance(
            model, plan.stacked().graph.chunk(0).to(device), cli, seed=args.seed,
            cost_cache=getattr(args, "cost_cache", None),
            layer_costs=getattr(args, "layer_costs", None), detail=True,
        )
    else:
        balance = cli.uniform_balance()
    pipe = make_engine(model, cli.gpipe_config(balance, device=device))
    _log_engine(cli, device, plan, pipe, balance)
    return _train_pipeline(args, g, model, plan, pipe, cli=cli, balance=balance,
                           predicted_step_s=predicted, plan_sha=plan_sha)


def table_digest(rows) -> str:
    """A short digest of a plan's table (its rows as JSON): what each rank
    prints to show that every rank took the same plan."""
    import hashlib
    import json

    return hashlib.sha1(json.dumps(rows, sort_keys=True).encode()).hexdigest()[:16]


def profiled_balance(model, chunk, cli, *, seed=0, cost_cache=None, layer_costs=None,
                     detail=False):
    """``--partition profiled``: the contiguous balance over ``cli.stages``
    that minimizes the schedule's predicted step under per-layer fwd/B/W
    costs measured on ``chunk`` (one padded chunk, the shape the engines
    dispatch per tick, on the device), or under ``layer_costs`` when a
    caller hands them in. Rank 0 (or the only process) prints the cost
    table and the pick. On ranks rank 0 alone profiles (and reads and
    writes ``cost_cache``), its costs reach every rank by one broadcast,
    and a gather raises unless every rank's table and pick equal rank 0's.
    With ``detail``, ``(balance, the table's digest, the predicted step
    seconds)``."""
    from repro_torch.core.costmodel import cached_profile_layer_costs, choose_balance
    from repro_torch.core.schedule import get_schedule

    def measure():
        if layer_costs is not None:
            return layer_costs
        return cached_profile_layer_costs(
            model, model.init_params(seed, device=chunk.features.device), chunk,
            backend=cli.backend, cache_path=cost_cache,
        )

    costs = ranks.from_leader(measure)
    balance, predicted = choose_balance(
        costs, cli.stages, get_schedule(cli.schedule, num_devices=cli.resolved_pipe_devices),
        cli.chunks,
    )
    table = {"costs": costs.table(), "balance": list(balance), "predicted_step_s": predicted}
    ranks.same_on_every_rank(table, "the --partition profiled table")
    if ranks.is_leader():
        _print_costs(costs)
        print(f"[gnn] profiled balance={balance} predicted_step={predicted * 1e3:.2f}ms")
    return (balance, table_digest(table), predicted) if detail else balance


def _print_costs(costs, label=""):
    print(f"[gnn] per-layer profile (ms/chunk{', ' + label if label else ''}):")
    for row in costs.table():
        print(f"  {row['layer']:2d} {row['name']:<14s} "
              f"fwd {row['fwd_s'] * 1e3:7.3f}  B {row['bwd_b_s'] * 1e3:7.3f}  "
              f"W {row['bwd_w_s'] * 1e3:7.3f}")


def _log_engine(cli, device, plan, pipe, balance, extra=""):
    if not ranks.is_leader():
        return
    if ranks.active():
        extra += f" ranks={ranks.world_size()}"
    print(f"[gnn] engine={cli.engine} device={device} stages={len(balance)} chunks={plan.chunks} "
          f"strategy={plan.strategy} schedule={cli.schedule} balance={balance} "
          f"edge_cut={plan.edge_cut:.3f} rebuild_s={plan.rebuild_seconds:.3f} "
          f"bubble={pipe.describe()['bubble_fraction']:.2f}{extra}")


def _train_pipeline(args, g, model, plan, pipe, *, cli, balance, predicted_step_s=None,
                    plan_sha=None) -> dict:
    """Epochs over ``pipe.train_step`` with the full-graph ``make_eval`` (the
    compiled engine, and any engine on a streamed plan: the eval program
    over the plan's core nodes), and the result dict the JAX launcher prints
    (with ``predicted_step_s`` for an ``--auto`` plan)."""
    from repro_torch.models.gnn.net import fold_in
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import make_eval, synchronize

    params = pipe.init_params(args.seed)
    optimizer = opt_lib.adam(5e-3, weight_decay=5e-4)
    opt_state = optimizer.init(params)
    if cli.engine == "compiled" or plan.strategy == "streamed":
        evaluate = lambda p, _g: pipe.evaluate(p, plan)  # noqa: E731
    else:
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
            if ranks.is_leader():
                print(f"epoch {epoch:4d} loss {float(loss):.4f} val {float(m['val_acc']):.3f}")
    m = evaluate(params, g)
    out = {
        "mode": f"gpipe-{plan.strategy}",
        "engine": cli.engine,
        "schedule": cli.schedule,
        "overlap": cli.overlap,
        "wire_latency": sched_stats.get("wire_latency"),
        "partition": cli.partition,
        "balance": list(balance),
        "chunks": plan.chunks,
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
    if predicted_step_s is not None:
        out["predicted_step_s"] = predicted_step_s
    if plan_sha is not None:
        out["plan_sha"] = plan_sha
    if ranks.active():
        out["ranks"] = ranks.world_size()
    if ranks.is_leader():
        print(out)
    return out


@dataclasses.dataclass
class TrainedLM:
    """One ``train_lm`` run: the printed summary, each step's loss and wall
    seconds (to a device synchronize), and the state it left."""

    summary: dict
    losses: list
    step_s: list
    topo: object
    step: object
    params: dict
    opt_state: object
    joined: object = None


def lm_batch(cfg, args, step: int, device):
    """Step ``step``'s batch on ``device``, as the JAX launcher draws it:
    tokens (B, seq - s_front + 1) from ``token_batch`` with ``--seed``, and
    on a frontend arch ``frontend_embeds`` (B, s_front, d) seeded with the
    step index (the launcher's ``seed=i``, not ``--seed``)."""
    import torch

    from repro_torch.data.tokens import frontend_embeds, token_batch
    from repro_torch.models.transformer.model import frontend_rows

    s_front = frontend_rows(cfg, args.seq)
    batch = {"tokens": torch.from_numpy(token_batch(
        batch=args.batch, seq=args.seq - s_front, vocab=cfg.vocab_size, seed=args.seed, step=step,
    )).to(device)}
    if s_front:
        batch["frontend_embeds"] = torch.from_numpy(frontend_embeds(
            batch=args.batch, seq=s_front, d_model=cfg.d_model, seed=step)).to(device)
    return batch


def train_lm(cfg, args, on_step=None, dtype=None) -> TrainedLM:
    """Train ``cfg`` (a built config; a caller may cut its depth) as the
    ``--mode lm`` flags say. ``on_step(i, params, opt_state, loss)`` is
    called after each step. ``dtype``: the params' (float32, the
    launcher's, by default; ``torch.bfloat16`` is the reference's own, its
    activations and hops bf16, Adam's moments and the loss float32). Under
    torchrun this rank joins the rank grid (``core.cli.join_lm_ring``;
    ``TrainedLM.joined``, which the caller leaves) and trains its own
    stage's rows of its data shard: ``params`` and ``opt_state`` are its
    shard, the losses every rank's alike."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models.transformer.model import (
        Topology, abstract_params, check_supported, held_stages, init_params, make_train_step,
    )
    from repro_torch.train.loop import synchronize
    from repro_torch.train.optimizer import tree_leaves

    check_supported(cfg)
    stages = args.stages if args.stages > 1 else 1
    schedule = "fill_drain" if args.schedule in ("fill_drain", "gpipe") else args.schedule
    if schedule not in ("fill_drain", "interleaved"):
        raise ValueError(
            f"--mode lm supports fill_drain|interleaved schedules, got {schedule!r} "
            "(1f1b/zb-h1 are GNN-engine schedules)"
        )
    if schedule == "interleaved" and stages > 1:
        # ring positions: --pipe-devices, else the largest divisor of stages
        # that fits the devices: the world's ranks under torchrun, one card
        # alone (V = stages)
        world = ranks.planned_world_size()
        pipe_dev = args.pipe_devices or max(
            d for d in range(1, min(world, stages) + 1) if stages % d == 0)
        if stages % pipe_dev:
            raise ValueError(f"--pipe-devices {pipe_dev} must divide --stages {stages}")
        num_virtual = stages // pipe_dev
    else:
        schedule, pipe_dev, num_virtual = "fill_drain", stages, 1
    joined, grid = join_lm_ring(pipe_dev, args.device)
    device = joined.device if joined is not None else resolve_device(args.device)
    num_micro = args.chunks
    if schedule == "interleaved" and num_micro < pipe_dev:
        num_micro = pipe_dev  # the ring needs C >= devices
        print(f"[lm] bumping --chunks to {num_micro} (interleaved needs >= --pipe-devices)")
    data = 1 if grid is None else grid.dp
    b_local = max(args.batch // data, 1)
    if b_local % num_micro:
        raise ValueError(
            f"micro-batch count {num_micro} must divide the per-device batch "
            f"{b_local} (--batch {args.batch} over {data} data shards)"
        )
    topo = Topology(num_stages=stages, num_micro=num_micro, loss_chunks=min(4, args.batch),
                    schedule=schedule, num_virtual=num_virtual, data=data, ring=grid)
    if schedule == "interleaved" and ranks.is_leader():
        print(f"[lm] schedule=interleaved stages={stages} devices={pipe_dev} "
              f"virtual/device={num_virtual} micro={num_micro}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step = make_train_step(cfg, topo, ShapeConfig("cli", args.seq, args.batch, "train"),
                           lr=args.lr)
    params = init_params(cfg, seed=args.seed, num_stages=stages, device=device, topo=topo,
                         stages=None if grid is None else held_stages(topo, grid.position),
                         data_rank=None if grid is None else grid.replica,
                         dtype=torch.float32 if dtype is None else dtype)
    opt_state = step.optimizer.init(params)

    losses, times = [], []
    for i in range(args.steps):
        batch = lm_batch(cfg, args, i, device)
        synchronize(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        loss = float(metrics["loss"])
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        if on_step is not None:
            on_step(i, params, opt_state, loss)
        if args.log_every and i % args.log_every == 0 and ranks.is_leader():
            print(f"step {i:4d} loss {loss:.4f} ({times[-1]:.2f}s)")
    if not np.isfinite(losses).all():
        raise AssertionError("training diverged")
    # each loss is taken before its step's update: the last update is read here
    if not all(bool(p.isfinite().all()) for p in tree_leaves(params)):
        raise AssertionError("training diverged: the last update left non-finite params")
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None
    per_rank = ranks.gathered({"peak": peak})
    summary = {
        "arch": cfg.name,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "improved": bool(losses[-1] < losses[0]),
        "avg_step_s": float(np.mean(times[1:])) if len(times) > 1 else times[0],
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "peak_mem_gb": peak,
        "params": sum(int(p.numel()) for p in tree_leaves(abstract_params(cfg, stages))),
    }
    if grid is not None:
        summary["ranks"] = len(per_rank)
        summary["data_parallel"] = grid.dp
        summary["peak_mem_gb_per_rank"] = [r["peak"] for r in per_rank]
        summary["losses"] = losses
    return TrainedLM(summary, losses, times, topo, step, params, opt_state, joined)


def run_lm(args) -> dict:
    """Train the LM pool as the flags say; returns (and prints) the result
    dict: the JAX launcher's keys plus ``device``, ``device_name``,
    ``peak_mem_gb`` (None on the CPU) and ``params``. Under torchrun rank 0
    alone prints, adding ``ranks``, ``peak_mem_gb_per_rank`` and every
    step's loss."""
    from repro_torch.configs import get_arch

    trained = train_lm(get_arch(args.arch, smoke=not args.full_arch), args)
    if ranks.is_leader():
        print(trained.summary)
    ranks.leave(trained.joined)
    return trained.summary


def build_parser() -> argparse.ArgumentParser:
    """The entry point's flags: the JAX launcher's set plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=["gnn", "lm"], default="gnn")
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--full-arch", action="store_true", help="use the full (not smoke) config")
    ap.add_argument("--strategy", default="sequential")
    # --engine/--schedule/--stages/--chunks/--pipe-devices/--partition/
    # --placement/--backend/--device
    add_pipeline_args(ap)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--num-nodes", type=int, default=None,
                    help="streamed datasets only: override the registry node count")
    ap.add_argument("--max-degree", type=int, default=32,
                    help="streamed datasets only: neighbor-slot cap per node")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "lm":
        return run_lm(args)
    return run_gnn(args)


if __name__ == "__main__":
    main()
