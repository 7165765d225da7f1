"""Batched GNN serving on a CUDA card: shape-bucketed ego-subgraph inference
through the pipeline engine's eval programs.

    PYTHONPATH=src python -m repro_torch.launch.serve_gnn --dataset cora \\
        --backend kernel --engine compiled --stages 4 --chunks 4 --verify

Counterpart of ``repro.launch.serve_gnn``. A synthetic open-loop arrival
process (Poisson at ``--qps``) emits node-classification and
link-prediction queries. Each query is served from its seeds' ``--hops``-hop
**ego-subgraph**; with ``--hops`` >= the model's receptive depth (2 for the
paper GAT) the halo is lossless, so ``--verify`` can hold every served
prediction against a full-graph forward on the same device.

Ego extraction and padding stay on the host. Ego-subgraphs are padded into
a static node-count ladder (``ShapeBuckets``; neighbor width is always the
full graph's ``max_degree``); same-bucket requests batch together,
``--chunks`` per dispatch, and each stacked batch moves to the device in
``GNNServer.execute``. The result comes back with ``.cpu()``, which waits
for the device, so latency covers the device work. Under ``--backend
kernel`` every GAT aggregation runs the hand-written CUDA kernel. Under
``--engine compiled`` (the default) each node-count bucket's eval program
is one CUDA graph, captured at warmup: a call copies the batch into the
bucket's static inputs and replays it. ``--auto`` serves on the plan the
planner ranks first (``--dry-run`` prints the ranking and stops) and
``--partition profiled`` on the measured balance, as in training.
``--overlap`` is accepted as in training; the eval programs run the
forward wave at wire latency 1 whatever it says, as the reference's do.

Under torchrun (``WORLD_SIZE`` > 1) the compiled engine's eval programs
run on the ring of ranks (``core.ranks``), and every rank must call each
of them in lockstep, while open-loop batching reads the wall clock, which
the ranks do not share. So rank 0 forms each batch and broadcasts a small
int tensor (``RankLockstep``: the batch's query ids and its bucket, or a
stop mark); every rank builds the same ego-subgraph batch from its own
copy of the graph and runs the eval ring, and rank 0 answers, verifies and
prints:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve_gnn \
        --dataset cora --backend kernel --stages 4 --chunks 4 --verify

The driver reports achieved queries/s, p50/p99 latency (completion minus
scheduled arrival, queueing included) and per-bucket batch occupancy; with
``--json-out`` it writes ``BENCH_serve.json`` and ``latency_hist.json`` with
the JAX driver's keys. It runs on ``cuda`` unless ``--device cpu`` is
given, and raises if there is no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import ranks
from repro_torch.graphs.data import GraphBatch, pad_graph, stack_graphs, to_numpy
from repro_torch.graphs.partition import ego_subgraph

# eval-program calls per bucket at warmup: one first call + WARM_REPS timed
WARM_REPS = 3
WARM_CALLS = 1 + WARM_REPS


@dataclasses.dataclass(frozen=True)
class Query:
    """One serving request: classify node ``u`` ("node") or score the pair
    ``(u, v)`` ("link"). ``arrival_s`` is the open-loop schedule offset."""

    qid: int
    kind: str  # "node" | "link"
    u: int
    v: int = -1
    arrival_s: float = 0.0

    @property
    def seeds(self) -> tuple[int, ...]:
        """Seed nodes whose rows the answer reads."""
        return (self.u,) if self.kind == "node" else (self.u, self.v)


@dataclasses.dataclass
class PreparedQuery:
    """A query with its bucket-padded ego-subgraph attached (on the host)."""

    query: Query
    graph: GraphBatch  # padded to (bucket size, full-graph max_degree)
    rows: tuple[int, ...]  # seed rows in the padded subgraph
    bucket: int
    ego_nodes: int  # pre-pad ego size (diagnostics)


@dataclasses.dataclass
class ServedResult:
    """One answered query and its latency."""

    query: Query
    latency_s: float
    pred: int  # node: argmax class; link: 1 iff score >= 0
    score: float  # node: max logp; link: logp_u . logp_v
    logp: np.ndarray  # (num_seeds, out_dim) — the verification surface


class ShapeBuckets:
    """A static, sorted node-count ladder; ``bucket_of(n)`` is a pure
    function of the ego size, so the number of batch shapes is bounded by
    ``len(sizes)`` whatever traffic arrives."""

    def __init__(self, sizes):
        self.sizes = tuple(sorted(set(int(s) for s in sizes)))
        if not self.sizes:
            raise ValueError("ShapeBuckets needs at least one size")

    @classmethod
    def geometric(cls, g: GraphBatch, *, base: int = 64, factor: int = 2) -> "ShapeBuckets":
        """base, base*factor, ... capped at the full graph's node count."""
        sizes, s = [], base
        while s < g.num_nodes:
            sizes.append(s)
            s *= factor
        sizes.append(g.num_nodes)
        return cls(sizes)

    def __len__(self) -> int:
        return len(self.sizes)

    def bucket_of(self, n: int) -> int:
        """Index of the smallest size that holds ``n`` nodes."""
        for i, s in enumerate(self.sizes):
            if n <= s:
                return i
        raise ValueError(f"ego of {n} nodes exceeds the largest bucket {self.sizes[-1]}")

    def size_of(self, bucket: int) -> int:
        """Node count of bucket ``bucket``."""
        return self.sizes[bucket]


class RankLockstep:
    """Rank 0's batches, announced to every rank: one broadcast of
    ``(2 + chunks,)`` int64 per batch, ``[1, bucket, qid_0, ...]`` padded
    with -1, or ``[0, ...]`` to stop. Lives on the rank's device (NCCL
    broadcasts device tensors)."""

    def __init__(self, chunks: int, device):
        self.buf = torch.full((2 + chunks,), -1, dtype=torch.int64, device=device)

    def announce(self, bucket: int, qids: list) -> None:
        """Rank 0: the next batch."""
        msg = [1, bucket] + list(qids) + [-1] * (self.buf.numel() - 2 - len(qids))
        self.buf.copy_(torch.tensor(msg, dtype=torch.int64))
        torch.distributed.broadcast(self.buf, src=0)

    def stop(self) -> None:
        """Rank 0: no more batches."""
        self.buf.fill_(0)
        torch.distributed.broadcast(self.buf, src=0)

    def receive(self):
        """Another rank: ``(bucket, qids)`` of rank 0's next batch, or None
        at the stop mark."""
        torch.distributed.broadcast(self.buf, src=0)
        msg = self.buf.tolist()
        if msg[0] == 0:
            return None
        return msg[1], [q for q in msg[2:] if q >= 0]


class GNNServer:
    """Bucketed batching frontend over a pipeline engine's eval programs:
    ``prepare`` extracts/pads one query's ego-subgraph on the host,
    ``execute`` runs up to ``chunks`` same-bucket prepared queries as one
    stacked batch on the engine's device. Params are bound to each bucket's
    ``EvalProgram`` once and stay resident on the device. With a
    ``lockstep`` (on ranks), rank 0's ``execute`` first announces the
    batch to the other ranks (``follow``)."""

    def __init__(self, engine, params, g: GraphBatch, *, hops: int = 2, buckets=None,
                 lockstep: RankLockstep | None = None):
        self.engine = engine
        self.lockstep = lockstep
        self.params = params
        self.g = g
        self.hops = hops
        self.chunks = engine.config.chunks
        self.device = engine.device
        self.buckets = buckets if buckets is not None else ShapeBuckets.geometric(g)
        self.max_deg = g.max_degree
        self.stats = {}  # bucket -> {"batches": int, "queries": int}

    def prepare(self, query: Query) -> PreparedQuery:
        """Extract and pad ``query``'s ego-subgraph (host-side)."""
        sub, rows = ego_subgraph(self.g, list(query.seeds), self.hops)
        bucket = self.buckets.bucket_of(sub.num_nodes)
        padded = pad_graph(sub, self.buckets.size_of(bucket), self.max_deg)
        return PreparedQuery(query, padded, tuple(int(r) for r in rows), bucket, sub.num_nodes)

    def _run(self, graphs) -> np.ndarray:
        batch = stack_graphs(graphs).to(self.device)
        prog = self.engine.compile_eval(self.params, batch)
        return prog(batch).cpu().numpy()  # (chunks, n_pad, out_dim); waits for the device

    def warm(self, bucket: int, probe: PreparedQuery) -> float:
        """Bind the bucket's program, run it once, then time ``WARM_REPS``
        warm calls. Returns the median warm per-batch call time in seconds."""
        graphs = [probe.graph] * self.chunks
        self._run(graphs)
        reps = []
        for _ in range(WARM_REPS):
            t0 = time.perf_counter()
            self._run(graphs)
            reps.append(time.perf_counter() - t0)
        return float(np.median(reps))

    def execute(self, prepared: list[PreparedQuery]) -> list[ServedResult]:
        """Run one same-bucket batch (1..chunks real requests; partial
        batches are padded by repeating the first request's subgraph)."""
        if not 0 < len(prepared) <= self.chunks:
            raise ValueError(f"batch of {len(prepared)} requests; chunks={self.chunks}")
        bucket = prepared[0].bucket
        if any(p.bucket != bucket for p in prepared):
            raise ValueError("execute takes requests of one bucket")
        if self.lockstep is not None and ranks.is_leader():
            self.lockstep.announce(bucket, [p.query.qid for p in prepared])
        graphs = [p.graph for p in prepared]
        graphs += [prepared[0].graph] * (self.chunks - len(prepared))
        logp = self._run(graphs)
        st = self.stats.setdefault(bucket, {"batches": 0, "queries": 0})
        st["batches"] += 1
        st["queries"] += len(prepared)
        out = []
        for i, p in enumerate(prepared):
            rows = logp[i][list(p.rows)]
            if p.query.kind == "node":
                pred, score = int(rows[0].argmax()), float(rows[0].max())
            else:
                score = float(np.dot(rows[0], rows[1]))
                pred = int(score >= 0.0)
            out.append(ServedResult(p.query, 0.0, pred, score, rows))
        return out

    def occupancy(self) -> dict:
        """Per-bucket fill: real requests / (batches * chunks)."""
        return {
            self.buckets.size_of(b): {
                "batches": st["batches"],
                "queries": st["queries"],
                "occupancy": st["queries"] / (st["batches"] * self.chunks),
            }
            for b, st in sorted(self.stats.items())
        }


def synth_queries(g: GraphBatch, n: int, *, qps: float, link_frac: float, seed: int):
    """n queries over random seed nodes with exponential inter-arrivals
    (open-loop Poisson at ``qps``); the same stream as the JAX driver's.
    Half the link queries score a real edge, half a random pair."""
    rng = np.random.default_rng(seed)
    nbr, msk = to_numpy(g.neighbors), to_numpy(g.mask)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, size=n))
    queries = []
    for qid in range(n):
        u = int(rng.integers(g.num_nodes))
        if rng.random() < link_frac:
            row = nbr[u][msk[u]]
            if rng.random() < 0.5 and len(row) > 1:
                v = int(rng.choice(row[1:]))  # slot 0 is the self-loop
            else:
                v = int(rng.integers(g.num_nodes))
            if v == u:
                v = (u + 1) % g.num_nodes
            queries.append(Query(qid, "link", u, v, float(arrivals[qid])))
        else:
            queries.append(Query(qid, "node", u, -1, float(arrivals[qid])))
    return queries


def serve(server: GNNServer, queries: list[Query], *, max_wait_s: float) -> list[ServedResult]:
    """The open-loop driver: queries become eligible at their scheduled
    arrival time; same-bucket requests batch up to ``chunks``, a partial
    batch dispatches once its oldest request has waited ``max_wait_s``.
    Latency is completion minus *scheduled* arrival (queueing included)."""
    pending: dict[int, deque] = {}
    results: list[ServedResult] = []
    n_pending = 0
    i = 0
    t0 = time.perf_counter()

    def dispatch(bucket):
        nonlocal n_pending
        q = pending[bucket]
        batch = [q.popleft() for _ in range(min(len(q), server.chunks))]
        n_pending -= len(batch)
        done = server.execute(batch)
        t_done = time.perf_counter() - t0
        for r in done:
            r.latency_s = t_done - r.query.arrival_s
        results.extend(done)

    while i < len(queries) or n_pending:
        now = time.perf_counter() - t0
        while i < len(queries) and queries[i].arrival_s <= now:
            p = server.prepare(queries[i])  # prep cost is inside the clock
            pending.setdefault(p.bucket, deque()).append(p)
            n_pending += 1
            i += 1
        # full batches first; then age out partial batches; then, once the
        # arrival stream is exhausted, drain whatever is left
        ready = [b for b, q in pending.items() if len(q) >= server.chunks]
        if not ready:
            now = time.perf_counter() - t0
            ready = [
                b for b, q in pending.items()
                if q and now - q[0].query.arrival_s >= max_wait_s
            ]
        if not ready and i >= len(queries):
            ready = [b for b, q in pending.items() if q]
        if ready:
            dispatch(ready[0])
            continue
        if i < len(queries):
            now = time.perf_counter() - t0
            wake = queries[i].arrival_s
            for q in pending.values():
                if q:
                    wake = min(wake, q[0].query.arrival_s + max_wait_s)
            if wake > now:
                time.sleep(min(wake - now, 0.05))
    return results


def follow(server: GNNServer, queries: list[Query]) -> int:
    """A rank other than 0: run each batch rank 0 announces, from the same
    query stream (``queries[qid]``), until the stop mark. Returns the
    batches run."""
    batches = 0
    while (msg := server.lockstep.receive()) is not None:
        bucket, qids = msg
        prepared = [server.prepare(queries[q]) for q in qids]
        if any(p.bucket != bucket for p in prepared):
            raise RuntimeError(f"rank 0 announced bucket {bucket}, this rank prepared another")
        server.execute(prepared)
        batches += 1
    return batches


def serve_on_ranks(server: GNNServer, queries: list[Query], *, max_wait_s: float):
    """``serve`` on rank 0 (then the stop mark), ``follow`` elsewhere.
    Returns rank 0's results, and an empty list on the other ranks."""
    if not ranks.is_leader():
        follow(server, queries)
        return []
    try:
        return serve(server, queries, max_wait_s=max_wait_s)
    finally:
        server.lockstep.stop()


def verify_results(
    model, params, g: GraphBatch, results: list[ServedResult], *, atol: float = 0.0,
    device="cpu",
) -> tuple[int, int, float]:
    """Served-vs-full-batch check on ``device``. Returns ``(mismatches,
    exact, max_diff)``: ``exact`` counts bit-identical results,
    ``mismatches`` results with any |diff| > ``atol``. On a card the
    64-row ego matmuls and the full-graph ones may take different cuBLAS
    algorithms, so bit-identity is not expected there; ``atol`` absorbs it."""
    placed = [{k: v.to(device) for k, v in p.items()} for p in params]
    with torch.inference_mode():
        full = model.apply(placed, g.to(device), train=False).cpu().numpy()
    bad = exact = 0
    max_diff = 0.0
    for r in results:
        want = full[list(r.query.seeds)]
        if np.array_equal(r.logp, want):
            exact += 1
        else:
            diff = float(np.abs(r.logp - want).max())
            max_diff = max(max_diff, diff)
            if diff > atol:
                bad += 1
    return bad, exact, max_diff


def run(args) -> dict:
    """Serve ``args.qps`` × ``args.duration`` synthetic queries; returns the
    summary dict (under torchrun: rank 0's; the other ranks return the
    batches they followed)."""
    from repro_torch.core.cli import PipelineCLIConfig, join_ranks

    cli = PipelineCLIConfig.from_args(args)
    joined = join_ranks(cli)
    try:
        return _run(args, cli, joined)
    finally:
        ranks.leave(joined)


def _run(args, cli, joined) -> dict:
    from repro_torch.core.cli import log_overlap, resolve_device
    from repro_torch.core.pipeline import make_engine
    from repro_torch.graphs import load_dataset
    from repro_torch.models.gnn.layers import canonical_backend
    from repro_torch.models.gnn.net import build_paper_gat

    # raises with no card
    device = joined.device if joined is not None else resolve_device(cli.device)
    leader = ranks.is_leader()
    if leader:
        log_overlap(cli)
    g = load_dataset(args.dataset, seed=args.seed)
    # serving is forward-only (train=False) and never applies attention
    # dropout; under the kernel backend the rate is set to 0 all the same,
    # because the planner's profile (--auto, --partition profiled) trains
    # the layers and the fused kernel refuses attention dropout in training
    kw = {"attn_dropout": 0.0} if canonical_backend(args.backend) == "kernel" else {}
    model = build_paper_gat(g.num_features, g.num_classes, backend=args.backend, **kw)
    params = model.init_params(args.seed)
    if cli.auto:
        # serving shares the planner: the pick's schedule/chunks/balance/
        # placement configure the engine whose eval programs serve traffic;
        # on ranks rank 0 profiles and every rank takes the same plan
        from repro_torch.core.autotune import plan_for_cli

        auto_plan = plan_for_cli(model, g, cli, seed=args.seed, device=device,
                                 costs_by_chunks=getattr(args, "costs_by_chunks", None))
        if leader:
            print(auto_plan.format_table(limit=10))
        if cli.dry_run:
            return {"mode": "auto-dry-run", "schedule": auto_plan.schedule,
                    "chunks": auto_plan.chunks, "balance": list(auto_plan.balance)}
        cli = dataclasses.replace(cli, schedule=auto_plan.schedule, chunks=auto_plan.chunks,
                                  stages=auto_plan.num_stages, partition="auto")
        balance = auto_plan.balance
        engine = make_engine(model, auto_plan.to_config(device=str(device)))
    else:
        if cli.partition == "profiled":
            from repro_torch.core.microbatch import make_plan
            from repro_torch.launch.train import profiled_balance

            chunk = make_plan(g, cli.chunks).stacked().graph.chunk(0).to(device)
            balance = profiled_balance(model, chunk, cli, seed=args.seed,
                                       layer_costs=getattr(args, "layer_costs", None))
        else:
            balance = cli.uniform_balance()
        engine = make_engine(model, cli.gpipe_config(balance, device=device))
    buckets = ShapeBuckets.geometric(g, base=args.bucket_base)
    lockstep = RankLockstep(cli.chunks, device) if joined is not None else None
    server = GNNServer(engine, params, g, hops=args.hops, buckets=buckets, lockstep=lockstep)

    n = max(1, int(round(args.qps * args.duration)))
    queries = synth_queries(g, n, qps=args.qps, link_frac=args.link_frac, seed=args.seed)

    # warmup: bind every bucket this query set will touch and time one warm
    # call each, outside the measured window
    probes, order = {}, []
    for q in queries:
        p = server.prepare(q)
        if p.bucket not in probes:
            probes[p.bucket] = p
            order.append(p.bucket)
    eval_call_s = {b: server.warm(b, probes[b]) for b in order}
    server.stats.clear()
    if leader:
        print(f"[serve] dataset={args.dataset} engine={cli.engine} backend={args.backend} "
              f"device={engine.device} ranks={ranks.world_size()} stages={cli.stages} "
              f"chunks={cli.chunks} hops={args.hops} "
              f"buckets={[buckets.size_of(b) for b in sorted(probes)]} "
              f"warm_call_ms={ {buckets.size_of(b): round(t * 1e3, 3) for b, t in sorted(eval_call_s.items())} }")

    if lockstep is None:
        results = serve(server, queries, max_wait_s=args.max_wait_ms / 1e3)
    else:
        results = serve_on_ranks(server, queries, max_wait_s=args.max_wait_ms / 1e3)
        if not leader:
            return {"rank": joined.rank, "followed_batches": sum(
                st["batches"] for st in server.stats.values())}
    if len(results) != n:
        raise RuntimeError(f"served {len(results)} of {n} queries")

    lat = np.array([r.latency_s for r in results])
    span = max(max(r.query.arrival_s + r.latency_s for r in results), 1e-9)
    occupancy = server.occupancy()
    total_batches = sum(v["batches"] for v in occupancy.values())
    summary = {
        "dataset": args.dataset,
        "engine": cli.engine,
        "schedule": cli.schedule,
        "overlap": cli.overlap,
        "chunks": cli.chunks,
        "stages": cli.stages,
        "partition": cli.partition,
        "balance": list(balance),
        "hops": args.hops,
        "qps": args.qps,
        "queries": n,
        "achieved_qps": n / span,
        "p50_s": float(np.percentile(lat, 50)),
        "p99_s": float(np.percentile(lat, 99)),
        "mean_s": float(lat.mean()),
        "eval_call_s": float(max(eval_call_s.values())),
        "occupancy": sum(v["queries"] for v in occupancy.values())
        / max(total_batches * server.chunks, 1),
        "buckets": occupancy,
        "backend": args.backend,
        "device": str(engine.device),
        "ranks": ranks.world_size(),
        "device_name": torch.cuda.get_device_name(engine.device)
        if engine.device.type == "cuda" else "cpu",
        "warm_buckets": len(eval_call_s),
    }
    print(f"[serve] {n} queries in {span:.2f}s: {summary['achieved_qps']:.1f} q/s "
          f"(offered {args.qps}), p50 {summary['p50_s'] * 1e3:.3f}ms "
          f"p99 {summary['p99_s'] * 1e3:.3f}ms, occupancy {summary['occupancy']:.2f}")
    for size, v in occupancy.items():
        print(f"[serve]   bucket n<={size}: {v['queries']} queries / "
              f"{v['batches']} batches (occupancy {v['occupancy']:.2f})")

    mismatches = None
    if args.verify:
        mismatches, exact, max_diff = verify_results(
            model, params, g, results, atol=args.verify_atol, device=engine.device
        )
        summary["verify_mismatches"] = mismatches
        summary["verify_exact"] = exact
        summary["verify_max_diff"] = max_diff
        print(f"[serve] verify: {exact}/{n} served predictions bit-identical "
              f"to the full-graph forward, {mismatches} beyond "
              f"atol={args.verify_atol:g} (max diff {max_diff:.3g})")

    if args.json_out:
        os.makedirs(args.json_out, exist_ok=True)
        key = f"serving/{args.dataset}/{cli.engine}/qps{args.qps:g}"
        with open(os.path.join(args.json_out, "BENCH_serve.json"), "w") as f:
            json.dump({"rows": {key: summary}}, f, indent=2, sort_keys=True)
            f.write("\n")
        counts, edges = np.histogram(lat * 1e3, bins=30)
        with open(os.path.join(args.json_out, "latency_hist.json"), "w") as f:
            json.dump({
                "unit": "ms",
                "bin_edges": [float(e) for e in edges],
                "counts": [int(c) for c in counts],
                "p50": summary["p50_s"] * 1e3,
                "p99": summary["p99_s"] * 1e3,
            }, f, indent=2)
            f.write("\n")
    if mismatches:
        raise SystemExit(f"--verify: {mismatches} served predictions diverged")
    return summary


def build_parser() -> argparse.ArgumentParser:
    """The serving CLI (the JAX driver's flags plus ``--device``)."""
    from repro_torch.core.cli import add_pipeline_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--qps", type=float, default=50.0, help="offered load (open-loop Poisson)")
    ap.add_argument("--duration", type=float, default=5.0, help="arrival window, seconds")
    ap.add_argument("--hops", type=int, default=2,
                    help="ego-subgraph halo depth; >= model receptive depth (2 for "
                         "the paper GAT) makes served predictions exact")
    ap.add_argument("--link-frac", type=float, default=0.25,
                    help="fraction of link-prediction queries in the stream")
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="partial batches dispatch after the oldest request waits this long")
    ap.add_argument("--bucket-base", type=int, default=64,
                    help="smallest shape bucket; ladder doubles up to the full graph")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="directory for BENCH_serve.json + latency_hist.json")
    ap.add_argument("--verify", action="store_true",
                    help="check every served prediction against a full-graph forward")
    ap.add_argument("--verify-atol", type=float, default=0.0,
                    help="--verify failure tolerance; 0 = strict bit-identity")
    add_pipeline_args(ap, engine="compiled", chunks=4, stages=4)
    return ap


def main(argv=None):
    """CLI entry point."""
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
