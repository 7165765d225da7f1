"""Paper §8: "pipeline parallelism is intended to benefit ... much greater
[graphs] than the PubMed set used here". Counterpart of
``examples/scaling_larger_graphs.py`` on ``repro_torch``, in two parts.

Part 1 runs the reddit-mini stand-in (8192 nodes / 131k edges / 50
classes) and shows where chunking starts paying: per-chunk peak activation
size drops ~linearly with chunks while halo batching keeps accuracy at
full-batch level.

Part 2 goes past what fits in one replica: a STREAMED power-law graph
(``repro_torch.graphs.open_streamed`` — edges from a per-block
counter-based RNG, features materialized per chunk on the host, never the
whole matrix) trained on the compiled engine at ``data_parallel=2`` and
checked against the host fill-drain oracle. One card holds one replica, so
the step runs the single-replica program over all chunks, bit-identical to
the oracle. The same code path runs the 2^20-node registry entry
(``open_streamed("powerlaw-1m")``) — only chunk count and wall-clock grow.

    PYTHONPATH=src python examples/torch/scaling_larger_graphs.py [--device cpu]

``--device`` defaults to ``cuda``. ``--dataset``, ``--num-nodes``,
``--chunks`` and ``--epochs`` (reddit-mini, 32768, 8, 3, as the JAX
example) size a shorter run.
"""

import argparse
import time

from repro_torch.core.cli import resolve_device
from repro_torch.core.microbatch import make_plan
from repro_torch.core.pipeline import GPipe, GPipeConfig, make_engine
from repro_torch.graphs import DoubleBufferedLoader, load_dataset, open_streamed, streamed_plan
from repro_torch.models.gnn.net import build_gnn, build_paper_gat
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import make_eval


def streamed_demo(device, num_nodes=32_768, chunks=8, epochs=3):
    """Streamed graph at data_parallel=2, oracle-checked."""
    t0 = time.time()
    ds = open_streamed("powerlaw-64k", num_nodes=num_nodes)
    plan = streamed_plan(ds, chunks, max_degree=32)
    g0 = plan.batches[0].graph
    print(f"\nstreamed powerlaw-64k@{num_nodes} built in {time.time() - t0:.1f}s: "
          f"{chunks} chunks x {g0.num_nodes} nodes, edge_cut={plan.edge_cut:.2f}")

    balance = (2, 2)
    model = build_gnn("gcn", g0.num_features, g0.num_classes, hidden=32, depth=2)
    opt = opt_lib.adam(1e-2)
    pipe = make_engine(model, GPipeConfig(
        engine="compiled", balance=balance, chunks=chunks, schedule="1f1b", data_parallel=2,
        device=str(device),
    ))
    host = make_engine(model, GPipeConfig(engine="host", balance=balance, chunks=chunks,
                                          device=str(device)))

    params = pipe.init_params(0)
    p_ref, _, _ = host.train_step(params, opt.init(params), plan, 1, opt)
    p_cmp, _, _ = pipe.train_step(params, opt.init(params), plan, 1, opt)
    diff = max(float((a - b).abs().max()) for la, lb in zip(p_ref, p_cmp)
               for a, b in zip(la.values(), lb.values()))
    print(f"data_parallel=2 (replicas split the chunks: {pipe._data_parallel_active}) "
          f"vs host fill-drain oracle: max update diff {diff:.2e}")

    # the loader overlaps chunk t+1's copy with chunk t's compute; on the
    # training path the stacked plan ships whole, so just demonstrate the
    # streaming order contract here
    batches = list(DoubleBufferedLoader((plan.batches[i].graph for i in range(chunks)),
                                        device=device))
    assert len(batches) == chunks
    state = opt.init(params)
    t0 = time.time()
    for epoch in range(epochs):
        params, state, loss = pipe.train_step(params, state, plan, 2 + epoch, opt)
    loss = float(loss)
    print(f"epoch_s={(time.time() - t0) / epochs:6.2f} loss@{epochs}ep={loss:.3f}")
    print("scale further: open_streamed('powerlaw-256k') / ('powerlaw-1m') —")
    print("same code path, chunk count carries the growth (fig3's scale/* rows).")
    return {"diff": diff, "loss": loss}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="reddit-mini")
    ap.add_argument("--num-nodes", type=int, default=32_768)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    t0 = time.time()
    g = load_dataset(args.dataset)
    edges = (int(g.mask.sum()) - g.num_nodes) // 2
    print(f"{args.dataset} built in {time.time() - t0:.1f}s: {g.num_nodes} nodes, "
          f"{edges} edges, max_deg {g.max_degree}")

    model = build_paper_gat(g.num_features, g.num_classes)
    opt = opt_lib.adam(5e-3, weight_decay=5e-4)
    evaluate = make_eval(model)
    g_dev = g.to(device)

    for chunks, strategy in [(1, "sequential"), (4, "halo"), (8, "halo")]:
        pipe = GPipe(model, GPipeConfig(balance=(2, 1, 1, 2), chunks=chunks, device=str(device)))
        plan = make_plan(g, chunks, strategy=strategy, halo_hops=2)
        sizes = [b.num_nodes for b in plan.batches]
        params = pipe.init_params(0)
        state = opt.init(params)
        t0 = time.time()
        for epoch in range(args.epochs):
            params, state, loss = pipe.train_step(params, state, plan, epoch, opt)
        float(loss)
        m = evaluate(params, g_dev)
        print(f"chunks={chunks:2d} ({strategy:10s}) max_chunk_nodes={max(sizes):6d} "
              f"(full={g.num_nodes}) epoch_s={(time.time() - t0) / args.epochs:6.2f} "
              f"val_acc@{args.epochs}ep={float(m['val_acc']):.3f} edge_cut={plan.edge_cut:.2f}")
    print()
    print("observed: on this small-world graph (avg degree 32) a 2-hop halo of")
    print("1/4 of the nodes already spans the WHOLE graph — exact halos cannot")
    print("shrink chunks here. This is precisely why GraphSAGE-style sampling")
    print("and SIGN precompute (graphs/sign.py) exist: SIGN makes chunks exact")
    print("AND small regardless of graph density (see tests/test_torch_sign.py).")

    return streamed_demo(device, num_nodes=args.num_nodes, chunks=args.chunks,
                         epochs=args.epochs)


if __name__ == "__main__":
    main()
