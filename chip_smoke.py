#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure stops the run with a non-zero exit:

1. Print the card, build the CUDA kernels from ``src/`` (``nvcc``, sm_90a),
   print the build seconds and ``-Xptxas -v`` registers/shared memory/spills.
2. Hold each kernel against its plain PyTorch version on the card (atol and
   rtol 1e-5): the padded kernel at the full-graph shapes of cora and
   pubmed, the bucket kernel on every degree bucket of skewed-powerlaw,
   plus edge cases (ragged R, empty bucket, W=1, fully-masked rows that
   must be exactly 0, a mask with holes, an out-of-range index -> NaN).
3. Serve cora through ``repro_torch.launch.serve_gnn.run`` with the kernel
   backend (4 stages, 4 chunks, 50 q/s for 3 s, ``--verify`` at 1e-5): every
   query answered, 0 mismatches, and the padded kernel's launch count equal
   to 2 GAT layers x chunks x eval calls (+2 for the full-graph verify).
4. Run the paper GAT forward over the degree-bucketed layout of
   skewed-powerlaw with the kernel backend and hold it against the padded
   backend's forward; the bucket kernel must have launched for every
   non-empty bucket of both GAT layers.
5. Time each kernel's main-path work with CUDA events over CUDA-graph
   replays, beside its plain version and its bound (bytes over 3.35 TB/s
   or fp32 operations over 67 TFLOP/s, whichever is larger).

The last three lines are the card's name and power limit, the ``kernels``
JSON line, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repo's ``src/`` beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ATOL = RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/gat_edge/csrc/gat_edge.cu"
REPLACES = {
    "gat_aggregate_kernel": "src/repro/kernels/gat_edge/kernel.py:70",
    "bucket_gat_kernel": "src/repro/kernels/gat_edge/kernel.py:164",
}
SERVE_ARGS = [
    "--dataset", "cora", "--backend", "kernel", "--engine", "host",
    "--stages", "4", "--chunks", "4", "--qps", "50", "--duration", "3",
    "--verify", "--verify-atol", "1e-5", "--device", "cuda",
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Harness:
    """Shared state of the phases: the torch module, the kernel module and
    per-kernel records for the final ``kernels`` line."""

    def __init__(self, torch, K, dev, card_line):
        self.torch = torch
        self.K = K
        self.dev = dev
        self.card = card_line
        self.gen = torch.Generator(device=self.dev).manual_seed(0)
        self.err = {name: 0.0 for name in REPLACES}
        self.launches = {}
        self.timing = {}

    # ------------------------------------------------------------ inputs --

    def features(self, n, h, f):
        t = self.torch
        hw = t.randn((n, h, f), generator=self.gen, device=self.dev)
        s_src = t.randn((n, h), generator=self.gen, device=self.dev)
        s_dst = t.randn((n, h), generator=self.gen, device=self.dev)
        return hw, s_src, s_dst

    def compare(self, name, label, hw, s_src, s_dst, nbr, mask, row=None, zero_rows=None):
        """Kernel vs plain version on the same card inputs; returns the
        kernel output."""
        t, K = self.torch, self.K
        from repro_torch.kernels.gat_edge.ref import gat_edge_ref

        if name == "gat_aggregate_kernel":
            got = K.gat_aggregate_kernel(hw, s_src, s_dst, nbr, mask)
        else:
            got = K.bucket_gat_kernel(hw, s_src, s_dst, nbr, mask, row)
        t.cuda.synchronize()
        want = gat_edge_ref(hw, s_src, s_dst, nbr, mask, row)
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not t.allclose(got, want, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"{label}: kernel disagrees with plain version, max |err| {err:.3g}")
        if zero_rows is not None and bool(zero_rows.any()):
            if not bool((got[zero_rows] == 0).all()):
                raise AssertionError(f"{label}: fully-masked rows are not exactly 0")
        self.err[name] = max(self.err[name], err)
        log(f"[compare] {name:21s} {label:44s} R={nbr.shape[0]:6d} W={nbr.shape[1]:4d} "
            f"H={hw.shape[1]} F={hw.shape[2]:2d} max|err|={err:.3g}")
        return got

    # ------------------------------------------------------------ timing --

    def time_ms(self, fn, iters=20, reps=10):
        """Device ms per ``fn()`` call: ``iters`` calls captured in a CUDA
        graph, replayed ``reps`` times between two CUDA events."""
        t = self.torch
        side = t.cuda.Stream()
        side.wait_stream(t.cuda.current_stream())
        with t.cuda.stream(side):
            for _ in range(3):
                fn()
        t.cuda.current_stream().wait_stream(side)
        t.cuda.synchronize()
        graph = t.cuda.CUDAGraph()
        with t.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        t.cuda.synchronize()
        start, end = t.cuda.Event(enable_timing=True), t.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * iters)

    def bound(self, calls):
        """(bound_ms, bound_by, bytes, ops) for a list of launches' inputs:
        each input read once, each output written once; feature and score
        rows counted only where a live slot needs them."""
        t = self.torch
        total_bytes = total_ops = 0
        for hw, s_src, s_dst, nbr, mask, row in calls:
            _, h, f = hw.shape
            r, w = nbr.shape
            live = int(mask.sum())
            used = int(t.unique(nbr[mask]).numel())
            rows = int(t.unique(row).numel()) if row is not None else r
            total_bytes += (
                used * h * f * 4  # feature rows gathered
                + used * h * 4  # destination scores gathered
                + rows * h * 4  # source scores
                + r * w * (4 + 1)  # neighbor indices + mask
                + (r * 4 if row is not None else 0)  # row_node
                + r * h * f * 4  # output
            )
            # per live slot and head: add, LeakyReLU, max, subtract, exp, sum,
            # divide, then F multiply-adds
            total_ops += live * h * (7 + 2 * f)
        t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = total_ops / FP32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), total_bytes, total_ops

    def launch(self, name, call):
        """One kernel-wrapper call on a ``(hw, s_src, s_dst, nbr, mask, row)``
        tuple."""
        if name == "gat_aggregate_kernel":
            return self.K.gat_aggregate_kernel(*call[:5])
        return self.K.bucket_gat_kernel(*call)

    def record_timing(self, name, label, calls, per_call=False):
        """Time ``calls`` (``(hw, s_src, s_dst, nbr, mask, row)`` tuples)
        through the kernel wrapper and through the plain version; with
        ``per_call`` also print each launch's time beside its bound."""
        from repro_torch.kernels.gat_edge.ref import gat_edge_ref

        def kernel_all():
            for c in calls:
                self.launch(name, c)

        def plain_all():
            for c in calls:
                gat_edge_ref(*c)

        ms = self.time_ms(kernel_all)
        plain_ms = self.time_ms(plain_all)
        bound_ms, bound_by, nbytes, nops = self.bound(calls)
        log(f"[timing] {name} {label}: {len(calls)} launches, kernel {ms:.6f} ms, "
            f"plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
            f"{nbytes} B, {nops} ops), share of bound {bound_ms / ms:.3f} [{self.card}]")
        for c in calls if per_call else ():
            one_ms = self.time_ms(lambda c=c: self.launch(name, c))
            one_bound = self.bound([c])[0]
            log(f"[timing]   {name} R={c[3].shape[0]:5d} W={c[3].shape[1]:4d} "
                f"F={c[0].shape[2]:2d} live={int(c[4].sum()):7d}: kernel {one_ms:.6f} ms, "
                f"bound {one_bound:.6f} ms, share of bound {one_bound / one_ms:.3f}")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "calls": len(calls)}


def layer_inputs(torch, p, h):
    """The GAT layer's pre-aggregation tensors (as ``gat_layer`` forms
    them), contiguous as the kernel takes them."""
    hw = torch.einsum("nf,hfo->nho", h, p["w"]).contiguous()
    s_src = torch.einsum("nho,ho->nh", hw, p["a_src"]).contiguous()
    s_dst = torch.einsum("nho,ho->nh", hw, p["a_dst"]).contiguous()
    return hw, s_src, s_dst


def gat_calls(torch, model, params, g, nbr, mask, rows):
    """Kernel-call inputs of both GAT layers of the paper model over ``g``:
    one entry per (layer, tile) with ``nbr``/``mask``/``rows`` lists of
    tiles (rows None for the padded layout)."""
    calls = []
    with torch.inference_mode():
        h = g.features
        for i, layer in enumerate(model.layers):
            if layer.name.startswith("gat"):
                hw, s_src, s_dst = layer_inputs(torch, params[i], h)
                calls += [(hw, s_src, s_dst, n, m, r) for n, m, r in zip(nbr, mask, rows)]
            h = layer.apply(params[i], g, h, None, False)
    return calls


def phase_compare(H, torch):
    import numpy as np

    from repro_torch.graphs import degree_bucketed_layout, load_dataset, pad_graph, subgraph

    dev = H.dev
    for ds, fs in (("cora", (8, 7)), ("pubmed", (8, 3))):
        g = load_dataset(ds).to(dev)
        for f in fs:
            H.compare("gat_aggregate_kernel", f"{ds} full graph F={f}",
                      *H.features(g.num_nodes, 8, f), g.neighbors, g.mask)

    skew = load_dataset("skewed-powerlaw").to(dev)
    layout = degree_bucketed_layout(skew)
    log(f"[compare] skewed-powerlaw buckets (rows, width): "
        f"{[(b.rows, b.width) for b in layout.buckets]}")
    for f in (8, 16):
        x = H.features(skew.num_nodes, 8, f)
        for b in layout.buckets:
            zero = ~b.mask.any(dim=1)
            H.compare("bucket_gat_kernel", f"skewed-powerlaw bucket W={b.width} F={f}",
                      *x, b.neighbors, b.mask, b.row_node, zero_rows=zero)

    # edge cases
    cora = load_dataset("cora").to(dev)
    x = H.features(cora.num_nodes, 8, 8)
    b = degree_bucketed_layout(cora).buckets[0]
    if b.rows < 37:
        raise AssertionError(f"cora's first bucket has {b.rows} rows, want >= 37")
    H.compare("bucket_gat_kernel", "ragged R=37", *x, b.neighbors[:37].contiguous(),
              b.mask[:37].contiguous(), b.row_node[:37].contiguous())
    before = H.K.bucket_gat_kernel.launches
    empty = H.compare("bucket_gat_kernel", "empty bucket R=0", *x, b.neighbors[:0],
                      b.mask[:0], b.row_node[:0])
    if empty.shape[0] != 0 or H.K.bucket_gat_kernel.launches != before:
        raise AssertionError("empty bucket must return (0, H, F) without a launch")
    self_loop = cora.neighbors[:, :1].contiguous()
    H.compare("gat_aggregate_kernel", "W=1 (self-loops only)", *x, self_loop,
              cora.mask[:, :1].contiguous())
    padded = pad_graph(subgraph(cora, np.arange(0, cora.num_nodes, 3)), 1000, cora.max_degree)
    holes = padded.mask[:, :-1].int() < padded.mask[:, 1:].int()
    if not bool(holes.any()):
        raise AssertionError("expected a mask with holes from subgraph()")
    zero = ~padded.mask.any(dim=1)
    if int(zero.sum()) < 50:
        raise AssertionError("expected fully-masked padding rows")
    H.compare("gat_aggregate_kernel", f"holed mask, {int(zero.sum())} fully-masked rows",
              *H.features(1000, 8, 7), padded.neighbors, padded.mask, zero_rows=zero)
    bad_nbr = cora.neighbors.clone()
    bad_nbr[5, 0] = cora.num_nodes  # out of range in a live slot
    out = H.K.gat_aggregate_kernel(*x, bad_nbr, cora.mask)
    torch.cuda.synchronize()
    if not (bool(out[5].isnan().all()) and bool(out[6].isfinite().all())):
        raise AssertionError("out-of-range index must give a NaN row and leave others")
    log("[compare] out-of-range index -> NaN row: ok")


def phase_serve(H, torch):
    from repro_torch.launch.serve_gnn import WARM_CALLS, build_parser, run

    args = build_parser().parse_args(SERVE_ARGS)
    H.K.gat_aggregate_kernel.launches = 0
    H.K.bucket_gat_kernel.launches = 0
    summary = run(args)
    launched = {
        "gat_aggregate_kernel": H.K.gat_aggregate_kernel.launches,
        "bucket_gat_kernel": H.K.bucket_gat_kernel.launches,
    }
    calls = sum(v["batches"] for v in summary["buckets"].values())
    calls += WARM_CALLS * summary["warm_buckets"]
    want = 2 * summary["chunks"] * calls + 2  # + the full-graph verify forward
    served = sum(v["queries"] for v in summary["buckets"].values())
    if served != summary["queries"] or summary["verify_mismatches"] != 0:
        raise AssertionError(f"serve: {served}/{summary['queries']} served, "
                             f"{summary['verify_mismatches']} mismatches")
    if launched["gat_aggregate_kernel"] != want or launched["bucket_gat_kernel"] != 0:
        raise AssertionError(f"serve: launches {launched}, want {want} padded and 0 bucket")
    H.launches["gat_aggregate_kernel"] = launched["gat_aggregate_kernel"]
    batches = sum(v["batches"] for v in summary["buckets"].values())
    log(f"[serve] ok: {served} queries, {batches} batches, achieved {summary['achieved_qps']} q/s, "
        f"p50 {summary['p50_s'] * 1e3} ms, p99 {summary['p99_s'] * 1e3} ms, "
        f"verify exact {summary['verify_exact']}/{summary['queries']} "
        f"max diff {summary['verify_max_diff']}, padded-kernel launches {want} "
        f"({2 * summary['chunks']} per served batch) [{H.card}]")
    return summary


def phase_bucketed(H, torch):
    from repro_torch.graphs import degree_bucketed_layout, load_dataset
    from repro_torch.models.gnn.net import build_paper_gat

    skew = load_dataset("skewed-powerlaw").to(H.dev)
    layout = degree_bucketed_layout(skew)
    model_k = build_paper_gat(skew.num_features, skew.num_classes, backend="kernel")
    model_p = build_paper_gat(skew.num_features, skew.num_classes, backend="padded")
    params = model_k.init_params(0, device=H.dev)
    H.K.gat_aggregate_kernel.launches = 0
    H.K.bucket_gat_kernel.launches = 0
    with torch.inference_mode():
        got = model_k.apply(params, layout, train=False)
    torch.cuda.synchronize()
    launched = H.K.bucket_gat_kernel.launches
    padded_launched = H.K.gat_aggregate_kernel.launches
    with torch.inference_mode():
        want = model_p.apply(params, skew, train=False)
    nonempty = sum(1 for b in layout.buckets if b.rows)
    err = float((got - want).abs().max())
    if got.shape != want.shape or not bool(got.isfinite().all()):
        raise AssertionError("bucketed forward: wrong shape or non-finite values")
    if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"bucketed forward disagrees with padded: max |err| {err:.3g}")
    if launched != 2 * nonempty or padded_launched != 0:
        raise AssertionError(f"bucket kernel launched {launched}, want {2 * nonempty}")
    H.launches["bucket_gat_kernel"] = launched
    log(f"[bucketed] skewed-powerlaw paper GAT, kernel vs padded backend: max |err| {err:.3g}, "
        f"bucket-kernel launches {launched} (2 layers x {nonempty} buckets)")
    return model_k, params, skew, layout


def phase_timing(H, torch, bucketed):
    from repro_torch.graphs import load_dataset, stack_graphs
    from repro_torch.launch.serve_gnn import GNNServer, Query, ShapeBuckets
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.models.gnn.net import build_paper_gat

    # one served cora batch: 4 ego-subgraphs in the 64-node bucket
    cora = load_dataset("cora")
    model = build_paper_gat(cora.num_features, cora.num_classes, backend="kernel")
    params = model.init_params(0, device=H.dev)
    cfg = GPipeConfig(balance=(2, 1, 1, 2), chunks=4, device=str(H.dev))
    server = GNNServer(make_engine(model, cfg), params, cora, hops=2,
                       buckets=ShapeBuckets.geometric(cora))
    prepared = [server.prepare(Query(i, "node", u)) for i, u in enumerate((0, 700, 1400, 2100))]
    batch = stack_graphs([p.graph for p in prepared]).to(H.dev)
    calls = []
    for c in range(batch.features.shape[0]):
        g = batch.chunk(c)
        calls += gat_calls(torch, model, params, g, [g.neighbors], [g.mask], [None])
    H.timing["gat_aggregate_kernel"] = H.record_timing(
        "gat_aggregate_kernel", f"one served cora batch (4 chunks x n_pad "
        f"{batch.features.shape[1]} x W {batch.neighbors.shape[2]})", calls)

    full = cora.to(H.dev)
    full_calls = gat_calls(torch, model, params, full, [full.neighbors], [full.mask], [None])
    H.record_timing("gat_aggregate_kernel", "cora full graph (verify forward)", full_calls)

    model_k, params_k, skew, layout = bucketed
    tiles = [b for b in layout.buckets if b.rows]
    b_calls = gat_calls(torch, model_k, params_k, skew, [b.neighbors for b in tiles],
                        [b.mask for b in tiles], [b.row_node for b in tiles])
    H.timing["bucket_gat_kernel"] = H.record_timing(
        "bucket_gat_kernel", f"skewed-powerlaw forward ({len(tiles)} buckets x 2 layers)",
        b_calls, per_call=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # phase 1: the card and the build
    card_line = card()
    log(f"[card] {card_line}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    from repro_torch.kernels.gat_edge import kernel as K

    built = K.library()
    log(f"[build] {built.path.name}: nvcc {built.build_seconds:.3f} s")
    for line in built.ptxas_log.splitlines():
        if line.strip():
            log(f"[build] {line.strip()}")

    H = Harness(torch, K, torch.device("cuda"), card_line)
    phase_compare(H, torch)  # phase 2
    phase_serve(H, torch)  # phase 3
    bucketed = phase_bucketed(H, torch)  # phase 4
    phase_timing(H, torch, bucketed)  # phase 5

    kernels = []
    for name, replaces in REPLACES.items():
        tm = H.timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": H.launches[name], "max_abs_err": H.err[name],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None,
        })
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(f"[card] {card_line}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
