#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure stops the run with a non-zero exit:

1. Print the card, build the CUDA kernels from ``src/`` (one ``nvcc`` per
   source, all started together, sm_90a), print the build seconds and
   ``-Xptxas -v`` registers/shared memory/spills.
2. Hold each kernel against its plain PyTorch version on the card (atol and
   rtol 1e-5). GAT: the padded kernel at the full-graph shapes of cora and
   pubmed; the bucket kernel on every degree bucket of skewed-powerlaw and
   on every tile of every chunk of phase 6's cora training plan, at both GAT
   layers' own inputs and on unit-scale random features (F 8 and 7). SpMM: the padded kernel on cora at F 256/32/7 and at
   both layers' own inputs of phase 7's single-device GCN on skewed-powerlaw
   (F 32/16); the bucket kernel on every bucket of the GCN training plan's
   skewed-powerlaw layout (max_degree 128, 2 chunks) at F 32/16. Plus edge
   cases for both (ragged R, empty bucket, W=1, rows that must be exactly 0,
   an out-of-range index -> NaN row).
3. Serve cora through ``repro_torch.launch.serve_gnn.run`` with the kernel
   backend (4 stages, 4 chunks, 50 q/s for 3 s, ``--verify`` at 1e-5): every
   query answered, 0 mismatches, and the padded GAT kernel's launch count
   equal to 2 GAT layers x chunks x eval calls (+2 for the full-graph verify).
4. Run the paper GAT forward over the degree-bucketed layout of
   skewed-powerlaw with the kernel backend and hold it against the padded
   backend's forward; the bucket kernel must have launched for every
   non-empty bucket of both GAT layers.
5. Time each kernel's main-path work with CUDA events over CUDA-graph
   replays (the bucket GAT kernel on one forward of phase 6's plan, and
   per launch on skewed-powerlaw), beside its plain version, its bound
   (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s, whichever is
   larger) and, for SpMM, ``torch.sparse.mm`` on a CSR matrix built once
   from (nbr, norm).
6. Train the paper GAT on cora through ``repro_torch.launch.train.run_gnn``
   (4 stages, 4 halo chunks, fill_drain, ``--backend pallas``): the loss
   stays finite and falls, and the bucket GAT kernel launches 2 (forward +
   recompute) x 2 GAT layers x buckets x 4 chunks per step.
7. Train the GCN of ``benchmarks/fig3.py`` ``_sparse_bench`` on
   skewed-powerlaw (max_degree 128, hidden 32, depth 2, balance (2, 2), 2
   sequential chunks, adam(1e-2), host engine): one kernel-backend step
   matches the padded backend: loss and update within 2e-4, and each leaf
   of the reduced gradients handed to Adam within 1e-5 of that leaf's
   largest gradient; fill_drain, 1f1b and zb-h1
   give bit-identical losses, gradients and updates under deterministic
   algorithms; the bucket SpMM
   kernel launches 2 x 2 GCN layers x 6 buckets x 2 chunks = 48 times per
   fill_drain step; the single-device ``train()`` and ``make_eval`` of the
   same GCN launch the padded SpMM kernel. Step times and the kernel's share
   of the step's device time (``torch.profiler``) are printed.

The last three lines are the card's name and power limit, the ``kernels``
JSON line, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repo's ``src/`` beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

# deterministic cuBLAS for phase 7's bit-identity check; read when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
ATOL = RTOL = 1e-5
GCN_MATCH_ATOL = 2e-4  # benchmarks/fig3.py: bucket concat reorders f32 edge sums
# the two backends' reduced gradients, per leaf: max |diff| over max |grad|
GCN_GRAD_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
GAT_SOURCE = "src/repro_torch/kernels/gat_edge/csrc/gat_edge.cu"
SPMM_SOURCE = "src/repro_torch/kernels/spmm/csrc/spmm.cu"
SOURCES = {
    "gat_aggregate_kernel": GAT_SOURCE,
    "bucket_gat_kernel": GAT_SOURCE,
    "padded_spmm_kernel": SPMM_SOURCE,
    "bucket_spmm_kernel": SPMM_SOURCE,
}
REPLACES = {
    "gat_aggregate_kernel": "src/repro/kernels/gat_edge/kernel.py:70",
    "bucket_gat_kernel": "src/repro/kernels/gat_edge/kernel.py:164",
    "padded_spmm_kernel": "src/repro/kernels/spmm/kernel.py:86",
    "bucket_spmm_kernel": "src/repro/kernels/spmm/kernel.py:99",
}
TRAIN_GAT_ARGS = [
    "--mode", "gnn", "--dataset", "cora", "--stages", "4", "--chunks", "4",
    "--strategy", "halo", "--schedule", "fill_drain", "--backend", "pallas",
    "--device", "cuda", "--epochs", "5", "--log-every", "0",
]
GCN_STEPS = 4  # timed steps per backend in phase 7 (the first is dropped)
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

    def __init__(self, torch, K, S, dev, card_line):
        self.torch = torch
        self.K = K  # the GAT kernel wrappers
        self.S = S  # the SpMM kernel wrappers
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
        return self._held(name, label, got, want, zero_rows,
                          f"R={nbr.shape[0]:6d} W={nbr.shape[1]:4d} H={hw.shape[1]} F={hw.shape[2]:3d}")

    def compare_spmm(self, name, label, hw, nbr, norm, zero_rows=None):
        """SpMM kernel vs its plain version on the same card inputs."""
        from repro_torch.kernels.spmm.ref import padded_spmm_ref

        got = getattr(self.S, name)(hw, nbr, norm)
        self.torch.cuda.synchronize()
        want = padded_spmm_ref(hw, nbr, norm)
        return self._held(name, label, got, want, zero_rows,
                          f"R={nbr.shape[0]:6d} W={nbr.shape[1]:4d} F={hw.shape[1]:3d}")

    def _held(self, name, label, got, want, zero_rows, shape):
        t = self.torch
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not t.allclose(got, want, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"{label}: kernel disagrees with plain version, max |err| {err:.3g}")
        if zero_rows is not None and bool(zero_rows.any()):
            if not bool((got[zero_rows] == 0).all()):
                raise AssertionError(f"{label}: rows that must be 0 are not exactly 0")
        self.err[name] = max(self.err[name], err)
        log(f"[compare] {name:21s} {label:46s} {shape} max|err|={err:.3g}")
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
                "library_ms": None, "calls": len(calls)}

    def spmm_bound(self, calls):
        """(bound_ms, bound_by, bytes, ops) for SpMM launches ``(hw, nbr,
        norm)``: indices and norms read once, the feature rows a nonzero
        norm needs read once, the output written once; a multiply-add (2
        operations) per feature of each nonzero-norm slot."""
        t = self.torch
        total_bytes = total_ops = 0
        for hw, nbr, norm in calls:
            f = hw.shape[1]
            r, w = nbr.shape
            live = norm != 0
            used = int(t.unique(nbr[live]).numel())
            total_bytes += r * w * (4 + 4) + used * f * 4 + r * f * 4
            total_ops += 2 * f * int(live.sum())
        t_bytes = total_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = total_ops / FP32_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), total_bytes, total_ops

    def csr(self, hw, nbr, norm):
        """The (R, N) CSR matrix of one (nbr, norm) tile: the library call's
        operand, built once outside any timed region."""
        t = self.torch
        r, w = nbr.shape
        rows = t.arange(r, device=nbr.device).repeat_interleave(w)
        live = norm.reshape(-1) != 0
        idx = t.stack([rows[live], nbr.reshape(-1).long()[live]])
        with warnings.catch_warnings():  # CSR's "beta" notice
            warnings.simplefilter("ignore", UserWarning)
            coo = t.sparse_coo_tensor(idx, norm.reshape(-1)[live], (r, hw.shape[0]),
                                      check_invariants=True).coalesce()
            return coo.to_sparse_csr()

    def record_spmm_timing(self, name, label, calls, per_call=False):
        """Time ``calls`` (``(hw, nbr, norm)`` tuples) through the kernel
        wrapper, the plain version and ``torch.sparse.mm`` on CSR."""
        t = self.torch
        from repro_torch.kernels.spmm.ref import padded_spmm_ref

        kernel = getattr(self.S, name)
        mats = [(self.csr(*c), c[0]) for c in calls]
        for (a, hw), c in zip(mats, calls):  # the library computes the same function
            if not t.allclose(t.sparse.mm(a, hw), padded_spmm_ref(*c), atol=ATOL, rtol=RTOL):
                raise AssertionError(f"{label}: torch.sparse.mm disagrees with the plain version")

        def kernel_all():
            for c in calls:
                kernel(*c)

        def plain_all():
            for c in calls:
                padded_spmm_ref(*c)

        def library_all():
            for a, hw in mats:
                t.sparse.mm(a, hw)

        ms = self.time_ms(kernel_all)
        plain_ms = self.time_ms(plain_all)
        library_ms = self.time_ms(library_all)
        bound_ms, bound_by, nbytes, nops = self.spmm_bound(calls)
        log(f"[timing] {name} {label}: {len(calls)} launches, kernel {ms:.6f} ms, "
            f"plain {plain_ms:.6f} ms, torch.sparse.mm {library_ms:.6f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {nops} ops), "
            f"share of bound {bound_ms / ms:.3f} [{self.card}]")
        for c in calls if per_call else ():
            one_ms = self.time_ms(lambda c=c: kernel(*c))
            one_bound = self.spmm_bound([c])[0]
            log(f"[timing]   {name} R={c[1].shape[0]:5d} W={c[1].shape[1]:4d} "
                f"F={c[0].shape[1]:3d} live={int((c[2] != 0).sum()):7d}: kernel {one_ms:.6f} ms, "
                f"bound {one_bound:.6f} ms, share of bound {one_bound / one_ms:.3f}")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, "calls": len(calls)}


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


def gcn_calls(torch, model, params, g, tiles):
    """SpMM-call inputs ``(hw, nbr, norm)`` of every GCN layer of ``model``
    over ``g``: one entry per (layer, tile), ``tiles`` a list of (nbr, norm)."""
    calls = []
    with torch.inference_mode():
        h = g.features
        for i, layer in enumerate(model.layers):
            if layer.name.startswith("gcn"):
                hw = (h @ params[i]["w"]).contiguous()
                calls += [(hw, nbr, norm) for nbr, norm in tiles]
            h = layer.apply(params[i], g, h, None, False)
    return calls


def gcn_plan_layout(dev):
    """The fig3 sparse-bench GCN's training inputs: skewed-powerlaw at
    max_degree 128, its 2-chunk sequential plan and the plan's bucketed
    layout (shared capacities) on the card."""
    from repro_torch.core.microbatch import make_plan
    from repro_torch.graphs import bucketize_stacked, load_dataset

    g = load_dataset("skewed-powerlaw", max_degree=128)
    plan = make_plan(g, 2, strategy="sequential")
    return g, plan, bucketize_stacked(plan.stacked().graph).to(dev)


def gat_plan_layout(dev):
    """The GAT training phase's inputs: cora, its plan under
    ``TRAIN_GAT_ARGS`` (4 halo chunks, 2 hops as ``run_gnn`` builds it) and
    the plan's bucketed layout (shared capacities) on the card."""
    from repro_torch.core.microbatch import make_plan
    from repro_torch.graphs import bucketize_stacked, load_dataset
    from repro_torch.launch.train import build_parser

    args = build_parser().parse_args(TRAIN_GAT_ARGS)
    plan = make_plan(load_dataset("cora"), args.chunks, strategy=args.strategy, halo_hops=2,
                     seed=args.seed)
    return plan, bucketize_stacked(plan.stacked().graph).to(dev)


def bucket_gat_plan_calls(torch, model, params, layout, chunks):
    """Bucket-kernel inputs of one forward of the paper GAT over every
    chunk of a stacked bucketed layout: per (chunk, GAT layer, tile)."""
    calls = []
    for c in range(chunks):
        chunk = layout.chunk(c)
        tiles = [b for b in chunk.buckets if b.rows]
        calls += gat_calls(torch, model, params, chunk, [b.neighbors for b in tiles],
                           [b.mask for b in tiles], [b.row_node for b in tiles])
    return calls


def phase_compare_spmm(H, torch):
    import numpy as np

    from repro_torch.graphs import load_dataset, pad_graph, subgraph

    dev, gen = H.dev, H.gen
    cora = load_dataset("cora").to(dev)
    for f in (256, 32, 7):
        hw = torch.randn((cora.num_nodes, f), generator=gen, device=dev)
        H.compare_spmm("padded_spmm_kernel", f"cora full graph F={f}", hw, cora.neighbors, cora.norm)

    from repro_torch.models.gnn.net import build_gnn

    g, plan, layout = gcn_plan_layout(dev)
    gd = g.to(dev)
    gcn = build_gnn("gcn", g.num_features, g.num_classes, hidden=32, depth=2, backend="kernel")
    zero = (gd.norm == 0).all(dim=1)
    for hw, nbr, norm in gcn_calls(torch, gcn, gcn.init_params(0, device=dev), gd,
                                   [(gd.neighbors, gd.norm)]):
        H.compare_spmm("padded_spmm_kernel", f"skewed single-device GCN layer F={hw.shape[1]}",
                       hw, nbr, norm, zero_rows=zero)

    log(f"[compare] GCN plan layout, skewed-powerlaw max_degree 128, 2 chunks: (chunks, rows, "
        f"width) {[tuple(b.neighbors.shape) for b in layout.buckets]}")
    for f in (32, 16):
        for c in range(plan.chunks):
            hw = torch.randn((plan.stacked().n_pad, f), generator=gen, device=dev)
            for b in layout.chunk(c).buckets:
                zero = (b.norm == 0).all(dim=1)
                H.compare_spmm("bucket_spmm_kernel", f"skewed chunk {c} bucket W={b.width} F={f}",
                               hw, b.neighbors, b.norm, zero_rows=zero)

    # edge cases
    b = layout.chunk(0).buckets[0]
    hw = torch.randn((plan.stacked().n_pad, 16), generator=gen, device=dev)
    H.compare_spmm("bucket_spmm_kernel", "ragged R=37", hw, b.neighbors[:37].contiguous(),
                   b.norm[:37].contiguous())
    before = H.S.bucket_spmm_kernel.launches
    empty = H.compare_spmm("bucket_spmm_kernel", "empty bucket R=0", hw, b.neighbors[:0],
                           b.norm[:0])
    if empty.shape != (0, 16) or H.S.bucket_spmm_kernel.launches != before:
        raise AssertionError("empty bucket must return (0, F) without a launch")
    hw = torch.randn((cora.num_nodes, 32), generator=gen, device=dev)
    H.compare_spmm("padded_spmm_kernel", "W=1 (self-loops only)", hw,
                   cora.neighbors[:, :1].contiguous(), cora.norm[:, :1].contiguous())
    padded = pad_graph(subgraph(cora, np.arange(0, cora.num_nodes, 3)), 1000, cora.max_degree)
    zero = (padded.norm == 0).all(dim=1)
    if int(zero.sum()) < 50:
        raise AssertionError("expected all-zero-norm padding rows")
    H.compare_spmm("padded_spmm_kernel", f"holed mask, {int(zero.sum())} all-zero-norm rows",
                   torch.randn((1000, 7), generator=gen, device=dev), padded.neighbors,
                   padded.norm, zero_rows=zero)
    bad_nbr = cora.neighbors.clone()
    bad_nbr[5, 3] = cora.num_nodes  # out of range (the kernel has no mask)
    out = H.S.padded_spmm_kernel(hw, bad_nbr, cora.norm)
    torch.cuda.synchronize()
    if not (bool(out[5].isnan().all()) and bool(out[6].isfinite().all())):
        raise AssertionError("out-of-range index must give a NaN row and leave others")
    log("[compare] spmm out-of-range index -> NaN row: ok")


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

    from repro_torch.models.gnn.net import build_paper_gat

    plan, layout = gat_plan_layout(dev)
    model = build_paper_gat(layout.num_features, layout.num_classes, backend="kernel")
    log(f"[compare] GAT plan layout, cora 4 halo chunks: (chunks, rows, width) "
        f"{[tuple(b.neighbors.shape) for b in layout.buckets]}")
    per_chunk = 2 * sum(1 for b in layout.buckets if b.rows)
    for i, (hw, s_src, s_dst, nbr, mask, row) in enumerate(bucket_gat_plan_calls(
            torch, model, model.init_params(0, device=dev), layout, plan.chunks)):
        H.compare("bucket_gat_kernel", f"cora plan chunk {i // per_chunk} W={nbr.shape[1]} "
                  f"F={hw.shape[2]}", hw, s_src, s_dst, nbr, mask, row, zero_rows=~mask.any(dim=1))
    for f in (8, 7):  # the same tiles on unit-scale features
        x = H.features(layout.features.shape[1], 8, f)
        for c in range(plan.chunks):
            for b in layout.chunk(c).buckets:
                H.compare("bucket_gat_kernel", f"cora plan chunk {c} W={b.width} F={f} randn", *x,
                          b.neighbors, b.mask, b.row_node, zero_rows=~b.mask.any(dim=1))

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

    plan, gat_layout = gat_plan_layout(H.dev)
    H.timing["bucket_gat_kernel"] = H.record_timing(
        "bucket_gat_kernel", f"one forward of the cora GAT training plan ({plan.chunks} chunks x "
        f"2 layers x {sum(1 for b in gat_layout.buckets if b.rows)} buckets)",
        bucket_gat_plan_calls(torch, model, params, gat_layout, plan.chunks))
    model_k, params_k, skew, layout = bucketed
    tiles = [b for b in layout.buckets if b.rows]
    b_calls = gat_calls(torch, model_k, params_k, skew, [b.neighbors for b in tiles],
                        [b.mask for b in tiles], [b.row_node for b in tiles])
    H.record_timing("bucket_gat_kernel", f"skewed-powerlaw forward ({len(tiles)} buckets x "
                    "2 layers)", b_calls, per_call=True)

    # the GCN training path's SpMM work (phase 7's model and params)
    from repro_torch.models.gnn.net import build_gnn

    g, plan, layout = gcn_plan_layout(H.dev)
    gcn = build_gnn("gcn", g.num_features, g.num_classes, hidden=32, depth=2, backend="kernel")
    gcn_params = gcn.init_params(0, device=H.dev)
    gd = g.to(H.dev)
    H.timing["padded_spmm_kernel"] = H.record_spmm_timing(
        "padded_spmm_kernel", "skewed-powerlaw single-device forward (2 GCN layers, F 32 and 16)",
        gcn_calls(torch, gcn, gcn_params, gd, [(gd.neighbors, gd.norm)]), per_call=True)
    b_calls = []
    for c in range(plan.chunks):
        chunk = layout.chunk(c)
        tiles = [(b.neighbors, b.norm) for b in chunk.buckets if b.rows]
        b_calls += gcn_calls(torch, gcn, gcn_params, chunk, tiles)
    H.timing["bucket_spmm_kernel"] = H.record_spmm_timing(
        "bucket_spmm_kernel", f"one forward of the GCN plan ({plan.chunks} chunks x 2 layers x "
        f"{len(layout.buckets)} buckets)", b_calls, per_call=True)


def phase_train_gat(H, torch):
    from repro_torch.launch.train import build_parser, run_gnn

    args = build_parser().parse_args(TRAIN_GAT_ARGS)
    _, layout = gat_plan_layout(H.dev)
    tiles = sum(1 for b in layout.buckets if b.rows)
    per_step = 2 * 2 * tiles * args.chunks  # (fwd + recompute) x GAT layers x tiles x chunks
    H.K.bucket_gat_kernel.launches = 0
    out = run_gnn(args)
    launched = H.K.bucket_gat_kernel.launches
    losses = out["epoch_losses"]
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"GAT training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"GAT training: loss did not fall {losses}")
    if launched != per_step * args.epochs:
        raise AssertionError(f"GAT training: bucket kernel launched {launched}, want "
                             f"{per_step} x {args.epochs} epochs")
    H.launches["bucket_gat_kernel"] = launched
    log(f"[train-gat] cora, 4 stages x 4 halo chunks, fill_drain, pallas: losses "
        f"{[round(x, 6) for x in losses]}, val_acc {out['val_acc']}, median_epoch_s "
        f"{out['median_epoch_s']}, first_epoch_s {out['first_epoch_s']}, bubble_fraction "
        f"{out['bubble_fraction']}, bucket-GAT launches {launched} ({per_step} per step = 2 x 2 "
        f"GAT layers x {tiles} buckets x {args.chunks} chunks) [{H.card}]")


def phase_train_gcn(H, torch):
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.models.gnn.net import build_gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import synchronize, train

    S, dev = H.S, H.dev
    g, plan, layout = gcn_plan_layout(dev)
    tiles = sum(1 for b in layout.buckets if b.rows)
    per_step = 2 * 2 * tiles * plan.chunks

    def slots(norms):  # (all slots, padding slots): what each backend's backward scatters
        total = sum(n.numel() for n in norms)
        return total, total - sum(int((n != 0).sum()) for n in norms)

    log(f"[train-gcn] slots (all, padding): padded chunks {slots([plan.stacked().graph.norm])}, "
        f"bucketed tiles {slots([b.norm for b in layout.buckets])}, full graph "
        f"{slots([g.norm])}")
    models = {b: build_gnn("gcn", g.num_features, g.num_classes, hidden=32, depth=2, backend=b)
              for b in ("padded", "kernel")}
    opt = opt_lib.adam(1e-2)
    params0 = models["kernel"].init_params(0, device=dev)

    def engine(backend, schedule):
        return make_engine(models[backend], GPipeConfig(
            balance=(2, 2), chunks=plan.chunks, schedule=schedule, backend=backend,
            device=str(dev)))

    def one_step(backend, schedule):
        """(params, loss, the reduced gradients Adam was handed, launches)."""
        seen = []

        def update(grads, state, params):
            seen.append(opt_lib.tree_map(torch.clone, grads))
            return opt.update(grads, state, params)

        S.bucket_spmm_kernel.launches = 0
        p, _, loss = engine(backend, schedule).train_step(
            params0, opt.init(params0), plan, 1, opt_lib.Optimizer(init=opt.init, update=update))
        synchronize(dev)
        return p, loss, seen[0], S.bucket_spmm_kernel.launches

    def leaves(tree):
        return [(f"{i}.{k}", v) for i, p in enumerate(tree) for k, v in p.items()]

    def max_diff(a, b):
        return max(float((x - y).abs().max()) for (_, x), (_, y) in zip(leaves(a), leaves(b)))

    def grad_rel(a, b):  # per leaf: max |diff| / max |grad of b|
        return {name: float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                for (name, x), (_, y) in zip(leaves(a), leaves(b))}

    torch.use_deterministic_algorithms(True)
    try:
        p_k, loss_k, g_k, launched = one_step("kernel", "fill_drain")
        p_p, loss_p, g_p, _ = one_step("padded", "fill_drain")
        diffs = {"loss": abs(float(loss_k) - float(loss_p)), "update": max_diff(p_k, p_p)}
        rel = grad_rel(g_k, g_p)
        if not all(d <= GCN_MATCH_ATOL for d in diffs.values()):
            raise AssertionError(f"GCN step: kernel vs padded backend differ by {diffs}")
        if not all(r <= GCN_GRAD_RTOL for r in rel.values()):
            raise AssertionError(f"GCN step: kernel vs padded gradients differ, per leaf "
                                 f"max |diff| / max |grad| {rel}")
        if launched != per_step:
            raise AssertionError(f"GCN step: bucket SpMM launched {launched}, want {per_step}")
        H.launches["bucket_spmm_kernel"] = launched
        counts = {"fill_drain": launched}
        for schedule in ("1f1b", "zb-h1"):
            p_s, loss_s, g_s, counts[schedule] = one_step("kernel", schedule)
            same = torch.equal(loss_s, loss_k) and all(
                torch.equal(x, y) for a, b in ((p_s, p_k), (g_s, g_k))
                for (_, x), (_, y) in zip(leaves(a), leaves(b)))
            if not same:
                raise AssertionError(f"GCN step: {schedule} loss, gradients or update not "
                                     "bit-identical to fill_drain")
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train-gcn] skewed-powerlaw fig3 GCN, one step from the same params, kernel vs padded "
        f"backend: max |diff| {diffs} (limit {GCN_MATCH_ATOL}); loss {float(loss_k)} vs "
        f"{float(loss_p)}; gradients per leaf max |diff| / max |grad| {rel} (limit "
        f"{GCN_GRAD_RTOL}), max |grad| {dict((n, float(v.abs().max())) for n, v in leaves(g_p))}; "
        f"fill_drain/1f1b/"
        f"zb-h1 losses, gradients and updates bit-identical under deterministic algorithms; "
        f"bucket-SpMM launches per step {counts} (fill_drain: 2 x 2 GCN layers x {tiles} "
        f"buckets x {plan.chunks} chunks) [{H.card}]")

    # step times, the two backends in turns (host clock to a device sync)
    times = {"padded": [], "kernel": []}
    engines = {b: engine(b, "fill_drain") for b in times}
    state = {b: (params0, opt.init(params0)) for b in times}
    for step in range(GCN_STEPS):
        for b in (("padded", "kernel") if step % 2 == 0 else ("kernel", "padded")):
            t0 = time.perf_counter()
            p, o, _ = engines[b].train_step(*state[b], plan, step, opt)
            synchronize(dev)
            times[b].append(time.perf_counter() - t0)
            state[b] = (p, o)
    med = {b: statistics.median(v[1:]) for b, v in times.items()}
    log(f"[train-gcn] fill_drain step, median of {GCN_STEPS - 1} after a warm-up: padded "
        f"{med['padded'] * 1e3:.3f} ms, kernel {med['kernel'] * 1e3:.3f} ms; all "
        f"{ {b: [round(x * 1e3, 3) for x in v] for b, v in times.items()} } ms [{H.card}]")
    H.gcn_step_ms = {b: v * 1e3 for b, v in med.items()}
    profile_gcn_step(H, torch, engines["kernel"], state["kernel"], plan, opt)

    # the single-device loop and full-graph eval launch the padded kernel
    gd = g.to(dev)
    S.padded_spmm_kernel.launches = 0
    # from init_params(0): the same params as params0
    res = train(models["kernel"], gd, epochs=3, lr=1e-2, weight_decay=0.0, seed=0)
    synchronize(dev)
    launched = S.padded_spmm_kernel.launches
    if launched != 2 * 3 + 2 or not (res.train_loss == res.train_loss):
        raise AssertionError(f"GCN train(): padded SpMM launched {launched}, want 8; "
                             f"train_loss {res.train_loss}")
    H.launches["padded_spmm_kernel"] = launched
    log(f"[train-gcn] single-device train() 3 epochs + make_eval: padded-SpMM launches "
        f"{launched} (2 GCN layers x 4 forwards), train_loss {res.train_loss}, val_acc "
        f"{res.val_acc}, epoch times {[round(x * 1e3, 3) for x in res.epoch_times_s]} ms "
        f"[{H.card}]")


def profile_gcn_step(H, torch, engine, state, plan, opt):
    """The SpMM kernel's share of a kernel-backend GCN step's device time,
    and the device's busy share of the step's wall time, from
    ``torch.profiler`` over 3 steps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.loop import synchronize

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(3):
            params, opt_state, _ = engine.train_step(*state, plan, 100 + step, opt)
            state = (params, opt_state)
        synchronize(H.dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    spmm_ms = sum(e.self_device_time_total for e in kernels if "spmm_kernel" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    if device_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time for the GCN step")
    log(f"[profile] kernel-backend GCN step x3 (profiled): wall {wall_ms:.3f} ms, device busy "
        f"{device_ms:.3f} ms ({device_ms / wall_ms:.3f} of wall), bucket SpMM kernel "
        f"{spmm_ms:.3f} ms ({spmm_ms / device_ms:.3f} of device time) [{H.card}]")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")


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
    from repro_torch.kernels.spmm import kernel as S

    # one nvcc per source, started together
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        builds = [pool.submit(mod.library) for mod in (K, S)]
        built_libs = [b.result() for b in builds]
    for built in built_libs:
        log(f"[build] {built.path.name}: nvcc {built.build_seconds:.3f} s")
        for line in built.ptxas_log.splitlines():
            if line.strip():
                log(f"[build] {line.strip()}")

    H = Harness(torch, K, S, torch.device("cuda"), card_line)
    phase_compare(H, torch)  # phase 2
    phase_compare_spmm(H, torch)  # phase 2, SpMM
    phase_serve(H, torch)  # phase 3
    bucketed = phase_bucketed(H, torch)  # phase 4
    phase_timing(H, torch, bucketed)  # phase 5
    phase_train_gat(H, torch)  # phase 6
    phase_train_gcn(H, torch)  # phase 7

    kernels = []
    for name, replaces in REPLACES.items():
        tm = H.timing[name]
        if not H.launches.get(name):
            raise AssertionError(f"{name} was not launched on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": replaces,
            "launches": H.launches[name], "max_abs_err": H.err[name],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
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
