#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its seconds); any failure stops the run with a non-zero
exit:

1. Print the card, build the four CUDA kernels from ``src/`` (GAT, SpMM,
   flash attention, SSD; one ``nvcc`` per source, all started together,
   sm_90a), print the build seconds and ``-Xptxas -v`` registers/shared
   memory/spills.
2. Hold each kernel against its plain PyTorch version on the card (atol and
   rtol 1e-5). GAT: the padded kernel at the full-graph shapes of cora and
   pubmed; the bucket kernel on every degree bucket of skewed-powerlaw and
   on every tile of every chunk of phase 6's cora training plan, at both GAT
   layers' own inputs and on unit-scale random features (F 8 and 7). SpMM,
   each launched twice and bit-identical: the padded kernel on cora at F
   256/32/7 and at both layers' own inputs of phase 7's single-device GCN on
   skewed-powerlaw (F 32/16); the bucket kernel on every bucket of the GCN
   training plan's skewed-powerlaw layout (max_degree 128, 2 chunks) at F
   32/16. Plus edge cases for both (ragged R, empty bucket, W=1, rows that
   must be exactly 0, an out-of-range index -> NaN row, also when it sits
   only in a zero-norm padding slot; SpMM with live slots interleaved with
   zero-norm ones at W 1/31/33/129 x R 1/40/48/8192). Flash attention at
   atol/rtol 1e-5 against its plain version run in float64 (at arctic's
   activations the float32 plain version itself nears 1e-5): the codeqwen
   prefill's launch shape (4 x 512 tokens, 32
   heads of 128, causal), GQA 32/16, 32/8 and 8/1, window 128 and 100
   (crossing tile edges), softcap 50, S 1/63/64/65/127/129/200/513, hd/hd_v
   64/64, 128/128, 128/64, 256/256 and 96/64, zamba2's hd 112 (32 heads, B
   4 and 8, S 512 and 256), and bf16 at 2e-2; phase 17's launches as the
   model makes them: musicgen (4 x 512 and 4 x 256, 32/32 heads, hd 64,
   by row index) and qwen2-vl (the same rows, 12/2 heads, hd 128, masked by
   the m-rope t-row with 128 and 64 frontend rows at t = 0); phase 18's:
   arctic (GQA 56/8, hd 128) and deepseek's MLA (128/128 heads at q/k head
   dim 192 and v head dim 128), 4 x 512 and 4 x 256, and MLA's dims at S
   300 with window 100 and in bf16; the position
   mask's edges in fp32 and bf16 (a prefix ending inside a KV tile, a
   prefix and window 40, every row in the prefix, hd 64 and 256); and the
   null-pointer (index) launch equal to positions arange(S) bit for bit.
   SSD, y and final state at
   atol 1e-4: the mamba2-130m prefill's launch shape (4 x 512, 24 heads, P
   64, N 128, chunk 128), zamba2's (112 heads, P 64, N 64, S 512 and 256),
   ragged S 64 and 200, chunk 32, S 1, S 2048 (16 chunks), strong decay and
   a 45-block grid.
3. Serve cora through ``repro_torch.launch.serve_gnn.run`` with the kernel
   backend (4 stages, 4 chunks, 50 q/s for 3 s, ``--verify`` at 1e-5): every
   query answered, 0 mismatches, and the padded GAT kernel's launch count
   equal to 2 GAT layers x chunks x eval calls (+2 for the full-graph verify).
3b. The same on the compiled engine (one CUDA graph per node-count bucket):
   every query answered, 0 mismatches; a profiled served call shows the
   padded GAT kernel 8 times inside its one replay; q/s, p50/p99 and the
   warm eval-call time are printed beside phase 3's. It runs after phase 5:
   a profiler pass before phase 5's graph captures made phase 5's own
   passes lose device records.
4. Run the paper GAT forward over the degree-bucketed layout of
   skewed-powerlaw with the kernel backend and hold it against the padded
   backend's forward; the bucket kernel must have launched for every
   non-empty bucket of both GAT layers.
5. Time each kernel's main-path work with CUDA events over CUDA-graph
   replays (the bucket GAT kernel on one forward of phase 6's plan and of
   skewed-powerlaw, and per launch, each beside that launch's plain time),
   beside its plain version, its bound (bytes over 3.35 TB/s or fp32
   operations over 67 TFLOP/s, whichever is larger; for flash and SSD, their
   operations as three TF32 tensor-core products each over 495 TFLOP/s, with
   the CUDA-core figure beside) and, for SpMM,
   ``torch.sparse.mm`` on a CSR matrix built once from (nbr, norm), with
   each SpMM launch's own time beside its bound; the flash and SSD kernels
   at their prefill launch shapes and at zamba2's prefill and training
   launches (4 x 512 and 4 x 256 tokens; flash at hd 112, SSD at 112 heads
   and N 64) and flash at musicgen's and qwen2-vl's (the same rows; the
   bound counts the pairs qwen2-vl's positions need; musicgen's launch also
   by the position path at positions arange, which no rope arch runs) and
   at phase 18's prefill launches (arctic GQA 56/8 and deepseek MLA 192/128,
   4 x 512), flash beside
   ``scaled_dot_product_attention`` on the same fp32 tensors (``is_causal``,
   or the positions' boolean ``attn_mask``, GQA by ``enable_gqa``), whose
   device kernels one ``torch.profiler`` pass names; the SSD call's
   three CUDA launches are named and timed by the profiler, and each must
   run once a call. The redesigned kernels' times are printed against their
   floors.
6. Train the paper GAT on cora through ``repro_torch.launch.train.run_gnn``
   (4 stages, 4 halo chunks, fill_drain, ``--backend pallas``): the loss
   stays finite and falls, and the bucket GAT kernel launches 2 (forward +
   recompute) x 2 GAT layers x buckets x 4 chunks per step; the same run
   under fill_drain, 1f1b and zb-h1 with deterministic algorithms gives
   bit-identical epoch losses and final eval.
6b. The same training on ``--engine compiled`` (each step one CUDA-graph
   replay) under fill_drain, 1f1b, zb-h1 and interleaved (2 pipe devices),
   deterministic: every epoch loss bit-identical to phase 6's host
   fill_drain run, and the final eval (over the plan) to the host engine's
   over the same plan. Per engine: median step time, peak allocated memory,
   a profiled step's device-busy share and bucket-GAT launches (inside one
   replay: as many as the capture recorded, 32 under fill_drain), and the
   graphs captured.
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
7b. The same GCN step on the compiled engine: loss and update bit-identical
   to phase 7's host step under deterministic algorithms, and a profiled
   replay with the bucket SpMM kernel 48 times inside it.
8. Serve codeqwen1.5-7b at full width (8.19e9 fp32 params) through
   ``repro_torch.launch.serve`` (``--full-arch --prompt-len 512
   --decode-steps 16 --batch 8 --chunks 2``): the flash kernel launches 32
   layers x 2 micro-batches = 64 times in the prefill; each layer's own q,
   k, v and output from micro-batch 0, captured on the way, are held against
   the plain version at 1e-5; the first decode step's logits are held
   against a fresh 513-token prefill at 1e-3 (cuBLAS may take other
   algorithms for 1 row than for 513). Prefill and decode times, tokens/s,
   peak memory, and ``torch.profiler`` breakdowns of a prefill and two
   decode steps are printed, with the prefill's and the decode's model FLOPs
   (``roofline.model_flops``) as a share of the fp32 peak over the wall.
9. The same for mamba2-130m at full width: the SSD wrapper is called 24 x 2
   = 48 times (3 CUDA launches each), each layer's captured inputs held at
   1e-4 (y and final state).
10. The zoo on phase 6's cora plan: ``build_gnn("graphconv")``,
   ``build_gnn("gatedgraphconv")`` (hidden 64, depth 2; kernel backend, its
   GCN projections on the bucket SpMM kernel) and the paper GAT on the
   dense and padded backends. Dense against padded in the full-graph loss
   and each gradient leaf at dropout 0, within 1e-5 of the leaf's largest
   entry in float64 (the float32 comparison is printed beside each
   backend's distance from float64); 3 steps with dropout on, compiled
   bit-identical to host fill_drain under deterministic algorithms; per
   engine the median step, busy share, peak memory and top kernels.
11. SIGN on cora: ``as_sign_graph(hops=2)`` on the card within 1e-5 of the
   CPU's; one sign-MLP step over 4 sequential chunks within 1e-5 of the
   full-batch step.
12. Phase 6's trained GAT params and Adam state saved with
   ``train.checkpoint`` and loaded back bit-identical; one step from each
   bit-identical.
13. The planner through the entry points: ``train --auto --dry-run`` on
   cora (per-layer card costs, the ranked table), ``--auto --epochs 3``
   (predicted against measured step), ``--partition profiled --schedule
   1f1b`` against uniform, ``serve_gnn --auto --dry-run``.
14. Streamed graphs and one-card data parallelism. 14a: the paper GAT on
   powerlaw-1m (1,048,576 nodes, 64 features, 16 classes) through
   ``run_gnn`` (``--stages 4 --chunks 8 --backend pallas --max-degree 32
   --engine compiled``, 2 epochs): the plan build, stack, bucketize and copy
   seconds, the bucket widths and capacities; the bucket GAT kernel against
   its plain version on every bucket of chunk 0 (131,072 rows) at both
   layers' inputs, and one forward of all 8 chunks timed beside its plain
   version and bound; one host and one compiled fill_drain step from the same
   params bit-identical under deterministic algorithms, with each engine's
   peak memory; 4 timed compiled steps (the first dropped), a profiled
   step's busy share, the plain backward's index-put share, the GAT launches
   inside the replay, the top kernels; the eval over the plan. 14b: fig3's
   scale configuration (GCN hidden 32, depth 2, powerlaw-64k, 8 chunks,
   balance (2, 2), 1f1b, kernel backend): 2 steps at ``data_parallel`` 1
   and 2 and on host fill_drain bit-identical, the bucket SpMM launches in
   a replay, the kernel against its plain version on chunk 0 and one
   forward timed beside ``torch.sparse.mm``. 14c: 14a's chunks through
   ``DoubleBufferedLoader``, bit for bit, the eval of chunk t beside the
   copy of t+1; per consumer (compiled and host eval), the copies' streams,
   pinned state, GB/s and the share of copy time that compute overlaps.
15. Overlap and the per-stage roofline. 15a: fig3's overlap configuration
   with the kernel backend (the paper GAT on cora, 4 stages (2, 1, 1, 2), 8
   sequential chunks, 1f1b, compiled engine under ``--overlap`` off,
   double-buffer and async): one step of each bit-identical to host
   fill_drain under deterministic algorithms; the tick counts (off below
   the retimed ones); the bucket GAT kernel against its plain version on
   every bucket of the 8-chunk layout, at both layers' inputs; each mode's
   step over 21 interleaved steps (the first dropped: quartiles, and the
   retimed modes' paired per-round differences from off); per mode one
   profiled replay: its device copies (count, streams, time), how many ran
   beside a kernel of another stream (at least one under double-buffer and
   async), the kernels' streams, ``capture_overlap_report``'s device-copy
   overlap fraction (a replay keeps no wire stream) and the bucket GAT
   launches inside the replay; per retimed mode one traced eager run of
   the same step program, where the engine's wire stream keeps its id: the
   wire posts' count, stream and time, and their hidden share (every event
   on the wire stream a copy, none of the compute on it). 15b: fig3's
   sparse configuration (the kernel-backend GCN, hidden 32, depth 2, on
   skewed-powerlaw at max_degree 128, balance (2, 2), 2 sequential chunks)
   through ``sparse_stage_report`` on the padded and the bucketed layout:
   the slots, and per stage its measured device time per chunk, its roof
   and the roof's share of the measured time, which may not pass 1.05;
   then the padded and the bucket SpMM kernels against their plain
   version on every chunk at both GCN layers' inputs.

16. LM training through ``repro_torch.launch.train.train_lm`` at full
   width with the JAX ``run_lm`` defaults (``--seq 256 --batch 8 --lr
   3e-4``, fp32, remat on). Per run: every loss finite; the flash and SSD
   wrappers called twice (forward and recompute) per active slot,
   micro-batch and step, and every call of the first forward held against
   the plain version at its own inputs; the losses, step times, median step
   after the first, tokens/s and peak allocated; one more step profiled:
   busy share, the kernels' launches inside it and their shares of device
   time, their plain backward's device time (the ops' autograd nodes), the
   top kernels. 16a: mamba2-130m at full depth, ``--stages 2 --chunks 2``,
   6 steps; its first step held against the same step on the CPU (plain
   versions, same params and batch: loss within 1e-4 relative, Adam's mu
   within 1e-3 of each leaf's largest entry); fill_drain and interleaved
   run again under deterministic algorithms, bit-identical. 16b:
   codeqwen1.5-7b cut to 8 of 32 layers (fp32 params, gradients and Adam's
   moments of all 8.19e9 params are 131 GB), ``--chunks 2``, 4 steps. 16c:
   zamba2-7b served at all 81 slots as phase 8 serves codeqwen (flash at hd
   112 13 x 2 times and SSD 68 x 2 times in the prefill, decode vs a fresh
   prefill at 1e-3), then trained cut to 36 slots (all 81: 94.3 GB of
   state), ``--chunks 2``, 4 steps. Each train step's model FLOPs over the
   median step are printed as a share of the fp32 peak.
17. The modality-frontend archs at full width and depth, each served as
   phase 8 serves codeqwen (prompt 512: 128 frontend rows from
   ``frontend_embeds`` and 384 tokens) and trained as phase 16 trains
   (seq 256: 64 frontend rows; ``--chunks 2``, 4 steps, the loss finite
   and falling). 17a musicgen-large (2.424e9 params; flash at 32/32 heads,
   hd 64: 96 launches in the prefill, 192 a training step). 17b qwen2-vl-2b
   (1.777e9 params; m-rope, GQA 12/2 at hd 128, flash masked by the t-row:
   56 launches in the prefill, 112 a training step); its decode is held at
   1e-3 to a fresh 513-row prefill whose last row takes the decode's
   positions (512 on all three m-rope axes, as the reference's decode
   rotates), and the gap to a prefill at ``make_positions(513)`` (t 385)
   is printed: the reference's own decode/prefill inconsistency.
18. The MoE archs at full width, each served as phase 8 serves codeqwen
   but cut to one layer (fp32 weights: arctic-480b 14.07e9 params, 56.3
   GB; deepseek-v3-671b 13.41e9, 53.6 GB), the flash kernel 1 x 2 times in
   the prefill, then trained as phase 16 trains with fewer experts (16 B a
   param of state), the loss of step 0's batch falling. The decode is held
   at 1e-3 to a fresh prefill whose experts drop no token (one row a
   micro-batch, capacity its tokens; decode drops none), and the gap to
   the prefill at the reference's capacity, which drops, is printed.
   18a arctic-480b
   (GQA 56/8 at hd 128, softmax top-2 of 128 experts, the dense residual)
   trained at 2 layers and 8 experts (2.577e9 params), ``--stages 2
   --chunks 2``, 4 steps, fill_drain and interleaved run again under
   deterministic algorithms, bit-identical. 18b deepseek-v3-671b (MLA, the
   flash kernel at q/k head dim 192 and v head dim 128; sigmoid top-8 of
   256, one shared expert, the multi-token-prediction head) trained at 1
   layer and 16 experts (2.841e9 params), ``--chunks 2``, 4 steps.
19. The dry run (``repro_torch.launch.dryrun``) against the card. The
   codeqwen1.5-7b prefill at phase 8's shapes (full width, 512 tokens,
   batch 8, 2 micro-batches) and its 8-layer training step at phase 16b's
   (seq 256, batch 8, 2 micro-batches, 4 loss chunks, remat), each run once
   under ``roofline.counter.OpCounter`` on the card and once on meta: the
   aten FLOPs and bytes equal op for op, the kernel calls equal to the
   wrappers' launch counts, the flash operations equal to
   ``roofline.kernel_cost``'s count, and the step's increment of the
   counter's peak over what was resident at entry within 10% of the
   increment of ``torch.cuda.max_memory_allocated`` (from a reset) over
   what the card held at entry; beside each, the step's
   median wall (outside the counter) over the dry run's ``bound_s``. The
   long-context windows: codeqwen1.5-7b at full width with
   ``long_context_window`` cut to 64, decoded from an empty ring through
   positions 0-80 (the ring wraps after 64), the last step's logits within
   1e-3 of a fresh 81-row prefill whose layers all take window 64 (the
   flash kernel's window path).
20. The ``examples/torch/`` scripts, each in a subprocess on its default
   device (the card), all five started together: each must exit 0.
   ``pipeline_parallel_gnn`` and ``scaling_larger_graphs`` take the CPU
   test's smaller arguments: at their defaults they took 95.7 s. Beside
   them, after phase 19, phase 19's full-width predictions count on meta in
   two processes with no CUDA device (codeqwen1.5-7b at all four shapes;
   deepseek-v3-671b at train_4k): each one-card verdict (peak against the
   card's 80 GiB, the dominant term) prints after the examples.

Every bound divides by the card's data-sheet rates from
``repro_torch.roofline.analysis.HW``, which knows the card by its name.
The last three lines are the card's name and power limit, the ``kernels``
JSON line, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repo's ``src/`` beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

# deterministic cuBLAS for phase 7's bit-identity check; read when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# the profiler's CUDA-graph workaround (torch.profiler applies it itself
# before CUDA 12.6): keep CUPTI initialized between passes, since the
# passes here alternate with graph captures
os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")
os.environ.setdefault("TEARDOWN_CUPTI", "0")

ROOT = Path(__file__).resolve().parent
ATOL = RTOL = 1e-5
GCN_MATCH_ATOL = 2e-4  # benchmarks/fig3.py: bucket concat reorders f32 edge sums
# the two backends' reduced gradients, per leaf: max |diff| over max |grad|
GCN_GRAD_RTOL = 1e-5
# the card's data-sheet rates (``repro_torch.roofline.analysis.HW``: memory
# bytes/s, fp32 FLOP/s on the CUDA cores, dense TF32 FLOP/s), read in main()
# for the card the script runs on; every bound below divides by them
CARD = None
# floors for the redesigned kernels' times on this card, printed against the
# measured times, not enforced: flash and padded SpMM, their first versions'
# times over 1.5; bucket SpMM, its first version's time; SSD, one prefill
# launch; bucket GAT, one forward of the cora training plan and of
# skewed-powerlaw; padded GAT, one served cora batch
FLOOR_MS = {"flash_attention_kernel": 0.43, "padded_spmm_kernel": 0.059,
            "bucket_spmm_kernel": 0.2175, "ssd_kernel": 0.25, "bucket_gat_kernel": 0.10,
            "bucket_gat_kernel skewed-powerlaw": 0.30, "gat_aggregate_kernel": 0.030}
SSD_LAUNCH_KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_output")
FLASH_ATOL = FLASH_RTOL = 1e-5  # fp32 attention, kernel vs plain (bf16: 2e-2)
FLASH_BF16_TOL = 2e-2
SSD_ATOL = 1e-4  # the JAX package's own SSD tolerance (tests/test_kernels.py)
DECODE_VS_PREFILL_ATOL = 1e-3  # cuBLAS may take other algorithms for 1 row than for 513
GAT_SOURCE = "src/repro_torch/kernels/gat_edge/csrc/gat_edge.cu"
SPMM_SOURCE = "src/repro_torch/kernels/spmm/csrc/spmm.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash/csrc/flash.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd.cu"
SOURCES = {
    "gat_aggregate_kernel": GAT_SOURCE,
    "bucket_gat_kernel": GAT_SOURCE,
    "padded_spmm_kernel": SPMM_SOURCE,
    "bucket_spmm_kernel": SPMM_SOURCE,
    "flash_attention_kernel": FLASH_SOURCE,
    "ssd_kernel": SSD_SOURCE,
}
REPLACES = {  # the public function of each TPU kernel (its pallas_call: PERF.md §6)
    "gat_aggregate_kernel": "src/repro/kernels/gat_edge/kernel.py:86",
    "bucket_gat_kernel": "src/repro/kernels/gat_edge/kernel.py:175",
    "padded_spmm_kernel": "src/repro/kernels/spmm/kernel.py:86",
    "bucket_spmm_kernel": "src/repro/kernels/spmm/kernel.py:99",
    "flash_attention_kernel": "src/repro/kernels/flash/kernel.py:74",
    "ssd_kernel": "src/repro/kernels/ssd/kernel.py:65",
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
LM_SERVE_ARGS = [  # phases 8-9: the LM serving driver at full width, one card
    "--full-arch", "--prompt-len", "512", "--decode-steps", "16", "--batch", "8",
    "--chunks", "2", "--device", "cuda",
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

    def __init__(self, torch, K, S, dev, card_line, FK=None, DK=None):
        self.torch = torch
        self.K = K  # the GAT kernel wrappers
        self.S = S  # the SpMM kernel wrappers
        self.FK = FK  # the flash-attention kernel wrapper
        self.DK = DK  # the SSD kernel wrapper
        self.dev = dev
        self.card = card_line
        self.gen = torch.Generator(device=self.dev).manual_seed(0)
        self.err = {name: 0.0 for name in REPLACES}
        self.used = {}  # per kernel: the largest share of the tolerance a compare used
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
        """SpMM kernel vs its plain version on the same card inputs; the
        kernel launched twice must agree bit for bit."""
        from repro_torch.kernels.spmm.ref import padded_spmm_ref

        got = getattr(self.S, name)(hw, nbr, norm)
        again = getattr(self.S, name)(hw, nbr, norm)
        self.torch.cuda.synchronize()
        if not self.torch.equal(got, again):
            raise AssertionError(f"{label}: two launches on the same inputs differ")
        want = padded_spmm_ref(hw, nbr, norm)
        return self._held(name, label, got, want, zero_rows,
                          f"R={nbr.shape[0]:6d} W={nbr.shape[1]:4d} F={hw.shape[1]:3d}")

    def _held(self, name, label, got, want, zero_rows, shape, atol=ATOL, rtol=RTOL):
        t = self.torch
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max()) if got.numel() else 0.0
        # how close the worst element comes to the allclose tolerance (1 = at it)
        used = float((diff / (atol + rtol * want.float().abs())).max()) if got.numel() else 0.0
        if not t.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"{label}: kernel disagrees with plain version, max |err| {err:.3g}")
        if zero_rows is not None and bool(zero_rows.any()):
            if not bool((got[zero_rows] == 0).all()):
                raise AssertionError(f"{label}: rows that must be 0 are not exactly 0")
        self.err[name] = max(self.err.get(name, 0.0), err)
        self.used[name] = max(self.used.get(name, 0.0), used)
        log(f"[compare] {name:21s} {label:46s} {shape} max|err|={err:.3g} of tolerance {used:.3f}")
        return got

    # ------------------------------------------------------------ timing --

    def time_ms(self, fn, iters=20, reps=10):
        """Device ms per ``fn()`` call: ``iters`` calls captured in a CUDA
        graph, replayed ``reps`` times between two CUDA events (the
        package's ``repro_torch.roofline.device_ms``, which also times the
        roofline's stages)."""
        from repro_torch.roofline import device_ms

        return device_ms(fn, iters, reps)

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
        t_bytes = total_bytes / CARD.hbm_bw * 1e3
        t_ops = total_ops / CARD.fp32_flops * 1e3
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
            one_plain = self.time_ms(lambda c=c: gat_edge_ref(*c))
            one_bound = self.bound([c])[0]
            log(f"[timing]   {name} R={c[3].shape[0]:5d} W={c[3].shape[1]:4d} "
                f"H={c[0].shape[1]} F={c[0].shape[2]:2d} live={int(c[4].sum()):7d}: kernel "
                f"{one_ms:.6f} ms, plain {one_plain:.6f} ms, bound {one_bound:.6f} ms, share of "
                f"bound {one_bound / one_ms:.3f} [{self.card}]")
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
        t_bytes = total_bytes / CARD.hbm_bw * 1e3
        t_ops = total_ops / CARD.fp32_flops * 1e3
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
    # out of range only in a zero-norm padding slot: still a NaN row
    bad_nbr, bad_norm = gd.neighbors.clone(), gd.norm.clone()
    bad_nbr[5, -1], bad_norm[5, -1] = g.num_nodes, 0.0
    hw = torch.randn((g.num_nodes, 32), generator=gen, device=dev)
    out = H.S.padded_spmm_kernel(hw, bad_nbr, bad_norm)
    torch.cuda.synchronize()
    if not (bool(out[5].isnan().all()) and bool(out[6].isfinite().all())):
        raise AssertionError("an out-of-range index in a zero-norm slot must give a NaN row")
    log("[compare] spmm out-of-range index -> NaN row (live slot, zero-norm padding slot): ok")

    # live slots interleaved with zero-norm slots (not trailing), every
    # W in {1, 31, 33, 129} (one, under and over a 32-slot group, the fig3
    # width) and R in {1, 40, 48, 8192} (a row, the fig3 wide buckets' row
    # counts, the padded layout's); every fifth row all zero
    for w in (1, 31, 33, 129):
        for r in (1, 40, 48, 8192):
            nbr = torch.randint(0, g.num_nodes, (r, w), generator=gen, device=dev,
                                dtype=torch.int32)
            norm = torch.rand((r, w), generator=gen, device=dev) + 0.1
            norm[:, 1::2] = 0.0
            norm[::5] = 0.0
            hw = torch.randn((g.num_nodes, 32), generator=gen, device=dev)
            H.compare_spmm("bucket_spmm_kernel", f"interleaved zero-norm slots R={r} W={w}",
                           hw, nbr, norm, zero_rows=(norm == 0).all(dim=1))


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
        bucket_gat_plan_calls(torch, model, params, gat_layout, plan.chunks), per_call=True)
    model_k, params_k, skew, layout = bucketed
    tiles = [b for b in layout.buckets if b.rows]
    b_calls = gat_calls(torch, model_k, params_k, skew, [b.neighbors for b in tiles],
                        [b.mask for b in tiles], [b.row_node for b in tiles])
    H.timing["bucket_gat_kernel skewed-powerlaw"] = H.record_timing(
        "bucket_gat_kernel", f"skewed-powerlaw forward ({len(tiles)} buckets x 2 layers)", b_calls,
        per_call=True)

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

    # the same training under fill_drain, 1f1b and zb-h1 with deterministic
    # algorithms: every epoch's loss and the final eval bit-identical
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for schedule in ("fill_drain", "1f1b", "zb-h1"):
            res = run_gnn(build_parser().parse_args([*TRAIN_GAT_ARGS, "--schedule", schedule]))
            runs[schedule] = (res["epoch_losses"], res["train_loss"], res["val_acc"],
                              res["median_epoch_s"])
    finally:
        torch.use_deterministic_algorithms(False)
    if any(v[:3] != runs["fill_drain"][:3] for v in runs.values()):
        raise AssertionError(f"GAT training: schedules differ under deterministic algorithms {runs}")
    log(f"[train-gat] fill_drain/1f1b/zb-h1 epoch losses and final eval bit-identical under "
        f"deterministic algorithms: {runs['fill_drain'][:3]} [{H.card}]")
    return runs


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
    ref = {"plan": plan, "layout": layout, "model": models["kernel"], "opt": opt,
           "params0": params0, "params": p_k, "loss": loss_k}

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
    return ref


PROFILE_MARGIN_S = 0.5


def profiled(torch, run, trace=None, events=False):
    """(wall ms, CUDA events) of ``run()`` to a device synchronize, under
    ``torch.profiler``, and with ``events`` every averaged event as a third
    item (host ranges too); with ``trace`` a path, the pass's Chrome trace
    is written there. The pass opens and closes ``PROFILE_MARGIN_S``
    before and after the timed work: the profiler keeps only the device
    records time-stamped inside the pass, and short passes on the card lost
    their first or all records without the margin."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    return (wall_ms, kernels, averages) if events else (wall_ms, kernels)


def profile_gcn_step(H, torch, engine, state, plan, opt):
    """The SpMM kernel's share of a kernel-backend GCN step's device time,
    and the device's busy share of the step's wall time, from
    ``torch.profiler`` over 3 steps."""

    def run():
        nonlocal state
        for step in range(3):
            params, opt_state, _ = engine.train_step(*state, plan, 100 + step, opt)
            state = (params, opt_state)

    wall_ms, kernels = profiled(torch, run)
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


# ------------------------------------- the compiled engine (phases 3b, 6b, 7b) --


def profile_one(torch, fn):
    """(wall ms, device-busy ms, {kernel name: (launches, device ms)}) of one
    ``fn()`` call to a device synchronize, from ``torch.profiler``."""
    wall_ms, kernels = profiled(torch, fn)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return wall_ms, device_ms, {e.key: (e.count, e.self_device_time_total / 1e3) for e in kernels}


def launches_named(counts, part):
    return sum(n for key, (n, _) in counts.items() if part in key)


def log_top(label, counts, top=5):
    for key, (n, ms) in sorted(counts.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"[profile]   {label}: {ms:9.3f} ms  x{n:5d}  {key[:90]}")


def phase_serve_compiled(H, torch, host):
    """Phase 3b: serve cora on the compiled engine, one CUDA graph per
    node-count bucket, beside phase 3's host-engine run."""
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.graphs import load_dataset
    from repro_torch.launch.serve_gnn import GNNServer, Query, ShapeBuckets, build_parser, run
    from repro_torch.models.gnn.net import build_paper_gat

    args = build_parser().parse_args([*SERVE_ARGS, "--engine", "compiled"])
    H.K.gat_aggregate_kernel.launches = 0
    summary = run(args)
    launched = H.K.gat_aggregate_kernel.launches
    served = sum(v["queries"] for v in summary["buckets"].values())
    if served != summary["queries"] or summary["verify_mismatches"] != 0:
        raise AssertionError(f"compiled serve: {served}/{summary['queries']} served, "
                             f"{summary['verify_mismatches']} mismatches")
    if launched == 0:
        raise AssertionError("compiled serve: the padded GAT kernel was never launched")
    # one served batch's eval call: one replay with the kernel inside
    cora = load_dataset("cora")
    model = build_paper_gat(cora.num_features, cora.num_classes, backend="kernel")
    engine = make_engine(model, GPipeConfig(balance=(2, 1, 1, 2), chunks=4, engine="compiled",
                                            device=str(H.dev)))
    server = GNNServer(engine, model.init_params(0, device=H.dev), cora, hops=2,
                       buckets=ShapeBuckets.geometric(cora))
    prepared = [server.prepare(Query(i, "node", u)) for i, u in enumerate((0, 700, 1400, 2100))]
    graphs = [p.graph for p in prepared]
    server._run(graphs)  # capture
    _, device_ms, counts = profile_one(torch, lambda: server._run(graphs))
    in_replay = launches_named(counts, "gat_edge_kernel")
    if in_replay != 2 * 4 or engine.graphs_captured != 1:
        raise AssertionError(f"compiled serve: {in_replay} GAT launches in a profiled call, "
                             f"want 8; {engine.graphs_captured} graphs captured")
    log(f"[serve-compiled] ok: {served} queries, 0 mismatches (verify exact "
        f"{summary['verify_exact']}/{summary['queries']}, max diff {summary['verify_max_diff']}), "
        f"achieved {summary['achieved_qps']} q/s (host {host['achieved_qps']}), p50 "
        f"{summary['p50_s'] * 1e3} ms (host {host['p50_s'] * 1e3}), p99 {summary['p99_s'] * 1e3} "
        f"ms (host {host['p99_s'] * 1e3}), warm eval call {summary['eval_call_s'] * 1e3} ms "
        f"(host {host['eval_call_s'] * 1e3}); padded-kernel launches recorded (warm-up + "
        f"capture) {launched}; a profiled served call: {in_replay} GAT launches inside the "
        f"replay, device busy {device_ms:.6f} ms [{H.card}]")


def engine_numbers(H, torch, pipe, params, opt, plan, kernel_part, steps=4):
    """Train ``steps`` steps on ``pipe`` from ``params``; returns (median step
    ms after the first, (``torch.cuda.max_memory_allocated`` over the steps,
    its excess over what was allocated before them), a profiled step's (wall ms, device ms, launches
    of ``kernel_part``, per-kernel counts)). The first step captures the
    compiled engine's graph, so its pool counts."""
    from repro_torch.train.loop import synchronize

    gc.collect()  # engines of earlier runs, and their graph pools
    torch.cuda.empty_cache()
    state = (params, opt.init(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for step in range(steps):
        t0 = time.perf_counter()
        p, o, _ = pipe.train_step(*state, plan, 200 + step, opt)
        synchronize(H.dev)
        times.append((time.perf_counter() - t0) * 1e3)
        state = (p, o)
    peak = torch.cuda.max_memory_allocated()
    peak = (peak, peak - base)
    wall, device, counts = profile_one(
        torch, lambda: pipe.train_step(*state, plan, 300, opt))
    return (statistics.median(times[1:]), peak,
            (wall, device, launches_named(counts, kernel_part), counts))


def phase_train_gat_compiled(H, torch, host):
    """Phase 6b: the paper GAT on cora through ``run_gnn --engine compiled``
    under four schedules, bit-identical to phase 6's host fill_drain run,
    with each engine's step time, busy share, peak memory and graphs."""
    from repro_torch.core.cli import PipelineCLIConfig
    from repro_torch.core.pipeline import make_engine
    from repro_torch.graphs import load_dataset
    from repro_torch.launch.train import build_parser, run_gnn
    from repro_torch.models.gnn.net import build_paper_gat, fold_in
    from repro_torch.train import optimizer as opt_lib

    plan, layout = gat_plan_layout(H.dev)
    tiles = sum(1 for b in layout.buckets if b.rows)
    cora = load_dataset("cora")
    model = build_paper_gat(cora.num_features, cora.num_classes, backend="pallas",
                            attn_dropout=0.0)
    host_losses, host_median_s = host["fill_drain"][0], host["fill_drain"][3]
    schedules = {"fill_drain": [], "1f1b": [], "zb-h1": [], "interleaved": ["--pipe-devices", "2"]}
    torch.use_deterministic_algorithms(True)
    try:
        # the host engine's final params, evaluated over the plan as the
        # compiled run evaluates: the reference for the compiled final eval
        args = build_parser().parse_args(TRAIN_GAT_ARGS)
        cli = PipelineCLIConfig.from_args(args)
        host_pipe = make_engine(model, cli.gpipe_config(cli.uniform_balance()))
        opt = opt_lib.adam(5e-3, weight_decay=5e-4)
        params = host_pipe.init_params(args.seed)
        state = opt.init(params)
        losses = []
        for epoch in range(args.epochs):
            params, state, loss = host_pipe.train_step(params, state, plan,
                                                       fold_in(args.seed, epoch), opt)
            losses.append(float(loss))
        if losses != host_losses:
            raise AssertionError(f"host loop {losses} != phase 6 run_gnn {host_losses}")
        trained = {"pipe": host_pipe, "params": params, "state": state, "opt": opt,
                   "plan": plan, "epochs": args.epochs}
        want = {k: float(v) for k, v in host_pipe.evaluate(params, plan).items()}
        rows = {}
        for schedule, extra in schedules.items():
            argv = [*TRAIN_GAT_ARGS, "--engine", "compiled", "--schedule", schedule, *extra]
            H.K.bucket_gat_kernel.launches = 0
            res = run_gnn(build_parser().parse_args(argv))
            launched = H.K.bucket_gat_kernel.launches
            got = {k: res[k] for k in want}
            if res["epoch_losses"] != host_losses or got != want:
                raise AssertionError(f"compiled {schedule}: losses {res['epoch_losses']} eval "
                                     f"{got}; host fill_drain {host_losses} eval {want}")
            if launched == 0:
                raise AssertionError(f"compiled {schedule}: bucket GAT kernel never launched")
            rows[schedule] = (res["median_epoch_s"], res["first_epoch_s"], launched)
        # per engine: step time, peak memory, one profiled step
        measured = {}
        for name, schedule, extra in (("host", "fill_drain", []),
                                      *(("compiled", s, e) for s, e in schedules.items())):
            argv = [*TRAIN_GAT_ARGS, "--engine", name, "--schedule", schedule, *extra]
            cli = PipelineCLIConfig.from_args(build_parser().parse_args(argv))
            pipe = make_engine(model, cli.gpipe_config(cli.uniform_balance()))
            params0 = pipe.init_params(0)
            med, peak, prof = engine_numbers(H, torch, pipe, params0, opt, plan, "gat_edge_kernel")
            graphs = getattr(pipe, "graphs_captured", 0)
            if name == "compiled":
                pipe.evaluate(params0, plan)
                graphs = pipe.graphs_captured
                (program,) = pipe._steps.values()
                (entry,) = program.captures.values()
                captured = entry[1].captured.launches.get("bucket_gat_kernel", 0)
                if prof[2] != captured or graphs != 2:
                    raise AssertionError(f"compiled {schedule}: {prof[2]} GAT launches in a "
                                         f"profiled replay, {captured} captured; {graphs} graphs")
                if schedule == "fill_drain" and prof[2] != 2 * 2 * tiles * plan.chunks:
                    raise AssertionError(f"compiled fill_drain: {prof[2]} GAT launches a step")
            measured[name if name == "host" else schedule] = (med, peak, prof, graphs)
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train-gat-compiled] cora paper GAT, 4 stages x 4 halo chunks, pallas, 5 epochs, "
        f"deterministic: compiled fill_drain/1f1b/zb-h1/interleaved epoch losses and final "
        f"eval bit-identical to host fill_drain: {host_losses}, eval {want} [{H.card}]")
    log(f"[train-gat-compiled] run_gnn median epoch s: host fill_drain {host_median_s}; "
        + ", ".join(f"compiled {s} {v[0]} (first epoch {v[1]}, GAT launches recorded {v[2]})"
                    for s, v in rows.items()) + f" [{H.card}]")
    for name, (med, peak, (wall, device, gat, counts), graphs) in measured.items():
        log(f"[train-gat-compiled] {name}: median step {med:.6f} ms, max_memory_allocated "
            f"{peak[0]} B ({peak[1]} B beyond the params and data), profiled step wall {wall:.6f} ms device {device:.6f} ms "
            f"busy {device / wall:.6f}, bucket-GAT launches in it {gat}, graphs captured "
            f"{graphs} [{H.card}]")
        if name in ("host", "fill_drain"):
            log_top(name, counts)
    gc.collect()
    torch.cuda.empty_cache()
    return trained


def phase_train_gcn_compiled(H, torch, ref):
    """Phase 7b: the fig3 GCN step on the compiled engine, kernel backend:
    loss and update bit-identical to phase 7's host step, the bucket SpMM
    kernel inside the replay."""
    from repro_torch.core.pipeline import GPipeConfig, make_engine

    plan, model, opt, params0 = ref["plan"], ref["model"], ref["opt"], ref["params0"]
    pipe = make_engine(model, GPipeConfig(balance=(2, 2), chunks=plan.chunks, engine="compiled",
                                          backend="kernel", device=str(H.dev)))
    torch.use_deterministic_algorithms(True)
    try:
        H.S.bucket_spmm_kernel.launches = 0
        p, _, loss = pipe.train_step(params0, opt.init(params0), plan, 1, opt)
        launched = H.S.bucket_spmm_kernel.launches
        same = torch.equal(loss, ref["loss"]) and all(
            torch.equal(a[k], b[k]) for a, b in zip(p, ref["params"]) for k in a)
        if not same:
            raise AssertionError("compiled GCN step: loss or update not bit-identical to host")
        if launched == 0:
            raise AssertionError("compiled GCN step: bucket SpMM kernel never launched")
    finally:
        torch.use_deterministic_algorithms(False)
    # timed as phase 7 times the host engine: a fresh engine, default algorithms
    del pipe
    pipe = make_engine(model, GPipeConfig(balance=(2, 2), chunks=plan.chunks, engine="compiled",
                                          backend="kernel", device=str(H.dev)))
    med, peak, (wall, device, spmm, counts) = engine_numbers(H, torch, pipe, params0, opt, plan,
                                                             "spmm_kernel")
    tiles = sum(1 for b in ref["layout"].buckets if b.rows)
    if spmm != 2 * 2 * tiles * plan.chunks:
        raise AssertionError(f"compiled GCN step: {spmm} SpMM launches in a profiled replay")
    log(f"[train-gcn-compiled] fig3 GCN, compiled fill_drain, kernel backend: loss {float(loss)} "
        f"and update bit-identical to the host step; median step {med:.6f} ms (host kernel "
        f"backend {H.gcn_step_ms['kernel']:.6f} ms), max_memory_allocated {peak[0]} B "
        f"({peak[1]} B beyond the params and data), profiled step wall "
        f"{wall:.6f} ms device {device:.6f} ms busy {device / wall:.6f}, bucket-SpMM launches "
        f"inside the replay {spmm} (2 x 2 GCN layers x {tiles} buckets x {plan.chunks} chunks), "
        f"recorded at warm-up + capture {launched} [{H.card}]")
    log_top("compiled GCN", counts)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()


# ------------------- the zoo, SIGN, checkpoints and the planner (phases 10-13) --

ZOO_STEPS = 4  # timed steps per engine in phase 10 (the first is dropped)
ZOO_ATOL = 1e-5  # dense vs padded in float64: loss, and each gradient leaf against its largest entry


def loss_and_grads(torch, model, g, dtype):
    """(masked NLL, per-layer gradients) of ``model`` on the full graph
    ``g`` from ``init_params(0)``, params and features cast to ``dtype``."""
    import dataclasses

    from repro_torch.train import losses, optimizer as opt_lib

    g = dataclasses.replace(g, features=g.features.to(dtype), norm=g.norm.to(dtype))
    leaves = opt_lib.requires_grad_leaves(opt_lib.tree_map(
        lambda v: v.to(dtype), model.init_params(0, device=g.features.device)))
    loss = losses.masked_nll(model.apply(leaves, g), g.labels, g.train_mask)
    return float(loss), opt_lib.tree_grad(loss, leaves)


def leaf_rel(a, b):
    """Per leaf of two gradient trees: max |diff| / max |entry of b|."""
    return {f"{i}.{k}": float((x[k] - y[k]).abs().max()) / max(float(y[k].abs().max()), 1e-30)
            for i, (x, y) in enumerate(zip(a, b)) for k in x}


def phase_zoo(H, torch):
    """Phase 10: GraphConv, GatedGraphConv (its GCN projections on the
    bucket SpMM kernel) and the paper GAT on the dense backend (and on the
    padded one, its yardstick), on cora in 4 stages x 4 halo chunks: dense
    against padded in the full-graph loss and gradients at dropout 0 (held
    in float64, where the two must be one function; in float32 a bias
    gradient, a cancelling sum over the graph's rows, differs between them
    by float32 rounding, so that comparison is printed beside each
    backend's distance from float64), host fill_drain against the compiled
    engine bit for bit with dropout on, and each engine's step time, busy
    share and peak memory."""
    from repro_torch.core.costmodel import uniform_balance
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.models.gnn.net import build_gnn, build_paper_gat
    from repro_torch.train import optimizer as opt_lib

    from repro_torch.graphs import load_dataset

    plan, _ = gat_plan_layout(H.dev)
    full = load_dataset("cora").to(H.dev)
    F, C = full.num_features, full.num_classes
    opt = opt_lib.adam(5e-3, weight_decay=5e-4)
    gat = lambda b: build_paper_gat(F, C, backend=b)  # noqa: E731
    cases = {  # name: (model for a backend, training backend, kernel name part)
        "graphconv": (lambda b: build_gnn("graphconv", F, C, backend=b), "padded", "spmm_kernel"),
        "gatedgraphconv": (lambda b: build_gnn("gatedgraphconv", F, C, backend=b), "kernel",
                           "spmm_kernel"),
        "gat-dense": (gat, "dense", "gat_edge_kernel"),
        "gat-padded": (gat, "padded", "gat_edge_kernel"),  # the dense step's yardstick
    }
    no_dropout = {"gat-dense": lambda b: build_paper_gat(F, C, backend=b, feat_dropout=0.0,
                                                         attn_dropout=0.0)}

    def engine(model, backend, name="host"):
        return make_engine(model, GPipeConfig(
            balance=balance, chunks=plan.chunks, engine=name, backend=backend,
            device=str(H.dev)))

    for name, (build, backend, part) in cases.items():
        # the paper GAT on the paper's split, as phases 6-6b run it
        balance = (2, 1, 1, 2) if name.startswith("gat-") else uniform_balance(
            len(build("padded").layers), 4)
        # dense against padded on the full graph, dropout 0: float64 holds
        # the two to one function; float32 is printed beside each backend's
        # distance from float64
        steps = {}
        torch.use_deterministic_algorithms(True)
        try:
            for b in (("padded", "dense") if name != "gat-padded" else ()):
                for dtype in (torch.float64, torch.float32):
                    steps[b, dtype] = loss_and_grads(torch, no_dropout.get(name, build)(b),
                                                     full, dtype)
            compared = ""
            if steps:
                f64, f32 = ({b: steps[b, dt] for b in ("padded", "dense")}
                            for dt in (torch.float64, torch.float32))
                rel = leaf_rel(f64["dense"][1], f64["padded"][1])
                loss_diff = abs(f64["dense"][0] - f64["padded"][0])
                if loss_diff > ZOO_ATOL * max(1.0, abs(f64["padded"][0])) or \
                        max(rel.values()) > ZOO_ATOL:
                    raise AssertionError(f"zoo {name}: dense vs padded in float64: loss diff "
                                         f"{loss_diff}, gradients per leaf {rel}")
                rel32 = leaf_rel(f32["dense"][1], f32["padded"][1])
                worst = max(rel32, key=rel32.get)
                off = {b: leaf_rel(f32[b][1], f64[b][1])[worst] for b in ("padded", "dense")}
                compared = (f"dense vs padded (dropout 0, full graph) in float64: loss diff "
                            f"{loss_diff:.3g}, gradient leaves max |diff| / max |grad| "
                            f"{max(rel.values()):.3g} (limit {ZOO_ATOL}); in float32: loss "
                            f"{f32['dense'][0]} vs {f32['padded'][0]}, worst leaf {worst} "
                            f"{rel32[worst]:.3g} of its largest entry, each backend's float32 "
                            f"distance from float64 there: padded {off['padded']:.3g}, dense "
                            f"{off['dense']:.3g}; ")

            # host fill_drain against the compiled engine, dropout on
            model = build(backend)
            params0 = model.init_params(0, device=H.dev)
            runs = {}
            for eng_name in ("host", "compiled"):
                pipe = engine(model, backend, eng_name)
                state, losses = (params0, opt.init(params0)), []
                H.S.bucket_spmm_kernel.launches = 0
                for step in range(3):
                    p, o, loss = pipe.train_step(*state, plan, 40 + step, opt)
                    state = (p, o)
                    losses.append(float(loss))
                runs[eng_name] = (state[0], losses, H.S.bucket_spmm_kernel.launches)
                del pipe
            (hp, hl, h_spmm), (cp, cl, _) = runs["host"], runs["compiled"]
            same = hl == cl and all(torch.equal(a[k], b[k]) for a, b in zip(hp, cp) for k in a)
            if not same or not all(x == x and abs(x) < float("inf") for x in hl):
                raise AssertionError(f"zoo {name}: compiled {cl} vs host {hl}, params equal "
                                     f"{same}")
            if (part == "spmm_kernel" and backend == "kernel") != (h_spmm > 0):
                raise AssertionError(f"zoo {name}: bucket SpMM launched {h_spmm} times in 3 "
                                     f"host steps on the {backend} backend")
        finally:
            torch.use_deterministic_algorithms(False)
        log(f"[zoo] {name} ({[layer.name for layer in model.layers]}, balance {balance}, "
            f"{backend}): {compared}3 steps with dropout on, "
            f"compiled bit-identical to host fill_drain: losses {hl}; bucket-SpMM launches in "
            f"the host steps {h_spmm} [{H.card}]")
        for eng_name in ("host", "compiled"):
            pipe = engine(model, backend, eng_name)
            med, peak, (wall, device, launched, counts) = engine_numbers(
                H, torch, pipe, params0, opt, plan, part, steps=ZOO_STEPS)
            log(f"[zoo] {name} {eng_name}: median step {med:.6f} ms, max_memory_allocated "
                f"{peak[0]} B ({peak[1]} B beyond the params and data), profiled step wall "
                f"{wall:.6f} ms device {device:.6f} ms busy {device / wall:.6f}, {part} "
                f"launches in it {launched} [{H.card}]")
            log_top(f"{name} {eng_name}", counts, top=4)
            del pipe
            gc.collect()
            torch.cuda.empty_cache()


def phase_sign(H, torch):
    """Phase 11: SIGN on cora: the diffused features on the card against
    the CPU, and one sign-MLP step over 4 sequential chunks against the
    full-batch step."""
    from repro_torch.core.microbatch import make_plan
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.graphs import load_dataset
    from repro_torch.graphs.sign import as_sign_graph, build_sign_mlp
    from repro_torch.train import losses, optimizer as opt_lib

    cora = load_dataset("cora")
    t0 = time.perf_counter()
    g = as_sign_graph(cora.to(H.dev), hops=2)
    torch.cuda.synchronize()
    precompute_ms = (time.perf_counter() - t0) * 1e3
    feat_err = float((g.features.cpu() - as_sign_graph(cora, hops=2).features).abs().max())
    if feat_err > ATOL:
        raise AssertionError(f"sign: card features differ from the CPU's by {feat_err}")
    m = build_sign_mlp(g.num_features, g.num_classes, hidden=64, dropout=0.0)
    params = m.init_params(0, device=H.dev)
    opt = opt_lib.adam(1e-2)
    leaves = opt_lib.requires_grad_leaves(params)
    ref_loss = losses.masked_nll(m.apply(leaves, g, train=True), g.labels, g.train_mask)
    upd, _ = opt.update(opt_lib.tree_grad(ref_loss, leaves), opt.init(params), params)
    want = opt_lib.apply_updates(params, upd)
    plan = make_plan(as_sign_graph(cora, hops=2), 4, strategy="sequential")
    pipe = make_engine(m, GPipeConfig(balance=(2, 2), chunks=4, device=str(H.dev)))
    got, _, loss = pipe.train_step(params, opt.init(params), plan, 1, opt)
    loss_diff = abs(float(loss) - float(ref_loss.detach()))
    upd_diff = max(float((a - b.detach()).abs().max())
                   for a, b in zip(opt_lib.tree_leaves(got), opt_lib.tree_leaves(want)))
    if loss_diff > ATOL or upd_diff > ATOL or plan.edge_cut != 0.0:
        raise AssertionError(f"sign: 4 sequential chunks vs full batch: loss diff {loss_diff}, "
                             f"update diff {upd_diff}, edge cut {plan.edge_cut}")
    log(f"[sign] cora hops 2: features {tuple(g.features.shape)} on the card within "
        f"{feat_err:.3g} of the CPU's (limit {ATOL}), precompute {precompute_ms:.3f} ms; one "
        f"sign-MLP step over 4 sequential chunks vs the full batch: loss {float(loss)} (diff "
        f"{loss_diff:.3g}), update max |diff| {upd_diff:.3g} (limit {ATOL}) [{H.card}]")


def phase_checkpoint(H, torch, trained):
    """Phase 12: the cora GAT's params and Adam state after phase 6's
    training, saved and loaded back bit-identical; one step from the loaded
    state equals one step from the state in memory."""
    import tempfile

    from repro_torch.models.gnn.net import fold_in
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint, tree_like

    pipe, plan, opt = trained["pipe"], trained["plan"], trained["opt"]
    tree = {"params": trained["params"], "opt": trained["state"]}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as path:
        t0 = time.perf_counter()
        save_checkpoint(path, tree, step=trained["epochs"], extra={"dataset": "cora"})
        save_ms = (time.perf_counter() - t0) * 1e3
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        loaded, meta = load_checkpoint(path, device=H.dev)
    back = tree_like(tree, loaded)
    flat = [(a, b) for x, y in ((tree["params"], back["params"]), (tree["opt"].mu, back["opt"].mu),
                                (tree["opt"].nu, back["opt"].nu))
            for p, q in zip(x, y) for a, b in ((p[k], q[k]) for k in p)]
    flat.append((tree["opt"].step, back["opt"].step))
    if meta["step"] != trained["epochs"] or not all(
            a.dtype == b.dtype and a.device == b.device and torch.equal(a, b) for a, b in flat):
        raise AssertionError("checkpoint: loaded state not bit-identical to the saved one")
    key = fold_in(0, trained["epochs"])
    torch.use_deterministic_algorithms(True)
    try:
        p1, _, l1 = pipe.train_step(tree["params"], tree["opt"], plan, key, opt)
        p2, _, l2 = pipe.train_step(back["params"], back["opt"], plan, key, opt)
    finally:
        torch.use_deterministic_algorithms(False)
    if not (torch.equal(l1, l2) and all(torch.equal(a[k], b[k]) for a, b in zip(p1, p2)
                                        for k in a)):
        raise AssertionError("checkpoint: a step from the loaded state differs")
    log(f"[checkpoint] cora paper GAT after {trained['epochs']} epochs: params + Adam state, "
        f"{len(flat)} tensors, {size} B on disk, saved in {save_ms:.3f} ms, loaded back "
        f"bit-identical; one step from each: loss {float(l1)} == {float(l2)}, updates "
        f"bit-identical [{H.card}]")


AUTO_ARGS = ["--mode", "gnn", "--dataset", "cora", "--backend", "pallas", "--strategy", "halo",
             "--stages", "4", "--chunks", "4", "--device", "cuda", "--log-every", "0"]


def phase_auto(H, torch):
    """Phase 13: the planner on the card through the training and serving
    entry points: ``--auto --dry-run`` (per-layer card costs and the ranked
    table), ``--auto`` training the pick (its predicted step beside the
    measured median), ``--partition profiled`` against the uniform balance,
    and ``serve_gnn --auto --dry-run``."""
    from repro_torch.core import costmodel
    from repro_torch.launch import serve_gnn
    from repro_torch.launch.train import build_parser, run_gnn

    costmodel._PROFILE_CACHE.clear()
    H.K.gat_aggregate_kernel.launches = 0
    t0 = time.perf_counter()
    dry = run_gnn(build_parser().parse_args([*AUTO_ARGS, "--auto", "--dry-run"]))
    plan_s = time.perf_counter() - t0
    profiled_launches = H.K.gat_aggregate_kernel.launches
    if dry["mode"] != "auto-dry-run" or profiled_launches == 0:
        raise AssertionError(f"auto dry run: {dry}, padded-GAT launches {profiled_launches}")
    rows = dry["layer_costs"]
    if not all(r[k] > 0 for r in rows for k in ("fwd_s", "bwd_s", "bwd_b_s", "bwd_w_s")):
        raise AssertionError(f"auto dry run: non-positive layer costs {rows}")
    log(f"[auto] --auto --dry-run: {dry['evaluated']} candidates in {plan_s:.3f} s (profiling "
        f"4 chunk counts included, padded-GAT kernel launches {profiled_launches}); pick "
        f"schedule {dry['schedule']} chunks {dry['chunks']} balance {dry['balance']} predicted "
        f"{dry['predicted_step_s'] * 1e3:.6f} ms; per-layer card costs at chunks="
        f"{dry['chunks']} (fwd / B / W ms): "
        + ", ".join(f"{r['name']} {r['fwd_s'] * 1e3:.4f}/{r['bwd_b_s'] * 1e3:.4f}/"
                    f"{r['bwd_w_s'] * 1e3:.4f}" for r in rows) + f" [{H.card}]")

    H.K.bucket_gat_kernel.launches = 0
    auto = run_gnn(build_parser().parse_args([*AUTO_ARGS, "--auto", "--epochs", "3"]))
    if H.K.bucket_gat_kernel.launches == 0 or auto["partition"] != "auto":
        raise AssertionError(f"auto training: {auto}")
    ratio = auto["predicted_step_s"] / auto["median_epoch_s"]
    log(f"[auto] --auto --epochs 3 trained schedule {auto['schedule']} chunks {auto['chunks']} "
        f"balance {auto['balance']}: predicted step {auto['predicted_step_s'] * 1e3:.6f} ms, "
        f"measured median step {auto['median_epoch_s'] * 1e3:.6f} ms (predicted/measured "
        f"{ratio:.4f}), losses {auto['epoch_losses']}, bucket-GAT launches "
        f"{H.K.bucket_gat_kernel.launches} [{H.card}]")

    part = {}
    for partition in ("profiled", "uniform"):
        res = run_gnn(build_parser().parse_args(
            [*AUTO_ARGS, "--partition", partition, "--schedule", "1f1b", "--epochs", "3"]))
        part[partition] = (res["balance"], res["median_epoch_s"] * 1e3, res["epoch_losses"])
    if part["profiled"][2] != part["profiled"][2] or sum(part["profiled"][0]) != 6:
        raise AssertionError(f"profiled partition: {part}")
    log(f"[auto] --partition profiled --schedule 1f1b: balance {part['profiled'][0]} median "
        f"step {part['profiled'][1]:.6f} ms; uniform {part['uniform'][0]} median step "
        f"{part['uniform'][1]:.6f} ms [{H.card}]")

    served = serve_gnn.run(serve_gnn.build_parser().parse_args(
        ["--dataset", "cora", "--backend", "kernel", "--device", "cuda", "--auto", "--dry-run"]))
    if served["mode"] != "auto-dry-run":
        raise AssertionError(f"serve --auto --dry-run: {served}")
    log(f"[auto] serve_gnn --auto --dry-run: pick {served} [{H.card}]")


# ------------------------ streamed graphs and one-card data parallelism (phase 14) --

STREAM_ARGS = [  # phase 14a: the paper GAT on the streamed 2^20-node graph
    "--mode", "gnn", "--dataset", "powerlaw-1m", "--stages", "4", "--chunks", "8",
    "--backend", "pallas", "--max-degree", "32", "--log-every", "0", "--device", "cuda",
]
STREAM_STEPS = 4  # timed compiled steps in phase 14a (the first is dropped)
INDEX_PUT_KERNEL = "indexing_backward_kernel"  # the plain backward's neighbor-gather index-put


def layout_bytes(layout) -> int:
    from repro_torch.core.cuda_graph import tree_tensors

    return sum(t.numel() * t.element_size() for t in tree_tensors(layout))


def same_trees(torch, a, b) -> bool:
    from repro_torch.core.cuda_graph import tree_tensors

    ta, tb = tree_tensors(a), tree_tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


def phase_streamed(H, torch):
    """Phase 14a: the paper GAT trained on powerlaw-1m through ``run_gnn``
    on the compiled engine, its host costs, the bucket GAT kernel against
    its plain version on every bucket of chunk 0, one host and one compiled
    step bit-identical, the timed compiled step and the eval over the
    plan. Returns the plan and its host-side bucketed layout for 14c."""
    import repro_torch.graphs as G
    from repro_torch.core.cli import PipelineCLIConfig
    from repro_torch.core.pipeline import make_engine
    from repro_torch.launch.train import build_parser, run_gnn
    from repro_torch.models.gnn.net import build_paper_gat
    from repro_torch.train import optimizer as opt_lib

    # the main path, keeping the plan run_gnn builds (built once: ~30 s of host work)
    plans, build_plan = [], G.streamed_plan

    def keep(*args, **kwargs):
        plans.append(build_plan(*args, **kwargs))
        return plans[-1]

    G.streamed_plan = keep
    H.K.bucket_gat_kernel.launches = 0
    t0 = time.perf_counter()
    try:
        out = run_gnn(build_parser().parse_args([*STREAM_ARGS, "--engine", "compiled",
                                                 "--epochs", "2"]))
    finally:
        G.streamed_plan = build_plan
    run_s = time.perf_counter() - t0
    launched = H.K.bucket_gat_kernel.launches
    (plan,) = plans
    finite = all(x == x and abs(x) < float("inf") for x in out["epoch_losses"])
    if out["mode"] != "gpipe-streamed" or not finite or launched == 0:
        raise AssertionError(f"powerlaw-1m run_gnn: {out}, bucket-GAT launches {launched}")
    H.launches["bucket_gat_kernel"] += launched
    log(f"[streamed] run_gnn powerlaw-1m (1048576 nodes), 4 stages x 8 chunks, pallas, compiled, "
        f"2 epochs: {run_s:.3f} s in all; plan build {plan.rebuild_seconds:.3f} s, edge_cut "
        f"{plan.edge_cut:.6f}, first epoch {out['first_epoch_s']:.3f} s (stack, bucketize, copy, "
        f"capture), second {out['median_epoch_s']:.6f} s, losses {out['epoch_losses']}, val_acc "
        f"{out['val_acc']}, bucket-GAT launches (warm-up + capture + eval) {launched} [{H.card}]")

    # the host costs, one at a time: stack (a fresh plan cache), bucketize, copy
    t0 = time.perf_counter()
    stacked = dataclasses.replace(plan).stacked()
    stack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_layout = G.bucketize_stacked(stacked.graph)
    bucket_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    layout = host_layout.to(H.dev)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    nbytes = layout_bytes(host_layout)
    slots = sum(b.rows * b.width for b in layout.buckets)
    live = [int(b.mask[0].sum()) for b in host_layout.buckets]  # chunk 0's live slots
    log(f"[streamed] host: plan.stacked() {stack_s:.3f} s, bucketize_stacked {bucket_s:.3f} s, "
        f"copy of the layout to the card {copy_s:.3f} s ({nbytes} B from pageable memory, "
        f"{nbytes / copy_s / 1e9:.3f} GB/s); n_pad {stacked.n_pad}, max_deg {stacked.max_deg}, "
        f"bucket widths {[b.width for b in layout.buckets]}, capacities "
        f"{[b.rows for b in layout.buckets]}: {slots} slots a chunk, chunk 0 {sum(live)} live "
        f"(per bucket {live}) and {slots - sum(live)} padding, each pointing at row 0 "
        f"[{H.card}]")

    # the kernel against its plain version on every bucket of chunk 0, both layers
    g0 = plan.batches[0].graph
    model = build_paper_gat(g0.num_features, g0.num_classes, backend="pallas", attn_dropout=0.0)
    params0 = model.init_params(0, device=H.dev)
    chunk0 = layout.chunk(0)
    tiles = [b for b in chunk0.buckets if b.rows]
    calls = gat_calls(torch, model, params0, chunk0, [b.neighbors for b in tiles],
                      [b.mask for b in tiles], [b.row_node for b in tiles])
    for i, call in enumerate(calls):
        H.compare("bucket_gat_kernel", f"powerlaw-1m chunk 0 gat_{i // len(tiles)}", *call)
    calls = bucket_gat_plan_calls(torch, model, params0, layout, plan.chunks)
    H.record_timing("bucket_gat_kernel", "powerlaw-1m forward (8 chunks)", calls)
    del calls, chunk0, tiles

    # one host and one compiled fill_drain step from the same params, bit for bit
    cli = PipelineCLIConfig.from_args(build_parser().parse_args(STREAM_ARGS))
    config = cli.gpipe_config(cli.uniform_balance())
    opt = opt_lib.adam(5e-3, weight_decay=5e-4)
    steps = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name in ("host", "compiled"):
            pipe = make_engine(model, dataclasses.replace(config, engine=name))
            t0 = time.perf_counter()
            pipe._chunk_graphs(plan)  # the engine's layout on the card
            torch.cuda.synchronize()
            layout_s = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            p, _, loss = pipe.train_step(params0, opt.init(params0), plan, 1, opt)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            steps[name] = ([{k: v.clone() for k, v in layer.items()} for layer in p],
                           loss.clone(), layout_s, step_s, peak)
            del pipe, p
    finally:
        torch.use_deterministic_algorithms(False)
    (hp, hl, *host_s), (cp, cl, *comp_s) = steps["host"], steps["compiled"]
    if not (torch.equal(hl, cl) and same_trees(torch, hp, cp)):
        raise AssertionError(f"powerlaw-1m: compiled step not bit-identical to host ({hl}, {cl})")
    log(f"[streamed] one fill_drain step, deterministic: loss {float(hl)} and every param leaf "
        f"bit-identical, host and compiled; host engine layout {host_s[0]:.3f} s, step "
        f"{host_s[1]:.6f} s, {host_s[2]} B beyond params and data; compiled layout "
        f"{comp_s[0]:.3f} s, step (capture included) {comp_s[1]:.6f} s, {comp_s[2]} B beyond "
        f"params and data [{H.card}]")
    del steps, hp, cp

    # the timed compiled steps, default algorithms, on a fresh engine
    gc.collect()
    torch.cuda.empty_cache()
    pipe = make_engine(model, dataclasses.replace(config, engine="compiled"))
    pipe._chunk_graphs(plan)
    med, peak, (wall, device, gat, counts) = engine_numbers(
        H, torch, pipe, params0, opt, plan, "gat_edge_kernel", steps=STREAM_STEPS)
    (program,) = pipe._steps.values()
    (entry,) = program.captures.values()
    captured = entry[1].captured.launches.get("bucket_gat_kernel", 0)
    if gat != captured:
        raise AssertionError(f"powerlaw-1m: {gat} GAT launches in a profiled replay, "
                             f"{captured} captured")
    index_put = sum(ms for key, (_, ms) in counts.items() if INDEX_PUT_KERNEL in key)
    t0 = time.perf_counter()
    metrics = pipe.evaluate(params0, plan)  # captures the eval graph
    torch.cuda.synchronize()
    first_eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = pipe.evaluate(params0, plan)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    values = {k: float(v) for k, v in metrics.items()}
    if not all(v == v and abs(v) < float("inf") for v in values.values()):
        raise AssertionError(f"powerlaw-1m eval: {values}")
    log(f"[streamed] compiled fill_drain step: median {med:.6f} ms over {STREAM_STEPS - 1} "
        f"steps, max_memory_allocated {peak[0]} B ({peak[1]} B beyond the params and data), "
        f"profiled step wall {wall:.6f} ms device {device:.6f} ms busy {device / wall:.6f}, "
        f"{INDEX_PUT_KERNEL} {index_put:.6f} ms ({index_put / device:.6f} of device time), "
        f"bucket-GAT launches in the replay {gat}, graphs captured {pipe.graphs_captured}; "
        f"eval over the plan {values}, first call {first_eval_s:.3f} s, warm call "
        f"{eval_s * 1e3:.6f} ms [{H.card}]")
    log_top("powerlaw-1m compiled", counts)
    del pipe, program, entry, layout
    gc.collect()
    torch.cuda.empty_cache()
    return plan, host_layout, model, params0


def phase_data_parallel(H, torch):
    """Phase 14b: fig3's scale configuration (the GCN at hidden 32, depth 2,
    on powerlaw-64k at its registry size, 8 chunks, ``max_degree=32``,
    balance (2, 2), 1f1b, compiled, kernel backend): two steps at
    ``data_parallel`` 1 and 2 and on host fill_drain, bit for bit; the
    bucket SpMM kernel against its plain version on chunk 0 and timed."""
    import repro_torch.graphs as G
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.models.gnn.net import build_gnn
    from repro_torch.train import optimizer as opt_lib

    plan = G.streamed_plan(G.open_streamed("powerlaw-64k"), 8, max_degree=32)
    g0 = plan.batches[0].graph
    model = build_gnn("gcn", g0.num_features, g0.num_classes, hidden=32, depth=2,
                      backend="kernel")
    params0 = model.init_params(0, device=H.dev)
    opt = opt_lib.adam(1e-2)
    configs = {
        "host fill_drain": dict(engine="host"),
        "compiled 1f1b dp=1": dict(engine="compiled", schedule="1f1b"),
        "compiled 1f1b dp=2": dict(engine="compiled", schedule="1f1b", data_parallel=2),
    }
    runs, engines = {}, {}
    torch.use_deterministic_algorithms(True)
    H.S.bucket_spmm_kernel.launches = 0
    try:
        for name, kw in configs.items():
            pipe = make_engine(model, GPipeConfig(balance=(2, 2), chunks=plan.chunks,
                                                  backend="kernel", device=str(H.dev), **kw))
            p, o = params0, opt.init(params0)
            losses = []
            for key in (1, 2):
                p, o, loss = pipe.train_step(p, o, plan, key, opt)
                losses.append(loss.clone())
            runs[name] = ([{k: v.clone() for k, v in layer.items()} for layer in p], losses)
            engines[name] = pipe
    finally:
        torch.use_deterministic_algorithms(False)
    launched = H.S.bucket_spmm_kernel.launches
    want_p, want_l = runs["host fill_drain"]
    for name, (p, losses) in runs.items():
        if not (all(torch.equal(a, b) for a, b in zip(losses, want_l))
                and same_trees(torch, p, want_p)):
            raise AssertionError(f"powerlaw-64k {name}: not bit-identical to host fill_drain")
    dp = engines["compiled 1f1b dp=2"]
    if dp._data_parallel_active or launched == 0:
        raise AssertionError(f"data_parallel=2: active {dp._data_parallel_active}, "
                             f"bucket-SpMM launches {launched}")
    H.launches["bucket_spmm_kernel"] += launched
    state = runs["compiled 1f1b dp=2"][0]
    _, device, counts = profile_one(torch, lambda: dp.train_step(state, opt.init(state), plan,
                                                                 3, opt))
    in_replay = launches_named(counts, "spmm_kernel")
    layout = dp.layout(plan.stacked().graph)
    tiles = sum(1 for b in layout.buckets if b.rows)
    if in_replay != 2 * 2 * tiles * plan.chunks:
        raise AssertionError(f"data_parallel=2: {in_replay} SpMM launches in a replay")
    log(f"[data-parallel] powerlaw-64k (65536 nodes, edge_cut {plan.edge_cut:.6f}) GCN hidden "
        f"32 depth 2, 8 chunks, balance (2, 2), kernel backend, deterministic: losses "
        f"{[float(x) for x in want_l]} and params bit-identical for "
        f"{', '.join(configs)}; _data_parallel_active False; bucket-SpMM launches (warm-up + "
        f"capture) {launched}, inside one data_parallel=2 replay {in_replay} (2 x 2 GCN layers "
        f"x {tiles} buckets x 8 chunks), its device time {device:.6f} ms [{H.card}]")

    chunk0 = layout.chunk(0)
    bucket_tiles = [(b.neighbors, b.norm) for b in chunk0.buckets if b.rows]
    for i, call in enumerate(gcn_calls(torch, model, params0, chunk0, bucket_tiles)):
        H.compare_spmm("bucket_spmm_kernel", f"powerlaw-64k chunk 0 gcn_{i // len(bucket_tiles)}",
                       *call)
    calls = []
    for c in range(plan.chunks):
        chunk = layout.chunk(c)
        calls += gcn_calls(torch, model, params0, chunk,
                           [(b.neighbors, b.norm) for b in chunk.buckets if b.rows])
    H.record_spmm_timing("bucket_spmm_kernel", "powerlaw-64k forward (8 chunks)", calls)
    del engines, dp, layout, chunk0, calls
    gc.collect()
    torch.cuda.empty_cache()


def copy_overlap(events) -> dict:
    """The HtoD copies of a Chrome trace beside its compute kernels: their
    names and streams, the kernels' streams, the copy time, the share of
    it that some kernel overlaps, and each copy's GB/s."""
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not copies or not kernels:
        raise AssertionError(f"loader: the trace holds {len(copies)} HtoD copies and "
                             f"{len(kernels)} kernels")
    merged = []  # the union of the compute intervals
    for lo, hi in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    copy_us = sum(e["dur"] for e in copies)
    hidden_us = sum(max(0.0, min(e["ts"] + e["dur"], hi) - max(e["ts"], lo))
                    for e in copies for lo, hi in merged)
    return {
        "names": sorted({e["name"] for e in copies}),
        "copy_streams": sorted({e["args"]["stream"] for e in copies}),
        "kernel_streams": sorted({e["args"]["stream"] for e in kernels}),
        "copies": len(copies),
        "copy_ms": copy_us / 1e3,
        "hidden_ms": hidden_us / 1e3,
        "gbps": sorted(e["args"]["bytes"] / (e["dur"] * 1e3) for e in copies if e["dur"] > 0),
    }


def phase_loader(H, torch, plan, host_layout, model, params):
    """Phase 14c: 14a's 8 chunks (each a one-chunk slice of the host
    bucketed layout) walked onto the card through ``DoubleBufferedLoader``,
    each arriving bit for bit, the eval forward of chunk t issued while
    chunk t+1 copies. One ``torch.profiler`` pass per consumer reads the
    copies' streams, pinned state, bandwidth and the share of copy time
    that compute kernels overlap: the compiled eval (one CUDA-graph replay,
    its batch first copied into the graph's static buffers on the compute
    stream) and the host engine's eval (which reads the loaded chunk in
    place)."""
    import tempfile

    from repro_torch.core.cuda_graph import map_tensors
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.graphs import DoubleBufferedLoader

    items = [map_tensors(lambda t, c=c: t[c:c + 1], host_layout) for c in range(plan.chunks)]
    loader = DoubleBufferedLoader(items, device=H.dev)
    lines = []
    for engine in ("compiled", "host"):
        pipe = make_engine(model, GPipeConfig(balance=(2, 1, 1, 2), chunks=1, engine=engine,
                                              backend="pallas", device=str(H.dev)))
        for t, item in enumerate(loader):  # warm-up: bitwise arrival, eval graphs captured
            logp = pipe.compile_eval(params, item)(item)
            if not same_trees(torch, map_tensors(lambda x: x.cpu(), item), items[t]):
                raise AssertionError(f"loader: chunk {t} did not arrive bit for bit")
            if not bool(torch.isfinite(logp).all()):
                raise AssertionError(f"loader: chunk {t} eval on the {engine} engine not finite")

        def walk():
            for item in loader:
                pipe.compile_eval(params, item)(item)

        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "loader.json"
            wall_ms, _ = profiled(torch, walk, trace=trace)
            o = copy_overlap(json.loads(trace.read_text())["traceEvents"])
        if set(o["copy_streams"]) & set(o["kernel_streams"]) or not all(
                "Pinned" in name for name in o["names"]):
            raise AssertionError(f"loader: {o}")
        rates = o["gbps"]
        lines.append(
            f"{engine} eval: {o['copies']} HtoD copies {o['names']} on streams "
            f"{o['copy_streams']}, compute kernels on {o['kernel_streams']}; HtoD copy time "
            f"{o['copy_ms']:.6f} ms, overlapped by compute {o['hidden_ms']:.6f} ms (share "
            f"{o['hidden_ms'] / o['copy_ms']:.6f}); GB/s per copy min {rates[0]:.3f} median "
            f"{statistics.median(rates):.3f} max {rates[-1]:.3f}; pass wall {wall_ms:.3f} ms")
        del pipe
    log("[loader] 8 powerlaw-1m chunks through DoubleBufferedLoader, each bit for bit, the eval "
        "of chunk t issued while chunk t+1 copies; " + "; ".join(lines) + f" [{H.card}]")
    del loader
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------ overlap and the per-stage roofline (phase 15) --

OVERLAP_MODES = ("off", "double-buffer", "async")
OVERLAP_STEPS = 21  # interleaved timed steps per mode in phase 15a (the first is dropped)
ROOF_SHARE_MAX = 1.05  # a stage faster than its floor means the count or the rates are wrong


def phase_overlap(H, torch):
    """Phase 15a: fig3's overlap configuration (``benchmarks/fig3.py``
    ``_overlap_bench``) on the kernel backend: the paper GAT on cora at full
    width, 4 stages (2, 1, 1, 2), 8 sequential chunks, 1f1b, compiled engine
    under overlap off, double-buffer and async. One step of each from the
    same params, and one of host fill_drain, bit-identical under
    deterministic algorithms; the tick counts; the bucket GAT kernel against
    its plain version on the engine's layout; each mode's step over
    interleaved steps; per mode one profiled replay: its device copies
    (count, streams, time), the kernels' streams, the copies running beside
    a kernel of another stream, the package's device-copy overlap report
    and the bucket GAT launches inside the replay; per retimed mode the
    wire posts of one traced eager run of the step program."""
    import collections
    import tempfile

    from repro_torch.core.microbatch import make_plan
    from repro_torch.core.overlap_report import (
        capture_overlap_report,
        load_trace_events,
        probe_streams,
    )
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.graphs import load_dataset
    from repro_torch.models.gnn.net import build_paper_gat, chunk_keys
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import synchronize

    cora = load_dataset("cora")
    plan = make_plan(cora, 8, strategy="sequential")
    model = build_paper_gat(cora.num_features, cora.num_classes, backend="pallas",
                            attn_dropout=0.0)
    opt = opt_lib.adam(5e-3, weight_decay=5e-4)
    params0 = model.init_params(0, device=H.dev)

    def engine(name, overlap):
        return make_engine(model, GPipeConfig(
            balance=(2, 1, 1, 2), chunks=plan.chunks, engine=name, backend="pallas",
            schedule="fill_drain" if name == "host" else "1f1b", overlap=overlap,
            device=str(H.dev)))

    runs, ticks = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, mode in (("host", "off"), *(("compiled", m) for m in OVERLAP_MODES)):
            stats = {}
            p, _, loss = engine(name, mode).train_step(params0, opt.init(params0), plan, 7, opt,
                                                       stats=stats)
            key = "host fill_drain" if name == "host" else mode
            runs[key] = ([{k: v.clone() for k, v in layer.items()} for layer in p], loss.clone())
            ticks[key] = stats.get("num_ticks")
    finally:
        torch.use_deterministic_algorithms(False)
    want_p, want_loss = runs["host fill_drain"]
    for mode in OVERLAP_MODES:
        p, loss = runs[mode]
        if not (torch.equal(loss, want_loss) and same_trees(torch, p, want_p)):
            raise AssertionError(f"overlap {mode}: loss or update not bit-identical to host "
                                 "fill_drain")
    if not ticks["off"] < ticks["double-buffer"] == ticks["async"]:
        raise AssertionError(f"overlap: tick counts {ticks}")

    # timed on fresh engines with default algorithms, the modes in turns
    gc.collect()
    torch.cuda.empty_cache()
    pipes = {m: engine("compiled", m) for m in OVERLAP_MODES}
    states = {m: (params0, opt.init(params0)) for m in OVERLAP_MODES}
    times = {m: [] for m in OVERLAP_MODES}
    H.K.bucket_gat_kernel.launches = 0
    for step in range(OVERLAP_STEPS):
        for m, pipe in pipes.items():
            t0 = time.perf_counter()
            p, o, _ = pipe.train_step(*states[m], plan, 200 + step, opt)
            synchronize(H.dev)
            times[m].append((time.perf_counter() - t0) * 1e3)
            states[m] = (p, o)
    launched = H.K.bucket_gat_kernel.launches
    if launched == 0:
        raise AssertionError("overlap: the bucket GAT kernel was never launched")
    H.launches["bucket_gat_kernel"] += launched

    # the kernel against its plain version on the engine's own layout, both layers
    layout = pipes["off"].layout(plan.stacked().graph)
    calls = bucket_gat_plan_calls(torch, model, params0, layout, plan.chunks)
    per_chunk = len(calls) // plan.chunks
    for i, call in enumerate(calls):
        H.compare("bucket_gat_kernel", f"cora 8 seq chunks, chunk {i // per_chunk} call "
                  f"{i % per_chunk}", *call)
    del calls

    log(f"[overlap] cora paper GAT, pallas, 4 stages (2, 1, 1, 2) x 8 sequential chunks, 1f1b: "
        f"off, double-buffer and async one step bit-identical to host fill_drain (loss "
        f"{float(want_loss)}); ticks off {ticks['off']} < retimed {ticks['double-buffer']}; "
        f"bucket-GAT launches recorded (warm-up + capture) {launched} [{H.card}]")

    def quartiles(xs):
        return ", ".join(f"{q:.6f}" for q in statistics.quantiles(xs, n=4))

    for m, pipe in pipes.items():
        with tempfile.TemporaryDirectory() as tmp:
            report = capture_overlap_report(
                lambda: pipe.train_step(*states[m], plan, 300, opt), trace_dir=tmp)
            events = load_trace_events(tmp)
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        gat = sum("gat_edge_kernel" in e["name"] for e in kernels)
        beside = sum(any(c["args"]["stream"] != k["args"]["stream"]
                         and c["ts"] < k["ts"] + k["dur"] and k["ts"] < c["ts"] + c["dur"]
                         for k in kernels) for c in copies)
        copy_streams = collections.Counter(c["args"]["stream"] for c in copies)
        timed = times[m][1:]
        paired = ""
        if m != "off":
            diffs = [(a - b) / b * 100 for a, b in zip(timed, times["off"][1:])]
            paired = (f", minus off per round (%) median {statistics.median(diffs):.6f} "
                      f"quartiles {quartiles(diffs)}")
        line = (
            f"{m}: step over {len(timed)} steps median {statistics.median(timed):.6f} ms, "
            f"quartiles {quartiles(timed)} ms, min {min(timed):.6f} max {max(timed):.6f}"
            f"{paired}; ticks {ticks[m]}; profiled replay: {len(copies)} device copies "
            f"({sum(c['dur'] for c in copies):.3f} us) on streams "
            f"{dict(sorted(copy_streams.items()))}, {beside} of them beside a kernel of another "
            f"stream; {len(kernels)} kernels on {len({k['args']['stream'] for k in kernels})} "
            f"streams; device-copy overlap_fraction {report['overlap_fraction']:.6f} (all "
            f"copies {report['collective_time_us']:.3f} us, under compute "
            f"{report['overlapped_time_us']:.3f} us, compute {report['compute_time_us']:.3f} "
            f"us); bucket-GAT launches in the replay {gat}; graphs captured "
            f"{pipe.graphs_captured}")
        log(f"[overlap]   {line} [{H.card}]")
        if gat == 0 or pipe.graphs_captured != 1:
            raise AssertionError(f"overlap {m}: {gat} bucket GAT launches in a profiled replay, "
                                 f"{pipe.graphs_captured} graphs captured")
        if m != "off" and not beside:
            raise AssertionError(f"overlap {m}: no device copy ran beside a kernel of another "
                                 "stream in a profiled replay")
        if m == "off":
            continue
        # the same step program run eagerly: the wire stream keeps its id there
        program, graphs, masks = pipe.step_program(params0, plan, opt)
        keys = chunk_keys(301, len(model.layers))
        with tempfile.TemporaryDirectory() as tmp:
            wire = capture_overlap_report(
                lambda: program(*states[m], graphs, masks, keys), wire_stream=pipe.wire_stream,
                trace_dir=tmp)
            events = load_trace_events(tmp)
        _, probe = probe_streams(events)
        posts = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and e["args"].get("stream") in wire["wire_streams"]
                 and e["args"].get("correlation") not in probe]
        compute_streams = {e["args"]["stream"] for e in events if e.get("cat") == "kernel"
                           and e["args"]["stream"] not in wire["wire_streams"]}
        line = (
            f"{m} eager step program (traced): {len(posts)} wire posts "
            f"({sorted({e['name'] for e in posts})}) on wire stream {wire['wire_streams']}, "
            f"compute on {sorted(compute_streams)}; posts {wire['collective_time_us']:.3f} us, "
            f"under compute {wire['overlapped_time_us']:.3f} us: wire overlap_fraction "
            f"{wire['overlap_fraction']:.6f}; compute {wire['compute_time_us']:.3f} us")
        log(f"[overlap]   {line} [{H.card}]")
        if (not posts or wire["num_collective_events"] != len(posts) or not compute_streams
                or any(e["cat"] != "gpu_memcpy" for e in posts)):
            raise AssertionError(f"overlap {m}: eager run, wire stream {wire['wire_streams']} "
                                 f"ran {sorted(e['name'] for e in posts)}, the report counts "
                                 f"{wire['num_collective_events']}, compute on "
                                 f"{sorted(compute_streams)}")
    del pipes, states, layout
    gc.collect()
    torch.cuda.empty_cache()


def phase_roofline(H, torch):
    """Phase 15b: fig3's sparse configuration (``benchmarks/fig3.py``
    ``_sparse_bench``): the kernel-backend GCN (hidden 32, depth 2) on
    skewed-powerlaw at max_degree 128, balance (2, 2), 2 sequential chunks,
    through ``sparse_stage_report`` on the padded and the bucketed layout:
    the slots and each stage's measured device time per chunk beside its
    roof. A stage faster than its roof by more than 5% raises."""
    from repro_torch.models.gnn.net import build_gnn
    from repro_torch.roofline import sparse_stage_report

    g, plan, layout = gcn_plan_layout(H.dev)
    model = build_gnn("gcn", g.num_features, g.num_classes, hidden=32, depth=2,
                      backend="kernel")
    params = model.init_params(0, device=H.dev)
    padded = plan.stacked().graph.to(H.dev)
    H.S.padded_spmm_kernel.launches = H.S.bucket_spmm_kernel.launches = 0
    report = sparse_stage_report(model, params, padded, layout, (2, 2))
    launched = {name: getattr(H.S, name).launches
                for name in ("padded_spmm_kernel", "bucket_spmm_kernel")}
    if not all(launched.values()):
        raise AssertionError(f"roofline: SpMM launches {launched}")
    for name, n in launched.items():
        H.launches[name] += n
    log(f"[roofline] fig3 sparse GCN on skewed-powerlaw (max_degree 128, 2 sequential chunks, "
        f"balance (2, 2)): slots per chunk {report['slots']}; rates {CARD}; SpMM launches "
        f"recorded (warm-up + capture) {launched} [{H.card}]")
    for row in report["stages"]:
        for name in ("padded", "bucketed"):
            share = row[name]["roof_share"]
            if share > ROOF_SHARE_MAX:
                raise AssertionError(f"roofline: stage {row['stage']} {name} roof_share {share}")
        log(f"[roofline]   stage {row['stage']} {row['layers']}: roof {row['roof_flops']:.0f} "
            f"FLOPs, {row['roof_bytes']:.0f} B, roof {row['roof_ms']:.6f} ms; padded "
            f"{row['padded']['measured_ms']:.6f} ms (roof_share "
            f"{row['padded']['roof_share']:.6f}), bucketed {row['bucketed']['measured_ms']:.6f} "
            f"ms (roof_share {row['bucketed']['roof_share']:.6f}) per chunk [{H.card}]")

    # each kernel against its plain version on every chunk, at both GCN layers' inputs
    for c in range(plan.chunks):
        chunk = padded.chunk(c)
        zero = (chunk.norm == 0).all(dim=1)
        for i, call in enumerate(gcn_calls(torch, model, params, chunk,
                                           [(chunk.neighbors, chunk.norm)])):
            H.compare_spmm("padded_spmm_kernel", f"skewed-powerlaw padded chunk {c} gcn_{i}",
                           *call, zero_rows=zero)
        chunk = layout.chunk(c)
        tiles = [(b.neighbors, b.norm) for b in chunk.buckets if b.rows]
        for i, call in enumerate(gcn_calls(torch, model, params, chunk, tiles)):
            H.compare_spmm("bucket_spmm_kernel", f"skewed-powerlaw bucketed chunk {c} "
                           f"gcn_{i // len(tiles)} bucket {i % len(tiles)}", *call,
                           zero_rows=(call[2] == 0).all(dim=1))


# ------------------------------------------------- LM serving (phases 2, 5, 8, 9) --


def flash_bound(q, k, v, window=0, q_pos=None, kv_pos=None):
    """(bound_ms, bound_by, bytes, ops, cuda_core_ms) of one fp32 flash
    launch, from ``roofline.kernel_cost.flash_cost`` (the count the dry run
    reads): q, k, v read once and the output written once; per needed
    (query, key) pair a hd-long dot product and a hd_v-long multiply-add (2
    operations each) plus 4 softmax operations; with positions, the pairs
    their mask needs. The bound counts the operations as the fp32-accurate
    kernel issues them, three TF32 tensor-core products each (3xTF32) at the
    TF32 rate; ``cuda_core_ms`` is the same count at the fp32 CUDA-core
    rate, printed beside it."""
    from repro_torch.kernels.flash.kernel import cost
    from repro_torch.roofline.kernel_cost import bound

    ops, nbytes = cost(q, k, v, window=window, q_pos=q_pos, kv_pos=kv_pos)
    t_bytes, t_ops = (t * 1e3 for t in bound(ops, nbytes, CARD))
    return (max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops,
            ops / CARD.fp32_flops * 1e3)


def ssd_bound(x, B, chunk):
    """(bound_ms, bound_by, bytes, ops, cuda_core_ms) of one SSD wrapper call,
    from ``roofline.kernel_cost.ssd_cost``: x, dt, loga, B, C read once, y
    and the final state written once; per chunk and head the causal half of
    C·Bᵀ and of G·(x·dt), C·Hᵀ and the state update, as multiply-adds. The
    bound counts them as the kernel issues them, three TF32 tensor-core
    products each (3xTF32) at the TF32 rate; ``cuda_core_ms`` is the same
    count at the fp32 CUDA-core rate, printed beside it."""
    from repro_torch.kernels.ssd.kernel import cost
    from repro_torch.roofline.kernel_cost import bound

    ops, nbytes = cost(x, B, chunk=chunk)
    t_bytes, t_ops = (t * 1e3 for t in bound(ops, nbytes, CARD))
    return (max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops,
            ops / CARD.fp32_flops * 1e3)


def flash_inputs(H, b, s, h, kv, hd, hd_v=None, dtype=None):
    t = H.torch
    dtype = t.float32 if dtype is None else dtype
    shapes = ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd if hd_v is None else hd_v))
    return tuple(t.randn(sh, generator=H.gen, device=H.dev).to(dtype) for sh in shapes)


def t_row(H, arch, s):
    """The mask positions of ``arch``'s model at S rows on the card, as
    ``attn_apply`` passes them: the m-rope t-row (``make_positions(cfg,
    S)[0]``: the frontend rows at 0, then the text from 1), else None (the
    index path)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer.model import make_positions

    cfg = get_arch(arch)
    return make_positions(cfg, s, device=H.dev)[0] if cfg.rope_kind == "mrope" else None


def frontend_t_row(H, s, s_front):
    """A t-row of ``make_positions``' form: ``s_front`` rows at 0, then 1, 2, ..."""
    t = H.torch
    idx = t.arange(s, dtype=t.int32, device=H.dev)
    return t.where(idx < s_front, 0, idx - s_front + 1).to(t.int32)


def ssd_inputs(H, b, s, h, p, n):
    """SSD inputs at the JAX SSD tests' scales; loga = A·dt as the op forms it."""
    t = H.torch
    x = t.randn((b, s, h, p), generator=H.gen, device=H.dev) * 0.5
    dt = t.nn.functional.softplus(t.randn((b, s, h), generator=H.gen, device=H.dev)) * 0.1
    A = -t.exp(t.linspace(0.0, 2.0, h, device=H.dev))
    B = t.randn((b, s, n), generator=H.gen, device=H.dev) * 0.3
    C = t.randn((b, s, n), generator=H.gen, device=H.dev) * 0.3
    return x, dt, (dt * A).contiguous(), B, C


def compare_flash(H, label, q, k, v, window=0, softcap=0.0, tol=FLASH_ATOL, out=None,
                  q_pos=None, kv_pos=None):
    """Flash kernel vs its plain version on the same card inputs (``out``:
    the kernel's output from the main path, else launched here), masked by
    ``q_pos``/``kv_pos`` where given. The plain version runs in float64
    (``plain64``). bf16 errors are kept apart from the fp32 ones the
    ``kernels`` line reports."""
    pos = {"q_pos": q_pos, "kv_pos": kv_pos}
    got = H.FK.flash_attention_kernel(q, k, v, window=window, softcap=softcap, **pos) \
        if out is None else out
    H.torch.cuda.synchronize()
    want = plain64(q, k, v, window=window, softcap=softcap, **pos)
    b, s, h, hd = q.shape
    key = "flash_attention_kernel" + ("" if q.dtype == H.torch.float32 else " bf16")
    front = "" if q_pos is None else f" t0={int((q_pos == q_pos[0]).sum()):3d}"
    return H._held(key, label, got, want, None,
                   f"B={b} S={s:4d} H={h:2d} KV={k.shape[2]:2d} hd={hd:3d} hd_v={v.shape[-1]:3d} "
                   f"win={window} cap={softcap} {str(q.dtype)[6:]}{front}", atol=tol, rtol=tol)


def plain64(q, k, v, **kw):
    """The flash kernel's plain version on the same inputs, computed in
    float64: at a full-width model's activations (arctic-480b's scores reach
    ~30) its float32 rounding alone moves the output by nearly the 1e-5
    tolerance (``KernelCapture.compare`` prints the share it uses)."""
    from repro_torch.kernels.flash.ref import flash_attention_ref

    return flash_attention_ref(q.double(), k.double(), v.double(), **kw)


def sdpa_call(torch, q, k, v, q_pos=None, kv_pos=None):
    """``fn() -> out`` (model layout): ``scaled_dot_product_attention`` on
    the same tensors, heads moved to dim 1 once, GQA by ``enable_gqa``;
    ``is_causal=True`` without positions, else the boolean mask
    ``kv_pos[j] <= q_pos[i]`` (built once)."""
    import torch.nn.functional as F

    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    gqa = k.shape[2] != q.shape[2]
    if q_pos is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=gqa).transpose(1, 2)
    mask = kv_pos[None, :] <= q_pos[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa).transpose(1, 2)


def sdpa_tolerance_used(torch, q, k, v, q_pos=None, kv_pos=None):
    """How close ``scaled_dot_product_attention`` (``sdpa_call``) comes to
    the flash tolerance against the plain version (in float64, ``plain64``)
    on the same fp32 inputs (the yardstick's own accuracy, beside the
    kernel's; not enforced)."""
    return tolerance_used(sdpa_call(torch, q, k, v, q_pos, kv_pos)(),
                          plain64(q, k, v, q_pos=q_pos, kv_pos=kv_pos))


def tolerance_used(got, want):
    """The largest share of the flash tolerance that ``got`` uses against
    ``want`` (1 = at it)."""
    diff = (got.double() - want.double()).abs()
    return float((diff / (FLASH_ATOL + FLASH_RTOL * want.double().abs())).max())


def compare_ssd(H, label, x, dt, loga, B, C, chunk, out=None):
    """SSD kernel vs its plain version, y and final state, on the same card
    inputs (``out``: the kernel's (y, state) from the main path)."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan

    got = H.DK.ssd_kernel(x, dt, loga, B, C, chunk=chunk) if out is None else out
    H.torch.cuda.synchronize()
    want = ssd_chunk_scan(x, dt, loga, B, C, chunk=chunk)
    b, s, h, p = x.shape
    shape = f"b={b} S={s:4d} h={h:2d} P={p:3d} N={B.shape[-1]:3d} chunk={chunk:3d}"
    for part, g, w in (("y", got[0], want[0]), ("state", got[1], want[1])):
        H._held("ssd_kernel", f"{label} {part}", g, w, None, shape, atol=SSD_ATOL, rtol=0.0)
    return got


def phase_compare_lm(H, torch):
    """Phase 2 for the LM kernels: main-path shapes and edge cases."""
    compare_flash(H, "codeqwen prefill launch shape", *flash_inputs(H, 4, 512, 32, 32, 128))
    compare_flash(H, "GQA 32/16", *flash_inputs(H, 2, 256, 32, 16, 128))
    compare_flash(H, "GQA 8/1", *flash_inputs(H, 2, 256, 8, 1, 64))
    compare_flash(H, "window 128", *flash_inputs(H, 2, 512, 8, 4, 128), window=128)
    compare_flash(H, "softcap 50", *flash_inputs(H, 2, 256, 8, 4, 128), softcap=50.0)
    for s in (64, 200, 513):
        compare_flash(H, f"ragged S {s}", *flash_inputs(H, 2, s, 8, 8, 128))
    compare_flash(H, "hd_v != hd", *flash_inputs(H, 2, 192, 8, 2, 96, hd_v=64))
    compare_flash(H, "S 300, GQA 8/2", *flash_inputs(H, 2, 300, 8, 2, 128, dtype=torch.bfloat16),
                  tol=FLASH_BF16_TOL)
    # the tensor-core tilings' edges: S around the 16-row warp tiles, the
    # 32/64-key KV tiles and the 64/128-row query tiles
    for s in (1, 63, 65, 127, 129, 513):
        compare_flash(H, f"Sq = Skv = {s}", *flash_inputs(H, 2, s, 8, 4, 128))
    for hd, hd_v in ((64, 64), (128, 128), (128, 64), (256, 256)):
        compare_flash(H, f"hd/hd_v {hd}/{hd_v}", *flash_inputs(H, 2, 300, 8, 4, hd, hd_v=hd_v))
    compare_flash(H, "window 100 crossing tile edges", *flash_inputs(H, 2, 300, 8, 4, 128),
                  window=100)
    compare_flash(H, "window 40, softcap 30, hd 64", *flash_inputs(H, 2, 257, 8, 4, 64),
                  window=40, softcap=30.0)
    compare_flash(H, "GQA 32/8", *flash_inputs(H, 2, 256, 32, 8, 128))
    for s, hd, window in ((129, 64, 0), (513, 128, 100), (65, 256, 0)):
        compare_flash(H, f"S {s} hd {hd} window {window}",
                      *flash_inputs(H, 2, s, 8, 2, hd, dtype=torch.bfloat16), window=window,
                      tol=FLASH_BF16_TOL)
    # zamba2's shared block: hd 112, 32 heads, its prefill and training
    # launches (4 rows a micro-batch) and the whole batch of 8
    for b, s in ((4, 512), (4, 256), (8, 512), (8, 256)):
        compare_flash(H, f"zamba2 hd 112, B {b} S {s}", *flash_inputs(H, b, s, 32, 32, 112))
    # phase 18's launches, prefill (S 512) and training (S 256), 4 rows a
    # micro-batch: arctic's GQA 56/8 (a grouping of 7) at hd 128, and
    # deepseek's MLA, MHA 128/128 at q/k head dim 192 and v head dim 128
    # (the HDV = 256 tiles: the output columns past 128 are neither read
    # nor written); then MLA's dims ragged, windowed and in bf16
    for s in (512, 256):
        compare_flash(H, f"arctic GQA 56/8, B 4 S {s}", *flash_inputs(H, 4, s, 56, 8, 128))
        compare_flash(H, f"deepseek MLA 192/128, B 4 S {s}",
                      *flash_inputs(H, 4, s, 128, 128, 192, hd_v=128))
    compare_flash(H, "MLA 192/128, S 300, window 100",
                  *flash_inputs(H, 2, 300, 8, 8, 192, hd_v=128), window=100)
    compare_flash(H, "MLA 192/128, S 300", *flash_inputs(H, 2, 300, 8, 8, 192, hd_v=128,
                                                         dtype=torch.bfloat16),
                  tol=FLASH_BF16_TOL)
    # phase 17's launches: musicgen (MHA 32/32, hd 64, the index path) and
    # qwen2-vl (GQA 12/2, hd 128, masked by the m-rope t-row: 128 and 64
    # frontend rows at t = 0, each seeing all the others)
    for s in (512, 256):
        pos = t_row(H, "musicgen-large", s)
        compare_flash(H, f"musicgen B 4 S {s}", *flash_inputs(H, 4, s, 32, 32, 64), q_pos=pos,
                      kv_pos=pos)
        pos = t_row(H, "qwen2-vl-2b", s)
        compare_flash(H, f"qwen2-vl B 4 S {s}, t-row", *flash_inputs(H, 4, s, 12, 2, 128),
                      q_pos=pos, kv_pos=pos)
    # the position mask's edges: a prefix ending inside a KV tile, a prefix
    # and a window, every row in the prefix, hd 64 and 256, bf16
    for s, s_front, window, hd in ((300, 100, 0, 128), (300, 100, 40, 128), (257, 33, 20, 64),
                                   (70, 70, 0, 128), (200, 50, 0, 256)):
        pos = frontend_t_row(H, s, s_front)
        compare_flash(H, f"prefix {s_front} of {s}, window {window}",
                      *flash_inputs(H, 2, s, 8, 2, hd), window=window, q_pos=pos, kv_pos=pos)
        compare_flash(H, f"prefix {s_front} of {s}, window {window}",
                      *flash_inputs(H, 2, s, 8, 2, hd, dtype=torch.bfloat16), window=window,
                      q_pos=pos, kv_pos=pos, tol=FLASH_BF16_TOL)
    # null pointers (the index path) and positions arange(S): bit for bit
    for s, hd, window, dtype in ((512, 128, 0, torch.float32), (512, 64, 0, torch.float32),
                                 (300, 128, 100, torch.float32), (129, 256, 0, torch.float32),
                                 (300, 128, 0, torch.bfloat16)):
        q, k, v = flash_inputs(H, 2, s, 8, 4, hd, dtype=dtype)
        pos = torch.arange(s, dtype=torch.int32, device=H.dev)
        index = H.FK.flash_attention_kernel(q, k, v, window=window)
        by_pos = H.FK.flash_attention_kernel(q, k, v, window=window, q_pos=pos, kv_pos=pos)
        if not torch.equal(index, by_pos):
            raise AssertionError(f"flash S {s} hd {hd} window {window} {dtype}: positions "
                                 "arange(S) differ from the index path")
        log(f"[compare] flash_attention_kernel S={s} hd={hd} win={window} {str(dtype)[6:]}: "
            "null-pointer (index) launch == positions arange(S), bit for bit")
    compare_ssd(H, "mamba2-130m prefill launch shape", *ssd_inputs(H, 4, 512, 24, 64, 128), 128)
    for s in (512, 256):  # zamba2's mixer: 112 heads, state 64
        compare_ssd(H, f"zamba2 112 heads N 64, b 4 S {s}", *ssd_inputs(H, 4, s, 112, 64, 64), 128)
    for s in (64, 200):
        compare_ssd(H, f"ragged S {s}", *ssd_inputs(H, 4, s, 24, 64, 128), 128)
    compare_ssd(H, "chunk 32", *ssd_inputs(H, 4, 512, 24, 64, 128), 32)
    # the chunk-parallel design's edges: one token, 16 chunks through the
    # state pass, strong decay (exp(la) underflows, exp above the diagonal
    # would overflow), a grid that is not a multiple of 132 blocks
    compare_ssd(H, "S 1", *ssd_inputs(H, 2, 1, 24, 64, 128), 128)
    compare_ssd(H, "S 2048, 16 chunks", *ssd_inputs(H, 1, 2048, 8, 64, 128), 128)
    x, dt, loga, B, C = ssd_inputs(H, 2, 512, 24, 64, 128)
    compare_ssd(H, "strong decay, loga x 40", x, dt, (loga * 40.0).contiguous(), B, C, 128)
    compare_ssd(H, "b h chunks 45", *ssd_inputs(H, 3, 300, 5, 64, 128), 128)


def phase_timing_lm(H, torch):
    """Phase 5 for the LM kernels at their main-path launch shapes: kernel,
    plain version, bound and (flash) ``scaled_dot_product_attention`` on the
    same fp32 tensors with TF32 off."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash.ref import flash_attention_ref
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan

    def flash_timing(label, q, k, v, pos=None, position_path_too=False):
        """``pos``: the kernel's positions, which the library call takes as a
        boolean mask (else ``is_causal``); ``position_path_too``: also time
        the position path on the same inputs at positions arange(S), which
        no rope arch runs (its cost beside the index path's)."""
        kw = {"q_pos": pos, "kv_pos": pos}
        library = sdpa_call(torch, q, k, v, pos, pos)
        if not torch.allclose(library(), flash_attention_ref(q, k, v, **kw), atol=FLASH_ATOL,
                              rtol=FLASH_RTOL):
            raise AssertionError("scaled_dot_product_attention disagrees with the plain version")
        ms = H.time_ms(lambda: H.FK.flash_attention_kernel(q, k, v, **kw, ordered=True))
        by_pos = ""
        if position_path_too:
            ar = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
            pos_ms = H.time_ms(lambda: H.FK.flash_attention_kernel(q, k, v, q_pos=ar, kv_pos=ar,
                                                                   ordered=True))
            by_pos = f" (the position path at positions arange: {pos_ms:.6f} ms)"
        plain_ms = H.time_ms(lambda: flash_attention_ref(q, k, v, **kw))
        library_ms = H.time_ms(library)
        bound_ms, bound_by, nbytes, nops, cuda_core_ms = flash_bound(q, k, v, 0, pos, pos)
        sdpa = "kernels: " + ", ".join(k for k, _, _ in device_kernel_times(
            torch, library, calls=1))
        mask = "is_causal" if pos is None else "boolean attn_mask"
        log(f"[timing] flash_attention_kernel {label}: kernel {ms:.6f} ms{by_pos}, plain "
            f"{plain_ms:.6f} ms, scaled_dot_product_attention ({mask}) {library_ms:.6f} ms "
            f"({sdpa}), "
            f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {nops} ops as 3xTF32 tensor-core "
            f"products at {CARD.tf32_flops:.3g}/s; on the fp32 CUDA cores {cuda_core_ms:.6f} ms), "
            f"share of bound {bound_ms / ms:.3f}, achieved {nops / ms / 1e9:.3f} TFLOP/s "
            f"[{H.card}]")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    H.timing["flash_attention_kernel"] = flash_timing(
        "one codeqwen prefill launch (4 x 512 tokens, 32 heads, hd 128, causal, fp32)",
        *flash_inputs(H, 4, 512, 32, 32, 128))
    for s in (512, 256):
        flash_timing(f"one zamba2 {'prefill' if s == 512 else 'training'} launch (4 x {s} "
                     f"tokens, 32 heads, hd 112, causal, fp32)", *flash_inputs(H, 4, s, 32, 32, 112))
    # phase 17's launches, at the positions the model passes
    for s in (512, 256):
        what = "prefill" if s == 512 else "training"
        flash_timing(f"one musicgen {what} launch (4 x {s} rows, 32/32 heads, hd 64, causal, "
                     f"fp32)", *flash_inputs(H, 4, s, 32, 32, 64),
                     pos=t_row(H, "musicgen-large", s), position_path_too=True)
        flash_timing(f"one qwen2-vl {what} launch (4 x {s} rows, 12/2 heads, hd 128, m-rope "
                     f"t-row with {s // 4} frontend rows, fp32)",
                     *flash_inputs(H, 4, s, 12, 2, 128), pos=t_row(H, "qwen2-vl-2b", s))

    # phase 18's prefill launches
    flash_timing("one arctic prefill launch (4 x 512 tokens, GQA 56/8, hd 128, causal, fp32)",
                 *flash_inputs(H, 4, 512, 56, 8, 128))
    flash_timing("one deepseek MLA prefill launch (4 x 512 tokens, 128/128 heads, hd 192, hd_v "
                 "128, causal, fp32)", *flash_inputs(H, 4, 512, 128, 128, 192, hd_v=128))

    for s in (512, 256):
        x, dt, loga, B, C = ssd_inputs(H, 4, s, 112, 64, 64)
        ms = H.time_ms(lambda: H.DK.ssd_kernel(x, dt, loga, B, C, chunk=128))
        plain_ms = H.time_ms(lambda: ssd_chunk_scan(x, dt, loga, B, C, chunk=128))
        bound_ms, bound_by, nbytes, nops, _ = ssd_bound(x, B, 128)
        log(f"[timing] ssd_kernel one zamba2 {'prefill' if s == 512 else 'training'} launch (4 x "
            f"{s} tokens, 112 heads, P 64, N 64, chunk 128): kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, library none, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, "
            f"{nops} ops as 3xTF32), share of bound {bound_ms / ms:.3f} [{H.card}]")

    x, dt, loga, B, C = ssd_inputs(H, 4, 512, 24, 64, 128)
    ms = H.time_ms(lambda: H.DK.ssd_kernel(x, dt, loga, B, C, chunk=128))
    plain_ms = H.time_ms(lambda: ssd_chunk_scan(x, dt, loga, B, C, chunk=128))
    bound_ms, bound_by, nbytes, nops, cuda_core_ms = ssd_bound(x, B, 128)
    seen = device_kernel_times(torch, lambda: H.DK.ssd_kernel(x, dt, loga, B, C, chunk=128))
    per_launch = [(short, t, n) for short in SSD_LAUNCH_KERNELS for k, t, n in seen if short in k]
    if len(seen) != len(SSD_LAUNCH_KERNELS) or len(per_launch) != len(SSD_LAUNCH_KERNELS) or any(
            n != 1 for _, _, n in per_launch):
        raise AssertionError(f"ssd_kernel: one call should launch each of {SSD_LAUNCH_KERNELS} "
                             f"once, the profiler saw {seen}")
    H.timing["ssd_kernel"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": None}
    log(f"[timing] ssd_kernel one mamba2-130m prefill launch (4 x 512 tokens, 24 heads, P 64, "
        f"N 128, chunk 128): kernel {ms:.6f} ms in {len(per_launch)} CUDA launches a call ("
        + ", ".join(f"{k} {t:.6f} ms" for k, t, _ in per_launch)
        + f", profiled), plain {plain_ms:.6f} ms, library none (no single PyTorch call), bound "
        f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B, {nops} ops as 3xTF32 tensor-core products at "
        f"{CARD.tf32_flops:.3g}/s; on the fp32 CUDA cores {cuda_core_ms:.6f} ms), share of bound "
        f"{bound_ms / ms:.3f}, achieved {nops / ms / 1e9:.3f} TFLOP/s [{H.card}]")
    log_floors(H)


def device_kernel_times(torch, fn, calls=10):
    """[(device kernel name, ms per call, launches per call)] of ``fn``, from
    one ``torch.profiler`` pass over ``calls`` calls."""
    fn()

    def run():
        for _ in range(calls):
            fn()

    _, kernels = profiled(torch, run)
    out = [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls) for e in kernels]
    if not out:
        raise AssertionError("torch.profiler recorded no device kernel")
    return out


def log_floors(H):
    """Each redesigned kernel's time against its floor, and against its
    library call where there is one (not enforced)."""
    for name, floor in FLOOR_MS.items():
        tm = H.timing[name]
        versus = "none" if tm["library_ms"] is None else (
            f"{tm['library_ms']:.6f} ms: {'no slower' if tm['ms'] <= tm['library_ms'] else 'slower'}")
        log(f"[timing] floor {name}: {tm['ms']:.6f} ms vs {floor} ms: "
            f"{'meets' if tm['ms'] <= floor else 'MISSES'}; library {versus} [{H.card}]")


def profile_steps(H, torch, label, served, keys):
    """Device busy share of one prefill's and of two decode steps' wall time
    and the named kernels' share of the prefill's device time, from
    ``torch.profiler`` (the decode cache is zeros: a step's work does not
    depend on its contents)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models.transformer.model import init_cache, make_prefill_step, make_serve_step
    from repro_torch.roofline import model_flops

    b, plen = served.prompt.shape[0], served.prompt_len
    pshape = ShapeConfig("profile", plen, b, "prefill")
    dshape = ShapeConfig("profile", plen + 32, b, "decode")
    prefill = make_prefill_step(served.cfg, served.topo, pshape)
    decode = make_serve_step(served.cfg, served.topo, dshape)
    tok = served.prompt[:, -1].to(torch.int32)

    def traced(fn, cache, steps):
        def run():
            with torch.inference_mode():
                for i in range(steps):
                    fn(i, cache)

        wall_ms, kernels = profiled(torch, run)
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        if device_ms <= 0:
            raise AssertionError(f"torch.profiler recorded no device time for {label}")
        return wall_ms, device_ms, kernels

    pcache = init_cache(served.cfg, served.topo, pshape, device=H.dev)
    wall_ms, device_ms, kernels = traced(
        lambda i, c: prefill(served.params, c, served.batch()), pcache, 1)
    del pcache
    mine_ms = sum(e.self_device_time_total for e in kernels
                  if any(k in e.key for k in keys)) / 1e3
    flops = model_flops(served.cfg, pshape, training=False)
    log(f"[profile] {label} prefill (profiled): wall {wall_ms:.3f} ms, device busy "
        f"{device_ms:.3f} ms ({device_ms / wall_ms:.3f} of wall), {'+'.join(keys)} {mine_ms:.3f} ms "
        f"({mine_ms / device_ms:.3f} of device time); model FLOPs {flops:.6g} (model_flops), "
        f"{flops / (wall_ms / 1e3) / CARD.fp32_flops:.4f} of the fp32 peak over the wall "
        f"[{H.card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")

    dcache = init_cache(served.cfg, served.topo, dshape, device=H.dev)
    step = lambda i, c: decode(served.params, c, {"tokens": tok, "pos": plen + i})
    with torch.inference_mode():
        step(0, dcache)  # warm-up
    wall_ms, device_ms, kernels = traced(lambda i, c: step(i + 1, c), dcache, 2)
    del dcache
    flops = 2 * model_flops(served.cfg, dshape, training=False)
    log(f"[profile] {label} decode, 2 steps (profiled): wall {wall_ms:.3f} ms, device busy "
        f"{device_ms:.3f} ms ({device_ms / wall_ms:.3f} of wall); model FLOPs {flops:.6g}, "
        f"{flops / (wall_ms / 1e3) / CARD.fp32_flops:.6f} of the fp32 peak over the wall "
        f"[{H.card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")


class KernelCapture:
    """Route the flash and SSD ops' kernel wrappers through recorders while
    a main path runs: each wrapper's count starts at 0, the first
    ``limits[name]`` calls' (args, kwargs, output) are kept in
    ``captured[name]``, and ``launches[name]`` holds the count on exit."""

    def __init__(self, limits: dict):
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.ssd import ops as ssd_ops

        self.ops = {"flash_attention_kernel": flash_ops, "ssd_kernel": ssd_ops}
        self.limits = limits
        self.captured = {name: [] for name in limits}
        self.launches = {}

    def __enter__(self):
        self.wrappers = {}
        for name, limit in self.limits.items():
            wrapper = self.wrappers[name] = getattr(self.ops[name], name)
            kept = self.captured[name]

            def record(*a, wrapper=wrapper, kept=kept, limit=limit, **kw):
                out = wrapper(*a, **kw)
                if len(kept) < limit:  # the op's autograd marks the outputs themselves
                    kept.append((tuple(x.detach() for x in a), kw,
                                 tuple(y.detach() for y in out) if isinstance(out, tuple)
                                 else out.detach()))
                return out

            wrapper.launches = 0
            setattr(self.ops[name], name, record)
        return self

    def __exit__(self, *exc):
        for name, wrapper in self.wrappers.items():
            setattr(self.ops[name], name, wrapper)
            self.launches[name] = wrapper.launches
        return False

    def compare(self, H, torch, label):
        """Hold every kept call against the plain version on its own inputs;
        returns the largest shares of the flash tolerance that
        ``scaled_dot_product_attention`` (on the global, uncapped calls) and
        the float32 plain version use against the float64 one."""
        from repro_torch.kernels.flash.ref import flash_attention_ref

        sdpa_used = plain32_used = 0.0
        for name, calls in self.captured.items():
            for i, (a, kw, out) in enumerate(calls):
                if name == "flash_attention_kernel":
                    pos = {"q_pos": kw.get("q_pos"), "kv_pos": kw.get("kv_pos")}
                    args = {"window": kw["window"], "softcap": kw["softcap"], **pos}
                    compare_flash(H, f"{label} call {i:3d}", *a, out=out, **args)
                    plain32_used = max(plain32_used, tolerance_used(
                        flash_attention_ref(*a, **args), plain64(*a, **args)))
                    if kw["window"] == 0 and kw["softcap"] == 0.0:
                        sdpa_used = max(sdpa_used, sdpa_tolerance_used(torch, *a, **pos))
                else:
                    compare_ssd(H, f"{label} call {i:3d}", *a, kw["chunk"], out=out)
        self.captured = {}
        return sdpa_used, plain32_used


@contextlib.contextmanager
def no_expert_drops():
    """While active, every expert of an MoE call takes all of the call's
    tokens (``moe.expert_capacity`` = T): no call drops a token. A decode
    step routes b_mb <= 8 tokens a call at capacity >= 8 and drops none; a
    prefill at the reference's capacity may drop (arctic-480b and
    deepseek-v3-671b do at full width), so decode is held to a prefill that
    drops none."""
    from repro_torch.models.transformer import moe

    inner = moe.expert_capacity
    moe.expert_capacity = lambda tokens, *args, **kw: tokens
    try:
        yield
    finally:
        moe.expert_capacity = inner


def active_slots(cfg, num_stages=1) -> dict:
    """{kernel: active layer slots whose forward calls it}."""
    from repro_torch.models.transformer.model import make_extras

    ex = make_extras(cfg, num_stages)
    if cfg.arch_type == "hybrid":
        return {"flash_attention_kernel": int(ex["attn"]["active"].sum()),
                "ssd_kernel": int(ex["mamba"]["active"].sum())}
    name = "ssd_kernel" if cfg.arch_type == "ssm" else "flash_attention_kernel"
    return {name: int(ex["active"].sum())}


def cut_config(cfg, cut):
    """(``cfg`` with the fields of ``cut`` replaced, a note of the cut)."""
    if not cut:
        return cfg, ""
    note = ", cut: " + ", ".join(f"{k} {getattr(cfg, k)} -> {v}" for k, v in cut.items())
    return dataclasses.replace(cfg, **cut), note


def phase_serve_lm(H, torch, arch, cut=None):
    """Phases 8, 9, 16c, 17 and 18's serving: serve ``arch`` at full width
    (its config's fields ``cut``, e.g. the depth, replaced where given)
    through ``repro_torch.launch.serve``; each kernel of its blocks must
    launch once per active layer slot and micro-batch in the prefill. Each
    slot's own kernel inputs and output from micro-batch 0 are captured on
    the way and held against the plain version; the first decode step's
    logits are held
    against a fresh prefill over the prompt (frontend rows included) plus the
    first token. On m-rope (qwen2-vl) the fresh prefill's last row takes the
    positions the decode gives it, (plen, plen, plen) as the reference's
    decode does; the gap to a prefill at ``make_positions(plen + 1)`` is the
    reference's own inconsistency (ROADMAP queue 3), printed, not held."""
    import numpy as np

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.serve import build_parser, serve
    from repro_torch.models.transformer.model import (
        _prefill, init_cache, make_extras, make_positions)

    args = build_parser().parse_args(["--arch", arch, *LM_SERVE_ARGS])
    cfg, cut_note = cut_config(get_arch(arch, smoke=not args.full_arch), cut)
    slots = active_slots(cfg)
    with KernelCapture(slots) as cap:
        served = serve(args, cfg)
    torch.cuda.synchronize()
    summary, gen = served.summary, served.generation
    for name, n in slots.items():
        want = n * args.chunks
        if cap.launches[name] != want:
            raise AssertionError(f"{arch}: {name} launched {cap.launches[name]} times in the "
                                 f"prefill, want {want} ({n} layer slots x {args.chunks} "
                                 "micro-batches)")
        H.launches[name] = H.launches.get(name, 0) + want
    if gen.tokens.shape != (args.batch, args.decode_steps + 1):
        raise AssertionError(f"{arch}: generated tokens {gen.tokens.shape}")
    for logits in (gen.prefill_logits, gen.first_decode_logits):
        if logits.shape != (args.batch, served.cfg.vocab_size) or not bool(logits.isfinite().all()):
            raise AssertionError(f"{arch}: logits of shape {tuple(logits.shape)} or non-finite")

    sdpa_used, plain32_used = cap.compare(H, torch, f"{arch} prefill micro-batch 0")
    if "flash_attention_kernel" in slots:
        log(f"[serve-lm] {arch} layers' own inputs, share of the flash tolerance used at most "
            f"against the float64 plain version: flash kernel "
            f"{H.used['flash_attention_kernel']:.3f} (all compares), "
            f"scaled_dot_product_attention {sdpa_used:.3f}, the float32 plain version "
            f"{plain32_used:.3f} (these layers) [{H.card}]")

    # decode vs prefill: the logits at position prompt_len, two ways
    b, plen = served.prompt.shape[0], served.prompt_len
    tok0 = torch.from_numpy(gen.tokens[:, 0]).to(H.dev, torch.int64)
    longer = dict(served.batch(), tokens=torch.cat([served.prompt, tok0[:, None]], dim=1))
    shape = ShapeConfig("check", plen + 1, b, "prefill")

    def fresh_prefill(positions=None, topo=None):
        cfg, topo = served.cfg, topo or served.topo
        with torch.inference_mode():
            logits, _ = _prefill(cfg, topo, make_extras(cfg, topo.num_stages), served.params,
                                 init_cache(cfg, topo, shape, device=H.dev), longer, plen + 1,
                                 positions)
        torch.cuda.synchronize()
        return logits

    mrope = served.cfg.rope_kind == "mrope"
    own = None
    if mrope:  # the decode's own positions for the last row
        own = torch.from_numpy(np.concatenate([make_positions(served.cfg, plen).numpy(),
                                               np.full((3, 1), plen, np.int32)], axis=1))
    moe_note = reference_gap = ""
    if served.cfg.num_experts:  # one row a micro-batch, each expert taking all its tokens
        with no_expert_drops():
            fresh = fresh_prefill(own, dataclasses.replace(served.topo, num_micro=b))
        at_capacity = fresh_prefill(own)
        gap = float((gen.first_decode_logits - at_capacity).abs().max())
        gap_agree = int((gen.first_decode_logits.argmax(-1) == at_capacity.argmax(-1)).sum())
        moe_note = (f" with no expert drops (one row a micro-batch, capacity its {plen + 1} "
                    "tokens)")
        reference_gap = (f"; against the served topology's prefill at the reference's capacity, "
                         f"which drops: max |logit diff| {gap:.6g}, argmax agree {gap_agree}/{b}, "
                         "measured, not held")
    else:
        fresh = fresh_prefill(own)
    err = float((gen.first_decode_logits - fresh).abs().max())
    agree = int((gen.first_decode_logits.argmax(-1) == fresh.argmax(-1)).sum())
    if mrope:
        at_t = fresh_prefill()
        gap = float((gen.first_decode_logits - at_t).abs().max())
        gap_agree = int((gen.first_decode_logits.argmax(-1) == at_t.argmax(-1)).sum())
        reference_gap = (
            f"; against a fresh prefill at make_positions({plen + 1}) (last row t "
            f"{plen - int(plen * served.cfg.frontend_frac) + 1}, where the reference's decode "
            f"rotates by {plen}): max |logit diff| {gap:.6g}, argmax agree {gap_agree}/{b}, "
            "measured, not held (the reference's own m-rope decode/prefill gap)")
    if not err <= DECODE_VS_PREFILL_ATOL:
        raise AssertionError(f"{arch}: decoded logits at position {plen} differ from a fresh "
                             f"{plen + 1}-token prefill by {err:.3g} (limit "
                             f"{DECODE_VS_PREFILL_ATOL})")
    launched = ", ".join(f"{name} launches {cap.launches[name]} ({n} slots x {args.chunks})"
                         for name, n in slots.items())
    front = "" if served.frontend_embeds is None else \
        f" ({served.frontend_embeds.shape[1]} frontend rows)"
    log(f"[serve-lm] {arch} full width{cut_note} ({summary['params']} params, fp32), batch {b}, "
        f"prompt "
        f"{plen}{front}, {args.decode_steps} decode steps, {args.chunks} micro-batches: prefill_s "
        f"{summary['prefill_s']}, decode_s_per_tok {summary['decode_s_per_tok']}, tokens_per_s "
        f"{summary['tokens_per_s']}, peak_mem_gb {summary['peak_mem_gb']}, sample "
        f"{summary['sample']}; {launched}; decode vs fresh {plen + 1}-row prefill"
        f"{' at the decode positions' if mrope else ''}{moe_note}: max |logit diff| {err:.6g} "
        f"(limit {DECODE_VS_PREFILL_ATOL}), argmax agree {agree}/{b}{reference_gap} [{H.card}]")
    profile_steps(H, torch, arch, served,
                  tuple(part for name in slots for part in LM_KERNEL_PARTS[name]))
    return summary


# ----------------------------------------------------- LM training (phase 16) --

LM_TRAIN_ARGS = [  # phase 16: the JAX launcher's run_lm defaults at full width, one card
    "--mode", "lm", "--full-arch", "--seq", "256", "--batch", "8", "--lr", "3e-4",
    "--log-every", "0", "--device", "cuda",
]
FIRST_STEP_LOSS_RTOL = 1e-4  # the card's first step against the CPU's, relative
FIRST_STEP_MU_TOL = 1e-3  # Adam's mu after step 1, of each leaf's largest entry
# each kernel's device-side names: flash's one launch, SSD's three
LM_KERNEL_PARTS = {"flash_attention_kernel": ("flash_kernel",), "ssd_kernel": SSD_LAUNCH_KERNELS}
# each op's autograd node, whose range holds its plain backward
BACKWARD_NODES = {"flash_attention_kernel": "_FlashBackward", "ssd_kernel": "_SsdBackward"}


def flat_cpu(tree, prefix=""):
    """{path: CPU copy} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_cpu(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().to("cpu", copy=True)
    return out


def phase_train_lm(H, torch, tag, arch, extra, *, cut=None, cpu_check=False,
                   also=(), falling=False):
    """Phase 16: train ``arch`` at full width (its config's fields ``cut``,
    e.g. the depth, replaced where given) through
    ``repro_torch.launch.train.train_lm`` with the JAX
    launcher's ``run_lm`` defaults plus ``extra``. Every kernel of its
    blocks launches twice (forward and recompute) per active slot,
    micro-batch and step; each call of the first forward is held against
    the plain version at its own inputs. Losses finite; median step after
    the first, tokens/s, peak allocated; one more step profiled: busy share,
    kernel launches and shares, the plain backward's device time, the top
    kernels. ``cpu_check``: the first step against the same step on the CPU
    (plain versions, same params and batch), loss and Adam's mu. ``also``:
    other schedules, run after the main path (its state freed) with its own
    schedule again, all under deterministic algorithms: their losses must
    be bit-identical.
    ``falling``: the loss of step 0's batch, taken again with the trained
    params (``step.loss``, no update), must be below its first value (each
    step draws a fresh batch of near-uniform tokens, so the step losses
    themselves need not fall in a few steps)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.train import build_parser, lm_batch, train_lm
    from repro_torch.models.transformer.model import init_params, make_train_step
    from repro_torch.roofline import model_flops
    from repro_torch.train.optimizer import tree_map

    t_phase = time.perf_counter()
    args = build_parser().parse_args([*LM_TRAIN_ARGS, "--arch", arch, *extra])
    cfg, cut_note = cut_config(get_arch(arch, smoke=not args.full_arch), cut)
    first = {name: n * args.chunks for name, n in active_slots(cfg, args.stages).items()}
    mu_card = {}

    def on_step(i, params, opt_state, loss):
        if i == 0 and cpu_check:
            mu_card.update(flat_cpu(opt_state.mu))

    with KernelCapture(first) as cap:
        trained = train_lm(cfg, args, on_step)
    torch.cuda.synchronize()
    for name, n in first.items():
        want = 2 * n * args.steps
        if cap.launches[name] != want:
            raise AssertionError(f"{arch}: {name} launched {cap.launches[name]} times in "
                                 f"{args.steps} steps, want {want} (forward and recompute x "
                                 f"{n} slot calls)")
        H.launches[name] = H.launches.get(name, 0) + want
    losses, summary = trained.losses, trained.summary
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{arch}: non-finite loss {losses}")
    if falling:
        with torch.no_grad():
            again = float(trained.step.loss(trained.params, lm_batch(cfg, args, 0, H.dev)))
        log(f"[train-lm] {tag} {arch} step 0's batch: loss {losses[0]!r} at the start, "
            f"{again!r} after {args.steps} steps ({again - losses[0]:+.6f}); the last step's "
            f"loss {'below' if losses[-1] < losses[0] else 'not below'} the first's [{H.card}]")
        if not again < losses[0]:
            raise AssertionError(f"{arch}: step 0's batch lost no loss in {args.steps} steps "
                                 f"({losses[0]} -> {again})")
    median = statistics.median(trained.step_s[1:])
    state_gb = 16 * summary["params"] / 1e9
    log(f"[train-lm] {tag} {arch} full width{cut_note} ({summary['params']} params, fp32; "
        f"params + "
        f"grads + Adam mu/nu {state_gb:.3f} GB), topology {trained.topo}, seq {args.seq}, batch "
        f"{args.batch}, lr {args.lr}: losses {losses}; step s {trained.step_s}; median step "
        f"after the first {median:.6f} s, {args.batch * args.seq / median:.1f} tokens/s; peak "
        f"allocated {summary['peak_mem_gb']:.3f} GB ({summary['peak_mem_gb'] - state_gb:.3f} "
        f"beyond the state); launches {cap.launches} [{H.card}]")
    _, plain32_used = cap.compare(H, torch, f"{arch} train step 0 forward")
    if "flash_attention_kernel" in first:
        log(f"[train-lm] {tag} {arch} step 0's flash calls, share of the tolerance used at most "
            f"against the float64 plain version: flash kernel "
            f"{H.used['flash_attention_kernel']:.3f} (all compares so far), the float32 plain "
            f"version {plain32_used:.3f} [{H.card}]")

    batch = lm_batch(cfg, args, args.steps, H.dev)
    wall_ms, kernels, events = profiled(
        torch, lambda: trained.step(trained.params, trained.opt_state, batch), events=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms <= 0:
        raise AssertionError(f"torch.profiler recorded no device time for {arch}'s step")
    parts = []
    for name in first:
        calls = sum(e.count for e in kernels if LM_KERNEL_PARTS[name][-1] in e.key)
        if calls != 2 * first[name]:
            raise AssertionError(f"{arch}: the profiled step ran {LM_KERNEL_PARTS[name][-1]} "
                                 f"{calls} times, want {2 * first[name]}")
        mine = sum(e.self_device_time_total for e in kernels
                   if any(p in e.key for p in LM_KERNEL_PARTS[name])) / 1e3
        back = sum(e.device_time_total for e in events
                   if e.device_type != torch.autograd.DeviceType.CUDA
                   and e.key.endswith(BACKWARD_NODES[name])) / 1e3
        parts.append(f"{name} {calls} launches (forward and recompute) {mine:.3f} ms "
                     f"({mine / device_ms:.3f} of device time), its plain backward "
                     + (f"{back:.3f} ms ({back / device_ms:.3f})" if back > 0 else "not measured"))
    flops = model_flops(cfg, ShapeConfig("train", args.seq, args.batch, "train"), training=True)
    log(f"[profile] {tag} {arch} one train step (profiled): wall {wall_ms:.3f} ms, device busy "
        f"{device_ms:.3f} ms ({device_ms / wall_ms:.3f} of wall); model FLOPs {flops:.6g} "
        f"(model_flops), over the median step {flops / median / CARD.fp32_flops:.4f} of the fp32 "
        f"peak; " + "; ".join(parts) + f" [{H.card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")

    if cpu_check:
        params = init_params(cfg, seed=args.seed, num_stages=trained.topo.num_stages,
                             device=H.dev)
        cpu_params = tree_map(lambda t: t.to("cpu", copy=True), params)
        del params
        step = make_train_step(cfg, trained.topo, ShapeConfig("cpu", args.seq, args.batch,
                                                              "train"), lr=args.lr)
        t0 = time.perf_counter()
        _, cpu_opt, metrics = step(cpu_params, step.optimizer.init(cpu_params),
                                   lm_batch(cfg, args, 0, "cpu"))
        cpu_s = time.perf_counter() - t0
        want = float(metrics["loss"])
        rel = abs(losses[0] - want) / abs(want)
        worst, worst_name = 0.0, ""
        for name, mu in flat_cpu(cpu_opt.mu).items():
            scale = float(mu.abs().max())
            err = float((mu_card[name] - mu).abs().max())
            used = err / (FIRST_STEP_MU_TOL * scale) if scale > 0 else (0.0 if err == 0 else 1e9)
            if used > worst:
                worst, worst_name = used, name
        if not rel <= FIRST_STEP_LOSS_RTOL or worst > 1.0:
            raise AssertionError(f"{arch}: first step on the card vs the CPU: loss rel {rel:.3g} "
                                 f"(limit {FIRST_STEP_LOSS_RTOL}), mu at {worst:.3g} of its "
                                 f"tolerance on {worst_name}")
        log(f"[train-lm] {tag} {arch} first step, card vs CPU (plain versions, {cpu_s:.1f} s on "
            f"the CPU): loss {losses[0]!r} vs {want!r}, relative {rel:.3g} "
            f"({rel / FIRST_STEP_LOSS_RTOL:.3f} of {FIRST_STEP_LOSS_RTOL}); Adam mu after step 1 "
            f"at most "
            f"{worst:.3f} of {FIRST_STEP_MU_TOL} x each leaf's largest entry ({worst_name}) "
            f"[{H.card}]")
    del trained, batch
    gc.collect()
    torch.cuda.empty_cache()
    if also:
        schedules_bit_identical(H, torch, tag, cfg, [*LM_TRAIN_ARGS, "--arch", arch, *extra],
                                (args.schedule, *also), first)
    log(f"[train-lm] {tag} {arch}: phase {time.perf_counter() - t_phase:.1f} s")
    return summary


def schedules_bit_identical(H, torch, tag, cfg, argv, schedules, kernels):
    """Train ``cfg`` once per schedule under deterministic algorithms; every
    run's losses must equal the first's bit for bit, and each must launch
    every kernel of ``kernels``."""
    from repro_torch.launch.train import build_parser, train_lm

    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for schedule in schedules:
            args = build_parser().parse_args([*argv, "--schedule", schedule])
            with KernelCapture({name: 0 for name in kernels}) as cap:
                trained = train_lm(cfg, args)
            if any(cap.launches[name] == 0 for name in kernels):
                raise AssertionError(f"{cfg.name} {schedule}: a kernel was not launched "
                                     f"({cap.launches})")
            for name in kernels:
                H.launches[name] += cap.launches[name]
            runs[schedule] = trained.losses
            log(f"[train-lm] {tag} {cfg.name} {schedule} under deterministic algorithms "
                f"(topology {trained.topo}): losses {trained.losses}; median step "
                f"{statistics.median(trained.step_s[1:]):.6f} s; launches {cap.launches} "
                f"[{H.card}]")
            del trained
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    first = runs[schedules[0]]
    if any(losses != first for losses in runs.values()):
        raise AssertionError(f"{cfg.name}: schedules' losses differ: {runs}")
    log(f"[train-lm] {tag} {cfg.name}: {', '.join(schedules)} bit-identical [{H.card}]")


def phase_lm_training(H, torch):
    """Phase 16: mamba2-130m at full depth (16a), codeqwen1.5-7b cut to 8
    of 32 layers (16b), zamba2-7b served at all 81 slots and trained cut to
    36 (16c); the cuts keep fp32 params, gradients and Adam's moments (16 B
    a param) within the card's 80 GB."""
    phase_train_lm(H, torch, "16a", "mamba2-130m",
                   ["--stages", "2", "--chunks", "2", "--steps", "6"], cpu_check=True,
                   also=("interleaved",))
    phase_train_lm(H, torch, "16b", "codeqwen1.5-7b", ["--chunks", "2", "--steps", "4"],
                   cut={"num_layers": 8})
    t0 = time.perf_counter()
    phase_serve_lm(H, torch, "zamba2-7b")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve-lm] 16c zamba2-7b serving: phase {time.perf_counter() - t0:.1f} s")
    phase_train_lm(H, torch, "16c", "zamba2-7b", ["--chunks", "2", "--steps", "4"],
                   cut={"num_layers": 36})


def phase_frontend_lm(H, torch):
    """Phase 17: the modality-frontend archs at full width and depth, each
    served through ``phase_serve_lm`` (prompt 512: 128 frontend rows and 384
    tokens) and trained through ``phase_train_lm`` (seq 256: 64 frontend
    rows, ``--chunks 2``, 4 steps): 17a musicgen-large (audio frontend,
    plain rope, gelu MLP; flash at 32/32 heads, hd 64), 17b qwen2-vl-2b
    (vision frontend, m-rope, GQA 12/2 at hd 128; flash masked by the
    t-row)."""
    for tag, arch in (("17a", "musicgen-large"), ("17b", "qwen2-vl-2b")):
        t0 = time.perf_counter()
        phase_serve_lm(H, torch, arch)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[serve-lm] {tag} {arch} serving: phase {time.perf_counter() - t0:.1f} s")
        phase_train_lm(H, torch, tag, arch, ["--chunks", "2", "--steps", "4"], falling=True)


MOE_PHASES = (  # phase 18: (tag, arch, serving cut, training cut, training flags, schedules)
    ("18a", "arctic-480b", {"num_layers": 1}, {"num_layers": 2, "num_experts": 8},
     ["--stages", "2", "--chunks", "2", "--steps", "4"], ("interleaved",)),
    ("18b", "deepseek-v3-671b", {"num_layers": 1}, {"num_layers": 1, "num_experts": 16},
     ["--chunks", "2", "--steps", "4"], ()),
)


def phase_moe_lm(H, torch):
    """Phase 18: the MoE archs at full width, served through
    ``phase_serve_lm`` cut to one layer (arctic-480b 14.07e9 params,
    deepseek-v3-671b 13.41e9: fp32 weights of 56.3 and 53.6 GB) and trained
    through ``phase_train_lm`` with fewer experts (16 B a param of state):
    18a arctic-480b (GQA 56/8 at hd 128, softmax top-2, the dense residual)
    trained at 2 layers and 8 of 128 experts, fill_drain and interleaved
    over 2 stages bit-identical with the MoE combine in the step; 18b
    deepseek-v3-671b (MLA: flash at q/k head dim 192 and v head dim 128,
    sigmoid top-8, a shared expert, the multi-token-prediction head)
    trained at 1 layer and 16 of 256 experts. Each training's step-0
    batch must lose loss."""
    for tag, arch, serve_cut, train_cut, extra, also in MOE_PHASES:
        t0 = time.perf_counter()
        phase_serve_lm(H, torch, arch, cut=serve_cut)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[serve-lm] {tag} {arch} serving: phase {time.perf_counter() - t0:.1f} s")
        phase_train_lm(H, torch, tag, arch, extra, cut=train_cut, also=also, falling=True)


# ------------------------------------------------- the dry run (phase 19) --

DRYRUN_PREDICTIONS = (  # full width on meta, one process each, beside phase 20
    [("codeqwen1.5-7b", s) for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")],
    [("deepseek-v3-671b", "train_4k")])
# deepseek-v3-671b x train_4k, the longest, counted in 110.1 s on the card's
# host (niced, beside phases 2-18)
PREDICTION_TIMEOUT_S = 300
DRYRUN_OUT = ROOT / "build" / "dryrun_predictions"
PEAK_RTOL = 0.10  # the step's peak increment: counter against the card's allocator
LONG_WINDOW = 64  # phase 19's long-context window (the configs' 8192 needs > 8k decode steps)
LONG_STEPS = 81  # positions 0-80: the ring wraps after 64
STEP_REPEATS = 3  # timed runs of each counted step (their median)


def start_predictions():
    """Start one process for each group of ``DRYRUN_PREDICTIONS`` (one core
    each, with no CUDA device: the counts run on meta), each running its
    dry runs one after another; ``report_predictions`` reads their reports.
    Returns ``(start time, [(process, log path, log file), ...])``."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = []
    for i, group in enumerate(DRYRUN_PREDICTIONS):
        code = ("from repro_torch.launch.dryrun import run_one\n"
                f"for arch, shape in {group!r}:\n"
                f"    run_one(arch, shape, out_dir={str(DRYRUN_OUT)!r})\n")
        path = DRYRUN_OUT / f"predictions{i}.log"
        log_file = open(path, "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code], env=env, stdout=log_file,
                                       stderr=subprocess.STDOUT), path, log_file))
    return time.perf_counter(), procs


def stop_predictions(predictions):
    """End the prediction processes that still run (the smoke stops what it
    starts)."""
    for proc, _, log_file in predictions[1]:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        log_file.close()


def counted_on_card_and_meta(H, torch, label, cfg, topo, shape):
    """Build ``shape``'s step on the card (``dryrun.build_step``, params from
    seed 0) and run it once under ``OpCounter``, then the same step on meta;
    hold the aten FLOPs and bytes equal op for op, the kernel calls equal to
    the wrappers' launch counts, the flash operations equal to
    ``kernel_cost``'s count, and the counter's peak within 10% of the card
    allocator's peak over the same step (from a reset; what else the card
    held at entry taken off). Then time the step outside the counter (the
    median of ``STEP_REPEATS``) beside the meta count's roofline bound.
    Returns the card's step inputs' params (for reuse) freed of the rest."""
    from repro_torch.launch.dryrun import build_step, count_step
    from repro_torch.roofline.analysis import collective_bytes, model_flops, roofline_report
    from repro_torch.roofline.kernel_cost import flash_cost

    step, inputs = build_step(cfg, shape, topo, device=H.dev)
    torch.cuda.synchronize()
    wrappers = {"flash_attention_kernel": H.FK.flash_attention_kernel,
                "ssd_kernel": H.DK.ssd_kernel}
    before = {name: w.launches for name, w in wrappers.items()}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    card = count_step(step, inputs)
    torch.cuda.synchronize()
    card_total = torch.cuda.max_memory_allocated()
    launched = {name: w.launches - before[name] for name, w in wrappers.items()}
    meta_step, meta_inputs = build_step(cfg, shape, topo, device="meta")
    meta = count_step(meta_step, meta_inputs)
    del meta_step, meta_inputs
    if dict(meta.flops_by_op) != dict(card.flops_by_op) or \
            dict(meta.bytes_by_op) != dict(card.bytes_by_op):
        diff = {k: (card.bytes_by_op.get(k), meta.bytes_by_op.get(k))
                for k in set(card.bytes_by_op) | set(meta.bytes_by_op)
                if card.bytes_by_op.get(k) != meta.bytes_by_op.get(k)}
        raise AssertionError(f"{label}: meta and card aten counts differ: FLOPs "
                             f"{card.aten_flops} vs {meta.aten_flops}; bytes by op {diff}")
    if meta.kernel_calls != card.kernel_calls or meta.kernel_ops != card.kernel_ops:
        raise AssertionError(f"{label}: kernel calls or operations differ, card "
                             f"{card.kernel_calls} {card.kernel_ops}, meta {meta.kernel_calls} "
                             f"{meta.kernel_ops}")
    if {k: v for k, v in launched.items() if v} != dict(card.kernel_calls):
        raise AssertionError(f"{label}: the counter saw {dict(card.kernel_calls)}, the wrappers "
                             f"launched {launched}")
    calls = card.kernel_calls.get("flash_attention_kernel", 0)
    b_mb = shape.global_batch // topo.num_micro
    want_ops = calls * flash_cost(b_mb, shape.seq_len, shape.seq_len, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim, cfg.head_dim, 4)[0]
    if card.kernel_ops.get("flash_attention_kernel", 0) != want_ops:
        raise AssertionError(f"{label}: flash operations {card.kernel_ops} != {want_ops}")
    # the step's own memory: what it added over what was live at entry
    # (params, cache, batch are most of the total and need no counting)
    counted_inc = card.peak_bytes - card.entry_bytes
    card_inc = card_total - held
    ratio = counted_inc / card_inc
    if abs(ratio - 1.0) > PEAK_RTOL:
        raise AssertionError(f"{label}: the counter's peak increment {counted_inc} B is "
                             f"{ratio:.4f} of the card's {card_inc} B (limit 1 +- {PEAK_RTOL})")
    for name in launched:
        H.launches[name] = H.launches.get(name, 0) + launched[name]

    times = []
    for _ in range(STEP_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
            step(*inputs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median = statistics.median(times)
    counts = meta.report()
    device_bytes = counts["bytes"]["aten"] + sum(counts["bytes"]["kernels"].values())
    report = roofline_report(aten_flops=meta.aten_flops, kernel_ops=counts["flops"]["kernels"],
                             device_bytes=device_bytes,
                             device_collective=collective_bytes(counts["collectives"]), chips=1,
                             model_flops_global=model_flops(cfg, shape,
                                                            training=shape.kind == "train"),
                             hw=CARD)
    log(f"[dryrun-card] {label}: meta == card: aten {card.aten_flops} FLOPs "
        f"({dict(card.flops_by_op)}), {card.aten_bytes} B over {len(card.bytes_by_op)} ops; "
        f"kernel calls {dict(card.kernel_calls)} == launches; flash operations "
        f"{card.kernel_ops.get('flash_attention_kernel', 0)} == kernel_cost; peak increment "
        f"over entry: counter {counted_inc / 1e9:.6f} GB (peak {card.peak_bytes / 1e9:.6f} less "
        f"resident {card.entry_bytes / 1e9:.6f}), card {card_inc / 1e9:.6f} GB "
        f"(max_memory_allocated {card_total / 1e9:.6f} less held {held / 1e9:.6f}), ratio "
        f"{ratio:.4f}; totals less what the card held outside the step: ratio "
        f"{card.peak_bytes / (card_total - (held - card.entry_bytes)):.4f}; step (median of "
        f"{STEP_REPEATS}, outside "
        f"the counter) {median:.6f} s, dry-run bound_s {report['bound_s']:.6f} s "
        f"({report['dominant']}: compute {report['compute_s']:.6f}, memory "
        f"{report['memory_s']:.6f}), step / bound {median / report['bound_s']:.3f} [{H.card}]")
    params = inputs[0]
    del step, inputs, card, meta
    gc.collect()
    torch.cuda.empty_cache()
    return params


def long_context_decode(H, torch, cfg, params):
    """Decode ``cfg`` (full width) with ``long_context_window`` cut to 64 from
    an empty ring through positions 0-80, one token a step (the ring wraps
    after 64), and hold the last step's logits within 1e-3 of the last row
    of a fresh 81-row prefill of the same config whose layers all take
    window 64: the flash kernel's window path."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.tokens import token_batch
    from repro_torch.models.transformer.model import (
        Topology, init_cache, make_prefill_step, make_serve_step)

    b = 4
    lcfg = dataclasses.replace(cfg, long_context_window=LONG_WINDOW)
    topo = Topology(num_stages=1, num_micro=1, long_context=True)
    dshape = ShapeConfig("long", LONG_STEPS, b, "decode")
    toks = torch.from_numpy(token_batch(batch=b, seq=LONG_STEPS, vocab=cfg.vocab_size, seed=0)[
        :, :LONG_STEPS].astype("int32")).to(H.dev)
    cache = init_cache(lcfg, topo, dshape, device=H.dev)
    ring = cache["k"].shape[4]
    step = make_serve_step(lcfg, topo, dshape)
    H.FK.flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for pos in range(LONG_STEPS):
            _, cache, logits = step(params, cache, {"tokens": toks[:, pos], "pos": pos})
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del cache
    wcfg = dataclasses.replace(cfg, window_size=LONG_WINDOW)
    pshape = ShapeConfig("check", LONG_STEPS, b, "prefill")
    ptopo = Topology(num_stages=1, num_micro=1)
    with torch.inference_mode():
        fresh, _ = make_prefill_step(wcfg, ptopo, pshape)(
            params, init_cache(wcfg, ptopo, pshape, device=H.dev), {"tokens": toks})
    torch.cuda.synchronize()
    launched = H.FK.flash_attention_kernel.launches
    if launched != cfg.num_layers:
        raise AssertionError(f"long context: flash launched {launched} times in the windowed "
                             f"prefill, want {cfg.num_layers}")
    H.launches["flash_attention_kernel"] += launched
    err = float((logits - fresh).abs().max())
    agree = int((logits.argmax(-1) == fresh.argmax(-1)).sum())
    if not err <= DECODE_VS_PREFILL_ATOL:
        raise AssertionError(f"long context: decode at position {LONG_STEPS - 1} differs from "
                             f"the windowed prefill by {err:.3g}")
    log(f"[dryrun-card] long context: {cfg.name} full width, long_context_window "
        f"{cfg.long_context_window} -> {LONG_WINDOW}, batch {b}: ring of {ring} slots, "
        f"{LONG_STEPS} decode steps from empty ({decode_s:.3f} s, "
        f"{decode_s / LONG_STEPS * 1e3:.3f} ms a step) vs a fresh {LONG_STEPS}-row prefill at "
        f"window {LONG_WINDOW} ({launched} flash launches, window path): max |logit diff| "
        f"{err:.6g} (limit {DECODE_VS_PREFILL_ATOL}), argmax agree {agree}/{b} [{H.card}]")


def report_predictions(H, torch, predictions):
    """Wait for the prediction processes (at most ``PREDICTION_TIMEOUT_S``
    from their start) and print each one-card verdict: peak against the
    card's memory, the dominant term; they are predictions at the
    data-sheet rates."""
    t0, procs = predictions
    for proc, path, log_file in procs:
        proc.wait(timeout=max(1.0, PREDICTION_TIMEOUT_S - (time.perf_counter() - t0)))
        log_file.flush()
        if proc.returncode != 0:
            raise AssertionError(f"the dry runs failed ({proc.returncode}): "
                                 f"{path.read_text()[-2000:]}")
    log(f"[dryrun] predictions: {time.perf_counter() - t0:.1f} s from their start to the last "
        f"report, {len(procs)} processes beside phase 20")
    for arch, shape in itertools.chain(*DRYRUN_PREDICTIONS):
        r = json.loads((DRYRUN_OUT / f"{arch}__{shape}__1card.json").read_text())
        mem, rf = r["memory"], r["roofline"]
        log(f"[dryrun] prediction {arch} x {shape} (meta, full width, {r['num_micro']} "
            f"micro-batches, counted in {r['count_s']} s beside phase 20): peak "
            f"{mem['peak_estimate_gib']} GiB {'fits' if mem['fits'] else 'does NOT fit'} the "
            f"{mem['card_gib']} GiB card; aten {r['flops']['aten']:.6g} FLOPs, kernels "
            f"{r['flops']['kernels']}, {r['bytes']['total']:.6g} B; dominant "
            f"{rf['dominant']} ({rf['bound_s']:.6g} s: compute {rf['compute_s']:.6g}, memory "
            f"{rf['memory_s']:.6g}) at the data-sheet rates of {r['card']} [{H.card}]")


def phase_dryrun(H, torch):
    """Phase 19: the dry run against the card. The codeqwen1.5-7b prefill at
    phase 8's shapes (full width, 512 tokens, batch 8, 2 micro-batches) and
    its 8-layer training step at phase 16b's (seq 256, batch 8, 2
    micro-batches, 4 loss chunks, remat), each counted on the card and on
    meta (``counted_on_card_and_meta``); the long-context windows on the
    card (``long_context_decode``). The full-width predictions count
    beside phase 20 (``start_predictions``, ``report_predictions``)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models.transformer.model import Topology

    cfg = get_arch("codeqwen1.5-7b")
    params = counted_on_card_and_meta(
        H, torch, "codeqwen1.5-7b prefill (phase 8: 512 tokens, batch 8, 2 micro-batches)", cfg,
        Topology(num_stages=1, num_micro=2), ShapeConfig("serve_prefill", 512, 8, "prefill"))
    long_context_decode(H, torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=8)
    counted_on_card_and_meta(
        H, torch, "codeqwen1.5-7b train step, 8 layers (phase 16b: seq 256, batch 8, 2 "
        "micro-batches, 4 loss chunks, remat)", cut,
        Topology(num_stages=1, num_micro=2, loss_chunks=4), ShapeConfig("cli", 256, 8, "train"))


EXAMPLES = (  # phase 20: (script, arguments): the defaults, or the CPU test's where
    # the defaults took over 60 s on the card (95.7 s each, the five started together)
    ("quickstart", []),
    ("serve_batched", []),
    ("lm_pretrain", []),
    ("pipeline_parallel_gnn", ["--dataset", "karate", "--epochs", "2"]),
    ("scaling_larger_graphs", ["--dataset", "karate", "--num-nodes", "2048", "--chunks", "4",
                               "--epochs", "1"]),
)
EXAMPLE_TIMEOUT_S = 300


def phase_examples(H, torch):
    """Phase 20: each ``examples/torch/`` script in a subprocess of its own,
    on its default device (the card), all started together; each must exit
    0. Prints each one's wall seconds and its last line."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for name, argv in EXAMPLES:
        path = ROOT / "examples" / "torch" / f"{name}.py"
        procs.append((name, argv, time.perf_counter(), subprocess.Popen(
            [sys.executable, str(path), *argv], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, argv, t0, proc in procs:
        try:
            out, _ = proc.communicate(
                timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        wall = time.perf_counter() - t0
        lines = [line for line in out.splitlines() if line.strip()]
        args = f"the CPU test's arguments {' '.join(argv)} (the defaults take over 60 s)" \
            if argv else "the defaults"
        log(f"[examples] {name}, {args}: exit {proc.returncode} in "
            f"{wall:.1f} s; last line: {lines[-1][:200] if lines else ''} [{H.card}]")
        if proc.returncode != 0:
            failed.append(name)
            log("\n".join(lines[-30:]))
    if failed:
        raise AssertionError(f"examples failed on the card: {failed}")


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
    from repro_torch.roofline.analysis import HW

    global CARD
    CARD = HW.of(torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # phase 1: the card and the build
    card_line = card()
    log(f"[card] {card_line}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"python {sys.version.split()[0]}; data-sheet rates {CARD}")
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.gat_edge import kernel as K
    from repro_torch.kernels.spmm import kernel as S
    from repro_torch.kernels.ssd import kernel as DK

    # one nvcc per source, started together
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        builds = [pool.submit(mod.library) for mod in (K, S, FK, DK)]
        built_libs = [b.result() for b in builds]
    for built in built_libs:
        log(f"[build] {built.path.name}: nvcc {built.build_seconds:.3f} s")
        for line in built.ptxas_log.splitlines():
            if line.strip():
                log(f"[build] {line.strip()}")

    H = Harness(torch, K, S, torch.device("cuda"), card_line, FK=FK, DK=DK)
    run_phases(H, torch)

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
    log("[compare] largest share of the tolerance used, per kernel: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(H.used.items())))
    log(f"[done] all 20 phases passed in {time.perf_counter() - t_start:.1f} s")
    log(f"[card] {card_line}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(H, torch):
    """Phases 2-20, each timed."""

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(H, torch, *args)
        log(f"[phase] {label} {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    phase("2", phase_compare)
    phase("2", phase_compare_spmm)
    phase("2", phase_compare_lm)  # flash attention and SSD
    served = phase("3", phase_serve)
    bucketed = phase("4", phase_bucketed)
    phase("5", phase_timing, bucketed)
    phase("5", phase_timing_lm)  # flash attention and SSD
    # after phase 5: a profiler pass before phase 5's graph captures made
    # phase 5's own profiler passes lose device records on the card
    phase("3b", phase_serve_compiled, served)
    host_runs = phase("6", phase_train_gat)
    trained = phase("6b", phase_train_gat_compiled, host_runs)
    gcn_ref = phase("7", phase_train_gcn)
    phase("7b", phase_train_gcn_compiled, gcn_ref)
    phase("8", phase_serve_lm, "codeqwen1.5-7b")
    torch.cuda.empty_cache()
    phase("9", phase_serve_lm, "mamba2-130m")
    torch.cuda.empty_cache()
    phase("10", phase_zoo)
    phase("11", phase_sign)
    phase("12", phase_checkpoint, trained)
    phase("13", phase_auto)
    streamed = phase("14a", phase_streamed)
    phase("14b", phase_data_parallel)
    phase("14c", phase_loader, *streamed)
    phase("15a", phase_overlap)
    phase("15b", phase_roofline)
    phase("16", phase_lm_training)
    phase("17", phase_frontend_lm)
    phase("18", phase_moe_lm)
    torch.cuda.empty_cache()
    phase("19", phase_dryrun)
    # phase 19's full-width predictions count on the host's other cores
    # while the examples run: no timed phase runs beside them
    predictions = start_predictions()
    try:
        phase("20", phase_examples)
        phase("19", report_predictions, predictions)
    finally:
        stop_predictions(predictions)


if __name__ == "__main__":
    sys.exit(main())
