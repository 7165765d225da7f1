#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on NVIDIA GPUs.

    python3 chip_smoke.py                # phases 1-20 and 24 on one card (21 on 2+, 22-23, 25 on 4)
    python3 chip_smoke.py --phases 21    # phase 1, then phase 21 on up to 4 cards
    python3 chip_smoke.py --phases 22    # phase 1, then phase 22 on 4 cards
    python3 chip_smoke.py --phases 23    # phase 1, then phase 23 on 4 cards
    python3 chip_smoke.py --phases 25    # phase 1, then phase 25 on 4 cards

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
   test's smaller arguments: at their defaults they took 95.7 s. From the
   start of phase 19 to the end of phase 24, phase 19's full-width
   predictions count on meta in two processes with no CUDA device
   (codeqwen1.5-7b at all four shapes; deepseek-v3-671b at train_4k): each
   one-card verdict (peak against the card's 80 GiB, the dominant term)
   prints after phase 24.

21. Across cards (``[ranks]``), on every visible card up to 4; on a machine
   with one card it prints that it did not run (it needs 2+ cards, as on a
   host with 4 H100s) and ``[done]`` names it; with 2-3 cards it runs 21a
   and 21b on 2 ranks, and ``[done]`` names the legs that did not run. 21a:
   the host engine with
   one card per stage (``GPipeConfig.devices``, one process), the paper GAT
   on cora (8 heads x 8 hidden), 4 stages x 8 halo chunks, ``--backend
   pallas``: fill_drain, and zb-h1 under ``Placement.ring(4, rotation=2,
   device_order=(2, 0, 3, 1))``, each bit-identical after 3 steps (dropout
   on, deterministic algorithms) to one-card host fill_drain, every
   bucket-GAT launch held against the plain version on its stage's card,
   each median step beside the one-card step. Then the four GNN kernels
   timed on one card at the ring paths' shapes, and ``chip_smoke.py
   --rank-worker`` under ``torchrun``, one rank per card (NCCL), which
   writes each rank's lines and checks to ``build/phase21/``: 21b the same
   model through ``run_gnn`` and the compiled engine on the ring
   (fill_drain, 1f1b, zb-h1 and 1f1b ``--overlap double-buffer`` on 4 ranks;
   interleaved and zb-v with ``--pipe-devices 2`` on 2): losses, params and
   eval bit-identical to one-card host fill_drain on every rank, each rank's
   bucket-GAT launches held against the plain version at its own inputs,
   per rank the median step, beside the one-card compiled step timed with
   the smoke's CPU threads and with one, as torchrun starts each rank; rank
   0 prints every rank's traced step: its busy share, NCCL time and hidden
   share. 21c fig3's scale
   configuration (powerlaw-64k GCN, hidden 32, depth 2, 8 chunks, 1f1b) at
   ``data_parallel`` 2 x 2 stages on 4 ranks, bit-identical to
   ``data_parallel`` 1 on one card, its eval over the bucketed layout and
   over the padded stacked batch (the padded SpMM kernel); both SpMM
   kernels held per rank. 21d ``serve_gnn.run`` on the 4-rank ring (cora,
   ``--verify`` at 1e-5): every query answered, the padded GAT kernel held
   on each rank, q/s, p50 and p99 beside phase 3b's one-card compiled
   serve in the same call (``--phases 21`` runs phase 3 too) and the
   one-card serve at both thread counts. 21e powerlaw-1m (2^20 nodes), the paper GAT, 4 stages x 8
   chunks on 4 ranks: each rank builds the plan, one deterministic step,
   two timed; then rank 0 leaves the group and holds the step bit for bit
   against the one-card compiled step (phase 14a's) and times that. 21f
   (before 21c) the planner on the 4-rank ring: ``run_gnn`` with
   ``--partition profiled`` (1f1b, 8 chunks) and with ``--auto``: rank 0
   alone profiles on its card and prints the table, every rank records its
   table digest and pick; the pick on the engine from the seed, 3
   deterministic steps per rank, which this process holds bit for bit
   against one card's host fill_drain under the chosen balance and chunks;
   per pick the predicted step beside the measured median and beside the
   uniform (2, 1, 1, 2) balance's under the same schedule and chunks, and
   every rank's NCCL ``SendRecv`` share of a traced step of each. Last,
   ``torchrun -m repro_torch.launch.train`` and ``-m
   repro_torch.launch.serve_gnn`` as a user starts them on 4 cards: one
   result dict (rank 0), losses within 1e-5 of one card's, every query
   verified.

22. The LM stage ring on four cards (``Topology.ring``: one pipeline
   position per rank, NCCL point-to-point hops, fp32, deterministic
   algorithms in 22a), through ``chip_smoke.py --rank-worker lm4`` under
   ``torchrun``, each rank's lines in ``build/phase22/``. First each
   full-width leg's per-rank state is printed against the card's 80 GB.
   22a, cut depth, held bit for bit on every rank against the same
   ``Topology`` in one process on one card of the host (losses, tokens,
   logits, and digests of every params and Adam-moment row the rank holds
   and of its replicated leaves): codeqwen1.5-7b at 8 layers trained 2
   steps under fill_drain on 4 stages and interleaved (``--stages 8
   --pipe-devices 4``), qwen2.5-32b at 8 layers prefilled (512) and
   decoded 16 steps, zamba2-7b at 24 slots (6 a rank, one shared-attention
   application each) trained, then served. 22b codeqwen1.5-7b at its 32
   layers, 8 a rank, ``--seq 256 --batch 8 --chunks 4``, 4 steps: losses
   finite and alike on every rank, per rank the median step, peak memory
   and a traced step's busy share, NCCL ``SendRecv`` time and hidden share,
   tokens/s. 22c qwen2.5-32b at its 64 layers, 16 a rank (no one card holds
   its fp32 weights), phase 8's serving flags: the decode's logits at
   position 512 within 1e-3 of a fresh 513-row prefill's on the ring,
   ``prefill_s``, ``decode_s_per_tok``, ``tokens_per_s``, per rank the
   peak and the traced prefill's and 4 decode steps' busy share. Every
   rank's first flash and SSD calls of each leg are held against the plain
   version at its own inputs (flash 1e-5 against float64, SSD 1e-4), and
   the launches a rank makes on each main path are counted. The two kernels
   are timed on one card at the ring's launch shapes. 22d ``torchrun -m
   repro_torch.launch.serve`` (codeqwen1.5-7b) and ``-m
   repro_torch.launch.train --mode lm`` (mamba2-130m), both ``--stages 4``
   on 4 cards, started together: one result dict each, from rank 0. On a
   machine with fewer cards phase 22 prints why it did not run.

23. The LM data axis on four cards: 2 data replicas of a 2-position stage
   ring (``Topology(data=2, ring=RankGrid(2, 2))``: ZeRO-3 gathers, the
   expert-parallel modes, the sequence-sharded decode), fp32, through
   ``chip_smoke.py --rank-worker lmdata`` under ``torchrun``, each rank's
   lines in ``build/phase23/``. First each full-width leg's per-rank state
   is printed against the card's 80 GB, and 23c's training expert cut is
   the widest of 64, 48, 32 whose predicted state fits 0.7 of the card.
   23a, cut depth, held bit for bit on every rank against
   ``Topology(data=2)`` in one process on one card (losses, tokens, logits,
   and digests of every params and Adam-moment row and data shard the rank
   holds): codeqwen1.5-7b at 8 layers trained 2 steps with ZeRO-3 on and
   off and interleaved (4 virtual stages), zamba2-7b at 24 slots trained
   (its shared block gathered), arctic-480b at 2 layers and 8 experts
   trained under ``gathered`` and ``a2a``, qwen2.5-32b at 8 layers
   prefilled (512) and decoded 16 steps. 23d codeqwen1.5-7b at full width,
   ``long_context_window`` 64, one row decoded 81 steps over a ring split
   32 + 32: tokens and last logits bit for bit against one card, the last
   step within 1e-3 of a windowed 81-row prefill. 23b codeqwen1.5-7b at its
   32 layers trained with ZeRO-3, ``--seq 256 --batch 8 --chunks 2``, 4
   steps: losses alike on every rank, per rank the median step, tokens/s,
   peak and a traced step's busy share and NCCL time. 23c arctic-480b at 2
   layers served with all 128 experts (64 a rank): the first decode's
   logits within 1e-3 of a fresh prefill that drops no token, then trained
   2 steps on the expert cut. 23f codeqwen1.5-7b at full width cut to 8
   layers: each rank counts one train step on its card under ``OpCounter``,
   on the dp 2 x D 2 grid and on a pods 2 x D 2 grid (``Topology.pods``)
   of the same ranks; this process holds each rank's count against the
   same rank's count on meta in a fake world of 4
   (``dryrun.count_on_grid``), op for op (aten FLOPs and bytes by op,
   kernel calls and work, collectives by kind), and its peak increment over
   the step's entry within 10% of the card allocator's. Every rank's first
   flash and SSD calls of each leg are held against the plain version, and
   the launches a rank makes on each main path are counted. The two kernels are timed on one card at
   the data axis's launch shapes. 23e ``torchrun -m
   repro_torch.launch.serve`` (codeqwen1.5-7b) and ``-m
   repro_torch.launch.train --mode lm`` (mamba2-130m), both ``--stages 2``
   on 4 cards (2 data replicas), started together: one result dict each,
   from rank 0. On a machine with fewer cards phase 23 prints why it did
   not run.

24. The LM steps at the reference's own dtype, bf16, on one card
   (``phase_bf16``, after phase 20, beside phase 19's predictions): params,
   caches and activations bf16,
   Adam's moments, Mamba's state, the loss and the logits float32, as the
   reference builds its steps by default; TF32 off for the float32 parts.
   Each kernel's bf16 instance is held on every captured call's own inputs
   within one bf16 ulp of its plain version (``kernels.bf16_ulps``: at the
   value, or at 2^-8 of the output's largest where the value is smaller;
   flash against the plain version on the same bf16 inputs, SSD's y
   against its float32 result rounded to bf16, its float32 state at 1e-4),
   and its launches on each path counted (the ``kernels`` line's ``... bf16``
   entries). 24a codeqwen1.5-7b served at full depth through
   ``launch.serve.generate`` at phase 8's flags: prefill_s, decode ms a
   token, tokens/s, peak; the prefill's logits within 0.10 of the largest
   |logit| of the float32 step's from the same weights upcast, the first
   decode's within 0.10 of a fresh bf16 prefill's. 24b mamba2-130m served
   (the SSD kernel's bf16 instance) and trained at full depth, 2 stages,
   4 steps. 24c zamba2-7b served at 81 slots (flash at hd 112, SSD at 112
   heads). 24d codeqwen1.5-7b cut to 8 layers, ``--seq 256 --batch 8``, 2
   micro-batches, 4 steps under deterministic algorithms on 1 stage, 2
   stages and 2 stages interleaved: every loss and the last update's
   params finite and bit for bit across the three. 24e deepseek-v3-671b's
   prefill cut to one layer (flash at 192/128). 24f the dry run against
   the card at bf16, as phase 19 at fp32, for 24a's prefill and 24d's
   step. 24g each bf16 launch shape of 24a-24e timed with CUDA events over
   replays: the kernel, its plain version, its bound at the bf16 rates, its
   ulps from the plain version and, for flash,
   ``scaled_dot_product_attention`` on the same bf16 tensors.

25. The LM stage ring and the data axis at the reference's bf16 on four
   cards (``phase_lm_bf16``): params, caches and activations bf16, Adam's
   moments, Mamba's state, the loss and the logits float32, as phase 24 on
   one card; the hops, ZeRO-3 gathers and MoE exchanges carry bf16. Through
   ``chip_smoke.py --rank-worker lmbf16`` under ``torchrun``, each rank's
   lines in ``build/phase25/``. First 25b-d's per-rank state is reckoned at
   bf16 (params and gradients 2 bytes a value, the moments 4) against the
   card, and 25d's training expert cut is the widest of 128, 96, 64, 48
   whose state fits 0.7 of the card. 25a, cut depth, deterministic, bit for
   bit on every rank against the same ``Topology`` at bf16 in one process
   on one card of the host (losses, tokens, logits, and digests of every
   params row, Adam-moment row, decode-cache row and data shard the rank
   holds; the dtypes asserted): on the ring (D 4) phase 22a's cases
   (codeqwen1.5-7b at 8 layers under fill_drain and interleaved,
   qwen2.5-32b at 8 layers served, zamba2-7b at 24 slots trained and
   served), on dp 2 x D 2 codeqwen at 8 layers with ZeRO-3 on and off,
   arctic-480b at 2 layers and 8 experts under ``gathered`` and ``a2a``,
   qwen2.5-32b at 8 layers served and the long-context decode (window 64,
   81 steps), and codeqwen trained on pods 2 x D 2. 25b codeqwen1.5-7b at
   its 32 layers on the ring at 22b's flags, 4 steps: losses finite and
   alike on every rank, per rank the median step, tokens/s, peak, what the
   card held after the first step beside the reckoning, a traced step's
   busy share, NCCL time and hidden share, and the model-FLOP share of the
   four cards' bf16 peak, beside 22b's fp32 figures. 25c qwen2.5-32b at its
   64 layers on the ring at phase 8's flags: the prefill's logits within
   ``BF16_VS_FP32_FRAC`` of the largest |logit| of the float32 ring prefill
   from the same weights upcast, the decode at position 512 within
   ``BF16_DECODE_FRAC`` of a fresh 513-row bf16 prefill's on the ring;
   prefill_s, decode_s_per_tok, tokens_per_s, per rank the peak and the
   traced prefill's and decode's busy share. 25d codeqwen1.5-7b at 32
   layers with ZeRO-3 at dp 2 x D 2 at 23b's flags, 4 steps (per rank the
   step, tokens/s, peak, NCCL time); arctic-480b at 2 layers served with
   all 128 experts, the first decode within ``BF16_DECODE_FRAC`` of a fresh
   prefill that drops no token, then trained 2 steps on the expert cut.
   25e 23f at bf16: each rank's counted codeqwen step (8 layers) on dp 2 x
   D 2 and pods 2 x D 2 op for op against ``dryrun.count_on_grid(...,
   dtype=torch.bfloat16)`` in a fake world of 4, its peak increment within
   10% of the allocator's. 25f every rank's first flash and SSD calls of
   each leg within one bf16 ulp of the plain version, their launches
   counted into the ``kernels`` line's ``... bf16`` entries; on one card
   each new bf16 launch shape timed as 24g (flash 2 x 256 at 32 heads, 4 x
   512 at GQA 40/8, 2 x 512 at GQA 56/8; SSD at zamba2's 2 x 256 training
   call). On a machine with fewer cards phase 25 prints why it did not run.

``--phases`` (e.g. ``--phases 21``) runs phase 1, then the phases named (and
those whose results they take), then the closing lines; the kernels line
lists the kernels those phases launched. Every bound divides by the card's
data-sheet rates from ``repro_torch.roofline.analysis.HW``, which knows the
card by its name. The last three lines are the card's name and power limit,
the ``kernels`` JSON line, and ``{"ok": true, "device": {...}}``. Without a
CUDA device, or without the repo's ``src/`` beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import itertools
import json
import math
import os
import shutil
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
SMOKE_LIMIT_S = 1200  # the whole one-card run, the kernels' build included
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


def served_cora_calls(H, torch):
    """The padded GAT kernel's inputs of one served cora batch (4
    ego-subgraphs in the 64-node bucket), its label, and the model, params
    and graph they came from."""
    from repro_torch.core.pipeline import GPipeConfig, make_engine
    from repro_torch.graphs import load_dataset, stack_graphs
    from repro_torch.launch.serve_gnn import GNNServer, Query, ShapeBuckets
    from repro_torch.models.gnn.net import build_paper_gat

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
    label = (f"one served cora batch (4 chunks x n_pad {batch.features.shape[1]} x W "
             f"{batch.neighbors.shape[2]})")
    return calls, label, model, params, cora


def phase_timing(H, torch, bucketed):
    calls, label, model, params, cora = served_cora_calls(H, torch)
    H.timing["gat_aggregate_kernel"] = H.record_timing("gat_aggregate_kernel", label, calls)

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
    return summary


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
    """(bound_ms, bound_by, bytes, ops, cuda_core_ms) of one flash launch,
    from ``roofline.kernel_cost.flash_cost`` (the count the dry run
    reads): q, k, v read once and the output written once; per needed
    (query, key) pair a hd-long dot product and a hd_v-long multiply-add (2
    operations each) plus 4 softmax operations; with positions, the pairs
    their mask needs. The bound counts the operations as the kernel issues
    them: on fp32 inputs three TF32 tensor-core products each (3xTF32) at
    the TF32 rate, on bf16 one bf16 product at the bf16 rate (bytes 2 a
    value); ``cuda_core_ms`` is the same count at the fp32 CUDA-core rate,
    printed beside it."""
    from repro_torch.kernels.flash.kernel import cost
    from repro_torch.roofline.kernel_cost import bound

    from repro_torch.roofline.kernel_cost import precision_of

    ops, nbytes = cost(q, k, v, window=window, q_pos=q_pos, kv_pos=kv_pos)
    t_bytes, t_ops = (t * 1e3 for t in bound(ops, nbytes, CARD, precision_of(q.dtype)))
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
    compare_bf16_wgmma_edges(H, torch)
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


def compare_bf16_route(H, label, q, k, v, route="wgmma", **kw):
    """Two bf16 flash launches that must take ``route`` (``kernel.route``):
    the same bits both times, and within one bf16 ulp of the plain version
    (``compare_bf16_flash``)."""
    fk = H.FK.flash_attention_kernel
    before = fk.wgmma_launches
    got = fk(q, k, v, **kw)
    again = fk(q, k, v, **kw)
    H.torch.cuda.synchronize()
    wgmma = fk.wgmma_launches - before
    if wgmma != (2 if route == "wgmma" else 0):
        raise AssertionError(f"{label}: {wgmma} of 2 launches on the wgmma instances, want the "
                             f"{route} instance")
    if not H.torch.equal(got, again):
        raise AssertionError(f"{label}: a second launch gave other bits")
    compare_bf16_flash(H, f"{label} [{route}, relaunch same bits]", q, k, v, out=got, **kw)


def compare_bf16_wgmma_edges(H, torch):
    """The bf16 wgmma instances' edges: S around the 64-row
    warpgroups, the 128-row blocks and the 64-key tiles at each head-dim
    instance (zamba2's 112, MLA's 192/128), a window crossing tile edges,
    softcap 50, GQA 40/8 and 56/8, positions with a frontend prefix at t =
    0; then what TMA cannot describe (hd 100; a base off 16 bytes) on the
    mma.sync instance."""
    bf16 = torch.bfloat16
    for hd, hd_v in ((64, 64), (112, 112), (128, 128), (192, 128), (256, 256)):
        for s in (1, 63, 64, 65, 127, 128, 129, 513):
            compare_bf16_route(H, f"wgmma S {s} hd/hd_v {hd}/{hd_v}",
                               *flash_inputs(H, 2, s, 8, 4, hd, hd_v=hd_v, dtype=bf16))
    compare_bf16_route(H, "wgmma window 100 crossing tile edges",
                       *flash_inputs(H, 2, 300, 8, 4, 128, dtype=bf16), window=100)
    compare_bf16_route(H, "wgmma softcap 50", *flash_inputs(H, 2, 256, 8, 4, 128, dtype=bf16),
                       softcap=50.0)
    for h in (40, 56):
        compare_bf16_route(H, f"wgmma GQA {h}/8", *flash_inputs(H, 2, 512, h, 8, 128, dtype=bf16))
    for s, s_front, window in ((300, 100, 0), (257, 33, 20)):
        pos = frontend_t_row(H, s, s_front)
        compare_bf16_route(H, f"wgmma prefix {s_front} of {s}, window {window}",
                           *flash_inputs(H, 2, s, 8, 2, 128, dtype=bf16), window=window,
                           q_pos=pos, kv_pos=pos)
    compare_bf16_route(H, "hd 100", *flash_inputs(H, 2, 200, 8, 4, 100, dtype=bf16),
                       route="mma.sync")
    q, k, v = flash_inputs(H, 2, 200, 8, 4, 128, dtype=bf16)
    flat = torch.empty(q.numel() + 1, dtype=bf16, device=H.dev)
    compare_bf16_route(H, "q's base 2 bytes past 16-byte alignment",
                       flat[1:].view(q.shape).copy_(q), k, v, route="mma.sync")


def time_flash(H, torch, label, q, k, v, pos=None, position_path_too=False):
    """Time one flash launch shape: the kernel, its plain version,
    ``scaled_dot_product_attention`` on the same fp32 tensors (``pos``: the
    kernel's positions, which the library call takes as a boolean mask,
    else ``is_causal``) and the bound; ``position_path_too``: also time the
    position path on the same inputs at positions arange(S), which no rope
    arch runs (its cost beside the index path's). Returns the kernels line's
    record."""
    from repro_torch.kernels.flash.ref import flash_attention_ref

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


def time_ssd(H, torch, label, x, dt, loga, B, C, chunk=128):
    """Time one SSD call shape: the kernel, its plain version and the bound
    (no single PyTorch call computes it). Returns the kernels line's record."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan

    ms = H.time_ms(lambda: H.DK.ssd_kernel(x, dt, loga, B, C, chunk=chunk))
    plain_ms = H.time_ms(lambda: ssd_chunk_scan(x, dt, loga, B, C, chunk=chunk))
    bound_ms, bound_by, nbytes, nops, _ = ssd_bound(x, B, chunk)
    log(f"[timing] ssd_kernel {label}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, library "
        f"none, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {nops} ops as 3xTF32), share "
        f"of bound {bound_ms / ms:.3f} [{H.card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_timing_lm(H, torch):
    """Phase 5 for the LM kernels at their main-path launch shapes: kernel,
    plain version, bound and (flash) ``scaled_dot_product_attention`` on the
    same fp32 tensors with TF32 off."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan

    def flash_timing(label, q, k, v, pos=None, position_path_too=False):
        return time_flash(H, torch, label, q, k, v, pos, position_path_too)

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
        time_ssd(H, torch, f"one zamba2 {'prefill' if s == 512 else 'training'} launch (4 x "
                 f"{s} tokens, 112 heads, P 64, N 64, chunk 128)", *ssd_inputs(H, 4, s, 112, 64, 64))

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
    """Route the ops' kernel wrappers (flash, SSD, and the GAT and SpMM
    kernels) through recorders while a main path runs: each wrapper's count
    starts at 0, the first ``limits[name]`` calls' (args, kwargs, output)
    are kept in ``captured[name]``, and ``launches[name]`` holds the count
    on exit (``wgmma[name]``: the flash launches that took the bf16 wgmma
    instances)."""

    def __init__(self, limits: dict):
        from repro_torch.kernels.flash import ops as flash_ops
        from repro_torch.kernels.gat_edge import ops as gat_ops
        from repro_torch.kernels.spmm import ops as spmm_ops
        from repro_torch.kernels.ssd import ops as ssd_ops

        self.ops = {"flash_attention_kernel": flash_ops, "ssd_kernel": ssd_ops,
                    "gat_aggregate_kernel": gat_ops, "bucket_gat_kernel": gat_ops,
                    "padded_spmm_kernel": spmm_ops, "bucket_spmm_kernel": spmm_ops}
        self.limits = limits
        self.captured = {name: [] for name in limits}
        self.launches = {}
        self.wgmma = {}

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
            if hasattr(wrapper, "wgmma_launches"):
                wrapper.wgmma_launches = 0
            setattr(self.ops[name], name, record)
        return self

    def __exit__(self, *exc):
        for name, wrapper in self.wrappers.items():
            setattr(self.ops[name], name, wrapper)
            self.launches[name] = wrapper.launches
            self.wgmma[name] = getattr(wrapper, "wgmma_launches", 0)
        return False

    def compare(self, H, torch, label):
        """Hold every kept call against the plain version on its own inputs;
        returns the largest shares of the flash tolerance that
        ``scaled_dot_product_attention`` (on the global, uncapped calls) and
        the float32 plain version use against the float64 one."""
        from repro_torch.kernels.flash.ref import flash_attention_ref
        from repro_torch.kernels.gat_edge.ref import gat_edge_ref
        from repro_torch.kernels.spmm.ref import padded_spmm_ref

        sdpa_used = plain32_used = 0.0
        for name, calls in self.captured.items():
            for i, (a, kw, out) in enumerate(calls):
                if name in ("gat_aggregate_kernel", "bucket_gat_kernel"):
                    H._held(name, f"{label} call {i:3d}", out, gat_edge_ref(*a, **kw), None,
                            f"R={a[3].shape[0]:6d} W={a[3].shape[1]:4d} H={a[0].shape[1]} "
                            f"F={a[0].shape[2]:3d} {a[0].device}")
                elif name in ("padded_spmm_kernel", "bucket_spmm_kernel"):
                    H._held(name, f"{label} call {i:3d}", out, padded_spmm_ref(*a), None,
                            f"R={a[1].shape[0]:6d} W={a[1].shape[1]:4d} F={a[0].shape[1]:3d} "
                            f"{a[0].device}")
                elif name == "flash_attention_kernel":
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


def active_slots(cfg, num_stages=1, stages=None) -> dict:
    """{kernel: active layer slots whose forward calls it}, over every
    stage or those of ``stages`` (a ring position's)."""
    from repro_torch.models.transformer.model import make_extras

    ex = make_extras(cfg, num_stages)
    rows = slice(None) if stages is None else list(stages)
    if cfg.arch_type == "hybrid":
        return {"flash_attention_kernel": int(ex["attn"]["active"][rows].sum()),
                "ssd_kernel": int(ex["mamba"]["active"][rows].sum())}
    name = "ssd_kernel" if cfg.arch_type == "ssm" else "flash_attention_kernel"
    return {name: int(ex["active"][rows].sum())}


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

DRYRUN_PREDICTIONS = (  # full width on meta, one process each, beside phases 19-24
    [("codeqwen1.5-7b", s) for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")],
    [("deepseek-v3-671b", "train_4k")])
# deepseek-v3-671b x train_4k, the longest, counted in 110.1 s on the card's
# host (niced, beside phases 2-18), in 128.1 s at bf16 (beside phase 20, PR 28)
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


def counted_on_card_and_meta(H, torch, label, cfg, topo, shape, dtype=None):
    """Build ``shape``'s step on the card (``dryrun.build_step``, params from
    seed 0, in ``dtype``: float32 by default, the launchers' dtype) and run
    it once under ``OpCounter``, then the same step on meta;
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

    dtype = torch.float32 if dtype is None else dtype
    step, inputs = build_step(cfg, shape, topo, device=H.dev, dtype=dtype)
    torch.cuda.synchronize()
    wrappers = {"flash_attention_kernel": H.FK.flash_attention_kernel,
                "ssd_kernel": H.DK.ssd_kernel}
    before = {name: w.launches for name, w in wrappers.items()}
    wgmma_before = H.FK.flash_attention_kernel.wgmma_launches
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    card = count_step(step, inputs)
    torch.cuda.synchronize()
    card_total = torch.cuda.max_memory_allocated()
    launched = {name: w.launches - before[name] for name, w in wrappers.items()}
    if dtype == torch.bfloat16:
        count_wgmma(H, label, launched["flash_attention_kernel"],
                    H.FK.flash_attention_kernel.wgmma_launches - wgmma_before)
    meta_step, meta_inputs = build_step(cfg, shape, topo, device="meta", dtype=dtype)
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
                                  cfg.num_kv_heads, cfg.head_dim, cfg.head_dim,
                                  dtype.itemsize)[0]
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
        key = name if dtype == torch.float32 else BF16_KEYS[name]
        H.launches[key] = H.launches.get(key, 0) + launched[name]

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
                             hw=CARD, aten_flops_by_dtype=counts["flops"]["by_dtype"],
                             kernel_ops_by_precision=counts["flops"]["kernels_by_precision"])
    log(f"[dryrun-card] {label}: {str(dtype)[6:]}, meta == card: aten {card.aten_flops} FLOPs "
        f"({dict(card.flops_by_op)}; by dtype {dict(card.flops_by_dtype)}), {card.aten_bytes} B "
        f"over {len(card.bytes_by_op)} ops; "
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
        f"report, {len(procs)} processes beside phases 19, 20 and 24")
    for arch, shape in itertools.chain(*DRYRUN_PREDICTIONS):
        r = json.loads((DRYRUN_OUT / f"{arch}__{shape}__1card.json").read_text())
        mem, rf = r["memory"], r["roofline"]
        log(f"[dryrun] prediction {arch} x {shape} (meta, full width, {r['dtype']}, "
            f"{r['num_micro']} micro-batches, counted in {r['count_s']} s beside phases 19-24): "
            f"peak {mem['peak_estimate_gib']} GiB {'fits' if mem['fits'] else 'does NOT fit'} the "
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
    beside phases 19-24 (``start_predictions``, ``report_predictions``)."""
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


# ------------------------------------------------------ phase 21: across cards --

RANK_CARDS = 4  # phase 21 runs on up to this many cards
RANK_LAUNCH_TIMEOUT_S = 900  # one torchrun launch of phase 21, start-up and plan builds included
RANKS_DIR = ROOT / "build" / "phase21"
PHASE21_SKIP = "phase 21 needs 2+ cards (run it on a host with 4 cards)"
RING_ARGS = [  # 21a-b: the paper GAT on cora (8 heads x 8 hidden), 4 stages x 8 chunks
    "--mode", "gnn", "--dataset", "cora", "--stages", "4", "--chunks", "8", "--strategy", "halo",
    "--backend", "pallas", "--log-every", "0",
]
RING_STEPS = 3  # steps held bit for bit against one card
RING_TIMED = 6  # timed steps per configuration (the first dropped)
RING_CASES = {  # ranks -> (schedule, overlap) run through run_gnn and the engine
    4: (("fill_drain", "off"), ("1f1b", "off"), ("zb-h1", "off"), ("1f1b", "double-buffer")),
    2: (("interleaved", "off"), ("zb-v", "off")),
}
HOST_RING = dict(rotation=2, device_order=(2, 0, 3, 1))  # 21a: the reference's placed host test
PLAN_CASES = {  # 21f: the planner on the 4-rank ring, through run_gnn (profiled: 21b's 1f1b)
    "profiled": ["--partition", "profiled", "--schedule", "1f1b"],
    "auto": ["--auto"],
}
GRID_STEPS = 3
CAPTURE_LIMIT = 32  # kernel calls a rank keeps, per kernel, to hold against the plain version


def sync_engine(pipe):
    """Wait for every device ``pipe`` runs on (a host engine with
    ``devices`` spans several)."""
    from repro_torch.train.loop import synchronize

    for device in sorted(set(getattr(pipe, "_stage_devices", [])) | {pipe.device}, key=str):
        synchronize(device)


def train_steps(torch, pipe, plan, steps, seed=0, params=None):
    """``run_gnn``'s training from ``params`` (the engine's seed init by
    default): Adam 5e-3 with weight decay 5e-4, the step key
    ``fold_in(seed, epoch)``. Returns (params cloned, optimizer state,
    optimizer, losses), each step synchronized."""
    from repro_torch.models.gnn.net import fold_in
    from repro_torch.train import optimizer as opt_lib

    params = pipe.init_params(seed) if params is None else params
    opt = opt_lib.adam(5e-3, weight_decay=5e-4)
    state, losses = opt.init(params), []
    for epoch in range(steps):
        params, state, loss = pipe.train_step(params, state, plan, fold_in(seed, epoch), opt)
        sync_engine(pipe)
        losses.append(float(loss))
    return [{k: v.clone() for k, v in p.items()} for p in params], state, opt, losses


def timed_steps(torch, pipe, plan, params, state, opt, steps, first_key=100):
    """Wall ms of ``steps`` more steps, each to a synchronize of every
    device the engine runs on."""
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, _ = pipe.train_step(params, state, plan, first_key + i, opt)
        sync_engine(pipe)
        times.append((time.perf_counter() - t0) * 1e3)
    return times, params, state


def cpu_tree(tree):
    return [{k: v.detach().cpu() for k, v in p.items()} for p in tree]


def ring_model(cli_args):
    """``run_gnn``'s model, plan and flags for ``cli_args``."""
    from repro_torch.core.cli import PipelineCLIConfig
    from repro_torch.core.microbatch import make_plan
    from repro_torch.graphs import load_dataset
    from repro_torch.launch.train import build_parser
    from repro_torch.models.gnn.net import build_paper_gat

    args = build_parser().parse_args(cli_args)
    g = load_dataset(args.dataset, seed=args.seed)
    model = build_paper_gat(g.num_features, g.num_classes, backend=args.backend, attn_dropout=0.0)
    plan = make_plan(g, args.chunks, strategy=args.strategy, halo_hops=2, seed=args.seed)
    return args, PipelineCLIConfig.from_args(args), model, plan


def grid_model(dev):
    """21c: fig3's scale configuration, the GCN at hidden 32, depth 2, on
    powerlaw-64k at its registry size, 8 chunks, ``max_degree=32``."""
    import repro_torch.graphs as G
    from repro_torch.models.gnn.net import build_gnn

    plan = G.streamed_plan(G.open_streamed("powerlaw-64k"), 8, max_degree=32)
    g0 = plan.batches[0].graph
    return build_gnn("gcn", g0.num_features, g0.num_classes, hidden=32, depth=2,
                     backend="kernel"), plan


def grid_config(dev, **kw):
    from repro_torch.core.pipeline import GPipeConfig

    return GPipeConfig(balance=(2, 2), chunks=8, schedule="1f1b", engine="compiled",
                       backend="kernel", device=str(dev), **kw)


def deterministic(torch):
    @contextlib.contextmanager
    def ctx():
        torch.use_deterministic_algorithms(True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)

    return ctx()


def ranks_references(H, torch):
    """One card (``H.dev``), deterministic: the host fill_drain of the cora
    ring configuration (params, losses, eval) and the ``data_parallel`` 1
    compiled GCN of 21c, saved for the rank workers; for the lines, the
    one-card compiled cora step's median and a one-card compiled serve run,
    each with this process's CPU threads and with one thread, as torchrun
    starts every rank (``OMP_NUM_THREADS=1``)."""
    import dataclasses as dc

    from repro_torch.core.pipeline import make_engine
    from repro_torch.launch.serve_gnn import build_parser, run

    args, cli, model, plan = ring_model([*RING_ARGS, "--device", H.dev.type])
    base = cli.gpipe_config(cli.uniform_balance(), device=H.dev)
    host = make_engine(model, base)
    with deterministic(torch):
        params, _, _, losses = train_steps(torch, host, plan, RING_STEPS)
        metrics = {k: float(v) for k, v in host.evaluate(params, plan).items()}
    refs = {"cora": {"params": cpu_tree(params), "losses": losses, "eval": metrics},
            "cora_compiled_ms": {}, "serve": {}}
    gmodel, gplan = grid_model(H.dev)
    with deterministic(torch):
        gpipe = make_engine(gmodel, grid_config(H.dev))
        gp, _, _, glosses = train_steps(torch, gpipe, gplan, GRID_STEPS)
        gmetrics = {k: float(v) for k, v in gpipe.evaluate(gp, gplan).items()}
    refs["grid"] = {"params": cpu_tree(gp), "losses": glosses, "eval": gmetrics}
    del host, gpipe
    threads = torch.get_num_threads()
    serve_args = build_parser().parse_args([*SERVE_ARGS, "--engine", "compiled"])
    try:
        for n in sorted({threads, 1}, reverse=True):
            torch.set_num_threads(n)
            gc.collect()
            comp = make_engine(model, dc.replace(base, engine="compiled"))
            p, s, opt, _ = train_steps(torch, comp, plan, 1)
            times, _, _ = timed_steps(torch, comp, plan, p, s, opt, RING_TIMED)
            refs["cora_compiled_ms"][n] = statistics.median(times[1:])
            del comp, p, s
            summary = run(serve_args)
            refs["serve"][n] = {k: summary[k] for k in ("achieved_qps", "p50_s", "p99_s")}
    finally:
        torch.set_num_threads(threads)
    torch.save(refs, RANKS_DIR / "refs.pt")
    log(f"[ranks] one card ({H.dev}), deterministic: cora ring configuration host fill_drain "
        f"{RING_STEPS} steps losses {losses}, eval {metrics}; powerlaw-64k GCN data_parallel 1 "
        f"(compiled 1f1b) losses {glosses}; the compiled cora step median {one_card_ms(refs)}; "
        f"serve cora compiled {one_card_serve(refs)} [{H.card}]")
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def one_card_ms(refs):
    """The one-card compiled cora step of ``ranks_references``, per CPU
    thread count."""
    return ", ".join(f"{ms:.6f} ms at {n} CPU threads"
                     for n, ms in sorted(refs["cora_compiled_ms"].items(), reverse=True))


def one_card_serve(refs):
    """The one-card compiled serve of ``ranks_references``, per CPU thread
    count."""
    return "; ".join(f"{n} CPU threads: {r['achieved_qps']} q/s, p50 {r['p50_s'] * 1e3} ms, "
                     f"p99 {r['p99_s'] * 1e3} ms"
                     for n, r in sorted(refs["serve"].items(), reverse=True))


def leg_host_devices(H, torch, cards, refs):
    """21a: the host engine with one card per stage (``devices``, one
    process): fill_drain, and zb-h1 under ``Placement.ring(4, rotation=2,
    device_order=(2, 0, 3, 1))``, each bit-identical to one-card host
    fill_drain after ``RING_STEPS`` steps; every bucket-GAT launch on its
    stage's card held against the plain version."""
    import dataclasses as dc

    from repro_torch.core.pipeline import make_engine
    from repro_torch.core.schedule import Placement

    args, cli, model, plan = ring_model([*RING_ARGS, "--device", H.dev.type])
    devices = tuple(torch.device(H.dev.type, i) if H.dev.type == "cuda" else H.dev
                    for i in range(cards))
    base = cli.gpipe_config(cli.uniform_balance(), device=H.dev)
    one_ms = None
    for schedule, placement in (("fill_drain", None),
                                ("zb-h1", Placement.ring(4, **HOST_RING))):
        pipe = make_engine(model, dc.replace(base, schedule=schedule, placement=placement,
                                             devices=devices))
        with deterministic(torch), KernelCapture({"bucket_gat_kernel": CAPTURE_LIMIT}) as cap:
            params, state, opt, losses = train_steps(torch, pipe, plan, RING_STEPS)
        same = same_trees(torch, cpu_tree(params), refs["cora"]["params"])
        if not same or losses != refs["cora"]["losses"]:
            raise AssertionError(f"21a {schedule} on {devices}: not bit-identical to one-card "
                                 f"host fill_drain ({losses} vs {refs['cora']['losses']})")
        H.launches["bucket_gat_kernel"] = H.launches.get("bucket_gat_kernel", 0) + \
            cap.launches["bucket_gat_kernel"]
        cap.compare(H, torch, f"21a host {schedule}")
        times, _, _ = timed_steps(torch, pipe, plan, params, state, opt, RING_TIMED)
        if one_ms is None:
            one = make_engine(model, base)
            p, s, o, _ = train_steps(torch, one, plan, 1)
            one_ms = statistics.median(timed_steps(torch, one, plan, p, s, o, RING_TIMED)[0][1:])
            del one
        log(f"[ranks] 21a host engine, {schedule}, stages on "
            f"{[str(d) for d in pipe._stage_devices]}: losses and params after {RING_STEPS} "
            f"steps bit-identical to one-card host fill_drain (deterministic); bucket-GAT "
            f"launches {cap.launches['bucket_gat_kernel']}; median step "
            f"{statistics.median(times[1:]):.6f} ms against {one_ms:.6f} ms on one card "
            f"({len(devices)} cards) [{H.card}]")
    gc.collect()
    torch.cuda.empty_cache()


def ranks_timing(H, torch):
    """The four GNN kernels timed on one card at the ring paths' shapes:
    the bucket GAT over one forward of the cora ring plan (21a-b), the
    padded GAT over one served cora batch (21d), the bucket SpMM over one
    forward of the powerlaw-64k plan and the padded SpMM over its padded
    chunks (21c)."""
    from repro_torch.graphs import bucketize_stacked

    args, cli, model, plan = ring_model([*RING_ARGS, "--device", H.dev.type])
    params = model.init_params(0, device=H.dev)
    layout = bucketize_stacked(plan.stacked().graph).to(H.dev)
    timing = {}  # phase 5's times, where it ran, stay the kernels line's
    timing["bucket_gat_kernel"] = H.record_timing(
        "bucket_gat_kernel", f"one forward of the cora ring plan ({plan.chunks} chunks)",
        bucket_gat_plan_calls(torch, model, params, layout, plan.chunks))
    calls, label, *_ = served_cora_calls(H, torch)
    timing["gat_aggregate_kernel"] = H.record_timing("gat_aggregate_kernel", label, calls)
    gmodel, gplan = grid_model(H.dev)
    gparams = gmodel.init_params(0, device=H.dev)
    stacked = gplan.stacked().graph
    glayout = bucketize_stacked(stacked).to(H.dev)
    padded = stacked.to(H.dev)
    b_calls, p_calls = [], []
    for c in range(gplan.chunks):
        chunk = glayout.chunk(c)
        b_calls += gcn_calls(torch, gmodel, gparams, chunk,
                             [(b.neighbors, b.norm) for b in chunk.buckets if b.rows])
        g = padded.chunk(c)
        p_calls += gcn_calls(torch, gmodel, gparams, g, [(g.neighbors, g.norm)])
    timing["bucket_spmm_kernel"] = H.record_spmm_timing(
        "bucket_spmm_kernel", "one forward of the powerlaw-64k plan (8 chunks)", b_calls)
    timing["padded_spmm_kernel"] = H.record_spmm_timing(
        "padded_spmm_kernel", "the powerlaw-64k plan's padded chunks (8)", p_calls)
    for name, record in timing.items():
        H.timing.setdefault(name, record)


def torchrun(n, argv, timeout=RANK_LAUNCH_TIMEOUT_S):
    """``python -m torch.distributed.run --standalone`` with ``n`` ranks on
    ``argv``; the completed process (raises on a non-zero exit, with the
    output's tail). Every rank it started has ended when it returns."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {n} x {' '.join(argv[:4])}: exit {proc.returncode}\n"
                             f"{(proc.stdout + proc.stderr)[-6000:]}")
    return proc


def run_rank_worker(H, torch, n, leg):
    """Run ``chip_smoke.py --rank-worker leg`` on ``n`` ranks under
    torchrun; print each rank's lines in rank order and fold its launches
    and kernel errors into ``H``. Returns the per-rank reports."""
    t0 = time.perf_counter()
    os.environ["CHIP_SMOKE_CARD"] = H.card
    torchrun(n, [str(ROOT / "chip_smoke.py"), "--rank-worker", leg])
    reports = []
    for r in range(n):
        with open(rank_dir(leg) / f"{leg}-rank{r}.json") as f:
            rep = json.load(f)
        reports.append(rep)
        for line in rep["lines"]:
            log(f"[ranks {r}/{n}] {line}")
        for name, count in rep["launches"].items():
            H.launches[name] = H.launches.get(name, 0) + count
        for name, err in rep["err"].items():
            H.err[name] = max(H.err.get(name, 0.0), err)
        for name, used in rep["used"].items():
            H.used[name] = max(H.used.get(name, 0.0), used)
    log(f"[ranks] {leg} on {n} ranks: {time.perf_counter() - t0:.1f} s with start-up [{H.card}]")
    return reports


def ranks_cli(H, torch, refs):
    """The two launchers as a user starts them on 4 cards: training (1f1b,
    3 epochs) and serving (``--verify`` at 1e-5); rank 0 alone prints."""
    t0 = time.perf_counter()
    proc = torchrun(4, ["-m", "repro_torch.launch.train", *RING_ARGS, "--device", "cuda",
                        "--engine", "compiled", "--schedule", "1f1b", "--epochs", str(RING_STEPS)])
    dicts = [line for line in proc.stdout.splitlines() if line.startswith("{'mode'")]
    if len(dicts) != 1:
        raise AssertionError(f"torchrun train: {len(dicts)} result dicts printed")
    out = ast.literal_eval(dicts[0])
    want = refs["cora"]["losses"]
    if out["ranks"] != 4 or not all(math.isclose(a, b, rel_tol=RTOL)
                                    for a, b in zip(out["epoch_losses"], want)):
        raise AssertionError(f"torchrun train: {out}")
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = torchrun(4, ["-m", "repro_torch.launch.serve_gnn", *SERVE_ARGS, "--engine", "compiled"])
    lines = [line for line in proc.stdout.splitlines() if line.startswith("[serve]")]
    verify = [line for line in lines if line.startswith("[serve] verify")]
    if len(verify) != 1 or ", 0 beyond" not in verify[0]:
        raise AssertionError("torchrun serve_gnn:\n" + "\n".join(lines))
    log(f"[ranks] torchrun -m repro_torch.launch.train on 4 ranks: one result dict (rank 0), "
        f"losses {out['epoch_losses']} (one-card deterministic {want}, within {RTOL}), median "
        f"epoch {out['median_epoch_s'] * 1e3:.6f} ms, {train_s:.1f} s with start-up; "
        f"torchrun -m repro_torch.launch.serve_gnn on 4 ranks, {time.perf_counter() - t0:.1f} "
        f"s: {' | '.join(lines[1:3])} | {verify[0]} [{H.card}]")


def plan_references(H, torch, reports):
    """21f's check: every rank's table digest and pick alike, and each
    rank's update under the pick bit for bit one card's host fill-drain
    under the same balance and chunks (deterministic, this process's card)."""
    from repro_torch.core.pipeline import make_engine

    for name in PLAN_CASES:
        recs = [rep["plan"][name] for rep in reports]
        picks = {(r["sha"], r["schedule"], r["chunks"], tuple(r["balance"])) for r in recs}
        if len(picks) != 1:
            raise AssertionError(f"21f {name}: the ranks took different plans: {picks}")
        (sha, schedule, chunks, balance), = picks
        args, cli, model, plan = ring_model([*RING_ARGS, "--device", H.dev.type, "--chunks",
                                             str(chunks)])
        host = make_engine(model, cli.gpipe_config(balance, device=H.dev))
        with deterministic(torch):
            params, _, _, losses = train_steps(torch, host, plan, RING_STEPS)
            metrics = {k: float(v) for k, v in host.evaluate(params, plan).items()}
        want = cpu_tree(params)
        for r in range(len(recs)):
            got = torch.load(RANKS_DIR / f"plan-{name}-rank{r}.pt", weights_only=False)
            if not same_trees(torch, got["params"], want) or got["losses"] != losses \
                    or got["eval"] != metrics:
                raise AssertionError(f"21f {name} rank {r}: not bit-identical to one card's host "
                                     f"fill_drain under {balance} x {chunks} chunks")
        rec = recs[0]
        log(f"[ranks] 21f {name}: every rank's plan digest {sha}; pick {schedule} x {chunks} "
            f"chunks, balance {balance}: every rank's params, losses {losses} and eval after "
            f"{RING_STEPS} steps bit-identical to one card's host fill_drain under it; "
            f"predicted {rec['predicted_ms']:.6f} ms, measured {rec['median_ms']:.6f} ms "
            f"(rank 0; {rec['median_ms'] / rec['predicted_ms']:.3f}x); uniform (2, 1, 1, 2) "
            f"{rec['uniform_ms']:.6f} ms, pick / uniform {rec['median_ms'] / rec['uniform_ms']:.4f}"
            f"; SendRecv shares {rec['sendrecv']} [{H.card}] x 4")
        for line in rec["table"]:
            log(f"[ranks] 21f {name} rank 0 printed: {line}")
        del host


def phase_ranks(H, torch, served_compiled):
    """Phase 21: the paper's pipeline with one stage per card (21a host
    engine with ``devices``; 21b the compiled ring over NCCL; 21c the
    ``(data, stage)`` grid; 21d serving on the ring, beside phase 3b's
    one-card ``served_compiled`` summary; 21e powerlaw-1m). Returns what of
    it did not run and why, having printed it: "" when every leg ran."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[ranks] not run: {PHASE21_SKIP} (this machine has {n} card)")
        return f"phase 21 not run ({PHASE21_SKIP})"
    cards = min(n, RANK_CARDS)
    shutil.rmtree(RANKS_DIR, ignore_errors=True)
    RANKS_DIR.mkdir(parents=True)
    refs = ranks_references(H, torch)
    leg_host_devices(H, torch, cards, refs)
    ranks_timing(H, torch)
    gc.collect()
    torch.cuda.empty_cache()
    run_rank_worker(H, torch, 2, "ring2")
    if cards < 4:
        not_run = (f"phase 21's 21b on 4 ranks, 21c, 21d and 21e not run: they take 4 cards, "
                   f"this machine has {n} (21a and 21b on 2 ranks passed)")
        log(f"[ranks] {not_run}")
        return not_run
    reports = run_rank_worker(H, torch, 4, "ring4")
    plan_references(H, torch, reports)
    serve, one = reports[0]["serve"], served_compiled
    log(f"[ranks] 21d served on 4 ranks ({reports[0]['threads']} CPU threads each): "
        f"{serve['achieved_qps']} q/s, p50 {serve['p50_s'] * 1e3} ms, p99 "
        f"{serve['p99_s'] * 1e3} ms; one card, phase 3b of this call: {one['achieved_qps']} "
        f"q/s, p50 {one['p50_s'] * 1e3} ms, p99 {one['p99_s'] * 1e3} ms; one card after the "
        f"references, {one_card_serve(refs)} [{H.card}] x 4")
    ranks_cli(H, torch, refs)
    return ""


# ---------------------------------------------- phase 21: the rank worker --


class RankLog:
    """A rank's record for the parent: its lines, the launches of the
    kernels on its main paths, its kernel checks and its CPU threads."""

    def __init__(self, rank, leg, threads):
        self.rank, self.leg = rank, leg
        self.data = {"lines": [], "launches": {}, "err": {}, "used": {}, "threads": threads}

    def line(self, text):
        self.data["lines"].append(text)

    def launched(self, launches):
        for name, count in launches.items():
            self.data["launches"][name] = self.data["launches"].get(name, 0) + count

    def write(self, H):
        self.data["err"] = {k: v for k, v in H.err.items() if v}
        self.data["used"] = dict(H.used)
        with open(rank_dir(self.leg) / f"{self.leg}-rank{self.rank}.json", "w") as f:
            json.dump(self.data, f)


def worker_ring(H, torch, rl, world, refs):
    """21b on this rank: each (schedule, overlap) of ``RING_CASES[world]``
    through ``run_gnn`` (the epoch losses equal one card's, every
    bucket-GAT launch this rank made in the first calls held against the
    plain version), then through the engine (params and eval after
    ``RING_STEPS`` steps bit-identical to one card's), its median step, and
    one traced step on every rank: rank 0 prints each rank's busy share,
    NCCL time and overlap."""
    from repro_torch.core.overlap_report import capture_rank_reports
    from repro_torch.core.pipeline import make_engine
    from repro_torch.launch.train import build_parser, run_gnn

    for schedule, overlap in RING_CASES[world]:
        extra = ["--schedule", schedule, "--overlap", overlap, "--engine", "compiled",
                 "--device", H.dev.type, "--epochs", str(RING_STEPS)]
        if world == 2:
            extra += ["--pipe-devices", "2"]
        with deterministic(torch), KernelCapture({"bucket_gat_kernel": CAPTURE_LIMIT}) as cap:
            out = run_gnn(build_parser().parse_args([*RING_ARGS, *extra]))
        if out["epoch_losses"] != refs["cora"]["losses"]:
            raise AssertionError(f"21b {schedule} {overlap}: run_gnn losses {out['epoch_losses']}"
                                 f" != one card's {refs['cora']['losses']}")
        rl.launched(cap.launches)
        cap.compare(H, torch, f"21b {schedule}/{overlap} rank {rl.rank}")
        args, cli, model, plan = ring_model([*RING_ARGS, *extra])
        pipe = make_engine(model, cli.gpipe_config(cli.uniform_balance(), device=H.dev))
        with deterministic(torch):
            params, state, opt, losses = train_steps(torch, pipe, plan, RING_STEPS)
            metrics = {k: float(v) for k, v in pipe.evaluate(params, plan).items()}
        if not same_trees(torch, cpu_tree(params), refs["cora"]["params"]) \
                or losses != refs["cora"]["losses"] or metrics != refs["cora"]["eval"]:
            raise AssertionError(f"21b {schedule} {overlap} rank {rl.rank}: not bit-identical "
                                 f"to one-card host fill_drain ({losses}, {metrics})")
        times, params, state = timed_steps(torch, pipe, plan, params, state, opt, RING_TIMED)
        reports = capture_rank_reports(
            lambda: pipe.train_step(params, state, plan, 999, opt))
        desc = pipe.describe()["ranks"]
        rl.line(f"21b {schedule:11s} {overlap:13s} ring position {desc['position']} of "
                f"{desc['rows']}: run_gnn losses, params and eval after {RING_STEPS} steps "
                f"bit-identical to one-card host fill_drain; bucket-GAT launches "
                f"{cap.launches['bucket_gat_kernel']}; median step "
                f"{statistics.median(times[1:]):.6f} ms ({torch.get_num_threads()} CPU "
                f"threads); one-card compiled step {one_card_ms(refs)} [{H.card}]")
        for rep in reports or ():  # rank 0 prints every rank's traced step
            busy = (rep["compute_time_us"] + rep["collective_time_us"]
                    - rep["overlapped_time_us"]) / rep["step_us"]
            rl.line(f"21b {schedule:11s} {overlap:13s} traced step of rank {rep['rank']}: "
                    f"{rep['step_us'] / 1e3:.6f} ms, busy {busy:.6f}, NCCL "
                    f"{rep['collective_time_us'] / 1e3:.6f} ms "
                    f"({rep['num_collective_events']} kernels, "
                    f"{rep['collective_time_us'] / rep['step_us']:.6f} of the step), hidden "
                    f"{rep['overlap_fraction']:.6f} of it [{H.card}]")
        del pipe


def plan_engine(H, cli_args, out):
    """The engine, plan and model of a 21f run: ``run_gnn``'s flags with
    the pick of its result ``out`` (schedule, chunks, balance; an ``--auto``
    pick's placement from the planner again, its costs cached in this
    process on rank 0 and broadcast)."""
    from repro_torch.core.autotune import plan_for_cli
    from repro_torch.core.pipeline import make_engine

    picked = ["--schedule", out["schedule"], "--chunks", str(out["chunks"])]
    args, cli, model, plan = ring_model([*cli_args, *picked])
    if out["partition"] == "auto":
        from repro_torch.graphs import load_dataset

        auto = plan_for_cli(model, load_dataset(args.dataset, seed=args.seed), cli,
                            strategy=args.strategy, seed=args.seed, device=H.dev)
        if (auto.schedule, auto.chunks, list(auto.balance)) != \
                (out["schedule"], out["chunks"], out["balance"]):
            raise AssertionError(f"21f: the planner's second pick {auto.schedule} "
                                 f"{auto.chunks} {auto.balance} differs from run_gnn's {out}")
        config = auto.to_config(device=str(H.dev))
    else:
        config = cli.gpipe_config(tuple(out["balance"]), device=H.dev)
    return make_engine(model, config), plan, model


def worker_plan(H, torch, rl):
    """21f on this rank: ``run_gnn`` with ``--partition profiled`` (1f1b)
    and with ``--auto``: rank 0 alone profiles and prints the table, every
    rank records its table digest and pick; each bucket-GAT launch in the
    first calls held against the plain version. Then the pick on the engine
    from the seed: ``RING_STEPS`` deterministic steps (params, losses and
    eval saved for the parent's one-card host fill-drain under the same
    balance), its median step beside the uniform (2, 1, 1, 2) balance's
    under the same schedule and chunks, and one traced step of each: every
    rank's NCCL ``SendRecv`` share."""
    from repro_torch.core.overlap_report import capture_rank_reports
    from repro_torch.core.pipeline import make_engine
    from repro_torch.launch.train import build_parser, run_gnn

    base = [*RING_ARGS, "--engine", "compiled", "--device", H.dev.type,
            "--epochs", str(RING_STEPS)]
    records = {}
    for name, flags in PLAN_CASES.items():
        text = io.StringIO()
        # rank 0's profile runs the padded GAT kernel on a padded chunk
        limits = {"bucket_gat_kernel": CAPTURE_LIMIT, "gat_aggregate_kernel": 8}
        with deterministic(torch), KernelCapture(limits) as cap, contextlib.redirect_stdout(text):
            out = run_gnn(build_parser().parse_args([*base, *flags]))
        printed = text.getvalue()
        marker = "[auto] evaluated" if name == "auto" else "[gnn] profiled balance="
        if (marker in printed) != (rl.rank == 0):
            raise AssertionError(f"21f {name} rank {rl.rank}: the table printed "
                                 f"{'nowhere' if rl.rank == 0 else 'on this rank too'}")
        rl.launched(cap.launches)
        cap.compare(H, torch, f"21f {name} rank {rl.rank}")
        pipe, plan, model = plan_engine(H, base, out)
        with deterministic(torch):
            params, state, opt, losses = train_steps(torch, pipe, plan, RING_STEPS)
            metrics = {k: float(v) for k, v in pipe.evaluate(params, plan).items()}
        if losses != out["epoch_losses"]:
            raise AssertionError(f"21f {name} rank {rl.rank}: engine losses {losses} != run_gnn's "
                                 f"{out['epoch_losses']}")
        torch.save({"params": cpu_tree(params), "losses": losses, "eval": metrics},
                   RANKS_DIR / f"plan-{name}-rank{rl.rank}.pt")
        uniform = make_engine(model, dataclasses.replace(pipe.config, balance=(2, 1, 1, 2),
                                                         placement=None))
        medians, shares = {}, {}
        for label, engine in (("pick", pipe), ("uniform", uniform)):
            p, st, o, _ = train_steps(torch, engine, plan, 1)
            times, p, st = timed_steps(torch, engine, plan, p, st, o, RING_TIMED)
            medians[label] = statistics.median(times[1:])
            reports = capture_rank_reports(lambda: engine.train_step(p, st, plan, 999, o))
            if reports:
                shares[label] = [round(rep["collective_time_us"] / rep["step_us"], 6)
                                 for rep in reports]
        records[name] = {"sha": out["plan_sha"], "schedule": out["schedule"],
                         "chunks": out["chunks"], "balance": out["balance"],
                         "predicted_ms": out["predicted_step_s"] * 1e3,
                         "median_ms": medians["pick"], "uniform_ms": medians["uniform"],
                         "sendrecv": shares, "losses": losses,
                         "table": [ln for ln in printed.splitlines()
                                   if ln.startswith(("[auto]", "[gnn] profiled", "     0",
                                                     "     1", "     2"))]}
        rl.line(f"21f {name:8s} plan digest {out['plan_sha']}: schedule {out['schedule']} "
                f"chunks {out['chunks']} balance {tuple(out['balance'])}, predicted "
                f"{out['predicted_step_s'] * 1e3:.6f} ms, measured median "
                f"{medians['pick']:.6f} ms ({torch.get_num_threads()} CPU threads); uniform "
                f"(2, 1, 1, 2) under the same schedule and chunks {medians['uniform']:.6f} ms; "
                f"GAT launches {cap.launches} [{H.card}]")
        for label, per_rank in shares.items():
            rl.line(f"21f {name:8s} {label:7s} NCCL SendRecv share of a traced step, ranks "
                    f"0-3: {per_rank} [{H.card}]")
        del pipe, uniform
    rl.data["plan"] = records


def worker_grid(H, torch, rl, refs):
    """21c on this rank: 2 replicas x a 2-stage ring, bit-identical to
    ``data_parallel`` 1 on one card; the eval over the plan's bucketed
    layout and over its padded stacked batch (serving's layout)."""
    from repro_torch.core.pipeline import make_engine

    model, plan = grid_model(H.dev)
    pipe = make_engine(model, grid_config(H.dev, data_parallel=2))
    limits = {"bucket_spmm_kernel": CAPTURE_LIMIT, "padded_spmm_kernel": CAPTURE_LIMIT}
    with deterministic(torch), KernelCapture(limits) as cap:
        params, state, opt, losses = train_steps(torch, pipe, plan, GRID_STEPS)
        metrics = {k: float(v) for k, v in pipe.evaluate(params, plan).items()}
        stacked = plan.stacked().graph
        padded = stacked.to(H.dev)
        with torch.inference_mode():
            padded_logp = pipe.compile_eval(params, padded)(padded)
            layout = pipe.layout(stacked)
            bucket_logp = pipe.compile_eval(params, layout)(layout)
    if not pipe._data_parallel_active:
        raise AssertionError("21c: the data axis did not split the chunks")
    if not same_trees(torch, cpu_tree(params), refs["grid"]["params"]) \
            or losses != refs["grid"]["losses"] or metrics != refs["grid"]["eval"]:
        raise AssertionError(f"21c rank {rl.rank}: not bit-identical to data_parallel 1 "
                             f"({losses}, {metrics})")
    gap = float((padded_logp - bucket_logp).abs().max())
    if not bool(padded_logp.isfinite().all()) or gap > GCN_MATCH_ATOL:
        raise AssertionError(f"21c rank {rl.rank}: padded eval {gap} from the bucketed one")
    rl.launched(cap.launches)
    cap.compare(H, torch, f"21c grid rank {rl.rank}")
    times, _, _ = timed_steps(torch, pipe, plan, params, state, opt, RING_TIMED)
    desc = pipe.describe()["ranks"]
    rl.line(f"21c powerlaw-64k GCN, replica {desc['replica']} position {desc['position']} of "
            f"{desc['rows']}: losses, params and eval after {GRID_STEPS} steps bit-identical "
            f"to data_parallel 1 on one card; padded eval within {gap:.3g} of the bucketed; "
            f"launches {cap.launches}; median step {statistics.median(times[1:]):.6f} ms "
            f"[{H.card}]")


def worker_serve(H, torch, rl):
    """21d on this rank: ``serve_gnn.run`` on the ring, every padded-GAT
    launch this rank made in the first calls held against the plain
    version; rank 0's summary."""
    from repro_torch.launch.serve_gnn import build_parser, run

    args = build_parser().parse_args([*SERVE_ARGS, "--engine", "compiled",
                                      "--device", H.dev.type])
    with KernelCapture({"gat_aggregate_kernel": 8}) as cap:
        summary = run(args)
    rl.launched(cap.launches)
    cap.compare(H, torch, f"21d serve rank {rl.rank}")
    if rl.rank == 0:
        served = sum(v["queries"] for v in summary["buckets"].values())
        if served != summary["queries"] or summary["verify_mismatches"] != 0:
            raise AssertionError(f"21d: {served}/{summary['queries']} served, "
                                 f"{summary['verify_mismatches']} mismatches")
        rl.data["serve"] = {k: summary[k] for k in ("achieved_qps", "p50_s", "p99_s")}
        rl.line(f"21d serve cora on 4 ranks: {served}/{summary['queries']} queries answered, "
                f"verify exact {summary['verify_exact']}, max diff "
                f"{summary['verify_max_diff']}; padded-GAT launches {cap.launches} [{H.card}]")
    else:
        rl.line(f"21d followed {summary['followed_batches']} batches; padded-GAT launches "
                f"{cap.launches} [{H.card}]")


def worker_stream(H, torch, rl):
    """21e on this rank: powerlaw-1m, the paper GAT, 4 stages x 8 chunks:
    one deterministic ring step, then 2 timed; then the group is left and
    rank 0 holds the step bit for bit against the one-card compiled step
    (phase 14a's) and times that."""
    import torch.distributed as dist

    import repro_torch.graphs as G
    from repro_torch.core.cli import PipelineCLIConfig
    from repro_torch.core.pipeline import make_engine
    from repro_torch.launch.train import build_parser
    from repro_torch.models.gnn.net import build_paper_gat
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.loop import synchronize

    args = build_parser().parse_args([*STREAM_ARGS, "--engine", "compiled", "--device",
                                      H.dev.type])
    t0 = time.perf_counter()
    plan = G.streamed_plan(G.open_streamed(args.dataset, seed=args.seed), args.chunks,
                           max_degree=args.max_degree)
    plan_s = time.perf_counter() - t0
    g0 = plan.batches[0].graph
    model = build_paper_gat(g0.num_features, g0.num_classes, backend="pallas", attn_dropout=0.0)
    params0 = model.init_params(0, device=H.dev)
    cli = PipelineCLIConfig.from_args(args)
    config = cli.gpipe_config(cli.uniform_balance(), device=H.dev)
    opt = opt_lib.adam(5e-3, weight_decay=5e-4)

    def step_s(pipe, params, state, key):
        t0 = time.perf_counter()
        out = pipe.train_step(params, state, plan, key, opt)
        synchronize(H.dev)
        return out, time.perf_counter() - t0

    pipe = make_engine(model, config)
    with deterministic(torch), KernelCapture({"bucket_gat_kernel": 8}) as cap:
        (p1, s1, l1), first_s = step_s(pipe, params0, opt.init(params0), 1)
    ring_p1, ring_l1 = cpu_tree(p1), float(l1)
    rl.launched(cap.launches)
    cap.compare(H, torch, f"21e powerlaw-1m rank {rl.rank}")
    ring = []
    state = (p1, s1)
    for key in (2, 3):
        (p, s, _), sec = step_s(pipe, *state, key)
        state = (p, s)
        ring.append(sec)
    rl.line(f"21e powerlaw-1m, 4 stages x 8 chunks, position "
            f"{pipe.describe()['ranks']['position']}: plan build {plan_s:.3f} s; first step "
            f"(deterministic) {first_s:.6f} s, then {ring[0]:.6f} and {ring[1]:.6f} s; "
            f"bucket-GAT launches {cap.launches} [{H.card}]")
    del pipe, p1, s1, state
    dist.barrier()
    dist.destroy_process_group()  # the one-card reference runs outside the group
    if rl.rank != 0:
        return
    gc.collect()
    torch.cuda.empty_cache()
    one = make_engine(model, config)
    with deterministic(torch):
        (q1, _, m1), _ = step_s(one, params0, opt.init(params0), 1)
    if not same_trees(torch, cpu_tree(q1), ring_p1) or float(m1) != ring_l1:
        raise AssertionError(f"21e: the ring's step is not bit-identical to the one-card "
                             f"compiled step ({ring_l1} vs {float(m1)})")
    del one, q1
    gc.collect()
    torch.cuda.empty_cache()
    one = make_engine(model, config)
    state, card = (params0, opt.init(params0)), []
    for key in (1, 2, 3):  # the first captures the graph
        (p, s, _), sec = step_s(one, *state, key)
        state = (p, s)
        card.append(sec)
    rl.data["stream"] = {"ring_s": ring, "card_s": card[1:]}
    rl.line(f"21e the ring's deterministic step bit-identical to the one-card compiled step "
            f"(loss {ring_l1}); timed steps on 4 ranks {ring[0]:.6f}, {ring[1]:.6f} s against "
            f"one card {card[1]:.6f}, {card[2]:.6f} s (this call; phase 14a: 7.25-7.32 s): "
            f"{card[1] / ring[0]:.3f}x, {card[2] / ring[1]:.3f}x [{H.card}]")


def rank_worker(leg: str) -> int:
    """``chip_smoke.py --rank-worker ring4|ring2|lm4|lmdata|lmbf16`` under
    torchrun: this rank's legs of phase 21 (``ring...``), 22 (``lm4``), 23
    (``lmdata``) or 25 (``lmbf16``), its record in ``rank_dir(leg)``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ranks
    from repro_torch.kernels.flash import kernel as FK
    from repro_torch.kernels.gat_edge import kernel as K
    from repro_torch.kernels.spmm import kernel as S
    from repro_torch.kernels.ssd import kernel as DK

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        from repro_torch.roofline.analysis import HW

        global CARD
        CARD = HW.of(torch.cuda.get_device_name(0))
    joined = ranks.join(device)
    H = Harness(torch, K, S, joined.device, os.environ.get("CHIP_SMOKE_CARD", device), FK=FK,
                DK=DK)
    rl = RankLog(joined.rank, leg, torch.get_num_threads())
    refs = torch.load(rank_dir(leg) / "refs.pt", weights_only=False)
    try:
        if leg == "lmbf16":
            bf16 = torch.bfloat16
            worker_lm_bf16_cut(H, torch, rl, refs)
            worker_lm_train_full(H, torch, rl, bf16)
            worker_lm_serve_full(H, torch, rl, bf16)
            worker_lm_data_train_full(H, torch, rl, bf16)
            worker_lm_data_moe(H, torch, rl, refs["experts"], bf16)
            worker_lm_data_count(H, torch, rl, ranks.RankGrid(2, 2), bf16)
        elif leg == "lmdata":
            grid = ranks.RankGrid(2, LM_DATA_CARDS // 2)
            worker_lm_data_cut(H, torch, rl, refs, grid)
            worker_lm_data_long(H, torch, rl, refs, grid)
            worker_lm_data_train_full(H, torch, rl)
            worker_lm_data_moe(H, torch, rl, refs["experts"])
            worker_lm_data_count(H, torch, rl, grid)
        elif leg == "lm4":
            worker_lm_cut(H, torch, rl, refs)
            worker_lm_train_full(H, torch, rl)
            worker_lm_serve_full(H, torch, rl)
        elif leg == "ring2":
            worker_ring(H, torch, rl, 2, refs)
        else:
            worker_ring(H, torch, rl, 4, refs)
            worker_plan(H, torch, rl)
            worker_grid(H, torch, rl, refs)
            worker_serve(H, torch, rl)
            worker_stream(H, torch, rl)  # leaves the group
        rl.write(H)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


# ------------------------------------------------- phase 22: the LM stage ring --

LM_RING_CARDS = 4  # phase 22 runs on exactly this many cards, one stage ring position each
LM_RING_DIR = ROOT / "build" / "phase22"
PHASE22_SKIP = "phase 22 needs 4 cards (run it on a host with 4 cards)"
LM_RING_TRAIN = [  # 22a-b: run_lm's defaults at full width, 4 micro-batches (C >= D interleaved)
    "--mode", "lm", "--full-arch", "--seq", "256", "--batch", "8", "--chunks", "4", "--lr", "3e-4",
    "--log-every", "0", "--device", "cuda",
]
LM_RING_SERVE = LM_SERVE_ARGS  # 22a, 22c: phase 8's serving flags
LM_RING_CUTS = (  # 22a: (tag, kind, arch, cut, flags), each bit for bit against one card
    ("codeqwen fill_drain", "train", "codeqwen1.5-7b", {"num_layers": 8},
     ["--stages", "4", "--steps", "2"]),
    ("codeqwen interleaved", "train", "codeqwen1.5-7b", {"num_layers": 8},
     ["--stages", "8", "--pipe-devices", "4", "--schedule", "interleaved", "--steps", "2"]),
    ("qwen2.5 serve", "serve", "qwen2.5-32b", {"num_layers": 8}, ["--stages", "4"]),
    ("zamba2 train", "train", "zamba2-7b", {"num_layers": 24}, ["--stages", "4", "--steps", "2"]),
    ("zamba2 serve", "serve", "zamba2-7b", {"num_layers": 24}, ["--stages", "4"]),
)
LM_RING_FULL_TRAIN = ("codeqwen1.5-7b", ["--stages", "4", "--steps", "4"])  # 22b
LM_RING_FULL_SERVE = ("qwen2.5-32b", ["--stages", "4"])  # 22c
LM_RING_CLI = (  # 22d: the launchers as a user starts them on 4 cards
    ["-m", "repro_torch.launch.serve", "--arch", "codeqwen1.5-7b", "--stages", "4",
     *LM_SERVE_ARGS],
    ["-m", "repro_torch.launch.train", *LM_RING_TRAIN, "--arch", "mamba2-130m", "--stages", "4",
     "--steps", "3"],
)
LM_RING_CAPTURE = 4  # kernel calls a rank keeps per kernel and leg, held against the plain version
LM_RING_DECODE_TRACED = 4  # decode steps in 22c's traced window
CARD_BYTES = 80e9  # one H100's memory


def rank_dir(leg: str) -> Path:
    """Where a worker leg's records go: phase 25's (``lmbf16``), 23's
    (``lmdata``), 22's (``lm4``) or 21's."""
    if leg == "lmbf16":
        return LM_BF16_DIR
    if leg == "lmdata":
        return LM_DATA_DIR
    return LM_RING_DIR if leg.startswith("lm") else RANKS_DIR


def tree_digests(torch, tree, stages=None, prefix=""):
    """{path: (sum, weighted sum)} of a params-shaped tree's bits: each
    leaf's elements as integers of their width (``bits_digest``), summed
    plain and weighted by position mod 65521
    (a changed bit changes them), in 2^24-element pieces on the leaf's
    device. ``blocks`` leaves are digested per row under ``path@stage``,
    row i being stage ``stages[i]`` (every row's own index when None)."""
    out = {}
    for k, v in tree.items():
        path = prefix + k
        if isinstance(v, dict):
            out.update(tree_digests(torch, v, stages, path + "/"))
        elif path.startswith("blocks/"):
            for i in range(v.shape[0]):
                out[f"{path}@{i if stages is None else stages[i]}"] = bits_digest(torch, v[i])
        else:
            out[path] = bits_digest(torch, v)
    return out


def leaf_dtypes(tree) -> set:
    """The dtypes of a tree's leaves, as strings."""
    from repro_torch.train.optimizer import tree_leaves

    return {str(a.dtype) for a in tree_leaves(tree)}


def cache_dtypes(cache, prefix="") -> dict:
    """{leaf name: dtype} of a decode cache (a hybrid's ``mamba/ssm`` ...)."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(cache_dtypes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = str(v.dtype)
    return out


def cache_digests(torch, cache, stages=None, data=1, replica=None, seq=False):
    """{``path@stage#r``: digest} of a decode cache's rows (leaves
    (stages, micro, slots, b_mb, ...)): per stage row (``stages[i]`` for
    row i, every row's own index when None) and, over a data axis of
    ``data``, per replica: its micro-batch rows, or with ``seq`` its ring
    slots of the attention leaves (``k``, ``v``, ``ckv``). In one process
    (``replica`` None) every replica's part; on a rank its own."""
    from repro_torch.models.transformer.model import _cut

    out = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{path}{k}/")
                continue
            split = None if data == 1 else (3 if seq and k in ("k", "v", "ckv") else
                                            None if seq else 2)
            for i in range(v.shape[0]):
                key = f"{path}{k}@{i if stages is None else stages[i]}"
                if split is None:
                    out[key] = bits_digest(torch, v[i])
                elif replica is None:
                    for r in range(data):
                        out[f"{key}#{r}"] = bits_digest(torch, _cut(v[i], split, data, r))
                else:
                    out[f"{key}#{replica}"] = bits_digest(torch, v[i])

    walk(cache, "")
    return out


def bits_digest(torch, t):
    """(sum, weighted sum) of ``t``'s bits: its elements as signed integers
    of their own width (int16 for bf16, int32 for float32), widened."""
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    words = t.detach().contiguous().view(-1).view(width)
    total = weighted = 0
    for start in range(0, words.numel(), 1 << 24):
        w = words[start:start + (1 << 24)].to(torch.int64)
        idx = torch.arange(start, start + w.numel(), device=w.device, dtype=torch.int64) % 65521
        total += int(w.sum())
        weighted += int((w * (idx + 1)).sum())
    return total, weighted


def lm_ring_case(H, torch, kind, arch, cut, flags, capture=None, dtype=None):
    """One 22a (25a at ``dtype`` bf16) case through the launchers'
    functions, in this process (one card, no group) or on this rank
    (``serve``/``train_lm`` find the group): what is held bit for bit, with
    the params', moments' and decode cache's digests per stage row (this
    rank's rows on a ring), and every leaf's dtype."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_lm
    from repro_torch.launch import train as train_launch
    from repro_torch.models.transformer.model import held_stages

    full = "--full-arch" in (LM_RING_TRAIN if kind == "train" else LM_RING_SERVE)
    cfg, note = cut_config(get_arch(arch, smoke=not full), cut)
    limits = {name: LM_RING_CAPTURE for name in active_slots(cfg)} if capture is None else capture
    with deterministic(torch), KernelCapture(limits) as cap:
        if kind == "train":
            args = train_launch.build_parser().parse_args([*LM_RING_TRAIN, "--arch", arch, *flags])
            run = train_launch.train_lm(cfg, args, dtype=dtype)
            topo = run.topo
            stages = None if topo.ring is None else held_stages(topo, topo.ring.position)
            got = {"losses": run.losses, "step_s": run.step_s,
                   "params": tree_digests(torch, run.params, stages),
                   "mu": tree_digests(torch, run.opt_state.mu, stages),
                   "nu": tree_digests(torch, run.opt_state.nu, stages),
                   "dtypes": {"params": leaf_dtypes(run.params),
                              "moments": leaf_dtypes(run.opt_state.mu) | leaf_dtypes(
                                  run.opt_state.nu)}}
            if dtype is not None:
                # step 0's batch again with the trained params: the loss's dtype
                again = run.step.loss(run.params, train_launch.lm_batch(cfg, args, 0, H.dev))
                got["again"] = bits_digest(torch, again)
                got["dtypes"]["loss"] = {str(again.dtype)}
        else:
            args = serve_lm.build_parser().parse_args(["--arch", arch, *LM_RING_SERVE, *flags])
            run = serve_lm.serve(args, cfg, dtype=torch.float32 if dtype is None else dtype)
            gen = run.generation
            topo = run.topo
            stages = None if topo.ring is None else held_stages(topo, topo.ring.position)
            got = {"tokens": gen.tokens.tolist(), "prefill_s": gen.prefill_s,
                   "decode_s": gen.decode_s,
                   "logits": [bits_digest(torch, gen.prefill_logits),
                              bits_digest(torch, gen.first_decode_logits)],
                   "cache": cache_digests(torch, gen.cache, stages),
                   "dtypes": {"params": leaf_dtypes(run.params),
                              "cache": cache_dtypes(gen.cache),
                              "logits": {str(gen.prefill_logits.dtype),
                                         str(gen.first_decode_logits.dtype)}}}
    got.update(summary=run.summary, note=note, topo=repr(run.topo))
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return got, cap


def lm_ring_references(H, torch):
    """22a on one card (``H.dev``), deterministic: every cut case at the
    ring's Topology in one process, saved for the rank workers."""
    refs = {}
    for tag, kind, arch, cut, flags in LM_RING_CUTS:
        t0 = time.perf_counter()
        got, cap = lm_ring_case(H, torch, kind, arch, cut, flags, capture={})
        refs[tag] = got
        what = (f"losses {got['losses']}, median step {statistics.median(got['step_s'][1:]):.6f} "
                f"s" if kind == "train" else
                f"tokens[0] {got['tokens'][0]}, prefill {got['prefill_s']:.6f} s, decode "
                f"{got['decode_s'] / 16:.6f} s a token")
        log(f"[lm-ring] 22a one card, {tag}{got['note']}, topology {got['topo']}: {what}; peak "
            f"{got['summary']['peak_mem_gb']} GB; {time.perf_counter() - t0:.1f} s [{H.card}]")
    torch.save(refs, LM_RING_DIR / "refs.pt")
    return refs


def lm_ring_timing(H, torch):
    """The LM kernels timed on one card at phase 22's launch shapes: flash
    at 22b's training micro-batch and 22c's prefill micro-batch, SSD at
    22a's zamba2 training and prefill micro-batches."""
    timing = {
        "flash_attention_kernel": time_flash(
            H, torch, "one qwen2.5-32b ring prefill launch (4 x 512 tokens, GQA 40/8, hd 128, "
            "causal, fp32)", *flash_inputs(H, 4, 512, 40, 8, 128)),
        "ssd_kernel": time_ssd(
            H, torch, "one zamba2 ring prefill call (4 x 512 tokens, 112 heads, P 64, N 64, "
            "chunk 128)", *ssd_inputs(H, 4, 512, 112, 64, 64)),
    }
    time_flash(H, torch, "one codeqwen ring training launch (2 x 256 tokens, 32 heads, hd 128, "
               "causal, fp32)", *flash_inputs(H, 2, 256, 32, 32, 128))
    time_ssd(H, torch, "one zamba2 ring training call (2 x 256 tokens, 112 heads, P 64, N 64, "
             "chunk 128)", *ssd_inputs(H, 2, 256, 112, 64, 64))
    for name, record in timing.items():
        H.timing.setdefault(name, record)


def state_bytes(leaf, values, train, moment_values=None):
    """Bytes of ``values`` of a params leaf (in its dtype) and, when
    training, as many gradient values in that dtype and Adam's two float32
    moments of ``moment_values`` (default ``values``)."""
    size = leaf.element_size()
    if not train:
        return values * size
    return 2 * values * size + 2 * 4 * (values if moment_values is None else moment_values)


def state_gb(cfg, topo, position, train, dtype=None):
    """The GB ring position ``position`` holds before any activation: its
    stage rows and every replicated leaf, params (``dtype``, float32 by
    default, leaf by leaf as ``init_params`` makes them) and, when
    training, gradients at the params' dtype and Adam's two float32
    moments."""
    import torch

    from repro_torch.models.transformer.model import abstract_params, held_stages
    from repro_torch.train.optimizer import tree_leaves

    meta = abstract_params(cfg, topo.num_stages, torch.float32 if dtype is None else dtype)
    share = len(held_stages(topo, position)) / topo.num_stages
    n = sum(state_bytes(p, p.numel() * (share if path == "blocks" else 1), train)
            for path, tree in meta.items() for p in tree_leaves(tree))
    return n / 1e9


def lm_ring_predictions(H):
    """Each full-width leg's per-rank state against the card's memory,
    printed before the run (a leg that cannot fit stops here)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_lm
    from repro_torch.launch import train as train_launch
    from repro_torch.models.transformer.model import Topology

    train_args = train_launch.build_parser().parse_args(
        [*LM_RING_TRAIN, "--arch", LM_RING_FULL_TRAIN[0], *LM_RING_FULL_TRAIN[1]])
    serve_args = serve_lm.build_parser().parse_args(
        ["--arch", LM_RING_FULL_SERVE[0], *LM_RING_SERVE, *LM_RING_FULL_SERVE[1]])
    for leg, args, train in (("22b", train_args, True), ("22c", serve_args, False)):
        cfg = get_arch(args.arch, smoke=not args.full_arch)
        topo = Topology(num_stages=args.stages, num_micro=args.chunks)
        gbs = [state_gb(cfg, topo, d, train) for d in range(args.stages)]
        log(f"[lm-ring] {leg} {args.arch} {cfg.num_layers} layers on {args.stages} ranks: fp32 "
            f"{'params, gradients and Adam moments' if train else 'weights'} per rank "
            + ", ".join(f"{g:.3f}" for g in gbs) + f" GB of the card's {CARD_BYTES / 1e9:.0f} "
            f"[{H.card}]")
        if max(gbs) > 0.9 * CARD_BYTES / 1e9:
            raise AssertionError(f"{leg}: a rank's state {max(gbs):.1f} GB would not fit")


def lm_ring_cli(H, torch):
    """22d: ``torchrun --nproc-per-node 4`` of both LM launchers, started
    together as a user starts them: one result dict each, from rank 0."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={LM_RING_CARDS}", *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for argv in LM_RING_CLI]
    outs = []
    try:
        for argv, proc in zip(LM_RING_CLI, procs):
            out, _ = proc.communicate(timeout=RANK_LAUNCH_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"torchrun {' '.join(argv[:2])}: exit {proc.returncode}\n"
                                     f"{out[-6000:]}")
            dicts = [ast.literal_eval(line) for line in out.splitlines()
                     if line.startswith("{'arch'")]
            if len(dicts) != 1 or dicts[0].get("ranks") != LM_RING_CARDS:
                raise AssertionError(f"torchrun {' '.join(argv[:2])}: {len(dicts)} result "
                                     f"dicts\n{out[-6000:]}")
            outs.append(dicts[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    served, trained = outs
    if not all(math.isfinite(x) for x in trained["losses"]):
        raise AssertionError(f"torchrun train: losses {trained['losses']}")
    log(f"[lm-ring] 22d torchrun -m repro_torch.launch.serve (codeqwen1.5-7b, 4 ranks) and -m "
        f"repro_torch.launch.train --mode lm (mamba2-130m, 4 ranks), together "
        f"{time.perf_counter() - t0:.1f} s: serve prefill_s {served['prefill_s']}, "
        f"decode_s_per_tok {served['decode_s_per_tok']}, tokens_per_s {served['tokens_per_s']}, "
        f"sample {served['sample']}, peak per rank {served['peak_mem_gb_per_rank']}; train "
        f"losses {trained['losses']}, avg step {trained['avg_step_s']}, peak per rank "
        f"{trained['peak_mem_gb_per_rank']} [{H.card}]")


def phase_lm_ring(H, torch):
    """Phase 22: the LM stage ring on four cards, one stage per rank. 22a
    cut-depth cases bit for bit on every rank against one card; 22b
    codeqwen1.5-7b trained at its 32 layers; 22c qwen2.5-32b served at its
    64 layers; 22d both LM launchers under torchrun. Returns what did not
    run, having printed it ("" when all of it ran)."""
    n = torch.cuda.device_count()
    if n < LM_RING_CARDS:
        log(f"[lm-ring] not run: {PHASE22_SKIP} (this machine has {n})")
        return f"phase 22 not run ({PHASE22_SKIP})"
    shutil.rmtree(LM_RING_DIR, ignore_errors=True)
    LM_RING_DIR.mkdir(parents=True)
    lm_ring_predictions(H)
    lm_ring_references(H, torch)
    lm_ring_timing(H, torch)
    gc.collect()
    torch.cuda.empty_cache()
    run_rank_worker(H, torch, LM_RING_CARDS, "lm4")
    lm_ring_cli(H, torch)
    return ""


# ---------------------------------------------- phase 22: the rank worker --


def worker_lm_cut(H, torch, rl, refs):
    """22a on this rank: each cut case on the ring, bit for bit against the
    one-card case of ``refs``: the losses, this rank's rows of the params
    and of Adam's moments and its replicated leaves (digests), the tokens
    and logits; this rank's kernel calls held against the plain version."""
    for tag, kind, arch, cut, flags in LM_RING_CUTS:
        got, cap = lm_ring_case(H, torch, kind, arch, cut, flags)
        keys = ("losses", "params", "mu", "nu") if kind == "train" else ("tokens", "logits")
        held_bit_for_bit(f"22a {tag} rank {rl.rank}", got, refs[tag], keys)
        rl.launched(cap.launches)
        cap.compare(H, torch, f"22a {tag} rank {rl.rank}")
        rows = sum(1 for k in got["params"] if "@" in k) if kind == "train" else 0
        rl.line(f"22a {tag}{got['note']}, {got['topo']}: "
                + (f"losses {got['losses']}, {rows} block-row leaves and every replicated leaf "
                   f"of params, mu and nu" if kind == "train" else
                   f"tokens {len(got['tokens'])} x {len(got['tokens'][0])}, prefill and first "
                   "decode logits")
                + f" bit-identical to one card; launches {cap.launches} [{H.card}]")


def held_bit_for_bit(label, got, want, keys):
    """Each of ``keys`` of a rank's case equal to the one-card case's; a
    digest dict over this rank's rows only, each of which one card has."""
    for key in keys:
        mine = got[key]
        if isinstance(mine, dict):
            missing = [k for k in mine if k not in want[key]]
            if missing:
                raise AssertionError(f"{label}: {key} {missing[:4]} not in the one-card digests")
            ref = {k: want[key][k] for k in mine}
        else:
            ref = want[key]
        if mine != ref:
            bad = [k for k in mine if mine[k] != ref[k]][:4] if isinstance(mine, dict) else mine
            raise AssertionError(f"{label}: {key} not bit-identical to one card ({bad})")


def held_launches(H, torch, rl, cap, label, bf16=False):
    """A rank's kept kernel calls held against the plain version (the bf16
    instances within ``BF16_ULPS``, ``compare_bf16_calls``) and its
    launches counted (a bf16 launch under its instance's key)."""
    if bf16:
        compare_bf16_calls(H, cap, label)
        flash = "flash_attention_kernel"
        count_wgmma(H, label, cap.launches.get(flash, 0), cap.wgmma.get(flash, 0))
        rl.launched({**{BF16_KEYS[name]: n for name, n in cap.launches.items()},
                     WGMMA_KEY: cap.wgmma.get(flash, 0)})
    else:
        cap.compare(H, torch, label)
        rl.launched(cap.launches)


def rank_report_lines(H, rl, leg, reports):
    """Rank 0's lines for every rank's traced call."""
    for rep in reports or ():
        busy = (rep["compute_time_us"] + rep["collective_time_us"]
                - rep["overlapped_time_us"]) / rep["step_us"]
        rl.line(f"{leg} traced, rank {rep['rank']}: {rep['step_us'] / 1e3:.6f} ms, compute "
                f"{rep['compute_time_us'] / rep['step_us']:.6f} of it, busy {busy:.6f}, NCCL "
                f"{rep['collective_time_us'] / 1e3:.6f} ms ({rep['num_collective_events']} "
                f"kernels, {rep['collective_time_us'] / rep['step_us']:.6f} of it), hidden "
                f"{rep['overlap_fraction']:.6f} of it [{H.card}]")


def worker_lm_train_full(H, torch, rl, dtype=None):
    """22b (25b at ``dtype`` bf16) on this rank: codeqwen1.5-7b at its 32
    layers, 8 a rank: losses finite and every rank's alike, this rank's
    flash launches (forward and recompute of its 8 layers x 4 micro-batches
    a step), the median step, peak and tokens/s, and one traced step per
    rank; at bf16 the model FLOPs over the median step as a share of the 4
    cards' bf16 peak, beside 22b's fp32 figures."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.overlap_report import capture_rank_reports
    from repro_torch.launch.train import build_parser, lm_batch, train_lm
    from repro_torch.models.transformer.model import held_stages
    from repro_torch.roofline import model_flops

    bf16 = dtype is not None and dtype != torch.float32
    tag = "25b" if bf16 else "22b"
    arch, flags = LM_RING_FULL_TRAIN
    args = build_parser().parse_args([*LM_RING_TRAIN, "--arch", arch, *flags])
    cfg = get_arch(arch, smoke=not args.full_arch)
    held = []
    with KernelCapture({"flash_attention_kernel": LM_RING_CAPTURE}) as cap:
        trained = train_lm(cfg, args, dtype=dtype, on_step=lambda i, *_: held.append(
            torch.cuda.memory_allocated(H.dev) if H.dev.type == "cuda" else 0))
    topo = trained.topo
    mine = active_slots(cfg, topo.num_stages, held_stages(topo, topo.ring.position))
    want = {k: 2 * n * args.chunks * args.steps for k, n in mine.items()}
    if cap.launches != want:
        raise AssertionError(f"{tag} rank {rl.rank}: launches {cap.launches}, want {want}")
    losses = trained.losses
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, losses)
    if not all(map(math.isfinite, losses)) or any(x != losses for x in every):
        raise AssertionError(f"{tag} rank {rl.rank}: losses {every}")
    held_launches(H, torch, rl, cap, f"{tag} rank {rl.rank}", bf16)
    median = statistics.median(trained.step_s[1:])
    peak = trained.summary["peak_mem_gb"]
    batch = lm_batch(cfg, args, args.steps, H.dev)
    reports = capture_rank_reports(
        lambda: trained.step(trained.params, trained.opt_state, batch))
    rl.data[tag] = {"median_s": median, "peak_gb": peak, "losses": losses,
                    "per_rank_peak": trained.summary["peak_mem_gb_per_rank"]}
    share = ""
    if bf16:
        flops = model_flops(cfg, ShapeConfig("t", args.seq, args.batch, "train"), training=True)
        peak_rate = LM_RING_CARDS * CARD.bf16_flops
        share = (f"; model FLOPs {flops:.6g} over the median {flops / median / peak_rate:.4f} "
                 f"of {LM_RING_CARDS} cards' bf16 peak; beside {FP32_22B}")
    reckoned = held_beside_reckoning(cfg, topo, topo.ring.position, dtype, held[0])
    rl.line(f"{tag} {arch} full width, {cfg.num_layers} layers, "
            f"{'bf16 params, ' if bf16 else ''}{trained.topo}: losses {losses} "
            f"(every rank alike); step s {trained.step_s}; median after the first {median:.6f} "
            f"s, {args.batch * args.seq / median:.1f} tokens/s; peak {peak} GB; {reckoned}; "
            f"launches {cap.launches}{share} [{H.card}]")
    rank_report_lines(H, rl, f"{tag} one train step", reports)
    del trained, batch
    gc.collect()
    torch.cuda.empty_cache()


def worker_lm_serve_full(H, torch, rl, dtype=None):
    """22c (25c at ``dtype`` bf16) on this rank: qwen2.5-32b at its 64
    layers, 16 a rank: the prefill's flash launches (16 layers x 2
    micro-batches), the first decode's logits within 1e-3 (bf16: within
    ``BF16_DECODE_FRAC`` of the largest |logit|) of a fresh 513-row
    prefill's (itself traced per rank), and 4 more decode steps traced per
    rank. At bf16 the prefill's logits are also held within
    ``BF16_VS_FP32_FRAC`` of the largest |logit| of the float32 ring
    prefill from the same weights upcast."""
    import numpy as np

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core.overlap_report import capture_rank_reports
    from repro_torch.launch.serve import build_parser, serve
    from repro_torch.models.transformer.model import (
        _prefill, held_stages, init_cache, make_extras, make_prefill_step, make_serve_step)
    from repro_torch.train.optimizer import tree_map

    bf16 = dtype is not None and dtype != torch.float32
    tag = "25c" if bf16 else "22c"
    arch, flags = LM_RING_FULL_SERVE
    args = build_parser().parse_args(["--arch", arch, *LM_RING_SERVE, *flags])
    cfg = get_arch(arch, smoke=not args.full_arch)
    with KernelCapture({"flash_attention_kernel": LM_RING_CAPTURE}) as cap:
        served = serve(args, cfg, dtype=dtype if bf16 else torch.float32)
    topo, gen = served.topo, served.generation
    mine = active_slots(cfg, topo.num_stages, held_stages(topo, topo.ring.position))
    want = {k: n * args.chunks for k, n in mine.items()}
    if cap.launches != want:
        raise AssertionError(f"{tag} rank {rl.rank}: launches {cap.launches}, want {want}")
    held_launches(H, torch, rl, cap, f"{tag} rank {rl.rank}", bf16)
    b, plen = served.prompt.shape[0], served.prompt_len
    notes = []
    if bf16:
        pshape = ShapeConfig("fp32", plen, b, "prefill")
        params32 = tree_map(lambda p: p.float(), served.params)
        with torch.inference_mode():
            logits32, _ = make_prefill_step(cfg, topo, pshape)(
                params32, init_cache(cfg, topo, pshape, device=H.dev), served.batch())
        del params32
        scale = float(logits32.abs().max())
        err = float((gen.prefill_logits - logits32).abs().max())
        agree = int((gen.prefill_logits.argmax(-1) == logits32.argmax(-1)).sum())
        if not err <= BF16_VS_FP32_FRAC * scale:
            raise AssertionError(f"{tag} rank {rl.rank}: bf16 prefill logits {err:.4g} from the "
                                 f"fp32 ring prefill's (limit {BF16_VS_FP32_FRAC} x {scale:.4g})")
        notes.append(f"prefill vs the fp32 ring prefill from the same weights upcast: max |logit "
                     f"diff| {err:.6g} = {err / scale:.5f} of the largest |logit| {scale:.6g} "
                     f"(limit {BF16_VS_FP32_FRAC}), argmax agree {agree}/{b}")
        del logits32
        gc.collect()
        torch.cuda.empty_cache()
    tok0 = torch.from_numpy(gen.tokens[:, 0]).to(H.dev, torch.int64)
    longer = {"tokens": torch.cat([served.prompt, tok0[:, None]], dim=1)}
    shape = ShapeConfig("check", plen + 1, b, "prefill")
    fresh = []

    def prefill():
        with torch.inference_mode():
            fresh.append(_prefill(cfg, topo, make_extras(cfg, topo.num_stages), served.params,
                                  init_cache(cfg, topo, shape, device=H.dev,
                                             dtype=served.params["embed"].dtype),
                                  longer, plen + 1)[0])

    prefill_reports = capture_rank_reports(prefill)
    err = float((gen.first_decode_logits - fresh[0]).abs().max())
    agree = int((gen.first_decode_logits.argmax(-1) == fresh[0].argmax(-1)).sum())
    scale = float(fresh[0].abs().max())
    limit = BF16_DECODE_FRAC * scale if bf16 else DECODE_VS_PREFILL_ATOL
    if not err <= limit:
        raise AssertionError(f"{tag} rank {rl.rank}: decode at position {plen} {err:.3g} from a "
                             f"fresh {plen + 1}-row prefill (limit {limit:.4g})")
    notes.append(f"decode vs fresh {plen + 1}-row prefill: max |logit diff| {err:.6g} "
                 + (f"= {err / scale:.5f} of the largest |logit| {scale:.6g} (limit "
                    f"{BF16_DECODE_FRAC})" if bf16 else f"(limit {DECODE_VS_PREFILL_ATOL})")
                 + f", argmax agree {agree}/{b}")
    del fresh
    step = make_serve_step(cfg, topo, ShapeConfig("serve_decode", plen + args.decode_steps + 16,
                                                  b, "decode"))
    tok = torch.from_numpy(np.ascontiguousarray(gen.tokens[:, -1])).to(H.dev, torch.int32)

    def decode():
        nonlocal tok
        with torch.inference_mode():
            for i in range(LM_RING_DECODE_TRACED):
                tok, _, _ = step(served.params, gen.cache, {"tokens": tok,
                                                            "pos": plen + args.decode_steps + i})

    decode_reports = capture_rank_reports(decode)
    summary = served.summary
    rl.data[tag] = {k: summary[k] for k in ("prefill_s", "decode_s_per_tok", "tokens_per_s",
                                            "peak_mem_gb", "peak_mem_gb_per_rank", "params")}
    rl.line(f"{tag} {arch} full width, {cfg.num_layers} layers ({summary['params']} params, "
            f"{'bf16' if bf16 else 'fp32'}), {topo}: prefill_s {summary['prefill_s']}, "
            f"decode_s_per_tok {summary['decode_s_per_tok']}, tokens_per_s "
            f"{summary['tokens_per_s']}, peak {summary['peak_mem_gb']} GB, sample "
            f"{summary['sample']}; " + "; ".join(notes) + f"; launches {cap.launches} [{H.card}]")
    rank_report_lines(H, rl, f"{tag} the fresh {plen + 1}-row prefill", prefill_reports)
    rank_report_lines(H, rl, f"{tag} {LM_RING_DECODE_TRACED} decode steps", decode_reports)
    del served, gen, step
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------- phase 23: the LM data axis --

LM_DATA_CARDS = 4  # phase 23: 2 data replicas of a 2-position stage ring, one rank a card
LM_DATA_DIR = ROOT / "build" / "phase23"
PHASE23_SKIP = "phase 23 needs 4 cards (run it on a host with 4 cards)"
LM_DATA_SEQ, LM_DATA_BATCH, LM_DATA_MICRO = 256, 8, 2  # phase 16's, 2 micro-batches a replica
LM_DATA_TRAIN = [  # 23b-c, 23e: the launcher's flags at full width
    "--mode", "lm", "--full-arch", "--seq", str(LM_DATA_SEQ), "--batch", str(LM_DATA_BATCH),
    "--chunks", str(LM_DATA_MICRO), "--lr", "3e-4", "--log-every", "0", "--device", "cuda",
]
LM_DATA_CUTS = (  # 23a: (tag, kind, arch, cut, Topology fields), dp 2 x D 2 against one card
    ("codeqwen zero3", "train", "codeqwen1.5-7b", {"num_layers": 8}, {}),
    ("codeqwen zero1", "train", "codeqwen1.5-7b", {"num_layers": 8}, {"zero3": False}),
    ("codeqwen interleaved", "train", "codeqwen1.5-7b", {"num_layers": 8},
     {"num_stages": 4, "schedule": "interleaved", "num_virtual": 2}),
    ("zamba2 train", "train", "zamba2-7b", {"num_layers": 24}, {}),
    ("arctic gathered", "train", "arctic-480b", {"num_layers": 2, "num_experts": 8}, {}),
    ("arctic a2a", "train", "arctic-480b", {"num_layers": 2, "num_experts": 8},
     {"moe_mode": "a2a"}),
    ("qwen2.5 serve", "serve", "qwen2.5-32b", {"num_layers": 8}, {}),
)
LM_DATA_FULL_TRAIN = ("codeqwen1.5-7b", ["--stages", "2", "--steps", "4"])  # 23b
LM_DATA_MOE = ("arctic-480b", {"num_layers": 2})  # 23c: served with all 128 experts
LM_DATA_MOE_EXPERTS = (64, 48, 32)  # 23c's training: the widest cut whose state fits
LM_DATA_MOE_FIT = 0.7  # of the card: the predicted state 23c's training may take
LM_DATA_COUNT = ("codeqwen1.5-7b", {"num_layers": 8})  # 23f: one rank's step counted
LM_DATA_COUNT_GRIDS = (("dp 2 x D 2", (1, 2, 2)), ("pods 2 x D 2", (2, 1, 2)))  # (pods, data, D)
LM_DATA_CLI = (  # 23e: the launchers as a user starts them on 4 cards, 2 data replicas
    ["-m", "repro_torch.launch.serve", "--arch", "codeqwen1.5-7b", "--stages", "2",
     *LM_SERVE_ARGS],
    ["-m", "repro_torch.launch.train", *LM_DATA_TRAIN, "--arch", "mamba2-130m", "--stages",
     "2", "--steps", "3"],
)


def lm_data_topology(fields, ring=None):
    """A 23a (25a) case's Topology: 2 stages, 2 micro-batches, 2 data
    replicas, or ``fields``' (``pods``: 2 pods of ``data`` replicas)."""
    from repro_torch.models.transformer.model import Topology

    base = {"num_stages": 2, "num_micro": LM_DATA_MICRO, "loss_chunks": 4, "data": 2}
    return Topology(ring=ring, **{**base, **fields})


def count_topology(grid_shape, ring=None):
    """A 23f grid's Topology: ``(pods, data, D)``, 2 micro-batches a replica."""
    from repro_torch.models.transformer.model import Topology

    pods, data, D = grid_shape
    return Topology(num_stages=D, num_micro=LM_DATA_MICRO, loss_chunks=4, data=data, pods=pods,
                    ring=ring)


def counts_of(counter):
    """An ``OpCounter``'s counts, op for op: aten FLOPs and bytes by op,
    kernel calls, operations and bytes, collectives by kind."""
    return {"flops": dict(counter.flops_by_op), "bytes": dict(counter.bytes_by_op),
            "calls": dict(counter.kernel_calls), "kernel_ops": dict(counter.kernel_ops),
            "kernel_bytes": dict(counter.kernel_bytes), "collectives": dict(counter.collectives)}


def lm_data_counts(H, torch, reports, dtype=None):
    """23f's check (25e's at ``dtype`` bf16), in this process (no group; a
    fake world of 4 for each count): each rank's card count of its step, on
    each grid, equal to the same rank's count on meta op for op, and its
    peak increment within ``PEAK_RTOL`` of the card allocator's."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.dryrun import count_on_grid

    dtype = torch.float32 if dtype is None else dtype
    tag = "23f" if dtype == torch.float32 else "25e"
    arch, cut = LM_DATA_COUNT
    cfg, _ = cut_config(get_arch(arch), cut)
    shape = ShapeConfig("23f", LM_DATA_SEQ, LM_DATA_BATCH, "train")
    for label, grid_shape in LM_DATA_COUNT_GRIDS:
        pods, data, D = grid_shape
        for r, rep in enumerate(reports):
            got = rep["count"][label]
            _, meta = count_on_grid(cfg, shape, pods=pods, data=data, stages=D, rank=r,
                                    topology=lambda g, s=grid_shape: count_topology(s, g),
                                    dtype=dtype)
            want = counts_of(meta)
            if got["counts"] != want:
                diff = {k: (got["counts"][k], want[k]) for k in want
                        if got["counts"][k] != want[k]}
                raise AssertionError(f"{tag} {label} rank {r}: the card's count differs from "
                                     f"meta's: {str(diff)[:1500]}")
            if abs(got["ratio"] - 1.0) > PEAK_RTOL:
                raise AssertionError(f"{tag} {label} rank {r}: the counter's peak increment is "
                                     f"{got['ratio']:.4f} of the card's (limit 1 +- "
                                     f"{PEAK_RTOL})")
            coll = {k: v for k, v in want["collectives"].items() if v}
            log(f"[lm-data] {tag} {label} rank {r} ({got['place']}, {str(dtype)[6:]}): card "
                f"count == meta count "
                f"in a fake world of 4, op for op: aten {sum(want['flops'].values())} FLOPs, "
                f"{sum(want['bytes'].values())} B over {len(want['bytes'])} ops, kernel calls "
                f"{want['calls']}, collectives {coll}; peak increment counter "
                f"{got['counted_gb']:.6f} GB, card {got['card_gb']:.6f} GB, ratio "
                f"{got['ratio']:.4f}; step under the counter {got['count_s']:.3f} s [{H.card}]")


def grid_digests(torch, tree, cfg, topo, moments=False, position=None, replica=None):
    """``tree_digests`` over a data axis: a ``blocks`` leaf per stage row
    (``path@stage``), and a leaf the layout splits (``param_layout``, or
    ``moment_specs`` with ``moments``) per data shard (``...#r``): in one
    process (``position`` None) every row and shard, on a rank its own."""
    from repro_torch.models.transformer.model import _cut, held_stages, leaf_layout

    layout = leaf_layout(cfg, topo)
    dims = layout.moments if moments else layout.params
    stages = list(range(topo.num_stages)) if position is None else held_stages(topo, position)
    out = {}

    def walk(t, d, path):
        for k, v in t.items():
            p = f"{path}{k}"
            if isinstance(v, dict):
                walk(v, d[k], p + "/")
                continue
            dim = d[k]
            if p.startswith("blocks/"):
                rows = [(f"{p}@{s}", v[i]) for i, s in enumerate(stages)]
                dim = None if dim is None else dim - 1
            else:
                rows = [(p, v)]
            for key, a in rows:
                if dim is None:
                    out[key] = bits_digest(torch, a)
                elif position is None:
                    for r in range(topo.data):
                        out[f"{key}#{r}"] = bits_digest(torch, _cut(a, dim, topo.data, r))
                else:
                    out[f"{key}#{replica}"] = bits_digest(torch, a)

    walk(tree, dims, "")
    return out


def lm_data_case(H, torch, kind, arch, cut, fields, grid=None, capture=None, dtype=None):
    """One 23a (25a at ``dtype`` bf16) case at full width, cut depth: one
    process on one card (``grid`` None, every replica and pod) or this rank
    of the grid; what is held bit for bit, with digests per stage row and
    data shard (caches too), and every leaf's dtype. A pod holds the same
    rows as every other pod, so a rank's digests are its pod's."""
    from argparse import Namespace

    import numpy as np

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.tokens import token_batch
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import lm_batch
    from repro_torch.models.transformer.model import held_stages, init_params, make_train_step

    cfg, note = cut_config(get_arch(arch, smoke=False), cut)
    topo = lm_data_topology(fields, grid)
    dtype = torch.float32 if dtype is None else dtype
    own, place = {}, {}
    if grid is not None:
        own = {"stages": held_stages(topo, grid.position), "data_rank": grid.replica}
        place = {"position": grid.position, "replica": grid.replica}
    limits = {name: LM_RING_CAPTURE for name in active_slots(cfg)} if capture is None else capture
    torch.cuda.reset_peak_memory_stats(H.dev)
    with deterministic(torch), KernelCapture(limits) as cap:
        params = init_params(cfg, seed=0, num_stages=topo.num_stages, device=H.dev, topo=topo,
                             dtype=dtype, **own)
        if kind == "train":
            args = Namespace(seq=LM_DATA_SEQ, batch=LM_DATA_BATCH, seed=0)
            step = make_train_step(cfg, topo, ShapeConfig("t", LM_DATA_SEQ, LM_DATA_BATCH,
                                                          "train"), lr=3e-4)
            opt = step.optimizer.init(params)
            losses, step_s, kinds = [], [], set()
            for i in range(2):
                batch = lm_batch(cfg, args, i, H.dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
                kinds.add(str(m["loss"].dtype))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            got = {"losses": losses, "step_s": step_s,
                   "params": grid_digests(torch, params, cfg, topo, **place),
                   "mu": grid_digests(torch, opt.mu, cfg, topo, True, **place),
                   "nu": grid_digests(torch, opt.nu, cfg, topo, True, **place),
                   "dtypes": {"params": leaf_dtypes(params),
                              "moments": leaf_dtypes(opt.mu) | leaf_dtypes(opt.nu),
                              "loss": kinds}}
            del step, opt
        else:
            b, plen = 8, 512
            prompt = torch.from_numpy(token_batch(batch=b, seq=plen, vocab=cfg.vocab_size,
                                                  seed=0)[:, :-1][:, :plen].astype(np.int64))
            gen = generate(cfg, topo, params, prompt.to(H.dev), 16)
            stages = None if grid is None else held_stages(topo, grid.position)
            got = {"tokens": gen.tokens.tolist(), "prefill_s": gen.prefill_s,
                   "decode_s": gen.decode_s,
                   "logits": [bits_digest(torch, gen.prefill_logits),
                              bits_digest(torch, gen.first_decode_logits)],
                   "cache": cache_digests(torch, gen.cache, stages, topo.data,
                                          place.get("replica")),
                   "dtypes": {"params": leaf_dtypes(params), "cache": cache_dtypes(gen.cache),
                              "logits": {str(gen.prefill_logits.dtype),
                                         str(gen.first_decode_logits.dtype)}}}
            del gen
    got.update(note=note, topo=repr(topo), peak=torch.cuda.max_memory_allocated(H.dev) / 1e9)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return got, cap


def lm_data_long(H, torch, grid=None, dtype=None):
    """23d: codeqwen1.5-7b at full width, ``long_context_window`` cut to
    64, one row decoded from an empty ring over positions 0-80 (teacher
    forced; the ring wraps after 64), the ring split over the data axis
    (``Topology.seq_shard``): one process on one card, or this rank; params
    and cache at ``dtype`` (float32 by default). One process also runs the
    windowed prefill the last step is held to."""
    import numpy as np

    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.data.tokens import token_batch
    from repro_torch.models.transformer.model import (
        Topology, held_stages, init_cache, init_params, make_prefill_step, make_serve_step)

    cfg = dataclasses.replace(get_arch("codeqwen1.5-7b", smoke=False),
                              long_context_window=LONG_WINDOW)
    topo = Topology(num_stages=2, num_micro=1, long_context=True, data=2, ring=grid)
    own = {} if grid is None else {"stages": held_stages(topo, grid.position),
                                   "data_rank": grid.replica}
    dtype = torch.float32 if dtype is None else dtype
    params = init_params(cfg, seed=0, num_stages=2, device=H.dev, topo=topo, dtype=dtype, **own)
    shape = ShapeConfig("long", LONG_STEPS, 1, "decode")
    toks = torch.from_numpy(token_batch(batch=1, seq=LONG_STEPS, vocab=cfg.vocab_size, seed=0)[
        :, :LONG_STEPS].astype(np.int32)).to(H.dev)
    cache = init_cache(cfg, topo, shape, dtype=dtype, device=H.dev)
    step = make_serve_step(cfg, topo, shape)
    tokens = []
    with deterministic(torch), torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(LONG_STEPS):
            tok, cache, logits = step(params, cache, {"tokens": toks[:, pos], "pos": pos})
            tokens.append(int(tok[0]))
        torch.cuda.synchronize()
    got = {"tokens": tokens, "logits": bits_digest(torch, logits), "last": logits.cpu(),
           "decode_s": time.perf_counter() - t0, "slots": cache["k"].shape[4],
           "cache": cache_digests(torch, cache, None if grid is None else own["stages"], 2,
                                  None if grid is None else grid.replica, seq=True),
           "dtypes": {"params": leaf_dtypes(params), "cache": cache_dtypes(cache),
                      "logits": {str(logits.dtype)}}}
    del cache, step
    if grid is None:
        wcfg = dataclasses.replace(cfg, window_size=LONG_WINDOW)
        ptopo = Topology(num_stages=2, num_micro=1)
        pshape = ShapeConfig("check", LONG_STEPS, 1, "prefill")
        with torch.inference_mode():
            fresh, _ = make_prefill_step(wcfg, ptopo, pshape)(
                params, init_cache(wcfg, ptopo, pshape, dtype=dtype, device=H.dev),
                {"tokens": toks})
        got["fresh"] = fresh.cpu()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return got


def lm_data_references(H, torch, experts):
    """23a and 23d on one card (``H.dev``), deterministic: every case at the
    grid's Topology with every replica in this process, saved for the rank
    workers with 23c's training cut (``experts``)."""
    refs = {"experts": experts}
    for tag, kind, arch, cut, fields in LM_DATA_CUTS:
        t0 = time.perf_counter()
        got, _ = lm_data_case(H, torch, kind, arch, cut, fields, capture={})
        refs[tag] = got
        what = (f"losses {got['losses']}, steps {got['step_s']} s" if kind == "train" else
                f"tokens[0] {got['tokens'][0]}, prefill {got['prefill_s']:.6f} s, decode "
                f"{got['decode_s'] / 16:.6f} s a token")
        log(f"[lm-data] 23a one card, {tag}{got['note']}, {got['topo']}: {what}; peak "
            f"{got['peak']:.3f} GB; {time.perf_counter() - t0:.1f} s [{H.card}]")
    t0 = time.perf_counter()
    refs["long"] = lm_data_long(H, torch)
    long = refs["long"]
    log(f"[lm-data] 23d one card: codeqwen1.5-7b long_context_window -> {LONG_WINDOW}, "
        f"{LONG_STEPS} steps of one row over {long['slots']} ring slots, 2 replicas in one "
        f"process: {long['decode_s'] / LONG_STEPS * 1e3:.3f} ms a step, tokens "
        f"{long['tokens'][-8:]} (last 8); {time.perf_counter() - t0:.1f} s [{H.card}]")
    torch.save(refs, LM_DATA_DIR / "refs.pt")
    return refs


def lm_data_timing(H, torch):
    """The LM kernels timed on one card at phase 23's launch shapes: flash
    at 23c's arctic prefill micro-batch (a replica's 2 rows of 512) and
    23b's training micro-batch, SSD at 23a's zamba2 training call."""
    timing = {
        "flash_attention_kernel": time_flash(
            H, torch, "one arctic-480b data-axis prefill launch (2 x 512 tokens, GQA 56/8, hd "
            "128, causal, fp32)", *flash_inputs(H, 2, 512, 56, 8, 128)),
        "ssd_kernel": time_ssd(
            H, torch, "one zamba2 data-axis training call (2 x 256 tokens, 112 heads, P 64, N "
            "64, chunk 128)", *ssd_inputs(H, 2, 256, 112, 64, 64)),
    }
    time_flash(H, torch, "one codeqwen data-axis training launch (2 x 256 tokens, 32 heads, hd "
               "128, causal, fp32)", *flash_inputs(H, 2, 256, 32, 32, 128))
    for name, record in timing.items():
        H.timing.setdefault(name, record)


def data_state_gb(cfg, topo, position, train, dtype=None):
    """The GB a rank at ring ``position`` holds before any activation on a
    data axis of ``topo.data``: its stage rows of its shard of every split
    leaf and every whole leaf, params at ``dtype`` (float32 by default, leaf
    by leaf as ``init_params`` makes them), and when training the gradients
    at the params' dtype and Adam's two float32 moments (``moment_specs``:
    the ``embed``/``head`` moments split too)."""
    import torch

    from repro_torch.models.transformer.model import abstract_params, held_stages, leaf_layout
    from repro_torch.train.optimizer import tree_leaves

    meta = abstract_params(cfg, topo.num_stages, torch.float32 if dtype is None else dtype)
    layout = leaf_layout(cfg, topo)
    share = len(held_stages(topo, position)) / topo.num_stages
    n = 0.0
    for key, tree in meta.items():
        for a, dp, dm in zip(tree_leaves(tree), tree_leaves(layout.params[key]),
                             tree_leaves(layout.moments[key])):
            rows = a.numel() * (share if key == "blocks" else 1)
            p = rows / (topo.data if dp is not None else 1)
            m = rows / (topo.data if dm is not None else 1)
            n += state_bytes(a, p, train, m)
    return n / 1e9


def lm_data_moe_experts(H, choices=LM_DATA_MOE_EXPERTS, dtype=None, tag="23c"):
    """23c's (25d's at ``dtype`` bf16) training cut: the most experts (of
    ``choices``) whose predicted per-rank state fits ``LM_DATA_MOE_FIT`` of
    the card."""
    from repro_torch.configs import get_arch

    arch, cut = LM_DATA_MOE
    preds = {}
    for e in choices:
        cfg, _ = cut_config(get_arch(arch, smoke=False), {**cut, "num_experts": e})
        preds[e] = max(data_state_gb(cfg, lm_data_topology({}), d, True, dtype) for d in range(2))
    pick = next((e for e in choices if preds[e] <= LM_DATA_MOE_FIT * CARD_BYTES / 1e9), None)
    log(f"[lm-data] {tag} {arch} training, 2 layers, dp 2 x D 2: predicted "
        f"{'fp32' if dtype is None else str(dtype)[6:]} params and gradients, float32 Adam "
        f"moments per rank " + ", ".join(f"{e} experts {g:.3f} GB" for e, g in preds.items())
        + f"; the widest within {LM_DATA_MOE_FIT} of the card's {CARD_BYTES / 1e9:.0f} GB: "
        f"{pick} [{H.card}]")
    if pick is None:
        raise AssertionError(f"{tag}: no expert cut of {choices} fits")
    return pick


def lm_data_predictions(H):
    """Each full-width leg's per-rank state against the card's memory,
    printed before the run (a leg that cannot fit stops here)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer.model import Topology

    legs = (("23b", LM_DATA_FULL_TRAIN[0], {}, True),
            ("23c serve", LM_DATA_MOE[0], LM_DATA_MOE[1], False),
            ("23d", "codeqwen1.5-7b", {}, False),
            ("23e serve", "codeqwen1.5-7b", {}, False))
    for leg, arch, cut, train in legs:
        cfg, note = cut_config(get_arch(arch, smoke=False), cut)
        topo = Topology(num_stages=2, num_micro=LM_DATA_MICRO, data=2)
        gbs = [data_state_gb(cfg, topo, d, train) for d in range(2)]
        log(f"[lm-data] {leg} {arch}{note}, dp 2 x D 2: fp32 "
            f"{'params, gradients and Adam moments' if train else 'weights'} per rank "
            + ", ".join(f"{g:.3f}" for g in gbs) + f" GB of the card's {CARD_BYTES / 1e9:.0f} "
            f"[{H.card}]")
        if max(gbs) > 0.9 * CARD_BYTES / 1e9:
            raise AssertionError(f"{leg}: a rank's state {max(gbs):.1f} GB would not fit")


def lm_data_cli(H, torch):
    """23e: ``torchrun --nproc-per-node 4`` of both LM launchers with
    ``--stages 2`` (2 data replicas), started together as a user starts
    them: one result dict each, from rank 0."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={LM_DATA_CARDS}", *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for argv in LM_DATA_CLI]
    outs = []
    try:
        for argv, proc in zip(LM_DATA_CLI, procs):
            out, _ = proc.communicate(timeout=RANK_LAUNCH_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"torchrun {' '.join(argv[:2])}: exit {proc.returncode}\n"
                                     f"{out[-6000:]}")
            dicts = [ast.literal_eval(line) for line in out.splitlines()
                     if line.startswith("{'arch'")]
            if len(dicts) != 1 or dicts[0].get("ranks") != LM_DATA_CARDS \
                    or dicts[0].get("data_parallel") != 2:
                raise AssertionError(f"torchrun {' '.join(argv[:2])}: {len(dicts)} result "
                                     f"dicts\n{out[-6000:]}")
            outs.append(dicts[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    served, trained = outs
    if not all(math.isfinite(x) for x in trained["losses"]):
        raise AssertionError(f"torchrun train: losses {trained['losses']}")
    log(f"[lm-data] 23e torchrun -m repro_torch.launch.serve (codeqwen1.5-7b, 32 layers) and -m "
        f"repro_torch.launch.train --mode lm (mamba2-130m), each --stages 2 on 4 ranks (2 data "
        f"replicas), together {time.perf_counter() - t0:.1f} s: serve prefill_s "
        f"{served['prefill_s']}, decode_s_per_tok {served['decode_s_per_tok']}, tokens_per_s "
        f"{served['tokens_per_s']}, sample {served['sample']}, peak per rank "
        f"{served['peak_mem_gb_per_rank']}; train losses {trained['losses']}, avg step "
        f"{trained['avg_step_s']}, peak per rank {trained['peak_mem_gb_per_rank']} [{H.card}]")


def phase_lm_data(H, torch):
    """Phase 23: the LM data axis on four cards, 2 replicas of a 2-position
    ring. 23a cut-depth cases bit for bit on every rank against one card's
    ``Topology(data=2)``; 23b codeqwen1.5-7b trained at its 32 layers with
    ZeRO-3; 23c arctic-480b served with all 128 experts, then trained on a
    cut; 23d the sequence-sharded long-context decode; 23f each rank's
    codeqwen step cut to 8 layers counted on its card on the dp 2 x D 2 and
    the pods 2 x D 2 grids, held against meta; 23e both LM launchers under
    torchrun. Returns what did not run, having printed it ("" when all of
    it ran)."""
    n = torch.cuda.device_count()
    if n < LM_DATA_CARDS:
        log(f"[lm-data] not run: {PHASE23_SKIP} (this machine has {n})")
        return f"phase 23 not run ({PHASE23_SKIP})"
    shutil.rmtree(LM_DATA_DIR, ignore_errors=True)
    LM_DATA_DIR.mkdir(parents=True)
    lm_data_predictions(H)
    lm_data_references(H, torch, lm_data_moe_experts(H))
    lm_data_timing(H, torch)
    gc.collect()
    torch.cuda.empty_cache()
    reports = run_rank_worker(H, torch, LM_DATA_CARDS, "lmdata")
    lm_data_counts(H, torch, reports)
    lm_data_cli(H, torch)
    return ""


# ---------------------------------------------- phase 23: the rank worker --


def worker_lm_data_cut(H, torch, rl, refs, grid):
    """23a on this rank: each cut case on the grid, bit for bit against the
    one-card case of ``refs``: the losses, this rank's rows and shards of
    the params and of Adam's moments (digests), the tokens and logits; this
    rank's kernel calls held against the plain version."""
    for tag, kind, arch, cut, fields in LM_DATA_CUTS:
        got, cap = lm_data_case(H, torch, kind, arch, cut, fields, grid)
        keys = ("losses", "params", "mu", "nu") if kind == "train" else ("tokens", "logits")
        held_bit_for_bit(f"23a {tag} rank {rl.rank}", got, refs[tag], keys)
        rl.launched(cap.launches)
        cap.compare(H, torch, f"23a {tag} rank {rl.rank}")
        leaves = len(got["params"]) if kind == "train" else 0
        rl.line(f"23a {tag}{got['note']}, {got['topo']}: "
                + (f"losses {got['losses']}, {leaves} row and shard digests of params, mu and "
                   f"nu, steps {got['step_s']} s" if kind == "train" else
                   f"tokens {len(got['tokens'])} x {len(got['tokens'][0])}, prefill and first "
                   f"decode logits, prefill {got['prefill_s']:.6f} s")
                + f" bit-identical to one card; peak {got['peak']:.3f} GB; launches "
                f"{cap.launches} [{H.card}]")


def worker_lm_data_long(H, torch, rl, refs, grid):
    """23d on this rank: the tokens and the last logits bit for bit against
    one card's two replicas, the last step within 1e-3 of the windowed
    prefill's."""
    got = lm_data_long(H, torch, grid)
    want = refs["long"]
    if got["tokens"] != want["tokens"] or got["logits"] != want["logits"]:
        raise AssertionError(f"23d rank {rl.rank}: tokens or logits not bit-identical to one "
                             f"card ({got['tokens'][-4:]} vs {want['tokens'][-4:]})")
    err = float((got["last"] - want["fresh"]).abs().max())
    if not err <= DECODE_VS_PREFILL_ATOL:
        raise AssertionError(f"23d rank {rl.rank}: the decode at position {LONG_STEPS - 1} is "
                             f"{err:.3g} from the windowed prefill")
    rl.line(f"23d codeqwen1.5-7b full width, long_context_window -> {LONG_WINDOW}, {LONG_STEPS} "
            f"steps of one row, {got['slots']} of the ring's {2 * got['slots']} slots on this "
            f"rank: tokens and last logits bit-identical to one card; the last step vs the "
            f"windowed {LONG_STEPS}-row prefill: max |logit diff| {err:.6g} (limit "
            f"{DECODE_VS_PREFILL_ATOL}); {got['decode_s'] / LONG_STEPS * 1e3:.3f} ms a step "
            f"[{H.card}]")


def worker_lm_data_train_full(H, torch, rl, dtype=None):
    """23b (25d at ``dtype`` bf16) on this rank: codeqwen1.5-7b at its 32
    layers, 16 a ring position, ZeRO-3 over 2 replicas: losses finite and
    every rank's alike, this rank's flash launches (forward and recompute
    of its 16 layers x 2 micro-batches a step), the median step, peak and
    tokens/s, one traced step per rank."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.core.overlap_report import capture_rank_reports
    from repro_torch.launch.train import build_parser, lm_batch, train_lm
    from repro_torch.models.transformer.model import held_stages

    bf16 = dtype is not None and dtype != torch.float32
    tag = "25d" if bf16 else "23b"
    arch, flags = LM_DATA_FULL_TRAIN
    args = build_parser().parse_args([*LM_DATA_TRAIN, "--arch", arch, *flags])
    cfg = get_arch(arch, smoke=not args.full_arch)
    held = []
    with KernelCapture({"flash_attention_kernel": LM_RING_CAPTURE}) as cap:
        trained = train_lm(cfg, args, dtype=dtype, on_step=lambda i, *_: held.append(
            torch.cuda.memory_allocated(H.dev) if H.dev.type == "cuda" else 0))
    topo = trained.topo
    mine = active_slots(cfg, topo.num_stages, held_stages(topo, topo.ring.position))
    want = {k: 2 * n * args.chunks * args.steps for k, n in mine.items()}
    if cap.launches != want:
        raise AssertionError(f"{tag} rank {rl.rank}: launches {cap.launches}, want {want}")
    losses = trained.losses
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, losses)
    if not all(map(math.isfinite, losses)) or any(x != losses for x in every):
        raise AssertionError(f"{tag} rank {rl.rank}: losses {every}")
    held_launches(H, torch, rl, cap, f"{tag} rank {rl.rank}", bf16)
    median = statistics.median(trained.step_s[1:])
    peak = trained.summary["peak_mem_gb"]
    batch = lm_batch(cfg, args, args.steps, H.dev)
    reports = capture_rank_reports(
        lambda: trained.step(trained.params, trained.opt_state, batch))
    rl.data[tag] = {"median_s": median, "peak_gb": peak, "losses": losses,
                    "per_rank_peak": trained.summary["peak_mem_gb_per_rank"]}
    reckoned = held_beside_reckoning(cfg, topo, topo.ring.position, dtype, held[0])
    rl.line(f"{tag} {arch} full width, {cfg.num_layers} layers, "
            f"{'bf16 params (ZeRO-3 gathers 2 bytes a value), ' if bf16 else ''}"
            f"{trained.topo}: losses {losses} "
            f"(every rank alike); step s {trained.step_s}; median after the first {median:.6f} "
            f"s, {args.batch * args.seq / median:.1f} tokens/s; peak {peak} GB; {reckoned}; "
            f"launches {cap.launches}{f'; beside {FP32_23B}' if bf16 else ''} [{H.card}]")
    rank_report_lines(H, rl, f"{tag} one train step", reports)
    del trained, batch
    gc.collect()
    torch.cuda.empty_cache()


def worker_lm_data_count(H, torch, rl, grid, dtype=None):
    """23f (25e at ``dtype`` bf16) on this rank: codeqwen1.5-7b at full
    width, cut to 8 layers, one train step on the card under ``OpCounter``
    (``dryrun.build_step``: seed-0 params, this rank's shard) on the dp 2 x
    D 2 grid and on a pods 2 x D 2 grid of the same ranks; its counts and
    its peak increment over the step's entry beside the allocator's, for
    the parent to hold against meta."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.core import ranks
    from repro_torch.launch.dryrun import build_step, count_step

    dtype = torch.float32 if dtype is None else dtype
    tag = "23f" if dtype == torch.float32 else "25e"
    key = "flash_attention_kernel" if dtype == torch.float32 else BF16_KEYS[
        "flash_attention_kernel"]
    arch, cut = LM_DATA_COUNT
    cfg, _ = cut_config(get_arch(arch), cut)
    shape = ShapeConfig("23f", LM_DATA_SEQ, LM_DATA_BATCH, "train")
    flash = H.FK.flash_attention_kernel
    out = {}
    for label, grid_shape in LM_DATA_COUNT_GRIDS:
        pods, data, D = grid_shape
        g = grid if pods == 1 else ranks.RankGrid(data, D, pods=pods)
        topo = count_topology(grid_shape, g)
        step, inputs = build_step(cfg, shape, topo, device=H.dev, dtype=dtype)
        torch.cuda.synchronize()
        before, wgmma_before = flash.launches, flash.wgmma_launches
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        card = count_step(step, inputs)
        torch.cuda.synchronize()
        count_s = time.perf_counter() - t0
        card_inc = torch.cuda.max_memory_allocated() - held
        counted_inc = card.peak_bytes - card.entry_bytes
        launched = flash.launches - before
        if H.dev.type == "cuda" and launched != card.kernel_calls.get("flash_attention_kernel", 0):
            raise AssertionError(f"{tag} {label} rank {rl.rank}: the counter saw "
                                 f"{dict(card.kernel_calls)}, flash launched {launched}")
        rl.launched({key: launched})
        if dtype == torch.bfloat16:
            wgmma = flash.wgmma_launches - wgmma_before
            count_wgmma(H, f"{tag} {label} rank {rl.rank}", launched, wgmma)
            rl.launched({WGMMA_KEY: wgmma})
        place = f"pod {g.pod}, replica {g.replica}, position {g.position}"
        out[label] = {"counts": counts_of(card), "ratio": counted_inc / card_inc,
                      "counted_gb": counted_inc / 1e9, "card_gb": card_inc / 1e9,
                      "count_s": count_s, "place": place}
        rl.line(f"{tag} {label}, {place}, {str(dtype)[6:]} params: one step counted on the card "
                f"in {count_s:.3f} s, flash launches {launched}, collectives "
                f"{ {k: v for k, v in card.collectives.items() if v} } [{H.card}]")
        del step, inputs, card
        gc.collect()
        torch.cuda.empty_cache()
    rl.data["count"] = out


def worker_lm_data_moe(H, torch, rl, experts, dtype=None):
    """23c (25d at ``dtype`` bf16) on this rank: arctic-480b cut to 2
    layers, one a ring position, served with all 128 experts (64 a rank),
    every expert taking all of a call's tokens (``no_expert_drops``: the
    second layer's cache depends on the first's MoE): the prefill's flash
    launches, the first decode's logits within 1e-3 (bf16: within
    ``BF16_DECODE_FRAC`` of the largest |logit|) of a fresh prefill's that
    drops no token (and the gap to one at the reference's capacity); then
    trained 2 steps with ``experts`` experts."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import serve as serve_lm
    from repro_torch.launch import train as train_launch
    from repro_torch.models.transformer.model import (
        _prefill, held_stages, init_cache, make_extras)

    bf16 = dtype is not None and dtype != torch.float32
    tag = "25d" if bf16 else "23c"
    arch, cut = LM_DATA_MOE
    args = serve_lm.build_parser().parse_args(["--arch", arch, *LM_SERVE_ARGS, "--stages", "2"])
    cfg, note = cut_config(get_arch(arch, smoke=False), cut)
    # 2 layers: the second's cache depends on the first's MoE, so the run
    # takes every token at every expert, as the prefill it is held to does
    with no_expert_drops(), KernelCapture({"flash_attention_kernel": LM_RING_CAPTURE}) as cap:
        served = serve_lm.serve(args, cfg, dtype=dtype if bf16 else torch.float32)
    topo, gen = served.topo, served.generation
    mine = active_slots(cfg, topo.num_stages, held_stages(topo, topo.ring.position))
    want = {k: n * args.chunks for k, n in mine.items()}
    if cap.launches != want:
        raise AssertionError(f"{tag} rank {rl.rank}: launches {cap.launches}, want {want}")
    held_launches(H, torch, rl, cap, f"{tag} serve rank {rl.rank}", bf16)
    b, plen = served.prompt.shape[0], served.prompt_len
    tok0 = torch.from_numpy(gen.tokens[:, 0]).to(H.dev, torch.int64)
    longer = {"tokens": torch.cat([served.prompt, tok0[:, None]], dim=1)}
    shape = ShapeConfig("check", plen + 1, b, "prefill")

    def fresh():
        with torch.inference_mode():
            return _prefill(cfg, topo, make_extras(cfg, topo.num_stages), served.params,
                            init_cache(cfg, topo, shape, device=H.dev,
                                       dtype=served.params["embed"].dtype),
                            longer, plen + 1)[0]

    with no_expert_drops():
        whole = fresh()
    dropping = fresh()
    err = float((gen.first_decode_logits - whole).abs().max())
    gap = float((gen.first_decode_logits - dropping).abs().max())
    scale = float(whole.abs().max())
    limit = BF16_DECODE_FRAC * scale if bf16 else DECODE_VS_PREFILL_ATOL
    if not err <= limit:
        raise AssertionError(f"{tag} rank {rl.rank}: decode at position {plen} {err:.3g} from a "
                             f"fresh {plen + 1}-row prefill that drops no token (limit "
                             f"{limit:.4g})")
    summary = served.summary
    rl.data[f"{tag} serve"] = {k: summary[k] for k in ("prefill_s", "decode_s_per_tok",
                                                       "tokens_per_s", "peak_mem_gb", "params")}
    rl.line(f"{tag} {arch} full width{note}, all {cfg.num_experts} experts "
            f"({cfg.num_experts // 2} a rank) taking every token, "
            f"{'bf16 params, ' if bf16 else ''}{topo}: prefill_s {summary['prefill_s']}, "
            f"decode_s_per_tok {summary['decode_s_per_tok']}, tokens_per_s "
            f"{summary['tokens_per_s']}, peak {summary['peak_mem_gb']} GB; decode vs a fresh "
            f"{plen + 1}-row prefill dropping no token: max |logit diff| {err:.6g} "
            + (f"= {err / scale:.5f} of the largest |logit| {scale:.6g} (limit "
               f"{BF16_DECODE_FRAC})" if bf16 else f"(limit {DECODE_VS_PREFILL_ATOL})")
            + f"; vs one at the reference's capacity {gap:.6g}; launches {cap.launches} "
            f"[{H.card}]")
    del served, gen, whole, dropping
    gc.collect()
    torch.cuda.empty_cache()
    targs = train_launch.build_parser().parse_args(
        [*LM_DATA_TRAIN, "--arch", arch, "--stages", "2", "--steps", "2"])
    tcfg, tnote = cut_config(get_arch(arch, smoke=False), {**cut, "num_experts": experts})
    held = []
    with KernelCapture({"flash_attention_kernel": LM_RING_CAPTURE}) as cap:
        trained = train_launch.train_lm(tcfg, targs, dtype=dtype, on_step=lambda i, *_: held.append(
            torch.cuda.memory_allocated(H.dev) if H.dev.type == "cuda" else 0))
    want = {k: 2 * n * targs.chunks * targs.steps for k, n in mine.items()}
    if cap.launches != want or not all(map(math.isfinite, trained.losses)):
        raise AssertionError(f"{tag} rank {rl.rank}: launches {cap.launches} (want {want}), "
                             f"losses {trained.losses}")
    held_launches(H, torch, rl, cap, f"{tag} train rank {rl.rank}", bf16)
    reckoned = held_beside_reckoning(tcfg, trained.topo, trained.topo.ring.position,
                                     dtype, held[0])
    rl.data[f"{tag} train"] = {"step_s": trained.step_s,
                               "peak_gb": trained.summary["peak_mem_gb"]}
    rl.line(f"{tag} {arch} trained{tnote} ({experts // 2} experts a rank), "
            f"{'bf16 params, ' if bf16 else ''}{trained.topo}: losses {trained.losses}, step s "
            f"{trained.step_s}, peak {trained.summary['peak_mem_gb']} GB; {reckoned}; launches "
            f"{cap.launches} [{H.card}]")
    del trained
    gc.collect()
    torch.cuda.empty_cache()


def held_beside_reckoning(cfg, topo, position, dtype, held_bytes):
    """What the card held after a rank's first train step (params and
    Adam's moments; the step's gradients freed) beside the reckoning
    (``data_state_gb``, or ``state_gb`` on a ring of one replica)."""
    reckon = data_state_gb if topo.data > 1 else state_gb
    total = reckon(cfg, topo, position, True, dtype)
    params = reckon(cfg, topo, position, False, dtype)
    return (f"memory_allocated after step 0 {held_bytes / 1e9:.3f} GB beside the reckoning's "
            f"params and moments {total - params:.3f} GB (params, gradients and moments "
            f"{total:.3f} GB)")


# ------------------------------------------- the reference's dtype (phase 24) --

# 24a: the bf16 prefill's logits against the float32 step's from the same
# weights upcast, and the bf16 decode's against a fresh bf16 prefill, each
# as a share of the largest |logit| of the float32 (fresh) logits; the fp32
# decode limit stays DECODE_VS_PREFILL_ATOL. bf16's rounding grows with
# depth and width: at codeqwen1.5-7b's full width the prefill's gap to the
# float32 step was 0.067 (PERF.md), where the CPU tests hold the port's bf16
# logits within 0.02 of the reference's bf16 ones at smoke size
BF16_VS_FP32_FRAC = 0.10
BF16_DECODE_FRAC = 0.10
BF16_ULPS = 1.0  # the bf16 instances against their plain version (kernels.bf16_ulps)
BF16_KEYS = {"flash_attention_kernel": "flash_attention_kernel bf16",
             "ssd_kernel": "ssd_kernel bf16"}
# the bf16 flash launches of phases 24 and 25 that took the wgmma instances
# (``kernel.route``): every one must
WGMMA_KEY = "flash_attention_kernel bf16 wgmma"
BF16_TRAIN = ["--seq", "256", "--batch", "8", "--lr", "3e-4"]  # phase 16's run_lm defaults


def held_bf16(H, name, label, got, want, shape):
    """A bf16 kernel output against its plain version's, rounded to bf16:
    at most ``BF16_ULPS`` apart (``kernels.bf16_ulps``); also prints how many
    values are more than one ulp apart by the strict count, at the value's
    own ulp, and the largest |value| among them."""
    from repro_torch.kernels import bf16_ulps

    t = H.torch
    key = BF16_KEYS[name]
    if got.dtype != t.bfloat16 or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)}, want bf16 "
                             f"{tuple(want.shape)}")
    ulps = bf16_ulps(got, want)
    worst = float(ulps.max()) if ulps.numel() else 0.0
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    mag = want.double().abs()
    strict = diff > t.exp2(t.floor(t.log2(mag.clamp(min=t.finfo(t.bfloat16).tiny))) - 7)
    n_strict = int(strict.sum())
    at = float(mag[strict].max()) if n_strict else 0.0
    if not worst <= BF16_ULPS:
        raise AssertionError(f"{label}: {worst:.3f} bf16 ulps from the plain version "
                             f"(limit {BF16_ULPS})")
    H.err[key] = max(H.err.get(key, 0.0), err)
    H.used[key] = max(H.used.get(key, 0.0), worst / BF16_ULPS)
    log(f"[bf16] {name:21s} {label:46s} {shape} {worst:.3f} ulps (limit {BF16_ULPS}), "
        f"max|err| {err:.3g}; {n_strict} of {got.numel()} values over one ulp at their own "
        f"magnitude, the largest |value| among them {at:.3g} (of {float(mag.max()):.3g})")


def compare_bf16_flash(H, label, q, k, v, out=None, **kw):
    """The flash kernel's bf16 instance (``out``, else launched here)
    against the plain version on the same bf16 inputs."""
    from repro_torch.kernels.flash.ref import flash_attention_ref

    got = H.FK.flash_attention_kernel(q, k, v, **kw) if out is None else out
    want = flash_attention_ref(q, k, v, **kw)
    b, s, h, hd = q.shape
    held_bf16(H, "flash_attention_kernel", label, got, want,
              f"B={b} S={s:4d} H={h:3d} KV={k.shape[2]:3d} hd={hd:3d} hd_v={v.shape[-1]:3d}")


def compare_bf16_ssd(H, label, x, dt, loga, B, C, chunk, out=None):
    """The SSD kernel on bf16 x, B, C (``out``, else launched here): y
    against the plain version's float32 result on the same values rounded
    to bf16, the float32 final state at ``SSD_ATOL``."""
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan

    y, state = H.DK.ssd_kernel(x, dt, loga, B, C, chunk=chunk) if out is None else out
    want_y, want_state = ssd_chunk_scan(x.float(), dt, loga, B.float(), C.float(), chunk=chunk)
    b, s, h, p = x.shape
    shape = f"b={b} S={s:4d} h={h:3d} P={p:3d} N={B.shape[-1]:3d} chunk={chunk:3d}"
    held_bf16(H, "ssd_kernel", f"{label} y", y, want_y.to(H.torch.bfloat16), shape)
    err = float((state - want_state).abs().max())
    if state.dtype != H.torch.float32 or not err <= SSD_ATOL:
        raise AssertionError(f"{label}: final state {state.dtype}, max |err| {err:.3g} (limit "
                             f"{SSD_ATOL})")


def compare_bf16_calls(H, cap, label):
    """Every call ``cap`` kept, held on its own inputs (``compare_bf16_*``)."""
    for name, calls in cap.captured.items():
        for i, (a, kw, out) in enumerate(calls):
            if name == "flash_attention_kernel":
                args = {k: kw[k] for k in ("window", "softcap", "q_pos", "kv_pos") if k in kw}
                compare_bf16_flash(H, f"{label} call {i:3d}", *a, out=out, **args)
            else:
                compare_bf16_ssd(H, f"{label} call {i:3d}", *a, kw["chunk"], out=out)
    cap.captured = {}


def count_bf16(H, cap, want, what):
    """Hold the wrappers' launches in ``cap`` to ``want`` ({kernel: n}) and
    add them to the bf16 instances' main-path counts; every flash launch
    must have taken the wgmma instances (``count_wgmma``)."""
    for name, n in want.items():
        if cap.launches[name] != n:
            raise AssertionError(f"{what}: {name} launched {cap.launches[name]} times, want {n}")
        H.launches[BF16_KEYS[name]] = H.launches.get(BF16_KEYS[name], 0) + n
        if name == "flash_attention_kernel":
            count_wgmma(H, what, n, cap.wgmma[name])


def count_wgmma(H, what, launched, wgmma):
    """Hold the ``wgmma`` launches (bf16 flash on the wgmma instances) to
    all ``launched`` bf16 flash launches of a main path, and count them."""
    if wgmma != launched:
        raise AssertionError(f"{what}: {launched} bf16 flash launches, {wgmma} of them on the "
                             "wgmma instances; every one must take them")
    H.launches[WGMMA_KEY] = H.launches.get(WGMMA_KEY, 0) + wgmma


def bf16_prompt(torch, cfg, args, dev):
    """``serve``'s prompt (and frontend rows) for ``args``, the rows bf16."""
    from repro_torch.data.tokens import frontend_embeds, token_batch
    from repro_torch.models.transformer.model import frontend_rows

    s_front = frontend_rows(cfg, args.prompt_len)
    n_text = args.prompt_len - s_front
    prompt = torch.from_numpy(token_batch(batch=args.batch, seq=n_text, vocab=cfg.vocab_size,
                                          seed=args.seed)[:, :-1][:, :n_text].astype("int64"))
    front = torch.from_numpy(frontend_embeds(batch=args.batch, seq=s_front, d_model=cfg.d_model,
                                             seed=args.seed)).to(dev, torch.bfloat16) \
        if s_front else None
    return prompt.to(dev), front


def serve_bf16(H, torch, tag, arch, *, cut=None, decode=True, fp32_check=False):
    """Serve ``arch`` at full width (fields ``cut``) from bf16 params
    (``init_params(dtype=torch.bfloat16)``) through ``launch.serve.generate``
    at phase 8's flags: caches bf16 (Mamba's ``ssm`` state float32), every
    kernel launched once per active slot and micro-batch in the prefill, its
    bf16 instance held on each slot's own inputs from micro-batch 0; with
    ``decode``, the first decode step's logits against a fresh bf16 prefill
    of one row more within ``BF16_DECODE_FRAC``; with ``fp32_check``, the
    prefill's logits against the float32 step's from the same weights
    upcast (TF32 off) within ``BF16_VS_FP32_FRAC``."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.serve import build_parser, generate
    from repro_torch.models.transformer.model import (
        Topology, _prefill, init_cache, init_params, make_extras, make_prefill_step)
    from repro_torch.train.optimizer import tree_leaves, tree_map

    t_phase = time.perf_counter()
    args = build_parser().parse_args(["--arch", arch, *LM_SERVE_ARGS])
    cfg, cut_note = cut_config(get_arch(arch), cut)
    topo = Topology(num_stages=1, num_micro=args.chunks)
    slots = active_slots(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=args.seed, device=H.dev, dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in tree_leaves(params))
    prompt, front = bf16_prompt(torch, cfg, args, H.dev)
    steps = args.decode_steps if decode else 0
    with KernelCapture(slots) as cap:
        gen = generate(cfg, topo, params, prompt, steps, front)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    count_bf16(H, cap, {name: n * args.chunks for name, n in slots.items()}, f"{tag} {arch}")
    kinds = {str(a.dtype) for a in tree_leaves(gen.cache)}
    want_kinds = {"torch.bfloat16"} | ({"torch.float32"} if "ssd_kernel" in slots else set())
    if kinds != want_kinds:
        raise AssertionError(f"{tag} {arch}: cache dtypes {kinds}, want {want_kinds}")
    for logits in (gen.prefill_logits, gen.first_decode_logits) if decode else \
            (gen.prefill_logits,):
        if logits.dtype != torch.float32 or not bool(logits.isfinite().all()):
            raise AssertionError(f"{tag} {arch}: logits {logits.dtype} or non-finite")
    compare_bf16_calls(H, cap, f"{tag} {arch} prefill mb 0")

    b, plen = prompt.shape[0], prompt.shape[1] + (0 if front is None else front.shape[1])
    batch = {"tokens": prompt} if front is None else {"tokens": prompt, "frontend_embeds": front}
    notes = []
    if fp32_check:
        params32 = tree_map(lambda p: p.float(), params)
        pshape = ShapeConfig("fp32", plen, b, "prefill")
        with torch.inference_mode():
            logits32, _ = make_prefill_step(cfg, topo, pshape)(
                params32, init_cache(cfg, topo, pshape, device=H.dev), batch)
        torch.cuda.synchronize()
        del params32
        scale = float(logits32.abs().max())
        err = float((gen.prefill_logits - logits32).abs().max())
        agree = int((gen.prefill_logits.argmax(-1) == logits32.argmax(-1)).sum())
        if not err <= BF16_VS_FP32_FRAC * scale:
            raise AssertionError(f"{tag} {arch}: bf16 prefill logits {err:.4g} from the fp32 "
                                 f"step's (limit {BF16_VS_FP32_FRAC} x {scale:.4g})")
        notes.append(f"prefill vs the fp32 step from the same weights upcast: max |logit diff| "
                     f"{err:.6g} = {err / scale:.5f} of the largest |logit| {scale:.6g} (limit "
                     f"{BF16_VS_FP32_FRAC}), argmax agree {agree}/{b}")
    if decode:
        tok0 = torch.from_numpy(gen.tokens[:, 0]).to(H.dev, torch.int64)
        longer = dict(batch, tokens=torch.cat([prompt, tok0[:, None]], dim=1))
        shape = ShapeConfig("check", plen + 1, b, "prefill")
        with torch.inference_mode():
            fresh, _ = _prefill(cfg, topo, make_extras(cfg, 1), params,
                                init_cache(cfg, topo, shape, dtype=torch.bfloat16, device=H.dev),
                                longer, plen + 1)
        torch.cuda.synchronize()
        scale = float(fresh.abs().max())
        err = float((gen.first_decode_logits - fresh).abs().max())
        agree = int((gen.first_decode_logits.argmax(-1) == fresh.argmax(-1)).sum())
        if not err <= BF16_DECODE_FRAC * scale:
            raise AssertionError(f"{tag} {arch}: bf16 decode at position {plen} {err:.4g} from "
                                 f"a fresh prefill (limit {BF16_DECODE_FRAC} x {scale:.4g})")
        notes.append(f"decode vs a fresh bf16 {plen + 1}-row prefill: max |logit diff| "
                     f"{err:.6g} = {err / scale:.5f} of the largest |logit| {scale:.6g} (limit "
                     f"{BF16_DECODE_FRAC}), argmax agree {agree}/{b}")
    n_tokens = int(gen.tokens.size)
    launched = ", ".join(f"{name} bf16 {n * args.chunks}" for name, n in slots.items())
    timing = f"prefill_s {gen.prefill_s:.6f}"
    if steps:
        timing += (f", decode ms a token {gen.decode_s / steps * 1e3:.6f}, tokens_per_s "
                   f"{n_tokens / (gen.prefill_s + gen.decode_s):.3f}")
    log(f"[bf16] {tag} {arch} served full width{cut_note} ({n_params} params, bf16), batch {b}, "
        f"prompt {plen}, {steps} decode steps, {args.chunks} micro-batches: {timing}, "
        f"peak_mem_gb {peak:.6f}; prefill launches {launched}"
        + "".join(f"; {note}" for note in notes)
        + f"; phase {time.perf_counter() - t_phase:.1f} s [{H.card}]")
    del params, gen
    gc.collect()
    torch.cuda.empty_cache()


def bf16_train_run(torch, cfg, topo, params, args, steps, on_step=None):
    """``steps`` train steps (``make_train_step``, lr ``args.lr``) from
    ``params`` on ``args``' batches: (losses, step seconds, params, the
    step, Adam's state)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.train import lm_batch
    from repro_torch.models.transformer.model import make_train_step

    step = make_train_step(cfg, topo, ShapeConfig("bf16", args.seq, args.batch, "train"),
                           lr=args.lr)
    opt = step.optimizer.init(params)
    losses, times = [], []
    for i in range(steps):
        batch = lm_batch(cfg, args, i, params["embed"].device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(i)
    return losses, times, params, step, opt


def train_bf16(H, torch, tag, arch, stages, steps, *, cut=None):
    """Train ``arch`` at full width (fields ``cut``) from bf16 params with
    float32 Adam moments, ``stages`` stages of 2 micro-batches at phase
    16's flags: every kernel launched twice (forward and recompute) per
    active slot, micro-batch and step, the first forward's calls held on
    their own inputs, losses and the last update's params finite; the
    median step, tokens/s, peak, and the model FLOPs over the median step as
    a share of the bf16 peak."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.train import build_parser
    from repro_torch.models.transformer.model import Topology, init_params
    from repro_torch.roofline import model_flops
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    args = build_parser().parse_args(["--mode", "lm", "--arch", arch, *BF16_TRAIN])
    cfg, cut_note = cut_config(get_arch(arch), cut)
    topo = Topology(num_stages=stages, num_micro=2, loss_chunks=4)
    first = {name: n * 2 for name, n in active_slots(cfg, stages).items()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=args.seed, num_stages=stages, device=H.dev,
                         dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in tree_leaves(params))
    with KernelCapture(first) as cap:
        losses, times, params, step, opt = bf16_train_run(torch, cfg, topo, params, args, steps)
    peak = torch.cuda.max_memory_allocated() / 1e9
    count_bf16(H, cap, {name: 2 * n * steps for name, n in first.items()}, f"{tag} {arch}")
    if not all(map(math.isfinite, losses)) or not all(
            bool(p.isfinite().all()) for p in tree_leaves(params)):
        raise AssertionError(f"{tag} {arch}: losses {losses} or the last update non-finite")
    kinds = ({str(p.dtype) for p in tree_leaves(params)},
             {str(m.dtype) for m in tree_leaves(opt.mu)})
    compare_bf16_calls(H, cap, f"{tag} {arch} train step 0 forward")
    median = statistics.median(times[1:])
    flops = model_flops(cfg, ShapeConfig("t", args.seq, args.batch, "train"), training=True)
    log(f"[bf16] {tag} {arch} trained full width{cut_note} ({n_params} params bf16, Adam's "
        f"moments float32; params {sorted(kinds[0])}, moments {sorted(kinds[1])}), {topo}, seq "
        f"{args.seq}, batch {args.batch}, lr {args.lr}: losses {losses}; step s {times}; median "
        f"step after the first {median:.6f} s, {args.batch * args.seq / median:.1f} tokens/s, "
        f"model FLOPs {flops:.6g} over it {flops / median / CARD.bf16_flops:.4f} of the bf16 "
        f"peak ({CARD.bf16_flops:.3g}/s); peak allocated {peak:.6f} GB; launches {cap.launches}; "
        f"phase {time.perf_counter() - t_phase:.1f} s [{H.card}]")
    del params, opt, step
    gc.collect()
    torch.cuda.empty_cache()


def restack(torch, params, num_stages):
    """A 1-stage tree's blocks (1, L, ...) as ``num_stages`` stages of L /
    ``num_stages`` slots, copied."""
    from repro_torch.train.optimizer import tree_map

    one = lambda a: a[0].reshape(num_stages, a.shape[1] // num_stages, *a.shape[2:]).clone()
    return dict(tree_map(torch.clone, params), blocks=tree_map(one, params["blocks"]))


def train_bf16_bit_identical(H, torch, tag, arch, steps, cut):
    """``arch`` (fields ``cut``) trained from one bf16 init under
    deterministic algorithms three ways: 1 stage fill_drain, 2 stages
    fill_drain (the same rows restacked), 2 stages interleaved on one card
    (2 virtual stages): every loss, and every param after the last update,
    bit for bit; losses and params finite. Each run's median step and its
    model FLOPs over it as a share of the bf16 peak."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch.train import build_parser
    from repro_torch.models.transformer.model import Topology, init_params
    from repro_torch.roofline import model_flops
    from repro_torch.train.optimizer import tree_leaves

    t_phase = time.perf_counter()
    args = build_parser().parse_args(["--mode", "lm", "--arch", arch, *BF16_TRAIN])
    cfg, cut_note = cut_config(get_arch(arch), cut)
    topo = lambda stages, **kw: Topology(num_stages=stages, num_micro=2, loss_chunks=4, **kw)
    runs = (("1 stage fill_drain", 1, {}), ("2 stages fill_drain", 2, {}),
            ("2 stages interleaved (2 virtual)", 2, {"schedule": "interleaved", "num_virtual": 2}))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = init_params(cfg, seed=args.seed, device=H.dev, dtype=torch.bfloat16)
    flops = model_flops(cfg, ShapeConfig("t", args.seq, args.batch, "train"), training=True)
    ref, lines = None, []
    torch.use_deterministic_algorithms(True)
    try:
        for what, stages, kw in runs:
            start = restack(torch, base, stages)
            slots = {name: n * 2 for name, n in active_slots(cfg, stages).items()}
            with KernelCapture({name: 0 for name in slots}) as cap:
                losses, times, params, step, opt = bf16_train_run(
                    torch, cfg, topo(stages, **kw), start, args, steps)
            count_bf16(H, cap, {name: 2 * n * steps for name, n in slots.items()},
                       f"{tag} {arch} {what}")
            del step, opt, start
            if not all(map(math.isfinite, losses)) or not all(
                    bool(p.isfinite().all()) for p in tree_leaves(params)):
                raise AssertionError(f"{tag} {arch} {what}: losses {losses} or params non-finite")
            leaves = tree_leaves(restack(torch, params, 2) if stages == 1 else params)
            del params
            if ref is None:
                ref = (losses, leaves)
            else:
                same = losses == ref[0] and all(H.torch.equal(a, b)
                                                for a, b in zip(leaves, ref[1]))
                if not same:
                    raise AssertionError(f"{tag} {arch}: {what} differs from {runs[0][0]} "
                                         f"(losses {losses} vs {ref[0]})")
            median = statistics.median(times[1:])
            lines.append(f"{what}: losses {losses}, median step {median:.6f} s, model FLOPs "
                         f"{flops:.6g} over it {flops / median / CARD.bf16_flops:.4f} of the bf16 "
                         "peak")
            del leaves
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[bf16] {tag} {arch} full width{cut_note}, bf16 params, seq {args.seq}, batch "
        f"{args.batch}, 2 micro-batches, {steps} steps under deterministic algorithms: "
        + "; ".join(lines) + f"; every loss and the last update's params bit-identical across "
        f"the three; peak allocated {peak:.6f} GB; phase {time.perf_counter() - t_phase:.1f} s "
        f"[{H.card}]")
    del base, ref
    gc.collect()
    torch.cuda.empty_cache()


# the bf16 mma.sync instance's times at 24g's and 25f's shapes before the
# wgmma instances (PERF.md §6, one NVIDIA H100 80GB HBM3 at 700 W), printed
# beside this run's
BF16_FLASH_BEFORE_MS = {
    "codeqwen prefill (24a)": "0.174870-0.177679",
    "codeqwen training (24d)": "0.059600-0.060142",
    "zamba2 prefill (24c)": "0.163731-0.165363",
    "deepseek MLA prefill (24e)": "0.805423-0.808020",
    "codeqwen ring training (25b)": "0.036956-0.037249",
    "qwen2.5-32b ring prefill (25c)": "0.220424-0.221049",
    "arctic data-axis prefill (25d)": "0.158594-0.158951",
}
BF16_FLASH_SHAPES = (  # 24g: (label, the launches on 24a-24e's paths, b, s, h, kv, hd, hd_v)
    ("codeqwen prefill (24a)", "64 in 24a's prefill", 4, 512, 32, 32, 128, 128),
    ("codeqwen training (24d)", "32 a step", 4, 256, 32, 32, 128, 128),
    ("zamba2 prefill (24c)", "26 in 24c's prefill", 4, 512, 32, 32, 112, 112),
    ("deepseek MLA prefill (24e)", "2 in 24e's prefill", 4, 512, 128, 128, 192, 128),
)
BF16_SSD_SHAPES = (  # 24g: (label, launches, b, s, h, p, n)
    ("mamba2 prefill (24b)", "48 in 24b's prefill", 4, 512, 24, 64, 128),
    ("mamba2 training (24b)", "96 a step", 4, 256, 24, 64, 128),
    ("zamba2 prefill (24c)", "136 in 24c's prefill", 4, 512, 112, 64, 64),
)


def time_bf16(H, torch, tag="24g", flash_shapes=BF16_FLASH_SHAPES, ssd_shapes=BF16_SSD_SHAPES):
    """24g (25f with phase 25's shapes): each bf16 launch shape timed with
    CUDA events over CUDA-graph replays (``Harness.time_ms``, as phase 5):
    the kernel, its plain version on the same bf16 inputs, the bound at the
    bf16 rates (flash: 2 bytes a value, one bf16 product an operation; SSD:
    x, B, C, y 2 bytes a value, its fp32 math 3xTF32), the distance from
    the plain version in bf16 ulps, and for flash
    ``scaled_dot_product_attention`` on the same bf16 tensors. The first
    shape of each kernel is its ``kernels`` line entry, unless an earlier
    phase of the run timed one. Flash prints the instance each shape takes
    (``kernel.route``) and the mma.sync instance's time before it."""
    from repro_torch.kernels.flash.ref import flash_attention_ref
    from repro_torch.kernels.ssd.ref import ssd_chunk_scan

    for i, (label, launches, b, s, h, kv, hd, hd_v) in enumerate(flash_shapes):
        q, k, v = flash_inputs(H, b, s, h, kv, hd, hd_v=hd_v, dtype=torch.bfloat16)
        compare_bf16_flash(H, f"{tag} {label}", q, k, v)
        ms = H.time_ms(lambda: H.FK.flash_attention_kernel(q, k, v))
        plain_ms = H.time_ms(lambda: flash_attention_ref(q, k, v))
        library = sdpa_call(torch, q, k, v)
        library_ms = H.time_ms(library)
        bound_ms, bound_by, nbytes, ops, _ = flash_bound(q, k, v)
        record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                  "library_ms": library_ms}
        if i == 0:
            H.timing.setdefault(BF16_KEYS["flash_attention_kernel"], record)
        route = H.FK.route(q.dtype, hd, hd_v, all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
        log(f"[timing] flash_attention_kernel bf16 {label} (B {b} x S {s}, {h}/{kv} heads, hd "
            f"{hd}/{hd_v}, causal): kernel {ms:.6f} ms on the {route} instance (mma.sync before: "
            f"{BF16_FLASH_BEFORE_MS[label]} ms) ({launches}), plain {plain_ms:.6f} ms, "
            f"scaled_dot_product_attention bf16 {library_ms:.6f} ms, bound {bound_ms:.6f} ms "
            f"({bound_by}: {nbytes} B, {ops} ops as bf16 products at {CARD.bf16_flops:.3g}/s), "
            f"share of bound {bound_ms / ms:.3f} [{H.card}]")
    for i, (label, launches, b, s, h, p, n) in enumerate(ssd_shapes):
        x, dt, loga, B, C = ssd_inputs(H, b, s, h, p, n)
        x, B, C = (a.to(torch.bfloat16) for a in (x, B, C))
        compare_bf16_ssd(H, f"{tag} {label}", x, dt, loga, B, C, 128)
        ms = H.time_ms(lambda: H.DK.ssd_kernel(x, dt, loga, B, C, chunk=128))
        plain_ms = H.time_ms(lambda: ssd_chunk_scan(x, dt, loga, B, C, chunk=128))
        bound_ms, bound_by, nbytes, ops, _ = ssd_bound(x, B, 128)
        if i == 0:
            H.timing.setdefault(BF16_KEYS["ssd_kernel"], {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None})
        log(f"[timing] ssd_kernel bf16 {label} (b {b} x S {s}, {h} heads, P {p}, N {n}, chunk "
            f"128; x, B, C, y bf16): kernel {ms:.6f} ms ({launches}), plain {plain_ms:.6f} ms, "
            f"library none, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} ops as "
            f"3xTF32 at {CARD.tf32_flops:.3g}/s), share of bound {bound_ms / ms:.3f} [{H.card}]")


def phase_bf16(H, torch):
    """Phase 24: the LM steps at the reference's own dtype on one card:
    bf16 params, caches and activations, float32 Adam moments, Mamba state,
    loss and logits (TF32 off for the float32 parts). 24a codeqwen1.5-7b
    served at full depth (prefill against the float32 step, decode against
    a fresh prefill); 24b mamba2-130m served and trained at full depth (the
    SSD kernel's bf16 instance); 24c zamba2-7b served at 81 slots (flash at
    hd 112, SSD at 112 heads); 24d codeqwen1.5-7b cut to 8 layers trained 4
    steps, bit for bit across 1 and 2 stages and fill_drain and
    interleaved; 24e deepseek-v3-671b's prefill cut to one layer (flash at
    192/128); 24f the dry run against the card at bf16 for 24a's prefill
    and 24d's step; 24g the kernels at 24a-24e's bf16 launch shapes."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.models.transformer.model import Topology

    serve_bf16(H, torch, "24a", "codeqwen1.5-7b", fp32_check=True)
    serve_bf16(H, torch, "24b", "mamba2-130m")
    train_bf16(H, torch, "24b", "mamba2-130m", stages=2, steps=4)
    serve_bf16(H, torch, "24c", "zamba2-7b")
    train_bf16_bit_identical(H, torch, "24d", "codeqwen1.5-7b", 4, {"num_layers": 8})
    serve_bf16(H, torch, "24e", "deepseek-v3-671b", cut={"num_layers": 1}, decode=False)
    cfg = get_arch("codeqwen1.5-7b")
    counted_on_card_and_meta(
        H, torch, "24f codeqwen1.5-7b bf16 prefill (24a: 512 tokens, batch 8, 2 micro-batches)",
        cfg, Topology(num_stages=1, num_micro=2), ShapeConfig("serve_prefill", 512, 8, "prefill"),
        dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    counted_on_card_and_meta(
        H, torch, "24f codeqwen1.5-7b bf16 train step, 8 layers (24d: seq 256, batch 8, 2 "
        "micro-batches, 4 loss chunks, remat)", dataclasses.replace(cfg, num_layers=8),
        Topology(num_stages=1, num_micro=2, loss_chunks=4), ShapeConfig("cli", 256, 8, "train"),
        dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    time_bf16(H, torch)


# ------------------------------- phase 25: the four-card LM paths at bf16 --

LM_BF16_CARDS = 4  # phase 25: the ring (D 4), the grid (dp 2 x D 2) and pods 2 x D 2
LM_BF16_DIR = ROOT / "build" / "phase25"
PHASE25_SKIP = "phase 25 needs 4 cards (run it on a host with 4 cards)"
LM_BF16_GRID_CUTS = (  # 25a: (tag, kind, arch, cut, Topology fields) on the grid and the pods
    ("codeqwen zero3", "train", "codeqwen1.5-7b", {"num_layers": 8}, {}),
    ("codeqwen zero1", "train", "codeqwen1.5-7b", {"num_layers": 8}, {"zero3": False}),
    ("arctic gathered", "train", "arctic-480b", {"num_layers": 2, "num_experts": 8}, {}),
    ("arctic a2a", "train", "arctic-480b", {"num_layers": 2, "num_experts": 8},
     {"moe_mode": "a2a"}),
    ("qwen2.5 serve", "serve", "qwen2.5-32b", {"num_layers": 8}, {}),
    ("codeqwen pods", "train", "codeqwen1.5-7b", {"num_layers": 8}, {"pods": 2, "data": 1}),
)
LM_BF16_MOE_EXPERTS = (128, 96, 64, 48)  # 25d's training: the widest cut whose bf16 state fits
# the fp32 runs 25b and 25d are read beside (PERF.md §5, four NVIDIA H100 80GB HBM3 at 700 W)
FP32_22B = ("22b at fp32 (PR 25's four-card runs): 1.547-1.580 s a step, NCCL 0.35-0.45 of it, "
            "peak 43.9-45.4 GB a rank")
FP32_23B = ("23b at fp32 (PR 26's four-card runs): 1.683347-1.684076 s a step, NCCL 0.409-0.452 "
            "of it, peak 42.806 GB a rank")
LM_BF16_FLASH_SHAPES = (  # 25f: (label, the launches a rank makes, b, s, h, kv, hd, hd_v)
    ("codeqwen ring training (25b)", "64 a step on each rank", 2, 256, 32, 32, 128, 128),
    ("qwen2.5-32b ring prefill (25c)", "32 in each rank's prefill", 4, 512, 40, 8, 128, 128),
    ("arctic data-axis prefill (25d)", "2 in each rank's prefill", 2, 512, 56, 8, 128, 128),
)
LM_BF16_SSD_SHAPES = (  # 25f: (label, launches, b, s, h, p, n)
    ("zamba2 ring training (25a)", "24 a step on each rank", 2, 256, 112, 64, 64),
)


def lm_bf16_predictions(H):
    """25b-d's per-rank state at bf16 (params and gradients at the params'
    dtype, Adam's moments float32) against the card, printed before the run
    (a leg that cannot fit stops here); returns 25d's training expert cut,
    the widest of ``LM_BF16_MOE_EXPERTS`` whose state fits
    ``LM_DATA_MOE_FIT`` of the card."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer.model import Topology

    bf16 = torch.bfloat16
    legs = (("25b", "codeqwen1.5-7b", {}, Topology(num_stages=4, num_micro=4), True),
            ("25c", "qwen2.5-32b", {}, Topology(num_stages=4, num_micro=2), False),
            ("25d codeqwen", "codeqwen1.5-7b", {}, lm_data_topology({}), True),
            ("25d arctic serve", *LM_DATA_MOE, lm_data_topology({}), False))
    for leg, arch, cut, topo, train in legs:
        cfg, note = cut_config(get_arch(arch, smoke=False), cut)
        reckon = data_state_gb if topo.data > 1 else state_gb
        gbs = [reckon(cfg, topo, d, train, bf16) for d in range(topo.num_stages)]
        log(f"[lm-bf16] {leg} {arch}{note}, {topo.data} x {topo.num_stages}: bf16 "
            f"{'params and gradients, float32 Adam moments' if train else 'weights'} per rank "
            + ", ".join(f"{g:.3f}" for g in gbs) + f" GB of the card's {CARD_BYTES / 1e9:.0f} "
            f"[{H.card}]")
        if max(gbs) > 0.9 * CARD_BYTES / 1e9:
            raise AssertionError(f"{leg}: a rank's state {max(gbs):.1f} GB would not fit")
    return lm_data_moe_experts(H, LM_BF16_MOE_EXPERTS, bf16, "25d")


def dtypes_note(kinds) -> str:
    """A case's dtypes, short: each kind's, a cache's by leaf."""
    short = lambda k: k.replace("torch.", "")
    return ", ".join(f"{key} " + ("/".join(sorted(map(short, v))) if isinstance(v, set) else
                                  " ".join(f"{p}:{short(d)}" for p, d in sorted(v.items())))
                     for key, v in kinds.items())


def check_bf16_dtypes(torch, label, cfg, got):
    """25a's dtypes: params as ``init_params`` makes them at bf16 (the
    reference's leaf dtypes), Adam's moments, the loss and the logits
    float32, every cache leaf bf16 but Mamba's ``ssm`` state (float32)."""
    from repro_torch.models.transformer.model import abstract_params

    kinds = got["dtypes"]
    want = leaf_dtypes(abstract_params(cfg, 1, torch.bfloat16))
    bad = []
    if kinds["params"] != want or "torch.bfloat16" not in want:
        bad.append(f"params {kinds['params']} (want {want})")
    for key in ("moments", "loss", "logits"):
        if key in kinds and kinds[key] != {"torch.float32"}:
            bad.append(f"{key} {kinds[key]}")
    for path, kind in kinds.get("cache", {}).items():
        if kind != ("torch.float32" if path.endswith("ssm") else "torch.bfloat16"):
            bad.append(f"cache {path} {kind}")
    if bad:
        raise AssertionError(f"{label}: dtypes " + "; ".join(bad))


def lm_bf16_references(H, torch, experts):
    """25a on one card (``H.dev``), deterministic, bf16 params: the ring's
    cases at their Topology in one process, the grid's and the pods' with
    every replica and pod in this process, and the long-context decode;
    saved for the rank workers with 25d's training cut (``experts``)."""
    from repro_torch.configs import get_arch

    bf16 = torch.bfloat16
    refs = {"experts": experts, "ring": {}, "grid": {}}
    cases = [("ring", c) for c in LM_RING_CUTS] + [("grid", c) for c in LM_BF16_GRID_CUTS]
    for where, (tag, kind, arch, cut, flags) in cases:
        t0 = time.perf_counter()
        case = lm_ring_case if where == "ring" else lm_data_case
        got, _ = case(H, torch, kind, arch, cut, flags, capture={}, dtype=bf16)
        check_bf16_dtypes(torch, f"25a one card, {where} {tag}", cut_config(
            get_arch(arch, smoke=False), cut)[0], got)
        refs[where][tag] = got
        what = (f"losses {got['losses']}" if kind == "train" else
                f"tokens[0] {got['tokens'][0]}, prefill {got['prefill_s']:.6f} s, decode "
                f"{got['decode_s'] / 16:.6f} s a token")
        log(f"[lm-bf16] 25a one card, {where} {tag}{got['note']}, {got['topo']}, bf16: {what}; "
            f"{time.perf_counter() - t0:.1f} s [{H.card}]")
    t0 = time.perf_counter()
    refs["long"] = long = lm_data_long(H, torch, dtype=bf16)
    check_bf16_dtypes(torch, "25a one card, long", get_arch("codeqwen1.5-7b", smoke=False), long)
    log(f"[lm-bf16] 25a one card: codeqwen1.5-7b long_context_window -> {LONG_WINDOW}, "
        f"{LONG_STEPS} steps of one row, 2 replicas in one process, bf16: "
        f"{long['decode_s'] / LONG_STEPS * 1e3:.3f} ms a step, tokens {long['tokens'][-8:]} "
        f"(last 8); {time.perf_counter() - t0:.1f} s [{H.card}]")
    torch.save(refs, LM_BF16_DIR / "refs.pt")
    return refs


def phase_lm_bf16(H, torch):
    """Phase 25: the LM stage ring and data axis at the reference's bf16 on
    four cards. 25a cut-depth cases bit for bit on every rank against one
    card (the ring, the dp 2 x D 2 grid, pods 2 x D 2, the long-context
    decode), dtypes asserted; 25b codeqwen1.5-7b trained at its 32 layers
    on the ring; 25c qwen2.5-32b served at its 64 layers on the ring; 25d
    codeqwen1.5-7b trained at 32 layers with ZeRO-3 and arctic-480b served
    with 128 experts and trained on the widest expert cut that fits; 25e a
    counted step per rank against meta; 25f the kernels' bf16 instances
    held on every rank's calls and timed at the new launch shapes. Returns
    what did not run, having printed it ("" when all of it ran)."""
    n = torch.cuda.device_count()
    if n < LM_BF16_CARDS:
        log(f"[lm-bf16] not run: {PHASE25_SKIP} (this machine has {n})")
        return f"phase 25 not run ({PHASE25_SKIP})"
    shutil.rmtree(LM_BF16_DIR, ignore_errors=True)
    LM_BF16_DIR.mkdir(parents=True)
    experts = lm_bf16_predictions(H)
    lm_bf16_references(H, torch, experts)
    time_bf16(H, torch, "25f", LM_BF16_FLASH_SHAPES, LM_BF16_SSD_SHAPES)
    gc.collect()
    torch.cuda.empty_cache()
    reports = run_rank_worker(H, torch, LM_BF16_CARDS, "lmbf16")
    lm_data_counts(H, torch, reports, torch.bfloat16)
    return ""


# ---------------------------------------------- phase 25: the rank worker --


def worker_lm_bf16_cut(H, torch, rl, refs):
    """25a on this rank, bf16 params: the ring's cases (``train_lm`` and
    ``serve`` join the ring of 4 themselves), the grid's on dp 2 x D 2 and
    the pods case on pods 2 x D 2, and the long-context decode, each bit
    for bit against the one-card case of ``refs`` (losses, tokens, logits,
    digests of this rank's rows and shards of the params, Adam's moments
    and the decode cache), its dtypes asserted, its kernel calls held
    within one bf16 ulp."""
    from repro_torch.configs import get_arch
    from repro_torch.core import ranks

    bf16 = torch.bfloat16
    grids = {1: ranks.RankGrid(2, 2), 2: ranks.RankGrid(1, 2, pods=2)}
    cases = [("ring", c) for c in LM_RING_CUTS] + [("grid", c) for c in LM_BF16_GRID_CUTS]
    for where, (tag, kind, arch, cut, flags) in cases:
        label = f"25a {where} {tag} rank {rl.rank}"
        if where == "ring":
            got, cap = lm_ring_case(H, torch, kind, arch, cut, flags, dtype=bf16)
            keys = ("losses", "again", "params", "mu", "nu") if kind == "train" else (
                "tokens", "logits", "cache")
        else:
            grid = grids[flags.get("pods", 1)]
            got, cap = lm_data_case(H, torch, kind, arch, cut, flags, grid, dtype=bf16)
            keys = ("losses", "params", "mu", "nu") if kind == "train" else (
                "tokens", "logits", "cache")
        check_bf16_dtypes(torch, label, cut_config(get_arch(arch, smoke=False), cut)[0], got)
        held_bit_for_bit(label, got, refs[where][tag], keys)
        held_launches(H, torch, rl, cap, label, bf16=True)
        trees = [k for k in keys if isinstance(got[k], dict)]
        digests = sum(len(got[k]) for k in trees)
        rl.line(f"25a {where} {tag}{got['note']}, {got['topo']}, bf16: "
                + (f"losses {got['losses']}" if kind == "train" else
                   f"tokens {len(got['tokens'])} x {len(got['tokens'][0])}, prefill and first "
                   "decode logits")
                + f" and {digests} row and shard digests of {', '.join(trees)} bit-identical "
                f"to one card; dtypes {dtypes_note(got['dtypes'])}; launches {cap.launches} "
                f"[{H.card}]")
    got = lm_data_long(H, torch, grids[1], dtype=bf16)
    want = refs["long"]
    label = f"25a long rank {rl.rank}"
    check_bf16_dtypes(torch, label, get_arch("codeqwen1.5-7b", smoke=False), got)
    held_bit_for_bit(label, got, want, ("tokens", "logits", "cache"))
    rl.line(f"25a codeqwen1.5-7b full width, long_context_window -> {LONG_WINDOW}, {LONG_STEPS} "
            f"steps of one row, {got['slots']} of the ring's {2 * got['slots']} slots on this "
            f"rank, bf16: tokens, last logits and this rank's cache slots bit-identical to one "
            f"card; {got['decode_s'] / LONG_STEPS * 1e3:.3f} ms a step [{H.card}]")


# a phase and the phases whose results it takes
PHASE_NEEDS = {"5": ("4",), "12": ("6",), "21": ("3",)}


def parse_phases(text):
    """``--phases 3,21`` -> the phase numbers to run, with what they need;
    None (every phase) without the flag."""
    if text is None:
        return None
    phases = {p.strip() for p in text.split(",") if p.strip()}
    unknown = phases - {str(n) for n in range(2, 26)}
    if unknown:
        raise SystemExit(f"--phases: no phase {sorted(unknown)}; phases are 2-25")
    for p in list(phases):
        phases.update(PHASE_NEEDS.get(p, ()))
    return phases


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke of the PyTorch/CUDA port.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after phase 1 (the card and the "
                         "build), e.g. 21; default: every phase")
    ap.add_argument("--rank-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker is not None:  # one rank of phases 21-23 or 25, started by torchrun
        return rank_worker(args.rank_worker)
    phases = parse_phases(args.phases)
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
    not_run = run_phases(H, torch, phases)

    kernels = []
    # each kernel, then the bf16 instances of flash and SSD (phase 24) as entries of their own
    instances = [(name, name) for name in REPLACES] + [(key, name) for name, key in
                                                        BF16_KEYS.items()]
    for key, name in instances:
        if phases is not None and not H.launches.get(key):
            continue  # --phases: the kernels those phases launched
        if not H.launches.get(key):
            raise AssertionError(f"{key} was not launched on its main path")
        if key not in H.timing:
            raise AssertionError(f"{key} was launched but not timed: its timing is phase 5's "
                                 "(phase 24's for the bf16 instances)")
        tm = H.timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": H.launches[key], "max_abs_err": H.err[key],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"],
        })
        if key == BF16_KEYS["flash_attention_kernel"]:  # every one on the wgmma instances
            if H.launches.get(WGMMA_KEY, 0) != H.launches[key]:
                raise AssertionError(f"{key}: {H.launches[key]} launches, "
                                     f"{H.launches.get(WGMMA_KEY, 0)} on the wgmma instances")
            kernels[-1]["wgmma_launches"] = H.launches[WGMMA_KEY]
    log("[compare] largest share of the tolerance used, per kernel: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(H.used.items())))
    # phases 21-23 and 25 run only where the cards are: "" when run, else why not
    ran = [p for p, note in not_run.items() if note == ""]
    skipped = [note for note in not_run.values() if note]
    if phases is None:
        names = f"all {21 + len(ran)} phases"
    else:
        names = "phases " + ", ".join(
            ["1", *sorted(phases - {"21", "22", "23", "25"}, key=int), *sorted(ran, key=int)])
    log(f"[done] {names} passed in {time.perf_counter() - t_start:.1f} s (limit {SMOKE_LIMIT_S} s)"
        + "".join(f"; {note}" for note in skipped))
    log(f"[card] {card_line}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(H, torch, phases=None):
    """Phases 2-25 (or those of ``phases``), each timed. Returns, for each
    of phases 21-23 and 25 that was asked for, what of it did not run (""
    when all of it ran)."""

    def phase(label, fn, *args):
        if phases is not None and label.rstrip("abc") not in phases:
            return None
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
    served_compiled = phase("3b", phase_serve_compiled, served)
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
    phase("14c", phase_loader, *(streamed or ()))
    phase("15a", phase_overlap)
    phase("15b", phase_roofline)
    phase("16", phase_lm_training)
    phase("17", phase_frontend_lm)
    phase("18", phase_moe_lm)
    torch.cuda.empty_cache()
    # phase 19's full-width predictions count on the host's other cores from
    # the start of phase 19 to the end of phase 24, two single-thread
    # processes beside card work (the host-bound phases 16-18 run before)
    predictions = start_predictions() if phases is None or {"19", "20"} & phases else None
    try:
        phase("19", phase_dryrun)
        phase("20", phase_examples)
        torch.cuda.empty_cache()
        phase("24", phase_bf16)
        if predictions is not None:
            phase("19", report_predictions, predictions)
    finally:
        if predictions is not None:
            stop_predictions(predictions)
    torch.cuda.empty_cache()
    not_run = {"21": phase("21", phase_ranks, served_compiled)}
    torch.cuda.empty_cache()
    not_run["22"] = phase("22", phase_lm_ring)
    torch.cuda.empty_cache()
    not_run["23"] = phase("23", phase_lm_data)
    torch.cuda.empty_cache()
    not_run["25"] = phase("25", phase_lm_bf16)
    return {p: note for p, note in not_run.items() if note is not None}


if __name__ == "__main__":
    sys.exit(main())
