#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100) and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It puts ``src`` on ``sys.path`` itself and
imports nothing of JAX or of the JAX package ``repro``.  Phases, each of
which exits non-zero on failure:

1. the card's name and power limit (``nvidia-smi``), then one ``nvcc`` per
   CUDA source of ``src/repro_torch/csrc``, all started together;
2. the main path: online TM-GCN serving (``paper_dyngnn``) at the full
   config's widths at the epinions scale (``DATASETS["epinions"]`` of
   ``configs/paper_dyngnn.py``: N = 755,200 nodes, 2,097,152 edge slots),
   16 windows of a 3.4 M-event synthetic CTDG stream — through
   ``repro_torch.serve.ServeEngine(device="cuda")``, whose kernel wrappers
   launch the CUDA kernels because the tensors lie on the card; every
   kernel's launch count and the CSR build count are zeroed just before
   and read just after (2 layers x 16 windows = 32 launches of each
   kernel, 16 CSR builds: one per snapshot); then node queries at batch
   1, 8, 64 and link queries on 64 pairs;
3. each kernel held to its plain PyTorch version (``ref.py``, called by
   name) on the card at the main path's shapes (the last window's graph;
   segment SpMM at the path's F = 2 and 6 and at F = 9 and 32, which run
   its generic instance (scalar and float4), then on a fully skewed
   graph, each shown to reject zeros and the kernel run with each row's
   last edge dropped),
   and timed beside its bound, its plain version and one PyTorch library
   call computing the same function (a yardstick the port never calls);
   ``banded_ttm`` at serving's call (the 4-row prefix and one new row,
   read through two pointers, one row written), shown to reject zeros, a
   dropped prefix row and a dropped slice row; the state-advance step
   timed, then profiled;
4. the first 6 of the 16 windows replayed through a ``device="cpu"``
   engine — where the wrappers run the plain versions — and its
   embeddings and queries after window 6 held to the card's, which the
   main path kept then (all 16 took ~50 s of host time); then
   small-graph serving of all three models, card against CPU, after
   every window;
4a. the training path: ``paper_dyngnn`` (TM-GCN) at the full config's
   widths trained through ``repro_torch.run.Engine(device="cuda")`` — a
   synthetic trace at N = 755,200 with T = 32 steps (cut from epinions'
   512; density 1.25, M-transform smoothed, ~2.1 M edge slots; made on
   the host by a child process started before phase 2), 10 AdamW
   steps of the blocked-checkpoint trainer (nb 4), then link-prediction
   evaluation; every kernel's count is zeroed just before the fit and
   read just after (per step: 160 ``segment_spmm`` — 64 forward, 64 in
   the checkpoint recompute, 32 backward on the transposed CSR; 12
   ``banded_ttm``; 8 ``banded_ttm_t``; 0 ``flash_decode``; 64 CSR
   builds for the run), losses, fenced ``train.step`` spans, peak device
   memory beside ``activation_memory_estimate``; then the warm step
   timed, and one step profiled: device busy, its device time by kind
   (fills, copies, adds, GEMMs, each kernel) and the forward M-product's
   device time a step (its 12 launches; it needs no copy);
4b. the kernels held to their plain versions at the train path's
   shapes, each shown to reject zeros and a dropped edge / input row, and
   timed beside bound, plain version and library call: ``segment_spmm``
   on the transposed CSR at F = 6; the forward ``banded_ttm`` on
   [prefix, slice] at (T_s 8, lead 4) with t_offset -4 (block 0: its
   prefix lies before global step 1 and is never read) and +4, at (32,
   lead 0) and at the full config's block (128, lead 4), rejecting a
   dropped prefix row and a dropped slice row; ``banded_ttm_t`` on the
   kept rows' gradient dZ (T_s, N x 6) at the same four shapes (block 0:
   slice rows only); then each at small shapes over every instance its
   launcher builds: w 1-9, T_s 1-12, lead 0 and w - 1, t_offset -7..+9,
   4 and 1 columns a thread (one pointer at a time off 16-byte
   alignment), ``banded_ttm_t`` with and without the prefix's rows;
4c. one training step's loss and every gradient, card against a
   ``device="cpu"`` run from the same parameters, for all three models at
   N = 65,536, T = 16, nb 4;
4d. the streamed schedule: ``paper_dyngnn`` at the full config's widths
   over the training trace (the train phase's dataset, reused; made here
   when that phase does not run), one epoch per snapshot through
   ``Engine(mode="streamed", device="cuda")`` with the prefetch thread
   staging on a side CUDA stream, then one without it (every count
   zeroed just before each and read just after: per step 3
   ``segment_spmm`` — 2 forward, 1 backward —, 2 ``banded_ttm``, 2
   ``banded_ttm_t``, 0 ``flash_decode``, 2 CSR builds), their losses and
   parameters held bit-identical, the per-snapshot breakdown (fenced
   spans: encode, stage, apply, CSR pair, step; ``prefetch.wait``), the
   payload bytes against naive, the peak device memory and whether the
   host encoder bounds the schedule; one epoch of ``slice_len = 8`` (24
   / 2 / 2 / 0 and 16 CSR builds a step); ``banded_ttm_t`` at the step's
   (1, lead 4), slice rows only, held to its plain version, shown to
   reject zeros and a dropped row, timed beside its bound, plain version
   and cuBLAS; one snapshot's CSR-pair build timed against the F = 6
   ``segment_spmm``; then the streamed loss stream, card (prefetch
   thread) against CPU (inline), for all three models at N = 65,536,
   T = 8: every step's loss within 1e-4 relative, the first step's
   gradients within 1e-4 x each leaf's max;
4e. snapshot partitioning at P = 1 over a one-rank NCCL group (the
   machine has one card; the same code as P ranks): ``paper_dyngnn`` on
   the train phase's trace through ``Engine(plan=ExecutionPlan(mode=
   "eager", mesh=group), device="cuda")``, 10 steps from the train phase's
   seed and optimizer (every count zeroed just before and read just after:
   the train phase's 160 / 12 / 8 / 0 launches a step and 64 CSR builds,
   40 all-to-alls a step of one layer's (8, N, 6) f32 payload, none of it
   leaving the rank), the loss stream held to the train phase's at rtol
   1e-5, the warm step, one profiled step (NCCL's all-to-all ranges apart
   from the copies they span) and peak memory beside eager's, and the
   one-rank all-to-all timed on one layer's payload and on a P = 4 rank's
   beside their copy bound and ``clone()``, with its host enqueue time;
4f. ``banded_ttm`` and ``banded_ttm_t`` at a P = 4 rank's temporal shape,
   (8, lead 4) x N/4 x 6 = 1,132,800 columns, t_offset -4 and +4, held to
   their plain versions, shown to reject faults, timed beside bound, plain
   version and cuBLAS's dense band;
4g. P = 2 ranks sharing the card over gloo with CUDA tensors (the
   shared-card phase's pair, 4o): TM-GCN at N = 65,536, T = 8
   partitioned, then on the CPU; their losses and first-step gradients
   held to each other, to the CPU's and to the card's P = 1 run over NCCL
   (1e-4 relative and 1e-4 x each leaf's max);
4h. the distributed stream at P = 1 over the one-rank NCCL group:
   ``paper_dyngnn`` on the train phase's trace (made here when that phase
   does not run), block 8 (4 rounds an epoch), 2 epochs through
   ``Engine(plan=ExecutionPlan(mode="streamed_mesh", mesh=group),
   device="cuda")`` (every count zeroed just before the fit and read just
   after: per round the slice step's 24 ``segment_spmm`` / 2
   ``banded_ttm`` / 2 ``banded_ttm_t`` / 0 ``flash_decode`` and 16 CSR
   builds, 8 all-to-alls of one layer's (8, N, 6) f32 payload, none of it
   leaving the rank), its loss stream held to the single-device
   ``train_streamed(slice_len=8)`` at rtol 1e-5; on the rank's cached
   stream: the prefetch thread off (identical), ``pipeline_rounds`` and
   ``a2a_chunks = 2`` (rtol 1e-5), ``int8_a2a`` and ``int8_all`` (within
   1e-3 of ``none``, ``tests/test_compression_drift.py``'s bound; their
   int8 all-to-all bytes), a fenced run (the round's transfer, CSR pair
   and step), ``pipeline_rounds`` off and on in turns, peak memory; one
   layer's int8 all-to-all, its quantize and dequantize passes apart,
   beside the f32 one and their copy bounds;
4i. P = 2 ranks sharing the card over gloo with CUDA tensors (4o's
   pair) run the distributed stream (TM-GCN, N = 65,536, T =
   8, block 4) on cuda:0, then on the CPU, for ``none`` and ``int8_a2a``;
   their losses held to each other, to the CPU's (1e-4 relative) and to
   the card's P = 1 (``none`` 1e-4 relative, ``int8_a2a`` 1e-3);
4j. the hybrid scheme (paper §6.5) on a 1 x 1 grid of the one-rank NCCL
   group (``dist.sharding.make_grid``): ``paper_dyngnn``'s widths on the
   train phase's trace (made here when that phase does not run), its
   edges split into the grid's destination shard, through
   ``core.hybrid.hybrid_forward`` (every count zeroed just before and read
   just after: L T = 64 ``segment_spmm`` on rectangular CSRs, L = 2
   ``banded_ttm``, T = 32 CSR builds), Z held to ``models.forward`` on the
   same batch (1e-5; 0.0 expected), the forward timed in turns beside the
   eager one; the one-rank frame all-gather at (32, 755,200, 6) into one
   tensor and into a list of its views, beside one copy of the frame;
   ``segment_spmm`` on a rectangular CSR at a Pm = 4 rank's shape
   (188,800 rows gathered from 755,200) at F = 2 and 6, held to its
   plain version, shown to reject zeros and a dropped edge per row, timed
   beside its bound (the x rows the CSR reads), plain version and
   ``torch.sparse.mm``; then a 2 x 2
   grid of four gloo ranks sharing cuda:0 (4o) at N = 65,536, T = 8,
   held to CPU gloo and to the card's 1 x 1 grid and eager forward (1e-4);
4k. the sampled schedule over the one-rank NCCL group: ``paper_dyngnn``
   on the first 8 steps of the train trace (N = 755,200; one epoch of 2
   rounds of block 4 over one pipeline of those steps, its host seconds
   counted: the first 16 steps in blocks of 8 cost ~40 s more of host
   sampling and pipeline, a second epoch ~90 s, and the carry store's
   epoch reset runs in the 2-epoch runs below), the launcher's
   defaults (N / 4 seeds, fanouts 10, 10), the
   union capped at the largest snapshot's edges, through
   ``Engine(plan=ExecutionPlan(mode="sampled", mesh=group,
   device_budget_bytes=B))`` with B between the sampled and the full-graph
   round's bytes, after ``streamed_mesh`` is shown to refuse B (every
   count zeroed just before the fit and read just after: per round 12 /
   2 / 2 / 0 and 8 CSR builds); ``table_pad``, ``edge_pad``, the dropped
   lanes, per round the fenced host sampling, staging, carry gather /
   all-gather / scatter, step and CSR-pair spans, the staged bytes beside
   the full round's and the peak beside ``sampled_round_bytes``; every
   vertex a seed with full fanout at N = 65,536, T = 8, 2 epochs, against
   the distributed stream on the card (rtol 1e-5); and 4o's two gloo
   ranks sharing cuda:0 for 2 epochs, card against CPU and the card's P =
   1 (1e-4);
4l. fault tolerance and elastic rescale (the ft group): eager
   ``paper_dyngnn`` at full width through ``Engine(device="cuda")`` with
   ``CheckpointSpec(every=5)``, 5 steps and ``Engine.resume()`` to 10,
   against the uninterrupted 10-step run and the train phase's losses
   (rtol 1e-5; 160 / 12 / 8 / 0 launches a step); the distributed stream
   at P = 1 over the NCCL group with ``CheckpointSpec(every=2)``, a
   SIGTERM raised in this process through the Engine's ``log_fn`` in
   round 2 (the run stops at cursor 3, mid-epoch) and ``resume()`` to the
   end, against the uninterrupted run (rtol 1e-5; 24 / 2 / 2 / 0 and 16
   CSR builds a round); each beside a cold and a warm ``Checkpointer``
   save's blocking ms and write s, the bytes on disk and a restore; P = 2
   -> 1 -> 2 on 4o's two gloo ranks sharing cuda:0 at N = 65,536, T =
   8, against ``train_streamed`` on the card (rtol 1e-5), payloads by
   ``comm_volume.rescale_payload``; the launcher with ``--ckpt-dir`` as a
   subprocess (eager at the smoke config, 100 steps: the distributed
   stream needs a card a rank; run beside 4o) stopped by a real SIGTERM
   after its first logged step, exiting 0 with a checkpoint, and
   relaunched to the uninterrupted run's final loss;
4m. the training trace (the trace group): the distributed stream at
   full width, P = 1 over the one-rank NCCL group, 2 epochs of 4 rounds
   through ``Engine(ExecutionPlan(mode="streamed_mesh", shards=1))``,
   untraced and traced in turns (every count zeroed just before each fit
   and read just after): losses and parameters equal (max|diff| 0.0);
   24 / 2 / 2 / 0 launches and 16 CSR builds a round, the traced fits'
   probe adding exactly three one-rank rounds; each round's ``round``,
   ``round.transfer``, ``round.step`` and derived ``round.spatial`` /
   ``round.a2a`` / ``round.temporal`` spans, the derived three summing to
   the step; the calibration report's 8 rows; the probe's seconds and the
   observer effect; the spans exported as ``.json`` and ``.jsonl``, each
   valid; the launcher with ``--trace`` on the card (eager, smoke
   config), its ``trace:`` line and a valid file; the port's trace
   checker (``python -m repro_torch.obs.check``) passing the exported
   ``.json`` and ``.jsonl`` with ``--phases`` and the launcher's file
   with ``--require train.step``;
4n. edge-list data (the data group): the train trace's raw snapshots
   (30,207,991 rows, kept by the train phase, which made the trace in its
   two stages) written as ``.npz`` by ``write_edgelist``, read back
   in memory and in chunks (byte-identical to the generator's lists; the
   peak RSS of each read in a child process), built by ``EdgeListDTDG``
   into the train phase's dataset array for array; cut: the ``.tsv`` form
   at N = 65,536, T = 8, and 10 eager steps on the card from an
   ``EdgeListDTDG`` of that file, held to an ``InMemoryDTDG`` fit on the
   generator's lists at max|diff| 0.0 (40 / 12 / 8 / 0 launches a step, 16
   CSR builds; the full-width fit from the file took ~62 s of host
   pipeline); the committed fixture ``tests/fixtures/epinions_tiny.tsv``
   trained on the card and on the CPU (1e-4);
4o. the shared-card checks of 4g, 4i, 4j, 4k and 4l at once, after the
   ft group: one spawned pair of gloo ranks runs the partition,
   distributed-stream, sampled and elastic checks in turn, four more
   ranks the hybrid's 2 x 2 grid beside them (``SHARED_THREADS`` CPU
   threads a rank, one join deadline for all), while this process makes
   each check's P = 1 reference on the card and the ft launcher's runs go
   on in a thread; then each group's comparison;
5. the LM path: Yi-6B at full width (32 layers, d 4096, 32 query heads
   over 4 KV heads, D 128, bf16, random weights drawn on the card from a
   seed) served through ``ServeEngine(device="cuda").generate()``: one
   wave of 8 prompts of 4,096 tokens (prefill takes the query-chunked
   path), 64 greedy tokens; every kernel's count is zeroed just before
   and read just after (32 layers x 63 decode steps = 2,016 launches of
   ``flash_decode``, none of the dyngnn kernels); prefill ms, decode ms
   per step (fenced spans), tokens/s, peak device memory; then one decode
   step alone and under ``torch.profiler``;
6. ``flash_decode`` held to its plain version at the path's shape (B 8,
   S 4,160, ragged ``cache_len`` with 1 and S), at ``decode_32k``'s
   (S 32,768) and ``long_500k``'s (B 1, S 524,288) lengths, at D 64 and
   D 256 with G 1 (MiniCPM, Gemma), at G 2 (a head tile of 16, 14
   padded), with a ``cache_len = 0`` row, at D 64 with G 4, and at
   OLMoE-1B-7B's decode shape (B 8, S 4,160, 16 heads over 16, D 128: G 1)
   with the full cache, ragged, with a ``cache_len = 0`` row and at
   ``long_500k``, at MiniCPM-2B's and Gemma-7B's decode shapes (G 1, D 64
   and 256, B 8, S 4,160), each in bf16 (the tensor-core instance, G 1
   too) and f32 (CUDA cores), and a ``long_500k`` rank's slice of OLMoE's
   cache with the log-sum-exp output, full and empty (as phase 12's
   check); at each, the check is shown to reject zeros and the kernel's
   output with one split's rows dropped; each row names its instance and
   is timed beside its bound, its plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
7. Yi-6B's full widths at 2 layers in f32, card (kernel) against a
   ``device="cpu"`` engine's parameters (plain version): prefill logits
   and 8 teacher-forced decode steps' logits;
8. the MoE LMs (the moe group): OLMoE-1B-7B at full width (16 layers, d
   2048, 16 query heads over 16 KV heads, D 128, 64 experts top-8 of ff
   1024, vocab 50,304, bf16, 6,919,620,608 random parameters drawn on the
   card) through ``ServeEngine(device="cuda").generate()``, phase 5's
   wave (8 prompts of 4,096 tokens, 64 greedy tokens; the prefill's
   capacity 5,120 slots an expert), every count zeroed just before and
   read just after (16 layers x 63 steps = 1,008 ``flash_decode``
   launches on its tensor-core instance at G = 1, none of the dyngnn
   kernels); prefill ms, decode ms p50 / p95, tokens/s, peak memory; one
   decode step profiled (device busy against wall, by kind) beside its
   bound (every weight but the embedding table, of which B rows are read,
   and the K/V rows read, at 3.35 TB/s); then Moonlight-16B-A3B's full
   widths cut to 4 of its 48 layers (B 8, prompt 512, 16 tokens: 4 x 15
   launches); LM training at OLMoE's widths cut to 4 of 16 layers
   (1,884,833,792 parameters; ``train_4k``'s sequence of 4,096, batch cut
   from 256 to 2), 10 ``launch.steps.lm_train_step`` calls: finite
   losses, step ms, tokens/s, peak; card against CPU in f32 (TF32 off):
   ``moe_apply`` at OLMoE's widths on 256 tokens at ample and at default
   capacity (routing first: a token routed differently must sit at a
   near-tie, its 8th and 9th probabilities under 1e-5 apart; outputs 1e-4
   on the tokens routed alike, the dropped fraction equal), OLMoE's
   widths at 2 layers (capacity for every token: prefill and 8 decode
   steps' logits, 1e-4, rows with a near-tie routing flip reported and
   left out), and one ``lm_train_step`` at 1 layer, B 1, S 128 (loss and
   every gradient 1e-4 x each leaf's max);
9. the static GNNs (the gnn group): GatedGCN, PNA, SchNet and
   EquiformerV2 at their full configs' widths, 10 AdamW steps each of
   their cells' own steps (``launch.steps.build_cell``: ``gnn_train_step``
   on the cell's tensors) from ``init_params`` (drawn on the card) and
   ``adamw.init_state``, at ``molecule`` (128 graphs: 3,840
   nodes, 8,192 edges) and ``full_graph_sm`` (2,708 nodes, 10,624 edge
   lanes, 1,433 features, 7 classes), and GatedGCN, PNA and SchNet at
   ``minibatch_lg`` (1,024 seeds, fanouts 15 and 10: 169,984 nodes,
   168,960 edges, 602 features, 41 classes), each shape's batch made once
   on the card; every count zeroed just before each run and read just
   after (no kernel: the GNNs aggregate with ``index_add`` and
   ``scatter_reduce``); per run finite losses, the parameter count, step
   ms, peak memory, one profiled step (device busy, idle share, device
   time by kind); the cuts' reckoning (``launch.dryrun.reckon``:
   ``ogb_products`` for every arch, EquiformerV2 at ``minibatch_lg``);
   card against CPU (TF32 off): one
   step's loss and gradients for each arch's smoke config on the
   launcher's smoke batch and EquiformerV2's full widths at 2 layers on
   ``molecule``, while the launcher trains EquiformerV2 at its full
   config for 5 steps in a subprocess on the card;
10. the recsys family (the recsys group): DIN at its full config
   (embed 18, history 100, attention MLP 80-40, MLP 200-80; 2,010,000
   table rows, ``configs/din.py``) at the reference's shapes: 10 AdamW
   steps of the ``train_batch`` cell's step (``din_train_step``) at
   ``train_batch`` (B 65,536,
   ragged histories drawn by ``din_batch`` on the card) from
   ``din_train_state`` (drawn on the card): finite losses, every
   parameter leaf moved, step ms, peak, one profiled step (busy, idle
   share, device time by kind); then the
   trained parameters served through ``ServeEngine(ServeConfig(model=
   DINConfig()), device="cuda").score`` -- 20 waves at ``serve_p99``
   (512) and 3 at ``serve_bulk`` (262,144), each after a warm wave: p50
   / p99, peak; then ``din_retrieval_step`` at ``retrieval_cand`` (one
   user against 1,000,000 candidates) in chunks of 131,072 (unchunked,
   its (N, L, 4P) features alone are 57.6 GB): total ms, candidates/s,
   peak; every count zeroed just before each and read just after (no
   kernel: DIN embeds with gathers and pools with GEMMs); card against
   CPU (TF32 off): logits, loss and one train step's gradients on 256
   rows at the full config, and 4,096 candidates scored in chunks of
   1,000 on the card against unchunked on the CPU, while the launcher
   trains DIN at its full config (B 65,536) for 3 steps in a subprocess
   on the card;
11. the cells (the cells group): every (arch x shape) cell of the
   registry (``launch.steps.all_cells``, 60) built by
   ``launch.steps.build_cell`` over a one-rank NCCL group and reckoned by
   ``launch.dryrun.reckon`` against the card's memory (less what the
   process still holds): argument bytes exact from the cells' abstract
   inputs, work bytes per family, a reserve; then one step of every
   cell that fits and that no other group runs at its registry shape,
   the allocator's segments expandable: the LM decode cells at
   ``long_500k`` (Yi-6B, and OLMoE-1B-7B when it fits; B 1, 524,288
   cached rows of random bf16 values; ``flash_decode`` once a layer,
   counts zeroed just before and read just after; a profiled step gives
   its device time a launch on the path) and the dyngnn cells at their
   full T (the paper's datasets' N and T; the snapshot-partitioned step
   with bf16 payloads and the fused final loss; inputs drawn on the card;
   per step 5 T ``segment_spmm``, TM-GCN's 2 L nb ``banded_ttm`` and L
   nb ``banded_ttm_t``, 2 T CSR builds), each with its peak against the
   reckoning (over it fails) and the analytic roofline beside its ms;
   then the dyngnn cell's step, card against CPU (gloo), for all three
   models at N = 65,536, T = 16;
12. the LM cells over ranks (the ranks group): ``flash_decode``'s
   log-sum-exp output (``return_lse``) against the plain version's at a
   ``long_500k`` rank's slice of Yi-6B's cache (full, part-filled, and
   empty: output 0 and -inf exactly), timed beside the call without it;
   then four gloo ranks sharing cuda:0 as a 2 x 2 grid run, at full
   width, Yi-6B's train step (tensor and data parallel, ZeRO AdamW
   state), prefill, three decode steps on the head-split cache and
   three of ``long_500k`` (B 1, S 524,288) on the cache split over all
   four ranks (slice 3 empty), and OLMoE-1B-7B's train step and three
   decode steps with its 64 experts split 32 + 32 (``RANKS_CELLS``:
   depth cut to 4 layers, OLMoE's train step to 2), each from its share
   of ``make_inputs(0)``; each cell runs first at 1 x 1 in this process,
   in bf16 and on the same values cast to fp32, and the ranks' outputs,
   handed over as CUDA tensors and gathered leaf by leaf, are held to the
   bf16 run: each leaf's max |diff| over its max |value| within twice the
   worst bf16-vs-fp32 one of its kind (parameters, m, v, master, logits,
   cache; the loss, one number, the run's worst; integers equal); the
   ranks' ``flash_decode`` launches
   (zeroed in each rank just before its cell's steps) are the path's;
   each rank's bytes and peak are printed beside ``launch.dryrun``'s
   per-rank reckoning, then ``launch.dryrun --grid 2x2`` over the LM
   cells with the smallest grid of H100s for each one card cannot hold.
   (The P = 1 check runs in the cells group: each LM cell it steps, built
   over the one-rank NCCL grid, equals the same cell built for no grid,
   bit for bit.)  Then the same four ranks run the static GNN and DIN
   cells at their full configs and widths (``RANKS_STATIC_CELLS``): the
   four archs' full graphs split by edge lanes over data with node rows a
   rank's (GatedGCN, PNA and EquiformerV2 at ``full_graph_sm``, SchNet at
   ``ogb_products`` with its 2,449,029 nodes, 2,000,000 of its
   edges and 1 of its 3 interactions; EquiformerV2 at 4 of its 12
   layers), EquiformerV2's ``minibatch_lg`` (192 seeds) and SchNet's
   ``molecule`` one replica a data rank, DIN's ``train_batch`` (65,536),
   ``serve_p99`` and ``retrieval_cand`` (1,000,000 candidates, 500,000 a
   data rank, in chunks of 32,768) with the tables split over model;
   each first at 1 x 1 over the one-rank NCCL group (DIN's serve step
   also built for no grid, bit for bit), then on the ranks, GatedGCN,
   PNA and SchNet in float64 (``RANKS_STATIC_F64``: the card's atomics
   move their f32 steps past the limit run to run), every leaf gathered
   and held within 1e-4 x its max at 1 x 1, no kernel launched; each
   rank's peak beside the per-rank reckoning, the step's seconds and the
   ``dp.*`` / ``gnn.*`` / ``tp.*`` bytes printed; then ``launch.dryrun
   --grid 2x2`` over the GNN, DIN and dyngnn cells;
13. the examples (the examples group, after 4m over the one-rank NCCL
   group): the five twins under ``examples/torch/`` called in this
   process at their default sizes on the card (quickstart's 60 eager
   steps, serve_dyngnn's 2 streamed epochs and 16 served windows,
   serve_lm's 4 x 32 greedy tokens at Yi-6B's smoke config,
   partition_compare's loss at P = 1 and its comm-volume table,
   train_dyngnn_distributed's 300 eager steps, evaluation and 2
   streamed_mesh epochs), every kernel count zeroed before each and read
   after: each kernel of a twin's path launched (``EXAMPLE_KERNELS``;
   segment_spmm's backward counted apart); then each twin at
   ``device="cpu"`` (the rank twins over a one-rank gloo group) held to
   its card run (losses relative, parameters and scores x each leaf's
   max, within ``TOL_EXAMPLES``; tokens, counts and accuracy equal;
   train_dyngnn_distributed at ``EXAMPLES_PARITY_STEPS`` eager steps on
   both); ``python examples/torch/quickstart.py`` runs as a user runs
   it, on the card, beside them all;
14. the API docs (the docs group, after 13 over the one-rank NCCL
   group): every ```python fence of the five twins under ``docs/torch/``
   run through the port's docs checker (``tools/torch/check_docs.py``)
   in this process on the card, every kernel count zeroed before and
   read after: segment_spmm (and its backward), banded_ttm and
   banded_ttm_t launched; at one rank, run_api.md's two fences guarded
   by a group of 4 skip and compression.md's 4-rank fence is passed by,
   each named in the log (the CPU tests run them on 4 gloo ranks); then
   the checker as a user runs it, ``--device cpu --no-links`` in a
   subprocess started before the examples group and run beside it and
   the card run, and each fence's values on the card held to
   the CPU's (``TOL_EXAMPLES``: losses and scores relative, counts,
   bytes and the rest equal).

Tolerances: the dyngnn cell card against CPU 1e-2 (its bf16 payloads,
``tests/test_torch_cells.py``'s); segment SpMM 1e-4 (abs and rel; fp32
sums in another order
than the plain ``index_add_``), banded TTM and its transpose 1e-5 (abs
and rel; the same fp32 operations in the same order, so 0.0 is
expected), served scores 1e-4 (the whole stack,
two layers); training loss and gradients 1e-4 x each leaf's max |value|
(sums over T x N ~ 1 M node-steps in another order);
flash decode, against the plain version's fp32 result, batch row by batch
row: 1e-4 abs and rel in f32 (``tests/test_kernels.py``'s), and in bf16
1e-2 x the row's max |plain|, no absolute term (2.56 times the worst
rounding of a bf16 output, 2^-8 of its size; the output shrinks as
1 / sqrt(cache rows), so a fixed term would pass zeros at long caches);
LM logits and ``moe_apply`` outputs 1e-4 (abs and rel; fp32 sums of
4,096- and 11,008-long products taken in another order, TF32 off); MoE
training gradients 1e-4 x each leaf's max; GNN and DIN losses 1e-4
relative and gradients 1e-4 x each leaf's max; DIN logits and retrieval
scores 1e-4 (abs and rel); the GNN and DIN cells over ranks against 1 x
1, 1e-4 x each leaf's max (``TOL_RANKS_STATIC``).
Kernel times are device time only (each call queued behind a device
sleep); ``wrapper_ms`` is the wrapper's host time plus device time.

Prints the card line, the per-phase numbers, one JSON line each of the
streamed, the partitioned, the distributed-stream, the hybrid, the
sampled, the fault-tolerance, the trace, the data, the moe, the gnn, the
recsys, the cells, the ranks, the examples and the docs phases' numbers,
one JSON line of the kernels and, last, ``{"ok": true, "device":
{...}}``.  Before that line it stops every process it started that is
still running (the shared sampling pools, ``multiprocessing``'s resource
tracker, any child or orphaned grandchild: the script is their
subreaper) and fails if any but those two was left; at exit it stops
them again.  Without a CUDA device, or without the repository around
it, it exits non-zero and prints no result.  ``--only
serve,train,stream,partition,dstream,hybrid,sampled,ft,trace,data,lm,moe,\
gnn,recsys,cells,ranks,examples,docs``
runs the build and the named groups of phases (1–4, 4a–4c, 4d, 4e–4g,
4h–4i, 4j, 4k, 4l, 4m, 4n, 5–7, 8 with phase 6's OLMoE rows when lm is
not named, 9, 10, 11, 12, 13, 14; each of partition, dstream, hybrid, sampled
and ft with its part of 4o; partition and data are held to train's run,
so they need train) and prints no result line.
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import gc
import importlib.util
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL_SPMM = 1e-4
TOL_TTM = 1e-5
TOL_SCORES = 1e-4
TOL_FD = {"float32": 1e-4, "bfloat16": 1e-2}
TOL_LOGITS = 1e-4

NUM_EVENTS = 3_400_000       # ~2.0 M alive edges at the last window
NUM_WINDOWS = 16
REPLAY_WINDOWS = 6           # the CPU replays the first 6 (16 took ~50 s)
BLOCK_SIZE = 8
QUERY_REPS = 30

TRAIN_T = 32                 # cut from the epinions trace's 512 steps
FULL_T = 512                 # the full config's T: its blocks are timed
TRAIN_DENSITY = 1.25         # smoothed snapshots + self-loops ~ 2.1 M slots
TRAIN_STEPS = 10
TRAIN_NB = 4                 # the full config's checkpoint_blocks
TOL_GRAD = 1e-4
PARITY_N, PARITY_T = 65_536, 16
STREAM_SLICE = 8             # the slice schedule's k: T / 8 AdamW steps
STREAM_PARITY_N, STREAM_PARITY_T = 65_536, 8
PART_P4 = 4                  # the rank count whose per-rank shapes are timed
PART_SHARED_N, PART_SHARED_T, PART_SHARED_NB = 65_536, 8, 2
PART_SHARED_STEPS = 4
SHARED_DEADLINE_S = 600      # the shared-card ranks, all checks, start
SHARED_THREADS = 2           # CPU threads a shared-card rank: 6 run at once
DSTREAM_EPOCHS = 2           # the distributed stream: 4 rounds an epoch
DSTREAM_PAIRS = 3            # pipeline_rounds off / on, 1-epoch turns
DSTREAM_SHARED_N, DSTREAM_SHARED_T, DSTREAM_SHARED_NB = 65_536, 8, 2
DRIFT_ATOL = 1e-3            # tests/test_compression_drift.py:43
HYBRID_REPS = 4              # the forward timed in turns with the eager one
HYBRID_SHARED_N, HYBRID_SHARED_T = 65_536, 8
SAMPLED_BLOCK = 4            # block 8 sampled twice the steps a round
SAMPLED_EPOCHS = 1           # 2 took ~90 s more of host sampling
SAMPLED_T = 8                # the first 8 of the trace's 32 steps: 2 rounds
SAMPLED_SMALL_N, SAMPLED_SMALL_T, SAMPLED_SMALL_BLOCK = 65_536, 8, 4
SAMPLED_SMALL_EPOCHS = 2     # the carry store's epoch reset runs too
FT_EVERY = 5                 # eager: 5 steps, checkpoint, resume() to 10
FT_STREAM_EVERY = 2          # streamed_mesh: a checkpoint every 2 rounds
FT_SIGTERM_ROUND = 2         # ... and a SIGTERM in round 2: cursor 3
FT_SHARED_N, FT_SHARED_T, FT_SHARED_NB = 65_536, 8, 2
FT_SCHEDULE = ((1, 1), (3, 2))   # widths 2 -> 1 -> 2, both mid-epoch
FT_LAUNCH_STEPS = 100        # the launcher at the smoke config (was 400)
PROBE_STEPS = 3              # the traced stream's probe: warm + best of 2
TRACE_LAUNCH_STEPS = 20      # the launcher with --trace, smoke config
DATA_ROWS = 30_207_991       # the train trace's raw edge rows (T = 32)
DATA_CHUNK = 1 << 22         # rows a chunk of the out-of-core read
DATA_TSV_N, DATA_TSV_T = 65_536, 8   # the .tsv form, cut

LM_BATCH = 8
LM_PROMPT = 4096
LM_TOKENS = 64
MOONLIGHT_LAYERS = 4         # of 48: its 48 would be 28.06 B parameters
MOONLIGHT_PROMPT, MOONLIGHT_TOKENS = 512, 16
MOE_TRAIN_LAYERS = 4         # of OLMoE's 16: ~30 GB of state, not ~110
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 4096   # train_4k's sequence, batch 256
MOE_TRAIN_STEPS = 10
GNN_ARCHS = ("gatedgcn", "pna", "schnet", "equiformer-v2")
#: the gnn group's runs at full width: each shape with the archs it takes
GNN_RUNS = (("molecule", GNN_ARCHS), ("full_graph_sm", GNN_ARCHS),
            ("minibatch_lg", GNN_ARCHS[:3]))
GNN_STEPS = 10
GNN_PARITY_LAYERS = 2        # EquiformerV2's full widths, card vs CPU
GNN_LAUNCH_STEPS = 5
RECSYS_STEPS = 10
RECSYS_WAVES = {"serve_p99": 20, "serve_bulk": 3}   # after one warm wave
RECSYS_CHUNK = 131_072       # ~18 GB of (chunk, L, 4P) features and hidden
RECSYS_PARITY_BATCH = 256
RECSYS_PARITY_CANDIDATES = 4_096
RECSYS_PARITY_CHUNK = 1_000  # does not divide 4,096: a short last chunk
RECSYS_LAUNCH_STEPS = 3
#: the cells group's card-vs-CPU check of the dyngnn cell: N, T and edges
#: a snapshot (with N self-loops: 327,680 lanes, a multiple of 1,024)
CELLS_PARITY = {"n_nodes": 65_536, "n_steps": 16, "edges_per_snap": 262_144}
#: tests/test_torch_cells.py's BF16_PAYLOAD_TOL: the dyngnn cell's bf16
#: all-to-all payloads may round an element to the neighbouring bf16 value
#: where the card's sums and the CPU's differ in their last bits
TOL_CELL_BF16 = 1e-2
LM_CELL_WARM = 2             # warm decode steps after the cell's first
#: the H100 80GB's ``total_memory`` (bytes), which ``CELLS_STEPPED`` holds to
H100_80GB_BYTES = 85_017_493_504
#: the cells the cells group steps on such a card: those the reckoning fits
#: there that no other group runs (tests/test_torch_dryrun.py pins the
#: same verdicts); OLMoE's long_500k fits with ~1 GB to spare, so memory
#: that the earlier groups leave held could drop it, which fails the phase
CELLS_STEPPED = (
    ("yi-6b", "long_500k"), ("olmoe-1b-7b", "long_500k"),
    ("tmgcn", "dtdg_epinions"), ("tmgcn", "dtdg_flickr"),
    ("tmgcn", "dtdg_amlsim"), ("tmgcn", "dtdg_weak_scale"),
    ("cdgcn", "dtdg_weak_scale"),
    ("evolvegcn", "dtdg_epinions"), ("evolvegcn", "dtdg_flickr"),
    ("evolvegcn", "dtdg_amlsim"), ("evolvegcn", "dtdg_weak_scale"))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def adopt_orphans() -> None:
    """Make this process the subreaper of everything it starts (Linux),
    so a grandchild whose parent exits becomes its child and
    :func:`stop_children` finds it."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)
    except (AttributeError, OSError):   # PR_SET_CHILD_SUBREAPER is Linux's
        pass


def children() -> dict[int, tuple[str, str]]:
    """This process's children -> (state, command line)."""
    me, out = os.getpid(), {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(fields[1]) == me:
            out[int(entry)] = (fields[0], cmd.strip()[:200])
    return out


def stop_children(grace_s: float = 5.0) -> list[str]:
    """Stop every process this one started that is still there: the
    shared sampling pools (``hoststore.sampled.close_worker_pools``),
    ``multiprocessing``'s resource tracker (left alone, it outlives the
    script by the moment it takes to see its pipe close), then any other
    child, SIGTERM and after ``grace_s`` SIGKILL; every exited child is
    reaped -> the command lines of the others that were still running."""
    sampled = sys.modules.get("repro_torch.hoststore.sampled")
    if sampled is not None:
        sampled.close_worker_pools()
    if "multiprocessing.resource_tracker" in sys.modules:
        sys.modules["multiprocessing.resource_tracker"] \
            ._resource_tracker._stop()
    left = {pid: cmd for pid, (state, cmd) in children().items()
            if state not in "ZX"}
    for pid in left:
        os.kill(pid, signal.SIGTERM)
    end = time.monotonic() + grace_s
    while (alive := [pid for pid, (state, _) in children().items()
                     if state not in "ZX"]) and time.monotonic() < end:
        time.sleep(0.05)
    for pid in alive:
        os.kill(pid, signal.SIGKILL)
    for pid in children():
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
    return [f"{pid}: {cmd}" for pid, cmd in left.items()]


# ------------------------------------------------------------ timing -------

class Timer:
    """Median CUDA-event time of ``fn`` over repeated calls, with the L2
    cache flushed before each call (the main path finds its inputs cold).
    The flush reads 64 MB, so L2 is left full of clean lines, as the ops
    before a kernel on the path leave it (weights read by the projections,
    say).  ``flush="write"`` zeroes 64 MB instead, as this script's timer
    once did: the timed call then also writes the flush's dirty lines
    back, which no caller on the path makes it do; it is kept to compare
    with readings taken that way.

    By default each call is queued behind a ~0.6 ms device sleep, so the
    host time a wrapper spends before its launch is hidden: the reading is
    device time only.  With ``host=True`` the device is idle when the
    start event is recorded, so the reading is the wrapper's host time
    before its launch plus the device time."""

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self._read = torch.ones(16 << 20, dtype=torch.float32,
                                device="cuda")
        self._write = torch.empty(64 << 20, dtype=torch.uint8,
                                  device="cuda")

    def _once(self, fn, host: bool, flush: str) -> float:
        torch = self.torch
        if flush == "read":
            self._read.sum()
        else:
            self._write.zero_()
        if host:
            torch.cuda.synchronize()
        else:
            torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def __call__(self, fn, host: bool = False, flush: str = "read"
                 ) -> float:
        for _ in range(3):
            fn()
        return statistics.median(self._once(fn, host, flush)
                                 for _ in range(self.reps))

    def turns(self, fns: dict) -> dict:
        """Device time of each of ``fns``, the calls taken in turns (a,
        b, a, b, ...) so the card's drift falls on all alike ->
        {name: median ms}."""
        for fn in fns.values():
            for _ in range(3):
                fn()
        times = {k: [] for k in fns}
        for _ in range(self.reps):
            for k, fn in fns.items():
                times[k].append(self._once(fn, False, "read"))
        return {k: statistics.median(v) for k, v in times.items()}


def bound_ms(nbytes: float, flops: float, peak_flops: float = 67e12,
             bw: float = 3.35e12) -> tuple[float, str]:
    """Least time on an H100 SXM (3.35 TB/s; fp32 outside the tensor cores
    67 TFLOP/s): the larger of bytes / bandwidth and ops / peak."""
    t_b, t_f = nbytes / bw * 1e3, flops / peak_flops * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def alternating_walls(torch, variants: dict, rounds: int, warm: int = 1
                      ) -> dict:
    """Host-clock ms of each variant's call (ending in a sync), the
    variants taken in turns so the host's drift falls on all alike ->
    {name: median over rounds - warm}."""
    walls = {k: [] for k in variants}
    for _ in range(rounds):
        for k, fn in variants.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v[warm:]) for k, v in walls.items()}


#: profiler windows tried before a trace with no device time fails
PROFILE_ATTEMPTS = 3


def device_profile(torch, fn, ranges: dict | None = None,
                   host_top: list | None = None, host: bool = True,
                   exclusive: dict | None = None
                   ) -> tuple[float, float, dict]:
    """``fn()`` twice under ``torch.profiler``, the first call in its
    warm-up cycle, the second recorded -> (wall us, device busy us,
    {device activity name: [us, ...]}) of the second.  A window opened
    without that cycle late in a long process could lose its first
    activities (DIN's step read 507 activities and 41.4 ms busy in a whole
    run against 562 and 66.4 ms alone, its step time the same); ``fn``
    must bear being called twice, and twice more for each window that
    comes back with no device activity at all (up to
    ``PROFILE_ATTEMPTS`` windows; one did, in a whole run).  Device
    activities only (kernels, copies, sets), each with its own duration.
    Busy is the time the union of their spans covers: activities can
    overlap (copies on a side stream, NCCL's kernels, and a kernel
    launched as a programmatic dependent, ``flash_decode``'s combine,
    which starts while the one before it runs and waits on the SMs), so
    the durations can add up to more; both sums are logged.
    ``exclusive``, when given, receives
    {name: [us, ...]}: each activity's time beyond the spans of those that
    started before it (these add up to busy; an activity wholly inside
    another gets 0).  The ranges that annotate device
    work (NCCL's ``nccl:all_to_all`` spans its copy) are not activities:
    they go to ``ranges`` ({name: [us, ...]}) when it is given; the 15
    host operations of most self time to ``host_top`` ([(name, us,
    calls)]), when it is given.  ``host=False`` records the device alone,
    which collects faster for a step of tens of thousands of host
    operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if host else []),
                schedule=schedule(wait=0, warmup=1, active=1,
                                  repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
        by_name: dict[str, list[float]] = {}
        found: dict[str, list[float]] = {}
        own: dict[str, list[float]] = {}
        spans = []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if (getattr(e, "is_user_annotation", False)
                        or e.name.startswith("nccl:")):
                    found.setdefault(e.name, []).append(
                        e.time_range.elapsed_us())
                else:
                    by_name.setdefault(e.name, []).append(
                        e.time_range.elapsed_us())
                    spans.append((e.time_range.start, e.time_range.end,
                                  e.name))
        covered = float("-inf")
        for start, end, name in sorted(spans):
            own.setdefault(name, []).append(
                max(0.0, end - max(start, covered)))
            covered = max(covered, end)
        busy = sum(sum(v) for v in own.values())
        if busy > 0:
            break
        # the tracer's window once came back empty in a long process
        log(f"profile: attempt {attempt + 1} recorded no device time")
    else:
        raise SystemExit("profile: the trace holds no device time")
    log(f"profile: device busy {busy / 1e3:.3f} ms (union of the spans), "
        f"durations summed {sum(map(sum, by_name.values())) / 1e3:.3f} ms")
    if exclusive is not None:
        exclusive.update(own)
    if ranges is not None:
        ranges.update(found)
    if host_top is not None:
        host_top.extend(sorted(
            ((a.key, a.self_cpu_time_total, a.count)
             for a in prof.key_averages()), key=lambda r: -r[1])[:15])
    return wall_us, busy, by_name


#: device activities by kind, first match wins (substrings of the names)
KINDS = (("banded_ttm_t", ("banded_ttm_t",)),
         ("banded_ttm", ("banded_ttm",)),
         ("segment_spmm", ("spmm",)),
         ("flash_decode", ("flash_decode",)),
         ("GEMMs", ("gemm", "xmma", "cutlass")),
         ("stack / cat copies", ("CatArrayBatchedCopy",)),
         ("other copies", ("copy", "Memcpy")),
         ("fills", ("FillFunctor", "Memset")),
         ("gradient adds", ("CUDAFunctor_add",)))


def by_kind(by_name: dict) -> dict:
    """{device activity name: [us]} -> {kind: {"ms", "count"}}; what no
    kind names is "other"."""
    out = {k: {"ms": 0.0, "count": 0} for k, _ in KINDS + (("other", ()),)}
    for name, v in by_name.items():
        kind = next((k for k, subs in KINDS if any(x in name for x in subs)),
                    "other")
        out[kind]["ms"] += sum(v) / 1e3
        out[kind]["count"] += len(v)
    return out


def fd_exclusive_us(by_name: dict, own: dict) -> float:
    """``flash_decode``'s device us in a profile: its partial kernels' own
    spans and its combines' time beyond the spans before them (the
    combine, a programmatic dependent, starts while the partial kernel
    runs and waits on the SMs until it ends)."""
    return (sum(sum(v) for k, v in by_name.items()
                if "flash_decode_partial" in k)
            + sum(sum(v) for k, v in own.items()
                  if "flash_decode_combine" in k))


# ------------------------------------------------------------ serving ------

def serve_run(device: str, params, n: int, events, max_edges: int,
              num_windows: int, windows: int | None = None,
              on_window=None):
    """Push each window's events, advance it; -> (engine, per-window ms).
    ``windows`` stops after the first so many of the ``num_windows``;
    ``on_window(k, engine)`` runs after window k's advance (untimed)."""
    from repro_torch.configs import registry
    from repro_torch.core.ctdg import EventStream
    from repro_torch.serve import IngestSpec, ServeConfig, ServeEngine

    spec = IngestSpec(num_windows=num_windows, policy="snapshot",
                      time_range=(float(events.time.min()),
                                  float(events.time.max())),
                      block_size=BLOCK_SIZE, max_edges=max_edges)
    cfg = dataclasses.replace(
        registry.get_arch("paper_dyngnn").make_config(), num_nodes=n)
    eng = ServeEngine(ServeConfig(arch="paper_dyngnn", model=cfg,
                                  ingest=spec), params=params,
                      device=device)
    win = spec.window_of(events.time)
    cuts = [0] + [int((win <= k).sum()) for k in range(num_windows)]
    advance_ms = []
    for k in range(windows or num_windows):
        sl = slice(cuts[k], cuts[k + 1])
        eng.ingest(EventStream(events.src[sl], events.dst[sl],
                               events.time[sl], events.kind[sl], n))
        t0 = time.perf_counter()
        eng.advance(1)
        advance_ms.append((time.perf_counter() - t0) * 1e3)
        if on_window is not None:
            on_window(k, eng)
    return eng, advance_ms


def percentiles(ms: list[float]) -> str:
    return (f"p50 {statistics.median(ms):.3f} ms, "
            f"p95 {sorted(ms)[int(0.95 * (len(ms) - 1))]:.3f} ms")


def check_launches(path: str, launches: dict, want: dict) -> None:
    log(f"[{path}] launches on the path: {launches}")
    for name, n in want.items():
        if launches[name] != n:
            raise SystemExit(f"kernel {name}: {launches[name]} launches on "
                             f"the {path} path, expected {n}")


def main_path(torch, kernels, obs, n_nodes: int, max_edges: int):
    """Phase 2: the full-width serving run on the kernel path."""
    import numpy as np

    from repro_torch.core.ctdg import synthetic_ctdg
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    t0 = time.perf_counter()
    events = synthetic_ctdg(n_nodes, NUM_EVENTS, delete_frac=0.2, seed=0)
    log(f"[serve] {len(events)} events generated on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(2)
    ids, pairs = rng.integers(0, n_nodes, 64), rng.integers(0, n_nodes,
                                                           (64, 2))
    replay = {"ids": ids, "pairs": pairs}

    def keep_state(k, eng):
        # the served state after the last window the CPU replays
        if k == REPLAY_WINDOWS - 1:
            replay.update(z=eng.z.cpu(), nodes=eng.query_nodes(ids),
                          links=eng.query_links(pairs))

    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced phase spans
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    eng, advance_ms = serve_run("cuda", None, n_nodes, events, max_edges,
                                NUM_WINDOWS, on_window=keep_state)
    launches = {k.name: k.launches for k in kernels}
    builds = spmm_ops.csr_builds
    obs.configure(enabled=False)
    check_launches("serve", launches, {"segment_spmm": 2 * NUM_WINDOWS,
                                       "banded_ttm": 2 * NUM_WINDOWS,
                                       "banded_ttm_t": 0,
                                       "flash_decode": 0})
    log(f"[serve] CSR builds on the path: {builds} (one per snapshot; "
        f"{launches['segment_spmm']} segment_spmm launches read them)")
    if builds != NUM_WINDOWS:
        raise SystemExit(f"segment_spmm: {builds} CSR builds in "
                         f"{NUM_WINDOWS} windows, expected {NUM_WINDOWS}")
    launches["csr_builds"] = builds
    alive = int(eng.applier.current[1].sum())
    r = eng.result()
    log(f"[serve] windows={r.windows_advanced} alive edges at the last "
        f"window={alive} resyncs={r.resyncs}")
    log(f"[serve] ingest+advance {r.ingest_seconds:.3f} s -> "
        f"{r.events_per_s:.0f} events/s")
    log("[serve] advance ms per window: "
        + ", ".join(f"{v:.1f}" for v in advance_ms))
    phases = {}
    for sp in tracer.spans():
        phases.setdefault(sp.name, []).append(sp.dur_s * 1e3)
    log("[serve] per-window phases (fenced spans, median / max ms): "
        + ", ".join(f"{name.split('.')[-1]} "
                    f"{statistics.median(phases[name]):.1f} / "
                    f"{max(phases[name]):.1f}"
                    for name in ("serve.encode", "serve.stage",
                                 "serve.apply", "serve.step")))
    log(f"[serve] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    rng = np.random.default_rng(1)
    for b in (1, 8, 64):
        lat = []
        for _ in range(QUERY_REPS):
            ids = rng.integers(0, n_nodes, b)
            t0 = time.perf_counter()
            out = eng.query_nodes(ids)
            lat.append((time.perf_counter() - t0) * 1e3)
            if out.shape != (b, 2) or not np.isfinite(out).all():
                raise SystemExit(f"query_nodes batch {b}: bad scores "
                                 f"{out.shape}")
        log(f"[query] nodes batch {b}: {percentiles(lat)}")
    lat = []
    for _ in range(QUERY_REPS):
        pairs = rng.integers(0, n_nodes, (64, 2))
        t0 = time.perf_counter()
        out = eng.query_links(pairs)
        lat.append((time.perf_counter() - t0) * 1e3)
        if out.shape != (64, 2) or not np.isfinite(out).all():
            raise SystemExit(f"query_links: bad logits {out.shape}")
    log(f"[query] links 64 pairs: {percentiles(lat)}")
    return eng, events, launches, replay


# ------------------------------------------------------- kernel checks -----

def check_close(name: str, got, want, tol: float) -> float:
    err = float((got - want).abs().max())
    limit = tol + tol * float(want.abs().max())
    if not (err <= limit):
        raise SystemExit(f"{name}: kernel disagrees with its plain version:"
                         f" max |diff| {err:.3e} > {limit:.3e}")
    return err


def spmm_faults(name: str, ops, x, row_ptr, col, w, want
                ) -> dict:
    """Show that the segment SpMM check rejects two faulty outputs made on
    the card: zeros, and the kernel run with each row's last edge dropped
    (its weight set to 0) -> {fault: max |diff| over the limit}."""
    last = row_ptr[1:] - 1
    last = last[row_ptr[1:] > row_ptr[:-1]].long()
    w_cut = w.clone()
    w_cut[last] = 0.0
    limit = TOL_SPMM * (1.0 + float(want.abs().max()))
    faults = {
        "zeros": float(want.abs().max()) / limit,
        "last edge dropped": float((ops.segment_spmm_csr(
            x, row_ptr, col, w_cut) - want).abs().max()) / limit}
    for fault, ratio in faults.items():
        if ratio <= 1.0:
            raise SystemExit(f"segment_spmm {name}: the check would pass a "
                             f"kernel that wrote {fault} ({ratio:.3f} x "
                             "its limit)")
    return faults


def check_spmm(torch, eng, timer):
    """Segment SpMM on the last window's graph (with self-loops), at the
    path's F = 2 (layer 1) and 6 (layer 2) and the generic instance's
    F = 9 and 32, then on a fully skewed graph; each held to the plain
    version, shown to reject two faulty outputs, and timed."""
    from repro_torch.graph import segment
    from repro_torch.kernels.segment_spmm import ops, ref
    from repro_torch.stream.train_loop import (make_self_loops,
                                               slice_weights_with_loops)

    n = eng.model.num_nodes
    edges, mask = eng.applier.current
    # snapshot policy: every valid lane's value is 1, so values == mask
    e_full, w_full = slice_weights_with_loops(
        n, *make_self_loops(n, edges.device), edges[None], mask[None],
        mask[None])
    e, w = e_full[0], w_full[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    valid = w != 0
    deg = torch.stack([segment.in_degree(e, n, valid),
                       segment.out_degree(e, n, valid)], dim=1)
    row_ptr, col, wc = ops.build_csr(e, w, n)
    nnz = int(row_ptr[-1])
    results = []
    err_all = 0.0
    build_ms = timer(lambda: ops.build_csr(e, w, n))
    for f, x in ((2, deg.contiguous()),
                 (6, torch.randn((n, 6), generator=gen, device="cuda")),
                 (9, torch.randn((n, 9), generator=gen, device="cuda")),
                 (32, torch.randn((n, 32), generator=gen, device="cuda"))):
        got = ops.segment_spmm_csr(x, row_ptr, col, wc)
        want = ref.segment_spmm_csr_ref(x, row_ptr, col, wc)
        torch.cuda.synchronize()
        err = check_close(f"segment_spmm F={f}", got, want, TOL_SPMM)
        faults = spmm_faults(f"F={f}", ops, x, row_ptr, col, wc,
                             want)
        err_all = max(err_all, err)
        csr = torch.sparse_csr_tensor(row_ptr, col[:nnz], wc[:nnz],
                                      size=(n, n), check_invariants=False)
        lib_err = float((torch.sparse.mm(csr, x) - want).abs().max())
        nbytes = (x.nbytes + row_ptr.nbytes + nnz * 8 + got.nbytes)
        b_ms, b_by = bound_ms(nbytes, 2.0 * nnz * f)

        def kern(x=x):
            return ops.segment_spmm_csr(x, row_ptr, col, wc)

        row = {
            "F": f, "edges": int(e.shape[0]), "nnz": nnz,
            "ms": timer(kern), "wrapper_ms": timer(kern, host=True),
            "with_csr_ms": timer(lambda x=x: ops.segment_spmm(x, e, w, n)),
            "with_csr_wrapper_ms": timer(
                lambda x=x: ops.segment_spmm(x, e, w, n), host=True),
            "csr_build_ms": build_ms,
            "plain_ms": timer(lambda x=x: ref.segment_spmm_csr_ref(
                x, row_ptr, col, wc)),
            "library_ms": timer(lambda x=x, csr=csr: torch.sparse.mm(csr,
                                                                     x)),
            "ms_write_flush": timer(kern, flush="write"),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "fault_over_limit": faults,
            "library_max_abs_err": lib_err}
        log(f"[kernel] segment_spmm F={f}: kernel {row['ms']:.4f} ms "
            f"(wrapper, host + device {row['wrapper_ms']:.4f}; with its "
            f"CSR build {row['with_csr_ms']:.4f}, wrapper "
            f"{row['with_csr_wrapper_ms']:.4f}), CSR build {build_ms:.4f}, "
            f"plain {row['plain_ms']:.4f}, torch.sparse.mm "
            f"{row['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}); with "
            f"a write flush: kernel {row['ms_write_flush']:.4f}")
        log(f"[kernel]   max|err| {err:.2e}; faults rejected at x limit: "
            f"zeros {faults['zeros']:.1f}, last edge dropped "
            f"{faults['last edge dropped']:.1f}")
        results.append(row)
    # fully skewed: every edge into one destination, pad lanes at (0, 0);
    # weights in [0.5, 1), so the one dropped edge of the fault below
    # stands out of a row summed over 32 K edges
    m = 1 << 16
    src = torch.randint(0, n, (m,), generator=gen, device="cuda")
    sk = torch.stack([src, torch.full_like(src, 7)], 1).to(torch.int32)
    sw = 0.5 + 0.5 * torch.rand((m,), generator=gen, device="cuda")
    sw[m // 2:] = 0.0
    sk[m // 2:] = 0
    s_csr = ops.build_csr(sk, sw, n)
    skew_err, skew_rows = 0.0, []
    for f in (2, 6, 9, 32):
        x = torch.randn((n, f), generator=gen, device="cuda")
        got = ops.segment_spmm(x, sk, sw, n)
        want = ref.segment_spmm_csr_ref(x, *s_csr)
        torch.cuda.synchronize()
        err = check_close(f"segment_spmm skewed F={f}", got, want, TOL_SPMM)
        faults = spmm_faults(f"skewed F={f}", ops, x, *s_csr, want)
        skew_err = max(skew_err, err)
        row = {"F": f, "max_abs_err": err, "fault_over_limit": faults,
               "ms": timer(lambda x=x: ops.segment_spmm_csr(x, *s_csr))}
        skew_rows.append(row)
        log(f"[kernel] segment_spmm skewed F={f} ({m} lanes into one row, "
            f"half of them zero-weight pads): max|err| {err:.2e}, faults "
            f"rejected at x limit: zeros {faults['zeros']:.1f}, last edge "
            f"dropped {faults['last edge dropped']:.1f}; kernel "
            f"{row['ms']:.4f} ms")
    return results, err_all, skew_err, skew_rows


def band_cost(t_s: int, nf: int, window: int, t_offset: int, lead: int,
              all_rows: bool = False) -> tuple[float, float]:
    """Bytes and operations of the forward M over [prefix (lead rows); x
    (t_s rows)], row 0 at global index ``t_offset``: it reads the rows
    that lie in a kept band, rows max(0, lead - w + 1, -t_offset) on, and
    writes the t_s kept rows; one multiply-add per band entry and column
    of a written row.  ``all_rows``: the earlier contract, which read
    every row from global step 1 on and wrote all lead + t_s rows."""
    rows, step1 = lead + t_s, max(0, -t_offset)
    first = 0 if all_rows else lead
    lo = step1 if all_rows else max(step1, lead - window + 1)
    nnz = sum(t - max(step1, t - window + 1) + 1
              for t in range(max(first, step1), rows))
    read = max(0, rows - lo)
    return float((read + rows - first) * nf * 4), float(nnz * nf)


def band_t_cost(t_s: int, nf: int, window: int, t_offset: int, lead: int,
                first: int) -> tuple[float, float]:
    """Bytes and operations of M^T over the kept rows: dZ (t_s, nf) of
    rows lead .. lead + t_s - 1 of a (lead + t_s)-row tensor, rows
    first .. lead + t_s - 1 written; a dZ row counts when it lies in some
    written band (at or after global step 1 and row first); one
    multiply-add per band entry and column."""
    rows = lead + t_s
    lo = max(first, -t_offset, 0)
    nnz = sum(t - max(lo, t - window + 1) + 1
              for t in range(max(lead, lo), rows))
    read = max(0, rows - max(lead, lo))
    return float((read + rows - first) * nf * 4), float(nnz * nf)


def band_matrix(torch, t: int, window: int, t_offset: int):
    """The dense (t, t) M of ``banded_ttm`` on the card (a yardstick)."""
    m = torch.zeros((t, t), device="cuda")
    for r in range(t):
        g = r + t_offset + 1
        for k in range(max(0, r - window + 1, -t_offset), r + 1):
            m[r, k] = 1.0 / min(window, g)
    return m


def check_ttm(torch, n: int, window: int, timer):
    """``banded_ttm`` at serving's call: the (w - 1)-row prefix carry and
    one new row of N x 6 columns, one row written; at the first window's
    t_offset (-4: the prefix lies before global step 1), 0, 37 and the
    last window's (the main row)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    main_off = NUM_WINDOWS - 1 - (window - 1)   # the last window's prefix
    rows = band_rows(torch, gen, n, window, timer, [
        (1, window - 1, off) for off in (-4, 0, 37, main_off)])
    return dict(rows[-1], max_abs_err=max(r["max_abs_err"] for r in rows),
                offsets=rows)


# ------------------------------------------------------------ profile ------

def profile_step(torch, eng):
    """The state-advance step alone, on the last window's graph: steady
    time over a few repeats, then one step under ``torch.profiler`` for
    device time by kernel and the device's idle share of the step."""
    from repro_torch.graph import segment

    n = eng.model.num_nodes
    edges, mask = eng.applier.current
    frame = torch.stack([segment.in_degree(edges, n, mask),
                         segment.out_degree(edges, n, mask)], dim=1)

    def step():
        carries = [c.clone() for c in eng.carries]
        return eng._advance(eng.params, carries, frame, edges, mask, mask,
                            NUM_WINDOWS)

    steady = alternating_walls(torch, {"step": step}, 7)["step"]
    log(f"[profile] state-advance step (warm, host clock + sync, median of "
        f"6): {steady:.3f} ms")
    wall_us, busy, by_name = device_profile(torch, step)
    log(f"[profile] one step under the profiler: wall {wall_us / 1e3:.2f} "
        f"ms, device busy {busy / 1e3:.2f} ms, idle share "
        f"{1 - busy / wall_us:.3f}, {sum(map(len, by_name.values()))} "
        f"device activities")
    for name, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[profile]   {sum(v) / 1e3:8.3f} ms  x{len(v):<3d} {name[:90]}")
    return {"steady_ms": steady, "wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us}


# ------------------------------------------------------- plain parity ------

def plain_parity(eng, events, replay: dict):
    """The run's first ``REPLAY_WINDOWS`` windows replayed on the CPU,
    where the kernel wrappers run their plain versions: that window's
    embeddings and queries, card (kernels, kept by the main path) against
    CPU (plain).  (All 16 windows took 47.5-60.6 s of host time.)"""
    import numpy as np

    n = eng.model.num_nodes
    plain, _ = serve_run("cpu", eng.params, n, events,
                         eng.applier.max_edges, NUM_WINDOWS,
                         windows=REPLAY_WINDOWS)
    z_err = float((replay["z"] - plain.z).abs().max())
    err = max(np.abs(replay["nodes"]
                     - plain.query_nodes(replay["ids"])).max(),
              np.abs(replay["links"]
                     - plain.query_links(replay["pairs"])).max())
    if not (err <= TOL_SCORES and z_err <= TOL_SCORES):
        raise SystemExit(f"served state: card (kernels) vs CPU (plain) "
                         f"max |diff| z {z_err:.3e}, scores {err:.3e} > "
                         f"{TOL_SCORES}")
    log(f"[serve] the first {REPLAY_WINDOWS} of {NUM_WINDOWS} windows "
        f"replayed on the CPU (plain versions): window "
        f"{REPLAY_WINDOWS - 1}'s z max |diff| {z_err:.2e}, queries max "
        f"|diff| {err:.2e} (tolerance {TOL_SCORES})")


def small_parity(torch):
    """Small graphs, all three models: card (kernels) vs CPU (plain),
    after every window."""
    import numpy as np

    from repro_torch.core import models as mdl
    from repro_torch.core.ctdg import synthetic_ctdg
    from repro_torch.serve import IngestSpec, ServeConfig, ServeEngine

    n, windows = 40, 12
    ev = synthetic_ctdg(n, 500, delete_frac=0.25, seed=1)
    spec = IngestSpec(num_windows=windows, block_size=4, max_edges=512,
                      time_range=(float(ev.time.min()),
                                  float(ev.time.max())))
    for model in ("tmgcn", "cdgcn", "evolvegcn"):
        cfg = mdl.DynGNNConfig(model=model, num_nodes=n, window=3)
        params = mdl.init_params(torch.Generator().manual_seed(7), cfg)
        gpu = ServeEngine(ServeConfig(model=cfg, ingest=spec),
                          params=params, device="cuda")
        cpu = ServeEngine(ServeConfig(model=cfg, ingest=spec),
                          params=params, device="cpu")
        gpu.ingest(ev)
        cpu.ingest(ev)
        err = 0.0
        for _ in range(windows):
            gpu.advance()
            cpu.advance()
            err = max(err, np.abs(gpu.query_nodes(np.arange(n))
                                  - cpu.query_nodes(np.arange(n))).max())
        if not err <= TOL_SCORES:
            raise SystemExit(f"small {model}: card vs CPU max |diff| "
                             f"{err:.3e} > {TOL_SCORES}")
        log(f"[parity] {model} N={n}: card (kernels) vs CPU (plain), "
            f"{windows} windows, max |diff| {err:.2e}")


# ------------------------------------------------------------ training -----

def train_trace(n_nodes: int, window: int):
    """The training trace's spec: T = 32 steps at N = ``n_nodes``,
    M-transform smoothed (~2.1 M edge slots with self-loops)."""
    from repro_torch.run import SyntheticTrace

    return SyntheticTrace(num_nodes=n_nodes, num_steps=TRAIN_T,
                          density=TRAIN_DENSITY, churn=0.1,
                          smoothing_mode="mproduct", window=window, seed=0)


TRACE_CHILD = """
import json, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from repro_torch.data.dyngnn import dataset_from_snapshots
from repro_torch.graph.generate import evolving_dynamic_graph
spec = json.loads(sys.argv[3])
t0 = time.perf_counter()
raw = evolving_dynamic_graph(spec["num_nodes"], spec["num_steps"],
                             spec["density"], spec["churn"], spec["seed"])
t1 = time.perf_counter()
ds = dataset_from_snapshots(raw, spec["num_nodes"],
                            smoothing_mode=spec["smoothing_mode"],
                            window=spec["window"],
                            edge_life=spec["edge_life"])
t2 = time.perf_counter()
arrays = {"frames": ds.frames, "labels": ds.labels}
for key, seq in (("raw", raw), ("snap", ds.snapshots), ("val", ds.values)):
    arrays.update({f"{key}{i}": a for i, a in enumerate(seq)})
np.savez(sys.argv[2], **arrays)
print(json.dumps({"generate_s": t1 - t0, "dataset_s": t2 - t1,
                  "write_s": time.perf_counter() - t2}))
"""


class TrainTraceJob:
    """``train_trace``'s raw snapshots and dataset made on the host in a
    child process (``TRACE_CHILD``: the same generator and smoothing, so
    the same arrays as made here) that the script starts before the serve
    group, so that the host's numpy work runs beside the serve group's
    card work; ``train_path`` reads them.  A process and not a thread: a
    thread would share this process's interpreter lock with the kernel
    timings of the serve group."""

    def __init__(self, n_nodes: int, window: int):
        import tempfile

        self.spec = train_trace(n_nodes, window)
        self.dir = Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
        self.out = self.dir / "trace.npz"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", TRACE_CHILD, str(SRC), str(self.out),
             json.dumps(dataclasses.asdict(self.spec))],
            cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self):
        """-> (raw snapshots, ``DTDGDataset``, seconds: the child's
        stages, its whole run and what this process waited and read)."""
        import shutil

        import numpy as np

        from repro_torch.data.dyngnn import DTDGDataset

        t1 = time.perf_counter()
        try:
            stdout, stderr = self.proc.communicate(timeout=900)
            if self.proc.returncode != 0:
                raise SystemExit(f"train trace: the child exited "
                                 f"{self.proc.returncode}:\n"
                                 f"{stderr[-2000:]}")
            waited = time.perf_counter() - t1
            seconds = json.loads(stdout.strip().splitlines()[-1])
            seconds["child_s"] = time.perf_counter() - self.t0
            with np.load(self.out) as z:
                arrays = {k: z[k] for k in z.files}
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.communicate()
            shutil.rmtree(self.dir, ignore_errors=True)
        t = self.spec.num_steps

        def seq(key):
            return [arrays.pop(f"{key}{i}") for i in range(t)]

        raw, snaps, vals = seq("raw"), seq("snap"), seq("val")
        ds = DTDGDataset(snapshots=snaps, values=vals,
                         frames=arrays.pop("frames"),
                         labels=arrays.pop("labels"),
                         num_nodes=self.spec.num_nodes)
        seconds.update(waited_s=waited,
                       read_s=time.perf_counter() - t1 - waited)
        return raw, ds, seconds


def train_launches(layers: int, t: int, nb: int) -> dict:
    """Launches of ``TRAIN_STEPS`` blocked TM-GCN steps: per step the
    aggregate forward (L T), again in each block's recompute (L T) and
    backward for every layer but the first (T); the M-product forward
    (L nb), in the recompute up to the block's last saved tensor, layer
    2's relu (nb: early stop), backward (L nb)."""
    return {"segment_spmm": TRAIN_STEPS * (2 * layers * t + t),
            "banded_ttm": TRAIN_STEPS * (layers * nb + nb),
            "banded_ttm_t": TRAIN_STEPS * layers * nb, "flash_decode": 0}


def train_path(torch, kernels, obs, n_nodes: int, trace: TrainTraceJob):
    """The training path: ``paper_dyngnn`` (TM-GCN) at the full config's
    widths through ``repro_torch.run.Engine(device="cuda")`` — 10 AdamW
    steps of the blocked-checkpoint trainer (nb 4) over a T = 32 synthetic
    trace at N = 755,200, then link-prediction evaluation -> (the padded
    batch, the path's numbers, the trace's dataset, which the streamed
    phase trains on again, and its raw snapshots, which the data group
    writes).  The trace is ``train_trace``'s, made in its two stages so
    the raw snapshots are kept, by ``trace`` beside the serve group."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core import checkpoint as ckpt
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import Engine, ExecutionPlan, InMemoryDTDG, \
        RunConfig

    cfg = registry.get_arch("paper_dyngnn").make_config()
    if (trace.spec.num_nodes, trace.spec.window) != (n_nodes, cfg.window):
        raise SystemExit(f"train trace: made for {trace.spec}, not N "
                         f"{n_nodes}, w {cfg.window}")
    raw, ds, made = trace.result()
    t0 = time.perf_counter()
    eng = Engine(RunConfig(model=cfg, data=InMemoryDTDG(ds),
                           plan=ExecutionPlan(num_steps=TRAIN_STEPS),
                           log_fn=log), device="cuda")
    rr = eng.resolve()
    pipe, nb = rr.pipeline, rr.cfg.checkpoint_blocks
    log(f"[train] {cfg.model}: trace N={n_nodes}, T={TRAIN_T}, density "
        f"{TRAIN_DENSITY} + M-transform (w {cfg.window}) + self-loops, made "
        f"on the host in a child process beside the serve group in "
        f"{made['child_s']:.1f} s (generate {made['generate_s']:.1f}, "
        f"smooth and features {made['dataset_s']:.1f}, write "
        f"{made['write_s']:.1f}; waited {made['waited_s']:.1f}, read "
        f"{made['read_s']:.1f} here), pipeline resolved in "
        f"{time.perf_counter() - t0:.1f} s: max_edges "
        f"{pipe.max_edges} (DATASETS['epinions']: 2,097,152), graph-diff "
        f"bytes {pipe.transfer_bytes()['ratio']:.3f} of naive")
    t0 = time.perf_counter()
    batch = pipe.batch
    torch.cuda.synchronize()
    batch_bytes = sum(t.nbytes for t in (batch.edges, batch.edge_weights,
                                         batch.edge_mask, batch.frames))
    log(f"[train] padded batch {batch_bytes / 1e9:.3f} GB on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced train.step spans
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    builds = spmm_ops.csr_builds
    obs.configure(enabled=False)
    peak = torch.cuda.max_memory_allocated()
    layers, t = cfg.num_layers, TRAIN_T
    check_launches("train", launches, train_launches(layers, t, nb))
    log(f"[train] CSR builds: {builds} (a forward and a transposed CSR per "
        "snapshot, once per run)")
    if builds != 2 * t:
        raise SystemExit(f"train: {builds} CSR builds, expected {2 * t}")
    launches["csr_builds"] = builds
    losses = res.losses
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise SystemExit(f"train: bad losses {losses}")
    spans = tracer.spans()
    step_ms = [sp.dur_s * 1e3 for sp in spans if sp.name == "train.step"]
    build_ms = [sp.dur_s * 1e3 for sp in spans
                if sp.name == "train.csr_build"]
    if len(step_ms) != TRAIN_STEPS or len(build_ms) != 1:
        raise SystemExit(f"train: {len(step_ms)} train.step spans, "
                         f"{len(build_ms)} train.csr_build spans")
    est = ckpt.activation_memory_estimate(rr.cfg, pipe.max_edges, nb)
    csr_bytes = sum(x.nbytes for pair in batch.csr_pairs() for c in pair
                    for x in c)
    log("[train] losses: " + ", ".join(f"{v:.5f}" for v in losses))
    log(f"[train] fit {fit_s:.2f} s; train.step (fenced spans): first "
        f"{step_ms[0]:.1f} ms (of which the 2 T CSR builds, fenced, "
        f"{build_ms[0]:.1f} ms), median of the rest "
        f"{statistics.median(step_ms[1:]):.1f} ms, median of all "
        f"{statistics.median(step_ms):.1f} ms")
    log(f"[train] peak device memory {peak / 2**30:.3f} GiB "
        f"({peak / 1e9:.3f} GB): batch {batch_bytes / 1e9:.3f} GB, CSR "
        f"pairs {csr_bytes / 1e9:.3f} GB; activation_memory_estimate(nb "
        f"{nb}) total {est['total'] / 1e9:.3f} GB (intra-block "
        f"{est['intra_block'] / 1e9:.3f}, checkpoints "
        f"{est['checkpoint'] / 1e9:.3f})")
    t0 = time.perf_counter()
    acc = eng.evaluate(res)
    log(f"[train] link-pred acc {acc:.3f} ({time.perf_counter() - t0:.1f} "
        "s)")

    step_fn = rr.cache["eager_step"]
    labels = torch.from_numpy(rr.ds.labels).cuda()
    state = {"params": res.state.params, "opt": res.state.opt_state}

    def one_step():
        state["params"], state["opt"], _ = step_fn(
            state["params"], state["opt"], batch, labels)

    steady = alternating_walls(torch, {"step": one_step}, 7)["step"]
    log(f"[profile-train] warm step (host clock + sync, median of 6): "
        f"{steady:.1f} ms")
    host_top: list = []
    wall_us, busy, by_name = device_profile(torch, one_step,
                                            host_top=host_top)
    kinds = by_kind(by_name)
    # the forward M-product reads [prefix, slice] where they lie: its
    # device time is its kernel's alone
    fwd = kinds["banded_ttm"]
    prof = {"steady_ms": steady, "wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "activities": sum(map(len, by_name.values())), "by_kind": kinds,
            "host_top": host_top,
            "forward_mproduct_ms": fwd["ms"],
            "forward_mproduct_launches": fwd["count"]}
    log(f"[profile-train] one step under the profiler: wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
        f"share {1 - busy / wall_us:.3f}, {prof['activities']} device "
        f"activities; the forward M-product {fwd['ms']:.3f} ms in "
        f"{fwd['count']} banded_ttm launches, no copy")
    for name, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[profile-train]   {sum(v) / 1e3:8.3f} ms  x{len(v):<4d} "
            f"{name[:90]}")
    log("[profile-train] device time by kind, ms (launches):")
    for kind, v in kinds.items():
        log(f"[profile-train]   {kind:20s} {v['ms']:8.3f} ({v['count']:4d})")
    stats = {"losses": losses, "step_ms": step_ms,
             "step_ms_median": statistics.median(step_ms),
             "step_ms_median_after_first": statistics.median(step_ms[1:]),
             "csr_build_ms": build_ms[0],
             "fit_s": fit_s, "peak_bytes": peak, "batch_bytes": batch_bytes,
             "csr_bytes": csr_bytes, "activation_estimate": est,
             "max_edges": pipe.max_edges, "link_pred_acc": acc,
             "launches": launches, "profile": prof}
    return batch, stats, rr.ds, pipe, raw


def check_backward(torch, batch, n: int, window: int, timer):
    """The kernels at the train path's shapes, held to their plain
    versions, each shown to reject faulty outputs, and timed beside its
    bound, its plain version and its library call: ``segment_spmm`` on the
    last snapshot's transposed CSR at F = 6 (the backward); ``banded_ttm``
    (forward and recompute) on the blocks' [prefix (w - 1 rows); slice
    (bsize rows)] with t_offset -4 (block 0) and +4 (block 1; blocks 2 and
    3 read the same full band at +12, +20), on (T, N x 6) over an empty
    prefix and on the full config's block; ``banded_ttm_t`` (the backward)
    at the same four; then both bands' sweeps at small shapes."""
    from repro_torch.kernels.segment_spmm import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    row_ptr, col, w = batch.csr_pairs()[-1][1]
    nnz = int(row_ptr[-1])
    dy = torch.randn((n, 6), generator=gen, device="cuda")
    got = ops.segment_spmm_csr(dy, row_ptr, col, w)
    want = ref.segment_spmm_csr_ref(dy, row_ptr, col, w)
    torch.cuda.synchronize()
    err = check_close("segment_spmm on the transposed CSR F=6", got, want,
                      TOL_SPMM)
    faults = spmm_faults("transposed F=6", ops, dy, row_ptr, col, w, want)
    lib = torch.sparse_csr_tensor(row_ptr, col[:nnz], w[:nnz], size=(n, n),
                                  check_invariants=False)
    b_ms, b_by = bound_ms(dy.nbytes + row_ptr.nbytes + nnz * 8 + got.nbytes,
                          2.0 * nnz * 6)

    def kern():
        return ops.segment_spmm_csr(dy, row_ptr, col, w)

    spmm = {"F": 6, "nnz": nnz, "ms": timer(kern),
            "wrapper_ms": timer(kern, host=True),
            "plain_ms": timer(lambda: ref.segment_spmm_csr_ref(
                dy, row_ptr, col, w)),
            "library_ms": timer(lambda: torch.sparse.mm(lib, dy)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "fault_over_limit": faults}
    log(f"[kernel] segment_spmm backward (transposed CSR, {nnz} edges) F=6:"
        f" kernel {spmm['ms']:.4f} ms (wrapper {spmm['wrapper_ms']:.4f}), "
        f"plain {spmm['plain_ms']:.4f}, torch.sparse.mm on A^T "
        f"{spmm['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}); max|err| "
        f"{err:.2e}; faults rejected at x limit: zeros "
        f"{faults['zeros']:.1f}, last edge dropped "
        f"{faults['last edge dropped']:.1f}")

    bsize, w1 = TRAIN_T // TRAIN_NB, window - 1
    full_bsize = FULL_T // TRAIN_NB
    # (T_s, lead, t_offset of prefix row 0): block 0, block 1 (blocks 2
    # and 3 read the same full band at +12, +20), the whole T over an
    # empty prefix, and block 1 of the full config's T = 512
    fwd = band_rows(torch, gen, n, window, timer, (
        (bsize, w1, -w1), (bsize, w1, bsize - w1), (TRAIN_T, 0, 0),
        (full_bsize, w1, full_bsize - w1)))
    # (T_s, lead, t_offset, write_lead): the gradient of block 0's kept
    # rows (its prefix, the zero initial carry, needs none), of block 1's
    # (prefix and slice), of the whole T, and of the full config's block 1
    rows = band_t_rows(torch, gen, n, window, timer, (
        (bsize, w1, -w1, False), (bsize, w1, bsize - w1, True),
        (TRAIN_T, 0, 0, True), (full_bsize, w1, full_bsize - w1, True)))
    return (spmm, fwd, rows, band_sweep(torch, gen),
            band_t_sweep(torch, gen))


def reject_faults(name: str, want, limit: float, faulty: dict) -> dict:
    """Show that a band check rejects each faulty output of ``faulty``
    ({fault: output, or None where the fault cannot arise}) -> {fault:
    max |diff| over the limit, or None}."""
    ratios = {"zeros": float(want.abs().max()) / limit}
    for fault, out in faulty.items():
        ratios[fault] = None if out is None else \
            float((out - want).abs().max()) / limit
    for fault, ratio in ratios.items():
        if ratio is not None and ratio <= 1.0:
            raise SystemExit(f"{name}: the check would pass a kernel that "
                             f"wrote {fault} ({ratio:.3f} x its limit)")
    return ratios


def without_row(x, row: int):
    cut = x.clone()
    cut[row] = 0.0
    return cut


def fault_text(faults: dict) -> str:
    return ", ".join(f"{k} " + ("n/a" if v is None else f"{v:.1f}")
                     for k, v in faults.items())


def band_rows(torch, gen, n: int, window: int, timer, cases) -> list[dict]:
    """``banded_ttm`` on [prefix (lead, N x 6); x (T_s, N x 6)] at each
    (T_s, lead, t_offset of prefix row 0) of ``cases``: held to its plain
    version, shown to reject zeros, a dropped prefix row (the last, which
    lies in the first kept row's band; n/a without a prefix, or when the
    prefix lies before global step 1 and is never read) and a dropped
    slice row, and timed beside its bound (the kept rows' count, and the
    earlier all-rows contract's beside it), its plain version and
    cuBLAS's dense band M[lead:] @ [prefix; x] on an input concatenated
    beforehand (the cat left out of its time)."""
    from repro_torch.kernels.mproduct import ops, ref

    rows = []
    for t_s, lead, off in cases:
        prefix = torch.randn((lead, n * 6), generator=gen, device="cuda")
        x = torch.randn((t_s, n * 6), generator=gen, device="cuda")

        def kern(p=prefix, v=x, off=off):
            return ops.banded_ttm(p, v, window, off)

        got = kern()
        want = ref.banded_ttm_ref(prefix, x, window, off)
        torch.cuda.synchronize()
        name = (f"banded_ttm [prefix ({lead}, {n * 6}); x ({t_s}, {n * 6})]"
                f" t_offset={off}")
        err = check_close(name, got, want, TOL_TTM)
        del got
        read_prefix = lead > 0 and lead + off >= 1
        faults = reject_faults(name, want, TOL_TTM * (
            1.0 + float(want.abs().max())), {
                "a prefix row dropped": kern(
                    without_row(prefix, lead - 1)) if read_prefix else None,
                "a slice row dropped": kern(v=without_row(x, t_s // 2))})
        full = torch.cat([prefix, x])
        m = band_matrix(torch, lead + t_s, window, off)[lead:].contiguous()
        b_ms, b_by = bound_ms(*band_cost(t_s, n * 6, window, off, lead))
        old_b_ms, _ = bound_ms(*band_cost(t_s, n * 6, window, off, lead,
                                          all_rows=True))
        row = {"shape": [t_s, n * 6], "lead": lead, "t_offset": off,
               "ms": timer(kern), "wrapper_ms": timer(kern, host=True),
               "plain_ms": timer(lambda p=prefix, v=x, off=off:
                                 ref.banded_ttm_ref(p, v, window, off)),
               "library_ms": timer(lambda m=m, full=full: m @ full),
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_all_rows_ms": old_b_ms, "max_abs_err": err,
               "library_max_abs_err": float((m @ full - want).abs().max()),
               "fault_over_limit": faults}
        log(f"[kernel] {name}: kernel {row['ms']:.4f} ms (wrapper "
            f"{row['wrapper_ms']:.4f}), plain {row['plain_ms']:.4f}, dense "
            f"band M[lead:] @ [prefix; x] {row['library_ms']:.4f}, bound "
            f"{b_ms:.4f} ({b_by}, {b_ms / row['ms']:.1%}; all rows written:"
            f" {old_b_ms:.4f}); max|err| {err:.2e}; faults rejected at x "
            f"limit: {fault_text(faults)}")
        rows.append(row)
        del prefix, x, want, full, m
        torch.cuda.empty_cache()
    return rows


def band_t_rows(torch, gen, n: int, window: int, timer, cases
                ) -> list[dict]:
    """``banded_ttm_t`` on the kept rows' gradient dZ (T_s, N x 6) at each
    (T_s, lead, t_offset, write_lead) of ``cases``: held to its plain
    version, shown to reject zeros and a dropped dZ row, and timed beside
    its bound (the kept-rows contract's bytes), its plain version and the
    dense ``M[lead:, first:]^T @ dZ``."""
    from repro_torch.kernels.mproduct import ops, ref

    rows = []
    for t_s, lead, off, write_lead in cases:
        first = 0 if write_lead else lead
        dz = torch.randn((t_s, n * 6), generator=gen, device="cuda")

        def kern(v=dz, lead=lead, off=off, wl=write_lead):
            return ops.banded_ttm_t(v, window, off, lead, wl)

        got = kern()
        want = ref.banded_ttm_t_ref(dz, window, off, lead, write_lead)
        torch.cuda.synchronize()
        name = (f"banded_ttm_t dZ ({t_s}, {n * 6}) lead {lead} t_offset="
                f"{off}{'' if write_lead else ', slice rows only'}")
        err = check_close(name, got, want, TOL_TTM)
        del got
        faults = reject_faults(name, want, TOL_TTM * (
            1.0 + float(want.abs().max())), {
                "a dZ row dropped": kern(without_row(dz, t_s // 2))})
        m = band_matrix(torch, lead + t_s, window, off)[lead:, first:]
        m = m.T.contiguous()
        b_ms, b_by = bound_ms(*band_t_cost(t_s, n * 6, window, off, lead,
                                           first))
        row = {"shape": [t_s, n * 6], "lead": lead, "t_offset": off,
               "write_lead": write_lead, "ms": timer(kern),
               "wrapper_ms": timer(kern, host=True),
               "plain_ms": timer(lambda v=dz, lead=lead, off=off,
                                 wl=write_lead: ref.banded_ttm_t_ref(
                                     v, window, off, lead, wl)),
               "library_ms": timer(lambda v=dz, m=m: m @ v),
               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
               "library_max_abs_err": float((m @ dz - want).abs().max()),
               "fault_over_limit": faults}
        log(f"[kernel] {name}: kernel {row['ms']:.4f} ms (wrapper "
            f"{row['wrapper_ms']:.4f}), plain {row['plain_ms']:.4f}, "
            f"dense M^T @ dZ {row['library_ms']:.4f}, bound {b_ms:.4f} "
            f"({b_by}, {b_ms / row['ms']:.1%}); max|err| {err:.2e}; faults "
            f"rejected at x limit: {fault_text(faults)}")
        rows.append(row)
        del dz, want, m
        torch.cuda.empty_cache()
    return rows


def sweep_verdict(torch, name: str, cases: list, errs: list, scale: list
                  ) -> dict:
    """Exit if any case's max |diff| exceeds check_close's limit, TOL_TTM
    x (1 + max |want|) -> the sweep's summary."""
    errs, scale = torch.stack(errs).cpu(), torch.stack(scale).cpu()
    bad = (~(errs <= TOL_TTM * (1.0 + scale))).nonzero().flatten()
    if len(bad):
        raise SystemExit(
            f"{name} sweep: {len(bad)} of {len(cases)} cases disagree with "
            f"the plain version, first {cases[int(bad[0])]}: max |diff| "
            f"{float(errs[bad[0]]):.3e}")
    return {"cases": len(cases), "max_abs_err": float(errs.max()),
            "nonzero_cases": int((scale > 0).sum())}


def band_sweep(torch, gen) -> dict:
    """``banded_ttm`` against its plain version at small shapes that reach
    every instance the launcher builds: w 1-8 (the register window) and 9
    (the loop), each with 4 columns a thread (NF 36) and one (NF 13, and
    NF 12 with the prefix's pointer, then x's, one float off 16-byte
    alignment); T_s 1-12, lead 0 and w - 1, t_offset -7..+9."""
    from repro_torch.kernels.mproduct import ops, ref

    inputs = {}
    for label, nf, skew_p, skew_x in (("NF 36", 36, 0, 0),
                                      ("NF 13", 13, 0, 0),
                                      ("NF 12 (prefix misaligned)", 12, 1, 0),
                                      ("NF 12 (x misaligned)", 12, 0, 1)):
        inputs[label] = tuple(
            torch.randn(12 * nf + skew, generator=gen, device="cuda"
                        )[skew:].view(12, nf) for skew in (skew_p, skew_x))
    cases, errs, scale = [], [], []
    for label, (p_all, x_all) in inputs.items():
        for w in range(1, 10):
            for t_s in range(1, 13):
                for lead in sorted({0, w - 1}):
                    for off in range(-7, 10):
                        p, x = p_all[:lead], x_all[:t_s]
                        want = ref.banded_ttm_ref(p, x, w, off)
                        cases.append((label, w, t_s, lead, off))
                        errs.append((ops.banded_ttm(p, x, w, off) - want
                                     ).abs().max())
                        scale.append(want.abs().max())
    out = sweep_verdict(torch, "banded_ttm", cases, errs, scale)
    log(f"[kernel] banded_ttm sweep: {out['cases']} cases (w 1-9, T_s 1-12, "
        f"lead 0 and w - 1, t_offset -7..+9; {', '.join(inputs)}), max|err| "
        f"{out['max_abs_err']:.2e} (limit {TOL_TTM:.0e} x (1 + max |want|));"
        f" {out['nonzero_cases']} cases with a nonzero result")
    return out


def band_t_sweep(torch, gen) -> dict:
    """``banded_ttm_t`` against its plain version at small shapes that
    reach every instance the launcher builds: w 1-8 (the unrolled window)
    and 9 (the loop), each with 4 columns a thread (NF 36) and one (NF 13,
    and NF 12 with dZ one float off 16-byte alignment); T_s 1-12, lead 0
    and w - 1, t_offset -7..+9, with and without the prefix's rows."""
    from repro_torch.kernels.mproduct import ops, ref

    inputs = {}
    for nf, skew in ((36, 0), (13, 0), (12, 1)):
        base = torch.randn(12 * nf + skew, generator=gen, device="cuda")
        inputs[f"NF {nf}" + (" misaligned" if skew else "")] = \
            base[skew:].view(12, nf)
    cases, errs, scale = [], [], []
    for label, dz_all in inputs.items():
        for w in range(1, 10):
            for t_s in range(1, 13):
                dz = dz_all[:t_s]
                for lead in sorted({0, w - 1}):
                    for off in range(-7, 10):
                        for wl in (True, False):
                            got = ops.banded_ttm_t(dz, w, off, lead, wl)
                            want = ref.banded_ttm_t_ref(dz, w, off, lead,
                                                        wl)
                            cases.append((label, w, t_s, lead, off, wl))
                            errs.append((got - want).abs().max())
                            scale.append(want.abs().max())
    out = sweep_verdict(torch, "banded_ttm_t", cases, errs, scale)
    log(f"[kernel] banded_ttm_t sweep: {out['cases']} cases (w 1-9, T_s "
        f"1-12, lead 0 and w - 1, t_offset -7..+9, with and without the "
        f"prefix's rows; {', '.join(inputs)}), max|err| "
        f"{out['max_abs_err']:.2e} (limit {TOL_TTM:.0e} x (1 + max "
        f"|want|)); {out['nonzero_cases']} cases with a nonzero result")
    return out


def train_parity(torch):
    """One training step's loss and gradients, card (kernels) against CPU
    (plain versions), from the same parameters, for all three models at
    N = 65,536, T = 16, nb 4, at the full config's widths."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.core import checkpoint as ckpt
    from repro_torch.core import models as tm
    from repro_torch.core.dtdg import build_batch
    from repro_torch.data.dyngnn import synthetic_dataset

    out = {}
    for model, smooth in (("tmgcn", "mproduct"), ("cdgcn", "none"),
                          ("evolvegcn", "edgelife")):
        cfg = dataclasses.replace(registry.get_arch(model).make_config(),
                                  num_nodes=PARITY_N, num_steps=PARITY_T,
                                  checkpoint_blocks=TRAIN_NB)
        ds = synthetic_dataset(PARITY_N, PARITY_T, density=TRAIN_DENSITY,
                               smoothing_mode=smooth, window=cfg.window,
                               seed=1)
        params = tm.init_params(torch.Generator().manual_seed(7), cfg)
        names = [k for k, _ in params.named_parameters()]
        res = {}
        for dev in ("cuda", "cpu"):
            b = build_batch(ds.snapshots, ds.frames, PARITY_N,
                            values=ds.values, device=dev)
            p = copy.deepcopy(params).to(dev)
            loss = ckpt.blocked_node_loss(
                cfg, p, b, torch.from_numpy(ds.labels).to(dev))
            grads = torch.autograd.grad(loss, list(p.parameters()))
            res[dev] = (loss.item(), [g.cpu() for g in grads])
        (lg, gg), (lc, gc) = res["cuda"], res["cpu"]
        worst = abs(lg - lc) / (TOL_GRAD * abs(lc))
        for name, a, b in zip(names, gg, gc, strict=True):
            ratio = float((a - b).abs().max()) / (
                TOL_GRAD * max(float(b.abs().max()), 1e-30))
            if not ratio <= 1.0:
                raise SystemExit(f"train parity {model}: gradient {name} "
                                 f"card vs CPU at {ratio:.3f} x its limit")
            worst = max(worst, ratio)
        if not worst <= 1.0:
            raise SystemExit(f"train parity {model}: loss {lg} vs {lc}")
        out[model] = {"loss_cuda": lg, "loss_cpu": lc,
                      "worst_over_limit": worst}
        log(f"[parity-train] {model} N={PARITY_N} T={PARITY_T} nb "
            f"{TRAIN_NB}: loss card {lg:.7f} / CPU {lc:.7f}; loss and "
            f"{len(names)} gradients within {worst:.3f} of their limits "
            f"({TOL_GRAD} x each leaf's max |value|)")
    return out


# ----------------------------------------------------------- streaming -----

def phase_ms(spans, name: str) -> list[float]:
    return [sp.dur_s * 1e3 for sp in spans if sp.name == name]


def stream_fit(torch, kernels, obs, pipe, overlap: bool, trace: str):
    """One epoch of ``Engine(mode="streamed", device="cuda")`` over the
    pipeline's trace, with ``trace`` "fenced" spans, "host"-clock spans or
    "none", every count zeroed just before the fit and read just after ->
    {result, launches (with the CSR builds), wall_s, spans, peak and
    base bytes (allocated before the fit)}."""
    from repro_torch.configs import registry
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import Engine, ExecutionPlan, InMemoryDTDG, \
        RunConfig

    eng = Engine(RunConfig(
        model=registry.get_arch("paper_dyngnn").make_config(),
        data=InMemoryDTDG(pipe.ds, pipeline=pipe),
        plan=ExecutionPlan(mode="streamed", num_epochs=1, overlap=overlap),
        log_every=8, log_fn=log), device="cuda")
    eng.resolve()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tracer = obs.configure(enabled=trace != "none", fence=trace == "fenced")
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    obs.configure(enabled=False)
    return {"result": res, "launches": launches, "wall_s": wall,
            "spans": tracer.spans(), "base": base,
            "peak": torch.cuda.max_memory_allocated()}


def check_stream_counts(path: str, launches: dict, steps: int, k: int,
                        layers: int) -> None:
    """Per step over a slice of k snapshots, TM-GCN with L layers: L k
    aggregates forward and (L - 1) k backward (the frames need no
    gradient), L bands and L transposed bands (slice rows only: the
    detached prefix carry needs no gradient), 2 k CSR builds."""
    check_launches(path, launches, {
        "segment_spmm": steps * (2 * layers - 1) * k,
        "banded_ttm": steps * layers, "banded_ttm_t": steps * layers,
        "flash_decode": 0})
    if launches["csr_builds"] != steps * 2 * k:
        raise SystemExit(f"{path}: {launches['csr_builds']} CSR builds, "
                         f"expected {steps * 2 * k}")


def stream_path(torch, kernels, obs, ds, pipe=None):
    """The streamed schedule: ``paper_dyngnn`` (TM-GCN) at the full
    config's widths over the train phase's trace (N = 755,200, T = 32):
    four per-snapshot epochs through ``Engine(mode="streamed",
    device="cuda")`` in turns, with the prefetch thread (host-clock
    spans), without it (fenced spans: the per-snapshot breakdown), then
    without and with it untraced; then one epoch of
    ``train_streamed(slice_len=8)``.  Launches and CSR builds are counted
    in each; the four per-snapshot runs' losses and parameters are held
    bit-identical -> (the phase's numbers, the pipeline).  ``pipe``, the
    train phase's pipeline over the same trace and blocks (its padded
    batch dropped), is reused where there is one: building it is one
    stats pass and one encode pass on the host (~63 s)."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.data.dyngnn import DTDGPipeline
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.stream import train_loop as st

    cfg = dataclasses.replace(
        registry.get_arch("paper_dyngnn").make_config(),
        num_nodes=ds.num_nodes, num_steps=ds.num_steps)
    t0 = time.perf_counter()
    reused = (pipe is not None and pipe.ds is ds
              and pipe.nb == cfg.checkpoint_blocks)
    if not reused:
        pipe = DTDGPipeline(ds, nb=cfg.checkpoint_blocks, device="cuda")
    setup_s = time.perf_counter() - t0
    t, layers = ds.num_steps, cfg.num_layers
    rep = pipe.transfer_bytes()
    log(f"[stream] trace N={ds.num_nodes} T={t} (the train phase's), "
        f"block {pipe.bsize}, max_edges {pipe.max_edges}, pads "
        f"{pipe.stream_stats.max_drops}/{pipe.stream_stats.max_adds}; "
        + ("the train phase's pipeline; " if reused else
           f"pipeline (stats + one encode pass) {setup_s:.1f} s on the "
           "host; ") +
        f"payload {rep['graph_diff']:,} B against naive {rep['naive']:,} B "
        f"(ratio {rep['ratio']:.3f}, {rep['graph_diff'] / t / 1e6:.2f} MB "
        f"a snapshot)")

    # in turns: on (host-clock spans), off (fenced spans: the breakdown),
    # then off and on again untraced
    runs = [stream_fit(torch, kernels, obs, pipe, overlap, trace)
            for overlap, trace in ((True, "host"), (False, "fenced"),
                                   (False, "none"), (True, "none"))]
    for r, overlap in zip(runs, (True, False, False, True), strict=True):
        check_stream_counts("stream" if overlap else "stream (no overlap)",
                            r["launches"], t, 1, layers)
    on, off = runs[0], runs[1]
    losses = on["result"].losses
    if len(losses) != t or not np.isfinite(losses).all():
        raise SystemExit(f"stream: bad losses {losses}")
    for r in runs[1:]:
        if r["result"].losses != losses or not all(
                torch.equal(a, b) for a, b in zip(
                    on["result"].state.params.parameters(),
                    r["result"].state.params.parameters(), strict=True)):
            raise SystemExit("stream: overlap on and off disagree: "
                             f"{losses} vs {r['result'].losses}")
    log("[stream] losses (overlap on == off, bit for bit, and the "
        "parameters, in all four runs): "
        + ", ".join(f"{v:.5f}" for v in losses))
    on_spans, off_spans = on["spans"], off["spans"]
    on_walls = [runs[0]["wall_s"], runs[3]["wall_s"]]
    off_walls = [runs[1]["wall_s"], runs[2]["wall_s"]]
    on_s, off_s = min(on_walls), min(off_walls)

    phases = {name: phase_ms(off_spans, f"stream.{name}")
              for name in ("encode", "stage", "apply", "csr_pair", "step")}
    for name, v in phases.items():
        if len(v) != t:
            raise SystemExit(f"stream: {len(v)} stream.{name} spans, "
                             f"expected {t}")
    phases["step_less_csr"] = [a - b for a, b in zip(
        phases["step"], phases["csr_pair"], strict=True)]
    med = {k: statistics.median(v) for k, v in phases.items()}
    wait = phase_ms(on_spans, "prefetch.wait")
    enc_on = phase_ms(on_spans, "stream.encode")
    stage_on = phase_ms(on_spans, "prefetch.stage")
    on_ms, off_ms = on_s * 1e3 / t, off_s * 1e3 / t
    device_ms = med["stage"] + med["apply"] + med["step"]
    log("[stream] per snapshot without the prefetch thread (fenced spans, "
        "median / max ms): " + ", ".join(
            f"{k} {med[k]:.2f} / {max(phases[k]):.2f}"
            for k in ("encode", "stage", "apply", "csr_pair",
                      "step_less_csr", "step")))
    log(f"[stream] with the prefetch thread (host-clock spans): "
        f"prefetch.wait median {statistics.median(wait):.2f} ms, total "
        f"{sum(wait) / 1e3:.2f} s of {on['wall_s']:.2f} s; worker encode "
        f"median "
        f"{statistics.median(enc_on):.2f} ms, stage (pin + enqueue) median "
        f"{statistics.median(stage_on):.2f} ms")
    bound = "encoder" if med["encode"] > device_ms else "device"
    verdict = (
        f"the host encoder bounds the schedule: {med['encode']:.1f} ms a "
        f"snapshot against {device_ms:.1f} ms of stage + apply + step, so "
        "the prefetch thread can hide at most "
        f"{device_ms / (med['encode'] + device_ms):.1%} of a snapshot"
        if bound == "encoder" else
        f"the prefetch thread can hide the host encoder "
        f"({med['encode']:.1f} ms a snapshot) behind stage + apply + step "
        f"({device_ms:.1f} ms)")
    walls = ", ".join(f"{r['wall_s']:.2f}" for r in runs)
    log(f"[stream] epoch wall, in turns (on traced, off fenced, off, on):"
        f" {walls} s; the faster of each: overlap on {on_ms:.1f} ms a "
        f"snapshot, off {off_ms:.1f} ms; {verdict}")
    log(f"[stream] peak device memory {on['peak'] / 1e9:.3f} GB with the "
        f"prefetch thread, {off['peak'] / 1e9:.3f} GB without; above what "
        f"was allocated before each fit, {(on['peak'] - on['base']) / 1e9:.3f}"
        f" and {(off['peak'] - off['base']) / 1e9:.3f} GB (the eager train "
        "step: 5.266 GB, PERF.md)")

    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    tracer = obs.configure(enabled=True)
    t0 = time.perf_counter()
    sl = st.train_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        block_size=pipe.bsize, stats=pipe.stream_stats,
        max_edges=pipe.max_edges, slice_len=STREAM_SLICE, device="cuda")
    torch.cuda.synchronize()
    sl_s = time.perf_counter() - t0
    sl_launches = {k.name: k.launches for k in kernels}
    sl_launches["csr_builds"] = spmm_ops.csr_builds
    obs.configure(enabled=False)
    rounds = t // STREAM_SLICE
    check_stream_counts("stream (slice 8)", sl_launches, rounds,
                        STREAM_SLICE, layers)
    if len(sl.losses) != rounds or not np.isfinite(sl.losses).all():
        raise SystemExit(f"stream slice: bad losses {sl.losses}")
    sl_spans = tracer.spans()
    sl_med = {name: statistics.median(phase_ms(sl_spans, f"stream.{name}"))
              for name in ("encode", "apply", "csr_pair", "step")}
    log(f"[stream] slice_len {STREAM_SLICE}: {rounds} steps in {sl_s:.2f} "
        "s, losses " + ", ".join(f"{v:.5f}" for v in sl.losses)
        + "; per step (fenced, median ms): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sl_med.items())
        + " (encode: per snapshot)")
    return {"T": t, "N": ds.num_nodes, "max_edges": pipe.max_edges,
            "block": pipe.bsize, "pipeline_s": setup_s,
            "pipeline_reused": reused, "transfer": rep, "losses": losses,
            "launches": on["launches"],
            "overlap_on": {"wall_s": on_walls, "ms_per_snapshot": on_ms,
                           "peak_bytes": on["peak"],
                           "base_bytes": on["base"],
                           "wait_ms_median": statistics.median(wait),
                           "wait_s_total": sum(wait) / 1e3,
                           "encode_ms_median": statistics.median(enc_on),
                           "stage_ms_median": statistics.median(stage_on)},
            "overlap_off": {"wall_s": off_walls, "ms_per_snapshot": off_ms,
                            "peak_bytes": off["peak"],
                            "base_bytes": off["base"], "phases_ms": med},
            "bound_by": bound, "verdict": verdict,
            "slice": {"slice_len": STREAM_SLICE, "wall_s": sl_s,
                      "losses": sl.losses, "launches": sl_launches,
                      "phases_ms": sl_med}}, pipe


def stream_kernel_checks(torch, pipe, window: int, timer) -> dict:
    """The kernels at the streamed step's shapes: ``banded_ttm_t`` on one
    kept row's gradient, (1, lead 4), slice rows only (held to its plain
    version, shown to reject zeros and a dropped row, timed beside its
    bound, plain version and cuBLAS's dense Mᵀ·dZ), and one snapshot's
    CSR-pair build — the step makes one a snapshot, eager training 2 T
    per run — timed against the F = 6 ``segment_spmm`` on its CSR."""
    import numpy as np

    from repro_torch.kernels.segment_spmm import ops
    from repro_torch.stream import train_loop as st

    n = pipe.ds.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(8)
    # global step 16 of the trace: its prefix rows are steps 12-15
    band_t = band_t_rows(torch, gen, n, window, timer,
                         ((1, window - 1, 16 - (window - 1), False),))[0]
    snap, vals = pipe.ds.snapshots[-1], pipe.ds.values[-1]
    e = np.zeros((pipe.max_edges, 2), np.int32)
    m = np.zeros((pipe.max_edges,), np.float32)
    v = np.zeros((pipe.max_edges,), np.float32)
    e[:len(snap)], m[:len(snap)], v[:len(snap)] = snap, 1.0, vals
    e_full, w_full = st.slice_weights_with_loops(
        n, *st.make_self_loops(n, "cuda"),
        *(torch.from_numpy(a)[None].cuda() for a in (e, m, v)))
    e_full, w_full = e_full[0], w_full[0]
    csr = ops.build_csr(e_full, w_full, n)
    x = torch.randn((n, 6), generator=gen, device="cuda")
    times = timer.turns({
        "pair": lambda: ops.build_csr_pair(e_full, w_full, n),
        "spmm": lambda: ops.segment_spmm_csr(x, *csr)})
    lanes = int(e_full.shape[0])
    # the edges and weights read once, two CSRs (row_ptr, col, w) written
    b_ms, b_by = bound_ms(12 * lanes + 2 * (4 * (n + 1) + 8 * lanes), 0.0)
    out = {"lanes": lanes, "nnz": int(csr[0][-1]),
           "pair_ms": times["pair"], "spmm_f6_ms": times["spmm"],
           "ratio": times["pair"] / times["spmm"], "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"[kernel] CSR pair build (forward + transposed, {out['lanes']} "
        f"lanes, {out['nnz']} edges): {out['pair_ms']:.4f} ms a snapshot, "
        f"{out['ratio']:.1f}x the F = 6 segment_spmm on its CSR "
        f"({out['spmm_f6_ms']:.4f} ms); bound {b_ms:.4f} ms ({b_by}, "
        f"{b_ms / out['pair_ms']:.1%})")
    return {"banded_ttm_t": band_t, "csr_pair": out}


def stream_parity(torch):
    """The streamed loss stream, card (kernels, prefetch thread) against
    CPU (plain versions, inline), from the same parameters, for all three
    models at N = 65,536, T = 8 at the full config's widths: each step's
    loss within 1e-4 relative, and the first step's loss and gradients
    within 1e-4 x each leaf's max |value|."""
    import copy

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset
    from repro_torch.stream import encoder as enc
    from repro_torch.stream import train_loop as st
    from repro_torch.stream.prefetch import DeltaApplier, stage_item

    out = {}
    n, t = STREAM_PARITY_N, STREAM_PARITY_T
    for model, smooth in (("tmgcn", "mproduct"), ("cdgcn", "none"),
                          ("evolvegcn", "edgelife")):
        cfg = dataclasses.replace(registry.get_arch(model).make_config(),
                                  num_nodes=n, num_steps=t,
                                  checkpoint_blocks=TRAIN_NB)
        ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                               smoothing_mode=smooth, window=cfg.window,
                               seed=1)
        params = tm.init_params(torch.Generator().manual_seed(7), cfg)
        max_edges = enc.padded_max_edges(ds.snapshots)
        first = next(st.host_stream(ds.snapshots, ds.values, ds.frames,
                                    ds.labels, n, max_edges, t // TRAIN_NB))
        names = [k for k, _ in params.named_parameters()]
        res = {}
        for dev in ("cuda", "cpu"):
            p = copy.deepcopy(params).to(dev)
            item, frame, lab = stage_item(first, dev)
            e, m, v = DeltaApplier(max_edges, dev).consume(item)
            loss, grads, _ = st.slice_value_and_grad(
                cfg, p, st.fresh_carries(cfg, p), frame[None], e[None],
                m[None], v[None], lab[None], 0)
            run = st.train_streamed(
                cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
                params=copy.deepcopy(params), overlap=dev == "cuda",
                device=dev)
            res[dev] = (loss.item(), [g.cpu() for g in grads], run.losses)
        (lg, gg, sg), (lc, gc, sc) = res["cuda"], res["cpu"]
        worst = abs(lg - lc) / (TOL_GRAD * abs(lc))
        for name, a, b in zip(names, gg, gc, strict=True):
            ratio = float((a - b).abs().max()) / (
                TOL_GRAD * max(float(b.abs().max()), 1e-30))
            if not ratio <= 1.0:
                raise SystemExit(f"stream parity {model}: gradient {name} "
                                 f"card vs CPU at {ratio:.3f} x its limit")
            worst = max(worst, ratio)
        steps = [abs(a - b) / (TOL_GRAD * abs(b))
                 for a, b in zip(sg, sc, strict=True)]
        if not (worst <= 1.0 and len(sg) == t and max(steps) <= 1.0
                and np.isfinite(sg).all()):
            raise SystemExit(f"stream parity {model}: losses {sg} vs {sc}, "
                             f"first step {lg} vs {lc}")
        out[model] = {"losses_cuda": sg, "losses_cpu": sc,
                      "loss_worst_over_limit": max(steps),
                      "first_step_worst_over_limit": worst}
        log(f"[parity-stream] {model} N={n} T={t}: {t} losses card vs CPU "
            f"within {max(steps):.3f} of 1e-4 relative (last {sg[-1]:.6f} "
            f"/ {sc[-1]:.6f}); first step's loss and {len(names)} "
            f"gradients within {worst:.3f} of their limits")
    return out


# ------------------------------------------------------- partitioning ------

def nccl_group(torch):
    """A one-rank NCCL process group on cuda:0 (an in-memory store: it
    opens no port)."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    return dist.group.WORLD


def partition_path(torch, kernels, obs, ds, pipe, group, eager: dict,
                   timer):
    """The snapshot-partitioned step at P = 1 over a one-rank NCCL group:
    ``paper_dyngnn`` at the full config's widths on the train phase's trace
    (N = 755,200, T = 32, nb 4) through ``Engine(plan=ExecutionPlan(
    mode="eager", mesh=group), device="cuda")``, 10 steps from the same
    seed and optimizer as the train phase; every count zeroed just before
    the fit and read just after (the train phase's 160 / 12 / 8 / 0 a step
    and 2 T CSR builds, the CPU test's counts at P = 1; 40 all-to-alls a
    step, every payload one layer's (8, N, 6) f32, none of it leaving the
    rank), the loss stream held to the train phase's at rtol 1e-5; then
    the warm step (and the cudaMalloc calls it makes), one profiled step
    (NCCL's all-to-all ranges apart from the copies they span), the
    one-rank all-to-all timed on one layer's payload and on the payload a
    P = 4 rank sends, each beside its copy bound and ``clone()``, and its
    host enqueue time -> the path's numbers."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.dist.sharding import ShardLayout, t_to_n
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import Engine, ExecutionPlan, InMemoryDTDG, RunConfig

    cfg = registry.get_arch("paper_dyngnn").make_config()
    t0 = time.perf_counter()
    eng = Engine(RunConfig(model=cfg, data=InMemoryDTDG(ds, pipeline=pipe),
                           plan=ExecutionPlan(mode="eager", mesh=group,
                                              num_steps=TRAIN_STEPS),
                           log_fn=log), device="cuda")
    rr = eng.resolve()
    setup_s = time.perf_counter() - t0
    pipe, nb, n = rr.pipeline, rr.cfg.checkpoint_blocks, rr.cfg.num_nodes
    layers, t = cfg.num_layers, ds.num_steps
    log(f"[partition] P = 1 over NCCL ({torch.cuda.get_device_name(0)}): "
        f"N={n}, T={t}, nb {nb}; plan resolved in {setup_s:.1f} s")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced train.step spans
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    fit_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    builds = spmm_ops.csr_builds
    obs.configure(enabled=False)
    peak = torch.cuda.max_memory_allocated()
    check_launches("partition", launches, train_launches(layers, t, nb))
    if builds != 2 * t:
        raise SystemExit(f"partition: {builds} CSR builds, expected {2 * t}")
    launches["csr_builds"] = builds
    counters = res.metrics["counters"]
    calls = counters.get("partition.a2a_calls", 0)
    handed = counters.get("partition.a2a_bytes", 0)
    remote = counters.get("partition.a2a_remote_bytes", 0)
    payload = (t // nb) * n * 6 * 4
    # per block: the forward's 2 L, the recompute's 2 L - 2 (it stops at
    # the last layer's relu), the backward's 2 L
    want_calls = TRAIN_STEPS * nb * (6 * layers - 2)
    if calls != want_calls or handed != calls * payload or remote != 0:
        raise SystemExit(f"partition: {calls} all-to-alls of {handed} B "
                         f"({remote} B remote), expected {want_calls} of "
                         f"{payload} B each, none remote")
    losses = res.losses
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(losses, eager["losses"], strict=True))
    if not (np.isfinite(losses).all() and worst <= 1e-5):
        raise SystemExit(f"partition: losses {losses} against eager's "
                         f"{eager['losses']} (worst relative {worst:.2e})")
    spans = tracer.spans()
    step_ms = phase_ms(spans, "train.step")
    build_ms = phase_ms(spans, "train.csr_build")
    log("[partition] losses: " + ", ".join(f"{v:.5f}" for v in losses)
        + f"; against the train phase's eager run: worst relative "
        f"{worst:.2e} (limit 1e-5)")
    log(f"[partition] a step: {calls // TRAIN_STEPS} all-to-alls, "
        f"{handed // TRAIN_STEPS:,} B handed to NCCL, {remote} B remote; "
        f"fit {fit_s:.2f} s; train.step (fenced spans) median "
        f"{statistics.median(step_ms):.1f} ms, after the first "
        f"{statistics.median(step_ms[1:]):.1f} (eager "
        f"{eager['step_ms_median_after_first']:.1f}); the rank's 2 T CSR "
        f"builds before the first step {build_ms[0]:.1f} ms")
    log(f"[partition] peak device memory {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} above the {base / 1e9:.3f} GB allocated "
        f"before the fit (eager: {eager['peak_bytes'] / 1e9:.3f} GB)")

    step_fn = rr.cache["eager_step"]
    layout = ShardLayout.of(group, nb, t // nb, n)
    args = pipe.rank_arrays(layout)
    csrs = pipe.rank_batch(layout).csr_pairs()
    state = {"params": res.state.params, "opt": res.state.opt_state}

    def one_step():
        state["params"], state["opt"], _ = step_fn(
            state["params"], state["opt"], *args, csrs=csrs)

    mallocs = torch.cuda.memory_stats()["num_device_alloc"]
    steady = alternating_walls(torch, {"step": one_step}, 7)["step"]
    mallocs = torch.cuda.memory_stats()["num_device_alloc"] - mallocs
    ranges: dict = {}
    host_top: list = []
    wall_us, busy, by_name = device_profile(torch, one_step, ranges,
                                            host_top)
    kinds = by_kind(by_name)
    nccl = [us for name, v in ranges.items() if name.startswith("nccl")
            for us in v]
    dtod = by_name.get("Memcpy DtoD (Device -> Device)", [])
    prof = {"steady_ms": steady, "wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "by_kind": kinds, "host_top": host_top,
            "nccl_ranges": len(nccl),
            "nccl_ms": sum(nccl) / 1e3, "dtod_copies": len(dtod),
            "dtod_ms": sum(dtod) / 1e3, "warm_step_device_mallocs": mallocs}
    ep = eager["profile"]
    log(f"[profile-partition] warm step (host clock + sync, median of 6): "
        f"{steady:.1f} ms (eager, this call: {ep['steady_ms']:.1f}); one "
        f"profiled step: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms (eager {ep['busy_ms']:.1f}), idle share "
        f"{1 - busy / wall_us:.3f}")
    log(f"[profile-partition] NCCL's all-to-all ranges: {len(nccl)}, "
        f"{sum(nccl) / 1e3:.3f} ms, spanning its copies (Memcpy DtoD, in "
        f"other copies: {len(dtod)}, {sum(dtod) / 1e3:.3f} ms); cudaMalloc "
        f"calls over the 7 warm steps: {mallocs}")
    log("[profile-partition] host operations by self time, ms (calls), "
        "the eager step's beside:")
    eager_top = {name: (us, c) for name, us, c in ep["host_top"]}
    for name, us, count in host_top:
        e_us, e_c = eager_top.get(name, (0.0, 0))
        log(f"[profile-partition]   {us / 1e3:8.3f} ({count:4d})   eager "
            f"{e_us / 1e3:8.3f} ({e_c:4d})  {name[:70]}")
    log("[profile-partition] device time by kind, ms (launches), eager's "
        "beside:")
    for kind, v in kinds.items():
        e = ep["by_kind"].get(kind, {"ms": 0.0, "count": 0})
        log(f"[profile-partition]   {kind:20s} {v['ms']:8.3f} "
            f"({v['count']:4d})   eager {e['ms']:8.3f} ({e['count']:4d})")
    del args, csrs, state

    a2a = {}
    for label, rows in (("layer payload", t // nb),
                        (f"a P = {PART_P4} rank's payload",
                         t // nb // PART_P4)):
        x = torch.randn((rows, n, 6), device="cuda")
        if not torch.equal(t_to_n(x, group), x):
            raise SystemExit("partition: the one-rank all-to-all changed "
                             "its payload")
        b_ms, b_by = bound_ms(2 * x.nbytes, 0.0)
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)       # the host enqueues ahead
        t0 = time.perf_counter()
        for _ in range(20):
            t_to_n(x, group)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        a2a[label] = {"shape": [rows, n, 6], "bytes": x.nbytes,
                      "host_enqueue_us": host_us,
                      "ms": timer(lambda x=x: t_to_n(x, group)),
                      "wrapper_ms": timer(lambda x=x: t_to_n(x, group),
                                          host=True),
                      "clone_ms": timer(x.clone), "bound_ms": b_ms,
                      "bound_by": b_by}
        r = a2a[label]
        log(f"[partition] one-rank all-to-all, {label} ({rows}, {n}, 6) "
            f"f32, {x.nbytes:,} B: {r['ms']:.4f} ms (with its host call "
            f"{r['wrapper_ms']:.4f}), clone() {r['clone_ms']:.4f}, copy "
            f"bound {b_ms:.4f} ({b_ms / r['ms']:.1%}); the host enqueues "
            f"one in {host_us:.1f} us")
        del x
    torch.cuda.empty_cache()
    return {"N": n, "T": t, "nb": nb, "losses": losses,
            "loss_worst_relative": worst, "launches": launches,
            "a2a": {"calls": calls, "bytes": handed, "remote_bytes": remote,
                    "payload_bytes": payload}, "a2a_timed": a2a,
            "step_ms": step_ms, "csr_build_ms": build_ms,
            "step_ms_median_after_first": statistics.median(step_ms[1:]),
            "fit_s": fit_s, "peak_bytes": peak, "base_bytes": base,
            "profile": prof}


def partition_band_checks(torch, n: int, window: int, timer):
    """The bands at the shapes a P = 4 rank's temporal stage gives them:
    (8, lead 4) x N/4 x 6 = 1,132,800 columns, block 0 (t_offset -4) and
    the later blocks (+4), forward and backward, each held to its plain
    version, shown to reject faults and timed beside its bound, plain
    version and cuBLAS's dense band."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    n_rank = n // PART_P4
    bsize, w1 = TRAIN_T // TRAIN_NB, window - 1
    fwd = band_rows(torch, gen, n_rank, window, timer, (
        (bsize, w1, -w1), (bsize, w1, bsize - w1)))
    bwd = band_t_rows(torch, gen, n_rank, window, timer, (
        (bsize, w1, -w1, False), (bsize, w1, bsize - w1, True)))
    return fwd, bwd


def partition_small(torch, dev: str, group) -> dict:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, nb 2,
    partitioned over ``group`` with this rank's tensors on ``dev``: the
    first step's loss and (all-reduced) gradients, then 4 steps' losses."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.core import partition
    from repro_torch.data.dyngnn import DTDGPipeline, synthetic_dataset
    from repro_torch.dist.sharding import ShardLayout
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    n, t, nb = PART_SHARED_N, PART_SHARED_T, PART_SHARED_NB
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t, checkpoint_blocks=nb)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    pipe = DTDGPipeline(ds, nb=nb, device=dev)
    layout = ShardLayout.of(group, nb, t // nb, n)
    args = pipe.rank_arrays(layout)
    csrs = pipe.rank_batch(layout).csr_pairs()
    params = tm.init_params(torch.Generator().manual_seed(7), cfg).to(dev)
    names = [k for k, _ in params.named_parameters()]
    share = partition.snapshot_partition_loss(cfg, group)(params, *args,
                                                          csrs=csrs)
    grads = torch.autograd.grad(share, list(params.parameters()))
    for g in grads:
        dist.all_reduce(g, group=group)
    loss = share.detach().clone()
    dist.all_reduce(loss, group=group)
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2,
                                total_steps=PART_SHARED_STEPS,
                                weight_decay=0.0)
    step = trainer.make_dyngnn_train_step(cfg, group, opt_cfg)
    opt = adamw.init_state(params)
    losses = []
    for _ in range(PART_SHARED_STEPS):
        params, opt, lv = step(params, opt, *args, csrs=csrs)
        losses.append(float(lv))
    return {"loss": float(loss), "losses": losses, "names": names,
            "grads": [g.cpu().numpy() for g in grads]}


def _rank_setup(rank: int, src: str, store: str, world: int):
    """A spawned rank sharing cuda:0: the repository on the path, TF32
    off, ``SHARED_THREADS`` CPU threads, rank ``rank`` of a gloo group of
    ``world`` over ``store`` -> (torch, dist)."""
    import datetime

    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(SHARED_THREADS)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    return torch, dist


def start_ranks(fn, nprocs: int, args: tuple):
    """Spawn ``nprocs`` ranks of ``fn(rank, *args)`` -> their context."""
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


def join_ranks(ctx, name: str, end: float) -> None:
    """Join the ranks of ``ctx`` by ``end`` (``time.monotonic()``); a
    failure, or the deadline, kills them and fails."""
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                raise SystemExit(f"{name}: ranks still running at the "
                                 "deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def small_close(name: str, got: dict, want: dict) -> float:
    """Losses within 1e-4 relative, first-step loss and gradients within
    1e-4 x each leaf's max |value| -> the worst share of its limit."""
    worst = max(abs(a - b) / (TOL_GRAD * abs(b)) for a, b in zip(
        got["losses"] + [got["loss"]], want["losses"] + [want["loss"]],
        strict=True))
    for k, a, b in zip(want["names"], got["grads"], want["grads"],
                       strict=True):
        ratio = float(abs(a - b).max()) / (
            TOL_GRAD * max(float(abs(b).max()), 1e-30))
        worst = max(worst, ratio)
        if not ratio <= 1.0:
            raise SystemExit(f"{name}: gradient {k} at {ratio:.3f} x its "
                             "limit")
    if not worst <= 1.0:
        raise SystemExit(f"{name}: losses {got['losses']} vs "
                         f"{want['losses']}")
    return worst


def partition_shared_check(one: dict, res: list, ranks_s: float) -> dict:
    """P = 2 ranks sharing the one card over gloo, with CUDA tensors (the
    pair of ``shared_card``): the small partitioned TM-GCN on cuda:0, then
    on the CPU; held to each other (rank 0 = rank 1), card against CPU and
    against the card's P = 1 run over NCCL (``one``)."""
    for dev in ("cuda", "cpu"):
        a, b = res[0][dev], res[1][dev]
        if a["losses"] != b["losses"] or not all(
                (x == y).all() for x, y in zip(a["grads"], b["grads"],
                                               strict=True)):
            raise SystemExit(f"partition shared card: the two ranks "
                             f"disagree on {dev}")
    two = res[0]["cuda"]
    vs_cpu = small_close("P = 2 card vs CPU", two, res[0]["cpu"])
    vs_one = small_close("P = 2 vs P = 1 on the card", two, one)
    log(f"[partition-shared] P = 2 gloo ranks on cuda:0: losses "
        + ", ".join(f"{v:.6f}" for v in two["losses"])
        + f"; card vs CPU gloo P = 2 within {vs_cpu:.3f} of the limits, vs "
        f"the card's P = 1 within {vs_one:.3f} (loss 1e-4 relative, "
        f"gradients {TOL_GRAD} x each leaf's max)")
    return {"N": PART_SHARED_N, "T": PART_SHARED_T, "losses": two["losses"],
            "losses_cpu": res[0]["cpu"]["losses"], "losses_p1": one["losses"],
            "worst_vs_cpu": vs_cpu, "worst_vs_p1": vs_one,
            "ranks_s": ranks_s}


# ------------------------------------------------- distributed stream ------

def dstream_run(torch, kernels, obs, cfg, ds, pipe, group, stream,
                **kw) -> dict:
    """One ``train_distributed_streamed`` run on the card over ``group``
    from the seed-0 parameters, on the rank's cached ``stream``, every
    count zeroed just before and read just after -> {losses, params,
    launches, counters, wall_s, per_shard_bytes}."""
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.stream import distributed as sd

    kw.setdefault("num_epochs", DSTREAM_EPOCHS)
    before = dict(obs.metrics_snapshot()["counters"])
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sd.train_distributed_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
        block_size=pipe.bsize, stats=pipe.stream_stats,
        max_edges=pipe.max_edges, shard_stream=stream, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    now = dict(obs.metrics_snapshot()["counters"])
    return {"losses": st.losses, "params": st.params, "launches": launches,
            "counters": {k: now.get(k, 0) - before.get(k, 0) for k in now},
            "wall_s": wall, "per_shard_bytes": st.per_shard_bytes}


def same_params(a, b) -> bool:
    return all(x.equal(y) for x, y in zip(a.parameters(), b.parameters(),
                                          strict=True))


def drift(a: list, b: list) -> float:
    return max(abs(x - y) for x, y in zip(a, b, strict=True))


def worst_rel(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b, strict=True))


def dstream_path(torch, kernels, obs, ds, pipe, group, timer):
    """The distributed stream at P = 1 over the one-rank NCCL group:
    ``paper_dyngnn`` at the full config's widths on the train phase's trace
    (N = 755,200, T = 32, block 8: 4 rounds an epoch), 2 epochs through
    ``Engine(plan=ExecutionPlan(mode="streamed_mesh", mesh=group),
    device="cuda")``, every count zeroed just before the fit and read just
    after (per round the streamed slice step's 24 / 2 / 2 / 0 launches and
    16 CSR builds, 8 all-to-alls of one layer's (8, N, 6) f32 payload, none
    of it leaving the rank); its loss stream held to the single-device
    ``train_streamed(slice_len=8)`` at rtol 1e-5; then on the rank's cached
    stream: overlap off (identical), ``pipeline_rounds`` and ``a2a_chunks =
    2`` (rtol 1e-5 against the serial run), ``int8_a2a`` and ``int8_all``
    (within DRIFT_ATOL of ``none``; their all-to-all bytes), a fenced run
    (the round's transfer / CSR pair / step medians), ``pipeline_rounds``
    off and on in turns; then one layer's int8 all-to-all, its quantize
    and dequantize passes apart, beside the f32 one and their copy bounds
    -> the path's numbers."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.data.dyngnn import DTDGPipeline
    from repro_torch.dist import compression as comp
    from repro_torch.dist import sharding
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import Engine, ExecutionPlan, InMemoryDTDG, RunConfig
    from repro_torch.stream import train_loop as st

    cfg = registry.get_arch("paper_dyngnn").make_config()
    if pipe is None:
        t0 = time.perf_counter()
        pipe = DTDGPipeline(ds, nb=cfg.checkpoint_blocks, device="cuda")
        log(f"[dstream] pipeline (stats + one encode pass) "
            f"{time.perf_counter() - t0:.1f} s on the host")
    n, t, layers = ds.num_nodes, ds.num_steps, cfg.num_layers
    win = pipe.bsize
    rounds = DSTREAM_EPOCHS * t // win
    cfg = dataclasses.replace(cfg, num_nodes=n, num_steps=t)

    t0 = time.perf_counter()
    ref = st.train_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        block_size=win, num_epochs=DSTREAM_EPOCHS, stats=pipe.stream_stats,
        max_edges=pipe.max_edges, slice_len=win, device="cuda")
    ref_s = time.perf_counter() - t0

    eng = Engine(RunConfig(model=cfg, data=InMemoryDTDG(ds, pipeline=pipe),
                           plan=ExecutionPlan(mode="streamed_mesh",
                                              mesh=group,
                                              num_epochs=DSTREAM_EPOCHS),
                           log_every=4, log_fn=log), device="cuda")
    rr = eng.resolve()
    if rr.cfg.checkpoint_blocks != cfg.checkpoint_blocks:
        raise SystemExit("dstream: the plan re-blocked the timeline")
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True, fence=False)   # host-clock rounds
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    obs.configure(enabled=False)
    peak = torch.cuda.max_memory_allocated()
    check_stream_counts("dstream", launches, rounds, win, layers)
    round_s = sum(sp.dur_s for sp in tracer.spans() if sp.name == "round")
    losses = res.losses
    rel = worst_rel(losses, ref.losses)
    if not (len(losses) == rounds and np.isfinite(losses).all()
            and rel <= 1e-5):
        raise SystemExit(f"dstream: losses {losses} against the slice "
                         f"stream's {ref.losses} (worst relative {rel:.2e})")
    counters = res.metrics["counters"]
    payload = win * n * 6 * 4
    calls = counters.get("partition.a2a_calls", 0)
    handed = counters.get("partition.a2a_bytes", 0)
    remote = counters.get("partition.a2a_remote_bytes", 0)
    want_calls = rounds * 4 * layers          # forward 2 L, backward 2 L
    if (calls != want_calls or handed != calls * payload or remote != 0
            or counters.get("stream.rounds") != rounds):
        raise SystemExit(f"dstream: {calls} all-to-alls of {handed} B "
                         f"({remote} B remote), expected {want_calls} of "
                         f"{payload} B each, none remote")
    per_shard = res.per_shard_bytes
    naive = res.transfer_report["naive"]
    log(f"[dstream] P = 1 over NCCL, N={n} T={t} block {win}: "
        f"{rounds} rounds in {fit_s:.2f} s of fit (the rank's encode "
        f"included; rounds {round_s:.2f} s on the host clock); losses "
        + ", ".join(f"{v:.5f}" for v in losses) + f"; against "
        f"train_streamed(slice_len={win}) on the card ({ref_s:.2f} s): worst "
        f"relative {rel:.2e} (limit 1e-5)")
    log(f"[dstream] a round: {calls // rounds} all-to-alls, "
        f"{handed // rounds:,} B handed to NCCL, {remote} B remote; the "
        f"rank's stream {per_shard[0]:,} B, {per_shard[0] / naive:.3f} of "
        f"naive ({naive:,} B); peak {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} above the {base / 1e9:.3f} allocated "
        "before the fit (streamed 0.821, eager 5.266 GB: PERF.md)")

    stream = rr.cache["shard_stream"]
    runs = {"overlap_off": dstream_run(torch, kernels, obs, cfg, ds, pipe,
                                       group, stream, overlap=False),
            "pipelined": dstream_run(torch, kernels, obs, cfg, ds, pipe,
                                     group, stream, pipeline_rounds=True),
            "chunks_2": dstream_run(torch, kernels, obs, cfg, ds, pipe,
                                    group, stream, a2a_chunks=2),
            "int8_a2a": dstream_run(torch, kernels, obs, cfg, ds, pipe,
                                    group, stream, compression="int8_a2a")}
    t0 = time.perf_counter()
    stream8 = pipe.sharded_streams(1, wire="int8", rank=0)[0]
    enc8_s = time.perf_counter() - t0
    runs["int8_all"] = dstream_run(torch, kernels, obs, cfg, ds, pipe, group,
                                   stream8, compression="int8_all")
    for name, r in runs.items():
        check_stream_counts(f"dstream ({name})", r["launches"], rounds, win,
                            layers)
    if runs["overlap_off"]["losses"] != losses or not same_params(
            runs["overlap_off"]["params"], res.state.params):
        raise SystemExit("dstream: overlap on and off disagree")
    for name in ("pipelined", "chunks_2"):
        rel_k = worst_rel(runs[name]["losses"], losses)
        if not rel_k <= 1e-5:
            raise SystemExit(f"dstream: {name} at {rel_k:.2e} of the serial "
                             "run (limit 1e-5)")
    a2a_bytes = {"f32": handed // rounds}
    for name in ("int8_a2a", "int8_all"):
        d = drift(runs[name]["losses"], losses)
        if not d <= DRIFT_ATOL:
            raise SystemExit(f"dstream: {name} drifts {d:.2e} from none "
                             f"(limit {DRIFT_ATOL})")
        c = runs[name]["counters"]
        a2a_bytes[name] = c.get("partition.a2a_bytes", 0) // rounds
        want_q = win * n * 6 * 4 * layers + 4 * 4 * layers
        if (c.get("partition.a2a_calls") != 2 * want_calls
                or a2a_bytes[name] != want_q
                or c.get("partition.a2a_remote_bytes") != 0):
            raise SystemExit(f"dstream: {name} handed {c} to NCCL, "
                             f"expected {2 * want_calls} calls and "
                             f"{want_q} B a round")
    log("[dstream] overlap off: identical; pipeline_rounds "
        f"{worst_rel(runs['pipelined']['losses'], losses):.1e}, "
        f"a2a_chunks 2 {worst_rel(runs['chunks_2']['losses'], losses):.1e} "
        "relative (limit 1e-5); int8_a2a drift "
        f"{drift(runs['int8_a2a']['losses'], losses):.2e}, int8_all "
        f"{drift(runs['int8_all']['losses'], losses):.2e} (limit "
        f"{DRIFT_ATOL}); a round hands NCCL {a2a_bytes['f32']:,} B in f32, "
        f"{a2a_bytes['int8_a2a']:,} B in int8 "
        f"({a2a_bytes['int8_a2a'] / a2a_bytes['f32']:.3f}); the int8 wire "
        f"stream {runs['int8_all']['per_shard_bytes'][0]:,} B against "
        f"{per_shard[0]:,} (encoded in {enc8_s:.1f} s)")

    # the round's phases: fenced spans serialize the schedule (the derived
    # phases and their probe are the trace group's)
    tracer = obs.configure(enabled=True, fence=True, phases=False)
    fenced = dstream_run(torch, kernels, obs, cfg, ds, pipe, group, stream,
                         overlap=False)
    spans = tracer.spans()
    obs.configure(enabled=False)
    phases = {k: phase_ms(spans, name) for k, name in (
        ("transfer", "round.transfer"), ("step", "round.step"),
        ("csr_pair", "stream.csr_pair"), ("round", "round"))}
    for k, v in phases.items():
        if len(v) != rounds:
            raise SystemExit(f"dstream: {len(v)} {k} spans, expected "
                             f"{rounds}")
    med = {k: statistics.median(v) for k, v in phases.items()}
    log("[dstream] a round, fenced spans (median / max ms): " + ", ".join(
        f"{k} {med[k]:.2f} / {max(phases[k]):.2f}" for k in phases))
    if fenced["losses"] != losses:
        raise SystemExit("dstream: the fenced run's losses differ")

    walls = {False: [], True: []}
    for _ in range(DSTREAM_PAIRS):
        for pr in (False, True):
            r = dstream_run(torch, kernels, obs, cfg, ds, pipe, group, stream,
                            num_epochs=1, pipeline_rounds=pr)
            walls[pr].append(r["wall_s"] * 1e3 / (t // win))
    off_ms, on_ms = min(walls[False]), min(walls[True])
    log(f"[dstream] a round (host clock over 1-epoch runs in turns, ms): "
        f"pipeline_rounds off {', '.join(f'{v:.1f}' for v in walls[False])}"
        f"; on {', '.join(f'{v:.1f}' for v in walls[True])}; the faster of "
        f"each {off_ms:.1f} / {on_ms:.1f} ({1 - on_ms / off_ms:+.1%} with it)")

    knobs = {"pipelined_rel": worst_rel(runs["pipelined"]["losses"], losses),
             "chunks_2_rel": worst_rel(runs["chunks_2"]["losses"], losses),
             "int8_a2a_drift": drift(runs["int8_a2a"]["losses"], losses),
             "int8_all_drift": drift(runs["int8_all"]["losses"], losses),
             "int8_all_stream_bytes": runs["int8_all"]["per_shard_bytes"]}
    a2a = dstream_a2a_timing(torch, comp, sharding, group, n, win, timer)
    del eng, rr, runs, fenced, stream, stream8
    gc.collect()
    torch.cuda.empty_cache()
    return {"N": n, "T": t, "block": win, "rounds": rounds,
            "losses": losses, "losses_slice_stream": ref.losses,
            "loss_worst_relative": rel, "launches": launches,
            "a2a": {"calls": calls, "bytes": handed, "remote_bytes": remote,
                    "payload_bytes": payload, "per_round_bytes": a2a_bytes},
            "per_shard_bytes": per_shard, "naive_bytes": naive,
            "fit_s": fit_s, "rounds_host_s": round_s, "ref_s": ref_s,
            "int8_wire_encode_s": enc8_s, "peak_bytes": peak,
            "base_bytes": base, "fenced_ms": med,
            "pipeline_rounds_ms": {"off": walls[False], "on": walls[True]},
            "knobs": knobs, "a2a_timed": a2a}


def dstream_a2a_timing(torch, comp, sharding, group, n: int, win: int,
                       timer) -> dict:
    """One layer's payload (win, N, 6) through the one-rank all-to-all:
    f32 (``t_to_n``), and on the int8 wire (``quantized_t_to_n``: the
    residual added, quantize, the int8 and scale all-to-alls, dequantize,
    the new residual), with its quantize pass, its int8 all-to-all and its
    dequantize pass timed apart; each beside its copy bound (bytes read
    once and written once at 3.35 TB/s)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((win, n, 6), generator=gen, device="cuda")
    res = torch.randn((win, n, 6), generator=gen, device="cuda") * 0.01
    pieces = sharding.t2n_send(x + res, 1)
    q, scales = comp.quantize_pieces(pieces)
    back = comp.dequantize_pieces(q, scales)
    if not (torch.equal(comp.quantized_t_to_n(x, res, group)[0],
                        sharding.t2n_recv(back))
            and torch.equal(sharding.all_to_all(q, group), q)):
        raise SystemExit("dstream: the one-rank int8 all-to-all changed its "
                         "payload")
    elems = x.numel()
    fns = {"f32_a2a": (lambda: sharding.t_to_n(x, group), 8 * elems),
           "int8_a2a": (lambda: sharding.all_to_all(q, group), 2 * elems),
           "quantize": (lambda: comp.quantize_pieces(pieces), 5 * elems),
           "dequantize": (lambda: comp.dequantize_pieces(q, scales),
                          5 * elems),
           "quantized_t_to_n": (lambda: comp.quantized_t_to_n(x, res, group),
                                16 * elems)}
    times = timer.turns({k: f for k, (f, _) in fns.items()})
    out = {}
    for k, (f, nbytes) in fns.items():
        b_ms, _ = bound_ms(nbytes, 0.0)
        out[k] = {"ms": times[k], "wrapper_ms": timer(f, host=True),
                  "bytes": nbytes, "bound_ms": b_ms}
        log(f"[dstream] {k} on ({win}, {n}, 6): {times[k]:.4f} ms (with its "
            f"host calls {out[k]['wrapper_ms']:.4f}), copy bound "
            f"{b_ms:.4f} ({b_ms / times[k]:.1%})")
    return out


def dstream_small(torch, dev: str, group, compression: str) -> list:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, block 4,
    the distributed stream over ``group`` with this rank's tensors on
    ``dev``, 2 epochs from the seed-7 parameters -> the loss stream."""
    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset
    from repro_torch.stream import distributed as sd

    n, t, nb = DSTREAM_SHARED_N, DSTREAM_SHARED_T, DSTREAM_SHARED_NB
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t, checkpoint_blocks=nb)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    params = tm.init_params(torch.Generator().manual_seed(7), cfg)
    return sd.train_distributed_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
        num_epochs=DSTREAM_EPOCHS, params=params, compression=compression,
        pipeline_rounds=True, device=dev).losses


def dstream_shared_ref(torch, group) -> dict:
    """The card's P = 1 small distributed streams over NCCL, per
    compression."""
    return {c: dstream_small(torch, "cuda", group, c)
            for c in ("none", "int8_a2a")}


def dstream_shared_check(one: dict, res: list, ranks_s: float) -> dict:
    """P = 2 ranks sharing the one card over gloo, with CUDA tensors (the
    pair of ``shared_card``): the small distributed stream on cuda:0, then
    on the CPU, for ``none`` and ``int8_a2a``; held to each other (rank 0
    = rank 1), card against CPU gloo P = 2 (1e-4 relative) and against the
    card's P = 1 over NCCL (``one``; ``none`` 1e-4 relative; ``int8_a2a``
    within DRIFT_ATOL: its pieces, and so its scales, differ with P)."""
    out = {"N": DSTREAM_SHARED_N, "T": DSTREAM_SHARED_T, "ranks_s": ranks_s,
           "p1": one}
    for c in ("none", "int8_a2a"):
        card, cpu = res[0][(c, "cuda")], res[0][(c, "cpu")]
        if res[1][(c, "cuda")] != card or res[1][(c, "cpu")] != cpu:
            raise SystemExit(f"dstream shared card: the two ranks disagree "
                             f"({c})")
        vs_cpu = worst_rel(card, cpu)
        vs_one = (worst_rel(card, one[c]) if c == "none"
                  else drift(card, one[c]))
        limit_one = TOL_GRAD if c == "none" else DRIFT_ATOL
        if not (vs_cpu <= TOL_GRAD and vs_one <= limit_one):
            raise SystemExit(f"dstream shared card {c}: {card} vs CPU {cpu} "
                             f"and P = 1 {one[c]}")
        out[c] = {"losses": card, "losses_cpu": cpu, "vs_cpu": vs_cpu,
                  "vs_p1": vs_one}
        log(f"[dstream-shared] {c}: P = 2 gloo ranks on cuda:0, losses "
            + ", ".join(f"{v:.6f}" for v in card)
            + f"; vs CPU gloo P = 2 {vs_cpu:.2e} relative (limit "
            f"{TOL_GRAD}), vs the card's P = 1 {vs_one:.2e} (limit "
            f"{limit_one}{' relative' if c == 'none' else ' absolute'})")
    return out


# ------------------------------------------------------------- hybrid ------

def hybrid_batch(torch, ds, n: int, pm: int, dev: str):
    """The dataset's padded batch on ``dev`` and its edges split into
    ``pm`` destination shards (``partition_edges_for_hybrid``, on the
    host) -> (batch, edges (T, pm E, 2), weights (T, pm E) on ``dev``)."""
    from repro_torch.core import dtdg, hybrid

    batch = dtdg.build_batch(ds.snapshots, ds.frames, n, values=ds.values,
                             device=dev)
    e_h, w_h = hybrid.partition_edges_for_hybrid(
        batch.edges.cpu().numpy(), batch.edge_weights.cpu().numpy(),
        batch.edge_mask.cpu().numpy(), n, pm=pm,
        max_local_edges=batch.edges.shape[1])
    return (batch, torch.from_numpy(e_h).to(dev),
            torch.from_numpy(w_h).to(dev))


def hybrid_path(torch, kernels, ds, group, timer):
    """The hybrid scheme (§6.5) at full width on a 1 x 1 grid over the
    one-rank NCCL group: ``paper_dyngnn``'s widths on the train phase's
    trace (N = 755,200, T = 32), its edges split into the one destination
    shard, ``core.hybrid.hybrid_forward`` (random seed-0 parameters), every
    count zeroed just before the forward and read just after (L T
    ``segment_spmm``, L ``banded_ttm``, T rectangular CSR builds); Z held
    to ``models.forward`` on the same batch (1e-5: the same CSRs and
    kernels, so 0.0 is expected); the forward timed beside the eager one
    (``forward_slice`` building its T CSRs, as the hybrid forward does);
    then the rectangular kernel at a Pm = 4 rank's shape -> the path's
    numbers."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core import hybrid
    from repro_torch.core import models as tm
    from repro_torch.dist import sharding
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    n, t = ds.num_nodes, ds.num_steps
    cfg = dataclasses.replace(registry.get_arch("paper_dyngnn").make_config(),
                              num_nodes=n, num_steps=t)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    batch, e_h, w_h = hybrid_batch(torch, ds, n, 1, "cuda")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    grid = sharding.make_grid(1, 1, group)
    params = tm.init_params(torch.Generator().manual_seed(0), cfg).to("cuda")
    fwd = hybrid.hybrid_forward(cfg, grid)
    frames, edges, ew = hybrid.local_blocks(grid, batch.frames, e_h, w_h)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    z = fwd(params, frames, edges, ew)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    peak = torch.cuda.max_memory_allocated()
    check_launches("hybrid", launches, {
        "segment_spmm": layers * t, "banded_ttm": layers,
        "banded_ttm_t": 0, "flash_decode": 0})
    if launches["csr_builds"] != t:
        raise SystemExit(f"hybrid: {launches['csr_builds']} CSR builds, "
                         f"expected {t}")
    with torch.no_grad():
        want = tm.forward(cfg, params, batch)
    if z.shape != want.shape or not bool(torch.isfinite(z).all()):
        raise SystemExit(f"hybrid: Z {tuple(z.shape)} against "
                         f"{tuple(want.shape)}, or not finite")
    err = check_close("hybrid Z vs models.forward", z, want, TOL_TTM)

    def eager():
        with torch.no_grad():
            return tm.forward_slice(cfg, params, batch.frames, batch.edges,
                                    batch.edge_weights,
                                    tm.init_carries(cfg, params,
                                                    device="cuda"), 0)[0]

    walls = alternating_walls(torch, {
        "hybrid": lambda: fwd(params, frames, edges, ew), "eager": eager},
        rounds=HYBRID_REPS)
    log(f"[hybrid] 1 x 1 grid over NCCL, N={n} T={t}: Z max|err| {err:.2e} "
        f"against models.forward (limit {TOL_TTM} abs + rel); forward "
        f"{walls['hybrid']:.2f} ms against the eager forward's "
        f"{walls['eager']:.2f} (host clock, {HYBRID_REPS - 1} rounds in "
        f"turns, each building its {t} CSRs); peak {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} above the batch; batch and shard "
        f"split {prep_s:.1f} s")
    del z, want, frames, edges, ew, e_h, w_h
    gc.collect()
    gather = frame_gather_ms(torch, group, t, n, cfg.hidden, timer)
    log(f"[hybrid] one-rank frame all-gather ({t}, {n}, {cfg.hidden}) "
        f"over NCCL: into one tensor {gather['into_tensor']:.4f} ms, into a "
        f"list of its views {gather['list']:.4f}, one copy of the frame "
        f"{gather['copy']:.4f} (device time, in turns)")
    rect = hybrid_rect_check(torch, batch, n, timer)
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"N": n, "T": t, "launches": launches, "max_abs_err": err,
            "forward_ms": walls, "peak_bytes": peak, "base_bytes": base,
            "prep_s": prep_s, "frame_all_gather_ms": gather,
            "rectangular": rect}


def frame_gather_ms(torch, group, t: int, n: int, f: int, timer) -> dict:
    """The hybrid forward's frame all-gather at its (T, N, F) shape over
    ``group``, two ways: ``all_gather_into_tensor`` into one buffer (what
    ``dist.sharding.all_gather`` issues) and ``all_gather`` into
    a list of that buffer's views (which NCCL gathers into a staging
    buffer and copies out), beside one copy of the frame -> {way: median
    device ms}."""
    import torch.distributed as dist

    x = torch.ones((t, n, f), device="cuda")
    out = x.new_empty((dist.get_world_size(group),) + tuple(x.shape))
    ms = timer.turns({
        "into_tensor": lambda: dist.all_gather_into_tensor(
            out.flatten(0, 1), x, group=group),
        "list": lambda: dist.all_gather(list(out.unbind(0)), x,
                                        group=group),
        "copy": lambda: out[0].copy_(x)})
    del x, out
    return ms


def hybrid_rect_check(torch, batch, n: int, timer) -> list:
    """``segment_spmm`` on a rectangular CSR at a Pm = 4 rank's shape:
    the last snapshot's edges (self-loops and Laplacian weights) whose
    destination is rank 1's (N/4 rows, ids made local), gathered from all
    N source rows; at F = 2 and 6, held to the plain version, shown to
    reject zeros and each row's last edge dropped, timed beside its bound
    (its bytes count each x row the CSR gathers once, and no other), the
    plain version and ``torch.sparse.mm`` on the same (N/4, N) matrix."""
    from repro_torch.kernels.segment_spmm import ops, ref

    n_loc = n // 4
    e, w = batch.edges[-1], batch.edge_weights[-1]
    sel = (e[:, 1] >= n_loc) & (e[:, 1] < 2 * n_loc) & (w != 0)
    e_loc = e[sel].clone()
    e_loc[:, 1] -= n_loc
    w_loc = w[sel].contiguous()
    row_ptr, col, wc = ops.build_csr(e_loc, w_loc, n_loc)
    nnz = int(row_ptr[-1])
    x_rows = int(torch.unique(col[:nnz]).numel())
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for f in (2, 6):
        x = torch.randn((n, f), generator=gen, device="cuda")
        got = ops.segment_spmm_csr(x, row_ptr, col, wc)
        want = ref.segment_spmm_csr_ref(x, row_ptr, col, wc)
        torch.cuda.synchronize()
        if got.shape != (n_loc, f):
            raise SystemExit(f"segment_spmm rectangular: {tuple(got.shape)}"
                             f", expected {(n_loc, f)}")
        err = check_close(f"segment_spmm rectangular F={f}", got, want,
                          TOL_SPMM)
        faults = spmm_faults(f"rectangular F={f}", ops, x, row_ptr, col, wc,
                             want)
        csr = torch.sparse_csr_tensor(row_ptr, col[:nnz], wc[:nnz],
                                      size=(n_loc, n),
                                      check_invariants=False)
        lib_err = float((torch.sparse.mm(csr, x) - want).abs().max())
        # each x row the CSR gathers is read once; the others not at all
        nbytes = (x_rows * f * x.element_size() + row_ptr.nbytes + nnz * 8
                  + got.nbytes)
        b_ms, b_by = bound_ms(nbytes, 2.0 * nnz * f)
        row = {"F": f, "rows": n_loc, "source_rows": n,
               "source_rows_read": x_rows, "nnz": nnz,
               "ms": timer(lambda x=x: ops.segment_spmm_csr(x, row_ptr, col,
                                                            wc)),
               "wrapper_ms": timer(lambda x=x: ops.segment_spmm_csr(
                   x, row_ptr, col, wc), host=True),
               "plain_ms": timer(lambda x=x: ref.segment_spmm_csr_ref(
                   x, row_ptr, col, wc)),
               "library_ms": timer(lambda x=x, csr=csr: torch.sparse.mm(
                   csr, x)),
               "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
               "fault_over_limit": faults, "library_max_abs_err": lib_err}
        log(f"[kernel] segment_spmm rectangular ({n_loc} rows from {n}, "
            f"{x_rows} of them read, {nnz} edges) F={f}: kernel "
            f"{row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}), plain "
            f"{row['plain_ms']:.4f}, torch.sparse.mm "
            f"{row['library_ms']:.4f}, bound {b_ms:.4f} "
            f"({b_by}, {b_ms / row['ms']:.1%}); max|err| {err:.2e}; faults "
            f"rejected at x limit: zeros {faults['zeros']:.1f}, last edge "
            f"dropped {faults['last edge dropped']:.1f}")
        rows.append(row)
    return rows


def hybrid_small(torch, dev: str, grid) -> dict:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, through
    ``hybrid_forward`` on ``grid`` with this rank's tensors on ``dev``,
    from the seed-7 parameters -> {rank's Z block, its grid place}."""
    from repro_torch.configs import registry
    from repro_torch.core import hybrid
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset

    n, t = HYBRID_SHARED_N, HYBRID_SHARED_T
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    batch, e_h, w_h = hybrid_batch(torch, ds, n, grid.pm, dev)
    params = tm.init_params(torch.Generator().manual_seed(7), cfg).to(dev)
    blocks = hybrid.local_blocks(grid, batch.frames, e_h, w_h)
    z = hybrid.hybrid_forward(cfg, grid)(params, *blocks)
    out = {"z": z.cpu().numpy(), "place": (grid.data_index,
                                           grid.model_index)}
    if grid.pd * grid.pm == 1:
        with torch.no_grad():
            out["eager"] = tm.forward(cfg, params, batch).cpu().numpy()
    return out


def _hybrid_shared_rank(rank: int, src: str, store: str, out_dir: str):
    """One of four ranks sharing cuda:0 over gloo as a 2 x 2 grid: the
    small hybrid forward on the card, then on the CPU, written to
    ``out_dir``."""
    import pickle

    torch, dist = _rank_setup(rank, src, store, 4)
    from repro_torch.dist import sharding
    try:
        grid = sharding.make_grid(2, 2)
        res = {dev: hybrid_small(torch, dev, grid) for dev in ("cuda", "cpu")}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def hybrid_shared_ref(torch, group) -> dict:
    """The small hybrid forward on the card's 1 x 1 grid over NCCL (and
    its eager forward)."""
    from repro_torch.dist import sharding
    return hybrid_small(torch, "cuda", sharding.make_grid(1, 1, group))


def hybrid_shared_check(one: dict, res: list, ranks_s: float) -> dict:
    """A 2 x 2 grid of four ranks sharing the one card over gloo, with
    CUDA tensors (the quad of ``shared_card``): the small hybrid forward
    on cuda:0, then on the CPU; the ranks' blocks assembled, card against
    CPU gloo and against the card's 1 x 1 grid over NCCL and its eager
    forward (``one``; 1e-4 abs + rel: the kernel sums in another order
    than the plain version)."""
    import numpy as np

    def assemble(dev):
        if [r[dev]["place"] for r in res] != [(0, 0), (0, 1), (1, 0),
                                              (1, 1)]:
            raise SystemExit("hybrid shared card: the ranks' grid places "
                             f"{[r[dev]['place'] for r in res]}")
        return np.concatenate([np.concatenate([res[2 * d + m][dev]["z"]
                                               for m in range(2)], axis=1)
                               for d in range(2)], axis=0)

    card, cpu = assemble("cuda"), assemble("cpu")
    out = {"N": HYBRID_SHARED_N, "T": HYBRID_SHARED_T, "ranks_s": ranks_s}
    for name, want in (("cpu", cpu), ("p1", one["z"]),
                       ("eager", one["eager"])):
        err = float(np.abs(card - want).max())
        limit = TOL_SPMM * (1.0 + float(np.abs(want).max()))
        if not (card.shape == want.shape and err <= limit):
            raise SystemExit(f"hybrid shared card: 2 x 2 on the card vs "
                             f"{name}: max|diff| {err:.3e} > {limit:.3e}")
        out[f"vs_{name}"] = err
    log(f"[hybrid-shared] 2 x 2 gloo ranks on cuda:0, N={HYBRID_SHARED_N} "
        f"T={HYBRID_SHARED_T}: Z max|diff| vs CPU gloo {out['vs_cpu']:.2e}, "
        f"vs the card's 1 x 1 over NCCL {out['vs_p1']:.2e}, vs its eager "
        f"forward {out['vs_eager']:.2e} (limit {TOL_SPMM} abs + rel)")
    return out


# ------------------------------------------------------------ sampled ------

def sampled_path(torch, kernels, obs, ds, group):
    """The sampled schedule at full width over the one-rank NCCL group:
    ``paper_dyngnn`` on the first ``SAMPLED_T`` = 8 steps of the train
    phase's trace (N = 755,200, T = 32), block 4 (one epoch of 2 rounds;
    16 steps in blocks of 8 took ~40 s more of host sampling and
    pipeline), through ``Engine(plan=ExecutionPlan(mode="sampled",
    mesh=group), device="cuda")`` with the launcher's defaults (N / 4
    seeds a round, fanouts 10, 10) and the union's edges capped at the
    largest snapshot's; the budget gate set between the sampled and the
    full-graph round: ``streamed_mesh`` refuses, ``sampled`` trains
    within it; every count zeroed just before the fit and read just after
    (per round the slice step's 12 / 2 / 2 / 0 and 8 CSR builds); fenced
    spans per round (host sampling, staging, the carries' gather,
    all-gather and scatter, the step, its CSR pairs) -> the path's
    numbers.  The 8 steps' pipeline is built once (timed) and handed to
    both the refused ``streamed_mesh`` Engine and the sampled one, whose
    store is ingested from that pipeline's stream, as the worker
    would."""
    import numpy as np

    from repro_torch import hoststore as hs
    from repro_torch.configs import registry
    from repro_torch.data.dyngnn import DTDGPipeline
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import (Engine, ExecutionPlan, InMemoryDTDG,
                                 RunConfig, SamplingSpec)

    win = SAMPLED_BLOCK
    n, t_full = ds.num_nodes, ds.num_steps
    # the trace's first SAMPLED_T steps (the first rounds of the whole
    # trace's epoch), so the host samples SAMPLED_T // win rounds, not
    # t_full // win
    t = SAMPLED_T
    sub = dataclasses.replace(
        ds, snapshots=ds.snapshots[:t], frames=ds.frames[:t],
        labels=ds.labels[:t],
        values=None if ds.values is None else ds.values[:t])
    t0 = time.perf_counter()
    pipe = DTDGPipeline(sub, nb=t // win, device="cuda")
    pipe_s = time.perf_counter() - t0
    cfg = dataclasses.replace(registry.get_arch("paper_dyngnn").make_config(),
                              num_nodes=n, num_steps=t,
                              checkpoint_blocks=t // win)
    layers = cfg.num_layers
    e_max = max(s.shape[0] for s in sub.snapshots)
    spec = SamplingSpec(batch_nodes=n // 4, fanouts=(10, 10),
                        max_edges=e_max)
    resolved = spec.resolve(n, win, 1)
    sampled_b = hs.sampled_round_bytes(resolved, win=win, num_shards=1,
                                       feat_dim=sub.frames.shape[-1])
    full_b = hs.full_graph_round_bytes(
        "streamed_mesh", num_steps=t, win=win, num_shards=1,
        max_edges=pipe.max_edges, num_nodes=n, feat_dim=sub.frames.shape[-1])
    budget = (sampled_b + full_b) // 2
    if not sampled_b < budget < full_b:
        raise SystemExit(f"sampled: no budget between the sampled round's "
                         f"{sampled_b} B and the full one's {full_b} B")
    try:
        Engine(RunConfig(
            model=cfg, data=InMemoryDTDG(sub, pipeline=pipe),
            plan=ExecutionPlan(mode="streamed_mesh", mesh=group,
                               device_budget_bytes=budget),
            log_fn=log), device="cuda").fit()
        raise SystemExit("sampled: streamed_mesh trained within a budget "
                         "below its round")
    except hs.DeviceBudgetError as e:
        refusal = str(e)
    data = InMemoryDTDG(sub, pipeline=pipe)
    eng = Engine(RunConfig(model=cfg, data=data, plan=ExecutionPlan(
        mode="sampled", mesh=group, sampling=spec, num_epochs=SAMPLED_EPOCHS,
        device_budget_bytes=budget), log_every=1, log_fn=log),
        device="cuda")
    rr = eng.resolve()
    if rr.pipeline is not pipe:
        raise SystemExit("sampled: the Engine did not take the 8 steps' "
                         "pipeline")
    t0 = time.perf_counter()
    # what the sampled worker builds when no store is cached: the store
    # ingests the pipeline's own delta items
    rr.cache["host_store"] = hs.TemporalCSRStore.from_stream(
        rr.pipeline.host_stream(), n)
    store_s = time.perf_counter() - t0
    store_bytes = rr.cache["host_store"].nbytes
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True, fence=True)
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    res = eng.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    spans = tracer.spans()
    obs.configure(enabled=False)
    peak = torch.cuda.max_memory_allocated()
    rounds = SAMPLED_EPOCHS * t // win
    check_stream_counts("sampled", launches, rounds, win, layers)
    rep = res.sample_report
    losses = res.losses
    if not (len(losses) == rounds and np.isfinite(losses).all()
            and rep.rounds == rounds):
        raise SystemExit(f"sampled: losses {losses}, {rep.rounds} rounds")
    if res.budget_report != {"required": sampled_b, "budget": budget}:
        raise SystemExit(f"sampled: budget report {res.budget_report}")
    per_round = {k: phase_ms(spans, name) for k, name in (
        ("sample", "sample.round"), ("stage", "sample.stage"),
        ("carry_gather", "carry.gather"), ("step", "round.step"),
        ("csr_pair", "stream.csr_pair"),
        ("carry_all_gather", "carry.all_gather"),
        ("carry_scatter", "carry.scatter"), ("round", "round"),
        ("prefetch_wait", "prefetch.wait"))}
    for k in ("sample", "stage", "carry_gather", "step", "csr_pair",
              "carry_scatter", "round"):
        if len(per_round[k]) != rounds:
            raise SystemExit(f"sampled: {len(per_round[k])} {k} spans, "
                             f"expected {rounds}")
    staged_round = rep.staged_bytes // rounds
    warm_step = statistics.median(per_round["step"][1:])
    log(f"[sampled] P = 1 over NCCL, N={n} T={t} (the first {t} of the "
        f"trace's {t_full} steps) block {win}, "
        f"{spec.batch_nodes} seeds, fanouts {spec.fanouts}: table_pad "
        f"{resolved.table_pad}, edge_pad {resolved.edge_pad} (the largest "
        f"snapshot's {e_max} edges), table filled up to "
        f"{rep.table_fill_max}; dropped {rep.dropped_nodes} nodes, "
        f"{rep.dropped_edges} edges; {rep.sampled_edges} union edges staged")
    log(f"[sampled] {rounds} rounds in {fit_s:.1f} s of fit (store ingest "
        f"{store_s:.1f} s, {store_bytes / 1e6:.1f} MB on the host, before "
        f"it; the pipeline over the {t} steps {pipe_s:.1f} s, before the "
        "refused Engine); losses "
        + ", ".join(f"{v:.5f}" for v in losses))
    for k, v in per_round.items():
        log(f"[sampled]   {k}: " + ", ".join(f"{x:.1f}" for x in v) + " ms")
    log(f"[sampled] warm step {warm_step:.1f} ms (the median of rounds 1-"
        f"{rounds - 1}'s round.step)")
    log(f"[sampled] staged {staged_round:,} B a round (the round's graph "
        f"tensors and its table rows of the carries) "
        f"against the full-graph round's {full_b:,} B; sampled_round_bytes "
        f"{sampled_b:,}; budget {budget:,} B: streamed_mesh refused "
        f"({refusal[:60]}...), sampled fit; peak {peak / 1e9:.3f} GB, "
        f"{(peak - base) / 1e9:.3f} above the {base / 1e9:.3f} allocated "
        "before the fit")
    del eng, rr, res, pipe, data
    gc.collect()
    torch.cuda.empty_cache()
    return {"N": n, "T": t, "T_trace": t_full, "block": win,
            "rounds": rounds,
            "seeds": spec.batch_nodes, "fanouts": list(spec.fanouts),
            "table_pad": resolved.table_pad, "edge_pad": resolved.edge_pad,
            "largest_snapshot_edges": e_max,
            "table_fill_max": rep.table_fill_max,
            "dropped_nodes": rep.dropped_nodes,
            "dropped_edges": rep.dropped_edges,
            "sampled_edges": rep.sampled_edges, "losses": losses,
            "launches": launches, "per_round_ms": per_round,
            "warm_step_ms": warm_step,
            "staged_bytes_per_round": staged_round,
            "sampled_round_bytes": sampled_b, "full_round_bytes": full_b,
            "budget": budget, "peak_bytes": peak, "base_bytes": base,
            "fit_s": fit_s, "store_s": store_s, "store_bytes": store_bytes,
            "pipeline_s": pipe_s}


def sampled_small(torch, dev: str, group, full: bool) -> dict:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, block 4, 2
    epochs over ``group`` with this rank's tensors on ``dev`` from the
    seed-7 parameters: ``train_sampled`` with every vertex a seed and full
    fanout (``full``; then also the distributed stream, its full-graph
    counterpart) or with N / 4 seeds and fanouts 10, 10; the union's edges
    capped at the largest snapshot's -> the loss streams."""
    from repro_torch import hoststore as hs
    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import DTDGPipeline, synthetic_dataset
    from repro_torch.stream import distributed as sd

    n, t, win = SAMPLED_SMALL_N, SAMPLED_SMALL_T, SAMPLED_SMALL_BLOCK
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t,
                              checkpoint_blocks=t // win)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    pipe = DTDGPipeline(ds, nb=t // win, device=dev)
    store = hs.TemporalCSRStore.from_stream(pipe.host_stream(), n)
    e_max = max(s.shape[0] for s in ds.snapshots)
    deg = store.max_in_degree()
    spec = (hs.SamplingSpec(batch_nodes=n, fanouts=(deg, deg),
                            max_edges=e_max) if full
            else hs.SamplingSpec(batch_nodes=n // 4, fanouts=(10, 10),
                                 max_edges=e_max))

    def params():
        return tm.init_params(torch.Generator().manual_seed(7), cfg)

    st = hs.train_sampled(cfg, store, ds.frames, ds.labels, spec=spec,
                          mesh=group, block_size=win,
                          num_epochs=SAMPLED_SMALL_EPOCHS, params=params(),
                          device=dev)
    out = {"losses": st.losses, "dropped": (st.report.dropped_nodes,
                                            st.report.dropped_edges),
           "max_in_degree": deg}
    if full:
        out["streamed_mesh"] = sd.train_distributed_streamed(
            cfg, ds.snapshots, ds.values, ds.frames, ds.labels, mesh=group,
            block_size=win, num_epochs=SAMPLED_SMALL_EPOCHS,
            stats=pipe.stream_stats, max_edges=pipe.max_edges,
            params=params(), device=dev).losses
    return out


def sampled_equivalence(torch, group) -> dict:
    """Every vertex a seed and full fanout on the card: the sampled loss
    stream equals the distributed stream's (rtol 1e-5), as
    ``tests/test_torch_hoststore.py`` pins on the CPU."""
    t0 = time.perf_counter()
    got = sampled_small(torch, "cuda", group, full=True)
    wall = time.perf_counter() - t0
    rel = worst_rel(got["losses"], got["streamed_mesh"])
    if not (rel <= 1e-5 and got["dropped"] == (0, 0)):
        raise SystemExit(f"sampled equivalence: {got['losses']} against "
                         f"streamed_mesh {got['streamed_mesh']} (worst "
                         f"relative {rel:.2e}), dropped {got['dropped']}")
    log(f"[sampled] full fanout (every vertex a seed, fanout = max in-degree "
        f"{got['max_in_degree']}) at N={SAMPLED_SMALL_N} T={SAMPLED_SMALL_T} "
        f"on the card: losses " + ", ".join(f"{v:.6f}" for v in got["losses"])
        + f" against streamed_mesh's, worst relative {rel:.2e} (limit 1e-5; "
        f"{wall:.1f} s)")
    return {"losses": got["losses"], "streamed_mesh": got["streamed_mesh"],
            "worst_relative": rel, "max_in_degree": got["max_in_degree"],
            "wall_s": wall}


def sampled_shared_ref(torch, group) -> list:
    """The card's P = 1 small sampled run over NCCL -> its losses."""
    return sampled_small(torch, "cuda", group, full=False)["losses"]


def sampled_shared_check(one: list, res: list, ranks_s: float) -> dict:
    """P = 2 ranks sharing the one card over gloo, with CUDA tensors (the
    pair of ``shared_card``): the small sampled run on cuda:0, then on the
    CPU; held to each other, card against CPU gloo P = 2 and against the
    card's P = 1 over NCCL (``one``; 1e-4 relative: the rounds are the
    same samples)."""
    if res[0] != res[1]:
        raise SystemExit(f"sampled shared card: the ranks disagree {res}")
    card, cpu = res[0]["cuda"], res[0]["cpu"]
    vs_cpu, vs_one = worst_rel(card, cpu), worst_rel(card, one)
    if not (vs_cpu <= TOL_GRAD and vs_one <= TOL_GRAD):
        raise SystemExit(f"sampled shared card: {card} vs CPU {cpu} and "
                         f"P = 1 {one}")
    log(f"[sampled-shared] P = 2 gloo ranks on cuda:0: losses "
        + ", ".join(f"{v:.6f}" for v in card)
        + f"; vs CPU gloo P = 2 {vs_cpu:.2e}, vs the card's P = 1 "
        f"{vs_one:.2e} relative (limit {TOL_GRAD})")
    return {"N": SAMPLED_SMALL_N, "T": SAMPLED_SMALL_T, "losses": card,
            "losses_cpu": cpu, "losses_p1": one, "vs_cpu": vs_cpu,
            "vs_p1": vs_one, "ranks_s": ranks_s}


# ----------------------------------------------------- fault tolerance -----

def ft_counts(kernels) -> dict:
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    out = {k.name: k.launches for k in kernels}
    out["csr_builds"] = spmm_ops.csr_builds
    return out


def ft_zero(kernels) -> None:
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    reset_counts(kernels)
    spmm_ops.csr_builds = 0


def ckpt_costs(torch, tree, d: Path) -> dict:
    """Two ``Checkpointer`` saves of ``tree``: each call's blocking ms (the
    device-to-host copies; the first also allocates the pinned buffers the
    second reuses) and its writer thread's s; the bytes on disk; one
    restore onto the card (ms, synchronized)."""
    from repro_torch.ckpt import Checkpointer

    ck = Checkpointer(d)
    blocking, write = [], []
    for step in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(step, tree)
        blocking.append(time.perf_counter() - t0)
        ck.wait()
        write.append(time.perf_counter() - t0 - blocking[-1])
    on_disk = sum(f.stat().st_size for f in (d / "step_2").iterdir())
    t0 = time.perf_counter()
    ck.restore(2, tree)
    torch.cuda.synchronize()
    return {"save_blocking_ms": blocking[1] * 1e3,
            "first_save_blocking_ms": blocking[0] * 1e3,
            "write_s": write[1], "first_write_s": write[0],
            "bytes_on_disk": on_disk,
            "restore_ms": (time.perf_counter() - t0) * 1e3}


def ft_eager(torch, kernels, obs, ds, pipe, train_losses):
    """Eager fault tolerance at full width, P = 1: ``paper_dyngnn`` on the
    train trace through ``Engine(device="cuda")`` with
    ``CheckpointSpec(every=5)``: a 5-step fit, then ``Engine.resume()`` to
    step 10, every count zeroed just before and read just after (10 steps'
    160 / 12 / 8 / 0 a step), against the uninterrupted 10-step run (and
    the train phase's losses when it ran): losses of steps 5-9 and the
    final parameters within rtol 1e-5 (max |diff| expected 0); then one
    save and restore of the (params, AdamW) tree beside the warm step."""
    import tempfile

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.run import (CheckpointSpec, Engine, ExecutionPlan,
                                 InMemoryDTDG, RunConfig)

    cfg = dataclasses.replace(registry.get_arch("paper_dyngnn").make_config(),
                              num_nodes=ds.num_nodes, num_steps=ds.num_steps)
    src = InMemoryDTDG(ds, pipeline=pipe)

    def engine(steps, **kw):
        return Engine(RunConfig(model=cfg, data=src,
                                plan=ExecutionPlan(num_steps=steps),
                                log_fn=lambda _m: None, **kw), device="cuda")

    t0 = time.perf_counter()
    ref = engine(TRAIN_STEPS).fit()
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        spec = CheckpointSpec(d, every=FT_EVERY)
        ft_zero(kernels)
        first = engine(FT_EVERY, checkpoint=spec).fit()
        tracer = obs.configure(enabled=True)      # fenced train.step spans
        rest = engine(TRAIN_STEPS, checkpoint=spec).resume()
        obs.configure(enabled=False)
        launches = ft_counts(kernels)
        costs = ckpt_costs(torch, (rest.state.params, rest.state.opt_state),
                           Path(d) / "costs")
    step_ms = [sp.dur_s * 1e3 for sp in tracer.spans()
               if sp.name == "train.step"]
    want = train_launches(cfg.num_layers, ds.num_steps,
                          cfg.checkpoint_blocks)
    check_launches("ft eager", {k: v for k, v in launches.items()
                                if k != "csr_builds"}, want)
    losses = first.losses + rest.losses
    if rest.state.step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise SystemExit(f"ft eager: resumed to {rest.state.step}, "
                         f"{len(losses)} losses")
    diff = max(abs(a - b) for a, b in zip(losses, ref.losses, strict=True))
    rel = worst_rel(losses, ref.losses)
    with torch.no_grad():
        pdiff = max(float((a - b).abs().max()) for a, b in zip(
            rest.state.params.parameters(), ref.state.params.parameters(),
            strict=True))
        pscale = max(float(b.abs().max())
                     for b in ref.state.params.parameters())
    if not (rel <= 1e-5 and pdiff <= 1e-5 * pscale):
        raise SystemExit(f"ft eager: resumed {losses} vs {ref.losses}, "
                         f"params max|diff| {pdiff}")
    vs_train = (worst_rel(losses, train_losses)
                if train_losses is not None else None)
    if vs_train is not None and not vs_train <= 1e-5:
        raise SystemExit(f"ft eager: {losses} vs the train phase's "
                         f"{train_losses}")
    warm = statistics.median(step_ms)
    log(f"[ft-eager] 5 steps + resume() to 10 vs the uninterrupted run "
        f"({ref_s:.1f} s): losses max|diff| {diff:.3e} ({rel:.2e} rel), "
        f"params max|diff| {pdiff:.3e}"
        + (f", vs the train phase {vs_train:.2e} rel"
           if vs_train is not None else "")
        + f"; launches {launches}; warm step (fenced, median of the "
        f"resumed 5) {warm:.2f} ms; save blocks "
        f"{costs['save_blocking_ms']:.3f} ms, writes in "
        f"{costs['write_s']:.4f} s, {costs['bytes_on_disk']} B on disk, "
        f"restore {costs['restore_ms']:.3f} ms")
    return {"losses": losses, "losses_uninterrupted": ref.losses,
            "max_abs_diff": diff, "params_max_abs_diff": pdiff,
            "vs_train_rel": vs_train, "warm_step_ms": warm,
            "step_ms": step_ms, "launches": launches, **costs}


def ft_stream(torch, kernels, obs, ds, pipe, group):
    """streamed_mesh fault tolerance at full width, P = 1 over the
    one-rank NCCL group: 2 epochs of 4 rounds with
    ``CheckpointSpec(every=2)``, a SIGTERM raised in this process through
    the Engine's ``log_fn`` during round FT_SIGTERM_ROUND (the run stops
    after it, mid-epoch, so the full-N carries cross the checkpoint),
    ``resume()`` to the end; every count zeroed just before and read just
    after (24 / 2 / 2 / 0 and 16 CSR builds a round); both runs' losses
    against the uninterrupted run (fenced, traced: its round's median) at
    rtol 1e-5; then one save and restore of the loop's checkpoint tree
    (params, AdamW, the full-N carries: 144,998,400 B for TM-GCN)."""
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.elastic import tree_bytes
    from repro_torch.run import (CheckpointSpec, Engine, ExecutionPlan,
                                 InMemoryDTDG, RunConfig)

    cfg = dataclasses.replace(registry.get_arch("paper_dyngnn").make_config(),
                              num_nodes=ds.num_nodes, num_steps=ds.num_steps)
    src = InMemoryDTDG(ds, pipeline=pipe)
    plan = ExecutionPlan(mode="streamed_mesh", mesh=group,
                         num_epochs=DSTREAM_EPOCHS)

    def engine(**kw):
        kw.setdefault("log_fn", lambda _m: None)
        return Engine(RunConfig(model=cfg, data=src, plan=plan, **kw),
                      device="cuda")

    tracer = obs.configure(enabled=True)      # fenced round spans
    t0 = time.perf_counter()
    ref = engine().fit()
    ref_s = time.perf_counter() - t0
    obs.configure(enabled=False)
    round_ms = [sp.dur_s * 1e3 for sp in tracer.spans()
                if sp.name == "round"]
    seen = []

    def killer(msg):
        if "dist stream round" in msg:
            if len(seen) == FT_SIGTERM_ROUND:
                os.kill(os.getpid(), signal.SIGTERM)
            seen.append(msg)

    with tempfile.TemporaryDirectory() as d:
        spec = CheckpointSpec(d, every=FT_STREAM_EVERY)
        ft_zero(kernels)
        t0 = time.perf_counter()
        first = engine(checkpoint=spec, log_fn=killer, log_every=1).fit()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rest = engine(checkpoint=spec).resume()
        rest_s = time.perf_counter() - t0
        launches = ft_counts(kernels)
        rounds = len(first.losses) + len(rest.losses)
        params = rest.state.params
        carries = tm.init_carries(cfg, params, device="cuda")
        carry_bytes = tree_bytes(carries)
        costs = ckpt_costs(torch, {"params": params,
                                   "opt": rest.state.opt_state,
                                   "carries": carries}, Path(d) / "costs")
    stop = FT_SIGTERM_ROUND + 1
    rep, rrep = first.rescale_report, rest.rescale_report
    if not (rep.preempted and first.state.step == stop
            and rrep.resumed_from == stop and not rrep.preempted
            and rest.state.step == len(ref.losses)):
        raise SystemExit(f"ft stream: preempted {rep.preempted} at "
                         f"{first.state.step}, resumed from "
                         f"{rrep.resumed_from} to {rest.state.step}")
    check_launches("ft stream", {k: v for k, v in launches.items()
                                 if k != "csr_builds"},
                   {"segment_spmm": 24 * rounds, "banded_ttm": 2 * rounds,
                    "banded_ttm_t": 2 * rounds, "flash_decode": 0})
    if launches["csr_builds"] != 16 * rounds:
        raise SystemExit(f"ft stream: {launches['csr_builds']} CSR builds "
                         f"for {rounds} rounds")
    losses = first.losses + rest.losses
    rel = worst_rel(losses, ref.losses)
    if not rel <= 1e-5:
        raise SystemExit(f"ft stream: {losses} vs {ref.losses}")
    want_carry = cfg.num_layers * (cfg.window - 1) * cfg.num_nodes \
        * cfg.out_dim * 4
    if carry_bytes != want_carry:
        raise SystemExit(f"ft stream: carries {carry_bytes} B, expected "
                         f"{want_carry}")
    med = statistics.median(round_ms)
    log(f"[ft-stream] SIGTERM in round {FT_SIGTERM_ROUND}: stopped at "
        f"cursor {first.state.step} ({first_s:.1f} s), resume() to "
        f"{rest.state.step} ({rest_s:.1f} s); losses vs the uninterrupted "
        f"run ({ref_s:.1f} s) {rel:.2e} rel, max|diff| "
        f"{drift(losses, ref.losses):.3e}; launches {launches}; round "
        f"(fenced, median) {med:.2f} ms; the loop's tree: carries "
        f"{carry_bytes} B, save blocks "
        f"{costs['first_save_blocking_ms']:.2f} ms (pinned buffers "
        f"allocated), then {costs['save_blocking_ms']:.2f} ms, "
        f"writes in {costs['write_s']:.3f} s, {costs['bytes_on_disk']} B "
        f"on disk, restore {costs['restore_ms']:.2f} ms")
    return {"losses": losses, "losses_uninterrupted": ref.losses,
            "worst_rel": rel, "stopped_at": first.state.step,
            "round_ms_median": med, "round_ms": round_ms,
            "carry_bytes": carry_bytes, "launches": launches,
            "first_s": first_s, "resume_s": rest_s, **costs}


def ft_small(torch, dev: str, pool) -> dict:
    """TM-GCN at the full config's widths, N = 65,536, T = 8, block 4,
    ``train_elastic_streamed`` over ``pool`` at widths 2 -> 1 -> 2
    (FT_SCHEDULE), 2 epochs from the seed-7 parameters."""
    from repro_torch import elastic as el
    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset

    n, t, nb = FT_SHARED_N, FT_SHARED_T, FT_SHARED_NB
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t, checkpoint_blocks=nb)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    params = tm.init_params(torch.Generator().manual_seed(7), cfg)
    st = el.train_elastic_streamed(
        cfg, ds.snapshots, ds.values, ds.frames, ds.labels,
        controller=el.RescaleController(initial_p=2, schedule=FT_SCHEDULE),
        pool=pool, num_epochs=DSTREAM_EPOCHS, params=params, device=dev)
    return {"losses": st.losses,
            "events": [(e.block, e.old_p, e.new_p, e.payload_bytes,
                        e.recompose_s) for e in st.report.events],
            "segments": st.report.segments}


def ft_shared_ref(torch, group) -> dict:
    """``train_streamed(slice_len=win)`` on the card from the small
    elastic run's parameters, and the run's carry and state bytes (the
    payload law's terms).  ``group`` is unused: the reference is one
    device's."""
    from repro_torch.configs import registry
    from repro_torch.core import models as tm
    from repro_torch.data.dyngnn import synthetic_dataset
    from repro_torch.elastic import tree_bytes
    from repro_torch.optim import adamw
    from repro_torch.stream import train_loop as st

    n, t, nb = FT_SHARED_N, FT_SHARED_T, FT_SHARED_NB
    cfg = dataclasses.replace(registry.get_arch("tmgcn").make_config(),
                              num_nodes=n, num_steps=t, checkpoint_blocks=nb)
    ds = synthetic_dataset(n, t, density=TRAIN_DENSITY,
                           smoothing_mode="mproduct", window=cfg.window,
                           seed=1)
    params = tm.init_params(torch.Generator().manual_seed(7), cfg)
    carry_b = tree_bytes(tm.init_carries(cfg, params))
    state_b = tree_bytes(params) + tree_bytes(adamw.init_state(params))
    ref = st.train_streamed(cfg, ds.snapshots, ds.values, ds.frames,
                            ds.labels, num_epochs=DSTREAM_EPOCHS,
                            params=params, slice_len=t // nb,
                            device="cuda").losses
    return {"losses": ref, "carry_bytes": carry_b, "state_bytes": state_b}


def ft_shared_check(one: dict, res: list, ranks_s: float) -> dict:
    """P = 2 -> 1 -> 2 on two gloo ranks sharing the card (the pair of
    ``shared_card``): the ranks agree, their losses equal
    ``train_streamed(slice_len=win)`` on the card (``one``) at rtol 1e-5,
    and each event's payload is ``comm_volume.rescale_payload`` of the
    run's trees."""
    from repro_torch.dist import comm_volume as cv

    ref, carry_b, state_b = (one["losses"], one["carry_bytes"],
                             one["state_bytes"])
    if res[0]["losses"] != res[1]["losses"] or \
            res[0]["segments"] != res[1]["segments"]:
        raise SystemExit(f"ft shared card: the ranks disagree {res}")
    got = res[0]
    rel = worst_rel(got["losses"], ref)
    events = [e[:3] for e in got["events"]]
    want = [(1, 2, 1), (3, 1, 2)]
    payload_ok = all(e[3] == int(cv.rescale_payload(carry_b, state_b,
                                                    e[1], e[2]))
                     for e in got["events"])
    if not (rel <= 1e-5 and events == want and payload_ok):
        raise SystemExit(f"ft shared card: losses {got['losses']} vs "
                         f"{ref}, events {got['events']} (carries "
                         f"{carry_b} B, state {state_b} B)")
    log(f"[ft-shared] P = 2 -> 1 -> 2 on 2 gloo ranks sharing cuda:0: "
        "losses " + ", ".join(f"{v:.6f}" for v in got["losses"])
        + f"; vs train_streamed on the card {rel:.2e} rel; events "
        + ", ".join(f"{b}: {o} -> {p}, {pb} B, recompose {s * 1e3:.1f} ms"
                    for b, o, p, pb, s in got["events"])
        + f" (the law: carries {carry_b} B + state {state_b} B a new rank)")
    return {"N": FT_SHARED_N, "T": FT_SHARED_T, "losses": got["losses"],
            "losses_ref": ref, "worst_rel": rel, "events": got["events"],
            "segments": got["segments"], "carry_bytes": carry_b,
            "state_bytes": state_b, "ranks_s": ranks_s}


# --------------------------------------------------- shared-card checks -----

#: the checks of the spawned pair, in their order, and the P = 1 reference
#: and the check of each group (hybrid's ranks are a quad of their own)
SHARED_PAIR = ("partition", "dstream", "sampled", "ft")
SHARED_REF = {"partition": lambda torch, g: partition_small(torch, "cuda",
                                                             g),
              "dstream": dstream_shared_ref, "hybrid": hybrid_shared_ref,
              "sampled": sampled_shared_ref, "ft": ft_shared_ref}
SHARED_CHECK = {"partition": partition_shared_check,
                "dstream": dstream_shared_check,
                "hybrid": hybrid_shared_check,
                "sampled": sampled_shared_check, "ft": ft_shared_check}


def _pair_rank(rank: int, src: str, store: str, out_dir: str,
               checks: tuple):
    """One of the two ranks sharing cuda:0 over gloo: each of ``checks`` in
    turn -- the small partitioned run, distributed stream (``none`` and
    ``int8_a2a``) and sampled run on the card, then on the CPU, and the
    small elastic run on the card -- written to ``out_dir``."""
    import pickle

    torch, dist = _rank_setup(rank, src, store, 2)
    world = dist.group.WORLD
    res = {}
    try:
        for name in checks:
            t0 = time.perf_counter()
            if name == "partition":
                res[name] = {dev: partition_small(torch, dev, world)
                             for dev in ("cuda", "cpu")}
            elif name == "dstream":
                res[name] = {(comp, dev): dstream_small(torch, dev, world,
                                                        comp)
                             for comp in ("none", "int8_a2a")
                             for dev in ("cuda", "cpu")}
            elif name == "sampled":
                res[name] = {dev: sampled_small(torch, dev, world,
                                                full=False)["losses"]
                             for dev in ("cuda", "cpu")}
            else:
                res[name] = ft_small(torch, "cuda", world)
            res[name + "_s"] = time.perf_counter() - t0
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        from repro_torch.elastic import drop_width_groups
        drop_width_groups()      # no group may outlive the teardown
        dist.destroy_process_group()


def shared_card(torch, group, groups) -> dict:
    """Every named group's shared-card check at once: one spawned pair of
    gloo ranks on cuda:0 runs the partition, dstream, sampled and ft
    checks in turn (``_pair_rank``), four more ranks the hybrid's 2 x 2
    grid beside them, and meanwhile this process makes each check's
    reference on the card over the one-rank NCCL ``group``; then each
    group's check -> {group: its numbers}.  The ranks start once (their
    imports, CUDA contexts and gloo groups), not once a group."""
    import pickle
    import tempfile

    pair = tuple(g for g in SHARED_PAIR if g in groups)
    named = [g for g in ("partition", "dstream", "hybrid", "sampled", "ft")
             if g in groups]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        end = time.monotonic() + SHARED_DEADLINE_S
        ctxs, dirs = {}, {}
        for name, fn, n, args in (("pair", _pair_rank, 2, (pair,)),
                                  ("hybrid", _hybrid_shared_rank, 4, ())):
            if (name == "pair" and pair) or (name == "hybrid"
                                             and "hybrid" in groups):
                dirs[name] = Path(d) / name
                dirs[name].mkdir()
                ctxs[name] = (start_ranks(fn, n, (
                    str(SRC), str(dirs[name] / "store"), str(dirs[name]))
                    + args), n)
        walls = {}
        try:
            refs = {g: SHARED_REF[g](torch, group) for g in named}
            ref_s = time.perf_counter() - t0
            for name, (ctx, _) in ctxs.items():
                join_ranks(ctx, f"shared card ({name})", end)
                walls[name] = time.perf_counter() - t0
        finally:
            for ctx, _ in ctxs.values():
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
        res = {}
        for name, (_, n) in ctxs.items():
            res[name] = []
            for r in range(n):
                with open(dirs[name] / f"rank{r}.pkl", "rb") as f:
                    res[name].append(pickle.load(f))
    out = {}
    for g in named:
        ranks = res["hybrid"] if g == "hybrid" else [r[g]
                                                     for r in res["pair"]]
        out[g] = SHARED_CHECK[g](refs[g], ranks, walls["hybrid" if g ==
                                                        "hybrid" else "pair"])
    if pair:
        out["pair_s"] = {g: res["pair"][0][g + "_s"] for g in pair}
    out.update(walls=walls, references_s=ref_s)
    log(f"[shared] the references on the card over NCCL {ref_s:.1f} s; "
        + ", ".join(f"the {k} ranks done {v:.1f} s after their start"
                    for k, v in walls.items())
        + (" (the pair's checks: " + ", ".join(
            f"{g} {res['pair'][0][g + '_s']:.1f} s" for g in pair) + ")"
           if pair else ""))
    return out


def ft_launcher_runs() -> dict:
    """The launcher as a subprocess on the card (``--ckpt-dir``, the eager
    schedule at the smoke config: the distributed stream needs a card a
    rank), stopped by a real SIGTERM from this process after its first
    logged step: it must exit 0 with a checkpoint; then a relaunch with the
    same ``--ckpt-dir``.  Subprocesses only, so it may run in a thread
    beside other phases -> what ``ft_launcher`` checks."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(SRC), PYTHONUNBUFFERED="1")
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "paper_dyngnn", "--steps", str(FT_LAUNCH_STEPS),
               "--ckpt-dir", d, "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                env=env, cwd=ROOT)
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line.rstrip())
                if line.startswith("step 0 loss"):
                    proc.send_signal(signal.SIGTERM)
                    break
            rest, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        first_s = time.perf_counter() - t0
        lines += rest.splitlines()
        from repro_torch.ckpt import Checkpointer
        steps = Checkpointer(d).all_steps()
        pre = [ln for ln in lines if ln.startswith("preempted at step")]
        if proc.returncode != 0 or len(steps) != 1 or not pre:
            raise SystemExit("ft launcher: the SIGTERMed run exited "
                             f"{proc.returncode} with checkpoints {steps}:\n"
                             + "\n".join(lines[-20:]))
        t0 = time.perf_counter()
        again = subprocess.run(cmd, capture_output=True, text=True,
                               env=env, cwd=ROOT, timeout=300)
        second_s = time.perf_counter() - t0
    return {"steps": steps, "pre": pre, "again": again,
            "first_s": first_s, "second_s": second_s}


def ft_launcher(torch, runs: dict) -> dict:
    """``ft_launcher_runs``' relaunch resumed and completed, its final
    loss that of an uninterrupted in-process run (made here, in the main
    thread: the Engine's preemption guard sets a signal handler)."""
    from repro_torch.configs import registry
    from repro_torch.run import Engine, ExecutionPlan, RunConfig, \
        SyntheticTrace

    steps, pre, again = runs["steps"], runs["pre"], runs["again"]
    first_s, second_s = runs["first_s"], runs["second_s"]
    out = again.stdout.splitlines()
    done = [ln for ln in out if ln.startswith("done: ")]
    resumed = [ln for ln in out if ln.startswith("resumed from checkpoint")]
    arch = registry.get_arch("paper_dyngnn")
    cfg = arch.make_smoke_config()
    ref = Engine(RunConfig(
        model=cfg, data=SyntheticTrace(num_nodes=cfg.num_nodes,
                                       num_steps=cfg.num_steps, density=3.0,
                                       churn=0.1, smoothing_mode="mproduct",
                                       window=cfg.window),
        plan=ExecutionPlan(num_steps=FT_LAUNCH_STEPS),
        log_fn=lambda _m: None), device="cuda").fit()
    want = f"done: {FT_LAUNCH_STEPS} steps, final loss {ref.losses[-1]:.4f}"
    if again.returncode != 0 or not done or not done[0].startswith(want) \
            or resumed != [f"resumed from checkpoint step {steps[0]}"]:
        raise SystemExit(f"ft launcher: relaunch exited {again.returncode}: "
                         f"{done} {resumed} (want {want!r})\n"
                         + again.stderr[-2000:])
    log(f"[ft-launcher] SIGTERM after step 0: '{pre[0]}', exit 0 with the "
        f"step-{steps[0]} checkpoint ({first_s:.1f} s); relaunch: "
        f"'{resumed[0]}', '{done[0]}' ({second_s:.1f} s), the "
        f"uninterrupted run's final loss {ref.losses[-1]:.4f}")
    return {"stopped_at": steps[0], "final": done[0],
            "first_s": first_s, "relaunch_s": second_s}


# ------------------------------------------------------------ trace path ---

def trace_fit(torch, kernels, obs, eng, stamps: list, traced: bool
              ) -> dict:
    """One fit of ``eng`` with the tracer on (fenced, with derived phases)
    or off, every count zeroed just before and read just after -> {losses,
    params, launches, counters, spans, round_ms}.  ``stamps`` is filled by
    the engine's ``log_fn``, called as each round's loss reaches the host:
    ``round_ms`` are the host-clock gaps between consecutive rounds."""
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    tracer = obs.configure(enabled=traced)
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    stamps.clear()
    res = eng.fit()
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    spans = tracer.spans()
    obs.configure(enabled=False)
    return {"losses": res.losses, "params": res.state.params,
            "launches": launches, "counters": res.metrics["counters"],
            "spans": spans,
            "round_ms": [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]}


def trace_path(torch, kernels, obs, ds, pipe, group) -> dict:
    """The training trace at full size: ``paper_dyngnn`` (TM-GCN, N =
    755,200, T = 32, block 8) through ``Engine(ExecutionPlan(mode=
    "streamed_mesh", shards=1, num_epochs=2))`` at P = 1 over the one-rank
    NCCL group, untraced and traced in turns (U T T U), every count zeroed
    just before each fit and read just after: the losses and final
    parameters of every run equal (max|diff| 0.0); the untraced runs' 24
    / 2 / 2 / 0 launches and 16 CSR builds a round, the traced runs' the
    same plus the probe's three one-rank rounds (and 3 x 8 all-to-alls);
    each of the 8 rounds carries ``round``, ``round.transfer``,
    ``round.step`` (and ``stream.csr_pair``, 3 more from the probe's
    steps) and the derived spatial / a2a / temporal spans, which
    sum to the step; the calibration report's 8 rows; the probe's seconds
    and the traced round against the untraced one (host-clock gaps between
    consecutive rounds' losses, after one warm fit that encodes the
    rank's stream); the spans exported as
    ``.json`` and ``.jsonl``, each valid; then the launcher with
    ``--trace`` on the card (eager at the smoke config), its ``trace:``
    line and its file."""
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.run import Engine, ExecutionPlan, InMemoryDTDG, RunConfig

    cfg = registry.get_arch("paper_dyngnn").make_config()
    cfg = dataclasses.replace(cfg, num_nodes=ds.num_nodes,
                              num_steps=ds.num_steps)
    layers, win = cfg.num_layers, pipe.bsize
    rounds = DSTREAM_EPOCHS * ds.num_steps // win
    stamps: list = []
    eng = Engine(RunConfig(model=cfg, data=InMemoryDTDG(ds, pipeline=pipe),
                           plan=ExecutionPlan(mode="streamed_mesh", shards=1,
                                              num_epochs=DSTREAM_EPOCHS),
                           log_every=1,
                           log_fn=lambda _m: stamps.append(
                               time.perf_counter())), device="cuda")
    if eng.resolve().mesh is not group:
        raise SystemExit("trace: the plan did not take the one-rank group")
    t0 = time.perf_counter()
    trace_fit(torch, kernels, obs, eng, stamps, False)
    warm_s = time.perf_counter() - t0
    runs = [trace_fit(torch, kernels, obs, eng, stamps, traced)
            for traced in (False, True, True, False)]
    base, traced = runs[0], runs[1]
    for r in runs[1:]:
        if r["losses"] != base["losses"] or not same_params(r["params"],
                                                            base["params"]):
            gap = drift(r["losses"], base["losses"])
            raise SystemExit(f"trace: a run's losses or parameters differ "
                             f"(losses max|diff| {gap})")
    for r in (runs[0], runs[3]):
        check_stream_counts("trace (untraced)", r["launches"], rounds, win,
                            layers)
    one_rank_round = {"segment_spmm": (2 * layers - 1) * win,
                      "banded_ttm": layers, "banded_ttm_t": layers,
                      "flash_decode": 0, "csr_builds": 2 * win}
    for r in (runs[1], runs[2]):
        got = {k: r["launches"][k] - base["launches"][k]
               for k in one_rank_round}
        want = {k: PROBE_STEPS * v for k, v in one_rank_round.items()}
        a2a = (r["counters"].get("partition.a2a_calls", 0)
               - base["counters"].get("partition.a2a_calls", 0))
        if got != want or a2a != PROBE_STEPS * 4 * layers:
            raise SystemExit(f"trace: the probe added {got} and {a2a} "
                             f"all-to-alls, expected {want} and "
                             f"{PROBE_STEPS * 4 * layers}")
        if r["counters"].get("stream.rounds") != rounds:
            raise SystemExit("trace: stream.rounds "
                             f"{r['counters'].get('stream.rounds')}")
    spans = traced["spans"]
    names = {"round", "round.transfer", "round.step", "round.spatial",
             "round.a2a", "round.temporal"}
    per_round: dict = {}
    for sp in spans:
        if "round" in sp.attrs and sp.name.startswith("round"):
            per_round.setdefault(sp.attrs["round"], {})[sp.name] = sp
    if sorted(per_round) != list(range(rounds)) or any(
            set(v) != names for v in per_round.values()):
        raise SystemExit(f"trace: round spans {sorted(per_round)}: "
                         f"{[sorted(v) for v in per_round.values()]}")
    worst = 0.0
    for v in per_round.values():
        derived = sum(v[f"round.{p}"].dur_s
                      for p in ("spatial", "a2a", "temporal"))
        worst = max(worst, abs(derived - v["round.step"].dur_s))
        if not all(v[f"round.{p}"].cat == "phase.derived"
                   and v[f"round.{p}"].attrs.get("derived") is True
                   for p in ("spatial", "a2a", "temporal")):
            raise SystemExit("trace: a derived span lacks its category")
    if worst > 1e-9:
        raise SystemExit(f"trace: derived spans miss the step by {worst} s")
    probes = [sp.dur_s for sp in spans if sp.name == "round.probe"]
    pairs = sum(sp.name == "stream.csr_pair" for sp in spans)
    if len(probes) != 2 or pairs != rounds + PROBE_STEPS:
        raise SystemExit(f"trace: {len(probes)} round.probe spans, {pairs} "
                         f"stream.csr_pair spans")
    rep = obs.calibration_report(spans)
    if len(rep.rows) != rounds or rep.extra["skipped"]:
        raise SystemExit(f"trace: calibration rows {len(rep.rows)}, "
                         f"skipped {rep.extra['skipped']}")
    for line in rep.summary().splitlines():
        log(f"[trace] {line}")
    med = {name: statistics.median(v[name].dur_s * 1e3
                                   for v in per_round.values())
           for name in sorted(names)}
    traced_round = [v["round"].dur_s * 1e3 for v in per_round.values()]
    gaps = {k: [statistics.median(r["round_ms"]) for r in pair]
            for k, pair in (("untraced", (runs[0], runs[3])),
                            ("traced", (runs[1], runs[2])))}
    share = med["round.a2a"] / med["round.step"]
    log(f"[trace] 8 rounds x 6 spans in each traced run; derived spans sum "
        f"to the step within {worst:.1e} s; span medians (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f"; a2a share of the step {share:.4f}")
    log(f"[trace] the probe: {', '.join(f'{v * 1e3:.2f}' for v in probes)} "
        f"ms (comp_ref = the faster), {PROBE_STEPS} steps on the card "
        f"after round 0; the observer effect: the traced round (fenced "
        f"span) median {statistics.median(traced_round):.2f} ms; the "
        f"median gap between consecutive rounds' losses (host clock) "
        f"untraced {', '.join(f'{v:.2f}' for v in gaps['untraced'])} ms, "
        f"traced {', '.join(f'{v:.2f}' for v in gaps['traced'])} ms (U T T "
        f"U after a warm fit of {warm_s:.1f} s that encoded the rank's "
        f"stream); losses and parameters of U T T U equal (max|diff| 0.0)")
    with tempfile.TemporaryDirectory() as d:
        sizes = {}
        for suffix in (".json", ".jsonl"):
            path = obs.export_trace(Path(d) / f"trace{suffix}", spans=spans)
            events, _ = obs.load_trace(path)
            problems = obs.validate_trace(events)
            phases = obs.phase_durations(events)
            if problems or len(phases) != rounds:
                raise SystemExit(f"trace: {path.name}: {problems[:3]}, "
                                 f"{len(phases)} rounds")
            sizes[suffix] = path.stat().st_size
        out = Path(d) / "launch.json"
        env = dict(os.environ, PYTHONPATH=str(SRC))
        t0 = time.perf_counter()
        launched = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "paper_dyngnn", "--steps", str(TRACE_LAUNCH_STEPS), "--trace",
             str(out), "--device", "cuda"], capture_output=True, text=True,
            env=env, cwd=ROOT, timeout=300)
        launch_s = time.perf_counter() - t0
        line = [ln for ln in launched.stdout.splitlines()
                if ln.startswith("trace: ")]
        events = obs.load_trace(out)[0] if out.exists() else []
        steps = sum(e["name"] == "train.step" for e in events)
        if (launched.returncode != 0 or len(line) != 1
                or not line[0].endswith(f" -> {out}")
                or obs.validate_trace(events) or steps != TRACE_LAUNCH_STEPS):
            raise SystemExit(f"trace: the launcher exited "
                             f"{launched.returncode}, {line}, {steps} "
                             f"train.step spans\n{launched.stderr[-2000:]}")
        launch_bytes = out.stat().st_size
        checked = check_traces([
            (Path(d) / "trace.json", ["--phases"], rounds),
            (Path(d) / "trace.jsonl", ["--phases"], rounds),
            (out, ["--require", "train.step"], 0)])
    log("[trace] python -m repro_torch.obs.check: " + "; ".join(checked))
    log(f"[trace] exported {sizes['.json']} B (.json), {sizes['.jsonl']} B "
        "(.jsonl), both valid with every phase of every round; the "
        f"launcher on the card: '{line[0].split(' -> ')[0]}', "
        f"{launch_bytes} B, valid ({launch_s:.1f} s)")
    return {"rounds": rounds, "losses": base["losses"],
            "launches": traced["launches"],
            "launches_untraced": base["launches"],
            "span_ms_median": med, "a2a_share": share,
            "derived_vs_step_s": worst, "probe_ms": [v * 1e3 for v in probes],
            "traced_round_ms": traced_round, "round_gap_ms": {
                k: [r["round_ms"] for r in pair]
                for k, pair in (("untraced", (runs[0], runs[3])),
                                ("traced", (runs[1], runs[2])))},
            "round_gap_ms_median": gaps, "warm_fit_s": warm_s,
            "calibration": {"baseline_s": rep.baseline_s,
                            "residual_s": [row.residual_s
                                           for row in rep.rows],
                            "predicted_s": [row.predicted_s
                                            for row in rep.rows]},
            "export_bytes": sizes, "launcher_trace_bytes": launch_bytes,
            "launcher_s": launch_s, "checked": checked}


def check_traces(jobs) -> list[str]:
    """``python -m repro_torch.obs.check PATH FLAGS`` for each (path,
    flags, rounds) of ``jobs``, all started together -> each one's line;
    fails unless each exits 0 with ``PATH: OK (N events, rounds
    rounds)``."""
    from repro_torch import obs

    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [(path, flags, rounds, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.obs.check", str(path), *flags],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for path, flags, rounds in jobs]
    lines = []
    for path, flags, rounds, proc in procs:
        out, err = proc.communicate(timeout=120)
        n = len(obs.load_trace(path)[0])
        want = f"{path}: OK ({n} events, {rounds} rounds)"
        if proc.returncode != 0 or out.strip() != want:
            raise SystemExit(f"trace: the port's checker {flags} on "
                             f"{path.name} exited {proc.returncode}: "
                             f"{out[-1000:]}{err[-2000:]}")
        lines.append(f"{path.name} {' '.join(flags)}: {want.split(': ')[1]}")
    return lines


# ------------------------------------------------------------- data path ---

_RSS_CHILD = """\
import os, sys, threading
page = os.sysconf("SC_PAGE_SIZE")


def rss():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * page


peak = [rss()]
done = threading.Event()


def watch():
    while not done.wait(0.002):
        peak[0] = max(peak[0], rss())


watcher = threading.Thread(target=watch, daemon=True)
watcher.start()
sys.path.insert(0, sys.argv[1])
from repro_torch.run import read_edgelist
if sys.argv[2] != "-":
    read_edgelist(sys.argv[2], chunk_edges=int(sys.argv[3]) or None)
done.set()
watcher.join()
print(max(peak[0], rss()))
"""


def read_rss_mb(path: str, chunk: int) -> float | None:
    """Peak resident MB of a fresh process that imports the port's readers
    and reads ``path`` (``-``: reads nothing) in memory (``chunk`` 0) or
    in chunks of ``chunk`` rows: its resident pages (``/proc/self/statm``)
    sampled every 2 ms on a thread.  (``ru_maxrss`` would carry over the
    forking parent's peak.)  None, with the child's error logged, where
    the machine cannot report it."""
    out = subprocess.run([sys.executable, "-c", _RSS_CHILD, str(SRC), path,
                          str(chunk)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        log(f"[data] peak RSS not measured: {out.stderr.strip()[-300:]}")
        return None
    return int(out.stdout.split()[-1]) / 2**20


def mb(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.0f} MB"


def same_snapshots(name: str, got: list, want: list) -> None:
    import numpy as np

    if len(got) != len(want) or any(
            a.dtype != np.int32 or a.shape != b.shape or not np.array_equal(
                a, b) for a, b in zip(got, want, strict=True)):
        raise SystemExit(f"data: {name}: the snapshots differ")


def same_dataset(name: str, got, want) -> None:
    import numpy as np

    same_snapshots(name, got.snapshots, want.snapshots)
    if got.num_nodes != want.num_nodes or any(
            a.dtype != b.dtype or not np.array_equal(a, b)
            for a, b in zip(got.values, want.values, strict=True)) or any(
            getattr(got, k).dtype != getattr(want, k).dtype
            or not np.array_equal(getattr(got, k), getattr(want, k))
            for k in ("frames", "labels")):
        raise SystemExit(f"data: {name}: the dataset differs")


def data_path(torch, kernels, ds, snaps: list) -> dict:
    """Edge-list data at the train trace's size: its raw snapshots, which
    the train phase kept (``snaps``,
    ``graph.generate.evolving_dynamic_graph(755_200, 32, 1.25, 0.1, 0)``,
    30,207,991 rows), written by ``write_edgelist`` as ``.npz``, read back
    in memory and in chunks (each byte-identical to the generator's lists;
    each read's peak RSS in a child process), built by ``EdgeListDTDG``
    (M-transform, window 5, chunked) into the train phase's dataset array
    for array (which fixes every input a fit from it would see).  Cut:
    the ``.tsv`` form at N = 65,536, T = 8 (``np.loadtxt`` of 30 M rows
    would take minutes), written, read back in memory and in chunks, and
    trained for 10 eager steps on the card from an ``EdgeListDTDG`` of the
    file, every count zeroed just before and read just after (40 / 12 /
    8 / 0 a step, 16 CSR builds): the loss stream of an ``InMemoryDTDG``
    fit on the generator's lists at max|diff| 0.0 (the full-width fit from
    the file took its pipeline's ~62 s of host passes).  Then the committed
    KONECT-format fixture ``tests/fixtures/epinions_tiny.tsv``, trained on
    the card and on the CPU (losses within 1e-4 relative)."""
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.data.dyngnn import dataset_from_snapshots
    from repro_torch.graph.generate import evolving_dynamic_graph
    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.run import (EdgeListDTDG, Engine, ExecutionPlan,
                                 InMemoryDTDG, RunConfig, read_edgelist,
                                 write_edgelist)

    cfg = registry.get_arch("paper_dyngnn").make_config()
    n, t = ds.num_nodes, ds.num_steps
    secs = {}
    rows = sum(len(s) for s in snaps)
    if rows != DATA_ROWS:
        raise SystemExit(f"data: {rows} rows, expected {DATA_ROWS}")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.npz"
        t0 = time.perf_counter()
        write_edgelist(path, snaps)
        secs["write"] = time.perf_counter() - t0
        npz_bytes = path.stat().st_size
        for name, chunk in (("read", None), ("read_chunked", DATA_CHUNK)):
            t0 = time.perf_counter()
            got, n_seen = read_edgelist(path, chunk_edges=chunk)
            secs[name] = time.perf_counter() - t0
            same_snapshots(name, got, snaps)
            if n_seen > n:
                raise SystemExit(f"data: {name} saw {n_seen} vertices")
            del got
        # three child processes, side by side: each reports its own peak
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(3) as pool:
            futs = {"import": pool.submit(read_rss_mb, "-", 0),
                    "read": pool.submit(read_rss_mb, str(path), 0),
                    "read_chunked": pool.submit(read_rss_mb, str(path),
                                                DATA_CHUNK)}
            rss = {k: f.result() for k, f in futs.items()}
        t0 = time.perf_counter()
        built = EdgeListDTDG(str(path), num_nodes=n,
                             smoothing_mode="mproduct", window=cfg.window,
                             chunk_edges=DATA_CHUNK).build()
        secs["build"] = time.perf_counter() - t0
        same_dataset("EdgeListDTDG.build", built, ds)
        del built
        small = evolving_dynamic_graph(DATA_TSV_N, DATA_TSV_T, TRAIN_DENSITY,
                                       0.1, 0)
        tsv = Path(d) / "small.tsv"
        t0 = time.perf_counter()
        write_edgelist(tsv, small)
        secs["tsv_write"] = time.perf_counter() - t0
        tsv_bytes = tsv.stat().st_size
        for name, chunk in (("tsv_read", None),
                            ("tsv_read_chunked", DATA_CHUNK // 16)):
            t0 = time.perf_counter()
            got, _ = read_edgelist(tsv, chunk_edges=chunk)
            secs[name] = time.perf_counter() - t0
            same_snapshots(name, got, small)
        # the eager fit from the file, on the cut: the full-size build is
        # held above to the train phase's dataset, array for array
        fits, fit_launches = {}, {}
        for name, source in (
                ("file", EdgeListDTDG(str(tsv), num_nodes=DATA_TSV_N,
                                      smoothing_mode="mproduct",
                                      window=cfg.window,
                                      chunk_edges=DATA_CHUNK // 16)),
                ("lists", InMemoryDTDG(dataset_from_snapshots(
                    small, DATA_TSV_N, "mproduct", cfg.window)))):
            small_cfg = dataclasses.replace(cfg, num_nodes=DATA_TSV_N,
                                            num_steps=DATA_TSV_T)
            eng = Engine(RunConfig(model=small_cfg, data=source,
                                   plan=ExecutionPlan(num_steps=TRAIN_STEPS),
                                   log_fn=lambda _m: None), device="cuda")
            t0 = time.perf_counter()
            rr = eng.resolve()
            secs[f"pipeline_{name}"] = time.perf_counter() - t0
            reset_counts(kernels)
            spmm_ops.csr_builds = 0
            t0 = time.perf_counter()
            fits[name] = eng.fit().losses
            torch.cuda.synchronize()
            secs[f"fit_{name}"] = time.perf_counter() - t0
            counts = {k.name: k.launches for k in kernels}
            counts["csr_builds"] = spmm_ops.csr_builds
            check_launches(f"data ({name})", counts,
                           train_launches(cfg.num_layers, DATA_TSV_T,
                                          rr.cfg.checkpoint_blocks))
            if counts["csr_builds"] != 2 * DATA_TSV_T:
                raise SystemExit(f"data ({name}): {counts['csr_builds']} "
                                 "CSR builds")
            fit_launches[name] = counts
            del eng, rr
    # the path's counts are the file fit's, zeroed just before it
    launches = fit_launches["file"]
    log(f"[data] {rows:,} rows (N {n:,}, T {t}), the train phase's; .npz "
        f"{npz_bytes:,} B written in "
        f"{secs['write']:.1f} s, read in memory {secs['read']:.1f} s and in "
        f"chunks of {DATA_CHUNK:,} rows {secs['read_chunked']:.1f} s, both "
        f"byte-identical to the generator's lists; peak RSS (a child "
        f"process) {mb(rss['read'])} in memory, {mb(rss['read_chunked'])} "
        f"chunked, {mb(rss['import'])} for the imports alone; "
        f"EdgeListDTDG.build (chunked, M-transform w {cfg.window}) "
        f"{secs['build']:.1f} s, equal to the train phase's dataset array "
        f"for array")
    log(f"[data] cut: .tsv at N {DATA_TSV_N:,}, T {DATA_TSV_T} "
        f"({sum(len(s) for s in small):,} rows, {tsv_bytes:,} B): written "
        f"{secs['tsv_write']:.1f} s, read {secs['tsv_read']:.1f} s, chunked "
        f"{secs['tsv_read_chunked']:.1f} s, byte-identical")
    if fits["file"] != fits["lists"]:
        raise SystemExit(f"data: losses from the .tsv {fits['file']} "
                         f"against the generator's lists {fits['lists']}")
    log(f"[data] {TRAIN_STEPS} eager steps on the card from the .tsv's "
        f"EdgeListDTDG (pipeline {secs['pipeline_file']:.1f} s, fit "
        f"{secs['fit_file']:.1f} s): the losses of an InMemoryDTDG fit on "
        f"the generator's lists at max|diff| 0.0 ({launches})")
    gc.collect()
    torch.cuda.empty_cache()

    fixture = ROOT / "tests" / "fixtures" / "epinions_tiny.tsv"
    small_cfg = registry.get_arch("paper_dyngnn").make_smoke_config()
    fx = {}
    for dev in ("cuda", "cpu"):
        fx[dev] = Engine(RunConfig(
            model=small_cfg, data=EdgeListDTDG(
                str(fixture), smoothing_mode="mproduct",
                window=small_cfg.window),
            plan=ExecutionPlan(num_steps=TRAIN_STEPS),
            log_fn=lambda _m: None), device=dev).fit().losses
    rel = worst_rel(fx["cuda"], fx["cpu"])
    if not (len(fx["cuda"]) == TRAIN_STEPS and rel <= 1e-4):
        raise SystemExit(f"data: the fixture's losses {fx}")
    log(f"[data] the fixture {fixture.relative_to(ROOT)}: "
        f"{TRAIN_STEPS} eager steps, card against CPU {rel:.1e} relative "
        f"(limit 1e-4); final loss {fx['cuda'][-1]:.5f}")
    return {"rows": rows, "npz_bytes": npz_bytes, "tsv_bytes": tsv_bytes,
            "seconds": secs, "peak_rss_mb": rss, "launches": launches,
            "losses": fits["file"],
            "fixture_losses": fx["cuda"], "fixture_card_vs_cpu_rel": rel}


# ------------------------------------------------------------- LM path -----

def lm_path(torch, kernels, obs, cfg, tag: str = "lm",
            batch: int = LM_BATCH, prompt: int = LM_PROMPT,
            new_tokens: int = LM_TOKENS):
    """Phase 5 (Yi-6B) and the moe group (OLMoE-1B-7B, Moonlight-16B-A3B):
    ``cfg`` at its widths through ``ServeEngine.generate``, one wave of
    ``batch`` prompts of ``prompt`` tokens and ``new_tokens`` greedy
    tokens, every count zeroed just before and read just after."""
    import numpy as np

    from repro_torch.kernels.build import reset_counts
    from repro_torch.serve import ServeConfig, ServeEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine(ServeConfig(model=cfg, batch_sizes=(batch,),
                                  prompt_len=prompt,
                                  max_tokens=new_tokens), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    log(f"[{tag}] {cfg.name}: {n_params:,} parameters ({cfg.dtype}, "
        f"{cfg.num_layers} layers) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if n_params != cfg.param_count():
        raise SystemExit(f"{tag}: {n_params} parameters, the config says "
                         f"{cfg.param_count()}")
    torch.cuda.reset_peak_memory_stats()
    tracer = obs.configure(enabled=True)     # fenced prefill/decode spans
    reset_counts(kernels)
    tokens = eng.generate()
    launches = {k.name: k.launches for k in kernels}
    obs.configure(enabled=False)
    steps = new_tokens - 1
    check_launches(tag, launches, {"segment_spmm": 0, "banded_ttm": 0,
                                   "banded_ttm_t": 0,
                                   "flash_decode": cfg.num_layers * steps})
    r = eng.result()
    if tokens.shape != (batch, new_tokens) or not (
            (tokens >= 0) & (tokens < cfg.padded_vocab)).all():
        raise SystemExit(f"{tag}: bad tokens {tokens.shape}, range "
                         f"[{tokens.min()}, {tokens.max()}]")
    spans = {}
    for sp in tracer.spans():
        spans.setdefault(sp.name, []).append(sp.dur_s * 1e3)
    prefill_ms = spans["serve.prefill"][0]
    decode_ms = spans["serve.decode"]
    if len(decode_ms) != steps:
        raise SystemExit(f"{tag}: {len(decode_ms)} decode spans, expected "
                         f"{steps}")
    wall = r.query_seconds
    kv_bytes = 2 * cfg.num_layers * batch * (prompt + new_tokens) \
        * cfg.num_kv_heads * cfg.head_dim * torch.finfo(cfg.dtype).bits // 8
    stats = {
        "arch": cfg.name, "layers": cfg.num_layers, "params": n_params,
        "batch": batch, "prompt": prompt, "new_tokens": new_tokens,
        "prefill_ms": prefill_ms,
        "decode_ms_p50": statistics.median(decode_ms),
        "decode_ms_p95": sorted(decode_ms)[int(0.95 * (steps - 1))],
        "decode_tokens_per_s": batch * steps / (sum(decode_ms) / 1e3),
        "tokens_per_s": tokens.size / wall, "generate_s": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "kv_cache_gb": kv_bytes / 1e9,
        "launches": launches["flash_decode"]}
    log(f"[{tag}] generate: B={batch}, prompt {prompt}, {new_tokens} "
        f"tokens, {wall:.3f} s -> {stats['tokens_per_s']:.1f} tokens/s "
        f"(fenced spans)")
    log(f"[{tag}] prefill {prefill_ms:.1f} ms; decode per step p50 "
        f"{stats['decode_ms_p50']:.3f} ms, p95 {stats['decode_ms_p95']:.3f}"
        f" ms over {steps} steps -> {stats['decode_tokens_per_s']:.1f} "
        f"decode tokens/s")
    log(f"[{tag}] peak device memory {stats['peak_gib']:.2f} GiB (the KV "
        f"cache {kv_bytes / 1e9:.2f} GB); tokens in [0, "
        f"{cfg.padded_vocab}): {tokens.shape}, first row "
        f"{np.asarray(tokens[0, :8]).tolist()}")
    return eng, stats


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def profile_decode(torch, eng, tag: str = "profile-lm",
                   batch: int = LM_BATCH, prompt: int = LM_PROMPT,
                   new_tokens: int = LM_TOKENS):
    """One decode step at the path's shape: warm steady time, then one step
    under ``torch.profiler`` (device busy, idle share, top ops), beside
    its bound: every weight but the embedding table (of which a step reads
    B rows) and the K/V rows it reads, read once at 3.35 TB/s.  For an MoE
    model that bound counts the experts the profiled step routes to (its
    inputs run once more under ``RoutingLog`` before it: the same tokens
    route alike and rewrite the same K/V row); the bound of the dense
    (E, C, d) dispatch, every expert's weights, is reported beside it."""
    from repro_torch.models import lm

    cfg, params = eng.model, eng.params
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device="cuda")
    logits, cache = lm.prefill(cfg, params, prompts, prompt + new_tokens)
    tok = torch.argmax(logits, -1)

    def step():
        nonlocal cache, tok
        lg, cache = lm.decode_step(cfg, params, cache, tok)
        tok = torch.argmax(lg, -1)

    steady = alternating_walls(torch, {"step": step}, 8, warm=2)["step"]

    def replay():
        # the same tokens route alike and rewrite the same K/V row, so
        # both of the profiler's calls run the step counted below
        torch.argmax(lm.decode_step(cfg, params, cache, tok)[0], -1)

    rows_read = int(cache["len"].sum()) + batch   # the new token's row too
    routed = None
    if cfg.is_moe:
        with RoutingLog() as rl:
            lm.decode_step(cfg, params, cache, tok)
        routed = [int(torch.unique(top).numel()) for top, _ in rl.calls]
        if len(routed) != cfg.num_layers:
            raise SystemExit(f"{tag}: {len(routed)} MoE calls in a step")
    own = {}
    wall_us, busy, by_name = device_profile(torch, replay, exclusive=own)
    fd = fd_exclusive_us(by_name, own)
    embed = params["embed"]
    weight_bytes = sum(t.nbytes for t in _leaves(params)) - embed.nbytes \
        + batch * embed[0].nbytes
    esize = torch.finfo(cfg.dtype).bits // 8
    kv_bytes = 2 * cfg.num_layers * rows_read * cfg.num_kv_heads \
        * cfg.head_dim * esize
    dense_bound = bound = (weight_bytes + kv_bytes) / 3.35e12 * 1e3
    unread = 0
    if routed is not None:
        ffn = params["layers"]["ffn"]
        expert_bytes = sum(ffn[k][0, 0].nbytes
                           for k in ("wi_gate", "wi_up", "wo"))
        unread = sum(cfg.moe_experts - r for r in routed) * expert_bytes
        bound = (weight_bytes - unread + kv_bytes) / 3.35e12 * 1e3
    res = {"steady_ms": steady, "wall_ms": wall_us / 1e3,
           "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
           "flash_decode_ms": fd / 1e3, "bound_ms": bound,
           "dense_dispatch_bound_ms": dense_bound,
           "routed_experts": routed,
           "weight_bytes": weight_bytes - unread, "kv_bytes": kv_bytes,
           "activities": sum(map(len, by_name.values())),
           "by_kind_ms": {}}
    for name, v in by_name.items():
        kind = next((k for k, subs in DECODE_KINDS
                     if any(x in name for x in subs)), "other")
        res["by_kind_ms"][kind] = res["by_kind_ms"].get(kind, 0.0) \
            + sum(v) / 1e3
    log(f"[{tag}] decode step (warm, host clock + sync, median of 6):"
        f" {steady:.3f} ms; bound {bound:.3f} ms "
        f"({(weight_bytes - unread) / 1e9:.2f} GB of weights + "
        f"{kv_bytes / 1e9:.2f} GB of K/V at 3.35 TB/s)")
    if routed is not None:
        log(f"[{tag}] the profiled step routes to {min(routed)}-"
            f"{max(routed)} of {cfg.moe_experts} experts a layer (mean "
            f"{sum(routed) / len(routed):.1f}); the dense (E, C, d) "
            f"dispatch reads every expert's weights: its bound "
            f"{dense_bound:.3f} ms ({weight_bytes / 1e9:.2f} GB of "
            f"weights)")
    log(f"[{tag}] one step under the profiler: wall "
        f"{res['wall_ms']:.3f} ms, device busy {res['busy_ms']:.3f} ms, "
        f"idle share {res['idle_share']:.3f}, {res['activities']} device "
        f"activities, flash_decode {res['flash_decode_ms']:.3f} ms; by kind "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            res["by_kind_ms"].items(), key=lambda kv: -kv[1])))
    for name, v in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]:
        log(f"[{tag}]   {sum(v) / 1e3:8.3f} ms  x{len(v):<4d} "
            f"{name[:90]}")
    return res


#: a decode step's device activities by kind, first match wins
DECODE_KINDS = (("flash_decode", ("flash_decode",)),
                ("gemm", ("gemm", "Gemm", "gemv", "cutlass", "nvjet",
                          "xmma", "sm90_")),
                ("sort / scan", ("sort", "Sort", "scan", "Scan",
                                 "radix", "cumsum", "bincount")),
                ("index / scatter", ("index", "Index", "scatter",
                                     "gather", "put_")),
                ("copy / fill", ("copy", "Copy", "fill", "Fill",
                                 "Memset", "Memcpy")),
                ("elementwise / reduce", ("elementwise", "reduce",
                                          "Reduce", "softmax")))


def fd_excess(dtype: str, got, want32) -> tuple[float, float]:
    """-> (max |kernel - plain fp32|, the largest ratio of a batch row's
    max |diff| to that row's limit; the check passes at <= 1).  A row's
    limit is, in f32, TOL_FD abs + rel x the row's max |plain|; in bf16,
    TOL_FD x the row's max |plain|, scaled to the output alone: the output
    shrinks as 1 / sqrt(cache rows), so a fixed absolute term, or one
    scaled to another row's larger output, would pass zeros."""
    diff = (got - want32).abs().flatten(1).amax(1)
    peak = want32.abs().flatten(1).amax(1)
    limit = TOL_FD[dtype] * (peak if dtype == "bfloat16" else 1.0 + peak)
    return float(diff.max()), float((diff / limit).max())


def dropped_split_lens(lens: list[int], s: int, splits: int) -> list[int]:
    """``cache_len`` with one split's share of each sequence's rows taken
    off its end (at least one row kept; rows with ``cache_len <= 0`` keep
    their meaning): the kernel run on these is the kernel with a split
    dropped."""
    out = []
    for x in lens:
        n = min(x, s)
        out.append(x if x <= 0 else max(n - -(-n // splits), 1))
    return out


S_PATH = LM_PROMPT + LM_TOKENS
#: flash_decode's cases: name, B, Hq, KVH, D, S, cache_len
FD_CASES = [
    ("path", 8, 32, 4, 128, S_PATH, [LM_PROMPT + 32] * 8),
    ("path ragged", 8, 32, 4, 128, S_PATH,
     [1, S_PATH, 4097, 2000, 3000, 17, 4100, 9999]),
    ("decode_32k", 8, 32, 4, 128, 32768,
     [32768, 1, 30000, 16384, 32767, 5000, 20000, 32768]),
    ("long_500k", 1, 32, 4, 128, 524288, [524288]),
    ("D64 G1", 8, 36, 36, 64, S_PATH, [LM_PROMPT + 32] * 8),
    ("D256 G1", 8, 16, 16, 256, S_PATH, [LM_PROMPT + 32] * 8),
    ("G2", 2, 8, 4, 128, 300, [300, 123]),
    ("cache_len 0", 2, 32, 4, 128, S_PATH, [0, S_PATH]),
    ("D64 G4", 2, 16, 4, 64, 1000, [1000, 77]),
]
#: the G = 1 shapes: OLMoE-1B-7B's decode (16 heads over 16, D 128) with
#: the last step's full cache, ragged, with a cache_len 0 row and at
#: long_500k's 524,288 rows; MiniCPM-2B's (36 over 36, D 64) and
#: Gemma-7B's (16 over 16, D 256) decode at their B 8, S 4,160; and, with
#: the log-sum-exp output ("lse", checked as ``lse_checks`` does), a
#: long_500k rank's slice of OLMoE's cache, full and empty
FD_MOE_CASES = [
    ("OLMoE", 8, 16, 16, 128, S_PATH, [S_PATH] * 8),
    ("OLMoE ragged", 8, 16, 16, 128, S_PATH,
     [1, S_PATH, 4097, 2000, 3000, 17, 4100, 9999]),
    ("OLMoE cache_len 0", 2, 16, 16, 128, S_PATH, [0, S_PATH]),
    # the cells group's OLMoE-1B-7B long_500k decode step
    ("OLMoE long_500k", 1, 16, 16, 128, 524288, [524288]),
    ("MiniCPM", 8, 36, 36, 64, S_PATH, [S_PATH] * 8),
    ("Gemma", 8, 16, 16, 256, S_PATH, [S_PATH] * 8),
    ("OLMoE long_500k slice", 1, 16, 16, 128, 131072, [131072], "lse"),
    ("OLMoE long_500k slice, empty", 1, 16, 16, 128, 131072, [0], "lse"),
]


def fd_instance(ops, plan: tuple, d: int) -> str:
    """The instance ``plan`` picked, by name."""
    if plan[0] != ops.TC_HEADS:
        return "CUDA cores"
    dt = ops.tc_dt(d)
    stages, ctas = ops.TC_RING[dt]
    return (f"tensor cores (D {dt}, {stages}-stage ring, {ctas} CTA"
            f"{'s' if ctas > 1 else ''} an SM)")


def check_flash_decode(torch, timer, cases=FD_CASES + FD_MOE_CASES):
    """Phase 6: the kernel against its plain version, and timed.  Each
    case also shows that its check rejects two faulty outputs made on the
    card: zeros, and the kernel's own output with one split's rows
    dropped.  Cases marked "lse" go through ``lse_checks``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, err_all = [], 0.0
    lse_cases = [c[:7] for c in cases if c[7:] == ("lse",)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, b, hq, kvh, d, s, lens in (c for c in cases
                                             if len(c) == 7):
            q = torch.randn((b, hq, d), generator=gen, device="cuda"
                            ).to(dtype)
            k = torch.randn((b, s, kvh, d), generator=gen, device="cuda"
                            ).to(dtype)
            v = torch.randn((b, s, kvh, d), generator=gen, device="cuda"
                            ).to(dtype)
            cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = ops.decode_attention(q, k, v, cl).float()
            want = ref.flash_decode_ref(q, k, v, cl)
            # the plain version's fp32 result before its cast to q's type
            want32 = want if dtype == torch.float32 else \
                ref.flash_decode_ref(q.float(), k.float(), v.float(), cl)
            torch.cuda.synchronize()
            err, ratio = fd_excess(dname, got, want32)
            if not ratio <= 1.0:
                raise SystemExit(f"flash_decode {name} {dname}: kernel "
                                 f"disagrees with its plain version: max "
                                 f"|diff| {err:.3e}, {ratio:.3f} x a row's "
                                 "limit")
            err_all = max(err_all, err)
            pl = ops.plan(b, s, hq, kvh, d, dtype == torch.bfloat16,
                          ops._sm_count(0))
            instance = fd_instance(ops, pl, d)
            cut = torch.tensor(dropped_split_lens(lens, s, pl[1]),
                               dtype=torch.int32, device="cuda")
            faults = {
                "zeros": fd_excess(dname, torch.zeros_like(got), want32)[1],
                "a split dropped": fd_excess(dname, ops.decode_attention(
                    q, k, v, cut).float(), want32)[1]}
            for fault, fratio in faults.items():
                if fratio <= 1.0:
                    raise SystemExit(
                        f"flash_decode {name} {dname}: the check would "
                        f"pass a kernel that wrote {fault} ({fratio:.3f} x "
                        "a row's limit)")
            # the yardstick: SDPA over (B, KVH, S, D) views with a length
            # mask (all-masked rows give NaN there, so its error is taken
            # over rows with cache_len >= 1)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            n_rows = [min(x, s) if x > 0 else s for x in lens]
            mask = (torch.arange(s, device="cuda")[None, :]
                    < torch.tensor(n_rows, device="cuda")[:, None]
                    )[:, None, None, :]

            def lib(q=q, kt=kt, vt=vt, mask=mask):
                return F.scaled_dot_product_attention(
                    q[:, :, None, :], kt, vt, attn_mask=mask,
                    enable_gqa=True)[:, :, 0]

            ok = torch.tensor([x > 0 for x in lens], device="cuda")
            lib_err = float((lib() - want).float()[ok].abs().max())
            esize = q.element_size()
            nbytes = 2 * q.nbytes + cl.nbytes \
                + 2 * sum(n_rows) * kvh * d * esize
            b_ms, b_by = bound_ms(nbytes, 4.0 * sum(n_rows) * hq * d)

            def kern(q=q, k=k, v=v, cl=cl):
                return ops.decode_attention(q, k, v, cl)

            row = {
                "case": name, "dtype": dname,
                "B": b, "Hq": hq, "KVH": kvh, "D": d, "S": s,
                "cache_len": lens, "instance": instance,
                "ms": timer(kern), "wrapper_ms": timer(kern, host=True),
                "plain_ms": timer(lambda q=q, k=k, v=v, cl=cl:
                                  ref.flash_decode_ref(q, k, v, cl)),
                "library_ms": timer(lib),
                "ms_write_flush": timer(kern, flush="write"),
                "library_ms_write_flush": timer(lib, flush="write"),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                "err_over_limit": ratio,
                "max_abs_err_vs_plain_in_dtype": float(
                    (got - want.float()).abs().max()),
                "fault_over_limit": faults, "library_max_abs_err": lib_err,
                "plan": pl}
            log(f"[kernel] flash_decode {name} {dname} (B {b}, Hq {hq}, "
                f"KVH {kvh}, D {d}, S {s}, plan {row['plan']}, {instance})"
                f": kernel {row['ms']:.4f} ms (wrapper, host + device "
                f"{row['wrapper_ms']:.4f}), plain "
                f"{row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, bound "
                f"{b_ms:.4f} ({b_by}); with a write flush: kernel "
                f"{row['ms_write_flush']:.4f}, sdpa "
                f"{row['library_ms_write_flush']:.4f}")
            log(f"[kernel]   max|err| {err:.3e}, {ratio:.3f} x a row's "
                "limit; faults rejected at x limit: zeros "
                f"{faults['zeros']:.1f}, a split dropped "
                f"{faults['a split dropped']:.1f}; sdpa max|err| "
                f"{lib_err:.2e}")
            rows.append(row)
            del q, k, v, got, want, want32, kt, vt, lib, kern
    if lse_cases:
        lse_rows = lse_checks(torch, timer, lse_cases, "kernel")
        err_all = max([err_all] + [r["max_abs_err"] for r in lse_rows])
        rows += lse_rows
    return rows, err_all


def lm_parity(torch):
    """Phase 7: Yi-6B's full widths at 2 layers in f32, the card's kernel
    path against the CPU's plain path on the same parameters."""
    from repro_torch.configs import yi_6b

    cfg = dataclasses.replace(yi_6b.make_config(), num_layers=2,
                              dtype=torch.float32)
    return model_parity(torch, cfg, "parity-lm")


def model_parity(torch, cfg, tag: str, routing=None) -> dict:
    """``cfg`` (f32) served card (kernel) and CPU (plain) on the same
    parameters: prefill logits over B 2 x 256 tokens and 8 teacher-forced
    decode steps' logits, 1e-4 abs and rel.  With ``routing`` (a pair of
    :class:`RoutingLog`, card and CPU, for an MoE model at a capacity that
    drops nothing, so the batch rows are independent) a row whose routing
    differs from the CPU's at a near-tie is reported and not compared."""
    import contextlib

    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine

    prompt, steps = 256, 8
    sc = ServeConfig(model=cfg, batch_sizes=(2,), prompt_len=prompt,
                     max_tokens=steps)
    gpu = ServeEngine(sc, device="cuda")
    cpu = ServeEngine(sc, params=gpu.params, device="cpu")
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + steps),
                         generator=gen)
    logs = routing or (contextlib.nullcontext(), contextlib.nullcontext())
    out = {"gpu": [], "cpu": []}
    for (name, eng, dev), log_ in zip((("gpu", gpu, "cuda"),
                                       ("cpu", cpu, "cpu")), logs):
        with log_:
            lg, cache = lm.prefill(cfg, eng.params,
                                   toks[:, :prompt].to(dev), prompt + steps)
            out[name].append(lg.cpu())
            for t in range(prompt, prompt + steps):
                lg, cache = lm.decode_step(cfg, eng.params, cache,
                                           toks[:, t].to(dev))
                out[name].append(lg.cpu())
    rows = [0, 1]
    res = {}
    if routing:
        flips = routing_flips(*routing)
        flipped = set()
        for call, tokens in flips["tokens"].items():
            width = prompt if call < cfg.num_layers else 1   # prefill
            flipped |= {int(t) // width for t in tokens}
        rows = [r for r in rows if r not in flipped]
        res["routing"] = {k: v for k, v in flips.items() if k != "tokens"}
        res["rows_compared"] = rows
        if flipped:
            log(f"[{tag}] ROUTING FLIP: {flips['tokens_differing']} "
                f"token-layer routings differ card vs CPU, each at a gap "
                f"< 1e-5 between its k-th and (k+1)-th probabilities "
                f"(largest {flips['max_gap']:.2e}); rows {sorted(flipped)} "
                "reported, not compared")
    errs = [check_close(f"{tag} {'prefill' if i == 0 else f'decode {i}'} "
                        "logits", g[rows], c[rows], TOL_LOGITS)
            if rows else float("nan")
            for i, (g, c) in enumerate(zip(out["gpu"], out["cpu"]))]
    limit = TOL_LOGITS * (1.0 + float(out["cpu"][-1].abs().max()))
    log(f"[{tag}] {cfg.name} widths, {cfg.num_layers} layers, f32, B 2, "
        f"prompt {prompt}: card (kernel) vs CPU (plain) logits max |diff| "
        f"prefill {errs[0]:.2e}, decode steps {max(errs[1:]):.2e} (limit "
        f"~{limit:.2e}), rows compared {rows}")
    res.update(prefill_err=errs[0], decode_err=max(errs[1:]))
    return res


class RoutingLog:
    """Within it, each ``nn.moe.moe_apply`` call records its tokens' top-k
    expert sets and each token's gap between its k-th and (k+1)-th
    router probabilities (the router recomputed beside the call)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.nn import moe

        self._mod, self._real = moe, moe.moe_apply

        def recorded(params, x, top_k, *args, **kwargs):
            with torch.no_grad():
                probs = torch.softmax(x.detach().reshape(-1, x.shape[-1])
                                      .to(torch.float32)
                                      @ params["router"], dim=-1)
                top = torch.topk(probs, top_k + 1, dim=-1)
                self.calls.append((
                    top.indices[:, :top_k].sort(dim=-1).values.cpu(),
                    (top.values[:, top_k - 1] - top.values[:, top_k]).cpu()))
            return self._real(params, x, top_k, *args, **kwargs)

        moe.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        self._mod.moe_apply = self._real


def routing_flips(card: RoutingLog, cpu: RoutingLog) -> dict:
    """The tokens whose expert sets differ card vs CPU -> {call index:
    token indices}, their count, the largest CPU gap among them; fails
    unless every such token's gap is under 1e-5 (a near-tie, which fp32
    sums in another order may break either way)."""
    if len(card.calls) != len(cpu.calls):
        raise SystemExit(f"routing: {len(card.calls)} MoE calls on the card"
                         f", {len(cpu.calls)} on the CPU")
    tokens, n, gap, gaps = {}, 0, 0.0, []
    for i, ((gi, _), (ci, cg)) in enumerate(zip(card.calls, cpu.calls)):
        diff = (gi != ci).any(dim=-1).nonzero().flatten()
        gaps.append(float(cg.min()))
        if len(diff):
            tokens[i] = diff.tolist()
            n += len(diff)
            gap = max(gap, float(cg[diff].max()))
    if gap >= 1e-5:
        raise SystemExit(f"routing: {n} token routings differ card vs CPU, "
                         f"one at a gap of {gap:.2e} between its k-th and "
                         "(k+1)-th probabilities (>= 1e-5: not a near-tie)")
    return {"calls": len(card.calls), "tokens_differing": n,
            "max_gap": gap, "smallest_gap_seen": min(gaps),
            "tokens": tokens}


def moe_apply_parity(torch) -> dict:
    """``moe_apply`` at OLMoE-1B-7B's widths (d 2048, 64 experts of ff
    1024, top 8, f32) on one input of 256 tokens, card against CPU: at
    ample capacity (256 slots an expert: nothing dropped) and at the
    default 1.25 (40 slots: tokens dropped).  Routing first: a token whose
    expert set differs must sit at a near-tie (``routing_flips``);
    outputs within 1e-4 (abs and rel) on the tokens routed alike, and the
    dropped fraction equal when every token is routed alike."""
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.nn import moe

    cfg = olmoe_1b_7b.make_config()
    cpu_p = moe.init_moe(torch.Generator().manual_seed(6), cfg.d_model,
                         cfg.d_ff, cfg.moe_experts, torch.float32)
    gpu_p = {k: v.cuda() for k, v in cpu_p.items()}
    x = torch.randn((1, 256, cfg.d_model), generator=torch.Generator()
                    .manual_seed(7))
    res = {}
    for name, cap in (("ample", 256), ("default", None)):
        logs = RoutingLog(), RoutingLog()
        with logs[0]:
            g_out, g_aux = moe.moe_apply(gpu_p, x.cuda(), cfg.moe_top_k,
                                         capacity=cap)
        with logs[1]:
            c_out, c_aux = moe.moe_apply(cpu_p, x, cfg.moe_top_k,
                                         capacity=cap)
        flips = routing_flips(*logs)
        same = torch.ones(256, dtype=torch.bool)
        same[flips["tokens"].get(0, [])] = False
        g_out, c_out = g_out.cpu()[0], c_out[0]
        err = check_close(f"moe_apply {name}", g_out[same], c_out[same],
                          TOL_LOGITS) if (flips["tokens_differing"] == 0
                                          or cap == 256) else float("nan")
        gd, cd = float(g_aux["dropped_frac"]), float(c_aux["dropped_frac"])
        if flips["tokens_differing"] == 0 and gd != cd:
            raise SystemExit(f"moe_apply {name}: dropped {gd} on the card, "
                             f"{cd} on the CPU")
        res[name] = {"capacity": cap or moe.moe_capacity(
            256, cfg.moe_top_k, cfg.moe_experts, cfg.moe_capacity_factor),
            "max_abs_err": err, "dropped_frac": gd,
            "lb_loss_diff": abs(float(g_aux["lb_loss"])
                                - float(c_aux["lb_loss"])),
            **{k: v for k, v in flips.items() if k != "tokens"}}
        log(f"[parity-moe] moe_apply {name} capacity "
            f"{res[name]['capacity']}: {flips['tokens_differing']} of 256 "
            f"tokens routed differently (smallest 8th-9th gap "
            f"{flips['smallest_gap_seen']:.2e}); max |diff| {err:.2e} on "
            f"the {int(same.sum())} routed alike (limit {TOL_LOGITS} abs + "
            f"rel); dropped {gd:.4f} (CPU {cd:.4f})")
    return res


def moe_train_parity(torch) -> dict:
    """One ``lm_train_step`` at OLMoE-1B-7B's widths, 1 layer, B 1, S 128,
    f32, card against CPU from the same parameters: the loss and every
    gradient within 1e-4 x each leaf's max |value| (1e-4 relative for the
    loss), the routing compared first; then the step itself on the card
    (its loss, finite, the one just compared)."""
    import numpy as np

    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.core.models import ParamTree
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(olmoe_1b_7b.make_config(), num_layers=1,
                              dtype=torch.float32)
    cpu_p = ParamTree(lm.init_lm_params(torch.Generator().manual_seed(8),
                                        cfg))
    gpu_p = ParamTree(_tree_cuda(lsteps.lm_tree(cpu_p)))
    rng = np.random.default_rng(9)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 129)))
    logs = RoutingLog(), RoutingLog()
    with logs[0]:
        g_loss, g_grads = lsteps.lm_loss_and_grads(
            cfg, gpu_p, toks[:, :-1].cuda(), toks[:, 1:].cuda())
    with logs[1]:
        c_loss, c_grads = lsteps.lm_loss_and_grads(cfg, cpu_p, toks[:, :-1],
                                                   toks[:, 1:])
    flips = routing_flips(*logs)
    names = [n for n, _ in cpu_p.named_parameters()]
    errs = {}
    compared = flips["tokens_differing"] == 0
    for name, g, c in zip(names, g_grads, c_grads, strict=True):
        err = float((g.cpu() - c).abs().max())
        errs[name] = err / max(float(c.abs().max()), 1e-30)
        if compared and not errs[name] <= TOL_GRAD:
            raise SystemExit(f"moe train parity: gradient {name} max |diff|"
                             f" {err:.3e}, {errs[name]:.2e} x its max")
    loss_rel = abs(float(g_loss) - float(c_loss)) / abs(float(c_loss))
    if compared and not loss_rel <= TOL_GRAD:
        raise SystemExit(f"moe train parity: loss {float(g_loss)} on the "
                         f"card, {float(c_loss)} on the CPU")
    if not compared:
        log(f"[parity-moe] ROUTING FLIP in the train step: "
            f"{flips['tokens_differing']} token routings differ at near-ties"
            f" (largest gap {flips['max_gap']:.2e}); gradients reported, "
            "not compared")
    # the step itself on the card, from a fresh AdamW state
    step = lsteps.lm_train_step(cfg)
    _, _, g_step = step(gpu_p, adamw.init_state(gpu_p), toks[:, :-1].cuda(),
                        toks[:, 1:].cuda())
    if not (np.isfinite(float(g_step))
            and abs(float(g_step) - float(g_loss)) <= 1e-6 * abs(
                float(g_loss))):
        raise SystemExit(f"moe train parity: the step's loss {g_step} "
                         f"against {g_loss}")
    worst = max(errs, key=errs.get)
    log(f"[parity-moe] lm_train_step, OLMoE widths, 1 layer, B 1, S 128, "
        f"f32: loss {float(g_loss):.6f} card vs {float(c_loss):.6f} CPU "
        f"({loss_rel:.1e} relative); gradients max |diff| / leaf max "
        f"{errs[worst]:.2e} ({worst}; limit {TOL_GRAD}); routing "
        f"{flips['tokens_differing']} of {128 * flips['calls']} differ; "
        f"the card's step: loss {float(g_step):.6f}")
    return {"loss_card": float(g_loss), "loss_cpu": float(c_loss),
            "loss_rel": loss_rel, "grad_err_over_max": errs,
            "compared": compared,
            **{k: v for k, v in flips.items() if k != "tokens"}}


def _tree_cuda(tree):
    return {k: _tree_cuda(v) if isinstance(v, dict) else v.detach().cuda()
            for k, v in tree.items()}


def moe_parity(torch) -> dict:
    """The moe group's card-against-CPU checks (TF32 off, f32)."""
    from repro_torch.configs import olmoe_1b_7b

    res = {"moe_apply": moe_apply_parity(torch)}
    gc.collect()
    # 2 layers; capacity factor E / k, so every expert has a slot for
    # every token: nothing drops and the batch rows stay independent
    cfg = olmoe_1b_7b.make_config()
    cfg = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32,
                              moe_capacity_factor=cfg.moe_experts
                              / cfg.moe_top_k)
    res["model"] = model_parity(torch, cfg, "parity-moe",
                                routing=(RoutingLog(), RoutingLog()))
    gc.collect()
    torch.cuda.empty_cache()
    res["train_step"] = moe_train_parity(torch)
    return res


def moe_train(torch, kernels, obs) -> dict:
    """LM training at OLMoE-1B-7B's widths, cut to 4 of its 16 layers
    (1.885 B parameters: bf16 parameters and gradients and AdamW's fp32
    m, v and master take ~30 GB, 16 layers would need ~110 GB), at
    ``train_4k``'s sequence of 4,096 tokens, batch cut from 256 to 2:
    ``MOE_TRAIN_STEPS`` ``lm_train_step`` calls from ``init_lm_params`` and
    ``adamw.init_state``, every count zeroed just before and read just
    after (no kernel: training decodes nothing).  Losses finite; step ms
    (host clock + sync, the median after the first), tokens/s, peak
    device memory."""
    import numpy as np

    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.kernels.build import reset_counts
    from repro_torch.launch import steps as lsteps

    cfg = dataclasses.replace(olmoe_1b_7b.make_config(),
                              num_layers=MOE_TRAIN_LAYERS)
    t0 = time.perf_counter()
    params, opt = lsteps.lm_train_state(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    if n != cfg.param_count():
        raise SystemExit(f"moe train: {n} parameters, the config says "
                         f"{cfg.param_count()}")
    state_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[moe-train] {cfg.name} widths, {cfg.num_layers} of 16 layers: "
        f"{n:,} parameters and AdamW state ({state_gb:.2f} GB) made on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ + 1)),
                          device="cuda")
    toks, tgts = seq[:, :-1], seq[:, 1:]
    step = lsteps.lm_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    losses, step_ms = [], []
    for _ in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, toks, tgts)
        losses.append(float(loss))          # reads the loss: a sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in kernels}
    check_launches("moe-train", launches, {k: 0 for k in launches})
    if not np.isfinite(losses).all():
        raise SystemExit(f"moe train: losses {losses}")
    warm = statistics.median(step_ms[1:])
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    log(f"[moe-train] {MOE_TRAIN_STEPS} steps of B {MOE_TRAIN_BATCH} x S "
        f"{MOE_TRAIN_SEQ}: losses " + ", ".join(f"{v:.5f}" for v in losses))
    log(f"[moe-train] step ms " + ", ".join(f"{v:.1f}" for v in step_ms)
        + f"; warm median {warm:.1f} ms -> {tokens / warm * 1e3:.0f} "
        f"tokens/s; peak device memory {peak:.2f} GB ({state_gb:.2f} of "
        "parameters and AdamW state)")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "params": n, "batch": MOE_TRAIN_BATCH,
            "seq": MOE_TRAIN_SEQ, "losses": losses, "step_ms": step_ms,
            "warm_step_ms": warm, "tokens_per_s": tokens / warm * 1e3,
            "peak_gb": peak, "state_gb": state_gb, "launches": launches}


# ------------------------------------------------------------ GNN path -----

#: a GNN step's device activities by kind, first match wins
GNN_KINDS = (("GEMMs", ("gemm", "xmma", "cutlass")),
             ("gathers (index_select)", ("indexSelect",)),
             ("scatter-adds (index_add)", ("indexFunc",)),
             ("scatter_reduce / gather", ("scatter_gather",)),
             ("stack / cat copies", ("CatArrayBatchedCopy",)),
             ("other copies", ("copy", "Memcpy")),
             ("fills", ("FillFunctor", "Memset")),
             ("reductions", ("reduce_kernel",)),
             ("norms / softmax", ("norm", "softmax")))


def gnn_kinds(by_name: dict, table: tuple = GNN_KINDS) -> list:
    """{device activity name: [us]} -> [(kind, ms, count)] by time, the
    kinds of ``table`` (first match wins), what none names under "other
    elementwise"."""
    out: dict[str, list] = {}
    for name, v in by_name.items():
        kind = next((k for k, subs in table
                     if any(x in name for x in subs)), "other elementwise")
        acc = out.setdefault(kind, [0.0, 0])
        acc[0] += sum(v) / 1e3
        acc[1] += len(v)
    return sorted(((k, ms, n) for k, (ms, n) in out.items()),
                  key=lambda r: -r[1])


def gnn_shape(name: str):
    from repro_torch.configs import registry
    return registry.get_arch("gatedgcn").shapes[name]


def gnn_run(torch, kernels, cell, params, opt, batch) -> dict:
    """``GNN_STEPS`` calls of the cell's own step (``launch.steps.
    build_cell``: ``gnn_train_step`` on the cell's tensors) from
    ``params`` and ``opt`` (the cell's ``make_inputs(0)``: ``init_params``
    with generator seed 0 and ``adamw.init_state``, on the card) on
    ``batch`` (its graph tensors), every count zeroed just before and read
    just after (no kernel: the GNNs aggregate with index_add /
    scatter_reduce); losses finite; each step's host-clock ms ending in
    the loss's read; peak memory; then one more step under the
    profiler."""
    import numpy as np

    from repro_torch.kernels.build import reset_counts
    from repro_torch.launch import steps as lsteps

    arch, shape = cell.arch_id, cell.shape
    dims = lsteps.gnn_dims(shape)
    n_params = sum(p.numel() for p in params.parameters())
    step = cell.step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    losses, step_ms = [], []
    for _ in range(GNN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, *batch)
        losses.append(float(loss))          # reads the loss: a sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in kernels}
    if any(launches.values()):
        raise SystemExit(f"gnn {arch} {shape.name}: kernel launches "
                         f"{launches}")
    if not np.isfinite(losses).all():
        raise SystemExit(f"gnn {arch} {shape.name}: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = statistics.median(step_ms[1:])
    holder = [params, opt]

    def one_step():
        holder[0], holder[1], _ = step(holder[0], holder[1], *batch)

    t0 = time.perf_counter()
    wall_us, busy_us, by_name = device_profile(torch, one_step, host=False)
    prof_s = time.perf_counter() - t0
    kinds = gnn_kinds(by_name)
    top = sorted(((k, sum(v) / 1e3, len(v)) for k, v in by_name.items()),
                 key=lambda r: -r[1])[:5]
    launches_n = sum(len(v) for v in by_name.values())
    log(f"[gnn] {arch} at {shape.name} (full width, {n_params:,} "
        f"parameters; N {dims['nodes']:,}, E {dims['edges']:,}): losses "
        + ", ".join(f"{v:.5f}" for v in losses))
    log(f"[gnn]   step ms " + ", ".join(f"{v:.1f}" for v in step_ms)
        + f"; warm median {warm:.2f} ms; peak {peak:.3f} GB; profiled step: "
        f"wall {wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms, "
        f"idle share {1 - busy_us / wall_us:.3f}, {launches_n} device "
        f"activities, {prof_s:.1f} s with the profiler's collection; by "
        "kind: " + ", ".join(
            f"{k} {ms:.2f} ({n})" for k, ms, n in kinds[:5]))
    del params, opt, holder
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "shape": shape.name, "params": n_params,
            "nodes": dims["nodes"], "edges": dims["edges"],
            "losses": losses, "step_ms": step_ms, "warm_step_ms": warm,
            "peak_gb": peak, "profiled_wall_ms": wall_us / 1e3,
            "busy_ms": busy_us / 1e3, "idle_share": 1 - busy_us / wall_us,
            "device_activities": launches_n, "profile_s": prof_s,
            "kinds": [{"kind": k, "ms": ms, "count": n}
                      for k, ms, n in kinds],
            "top": [{"name": k[:120], "ms": ms, "count": n}
                    for k, ms, n in top],
            "launches": launches}


def gnn_cuts(torch) -> dict:
    """The static-GNN cells one card cannot hold, by the dry run's
    reckoning (``launch.dryrun.reckon`` against the card's memory):
    ``ogb_products`` for every arch and EquiformerV2 at
    ``minibatch_lg``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as lsteps

    cap = torch.cuda.get_device_properties(0).total_memory
    cuts = {}
    for arch in GNN_ARCHS:
        for shape in ("minibatch_lg", "ogb_products"):
            if (shape, arch) in {(s, a) for s, archs in GNN_RUNS
                                 for a in archs}:
                continue
            rec = dryrun.reckon(lsteps.build_cell(arch, shape), cap)
            if rec["fits"]:
                raise SystemExit(f"gnn: {arch} at {shape} fits by the "
                                 "reckoning but no run takes it")
            log(f"[gnn] cut: {dryrun.summary(rec)}")
            cuts[f"{arch} {shape}"] = {
                "arg_bytes": rec["arg_bytes"], "work": rec["work"],
                "need_bytes": rec["need_bytes"], "capacity_bytes": cap}
    return cuts


def gnn_path(torch, kernels) -> dict:
    """The static GNNs trained at full width on the card through their
    cells (``launch.steps.build_cell`` at the registry's shapes): each of
    ``GNN_RUNS``' shapes' graph tensors made once on the card by its first
    cell's ``make_inputs(0)`` (``gnn_batches``, seed 0), each later
    arch's parameters and AdamW state by its cell's ``make_state(0)``,
    then ``gnn_run``; the cuts' reckoning."""
    from repro_torch.launch import steps as lsteps

    runs = []
    for shape_name, archs in GNN_RUNS:
        batch = None
        for arch in archs:
            cell = lsteps.build_cell(arch, shape_name)
            if batch is None:
                t0 = time.perf_counter()
                params, opt, *batch = cell.make_inputs(0)
                torch.cuda.synchronize()
                log(f"[gnn] {shape_name} inputs made on the card in "
                    f"{time.perf_counter() - t0:.1f} s")
            else:
                # make_inputs' own draw, without remaking the graph
                params, opt = cell.make_state(0)
            runs.append(gnn_run(torch, kernels, cell, params, opt, batch))
            del params, opt
        del batch
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k.name: sum(r["launches"][k.name] for r in runs)
                for k in kernels}
    return {"runs": runs, "cuts": gnn_cuts(torch), "launches": launches}


def gnn_grads_close(name: str, got, want) -> float:
    """Loss 1e-4 relative, gradients 1e-4 x each leaf's max |value| ->
    the worst share of a limit."""
    (l_got, g_got), (l_want, g_want) = got, want
    worst = abs(float(l_got) - float(l_want)) / (TOL_GRAD
                                                 * abs(float(l_want)))
    for a, b in zip(g_got, g_want, strict=True):
        a, b = a.detach().cpu(), b.detach().cpu()
        worst = max(worst, float((a - b).abs().max())
                    / (TOL_GRAD * max(float(b.abs().max()), 1e-30)))
    if not worst <= 1.0:
        raise SystemExit(f"gnn parity {name}: card vs CPU at {worst:.3f} x "
                         "the limits")
    return worst


def gnn_parity(torch) -> dict:
    """Card against CPU (TF32 off): one train step's loss and gradients for
    each arch at its smoke config on the launcher's smoke batch, and
    EquiformerV2 at full width cut to ``GNN_PARITY_LAYERS`` layers on
    ``molecule`` (128 graphs); the same parameters (drawn on the host) and
    batch on both.  Meanwhile the launcher trains EquiformerV2 at its full
    config on the card in a subprocess (``--full-config --steps 5``) and
    must print finite losses and ``done``."""
    import copy

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.train import GNN_SMOKE_SHAPE

    env = dict(os.environ, PYTHONPATH=str(SRC), PYTHONUNBUFFERED="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "equiformer-v2", "--full-config", "--steps",
           str(GNN_LAUNCH_STEPS)]
    t_launch = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        cases = []
        for arch in GNN_ARCHS:
            shape = gnn_shape("molecule")
            cases.append((arch, registry.get_arch(arch).make_smoke_config(),
                          dataclasses.replace(shape, dims={
                              **shape.dims, **GNN_SMOKE_SHAPE})))
        eq_cfg = dataclasses.replace(
            registry.get_arch("equiformer-v2").make_config(),
            n_layers=GNN_PARITY_LAYERS)
        cases.append(("equiformer-v2", eq_cfg, gnn_shape("molecule")))
        out = []
        for arch, cfg, shape in cases:
            dims = lsteps.gnn_dims(shape)
            params, _ = lsteps.gnn_train_state(
                torch.Generator().manual_seed(0), arch, cfg, dims["d_in"],
                dims["num_classes"])
            fwd = lsteps.gnn_logits_fn(arch, cfg)
            res = {}
            for dev in ("cpu", "cuda"):
                p = params if dev == "cpu" else copy.deepcopy(params).cuda()
                t0 = time.perf_counter()
                res[dev] = lsteps.gnn_loss_and_grads(
                    fwd, shape.kind, p, lsteps.gnn_batches(shape,
                                                           device=dev))
                res[dev + "_s"] = time.perf_counter() - t0
            worst = gnn_grads_close(f"{arch} {cfg.name}", res["cuda"],
                                    res["cpu"])
            log(f"[gnn-parity] {arch} ({cfg.name}, "
                f"{getattr(cfg, 'n_layers', getattr(cfg, 'n_interactions', 0))}"
                f" layers) at {shape.name} N {dims['nodes']:,}: loss "
                f"{float(res['cuda'][0]):.6f} (CPU {float(res['cpu'][0]):.6f});"
                f" card vs CPU within {worst:.3f} of the limits (loss 1e-4 "
                f"relative, gradients {TOL_GRAD} x each leaf's max; CPU "
                f"{res['cpu_s']:.1f} s)")
            out.append({"arch": arch, "config": cfg.name, "shape": shape.name,
                        "nodes": dims["nodes"],
                        "loss": float(res["cuda"][0]),
                        "loss_cpu": float(res["cpu"][0]), "worst": worst})
            del params, res
            gc.collect()
        rest, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    launch_s = time.perf_counter() - t_launch
    lines = rest.splitlines()
    losses = [float(ln.split()[-1]) for ln in lines
              if ln.startswith("step ")]
    if proc.returncode != 0 or lines[-1:] != ["done"] or \
            len(losses) != GNN_LAUNCH_STEPS or \
            not np.isfinite(losses).all():
        raise SystemExit(f"gnn launcher: exit {proc.returncode}:\n{rest}\n"
                         + err[-2000:])
    log(f"[gnn-launcher] {' '.join(cmd[2:])}: losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f", done ({launch_s:.1f} s, beside the parity checks)")
    return {"cases": out, "launcher": {"losses": losses, "s": launch_s}}


# ------------------------------------------------------------- recsys -----

#: the recsys group's device activities by kind, first match wins
RECSYS_KINDS = (("GEMMs", ("gemm", "xmma", "cutlass")),
                ("embedding gathers (index_select)",
                 ("indexSelect", "gather")),
                ("embedding backward (sort, segment sums)",
                 ("embedding", "RadixSort", "radix", "segment",
                  "partial", "grad_weight")),
                ("cat copies", ("CatArrayBatchedCopy",)),
                ("other copies", ("copy", "Memcpy")),
                ("fills", ("FillFunctor", "Memset")),
                ("reductions", ("reduce_kernel",)))


def recsys_shape(name: str, **dims):
    from repro_torch.configs import registry
    shape = registry.get_arch("din").shapes[name]
    return dataclasses.replace(shape, dims={**shape.dims, **dims})


def recsys_train(torch, kernels, cfg) -> tuple[dict, object]:
    """``RECSYS_STEPS`` calls of the ``train_batch`` cell's step
    (``launch.steps.build_cell``: ``din_train_step``; B 65,536) on DIN's
    full config from the cell's ``make_inputs(0)`` (``din_batch`` seed 0
    and ``din_train_state`` with generator seed 0, on the card); every
    count zeroed just before and read just after (no kernel: DIN embeds
    with gathers and pools with GEMMs); losses finite; each step's host
    ms ending in the loss's read; peak memory; two more steps under the
    profiler, the second recorded. -> (stats, the trained parameters)."""
    import numpy as np

    from repro_torch.kernels.build import reset_counts
    from repro_torch.launch import steps as lsteps

    cell = lsteps.build_cell("din", "train_batch")
    shape = cell.shape
    if cell.config != cfg:
        raise SystemExit(f"recsys: the cell's config {cell.config}")
    t0 = time.perf_counter()
    params, opt, batch, labels = cell.make_inputs(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    step = cell.step
    start = {k: p.detach().cpu() for k, p in params.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    losses, step_ms = [], []
    for _ in range(RECSYS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch, labels)
        losses.append(float(loss))          # reads the loss: a sync
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in kernels}
    if any(launches.values()):
        raise SystemExit(f"recsys train: kernel launches {launches}")
    if not np.isfinite(losses).all():
        raise SystemExit(f"recsys train: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the labels are independent of the features, so the loss stays near
    # log 2: that the steps train is read from the parameters
    moved = {k: float((p.detach().cpu() - start[k]).norm())
             for k, p in params.named_parameters()}
    if not all(np.isfinite(v) and v > 0 for v in moved.values()):
        raise SystemExit(f"recsys train: parameter change norms {moved}")
    moved_norm = sum(v * v for v in moved.values()) ** 0.5
    del start
    warm = statistics.median(step_ms[1:])
    holder = [params, opt]

    def one_step():
        holder[0], holder[1], _ = step(holder[0], holder[1], batch, labels)

    t0 = time.perf_counter()
    wall_us, busy_us, by_name = device_profile(torch, one_step, host=False)
    prof_s = time.perf_counter() - t0
    kinds = gnn_kinds(by_name, RECSYS_KINDS)
    top = sorted(((k, sum(v) / 1e3, len(v)) for k, v in by_name.items()),
                 key=lambda r: -r[1])[:5]
    n_act = sum(len(v) for v in by_name.values())
    b = shape.dims["batch"]
    log(f"[recsys] train at train_batch (full config, {n_params:,} "
        f"parameters; B {b:,}, L {cfg.seq_len}): batch and state made on "
        f"the card in {setup_s:.1f} s; losses "
        + ", ".join(f"{v:.5f}" for v in losses)
        + f"; every leaf moved, the parameters by norm {moved_norm:.4f}")
    log("[recsys]   step ms " + ", ".join(f"{v:.1f}" for v in step_ms)
        + f"; warm median {warm:.2f} ms ({b / warm * 1e3:,.0f} examples/s); "
        f"peak {peak:.3f} GB; profiled step: wall {wall_us / 1e3:.2f} ms, "
        f"device busy {busy_us / 1e3:.2f} ms, idle share "
        f"{1 - busy_us / wall_us:.3f}, {n_act} device activities, "
        f"{prof_s:.1f} s with the profiler's collection; by kind: "
        + ", ".join(f"{k} {ms:.2f} ({n})" for k, ms, n in kinds[:6]))
    log("[recsys]   top device activities: " + "; ".join(
        f"{k[:80]} {ms:.2f} ms ({n})" for k, ms, n in top))
    params = holder[0]
    del opt, holder, batch, labels
    gc.collect()
    torch.cuda.empty_cache()
    stats = {"batch": b, "params": n_params, "losses": losses,
             "param_change_norm": moved_norm,
             "step_ms": step_ms, "warm_step_ms": warm,
             "examples_per_s": b / warm * 1e3, "peak_gb": peak,
             "profiled_wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
             "idle_share": 1 - busy_us / wall_us,
             "device_activities": n_act, "profile_s": prof_s,
             "kinds": [{"kind": k, "ms": ms, "count": n}
                       for k, ms, n in kinds],
             "top": [{"name": k[:120], "ms": ms, "count": n}
                     for k, ms, n in top],
             "launches": launches}
    return stats, params


def recsys_serve(torch, kernels, cfg, params) -> dict:
    """``ServeEngine(ServeConfig(model=cfg), params, device="cuda")``
    scoring waves of its synthetic requests at ``serve_p99`` (512) and
    ``serve_bulk`` (262,144): one warm wave each, then ``RECSYS_WAVES``
    waves, each ``score(batch_size=B)`` (the stopwatch spans the forward
    and the logits' copy to the host; the request draw and its copy to
    the card come before it); logits finite, (B, 2); p50 / p99 per shape;
    the bulk waves' peak memory; every count zeroed just before the waves
    and read just after."""
    import numpy as np

    from repro_torch.kernels.build import reset_counts
    from repro_torch.serve import ServeConfig, ServeEngine

    sizes = {name: recsys_shape(name).dims["batch"] for name in RECSYS_WAVES}
    eng = ServeEngine(ServeConfig(model=cfg,
                                  batch_sizes=tuple(sorted(sizes.values()))),
                      params=params, device="cuda")
    out = {}
    reset_counts(kernels)
    for name, waves in RECSYS_WAVES.items():
        b = sizes[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first = len(eng.result().query_latencies_ms)
        t0 = time.perf_counter()
        for _ in range(waves + 1):
            logits = eng.score(batch_size=b)
            if logits.shape != (b, cfg.num_classes) or \
                    not np.isfinite(logits).all():
                raise SystemExit(f"recsys serve {name}: logits "
                                 f"{logits.shape}, finite "
                                 f"{np.isfinite(logits).all()}")
        wall_s = time.perf_counter() - t0
        lat = eng.result().query_latencies_ms[first:]
        warm_ms, ms = lat[0], lat[1:]
        p50, p99 = (float(np.percentile(ms, q)) for q in (50, 99))
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[name] = {"batch": b, "waves": waves, "first_ms": warm_ms,
                     "ms": ms, "p50_ms": p50, "p99_ms": p99,
                     "queries_per_s": b / p50 * 1e3, "peak_gb": peak,
                     "wall_s": wall_s}
        log(f"[recsys] serve {name} (B {b:,}): {waves} waves after a warm "
            f"one ({warm_ms:.2f} ms): p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
            f"{b / p50 * 1e3:,.0f} queries/s at p50; peak {peak:.3f} GB; "
            f"{wall_s:.1f} s with the request draws")
    launches = {k.name: k.launches for k in kernels}
    if any(launches.values()):
        raise SystemExit(f"recsys serve: kernel launches {launches}")
    r = eng.result()
    log(f"[recsys]   {r.summary()}")
    out["launches"] = launches
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recsys_retrieval(torch, kernels, cfg, params) -> dict:
    """The ``retrieval_cand`` cell's step (``din_retrieval_step``) with
    the trained parameters: one user's history (``din_batch``, seed 1, on
    the card) against 1,000,000 candidates in chunks of ``RECSYS_CHUNK``,
    twice (the first warms the GEMMs' choices at the chunk's shapes);
    scores finite, in [0, 1], (N,); total ms,
    candidates/s, peak memory; every count zeroed just before and read
    just after."""
    from repro_torch.kernels.build import reset_counts
    from repro_torch.launch import steps as lsteps

    cell = lsteps.build_cell("din", "retrieval_cand")
    if cell.config != cfg or lsteps.RETRIEVAL_CHUNK != RECSYS_CHUNK:
        raise SystemExit("recsys: the retrieval cell's config or chunk")
    shape = cell.shape
    n = shape.dims["n_candidates"]
    batch = lsteps.din_batch(cfg, shape, seed=1, device="cuda")
    items, cates = batch.pop("cand_items"), batch.pop("cand_cates")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    runs_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = cell.step(params, batch, items, cates)
        torch.cuda.synchronize()
        runs_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in kernels}
    if any(launches.values()):
        raise SystemExit(f"recsys retrieval: kernel launches {launches}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    lo, hi = float(scores.min()), float(scores.max())
    if scores.shape != (n,) or not bool(torch.isfinite(scores).all()) \
            or lo < 0.0 or hi > 1.0:
        raise SystemExit(f"recsys retrieval: scores {tuple(scores.shape)}, "
                         f"range [{lo}, {hi}]")
    ms = runs_ms[-1]
    chunks = -(-n // RECSYS_CHUNK)
    log(f"[recsys] retrieval_cand: 1 user x {n:,} candidates in {chunks} "
        f"chunks of {RECSYS_CHUNK:,}: {ms:.2f} ms (first run "
        f"{runs_ms[0]:.2f}), {n / ms * 1e3:,.0f} candidates/s; scores in "
        f"[{lo:.4f}, {hi:.4f}]; peak {peak:.3f} GB")
    del batch, items, cates, scores
    gc.collect()
    torch.cuda.empty_cache()
    return {"candidates": n, "chunk": RECSYS_CHUNK, "chunks": chunks,
            "ms": ms, "first_ms": runs_ms[0],
            "candidates_per_s": n / ms * 1e3, "score_range": [lo, hi],
            "peak_gb": peak, "launches": launches}


def recsys_parity(torch) -> dict:
    """Card against CPU (TF32 off), the same parameters (drawn on the
    host, full config) on both: a batch of ``RECSYS_PARITY_BATCH`` at the
    full config (``din_batch``, seed 2) -- logits 1e-4, the loss 1e-4
    relative and one train step's gradients 1e-4 x each leaf's max; and
    ``RECSYS_PARITY_CANDIDATES`` retrieval candidates (seed 3) scored in
    chunks of ``RECSYS_PARITY_CHUNK`` on the card against unchunked on the
    CPU at 1e-4.  Meanwhile the launcher trains DIN at its full config
    (``--full-config``, B 65,536) on the card in a subprocess and must
    print finite losses and ``done``."""
    import copy

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.launch import steps as lsteps
    from repro_torch.models import din

    cfg = registry.get_arch("din").make_config()
    env = dict(os.environ, PYTHONPATH=str(SRC), PYTHONUNBUFFERED="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "din",
           "--full-config", "--steps", str(RECSYS_LAUNCH_STEPS)]
    t_launch = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    try:
        params, _ = lsteps.din_train_state(torch.Generator().manual_seed(5),
                                           cfg)
        shape = recsys_shape("train_batch", batch=RECSYS_PARITY_BATCH)
        arrays = lsteps.din_batch_arrays(cfg, shape, seed=2)
        res = {}
        for dev in ("cpu", "cuda"):
            p = params if dev == "cpu" else copy.deepcopy(params).cuda()
            batch = din.batch_to(arrays, dev)
            labels = batch.pop("labels")
            logits = lsteps.din_serve_step(p, batch).cpu()
            loss, grads = lsteps.din_loss_and_grads(p, batch, labels)
            res[dev] = (logits, loss, grads)
        (l_gpu, loss_gpu, g_gpu), (l_cpu, loss_cpu, g_cpu) = \
            res["cuda"], res["cpu"]
        logit_err = float((l_gpu - l_cpu).abs().max())
        worst = logit_err / (TOL_LOGITS * (1 + float(l_cpu.abs().max())))
        worst = max(worst, abs(float(loss_gpu) - float(loss_cpu))
                    / (TOL_GRAD * abs(float(loss_cpu))))
        for a, b in zip(g_gpu, g_cpu, strict=True):
            worst = max(worst, float((a.cpu() - b).abs().max())
                        / (TOL_GRAD * max(float(b.abs().max()), 1e-30)))
        if not worst <= 1.0:
            raise SystemExit(f"recsys parity: card vs CPU at {worst:.3f} x "
                             "the limits")
        del res, g_gpu, g_cpu
        rshape = recsys_shape("retrieval_cand",
                              n_candidates=RECSYS_PARITY_CANDIDATES)
        rarr = lsteps.din_batch_arrays(cfg, rshape, seed=3)
        scores = {}
        for dev, chunk in (("cpu", None), ("cuda", RECSYS_PARITY_CHUNK)):
            p = params if dev == "cpu" else copy.deepcopy(params).cuda()
            batch = din.batch_to(rarr, dev)
            items, cates = batch.pop("cand_items"), batch.pop("cand_cates")
            scores[dev] = lsteps.din_retrieval_step(
                p, batch, items, cates, chunk=chunk).cpu()
        r_err = float((scores["cuda"] - scores["cpu"]).abs().max())
        r_worst = r_err / (TOL_SCORES * (1 + float(scores["cpu"].abs()
                                                   .max())))
        if not r_worst <= 1.0:
            raise SystemExit(f"recsys parity: retrieval card vs CPU "
                             f"max|diff| {r_err:.3e}")
        log(f"[recsys-parity] full config, B {RECSYS_PARITY_BATCH}: logits "
            f"max|diff| {logit_err:.3e}, loss {float(loss_gpu):.6f} (CPU "
            f"{float(loss_cpu):.6f}); logits, loss and gradients within "
            f"{worst:.3f} of the limits (logits {TOL_LOGITS}, loss "
            f"{TOL_GRAD} relative, gradients {TOL_GRAD} x each leaf's max); "
            f"retrieval of {RECSYS_PARITY_CANDIDATES:,} candidates, chunks "
            f"of {RECSYS_PARITY_CHUNK:,} on the card against unchunked on "
            f"the CPU: max|diff| {r_err:.3e} ({r_worst:.3f} of the limit)")
        del params
        gc.collect()
        rest, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    launch_s = time.perf_counter() - t_launch
    lines = rest.splitlines()
    losses = [float(ln.split()[-1]) for ln in lines
              if ln.startswith("step ")]
    if proc.returncode != 0 or lines[-1:] != ["done"] or \
            len(losses) != RECSYS_LAUNCH_STEPS or \
            not np.isfinite(losses).all():
        raise SystemExit(f"recsys launcher: exit {proc.returncode}:\n{rest}\n"
                         + err[-2000:])
    log(f"[recsys-launcher] {' '.join(cmd[2:])}: losses "
        + ", ".join(f"{v:.4f}" for v in losses)
        + f", done ({launch_s:.1f} s, beside the parity checks)")
    return {"batch": RECSYS_PARITY_BATCH, "logits_max_abs_err": logit_err,
            "loss": float(loss_gpu), "loss_cpu": float(loss_cpu),
            "worst": worst, "retrieval_candidates": RECSYS_PARITY_CANDIDATES,
            "retrieval_chunk": RECSYS_PARITY_CHUNK,
            "retrieval_max_abs_err": r_err, "retrieval_worst": r_worst,
            "launcher": {"losses": losses, "s": launch_s}}


def lm_cell_step(torch, kernels, cell, rec: dict) -> dict:
    """One decode step of an LM cell at its registry shape (``long_500k``:
    B 1, 524,288 cached rows) from ``make_inputs(0)`` (bf16 weights and a
    cache of random values drawn on the card, ``len`` 524,287), every count
    zeroed just before and read just after (``flash_decode`` once a layer,
    nothing else); logits finite; the first step's ms, then
    ``LM_CELL_WARM`` warm steps on the same inputs (each rewrites row
    524,287); peak memory against the reckoning; one more step profiled:
    ``flash_decode``'s device time a launch on the path."""
    from repro_torch.kernels.build import reset_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, cache, token = cell.make_inputs(0)
    torch.cuda.synchronize()
    inputs_s = time.perf_counter() - t0
    reset_counts(kernels)
    t0 = time.perf_counter()
    logits, out = cell.step(params, cache, token)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in kernels}
    layers, s = cell.config.num_layers, cell.shape.dims["seq_len"]
    check_launches(f"cells {cell.arch_id} {cell.shape_name}", launches,
                   {"segment_spmm": 0, "banded_ttm": 0, "banded_ttm_t": 0,
                    "flash_decode": layers})
    if not (bool(torch.isfinite(logits).all())
            and logits.shape == (1, cell.config.padded_vocab)
            and out["len"].tolist() == [s]):
        raise SystemExit(f"cells {cell.arch_id}: logits "
                         f"{tuple(logits.shape)}, len {out['len'].tolist()}")
    # the ranks group's P = 1 check: the cell built over the one-rank NCCL
    # grid (the grid code) against the one built for no grid, the same
    # step on the same inputs (it rewrites the same row): bit for bit
    from repro_torch.launch import steps as lsteps
    plain = lsteps.build_cell(cell.arch_id, cell.shape_name, None)
    again, _ = plain.step(params, cache, token)
    p1_equal = bool(torch.equal(again, logits))
    log(f"[ranks] P = 1 over NCCL: {cell.arch_id} x {cell.shape_name} "
        f"through the grid code equals the one-rank path: {p1_equal}")
    if not p1_equal:
        raise SystemExit(f"cells {cell.arch_id}: the 1 x 1 grid's step "
                         "differs from the one-rank path's")
    del logits, out, again
    warm = []
    for _ in range(LM_CELL_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell.step(params, cache, token)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    own = {}
    _, busy_us, by_name = device_profile(
        torch, lambda: cell.step(params, cache, token), host=False,
        exclusive=own)
    fd = [v for k, v in by_name.items() if "flash_decode" in k]
    fd_ms = fd_exclusive_us(by_name, own) / 1e3 / layers
    part_ms = sum(sum(v) for k, v in by_name.items()
                  if "flash_decode_partial" in k) / 1e3 / layers
    reckoned = rec["need_bytes"] - rec["reserve_bytes"]
    log(f"[cells] {cell.arch_id} x {cell.shape_name} decode (B 1, {s:,} "
        f"cached rows, bf16): inputs drawn on the card in {inputs_s:.1f} s; "
        f"first step {first_ms:.1f} ms, warm "
        f"{', '.join(f'{v:.2f}' for v in warm)} ms; peak {peak / 1e9:.3f} GB against the "
        f"reckoned {reckoned / 1e9:.3f} (arguments "
        f"{rec['arg_bytes'] / 1e9:.3f}); profiled step busy "
        f"{busy_us / 1e3:.2f} ms, flash_decode {fd_ms:.4f} ms a launch on "
        f"the path: its partial kernel's own span {part_ms:.4f} and the "
        f"combine's tail {fd_ms - part_ms:.4f} "
        f"({sum(len(v) for v in fd)} device activities)")
    if peak > reckoned:
        raise SystemExit(f"cells {cell.arch_id}: peak {peak} over the "
                         f"reckoning's {reckoned}")
    del params, cache, token
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cell.arch_id, "shape": cell.shape_name,
            "inputs_s": inputs_s, "first_step_ms": first_ms,
            "warm_step_ms": warm, "peak_bytes": peak,
            "reckoned_bytes": reckoned, "arg_bytes": rec["arg_bytes"],
            "busy_ms": busy_us / 1e3, "flash_decode_ms_per_launch": fd_ms,
            "flash_decode_partial_ms_per_launch": part_ms,
            "launches": launches, "p1_equal_to_one_rank": p1_equal}


def cells_spmm_row(torch, name: str, x, csr, timer) -> dict:
    """``segment_spmm`` on one CSR held to its plain version, shown to
    reject zeros and a dropped edge, and timed beside its bound, its plain
    version and ``torch.sparse.mm``."""
    from repro_torch.kernels.segment_spmm import ops, ref

    row_ptr, col, w = csr
    n, f, nnz = row_ptr.shape[0] - 1, x.shape[1], int(row_ptr[-1])
    got = ops.segment_spmm_csr(x, row_ptr, col, w)
    want = ref.segment_spmm_csr_ref(x, row_ptr, col, w)
    torch.cuda.synchronize()
    err = check_close(name, got, want, TOL_SPMM)
    faults = spmm_faults(name, ops, x, row_ptr, col, w, want)
    lib = torch.sparse_csr_tensor(row_ptr, col[:nnz], w[:nnz], size=(n, n),
                                  check_invariants=False)
    b_ms, b_by = bound_ms(x.nbytes + row_ptr.nbytes + nnz * 8 + got.nbytes,
                          2.0 * nnz * f)

    def kern():
        return ops.segment_spmm_csr(x, row_ptr, col, w)

    row = {"case": name, "N": n, "F": f, "nnz": nnz, "ms": timer(kern),
           "plain_ms": timer(lambda: ref.segment_spmm_csr_ref(
               x, row_ptr, col, w)),
           "library_ms": timer(lambda: torch.sparse.mm(lib, x)),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
           "fault_over_limit": faults}
    log(f"[kernel] {name} ({nnz:,} edges): kernel {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f}, torch.sparse.mm "
        f"{row['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}); max|err| "
        f"{err:.2e}; faults rejected at x limit: zeros "
        f"{faults['zeros']:.1f}, last edge dropped "
        f"{faults['last edge dropped']:.1f}")
    return row


def cells_kernel_checks(torch, cell, inputs, timer) -> dict:
    """The kernels at a TM-GCN cell's own shapes on the card, each held to
    its plain version, shown to reject faulty outputs and timed:
    ``segment_spmm`` on the cell's first snapshot, its CSR at the step's
    F = 2 (layer 1) and 6 (layer 2) and its transposed CSR at F = 6 (the
    backward); ``banded_ttm`` on block 0's and block 1's [prefix (w - 1
    rows); slice (T / nb rows)] of (., N x 6) (blocks 2 on read the same
    full band as block 1) and ``banded_ttm_t`` on their kept rows'
    gradient."""
    from repro_torch.kernels.segment_spmm import ops as spmm_ops

    cfg, n = cell.config, cell.meta["nodes"]
    edges, ew = inputs[3][0, 0], inputs[4][0, 0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    csr, csr_t = spmm_ops.build_csr_pair(edges, ew, n)
    tag = f"segment_spmm {cell.shape_name}"
    spmm = [cells_spmm_row(torch, f"{tag} F={f}", torch.randn(
                (n, f), generator=gen, device="cuda"), csr, timer)
            for f in (cfg.feat_in, cfg.hidden)]
    spmm.append(cells_spmm_row(torch, f"{tag} transposed F={cfg.hidden}",
                               torch.randn((n, cfg.hidden), generator=gen,
                                           device="cuda"), csr_t, timer))
    del csr, csr_t
    bsize, w1 = cfg.num_steps // cfg.checkpoint_blocks, cfg.window - 1
    fwd = band_rows(torch, gen, n, cfg.window, timer, (
        (bsize, w1, -w1), (bsize, w1, bsize - w1)))
    bwd = band_t_rows(torch, gen, n, cfg.window, timer, (
        (bsize, w1, -w1, False), (bsize, w1, bsize - w1, True)))
    torch.cuda.empty_cache()
    return {"segment_spmm": spmm, "banded_ttm": fwd, "banded_ttm_t": bwd}


def dyngnn_cell_step(torch, kernels, cell, rec: dict, timer) -> dict:
    """One step of a dyngnn cell at its registry shape (the full T) over
    the one-rank NCCL group, from ``make_inputs(0)`` drawn on the card;
    every count zeroed just before and read just after: per step 5 T
    ``segment_spmm`` (L T forward, L T recompute, T backward), TM-GCN's
    ``banded_ttm`` 2 L nb (the fused final loss lies in the block, so its
    recompute reaches the last band) and ``banded_ttm_t`` L nb, none for
    CD-GCN and EvolveGCN, 2 T CSR builds; the loss finite; peak memory
    against the reckoning (the block's floats a (step, vertex) read back
    from it) and the analytic roofline beside the step's ms; for TM-GCN,
    whose step runs all three kernels, ``cells_kernel_checks`` on the
    cell's inputs."""
    import math

    from repro_torch.kernels.build import reset_counts
    from repro_torch.kernels.segment_spmm import ops as spmm_ops
    from repro_torch.launch import dryrun

    cfg, m = cell.config, cell.meta
    n, t, nb, layers = m["nodes"], m["steps"], cfg.checkpoint_blocks, \
        cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    inputs = cell.make_inputs(0)
    torch.cuda.synchronize()
    inputs_s = time.perf_counter() - t0
    reset_counts(kernels)
    spmm_ops.csr_builds = 0
    t0 = time.perf_counter()
    _, _, loss = cell.step(*inputs)
    loss = float(loss)                    # reads the loss: a sync
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in kernels}
    launches["csr_builds"] = spmm_ops.csr_builds
    band = cfg.model == "tmgcn"
    check_launches(f"cells {cell.arch_id} {cell.shape_name}", launches,
                   {"segment_spmm": (2 * layers + 1) * t,
                    "banded_ttm": 2 * layers * nb if band else 0,
                    "banded_ttm_t": layers * nb if band else 0,
                    "flash_decode": 0, "csr_builds": 2 * t})
    if not (math.isfinite(loss) and 0.0 < loss < 2.0):
        raise SystemExit(f"cells {cell.arch_id} {cell.shape_name}: loss "
                         f"{loss}")
    peak = torch.cuda.max_memory_allocated()
    reckoned = rec["need_bytes"] - rec["reserve_bytes"]
    block = (peak - rec["arg_bytes"] - rec["work"]["CSR pairs"]
             - rec["work"]["block carries"]) / (4 * (t // nb) * n)
    cost, coll = dryrun.dyngnn_analytic(m, cfg, 1)
    rl = dryrun.roofline(cost, coll)
    log(f"[cells] {cell.arch_id} x {cell.shape_name} (N {n:,}, T {t}, nb "
        f"{nb}, {m['edges_per_snap']:,} lanes a snapshot): inputs drawn on "
        f"the card in {inputs_s:.1f} s; step {step_ms:.1f} ms (host clock, "
        f"the loss read), loss {loss:.5f}; peak "
        f"{peak / 1e9:.3f} GB against the reckoned {reckoned / 1e9:.3f} "
        f"(a block {block:.1f} floats a (step, vertex) against "
        f"{dryrun.DYNGNN_BLOCK_FLOATS[cfg.model]}); analytic roofline "
        f"{rl['bound_s'] * 1e3:.2f} ms ({rl['dominant']}; "
        f"{cost['flops'] / 1e9:.1f} GFLOP, "
        f"{cost['bytes accessed'] / 1e9:.1f} GB): the step "
        f"{step_ms / (rl['bound_s'] * 1e3):.1f}x it")
    if peak > reckoned:
        raise SystemExit(f"cells {cell.arch_id} {cell.shape_name}: peak "
                         f"{peak} over the reckoning's {reckoned}")
    checks = cells_kernel_checks(torch, cell, inputs, timer) if band else {}
    del inputs
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cell.arch_id, "shape": cell.shape_name, "N": n, "T": t,
            "inputs_s": inputs_s, "step_ms": step_ms, "loss": loss,
            "peak_bytes": peak, "reckoned_bytes": reckoned,
            "arg_bytes": rec["arg_bytes"], "block_floats": block,
            "roofline_ms": rl["bound_s"] * 1e3, "dominant": rl["dominant"],
            "flops": cost["flops"], "bytes": cost["bytes accessed"],
            "launches": launches, "kernel_checks": checks}


def cells_parity(torch, grid) -> dict:
    """The dyngnn cell's step on the card (NCCL, kernels) against the
    same step on the CPU (a one-rank gloo group, plain versions) from the
    card's inputs, for all three models at ``CELLS_PARITY``: the loss and
    every leaf of the step's output -- the parameters and AdamW's m
    ((1 - b1) x the clipped gradient), v and master -- within
    ``TOL_CELL_BF16`` (the loss relative, leaves x each leaf's max)."""
    import copy

    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps as lsteps

    cpu_grid = lmesh.make_host_mesh(1, 1, group=dist.new_group(
        backend="gloo"))
    out = {}
    for model in ("tmgcn", "cdgcn", "evolvegcn"):
        t0 = time.perf_counter()
        card = lsteps.build_cell(model, "dtdg_epinions", grid,
                                 shape_override=CELLS_PARITY)
        cpu = lsteps.build_cell(model, "dtdg_epinions", cpu_grid,
                                shape_override=CELLS_PARITY, device="cpu")
        inputs = card.make_inputs(0)
        params, opt, *arrays = inputs
        host = (copy.deepcopy(params).to("cpu"),
                {k: ({n: v.cpu() for n, v in d.items()}
                     if isinstance(d, dict) else d.cpu())
                 for k, d in opt.items()}) + tuple(a.cpu() for a in arrays)
        got = lsteps.input_leaves(card.step(*inputs))
        want = lsteps.input_leaves(cpu.step(*host))
        worst, worst_leaf = 0.0, ""
        for k, w in want.items():
            g = got[k].detach().cpu().double()
            w = w.detach().double()
            if not w.is_floating_point():
                if not torch.equal(g, w):
                    raise SystemExit(f"cells parity {model}: {k} differs")
                continue
            if k == "2":
                err = abs(float(g) - float(w)) / abs(float(w))
            else:
                err = float((g - w).abs().max()) / max(
                    float(w.abs().max()), 1e-30)
            if err > worst:
                worst, worst_leaf = err, k
        loss_err = abs(float(got["2"]) - float(want["2"])) / abs(
            float(want["2"]))
        log(f"[cells] card vs CPU, {model} cell at N "
            f"{CELLS_PARITY['n_nodes']:,}, T {CELLS_PARITY['n_steps']}: loss {float(got['2']):.6f} vs "
            f"{float(want['2']):.6f} ({loss_err:.2e} relative); the worst "
            f"leaf {worst_leaf} at {worst:.2e} of its max (limit "
            f"{TOL_CELL_BF16}; {time.perf_counter() - t0:.1f} s)")
        if worst > TOL_CELL_BF16:
            raise SystemExit(f"cells parity {model}: {worst_leaf} at "
                             f"{worst:.3e}")
        out[model] = {"loss_rel": loss_err, "worst": worst,
                      "worst_leaf": worst_leaf}
        del inputs, host, params, opt, arrays
        gc.collect()
        torch.cuda.empty_cache()
    return out


def cells_path(torch, kernels, card: str, timer) -> dict:
    """The cells on one card (``launch.steps.build_cell`` over the
    one-rank NCCL group this group opens and ends): the reckoning of all
    60 (``launch.dryrun.reckon``, against the card's memory less what the
    process still holds), then one step of every cell it reckons to fit
    that no other group runs at its registry shape -- the LM decode cells
    (``lm_cell_step``) and the 15 distinct dyngnn cells (``paper_dyngnn``
    is ``tmgcn``'s; ``dyngnn_cell_step``) -- with the allocator's segments
    expandable; the dyngnn cell card against CPU (``cells_parity``).  On
    an H100 80GB the cells stepped must be ``CELLS_STEPPED``: the
    reckoning against the whole card gives them, and the memory this
    process holds may drop none."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps as lsteps

    gc.collect()
    # cuBLAS keeps a 32 MiB workspace for the process's life; made while
    # an earlier group's freed segment lay cached, it sits in it and holds
    # all of it (5.9 GB after the lm group alone): cleared, empty_cache
    # returns the segment, and the next GEMM makes a workspace anew
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    held = torch.cuda.memory_reserved()
    cap = total - held
    dryrun.expandable_segments(True)
    group = nccl_group(torch)
    try:
        grid = lmesh.make_host_mesh(1, 1)
        log(f"[cells] {card}: capacity {cap:,} B (total_memory {total:,} "
            f"less {held:,} this process holds, "
            f"{torch.cuda.memory_allocated():,} of it allocated); the "
            "reckoning of "
            f"{len(lsteps.all_cells())} cells (arguments exact, work per "
            f"family, reserve {dryrun.RESERVE:,} B):")
        t0 = time.perf_counter()
        cells, recs = {}, {}
        for arch, shape in lsteps.all_cells():
            cells[arch, shape] = lsteps.build_cell(arch, shape, grid)
            recs[arch, shape] = dryrun.reckon(cells[arch, shape], cap)
            log(f"[cells]   {dryrun.summary(recs[arch, shape])}")
        reckon_s = time.perf_counter() - t0
        fits = [k for k, r in recs.items() if r["fits"]]
        log(f"[cells] {len(fits)} of {len(recs)} fit ({reckon_s:.1f} s)")
        elsewhere = {k for k in fits if recs[k]["family"] in ("gnn",
                                                               "recsys")}
        stepped = [k for k in fits
                   if k not in elsewhere and k[0] != "paper_dyngnn"]
        whole = {k for k in recs if k not in elsewhere
                 and k[0] != "paper_dyngnn"
                 and dryrun.reckon(cells[k], total)["fits"]}
        if total == H100_80GB_BYTES and whole != set(CELLS_STEPPED):
            raise SystemExit(
                f"cells: against the whole H100 80GB the reckoning steps "
                f"{sorted(whole)}, not the pinned CELLS_STEPPED")
        if set(stepped) != whole:
            raise SystemExit(
                f"cells: the {held:,} B this process holds drop "
                f"{sorted(whole - set(stepped))} from the cells stepped")
        runs = []
        for k in stepped:
            if recs[k]["family"] == "lm":
                runs.append(lm_cell_step(torch, kernels, cells[k], recs[k]))
            else:
                runs.append(dyngnn_cell_step(torch, kernels, cells[k],
                                             recs[k], timer))
        parity = cells_parity(torch, grid)
    finally:
        dist.destroy_process_group()
        dryrun.expandable_segments(False)
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k.name: sum(r["launches"][k.name] for r in runs)
                for k in kernels}
    return {"capacity_bytes": cap, "total_memory": total,
            "held_bytes": held, "reckon_s": reckon_s,
            "reckoning": [[r["arch"], r["shape"], r["arg_bytes"],
                           r["need_bytes"], r["fits"]]
                          for r in recs.values()],
            "fits": [list(k) for k in fits],
            "stepped": [list(k) for k in stepped],
            "run_elsewhere": sorted(list(k) for k in elsewhere),
            "runs": runs, "parity": parity, "launches": launches}


# ---------------------------------------------------------------- ranks ----

#: the LM cells the ranks group runs over a 2 x 2 grid of gloo ranks on
#: cuda:0, at full width, each held to the same cell at 1 x 1 on the card:
#: (arch, shape, shape override, layers kept).  Depth is cut to what keeps
#: the group inside its time and the card's memory: 4 of Yi-6B's 32
#: layers; 4 of OLMoE-1B-7B's 16 for decode and 2 for its train step (the
#: 1 x 1 references' AdamW state in bf16 and fp32 beside the ranks' own).
#: Yi's long_500k keeps its registry S and B.
RANKS_CELLS = (
    ("yi-6b", "train_4k", {"seq_len": 512, "global_batch": 4}, 4),
    ("yi-6b", "prefill_32k", {"seq_len": 512, "global_batch": 4}, 4),
    ("yi-6b", "decode_32k", {"seq_len": 1024, "global_batch": 4}, 4),
    ("yi-6b", "long_500k", None, 4),
    ("olmoe-1b-7b", "train_4k", {"seq_len": 512, "global_batch": 4}, 2),
    ("olmoe-1b-7b", "decode_32k", {"seq_len": 1024, "global_batch": 4}, 4),
)
RANKS_GRID = (2, 2)
RANKS_DECODE_STEPS = 3
#: long_500k's cache length before its decode steps: slices 0 and 1 full,
#: slice 2 part-filled, slice 3 empty (its weight in the merge exactly 0)
RANKS_LONG_LEN = 300_000
RANKS_DEADLINE_S = 600
RANKS_THREADS = 2           # CPU threads a rank: gloo reduces on the host
#: flash_decode's log-sum-exp output: a long_500k rank's slice of Yi-6B's
#: cache (B 1, S 524,288 / 4), full, ragged and empty
FD_LSE_CASES = [
    ("long_500k slice", 1, 32, 4, 128, 131072, [131072]),
    ("long_500k slice, part", 1, 32, 4, 128, 131072, [44_288]),
    ("long_500k slice, empty", 1, 32, 4, 128, 131072, [0]),
]
TOL_LSE = 1e-4              # abs + rel: fp32 sums of the same products
#: the static-GNN and DIN cells the ranks group runs over the same 2 x 2
#: grid at their full configs and widths, each held to 1 x 1 on the card
#: (f32; only the order of the sums differs): (arch, shape, shape
#: override, config override).  Four ranks share the card, so SchNet's
#: ogb_products keeps its 2,449,029 nodes (one padding row at 2 data
#: ranks), 100 features and widths with its edges cut from 61,859,140 to
#: 2,000,000 and its depth from 3 interactions to 1 (the host moves each
#: gathered (N, 64) tensor through gloo, 3 x a layer's bytes at depth 3:
#: ~45-50 s of the script; a step's bytes follow the nodes and the
#: depth, not the edges); EquiformerV2 keeps 4 of its 12 layers at both
#: shapes (8-11 s a step at 12); EquiformerV2's
#: minibatch_lg has its 1,024 seeds cut to 192 (a rank's replica of 512
#: reckons 69.2 GB with the reserve, four do not fit; of 96, 15.3 GB);
#: the rest keep their registry shapes (DIN's retrieval 1,000,000
#: candidates, 500,000 a data rank, in chunks of RANKS_RETRIEVAL_CHUNK)
RANKS_STATIC_CELLS = (
    ("gatedgcn", "full_graph_sm", None, None),
    ("pna", "full_graph_sm", None, None),
    ("schnet", "ogb_products", {"n_edges": 2_000_000},
     {"n_interactions": 1}),
    ("equiformer-v2", "full_graph_sm", None, {"n_layers": 4}),
    ("equiformer-v2", "minibatch_lg", {"batch_nodes": 192},
     {"n_layers": 4}),
    ("schnet", "molecule", None, None),
    ("din", "train_batch", None, None),
    ("din", "serve_p99", None, None),
    ("din", "retrieval_cand", None, None),
)
#: candidates a rank scores at a time on the shared card (131,072 a chunk
#: holds 19.5 GB of features: four ranks at once would not fit)
RANKS_RETRIEVAL_CHUNK = 32_768
#: each leaf of a GNN or DIN cell within this x its max at 1 x 1 (the side
#: workloads' limit)
TOL_RANKS_STATIC = 1e-4
#: the archs whose ranks and 1 x 1 run step in float64 (parameters, graph
#: tensors and the steps; AdamW's state stays fp32): in f32 the card's
#: index_add and scatter atomics sum in another order each run, and two
#: identical 1 x 1 steps of GatedGCN's 16 layers differ by 1.27e-3 of an
#: m leaf's max and 2.88e-3 of a leaf that starts at zero (one Adam
#: update, lr g / (|g| + 1e-8), decided by g's last bits where |g| is
#: near 1e-8; scripts/gnn_step_spread.py on an H100 80GB HBM3 at 700 W),
#: PNA's std and SchNet's zero-started biases past 1e-4 too, so no
#: re-ordered step can be held to TOL_RANKS_STATIC in f32; in f64 the
#: order moves nothing the check can see and a layout fault still shows.
#: EquiformerV2 (f32 SO(3) tables) and DIN stay f32: within it as they are
RANKS_STATIC_F64 = ("gatedgcn", "pna", "schnet")


def ranks_cell(steps, arch: str, shape: str, over, layers: int, grid,
               dtype=None, device="cuda"):
    """One of ``RANKS_CELLS`` over ``grid`` (None: one rank)."""
    cfg = {"num_layers": layers}
    if dtype is not None:
        cfg["dtype"] = dtype
    return steps.build_cell(arch, shape, grid, shape_override=over,
                            config_override=cfg, device=device)


def ranks_inputs(cell) -> list:
    """``make_inputs(0)``; a decode cell's cache then steps back, so its
    ``RANKS_DECODE_STEPS`` steps fit (long_500k's to ``RANKS_LONG_LEN``)."""
    inputs = list(cell.make_inputs(0))
    if cell.kind == "decode":
        cache = inputs[1]
        back = (cell.shape.dims["seq_len"] - RANKS_LONG_LEN
                if cell.shape_name == "long_500k" else RANKS_DECODE_STEPS)
        cache["len"] = cache["len"] - back
    return inputs


def ranks_run(cell, inputs: list) -> dict:
    """The cell's step(s) -> {output path: tensor}: a train step's
    parameters (``0.*``), AdamW state (``1.*``) and loss (``2``); a
    prefill's logits (``0``) and cache (``1.*``); each decode step's
    logits (``0.step<i>``) and the last cache (``1.*``)."""
    from repro_torch.launch import steps

    if cell.kind != "decode":
        return steps.input_leaves(cell.step(*inputs))
    params, cache, token = inputs
    out = {}
    for i in range(RANKS_DECODE_STEPS):       # the same token each step
        logits, cache = cell.step(params, cache, token)
        out[f"0.step{i}"] = logits
    out.update({f"1.{k}": v for k, v in cache.items()})
    return out


def ranks_specs(cell) -> dict:
    """{output path: spec} of :func:`ranks_run`'s outputs."""
    from repro_torch.launch import dryrun

    flat = dryrun.flat_in_specs(cell.out_specs)
    if cell.kind == "decode":
        logits = flat.pop("0")
        flat.update({f"0.step{i}": logits
                     for i in range(RANKS_DECODE_STEPS)})
    return flat


def ranks_kind(path: str) -> str:
    """The kind of an output leaf its bound is taken over: a train step's
    ``params``, ``m``, ``v``, ``master`` or ``loss``, a serve step's
    ``logits`` or ``cache``."""
    parts = path.split(".")
    if parts[0] == "1" and len(parts) > 2:
        return parts[1]
    return {"0": "params" if len(parts) > 1 and not parts[1]
            .startswith("step") else "logits", "1": "cache",
            "2": "loss"}[parts[0]]


def _ranks_rank(rank: int, src: str, store: str, q_out, q_go) -> None:
    """A rank of the 2 x 2 grid on cuda:0: each of ``RANKS_CELLS``, then
    each of ``RANKS_STATIC_CELLS``, when the main process says go, its
    outputs' shares handed over as CUDA tensors (IPC, no copy) with its
    launches, peak, seconds and collective bytes (``obs`` counters); it
    holds them until the main process has read them."""
    torch, dist = _rank_setup(rank, src, store, 4)
    torch.set_num_threads(RANKS_THREADS)
    from repro_torch import kernels as kmod
    from repro_torch import obs
    from repro_torch.kernels.build import reset_counts
    from repro_torch.launch import mesh, steps

    steps.RETRIEVAL_CHUNK = RANKS_RETRIEVAL_CHUNK
    try:
        grid = mesh.make_host_mesh(*RANKS_GRID)
        todo = [functools.partial(ranks_cell, steps, arch, shape, over,
                                  layers, grid)
                for arch, shape, over, layers in RANKS_CELLS]
        todo += [functools.partial(steps.build_cell, arch, shape, grid,
                                   shape_override=over,
                                   config_override=cfg)
                 for arch, shape, over, cfg in RANKS_STATIC_CELLS]
        for i, make in enumerate(todo):
            if q_go[rank].get() != i:
                raise RuntimeError(f"rank {rank}: out of step at cell {i}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cell = make()
            inputs = static_f64(torch, cell, ranks_inputs(cell))
            held = torch.cuda.memory_allocated()
            torch.cuda.synchronize()
            peak_inputs = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(kmod.ALL)
            before = obs.metrics_snapshot()
            t1 = time.perf_counter()
            out = ranks_run(cell, inputs)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t1
            step_peak = torch.cuda.max_memory_allocated()
            moved = {k: v for k, v in obs.metrics().delta(before)
                     ["counters"].items() if k.endswith("_bytes")}
            meta = {"launches": {k.name: k.launches for k in kmod.ALL},
                    "peak_bytes": max(peak_inputs, step_peak),
                    "step_peak_bytes": step_peak,
                    "input_bytes": held, "step_s": step_s,
                    "cell_s": time.perf_counter() - t0,
                    "collective_bytes": moved}
            q_out.put((rank, i, {k: v.detach() for k, v in out.items()},
                       meta))
            if q_go[rank].get() != ("done", i):
                raise RuntimeError(f"rank {rank}: no release of cell {i}")
            del cell, inputs, out
            gc.collect()
            # the blocks handed over stay this process's until it collects
            # them once the main process has let go
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def ranks_compare(torch, shd, specs: dict, shares: list, want: dict,
                  floor: dict) -> dict:
    """Each output leaf gathered from the ranks' shares (one leaf at a
    time, on the card) against the 1 x 1 run: its max |diff| over its max
    |value| (integers equal) -> {path: ratio}; fails if a ratio passes
    twice the worst bf16-vs-fp32 ratio of its kind (``floor``; the loss,
    a single number whose bf16 noise one sample does not measure, twice
    the run's worst)."""
    grid = shd.Grid(*RANKS_GRID, 0, None, None)
    out = {}
    for path, w in want.items():
        g = shd.gather_tree([{"x": s[path]} for s in shares],
                            {"x": specs[path]}, grid)["x"]
        if tuple(g.shape) != tuple(w.shape):
            raise SystemExit(f"ranks: {path} gathered {tuple(g.shape)}, "
                             f"1 x 1 {tuple(w.shape)}")
        if not w.is_floating_point():
            if not torch.equal(g, w):
                raise SystemExit(f"ranks: {path} differs from 1 x 1")
            continue
        ratio = rel_diff(g, w)
        kind = ranks_kind(path)
        # a kind's leaves against its own worst; the loss, one number,
        # against the run's worst
        lim = floor[kind] if kind != "loss" else max(floor.values())
        if not ratio <= 2 * lim:
            raise SystemExit(f"ranks: {path} at {ratio:.3e} of its max, "
                             f"over twice the bf16-vs-fp32 {lim:.3e} of "
                             f"its kind ({kind})")
        out[path] = ratio
        del g
    return out


def rel_diff(a, b, chunk: int = 1 << 24) -> float:
    """max |a - b| over max |b|, in fp32 a chunk of ``chunk`` elements at
    a time (a leaf's fp32 copy would not fit beside the ranks' state)."""
    a, b = a.detach().reshape(-1), b.detach().reshape(-1)
    diff = top = 0.0
    for i in range(0, b.numel(), chunk):
        x, y = a[i:i + chunk].float(), b[i:i + chunk].float()
        diff = max(diff, float((x - y).abs().max()))
        top = max(top, float(y.abs().max()))
    return diff / max(top, 1e-30)


def ranks_fp32(torch, steps, arch, shape, over, layers, inputs: list
               ) -> dict:
    """The same cell at 1 x 1 in fp32 on copies of ``inputs`` cast to
    fp32 (a train cell's AdamW state made anew: master = the cast
    parameters, m = v = 0, as in bf16) -> its outputs."""
    from repro_torch.core.models import ParamTree
    from repro_torch.optim import adamw

    cell = ranks_cell(steps, arch, shape, over, layers, None,
                      dtype=torch.float32)

    def f32(x):
        if isinstance(x, dict):
            return {k: f32(v) for k, v in x.items()}
        return x.detach().to(torch.float32, copy=True) \
            if x.is_floating_point() else x.clone()

    if cell.kind == "train":
        params = ParamTree(f32(steps.lm_tree(inputs[0])))
        cast = [params, adamw.init_state(params)] + inputs[2:]
    else:
        cast = [f32(x) if isinstance(x, dict) else x for x in inputs]
    return ranks_run(cell, cast)


def ranks_floor(want: dict, got32: dict) -> dict:
    """The worst |bf16 - fp32| over each leaf's max, by kind: the bf16
    noise the 2 x 2 run is bounded by."""
    floor: dict = {}
    for path, w in want.items():
        if w.is_floating_point():
            kind = ranks_kind(path)
            floor[kind] = max(floor.get(kind, 0.0),
                              rel_diff(w, got32[path]))
    return floor


def lse_checks(torch, timer, cases=FD_LSE_CASES, tag="ranks"
               ) -> list[dict]:
    """``flash_decode``'s log-sum-exp output (``return_lse``) against the
    plain version's at ``cases`` in bf16: the output as the other
    bf16 checks hold it, the log-sum-exp within ``TOL_LSE`` (abs + rel),
    an empty slice's output exactly 0 and its log-sum-exp exactly -inf;
    each check shown to reject zeros and a dropped split; the output the
    same bits as the call without it; timed beside the call without it
    (in turns), the plain version and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for name, b, hq, kvh, d, s, lens in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for shape in
                   ((b, hq, d), (b, s, kvh, d), (b, s, kvh, d)))
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        o, lse = ops.decode_attention(q, k, v, cl, return_lse=True)
        o32, lse32 = ref.flash_decode_ref(q.float(), k.float(), v.float(),
                                          cl, return_lse=True)
        pl = ops.plan(b, s, hq, kvh, d, True, ops._sm_count(0))
        if lens[0] <= 0:
            if not (bool((o == 0).all()) and bool(torch.isneginf(lse).all())
                    and bool((o32 == 0).all())
                    and bool(torch.isneginf(lse32).all())):
                raise SystemExit(f"flash_decode lse {name}: an empty slice "
                                 "must give 0 and -inf")
            err, ratio, lse_err = 0.0, 0.0, 0.0
            faults = {}
        else:
            err, ratio = fd_excess("bfloat16", o.float(), o32)
            lse_err = float(((lse - lse32).abs()
                             / (1.0 + lse32.abs())).max())
            if not (ratio <= 1.0 and lse_err <= TOL_LSE):
                raise SystemExit(f"flash_decode lse {name}: output "
                                 f"{ratio:.3f} x its limit, lse {lse_err:.2e}")
            if not torch.equal(o, ops.decode_attention(q, k, v, cl)):
                raise SystemExit(f"flash_decode lse {name}: the output "
                                 "differs from the call without lse")
            cut = torch.tensor(dropped_split_lens(lens, s, pl[1]),
                               dtype=torch.int32, device="cuda")
            _, lse_cut = ops.decode_attention(q, k, v, cut, return_lse=True)
            faults = {"zeros": fd_excess("bfloat16", torch.zeros_like(
                o).float(), o32)[1], "lse of a split dropped": float(
                ((lse_cut - lse32).abs() / (1.0 + lse32.abs())).max())
                / TOL_LSE}
            if min(faults.values()) <= 1.0:
                raise SystemExit(f"flash_decode lse {name}: the check would "
                                 f"pass a faulty kernel: {faults}")
        n_rows = [min(x, s) if x > 0 else 0 for x in lens]
        nbytes = 2 * q.nbytes + cl.nbytes + lse.nbytes \
            + 2 * sum(n_rows) * kvh * d * q.element_size()
        b_ms, b_by = bound_ms(nbytes, 4.0 * sum(n_rows) * hq * d)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(s, device="cuda")[None, :]
                < torch.tensor([max(x, 1) for x in n_rows],
                               device="cuda")[:, None])[:, None, None, :]

        def lib(q=q, kt=kt, vt=vt, mask=mask):
            return F.scaled_dot_product_attention(
                q[:, :, None, :], kt, vt, attn_mask=mask,
                enable_gqa=True)[:, :, 0]

        t = timer.turns({
            "lse": lambda: ops.decode_attention(q, k, v, cl,
                                                return_lse=True),
            "no_lse": lambda: ops.decode_attention(q, k, v, cl)})
        row = {"case": name, "dtype": "bfloat16", "B": b, "Hq": hq,
               "KVH": kvh, "D": d, "S": s, "cache_len": lens, "plan": pl,
               "instance": fd_instance(ops, pl, d),
               "ms": t["lse"], "ms_without_lse": t["no_lse"],
               "plain_ms": timer(lambda: ref.flash_decode_ref(
                   q, k, v, cl, return_lse=True)),
               "library_ms": timer(lib), "bound_ms": b_ms,
               "bound_by": b_by, "max_abs_err": err,
               "err_over_limit": ratio, "lse_err": lse_err,
               "fault_over_limit": faults}
        log(f"[{tag}] flash_decode lse {name} (B {b}, Hq {hq}, KVH {kvh}, "
            f"D {d}, S {s}, cache_len {lens}, plan {pl}, {row['instance']})"
            f": with lse {row['ms']:.4f} ms, without "
            f"{row['ms_without_lse']:.4f}, "
            f"plain {row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, "
            f"bound {b_ms:.4f} ({b_by}); output max|err| {err:.3e} "
            f"({ratio:.3f} x limit), lse {lse_err:.2e} (limit {TOL_LSE}); "
            f"faults rejected at x limit: {faults}")
        rows.append(row)
        del q, k, v, o, lse, o32, lse32, kt, vt
    return rows


def ranks_exchange(i: int, name: str, procs, q_go, q_out, end: float
                   ) -> tuple[list, list]:
    """Tell the four ranks to run cell ``i`` and collect each rank's
    shares and numbers; a rank's failure or the deadline fails."""
    import queue

    for q in q_go:
        q.put(i)
    shares, metas = [None] * 4, [None] * 4
    while any(s is None for s in shares):
        if time.monotonic() > end or any(
                p.exitcode not in (None, 0) for p in procs.processes):
            raise SystemExit(f"ranks: cell {i} ({name}): a rank failed or "
                             "the deadline passed")
        try:
            r, j, out, meta = q_out.get(timeout=5)
        except queue.Empty:
            continue
        if j != i:
            raise SystemExit(f"ranks: rank {r} sent cell {j} at {i}")
        shares[r], metas[r] = out, meta
        del out
    return shares, metas


def static_reference(torch, lsteps, arch: str, shape: str, over, cfg,
                     grid1) -> tuple[dict, float]:
    """One of ``RANKS_STATIC_CELLS`` at 1 x 1 on the card, over the
    one-rank NCCL group's grid ``grid1``, on the global batch the 2 x 2
    ranks hold (a replica cell: its R = 2 replicas stepped in this
    process, the reference's ``vmap``; in float64 for
    ``RANKS_STATIC_F64``) -> (its outputs by path, its step's
    seconds)."""
    pd = RANKS_GRID[0]
    cell = lsteps.build_cell(arch, shape, grid1, shape_override=over,
                             config_override=cfg)
    if cell.kind in ("minibatch", "molecule"):
        params, opt = cell.make_state(0)
        seeds = lsteps.gnn_dims(cell.shape, pd)["seeds"]
        batches = lsteps.gnn_batches(cell.shape, pd, 0, "cuda")
        step = lsteps.gnn_train_step(arch, cell.config, cell.kind,
                                     seeds=seeds)
        inputs = [params, opt, batches]
    else:
        step, inputs = cell.step, list(cell.make_inputs(0))
    inputs = static_f64(torch, cell, inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lsteps.input_leaves(step(*inputs))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def static_kind(path: str) -> str:
    """The kind of an output leaf of a GNN or DIN cell: ``params``,
    ``m``, ``v``, ``master``, ``step``, ``loss`` or (a serve step's)
    ``output``."""
    if path.startswith("1."):
        return path.split(".")[1]
    return {"0": "params", "2": "loss", "": "output"}[path.split(".")[0]]


def static_worst(ratios: dict) -> dict:
    worst: dict = {}
    for path, ratio in ratios.items():
        kind = static_kind(path)
        worst[kind] = max(worst.get(kind, 0.0), ratio)
    return worst


def static_f64(torch, cell, inputs: list) -> list:
    """A cell's inputs in float64 when its arch is in ``RANKS_STATIC_F64``
    (a ``ParamTree`` converted in place; AdamW's state kept), else as
    given."""
    from repro_torch.models.gnn.common import GraphBatch

    if cell.arch_id not in RANKS_STATIC_F64:
        return inputs

    def f64(x):
        if isinstance(x, torch.nn.Module):
            return x.double()
        if isinstance(x, (list, tuple)):
            return type(x)(f64(v) for v in x)
        if isinstance(x, GraphBatch):
            return dataclasses.replace(x, **{
                f.name: f64(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if isinstance(getattr(x, f.name), torch.Tensor)})
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.double()
        return x

    return [inputs[0].double(), inputs[1]] + [f64(x) for x in inputs[2:]]


def static_compare(torch, dryrun, shd, gcell, shares: list, want: dict
                   ) -> dict:
    """Each output leaf of the 2 x 2 cell ``gcell`` gathered from the
    ranks' ``shares`` (by its ``out_specs``) against the 1 x 1 run's
    ``want``: its max |diff| within ``TOL_RANKS_STATIC`` x its max |value|
    (integers equal) -> {path: that ratio}."""
    name = f"{gcell.arch_id} x {gcell.shape_name}"
    specs = (dryrun.flat_in_specs(gcell.out_specs)
             if isinstance(gcell.out_specs[0], dict)
             else {"": gcell.out_specs})
    grid = shd.Grid(*RANKS_GRID, 0, None, None)
    ratios, bad = {}, []
    for path, w in want.items():
        g = shd.gather_tree([{"x": sh[path]} for sh in shares],
                            {"x": specs[path]}, grid)["x"]
        if tuple(g.shape) != tuple(w.shape):
            raise SystemExit(f"ranks: {name} {path} gathered "
                             f"{tuple(g.shape)}, 1 x 1 {tuple(w.shape)}")
        if not w.is_floating_point():
            if not torch.equal(g, w):
                raise SystemExit(f"ranks: {name} {path} differs from 1 x 1")
            continue
        ratios[path] = rel_diff(g, w)
        if not ratios[path] <= TOL_RANKS_STATIC:
            bad.append(f"{path} at {ratios[path]:.3e}")
        del g
    if bad:
        raise SystemExit(f"ranks: {name} against 1 x 1, over "
                         f"{TOL_RANKS_STATIC} of each leaf's max: "
                         + "; ".join(bad))
    return ratios


def ranks_static(torch, lsteps, dryrun, shd, procs, q_go, q_out,
                 end: float, total: int) -> list[dict]:
    """The GNN and DIN cells over the 2 x 2 ranks (``RANKS_STATIC_CELLS``):
    each first at 1 x 1 over the one-rank NCCL group (P = 1; DIN's serve
    step also built for no grid, bit for bit), then on the ranks (both in
    float64 for ``RANKS_STATIC_F64``), each output leaf gathered and held
    within ``TOL_RANKS_STATIC`` x its max at 1 x 1 (integers equal); no
    kernel launches on these paths.  Prints each rank's peak beside the
    per-rank reckoning, the step's seconds and the collective bytes."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh

    opened = not dist.is_initialized()
    grid1 = lmesh.join_one_rank("cuda")
    chunk, lsteps.RETRIEVAL_CHUNK = lsteps.RETRIEVAL_CHUNK, \
        RANKS_RETRIEVAL_CHUNK
    try:
        return [static_cell(torch, lsteps, dryrun, shd, procs, q_go, q_out,
                            end, total, grid1, len(RANKS_CELLS) + j, *cell)
                for j, cell in enumerate(RANKS_STATIC_CELLS)]
    finally:
        lsteps.RETRIEVAL_CHUNK = chunk
        if opened:
            dist.destroy_process_group()


def static_cell(torch, lsteps, dryrun, shd, procs, q_go, q_out, end: float,
                total: int, grid1, i: int, arch: str, shape: str, over,
                cfg) -> dict:
    """One of ``RANKS_STATIC_CELLS`` (cell ``i`` of the ranks): 1 x 1, the
    ranks, the comparison and the numbers (``ranks_static``)."""
    t0 = time.perf_counter()
    want, ref_step_s = static_reference(torch, lsteps, arch, shape, over,
                                        cfg, grid1)
    p1_equal = None
    if (arch, shape) == ("din", "serve_p99"):
        # deterministic (gathers and GEMMs; a GNN step's index_add
        # atomics are not): the grid code at P = 1 is the one-rank path
        plain = lsteps.build_cell(arch, shape, None, shape_override=over,
                                  config_override=cfg)
        again = lsteps.input_leaves(plain.step(*plain.make_inputs(0)))
        p1_equal = all(torch.equal(again[k], w) for k, w in want.items())
        if not p1_equal:
            raise SystemExit(f"ranks: {arch} x {shape} over the one-rank "
                             "NCCL grid differs from the one-rank path")
        del plain, again
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    shares, metas = ranks_exchange(i, f"{arch} {shape}", procs, q_go,
                                   q_out, end)
    grid = shd.Grid(*RANKS_GRID, 0, None, None)
    gcell = lsteps.build_cell(arch, shape, grid, shape_override=over,
                              config_override=cfg)
    worst = static_worst(static_compare(torch, dryrun, shd, gcell, shares,
                                        want))
    del shares, want
    for q in q_go:
        q.put(("done", i))
    gc.collect()
    torch.cuda.empty_cache()
    for m in metas:
        if any(m["launches"].values()):
            raise SystemExit(f"ranks: {arch} x {shape} launched "
                             f"{m['launches']}; its path has no kernel")
    rec = dryrun.reckon(gcell, total, grid)
    # the reckoning is f32's: a float64 step holds about twice its bytes
    scale = 2 if arch in RANKS_STATIC_F64 else 1
    moved: dict = {}
    for m in metas:
        for k, v in m["collective_bytes"].items():
            moved[k] = moved.get(k, 0) + v
    run = {"arch": arch, "shape": shape, "override": over,
           "config_override": cfg,
           "dtype": "float64" if scale == 2 else "float32",
           "ratios_by_kind": worst, "p1_bit_equal": p1_equal,
           "ranks": metas, "reckoned_bytes": scale * (rec["need_bytes"]
                                                      - rec["reserve_bytes"]),
           "reckoned_arg_bytes": scale * rec["arg_bytes"],
           "reference_step_s": ref_step_s, "reference_s": ref_s,
           "collective_bytes": moved,
           "cell_s": time.perf_counter() - t0}
    log(f"[ranks] {arch} x {shape} ({over or 'registry shape'}"
        + (f", {cfg}" if cfg else "") + ", "
        f"{run['dtype']}) on 2 x 2 gloo ranks of cuda:0 against 1 x 1 (P = 1"
        " over NCCL"
        + (f", = the no-grid path bit for bit: {p1_equal}"
           if p1_equal is not None else "")
        + "): max |diff| over each leaf's max by kind "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (limit {TOL_RANKS_STATIC}); peaks a rank (the inputs' draw "
        f"included) "
        f"{', '.join(f'{m['peak_bytes'] / 1e9:.3f}' for m in metas)}"
        f" GB, the step's "
        f"{', '.join(f'{m['step_peak_bytes'] / 1e9:.3f}' for m in metas)}"
        f" GB against the reckoned {run['reckoned_bytes'] / 1e9:.3f}"
        + (" (twice f32's)" if scale == 2 else "")
        + f" (arguments {run['reckoned_arg_bytes'] / 1e9:.3f}); step "
        f"{', '.join(f'{m['step_s']:.2f}' for m in metas)} s (1 x 1 "
        f"{ref_step_s:.2f} s); collective bytes, all ranks: "
        + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in
                    sorted(moved.items()))
        + f"; cell {run['cell_s']:.1f} s")
    return run


def ranks_path(torch, kernels, card: str, timer) -> dict:
    """The ranks group: the LM cells over ranks on the one card.

    A 2 x 2 grid of gloo ranks sharing cuda:0 (``_ranks_rank``) runs each
    of ``RANKS_CELLS`` at full width -- Yi-6B's train step (tensor and
    data parallel, ZeRO state), prefill, decode on the head-split cache
    and long_500k's decode on the cache split over all four ranks;
    OLMoE-1B-7B's train step and decode with its 64 experts split 32 + 32
    -- each from its share of ``make_inputs(0)``.  This process runs the
    same cell at 1 x 1 first, in bf16 and on the same values cast to fp32,
    then gathers the ranks' outputs leaf by leaf (handed over as CUDA
    tensors) and holds each within twice the bf16-vs-fp32 difference of
    its kind.  The ranks' launches (counted in each rank, zeroed just
    before its cell's step(s)) are the group's; ``flash_decode``'s
    log-sum-exp output is checked and timed (``lse_checks``); each rank's
    bytes and peak are printed beside ``launch.dryrun``'s per-rank
    reckoning, then ``launch.dryrun --grid 2x2`` over the 20 LM cells."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as lsteps

    gc.collect()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    lse_rows = lse_checks(torch, timer)
    ctx = mp.get_context("spawn")
    q_out = ctx.Queue()
    q_go = [ctx.Queue() for _ in range(4)]
    store = tempfile.mktemp(prefix="ranks_store_")
    t_all = time.perf_counter()
    procs = mp.start_processes(
        _ranks_rank, args=(str(SRC), store, q_out, q_go), nprocs=4,
        join=False, start_method="spawn")
    end = time.monotonic() + RANKS_DEADLINE_S
    runs, launches = [], {k.name: 0 for k in kernels}
    try:
        for i, (arch, shape, over, layers) in enumerate(RANKS_CELLS):
            t0 = time.perf_counter()
            one = ranks_cell(lsteps, arch, shape, over, layers, None)
            inputs = ranks_inputs(one)
            got32 = ranks_fp32(torch, lsteps, arch, shape, over, layers,
                               inputs)
            want = ranks_run(one, inputs)
            floor = ranks_floor(want, got32)
            del inputs, got32
            gc.collect()
            torch.cuda.empty_cache()
            ref_s = time.perf_counter() - t0
            shares, metas = ranks_exchange(i, f"{arch} {shape}", procs,
                                           q_go, q_out, end)
            grid_cell = ranks_cell(lsteps, arch, shape, over, layers,
                                   shd.Grid(*RANKS_GRID, 0, None, None))
            ratios = ranks_compare(torch, shd, ranks_specs(grid_cell),
                                   shares, want, floor)
            del shares, want
            for q in q_go:
                q.put(("done", i))
            gc.collect()
            torch.cuda.empty_cache()
            rec = dryrun.reckon(grid_cell, total, grid_cell.layout.grid)
            for m in metas:
                for k, v in m["launches"].items():
                    launches[k] += v
            worst = {}
            for path, ratio in ratios.items():
                kind = ranks_kind(path)
                worst[kind] = max(worst.get(kind, 0.0), ratio)
            run = {"arch": arch, "shape": shape, "override": over,
                   "layers": layers, "ratios_by_kind": worst,
                   "floor_by_kind": floor, "ranks": metas,
                   "reckoned_bytes": rec["need_bytes"]
                   - rec["reserve_bytes"],
                   "reckoned_arg_bytes": rec["arg_bytes"],
                   "reference_s": ref_s,
                   "cell_s": time.perf_counter() - t0}
            log(f"[ranks] {arch} x {shape} ({layers} layers, "
                f"{over or 'registry shape'}) on 2 x 2 gloo ranks of cuda:0 "
                f"against 1 x 1: " + ", ".join(
                    f"{k} {worst.get(k, 0.0):.2e} (bf16 vs fp32 "
                    f"{floor[k]:.2e})" for k in floor)
                + f"; ranks' inputs "
                f"{', '.join(f'{m['input_bytes'] / 1e9:.3f}' for m in metas)}"
                f" GB, peaks (the inputs' draw included) "
                f"{', '.join(f'{m['peak_bytes'] / 1e9:.3f}' for m in metas)}"
                f" GB, the step(s)' "
                f"{', '.join(f'{m['step_peak_bytes'] / 1e9:.3f}' for m in metas)}"
                f" GB against the reckoned {run['reckoned_bytes'] / 1e9:.3f}"
                f" (arguments {rec['arg_bytes'] / 1e9:.3f}); step(s) "
                f"{', '.join(f'{m['step_s']:.2f}' for m in metas)} s; "
                f"flash_decode launches "
                f"{[m['launches']['flash_decode'] for m in metas]}; "
                f"1 x 1 bf16 + fp32 {ref_s:.1f} s, cell {run['cell_s']:.1f}"
                " s")
            runs.append(run)
        static_runs = ranks_static(torch, lsteps, dryrun, shd, procs, q_go,
                                   q_out, end, total)
        join_ranks(procs, "ranks", end)
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t_all
    want_fd = sum(4 * layers * RANKS_DECODE_STEPS
                  for arch, shape, _, layers in RANKS_CELLS
                  if shape in ("decode_32k", "long_500k"))
    check_launches("ranks", launches, {"segment_spmm": 0, "banded_ttm": 0,
                                       "banded_ttm_t": 0,
                                       "flash_decode": want_fd})
    log(f"[ranks] launch.dryrun --grid 2x2 over the LM cells ({card}, "
        f"capacity {total:,} B):")
    grid_recs = dryrun.grid_run(
        [c for c in lsteps.all_cells()
         if c[0] in ("yi-6b", "gemma-7b", "minicpm-2b", "olmoe-1b-7b",
                     "moonshot-v1-16b-a3b")], *RANKS_GRID, total, "cuda",
        log=lambda m: log(f"[ranks]   {m}"))
    smallest = {f"{r['one_card']['arch']} x {r['one_card']['shape']}":
                (r["smallest"]["grid"], r["smallest"]["need_bytes"])
                for r in grid_recs if r.get("smallest")}
    log(f"[ranks] launch.dryrun --grid 2x2 over the GNN, DIN and dyngnn "
        f"cells ({card}, capacity {total:,} B):")
    static_grids = dryrun.grid_run(
        [c for c in lsteps.all_cells()
         if c[0] not in ("yi-6b", "gemma-7b", "minicpm-2b", "olmoe-1b-7b",
                         "moonshot-v1-16b-a3b")], *RANKS_GRID, total, "cuda",
        log=lambda m: log(f"[ranks]   {m}"))
    smallest.update({
        f"{r['one_card']['arch']} x {r['one_card']['shape']}":
        r["smallest"] and (r["smallest"]["grid"],
                           r["smallest"]["need_bytes"])
        for r in static_grids if "smallest" in r})
    return {"runs": runs, "static_runs": static_runs, "lse_rows": lse_rows,
            "launches": launches, "ranks_s": ranks_s,
            "smallest_grids": smallest}




def recsys_path(torch, kernels) -> dict:
    """The recsys group: DIN at its full config trained, served and
    scoring retrieval candidates on the card, then held to the CPU."""
    from repro_torch.configs import registry

    cfg = registry.get_arch("din").make_config()
    train, params = recsys_train(torch, kernels, cfg)
    serve = recsys_serve(torch, kernels, cfg, params)
    retrieval = recsys_retrieval(torch, kernels, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k.name: train["launches"][k.name]
                + serve["launches"][k.name] + retrieval["launches"][k.name]
                for k in kernels}
    return {"config": dataclasses.asdict(cfg), "train": train,
            "serve": serve, "retrieval": retrieval, "launches": launches}


# ------------------------------------------------------------- examples ----

#: the twins of ``examples/*.py`` under ``examples/torch/``, in run order
EXAMPLES = ("quickstart", "serve_dyngnn", "serve_lm", "partition_compare",
            "train_dyngnn_distributed")
#: the kernels each twin's path launches on the card ("segment_spmm_bwd":
#: segment_spmm launched by ``SegmentSpmmFn.backward`` on the transposed
#: CSR); partition_compare computes a loss, no gradient
_TRAINED = ("segment_spmm", "segment_spmm_bwd", "banded_ttm", "banded_ttm_t")
EXAMPLE_KERNELS = {"quickstart": _TRAINED, "serve_dyngnn": _TRAINED,
                   "serve_lm": ("flash_decode",),
                   "partition_compare": ("segment_spmm", "banded_ttm"),
                   "train_dyngnn_distributed": _TRAINED}
EXAMPLES_PARITY_STEPS = 20   # of train_dyngnn_distributed's 300: card vs CPU
TOL_EXAMPLES = 1e-4          # PERF.md §2: card vs CPU
EXAMPLE_LINES = (r"graph-difference transfer: [\d,]+ bytes vs naive [\d,]+ "
                 r"\([\d.]+x less\)$", r"loss: \d\.\d{4} -> \d\.\d{4}$",
                 r"link-prediction accuracy: \d\.\d{3}$")


def load_example(name: str):
    """``examples/torch/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class BackwardLaunches:
    """Counts the ``segment_spmm`` launches ``SegmentSpmmFn.backward``
    makes while entered (the kernel's own count holds both directions)."""

    def __enter__(self):
        from repro_torch.kernels.segment_spmm import ops as spmm_ops

        self.ops, self.n = spmm_ops, 0
        self.orig = spmm_ops.SegmentSpmmFn.backward

        def backward(ctx, dy):
            n0 = spmm_ops.KERNEL.launches
            out = self.orig(ctx, dy)
            self.n += spmm_ops.KERNEL.launches - n0
            return out

        spmm_ops.SegmentSpmmFn.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        self.ops.SegmentSpmmFn.backward = staticmethod(self.orig)


def example_on_card(torch, kernels, name: str, fn, needed=None):
    """``fn()`` with every kernel count zeroed just before and read just
    after -> (its result, {kernel: launches}, seconds); fails when a
    kernel of the path (``needed``, else the twin's ``EXAMPLE_KERNELS``)
    did not launch."""
    from repro_torch.kernels.build import reset_counts

    reset_counts(kernels)
    t0 = time.perf_counter()
    with BackwardLaunches() as bwd:
        out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    counts["segment_spmm_bwd"] = bwd.n
    if needed is None:
        needed = EXAMPLE_KERNELS[name]
    missing = [k for k in needed if counts[k] < 1]
    if missing:
        raise SystemExit(f"examples: {name} on the card launched no "
                         f"{', '.join(missing)} ({counts})")
    return out, counts, secs


def rel_worst(name: str, got, want, tol: float) -> float:
    """Max |got - want| / |want| over two loss streams; fails past tol."""
    worst = worst_rel(list(got), list(want))
    if not worst <= tol:
        raise SystemExit(f"examples: {name} card vs CPU {worst:.3e} "
                         f"relative (limit {tol})")
    return worst


def leaf_worst(name: str, got: dict, want: dict, tol: float) -> float:
    """Max over ``want``'s leaves of max |got - want| / max |want| (numpy
    leaves); fails past tol."""
    import torch

    worst = max(rel_diff(torch.as_tensor(got[k]), torch.as_tensor(v))
                for k, v in want.items())
    if not worst <= tol:
        raise SystemExit(f"examples: {name} card vs CPU {worst:.3e} x the "
                         f"leaf's max (limit {tol})")
    return worst


def same(name: str, got, want) -> None:
    """Fails unless the card's value equals the CPU's."""
    if got != want:
        raise SystemExit(f"examples: {name}: card {got!r}, CPU {want!r}")


class QuickstartScript:
    """``python examples/torch/quickstart.py`` as a user runs it, on the
    card (its default device), started now; a thread collects its output
    and its wall seconds.  It runs on one CPU thread beside this
    process's twins (on the CPU here, two pools of intra-op threads on the
    host's cores slowed both ~20x)."""

    def __init__(self):
        import threading

        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable,
             str(ROOT / "examples" / "torch" / "quickstart.py")],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC),
                               OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out = self.err = ""
        self.seconds = None

        def collect():
            self.out, self.err = self.proc.communicate()
            self.seconds = time.perf_counter() - t0

        self.thread = threading.Thread(target=collect, daemon=True)
        self.thread.start()

    def check(self) -> dict:
        """Waits for it; fails unless it exited 0 and printed each of the
        example's three lines once."""
        import re

        self.thread.join(timeout=300)
        lines = self.out.splitlines()
        if self.proc.returncode != 0 or not all(
                sum(1 for ln in lines if re.match(p, ln)) == 1
                for p in EXAMPLE_LINES):
            raise SystemExit(f"examples: python examples/torch/quickstart.py"
                             f" exited {self.proc.returncode}:\n"
                             f"{self.out[-2000:]}\n{self.err[-2000:]}")
        return {"returncode": self.proc.returncode, "lines": lines[-3:],
                "seconds": self.seconds}

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.thread.join(timeout=60)


def example_runs(torch, mod, name: str, group, gloo, echo):
    """-> (the twin's run on the card at its default sizes, a thunk of its
    CPU run, a thunk of the card run its CPU run is held to, or None for
    the default run itself).  The rank twins take ``group`` (the one-rank
    NCCL group) on the card and ``gloo`` on the CPU; serve_lm's parameters
    are drawn once on the host for both; train_dyngnn_distributed is held
    to the CPU at ``EXAMPLES_PARITY_STEPS``."""
    def quiet(_msg):
        return None

    if name == "serve_lm":
        from repro_torch.configs import registry
        from repro_torch.models import lm

        params = lm.init_lm_params(
            torch.Generator().manual_seed(0),
            registry.get_arch("yi-6b").make_smoke_config())
        return (lambda: mod.run(device="cuda", params=params, echo=echo),
                lambda: mod.run(device="cpu", params=params, echo=quiet),
                None)
    if name == "partition_compare":
        return (lambda: mod.run("cuda", echo=echo),
                lambda: dict(zip(("loss_sp", "loss_ref"),
                                 mod.losses(gloo, torch.device("cpu")))),
                None)
    if name == "train_dyngnn_distributed":
        return (lambda: mod.run(device="cuda", echo=echo),
                lambda: mod.train(gloo, EXAMPLES_PARITY_STEPS, "cpu",
                                  echo=quiet),
                lambda: mod.train(group, EXAMPLES_PARITY_STEPS, "cuda",
                                  echo=quiet))
    return (lambda: mod.run(device="cuda", echo=echo),
            lambda: mod.run(device="cpu", echo=quiet), None)


def example_compare(name: str, card: dict, ref: dict) -> dict:
    """The twin ``name``'s card run against its CPU run, at
    ``TOL_EXAMPLES`` -> the worst distance of each kind; fails past it."""
    from repro_torch import convert

    worst = {}
    for k in ("losses", "stream_losses"):
        if k in ref:
            worst[f"{k}_rel"] = rel_worst(f"{name} {k}", card[k], ref[k],
                                          TOL_EXAMPLES)
    if "loss_sp" in ref:
        worst["losses_rel"] = rel_worst(
            name, [card["loss_sp"], card["loss_ref"]],
            [ref["loss_sp"], ref["loss_ref"]], TOL_EXAMPLES)
    for k in ("params", "stream_params"):
        if k in ref:
            worst[k] = leaf_worst(f"{name} {k}",
                                  convert.params_to_numpy(card[k]),
                                  convert.params_to_numpy(ref[k]),
                                  TOL_EXAMPLES)
    if "node_scores" in ref:
        worst["scores"] = leaf_worst(
            name, {k: card[k] for k in ("node_scores", "link_scores")},
            {k: ref[k] for k in ("node_scores", "link_scores")},
            TOL_EXAMPLES)
    if "tokens" in ref:
        same(f"{name} tokens", card["tokens"].tolist(),
             ref["tokens"].tolist())
    for k in ("graph_diff", "naive", "accuracy", "ratio", "steps", "rounds",
              "events", "windows", "resyncs", "queries", "query_batches",
              "tokens_generated"):
        if k in ref:
            same(f"{name} {k}", card[k], ref[k])
    return worst


#: what the group reports of each twin's card run at its default sizes
EXAMPLE_NUMBERS = ("p", "steps", "rounds", "accuracy", "graph_diff",
                   "naive", "events", "windows", "resyncs", "queries",
                   "tokens_generated", "loss_sp", "loss_ref", "identical",
                   "volume")


def example_numbers(card: dict) -> dict:
    """``EXAMPLE_NUMBERS`` of a twin's card run, JSON-ready."""
    out = {k: card[k] for k in EXAMPLE_NUMBERS if k in card}
    for k in ("losses", "stream_losses"):
        if k in card:
            out[f"{k}_first_last"] = [card[k][0], card[k][-1]]
    if "tokens" in card:
        out["tokens_shape"] = list(card["tokens"].shape)
        out["request0"] = card["tokens"][0][:12].tolist()
    return {k: float(v) if hasattr(v, "dtype") else v
            for k, v in out.items()}


def examples_path(torch, kernels, group) -> dict:
    """The examples group: the quickstart script started on the card as
    a subprocess (a fresh process takes ~25 s to its last line, most of
    it start-up, hidden behind the rest), each twin of ``EXAMPLES`` on the
    card at its default sizes (the rank twins over ``group``, the
    one-rank NCCL group) with its kernels' launches, then each twin on
    the CPU (the rank twins over a one-rank gloo group), held to its card
    run."""
    import torch.distributed as dist

    gloo = dist.new_group(backend="gloo")
    script = QuickstartScript()
    runs, launches, cpu_runs = {}, {}, {}
    try:
        for name in EXAMPLES:
            mod = load_example(name)

            def echo(msg, name=name):
                for line in msg.splitlines():
                    log(f"[examples] {name}: {line}")

            on_card, on_cpu, parity = example_runs(torch, mod, name, group,
                                                   gloo, echo)
            card, n, secs = example_on_card(torch, kernels, name, on_card)
            rec = {"card_s": secs, "launches": n, **example_numbers(card)}
            if name == "partition_compare" and not card["identical"]:
                raise SystemExit("examples: partition_compare: the "
                                 "partitioned loss differs from the "
                                 "one-device loss on the card")
            if parity is not None:
                t0 = time.perf_counter()
                card = parity()
                rec["parity_steps"] = EXAMPLES_PARITY_STEPS
                rec["parity_card_s"] = time.perf_counter() - t0
            cpu_runs[name] = (card, on_cpu)
            runs[name] = rec
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
        for name, (card, on_cpu) in cpu_runs.items():
            t0 = time.perf_counter()
            ref = on_cpu()
            rec = runs[name]
            rec["cpu_s"] = time.perf_counter() - t0
            rec["card_vs_cpu"] = example_compare(name, card, ref)
            log(f"[examples] {name}: {rec['card_s']:.1f} s on the card, "
                f"{rec['cpu_s']:.1f} s on the CPU; launches "
                + ", ".join(f"{k} {v}" for k, v in rec["launches"].items()
                            if v)
                + "; card vs CPU "
                + (", ".join(f"{k} {v:.2e}"
                             for k, v in rec["card_vs_cpu"].items())
                   or "equal"))
        cpu_runs.clear()
        gc.collect()
        t0 = time.perf_counter()
        runs["quickstart_script"] = script.check()
        log(f"[examples] python examples/torch/quickstart.py on the card: "
            f"exit 0 in {runs['quickstart_script']['seconds']:.1f} s, its "
            f"lines {runs['quickstart_script']['lines']} (waited "
            f"{time.perf_counter() - t0:.1f} s after the CPU runs)")
    finally:
        script.stop()
        dist.destroy_process_group(gloo)
    return {"runs": runs, "launches": launches}


# ----------------------------------------------------------------- docs ----

#: the kernels the twin docs' fences launch on the card: their dyngnn
#: runs train (``_TRAINED``), and no fence serves an LM
DOCS_KERNELS = _TRAINED
#: the card's fence values against the CPU's, every kind relative
DOCS_TOLS = {"loss": TOL_EXAMPLES, "score": TOL_EXAMPLES,
             "int8": TOL_EXAMPLES}
DOCS_CPU_THREADS = "2"      # the CPU run's threads, beside the card run


def load_docs_checker():
    """``tools/torch/check_docs.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_check_docs", ROOT / "tools" / "torch" / "check_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def docs_worst(tool, card: dict, cpu: dict) -> dict:
    """The largest relative distance of each inexact kind, card vs CPU."""
    import numpy as np

    worst: dict = {}
    for doc, fences in cpu.items():
        for i, vals in enumerate(fences):
            for expr, want in (vals or {}).items():
                kind = tool.FENCE_VALUES[doc][i][expr]
                if kind == "exact":
                    continue
                a = np.asarray(card[doc][i][expr], dtype=np.float64)
                b = np.asarray(want, dtype=np.float64)
                scale = (np.abs(b) if kind != "score"
                         else np.abs(b).max()) + 1e-30
                worst[kind] = max(worst.get(kind, 0.0),
                                  float(np.max(np.abs(a - b) / scale)))
    return worst


class DocsCpuRun:
    """``tools/torch/check_docs.py --device cpu --no-links --values``
    started as a subprocess (the checker's fences as a user runs them, on
    the host; the link check reads files, not the card, and
    ``tests/test_torch_docs.py`` holds it, so a checkout that leaves out
    a linked file does not fail here).  The script starts it before the
    examples group, so that it runs beside that group's card runs, and
    the docs group reads it."""

    def __init__(self):
        import tempfile

        self.dir = Path(tempfile.mkdtemp(prefix="chip_smoke_docs_"))
        self.out = self.dir / "cpu.json"
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "tools" / "torch" / "check_docs.py"),
             "--device", "cpu", "--no-links", "--values", str(self.out)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC),
                               TMPDIR=str(self.dir),
                               OMP_NUM_THREADS=DOCS_CPU_THREADS),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(self) -> tuple[dict, float, float]:
        """-> (each fence's values on the CPU, the run's seconds, the
        seconds waited for it here); raises if the checker failed."""
        t1 = time.perf_counter()
        try:
            stdout, stderr = self.proc.communicate(timeout=600)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.communicate()
        waited = time.perf_counter() - t1
        if self.proc.returncode != 0 or not self.out.exists():
            raise SystemExit(f"docs: tools/torch/check_docs.py --device cpu "
                             f"--no-links exited {self.proc.returncode}:\n"
                             f"{stdout[-2000:]}\n{stderr[-2000:]}")
        return (json.loads(self.out.read_text()),
                time.perf_counter() - self.t0, waited)

    def close(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        shutil.rmtree(self.dir, ignore_errors=True)


def docs_path(torch, kernels, cpu_run: DocsCpuRun) -> dict:
    """The docs group: every fence of the five twins under
    ``docs/torch/`` through the docs checker in this process on the card
    (the one-rank NCCL group open, as a lone process's: run_api.md's
    fences guarded by a group of 4 skip, compression.md's 4-rank fence is
    passed by) with every kernel launch counted, and each fence's values
    on the card held to those of ``cpu_run``, the same checker's run on
    the host."""
    import tempfile

    tool = load_docs_checker()
    seconds: dict = {}

    def run_docs():
        values = {}
        for name in tool.EXAMPLE_DOCS:
            t1 = time.perf_counter()
            values[name] = tool.run_examples(
                tool.DOCS / name, "cuda", echo=lambda m: log(f"[docs] {m}"))
            seconds[name] = time.perf_counter() - t1
        return values

    try:
        saved, tempfile.tempdir = tempfile.tempdir, str(cpu_run.dir)
        try:
            card, launches, card_s = example_on_card(
                torch, kernels, "docs", run_docs, DOCS_KERNELS)
        finally:
            tempfile.tempdir = saved
        cpu, cpu_s, waited = cpu_run.result()
    finally:
        cpu_run.close()
    card = json.loads(json.dumps(card))        # the CPU's JSON types
    problems = tool.compare_values(card, cpu, DOCS_TOLS)
    if problems:
        raise SystemExit("docs: card vs CPU:\n" + "\n".join(problems[:20]))
    guarded = [f"{doc} block {i + 1}" for doc, fs in card.items()
               for i, v in enumerate(fs) if v == {}]
    cpu_only = [f"{doc} block {i + 1}" for doc, fs in card.items()
                for i, v in enumerate(fs) if v is None]
    worst = docs_worst(tool, card, cpu)
    n_fences = sum(len(fs) for fs in card.values())
    log(f"[docs] {n_fences} fences: {n_fences - len(cpu_only)} run on the "
        f"card in {card_s:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + "); launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                     if v))
    log(f"[docs] skipped by their guard at 1 rank, as in a lone process "
        f"(4 gloo ranks run them in tests/test_torch_docs_ranks.py): "
        f"{', '.join(guarded)}")
    log(f"[docs] run on the CPU only (it needs 4 ranks, one card here; 4 "
        f"gloo ranks in tests/test_torch_docs_ranks.py): "
        f"{', '.join(cpu_only)}")
    log(f"[docs] tools/torch/check_docs.py --device cpu --no-links: exit 0 "
        f"in {cpu_s:.1f} s ({DOCS_CPU_THREADS} threads, started before the "
        f"examples and docs groups, beside their card runs; waited {waited:.1f} s "
        f"after the card run); card vs CPU: every exact value "
        "equal, worst relative " + (", ".join(f"{k} {v:.2e}" for k, v in
                                              worst.items()) or "-")
        + f" (limit {TOL_EXAMPLES})")
    return {"launches": launches, "card_s": card_s, "doc_s": seconds,
            "cpu_s": cpu_s, "cpu_wait_s": waited, "fences": n_fences,
            "guarded": guarded, "cpu_only": cpu_only,
            "card_vs_cpu": worst}


# ---------------------------------------------------------------- main -----

GROUPS = ("serve", "train", "stream", "partition", "dstream", "hybrid",
          "sampled", "ft", "trace", "data", "lm", "moe", "gnn", "recsys",
          "cells", "ranks", "examples", "docs")


def kernel_entry(name: str, source: str, replaces: str, launches: dict,
                 row: dict, **extra) -> dict:
    """One kernel's line of the report: its launches on each path driven
    (and their sum), and the main shape's numbers from ``row``."""
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "launches": sum(v.get(name, 0) for v in launches.values()),
             "launches_by_path": {p: v.get(name, 0)
                                  for p, v in launches.items()}}
    for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        entry[key] = row[key]
    entry.update(extra)
    return entry


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    groups = GROUPS
    if argv[:1] == ["--only"] and len(argv) == 2:
        groups = tuple(argv[1].split(","))
    if argv and (groups == GROUPS or not set(groups) <= set(GROUPS)
                 or ({"partition", "data"} & set(groups)
                     and "train" not in groups)):
        print(f"usage: chip_smoke.py [--only {','.join(GROUPS)}] "
              "(partition and data are held to train's run: name train "
              "too)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout (no "
              "src/repro_torch here)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    adopt_orphans()
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels as kmod
    from repro_torch import obs
    from repro_torch.configs.paper_dyngnn import DATASETS
    from repro_torch.kernels.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    kernels = list(kmod.ALL)
    t0 = time.perf_counter()
    logs = build_all(kernels)
    log(f"[build] {len(kernels)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s (device "
            f"memory after it: {torch.cuda.memory_allocated() / 1e9:.3f} "
            f"GB allocated, {torch.cuda.memory_reserved() / 1e9:.3f} "
            "reserved)")
        return out

    n_nodes, _, max_edges = DATASETS["epinions"]
    # the train group's trace is made on the host beside the serve group
    train_job = TrainTraceJob(n_nodes, 5) if "train" in groups else None
    timer = Timer(torch)
    launches, report = {}, []
    if "serve" in groups:
        eng, events, launches["serve"], replay = phase(
            "main path", main_path, torch, kernels, obs, n_nodes, max_edges)
        spmm_rows, spmm_err, skew_err, skew_rows = phase(
            "segment_spmm check", check_spmm, torch, eng, timer)
        ttm = phase("banded_ttm check", check_ttm, torch, n_nodes,
                    eng.model.window, timer)
        step_prof = phase("profile", profile_step, torch, eng)
        phase("plain-path parity", plain_parity, eng, events, replay)
        phase("small-graph parity", small_parity, torch)
        # the engine sits in a reference cycle: collect it now, or its
        # device state stays allocated under the train phase's peak
        del eng, events, replay
        gc.collect()
        torch.cuda.empty_cache()
    train_ds = stream_pipe = None
    if "train" in groups:
        batch, train_stats, train_ds, stream_pipe, train_raw = phase(
            "train path", train_path, torch, kernels, obs, n_nodes,
            train_job)
        launches["train"] = train_stats["launches"]
        spmm_bwd, ttm_train_rows, ttm_t_rows, ttm_sweep, ttm_t_sweep = \
            phase("train-shape kernel checks", check_backward, torch, batch,
                  n_nodes, 5, timer)
        # the pipeline goes on to the streamed phases; its padded batch
        # (2.5 GB with its CSR pairs) would sit under their peaks
        del batch
        stream_pipe._batch = None
        gc.collect()
        torch.cuda.empty_cache()
        train_par = phase("train parity", train_parity, torch)
    if "stream" in groups:
        if train_ds is None:
            t0 = time.perf_counter()
            train_ds = train_trace(n_nodes, 5).build()
            log(f"[stream] trace made on the host in "
                f"{time.perf_counter() - t0:.1f} s (no train phase)")
        stream_stats, stream_pipe = phase("stream path", stream_path, torch,
                                          kernels, obs, train_ds,
                                          stream_pipe)
        launches["stream"] = stream_stats["launches"]
        stream_checks = phase("stream-shape kernel checks",
                              stream_kernel_checks, torch, stream_pipe, 5,
                              timer)
        gc.collect()
        torch.cuda.empty_cache()
        stream_stats["parity"] = phase("stream parity", stream_parity,
                                       torch)
        stream_stats.update(stream_checks)
    if {"partition", "dstream", "hybrid", "sampled", "ft", "trace",
            "examples", "docs"} & set(groups):
        import torch.distributed as dist
        group = nccl_group(torch)
        try:
            if "partition" in groups:
                part_stats = phase("partition path", partition_path, torch,
                                   kernels, obs, train_ds, stream_pipe,
                                   group, train_stats, timer)
                launches["partition"] = part_stats["launches"]
                part_fwd, part_bwd = phase("partition-shape kernel checks",
                                           partition_band_checks, torch,
                                           n_nodes, 5, timer)
                part_stats["band_rows"] = part_fwd
                part_stats["band_t_rows"] = part_bwd
            if "dstream" in groups:
                if train_ds is None:
                    t0 = time.perf_counter()
                    train_ds = train_trace(n_nodes, 5).build()
                    log(f"[dstream] trace made on the host in "
                        f"{time.perf_counter() - t0:.1f} s (no train "
                        "phase)")
                dstream_stats = phase("dstream path", dstream_path, torch,
                                      kernels, obs, train_ds, stream_pipe,
                                      group, timer)
                launches["dstream"] = dstream_stats["launches"]
            if {"hybrid", "sampled", "ft", "trace"} & set(groups) \
                    and train_ds is None:
                t0 = time.perf_counter()
                train_ds = train_trace(n_nodes, 5).build()
                log(f"[hybrid/sampled] trace made on the host in "
                    f"{time.perf_counter() - t0:.1f} s (no train phase)")
            if "hybrid" in groups:
                hybrid_stats = phase("hybrid path", hybrid_path, torch,
                                     kernels, train_ds, group, timer)
                launches["hybrid"] = hybrid_stats["launches"]
            if "sampled" in groups:
                sampled_stats = phase("sampled path", sampled_path, torch,
                                      kernels, obs, train_ds, group)
                launches["sampled"] = sampled_stats["launches"]
                sampled_stats["equivalence"] = phase(
                    "sampled equivalence", sampled_equivalence, torch,
                    group)
            if "ft" in groups:
                gc.collect()
                torch.cuda.empty_cache()
                if stream_pipe is None:
                    from repro_torch.data.dyngnn import DTDGPipeline
                    t0 = time.perf_counter()
                    stream_pipe = DTDGPipeline(train_ds, nb=TRAIN_NB,
                                               device="cuda")
                    log(f"[ft] pipeline {time.perf_counter() - t0:.1f} s on "
                        "the host (no stream phase)")
                ft_stats = {"eager": phase(
                    "ft eager", ft_eager, torch, kernels, obs, train_ds,
                    stream_pipe, train_stats["losses"]
                    if "train" in groups else None)}
                ft_stats["stream"] = phase("ft stream", ft_stream, torch,
                                           kernels, obs, train_ds,
                                           stream_pipe, group)
                launches["ft"] = {
                    k: ft_stats["eager"]["launches"].get(k, 0)
                    + ft_stats["stream"]["launches"].get(k, 0)
                    for k in ft_stats["eager"]["launches"]}
            shared = {"partition", "dstream", "hybrid", "sampled",
                      "ft"} & set(groups)
            if shared:
                # the shared-card ranks, this process's references and the
                # ft launcher's two runs (each a subprocess) side by side
                from concurrent.futures import ThreadPoolExecutor
                gc.collect()
                torch.cuda.empty_cache()
                with ThreadPoolExecutor(1) as pool:
                    launcher = (pool.submit(ft_launcher_runs)
                                if "ft" in groups else None)
                    t0 = time.perf_counter()
                    shared_stats = phase("shared card", shared_card, torch,
                                         group, groups)
                    if launcher is not None:
                        ft_stats["launcher"] = ft_launcher(
                            torch, launcher.result())
                        log(f"[phase] shared card and ft launcher: "
                            f"{time.perf_counter() - t0:.1f} s")
                if "partition" in shared:
                    part_stats["shared_card"] = shared_stats["partition"]
                if "dstream" in shared:
                    dstream_stats["shared_card"] = shared_stats["dstream"]
                if "hybrid" in shared:
                    hybrid_stats["shared_card"] = shared_stats["hybrid"]
                if "sampled" in shared:
                    sampled_stats["shared_card"] = shared_stats["sampled"]
                if "ft" in shared:
                    ft_stats["shared_card"] = shared_stats["ft"]
            if "trace" in groups:
                gc.collect()
                torch.cuda.empty_cache()
                if stream_pipe is None:
                    from repro_torch.data.dyngnn import DTDGPipeline
                    t0 = time.perf_counter()
                    stream_pipe = DTDGPipeline(train_ds, nb=TRAIN_NB,
                                               device="cuda")
                    log(f"[trace] pipeline {time.perf_counter() - t0:.1f} s "
                        "on the host (no stream phase)")
                trace_stats = phase("trace path", trace_path, torch,
                                    kernels, obs, train_ds, stream_pipe,
                                    group)
                launches["trace"] = trace_stats["launches"]
            docs_cpu = DocsCpuRun() if "docs" in groups else None
            if "examples" in groups:
                gc.collect()
                torch.cuda.empty_cache()
                examples_stats = phase("examples", examples_path, torch,
                                       kernels, group)
                launches["examples"] = examples_stats["launches"]
            if "docs" in groups:
                gc.collect()
                torch.cuda.empty_cache()
                docs_stats = phase("docs", docs_path, torch, kernels,
                                   docs_cpu)
                launches["docs"] = docs_stats["launches"]
        finally:
            dist.destroy_process_group()
    if "data" in groups:
        gc.collect()
        torch.cuda.empty_cache()
        data_stats = phase("data path", data_path, torch, kernels, train_ds,
                           train_raw)
        del train_raw
        launches["data"] = data_stats["launches"]
    del train_ds, stream_pipe
    gc.collect()
    torch.cuda.empty_cache()
    if "lm" in groups:
        from repro_torch.configs import yi_6b
        lm_eng, lm_stats = phase("lm path", lm_path, torch, kernels, obs,
                                 yi_6b.make_config())
        launches["lm"] = {"flash_decode": lm_stats["launches"]}
        lm_prof = phase("lm profile", profile_decode, torch, lm_eng)
        del lm_eng
        gc.collect()
        torch.cuda.empty_cache()
        fd_rows, fd_err = phase("flash_decode check", check_flash_decode,
                                torch, timer)
        lm_stats["parity"] = phase("lm parity", lm_parity, torch)
    if "moe" in groups:
        from repro_torch.configs import moonshot_v1_16b_a3b, olmoe_1b_7b
        moe_eng, olmoe = phase("moe path", lm_path, torch, kernels, obs,
                               olmoe_1b_7b.make_config(), "moe")
        olmoe["decode_profile"] = phase("moe profile", profile_decode,
                                        torch, moe_eng, "profile-moe")
        del moe_eng
        gc.collect()
        torch.cuda.empty_cache()
        moon_cfg = dataclasses.replace(moonshot_v1_16b_a3b.make_config(),
                                       num_layers=MOONLIGHT_LAYERS)
        moe_eng, moon = phase("moe moonlight", lm_path, torch, kernels, obs,
                              moon_cfg, "moe-moonlight", LM_BATCH,
                              MOONLIGHT_PROMPT, MOONLIGHT_TOKENS)
        del moe_eng
        gc.collect()
        torch.cuda.empty_cache()
        moe_stats = {"olmoe": olmoe, "moonlight": moon}
        launches["moe"] = {"flash_decode": olmoe["launches"]
                           + moon["launches"]}
        moe_stats["train"] = phase("moe train", moe_train, torch, kernels,
                                   obs)
        moe_stats["parity"] = phase("moe parity", moe_parity, torch)
        gc.collect()
        torch.cuda.empty_cache()
        if "lm" not in groups:
            fd_rows, fd_err = phase("flash_decode check (OLMoE)",
                                    check_flash_decode, torch, timer,
                                    FD_MOE_CASES)
        moe_stats["flash_decode"] = [r for r in fd_rows if r["case"] in
                                     {c[0] for c in FD_MOE_CASES}]

    if "gnn" in groups:
        gc.collect()
        torch.cuda.empty_cache()
        gnn_stats = phase("gnn path", gnn_path, torch, kernels)
        launches["gnn"] = gnn_stats["launches"]
        gnn_stats["parity"] = phase("gnn parity", gnn_parity, torch)

    if "recsys" in groups:
        gc.collect()
        torch.cuda.empty_cache()
        recsys_stats = phase("recsys path", recsys_path, torch, kernels)
        launches["recsys"] = recsys_stats["launches"]
        recsys_stats["parity"] = phase("recsys parity", recsys_parity, torch)

    if "cells" in groups:
        gc.collect()
        torch.cuda.empty_cache()
        cells_stats = phase("cells path", cells_path, torch, kernels, card,
                            timer)
        launches["cells"] = cells_stats["launches"]
        cells_checks = {k: [row for r in cells_stats["runs"]
                            for row in r.get("kernel_checks", {}).get(k, [])]
                        for k in ("segment_spmm", "banded_ttm",
                                  "banded_ttm_t")}

    if "ranks" in groups:
        gc.collect()
        torch.cuda.empty_cache()
        ranks_stats = phase("ranks path", ranks_path, torch, kernels, card,
                            timer)
        launches["ranks"] = ranks_stats["launches"]

    if "serve" in groups:
        spmm_main = next(r for r in spmm_rows if r["F"] == 6)  # layer 2
        spmm_main = dict(spmm_main, max_abs_err=spmm_err)
        extra = {"shapes": spmm_rows, "skewed_max_abs_err": skew_err,
                 "skewed": skew_rows,
                 "csr_builds": launches["serve"]["csr_builds"],
                 "state_advance": step_prof}
        if "train" in groups:
            extra["backward"] = spmm_bwd
            extra["csr_builds_train"] = launches["train"]["csr_builds"]
        if "stream" in groups:
            extra["csr_builds_stream"] = launches["stream"]["csr_builds"]
            extra["csr_pair_build"] = stream_stats["csr_pair"]
        if "hybrid" in groups:
            extra["rectangular"] = hybrid_stats["rectangular"]
        if "cells" in groups:
            extra["cells_shapes"] = cells_checks["segment_spmm"]
        report.append(kernel_entry(
            "segment_spmm", "src/repro_torch/csrc/segment_spmm.cu",
            "src/repro/kernels/segment_spmm/segment_spmm.py:55", launches,
            spmm_main, **extra))
        report.append(kernel_entry(
            "banded_ttm", "src/repro_torch/csrc/banded_ttm.cu",
            "src/repro/kernels/mproduct/mproduct.py:54", launches, ttm,
            detail=ttm, **({"train_shapes": ttm_train_rows,
                            "sweep": ttm_sweep}
                           if "train" in groups else {}),
            **({"partition_shapes": part_stats["band_rows"]}
               if "partition" in groups else {}),
            **({"cells_shapes": cells_checks["banded_ttm"]}
               if "cells" in groups else {})))
    if "train" in groups:
        ttm_t_main = ttm_t_rows[1]     # block 1: dZ (8, N x 6), lead 4, +4
        report.append(kernel_entry(
            "banded_ttm_t", "src/repro_torch/csrc/banded_ttm.cu",
            "src/repro/kernels/mproduct/mproduct.py:54 (its backward; the "
            "TPU package has none)", launches,
            dict(ttm_t_main, max_abs_err=max(r["max_abs_err"]
                                             for r in ttm_t_rows)),
            shapes=ttm_t_rows + ([stream_stats["banded_ttm_t"]]
                                 if "stream" in groups else [])
            + (part_stats["band_t_rows"] if "partition" in groups else []),
            sweep=ttm_t_sweep, train_path=train_stats,
            train_parity=train_par,
            **({"cells_shapes": cells_checks["banded_ttm_t"]}
               if "cells" in groups else {})))
    if "stream" in groups:
        # the streamed schedule's own numbers (the kernels' lines above
        # count its launches in their "stream" path)
        log(json.dumps({"stream_path": stream_stats}))
    if "partition" in groups:
        log(json.dumps({"partition_path": {
            k: v for k, v in part_stats.items()
            if k not in ("band_rows", "band_t_rows")}}))
    if "dstream" in groups:
        log(json.dumps({"dstream_path": dstream_stats}))
    if "hybrid" in groups:
        log(json.dumps({"hybrid_path": {
            k: v for k, v in hybrid_stats.items() if k != "rectangular"}}))
        if "serve" not in groups:
            log(json.dumps({"segment_spmm_rectangular":
                            hybrid_stats["rectangular"]}))
    if "sampled" in groups:
        log(json.dumps({"sampled_path": sampled_stats}))
    if "ft" in groups:
        log(json.dumps({"ft_path": ft_stats}))
    if "trace" in groups:
        log(json.dumps({"trace_path": trace_stats}))
    if "data" in groups:
        log(json.dumps({"data_path": data_stats}))
    if "moe" in groups:
        log(json.dumps({"moe_path": moe_stats}))
    if "gnn" in groups:
        log(json.dumps({"gnn_path": gnn_stats}))
    if "recsys" in groups:
        log(json.dumps({"recsys_path": recsys_stats}))
    if "cells" in groups:
        log(json.dumps({"cells_path": cells_stats}))
    if "ranks" in groups:
        log(json.dumps({"ranks_path": ranks_stats}))
    if "examples" in groups:
        log(json.dumps({"examples_path": examples_stats}))
    if "docs" in groups:
        log(json.dumps({"docs_path": docs_stats}))
    if {"lm", "moe"} & set(groups):
        report.append(kernel_entry(
            "flash_decode", "src/repro_torch/csrc/flash_decode.cu",
            "src/repro/kernels/flash_decode/flash_decode.py:69", launches,
            dict(fd_rows[0], max_abs_err=fd_err), shapes=fd_rows,
            **({"lm_path": lm_stats, "decode_profile": lm_prof}
               if "lm" in groups else {}),
            **({"lse_rows": ranks_stats["lse_rows"]}
               if "ranks" in groups else {})))
    log("[done] kernels launched on the paths driven and checked against "
        "their plain versions: " + ", ".join(k["name"] for k in report))
    log(json.dumps({"kernels": report}))
    left = stop_children()
    if left:
        raise SystemExit("chip_smoke: processes left running at the end, "
                         "now stopped:\n" + "\n".join(left))
    log("[done] every process the script started has ended")
    if groups != GROUPS:
        log(f"[done] partial run ({','.join(groups)}): no result line")
        return 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # registered before anything imports multiprocessing, so it runs last
    # at exit, after the finalizers that may restart the resource tracker;
    # a failed phase's processes are stopped there too
    atexit.register(stop_children)
    raise SystemExit(main())
