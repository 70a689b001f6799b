#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--scale 20] [--seed 0]

Phases, each printing one JSON line; any failure exits non-zero:

1. device   — fails unless CUDA is available; the card's name and power
              limit as ``nvidia-smi`` gives them.
2. build    — builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
              into ``build/repro_torch/`` (nvcc, sm_90a) and reports seconds;
              counts the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load)
              instructions in each bf16 attention kernel from
              ``cuobjdump -sass`` of the library, and fails if either is
              missing; counts the TF32 ``HMMA`` (``mma.sync`` m16n8k8)
              instructions in each float32 attention kernel and in each
              SSD chunk kernel (one per head dim P), and fails if one has
              none; fails unless every reduction in the edge-block
              kernel's sum instantiations at K=1 is one vector ``F32x2``
              (value and count together).
3. data     — a Graph500-style R-MAT graph (scale 20, edge factor 16,
              weighted) from ``generate.rmat_stream``, partitioned into 4
              shards with edge blocks as the host drive loop builds them.
4. kernels  — each kernel against its plain PyTorch version on the card, at
              the main path's shapes (shard 0's edge blocks and CSR tiles),
              for pagerank (sum, K=1) and sssp_bf (min, K=4): min must be
              bit-equal, sum within rtol/atol below; kernel, plain, library
              (one ``scatter_reduce`` merging the same messages, as a
              yardstick) times and the bound (bytes over the memory rate).
              The edge block runs twice: all 64 blocks in one launch
              (nb=64), and one launch per block (nb=1), the shape
              ``BlockedDaemon`` launches, timed per launch over all blocks;
              there ``device_ms`` is the same launches' time queued behind a
              sleep kernel, without the host's gaps between them.
5. e2e      — the host drive loop end to end on 4 shards: pagerank through
              ``daemon="cuda"`` (BSP; every phase before 5d pins its CSR
              config to ``CSRConfig()``), sssp_bf through ``daemon="cuda"``
              (GAS) and through ``BlockedDaemon(kernel="cuda")`` (BSP), each
              held against the port's ``run_reference`` on the card.  Each
              composition first runs one warm-up iteration (set-up: the
              daemon's CSR compaction); the launch counters are zeroed just
              before the timed run and must be non-zero after it.
5b. fused   — the device-resident fused loop on the same graph, shards and
              references: ``daemon="sharded"`` + ``upper="mesh"`` drives
              ``DriveLoop``.  pagerank (10 iterations, BSP) and sssp_bf (to
              its fixed point, GAS) through ``ShardedDaemon(kernel="cuda")``,
              and sssp_bf (BSP) through ``ShardedDaemon(kernel=
              "reference")``.  Each fails unless the middleware chose the
              fused loop and every record says ``fused``, unless its state
              matches ``run_reference`` (sssp bit-equal, pagerank within
              rtol/atol below, same iteration count), and, for
              ``kernel="cuda"``, unless ``csr_tile`` launched exactly once an
              iteration (one launch over all 4 shards' stacked tiles).  It
              prints ``init_s`` (the middleware's construction: stacking,
              compaction and placement), ``setup_s`` (that and one warm-up
              iteration), ``per_iteration_s`` beside the host loop's for the
              same program in phase 5, launches per iteration and the
              device→host fetches per iteration (calls that bring a CUDA
              tensor to the host, counted by size).  Then, for each run,
              ``profile``: ``torch.profiler`` over one more run — device
              time per CUDA kernel, memset and memcpy an iteration (the
              top 8), their sum, and the device's idle share of the
              profiled and of the timed run's wall time; and for
              ``kernel="cuda"`` ``parts_ms``: the step cut into its parts
              at the first iteration's inputs, each timed alone (mask,
              index casts, gathers, ``csr_tile``, the cross-tile combine,
              ``merge_partials``, apply, the fetch, the whole step), beside
              altered parts that compute the same values: the combine over
              only the rows that received a message
              (``padded_row_share`` is the rest), and the gathers by
              ``index_select`` and as K scalar gathers.  Then ``csr_tile``
              against its plain version at the fused loop's shape (all
              shards' tiles stacked, S·nt of them, dead tiles included),
              as in phase 4; this is the CSR tile's main case in the
              ``kernels`` line.
5c. pipeline — the pipeline shuffle on the same graph, shards and
              references: sssp_bf (BSP, to its fixed point) and pagerank
              (BSP, 10 iterations) through ``PipelinedDaemon(kernel=
              "cuda")``, whose three stages run in three threads and on
              three CUDA streams (copy in, compute, copy out), held
              against ``run_reference`` as in phase 5; sssp_bf must also
              launch ``edge_block`` as often, iteration for iteration, as
              phase 5's ``BlockedDaemon(kernel="cuda")`` run.  Each prints
              ``stages``: the executors' summed ``wall_time``, each stage's
              host ``busy`` seconds and its event-timed device span, beside
              the blocked run's, and ``pipelined_over_blocked`` (s an
              iteration).  Then ``calibration``: the stage times per block
              of the blocked daemon over shard 0's edges at four block
              sizes, 4,096..262,144, Lemma 1's (k1, k2, k3, a) fitted to the host
              stage times and to the device spans (``core.pipeline.
              calibrate``) with the upload's host merge cut in its
              halves (``scatter_at``, ``np.add.at``) per block, ``b_opt``,
              its branch and the block size
              ``block_size="auto"`` gives, beside the defaults'.  Then a
              pipelined run at the host fit's block size (2 iterations,
              against ``run_reference`` cut there), and Fig. 8's ratio at
              R-MAT scale 12 on one shard: ``daemon="naive"`` (a per-edge
              loop on the host), the blocked, pipelined and ``"cuda"``
              daemons over 2 iterations against the cut reference (the
              last three also to the fixed point), ``naive_over`` each.
              ``reduced`` names the cuts.
5d. autotune — ``kernels.autotune.autotune_csr`` for pagerank and sssp_bf
              on the shard with the most live edges, over the card's space
              (the flat merge at edge tiles 256, 512, 1024; the CSR-tile
              kernel at 256, 512): each point's ms, the winner and the
              signature's backend.  The flat merge at edge tile 512 on the
              same shard, timed as swept (dead and padded slots merge the
              identity into vertex 0) and over its live slots alone, with
              the dead-slot count and its row gather alone.  Then the fused
              loop with ``csr_config=None`` (pagerank 10 iterations, sssp_bf
              to its fixed point; the daemon tunes on the same shard, so
              its lookup is answered by the memo), checked as in phase 5b
              with ``csr_tile`` launched once an iteration if a kernel
              point won and never if a flat one did, its s an iteration
              beside phase 5b's pinned run; and the host loop (sssp_bf,
              ``daemon="cuda"``, GAS) with ``csr_config=None``, checked as
              in phase 5, beside phase 5's.
5e. mesh    — the fused loop at ``mesh=4`` (a logical device a shard) with
              ``CSRConfig()`` pinned, sssp_bf (GAS) and pagerank (BSP),
              checked as in phase 5b and against phase 5b's ``mesh=1``
              runs (sssp_bf bit-equal, pagerank within rtol/atol below);
              ``merge_partials`` must receive (4, N, K) every iteration;
              s an iteration beside ``mesh=1``, and phase 5b's
              ``profile`` (beside phase 5h's).
5e'. ranks  — the graph loop across ``torch.distributed`` ranks: the
              smoke spawns 4 gloo ranks (its own world, ``file://``
              rendezvous) that share the one card, CUDA tensors on each.
              The graph's arrays are written once as ``.npy`` and
              memory-mapped by each rank; each runs the same partitioner
              (4 shards) and binds only its own shard
              (``dist.sharding.RankMesh``, ``ShardedDaemon(mesh=rm)``,
              ``MeshUpperSystem(mesh=rm)``).  sssp_bf (GAS, to its fixed
              point) and pagerank (BSP, 10 iterations) through the fused
              ``DriveLoop``: each rank's state bit-identical to rank 0's,
              sssp_bf bit-equal to phase 5e's ``mesh=4`` state and
              pagerank within rtol/atol below, in as many iterations;
              ``csr_tile`` launched once an iteration and one small fetch
              an iteration (plus the final state) on each rank.  Then
              sssp_bf through the host loop over ``MeshUpperSystem(mesh=
              rm)`` (bit-equal to ``run_reference``) and pagerank's host
              loop on the int8 wire (``wire="compressed"``): every merge
              bit-equal to phase 8's NumPy oracle of the wire, fed every
              rank's recorded per-shard aggregates.  Prints s an iteration
              on each rank, the bytes of each all_reduce and the backend:
              four ranks share one card's SMs and gloo stages its wire
              through host memory, so none of it is a scale-out figure.
              (a) sssp_bf under ``AsyncModel``'s ``holding`` arm across
              the ranks: each rank's state bit-identical to rank 0's and,
              once phase 5f has run, bit-equal to its ``mesh=4`` holding
              state with equal iterations, skipped bodies and held
              device-iterations (so the line prints after 5f's); on each
              rank ``csr_tile`` launched once per run of its executing
              devices and one small fetch an iteration.  The R-MATs hold
              no device at m = 4, so the same arm also runs on 5h's road
              network (``grid_road(1024, seed=1)``, 60 iterations), held
              bit-equal to a one-process ``mesh=4`` run of it (itself at
              or above ``run_reference`` cut there) with held
              device-iterations > 0 and some rank whose device held.
              (b) structure epochs on 5g's scale-18 R-MAT: one GAS
              sssp_bf middleware over the ranks takes a
              kill of rank 3's device before iteration 2 and its join
              before iteration 4 (4 → 2 → 4 devices; ranks 2 and 3 sit
              out in between, in the world), a ``rebalance`` with rank 0's
              shard at half capacity, and ``run_dynamic`` of 5g's
              65,536-edge shard-0 add batch; each run bit-identical over
              the ranks and bit-equal to ``run_reference`` (the mutated
              graph's for the third), the migrations as the one-process
              planner plans the same schedule at m = 4 (a plan only), no
              fetch inside a rebuild.  Prints each rank's rebuild seconds,
              s an iteration around each epoch and the async step's flags
              all_reduce ms.  (c) 5h (d) across the ranks on 5g's
              scale-18 graph (cut from scale 20, in ``reduced``) at 5h's
              budget rule (a quarter of the resident CSR bytes a logical
              device): sssp_bf GAS out of core with prefetch, device 3
              killed before iteration 3 (ranks 2 and 3 idle after),
              ``oocore_replan`` at half the budget and a second run; each
              bit-equal to ``run_reference`` and identical on every rank,
              its per-iteration super-shards, hot columns and the world's
              hot hits and cold misses those of the same two runs on one
              process at ``mesh=4``; on each rank ``csr_tile`` (hot > 0) +
              uploads a step, at most two groups live, one fetch a step
              and none in a rebuild.  Prints each rank's s an iteration
              before and after the kill, rebuild s, transfer, wait,
              overlap and copy GB/s, and the ranks' summed GB/s.  (d) 5i
              across the ranks on 5g's graph:
              ``GraphServeSession(kernel="cuda", max_batch=8, mesh=<the
              RankMesh>)`` answers 5i's batch of 8 of each kind, a
              pagerank lookup and 5i's seeded replay (cut to the families
              the batches built); every rank's answers and batches
              identical, khop and sssp bit-equal to 5i's, ppr and the
              lookup held to 5i's float64 references (so the line prints
              after 5i's); ``csr_tile`` once an iteration and one small
              fetch an iteration on each rank.  Prints ``init_s`` per
              family per rank, service s a batch, rank 0's qps, p50 and
              p99.  A failing or hung rank fails the phase.
5f. async   — the fused async loop (``model=AsyncModel(...)``, so
              ``AsyncDriveLoop``) at ``mesh=4`` with ``CSRConfig()`` pinned:
              sssp_bf to its fixed point under README's three arms
              (``eager`` θ0=0, decay 0.5; ``holding`` θ0=10, decay 0.9;
              ``buckets`` as ``holding`` with ``bucket_k=8``) and pagerank
              ``eager`` for 10 iterations, against ``run_reference`` as in
              phase 5 (sssp bit-equal, pagerank within rtol/atol below),
              one fetch an iteration.  Every record must show a held
              device running no tile, ``gen_run + gen_skipped == 4`` and
              ``gen_run`` devices running tiles; ``csr_tile`` must launch
              once per run of consecutive executing devices in every
              iteration; the instrumented daemon's ``gen_invocations``
              must equal Σ ``gen_run`` (and ``bucket_invocations`` Σ
              ``gen_skipped`` under ``buckets``).  Each prints s an
              iteration beside phase 5e's run of the same program
              (``async_over_bsp``, for information), the skipped device
              bodies (``gen_skipped``) and held device-iterations
              (``run_mask`` False), launches per iteration, and for
              ``holding`` the ``profile`` of phase 5b.  With every vertex
              active Graph500's R-MAT skips few or no bodies, so
              ``holding`` also runs as
              ``benchmarks/bench_accel.py``'s async table runs it: its
              skewed R-MAT (a=0.7, b=0.15, c=0.1, no dedup) at 5g's
              scale 18 and the same edge factor, sources 0-3 the only active
              vertices, beside the barriered ``mesh=4`` run (GAS) of the
              same, checked the same way; there ``holding`` must skip a
              device body at least once.
5g. elastic — the structure-epoch layer at ``mesh=4`` with ``CSRConfig()``
              pinned, on an R-MAT graph of scale 18 made as phase 3's
              (edge factor 16, ``--seed``; its own 4 shards, pagerank and
              sssp_bf programs and ``run_reference`` runs; the depth cut
              that makes room for phase 9, in the line's ``reduced``): (a) sssp_bf GAS with
              ``FailureSchedule(kills=[(3, 2)])`` (4 → 2 logical devices),
              (b) the same kill under ``AsyncModel`` ``holding``, (c)
              pagerank BSP (10 its) with the kill, (d) sssp_bf with
              ``kills=[(2, 1)], recoveries=[(5, 1)]`` (4 → 2 → 4), (e)
              sssp_bf with step-time reports putting device 1 at 3× the
              others (a Lemma-2 re-partition that recompacts every tile);
              (f) ``rebalance(capacities=linspace(1, 2, 4))`` between two
              sssp_bf runs of the fused loop, and before one on the host
              loop with ``daemon="cuda"`` (phase 5's sssp_bf middleware on
              the scale-20 graph, whose run before it is phase 5's); (g) a ``MutationSchedule``
              batch at iteration 3 adding 65,536 edges whose sources own
              edges in shard 0 (destinations uniform, weights in the
              generator's range, from ``--seed``); (h) ``run_dynamic`` of
              the same batch after a converged run (incremental, mode
              ``dirty``), beside a cold run of a fresh middleware on the mutated
              graph; (i) ``run_dynamic`` of a batch removing 65,536 of
              shard 0's edge pairs (mode ``cold_fallback``).  Each is held
              against ``run_reference`` on the post-trigger graph (sssp
              bit-equal, pagerank within rtol/atol below); the migration
              records must name the killed / joined devices and the axis
              length after; in every iteration the step makes exactly one
              small fetch, a BSP rebuild none (an async one at most one
              (m,)-sized), nothing vertex-sized but the final state;
              ``csr_tile`` launches once an iteration (async: once per run
              of executing devices); tilesets recut / reused are (0, 4) per
              kill or join, (4, 0) for the straggler, (1, 3) per batch; no
              autotune sweep.  Prints each rebuild's ``seconds``, the
              iterations, s an iteration in each segment between rebinds
              beside phase 5e's ``mesh=4`` runs, and the incremental
              iterations against the cold ones.
5h. oocore  — out-of-core execution (``Middleware(oocore=OocoreConfig(...))``,
              so ``OocoreDriveLoop``) at ``mesh=4`` with ``CSRConfig()``
              pinned, on the same graph and shards, under a budget of a
              quarter of phase 5e's resident CSR bytes per logical device
              (``benchmarks/bench_accel.py``'s div=4), hot fraction 0.25:
              the hot set stays on the card, the cold super-shards are
              pinned on the host and copied on a side CUDA stream.  (a)
              sssp_bf GAS with prefetch, (b) the same without (a re-plan
              of the same middleware switches it off), (c) pagerank BSP
              (10 its), (d) sssp_bf with device 3 killed before iteration
              3 (4 → 2, the plan's column bytes must double), then
              ``oocore_replan`` to half the budget and a second run, (e)
              sssp_bf at the config phase 5d memoized (no sweep; the flat
              merge launches no ``csr_tile``), (f) sssp_bf on
              ``grid_road(1024, seed=1)`` (1,048,576 vertices) for 60
              iterations with and without prefetch, beside its resident
              ``mesh=4`` run.  Each run, after a warm-up iteration: the
              state bit-equal to ``run_reference`` and to the resident
              run (pagerank within rtol/atol below), equal iterations;
              one small fetch in each step, none in a rebuild or a
              re-plan, one vertex-sized (the final state); ``csr_tile``
              launched (hot set > 0) + uploads times an iteration;
              uploads + skipped = Σ super-shards; hot hits + cold misses
              = blocks run; wait ≤ transfer (raw event readings, to
              their grain) so 0 ≤ overlap ≤ 1, exactly 0 and no skip
              without prefetch; at most two groups live, in at most two
              device slots of one group's bytes (one without prefetch);
              the device's peak allocation over the run's start, with
              prefetch, at most one slot and the scheduler's gather above
              the no-prefetch arm's ((a) against (b), (f) against its
              twin); the hot set's device bytes m × hot_cols ×
              col_bytes_dev; a skip in (f) with prefetch.  Prints the plan, s an iteration beside the
              resident step, transfer and wait seconds, the overlap, GB
              uploaded and the copies' GB/s (event-timed), skips, the hot
              hit rate, the kill's and re-plans' seconds, and for (a)
              and (c) phase 5b's ``profile``.

5i. serve  — online graph-query serving (``repro_torch.serve``) on 5g's
              R-MAT graph of scale 18 (for the smoke's time) at ``mesh=4``
              with ``CSRConfig()`` pinned,
              ``GraphServeSession(kernel="cuda", max_batch=8)``:
              (a) a batch of 8 queries of each kind (``khop`` at hops 3,
              ``sssp``, ``ppr``; six vertices with out-edges drawn from
              ``--seed``, a duplicate and a 3-seed query), khop and sssp
              columns bit-equal to ``run_reference`` of the same program
              on the card, duplicates equal, each ppr column within rtol
              1e-4 / atol 1e-8, and within 1e-5 of its mass in L1, of its
              query's solo ``run_reference`` at the apply where the freeze
              stops it (the state before the apply that found it quiet; an
              apply either side where float32 rounding moves the quiet
              test: ``stop_offsets``); every sum program's reference in
              this phase runs in float64, since a float32 dense
              reference's atomic sums into a hub drift by ~3e-5 at scale
              20.  Each batch runs twice (the second is the
              family's steady state), and sssp's first query as a batch of
              one, bit-equal to its column; (b) a ``lookup`` of
              ``pagerank`` against ``run_reference`` at the session's 60
              iterations (rtol 1e-4 / atol 1e-7); (c) a seeded
              ``generate_workload`` (khop, sssp, ppr, lookup; repeat
              fraction 0.2; 16,000 requests a virtual second, so batches
              flush full) replayed through ``GraphServeRouter(
              max_batch=8)``, cut to the longest prefix of its 64 requests
              whose batches all land on (a)'s families; every batch answer
              against its solo reference, every cache hit equal to its
              first answer; (d) ``tests/test_serve.py``'s kill arm on (a)'s
              session and families (one ``FleetMonitor`` from the start,
              the schedule armed here): a khop batch cached, device 2
              killed at iteration 5 and rejoining at 8 inside one ppr batch
              (two migrations, 4 → 2 → 4), the volatile entry alone
              flushed, the durable answers still hit, the ppr answers
              against their float64 solo runs and the sssp batch after the
              join bit-equal to (a)'s, no family built.  Every serving run:
              the fused loop, ``csr_tile`` once an iteration, one small
              fetch an iteration and one vertex-sized a run; no sweep.
              Prints ``init_s`` per family, ``service_s`` per batch and s
              per query at B = 8 beside B = 1, the replay's qps and
              p50/p99, and the migrations' seconds;
              then ``csr_tile`` at the serve triples (add_one/min,
              add_weight/min, pr_div_deg/sum at K = 8, each with its
              program's aux: none for the min programs, padded to the
              kernel's one zero column as the main path pads it, 1 + 8
              wide for ppr) over a serve family's stacked tiles, against
              its plain version as in phase 4.  Every graph kernel's bound
              counts the aux columns its message function reads (1 for
              pr_div_deg, else 0), not the aux it is handed.

6. attention — a qwen2-72b attention layer at ``train_4k`` (B=1, Hq=64,
              Hkv=8, S=4096, D=128, bf16, causal) through
              ``kernels.ops.flash_attention``, with the launch counter zeroed
              just before and read just after; then the kernel against
              ``impl="reference"`` (bf16: |Δ| ≤ 2^-7·|want| + 1e-5 at every
              element, one bf16 ulp of the output), one non-causal
              float32 case at whisper-base's head dim (D=64, Hq=Hkv=8,
              S=4096; max |Δ| ≤ 1e-4·max(1, max |want|)), which runs the
              3xTF32 kernel (three TF32 tensor-core products per matrix
              product), and a zamba2-2.7b attention layer (B=1, Hq=Hkv=32,
              D=2560/32=80, S=4096, bf16, causal), which runs the D=128
              kernel with the columns past 80 zero-filled.  Kernel,
              entry point, plain and library
              (``scaled_dot_product_attention``, a yardstick the port never
              calls) times and the bound (bf16: the flops at 989 TFLOP/s;
              float32: three TF32 products' flops at 495 TFLOP/s, with the
              flops at the FMA units' 67 TFLOP/s beside it as
              ``fma_bound_ms``); for information, the share of
              the same tolerance that SDPA's output takes against the same
              reference (no check: SDPA rounds P to bf16).
7. ssd       — a mamba2-1.3b SSD layer (B=1, S=4096, H=64, P=64, G=1,
              N=128, chunk 256, f32) through ``kernels.ops.ssd_scan``, counted
              as above; held against ``impl="reference"`` and the sequential
              ``ref.ssd_scan_reference``, and ``ssd_chunk`` against
              ``ssd_chunk_plain`` on all four outputs (max |Δ| ≤
              1e-4·max(1, max |want|) each).  These inputs are those of
              tests/test_kernels.py (dt = softplus(N(0,1))), under which a
              256-long chunk's decay underflows to 0; a second set with dt
              in Mamba2's range 1e-3..1e-1 keeps decay and gate normal
              floats and holds them per element within 1e-4·|want|, and
              runs the same checks.  The chunk step runs the 3xTF32 kernel
              (C·Bᵀ once per block of 16 heads, every product as three TF32
              tensor-core products), so its bound is three TF32 products'
              flops at 495 TFLOP/s, with the FMA units' bound beside it as
              ``fma_bound_ms``.  No single PyTorch call computes the SSD,
              so it has no library time.
8. model     — language-model serving at zamba2-2.7b's published config
              (54 Mamba2 layers, the shared attention block after every 6,
              2,422,386,848 float32 parameters made from ``--seed`` on the
              card, bf16 compute): ``repro_torch.models.Model(kernel=
              "cuda")``'s prefill of B=2 prompts of S=4096 tokens
              (``cache_len`` 4096 + 32), the launch counters zeroed just
              before and read just after (flash attention once a shared
              block invocation, 9; the SSD chunk kernel once a Mamba2
              layer, 54); the same prefill through ``kernel="reference"``
              (the same parameters).  Layer level, on the kernel prefill's
              own activations: the first Mamba2 layer's SSD (y and final
              state, float32) within phase 7's tolerance, the first shared
              block's attention within phase 6's bf16 tolerance, each
              timed at these shapes beside its plain version (and SDPA)
              with its bound.  End to end: the last position's logits,
              every layer's final SSM state and conv tail and the KV
              caches within ``MODEL_TOL``·max |want| of the reference's
              (a tolerance fixed on the CPU, PERF.md).  Then greedy
              generation of 32 tokens (the prefill's token and 31 decode
              steps), twice, with identical tokens and no model-kernel
              launch in decode; prefill s, decode ms a step, tokens/s, the
              peak allocation (the bf16 copies of the weights, made once
              and kept, counted in it), and, for information, the tokens
              that agree with a generation from the reference prefill's
              cache.  Last, the compressed wire on phase 3's graph and
              shards: pagerank's host loop as phase 5 runs it (10
              iterations, ``daemon="cuda"`` pinned to ``CSRConfig()``) with
              ``MeshUpperSystem(mesh=4, wire="compressed")``: every merge
              bit-equal to a NumPy oracle of the int8 error-feedback wire
              (per-device scales, the shared max, int32 sum, one
              dequantize, the residual carried) on the merge's own
              per-shard aggregates; after ``reset`` the same merges
              replayed through the same upper bit-equal; ``wire_stats``
              ((N·K·4·bits)//32 + 4)·m a merge; then ``bits=4`` held to
              its oracle (one run each: a second run differs from the
              first only by the daemon's float sums, which vary with the
              combine's atomics, PERF.md §6).  The distance to phase 5's
              exact state is reported, not bounded: a per-tensor scale
              puts most R-MAT aggregates under one quantization step
              (PERF.md §6).
9. train     — training, on phase 8's model (its parameters; the bf16
              copies dropped): (a) zamba2-2.7b's loss and backward on
              B=1 × S=4096 tokens of ``train.data.SyntheticLM(seed)``
              through the kernels' ``autograd.Function``s against
              ``kernel="reference"`` on the same parameters, in float32
              compute (every gradient leaf within ``TRAIN_TOL``·max |want|
              of that leaf, the loss within ``TRAIN_LOSS_RTOL``) and in
              the config's bf16 (the loss within ``TRAIN_LOSS_RTOL_BF16``,
              ||Δ|| / ||want|| over all leaves within ``TRAIN_L2_BF16``),
              the launch counters zeroed just before and read just after
              each kernel pass (per-group remat: 18 flash attention, 108
              ``ssd_chunk``); on that pass's own inputs the first shared
              block's dq, dk, dv and the first Mamba2 layer's SSD chunk
              gradients through the Functions bit-equal to plain autograd
              of the plain versions, and ``ops.ssd_scan``'s gradients
              within 1e-4·max(1, max |want|) of the reference path's; then
              a 512-token prefill, 3 AdamW steps through
              ``train.step.make_train_step`` (each loss finite; s a step,
              tokens/s, the peak allocation), and the prefill again, now
              bit-equal to one through freshly cast copies (and moved from
              the first); one step with ``grad_wire="int8"``: its
              ``grad_wire_err``, and the first leaf of at most 2^22 floats
              as sent bit-equal to a NumPy oracle of the int round.  (b)
              qwen3-moe-235b-a22b at its published width, 2 of its 94
              layers (in the line's ``reduced``), parameters from
              ``--seed``: a prefill of B=1 × 4096 tokens through the
              kernels (one attention launch a layer) against
              ``kernel="reference"`` within ``MODEL_TOL``·max |want|, 16
              greedy tokens twice, identical; the share of (token,
              expert) assignments dropped for want of capacity, prefill s,
              ms a decode step, the peak.  (c) whisper-base at its
              published config: frames (2, 1500, 512) from the seed and a
              448-token prompt; a prefill launches attention 6 times at
              S=1500 with ``causal=False`` (the encoder) and 6 times
              causal at S=448, within ``MODEL_TOL`` of the reference, 32
              greedy tokens twice; its gradients against the reference as
              in (a), and one AdamW step.  Each model's first attention
              inputs of a kind are timed through the kernel beside its
              plain version and SDPA, with the bound.  (d)
              ``launch.train --reduced`` (stablelm, 6 steps, a checkpoint
              every 3, ``--grad-wire int8``), its last checkpoint removed
              and the run repeated: it resumes from step 3 and runs the
              rest; then ``examples.elastic_restart`` on the card (its
              restored state bit-equal to the saved one, the resumed
              losses within its ``LOSS_RTOL`` of an uninterrupted run).

9'. model_ranks — the model path across ``torch.distributed`` ranks
              (run right after the build phase, on a card and
              host nothing else has used yet):
              4 gloo ranks share the card as a (2, 2) ``RankGrid`` (data,
              model), spawned once: every parameter is a rank's block of
              the JAX layout of the arm's rules.  (a) (``"serve"``: the
              weights whole over data; heads, the vocabulary and the
              experts on model) qwen3-moe-235b-a22b at its
              published width, 2 of its 94 layers with bf16 parameters
              (both in ``reduced``), from ``--seed`` (each rank draws the
              one-process init and keeps its block: 64 of the 128 experts
              of each layer on each model rank, half the q heads, its KV
              cache by sequence): a prefill of B=2 × 4096
              (row d on data row d) through the kernels, then 16 greedy
              tokens, twice.  Before the world is spawned the script runs
              each row's one-process B=1 prefill and decode on the same
              parameters (the capacity is ``capacity_for(4096)`` on both
              sides).  Each rank's prefill logits within
              ``MODEL_TOL``·max |want| of its row's, the tokens identical
              on both ranks of a row and in the second run, flash
              attention launched once a layer in each prefill on every
              rank (the counter zeroed just before, read just after); it
              prints the tokens that agree with the one-process ones, each
              rank's peak allocation, prefill s, ms a decode step, the
              combine's all_reduce ms (alone, at the prefill's and a
              decode step's shape) and the world's dropped share.  (b)
              ``launch.train`` on the grid, reduced qwen3-moe in float32, 6
              steps of B=8 × 128 with ``--kill-device-at 3`` ((2, 2) → (1,
              2) on ranks 0-1; rank 2 idle, rank 3 lost), then the same on
              the CPU in the same world, both from parameters drawn on
              the CPU: the card's losses within ``TRAIN_LOSS_RTOL`` of the
              CPU's, the survivors' final leaves within
              ``TRAIN_TOL``·max |want| (elements whose gradient was
              float32 noise in the same step in both runs, ``MR_NOISE``,
              within ``MR_NOISE_MOVE``), every rank the leader's losses; s a step before and after the kill,
              the migration s (every block re-laid onto the survivors),
              the gradients' all_reduce ms alone ((b) and (c) under the
              ``"2d"`` rules: FSDP on data, heads, the FFN's hidden dim,
              the vocabulary and the experts on model).  (c) zamba2-2.7b
              at its published widths, ``ZR_LAYERS`` (2) Mamba2 layers
              and one shared-block invocation after them (in
              ``reduced``), bf16 compute: a prefill of B=2 × 4096 (row d on data row d) and
              16 greedy tokens, then a second prefill, against each row's
              one-process B=1 run made before the spawn: each rank's
              logits (its vocabulary block) and every cache block within
              ``MODEL_TOL``·max |want|, the tokens equal on a row's ranks,
              1 flash attention and 2 ``ssd_chunk`` launches in each
              prefill on every rank; it prints prefill s, ms a decode step
              (each gathers every FSDP block over data), the second
              prefill's peak above its start (phase 10 predicts it), the
              parameters a rank holds against one process's,
              and the layout's all_reduce, FSDP gather and re-lay timed
              alone.  Then ``ssd_chunk`` at a rank's 40 heads (G=1) and
              flash attention at its 16 q / 16 KV heads (D=80, bf16,
              causal) against their plain versions.  A failing or hung
              rank fails the phase.

10. analysis — the dry-run accounting (``launch/op_analysis.py``)
              against the card.  (a) Nine steps that phases 8, 9 and 9'
              ran and measured — zamba2-2.7b's second kernel prefill (B=2,
              S=4096) and one decode step, its last AdamW step (B=1,
              S=4096), qwen3-moe's and whisper-base's second prefill, and
              9' (c)'s second prefill on each of the four ranks (a traced
              (2, 2) grid of the gloo transport, ``TracedGrid``) — are
              built again by ``launch/dryrun.py``'s ``build_step``, the
              code that writes the dry run's records, and traced on the
              meta device (the model kernels' launches planned, not
              made).  Each line holds
              the predicted peak allocation above the step's start against
              ``max_memory_allocated`` − ``memory_allocated``-before
              (within ``PEAK_TOL``), the planned launches against the
              counted ones (equal), the dot FLOPs, their share of the
              measured seconds at 989 TFLOP/s (``flops_share``) and the
              roofline's terms; a miss fails the phase.  (b) The
              deprecated ``GXEngine`` shim (``core/engine.py``) on an R-MAT
              of scale 16: sssp_bf through ``execution="vectorized"`` and
              ``"blocked"`` with ``use_pallas=True``, bit-equal to
              ``run_reference``, with its ``csr_tile`` and ``edge_block``
              launches.

Float32 matrix products run in full float32 (TF32 off) throughout.  Then the
``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 on the tensor cores, dense
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 on the tensor cores, dense
# float32 attention and the SSD chunk step take each matrix product as
# three TF32 products (csrc/tf32.cuh: a_s·b_b + a_b·b_s + a_b·b_b)
TF32_PRODUCTS = 3
# Sum merges: kernel and plain version add the same non-negative float32
# messages in different orders (a kernel's run walk or atomics against the
# plain scatter), so they agree to a relative error of a few ulps times the
# row's message count.
SUM_RTOL, SUM_ATOL = 1e-4, 1e-12
PR_RTOL, PR_ATOL = 1e-4, 1e-12  # pagerank state after the same iterations
EDGE_FACTOR = 16    # Graph500's edges per vertex
SHARDS = 4
PR_ITERATIONS = 10  # pagerank runs a fixed count (it converges slowly)
# phase 5c: block sizes at which the stage times are fitted (every second
# power of two of the range; the fit has two coefficients a line), the
# blocks timed at each, the iterations of the cut runs, and Fig. 8's
# graph scale
CALIBRATION_SIZES = (4096, 16384, 65536, 262144)
CALIBRATION_BLOCKS = 16
MERGE_REPS = 5
CUT_ITERATIONS = 2
FIG8_SCALE = 12
# (label, B, Hq, Hkv, S, D, dtype, causal); the first is the main path
ATTN_CASES = (("qwen2-72b/bf16/causal", 1, 64, 8, 4096, 128, "bfloat16", True),
              ("whisper-base-d64/f32/full", 1, 8, 8, 4096, 64, "float32",
               False),
              ("zamba2-2.7b/bf16/causal", 1, 32, 32, 4096, 80, "bfloat16",
               True))
# bf16 outputs: kernel and plain version round float32 results that differ
# by float32 summation order to bf16, so they differ by at most one bf16 ulp
# (≤ 2^-7·|want|) plus that float32 difference
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
F32_RTOL = 1e-4     # max |Δ| ≤ F32_RTOL · max(1, max |want|)
# mamba2-1.3b: d_inner 4096 = 64 heads of P=64, N=128, G=1, chunk 256
SSD = dict(b=1, s=4096, h=64, p=64, g=1, n=128, chunk=256)
# Mamba2's dt range (dt_min, dt_max of the reference Mamba2 layer): a
# chunk's Σ|a|·dt stays O(1), so decay and gate are live
SSD_DT_RANGE = (1e-3, 1e-1)
LIVE_MIN = 1e-30    # a per-element relative check needs |want| above this
# phase 8: the served model and its prompt batch
MODEL_ARCH = "zamba2-2.7b"
MODEL_B, MODEL_S, MODEL_GEN = 2, 4096, 32
# end to end, the kernel prefill against kernel="reference": |Δ| ≤
# MODEL_TOL · max |want| for the logits and every cache leaf.  The kernels'
# last-bit differences (one bf16 ulp in attention, float32 rounding in the
# SSD) pass through 54 random-weight layers; emulated on the CPU at this
# depth they move the logits by 1.0% and the caches by 1.3–1.6% of max
# |want| (bf16 against float32 itself 1.5–2.1%), so 2^-4 leaves a margin
# of ~4 (PERF.md §6)
MODEL_TOL = 2.0 ** -4
# phase 9: zamba2-2.7b trained at B=1, S=4096 (3 AdamW steps; a 512-token
# prefill before and after them); the gradients through the kernels
# against kernel="reference" on the same parameters and batch.  float32
# compute: every leaf within TRAIN_TOL·max |want| of that leaf, the loss
# within TRAIN_LOSS_RTOL.  bf16 compute (the config's): the loss within
# TRAIN_LOSS_RTOL_BF16 and ||Δ|| / ||want|| over all leaves within
# TRAIN_L2_BF16 — a per-leaf bound cannot hold there: one bf16 ulp on 30%
# of the attention outputs moves a leaf's gradient by up to 56% of its max
# through 54 bf16 layers (median 8.5%, global 7.9% in L2), where float32
# moves it by 2.6e-4 at most (scripts/train_tol_sim.py, d_model 256, S
# 512); PERF.md §6
TRAIN_B, TRAIN_S, TRAIN_PREFILL_S, TRAIN_STEPS = 1, 4096, 512, 3
TRAIN_TOL = 2.0 ** -9
TRAIN_LOSS_RTOL = 1e-5
TRAIN_LOSS_RTOL_BF16 = 2.0 ** -10
TRAIN_L2_BF16 = 2.0 ** -2
WIRE_ORACLE_NUMEL = 1 << 22  # the first leaf this small meets the oracle
# phase 9 (b): qwen3-moe at its published width, 2 of its 94 layers
MOE_ARCH, MOE_LAYERS, MOE_S, MOE_GEN = "qwen3-moe-235b-a22b", 2, 4096, 16
# phase 9 (c): whisper-base, a 448-token prompt (no multiple of 128)
WHISPER_ARCH, WHISPER_B, WHISPER_PROMPT, WHISPER_GEN = (
    "whisper-base", 2, 448, 32)
# phase 10: a predicted peak allocation above a step's start within
# PEAK_TOL of the card's; the graph the GXEngine shim runs on
PEAK_TOL = 0.05
ENGINE_SCALE = 16
# the bf16 attention kernel (csrc/flash_attention_sm90.cu) and the SASS
# instructions that show it runs on wgmma and TMA loads
SASS_KERNEL = "attn_sm90_kernel"
SASS_OPS = ("HGMMA", "UTMALDG")
# the float32 attention kernel, the SSD chunk kernel, and their mma.sync
# m16n8k8 TF32 instructions
F32_SASS_KERNEL = "attn_tf32_kernel"
SSD_SASS_KERNEL = "ssd_chunk_kernel"
TF32_HMMA = r"\bHMMA\.[0-9A-Z.]*TF32"
# the edge-block kernel's instantiations for the sum monoid at K=1 (any
# message function: edge_block_kernel<OP, kSum=0, KT=1>) and the vector
# reduction each live edge must take there
RED_KERNEL = r"edge_block_kernelILi\d+ELi0ELi1E"
RED_VECTOR = "F32x2"


T0 = time.perf_counter()


def emit(obj) -> None:
    """Prints one JSON line; a phase's line gets ``t_s``, the seconds since
    the script started, so each phase's share of the run shows."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def measured_step(fn) -> tuple:
    """Runs ``fn()`` once between synchronizations; returns its result and
    ``{"s", "peak_delta_bytes", "peak_bytes"}``: the seconds, and the peak
    allocation during the call above what was allocated before it (and
    absolute)."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return out, {"s": s, "peak_delta_bytes": peak - before,
                 "peak_bytes": peak}


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 5, sleep_cycles: int = 20_000_000):
    """Device time of ``fn``'s launches with the host's gaps taken out: the
    launches are queued behind a sleep kernel of ``sleep_cycles`` (~10 ms)
    and timed from the sleep's end.  Returns the mean over ``reps`` and
    whether the host had queued them all before the sleep ended every time
    (else the time still holds host gaps)."""
    import torch

    fn()
    total, ahead = 0.0, True
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        fn()
        end.record()
        ahead &= not start.query()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, ahead


def bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the rate the operands allow
    (float32 unless told otherwise)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def aux_read(program) -> int:
    """Aux columns a kernel's message function reads at a live source:
    ``pr_div_deg`` divides by column 0 (the out-degree), the other message
    functions read none.  Wider aux (PPR's restart columns) is the apply's,
    not the kernel's, so the bound counts only this many."""
    return 1 if program.gen_op == "pr_div_deg" else 0


def edge_bytes(emask) -> int:
    """Edge-slot bytes a kernel must read: a live slot's src index, dst
    index, weight and mask (16 B); a dead or padded slot's mask alone
    (4 B).  With the src rows the live edges gather and the partials and
    counts written, this is the byte count of the bound."""
    live = int(emask.sum())
    return live * 16 + (emask.numel() - live) * 4


def compare(name, got, want, counts_got, counts_want, monoid_name):
    import torch

    if not torch.equal(counts_got, counts_want):
        raise AssertionError(f"{name}: counts differ")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite partials")
    err = (got - want).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    if monoid_name == "sum":
        tol = SUM_ATOL + SUM_RTOL * want.abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"{name}: sum outside rtol={SUM_RTOL} "
                                 f"atol={SUM_ATOL}, max abs err {max_abs}")
    elif not torch.equal(got, want):
        raise AssertionError(f"{name}: {monoid_name} not bit-equal "
                             f"(max abs err {max_abs})")
    return max_abs, tolerance(monoid_name)


def tolerance(monoid_name: str) -> str:
    if monoid_name == "sum":
        return f"rtol={SUM_RTOL} atol={SUM_ATOL}"
    return "bit-equal"


def library_merge_ms(parts, monoid):
    """One ``scatter_reduce`` per (msgs, seg, live, num_segments) part,
    merging the same messages into the same slots, all parts in turn — the
    library yardstick (the merge alone, on precomputed messages); the port
    never calls it."""
    import torch

    reduce = {"sum": "sum", "min": "amin", "max": "amax", "or": "amax"}
    calls = []
    for msgs, seg, live, num_segments in parts:
        out = torch.full((num_segments, msgs.shape[1]), monoid.identity,
                         dtype=torch.float32, device=msgs.device)
        calls.append((out, seg[live].long()[:, None].expand(
            -1, msgs.shape[1]), msgs[live]))
    return cuda_time_ms(lambda: [out.scatter_reduce(
        0, idx, vals, reduce=reduce[monoid.name], include_self=True)
        for out, idx, vals in calls])


def phase_csr_tile(tiles, program, state, aux, active, label):
    """``tiles``: the per-tile arrays (``CSRTileSet.arrays()`` layout, numpy
    or device tensors) of one shard, or of all shards stacked as the fused
    loop launches them."""
    import torch

    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels import ops

    dev = state.device
    csr = {k: torch.as_tensor(v, device=dev) for k, v in tiles.items()}
    aux = ops._pad_aux(state, aux)  # a zero-width aux as the main path pads it
    svids = csr["svids"].long()
    vsrc = state[svids].contiguous()
    vaux = aux[svids].contiguous()
    rowst = state[csr["rows"].long()].contiguous()
    emask = csr["emask"] & active[csr["gsrc"].long()]
    emf = emask.to(torch.float32)
    args = (vsrc, vaux, rowst, csr["lsrc"], csr["seg"], csr["w"], emf)
    got, got_c = ebk.csr_tile(*args, program=program)
    want, want_c = ebk.csr_tile_plain(*args, program=program)
    torch.cuda.synchronize()
    max_abs, tol = compare(f"csr_tile/{label}", got, want, got_c, want_c,
                      program.monoid.name)
    ms = cuda_time_ms(lambda: ebk.csr_tile(*args, program=program))
    plain_ms = cuda_time_ms(lambda: ebk.csr_tile_plain(*args,
                                                       program=program),
                            reps=5)
    t, et = csr["lsrc"].shape
    st, k, a = vsrc.shape[1], vsrc.shape[2], vaux.shape[2]
    rt = rowst.shape[1]
    live_src = torch.unique(
        (torch.arange(t, device=dev)[:, None] * st + csr["lsrc"])[emask])
    nbytes = edge_bytes(emask) + live_src.numel() * (k + aux_read(
        program)) * 4 + t * rt * (k + 1) * 4
    ops = int(emask.sum()) * k * 2
    msgs = program.msg_gen(
        torch.take_along_dim(vsrc, csr["lsrc"].long()[..., None], 1
                             ).reshape(-1, k),
        None, csr["w"].reshape(-1, 1),
        torch.take_along_dim(vaux, csr["lsrc"].long()[..., None], 1
                             ).reshape(-1, a))
    seg = (csr["seg"].long() + torch.arange(t, device=dev)[:, None] * rt)
    library_ms = library_merge_ms(
        [(msgs, seg.reshape(-1), emask.reshape(-1), t * rt)], program.monoid)
    return dict(kernel="csr_tile", case=label, tiles=t, ET=et, RT=rt, ST=st,
                K=k, A=a, live_edges=int(emask.sum()), max_abs_err=max_abs,
                tolerance=tol,
                kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=nbytes, ops=ops, **bound(nbytes, ops))


def phase_edge_block(bs, program, state, aux, active, label,
                     per_block=False):
    """All blocks in one launch, or (``per_block``) one launch per block
    as ``BlockedDaemon`` makes them, each held against the plain version;
    with ``per_block`` every time, the bytes and the bound are per launch,
    the mean over all blocks launched one after another."""
    import torch

    from repro_torch.kernels import edge_block as ebk

    dev = state.device
    vids = torch.from_numpy(bs.vids).to(dev).long()
    lsrc = torch.from_numpy(bs.lsrc).to(dev)
    ldst = torch.from_numpy(bs.ldst).to(dev)
    w = torch.from_numpy(bs.weights).to(dev)
    emask = (torch.from_numpy(bs.emask).to(dev)
             & active[torch.from_numpy(bs.gsrc).to(dev).long()])
    vstate = state[vids].contiguous()
    vaux = aux[vids].contiguous()
    emf = emask.to(torch.float32)
    args = (vstate, vaux, lsrc, ldst, w, emf)
    nb, b = lsrc.shape
    calls = ([tuple(x[i:i + 1].clone() for x in args) for i in range(nb)]
             if per_block else [args])
    max_abs, tol = 0.0, tolerance(program.monoid.name)
    for i, c in enumerate(calls):
        got, got_c = ebk.edge_block(*c, program=program)
        want, want_c = ebk.edge_block_plain(*c, program=program)
        torch.cuda.synchronize()
        max_abs = max(max_abs, compare(f"edge_block/{label}/{i}", got, want,
                                       got_c, want_c, program.monoid.name)[0])

    def each(fn):
        return lambda: [fn(*c, program=program) for c in calls]

    launches = len(calls)
    ms = cuda_time_ms(each(ebk.edge_block)) / launches
    # back-to-back small launches wait on the host: their device time alone
    device_ms, host_ahead = queued_ms(each(ebk.edge_block))
    plain_ms = cuda_time_ms(each(ebk.edge_block_plain), reps=5) / launches
    vb, k, a = vstate.shape[1], vstate.shape[2], vaux.shape[2]
    live_src = torch.unique(
        (torch.arange(nb, device=dev)[:, None] * vb + lsrc)[emask])
    nbytes = (edge_bytes(emask) + live_src.numel() * (k + aux_read(
        program)) * 4 + nb * vb * (k + 1) * 4) // launches
    ops = int(emask.sum()) * k * 2 // launches
    msgs = program.msg_gen(
        torch.take_along_dim(vstate, lsrc.long()[..., None], 1
                             ).reshape(-1, k),
        None, w.reshape(-1, 1),
        torch.take_along_dim(vaux, lsrc.long()[..., None], 1).reshape(-1, a))
    if per_block:
        msgs = msgs.reshape(nb, b, k)
        parts = [(msgs[i], ldst[i], emask[i], vb) for i in range(nb)]
    else:
        seg = ldst.long() + torch.arange(nb, device=dev)[:, None] * vb
        parts = [(msgs, seg.reshape(-1), emask.reshape(-1), nb * vb)]
    library_ms = library_merge_ms(parts, program.monoid) / launches
    return dict(kernel="edge_block", case=label, blocks=nb, B=b, VB=vb, K=k,
                A=a, live_edges=int(emask.sum()), launches_timed=launches,
                max_abs_err=max_abs, tolerance=tol,
                kernel_ms=ms, launches_per_s=1e3 / ms,
                device_ms=device_ms / launches, host_ahead=host_ahead,
                plain_ms=plain_ms,
                library_ms=library_ms, bytes=nbytes, ops=ops,
                **bound(nbytes, ops))


def tol_share(got, want, rtol, atol):
    """|got − want|, its share of atol + rtol·|want| per element, and the
    count of elements whose share is above 1."""
    err = (got.float() - want.float()).abs()
    share = err / (atol + rtol * want.float().abs()).clamp_min(LIVE_MIN)
    return err, share, int((share > 1).sum())


def check_close(name, got, want, *, rtol=0.0, atol=None,
                live=False) -> dict:
    """Raises unless |got − want| ≤ atol + rtol·|want| at every element
    (``atol`` by default F32_RTOL · max(1, max |want|)), on another shape
    or dtype, or on a non-finite value.  With ``live`` it also raises if
    some |want| is below LIVE_MIN, where a relative check says nothing.
    Returns the max |Δ|, the largest share of its element's tolerance
    that any |Δ| takes (``tol_share``, ≤ 1 to pass), the tolerance and the
    range of |want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}, "
                             f"expected {want.dtype} {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite values")
    gf, wf = got.float(), want.float()
    mag = wf.abs()
    if atol is None:
        atol = F32_RTOL * max(1.0, float(mag.max()))
    if live and float(mag.min()) < LIVE_MIN:
        raise AssertionError(f"{name}: |want| down to {float(mag.min())}, "
                             f"below {LIVE_MIN}: the check is not live")
    err, share, over = tol_share(gf, wf, rtol, atol)
    if over:
        raise AssertionError(f"{name}: |Δ| above {atol} + {rtol}·|want| at "
                             f"{over} elements (max |Δ| {float(err.max())})")
    return {"max_abs_err": float(err.max()), "tol_share": float(share.max()),
            "atol": atol, "rtol": rtol, "want_abs_min": float(mag.min()),
            "want_abs_max": float(mag.max())}


def phase_attention(label, b, hq, hkv, s, d, dtype_name, causal, seed):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    # the main path: the entry point, counted alone
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    if launches == 0:
        raise AssertionError(f"attention/{label}: kernel never launched")
    want = ops.flash_attention(q, k, v, causal=causal, impl="reference")
    tol = (dict(rtol=BF16_RTOL, atol=BF16_ATOL) if dtype == torch.bfloat16
           else {})
    chk = check_close(f"attention/{label}", out, want, **tol)
    # SDPA against the same reference and tolerance: information, no check
    sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)
    _, share, over = tol_share(sdpa, want, chk["rtol"], chk["atol"])
    sdpa_chk = {"tol_share": float(share.max()), "elements_over": over,
                "elements": want.numel()}
    del want, sdpa, share
    kernel_ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v,
                                                        causal=causal),
                             reps=10, warmup=2)
    entry_ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v,
                                                        causal=causal),
                            reps=10, warmup=2)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=causal), reps=3, warmup=1)
    library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True))
    pairs = s * (s + 1) // 2 if causal else s * s
    ops_count = 4 * d * pairs * b * hq
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    if dtype == torch.bfloat16:
        rate, tc_ops, extra = BF16_OPS_PER_S, ops_count, {}
    else:
        rate, tc_ops = TF32_OPS_PER_S, TF32_PRODUCTS * ops_count
        extra = {"tensor_core_ops": tc_ops,
                 "bound_basis": f"{TF32_PRODUCTS} TF32 products per matrix "
                                f"product at {TF32_OPS_PER_S:.3g} flop/s",
                 "fma_bound_ms": bound(nbytes, ops_count)["bound_ms"]}
    return dict(
        phase="attention", case=label, B=b, Hq=hq, Hkv=hkv, S=s, D=d,
        dtype=dtype_name, causal=causal, launches=launches,
        first_call_s=first_s, max_abs_err=chk["max_abs_err"], check=chk,
        library_check=sdpa_chk,
        kernel_ms=kernel_ms, entry_ms=entry_ms, plain_ms=plain_ms,
        library_ms=library_ms,
        library_call="scaled_dot_product_attention(enable_gqa=True)",
        bytes=nbytes, ops=ops_count, ops_per_s=rate, **extra,
        **bound(nbytes, tc_ops, rate))


def library_sass() -> str:
    """``cuobjdump -sass`` of the built library."""
    from repro_torch.kernels import build

    return subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass", str(build.library_path())],
        capture_output=True, text=True, check=True).stdout


def sass_functions(sass: str, pattern: str):
    """(name, body) of each function in ``sass`` whose name matches."""
    import re

    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        if re.search(pattern, name):
            yield name.strip(), body


def attn_instance(name: str) -> str:
    """An attention kernel's template arguments from its mangled name:
    "D<head dim>/causal" or "D<head dim>/full"."""
    import re

    d, causal = re.search(r"ILi(\d+)ELb([01])E", name).groups()
    return f"D{d}/{'causal' if causal == '1' else 'full'}"


def sass_counts(sass: str):
    """Counts of SASS_OPS in each bf16 attention kernel of the built library,
    keyed by ``attn_instance``; raises if one lacks either."""
    import re

    counts = {}
    for name, body in sass_functions(sass, SASS_KERNEL):
        counts[attn_instance(name)] = {
            op: len(re.findall(rf"\b{op}\b", body)) for op in SASS_OPS}
    if not counts:
        raise AssertionError(f"no {SASS_KERNEL} in the library's SASS")
    for key, c in counts.items():
        if not all(c.values()):
            raise AssertionError(f"{SASS_KERNEL} {key}: SASS counts {c}")
    return counts


def ssd_instance(name: str) -> str:
    """An SSD chunk kernel's template argument from its mangled name:
    "P<head dim>"."""
    import re

    return "P" + re.search(r"ILi(\d+)EE", name).group(1)


def tf32_mma_counts(sass: str, kernel: str = F32_SASS_KERNEL,
                    instance=attn_instance):
    """Count of TF32 ``HMMA`` instructions in each instantiation of
    ``kernel`` in the built library, keyed by ``instance`` of its name;
    raises if there is none or one has none."""
    import re

    counts = {instance(name): len(re.findall(TF32_HMMA, body))
              for name, body in sass_functions(sass, kernel)}
    if not counts:
        raise AssertionError(f"no {kernel} in the library's SASS")
    for key, c in counts.items():
        if not c:
            raise AssertionError(f"{kernel} {key}: no TF32 HMMA")
    return counts


def red_counts(sass: str):
    """The reductions (``RED``/``ATOM`` mnemonics and their counts) in each
    sum instantiation of the edge-block kernel at K=1; raises unless each
    has some and every one is the vector RED_VECTOR form."""
    import re

    counts = {}
    for name, body in sass_functions(sass, RED_KERNEL):
        ops = {}
        for op in re.findall(r"\b((?:RED|ATOM)[A-Za-z0-9_.]*)", body):
            ops[op] = ops.get(op, 0) + 1
        counts[name] = ops
        if not ops or any(RED_VECTOR not in op for op in ops):
            raise AssertionError(f"{name}: reductions {ops}, expected only "
                                 f"{RED_VECTOR}")
    if not counts:
        raise AssertionError(f"no {RED_KERNEL} in the library's SASS")
    return counts


def ssd_inputs(seed, dt_range=None):
    """x, dt, a, B, C at mamba2-1.3b width, from ``seed``: as
    tests/test_kernels.py makes them (0.5·N(0,1) x, softplus(N(0,1)) dt,
    a = −exp(0.3·N(0,1)), 0.3·N(0,1) B and C), or with dt log-uniform in
    ``dt_range``."""
    import torch

    dev = torch.device("cuda")
    b, s, h, p, g, n = (SSD[k] for k in ("b", "s", "h", "p", "g", "n"))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = 0.5 * randn(b, s, h, p)
    if dt_range is None:
        dt = torch.nn.functional.softplus(randn(b, s, h))
    else:
        lo, hi = (math.log(v) for v in dt_range)
        dt = torch.exp(lo + (hi - lo) * torch.rand(
            (b, s, h), generator=gen, device=dev))
    a = -torch.exp(0.3 * randn(h))
    return x, dt, a, 0.3 * randn(b, s, g, n), 0.3 * randn(b, s, g, n)


def check_ssd(label, y, inputs, live) -> tuple[dict, float, tuple]:
    """``y`` of ``ops.ssd_scan`` against ``impl="reference"`` and the
    sequential ``ref.ssd_scan_reference``, and ``ssd_chunk`` against
    ``ssd_chunk_plain`` on all four outputs.  With ``live``, decay and gate
    are held per element within F32_RTOL·|want| (and must be normal
    floats).  Returns the checks, the sequential reference's seconds and
    the chunk step's arguments."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd

    b, s, h, p, g, n, chunk = (SSD[k] for k in ("b", "s", "h", "p", "g", "n",
                                                "chunk"))
    nc = s // chunk
    x, dt, a, bm, cm = inputs
    checks = {}
    y_ref = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk, impl="reference")
    checks["y_vs_reference"] = check_close(f"ssd/{label}/y vs reference", y,
                                           y_ref)
    del y_ref
    t0 = time.perf_counter()
    y_seq = ref.ssd_scan_reference(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    checks["y_vs_sequential"] = check_close(f"ssd/{label}/y vs sequential",
                                            y, y_seq)
    del y_seq
    args = (x.reshape(b, nc, chunk, h, p), dt.reshape(b, nc, chunk, h), a,
            bm.reshape(b, nc, chunk, g, n), cm.reshape(b, nc, chunk, g, n))
    got = ssd.ssd_chunk(*args)
    want = ssd.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    for name, gt, wt in zip(("y", "state", "decay", "gate"), got, want):
        tol = (dict(rtol=F32_RTOL, atol=0.0, live=True)
               if live and name in ("decay", "gate") else {})
        checks[f"chunk_{name}"] = check_close(
            f"ssd/{label}/ssd_chunk {name}", gt, wt, **tol)
    return checks, seq_s, args


def phase_ssd(seed):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    b, s, h, p, g, n, chunk = (SSD[k] for k in ("b", "s", "h", "p", "g", "n",
                                                "chunk"))
    nc = s // chunk
    inputs = ssd_inputs(seed)
    # the main path: the entry point, counted alone
    ssd.ssd_chunk.launches = 0
    t0 = time.perf_counter()
    y = ops.ssd_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ssd.ssd_chunk.launches
    if launches == 0:
        raise AssertionError("ssd: kernel never launched")
    checks, seq_s, args = check_ssd("test_kernels-inputs", y, inputs,
                                    live=False)
    del y
    kernel_ms = cuda_time_ms(lambda: ssd.ssd_chunk(*args))
    entry_ms = cuda_time_ms(lambda: ops.ssd_scan(*inputs, chunk=chunk))
    plain_ms = cuda_time_ms(lambda: ssd.ssd_chunk_plain(*args), reps=3,
                            warmup=1)
    del args
    # decay and gate live: dt in Mamba2's range, a second seed
    live_inputs = ssd_inputs(seed + 1, SSD_DT_RANGE)
    live_checks, _, _ = check_ssd(
        "mamba2-dt-range", ops.ssd_scan(*live_inputs, chunk=chunk),
        live_inputs, live=True)
    del live_inputs
    # C·Bᵀ once per (batch, chunk, group); per (batch, chunk, head) the
    # gated product with x and the state
    tri = chunk * (chunk + 1) // 2
    ops_count = (b * nc * g * 2 * n * tri
                 + b * nc * h * (2 * p * tri + 2 * chunk * n * p))
    # x, y; states; dt, gate; B, C read by group; decay; a
    nbytes = 4 * (2 * b * s * h * p + b * nc * h * n * p + 2 * b * s * h
                  + 2 * b * s * g * n + b * nc * h + h)
    every = {**checks, **{f"live_{k}": v for k, v in live_checks.items()}}
    tc_ops = TF32_PRODUCTS * ops_count
    return dict(
        phase="ssd", case="mamba2-1.3b/f32", launches=launches,
        first_call_s=first_s, sequential_reference_s=seq_s,
        **SSD, dt_range_live=SSD_DT_RANGE,
        max_abs_err=max(c["max_abs_err"] for c in every.values()),
        checks=every,
        kernel_ms=kernel_ms, entry_ms=entry_ms, plain_ms=plain_ms,
        library_ms=None,
        library_note="no single PyTorch call computes the SSD chunk step",
        bytes=nbytes, ops=ops_count, ops_per_s=TF32_OPS_PER_S,
        tensor_core_ops=tc_ops,
        bound_basis=f"{TF32_PRODUCTS} TF32 products per matrix product at "
                    f"{TF32_OPS_PER_S:.3g} flop/s",
        fma_bound_ms=bound(nbytes, ops_count)["bound_ms"],
        **bound(nbytes, tc_ops, TF32_OPS_PER_S))


# the tensor methods that bring a tensor to the host (``to`` only when its
# target is the CPU)
FETCHES = ("cpu", "tolist", "item", "__bool__", "__int__", "__float__",
           "__index__")


@contextlib.contextmanager
def counting_fetches(calls: list):
    """Appends (method, numel) to ``calls`` for each call that brings a CUDA
    tensor to the host, while the block runs."""
    import torch

    def counted(name, orig):
        def method(self, *args, **kwargs):
            if self.is_cuda:
                calls.append((name, self.numel()))
            return orig(self, *args, **kwargs)
        return method

    def to(self, *args, **kwargs):
        target = kwargs.get("device", args[0] if args else None)
        if (self.is_cuda and isinstance(target, (str, torch.device))
                and torch.device(target).type == "cpu"):
            calls.append(("to", self.numel()))
        return saved["to"](self, *args, **kwargs)

    saved = {name: getattr(torch.Tensor, name) for name in FETCHES + ("to",)}
    try:
        for name in FETCHES:
            setattr(torch.Tensor, name, counted(name, saved[name]))
        torch.Tensor.to = to
        yield calls
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)


def fused_profile(mw, frontier=None) -> dict:
    """Device time per CUDA kernel (and memset/memcpy) per iteration over
    one run, and the device's busy and idle share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = mw.run(frontier=frontier)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    its = res.iterations
    per_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us:
            per_kernel[ev.key[:100]] = us / its
    busy_s = sum(per_kernel.values()) * 1e-6 * its
    top = dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8])
    return {"iterations": its, "wall_s": wall,
            "device_busy_s_per_iteration": busy_s / its,
            "device_idle_share": 1.0 - busy_s / wall,
            "kernels": len(per_kernel),
            "top_device_us_per_iteration": top}


def fused_parts_ms(mw, state, aux, active) -> dict:
    """The fused step's parts at one iteration's inputs, each timed alone."""
    import torch

    from repro_torch.core.template import segment_sum
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels import ops
    from repro_torch.plug.daemons import _CSR_FIELDS
    from repro_torch.plug.middleware import apply_step

    prog, n, k = mw.program, mw.n, mw.program.state_width
    monoid = prog.monoid
    loop = mw._loop
    stacked = mw.daemon.stacked
    c = stacked["csr"]
    act = active if loop._use_frontier else None

    def mask():
        em = c["emask"] & act[c["gsrc"]] if act is not None else c["emask"]
        return em, em.any(dim=2).sum(dim=1, dtype=torch.int32)

    em, _ = mask()
    csr = {f: c[f].flatten(0, 1) for f in _CSR_FIELDS}
    csr["emask"] = em.flatten(0, 1)
    aux1 = ops._pad_aux(state, aux)

    def casts():
        return (csr["svids"].long(), csr["rows"].long(),
                csr["emask"].to(torch.float32))

    svids, rows, emf = casts()

    def gather():
        return state[svids], aux1[svids]

    vsrc, vaux = gather()
    # as csr_aggregate hands it: only the plain version reads dst rows
    rowst = (state[rows] if state.device.type == "cpu"
             else state.new_zeros(()).expand(*rows.shape, k))

    def kernel():
        return ebk.csr_tile(vsrc, vaux, rowst, csr["lsrc"], csr["seg"],
                            csr["w"], emf, program=prog)

    partial, counts = kernel()
    flat = rows.reshape(-1)

    def combine():
        agg = monoid.segment_reduce(partial.reshape(-1, k), flat, n)
        cnt = segment_sum(counts.reshape(-1), flat, n)
        return torch.where((cnt > 0)[:, None], agg,
                           torch.full_like(agg, monoid.identity)), cnt

    agg, cnt = combine()
    live = torch.nonzero(counts.reshape(-1) > 0).reshape(-1)
    live_rows = flat[live]

    def combine_live_rows():
        agg = monoid.segment_reduce(partial.reshape(-1, k)[live], live_rows,
                                    n)
        cnt = segment_sum(counts.reshape(-1)[live], live_rows, n)
        return torch.where((cnt > 0)[:, None], agg,
                           torch.full_like(agg, monoid.identity)), cnt

    agg_live, cnt_live = combine_live_rows()
    if not (torch.equal(cnt_live, cnt) and (
            torch.equal(agg_live, agg) if monoid.idempotent
            else torch.allclose(agg_live, agg, rtol=SUM_RTOL,
                                atol=SUM_ATOL))):
        raise AssertionError("fused parts: the combine over live rows "
                             "differs from the combine")

    def gather_index_select():
        flat_ids = svids.reshape(-1)
        return (state.index_select(0, flat_ids).view(*svids.shape, k),
                aux1.index_select(0, flat_ids).view(*svids.shape, -1))

    cols = torch.arange(k, device=state.device)
    acols = torch.arange(aux1.shape[1], device=state.device)

    def gather_flat():
        ids = svids[..., None]
        return (state.reshape(-1)[ids * k + cols],
                aux1.reshape(-1)[ids * aux1.shape[1] + acols])

    for variant in (gather_index_select, gather_flat):
        if not all(torch.equal(a, b) for a, b in zip(variant(), gather())):
            raise AssertionError(f"fused parts: {variant.__name__} differs "
                                 "from the gathers")

    def merge():
        return mw.upper.merge_partials(agg[None], cnt[None])

    def apply():
        new, new_active = apply_step(prog, state, agg, cnt > 0, aux, 1)
        n_active = new_active.sum()
        return torch.cat([torch.stack([(n_active == 0).long(), n_active]),
                          torch.zeros(SHARDS, dtype=torch.long,
                                      device=state.device)])

    flags = apply()
    return {
        "mask_and_tiles_run": cuda_time_ms(mask),
        "index_casts": cuda_time_ms(casts),
        "gathers": cuda_time_ms(gather),
        "csr_tile": cuda_time_ms(kernel),
        "cross_tile_combine": cuda_time_ms(combine),
        "cross_tile_combine_live_rows": cuda_time_ms(combine_live_rows),
        "padded_row_share": 1.0 - live.numel() / flat.numel(),
        "gathers_index_select": cuda_time_ms(gather_index_select),
        "gathers_flat": cuda_time_ms(gather_flat),
        "merge_partials": cuda_time_ms(merge),
        "apply_and_flags": cuda_time_ms(apply),
        "fetch": cuda_time_ms(flags.tolist),
        "whole_step": cuda_time_ms(lambda: loop._advance(
            (state, active), aux, 1, stacked)[1].tolist()),
        "tiles": int(c["lsrc"].shape[0] * c["lsrc"].shape[1]),
        "ET": int(c["lsrc"].shape[2]), "RT": int(c["rows"].shape[2]),
        "ST": int(c["svids"].shape[2]),
    }


def pinned_csr_daemon():
    """``daemon="cuda"`` with its CSR config pinned to ``CSRConfig()`` (the
    tile kernel at edge tile 512), as every phase before 5d runs it."""
    from repro_torch import plug
    from repro_torch.kernels.ops import CSRConfig

    return plug.VectorizedDaemon(kernel="cuda", csr_config=CSRConfig())


def check_state(label, state, ref, tol) -> float:
    """A run's state against ``run_reference``'s: the same shape, finite,
    and bit-equal (``tol`` None) or within ``tol`` = (rtol, atol).
    Returns max |Δ|."""
    import numpy as np

    state, ref = np.asarray(state), np.asarray(ref)
    if state.shape != ref.shape:
        raise AssertionError(f"{label}: state shape {state.shape}")
    if not np.isfinite(state).all():
        raise AssertionError(f"{label}: non-finite state")
    if tol is None:
        if not np.array_equal(state, ref):
            raise AssertionError(f"{label}: not bit-equal to run_reference")
        return 0.0
    rtol, atol = tol
    max_abs = float(np.abs(state - ref).max())
    if not np.allclose(state, ref, rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: outside rtol={rtol} atol={atol} "
                             f"of run_reference (max abs {max_abs})")
    return max_abs


def run_e2e(label, graph, program, daemon, model, parts, ref_state, sum_tol,
            device="cuda", upper="host", options=None, max_iterations=None,
            on_timed=None, frontier=None, num_shards=1):
    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.kernels import edge_block as ebk

    t0 = time.perf_counter()
    mw = plug.Middleware(graph, program, daemon=daemon, upper=upper,
                         model=model, partitions=parts, options=options,
                         num_shards=num_shards, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # one warm-up iteration: the daemon compacts each shard's CSR tiles on
    # its first call (the fused daemon in the constructor), which is set-up
    # and stays out of the timed run
    mw.run(max_iterations=1, frontier=frontier)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    fetches: list = []
    ebk.edge_block.launches = 0
    ebk.csr_tile.launches = 0
    if on_timed is not None:
        on_timed()
    if mw._fused:
        with counting_fetches(fetches):
            res = mw.run(max_iterations, frontier=frontier)
    else:
        res = mw.run(max_iterations, frontier=frontier)
    torch.cuda.synchronize()
    launches = {"edge_block": ebk.edge_block.launches,
                "csr_tile": ebk.csr_tile.launches}
    max_abs = check_state(label, res.state, ref_state, sum_tol)
    its = max(res.iterations, 1)
    fused = {}
    if mw._fused:
        big = [c for c in fetches if c[1] >= graph.num_vertices]
        fused = dict(fused_kind=mw._fused_kind, init_s=init_s,
                     fetches_per_iteration=(len(fetches) - len(big)) / its,
                     vertex_sized_fetches=len(big),
                     fetch_methods=sorted({c[0] for c in fetches}))
    return res, launches, mw, dict(
        phase="e2e", run=label, **fused, setup_s=setup_s,
        iterations=res.iterations,
        converged=res.converged, wall_s=res.wall_time,
        per_iteration_s=res.wall_time / max(res.iterations, 1),
        daemon_busy_s=sum(sum(r.get("shard_busy_s", ()))
                          for r in res.per_iteration),
        max_abs_err_vs_reference=max_abs, launches=launches,
        launches_per_iteration={k: v / max(res.iterations, 1)
                                for k, v in launches.items()},
        rounds_skipped=res.stats.rounds_skipped)


def stage_summary(res, key) -> dict:
    """Sums over a run's executor records (``"pipeline"`` or
    ``"sequential"``, one per shard an iteration): wall time, each stage's
    host busy time and each stage's event-timed device span."""
    from repro_torch.core.pipeline import STAGES

    recs = [r for it in res.per_iteration for r in it.get(key, ())]
    if not recs or any("device" not in r for r in recs):
        raise AssertionError(f"no {key!r} records with device stage times")
    return {"records": len(recs),
            "wall_time_s": sum(r["wall_time"] for r in recs),
            "busy_s": {s: sum(r["busy"][s] for r in recs) for s in STAGES},
            "device_s": {s: sum(r["device"][s] for r in recs)
                         for s in STAGES}}


def daemon_seconds(res, key, iterations) -> float:
    """The executors' wall time over a run's first ``iterations``."""
    return sum(r["wall_time"] for it in res.per_iteration[:iterations]
               for r in it.get(key, ()))


# phase 5h: out-of-core execution.  The budget is a quarter of the resident
# CSR columns' bytes per logical device (benchmarks/bench_accel.py's div=4),
# a quarter of it the hot set's.
OOCORE_DIV = 4
OOCORE_HOT = 0.25
OOCORE_KILL = [(3, 3)]  # device 3 dies before iteration 3: 4 → 2
ROAD_SIDE = 1024        # grid_road(1024): 1,048,576 vertices, a metro road net
ROAD_SEED = 1
ROAD_ITERATIONS = 60
OOCORE_EPS_S = 2e-6     # a copy's two events' grain (0.5 µs each, twice)
_OOCORE_SUMS = ("iterations", "transfer_s", "wait_s", "hidden_s", "hot_hits",
                "cold_misses", "uploads", "upload_bytes", "skipped")


def oocore_plan(label, mw) -> dict:
    """The binding's plan, checked: the hot set's device bytes are
    m × hot_cols × col_bytes_dev."""
    import dataclasses

    d = mw.daemon
    plan = d.oocore_plan
    hot = (0 if d.hot_stacked is None else
           sum(t.numel() * t.element_size()
               for t in d.hot_stacked["csr"].values()))
    if hot != d.m * plan.hot_cols * plan.col_bytes_dev:
        raise AssertionError(f"{label}: hot set {hot} bytes on the device, "
                             f"plan {d.m} × {plan.hot_cols} × "
                             f"{plan.col_bytes_dev}")
    return {**dataclasses.asdict(plan), "m": d.m,
            "fields": sorted(d._cold[0]) if d._cold else [],
            "hot_bytes_device": hot,
            "super_shard_bytes_dev": plan.super_shard_bytes_dev,
            "resident_bytes_dev": plan.resident_bytes_dev,
            "upload_bytes": d.super_shard_nbytes}


def oocore_run(label, mw, ref, tol, ref_it, resident, *,
               max_iterations=None, expect_kill=False,
               profile=False) -> tuple:
    """One probed run of phase 5h on an out-of-core middleware, after a
    warm-up iteration: the state against ``run_reference`` and against
    ``resident`` (phase 5e's ``mesh=4`` run of the same program, or (f)'s;
    (label, state, s an iteration)), the iterations against ``ref_it``;
    in every iteration one small fetch in the step and none in a rebuild,
    ``csr_tile`` launched (hot set > 0) + uploads times (none for the flat
    merge), hot hits + cold misses = blocks run, wait ≤ transfer (raw,
    to the events' grain) and overlap ≤ 1 (exactly 0, and no skip, without
    prefetch); over the run uploads + skipped = Σ super-shards, at most two
    groups live in at most two slots of one group's bytes (one without
    prefetch) and one vertex-sized fetch.  The device's peak allocation
    over the run's start (no cold group live then) goes in the line as
    ``peak_bytes_over_base``.  ``profile`` adds phase 5b's ``profile`` of one
    more run.  Returns its line and its csr_tile launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import edge_block as ebk

    n = mw.n
    flat = mw.daemon._csr_config.merge == "flat"
    mw.run(max_iterations=1)
    # no cold group live: the base holds the hot set and everything else
    # of the process, the peak over it the run's slots and working set
    if mw._loop._uploader is not None:
        mw._loop._uploader.close()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = {k: mw.oocore_stats.get(k, 0) for k in _OOCORE_SUMS}
    calls, its = [], []
    probe_loop(mw, calls, its)
    l0 = ebk.csr_tile.launches
    try:
        with counting_fetches(calls):
            res = mw.run(max_iterations)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    finally:  # the probe's wrappers go: the next run probes afresh
        for obj, name in ((mw, "_poll_structure"),
                          (mw._loop, "_adopt_epoch"),
                          (mw._loop, "_advance"), (mw._loop, "_read_extra")):
            vars(obj).pop(name, None)
    launched = ebk.csr_tile.launches - l0
    st = mw.oocore_stats
    d = {k: st[k] - before[k] for k in _OOCORE_SUMS}
    recs = [r["oocore"] for r in res.per_iteration]
    if len(its) != res.iterations or d["iterations"] != res.iterations:
        raise AssertionError(f"{label}: {len(its)} probed iterations, "
                             f"{d['iterations']} counted, of "
                             f"{res.iterations}")
    for i, r, oc in zip(its, res.per_iteration, recs):
        where = f"{label}: iteration {i['iteration']}"
        if len(i["step_fetches"]) != 1 or i["step_fetches"][0][1] >= n:
            raise AssertionError(f"{where}: step fetches {i['step_fetches']}")
        if i["rebuild_fetches"]:
            raise AssertionError(f"{where}: rebuild fetches "
                                 f"{i['rebuild_fetches']}")
        uploads = oc["super_shards"] - oc["skipped"]
        want = 0 if flat else int(oc["hot_cols"] > 0) + uploads
        if i["csr_tile"] != want:
            raise AssertionError(f"{where}: csr_tile launched "
                                 f"{i['csr_tile']} times, expected {want}")
        if oc["hot_hits"] + oc["cold_misses"] != r["blocks_run"]:
            raise AssertionError(f"{where}: hot hits {oc['hot_hits']} + "
                                 f"cold misses {oc['cold_misses']} != "
                                 f"blocks run {r['blocks_run']}")
        # raw readings: a wait past its transfers (overlap below 0 by more
        # than the events' grain) is a mis-paired or mis-timed event
        if (oc["wait_s"] > oc["transfer_s"] + OOCORE_EPS_S * (uploads + 1)
                or oc["overlap_efficiency"] > 1.0):
            raise AssertionError(f"{where}: wait {oc['wait_s']} s, "
                                 f"transfer {oc['transfer_s']} s, overlap "
                                 f"{oc['overlap_efficiency']}")
        if not oc["prefetch"] and (oc["skipped"] or oc["hidden_s"] != 0.0
                                   or oc["overlap_efficiency"] != 0.0):
            raise AssertionError(f"{where}: without prefetch {oc}")
    big = [c for c in calls if c[1] >= n]
    if big != [("cpu", n * mw.k)]:
        raise AssertionError(f"{label}: vertex-sized fetches {big}")
    if d["uploads"] + d["skipped"] != sum(oc["super_shards"] for oc in recs):
        raise AssertionError(f"{label}: uploads {d['uploads']} + skipped "
                             f"{d['skipped']} over {res.iterations} "
                             "iterations")
    up = mw._loop._uploader  # this run's: each run arms its own
    live = up.max_live_groups if up is not None else 0
    if live > 2 or (up is not None and not up.prefetch and live != 1):
        raise AssertionError(f"{label}: {live} groups live")
    slots = up.slot_allocations if up is not None else 0
    slot_bytes = up.slot_bytes if up is not None else 0
    if (slots > (2 if up is not None and up.prefetch else 1)
            or slot_bytes != slots * mw.daemon.super_shard_nbytes):
        raise AssertionError(f"{label}: {slots} slots of {slot_bytes} "
                             f"bytes, a group {mw.daemon.super_shard_nbytes}")
    if res.iterations != ref_it:
        raise AssertionError(f"{label}: {res.iterations} iterations, "
                             f"reference ran {ref_it}")
    max_abs = check_state(label, res.state, ref, tol)
    r_label, r_state, r_s = resident
    max_abs_res = check_state(f"{label} against {r_label}", res.state,
                              r_state, tol)
    migs = [r["migration"] for r in res.per_iteration if "migration" in r]
    if expect_kill != bool(migs):
        raise AssertionError(f"{label}: migrations {migs}")
    steps = [i["step_s"] for i in its]
    transfer, wait = d["transfer_s"], d["wait_s"]
    seen = d["hot_hits"] + d["cold_misses"]
    per_it = res.wall_time / res.iterations
    rec = {"run": label, "prefetch": recs[0]["prefetch"],
           "iterations": res.iterations, "converged": res.converged,
           "s_per_iteration": per_it,
           "median_step_s": sorted(steps)[len(steps) // 2],
           "resident_run": r_label, "resident_per_iteration_s": r_s,
           "over_resident": per_it / r_s,
           "transfer_s": transfer, "wait_s": wait, "hidden_s": d["hidden_s"],
           "overlap_efficiency": (1.0 - wait / transfer
                                  if transfer > 0 else None),
           "uploads": d["uploads"], "skipped": d["skipped"],
           "skipped_per_iteration": [oc["skipped"] for oc in recs],
           "upload_gb": d["upload_bytes"] / 1e9,
           "copy_gb_per_s": (d["upload_bytes"] / transfer / 1e9
                             if transfer > 0 else None),
           "hot_hit_rate": d["hot_hits"] / seen if seen else None,
           "max_live_groups": live,
           "slots": slots, "slot_bytes": slot_bytes,
           "peak_bytes_over_base": peak,
           "csr_tile": launched,
           "csr_tile_per_iteration": [i["csr_tile"] for i in its],
           "max_abs_err_vs_reference": max_abs,
           "max_abs_err_vs_resident": max_abs_res}
    if migs:
        rec["migration"] = {k: migs[0][k] for k in (
            "killed", "devices_before", "devices_after", "seconds")}
    if profile:
        prof = fused_profile(mw)
        rec.update(profile=prof, device_idle_share_unprofiled=(
            1.0 - prof["device_busy_s_per_iteration"] / per_it))
    return rec, launched


def phase_oocore(g, parts, pr, sp, refs, resident4, autotuned) -> tuple:
    """Phase 5h: out-of-core execution at ``mesh=SHARDS`` with
    ``CSRConfig()`` pinned, on phase 3's graph and shards, under a budget of
    a quarter of the resident CSR columns' bytes per logical device
    (``resident4``: phase 5e's runs, name → (label, state, s an iteration,
    those bytes); ``autotuned``: phase 5d's sssp_bf run, (label, s an
    iteration)): (a) sssp_bf GAS with prefetch, (b) the same without,
    (c) pagerank BSP, (d) sssp_bf with device 3 killed before iteration 3,
    then ``oocore_replan`` to half the budget and a second run, (e)
    sssp_bf at the config phase 5d memoized (no sweep), (f) sssp_bf on
    ``grid_road(1024)`` for 60 iterations with and without prefetch.
    (a), (b) and (d) share one middleware (a re-plan switches prefetch),
    and (f)'s two arms another.  Returns the phase's line and its
    csr_tile launches."""
    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.graph import generate
    from repro_torch.graph.algorithms import sssp_bf
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ops import CSRConfig

    sweeps = autotune.CACHE.sweeps
    sp_ref, sp_it = refs[sp.name]
    pr_ref, pr_it = refs[pr.name]
    res_sp, res_pr = (resident4[p.name][:3] for p in (sp, pr))
    budget = resident4[sp.name][3] // OOCORE_DIV
    out = {"phase": "oocore", "m": SHARDS, "runs": [],
           "budget": {"csr_bytes_per_device": resident4[sp.name][3],
                      "hbm_budget": budget, "hot_fraction": OOCORE_HOT},
           "reduced": {"road": f"grid_road({ROAD_SIDE}) runs "
                       f"{ROAD_ITERATIONS} iterations (against "
                       "run_reference cut there), as bench_accel's "
                       "out-of-core table does"}}
    launches_tile = 0

    def config(b, prefetch=True):
        return plug.OocoreConfig(hbm_budget=b, hot_fraction=OOCORE_HOT,
                                 prefetch=prefetch)

    def make(graph, prog, model, b, partitions, csr_config=CSRConfig(),
             **kw):
        t0 = time.perf_counter()
        mw = plug.Middleware(
            graph, prog, daemon=plug.ShardedDaemon(
                kernel="cuda", mesh=SHARDS, csr_config=csr_config),
            upper=plug.MeshUpperSystem(mesh=SHARDS), model=model,
            partitions=partitions, oocore=config(b), device="cuda", **kw)
        torch.cuda.synchronize()
        if mw._fused_kind != "oocore":
            raise AssertionError(f"fused kind {mw._fused_kind}")
        return mw, time.perf_counter() - t0

    def keep(rec, launches, **extra):
        nonlocal launches_tile
        rec.update(extra)
        emit({**rec, "phase": "oocore"})
        out["runs"].append(rec["run"])
        launches_tile += launches

    def peak_check(label, pre, npf, mw):
        """With prefetch the device holds at most one slot more than
        without, besides the scheduler's gather of the cold groups' sources
        (a bool and an int32 each): copies that ran ahead of compute would
        show here as more groups."""
        n_src = mw.daemon._cold_index[0].numel()
        allow = mw.daemon.super_shard_nbytes + 5 * n_src + 2**21
        over = pre["peak_bytes_over_base"] - npf["peak_bytes_over_base"]
        out.setdefault("peak_checks", []).append(
            {"run": label, "prefetch_over_no_prefetch_bytes": over,
             "allowed_bytes": allow})
        if over > allow:
            raise AssertionError(f"{label}: prefetch peaks {over} bytes above "
                                 f"no prefetch, allowed {allow}")

    def replan(mw, cfg):
        calls = []
        with counting_fetches(calls):
            ep = mw.oocore_replan(cfg)
        torch.cuda.synchronize()
        if calls:
            raise AssertionError(f"oocore_replan fetched {calls}")
        return ep.meta["seconds"]

    # (a), (b), (d): one sssp_bf middleware, a monitor for the kill
    mw, init_s = make(g, sp, "gas", budget, parts,
                      monitor=plug.FleetMonitor(num_hosts=SHARDS,
                                                model_parallel=1))
    plan = oocore_plan("sssp_bf", mw)
    out["plan"] = plan
    rec_a, n_l = oocore_run("sssp_bf/oocore/prefetch/gas", mw, sp_ref, None,
                            sp_it, res_sp, profile=True)
    keep(rec_a, n_l, init_s=init_s, plan=plan)
    s = replan(mw, config(budget, prefetch=False))
    rec, n_l = oocore_run("sssp_bf/oocore/no-prefetch/gas", mw, sp_ref, None,
                          sp_it, res_sp)
    keep(rec, n_l, replan_s=s, plan=oocore_plan("no-prefetch", mw))
    peak_check("sssp_bf", rec_a, rec, mw)
    s = replan(mw, config(budget))
    col_bytes = mw.daemon.oocore_plan.col_bytes_dev
    mw.failures = plug.FailureSchedule(kills=OOCORE_KILL)
    rec, n_l = oocore_run("sssp_bf/oocore/kill/gas", mw, sp_ref, None, sp_it,
                          res_sp, expect_kill=True)
    mig = rec["migration"]
    if (mig["killed"], mig["devices_after"]) != ([3], 2) or (
            mw.daemon.oocore_plan.col_bytes_dev != 2 * col_bytes):
        raise AssertionError(f"kill: {mig}, col_bytes_dev "
                             f"{mw.daemon.oocore_plan.col_bytes_dev} after "
                             f"{col_bytes}")
    keep(rec, n_l, replan_s=s, plan=oocore_plan("kill", mw))
    s = replan(mw, config(budget // 2))
    rec, n_l = oocore_run("sssp_bf/oocore/kill/replan-half/gas", mw, sp_ref,
                          None, sp_it, res_sp)
    keep(rec, n_l, replan_s=s, plan=oocore_plan("replan", mw),
         hbm_budget=budget // 2)
    del mw
    torch.cuda.empty_cache()

    # (c): pagerank
    mw, init_s = make(g, pr, "bsp", budget, parts)
    rec, n_l = oocore_run("pagerank/oocore/prefetch/bsp", mw, pr_ref,
                          (PR_RTOL, PR_ATOL), pr_it, res_pr, profile=True)
    keep(rec, n_l, init_s=init_s, plan=oocore_plan("pagerank", mw))
    del mw
    torch.cuda.empty_cache()

    # (e): the config phase 5d memoized for sssp_bf: a lookup, no sweep
    mw, init_s = make(g, sp, "gas", budget, parts, csr_config=None)
    chosen = mw.daemon._csr_config
    if autotune.CACHE.sweeps != sweeps:
        raise AssertionError("(e) swept: 5d's memo did not answer")
    rec, n_l = oocore_run("sssp_bf/oocore/autotuned/gas", mw, sp_ref, None,
                          sp_it, (autotuned[0], sp_ref, autotuned[1]))
    keep(rec, n_l, init_s=init_s, chosen=chosen.label,
         plan=oocore_plan("autotuned", mw))
    del mw
    torch.cuda.empty_cache()

    # (f): the road network, where the frontier is a wavefront
    t0 = time.perf_counter()
    gr = generate.grid_road(ROAD_SIDE, seed=ROAD_SEED)
    spr = sssp_bf(gr, sources=[0, 1, 2, 3])
    parts_r = plug.HostUpperSystem().partition(gr, SHARDS)
    ref_r, ref_r_it = plug.run_reference(gr, spr,
                                         max_iterations=ROAD_ITERATIONS,
                                         device="cuda")
    out["road"] = {"side": ROAD_SIDE, "vertices": gr.num_vertices,
                   "edges": gr.num_edges, "data_s": time.perf_counter() - t0}
    label = "road/sssp_bf/sharded-cuda/mesh4/gas"
    res, launches, mw, rrec = run_e2e(
        label, gr, spr, plug.ShardedDaemon(kernel="cuda", mesh=SHARDS,
                                           csr_config=CSRConfig()),
        "gas", parts_r, ref_r, None, upper=plug.MeshUpperSystem(mesh=SHARDS),
        max_iterations=ROAD_ITERATIONS)
    check_fused_run(label, res, mw, rrec, launches, res.iterations)
    road_bytes = sum(t.numel() * t.element_size()
                     for t in mw.daemon.stacked["csr"].values()) // mw.daemon.m
    resident_r = (label, np.asarray(res.state), rrec["per_iteration_s"])
    keep(rrec, launches["csr_tile"], csr_bytes_per_device=road_bytes)
    del mw
    torch.cuda.empty_cache()
    mw, init_s = make(gr, spr, "gas", road_bytes // OOCORE_DIV, parts_r)
    road_plan = oocore_plan("road", mw)
    rec_a, n_l = oocore_run("road/sssp_bf/oocore/prefetch/gas", mw, ref_r,
                            None, ref_r_it, resident_r,
                            max_iterations=ROAD_ITERATIONS)
    if rec_a["skipped"] == 0:
        raise AssertionError("road with prefetch skipped no group")
    keep(rec_a, n_l, init_s=init_s, plan=road_plan,
         hbm_budget=road_bytes // OOCORE_DIV)
    s = replan(mw, config(road_bytes // OOCORE_DIV, prefetch=False))
    rec, n_l = oocore_run("road/sssp_bf/oocore/no-prefetch/gas", mw, ref_r,
                          None, ref_r_it, resident_r,
                          max_iterations=ROAD_ITERATIONS)
    keep(rec, n_l, replan_s=s)
    peak_check("road", rec_a, rec, mw)
    del mw
    torch.cuda.empty_cache()
    if autotune.CACHE.sweeps != sweeps:
        raise AssertionError("phase 5h swept")
    return out, launches_tile


def stage_calibration(part, program, graph) -> list:
    """Per-block stage times of ``BlockedDaemon(kernel="cuda")`` over shard
    0's edges, at each of CALIBRATION_SIZES: each stage's host time (the
    ``busy`` of ``run_sequential``: what each pipeline thread spends on a
    block, the upload's wait for its copy and its host merge included) and
    its event-timed device span, averaged over the first
    CALIBRATION_BLOCKS blocks after one warm-up block (which also makes
    the pinned buffers for the shape); and the upload's host merge cut in
    its two halves, each timed alone on one block's (VB, K) partial:
    ``Monoid.scatter_at`` into the (N, K) aggregate and ``np.add.at``
    into the counts."""
    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.core.blocks import build_blocks
    from repro_torch.core.pipeline import STAGES

    state, aux = program.init(graph)
    daemon = plug.BlockedDaemon(kernel="cuda").bind(
        program, graph.num_vertices, device="cuda")
    monoid, k = program.monoid, program.state_width
    agg = torch.full((graph.num_vertices, k), monoid.identity)
    cnt = np.zeros(graph.num_vertices, np.int64)
    rows = []
    for b in CALIBRATION_SIZES:
        bs = build_blocks(part, b)
        n = min(CALIBRATION_BLOCKS, bs.num_blocks - 1)
        daemon.run_blocks(state, aux, bs, np.arange(1), {})
        rec: dict = {}
        daemon.run_blocks(state, aux, bs, np.arange(1, n + 1), rec)
        r = rec["sequential"][0]
        vids = bs.vids[n]
        partial = torch.zeros((bs.vblock_size, k))
        counts = np.ones(bs.vblock_size, np.int32)
        t0 = time.perf_counter()
        for _ in range(MERGE_REPS):
            monoid.scatter_at(agg, torch.from_numpy(vids), partial)
        t1 = time.perf_counter()
        for _ in range(MERGE_REPS):
            np.add.at(cnt, vids, counts)
        t2 = time.perf_counter()
        rows.append({"block_size": b, "vblock_size": bs.vblock_size,
                     "blocks": n,
                     "host_s": {s: r["busy"][s] / n for s in STAGES},
                     "device_s": {s: r["device"][s] / n for s in STAGES},
                     "merge_s": {"scatter_at": (t1 - t0) / MERGE_REPS,
                                 "add_at": (t2 - t1) / MERGE_REPS}})
    return rows


def lemma1(d: int, coeffs) -> dict:
    """Lemma 1's optimum for ``d`` edges under (k1, k2, k3, a), and the
    block size ``block_size="auto"`` resolves it to (the middleware clamps
    it to 64..65,536 edges)."""
    from repro_torch.core import pipeline as pl

    res = pl.optimal_block_size(d, *coeffs)
    best_b, t = pl.optimal_integer_blocks(d, *coeffs)
    return {**dict(zip(("k1", "k2", "k3", "a"), coeffs)),
            "b_opt": res.b_opt, "case": res.case, "t_min_s": res.t_min,
            "integer_block": best_b, "eq2_s": t,
            "auto_block": int(min(max(best_b, 64), 1 << 16))}


def phase_pipeline(g, parts, pr, sp, pr_ref, pr_ref_it, sp_ref, sp_ref_it,
                   blocked, seed) -> tuple[dict, int]:
    """Phase 5c: the pipeline shuffle.  ``blocked`` is phase 5's
    ``(res, launches, rec)`` of ``BlockedDaemon(kernel="cuda")`` on sssp_bf.
    Returns the phase's line and the edge_block launches of its pipelined
    runs at scale 20."""
    from repro_torch import plug
    from repro_torch.core import pipeline as pl
    from repro_torch.graph import generate
    from repro_torch.graph.algorithms import sssp_bf

    out = {"phase": "pipeline", "reduced": {}}
    launches_pipelined = 0
    b_res, b_launches, b_rec = blocked
    # -- sssp_bf to its fixed point, and pagerank, at the defaults
    runs = (("sssp_bf/pipelined-cuda/bsp", sp, sp_ref, None, sp_ref_it),
            ("pagerank/pipelined-cuda/bsp", pr, pr_ref, (PR_RTOL, PR_ATOL),
             pr_ref_it))
    for label, prog, ref, tol, ref_it in runs:
        res, launches, _, rec = run_e2e(
            label, g, prog, plug.PipelinedDaemon(kernel="cuda"), "bsp",
            parts, ref, tol)
        if res.iterations != ref_it:
            raise AssertionError(f"{label}: {res.iterations} iterations, "
                                 f"reference ran {ref_it}")
        if launches["edge_block"] == 0 or launches["csr_tile"]:
            raise AssertionError(f"{label}: launches {launches}")
        launches_pipelined += launches["edge_block"]
        rec["stages"] = stage_summary(res, "pipeline")
        if prog is sp:
            if (res.iterations != b_res.iterations
                    or launches["edge_block"] != b_launches["edge_block"]
                    or [r["blocks_run"] for r in res.per_iteration]
                    != [r["blocks_run"] for r in b_res.per_iteration]):
                raise AssertionError(
                    f"{label}: {launches['edge_block']} edge_block launches "
                    f"over {res.iterations} iterations, the blocked daemon "
                    f"{b_launches['edge_block']} over {b_res.iterations}")
            rec["blocked_run"] = b_rec["run"]
            rec["blocked_per_iteration_s"] = b_rec["per_iteration_s"]
            rec["blocked_stages"] = stage_summary(b_res, "sequential")
            rec["pipelined_over_blocked"] = (rec["per_iteration_s"]
                                             / b_rec["per_iteration_s"])
            default_run = res
        out[label] = rec
    # -- Lemma 1's coefficients fitted on the card
    rows = stage_calibration(parts[0], sp, g)
    d = parts[0].num_edges
    host_fit = pl.calibrate([(r["block_size"], *r["host_s"].values())
                             for r in rows])
    device_fit = pl.calibrate([(r["block_size"], *r["device_s"].values())
                               for r in rows])
    o = plug.PlugOptions()
    out["reduced"]["calibration"] = (
        f"{len(CALIBRATION_SIZES)} block sizes, every second power of two "
        "from 4,096 to 262,144 edges: the fit is two lines, a slope and an "
        "affine one")
    out["calibration"] = {
        "shard0_edges": d, "samples": rows,
        "host_stage_fit": lemma1(d, host_fit),
        "device_stage_fit": lemma1(d, device_fit),
        "defaults": lemma1(d, (o.k1, o.k2, o.k3, o.a))}
    # -- a pipelined run at the fitted block size
    fitted = plug.PlugOptions(block_size="auto", **dict(zip(
        ("k1", "k2", "k3", "a"), host_fit)))
    sp_cut, _ = plug.run_reference(g, sp, max_iterations=CUT_ITERATIONS,
                                   device="cuda")
    label = f"sssp_bf/pipelined-cuda/fitted/{CUT_ITERATIONS}-its"
    res, launches, mw, rec = run_e2e(
        label, g, sp, plug.PipelinedDaemon(kernel="cuda"), "bsp", parts,
        sp_cut, None, options=fitted, max_iterations=CUT_ITERATIONS)
    if res.iterations != CUT_ITERATIONS or launches["edge_block"] == 0:
        raise AssertionError(f"{label}: {res.iterations} iterations, "
                             f"launches {launches}")
    launches_pipelined += launches["edge_block"]
    rec.update(block_size=mw.block_size, vblock_size=mw.vblock_size,
               stages=stage_summary(res, "pipeline"),
               daemon_s=daemon_seconds(res, "pipeline", CUT_ITERATIONS),
               default_block_size=out["calibration"]["defaults"]
               ["auto_block"],
               default_daemon_s_same_iterations=daemon_seconds(
                   default_run, "pipeline", CUT_ITERATIONS))
    out["fitted"] = rec
    out["reduced"]["fitted"] = (
        f"the fitted block size runs {CUT_ITERATIONS} iterations against "
        f"run_reference cut at {CUT_ITERATIONS}: small blocks multiply the "
        "per-block host work")
    # -- Fig. 8's ratio at a reduced size
    n12 = 1 << FIG8_SCALE
    g12 = generate.rmat_stream(n12, EDGE_FACTOR * n12, seed=seed)
    sp12 = sssp_bf(g12, sources=[0, 1, 2, 3])
    parts12 = plug.HostUpperSystem().partition(g12, 1)
    ref12, ref12_it = plug.run_reference(g12, sp12, device="cuda")
    ref12_cut, _ = plug.run_reference(g12, sp12,
                                      max_iterations=CUT_ITERATIONS,
                                      device="cuda")
    daemons = {"naive": lambda: "naive",
               "blocked-cuda": lambda: plug.BlockedDaemon(kernel="cuda"),
               "pipelined-cuda": lambda: plug.PipelinedDaemon(kernel="cuda"),
               "cuda": pinned_csr_daemon}
    fig8 = {"vertices": n12, "edges": g12.num_edges, "shards": 1,
            "reference_iterations": ref12_it}
    for name, make in daemons.items():
        res, _, _, rec = run_e2e(f"fig8/{name}/{CUT_ITERATIONS}-its", g12,
                                 sp12, make(), "bsp", parts12, ref12_cut,
                                 None, max_iterations=CUT_ITERATIONS)
        entry = {"per_iteration_s": rec["per_iteration_s"],
                 "setup_s": rec["setup_s"]}
        if name != "naive":
            res, _, _, full = run_e2e(f"fig8/{name}", g12, sp12, make(),
                                      "bsp", parts12, ref12, None)
            if res.iterations != ref12_it:
                raise AssertionError(f"fig8/{name}: {res.iterations} "
                                     f"iterations, reference {ref12_it}")
            entry["fixed_point_per_iteration_s"] = full["per_iteration_s"]
        fig8[name] = entry
    naive_s = fig8["naive"]["per_iteration_s"]
    fig8["naive_over"] = {name: naive_s / fig8[name]["per_iteration_s"]
                          for name in daemons if name != "naive"}
    out["fig8"] = fig8
    out["reduced"]["fig8"] = (
        f"R-MAT scale {FIG8_SCALE}, 1 shard; every daemon's ratio over its "
        f"first {CUT_ITERATIONS} iterations (against run_reference cut "
        "there), the accelerated ones also to the fixed point: naive is a "
        "Python loop per edge, minutes an iteration at scale 20")
    return out, launches_pipelined


def check_fused_run(label, res, mw, rec, launches, want_tile,
                    kind="bsp") -> None:
    """Phase 5b's checks of a fused run: the fused loop ran (``kind``),
    ``csr_tile`` launched ``want_tile`` times and ``edge_block`` never, and
    one small fetch an iteration plus the final state crossed to the
    host."""
    if mw._fused_kind != kind or not all(
            r.get("fused") for r in res.per_iteration):
        raise AssertionError(f"{label}: ran the host loop, not the fused "
                             f"one (_fused_kind={mw._fused_kind!r})")
    if launches["csr_tile"] != want_tile or launches["edge_block"] != 0:
        raise AssertionError(f"{label}: launches {launches} over "
                             f"{res.iterations} iterations, expected "
                             f"csr_tile {want_tile}")
    if rec["vertex_sized_fetches"] != 1 or rec["fetches_per_iteration"] != 1:
        raise AssertionError(f"{label}: device→host fetches "
                             f"{rec['fetches_per_iteration']} an iteration "
                             f"and {rec['vertex_sized_fetches']} "
                             "vertex-sized, expected 1 and 1")


def flat_parts_ms(tiles, program, state, aux) -> dict:
    """The flat merge on one shard's tiles, timed as the sweep runs it
    (dead and padded slots merge the identity into vertex 0) and over the
    live slots alone, which give the same aggregate; and its K-wide row
    gather ``state[gsrc]`` alone."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.autotune import CSRConfig

    dev = state.device
    cfg = CSRConfig(edge_tile=tiles["emask"].shape[1], lowering="torch",
                    merge="flat")
    csr = {k: torch.as_tensor(v, device=dev) for k, v in tiles.items()}
    live = torch.nonzero(csr["emask"].reshape(-1)).reshape(-1)
    live_csr = {k: csr[k].reshape(-1)[live][None]
                for k in ("gsrc", "gdst", "emask")}
    live_csr["w"] = csr["w"].reshape(-1, 1)[live][None]

    def run(c):
        return ops.csr_aggregate(state, aux, c, program=program,
                                 num_vertices=state.shape[0], config=cfg)

    (agg, cnt), (agg_l, cnt_l) = run(csr), run(live_csr)
    if not (torch.equal(cnt, cnt_l) and (
            torch.equal(agg, agg_l) if program.monoid.idempotent
            else torch.allclose(agg, agg_l, rtol=SUM_RTOL, atol=SUM_ATOL))):
        raise AssertionError("flat merge: the live slots alone give another "
                             "aggregate")
    gsrc = csr["gsrc"].long().reshape(-1)
    return {"slots": csr["emask"].numel(), "live_slots": live.numel(),
            "dead_slots": csr["emask"].numel() - live.numel(),
            "flat_ms": cuda_time_ms(lambda: run(csr)),
            "flat_live_slots_ms": cuda_time_ms(lambda: run(live_csr)),
            "row_gather_ms": cuda_time_ms(lambda: state[gsrc])}


def phase_autotune(g, blocksets, parts, pr, sp, refs, pinned) -> tuple:
    """Phase 5d: the sweep on the card and the loops that follow it.
    ``refs`` maps a program's name to (run_reference state, iterations);
    ``pinned`` maps it to phase 5b's fused run at ``CSRConfig()`` (label,
    s an iteration) and to phase 5's host loop.  Returns the phase's line
    and the csr_tile launches of its runs."""
    import torch

    from repro_torch import plug
    from repro_torch.graph.compaction import build_csr_tiles
    from repro_torch.kernels import autotune
    from repro_torch.plug.daemons import _live_edges

    n = g.num_vertices
    dev = torch.device("cuda")
    out = {"phase": "autotune", "signature_backend": autotune.backend(dev),
           "space": [c.label for c in autotune.default_space(dev)]}
    big = max(range(len(blocksets)),
              key=lambda j: int(blocksets[j].emask.sum()))
    src, dst, w = _live_edges(blocksets[big])
    out.update(shard=big, shard_edges=int(src.size))
    sweeps = {}
    for prog in (pr, sp):
        t0 = time.perf_counter()
        chosen = autotune.autotune_csr(src, dst, w, n, prog, device=dev)
        entry = next(e for e in autotune.CACHE.report()["entries"]
                     if e["num_edges"] == src.size
                     and e["monoid"] == prog.monoid.name
                     and e["state_width"] == prog.state_width)
        sweeps[prog.name] = {
            "chosen": chosen.label, "sweep_s": time.perf_counter() - t0,
            "ms": {label: t * 1e3 for label, t in entry["table"].items()}}
    out["sweeps"] = sweeps
    # the flat merge's dead slots on the tuned shard, at edge tile 512
    tiles = build_csr_tiles(src, dst, w, n, edge_tile=512).arrays()
    out["flat_et512"] = {}
    for prog in (pr, sp):
        state, aux = (torch.as_tensor(a, device=dev) for a in prog.init(g))
        out["flat_et512"][prog.name] = flat_parts_ms(tiles, prog, state, aux)
    del tiles
    launches_tile = 0
    runs = (("pagerank/sharded-autotuned/mesh/bsp", pr, "bsp",
             (PR_RTOL, PR_ATOL)),
            ("sssp_bf/sharded-autotuned/mesh/gas", sp, "gas", None))
    for label, prog, model, tol in runs:
        ref, ref_it = refs[prog.name]
        res, launches, mw, rec = run_e2e(
            label, g, prog, plug.ShardedDaemon(kernel="cuda"), model, parts,
            ref, tol, upper="mesh")
        chosen = mw.daemon._csr_config
        if chosen.label != sweeps[prog.name]["chosen"]:
            raise AssertionError(f"{label}: chose {chosen.label}, the sweep "
                                 f"{sweeps[prog.name]['chosen']}")
        if prog is pr and res.iterations != ref_it:
            raise AssertionError(f"{label}: {res.iterations} iterations, "
                                 f"reference ran {ref_it}")
        # one csr_tile launch an iteration for a kernel point, none for
        # the flat merge
        check_fused_run(label, res, mw, rec, launches,
                        0 if chosen.merge == "flat" else res.iterations)
        emask = mw.daemon.stacked["csr"]["emask"]
        pinned_label, pinned_s = pinned[prog.name]
        rec.update(phase="autotune", chosen=chosen.label,
                   csr_tile_per_iteration=launches["csr_tile"]
                   / res.iterations,
                   stacked_slots=emask.numel(),
                   stacked_dead_slots=emask.numel() - int(emask.sum()),
                   pinned_run=pinned_label,
                   pinned_per_iteration_s=pinned_s,
                   autotuned_over_pinned=rec["per_iteration_s"] / pinned_s)
        out[label] = rec
        launches_tile += launches["csr_tile"]
        del mw
        torch.cuda.empty_cache()
    # the host loop, tuned on the first shard it runs
    label = "sssp_bf/cuda-autotuned/gas"
    res, launches, mw, rec = run_e2e(label, g, sp,
                                     plug.VectorizedDaemon(kernel="cuda"),
                                     "gas", parts, refs[sp.name][0], None)
    chosen = mw.daemon._csr_config
    if launches["edge_block"] or (
            (launches["csr_tile"] > 0) != (chosen.merge != "flat")):
        raise AssertionError(f"{label}: launches {launches} at "
                             f"{chosen.label}")
    host_label, host_s = pinned["host/" + sp.name]
    rec.update(chosen=chosen.label, pinned_run=host_label,
               pinned_per_iteration_s=host_s,
               autotuned_over_pinned=rec["per_iteration_s"] / host_s)
    out[label] = rec
    launches_tile += launches["csr_tile"]
    rep = autotune.CACHE.report()
    out["cache"] = {"sweeps": rep["sweeps"], "hits": rep["hits"]}
    return out, launches_tile


def phase_mesh(g, parts, pr, sp, refs, mesh1) -> tuple:
    """Phase 5e: the fused loop at ``mesh=SHARDS`` (one logical device a
    shard) with ``CSRConfig()`` pinned, against phase 5b's ``mesh=1`` runs
    (``mesh1``: a program's name → (label, state, s an iteration)).
    Returns the phase's line, its csr_tile launches and, for phase 5h, each
    program's run: name → (label, state, s an iteration, the stacked CSR
    fields' bytes per logical device)."""
    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.kernels.ops import CSRConfig

    out = {"phase": "mesh", "m": SHARDS}
    launches_tile = 0
    resident = {}
    runs = (("sssp_bf/sharded-cuda/mesh4/gas", sp, "gas", None),
            ("pagerank/sharded-cuda/mesh4/bsp", pr, "bsp",
             (PR_RTOL, PR_ATOL)))
    for label, prog, model, tol in runs:
        upper = plug.MeshUpperSystem(mesh=SHARDS)
        shapes = set()
        merge = upper.merge_partials

        def recorded(partials, counts, merge=merge, shapes=shapes):
            shapes.add((tuple(partials.shape), tuple(counts.shape)))
            return merge(partials, counts)

        upper.merge_partials = recorded
        res, launches, mw, rec = run_e2e(
            label, g, prog, plug.ShardedDaemon(kernel="cuda",
                                               csr_config=CSRConfig()),
            model, parts, refs[prog.name][0], tol, upper=upper)
        check_fused_run(label, res, mw, rec, launches, res.iterations)
        k = prog.state_width
        want = {((SHARDS, g.num_vertices, k), (SHARDS, g.num_vertices))}
        if mw.daemon.m != SHARDS or shapes != want:
            raise AssertionError(f"{label}: m={mw.daemon.m}, merge_partials "
                                 f"received {sorted(shapes)}")
        m1_label, m1_state, m1_s = mesh1[prog.name]
        state = np.asarray(res.state)
        if tol is None:
            if not np.array_equal(state, m1_state):
                raise AssertionError(f"{label}: not bit-equal to {m1_label}")
            max_abs = 0.0
        else:
            max_abs = float(np.abs(state - m1_state).max())
            if not np.allclose(state, m1_state, rtol=tol[0], atol=tol[1]):
                raise AssertionError(f"{label}: outside rtol={tol[0]} of "
                                     f"{m1_label} (max abs {max_abs})")
        csr_bytes = sum(t.numel() * t.element_size()
                        for t in mw.daemon.stacked["csr"].values())
        prof = fused_profile(mw)  # beside phase 5h's out-of-core profiles
        rec.update(profile=prof, device_idle_share_unprofiled=(
            1.0 - prof["device_busy_s_per_iteration"]
            / rec["per_iteration_s"]))
        rec.update(phase="mesh", merge_partials_shapes=sorted(shapes),
                   mesh1_run=m1_label, mesh1_per_iteration_s=m1_s,
                   max_abs_err_vs_mesh1=max_abs,
                   mesh4_over_mesh1=rec["per_iteration_s"] / m1_s,
                   csr_bytes_per_device=csr_bytes // mw.daemon.m)
        out[label] = rec
        resident[prog.name] = (label, state, rec["per_iteration_s"],
                               csr_bytes // mw.daemon.m)
        launches_tile += launches["csr_tile"]
        del mw
        torch.cuda.empty_cache()
    return out, launches_tile, resident


# phase 5e': the graph loop across ranks
RANKS = 4                  # gloo ranks sharing the one card
RANKS_TIMEOUT_S = 240.0    # the spawned world's limit: 1.9x the slowest
                           # world on an H100 (127 s; a collective's: 60 s)
RANKS_CAVEAT = ("4 ranks share one card's SMs and gloo stages each "
                "all_reduce through host memory: not a scale-out figure")
RANK_RUNS = (  # label, program, model, loop, upper options
    ("sssp_bf/ranks4/fused/gas", "sssp_bf", "gas", "fused", {}),
    ("pagerank/ranks4/fused/bsp", "pagerank", "bsp", "fused", {}),
    ("sssp_bf/ranks4/host/bsp", "sssp_bf", "bsp", "host", {}),
    ("pagerank/ranks4/host-int8/bsp", "pagerank", "bsp", "host",
     {"wire": "compressed", "bits": 8}))


# 5e' (a): the async loop across the ranks, at 5f's holding arm: on phase
# 3's R-MAT, and on 5h's road network for ROAD_ITERATIONS iterations, where
# the run mask holds devices (the R-MATs hold none at m = 4)
RANK_ASYNC_ARM = "holding"
RANK_ASYNC_RUNS = (  # label, graph, iteration cap
    (f"sssp_bf/ranks4/async-{RANK_ASYNC_ARM}", "rmat", None),
    (f"sssp_bf/ranks4/road/async-{RANK_ASYNC_ARM}", "road", ROAD_ITERATIONS))
# 5e' (b): structure epochs across the ranks, on one GAS sssp_bf middleware
# over 5g's graph: rank 3's device dies before iteration 2 and is back
# before iteration 4 (m 4 → 2 → 4: ranks 2 and 3 sit out in between), then
# a rebalance with shard 0 (rank 0's) at half the others' capacity, then
# 5g's 65,536-edge shard-0 add batch through run_dynamic
RANK_EPOCH_SCHEDULE = {"kills": [(2, 3)], "recoveries": [(4, 3)]}
RANK_REBALANCE_COSTS = (2.0, 1.0, 1.0, 1.0)


def _rank_file(tmp, label, rank, what="state") -> Path:
    return Path(tmp) / f"{label.replace('/', '_')}.{what}.rank{rank}.npy"


def ranks_world(rank, world, tmp, sizes, seed, oocore_budget) -> dict:
    """One rank of phase 5e': the graphs memory-mapped from ``tmp``
    (``sizes``: name → vertices; :func:`_rank_graph`), its own shard
    bound, every run of ``RANK_RUNS`` on phase 3's (one warm-up iteration
    first, then the timed run with the launches and fetches counted), then
    the async arm's runs (:func:`rank_async`) and the epoch arm on 5g's
    (:func:`rank_epochs`).  Writes each final state (and the int8 wire's
    per-merge aggregates) under ``tmp`` for the parent's checks; returns
    the rank's records."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.dist.sharding import RankMesh
    from repro_torch.graph.algorithms import pagerank, sssp_bf
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels.ops import CSRConfig

    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    t0 = time.perf_counter()
    graphs = {name: _rank_graph(tmp, name, n) for name, n in sizes.items()}
    g, n = graphs["rmat"], sizes["rmat"]
    programs = {"pagerank": pagerank(g, max_iterations=PR_ITERATIONS),
                "sssp_bf": sssp_bf(g, sources=[0, 1, 2, 3])}
    mesh = RankMesh()  # cuda:{rank % device_count}
    out = {"rank": rank, "device": str(mesh.device), "backend": mesh.backend,
           "shards": list(mesh.shard_range(SHARDS)),
           "load_s": time.perf_counter() - t0, "runs": {}}
    # phase 3's partitions, cut once for every middleware on that graph but
    # the epoch arm's (which re-partitions); phase 5's are the same cut
    t0 = time.perf_counter()
    parts = plug.HostUpperSystem().partition(g, SHARDS)
    out["partition_s"] = time.perf_counter() - t0

    class Recording(plug.MeshUpperSystem):
        """Keeps each merge's per-shard aggregates (this rank's) and a
        digest of its result."""

        def reset(self):
            super().reset()
            self.rounds = []

        def merge(self, states, aggs, cnts):
            base, agg, cnt = super().merge(states, aggs, cnts)
            self.rounds.append((np.stack([np.asarray(a, np.float32)
                                          for a in aggs]),
                                np.array(agg, np.float32)))
            return base, agg, cnt

    for label, name, model, loop, upper_kw in RANK_RUNS:
        prog = programs[name]
        upper = (Recording if upper_kw else plug.MeshUpperSystem)(
            mesh=mesh, **upper_kw)
        daemon = (plug.ShardedDaemon(kernel="cuda", mesh=mesh,
                                     csr_config=CSRConfig())
                  if loop == "fused" else pinned_csr_daemon())
        t0 = time.perf_counter()
        mw = plug.Middleware(g, prog, daemon=daemon, upper=upper,
                             model=model, partitions=parts)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        mw.run(max_iterations=1)  # warm-up: the host daemon compacts here
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        fetches: list = []
        ebk.csr_tile.launches = 0
        with counting_fetches(fetches):
            res = mw.run()
        torch.cuda.synchronize()
        its = max(res.iterations, 1)
        big = [c for c in fetches if c[1] >= n]
        rec = dict(loop=type(mw._loop).__name__, init_s=init_s,
                   setup_s=setup_s, iterations=res.iterations,
                   converged=res.converged, wall_s=res.wall_time,
                   per_iteration_s=res.wall_time / its,
                   csr_tile_launches=ebk.csr_tile.launches,
                   fetches_per_iteration=(len(fetches) - len(big)) / its,
                   vertex_sized_fetches=len(big),
                   rounds_skipped=res.stats.rounds_skipped,
                   wire_stats=dict(upper.wire_stats))
        np.save(_rank_file(tmp, label, rank), np.asarray(res.state))
        if upper_kw:
            np.save(_rank_file(tmp, label, rank, "aggs"),
                    np.stack([a for a, _ in upper.rounds]))
            rec["merge_digests"] = [hashlib.sha1(r.tobytes()).hexdigest()
                                    for _, r in upper.rounds]
            if rank == 0:
                np.save(_rank_file(tmp, label, rank, "merged"),
                        np.stack([r for _, r in upper.rounds]))
        out["runs"][label] = rec
        del mw, daemon, upper
        torch.cuda.empty_cache()
    out["async"] = {
        label: rank_async(mesh, label, graphs[name],
                          programs["sssp_bf"] if name == "rmat" else
                          sssp_bf(graphs[name], sources=[0, 1, 2, 3]),
                          cap, tmp, rank,
                          parts if name == "rmat" else None)
        for label, name, cap in RANK_ASYNC_RUNS}
    g_e = graphs["elastic"]
    out["epochs"] = rank_epochs(mesh, g_e, sssp_bf(g_e, sources=[0, 1, 2, 3]),
                                tmp, rank, g_e.num_vertices, seed)
    # (c) on 5g's graph, cut as the parent cuts it for its one-process run
    out["oocore"] = rank_oocore(
        mesh, g_e, sssp_bf(g_e, sources=[0, 1, 2, 3]),
        plug.HostUpperSystem().partition(g_e, SHARDS), tmp, rank,
        oocore_budget)
    out["serve"] = rank_serve(mesh, g_e, tmp, rank, seed)
    # one iteration's collectives alone, as the fused sssp_bf step makes
    # them: the (N, K) aggregate's MIN and the (N,) counts' SUM; and the
    # async step's flags (S blocks, 3m device flags, the backlog's)
    k = programs["sssp_bf"].state_width
    agg = torch.rand((n, k), device=mesh.device)
    cnt = torch.ones(n, dtype=torch.int32, device=mesh.device)
    flags = torch.ones(SHARDS + 3 * mesh.size + 1, dtype=torch.int32,
                       device=mesh.device)
    out["all_reduce_ms"] = {
        "aggregate_min": _collective_ms(lambda: mesh.all_reduce(agg, "min")),
        "counts_sum": _collective_ms(lambda: mesh.all_reduce(cnt, "sum")),
        "async_flags_sum": _collective_ms(
            lambda: mesh.all_reduce(flags, "sum"))}
    return out


def _rank_graph(tmp, name, n):
    """Graph ``name`` of ``n`` vertices, its arrays memory-mapped from the
    ``.npy`` files :func:`phase_ranks` wrote under ``tmp``."""
    import numpy as np

    from repro_torch.graph.structure import Graph

    return Graph(num_vertices=n, **{
        k: np.load(Path(tmp) / f"{name}.{k}.npy", mmap_mode="r")
        for k in ("src", "dst", "weights")})


def own_runs(rec, mesh) -> int:
    """The maximal runs of consecutive executing devices among this rank's
    own devices in one async record (:func:`executed_runs`' slice)."""
    ran, _ = executed_runs(rec)
    mine = ran[mesh.offset:mesh.offset + mesh.local]
    return sum(1 for g, r in enumerate(mine) if r and (g == 0 or
                                                        not mine[g - 1]))


def rank_async(mesh, label, g, prog, cap, tmp, rank, parts) -> dict:
    """One run of 5e' (a) on one rank: ``prog`` under ``AsyncModel``'s
    ``holding`` arm over the RankMesh on ``parts`` (None: the middleware
    cuts its own) (a warm-up iteration, then the timed
    run of at most ``cap`` iterations), with csr_tile's launches counted
    per ``run_all_shards`` call against the runs of this rank's executing
    devices, the iterations in which every device of this rank held, and
    the fetches counted."""
    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels.ops import CSRConfig

    n = g.num_vertices
    daemon = plug.ShardedDaemon(kernel="cuda", mesh=mesh,
                                csr_config=CSRConfig())
    per_call, run_all = [], daemon.run_all_shards

    def counted(*args, **kwargs):
        before = ebk.csr_tile.launches
        result = run_all(*args, **kwargs)
        per_call.append(ebk.csr_tile.launches - before)
        return result

    daemon.run_all_shards = counted
    t0 = time.perf_counter()
    mw = plug.Middleware(
        g, prog, daemon=daemon, upper=plug.MeshUpperSystem(mesh=mesh),
        model=plug.AsyncModel(**dict(ASYNC_ARMS)[RANK_ASYNC_ARM]),
        num_shards=SHARDS, partitions=parts)
    if not isinstance(mw._loop, plug.AsyncDriveLoop):
        raise AssertionError(f"{label}: ran {type(mw._loop).__name__}")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mw.run(max_iterations=1)
    torch.cuda.synchronize()
    per_call.clear()
    fetches: list = []
    with counting_fetches(fetches):
        res = mw.run(cap)
    torch.cuda.synchronize()
    recs = res.per_iteration
    want = [own_runs(r, mesh) for r in recs]
    if per_call != want:
        raise AssertionError(f"{label}: rank {rank}: csr_tile launches "
                             f"{per_call} per iteration, its runs of "
                             f"executing devices {want}")
    its = max(res.iterations, 1)
    big = [c for c in fetches if c[1] >= n]
    np.save(_rank_file(tmp, label, rank), np.asarray(res.state))
    out = {"run": label, "init_s": init_s, "iterations": res.iterations,
           "converged": res.converged, "wall_s": res.wall_time,
           "per_iteration_s": res.wall_time / its,
           "csr_tile_launches": sum(per_call),
           "csr_tile_per_iteration": per_call,
           "fetches_per_iteration": (len(fetches) - len(big)) / its,
           "vertex_sized_fetches": len(big),
           "gen_run": sum(r["gen_run"] for r in recs),
           "gen_skipped": sum(r["gen_skipped"] for r in recs),
           "held_device_iterations": sum(r["run_mask"].count(False)
                                         for r in recs),
           "rank_held_iterations": sum(
               1 for r in recs
               if not any(r["run_mask"][mesh.offset:mesh.offset
                                        + mesh.local])),
           "refreshed": [r["refreshed"] for r in recs]}
    del mw, daemon
    torch.cuda.empty_cache()
    return out


def rank_epochs(mesh, g, prog, tmp, rank, n, seed) -> dict:
    """5e' (b) on one rank: one GAS sssp_bf middleware over the RankMesh
    (a warm-up iteration first) takes three runs — under
    ``RANK_EPOCH_SCHEDULE`` (a kill and a join), after
    ``rebalance(RANK_REBALANCE_COSTS)``, and ``run_dynamic`` of phase 5g's
    shard-0 add batch — each probed (:func:`probe_loop`): the seconds and
    fetches of every rebuild on this rank (none may fetch), the steps'
    seconds between rebuilds, csr_tile once a step."""
    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels.ops import CSRConfig

    daemon = plug.ShardedDaemon(kernel="cuda", mesh=mesh,
                                csr_config=CSRConfig())
    t0 = time.perf_counter()
    mw = plug.Middleware(
        g, prog, daemon=daemon, upper=plug.MeshUpperSystem(mesh=mesh),
        model="gas", num_shards=SHARDS,
        failures=plug.FailureSchedule(**RANK_EPOCH_SCHEDULE))
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "runs": []}
    mw.run(max_iterations=1)  # every event is due at iteration 2 or later
    calls: list = []
    its: list = []
    probe_loop(mw, calls, its)

    def probed_run(label, trigger):
        calls.clear()
        its.clear()
        before = ebk.csr_tile.launches
        t0 = time.perf_counter()
        with counting_fetches(calls):
            res = trigger()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = [i for i in its if "step_s" in i]
        bad = [(i["iteration"], i["rebuild_fetches"]) for i in its
               if i["rebuild_fetches"] and i["rebound"]]
        if bad:
            raise AssertionError(f"{label}: rank {rank}: fetches inside the "
                                 f"rebuilds (iteration, fetches) {bad}")
        if any(i["csr_tile"] != 1 or len(i["step_fetches"]) != 1
               for i in steps):
            raise AssertionError(f"{label}: rank {rank}: a step's csr_tile "
                                 "launches or fetches are not 1")
        np.save(_rank_file(tmp, label, rank), np.asarray(res.state))
        # the epochs' records, but the dirty vertex lists and the seconds
        # each rank measures for itself
        events = [{"iteration": r["iteration"], "kind": kind,
                   **{k: v for k, v in r[kind].items()
                      if k not in ("dirty_vertices", "seconds")}}
                  for r in res.per_iteration
                  for kind in ("migration", "mutation") if kind in r]
        return {"run": label, "iterations": res.iterations,
                "converged": res.converged, "wall_s": wall,
                "stepped": [i["iteration"] for i in steps],
                "step_s": [i["step_s"] for i in steps],
                "rebuild_s": {i["iteration"]: i["rebuild_s"]
                              for i in its if i["rebound"]},
                "rebuild_fetches": sum(len(i["rebuild_fetches"])
                                       for i in its if i["rebound"]),
                "csr_tile_launches": ebk.csr_tile.launches - before,
                "events": events, "members": list(mw.ranks.members)}

    out["runs"].append(probed_run("sssp_bf/ranks4/kill-join", mw.run))
    t0 = time.perf_counter()
    fractions = mw.rebalance(np.array(RANK_REBALANCE_COSTS))
    out["rebalance_s"] = time.perf_counter() - t0
    out["fractions"] = [float(f) for f in fractions]
    out["runs"].append(probed_run("sssp_bf/ranks4/rebalanced", mw.run))
    batch = shard0_batches(mw.partitions, n, seed)
    out["runs"].append(probed_run("sssp_bf/ranks4/run_dynamic",
                                  lambda: mw.run_dynamic(batch)))
    ep = mw.epochs.epoch
    out["mutation"] = {"seconds": ep.meta["seconds"],
                       "shards_recut": ep.meta["shards_recut"],
                       "edges_added": ep.meta["edges_added"],
                       "incremental": ep.meta["incremental"],
                       "mode": mw.last_restart["mode"]}
    del mw, daemon
    torch.cuda.empty_cache()
    return out


# 5e' (c): 5h (d) across the ranks — its kill run, then the re-plan at half
# the budget and a second run — on 5g's scale-18 graph, at 5h's budget rule
# (a quarter of the resident CSR bytes a logical device), held to the same
# two runs on one process
RANK_OOCORE_RUNS = ("sssp_bf/ranks4/oocore/kill/gas",
                    "sssp_bf/ranks4/oocore/kill/replan-half/gas")
# an out-of-core record's counters every rank and one process agree on (the
# hit counts are the world's); the rest are a rank's own
OOCORE_WORLD = ("super_shards", "hot_cols", "hot_hits", "cold_misses")


def oocore_one_process(g, prog, parts) -> tuple:
    """5e' (c)'s budget and its one-process twin: 5h's budget rule on
    ``g`` (a quarter of a resident ``mesh=SHARDS`` middleware's CSR bytes a
    logical device), then the rank arm's two runs at ``mesh=SHARDS`` on one
    process — ``OOCORE_KILL`` due at iteration 3, a warm-up iteration and
    the run, ``oocore_replan`` at half the budget, a warm-up and the run —
    → (budget, each run's per-iteration ``OOCORE_WORLD`` counters)."""
    import torch

    from repro_torch import plug
    from repro_torch.kernels.ops import CSRConfig

    def make(**kw):
        return plug.Middleware(
            g, prog, daemon=plug.ShardedDaemon(kernel="cuda", mesh=SHARDS,
                                               csr_config=CSRConfig()),
            upper=plug.MeshUpperSystem(mesh=SHARDS), model="gas",
            partitions=parts, device="cuda", **kw)

    mw = make()
    budget = sum(t.numel() * t.element_size() for t in
                 mw.daemon.stacked["csr"].values()) // mw.daemon.m \
        // OOCORE_DIV
    del mw
    mw = make(oocore=plug.OocoreConfig(hbm_budget=budget,
                                       hot_fraction=OOCORE_HOT),
              failures=plug.FailureSchedule(kills=OOCORE_KILL))
    counters = []
    for b in (budget, budget // 2):
        if b != budget:
            mw.oocore_replan(plug.OocoreConfig(hbm_budget=b,
                                               hot_fraction=OOCORE_HOT))
        mw.run(max_iterations=1)
        res = mw.run()
        counters.append([{k: r["oocore"][k] for k in OOCORE_WORLD}
                         for r in res.per_iteration])
    del mw
    torch.cuda.empty_cache()
    return budget, counters


def rank_oocore(mesh, g, prog, parts, tmp, rank, budget) -> dict:
    """5e' (c) on one rank: sssp_bf GAS out of core over the RankMesh on
    5g's graph and its partitions ``parts`` at ``budget`` bytes a logical
    device (:func:`oocore_one_process`'s), ``OOCORE_KILL`` due at
    iteration 3, a warm-up iteration, the kill run, ``oocore_replan`` at
    half the budget, a warm-up and the second run — each probed: on every
    step this rank ran, ``csr_tile`` (hot > 0) + uploads and one small
    fetch; no fetch in a rebuild; at most two groups live in two slots.
    Writes each final state under ``tmp``; returns the runs' world
    counters and this rank's seconds, copies and spans."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels.ops import CSRConfig

    def config(b):
        return plug.OocoreConfig(hbm_budget=b, hot_fraction=OOCORE_HOT)

    n = g.num_vertices
    t0 = time.perf_counter()
    mw = plug.Middleware(
        g, prog, daemon=plug.ShardedDaemon(kernel="cuda", mesh=mesh,
                                           csr_config=CSRConfig()),
        upper=plug.MeshUpperSystem(mesh=mesh), model="gas",
        partitions=parts, oocore=config(budget),
        failures=plug.FailureSchedule(kills=OOCORE_KILL))
    torch.cuda.synchronize()
    if mw._fused_kind != "oocore":
        raise AssertionError(f"rank {rank}: fused kind {mw._fused_kind}")
    out = {"init_s": time.perf_counter() - t0,
           "plan": dataclasses.asdict(mw.daemon.oocore_plan), "runs": []}
    calls: list = []
    its: list = []

    def probed(label):
        mw.run(max_iterations=1)  # warm-up: every event is due later
        probe_loop(mw, calls, its)
        read = mw._loop._read_extra

        def read_own(carry, extra):
            carry, rec = read(carry, extra)
            oc = rec["oocore"]
            its[-1].update(oocore=oc, uploads=oc["super_shards"]
                           - oc["skipped"], group_bytes=(
                               mw.daemon.super_shard_nbytes))
            return carry, rec

        mw._loop._read_extra = read_own
        calls.clear()
        its.clear()
        before = ebk.csr_tile.launches
        t0 = time.perf_counter()
        try:
            with counting_fetches(calls):
                res = mw.run()
            torch.cuda.synchronize()
        finally:  # the probe's wrappers go: the next run probes afresh
            for obj, name in ((mw, "_poll_structure"),
                              (mw._loop, "_adopt_epoch"),
                              (mw._loop, "_advance"),
                              (mw._loop, "_read_extra")):
                vars(obj).pop(name, None)
        wall = time.perf_counter() - t0
        steps = [i for i in its if "step_s" in i]
        for i in steps:
            oc = i["oocore"]
            want = int(oc["hot_cols"] > 0) + i["uploads"]
            if i["csr_tile"] != want or len(i["step_fetches"]) != 1 \
                    or i["step_fetches"][0][1] >= n:
                raise AssertionError(
                    f"{label}: rank {rank}: iteration {i['iteration']}: "
                    f"csr_tile {i['csr_tile']} (expected {want}), step "
                    f"fetches {i['step_fetches']}")
        bad = [(i["iteration"], i["rebuild_fetches"]) for i in its
               if i["rebuild_fetches"]]
        if bad:
            raise AssertionError(f"{label}: rank {rank}: fetches in a "
                                 f"rebuild {bad}")
        up = mw._loop._uploader
        live = 0 if up is None else up.max_live_groups
        slots = 0 if up is None else up.slot_allocations
        if live > 2 or slots > 2:
            raise AssertionError(f"{label}: rank {rank}: {live} groups live "
                                 f"in {slots} slots")
        np.save(_rank_file(tmp, label, rank), np.asarray(res.state))
        transfer = sum(i["oocore"]["transfer_s"] for i in steps)
        wait = sum(i["oocore"]["wait_s"] for i in steps)
        moved = sum(i["uploads"] * i["group_bytes"] for i in steps)
        # the kill run's steps split at the kill; the second run's whole
        kill_at = (OOCORE_KILL[0][0] if any("migration" in r for r in
                                              res.per_iteration) else 0)
        before_kill = [i["step_s"] for i in steps if i["iteration"] < kill_at]
        after_kill = [i["step_s"] for i in steps
                      if i["iteration"] >= kill_at]
        return {
            "run": label, "iterations": res.iterations,
            "converged": res.converged, "wall_s": wall,
            "members": list(mw.ranks.members),
            "world": [{k: r["oocore"][k] for k in OOCORE_WORLD}
                      for r in res.per_iteration],
            "migrations": [{k: r["migration"][k] for k in (
                "killed", "devices_after", "device_ids")}
                for r in res.per_iteration if "migration" in r],
            "stepped": [i["iteration"] for i in steps],
            "skipped": [i["oocore"]["skipped"] for i in steps],
            "s_per_iteration_before_kill": (
                sum(before_kill) / len(before_kill) if before_kill
                else None),
            "s_per_iteration_after_kill": (
                sum(after_kill) / len(after_kill) if after_kill else None),
            "rebuild_s": {i["iteration"]: i["rebuild_s"] for i in its
                          if i["rebound"]},
            "first_step_s": steps[0]["step_s"] if steps else None,
            "csr_tile_launches": ebk.csr_tile.launches - before,
            "transfer_s": transfer, "wait_s": wait,
            "overlap_efficiency": (1.0 - wait / transfer if transfer > 0
                                   else None),
            "upload_bytes": moved,
            "copy_gb_per_s": moved / transfer / 1e9 if transfer > 0 else None,
            "max_live_groups": live, "slots": slots}

    out["runs"].append(probed(RANK_OOCORE_RUNS[0]))
    t0 = time.perf_counter()
    ep = mw.oocore_replan(config(budget // 2))
    torch.cuda.synchronize()
    out["replan_s"] = time.perf_counter() - t0
    out["replan"] = {k: ep.meta[k] for k in (
        "super_shards_before", "super_shards_after", "hot_cols_before",
        "hot_cols_after")}
    out["runs"].append(probed(RANK_OOCORE_RUNS[1]))
    del mw
    torch.cuda.empty_cache()
    return out


def rank_serve(mesh, g, tmp, rank, seed) -> dict:
    """5e' (d) on one rank: ``GraphServeSession(kernel="cuda",
    max_batch=SERVE_B, mesh=<the RankMesh>)`` on 5g's graph answers 5i's
    batch of 8 of each kind, a pagerank lookup and 5i's replay cut to the
    families the batches built (:func:`serve_plan`), each step checked as
    5i checks it on this rank (:func:`serve_step`).  Writes the answers
    under ``tmp``; returns the steps' records."""
    import numpy as np
    import torch

    from repro_torch import serve
    from repro_torch.kernels.ops import CSRConfig

    n = g.num_vertices
    session = serve.GraphServeSession(
        g, num_shards=SHARDS, kernel="cuda", max_batch=SERVE_B, mesh=mesh,
        csr_config=CSRConfig())
    seeds = serve_seeds(g, seed)
    params = {"khop": (("hops", SERVE_HOPS),), "sssp": (), "ppr": ()}
    out = {"batches": {}, "launches": 0}
    for kind in params:
        (answers, rec), _, checks = serve_step(
            f"ranks4/{kind}/B{SERVE_B}",
            lambda: session.execute_batch(kind, params[kind], seeds), n)
        out["launches"] += checks["csr_tile"]
        np.save(_rank_file(tmp, f"serve/{kind}", rank), np.stack(answers, 1))
        out["batches"][kind] = {"iterations": rec["iterations"],
                                "service_s": rec["service_s"], **checks}
    field = (("field", "pagerank"),)
    look_seeds = [(seeds[0], seeds[2], seeds[4]), (seeds[1],)]
    (looked, recl), _, checks = serve_step(
        "ranks4/lookup/pagerank",
        lambda: session.execute_batch("lookup", field, look_seeds), n)
    out["launches"] += checks["csr_tile"]
    np.save(_rank_file(tmp, "serve/lookup", rank),
            session._analytics["pagerank"])
    out["lookup"] = {"service_s": recl["service_s"],
                     "answers": [np.asarray(a).tolist() for a in looked],
                     **checks}
    wl = serve.generate_workload(
        num_requests=SERVE_REQUESTS, num_vertices=n, rate=SERVE_RATE,
        seed=seed, hops=SERVE_HOPS, repeat_fraction=SERVE_REPEAT)
    count = serve_plan(serve, wl, session.compiled_families)
    fams = len(session.compiled_families)
    router = serve.GraphServeRouter(session, max_batch=SERVE_B)
    (answers, stats), runs, checks = serve_step(
        "ranks4/replay", lambda: serve.replay(router, wl[:count]), n)
    out["launches"] += checks["csr_tile"]
    # one flat array: a lookup's answer is as long as its seed set
    np.save(_rank_file(tmp, "serve/replay", rank), np.concatenate(
        [np.asarray(a.value, np.float32) for a in answers]))
    out["replay"] = {
        "requests": count, "completed": stats["completed"],
        "cached": stats["cached"], "qps": stats["throughput_qps"],
        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
        "wall_s": stats["wall_s"],
        "queries": [(a.query.kind, list(a.query.seeds), a.query.params,
                     a.cached, int(np.asarray(a.value).size))
                    for a in answers],
        "batch_sizes": [res.state.shape[1] for _, res in runs],
        "families_built": len(session.compiled_families) - fams, **checks}
    out["init_s"] = {"/".join(str(x) for x in k): v
                     for k, v in session.init_s.items()}
    del session, router
    torch.cuda.empty_cache()
    return out


def _collective_ms(fn, reps: int = 5) -> float:
    """Host-clock ms of one call that ends on the card (a warm-up first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def planned_migrations(m, schedule, iterations) -> list:
    """What the one-process planner (``Middleware._poll_faults`` /
    ``_feasible_mesh_size`` / ``migrate`` with ``dist.fault``'s monitor and
    ``reassign_shards``) plans for ``schedule`` at m devices over SHARDS
    shards, poll by poll for ``iterations`` polls — a plan only: no graph,
    no build."""
    import numpy as np

    from repro_torch.dist import fault

    mon = fault.FleetMonitor(num_hosts=m, model_parallel=1)
    sched = fault.FailureSchedule(**schedule)
    axis, plans = list(range(m)), []
    for it in range(1, iterations + 1):
        joined = [d for d in sched.recoveries_at(it) if mon.failed[d]]
        for d in joined:
            mon.mark_recovered(d)
        killed = [d for d in sched.kills_at(it) if not mon.failed[d]]
        for d in killed:
            mon.mark_failed(d)
        alive = [int(d) for d in mon.alive_indices()]
        m_new = max(d for d in range(1, min(SHARDS, len(alive)) + 1)
                    if SHARDS % d == 0)
        if not (any(mon.failed[d] for d in axis) or m_new > len(axis)):
            continue
        frac_fleet = mon.batch_fractions()
        chosen = sorted(sorted(alive, key=lambda d: (-frac_fleet[d], d))
                        [:m_new])
        frac = np.asarray(frac_fleet[chosen], dtype=np.float64)
        frac = (np.full(m_new, 1.0 / m_new) if frac.sum() <= 0
                else frac / frac.sum())
        assign = fault.reassign_shards(SHARDS, frac, cap=SHARDS // m_new)
        plans.append({"iteration": it, "killed": killed, "joined": joined,
                      "devices_after": m_new, "device_ids": chosen,
                      "assignment": [int(a) for a in assign],
                      "repartitioned": bool(mon.observed)})
        axis = chosen
    return plans


def _segments(stepped, step_s, cuts) -> list:
    """A rank's step seconds cut at the rebuild iterations ``cuts``: the
    iterations each stretch ran and their mean (None where the rank sat
    out)."""
    bounds = [1] + sorted(cuts) + [10 ** 9]
    out = []
    for lo, hi in zip(bounds, bounds[1:]):
        s = [t for i, t in zip(stepped, step_s) if lo <= i < hi]
        out.append({"from_iteration": lo, "iterations": len(s),
                    "s_per_iteration": sum(s) / len(s) if s else None})
    return out


def ranks_async_check(tmp, ranks, label) -> tuple:
    """One run of 5e' (a) in the parent: every rank's state bit-identical
    to rank 0's, equal records' sums, one small fetch an iteration and the
    final state on each rank.  Returns the line's entry and rank 0's state
    (held to a ``mesh=4`` run of the same by :func:`ranks_async_vs_mesh4`)."""
    import numpy as np

    recs = [r["async"][label] for r in ranks]
    states = [np.load(_rank_file(tmp, label, r)) for r in range(RANKS)]
    if any(st.tobytes() != states[0].tobytes() for st in states[1:]):
        raise AssertionError(f"{label}: the ranks' states differ")
    keys = ("iterations", "converged", "gen_run", "gen_skipped",
            "held_device_iterations", "refreshed")
    if len({tuple(str(r[k]) for k in keys) for r in recs}) != 1:
        raise AssertionError(f"{label}: the ranks' runs differ")
    if any(r["fetches_per_iteration"] != 1 or r["vertex_sized_fetches"] != 1
           for r in recs):
        raise AssertionError(f"{label}: fetches {recs}")
    line = {k: recs[0][k] for k in keys if k != "refreshed"}
    line.update(run=label, per_iteration_s=[r["per_iteration_s"]
                                            for r in recs],
                init_s=[r["init_s"] for r in recs],
                rank_held_iterations=[r["rank_held_iterations"]
                                      for r in recs],
                csr_tile_launches=[r["csr_tile_launches"] for r in recs],
                csr_tile_per_iteration=[r["csr_tile_per_iteration"]
                                        for r in recs])
    return line, states[0]


def ranks_async_vs_mesh4(line, state, want, mesh4_state) -> None:
    """One run of 5e' (a) against the ``mesh=4`` run of the same arm on
    one process (``want``: its record): the state bit-equal, and equal
    iterations, skipped device bodies and held device-iterations."""
    label = want["run"]
    check_state(f"{line['run']} vs {label}", state, mesh4_state, None)
    for key in ("iterations", "gen_skipped", "held_device_iterations"):
        if line[key] != want[key]:
            raise AssertionError(f"{line['run']}: {key} {line[key]}, {label} "
                                 f"{want[key]}")
    line["mesh4_run"] = label
    line["mesh4_per_iteration_s"] = want["per_iteration_s"]


def road_async_mesh4(gr, prog) -> tuple:
    """The one-process ``mesh=4`` run that 5e' (a)'s road run is held to:
    the holding arm on ``gr`` for ROAD_ITERATIONS iterations after a
    warm-up one, held to an upper bound of ``run_reference`` cut there
    (a held device delays its messages: every distance is that of a path
    of at most as many hops, so at least the barriered run's).  Returns
    its record and state."""
    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.kernels.ops import CSRConfig

    label = f"sssp_bf/road/async-{RANK_ASYNC_ARM}/mesh4"
    t0 = time.perf_counter()
    ref, ref_it = plug.run_reference(gr, prog, max_iterations=ROAD_ITERATIONS,
                                     device="cuda")
    ref = np.asarray(ref)
    mw = plug.Middleware(
        gr, prog, daemon=plug.ShardedDaemon(kernel="cuda",
                                            csr_config=CSRConfig()),
        upper=plug.MeshUpperSystem(mesh=SHARDS),
        model=plug.AsyncModel(**dict(ASYNC_ARMS)[RANK_ASYNC_ARM]),
        num_shards=SHARDS, device="cuda")
    mw.run(max_iterations=1)
    res = mw.run(ROAD_ITERATIONS)
    torch.cuda.synchronize()
    state = np.asarray(res.state)
    recs = res.per_iteration
    if res.iterations != ref_it or not np.isfinite(state).all() or \
            (state < ref).any():
        raise AssertionError(f"{label}: {res.iterations} iterations (the "
                             f"reference's {ref_it}), not at or above "
                             "run_reference's state")
    rec = {"run": label, "iterations": res.iterations,
           "per_iteration_s": res.wall_time / max(res.iterations, 1),
           "gen_skipped": sum(r["gen_skipped"] for r in recs),
           "held_device_iterations": sum(r["run_mask"].count(False)
                                         for r in recs),
           "equal_to_reference_share": float((state == ref).mean()),
           "seconds": time.perf_counter() - t0}
    del mw
    torch.cuda.empty_cache()
    return rec, state


def ranks_epochs_check(tmp, ranks, g, refs, seed) -> dict:
    """5e' (b) in the parent: each run's states bit-identical over the
    ranks and bit-equal to ``run_reference`` (the third on the mutated
    graph), the kill and the join as the one-process planner plans them,
    the rebalance's fractions Lemma 2's, the batch recutting shard 0
    alone; with each rank's rebuild seconds and s an iteration around each
    epoch."""
    import numpy as np

    from repro_torch import plug
    from repro_torch.core.balance import lemma2_fractions
    from repro_torch.graph import mutation as graph_mutation
    from repro_torch.graph.algorithms import sssp_bf

    eps = [r["epochs"] for r in ranks]
    runs = list(zip(*[e["runs"] for e in eps]))
    # the references: phase 5's, and the mutated graph's, whose batch the
    # ranks drew from the rebalanced partitions
    t0 = time.perf_counter()
    fractions = lemma2_fractions(np.array(RANK_REBALANCE_COSTS))
    parts = plug.HostUpperSystem().partition(g, SHARDS, fractions=fractions)
    g_mut, _ = graph_mutation.apply_to_graph(
        g, shard0_batches(parts, g.num_vertices, seed))
    ref_mut = plug.run_reference(g_mut, sssp_bf(g_mut, sources=[0, 1, 2, 3]),
                                 device="cuda")[0]
    out = {"reference_mutated_s": time.perf_counter() - t0, "runs": {}}
    for rank_runs, ref in zip(runs, (refs["sssp_bf"][0], refs["sssp_bf"][0],
                                     ref_mut)):
        label = rank_runs[0]["run"]
        states = [np.load(_rank_file(tmp, label, r)) for r in range(RANKS)]
        if any(st.tobytes() != states[0].tobytes() for st in states[1:]):
            raise AssertionError(f"{label}: the ranks' states differ")
        check_state(label, states[0], ref, None)
        keys = ("iterations", "converged", "events", "members")
        if len({tuple(str(r[k]) for k in keys) for r in rank_runs}) != 1:
            raise AssertionError(f"{label}: the ranks' runs differ")
        if any(r["rebuild_fetches"] for r in rank_runs):
            raise AssertionError(f"{label}: fetches inside a rebuild")
        cuts = sorted({int(i) for r in rank_runs for i in r["rebuild_s"]})
        out["runs"][label] = {
            "iterations": rank_runs[0]["iterations"],
            "members_end": rank_runs[0]["members"],
            "events": rank_runs[0]["events"],
            "rebuild_s": [r["rebuild_s"] for r in rank_runs],
            "segments": [_segments(r["stepped"], r["step_s"], cuts)
                         for r in rank_runs],
            "csr_tile_launches": [r["csr_tile_launches"] for r in rank_runs],
            "wall_s": [r["wall_s"] for r in rank_runs]}
    kill_join = runs[0][0]
    got = [{k: e[k] for k in ("iteration", "killed", "joined",
                              "devices_after", "device_ids", "assignment",
                              "repartitioned")}
           for e in kill_join["events"] if e["kind"] == "migration"]
    want = planned_migrations(SHARDS, RANK_EPOCH_SCHEDULE,
                              kill_join["iterations"])
    if got != want or len(got) != 2:
        raise AssertionError(f"{kill_join['run']}: migrations {got}, the "
                             f"one-process planner's {want}")
    if any(e["fractions"] != [float(f) for f in fractions] for e in eps):
        raise AssertionError(f"rebalance fractions {eps[0]['fractions']}, "
                             f"Lemma 2's {list(fractions)}")
    mut = [e["mutation"] for e in eps]
    if any(x["shards_recut"] != 1 or x["mode"] != "dirty"
           or not x["incremental"] for x in mut):
        raise AssertionError(f"run_dynamic: {mut}")
    out.update(plan=want, fractions=eps[0]["fractions"],
               rebalance_s=[e["rebalance_s"] for e in eps],
               mutation_s=[x["seconds"] for x in mut],
               mutation=mut[0], init_s=[e["init_s"] for e in eps])
    # a rank rebuilding longer than the others makes them wait in the next
    # collective, which gives up at 60 s
    waits = [max(r["rebuild_s"].values(), default=0.0)
             for run in runs for r in run] + out["rebalance_s"] + \
        out["mutation_s"]
    out["longest_rebuild_s"] = max(waits)
    out["near_collective_limit"] = max(waits) > 30.0
    return out


def ranks_oocore_check(tmp, ranks, refs) -> tuple:
    """5e' (c) in the parent: each run's states bit-identical over the
    ranks and bit-equal to ``run_reference``, the ranks' world counters,
    migrations and members the same.  Returns the line's entry (each
    rank's seconds, copies and spans; the summed GB/s) and the world
    counters by run, held to one process's by
    :func:`ranks_oocore_vs_one_process`."""
    import numpy as np

    recs = [r["oocore"] for r in ranks]
    out = {"plan": recs[0]["plan"], "init_s": [r["init_s"] for r in recs],
           "replan_s": [r["replan_s"] for r in recs],
           "replan": recs[0]["replan"], "runs": {}}
    world = {}
    for i, label in enumerate(RANK_OOCORE_RUNS):
        runs = [r["runs"][i] for r in recs]
        states = [np.load(_rank_file(tmp, label, r)) for r in range(RANKS)]
        if any(st.tobytes() != states[0].tobytes() for st in states[1:]):
            raise AssertionError(f"{label}: the ranks' states differ")
        check_state(label, states[0], refs["sssp_bf"][0], None)
        keys = ("iterations", "converged", "world", "migrations", "members")
        if len({tuple(str(r[k]) for k in keys) for r in runs}) != 1:
            raise AssertionError(f"{label}: the ranks' runs differ")
        if runs[0]["iterations"] != refs["sssp_bf"][1]:
            raise AssertionError(f"{label}: {runs[0]['iterations']} "
                                 "iterations, the reference's "
                                 f"{refs['sssp_bf'][1]}")
        world[label] = runs[0]["world"]
        per = {k: [r[k] for r in runs] for k in (
            "s_per_iteration_before_kill", "s_per_iteration_after_kill",
            "first_step_s", "rebuild_s", "transfer_s", "wait_s",
            "overlap_efficiency",
            "copy_gb_per_s", "skipped", "csr_tile_launches",
            "max_live_groups", "wall_s")}
        rates = [r["copy_gb_per_s"] for r in runs if r["copy_gb_per_s"]]
        # the ranks' copies need not overlap in time: their bytes over the
        # run's wall time too
        out["runs"][label] = {
            "iterations": runs[0]["iterations"],
            "members_end": runs[0]["members"],
            "migrations": runs[0]["migrations"], **per,
            "summed_copy_gb_per_s": sum(rates),
            "copy_gb_per_wall_s": sum(r["upload_bytes"] for r in runs)
            / max(r["wall_s"] for r in runs) / 1e9}
    return out, world


def ranks_oocore_vs_one_process(line, world, counters) -> None:
    """5e' (c)'s world counters against the same runs on one process
    (:func:`oocore_one_process`), iteration for iteration."""
    for label, want in zip(RANK_OOCORE_RUNS, counters):
        if world[label] != want:
            raise AssertionError(f"{label}: counters {world[label]}, one "
                                 f"process's {want}")
        line["runs"][label]["one_process_counters_equal"] = True


def ranks_serve_check(tmp, ranks) -> tuple:
    """5e' (d) in the parent: every rank's batch, lookup and replay
    answers bit-identical, and their replay's queries and batch sizes the
    same.  Returns the line's entry and rank 0's answers, held to 5i's by
    :func:`ranks_serve_vs_5i`."""
    import numpy as np

    recs = [r["serve"] for r in ranks]
    answers = {}
    for what in ("khop", "sssp", "ppr", "lookup", "replay"):
        got = [np.load(_rank_file(tmp, f"serve/{what}", r))
               for r in range(RANKS)]
        if any(a.tobytes() != got[0].tobytes() for a in got[1:]):
            raise AssertionError(f"serve/{what}: the ranks' answers differ")
        answers[what] = got[0]
    for key in ("queries", "batch_sizes", "completed", "cached"):
        if len({str(r["replay"][key]) for r in recs}) != 1:
            raise AssertionError(f"serve replay: the ranks' {key} differ")
    if len({str(r["lookup"]["answers"]) for r in recs}) != 1:
        raise AssertionError("serve lookup: the ranks' answers differ")
    rep = recs[0]["replay"]
    if rep["completed"] != rep["requests"]:
        raise AssertionError(f"serve replay: {rep['completed']} of "
                             f"{rep['requests']} completed")
    out = {
        "init_s": [r["init_s"] for r in recs],
        "batches": {k: {"iterations": v["iterations"],
                        "service_s": [r["batches"][k]["service_s"]
                                      for r in recs]}
                    for k, v in recs[0]["batches"].items()},
        "lookup_service_s": [r["lookup"]["service_s"] for r in recs],
        "replay": {k: rep[k] for k in ("requests", "completed", "cached",
                                       "qps", "p50_ms", "p99_ms", "wall_s",
                                       "batch_sizes", "families_built")},
        "replay_wall_s": [r["replay"]["wall_s"] for r in recs]}
    answers["lookup_answers"] = recs[0]["lookup"]["answers"]
    answers["queries"] = rep["queries"]
    return out, answers


def ranks_serve_vs_5i(line, answers, refs) -> None:
    """5e' (d)'s answers against 5i's (``refs``: :func:`phase_serve`'s):
    the batch of 8's khop and sssp columns bit-equal to 5i's, its ppr
    columns held to 5i's float64 solo runs (:func:`check_ppr`); the
    lookup's field and answers to 5i's pagerank reference; each replay
    answer as 5i holds its own (min kinds bit-equal to the solo reference,
    ppr by :func:`check_ppr`, lookups within their tolerance)."""
    import numpy as np

    from repro_torch.graph.algorithms import BATCHED_QUERIES

    g = refs["graph"]
    for kind in ("khop", "sssp"):
        for q in range(SERVE_B):
            got, want = answers[kind][:, q], refs["batch8"][kind][q]
            if not np.array_equal(got, want):
                raise AssertionError(f"ranks4/{kind}/q{q}: not 5i's answer")
    ppr = [check_ppr(f"ranks4/ppr/q{q}", answers["ppr"][:, q],
                     refs["tails"][q]) for q in range(SERVE_B)]
    pr_ref = refs["pr_ref"]
    look = check_answers("ranks4/lookup", "lookup", answers["lookup"],
                         pr_ref[:, 0])
    seeds = refs["seeds"]
    for s, got in zip([(seeds[0], seeds[2], seeds[4]), (seeds[1],)],
                      answers["lookup_answers"]):
        check_answers("ranks4/lookup/answer", "lookup", np.asarray(got),
                      pr_ref[list(s), 0])
    solo = refs["solo"]
    rep_abs, offsets = 0.0, []
    sizes = [q[4] for q in answers["queries"]]
    values = np.split(answers["replay"], np.cumsum(sizes)[:-1])
    for (kind, qseeds, params, _, _), value in zip(answers["queries"],
                                                   values):
        key = (kind, tuple(qseeds), tuple(tuple(p) for p in params))
        if kind == "ppr":
            if key not in solo:
                solo[key] = ppr_tail(g, tuple(qseeds))
            max_abs, _, off = check_ppr("ranks4/replay/ppr", value,
                                        solo[key])
            rep_abs = max(rep_abs, max_abs)
            offsets.append(off)
            continue
        if kind == "lookup":
            want = pr_ref[np.asarray(qseeds), 0]
        else:
            if key not in solo:
                prog = BATCHED_QUERIES[kind](g, [tuple(qseeds)],
                                             **dict(params))
                solo[key] = serve_reference(g, prog)[0][:, 0]
            want = solo[key]
        rep_abs = max(rep_abs, check_answers(f"ranks4/replay/{kind}", kind,
                                             value, want))
    line.update(ppr_max_abs_err_vs_reference=max(x[0] for x in ppr),
                ppr_l1_share_vs_reference=max(x[1] for x in ppr),
                ppr_stop_offsets=[x[2] for x in ppr],
                lookup_max_abs_err_vs_reference=look,
                replay_max_abs_err_vs_reference=rep_abs,
                replay_ppr_stop_offsets=offsets)


def phase_ranks(g, refs, resident4, mesh_its, seed, g_e, refs_e) -> tuple:
    """Phase 5e' (see the module docstring).  ``resident4``: phase 5e's
    runs (name → (label, state, ...)); ``mesh_its``: their iterations by
    name; ``g_e`` / ``refs_e``: 5g's graph and its references, which the
    epoch and serving arms run on.  Returns the phase's line, the ranks'
    csr_tile launches, the async arm's state on phase 3's graph (held to
    phase 5f's afterwards) and what (c) and (d) are held to 5h's and 5i's
    by afterwards."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import plug
    from repro_torch.graph import generate
    from repro_torch.graph.algorithms import sssp_bf
    from repro_torch.launch.mesh import spawn_ranks

    n = g.num_vertices
    t0 = time.perf_counter()
    gr = generate.grid_road(ROAD_SIDE, seed=ROAD_SEED)
    road_rec, road_state = road_async_mesh4(
        gr, sssp_bf(gr, sources=[0, 1, 2, 3]))
    graphs = {"rmat": g, "road": gr, "elastic": g_e}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        t1 = time.perf_counter()
        for name, graph in graphs.items():
            for k in ("src", "dst", "weights"):
                np.save(Path(tmp) / f"{name}.{k}.npy", getattr(graph, k))
        write_s = time.perf_counter() - t1
        sizes = {name: graph.num_vertices for name, graph in graphs.items()}
        t1 = time.perf_counter()
        budget, oocore_counters = oocore_one_process(
            g_e, sssp_bf(g_e, sources=[0, 1, 2, 3]),
            plug.HostUpperSystem().partition(g_e, SHARDS))
        oocore_one_s = time.perf_counter() - t1
        ranks = spawn_ranks(ranks_world, RANKS, (tmp, sizes, seed, budget),
                            backend="gloo",
                            init_method=f"file://{tmp}/init",
                            timeout_s=RANKS_TIMEOUT_S)
        world_s = time.perf_counter() - t1 - write_s
        out = {"phase": "ranks", "world": RANKS, "shards": SHARDS,
               "reduced": {
                   "epochs": f"(b) runs on 5g's R-MAT of scale "
                             f"{ELASTIC_SCALE}, not {n.bit_length() - 1}, "
                             "to keep the smoke well inside its time limit",
                   "road": f"(a) on grid_road({ROAD_SIDE}) runs "
                           f"{ROAD_ITERATIONS} iterations, as 5h's road "
                           "runs do",
                   "oocore": f"(c) runs on 5g's R-MAT of scale "
                             f"{ELASTIC_SCALE}, not {n.bit_length() - 1}, "
                             "held to the same runs on one process there, "
                             "to keep the smoke well inside its time "
                             "limit"},
               "backend": sorted({r["backend"] for r in ranks}),
               "devices": [r["device"] for r in ranks],
               "shards_by_rank": [r["shards"] for r in ranks],
               "caveat": RANKS_CAVEAT, "write_npy_s": write_s,
               "road_mesh4": road_rec, "world_s": world_s,
               "load_s": [r["load_s"] for r in ranks],
               "partition_s": [r["partition_s"] for r in ranks],
               "all_reduce_ms": [r["all_reduce_ms"] for r in ranks],
               "runs": {}}
        launches = 0
        for label, name, model, loop, upper_kw in RANK_RUNS:
            recs = [r["runs"][label] for r in ranks]
            states = [np.load(_rank_file(tmp, label, r)) for r in range(RANKS)]
            if any(st.tobytes() != states[0].tobytes() for st in states[1:]):
                raise AssertionError(f"{label}: the ranks' states differ")
            if len({(r["iterations"], r["converged"]) for r in recs}) != 1:
                raise AssertionError(f"{label}: the ranks' runs differ")
            its = recs[0]["iterations"]
            k = states[0].shape[1]
            run = {"iterations": its, "loop": recs[0]["loop"],
                   "per_iteration_s": [r["per_iteration_s"] for r in recs],
                   "init_s": [r["init_s"] for r in recs],
                   "setup_s": [r["setup_s"] for r in recs],
                   "csr_tile_launches": [r["csr_tile_launches"]
                                         for r in recs],
                   "fetches_per_iteration": [r["fetches_per_iteration"]
                                             for r in recs],
                   "wire_stats": recs[0]["wire_stats"]}
            launches += sum(run["csr_tile_launches"])
            if loop == "fused":
                want_label, want = resident4[name][:2]
                tol = None if name == "sssp_bf" else (PR_RTOL, PR_ATOL)
                run["max_abs_err_vs_mesh4"] = check_state(
                    f"{label} vs {want_label}", states[0], want, tol)
                if its != mesh_its[name]:
                    raise AssertionError(f"{label}: {its} iterations, "
                                         f"{want_label} ran {mesh_its[name]}")
                if run["csr_tile_launches"] != [its] * RANKS:
                    raise AssertionError(f"{label}: csr_tile launches "
                                         f"{run['csr_tile_launches']}, "
                                         f"expected {its} on each rank")
                if any(r["fetches_per_iteration"] != 1
                       or r["vertex_sized_fetches"] != 1 for r in recs):
                    raise AssertionError(f"{label}: fetches {recs}")
                run["mesh4_run"] = want_label
                run["all_reduce_bytes"] = {
                    "aggregate": n * k * 4, "counts": n * 4,
                    "blocks_run": SHARDS * 4}
            elif not upper_kw:
                run["max_abs_err_vs_reference"] = check_state(
                    label, states[0], refs[name][0], None)
                if min(run["csr_tile_launches"]) == 0:
                    raise AssertionError(f"{label}: no csr_tile launch")
                run["all_reduce_bytes"] = {"aggregate": n * k * 4,
                                           "counts": n * 4}
            else:
                digests = {tuple(r["merge_digests"]) for r in recs}
                if len(digests) != 1:
                    raise AssertionError(f"{label}: the ranks' merges differ")
                aggs = np.concatenate([np.load(_rank_file(tmp, label, r,
                                                          "aggs"))
                                       for r in range(RANKS)], axis=1)
                merged = np.load(_rank_file(tmp, label, 0, "merged"))
                run.update(host_wire(list(zip(aggs, merged)), RANKS,
                                     upper_kw["bits"]))
                if not np.isfinite(states[0]).all():
                    raise AssertionError(f"{label}: non-finite state")
                run["all_reduce_bytes"] = {"scale": 4,
                                           "int32_codes": n * k * 4,
                                           "counts": n * 4}
            out["runs"][label] = run
        out["async"] = {}
        for label, name, _ in RANK_ASYNC_RUNS:
            line, state = ranks_async_check(tmp, ranks, label)
            out["async"][label] = line
            launches += sum(line["csr_tile_launches"])
            if name == "rmat":
                async_state = state
                continue
            ranks_async_vs_mesh4(line, state, road_rec, road_state)
            if line["held_device_iterations"] == 0 or \
                    sum(line["rank_held_iterations"]) == 0:
                raise AssertionError(f"{label}: no device held")
        out["epochs"] = ranks_epochs_check(tmp, ranks, g_e, refs_e, seed)
        launches += sum(sum(r["csr_tile_launches"])
                        for r in out["epochs"]["runs"].values())
        out["oocore"], oocore_world = ranks_oocore_check(tmp, ranks,
                                                         refs_e)
        out["oocore"]["hbm_budget"] = budget
        out["oocore"]["one_process_s"] = oocore_one_s
        ranks_oocore_vs_one_process(out["oocore"], oocore_world,
                                    oocore_counters)
        launches += sum(sum(r["csr_tile_launches"])
                        for r in out["oocore"]["runs"].values())
        out["serve"], serve_answers = ranks_serve_check(tmp, ranks)
        launches += sum(r["serve"]["launches"] for r in ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out, launches, async_state, (oocore_world, serve_answers)


# benchmarks/bench_accel.py's skewed R-MAT (_async_skew_table; no dedup)
SKEWED_RMAT = {"a": 0.7, "b": 0.15, "c": 0.1}
ASYNC_ARMS = (  # README's arms (benchmarks/bench_accel.py ASYNC_SKEW_ARMS)
    ("eager", dict(theta0=0.0, decay=0.5)),
    ("holding", dict(theta0=10.0, decay=0.9)),
    ("buckets", dict(theta0=10.0, decay=0.9, bucket_k=8)))


def executed_runs(rec) -> tuple:
    """The logical devices that ran their body in one async record — those
    that ran a tile: an executing device's backlog holds a source whose
    edges it owns — and the number of maximal runs of consecutive ones."""
    m = rec["devices"]
    per = len(rec["shard_blocks_run"]) // m
    ran = [sum(rec["shard_blocks_run"][g * per:(g + 1) * per]) > 0
           for g in range(m)]
    runs = sum(1 for g in range(m) if ran[g] and (g == 0 or not ran[g - 1]))
    return ran, runs


def async_run(label, g, parts, prog, kw, ref, tol, max_it, bsp,
              frontier=None) -> tuple:
    """One fused async run of phase 5f (``AsyncModel(**kw)`` at
    ``mesh=SHARDS``, ``CSRConfig()`` pinned) with its checks; ``bsp`` is
    the (label, s an iteration) of the same program's barriered run at
    ``mesh=SHARDS`` on the same graph and frontier.  Returns its line, its
    csr_tile launches and its middleware."""
    from repro_torch import plug
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels.ops import CSRConfig

    daemon = plug.ShardedDaemon(kernel="cuda", csr_config=CSRConfig())
    per_call = []  # csr_tile launches of each run_all_shards call
    run_all = daemon.run_all_shards

    def counted(*args, **kwargs):
        before = ebk.csr_tile.launches
        result = run_all(*args, **kwargs)
        per_call.append(ebk.csr_tile.launches - before)
        return result

    def timed():
        per_call.clear()
        daemon.instrument = True
        daemon.reset_counters()

    daemon.run_all_shards = counted
    res, launches, mw, rec = run_e2e(
        label, g, prog, daemon, plug.AsyncModel(**kw), parts, ref, tol,
        upper=plug.MeshUpperSystem(mesh=SHARDS), max_iterations=max_it,
        on_timed=timed, frontier=frontier)
    recs = res.per_iteration
    if len(per_call) != res.iterations or not all(
            r.get("async") for r in recs):
        raise AssertionError(f"{label}: {len(per_call)} daemon calls over "
                             f"{res.iterations} async iterations")
    want_tile, held = 0, 0
    for r, launched in zip(recs, per_call):
        ran, n_runs = executed_runs(r)
        if (sum(ran) != r["gen_run"]
                or r["gen_run"] + r["gen_skipped"] != SHARDS):
            raise AssertionError(
                f"{label}: iteration {r['iteration']}: devices that ran a "
                f"tile {ran}, gen_run {r['gen_run']}, gen_skipped "
                f"{r['gen_skipped']}")
        for dev, may_run in enumerate(r["run_mask"]):
            if not may_run:
                held += 1
                if ran[dev]:
                    raise AssertionError(
                        f"{label}: held device {dev} ran tiles at "
                        f"iteration {r['iteration']}")
        if launched != n_runs:
            raise AssertionError(
                f"{label}: iteration {r['iteration']}: csr_tile launched "
                f"{launched} times for {n_runs} runs of executing devices")
        want_tile += n_runs
    check_fused_run(label, res, mw, rec, launches, want_tile, kind="async")
    gen_run = sum(r["gen_run"] for r in recs)
    gen_skipped = sum(r["gen_skipped"] for r in recs)
    if daemon.gen_invocations != gen_run:
        raise AssertionError(f"{label}: {daemon.gen_invocations} device "
                             f"bodies ran, records say {gen_run}")
    if kw.get("bucket_k") and daemon.bucket_invocations != gen_skipped:
        raise AssertionError(f"{label}: {daemon.bucket_invocations} bucket "
                             f"runs for {gen_skipped} skipped device bodies")
    bsp_label, bsp_s = bsp
    rec.update(phase="async", bsp_run=bsp_label, bsp_per_iteration_s=bsp_s,
               async_over_bsp=rec["per_iteration_s"] / bsp_s,
               gen_run=gen_run, gen_skipped=gen_skipped,
               held_device_iterations=held,
               bucket_invocations=daemon.bucket_invocations,
               csr_tile_launches_per_iteration=list(per_call),
               refreshed=[r["refreshed"] for r in recs],
               theta_last=recs[-1]["theta"])
    return rec, launches["csr_tile"], mw


def phase_async(g, parts, pr, sp, refs, mesh4, seed) -> tuple:
    """Phase 5f: the fused async loop (``AsyncModel``, ``AsyncDriveLoop``)
    at ``mesh=SHARDS`` with ``CSRConfig()`` pinned: sssp_bf to its fixed
    point under the three arms and pagerank ``eager`` for PR_ITERATIONS,
    each against ``run_reference``, beside phase 5e's run of the same
    program (``mesh4``: a program's name → (label, s an iteration)); then
    sssp_bf ``holding`` as the JAX package's async benchmark runs it — its
    skewed R-MAT (here at 5g's ``ELASTIC_SCALE``, the same edge factor),
    the four sources the only active vertices — beside the barriered run
    of the same.  Returns the phase's line and its csr_tile launches."""
    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.graph import generate
    from repro_torch.graph.algorithms import sssp_bf
    from repro_torch.kernels.ops import CSRConfig

    n = g.num_vertices
    out = {"phase": "async", "m": SHARDS, "reduced": {
        "pagerank": f"the eager arm only, {PR_ITERATIONS} iterations "
                    "(theta at the floor: BSP's trajectory); a holding "
                    "pagerank to its fixed point is too slow at scale 20",
        "skewed": "Graph500's R-MAT with every vertex active skips few or "
                  "no device bodies in the holding arm (gen_skipped), so "
                  "holding and buckets also run as "
                  "benchmarks/bench_accel.py's async table does: its "
                  "skewed R-MAT (a=0.7, b=0.15, c=0.1, no dedup) at the "
                  "same edge factor, sources 0-3 the only active "
                  "vertices; there holding must skip a body.  Only holding "
                  "runs there: buckets' checks are those it passes on "
                  "Graph500's R-MAT",
        "skewed_scale": f"the skewed R-MAT at 5g's scale {ELASTIC_SCALE}, "
                        f"not {g.num_vertices.bit_length() - 1}: its "
                        "generation and two constructions took ~45 s at "
                        "scale 20, and the smoke's last line came at 960 s "
                        "on a slow machine"}}
    launches_tile = 0

    def keep(label, rec, launches, mw, profile=False, frontier=None):
        nonlocal launches_tile
        if profile:
            prof = fused_profile(mw, frontier)
            rec.update(profile=prof, device_idle_share_unprofiled=(
                1.0 - prof["device_busy_s_per_iteration"]
                / rec["per_iteration_s"]))
        out[label] = rec
        launches_tile += launches
        del mw
        torch.cuda.empty_cache()

    runs = [(f"sssp_bf/async-{arm}/mesh4", sp, kw, None, None)
            for arm, kw in ASYNC_ARMS]
    runs.append(("pagerank/async-eager/mesh4", pr, ASYNC_ARMS[0][1],
                 (PR_RTOL, PR_ATOL), PR_ITERATIONS))
    states = {}  # each sssp_bf arm's state, for phase 5e''s (a)
    for label, prog, kw, tol, max_it in runs:
        ref, ref_it = refs[prog.name]
        rec, launches, mw = async_run(label, g, parts, prog, kw, ref, tol,
                                      max_it, mesh4[prog.name])
        if prog is pr and rec["iterations"] != ref_it:
            raise AssertionError(f"{label}: {rec['iterations']} iterations, "
                                 f"reference ran {ref_it}")
        if prog is sp:
            states[label] = np.asarray(mw._last_state)
        keep(label, rec, launches, mw, profile="holding" in label)

    # -- the skewed R-MAT: where devices hold
    t0 = time.perf_counter()
    n = 1 << ELASTIC_SCALE
    gs = generate.rmat_stream(n, EDGE_FACTOR * n, seed=seed, **SKEWED_RMAT)
    parts_s = plug.HostUpperSystem().partition(gs, SHARDS)
    sps = sssp_bf(gs, sources=[0, 1, 2, 3])
    # from the sources alone: the fixed point is run_reference's, since
    # every other vertex starts unreached and sends nothing
    frontier = np.zeros(n, dtype=bool)
    frontier[:4] = True
    ref_s, ref_s_it = plug.run_reference(gs, sps, device="cuda")
    out["skewed_graph"] = {"rmat": SKEWED_RMAT, "scale": ELASTIC_SCALE,
                           "edges": gs.num_edges,
                           "reference_iterations": ref_s_it,
                           "data_s": time.perf_counter() - t0}
    bsp_label = "sssp_bf/skewed/sharded-cuda/mesh4/gas"
    res, launches, mw, rec = run_e2e(
        bsp_label, gs, sps, plug.ShardedDaemon(kernel="cuda",
                                               csr_config=CSRConfig()),
        "gas", parts_s, ref_s, None, upper=plug.MeshUpperSystem(mesh=SHARDS),
        frontier=frontier)
    check_fused_run(bsp_label, res, mw, rec, launches, res.iterations)
    keep(bsp_label, rec, launches["csr_tile"], mw)
    bsp = (bsp_label, rec["per_iteration_s"])
    for arm, kw in ASYNC_ARMS[1:2]:
        label = f"sssp_bf/skewed/async-{arm}/mesh4"
        rec, launches, mw = async_run(label, gs, parts_s, sps, kw, ref_s,
                                      None, None, bsp, frontier)
        if "holding" in label and rec["gen_skipped"] == 0:
            raise AssertionError(f"{label}: no device body was skipped")
        keep(label, rec, launches, mw, profile="holding" in label,
             frontier=frontier)
    return out, launches_tile, states


# phase 5g: the structure-epoch layer.  Events fire before their iteration
# runs; every one is due at iteration 2 or later, so the warm-up iteration
# consumes none.
ELASTIC_KILL = [(3, 2)]                       # device 2 dies: 4 → 2
ELASTIC_JOIN = {"kills": [(2, 1)], "recoveries": [(5, 1)]}  # 4 → 2 → 4
STRAGGLER_IT, STRAGGLER, STRAGGLER_X = 2, 1, 3.0  # 3× the others' step
MUTATION_EDGES = 65536                        # each batch, all in shard 0
MUTATION_IT = 3
ELASTIC_SCALE = 18  # 5g's graph (phase 3's is scale 20)
WEIGHT_RANGE = (1.0, 10.0)                    # generate.rmat_stream's


def probe_loop(mw, calls: list, its: list) -> None:
    """Wraps one fused middleware's structure poll, epoch adoption, step
    and record read: for each iteration, ``its`` gets the seconds and the
    device→host fetches of its rebuild (poll + adoption) apart from those
    of its step (the step and its one fetch), and its csr_tile launches."""
    from repro_torch.kernels import edge_block as ebk

    loop = mw._loop
    poll, adopt = mw._poll_structure, loop._adopt_epoch
    advance, read = loop._advance, loop._read_extra

    def polled(it):
        t0, f0 = time.perf_counter(), len(calls)
        out = poll(it)
        its.append({"iteration": it, "rebound": False,
                    "rebuild_s": time.perf_counter() - t0,
                    "rebuild_fetches": calls[f0:]})
        return out

    def adopted(*args):
        cur = its[-1]
        t0, f0 = time.perf_counter(), len(calls)
        out = adopt(*args)
        cur["rebuild_s"] += time.perf_counter() - t0
        cur["rebuild_fetches"] = cur["rebuild_fetches"] + calls[f0:]
        cur["rebound"] = True
        return out

    def advanced(*args):
        its[-1].update(t=time.perf_counter(), f=len(calls),
                       l=ebk.csr_tile.launches)
        return advance(*args)

    def read_extra(carry, extra):
        cur = its[-1]
        cur["step_s"] = time.perf_counter() - cur.pop("t")
        cur["step_fetches"] = calls[cur.pop("f"):]
        cur["csr_tile"] = ebk.csr_tile.launches - cur.pop("l")
        return read(carry, extra)

    mw._poll_structure = polled
    loop._adopt_epoch = adopted
    loop._advance = advanced
    loop._read_extra = read_extra


def check_probed(label, res, mw, its, calls, n) -> dict:
    """Phase 5g's per-iteration checks of a probed fused run: exactly one
    small fetch in each step; none in a BSP rebuild, and nothing
    vertex-sized in any rebuild; csr_tile once per iteration under BSP and
    once per run of executing devices under the async model; one
    vertex-sized fetch in the run (the final state).  Returns the step
    times, rebuild fetches and launches."""
    if len(its) != res.iterations:
        raise AssertionError(f"{label}: {len(its)} probed iterations of "
                             f"{res.iterations}")
    for i, r in zip(its, res.per_iteration):
        if len(i["step_fetches"]) != 1 or i["step_fetches"][0][1] >= n:
            raise AssertionError(f"{label}: iteration {i['iteration']}: "
                                 f"step fetches {i['step_fetches']}")
        small = [c for c in i["rebuild_fetches"] if c[1] < n]
        if len(small) != len(i["rebuild_fetches"]) or (
                small and (mw._fused_kind == "bsp" or not i["rebound"])):
            raise AssertionError(f"{label}: iteration {i['iteration']}: "
                                 f"rebuild fetches {i['rebuild_fetches']}")
        want = (executed_runs(r)[1] if mw._fused_kind == "async" else 1)
        if i["csr_tile"] != want:
            raise AssertionError(f"{label}: iteration {i['iteration']}: "
                                 f"csr_tile launched {i['csr_tile']} times, "
                                 f"expected {want}")
    big = [c for c in calls if c[1] >= n]
    if big != [("cpu", n * mw.k)]:
        raise AssertionError(f"{label}: vertex-sized fetches {big}")
    steps = [i["step_s"] for i in its]
    return {"step_s": steps, "s_per_iteration": sum(steps) / len(steps),
            "rebuild_fetches": sum(len(i["rebuild_fetches"]) for i in its),
            "csr_tile_per_iteration": [i["csr_tile"] for i in its]}


def elastic_run(label, g, prog, model, ref, tol, *, failures=None,
                mutations=None, expect=(), tiles=None) -> tuple:
    """One fused run of phase 5g at ``mesh=SHARDS`` with ``CSRConfig()``
    pinned, its structure triggers given: a warm-up iteration, then the
    probed run (:func:`probe_loop`) checked against ``ref`` and
    :func:`check_probed`.  ``expect`` lists, per rebind in order, the
    record entries the rebind must carry; ``tiles`` the (recut, reused)
    tilesets the run's rebinds must add.  Returns its line, its csr_tile
    launches and its middleware."""
    import torch

    from repro_torch import plug
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels.ops import CSRConfig

    n = g.num_vertices
    daemon = plug.ShardedDaemon(kernel="cuda", mesh=SHARDS,
                                csr_config=CSRConfig())
    t0 = time.perf_counter()
    mw = plug.Middleware(g, prog, daemon=daemon,
                         upper=plug.MeshUpperSystem(mesh=SHARDS),
                         model=model, num_shards=SHARDS, failures=failures,
                         mutations=mutations, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mw.run(max_iterations=1)
    torch.cuda.synchronize()
    base = (daemon.tiles_recut, daemon.tilesets_reused)
    calls, its, causes = [], [], []
    probe_loop(mw, calls, its)
    mw.epochs.subscribe("probe", lambda new, old: causes.append(new.cause))
    before = ebk.csr_tile.launches
    with counting_fetches(calls):
        res = mw.run()
    torch.cuda.synchronize()
    launches = ebk.csr_tile.launches - before
    max_abs = check_state(label, res.state, ref, tol)
    probed = check_probed(label, res, mw, its, calls, n)
    rebinds = []
    for i, r in zip(its, res.per_iteration):
        if not i["rebound"]:
            continue
        ev = r.get("migration") or r.get("mutation")
        rec = {"iteration": r["iteration"],
               "cause": causes[len(rebinds)] if len(causes) > len(rebinds)
               else None,
               "seconds": ev["seconds"], "rebuild_s_probed": i["rebuild_s"],
               "rebuild_fetches": len(i["rebuild_fetches"])}
        rec.update({k: v for k, v in ev.items()
                    if k not in ("seconds", "dirty_vertices", "assignment")})
        if "migration" in r:
            dv = ev["dirty_vertices"]
            rec["dirty_vertices"] = "all" if dv is None else len(dv)
            rec["assignment"] = ev["assignment"]
        rebinds.append(rec)
    if not (len(rebinds) == len(causes) == len(expect)):
        raise AssertionError(f"{label}: {len(rebinds)} rebinds of "
                             f"{len(causes)} epochs, expected {len(expect)}")
    for got, want in zip(rebinds, expect):
        for k, v in want.items():
            if got.get(k) != v:
                raise AssertionError(f"{label}: rebind at iteration "
                                     f"{got['iteration']}: {k}={got.get(k)}"
                                     f", expected {v}")
    added = (daemon.tiles_recut - base[0], daemon.tilesets_reused - base[1])
    if tiles is not None and added != tiles:
        raise AssertionError(f"{label}: tilesets recut/reused {added}, "
                             f"expected {tiles}")
    if not res.converged and prog.name != "pagerank":
        raise AssertionError(f"{label}: did not converge")
    # the step times cut at each rebind, with the axis length they ran at
    segments, devices, start = [], SHARDS, 0
    for k in [j for j, i in enumerate(its) if i["rebound"]] + [len(its)]:
        if k > start:
            steps = probed["step_s"][start:k]
            segments.append({"from_iteration": start + 1, "devices": devices,
                             "iterations": k - start,
                             "s_per_iteration": sum(steps) / len(steps),
                             "median_s": sorted(steps)[len(steps) // 2]})
        if k < len(its):
            devices = next(r for r in rebinds if r["iteration"] == k + 1
                           ).get("devices_after", devices)
        start = k
    return {"run": label, "model": getattr(model, "name", model),
            "init_s": init_s, "iterations": res.iterations,
            "converged": res.converged, "wall_s": res.wall_time,
            "max_abs_err_vs_reference": max_abs, "rebinds": rebinds,
            "epoch": mw.epochs.version, "devices_end": mw.daemon.m,
            "tilesets_recut_reused": list(added), "segments": segments,
            **probed}, launches, mw


def shard0_batches(parts, n, seed) -> tuple:
    """The phase's add batch: MUTATION_EDGES edges whose sources own
    out-edges in shard 0 (so only shard 0 is dirty), destinations uniform,
    weights in the generator's range; drawn from ``seed``."""
    import numpy as np

    from repro_torch import plug

    rng = np.random.default_rng(seed)
    src = rng.choice(np.unique(parts[0].src), MUTATION_EDGES)
    dst = rng.integers(0, n, MUTATION_EDGES)
    w = rng.uniform(*WEIGHT_RANGE, MUTATION_EDGES)
    log = plug.MutationLog()
    for s, d, x in zip(src.tolist(), dst.tolist(), w.tolist()):
        log.add_edge(s, d, x)
    return log.freeze()


def shard0_removals(part, seed):
    """MUTATION_EDGES distinct (src, dst) pairs of ``part``'s edges, drawn
    from ``seed``, as a removal batch."""
    import numpy as np

    from repro_torch import plug

    rng = np.random.default_rng(seed + 1)
    key = part.src.astype(np.int64) * part.num_vertices + part.dst
    pairs = rng.choice(np.unique(key), MUTATION_EDGES, replace=False)
    log = plug.MutationLog()
    for k in pairs.tolist():
        log.remove_edge(k // part.num_vertices, k % part.num_vertices)
    return log.freeze()


def phase_elastic(g, parts, pr, sp, refs, mesh4, seed, host_sp,
                  host_ref) -> tuple:
    """Phase 5g: the structure-epoch layer at ``mesh=SHARDS`` with
    ``CSRConfig()`` pinned — kills, a join, a straggler, rebalances and
    mutation batches, each against ``run_reference`` on the post-trigger
    graph.  ``mesh4`` maps a program's name to phase 5e's (label, s an
    iteration); ``host_sp`` holds phase 5's host-loop sssp_bf middleware
    (phase 3's graph, whose reference state is ``host_ref``), which (f)
    takes out and rebalances.  Returns the phase's line and its csr_tile
    launches."""
    import numpy as np
    import torch

    from repro_torch import plug
    from repro_torch.graph import mutation
    from repro_torch.kernels import autotune
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels.ops import CSRConfig

    n = g.num_vertices
    sweeps = autotune.CACHE.sweeps
    out = {"phase": "elastic", "m": SHARDS, "runs": [], "mesh4_runs": {
        k: {"run": v[0], "s_per_iteration": v[1]} for k, v in mesh4.items()},
        "reduced": {"rebalance": "the host loop's rebalance runs only after "
                    "it, on phase 5's sssp_bf/cuda/gas middleware: its run "
                    "before is phase 5's",
                    "scale": f"an R-MAT graph of scale {ELASTIC_SCALE} "
                    "(phase 3's is 20) for every run but the host "
                    "rebalance, which stays on phase 5's graph"},
        "vertices": n, "edges": g.num_edges}
    launches_tile = 0
    sp_ref = refs[sp.name][0]
    pr_ref = refs[pr.name][0]
    gone = {"killed": [2], "devices_before": SHARDS, "devices_after": 2}

    def keep(rec, launches, mw):
        """Prints the run's own line at once, so a later failure keeps
        it."""
        nonlocal launches_tile
        emit({**rec, "phase": "elastic"})
        out["runs"].append(rec["run"])
        launches_tile += launches
        del mw
        torch.cuda.empty_cache()

    # (a)–(e): kills, a join, a straggler
    holding = plug.AsyncModel(theta0=10.0, decay=0.9)
    slow = [(STRAGGLER_IT, d, STRAGGLER_X if d == STRAGGLER else 1.0)
            for d in range(SHARDS)]
    runs = (
        ("sssp_bf/kill/gas", sp, "gas", sp_ref, None,
         dict(kills=ELASTIC_KILL), [gone], (0, SHARDS)),
        ("sssp_bf/kill/async-holding", sp, holding, sp_ref, None,
         dict(kills=ELASTIC_KILL), [gone], (0, SHARDS)),
        ("pagerank/kill/bsp", pr, "bsp", pr_ref, (PR_RTOL, PR_ATOL),
         dict(kills=ELASTIC_KILL), [gone], (0, SHARDS)),
        ("sssp_bf/kill-join/gas", sp, "gas", sp_ref, None, ELASTIC_JOIN,
         [{"killed": [1], "devices_after": 2},
          {"joined": [1], "devices_after": SHARDS}], (0, 2 * SHARDS)),
        ("sssp_bf/straggler/gas", sp, "gas", sp_ref, None, dict(slow=slow),
         [{"stragglers": [STRAGGLER], "repartitioned": True,
           "devices_after": SHARDS}], (SHARDS, 0)))
    for label, prog, model, ref, tol, sched, expect, tiles in runs:
        rec, launches, mw = elastic_run(
            label, g, prog, model, ref, tol,
            failures=plug.FailureSchedule(**sched), expect=expect,
            tiles=tiles)
        if prog is pr and rec["iterations"] != refs[pr.name][1]:
            raise AssertionError(f"{label}: {rec['iterations']} iterations")
        keep(rec, launches, mw)

    # (f): rebalance between runs, fused and on the host loop (phase 5's
    # sssp_bf/cuda/gas middleware, whose run before the rebalance is
    # phase 5's)
    caps = np.linspace(1.0, 2.0, SHARDS)
    fused_mw = plug.Middleware(
        g, sp, model="gas", num_shards=SHARDS, device="cuda",
        daemon=plug.ShardedDaemon(kernel="cuda", mesh=SHARDS,
                                  csr_config=CSRConfig()),
        upper=plug.MeshUpperSystem(mesh=SHARDS))
    fused_mw.run(max_iterations=1)
    for label, fused in (("sssp_bf/rebalance/sharded-cuda/gas", True),
                         ("sssp_bf/rebalance/cuda/gas", False)):
        mw = fused_mw if fused else host_sp.pop()
        rec = {"run": label, "fused": fused}
        for when in ("before", "after") if fused else ("after",):
            if when == "after":
                t0 = time.perf_counter()
                fr = mw.rebalance(capacities=caps)
                torch.cuda.synchronize()
                rec["rebalance_s"] = time.perf_counter() - t0
                rec["fractions"] = [float(f) for f in fr]
                t0 = time.perf_counter()
                mw.run(max_iterations=1)  # the host daemon compacts here
                torch.cuda.synchronize()
                rec["first_iteration_after_s"] = time.perf_counter() - t0
            l0 = ebk.csr_tile.launches
            res = mw.run()
            torch.cuda.synchronize()
            launched = ebk.csr_tile.launches - l0
            rec[when] = {
                "iterations": res.iterations,
                "s_per_iteration": res.wall_time / res.iterations,
                "csr_tile_per_iteration": launched / res.iterations,
                "max_abs_err_vs_reference": check_state(
                    f"{label}/{when}", res.state,
                    sp_ref if fused else host_ref, None)}
            if fused and launched != res.iterations:
                raise AssertionError(f"{label}: csr_tile {launched} over "
                                     f"{res.iterations} iterations")
            if launched == 0:
                raise AssertionError(f"{label}: csr_tile never launched")
            launches_tile += launched
        if mw.epochs.epoch.cause != "rebalance":
            raise AssertionError(f"{label}: epoch {mw.epochs.epoch.cause}")
        keep(rec, 0, mw)
    del fused_mw, mw

    # (g)–(i): mutation batches in shard 0
    t0 = time.perf_counter()
    add = shard0_batches(parts, n, seed)
    out["batches"] = {"edges": MUTATION_EDGES, "build_s":
                      time.perf_counter() - t0}
    g2, _ = mutation.apply_to_graph(g, add)  # the post-batch graph
    t0 = time.perf_counter()
    ref2, ref2_it = plug.run_reference(g2, sp, device="cuda")
    out["batches"]["reference_s"] = time.perf_counter() - t0
    out["batches"]["reference_iterations"] = ref2_it
    rec, launches, mw = elastic_run(
        "sssp_bf/add-mid-run/gas", g, sp, "gas", ref2, None,
        mutations=plug.MutationSchedule(events=[(MUTATION_IT, add)]),
        expect=[{"iteration": MUTATION_IT, "incremental": True,
                 "edges_added": MUTATION_EDGES}], tiles=(1, SHARDS - 1))
    if mw.epochs.epoch.meta["shards_recut"] != 1:
        raise AssertionError("add-mid-run: shards_recut "
                             f"{mw.epochs.epoch.meta['shards_recut']}")
    rec["shards_recut"] = mw.epochs.epoch.meta["shards_recut"]
    keep(rec, launches, mw)

    # the cold run of the add batch's graph, beside the incremental one
    label = "sssp_bf/cold-after-add/gas"
    res, launches, mw, crec = run_e2e(
        label, g2, sp, plug.ShardedDaemon(kernel="cuda", mesh=SHARDS,
                                          csr_config=CSRConfig()),
        "gas", plug.HostUpperSystem().partition(g2, SHARDS), ref2, None,
        upper=plug.MeshUpperSystem(mesh=SHARDS))
    check_fused_run(label, res, mw, crec, launches, res.iterations)
    cold_it = res.iterations
    keep(crec, launches["csr_tile"], mw)

    rec = {"run": "sssp_bf/run_dynamic/gas", "cold_run": label,
           "cold_iterations": cold_it}
    daemon = plug.ShardedDaemon(kernel="cuda", mesh=SHARDS,
                                csr_config=CSRConfig())
    mw = plug.Middleware(g, sp, daemon=daemon, model="gas",
                         upper=plug.MeshUpperSystem(mesh=SHARDS),
                         num_shards=SHARDS, device="cuda")
    mw.run(max_iterations=1)
    res = mw.run()
    check_state("run_dynamic/converged", res.state, sp_ref, None)
    rec["converged_run"] = {"iterations": res.iterations,
                            "s_per_iteration": res.wall_time
                            / res.iterations}
    for key, batch, ref_state, mode, label in (
            ("add", add, ref2, "dirty", "h"),
            ("remove", None, None, "cold_fallback", "i")):
        if batch is None:
            t0 = time.perf_counter()
            batch = shard0_removals(mw.partitions[0], seed)
            rec["removal_build_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref_state, _ = plug.run_reference(
                mutation.apply_to_graph(mw.graph, batch)[0], sp,
                device="cuda")
            rec["removal_reference_s"] = time.perf_counter() - t0
        base = (daemon.tiles_recut, daemon.tilesets_reused)
        calls, its = [], []
        probe_loop(mw, calls, its)
        l0 = ebk.csr_tile.launches
        t0 = time.perf_counter()
        with counting_fetches(calls):
            res = mw.run_dynamic(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = ebk.csr_tile.launches - l0
        ep = mw.epochs.epoch
        lr = mw.last_restart
        if lr["mode"] != mode or ep.meta["shards_recut"] != 1:
            raise AssertionError(f"run_dynamic {key}: mode {lr['mode']}, "
                                 f"shards_recut {ep.meta['shards_recut']}")
        added = (daemon.tiles_recut - base[0],
                 daemon.tilesets_reused - base[1])
        if added != (1, SHARDS - 1):
            raise AssertionError(f"run_dynamic {key}: tilesets recut/reused "
                                 f"{added}")
        if key == "add" and not np.array_equal(mw.graph.src, g2.src):
            raise AssertionError("run_dynamic add: another mutated graph")
        probed = check_probed(f"run_dynamic/{key}", res, mw, its, calls, n)
        rec[key] = {
            "case": label, "mode": lr["mode"], "reason": lr["reason"],
            "iterations": res.iterations, "dirty_count": lr["dirty_count"],
            "apply_s": ep.meta["seconds"], "wall_s": wall,
            "run_s_per_iteration": res.wall_time / res.iterations,
            "edges_added": ep.meta["edges_added"],
            "edges_removed": ep.meta["edges_removed"],
            "shards_recut": ep.meta["shards_recut"],
            "tilesets_recut_reused": list(added),
            "max_abs_err_vs_reference": check_state(
                f"run_dynamic/{key}", res.state, ref_state, None),
            **probed}
        launches_tile += launched
    rec["incremental_over_cold_iterations"] = (rec["add"]["iterations"]
                                               / cold_it)
    out["incremental_iterations"] = rec["add"]["iterations"]
    out["cold_iterations"] = cold_it
    keep(rec, 0, mw)
    if autotune.CACHE.sweeps != sweeps:
        raise AssertionError(f"phase 5g swept {autotune.CACHE.sweeps - sweeps}"
                             " times")
    out["sweeps"] = autotune.CACHE.sweeps - sweeps
    return out, launches_tile


# phase 5i: online graph-query serving (repro_torch.serve) at mesh=4 with
# CSRConfig() pinned.  (c)'s workload arrives faster than the admission
# deadline, so batches flush full (or at the end's drain), and its request
# count is cut until every batch lands on a family (a) built: a drained
# partial batch would build a bucket-1, -2 or -4 family (a scale-20
# construction, 14-19 s each) that the smoke has no room for.
SERVE_B = 8                   # the session's and the router's max_batch
SERVE_HOPS = 3
SERVE_REQUESTS = 64
SERVE_MIN_REQUESTS = 32       # (c) is cut no further
SERVE_RATE = 16000.0          # requests per virtual second
SERVE_REPEAT = 0.2
SERVE_KILL = {"kills": [(5, 2)], "recoveries": [(8, 2)]}  # 4 → 2 → 4
# PPR on the card against its query's solo float64 reference at the apply
# where the freeze stops the column (ppr_tail, check_ppr): element-wise, and
# as the L1 distance over the column's L1 norm (a mass most vertices hold
# at ~1e-6 each, where an atol says little).  float32 rounding alone is
# ~2e-7 of the L1 norm and under 1% of the element tolerance (R-MAT scale
# 16, plain path); the column rounded to bf16 is 1.5e-3 and 30x, and one
# apply more or less 2e-5 (scale 11) to 5e-5 (scale 14).
# pagerank lookups stop at pagerank's tol 1e-8, so a run one iteration
# apart differs by about that
PPR_RTOL, PPR_ATOL, PPR_L1 = 1e-4, 1e-8, 1e-5
LOOKUP_RTOL, LOOKUP_ATOL = 1e-4, 1e-7


def serve_reference(g, prog, max_iterations=None):
    """``run_reference`` of a serve program on the card: as it is for the
    min programs (exact), in float64 for the sum programs.  At scale 20 a
    float32 dense reference scatters millions of messages into a hub with
    atomics, and its rounding there moves a PPR column by ~3e-5."""
    import dataclasses

    import numpy as np

    from repro_torch import plug

    if prog.monoid.idempotent:
        return plug.run_reference(g, prog, max_iterations, device="cuda")
    init = prog.init
    wide = dataclasses.replace(prog, init=lambda gr: tuple(
        a.astype(np.float64) for a in init(gr)))
    return plug.run_reference(g, wide, max_iterations, device="cuda")


def ppr_tail(g, seeds) -> list:
    """One PPR query's float64 ``run_reference`` on the card: its states
    after its last three applies, the last one the apply that left it quiet
    (numpy (N,) columns, oldest first).  A served column stops at the state
    before the apply that found its query quiet (the per-query freeze of
    ``apply_step``): the middle one, or a neighbour where float32 rounding
    moves the quiet test (max change < tol) an iteration."""
    import collections
    import dataclasses

    import numpy as np

    from repro_torch import plug
    from repro_torch.graph.algorithms import BATCHED_QUERIES

    prog = BATCHED_QUERIES["ppr"](g, [seeds])
    init, apply = prog.init, prog.msg_apply
    tail = collections.deque(maxlen=3)

    def recorded(state, merged, has_msg, aux, it):
        if not tail:
            tail.append(state[:, 0].clone())
        new, active = apply(state, merged, has_msg, aux, it)
        tail.append(new[:, 0].clone())
        return new, active

    wide = dataclasses.replace(prog, msg_apply=recorded, init=lambda gr:
                               tuple(a.astype(np.float64) for a in init(gr)))
    plug.run_reference(g, wide, device="cuda")
    return [t.cpu().numpy() for t in tail]


def check_ppr(label, got, tail) -> tuple:
    """A served PPR column against the state of ``tail`` (``ppr_tail``)
    nearest it in L1, within PPR_RTOL / PPR_ATOL element-wise and PPR_L1 of
    its mass.  Returns (max |Δ|, the L1 share, the stop's offset from the
    float64 run's: 0 where both stop at the same apply)."""
    import numpy as np

    shares = [l1_share(got, t) for t in tail]
    at = int(np.argmin(shares))
    return (check_answers(label, "ppr", got, tail[at]), shares[at],
            at - (len(tail) - 2))


def serve_seeds(g, seed) -> list:
    """(a)'s 8 queries: six vertices with out-edges drawn from ``seed``, a
    duplicate of the second and a 3-seed query."""
    import numpy as np

    rng = np.random.default_rng(seed + 27)
    live = np.flatnonzero(g.out_degrees() > 0)
    v = [int(x) for x in rng.choice(live, size=9, replace=False)]
    return v[:6] + [v[1], tuple(v[6:])]


@contextlib.contextmanager
def recording_runs(runs: list):
    """Appends (middleware, ``Result``) to ``runs`` for each
    ``Middleware.run`` while the block runs (a serving call's family and
    analytics runs), so their records can be checked."""
    from repro_torch import plug

    run = plug.Middleware.run

    def recorded(self, *args, **kwargs):
        res = run(self, *args, **kwargs)
        runs.append((self, res))
        return res

    plug.Middleware.run = recorded
    try:
        yield runs
    finally:
        plug.Middleware.run = run


def check_serve_runs(label, runs, calls, launches, n) -> dict:
    """Phase 5i's checks of the fused runs a serving step made: each on the
    fused loop with every record ``fused``; ``csr_tile`` once an iteration;
    one small fetch an iteration and one vertex-sized (the final state) a
    run."""
    its = sum(res.iterations for _, res in runs)
    for mw, res in runs:
        if mw._fused_kind != "bsp" or not all(
                r.get("fused") for r in res.per_iteration):
            raise AssertionError(f"{label}: ran the host loop, not the fused "
                                 f"one (_fused_kind={mw._fused_kind!r})")
    if launches != its:
        raise AssertionError(f"{label}: csr_tile launched {launches} times "
                             f"in {its} fused iterations")
    small = [c for c in calls if c[1] < n]
    big = [c for c in calls if c[1] >= n]
    if len(small) != its or big != [("cpu", n * mw.k) for mw, _ in runs]:
        raise AssertionError(f"{label}: {len(small)} small fetches in {its} "
                             f"iterations, vertex-sized {big}")
    return {"runs": len(runs), "iterations": its, "csr_tile": launches,
            "fetches_per_iteration": len(small) / max(its, 1),
            "vertex_sized_fetches": len(big)}


def serve_step(label, fn, n):
    """Runs ``fn()`` (a session or router call) with launches and fetches
    counted; returns its value, the fused runs it made and their checks."""
    from repro_torch.kernels import edge_block as ebk

    calls, runs, before = [], [], ebk.csr_tile.launches
    t0 = time.perf_counter()
    with counting_fetches(calls), recording_runs(runs):
        out = fn()
    wall = time.perf_counter() - t0
    checks = check_serve_runs(label, runs, calls,
                              ebk.csr_tile.launches - before, n)
    return out, runs, dict(checks, wall_s=wall)


def l1_share(got, want) -> float:
    """|got − want|'s L1 norm over want's."""
    import numpy as np

    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).sum()
                 / max(np.abs(want).sum(), LIVE_MIN))


def check_answers(label, kind, got, want) -> float:
    """A served column against its reference: khop/sssp bit-equal, ppr and
    lookup within their tolerances, ppr also within PPR_L1 of its mass.
    Returns max |Δ|."""
    tol = {"ppr": (PPR_RTOL, PPR_ATOL),
           "lookup": (LOOKUP_RTOL, LOOKUP_ATOL)}.get(kind)
    max_abs = check_state(label, got, want, tol)
    if kind == "ppr" and l1_share(got, want) > PPR_L1:
        raise AssertionError(f"{label}: L1 distance {l1_share(got, want)} "
                             f"of the column's mass, above {PPR_L1}")
    return max_abs


def serve_plan(serve, wl, families) -> int:
    """The longest prefix of workload ``wl``, down to SERVE_MIN_REQUESTS,
    whose replay (simulated: admission and caching decide alone) runs only
    batches of ``families`` (kind, params, bucket) and lookups."""
    from repro_torch.core.pow2 import pow2_bucket

    class Recorder:
        max_batch = SERVE_B

        def __init__(self):
            self.keys = set()

        def execute_batch(self, kind, params, seeds_list):
            if kind != "lookup":
                self.keys.add((kind, params,
                               pow2_bucket(len(seeds_list), SERVE_B)))
            return [0.0 for _ in seeds_list], {
                "batch": len(seeds_list), "iterations": 0, "service_s": 0.0,
                "durable": True, "migrations": []}

    for count in range(len(wl), SERVE_MIN_REQUESTS - 1, -1):
        rec = Recorder()
        serve.replay(serve.GraphServeRouter(rec, max_batch=SERVE_B),
                     wl[:count])
        if rec.keys <= set(families):
            return count
    return len(wl)


def later_schedule():
    """A ``FailureSchedule`` that holds no event until ``arm(kills=...,
    recoveries=...)`` gives it its events, so one session's families serve
    healthy first and then under a kill."""
    from repro_torch import plug

    class Later(plug.FailureSchedule):
        def arm(self, **events):
            plug.FailureSchedule.__init__(self, **events)

    return Later()


def phase_serve(g, seed) -> tuple:
    """Phase 5i: ``repro_torch.serve`` on 5g's graph (scale
    ``ELASTIC_SCALE``) at ``mesh=SHARDS`` with ``CSRConfig()`` pinned: (a)
    a batch of 8 of each
    kind (and sssp's first query alone), (b) a pagerank lookup, (c) a
    seeded replay through ``GraphServeRouter``, (d) a kill and a join under
    live traffic, then the CSR tile at the serve triples' stacked shape.
    Returns the phase's line, its csr_tile launches and its kernel
    cases."""
    import numpy as np
    import torch

    from repro_torch import plug, serve
    from repro_torch.graph.algorithms import BATCHED_QUERIES, pagerank
    from repro_torch.kernels import autotune
    from repro_torch.kernels.ops import CSRConfig

    t_phase = time.perf_counter()
    n = g.num_vertices
    sweeps = autotune.CACHE.sweeps
    dev = torch.device("cuda")
    out = {"phase": "serve", "m": SHARDS, "max_batch": SERVE_B,
           "vertices": n, "edges": g.num_edges,
           "reduced": {"scale": f"5g's R-MAT graph of scale {ELASTIC_SCALE} "
                       "(phase 3's is 20), for the smoke's time"}}
    launches_tile = 0
    # one monitor for every family; (d) arms the schedule's kill and join
    failures = later_schedule()
    session = serve.GraphServeSession(
        g, num_shards=SHARDS, kernel="cuda", max_batch=SERVE_B,
        monitor=plug.FleetMonitor(num_hosts=SHARDS), failures=failures,
        device="cuda", mesh=SHARDS, csr_config=CSRConfig())
    seeds = serve_seeds(g, seed)
    params = {"khop": (("hops", SERVE_HOPS),), "sssp": (), "ppr": ()}

    # (a) a batch of 8 of each kind, each column against run_reference of
    # the same program on the card; sssp's first query alone too
    batch8, batches = {}, []
    for kind in ("khop", "sssp", "ppr"):
        label = f"{kind}/B{SERVE_B}"
        (answers, rec), runs, checks = serve_step(
            label, lambda: session.execute_batch(kind, params[kind], seeds),
            n)
        launches_tile += checks["csr_tile"]
        prog = BATCHED_QUERIES[kind](g, seeds, **dict(params[kind]))
        ref, ref_it = serve_reference(g, prog)
        extra = {}
        if kind == "ppr":
            # the batched contract: column q is query q's solo run (the
            # freeze stops a quiet column where its solo run stops), held
            # against the float64 solo run where it stops (check_ppr)
            tails = [ppr_tail(g, s) for s in seeds]  # (d) reuses them
            got = [check_ppr(f"{label}/q{q}", answers[q], tails[q])
                   for q in range(SERVE_B)]
            max_abs = max(x[0] for x in got)
            extra["l1_share_vs_reference"] = max(x[1] for x in got)
            extra["stop_offsets"] = [x[2] for x in got]
        else:
            max_abs = max(check_answers(f"{label}/q{q}", kind, answers[q],
                                        ref[:, q]) for q in range(SERVE_B))
        if not np.array_equal(answers[1], answers[6]):
            raise AssertionError(f"{label}: duplicate columns differ")
        # the same batch again: the family's steady state
        (again, rec2), _, checks2 = serve_step(
            label + "/again",
            lambda: session.execute_batch(kind, params[kind], seeds), n)
        launches_tile += checks2["csr_tile"]
        for q in range(SERVE_B):
            check_answers(f"{label}/again/q{q}", kind, again[q], answers[q])
        batch8[kind] = (answers, prog)
        batches.append({
            "batch": label, "iterations": rec["iterations"],
            "reference_iterations": ref_it, "converged": rec["converged"],
            "service_s": rec["service_s"], "service_s_again":
            rec2["service_s"], "s_per_query": rec2["service_s"] / SERVE_B,
            "max_abs_err_vs_reference": max_abs, **extra, **checks})
        emit({"phase": "serve", "step": batches[-1]})
    (one, rec1), _, checks = serve_step(
        "sssp/B1", lambda: session.execute_batch("sssp", (), seeds[:1]), n)
    launches_tile += checks["csr_tile"]
    (again, rec1b), _, checks1b = serve_step(
        "sssp/B1/again",
        lambda: session.execute_batch("sssp", (), seeds[:1]), n)
    launches_tile += checks1b["csr_tile"]
    for got in (one[0], again[0]):
        if not np.array_equal(got, batch8["sssp"][0][0]):
            raise AssertionError("sssp/B1: not bit-equal to its column of "
                                 f"the batch of {SERVE_B}")
    batches.append({"batch": "sssp/B1", "iterations": rec1["iterations"],
                    "service_s": rec1["service_s"],
                    "service_s_again": rec1b["service_s"],
                    "s_per_query": rec1b["service_s"], **checks})
    b8 = next(b for b in batches if b["batch"] == f"sssp/B{SERVE_B}")
    out["batches"] = batches
    out["sssp_s_per_query_b8_over_b1"] = b8["s_per_query"] / rec1b[
        "service_s"]

    # (b) a pagerank lookup: the converged field against run_reference
    field = (("field", "pagerank"),)
    look_seeds = [(seeds[0], seeds[2], seeds[4]), (seeds[1],)]
    (looked, recl), look_runs, checks = serve_step(
        "lookup/pagerank",
        lambda: session.execute_batch("lookup", field, look_seeds), n)
    launches_tile += checks["csr_tile"]
    pr_ref, pr_ref_it = serve_reference(
        g, pagerank(g), max_iterations=session.analytics_iterations)
    lk_abs = check_answers("lookup/pagerank", "lookup",
                           session._analytics["pagerank"], pr_ref[:, 0])
    for s, got in zip(look_seeds, looked):
        check_answers("lookup/pagerank/answer", "lookup", got,
                      pr_ref[list(s), 0])
    out["lookup"] = {"service_s": recl["service_s"],
                     "analytics_iterations": look_runs[-1][1].iterations,
                     "reference_iterations": pr_ref_it,
                     "max_abs_err_vs_reference": lk_abs, **checks}
    emit({"phase": "serve", "step": "lookup", **out["lookup"]})

    # (c) a seeded replay through the router, every batch on (a)'s families
    wl = serve.generate_workload(
        num_requests=SERVE_REQUESTS, num_vertices=n, rate=SERVE_RATE,
        seed=seed, hops=SERVE_HOPS, repeat_fraction=SERVE_REPEAT)
    count = serve_plan(serve, wl, session.compiled_families)
    if count < SERVE_REQUESTS:
        out["reduced"]["replay_requests"] = (
            f"{count} of {SERVE_REQUESTS}: the longest prefix whose batches "
            "all land on families (a) built (no family build in the replay)")
    router = serve.GraphServeRouter(session, max_batch=SERVE_B)
    fams_before = len(session.compiled_families)
    (answers, stats), runs, checks = serve_step(
        "replay", lambda: serve.replay(router, wl[:count]), n)
    launches_tile += checks["csr_tile"]
    # replay lists the cache hits first (at submit) and the batches' answers
    # after them; the router's cache starts empty, so each hit's key was
    # answered by a batch, and every batch answer of a key is the same
    solo, first, rep_abs, rep_l1, offsets = {}, {}, 0.0, 0.0, []
    for a in answers:
        key = a.query.cache_key
        if not a.cached and key in first and not np.array_equal(
                np.asarray(a.value), first[key]):
            raise AssertionError(f"replay: two answers of {key} differ")
        if not a.cached:
            first.setdefault(key, np.asarray(a.value))
    for a in answers:
        key = a.query.cache_key
        if a.cached:
            if key not in first or not np.array_equal(
                    np.asarray(a.value), first[key]):
                raise AssertionError(f"replay: cached {key} is not its "
                                     "first answer")
            continue
        q = a.query
        if q.kind == "ppr":
            if key not in solo:
                solo[key] = ppr_tail(g, q.seeds)
            max_abs, share, off = check_ppr("replay/ppr",
                                            np.asarray(a.value), solo[key])
            rep_abs, rep_l1 = max(rep_abs, max_abs), max(rep_l1, share)
            offsets.append(off)
            continue
        if q.kind == "lookup":
            want = pr_ref[np.asarray(q.seeds), 0]
        else:
            if key not in solo:
                prog = BATCHED_QUERIES[q.kind](g, [q.seeds], **dict(q.params))
                solo[key] = serve_reference(g, prog)[0][:, 0]
            want = solo[key]
        rep_abs = max(rep_abs, check_answers(f"replay/{q.kind}", q.kind,
                                             np.asarray(a.value), want))
    out["replay"] = {
        "requests": count, "rate_per_virtual_s": SERVE_RATE,
        "repeat_fraction": SERVE_REPEAT, "completed": stats["completed"],
        "cached": stats["cached"], "qps": stats["throughput_qps"],
        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
        "wall_s": stats["wall_s"], "kinds": stats["kinds"],
        "batch_sizes": [res.state.shape[1] for _, res in runs],
        "families_built": len(session.compiled_families) - fams_before,
        "solo_references": len(solo), "max_abs_err_vs_reference": rep_abs,
        "ppr_l1_share_vs_reference": rep_l1, "ppr_stop_offsets": offsets,
        **checks}
    if stats["completed"] != count:
        raise AssertionError(f"replay: {stats['completed']} of {count} "
                             "requests completed")
    emit({"phase": "serve", "step": "replay", **out["replay"]})
    out["families"] = len(session.compiled_families)
    out["init_s"] = {"/".join(str(x) for x in k): v
                     for k, v in session.init_s.items()}

    # the CSR tile at the serve triples' stacked shape: all shards' tiles of
    # a serve family, the states (a) answered
    fam = session._family("sssp", (), SERVE_B)
    stacked = {k: v.flatten(0, 1) for k, v in
               fam["mw"].daemon.stacked["csr"].items()}
    rng = np.random.default_rng(seed + 9)
    active = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    cases = []
    for kind, label in (("khop", "khop_min_k8/serve"),
                        ("sssp", "sssp_min_k8/serve"),
                        ("ppr", "ppr_sum_k8/serve")):
        answers, prog = batch8[kind]
        state = torch.from_numpy(np.stack(answers, 1)).to(dev)
        # each program's own aux: (n, 0) for khop/sssp, (n, 1 + B) for ppr
        aux = torch.from_numpy(prog.init(g)[1]).to(dev)
        act = (torch.ones(n, dtype=torch.bool, device=dev) if kind == "ppr"
               else active)
        rec = phase_csr_tile(stacked, prog, state, aux, act, label)
        emit({"phase": "kernel", **rec})
        cases.append(rec)
    del stacked, fam, router

    # (d) a kill and a join under live traffic: tests/test_serve.py's
    # acceptance arm on (a)'s session and families
    t0 = time.perf_counter()
    fams_before = len(session.compiled_families)
    failures.arm(**SERVE_KILL)
    router = serve.GraphServeRouter(session, max_wait=0.0)
    khop_qs = [serve.Query.make("khop", s, hops=SERVE_HOPS) for s in seeds]
    t_warm = [router.submit(q)[0] for q in khop_qs]
    router.clock.advance(0.01)
    _, _, checks_w = serve_step("kill/warm", router.pump, n)
    launches_tile += checks_w["csr_tile"]
    warm = [router.result(t) for t in t_warm]
    if (any(a is None or a.cached for a in warm)
            or session.mesh_epoch != 0):
        raise AssertionError("kill/warm: the warm khop batch did not run "
                             "before the kill")
    for q, a in enumerate(warm):
        if not np.array_equal(a.value, batch8["khop"][0][q]):
            raise AssertionError(f"kill/warm/q{q}: not (a)'s answer")
    router.cache.insert(("sentinel",), 0, durable=False)
    t_ppr = [router.submit(serve.Query.make("ppr", s))[0] for s in seeds]
    router.clock.advance(0.01)
    _, runs, checks_p = serve_step("kill/ppr", router.pump, n)
    launches_tile += checks_p["csr_tile"]
    migs = [r["migration"] for r in runs[0][1].per_iteration
            if "migration" in r]
    ppr_fam = session._family("ppr", (), SERVE_B)
    if (session.mesh_epoch != 2 or [m["killed"] for m in migs] != [[2], []]
            or [m["joined"] for m in migs] != [[], [2]]
            or ppr_fam["mw"].daemon.m != SHARDS):
        raise AssertionError(f"kill/ppr: epoch {session.mesh_epoch}, "
                             f"migrations {migs}, "
                             f"m={ppr_fam['mw'].daemon.m}")
    if (("sentinel",) in router.cache or router.cache.stats.flushed != 1
            or any(q.cache_key not in router.cache for q in khop_qs)):
        raise AssertionError("kill/ppr: the migration flushed "
                             f"{router.cache.stats.as_dict()}, expected the "
                             "volatile sentinel alone")
    for q, s in enumerate(seeds):
        _, hit = router.submit(serve.Query.make("khop", s, hops=SERVE_HOPS))
        if (hit is None or not hit.cached
                or not np.array_equal(hit.value, warm[q].value)):
            raise AssertionError(f"kill/q{q}: the durable khop answer did "
                                 "not survive")
    got = [check_ppr(f"kill/ppr/q{q}", router.result(t).value, tails[q])
           for q, t in enumerate(t_ppr)]
    (ans_after, rec_after), _, checks_a = serve_step(
        "kill/after", lambda: session.execute_batch("sssp", (), seeds), n)
    launches_tile += checks_a["csr_tile"]
    if rec_after["mesh_epoch"] != 2 or rec_after["migrations"]:
        raise AssertionError(f"kill/after: {rec_after}")
    for q in range(SERVE_B):
        if not np.array_equal(ans_after[q], batch8["sssp"][0][q]):
            raise AssertionError(f"kill/after/q{q}: not (a)'s answer")
    if len(session.compiled_families) != fams_before:
        raise AssertionError("kill: built a family")
    out["kill"] = {
        "schedule": SERVE_KILL, "mesh_epoch": session.mesh_epoch,
        "migrations": [{k: m[k] for k in ("killed", "joined",
                                          "devices_before", "devices_after",
                                          "seconds")} for m in migs],
        "migration_s": [m["seconds"] for m in migs],
        "ppr_iterations": runs[0][1].iterations,
        "ppr_max_abs_err_vs_reference": max(x[0] for x in got),
        "ppr_l1_share_vs_reference": max(x[1] for x in got),
        "ppr_stop_offsets": [x[2] for x in got],
        "cache": router.cache.stats.as_dict(),
        "families_built": 0,
        "checks": [checks_w, checks_p, checks_a],
        "seconds": time.perf_counter() - t0}
    emit({"phase": "serve", "step": "kill", **out["kill"]})
    del session, router
    torch.cuda.empty_cache()
    if autotune.CACHE.sweeps != sweeps:
        raise AssertionError(f"phase 5i swept {autotune.CACHE.sweeps - sweeps}"
                             " times with CSRConfig() pinned")
    out["seconds"] = time.perf_counter() - t_phase
    refs = {"graph": g, "seeds": seeds, "tails": tails, "solo": solo,
            "pr_ref": pr_ref,
            "batch8": {k: answers for k, (answers, _) in batch8.items()}}
    return out, launches_tile, cases, refs


@contextlib.contextmanager
def first_calls(module, names):
    """Records the arguments of the first call of each ``module.<name>``
    (the model reaches its kernels through these module attributes) and
    passes every call through, so the launches stay as they are."""
    got: dict = {}
    originals = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            got.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield got
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def model_attention(q, k, v) -> dict:
    """The first shared block's attention on the model's own q, k, v: the
    kernel against ``impl="reference"`` within phase 6's bf16 tolerance,
    timed beside its plain version and SDPA, with its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    b, hq, s, d = q.shape
    got = fa.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention(q, k, v, causal=True, impl="reference")
    chk = check_close("model/attention", got, want, rtol=BF16_RTOL,
                      atol=BF16_ATOL)
    del got, want
    pairs = s * (s + 1) // 2
    ops_count = 4 * d * pairs * b * hq
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return dict(
        B=b, Hq=hq, Hkv=k.shape[1], S=s, D=d, dtype=str(q.dtype),
        check=chk, max_abs_err=chk["max_abs_err"],
        kernel_ms=cuda_time_ms(lambda: fa.flash_attention(q, k, v),
                               reps=10, warmup=2),
        plain_ms=cuda_time_ms(lambda: fa.flash_attention_plain(q, k, v),
                              reps=3, warmup=1),
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        bytes=nbytes, ops=ops_count, ops_per_s=BF16_OPS_PER_S,
        **bound(nbytes, ops_count, BF16_OPS_PER_S))


def model_ssd(args, kwargs) -> dict:
    """The first Mamba2 layer's SSD on the model's own inputs, in float32:
    y and the final state of ``ops.ssd_scan`` against ``impl="reference"``
    within phase 7's tolerance; ``ssd_chunk`` timed at these shapes beside
    ``ssd_chunk_plain``, with its bound."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    x, dt, a, bm, cm = args
    chunk = kwargs["chunk"]
    x = x.float()
    y, state = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                            return_final_state=True)
    y_ref, state_ref = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk,
                                    impl="reference",
                                    return_final_state=True)
    checks = {"y": check_close("model/ssd y", y, y_ref),
              "final_state": check_close("model/ssd final state", state,
                                         state_ref)}
    del y, y_ref, state, state_ref
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    nc = s // chunk
    chunk_args = (x.reshape(b, nc, chunk, h, p),
                  dt.float().contiguous().reshape(b, nc, chunk, h),
                  a.float().contiguous(),
                  bm.float().contiguous().reshape(b, nc, chunk, g, n),
                  cm.float().contiguous().reshape(b, nc, chunk, g, n))
    torch.cuda.synchronize()
    tri = chunk * (chunk + 1) // 2
    ops_count = (b * nc * g * 2 * n * tri
                 + b * nc * h * (2 * p * tri + 2 * chunk * n * p))
    nbytes = 4 * (2 * b * s * h * p + b * nc * h * n * p + 2 * b * s * h
                  + 2 * b * s * g * n + b * nc * h + h)
    tc_ops = TF32_PRODUCTS * ops_count
    return dict(
        B=b, S=s, H=h, P=p, G=g, N=n, chunk=chunk, checks=checks,
        max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        kernel_ms=cuda_time_ms(lambda: ssd.ssd_chunk(*chunk_args)),
        entry_ms=cuda_time_ms(lambda: ops.ssd_scan(x, dt, a, bm, cm,
                                                   chunk=chunk)),
        plain_ms=cuda_time_ms(lambda: ssd.ssd_chunk_plain(*chunk_args),
                              reps=3, warmup=1),
        library_ms=None, bytes=nbytes, ops=ops_count,
        ops_per_s=TF32_OPS_PER_S, tensor_core_ops=tc_ops,
        fma_bound_ms=bound(nbytes, ops_count)["bound_ms"],
        **bound(nbytes, tc_ops, TF32_OPS_PER_S))


def model_checks(logits, cache, ref_logits, ref_cache) -> dict:
    """The kernel prefill's logits and every cache leaf against the
    reference prefill's, each within MODEL_TOL · max |want|."""
    out = {}
    for name, got, want in [("logits", logits, ref_logits),
                            *((k, cache[k], ref_cache[k])
                              for k in sorted(ref_cache))]:
        scale = float(want.float().abs().max())
        chk = check_close(f"model/{name}", got, want,
                          atol=MODEL_TOL * scale)
        out[name] = {**chk, "share_of_max": chk["max_abs_err"] / scale}
    return out


def phase_model(seed) -> tuple:
    """Phase 8's model half; returns its record, the kernels' records at
    the model's shapes, and the model (phase 9 trains it)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import Model
    from repro_torch.models import attention as A
    from repro_torch.train.serve import (decode_from, make_decode_step,
                                         make_prefill_step)

    dev = torch.device("cuda")
    cfg = get_config(MODEL_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(cfg, kernel="cuda", device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    out = {"phase": "model", "arch": MODEL_ARCH, "family": cfg.family,
           "parameters": model.num_params(),
           "parameter_bytes": sum(p.numel() * p.element_size()
                                  for p in model.parameters()),
           "allocated_bytes_after_init": torch.cuda.memory_allocated(dev),
           "init_s": time.perf_counter() - t0,
           "B": MODEL_B, "S": MODEL_S, "cache_len": MODEL_S + MODEL_GEN,
           "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
           "model_tol": MODEL_TOL}
    groups = cfg.num_layers // cfg.attn_every
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (MODEL_B, MODEL_S),
                           generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(model, cache_len=MODEL_S + MODEL_GEN)

    # (b) the main path: the kernel prefill, counted alone
    fa.flash_attention.launches = 0
    ssd.ssd_chunk.launches = 0
    t0 = time.perf_counter()
    with first_calls(A, ("attend",)) as first, \
            first_calls(ops, ("ssd_scan",)) as first_ssd:
        logits, cache = prefill(batch)
    torch.cuda.synchronize()
    out["prefill_first_s"] = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches,
                "ssd_chunk": ssd.ssd_chunk.launches}
    out["launches"] = launches
    if launches != {"flash_attention": groups, "ssd_chunk": cfg.num_layers}:
        raise AssertionError(f"model: prefill launched {launches}, expected "
                             f"{groups} flash_attention and "
                             f"{cfg.num_layers} ssd_chunk")
    out["compute_copy_bytes"] = model.compute_bytes()

    reference = model.with_kernel("reference")
    t0 = time.perf_counter()
    ref_logits, ref_cache = reference.prefill(
        batch, cache_len=MODEL_S + MODEL_GEN)
    torch.cuda.synchronize()
    out["reference_prefill_s"] = time.perf_counter() - t0
    if (fa.flash_attention.launches, ssd.ssd_chunk.launches) != (
            groups, cfg.num_layers):
        raise AssertionError("model: the reference prefill launched a kernel")
    out["end_to_end"] = model_checks(logits, cache, ref_logits, ref_cache)
    ref_next = ref_logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    out["last_token_agrees"] = float(
        (logits[:, -1].argmax(-1) == ref_next[:, 0]).float().mean())
    del logits, ref_logits
    (q, k, v), _ = first["attend"]
    attn = model_attention(q, k, v)
    del q, k, v
    ssd_rec = model_ssd(*first_ssd["ssd_scan"])
    del first, first_ssd
    out["layer"] = {"attention": attn["check"], "ssd": ssd_rec["checks"]}

    # (c) greedy generation from the kernel prefill, twice; the second
    # prefill measured for phase 10
    runs = []
    peak = torch.cuda.max_memory_allocated(dev)  # measured_step resets it
    for i in range(2):
        del cache
        fa.flash_attention.launches = 0
        ssd.ssd_chunk.launches = 0
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        (logits, cache), meas = measured_step(lambda: prefill(batch))
        if i == 1:
            out["measured_prefill"] = {**meas, "launches": {
                "flash_attention": fa.flash_attention.launches,
                "ssd_chunk": ssd.ssd_chunk.launches}}
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        t_prefill = meas["s"]
        fa.flash_attention.launches = 0
        ssd.ssd_chunk.launches = 0
        t0 = time.perf_counter()
        toks = decode_from(model, cache, tok, MODEL_S, MODEL_GEN)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        decode_launches = (fa.flash_attention.launches
                           + ssd.ssd_chunk.launches)
        if decode_launches:
            raise AssertionError(f"model: decode launched {decode_launches} "
                                 "model kernels")
        runs.append({"prefill_s": t_prefill, "decode_s": t_decode,
                     "tokens": toks.cpu()})
    if not torch.equal(runs[0]["tokens"], runs[1]["tokens"]):
        raise AssertionError("model: two greedy generations differ")
    steps = MODEL_GEN - 1
    plain_toks = decode_from(model, ref_cache, ref_next, MODEL_S,
                             MODEL_GEN).cpu()
    out["generation"] = {
        "tokens": MODEL_GEN, "decode_steps": steps,
        "runs": [{k: r[k] for k in ("prefill_s", "decode_s")} | {
            "decode_ms_per_step": 1e3 * r["decode_s"] / steps,
            "decode_tokens_per_s": steps * MODEL_B / r["decode_s"],
            "tokens_per_s": MODEL_GEN * MODEL_B / (r["prefill_s"]
                                                    + r["decode_s"])}
                 for r in runs],
        "identical": True, "decode_model_kernel_launches": 0,
        "first_row": runs[0]["tokens"][0].tolist(),
        "agree_with_reference_prefill": int(
            (runs[0]["tokens"] == plain_toks).sum()),
        "of": plain_toks.numel()}
    out["peak_allocated_bytes"] = max(peak,
                                      torch.cuda.max_memory_allocated(dev))
    # one more decode step, at the last free position of the second run's
    # cache, measured for phase 10
    decode = make_decode_step(model)
    tok = toks[:, -1:]
    fa.flash_attention.launches = 0
    ssd.ssd_chunk.launches = 0
    with torch.no_grad():
        _, meas = measured_step(
            lambda: decode(cache, tok, MODEL_S + MODEL_GEN - 1))
    out["measured_decode"] = {**meas, "pos": MODEL_S + MODEL_GEN - 1,
                              "launches": {
                                  "flash_attention":
                                      fa.flash_attention.launches,
                                  "ssd_chunk": ssd.ssd_chunk.launches}}
    del reference, cache, ref_cache
    torch.cuda.empty_cache()
    return out, attn, ssd_rec, model


def recording_upper(bits: int):
    """``MeshUpperSystem(mesh=4, wire="compressed", bits=bits)`` that keeps
    every merge's per-shard aggregates and its result (a run's worth)."""
    import numpy as np

    from repro_torch import plug

    class Recording(plug.MeshUpperSystem):
        rounds: list = []

        def reset(self):
            super().reset()
            self.rounds = []

        def merge(self, states, aggs, cnts):
            base, agg, cnt = super().merge(states, aggs, cnts)
            self.rounds.append((np.stack([np.asarray(a, np.float32)
                                          for a in aggs]),
                                np.array(agg, np.float32)))
            return base, agg, cnt

    return Recording(mesh=SHARDS, wire="compressed", bits=bits)


def host_wire(rounds, m: int, bits: int) -> dict:
    """Each recorded merge against a NumPy oracle of the int error-feedback
    wire: the m devices' partials (their S/m shards added in order), each
    device's scale max(amax, 1e-12)/qmax, the shared max, int32 sum, one
    dequantize, the residual carried to the next merge; the sum is the
    mean times m.  Raises unless every merge is bit-equal."""
    import numpy as np

    qmax = (1 << (bits - 1)) - 1
    residual = None
    for i, (aggs, got) in enumerate(rounds):
        groups = aggs.reshape(m, aggs.shape[0] // m, *aggs.shape[1:])
        parts = groups[:, 0].copy()
        for j in range(1, groups.shape[1]):
            parts = parts + groups[:, j]
        if residual is None:
            residual = np.zeros_like(parts)
        t = parts + residual
        local = (np.maximum(np.abs(t).reshape(m, -1).max(axis=1),
                            np.float32(1e-12)) / np.float32(qmax))
        shared = local.max()
        q = np.clip(np.round(t / shared), -qmax, qmax).astype(np.int8)
        acc = q.astype(np.int32).sum(axis=0, dtype=np.int32)
        want = (acc.astype(np.float32) * shared / np.float32(m)
                * np.float32(m))
        residual = t - q.astype(np.float32) * shared
        if got.shape != want.shape or not np.array_equal(got, want):
            bad = int((got != want).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"wire/bits={bits}: merge {i} differs from "
                                 f"the host oracle at {bad} elements")
    return {"merges": len(rounds), "bit_equal_to_oracle": True}


def phase_wire(g, parts, pr, exact_state) -> dict:
    """Phase 8's compressed-wire half (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch import plug

    out = {"phase": "model", "step": "compressed_wire", "m": SHARDS,
           "iterations": PR_ITERATIONS, "runs": {}}
    n, k = g.num_vertices, pr.state_width
    want = np.asarray(exact_state)
    zeros = [np.zeros((n, k), np.float32)] * SHARDS
    no_counts = [np.zeros(n, np.int32)] * SHARDS
    for bits in (8, 4):
        upper = recording_upper(bits)
        t0 = time.perf_counter()
        mw = plug.Middleware(g, pr, daemon=pinned_csr_daemon(), upper=upper,
                             partitions=parts, device="cuda")
        if mw._fused:
            raise AssertionError("wire: the compressed wire took a fused loop")
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = mw.run(PR_ITERATIONS)
        wall = time.perf_counter() - t0
        rounds = upper.rounds
        oracle = host_wire(rounds, upper.m, bits)
        per_merge = ((n * k * 4 * bits) // 32 + 4) * upper.m
        stats = dict(upper.wire_stats)
        if stats != {"exact_bytes": 0,
                     "compressed_bytes": per_merge * len(rounds)}:
            raise AssertionError(f"wire/bits={bits}: wire_stats {stats}, "
                                 f"expected {per_merge} a merge")
        # the wire restarts clean: after reset the same aggregates
        # through the same upper give the same sums, bit for bit
        upper.reset()
        for i, (aggs, got) in enumerate(rounds):
            again = upper.merge(zeros, list(aggs), no_counts)[1]
            if not np.array_equal(again, got):
                raise AssertionError(f"wire/bits={bits}: merge {i} "
                                     "replayed after reset differs")
        state = np.asarray(res.state)
        if not np.isfinite(state).all() or state.shape != want.shape:
            raise AssertionError(f"wire/bits={bits}: bad state")
        err = np.abs(state - want)
        out["runs"][f"bits{bits}"] = dict(
            init_s=init_s, wall_s=wall, iterations=res.iterations,
            **oracle, replay_bit_equal=True, wire_stats=stats,
            bytes_per_merge=per_merge,
            exact_bytes_per_merge=n * k * 4 * upper.m,
            max_abs_vs_exact=float(err.max()),
            max_share_vs_exact=float(err.max() / np.abs(want).max()),
            l1_share_vs_exact=float(err.sum() / np.abs(want).sum()))
        del mw
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 9: training
# --------------------------------------------------------------------------
@contextlib.contextmanager
def all_calls(module, name, record, keep=None):
    """Passes every call of ``module.<name>`` through and appends
    ``record(*args, **kwargs)`` of each to the list it yields (``None``
    after the first ``keep`` calls)."""
    got: list = []
    fn = getattr(module, name)

    def call(*args, **kwargs):
        got.append(record(*args, **kwargs)
                   if keep is None or len(got) < keep else None)
        return fn(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield got
    finally:
        setattr(module, name, fn)


def twin(model, cfg, kernel: str):
    """``model``'s very parameters under another config (its compute
    dtype) and kernel, with compute-dtype copies of its own."""
    from repro_torch.models import Model

    out = Model(cfg, kernel=kernel, device="meta")
    out.load_state_dict(model.state_dict(keep_vars=True), assign=True)
    return out


def counted_grads(model, batch):
    """``loss_and_grads`` with the model kernels' launch counters zeroed
    just before and read just after; returns (loss, grads, launches, s)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.train.step import loss_and_grads

    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    ssd.ssd_chunk.launches = 0
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(model, batch)
    torch.cuda.synchronize()
    return loss, grads, {"flash_attention": fa.flash_attention.launches,
                         "ssd_chunk": ssd.ssd_chunk.launches}, \
        time.perf_counter() - t0


def grad_checks(label, loss, grads, want_loss, want, *, leaf_tol=None,
                l2_tol=None, loss_rtol) -> dict:
    """The gradients through the kernels against the reference's: the loss
    within ``loss_rtol``; with ``leaf_tol`` every leaf within leaf_tol ·
    max |want| of that leaf; with ``l2_tol`` ||Δ|| / ||want|| over all
    leaves.  Reports the per-leaf shares either way."""
    import torch

    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    if not math.isfinite(float(loss)) or loss_rel > loss_rtol:
        raise AssertionError(f"{label}: loss {float(loss)} against "
                             f"{float(want_loss)} (rel {loss_rel})")
    shares, num, den = {}, 0.0, 0.0
    for k, w in want.items():
        g = grads[k]
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: gradient {k} bad")
        d = (g.float() - w.float())
        scale = float(w.float().abs().max())
        shares[k] = float(d.abs().max()) / scale if scale else 0.0
        num += float((d * d).sum())
        den += float((w.float() * w.float()).sum())
    rel_l2 = math.sqrt(num / den)
    worst = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
    if leaf_tol is not None and worst[0][1] > leaf_tol:
        raise AssertionError(f"{label}: gradient {worst[0][0]} off by "
                             f"{worst[0][1]} of its max, over {leaf_tol}")
    if l2_tol is not None and rel_l2 > l2_tol:
        raise AssertionError(f"{label}: gradients' relative L2 {rel_l2} "
                             f"over {l2_tol}")
    ordered = sorted(shares.values())
    return {"loss": float(loss), "reference_loss": float(want_loss),
            "loss_rel_diff": loss_rel, "loss_rtol": loss_rtol,
            "leaves": len(shares), "leaf_tol": leaf_tol,
            "max_leaf_share": ordered[-1],
            "median_leaf_share": ordered[len(ordered) // 2],
            "worst_leaves": worst, "rel_l2": rel_l2, "l2_tol": l2_tol}


def function_checks(attn_args, ssd_args, seed) -> dict:
    """Layer level on the train step's own inputs: the first shared-block
    attention's dq, dk, dv and the first Mamba2 layer's SSD chunk
    gradients through the kernels' Functions against plain autograd of
    their plain versions on the same inputs — bit-equal, since the
    backward recomputes exactly that; then ``ops.ssd_scan``'s gradients
    (the Function under the cross-chunk loop) against the reference
    path's within 1e-4·max(1, max |want|)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    out = {}

    def plain(fn, inputs, grads):
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        ys = fn(*xs)
        return torch.autograd.grad(ys if isinstance(ys, tuple) else (ys,),
                                   xs, grads)

    (q, k, v), kw = attn_args
    q, k, v = (t.detach() for t in (q, k, v))
    g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = fa.flash_attention.launches
    o = fa.flash_attention(*xs, causal=kw["causal"])
    if fa.flash_attention.launches != n0 + 1 or o.grad_fn is None:
        raise AssertionError("train/attention: no kernel launch or no "
                             "gradient under autograd")
    got = torch.autograd.grad(o, xs, g)
    want = plain(lambda *t: fa.flash_attention_plain(
        *t, causal=kw["causal"]), (q, k, v), (g,))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"train/attention {name}: not bit-equal "
                                 f"to plain autograd (max |Δ| "
                                 f"{float((a.float() - b.float()).abs().max())})")
    out["attention"] = {"shape": list(q.shape), "dtype": str(q.dtype),
                        "bit_equal": ["dq", "dk", "dv"]}
    del q, k, v, g, xs, o, got, want

    (x, dt, a, bm, cm), kw = ssd_args
    chunk = kw["chunk"]
    b, s, h, p = x.shape
    nc = s // chunk
    grp, n = bm.shape[2], bm.shape[3]
    cin = (x.detach().float().reshape(b, nc, chunk, h, p),
           dt.detach().float().reshape(b, nc, chunk, h),
           a.detach().float(),
           bm.detach().float().reshape(b, nc, chunk, grp, n),
           cm.detach().float().reshape(b, nc, chunk, grp, n))
    outs_g = tuple(torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, nc, chunk, h, p), (b, nc, h, n, p),
                                 (b, nc, h), (b, nc, chunk, h)))
    xs = [t.clone().requires_grad_(True) for t in cin]
    ys = ssd.ssd_chunk(*xs)
    if any(y.grad_fn is None for y in ys):
        raise AssertionError("train/ssd: an output without a gradient")
    got = torch.autograd.grad(ys, xs, outs_g)
    want = plain(ssd.ssd_chunk_plain, cin, outs_g)
    for name, g1, g2 in zip(("x", "dt", "a", "b", "c"), got, want):
        if not torch.equal(g1, g2):
            raise AssertionError(f"train/ssd d{name}: not bit-equal to "
                                 "plain autograd")
    flat = tuple(t.detach().float().contiguous() for t in (x, dt, a, bm, cm))
    gy = torch.randn(flat[0].shape, generator=gen, device="cuda")
    scan = {}
    for impl in ("cuda", "reference"):
        xs = [t.clone().requires_grad_(True) for t in flat]
        scan[impl] = torch.autograd.grad(
            ops.ssd_scan(*xs, chunk=chunk, impl=impl), xs, gy)
    shares = {}
    for name, g1, g2 in zip(("x", "dt", "a", "b", "c"), scan["cuda"],
                            scan["reference"]):
        chk = check_close(f"train/ssd_scan d{name}", g1, g2)
        shares[name] = chk["tol_share"]
    out["ssd"] = {"shape": list(x.shape), "chunk": chunk,
                  "chunk_bit_equal": ["x", "dt", "a", "b", "c"],
                  "scan_vs_reference_tol_share": shares}
    return out


def attention_case(label, q, k, v, causal) -> dict:
    """The kernel at a model's own attention inputs: against its plain
    version (bf16: one ulp), timed beside it and SDPA, with its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, hq, s, d = q.shape
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    tol = (dict(rtol=BF16_RTOL, atol=BF16_ATOL)
           if q.dtype == torch.bfloat16 else {})
    chk = check_close(f"attention/{label}", got, want, **tol)
    del got, want
    pairs = s * (s + 1) // 2 if causal else s * s
    ops_count = 4 * d * pairs * b * hq
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return dict(
        case=label, B=b, Hq=hq, Hkv=k.shape[1], S=s, D=d,
        dtype=str(q.dtype), causal=causal, max_abs_err=chk["max_abs_err"],
        tol_share=chk["tol_share"],
        kernel_ms=cuda_time_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal), reps=10, warmup=2),
        plain_ms=cuda_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal), reps=3, warmup=1),
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)),
        bytes=nbytes, ops=ops_count,
        **bound(nbytes, ops_count, BF16_OPS_PER_S))


def train_zamba2(model, seed) -> tuple:
    """Phase 9 (a); returns its record and the kernels' case records."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.dist import collectives as coll
    from repro_torch.models import attention as A
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.step import (as_batch, init_wire_state,
                                        make_train_step)

    dev = torch.device("cuda")
    cfg = model.cfg
    model.params_changed()  # phase 8's bf16 copies: 4.84 GB freed
    torch.cuda.empty_cache()
    groups = cfg.num_layers // cfg.attn_every
    want_launches = {"flash_attention": 2 * groups,
                     "ssd_chunk": 2 * cfg.num_layers}
    data = SyntheticLM(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=seed)
    batch = as_batch(data.next_batch(), dev)
    out = {"arch": cfg.name, "parameters": model.num_params(),
           "B": TRAIN_B, "S": TRAIN_S, "remat": cfg.remat,
           "tolerances": {"f32_leaf": TRAIN_TOL, "bf16_rel_l2":
                          TRAIN_L2_BF16, "f32_loss_rtol": TRAIN_LOSS_RTOL,
                          "bf16_loss_rtol": TRAIN_LOSS_RTOL_BF16}}

    # float32 compute: every leaf within TRAIN_TOL of the reference's
    f32 = cfg.replace(dtype="float32")
    want_loss, want, _, ref_s = counted_grads(twin(model, f32, "reference"),
                                              batch)
    loss, grads, launches, s = counted_grads(twin(model, f32, "cuda"), batch)
    if launches != want_launches:
        raise AssertionError(f"train/f32: launched {launches}, expected "
                             f"{want_launches}")
    out["float32"] = {"launches": launches, "s": s, "reference_s": ref_s,
                      **grad_checks("train/f32", loss, grads, want_loss,
                                    want, leaf_tol=TRAIN_TOL,
                                    loss_rtol=TRAIN_LOSS_RTOL)}
    del want, grads
    torch.cuda.empty_cache()

    # the config's bf16 compute: the main path's train pass, counted alone
    want_loss, want, _, ref_s = counted_grads(model.with_kernel("reference"),
                                              batch)
    first = lambda *a, **kw: (a, kw)  # noqa: E731
    with all_calls(A, "attend", first, keep=1) as attn_calls, \
            all_calls(ops, "ssd_scan", first, keep=1) as ssd_calls:
        loss, grads, launches, s = counted_grads(model, batch)
    if launches != want_launches:
        raise AssertionError(f"train/bf16: launched {launches}, expected "
                             f"{want_launches}")
    out["launches"] = launches
    out["bfloat16"] = {"launches": launches, "s": s, "reference_s": ref_s,
                       "attend_calls": len(attn_calls),
                       "ssd_scan_calls": len(ssd_calls),
                       **grad_checks("train/bf16", loss, grads, want_loss,
                                     want, l2_tol=TRAIN_L2_BF16,
                                     loss_rtol=TRAIN_LOSS_RTOL_BF16)}
    del want, grads
    attn_first, ssd_first = attn_calls[0], ssd_calls[0]
    del attn_calls, ssd_calls
    torch.cuda.empty_cache()
    out["layer"] = function_checks(attn_first, ssd_first, seed)
    (q, k, v), _ = attn_first
    case = attention_case(f"{cfg.name}/train/B{TRAIN_B}", q.detach(),
                          k.detach(), v.detach(), True)
    del attn_first, ssd_first, q, k, v

    # a prefill before the steps (the compute copies made), 3 AdamW steps
    prompt = {"tokens": batch["tokens"][:, :TRAIN_PREFILL_S]}
    with torch.no_grad():
        before, _ = model.prefill(prompt)
    opt = AdamW(AdamWConfig(peak_lr=1e-4, warmup_steps=1, total_steps=10))
    state = opt.init(model)
    step = make_train_step(model, opt)
    steps = []
    for i in range(TRAIN_STEPS):
        b_i = as_batch(data.next_batch(), dev)
        fa.flash_attention.launches = ssd.ssd_chunk.launches = 0
        (state, metrics), meas = measured_step(lambda: step(state, b_i))
        dt_s = meas["s"]
        rec = {"loss": float(metrics["loss"]), "s": dt_s,
               "peak_delta_bytes": meas["peak_delta_bytes"],
               "peak_bytes": meas["peak_bytes"],
               "tokens_per_s": TRAIN_B * TRAIN_S / dt_s,
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]),
               "launches": {"flash_attention": fa.flash_attention.launches,
                            "ssd_chunk": ssd.ssd_chunk.launches}}
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"train/step {i}: loss {rec['loss']}")
        steps.append(rec)
    out["steps"] = steps
    out["step_s_warm"] = min(r["s"] for r in steps[1:])
    out["tokens_per_s_warm"] = TRAIN_B * TRAIN_S / out["step_s_warm"]
    out["peak_allocated_bytes_steps"] = max(r["peak_bytes"] for r in steps)
    out["measured_step"] = {"step_index": TRAIN_STEPS - 1, **{
        k: steps[-1][k] for k in ("s", "peak_delta_bytes", "peak_bytes",
                                  "launches")}}
    out["opt_state_bytes"] = sum(
        t.numel() * t.element_size() for part in ("m", "v")
        for t in state[part].values())

    # the prefill after the steps reads fresh compute copies
    with torch.no_grad():
        after, _ = model.prefill(prompt)
        fresh, _ = twin(model, cfg, "cuda").prefill(prompt)
    if not torch.equal(after, fresh):
        raise AssertionError("train: the prefill after the steps differs "
                             "from one through freshly cast copies")
    if torch.equal(after, before):
        raise AssertionError("train: the steps did not change the prefill")
    out["prefill_after_steps"] = {
        "bit_equal_to_fresh_copies": True,
        "moved_from_before": float((after.float() - before.float())
                                   .abs().max())}
    del before, after, fresh
    model.params_changed()

    # one step through the int8 wire; one leaf against a NumPy oracle
    wire = init_wire_state(model)
    wstep = make_train_step(model, opt, grad_wire="int8")
    seen = []

    def record_q(t, bits=8):
        q_, s_ = quantize(t, bits)
        if not seen and t.numel() <= WIRE_ORACLE_NUMEL:
            seen.append([t.detach().cpu(), bits, None])
        return q_, s_

    def record_dq(q_, s_):
        r = dequantize(q_, s_)
        if seen and seen[0][2] is None:
            seen[0][2] = r.detach().cpu()
        return r

    quantize, dequantize = coll.quantize_int, coll.dequantize_int
    coll.quantize_int, coll.dequantize_int = record_q, record_dq
    try:
        state, wire, metrics = wstep(state, wire, as_batch(
            data.next_batch(), dev))
        torch.cuda.synchronize()
    finally:
        coll.quantize_int, coll.dequantize_int = quantize, dequantize
    t_np, bits, sent = seen[0]
    out["grad_wire"] = {"grad_wire_err": float(metrics["grad_wire_err"]),
                        "loss": float(metrics["loss"]),
                        **wire_oracle(t_np, bits, sent)}
    del state, wire, opt, step, wstep
    torch.cuda.empty_cache()
    return out, case


def wire_oracle(t, bits, sent) -> dict:
    """One leaf's sent gradient against a NumPy oracle of the int round:
    scale max(amax, 1e-12)/qmax, q = clip(rint(t/scale)), sent = q·scale."""
    import numpy as np

    qmax = (1 << (bits - 1)) - 1
    x = t.numpy().astype(np.float32)
    scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))) \
        / np.float32(qmax)
    q = np.clip(np.rint(x / scale), -qmax, qmax).astype(np.int8)
    want = q.astype(np.float32) * scale
    if not np.array_equal(sent.numpy(), want):
        raise AssertionError(f"train/grad_wire: the sent leaf differs from "
                             f"the NumPy oracle at "
                             f"{int((sent.numpy() != want).sum())} elements")
    return {"oracle_leaf_numel": int(x.size), "oracle_bit_equal": True}


def serve_case(label, model, batch, cache_len, gen_steps, prompt_len):
    """A model's kernel prefill against ``kernel="reference"`` within
    MODEL_TOL·max |want| (logits and every cache leaf), then greedy decode
    twice with identical tokens.  Returns the record and the attention
    calls of the kernel prefill (their inputs)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A
    from repro_torch.train.serve import decode_from, make_prefill_step

    prefill = make_prefill_step(model, cache_len=cache_len)
    kinds: set = set()

    def record(q, k, v, *, causal, kernel):
        first = causal not in kinds
        kinds.add(causal)
        return {"causal": causal, "S": q.shape[2],
                "qkv": (q, k, v) if first else None}

    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    with all_calls(A, "attend", record) as calls:
        logits, cache = prefill(batch)
    torch.cuda.synchronize()
    out = {"prefill_first_s": time.perf_counter() - t0,
           "launches": fa.flash_attention.launches,
           "attend_calls": [{k: c[k] for k in ("causal", "S")}
                            for c in calls]}
    t0 = time.perf_counter()
    ref_logits, ref_cache = model.with_kernel("reference").prefill(
        batch, cache_len=cache_len)
    torch.cuda.synchronize()
    out["reference_prefill_s"] = time.perf_counter() - t0
    out["end_to_end"] = model_checks(logits, cache, ref_logits, ref_cache)
    del ref_logits, ref_cache
    runs = []
    peak = torch.cuda.max_memory_allocated()  # measured_step resets it
    for i in range(2):
        del cache
        fa.flash_attention.launches = 0
        peak = max(peak, torch.cuda.max_memory_allocated())
        (logits, cache), meas = measured_step(lambda: prefill(batch))
        if i == 1:  # measured for phase 10
            out["measured_prefill"] = {
                **meas, "launches": {
                    "flash_attention": fa.flash_attention.launches}}
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        t_prefill = meas["s"]
        t0 = time.perf_counter()
        toks = decode_from(model, cache, tok, prompt_len, gen_steps)
        torch.cuda.synchronize()
        runs.append({"prefill_s": t_prefill,
                     "decode_ms_per_step": 1e3 * (time.perf_counter() - t0)
                     / (gen_steps - 1), "tokens": toks.cpu()})
    out["peak_allocated_bytes"] = max(peak, torch.cuda.max_memory_allocated())
    if not torch.equal(runs[0]["tokens"], runs[1]["tokens"]):
        raise AssertionError(f"{label}: two greedy generations differ")
    out["generation"] = {"tokens": gen_steps, "identical": True,
                         "first_row": runs[0]["tokens"][0].tolist(),
                         "runs": [{k: r[k] for k in ("prefill_s",
                                                     "decode_ms_per_step")}
                                  for r in runs]}
    del cache, logits
    return out, [(*c["qkv"], c["causal"]) for c in calls if c["qkv"]]


def train_moe(seed) -> tuple:
    """Phase 9 (b): qwen3-moe-235b-a22b at its published width, 2 of its
    94 layers."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models import moe as M

    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_S), generator=gen,
                           device=dev, dtype=torch.int32)
    stats: dict = {}
    moe_ffn = M.moe_ffn

    def counting(*a, **kw):
        return moe_ffn(*a, stats=stats, **kw)

    out = {"arch": cfg.name, "family": cfg.family,
           "reduced": f"depth: {MOE_LAYERS} of the published 94 layers "
                      "(published widths)",
           "parameters": model.num_params(), "init_s":
           time.perf_counter() - t0, "B": 1, "S": MOE_S,
           "capacity": M.capacity_for(MOE_S, cfg),
           "decode_capacity": M.capacity_for(1, cfg)}
    M.moe_ffn = counting
    try:
        rec, calls = serve_case("train/moe", model, {"tokens": tokens},
                                MOE_S + MOE_GEN, MOE_GEN, MOE_S)
    finally:
        M.moe_ffn = moe_ffn
    if rec["launches"] != MOE_LAYERS:
        raise AssertionError(f"train/moe: prefill launched "
                             f"{rec['launches']}, expected {MOE_LAYERS}")
    out.update(rec)
    out["dropped_share"] = float(stats["dropped"]) / float(
        stats["assignments"])
    out["peak_allocated_bytes"] = max(rec["peak_allocated_bytes"],
                                      torch.cuda.max_memory_allocated(dev))
    q, k, v, causal = calls[0]
    case = attention_case(f"{cfg.name}/prefill/B1", q, k, v, causal)
    del calls, q, k, v, model
    torch.cuda.empty_cache()
    return out, case


def train_whisper(seed) -> tuple:
    """Phase 9 (c): whisper-base at its published config."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.step import as_batch, make_train_step

    dev = torch.device("cuda")
    cfg = get_config(WHISPER_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    frames = 0.02 * torch.randn((WHISPER_B, cfg.encoder_seq, cfg.d_model),
                                generator=gen, device=dev)
    data = SyntheticLM(cfg.vocab_size, WHISPER_PROMPT, WHISPER_B, seed=seed)
    batch = {**as_batch(data.next_batch(), dev), "frames": frames}
    serve_batch = {"tokens": batch["tokens"], "frames": frames}
    rec, calls = serve_case("train/whisper", model, serve_batch,
                            WHISPER_PROMPT + WHISPER_GEN, WHISPER_GEN,
                            WHISPER_PROMPT)
    kinds = sorted((c["causal"], c["S"]) for c in rec["attend_calls"])
    want = sorted([(False, cfg.encoder_seq)] * cfg.num_encoder_layers
                  + [(True, WHISPER_PROMPT)] * cfg.num_layers)
    if kinds != want or rec["launches"] != len(want):
        raise AssertionError(f"train/whisper: attention calls {kinds}, "
                             f"launches {rec['launches']}")
    out = {"arch": cfg.name, "family": cfg.family,
           "parameters": model.num_params(), "B": WHISPER_B,
           "encoder_S": cfg.encoder_seq, "prompt": WHISPER_PROMPT, **rec}
    enc = next(c for c in calls if not c[3])
    dec = next(c for c in calls if c[3])
    cases = [attention_case(f"{cfg.name}/encoder/B{WHISPER_B}", *enc),
             attention_case(f"{cfg.name}/decoder/B{WHISPER_B}", *dec)]
    del calls, enc, dec

    # one train step at full width against the reference, as in (a)
    want_launches = {"flash_attention": 2 * len(want), "ssd_chunk": 0}
    f32 = cfg.replace(dtype="float32")
    wl, wg, _, _ = counted_grads(twin(model, f32, "reference"), batch)
    gl, gg, launches, _ = counted_grads(twin(model, f32, "cuda"), batch)
    if launches != want_launches:
        raise AssertionError(f"train/whisper f32: launched {launches}")
    out["float32"] = grad_checks("train/whisper f32", gl, gg, wl, wg,
                                 leaf_tol=TRAIN_TOL,
                                 loss_rtol=TRAIN_LOSS_RTOL)
    wl, wg, _, _ = counted_grads(model.with_kernel("reference"), batch)
    gl, gg, launches, _ = counted_grads(model, batch)
    if launches != want_launches:
        raise AssertionError(f"train/whisper bf16: launched {launches}")
    out["bfloat16"] = grad_checks("train/whisper bf16", gl, gg, wl, wg,
                                  l2_tol=TRAIN_L2_BF16,
                                  loss_rtol=TRAIN_LOSS_RTOL_BF16)
    out["train_launches"] = launches
    del wg, gg
    opt = AdamW(AdamWConfig(peak_lr=1e-4, warmup_steps=1, total_steps=10))
    state, metrics = make_train_step(model, opt)(opt.init(model), batch)
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError("train/whisper: the step's loss is not finite")
    out["step_loss"] = float(metrics["loss"])
    out["peak_allocated_bytes"] = max(rec["peak_allocated_bytes"],
                                      torch.cuda.max_memory_allocated(dev))
    del model, state, batch, serve_batch, frames
    torch.cuda.empty_cache()
    return out, cases


def train_launchers() -> dict:
    """Phase 9 (d): ``launch.train --reduced`` with checkpoints and the
    int8 wire, cut after its first checkpoint and resumed; then
    ``examples.elastic_restart``."""
    import io
    import shutil
    import tempfile

    from repro_torch.examples import elastic_restart
    from repro_torch.launch import train as tlaunch

    out = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        args = ["--arch", "stablelm-1.6b", "--reduced", "--steps", "6",
                "--batch", "4", "--seq", "128", "--checkpoint-every", "3",
                "--log-every", "1", "--grad-wire", "int8",
                "--checkpoint-dir", work]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            whole = tlaunch.main(args)
            shutil.rmtree(Path(work) / "step_00000006")
            resumed = tlaunch.main(args)
        text = buf.getvalue()
        if "resumed from step 3" not in text or len(resumed) != 3:
            raise AssertionError("train/launcher: no resume from step 3")
        if not all(math.isfinite(x) for x in whole + resumed):
            raise AssertionError("train/launcher: a loss is not finite")
        out["launch_train"] = {
            "args": args[:-1] + ["TMPDIR/..."], "losses": whole,
            "resumed_losses": resumed,
            "resumed_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                        zip(resumed, whole[3:])),
            "last_line": text.strip().splitlines()[-1]}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rec = elastic_restart.main(["--checkpoint-dir",
                                        str(Path(work) / "elastic")])
        if not rec["restored_bit_equal"] or not rec["sharded_loader_slices"]:
            raise AssertionError("train/elastic: the restored state is not "
                                 "what was saved")
        if rec["verdict"] == "mismatch!":
            raise AssertionError(f"train/elastic: resumed losses off by "
                                 f"{rec['max_loss_rel_diff']}")
        out["elastic_restart"] = {k: rec[k] for k in (
            "plan", "restored_bit_equal", "sharded_loader_slices",
            "max_param_diff", "max_loss_rel_diff", "loss_rtol", "verdict")}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def phase_train(box: list, seed) -> tuple:
    """Phase 9 on phase 8's model, handed over in ``box`` (emptied here,
    so it is freed after (a)); returns its record and the attention cases
    it timed."""
    import torch

    t_phase = time.perf_counter()
    out = {"phase": "train"}
    t0 = time.perf_counter()
    out["zamba2"], z_case = train_zamba2(box.pop(), seed)
    out["zamba2"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["moe"], m_case = train_moe(seed)
    out["moe"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["whisper"], w_cases = train_whisper(seed)
    out["whisper"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["launchers"] = train_launchers()
    out["launchers"]["seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    return out, [z_case, m_case, *w_cases]


# --------------------------------------------------------------------------
# phase 9': the model path across ranks
# --------------------------------------------------------------------------
# four gloo ranks share the card as a (data, model) grid of (2, 2)
MR_RANKS, MR_MP = 4, 2
MR_TIMEOUT_S = 600.0    # the spawned world's limit
# (a) qwen3-moe at its published width, MOE_LAYERS of its 94 layers, bf16
# parameters; B=2 prompts of MOE_S tokens, row d on data row d
MR_B = 2
# (b) launch.train on the grid, float32 (TF32 off), on the card and then on
# the CPU, the parameters drawn on the CPU for both (``_init_drawn_on_cpu``);
# the grid loses rank 3 before step 3
MR_TRAIN_ARGV = ["--arch", MOE_ARCH, "--reduced", "--steps", "6", "--batch",
                 "8", "--seq", "128", "--kill-device-at", "3",
                 "--log-every", "1", "--dtype", "float32"]
# an element whose gradient was nonzero and within MR_NOISE of its leaf's
# max in the same step in both runs is float32 noise of the leaf's sums,
# which Adam's normalisation turns into a move of up to lr whatever its
# size: it is held within MR_NOISE_MOVE, as tests/test_torch_ranks_train.py
# holds the same model's ranks to JAX's steps on the CPU
MR_NOISE = 1e-5
MR_NOISE_MOVE = 2e-4
# (c) zamba2-2.7b at its published widths under the "2d" rules (FSDP on
# data, heads and the FFN's hidden dim on model), bf16 compute as in phase
# 8, ZR_LAYERS Mamba2 layers and one shared-block invocation after them
# (the published config's block comes after every 6: cut to 2 for the
# smoke's time); B=2 prompts of MODEL_S tokens, row d on data row d, then
# ZR_GEN greedy tokens
ZR_LAYERS, ZR_B, ZR_GEN = 2, 2, 16


def moe_ranks_cfg():
    from repro_torch.configs import get_config

    return get_config(MOE_ARCH).replace(num_layers=MOE_LAYERS,
                                        param_dtype="bfloat16")


def moe_ranks_tokens(cfg, seed, dev):
    """The (MR_B, MOE_S) prompts, from the seed, on the card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (MR_B, MOE_S), generator=gen,
                         device=dev, dtype=torch.int32)


def zamba_ranks_cfg():
    from repro_torch.configs import get_config

    return get_config(MODEL_ARCH).replace(num_layers=ZR_LAYERS,
                                          attn_every=ZR_LAYERS)


def zamba_ranks_tokens(cfg, seed, dev):
    """The (ZR_B, MODEL_S) prompts of arm (c), from the seed, on the
    card."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    return torch.randint(0, cfg.vocab_size, (ZR_B, MODEL_S), generator=gen,
                         device=dev, dtype=torch.int32)


def cache_host(cache) -> dict:
    """A cache's tensors as float32 NumPy arrays (``cache_len`` left
    out)."""
    return {k: v.float().cpu().numpy() for k, v in cache.items()
            if not isinstance(v, int)}


def zamba_ranks_arm(grid, tmp, seed) -> dict:
    """Phase 9' (c) on one rank: zamba2's prefill of its row and ZR_GEN
    greedy tokens under the dense layout, then a second prefill (the
    kernels' launches counted in each; the second's peak above its start
    measured for phase 10: the first makes the compute-dtype copies), its
    logits and cache blocks written under ``tmp``; the layout's
    collectives timed alone.  Each decode step gathers every FSDP block
    over data, as the ``"2d"`` rules have it, so the tokens are decoded
    once."""
    import numpy as np
    import torch

    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.train.serve import decode_from, make_prefill_step

    dev = grid.device
    cfg = zamba_ranks_cfg()
    out = {}
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, mesh=grid).init(
        torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["parameters"] = model.num_params()
    tokens = grid.local_rows(zamba_ranks_tokens(cfg, seed, dev))
    prefill = make_prefill_step(model, cache_len=MODEL_S + ZR_GEN)
    runs = []
    with shd.activation_sharding(grid, grid.rules, batch=ZR_B):
        for i in range(2):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            fa.flash_attention.launches = ssd.ssd_chunk.launches = 0
            t0 = time.perf_counter()
            logits, cache = prefill({"tokens": tokens})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            launches = {"flash_attention": fa.flash_attention.launches,
                        "ssd_chunk": ssd.ssd_chunk.launches}
            peak = torch.cuda.max_memory_allocated(dev) - before
            if i == 0:
                out["compute_bytes"] = model.compute_bytes()
                np.save(_rank_file(tmp, "zamba_ranks", grid.rank, "logits"),
                        logits.float().cpu().numpy())
                for k, v in cache_host(cache).items():
                    np.save(_rank_file(tmp, "zamba_ranks", grid.rank,
                                       f"cache_{k}"), v)
            run = {"prefill_s": prefill_s, "launches": launches,
                   "peak_delta_bytes": peak}
            if i == 0:
                tok = L.vocab_argmax(logits[:, -1], cfg.padded_vocab).to(
                    torch.int32)[:, None]
                t0 = time.perf_counter()
                toks = decode_from(model, cache, tok, MODEL_S, ZR_GEN)
                torch.cuda.synchronize()
                run["decode_ms_per_step"] = 1e3 * (
                    time.perf_counter() - t0) / (ZR_GEN - 1)
                run["tokens"] = toks.cpu().numpy()
            runs.append(run)
            del logits, cache
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        # the layout's collectives alone, at the prefill's shapes in bf16:
        # a row-parallel product's all_reduce over model, the FSDP gather
        # of in_proj's block over data, the packed projection's re-lay
        # (its column blocks gathered over model)
        d, width = cfg.d_model, 2 * cfg.d_inner + 2 * cfg.ssm_groups \
            * cfg.ssm_state + cfg.ssm_heads
        act = torch.ones((MODEL_S, d), dtype=cfg.tdtype, device=dev)
        w = torch.ones((d // grid.dp, width // grid.mp), dtype=cfg.tdtype,
                       device=dev)
        cols = torch.ones((1, MODEL_S, width // grid.mp), dtype=cfg.tdtype,
                          device=dev)
        out["collective_ms"] = {
            "all_reduce_model": _collective_ms(
                lambda: grid.all_reduce(act, axis="model")),
            "gather_fsdp_in_proj": _collective_ms(
                lambda: grid.all_gather(w, 0, axis="data")),
            "relay_in_proj_columns": _collective_ms(
                lambda: grid.all_gather(cols, -1, axis="model")),
            "shapes": {"all_reduce_model": list(act.shape),
                       "gather_fsdp_in_proj": list(w.shape),
                       "relay_in_proj_columns": list(cols.shape)}}
        del act, w, cols
    out["runs"] = runs
    del model, prefill
    torch.cuda.empty_cache()
    return out


def model_ranks_world(rank, world, tmp, seed) -> dict:
    """One rank of phase 9': (a) qwen3-moe's prefill and greedy decode on
    its row of the grid, twice, its logits written under ``tmp``; the
    combine's and the gradients' all_reduce timed alone; (c) zamba2 under
    the dense layout (``zamba_ranks_arm``); (b) launch.train with the
    kill, on the card and then on the CPU, held to each other here."""
    import numpy as np
    import torch

    from repro_torch.dist import sharding as shd
    from repro_torch.dist.sharding import RankGrid
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.train.serve import decode_from, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # (a) serves: the "serve" rules (weights whole over data, split over
    # model); (c) and (b) run the "2d" rules
    grid = RankGrid(MR_MP, strategy="serve")  # cuda:{rank % device_count}
    torch.cuda.set_device(grid.device)
    dev = grid.device
    cfg = moe_ranks_cfg()
    out = {"rank": rank, "coords": grid.coords, "device": str(dev),
           "backend": grid.backend}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, mesh=grid).init(
        torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["parameters"] = model.num_params()
    tokens = grid.local_rows(moe_ranks_tokens(cfg, seed, dev))
    prefill = make_prefill_step(model, cache_len=MOE_S + MOE_GEN)
    stats: dict = {}
    moe_ffn = M.moe_ffn
    runs = []
    with shd.activation_sharding(grid, grid.rules, batch=MR_B):
        for i in range(2):
            M.moe_ffn = ((lambda *a, **kw: moe_ffn(*a, stats=stats, **kw))
                         if i == 0 else moe_ffn)
            try:
                fa.flash_attention.launches = 0
                t0 = time.perf_counter()
                logits, cache = prefill({"tokens": tokens})
                torch.cuda.synchronize()
                prefill_s = time.perf_counter() - t0
                launches = fa.flash_attention.launches
            finally:
                M.moe_ffn = moe_ffn
            tok = L.vocab_argmax(logits[:, -1], cfg.padded_vocab).to(
                torch.int32)[:, None]
            t0 = time.perf_counter()
            toks = decode_from(model, cache, tok, MOE_S, MOE_GEN)
            torch.cuda.synchronize()
            runs.append({"prefill_s": prefill_s, "launches": launches,
                         "decode_ms_per_step": 1e3 * (time.perf_counter()
                                                      - t0) / (MOE_GEN - 1),
                         "tokens": toks.cpu().numpy()})
            if i == 0:
                np.save(_rank_file(tmp, "moe_ranks", rank, "logits"),
                        logits.float().cpu().numpy())
            del logits, cache
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        # the combine's all_reduce over the data row, alone, at the
        # prefill's (T_loc, D) and a decode step's (1, D) in bf16
        x = torch.ones((MOE_S, cfg.d_model), dtype=cfg.tdtype, device=dev)
        out["combine_all_reduce_ms"] = {
            "prefill": _collective_ms(
                lambda: grid.all_reduce(x, axis="model")),
            "decode": _collective_ms(lambda: grid.all_reduce(
                x[:1].clone(), axis="model"))}
    out["runs"] = runs
    out["dropped"] = float(stats["dropped"])
    out["assignments"] = float(stats["assignments"])
    del model, prefill, x
    torch.cuda.empty_cache()
    # the gradients' all_reduce over the data axis of the (2, 2) grid, alone:
    # one float32 buffer of the rank's reduced qwen3-moe leaves
    from repro_torch.configs import get_reduced

    numel = Model(get_reduced(MOE_ARCH), device="meta",
                  mesh=grid).num_params()
    g = torch.ones(numel, dtype=torch.float32, device=dev)
    out["grad_all_reduce_ms"] = _collective_ms(
        lambda: grid.all_reduce(g, axis="data"))
    out["grad_all_reduce_bytes"] = numel * 4
    del g
    out["zamba"] = zamba_ranks_arm(
        RankGrid(MR_MP, strategy="2d", _groups=grid._groups), tmp, seed)
    out["train"] = model_ranks_train(world)
    return out


@contextlib.contextmanager
def _init_drawn_on_cpu():
    """``Model.init`` draws every leaf (the rank's block of it on a grid)
    from a CPU generator of the given generator's seed and copies it to
    the model's device: the card's run and the CPU's start from the same
    parameters."""
    import torch

    from repro_torch.models import Model

    init = Model.init

    def drawn(self, gen):
        cpu = init(Model(self.cfg, kernel=self.kernel, device="cpu",
                         mesh=self.mesh),
                   torch.Generator().manual_seed(gen.initial_seed()))
        self.load_state_dict(cpu.state_dict())
        return self

    Model.init = drawn
    try:
        yield
    finally:
        Model.init = init


def _train_recording(argv) -> tuple:
    """``launch.train`` of ``argv`` in this process, its stdout captured,
    the parameters drawn on the CPU → (its result, its stdout, each
    step's elements of each leaf whose gradient was nonzero and within
    ``MR_NOISE`` of the leaf's max, with the step's layout: the kill
    re-lays the blocks)."""
    import io

    from repro_torch.launch import train as tlaunch
    from repro_torch.train.optimizer import AdamW

    update = AdamW.update
    noisy: list = []

    def recording(self, model, grads, state):
        step = {}
        for k, g in grads.items():
            a = g.detach().abs()
            step[k] = ((a > 0) & (a <= MR_NOISE * a.max())).cpu().numpy()
        noisy.append((step, leaf_layout(model)))
        return update(self, model, grads, state)

    AdamW.update = recording
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf), _init_drawn_on_cpu():
            run = tlaunch.train(tlaunch.parse_args(argv))
    finally:
        AdamW.update = update
    return run, buf.getvalue(), noisy


def leaf_layout(model) -> dict:
    """Each parameter's whole shape and the rank's block of it (its
    slices; None for a whole leaf), by ``state_dict`` name."""
    from repro_torch.models import layers as L

    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, L.ParamNode):
            sliced = mod.sliced()
            for k in mod._leaves:
                out[f"{prefix}.{k}" if prefix else k] = (
                    mod.leaf(k).shape, sliced.get(k))
    return out


def whole_noise(noisy) -> list:
    """Each step's noise masks over the whole leaves: every world rank's
    blocks (``all_gather_object`` over the world; each rank calls it),
    OR-ed into place."""
    import numpy as np
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, noisy)
    steps = []
    for i in range(max(len(n) for n in every)):
        masks: dict = {}
        for n in every:
            if i >= len(n):
                continue
            step, layout = n[i]
            for k, m in step.items():
                shape, sl = layout[k]
                full = masks.setdefault(k, np.zeros(shape, dtype=bool))
                full[(slice(None),) if sl is None else sl] |= m
        steps.append(masks)
    return steps


def model_ranks_train(world) -> dict:
    """Phase 9' (b) on one rank: ``launch.train`` with the kill on the
    card, then on the CPU in the same world, each from the parameters
    drawn on the CPU; the card's losses and final leaves held to the
    CPU's here."""
    import numpy as np

    os.environ["WORLD_SIZE"] = str(world)
    kill = int(MR_TRAIN_ARGV[MR_TRAIN_ARGV.index("--kill-device-at") + 1])
    runs = {}
    for device in ("cuda", "cpu"):
        run, stdout, noisy = _train_recording(MR_TRAIN_ARGV
                                              + ["--device", device])
        runs[device] = {
            "losses": run["losses"], "stdout": stdout,
            "grid": dict(run["grid"].shape), "idle": run["grid"].idle,
            "step_s_before_kill": run["step_s"][:kill],
            "step_s_after_kill": run["step_s"][kill:],
            "migrate_s": run["migrate_s"],
            "params": {k: v.detach().float().cpu().numpy()
                       for k, v in run["model"].state_dict().items()},
            "layout": leaf_layout(run["model"]), "noisy": whole_noise(noisy)}
        del run
    got, want = runs["cuda"], runs["cpu"]
    out = {k: got[k] for k in ("losses", "grid", "idle", "migrate_s",
                               "step_s_before_kill", "step_s_after_kill",
                               "stdout")}
    out["cpu_losses"] = want["losses"]
    out["cpu_step_s"] = want["step_s_before_kill"] + want["step_s_after_kill"]
    out["loss_max_rel_diff"] = max(abs(a - b) / abs(b) for a, b in
                                   zip(got["losses"], want["losses"]))
    if not got["idle"]:
        worst, noisy_n, noisy_worst = 0.0, 0, 0.0
        for k, w in want["params"].items():
            diff = np.abs(got["params"][k] - w)
            noise = np.zeros(diff.shape, dtype=bool)
            sl = got["layout"][k][1]
            for mine, theirs in zip(got["noisy"], want["noisy"]):
                if k in mine:
                    both = mine[k] & theirs[k]
                    noise |= both if sl is None else both[sl]
            scale = float(np.abs(w).max())
            if (~noise).any():
                worst = max(worst, float(diff[~noise].max()) / scale)
            if noise.any():
                noisy_n += int(noise.sum())
                noisy_worst = max(noisy_worst, float(diff[noise].max()))
        out["leaf_max_rel_err"] = worst
        out["noisy_elements"] = noisy_n
        out["noisy_max_abs_err"] = noisy_worst
    return out


def phase_model_ranks(seed) -> tuple:
    """Phase 9' (see the module docstring) → its line and each rank's
    flash-attention launches in its first prefill."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import Model
    from repro_torch.models import moe as M
    from repro_torch.train.serve import decode_from, make_prefill_step

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = moe_ranks_cfg()
    # the one-process B=1 prefill and decode of each row, on the same
    # parameters (the init a rank keeps its block of)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    tokens = moe_ranks_tokens(cfg, seed, dev)
    one = []
    with torch.no_grad():
        for d in range(MR_B):
            logits, cache = make_prefill_step(
                model, cache_len=MOE_S + MOE_GEN)({"tokens": tokens[d:d + 1]})
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks = decode_from(model, cache, tok, MOE_S, MOE_GEN)
            one.append((logits.float().cpu().numpy(), toks.cpu().numpy()))
            del logits, cache
    one_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    # (c)'s one-process B=1 prefill and decode of each row
    zcfg = zamba_ranks_cfg()
    t0 = time.perf_counter()
    model = Model(zcfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    ztokens = zamba_ranks_tokens(zcfg, seed, dev)
    zone = []
    with torch.no_grad():
        for d in range(ZR_B):
            logits, cache = make_prefill_step(
                model, cache_len=MODEL_S + ZR_GEN)({"tokens": ztokens[d:d + 1]})
            held = cache_host(cache)  # the prefill's: decode writes in place
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            toks = decode_from(model, cache, tok, MODEL_S, ZR_GEN)
            zone.append((logits.float().cpu().numpy(), held,
                         toks.cpu().numpy()))
            del logits, cache, held
    zone_bytes = {"parameters": model.num_params(),
                  "compute_bytes": model.compute_bytes()}
    zone_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    out = {"phase": "model_ranks", "world": MR_RANKS,
           "grid": {"data": MR_RANKS // MR_MP, "model": MR_MP},
           "arch": cfg.name, "B": MR_B, "S": MOE_S, "gen": MOE_GEN,
           "capacity": M.capacity_for(MOE_S, cfg),
           "decode_capacity": M.capacity_for(1, cfg),
           "reduced": {
               "depth": f"{MOE_LAYERS} of the published 94 layers "
                        "(published widths)",
               "param_dtype": "bfloat16 (the config's is float32): four "
                              "ranks' blocks share one card",
               "train": "(b) trains the reduced config: AdamW state at "
                        "published width needs >= 20 GB a rank"},
           "caveat": RANKS_CAVEAT, "one_process_s": one_s}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_model_ranks_")
    try:
        t0 = time.perf_counter()
        ranks = spawn_ranks(model_ranks_world, MR_RANKS, (tmp, seed),
                            backend="gloo", init_method=f"file://{tmp}/init",
                            timeout_s=MR_TIMEOUT_S)
        out["world_s"] = time.perf_counter() - t0
        # (a) each rank against its row's one-process run
        rows = []
        for r in ranks:
            d = r["coords"]["data"]
            got = np.load(_rank_file(tmp, "moe_ranks", r["rank"], "logits"))
            want, want_toks = one[d]
            scale = float(np.abs(want).max())
            want = vocab_block(want, got, r["coords"]["model"])
            err = float(np.abs(got - want).max())
            if not err <= MODEL_TOL * scale:
                raise AssertionError(f"model_ranks: rank {r['rank']}'s "
                                     f"logits {err} from row {d}'s, > "
                                     f"{MODEL_TOL} · {scale}")
            a, b = (run["tokens"] for run in r["runs"])
            if not np.array_equal(a, b):
                raise AssertionError(f"model_ranks: rank {r['rank']}'s two "
                                     "generations differ")
            if any(run["launches"] != MOE_LAYERS for run in r["runs"]):
                raise AssertionError(
                    f"model_ranks: rank {r['rank']} launched flash "
                    f"attention {[run['launches'] for run in r['runs']]} "
                    f"times a prefill, expected {MOE_LAYERS}")
            rows.append({
                "rank": r["rank"], "coords": r["coords"],
                "parameters": r["parameters"], "init_s": r["init_s"],
                "logits_max_abs_err": err, "logits_tol": MODEL_TOL * scale,
                "tokens_agreeing_with_one_process": int(
                    (a == want_toks).sum()),
                "peak_allocated_bytes": r["peak_allocated_bytes"],
                "prefill_s": [run["prefill_s"] for run in r["runs"]],
                "decode_ms_per_step": [run["decode_ms_per_step"]
                                       for run in r["runs"]],
                "combine_all_reduce_ms": r["combine_all_reduce_ms"],
                "flash_attention_launches": [run["launches"]
                                             for run in r["runs"]],
                "first_row": a[0].tolist()})
        for d in range(MR_RANKS // MR_MP):
            toks = [r["runs"][0]["tokens"] for r in ranks
                    if r["coords"]["data"] == d]
            if any(not np.array_equal(t, toks[0]) for t in toks[1:]):
                raise AssertionError(f"model_ranks: data row {d}'s ranks "
                                     "decoded different tokens")
        # every rank of a row counts the row's drops; the rows' counts are
        # summed over data, so each rank holds the world's
        out["dropped_share"] = ranks[0]["dropped"] / ranks[0]["assignments"]
        out["serve"] = rows
        out["zamba2"] = zamba_ranks_check(tmp, ranks, zcfg, zone,
                                          zone_bytes, zone_s)
        out["backend"] = sorted({r["backend"] for r in ranks})
        out["devices"] = [r["device"] for r in ranks]
        # (b) the launcher with the kill, the card against the CPU
        trains = [r["train"] for r in ranks]
        lead = trains[0]
        if "device lost → survivor mesh {'data': 1, 'model': 2} over 2/4 " \
                "devices, live state migrated checkpoint-free" \
                not in lead["stdout"]:
            raise AssertionError(f"model_ranks/train: no migration line in "
                                 f"{lead['stdout']!r}")
        for r, t in zip(ranks, trains):
            if t["losses"] != lead["losses"] or t["idle"] != (r["rank"] >= 2):
                raise AssertionError(f"model_ranks/train: rank {r['rank']} "
                                     f"{t['losses']} idle={t['idle']}")
            if not all(math.isfinite(x) for x in t["losses"]):
                raise AssertionError("model_ranks/train: a loss is not "
                                     "finite")
            if t["loss_max_rel_diff"] > TRAIN_LOSS_RTOL:
                raise AssertionError(
                    f"model_ranks/train: rank {r['rank']}'s losses "
                    f"{t['losses']} against the CPU's {t['cpu_losses']}")
            if not t["idle"] and (t["leaf_max_rel_err"] > TRAIN_TOL or
                                  t["noisy_max_abs_err"] > MR_NOISE_MOVE):
                raise AssertionError(
                    f"model_ranks/train: rank {r['rank']}'s leaves "
                    f"{t['leaf_max_rel_err']} of max (noise elements "
                    f"{t['noisy_elements']}, {t['noisy_max_abs_err']}) "
                    f"from the CPU's")
        out["train"] = {
            "argv": MR_TRAIN_ARGV, "grid_after_kill": lead["grid"],
            "losses": lead["losses"], "cpu_losses": lead["cpu_losses"],
            "loss_max_rel_diff": max(t["loss_max_rel_diff"]
                                     for t in trains),
            "loss_rtol": TRAIN_LOSS_RTOL,
            "leaf_max_rel_err": max(t["leaf_max_rel_err"] for t in trains
                                    if not t["idle"]),
            "leaf_tol": TRAIN_TOL,
            "noisy_elements": [t.get("noisy_elements") for t in trains],
            "noisy_max_abs_err": max(t["noisy_max_abs_err"] for t in trains
                                     if not t["idle"]),
            "noisy_move_bound": MR_NOISE_MOVE,
            "step_s_before_kill": [t["step_s_before_kill"] for t in trains],
            "step_s_after_kill": [t["step_s_after_kill"] for t in trains],
            "cpu_step_s": [t["cpu_step_s"] for t in trains],
            "migrate_s": [t["migrate_s"] for t in trains],
            "grad_all_reduce_ms": [r["grad_all_reduce_ms"] for r in ranks],
            "grad_all_reduce_bytes": ranks[0]["grad_all_reduce_bytes"],
            "last_line": lead["stdout"].strip().splitlines()[-1]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["rank_kernels"] = phase_rank_kernels(seed)
    out["seconds"] = time.perf_counter() - t_phase
    return out, [r["flash_attention_launches"][0] for r in rows]


def vocab_block(want, got, model_index):
    """``want``'s block of the vocabulary (last dim) that a rank's ``got``
    holds: the model axis' ``model_index``-th."""
    v = got.shape[-1]
    if v == want.shape[-1]:
        return want
    return want[..., model_index * v:(model_index + 1) * v]


def zamba_ranks_check(tmp, ranks, cfg, one, one_bytes, one_s) -> dict:
    """Phase 9' (c) held: each rank's logits (its vocabulary block) and
    every cache block within MODEL_TOL·max |want| of its row's one-process
    run, its tokens equal to its row's other rank's, one flash-attention
    and ZR_LAYERS ssd_chunk launches in each prefill."""
    import numpy as np

    from repro_torch.dist import sharding as shd
    from repro_torch.models import Model

    _, axes = Model(cfg, device="meta").init_cache(1, MODEL_S + ZR_GEN)
    want_launches = {"flash_attention": ZR_LAYERS // cfg.attn_every,
                     "ssd_chunk": ZR_LAYERS}
    rows = []
    for r in ranks:
        z = r["zamba"]
        d, rank = r["coords"]["data"], r["rank"]
        want_logits, want_cache, want_toks = one[d]
        got = np.load(_rank_file(tmp, "zamba_ranks", rank, "logits"))
        scale = float(np.abs(want_logits).max())
        err = float(np.abs(got - vocab_block(want_logits, got,
                                             r["coords"]["model"])).max())
        if not err <= MODEL_TOL * scale:
            raise AssertionError(f"model_ranks/zamba2: rank {rank}'s logits "
                                 f"{err} > {MODEL_TOL} · {scale}")
        grid = shd.TracedGrid({"data": MR_RANKS // MR_MP, "model": MR_MP},
                              rank=rank)
        cache_err = {}
        for name, full in want_cache.items():
            ax = tuple(None if a == shd.BATCH else a for a in axes[name])
            spec = grid.param_spec(full.shape, ax)
            block = full[grid.local_slice(full.shape, spec)] if spec else full
            mine = np.load(_rank_file(tmp, "zamba_ranks", rank,
                                      f"cache_{name}"))
            if mine.shape != block.shape:
                raise AssertionError(f"model_ranks/zamba2: rank {rank}'s "
                                     f"cache {name} {mine.shape}, its block "
                                     f"{block.shape}")
            c_scale = float(np.abs(full).max())
            cache_err[name] = float(np.abs(mine - block).max())
            if not cache_err[name] <= MODEL_TOL * c_scale:
                raise AssertionError(
                    f"model_ranks/zamba2: rank {rank}'s cache {name} "
                    f"{cache_err[name]} > {MODEL_TOL} · {c_scale}")
        a = z["runs"][0]["tokens"]
        for run in z["runs"]:
            if run["launches"] != want_launches:
                raise AssertionError(
                    f"model_ranks/zamba2: rank {rank} launched "
                    f"{run['launches']} in a prefill, expected "
                    f"{want_launches}")
        rows.append({
            "rank": rank, "coords": r["coords"],
            "parameters": z["parameters"],
            "parameters_one_process": one_bytes["parameters"],
            "compute_bytes": z["compute_bytes"],
            "compute_bytes_one_process": one_bytes["compute_bytes"],
            "init_s": z["init_s"], "logits_max_abs_err": err,
            "logits_tol": MODEL_TOL * scale, "cache_max_abs_err": cache_err,
            "tokens_agreeing_with_one_process": int((a == want_toks).sum()),
            "launches": [run["launches"] for run in z["runs"]],
            "prefill_s": [run["prefill_s"] for run in z["runs"]],
            "decode_ms_per_step": z["runs"][0]["decode_ms_per_step"],
            "peak_delta_bytes": [run["peak_delta_bytes"]
                                 for run in z["runs"]],
            "peak_allocated_bytes": z["peak_allocated_bytes"],
            "collective_ms": z["collective_ms"]})
    for d in range(MR_RANKS // MR_MP):
        toks = [r["zamba"]["runs"][0]["tokens"] for r in ranks
                if r["coords"]["data"] == d]
        if any(not np.array_equal(t, toks[0]) for t in toks[1:]):
            raise AssertionError(f"model_ranks/zamba2: data row {d}'s ranks "
                                 "decoded different tokens")
    return {"arch": cfg.name, "strategy": "2d", "B": ZR_B, "S": MODEL_S,
            "gen": ZR_GEN, "one_process_s": one_s,
            "reduced": {"depth": f"{ZR_LAYERS} of the published 54 Mamba2 "
                                 "layers and 1 of 9 shared-block "
                                 f"invocations, after {ZR_LAYERS} layers, "
                                 "not 6 (published widths): cut from 6 "
                                 "layers for the smoke's time"},
            "ranks": rows}


def phase_rank_kernels(seed) -> dict:
    """The model kernels at the shapes a rank of phase 9' (c) gives them:
    ``ssd_chunk`` at zamba2's 40 heads a rank (G=1, N=64, P=64, chunks of
    256 over 4096 positions) against ``ssd_chunk_plain`` on all four
    outputs, and flash attention at 16 q / 16 KV heads of D=80 (bf16,
    causal, S=4096) through ``phase_attention``."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    cfg = zamba_ranks_cfg()
    h = cfg.ssm_heads // MR_MP
    p, n, g, chunk = (cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups,
                      cfg.ssm_chunk)
    nc = MODEL_S // chunk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    args = (0.5 * randn(1, nc, chunk, h, p),
            torch.nn.functional.softplus(randn(1, nc, chunk, h)),
            -torch.exp(0.3 * randn(h)), 0.3 * randn(1, nc, chunk, g, n),
            0.3 * randn(1, nc, chunk, g, n))
    got, want = ssd.ssd_chunk(*args), ssd.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    checks = {name: check_close(f"rank_kernels/ssd_chunk {name}", a, b)
              for name, a, b in zip(("y", "state", "decay", "gate"), got,
                                    want)}
    del got, want
    # as phase_ssd counts them: C·Bᵀ once per (chunk, group), per (chunk,
    # head) the gated product with x and the state; three TF32 products
    tri = chunk * (chunk + 1) // 2
    ops_count = nc * g * 2 * n * tri + nc * h * (2 * p * tri + 2 * chunk
                                                  * n * p)
    nbytes = 4 * (2 * MODEL_S * h * p + nc * h * n * p + 2 * MODEL_S * h
                  + 2 * MODEL_S * g * n + nc * h + h)
    ssd_rec = {"case": f"{cfg.name}/rank/H{h}", "H": h, "P": p, "N": n,
               "G": g, "L": chunk, "NC": nc,
               "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
               "checks": checks,
               "kernel_ms": cuda_time_ms(lambda: ssd.ssd_chunk(*args)),
               "plain_ms": cuda_time_ms(lambda: ssd.ssd_chunk_plain(*args),
                                        reps=3, warmup=1),
               **bound(nbytes, TF32_PRODUCTS * ops_count, TF32_OPS_PER_S)}
    del args
    attn = phase_attention(
        f"{cfg.name}/rank/H{cfg.num_heads // MR_MP}", 1,
        cfg.num_heads // MR_MP, cfg.num_kv_heads // MR_MP, MODEL_S,
        cfg.resolved_head_dim, "bfloat16", True, seed)
    torch.cuda.empty_cache()
    return {"ssd_chunk": ssd_rec, "flash_attention": {
        k: attn[k] for k in ("case", "B", "Hq", "Hkv", "S", "D", "dtype",
                             "max_abs_err", "check", "kernel_ms",
                             "plain_ms", "library_ms", "bound_ms",
                             "bound_by")}}


def analysis_steps() -> dict:
    """Phase 10 (a): each step phases 8 and 9 measured, as the dry run's
    ``build_step`` builds it on the meta device: name → its arguments."""
    return {
        f"{MODEL_ARCH}/prefill/B{MODEL_B}/S{MODEL_S}": dict(
            arch=MODEL_ARCH, shape_name="prefill_32k", batch=MODEL_B,
            seq=MODEL_S, cache_len=MODEL_S + MODEL_GEN),
        f"{MODEL_ARCH}/decode/B{MODEL_B}": dict(
            arch=MODEL_ARCH, shape_name="decode_32k", batch=MODEL_B,
            seq=MODEL_S, cache_len=MODEL_S + MODEL_GEN),
        f"{MODEL_ARCH}/train/B{TRAIN_B}/S{TRAIN_S}": dict(
            arch=MODEL_ARCH, shape_name="train_4k", batch=TRAIN_B,
            seq=TRAIN_S, microbatches=1),
        f"{MOE_ARCH}/{MOE_LAYERS}L/prefill/B1/S{MOE_S}": dict(
            arch=MOE_ARCH, shape_name="prefill_32k", batch=1, seq=MOE_S,
            num_layers=MOE_LAYERS, cache_len=MOE_S + MOE_GEN),
        f"{WHISPER_ARCH}/prefill/B{WHISPER_B}": dict(
            arch=WHISPER_ARCH, shape_name="prefill_32k", batch=WHISPER_B,
            seq=WHISPER_PROMPT, cache_len=WHISPER_PROMPT + WHISPER_GEN),
        **{zamba_ranks_step(r): dict(
            arch=MODEL_ARCH, shape_name="prefill_32k", batch=ZR_B,
            seq=MODEL_S, num_layers=ZR_LAYERS, attn_every=ZR_LAYERS,
            cache_len=MODEL_S + ZR_GEN, grid=("gloo", r))
          for r in range(MR_RANKS)}}


def zamba_ranks_step(rank: int) -> str:
    """Phase 10's name of phase 9' (c)'s prefill on ``rank``."""
    return (f"{MODEL_ARCH}/{ZR_LAYERS}L/grid{MR_RANKS // MR_MP}x{MR_MP}"
            f"/rank{rank}/prefill/B{ZR_B}")


def phase_analysis(measured: dict, smi: str) -> dict:
    """Phase 10 (a): each measured step built by ``dryrun.build_step`` —
    the code that writes the dry run's records — and traced on the meta
    device under ``op_analysis.OpCounter``; the prediction against the
    card's measurement.  ``measured`` maps analysis_steps()'s names to the
    phase records' ``{"s", "peak_delta_bytes", "launches"}``."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import dryrun, op_analysis

    out = {"phase": "analysis", "peak_tol": PEAK_TOL, "card": smi,
           "steps": {}}
    lib_launches = (fa.flash_attention.launches, ssd.ssd_chunk.launches)
    from repro_torch.dist import sharding as shd

    for name, kwargs in analysis_steps().items():
        t0 = time.perf_counter()
        if "grid" in kwargs:  # a rank of phase 9' (c): its traced grid
            backend, rank = kwargs["grid"]
            kwargs = {**kwargs, "grid": shd.TracedGrid(
                {"data": MR_RANKS // MR_MP, "model": MR_MP}, rank=rank,
                backend=backend)}
        step = dryrun.build_step(**kwargs)
        with op_analysis.OpCounter() as counter:
            result = step.run()
        st = counter.stats()
        del result
        trace_s = time.perf_counter() - t0
        meas = measured[name]
        planned = {k: st.kernel_launches.get(k, 0)
                   for k in ("flash_attention", "ssd_chunk")}
        counted = {k: meas["launches"].get(k, 0) for k in planned}
        ratio = st.peak_bytes / meas["peak_delta_bytes"]
        record = {"compute_dtype": step.meta["compute_dtype"],
                  "device": dryrun.card(),
                  "memory": {"argument_bytes": dryrun.tensor_bytes(step.args)}}
        dryrun.apply_stats(record, st)
        del step
        rec = {"predicted_peak_delta_bytes": st.peak_bytes,
               "measured_peak_delta_bytes": meas["peak_delta_bytes"],
               "peak_ratio": ratio, "planned_launches": planned,
               "counted_launches": counted,
               "dot_flops": st.dot_flops,
               "kernel_dot_flops": st.kernel_dot_flops,
               "kernel_recompute_dot_flops": st.kernel_recompute_dot_flops,
               "dot_bytes": st.dot_bytes,
               "bytes_accessed": st.bytes_accessed, "op_count": st.op_count,
               "measured_s": meas["s"],
               "flops_share": st.dot_flops / (meas["s"] * BF16_OPS_PER_S),
               "roofline": record["roofline"],
               "argument_bytes": record["memory"]["argument_bytes"],
               "trace_s": trace_s, "card": smi}
        emit({"phase": "analysis", "step": name, **rec})
        out["steps"][name] = rec
        if planned != counted:
            raise AssertionError(f"analysis/{name}: planned launches "
                                 f"{planned}, the card counted {counted}")
        if abs(ratio - 1.0) > PEAK_TOL:
            raise AssertionError(
                f"analysis/{name}: predicted peak {st.peak_bytes} B is "
                f"{ratio:.4f} of the card's {meas['peak_delta_bytes']} B")
    if (fa.flash_attention.launches, ssd.ssd_chunk.launches) != lib_launches:
        raise AssertionError("analysis: a meta trace launched a kernel")
    out["planned"] = {k: sum(r["planned_launches"][k]
                             for r in out["steps"].values())
                      for k in ("flash_attention", "ssd_chunk")}
    torch.cuda.empty_cache()
    return out


def phase_engine(seed) -> dict:
    """Phase 10 (b): the deprecated ``GXEngine`` shim on an R-MAT of scale
    ``ENGINE_SCALE``: sssp_bf through the vectorized and blocked daemons
    with ``use_pallas=True``, bit-equal to run_reference, its kernels'
    launches counted."""
    import warnings

    import numpy as np

    from repro_torch.core.engine import EngineOptions, GXEngine
    from repro_torch.graph import generate
    from repro_torch.graph.algorithms import sssp_bf
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.plug import run_reference

    n = 1 << ENGINE_SCALE
    g = generate.rmat_stream(n, EDGE_FACTOR * n, seed=seed)
    prog = sssp_bf(g, sources=[0, 1, 2, 3])
    ref, ref_it = run_reference(g, prog, device="cuda")
    out = {"phase": "analysis", "step": "engine", "scale": ENGINE_SCALE,
           "edges": g.num_edges, "reference_iterations": ref_it, "runs": {},
           "launches": {"csr_tile": 0, "edge_block": 0}}
    for execution, kernel in (("vectorized", "csr_tile"),
                              ("blocked", "edge_block")):
        before = (ebk.csr_tile.launches, ebk.edge_block.launches)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = GXEngine(g, prog, num_shards=SHARDS, options=EngineOptions(
                execution=execution, use_pallas=True))
        t0 = time.perf_counter()
        res = eng.run()
        wall = time.perf_counter() - t0
        launches = {"csr_tile": ebk.csr_tile.launches - before[0],
                    "edge_block": ebk.edge_block.launches - before[1]}
        if not np.array_equal(res.state, ref):
            raise AssertionError(f"engine/{execution}: the state differs "
                                 "from run_reference")
        if launches[kernel] == 0:
            raise AssertionError(f"engine/{execution}: {kernel} was never "
                                 "launched")
        out["runs"][execution] = {
            "daemon": type(eng._mw.daemon).__name__,
            "iterations": res.iterations, "wall_s": wall,
            "bit_equal": True, "launches": launches}
        for k, v in launches.items():
            out["launches"][k] += v
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="log2 of the vertex count (Graph500 scale)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    import numpy as np

    from repro_torch import plug
    from repro_torch.graph import generate
    from repro_torch.graph.algorithms import pagerank, sssp_bf
    from repro_torch.graph.compaction import tiles_from_blockset
    from repro_torch.kernels import build
    from repro_torch.kernels import edge_block as ebk
    from repro_torch.kernels.ops import CSRConfig

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    regs = [ln.strip() for ln in build.ptxas_report().splitlines()
            if "registers" in ln]
    lib_sass = library_sass()
    sass = sass_counts(lib_sass)
    tf32_sass = tf32_mma_counts(lib_sass)
    ssd_sass = tf32_mma_counts(lib_sass, SSD_SASS_KERNEL, ssd_instance)
    reds = red_counts(lib_sass)
    del lib_sass
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds, "ptxas": regs,
          "attn_sm90_sass": sass, "attn_tf32_hmma": tf32_sass,
          "ssd_tf32_hmma": ssd_sass, "edge_block_sum_k1_reductions": reds})

    # -- 9'. the model path across four gloo ranks (run first, on a card
    # and host nothing else has used yet): qwen3-moe served, zamba2 under
    # the dense layout, launch.train through a kill -----------------------
    ranks_model_rec, ranks_model_launches = phase_model_ranks(args.seed)
    emit(ranks_model_rec)
    torch.cuda.empty_cache()

    # -- 3. data -----------------------------------------------------------
    t0 = time.perf_counter()
    n = 1 << args.scale
    g = generate.rmat_stream(n, EDGE_FACTOR * n, seed=args.seed)
    t_gen = time.perf_counter() - t0
    parts = plug.HostUpperSystem().partition(g, SHARDS)
    t_part = time.perf_counter() - t0 - t_gen
    probe = plug.Middleware(g, pagerank(g), daemon=pinned_csr_daemon(),
                            partitions=parts, device="cuda")
    blocksets = probe.blocksets
    bs = blocksets[0]
    ts = tiles_from_blockset(bs, n, edge_tile=CSRConfig().edge_tile)
    emit({"phase": "data", "vertices": n, "edges": g.num_edges,
          "shards": SHARDS, "block_size": probe.block_size,
          "vblock_size": probe.vblock_size, "shard0_blocks": bs.num_blocks,
          "shard0_tiles": ts.num_tiles, "ET": ts.edge_tile,
          "RT": ts.row_tile, "ST": ts.src_tile, "generate_s": t_gen,
          "partition_s": t_part,
          "blocks_and_tiles_s": time.perf_counter() - t0 - t_gen - t_part})
    del probe

    # -- 4. kernels at the main path's shapes ------------------------------
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    pr = pagerank(g, max_iterations=PR_ITERATIONS)
    pr_state, pr_aux = (torch.from_numpy(a).to(dev) for a in pr.init(g))
    sources = [0, 1, 2, 3]
    sp = sssp_bf(g, sources=sources)
    # a mid-run sssp state: finite distances and a partial frontier
    sp_state = torch.from_numpy(
        rng.uniform(0.0, 100.0, (n, 4)).astype(np.float32)).to(dev)
    sp_aux = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    sp_active = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    all_active = torch.ones(n, dtype=torch.bool, device=dev)
    cases = []
    for fn, shape, kw, suffix in (
            (phase_csr_tile, ts.arrays(), {}, ""),
            (phase_edge_block, bs, {}, ""),
            (phase_edge_block, bs, {"per_block": True}, "/nb1")):
        for prog, st, ax, act, label in (
                (pr, pr_state, pr_aux, all_active, "pagerank_sum_k1"),
                (sp, sp_state, sp_aux, sp_active, "sssp_min_k4")):
            rec = fn(shape, prog, st, ax, act, label + suffix, **kw)
            emit({"phase": "kernel", **rec})
            cases.append(rec)
    del ts

    # -- 5. end to end -----------------------------------------------------
    e2e_launches = {"edge_block": 0, "csr_tile": 0}
    t0 = time.perf_counter()
    pr_ref, pr_ref_it = plug.run_reference(g, pr, device="cuda")
    sp_ref, sp_ref_it = plug.run_reference(g, sp, device="cuda")
    emit({"phase": "reference", "pagerank_iterations": pr_ref_it,
          "sssp_iterations": sp_ref_it,
          "seconds": time.perf_counter() - t0})
    runs = (("pagerank/cuda/bsp", pr, "bsp", pr_ref, (PR_RTOL, PR_ATOL),
             "csr_tile"),
            ("sssp_bf/cuda/gas", sp, "gas", sp_ref, None, "csr_tile"),
            ("sssp_bf/blocked-cuda/bsp", sp, "bsp", sp_ref, None,
             "edge_block"))
    host_per_it = {}
    host_sp = []  # sssp_bf's host-loop middleware, rebalanced in 5g (f)
    for label, prog, model, ref, tol, kernel in runs:
        daemon = (pinned_csr_daemon() if kernel == "csr_tile"
                  else plug.BlockedDaemon(kernel="cuda"))
        # that middleware owns its partitions (rebalance refuses given
        # ones): the host upper's default cut, as parts is
        own = prog is sp and kernel == "csr_tile"
        res, launches, mw, rec = run_e2e(label, g, prog, daemon, model,
                                         None if own else parts, ref, tol,
                                         num_shards=SHARDS)
        if own:
            if not all(np.array_equal(a.src, b.src)
                       and np.array_equal(a.dst, b.dst)
                       for a, b in zip(mw.partitions, parts, strict=True)):
                raise AssertionError(f"{label}: its own cut is not parts")
            host_sp.append(mw)
        del mw
        if kernel == "edge_block":
            blocked_run = (res, launches, rec)
        if prog is pr:
            pr_exact = res.state  # phase 8 holds the compressed wire to it
        if prog is pr and res.iterations != pr_ref_it:
            raise AssertionError(f"{label}: {res.iterations} iterations, "
                                 f"reference ran {pr_ref_it}")
        if launches[kernel] == 0:
            raise AssertionError(f"{label}: {kernel} was never launched")
        emit(rec)
        for k, v in launches.items():
            e2e_launches[k] += v
        if kernel == "csr_tile":
            host_per_it[prog.name] = (label, rec["per_iteration_s"])

    # -- 5b. the device-resident fused loop --------------------------------
    fused_launches = {"edge_block": 0, "csr_tile": 0}
    mesh1 = {}  # a program's cuda run at mesh=1: label, state, s / it
    stacked_tiles = None
    fused_runs = (
        ("pagerank/sharded-cuda/mesh/bsp", pr, "cuda", "bsp", pr_ref,
         (PR_RTOL, PR_ATOL)),
        ("sssp_bf/sharded-cuda/mesh/gas", sp, "cuda", "gas", sp_ref, None),
        ("sssp_bf/sharded-reference/mesh/bsp", sp, "reference", "bsp",
         sp_ref, None))
    for label, prog, kernel, model, ref, tol in fused_runs:
        res, launches, mw, rec = run_e2e(
            label, g, prog, plug.get_daemon("sharded", kernel=kernel,
                                            csr_config=CSRConfig()),
            model, parts, ref, tol, upper="mesh")
        if prog is pr and res.iterations != pr_ref_it:
            raise AssertionError(f"{label}: {res.iterations} iterations, "
                                 f"reference ran {pr_ref_it}")
        check_fused_run(label, res, mw, rec, launches,
                        res.iterations if kernel == "cuda" else 0)
        if kernel == "cuda":
            mesh1[prog.name] = (label, np.asarray(res.state),
                                rec["per_iteration_s"])
        host_label, host_s = host_per_it[prog.name]
        per_it = rec["per_iteration_s"]
        prof = fused_profile(mw)
        rec.update(phase="fused", host_loop_run=host_label,
                   host_loop_per_iteration_s=host_s,
                   host_over_fused=host_s / per_it, profile=prof,
                   # the profiler slows the host: the busy time against
                   # the unprofiled run's wall time too
                   device_idle_share_unprofiled=(
                       1.0 - prof["device_busy_s_per_iteration"] / per_it))
        if kernel == "cuda":
            state0, aux0 = prog.init(g)
            rec["parts_ms"] = fused_parts_ms(
                mw, torch.as_tensor(state0, device=dev),
                torch.as_tensor(aux0, device=dev),
                torch.ones(n, dtype=torch.bool, device=dev))
        emit(rec)
        for k, v in launches.items():
            fused_launches[k] += v
            e2e_launches[k] += v
        if kernel == "cuda" and stacked_tiles is None:
            # all shards' tiles as the fused loop hands them to csr_tile
            stacked_tiles = {k: v.flatten(0, 1) for k, v in
                             mw.daemon.stacked["csr"].items()}
        del mw
        torch.cuda.empty_cache()
    # the CSR tile at the fused loop's shape: S·nt stacked tiles, the
    # smaller shards ending in whole dead tiles
    for prog, st, ax, act, label in (
            (pr, pr_state, pr_aux, all_active, "pagerank_sum_k1/fused"),
            (sp, sp_state, sp_aux, sp_active, "sssp_min_k4/fused")):
        rec = phase_csr_tile(stacked_tiles, prog, st, ax, act, label)
        emit({"phase": "kernel", **rec})
        cases.append(rec)
    del stacked_tiles
    torch.cuda.empty_cache()

    # -- 5c. the pipeline shuffle ------------------------------------------
    pipe_rec, pipe_launches = phase_pipeline(
        g, parts, pr, sp, pr_ref, pr_ref_it, sp_ref, sp_ref_it, blocked_run,
        args.seed)
    emit(pipe_rec)
    torch.cuda.empty_cache()

    # -- 5d. autotune: the sweep on the card and the loops after it --------
    refs = {pr.name: (pr_ref, pr_ref_it), sp.name: (sp_ref, sp_ref_it)}
    pinned = {name: (label, s) for name, (label, _, s) in mesh1.items()}
    pinned["host/" + sp.name] = host_per_it[sp.name]
    tune_rec, tune_launches = phase_autotune(g, blocksets, parts, pr, sp,
                                             refs, pinned)
    emit(tune_rec)
    del blocksets
    torch.cuda.empty_cache()

    # -- 5e. the shard axis at four logical devices -------------------------
    mesh_rec, mesh_launches, resident4 = phase_mesh(g, parts, pr, sp, refs,
                                                    mesh1)
    emit(mesh_rec)
    e2e_launches["csr_tile"] += tune_launches + mesh_launches
    torch.cuda.empty_cache()

    # 5g's graph and references (5e''s epoch arm runs on it too)
    t0 = time.perf_counter()
    n_e = 1 << ELASTIC_SCALE
    g_e = generate.rmat_stream(n_e, EDGE_FACTOR * n_e, seed=args.seed)
    pr_e = pagerank(g_e, max_iterations=PR_ITERATIONS)
    sp_e = sssp_bf(g_e, sources=sources)
    refs_e = {p.name: plug.run_reference(g_e, p, device="cuda")
              for p in (pr_e, sp_e)}
    setup_e = time.perf_counter() - t0

    # -- 5e'. the graph loop across four gloo ranks on the card -----------
    mesh_its = {r["run"].split("/")[0]: r["iterations"]
                for r in mesh_rec.values() if isinstance(r, dict)}
    ranks_rec, ranks_launches, ranks_async_state, ranks_later = phase_ranks(
        g, refs, resident4, mesh_its, args.seed, g_e, refs_e)
    e2e_launches["csr_tile"] += ranks_launches

    # -- 5f. the async priority model at four logical devices --------------
    mesh4 = {r["run"].split("/")[0]: (r["run"], r["per_iteration_s"])
             for r in mesh_rec.values() if isinstance(r, dict)}
    async_rec, async_launches, async_states = phase_async(
        g, parts, pr, sp, refs, mesh4, args.seed)
    emit(async_rec)
    # 5e''s async arm against this phase's mesh=4 run of its arm
    mesh4_label = f"sssp_bf/async-{RANK_ASYNC_ARM}/mesh4"
    ranks_async_vs_mesh4(ranks_rec["async"][RANK_ASYNC_RUNS[0][0]],
                         ranks_async_state, async_rec[mesh4_label],
                         async_states[mesh4_label])
    del ranks_async_state, async_states
    e2e_launches["csr_tile"] += async_launches
    torch.cuda.empty_cache()

    # -- 5g. the structure-epoch layer: kills, joins, mutations ------------
    elastic_rec, elastic_launches = phase_elastic(
        g_e, plug.HostUpperSystem().partition(g_e, SHARDS), pr_e, sp_e,
        refs_e, mesh4, args.seed, host_sp, sp_ref)
    elastic_rec["graph_and_references_s"] = setup_e
    del pr_e, sp_e, refs_e  # 5i serves on g_e too
    emit(elastic_rec)
    e2e_launches["csr_tile"] += elastic_launches
    torch.cuda.empty_cache()

    # -- 5h. out-of-core: super-shards streamed from pinned host memory ----
    tuned = "sssp_bf/sharded-autotuned/mesh/gas"
    oocore_rec, oocore_launches = phase_oocore(
        g, parts, pr, sp, refs, resident4,
        (tuned, tune_rec[tuned]["per_iteration_s"]))
    emit(oocore_rec)
    e2e_launches["csr_tile"] += oocore_launches
    torch.cuda.empty_cache()

    # -- 5i. online graph-query serving -------------------------------------
    serve_rec, serve_launches, serve_cases, serve_refs = phase_serve(
        g_e, args.seed)
    del g_e
    emit(serve_rec)
    # 5e' (d) against 5i's answers and references; the ranks line last
    ranks_serve_vs_5i(ranks_rec["serve"], ranks_later[1], serve_refs)
    del ranks_later, serve_refs
    emit(ranks_rec)
    e2e_launches["csr_tile"] += serve_launches
    cases.extend(serve_cases)
    torch.cuda.empty_cache()

    # -- 6. attention at qwen2-72b width (and whisper-base's head dim) -----
    attn = []
    for case in ATTN_CASES:
        rec = phase_attention(*case, seed=args.seed)
        emit(rec)
        attn.append(rec)
        torch.cuda.empty_cache()

    # -- 7. ssd at mamba2-1.3b width ---------------------------------------
    ssd_rec = phase_ssd(args.seed)
    emit(ssd_rec)
    torch.cuda.empty_cache()

    # -- 8. zamba2-2.7b served through both model kernels; the compressed
    # wire on the graph path ------------------------------------------------
    model_rec, model_attn, model_ssd_rec, model = phase_model(args.seed)
    emit({**model_rec, "attention": model_attn, "ssd": model_ssd_rec})
    emit(phase_wire(g, parts, pr, pr_exact))
    del g, parts
    torch.cuda.empty_cache()

    # -- 9. training: zamba2-2.7b on phase 8's model, qwen3-moe, whisper,
    # the launchers ----------------------------------------------------------
    box = [model]
    del model
    train_rec, train_cases = phase_train(box, args.seed)
    emit({**train_rec, "attention_cases": train_cases})
    torch.cuda.empty_cache()


    # -- 10. the dry-run accounting against the card; the GXEngine shim ----
    t_phase = time.perf_counter()
    measured = {
        f"{MODEL_ARCH}/prefill/B{MODEL_B}/S{MODEL_S}":
            model_rec["measured_prefill"],
        f"{MODEL_ARCH}/decode/B{MODEL_B}": model_rec["measured_decode"],
        f"{MODEL_ARCH}/train/B{TRAIN_B}/S{TRAIN_S}":
            train_rec["zamba2"]["measured_step"],
        f"{MOE_ARCH}/{MOE_LAYERS}L/prefill/B1/S{MOE_S}":
            train_rec["moe"]["measured_prefill"],
        f"{WHISPER_ARCH}/prefill/B{WHISPER_B}":
            train_rec["whisper"]["measured_prefill"]}
    for row in ranks_model_rec["zamba2"]["ranks"]:  # the second prefill
        measured[zamba_ranks_step(row["rank"])] = {
            "s": row["prefill_s"][1],
            "peak_delta_bytes": row["peak_delta_bytes"][1],
            "launches": row["launches"][1]}
    analysis = phase_analysis(measured, smi)
    engine = phase_engine(args.seed)
    emit({"phase": "analysis", "seconds": time.perf_counter() - t_phase,
          "planned_launches": analysis["planned"],
          "engine_launches": engine["launches"]})

    # -- the kernels line --------------------------------------------------
    sources_of = {
        "csr_tile": ("src/repro_torch/kernels/csrc/csr_tile.cu",
                     "src/repro/kernels/edge_block.py:189"),
        "edge_block": ("src/repro_torch/kernels/csrc/edge_block.cu",
                       "src/repro/kernels/edge_block.py:81"),
    }
    # the case at the shape the main path launches: every shard's tiles at
    # once (the fused loop) for the CSR tile, one block per launch for the
    # edge block
    main_case = {"csr_tile": "sssp_min_k4/fused",
                 "edge_block": "sssp_min_k4/nb1"}
    kernels = []
    for name, (source, replaces) in sources_of.items():
        mine = [c for c in cases if c["kernel"] == name]
        main = next(c for c in mine if c["case"] == main_case[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": e2e_launches[name],
            "launches_fused": fused_launches[name],
            "launches_engine": engine["launches"][name],
            **({"launches_pipelined": pipe_launches}
               if name == "edge_block" else
               {"launches_autotuned": tune_launches,
                "launches_mesh4": mesh_launches,
                "launches_ranks": ranks_launches,
                "launches_async": async_launches,
                "launches_elastic": elastic_launches,
                "launches_oocore": oocore_launches,
                "launches_serve": serve_launches}),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "cases": {c["case"]: {k: c[k] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "library_ms",
                "max_abs_err")} for c in mine},
        })
    # the model kernels' main path is phase 8's prefill: their launches
    # there, and their times at its shapes (phases 6-7's in "cases")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:69",
        "launches": model_rec["launches"]["flash_attention"],
        "launches_dryrun": analysis["planned"]["flash_attention"],
        "launches_entry_point": attn[0]["launches"],
        "max_abs_err": max(
            [model_attn["max_abs_err"],
             ranks_model_rec["rank_kernels"]["flash_attention"][
                 "max_abs_err"]] + [c["max_abs_err"] for c in attn]),
        "ms": model_attn["kernel_ms"], "plain_ms": model_attn["plain_ms"],
        "bound_ms": model_attn["bound_ms"],
        "bound_by": model_attn["bound_by"],
        "library_ms": model_attn["library_ms"],
        "model_case": f"{MODEL_ARCH}/prefill/B{MODEL_B}/S{MODEL_S}",
        "launches_train": train_rec["zamba2"]["launches"]["flash_attention"],
        "launches_moe_prefill": train_rec["moe"]["launches"],
        "launches_whisper_prefill": train_rec["whisper"]["launches"],
        "launches_whisper_train":
            train_rec["whisper"]["train_launches"]["flash_attention"],
        "launches_model_ranks": ranks_model_launches,
        "launches_model_ranks_zamba2": [
            row["launches"][0]["flash_attention"]
            for row in ranks_model_rec["zamba2"]["ranks"]],
        "rank_case": ranks_model_rec["rank_kernels"]["flash_attention"],
        "gradient": "autograd.Function, plain backward (29)",
        "design": {
            "bf16": "flash_attention_sm90.cu: 3-stage TMA ring of "
                    "128-key k/v tiles, wgmma m64n128k16 q·kᵀ, online "
                    "softmax in registers, P·V as bf16 hi + lo wgmmas with "
                    "A from registers; 2 consumer warpgroups taking turns "
                    "+ 1 producer warpgroup; head dims 8..128 in steps of "
                    "8 on instantiations at 16/32/64/128, TMA zero-filling "
                    "the columns past d",
            "f32": "flash_attention.cu: 3xTF32 on mma.sync m16n8k8 (each "
                   "product as a_s·b_b + a_b·b_s + a_b·b_b, cvt.rna split), "
                   "4 warps of 16 query rows, 64-key k/v tiles by cp.async "
                   "double-buffered with zero-fill, q split once into "
                   "shared memory, P from the S accumulator in registers; "
                   "instantiations at every multiple of 16 up to 128",
            "sass": sass, "f32_sass_tf32_hmma": tf32_sass,
        },
        "cases": {c["case"]: {k: c[k] for k in (
            "kernel_ms", "entry_ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err")} | {"tol_share": c["check"]["tol_share"],
                               "library_tol_share":
                                   c["library_check"]["tol_share"]}
                  | {k: c[k] for k in ("fma_bound_ms",) if k in c}
                  for c in attn} | {c["case"]: {k: c[k] for k in (
                      "kernel_ms", "plain_ms", "bound_ms", "library_ms",
                      "max_abs_err", "tol_share")} for c in train_cases},
    })
    kernels.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:61",
        "launches": model_rec["launches"]["ssd_chunk"],
        "launches_dryrun": analysis["planned"]["ssd_chunk"],
        "launches_entry_point": ssd_rec["launches"],
        "max_abs_err": max(ssd_rec["max_abs_err"],
                           model_ssd_rec["max_abs_err"],
                           ranks_model_rec["rank_kernels"]["ssd_chunk"][
                               "max_abs_err"]),
        "ms": model_ssd_rec["kernel_ms"],
        "plain_ms": model_ssd_rec["plain_ms"],
        "bound_ms": model_ssd_rec["bound_ms"],
        "bound_by": model_ssd_rec["bound_by"],
        "library_ms": None, "entry_ms": model_ssd_rec["entry_ms"],
        "fma_bound_ms": model_ssd_rec["fma_bound_ms"],
        "model_case": f"{MODEL_ARCH}/prefill/B{MODEL_B}/S{MODEL_S}",
        "launches_train": train_rec["zamba2"]["launches"]["ssd_chunk"],
        "launches_model_ranks_zamba2": [
            row["launches"][0]["ssd_chunk"]
            for row in ranks_model_rec["zamba2"]["ranks"]],
        "rank_case": ranks_model_rec["rank_kernels"]["ssd_chunk"],
        "gradient": "autograd.Function, plain backward (29)",
        "cases": {ssd_rec["case"]: {k: ssd_rec[k] for k in (
            "kernel_ms", "entry_ms", "plain_ms", "bound_ms", "fma_bound_ms",
            "max_abs_err")}},
        "design": "ssd_scan.cu: 3xTF32 on mma.sync m16n8k8 (each product "
                  "as a_s·b_b + a_b·b_s + a_b·b_b), 256 threads a CTA; one "
                  "launch of y CTAs (batch, chunk, group, block of 16 "
                  "heads, 64 target rows; heaviest first) that form C·Bᵀ "
                  "once into shared memory and W = C·Bᵀ ∘ gate ∘ dt per head "
                  "in registers, then state CTAs (batch, chunk, head, 128 "
                  "state rows); tiles by cp.async, double-buffered, "
                  "zero-filled past L and N",
        "sass_tf32_hmma": ssd_sass,
    })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
