#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the emulator on one CUDA card.

Run from the root of a checkout, with one CUDA device visible:

    python3 chip_smoke.py

Phases, each printing its lines in order:

1. **Device** — the card's name and power limit (``nvidia-smi``).
2. **Build** — ``nvcc`` compiles all five hand-written kernels from
   ``src/repro_torch/kernels/csrc`` for ``sm_90a`` into
   ``build/repro_torch/``, and kernel B once more with its clock64()
   phase stamps (one process per library, started together).
3. **Kernel A** (``hmmu_lookup``) against its plain version at the
   paper's geometry (294,912 x 8 table), B in {1, 4}, m in {512, 514},
   and B in {16, 64} at m = 514, with negative and past-the-end pages;
   then its fused entry (the scan path's stage 2: every point's 512
   chunk rows and its raw DMA swap pair, -1 idle, negative and past the
   end, each point from its own table) at B in {1, 16, 64}, and at B = 16
   with one chunk shared by every point: ``torch.equal``; each one's
   time, the plain version's, one advanced-indexing call's
   (``library_ms``) and the byte bound.
4. **Kernel B** (``chunk_step``) against its plain version (the loop of
   ``step_ref(seq=True)`` and ``counters.update``): each of the six
   policies, on ``small_platform``, on the paper geometry and on the
   paper geometry with a flash slow tier (a chunk's read latencies sum
   past 2^24, which must happen at least once), from an
   adversarial state (pins, a poisoned page, a swap in flight) with an
   endurance budget and a fault plan of deaths and transients, over more
   than 2 x ``decay_every`` chunks, launched once per chunk (compared
   after every chunk) and once over all the chunks (final state, the 16
   counters and every output); then B = 2 design points (different
   params) over all their chunks in one launch.
5. **The main path at full size** — ``Engine(paper_platform().with_(
   chunk=512, policy="hotness", hot_threshold=4)).run`` on the port's
   ``520.omnetpp`` trace at scale 1e-4 (1,342,177 requests, 2,622
   chunks), once through kernel B (``chunk_step_kernel="auto"``: one
   launch) and once through the scan path whose stage-2 gather is kernel
   A's fused entry (``"off"``: one launch per chunk); the two final
   states, counters
   and outputs must be bitwise equal. Then kernel B's device time per
   chunk over the whole trace and its share of the wall time of the same
   ``Engine.run`` (three runs), its clock64() phase split from the
   stamped build and that build's time, the same run with one thread
   block per point instead of a cluster (results equal), and its plain
   version's time.
6. **The model kernels at full width** — the entry points
   ``ops.flash_attention``, ``ops.decode_attention`` and
   ``ops.rwkv_chunk`` driven once per case at the widths of the repo's
   configurations (minitron-8b, gemma3-4b, phi3-mini, rwkv6-7b; inputs
   from fixed seeds on the card), each launch counted, and the flash
   kernel's path per call ("wgmma" for every bf16 case, whose head dims
   are multiples of 8, "mma" for every fp32 one); the count of ``HGMMA``,
   ``UTMALDG`` and TF32 ``HMMA`` (``mma.sync``) instructions in the flash
   library's SASS and of TF32 ``HMMA`` in the RWKV library's where
   ``cuobjdump`` is found; then each case against
   its plain version on the same inputs (max abs error and its share of
   ``repro_torch.kernels.ref.kernel_error``'s allowance), the kernel's
   device time, the plain version's, a library yardstick's where one
   PyTorch call computes the same function
   (``scaled_dot_product_attention``), and the bound; for the bf16 RWKV
   case also each of its three device kernels' time per launch (CUPTI),
   whose sum must come within 5% of the launch's events time. A case whose
   bytes fit in the 50 MB L2 is timed with the L2 flushed before each call.
7. **The design-point sweep at full size** — ``Engine.sweep`` over the
   repo's 16-point Fig 8 grid (3D XPoint and STT-RAM, 1/9 and 2/9 of the
   pages fast, ``hotness`` and ``static``, link latencies 600 and 1200;
   ``benchmarks/bench_sweep.py``'s grid) at ``paper_platform().with_(
   chunk=512, hot_threshold=4, decay_every=32, write_weight=4)`` on the
   ``505.mcf`` trace at scale 1e-5 (970,662 requests over 154,112 pages,
   past both fast tiers): ONE launch of kernel B and none of kernel A;
   every point reaches its slow tier, and every ``hotness`` point
   migrates; every point bitwise equal to its own ``Engine.run``;
   ``continue_sweep`` over the second half equal to the whole sweep; the
   ``"off"`` route over the first 64 chunks, one chunk loop for all 16
   points with ONE launch of kernel A a chunk (64 in all) and none of
   kernel B, equal to ``"auto"``, and kernel A's device time per launch
   there; over 40
   chunks, the 16 points and one with a ``policy_id`` past the end of a
   registry subset (``hotness``, ``static``, ``write_bias``), in one
   launch, each equal to its plain run at its own parameters. Then the
   sweep's wall, us per point-request, kernel B's device time and share of
   the wall, peak device memory, and kernel B's device time at B = 1, 16
   and 64.
8. **Serving at full size** — the port's continuous-batching scheduler
   (``repro_torch.serve``) over ``Engine`` at the three profiles of
   ``benchmarks/bench_serve.py:55-87`` with its workload (``:93-99``),
   as ``BENCH_serve.json`` records them. ``full`` (294,912 table rows,
   110,000 sequences, 100,000 live) on ``"auto"``: ``warmup``, then
   ``submit`` and ``run`` traced; every emulated field of the file's
   ``metrics`` and of its per-bucket ``cases`` equal to the port's
   report (floats exactly), kernel B launched once a dispatch (274),
   no new dispatch key after warmup; the wall, emulated requests per
   second, kernel B's device time and share of the wall, the host
   synchronisations PyTorch's sync debug mode sees in the run, the same
   run at ``max_live_batches=1`` (results and final state equal), and a
   third run's split of the host's time (``Engine.run``, copies,
   harvest, contracts, the scheduler's numpy work).
   ``quick`` and ``degraded`` (a seeded plan killing 5% of the fast
   tier's frames) on ``"auto"`` and ``"off"``: each equal to its
   metrics in the file, the two routes bitwise equal (outs and trace
   logs, final state). ``quick`` without pins against
   ``Engine.run_stream`` over its trace log at prefetch 0 and 2. Pin
   contracts stamped and released on the card, at the full geometry,
   over a padded batch holding the DMA's in-flight pair, a POISONED and
   a RETIRED page: equal to the CPU and to a plain loop.
9. **User policies, tiered KV-cache accounting and consumed states** —
   (a) two policies registered with ``core.policies.register``
   (``user_hotness``, ``hotness`` under a new name; ``user_write_hot``,
   the hottest slow page written in the chunk) at phase 7's platform on
   phase 7's trace cut to its first 128 chunks: the six built-ins and
   both user policies in one ``"off"`` sweep (one chunk loop, ONE launch
   of kernel A a chunk), the six built-ins on ``"auto"`` (ONE launch of
   kernel B), bitwise equal across the routes; ``user_hotness`` equal to
   ``hotness``; ``user_write_hot`` equal to its own one-point ``"off"``
   run; ``"auto"`` refusing ``user_write_hot`` by name, launching kernel
   B once at ``hotness`` with the user policies registered, and refusing
   an impostor re-registered as ``hotness``; the ``"off"`` sweep's wall,
   us per point-request and kernel A's device time. (b)
   ``memtier.TieredKVAccounting`` at minitron-8b's KV width (4,096 B a
   position, 64 positions a page, one pinned page a sequence) on
   ``paper_platform().with_(chunk=512, policy="hotness",
   hot_threshold=4)``: 128 sequences of 32,768 tokens (65,536 pages,
   twice the fast tier), 8 decode steps, 16 sequences freed and 16
   admitted, 4 more steps, on ``"auto"`` (one kernel-B launch a step) and
   ``"off"`` (one kernel-A launch a chunk): reports, final tables,
   counters and states bitwise equal, ``check_table`` passing; the wall
   a step split into stream building and ``account``, kernel B's device
   time a step and its share. (c) A consumed (donated) state passed to
   ``Engine.run`` again raises ``RuntimeError``. (d), run first: kernel
   B's energy fold (``__fmaf_rn``, the reference's order under ``jit``)
   on 2,000 random single-chunk channels in one launch, each folded from
   zero, bitwise equal to the plain route's exact FMA; some of them must
   differ from the form that rounds every product on its own.
10. **Serving the dense models at full width** — ``memtier.ServeEngine``
   over the port's model (``models.init_params`` on the card from a seed,
   bfloat16, every layer) with ``launch/serve.py``'s emulator settings
   (64 fast and 4,096 slow pages, chunk 64, ``hotness``,
   ``hot_threshold=4``, one pinned page a sequence), batch 8, ``smax``
   2,048, 16 requests (prompts of 1,024-1,536 tokens from a seed, 32 new
   tokens; the 15th 64 new tokens, the 16th a 2,016-token prompt and 8,
   so its idle lane's ``pos`` passes ``smax``), at minitron-8b (32
   layers) and then gemma3-4b (34 layers, window 1,024 on five layers of
   six, tied embeddings), each model's weights freed before the next.
   Checks: kernel B launched once a decode step and no other kernel
   (the counts from the run alone); an idle lane's ``pos`` past
   ``smax`` with no device assert; the tier's report, table, counters
   and state bitwise equal to a CPU ``TieredKVAccounting`` replay of the
   recorded streams and frees; every token the argmax of a prefill over
   its prompt and the tokens before it wherever that row's top-2 margin
   exceeds ``LOGIT_TOL``, and every decode-path logit row within
   ``LOGIT_TOL`` of it; layer 0's ``rms_norm`` equal to its float32
   formula and RoPE within one bfloat16 step of the rotation; on
   layer 0's activations ``ops.flash_attention`` against
   ``chunked_attention`` and ``ops.decode_attention`` against
   ``dist_decode`` within ``ref.kernel_error``; and layer 0 at decode
   step ``SPY_STEP`` against one layer-0 forward of each live lane's
   sequence: the q and cache rows within ``CACHE_REL``, ``dist_decode``
   within the float32 allowance of float64 attention over the engine's
   ``pos + 1`` rows and the layer's window, ``chunked_attention``'s row
   within the bfloat16 allowance of float64 attention on its inputs. The
   model runs as users run it: its entry points accumulate bfloat16
   products in float32 whatever PyTorch's default. Numbers: parameter bytes,
   peak device memory, ``init_params`` time, prefill ms and tokens/s, a
   decode step's wall split into the model, stream building and
   ``account``, kernel B's device time a step (CUPTI) and its share.
11. **Serving the other families at full width** — ``ServeEngine`` as in
   phase 10 (bfloat16, random weights from a seed, ``launch/serve.py``'s
   emulator settings, kernel B once a decode step, the report and every
   tier state field bitwise equal to a CPU replay) at rwkv6-7b (whole:
   batch 8, 10 requests of 1,024-1,536 tokens in multiples of the 128
   chunk, 128 new tokens, two of them 64, so the 9th and 10th join a live
   batch), hymba-1.5b (whole: batch 4, 6 requests of 960-1,100 tokens,
   one past the 1,024 window and one crossing it while decoding, 48 new),
   deepseek-v2-236b (full width, the first 4 of 60 layers: MLA and 160
   experts top-6 plus 2 shared) and phi3.5-moe-42b (full width, 8 of 32
   layers), both batch 8, 10 requests of 1,024-1,536 tokens, 32 new, each
   model's weights freed before the next. Checks, in the layer where a
   fault would happen first: rwkv6-7b's layer 0 through kernel 5
   (``ops.rwkv_chunk``) against the model's scan, and its decode state
   against float64 over prompt + 1; hymba's layer 1 (windowed): the flash
   kernel against ``chunked_attention``, the length ``dist_decode`` saw
   over a wrapped ring, the decode kernel over the ring against
   ``dist_decode`` and float64, the Mamba state against the sequential
   scan over prompt + 1; deepseek-v2's layer 0: the absorbed MLA decode
   against float64 materialised attention and the latent cache rows
   against the sequence path; both MoE models' layer 0: the routing equal
   to a plain recomputation and the output within its allowance, over
   calls that drop slots; phi3.5-moe's layer 0 also takes phase 10's GQA
   checks. Then the tokens against the sequence path within
   ``LOGIT_TOL`` (the MoE models in a second serve of 4 requests with no
   token dropped on either path, and every row held, the sequence path
   routing the compared tokens to the decode path's experts). Phases 10
   and 11 run one function (``model_serve``) over their rows
   (``DENSE_SERVES``, ``FAMILY_SERVES``). Numbers: parameter
   bytes, peak memory, prefill ms and tokens/s, a decode step's wall
   split, the model's device time and kernels a step, kernel B's device
   time a step, the MoE's live slots dropped a step, the logit spread.
12. **Training at full width** — (a) internlm2-1.8b whole
   (``configs/internlm2_1p8b.py``: 24 layers, d 2,048, GQA 16/8 heads of
   128, d_ff 8,192, vocab 92,544, untied head; 1.889B parameters, bf16
   from a seed, float32 moments) on the port's Markov data
   (``data.make_batch``) at batch 4 x 2,048 in 2 micro-batches, 8 steps
   of ``launch.steps.make_train_step`` at lr 3e-4 (``launch/train.py``'s
   schedule). Checks: the batches of the 8 steps on the card equal the
   CPU's; every loss finite, the last step's below the initial model's
   loss on the same batch and the first batch's after the 8 steps below
   its first (a step's batch is new to the model, and batches differ by
   more than 8 steps teach); layer 0 at the first step (its input, the
   gradients at its output, its parameters and its input recorded by
   hooks) recomputed in float64 from its formulas, each parameter
   gradient and dx within ``GRAD_REL`` of it (||g - g64|| / ||g64||); on
   layer 0's q, k, v and the gradient at its attention output,
   ``chunked_attention``'s backward against float64 autograd
   (``ATTN_GRAD_REL``) and ``ops.flash_attention``'s gradient (kernel 3's
   forward, launches counted) within ``ref.kernel_error`` of it; at the
   second step, AdamW's update of the embedding, layer 0's ``wq`` and
   ``final_norm`` bit for bit the port's ``adamw_update`` on the CPU over
   the same inputs, and within ``ADAMW_*_REL`` of its float64 formula.
   Numbers: parameter bytes, peak memory, a step's wall (median of steps
   2-7) and tokens/s, the model's FLOPs a step and their share of 989
   TFLOP/s, the last step's device time, kernels and device share
   (CUPTI) with its largest kernels, AdamW's part of a step. (b) crash and
   resume: ``launch.train.run`` at internlm2-1.8b's full width, its first
   2 of 24 layers, on the card: 8 steps with a checkpoint every 4 and
   ``--simulate-failure-at 4``, a resume to step 8, and an uninterrupted
   run: the final losses within rtol 1e-5 and every parameter bit for
   bit, each checkpoint's write time and bytes. (c) The other families at
   full width, each cut to its first 2 layers (``TRAIN_FAMILIES``), two
   steps of ``make_train_step`` on their Markov data: rwkv6-7b (batch 2 x
   512, the chunked scan's backward over four 128-token chunks),
   hymba-1.5b (2 x 512, the per-token Mamba loop under autograd) and
   phi3.5-moe-42b (2 x 1,024, the dense dispatch's backward and the aux
   loss, at its capacity factor 1.25); each loss finite, layer 0's
   gradients at the first step (and dx) within ``GRAD_REL`` of layer 0
   written out in float64 from its formulas (RWKV's time mix as the
   per-token recurrence, Mamba's scan a token at a time, the MoE at the
   step's own routing), peak memory.
13. **The paper's oracle and Fig 7 on the card, large chunks and the
   examples** — (a) the central correctness claim at the paper's geometry
   (``paper_platform().with_(chunk=1, ...)``: 294,912 pages, 16 banks, 3D
   XPoint): on the six workloads of ``benchmarks/bench_speedup.py``
   (``WORKLOADS_SMALL``, scale 6e-9, 16,384 requests each) under
   ``static``, ``hotness`` (``hot_threshold=2, decay_every=512``) and
   ``write_bias`` (``hot_threshold=4, decay_every=64, write_weight=4``),
   and once more on ``505.mcf`` with ``write_bias`` at 131,072 requests,
   ``Engine.run`` on ``"auto"`` (ONE launch of kernel B over one-request
   chunks) bitwise equal to the port's sequential simulators
   (``repro_torch.sims``: ``trace_sim`` and ``cycle_sim(refresh=False)``)
   in every request's return, latency and device, the final clock, the
   swaps (``cycle_sim`` may lead by the swap in flight at the end), the
   integer and byte counters, with the energy and read-latency counters
   (float32 sums of one term a chunk) within their rounding bound; every
   case that migrates (``ORACLE_MIGRATING``) shows swaps; then ``"off"``
   (one launch of kernel A a chunk) on each policy's first 512 requests,
   held the same way, and ``"auto"`` over those requests bitwise equal to
   it, final table and state included. (b) Fig 7: ``bench_speedup``'s ``paper_platform().
   with_(chunk=4096)`` on the same six workloads: the native time (the
   emulated clock, 1 cycle = 1 ns), ``Engine.run``'s synchronised wall
   (a warm-up, then the median of 3), the walls of ``trace_sim`` and of
   ``cycle_sim(refresh=True, cpu_model=True)``, the three slowdowns and
   two speedups and their geometric means, beside the card's name and
   power limit; kernel B on its workspace layout. (c) Kernel B past its
   shared-memory ceiling: chunk 2048 keeps the per-request arrays in
   shared memory, chunk 4096 in a global workspace; at chunk 4096 on
   phase 5's trace ``"auto"`` bitwise equal to ``"off"``; at 2048 and 4096
   a B = 2 ``Engine.sweep`` (``hotness``, ``write_bias``) in one launch,
   each point equal to its own run; the layout each launch took and
   kernel B's us per chunk at both sizes. (d) The five ported examples
   (``examples/{quickstart, policy_exploration, serve_continuous,
   wear_leveling, endurance_lifetime}_torch.py``, the last two with
   ``--quick --check``) run in this process on the card, each to its end
   with its own assertions (``serve_continuous``'s flat
   ``compile_count`` among them), their rows printed.
14. **The multi-device paths** — (a) phase 7's 16-point grid and trace
   through ``Engine.sweep(mesh=...)`` over 2 and 3 shares of the card
   (``(cuda:0,) * 2``: 8 + 8 points; ``* 3``: padded to 18), one launch
   of kernel B a share, each bitwise equal to phase 7's single launch,
   with each share's launch time (CUDA events); a split
   ``continue_sweep`` over the second half equal to the whole sweep;
   ``"off"`` over 3 shares on the first 64 chunks (one chunk loop a
   share, kernel A once a chunk in each) equal to ``"auto"``; a CPU mesh
   refused by a CUDA engine; ``sweep_mesh()``'s device count. One card:
   scaling over cards is not measured. (b) The models' sharded paths in
   2 ``gloo`` ranks sharing the card (data 1 x model 2, one process a
   rank, ``launch.mesh.run_ranks``), each at full width with its depth
   cut and held to the same model unsharded on the card in the same
   rank: hymba-1.5b (2 layers; 25 heads divide no even model axis) with
   a 2,048-token prefill on the context-parallel path and 2 decode steps
   over rings split on their slots (layer 0's attention rows and layer
   1's ring within ``CACHE_REL``, the logits within ``LOGIT_TOL``);
   phi3.5-moe-42b (2 layers, 8 of 16 experts a rank) forward and
   backward through the expert-parallel path at capacity factor 8
   (nothing dropped) against the dense path, and at 1.0 (every rank
   drops) against the per-rank composition of the port's own
   ``_route_scatter``, ``_expert_ffn`` and ``_combine`` (layer 0's MoE
   output within ``CACHE_REL``, the loss within 2^-9, layer 0's
   gradients within ``GRAD_REL``); minitron-8b (2 layers) a 1,024-token
   prefill and 4 decode steps over a cache split on its sequence axis
   (layer 0's ``dist_decode`` within the float32 attention allowance,
   the cache slices within ``CACHE_REL``, the logits within
   ``LOGIT_TOL``). Each rank prints its device time, the bytes of each
   collective, the host round trips (gloo's all-gather of CUDA tensors,
   ``dist.HOST_TRANSPORT``) and their bytes, and its peak memory.
15. **Training over a mesh** — ``launch.train.run --mesh dev`` in 4
   ``gloo`` ranks sharing the card (``launch.mesh.run_ranks``), full width
   with the depth cut, the weights held by ``launch.shardings.
   param_specs``, the moments and the gradient accumulator by
   ``zero1_specs`` (ZeRO-1/2). Rank 0 first runs the same
   ``launch.train.run`` on one device (same seed, weights, batches,
   schedule) while the others wait. (a) internlm2-1.8b, 2 of 24 layers,
   data 2 x model 2, batch 4 x 512 in 2 micro-batches, 4 steps: the first
   step's loss within ``MESH_LOSS_RTOL`` and its global norm within
   ``MESH_STEPS_RTOL`` of the single device's, and equal to the sum over
   the distinct blocks; every gradient leaf, from each rank's block of
   it, norm-wise within the row's ``grad_rel`` of the single device's;
   the 4 losses and grad norms within ``MESH_STEPS_RTOL``; the bytes each
   rank holds in parameters, moments and the accumulator equal to each
   leaf's whole size over the product of its spec's axis sizes; the
   first step's ZeRO-1 update on copies of each rank's blocks bit for bit
   the same step over the rank's whole parameter blocks; then the
   elastic restart: the run's checkpoint at step 2 on (data 2, model 2),
   resumed on (data 1, model 4) to step 4, its losses within
   ``MESH_STEPS_RTOL`` of the straight run's, and its final parameters
   norm-wise too. (b) phi3.5-moe-42b, 1 of 32 layers, the weights split
   over ``"data"`` too (the launcher's ``needs_fsdp`` of the whole
   configuration: 8 of 16 experts a rank, each halved
   over ``"data"``), data 2 x model 2, batch 2 x 1,024, 2 steps at capacity factor E / k (no token dropped on
   either path): the same checks but the bitwise update (every block is
   already split over ``"data"``) and the restart, and each rank's
   expert bytes. (c) ``optim.compressed_psum_spec`` over the 2-rank
   ``"pod"`` axis of a (pod 2, model 2) mesh on internlm2-1.8b's layer
   shapes, each pod's gradients at another magnitude: within 2% of the
   exact all-reduce (``tests/test_grad_compression.py``'s bar),
   deterministic and stochastic, and the int8 blocks and scales equal to
   ``compress_int8`` on the CPU. Per rank: held bytes, peak memory, each
   step's wall, and over the run the bytes, calls and seconds of each
   collective and the host round trips (gloo's all-gather of CUDA
   tensors, ``dist.HOST_TRANSPORT``).
16. **The dry run against the card** — phase 15 (a)'s step
   (internlm2-1.8b, 2 of 24 layers at full width, data 2 x model 2, 4 x
   512 in 2 micro-batches) dry-run by ``launch.dryrun`` as rank 0 of a
   4-rank ``"fake"`` process group on ``meta`` tensors: its held bytes
   (weights, moments, gradient accumulator) and each collective's
   operand bytes a step equal to rank 0's records of phase 15 (reused, not
   run again), and its FLOPs equal to ``FlopCounterMode`` around phase
   15's second step on rank 0; the predicted peak beside the rank's
   ``torch.cuda.max_memory_allocated`` (a reading). Then two production
   cells through the CLI in a subprocess, ``internlm2-1.8b decode_32k``
   on 16 x 16 and ``internlm2-1.8b train_4k`` on 2 x 16 x 16: both
   ``"status": "ok"``. The dry run launches no kernel.
17. **The stage cut and the budget run** — (a) ``kernels.chunk_step.
   step_until(upto="full")`` on phase 5's first chunk, on the card,
   bitwise equal to one chunk of kernel B (``chunk_step``); (b) each of
   ``STAGES`` over phase 5's first two chunks on the card bitwise equal
   to the CPU's; (c) ``analysis.ranges``' budget run at
   ``paper_platform()``, chunk 512: 1,024 chunks of an all-write hot
   trace from the HOTNESS and WEAR lanes three under their caps, the time
   fields and EPOCH just under the int32 horizon that run reaches (a
   first run from the time origin measures it) and the summing counters
   under 2^31 - 1 less one a request, on kernel B (one launch a run),
   bitwise equal to its plain version (``step_ref(seq=True)``'s loop);
   HOTNESS and WEAR saturate at their caps and nothing wraps; (d) a
   consumed state's storage identity on kernel B: ``Engine.run(state=)``,
   ``run_stream`` and ``continue_sweep`` on ``"auto"`` hand back tensors
   in the passed state's memory.
18. **The kernel sanitizer's checks on the card** (``analysis.
   kernel_san``; NVIDIA's ``compute-sanitizer`` refuses this machine's
   card, ROADMAP §3): each of the five kernels at small shapes with every
   buffer its wrapper allocates between guard bands and poisoned, twice
   with two poisons: equal to its plain version (kernels A and B bit for
   bit), the same under both poisons, every guard band intact; kernel
   B's layout at each of the pass's chunks as the pass predicts, and the
   card's opt-in shared memory a block equal to the pass's limit.
19. One JSON line of per-kernel numbers (kernels A and B also carry
   ``serve_launches``, ``policy_launches``, ``memtier_launches``,
   ``model_serve_launches``, ``family_serve_launches``,
   ``oracle_launches``, ``fig7_launches`` and ``example_launches``, the
   counts of phases 8, 9 (a), 9 (b), 10, 11 and 13 (a), (b), (d); every
   kernel ``train_launches``, phase 12 (a) and (c)'s, ``mesh_launches``,
   phase 14's, ``mesh_train_launches``, phase 15's, and
   ``dryrun_launches``, ``stage_launches`` and ``kernel_san_launches``,
   phases 16, 17 and 18's), the card line again, and the last line
   ``{"ok": true, "device": {...}}``.

Any mismatch or error exits nonzero. Without a CUDA device, or without
the rest of the repository, it exits nonzero before printing a result.
Only the port is imported: nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from typing import Callable, NamedTuple

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory, NVIDIA's data sheet
# H100 SXM dense peaks (NVIDIA's data sheet): bf16 tensor cores, and fp32
# outside them (one TF32 product misses the float32 tolerances).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# A float32 product can also run exactly enough on the TF32 tensor cores
# (495 TFLOP/s dense) as three TF32 products (3xTF32): 165e12 float32
# FLOP/s, the least time of the float32 products of the RWKV kernel and of
# the flash kernel's "mma" path.
FP32_3XTF32_FLOPS = 495e12 / 3
TF32_MMA = "HMMA.1688.F32.TF32"   # mma.sync m16n8k8 TF32 in the SASS
POLICIES = ("static", "hotness", "write_bias", "stream", "hotness_global",
            "wear_level")


class Mismatch(AssertionError):
    pass


def cuda_device(torch):
    return torch.device("cuda", 0)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def wall_ms(torch, fn, iters: int) -> float:
    """Host-clock milliseconds per call of ``fn``, synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(torch, fn, iters: int, name: str | None = None) -> float:
    """Device milliseconds per call of ``fn``: see
    :func:`device_and_wall_ms`."""
    return device_and_wall_ms(torch, fn, iters, name)[0]


def trace_us(prof, match) -> tuple[float, int]:
    """(device microseconds, kernel launches) in a ``torch.profiler``
    trace, of the kernels whose names ``match`` accepts."""
    total, launches = 0.0, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t and match(ev.key):
            total += t
            launches += ev.count
    return total, launches


def device_and_wall_ms(torch, fn, iters: int, name: str | None = None
                       ) -> tuple[float, float]:
    """(device, host-clock) milliseconds per call of ``fn``, both from the
    same calls: the device time from a CUPTI trace (``torch.profiler``)
    of the kernels whose name contains ``name`` (every kernel when
    ``name`` is None), the wall time around those calls, synchronised.
    Falls back to CUDA events around the calls when the trace shows no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    total_us = trace_us(prof, lambda key: name is None or name in key)[0]
    if total_us > 0:
        return total_us / 1e3 / iters, wall
    print(f"  (no device time in the trace for {name or 'the call'}: "
          "timing with CUDA events)")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    return start.elapsed_time(end) / iters, wall


def device_ms_by_kernel(torch, fn, iters: int, names) -> dict:
    """{name: (device milliseconds per launch, launches in the trace)} of
    the kernels whose names contain each of ``names``, over ``iters``
    calls of ``fn`` (one CUPTI trace, ``torch.profiler``). The mean is over
    the launches that the trace holds, not over the calls made, so that a
    launch missing from the trace does not lower it; (0.0, 0) for a kernel
    the trace does not show."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for n in names:
        us, launches = trace_us(prof, lambda key, n=n: n in key)
        split[n] = (us / 1e3 / launches if launches else 0.0, launches)
    return split


def kernel_resources(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) of each entry function in a
    build log of ``nvcc -Xptxas -v``, template arguments shortened
    (``flash_wgmma_kernel<128>``, ``decode_split_kernel<bf16,1,4>``)."""
    import re
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            mangled = m.group(1)
            # The Itanium name's components are <length><identifier>; the
            # kernel's own name is the last of them.
            k = ([k for k in re.finditer(
                r"(?=(\d+)([A-Za-z_]\w*?_kernel))", mangled)
                if int(k.group(1)) == len(k.group(2))] or [None])[-1]
            if k is None:                     # an extern "C" or odd name
                name = mangled
                continue
            end = k.start() + len(k.group(1)) + len(k.group(2))
            t = re.match(r"I(\w*?)EE", mangled[end:])
            args = re.sub(r"^f", "fp32,", t.group(1) if t else "")
            args = args.replace("13__nv_bfloat16", "bf16,").replace(
                "Li", "").replace("E", ",").strip(",")
            name = f"{k.group(2)}<{args}>" if args else k.group(2)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def max_abs_diff(torch, a, b) -> int:
    if a.dtype == torch.bool:
        a, b = a.to(torch.int32), b.to(torch.int32)
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


# --------------------------------------------------------------- phase 3
LOOKUP_PAGES = 294_912       # the paper's table: 32,768 + 262,144 rows
CHUNK = 512                  # the main path's chunk; fused: + 2 swap rows


def lookup_table(torch, dev, b: int):
    """B random packed tables at the paper's geometry, made on the card."""
    g = torch.Generator(device=dev).manual_seed(b)
    return torch.randint(-2 ** 20, 2 ** 20, (b, LOOKUP_PAGES, 8),
                         generator=g, dtype=torch.int32, device=dev)


def lookup_pages(torch, dev, b: int, m: int, seed: int):
    """int32[B, m] pages with negative and past-the-end ones up front."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = torch.randint(0, LOOKUP_PAGES, (b, m), generator=g,
                          dtype=torch.int32, device=dev)
    pages[:, :4] = torch.tensor([-1, -LOOKUP_PAGES - 3, LOOKUP_PAGES, 2 ** 30],
                                dtype=torch.int32)
    return pages


def lookup_times(torch, table, rows_idx, kernel, plain, kernel_name: str,
                 label: str) -> tuple:
    """(kernel device ms, plain wall ms, advanced indexing device ms, the
    byte bound in ms) of one gather of ``rows_idx`` [B, r] (clamped row
    indices) from ``table``: r rows read, r rows written, r indices."""
    b, r = rows_idx.shape
    b_idx = torch.arange(b, device=table.device)[:, None].expand(b, r)
    k_ms = device_ms(torch, kernel, 200, kernel_name)
    p_ms = wall_ms(torch, plain, 200)
    lib_ms = device_ms(torch, lambda: table[b_idx, rows_idx], 200)
    byts = b * r * (32 + 32 + 4)
    print(f"    {label}: kernel {k_ms * 1e3:.2f} us (device), plain "
          f"{p_ms * 1e3:.2f} us (wall), advanced indexing "
          f"{lib_ms * 1e3:.2f} us (device), bound "
          f"{byts / HBM_BYTES_PER_S * 1e9:.2f} ns ({byts} B)")
    return k_ms, p_ms, lib_ms, byts / HBM_BYTES_PER_S * 1e3


def check_lookup(torch, dev, hl) -> dict:
    """Kernel A's two entries against their plain versions (torch.equal)
    at the paper's geometry: the unfused gather at B in {1, 4} x m in
    {512, 514} and B in {16, 64} x 514; the fused entry (the chunk's 512
    rows and the raw DMA pair, -1 idle, negative and past the end) at
    B in {1, 16, 64}, and at B = 16 with one chunk shared by every point
    (an expanded view). Times and bounds of each."""
    err = 0
    timing, fused = {}, {}
    for b, ms in ((1, (512, 514)), (4, (512, 514)), (16, (514,)),
                  (64, (514,))):
        table = lookup_table(torch, dev, b)
        for m in ms:
            pages = lookup_pages(torch, dev, b, m, seed=b * 1000 + m)
            got = hl.hmmu_lookup_cuda(table, pages)
            want = hl.hmmu_lookup_plain(table, pages)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            err = max(err, max_abs_diff(torch, got, want))
            print(f"  kernel A  B={b} m={m}: torch.equal={ok}")
            if not ok:
                raise Mismatch(f"hmmu_lookup differs at B={b} m={m}")
            idx = pages.to(torch.int64).clamp(0, LOOKUP_PAGES - 1)
            timing[(b, m)] = lookup_times(
                torch, table, idx, lambda: hl.hmmu_lookup_cuda(table, pages),
                lambda: hl.hmmu_lookup_plain(table, pages),
                "hmmu_lookup_kernel", f"B={b} m={m}")
        if b == 4:
            continue
        pages = lookup_pages(torch, dev, b, CHUNK, seed=b)
        regs = torch.randint(-3, LOOKUP_PAGES + 3, (2, b), dtype=torch.int32,
                             generator=torch.Generator(device=dev)
                             .manual_seed(7), device=dev)
        regs[:, 0] = torch.tensor([-1, LOOKUP_PAGES], dtype=torch.int32)
        if b > 1:
            regs[:, 1] = torch.tensor([-LOOKUP_PAGES - 1, -1],
                                      dtype=torch.int32)
        page_a, page_b = regs[0], regs[1]
        cases = [("", pages)]
        if b == 16:
            cases.append((" (one chunk shared, point stride 0)",
                          pages[:1].expand(b, -1)))
        for what, pg in cases:
            got = hl.hmmu_lookup_fused_cuda(table, pg, page_a, page_b)
            want = hl.hmmu_lookup_fused_plain(table, pg, page_a, page_b)
            torch.cuda.synchronize()
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            err = max([err] + [max_abs_diff(torch, g, w)
                               for g, w in zip(got, want)])
            print(f"  kernel A fused  B={b} x ({CHUNK} + 2) rows{what}: "
                  f"torch.equal={ok}")
            if not ok:
                raise Mismatch(f"hmmu_lookup_fused differs at B={b}{what}")
        idx = torch.cat([pages, regs.T.clamp_min(0)], dim=1).to(
            torch.int64).clamp(0, LOOKUP_PAGES - 1)
        fused[b] = lookup_times(
            torch, table, idx,
            lambda: hl.hmmu_lookup_fused_cuda(table, pages, page_a, page_b),
            lambda: hl.hmmu_lookup_fused_plain(table, pages, page_a, page_b),
            "hmmu_lookup_fused_kernel", f"fused B={b} x {CHUNK + 2} rows")
        del table
    return {"max_abs_err": err, "timing": timing, "fused": fused}


# --------------------------------------------------------------- phase 4
def adversarial_setup(torch, dev, rt, cfg, n_chunks, seed):
    """Pins, a poisoned page, a swap in flight; a trace hammering a few
    slow pages and the swap pair, with a few pages out of range; a plan of
    deaths and transients."""
    import numpy as np
    from repro_torch.core import table as tl
    params = cfg.runtime(dev)
    st = rt.core.init_state(cfg, params)
    nf = cfg.n_fast_pages
    tab = tl.set_flags(st.table, [0, 1], tl.PIN_FAST)
    tab = tl.set_flags(tab, [nf + 1], tl.PIN_SLOW)
    tab = tl.set_flags(tab, [nf + 3], tl.POISONED)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    st = st._replace(table=tab, dma=st.dma._replace(
        active=i32(1), page_a=i32(nf + 2), page_b=i32(nf - 1), start=i32(0)))
    rng = np.random.default_rng(seed)
    n = n_chunks * cfg.chunk
    page = np.where(rng.random(n) < 0.5, nf + rng.integers(0, 8, n),
                    rng.integers(0, cfg.n_pages, n)).astype(np.int32)
    page[rng.random(n) < 0.15] = nf + 2
    page[rng.random(n) < 0.1] = nf - 1
    # Pages past the table and negative ones (JAX's gather rules).
    page[rng.random(n) < 0.01] = cfg.n_pages + 3
    page[rng.random(n) < 0.01] = -2
    off = (rng.integers(0, cfg.page_size // 64, n) * 64).astype(np.int32)
    trace = rt.core.Trace(*(torch.as_tensor(x, device=dev) for x in (
        page, off, rng.random(n) < 0.5, np.full(n, 64, np.int32))))
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[-5:] = False
    plan = rt.core.seeded_plan(seed, pages=np.arange(nf, nf + 12),
                               n_chunks=n_chunks, n_deaths=2, n_transient=8,
                               device=dev)
    return params, st, trace, valid, plan


def scalars_of(cs, st):
    return cs.StepScalars(
        clock=st.clock, clock_ptr=st.clock_ptr, chunk_idx=st.chunk_idx,
        dma=st.dma, link_free_rx=st.link_free_rx,
        link_free_tx=st.link_free_tx, last_return=st.last_return,
        rescue_page=st.rescue_page, min_wear=st.min_wear,
        fault_cursor=st.fault_cursor)


def as_int(torch, x):
    return x.to(torch.int32) if x.dtype == torch.bool else x


def compare(torch, where, pairs) -> int:
    """Hold each (name, kernel value, plain value) equal, dtype and shape
    included; returns the max abs difference (0)."""
    err = 0
    for name, a, b in pairs:
        a, b = as_int(torch, a), as_int(torch, b)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise Mismatch(f"chunk_step differs from its plain version at "
                           f"{where}: {name}")
        err = max(err, max_abs_diff(torch, a, b))
    return err


def leaves(s, t, path="state"):
    """(path, a, b) for every tensor of two like NamedTuples."""
    if isinstance(s, tuple):
        for f in s._fields:
            yield from leaves(getattr(s, f), getattr(t, f), f"{path}.{f}")
    else:
        yield path, s, t


def compare_step(torch, where, got, want) -> int:
    """Compare (table, scalars, bank_free, outs) of one chunk of the
    kernel and of the plain version exactly."""
    kt, ksc, kbf, ko = got
    pt, psc, pbf, po = want
    return compare(torch, where, [
        ("table", kt, pt), ("bank_free", kbf, pbf),
        *leaves(ksc, psc, "scalars"),
        *(("outs." + k, ko[k], po[k]) for k in po)])


def compare_run(torch, where, got, want) -> int:
    """Compare (state, outs) of two whole runs exactly: the table, the
    scalars, the bank registers, the 16 counters and every output."""
    (ks, ko), (ps, po) = got, want
    return compare(torch, where, [
        *leaves(ks, ps), *(("outs." + k, ko[k], po[k]) for k in po)])


def kernel_args(torch, cs, points, trace, valid, plan) -> tuple:
    """``chunk_step_cuda``'s tensors, [B, ...] each, for the design points
    ``points`` ((params, state) pairs) running one trace and plan; the
    table is a stacked copy, which the launch updates."""
    def stack(xs):
        return torch.stack(xs).contiguous()

    def same(x):
        return stack([x.to(torch.int32)] * len(points))
    packed = [cs._pack_scalars(p, scalars_of(cs, st)) for p, st in points]
    ctrs = [cs.pack_counters(st.counters) for _, st in points]
    return (stack([st.table for _, st in points]),
            stack([p[0] for p in packed]), stack([p[1] for p in packed]),
            stack([st.bank_free for _, st in points]),
            *(same(x) for x in (*trace, valid)), same(plan.transient),
            same(plan.deaths), stack([c[0] for c in ctrs]),
            stack([c[1] for c in ctrs]))


def read_sum_max(torch, cfg, trace, valid, latency) -> int:
    """The largest integer sum of one chunk's read latencies: above 2^24
    a float32 sum of them is no longer exact in every order."""
    reads = (~trace.is_write & valid).reshape(-1, cfg.chunk)
    lat = latency.reshape(-1, cfg.chunk).to(torch.int64)
    return int(torch.where(reads, lat, 0).sum(dim=1).max())


def check_chunk_step(torch, dev, rt, cs) -> dict:
    from repro_torch.core.policies import PolicyRegistry
    reg = PolicyRegistry.snapshot()
    err = 0
    times = {}
    # "flash": the paper geometry with a flash slow tier, whose read
    # latencies sum past 2^24 within a chunk (the counters' exact sums).
    paper = rt.core.paper_platform().with_(chunk=512)
    geometries = (
        ("small", rt.core.small_platform(chunk=16)), ("paper", paper),
        ("flash", paper.with_(slow=rt.core.TECHNOLOGIES["flash"])))
    worst = 0
    for geom, base in geometries:
        for policy in POLICIES:
            cfg = base.with_(policy=policy, hot_threshold=2, decay_every=4,
                             endurance_budget=6, write_weight=3)
            n_chunks = 2 * cfg.decay_every + 3
            params, st, trace, valid, plan = adversarial_setup(
                torch, dev, rt, cfg, n_chunks, seed=len(policy))
            on = cfg.with_(chunk_step_kernel="on")
            k = (st.table.clone(), scalars_of(cs, st), st.bank_free.clone())
            p = (st.table.clone(), scalars_of(cs, st), st.bank_free.clone())
            retired = injected = 0
            k_s = p_s = 0.0
            for c in range(n_chunks):
                sl = slice(c * cfg.chunk, (c + 1) * cfg.chunk)
                args = [x[sl] for x in trace] + [valid[sl]]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                kt, ksc, kbf, ko = cs.chunk_step(on, reg, *k[:1], params,
                                                 k[1], k[2], *args, plan)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                pt, psc, pbf, po = cs.step_ref(cfg, reg, p[0], params, p[1],
                                               p[2], *args, plan, seq=True)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                k_s += t1 - t0
                p_s += t2 - t1
                err = max(err, compare_step(
                    torch, f"{geom}/{policy} chunk {c}",
                    (kt, ksc, kbf, ko), (pt, psc, pbf, po)))
                k, p = (kt, ksc, kbf), (pt, psc, pbf)
                retired += int(po["retired"]) >= 0
                injected += int(po["injected"].sum())
            # The same chunks in ONE launch, against the plain loop
            # (step_ref(seq=True) and counters.update per chunk).
            emu = rt.core.emulator
            cs.KERNEL.reset()
            k_run = emu._emulate_impl(on, reg, trace, valid,
                                      emu.clone_state(st), params, plan)
            torch.cuda.synchronize()
            if cs.KERNEL.launches != 1:
                raise Mismatch(f"{geom}/{policy}: {cs.KERNEL.launches} "
                               "launches for one run")
            p_run = emu._emulate_impl(cfg, reg, trace, valid,
                                      emu.clone_state(st), params, plan,
                                      seq=True)
            err = max(err, compare_run(torch, f"{geom}/{policy}, one launch",
                                       k_run, p_run))
            worst = max(worst, read_sum_max(torch, cfg, trace, valid,
                                            p_run[1]["latency"]))
            print(f"  kernel B  {geom:5s} {policy:14s} {n_chunks} chunks "
                  f"equal per chunk and in one launch; swaps "
                  f"{int(k[1].dma.swaps_done)}, retirements {retired}, "
                  f"injected {injected}; per chunk kernel "
                  f"{k_s / n_chunks * 1e3:.3f} ms, plain "
                  f"{p_s / n_chunks * 1e3:.3f} ms (wall)")
            if retired == 0 or injected == 0:
                raise Mismatch(f"{geom}/{policy}: the fault paths never fired")
            times[(geom, policy)] = (k_s / n_chunks, p_s / n_chunks)
    print(f"  kernel B  largest read-latency sum of a chunk in phase 4: "
          f"{worst} (2^24 = {2 ** 24})")
    if worst <= 2 ** 24:
        raise Mismatch("no phase-4 chunk summed its read latencies past "
                       "2^24")
    err = max(err, check_batched(torch, dev, rt, cs, reg))
    return {"max_abs_err": err, "times": times}


def check_batched(torch, dev, rt, cs, reg) -> int:
    """B = 2 design points with different params over all their chunks in
    ONE launch, each held against its own plain run."""
    emu = rt.core.emulator
    base = rt.core.paper_platform().with_(chunk=512, decay_every=4,
                                          endurance_budget=6)
    cfgs = [base.with_(policy="hotness", hot_threshold=2),
            base.with_(policy="wear_level", hot_threshold=3, wear_slack=8,
                       issue_gap=6)]
    n_chunks = 10
    setups = [adversarial_setup(torch, dev, rt, c, n_chunks, seed=11)
              for c in cfgs]
    _, _, trace, valid, plan = setups[0]
    args = kernel_args(torch, cs, [s[:2] for s in setups], trace, valid,
                       plan)
    cs.KERNEL.reset()
    out = cs.chunk_step_cuda(base, reg, *args)
    torch.cuda.synchronize()
    if cs.KERNEL.launches != 1:
        raise Mismatch(f"B=2: {cs.KERNEL.launches} launches")
    err = 0
    for b, ((params, st, *_), cfg) in enumerate(zip(setups, cfgs)):
        want = emu._emulate_impl(cfg, reg, trace, valid, emu.clone_state(st),
                                 params, plan, seq=True)
        got = (emu.kernel_state(args[0][b], out, b),
               emu.kernel_outs(base, out, valid, b))
        err = max(err, compare_run(torch, f"B=2 point {b}", got, want))
    print(f"  kernel B  B=2 (hotness, wear_level; different params) "
          f"{n_chunks} chunks in one launch: equal")
    return err


# --------------------------------------------------------------- phase 5
def run_main_path(torch, dev, rt, hl, cs) -> dict:
    from repro_torch.trace import workload_trace
    cfg = rt.paper_platform().with_(chunk=512, policy="hotness",
                                    hot_threshold=4)
    trace, _, n = workload_trace("520.omnetpp", scale=1e-4, device=dev)
    n_chunks = -(-n // cfg.chunk)
    print(f"  trace 520.omnetpp scale 1e-4: {n} requests, footprint "
          f"{int(trace.page.max()) + 1} pages, {n_chunks} chunks")
    results = {}
    for route, kernel in (("auto", cs.KERNEL), ("off", hl.KERNEL)):
        eng = rt.Engine(cfg.with_(chunk_step_kernel=route))
        torch.cuda.synchronize()
        hl.KERNEL.launches = 0
        cs.KERNEL.launches = 0
        t0 = time.perf_counter()
        res = eng.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"hmmu_lookup": hl.KERNEL.launches,
                  "chunk_step": cs.KERNEL.launches}
        summary = res.summary()
        print(f"  route {route!r}: launches {counts}; wall {wall:.3f} s, "
              f"{wall / n * 1e6:.4f} us/request; swaps "
              f"{int(res.state.dma.swaps_done)}")
        print(f"    counters {json.dumps(summary)}")
        want = 1 if route == "auto" else n_chunks
        if kernel.launches != want:
            raise Mismatch(f"route {route}: {kernel.name} launched "
                           f"{kernel.launches} times, not {want}")
        results[route] = (res, counts, wall)
    a, b = results["auto"][0], results["off"][0]
    for k in a.outs:
        if not torch.equal(a.outs[k], b.outs[k]):
            raise Mismatch(f"main path: outs[{k}] differs between routes")
    for path, x, y in leaves(a.state, b.state):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise Mismatch(f"main path: {path} differs between routes")
    check_outputs(torch, rt, cfg, a, n)
    print("  both routes: final states, counters and outputs bitwise equal")
    # A chunk's float32 sums are exact below 2^24, in any order.
    padded, valid = rt.core.pad_trace(cfg, trace)
    lat = torch.nn.functional.pad(a.outs["latency"], (0, len(valid) - n))
    print(f"  largest read-latency sum of a chunk: "
          f"{read_sum_max(torch, cfg, padded, valid, lat)} (2^24 = "
          f"{2 ** 24})")
    return {"cfg": cfg, "trace": trace, "n": n, "n_chunks": n_chunks,
            "results": results}


def check_outputs(torch, rt, cfg, res, n):
    """The repo's own means: shapes, ranges, counter totals, and the
    packed-table invariants."""
    o = res.outs
    for k in ("returns", "device", "latency"):
        if o[k].shape != (n,):
            raise Mismatch(f"outs[{k}] has shape {tuple(o[k].shape)}")
    if not bool(((o["device"] == 0) | (o["device"] == 1)).all()):
        raise Mismatch("a request reached no device")
    if not bool((o["latency"] > 0).all()):
        raise Mismatch("a request has no positive latency")
    c = res.state.counters
    total = int(c.reads_fast + c.writes_fast + c.reads_slow + c.writes_slow)
    if total != n:
        raise Mismatch(f"counters count {total} requests, not {n}")
    for f in ("bytes_read_fast", "sum_read_latency", "energy_pj"):
        if not bool(torch.isfinite(getattr(c, f))):
            raise Mismatch(f"counter {f} is not finite")
    rt.core.check_table(cfg, res.state.table)


def kernel_b_numbers(torch, dev, rt, cs, main) -> dict:
    """Kernel B on the whole main trace in one launch: its device time per
    chunk and the device's share of the wall time of the same
    ``Engine.run`` (three runs, traced: a launch under a profiler takes
    the stamped instantiation), the clock64() phase split and the times
    of the release and stamped instantiations (CUDA events, no profiler),
    one CTA per point against the cluster (same results, and their
    times), its plain version's wall time per chunk, and its byte bound.
    The measurement options go to ``chunk_step_cuda`` directly."""
    from repro_torch.core.policies import PolicyRegistry
    emu = rt.core.emulator
    cfg, n_chunks = main["cfg"], main["n_chunks"]
    on = cfg.with_(chunk_step_kernel="on")
    eng = rt.Engine(on)
    reg = PolicyRegistry.snapshot()
    trace, valid = rt.core.pad_trace(cfg, main["trace"])
    plan = rt.core.FaultPlan.empty(device=dev)

    def launch(**kw):
        args = kernel_args(torch, cs, [(eng.params, eng.init_state())],
                           trace, valid, plan)
        out = cs.chunk_step_cuda(on, reg, *args, **kw)
        return emu.kernel_state(args[0][0], out), emu.kernel_outs(on, out,
                                                                  valid)

    def kernel_ms(**kw) -> float:
        """Kernel B's device time, CUDA events around the launch alone:
        a spin ahead of it keeps the device busy while the host enqueues,
        so the start event passes only as the kernel starts."""
        args = kernel_args(torch, cs, [(eng.params, eng.init_state())],
                           trace, valid, plan)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start.record()
        cs.chunk_step_cuda(on, reg, *args, **kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    runs = [device_and_wall_ms(torch, lambda: eng.run(main["trace"]), 1,
                               "chunk_step_kernel") for _ in range(3)]
    k_ms, wall_ms = sorted(runs)[1]
    k_ms /= n_chunks
    print(f"  kernel B over the {n_chunks} main-path chunks in one launch "
          f"(three Engine.run calls, each traced, so stamped): " + "; ".join(
              f"{d / n_chunks * 1e3:.3f} us/chunk, {d:.2f} of {w:.2f} ms "
              f"wall, a device share of {d / w:.3f}" for d, w in runs))
    stamped = torch.zeros(1, len(cs.PHASES), dtype=torch.int64, device=dev)
    rel, stamp = [], []
    for _ in range(3):
        rel.append(kernel_ms() / n_chunks)
        stamp.append(kernel_ms(phases=stamped.zero_()) / n_chunks)
    rel_ms, stamped_ms = sorted(rel)[1], sorted(stamp)[1]
    cyc = stamped[0].tolist()
    tot = sum(cyc)
    print("  kernel B phase split (stamped instantiation, clock64 on the "
          "leader's thread 0, share of the cycles; us/chunk at the release "
          "instantiation's device time): " + ", ".join(
              f"{nm} {c / tot:.3f} ({c / tot * rel_ms * 1e3:.2f})"
              for nm, c in zip(cs.PHASES, cyc)))
    print(f"  kernel B stamped instantiation {stamped_ms * 1e3:.3f} us/chunk, "
          f"release {rel_ms * 1e3:.3f} us/chunk (device, CUDA events, median "
          f"of three calls each, same inputs)")
    one_ms = device_ms(torch, lambda: launch(cluster=1), 1,
                       "chunk_step_kernel") / n_chunks
    a, b = launch(), launch(cluster=1)
    for name, x, y in [*leaves(a[0], b[0]),
                       *((k, a[1][k], b[1][k]) for k in a[1])]:
        if not torch.equal(x, y):
            raise Mismatch(f"kernel B with one CTA per point differs: {name}")
    print(f"  kernel B with one CTA per point (no cluster): "
          f"{one_ms * 1e3:.3f} us/chunk (device), results equal")
    # The plain version: step_ref(seq=True) and counters.update per chunk.
    n_plain = 16
    m = n_plain * cfg.chunk
    sub = rt.core.Trace(*(x[:m] for x in trace))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emu._emulate_impl(cfg, reg, sub, valid[:m], eng.init_state(),
                      eng.params, seq=True)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3 / n_plain
    # Bytes the step must move per chunk: the request vectors in (5 x 4 B)
    # and out (5 x 4 B), one 32 B row read and one 4 B HOTNESS word
    # written per distinct page, a 4 B WEAR word per distinct slow frame
    # written (bounded by the writes), and on decay chunks the whole
    # HOTNESS lane read and written plus the slow WEAR lane read.
    pg = trace.page.reshape(n_chunks, cfg.chunk).sort(dim=1).values
    uniq = 1 + (pg[:, 1:] != pg[:, :-1]).sum(dim=1)
    writes = (trace.is_write & valid).reshape(n_chunks, cfg.chunk).sum(dim=1)
    n_decay = sum(c % cfg.decay_every == cfg.decay_every - 1
                  for c in range(n_chunks))
    byts = int(n_chunks * cfg.chunk * 40 + (uniq * 36).sum()
               + torch.minimum(writes, uniq).sum() * 4) + \
        n_decay * (cfg.n_pages * 8 + cfg.n_slow_pages * 4)
    bound_ms = byts / n_chunks / HBM_BYTES_PER_S * 1e3
    print(f"  kernel B plain version {p_ms:.3f} ms/chunk (wall, {n_plain} "
          f"chunks); bound {bound_ms * 1e6:.1f} ns/chunk "
          f"({byts / n_chunks:.0f} B)")
    return {"ms": rel_ms, "plain_ms": p_ms, "bound_ms": bound_ms}


def kernel_a_main_ms(torch, rt, hl, main, n_chunks=256) -> float:
    """Kernel A's device time per launch on the scan path's real
    inputs (the first chunks of the main trace)."""
    cfg, trace = main["cfg"], main["trace"]
    n_chunks = min(n_chunks, len(trace) // cfg.chunk)
    sub = rt.core.Trace(*(x[:n_chunks * cfg.chunk] for x in trace))
    eng = rt.Engine(cfg.with_(chunk_step_kernel="off"))
    name = "hmmu_lookup_fused_kernel"
    ms, traced = device_ms_by_kernel(torch, lambda: eng.run(sub), 1,
                                     (name,))[name]
    if not traced:
        ms = device_ms(torch, lambda: eng.run(sub), 1, name) / n_chunks
    print(f"  kernel A on the first {n_chunks} main-path chunks: "
          f"{ms * 1e3:.2f} us/launch (device; {traced} of {n_chunks} "
          "launches traced)")
    return ms


# --------------------------------------------------------------- phase 7
def sweep_grid(rt):
    """The paper's platform (Table II, nothing cut) and the repo's 16-point
    Fig 8 grid (``benchmarks/bench_sweep.py``): technologies x fast-tier
    shares x policies x link latencies."""
    from repro_torch.sweep import SweepSpec
    base = rt.paper_platform().with_(chunk=512, hot_threshold=4,
                                     decay_every=32, write_weight=4)
    return base, SweepSpec(base, technologies=("3dxpoint", "stt-ram"),
                           fast_fractions=(1 / 9, 2 / 9),
                           policies=("hotness", "static"),
                           link_lats=(600, 1200))


def sweep_trace(torch, dev, rt):
    """Phase 7's trace: ``505.mcf`` (Table III: 602 MB, 154,112 pages of
    4 KiB, past both of the grid's fast tiers, 32,768 and 65,536 pages, and
    inside the 294,912-row table) at scale 1e-5, 970,662 requests. Phase
    5's ``520.omnetpp`` touches 61,696 pages, all of them DRAM at 2/9."""
    from repro_torch.trace import workload_trace
    trace, _, n = workload_trace("505.mcf", scale=1e-5, device=dev)
    print(f"  trace 505.mcf scale 1e-5: {n} requests, footprint "
          f"{int(trace.page.max()) + 1} pages", flush=True)
    return trace


def same_runs(torch, where, got, want) -> None:
    """Hold two (state, outs) pairs bitwise equal; raise at the first
    field that differs."""
    (gs, go), (ws, wo) = got, want
    for name, a, b in [*leaves(gs, ws),
                       *(("outs." + k, go[k], wo[k]) for k in wo)]:
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise Mismatch(f"sweep: {where}: {name} differs")


def check_sweep(torch, dev, rt, hl, cs, base, spec, trace, off_chunks=64,
                plain_chunks=40) -> dict:
    """Every check of phase 7 (see the module docstring); returns the
    first sweep's wall, launches and peak device memory."""
    import dataclasses
    from repro_torch.sweep import build_points
    from repro_torch.engine import stack_params
    point_of = rt.core.emulator._index
    points = build_points(spec)
    n, chunk = len(trace), base.chunk
    eng = rt.Engine(base)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    hl.KERNEL.launches = 0
    cs.KERNEL.launches = 0
    t0 = time.perf_counter()
    res = eng.sweep(spec, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"hmmu_lookup": hl.KERNEL.launches,
              "chunk_step": cs.KERNEL.launches}
    peak = torch.cuda.max_memory_allocated() - before
    n_pad = res.outs["returns"].shape[1]
    print(f"  Engine.sweep of {len(points)} points over {n} requests "
          f"({n_pad // chunk} chunks): launches {counts}; wall {wall:.3f} s "
          f"(first call); registry {res.registry.names}; tables "
          f"{res.states.table.numel() * 4} B, trace copied a point "
          f"{5 * 4 * n_pad * len(points)} B; peak device memory {peak} B "
          "above what was allocated before the call",
          flush=True)
    if counts != {"hmmu_lookup": 0, "chunk_step": 1}:
        raise Mismatch(f"sweep: launches {counts}, not one of kernel B")
    for i, p in enumerate(points):
        want = eng.run(trace, params=p.params(dev))
        same_runs(torch, f"point {i} ({p.label}) against its Engine.run",
                  (point_of(res.states, i),
                   {k: v[i, :n] for k, v in res.outs.items()}), want)
        check_outputs(torch, rt, p.cfg, want, n)
    for p, row in zip(points, res.rows()):
        print(f"    {row['label']}: AMAT {row['amat_cyc']:.3f} cycles, fast "
              f"hits {row['fast_hit_rate']:.4f}, swaps {row['swaps']}, "
              f"NVM peak wear {row['nvm_peak_wear']}, energy "
              f"{row['energy_mJ']:.4f} mJ")
        if row["fast_hit_rate"] >= 1 or (p.cfg.policy == "hotness"
                                         and row["swaps"] == 0):
            raise Mismatch(f"sweep: {row['label']} never reaches its slow "
                           "tier or never migrates: the trace does not "
                           "exercise its parameters")
    print(f"  each of the {len(points)} points bitwise equal to its own "
          "Engine.run (state, counters, outputs)", flush=True)
    # The continuation: the first half, then the rest from its states.
    half = (n // chunk // 2) * chunk
    first = eng.sweep(spec, rt.core.Trace(*(x[:half] for x in trace)))
    cont = eng.continue_sweep(first, rt.core.Trace(*(x[half:]
                                                     for x in trace)))
    same_runs(torch, "continue_sweep against the whole sweep",
              # reprolint: allow[donation] the first half's outputs only
              (cont.states, {k: torch.cat([first.outs[k], cont.outs[k]],
                                          dim=1) for k in res.outs}),
              (res.states, res.outs))
    print(f"  continue_sweep over requests {half}..{n} after a sweep of the "
          "first half: equal to the one sweep", flush=True)
    del res, first, cont
    # The "off" route (one chunk loop for every point, kernel A's fused
    # entry once a chunk) at reduced depth, against "auto" on the same
    # chunks.
    m = off_chunks * chunk
    sub = rt.core.Trace(*(x[:m] for x in trace))
    off = base.with_(chunk_step_kernel="off")
    off_spec = dataclasses.replace(spec, base=off)
    hl.KERNEL.launches = 0
    cs.KERNEL.launches = 0
    t0 = time.perf_counter()
    got = rt.Engine(off).sweep(off_spec, sub)
    torch.cuda.synchronize()
    off_wall = time.perf_counter() - t0
    off_counts = {"hmmu_lookup": hl.KERNEL.launches,
                  "chunk_step": cs.KERNEL.launches}
    if off_counts != {"hmmu_lookup": off_chunks, "chunk_step": 0}:
        raise Mismatch(f"sweep on 'off': launches {off_counts}, not one of "
                       f"kernel A a chunk ({off_chunks})")
    want = eng.sweep(spec, sub)
    same_runs(torch, f"'off' against 'auto' over {off_chunks} chunks",
              (got.states, got.outs), (want.states, want.outs))
    del got, want
    a_ms, traced = device_ms_by_kernel(
        torch, lambda: rt.Engine(off).sweep(off_spec, sub), 1,
        ("hmmu_lookup_fused_kernel",))["hmmu_lookup_fused_kernel"]
    print(f"  route 'off' over the first {off_chunks} chunks of "
          f"{len(points)} points: launches {off_counts}, wall "
          f"{off_wall:.3f} s; equal to 'auto'; kernel A "
          f"{a_ms * 1e3:.2f} us/launch (device; {traced} of {off_chunks} "
          "launches traced)", flush=True)
    # Every grid point, over a registry subset (the grid's, hotness before
    # static, then write_bias), and one more point with a policy_id past
    # the subset's end (the clamped policy, write_bias, without its write
    # weighting): one launch, each point against the plain loop at its own
    # parameters.
    names = ("hotness", "static", "write_bias")
    sub_eng = rt.Engine(base, registry=names)
    picks = [*points, points[0]]
    ids = [names.index(p.cfg.policy) for p in points] + [7]
    params = stack_params(picks, dev)._replace(policy_id=torch.tensor(
        ids, dtype=torch.int32, device=dev))
    m = plain_chunks * chunk
    sub = rt.core.Trace(*(x[:m] for x in trace))
    cs.KERNEL.launches = 0
    got = sub_eng.sweep(params, sub)
    torch.cuda.synchronize()
    if cs.KERNEL.launches != 1:
        raise Mismatch(f"registry subset: {cs.KERNEL.launches} launches")
    emu = rt.core.emulator
    ones = torch.ones(m, dtype=torch.bool, device=dev)
    for i, p in enumerate(picks):
        pp = point_of(params, i)
        want = emu._emulate_impl(base, sub_eng.registry, sub, ones,
                                 rt.core.init_state(base, pp), pp, seq=True)
        same_runs(torch, f"point {i} ({p.label}), registry {names}, "
                  f"policy_id {int(pp.policy_id)}, against its plain run",
                  (point_of(got.states, i),
                   {k: v[i] for k, v in got.outs.items()}), want)
    print(f"  registry {names}: the {len(points)} grid points (policy_ids "
          f"{ids[:-1]}) and policy_id 7 past its end, in one launch over "
          f"{plain_chunks} chunks: each equal to its plain run "
          "(step_ref(seq=True))", flush=True)
    return {"wall": wall, "counts": counts, "peak": peak, "n_pad": n_pad}


def sweep_numbers(torch, rt, base, spec, trace, card: str) -> dict:
    """Kernel B's device time for one ``Engine.sweep`` (CUPTI) and the wall
    of the same call: three traced calls at B = 16, one at B = 1 and B = 64
    (64: ``extra_axes`` of four ``hot_threshold`` values)."""
    import dataclasses
    from repro_torch.sweep import build_points
    eng = rt.Engine(base)
    n = len(trace)
    n_chunks = -(-n // base.chunk)
    spec64 = dataclasses.replace(
        spec, extra_axes=(("hot_threshold", (2, 4, 8, 16)),))
    out = {}
    for b, grid in ((1, build_points(spec)[:1]), (16, spec), (64, spec64)):
        runs = [device_and_wall_ms(torch, lambda: eng.sweep(grid, trace), 1,
                                   "chunk_step_kernel")
                for _ in range(3 if b == 16 else 1)]
        k_ms, w_ms = sorted(runs)[len(runs) // 2]
        out[b] = (k_ms, w_ms)
        print(f"  B={b}: kernel B {k_ms:.3f} ms for the launch "
              f"({k_ms / n_chunks * 1e3:.3f} us/chunk), "
              f"{k_ms * 1e3 / (b * n):.5f} us per point-request (device); "
              f"Engine.sweep wall {w_ms / 1e3:.4f} s, "
              f"{w_ms * 1e3 / (b * n):.5f} us per point-request, device "
              f"share {k_ms / w_ms:.3f}" + (
                  "; calls: " + ", ".join(f"{d:.3f} of {w:.3f} ms"
                                         for d, w in runs)
                  if len(runs) > 1 else "") + f" [{card}]", flush=True)
    return out


# --------------------------------------------------------------- phase 8
# The three serving profiles of ``benchmarks/bench_serve.py:55-87``
# (``PROFILES``), as ``BENCH_serve.json``'s ``config`` records them, and
# the workload of ``_workload`` (``benchmarks/bench_serve.py:93-99``):
# ``default_rng(0)``, prompts of 1-4 pages at p = 0.6 / 0.2 / 0.1 / 0.1,
# decode lengths in [decode_lo, decode_hi).
_QUICK_SERVE = dict(
    sorted_batch_sizes=(1024, 2048, 4096), max_live_seqs=5_000,
    max_live_batches=2, max_admit_per_step=512, pin_pages_per_seq=1,
    max_pages_per_seq=6, positions_per_page=16, window_pages=2,
    prefill_writes_per_page=2, free_low_frac=0.28, free_high_frac=0.32,
    slo_latency_us=5_000.0, pinned_slo=0.90)
SERVE_PROFILES = {
    "full": dict(
        geometry=dict(n_fast_pages=131072, n_slow_pages=163840, chunk=512),
        serve=dict(sorted_batch_sizes=(8192, 16384, 32768),
                   max_live_seqs=100_000, max_live_batches=2,
                   max_admit_per_step=4096, pin_pages_per_seq=1,
                   max_pages_per_seq=6, positions_per_page=64,
                   window_pages=2, prefill_writes_per_page=2,
                   free_low_frac=0.15, free_high_frac=0.18,
                   slo_latency_us=120_000.0, pinned_slo=0.90),
        n_seqs=110_000, decode_lo=8, decode_hi=41, min_live=100_000,
        metrics="metrics"),
    "quick": dict(
        geometry=dict(n_fast_pages=8192, n_slow_pages=10240, chunk=256),
        serve=_QUICK_SERVE, n_seqs=6_000, decode_lo=8, decode_hi=25,
        min_live=5_000, metrics="quick_metrics"),
    # quick, plus a seeded fault plan killing 5% of the fast tier's frames
    # over 1,100 chunks.
    "degraded": dict(
        geometry=dict(n_fast_pages=8192, n_slow_pages=10240, chunk=256),
        serve=_QUICK_SERVE, n_seqs=6_000, decode_lo=8, decode_hi=25,
        min_live=5_000, metrics="degraded_metrics",
        faults=dict(seed=20, fast_frac=0.05, n_chunks=1100)),
}
# The fields of a profile's metrics that are not emulated (host clock).
SERVE_WALL_FIELDS = ("warmup_s", "wall_s", "req_per_s")


def serve_bench() -> dict:
    return json.loads((ROOT / "BENCH_serve.json").read_text())


def serve_workload(n_seqs: int, lo: int, hi: int, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    prompt = rng.choice([1, 2, 3, 4], size=n_seqs, p=[0.6, 0.2, 0.1, 0.1])
    decode = rng.integers(lo, hi, size=n_seqs)
    return prompt.astype(np.int32), decode.astype(np.int32)


def serve_run(torch, dev, rt, hl, cs, name: str, route: str = "auto",
              trace_kernel: bool = False, on_start=None, **overrides
              ) -> dict:
    """One profile through the port's entry points: ``Engine`` on
    ``paper_platform().with_(**geometry)``, ``warmup``, then (launch counts
    and dispatch keys taken just before) ``submit`` and ``run``.
    ``trace_kernel`` traces the run (CUPTI) for kernel B's device time and
    counts the host synchronisations that PyTorch's sync debug mode sees
    in it. ``on_start`` is called just before ``submit``."""
    import numpy as np
    from repro_torch.serve import ContinuousBatchingScheduler, ServeConfig
    prof = SERVE_PROFILES[name]
    cfg = rt.paper_platform().with_(chunk_step_kernel=route,
                                    **prof["geometry"])
    kw = dict(prof["serve"], **overrides)
    if prof.get("faults"):
        f, nf = prof["faults"], cfg.n_fast_pages
        kw["faults"] = rt.core.seeded_plan(
            f["seed"], pages=np.arange(nf), n_chunks=f["n_chunks"],
            n_deaths=int(f["fast_frac"] * nf))
    eng = rt.Engine(cfg, device=dev)
    sched = ContinuousBatchingScheduler(eng, ServeConfig(**kw))
    t0 = time.perf_counter()
    sched.warmup()
    warm = time.perf_counter() - t0
    prompt, decode = serve_workload(prof["n_seqs"], prof["decode_lo"],
                                    prof["decode_hi"])
    keys0 = eng.compile_count
    torch.cuda.synchronize()
    hl.KERNEL.launches = 0
    cs.KERNEL.launches = 0
    prof_ctx = None
    if trace_kernel:
        import warnings
        from torch.profiler import ProfilerActivity, profile
        prof_ctx = profile(activities=[ProfilerActivity.CUDA])
        prof_ctx.__enter__()
        syncs = warnings.catch_warnings(record=True)
        seen = syncs.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
    if on_start is not None:
        on_start()
    try:
        t0 = time.perf_counter()
        sched.submit(prompt, decode)
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if prof_ctx is not None:
            torch.cuda.set_sync_debug_mode(0)
            syncs.__exit__(None, None, None)
            prof_ctx.__exit__(None, None, None)
    out = {"sched": sched, "cfg": cfg, "report": sched.report(),
           "warmup_s": warm, "wall_s": wall,
           "recompiles": eng.compile_count - keys0,
           "launches": {"hmmu_lookup": hl.KERNEL.launches,
                        "chunk_step": cs.KERNEL.launches}}
    if prof_ctx is not None:
        out["kernel_b_us"] = trace_us(prof_ctx,
                                      lambda k: "chunk_step_kernel" in k)
        out["syncs"] = sum("synchronizing" in str(w.message) for w in seen)
    return out


def serve_host_split(torch, dev, rt, hl, cs, name: str = "full") -> dict:
    """Where the host's wall goes in one run of the profile (a separate,
    unchecked run): seconds inside ``Engine.run``, the trace's copy to the
    card, the outputs' copy enqueue, harvest (waiting on a dispatch's copy
    and unpacking it), the pin contracts, and the rest (the scheduler's
    numpy work), by wrapping those calls with a host clock."""
    from repro_torch.serve import contracts, scheduler, staging
    acc = dict.fromkeys(("Engine.run", "trace copy", "output copy enqueue",
                         "harvest wait + unpack", "contracts"), 0.0)

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t0
        return wrapper
    saved = {(scheduler, n): getattr(scheduler, n) for n in
             ("to_device", "stamp_pin_pages", "release_pin_pages")}
    saved[(staging.Fetch, "__init__")] = staging.Fetch.__init__
    saved[(staging.Fetch, "get")] = staging.Fetch.get
    run_fn = rt.Engine.run
    try:
        scheduler.to_device = timed(saved[(scheduler, "to_device")],
                                    "trace copy")
        for n in ("stamp_pin_pages", "release_pin_pages"):
            setattr(scheduler, n, timed(getattr(contracts, n), "contracts"))
        staging.Fetch.__init__ = timed(saved[(staging.Fetch, "__init__")],
                                       "output copy enqueue")
        staging.Fetch.get = timed(saved[(staging.Fetch, "get")],
                                  "harvest wait + unpack")
        rt.Engine.run = timed(run_fn, "Engine.run")
        run = serve_run(torch, dev, rt, hl, cs, name, on_start=lambda: (
            acc.update(dict.fromkeys(acc, 0.0))))
    finally:
        rt.Engine.run = run_fn
        for (obj, n), fn in saved.items():
            setattr(obj, n, fn)
    acc["the rest (numpy scheduling)"] = run["wall_s"] - sum(acc.values())
    return {"wall_s": run["wall_s"], "split": acc}


def serve_metrics(run: dict) -> dict:
    """The profile's metrics as ``benchmarks/bench_serve.py`` builds them
    (without its wall-clock fields)."""
    rep = run["report"]
    m = {f: getattr(rep, f) for f in (
        "n_sequences", "n_mem_requests", "n_dispatches",
        "live_seqs_high_water", "inflight_high_water", "p50_latency_us",
        "p99_latency_us", "mean_latency_us", "slo_latency_us",
        "slo_attainment", "pinned_accesses", "pinned_fast_hit_rate",
        "evictions", "refetches", "frames_retired", "fault_refetches",
        "renegotiations")}
    m["recompiles_after_warmup"] = run["recompiles"]
    return m


def check_serve_metrics(name: str, route: str, run: dict, bench: dict,
                        cases: bool = False) -> None:
    """Every emulated field of ``BENCH_serve.json``'s metrics of the
    profile (and, with ``cases``, every row of its per-bucket ``cases``)
    equal to the port's report: floats exactly."""
    want = {k: v for k, v in bench[SERVE_PROFILES[name]["metrics"]].items()
            if k not in SERVE_WALL_FIELDS}
    got = serve_metrics(run)
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if set(got) != set(want):
        bad["fields"] = (sorted(got), sorted(want))
    if cases:
        per = run["report"].per_bucket
        rows = {r["size"]: {k: v for k, v in r.items() if k != "size"}
                for r in bench["cases"]}
        if set(per) != set(rows):
            bad["buckets"] = (sorted(per), sorted(rows))
        for size, row in rows.items():
            for k, v in row.items():
                if per.get(size, {}).get(k) != v:
                    bad[f"cases[{size}].{k}"] = (per.get(size, {}).get(k), v)
    if bad:
        raise Mismatch(f"serve {name} on {route!r} differs from "
                       f"BENCH_serve.json: {bad}")
    if run["report"].live_seqs_high_water < SERVE_PROFILES[name]["min_live"]:
        raise Mismatch(f"serve {name}: only "
                       f"{run['report'].live_seqs_high_water} live sequences")


def same_serve(torch, where: str, a, b) -> None:
    """Two schedulers' outs_log, trace_log and final carry bitwise equal."""
    import numpy as np
    if a.dispatch_log != b.dispatch_log:
        raise Mismatch(f"serve {where}: dispatch logs differ")
    for i, (x, y) in enumerate(zip(a.trace_log, b.trace_log, strict=True)):
        for name, u, v in leaves(x, y, f"trace_log[{i}]"):
            if not torch.equal(u, v):
                raise Mismatch(f"serve {where}: {name} differs")
    for i, (x, y) in enumerate(zip(a.outs_log, b.outs_log, strict=True)):
        for k in y:
            if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k]):
                raise Mismatch(f"serve {where}: outs_log[{i}][{k}] differs")
    for name, u, v in leaves(a.carry, b.carry, "carry"):
        if u.dtype != v.dtype or not torch.equal(u, v.to(u.device)):
            raise Mismatch(f"serve {where}: {name} differs")


def serve_launch_check(name: str, route: str, run: dict) -> None:
    rep = run["report"]
    n_chunks = sum(s for s, _ in run["sched"].dispatch_log) // \
        run["cfg"].chunk
    want = ({"hmmu_lookup": 0, "chunk_step": rep.n_dispatches}
            if route == "auto" else
            {"hmmu_lookup": n_chunks, "chunk_step": 0})
    if run["launches"] != want:
        raise Mismatch(f"serve {name} on {route!r}: launches "
                       f"{run['launches']}, not {want}")
    if run["recompiles"]:
        raise Mismatch(f"serve {name} on {route!r}: {run['recompiles']} new "
                       "dispatch keys after warmup")


def check_serve_full(torch, dev, rt, hl, cs, bench: dict, card: str) -> dict:
    """The ``full`` profile on ``"auto"`` (traced), held to
    ``BENCH_serve.json``'s metrics and cases; then the same run at
    ``max_live_batches=1``, whose results must be equal."""
    run = serve_run(torch, dev, rt, hl, cs, "full", trace_kernel=True)
    rep = run["report"]
    check_serve_metrics("full", "auto", run, bench, cases=True)
    serve_launch_check("full", "auto", run)
    k_us, k_n = run["kernel_b_us"]
    wall = run["wall_s"]
    print(f"  full profile on 'auto': {rep.n_sequences} sequences (peak "
          f"{rep.live_seqs_high_water} live), {rep.n_mem_requests} requests "
          f"in {rep.n_dispatches} dispatches ({rep.n_steps} steps): every "
          f"emulated field of BENCH_serve.json's metrics and of its "
          f"{len(bench['cases'])} per-bucket cases equal; launches "
          f"{run['launches']}; dispatch keys after warmup "
          f"{run['recompiles']}; compile_count {rep.compile_count}",
          flush=True)
    print(f"  full profile wall {wall:.3f} s (warmup {run['warmup_s']:.3f} "
          f"s), {rep.n_mem_requests / wall:,.0f} emulated requests per "
          f"second of wall; kernel B {k_us / 1e3:.3f} ms device over "
          f"{k_n} launches traced ({k_us / max(k_n, 1):.1f} us a launch), "
          f"a device share of {k_us / 1e6 / wall:.4f}; in-flight high water "
          f"{rep.inflight_high_water}; host synchronisations seen in the "
          f"run {run['syncs']}; p50 / p99 {rep.p50_latency_us} / "
          f"{rep.p99_latency_us} emulated us [{card}]", flush=True)
    one = serve_run(torch, dev, rt, hl, cs, "full", trace_kernel=True,
                    max_live_batches=1)
    a = dict(serve_metrics(run), per_bucket=rep.per_bucket)
    b = dict(serve_metrics(one), per_bucket=one["report"].per_bucket)
    a.pop("inflight_high_water"), b.pop("inflight_high_water")
    if a != b or one["report"].inflight_high_water != 1:
        raise Mismatch("serve full at max_live_batches=1 differs")
    same_serve(torch, "full, max_live_batches 2 against 1", run["sched"],
               one["sched"])
    k1 = one["kernel_b_us"][0]
    print(f"  full profile at max_live_batches=1: wall "
          f"{one['wall_s']:.3f} s (warmup {one['warmup_s']:.3f} s), "
          f"{one['report'].n_mem_requests / one['wall_s']:,.0f} requests/s, "
          f"kernel B device share {k1 / 1e6 / one['wall_s']:.4f}; results "
          f"and final state equal to max_live_batches=2 [{card}]",
          flush=True)
    host = serve_host_split(torch, dev, rt, hl, cs)
    print(f"  full profile, a third (unchecked) run: wall "
          f"{host['wall_s']:.3f} s, of it on the host: " + ", ".join(
              f"{k} {v:.3f} s" for k, v in host["split"].items()) +
          f" [{card}]", flush=True)
    return {"launches": run["launches"]["chunk_step"], "wall_s": wall,
            "kernel_b_ms": k_us / 1e3}


def check_serve_routes(torch, dev, rt, hl, cs, bench: dict) -> dict:
    """``quick`` and ``degraded`` on ``"auto"`` and ``"off"``: each equal
    to its metrics in ``BENCH_serve.json``, the two routes bitwise equal
    on the outs and trace logs and the final state; ``degraded`` retires
    frames and refetches across its dispatches."""
    a_launches = 0
    for name in ("quick", "degraded"):
        runs = {}
        for route in ("auto", "off"):
            run = serve_run(torch, dev, rt, hl, cs, name, route,
                            record_traces=True)
            check_serve_metrics(name, route, run, bench)
            serve_launch_check(name, route, run)
            rep = run["report"]
            print(f"  {name} on {route!r}: {rep.n_mem_requests} requests in "
                  f"{rep.n_dispatches} dispatches, launches "
                  f"{run['launches']}, wall {run['wall_s']:.3f} s; equal to "
                  f"BENCH_serve.json's {SERVE_PROFILES[name]['metrics']}"
                  + (f" ({rep.frames_retired} frames retired, "
                     f"{rep.fault_refetches} fault refetches, pinned "
                     f"fast-hit {rep.pinned_fast_hit_rate})"
                     if rep.frames_retired else ""), flush=True)
            runs[route] = run
        if name == "quick":
            a_launches = runs["off"]["launches"]["hmmu_lookup"]
        same_serve(torch, f"{name}, 'auto' against 'off'",
                   runs["auto"]["sched"], runs["off"]["sched"])
        print(f"  {name}: the two routes bitwise equal (outs_log, "
              f"trace_log, final carry)", flush=True)
        del runs
    return {"off_launches": a_launches}


def check_serve_replay(torch, dev, rt, hl, cs) -> None:
    """``quick`` with no pin contracts, recorded, against
    ``Engine.run_stream`` over its trace log on a fresh engine at prefetch
    0 and 2 (``tests/test_serve.py:113-127`` at profile size): every
    output equal. The scheduled run's last dispatch pads its tail to a
    bucket, past the one chunk ``run_stream`` pads it to; the final state
    equals the replay's continued over those all-invalid chunks (as in
    the JAX package)."""
    import numpy as np
    run = serve_run(torch, dev, rt, hl, cs, "quick", pin_pages_per_seq=0,
                    record_traces=True)
    sched, chunk = run["sched"], run["cfg"].chunk
    padded = [(s, n) for s, n in sched.dispatch_log if n < s]
    if padded != sched.dispatch_log[-1:]:
        raise Mismatch(f"quick without pins: padded dispatches {padded}; "
                       "only the last may be padded for the replay")
    size, n_valid = padded[0] if padded else (0, 0)
    extra = size - -(-n_valid // chunk) * chunk
    got = {k: np.concatenate([o[k] for o in sched.outs_log])
           for k in sched.outs_log[0]}
    for prefetch in (0, 2):
        eng = rt.Engine(run["cfg"], device=dev)
        t0 = time.perf_counter()
        rep = eng.run_stream(iter(sched.trace_log), prefetch=prefetch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, v in got.items():
            if not np.array_equal(v, rep.outs[k].cpu().numpy()):
                raise Mismatch(f"run_stream replay (prefetch {prefetch}): "
                               f"outs[{k}] differs")
        state = rep.state
        if extra:
            z = torch.zeros(extra, dtype=torch.int32, device=dev)
            state = eng.run(rt.core.Trace(z, z, z.bool(), z), state=state,
                            valid=z.bool()).state
        for name, u, v in leaves(sched.carry, state, "state"):
            if not torch.equal(u, v):
                raise Mismatch(f"run_stream replay (prefetch {prefetch}): "
                               f"{name} differs")
        print(f"  quick without pins ({run['report'].n_mem_requests} "
              f"requests, {len(sched.trace_log)} segments) equal to "
              f"Engine.run_stream over its trace log at prefetch {prefetch} "
              f"(every output; the final state after {extra // chunk} "
              f"all-invalid chunks, the last dispatch's padding past one "
              f"chunk); replay wall {wall:.3f} s", flush=True)


def plain_contracts(flags, device_lane, dma, stamp, release):
    """The pin contracts written out plainly (numpy, one page at a time):
    the FLAGS lane after stamping ``stamp`` and then releasing
    ``release``."""
    from repro_torch.core import table as tl
    active, page_a, page_b = dma
    out = flags.copy()
    for p in stamp:
        if flags[p] & (tl.POISONED | tl.RETIRED):
            continue
        d = device_lane[p]
        if active and p == page_a:
            d = 0
        elif active and p == page_b:
            d = 1
        out[p] |= tl.PIN_FAST if d == 0 else tl.PIN_SLOW
    for p in release:
        out[p] &= ~tl.PINNED
    return out


def check_serve_contracts(torch, dev, rt) -> None:
    """Stamp and release a padded batch at the ``full`` profile's geometry
    and stamp width: live pages include the DMA's in-flight pair, a
    POISONED and a RETIRED page, page 0 (every padding lane's row) and the
    last page. The card equals the port on the CPU and the plain loop."""
    import numpy as np
    from repro_torch.core import table as tl
    from repro_torch.serve import release_pin_pages, stamp_pin_pages
    prof = SERVE_PROFILES["full"]
    cfg = rt.paper_platform().with_(**prof["geometry"])
    width = prof["serve"]["max_admit_per_step"]
    nf, n = cfg.n_fast_pages, cfg.n_pages
    rng = np.random.default_rng(8)
    page_a, page_b = nf + 1234, 77
    special = [page_a, page_b, nf + 5, 9, 0, n - 1]
    pages = np.concatenate([special, rng.integers(0, n, 2000)]).astype(
        np.int32)
    rng.shuffle(pages)
    release = pages[:700]
    tables = {}
    for where in ("cpu", dev):
        st = rt.Engine(cfg, device=where).init_state()
        tab = tl.set_flags(st.table, [nf + 5], tl.POISONED)
        tab = tl.set_flags(tab, [9], tl.POISONED | tl.RETIRED)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=where)
        st = st._replace(table=tab, dma=st.dma._replace(
            active=i32(1), page_a=i32(page_a), page_b=i32(page_b)))
        start = tl.flags(st.table).cpu().numpy()
        lane = tl.device(st.table).cpu().numpy()
        st = stamp_pin_pages(st, pages, width=width)
        st = release_pin_pages(st, release, width=width)
        tables[str(where)] = st.table.cpu()
    torch.cuda.synchronize()
    if not torch.equal(tables["cpu"], tables[str(dev)]):
        raise Mismatch("pin contracts on the card differ from the CPU")
    want = plain_contracts(start, lane, (1, page_a, page_b), pages, release)
    got = tl.flags(tables[str(dev)]).numpy()
    if not np.array_equal(got, want):
        bad = np.flatnonzero(got != want)[:5].tolist()
        raise Mismatch(f"pin contracts differ from the plain loop at pages "
                       f"{bad}")
    print(f"  pin contracts at the full geometry ({n} rows), {len(pages)} "
          f"pages padded to {width} (in-flight swap pair, POISONED, "
          f"RETIRED, page 0, the last page), then {len(release)} released: "
          "equal on the card, on the CPU and in the plain loop", flush=True)


def check_serve(torch, dev, rt, hl, cs, card: str, full: bool = True
                ) -> dict:
    """Every check of phase 8 (see the module docstring)."""
    bench = serve_bench()
    out = check_serve_full(torch, dev, rt, hl, cs, bench, card) \
        if full else {}
    out.update(check_serve_routes(torch, dev, rt, hl, cs, bench))
    check_serve_replay(torch, dev, rt, hl, cs)
    check_serve_contracts(torch, dev, rt)
    return out


# --------------------------------------------------------------- phase 9
# The user policies' slice: phase 7's platform and trace, cut to its first
# POLICY_CHUNKS chunks (65,536 of 970,662 requests).
POLICY_CHUNKS = 128
USER_POLICIES = ("user_hotness", "user_write_hot")


def user_policies(torch, rt) -> dict:
    """Two policies written against the port's policy interface, as a
    user would (a leading point axis, as every policy takes):
    ``user_hotness``, ``hotness`` under a new name and function object,
    and ``user_write_hot``, which promotes the hottest slow page WRITTEN
    in the chunk past ``hot_threshold``, with the CLOCK victim."""
    pol = rt.core.policies
    take_lane = rt.core.indexing.take_lane
    hotness_lane = rt.core.table.HOTNESS

    def user_hotness(cfg, params, table, ptr, pages, is_write, valid):
        return pol.hotness_policy(cfg, params, table, ptr, pages, is_write,
                                  valid)

    def user_write_hot(cfg, params, table, ptr, pages, is_write, valid):
        cand, heat = pol._chunk_candidate(table, pages, valid,
                                          extra_mask=is_write)
        victim, vfound, skip = pol._clock_victim(table, ptr,
                                                 params.n_fast_pages)
        want = vfound & (heat >= params.hot_threshold) & \
            (heat > take_lane(table, victim, hotness_lane))
        new_ptr = (ptr + skip + want.to(torch.int32)) % params.n_fast_pages
        return want, cand, victim, new_ptr
    return {"user_hotness": user_hotness, "user_write_hot": user_write_hot}


def expect_refusal(what: str, fn, pattern: str) -> str:
    """Run ``fn``, which must raise the kernel route's ValueError naming
    ``pattern``; returns its message."""
    try:
        fn()
    except ValueError as e:
        if pattern not in str(e) or "chunk_step_kernel=\"off\"" not in str(e):
            raise Mismatch(f"{what}: refused with {e!r}") from e
        return str(e)
    raise Mismatch(f"{what}: not refused")


def point_run(res, i, n):
    """Design point ``i``'s (state, outs) of a sweep, outputs cut to n."""
    from repro_torch.core.emulator import _index
    return (_index(res.states, i),
            {k: v[i, :n] for k, v in res.outs.items()})


def check_user_policies(torch, dev, rt, hl, cs, card: str) -> dict:
    """Phase 9 (a): see the module docstring. Registers the two user
    policies (and later an impostor ``hotness``) in the port's module
    dict, and restores the dict before it returns."""
    from repro_torch.sweep import SweepSpec
    pol = rt.core.policies
    saved = dict(pol.POLICIES)
    try:
        for name, fn in user_policies(torch, rt).items():
            pol.register(name)(fn)
        base = rt.paper_platform().with_(chunk=512, hot_threshold=4,
                                         decay_every=32, write_weight=4)
        whole = sweep_trace(torch, dev, rt)
        n = POLICY_CHUNKS * base.chunk
        trace = rt.core.Trace(*(x[:n] for x in whole))
        print(f"  cut to its first {POLICY_CHUNKS} chunks: {n} of "
              f"{len(whole)} requests; platform {base.n_fast_pages} + "
              f"{base.n_slow_pages} pages "
              f"({base.n_pages * 8 * 4} B of table a point)", flush=True)
        del whole
        names = (*POLICIES, *USER_POLICIES)
        off = base.with_(chunk_step_kernel="off")
        off_spec = SweepSpec(off, policies=names)
        off_eng = rt.Engine(off)
        hl.KERNEL.launches = 0
        cs.KERNEL.launches = 0
        t0 = time.perf_counter()
        got = off_eng.sweep(off_spec, trace)
        torch.cuda.synchronize()
        off_wall = time.perf_counter() - t0
        off_counts = {"hmmu_lookup": hl.KERNEL.launches,
                      "chunk_step": cs.KERNEL.launches}
        if off_counts != {"hmmu_lookup": POLICY_CHUNKS, "chunk_step": 0}:
            raise Mismatch(f"user policies on 'off': launches {off_counts},"
                           f" not one of kernel A a chunk ({POLICY_CHUNKS})")
        eng = rt.Engine(base)
        hl.KERNEL.launches = 0
        cs.KERNEL.launches = 0
        want = eng.sweep(SweepSpec(base, policies=POLICIES), trace)
        torch.cuda.synchronize()
        auto_counts = {"hmmu_lookup": hl.KERNEL.launches,
                       "chunk_step": cs.KERNEL.launches}
        if auto_counts != {"hmmu_lookup": 0, "chunk_step": 1}:
            raise Mismatch(f"built-ins on 'auto': launches {auto_counts}, "
                           "not one of kernel B")
        print(f"  Engine.sweep of the six built-ins and {USER_POLICIES} on "
              f"'off': {len(names)} points in one chunk loop, launches "
              f"{off_counts}, wall {off_wall:.3f} s (first call); the six "
              f"built-ins on 'auto': launches {auto_counts}", flush=True)
        for i, name in enumerate(POLICIES):
            same_runs(torch, f"{name}: 'off' against 'auto'",
                      point_run(got, i, n), point_run(want, i, n))
        same_runs(torch, "user_hotness against hotness",
                  point_run(got, names.index("user_hotness"), n),
                  point_run(got, names.index("hotness"), n))
        one = rt.Engine(off.with_(policy="user_write_hot")).run(trace)
        same_runs(torch, "user_write_hot against its one-point 'off' run",
                  point_run(got, names.index("user_write_hot"), n),
                  (one.state, one.outs))
        rows = got.rows()
        for row in rows:
            print(f"    {row['label']}: AMAT {row['amat_cyc']:.3f} cycles, "
                  f"fast hits {row['fast_hit_rate']:.4f}, swaps "
                  f"{row['swaps']}")
        if rows[names.index("user_write_hot")]["swaps"] == 0:
            raise Mismatch("user_write_hot never migrates on this trace")
        print("  the six built-in points bitwise equal on 'off' and 'auto';"
              " user_hotness equal to hotness; user_write_hot equal to its "
              "one-point 'off' run", flush=True)
        del got, want, one
        a_ms, w_ms = device_and_wall_ms(
            torch, lambda: off_eng.sweep(off_spec, trace), 1,
            "hmmu_lookup_fused_kernel")
        print(f"  'off' sweep of {len(names)} points (a second call, "
              f"traced): wall {w_ms / 1e3:.3f} s, "
              f"{w_ms * 1e3 / (len(names) * n):.4f} us per point-request; "
              f"kernel A {off_counts['hmmu_lookup']} launches, "
              f"{a_ms / POLICY_CHUNKS * 1e3:.2f} us/launch (device), "
              f"{a_ms / w_ms:.4f} of the wall [{card}]", flush=True)
        # The kernel route refuses a selected user policy by name, and an
        # unselected one does not stop it.
        msg = expect_refusal(
            "Engine.run at user_write_hot on 'auto'",
            lambda: rt.Engine(base.with_(policy="user_write_hot")).run(
                trace), "'user_write_hot'")
        print(f"  'auto' at user_write_hot refused: {msg}", flush=True)
        hl.KERNEL.launches = 0
        cs.KERNEL.launches = 0
        hot_eng = rt.Engine(base.with_(policy="hotness"))
        hot_eng.run(trace)
        torch.cuda.synchronize()
        if set(USER_POLICIES) - set(hot_eng.registry.names) or \
                cs.KERNEL.launches != 1 or hl.KERNEL.launches != 0:
            raise Mismatch(f"an unselected user policy: registry "
                           f"{hot_eng.registry.names}, launches of kernel B "
                           f"{cs.KERNEL.launches}, of kernel A "
                           f"{hl.KERNEL.launches}")
        print(f"  'auto' at hotness with {USER_POLICIES} registered: kernel "
              "B launched once", flush=True)
        pol.register("hotness")(user_policies(torch, rt)["user_hotness"])
        cs.KERNEL.launches = 0
        expect_refusal("an impostor registered as 'hotness' on 'auto'",
                       lambda: rt.Engine(base.with_(policy="hotness")).run(
                           trace), "'hotness' is a user policy")
        if cs.KERNEL.launches:
            raise Mismatch("the impostor launched kernel B")
        print("  an impostor registered as 'hotness' refused on 'auto'",
              flush=True)
    finally:
        pol.POLICIES.clear()
        pol.POLICIES.update(saved)
    return {"off_launches": off_counts["hmmu_lookup"],
            "auto_launches": auto_counts["chunk_step"]}


# Phase 9 (b): minitron-8b's KV cache. ``ServeEngine._kv_bytes_per_position``
# gives 2 (K and V) x 2 bytes (bfloat16) x 8 KV heads x 128 head dim; it
# sets 64 positions a page. 128 sequences (``decode_32k``'s batch) of
# 32,768 tokens hold 512 pages each: 65,536 pages, twice the fast tier.
KV_BYTES_PER_POSITION = 2 * 2 * 8 * 128
KV_POSITIONS_PER_PAGE = 64
KV_SEQS, KV_CONTEXT, KV_STEPS, KV_TURNOVER, KV_STEPS_AFTER = \
    128, 32_768, 8, 16, 4


def tiered_run(torch, dev, rt, route: str) -> dict:
    """Phase 9 (b)'s decode run on ``route``: KV_STEPS decode steps of
    KV_SEQS sequences, then KV_TURNOVER of them freed and as many new
    ones admitted, then KV_STEPS_AFTER steps. Returns the accounting, the
    host time of each step's stream building and ``account`` calls, and
    each step's request count."""
    from repro_torch.memtier import TieredKVAccounting
    cfg = rt.paper_platform().with_(chunk=512, policy="hotness",
                                    hot_threshold=4,
                                    chunk_step_kernel=route)
    tier = TieredKVAccounting(
        cfg, n_layers=32, positions_per_page=KV_POSITIONS_PER_PAGE,
        bytes_per_position=KV_BYTES_PER_POSITION, pin_pages_per_seq=1,
        device=dev)
    seqs = list(range(KV_SEQS))
    lens = [KV_CONTEXT] * KV_SEQS
    build, account, requests = [], [], []

    def step():
        t0 = time.perf_counter()
        trace = tier.access_trace(seqs, lens)
        t1 = time.perf_counter()
        tier.account(trace)      # reads the clock back: synchronised
        account.append(time.perf_counter() - t1)
        build.append(t1 - t0)
        requests.append(len(trace))
        lens[:] = [x + 1 for x in lens]

    for _ in range(KV_STEPS):
        step()
    for sid in seqs[:KV_TURNOVER]:
        tier.free_sequence(sid)
    seqs = seqs[KV_TURNOVER:] + list(range(KV_SEQS, KV_SEQS + KV_TURNOVER))
    lens[:] = lens[KV_TURNOVER:] + [KV_CONTEXT] * KV_TURNOVER
    for _ in range(KV_STEPS_AFTER):
        step()
    return {"tier": tier, "build": build, "account": account,
            "requests": requests, "cfg": cfg}


def check_tiered(torch, dev, rt, hl, cs, card: str) -> dict:
    """Phase 9 (b): see the module docstring."""
    from torch.profiler import ProfilerActivity, profile
    runs, counts = {}, {}
    for route in ("auto", "off"):
        hl.KERNEL.launches = 0
        cs.KERNEL.launches = 0
        if route == "auto":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                runs[route] = tiered_run(torch, dev, rt, route)
            b_us, b_traced = trace_us(prof, lambda k: "chunk_step_kernel" in k)
        else:
            runs[route] = tiered_run(torch, dev, rt, route)
        counts[route] = {"hmmu_lookup": hl.KERNEL.launches,
                         "chunk_step": cs.KERNEL.launches}
    a, o = runs["auto"], runs["off"]
    steps = KV_STEPS + KV_STEPS_AFTER
    chunk = a["cfg"].chunk
    n_chunks = sum(-(-r // chunk) for r in a["requests"])
    if counts["auto"] != {"hmmu_lookup": 0, "chunk_step": steps} or \
            counts["off"] != {"hmmu_lookup": n_chunks, "chunk_step": 0}:
        raise Mismatch(f"tiered accounting: launches {counts}; expected one "
                       f"of kernel B a step ({steps}) on 'auto' and one of "
                       f"kernel A a chunk ({n_chunks}) on 'off'")
    ta, to = a["tier"], o["tier"]
    rep_a, rep_o = ta.report(), to.report()
    if rep_a != rep_o:
        bad = [k for k in rep_a if rep_a[k] != rep_o[k]]
        raise Mismatch(f"tiered accounting: report fields {bad} differ "
                       "between 'auto' and 'off'")
    for name, u, v in leaves(ta.state, to.state, "state"):
        if not torch.equal(u, v):
            raise Mismatch(f"tiered accounting: {name} differs between "
                           "'auto' and 'off'")
    if ta._pinned != to._pinned or a["requests"] != o["requests"]:
        raise Mismatch("tiered accounting: pinned pages or streams differ")
    rt.core.check_table(a["cfg"], ta.state.table)
    if rep_a["slow_free"] >= a["cfg"].n_slow_pages or rep_a["fast_free"]:
        raise Mismatch("tiered accounting: the cache did not spill past the "
                       "fast tier")
    wall = [x + y for x, y in zip(a["build"], a["account"])]
    b_ms = b_us / 1e3 / steps
    print(f"  minitron-8b KV ({KV_BYTES_PER_POSITION} B a position, "
          f"{KV_POSITIONS_PER_PAGE} positions a page): {KV_SEQS} sequences "
          f"at {KV_CONTEXT} tokens, {KV_STEPS} decode steps, "
          f"{KV_TURNOVER} freed and admitted, {KV_STEPS_AFTER} more; "
          f"requests a step {a['requests'][0]}..{max(a['requests'])}; "
          f"launches {counts}", flush=True)
    print(f"  report on 'auto' and 'off' equal ({rep_a['requests']} "
          f"requests; pinned pages {rep_a['pinned_pages']}, pinned fast hit "
          f"rate {rep_a['pinned_fast_hit_rate']:.4f}; reads fast/slow "
          f"{rep_a['reads_fast']}/{rep_a['reads_slow']}; migrations "
          f"{rep_a['migrations']}; free fast/slow {rep_a['fast_free']}/"
          f"{rep_a['slow_free']}); final tables, counters and every state "
          "field bitwise equal; check_table passes", flush=True)
    mean = lambda xs: sum(xs) / len(xs) * 1e3
    print(f"  'auto' a step: wall {mean(wall):.3f} ms = stream building "
          f"{mean(a['build']):.3f} ms + account {mean(a['account']):.3f} ms; "
          f"kernel B {b_ms:.3f} ms (device; {b_traced} of {steps} launches "
          f"traced), {b_ms / mean(wall):.4f} of the wall; first step "
          f"{wall[0] * 1e3:.3f} ms; 'off' a step: stream building "
          f"{mean(o['build']):.3f} ms + account {mean(o['account']):.3f} ms "
          f"[{card}]", flush=True)
    return {"auto_launches": counts["auto"]["chunk_step"],
            "off_launches": counts["off"]["hmmu_lookup"]}


def check_consumed(torch, dev, rt) -> None:
    """Phase 9 (c): a donated state passed to ``run`` again is refused."""
    cfg = rt.small_platform(chunk=16)
    eng = rt.Engine(cfg)
    z = torch.arange(64, dtype=torch.int32, device=dev) % cfg.n_pages
    trace = rt.core.Trace(z, z * 0, z % 3 == 0, torch.full_like(z, 64))
    s0 = eng.run(trace).state
    s1 = eng.run(trace, state=s0).state
    try:
        # reprolint: allow[donation] the consumed state must be refused
        eng.run(trace, state=s0)
    except RuntimeError as e:
        if "donate=False" not in str(e):
            raise Mismatch(f"consumed state: refused with {e!r}") from e
    else:
        raise Mismatch("a consumed state was run again on the card")
    eng.run(trace, state=s1)
    print("  a consumed state passed to Engine.run again on the card: "
          "RuntimeError", flush=True)


# Phase 9 (d): single-chunk channels whose energy is folded from zero, so
# a one-ulp difference in a chunk's energy term shows (on a long run the
# counter's own ulp hides it).
ENERGY_CHANNELS = 2000


def check_energy_fold(torch, dev, rt, cs) -> None:
    """Phase 9 (d): ``Engine.run_channels`` over ENERGY_CHANNELS random
    16-request chunks (64, 128 or 4,096 B, both tiers), each from a fresh
    state, in ONE launch of kernel B, against the plain route (``"off"``,
    ``counters.fma``): every counter bitwise equal. The energy of some
    channels must differ from the form that rounds every product on its
    own, or the data would not tell the two apart."""
    cfg = rt.small_platform(chunk=16)
    g = torch.Generator(device=dev).manual_seed(9)
    shape = (ENERGY_CHANNELS, cfg.chunk)

    def draw(hi):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)
    sizes = torch.tensor([64, 128, 4096], dtype=torch.int32, device=dev)
    traces = rt.core.Trace(draw(cfg.n_pages), draw(64) * 64,
                           draw(5) < 2, sizes[draw(3).long()])
    cs.KERNEL.launches = 0
    got = rt.Engine(cfg).run_channels(traces)[0].counters
    torch.cuda.synchronize()
    if cs.KERNEL.launches != 1:
        raise Mismatch(f"energy fold: {cs.KERNEL.launches} launches of "
                       "kernel B for one run_channels call")
    want = rt.Engine(cfg.with_(chunk_step_kernel="off")).run_channels(
        traces)[0].counters
    for name, a, b in leaves(got, want, "counters"):
        if not torch.equal(a, b):
            raise Mismatch(f"energy fold: {name} differs between kernel B "
                           f"and the plain route on "
                           f"{int((a != b).sum())} channels")
    p = rt.Engine(cfg).params
    f32 = lambda x: x.to(torch.float32)
    separate = (8.0 * (f32(want.bytes_read_fast) + f32(want.bytes_write_fast))
                * p.power_pj_per_bit_fast
                + 8.0 * f32(want.bytes_read_slow)
                * p.power_pj_per_bit_slow_read) \
        + 8.0 * f32(want.bytes_write_slow) * p.power_pj_per_bit_slow_write
    differ = int((separate != want.energy_pj).sum())
    if differ == 0:
        raise Mismatch("energy fold: no channel's energy tells the two-FMA "
                       "order from the product-by-product one")
    print(f"  energy fold: {ENERGY_CHANNELS} single-chunk channels in one "
          f"launch of kernel B, every counter bitwise equal to the plain "
          f"route (counters.fma); {differ} of them differ from the "
          "product-by-product rounding", flush=True)


def check_slice9(torch, dev, rt, hl, cs, card: str) -> dict:
    """Every check of phase 9 (see the module docstring)."""
    check_energy_fold(torch, dev, rt, cs)
    out = {"policies": check_user_policies(torch, dev, rt, hl, cs, card),
           "tiered": check_tiered(torch, dev, rt, hl, cs, card)}
    check_consumed(torch, dev, rt)
    return out


# --------------------------------------------------------------- phase 10
# Serving at full width: the port's ``ServeEngine`` over the dense model
# (all layers, bfloat16, random weights from a seed on the card) with
# ``launch/serve.py``'s emulator settings, at minitron-8b and gemma3-4b.
SERVE_SMAX = 2048
# The last request of a dense model's serve fills its lane to near
# SERVE_SMAX and ends after IDLE_NEW tokens while the one before it runs
# for LONG_NEW: the idle lane's ``pos`` then passes SERVE_SMAX (decode
# advances every lane).
IDLE_PROMPT, IDLE_NEW, LONG_NEW = 2016, 8, 64


class ServeModel(NamedTuple):
    """One model's serve in phases 10 and 11."""
    arch: str
    layers: int | None   # the depth cut (None: every layer)
    batch: int
    prompts: tuple       # (lowest, highest) prompt length, from a seed
    new: int             # new tokens a request
    lengths: tuple       # (request index, its new tokens) that differ
    requests: int
    idle: bool           # the last request is the idle-lane one above


DENSE_SERVES = tuple(
    ServeModel(arch, None, 8, (1024, 1536), 32, ((14, LONG_NEW),
                                                 (15, IDLE_NEW)), 16, True)
    for arch in ("minitron-8b", "gemma3-4b"))
LAYER0_BLOCK = 128     # the flash kernel takes Sq in multiples of its block
SPY_STEP = 10          # the decode step whose layer 0 meets the sequence path
# Decode-path logits against the sequence path's, both bfloat16: the two
# paths round each layer's products and outputs to bfloat16 apart
# (different product shapes, chunked against cached attention), and over
# 32-34 layers of random weights the drift grows to several bfloat16
# steps of the logits, whose largest magnitudes lie in [4, 8) (a step of
# 2^-5 there). The sequence path alone moves as far when only its length
# changes: on an H100 its row over the prompt stood up to 0.234
# (minitron-8b) and 0.188 (gemma3-4b) from its row over the longer
# sequence, and the decode path up to 0.322 and 0.223. The bound is 16
# steps (0.5); a generated token is held to the sequence path's argmax
# wherever that row's top-2 margin exceeds it.
LOGIT_TOL = 0.5
# Layer 0's q and cache rows at a decode step against the sequence path's:
# a bfloat16 step of a value apart at most before RoPE, two after it (the
# rotation carries the step, and each side rounds once more); the bound is
# four steps of the largest magnitude. A row not written, or written at
# another position or into another lane, stands the whole value apart.
CACHE_REL = 2.0 ** -5


def seq_multiple(cfg) -> int:
    """Sequence-path lengths are multiples of this: RWKV's chunk (a longer
    whole-sequence chunk overflows float32, ROADMAP §3), else 1."""
    return cfg.rwkv_chunk if cfg.attn_type == "rwkv6" else 1


def serve_requests(row: ServeModel, cfg, seed: int = 0) -> list:
    """(rid, int32 prompt, max_new_tokens) of one model's requests: prompt
    lengths from a seed, multiples of ``seq_multiple``. With ``row.idle``
    the last prompt is IDLE_PROMPT long. Hymba's first prompt is the
    longest (past the 1,024 window: prefill restacks the ring) and its
    third ends half the new tokens short of the window (its lane crosses
    it while decoding)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    m = seq_multiple(cfg)
    lo, hi = (n // m for n in row.prompts)
    lens = (rng.integers(lo, hi + 1, row.requests - row.idle) * m).tolist()
    if row.idle:
        lens.append(IDLE_PROMPT)
    if cfg.attn_type == "hymba":
        lens[0], lens[2] = row.prompts[1], cfg.window - row.new // 2
    news = [row.new] * row.requests
    for i, n in row.lengths:
        news[i] = n
    return [(rid, rng.integers(0, cfg.vocab, n).astype(np.int32), m)
            for rid, (n, m) in enumerate(zip(lens, news))]


def instrument_serve(torch, eng) -> dict:
    """Wrap one ``ServeEngine``'s calls (instance attributes over its
    methods; the engine's code is not touched): each prefill's time,
    tokens and logit row; each decode step's time, logit rows by request,
    the largest ``pos`` of an idle lane and the live lanes' MoE slots
    dropped (over the layers); the tier's stream building and ``account``
    times; the tier's calls in order, for the replay. At one decode step
    one layer's decode call is recorded (``log["spy"]``), with the
    engine's ``pos`` and lanes before the step: GQA's layer 0
    ``dist_decode`` and MLA's layer 0 ``mla_decode`` at step SPY_STEP,
    Hymba's layer HYMBA_LAYER ``dist_decode`` over its ring at the first
    step where a live lane's ``pos`` reaches the window. The model
    functions are looked up at each call, so an outer wrapper's spies
    stay in place."""
    from repro_torch.models import mamba, mla, moe, transformer
    cfg = eng.cfg
    log = {"prefill": [], "rows": {}, "decode_ms": [], "build_ms": [],
           "account_ms": [], "step_ms": [], "tier_calls": [],
           "idle_pos": -1, "drops": [], "spy": None}
    prefill, decode, step = eng._prefill, eng._decode, eng.step
    tier = eng.tier
    access, account, free = tier.access_trace, tier.account, \
        tier.free_sequence
    # the decode call a check holds: its module, name and place in a step
    mod, name, nth = {"gqa": (transformer, "dist_decode", 1),
                      "mla": (mla, "mla_decode", 1),
                      "hymba": (mamba, "dist_decode", HYMBA_LAYER + 1)
                      }.get(cfg.attn_type, (None, None, 0))

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def prefill_(params, inputs):
        out, ms = timed(prefill, params, inputs)
        log["prefill"].append((ms, inputs.shape[1], out[0][0].clone()))
        return out

    def decode_(params, tokens, cache, pos):
        lanes = [r.rid if r is not None else None for r in eng.active]
        live = [i for i, rid in enumerate(lanes) if rid is not None]
        before = pos.tolist()
        spying = log["spy"] is None and mod is not None and (
            max(before[i] for i in live) >= cfg.window
            if cfg.attn_type == "hymba"
            else len(log["decode_ms"]) == SPY_STEP)
        keeps, calls = [], []
        real_route = moe._top_k_dispatch
        real = getattr(mod, name) if mod is not None else None

        def route(probs, k, cap):
            out = real_route(probs, k, cap)
            keeps.append(out[3])
            return out

        def spy(*a, **kw):
            out = real(*a, **kw)
            calls.append(None)
            if spying and len(calls) == nth:
                if cfg.attn_type == "mla":
                    _, p, x, _, c, kv_len = a
                    log["spy"] = {"p": p, "x": x.clone(),
                                  "c_kv": c["c_kv"].clone(),
                                  "k_rope": c["k_rope"].clone(),
                                  "kv_len": kv_len.clone(),
                                  "out": out[0].clone()}
                else:
                    q, ck, cv, kv_len = a
                    log["spy"] = {"q": q.clone(), "k": ck.clone(),
                                  "v": cv.clone(), "kv_len": kv_len.clone(),
                                  "window": kw.get("window"),
                                  "out": out.clone()}
                log["spy"].update(pos=before, lanes=lanes)
            return out

        moe._top_k_dispatch = route
        if mod is not None:
            setattr(mod, name, spy)
        try:
            out, ms = timed(decode, params, tokens, cache, pos)
        finally:
            moe._top_k_dispatch = real_route
            if mod is not None:
                setattr(mod, name, real)
        log["decode_ms"].append(ms)
        for i in live:
            log["rows"].setdefault(lanes[i], []).append(out[0][i].clone())
        idle = [i for i, rid in enumerate(lanes) if rid is None]
        if idle:
            log["idle_pos"] = max(log["idle_pos"],
                                  int(out[2][idle].max()))
        if keeps:
            log["drops"].append(int(sum((~kp[live]).sum() for kp in keeps)))
        return out

    def step_():
        n = len(log["prefill"])
        t0 = time.perf_counter()
        live = step()
        admit = sum(ms for ms, _, _ in log["prefill"][n:])
        if live:       # the step's wall less its admissions' prefills
            log["step_ms"].append((time.perf_counter() - t0) * 1e3 - admit)
        return live

    def access_(seq_ids, kv_lens, windows=None):
        t0 = time.perf_counter()
        trace = access(seq_ids, kv_lens, windows)
        log["build_ms"].append((time.perf_counter() - t0) * 1e3)
        log["tier_calls"].append(("trace", list(seq_ids), list(kv_lens),
                                  None if windows is None else list(windows)))
        return trace

    def account_(trace):
        t0 = time.perf_counter()
        out = account(trace)      # reads the clock back: synchronised
        log["account_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def free_(seq_id):
        log["tier_calls"].append(("free", seq_id))
        free(seq_id)

    eng._prefill, eng._decode, eng.step = prefill_, decode_, step_
    tier.access_trace, tier.account, tier.free_sequence = \
        access_, account_, free_
    return log


def replay_tier(rt, tier, calls, device):
    """A fresh ``TieredKVAccounting`` like ``tier`` on ``device``, fed the
    recorded calls in order."""
    from repro_torch.memtier import TieredKVAccounting
    out = TieredKVAccounting(tier.cfg, tier.n_layers,
                             positions_per_page=tier.ppp,
                             bytes_per_position=tier.bpp,
                             pin_pages_per_seq=tier.pin_pages_per_seq,
                             device=device)
    for call in calls:
        if call[0] == "trace":
            out.account(out.access_trace(*call[1:]))
        else:
            out.free_sequence(call[1])
    return out


def check_replay(torch, rt, eng, calls) -> dict:
    """The tier's report, final table, counters and state against a CPU
    ``TieredKVAccounting`` fed the recorded calls: bitwise."""
    tier = eng.tier
    cpu = replay_tier(rt, tier, calls, "cpu")
    got, want = tier.report(), cpu.report()
    if got != want:
        bad = [k for k in want if got.get(k) != want[k]]
        raise Mismatch(f"model serve: report fields {bad} differ from the "
                       "CPU replay")
    for name, a, b in leaves(tier.state, cpu.state, "state"):
        if not torch.equal(a.cpu(), b):
            raise Mismatch(f"model serve: {name} differs from the CPU replay")
    if tier._pinned != cpu._pinned:
        raise Mismatch("model serve: pinned pages differ from the CPU replay")
    return got


def check_tokens(torch, cfg, params, reqs, log,
                 routes: dict | None = None) -> dict:
    """Each request's tokens against a prefill over its prompt and the
    tokens before each one (the sequence path): the argmax wherever that
    row's top-2 margin exceeds LOGIT_TOL, and every decode-path row (the
    admission's prefill row, then the decode steps' rows) within LOGIT_TOL
    of it. The sequence is padded with token 0 past its end to a multiple
    of ``seq_multiple`` (causality keeps the padding out of the compared
    rows). With ``routes`` (an MoE model: each request's experts a row and
    a layer on the decode path, ``record_serve_routes``), the sequence
    path routes the compared rows to the decode path's experts
    (``forced_routes``): the two paths' bf16 hidden states differ by
    rounding, and where two experts' router probabilities stand that close
    the choice flips, a discrete change of the row that is not the fault
    this check looks for. The rows whose choice flipped are counted."""
    from repro_torch.models import ShardCtx, layers, transformer
    sh = ShardCtx()
    dev = params["final_norm"].device
    mult = seq_multiple(cfg)
    checked = total = flipped = 0
    worst = floor = 0.0
    margins, row_diff, scale = [], [], 0.0
    for i, req in enumerate(reqs):
        n, r = len(req.prompt), len(req.out)
        toks = list(req.prompt) + req.out[:-1]
        toks += [0] * (-len(toks) % mult)
        seq = torch.as_tensor(toks, dtype=torch.int32, device=dev)[None]
        own = []
        if routes is not None:
            forced = routes[req.rid][:r]
            if forced.shape[0] != r:
                raise Mismatch(f"model serve: request {req.rid} has "
                               f"{forced.shape[0]} routed rows for {r} "
                               "tokens")
            ctx = forced_routes(slice(n - 1, n - 1 + r), forced, own)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            x, _, _ = transformer.forward_seq(cfg, params, seq, sh,
                                              collect_cache=False)
        if own:
            own = torch.stack(own, 1).sort(dim=-1).values    # [r, L, k]
            flipped += int((own != forced.sort(dim=-1).values).any(
                -1).any(-1).sum())
        x = x[:, n - 1:n - 1 + r]
        want = layers.lm_logits(cfg, params, x, sh)[0]
        got = torch.stack([log["prefill"][i][2]] + log["rows"].get(
            req.rid, [])[:r - 1])
        if got.shape != want.shape:
            raise Mismatch(f"model serve: request {req.rid} has "
                           f"{got.shape[0]} logit rows for {want.shape[0]} "
                           "tokens")
        diff = (got.float() - want.float()).abs().amax(dim=-1)
        # Row 0 is the sequence path itself, over the prompt alone: how far
        # two lengths of the same path stand apart (the noise floor).
        floor = max(floor, float(diff[0]))
        row_diff += diff[1:].tolist()
        scale = max(scale, float(want.float().abs().max()))
        worst = max(worst, float(diff.max()))
        if float(diff.max()) > LOGIT_TOL:
            raise Mismatch(f"model serve: request {req.rid}'s decode-path "
                           f"logits stand {float(diff.max()):.4f} from the "
                           f"sequence path's (tolerance {LOGIT_TOL}; the "
                           f"sequence path over the prompt alone "
                           f"{float(diff[0]):.4f}; rows {diff.tolist()}; "
                           f"largest |logit| {scale:.3f})")
        top2 = want.float().topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        arg = want.argmax(dim=-1).tolist()
        for j, tok in enumerate(req.out):
            total += 1
            margins.append(margin[j])
            if margin[j] > LOGIT_TOL:
                checked += 1
                if arg[j] != tok:
                    raise Mismatch(
                        f"model serve: request {req.rid}'s token {j} is "
                        f"{tok}, the sequence path's argmax {arg[j]} "
                        f"(margin {margin[j]:.4f})")
    margins.sort()
    row_diff.sort()
    return {"checked": checked, "total": total, "worst": worst,
            "floor": floor, "median_diff": row_diff[len(row_diff) // 2],
            "scale": scale, "median_margin": margins[len(margins) // 2],
            "flipped": flipped}


def check_layer0(torch, ops, ref, cfg, params, prompt, spy) -> dict:
    """Layer 0 of one prompt through the port's own functions: the norm's
    output equal to its float32 formula rounded once (the reference's cast
    points), RoPE within one bfloat16 step (of the pair's magnitude, which
    the rotation keeps) of the rotation of each pair (x_i, x_{i+D/2})
    computed in float64; then the hand-written kernels on
    the model's activations: ``ops.flash_attention`` on the post-RoPE
    q/k/v against ``chunked_attention`` (the model's prefill attention),
    and ``ops.decode_attention`` on the q and cache that ``dist_decode``
    saw at one decode step, each within ``ref.kernel_error``."""
    from repro_torch.models import ShardCtx, layers, transformer
    from repro_torch.models.chunked_attention import chunked_attention
    sh = ShardCtx()
    p = transformer._layer(params, 0)["attn"]
    window = (transformer.layer_windows(cfg) or [None])[0]
    x = layers.embed_tokens(cfg, params["embed"], prompt[None], sh)
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    xf = x.float()
    want_h = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True)
                               + cfg.norm_eps) * p["norm"].float()).to(x.dtype)
    if not torch.equal(h, want_h):
        raise Mismatch(f"model serve: layer 0's rms_norm differs from its "
                       f"float32 formula at {int((h != want_h).sum())} of "
                       f"{h.numel()} elements")
    q, k, v = layers.gqa_project(cfg, p, h, cfg.adtype)
    s, hd = q.shape[2], cfg.head_dim_
    posn = torch.arange(s, dtype=torch.float32, device=q.device)
    cos, sin = layers.rope_tables(posn, hd, cfg.rope_theta)
    rot = {}
    for name, t in (("q", q), ("k", k)):
        got = layers.apply_rope(t, cos, sin)
        i = torch.arange(0, hd, 2, dtype=torch.float64, device=q.device)
        ang = torch.arange(s, dtype=torch.float64, device=q.device)[:, None] \
            * cfg.rope_theta ** (-i / hd)
        z = torch.complex(*t.double().chunk(2, dim=-1)) * torch.polar(
            torch.ones_like(ang), ang)
        want = torch.cat([z.real, z.imag], dim=-1).to(t.dtype)
        step = (z.abs().float().clamp_min(2.0 ** -126).log2().floor()
                - 7).exp2().repeat(1, 1, 1, 2)
        over = ((got.float() - want.float()).abs() / step).max()
        if float(over) > 1.0:
            raise Mismatch(f"model serve: layer 0's RoPE on {name} stands "
                           f"{float(over):.1f} bfloat16 steps from the "
                           "rotation")
        rot[name] = got
    v = v.contiguous()
    attn = chunked_attention(rot["q"], rot["k"], v, causal=True,
                             window=window)
    flash = ops.flash_attention(rot["q"], rot["k"], v, causal=True,
                                window=window)
    f_err, f_share = ref.kernel_error("attention", flash, attn)
    dec = ops.decode_attention(spy["q"], spy["k"], spy["v"], spy["kv_len"],
                               window=spy["window"])
    d_err, d_share = ref.kernel_error("attention", dec,
                                      spy["out"].to(dec.dtype))
    for what, share in (("flash_attention", f_share),
                        ("decode_attention", d_share)):
        if not share <= 1.0:
            raise Mismatch(f"model serve: ops.{what} on layer 0's "
                           f"activations at {share:.2f} of its allowance")
    return {"flash": (f_err, f_share), "decode": (d_err, d_share),
            "s": s, "window": window}


def attention_f64(torch, q, k, v, n: int, window):
    """Float64 attention of one query a head over cache rows [0, n), the
    last ``window`` of them where ``window`` is an int. q [Hq, D]; k/v
    [Hkv, >= n, D] -> [Hq, D] float64."""
    hq, d = q.shape
    hkv = k.shape[0]
    qg = q.double().reshape(hkv, hq // hkv, d)
    logits = torch.einsum("kgd,ktd->kgt", qg, k[:, :n].double()) * d ** -0.5
    if window is not None:
        logits[..., :max(0, n - window)] = -math.inf
    return torch.einsum("kgt,ktd->kgd", logits.softmax(-1),
                        v[:, :n].double()).reshape(hq, v.shape[-1])


def check_decode_layer0(torch, ref, cfg, params, reqs, spy) -> dict:
    """Layer 0 at the spied decode step against the sequence path, lane by
    lane, through one layer only (no drift of 32 layers between them). For
    each live lane, its request's prompt and the tokens fed up to this
    step (``pos + 1`` positions, ``pos`` the engine's before the step) go
    through layer 0 once, giving the sequence path's q, k, v. (a) The q
    that ``dist_decode`` saw, and the lane's cache rows [0, pos], within
    CACHE_REL of the largest magnitude of the sequence path's: the two
    paths' projections sum in different orders and round to bfloat16
    apart, by a step of a value at most (after RoPE, two), while a row
    not written, or written at another position or into another lane,
    stands apart by the whole value. (b) ``dist_decode``'s output within
    ``ref.kernel_error``'s float32 allowance of float64 attention over the
    same q and cache rows [0, pos + 1), in layer 0's own window: the length
    and the window come from the engine and the configuration, not from the
    call, so a length or window edge off by one row fails (on an H100 at
    minitron-8b: 8.6e-3 of an output near 1, against float32 noise of
    1.3e-6). (c) ``chunked_attention``'s row at ``pos`` over the
    sequence path's q, k, v within the bfloat16 allowance of float64
    attention on the same inputs. The two paths' outputs' largest
    difference is printed, not held (the sequence path's row is rounded to
    bfloat16)."""
    from repro_torch.models import ShardCtx, layers, transformer
    from repro_torch.models.chunked_attention import chunked_attention
    sh = ShardCtx()
    p = transformer._layer(params, 0)["attn"]
    window = (transformer.layer_windows(cfg) or [None])[0]
    dev = p["wq"].device
    byrid = {r.rid: r for r in reqs}
    out = {"lanes": 0, "cache": 0.0, "q": 0.0, "dist": 0.0, "chunked": 0.0,
           "paths": 0.0}
    for i, rid in enumerate(spy["lanes"]):
        if rid is None:
            continue
        req, pos = byrid[rid], spy["pos"][i]
        n = len(req.prompt)
        seq = list(req.prompt) + req.out[:pos - n + 1]
        if len(seq) != pos + 1:
            raise Mismatch(f"model serve: lane {i} at pos {pos} holds "
                           f"{len(seq)} tokens of request {rid}")
        x = layers.embed_tokens(cfg, params["embed"], torch.as_tensor(
            seq, dtype=torch.int32, device=dev)[None], sh)
        h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
        q, k, v = layers.gqa_project(cfg, p, h, cfg.adtype)
        cos, sin = layers.rope_tables(torch.arange(
            pos + 1, dtype=torch.float32, device=dev), cfg.head_dim_,
            cfg.rope_theta)
        q, k = layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)
        for key, name, got, want in (
                ("q", "q", spy["q"][i], q[0, :, pos]),
                ("cache", "cache k", spy["k"][i, :, :pos + 1], k[0]),
                ("cache", "cache v", spy["v"][i, :, :pos + 1], v[0])):
            share = float((got.float() - want.float()).abs().max()
                          / want.float().abs().max() / CACHE_REL)
            out[key] = max(out[key], share)
            if not share <= 1.0:
                raise Mismatch(f"model serve: lane {i}'s {name} at decode "
                               f"(pos {pos}) stands {share:.2f} of "
                               f"{CACHE_REL} of its magnitude from layer 0 "
                               "of the sequence path")
        want = attention_f64(torch, spy["q"][i], spy["k"][i], spy["v"][i],
                             pos + 1, window)
        _, d_share = ref.kernel_error("attention", spy["out"][i],
                                      want.float())
        row = chunked_attention(q, k, v.contiguous(), causal=True,
                                window=window)[0, :, pos]
        want_c = attention_f64(torch, q[0, :, pos], k[0], v[0], pos + 1,
                               window)
        _, c_share = ref.kernel_error("attention", row, want_c.to(row.dtype))
        for what, share in (("dist_decode", d_share),
                            ("chunked_attention", c_share)):
            if not share <= 1.0:
                raise Mismatch(f"model serve: layer 0's {what} for lane {i} "
                               f"(pos {pos}, window {window}) at "
                               f"{share:.2f} of its allowance of float64 "
                               "attention over the engine's length")
        out["dist"] = max(out["dist"], d_share)
        out["chunked"] = max(out["chunked"], c_share)
        out["paths"] = max(out["paths"], float(
            (spy["out"][i] - row.float()).abs().max()))
        out["lanes"] += 1
    if not out["lanes"]:
        raise Mismatch("model serve: no live lane at the spied decode step")
    return out


# --------------------------------------------------------------- phase 11
# Serving the other families at full width: RWKV6, Hymba (attention +
# Mamba), MLA + MoE and GQA + MoE through ``ServeEngine`` with
# ``launch/serve.py``'s emulator settings, bfloat16, random weights from a
# seed. Each model's checks start in the layer where a fault would happen
# (layer 0, or Hymba's first windowed layer), before its tokens are held
# to the sequence path; every failure of a model is reported together.


@contextlib.contextmanager
def record_routes(out: list):
    """Append every MoE routing call's experts (``moe._top_k_dispatch``'s
    indices) to ``out``, in call order: one ``[T, k]`` tensor a layer a
    forward."""
    from repro_torch.models import moe
    real = moe._top_k_dispatch

    def spy(probs, k, cap):
        got = real(probs, k, cap)
        out.append(got[0])
        return got
    moe._top_k_dispatch = spy
    try:
        yield
    finally:
        moe._top_k_dispatch = real


def record_serve_routes(eng, routes: dict) -> None:
    """Wrap an engine's ``_prefill`` / ``_decode`` to keep each request's
    expert sets a row: ``routes[rid]`` becomes ``[rows, L, k]`` (the
    admission's last prompt token, then one row a decode step)."""
    import torch
    prefill, decode = eng._prefill, eng._decode

    def prefill_(params, inputs):
        rid = next(r.rid for r in eng.active
                   if r is not None and r.rid not in routes)
        rec = []
        with record_routes(rec):
            out = prefill(params, inputs)
        routes[rid] = torch.stack([r[-1] for r in rec])[None]
        return out

    def decode_(params, tokens, cache, pos):
        lanes = [(i, r.rid) for i, r in enumerate(eng.active)
                 if r is not None]
        rec = []
        with record_routes(rec):
            out = decode(params, tokens, cache, pos)
        for i, rid in lanes:
            routes[rid] = torch.cat([routes[rid], torch.stack(
                [r[i] for r in rec])[None]])
        return out
    eng._prefill, eng._decode = prefill_, decode_


@contextlib.contextmanager
def forced_routes(rows: slice, forced, own: list):
    """Inside, the l-th MoE routing call sends the tokens ``rows`` to the
    experts ``forced[:, l]`` (``[R, L, k]``) and every other token where
    the model sends it, with the gates and slots of ``moe_plain_routing``
    over those experts; each call's own experts for ``rows`` are appended
    to ``own``."""
    import torch
    from repro_torch.models import moe
    real = moe._top_k_dispatch

    def spy(probs, k, cap):
        idx = real(probs, k, cap)[0]
        own.append(idx[rows])
        idx = idx.clone()
        idx[rows] = forced[:, len(own) - 1]
        return tuple(torch.as_tensor(a, device=probs.device) for a in
                     moe_plain_routing(probs, k, cap, idx.cpu().numpy()))
    moe._top_k_dispatch = spy
    try:
        yield
    finally:
        moe._top_k_dispatch = real


# The bf16 logit bound LOGIT_TOL holds here too. On an H100 (NVIDIA H100
# 80GB HBM3, 700 W) the decode path stood at most 0.3125 / 0.1211 from the
# sequence path at rwkv6 / hymba, and the sequence path alone, only its
# length changed, 0.2390 / 0.1016 from itself: bf16 drift through random
# weights.
FAMILY_SERVES = (
    ServeModel("rwkv6-7b", None, 8, (1024, 1536), 128, ((0, 64), (1, 64)),
               10, False),
    ServeModel("hymba-1.5b", None, 4, (960, 1100), 48, ((0, 16), (1, 24)),
               6, False),
    ServeModel("deepseek-v2-236b", 4, 8, (1024, 1536), 32, (), 10, False),
    ServeModel("phi3.5-moe-42b-a6.6b", 8, 8, (1024, 1536), 32, (), 10,
               False),
)
# The MoE token check's own serve: no token dropped on either path.
MOE_CHECK_REQUESTS, MOE_CHECK_NEW = 4, 16
# Hymba's first windowed layer (layer 0 is global).
HYMBA_LAYER = 1
# A model's state and its recomputations, both from the same bf16 inputs:
# RWKV's decode state against float64 within 1e-4 of its largest magnitude
# (float32 prefix sums of log-decays up to ~47 in a chunk, each exp off by
# up to a few 1e-6), and the Mamba state and conv window after one decode
# step against the sequential scan's over prompt + 1 within the same 1e-4
# (both float32 recurrences over the same projections); the MLA decode
# output and the MoE output against their recomputations within 2^-6 of
# the largest magnitude (a few bfloat16 steps: each side rounds its
# products to bfloat16 apart), the CPU tests' bfloat16 bound.
STATE_REL = 1e-4
BF16_REL = 2.0 ** -6


def rel_share(torch, got, want, rel: float) -> float:
    """max |got - want| as a share of ``rel`` of max |want|."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30) / rel)


def hold(fails: list, what: str, share: float) -> float:
    """Record a failure when ``share`` (of an allowance) passes 1."""
    if not share <= 1.0:
        fails.append(f"{what} at {share:.3f} of its allowance")
    return share


def layer_input(torch, cfg, params, tokens, upto: int):
    """The normed input of layer ``upto`` (its attention norm) over
    ``tokens`` [1, S], through the layers before it (the sequence path)."""
    from repro_torch.models import ShardCtx, layers, transformer
    sh = ShardCtx()
    x = layers.embed_tokens(cfg, params["embed"], tokens, sh)
    positions = torch.arange(tokens.shape[1], dtype=torch.float32,
                             device=x.device)
    windows = transformer._windows(cfg)
    for l in range(upto):
        x, _, _ = transformer._seq_block(cfg, sh, positions,
                                         transformer._layer(params, l), x,
                                         windows[l])
    p = transformer._layer(params, upto)
    return layers.rms_norm(x, p["attn"]["norm"], cfg.norm_eps), x, p


def rwkv_layer0(torch, ops, ref, cfg, params, prompt, tok, fails) -> dict:
    """rwkv6-7b, layer 0, on the model's activations of a prompt whose
    length is a multiple of the chunk: (a) kernel 5 (``ops.rwkv_chunk``)
    against the model's plain chunked scan within ``ref.kernel_error
    ("rwkv")``; (b) the decode state after one more token (the model's
    prefill state, then ``rwkv_decode_step``) against the float64 state of
    the recurrence over prompt + 1 on the same inputs (the prefill's
    log-decays rounded to bfloat16 as the model's time mix rounds them,
    the decode token's in float32 as its decode step keeps them), within
    STATE_REL of its largest magnitude."""
    from repro_torch.models import ShardCtx, rwkv
    sh = ShardCtx()
    seq = torch.cat([prompt, tok])[None]
    h, _, p = layer_input(torch, cfg, params, seq, 0)
    p = p["attn"]
    n, hh = prompt.shape[0], cfg.n_heads
    zero = h.new_zeros((1, cfg.d_model))
    r, k, v, _, logw = rwkv._projections(cfg, p, h[:, :n],
                                         rwkv._token_shift(h[:, :n], zero))
    heads = [rwkv._heads(t, hh).contiguous() for t in
             (r, k, v, logw.to(cfg.adtype))]
    got = ops.rwkv_chunk(*heads, p["u"], chunk=cfg.rwkv_chunk)
    want, _ = rwkv.rwkv_chunk_scan(*heads, p["u"], cfg.rwkv_chunk)
    k_err, k_share = ref.kernel_error("rwkv", got, want)
    hold(fails, "rwkv6-7b layer 0: ops.rwkv_chunk against the plain scan",
         k_share)
    _, _, state = rwkv.rwkv_time_mix(cfg, p, h[:, :n], sh, zero)
    _, _, state = rwkv.rwkv_decode_step(cfg, p, h[:, n:], sh, h[:, n - 1],
                                        state)
    _, k1, v1, _, lw1 = rwkv._projections(cfg, p, h[:, n:], h[:, n - 1:n])
    ks = torch.cat([k, k1], 1)
    vs = torch.cat([v, v1], 1)
    lw = torch.cat([logw.to(cfg.adtype).float(), lw1], 1)
    ks, vs, lw = (rwkv._heads(t.double(), hh)[0] for t in (ks, vs, lw))
    cum = lw.cumsum(1)                                   # [H, n+1, Dk]
    wk = ks * torch.exp(cum[:, -1:] - cum)
    want_s = torch.einsum("hsk,hsv->hkv", wk, vs)
    s_share = hold(fails, "rwkv6-7b layer 0: the decode state against "
                   "float64 over prompt + 1",
                   rel_share(torch, state[0], want_s, STATE_REL))
    return {"kernel": (k_err, k_share), "state": s_share, "s": n}


def moe_plain_routing(probs, k: int, cap: int, idx=None):
    """The reference's routing recomputed on the host, token by token:
    each token's k most probable experts (ties to the lower index; or the
    experts ``idx`` [T, k] where given), the gates over their float32 sum
    in order, then the slots numbered slot j = 0..k-1 in turn, token by
    token, counts carried."""
    import numpy as np
    P = probs.float().cpu().numpy()
    t, e = P.shape
    if idx is None:
        idx = np.array([sorted(range(e), key=lambda j: (-P[i, j], j))[:k]
                        for i in range(t)], np.int64).reshape(t, k)
    gates = np.empty((t, k), np.float32)
    for i in range(t):
        order = idx[i].tolist()
        total = np.float32(P[i, order[0]])
        for j in order[1:]:
            total = np.float32(total + P[i, j])
        gates[i] = P[i, order] / np.float32(max(total, np.float32(1e-9)))
    counts = np.zeros(e, np.int64)
    pos = np.empty((t, k), np.int64)
    keep = np.empty((t, k), bool)
    for j in range(k):
        for i in range(t):
            c = counts[idx[i, j]]
            keep[i, j] = c < cap
            pos[i, j] = min(c, cap - 1)
            counts[idx[i, j]] += 1
    return idx, gates, pos, keep


def moe_plain_out(torch, cfg, p, x, route):
    """The MoE FFN of tokens ``x`` [T, D] under the routing ``route``:
    each kept slot's expert SwiGLU in float32 from the bf16 weights, times
    its gate, summed a token; plus the shared experts."""
    idx, gates, _, keep = (torch.as_tensor(a, device=x.device)
                           for a in route)
    xf = x.float()
    out = torch.zeros_like(xf)
    silu = torch.nn.functional.silu
    ffn = lambda w, h: (silu(h @ w["w_gate"].float()) * (
        h @ w["w_in"].float())) @ w["w_out"].float()
    for e in torch.unique(idx[keep]).tolist():
        t, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        w = {n: p[n][e] for n in ("w_in", "w_gate", "w_out")}
        out.index_add_(0, t, ffn(w, xf[t]) * gates[t, j, None].float())
    if "shared" in p:
        out += ffn(p["shared"], xf)
    return out


def moe_layer0(torch, cfg, params, prompt, fails) -> dict:
    """An MoE model's layer 0 on its activations over a prompt: the MoE
    call at the prefill's shape (every token, its capacity) and at the
    decode step's (8 consecutive tokens a call, capacity 4 for both
    models): ``idx``, ``gates``, ``pos`` and ``keep`` equal to
    ``moe_plain_routing`` exactly, the output within BF16_REL of
    ``moe_plain_out``. Some slots must be dropped over these calls, so
    that the keep mask is seen at work."""
    from repro_torch.models import ShardCtx, layers, mla, moe, transformer
    sh = ShardCtx()
    seq = prompt[None]
    h, x, p = layer_input(torch, cfg, params, seq, 0)
    positions = torch.arange(seq.shape[1], dtype=torch.float32,
                             device=h.device)
    attn = (mla.mla_attention if cfg.attn_type == "mla"
            else layers.gqa_attention)
    a, _ = attn(cfg, p["attn"], h, sh, positions,
                transformer._windows(cfg)[0])
    # the MoE's input: layer 0's residual after attention, normed
    h2 = layers.rms_norm(x + a, p["mlp"]["norm"], cfg.norm_eps)
    calls = [h2] + [h2[0, i:i + 8, None] for i in
                    range(0, h2.shape[1] - 7, 8)][:64]
    seen = {"calls": 0, "dropped": 0, "out": 0.0, "tokens": 0}
    real = moe._top_k_dispatch
    for xin in calls:
        rec = {}

        def spy(probs, k, cap):
            out = real(probs, k, cap)
            rec.update(probs=probs, cap=cap, out=out)
            return out
        moe._top_k_dispatch = spy
        try:
            got, _ = moe.moe_block(cfg, p["mlp"], xin, sh)
        finally:
            moe._top_k_dispatch = real
        plain = moe_plain_routing(rec["probs"], cfg.moe.top_k, rec["cap"])
        for name, a_, b_ in zip(("idx", "gates", "pos", "keep"),
                                rec["out"], plain):
            if not (a_.cpu().numpy() == b_).all():
                fails.append(f"{cfg.name} layer 0: the MoE's {name} differs "
                             f"from the plain routing at {xin.shape[0]} x "
                             f"{xin.shape[1]} tokens (capacity {rec['cap']})")
        want = moe_plain_out(torch, cfg, p["mlp"], xin.reshape(
            -1, cfg.d_model), plain).reshape(got.shape)
        seen["out"] = max(seen["out"], rel_share(torch, got, want, BF16_REL))
        seen["dropped"] += int((~plain[3]).sum())
        seen["calls"] += 1
        seen["tokens"] += xin.shape[0] * xin.shape[1]
    hold(fails, f"{cfg.name} layer 0: the MoE output against its plain "
         f"recomputation (share of {BF16_REL})", seen["out"])
    if not seen["dropped"]:
        fails.append(f"{cfg.name} layer 0: no slot dropped in "
                     f"{seen['calls']} MoE calls; the keep mask is unseen")
    return seen


def mla_f64(torch, cfg, p, x, c_kv, k_rope, kv_len):
    """MLA attention of one token a lane over the latent cache with
    per-head K and V materialised from it (the prefill form), float64 from
    the same bf16 weights and inputs. x [B,1,D]; c_kv [B,S,R]; k_rope
    [B,S,rope] -> [B,1,D]."""
    m, h = cfg.mla, cfg.n_heads
    f = {k: v.double() for k, v in p.items()}
    b = x.shape[0]
    cq = x.double() @ f["wq_a"]
    cq = cq * torch.rsqrt((cq * cq).mean(-1, keepdim=True)
                          + cfg.norm_eps) * f["q_norm"]
    q = (cq @ f["wq_b"]).reshape(b, h, -1)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    i = torch.arange(0, m.rope_head_dim, 2, dtype=torch.float64,
                     device=x.device)
    ang = (kv_len - 1).double()[:, None, None] * cfg.rope_theta ** (
        -i / m.rope_head_dim)
    q1, q2 = q_rope.chunk(2, -1)
    q_rope = torch.cat([q1 * ang.cos() - q2 * ang.sin(),
                        q2 * ang.cos() + q1 * ang.sin()], -1)
    ckv = c_kv.double()
    k_nope = torch.einsum("bsr,rhn->bhsn", ckv, f["wk_b"].reshape(
        m.kv_lora_rank, h, m.nope_head_dim))
    v = torch.einsum("bsr,rhn->bhsn", ckv, f["wv_b"].reshape(
        m.kv_lora_rank, h, m.v_head_dim))
    logits = (torch.einsum("bhn,bhsn->bhs", q_nope, k_nope)
              + torch.einsum("bhr,bsr->bhs", q_rope, k_rope.double())) * \
        (m.nope_head_dim + m.rope_head_dim) ** -0.5
    mask = torch.arange(ckv.shape[1], device=x.device)[None, None, :] < \
        kv_len[:, None, None]
    att = torch.where(mask, logits, -math.inf).softmax(-1)
    o = torch.einsum("bhs,bhsn->bhn", att, v).reshape(b, 1, -1)
    return o @ f["wo"]


def mla_decode_layer0(torch, cfg, params, reqs, spy, fails) -> dict:
    """deepseek-v2, layer 0 at the spied decode step: (a) the absorbed
    ``mla_decode`` output against ``mla_f64`` over the same latent cache
    and lengths (live lanes), within BF16_REL; (b) each live lane's cache
    rows [0, pos] (latent and RoPE key) against the sequence path's layer
    0 over its tokens, within CACHE_REL of their largest magnitude (a row
    written at another position stands the whole value apart)."""
    from repro_torch.models import layers, mla
    live = [i for i, rid in enumerate(spy["lanes"]) if rid is not None]
    p = spy["p"]
    want = mla_f64(torch, cfg, p, spy["x"][live], spy["c_kv"][live],
                   spy["k_rope"][live], spy["kv_len"][live])
    out = {"absorbed": hold(fails, "deepseek-v2 layer 0: the absorbed "
                            "decode against float64 materialised attention",
                            rel_share(torch, spy["out"][live], want,
                                      BF16_REL)),
           "cache": 0.0, "lanes": len(live)}
    byrid = {r.rid: r for r in reqs}
    for i in live:
        req, pos = byrid[spy["lanes"][i]], spy["pos"][i]
        toks = (list(req.prompt) + req.out)[:pos + 1]
        h, _, _ = layer_input(torch, cfg, params, torch.as_tensor(
            toks, dtype=torch.int32, device=p["wq_a"].device)[None], 0)
        c_kv, k_rope = mla._project_kv_latent(cfg, p, h)
        cos, sin = layers.rope_tables(torch.arange(
            pos + 1, dtype=torch.float32, device=h.device),
            cfg.mla.rope_head_dim, cfg.rope_theta)
        k_rope = layers.apply_rope(k_rope, cos, sin)[:, 0]
        for name, got, w in (("c_kv", spy["c_kv"][i, :pos + 1], c_kv[0]),
                             ("k_rope", spy["k_rope"][i, :pos + 1],
                              k_rope[0])):
            out["cache"] = max(out["cache"], hold(
                fails, f"deepseek-v2 layer 0: lane {i}'s cache {name} rows "
                f"(pos {pos}) against the sequence path",
                rel_share(torch, got, w, CACHE_REL)))
    return out


def hymba_layer1(torch, ops, ref, cfg, params, reqs, spy, fails) -> dict:
    """hymba-1.5b, layer 1 (a local layer, window 1,024): (a)
    ``ops.flash_attention`` against ``chunked_attention`` on the layer's
    q, k, v over the longest request's tokens padded to a multiple of 128
    (past the window); (b) at the spied decode step, where a live lane's
    ring has wrapped: the length ``dist_decode`` saw equal to min(pos + 1,
    1,024) in every lane, ``ops.decode_attention`` over the ring against
    ``dist_decode`` within ``ref.kernel_error``, and ``dist_decode``
    within the float32 allowance of float64 attention over the ring's
    valid slots; (c) the Mamba state after one decode token (the prefill
    form's state, then one step) against the sequential scan over prompt +
    1 on the same inputs, within STATE_REL."""
    from repro_torch.models import ShardCtx, layers, mamba, transformer
    from repro_torch.models.chunked_attention import chunked_attention
    sh = ShardCtx()
    dev = params["final_norm"].device
    req = max(reqs, key=lambda r: len(r.prompt))
    toks = list(req.prompt) + req.out
    toks += [0] * (-len(toks) % LAYER0_BLOCK)
    h, _, p = layer_input(torch, cfg, params, torch.as_tensor(
        toks, dtype=torch.int32, device=dev)[None], HYMBA_LAYER)
    p = p["attn"]
    window = transformer._windows(cfg)[HYMBA_LAYER]
    q, k, v = layers.gqa_project(cfg, p, h, cfg.adtype)
    cos, sin = layers.rope_tables(torch.arange(
        h.shape[1], dtype=torch.float32, device=dev), cfg.head_dim_,
        cfg.rope_theta)
    q, k = layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)
    v = v.contiguous()
    out = {"s": h.shape[1], "window": window}
    flash = ops.flash_attention(q, k, v, causal=True, window=window)
    attn = chunked_attention(q, k, v, causal=True, window=window)
    out["flash"] = ref.kernel_error("attention", flash, attn)
    hold(fails, "hymba-1.5b layer 1: ops.flash_attention against "
         "chunked_attention", out["flash"][1])
    size = spy["k"].shape[2]
    pos = torch.as_tensor(spy["pos"], device=dev)
    eff = torch.clamp(pos + 1, max=size).to(torch.int32)
    live = [i for i, rid in enumerate(spy["lanes"]) if rid is not None]
    if not torch.equal(spy["kv_len"][live].int(), eff[live]):
        fails.append(f"hymba-1.5b layer {HYMBA_LAYER}: dist_decode over the "
                     f"ring saw lengths {spy['kv_len'][live].tolist()}, "
                     f"expected min(pos + 1, {size}) = {eff[live].tolist()}")
    dec = ops.decode_attention(spy["q"], spy["k"], spy["v"], eff)
    out["decode"] = ref.kernel_error("attention", dec[live],
                                     spy["out"][live].to(dec.dtype))
    hold(fails, "hymba-1.5b layer 1: ops.decode_attention over the ring "
         "against dist_decode", out["decode"][1])
    d64 = 0.0
    for i in live:
        want = attention_f64(torch, spy["q"][i], spy["k"][i], spy["v"][i],
                             int(eff[i]), None)
        d64 = max(d64, ref.kernel_error("attention", spy["out"][i],
                                        want.float())[1])
    out["dist"] = hold(fails, "hymba-1.5b layer 1: dist_decode against "
                       "float64 attention over the ring's valid slots", d64)
    out["wrapped"] = int(pos[live].max()) + 1 - size
    # (c) the Mamba state over prompt + 1, on the sequence path's inputs
    n = len(req.prompt)
    xn = h[:, :n + 1]
    _, conv_a, ssm_a = mamba.mamba_mix(cfg, p["mamba"], xn[:, :n], sh)
    _, conv_b, ssm_b = mamba.mamba_mix(cfg, p["mamba"], xn[:, n:], sh,
                                       conv_state=conv_a, ssm_state=ssm_a)
    _, conv_c, ssm_c = mamba.mamba_mix(cfg, p["mamba"], xn, sh)
    out["ssm"] = hold(fails, "hymba-1.5b layer 1: the Mamba decode state "
                      "against the sequential scan over prompt + 1",
                      rel_share(torch, ssm_b, ssm_c, STATE_REL))
    out["conv"] = hold(fails, "hymba-1.5b layer 1: the conv state against "
                       "the sequential scan's",
                       rel_share(torch, conv_b, conv_c, STATE_REL))
    return out


def serve_engine(torch, dev, rt, cfg, row: ServeModel, params, reqs):
    """A ``ServeEngine`` with ``launch/serve.py``'s emulator settings,
    ``reqs`` submitted, and ``instrument_serve``'s log."""
    from repro_torch.memtier import ServeEngine
    from repro_torch.memtier.engine import Request
    emu = rt.EmulatorConfig(n_fast_pages=64, n_slow_pages=4096, chunk=64,
                            policy="hotness", hot_threshold=4)
    eng = ServeEngine(cfg, params, batch_size=row.batch, smax=SERVE_SMAX,
                      emu_cfg=emu, policy="hotness", pin_pages_per_seq=1,
                      device=dev)
    reqs = [Request(rid=r, prompt=p, max_new_tokens=m) for r, p, m in reqs]
    for r in reqs:
        eng.submit(r)
    return eng, reqs, instrument_serve(torch, eng)


def layer_checks(torch, ops, ref, cfg, params, reqs, log, layer,
                 fails) -> None:
    """The checks in the layer where each family's fault would happen."""
    dev = params["final_norm"].device
    fam, spy = cfg.attn_type, log["spy"]
    if fam != "rwkv6" and spy is None:
        fails.append("no decode call of the checked layer was recorded")
        return
    if fam == "rwkv6":
        r0 = reqs[-1]
        layer.update(rwkv_layer0(
            torch, ops, ref, cfg, params,
            torch.as_tensor(r0.prompt, device=dev),
            torch.as_tensor(r0.out[:1], device=dev, dtype=torch.int32),
            fails))
    elif fam == "hymba":
        layer.update(hymba_layer1(torch, ops, ref, cfg, params, reqs, spy,
                                  fails))
    elif fam == "mla":
        layer["mla"] = mla_decode_layer0(torch, cfg, params, reqs, spy,
                                         fails)
    else:
        prompt = reqs[-1].prompt
        try:
            layer["gqa"] = check_layer0(torch, ops, ref, cfg, params,
                                        torch.as_tensor(prompt[:len(
                                            prompt) // LAYER0_BLOCK
                                            * LAYER0_BLOCK], device=dev),
                                        spy)
            layer["gqa_decode"] = check_decode_layer0(torch, ref, cfg,
                                                      params, reqs, spy)
        except Mismatch as exc:
            fails.append(str(exc))
    if cfg.moe:
        layer["moe"] = moe_layer0(torch, cfg, params, torch.as_tensor(
            reqs[-1].prompt, device=dev), fails)


def model_serve(torch, dev, rt, kernels, row: ServeModel, card: str
                ) -> dict:
    """Phase 10 or 11 at one configuration: see the module docstring.
    Returns each kernel's launches over the serve; raises once, naming
    each check that failed."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.models import init_params, layers, transformer
    cfg = configs.get(row.arch)
    if row.layers:
        cfg = cfg.with_(n_layers=row.layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    eng, reqs, log = serve_engine(torch, dev, rt, cfg, row, params,
                                  serve_requests(row, cfg))
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    steps = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    fails = []
    if counts != {**{n: 0 for n in kernels}, "chunk_step": steps}:
        fails.append(f"launches {counts} over {steps} decode steps; "
                     "expected kernel B once a step and no other")
    if not all(r.done for r in reqs):
        fails.append("a request did not finish")
    if row.idle and log["idle_pos"] < SERVE_SMAX:
        fails.append(f"no idle lane's pos passed {SERVE_SMAX} (largest "
                     f"{log['idle_pos']})")
    t1 = time.perf_counter()
    rep = check_replay(torch, rt, eng, log["tier_calls"])
    # Kernel B's device time a step: the recorded streams replayed on the
    # card under CUPTI, the same launches on the same inputs as the run's.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay_tier(rt, eng.tier, log["tier_calls"], dev)
        torch.cuda.synchronize()
    b_us, b_traced = trace_us(prof, lambda key: "chunk_step_kernel" in key)
    del prof
    # The layer where each family's fault would happen, first: a fault
    # there is named by the check that sees it alone, before the layers
    # above carry it into the logits.
    t2 = time.perf_counter()
    layer = {}
    with layers.fp32_sums():
        layer_checks(torch, ops, ref, cfg, params, reqs, log, layer, fails)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    # The tokens against the sequence path. MoE: a second, shorter serve
    # with no token dropped on either path (capacity n_experts / top_k).
    try:
        if cfg.moe:
            e = cfg.moe
            ccfg = cfg.with_(moe=dataclasses.replace(
                e, capacity_factor=e.n_experts / e.top_k))
            crow = row._replace(requests=MOE_CHECK_REQUESTS,
                                new=MOE_CHECK_NEW)
            ceng, creqs, clog = serve_engine(
                torch, dev, rt, ccfg, crow, params,
                serve_requests(crow, ccfg, 1))
            routes = {}
            record_serve_routes(ceng, routes)
            ceng.run()
            del ceng
            tok = check_tokens(torch, ccfg, params, creqs, clog, routes)
        else:
            tok = check_tokens(torch, cfg, params, reqs, log)
    except Mismatch as exc:
        fails.append(str(exc))
        tok = None
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    # The model's own device time a decode step: two more steps on the
    # engine's final cache under CUPTI, every kernel counted.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            transformer.decode_step(cfg, params, eng.tokens, eng.cache,
                                    eng.pos, eng.sh)
        torch.cuda.synchronize()
    m_us, m_kernels = trace_us(prof, lambda key: True)
    del prof
    mean = lambda xs: sum(xs) / len(xs)
    pre_ms = [ms for ms, _, _ in log["prefill"][1:]]   # after the first
    tok_s = [n / ms * 1e3 for ms, n, _ in log["prefill"][1:]]
    model, build, acc, step_ms = (mean(log[k]) for k in (
        "decode_ms", "build_ms", "account_ms", "step_ms"))
    b_ms = b_us / 1e3 / steps
    depth = (f"{cfg.n_layers} of {configs.get(row.arch).n_layers} layers"
             if row.layers else f"{cfg.n_layers} layers")
    print(f"  {row.arch}: {depth}, {pbytes} parameter bytes (bf16), "
          f"init_params {init_s:.3f} s; peak device memory {peak} B; "
          f"{len(reqs)} requests, batch {row.batch}, smax {SERVE_SMAX}: "
          f"{steps} decode steps in {wall:.3f} s "
          f"({max(0, len(reqs) - row.batch)} admitted into a live batch); "
          f"launches {counts} [{card}]", flush=True)
    print(f"  prefill {mean(pre_ms):.3f} ms a request ({min(pre_ms):.3f}.."
          f"{max(pre_ms):.3f}; the first {log['prefill'][0][0]:.3f}), "
          f"{mean(tok_s):.0f} tokens/s; a decode step {step_ms:.3f} ms "
          f"wall: model {model:.3f} (decode_step, synchronised), stream "
          f"building {build:.3f}, account {acc:.3f}, the rest (argmax, one "
          f"read back, bookkeeping) {step_ms - model - build - acc:.3f}; "
          f"kernel B {b_ms:.4f} ms a step (device, CUPTI over a replay of "
          f"the run's streams on the card; {b_traced} of {steps} launches "
          f"traced), {b_ms / step_ms:.4f} of the step; the model's device "
          f"time a step {m_us / 2e3:.3f} ms in {m_kernels // 2} kernels "
          f"(CUPTI, 2 steps), {m_us / 2e3 / model:.4f} of its wall "
          f"[{card}]", flush=True)
    if cfg.moe:
        d = log["drops"]
        print(f"  MoE (capacity factor {cfg.moe.capacity_factor}): live "
              f"lanes' slots dropped a step over {cfg.n_layers} layers: "
              f"mean {mean(d):.2f}, max {max(d)}, {sum(d)} in all; by step "
              f"{d}", flush=True)
    if tok is not None:
        flips = (f"; {tok['flipped']} rows whose experts differ between "
                 "the two paths, held with the sequence path routed as the "
                 "decode path" if cfg.moe else "")
        print(f"  tokens{' (no-drop serve)' if cfg.moe else ''}: "
              f"{tok['checked']} of {tok['total']} held to the sequence "
              f"path's argmax (top-2 margin above {LOGIT_TOL}; median "
              f"margin {tok['median_margin']:.4f}); decode-path logits "
              f"within {tok['worst']:.4f} of it (median row "
              f"{tok['median_diff']:.4f}; the sequence path over the prompt "
              f"alone within {tok['floor']:.4f}; largest |logit| "
              f"{tok['scale']:.3f}){flips}", flush=True)
    idle = (f"largest idle pos {log['idle_pos']} (smax {SERVE_SMAX}); "
            if row.idle else "")
    print(f"  {idle}report ({rep['requests']} requests, migrations "
          f"{rep['migrations']}, pinned fast hit rate "
          f"{rep['pinned_fast_hit_rate']:.4f}, free fast/slow "
          f"{rep['fast_free']}/{rep['slow_free']}) and every state field "
          f"bitwise equal to the CPU replay; checks took replays "
          f"{t2 - t1:.1f} s, layer {t3 - t2:.1f} s, tokens {t4 - t3:.1f} s",
          flush=True)
    for line in layer_lines(layer):
        print(f"  {line}", flush=True)
    del eng, params
    if fails:
        raise Mismatch(f"{row.arch}: " + "; ".join(fails))
    return counts


def layer_lines(layer: dict) -> list:
    """The printed lines of ``layer_checks``' readings."""
    out = []
    if "gqa" in layer:
        l0 = layer["gqa"]
        f, d = l0["flash"], l0["decode"]
        out.append(f"layer 0 ({l0['s']} tokens, window {l0['window']}): "
                   f"rms_norm equal to its float32 formula, RoPE within one "
                   f"bfloat16 step of the rotation; ops.flash_attention "
                   f"against chunked_attention {f[0]:.3e} ({f[1]:.3f} of its "
                   f"allowance), ops.decode_attention against dist_decode "
                   f"{d[0]:.3e} ({d[1]:.3f})")
    if "gqa_decode" in layer:
        dl0 = layer["gqa_decode"]
        out.append(f"layer 0 at decode step {SPY_STEP}, {dl0['lanes']} "
                   f"live lanes against the sequence path: q within "
                   f"{dl0['q']:.3f} and the cache rows within "
                   f"{dl0['cache']:.3f} of {CACHE_REL} of the largest "
                   f"magnitude; dist_decode at "
                   f"{dl0['dist']:.3f} of the float32 allowance of float64 "
                   f"attention over the engine's pos + 1 rows, "
                   f"chunked_attention's row at {dl0['chunked']:.3f} of the "
                   f"bfloat16 allowance; the two paths' outputs "
                   f"{dl0['paths']:.3e} apart")
    if "kernel" in layer:
        out.append(f"layer 0 ({layer['s']} tokens): ops.rwkv_chunk (kernel "
                   f"5) against the model's scan {layer['kernel'][0]:.3e} "
                   f"({layer['kernel'][1]:.3f} of its allowance); the decode "
                   f"state at {layer['state']:.3f} of {STATE_REL} of float64")
    if "ssm" in layer:
        f, d = layer["flash"], layer["decode"]
        out.append(f"layer {HYMBA_LAYER} (window {layer['window']}, "
                   f"{layer['s']} tokens): ops.flash_attention against "
                   f"chunked_attention {f[0]:.3e} ({f[1]:.3f}); over the "
                   f"ring (wrapped by {layer['wrapped']} slots): "
                   f"ops.decode_attention against dist_decode {d[0]:.3e} "
                   f"({d[1]:.3f}), dist_decode at {layer['dist']:.3f} of the "
                   f"float32 allowance of float64; Mamba state "
                   f"{layer['ssm']:.3e}, conv {layer['conv']:.3e} of "
                   f"{STATE_REL}")
    if "mla" in layer:
        a = layer["mla"]
        out.append(f"layer 0, MLA at decode step {SPY_STEP}, {a['lanes']} "
                   f"live lanes: absorbed decode at {a['absorbed']:.3f} of "
                   f"{BF16_REL} of float64 materialised attention, cache "
                   f"rows at {a['cache']:.3f} of {CACHE_REL}")
    if "moe" in layer:
        m = layer["moe"]
        out.append(f"layer 0: MoE routing equal to the plain routing in "
                   f"{m['calls']} calls ({m['tokens']} tokens, {m['dropped']}"
                   f" slots dropped), output at {m['out']:.3f} of "
                   f"{BF16_REL}")
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def check_model_serve(torch, dev, rt, kernels, card: str, rows) -> dict:
    """Every check of phase 10 or 11 (see the module docstring) over the
    models ``rows``, each model's weights freed before the next one's are
    drawn. Returns each kernel's launches over the models' runs; raises
    once, naming every model that failed and each of its checks."""
    out, fails = {}, []
    for row in rows:
        try:
            out[row.arch] = model_serve(torch, dev, rt, kernels, row, card)
        except Mismatch as exc:
            print(f"  FAILED: {exc}", flush=True)
            fails.append(str(exc))
        torch.cuda.empty_cache()
    if fails:
        raise Mismatch(" | ".join(fails))
    return {name: sum(c[name] for c in out.values()) for name in kernels}


# --------------------------------------------------------------- phase 12
# Training at full width: internlm2-1.8b whole (``configs/internlm2_1p8b``),
# bfloat16 parameters from a seed with float32 moments, the port's Markov
# data at batch 4 x 2,048 tokens in 2 micro-batches, 8 steps through
# ``launch.steps.make_train_step`` at ``launch/train.py``'s schedule
# (warmup min(20, steps // 5), cosine to the 8th step).
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 2048, 2, 8
TRAIN_LR = 3e-4
TRAIN_SPY_STEP = 0        # layer 0's gradients, at the first step
TRAIN_ADAMW_STEP = 1      # the AdamW holds, at the second
# Layer 0's bfloat16 gradients (and dx) against float64 over the same
# inputs: ||g - g64|| / ||g64||. Each product rounds to bfloat16 once
# (2^-9 of a value at most), a few times along a gradient's path, in
# float32 sums: 2^-5 leaves room for some ten such roundings.
GRAD_REL = 2.0 ** -5
# chunked_attention's bfloat16 dq, dk, dv against float64 autograd of the
# S x S form on the same bfloat16 q, k, v and upstream gradient: one
# rounding of float32 sums to bfloat16 each (2^-9), with 2^-3 of margin.
ATTN_GRAD_REL = 2.0 ** -6
# AdamW against its formula in float64 at the step's own inputs: the
# moments within a few float32 ulps of their terms (2^-21 of b1 |mu| + (1
# - b1) |g|, and the same for nu), a bfloat16 parameter within half a
# bfloat16 step (2^-8 of it) plus float32 noise (2^-20 of |p| + lr |delta|).
ADAMW_MOMENT_REL = 2.0 ** -21
ADAMW_PARAM_REL = 2.0 ** -8
# The crash-and-resume run: the first 2 of internlm2-1.8b's 24 layers at
# full width, through ``launch.train.run``: 8 steps, a checkpoint every
# 4, a crash at 4, a resume to 8, and an uninterrupted run. The final
# losses within the reference's own bar (``tests/test_system.py``), and
# the parameters bit for bit: the loss moves so little in 8 steps that
# a resume replaying steps 0-3 stays within 1e-5 of it (3.5e-6 measured).
RESUME_LAYERS = 2
RESUME_RTOL = 1e-5


def leaf_items(tree, path=""):
    """(path, tensor) pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def rel_norm(torch, got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp_min(1e-300))


def norm_f64(cfg, t, w):
    """RMS norm in float64."""
    return t * (t * t).mean(-1, keepdim=True).add(cfg.norm_eps).rsqrt() * w


def rope_f64(torch, cfg, t):
    """RoPE on each half pair at positions 0..S-1, in float64."""
    hd, s = t.shape[-1], t.shape[-2]
    i = torch.arange(0, hd, 2, dtype=torch.float64, device=t.device)
    ang = torch.arange(s, dtype=torch.float64, device=t.device)[:, None] \
        * cfg.rope_theta ** (-i / hd)
    t1, t2 = t.chunk(2, dim=-1)
    return torch.cat([t1 * ang.cos() - t2 * ang.sin(),
                      t2 * ang.cos() + t1 * ang.sin()], dim=-1)


def gqa_f64(torch, cfg, a, h, window):
    """Grouped attention of the normed input ``h`` [B, S, D] in float64:
    the projections, RoPE and causal (windowed) attention at scale
    D^-0.5; the heads' outputs [B, Hq, S, D] (before ``wo``)."""
    b, s, _ = h.shape
    hd, hq, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    q = rope_f64(torch, cfg, (h @ a["wq"]).reshape(b, s, hq, hd)
                 .transpose(1, 2))
    k = rope_f64(torch, cfg, (h @ a["wk"]).reshape(b, s, hkv, hd)
                 .transpose(1, 2))
    v = (h @ a["wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    return naive_f64(torch, q, k, v, window)


def swiglu_f64(torch, m, h):
    g = h @ m["w_gate"]
    return (g * torch.sigmoid(g) * (h @ m["w_in"])) @ m["w_out"]


def layer0_f64(torch, cfg, p, x, window, keep: dict):
    """Layer 0 of a GQA + SwiGLU model (internlm2) written out in float64
    from its formulas, independent of the port's layers: RMS norms, RoPE
    on each half pair, causal (windowed) grouped attention at scale
    D^-0.5, SwiGLU. ``keep`` gets the attention output (its gradient is
    retained)."""
    b, s, _ = x.shape
    a = p["attn"]
    o = gqa_f64(torch, cfg, a, norm_f64(cfg, x, a["norm"]), window)
    o.retain_grad()
    keep["o"] = o
    x1 = x + o.transpose(1, 2).reshape(b, s, -1) @ a["wo"]
    return x1 + swiglu_f64(torch, p["mlp"], norm_f64(cfg, x1,
                                                     p["mlp"]["norm"]))


def naive_f64(torch, q, k, v, window):
    """Causal (windowed) grouped attention of [B, Hq, S, D] over [B, Hkv,
    S, D] in float64, S x S logits."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    qg = q.double().reshape(b, hkv, hq // hkv, s, hd)
    logits = torch.einsum("bkgqd,bktd->bkgqt", qg, k.double()) * hd ** -0.5
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    ok = ki <= qi
    if window is not None:
        ok &= qi - ki < window
    logits = logits.masked_fill(~ok, -math.inf)
    out = torch.einsum("bkgqt,bktd->bkgqd", logits.softmax(-1), v.double())
    return out.reshape(b, hq, s, v.shape[-1])


def spy_layer0(torch, transformer, params, rec: dict):
    """Wrap ``transformer._train_block`` so that layer 0's first call with
    autograd recording (the first micro-batch of the step where ``rec``
    is armed) keeps its input and hooks the gradients arriving at its
    input, its output (and its MoE aux loss) and each of its parameters;
    a MoE layer's routing is kept too. Returns the original."""
    real = transformer._train_block
    ptr = params["layers"]["attn"]["norm"].data_ptr()

    def block(cfg, sh, positions, p, x, window):
        take = rec.get("armed") and "x" not in rec and \
            p["attn"]["norm"].data_ptr() == ptr
        if take:
            rec["x"] = x.detach().clone()
            rec["grads"] = {}
            x.register_hook(lambda g: rec.__setitem__("dx", g.detach()))
            for path, t in leaf_items(p):
                t.register_hook(lambda g, path=path:
                                rec["grads"].__setitem__(path, g.detach()))
        if take and cfg.moe:
            out, aux = routed(cfg, sh, positions, p, x, window)
        else:
            out, aux = real(cfg, sh, positions, p, x, window)
        if take:
            out.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
            if aux.requires_grad:
                aux.register_hook(
                    lambda g: rec.__setitem__("daux", g.detach()))
        return out, aux

    def routed(*args):
        # the MoE's routing of layer 0 (expert, gate, slot, kept)
        from repro_torch.models import moe
        dispatch = moe._top_k_dispatch

        def recorded(probs, k, cap):
            out = dispatch(probs, k, cap)
            rec["route"] = tuple(t.detach() for t in out)
            return out
        moe._top_k_dispatch = recorded
        try:
            return real(*args)
        finally:
            moe._top_k_dispatch = dispatch

    transformer._train_block = block
    return real


def check_layer0_grads(torch, cfg, p0, rec, fails) -> dict:
    """Layer 0 (its parameters ``p0`` as the step saw them) recomputed in
    float64 from the recorded input and the gradient at its output: each
    parameter gradient and dx of the step against it (``GRAD_REL``).
    Returns the readings and what the attention check needs."""
    from repro_torch.models import transformer
    p64 = {k: {n: t.detach().double().requires_grad_()
               for n, t in v.items()} for k, v in p0.items()}
    x64 = rec["x"].double().requires_grad_()
    keep = {}
    window = (transformer.layer_windows(cfg) or [None])[0]
    y = layer0_f64(torch, cfg, p64, x64, window, keep)
    y.backward(rec["dy"].double())
    shares = {}
    for path, t in leaf_items(p64):
        shares[path] = rel_norm(torch, rec["grads"][path], t.grad) / GRAD_REL
    shares["dx"] = rel_norm(torch, rec["dx"], x64.grad) / GRAD_REL
    for path, share in shares.items():
        hold(fails, f"training: layer 0's gradient {path} against float64",
             share)
    return {"shares": shares, "d_o": keep["o"].grad, "window": window}


def check_attention_grads(torch, ops, ref, fa, cfg, a, rec, d_o, window,
                          fails) -> dict:
    """On layer 0's own q, k, v (the port's projections and RoPE of the
    recorded input, bfloat16) and the gradient at the attention output:
    ``chunked_attention``'s backward against float64 autograd of the S x S
    form (``ATTN_GRAD_REL``), and ``ops.flash_attention``'s gradient
    (kernel 3's forward, the plain recompute's backward) against it
    within ``ref.kernel_error``'s allowance. Kernel 3's launches in this
    check are counted."""
    from repro_torch.models import layers
    from repro_torch.models.chunked_attention import chunked_attention
    with torch.no_grad():
        h = layers.rms_norm(rec["x"], a["norm"], cfg.norm_eps)
        q, k, v = layers.gqa_project(cfg, a, h, cfg.adtype)
        pos = torch.arange(q.shape[2], dtype=torch.float32, device=q.device)
        cos, sin = layers.rope_tables(pos, cfg.head_dim_, cfg.rope_theta)
        q, k = layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin)
        v = v.contiguous()
    g = d_o.to(cfg.adtype)

    def grads(fn, *ins):
        ins = [t.detach().requires_grad_() for t in ins]
        out = fn(*ins)
        return torch.autograd.grad(out, ins, g.to(out.dtype))
    chunked = grads(lambda *t: chunked_attention(*t, causal=True,
                                                 window=window), q, k, v)
    want = grads(lambda *t: naive_f64(torch, *t, window), q.double(),
                 k.double(), v.double())
    out = {"chunked": {}, "flash": {}}
    for name, a_, w in zip(("dq", "dk", "dv"), chunked, want):
        out["chunked"][name] = hold(
            fails, f"training: chunked_attention's attention backward "
            f"{name} against float64", rel_norm(torch, a_, w) / ATTN_GRAD_REL)
    before = fa.KERNEL.launches
    flash = grads(lambda *t: ops.flash_attention(*t, causal=True,
                                                 window=window), q, k, v)
    torch.cuda.synchronize()
    out["flash_launches"] = fa.KERNEL.launches - before
    for name, a_, w in zip(("dq", "dk", "dv"), flash, chunked):
        out["flash"][name] = hold(
            fails, f"training: ops.flash_attention's gradient {name} "
            f"against chunked_attention's",
            ref.kernel_error("attention", a_, w)[1])
    if out["flash_launches"] < 1:
        fails.append("training: ops.flash_attention launched kernel 3 no "
                     "time")
    return out


ADAMW_LEAVES = ("/embed/tokens", "/final_norm", "/layers/attn/wq")


def adamw_leaf(tree, path: str):
    """A leaf of ``ADAMW_LEAVES``: layer 0's slice of ``wq``."""
    t = dict(leaf_items(tree))[path]
    return t[0] if path.startswith("/layers") else t


def spy_adamw(torch, steps, rec: dict):
    """Wrap ``launch.steps.adamw_update`` so that the step where ``rec``
    is armed keeps, for ``ADAMW_LEAVES``, the parameters, gradients and
    moments before the update and the parameters and moments after it,
    with the step counter and the global norm. Returns the original."""
    real = steps.adamw_update

    def update(cfg, params, grads, state):
        armed = rec.get("armed")
        if armed:
            rec["before"] = {path: tuple(
                adamw_leaf(t, path).detach().clone()
                for t in (params, grads, state.mu, state.nu))
                for path in ADAMW_LEAVES}
            rec["step"] = int(state.step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = real(cfg, params, grads, state)
        if armed:
            torch.cuda.synchronize()
            rec["ms"] = (time.perf_counter() - t0) * 1e3
            p, st, m = out
            rec["after"] = {path: tuple(adamw_leaf(t, path).detach().clone()
                                        for t in (p, st.mu, st.nu))
                            for path in ADAMW_LEAVES}
            rec["gn"] = m["grad_norm"].detach().clone()
            rec["armed"] = False
        return out

    steps.adamw_update = update
    return real


def bits(torch, t):
    """A float tensor's bits as integers (NaNs compare by their bits)."""
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def adamw_f64(torch, cfg, p, g, mu, nu, gn, t: int):
    """AdamW from its formula in float64 at step t (bias corrections
    1 - b^t, the warmup-cosine rate at t): (p, mu, nu, lr * delta)."""
    f = lambda x: x.double()
    scale = min(1.0, cfg.clip_norm / max(float(gn), 1e-9))
    gc = f(g) * scale
    mu2 = cfg.b1 * f(mu) + (1 - cfg.b1) * gc
    nu2 = cfg.b2 * f(nu) + (1 - cfg.b2) * gc * gc
    if t < cfg.warmup_steps:
        lr = cfg.lr_peak * t / max(1, cfg.warmup_steps)
    else:
        prog = min(1.0, max(0.0, (t - cfg.warmup_steps)
                            / max(1, cfg.total_steps - cfg.warmup_steps)))
        lr = cfg.lr_peak * 0.5 * (1 + math.cos(math.pi * prog))
    delta = (mu2 / (1 - cfg.b1 ** t)) / (
        torch.sqrt(nu2 / (1 - cfg.b2 ** t)) + cfg.eps) \
        + cfg.weight_decay * f(p)
    return f(p) - lr * delta, mu2, nu2, lr * delta, gc


def check_adamw(torch, opt, opt_cfg, rec, fails) -> dict:
    """The step's update of ``ADAMW_LEAVES``: bit for bit the port's
    ``adamw_update`` on the CPU over the same parameters, gradients and
    moments (the card's global norm given), and within its allowances of
    the formula in float64 (``ADAMW_*_REL``)."""
    from repro_torch.optim import adamw as TA
    names = ("param", "mu", "nu")
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}
    before = {k: tuple(t.cpu() for t in v) for k, v in rec["before"].items()}
    saved = TA.global_norm
    TA.global_norm = lambda grads: rec["gn"].cpu()
    t0 = time.perf_counter()
    try:
        p, st, _ = opt.adamw_update(
            opt_cfg, {k: v[0].clone() for k, v in before.items()},
            {k: v[1] for k, v in before.items()},
            opt.OptState(cpu({k: v[2].clone() for k, v in before.items()}),
                         cpu({k: v[3].clone() for k, v in before.items()}),
                         torch.tensor(rec["step"], dtype=torch.int32)))
    finally:
        TA.global_norm = saved
    cpu_s = time.perf_counter() - t0
    out = {"cpu_s": cpu_s, "differ": {}, "shares": {}}
    t = rec["step"] + 1
    for path, (pa, ma, na) in rec["after"].items():
        for name, got, want in zip(names, (pa, ma, na),
                                   (p[path], st.mu[path], st.nu[path])):
            n = int((bits(torch, got.cpu()) != bits(torch, want)).sum())
            out["differ"][f"{path} {name}"] = n
            if n:
                fails.append(f"training: AdamW's {name} of {path} on the "
                             f"card differs from the CPU's at {n} of "
                             f"{got.numel()} elements")
        pb, g, mb, nb = rec["before"][path]
        p64, mu64, nu64, step64, gc = adamw_f64(torch, opt_cfg, pb, g, mb, nb,
                                                rec["gn"], t)
        allow = {
            "mu": ADAMW_MOMENT_REL * (opt_cfg.b1 * mb.double().abs()
                                      + (1 - opt_cfg.b1) * gc.abs()),
            "nu": ADAMW_MOMENT_REL * (opt_cfg.b2 * nb.double()
                                      + (1 - opt_cfg.b2) * gc * gc),
            "param": ADAMW_PARAM_REL * p64.abs() + 2.0 ** -20 * (
                pb.double().abs() + step64.abs())}
        for name, got, want in zip(names, (pa, ma, na), (p64, mu64, nu64)):
            err = (got.double() - want).abs()
            share = float((err / allow[name].clamp_min(1e-30)).max())
            out["shares"][f"{path} {name}"] = hold(
                fails, f"training: AdamW's {name} of {path} against its "
                f"float64 formula at step {t}", share)
    return out


def batch_losses(torch, cfg, params, dcfg, dev) -> list:
    """The loss of each training step's batch under ``params``, without
    autograd, micro-batch by micro-batch as the step takes it."""
    from repro_torch.data import make_batch
    from repro_torch.models import ShardCtx, layers, loss_fn
    out = []
    n = TRAIN_BATCH // TRAIN_MICRO
    with torch.no_grad(), layers.fp32_sums():
        for s in range(TRAIN_STEPS):
            b = make_batch(dcfg, s, dev)
            out.append(sum(float(loss_fn(
                cfg, params, {k: v[i * n:(i + 1) * n] for k, v in b.items()},
                ShardCtx())[0]) for i in range(TRAIN_MICRO)) / TRAIN_MICRO)
    return out


def top_kernels(prof, n: int) -> list:
    """The ``n`` kernels of a trace with the most device time: (name,
    milliseconds, launches)."""
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t:
            rows.append((ev.key, t / 1e3, ev.count))
    return sorted(rows, key=lambda r: -r[1])[:n]


def train_flops(cfg, tokens: int, seq: int) -> float:
    """The model's FLOPs a training step from its shapes: 6 x (the
    parameters a token multiplies: every matrix but the input embedding)
    x tokens, plus causal attention's two products, forward and backward
    (3 x 4 x heads x head dim x query-key pairs a layer), without the
    recompute."""
    n = cfg.n_params() - cfg.vocab * cfg.d_model
    pairs = seq * (seq + 1) // 2 * (tokens // seq)
    return 6.0 * n * tokens + 12.0 * cfg.n_layers * cfg.n_heads * \
        cfg.head_dim_ * pairs


def check_train_whole(torch, dev, kernels, card: str) -> dict:
    """Phase 12 (a): see the module docstring. Returns each kernel's
    launches over the 8 steps; raises once, naming each check that
    failed."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs, optim
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps
    from repro_torch.models import ShardCtx, init_params, transformer
    fails: list = []
    cfg = configs.get(TRAIN_ARCH)
    opt_cfg = optim.AdamWConfig(lr_peak=TRAIN_LR,
                                warmup_steps=min(20, TRAIN_STEPS // 5),
                                total_steps=TRAIN_STEPS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    for s in range(TRAIN_STEPS):
        a, b = make_batch(dcfg, s, dev), make_batch(dcfg, s, "cpu")
        if not all(torch.equal(a[k].cpu(), b[k]) for k in a):
            fails.append(f"training: the data batch of step {s} on the card "
                         f"differs from the CPU's")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    state = optim.init_opt_state(params)
    init_losses = batch_losses(torch, cfg, params, dcfg, dev)
    pbytes = sum(t.numel() * t.element_size() for t in _tensors(params))
    print(f"  {TRAIN_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_params() / 1e9:.3f}B parameters ({pbytes / 1e9:.2f} GB "
          f"bf16), batch {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} "
          f"micro-batches, {TRAIN_STEPS} steps, lr {TRAIN_LR}", flush=True)
    step_fn = steps.make_train_step(cfg, opt_cfg, ShardCtx(),
                                    micro_batches=TRAIN_MICRO)
    spy, arec = {}, {}
    real_block = spy_layer0(torch, transformer, params, spy)
    real_update = spy_adamw(torch, steps, arec)
    for k in kernels.values():
        k.launches = 0
    losses, walls, prof, p0 = [], [], None, None
    try:
        for s in range(TRAIN_STEPS):
            spy["armed"] = s == TRAIN_SPY_STEP
            arec["armed"] = s == TRAIN_ADAMW_STEP
            if s == TRAIN_SPY_STEP:      # layer 0 as the step sees it
                p0 = {k: {n: t.detach().clone() for n, t in v.items()}
                      for k, v in transformer._layer(params, 0).items()}
            batch = make_batch(dcfg, s, dev)
            torch.cuda.synchronize()
            last = s == TRAIN_STEPS - 1
            with (profile(activities=[ProfilerActivity.CUDA]) if last
                  else contextlib.nullcontext()) as p:
                t0 = time.perf_counter()
                params, state, m = step_fn(params, state, batch)
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            prof = p if last else prof
    finally:
        transformer._train_block = real_block
        steps.adamw_update = real_update
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    end_losses = batch_losses(torch, cfg, params, dcfg, dev)
    del params, state, batch, m
    torch.cuda.empty_cache()

    print("  step losses: " + " ".join(f"{x:.4f}" for x in losses)
          + "\n  the initial model's loss on each step's batch: "
          + " ".join(f"{x:.4f}" for x in init_losses)
          + "\n  the trained model's: "
          + " ".join(f"{x:.4f}" for x in end_losses), flush=True)
    if not all(math.isfinite(x) for x in losses + end_losses):
        fails.append("training: a loss is not finite")
    # A step's loss is taken on a batch the model has not seen, and
    # batches differ by more than 8 steps teach: each is held to the
    # initial model's loss on the same batch.
    if not losses[-1] < init_losses[-1]:
        fails.append(f"training: the last step's loss {losses[-1]:.4f} is "
                     f"not below the initial model's on its batch "
                     f"{init_losses[-1]:.4f}")
    if not end_losses[0] < losses[0]:
        fails.append(f"training: the first batch's loss after "
                     f"{TRAIN_STEPS} steps {end_losses[0]:.4f} is not below "
                     f"its loss at the first step {losses[0]:.4f}")
    print(f"  launches over the {TRAIN_STEPS} steps: {launches}")
    wall = statistics.median(walls[2:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, tokens, TRAIN_SEQ)
    dev_us, n_kernels = trace_us(prof, lambda key: True)
    each = " ".join(f"{w * 1e3:.0f}" for w in walls)
    print(f"  a step: wall {wall * 1e3:.1f} ms (median of steps 2-"
          f"{TRAIN_STEPS - 1}; each {each} ms), {tokens / wall:.0f} "
          f"tokens/s; {flops / 1e12:.1f} TFLOP (6 N tokens + attention), "
          f"{flops / wall / 1e12:.1f} TFLOP/s = "
          f"{flops / wall / PEAK_FLOPS['bfloat16']:.3f} of 989 TFLOP/s "
          f"bf16 ({card})")
    print(f"  the last step traced: device {dev_us / 1e3:.1f} ms in "
          f"{n_kernels} kernels, a device share of "
          f"{dev_us / 1e3 / (walls[-1] * 1e3):.3f}; peak memory "
          f"{(peak - held) / 1e9:.2f} GB over the {held / 1e9:.2f} GB held "
          f"before the phase; AdamW {arec['ms']:.1f} ms of step "
          f"{TRAIN_ADAMW_STEP + 1}'s wall; its largest kernels: " + "; ".join(
              f"{k[:60]} {ms:.1f} ms ({c})" for k, ms, c in
              top_kernels(prof, 6)))

    l0 = check_layer0_grads(torch, cfg, p0, spy, fails)
    print("  layer 0 at step 1 against float64 (||g - g64|| / ||g64|| as a "
          f"share of {GRAD_REL}): " + ", ".join(
              f"{k} {v:.3f}" for k, v in l0["shares"].items()))
    att = check_attention_grads(torch, ops, ref, fa, cfg, p0["attn"], spy,
                                l0["d_o"], l0["window"], fails)
    print(f"  attention backward on layer 0's q, k, v: chunked_attention "
          f"against float64 (share of {ATTN_GRAD_REL}): " + ", ".join(
              f"{k} {v:.3f}" for k, v in att["chunked"].items())
          + "; ops.flash_attention's gradient against it (share of "
          "ref.kernel_error's allowance): " + ", ".join(
              f"{k} {v:.3f}" for k, v in att["flash"].items())
          + f"; kernel 3 launched {att['flash_launches']} times")
    del spy, p0, l0
    aw = check_adamw(torch, optim, opt_cfg, arec, fails)
    print(f"  AdamW at step {arec['step'] + 1} on {', '.join(ADAMW_LEAVES)} "
          f"(layer 0's wq): elements that differ from the CPU's "
          f"adamw_update ({aw['cpu_s']:.1f} s there): "
          f"{sum(aw['differ'].values())}; against float64 (share of its "
          f"allowance): " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in aw["shares"].items()))
    del arec
    torch.cuda.empty_cache()
    if fails:
        raise Mismatch("training: FAILED: " + "; ".join(fails))
    return {"launches": launches}


def check_train_resume(torch, dev, card: str) -> None:
    """Phase 12 (b): see the module docstring. ``launch.train.run`` at
    ``RESUME_LAYERS`` layers on the card: a crash at step 4 with a
    checkpoint, a resume to step 8, an uninterrupted run; raises unless
    the final losses agree within ``RESUME_RTOL``."""
    import shutil
    import tempfile
    from repro_torch.ckpt import checkpoint
    from repro_torch.launch import train
    writes = []
    real_write = checkpoint._write

    def timed_write(directory, step, flat, extra):
        t0 = time.perf_counter()
        path = real_write(directory, step, flat, extra)
        writes.append((time.perf_counter() - t0, os.path.getsize(
            os.path.join(path, "arrays.npz"))))
        return path

    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase12_", dir=build)
    args = ["--arch", TRAIN_ARCH, "--layers", str(RESUME_LAYERS),
            "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--micro-batches", str(TRAIN_MICRO),
            "--lr", str(TRAIN_LR), "--ckpt-every", "4", "--log-every", "4",
            "--device", str(dev)]
    checkpoint._write = timed_write
    t0 = time.perf_counter()
    try:
        try:
            train.run(args + ["--ckpt-dir", tmp, "--simulate-failure-at",
                              "4"])
            raise Mismatch("training: the run with --simulate-failure-at 4 "
                           "did not stop")
        except SystemExit as e:
            print(f"  {e}")
        torch.cuda.empty_cache()
        p_res, loss_res = train.run(args + ["--ckpt-dir", tmp])
        p_res = dict(leaf_items(p_res))
        torch.cuda.empty_cache()
        p_str, loss_str = train.run(args)
    finally:
        checkpoint._write = real_write
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    diff = max(float((p_res[k] - v).detach().float().abs().max())
               for k, v in leaf_items(p_str))
    del p_res, p_str
    torch.cuda.empty_cache()
    print(f"  crash at 4 and resume vs straight ({RESUME_LAYERS} of 24 "
          f"layers, full width): final loss {loss_res:.6f} vs "
          f"{loss_str:.6f} (rtol {RESUME_RTOL}), largest parameter "
          f"difference {diff:g}; checkpoint writes: " + ", ".join(
              f"{b / 1e9:.2f} GB in {t:.1f} s" for t, b in writes)
          + f"; the three runs {wall:.1f} s ({card})")
    if not abs(loss_res - loss_str) <= RESUME_RTOL * abs(loss_str):
        raise Mismatch(f"training: the resume's final loss {loss_res!r} "
                       f"differs from the uninterrupted run's {loss_str!r} "
                       f"past rtol {RESUME_RTOL}")
    if diff != 0:
        raise Mismatch(f"training: the resume's parameters differ from the "
                       f"uninterrupted run's by up to {diff:g}")


# Phase 12 (c): the other families, each at full width with its depth
# cut, two steps of ``launch.steps.make_train_step`` on its Markov data.
# The sequence is a multiple of the config's ``seq_multiple`` (RWKV's
# 128-token chunk) and short enough for the per-token loops: Hymba's
# Mamba scan runs a step a token, three times a layer under the recompute.
class TrainFamily(NamedTuple):
    arch: str
    layers: int       # the first N of the config's layers, widths unchanged
    batch: int
    seq: int
    what: str         # the path its training exercises


TRAIN_FAMILIES = (
    TrainFamily("rwkv6-7b", 2, 2, 512, "the chunked scan's backward"),
    TrainFamily("hymba-1.5b", 2, 2, 512,
                "the per-token Mamba loop under autograd"),
    TrainFamily("phi3.5-moe-42b-a6.6b", 2, 2, 1024,
                "the dense dispatch's backward and the aux loss"),
)
FAMILY_STEPS = 2


def shift_f64(torch, x):
    """Token shift: each row's previous row, zeros before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def rwkv_layer0_f64(torch, cfg, p, x, rec, plain: bool = False):
    """RWKV6 layer 0 in float64 from its formulas: the time mix as the
    per-token recurrence out_t = r_t (S + diag(u) k_t v_t^T), S <- diag(w_t)
    S + k_t v_t^T, the per-head RMS group norm and gate, then the channel
    mix (relu^2, sigmoid receptance). Unless ``plain``, each value is
    rounded to the activation type where the model rounds it (``act``):
    the norms' outputs, each step of the token-shift lerp, the
    projections, the log-decay, the gated output and the residuals. The r
    and k paths' gradients (``u``'s most) are ill-conditioned in those
    roundings: at rwkv6-7b's width, the plain formulas miss the bfloat16
    gradients by up to 7.7 x ``GRAD_REL``. So the bfloat16 step is held
    to the rounded formulas (the rounding points are JAX's:
    ``tests/test_torch_train_families.py``), and the layer run in float32
    to the plain ones (``check_rwkv_f32``)."""
    b, s, d = x.shape
    h, a, m = cfg.n_heads, p["attn"], p["mlp"]
    dh = d // h
    act = (lambda t: t) if plain else lambda t: t.to(cfg.adtype).double()

    def shifted(xn):
        xs = shift_f64(torch, xn)
        return lambda mu: act(xn + act(act(xs - xn) * mu))
    mix = shifted(act(norm_f64(cfg, x, a["norm"])))
    r, k, v, g = (act(mix(a["mu_" + n]) @ a["w_" + n]) for n in "rkvg")
    dd = act(act(torch.tanh(act(mix(a["mu_w"]) @ a["decay_a"])))
             @ a["decay_b"])
    logw = -torch.exp(torch.clamp(a["decay_base"] + dd, -8.0, 6.0))
    w = torch.exp(act(logw))
    heads = lambda t: t.reshape(b, s, h, dh)
    r, k, v, w = map(heads, (r, k, v, w))
    state = x.new_zeros((b, h, dh, dh))
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 state + a["u"][None, :, :, None] * kv))
        state = state * w[:, t, :, :, None] + kv
    out = torch.stack(outs, 1)                          # [B, S, H, Dh]
    out = out * (out * out).mean(-1, keepdim=True).add(cfg.norm_eps).rsqrt()
    out = act(act(out.reshape(b, s, d) * a["gn_w"])
              * act(g * torch.sigmoid(g)))
    x1 = act(x + act(out @ a["w_o"]))
    mix = shifted(act(norm_f64(cfg, x1, m["norm"])))
    kk = act(torch.relu(act(mix(m["mu_k"]) @ m["w_k"])) ** 2)
    rr = act(torch.sigmoid(act(mix(m["mu_r"]) @ m["w_r"])))
    return act(x1 + act(act(kk @ m["w_v"]) * rr)), None


def hymba_layer0_f64(torch, cfg, p, x, rec):
    """Hymba layer 0 in float64: attention and the Mamba path on the same
    normed input (the causal depthwise conv, the selective scan a token at
    a time, the skip and the SiLU gate), each path RMS-normed, averaged
    and projected, then the SwiGLU."""
    b, s, _ = x.shape
    a, mb = p["attn"], p["attn"]["mamba"]
    window = None if 0 in cfg.hymba_global_layers else cfg.window
    xn = norm_f64(cfg, x, a["norm"])
    att = gqa_f64(torch, cfg, a, xn, window).transpose(1, 2).reshape(
        b, s, -1)
    xz = xn @ mb["in_proj"]
    di = xz.shape[-1] // 2
    xm, z = xz[..., :di], xz[..., di:]
    kw = mb["conv_w"].shape[1]
    xp = torch.cat([xm.new_zeros((b, kw - 1, di)), xm], dim=1)
    xm = sum(xp[:, i:i + s] * mb["conv_w"][:, i] for i in range(kw))
    xm = xm * torch.sigmoid(xm)
    n = cfg.ssm.d_state
    r = mb["x_proj"].shape[1] - 2 * n
    proj = xm @ mb["x_proj"]
    dt = torch.nn.functional.softplus(proj[..., :r] @ mb["dt_proj"]
                                      + mb["dt_bias"])
    bm, cm = proj[..., r:r + n], proj[..., r + n:]
    amat = -torch.exp(mb["a_log"])
    hs = x.new_zeros((b, di, n))
    ys = []
    for t in range(s):
        hs = torch.exp(dt[:, t, :, None] * amat) * hs \
            + (dt[:, t] * xm[:, t])[..., None] * bm[:, t, None, :]
        ys.append((hs * cm[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, 1) + xm * mb["d_skip"]) * (z * torch.sigmoid(z))
    pn = lambda t, w: t * (t * t).mean(-1, keepdim=True).add(
        cfg.norm_eps).rsqrt() * w
    fused = (pn(att, a["attn_out_norm"]) + pn(y, a["ssm_out_norm"])) * 0.5
    x1 = x + fused @ a["wo"]
    return x1 + swiglu_f64(torch, p["mlp"], norm_f64(cfg, x1,
                                                     p["mlp"]["norm"])), None


def moe_layer0_f64(torch, cfg, p, x, rec):
    """A GQA + MoE layer 0 in float64: the router's probabilities, each
    token's gates at the experts and slots the step's routing took (its
    top k; a slot past capacity dropped), every expert's SwiGLU on its
    tokens, and the switch loss from the probabilities. Returns (y, aux)."""
    b, s, d = x.shape
    a, m, e = p["attn"], p["mlp"], cfg.moe
    o = gqa_f64(torch, cfg, a, norm_f64(cfg, x, a["norm"]), None)
    x1 = x + o.transpose(1, 2).reshape(b, s, -1) @ a["wo"]
    xt = norm_f64(cfg, x1, m["norm"]).reshape(b * s, d)
    idx, _, _, keep = rec["route"]
    probs = torch.softmax(xt @ m["router"], dim=-1)
    vals = probs.gather(1, idx)
    gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9) * keep
    out = torch.zeros_like(xt)
    for ex in range(e.n_experts):
        w = (gates * (idx == ex)).sum(-1)
        tok = ((idx == ex) & keep).any(-1).nonzero()[:, 0]
        if len(tok):
            ffn = swiglu_f64(torch, {n: m[n][ex] for n in
                                     ("w_in", "w_gate", "w_out")}, xt[tok])
            out = out.index_add(0, tok, ffn * w[tok, None])
    ce = torch.nn.functional.one_hot(idx, e.n_experts).double().sum(1) \
        .mean(0) / e.top_k
    aux = e.n_experts * (probs.mean(0) * ce).sum()
    return x1 + out.reshape(b, s, d), aux


FAMILY_F64 = {"rwkv6": rwkv_layer0_f64, "hymba": hymba_layer0_f64,
              "gqa": moe_layer0_f64}


def nested_f64(torch, tree, dtype=None):
    """A nested dict of tensors as float64 (or ``dtype``) leaves that take
    gradients."""
    if isinstance(tree, dict):
        return {k: nested_f64(torch, v, dtype) for k, v in tree.items()}
    return tree.detach().to(dtype or torch.float64).requires_grad_()


def nested_clone(tree):
    """A nested dict of tensors, each detached and copied."""
    if isinstance(tree, dict):
        return {k: nested_clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def check_family_grads(torch, cfg, p0, rec, fails, name: str) -> dict:
    """Layer 0 of a family (its parameters ``p0`` as the step saw them)
    recomputed in float64 from its formulas on the recorded input, with
    the gradients at its output (and at its aux loss) the step saw: each
    parameter gradient and dx against it (``GRAD_REL``)."""
    p64 = nested_f64(torch, p0)
    x64 = rec["x"].double().requires_grad_()
    y, aux = FAMILY_F64[cfg.attn_type](torch, cfg, p64, x64, rec)
    outs, seeds = [y], [rec["dy"].double()]
    if aux is not None:
        outs.append(aux)
        seeds.append(rec["daux"].double())
    torch.autograd.backward(outs, seeds)
    shares = {}
    for path, t in leaf_items(p64):
        # a parameter the step's backward never reached has no gradient
        got = rec["grads"].get(path, torch.zeros_like(t))
        shares[path] = rel_norm(torch, got, t.grad) / GRAD_REL
    shares["dx"] = rel_norm(torch, rec["dx"], x64.grad) / GRAD_REL
    for path, share in shares.items():
        hold(fails, f"training {name}: layer 0's gradient {path} against "
             "float64", share)
    return shares


def check_rwkv_f32(torch, cfg, p0, rec, fails, name: str) -> dict:
    """rwkv6's layer 0 run by the port in float32 (its parameters ``p0``
    and the step's recorded input and output gradient, cast) against the
    plain float64 formulas, with no rounding: each parameter gradient and
    dx within ``GRAD_REL``."""
    from repro_torch.models import ShardCtx, layers, transformer
    cfg32 = cfg.with_(param_dtype="float32", activation_dtype="float32")
    p32 = nested_f64(torch, p0, torch.float32)
    x32 = rec["x"].float().requires_grad_()
    positions = torch.arange(x32.shape[1], dtype=torch.float32,
                             device=x32.device)
    y32, _ = layers.fp32_accumulation(transformer._train_block)(
        cfg32, ShardCtx(), positions, p32, x32, None)
    y32.backward(rec["dy"].float())
    p64 = nested_f64(torch, p0)
    x64 = rec["x"].double().requires_grad_()
    y64, _ = rwkv_layer0_f64(torch, cfg, p64, x64, rec, plain=True)
    y64.backward(rec["dy"].double())
    shares = {path: rel_norm(torch, t32.grad, t.grad) / GRAD_REL
              for (path, t), (_, t32) in zip(leaf_items(p64),
                                             leaf_items(p32))}
    shares["dx"] = rel_norm(torch, x32.grad, x64.grad) / GRAD_REL
    for path, share in shares.items():
        hold(fails, f"training {name}: layer 0 in float32, gradient {path} "
             "against the plain float64 formulas", share)
    return shares


def check_train_family(torch, dev, kernels, row: TrainFamily, card: str,
                       fails: list) -> dict:
    """Two steps of one family (``row``), layer 0's gradients at the first
    against float64; returns the kernels' launches over the steps."""
    from repro_torch import configs, optim
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.launch import steps
    from repro_torch.models import ShardCtx, init_params, transformer
    full = configs.get(row.arch)
    cfg = full.with_(n_layers=row.layers)
    opt_cfg = optim.AdamWConfig(lr_peak=TRAIN_LR, warmup_steps=1,
                                total_steps=FAMILY_STEPS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=row.seq,
                      global_batch=row.batch, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    state = optim.init_opt_state(params)
    p0 = nested_clone(transformer._layer(params, 0))
    step_fn = steps.make_train_step(cfg, opt_cfg, ShardCtx())
    spy = {}
    real_block = spy_layer0(torch, transformer, params, spy)
    for k in kernels.values():
        k.launches = 0
    losses, walls = [], []
    try:
        for s in range(FAMILY_STEPS):
            spy["armed"] = s == 0
            batch = make_batch(dcfg, s, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        transformer._train_block = real_block
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _tensors(params))
    del params, state, batch, m
    torch.cuda.empty_cache()
    name = row.arch
    if not all(math.isfinite(x) for x in losses):
        fails.append(f"training {name}: a loss is not finite: {losses}")
    shares = check_family_grads(torch, cfg, p0, spy, fails, name)
    plain = ""
    if cfg.attn_type == "rwkv6":
        s32 = check_rwkv_f32(torch, cfg, p0, spy, fails, name)
        w32 = max(s32, key=s32.get)
        plain = (f"; layer 0 in float32 against the plain float64 formulas:"
                 f" the largest {w32} {s32[w32]:.4f}")
    del spy, p0
    torch.cuda.empty_cache()
    worst = max(shares, key=shares.get)
    print(f"  {name} ({row.what}): {row.layers} of {full.n_layers} layers "
          f"at full width (d {cfg.d_model}), {n_params / 1e9:.3f}B "
          f"parameters, batch {row.batch} x {row.seq}, {FAMILY_STEPS} "
          f"steps: losses " + " ".join(f"{x:.4f}" for x in losses)
          + f"; walls " + " ".join(f"{w * 1e3:.0f}" for w in walls)
          + f" ms; peak memory {(peak - held) / 1e9:.2f} GB; layer 0 "
          f"against float64 (share of {GRAD_REL}): {len(shares)} "
          f"gradients, the largest {worst} {shares[worst]:.3f}{plain}; "
          f"launches {launches} [{card}]", flush=True)
    return launches


def check_train_families(torch, dev, kernels, card: str,
                         rows=TRAIN_FAMILIES) -> dict:
    """Phase 12 (c): each family of ``rows``; raises once, naming each
    check that failed. Returns the kernels' launches summed over them."""
    fails: list = []
    total = {n: 0 for n in kernels}
    for row in rows:
        for n, c in check_train_family(torch, dev, kernels, row, card,
                                       fails).items():
            total[n] += c
    if fails:
        raise Mismatch("training: FAILED: " + "; ".join(fails))
    return total


def check_train(torch, dev, kernels, card: str, part: str = "abc") -> dict:
    """Every check of phase 12: (a) internlm2-1.8b whole, (b) crash and
    resume, (c) rwkv6, hymba and phi3.5-moe. Returns each kernel's
    launches over the steps of (a) and (c)."""
    out = {"launches": {n: 0 for n in kernels}}
    if "a" in part:
        out = check_train_whole(torch, dev, kernels, card)
    if "b" in part:
        check_train_resume(torch, dev, card)
    if "c" in part:
        for n, c in check_train_families(torch, dev, kernels,
                                         card).items():
            out["launches"][n] += c
    return out


# --------------------------------------------------------------- phase 6
# Each model kernel is held to its plain version within
# ``repro_torch.kernels.ref.kernel_error``'s allowance, in the working
# type: attention |err| <= 2e-5 in float32 and 1e-5 + 2^-7 |plain| in
# bfloat16 (one bfloat16 step of the value), RWKV 1e-5 of the output's
# largest magnitude (~5e2 at these shapes).


# --------------------------------------------------------------- phase 13
# bench_speedup.WORKLOADS_SMALL (benchmarks/bench_speedup.py:25), its scale
# and its least trace length: 16,384 requests each.
ORACLE_WORKLOADS = ("505.mcf", "519.lbm", "538.imagick", "520.omnetpp",
                    "508.namd", "541.leela")
ORACLE_SCALE = 6e-9
ORACLE_REQUESTS = 16_384
# The three policies the sequential simulators model, at settings that
# migrate on the paper's geometry (at bench_speedup's own hot_threshold 8
# and decay_every 16 it makes no swap in 16,384 requests).
ORACLE_SETTINGS = (("static", {}),
                   ("hotness", dict(hot_threshold=2, decay_every=512)),
                   ("write_bias", dict(hot_threshold=4, decay_every=64,
                                       write_weight=4)))
# The (workload, policy) cases that must migrate: on 519.lbm, 508.namd and
# 541.leela these settings make few swaps or none.
ORACLE_MIGRATING = (("505.mcf", "hotness"), ("505.mcf", "write_bias"),
                    ("520.omnetpp", "hotness"), ("520.omnetpp", "write_bias"))
ORACLE_DEEP = ("505.mcf", "write_bias", 131_072)
ORACLE_OFF_REQUESTS = 512      # "off" is one kernel-A launch a request here
FIG7_CHUNK = 4096              # benchmarks/bench_speedup.py:37
LARGE_CHUNKS = (2048, 4096)    # the shared-memory and the workspace layout
EXAMPLES = (("quickstart_torch", ()),
            ("policy_exploration_torch", ()),
            ("serve_continuous_torch", ()),
            ("wear_leveling_torch", ("--quick", "--check")),
            ("endurance_lifetime_torch", ("--quick", "--check")))
U32 = 2.0 ** -24               # float32's unit roundoff


def sim_pair(cfg, arrays):
    """The port's ``trace_sim`` and ``cycle_sim(refresh=False)`` on one
    trace, with their walls (s)."""
    from repro_torch.sims import cycle_sim, trace_sim
    t0 = time.perf_counter()
    r1 = trace_sim.simulate(cfg, *arrays)
    t1 = time.perf_counter()
    r2 = cycle_sim.simulate(cfg, *arrays, refresh=False)
    return r1, r2, t1 - t0, time.perf_counter() - t1


SIM_INT_COUNTERS = ("reads_fast", "writes_fast", "reads_slow",
                    "writes_slow", "reorder_held")


def hold_oracle(where: str, res, r1, r2, n_chunks: int) -> dict:
    """Hold an ``Engine.run`` at chunk 1 to both simulators: returns,
    latency and device bitwise, the final clock, the swaps (``cycle_sim``
    may lead by the one swap in flight at the end), the integer counters
    and the byte counters exactly; the two float32 counters that sum a
    term a chunk (energy, read latency) within the bound of a float32
    sum of ``n_chunks`` positive terms, ``n_chunks * 2^-22`` relative
    (the term's coefficient and product roundings, the fold's).
    Returns each float counter's share of its bound."""
    import numpy as np
    o, st = res.outs, res.state
    for name, sim in (("trace_sim", r1), ("cycle_sim", r2)):
        for k in ("returns", "latency", "device"):
            got = o[k].cpu().numpy().astype(np.int64)
            want = getattr(sim, k)
            if got.shape != want.shape or not np.array_equal(got, want):
                bad = np.flatnonzero(got != want)
                raise Mismatch(
                    f"{where}: {k} differs from {name} at {bad.size} of "
                    f"{want.size} requests, first request {bad[0]}: "
                    f"{got[bad[0]]} against {want[bad[0]]}")
        if int(st.clock) != sim.clock:
            raise Mismatch(f"{where}: clock {int(st.clock)}, {name} "
                           f"{sim.clock}")
        c = st.counters
        for k in SIM_INT_COUNTERS:
            if int(getattr(c, k)) != sim.counters[k]:
                raise Mismatch(f"{where}: counter {k} {int(getattr(c, k))},"
                               f" {name} {sim.counters[k]}")
        for k, parts in (("bytes_read", ("bytes_read_fast",
                                         "bytes_read_slow")),
                         ("bytes_written", ("bytes_write_fast",
                                            "bytes_write_slow"))):
            got = sum(float(getattr(c, f)) for f in parts)
            if got != sim.counters[k]:
                raise Mismatch(f"{where}: {k} {got}, {name} "
                               f"{sim.counters[k]}")
    swaps = int(st.dma.swaps_done)
    if swaps != r1.swaps or r2.swaps - r1.swaps not in (0, 1):
        raise Mismatch(f"{where}: swaps {swaps}, trace_sim {r1.swaps}, "
                       f"cycle_sim {r2.swaps}")
    c = st.counters
    bound = n_chunks * 2.0 ** -22
    reads = int(c.n_reads)
    mean = float(c.sum_read_latency) / max(reads, 1)
    shares = {}
    for k, got, want in (
            ("energy_pj", float(c.energy_pj), r1.counters["energy_pj"]),
            ("mean_read_latency", mean,
             r1.counters["mean_read_latency_cyc"])):
        rel = abs(got - want) / abs(want) if want else abs(got)
        shares[k] = rel / bound
        if rel > bound:
            raise Mismatch(f"{where}: {k} {got} against the simulators' "
                           f"{want}: {rel:.3g} relative, past {bound:.3g}")
    return shares


def check_oracle(torch, dev, rt, hl, cs) -> dict:
    """Phase 13 (a): kernel B at chunk 1 on the paper's geometry held to
    the sequential simulators, bit for bit (see the module docstring);
    returns the launches of kernels A and B."""
    from repro_torch.trace import workload_trace
    launches = {"hmmu_lookup": 0, "chunk_step": 0}

    def run(cfg, trace, route, want):
        hl.KERNEL.launches = 0
        cs.KERNEL.reset()
        t0 = time.perf_counter()
        res = rt.Engine(cfg.with_(chunk_step_kernel=route)).run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"hmmu_lookup": hl.KERNEL.launches,
               "chunk_step": cs.KERNEL.launches}
        if got != want:
            raise Mismatch(f"chunk 1 on {route!r}: launches {got}, not "
                           f"{want}")
        if route == "auto" and cs.KERNEL.variant_launches["shared"] != 1:
            raise Mismatch(f"chunk 1: layouts {cs.KERNEL.variant_launches}")
        for k in launches:
            launches[k] += got[k]
        return res, wall

    settings = dict(ORACLE_SETTINGS)
    cases = [(w, [p for p, _ in ORACLE_SETTINGS], ORACLE_REQUESTS)
             for w in ORACLE_WORKLOADS]
    cases.append((ORACLE_DEEP[0], [ORACLE_DEEP[1]], ORACLE_DEEP[2]))
    for name, policies, m in cases:
        trace, _, n = workload_trace(name, scale=ORACLE_SCALE,
                                     min_requests=m, device=dev)
        arrays = [x.cpu().numpy() for x in trace]
        for policy in policies:
            cfg = rt.paper_platform().with_(chunk=1, policy=policy,
                                            **settings[policy])
            res, wall = run(cfg, trace, "auto", {"hmmu_lookup": 0,
                                                 "chunk_step": 1})
            r1, r2, ts, cy = sim_pair(cfg, arrays)
            shares = hold_oracle(f"{name}/{policy} at chunk 1", res, r1, r2,
                                 n)
            swaps = int(res.state.dma.swaps_done)
            print(f"  {name:11s} {policy:10s} {n:6d} requests in {n} "
                  f"chunks (one launch of kernel B, {wall:.3f} s, "
                  f"{wall / n * 1e6:.2f} us/chunk wall): clock "
                  f"{int(res.state.clock)}, swaps {swaps} (cycle_sim "
                  f"{r2.swaps}); equal to trace_sim ({ts:.2f} s) and "
                  f"cycle_sim ({cy:.2f} s); energy at "
                  f"{shares['energy_pj']:.3f}, mean read latency at "
                  f"{shares['mean_read_latency']:.3f} of their float32 "
                  "bound", flush=True)
            if (name, policy) in ORACLE_MIGRATING and swaps == 0:
                raise Mismatch(f"{name}/{policy}: no swap: the DMA path is "
                               "not exercised")
    # "off": one launch of kernel A a chunk, on each policy's first
    # requests of the first workload; "auto" over the same requests must
    # equal it in every field of the final state too (the table's EPOCH
    # stamps show when each swap committed, which the simulators keep to
    # themselves).
    name = ORACLE_WORKLOADS[0]
    trace, _, _ = workload_trace(name, scale=ORACLE_SCALE,
                                 min_requests=ORACLE_REQUESTS, device=dev)
    m = ORACLE_OFF_REQUESTS
    sub = rt.core.Trace(*(x[:m] for x in trace))
    arrays = [x.cpu().numpy() for x in sub]
    for policy, kw in ORACLE_SETTINGS:
        cfg = rt.paper_platform().with_(chunk=1, policy=policy, **kw)
        res, wall = run(cfg, sub, "off", {"hmmu_lookup": m,
                                          "chunk_step": 0})
        r1, r2, _, _ = sim_pair(cfg, arrays)
        hold_oracle(f"{name}/{policy} at chunk 1 on 'off'", res, r1, r2, m)
        auto, _ = run(cfg, sub, "auto", {"hmmu_lookup": 0, "chunk_step": 1})
        same_runs(torch, f"{name}/{policy}, the first {m} requests at chunk "
                  "1: 'auto' against 'off'", tuple(auto), tuple(res))
        print(f"  {name} {policy:10s} first {m} requests on 'off' ({m} "
              f"launches of kernel A, {wall:.2f} s): equal to trace_sim "
              f"and cycle_sim, and 'auto' equal to it (final state "
              f"included); swaps {int(res.state.dma.swaps_done)}",
              flush=True)
    return launches


def check_fig7(torch, dev, rt, hl, cs, card: str) -> dict:
    """Phase 13 (b): the paper's Fig 7 on the card (see the module
    docstring); returns the launches of kernels A and B and the rows."""
    import numpy as np
    from repro_torch.sims import cycle_sim, trace_sim
    from repro_torch.trace import workload_trace
    cfg = rt.paper_platform().with_(chunk=FIG7_CHUNK)
    eng = rt.Engine(cfg)
    rows = []
    hl.KERNEL.launches = 0
    cs.KERNEL.reset()
    for name in ORACLE_WORKLOADS:
        trace, _, n = workload_trace(name, scale=ORACLE_SCALE,
                                     min_requests=ORACLE_REQUESTS,
                                     device=dev)
        arrays = [x.cpu().numpy() for x in trace]

        def emu():
            r = eng.run(trace)
            torch.cuda.synchronize()
            return r
        res = emu()                       # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = emu()
            walls.append(time.perf_counter() - t0)
        check_outputs(torch, rt, cfg, res, n)
        emu_s = statistics.median(walls)
        native_s = int(res.state.clock) * 1e-9      # 1 cycle == 1 ns
        t0 = time.perf_counter()
        trace_sim.simulate(cfg, *arrays)
        ts_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cycle_sim.simulate(cfg, *arrays, refresh=True, cpu_model=True)
        cy_s = time.perf_counter() - t0
        row = {"workload": name, "requests": n, "native_s": native_s,
               "emu_s": emu_s, "trace_sim_s": ts_s, "cycle_sim_s": cy_s,
               "emu_slowdown": emu_s / native_s,
               "tracesim_slowdown": ts_s / native_s,
               "cyclesim_slowdown": cy_s / native_s,
               "speedup_vs_tracesim": ts_s / emu_s,
               "speedup_vs_cyclesim": cy_s / emu_s}
        rows.append(row)
        print(f"  {name:11s} n={n} native {native_s * 1e3:.4f} ms; "
              f"emulator {emu_s * 1e3:.3f} ms (median of 3: "
              + ", ".join(f"{w * 1e3:.3f}" for w in walls)
              + f"), trace_sim {ts_s:.3f} s, cycle_sim {cy_s:.3f} s; "
              f"slowdowns {row['emu_slowdown']:.2f}x / "
              f"{row['tracesim_slowdown']:.1f}x / "
              f"{row['cyclesim_slowdown']:.1f}x; speedups "
              f"{row['speedup_vs_tracesim']:.1f}x / "
              f"{row['speedup_vs_cyclesim']:.1f}x", flush=True)

    def geomean(key):
        return float(np.exp(np.mean(np.log([r[key] for r in rows]))))
    print(f"  Fig 7 geomeans over {len(rows)} workloads: slowdowns emulator "
          f"{geomean('emu_slowdown'):.3f}x, trace_sim "
          f"{geomean('tracesim_slowdown'):.1f}x, cycle_sim "
          f"{geomean('cyclesim_slowdown'):.1f}x; speedups "
          f"{geomean('speedup_vs_tracesim'):.1f}x over trace_sim, "
          f"{geomean('speedup_vs_cyclesim'):.1f}x over cycle_sim "
          f"[{card}]", flush=True)
    layouts = dict(cs.KERNEL.variant_launches)
    if layouts["shared"] or not layouts["workspace"]:
        raise Mismatch(f"Fig 7 at chunk {FIG7_CHUNK}: layouts {layouts}")
    return {"launches": {"hmmu_lookup": hl.KERNEL.launches,
                         "chunk_step": cs.KERNEL.launches}, "rows": rows}


def chunk_layout_line(cs) -> str:
    v = cs.KERNEL.variant_launches
    return f"layouts {{'shared': {v['shared']}, 'workspace': {v['workspace']}}}"


def check_large_chunks(torch, dev, rt, hl, cs, card: str,
                       parts: str = "rs") -> dict:
    """Phase 13 (c): kernel B past its shared-memory chunk ceiling (see the
    module docstring); ``parts`` "r" the routes at chunk 4096, "s" the
    B = 2 sweeps and the times. Returns us per chunk by chunk size."""
    from repro_torch.sweep import SweepSpec, build_points
    from repro_torch.trace import workload_trace
    trace, _, n = workload_trace("520.omnetpp", scale=1e-4, device=dev)
    paper = rt.paper_platform()
    for chunk in LARGE_CHUNKS:
        layout, words = cs.chunk_layout(str(dev), chunk, paper.n_banks)
        print(f"  chunk {chunk}: {layout} layout, {words * 4} B a design "
              "point", flush=True)
    if "r" in parts:
        cfg = paper.with_(chunk=FIG7_CHUNK, policy="hotness",
                          hot_threshold=4)
        n_chunks = -(-n // cfg.chunk)
        got = {}
        for route, want in (("auto", {"hmmu_lookup": 0, "chunk_step": 1}),
                            ("off", {"hmmu_lookup": n_chunks,
                                     "chunk_step": 0})):
            hl.KERNEL.launches = 0
            cs.KERNEL.reset()
            t0 = time.perf_counter()
            res = rt.Engine(cfg.with_(chunk_step_kernel=route)).run(trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {"hmmu_lookup": hl.KERNEL.launches,
                      "chunk_step": cs.KERNEL.launches}
            print(f"  chunk {cfg.chunk} on {route!r} over {n} requests "
                  f"({n_chunks} chunks): launches {counts}, "
                  f"{chunk_layout_line(cs)}; wall {wall:.3f} s", flush=True)
            if counts != want:
                raise Mismatch(f"chunk {cfg.chunk} on {route!r}: launches "
                               f"{counts}, not {want}")
            got[route] = (res.state, res.outs)
        if cs.KERNEL.variant_launches["workspace"] != 0:
            raise Mismatch("'off' launched kernel B")
        same_runs(torch, f"chunk {cfg.chunk}: 'auto' against 'off'",
                  got["auto"], got["off"])
        check_outputs(torch, rt, cfg, rt.RunResult(*got["auto"]), n)
        print(f"  chunk {cfg.chunk}: 'auto' (kernel B, workspace layout) "
              "bitwise equal to 'off'", flush=True)
        del got, res
    us = {}
    if "s" in parts:
        for chunk in LARGE_CHUNKS:
            base = paper.with_(chunk=chunk, hot_threshold=4)
            spec = SweepSpec(base, policies=("hotness", "write_bias"))
            eng = rt.Engine(base)
            cs.KERNEL.reset()
            res = eng.sweep(spec, trace)
            torch.cuda.synchronize()
            layout = chunk_layout_line(cs)
            if cs.KERNEL.launches != 1:
                raise Mismatch(f"chunk {chunk} sweep: {cs.KERNEL.launches} "
                               "launches")
            want_layout = cs.chunk_layout(str(dev), chunk, base.n_banks)[0]
            if cs.KERNEL.variant_launches[want_layout] != 1:
                raise Mismatch(f"chunk {chunk} sweep: {layout}, not the "
                               f"{want_layout} layout")
            for i, p in enumerate(build_points(spec)):
                same_runs(torch, f"chunk {chunk}, B = 2, point {i} "
                          f"({p.label}) against its Engine.run",
                          point_run(res, i, n),
                          eng.run(trace, params=p.params(dev)))
            n_chunks = -(-n // chunk)
            runs = [device_and_wall_ms(torch, lambda: eng.run(trace), 1,
                                       "chunk_step_kernel")
                    for _ in range(3)]
            k_ms, w_ms = sorted(runs)[1]
            us[chunk] = k_ms / n_chunks * 1e3
            print(f"  chunk {chunk}: B = 2 sweep (hotness, write_bias) in "
                  f"one launch, {layout}: each point bitwise equal to its "
                  f"own Engine.run; kernel B {us[chunk]:.3f} us/chunk at "
                  f"B = 1 (median of 3 traced runs: " + ", ".join(
                      f"{d / n_chunks * 1e3:.3f}" for d, _ in runs)
                  + f"), {k_ms * 1e3 / n:.5f} us/request, device share "
                  f"{k_ms / w_ms:.3f} [{card}]", flush=True)
            del res
    return us


def load_example(name: str):
    """Import ``examples/<name>.py`` as a module (the examples directory
    on ``sys.path``, for the ones that import each other)."""
    import importlib.util
    examples = str(ROOT / "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_examples(torch, dev, hl, cs) -> dict:
    """Phase 13 (d): the five ported examples on the card, in this process
    (their launches counted), each run to its end with its own
    assertions; returns the launches of kernels A and B."""
    import contextlib
    import io
    import tempfile
    launches = {"hmmu_lookup": 0, "chunk_step": 0}
    with tempfile.TemporaryDirectory(prefix="phase13_", dir=ROOT / "build"
                                     if (ROOT / "build").is_dir() else None
                                     ) as tmp:
        for name, args in EXAMPLES:
            argv = ["--device", str(dev), *args]
            if name == "policy_exploration_torch":
                argv += ["--out", str(pathlib.Path(tmp) / "heatmap.csv")]
            hl.KERNEL.launches = 0
            cs.KERNEL.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    load_example(name).main(argv)
                torch.cuda.synchronize()
            except Exception as e:
                print(buf.getvalue())
                raise Mismatch(f"example {name} {' '.join(args)}: "
                               f"{type(e).__name__}: {e}") from e
            counts = {"hmmu_lookup": hl.KERNEL.launches,
                      "chunk_step": cs.KERNEL.launches}
            for k in launches:
                launches[k] += counts[k]
            print(f"  examples/{name}.py {' '.join(argv)}: "
                  f"{time.perf_counter() - t0:.2f} s, launches {counts}:")
            for line in buf.getvalue().splitlines():
                print(f"    | {line}")
            if counts["chunk_step"] == 0:
                raise Mismatch(f"example {name} never launched kernel B")
    return launches


def check_slice13(torch, dev, rt, hl, cs, card: str) -> dict:
    """Phase 13 (a)-(d); returns the launches of each part."""
    print("  (a) chunk 1 against the sequential simulators, paper geometry",
          flush=True)
    oracle = check_oracle(torch, dev, rt, hl, cs)
    print(f"  (b) Fig 7 at chunk {FIG7_CHUNK} ({card})", flush=True)
    fig7 = check_fig7(torch, dev, rt, hl, cs, card)
    print("  (c) large chunks: the shared-memory and workspace layouts",
          flush=True)
    us = check_large_chunks(torch, dev, rt, hl, cs, card)
    print("  (d) the five examples on the card", flush=True)
    examples = check_examples(torch, dev, hl, cs)
    return {"oracle": oracle, "fig7": fig7["launches"], "us": us,
            "examples": examples}


# --------------------------------------------------------------- phase 14
# (a) The split sweep: phase 7's grid and trace over shares of the one
# card. 16 points on 2 shares are 8 + 8; on 3 they pad to 18 (6 + 6 + 6).
SPLIT_SHARES = (2, 3)
SPLIT_OFF_CHUNKS = 64


def check_split_sweep(torch, dev, rt, hl, cs, base, spec, trace,
                      card: str) -> dict:
    """Phase 14 (a): ``Engine.sweep(mesh=...)`` over 2 and 3 shares of the
    card bitwise equal to phase 7's single launch (one launch of kernel B
    a share); a split ``continue_sweep`` equal to the whole sweep; the
    ``"off"`` route split over 3 shares on a cut trace equal to ``"auto"``;
    a CPU mesh refused by a CUDA engine. Returns the kernels' launches."""
    import dataclasses
    from repro_torch.engine import sweep_mesh
    Trace = rt.core.Trace
    eng = rt.Engine(base)
    n, chunk = len(trace), base.chunk
    whole = eng.sweep(spec, trace)
    torch.cuda.synchronize()
    launches = {"hmmu_lookup": 0, "chunk_step": 0}
    real = rt.engine._emulate_batch_impl
    events = []

    def timed(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*args, **kw)
        ev[1].record()
        events.append(ev)
        return out

    def split(what, fn, want_counts):
        events.clear()
        hl.KERNEL.launches = cs.KERNEL.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"hmmu_lookup": hl.KERNEL.launches,
                  "chunk_step": cs.KERNEL.launches}
        for k in launches:
            launches[k] += counts[k]
        if counts != want_counts:
            raise Mismatch(f"split sweep: {what}: launches {counts}, not "
                           f"{want_counts}")
        return res, wall, [a.elapsed_time(b) for a, b in events], counts

    rt.engine._emulate_batch_impl = timed
    try:
        for shares in SPLIT_SHARES:
            mesh = (dev,) * shares
            res, wall, ms, counts = split(
                f"{shares} shares", lambda: eng.sweep(spec, trace, mesh=mesh),
                {"hmmu_lookup": 0, "chunk_step": shares})
            same_runs(torch, f"{shares} shares of {dev} against the single "
                      "launch", (res.states, res.outs),
                      (whole.states, whole.outs))
            per = -(-len(res.points) // shares)
            print(f"  {len(res.points)} points over {shares} shares of {dev} "
                  f"({per} points a share, {per * shares - len(res.points)} "
                  f"padding): launches {counts}; each share's launch "
                  + ", ".join(f"{m:.3f}" for m in ms) + f" ms (device, CUDA "
                  f"events); wall {wall:.3f} s; bitwise equal to phase 7's "
                  f"single launch [{card}]", flush=True)
            del res
        half = (n // chunk // 2) * chunk
        mesh = (dev,) * SPLIT_SHARES[-1]
        first = eng.sweep(spec, Trace(*(x[:half] for x in trace)), mesh=mesh)
        cont = eng.continue_sweep(first, Trace(*(x[half:] for x in trace)),
                                  mesh=mesh)
        same_runs(torch, "a split continue_sweep against the whole sweep",
                  # reprolint: allow[donation] the first half's outputs only
                  (cont.states, {k: torch.cat([first.outs[k], cont.outs[k]],
                                              dim=1) for k in whole.outs}),
                  (whole.states, whole.outs))
        print(f"  continue_sweep over {len(mesh)} shares, requests {half}.."
              f"{n} after a split sweep of the first half: equal to the one "
              "sweep", flush=True)
        del first, cont, whole
        m = SPLIT_OFF_CHUNKS * chunk
        sub = Trace(*(x[:m] for x in trace))
        off = base.with_(chunk_step_kernel="off")
        got, wall, ms, counts = split(
            f"'off' over {len(mesh)} shares",
            lambda: rt.Engine(off).sweep(dataclasses.replace(spec, base=off),
                                         sub, mesh=mesh),
            {"hmmu_lookup": SPLIT_OFF_CHUNKS * len(mesh), "chunk_step": 0})
    finally:
        rt.engine._emulate_batch_impl = real
    want = eng.sweep(spec, sub)
    same_runs(torch, f"'off' over {len(mesh)} shares against 'auto'",
              (got.states, got.outs), (want.states, want.outs))
    print(f"  route 'off' over the first {SPLIT_OFF_CHUNKS} chunks on "
          f"{len(mesh)} shares: launches {counts} (one chunk loop a share); "
          f"wall {wall:.3f} s; equal to 'auto'", flush=True)
    del got, want
    try:
        eng.sweep(spec, sub, mesh=(torch.device("cpu"),))
        raise Mismatch("split sweep: a CPU mesh on a CUDA engine ran")
    except ValueError as e:
        if "engine's type" not in str(e):
            raise Mismatch(f"split sweep: a CPU mesh refused with {e!r}")
        refused = str(e)
    print(f"  sweep_mesh(): {len(sweep_mesh())} device(s) ({card}); a CPU "
          f"mesh on a CUDA engine: {refused}. One card: scaling over cards "
          "is not measured here", flush=True)
    return launches


# (b) The sharded models: 2 gloo ranks sharing the card (data 1 x model 2;
# NCCL takes no two ranks on one device), each model at full width with
# its depth cut, held to the same model unsharded on the card.
SHARD_RANKS = 2
SHARD_HYMBA = dict(layers=2, batch=1, seq=2048, smax=4096, steps=2)
SHARD_MOE = dict(layers=2, batch=2, seq=512)
SHARD_MOE_BINDING = 1.0         # a capacity factor at which capacity binds
SHARD_DECODE = dict(layers=2, batch=2, seq=1024, smax=2048, steps=4)
# dist_decode's float32 output sharded against unsharded: the float32
# attention allowance (``ref.kernel_error``).


def _rank_setup(torch):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import ShardCtx
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dev, ShardCtx.from_mesh(make_dev_mesh(model=SHARD_RANKS))


def _spy_first(module, name, store: list):
    """Wrap ``module.name`` so that every call's output (its first item for
    a tuple) is kept in ``store``; returns the original."""
    real = getattr(module, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        store.append((out[0] if isinstance(out, tuple) else out).detach()
                     .clone())
        return out
    setattr(module, name, spy)
    return real


def _timed(torch, fn):
    """(fn's result, device milliseconds between two CUDA events around
    it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _shard_hymba(torch, dev, sh, fails) -> dict:
    """hymba-1.5b (25 heads: no even model axis divides them), a prefill
    past the window on the context-parallel path, then decode steps over
    rings split on their slot axis: layer 0's attention rows (the CP
    all-gather) and layer 1's ring slice within ``CACHE_REL``, every
    logit within ``LOGIT_TOL`` of the unsharded run."""
    from repro_torch import configs
    from repro_torch.models import (ShardCtx, decode_step, init_params,
                                    layers, prefill)
    c = SHARD_HYMBA
    cfg = configs.get("hymba-1.5b").with_(n_layers=c["layers"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (c["batch"], c["seq"]),
                           generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (c["steps"], c["batch"]),
                         generator=gen, device=dev)
    if not layers.use_context_parallel(cfg, sh, c["batch"], c["seq"]):
        fails.append("hymba: the context-parallel path is not taken")

    def run(ctx):
        rows = []
        real = _spy_first(layers, "attend", rows)
        try:
            with torch.no_grad():
                lg, cache, pos = prefill(cfg, params, prompt, ctx, c["smax"])
                out = [lg]
                for t in toks:
                    lg, cache, pos = decode_step(cfg, params, t, cache, pos,
                                                 ctx)
                    out.append(lg)
        finally:
            layers.attend = real
        return out, cache, rows[0]
    (ref, ref_cache, ref_rows) = run(ShardCtx())
    sh.traffic.reset()
    (got, cache, rows), ms = _timed(torch, lambda: run(sh))
    out = {"device_ms": ms}
    out["attention"] = hold(fails, "hymba: layer 0's context-parallel "
                            "attention rows", rel_share(torch, rows, ref_rows,
                                                        CACHE_REL))
    n = cache[1]["k"].shape[2]
    lo = sh.coord("model") * n
    out["ring"] = hold(fails, "hymba: layer 1's ring slice", max(
        rel_share(torch, cache[1][k], ref_cache[1][k][:, :, lo:lo + n],
                  CACHE_REL) for k in ("k", "v")))
    out["logits"] = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(got, ref))
    hold(fails, "hymba: the logits", out["logits"] / LOGIT_TOL)
    out["what"] = (f"hymba-1.5b, {c['layers']} of 32 layers at full width, "
                   f"prefill {c['batch']} x {c['seq']} on the CP path "
                   f"(window {cfg.window}), {c['steps']} decode steps, rings "
                   f"of {n} slots a rank")
    return out


def _composed_moe(torch, moe, tp: int):
    """The reference's ``_moe_shard_map`` on one device from the port's own
    per-shard functions: each model rank's sequence slice routed with its
    own capacity through every expert and combined; the switch
    statistics averaged over the ranks."""
    def moe_block(cfg, p, x, sh):
        b, s, d = x.shape
        sl = s // tp
        c_dev = moe.capacity(cfg, b * sl)
        cols, mes, ces = [], [], []
        for j in range(tp):
            xt = x[:, j * sl:(j + 1) * sl].reshape(b * sl, d)
            buf, idx, gates, pos, keep, me, ce = moe._route_scatter(
                cfg, p["router"], xt, c_dev)
            eo = moe._expert_ffn(p, buf, cfg.adtype)
            cols.append(moe._combine(eo, idx, gates, pos, keep, cfg.adtype)
                        .reshape(b, sl, d))
            mes.append(me)
            ces.append(ce)
        aux = moe._aux_loss(cfg, sum(mes) / tp, sum(ces) / tp)
        return torch.cat(cols, 1), aux
    return moe_block


def _shard_moe(torch, dev, sh, fails) -> dict:
    """phi3.5-moe (16 experts, 8 a rank) through the expert-parallel
    forward and backward: at capacity factor E / k (nothing dropped)
    against the unsharded dense path, and at ``SHARD_MOE_BINDING``, where
    every rank drops slots, against the per-rank composition; layer 0's
    MoE output within ``CACHE_REL``, the loss within 2^-9 of it, and
    layer 0's gradients (the rank's experts' slice) within ``GRAD_REL``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import (ShardCtx, init_params, loss_fn, moe,
                                    reduce_grads, shard_params, transformer)
    from repro_torch.models.layers import fp32_sums
    from repro_torch.tree import leaves as tree_leaves, tree_map
    c = SHARD_MOE
    base = configs.get("phi3.5-moe-42b-a6.6b").with_(n_layers=c["layers"])
    e = base.moe
    dcfg = DataConfig(vocab=base.vocab, seq_len=c["seq"],
                      global_batch=c["batch"], seed=0)
    batch = make_batch(dcfg, 0, dev)
    out = {"device_ms": 0.0}

    def run(cfg, params, ctx, block=None):
        outs, dropped = [], []
        real = _spy_first(moe, "moe_block", outs)
        route = moe._route_scatter

        def counting(*a):
            r = route(*a)
            dropped.append(int((~r[4]).sum()))
            return r
        moe._route_scatter = counting
        if block is not None:
            moe.moe_block = _wrap_out(block, outs)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        try:
            with fp32_sums():
                loss, _ = loss_fn(cfg, params, batch, ctx)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
        finally:
            moe.moe_block, moe._route_scatter = real, route
        for t in leaves:
            t.requires_grad_(False)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        return float(loss.detach()), grads, outs[0], sum(dropped)

    for label, factor in (("no drop", e.n_experts / e.top_k),
                          ("binding", SHARD_MOE_BINDING)):
        cfg = base.with_(moe=dataclasses.replace(e, capacity_factor=factor))
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        block = None if label == "no drop" else _composed_moe(
            torch, moe, sh.size("model"))
        ref_loss, ref_grads, ref_out, ref_drop = run(cfg, params, ShardCtx(),
                                                     block)
        local = shard_params(cfg, params, sh)
        del params
        sh.traffic.reset()
        (loss, grads, got, drop), ms = _timed(
            torch, lambda: run(cfg, local, sh))
        grads = reduce_grads(cfg, grads, sh)
        out["device_ms"] += ms
        e_loc = e.n_experts // sh.size("model")
        lo = sh.coord("model") * e_loc
        shares = {}
        for path, g in leaf_items(transformer._layer(grads, 0)):
            want = transformer._layer(ref_grads, 0)
            for k in path.strip("/").split("/"):
                want = want[k]
            if path.startswith("/mlp/w_"):
                want = want[lo:lo + e_loc]
            shares[path] = rel_norm(torch, g, want) / GRAD_REL
            hold(fails, f"phi3.5-moe ({label}): layer 0's gradient {path}",
                 shares[path])
        worst = max(shares, key=shares.get)
        out[label] = {
            "loss": (loss, ref_loss), "dropped": (drop, ref_drop),
            "moe_out": hold(fails, f"phi3.5-moe ({label}): layer 0's MoE "
                            "output", rel_share(torch, got, ref_out,
                                                CACHE_REL)),
            "grad": (worst, shares[worst]), "traffic": sh.traffic.as_dict()}
        hold(fails, f"phi3.5-moe ({label}): the loss",
             abs(loss - ref_loss) / abs(ref_loss) / 2.0 ** -9)
        if (drop > 0) != (label == "binding"):
            fails.append(f"phi3.5-moe ({label}): {drop} slots dropped")
        del local, grads, ref_grads
        torch.cuda.empty_cache()
    out["what"] = (f"phi3.5-moe-42b, {c['layers']} of 32 layers at full "
                   f"width, {e.n_experts} experts ({e.n_experts // 2} a "
                   f"rank), batch {c['batch']} x {c['seq']}, forward and "
                   "backward")
    return out


def _wrap_out(fn, store: list):
    def spy(*a, **kw):
        out = fn(*a, **kw)
        store.append(out[0].detach().clone())
        return out
    return spy


def _shard_decode(torch, dev, sh, fails) -> dict:
    """minitron-8b: a prefill, then decode steps with the KV cache split on
    its sequence axis (each rank writes only the rows it holds): layer
    0's ``dist_decode`` output within the float32 attention allowance of
    the unsharded one, the cache slices within ``CACHE_REL`` and every
    logit within ``LOGIT_TOL``."""
    from repro_torch import configs
    from repro_torch.kernels import ref as kref
    from repro_torch.models import (ShardCtx, decode_step, init_params,
                                    prefill, transformer)
    c = SHARD_DECODE
    cfg = configs.get("minitron-8b").with_(n_layers=c["layers"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (c["batch"], c["seq"]),
                           generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (c["steps"], c["batch"]),
                         generator=gen, device=dev)

    def run(ctx):
        attn = []
        real = _spy_first(transformer, "dist_decode", attn)
        try:
            with torch.no_grad():
                lg, cache, pos = prefill(cfg, params, prompt, ctx, c["smax"])
                out = [lg]
                for t in toks:
                    lg, cache, pos = decode_step(cfg, params, t, cache, pos,
                                                 ctx)
                    out.append(lg)
        finally:
            transformer.dist_decode = real
        return out, cache, attn[::cfg.n_layers]
    ref, ref_cache, ref_attn = run(ShardCtx())
    sh.traffic.reset()
    (got, cache, attn), ms = _timed(torch, lambda: run(sh))
    out = {"device_ms": ms}
    out["dist_decode"] = hold(fails, "minitron-8b: layer 0's sharded "
                              "dist_decode", max(
                                  kref.kernel_error("attention", a, b)[1]
                                  for a, b in zip(attn, ref_attn)))
    n = cache["k"].shape[3]
    lo = sh.coord("model") * n
    out["cache"] = hold(fails, "minitron-8b: the cache slice", max(
        rel_share(torch, cache[k], ref_cache[k][:, :, :, lo:lo + n],
                  CACHE_REL) for k in ("k", "v")))
    out["logits"] = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(got, ref))
    hold(fails, "minitron-8b: the logits", out["logits"] / LOGIT_TOL)
    out["what"] = (f"minitron-8b, {c['layers']} of 32 layers at full width, "
                   f"prefill {c['batch']} x {c['seq']}, {c['steps']} decode "
                   f"steps over a cache of {c['smax']} rows split "
                   f"{n} a rank")
    return out


SHARD_CASES = {"hymba": _shard_hymba, "moe": _shard_moe,
               "decode": _shard_decode}


def sharded_rank(rank: int, world: int, case: str) -> dict:
    """One rank of phase 14 (b) (``launch.mesh.run_ranks``): the case's
    checks, its device time, traffic and peak memory."""
    import torch
    dev, sh = _rank_setup(torch)
    from repro_torch.kernels import (chunk_step, decode_attention,
                                     flash_attention, hmmu_lookup, rwkv_scan)
    fails: list = []
    torch.cuda.reset_peak_memory_stats()
    out = SHARD_CASES[case](torch, dev, sh, fails)
    out.update(rank=rank, fails=fails, traffic=sh.traffic.as_dict(),
               peak=torch.cuda.max_memory_allocated(),
               launches={m.KERNEL.name: m.KERNEL.launches for m in (
                   hmmu_lookup, chunk_step, flash_attention,
                   decode_attention, rwkv_scan)})
    return out


def check_sharded_models(torch, card: str, cases=tuple(SHARD_CASES)
                         ) -> dict:
    """Phase 14 (b): each case of ``SHARD_CASES`` in ``SHARD_RANKS`` gloo
    ranks on the card; raises once, naming each check that failed.
    Returns the kernels' launches summed over the ranks."""
    from repro_torch.launch.mesh import run_ranks
    fails = []
    launches: dict = {}
    (ROOT / "build").mkdir(exist_ok=True)
    for case in cases:
        t0 = time.perf_counter()
        res = run_ranks(sharded_rank, SHARD_RANKS, (case,), timeout_s=600,
                        work_dir=ROOT / "build")
        print(f"  {res[0]['what']} ({time.perf_counter() - t0:.1f} s with "
              "the ranks' start):", flush=True)
        for r in res:
            fails += [f"rank {r['rank']}: {f}" for f in r["fails"]]
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
            t = r["traffic"]
            nums = {k: v for k, v in r.items() if k not in (
                "what", "rank", "fails", "traffic", "peak", "device_ms",
                "launches")}
            print(f"    rank {r['rank']}: device {r['device_ms']:.1f} ms; "
                  f"bytes a collective {t['bytes']} in {t['calls']} calls; "
                  f"host round trips {t['round_trips']} moving "
                  f"{t['round_trip_bytes']} B; peak memory "
                  f"{r['peak'] / 1e9:.2f} GB; {_fmt(nums)} [{card}]",
                  flush=True)
    print(f"  the ranks' kernel launches: {launches}", flush=True)
    if fails:
        raise Mismatch("sharded models: FAILED: " + "; ".join(fails))
    return launches


def _fmt(x) -> str:
    if isinstance(x, float):
        return f"{x:.4g}"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k}: {_fmt(v)}" for k, v in x.items()
                               if k != "traffic") + "}"
    if isinstance(x, (tuple, list)):
        return "(" + ", ".join(_fmt(v) for v in x) + ")"
    return str(x)


def check_slice14(torch, dev, rt, hl, cs, card: str) -> dict:
    """Phase 14 (a) and (b); returns each kernel's launches over both."""
    print("  (a) the split sweep", flush=True)
    base, spec = sweep_grid(rt)
    trace = sweep_trace(torch, dev, rt)
    launches = check_split_sweep(torch, dev, rt, hl, cs, base, spec, trace,
                                 card)
    del trace
    torch.cuda.empty_cache()
    print(f"  (b) the sharded models: {SHARD_RANKS} gloo ranks on {dev}",
          flush=True)
    for k, v in check_sharded_models(torch, card).items():
        launches[k] = launches.get(k, 0) + v
    return launches


# --------------------------------------------------------------- phase 15
# Training over a mesh (``launch.train.run --mesh dev``) in MESH_RANKS gloo
# ranks sharing the card, each model at full width with its depth cut:
# the weights held by ``launch.shardings.param_specs``, the moments and
# the gradient accumulator by ``zero1_specs`` (ZeRO-1/2). Every run is
# held to the single-device run of the same ``launch.train.run`` (the
# same seed, weights, batches and schedule) that rank 0 makes first.
class MeshTrain(NamedTuple):
    part: str
    arch: str
    layers: int            # of the configuration's, which keeps its widths
    batch: int
    seq: int
    micro: int
    steps: int
    fsdp: bool             # the launcher splits the weights over "data" too
    crash: int | None      # the elastic restart: from the checkpoint here
    grad_rel: float        # the first step's gradients, norm-wise


# The mesh against one device, both in bfloat16: each rank's products
# cover 1 or 2 rows where one device's cover 2 or 4, so cuBLAS may pick
# other kernels and round apart (one bfloat16 step is 2^-9 to 2^-8 of a
# value). A loss averages ~2,000 such logits (rtol 2^-10); the 4 steps'
# losses and grad norms drift no further than 2^-8. A dense gradient's
# norm-wise error is a few roundings along its path (2^-6). The MoE's is
# not: a router gradient sums gate terms that cancel, and the error of
# the router reaches every leaf below it. phi3.5-moe's mesh (experts
# split over both axes, the expert-parallel path) and one device agree
# within 5.4e-6 on every leaf in float32 (``chip_mesh_f32.py``), and
# read up to 0.060 apart in bfloat16 at 2 layers (the router; 0.035-0.042
# elsewhere) and up to 0.0073 at the 1 layer run here (the token table):
# 2^-5 holds that with room for another draw of the bfloat16 roundings.
MESH_RANKS = 4
MESH_TRAINS = (
    MeshTrain("a", "internlm2-1.8b", 2, 4, 512, 2, 4, False, 2, 2.0 ** -6),
    # 16 experts: 8 a rank on "model", each split once more on "data"; one
    # layer, for the time gloo takes to gather the experts (PERF.md §5)
    MeshTrain("b", "phi3.5-moe-42b-a6.6b", 1, 2, 1024, 1, 2, True, None,
              2.0 ** -5),
)
MESH_MODEL = 2                  # (data 2, model 2); the restart (1, 4)
MESH_LR = 3e-4
MESH_LOSS_RTOL = 2.0 ** -10
MESH_STEPS_RTOL = 2.0 ** -8
MESH_COMPRESS_REL = 0.02        # tests/test_grad_compression.py's bar


def _leaf_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in leaf_items(tree))


def _held_check(sh, tree, specs, shapes, what: str, fails: list) -> int:
    """The bytes this rank holds of ``tree``; each leaf must hold its
    whole size over the product of the axis sizes of its spec."""
    from repro_torch.models.sharding import spec_axes
    from repro_torch.tree import leaves
    for (path, t), spec, shape in zip(leaf_items(tree), leaves(specs),
                                      leaves(shapes)):
        ways = math.prod(sh.size(a) for a in spec_axes(spec))
        want = math.prod(shape) * t.element_size() // ways
        if t.numel() * t.element_size() != want:
            fails.append(f"{what}{path}: {t.numel() * t.element_size()} B "
                         f"held, the spec {spec} says {want}")
    return _leaf_bytes(tree)


@contextlib.contextmanager
def _uncounted(traffic):
    """Inside, the collectives a check makes are left out of ``traffic``."""
    if traffic is None:
        yield
        return
    saved = (traffic.bytes.copy(), traffic.calls.copy(),
             traffic.seconds.copy(), traffic.round_trips,
             traffic.round_trip_bytes)
    try:
        yield
    finally:
        (traffic.bytes, traffic.calls, traffic.seconds, traffic.round_trips,
         traffic.round_trip_bytes) = saved


def _spy_train(torch, train, rec: dict, first):
    """Wrap ``train.make_train_step`` so that each step's loss, grad norm,
    wall and collective bytes (on a mesh) are kept in ``rec``, the FLOPs
    of step ``FLOPS_STEP`` too (``FlopCounterMode``), and ``first(cfg,
    opt_cfg, sh, grad_specs, (loss, metrics, grads), params, opt)`` checks
    the first step's gradients between its two halves (outside the step's
    wall and its traffic); returns the original."""
    from torch.utils.flop_counter import FlopCounterMode
    real = train.make_train_step

    def make(cfg, opt_cfg, sh, micro_batches=1, grad_specs=None):
        step = real(cfg, opt_cfg, sh, micro_batches=micro_batches,
                    grad_specs=grad_specs)
        grads_of = step.compute_grads

        def spied(params, opt, batch):
            checks = []

            def grads_then_check(p, b):
                out = grads_of(p, b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with _uncounted(sh.traffic):
                    rec["first"] = first(cfg, opt_cfg, sh, grad_specs, out, p,
                                         opt)
                checks.append(time.perf_counter() - t0)
                return out
            if not rec.get("first"):
                step.compute_grads = grads_then_check
            count = len(rec.get("losses", ())) == FLOPS_STEP
            before = dict(sh.traffic.bytes) if sh.traffic else {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                with FlopCounterMode(display=False) if count else \
                        contextlib.nullcontext() as flops:
                    params, opt, m = step(params, opt, batch)
                loss = float(m["loss"])
            finally:
                step.compute_grads = grads_of
            rec.setdefault("step_s", []).append(
                time.perf_counter() - t0 - sum(checks))
            if count:
                rec["step_flops"] = flops.get_total_flops()
            if sh.traffic:
                rec.setdefault("step_bytes", []).append({
                    k: v - before.get(k, 0) for k, v in
                    sh.traffic.bytes.items() if v != before.get(k, 0)})
            rec.setdefault("losses", []).append(loss)
            rec.setdefault("norms", []).append(float(m["grad_norm"]))
            rec["sh"] = sh
            return params, opt, m
        return spied
    train.make_train_step = make
    return real


MESH_REF = ROOT / "build" / "phase15_ref_grads.pt"
FLOPS_STEP = 1      # the step whose FLOPs phase 16 predicts (no check in it)


def _ref_first(torch):
    """The single-device run's first step: its loss and global norm, and
    its gradients written to ``MESH_REF`` for the ranks to read."""
    def first(cfg, opt_cfg, sh, grad_specs, grads, params, opt):
        from repro_torch.optim import global_norm
        loss, _, g = grads
        torch.save({p: t.detach().cpu() for p, t in leaf_items(g)}, MESH_REF)
        return {"loss": float(loss), "norm": float(global_norm(g))}
    return first


def _block_sums(torch, got, want) -> tuple:
    """(sum of (got - want)^2, sum of want^2) in float64, some 2^24
    elements at a time."""
    d = w = 0.0
    got = got.detach().reshape(got.shape[0] if got.dim() else 1, -1)
    want = want.detach().reshape(got.shape)
    rows = max(1, (1 << 24) // max(1, got.shape[1]))
    for i in range(0, got.shape[0], rows):
        a, b = got[i:i + rows].double(), want[i:i + rows].double()
        d += float(((a - b) ** 2).sum())
        w += float((b * b).sum())
    return d, w


def _mesh_first(torch, row, ref, fails):
    """The mesh run's first step: the bytes this rank holds against the
    specs; the global loss and norm against the single-device run's; each
    gradient leaf's norm-wise error against the single device's, from
    every rank's block of it (the blocks' sums added over the axes that
    split them); and ZeRO-1's update (``_zero1_check``)."""
    def first(cfg, opt_cfg, sh, zspecs, grads, params, opt):
        import torch.distributed as tdist
        from repro_torch import dist
        from repro_torch.launch import shardings as shd
        from repro_torch.models.sharding import local_slice, spec_axes
        from repro_torch.optim import global_norm
        from repro_torch.tree import leaves
        loss, _, g = grads
        shapes = shd.param_shapes(cfg)
        if sh.stored != shd.param_specs(cfg, sh, row.fsdp):
            fails.append(f"{row.arch} on the mesh: the launcher holds the "
                         "weights by other specs than param_specs(fsdp="
                         f"{row.fsdp})")
        held = {
            "params": _held_check(sh, params, sh.stored, shapes, "params",
                                  fails),
            "moments": _held_check(sh, opt.mu, zspecs, shapes, "mu", fails)
            + _held_check(sh, opt.nu, zspecs, shapes, "nu", fails),
            "accumulator": _held_check(sh, g, zspecs, shapes, "grads",
                                       fails)}
        if cfg.moe:
            held["experts"] = sum(
                t.numel() * t.element_size() for k, t in
                params["layers"]["mlp"].items() if k in ("w_in", "w_gate",
                                                         "w_out"))
        out = {"held": held, "loss": float(loss), "grad": ("", 0.0),
               "grads": {}, "norm": float(global_norm(g, sh, zspecs))}
        out["norm_blocks"] = _norm_over_blocks(torch, sh, g, zspecs)
        if out["norm"] != out["norm_blocks"]:
            fails.append(f"{row.arch} on the mesh: the global norm "
                         f"{out['norm']!r} is not the sum over the distinct "
                         f"blocks {out['norm_blocks']!r}")
        want_all = torch.load(MESH_REF, mmap=True)
        for (path, t), spec in zip(leaf_items(g), leaves(zspecs)):
            want = local_slice(want_all[path], spec, sh).to(t.device)
            sums = torch.tensor(_block_sums(torch, t, want),
                                dtype=torch.float64, device=t.device)
            axes = tuple(a for a in sh.names if a in spec_axes(spec))
            d, w = dist.sum_f64(sums, sh, axes).tolist()
            share = (d / max(w, 1e-300)) ** 0.5 / row.grad_rel
            out["grads"][path] = share
            hold(fails, f"{row.arch} on the mesh: the first step's gradient "
                 f"{path}", share)
            if share >= out["grad"][1]:
                out["grad"] = (path, share)
            del want
        del want_all
        tdist.barrier()
        if ref is not None:
            out.update(ref_loss=ref["loss"], ref_norm=ref["norm"])
            hold(fails, f"{row.arch} on the mesh: the first step's loss",
                 abs(out["loss"] - ref["loss"]) / abs(ref["loss"])
                 / MESH_LOSS_RTOL)
            hold(fails, f"{row.arch} on the mesh: the first step's global "
                 "norm", abs(out["norm"] - ref["norm"]) / ref["norm"]
                 / MESH_STEPS_RTOL)
        if not row.fsdp:
            out["zero1"] = _zero1_check(torch, opt_cfg, sh, params, opt, g,
                                        zspecs, fails, row)
        return out
    return first


def _norm_over_blocks(torch, sh, g, specs) -> float:
    """The global norm of gradient blocks another way: every rank's float64
    partial sum of each leaf all-gathered, then each leaf's partials added
    over one rank of each distinct block (the ranks at coordinate 0 on the
    axes the leaf's spec leaves out)."""
    from repro_torch.models.sharding import gather, rank_coords, spec_axes
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    parts = torch.stack([adamw._square_sum(t) for t in leaves(g)])
    every = gather(parts[None], (tuple(sh.names),), sh)      # [world, leaves]
    total = torch.zeros((), dtype=torch.float64, device=parts.device)
    for j, spec in enumerate(leaves(specs)):
        split = spec_axes(spec)
        for r in range(every.shape[0]):
            coords = rank_coords(r, sh.axis_sizes)
            if all(coords[a] == 0 for a in sh.names if a not in split):
                total = total + every[r, j]
    return float(torch.sqrt(total.float()))


ZERO1_LEAVES = ("/layers/", "/final_norm")     # the vocabulary's left out


def _zero1_check(torch, opt_cfg, sh, params, opt, g, zspecs, fails,
                 row) -> dict:
    """The first step's AdamW on copies of this rank's blocks (ZeRO-1: the
    parameter blocks, and the moment and gradient blocks split once more
    over "data") against ``_update_leaf`` over the rank's whole parameter
    block, with its moment and gradient blocks all-gathered over "data"
    into that block and the same clipping: every parameter and moment
    bit for bit, for the leaves under ``ZERO1_LEAVES``."""
    from repro_torch.models.sharding import gather, local_slice
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, tree_map
    out = {"leaves": 0, "differ": 0}
    with torch.no_grad():
        copy = lambda tree: tree_map(lambda t: t.detach().clone(), tree)
        p1 = copy(params)
        st1 = adamw.OptState(copy(opt.mu), copy(opt.nu), opt.step.clone())
        _, _, m = adamw.adamw_update(opt_cfg, p1, g, st1, sh, sh.stored,
                                     zspecs)
        scale = adamw._clip_scale(m["grad_norm"], opt_cfg.clip_norm)
        c = adamw._scalars(opt_cfg, int(opt.step) + 1,
                           m["grad_norm"].device)
        for (path, p), pspec, zspec, gt, mu, nu, p_new, mu_new, nu_new in \
                zip(leaf_items(params), leaves(sh.stored), leaves(zspecs),
                    leaves(g), leaves(opt.mu), leaves(opt.nu), leaves(p1),
                    leaves(st1.mu), leaves(st1.nu)):
            if not path.startswith(ZERO1_LEAVES):
                continue
            added = adamw._added_axis(pspec, zspec, sh)
            if added is None:
                continue
            part = (None,) * added[0] + (added[1],)
            want = [p.detach().clone()] + [gather(t, part, sh).clone()
                                           for t in (gt, mu, nu)]
            adamw._update_leaf(*want, scale, c)
            out["leaves"] += 1
            same = torch.equal(p_new, want[0]) and all(
                torch.equal(a, local_slice(b, part, sh))
                for a, b in ((mu_new, want[2]), (nu_new, want[3])))
            if not same:
                out["differ"] += 1
                fails.append(f"{row.arch}: ZeRO-1's update of {path} "
                             "differs from the same step over the rank's "
                             "whole block")
            del want
        del p1, st1
    return out


def _hold_steps(fails, what, got, want) -> float:
    share = max(abs(a - b) / abs(b) for a, b in zip(got, want)) \
        / MESH_STEPS_RTOL
    hold(fails, what, share)
    return share


def _mesh_train(torch, dev, row: MeshTrain, fails: list) -> dict:
    """One row of ``MESH_TRAINS`` in this rank (see the module
    docstring)."""
    import dataclasses
    import torch.distributed as tdist
    from repro_torch import configs
    from repro_torch.launch import train
    rank0 = tdist.get_rank() == 0
    real_get = configs.get
    if "moe" in row.arch:
        # capacity factor E / k: neither path drops a token, so the
        # expert-parallel mesh and the dense single device compute alike
        def no_drop(arch):
            cfg = real_get(arch)
            return cfg.with_(moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        configs.get = no_drop
    args = ["--arch", row.arch, "--layers", str(row.layers), "--batch",
            str(row.batch), "--seq", str(row.seq), "--micro-batches",
            str(row.micro), "--steps", str(row.steps), "--lr", str(MESH_LR),
            "--log-every", "1000", "--device", str(dev)]
    mesh = ["--mesh", "dev"]
    out: dict = {}
    ref = None
    rec: dict = {}
    real = _spy_train(torch, train, rec, _ref_first(torch))
    try:
        if rank0:           # the single-device run, the others waiting
            _, out["ref_final_loss"] = train.run(args)
            ref = {"loss": rec["first"]["loss"],
                   "norm": rec["first"]["norm"], "losses": rec["losses"],
                   "norms": rec["norms"]}
            out["ref_step_s"] = rec["step_s"]
            rec.clear()
            torch.cuda.empty_cache()
        tdist.barrier()
        train.make_train_step = real
        _spy_train(torch, train, rec, _mesh_first(torch, row, ref, fails))
        torch.cuda.reset_peak_memory_stats()
        ck = _checkpoints(row, tdist)
        writes: list = []
        with _timed_writes(writes):
            p, out["final_loss"] = train.run(
                args + mesh + ["--mesh-model", str(MESH_MODEL)] + ck)
        out["peak"] = torch.cuda.max_memory_allocated()
        out.update(first=rec["first"], losses=rec["losses"],
                   step_s=rec["step_s"], step_bytes=rec["step_bytes"],
                   step_flops=rec.get("step_flops"),
                   traffic=rec["sh"].traffic.as_dict(),
                   axes=dict(rec["sh"].axis_sizes), writes=writes)
        if ref is not None:
            out["losses_share"] = _hold_steps(
                fails, f"{row.arch} on the mesh: the {row.steps} steps' "
                "losses", rec["losses"], ref["losses"])
            out["norms_share"] = _hold_steps(
                fails, f"{row.arch} on the mesh: the {row.steps} steps' "
                "grad norms", rec["norms"], ref["norms"])
            out["ref_losses"] = ref["losses"]
        del ref
        torch.cuda.empty_cache()
        if ck:
            out["restart"] = _elastic(torch, train, row, args + mesh, rec,
                                      out["losses"], p, fails)
        del p
    finally:
        train.make_train_step = real
        configs.get = real_get
        if rank0:
            MESH_REF.unlink(missing_ok=True)
    return out


MESH_CKPT = ROOT / "build" / "phase15_ckpt"


def _checkpoints(row: MeshTrain, tdist) -> list:
    """The straight run's checkpoint options where the row restarts: a
    checkpoint every ``row.crash`` steps into a fresh ``MESH_CKPT``."""
    if row.crash is None:
        return []
    if tdist.get_rank() == 0:
        shutil.rmtree(MESH_CKPT, ignore_errors=True)
    tdist.barrier()
    return ["--ckpt-dir", str(MESH_CKPT), "--ckpt-every", str(row.crash)]


@contextlib.contextmanager
def _timed_writes(writes: list):
    """Inside, each checkpoint write's seconds and bytes go to
    ``writes``."""
    from repro_torch.ckpt import checkpoint
    real_write = checkpoint._write

    def timed_write(directory, step, flat, extra):
        t0 = time.perf_counter()
        path = real_write(directory, step, flat, extra)
        writes.append((time.perf_counter() - t0, os.path.getsize(
            os.path.join(path, "arrays.npz"))))
        return path
    checkpoint._write = timed_write
    try:
        yield
    finally:
        checkpoint._write = real_write


def _elastic(torch, train, row, args, rec, straight, params, fails
             ) -> dict:
    """The elastic restart: the straight run's checkpoint at ``row.crash``
    on (data 2, model 2) (the later ones removed), resumed on (data 1,
    model 4) to the end; its losses and its final parameters (whole, as
    ``launch.train.run`` returns them) against the straight run's
    ``params``, every leaf norm-wise (a random model's loss barely
    depends on its weights, so the losses alone would miss a wrong
    block)."""
    import torch.distributed as tdist
    if tdist.get_rank() == 0:
        for d in MESH_CKPT.glob("step_*"):
            if int(d.name.split("_")[1].split(".")[0]) > row.crash:
                shutil.rmtree(d)
    tdist.barrier()
    out = {}
    try:
        rec.clear()
        rec["first"] = {"skipped": True}
        t0 = time.perf_counter()
        p, loss = train.run(args + ["--mesh-model", str(MESH_RANKS),
                                    "--ckpt-dir", str(MESH_CKPT)])
        out["resume_s"] = time.perf_counter() - t0
        out["axes"] = dict(rec["sh"].axis_sizes)
        out["losses"] = rec["losses"]
        out["share"] = _hold_steps(
            fails, f"{row.arch}: the elastic restart's losses on "
            f"{out['axes']}", rec["losses"], straight[row.crash:])
        want = dict(leaf_items(params))
        shares = {}
        for path, t in leaf_items(p):
            d, w = _block_sums(torch, t, want[path])
            shares[path] = (d / max(w, 1e-300)) ** 0.5 / MESH_STEPS_RTOL
            hold(fails, f"{row.arch}: the elastic restart's final {path}",
                 shares[path])
        out["params"] = max(shares.items(), key=lambda kv: kv[1])
        del p
    finally:
        tdist.barrier()
        if tdist.get_rank() == 0:
            shutil.rmtree(MESH_CKPT, ignore_errors=True)
    return out


def _mesh_compress(torch, dev, fails) -> dict:
    """Phase 15 (c): ``compressed_psum_spec`` over the 2-rank ``"pod"`` axis
    of a (pod 2, model 2) mesh, on internlm2-1.8b's layer shapes at full
    width, each pod's gradients at another magnitude: within
    ``MESH_COMPRESS_REL`` of the exact all-reduce, deterministic and
    stochastic, and each rank's int8 blocks and scales equal to
    ``compress_int8`` of the same gradients on the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs, dist
    from repro_torch.launch import shardings as shd
    from repro_torch.models import ShardCtx
    from repro_torch.optim import compress
    sh = ShardCtx.from_mesh(init_device_mesh("cpu", (2, 2),
                                             mesh_dim_names=("pod", "model")))
    pod = sh.coord("pod")
    shapes = shd.param_shapes(configs.get("internlm2-1.8b").with_(
        n_layers=1))["layers"]
    gen = torch.Generator(device=dev).manual_seed(100 + pod)
    grads = {k: {n: torch.randn(s, generator=gen, device=dev)
                 * (1e-3 * (1 + 2 * pod)) for n, s in v.items()}
             for k, v in shapes.items()}
    blocks = []
    real = compress.compress_int8

    def spy(x, g=None):
        q = real(x, g)
        if g is None:
            blocks.append((x, q))
        return q
    compress.compress_int8 = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = compress.compressed_psum_spec(grads, sh, "pod")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        sto = compress.compressed_psum_spec(
            grads, sh, "pod",
            torch.Generator(device=dev).manual_seed(7 + sh.coord("model")))
    finally:
        compress.compress_int8 = real
    out = {"wall_ms": ms, "traffic": sh.traffic.as_dict(), "elements": sum(
        t.numel() for _, t in leaf_items(grads))}
    for name, got in (("deterministic", det), ("stochastic", sto)):
        worst = 0.0
        for (path, g), (_, s) in zip(leaf_items(grads), leaf_items(got)):
            exact = dist.all_reduce(g, sh, "pod")
            worst = max(worst, float((s - exact).abs().max()
                                     / exact.abs().max()))
        out[name] = hold(fails, f"compressed_psum_spec ({name})",
                         worst / MESH_COMPRESS_REL)
    same = all(torch.equal(q[0].cpu(), c[0]) and torch.equal(q[1].cpu(), c[1])
               for x, q in blocks for c in [real(x.cpu())])
    if not same:
        fails.append("compressed_psum_spec: the card's int8 blocks differ "
                     "from compress_int8 on the CPU")
    out["blocks_equal"] = same
    return out


def mesh_train_rank(rank: int, world: int, parts: str) -> dict:
    """One rank of phase 15 (``launch.mesh.run_ranks``): the rows of
    ``MESH_TRAINS`` and (c) that ``parts`` names."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from repro_torch.kernels import (chunk_step, decode_attention,
                                     flash_attention, hmmu_lookup, rwkv_scan)
    fails: list = []
    out = {"rank": rank, "fails": fails, "runs": {}}
    for row in MESH_TRAINS:
        if row.part in parts:
            out["runs"][row.part] = _mesh_train(torch, dev, row, fails)
            torch.cuda.empty_cache()
    if "c" in parts:
        out["compress"] = _mesh_compress(torch, dev, fails)
    out["launches"] = {m.KERNEL.name: m.KERNEL.launches for m in (
        hmmu_lookup, chunk_step, flash_attention, decode_attention,
        rwkv_scan)}
    return out


def _gb(b) -> str:
    return f"{b / 1e9:.3f} GB"


def check_mesh_train(torch, card: str, parts: str = "abc",
                     records: dict | None = None) -> dict:
    """Phase 15: ``MESH_RANKS`` gloo ranks on the card run ``parts`` (see
    the module docstring); raises once, naming each check that failed.
    Returns the kernels' launches summed over the ranks; ``records``, if
    given, receives rank 0's record of each part (phase 16 reads it)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import run_ranks
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    res = run_ranks(mesh_train_rank, MESH_RANKS, (parts,), timeout_s=1200,
                    work_dir=ROOT / "build")
    print(f"  {MESH_RANKS} ranks, {time.perf_counter() - t0:.1f} s with "
          "their start", flush=True)
    fails = [f"rank {r['rank']}: {f}" for r in res for f in r["fails"]]
    for row in MESH_TRAINS:
        if row.part not in parts:
            continue
        full = configs.get(row.arch).n_layers
        print(f"  ({row.part}) {row.arch}: {row.layers} of {full} layers at "
              f"full width, batch {row.batch} x {row.seq} in {row.micro} "
              f"micro-batch(es), {row.steps} steps, data "
              f"{MESH_RANKS // MESH_MODEL} x model {MESH_MODEL}"
              + (", the weights split over data too (fsdp)" if row.fsdp
                 else "") + f" [{card}]", flush=True)
        r0 = res[0]["runs"][row.part]
        print(f"    single device (rank 0): losses {_fmt(r0['ref_losses'])}"
              f", a step {_fmt(r0['ref_step_s'])} s", flush=True)
        print(f"    mesh: losses {_fmt(r0['losses'])} (share of rtol "
              f"{MESH_STEPS_RTOL:g}: {r0['losses_share']:.3f}; grad norms "
              f"{r0['norms_share']:.3f}); first step's loss "
              f"{r0['first']['loss']:.6f} vs {r0['first']['ref_loss']:.6f}"
              f", largest gradient share of {row.grad_rel:g}: "
              f"{r0['first']['grad'][1]:.3f} ({r0['first']['grad'][0]})",
              flush=True)
        for r in res:
            m = r["runs"][row.part]
            t = m["traffic"]
            held = ", ".join(f"{k} {_gb(v)}" for k, v in
                             m["first"]["held"].items())
            print(f"    rank {r['rank']}: holds {held}; peak "
                  f"{_gb(m['peak'])}; a step {_fmt(m['step_s'])} s; over "
                  f"the run, bytes a collective {t['bytes']} in "
                  f"{t['calls']} calls taking {_fmt(t['seconds'])} s; host "
                  f"round trips {t['round_trips']} moving "
                  f"{t['round_trip_bytes']} B", flush=True)
        f = r0["first"]
        z = f.get("zero1")
        print(f"    the first step's global norm {f['norm']!r} (over the "
              f"distinct blocks {f['norm_blocks']!r}; one device "
              f"{f['ref_norm']!r})" + (
                  f"; ZeRO-1: the update of {z['leaves']} leaves a rank, "
                  "gathered back, bitwise equal to the same step over the "
                  f"rank's whole blocks in {z['leaves'] - z['differ']}"
                  if z else ""), flush=True)
        if "restart" in r0:
            e = r0["restart"]
            print(f"    elastic restart: checkpoint at {row.crash} on "
                  f"{r0['axes']} (writes of " + ", ".join(
                      f"{_gb(b)} in {t:.1f} s" for t, b in r0["writes"])
                  + f"), resumed on {e['axes']} in "
                  f"{e['resume_s']:.1f} s: losses {_fmt(e['losses'])} vs "
                  f"{_fmt(r0['losses'][row.crash:])} (share {e['share']:.3f}"
                  f"); its final parameters at most {e['params'][1]:.3f} of "
                  f"{MESH_STEPS_RTOL:g} from the straight run's "
                  f"({e['params'][0]})", flush=True)
    if "c" in parts:
        for r in res:
            c = r["compress"]
            print(f"    (c) rank {r['rank']}: compressed_psum_spec over "
                  f"'pod' of {c['elements']} elements in "
                  f"{c['wall_ms']:.1f} ms; error as a share of "
                  f"{MESH_COMPRESS_REL}: deterministic "
                  f"{c['deterministic']:.3f}, stochastic "
                  f"{c['stochastic']:.3f}; int8 blocks equal to the CPU's: "
                  f"{c['blocks_equal']}; {c['traffic']['bytes']} B, "
                  f"{c['traffic']['round_trips']} host round trips "
                  f"[{card}]", flush=True)
    if records is not None:
        records.update(res[0]["runs"])
    launches: dict = {}
    for r in res:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"  the ranks' kernel launches: {launches}", flush=True)
    if fails:
        raise Mismatch("training over a mesh: FAILED: " + "; ".join(fails))
    return launches


# --------------------------------------------------------------------------- #
# phase 16: the dry run against the card
# --------------------------------------------------------------------------- #

DRYRUN_CELLS = (("internlm2-1.8b", "decode_32k", False),
                ("internlm2-1.8b", "train_4k", True))


def dryrun_cli(arch: str, shape: str, multi_pod: bool):
    """Start one production cell through ``python -m
    repro_torch.launch.dryrun`` in a subprocess; ``dryrun_record`` waits
    for it."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape] + (["--multi-pod"] if multi_pod else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return (arch, shape, time.perf_counter(), subprocess.Popen(
        cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))


def dryrun_record(started) -> dict:
    """The JSON record of a cell ``dryrun_cli`` started (``"status":
    "ok"``, or a Mismatch)."""
    arch, shape, t0, proc = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise Mismatch(f"dry run {arch} {shape}: exit {proc.returncode}\n"
                       f"{err[-2000:]}")
    rec = json.loads(lines[-1])
    rec["wall_s"] = time.perf_counter() - t0
    if rec["status"] != "ok":
        raise Mismatch(f"dry run {arch} {shape} on {rec['mesh']}: "
                       f"{rec['status']} {rec.get('error', '')}")
    return rec


def check_dryrun(torch, card: str, rank0: dict) -> None:
    """Phase 16 (module docstring): ``rank0`` is rank 0's record of phase
    15 (a)."""
    # the CLI's production cells run beside this process's dry run
    cells = [dryrun_cli(*c) for c in DRYRUN_CELLS]
    try:
        _check_dryrun(torch, card, rank0, cells)
    finally:
        for started in cells:
            started[3].kill()


def _check_dryrun(torch, card: str, rank0: dict, cells: list) -> None:
    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun
    row = MESH_TRAINS[0]
    cfg = configs.get(row.arch).with_(n_layers=row.layers)
    t0 = time.perf_counter()
    try:
        with dryrun.fake_world(MESH_RANKS):
            sh = dryrun.dev_ctx(MESH_MODEL)
            run, cell = dryrun.build_cell(
                row.arch, Shape("phase15", "train", row.seq, row.batch), sh,
                cfg=cfg, micro_batches=row.micro)
            dry = dryrun.measure(run, cell)
    except Exception as e:  # the dry run itself failing is this phase's
        raise Mismatch(f"the dry run of phase 15 (a)'s step failed: "
                       f"{e!r}") from e
    held = dry["memory"]["held"]
    print(f"  (a) {row.arch}, {row.layers} layers, data "
          f"{MESH_RANKS // MESH_MODEL} x model {MESH_MODEL}, {row.batch} x "
          f"{row.seq} in {row.micro} micro-batches: dry run as rank 0 of a "
          f"fake {MESH_RANKS}-rank group in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    fails = []
    real = rank0["first"]["held"]
    for k in ("params", "moments", "accumulator"):
        line = f"    held {k}: predicted {held[k]} B, phase 15 {real[k]} B"
        print(line + (" (equal)" if held[k] == real[k] else " DIFFER"))
        if held[k] != real[k]:
            fails.append(f"held {k}: {held[k]} B predicted, {real[k]} B")
    step = rank0["step_bytes"][FLOPS_STEP]
    want = {k: v for k, v in step.items() if v}
    got = {k: v for k, v in dry["traffic"]["bytes"].items() if v}
    print(f"    bytes a collective in a step: predicted {got}, phase 15's "
          f"step {FLOPS_STEP} {want}" + (" (equal)" if got == want else
                                         " DIFFER"))
    if got != want:
        fails.append(f"collective bytes a step: {got} predicted, {want}")
    print(f"    result bytes by the reference's op names: "
          f"{dry['collective_bytes']}")
    flops = rank0["step_flops"]
    print(f"    FLOPs a step: predicted {dry['flops']:.0f}, "
          f"FlopCounterMode around phase 15's step {FLOPS_STEP} "
          f"{flops:.0f}" + (" (equal)" if dry["flops"] == flops else
                            " DIFFER"))
    if dry["flops"] != flops:
        fails.append(f"FLOPs a step: {dry['flops']} predicted, {flops}")
    peak = dry["memory"]["peak_bytes"]
    print(f"    peak: predicted {_gb(peak)} (one step's live tensors), "
          f"max_memory_allocated over phase 15's run {_gb(rank0['peak'])}:"
          f" ratio {peak / rank0['peak']:.3f} (a reading) [{card}]",
          flush=True)
    if fails:
        raise Mismatch("the dry run against phase 15: FAILED: "
                       + "; ".join(fails))
    for started in cells:
        rec = dryrun_record(started)
        arch, shape = started[:2]
        print(f"  (b) CLI {arch} {shape} on {rec['mesh']}: {rec['status']} "
              f"in {rec['wall_s']:.1f} s (trace {rec['trace_s']} s); "
              f"flops {rec['flops']:.4g}, bytes {rec['bytes']:.4g}, "
              f"collective result bytes {rec['collective_bytes']['total']}"
              f", held {rec['memory']['argument_bytes']} B, peak "
              f"{rec['memory']['peak_bytes']} B", flush=True)


# --------------------------------------------------------------------------- #
# phase 17: the stage cut and the budget run
# --------------------------------------------------------------------------- #

def check_stages(torch, dev, rt, cs, first) -> None:
    """Phase 17 (a) and (b) on ``first``, phase 5's first two chunks
    (page, offset, is_write, size) on the card."""
    from repro_torch.core.policies import PolicyRegistry
    from repro_torch.core.emulator import _step_scalars
    cfg = rt.paper_platform().with_(chunk=CHUNK, policy="hotness",
                                    hot_threshold=4)
    reg = PolicyRegistry.snapshot()
    chunks = [tuple(x[c * cfg.chunk:(c + 1) * cfg.chunk] for x in first)
              for c in range(2)]

    def start(device):
        params = cfg.runtime(device)
        st = rt.core.init_state(cfg, params)
        return st.table, params, _step_scalars(st), st.bank_free

    valid = torch.ones(cfg.chunk, dtype=torch.bool, device=dev)
    on = cfg.with_(chunk_step_kernel="on")
    kern = cs.chunk_step(on, reg, *start(dev), *chunks[0], valid)
    full = cs.step_until(cfg, reg, *start(dev), *chunks[0], valid,
                         upto="full")
    compare_step(torch, "step_until(upto='full') against kernel B", full,
                 kern)
    print("  (a) step_until(upto='full') on phase 5's first chunk: bitwise "
          "equal to one chunk of kernel B", flush=True)
    def stage(upto, device):
        table, params, sc, bf = start(device)
        for chunk in chunks:
            table, sc, bf, outs = cs.step_until(
                cfg, reg, table, params, sc, bf,
                *(x.to(device) for x in chunk), valid.to(device), upto=upto)
        return table, sc, bf, outs

    for upto in cs.STAGES:
        compare_step(torch, f"stage {upto!r}, card against CPU",
                     _to_cpu(stage(upto, dev)),
                     stage(upto, torch.device("cpu")))
    print(f"  (b) every stage of {cs.STAGES} over 2 chunks: card bitwise "
          "equal to the CPU", flush=True)


def _to_cpu(x):
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_to_cpu(v) for v in x)) if hasattr(x, "_fields") \
            else tuple(_to_cpu(v) for v in x)
    return x.cpu()


def check_budget(torch, dev, rt, cs, card: str) -> None:
    """Phase 17 (c): ``analysis.ranges``' budget run on kernel B against
    its plain version."""
    from repro_torch.analysis import ranges
    cfg = ranges.budget_config(rt.paper_platform().with_(chunk=CHUNK))
    on = cfg.with_(chunk_step_kernel="on")
    n = ranges.N_CHUNKS_BUDGET
    cs.KERNEL.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k_st, k_outs, time0 = ranges.budget_run(on, n, device=dev)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    if cs.KERNEL.launches != 2:
        raise Mismatch(f"the budget run launched kernel B "
                       f"{cs.KERNEL.launches} times, not twice")
    t0 = time.perf_counter()
    p_st, p_outs, _ = ranges.budget_run(cfg, n, device=dev, seq=True,
                                        time0=time0)
    torch.cuda.synchronize()
    p_s = time.perf_counter() - t0
    compare_run(torch, "the budget run", (k_st, k_outs), (p_st, p_outs))
    problems, ends = ranges.saturation(k_st, time0, n * cfg.chunk)
    print(f"  (c) budget run: {n} chunks of {cfg.chunk} on kernel B (two "
          f"launches, {k_s:.2f} s with the origin run) from time {time0}: "
          f"bitwise equal to its plain version ({p_s:.1f} s); HOTNESS "
          f"{ends['HOTNESS']}, WEAR {ends['WEAR']}, EPOCH {ends['EPOCH']}, "
          f"clock {ends['clock']}, writes_slow "
          f"{ends['counters.writes_slow']}, swaps {ends['swaps_done']} "
          f"[{card}]", flush=True)
    if problems:
        raise Mismatch("the budget run: FAILED: " + "; ".join(problems))


def check_donation(torch, dev, rt) -> None:
    """Phase 17 (d): a consumed state's storage identity on kernel B."""
    from repro_torch.analysis.donation import kept_storage
    from repro_torch.sweep import SweepSpec
    cfg = rt.small_platform(chunk=16)
    eng = rt.Engine(cfg, device=dev)
    z = torch.arange(96, dtype=torch.int32, device=dev) % cfg.n_pages
    trace = rt.core.Trace(z, z * 0, z % 3 == 0, torch.full_like(z, 64))
    half = rt.core.Trace(*(x[:40] for x in trace)), \
        rt.core.Trace(*(x[40:] for x in trace))
    # Each consumed state is read for its storage only: that is the check.
    st = eng.run(trace).state
    nxt = eng.run(trace, state=st).state
    # reprolint: allow[donation] the consumed state's storage
    moved = {"run": kept_storage(st, nxt)}
    st = nxt
    nxt = eng.run_stream(list(half), state=st).state
    # reprolint: allow[donation] the consumed state's storage
    moved["run_stream"] = kept_storage(st, nxt)
    sw = eng.sweep(SweepSpec(base=cfg, policies=("hotness", "static")),
                   trace)
    cont = eng.continue_sweep(sw, trace)
    # reprolint: allow[donation] the consumed states' storage
    moved["continue_sweep"] = kept_storage(sw.states, cont.states)
    bad = {k: v for k, v in moved.items() if v}
    if bad:
        raise Mismatch(f"a consumed state's result left its memory: {bad}")
    print("  (d) Engine.run(state=), run_stream and continue_sweep on "
          "kernel B: every tensor of the result in the passed state's "
          "memory", flush=True)


def check_slice17(torch, dev, rt, cs, card: str, first) -> None:
    check_stages(torch, dev, rt, cs, first)
    check_budget(torch, dev, rt, cs, card)
    check_donation(torch, dev, rt)


# --------------------------------------------------------------------------- #
# phase 18: the kernel sanitizer's checks on the card
# --------------------------------------------------------------------------- #

def check_kernel_san(torch, dev, cs, card: str) -> None:
    """Phase 18 (module docstring)."""
    from repro_torch.analysis import kernel_san
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    print(f"  the card's opt-in shared memory a block: {optin} B (the "
          f"pass's limit {kernel_san.H100_SMEM_OPTIN} B)", flush=True)
    fails = []
    if optin != kernel_san.H100_SMEM_OPTIN:
        fails.append(f"the card allows {optin} B a block, the pass "
                     f"assumes {kernel_san.H100_SMEM_OPTIN}")
    for label, b, _ in kernel_san.footprints():
        if not label.startswith("chunk_step"):
            continue
        chunk, banks = int(label.split()[2]), int(label.split()[4])
        layout, _ = cs.chunk_layout(str(dev), chunk, banks)
        want = "workspace" if b > kernel_san.H100_SMEM_OPTIN else "shared"
        if layout != want and abs(b - kernel_san.H100_SMEM_OPTIN) > 16384:
            fails.append(f"{label}: the card took the {layout} layout, the "
                         f"pass predicts {want}")
    print(f"  kernel B's layouts at chunks {kernel_san.CHUNKS}: as the "
          f"footprints predict", flush=True)
    rows = kernel_san.card_checks(dev)
    for r in rows:
        share = "bitwise" if r["share"] == 0 else f"share {r['share']:.3f}"
        print(f"  {r['name']}: {r['launches']} launches under 2 poisons; "
              f"against its plain version {share}; the same under both "
              f"poisons: {r['stable']}; guard bands intact over "
              f"{r['buffers']} buffers: {not r['guards']} [{card}]",
              flush=True)
        fails += r["fails"]
    if fails:
        raise Mismatch("the kernel sanitizer's checks: FAILED: "
                       + "; ".join(fails))


def event_ms(torch, fn, budget_ms: float = 150.0) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around a run of
    calls after one warm-up call, as many calls as fit ``budget_ms``
    (at least 3)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = max(3, min(50, int(budget_ms / max(start.elapsed_time(end),
                                                1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


L2_BYTES = 50 * 2 ** 20      # H100 L2 cache


def flushed_ms(torch, fn, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn`` with the L2 cache flushed
    before each call (a 64 MiB buffer read, so that no dirty line is left
    to write back during the call): CUDA events around each call alone,
    after one warm-up call."""
    scrub = torch.ones(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        scrub.max()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def sass_counts(library: pathlib.Path,
                ops=("HGMMA", "UTMALDG")) -> dict | None:
    """Counts of the instructions ``ops`` (by default ``HGMMA``, wgmma,
    and ``UTMALDG``, a TMA load) in a kernel library's SASS, or None when
    no ``cuobjdump`` is found (the CUDA toolkit's, or Triton's copy)."""
    import shutil
    tools = [shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        tools.append(str(pathlib.Path(triton.__file__).parent / "backends"
                         / "nvidia" / "bin" / "cuobjdump"))
    except ImportError:
        pass
    tool = next((t for t in tools if t and pathlib.Path(t).exists()), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    return {op: sum(op in ln for ln in sass.splitlines()) for op in ops}


def attention_pairs(sq, skv, causal, window) -> int:
    """(q, k) pairs that the masks keep: q row r sits at r + skv - sq."""
    total = 0
    for r in range(sq):
        qi = r + skv - sq
        hi = min(qi, skv - 1) if causal else skv - 1
        lo = max(0, qi - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


def bound(flops: float, byts: float, dtype: str,
          rate: float | None = None) -> tuple[float, str]:
    """The least time (ms) for ``flops`` (at ``rate`` FLOP/s, by default
    the card's peak for ``dtype``) and ``byts``, and which bounds."""
    t_ops = flops / (rate or PEAK_FLOPS[dtype])
    t_mem = byts / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Case(NamedTuple):
    """One phase-6 call: ``run`` goes through the entry point (counted),
    ``kernel_call`` launches the kernel's wrapper alone (timing),
    ``plain`` is the plain version, ``library`` the yardstick or None."""
    kernel: str
    label: str
    config: str
    dtype: str
    run: Callable
    kernel_call: Callable
    plain: Callable
    library: Callable | None
    flops: float
    byts: float
    rate: float | None = None     # FLOP/s of the bound, if not the peak
    path: str | None = None       # the flash path the call must take


def randn(torch, dev, seed, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def flash_case(torch, dev, ops, fa, label, config, seed, b, hq, hkv, sq, skv,
               d, dtype, window=None):
    F = torch.nn.functional
    dt = getattr(torch, dtype)
    q = randn(torch, dev, seed, (b, hq, sq, d), dt)
    k = randn(torch, dev, seed + 1, (b, hkv, skv, d), dt)
    v = randn(torch, dev, seed + 2, (b, hkv, skv, d), dt)
    kw = dict(causal=True, window=window)
    if window is None and sq == skv:
        lib = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    else:
        # SDPA's is_causal is top-left; the kernel's mask is bottom-right.
        qi = torch.arange(sq, device=dev)[:, None] + (skv - sq)
        ki = torch.arange(skv, device=dev)[None, :]
        mask = ki <= qi
        if window is not None:
            mask &= qi - ki < window
        lib = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    flops = 4 * b * hq * d * attention_pairs(sq, skv, True, window)
    byts = nbytes(q, k, v, q)
    fp32 = dtype == "float32"
    return Case("flash_attention", label, config, dtype,
                lambda: ops.flash_attention(q, k, v, **kw),
                lambda: fa.flash_attention_cuda(q, k, v, **kw),
                lambda: fa.flash_attention_plain(q, k, v, **kw),
                lib, flops, byts, FP32_3XTF32_FLOPS if fp32 else None,
                "mma" if fp32 or d % 8 else "wgmma")


def flash_grad_case(torch, dev, ops, fa, seed):
    """Backward through the kernel's forward (a plain recompute) against
    plain autograd, minitron-8b widths at 1,024 tokens, fp32."""
    b, hq, hkv, s, d = 1, 32, 8, 1024, 128
    q, k, v = (randn(torch, dev, seed + i, (b, h, s, d), torch.float32)
               .requires_grad_() for i, h in enumerate((hq, hkv, hkv)))
    g = randn(torch, dev, seed + 3, (b, hq, s, d), torch.float32)

    def through(fn):
        out = fn(q, k, v)
        return (out.detach(), *torch.autograd.grad(out, (q, k, v), g))
    flops = 4 * b * hq * d * attention_pairs(s, s, True, None)
    return Case("flash_attention", "gradient (forward + backward)",
                "minitron-8b", "float32",
                lambda: through(ops.flash_attention),
                lambda: through(ops.flash_attention),
                lambda: through(fa.flash_attention_plain), None, 3 * flops,
                3 * nbytes(q, k, v, q), FP32_3XTF32_FLOPS, "mma")


def decode_case(torch, dev, ops, da, label, config, seed, b, hq, hkv, smax,
                d, window=None):
    F = torch.nn.functional
    dt = torch.bfloat16
    q = randn(torch, dev, seed, (b, hq, d), dt)
    kc = randn(torch, dev, seed + 1, (b, hkv, smax, d), dt)
    vc = randn(torch, dev, seed + 2, (b, hkv, smax, d), dt)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    kv_len = torch.randint(1, smax + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    ki = torch.arange(smax, device=dev)[None, :]
    mask = ki < kv_len[:, None].long()
    if window is not None:
        mask &= ki >= kv_len[:, None].long() - window
    mask = mask[:, None, None, :]
    rows = int(mask.sum())            # valid cache rows over the batch
    kw = dict(window=window)
    q4 = q[:, :, None, :]
    return Case(
        "decode_attention", label, config, "bfloat16",
        lambda: ops.decode_attention(q, kc, vc, kv_len, **kw),
        lambda: da.decode_attention_cuda(q, kc, vc, kv_len, **kw),
        lambda: da.decode_attention_plain(q, kc, vc, kv_len, **kw),
        lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask,
                                               enable_gqa=True),
        4 * (hq // hkv) * hkv * d * rows,
        nbytes(q, q, kv_len) + rows * hkv * d * 2 * 2)


def rwkv_case(torch, dev, ops, rw, label, seed, dtype):
    """rwkv6-7b: 64 heads of 64, 4,096 tokens, chunk 128. The log-decay
    is the model's: -exp(decay_base + dd), decay_base = linspace(-6, -1)
    over the 4,096 channels as ``repro.models`` initialises it, dd a
    data-dependent N(0, 0.5^2). (The CPU tests' -exp(N(0, 1) - 1.5)
    sums past -88 inside some 128-token chunks at this size, where
    exp(-cum) overflows float32 in the chunked form, in the JAX package
    as here.)"""
    b, h, s, d, c = 1, 64, 4096, 64, 128
    dt = getattr(torch, dtype)
    r, k, v = (randn(torch, dev, seed + i, (b, h, s, d), dt)
               for i in range(3))
    base = torch.linspace(-6.0, -1.0, h * d, device=dev).reshape(h, 1, d)
    dd = randn(torch, dev, seed + 3, (b, h, s, d), torch.float32) * 0.5
    logw = (-torch.exp(base + dd)).to(dt)
    u = randn(torch, dev, seed + 4, (h, d), torch.float32) * 0.3
    n = s // c
    per_chunk = (c * (c - 1) // 2) * d * 2 * 2 + c * d * 2 * 2 + \
        c * d * d * 2 * 2
    return Case("rwkv_scan", label, "rwkv6-7b", dtype,
                lambda: ops.rwkv_chunk(r, k, v, logw, u, chunk=c),
                lambda: rw.rwkv_chunk_scan_cuda(r, k, v, logw, u, c),
                lambda: rw.rwkv_scan_plain(r, k, v, logw, u, c)[0], None,
                b * h * n * per_chunk,
                nbytes(r, k, v, logw, u) + b * h * s * d * 4,
                FP32_3XTF32_FLOPS if dtype == "float32" else None)


def model_cases(torch, dev, ops, fa, da, rw) -> list:
    """Phase 6's calls at the widths of the repo's configurations
    (``src/repro/configs``; decode at ``shapes.decode_32k``'s cache with
    the batch cut to 8)."""
    return [
        flash_case(torch, dev, ops, fa, "prefill, causal", "minitron-8b",
                   100, 1, 32, 8, 4096, 4096, 128, "bfloat16"),
        flash_case(torch, dev, ops, fa, "local layer, window 1024",
                   "gemma3-4b", 110, 1, 8, 4, 4096, 4096, 256, "bfloat16",
                   window=1024),
        flash_case(torch, dev, ops, fa, "continuation, q_off 3072",
                   "minitron-8b", 120, 1, 32, 8, 1024, 4096, 128,
                   "bfloat16"),
        flash_case(torch, dev, ops, fa, "prefill, fp32", "phi3-mini", 130,
                   1, 32, 32, 2048, 2048, 96, "float32"),
        flash_case(torch, dev, ops, fa, "prefill, bf16", "phi3-mini", 135,
                   1, 32, 32, 4096, 4096, 96, "bfloat16"),
        flash_grad_case(torch, dev, ops, fa, 140),
        decode_case(torch, dev, ops, da, "decode_32k, B=8", "minitron-8b",
                    200, 8, 32, 8, 32768, 128),
        decode_case(torch, dev, ops, da, "decode_32k, B=8, window 1024",
                    "gemma3-4b", 210, 8, 8, 4, 32768, 256, window=1024),
        rwkv_case(torch, dev, ops, rw, "chunk 128, bf16", 300, "bfloat16"),
        rwkv_case(torch, dev, ops, rw, "chunk 128, fp32", 310, "float32"),
    ]


def case_error(ref, case, got, want) -> tuple[float, float]:
    """(max abs error, its largest share of the allowance) of a case's
    kernel result against its plain result (tuples for the gradient
    case)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    kind = "rwkv" if case.kernel == "rwkv_scan" else "attention"
    err, share = 0.0, 0.0
    for a, b in zip(got, want):
        try:
            e, sh = ref.kernel_error(kind, a, b)
        except ValueError as exc:
            raise Mismatch(f"{case.kernel} {case.label}: {exc}") from exc
        if not math.isfinite(e):
            raise Mismatch(f"{case.kernel} {case.label}: non-finite output")
        err, share = max(err, e), max(share, sh)
    return err, share


def check_model_kernels(torch, ref, fa, da, rw, cases) -> dict:
    """Drive every case through its entry point once with the launch
    counts set to 0 (the path), then hold each against its plain version
    and time it."""
    kernels = {"flash_attention": fa.KERNEL, "decode_attention": da.KERNEL,
               "rwkv_scan": rw.KERNEL}
    torch.cuda.synchronize()
    for k in kernels.values():
        k.reset()
    outs = [case.run() for case in cases]
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in kernels.items()}
    want = {name: sum(c.kernel == name for c in cases) for name in kernels}
    variants = dict(fa.KERNEL.variant_launches)
    paths = {v: sum(c.path == v for c in cases) for v in fa.KERNEL.variants}
    print(f"  the path: {len(cases)} calls through ops.*, launches {counts}; "
          f"flash variants {variants}")
    if counts != want:
        raise Mismatch(f"phase 6 launched {counts}, expected {want}")
    if variants != paths:
        raise Mismatch(f"the flash cases took the paths {variants}, "
                       f"expected {paths} (bf16 at D % 8 == 0 on wgmma, "
                       "fp32 on mma)")
    if counts["flash_attention"]:
        sass = sass_counts(fa.KERNEL.library, ("HGMMA", "UTMALDG", TF32_MMA))
        if sass is None:
            print("  flash SASS: not checked (no cuobjdump found)")
        else:
            print(f"  flash SASS: {sass['HGMMA']} HGMMA, {sass['UTMALDG']} "
                  f"UTMALDG, {sass[TF32_MMA]} {TF32_MMA} instructions")
            for op in ("HGMMA", TF32_MMA):
                if sass[op] == 0:
                    raise Mismatch(f"the flash library holds no {op}")
    if any(c.kernel == "rwkv_scan" for c in cases):
        tf32 = sass_counts(rw.KERNEL.library, (TF32_MMA,))
        if tf32 is None:
            print("  rwkv SASS: not checked (no cuobjdump found)")
        else:
            print(f"  rwkv SASS: {tf32[TF32_MMA]} {TF32_MMA} instructions")
            if tf32[TF32_MMA] == 0:
                raise Mismatch("the rwkv library holds no TF32 mma.sync")
    results = []
    for case, got in zip(cases, outs):
        plain = case.plain()
        err, over = case_error(ref, case, got, plain)
        del plain
        # A case whose bytes fit in L2 would find them there on repeated
        # launches; it is timed cold, as its caller would find it.
        cold = case.byts < L2_BYTES
        timer = (lambda fn: flushed_ms(torch, fn)) if cold else \
            (lambda fn: event_ms(torch, fn))
        ms = timer(case.kernel_call)
        plain_ms = timer(case.plain)
        lib_ms = timer(case.library) if case.library else None
        bound_ms, bound_by = bound(case.flops, case.byts, case.dtype,
                                   case.rate)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        print(f"  {case.kernel:16s} {case.config:12s} {case.label:30s} "
              f"{case.dtype}: max|err| {err:.3e} ({over:.3f} of its "
              f"allowance); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib}, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{case.flops:.4e} flop, {case.byts:.4e} B)"
              f"{'; L2 flushed before each launch' if cold else ''}",
              flush=True)
        if over > 1.0:
            raise Mismatch(f"{case.kernel} {case.label}: max|err| {err:.3e} "
                           f"exceeds its allowance")
        if case.kernel == "rwkv_scan" and case.dtype == "bfloat16":
            check_rwkv_split(torch, rw, case, ms)
        results.append({"case": case, "err": err, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by})
    return {"counts": counts, "variants": variants, "results": results}


# How far the sum of the RWKV launch's device kernels (CUPTI) may fall
# from the events time of the same launch: the events time also holds the
# gaps between the three kernels, ~1-2% of it on the H100.
SPLIT_TOLERANCE = 0.05


def check_rwkv_split(torch, rw, case, events_ms: float) -> None:
    """Print the RWKV launch's three device kernels' times per launch
    (CUPTI, 20 calls) and their sum beside ``events_ms``, the events time
    of the whole launch; raise when the sum is more than SPLIT_TOLERANCE
    away from it."""
    split = device_ms_by_kernel(torch, case.kernel_call, 20, rw.LAUNCHES)
    if not any(n for _, n in split.values()):
        print("    its launches (CUPTI): not measured (no device time in "
              "the trace)", flush=True)
        return
    total = sum(t for t, _ in split.values())
    print("    its launches (CUPTI, 20 calls; ms per launch, launches "
          "traced): " + ", ".join(f"{n} {t:.4f} ms ({k})"
                                  for n, (t, k) in split.items())
          + f"; sum {total:.4f} ms, events {events_ms:.4f} ms", flush=True)
    if abs(total - events_ms) > SPLIT_TOLERANCE * events_ms:
        raise Mismatch(f"rwkv_scan {case.label}: its device kernels sum to "
                       f"{total:.4f} ms, the launch takes {events_ms:.4f} ms")


def model_kernel_rows(m6, train_launches: dict, mesh_launches: dict,
                      mesh_train_launches: dict, later: dict) -> list:
    """One ``kernels`` entry per model kernel: the times of its first case
    (the main shape), the largest error over its cases, and its launches
    over phase 12's training steps, phase 14, phase 15 and (``later``,
    each key's counts by kernel) phases 16-18."""
    meta = {
        "flash_attention": "src/repro/kernels/flash_attention.py:111",
        "decode_attention": "src/repro/kernels/decode_attention.py:100",
        "rwkv_scan": "src/repro/kernels/rwkv_scan.py:84",
    }
    rows = []
    for name, replaces in meta.items():
        res = [r for r in m6["results"] if r["case"].kernel == name]
        first = res[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": m6["counts"][name],
            "train_launches": train_launches[name],
            "mesh_launches": mesh_launches.get(name, 0),
            "mesh_train_launches": mesh_train_launches.get(name, 0),
            **{k: v[name] for k, v in later.items()},
            "max_abs_err": max(r["err"] for r in res), "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"]})
    return rows


def main() -> int:
    start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch as rt
        from repro_torch.kernels import build
        from repro_torch.kernels import chunk_step as cs
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import hmmu_lookup as hl
        from repro_torch.kernels import ops
        from repro_torch.kernels import ref
        from repro_torch.kernels import rwkv_scan as rw
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    try:
        dev = cuda_device(torch)
        # The plain versions' float32 products stay float32 (no TF32).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(f"[1] device: {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}", flush=True)

        t0 = time.perf_counter()
        all_kernels = (hl.KERNEL, cs.KERNEL, fa.KERNEL, da.KERNEL, rw.KERNEL)
        build.build_all(all_kernels)
        print(f"[2] build: {time.perf_counter() - t0:.1f} s -> "
              f"{build.BUILD_DIR}", flush=True)
        for k in all_kernels:
            print(f"    {k.name}: {k.library.name}; "
                  f"registers / spilled "
                  f"bytes: " + ", ".join(f"{n} {r}/{sp}" for n, r, sp in
                                         kernel_resources(k.build_log)))

        print("[3] kernel A (hmmu_lookup) against its plain version",
              flush=True)
        a = check_lookup(torch, dev, hl)

        print("[4] kernel B (chunk_step) against its plain version",
              flush=True)
        b = check_chunk_step(torch, dev, rt, cs)

        print("[5] the main path at full size", flush=True)
        main_run = run_main_path(torch, dev, rt, hl, cs)
        b_num = kernel_b_numbers(torch, dev, rt, cs, main_run)
        a_main_ms = kernel_a_main_ms(torch, rt, hl, main_run)
        counts = {route: main_run["results"][route][1]
                  for route in ("auto", "off")}
        # phase 17's stage cut reads the first two chunks
        first = tuple(x[:2 * CHUNK].clone() for x in main_run["trace"])
        del main_run

        print("[6] model kernels at full width", flush=True)
        m6 = check_model_kernels(torch, ref, fa, da, rw,
                                 model_cases(torch, dev, ops, fa, da, rw))

        print(f"[7] the design-point sweep at full size ({card})",
              flush=True)
        base, spec = sweep_grid(rt)
        trace = sweep_trace(torch, dev, rt)
        check_sweep(torch, dev, rt, hl, cs, base, spec, trace)
        sweep_numbers(torch, rt, base, spec, trace, card)
        del trace

        print(f"[8] serving at full size ({card})", flush=True)
        serve = check_serve(torch, dev, rt, hl, cs, card)

        print(f"[9] user policies, the tiered KV-cache accounting and "
              f"consumed states ({card})", flush=True)
        s9 = check_slice9(torch, dev, rt, hl, cs, card)

        print(f"[10] serving the dense models at full width ({card})",
              flush=True)
        t0 = time.perf_counter()
        serve_kernels = {
            "hmmu_lookup": hl.KERNEL, "chunk_step": cs.KERNEL,
            "flash_attention": fa.KERNEL, "decode_attention": da.KERNEL,
            "rwkv_scan": rw.KERNEL}
        s10 = check_model_serve(torch, dev, rt, serve_kernels, card,
                                DENSE_SERVES)
        print(f"    phase 10 took {time.perf_counter() - t0:.1f} s",
              flush=True)

        print(f"[11] serving rwkv6, hymba, deepseek-v2 and phi3.5-moe at "
              f"full width ({card})", flush=True)
        t0 = time.perf_counter()
        s11 = check_model_serve(torch, dev, rt, serve_kernels, card,
                                FAMILY_SERVES)
        print(f"    phase 11 took {time.perf_counter() - t0:.1f} s",
              flush=True)

        print(f"[12] training internlm2-1.8b, rwkv6, hymba and phi3.5-moe "
              f"at full width ({card})", flush=True)
        t0 = time.perf_counter()
        s12 = check_train(torch, dev, serve_kernels, card)
        print(f"    phase 12 took {time.perf_counter() - t0:.1f} s",
              flush=True)

        print(f"[13] the chunk-1 oracle, Fig 7, large chunks and the "
              f"examples ({card})", flush=True)
        t0 = time.perf_counter()
        s13 = check_slice13(torch, dev, rt, hl, cs, card)
        print(f"    phase 13 took {time.perf_counter() - t0:.1f} s",
              flush=True)

        print(f"[14] the multi-device paths: the split sweep and the "
              f"sharded models ({card})", flush=True)
        t0 = time.perf_counter()
        s14 = check_slice14(torch, dev, rt, hl, cs, card)
        print(f"    phase 14 took {time.perf_counter() - t0:.1f} s",
              flush=True)

        print(f"[15] training over a mesh: {MESH_RANKS} gloo ranks on "
              f"{dev} ({card})", flush=True)
        t0 = time.perf_counter()
        records: dict = {}
        s15 = check_mesh_train(torch, card, records=records)
        print(f"    phase 15 took {time.perf_counter() - t0:.1f} s",
              flush=True)

        counted = (hl, cs, fa, da, rw)
        print(f"[16] the dry run against the card ({card})", flush=True)
        t0 = time.perf_counter()
        for m in counted:
            m.KERNEL.reset()
        check_dryrun(torch, card, records["a"])
        s16 = {m.KERNEL.name: m.KERNEL.launches for m in counted}
        print(f"    launches {s16}; phase 16 took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        print(f"[17] the stage cut and the budget run ({card})", flush=True)
        t0 = time.perf_counter()
        for m in counted:
            m.KERNEL.reset()
        check_slice17(torch, dev, rt, cs, card, first)
        s17 = {m.KERNEL.name: m.KERNEL.launches for m in counted}
        print(f"    launches {s17}; phase 17 took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        print(f"[18] the kernel sanitizer's checks on the card ({card})",
              flush=True)
        t0 = time.perf_counter()
        for m in counted:
            m.KERNEL.reset()
        check_kernel_san(torch, dev, cs, card)
        s18 = {m.KERNEL.name: m.KERNEL.launches for m in counted}
        print(f"    launches {s18}; phase 18 took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        later = {"dryrun_launches": s16, "stage_launches": s17,
                 "kernel_san_launches": s18}

        print("[19] per-kernel numbers", flush=True)
        k_ms, p_ms, lib_ms, a_bound = a["fused"][1]
        kernels = [
            {"name": "hmmu_lookup", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/hmmu_lookup.cu",
             "replaces": "src/repro/kernels/hmmu_lookup.py:78",
             "launches": counts["off"]["hmmu_lookup"],
             "serve_launches": serve["off_launches"],
             "policy_launches": s9["policies"]["off_launches"],
             "memtier_launches": s9["tiered"]["off_launches"],
             "model_serve_launches": s10["hmmu_lookup"],
             "family_serve_launches": s11["hmmu_lookup"],
             "oracle_launches": s13["oracle"]["hmmu_lookup"],
             "fig7_launches": s13["fig7"]["hmmu_lookup"],
             "example_launches": s13["examples"]["hmmu_lookup"],
             "train_launches": s12["launches"]["hmmu_lookup"],
             "mesh_launches": s14["hmmu_lookup"],
             "mesh_train_launches": s15["hmmu_lookup"],
             **{k: v["hmmu_lookup"] for k, v in later.items()},
             "max_abs_err": a["max_abs_err"], "ms": a_main_ms,
             "plain_ms": p_ms, "bound_ms": a_bound, "bound_by": "bytes",
             "library_ms": lib_ms},
            {"name": "chunk_step", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/chunk_step.cu",
             "replaces": "src/repro/kernels/chunk_step.py:793",
             "launches": counts["auto"]["chunk_step"],
             "serve_launches": serve["launches"],
             "policy_launches": s9["policies"]["auto_launches"],
             "memtier_launches": s9["tiered"]["auto_launches"],
             "model_serve_launches": s10["chunk_step"],
             "family_serve_launches": s11["chunk_step"],
             "oracle_launches": s13["oracle"]["chunk_step"],
             "fig7_launches": s13["fig7"]["chunk_step"],
             "example_launches": s13["examples"]["chunk_step"],
             "train_launches": s12["launches"]["chunk_step"],
             "mesh_launches": s14["chunk_step"],
             "mesh_train_launches": s15["chunk_step"],
             **{k: v["chunk_step"] for k, v in later.items()},
             "max_abs_err": b["max_abs_err"], "ms": b_num["ms"],
             "plain_ms": b_num["plain_ms"], "bound_ms": b_num["bound_ms"],
             "bound_by": "bytes", "library_ms": None},
            *model_kernel_rows(m6, s12["launches"], s14, s15, later),
        ]
        print(f"    kernel A's fused entry alone at B=1 x {CHUNK + 2} rows: "
              f"{k_ms * 1e3:.2f} us; the script took "
              f"{time.perf_counter() - start:.1f} s")
        print(json.dumps({"kernels": kernels}))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception:  # a boundary that reports: any failure is nonzero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
