#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py              # all twenty-one phases, one card
  python3 chip_smoke.py --only build,roofline
  python3 chip_smoke.py --only build,kernels,serve_ssm
  python3 chip_smoke.py --only build,mesh_serve
  python3 chip_smoke.py --only build,serve_paged
  python3 chip_smoke.py --only build,serve_lifecycle
  python3 chip_smoke.py --only build,serve_disagg
  python3 chip_smoke.py --only build,stack_bits
  python3 chip_smoke.py --only build,head_product
  python3 chip_smoke.py --only build,train_scheduled,prefill
  python3 chip_smoke.py --only build,kernels,whisper
  python3 chip_smoke.py --only build,elastic
  python3 chip_smoke.py --only build,kernels --kernels fused_mlp,fused_mlp_wgrad
  python3 chip_smoke.py --only build,kernels --kernels grouped_gemm,rmsnorm

Phases:
  1 build    nvidia-smi's card and power limit; build the CUDA kernels from
             ``src/repro_torch/kernels/csrc`` (nvcc, at first use).
  2 kernels  each kernel against its plain PyTorch version on the card, at
             the main paths' shapes and ragged ones, bf16 (tol 2e-2) and
             fp32 (tol 1e-4, TF32 off); median time by CUDA events beside
             the plain version's, one library call's and the bound.
             fused_mlp also at the train shape (R = 320) and at
             jamba-v0.1-52b's expert width (16 experts, d 4096, f 14336,
             N 4096, R 320) with its scratch bytes; every bf16 case of
             fused_mlp, grouped_gemm, fused_mlp_dgrad, fused_mlp_wgrad and
             flash_attention must take the wgmma path, and every case of
             the five must give identical bits on a second call
             (grouped_gemm also in the other traversal order, and at
             decode, M = 4, and on a column block of w_down; its bf16
             cases are timed beside the general kernel). The
             backward kernels (fused_mlp_dgrad, fused_mlp_wgrad) at the
             train shape, a ragged R, a column block and all four
             activations, in bf16 within 2e-2 or 3x the floor between two
             plain routes (at the small shape over 8 seeded draws);
             flash_attention at the qwen2 train shape, a GQA shape
             (mixtral-8x7b's heads) and ragged lengths, in bf16 also
             within twice the general kernel's error on the same inputs
             (the largest over 8 seeded draws, both sides);
             ssd_forward at the mamba2-780m train shape and ragged ones,
             and with an initial and a final state at the serving chunk
             shape and a ragged one; rmsnorm in both epilogues at the
             paths' widths and the JAX test's shapes, non-unit scales.
             Later cases: ssd_forward at jamba-v0.1-52b's SSM shape (128
             heads, d_state 16) and at a small shape; phase 18's shapes
             (fused_mlp at qwen2's no-drop capacity for 8 x 512 tokens,
             R 4096; flash_attention on 8 x 512; ssd_forward from a
             zero state returning h_final at 4 x 1024); phase 19's
             (flash_attention at whisper-small's 12 heads of 64, B 8:
             the encoder's non-causal 1500 x 1500, the cross-attention's
             375 and 32 queries over 1500 keys, the decoder's causal 375;
             SDPA non-causal beside the non-causal ones; every bf16 flash
             case also timed from a CUDA graph). At the small shape,
             the train shape and the serving chunk, over 8 seeded draws,
             the tensor-core kernel is held to its rule against the fp64
             sequential oracle (ssd.ORACLE_*: y's max error within 2x
             the general kernel's and its pooled rel L2 within 1.1x;
             h_final's rel L2 within 2^-16), and the rule must reject
             the kernel's arithmetic with one bf16 term
             (ref.ssd_split_ref); every bf16 ssd_forward case takes the
             tensor-core path, gives the same bits twice, and is timed
             beside the general kernel and from a CUDA graph;
             topk_combine at k 2 and 8 (d 2048 and 4096), every case
             with the bits of the plain j-order sum, twice, and a graph
             device time.
  3 serve    ServeEngine on the full qwen2-moe-2.7b (24 layers, bf16,
             seeded weights on the card), gemm_impl="pallas_fused", 8 slots,
             max_seq 1024, chunk 256: after a warm-up round on an engine of
             its own, 16 requests with prompts of 64-512 tokens and max_new
             32. Launch counters are zeroed before and read after (rmsnorm:
             2L+1 per prefill_chunk or decode_step call; every fused_mlp
             launch on the wgmma path); the plain versions must see no
             CUDA tensor.
  4 logits   the same weights: one stacked prefill_chunk plus 4
             teacher-forced decode_steps through the kernels and through
             the plain versions; fp32 logits compared (first 4 layers in
             fp32, and all 24 in bf16 beside a second plain path; every
             bf16 fused_mlp launch on the wgmma path).
  5 pallas   a short serve with gemm_impl="pallas" (the grouped-GEMM
             kernel), then one full-width MoE layer, prefill and decode
             shapes, "pallas" against "xla"; every bf16 grouped_gemm
             launch on the wgmma path.
  6 train    the serving weights are freed first. Loss and every gradient
             of qwen2-moe-2.7b at full width through the kernels and through
             the plain versions: 2 layers in fp32 (rel L2 1e-4 per leaf),
             4 layers in bf16 (beside a second plain route). Then the
             port's train step at full width and 4 layers (bf16, comet,
             pallas_fused, remat full, AdamW), 4096 tokens per step: one
             warm-up step and 3 timed ones, launch counters zeroed before
             and read after (2L fused_mlp and topk_combine, L dgrad and
             wgrad per step; 2L flash_attention: forward and remat
             recompute; every one of them on the wgmma path;
             rmsnorm 2 x 2L + 1: forward, remat recompute and
             the final norm). Last, Trainer.run with a checkpoint and a
             fault-hook replay on qwen2-moe-2.7b-smoke.
  7 train_ssm  mamba2-780m at full width and all 48 layers: loss and every
             gradient through the SSD kernel and through the plain
             chunked form, 2 layers in fp32 (rel L2 1e-4 per leaf) and 4
             in bf16 (beside a second plain route at chunk 64); then the
             train step (bf16, remat full, AdamW), 4 x 2048 tokens: one
             warm-up step and 3 timed ones, 2 x 48 ssd_forward launches
             per step, every one on the tensor-core path (rmsnorm
             2 x 96 + 1).
  8 serve_ssm  qwen2's serving weights are freed first. ServeEngine on
             the whole mamba2-780m (48 layers, bf16, seeded weights on
             the card), 8 slots, max_seq 2048, chunk 256: after a warm-up
             round on an engine of its own, 16 requests with prompts of
             64-1024 tokens and max_new 32.
             ssd_forward launches 48 per prefill_chunk call (every one
             on the tensor-core path), rmsnorm 97
             (2L+1) per prefill_chunk or decode_step call; the plain
             versions see no CUDA tensor. Then teacher-forced logits as in
             phase 4: 4 layers in fp32 (1e-4), all 48 in bf16 beside a
             second plain route (the SSD at chunk 64 against 256).
  9 ranked   the earlier phases' state is freed first. The port's self-test
             CLI at --device cuda (one NCCL rank per GPU: world 1 here;
             every check must pass). Then one qwen2-moe-2.7b MoE layer at
             full width (E 64, top-4, d 2048, f 1408, bf16, pallas_fused,
             4 x 1024 tokens) through the ranked moe_ffn over a one-rank
             NCCL context and without a context, forward and backward, for
             naive, coarse, comet (ring_group 1, two column blocks, fused
             combine) and comet_hier at those knobs on the bf16 and the
             fp8_e4m3 wire: the same bits, counters zeroed before and
             read after (every fused_mlp, dgrad and wgrad launch on the
             wgmma path; the plain versions see no CUDA tensor). At world 1
             every impl takes its one-rank arm with or without the context
             (comet_hier: the wire's straight-through quantization, then
             the local arm), so no ring, permute or wire crosses NCCL
             here; the ranks' paths run in tests/test_torch_ranked.py on
             gloo CPU ranks. Then the
             comet ring's producer (mlp_col_blocks, one column-sliced
             fused_mlp per block) at the shapes one rank of a 4-rank ring
             runs (16 experts, rows g x C for ring_group g = 1, 2) against
             the column slices of the whole product (bf16 tolerance),
             timed beside it. Last, a gloo context handed a CUDA tensor
             must raise by name.
 10 mesh_train  the earlier phases' state is freed first. On a world-1
             NCCL group, phase 6's configuration (qwen2-moe-2.7b at full
             width, 4 layers, bf16, comet, pallas_fused, remat full, 4 x
             1024 tokens) built twice from one seed: through
             build_train_step without a mesh and on the (1, 1) mesh; one
             step each on one batch, the loss and every updated leaf
             (parameters and AdamW moments) within rel L2 2e-2, with the
             count of leaves that gave identical bits. Then 3 timed steps
             of the mesh step after that warm-up, counters zeroed before
             and read after: phase 6's launch counts, every fused_mlp,
             dgrad, wgrad and flash_attention launch on the wgmma path,
             the plain versions seeing no CUDA tensor; step ms, tokens/s
             and max_memory_allocated beside phase 6's. Last, ``torchrun
             -m repro_torch.launch.train --mesh 1,1 --distributed`` on
             qwen2-moe-2.7b-smoke (4 steps, finite losses) and the port's
             self-test at ``--device cuda --case all`` (every check must
             pass). One NCCL rank per card: the comet ring's overlap is
             not measured here.
 11 plan     the earlier phases' state is freed first. Adaptive workload
             assignment on h100_nvlink, through launch/tune.py: (a) the
             cost model's plans for the qwen2-moe-2.7b layer at ep 1
             (train at 4 x 1024 tokens, prefill at an 8 x 256 chunk,
             decode at 8 tokens); (b) --measured at world 1 on phase 9's
             layer (bf16, the config's capacity), twice per phase: every
             candidate timed by CUDA events over 20 calls (train: forward
             and backward over xla and
             pallas_fused; prefill and decode: forward over xla, pallas
             and pallas_fused), counters zeroed before each and read after
             (pallas_fused: fused_mlp, and in train dgrad and wgrad, on the
             wgmma path; pallas: grouped_gemm on it; every candidate
             topk_combine), each beside its modeled ms, the card's pick
             beside the model's; the winners written to a cache in a
             temporary directory. (c) per phase, moe_ffn with the cache
             gives the bits of moe_ffn under the plan's knobs
             (plan.apply); (d) phase 6's configuration trains 3 steps
             through build_train_step with the cache (finite, none
             skipped), its first loss with the bits of the explicit
             knobs', and launch/train.py --plan-cache trains the smoke
             config; (e) phase 3's engine with the cache serves 8
             requests, all ok, every prefill chunk on the prefill plan and
             every decode step on the decode plan with the launches they
             name. At world 1 no ring hop is timed.
 12 serve_hybrid  the earlier phases' state is freed first. ServeEngine on
             jamba-v0.1-52b at one period (8 layers: 1 attention, 7 Mamba,
             4 MoE of 16 experts at f 14336, top-2) and every published
             width (13.27 B parameters, bf16, seeded weights on the card),
             gemm_impl="pallas_fused", 8 slots, max_seq 2048, chunk 256:
             after a warm-up round on an engine of its own, 16 requests
             with prompts of 64-1024 tokens and max_new 32. Counters zeroed
             before and read after: fused_mlp and topk_combine as the
             resolved plans of the 4 MoE layers in every prefill_chunk and
             decode_step call give them (every fused_mlp launch on the
             wgmma path), ssd_forward 7 per prefill_chunk call (all on the
             tensor-core path), rmsnorm 24 per call; the plain versions see
             no CUDA tensor. Then teacher-forced logits as in phase 4: bf16
             at the period beside a second plain route (xla, the SSD at
             chunk 64), and fp32 at the period (weights drawn anew from the
             seed once the bf16 ones are freed; the phase fails where
             they do not fit) at 1e-4. Phase 2 holds each kernel at the
             shapes this phase launches it at (HYBRID_CASES).
 13 mesh_serve  the earlier phases' state is freed first. Phase 3's
             configuration (qwen2-moe-2.7b whole, bf16, seed 0,
             pallas_fused, 8 slots, max_seq 1024, chunk 256, phase 3's
             trace) served four times on one world-1 NCCL group, in
             turns by the mesh-less engine and by ServeEngine(mesh=) on
             a (1, 1) mesh (mesh-less, mesh, mesh, mesh-less), each
             after a warm-up round. 16/16 ok on every run, token streams
             identical, launches equal per kernel (every fused_mlp launch
             on the wgmma path); TTFT p50/p99, prefill tokens/s, decode
             ms a step, max_memory_allocated and the cache's bytes of
             each run, and the mesh's decode ms over the mesh-less's.
             Then the split-KV merge with no ranks: qwen2's decode shape
             (8 rows, 1024 positions, 16 heads of 128, bf16 cache) cut
             into 4 position shards, decode_attention_partial per shard,
             merge_decode_partials: the fp32 merge against
             decode_attention's fp32 arithmetic within 1e-5, rounded to
             bf16 against the bf16 decode_attention within 2e-2, and
             the shards wholly past a row empty. NCCL refuses two
             ranks on one card: the sharded arms (kv heads, split-KV,
             dp-cut slots) run on gloo CPU ranks in
             tests/test_torch_mesh_serve.py.
 14 serve_paged  the earlier phases' state is freed first. Phase 3's
             engine and trace (qwen2-moe-2.7b whole, bf16, seed 0,
             pallas_fused, max_seq 1024, chunk 256) with the paged KV cache
             (ServeEngine(page_size=64), the page of the JAX package's
             capacity table), every run draining to n_pages - 1 free
             pages. (a) At no-drop capacity (capacity_factor = num_experts
             / top_k: C is the token count, so the dead and pad rows that
             read the null page cannot change a live token): the
             contiguous engine against the paged one on the 8-slot parity
             pool (129 pages), at 8 slots and at 16 slots on that same
             pool, the 16 streams identical. (b) At phase 3's capacity
             (1.25), 8 slots, in turns (contiguous, paged, paged,
             contiguous): 16/16 ok and equal launches per kernel (every
             fused_mlp launch on the wgmma path) on every run; TTFT
             p50/p99, prefill tokens/s, decode ms a step, the cache's
             bytes and max_memory_allocated of each, the paged runs'
             decode ms over the contiguous runs', and the count of
             identical streams (recorded, not held: a dropping capacity
             routes the null-page rows differently). (c) At equal cache
             memory: 16 slots on the 8-slot pool, once at 1.25: the peak
             of live requests (16 against the contiguous engine's 8),
             decode tokens/s and the rest. (d) ServeEngine(mesh=,
             page_size=64) on a (1, 1) mesh of a world-1 NCCL group at
             no-drop capacity, beside (a)'s 8-slot paged run: the same
             streams and launches.
 15 serve_lifecycle  the earlier phases' state is freed first. Phase 3's
             engine and trace with the paged cache (page 64, the 8-slot
             pool of 129 pages) at no-drop capacity, after a warm-up
             round, launch counters zeroed before and read after each
             run (every fused_mlp launch on the wgmma path, the plain
             versions seeing no CUDA tensor, every request terminal,
             128 pages free). (a) Fault-free: the reference streams. (b)
             A fault plan with a snapshot every 8 steps under a
             temporary directory: crashes at steps 5 (before the first
             snapshot: replay from the start) and 19 (restore of step
             16), a poisoned row at step 48 (after the queue empties),
             an 8-page squeeze at step 10, a 50 ms spike at step 26:
             15 ok streams identical to (a)'s, the quarantined one a
             prefix of its (a) stream, every (rid, idx) emitted once,
             failures == recoveries == 2, the spike's step flagged
             (straggler factor 1.3); launches, ms and bytes per
             snapshot, ms per restore, steps replayed and the wall
             time against (a) recorded. (b') A row poisoned at step 12,
             in the first wave: the freed slot admits request 8 alone,
             and the 15 ok streams must be (a)'s. (c) No faults: a live
             cancel after the 4th token and a queued cancel; max_queue
             4 under "deadline" shedding on a burst of 16; a 1 ms TTFT
             deadline on 4 requests queued behind 8 live ones (all
             expire in the queue); every ok stream must be (a)'s,
             whatever stack its request was admitted in. (d)
             ``launch.serve`` with --page-size 64 --pages 129 --chaos
             0.02 --snapshot-dir: every request terminal, every
             injected crash recovered, the plan's and the robustness
             summaries printed.
 16 serve_disagg  the earlier phases' state is freed first. Phase 15's
             model cut to 4 of its 24 layers (DISAGG_LAYERS: the script's
             time) and its trace at no-drop capacity: (a) the shared paged
             engine (8 slots, 129 pages) and (b) the router of
             serving/disagg.py, 1 prefill worker of 4 slots (65 pages)
             and 1 decode worker of 8 slots (129 pages) sharing one
             parameter set, in turns (shared, router, router, shared):
             16/16 ok, the router's streams (a)'s, 16 migrations, the
             pages moved the prompts' pages, no prefill on the decode
             worker, every fused_mlp launch on the wgmma path, every
             (rid, idx) emitted once; TTFT p50/p99, decode ms a step,
             the ms of every export and migrate, the bytes moved, the
             held handoffs' peak bytes, peak memory and launches
             recorded. (c) Snapshots every 4 steps in a temporary
             directory: a decode-worker crash at the tick of the second
             wave's first migration (re-migrated from the held handoff)
             and a prefill-worker crash at step 3, in two runs: (a)'s
             streams, failures == recoveries == injected, every (rid,
             idx) emitted once. (d) mamba2-780m whole, 8 requests of
             64-1024 tokens, the router 1x1 against its shared paged
             engine: identical streams, every ssd_forward launch on the
             tensor-core path. (e) ``launch.serve --disagg --page-size
             64 --prefill-workers 1 --decode-workers 1`` (the mixed
             trace, capacity 1.25): every request terminal, the
             router's summary printed.
 17 train_scheduled  the earlier phases' state is freed first. Phase 6's
             step (qwen2-moe-2.7b, 4 layers at full width, bf16, comet,
             pallas_fused, 4 x 1024 tokens) under schedule "" (remat),
             "sequential" and "overlap" (the block-schedule IR: layers
             unrolled, no remat). Loss and every gradient of one
             fwd+bwd from the same weights: the two scheduled orders
             the same bits, each within bf16 2e-2 of the remat one
             (identical leaves counted); launches per mode as predicted
             (forward once without remat, twice with it), every
             fused_mlp, dgrad, wgrad and flash launch on the wgmma path.
             Then the three train steps in turns (a warm-up each, 2
             rounds): ms, tokens/s, peak memory, launches a step.
 18 prefill  the monolithic prefill (lm.prefill, the cache stitched into
             a decode cache, decode_step with rope_pos and kv_start)
             beside the chunked admission (stacked prefill_chunk calls of
             256) of the same prompts, counters zeroed before and read
             after 3 timed prefill calls. qwen2-moe-2.7b whole (bf16,
             seed 0, pallas_fused, no-drop capacity): 8 prompts of 512
             tokens (every flash_attention and fused_mlp launch on the
             wgmma path) and 8 of 64-512 left-padded (masked attention),
             32 decode steps each: the first decode logits within 2e-2
             (rel L2) of the chunked path's, identical streams counted;
             mamba2-780m whole, 4 x 1024 tokens: every ssd_forward (a
             zero state, h_final returned) on the tensor-core path.
             ms, tokens/s, peak memory and launches of each. The mesh
             arms, at world 1 over NCCL: qwen2 at 4 layers in fp32 (both
             prompt sets) and mamba2's 4 x 1024 through
             build_prefill_step(mesh=) on a (1, 1) mesh, the cache
             stitched by stitch_prefill_cache(ctx=) and one decode_step,
             beside the same without a mesh (counters zeroed before each
             arm's prefill and read after: the same launches): logits,
             both caches and the decode logits compared, identical bits
             counted, each within fp32 1e-4 / bf16 2e-2.
 19 whisper  the earlier phases' state is freed first. whisper-small,
             the encoder-decoder, at every published width (12 encoder
             and 12 decoder layers, d 768, 12 heads of 64, vocab 51,865,
             seeded weights on the card). (a) fp32, whole: lm.prefill of
             32 tokens beside 1500 frames, the cache stitched into a
             decode cache of 1500 encoder rows, one decode_step: its
             logits within rel L2 1e-4 of the full forward's at position
             32; the forward through the kernels within 1e-4 of the plain
             versions'; the same prefill, stitch and decode step on a
             (1, 1) mesh at world 1 over NCCL beside the mesh-less arm,
             as phase 18's mesh arms (36 flash launches each). (b) bf16,
             2 + 2 layers, 4 rows: loss and every gradient through the
             kernels against the plain versions, per leaf within
             max(2e-2, 3 x the floor to a second plain route: the
             chunked online-softmax attention of models/attention.py in
             blocks of 125); and on a (1, 1) mesh against the mesh-less
             kernel run (identical bits counted, within 2e-2; the same
             launches, every flash launch on the wgmma path). (c)
             launch/train.py's Trainer at --batch 8 --seq 1500 (1500
             frames and 375 tokens a row): a warm-up and 3 timed steps,
             finite, none skipped, 72 flash_attention launches a step
             (36 regions: 12 encoder, 12 decoder causal, 12 cross; and
             their remat recompute), every one on the wgmma path; step
             ms, frames/s, tokens/s, peak memory. (d) 8 requests of 1500
             frames and a 32-token prompt: a warm-up and 3 timed
             monolithic prefills (36 flash launches each, all wgmma), the
             stitch into a decode cache of 448 positions and 1500 encoder
             rows, 64 greedy decode steps (no kernel launch); the first
             step's logits within rel L2 2e-2 of the full forward's at
             position 32; ms, memory and launches.
 20 elastic  the earlier phases' state is freed first; world 1 over NCCL.
             (a) qwen2-moe-2.7b at 2 of 24 layers, every published width,
             bf16, phase 6's 4 x 1024 tokens a step, through the Trainer:
             2 steps without a mesh, rescale to a (1, 1) mesh, 2 steps,
             rescale to none, 1 step, against 5 uninterrupted steps from
             the same seed: the same loss bits and every leaf of the final
             state (parameters, both AdamW moments) the same bits; the ms
             of each rescale, the peak memory, and the launches of the 5
             steps (fused_mlp, dgrad, wgrad, flash_attention all on the
             wgmma path, topk_combine, rmsnorm). (b) allreduce_compressed
             over the NCCL group on one step's gradient tree with a
             non-zero residual: the bits of the local round trip
             (compress, then decompress) and the same residuals; ms
             (median of 3) beside its wire bytes and the fp32 tree's. (c)
             python -m repro_torch.analysis.verify --all --json: no error.
 21 roofline  the earlier phases' state is freed first. (a) phase 20's
             step (2 layers, bf16, 4 x 1024 tokens): one warm step, then
             one under analysis/op_cost.count_cost and torch.profiler;
             analysis/roofline.analyze's report (t_compute, t_memory, the
             bound against the wall and device ms, mfu); the count must
             equal a world-1 dry run of the same step on meta tensors
             (FLOPs, bytes, products by dtype, the kernel regions, no
             collective bytes), the dry run's argument bytes lie within
             1% of what the card allocated for the state and the batch,
             the bound at most the wall, 0 < mfu <= 1, and fused_mlp, its
             dgrad and wgrad, flash_attention (all on the wgmma path),
             topk_combine and rmsnorm launched. (c) every compiled kernel
             instance's registers, static shared memory, spills and
             thread limit (cudaFuncGetAttributes, csrc/attrs.cuh) against
             its launch models (analysis/verify/kernel_check.py). (b)
             python -m repro_torch.launch.dryrun for qwen2-moe-2.7b x
             train_4k and x decode_32k on the single-pod mesh over 256
             fake ranks, one process a cell: both ok. (a') the same step
             once more, untimed, under count_cost(attribute=True), and
             its meta dry run so: the same buckets (FLOPs, products,
             bytes, calls) on both, their sums the timed count's totals,
             each kernel's launches its region's calls, every one filed
             under its region's bucket or that bucket's bwd:; the
             card's bucket table is printed. (d) python -m
             repro_torch.analysis.attribute qwen2-moe-2.7b decode_32k and
             python -m repro_torch.launch.hillclimb qwen2-moe-2.7b
             decode_32k n_col=2 save=1: both exit 0, the attribution's
             buckets sum to its totals, the climb's saved report names
             its overrides. (b) and (d) need no card and start in the
             background when the script starts (at the lowest priority,
             one thread each); the phase collects them.

Extra phases, run only when named: ``--only build,serve,profile`` profiles
one admission round and 8 decode steps of the serve configuration
(``--only build,serve_ssm,profile_serve_ssm`` of the serve_ssm one,
``--only build,profile_serve_hybrid`` of the serve_hybrid one,
``--only build,profile_serve_paged`` of the serve configuration with the
contiguous and the paged cache in turns),
``--only build,train,profile_train`` one train step of the train phase and
``--only build,train_ssm,profile_train_ssm`` one of train_ssm, under
torch.profiler (device time by kernel); ``--only build,rule_seeds`` how
steady the phase-2 rules taken over seeded draws are (the bf16 backward
kernels' floor, the wgmma flash kernel beside the general one), on 16
independent sets of draws, one draw against all 8; ``--only nccl_pair``
what NCCL does with two ranks on the one card (an all-reduce of a CUDA
tensor, each rank's outcome recorded); ``--only build,stack_bits`` whether
a qwen2-moe-2.7b request's prefill bits depend on its stack (alone in
two slots, in stacks of 2, 4 and 8 at the first and last row: the first
op whose bits change), each product of the path alone at those row
counts, and the decode's live rows at 4, 8 and 16 slots;
``--only build,head_product`` the training head's fp32 product on bf16
tensor cores at the training cell's chunk shape (2,048 x 2,048 x
151,936): logits, dh and dW against fp64 beside the fp32 cuBLAS product,
a one-piece and a one-pass control, over a sweep of the longest K a
tensor-core pass sums; the present and the new path's times a chunk; and
one traced train step's count of head products (8 ``bf16_exact``) and
split launches (4).

Prints the card line, one JSON line of kernel records, and as its last line
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
no CUDA device is available, when the repo's package is missing, or when
any phase fails. Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "qwen2-moe-2.7b"
TOL = {"bf16": 2e-2, "fp32": 1e-4,
       "merge": 1e-5}      # the fp32 split-KV merge against fp32 decode
PHASES = ("build", "kernels", "serve", "logits", "pallas", "serve_ssm",
          "train", "train_ssm", "ranked", "mesh_train", "plan",
          "serve_hybrid", "mesh_serve", "serve_paged", "serve_lifecycle",
          "serve_disagg", "train_scheduled", "prefill", "whisper",
          "elastic", "roofline")
# run only when named in --only
EXTRA_PHASES = ("profile", "profile_serve_ssm", "profile_train",
                "profile_train_ssm", "profile_serve_hybrid",
                "profile_serve_paged", "rule_seeds", "nccl_pair",
                "stack_bits", "head_product")
REPLACES = {
    "fused_mlp": "src/repro/kernels/fused_mlp.py:90",
    "grouped_gemm": "src/repro/kernels/grouped_gemm.py:49",
    "topk_combine": "src/repro/kernels/topk_combine.py:57",
    "fused_mlp_dgrad": "src/repro/kernels/fused_mlp.py:226",
    "fused_mlp_wgrad": "src/repro/kernels/fused_mlp.py:320",
    "flash_attention": "src/repro/kernels/flash_attention.py:63",
    "ssd_forward": "src/repro/kernels/ssd.py:72",
    "rmsnorm": "src/repro/kernels/rmsnorm.py:18",
}
# the main path's kernel source of each (bf16: the wgmma paths of
# fused_mlp, grouped_gemm, fused_mlp_dgrad, fused_mlp_wgrad and
# flash_attention; their general kernels are <name>.cu)
SOURCES = {"fused_mlp": "fused_mlp_hopper.cu",
           "grouped_gemm": "grouped_gemm_hopper.cu",
           "fused_mlp_dgrad": "fused_mlp_dgrad_hopper.cu",
           "fused_mlp_wgrad": "fused_mlp_wgrad_hopper.cu",
           "flash_attention": "flash_attention_hopper.cu",
           "ssd_forward": "ssd_hopper.cu"}
# the kernels with a Hopper path (wgmma; the SSD's tensor-core mma):
# their counter beside the kernel's in read_counts()
HOPPER = ("fused_mlp", "grouped_gemm", "fused_mlp_dgrad", "fused_mlp_wgrad",
          "flash_attention", "ssd_forward")
# seeded draws (the first is the case's own data) over which phase 2 takes
# the bf16 backward kernels' floor rule at the small shape, and the bf16
# wgmma flash kernel's error beside the general kernel's
DRAWS = 8
# calls in the topk_combine case's CUDA graph (its device time)
TOPK_REPS = 21
JAMBA_CASE = "jamba E=16 R=320 d=4096 f=14336 N=4096"
# phase 12's decode and stateful SSD shapes, held in phase 2
HYBRID_DECODE_CASE = "jamba decode E=16 R=4 d=4096 f=14336 N=4096"
HYBRID_SSD_CASE = "jamba serve state A8 C256 nh128 hd64 ds16"
# the bf16 phase-2 cases at the shapes phase 12 launches each kernel at
HYBRID_CASES = {
    "fused_mlp": (JAMBA_CASE, HYBRID_DECODE_CASE),
    "topk_combine": ("T=2048 k=2 d=4096", "T=8 k=2 d=4096"),
    "ssd_forward": (HYBRID_SSD_CASE,),
    "rmsnorm": tuple(f"T={T} d={d} model" for T in (2048, 8)
                     for d in (4096, 8192))}
# phase 2's cases at phase 18's shapes
PREFILL_MLP_CASE = "prefill no-drop R=4096 expert_major"
PREFILL_FLASH_CASE = "prefill B8 H16 S512 hd128"
PREFILL_SSD_CASE = "prefill final A4 S1024 nh48 hd64 ds128"
# phase 2's flash cases at phase 19's shapes (whisper-small, B 8)
WHISPER_FLASH_CASES = {
    "whisper encoder B8 H12 S1500 hd64": dict(B=8, Hq=12, Hkv=12, S=1500,
                                              hd=64, c=False),
    "whisper cross B8 H12 Sq375 Sk1500 hd64": dict(B=8, Hq=12, Hkv=12,
                                                   S=375, Sk=1500, hd=64,
                                                   c=False),
    "whisper cross B8 H12 Sq32 Sk1500 hd64": dict(B=8, Hq=12, Hkv=12, S=32,
                                                  Sk=1500, hd=64, c=False),
    "whisper decoder B8 H12 S375 hd64": dict(B=8, Hq=12, Hkv=12, S=375,
                                             hd=64, c=True)}
# the train phase: 4 layers at full width (optimizer state for all 24 does
# not fit one card), 4 x 1024 tokens per step
TRAIN_LAYERS = 4
TRAIN_SEQ, TRAIN_BATCH = 1024, 4
# the SSM train phase: mamba2-780m whole (48 layers), 4 x 2048 tokens per
# step (2048 is Mamba-2's published training context)
SSM_ARCH = "mamba2-780m"
SSM_SEQ, SSM_BATCH = 2048, 4
# the SSM serve phase: prompts up to 1024 tokens in 8 slots of 2048
SSM_SERVE = dict(max_seq=2048, prompt_max=1024)
# the ranked phase: one qwen2-moe-2.7b MoE layer on 4 x 1024 tokens, and
# the ring producer's shapes at one rank of a 4-rank ring
RANKED_TOKENS = (4, 1024)
RING_RANKS = 4
# the plan phase: the cache's hardware key, and the (batch, seq) of each
# latency phase's key: the train step's 4 x 1024 tokens, the serving
# engine's stacked 8 x 256 prefill chunk and its 8-slot decode step
PLAN_HW = "h100_nvlink"
PLAN_SHAPES = {"train": (4, 1024), "prefill": (8, 256), "decode": (8, 1)}
PLAN_TOKENS = {k: b * s for k, (b, s) in PLAN_SHAPES.items()}
PLAN_ITERS = 20
PLAN_ROUNDS = 2
# the hybrid serve phase: jamba-v0.1-52b at one period (8 layers: 1
# attention, 7 Mamba, 4 MoE of 16 experts at f 14336) and every published
# width; prompts up to 1024 tokens in 8 slots of 2048
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_SERVE = dict(max_seq=2048, prompt_max=1024)
# the mesh serve phase: the engines' turns, and the split-KV check's
# position shards of the cache
MESH_SERVE_TURNS = ("meshless", "mesh", "mesh", "meshless")
MESH_SERVE_SHARDS = 4
# the paged serve phase: the page, and the turns at phase 3's capacity
PAGED_PAGE = 64
PAGED_TURNS = ("contiguous", "paged", "paged", "contiguous")
# the lifecycle phase: the 8-slot parity pool of 64-token pages; the fault
# plan's steps (snapshots every 8 steps: one crash before the first, one
# after; the poisoned row in the second wave of admissions, after the
# queue has emptied), the squeeze (step, pages, steps held), and the
# straggler factor under which a 50 ms spike on a decode step of 56-95 ms
# is an outlier. A second cell poisons a row in the first wave
# (LIFECYCLE_EARLY_NAN_STEP): the freed slot moves request 8 into an
# admission of its own, whose bits must be the stack's (the router's and
# the LM head's fp32 products are taken per request, so a lone admission
# takes the stack's bits)
LIFECYCLE_POOL = 8 * 1024 // PAGED_PAGE + 1
LIFECYCLE_CRASHES = (5, 19)
LIFECYCLE_NAN_STEP = 48
LIFECYCLE_EARLY_NAN_STEP = 12
LIFECYCLE_SQUEEZE = (10, 8, 4)
LIFECYCLE_SPIKE_STEP = 26
LIFECYCLE_STRAGGLER = 1.3
# the elastic phase: qwen2-moe-2.7b at 2 of 24 layers, every published
# width, phase 6's 4 x 1024 tokens a step, seeded weights
ELASTIC_LAYERS = 2
ELASTIC_SEED = 5


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def median_ms(fn, iters=10, warmup=2):
    """Median of per-call CUDA-event times after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def graph_ms(fn, reps=50, iters=5):
    """Median per-call device time of ``reps`` calls fn(0), fn(1), ...
    replayed from one CUDA graph: for a kernel of a few microseconds,
    events around eager calls time the host's launch gap instead (each
    call checks its operands and crosses ctypes). fn(i) takes its i-th
    input, so the calls can cycle through more bytes than the L2 holds."""
    import torch
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    return median_ms(graph.replay, iters=iters, warmup=1) / reps


def bound_ms(cost):
    """(ms, "bytes" or "operations") of a ``roofline.KernelCost``: the
    H100's data-sheet peaks, as ``analysis/roofline.py`` holds them."""
    t, by = cost.bound_s()
    return t * 1e3, by


def _pairs(got, want):
    """(got, want) output pairs of one output or a tuple of them (None
    entries skipped)."""
    if not isinstance(want, tuple):
        return [(got, want)]
    return [(g, w) for g, w in zip(got, want) if w is not None]


def outputs_err(got, want, tol):
    """max_err over one output or a tuple of them."""
    errs = [max_err(g, w, tol) for g, w in _pairs(got, want)]
    return max(e for e, _ in errs), all(o for _, o in errs)


def outputs_outside(got, want, tol):
    """How many elements lie outside tol + tol * |want|, of how many."""
    n = tot = 0
    for g, w in _pairs(got, want):
        diff = (g.float() - w.float()).abs()
        n += int((diff > tol + tol * w.float().abs()).sum())
        tot += w.numel()
    return n, tot


def _sq_sums(got, want):
    """(||got - want||^2, ||want||^2) over one output or a tuple of them."""
    pairs = _pairs(got, want)
    return (sum(float((g.double() - w.double()).norm() ** 2)
                for g, w in pairs),
            sum(float(w.double().norm() ** 2) for _, w in pairs))


def max_err(got, want, tol):
    """max |got - want|, and whether every element is within
    tol + tol * |want| (numpy's allclose with rtol = atol = tol)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(((diff <= tol + tol * w.abs()) & g.isfinite()).all())
    return float(diff.max()), ok


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(shape, dt, scale, gen):
    import torch
    return (torch.randn(shape, device="cuda", dtype=torch.float32,
                        generator=gen) * scale).to(dt)


def kernel_cases():
    """(kernel, label, dtype, spec) at the main path's shapes of
    qwen2-moe-2.7b (E = 64, d = 2048, f = 1408, top-4) and ragged ones."""
    cases = []
    for dt in ("bf16", "fp32"):
        for R in (160, 4, 37):
            cases.append(("fused_mlp", f"R={R} expert_major", dt,
                          dict(R=R, order="expert_major", col=None)))
        cases.append(("fused_mlp", "R=160 n_major", dt,
                      dict(R=160, order="n_major", col=None)))
        cases.append(("fused_mlp", "R=37 n_major col_slice=(512,1024)", dt,
                      dict(R=37, order="n_major", col=(512, 1024))))
        cases.append(("grouped_gemm", "gemm1 expert_major", dt,
                      dict(M=160, K=2048, N=1408, order="expert_major")))
        cases.append(("grouped_gemm", "gemm2 n_major", dt,
                      dict(M=160, K=1408, N=2048, order="n_major")))
        cases.append(("grouped_gemm", "ragged M=37 n_major", dt,
                      dict(M=37, K=2048, N=1408, order="n_major")))
        for T in (2048, 8, 1000):
            cases.append(("topk_combine", f"T={T}", dt, dict(T=T)))
        # the backward kernels: R = capacity(4096, 4, 64, 1.25) = 320 at
        # the train shape, a ragged R, one of two column blocks, and every
        # activation at a small ragged shape
        for kern in ("fused_mlp_dgrad", "fused_mlp_wgrad"):
            full = dict(E=64, d=2048, f=1408, N=2048, act="swiglu", col=None)
            cases.append((kern, "R=320 swiglu", dt, dict(full, R=320)))
            cases.append((kern, "R=37 swiglu", dt, dict(full, R=37)))
            cases.append((kern, "R=320 col_slice=(1024,1024)", dt,
                          dict(full, R=320, col=(1024, 1024))))
            for act in ("swiglu", "geglu", "gelu", "relu2"):
                cases.append((kern, f"E=8 R=70 d=N=256 f=200 {act}", dt,
                              dict(E=8, R=70, d=256, f=200, N=256, act=act,
                                   col=None, draws=DRAWS)))
        # flash attention: qwen2-moe-2.7b's train shape, mixtral-8x7b's
        # GQA heads at 2048, ragged and short lengths
        for label, spec in (
                ("train B4 H16 S1024 hd128", dict(B=4, Hq=16, Hkv=16,
                                                  S=1024, hd=128, c=True,
                                                  train=True)),
                ("GQA B1 H32/8 S2048 hd128", dict(B=1, Hq=32, Hkv=8,
                                                  S=2048, hd=128, c=True)),
                ("B2 H4 S1000 hd128", dict(B=2, Hq=4, Hkv=4, S=1000,
                                           hd=128, c=True)),
                ("B2 H4/2 S77 hd64 non-causal", dict(B=2, Hq=4, Hkv=2,
                                                     S=77, hd=64, c=False))):
            cases.append(("flash_attention", label, dt,
                          dict(spec, draws=DRAWS)))
        # SSD: mamba2-780m's train shape, a ragged length, a small state
        for label, spec in (
                ("train B4 S2048 nh48 hd64 ds128", dict(B=4, S=2048, nh=48,
                                                        hd=64, ds=128,
                                                        train=True,
                                                        draws=DRAWS)),
                ("B2 S1000 nh8 hd64 ds128", dict(B=2, S=1000, nh=8, hd=64,
                                                 ds=128)),
                ("B2 S77 nh2 hd32 ds16", dict(B=2, S=77, nh=2, hd=32,
                                              ds=16))):
            cases.append(("ssd_forward", label, dt, spec))
        # the SSD with an initial and a final state: mamba2-780m's serving
        # chunk (8 rows of 256) and a ragged one
        for label, spec in (
                ("serve state A8 C256 nh48 hd64 ds128",
                 dict(B=8, S=256, nh=48, hd=64, ds=128, state=True,
                      draws=DRAWS)),
                ("state A1 C100 nh48 hd64 ds128",
                 dict(B=1, S=100, nh=48, hd=64, ds=128, state=True))):
            cases.append(("ssd_forward", label, dt, spec))
        # rmsnorm: the serving paths' widths (qwen2 2048, mamba2 1536 and
        # its gated 3072) at a 2048-row prefill step and 8-row decode, and
        # the JAX test's shapes; both epilogues
        for T, d in ((2048, 2048), (2048, 1536), (2048, 3072), (8, 1536),
                     (100, 896), (8, 64)):
            for epi in ("model", "tpu"):
                cases.append(("rmsnorm", f"T={T} d={d} {epi}", dt,
                              dict(T=T, d=d, epi=epi)))
    # Later cases come last, so the cases above keep the seeded data they
    # had: fused_mlp at the train shape (R = 320), and at jamba-v0.1-52b's
    # expert width (d_model 4096, d_expert 14336, 16 experts) at 320 rows
    # per expert, where the scratch the forward needs is recorded.
    for dt in ("bf16", "fp32"):
        cases.append(("fused_mlp", "R=320 expert_major", dt,
                      dict(R=320, order="expert_major", col=None)))
    cases.append(("fused_mlp", JAMBA_CASE, "bf16",
                  dict(R=320, order="expert_major", col=None, E=16, d=4096,
                       f=14336, N=4096)))
    # the grouped GEMM at decode (8 slots, top-4: C = 4 rows per expert),
    # gemm1 and gemm2, and gemm2 on a column block of w_down (1024 of
    # 2048 columns from column 1024, the row stride 2048)
    for dt in ("bf16", "fp32"):
        cases.append(("grouped_gemm", "decode gemm1 M=4 expert_major", dt,
                      dict(M=4, K=2048, N=1408, order="expert_major")))
        cases.append(("grouped_gemm", "decode gemm2 M=4 n_major", dt,
                      dict(M=4, K=1408, N=2048, order="n_major")))
        cases.append(("grouped_gemm", "gemm2 col_slice=(1024,1024) n_major",
                      dt, dict(M=160, K=1408, N=2048, order="n_major",
                               col=(1024, 1024))))
    # the SSD at jamba-v0.1-52b's SSM layers (128 heads of 64, d_state
    # 16) on 2048 tokens, and a small shape over seeded draws (the
    # tensor-core kernel against the fp64 oracle beside the general one)
    cases.append(("ssd_forward", "jamba B1 S2048 nh128 hd64 ds16", "bf16",
                  dict(B=1, S=2048, nh=128, hd=64, ds=16)))
    cases.append(("ssd_forward", "B2 S130 nh3 hd64 ds32 oracle", "bf16",
                  dict(B=2, S=130, nh=3, hd=64, ds=32, draws=DRAWS)))
    # the top-k combine at top-2 (mixtral, phi3.5, jamba) and top-8
    # (granite, qwen3), at qwen2's width and at 4096
    for dt in ("bf16", "fp32"):
        for kk in (2, 8):
            for d in (2048, 4096):
                cases.append(("topk_combine", f"T=2048 k={kk} d={d}", dt,
                              dict(T=2048, k=kk, d=d)))
    # phase 12's shapes (jamba-v0.1-52b served at one period): the SSD
    # with a state at the serving chunk (8 rows of 256, 128 heads of 64,
    # d_state 16), fused_mlp at the 8-slot decode step's broadcast
    # (capacity(8, 2, 16, 1.25) = 4 rows per expert), and rmsnorm at
    # d_model 4096 and the gated width 8192 at a 2048-row prefill step and
    # 8-row decode, and topk_combine at the decode step's top-2
    cases.append(("ssd_forward", HYBRID_SSD_CASE, "bf16",
                  dict(B=8, S=256, nh=128, hd=64, ds=16, state=True,
                       draws=DRAWS)))
    cases.append(("ssd_forward", HYBRID_SSD_CASE, "fp32",
                  dict(B=8, S=256, nh=128, hd=64, ds=16, state=True)))
    cases.append(("fused_mlp", HYBRID_DECODE_CASE, "bf16",
                  dict(R=4, order="expert_major", col=None, E=16, d=4096,
                       f=14336, N=4096)))
    for dt in ("bf16", "fp32"):
        for T, d in ((2048, 4096), (2048, 8192), (8, 4096), (8, 8192)):
            cases.append(("rmsnorm", f"T={T} d={d} model", dt,
                          dict(T=T, d=d, epi="model")))
        cases.append(("topk_combine", "T=8 k=2 d=4096", dt,
                      dict(T=8, k=2, d=4096)))
    # phase 18's shapes (the monolithic prefill): fused_mlp at qwen2's
    # no-drop capacity for 8 x 512 tokens (C = T = 4096 rows per expert),
    # the flash kernel on 8 unmasked prompts of 512, and the SSD from a
    # zero state returning h_final at mamba2-780m's 4 x 1024
    cases.append(("fused_mlp", PREFILL_MLP_CASE, "bf16",
                  dict(R=4096, order="expert_major", col=None)))
    for dt in ("bf16", "fp32"):
        cases.append(("flash_attention", PREFILL_FLASH_CASE, dt,
                      dict(B=8, Hq=16, Hkv=16, S=512, hd=128, c=True)))
        cases.append(("ssd_forward", PREFILL_SSD_CASE, dt,
                      dict(B=4, S=1024, nh=48, hd=64, ds=128, final=True)))
    # phase 19's shapes (whisper-small, 12 heads of 64, B 8): the
    # encoder's self-attention over 1500 frames, the cross-attention of
    # the train step's 375 tokens and of the prefill's 32 over them
    # (non-causal, Sq != Sk, the last kv tile partial), the decoder's
    # causal self-attention at 375
    for dt in ("bf16", "fp32"):
        for label, spec in WHISPER_FLASH_CASES.items():
            cases.append(("flash_attention", label, dt,
                          dict(spec, draws=DRAWS if dt == "bf16" else 1)))
    return cases


def flash_case(dt, isz, spec, gen):
    """(kernel fn, plain fn, library fn, backward fn, roofline cost) of a
    flash-attention case: S queries over Sk keys (default S). q/k/v are
    made in the model's (B, S, H, hd) layout and passed as transposed
    views, as the model passes them. The FLOPs count QK^T and PV over the
    pairs the mask keeps."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    B, Hq, Hkv, S, hd, causal = (spec[k] for k in
                                 ("B", "Hq", "Hkv", "S", "hd", "c"))
    Sk = spec.get("Sk", S)
    q = _randn((B, S, Hq, hd), dt, 1.0, gen).transpose(1, 2)
    k = _randn((B, Sk, Hkv, hd), dt, 1.0, gen).transpose(1, 2)
    v = _randn((B, Sk, Hkv, hd), dt, 1.0, gen).transpose(1, 2)
    ct = _randn((B, Hq, S, hd), dt, 1.0, gen)

    def kf():
        return flash_attention.flash_attention(q, k, v, causal)

    def pf():
        return ref.flash_attention_ref(q, k, v, causal)

    def lib():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=Hq != Hkv)

    def bwd():
        return ref.flash_attention_vjp(q, k, v, causal, ct)

    from repro_torch.analysis.roofline import flash_cost
    return kf, pf, lib, bwd, flash_cost(B, Hq, Hkv, S, Sk, hd, causal, isz)


def ssd_case(dt, spec, gen):
    """(kernel fn, plain fn, library fn, backward fn, (roofline cost,
    roofline cost on the tensor-core path), (fp64 oracle fn, one-term
    emulation fn)) of an SSD case. x, B and C
    are slices of one conv-output-like tensor, as the model passes them;
    dt, A, D are fp32. There is no single PyTorch call for the SSD: no
    library yardstick. The FLOPs count the chunked form at the kernels'
    chunk Q: per (batch, chunk) C . B^T (shared by the heads), per (batch,
    head, chunk) the (Q, Q) . (Q, hd) product and the two (Q, ds) .
    (ds, hd) state products: fp32 on the general path; on the tensor-core
    path the last three once per bf16 term."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref, ssd
    B, S, nh, hd, ds = (spec[k] for k in ("B", "S", "nh", "hd", "ds"))
    conv = _randn((B, S, nh * hd + 2 * ds), dt, 1.0, gen)
    x = conv[..., :nh * hd].reshape(B, S, nh, hd)
    Bm, Cm = conv[..., nh * hd:nh * hd + ds], conv[..., nh * hd + ds:]
    dtv = F.softplus(torch.randn((B, S, nh), device="cuda", generator=gen))
    A = -torch.exp(torch.randn((nh,), device="cuda", generator=gen) * 0.3)
    D = torch.ones((nh,), device="cuda")
    ct = _randn((B, S, nh, hd), dt, 1.0, gen)
    ins = (x, dtv, A, Bm, Cm, D)
    h0 = (torch.randn((B, nh, ds, hd), device="cuda", generator=gen)
          if spec.get("state") else None)
    # the stateful form: from h0 (or a zero state with "final") to h_final
    final = bool(spec.get("state") or spec.get("final"))

    def kf():
        if not final:
            return ssd.ssd_forward(*ins)
        return ssd.ssd_forward_state(*ins, h0)

    def pf():
        if not final:
            return ref.ssd_chunked_ref(*ins, chunk=ssd.CHUNK)
        return ref.ssd_state_ref(*ins, h0, chunk=ssd.CHUNK)

    def bwd():   # the op's backward, at the kernel's chunk
        return ref.ssd_vjp(*ins, ssd.CHUNK, ct, (True,) * 6)

    def orc():   # the fp64 sequential oracle, as kf returns
        out = ref.ssd_ref(*ins, acc=torch.float64, h0=h0, return_state=True)
        return out if final else out[0]

    def one_term():   # the tensor-core arithmetic with one bf16 term
        out = ref.ssd_split_ref(*ins, h0, terms=1, slab=ssd.HOPPER_SLAB,
                                chunk=ssd.CHUNK)
        return out if final else out[0]

    from repro_torch.analysis.roofline import ssd_cost
    isz = 2 if dt == torch.bfloat16 else 4
    costs = tuple(ssd_cost(B, S, nh, hd, ds, isz, h0 is not None, final, tc)
                  for tc in (False, True))
    return kf, pf, None, bwd, costs, (orc, one_term)


def rmsnorm_case(dt, isz, spec, gen):
    """(kernel fn, plain fn, library fn, roofline cost) of an rmsnorm case:
    x (T, d) in dt, a non-unit fp32 scale (the model's norm scales are fp32
    leaves). The plain version is the epilogue's: ``ref.rms_norm`` (model)
    or ``ref.rmsnorm_ref`` (tpu). The library yardstick is F.rms_norm with
    the scale in x's dtype, which the port never calls. Bytes: x read and y
    written once, the scale once; FLOPs: square, sum, normalise, scale."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref, rmsnorm
    T, d, epi, eps = spec["T"], spec["d"], spec["epi"], 1e-5
    # timed calls cycle through copies of x that together exceed the 50 MB
    # L2, as a prefill step's norm reads a row block it did not just read
    n = min(50, -(-128 * 2 ** 20 // (T * d * isz)))
    xs = [_randn((T, d), dt, 1.0, gen) for _ in range(n)]
    scale = 1.0 + 0.1 * torch.randn((d,), device="cuda", generator=gen)
    scale_lib = scale.to(dt)
    plain = ref.rms_norm if epi == "model" else ref.rmsnorm_ref

    def k(i=0):
        return rmsnorm.rmsnorm(xs[i % n], scale, eps, epilogue=epi)

    def p(i=0):
        return plain(xs[i % n], scale, eps)

    def lib(i=0):
        return F.rms_norm(xs[i % n], (d,), weight=scale_lib, eps=eps)

    from repro_torch.analysis.roofline import rmsnorm_cost
    return k, p, lib, rmsnorm_cost(T, d, isz)


def mlp_bwd_case(kernel, dt, isz, spec, gen):
    """(kernel fn, plain fn, second plain fn, library fn, roofline cost) of
    a backward kernel case. The second plain route runs the plain version
    with fp64 products (the same bf16 rounding points). The library
    yardstick is torch.autograd.grad through bmm -> activation -> bmm,
    which the port never calls."""
    import torch

    from repro_torch.kernels import fused_mlp, ref
    from repro_torch.models.common import activate, is_glu
    E, R, d, f, N, act = (spec[k] for k in ("E", "R", "d", "f", "N", "act"))
    glu = is_glu(act)
    x = _randn((E, R, d), dt, 1.0, gen)
    wg = _randn((E, d, f), dt, d ** -0.5, gen) if glu else None
    wu = _randn((E, d, f), dt, d ** -0.5, gen)
    wd = _randn((E, f, N), dt, f ** -0.5, gen)
    dy = _randn((E, R, N), dt, 1.0, gen)
    if spec["col"] is not None:
        s, w = spec["col"]
        wd, dy = wd[:, :, s:s + w], dy[:, :, s:s + w].contiguous()
    n_out = wd.shape[2]
    dgrad = kernel == "fused_mlp_dgrad"
    kfn = fused_mlp.fused_mlp_dgrad if dgrad else fused_mlp.fused_mlp_wgrad
    pfn = ref.fused_mlp_dgrad_ref if dgrad else ref.fused_mlp_wgrad_ref

    def k():
        return kfn(x, wg, wu, wd, dy, act)

    def p():
        return pfn(x, wg, wu, wd, dy, act)

    def p64():
        return pfn(x, wg, wu, wd, dy, act, acc=torch.float64)

    def lib():
        xs = x.detach().requires_grad_(dgrad)
        ws = [t.detach().requires_grad_(not dgrad) for t in (wg, wu, wd)
              if t is not None]
        gate = torch.bmm(xs, ws[0]) if glu else None
        y = torch.bmm(activate(act, gate, torch.bmm(xs, ws[-2])), ws[-1])
        return torch.autograd.grad(y, [xs] if dgrad else ws, dy)

    from repro_torch.analysis.roofline import fused_mlp_bwd_cost
    cost = fused_mlp_bwd_cost(kernel, E, R, d, f, n_out, glu, isz)
    path = fused_mlp.hopper_path(x, wg, wu, wd, dy)
    extra = {}
    if dgrad:
        # the wgmma path's bf16 dup (and dgate) against the general path's
        # fp32 partials of dX
        general = fused_mlp.general_scratch_bytes(E, R, f, d)
        extra.update(scratch_bytes=fused_mlp.dgrad_scratch_bytes(E, R, f, glu)
                     if path else general, general_scratch_bytes=general)
    else:
        extra["scratch_bytes"] = (fused_mlp.wgrad_scratch_bytes(E, R, f, glu)
                                  if path else None)
    return k, p, p64, lib, cost, extra


@contextlib.contextmanager
def general_path():
    """While active, the fused-MLP, grouped-GEMM, flash-attention and SSD
    wrappers take their general kernels for every call."""
    from repro_torch.kernels import (flash_attention, fused_mlp,
                                     grouped_gemm, ssd)
    real = {m: m.hopper_path for m in (fused_mlp, grouped_gemm,
                                       flash_attention, ssd)}
    for m in real:
        m.hopper_path = lambda *a, **kw: False
    try:
        yield
    finally:
        for m, fn in real.items():
            m.hopper_path = fn


def _gen(seed):
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _extra_draws(spec):
    """Generators of a case's extra draws 1, 2, ... (seeds 1001, ...): the
    first draw is the case's own data, and no later case's data moves."""
    return [_gen(1000 + i) for i in range(1, spec.get("draws", 1))]


def flash_runs(dt, isz, spec, gens):
    """(wgmma, general, plain) outputs of a flash case, one per generator."""
    runs = []
    for g in gens:
        kf, pf = flash_case(dt, isz, spec, g)[:2]
        new = kf()
        with general_path():
            gen = kf()
        runs.append((new, gen, pf()))
    return runs


def flash_stats(runs):
    """The bf16 wgmma flash kernel beside the general kernel over seeded
    draws, each (wgmma, general, plain) on the same inputs. The wgmma
    kernel's max error against the plain version, the largest over the
    draws, may be at most twice the general kernel's, taken the same way.
    Both differ from the plain version only where a last-bit difference of
    the fp32 result flips the output's bf16 rounding; at a small shape a
    handful of elements flip, so the max error of one draw is the ulp of
    whichever element happened to flip, and the ratio of two such maxima
    moves by large factors with the data (the rule_seeds phase). The count
    of elements that differ is recorded beside it."""
    tol = TOL["bf16"]
    err = max(outputs_err(n, w, tol)[0] for n, _, w in runs)
    g_err = max(outputs_err(g, w, tol)[0] for _, g, w in runs)
    return {"draws": len(runs), "draws_max_abs_err": err,
            "general_max_abs_err": g_err,
            "within_general": bool(err <= 2 * g_err),
            "within_tol_all_draws": all(outputs_err(n, w, tol)[1]
                                        for n, _, w in runs),
            "differ": sum(int((n != w).sum()) for n, _, w in runs),
            "general_differ": sum(int((g != w).sum()) for _, g, w in runs)}


def ssd_oracle_sums(new, general, oracle, one_term):
    """One draw's sums for the SSD rule: the tensor-core kernel's output,
    the general kernel's, the fp64 oracle's and the one-term emulation's
    on the same inputs, each y or (y, h_final). Max errors and squared
    errors of y against the oracle (in that order: tensor-core, general,
    one term), and of h_final's where there is one."""
    outs = (new, general, one_term)
    y = [t[0] if isinstance(t, tuple) else t for t in outs]
    oy = oracle[0] if isinstance(oracle, tuple) else oracle
    sums = {"max": [float((t.double() - oy).abs().max()) for t in y],
            "sq": [float((t.double() - oy).norm() ** 2) for t in y],
            "den": float(oy.norm() ** 2)}
    if isinstance(oracle, tuple):
        sums["h_sq"] = [float((t[1].double() - oracle[1]).norm() ** 2)
                        for t in outs]
        sums["h_den"] = float(oracle[1].norm() ** 2)
    return sums


def ssd_oracle_runs(dt, spec, gens):
    """ssd_oracle_sums of an SSD case, one per generator."""
    runs = []
    for g in gens:
        case = ssd_case(dt, spec, g)
        kf, fns = case[0], case[-1]
        new = kf()
        with general_path():
            general = kf()
        runs.append(ssd_oracle_sums(new, general, fns[0](), fns[1]()))
    return runs


def ssd_oracle_stats(runs):
    """The tensor-core SSD kernel's rule (kernels/ssd.py, ORACLE_*) over
    seeded draws (ssd_oracle_sums): y's max error against the fp64
    sequential oracle (the largest over the draws) at most
    ORACLE_MAX_RATIO x the general kernel's, its rel L2 (pooled) at most
    ORACLE_L2_RATIO x; with a state, h_final's pooled rel L2 at most
    ORACLE_STATE_L2. Both kernels round y to bf16, so both y errors are
    near half an ulp of the largest outputs; the rel L2 margin tells the
    kernel's two bf16 terms from one (the emulation's, which must fail
    it: ``rejects_one_term``)."""
    from repro_torch.kernels import ssd
    den = sum(r["den"] for r in runs)
    l2 = [(sum(r["sq"][i] for r in runs) / den) ** 0.5 for i in range(3)]
    mx = [max(r["max"][i] for r in runs) for i in range(3)]
    rec = {"draws": len(runs), "oracle_max_abs_err": mx[0],
           "general_oracle_max_abs_err": mx[1],
           "one_term_oracle_max_abs_err": mx[2], "oracle_rel_l2": l2[0],
           "general_oracle_rel_l2": l2[1], "one_term_oracle_rel_l2": l2[2]}
    ok = (mx[0] <= ssd.ORACLE_MAX_RATIO * mx[1]
          and l2[0] <= ssd.ORACLE_L2_RATIO * l2[1])
    rejects = l2[2] > ssd.ORACLE_L2_RATIO * l2[1]
    if "h_sq" in runs[0]:
        h_den = sum(r["h_den"] for r in runs)
        h_l2 = [(sum(r["h_sq"][i] for r in runs) / h_den) ** 0.5
                for i in range(3)]
        rec.update(state_oracle_rel_l2=h_l2[0],
                   general_state_oracle_rel_l2=h_l2[1],
                   one_term_state_oracle_rel_l2=h_l2[2])
        ok = ok and h_l2[0] <= ssd.ORACLE_STATE_L2
        rejects = rejects and h_l2[2] > ssd.ORACLE_STATE_L2
    rec.update(within_general=bool(ok), rejects_one_term=bool(rejects))
    return rec


def floor_runs(kernel, dt, isz, spec, gens):
    """(kernel, plain, second plain route) outputs of a backward case, one
    per generator."""
    runs = []
    for g in gens:
        k, p, p64 = mlp_bwd_case(kernel, dt, isz, spec, g)[:3]
        runs.append((k(), p(), p64()))
    return runs


def floor_stats(runs):
    """The bf16 backward kernels' floor rule over seeded draws, each
    (kernel, plain, second plain route) on the same inputs. The kernel is
    held to 3x the floor between the two plain routes in max error (the
    largest over the draws, both sides) and in rel L2 (pooled over the
    draws, both sides). At one draw this is the rule as it stood; at the
    small shape the floor of one draw moves more than 3x with the data,
    and the pooled one does not (the rule_seeds phase)."""
    tol = TOL["bf16"]
    err = max(outputs_err(g, w, tol)[0] for g, w, _ in runs)
    f_err = max(outputs_err(f, w, tol)[0] for _, w, f in runs)
    k_sq = [_sq_sums(g, w) for g, w, _ in runs]
    f_sq = [_sq_sums(f, w) for _, w, f in runs]
    k_l2 = (sum(n for n, _ in k_sq) / max(sum(d for _, d in k_sq),
                                          1e-300)) ** 0.5
    f_l2 = (sum(n for n, _ in f_sq) / max(sum(d for _, d in f_sq),
                                          1e-300)) ** 0.5
    outside = [outputs_outside(g, w, tol) for g, w, _ in runs]
    f_outside = [outputs_outside(f, w, tol) for _, w, f in runs]
    return {"draws": len(runs), "draws_max_abs_err": err,
            "within_tol_all_draws": all(outputs_err(g, w, tol)[1]
                                        for g, w, _ in runs),
            "floor_max_abs_err": f_err, "floor_rel_l2": f_l2,
            "rel_l2": k_l2,
            "within_floor": bool(err <= 3 * f_err and k_l2 <= 3 * f_l2),
            "outside_tol": [sum(n for n, _ in outside),
                            sum(t for _, t in outside)],
            "floor_outside_tol": [sum(n for n, _ in f_outside),
                                  sum(t for _, t in f_outside)]}


def run_kernel_case(kernel, dt_name, spec, gen, timed):
    import torch

    from repro_torch.analysis import roofline as RL
    from repro_torch.kernels import fused_mlp, grouped_gemm, ref, \
        topk_combine
    from repro_torch.models.common import activate
    dt = torch.bfloat16 if dt_name == "bf16" else torch.float32
    isz = 2 if dt_name == "bf16" else 4
    E, d, f, N = (spec.get(k, v) for k, v in (("E", 64), ("d", 2048),
                                              ("f", 1408), ("N", 2048)))
    if kernel == "fused_mlp":
        R = spec["R"]
        x = _randn((E, R, d), dt, 1.0, gen)
        wg = _randn((E, d, f), dt, d ** -0.5, gen)
        wu = _randn((E, d, f), dt, d ** -0.5, gen)
        wd_full = _randn((E, f, N), dt, f ** -0.5, gen)
        wd = wd_full
        if spec["col"] is not None:
            s, w = spec["col"]
            wd = wd_full[:, :, s:s + w]
        n_out = wd.shape[2]

        def k():
            return fused_mlp.fused_mlp(x, wg, wu, wd, "swiglu",
                                       order=spec["order"])

        def p():
            return ref.fused_mlp_ref(x, wg, wu, wd, "swiglu")

        def lib():   # bmm -> silu * up -> bmm, the library yardstick
            return torch.bmm(activate("swiglu", torch.bmm(x, wg),
                                      torch.bmm(x, wu)), wd)

        cost = RL.fused_mlp_cost(E, R, d, f, n_out, True, isz)
        path = fused_mlp.hopper_path(x, wg, wu, wd)
        scratch = (fused_mlp.fused_mlp_plan(E, R, d, f, n_out)
                   ["scratch_bytes"] if path else
                   fused_mlp.general_scratch_bytes(E, R, f, n_out))
        extra = {"scratch_bytes": scratch,
                 "general_scratch_bytes":
                     fused_mlp.general_scratch_bytes(E, R, f, n_out)}
    elif kernel in ("fused_mlp_dgrad", "fused_mlp_wgrad"):
        k, p, p64, lib, cost, extra = mlp_bwd_case(kernel, dt, isz,
                                                            spec, gen)
    elif kernel == "flash_attention":
        k, p, lib, bwd, cost = flash_case(dt, isz, spec, gen)
        extra = {}
    elif kernel == "ssd_forward":
        k, p, lib, bwd, (cost, tc_cost), oracle_fns = ssd_case(
            dt, spec, gen)
        extra = {}
    elif kernel == "rmsnorm":
        k, p, lib, cost = rmsnorm_case(dt, isz, spec, gen)
    elif kernel == "grouped_gemm":
        M, K, Nn = spec["M"], spec["K"], spec["N"]
        lhs = _randn((E, M, K), dt, 1.0, gen)
        rhs = _randn((E, K, Nn), dt, K ** -0.5, gen)
        if spec.get("col") is not None:     # a column block of rhs
            s, w = spec["col"]
            rhs = rhs[:, :, s:s + w]
            Nn = w

        def k(order=spec["order"]):
            return grouped_gemm.grouped_gemm(lhs, rhs, order=order)

        def p():
            return ref.grouped_gemm_ref(lhs, rhs)

        def lib():
            return torch.bmm(lhs, rhs)

        cost = RL.grouped_gemm_cost(E, M, K, Nn, isz)
        extra = {}
    else:
        T, kk = spec["T"], spec.get("k", 4)
        rows = _randn((T, kk, d), dt, 1.0, gen)
        w = torch.softmax(torch.randn((T, kk), device="cuda",
                                      generator=gen), dim=-1)
        w_lib = w.to(dt)

        def k():
            return topk_combine.topk_combine(rows, w)

        def p():
            return ref.topk_combine_ref(rows, w)

        def lib():
            return torch.einsum("tkd,tk->td", rows, w_lib)

        cost = RL.topk_combine_cost(T, kk, d, isz, w.element_size())
        extra = {}
        # the graph's TOPK_REPS calls cycle through copies of the rows (no
        # new random draws): at least three, and as many as hold four
        # times the card's L2 (at T 8 all of them fit in it, as a decode
        # step's rows do, fresh from the expert GEMM)
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        n = min(TOPK_REPS, max(3, -(-4 * l2 // rows.nbytes)))
        copies = [rows] + [rows.clone() for _ in range(n - 1)]

        def k_i(i):
            return topk_combine.topk_combine(copies[i % n], w)

        def lib_i(i):
            return torch.einsum("tkd,tk->td", copies[i % n], w_lib)
    reset_counts()
    got = k()
    torch.cuda.synchronize()
    counts = read_counts()
    want = p()
    err, ok = outputs_err(got, want, TOL[dt_name])
    rec = {"max_abs_err": err, "within_tol": ok, "tol": TOL[dt_name]}
    if kernel == "topk_combine":
        # a second call, and the plain j-order sum, give the kernel's bits
        rec["identical_bits"] = torch.equal(k(), got)
        rec["ordered_bits"] = torch.equal(ref.topk_combine_ordered(rows, w),
                                          got)
    if kernel in HOPPER:
        # the path the call took (by the Hopper path's counter), its
        # scratch, and whether a second call gives the same bits (the
        # partials and products are summed in a fixed order, without
        # atomics)
        rec.update(extra)
        rec["path"] = ("hopper" if counts[f"{kernel}_hopper"] == 1
                       else "general")
        again = k()
        rec["identical_bits"] = all(
            torch.equal(a, b) for a, b in _pairs(again, got))
        if kernel == "grouped_gemm":
            # every tile sums K in one order: the other traversal order
            # gives the same bits
            other = ("n_major" if spec["order"] == "expert_major"
                     else "expert_major")
            rec["identical_bits"] &= torch.equal(k(order=other), got)
        if rec["path"] == "hopper" and kernel == "ssd_forward" \
                and spec.get("draws", 1) > 1:
            # the tensor-core kernel's rule against the fp64 sequential
            # oracle, over seeded draws
            with general_path():
                general = k()
            first = ssd_oracle_sums(got, general, oracle_fns[0](),
                                    oracle_fns[1]())
            del general
            rec.update(ssd_oracle_stats(
                [first] + ssd_oracle_runs(dt, spec, _extra_draws(spec))))
            ok = ok and rec["within_general"]
            rec["within_tol"] = ok
        if rec["path"] == "hopper" and kernel in ("fused_mlp_wgrad",
                                                  "flash_attention"):
            # the same call through the general kernel (as for an unaligned
            # shape): whether the wgmma wgrad gives its bits; the wgmma
            # flash's error may be at most twice the general kernel's
            with general_path():
                again = k()
            if kernel == "fused_mlp_wgrad":
                rec["general_identical_bits"] = all(
                    torch.equal(a, b) for a, b in _pairs(again, got))
            else:
                rec.update(flash_stats(
                    [(got, again, want)]
                    + flash_runs(dt, isz, spec, _extra_draws(spec))))
                ok = rec["within_tol_all_draws"] and rec["within_general"]
                rec["within_tol"] = ok
        del again
    if kernel in ("fused_mlp_dgrad", "fused_mlp_wgrad") and dt_name == "bf16":
        # The weight gradients are sums over the rows of products of
        # bf16-rounded factors. Where two routes round an intermediate
        # (h, dh, dup, dgate) to neighbouring bf16 values, one summand moves
        # by an ulp of its own size, which can exceed 2e-2 of a sum that
        # cancels: two plain routes (fp32 and fp64 products, the same
        # rounding points) differ so on a few elements in millions. Such a
        # case is held, as phase 4 holds the logits, to 3x the floor
        # between the two plain routes, in max error and in rel L2
        # (floor_stats).
        rec.update(floor_stats(
            [(got, want, p64())]
            + floor_runs(kernel, dt, isz, spec, _extra_draws(spec))))
        ok = rec["within_tol_all_draws"] or rec["within_floor"]
        rec["within_tol"] = ok
    del got, want
    # the norm's statistics and the general SSD kernel's products are fp32
    # whatever the inputs' dtype; the tensor-core SSD's products are bf16,
    # counted once per bf16 term of their fp32 operand (roofline.ssd_cost)
    if kernel == "ssd_forward" and rec.get("path") == "hopper":
        cost = tc_cost
    b_ms, b_by = bound_ms(cost)
    rec.update(bound_ms=b_ms, bound_by=b_by, bytes=cost.bytes,
               flops=cost.flops)
    if timed:
        iters = 10 if dt_name == "bf16" else 3
        if kernel != "fused_mlp" and kernel.startswith("fused_mlp") \
                and spec["E"] == 64:
            iters = 5 if dt_name == "bf16" else 3
        timer = graph_ms if kernel == "rmsnorm" else functools.partial(
            median_ms, iters=iters)
        rec["ms"] = timer(k)
        rec["plain_ms"] = timer(p)
        rec["library_ms"] = None if lib is None else timer(lib)
        if kernel in ("grouped_gemm", "ssd_forward") \
                and rec.get("path") == "hopper":
            # the general kernel on the same inputs
            with general_path():
                rec["general_ms"] = timer(k)
        if rec.get("path") == "hopper" and kernel in (
                "grouped_gemm", "ssd_forward", "flash_attention"):
            # device time alone, the calls replayed from a CUDA graph (the
            # eager times above include each call's host work)
            rec["device_ms"] = graph_ms(lambda i: k(), reps=20)
            if lib is not None:
                rec["library_device_ms"] = graph_ms(lambda i: lib(), reps=20)
        if kernel == "topk_combine":
            rec["device_ms"] = graph_ms(k_i, reps=TOPK_REPS)
            rec["library_device_ms"] = graph_ms(lib_i, reps=TOPK_REPS)
            rec["copies"] = n
            # 200 calls back to back, per call: the wrapper's host work
            # where it exceeds the kernel's device time (decode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                k()
            torch.cuda.synchronize()
            rec["back_to_back_ms"] = (time.perf_counter() - t0) / 200 * 1e3
        if spec.get("train") and dt_name == "bf16":
            # the flash/SSD op's backward at the train shape: the plain
            # version recomputed under autograd (no backward kernel, as in
            # the JAX package)
            rec["backward_ms"] = median_ms(bwd, iters=5, warmup=1)
    return rec


def phase_kernels(out, only=()):
    """Phase 2, over every case or only those of the kernels named."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = []
    for kernel, label, dt, spec in kernel_cases():
        if only and kernel not in only:
            continue
        rec = run_kernel_case(kernel, dt, spec, gen, timed=True)
        rec.update(kernel=kernel, case=label, dtype=dt)
        results.append(rec)
        lib = ("none" if rec["library_ms"] is None
               else f"{rec['library_ms']:.4f}")
        bwd = ("" if "backward_ms" not in rec
               else f", backward {rec['backward_ms']:.4f}")
        if "general_ms" in rec:
            bwd += f", general kernel {rec['general_ms']:.4f}"
        if "device_ms" in rec:
            bwd += f"; graph {rec['device_ms']:.4f}" + (
                "" if "library_device_ms" not in rec else
                f", library graph {rec['library_device_ms']:.4f}")
        if "back_to_back_ms" in rec:
            bwd += f"; back to back {rec['back_to_back_ms']:.4f}"
        times = (f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
                 f"library {lib}, bound {rec['bound_ms']:.4f} by "
                 f"{rec['bound_by']}{bwd})")
        floor = ("" if "floor_rel_l2" not in rec else
                 f" [{rec['draws']} draws: max err "
                 f"{rec['draws_max_abs_err']:.2e}, rel L2 "
                 f"{rec['rel_l2']:.2e}, outside tol "
                 f"{rec['outside_tol'][0]}/{rec['outside_tol'][1]}; "
                 f"plain-route floor {rec['floor_max_abs_err']:.2e} / "
                 f"{rec['floor_rel_l2']:.2e}, outside tol "
                 f"{rec['floor_outside_tol'][0]}]")
        path = ("" if "path" not in rec else
                f" [{rec['path']} path"
                + ("" if rec.get("scratch_bytes") is None else
                   f", scratch {rec['scratch_bytes']} B")
                + f", identical bits {rec['identical_bits']}"
                + ("" if "general_identical_bits" not in rec else
                   f", general kernel's bits "
                   f"{rec['general_identical_bits']}")
                + ("" if "general_max_abs_err" not in rec else
                   f"; over {rec['draws']} draws max err "
                   f"{rec['draws_max_abs_err']:.3e}, "
                   f"{rec['differ']} elements differ; general kernel's "
                   f"{rec['general_max_abs_err']:.3e}, "
                   f"{rec['general_differ']} differ")
                + ("" if "oracle_max_abs_err" not in rec else
                   f"; over {rec['draws']} draws against the fp64 oracle "
                   f"max err {rec['oracle_max_abs_err']:.3e}, rel L2 "
                   f"{rec['oracle_rel_l2']:.3e}; general kernel's "
                   f"{rec['general_oracle_max_abs_err']:.3e}, "
                   f"{rec['general_oracle_rel_l2']:.3e}; one term's "
                   f"{rec['one_term_oracle_max_abs_err']:.3e}, "
                   f"{rec['one_term_oracle_rel_l2']:.3e}")
                + ("" if "state_oracle_rel_l2" not in rec else
                   f"; h_final rel L2 {rec['state_oracle_rel_l2']:.3e}, "
                   f"general {rec['general_state_oracle_rel_l2']:.3e}, "
                   f"one term {rec['one_term_state_oracle_rel_l2']:.3e}")
                + "]")
        if "ordered_bits" in rec:
            path = (f" [j-order bits {rec['ordered_bits']}, identical bits "
                    f"{rec['identical_bits']}]")
        log(f"  {kernel:15s} {dt} {label:34s} max_abs_err "
            f"{rec['max_abs_err']:.3e} "
            f"{'ok' if rec['within_tol'] else 'FAIL'}  {times}{floor}{path}")
        torch.cuda.empty_cache()
    out["kernel_cases"] = results
    bad = [f"{r['kernel']} {r['dtype']} {r['case']}" for r in results
           if not r["within_tol"]]
    check(not bad, f"kernels outside tolerance: {bad}")
    differ = [f"{r['kernel']} {r['dtype']} {r['case']}" for r in results
              if r.get("identical_bits") is False]
    check(not differ, f"two calls gave different bits: {differ}")
    unordered = [f"{r['kernel']} {r['dtype']} {r['case']}" for r in results
                 if r.get("ordered_bits") is False]
    check(not unordered,
          f"topk_combine off the plain j-order sum's bits: {unordered}")
    # the SSD rule is tight enough to reject one bf16 term where it runs
    weak = [f"{r['kernel']} {r['case']}" for r in results
            if r.get("rejects_one_term") is False]
    check(not weak, f"the SSD oracle rule passes one bf16 term: {weak}")
    # every bf16 case of the redesigned kernels at the main paths' shapes
    # (d, f, N multiples of 8, aligned slices; head_dim 64 or 128; the
    # SSD's head_dim a multiple of 32, d_state of 16) takes the Hopper path
    general = [f"{r['kernel']} {r['case']}" for r in results
               if r["kernel"] in HOPPER
               and r["dtype"] == "bf16" and r["path"] != "hopper"]
    check(not general, f"bf16 cases on the general path: {general}")


def phase_rule_seeds(out, bases=16):
    """How steady the two phase-2 rules taken over seeded draws are: the
    small bf16 backward cases and two bf16 flash cases, each on ``bases``
    independent sets of 8 draws (seeds 10000 b + i), judged on the first
    draw alone (the rule as one draw takes it) and pooled over the 8.
    Reports per case how many of the sets pass each way and the spread of
    the floor (backward) or of the error ratio to the general kernel
    (flash)."""
    import torch
    cases = [(k, label, spec) for k, label, dt, spec in kernel_cases()
             if dt == "bf16" and spec.get("draws", 1) > 1
             and k != "ssd_forward"
             and (k != "flash_attention" or spec["S"] <= 1000)]
    res = []
    for kernel, label, spec in cases:
        one, pooled, spread = [], [], []
        for b in range(bases):
            gens = [_gen(10000 * b + i) for i in range(spec["draws"])]
            if kernel == "flash_attention":
                runs = flash_runs(torch.bfloat16, 2, spec, gens)
                st1, stn = flash_stats(runs[:1]), flash_stats(runs)
                one.append(st1["within_general"])
                pooled.append(stn["within_general"])
                spread.append([st["draws_max_abs_err"]
                               / max(st["general_max_abs_err"], 1e-30)
                               for st in (st1, stn)])
            else:
                runs = floor_runs(kernel, torch.bfloat16, 2, spec, gens)
                st1, stn = floor_stats(runs[:1]), floor_stats(runs)
                one.append(st1["within_tol_all_draws"] or st1["within_floor"])
                pooled.append(stn["within_tol_all_draws"]
                              or stn["within_floor"])
                spread.append([st["floor_rel_l2"] for st in (st1, stn)])
            del runs
        rec = {"kernel": kernel, "case": label, "sets": bases,
               "pass_one_draw": sum(one), "pass_pooled": sum(pooled),
               "one_draw_min": min(x for x, _ in spread),
               "one_draw_max": max(x for x, _ in spread),
               "pooled_min": min(y for _, y in spread),
               "pooled_max": max(y for _, y in spread)}
        res.append(rec)
        what = "error ratio" if kernel == "flash_attention" else "floor L2"
        log(f"  {kernel:15s} {label:34s} pass {rec['pass_one_draw']}/{bases}"
            f" on one draw, {rec['pass_pooled']}/{bases} pooled; {what} "
            f"{rec['one_draw_min']:.3g}..{rec['one_draw_max']:.3g} on one "
            f"draw, {rec['pooled_min']:.3g}..{rec['pooled_max']:.3g} pooled")
        torch.cuda.empty_cache()
    out["rule_seeds"] = res


# ---------------------------------------------------------------------------
# phases 3-5: the serving path
# ---------------------------------------------------------------------------


class PlainGuard:
    """Counts calls of the plain versions with CUDA tensors while active."""

    NAMES = ("fused_mlp_ref", "grouped_gemm_ref", "topk_combine_ref",
             "fused_mlp_dgrad_ref", "fused_mlp_wgrad_ref",
             "flash_attention_ref", "ssd_chunked_ref", "ssd_ref",
             "ssd_state_ref", "rmsnorm_ref", "rms_norm", "split3_bf16_ref")

    def __init__(self):
        from repro_torch.kernels import ref
        self.ref = ref
        self.cuda_calls = 0
        self.saved = {}

    def __enter__(self):
        for n in self.NAMES:
            real = getattr(self.ref, n)
            self.saved[n] = real

            def wrapped(*args, _real=real, **kw):
                import torch
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in args):
                    self.cuda_calls += 1
                return _real(*args, **kw)

            setattr(self.ref, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, real in self.saved.items():
            setattr(self.ref, n, real)


def reset_counts():
    from repro_torch.kernels import (flash_attention, fused_mlp,
                                     grouped_gemm, rmsnorm, split3, ssd,
                                     topk_combine)
    from repro_torch.models.common import HEAD_PRODUCT_CALLS
    for m in (fused_mlp, grouped_gemm, topk_combine, flash_attention, ssd,
              rmsnorm, split3):
        m.reset()
    for k in HEAD_PRODUCT_CALLS:
        HEAD_PRODUCT_CALLS[k] = 0


def read_counts():
    """Each kernel's launches (its Hopper path's beside it), and the
    head's logits products by path (``models/common.HEAD_PRODUCT_CALLS``)
    as ``head_bf16_exact`` and ``head_fp32``."""
    from repro_torch.kernels import (flash_attention, fused_mlp,
                                     grouped_gemm, rmsnorm, split3, ssd,
                                     topk_combine)
    from repro_torch.models.common import HEAD_PRODUCT_CALLS
    return {"fused_mlp": fused_mlp.launches,
            "fused_mlp_hopper": fused_mlp.hopper_launches,
            "grouped_gemm": grouped_gemm.launches,
            "grouped_gemm_hopper": grouped_gemm.hopper_launches,
            "topk_combine": topk_combine.launches,
            "fused_mlp_dgrad": fused_mlp.dgrad_launches,
            "fused_mlp_dgrad_hopper": fused_mlp.dgrad_hopper_launches,
            "fused_mlp_wgrad": fused_mlp.wgrad_launches,
            "fused_mlp_wgrad_hopper": fused_mlp.wgrad_hopper_launches,
            "flash_attention": flash_attention.launches,
            "flash_attention_hopper": flash_attention.hopper_launches,
            "ssd_forward": ssd.launches,
            "ssd_forward_hopper": ssd.hopper_launches,
            "rmsnorm": rmsnorm.launches,
            "split3": split3.launches,
            "head_bf16_exact": HEAD_PRODUCT_CALLS["bf16_exact"],
            "head_fp32": HEAD_PRODUCT_CALLS["fp32"]}


def head_launches(cfg, seq, passes):
    """The head's counts in ``passes`` forward and backward passes of
    ``chunked_xent`` over sequences of ``seq`` tokens: a logits product a
    chunk in the forward and one in its checkpoint recompute, on the
    bf16-exact path with a split launch a chunk in the backward for bf16
    operands and fp32 logits, else on the fp32 path."""
    import inspect

    from repro_torch.models.common import chunked_xent
    chunk = inspect.signature(chunked_xent).parameters["chunk"].default
    n = -(-seq // chunk) * passes
    if (cfg.param_dtype == cfg.compute_dtype == "bfloat16"
            and cfg.logit_dtype == "float32"):
        return {"split3": n, "head_bf16_exact": 2 * n, "head_fp32": 0}
    return {"split3": 0, "head_bf16_exact": 0, "head_fp32": 2 * n}


@contextlib.contextmanager
def count_model_calls(calls):
    """While active, counts lm.prefill_chunk and lm.decode_step calls into
    the dict ``calls`` (the engine reaches both through the module)."""
    from repro_torch.models import lm
    saved = {n: getattr(lm, n) for n in ("prefill_chunk", "decode_step")}
    for n, real in saved.items():
        calls[n] = 0

        def wrapped(*a, _real=real, _n=n, **kw):
            calls[_n] += 1
            return _real(*a, **kw)

        setattr(lm, n, wrapped)
    try:
        yield calls
    finally:
        for n, real in saved.items():
            setattr(lm, n, real)


def with_gemm(cfg, gemm_impl):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, gemm_impl=gemm_impl))


def serve(cfg, params, n_req, max_new, seed, out_key, out, batch=8,
          max_seq=1024, chunk=256, prompt_max=512, engine_kw=None,
          moe_sink=None, warm_up=True):
    import numpy as np
    import torch

    from repro_torch.launch.serve import make_trace
    from repro_torch.serving import ServeEngine
    engine_kw = engine_kw or {}
    if warm_up:
        # on an engine of its own (first-call set-up of the CUDA libraries
        # and the kernels' module), so the timed run is a warm server
        warm = ServeEngine(cfg, params=params, max_seq=max_seq,
                           batch_size=batch, chunk=chunk, device="cuda",
                           **engine_kw)
        for p in make_trace(cfg.vocab_size, batch, 64, prompt_max,
                            seed + 100):
            warm.submit(p, max_new=2)
        warm.run()
        del warm
    eng = ServeEngine(cfg, params=params, max_seq=max_seq, batch_size=batch,
                      chunk=chunk, device="cuda", **engine_kw)
    peak = [0]                 # the most live requests of a decode step
    real_decode = eng._decode_once

    def decode_once():
        peak[0] = max(peak[0], int(eng.live.sum()))
        real_decode()

    eng._decode_once = decode_once
    prompts = make_trace(cfg.vocab_size, n_req, 64, prompt_max, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with PlainGuard() as guard, count_model_calls({}) as calls, \
            _moe_spy(moe_sink):
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new=max_new) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del eng._decode_once       # the wrapper holds the engine: a cycle
    counts = read_counts()
    reqs = [eng.finished[r] for r in rids]
    ttft = [r.ttft_s * 1e3 for r in reqs]
    rec = {
        "gemm_impl": cfg.moe.gemm_impl if cfg.moe else None,
        "requests": n_req,
        "max_new": max_new, "slots": batch, "max_seq": max_seq,
        "chunk": chunk, "prompt_tokens": eng.prefill_tokens,
        "decode_steps": eng.decode_steps, "decode_tokens": eng.decode_tokens,
        "admit_rounds": eng.admit_rounds, "wall_s": wall,
        "prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
        "prefill_tok_s": eng.prefill_tokens / max(eng.prefill_s, 1e-9),
        "decode_tok_s": eng.decode_tokens / max(eng.decode_s, 1e-9),
        "decode_ms_per_step": eng.decode_s / max(eng.decode_steps, 1) * 1e3,
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "cache_gb": sum(t.numel() * t.element_size()
                        for e in eng.cache for t in e.values()) / 1e9,
        "peak_live": peak[0],
        "launches": counts, "model_calls": calls,
        "plain_calls_on_cuda": guard.cuda_calls,
    }
    if eng.paged:
        rec.update(page_size=eng.page_size, n_pages=eng.n_pages,
                   free_pages=eng.free_pages, admissions=eng.admissions)
    out[out_key] = rec
    log("  " + json.dumps(rec))
    bad = [r.rid for r in reqs if r.status.value != "ok"
           or len(r.tokens) != max_new
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    check(not bad, f"requests not ok with {max_new} valid tokens: {bad}")
    check(guard.cuda_calls == 0,
          f"plain versions saw CUDA tensors {guard.cuda_calls} times")
    check(not eng.paged or eng.free_pages == eng.n_pages - 1,
          f"{eng.free_pages} pages free after the drain, not "
          f"{eng.n_pages - 1}")
    # every norm region is one rmsnorm launch: ln1 (and ln2 where the
    # layer has an FFN or MoE, or the SSM block's gated norm) per layer,
    # and the final norm, in every prefill_chunk and decode_step call
    per_call = norms_per_forward(cfg)
    n_calls = calls["prefill_chunk"] + calls["decode_step"]
    check(counts["rmsnorm"] == per_call * n_calls,
          f"rmsnorm launches {counts['rmsnorm']}, expected {per_call} x "
          f"{n_calls} model calls")
    return eng, rec


def norms_per_forward(cfg):
    """The rmsnorm regions of one forward through the model: per layer
    ln1, ln2 where the layer has an FFN or MoE, and the SSM block's gated
    norm; then ln_f."""
    n = 1
    for pos in range(cfg.n_layers):
        n += 1 + (cfg.d_ff > 0 or cfg.is_moe_layer(pos))
        n += cfg.layer_kind(pos) != "a"
    return n


def phase_serve(state, out):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = with_gemm(get_config(ARCH), "pallas_fused")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    out["init_params_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {ARCH}: {n_params / 1e9:.2f} B parameters in bf16 on the card, "
        f"init {out['init_params_s']:.1f} s")
    state["cfg"], state["params"] = cfg, params
    _, rec = serve(cfg, params, 16, 32, 0, "serve", out)
    check(rec["launches"]["fused_mlp"] > 0 and
          rec["launches"]["topk_combine"] > 0,
          f"main path did not launch the kernels: {rec['launches']}")
    # every bf16 forward went through the wgmma kernel
    check(rec["launches"]["fused_mlp_hopper"] == rec["launches"]["fused_mlp"],
          f"fused_mlp launches off the wgmma path: {rec['launches']}")


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return [t for _, t in tree_leaves(tree)]


@contextlib.contextmanager
def plain_ops():
    """While active, ops' kernel entry points call the plain versions,
    explicitly by name, on CUDA tensors (the combine's autograd function
    reaches its forward through ops.topk_combine); the plain attention and
    SSD are differentiated by autograd directly."""
    from repro_torch.kernels import ops, ref
    names = ("topk_combine", "grouped_gemm", "fused_mlp", "fused_mlp_dgrad",
             "fused_mlp_wgrad", "flash_attention", "ssd_forward",
             "ssd_forward_state", "rms_norm", "split3_bf16")
    saved = {n: getattr(ops, n) for n in names}

    def wd_of(w, col_slice):
        wd = w["w_down"]
        if col_slice is not None:
            wd = wd[:, :, col_slice[0]:col_slice[0] + col_slice[1]]
        return wd

    def plain_gg(lhs, rhs, order="expert_major"):
        return ref.grouped_gemm_ref(lhs, rhs)

    def plain_mlp(rows, w, activation, col_slice=None, order=""):
        return ref.fused_mlp_ref(rows, w.get("w_gate"), w["w_up"],
                                 wd_of(w, col_slice), activation)

    def plain_dgrad(rows, w, dy, activation, col_slice=None):
        return ref.fused_mlp_dgrad_ref(rows, w.get("w_gate"), w["w_up"],
                                       wd_of(w, col_slice), dy, activation)

    def plain_wgrad(rows, w, dy, activation, col_slice=None):
        return ref.fused_mlp_wgrad_ref(rows, w.get("w_gate"), w["w_up"],
                                       wd_of(w, col_slice), dy, activation)

    def plain_ssd(x, dt, A, Bm, Cm, D, chunk=64):
        return ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk)

    def plain_ssd_state(x, dt, A, Bm, Cm, D, chunk=64, h0=None):
        return ref.ssd_state_ref(x, dt, A, Bm, Cm, D, h0, chunk)

    plain = dict(zip(names, (ref.topk_combine_ref, plain_gg, plain_mlp,
                             plain_dgrad, plain_wgrad,
                             ref.flash_attention_ref, plain_ssd,
                             plain_ssd_state, ref.rms_norm,
                             ref.split3_bf16_ref)))
    for n in names:
        setattr(ops, n, plain[n])
    try:
        yield
    finally:
        for n in names:
            setattr(ops, n, saved[n])


def phase_serve_ssm(state, out):
    """The whole mamba2-780m served through the SSD kernel with a state and
    the rmsnorm kernel, then its teacher-forced logits against the plain
    versions."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    state.pop("params", None)                  # qwen2's serving weights
    torch.cuda.empty_cache()
    cfg = ssm_cfg(48, "bfloat16")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {SSM_ARCH}: {n_params / 1e9:.3f} B parameters in bf16 on the "
        f"card, init {time.perf_counter() - t0:.1f} s")
    state["ssm_serve"] = (cfg, params)
    _, rec = serve(cfg, params, 16, 32, 0, "serve_ssm", out, **SSM_SERVE)
    L, calls = cfg.n_layers, rec["model_calls"]
    check(rec["launches"]["ssd_forward"] == L * calls["prefill_chunk"],
          f"ssd_forward launches {rec['launches']['ssd_forward']}, expected "
          f"{L} x {calls['prefill_chunk']} prefill_chunk calls")
    # every bf16 serving chunk's SSD went through the tensor-core kernel
    check(rec["launches"]["ssd_forward_hopper"]
          == rec["launches"]["ssd_forward"],
          f"ssd_forward launches off the tensor-core path: {rec['launches']}")

    # teacher-forced logits: one stacked prefill_chunk (4 rows x 256, valid
    # lengths 97-256) and 4 decode_steps, kernels against plain versions.
    # fp32 at 4 layers, 1e-4; bf16 at all 48 beside the floor between two
    # plain routes, the SSD at the model's chunk (256) and at 64
    rng = np.random.default_rng(1)
    plens = np.array([256, 200, 97, 160])
    toks = rng.integers(1, cfg.vocab_size, (4, 256))
    nxt = rng.integers(1, cfg.vocab_size, (4, 4))

    def run(c, p, plain=False):
        with plain_ops() if plain else contextlib.nullcontext():
            return teacher_forced_logits(c, p, toks, plens, nxt)

    c32 = ssm_cfg(4, "float32")
    p32 = {k: tree_map(lambda a: a.float(), v) for k, v in params.items()
           if k != "layers"}
    p32["layers"] = [tree_map(lambda a: a[:4].float(), v)
                     for v in params["layers"]]
    fp32 = compare_logits(run(c32, p32), run(c32, p32, plain=True))
    del p32
    plain = run(cfg, params, plain=True)
    bf16 = compare_logits(run(cfg, params), plain)
    floor = compare_logits(run(ssm_cfg(48, "bfloat16", 64), params,
                               plain=True), plain)
    logits = {"fp32_4_layers": fp32, "bf16_48_layers": bf16,
              "bf16_48_layers_chunk64_vs_plain": floor}
    out["serve_ssm_logits"] = logits
    log("  " + json.dumps(logits))
    check(fp32["rel_l2_err"] <= TOL["fp32"],
          f"fp32 logits rel L2 error {fp32['rel_l2_err']:.3e} > 1e-4")
    check(fp32["argmax_agree"] >= 0.95,
          f"fp32 argmax agreement {fp32['argmax_agree']:.2f} < 0.95")
    bound = max(TOL["bf16"], 3 * floor["rel_l2_err"])
    check(bf16["rel_l2_err"] <= bound,
          f"bf16 logits rel L2 error {bf16['rel_l2_err']:.3e} > {bound:.3e}")


def teacher_forced_logits(cfg, params, toks, plens, nxt, S=512):
    """One stacked prefill_chunk, then one decode_step per row of ``nxt``
    (teacher-forced tokens): the fp32 logits of every step, stacked."""
    import torch

    from repro_torch.models import lm
    A = toks.shape[0]
    cache = lm.init_cache(cfg, A, S, "cuda")
    lg, cache = lm.prefill_chunk(
        cfg, params, cache, torch.from_numpy(toks).cuda(),
        torch.zeros(A, dtype=torch.long, device="cuda"),
        torch.from_numpy(plens).cuda())
    logits = [lg]
    pos = torch.from_numpy(plens).cuda()
    for row in nxt:
        lg, cache = lm.decode_step(cfg, params, cache,
                                   torch.from_numpy(row[:, None]).cuda(),
                                   pos)
        logits.append(lg)
        pos = pos + 1
    return torch.cat(logits)


def compare_logits(got, want):
    check(bool(got.isfinite().all()) and bool(want.isfinite().all()),
          "non-finite logits")
    row_rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).tolist()
    return {"rows": got.shape[0],
            "rel_l2_err": float((got - want).norm() / want.norm()),
            "row_rel_l2_max": max(row_rel),
            "row_rel_l2_median": statistics.median(row_rel),
            "max_abs_err": float((got - want).abs().max()),
            "logit_absmax": float(want.abs().max()),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean())}


def phase_logits(state, out):
    """The same weights through the kernels and through the plain versions:
    one stacked prefill_chunk (4 rows x 256 tokens, valid lengths 97-256)
    plus 4 teacher-forced decode_steps.

    fp32, the first 4 layers (the bf16 weights cast up): here the two paths
    differ only in fp32 summation order, so the logits are held to the
    repo's fp32 tolerance in norm and the argmax to 95% of rows.

    bf16, all 24 layers: the two paths round to bf16 at other points, and
    with random-init routers (near-uniform probabilities) a 1-ulp difference
    flips the top-4 choice of near-tied tokens, which compounds over the
    layers. So the kernel path is held to the distance between two plain
    implementations of the same model, the plain versions and the "xla"
    backend (bf16 products, gate/up rounded to bf16): at most 3x that
    floor, and at least the repo's bf16 2e-2 in norm."""
    import numpy as np
    import torch

    from repro_torch.models.common import tree_map
    cfg, params = state["cfg"], state["params"]
    rng = np.random.default_rng(1)
    plens = np.array([256, 200, 97, 160])
    toks = rng.integers(1, cfg.vocab_size, (4, 256))
    nxt = rng.integers(1, cfg.vocab_size, (4, 4))

    def run(c, p, plain=False):
        if not plain:
            return teacher_forced_logits(c, p, toks, plens, nxt)
        with plain_ops():
            return teacher_forced_logits(c, p, toks, plens, nxt)

    n32 = min(4, cfg.n_layers)
    c32 = dataclasses.replace(cfg, n_layers=n32, param_dtype="float32",
                              compute_dtype="float32")
    p32 = {k: tree_map(lambda a: a.float(), v) for k, v in params.items()
           if k != "layers"}
    p32["layers"] = [tree_map(lambda a: a[:n32].float(), v)
                     for v in params["layers"]]
    fp32 = compare_logits(run(c32, p32), run(c32, p32, plain=True))
    del p32
    torch.cuda.empty_cache()
    plain = run(cfg, params, plain=True)
    reset_counts()
    bf16 = compare_logits(run(cfg, params), plain)
    counts = read_counts()
    floor = compare_logits(run(with_gemm(cfg, "xla"), params, plain=True),
                           plain)
    rec = {"fp32_4_layers": fp32, "bf16_24_layers": bf16,
           "bf16_24_layers_xla_vs_plain": floor, "bf16_launches": counts}
    out["logits"] = rec
    log("  " + json.dumps(rec))
    check(0 < counts["fused_mlp"] == counts["fused_mlp_hopper"],
          f"bf16 fused_mlp launches off the wgmma path: {counts}")
    check(fp32["rel_l2_err"] <= TOL["fp32"],
          f"fp32 logits rel L2 error {fp32['rel_l2_err']:.3e} > 1e-4")
    check(fp32["argmax_agree"] >= 0.95,
          f"fp32 argmax agreement {fp32['argmax_agree']:.2f} < 0.95")
    bound = max(TOL["bf16"], 3 * floor["rel_l2_err"])
    check(bf16["rel_l2_err"] <= bound,
          f"bf16 logits rel L2 error {bf16['rel_l2_err']:.3e} > {bound:.3e}")


def phase_pallas(state, out):
    import torch

    from repro_torch.core import moe_layer
    cfg, params = with_gemm(state["cfg"], "pallas"), state["params"]
    _, rec = serve(cfg, params, 8, 8, 2, "serve_pallas", out)
    check(rec["launches"]["grouped_gemm"] > 0,
          f"pallas serve did not launch grouped_gemm: {rec['launches']}")
    # every bf16 launch on the wgmma path
    check(rec["launches"]["grouped_gemm_hopper"]
          == rec["launches"]["grouped_gemm"],
          f"pallas serve: grouped_gemm launches off the wgmma path: "
          f"{rec['launches']}")
    moe = {k: v[0] for k, v in params["layers"][0]["moe"].items()
           if k != "experts"}
    moe["experts"] = {k: v[0] for k, v in
                      params["layers"][0]["moe"]["experts"].items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    res = {}
    for name, shape in (("prefill", (8, 256, cfg.d_model)),
                        ("decode", (8, 1, cfg.d_model))):
        x = torch.randn(shape, device="cuda", generator=gen).to(
            moe["experts"]["w_up"].dtype)
        ys = {}
        reset_counts()
        for impl in ("pallas", "xla"):
            c = with_gemm(cfg, impl)
            ys[impl], _ = moe_layer.moe_ffn(c, c.moe, moe, x)
        err, ok = max_err(ys["pallas"], ys["xla"], TOL["bf16"])
        counts = read_counts()
        res[name] = {"max_abs_err": err, "within_tol": ok,
                     "grouped_gemm_launches": counts["grouped_gemm"],
                     "grouped_gemm_hopper_launches":
                         counts["grouped_gemm_hopper"],
                     "y_absmean": float(ys["xla"].float().abs().mean())}
        check(res[name]["grouped_gemm_launches"] > 0,
              f"the pallas MoE layer did not launch grouped_gemm ({name})")
        check(counts["grouped_gemm_hopper"] == counts["grouped_gemm"],
              f"the pallas MoE layer launched grouped_gemm off the wgmma "
              f"path ({name}): {counts}")
    out["moe_layer_pallas_vs_xla"] = res
    log("  " + json.dumps(res))
    check(all(r["within_tol"] for r in res.values()),
          f"pallas MoE layer disagrees with xla: {res}")


# ---------------------------------------------------------------------------
# phase 6: the training path
# ---------------------------------------------------------------------------


def train_cfg(n_layers, dtype, gemm_impl="pallas_fused"):
    """qwen2-moe-2.7b at full width, cut in depth only; the MoE layer runs
    the comet arm, whose backward is the dgrad/wgrad kernels."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    return dataclasses.replace(
        cfg, n_layers=n_layers, param_dtype=dtype, compute_dtype=dtype,
        remat="full", moe=dataclasses.replace(cfg.moe, impl="comet",
                                              gemm_impl=gemm_impl))


def train_batch(cfg, step=0, seq=TRAIN_SEQ, batch=TRAIN_BATCH):
    """The train shape's synthetic batch (4 x 1024 tokens) on the card."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.specs import train_batch_specs
    shape = ShapeConfig("train", seq, batch, "train")
    nb = SyntheticLM(cfg, train_batch_specs(cfg, shape, 1)).batch_at(step)
    return {k: torch.from_numpy(v).long().cuda() for k, v in nb.items()}


def loss_and_grads(cfg, params, batch, plain=False):
    """loss_fn and the gradient of every leaf, through the kernels or (with
    ``plain``) the plain versions."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    leaves = [(p, t.requires_grad_(True)) for p, t in tree_leaves(params)]
    with plain_ops() if plain else contextlib.nullcontext():
        loss, _ = lm.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss.detach(), {p: g for (p, _), g in zip(leaves, grads)}


def rel_l2(got, want):
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp(min=1e-30))


def grad_check(cfg, params, batch, routes):
    """Loss and per-leaf gradient distances of the kernel route to the
    plain route (and of each extra route to the plain route)."""
    import torch
    runs = {"plain": loss_and_grads(cfg, params, batch, plain=True)}
    for name, c in routes.items():
        runs[name] = loss_and_grads(c, params, batch,
                                    plain=name != "kernels")
    torch.cuda.synchronize()
    want_l, want_g = runs.pop("plain")
    res = {}
    for name, (loss, grads) in runs.items():
        check(bool(torch.isfinite(loss)) and all(
            bool(g.isfinite().all()) for g in grads.values()),
            f"{name}: non-finite loss or gradient")
        res[name] = {
            "loss": float(loss), "loss_plain": float(want_l),
            "loss_rel_err": abs(float(loss) - float(want_l))
            / abs(float(want_l)),
            "grad_rel_l2": {"/".join(map(str, p)): rel_l2(g, want_g[p])
                            for p, g in grads.items()}}
    return res


def phase_train(state, out):
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.trainer import Trainer, TrainerConfig
    for key in ("params", "ssm_serve"):        # the serving weights
        state.pop(key, None)
    torch.cuda.empty_cache()
    rec = {}

    # (1) fp32, 2 layers: the kernels against the plain versions
    c32 = train_cfg(2, "float32")
    p32 = lm.init_params(c32, seed=1, device="cuda")
    g32 = grad_check(c32, p32, train_batch(c32), {"kernels": c32})
    del p32
    torch.cuda.empty_cache()
    k32 = g32["kernels"]
    worst32 = max(k32["grad_rel_l2"].values())
    rec["fp32_2_layers"] = {"loss_rel_err": k32["loss_rel_err"],
                            "grad_rel_l2_max": worst32,
                            "grad_rel_l2": k32["grad_rel_l2"]}
    log(f"  fp32 2 layers: loss {k32['loss']:.6f} (plain "
        f"{k32['loss_plain']:.6f}), worst leaf rel L2 {worst32:.3e}")
    check(k32["loss_rel_err"] <= TOL["fp32"] and worst32 <= TOL["fp32"],
          f"fp32 gradients: loss rel err {k32['loss_rel_err']:.3e}, worst "
          f"leaf {worst32:.3e} > 1e-4")

    # (2) bf16, 4 layers, beside the floor between two plain routes
    c16 = train_cfg(TRAIN_LAYERS, "bfloat16")
    p16 = lm.init_params(c16, seed=2, device="cuda")
    g16 = grad_check(c16, p16, train_batch(c16),
                     {"kernels": c16,
                      "xla": train_cfg(TRAIN_LAYERS, "bfloat16", "xla")})
    del p16
    torch.cuda.empty_cache()
    bad = []
    for leaf, err in g16["kernels"]["grad_rel_l2"].items():
        bound = max(TOL["bf16"], 3 * g16["xla"]["grad_rel_l2"][leaf])
        if err > bound:
            bad.append(f"{leaf}: {err:.3e} > {bound:.3e}")
    lbound = max(TOL["bf16"], 3 * g16["xla"]["loss_rel_err"])
    rec["bf16_4_layers"] = {
        name: {"loss_rel_err": r["loss_rel_err"],
               "grad_rel_l2_max": max(r["grad_rel_l2"].values()),
               "grad_rel_l2": r["grad_rel_l2"]} for name, r in g16.items()}
    log(f"  bf16 {TRAIN_LAYERS} layers: kernels vs plain loss rel err "
        f"{g16['kernels']['loss_rel_err']:.3e}, worst leaf "
        f"{max(g16['kernels']['grad_rel_l2'].values()):.3e}; xla vs plain "
        f"{g16['xla']['loss_rel_err']:.3e}, worst leaf "
        f"{max(g16['xla']['grad_rel_l2'].values()):.3e}")
    check(g16["kernels"]["loss_rel_err"] <= lbound,
          f"bf16 loss rel err {g16['kernels']['loss_rel_err']:.3e} > "
          f"{lbound:.3e}")
    check(not bad, f"bf16 gradients outside max(2e-2, 3 x floor): {bad}")

    # (3) the train step at full width, 4 layers
    cfg = train_cfg(TRAIN_LAYERS, "bfloat16")
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    tr = Trainer(cfg, shape, None, TrainerConfig(ckpt_dir=ckpt),
                 device="cuda")
    t0 = time.perf_counter()
    tstate = tr.init_state()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(tstate["params"]))
    log(f"  train: {ARCH} at {TRAIN_LAYERS} layers, {n_params / 1e9:.2f} B "
        f"parameters, init {time.perf_counter() - t0:.1f} s")
    batches = [tr._device_batch(tr.data.batch_at(i)) for i in range(4)]
    tstate, m = tr.built["fn"](tstate, batches[0])    # warm-up
    warm_loss = float(m["loss"])
    tstate, steps, counts, plain_calls = train_steps(tr, tstate, batches[1:])
    L = TRAIN_LAYERS
    tokens = TRAIN_SEQ * TRAIN_BATCH
    ms = statistics.median(st["ms"] for st in steps)
    rec["train"] = {
        "layers": L, "tokens_per_step": tokens, "params": n_params,
        "warmup_loss": warm_loss, "steps": steps, "step_ms_median": ms,
        "tokens_per_s": tokens / ms * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "plain_calls_on_cuda": plain_calls}
    log("  " + json.dumps(rec["train"]))
    # rmsnorm: the forward's 2L norms, their remat recompute in the
    # backward, and ln_f (outside the checkpointed periods); the norm's
    # backward is plain
    want = {"fused_mlp": 2 * L * 3, "fused_mlp_hopper": 2 * L * 3,
            "topk_combine": 2 * L * 3, "fused_mlp_dgrad": L * 3,
            "fused_mlp_dgrad_hopper": L * 3,
            "fused_mlp_wgrad": L * 3, "fused_mlp_wgrad_hopper": L * 3,
            "grouped_gemm": 0, "grouped_gemm_hopper": 0,
            "flash_attention": 2 * L * 3,
            "flash_attention_hopper": 2 * L * 3,
            "ssd_forward": 0, "ssd_forward_hopper": 0,
            "rmsnorm": (2 * 2 * L + 1) * 3,
            **head_launches(cfg, TRAIN_SEQ, 3)}
    check(counts == want, f"launches {counts}, expected {want} (3 steps)")
    check(plain_calls == 0,
          f"plain versions saw CUDA tensors {plain_calls} times")
    check(all(np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])
              and not st["skipped"] for st in steps),
          f"non-finite or skipped steps: {steps}")
    state["train"] = (tr, tstate, batches[0])
    out["train"] = rec

    # (4) Trainer.run with checkpoints and a fault-hook replay (smoke
    # config: a full-width checkpoint is 35 GB)
    smoke = get_config(ARCH + "-smoke")
    smoke = dataclasses.replace(smoke, moe=dataclasses.replace(
        smoke.moe, gemm_impl="pallas_fused"))
    sshape = ShapeConfig("smoke", 64, 4, "train")

    def run(hook=None):
        d = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
        t = Trainer(smoke, sshape, None,
                    TrainerConfig(ckpt_dir=d, ckpt_every=2, log_every=1000,
                                  keep=2), fault_hook=hook, device="cuda")
        return t.run(6)

    fired = []

    def bomb(step):
        if step == 5 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    clean, replay = run(), run(bomb)
    lc = [m["loss"] for m in clean["metrics"]]
    lr_ = [m["loss"] for m in replay["metrics"]]
    rec["trainer_run"] = {"arch": smoke.name, "clean_losses": lc,
                          "replay_losses": lr_,
                          "restarts": replay["restarts"],
                          "final_step": replay["final_step"]}
    log("  " + json.dumps(rec["trainer_run"]))
    # the replay repeats steps 5-6 from the step-4 checkpoint; torch's
    # atomic scatter-adds (embedding and dispatch gradients) may differ in
    # the last bits between the two runs
    check(replay["restarts"] == 1 and replay["final_step"] == 6
          and all(np.isfinite(lc + lr_))
          and abs(lr_[-1] - lc[-1]) <= 1e-4 * abs(lc[-1]),
          f"Trainer.run replay: {rec['trainer_run']}")


def train_steps(tr, tstate, batches):
    """Timed train steps (launch counters zeroed before, read after, plain
    versions watched): (state, step records, launch counts, plain calls on
    CUDA tensors)."""
    import torch
    step_fn = tr.built["fn"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps = []
    with PlainGuard() as guard:
        for b in batches:
            t0 = time.perf_counter()
            tstate, m = step_fn(tstate, b)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                          "loss": loss, "grad_norm": float(m["grad_norm"]),
                          "skipped": m["skipped"]})
    return tstate, steps, read_counts(), guard.cuda_calls


def ssm_cfg(n_layers, dtype, chunk=0):
    """mamba2-780m at full width, cut in depth only where named; ``chunk``
    overrides the SSD chunk of the plain route (the model's is 256)."""
    from repro_torch.configs import get_config
    cfg = get_config(SSM_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=n_layers, param_dtype=dtype,
                              compute_dtype=dtype, remat="full")
    if chunk:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=chunk))
    return cfg


def phase_train_ssm(state, out):
    """mamba2-780m: gradients through the SSD kernel against the plain
    chunked form, then the train step of the whole model."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.training.trainer import Trainer, TrainerConfig
    for key in ("params", "ssm_serve", "train"):   # earlier phases' state
        state.pop(key, None)
    torch.cuda.empty_cache()
    rec = {}

    def batch_of(cfg):
        return train_batch(cfg, 0, SSM_SEQ, SSM_BATCH)

    # (1) fp32, 2 layers: the kernel route (forward and backward at the
    # kernel's chunk of 64) against the plain chunked form at the model's
    # chunk (256); the plain form at chunk 64 beside it shows the fp32
    # floor of that chunk change (reported, not a bound)
    c32 = ssm_cfg(2, "float32")
    p32 = lm.init_params(c32, seed=1, device="cuda")
    g32 = grad_check(c32, p32, batch_of(c32),
                     {"kernels": c32, "chunk64": ssm_cfg(2, "float32", 64)})
    del p32
    torch.cuda.empty_cache()
    k32 = g32["kernels"]
    worst32 = max(k32["grad_rel_l2"].values())
    rec["fp32_2_layers"] = {
        "loss_rel_err": k32["loss_rel_err"], "grad_rel_l2_max": worst32,
        "grad_rel_l2": k32["grad_rel_l2"],
        "chunk64_grad_rel_l2_max": max(g32["chunk64"]["grad_rel_l2"]
                                       .values())}
    floor32 = rec["fp32_2_layers"]["chunk64_grad_rel_l2_max"]
    log(f"  fp32 2 layers: loss {k32['loss']:.6f} (plain "
        f"{k32['loss_plain']:.6f}), worst leaf rel L2 {worst32:.3e}; "
        f"chunk 64 vs plain {floor32:.3e}")
    check(k32["loss_rel_err"] <= TOL["fp32"] and worst32 <= TOL["fp32"],
          f"fp32 gradients: loss rel err {k32['loss_rel_err']:.3e}, worst "
          f"leaf {worst32:.3e} > 1e-4")

    # (2) bf16, 4 layers, beside a second plain route (chunk 64)
    c16 = ssm_cfg(4, "bfloat16")
    p16 = lm.init_params(c16, seed=2, device="cuda")
    g16 = grad_check(c16, p16, batch_of(c16),
                     {"kernels": c16, "chunk64": ssm_cfg(4, "bfloat16", 64)})
    del p16
    torch.cuda.empty_cache()
    bad = []
    for leaf, err in g16["kernels"]["grad_rel_l2"].items():
        bound = max(TOL["bf16"], 3 * g16["chunk64"]["grad_rel_l2"][leaf])
        if err > bound:
            bad.append(f"{leaf}: {err:.3e} > {bound:.3e}")
    lbound = max(TOL["bf16"], 3 * g16["chunk64"]["loss_rel_err"])
    rec["bf16_4_layers"] = {
        name: {"loss_rel_err": r["loss_rel_err"],
               "grad_rel_l2_max": max(r["grad_rel_l2"].values()),
               "grad_rel_l2": r["grad_rel_l2"]} for name, r in g16.items()}
    log(f"  bf16 4 layers: kernel vs plain loss rel err "
        f"{g16['kernels']['loss_rel_err']:.3e}, worst leaf "
        f"{max(g16['kernels']['grad_rel_l2'].values()):.3e}; chunk 64 vs "
        f"plain {g16['chunk64']['loss_rel_err']:.3e}, worst leaf "
        f"{max(g16['chunk64']['grad_rel_l2'].values()):.3e}")
    check(g16["kernels"]["loss_rel_err"] <= lbound,
          f"bf16 loss rel err {g16['kernels']['loss_rel_err']:.3e} > "
          f"{lbound:.3e}")
    check(not bad, f"bf16 gradients outside max(2e-2, 3 x floor): {bad}")

    # (3) the train step of the whole model: 48 layers, bf16
    cfg = ssm_cfg(48, "bfloat16")
    shape = ShapeConfig("train", SSM_SEQ, SSM_BATCH, "train")
    tr = Trainer(cfg, shape, None,
                 TrainerConfig(ckpt_dir=tempfile.mkdtemp(
                     prefix="chip_smoke_ssm_")), device="cuda")
    t0 = time.perf_counter()
    tstate = tr.init_state()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(tstate["params"]))
    log(f"  train: {SSM_ARCH}, {cfg.n_layers} layers, {n_params / 1e9:.3f} "
        f"B parameters, init {time.perf_counter() - t0:.1f} s")
    batches = [tr._device_batch(tr.data.batch_at(i)) for i in range(4)]
    tstate, m = tr.built["fn"](tstate, batches[0])    # warm-up
    warm_loss = float(m["loss"])
    tstate, steps, counts, plain_calls = train_steps(tr, tstate, batches[1:])
    L, tokens = cfg.n_layers, SSM_SEQ * SSM_BATCH
    ms = statistics.median(st["ms"] for st in steps)
    rec["train"] = {
        "arch": SSM_ARCH, "layers": L, "tokens_per_step": tokens,
        "params": n_params, "warmup_loss": warm_loss, "steps": steps,
        "step_ms_median": ms, "tokens_per_s": tokens / ms * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "plain_calls_on_cuda": plain_calls}
    log("  " + json.dumps(rec["train"]))
    # rmsnorm: ln1 and the gated norm per layer, forward and remat
    # recompute, and ln_f
    want = {"fused_mlp": 0, "fused_mlp_hopper": 0, "topk_combine": 0,
            "fused_mlp_dgrad": 0, "fused_mlp_dgrad_hopper": 0,
            "fused_mlp_wgrad": 0, "fused_mlp_wgrad_hopper": 0,
            "grouped_gemm": 0, "grouped_gemm_hopper": 0, "flash_attention": 0,
            "flash_attention_hopper": 0,
            "ssd_forward": 2 * L * 3, "ssd_forward_hopper": 2 * L * 3,
            "rmsnorm": (2 * 2 * L + 1) * 3,
            **head_launches(cfg, SSM_SEQ, 3)}
    check(counts == want, f"launches {counts}, expected {want} (3 steps)")
    check(plain_calls == 0,
          f"plain versions saw CUDA tensors {plain_calls} times")
    check(all(np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])
              and not st["skipped"] for st in steps),
          f"non-finite or skipped steps: {steps}")
    state["train_ssm"] = (tr, tstate, batches[0])
    out["train_ssm"] = rec


# ---------------------------------------------------------------------------
# phase 9: the ranked MoE layer
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def world1(backend):
    """A default process group of one rank on ``backend``, meeting through
    a file in a temporary directory; destroyed on exit."""
    import tempfile

    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def ranked_ctx(seq_shard=False):
    from repro_torch.parallel.mesh import AxisCtx, make_mesh
    return AxisCtx(mesh=make_mesh((1, 1), ("data", "model")),
                   dp_axes=("data",), model_axis="model",
                   seq_shard=seq_shard)


def ranked_selftest(rec, case="moe"):
    """The port's self-test CLI at --device cuda: one NCCL rank per GPU."""
    import os
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.selftest", "--device",
         "cuda", "--case", case, "--timeout", "240"], capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    rec["selftest"] = {"case": case, "rc": proc.returncode,
                       "checks": len(lines),
                       "passed": sum(ln.startswith("[PASS]") for ln in lines),
                       "train_checks": [ln for ln in lines if "mesh_" in ln],
                       "s": time.perf_counter() - t0}
    log(f"  selftest --device cuda --case {case}: "
        + json.dumps(rec["selftest"]))
    check(proc.returncode == 0 and lines
          and rec["selftest"]["passed"] == len(lines),
          f"selftest --device cuda --case {case} failed:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def ranked_layer(rec):
    """One qwen2-moe-2.7b MoE layer at full width (bf16, pallas_fused,
    RANKED_TOKENS) through the ranked moe_ffn over a one-rank NCCL context
    and without one, forward and backward: the same bits, every MoE
    kernel launch on the wgmma path, every tensor on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import moe_layer as M
    cfg = get_config(ARCH)
    m0 = dataclasses.replace(cfg.moe, gemm_impl="pallas_fused")
    d, E, f = cfg.d_model, m0.num_experts, m0.d_expert
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    base = {"router": _randn((d, E), torch.bfloat16, d ** -0.5, gen),
            "experts": {
                "w_gate": _randn((1, E, d, f), torch.bfloat16, d ** -0.5,
                                 gen),
                "w_up": _randn((1, E, d, f), torch.bfloat16, d ** -0.5, gen),
                "w_down": _randn((1, E, f, d), torch.bfloat16, f ** -0.5,
                                 gen)}}
    x = _randn(RANKED_TOKENS + (d,), torch.bfloat16, 1.0, gen)

    def fwd_bwd(mcfg, ctx):
        params = {"router": base["router"].clone().requires_grad_(True),
                  "experts": {k: v.clone().requires_grad_(True)
                              for k, v in base["experts"].items()}}
        y, aux = M.moe_ffn(cfg, mcfg, params, x, ctx)
        leaves = [params["router"]] + [params["experts"][k]
                                       for k in sorted(params["experts"])]
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux, leaves)
        return [y, aux, *grads]

    ctx = ranked_ctx()
    res = {}
    ring = dict(ring_group=1, n_col_blocks=2, fused_combine=True)
    for name, kw in (("naive", dict(impl="naive")),
                     ("coarse", dict(impl="coarse")),
                     ("comet", dict(impl="comet", **ring)),
                     ("comet_hier-bf16", dict(impl="comet_hier",
                                              wire_dtype="bf16", **ring)),
                     ("comet_hier-fp8_e4m3", dict(
                         impl="comet_hier", wire_dtype="fp8_e4m3",
                         **ring))):
        mcfg = dataclasses.replace(m0, **kw)
        runs, r = {}, {}
        for tag, c in (("no_ctx", None), ("ctx", ctx)):
            reset_counts()
            with PlainGuard() as guard:
                runs[tag] = fwd_bwd(mcfg, c)
                torch.cuda.synchronize()
            counts = read_counts()
            r[tag] = {"launches": counts, "plain_calls_on_cuda":
                      guard.cuda_calls,
                      "ms": median_ms(lambda: fwd_bwd(mcfg, c), iters=5)}
            for k in ("fused_mlp", "fused_mlp_dgrad", "fused_mlp_wgrad"):
                check(counts[k] > 0 and counts[f"{k}_hopper"] == counts[k],
                      f"ranked {name} ({tag}): {k} launches off the wgmma "
                      f"path or none: {counts}")
            check(counts["topk_combine"] > 0,
                  f"ranked {name} ({tag}): no topk_combine launch")
            check(guard.cuda_calls == 0, f"ranked {name} ({tag}): plain "
                  f"versions saw CUDA tensors {guard.cuda_calls} times")
            check(all(t.is_cuda for t in runs[tag]),
                  f"ranked {name} ({tag}): a result off the card")
        r["same_bits"] = all(torch.equal(a, b)
                             for a, b in zip(runs["no_ctx"], runs["ctx"]))
        r["y_absmean"] = float(runs["ctx"][0].detach().float().abs()
                               .mean())
        res[name] = r
        log(f"  ranked {name}: " + json.dumps(r))
        check(r["same_bits"], f"ranked {name}: the world-1 NCCL context "
              f"does not give the context-less bits")
    rec["layer"] = {"tokens": list(RANKED_TOKENS), "impls": res}


def ring_producer(rec):
    """The ring's per-macro-step producer (``mlp_col_blocks`` under
    pallas_fused, one column-sliced fused_mlp per block) at the shapes one
    rank of a RING_RANKS-rank ring runs: E_loc = E / ranks experts, rows
    g * C for ring_group g, C from routing.capacity at the layer's local
    tokens; held against the column slices of the whole product at the
    bf16 tolerance and timed beside it."""
    import torch

    from repro_torch.analysis import roofline as RL
    from repro_torch.configs import get_config
    from repro_torch.core import routing as R
    from repro_torch.core import transport as T
    from repro_torch.kernels import fused_mlp
    cfg = get_config(ARCH)
    m = cfg.moe
    d, f, act = cfg.d_model, m.d_expert, cfg.activation
    E_loc = m.num_experts // RING_RANKS
    C = R.capacity(RANKED_TOKENS[0] * RANKED_TOKENS[1], m.top_k,
                   m.num_experts, m.capacity_factor)
    n_col, blk = 2, d // 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    w = {"w_gate": _randn((E_loc, d, f), torch.bfloat16, d ** -0.5, gen),
         "w_up": _randn((E_loc, d, f), torch.bfloat16, d ** -0.5, gen),
         "w_down": _randn((E_loc, f, d), torch.bfloat16, f ** -0.5, gen)}
    res = {}
    for g in (1, 2):
        rows = _randn((E_loc, g * C, d), torch.bfloat16, 1.0, gen)
        whole = T._mlp_out(rows, w, act, "pallas_fused")
        fused_mlp.reset()
        blocks = T.mlp_col_blocks(rows, w, act, n_col, blk, "pallas_fused")
        torch.cuda.synchronize()
        launches = (fused_mlp.launches, fused_mlp.hopper_launches)
        errs = [max_err(b, whole[..., i * blk:(i + 1) * blk], TOL["bf16"])
                for i, b in enumerate(blocks)]
        R_ = g * C
        whole_bound, by = bound_ms(RL.fused_mlp_cost(E_loc, R_, d, f, d))
        r = {"E_loc": E_loc, "rows": R_, "C": C, "n_col": n_col,
             "launches": launches[0], "hopper_launches": launches[1],
             "max_abs_err": max(e for e, _ in errs),
             "within_tol": all(o for _, o in errs),
             "blocks_ms": median_ms(lambda: T.mlp_col_blocks(
                 rows, w, act, n_col, blk, "pallas_fused")),
             "whole_ms": median_ms(lambda: T._mlp_out(rows, w, act,
                                                      "pallas_fused")),
             "whole_bound_ms": whole_bound, "whole_bound_by": by}
        res[f"ring_group{g}"] = r
        log(f"  mlp_col_blocks E_loc {E_loc} rows {R_}: " + json.dumps(r))
        check(launches == (n_col, n_col),
              f"mlp_col_blocks launches {launches}, expected {n_col} on the "
              f"wgmma path")
        check(r["within_tol"], f"mlp_col_blocks at rows {R_} disagrees "
              f"with the whole product: {r['max_abs_err']}")
    rec["col_blocks"] = res


def phase_ranked(state, out):
    import torch

    from repro_torch.parallel import collectives as CL
    state.clear()                     # earlier phases' weights and state
    torch.cuda.empty_cache()
    rec = {}
    ranked_selftest(rec)
    with world1("nccl"):
        ranked_layer(rec)
    ring_producer(rec)
    # a gloo communicator handed a CUDA tensor raises by name
    with world1("gloo"):
        ctx = ranked_ctx(seq_shard=True)
        try:
            CL.psum(torch.ones(4, device="cuda"), ctx.model_group)
            raised = ""
        except ValueError as e:
            raised = str(e)
    rec["gloo_cuda_refusal"] = raised
    log(f"  gloo + CUDA tensor: {raised!r}")
    check("gloo communicator takes cpu" in raised,
          f"a gloo context took a CUDA tensor: {raised!r}")
    out["ranked"] = rec


# ---------------------------------------------------------------------------
# phase 10: the mesh train step
# ---------------------------------------------------------------------------


def _state_leaves(state):
    """{(part, *path): leaf} of every parameter and AdamW moment."""
    from repro_torch.models.common import tree_leaves
    return {(part,) + path: t
            for part, tree in (("params", state["params"]),
                               ("m", state["opt"]["m"]),
                               ("v", state["opt"]["v"]))
            for path, t in tree_leaves(tree)}


def mesh_vs_meshless(rec):
    """Phase 6's configuration through build_train_step without a mesh and
    on a (1, 1) mesh over the world-1 NCCL group, one step each from one
    seed on one batch: the loss and every updated leaf compared (the
    mesh-less state goes to the host first: two states do not fit one
    card beside a step). Returns the mesh run (built, state, batches)."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import specs as SP
    from repro_torch.launch.train_step import build_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.mesh import make_mesh
    cfg = train_cfg(TRAIN_LAYERS, "bfloat16")
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    mesh = make_mesh((1, 1), ("data", "model"))
    batches = [train_batch(cfg, step=i) for i in range(4)]
    runs = {}
    for tag, m in (("meshless", None), ("mesh", mesh)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        built = build_train_step(cfg, shape, m)
        params = lm.init_params(cfg, seed=3, device="cuda")
        batch = batches[0]
        if m is not None:
            params = SH.to_mesh(params, cfg, built["ctx"])
            batch = SP.local_batch(batch, built["batch_pspecs"], m)
        st = {"params": params, "opt": AdamW().init(params), "step": 0}
        del params
        t0 = time.perf_counter()
        st, met = built["fn"](st, batch)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        runs[tag] = {"loss": loss, "grad_norm": float(met["grad_norm"]),
                     "skipped": met["skipped"],
                     "ms": (time.perf_counter() - t0) * 1e3,
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9}
        if m is None:
            ref = {k: t.detach().to("cpu", copy=True)
                   for k, t in _state_leaves(st).items()}
            del st, built
        else:
            got = {k: t.detach() for k, t in _state_leaves(st).items()}
            kept = (built, st, batches)
    check(set(got) == set(ref), "the two states hold different leaves")
    # leaf by leaf on the card: the mesh-less leaf comes back from the host
    same, errs = 0, {}
    for k, want in ref.items():
        w = want.to("cuda")
        same += bool(torch.equal(got[k], w))
        errs["/".join(map(str, k))] = rel_l2(got[k], w)
        del w
    worst = max(errs, key=errs.get)
    lerr = abs(runs["mesh"]["loss"] - runs["meshless"]["loss"]) / abs(
        runs["meshless"]["loss"])
    rec["compare"] = {"runs": runs, "leaves": len(ref),
                      "identical_bits": same, "loss_rel_err": lerr,
                      "worst_leaf": worst, "worst_rel_l2": errs[worst]}
    log("  mesh (1, 1) vs mesh-less, one step: " + json.dumps(rec["compare"]))
    log(f"  {same} of {len(ref)} leaves (parameters and moments) gave "
        f"identical bits")
    check(not runs["mesh"]["skipped"] and not runs["meshless"]["skipped"],
          f"a step was skipped: {runs}")
    check(lerr <= TOL["bf16"] and errs[worst] <= TOL["bf16"],
          f"mesh vs mesh-less: loss rel err {lerr:.3e}, {worst} rel L2 "
          f"{errs[worst]:.3e} > {TOL['bf16']}")
    return kept


def mesh_timed_steps(rec, out, kept):
    """Three timed steps of the mesh step after the compared one (its
    warm-up): phase 6's launch counts on the wgmma path, no plain call on
    a CUDA tensor, step time and memory beside phase 6's."""
    import types

    import numpy as np
    built, st, batches = kept
    from repro_torch.launch import specs as SP
    mesh = built["ctx"].mesh
    local = [SP.local_batch(b, built["batch_pspecs"], mesh)
             for b in batches[1:]]
    st, steps, counts, plain_calls = train_steps(
        types.SimpleNamespace(built=built), st, local)
    import torch
    L = TRAIN_LAYERS
    tokens = TRAIN_SEQ * TRAIN_BATCH
    ms = statistics.median(s["ms"] for s in steps)
    p6 = out.get("train", {}).get("train", {})
    rec["train"] = {
        "layers": L, "tokens_per_step": tokens, "steps": steps,
        "step_ms_median": ms, "tokens_per_s": tokens / ms * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "plain_calls_on_cuda": plain_calls,
        "phase6_step_ms_median": p6.get("step_ms_median"),
        "phase6_tokens_per_s": p6.get("tokens_per_s"),
        "phase6_max_memory_allocated_gb": p6.get("max_memory_allocated_gb")}
    log("  mesh step: " + json.dumps(rec["train"]))
    if p6:
        log(f"  mesh step {ms:.1f} ms ({tokens / ms * 1e3:.0f} tokens/s, "
            f"{rec['train']['max_memory_allocated_gb']:.1f} GB) beside "
            f"phase 6's {p6['step_ms_median']:.1f} ms "
            f"({p6['tokens_per_s']:.0f} tokens/s, "
            f"{p6['max_memory_allocated_gb']:.1f} GB)")
    want = {"fused_mlp": 2 * L * 3, "fused_mlp_hopper": 2 * L * 3,
            "topk_combine": 2 * L * 3, "fused_mlp_dgrad": L * 3,
            "fused_mlp_dgrad_hopper": L * 3,
            "fused_mlp_wgrad": L * 3, "fused_mlp_wgrad_hopper": L * 3,
            "grouped_gemm": 0, "grouped_gemm_hopper": 0,
            "flash_attention": 2 * L * 3,
            "flash_attention_hopper": 2 * L * 3,
            "ssd_forward": 0, "ssd_forward_hopper": 0,
            "rmsnorm": (2 * 2 * L + 1) * 3,
            **head_launches(train_cfg(L, "bfloat16"), TRAIN_SEQ, 3)}
    check(counts == want, f"mesh step launches {counts}, expected {want} "
          f"(3 steps)")
    check(plain_calls == 0,
          f"plain versions saw CUDA tensors {plain_calls} times")
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
              and not s["skipped"] for s in steps),
          f"non-finite or skipped mesh steps: {steps}")


def mesh_train_cli(rec):
    """``torchrun -m repro_torch.launch.train --mesh 1,1 --distributed``
    on qwen2-moe-2.7b-smoke, 4 steps: exit 0 with finite losses."""
    import math
    import os
    import re
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "repro_torch.launch.train",
             "--arch", ARCH + "-smoke", "--mesh", "1,1", "--distributed",
             "--steps", "4", "--batch", "4", "--seq", "64", "--ckpt-dir",
             ckpt], capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    m = re.search(r"final_step=(\d+) restarts=(\d+) loss (\S+) -> (\S+)",
                  proc.stdout)
    rec["cli"] = {"rc": proc.returncode, "s": time.perf_counter() - t0,
                  "line": m.group(0) if m else None}
    log("  torchrun launch.train --mesh 1,1 --distributed: "
        + json.dumps(rec["cli"]))
    check(proc.returncode == 0 and m and m.group(1) == "4"
          and all(math.isfinite(float(m.group(i))) for i in (3, 4)),
          f"torchrun launch.train failed:\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-3000:]}")


def phase_mesh_train(state, out):
    import torch
    state.clear()                     # earlier phases' weights and state
    torch.cuda.empty_cache()
    rec = {}
    with world1("nccl"):
        kept = mesh_vs_meshless(rec)
        mesh_timed_steps(rec, out, kept)
        del kept
    torch.cuda.empty_cache()
    mesh_train_cli(rec)
    ranked_selftest(rec, case="all")
    out["mesh_train"] = rec


# ---------------------------------------------------------------------------
# phase 11: adaptive workload assignment (the plan cache and the tuner)
# ---------------------------------------------------------------------------


def _moe_spy(sink):
    """While active, appends (impl, ring_group, n_col, gemm_impl, tokens,
    fused_combine, sequence length) of every moe_ffn body to ``sink`` (a
    list, or None to record nothing)."""
    from repro_torch.core import moe_layer as M
    real = M._moe_body

    def spy(cfg, mcfg, n_col, gemm_impl, x, *a, **kw):
        if sink is not None:
            sink.append((mcfg.impl, mcfg.ring_group, n_col, gemm_impl,
                         x.shape[0] * x.shape[1], mcfg.fused_combine,
                         x.shape[1]))
        return real(cfg, mcfg, n_col, gemm_impl, x, *a, **kw)

    @contextlib.contextmanager
    def cm():
        M._moe_body = spy
        try:
            yield sink
        finally:
            M._moe_body = real
    return cm()


def _backend_launches_ok(gemm_impl, d, train=False):
    """Whether the launch deltas ``d`` are those of a MoE under
    ``gemm_impl``: pallas_fused launches fused_mlp (and with ``train``
    dgrad and wgrad), pallas grouped_gemm, xla neither; every launch on
    the wgmma path, and topk_combine in every case."""
    fused = ("fused_mlp",) + (("fused_mlp_dgrad", "fused_mlp_wgrad")
                              if train else ())
    if d["topk_combine"] <= 0:
        return False
    if gemm_impl == "pallas_fused":
        return (all(d[k] > 0 and d[f"{k}_hopper"] == d[k] for k in fused)
                and d["grouped_gemm"] == 0)
    if gemm_impl == "pallas":
        return (d["grouped_gemm"] > 0
                and d["grouped_gemm_hopper"] == d["grouped_gemm"]
                and d["fused_mlp"] == 0)
    return d["fused_mlp"] == 0 and d["grouped_gemm"] == 0


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def plan_model_backed(rec, path):
    """(a) launch.tune, model-backed, h100_nvlink, the qwen2 layer at ep 1:
    train at 4 x 1024 tokens, prefill at an 8 x 256 chunk, decode at 8."""
    from repro_torch.launch import tune
    res = tune.main(["--hw", PLAN_HW, "--models", ARCH, "--ep", "1",
                     "--phase", "train", "prefill", "decode", "--M",
                     str(PLAN_TOKENS["prefill"]), str(PLAN_TOKENS["train"]),
                     "--decode-M", str(PLAN_TOKENS["decode"]), "--out",
                     path])
    rec["model"] = {f"{plan.phase}/M{s.M}": plan.to_json()
                    for _, s, plan in res["rows"]}
    check(len(res["rows"]) == 5 and all(p.source == "model"
                                        for _, _, p in res["rows"]),
          f"model-backed tune: {res['rows']}")


def plan_measured(rec, path):
    """(b) launch.tune --measured at world 1 on phase 9's layer (E 64,
    top-4, d 2048, f 1408, bf16, the config's capacity), PLAN_ROUNDS
    times per phase (the cache keeps the last round's winners): every
    candidate timed (train: forward and backward over xla and
    pallas_fused; prefill and decode: forward over xla, pallas and
    pallas_fused), its launches counted, its modeled ms on h100_nvlink
    beside its measured ms, the card's pick beside the model's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import adaptive as A
    from repro_torch.launch import tune
    cfg = get_config(ARCH)
    per_cand = []
    real = A.make_timing_measure

    def counted(*a, **kw):
        inner = real(*a, **kw)

        def measure(plan):
            torch.cuda.synchronize()
            reset_counts()
            with PlainGuard() as guard:
                t = inner(plan)
            per_cand.append({"plan": plan, "launches": read_counts(),
                             "plain_calls_on_cuda": guard.cuda_calls})
            return t
        return measure

    def one_round(phase, B, S):
        per_cand.clear()
        gemm = (["xla", "pallas_fused"] if phase == "train"
                else ["xla", "pallas", "pallas_fused"])
        t0 = time.perf_counter()
        out = tune.main(["--measured", "--hw", PLAN_HW, "--arch", ARCH,
                         "--batch", str(B), "--seq", str(S), "--phase",
                         phase, "--capacity-factor",
                         str(cfg.moe.capacity_factor), "--iters",
                         str(PLAN_ITERS), "--force", "--gemm", *gemm,
                         "--out", path])
        (_, s, won), = out["rows"]
        model = A.phase_measure(A.H100_NVL, s, phase)
        launches = {_plan_tag(c["plan"]): c for c in per_cand}
        cands = []
        for plan, t, err in out["timed"]:
            c = launches.get(_plan_tag(plan), {})
            ok = bool(c) and _backend_launches_ok(
                plan.gemm_impl, c["launches"], train=phase == "train")
            cands.append({"plan": _plan_tag(plan),
                          "ms": None if t is None else t * 1e3,
                          "model_ms": model(plan) * 1e3, "error": err,
                          "launches_ok": ok,
                          "plain_calls_on_cuda": c.get("plain_calls_on_cuda"),
                          "launches": c.get("launches")})
        done = [c for c in cands if c["ms"] is not None]
        model_pick = min(done, key=lambda c: c["model_ms"])["plan"]
        r = {"key": A.PlanCache.key(s, A.H100_NVL, phase), "tokens": [B, S],
             "candidates": cands, "card_pick": _plan_tag(won),
             "card_pick_ms": won.measured_s * 1e3, "model_pick": model_pick,
             "same_pick": model_pick == _plan_tag(won),
             "analytic_plan": _plan_tag(A.analytic_plan(s, A.H100_NVL,
                                                        phase)),
             "s": time.perf_counter() - t0}
        log(f"  measured {phase} ({B} x {S} tokens), {len(cands)} "
            f"candidates: card picks {r['card_pick']} "
            f"({r['card_pick_ms']:.3f} ms), the model {r['model_pick']}: "
            f"{'same' if r['same_pick'] else 'differ'}; analytic_plan "
            f"{r['analytic_plan']}")
        for c in cands:
            log(f"    {c['plan']:<34} card "
                + ("failed: " + c["error"] if c["ms"] is None
                   else f"{c['ms']:8.3f} ms") + f"  model "
                f"{c['model_ms']:8.3f} ms")
        check(all(c["ms"] is not None for c in cands),
              f"measured {phase}: candidates failed: "
              f"{[c for c in cands if c['ms'] is None]}")
        check(all(c["launches_ok"] and c["plain_calls_on_cuda"] == 0
                  for c in cands),
              f"measured {phase}: launches do not match the backends: "
              f"{[c for c in cands if not c['launches_ok']]}")
        return r

    res = {phase: {"rounds": []} for phase in PLAN_SHAPES}
    A.make_timing_measure = counted
    try:
        for _ in range(PLAN_ROUNDS):
            for phase, (B, S) in PLAN_SHAPES.items():
                res[phase]["rounds"].append(one_round(phase, B, S))
    finally:
        A.make_timing_measure = real
    for phase, r in res.items():
        picks = [x["card_pick"] for x in r["rounds"]]
        r["card_pick_stable"] = len(set(picks)) == 1
        log(f"  {phase}: the card's picks over {PLAN_ROUNDS} rounds "
            f"{picks}; the model's {r['rounds'][-1]['model_pick']}")
    rec["measured"] = res


def _plan_tag(plan):
    return (f"{plan.impl} rg{plan.ring_group} nc{plan.n_col_blocks} "
            f"{plan.gemm_impl} fc{int(plan.fused_combine)}")


def _plan_layer(seed=21):
    """Phase 9's layer: qwen2-moe-2.7b's MoE at full width, bf16, seeded
    weights on the card (router, packed experts)."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_expert
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    base = {"router": _randn((d, E), torch.bfloat16, d ** -0.5, gen),
            "experts": {
                "w_gate": _randn((1, E, d, f), torch.bfloat16, d ** -0.5,
                                 gen),
                "w_up": _randn((1, E, d, f), torch.bfloat16, d ** -0.5, gen),
                "w_down": _randn((1, E, f, d), torch.bfloat16, f ** -0.5,
                                 gen)}}
    return cfg, base, gen


def plan_layer_bits(rec, path):
    """(c) per phase, moe_ffn with the cache against moe_ffn under the
    cached plan's knobs set explicitly (plan.apply: plan_override): the
    same bits (the train phase also every gradient), the kernels the plan
    names launched."""
    import torch

    from repro_torch.core import adaptive as A
    from repro_torch.core import moe_layer as M
    cfg, base, gen = _plan_layer()
    res = {}
    for phase, (B, S) in PLAN_SHAPES.items():
        x = _randn((B, S, cfg.d_model), torch.bfloat16, 1.0, gen)
        m_cache = dataclasses.replace(cfg.moe, plan_cache=path,
                                      plan_hw=PLAN_HW, plan_phase=phase,
                                      impl="naive", gemm_impl="xla")
        s = A.plan_shape(cfg.moe, cfg.d_model, B * S, 1, 1)
        plan = A.load_plan_cache(path).get(s, A.H100_NVL, phase)
        check(plan is not None and plan.source == "measured",
              f"no measured {phase} plan in the cache: {plan}")
        train = phase == "train"

        def run(mcfg):
            params = {"router": base["router"].clone().requires_grad_(train),
                      "experts": {k: v.clone().requires_grad_(train)
                                  for k, v in base["experts"].items()}}
            with torch.set_grad_enabled(train):
                y, aux = M.moe_ffn(cfg, mcfg, params, x)
                if not train:
                    return [y, aux]
                leaves = [params["router"]] + [
                    params["experts"][k] for k in sorted(params["experts"])]
                return [y.detach(), aux.detach(), *torch.autograd.grad(
                    (y.float() ** 2).sum() + aux, leaves)]

        torch.cuda.synchronize()
        reset_counts()
        ran = []
        with PlainGuard() as guard, _moe_spy(ran):
            got = run(m_cache)
            torch.cuda.synchronize()
        counts = read_counts()
        want = run(plan.apply(cfg.moe))
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        r = {"plan": _plan_tag(plan), "ran": [list(t) for t in ran],
             "same_bits": same, "launches": counts,
             "plain_calls_on_cuda": guard.cuda_calls,
             "finite": all(bool(t.float().isfinite().all()) for t in got)}
        res[phase] = r
        log(f"  layer with the cache, {phase}: " + json.dumps(
            {k: v for k, v in r.items() if k != "launches"}))
        check(ran and all(t[:4] == (plan.impl, plan.ring_group,
                                    plan.n_col_blocks, plan.gemm_impl)
                          for t in ran),
              f"{phase}: the layer did not run the cached plan: {ran}")
        check(same and r["finite"], f"{phase}: the cache's plan does not "
              f"give the bits of its explicit knobs")
        check(_backend_launches_ok(plan.gemm_impl, counts, train) and
              guard.cuda_calls == 0,
              f"{phase}: launches {counts} do not match {plan.gemm_impl}")
    rec["layer"] = res


def plan_train(rec, path):
    """(d) phase 6's configuration through build_train_step with the plan
    cache (what Trainer and launch/train.py build): 3 steps, finite, none
    skipped; its first step's loss against the step built with the
    cached train plan's knobs set explicitly, from the same seed and
    batch. Then launch/train.py --plan-cache on the smoke config (its
    checkpoint at full width would be 35 GB)."""
    import math
    import tempfile

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.core import adaptive as A
    from repro_torch.launch import train
    from repro_torch.launch.train_step import build_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW
    cfg = train_cfg(TRAIN_LAYERS, "bfloat16")
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batches = [train_batch(cfg, step=i) for i in range(3)]
    s = A.plan_shape(cfg.moe, cfg.d_model, TRAIN_SEQ * TRAIN_BATCH, 1, 1)
    plan = A.load_plan_cache(path).get(s, A.H100_NVL, "train")
    explicit = dataclasses.replace(cfg, moe=plan.apply(cfg.moe))
    runs = {}
    for tag, c, kw, n in (("explicit", explicit, {}, 1),
                          ("cache", cfg, dict(plan_cache=path,
                                              plan_hw=PLAN_HW), 3)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        built = build_train_step(c, shape, **kw)
        params = lm.init_params(c, seed=5, device="cuda")
        st = {"params": params, "opt": AdamW().init(params), "step": 0}
        del params
        steps = []
        reset_counts()
        ran = []
        with PlainGuard() as guard, _moe_spy(ran):
            for b in batches[:n]:
                t0 = time.perf_counter()
                st, met = built["fn"](st, b)
                loss = float(met["loss"])
                torch.cuda.synchronize()
                steps.append({"loss": loss, "loss_hex": loss.hex(),
                              "skipped": met["skipped"],
                              "grad_norm": float(met["grad_norm"]),
                              "ms": (time.perf_counter() - t0) * 1e3})
        runs[tag] = {"steps": steps, "launches": read_counts(),
                     "plain_calls_on_cuda": guard.cuda_calls,
                     "moe_knobs": sorted({t[:4] for t in ran})}
        del st, built
    same = runs["cache"]["steps"][0]["loss_hex"] == \
        runs["explicit"]["steps"][0]["loss_hex"]
    rec["train"] = {"plan": _plan_tag(plan), "runs": runs,
                    "first_loss_same_bits": same}
    log("  train step with the cache: " + json.dumps(rec["train"]))
    check(runs["cache"]["moe_knobs"] == [(plan.impl, plan.ring_group,
                                          plan.n_col_blocks, plan.gemm_impl)],
          f"train: the MoE layers ran {runs['cache']['moe_knobs']}")
    check(all(math.isfinite(st["loss"]) and not st["skipped"]
              for st in runs["cache"]["steps"]),
          f"train with the cache: {runs['cache']['steps']}")
    check(same, "train: the first step's loss with the cache differs from "
          "the explicit knobs'")
    check(_backend_launches_ok(plan.gemm_impl, runs["cache"]["launches"],
                               train=True)
          and runs["cache"]["plain_calls_on_cuda"] == 0,
          f"train launches {runs['cache']['launches']} do not match "
          f"{plan.gemm_impl}")
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        res = train.main(["--arch", ARCH + "-smoke", "--steps", "3",
                          "--batch", "4", "--seq", "64", "--plan-cache",
                          path, "--plan-hw", PLAN_HW, "--ckpt-dir", ckpt],
                         device="cuda")
    ls = [m["loss"] for m in res["metrics"]]
    rec["cli"] = {"losses": ls, "final_step": res["final_step"],
                  "skipped": [m["skipped"] for m in res["metrics"]],
                  "s": time.perf_counter() - t0}
    log("  launch/train.py --plan-cache (smoke): " + json.dumps(rec["cli"]))
    check(res["final_step"] == 3 and all(math.isfinite(v) for v in ls)
          and not any(rec["cli"]["skipped"]),
          f"launch/train.py --plan-cache: {rec['cli']}")


def plan_serve(rec, path):
    """(e) phase 3's engine (qwen2-moe-2.7b whole, bf16, 8 slots, max_seq
    1024, chunk 256) with the cache: 8 requests all ok; every prefill
    chunk's MoE layers run the cache's prefill plan and every decode
    step's its decode plan, with the launches of the kernels each names."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import adaptive as A
    from repro_torch.models import lm
    cfg = get_config(ARCH)
    params = lm.init_params(cfg, seed=0, device="cuda")
    plans = {ph: A.load_plan_cache(path).get(A.plan_shape(
        cfg.moe, cfg.d_model, PLAN_TOKENS[ph], 1, 1), A.H100_NVL, ph)
        for ph in ("prefill", "decode")}
    calls = []
    saved = {n: getattr(lm, n) for n in ("prefill_chunk", "decode_step")}

    def wrap(name, real):
        def f(*a, **kw):
            ran = []
            before = read_counts()
            with _moe_spy(ran):
                res = real(*a, **kw)
            calls.append((name, ran, _delta(read_counts(), before)))
            return res
        return f

    for n, real in saved.items():
        setattr(lm, n, wrap(n, real))
    try:
        _, srec = serve(cfg, params, 8, 32, 0, "serve", {},
                        engine_kw=dict(plan_cache=path, plan_hw=PLAN_HW))
    finally:
        for n, real in saved.items():
            setattr(lm, n, real)
    bad = []
    for name, ran, d in calls:
        plan = plans["prefill" if name == "prefill_chunk" else "decode"]
        knobs = {t[:4] for t in ran}
        if knobs != {(plan.impl, plan.ring_group, plan.n_col_blocks,
                      plan.gemm_impl)} or not _backend_launches_ok(
                plan.gemm_impl, d):
            bad.append((name, sorted(knobs), d))
    rec["serve"] = {"plans": {k: _plan_tag(v) for k, v in plans.items()},
                    "model_calls": len(calls), "mismatched_calls": bad[:4],
                    **{k: srec[k] for k in ("requests", "launches",
                                            "prefill_tok_s",
                                            "decode_ms_per_step", "wall_s")}}
    log("  serve with the cache: " + json.dumps(rec["serve"]))
    check(not bad, f"serve: {len(bad)} model calls ran other plans or "
          f"launches: {bad[:4]}")
    del params
    torch.cuda.empty_cache()


def phase_plan(state, out):
    import tempfile

    import torch
    state.clear()                     # earlier phases' weights and state
    torch.cuda.empty_cache()
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        plan_model_backed(rec, f"{tmp}/model.json")
        path = f"{tmp}/plans.json"
        plan_measured(rec, path)
        plan_layer_bits(rec, path)
        plan_train(rec, path)
        torch.cuda.empty_cache()
        plan_serve(rec, path)
    out["plan"] = rec


# ---------------------------------------------------------------------------
# phase 12: a hybrid model served at full width
# ---------------------------------------------------------------------------


def hybrid_cfg(dtype="bfloat16", chunk=0, gemm_impl="pallas_fused"):
    """jamba-v0.1-52b at one period (8 layers, the least depth the port's
    period stacking takes) and every published width; ``chunk`` sets the
    SSD chunk of a plain route (the model's is 256)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import period_of
    cfg = get_config(HYBRID_ARCH)
    cfg = with_gemm(dataclasses.replace(
        cfg, n_layers=period_of(cfg), param_dtype=dtype,
        compute_dtype=dtype), gemm_impl)
    if chunk:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=chunk))
    return cfg


def moe_serve_launches(cfg, ran):
    """(fused_mlp, topk_combine) launches of the MoE bodies in ``ran``
    (``_moe_spy`` records) at world 1 under pallas_fused: one fused_mlp a
    body (a comet arm's local forward and the decode broadcast run the
    expert MLP whole), and one topk_combine a body, or one a column block
    of the resolved plan where a comet arm streams the combine."""
    from repro_torch.core.transport import legalize_n_col
    width = cfg.moe.wire_dim or cfg.d_model
    comb = sum(legalize_n_col(width, n_col)
               if fc and impl in ("comet", "comet_hier") and S > 1 else 1
               for impl, _, n_col, _, _, fc, S in ran)
    return len(ran), comb


def phase_serve_hybrid(state, out):
    """jamba-v0.1-52b at one full-width period served through the MoE, SSD
    and rmsnorm kernels, then its teacher-forced logits against the plain
    versions: bf16 beside a second plain route, and fp32 once the bf16
    weights are freed (the phase fails where they do not fit)."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    state.clear()                     # earlier phases' weights and state
    torch.cuda.empty_cache()
    cfg = hybrid_cfg()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {HYBRID_ARCH}, {cfg.n_layers} layers: {n_params / 1e9:.2f} B "
        f"parameters in bf16 on the card, init "
        f"{time.perf_counter() - t0:.1f} s")
    ran = []
    eng, rec = serve(cfg, params, 16, 32, 0, "serve_hybrid", out,
                     moe_sink=ran, **HYBRID_SERVE)
    del eng                           # it holds the weights
    L, calls = rec["launches"], rec["model_calls"]
    n_calls = calls["prefill_chunk"] + calls["decode_step"]
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    n_ssm = sum(cfg.layer_kind(i) != "a" for i in range(cfg.n_layers))
    fused, comb = moe_serve_launches(cfg, ran)
    rec.update({"arch": HYBRID_ARCH, "n_layers": cfg.n_layers,
                "params_b": n_params / 1e9, "moe_bodies": len(ran),
                "moe_knobs": sorted({tuple(t[:4]) + (bool(t[5]),)
                                     for t in ran}),
                "expected": {"fused_mlp": fused, "topk_combine": comb,
                             "ssd_forward": n_ssm * calls["prefill_chunk"]}})
    log("  hybrid launches: " + json.dumps(
        {k: rec[k] for k in ("moe_bodies", "moe_knobs", "expected")}))
    check(len(ran) == n_moe * n_calls,
          f"{len(ran)} MoE bodies, expected {n_moe} x {n_calls} calls")
    check(L["fused_mlp"] == fused == L["fused_mlp_hopper"],
          f"fused_mlp launches {L['fused_mlp']} (wgmma "
          f"{L['fused_mlp_hopper']}), expected {fused}")
    check(L["topk_combine"] == comb,
          f"topk_combine launches {L['topk_combine']}, expected {comb}")
    check(L["ssd_forward"] == n_ssm * calls["prefill_chunk"]
          == L["ssd_forward_hopper"],
          f"ssd_forward launches {L['ssd_forward']} (tensor-core "
          f"{L['ssd_forward_hopper']}), expected {n_ssm} x "
          f"{calls['prefill_chunk']} prefill_chunk calls")

    # teacher-forced logits (phase 4's rows): bf16 at the period beside a
    # second plain route (the xla backend, the SSD at chunk 64)
    rng = np.random.default_rng(1)
    plens = np.array([256, 200, 97, 160])
    toks = rng.integers(1, cfg.vocab_size, (4, 256))
    nxt = rng.integers(1, cfg.vocab_size, (4, 4))

    def run(c, p, plain=False):
        with plain_ops() if plain else contextlib.nullcontext():
            return teacher_forced_logits(c, p, toks, plens, nxt)

    plain = run(cfg, params, plain=True)
    reset_counts()
    bf16 = compare_logits(run(cfg, params), plain)
    counts = read_counts()
    floor = compare_logits(run(hybrid_cfg(chunk=64, gemm_impl="xla"),
                               params, plain=True), plain)
    del params, plain
    torch.cuda.empty_cache()
    # fp32 at the period: 4 bytes a parameter, drawn anew from the seed,
    # and the general fp32 kernels' scratch (4.7 GB at this prefill)
    c32 = hybrid_cfg("float32")
    need, free = 4 * n_params + 12e9, torch.cuda.mem_get_info()[0]
    check(need <= free, f"the fp32 logits need {need / 1e9:.1f} GB, "
                        f"{free / 1e9:.1f} GB free once the bf16 weights "
                        f"are freed")
    p32 = lm.init_params(c32, seed=0, device="cuda")
    fp32 = compare_logits(run(c32, p32), run(c32, p32, plain=True))
    del p32
    torch.cuda.empty_cache()
    logits = {"bf16_8_layers": bf16, "bf16_8_layers_xla_chunk64_vs_plain":
              floor, "fp32_8_layers": fp32, "bf16_launches": counts}
    out["serve_hybrid_logits"] = logits
    log("  " + json.dumps(logits))
    check(0 < counts["fused_mlp"] == counts["fused_mlp_hopper"] and
          0 < counts["ssd_forward"] == counts["ssd_forward_hopper"],
          f"bf16 logits: launches off the wgmma/tensor-core paths: {counts}")
    bound = max(TOL["bf16"], 3 * floor["rel_l2_err"])
    check(bf16["rel_l2_err"] <= bound,
          f"bf16 logits rel L2 error {bf16['rel_l2_err']:.3e} > {bound:.3e}")
    check(fp32["rel_l2_err"] <= TOL["fp32"],
          f"fp32 logits rel L2 error {fp32['rel_l2_err']:.3e} > 1e-4")
    check(fp32["argmax_agree"] >= 0.95,
          f"fp32 argmax agreement {fp32['argmax_agree']:.2f} < 0.95")


# ---------------------------------------------------------------------------
# phase 13: serving on a mesh
# ---------------------------------------------------------------------------


def split_kv_merge(rec):
    """The split-KV arm's arithmetic with no ranks: qwen2-moe-2.7b's decode
    shape (8 rows, 1024 positions, 16 heads of 128, bf16 cache) cut by
    hand into MESH_SERVE_SHARDS position shards, each reduced by
    decode_attention_partial at its offset, merged by
    merge_decode_partials: the fp32 merge against decode_attention's fp32
    arithmetic on the same inputs within 1e-5, the merge rounded to bf16
    against the bf16 decode_attention within 2e-2. The rows' positions
    leave some shards wholly past a row: those must give l = acc = 0."""
    import torch

    from repro_torch.models import attention as A
    B, S, H, hd, n = 8, 1024, 16, 128, MESH_SERVE_SHARDS
    gen = _gen(23)
    q, k, v = (_randn(shp, torch.bfloat16, 1.0, gen)
               for shp in ((B, 1, H, hd), (B, S, H, hd), (B, S, H, hd)))
    pos = torch.tensor([5, 130, 255, 256, 511, 700, 900, 1023],
                       device="cuda")
    Sl = S // n
    parts = [A.decode_attention_partial(q, k[:, i * Sl:(i + 1) * Sl],
                                        v[:, i * Sl:(i + 1) * Sl], pos,
                                        i * Sl) for i in range(n)]
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    got = A.merge_decode_partials(m, l, acc).transpose(1, 2)
    want = A.decode_attention(q.float(), k.float(), v.float(), pos)
    err32, ok32 = max_err(got, want, TOL["merge"])
    err, ok16 = max_err(got.to(q.dtype), A.decode_attention(q, k, v, pos),
                        TOL["bf16"])
    past = (torch.arange(n, device="cuda")[:, None] * Sl
            > pos[None, :])                                # (shard, row)
    empty_ok = bool((l[past] == 0).all() and (acc[past] == 0).all()
                    and torch.isfinite(m).all())
    rec["split_kv_merge"] = {"shape": [B, S, H, hd], "shards": n,
                             "fp32_max_abs_err": err32,
                             "fp32_within_tol": ok32,
                             "max_abs_err": err, "within_tol": ok16,
                             "empty_shard_rows": int(past.sum()),
                             "empty_shards_zero": empty_ok}
    log("  split-KV merge: " + json.dumps(rec["split_kv_merge"]))
    check(ok32 and ok16 and empty_ok, f"split-KV merge: fp32 max abs err "
          f"{err32:.3e} (tol {TOL['merge']}), bf16 {err:.3e} (tol "
          f"{TOL['bf16']}), empty shards zero: {empty_ok}")


def phase_mesh_serve(state, out):
    """Phase 3's engine on a (1, 1) mesh of a world-1 NCCL group
    (ServeEngine(mesh=)) and the mesh-less engine on the same weights and
    trace, in turns (mesh-less, mesh, mesh, mesh-less): 16/16 ok, the
    same token streams and launches per kernel on every run, the serving
    metrics of each; then the split-KV merge with no ranks."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.parallel.mesh import make_mesh
    state.clear()                     # earlier phases' weights and state
    torch.cuda.empty_cache()
    cfg = with_gemm(get_config(ARCH), "pallas_fused")
    params = lm.init_params(cfg, seed=0, device="cuda")
    runs, tokens = {}, {}
    with world1("nccl"):
        mesh = make_mesh((1, 1), ("data", "model"))
        for i, tag in enumerate(MESH_SERVE_TURNS):
            kw = {"mesh": mesh} if tag == "mesh" else None
            key = f"{tag}{i}"
            torch.cuda.empty_cache()
            eng, r = serve(cfg, params, 16, 32, 0, key, runs, engine_kw=kw)
            tokens[key] = [eng.finished[j].tokens
                           for j in sorted(eng.finished)]
            del eng
    del params
    torch.cuda.empty_cache()
    first = next(iter(runs))
    same = {k: sum(a == b for a, b in zip(v, tokens[first]))
            for k, v in tokens.items()}
    keys = ("ttft_p50_ms", "ttft_p99_ms", "prefill_tok_s",
            "decode_ms_per_step", "max_memory_allocated_gb", "cache_gb")

    def mean(tag, k):
        """The mean of ``k`` over the runs of one tag ("mesh" or
        "meshless"): a run's key is its tag and its turn's index."""
        vals = [r[k] for key, r in runs.items()
                if key.rstrip("0123456789") == tag]
        return sum(vals) / len(vals)

    rec = {"runs": runs, "compare": {
        "turns": list(runs), "identical_streams": same,
        "launches_equal": all(r["launches"] == runs[first]["launches"]
                              for r in runs.values()),
        "decode_ms_ratio": mean("mesh", "decode_ms_per_step")
        / mean("meshless", "decode_ms_per_step"),
        **{f"{key}_{k}": r[k] for key, r in runs.items() for k in keys}}}
    out["mesh_serve"] = rec
    log("  mesh (1, 1) vs mesh-less, in turns: " + json.dumps(rec["compare"]))
    L = runs[first]["launches"]
    check(all(n == 16 for n in same.values()),
          f"token streams identical to the first run's: {same}")
    check(rec["compare"]["launches_equal"],
          "launches differ: " + json.dumps({k: r["launches"]
                                            for k, r in runs.items()}))
    check(L["fused_mlp"] > 0 and L["fused_mlp"] == L["fused_mlp_hopper"]
          and L["topk_combine"] > 0 and L["rmsnorm"] > 0,
          f"launches off the kernels or the wgmma path: {L}")
    split_kv_merge(rec)


# ---------------------------------------------------------------------------
# phase 14: the paged KV cache on the serving path
# ---------------------------------------------------------------------------


def phase_serve_paged(state, out):
    """Phase 3's engine and trace with the paged cache (page 64): (a)
    exactness against the contiguous engine at no-drop capacity, 8 and 16
    slots on the 8-slot parity pool; (d) the paged engine on a (1, 1) NCCL
    mesh beside (a)'s; (b) contiguous and paged in turns at phase 3's
    capacity, 8 slots; (c) 16 slots on the 8-slot pool (equal cache
    memory). Every paged run drains to n_pages - 1 free pages."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.parallel.mesh import make_mesh
    state.clear()                     # earlier phases' weights and state
    torch.cuda.empty_cache()
    cfg = with_gemm(get_config(ARCH), "pallas_fused")
    moe = cfg.moe
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))
    params = lm.init_params(cfg, seed=0, device="cuda")
    pool = 8 * 1024 // PAGED_PAGE + 1            # the 8-slot parity pool
    runs, streams = {}, {}

    def run(key, c, batch=8, paged=True, **kw):
        if paged:
            kw.update(page_size=PAGED_PAGE, n_pages=pool)
        torch.cuda.empty_cache()
        eng, _ = serve(c, params, 16, 32, 0, key, runs, batch=batch,
                       engine_kw=kw, warm_up=not runs)
        streams[key] = [eng.finished[j].tokens for j in sorted(eng.finished)]
        del eng

    def same(a, b):
        return sum(x == y for x, y in zip(streams[a], streams[b]))

    with world1("nccl"):
        mesh = make_mesh((1, 1), ("data", "model"))
        run("nodrop_contiguous8", nodrop, paged=False)
        run("nodrop_paged8", nodrop)
        run("nodrop_contiguous16", nodrop, batch=16, paged=False)
        run("nodrop_paged16", nodrop, batch=16)
        run("nodrop_paged8_mesh", nodrop, mesh=mesh)
    for i, tag in enumerate(PAGED_TURNS):
        run(f"{tag}{i}", cfg, paged=tag == "paged")
    run("paged16_pool8", cfg, batch=16)
    del params
    torch.cuda.empty_cache()

    def mean(tag, k):
        vals = [runs[f"{t}{i}"][k] for i, t in enumerate(PAGED_TURNS)
                if t == tag]
        return sum(vals) / len(vals)

    keys = ("ttft_p50_ms", "ttft_p99_ms", "prefill_tok_s",
            "decode_ms_per_step", "decode_tok_s", "max_memory_allocated_gb",
            "cache_gb", "peak_live")
    turns = [f"{t}{i}" for i, t in enumerate(PAGED_TURNS)]
    rec = {"page_size": PAGED_PAGE, "n_pages": pool, "runs": runs,
           "compare": {
               "identical_nodrop_8": same("nodrop_contiguous8",
                                          "nodrop_paged8"),
               "identical_nodrop_16": same("nodrop_contiguous16",
                                           "nodrop_paged16"),
               "identical_mesh": same("nodrop_paged8", "nodrop_paged8_mesh"),
               "identical_turns": {k: same(turns[0], k) for k in turns},
               "identical_paged_turns": same(turns[1], turns[2]),
               "decode_ms_ratio": mean("paged", "decode_ms_per_step")
               / mean("contiguous", "decode_ms_per_step"),
               **{f"{key}_{k}": r[k] for key, r in runs.items()
                  for k in keys}}}
    out["serve_paged"] = rec
    log("  paged vs contiguous: " + json.dumps(rec["compare"]))
    c = rec["compare"]
    check(c["identical_nodrop_8"] == 16 and c["identical_nodrop_16"] == 16,
          f"no-drop streams identical to the contiguous engine's: 8 slots "
          f"{c['identical_nodrop_8']}, 16 slots {c['identical_nodrop_16']}")
    check(c["identical_mesh"] == 16 and runs["nodrop_paged8_mesh"][
        "launches"] == runs["nodrop_paged8"]["launches"],
          f"the (1, 1) mesh's streams ({c['identical_mesh']} of 16) or "
          f"launches differ from the paged engine's without a mesh")
    L = runs[turns[0]]["launches"]
    check(all(runs[k]["launches"] == L for k in turns),
          "launches differ between the turns: " + json.dumps(
              {k: runs[k]["launches"] for k in turns}))
    check(all(r["launches"]["fused_mlp"] > 0 and r["launches"]["fused_mlp"]
              == r["launches"]["fused_mlp_hopper"]
              and r["launches"]["topk_combine"] > 0 for r in runs.values()),
          "launches off the kernels or the wgmma path: " + json.dumps(
              {k: r["launches"] for k, r in runs.items()}))
    check(runs["paged16_pool8"]["peak_live"] == 16
          and runs[turns[0]]["peak_live"] == 8,
          f"peak live requests {runs['paged16_pool8']['peak_live']} on the "
          f"8-slot pool at 16 slots (want 16), "
          f"{runs[turns[0]]['peak_live']} contiguous (want 8)")


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def lifecycle_run(cfg, params, key, runs, prompts, max_new=32,
                  engine_kw=None, script=None):
    """One run of phase 15's engine (qwen2-moe-2.7b whole, 8 slots,
    max_seq 1024, chunk 256, the paged cache on the 8-slot parity pool):
    ``script(eng)`` submits and drives it (default: every prompt, then
    ``run``). Launch counters zeroed before and read after, the plain
    versions watched, the ``on_token`` emissions, the snapshots' and
    restores' times and bytes, the replayed steps, TTFT and peak memory
    recorded into ``runs[key]``; returns the engine."""
    import numpy as np
    import torch

    from repro_torch.serving import ServeEngine
    emissions, snaps, restores, replayed = [], [], [], [0]
    eng = ServeEngine(cfg, params=params, max_seq=1024, batch_size=8,
                      chunk=256, device="cuda", page_size=PAGED_PAGE,
                      n_pages=LIFECYCLE_POOL,
                      on_token=lambda *e: emissions.append(e),
                      **(engine_kw or {}))
    real_snap, real_restore, real_recover = (eng.snapshot, eng.restore,
                                             eng._recover)

    def snapshot():
        t0 = time.perf_counter()
        real_snap()
        snaps.append((time.perf_counter() - t0,
                      _dir_bytes(Path(eng.ckpt.dir)
                                 / f"step_{eng.step_idx:08d}")))

    def restore(step=None):
        t0 = time.perf_counter()
        real_restore(step)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)

    def recover(error):
        have = eng.ckpt.latest_step() if eng.ckpt is not None else None
        replayed[0] += eng.step_idx - 1 - (have or 0)
        real_recover(error)

    eng.snapshot, eng.restore, eng._recover = snapshot, restore, recover
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with PlainGuard() as guard, count_model_calls({}) as calls:
        t0 = time.perf_counter()
        if script is None:
            rids = [eng.submit(p, max_new=max_new) for p in prompts]
            eng.run()
        else:
            rids = script(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the wrappers hold the engine: a cycle
    del eng.snapshot, eng.restore, eng._recover
    counts = read_counts()
    reqs = {rid: eng.finished[rid] for rid in rids
            if rid in eng.finished}
    ttft = [r.ttft_s * 1e3 for r in reqs.values() if r.first_token_t > 0]
    rec = {"wall_s": wall, "steps": eng.step_idx,
           "ttft_p50_ms": float(np.percentile(ttft, 50)) if ttft else None,
           "ttft_p99_ms": float(np.percentile(ttft, 99)) if ttft else None,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
           / 1e9, "decode_steps": eng.decode_steps,
           "decode_ms_per_step": eng.decode_s / max(eng.decode_steps, 1)
           * 1e3, "prefill_s": eng.prefill_s, "admit_rounds":
           eng.admit_rounds, "launches": counts, "model_calls": calls,
           "plain_calls_on_cuda": guard.cuda_calls,
           "failures": eng.failures, "recoveries": eng.recoveries,
           "quarantined": eng.quarantined, "expired": eng.expired,
           "shed": eng.shed, "statuses": {
               st: sum(r.status.value == st for r in reqs.values())
               for st in sorted({r.status.value for r in reqs.values()})},
           "emissions": len(emissions), "replayed_steps": replayed[0],
           "snapshots": len(snaps),
           "snapshot_ms": [t * 1e3 for t, _ in snaps],
           "snapshot_bytes": [b for _, b in snaps],
           "restore_ms": [t * 1e3 for t in restores],
           "straggler_steps": list(eng.monitor.flagged)}
    if eng.faults is not None:
        rec["injected"] = dict(eng.faults.counts)
        rec["injected_events"] = [[int(t), e] for t, e in eng.faults.events]
        eng.faults.release_all(eng)
    rec["free_pages"] = eng.free_pages
    runs[key] = rec
    log(f"  {key}: " + json.dumps({k: v for k, v in rec.items()
                                   if k != "injected_events"}))
    check(guard.cuda_calls == 0,
          f"{key}: plain versions saw CUDA tensors {guard.cuda_calls} times")
    check(counts["fused_mlp"] > 0 and counts["topk_combine"] > 0
          and counts["fused_mlp"] == counts["fused_mlp_hopper"],
          f"{key}: launches off the kernels or the wgmma path: {counts}")
    check(all(r.done for r in reqs.values()) and not eng.pending,
          f"{key}: requests not terminal: "
          f"{[r.rid for r in reqs.values() if not r.done]}")
    check(eng.free_pages == eng.n_pages - 1,
          f"{key}: {eng.free_pages} pages free, not {eng.n_pages - 1}")
    return eng, reqs, emissions


def phase_serve_lifecycle(state, out):
    """The serving lifecycle on phase 3's engine and trace (qwen2-moe-2.7b
    whole, bf16, seed 0, pallas_fused, max_seq 1024, chunk 256, 8 slots,
    16 requests of 64-512 prompt tokens, max_new 32) with the paged cache
    (page 64, 129 pages) at no-drop capacity. (a) fault-free; (b) a fault
    plan with snapshots every 8 steps: two crashes, one before and one
    after the first snapshot, a poisoned row, a page squeeze and a 50 ms
    latency spike; (c) cancels, a bounded queue under "deadline"
    shedding, 1 ms TTFT deadlines behind 8 live requests; (d) the serve
    CLI with --chaos 0.02 and snapshots."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import lm
    from repro_torch.serving import FaultInjector, FaultPlan, ServeEngine
    state.clear()                     # earlier phases' weights and state
    torch.cuda.empty_cache()
    cfg = with_gemm(get_config(ARCH), "pallas_fused")
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompts = make_trace(cfg.vocab_size, 16, 64, 512, 0)
    # warm-up on an engine of its own: (a)'s wall time is a warm server's
    warm = ServeEngine(cfg, params=params, max_seq=1024, batch_size=8,
                       chunk=256, device="cuda", page_size=PAGED_PAGE,
                       n_pages=LIFECYCLE_POOL)
    for p in make_trace(cfg.vocab_size, 8, 64, 512, 100):
        warm.submit(p, max_new=2)
    warm.run()
    del warm
    runs = {}
    tmp = tempfile.mkdtemp(prefix="serve_lifecycle_")
    try:
        # (a) fault-free
        _, ref, _ = lifecycle_run(cfg, params, "fault_free", runs, prompts)
        want = {rid: r.tokens for rid, r in ref.items()}
        check(all(r.status.value == "ok" and len(r.tokens) == 32
                  for r in ref.values()),
              "fault-free: requests not ok with 32 tokens")
        # (b) injected faults
        plan = FaultPlan(crash_steps=LIFECYCLE_CRASHES,
                         nan_rows={LIFECYCLE_NAN_STEP: 1},
                         page_squeeze={LIFECYCLE_SQUEEZE[0]:
                                       LIFECYCLE_SQUEEZE[1:]},
                         latency_s={LIFECYCLE_SPIKE_STEP: 0.05})
        inj = FaultInjector(plan)
        eng, got, emissions = lifecycle_run(
            cfg, params, "faults", runs, prompts, engine_kw=dict(
                snapshot_dir=f"{tmp}/b", snapshot_every=8, faults=inj,
                straggler_factor=LIFECYCLE_STRAGGLER))
        rb = runs["faults"]
        seen = {}
        for rid, idx, tok in emissions:
            check((rid, idx) not in seen, f"duplicate emission {rid, idx}")
            seen[rid, idx] = tok
        bad = ([] if len(seen) == sum(len(r.tokens) for r in got.values())
               else [("emitted", len(seen))])
        for rid, r in got.items():
            if [seen.get((rid, i)) for i in range(len(r.tokens))] != \
                    r.tokens:
                bad.append(("emitted", rid))
            if r.status.value == "ok" and r.tokens != want[rid]:
                bad.append(("ok stream", rid))
            if r.status.value == "quarantined" and \
                    r.tokens != want[rid][:len(r.tokens)]:
                bad.append(("quarantined prefix", rid))
        quarantined = [rid for rid, r in got.items()
                       if r.status.value == "quarantined"]
        rb.update(quarantined=len(quarantined),
                  identical_ok=sum(r.tokens == want[rid]
                                   for rid, r in got.items()
                                   if r.status.value == "ok"),
                  wall_over_fault_free=rb["wall_s"]
                  / runs["fault_free"]["wall_s"])
        check(not bad, f"faults: streams or emissions wrong: {bad}")
        check(set(got) == set(ref) and len(quarantined) == 1
              and rb["statuses"].get("ok") == len(ref) - 1,
              f"faults: statuses {rb['statuses']} (want 15 ok and 1 "
              f"quarantined)")
        check(rb["failures"] == rb["recoveries"] == inj.counts["crash"]
              == len(LIFECYCLE_CRASHES),
              f"faults: failures {rb['failures']}, recoveries "
              f"{rb['recoveries']}, injected crashes {inj.counts['crash']}")
        check(inj.counts["page_squeeze"] == 1 and inj.counts["latency"] == 1,
              f"faults: injected {inj.counts}")
        check(LIFECYCLE_SPIKE_STEP in rb["straggler_steps"],
              f"faults: the spike's step {LIFECYCLE_SPIKE_STEP} not flagged "
              f"(flagged {rb['straggler_steps']})")
        check(rb["snapshots"] > 0 and len(rb["restore_ms"]) == 1,
              f"faults: {rb['snapshots']} snapshots, "
              f"{len(rb['restore_ms'])} restores (want 1: the first "
              f"crash precedes every snapshot)")
        del eng, got
        shutil.rmtree(f"{tmp}/b", ignore_errors=True)

        def same_as_a(key, got):
            """Records which ok streams differ from (a)'s: a request's
            bits must not depend on the stack it was admitted in."""
            runs[key]["ok_streams_unlike_a"] = sorted(
                rid for rid, r in got.items()
                if r.status.value == "ok" and r.tokens != want[rid])

        # (b') a row poisoned in the first wave: a later request is
        # admitted in a stack of its own, its stream still (a)'s
        stacks = []

        def first_wave(eng):
            real = eng._admit_batch

            def admit(pairs):
                stacks.append(len(pairs))
                return real(pairs)

            eng._admit_batch = admit
            rids = [eng.submit(p, max_new=32) for p in prompts]
            eng.run()
            del eng._admit_batch
            return rids

        inj = FaultInjector(FaultPlan(
            nan_rows={LIFECYCLE_EARLY_NAN_STEP: 1}))
        _, got, _ = lifecycle_run(cfg, params, "faults_first_wave", runs,
                                  prompts, engine_kw=dict(faults=inj),
                                  script=first_wave)
        same_as_a("faults_first_wave", got)
        rw = runs["faults_first_wave"]
        rw["admission_stacks"] = stacks
        check(rw["statuses"] == {"ok": 15, "quarantined": 1}
              and 1 in stacks and inj.counts["nan"] == 1,
              f"first wave: statuses {rw['statuses']}, admission stacks "
              f"{stacks} (want a lone admission), injected {inj.counts}")
        check(not rw["ok_streams_unlike_a"]
              and all(r.tokens == want[rid][:len(r.tokens)]
                      for rid, r in got.items()),
              f"first wave: ok streams unlike (a)'s "
              f"{rw['ok_streams_unlike_a']}")
        del got

        # (c) the lifecycle without faults
        def cancels(eng):
            rids = [eng.submit(p, max_new=32) for p in prompts]
            check(eng.cancel(rids[12]), "queued cancel refused")
            eng.step()                    # rids[0] takes slot 0
            first = eng.slot_req[0]
            check(first is not None and first.rid == rids[0],
                  "rids[0] not live in slot 0")
            while len(first.tokens) < 4:  # one token a step
                eng.step()
            check(len(first.tokens) == 4 and eng.cancel(rids[0]),
                  "live cancel after the 4th token refused")
            eng.run()
            return rids

        _, got, _ = lifecycle_run(cfg, params, "cancel", runs, prompts,
                                  script=cancels)
        same_as_a("cancel", got)
        rids = sorted(got)
        check(got[rids[0]].status.value == "cancelled"
              and got[rids[0]].tokens == want[rids[0]][:4]
              and got[rids[12]].status.value == "cancelled"
              and got[rids[12]].tokens == []
              and all(got[r].status.value == "ok"
                      and len(got[r].tokens) == 32 for r in rids
                      if r not in (rids[0], rids[12]))
              and not runs["cancel"]["ok_streams_unlike_a"],
              f"cancel: statuses {runs['cancel']['statuses']}, streams "
              f"unlike (a)'s {runs['cancel']['ok_streams_unlike_a']}")

        def burst(eng):
            rids, rejected = [], 0
            for i, p in enumerate(prompts):
                try:
                    rids.append(eng.submit(p, max_new=32, deadline_s=(
                        None if i % 4 == 0 else 100.0 + 10 * i)))
                except Exception as e:        # counted, then checked
                    if type(e).__name__ != "RejectedRequest":
                        raise
                    rejected += 1
                check(len(eng.queue) <= 4, "queue above max_queue")
            eng.run()
            runs_burst["rejected"] = rejected
            return rids

        runs_burst = {}
        eng, got, _ = lifecycle_run(
            cfg, params, "shed", runs, prompts, script=burst,
            engine_kw=dict(max_queue=4, shed_policy="deadline"))
        rs = runs["shed"]
        rs["rejected"] = runs_burst["rejected"]
        same_as_a("shed", got)
        ok = [rid for rid, r in got.items() if r.status.value == "ok"]
        check(rs["shed"] > 0 and rs["shed"] + rs["rejected"] + len(ok)
              == len(prompts) and all(len(got[r].tokens) == 32 for r in ok)
              and rs["statuses"].get("expired", 0) == rs["shed"]
              and not rs["ok_streams_unlike_a"],
              f"shed: {rs['shed']} shed, {rs['rejected']} rejected, "
              f"statuses {rs['statuses']}, streams unlike (a)'s "
              f"{rs['ok_streams_unlike_a']}")
        del eng

        def ttft(eng):
            rids = [eng.submit(p, max_new=32) for p in prompts[:8]]
            eng.step()
            check(int(eng.live.sum()) == 8, "8 live requests")
            rids += [eng.submit(p, max_new=32, ttft_deadline_s=0.001)
                     for p in prompts[8:12]]
            eng.run()
            return rids

        _, got, _ = lifecycle_run(cfg, params, "ttft", runs, prompts,
                                  script=ttft)
        same_as_a("ttft", got)
        rids = sorted(got)
        check(all(got[r].status.value == "expired" and "ttft" in
                  got[r].error and not got[r].tokens for r in rids[8:])
              and not runs["ttft"]["ok_streams_unlike_a"]
              and runs["ttft"]["expired"] == 4,
              f"ttft: statuses {runs['ttft']['statuses']}")
        del params
        torch.cuda.empty_cache()

        # (d) the CLI with chaos and snapshots, its own weights
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli = serve_cli.main(["--arch", ARCH, "--page-size", "64",
                                  "--pages", str(LIFECYCLE_POOL),
                                  "--chaos", "0.02",
                                  "--snapshot-dir", f"{tmp}/d"],
                                 device="cuda")
        text = buf.getvalue()
        summary = [line for line in text.splitlines()
                   if not line.startswith("req")]
        runs["cli"] = {
            "summary": summary, "failures": cli.failures,
            "recoveries": cli.recoveries,
            "injected": dict(cli.faults.counts),
            "statuses": {st: sum(r.status.value == st
                                 for r in cli.finished.values())
                         for st in sorted({r.status.value for r in
                                           cli.finished.values()})}}
        log("  cli: " + json.dumps(runs["cli"]))
        check(len(cli.finished) == 16
              and all(r.done for r in cli.finished.values())
              and not cli.pending,
              f"cli: requests not terminal: {runs['cli']['statuses']}")
        check(any(line.startswith("robustness: statuses")
                  for line in summary)
              and any(line.startswith("chaos: ") for line in summary),
              "cli: the chaos plan's or the robustness summary missing")
        check(cli.failures == cli.recoveries == cli.faults.counts["crash"],
              f"cli: failures {cli.failures}, recoveries "
              f"{cli.recoveries}, injected {cli.faults.counts}")
        del cli
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["serve_lifecycle"] = {"page_size": PAGED_PAGE,
                              "n_pages": LIFECYCLE_POOL, "runs": runs}


def _kv_bytes(hand):
    return sum(t.numel() * t.element_size() for e in hand.kv
               for t in e.values())


def disagg_run(cfg, params, key, runs, prompts, ec_kw, max_new=32,
               faults=None):
    """One run of phase 16's router (``EngineConfig(disagg=True,
    **ec_kw).build``) on ``prompts``: launch counters zeroed before and
    read after, the plain versions watched, the ``on_token`` emissions,
    the ms of every export and migrate (synchronized on both sides), the
    bytes moved, the peak bytes of the handoffs the router holds, the
    tick of every migration and the router's summary recorded into
    ``runs[key]``; returns (router, requests, emissions)."""
    import numpy as np
    import torch

    from repro_torch.serving import EngineConfig
    emissions, exports, migrates, moved, ticks = [], [], [], [0], []
    held = [0]
    ec = EngineConfig(disagg=True, **ec_kw)
    router = ec.build(cfg, params=params, device="cuda", faults=faults,
                      on_token=lambda *e: emissions.append(e))

    def timed(w, name, sink):
        real = getattr(w, name)

        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = real(*a)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
            if name == "migrate" and got:
                moved[0] += _kv_bytes(a[0])
                ticks.append(router.step_idx)
            return got

        setattr(w, name, call)

    for w in router.prefills:
        timed(w, "export_handoff", exports)
    for w in router.decodes:
        timed(w, "migrate", migrates)
    real_step = router.step

    def step():
        more = real_step()
        held[0] = max(held[0], sum(_kv_bytes(h)
                                   for h in router.handoffs.values()))
        return more

    router.step = step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with PlainGuard() as guard, count_model_calls({}) as calls:
        t0 = time.perf_counter()
        rids = [router.submit(p, max_new=max_new) for p in prompts]
        router.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del router.step                  # the wrappers hold the router: a cycle
    for w in router.workers:
        w.__dict__.pop("export_handoff", None)
        w.__dict__.pop("migrate", None)
    counts = read_counts()
    reqs = {rid: router.finished[rid] for rid in rids}
    ttft = [r.ttft_s * 1e3 for r in reqs.values() if r.first_token_t > 0]
    dec = router.decodes[0]
    summary = router.summary()
    rec = {"wall_s": wall, "ticks": router.step_idx,
           "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p99_ms": float(np.percentile(ttft, 99)),
           "decode_ms_per_step": dec.decode_s / max(dec.decode_steps, 1)
           * 1e3, "decode_steps": dec.decode_steps,
           "export_ms": exports, "migrate_ms": migrates,
           "export_ms_median": float(np.median(exports)),
           "migrate_ms_median": float(np.median(migrates)),
           "bytes_moved": moved[0], "held_handoff_peak_bytes": held[0],
           "migration_ticks": ticks,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated()
           / 1e9, "pools_gb": {f"{n}{i}": sum(
               t.numel() * t.element_size() for e in w.cache
               for t in e.values()) / 1e9 for n, ws in (
               ("prefill", router.prefills), ("decode", router.decodes))
               for i, w in enumerate(ws)},
           "launches": counts, "model_calls": calls,
           "plain_calls_on_cuda": guard.cuda_calls,
           "emissions": len(emissions),
           "statuses": {st: sum(r.status.value == st for r in reqs.values())
                        for st in sorted({r.status.value
                                          for r in reqs.values()})},
           "decode_worker_prefill_tokens": sum(w.prefill_tokens
                                               for w in router.decodes),
           "summary": {k: v for k, v in summary.items()}}
    if faults is not None:
        rec["injected"] = {f"{t[0]}{t[1]}": dict(i.counts)
                           for t, i in faults.items()}
    runs[key] = rec
    log(f"  {key}: " + json.dumps({k: v for k, v in rec.items()
                                   if k not in ("export_ms", "migrate_ms")}))
    check(guard.cuda_calls == 0,
          f"{key}: plain versions saw CUDA tensors {guard.cuda_calls} times")
    check(all(r.done for r in reqs.values()) and not router.pending,
          f"{key}: requests not terminal")
    check(all(w.free_pages == w.n_pages - 1 for w in router.workers),
          f"{key}: pages not all free after the drain")
    return router, reqs, emissions


def _once(emissions, reqs):
    """Every (rid, idx) emitted exactly once, with the request's token."""
    seen = {}
    for rid, idx, tok in emissions:
        check((rid, idx) not in seen, f"duplicate emission {rid, idx}")
        seen[rid, idx] = tok
    for rid, r in reqs.items():
        check([seen.get((rid, i)) for i in range(len(r.tokens))]
              == r.tokens, f"emissions of {rid} differ from its stream")
    check(len(seen) == sum(len(r.tokens) for r in reqs.values()),
          "emissions beyond the streams")


DISAGG_EC = dict(max_seq=1024, chunk=256, page_size=PAGED_PAGE,
                 prefill_slots=4, decode_slots=8, n_pages=LIFECYCLE_POOL)
DISAGG_TURNS = ("shared", "router", "router", "shared")
DISAGG_PREFILL_CRASH = 3
# phase 16's qwen2-moe-2.7b depth (a, b, c): 4 of 24 layers at every
# published width, so the twenty phases stay within half the contract's
# 1200 s (the snapshots of the crash runs scale with the layers); the CLI
# (e) serves the whole model
DISAGG_LAYERS = 4
DISAGG_SSM_REQUESTS = 8


def phase_serve_disagg(state, out):
    """Disaggregated serving on phase 3's model and trace (qwen2-moe-2.7b
    at DISAGG_LAYERS of its 24 layers and every published width, bf16,
    seed 0, pallas_fused, no-drop capacity, max_seq 1024,
    chunk 256, page 64; 16 requests of 64-512 prompt tokens, max_new 32):
    (a) the shared paged engine at 8 slots (129 pages) and (b) the router,
    1 prefill worker of 4 slots and 1 decode worker of 8 slots (129 pages)
    sharing one parameter set, in turns (shared, router, router, shared):
    16/16 ok, the router's streams (a)'s, 16 migrations, the pages moved
    the prompts' pages, no prefill on the decode worker, every fused_mlp
    launch on the wgmma path; TTFT, decode ms a step, export and migrate
    ms, bytes moved, the held handoffs' peak bytes, peak memory and
    launches recorded. (c) Snapshots every 4 steps: a decode-worker crash
    at the tick of the second wave's first migration (its rid then
    re-migrates from the held handoff) and a prefill-worker crash before
    the first snapshot, in two runs: (a)'s streams, failures ==
    recoveries == injected, every (rid, idx) emitted once. (d) mamba2-780m
    whole, 8 requests, the router against its shared paged engine: the
    same streams, every ssd_forward launch on the tensor-core path. (e)
    ``launch.serve --disagg --page-size 64 --prefill-workers 1
    --decode-workers 1`` (the mixed trace): every request terminal, the
    router's summary printed."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import lm
    from repro_torch.serving import (FaultInjector, FaultPlan, ServeEngine,
                                     pages_for)
    state.clear()                     # earlier phases' weights and state
    torch.cuda.empty_cache()
    cfg = with_gemm(get_config(ARCH), "pallas_fused")
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, n_layers=DISAGG_LAYERS,
                              moe=dataclasses.replace(
                                  moe, capacity_factor=moe.num_experts
                                  / moe.top_k))
    params = lm.init_params(cfg, seed=0, device="cuda")
    prompts = make_trace(cfg.vocab_size, 16, 64, 512, 0)
    warm = ServeEngine(cfg, params=params, max_seq=1024, batch_size=8,
                       chunk=256, device="cuda", page_size=PAGED_PAGE,
                       n_pages=LIFECYCLE_POOL)
    for p in make_trace(cfg.vocab_size, 8, 64, 512, 100):
        warm.submit(p, max_new=2)
    warm.run()
    del warm
    runs, streams = {}, {}
    rec = {"runs": runs, "layers": DISAGG_LAYERS}
    for i, tag in enumerate(DISAGG_TURNS):
        key = f"{tag}{i}"
        torch.cuda.empty_cache()
        if tag == "shared":
            _, got, _ = lifecycle_run(cfg, params, key, runs, prompts)
        else:
            _, got, em = disagg_run(cfg, params, key, runs, prompts,
                                    DISAGG_EC)
            _once(em, got)
        streams[key] = {rid: r.tokens for rid, r in got.items()}
        check(all(r.status.value == "ok" and len(r.tokens) == 32
                  for r in got.values()), f"{key}: requests not ok")
    want = streams["shared0"]
    pages = sum(pages_for(len(p), PAGED_PAGE) for p in prompts)
    for key in ("router1", "router2"):
        r = runs[key]
        s = r["summary"]
        check(streams[key] == want,
              f"{key}: streams unlike the shared engine's: "
              f"{sorted(k for k in want if streams[key][k] != want[k])}")
        check(s["migrations"] == 16 and s["pages_moved"] == pages
              and r["decode_worker_prefill_tokens"] == 0,
              f"{key}: migrations {s['migrations']}, pages moved "
              f"{s['pages_moved']} (want 16, {pages}), decode-worker "
              f"prefill tokens {r['decode_worker_prefill_tokens']}")
        L = r["launches"]
        check(L["fused_mlp"] > 0 and L["fused_mlp"] == L["fused_mlp_hopper"]
              and L["topk_combine"] > 0 and L["rmsnorm"] > 0,
              f"{key}: launches off the kernels or the wgmma path: {L}")
    check(streams["shared3"] == want, "the shared engine's turns differ")

    def mean(tag, k):
        vals = [runs[f"{t}{i}"][k] for i, t in enumerate(DISAGG_TURNS)
                if t == tag]
        return sum(vals) / len(vals)

    for k in ("ttft_p50_ms", "ttft_p99_ms", "decode_ms_per_step",
              "wall_s"):
        rec[k] = {tag: mean(tag, k) for tag in ("shared", "router")}
        rec[f"router_over_shared_{k}"] = mean("router", k) / mean("shared",
                                                                  k)
    rec["max_memory_allocated_gb"] = {
        tag: mean(tag, "max_memory_allocated_gb")
        for tag in ("shared", "router")}

    # (c) worker crashes with snapshots every 4 steps
    tmp = tempfile.mkdtemp(prefix="serve_disagg_")
    try:
        wave2 = runs["router1"]["migration_ticks"][8]
        for role, at in (("decode", wave2),
                         ("prefill", DISAGG_PREFILL_CRASH)):
            key = f"crash_{role}"
            ec_kw = dict(DISAGG_EC, snapshot_dir=f"{tmp}/{role}",
                         snapshot_every=4, recover=True)
            plan = FaultPlan(crash_workers={at: (role, 0)})
            inj = {t: FaultInjector(plan, role=t)
                   for t in (("prefill", 0), ("decode", 0))}
            torch.cuda.empty_cache()
            _, got, em = disagg_run(cfg, params, key, runs, prompts, ec_kw,
                                    faults=inj)
            _once(em, got)
            r = runs[key]
            s = r["summary"]
            r["crash_step"] = at
            injected = sum(i.counts["crash"] for i in inj.values())
            check({rid: q.tokens for rid, q in got.items()} == want,
                  f"{key}: streams unlike the shared engine's")
            check(s["failures"] == s["recoveries"] == injected == 1,
                  f"{key}: failures {s['failures']}, recoveries "
                  f"{s['recoveries']}, injected {injected}")
            shutil.rmtree(f"{tmp}/{role}", ignore_errors=True)
        check(runs["crash_decode"]["summary"]["remigrations"] > 0,
              "the decode-worker crash re-migrated nothing")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    torch.cuda.empty_cache()

    # (d) the SSM carry: mamba2-780m whole, router 1x1 against its shared
    # paged engine
    scfg = get_config(SSM_ARCH)
    sparams = lm.init_params(scfg, seed=0, device="cuda")
    sprompts = make_trace(scfg.vocab_size, DISAGG_SSM_REQUESTS, 64, 1024, 0)
    skw = dict(max_seq=2048, chunk=256, page_size=PAGED_PAGE)
    shared = ServeEngine(scfg, params=sparams, batch_size=8, device="cuda",
                         **skw)
    rids = [shared.submit(p, max_new=32) for p in sprompts]
    shared.run()
    want_ssm = {rid: shared.finished[rid].tokens for rid in rids}
    del shared
    _, got, em = disagg_run(scfg, sparams, "ssm_router", runs, sprompts,
                            dict(skw, prefill_slots=4, decode_slots=8))
    _once(em, got)
    L = runs["ssm_router"]["launches"]
    check({rid: q.tokens for rid, q in got.items()} == want_ssm,
          "ssm: the router's streams unlike the shared engine's")
    check(runs["ssm_router"]["summary"]["migrations"] == DISAGG_SSM_REQUESTS
          and L["ssd_forward"] > 0
          and L["ssd_forward"] == L["ssd_forward_hopper"],
          f"ssm: migrations {runs['ssm_router']['summary']['migrations']}, "
          f"launches {L}")
    del sparams, got
    torch.cuda.empty_cache()

    # (e) the CLI, its own weights (phase 3's capacity)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli = serve_cli.main(["--arch", ARCH, "--disagg", "--page-size",
                              str(PAGED_PAGE), "--prefill-workers", "1",
                              "--decode-workers", "1"], device="cuda")
    text = buf.getvalue()
    summary = [line for line in text.splitlines()
               if not line.startswith("req")]
    runs["cli"] = {"summary_lines": summary, "summary": cli.summary(),
                   "statuses": {st: sum(r.status.value == st
                                        for r in cli.finished.values())
                                for st in sorted({r.status.value for r in
                                                  cli.finished.values()})}}
    log("  cli: " + json.dumps(runs["cli"]))
    check(len(cli.finished) == 16
          and all(r.done for r in cli.finished.values())
          and not cli.pending, f"cli: requests not terminal: "
          f"{runs['cli']['statuses']}")
    check(any(line.startswith("migration: ") for line in summary)
          and any(line.startswith("disagg: ") for line in summary),
          "cli: the router's summary missing")
    del cli
    torch.cuda.empty_cache()
    out["serve_disagg"] = rec


STACK_SIZES = (1, 2, 4, 8)
STACK_DECODE_SLOTS = (4, 8, 16)


class _OpTap:
    """While active, records the outputs of the prefill chunk's ops for
    one admission row (``row`` of a stack of ``rows``, chunk ``C``): the
    norms, the q/k/v projections, the attention, the residual after the
    output projection, the router's fp32 product, the MoE and shared-expert
    outputs, each layer's output and the logits, in call order as (op,
    layer, tensor) on the card."""

    def __init__(self, row, rows, C):
        self.row, self.rows, self.C = row, rows, C
        self.records, self.layer, self.saved = [], -1, []

    def _take(self, t):
        if isinstance(t, (tuple, list)):
            return [self._take(u) for u in t]
        if t.dim() == 0:
            return t.detach().clone()
        if t.shape[0] == self.rows:
            return t[self.row].detach().clone()
        if t.shape[0] == self.rows * self.C:
            return t[self.row * self.C:(self.row + 1) * self.C] \
                .detach().clone()
        return t.detach().clone()

    def _wrap(self, mod, name, op, first_arg=None, outs=None):
        """``outs``: how many leading outputs to record (the router's and
        the MoE's aux loss is over the whole stack)."""
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            if op == "layer":
                self.layer += 1
            if first_arg is not None:
                self.records.append((first_arg[0], self.layer,
                                     self._take(a[first_arg[1]])))
            got = real(*a, **kw)
            if op is not None:
                self.records.append((op, self.layer, self._take(
                    got if outs is None else got[:outs])))
            return got

        setattr(mod, name, wrapped)
        self.saved.append((mod, name, real))

    def __enter__(self):
        from repro_torch.core import routing
        from repro_torch.models import attention, blocks, lm
        self._wrap(blocks, "chunk_layer", "layer")
        self._wrap(blocks, "apply_norm", "norm")
        self._wrap(blocks, "_qkv_proj", "qkv")
        self._wrap(attention, "attention", "attention")
        # the residual after the output projection (o @ wo) enters the tail
        self._wrap(blocks, "_mlp_tail", None, first_arg=("x+o@wo", 2))
        self._wrap(routing, "router", "router", outs=2)
        self._wrap(blocks, "moe_ffn", "moe", outs=1)
        self._wrap(blocks, "ffn_apply", "shared_ffn")
        self._wrap(lm, "_serve_logits", "logits")
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self.saved):
            setattr(mod, name, real)


def _same(a, b):
    import torch
    if isinstance(a, (list, tuple)):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(a, b)


def _first_diff(base, got):
    """The first record of ``got`` whose bits differ from ``base``'s, as
    [op, layer, index], and how many records differ."""
    first, n = None, 0
    for i, ((op, layer, t), (_, _, u)) in enumerate(zip(base, got)):
        if not _same(t, u):
            n += 1
            if first is None:
                first = [op, layer, i]
    return first, n


def _row_invariant(fn, mk_rest, x0, counts):
    """Whether fn's output rows for the fixed leading rows x0 have the
    same bits whatever the rows that follow: fn(cat(x0, mk_rest(n))) for
    each n in counts, its first x0.shape[0] rows against n = counts[0]'s."""
    import torch
    base, same = None, {}
    for n in counts:
        x = torch.cat([x0, mk_rest(n)]) if n else x0
        y = fn(x)[:x0.shape[0]]
        if base is None:
            base = y
        same[str(x0.shape[0] + n)] = bool(torch.equal(y, base))
    return same


def stack_ops(cfg, params, C, gen):
    """Each product of the prefill path (layer 0's weights, bf16) and the
    fp32 router and LM head, at the row counts a stack of 1-8 admission
    rows gives them: does the first request's result keep its bits?"""
    import torch

    from repro_torch.core.moe_layer import moe_ffn
    from repro_torch.core.routing import router_logits
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import lm
    d = cfg.d_model
    lp = lm._period(params["layers"][0], 0)
    dt = lp["attn"]["wq"].dtype

    def rnd(*s, dtype=dt):
        return torch.randn(*s, generator=gen, device="cuda").to(dtype)

    x0 = rnd(C, d)
    rest = [n * C for n in STACK_SIZES]
    rest = [r - C for r in rest]
    res = {}
    for name in ("wq", "wk", "wv", "wo"):
        w = lp["attn"][name]
        res[name] = _row_invariant(lambda x, w=w: x @ w,
                                   lambda n: rnd(n, d), x0, rest)
        res[name + " bmm over the stack"] = _row_invariant(
            lambda x, w=w: torch.bmm(x.reshape(-1, C, d),
                                     w.expand(x.shape[0] // C, *w.shape))
            .reshape(x.shape[0], -1),
            lambda n: rnd(n, d), x0, rest)
        res[name + " grouped_gemm kernel"] = _row_invariant(
            lambda x, w=w: ops.grouped_gemm(x[None], w[None].contiguous())[0],
            lambda n: rnd(n, d), x0, rest)
    sh = lp["moe"].get("shared")
    if sh is not None:
        for name in ("w_gate", "w_up", "w_down"):
            w = sh[name]
            x0s = rnd(C, w.shape[0])
            res["shared " + name] = _row_invariant(
                lambda x, w=w: x @ w, lambda n, k=w.shape[0]: rnd(n, k),
                x0s, rest)
    wr = lp["moe"]["router"]
    res["router fp32"] = _row_invariant(
        lambda x: x.float() @ wr.float(), lambda n: rnd(n, d), x0, rest)
    head = lm.output_head(cfg, params).float()
    res["lm head fp32"] = _row_invariant(
        lambda x: x.float() @ head, lambda n: rnd(n, d), rnd(1, d),
        [n - 1 for n in STACK_SIZES])
    res["lm head fp32, one product per row"] = _row_invariant(
        lambda x: lm._logits(cfg, params, x, per_row=True),
        lambda n: rnd(n, d), rnd(1, d), [n - 1 for n in STACK_SIZES])
    res["router fp32, one product per 256-row sequence"] = _row_invariant(
        lambda x: router_logits(x, wr, seq_len=C), lambda n: rnd(n, d), x0,
        rest)
    mcfg = cfg.moe
    res["moe_ffn, 256-row sequences"] = _row_invariant(
        lambda x: moe_ffn(cfg, mcfg, lp["moe"], x.reshape(-1, C, d),
                          n_col=mcfg.n_col_blocks)[0].reshape(-1, d),
        lambda n: rnd(n, d), x0, rest)
    res["rmsnorm kernel"] = _row_invariant(
        lambda x: ops.rms_norm(x, lp["ln1"]["scale"], cfg.norm_eps),
        lambda n: rnd(n, d), x0, rest)
    a = cfg.attn
    S = 1024
    q0 = rnd(1, C, a.n_heads, a.head_dim)
    k0 = rnd(1, S, a.n_kv_heads, a.head_dim)
    v0 = rnd(1, S, a.n_kv_heads, a.head_dim)

    def attn(q):
        n = q.shape[0]
        k = torch.cat([k0, rnd(n - 1, S, a.n_kv_heads, a.head_dim)]) \
            if n > 1 else k0
        v = torch.cat([v0, rnd(n - 1, S, a.n_kv_heads, a.head_dim)]) \
            if n > 1 else v0
        q_pos = torch.arange(C, device="cuda")[None].expand(n, C) + 256
        kv_pos = torch.arange(S, device="cuda")[None].expand(n, S)
        return A.attention(q, k, v, q_pos, kv_pos, q_block=a.q_block,
                           kv_block=a.kv_block)

    res["attention"] = _row_invariant(
        attn, lambda n: rnd(n, C, a.n_heads, a.head_dim), q0,
        [n - 1 for n in STACK_SIZES])
    return res


def phase_stack_bits(state, out):
    """Whether a request's prefill bits depend on its stack, on the card:
    one qwen2-moe-2.7b request of 256 tokens (bf16, seed 0, pallas_fused,
    no-drop capacity) prefilled as one chunk alone in slot 0 and in slot
    5, and in stacks of 2, 4 and 8 at the first and at the last row, each
    op's output for its row recorded
    (``_OpTap``) and held against the lone slot-0 run's: the first op
    whose bits change, and the logits and next token. Then each product
    of the path in isolation at the stacks' row counts (``stack_ops``),
    and the decode step at 4, 8 and 16 slots with the same 4 live rows:
    the live rows' logits bits against 4 slots'."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    state.clear()
    torch.cuda.empty_cache()
    cfg = with_gemm(get_config(ARCH), "pallas_fused")
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))
    params = lm.init_params(cfg, seed=0, device="cuda")
    C, S = 256, 1024
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    prompts = torch.randint(1, cfg.vocab_size, (8, C), generator=gen,
                            device="cuda")
    cache = lm.init_cache(cfg, 8, S, "cuda")

    def prefill(rows, slots, pos):
        toks = prompts[rows]
        A_ = len(rows)
        with _OpTap(pos, A_, C) as tap:
            logits, _ = lm.prefill_chunk(
                cfg, params, cache, toks,
                torch.zeros(A_, dtype=torch.long, device="cuda"),
                torch.full((A_,), C, dtype=torch.long, device="cuda"),
                torch.tensor(slots, device="cuda"))
        torch.cuda.synchronize()
        return tap.records, logits[pos]

    runs = {}
    base, base_logits = prefill([0], [0], 0)
    cases = [("alone slot 5", [0], [5], 0)]
    for A_ in STACK_SIZES[1:]:
        others = list(range(1, A_))
        cases.append((f"stack {A_} first", [0] + others,
                      list(range(A_)), 0))
        cases.append((f"stack {A_} last", others + [0],
                      list(range(A_)), A_ - 1))
    for key, rows, slots, pos in cases:
        recs, logits = prefill(rows, slots, pos)
        first, n = _first_diff(base, recs)
        runs[key] = {"first_diff": first, "records_differing": n,
                     "records": len(recs),
                     "logits_identical": bool(torch.equal(logits,
                                                          base_logits)),
                     "logits_max_abs": float((logits - base_logits)
                                             .abs().max()),
                     "next_token_same": int(logits.argmax()) ==
                     int(base_logits.argmax())}
        log(f"  {key}: " + json.dumps(runs[key]))
    del base, recs
    ops_res = stack_ops(cfg, params, C, gen)
    log("  products alone: " + json.dumps(ops_res))

    # decode at 4, 8 and 16 slots: the same 4 live rows
    dec = {}
    ref = None
    for B in STACK_DECODE_SLOTS:
        c = lm.init_cache(cfg, B, S, "cuda")
        rows = [0, 1, 2, 3]
        lm.prefill_chunk(cfg, params, c, prompts[rows],
                         torch.zeros(4, dtype=torch.long, device="cuda"),
                         torch.full((4,), C, dtype=torch.long,
                                    device="cuda"),
                         torch.arange(4, device="cuda"))
        toks = torch.zeros((B, 1), dtype=torch.long, device="cuda")
        toks[:4, 0] = prompts[:4, -1]
        pos = torch.zeros((B,), dtype=torch.long, device="cuda")
        pos[:4] = C
        steps = []
        for _ in range(4):
            logits, _ = lm.decode_step(cfg, params, c, toks, pos)
            steps.append(logits[:4].clone())
            toks[:4, 0] = logits[:4].argmax(-1)
            pos[:4] += 1
        del c
        torch.cuda.synchronize()
        if ref is None:
            ref = steps
        dec[str(B)] = [bool(torch.equal(a, b)) for a, b in zip(steps, ref)]
    log("  decode, same live rows at 4/8/16 slots: " + json.dumps(dec))
    out["stack_bits"] = {"prefill": runs, "products": ops_res,
                         "decode_vs_4_slots": dec}
    del params, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 17: the train step through the block-schedule IR
# ---------------------------------------------------------------------------


# "" = phase 6's period-at-a-time step under remat; the other two run the
# layers unrolled through the IR, without remat
SCHED_MODES = ("", "sequential", "overlap")
SCHED_TURNS = 2


def sched_launches(L, remat):
    """The launches one fwd+bwd of phase 6's configuration makes per
    kernel: the forward's (twice under remat: its recompute), one dgrad
    and one wgrad per MoE layer, 2L+1 norms a forward; the head's (its
    chunks' own recompute under any schedule)."""
    f = 2 if remat else 1
    return {**head_launches(train_cfg(L, "bfloat16"), TRAIN_SEQ, 1),"fused_mlp": f * L, "fused_mlp_hopper": f * L,
            "topk_combine": f * L, "fused_mlp_dgrad": L,
            "fused_mlp_dgrad_hopper": L, "fused_mlp_wgrad": L,
            "fused_mlp_wgrad_hopper": L, "grouped_gemm": 0,
            "grouped_gemm_hopper": 0, "flash_attention": f * L,
            "flash_attention_hopper": f * L, "ssd_forward": 0,
            "ssd_forward_hopper": 0, "rmsnorm": f * 2 * L + 1}


def phase_train_scheduled(state, out):
    """Phase 6's qwen2-moe-2.7b step (4 layers at full width, bf16, comet,
    pallas_fused, 4 x 1024 tokens) through the block-schedule IR
    (``build_train_step(schedule=)``): (1) loss and every gradient of one
    fwd+bwd from the same weights under schedule "" (remat), "sequential"
    and "overlap", launch counters zeroed before and read after each: the
    two scheduled runs give the same bits (loss and every leaf), each
    within bf16 2e-2 of the remat run (per leaf rel L2; identical leaves
    counted), every fused_mlp, dgrad, wgrad and flash launch on the wgmma
    path, the plain versions seeing no CUDA tensor. (2) The three steps
    (AdamW) in turns, a warm-up step each, then SCHED_TURNS rounds: ms,
    tokens/s, max_memory_allocated and launches per step."""
    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.train_step import build_train_step
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.adamw import AdamW
    state.clear()
    torch.cuda.empty_cache()
    L = TRAIN_LAYERS
    cfg = train_cfg(L, "bfloat16")
    params = lm.init_params(cfg, seed=2, device="cuda")
    batch = train_batch(cfg)
    rec = {"grads": {}, "steps": {}}
    runs = {}
    for mode in SCHED_MODES:
        c = dataclasses.replace(cfg, block_schedule=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with PlainGuard() as guard:
            runs[mode] = loss_and_grads(c, params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        want = sched_launches(L, remat=not mode)
        rec["grads"][mode or "remat"] = {
            "loss": float(runs[mode][0]),
            "fwd_bwd_ms": (time.perf_counter() - t0) * 1e3,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts, "plain_calls_on_cuda": guard.cuda_calls}
        check(counts == want, f"{mode or 'remat'}: launches {counts}, "
                              f"expected {want}")
        check(guard.cuda_calls == 0,
              f"{mode or 'remat'}: plain versions saw CUDA tensors")
    (ls, gs), (lo, go), (lr, gr) = (runs[m] for m in ("sequential",
                                                       "overlap", ""))
    same = [p for p in gs if torch.equal(gs[p], go[p])]
    rel = {"/".join(map(str, p)): rel_l2(go[p], gr[p]) for p in go}
    ident = sum(torch.equal(go[p], gr[p]) for p in go)
    loss_rel = abs(float(lo) - float(lr)) / abs(float(lr))
    rec["compare"] = {
        "leaves": len(go), "sequential_overlap_identical": len(same),
        "loss_identical": bool(torch.equal(ls, lo)),
        "vs_remat_loss_rel_err": loss_rel,
        "vs_remat_loss_identical": bool(torch.equal(lo, lr)),
        "vs_remat_identical_leaves": ident,
        "vs_remat_grad_rel_l2_max": max(rel.values()),
        "vs_remat_grad_rel_l2": rel}
    log("  " + json.dumps({k: v for k, v in rec["compare"].items()
                           if k != "vs_remat_grad_rel_l2"}))
    check(torch.equal(ls, lo) and len(same) == len(gs),
          f"sequential and overlap differ: loss {float(ls)} / {float(lo)}, "
          f"{len(same)} of {len(gs)} leaves identical")
    check(loss_rel <= TOL["bf16"] and max(rel.values()) <= TOL["bf16"],
          f"scheduled step against the remat step: loss rel err "
          f"{loss_rel:.3e}, worst leaf {max(rel.values()):.3e} > 2e-2")
    del runs, gs, go, gr
    for _, t in tree_leaves(params):
        t.requires_grad_(False)
    torch.cuda.empty_cache()

    # (2) the steps in turns, from one state updated in place
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    steps = {m: build_train_step(cfg, shape, schedule=m)["fn"]
             for m in SCHED_MODES}
    tstate = {"params": params, "opt": AdamW().init(params), "step": 0}
    batches = [train_batch(cfg, step=i) for i in range(1 + SCHED_TURNS)]
    for m in SCHED_MODES:                         # warm-up
        tstate, _ = steps[m](tstate, batches[0])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    for m in SCHED_MODES:
        rec["steps"][m or "remat"] = {"runs": []}
    for turn in range(SCHED_TURNS):
        for m in SCHED_MODES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            tstate, met = steps[m](tstate, batches[1 + turn])
            loss = float(met["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = read_counts()
            rec["steps"][m or "remat"]["runs"].append({
                "ms": ms, "loss": loss, "skipped": met["skipped"],
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                "launches": counts})
            check(np.isfinite(loss) and not met["skipped"],
                  f"{m or 'remat'}: non-finite or skipped step")
            check(counts == sched_launches(L, remat=not m),
                  f"{m or 'remat'} step launches {counts}")
    for m, r in rec["steps"].items():
        r["step_ms_median"] = statistics.median(x["ms"] for x in r["runs"])
        r["tokens_per_s"] = tokens / r["step_ms_median"] * 1e3
        r["max_memory_allocated_gb"] = max(x["max_memory_allocated_gb"]
                                           for x in r["runs"])
        r["launches"] = r["runs"][-1]["launches"]
        log(f"  {m}: {r['step_ms_median']:.1f} ms a step, "
            f"{r['tokens_per_s']:.0f} tokens/s, peak "
            f"{r['max_memory_allocated_gb']:.2f} GB")
    out["train_scheduled"] = rec


# ---------------------------------------------------------------------------
# phase 18: the monolithic prefill and its left-padded decode
# ---------------------------------------------------------------------------


PREFILL_EQUAL = (8, 512)                   # rows, tokens each
PREFILL_MIXED = (8, 64, 512)               # rows, shortest, longest
PREFILL_DECODE = 32
PREFILL_SSM = (4, 1024)
PREFILL_ITERS = 3
PREFILL_CHUNK = 256
# the bf16 floor: the chunked admission at another chunk, against 256
PREFILL_FLOOR_CHUNK = 128


def _left_padded(prompts):
    """(tokens, mask or None, pads) of prompts left-padded to the longest,
    on the card; no mask when every prompt has the longest's length."""
    import torch
    plen = max(len(p) for p in prompts)
    toks = torch.zeros((len(prompts), plen), dtype=torch.long)
    mask = torch.zeros((len(prompts), plen), dtype=torch.bool)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = torch.tensor(p)
        mask[i, plen - len(p):] = True
    pads = (plen - mask.sum(1)).cuda()
    return toks.cuda(), (None if bool(mask.all()) else mask.cuda()), pads


def _greedy(cfg, params, cache, nxt, t_pos, steps, **kw):
    """``steps`` greedy decode steps from the tokens ``nxt`` at write
    indices ``t_pos`` (RoPE positions ``kw["rope_pos"]`` + t where given):
    (the first step's logits, the tokens, prefill token first, per row)."""
    import torch

    from repro_torch.models import lm
    streams, first = [nxt.tolist()], None
    for t in range(steps):
        step_kw = dict(kw)
        if "rope_pos" in kw:
            step_kw["rope_pos"] = kw["rope_pos"] + t
        lg, cache = lm.decode_step(cfg, params, cache, nxt[:, None],
                                   t_pos + t, **step_kw)
        first = lg if first is None else first
        nxt = torch.argmax(lg, -1)
        streams.append(nxt.tolist())
    return first, [list(s) for s in zip(*streams)]


def monolithic(cfg, params, prompts, steps, forced, timed=True):
    """lm.prefill of the left-padded prompts, timed over PREFILL_ITERS
    calls after a warm-up (launch counters zeroed before, read after),
    its cache stitched into a decode cache: ``steps`` greedy decode steps
    at each row's real position (rope_pos, kv_start), and one decode step
    of the tokens ``forced`` from a second stitch. Returns (record, the
    prefill's logits, the forced step's logits, the streams)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.serving import stitch_prefill_cache
    toks, mask, pads = _left_padded(prompts)
    n, plen = toks.shape
    batch = {"tokens": toks} if mask is None else {"tokens": toks,
                                                  "mask": mask}
    if timed:
        lm.prefill(cfg, params, batch)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms = []
    with PlainGuard() as guard:
        for _ in range(PREFILL_ITERS if timed else 1):
            t0 = time.perf_counter()
            logits, pre = lm.prefill(cfg, params, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    real = sum(len(p) for p in prompts)
    rec = {"rows": n, "padded_len": plen, "tokens": real,
           "masked": mask is not None, "ms": ms,
           "ms_median": statistics.median(ms),
           "tokens_per_s": real / statistics.median(ms) * 1e3,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "plain_calls_on_cuda": guard.cuda_calls}
    t_pos = torch.full((n,), plen, device="cuda")

    def stitched():
        return stitch_prefill_cache(cfg, lm.init_cache(
            cfg, n, plen + steps, "cuda"), pre, plen)

    kw = dict(rope_pos=plen - pads, kv_start=pads)
    forced_first, _ = _greedy(cfg, params, stitched(), forced, t_pos, 1,
                              **kw)
    t0 = time.perf_counter()
    _, streams = _greedy(cfg, params, stitched(), torch.argmax(logits, -1),
                         t_pos, steps, **kw)
    torch.cuda.synchronize()
    rec["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
    return rec, logits, forced_first, streams


def chunked(cfg, params, prompts, steps, chunk=PREFILL_CHUNK, forced=None,
            timed=True):
    """The engine's admission of the same prompts: stacked prefill_chunk
    calls of ``chunk`` tokens (each row from slot index 0, tail-padded,
    identity rows once a prompt ends), timed over PREFILL_ITERS rounds,
    then ``steps`` greedy decode steps, the first from ``forced`` (default
    its own argmax). Returns (record, each row's prefill logits, the first
    decode step's logits, the streams)."""
    import torch

    from repro_torch.models import lm
    n = len(prompts)
    lens = torch.tensor([len(p) for p in prompts], device="cuda")
    plen = max(len(p) for p in prompts)
    toks = torch.zeros((n, plen), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    toks = toks.cuda()
    slots = torch.arange(n, device="cuda")

    def admit():
        cache = lm.init_cache(cfg, n, plen + steps, "cuda")
        logits = None
        for c0 in range(0, plen, chunk):
            valid = torch.clamp(lens - c0, 0, chunk)
            lg, cache = lm.prefill_chunk(
                cfg, params, cache, toks[:, c0:c0 + chunk],
                torch.full((n,), c0, device="cuda"), valid, slots)
            ends = (lens > c0) & (lens <= c0 + chunk)
            logits = lg if logits is None else torch.where(
                ends[:, None], lg, logits)
        return logits, cache

    if timed:
        admit()                                         # warm-up
    ms = []
    for _ in range(PREFILL_ITERS if timed else 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = admit()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    rec = {"chunk": chunk, "ms": ms, "ms_median": statistics.median(ms),
           "tokens_per_s": int(lens.sum()) / statistics.median(ms) * 1e3}
    nxt = torch.argmax(logits, -1) if forced is None else forced
    first, streams = _greedy(cfg, params, cache, nxt, lens, steps)
    return rec, logits, first, streams


def prefill_case(cfg, params, prompts, steps, want_launches, timed=True):
    """The monolithic prefill beside the chunked admission of the same
    prompts (each prefill's logits; the first decode step's from the
    chunked path's first tokens; the free-running streams: identical
    ones counted), and the floor between two chunked admissions (chunk
    PREFILL_FLOOR_CHUNK against PREFILL_CHUNK, the same first tokens).
    Returns the record."""
    import torch
    chunk, c_lg, c_first, c_streams = chunked(cfg, params, prompts, steps,
                                              timed=timed)
    forced = torch.argmax(c_lg, -1)
    mono, m_lg, m_first, m_streams = monolithic(cfg, params, prompts,
                                                steps, forced, timed)
    _, f_lg, f_first, _ = chunked(cfg, params, prompts, 1,
                                  PREFILL_FLOOR_CHUNK, forced, timed=False)
    rec = {"monolithic": mono, "chunked": chunk,
           "prefill_logits": compare_logits(m_lg, c_lg),
           "first_decode_logits": compare_logits(m_first, c_first),
           "floor_prefill_logits": compare_logits(f_lg, c_lg),
           "floor_first_decode_logits": compare_logits(f_first, c_first),
           "identical_streams": sum(a == b for a, b in zip(m_streams,
                                                           c_streams)),
           "streams": len(prompts)}
    log("  " + json.dumps({k: v for k, v in rec.items()
                           if k not in ("monolithic", "chunked")}))
    log(f"  monolithic {mono['ms_median']:.1f} ms "
        f"({mono['tokens_per_s']:.0f} tokens/s), chunked "
        f"{chunk['ms_median']:.1f} ms ({chunk['tokens_per_s']:.0f})")
    n = PREFILL_ITERS if timed else 1
    check(mono["launches"] == {k: n * v for k, v in want_launches.items()},
          f"prefill launches {mono['launches']}, expected "
          f"{n} x {want_launches}")
    check(mono["plain_calls_on_cuda"] == 0,
          "plain versions saw CUDA tensors")
    return rec


def _prefill_launches(cfg, flash):
    """One prefill call's launches: a fused_mlp and a topk_combine per MoE
    layer, 2L+1 norms, a flash_attention per attention layer where the
    batch is unmasked; the Hopper paths' alike in bf16."""
    L = cfg.n_layers
    hop = cfg.param_dtype == "bfloat16"
    n = {k: 0 for k in read_counts()}
    if cfg.moe is not None:
        n.update(fused_mlp=L, fused_mlp_hopper=L * hop, topk_combine=L)
    if flash:
        n.update(flash_attention=L, flash_attention_hopper=L * hop)
    n["rmsnorm"] = 2 * L + 1
    return n


def mesh_prefill_arms(cfg, params, batch, enc_len=0):
    """The monolithic prefill of ``batch`` ("tokens" (B, S), and a
    left-padded batch's "mask" or an encoder-decoder's "frames") through
    build_prefill_step twice, without a mesh and on a (1, 1) mesh over the
    world-1 NCCL group (build_prefill_step(mesh=) on to_mesh's shard,
    stitch_prefill_cache(ctx=, layout=) into init_cache(ctx=), decode_step
    on the serving context), launch counters zeroed before each arm's
    prefill and read after: its cache stitched into a decode cache of S +
    1 positions (and ``enc_len`` encoder rows), one decode step from the
    prefill's argmax (a left-padded row at its real position). The mesh
    arm's logits, prefill cache leaves, decode logits and decode cache
    leaves against the mesh-less arm's: identical bits counted, rel L2 of
    each, within fp32 1e-4 / bf16 2e-2. Returns the record."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.train_step import build_prefill_step
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.serving import stitch_prefill_cache
    n, plen = batch["tokens"].shape
    mask = batch.get("mask")
    kw = {} if mask is None else dict(rope_pos=(plen - (~mask).sum(1)),
                                      kv_start=(~mask).sum(1))
    shape = ShapeConfig("prefill", plen, n, "prefill")
    arms = {}
    with world1("nccl"):
        mesh = make_mesh((1, 1), ("data", "model"))
        for tag, m in (("meshless", None), ("mesh", mesh)):
            built = build_prefill_step(cfg, shape, m)
            p, ctx, layout = params, None, None
            if m is not None:
                p = SH.to_mesh(params, cfg, built["ctx"])
                ctx = SH.make_ctx(cfg, m, seq_shard=False)
                layout = lm.serve_layout(cfg, ctx, n, plen + 1,
                                         built["param_specs"],
                                         enc_len=enc_len)
            torch.cuda.synchronize()
            reset_counts()
            with PlainGuard() as guard:
                t0 = time.perf_counter()
                logits, pre = built["fn"](p, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                counts = read_counts()
                cache = stitch_prefill_cache(cfg, lm.init_cache(
                    cfg, n, plen + 1, "cuda", ctx, enc_len), pre, plen, ctx,
                    layout)
                dec, cache = lm.decode_step(
                    cfg, p, cache, torch.argmax(logits, -1)[:, None],
                    torch.full((n,), plen, device="cuda"), ctx, layout, **kw)
            torch.cuda.synchronize()
            arms[tag] = {"logits": logits, "decode_logits": dec,
                         **{"prefill_cache/" + "/".join(map(str, k)): t
                            for k, t in tree_leaves(pre)},
                         **{"decode_cache/" + "/".join(map(str, k)): t
                            for k, t in tree_leaves(cache)},
                         "_rec": {"ms": ms, "launches": counts,
                                  "plain_calls_on_cuda": guard.cuda_calls}}
    want, got = arms["meshless"], arms["mesh"]
    recs = {t: arms[t].pop("_rec") for t in arms}
    check(set(got) == set(want), "the two arms' caches hold other leaves")
    errs = {k: rel_l2(got[k], want[k]) for k in want}
    same = sum(bool(torch.equal(got[k], want[k])) for k in want)
    worst = max(errs, key=errs.get)
    rec = {"arms": recs, "compared": len(want), "identical_bits": same,
           "worst": worst, "worst_rel_l2": errs[worst],
           "logits_rel_l2": errs["logits"],
           "decode_logits_rel_l2": errs["decode_logits"]}
    log("  (1, 1) mesh vs mesh-less: " + json.dumps(rec))
    tol = TOL["bf16" if cfg.param_dtype == "bfloat16" else "fp32"]
    check(recs["mesh"]["launches"] == recs["meshless"]["launches"],
          f"mesh arm launches {recs['mesh']['launches']}, mesh-less "
          f"{recs['meshless']['launches']}")
    check(all(r["plain_calls_on_cuda"] == 0 for r in recs.values()),
          "plain versions saw CUDA tensors")
    check(errs[worst] <= tol, f"mesh arm: {worst} rel L2 {errs[worst]:.3e} "
                              f"from the mesh-less arm's")
    return rec


def phase_prefill(state, out):
    """The monolithic prefill (``lm.prefill``: the whole prompt in one
    forward, the cache returned) and the left-padded decode it feeds
    (``serving.stitch_prefill_cache``, ``decode_step(rope_pos=,
    kv_start=)``), beside the chunked admission (stacked prefill_chunk
    calls of 256) of the same prompts, launch counters zeroed before and
    read after the prefill calls, each case 8 prompts of 512 tokens
    (unmasked: the flash kernel) and 8 of 64-512 left-padded (masked).
    (a) qwen2-moe-2.7b at full width, 4 layers, fp32 (pallas_fused,
    no-drop capacity, seed 0): each prefill's logits and the first decode
    step's (both paths fed the chunked path's first tokens) within fp32
    1e-4 (rel L2) of the chunked path's. (b) qwen2 whole in bf16: 3
    timed prefill calls (every flash_attention and fused_mlp launch on
    the wgmma path), 32 decode steps; the logits' distances recorded
    beside the floor between two chunked admissions (chunk 128 against
    256), the identical streams counted. (c) mamba2-780m whole, 4 x 1024
    tokens: every ssd_forward (a zero state, h_final returned) on the
    tensor-core path, the distances recorded. ms, tokens/s, peak memory
    and launches of each. (d) The (1, 1) mesh arms of (a)'s two prompt
    sets and (c)'s (``mesh_prefill_arms``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_trace
    from repro_torch.models import lm
    state.clear()
    torch.cuda.empty_cache()
    cfg = with_gemm(get_config(ARCH), "pallas_fused")
    moe = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.num_experts / moe.top_k))
    n, S = PREFILL_EQUAL
    equal = make_trace(cfg.vocab_size, n, S, S, 11)
    n, lo, hi = PREFILL_MIXED
    mixed = make_trace(cfg.vocab_size, n, lo, hi, 12)
    rec = {}
    c32 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    p32 = lm.init_params(c32, seed=0, device="cuda")
    for key, prompts, flash in (("fp32_equal", equal, True),
                                ("fp32_mixed", mixed, False)):
        rec[key] = prefill_case(c32, p32, prompts, 1,
                                _prefill_launches(c32, flash), timed=False)
        for what in ("prefill_logits", "first_decode_logits"):
            err = rec[key][what]["rel_l2_err"]
            check(err <= TOL["fp32"], f"{key}: {what} rel L2 {err:.3e} "
                                      f"from the chunked path's")
        toks, mask, _ = _left_padded(prompts)
        rec[key]["mesh_1x1"] = mesh_prefill_arms(
            c32, p32, {"tokens": toks} if mask is None else
            {"tokens": toks, "mask": mask})
        if flash:
            n = rec[key]["mesh_1x1"]["arms"]["mesh"]["launches"]
            check(n["flash_attention"] == c32.n_layers,
                  f"{key}: mesh arm flash launches {n}")
    del p32
    torch.cuda.empty_cache()
    params = lm.init_params(cfg, seed=0, device="cuda")
    for key, prompts, flash in (("bf16_equal", equal, True),
                                ("bf16_mixed", mixed, False)):
        rec[key] = prefill_case(cfg, params, prompts, PREFILL_DECODE,
                                _prefill_launches(cfg, flash))
    del params
    torch.cuda.empty_cache()
    scfg = ssm_cfg(get_config(SSM_ARCH).n_layers, "bfloat16")
    sparams = lm.init_params(scfg, seed=0, device="cuda")
    n, S = PREFILL_SSM
    want = _prefill_launches(scfg, False)
    want.update(ssd_forward=scfg.n_layers, ssd_forward_hopper=scfg.n_layers)
    prompts = make_trace(scfg.vocab_size, n, S, S, 13)
    rec["mamba2"] = prefill_case(scfg, sparams, prompts, 1, want)
    rec["mamba2"]["mesh_1x1"] = mesh_prefill_arms(
        scfg, sparams, {"tokens": _left_padded(prompts)[0]})
    n = rec["mamba2"]["mesh_1x1"]["arms"]["mesh"]["launches"]
    check(n["ssd_forward"] == n["ssd_forward_hopper"] == scfg.n_layers,
          f"mamba2 mesh arm launches {n}")
    out["prefill"] = rec


# the whisper phase: whisper-small whole (12 encoder and 12 decoder
# layers at every published width); fp32: 2 rows of 1500 frames and 32
# tokens; bf16 gradients at 2 + 2 layers on 4 rows; the train step at
# --batch 8 --seq 1500 (1500 frames and 375 tokens a row, the JAX
# package's ratio); serving: 8 requests of 1500 frames and 32 prompt
# tokens, a decode cache of 448 positions (whisper's text context) and
# 1500 encoder rows, 64 greedy decode steps
WHISPER_ARCH = "whisper-small"
WHISPER_FP32 = (2, 1500, 32)               # rows, frames, tokens
WHISPER_GRAD = (4, 1500, 375, 2)           # rows, frames, tokens, layers
WHISPER_TRAIN = (8, 1500)                  # --batch, --seq
WHISPER_SERVE = (8, 1500, 32, 448, 64)     # rows, frames, prompt, ctx, steps


def whisper_cfg(dtype, layers=0):
    """whisper-small at full width in ``dtype``; ``layers`` cuts both
    stacks to that depth (0: all 12 + 12)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(WHISPER_ARCH), param_dtype=dtype,
                              compute_dtype=dtype)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers, n_enc_layers=layers)
    return cfg


def whisper_inputs(cfg, rows, frames, tokens, seed):
    """Seeded stub-frontend frames (B, frames, d) and tokens (B, tokens)
    on the card, as the synthetic data draws them."""
    import torch
    g = _gen(seed)
    fr = torch.randn((rows, frames, cfg.d_model), device="cuda",
                     generator=g) * 0.02
    toks = torch.randint(0, cfg.vocab_size, (rows, tokens), device="cuda",
                         generator=g)
    return fr, toks


def whisper_flash_launches(cfg, train=False):
    """Flash launches of one forward: the encoder's self-attention and
    each decoder layer's causal self-attention and cross-attention (36
    for whisper-small); a train step under remat recomputes them all."""
    n = cfg.n_enc_layers + 2 * cfg.n_layers
    return 2 * n if train and cfg.remat == "full" else n


# the second plain route's blocks of queries and keys: 125 divides every
# length of phase 19's attention (1500 frames, 375 tokens)
WHISPER_FLOOR_BLOCK = 125


@contextlib.contextmanager
def chunked_attention_route():
    """While active, ops.flash_attention calls the plain chunked
    online-softmax attention of models/attention.py by name, in blocks of
    WHISPER_FLOOR_BLOCK (a second plain route: the JAX package's chunked
    jnp form, fp32 like ref.flash_attention_ref but summed block by
    block)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    saved = ops.flash_attention

    def chunked(q, k, v, causal=True):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qp, kp = (torch.arange(t.shape[1], device=q.device)[None, :]
                  .expand(t.shape[0], -1) for t in (qt, kt))
        return A.chunked_attention(qt, kt, vt, WHISPER_FLOOR_BLOCK,
                                   WHISPER_FLOOR_BLOCK, qp, kp,
                                   causal).transpose(1, 2)

    ops.flash_attention = chunked
    try:
        yield
    finally:
        ops.flash_attention = saved


def mesh_loss_and_grads(cfg, params, batch):
    """loss_fn and the gradient of every leaf on a (1, 1) mesh over the
    world-1 NCCL group: the mesh train step's context (``seq_shard`` on)
    and to_mesh's shard of ``params``, keyed as ``loss_and_grads`` keys
    them."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel import sharding as SH
    from repro_torch.parallel.mesh import make_mesh
    with world1("nccl"):
        ctx = SH.make_ctx(cfg, make_mesh((1, 1), ("data", "model")),
                          seq_shard=True)
        p = SH.to_mesh(params, cfg, ctx)
        leaves = [(k, t.requires_grad_(True)) for k, t in tree_leaves(p)]
        loss, _ = lm.loss_fn(cfg, p, batch, ctx)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        torch.cuda.synchronize()
    return loss.detach(), {k: g for (k, _), g in zip(leaves, grads)}


def phase_whisper(state, out):
    """whisper-small, the encoder-decoder, through the port's entry points
    (the encoder's self-attention, the cross-attention and the decoder's
    unmasked causal self-attention on the flash kernel). (a) fp32, whole:
    lm.prefill of 32 tokens beside 1500 frames, the cache stitched into a
    decode cache of 1500 encoder rows, one decode_step: its logits within
    rel L2 1e-4 of the full forward's at position 32; the forward's
    logits through the kernels within 1e-4 of the plain versions'. (b)
    bf16 at 2 + 2 layers: loss and every gradient through the kernels
    against the plain versions, per leaf within max(2e-2, 3 x the floor
    between two plain routes: the chunked attention beside the plain
    one), as phase 6. (c) launch/train.py's Trainer
    at --batch 8 --seq 1500: a warm-up and 3 timed steps, finite and none
    skipped, 72 flash launches a step (36 regions and their remat
    recompute), every one on the wgmma path. (d) 8 requests of 1500
    frames and 32 tokens: a warm-up and 3 timed monolithic prefills (36
    flash launches each, all wgmma), the stitch into a decode cache of
    448 positions and 1500 encoder rows, 64 greedy decode steps (no flash
    launch); the first step's logits within rel L2 2e-2 of the full
    forward's. ms, memory and launches of each. (a) and (b) also on a (1,
    1) mesh at world 1 beside their mesh-less runs (``mesh_prefill_arms``,
    ``mesh_loss_and_grads``)."""
    import numpy as np
    import tempfile

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.serving import stitch_prefill_cache
    from repro_torch.training.trainer import Trainer, TrainerConfig
    state.clear()
    torch.cuda.empty_cache()
    rec = out["whisper"] = {}

    # (a) fp32, the whole model
    cfg = whisper_cfg("float32")
    params = lm.init_params(cfg, seed=0, device="cuda")
    Bz, F_, S = WHISPER_FP32
    fr, toks = whisper_inputs(cfg, Bz, F_, S + 1, 31)
    with torch.no_grad():
        h, _, _ = lm.forward(cfg, params, {"frames": fr, "tokens": toks})
        with plain_ops():
            hp, _, _ = lm.forward(cfg, params, {"frames": fr, "tokens": toks})
    want = lm._logits(cfg, params, h[:, S], per_row=True)
    plain = lm._logits(cfg, params, hp[:, S], per_row=True)
    _, pre = lm.prefill(cfg, params, {"frames": fr, "tokens": toks[:, :S]})
    cache = stitch_prefill_cache(cfg, lm.init_cache(
        cfg, Bz, S + 8, "cuda", enc_len=F_), pre, S)
    got, _ = lm.decode_step(cfg, params, cache, toks[:, S:],
                            torch.full((Bz,), S, device="cuda"))
    rec["fp32"] = {"decode_vs_forward_rel_l2": rel_l2(got, want),
                   "kernels_vs_plain_rel_l2": rel_l2(want, plain)}
    log("  fp32 whole: " + json.dumps(rec["fp32"]))
    del cache, pre, h, hp
    rec["fp32_mesh_1x1"] = mesh_prefill_arms(
        cfg, params, {"frames": fr, "tokens": toks[:, :S]}, enc_len=F_)
    n = rec["fp32_mesh_1x1"]["arms"]["mesh"]["launches"]
    check(n["flash_attention"] == whisper_flash_launches(cfg),
          f"fp32 mesh arm flash launches {n}")
    del params
    torch.cuda.empty_cache()
    for k, v in rec["fp32"].items():
        check(v <= TOL["fp32"], f"fp32 {k} {v:.3e} > 1e-4")

    # (b) bf16 gradients at 2 + 2 layers
    Bz, F_, S, L = WHISPER_GRAD
    c16 = whisper_cfg("bfloat16", L)
    p16 = lm.init_params(c16, seed=2, device="cuda")
    fr, toks = whisper_inputs(c16, Bz, F_, S + 1, 32)
    batch = {"frames": fr, "tokens": toks[:, :S], "labels": toks[:, 1:]}
    runs = {"plain": loss_and_grads(c16, p16, batch, plain=True)}
    reset_counts()
    runs["kernels"] = loss_and_grads(c16, p16, batch)
    torch.cuda.synchronize()
    counts16 = {"meshless": read_counts()}
    with plain_ops(), chunked_attention_route():
        runs["chunked"] = loss_and_grads(c16, p16, batch)
    reset_counts()
    mesh_l, mesh_g = mesh_loss_and_grads(c16, p16, batch)
    counts16["mesh"] = read_counts()
    torch.cuda.synchronize()
    del p16
    want_l, want_g = runs.pop("plain")
    g = {}
    for name, (loss, grads) in runs.items():
        check(bool(torch.isfinite(loss)) and all(
            bool(t.isfinite().all()) for t in grads.values()),
            f"bf16 {name}: non-finite loss or gradient")
        g[name] = {"loss_rel_err": abs(float(loss) - float(want_l))
                   / abs(float(want_l)),
                   "grad_rel_l2": {"/".join(map(str, p)): rel_l2(t, want_g[p])
                                   for p, t in grads.items()}}
    kern_l, kern_g = runs["kernels"]
    check(set(mesh_g) == set(kern_g), "the mesh arm's leaves differ")
    mesh_errs = {"/".join(map(str, k)): rel_l2(mesh_g[k], t)
                 for k, t in kern_g.items()}
    worst = max(mesh_errs, key=mesh_errs.get)
    rec["bf16_mesh_1x1"] = {
        "loss_identical": bool(torch.equal(mesh_l, kern_l)),
        "loss_rel_err": abs(float(mesh_l) - float(kern_l))
        / abs(float(kern_l)),
        "leaves": len(kern_g),
        "identical_bits": sum(bool(torch.equal(mesh_g[k], t))
                              for k, t in kern_g.items()),
        "worst": worst, "worst_rel_l2": mesh_errs[worst],
        "launches": counts16}
    log("  bf16 (1, 1) mesh vs mesh-less: " + json.dumps(
        rec["bf16_mesh_1x1"]))
    del runs, want_g, mesh_g, kern_g
    torch.cuda.empty_cache()
    m16 = rec["bf16_mesh_1x1"]
    check(m16["loss_rel_err"] <= TOL["bf16"]
          and m16["worst_rel_l2"] <= TOL["bf16"],
          f"bf16 mesh arm: loss rel err {m16['loss_rel_err']:.3e}, "
          f"{worst} rel L2 {m16['worst_rel_l2']:.3e}")
    check(counts16["mesh"] == counts16["meshless"]
          and counts16["mesh"]["flash_attention"]
          == counts16["mesh"]["flash_attention_hopper"] > 0,
          f"bf16 gradient launches {counts16}")
    bad = [f"{leaf}: {err:.3e}" for leaf, err in
           g["kernels"]["grad_rel_l2"].items()
           if err > max(TOL["bf16"], 3 * g["chunked"]["grad_rel_l2"][leaf])]
    rec["bf16_grads"] = {
        name: {"loss_rel_err": r["loss_rel_err"],
               "grad_rel_l2_max": max(r["grad_rel_l2"].values()),
               "grad_rel_l2": r["grad_rel_l2"]} for name, r in g.items()}
    log(f"  bf16 {L}+{L} layers: kernels vs plain loss rel err "
        f"{g['kernels']['loss_rel_err']:.3e}, worst leaf "
        f"{rec['bf16_grads']['kernels']['grad_rel_l2_max']:.3e}; chunked "
        f"route vs plain {g['chunked']['loss_rel_err']:.3e}, worst leaf "
        f"{rec['bf16_grads']['chunked']['grad_rel_l2_max']:.3e}")
    check(g["kernels"]["loss_rel_err"]
          <= max(TOL["bf16"], 3 * g["chunked"]["loss_rel_err"]),
          f"bf16 loss rel err {g['kernels']['loss_rel_err']:.3e}")
    check(not bad, f"bf16 gradients outside max(2e-2, 3 x floor): {bad}")

    # (c) the Trainer of launch/train.py at --batch 8 --seq 1500
    cfg = whisper_cfg("bfloat16")
    Bz, F_ = WHISPER_TRAIN
    tr = Trainer(cfg, ShapeConfig("train", F_, Bz, "train"), None,
                 TrainerConfig(ckpt_dir=tempfile.mkdtemp(
                     prefix="chip_smoke_whisper_")), device="cuda")
    tstate = tr.init_state()
    n_params = sum(t.numel() for t in _leaves(tstate["params"]))
    batches = [tr._device_batch(tr.data.batch_at(i)) for i in range(4)]
    T = batches[0]["tokens"].shape[1]
    tstate, m = tr.built["fn"](tstate, batches[0])        # warm-up
    warm_loss = float(m["loss"])
    tstate, steps, counts, plain_calls = train_steps(tr, tstate, batches[1:])
    ms = statistics.median(st["ms"] for st in steps)
    rec["train"] = {
        "rows": Bz, "frames": F_, "tokens": T, "params": n_params,
        "warmup_loss": warm_loss, "steps": steps, "step_ms_median": ms,
        "frames_per_s": Bz * F_ / ms * 1e3, "tokens_per_s": Bz * T / ms * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "plain_calls_on_cuda": plain_calls}
    log("  train: " + json.dumps(rec["train"]))
    del tr, tstate, batches
    torch.cuda.empty_cache()
    n = 3 * whisper_flash_launches(cfg, train=True)
    want = {k: 0 for k in counts}
    want.update(flash_attention=n, flash_attention_hopper=n,
                **head_launches(cfg, T, 3))
    check(counts == want, f"train launches {counts}, expected {want}")
    check(plain_calls == 0, f"plain versions saw CUDA tensors {plain_calls} "
                            f"times")
    check(all(np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])
              and not st["skipped"] for st in steps),
          f"non-finite or skipped steps: {steps}")

    # (d) serving: the monolithic prefill, the stitch, greedy decode
    params = lm.init_params(cfg, seed=0, device="cuda")
    Bz, F_, S, ctx_len, n_steps = WHISPER_SERVE
    fr, toks = whisper_inputs(cfg, Bz, F_, S, 33)
    batch = {"frames": fr, "tokens": toks}
    lm.prefill(cfg, params, batch)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    pre_ms = []
    with PlainGuard() as guard:
        for _ in range(PREFILL_ITERS):
            t0 = time.perf_counter()
            logits, pre = lm.prefill(cfg, params, batch)
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
        pre_counts = read_counts()
        cache = stitch_prefill_cache(cfg, lm.init_cache(
            cfg, Bz, ctx_len, "cuda", enc_len=F_), pre, S)
        del pre
        reset_counts()
        t0 = time.perf_counter()
        first, streams = _greedy(cfg, params, cache, torch.argmax(logits, -1),
                                 torch.full((Bz,), S, device="cuda"), n_steps)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        dec_counts = read_counts()
    with torch.no_grad():
        full = torch.cat([toks, torch.argmax(logits, -1)[:, None]], 1)
        h, _, _ = lm.forward(cfg, params, {"frames": fr, "tokens": full})
    ref_logits = lm._logits(cfg, params, h[:, S], per_row=True)
    rec["serve"] = {
        "rows": Bz, "frames": F_, "prompt": S, "max_seq": ctx_len,
        "decode_steps": n_steps, "prefill_ms": pre_ms,
        "prefill_ms_median": statistics.median(pre_ms),
        "decode_ms_per_step": dec_ms,
        "decode_tokens_per_s": Bz / dec_ms * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "prefill_launches": pre_counts, "decode_launches": dec_counts,
        "plain_calls_on_cuda": guard.cuda_calls,
        "first_decode_vs_forward": compare_logits(first, ref_logits),
        "streams_len": len(streams[0])}
    log("  serve: " + json.dumps(rec["serve"]))
    del params, cache
    torch.cuda.empty_cache()
    n = PREFILL_ITERS * whisper_flash_launches(cfg)
    want = {k: 0 for k in pre_counts}
    want.update(flash_attention=n, flash_attention_hopper=n)
    check(pre_counts == want, f"prefill launches {pre_counts}, expected "
                              f"{want}")
    check(dec_counts == {k: 0 for k in dec_counts},
          f"decode launched kernels: {dec_counts}")
    check(guard.cuda_calls == 0, "plain versions saw CUDA tensors")
    err = rec["serve"]["first_decode_vs_forward"]["rel_l2_err"]
    check(err <= TOL["bf16"], f"bf16 first decode logits rel L2 {err:.3e} "
                              f"from the forward's")


# ---------------------------------------------------------------------------
# phase 20: elastic re-meshing, int8 gradient compression, the verify driver
# ---------------------------------------------------------------------------


def elastic_trainer(cfg, ckpt_dir):
    """A Trainer of phase 6's shape without a mesh, seeded weights on the
    card."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    tr = Trainer(cfg, shape, None, TrainerConfig(
        ckpt_dir=ckpt_dir, ckpt_every=10_000, log_every=10_000),
        device="cuda")
    return tr, tr.init_state(ELASTIC_SEED)


def elastic_rescale(rec):
    """(a) 2 steps without a mesh, rescale to a (1, 1) mesh, 2 steps,
    rescale to none, 1 step; then 5 uninterrupted steps from the same
    seed: the losses and every leaf of the final state must be the same
    bits. Launches counted over the elastic run's steps and rescales."""
    import tempfile

    import torch

    from repro_torch.parallel.mesh import make_mesh
    cfg = train_cfg(ELASTIC_LAYERS, "bfloat16")
    mesh = make_mesh((1, 1), ("data", "model"))
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rescale_ms = []
        with PlainGuard() as guard:
            tr, st = elastic_trainer(cfg, ckpt)
            step = 0
            for end, target in ((2, mesh), (4, None), (5, "end")):
                st, step = tr._run_span(st, step, end)
                if target == "end":
                    break
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = tr.rescale(st, target)
                torch.cuda.synchronize()
                rescale_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        elastic = [m["loss"] for m in tr.metrics_log]
        steps_ms = [m["time_s"] * 1e3 for m in tr.metrics_log]
        got = _state_leaves(st)
        del tr
        ref_tr, ref_st = elastic_trainer(cfg, ckpt)
        ref_st, _ = ref_tr._run_span(ref_st, 0, 5)
        plain = [m["loss"] for m in ref_tr.metrics_log]
        want = _state_leaves(ref_st)
        n_leaves = len(want)
        same = sum(bool(torch.equal(got[k], want[k])) for k in want)
        same_keys = set(got) == set(want)
        del st, ref_st, ref_tr, got, want
    torch.cuda.empty_cache()
    L = ELASTIC_LAYERS
    expect = {k: 0 for k in counts}
    expect.update(fused_mlp=2 * L * 5, fused_mlp_hopper=2 * L * 5,
                  topk_combine=2 * L * 5, fused_mlp_dgrad=L * 5,
                  fused_mlp_dgrad_hopper=L * 5, fused_mlp_wgrad=L * 5,
                  fused_mlp_wgrad_hopper=L * 5, flash_attention=2 * L * 5,
                  flash_attention_hopper=2 * L * 5,
                  rmsnorm=(2 * 2 * L + 1) * 5,
                  **head_launches(cfg, TRAIN_SEQ, 5))
    rec["rescale"] = {
        "layers": L, "tokens_per_step": TRAIN_SEQ * TRAIN_BATCH,
        "path": "none -> (1, 1) -> none", "losses": elastic,
        "uninterrupted_losses": plain, "step_ms": steps_ms,
        "rescale_ms": rescale_ms, "leaves": n_leaves,
        "identical_leaves": same, "max_memory_allocated_gb": peak,
        "launches": counts, "plain_calls_on_cuda": guard.cuda_calls}
    log("  elastic run: " + json.dumps(rec["rescale"]))
    log(f"  rescales {rescale_ms[0]:.2f} ms (to (1, 1)), {rescale_ms[1]:.2f}"
        f" ms (to none); {same} of {rec['rescale']['leaves']} leaves the "
        f"uninterrupted run's bits; peak {peak:.1f} GB")
    check(same_keys and same == rec["rescale"]["leaves"],
          f"{same} of {rec['rescale']['leaves']} leaves gave the "
          f"uninterrupted run's bits")
    check(elastic == plain, f"losses {elastic} against {plain}")
    check(counts == expect, f"launches {counts}, expected {expect}")
    check(guard.cuda_calls == 0, "plain versions saw CUDA tensors")


def elastic_compression(rec):
    """(b) allreduce_compressed over the world-1 NCCL group on a train
    step's gradient tree (phase 6's shape, the elastic depth) with a
    non-zero residual: the bits of decompress_pytree(compress_pytree(g,
    r)) and the same residuals; its ms (median of 3) beside its wire
    bytes and the fp32 tree's."""
    import torch

    from repro_torch.models import lm
    from repro_torch.optim import compression as C
    from repro_torch.parallel.mesh import make_mesh
    cfg = train_cfg(ELASTIC_LAYERS, "bfloat16")
    params = lm.init_params(cfg, seed=ELASTIC_SEED, device="cuda")
    _, grads = loss_and_grads(cfg, params, train_batch(cfg))
    grads = {"/".join(map(str, p)): g for p, g in grads.items()}
    del params
    torch.cuda.empty_cache()
    _, resid = C.compress_pytree(grads, C.init_residuals(grads))
    group = make_mesh((1, 1), ("data", "model")).group(("data",))
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, new = C.allreduce_compressed(grads, resid, group)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if len(ms) < 3:
            del out, new
    same_out = same_res = 0
    for p, g in grads.items():           # leaf by leaf: one copy at a time
        q, s, r = C.compress_with_feedback(g, resid[p])
        same_out += bool(torch.equal(out[p], C.dequantize_int8(q, s)))
        same_res += bool(torch.equal(new[p], r))
    n = len(grads)
    elements = sum(g.numel() for g in grads.values())
    # the payloads of the call's two all-reduces beside the int8 values
    # and an fp32 all-reduce of the same tree
    wire = {"int32_payload": 4 * elements, "fp32_scales": 4 * n,
            "int8_payload": elements, "fp32_tree": 4 * elements}
    rec["compression"] = {
        "leaves": n, "elements": elements,
        "identical_outputs": same_out, "identical_residuals": same_res,
        "ms": ms, "ms_median": statistics.median(ms), "wire_bytes": wire,
        "backend": "nccl", "world": 1}
    log("  allreduce_compressed: " + json.dumps(rec["compression"]))
    del grads, resid, out, new
    torch.cuda.empty_cache()
    check(same_out == n and same_res == n,
          f"world-1 allreduce_compressed: {same_out} / {same_res} of {n} "
          f"leaves gave the local round trip's bits")


def elastic_verify(rec):
    """(c) python -m repro_torch.analysis.verify --all --json: no error."""
    import os
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.verify", "--all",
         "--json"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    try:
        report = json.loads(proc.stdout)
    except json.JSONDecodeError:
        report = {"ok": False, "errors": None, "diagnostics": []}
    rec["verify"] = {"rc": proc.returncode, "s": time.perf_counter() - t0,
                     "errors": report["errors"],
                     "diagnostics": len(report["diagnostics"])}
    log("  verify --all: " + json.dumps(rec["verify"]))
    check(proc.returncode == 0 and report["ok"],
          f"verify --all failed:\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-3000:]}")


def phase_elastic(state, out):
    import torch
    state.clear()                     # earlier phases' weights and state
    torch.cuda.empty_cache()
    rec = {}
    out["elastic"] = rec
    with world1("nccl"):
        elastic_rescale(rec)
        elastic_compression(rec)
    elastic_verify(rec)


ROOFLINE_CELLS = ("train_4k", "decode_32k")    # phase 21 (b)
# phase 21 (d): the attribution and the override-climb CLIs on one cell
# each: (name, the module's arguments, the JSON file the run writes, in
# the run's directory)
ROOFLINE_TOOLS = (
    ("attribute", ["repro_torch.analysis.attribute", ARCH, "decode_32k",
                   "--json", "attribute.json"], "attribute.json"),
    ("hillclimb", ["repro_torch.launch.hillclimb", ARCH, "decode_32k",
                   "n_col=2", "save=1"],
     f"experiments/perf/{ARCH}_decode_32k_n_col2.json"))
ROOFLINE_CLI_TIMEOUT = 900


class DryrunCli:
    """Phase 21 (b) and (d): ``python -m repro_torch.launch.dryrun`` for
    ARCH's ROOFLINE_CELLS on the single-pod mesh over 256 fake ranks, one
    process a cell, and the ROOFLINE_TOOLS runs, one process each, in a
    directory of their own. The runs need no card and take longer than
    the phase on the card's host (a train_4k cell runs some 470,000 ops
    on meta tensors), so ``main`` starts them when the script starts, at
    the lowest CPU priority and one thread each, and phase 21 collects
    them; ``stop`` kills what is still running."""

    def __init__(self):
        self.runs = {}
        self.tmp = None

    def _spawn(self, name, args, out, cwd=None):
        import os
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        log_path = Path(self.tmp.name) / f"{name}.log"
        with open(log_path, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", *args], stdout=f,
                stderr=subprocess.STDOUT, env=env, cwd=cwd,
                preexec_fn=lambda: os.nice(19))
        self.runs[name] = (proc, log_path, out, time.perf_counter())

    def start(self):
        import tempfile
        self.tmp = tempfile.TemporaryDirectory()
        tmp = Path(self.tmp.name)
        for shape in ROOFLINE_CELLS:
            summary = tmp / f"{shape}.json"
            self._spawn(shape, ["repro_torch.launch.dryrun", "--arch", ARCH,
                                "--shape", shape, "--summary", str(summary)],
                        summary)
        for name, args, out in ROOFLINE_TOOLS:
            (tmp / name).mkdir()
            self._spawn(name, args, tmp / name / out, cwd=tmp / name)

    def collect(self, timeout=ROOFLINE_CLI_TIMEOUT):
        """{name: {"rc", "s" (start to collect), "out" (the JSON the run
        wrote, None if none), "report", "log_tail"}}."""
        res = {}
        for name, (proc, log_path, out, t0) in self.runs.items():
            try:
                rc = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            lines = log_path.read_text().splitlines()
            res[name] = {"rc": rc, "s": time.perf_counter() - t0,
                         "out": (json.loads(out.read_text()) if out.exists()
                                 else None),
                         "report": [ln for ln in lines
                                    if ln.startswith(("==", "  "))][-12:],
                         "log_tail": lines[-24:]}
        return res

    def stop(self):
        for proc, *_ in self.runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if self.tmp is not None:
            self.tmp.cleanup()
            self.tmp = None


def roofline_step(rec):
    """(a) phase 20's qwen2-moe-2.7b step (2 layers, every width, bf16, 4 x
    1024 tokens): one warm step, then one under ``count_cost`` and
    torch.profiler; its report, and the same step's world-1 dry run on
    meta: the same FLOPs, bytes and regions, the argument bytes within 1%
    of what the card allocated for them, a bound no longer than the wall
    and 0 < mfu <= 1."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis import roofline as RL
    from repro_torch.analysis.op_cost import count_cost, top_ops
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.train_step import build_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW
    cfg = train_cfg(ELASTIC_LAYERS, "bfloat16")
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    built = build_train_step(cfg, shape)
    params = lm.init_params(cfg, seed=ELASTIC_SEED, device="cuda")
    state = {"params": params, "opt": AdamW().init(params), "step": 0}
    # token ids in int32, as the dry run makes them (launch/dryrun.py)
    batch = {k: v.to(torch.int32) for k, v in train_batch(cfg).items()}
    torch.cuda.synchronize()
    card_args = torch.cuda.memory_allocated() - base
    state, m = built["fn"](state, batch)               # warm
    float(m["loss"])
    torch.cuda.synchronize()
    reset_counts()
    with PlainGuard() as guard, count_cost() as cost, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = built["fn"](state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    # (a') the same step once more, untimed, under attribution
    reset_counts()
    t0 = time.perf_counter()
    with count_cost(attribute=True) as attr:
        state, m = built["fn"](state, batch)
        float(m["loss"])
    torch.cuda.synchronize()
    rec["attributed_wall_ms"] = (time.perf_counter() - t0) * 1e3
    attr_counts = read_counts()
    del state, params, m
    report = RL.analyze(cost, 1, cfg, shape,
                        RL.device_time_by_name(prof, wall))
    log(RL.fmt_report(f"{ARCH} x {ELASTIC_LAYERS} layers, {TRAIN_BATCH} x "
                      f"{TRAIN_SEQ} tokens, bf16, on the card", report))
    t0 = time.perf_counter()
    run, mem, assumed = dryrun.build_cell(cfg, shape, None)
    with dryrun.MetaOutputCache(), count_cost() as meta:
        run()
    meta_s = time.perf_counter() - t0
    meta_args = sum(v for k, v in mem.items() if k != "grad_bytes")
    same = {"flops": cost.flops == meta.flops,
            "bytes": cost.bytes == meta.bytes,
            "mxu_by_dtype": cost.mxu_by_dtype == meta.mxu_by_dtype,
            "regions": cost.regions == meta.regions}
    diff = [(str(k), v, meta.by_op.get(k)) for k, v in cost.by_op.items()
            if meta.by_op.get(k) != v]
    diff += [(str(k), None, v) for k, v in meta.by_op.items()
             if k not in cost.by_op]
    rec["step"] = {
        "layers": ELASTIC_LAYERS, "tokens": TRAIN_SEQ * TRAIN_BATCH,
        "loss": loss, "report": report, "launches": counts,
        "plain_calls_on_cuda": guard.cuda_calls,
        "meta": {"flops": meta.flops, "bytes": meta.bytes,
                 "mxu_by_dtype": meta.mxu_by_dtype, "regions": meta.regions,
                 "collective_bytes": meta.ici_bytes, "s": meta_s,
                 "memory": mem, "argument_bytes": meta_args,
                 "peak_temp_bytes": meta.peak_bytes, "assumed": assumed},
        "card_argument_bytes": card_args,
        "argument_rel_diff": abs(meta_args - card_args) / card_args,
        "same": same, "by_op_diff": diff[:20],
        "top_ops_by_bytes": top_ops(cost, "bytes", 8)}
    rel = rec["step"]["argument_rel_diff"]
    log("  card vs meta: " + json.dumps(same) + f"; argument bytes meta "
        f"{meta_args} card {card_args} (rel {rel:.2e}); meta dry run "
        f"{meta_s:.1f} s; launches {counts}")
    for row in diff[:20]:
        log(f"    op count differs: {row}")
    check(all(same.values()) and cost.ici_bytes == 0 == meta.ici_bytes,
          f"the card's count differs from the meta dry run's: {same}")
    check(rel <= 0.01,
          f"argument bytes {meta_args} (meta) against {card_args} (card)")
    check(report["bound_time_s"] * 1e3 <= report["wall_ms"],
          f"bound {report['bound_time_s'] * 1e3:.1f} ms above the wall "
          f"{report['wall_ms']:.1f} ms: the count is wrong")
    check(0 < report["mfu"] <= 1, f"mfu {report['mfu']}")
    L = ELASTIC_LAYERS
    for k in ("fused_mlp", "fused_mlp_dgrad", "fused_mlp_wgrad",
              "flash_attention"):
        check(counts[k] > 0 and counts[f"{k}_hopper"] == counts[k],
              f"{k}: {counts[k]} launches, {counts[f'{k}_hopper']} on the "
              f"Hopper path")
    check(counts["topk_combine"] == 2 * L and counts["rmsnorm"] > 0,
          f"launches {counts}")
    check(guard.cuda_calls == 0, "plain versions saw CUDA tensors")
    roofline_buckets(rec, cost, attr, attr_counts, run)


def roofline_buckets(rec, cost, attr, launches, run):
    """(a') the attributed count of the step on the card against the
    same step's on meta: the same buckets (FLOPs, products, bytes,
    calls), their sums the un-attributed count's totals, and each
    kernel's launches its region's calls, every one filed under the
    region's bucket or that bucket's ``bwd:``."""
    from repro_torch.analysis.attribute import fmt_rows
    from repro_torch.analysis.op_cost import (bucket_of, bucket_rows,
                                              count_cost)
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    with dryrun.MetaOutputCache(), count_cost(attribute=True) as meta:
        run()
    meta_s = time.perf_counter() - t0
    sums = {k: sum(r[k] for r in attr.by_bucket.values()) == getattr(cost, k)
            for k in ("flops", "mxu_flops", "bytes", "ici_bytes")}
    held = {}
    for k in attr.regions:
        held[k] = {"bucket": bucket_of(k), "launches": launches[k],
                   "calls": attr.regions[k]["calls"],
                   "filed": attr.region_buckets.get(k, {})}
    same = (attr.by_bucket == meta.by_bucket
            and attr.region_buckets == meta.region_buckets)
    rec["buckets"] = {"rows": bucket_rows(attr), "same_as_meta": same,
                      "sums_equal_totals": sums, "kernels": held,
                      "meta_s": meta_s}
    log("  the step's buckets on the card (attributed, untimed; GFLOP "
        "1e9, GiB 2**30):")
    log("\n".join("    " + ln
                  for ln in fmt_rows(bucket_rows(attr), 30).splitlines()))
    log(f"  buckets card vs meta: same {same}; "
        f"sums equal the totals {sums}; the attributed step "
        f"{rec['attributed_wall_ms']:.1f} ms (host clock, no profiler); "
        f"meta {meta_s:.1f} s; kernels "
        f"{json.dumps(held)}")
    for b in sorted(set(attr.by_bucket) | set(meta.by_bucket)):
        if attr.by_bucket.get(b) != meta.by_bucket.get(b):
            log(f"    bucket differs: {b} card {attr.by_bucket.get(b)} "
                f"meta {meta.by_bucket.get(b)}")
    check(same, "the card's buckets differ from the meta dry run's: "
                f"regions filed {attr.region_buckets} (card) against "
                f"{meta.region_buckets} (meta)")
    check(all(sums.values()), f"the buckets do not sum to the count: {sums}")
    check((attr.flops, attr.bytes, attr.regions) ==
          (cost.flops, cost.bytes, cost.regions),
          "the attributed step counts otherwise than the timed one")
    for k, h in held.items():
        b = h["bucket"]
        check(0 < h["launches"] == h["calls"] == sum(h["filed"].values())
              and set(h["filed"]) <= {b, "bwd:" + b},
              f"{k}: {h['launches']} launches, {h['calls']} region calls, "
              f"filed {h['filed']}: not all under {b} or bwd:{b}")


def roofline_cli(rec, cli):
    """(b) the dry-run CLI's cells (``DryrunCli``): every one ``ok``; (d)
    the attribution and override-climb runs: both exit 0, the
    attribution's rows sum to its totals, the climb's saved report names
    its overrides."""
    res = cli.collect()
    rec["dryrun_cli"] = {k: v for k, v in res.items()
                         if k in ROOFLINE_CELLS}
    rec["tools_cli"] = {k: v for k, v in res.items()
                        if k not in ROOFLINE_CELLS}
    for name, r in res.items():
        log(f"  {name} {ARCH}: rc {r['rc']}, {r['s']:.1f} s after its start")
        for ln in r["report"]:
            log("    " + ln)
        out = r["out"]
        if name in ROOFLINE_CELLS:
            for c in out or []:
                log("    " + json.dumps(c))
            ok = r["rc"] == 0 and [c["status"] for c in out or []] == ["ok"]
        elif name == "attribute":
            if out:
                from repro_torch.analysis.attribute import fmt_rows
                log("\n".join("    " + ln for ln in
                              fmt_rows(out["rows"]).splitlines()))
            rows = out["rows"] if out else []
            ok = r["rc"] == 0 and bool(rows) and all(
                abs(sum(row[i] for row in rows) - out["totals"][k])
                <= 1e-9 * max(1.0, out["totals"][k])
                for i, k in enumerate(("flops", "mxu_flops", "bytes",
                                       "ici_bytes"), 1))
        else:
            ok = (r["rc"] == 0 and out is not None
                  and out.get("overrides") == {"n_col": "2", "save": "1"}
                  and out.get("status") == "ok"
                  and any("'n_col': '2'" in ln for ln in r["report"]))
        check(ok, f"{name}: rc {r['rc']}\n" + "\n".join(r["log_tail"]))


def roofline_attributes(rec):
    """(c) every compiled kernel instance's registers, shared memory,
    spills and thread limit (``cudaFuncGetAttributes``) against its launch
    models (``kernel_check.check_attributes``)."""
    import torch

    from repro_torch.analysis.verify import kernel_check as KC
    from repro_torch.kernels import build
    attrs = build.kernel_attributes(build.load())
    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin",
                    KC.SMEM_PER_BLOCK)
    diags = KC.check_attributes(attrs, optin=optin)
    rec["attributes"] = {"optin_smem": optin, "instances": attrs,
                         "diagnostics": [d.to_json() for d in diags]}
    for a in attrs:
        log(f"    {a['source']:28s} regs {a['regs']:3d} static "
            f"{a['static_smem']:5d} local {a['local_bytes']:4d} max threads "
            f"{a['max_threads']:4d}  {a['label']}")
    for d in diags:
        log(f"    {d}")
    check(not diags, f"{len(diags)} kernel instances disagree with their "
          f"launch models")


def phase_roofline(state, out, cli):
    import torch
    state.clear()
    torch.cuda.empty_cache()
    rec = {}
    out["roofline"] = rec
    try:
        roofline_step(rec)
    finally:
        torch.cuda.empty_cache()
    roofline_attributes(rec)
    roofline_cli(rec, cli)


def phase_profile_hybrid(state, out):
    """phase_profile of phase 12's configuration, its weights drawn anew
    from the seed."""
    import torch

    from repro_torch.models import lm
    state.clear()
    torch.cuda.empty_cache()
    cfg = hybrid_cfg()
    params = lm.init_params(cfg, seed=0, device="cuda")
    phase_profile(cfg, params, out, "profile_serve_hybrid", **HYBRID_SERVE)


def phase_profile_paged(state, out):
    """phase_profile of phase 3's configuration with the contiguous cache
    and with the paged one (page 64, the parity pool), in turns
    (contiguous, paged, paged, contiguous), the weights drawn anew from
    the seed: the paged decode's gathers show in the indexing group."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    state.clear()
    torch.cuda.empty_cache()
    cfg = with_gemm(get_config(ARCH), "pallas_fused")
    params = lm.init_params(cfg, seed=0, device="cuda")
    res = {}
    for i, tag in enumerate(PAGED_TURNS):
        kw = {"page_size": PAGED_PAGE} if tag == "paged" else None
        phase_profile(cfg, params, res, f"{tag}{i}", engine_kw=kw)
    out["profile_serve_paged"] = res


def _pair_probe(path):
    """One rank of the two-NCCL-ranks-on-one-card probe: an all-reduce of
    a CUDA tensor; writes its outcome to ``path``.<rank>."""
    import torch
    import torch.distributed as dist
    rank = dist.get_rank()
    try:
        t = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        res = {"ok": True, "sum": t.tolist()}
    except Exception as e:            # the probe's outcome, recorded
        res = {"ok": False, "error": f"{type(e).__name__}: {e}"[:2000]}
    Path(f"{path}.{rank}").write_text(json.dumps(res))
    return 0 if res["ok"] else 1


# ---------------------------------------------------------------------------
# extra phase: the head's fp32 product on bf16 tensor cores
# ---------------------------------------------------------------------------

# one chunk of the training head: 2 x 1,024 rows, d 2,048, qwen2's vocab
HEAD_SHAPE = (2048, 2048, 151936)
HEAD_SEED = 11
# a product's max error against fp64 may be this many times the fp32
# cuBLAS product's (TF32 off)
HEAD_ERR_RATIO = 4.0
# the head's scale over 1/sqrt(d): logits of about unit spread, as at
# initialisation, and four times that, a softmax peaked as a model's that
# has learned (its gradient's large entries then carry all their bits)
HEAD_SCALES = {"init": 1.0, "peaked": 4.0}
# the longest K of one tensor-core pass, swept (``common.K_PASS`` among
# them is the one the path takes)
HEAD_K_PASSES = (512, 1024, 2048, 4096, 8192)


def _max_rel(got, want):
    """max |got - want| over max |want|, want in fp64."""
    return float((got.double() - want).abs().max() / want.abs().max())


def _head_errors(a, b, G):
    """Max relative errors against fp64 of the logits a @ b, dh = G @ b.T
    and dW = a.T @ G: the fp32 cuBLAS product of the widened operands
    (``fp32``), the tensor-core path in passes of each of
    ``HEAD_K_PASSES`` along K (``k<n>``; ``new`` the one of
    ``common.K_PASS``), and two controls: G rounded once to bf16
    (``one_piece``) and dh's three pieces in one pass over the whole vocab
    (``one_pass``)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import common
    errs = {}
    with torch.no_grad():
        want = a.double() @ b.double()
        e = errs["logits"] = {"fp32": _max_rel(a.float() @ b.float(), want)}
        for k in HEAD_K_PASSES:
            e[f"k{k}"] = _max_rel(common._mm_f32(a, b, k_pass=k), want)
        del want
        want = G.double() @ b.double().t()
        e = errs["dh"] = {"fp32": _max_rel(G @ b.float().t(), want)}
        for k in HEAD_K_PASSES:
            e[f"k{k}"] = _max_rel(common.split_grads_f32(
                a, b, G, (True, False), k)[0], want)
        e["one_piece"] = _max_rel(common._mm_f32(G.bfloat16(), b.t()), want)
        p = torch.mm(ops.split3_bf16(G).view(-1, G.shape[1]), b.t(),
                     out_dtype=torch.float32).view(3, *a.shape)
        e["one_pass"] = _max_rel((p[0] - p[1]) - p[2], want)
        del want, p
        want = a.double().t() @ G.double()
        e = errs["dW"] = {"fp32": _max_rel(a.float().t() @ G, want)}
        for k in HEAD_K_PASSES:
            e[f"k{k}"] = _max_rel(common.split_grads_f32(
                a, b, G, (False, True), k)[1], want)
        e["one_piece"] = _max_rel(common._mm_f32(a.t(), G.bfloat16()), want)
        del want
    for e in errs.values():
        e["new"] = e[f"k{common.K_PASS}"]
    torch.cuda.empty_cache()
    return errs


def phase_head_product(state, out):
    """The head's logits, dh and dW (``models/common.bf16_exact_mm``, its
    backward's ``split_grads_f32``) at the training cell's chunk shape,
    against fp64, for a head at each of ``HEAD_SCALES`` and passes along K
    of each of ``HEAD_K_PASSES``: at ``common.K_PASS`` each max relative
    error at most ``HEAD_ERR_RATIO`` times the fp32 cuBLAS product's; the
    gradient rounded once to bf16 (the control) misses that limit in dh
    and dW of the peaked softmax. Then the forward and the backward's
    products a chunk at each K pass, the present (widened fp32) and the
    new path's forward and backward a chunk in turns, all with CUDA
    events, and the split alone (``csrc/split3.cu``, its bits those of the
    plain version); and one traced, profiled train step of qwen2-moe-2.7b
    at the training cell's 4 layers and 2 x 4,096 tokens (4 chunks),
    counters zeroed just before it: 8 ``bf16_exact`` head products and no
    fp32 one, 4 split launches, and its device time by kernel."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.analysis import roofline as RL
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.train_step import build_train_step
    from repro_torch.models import common, lm
    from repro_torch.optim.adamw import AdamW
    for key in list(state):                    # earlier phases' weights
        state.pop(key)
    torch.cuda.empty_cache()
    check(common.K_PASS in HEAD_K_PASSES,
          f"K_PASS {common.K_PASS} is not among the swept {HEAD_K_PASSES}")
    rec = out["head_product"] = {"shape": list(HEAD_SHAPE), "errors": {},
                                 "k_passes": list(HEAD_K_PASSES),
                                 "k_pass": common.K_PASS}
    rows, d, V = HEAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(HEAD_SEED)
    # the final norm's unit-scale rows
    a = torch.randn(rows, d, device="cuda", generator=gen).bfloat16()
    w = torch.randn(d, V, device="cuda", generator=gen)
    labels = torch.randint(0, V, (rows,), device="cuda", generator=gen)
    for dist, scale in HEAD_SCALES.items():
        b = (w * (scale * d ** -0.5)).bfloat16()
        with torch.no_grad():
            # the logits' gradient as the chunk's backward gives it:
            # softmax less one-hot, over the count
            G = torch.softmax(a.float() @ b.float(), -1)
            G[torch.arange(rows, device="cuda"), labels] -= 1.0
            G /= rows
        errs = rec["errors"][dist] = _head_errors(a, b, G)
        for name, e in errs.items():
            log(f"  {dist} {name}: max rel err against fp64 (x fp32's): "
                + ", ".join(f"{k} {v:.3e} ({v / e['fp32']:.2f})"
                            for k, v in e.items() if k != "new"))
        for name, e in errs.items():
            check(e["new"] <= HEAD_ERR_RATIO * e["fp32"],
                  f"{dist} {name}: {e['new']:.3e} > {HEAD_ERR_RATIO} x "
                  f"fp32's {e['fp32']:.3e}")
            if dist == "peaked" and "one_piece" in e:
                check(e["one_piece"] > HEAD_ERR_RATIO * e["fp32"],
                      f"{dist} {name}: the one-piece control passes the "
                      f"limit")
        if dist != "peaked":
            del G
    del w

    # the tensor-core products a chunk at each K pass
    sweep = rec["k_pass_ms"] = {}
    for k in HEAD_K_PASSES:
        with torch.no_grad():
            sweep[k] = {
                "fwd_ms": median_ms(
                    lambda: common._mm_f32(a, b, k_pass=k), iters=5,
                    warmup=1),
                "bwd_ms": median_ms(
                    lambda: common.split_grads_f32(a, b, G, (True, True), k),
                    iters=5, warmup=1)}
        torch.cuda.empty_cache()
        log(f"  K pass {k}: forward {sweep[k]['fwd_ms']:.3f} ms, backward's "
            f"split and products {sweep[k]['bwd_ms']:.3f} ms, a chunk")

    def fwd(path):
        return (lambda: a.float() @ b.float()) if path == "fp32" else \
            (lambda: common.bf16_exact_mm(a, b))

    def bwd(path):
        ag, bg = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = (ag.float() @ bg.float() if path == "fp32"
             else common.bf16_exact_mm(ag, bg))
        return lambda: torch.autograd.grad(y, (ag, bg), G,
                                           retain_graph=True)

    times = rec["times"] = {}
    for path in ("fp32", "new", "new", "fp32"):
        with torch.no_grad():
            f = median_ms(fwd(path), iters=5, warmup=1)
        bk = median_ms(bwd(path), iters=5, warmup=1)
        torch.cuda.empty_cache()
        times.setdefault(path, []).append({"fwd_ms": f, "bwd_ms": bk})
    with torch.no_grad():
        same = torch.equal(ops.split3_bf16(G).view(torch.int16),
                           ref.split3_bf16_ref(G).view(torch.int16))
        rec["split_bits_equal"] = same
        for key, split in (("split_ms", ops.split3_bf16),
                           ("split_plain_ms", ref.split3_bf16_ref)):
            rec[key] = median_ms(lambda: split(G), iters=5, warmup=1)
    flop = 2 * rows * d * V
    for path, runs in times.items():
        f = statistics.median(r["fwd_ms"] for r in runs)
        bk = statistics.median(r["bwd_ms"] for r in runs)
        log(f"  {path}: forward {f:.3f} ms ({flop / f / 1e9:.1f} TFLOP/s of "
            f"the fp32 product), backward {bk:.3f} ms, a chunk")
    bound_ms = RL.split3_cost(G.numel()).bound_s()[0] * 1e3
    log(f"  the split alone: kernel {rec['split_ms']:.3f} ms, plain "
        f"{rec['split_plain_ms']:.3f} ms a chunk (bound {bound_ms:.3f} ms); "
        f"the same bits: {same}")
    check(same, "the split kernel's pieces differ from the plain version's")
    del G, a, b
    torch.cuda.empty_cache()

    # the training cell's step: 4 layers, 2 x 4,096 tokens (4 chunks)
    cfg = train_cfg(4, "bfloat16")
    params = lm.init_params(cfg, seed=HEAD_SEED, device="cuda")
    fn = build_train_step(cfg, ShapeConfig("train", 4096, 2, "train"),
                          optim=AdamW())["fn"]
    tstate = {"params": params, "opt": AdamW().init(params), "step": 0}
    nb = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4096),
                                  device="cuda", generator=gen)}
    nb["labels"] = torch.roll(nb["tokens"], -1, 1)
    tstate, m = fn(tstate, nb)                             # warm-up
    float(m["loss"])
    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            tracing.recording():
        t0 = time.perf_counter()
        tstate, m = fn(tstate, nb)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = tracing.drain()
    counts = read_counts()
    heads = {k: counts[k] for k in ("split3", "head_bf16_exact",
                                    "head_fp32")}
    prof_rec = RL.device_time_by_name(prof, wall)
    rec["train_step"] = {"counts": heads, "loss": loss,
                         "head_spans": sum(sp[0] == "model.head"
                                           for sp in spans),
                         "profile": prof_rec}
    log(f"  one traced train step (4 layers, 2 x 4096): {heads}, loss "
        f"{loss:.4f}, wall {wall * 1e3:.1f} ms, device "
        f"{prof_rec['device_ms']:.1f} ms")
    for r in prof_rec["top"]:
        log(f"    {r['ms']:9.3f} ms {r['calls']:6d}x  {r['kernel']}")
    want = head_launches(cfg, 4096, 1)
    check(heads == want == {"split3": 4, "head_bf16_exact": 8,
                            "head_fp32": 0},
          f"a train step's head counts {heads}, expected {want}")
    check(math.isfinite(loss), "non-finite loss")
    del tstate, params, fn
    torch.cuda.empty_cache()


def phase_nccl_pair(out):
    """Two NCCL ranks on the one card: what NCCL does with them."""
    import tempfile

    from repro_torch.launch import selftest
    with tempfile.TemporaryDirectory() as tmp:
        base = f"{tmp}/probe"
        try:
            selftest.spawn(2, _pair_probe, (base,), device="cuda",
                           timeout=120.0)
            spawn = "ok"
        except (RuntimeError, TimeoutError) as e:
            spawn = f"{type(e).__name__}: {e}"
        ranks = {r: json.loads(Path(f"{base}.{r}").read_text())
                 for r in range(2) if Path(f"{base}.{r}").exists()}
    out["nccl_pair"] = {"spawn": spawn, "ranks": ranks}
    log("  two NCCL ranks on one card: " + json.dumps(out["nccl_pair"]))


def profile_step(state, key, out_key, out):
    """Device time by kernel name over one train step of a train phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.roofline import device_time_by_name
    tr, tstate, batch = state[key]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tstate, m = tr.built["fn"](tstate, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    state[key] = (tr, tstate, batch)
    out[out_key] = device_time_by_name(prof, wall)
    log(f"  train step: wall {wall * 1e3:.1f} ms, device "
        f"{out[out_key]['device_ms']:.1f} ms")
    for r in out[out_key]["top"]:
        log(f"    {r['ms']:9.3f} ms {r['calls']:6d}x  {r['kernel']}")
    for g, r in out[out_key]["groups"].items():
        log(f"    {r['ms']:9.3f} ms {r['calls']:6d}x  [{g}]")
    check(out[out_key]["device_ms"] > 0,
          "the profiler recorded no device time")


def phase_profile(cfg, params, out, out_key, max_seq=1024, prompt_max=512,
                  engine_kw=None):
    """Device time by kernel name over one admission round (prefill) and 8
    decode steps of a serve configuration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.roofline import device_time_by_name
    from repro_torch.launch.serve import make_trace
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(cfg, params=params, max_seq=max_seq, batch_size=8,
                      chunk=256, device="cuda", **(engine_kw or {}))
    for p in make_trace(cfg.vocab_size, 8, 64, prompt_max, 5):
        eng.submit(p, max_new=32)
    res = {}
    for name, work in (("prefill", lambda: eng._admit_batch(
            eng._gather_admissions())),
                       ("decode", lambda: [eng._decode_once()
                                           for _ in range(8)])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        res[name] = device_time_by_name(prof, wall)
        dev_ms = res[name]["device_ms"]
        log(f"  {name}: wall {wall * 1e3:.1f} ms, device {dev_ms:.1f} ms")
        for r in res[name]["top"]:
            log(f"    {r['ms']:9.3f} ms {r['calls']:6d}x  {r['kernel']}")
        for g, r in res[name]["groups"].items():
            log(f"    {r['ms']:9.3f} ms {r['calls']:6d}x  [{g}]")
    out[out_key] = res
    check(all(r["device_ms"] > 0 for r in res.values()),
          "the profiler recorded no device time")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def kernel_records(out):
    """One record per kernel: times and error at the prefill step's bf16
    shape, launches from the serving run that exercises it."""
    head = {"fused_mlp": "R=160 expert_major",
            "grouped_gemm": "gemm1 expert_major",
            "topk_combine": "T=2048",
            "fused_mlp_dgrad": "R=320 swiglu",
            "fused_mlp_wgrad": "R=320 swiglu",
            "flash_attention": "train B4 H16 S1024 hd128",
            "ssd_forward": "train B4 S2048 nh48 hd64 ds128",
            "rmsnorm": "T=2048 d=1536 model"}
    src = {"fused_mlp": "serve", "grouped_gemm": "serve_pallas",
           "topk_combine": "serve", "rmsnorm": "serve_ssm"}

    def case_rec(name, case):
        return next((r for r in out.get("kernel_cases", [])
                     if r["kernel"] == name and r["dtype"] == "bf16"
                     and r["case"] == case), {})

    recs = []
    for name, case in head.items():
        c = case_rec(name, case)
        phase = "train_ssm" if name == "ssd_forward" else "train"
        run = (out.get(phase, {}).get("train", {}) if name not in src
               else out.get(src[name], {}))
        extra = {}
        if name in ("grouped_gemm", "rmsnorm"):   # the decode shape
            dc = case_rec(name, "decode gemm1 M=4 expert_major"
                          if name == "grouped_gemm" else "T=8 d=1536 model")
            extra = {"decode_ms": dc.get("ms"),
                     "decode_bound_ms": dc.get("bound_ms"),
                     "decode_library_ms": dc.get("library_ms")}
        for key in ("general_ms", "device_ms", "library_device_ms",
                    "back_to_back_ms"):
            if key in c:
                extra[key] = c[key]
        if name in HOPPER:            # launches on the Hopper path
            extra["hopper_launches"] = run.get("launches", {}).get(
                f"{name}_hopper", 0)
        mesh_l = out.get("mesh_train", {}).get("train", {}).get(
            "launches", {})
        if mesh_l:                    # the mesh train step's 3 steps
            extra["mesh_train_launches"] = mesh_l.get(name, 0)
        plan_l = out.get("plan", {}).get("train", {}).get("runs", {}).get(
            "cache", {}).get("launches", {})
        if plan_l:                    # 3 train steps on the cached plan
            extra["plan_train_launches"] = plan_l.get(name, 0)
        hybrid_l = out.get("serve_hybrid", {}).get("launches", {})
        if hybrid_l:                  # jamba-v0.1-52b served at one period
            extra["serve_hybrid_launches"] = hybrid_l.get(name, 0)
        mesh_s = out.get("mesh_serve", {}).get("runs", {}).get(
            "mesh1", {}).get("launches", {})
        if mesh_s:                    # phase 3's engine on a (1, 1) mesh
            extra["mesh_serve_launches"] = mesh_s.get(name, 0)
        paged_l = out.get("serve_paged", {}).get("runs", {}).get(
            "paged1", {}).get("launches", {})
        if paged_l:                   # phase 3's engine, the paged cache
            extra["serve_paged_launches"] = paged_l.get(name, 0)
        life_l = out.get("serve_lifecycle", {}).get("runs", {}).get(
            "faults", {}).get("launches", {})
        if life_l:                    # phase 15's run under the fault plan
            extra["serve_lifecycle_launches"] = life_l.get(name, 0)
        sched = out.get("train_scheduled", {}).get("steps", {})
        if sched:                     # a train step of each order, phase 17
            extra["train_scheduled_launches"] = {
                m: r["launches"].get(name, 0) for m, r in sched.items()}
        pre = out.get("prefill", {})
        if pre:                       # phase 18's monolithic prefills
            extra["prefill_launches"] = {
                k: r["monolithic"]["launches"].get(name, 0)
                for k, r in pre.items()}
            extra["prefill_mesh_1x1_launches"] = {
                k: r["mesh_1x1"]["arms"]["mesh"]["launches"].get(name, 0)
                for k, r in pre.items() if "mesh_1x1" in r}
        pcase = {"fused_mlp": PREFILL_MLP_CASE,
                 "flash_attention": PREFILL_FLASH_CASE,
                 "ssd_forward": PREFILL_SSD_CASE}.get(name)
        if pcase:                     # phase 2 at phase 18's shape
            extra["prefill_case"] = {"case": pcase, **{
                k: case_rec(name, pcase).get(k) for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_ms", "general_ms", "path")}}
        if name == "flash_attention":  # phase 2 at phase 19's shapes
            extra["whisper_cases"] = {
                case: {k: case_rec(name, case).get(k) for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_ms", "library_device_ms", "path",
                    "draws_max_abs_err", "general_max_abs_err")}
                for case in WHISPER_FLASH_CASES}
            wh = out.get("whisper", {})
            extra["whisper_launches"] = {
                "train_3_steps": wh.get("train", {}).get("launches", {})
                .get(name), "prefill_3_calls": wh.get("serve", {}).get(
                    "prefill_launches", {}).get(name),
                "mesh_1x1_fp32_prefill": wh.get("fp32_mesh_1x1", {}).get(
                    "arms", {}).get("mesh", {}).get("launches", {})
                .get(name),
                "mesh_1x1_bf16_grads": wh.get("bf16_mesh_1x1", {}).get(
                    "launches", {}).get("mesh", {}).get(name)}
        if name in HYBRID_CASES:      # phase 2 at phase 12's shapes
            extra["serve_hybrid_cases"] = {
                case: {k: case_rec(name, case).get(k) for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_ms", "path")}
                for case in HYBRID_CASES[name]}
        if name == "ssd_forward":     # the serving chunk, with a state
            sc = case_rec(name, "serve state A8 C256 nh48 hd64 ds128")
            serve_l = out.get("serve_ssm", {}).get("launches", {})
            extra.update({"serve_ms": sc.get("ms"),
                          "serve_device_ms": sc.get("device_ms"),
                          "serve_general_ms": sc.get("general_ms"),
                          "serve_bound_ms": sc.get("bound_ms"),
                          "serve_plain_ms": sc.get("plain_ms"),
                          "serve_launches": serve_l.get(name, 0),
                          "serve_hopper_launches": serve_l.get(
                              f"{name}_hopper", 0)})
        recs.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      + SOURCES.get(name, f"{name}.cu"),
            "replaces": REPLACES[name],
            "launches": run.get("launches", {}).get(name, 0),
            "max_abs_err": c.get("max_abs_err"), "ms": c.get("ms"),
            "plain_ms": c.get("plain_ms"), "bound_ms": c.get("bound_ms"),
            "bound_by": c.get("bound_by"), "library_ms": c.get("library_ms"),
            "at": f"bf16 {case}",
            **({"path": c["path"]} if "path" in c else {}), **extra})
    return recs


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi unavailable"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    ap.add_argument("--kernels", default="",
                    help="phase 2 only: comma-separated kernels to check "
                         f"(default all of {tuple(REPLACES)})")
    args = ap.parse_args(argv)
    only_kernels = tuple(k for k in args.kernels.split(",") if k)
    if set(only_kernels) - set(REPLACES):
        ap.error(f"unknown kernels {sorted(set(only_kernels) - set(REPLACES))}")
    phases = [p for p in args.only.split(",") if p]
    unknown = set(phases) - set(PHASES + EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.device import resolve_device
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the repo's package is missing ({e})",
              file=sys.stderr)
        return 2
    resolve_device("cuda")                     # TF32 off for fp32 products
    card = card_line()
    out = {"card": card, "torch": torch.__version__,
           "cuda": torch.version.cuda, "phases": {}}
    state = {}
    t_all = time.perf_counter()
    failed = []
    # phase 21 (b) runs on the host's CPU only: start it now, beside the
    # card's phases, and collect it in phase 21
    dryrun_cli = DryrunCli()
    if "roofline" in phases:
        dryrun_cli.start()
    # each profile phase right after the phase whose state it profiles;
    # serve_ssm, train and train_ssm free the earlier phases' weights and
    # state
    order = ("build", "kernels", "rule_seeds", "serve", "logits", "pallas",
             "profile", "serve_ssm", "profile_serve_ssm", "train",
             "profile_train", "train_ssm", "profile_train_ssm", "ranked",
             "mesh_train", "plan", "serve_hybrid", "profile_serve_hybrid",
             "mesh_serve", "serve_paged", "profile_serve_paged",
             "serve_lifecycle", "serve_disagg", "train_scheduled", "prefill",
             "whisper", "elastic", "roofline", "stack_bits", "head_product",
             "nccl_pair")
    for name in order:
        if name not in phases:
            continue
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            if name == "build":
                log(f"  card: {card}")
                lib = build.load()
                out["build_s"] = lib.build_s
                log(f"  kernels built in {lib.build_s:.1f} s -> {lib.path}")
                log("\n".join(line for line in lib.log.splitlines()
                              if "registers" in line or "==" in line))
            elif name == "kernels":
                phase_kernels(out, only_kernels)
            elif name == "rule_seeds":
                phase_rule_seeds(out)
            elif name == "serve":
                phase_serve(state, out)
            elif name == "logits":
                check("params" in state, "needs the serve phase")
                phase_logits(state, out)
            elif name == "pallas":
                check("params" in state, "needs the serve phase")
                phase_pallas(state, out)
            elif name == "profile":
                check("params" in state, "needs the serve phase")
                phase_profile(state["cfg"], state["params"], out, "profile")
            elif name == "serve_ssm":
                phase_serve_ssm(state, out)
            elif name == "profile_serve_ssm":
                check("ssm_serve" in state, "needs the serve_ssm phase")
                phase_profile(*state["ssm_serve"], out, "profile_serve_ssm",
                              **SSM_SERVE)
            elif name == "train":
                phase_train(state, out)
            elif name == "profile_train":
                check("train" in state, "needs the train phase")
                profile_step(state, "train", "profile_train", out)
            elif name == "train_ssm":
                phase_train_ssm(state, out)
            elif name == "profile_train_ssm":
                check("train_ssm" in state, "needs the train_ssm phase")
                profile_step(state, "train_ssm", "profile_train_ssm", out)
            elif name == "ranked":
                phase_ranked(state, out)
            elif name == "mesh_train":
                phase_mesh_train(state, out)
            elif name == "plan":
                phase_plan(state, out)
            elif name == "serve_hybrid":
                phase_serve_hybrid(state, out)
            elif name == "profile_serve_hybrid":
                phase_profile_hybrid(state, out)
            elif name == "mesh_serve":
                phase_mesh_serve(state, out)
            elif name == "serve_paged":
                phase_serve_paged(state, out)
            elif name == "profile_serve_paged":
                phase_profile_paged(state, out)
            elif name == "serve_lifecycle":
                phase_serve_lifecycle(state, out)
            elif name == "serve_disagg":
                phase_serve_disagg(state, out)
            elif name == "train_scheduled":
                phase_train_scheduled(state, out)
            elif name == "prefill":
                phase_prefill(state, out)
            elif name == "whisper":
                phase_whisper(state, out)
            elif name == "elastic":
                phase_elastic(state, out)
            elif name == "roofline":
                phase_roofline(state, out, dryrun_cli)
            elif name == "stack_bits":
                phase_stack_bits(state, out)
            elif name == "head_product":
                phase_head_product(state, out)
            elif name == "nccl_pair":
                phase_nccl_pair(out)
            status = "ok"
        except Exception as e:                 # report, then fail the run
            import traceback
            traceback.print_exc()
            status = f"failed: {type(e).__name__}: {e}"
            failed.append(name)
        out["phases"][name] = {"status": status,
                               "s": time.perf_counter() - t0}
        log(f"  phase {name}: {status} ({time.perf_counter() - t0:.1f} s)")
    dryrun_cli.stop()
    out["wall_s"] = time.perf_counter() - t_all
    out["kernels"] = kernel_records(out)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    tag = "" if phases == list(PHASES) else "_" + "_".join(phases)
    if only_kernels:
        tag += "_" + "_".join(only_kernels)
    (dest / f"chip_smoke{tag}.json").write_text(json.dumps(out, indent=1))
    if failed:
        log(f"chip_smoke: phases failed: {failed}")
        return 1
    print(json.dumps({"kernels": out["kernels"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
