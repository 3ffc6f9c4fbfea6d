#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (paddle_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card; exits non-zero (printing no result) without one, or
when run outside a checkout of the repository. Phases, each of which
fails the run:

1. build the hand-written kernels from paddle_tpu_torch/csrc (nvcc, all
   sources in parallel) and print their register / shared-memory report;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (float32; attention within 1e-4 abs,
   w8a16 within 1e-4 x max|ref|), then time kernel, plain version and
   one PyTorch library call, beside the bytes/FLOP bound of the H100:
   ragged paged attention over float32 pages and over int8 pages (the
   same mixed step through the split-KV body: bitwise equal across two
   calls; timed warm and with L2 flushed between calls, the flushed
   times in the kernels line), dense decode attention, and the w8a16
   matmul at 1, 8, 16 and 256 rows for every projection of the model
   and its head (bitwise equal across two calls; warm and L2 flushed);
3. serve 12 greedy requests end to end through
   ``SpeculativeEngine(k=0)`` at the full width of the repo's default
   GPTConfig (vocab 50304, d 1024, 24 layers, 16 heads, FFN 4096, tied
   head, float32, random weights from --seed) over a pool small enough
   to preempt, with token-budget mixed steps; the ragged kernel must
   launch once per layer per model call;
4. hold the paged engine against the dense ContinuousBatchingEngine
   (decode through the decode-attention kernel) on 4 of the prompts,
   hidden row by hidden row, and greedy tokens up to the first step
   whose top-two logit gap is below the tolerance;
5. quantized serving at the same width: FusedMultiTransformerInt8 with
   an int8 head, int8 KV pages and the prefix cache, 12 requests that
   share a 256-token system prompt, over a pool small enough to preempt;
   the int8 ragged kernel launches once per layer per model call, the
   w8a16 kernel for all 4 projections of every layer in every model
   call of <= 256 rows and for every head call;
6. quantized against float on the same float weights, teacher-forced
   with phase 4's tokens, under the JAX package's documented bounds:
   int8 KV pages (hidden within 0.05 x max|h|), int8 weights (0.1
   relative), the int8 head (logits within 2%);
7. prefix adoption on the fp32 pool: the shared-prompt requests with the
   prefix cache and without agree within 1e-5 x max|h|;
8. the grouped GEMM (gmm) against its plain version at the MoE slice's
   shapes — decode (8 experts x capacity 8 rows) and a 520-row mixed
   call (8 x 168 rows), for the expert ffn1 and ffn2 — within 1e-4 x
   max|ref| and bitwise equal from run to run, then timed warm and with
   L2 flushed beside its bound (the 3xTF32 tensor-core floor, the
   float32 SIMT figure beside it), the plain version and torch.bmm over
   the equal-capacity layout; the kernels line holds a mixed call's
   ffn1 + ffn2, L2 flushed;
9. MoE serving: an 8-expert top-2 MoeServingCore at the same widths
   (expert FFN 4096, capacity factor 1.25, block_m 8) serves phase 3's
   12 prompts through SpeculativeEngine(k=0) with phase 3's pool and
   budget; the scheduling counts must equal phase 3's, gmm must launch
   2 x 24 x model calls, and moe.* must be in the registry after every
   round;
10. per layer, on the same rows (a decode batch with inactive zero rows
   and 512 rows), the gmm path and the per-expert fold route alike and
   agree within 1e-5 x max|out|; shard_experts(2) is bitwise equal to the
   unsharded fold over one whole forward; a decode-sized and a
   mixed-sized call of each model are profiled (host wall, device busy,
   costliest kernels);
11. speculative decoding: the dense model with a 6-layer truncated draft
   at k=4 emits phase 4's greedy tokens up to the first near-tie; the
   MoE model with its 6-layer MoE draft at k=2 serves the same 4 prompts
   with both pools' invariants held;
12. the training slice's kernels against their plain versions on the
   card: flash attention forward and backward (bf16 causal [16, 2048,
   32, 128], each query row of out and dq and each key row of dk and dv
   within 3e-2 x that row's max|ref|, lse within 1e-4, the plain
   backward two batch rows at a time; dq, dk, dv bitwise equal across
   two calls; float32 tail, cross-length and dropout cases within 1e-4
   and their bf16 twins per row within 3e-2; the ptxas report of the
   wgmma kernels, the gmm tile kernel, the split-KV ragged kernels over
   float and int8 pools and the w8a16 kernels: registers, and no
   spills),
   the fused RMSNorm at [32768, 4096] bf16 with and without the residual
   (one bf16 ulp; the residual stream bitwise), the fused AdamW over the
   12 leaves of the trainer (m, v, master within 1e-6 x max|ref|); each
   timed with CUDA events beside its bound, its plain version (flash: at
   batch 2) and one PyTorch call (sdpa, F.rms_norm,
   torch.optim.AdamW(fused=True));
13. training at bench.py's Llama-2-7B proxy widths (vocab 32000, hidden
   4096, FFN 11008, 32 heads, 2 layers, seq 2048, batch 16, bf16, fp32
   moments, remat off, chunked CE; random weights from --seed): 1
   warm-up and 5 steps on one batch, every loss finite and the last
   below the first; per step the flash kernels launch once per layer
   each, RMSNorm twice per layer and AdamW once per leaf (12); tokens/s,
   MFU, peak memory and a profile of one step;
14. the kernel path against the plain path at the same widths (batch 2)
   from equal weights: the loss, every gradient, and params and masters
   after one step, within the bounds stated below;
15. the BERT slice's kernels against their plain versions at its shapes,
   float32 and bf16: LayerNorm with and without the residual at [4096,
   768] (float32 within 1e-5 x max|ref|, bf16 one ulp, the residual
   stream bitwise, the backward within 1e-5), dropout at p 0.1 over
   [4096, 768] and [4096, 3072] (output and backward bitwise, kept share
   within 1e-3 of 0.9); each timed (profiler device sums) beside its
   bound, its plain version and one PyTorch call (add + F.layer_norm,
   F.dropout);
16. BERT-base pretraining as bench_extra.py's config #2 (vocab 30522,
   hidden 768, 12 layers, 12 heads, FFN 3072, dropout 0.1, batch 32 x
   128, 85% of the MLM labels -100, AdamW(1e-4), FLAGS_tpu_fused_encoder
   on, float32; random weights from --seed): 1 warm-up and 10 steps on
   one batch, every loss finite and the last below the first; per step
   dropout launches 2 x (1 + 3 x 12) times and LayerNorm 2 x 12 times;
   sequences/s, MFU against the fp32 non-tensor peak, peak memory and a
   profile of one step;
17. the kernel path on the card against the plain path on the CPU at
   full width (batch 2, hidden dropout 0.1, attention dropout 0, the
   same weights and seeds): loss within 1e-5 relative, every gradient
   within 1e-3 x max|g| with cosine >= 0.9999;
18. (run after phase 11, while the dense model is resident) fork-shared
   parallel decoding at the same width over phase 3's pool shape:
   phase 11's 4 prompts each submitted with n=4, every branch emitting
   phase 4's greedy tokens up to the first near-tie, parallel.groups 4,
   branches 12, prefill_tokens_saved 3 x the prompts' lengths, the
   ragged kernel 24 times per model call; the lane oracle (a top-k
   group seeded S against 4 lone submits seeded branch_lane_seed(S, i),
   equal up to the first draw within TOL_LANE of a CDF edge, at least
   two branches distinct); a 2-page + 5-token prompt's group after 3
   decode tokens on a float pool and on an int8 pool with the prefix
   cache (full pages shared by all 4 tables, 4 distinct tails, engine
   and deep pool audits); a greedy int8 group against the lone int8
   stream up to its near-tie; best-of n=3 at page capacity (one
   winner, 2 CANCELLED, the pool whole after release); fork_stream
   under k=4 speculation against phase 4's tokens and a stateful
   grammar mask over the whole vocabulary under top-k speculation;
   then, printed only, one group against 4 lone submits at equal pool
   bytes;
19. (run after phase 18) the serving stack's snapshots, slices, faults,
   deadlines, tenants and per-phase steps at the same width over phase
   3's traffic and pool: a snapshot at the first step with a request
   mid-prefill and a preempted one queued, restored into a fresh engine
   on the card (every stream phase 3's over all 32 tokens, the
   scheduling after the cut the uninterrupted run's, the deep audit
   held; snapshot bytes and times printed), with a queued request whose
   deadline_steps fails it at the step the rule gives while the other
   12 are unchanged; on phase 5's int8 pool with the prefix cache, a
   delta snapshot shipping fewer rows than a full one (base + delta
   restore the same live pages bitwise) and rehoming into a larger and
   a smaller pool (cached-free pages dropped); a running request moved
   to a second engine by export_slice / import_slice and
   submit(resume=True); a CrashInjector crash at post_prefill re-driven
   from the last step-boundary snapshot (streams phase 3's); a seeded
   FaultInjector storm (on a pool with room for all 12 requests and no
   retry budget, so each eviction is a forced shed: >= 3 sheds and >= 2
   NaN failures at the schedule's steps and slots, no quarantined page
   in a later snapshot); a draft-pool OOM and corrupted draft logits
   under k=4;
   a quota'd flooder tenant beside two tenants with floors (every flood
   request rejected or shed at its quota); and phase 3's traffic with
   ragged_step=False (one launch per layer per chunk and per decode
   step, as the plan predicts; tokens/s printed only). Streams whose
   batching differs from phase 3's (5's) are held to its tokens up to
   their first near-tie, computed here by phase 4's rule;
20. (run after phase 19) durability and observability at the same
   width: phase 3's traffic with a TraceCollector, a HealthMonitor and
   a CostLedger attached (phase 3's streams and counts; the ledger's
   rows, skipped rows and replay waste equal to the engine's counters;
   the Chrome trace, the cost report and the health report read by
   tools/trace_report.py, cost_report.py and health_report.py, each
   exiting 0; step-phase shares, TTFT / TPOT, goodput and alerts
   printed), then durable crash storms through RecoverableServer
   (fsync'd journal and snapshots in a temporary directory; a seeded
   schedule of post_admission, post_prefill, pre_journal and
   post_journal crashes, each recovered from the files with a fresh
   collector, monitor and ledger and audited): the float engine (phase
   3's streams), the quantized engine with the prefix cache (phase 5's)
   and k=4 with the 6-layer draft plus a mid_spec_round crash (phase
   11's, hence phase 4's up to its near-tie); every outcome delivered
   exactly once; snapshot bytes, save, load, replay and recovery
   seconds and journal records and bytes printed;
21. (run after phase 20) the serving fleet at the same width: one spec
   (phase 3's widths, pool and budgets, a rolled readout, seeds from
   --seed) serves phase 3's 12 prompts from an in-process server (the
   baseline), then from three socket workers (one prefill-role, two
   decode-role; spawned processes, each with its own CUDA context
   running the ragged kernel) behind a prefix-aware Router that
   migrates every finished prefill as a page slice (each request
   placed on the prefill worker migrates once); then the same fleet
   under a FleetSupervisor through a seeded router kill and a real
   SIGKILL of a decode worker, each corpse respawned from its journal
   and snapshot (back at 3 of 3 live, a spawn/rejoin pair in the
   router journal for each); then a seeded network storm over the
   resilient sockets (drops, torn and corrupt frames, a black-holed
   reply) with no respawn. Each leg ends with the baseline's streams
   (up to a stream's first near-tie, phase 4's rule), every outcome
   delivered once and every worker's audit ok; children's start-up
   seconds, slice bytes and ship seconds, respawn seconds, reconnects
   and net counters printed;
22. (run after phase 21) head-sharded serving at the same width:
   phase 3's traffic through ``tsm.shard(2)`` and ``tsm.shard(4)``
   (logical shards on the one card, per-shard qkv column slices) over
   phase 3's float pool and over an int8 pool (held to an mp=1 run of
   the same float weights over int8 pages): streams and scheduling
   counts equal to mp=1's, one all-reduce per layer per model call,
   ragged launches layers x mp per call, per-device pool bytes the
   total over mp; an mp=2 snapshot restored at mp=1 and an mp=1
   snapshot at mp=2, and an mp=2 slice resumed in an mp=1 pool, each
   continuing phase 3's streams; mp=2 hidden states of phase 4's
   teacher-forced run bitwise mp=1's with the replicated projection
   (within TOL_REL with the column slices); tokens/s printed only;
23. (run after phase 17) the ``nn`` training surface under AMP, each leg
   failing the run on a failed check: (a) BERT-base pretraining as
   bench_extra.py's AMP-O2 leg (phase 16's config, batch, labels and
   fused encoder; ``amp.decorate`` bf16, ``auto_cast(level="O2")``,
   ``AdamW(1e-4, multi_precision=True)``): 1 warm-up and 10 steps,
   every loss finite and the last below the first, per step LayerNorm 2
   x 12 and dropout 2 x (1 + 3 x 12) launches in bf16; sequences/s, MFU
   against the bf16 dense peak, peak memory and a profile of one step
   beside phase 16's fp32 figures; then the kernel path on the card
   against the plain O2 path on the CPU at batch 2 (loss within
   BOUND_AMP_LOSS, every gradient's cosine >= BOUND_AMP_COS); (b)
   LlamaForCausalLM at bench.py's proxy widths (phase 13's, batch 16 x
   2048, full logits, fp32 cross entropy) under O2 with multi-precision
   AdamW: 1 warm-up and 5 steps, flash forward and backward once per
   layer a step, RMSNorm 2 x 2 + 1 a forward; tokens/s, MFU, peak
   memory, a profile; then greedy ``generate`` (batch 4, a 128-token
   prompt, 32 new tokens, the KV cache, the flash kernel at Lq 1) equal
   to a no-cache re-forward's argmax up to the first near-tie; (c)
   GPTForCausalLM at GPTConfig's widths (the serving phases' model,
   seq 1024, dropout 0.1) under O2 with recompute, batch 8: 1 warm-up
   and 5 steps with the flash kernels' hash dropout and the dropout
   kernel on the hidden dropouts (launch counts checked); a
   recompute-on and a recompute-off step from equal weights and seeds
   within the bf16 bounds; (d) ``nn.Transformer()`` at its defaults,
   pre-norm, one O2 step, then an incremental greedy decode through
   ``gen_cache`` equal to full causal re-forwards up to the first
   near-tie; ``MoELayer(1024, 8 experts, 4096, top 2)`` over 8192
   tokens under O2: the routing on the card exactly the CPU's from the
   same logits, forward and backward within the bf16 bounds of the
   float32 layer on the agreeing tokens;
24. (run after phase 23) the training flagship on meshes of LOGICAL
   ranks on the one card, at phase 13's widths (batch 16 x 2048, bf16,
   fp32 moments, weights from --seed): (a) dp 2 x pp 2 x mp 2, n_micro
   4, 2 layers, remat; (b) pp 2 x sharding 2 x sep 2, n_micro 4, 2
   layers (ring attention at T 2048, 1024 a rank); (c) pp 2 x n_virtual
   2 with remat_stage, 4 layers. Each leg builds the one-device trainer
   from the same seed in this call and holds the mesh trainer's loss,
   every gradient leaf (phase 14's BOUND_TRAIN_*) and the masters after
   one step against it, then times 3 steps after that warm-up beside the
   one-device trainer's s/step, and requires exactly the launches per
   kernel and the collectives per kind that ``mesh_expected`` derives
   from the schedule; (d) the one-device trainer under remat_policy
   'full', 'save_attn' and 'save_dots': gradients within the bounds of
   'full''s, the launches, peak memory ordered full < save_attn <
   save_dots;
25. (run after phase 24) Paddle's dygraph tensor parallelism on LOGICAL
   mp ranks of the one card (``fleet.init(mp_degree=..., device=
   "cuda")``; the mpu layers in the models' places): (a)
   LlamaForCausalLM at phase 23b's widths and batch under O2 with
   multi-precision AdamW at mp 2 and mp 4, (b) GPTForCausalLM at phase
   23c's widths and batch (dropout 0.1, recompute off) at mp 2. Each
   model loads its mp 1 twin's weights (built from --seed in this
   call); one step's loss and every gradient within phase 23's
   BOUND_AMP_* of the twin's (the same dropout seeds), then 3 steps
   after a warm-up timed beside the twin's s/step; each step requires
   exactly the launches of phase 23's legs and the collectives per kind
   and their bytes that ``fleet_mp_expected`` derives from the Megatron
   pairing. (c) The four mpu layers alone at Llama-2-7B widths, float32
   (TF32 off), mp 2, against their plain layers on the same inputs:
   ``VocabParallelEmbedding`` equal to the lookup exactly, Column, Row
   and ``ParallelCrossEntropy`` within BOUND_MP_F32 forward and
   backward;
26. (run after phase 25) the rest of fleet's hybrid training on LOGICAL
   ranks of the one card at phase 23b's widths and batch under O2 with
   multi-precision AdamW: (a) ``fleet.init(pp_degree=2,
   sharding_degree=2)``, a ``PipelineLayer`` of ``LayerDesc``s
   (embedding, the decoder layers, RMSNorm, head) through
   ``distributed_model`` (``PipelineParallel``, 4 micro-batches) and
   ``distributed_optimizer`` (``DygraphShardingOptimizer``): one
   ``train_batch``'s loss, every gradient and every master within
   BOUND_AMP_* of LlamaForCausalLM accumulating the same micro-batches
   by hand, the state bytes each sharding rank holds as ``_shard_spec``
   assigns, the collectives of ``fleet_hybrid_expected`` and the
   launches exactly, 3 timed steps beside the twin's; (d) on (a)'s
   model: ``distributed.checkpoint`` save, load into an mp 2 and a
   one-device LlamaForCausalLM bitwise, a further step of each within
   the bounds, ``PPParallelAdaptor`` round trips exact; (b) offload to
   pinned host memory against the on-card optimizer (one step within
   the bounds, peak memory and s/step of both); (c)
   ``group_sharded_parallel(..., "p_g_os")`` at sharding 2: parameter
   bytes per rank halved, the forward's all-gathers exactly, one step
   within the bounds; (e) ``MoELayer(1024, 8, 4096, top 2)`` over 8192
   tokens at ep 2 against ep 1: routing exactly, output and gradients
   within the bf16 bounds, ``moe_ep_expected``'s all-gathers and
   all-to-alls exactly; (f) ``TrainStep(grad_accum_steps=4)`` within the
   bounds of its twin, s/step;
27. (run after phase 26) training across two processes sharing the
   card, spawned by the port's launcher (``python -m
   paddle_tpu_torch.distributed.launch --nproc_per_node 2 chip_smoke.py
   --mp-child CONFIG``; Gloo; each rank's results in a file of its own;
   the launcher kills both past MP_TIMEOUT, which fails the phase): a
   rendezvous at a taken port and a world on distinct cards raise; (a)
   every eager collective of ``distributed.communication`` on CUDA
   tensors, float32 and int32, each checked exactly (``all_reduce`` of
   rank + 1 gives 3 and int32 stays int32), the calls, bytes and
   host-staged bytes printed; (b) ``LlamaSpmdTrainer`` at phase 24's
   widths and batch (bf16, fp32 moments, remat, weights from --seed)
   with mp 2 split across the processes, 3 steps: the two processes'
   losses bitwise equal and bitwise a one-process run with mp 2 as
   LOGICAL ranks on the card, every shard and fp32 master bitwise (by
   sha256), the collectives per kind and their bytes equal and the
   launches of rows 4, 5, 6 and 9 half the one-process run's in each;
   step times and each process's peak memory printed; (c) two workers,
   each holding a CUDA context, under ``ElasticSupervisor``: rank 1
   SIGKILLed mid-run, the pod relaunched once, the supervisor exits 0;
   (d) rpc between the two ranks;
28. print the kernels line, the card line and, last, the contract line.
Every number printed carries the card's name and power limit; each row
of the kernels line says in ``timed`` which call it timed and how.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# float32 everywhere; the matmuls and convolutions in full float32
TOL_KERNEL = 1e-4          # kernel vs plain version, max abs error
TOL_W8A16 = 1e-4           # w8a16 vs plain version, relative to max|ref|
TOL_GMM = 1e-4             # gmm vs plain version, relative to max|ref|
TOL_REL = 1e-5             # paged vs dense: hidden / logits, rel. to max
# the JAX package's documented bounds of quantized against float serving
BOUND_KV8 = 0.05           # int8 KV pages: hidden, rel. to max|h_fp|
BOUND_W8 = 0.1             # int8 weights: hidden, rel. to max|h_fp|
BOUND_HEAD8 = 0.02         # int8 head: logits, rel. to max|logits_fp|
# the training slice's bf16 flash kernels against their plain versions:
# both round p and dS to bf16, relative to running maxima of different tile
# widths, and write bf16 (1 ulp <= 2**-7 relative). Each row (a query of
# out and dq, a key of dk and dv) is held on its own, since late rows are
# far smaller than early ones: max|err| within 3e-2 x max|ref| of the row
# (four ulps of its largest entry; no row's max|ref| below 1e-3 x the
# tensor's, see _row_err). lse is float32 in both: TOL_KERNEL.
TOL_BF16_ROW = 3e-2
# the kernel path against the plain path at full width, bf16: the loss
# (relative), each leaf's gradient (max abs error over max|plain|) and
# its cosine with the plain gradient
BOUND_TRAIN_LOSS = 1e-3
BOUND_TRAIN_GRAD = 5e-2
BOUND_TRAIN_COS = 0.999
# the BERT kernel path (card) against the plain path (CPU), float32, TF32
# off: summation order only
BOUND_BERT_LOSS = 1e-5
BOUND_BERT_GRAD = 1e-3
BOUND_BERT_COS = 0.9999
# phase 23 (AMP): bf16 paths against other bf16 or float32 paths. Both
# round every op's output to bf16 (2**-8 relative) along chains of tens
# of ops in different GEMM orders: the loss within 2e-2 relative, each
# gradient's cosine with the other path's >= 0.99 (tensors whose max|g|
# is below 1e-2 x the model's largest, rounding noise in bf16, take no
# cosine), an output within 3e-2 x max|ref|
BOUND_AMP_LOSS = 2e-2
BOUND_AMP_COS = 0.99
BOUND_AMP_OUT = 3e-2
# phase 25 (c): an mpu layer against its plain layer in float32, TF32
# off: the ranks' partial products summed in rank order against one
# GEMM (summation order only), max|err| over max|ref| of outputs and
# gradients
BOUND_MP_F32 = 1e-5
# greedy agreement of two bf16 paths: steps whose reference top-two
# logit gap is below this x max|logit| (a few bf16 ulps of the largest
# logit) may go either way, and the streams part from there
TOL_TIE_BF16 = 2.0 ** -6
# the lane oracle (phase 18): a group's branch and its lone submit draw
# the same uniforms, but their probability rows differ in the last bits
# (cuBLAS may pick another kernel, hence another summation order, for
# another batch composition); a draw whose uniform lies within this of an
# edge of its token's CDF interval may go either way, and the streams
# part from there. Hidden rows of two paths agree to ~1e-6 relative
# (phase 4), so the CDF edges move by far less than this.
TOL_LANE = 1e-4
HBM_BYTES_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32_FLOP_S = 494.7e12     # H100 SXM TF32 tensor cores, dense
L2_FLUSH_BYTES = 128 << 20  # written between L2-flushed timed calls
BF16_FLOP_S = 989e12       # H100 SXM bf16 tensor cores, dense

FULL = dict(vocab=50304, d=1024, layers=24, heads=16, ffn=4096,
            block_size=16, max_batch=8, chunk_tokens=128, budget=512,
            n_requests=12, min_prompt=64, max_prompt=960, new_tokens=32,
            num_blocks=260, kernel_pool_blocks=640, timing_iters=20,
            # quantized serving: a shared system prompt + unique suffixes
            system_prompt=256, min_suffix=32, max_suffix=704,
            q_num_blocks=310,
            # MoE serving (Mixtral-8x7B's routing) and speculation
            experts=8, top_k=2, capacity_factor=1.25, block_m=8,
            draft_layers=6, spec_k=4, moe_spec_k=2, spec_requests=4,
            # parallel decoding: branches a group, the lane seed and
            # top-k, the grammar mask's modulus, the equal-bytes bench's
            # prompt in pages (bench_extra.py:2476-2530)
            par_n=4, lane_seed=777, lane_top_k=50, mask_mod=7,
            par_prompt_blocks=6,
            # phase 19: the fault storm's seed and step range, the
            # speculative storm's draft-pool OOM and NaN steps
            storm_seed=12, storm_steps=40, storm_num_blocks=420,
            storm_draft_oom=(6, 12),
            storm_draft_nan=(9,),
            # phase 20: rounds between the recovery host's snapshots
            # (float / quantized runs; the speculative one)
            durable_every=16, durable_spec_every=8,
            # phase 21: the ticks the seeded router kill is drawn from
            # (the prefill worker is still prefilling and both decode
            # workers hold migrated streams), the op timeout of the
            # network storm (a black-holed reply waits it out; the
            # largest op, a page-slice export, takes a few seconds)
            fleet_kill_window=(4, 12), fleet_call_timeout=10.0,
            # training: bench.py's Llama-2-7B proxy (bench.py:58-61)
            train_vocab=32000, train_hidden=4096, train_ffn=11008,
            train_heads=32, train_kv_heads=32, train_layers=2,
            train_seq=2048, train_batch=16, train_steps=5,
            train_plain_batch=2, train_timing_iters=10,
            # BERT-base pretraining (bench_extra.py:186-287, config #2)
            bert_vocab=30522, bert_hidden=768, bert_layers=12,
            bert_heads=12, bert_ffn=3072, bert_batch=32, bert_seq=128,
            bert_steps=10, bert_plain_batch=2, bert_timing_iters=20,
            # phase 23: Llama generate (batch, prompt, new tokens), GPT
            # under recompute (batch, steps), nn.Transformer (batch,
            # lengths, vocab of its token wrapper), MoELayer tokens
            gen_batch=4, gen_prompt=128, gen_new=32, gpt_batch=8,
            gpt_steps=5, gpt_seq=1024, tf_batch=16, tf_len=128,
            tf_vocab=1000, tf_new=16, moe_tokens=8192, moe_d=1024,
            moe_hidden=4096,
            # phase 25 (c): rows through the mpu layers alone
            mp_rows=4096)


class SmokeFailure(RuntimeError):
    pass


def require(ok, what):
    if not ok:
        raise SmokeFailure(what)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else ""
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return line or "nvidia-smi unavailable"


def _event_ms(torch, fn, device, iters):
    """ms per call after warm-up: CUDA events around ``iters`` back-to-back
    calls, which includes the host's launch overhead when that is the
    slower side (the host clock off the card)."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _time_ms(torch, fn, device, iters):
    """(device ms, wall ms) per call after warm-up. Device: the kernels
    ``fn`` launches, summed by CUPTI through torch.profiler (None when the
    profiler records no device time); wall: ``_event_ms``. Off the card
    both are host-clock times."""
    wall = _event_ms(torch, fn, device, iters)
    if device.type != "cuda":
        return wall, wall
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages())
    return (us / 1e3 / iters if us > 0 else None), wall


def _device(*timings):
    """The device times of (device, wall) pairs; the wall times where the
    profiler saw no device time."""
    if any(t[0] is None for t in timings):
        return tuple(t[1] for t in timings)
    return tuple(t[0] for t in timings)


def _flush_buffer(torch, device):
    """A buffer of 2.56x the H100's 50 MB L2 (None off the card)."""
    if device.type != "cuda":
        return None
    return torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                       device=device)


def _flushed_ms(torch, fn, device, iters, flush):
    """ms per call with L2 flushed before each call: CUDA events around
    each call alone; between calls, outside the events, a write of
    ``flush`` (>= 2x the L2) and a device-side wait of ~0.5 ms that lets
    the host enqueue the call before the card reaches it, so the events
    time the device and not the host's launch. Off the card:
    ``_event_ms``."""
    if device.type != "cuda":
        return _event_ms(torch, fn, device, iters)
    fn()
    pairs = []
    for i in range(iters):
        flush.fill_(float(i))
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _flushed_device_ms(torch, fn, device, iters, flush, keys):
    """Device ms per call with L2 flushed before each call: the
    profiler's time of the kernels whose names hold one of ``keys``
    (the flush and the wait excluded), so unlike ``_flushed_ms`` no
    launch gap is counted. None when the profiler saw none (or off the
    card)."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            flush.fill_(float(i))
            torch.cuda._sleep(1_000_000)
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages() if any(k in e.key for k in keys))
    return us / 1e3 / iters if us > 0 else None


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _bound(nbytes, flops, flop_s=FP32_FLOP_S):
    t_b, t_f = nbytes / HBM_BYTES_S, flops / flop_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_kernels(torch, device, cfg, tag, say):
    """Each kernel against its plain version at the serving shapes, then
    timed. Returns {name: row of the kernels line}."""
    from paddle_tpu_torch.inference.paged_cache import _quant_rows
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import paged_attention as pa
    F = torch.nn.functional
    rng = np.random.RandomState(11)
    H, hd, bs = cfg["heads"], cfg["d"] // cfg["heads"], cfg["block_size"]
    S = -(-(cfg["max_prompt"] + cfg["new_tokens"]) // 128) * 128
    MB = S // bs
    rows = {}

    # -- ragged paged attention: a mixed step of the serving path ------
    # prefill chunks of 128 and 2 rows, a zero-length segment, 7 decode
    # rows and one decode row through an all-trash table at t = 0
    n_dec = cfg["max_batch"]
    q_lens = (min(128, cfg["chunk_tokens"]), 2, 0) + (1,) * n_dec
    dec_lens = rng.randint(cfg["min_prompt"], S - 1, n_dec - 1) + 1
    kv_lens = np.array([256 + q_lens[0], 510 + q_lens[1], 48]
                       + list(dec_lens) + [1], np.int32)
    kv_lens = np.minimum(kv_lens, S)
    NB = cfg["kernel_pool_blocks"]
    pool = torch.randn((NB, 2, H, bs, hd), generator=torch.Generator(
        ).manual_seed(1)).to(device)
    bt = np.zeros((len(q_lens), MB), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    k = 0
    for s, L in enumerate(kv_lens[:-1]):       # last row: trash table
        n = -(-int(L) // bs)
        bt[s, :n] = perm[k:k + n]
        k += n
    require(k < NB, "kernel check pool too small")
    # q as the serving model hands it over: the query third of the packed
    # qkv projection, a strided view (row stride 3 d)
    R, d = sum(q_lens), cfg["d"]
    q = torch.randn((R, 3 * d), generator=torch.Generator().manual_seed(
        2)).to(device).split(d, dim=-1)[0].reshape(R, H, hd)
    require(q.stride(0) == 3 * d, "phase 2 q is not the qkv split view")
    btd = torch.from_numpy(bt).to(device)
    lensd = torch.from_numpy(kv_lens).to(device)
    got = pa.paged_attention_ragged(q, pool, btd, q_lens, lensd)
    ref = pa.paged_attention_ragged_reference(q, pool, btd, q_lens, lensd)
    err = float((got - ref).abs().max())
    require(bool(torch.isfinite(got).all()), "ragged kernel: non-finite")
    say(f"{tag} paged_attention_ragged vs plain: max_abs_err {err:.3e} "
        f"(tol {TOL_KERNEL}) rows {R} q_lens {q_lens} q strides "
        f"{q.stride()}")
    require(err <= TOL_KERNEL, f"ragged kernel disagrees: {err}")
    # library yardstick: ONE sdpa call over the gathered, padded pages
    kg, vg = pa.gather_pages(pool, btd)          # [n_seq, S, H, hd]
    maxq = max(q_lens)
    qp = torch.zeros((len(q_lens), H, maxq, hd), device=device)
    r0 = 0
    for s, ql in enumerate(q_lens):
        qp[s, :, :ql] = q[r0:r0 + ql].transpose(0, 1)
        r0 += ql
    qpos = (torch.from_numpy(kv_lens - np.array(q_lens)).to(device)[
        :, None] + torch.arange(maxq, device=device)[None])
    lmask = (torch.arange(kg.shape[1], device=device)[None, None, :]
             <= qpos[:, :, None])[:, None]
    kt, vt = kg.transpose(1, 2), vg.transpose(1, 2)
    iters = cfg["timing_iters"]
    # the serving path's plan: split-KV items from the host lengths
    plan = pa.RaggedPlan(q_lens, kv_lens)
    again = pa.paged_attention_ragged(q, pool, btd, q_lens, lensd, plan=plan)
    same = bool(torch.equal(again, got))
    require(same, "ragged kernel: two launches differ")
    del again
    kernel = lambda: pa.paged_attention_ragged(  # noqa: E731
        q, pool, btd, q_lens, lensd, plan=plan)
    plain = lambda: pa.paged_attention_ragged_reference(  # noqa: E731
        q, pool, btd, q_lens, lensd)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qp, kt, vt, attn_mask=lmask)
    t_k = _time_ms(torch, kernel, device, iters)
    t_p = _time_ms(torch, plain, device, iters)
    t_l = _time_ms(torch, library, device, iters)
    warm = _device(t_k, t_p, t_l)
    flush = _flush_buffer(torch, device)
    ms, plain_ms, lib_ms = (_flushed_ms(torch, f, device, iters, flush)
                            for f in (kernel, plain, library))
    # the Pallas module's default tile width, and spans sized from the
    # table width (device lengths only), for comparison
    t_64 = _time_ms(torch, lambda: pa.paged_attention_ragged(
        q, pool, btd, q_lens, lensd, tile_q=64), device, iters)
    t_w = _time_ms(torch, lambda: pa.paged_attention_ragged(
        q, pool, btd, q_lens, lensd), device, iters)
    # bound: q read + out written once, each row's visible K/V once per
    # sequence (positions < kv_len), tables and lengths
    live = [s for s, ql in enumerate(q_lens) if ql]
    kv_pos = sum(int(kv_lens[s]) for s in live)
    nbytes = (2 * sum(q_lens) * H * hd * 4 + kv_pos * H * hd * 2 * 4
              + bt.nbytes + kv_lens.nbytes)
    flops = 0
    for s in live:
        p0 = int(kv_lens[s]) - q_lens[s]
        flops += sum(p0 + i + 1 for i in range(q_lens[s])) * 4 * hd * H
    b_ms, b_by = _bound(nbytes, flops)
    say(f"{tag} paged_attention_ragged (float32 pages) time per call, L2 "
        f"flushed (CUDA events): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa over gathered pages {lib_ms:.4f} ms; warm (profiler "
        f"device time, back to back): kernel {warm[0]:.4f}, plain "
        f"{warm[1]:.4f}, sdpa {warm[2]:.4f} ms; bound {b_ms:.4f} ms "
        f"({b_by}; {nbytes} B, {flops} flop); warm wall per call: kernel "
        f"{t_k[1]:.4f}, plain {t_p[1]:.4f}, sdpa {t_l[1]:.4f} ms; run to "
        f"run bitwise {same}; warm kernel at tile_q 64 (the Pallas "
        f"default) {_device(t_64)[0]:.4f} ms, spans from the table width "
        f"{_device(t_w)[0]:.4f} ms")
    del flush
    rows["paged_attention_ragged"] = dict(
        name="paged_attention_ragged", route="cuda",
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:290",
        timed=f"phase 2's mixed step ({R} rows), L2 flushed, CUDA events "
        f"per call; warm_ms: back to back, profiler device time",
        max_abs_err=err, ms=ms, warm_ms=warm[0], plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    # -- the same mixed step over int8 pages ----------------------------
    # the pool quantized as the serving appends write it; trash block 0
    # keeps zero scales, so the all-trash row reads exact zeros
    qpool, scales = _quant_rows(pool)
    qpool[0], scales[0] = 0, 0.0
    got = pa.paged_attention_ragged(q, qpool, btd, q_lens, lensd,
                                    kv_scales=scales)
    ref = pa.paged_attention_ragged_reference(q, qpool, btd, q_lens, lensd,
                                              kv_scales=scales)
    err = float((got - ref).abs().max())
    require(bool(torch.isfinite(got).all()), "int8 ragged kernel: "
            "non-finite")
    again = pa.paged_attention_ragged(q, qpool, btd, q_lens, lensd,
                                      plan=plan, kv_scales=scales)
    same = bool(torch.equal(again, got))
    del again
    say(f"{tag} paged_attention_ragged int8 pages vs plain: max_abs_err "
        f"{err:.3e} (tol {TOL_KERNEL}) rows {R} q_lens {q_lens}; run to "
        f"run bitwise {same}")
    require(err <= TOL_KERNEL, f"int8 ragged kernel disagrees: {err}")
    require(same, "int8 ragged kernel: two launches differ")
    # yardstick: sdpa over pages gathered and dequantized beforehand
    kq, vq = pa.gather_pages(qpool, btd, kv_scales=scales)
    kqt, vqt = kq.transpose(1, 2), vq.transpose(1, 2)
    fns = (lambda: pa.paged_attention_ragged(
        q, qpool, btd, q_lens, lensd, plan=plan, kv_scales=scales),
        lambda: pa.paged_attention_ragged_reference(
        q, qpool, btd, q_lens, lensd, kv_scales=scales),
        lambda: F.scaled_dot_product_attention(qp, kqt, vqt,
                                               attn_mask=lmask))
    t_k, t_p, t_l = (_time_ms(torch, f, device, iters) for f in fns)
    warm = _device(t_k, t_p, t_l)
    flush = _flush_buffer(torch, device)
    ms, plain_ms, lib_ms = (_flushed_ms(torch, f, device, iters, flush)
                            for f in fns)
    dev_ms = _flushed_device_ms(torch, fns[0], device, iters, flush,
                                ("span_kernel", "combine_kernel"))
    del flush, fns
    # bound: as above with hd int8 bytes + one f32 scale per (position,
    # head, K|V)
    nbytes = (2 * sum(q_lens) * H * hd * 4 + kv_pos * H * (hd + 4) * 2
              + bt.nbytes + kv_lens.nbytes)
    b_ms, b_by = _bound(nbytes, flops)
    say(f"{tag} paged_attention_ragged (int8 pages) time per call, L2 "
        f"flushed (CUDA events): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, sdpa over dequantized gathered pages {lib_ms:.4f} ms; warm "
        f"(profiler device time, back to back): kernel {warm[0]:.4f}, "
        f"plain {warm[1]:.4f}, sdpa {warm[2]:.4f} ms; bound {b_ms:.4f} ms "
        f"({b_by}; {nbytes} B, {flops} flop); warm wall per call: kernel "
        f"{t_k[1]:.4f}, plain {t_p[1]:.4f}, sdpa {t_l[1]:.4f} ms; kernel "
        f"device time L2 flushed (profiler, no launch gap) "
        f"{_fmt(dev_ms)}")
    rows["paged_attention_ragged_int8"] = dict(
        name="paged_attention_ragged_int8", route="cuda",
        source="paddle_tpu_torch/csrc/paged_attention_int8.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:231",
        timed=f"phase 2's mixed step ({R} rows) over int8 pages, L2 "
        f"flushed, CUDA events per call; warm_ms: back to back, profiler "
        f"device time; flushed_device_ms: L2 flushed, profiler device time",
        max_abs_err=err, ms=ms, warm_ms=warm[0], flushed_device_ms=dev_ms,
        plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    del qpool, scales, kq, vq, kqt, vqt

    # -- dense decode attention: the oracle's decode shapes ------------
    B = 4
    cache = torch.randn((2, B, H, S, hd), generator=torch.Generator(
        ).manual_seed(3)).to(device)
    qd = torch.randn((B, H, hd), generator=torch.Generator(
        ).manual_seed(4)).to(device)
    lens = torch.from_numpy(rng.randint(cfg["min_prompt"], S, B).astype(
        np.int32)).to(device)
    kc, vc = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    got = da.decode_attention(qd, kc, vc, lens)
    ref = da.decode_attention_reference(qd, kc, vc, lens)
    err = float((got - ref).abs().max())
    z = da.decode_attention(qd[:2], kc[:2], vc[:2],
                            torch.tensor([0, 5], dtype=torch.int32,
                                         device=device))
    require(not bool(z[0].any()), "decode kernel: length 0 not zeros")
    # the ragged kernel's decode rows over a pool holding the same cache
    # (its blocks shuffled): the same split-KV body, bit for bit
    MBd = S // bs
    bt_d = rng.permutation(np.arange(1, 1 + B * MBd)).reshape(B, MBd)
    pool_d = pa.scatter_pages(kc, vc, bt_d, 1 + B * MBd)
    bt_d = torch.from_numpy(bt_d.astype(np.int32)).to(device)
    paged = pa.paged_attention_ragged(qd, pool_d, bt_d, (1,) * B, lens)
    as_paged = bool(torch.equal(paged, got))
    same = bool(torch.equal(da.decode_attention(qd, kc, vc, lens), got))
    del pool_d, paged
    say(f"{tag} decode_attention vs plain: max_abs_err {err:.3e} "
        f"(tol {TOL_KERNEL}) B {B} S {S}; bitwise equal to the ragged "
        f"kernel's decode rows over the same K/V in pages: {as_paged}; run "
        f"to run bitwise {same}")
    require(err <= TOL_KERNEL, f"decode kernel disagrees: {err}")
    require(as_paged, "decode kernel: not bitwise the ragged kernel's "
            "decode rows")
    require(same, "decode kernel: two launches differ")
    t = decode_timings(torch, device, qd, cache, lens, iters)
    # the same widths at one long row (64 spans; 67 MB of K/V, above L2)
    SL = 8192
    cache_l = torch.randn((2, 1, H, SL, hd), generator=torch.Generator(
        ).manual_seed(5)).to(device)
    ql = torch.randn((1, H, hd), generator=torch.Generator(
        ).manual_seed(6)).to(device)
    lens_l = torch.full((1,), SL, dtype=torch.int32, device=device)
    kl, vl = cache_l[0].transpose(1, 2), cache_l[1].transpose(1, 2)
    err_l = float((da.decode_attention(ql, kl, vl, lens_l) -
                   da.decode_attention_reference(ql, kl, vl, lens_l)
                   ).abs().max())
    say(f"{tag} decode_attention one long row vs plain: max_abs_err "
        f"{err_l:.3e} (tol {TOL_KERNEL}) B 1 S {SL}")
    require(err_l <= TOL_KERNEL, f"decode kernel disagrees at one long "
            f"row: {err_l}")
    tl = decode_timings(torch, device, ql, cache_l, lens_l, iters)
    del cache_l, kl, vl
    for what, tt in ((f"{B} rows over {S} positions", t),
                     (f"one row of {SL} positions", tl)):
        say(f"{tag} decode_attention, {what}: L2 flushed (CUDA events): "
            f"kernel {tt['ms']:.4f} ms, plain {tt['plain_ms']:.4f} ms, sdpa "
            f"{tt['library_ms']:.4f} ms; kernel device time L2 flushed "
            f"(profiler, no launch gap) {_fmt(tt['flushed_device_ms'])}; "
            f"warm (profiler device time, back to back): kernel "
            f"{tt['warm_ms']:.4f}, plain {tt['warm_plain_ms']:.4f}, sdpa "
            f"{tt['warm_library_ms']:.4f} ms; bound {tt['bound_ms']:.4f} ms "
            f"({tt['bound_by']}; {tt['bytes']} B); warm wall per call: "
            f"kernel {tt['wall_ms']:.4f} ms")
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/pallas/decode_attention.py:86",
        timed=f"{B} rows over {S} positions, L2 flushed, CUDA events per "
        f"call (span and combine launches); plain_ms and library_ms "
        f"likewise; warm_ms: back to back, profiler device time; "
        f"flushed_device_ms: L2 flushed, profiler device time of both "
        f"kernels; long_*: one row of {SL} positions, L2 flushed, CUDA "
        f"events",
        max_abs_err=max(err, err_l), ms=t["ms"], warm_ms=t["warm_ms"],
        flushed_device_ms=t["flushed_device_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], long_ms=tl["ms"],
        long_bound_ms=tl["bound_ms"], long_library_ms=tl["library_ms"])
    rows["w8a16_matmul"] = phase_w8a16(torch, device, cfg, tag, say)
    return rows


def decode_timings(torch, device, q, cache, lens, iters):
    """``decode_attention`` over the [B, S, H, hd] views of ``cache`` [2,
    B, H, S, hd] at ``lens``, its plain version and one sdpa call: each L2
    flushed (CUDA events per call) and warm (profiler device time, back
    to back); the kernel's L2-flushed device time (profiler: the span
    and the combine kernels, named decode_*); the bytes bound (q read and
    out written once, each row's valid K/V once)."""
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    F = torch.nn.functional
    B, H, S, hd = cache.shape[1:]
    kc, vc = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    dmask = (torch.arange(S, device=device)[None, :]
             < lens[:, None])[:, None, None]
    fns = (lambda: da.decode_attention(q, kc, vc, lens),
           lambda: da.decode_attention_reference(q, kc, vc, lens),
           lambda: F.scaled_dot_product_attention(
               q[:, :, None], cache[0], cache[1], attn_mask=dmask))
    t_k, t_p, t_l = (_time_ms(torch, f, device, iters) for f in fns)
    warm = _device(t_k, t_p, t_l)
    flush = _flush_buffer(torch, device)
    ms, plain_ms, lib_ms = (_flushed_ms(torch, f, device, iters, flush)
                            for f in fns)
    dev_ms = _flushed_device_ms(torch, fns[0], device, iters, flush,
                                ("decode_",))
    tot = int(lens.clamp(0, S).sum())
    nbytes = 2 * B * H * hd * 4 + tot * H * hd * 2 * 4 + B * 4
    b_ms, b_by = _bound(nbytes, tot * 4 * hd * H)
    del flush
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                flushed_device_ms=dev_ms, warm_ms=warm[0],
                warm_plain_ms=warm[1], warm_library_ms=warm[2],
                wall_ms=t_k[1], bound_ms=b_ms, bound_by=b_by, bytes=nbytes)


def phase_w8a16(torch, device, cfg, tag, say):
    """The w8a16 kernel against its plain version at 1, 8, 16 (a verify
    batch) and 256 rows for every projection of a layer and the head,
    and bitwise equal from run to run; each timed warm (profiler, back to
    back) and with L2 flushed (CUDA events: a served model's weights do
    not fit the L2) beside its bound, the plain version and torch.matmul
    over the weight dequantized beforehand. The kernels-line row sums one
    layer's four projections at 8 rows (a decode step): ``ms`` and the
    plain and library times L2 flushed, ``warm_ms`` the kernel warm."""
    from paddle_tpu_torch.ops.hopper import int8_matmul as im
    d, ffn, V = cfg["d"], cfg["ffn"], cfg["vocab"]
    shapes = {"qkv": (d, 3 * d), "out_proj": (d, d), "ffn1": (d, ffn),
              "ffn2": (ffn, d), "head": (d, V)}
    iters = cfg["timing_iters"]
    flush = _flush_buffer(torch, device)
    layer = dict(ms=0.0, warm_ms=0.0, device_ms=0.0, plain_ms=0.0,
                 library_ms=0.0, bound_ms=0.0, max_abs_err=0.0, by=set())
    for name, (K, N) in shapes.items():
        gen = torch.Generator().manual_seed(K * 7 + N)
        w = torch.randint(-127, 128, (K, N), generator=gen,
                          dtype=torch.int8).to(device)
        wscale = torch.rand(N, generator=gen).to(device) / 127.0
        wdeq = w.float() * wscale          # the library call's operand
        for M in (1, 8, 16, 256):
            x = torch.randn((M, K), generator=gen).to(device)
            got = im.w8a16_matmul(x, w)
            ref = im.w8a16_matmul_reference(x, w)
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            same = bool(torch.equal(im.w8a16_matmul(x, w), got))
            require(err <= TOL_W8A16 * scale, f"w8a16 {name} M {M} "
                    f"disagrees: {err} vs max|ref| {scale}")
            require(same, f"w8a16 {name} M {M}: two launches differ")
            fns = (lambda: im.w8a16_matmul(x, w),
                   lambda: im.w8a16_matmul_reference(x, w),
                   lambda: torch.matmul(x, wdeq))
            t_k, t_p, t_l = (_time_ms(torch, f, device, iters) for f in fns)
            warm = _device(t_k, t_p, t_l)
            ms, plain_ms, lib_ms = (_flushed_ms(torch, f, device, iters,
                                                flush) for f in fns)
            dev_ms = _flushed_device_ms(torch, fns[0], device, iters, flush,
                                        ("w8a16_",))
            nbytes = M * K * 4 + K * N + M * N * 4
            b_ms, b_by = _bound(nbytes, 2 * M * K * N)
            say(f"{tag} w8a16_matmul {name} M {M} K {K} N {N}: max_abs_err "
                f"{err:.3e} (tol {TOL_W8A16 * scale:.3e}), run to run "
                f"bitwise {same}; L2 flushed (CUDA events): kernel {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, matmul over the dequantized "
                f"weight {lib_ms:.4f} ms; warm (profiler, back to back): "
                f"kernel {warm[0]:.4f}, plain {warm[1]:.4f}, matmul "
                f"{warm[2]:.4f} ms; bound {b_ms:.4f} ms ({b_by}; {nbytes} "
                f"B); warm wall kernel {t_k[1]:.4f} ms; kernel device time "
                f"L2 flushed (profiler, no launch gap) {_fmt(dev_ms)}")
            if M == 8 and name != "head":
                layer["device_ms"] = (None if dev_ms is None or
                                      layer["device_ms"] is None else
                                      layer["device_ms"] + dev_ms)
                for key, val in (("ms", ms), ("warm_ms", warm[0]),
                                 ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms),
                                 ("bound_ms", b_ms)):
                    layer[key] += val
                layer["max_abs_err"] = max(layer["max_abs_err"], err)
                layer["by"].add(b_by)
            del fns
        del w, wdeq
    del flush
    say(f"{tag} w8a16_matmul one layer's 4 projections at M 8, L2 flushed: "
        f"kernel {layer['ms']:.4f} ms, plain {layer['plain_ms']:.4f} ms, "
        f"matmul {layer['library_ms']:.4f} ms, bound {layer['bound_ms']:.4f} "
        f"ms; warm: kernel {layer['warm_ms']:.4f} ms; kernel device time L2 "
        f"flushed (profiler) {_fmt(layer['device_ms'])}")
    return dict(
        name="w8a16_matmul", route="cuda",
        source="paddle_tpu_torch/csrc/int8_matmul.cu",
        replaces="paddle_tpu/ops/pallas/int8_matmul.py:61",
        timed="one layer's 4 projections at 8 rows, L2 flushed, CUDA "
        "events per call; warm_ms: back to back, profiler device time; "
        "flushed_device_ms: L2 flushed, profiler device time",
        max_abs_err=layer["max_abs_err"], ms=layer["ms"],
        warm_ms=layer["warm_ms"], flushed_device_ms=layer["device_ms"],
        plain_ms=layer["plain_ms"],
        bound_ms=layer["bound_ms"],
        bound_by="bytes" if layer["by"] == {"bytes"} else "operations",
        library_ms=layer["library_ms"])


def build_model(torch, device, cfg, seed):
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.inference import TokenServingModel
    gen = torch.Generator(device=device).manual_seed(seed)
    core = FusedMultiTransformer(cfg["d"], cfg["heads"], cfg["ffn"],
                                 num_layers=cfg["layers"], device=device,
                                 generator=gen)
    emb = np.random.default_rng(seed).standard_normal(
        (cfg["vocab"], cfg["d"]), dtype=np.float32) * np.float32(0.02)
    return TokenServingModel(core, emb)          # tied head


def phase_serve(torch, device, cfg, tsm, prompts, tag, say, label,
                num_blocks, each_round=None, **engine_kw):
    """12 greedy requests through SpeculativeEngine(k=0) with mixed
    steps and preemption; ``each_round(engine)`` runs after every round.
    Returns a dict: launches (per kernel), streams, the engine, the rows
    of every model call, the head calls and the scheduling counts."""
    from paddle_tpu_torch.inference import SpeculativeEngine
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import grouped_gemm as gg
    from paddle_tpu_torch.ops.hopper import int8_matmul as im
    from paddle_tpu_torch.ops.hopper import paged_attention as pa
    rows, heads = [], []
    hook = tsm.core.register_forward_pre_hook(
        lambda m, a: rows.append(a[0].shape[0] * a[0].shape[1]))
    eng = SpeculativeEngine(
        tsm, None, k=0, max_batch=cfg["max_batch"],
        block_size=cfg["block_size"], num_blocks=num_blocks,
        chunk_tokens=cfg["chunk_tokens"],
        prefill_token_budget=cfg["budget"], **engine_kw)
    logits = tsm.logits
    tsm.logits = lambda h: (heads.append(1), logits(h))[1]
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    n_new = cfg["new_tokens"]
    for mod in (pa, da, im, gg):
        mod.reset_launch_count()
    t0 = time.perf_counter()
    rids = [eng.submit(p) for p in prompts]
    done, rounds = {}, 0
    while len(done) < len(rids):
        rounds += 1
        require(rounds < 50 * len(rids), "serving did not converge")
        eng.step()
        if each_round is not None:
            each_round(eng)
        for r in rids:
            if r not in done and r in eng._by_rid and \
                    len(eng.generated(r)) >= n_new:
                done[r] = eng.generated(r)[:n_new]
                eng.release(r)
    if device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"paged_attention_ragged": pa.launch_count(),
                "decode_attention": da.launch_count(),
                "w8a16_matmul": im.launch_count(),
                "gmm": gg.launch_count()}
    hook.remove()
    del tsm.logits
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0
    outs = eng.outcomes
    preempt = sum(o.preemptions for o in outs)
    st = eng.engine.prefill_stats
    # a head-sharded core launches once per layer per shard
    per_call = cfg["layers"] * getattr(tsm.core, "mp", 1)
    say(f"{tag} {label}: {len(rids)} requests x {n_new} tokens in "
        f"{secs:.3f} s = {len(rids) * n_new / secs:.2f} tokens/s; "
        f"{rounds} rounds, {len(rows)} model calls, {st.mixed_steps} "
        f"mixed steps, {preempt} preemptions "
        f"({eng.engine.resilience_stats.retried} re-admissions), "
        f"ragged launches {launches['paged_attention_ragged']} "
        f"(= {per_call} x {len(rows)} model calls), peak memory "
        f"{peak / 2**20:.1f} MiB")
    require(all(o.status == "finished" for o in outs) and
            len(outs) == len(rids), "a request did not finish")
    require(preempt >= 1, "no preemption happened")
    require(st.mixed_steps >= 1, "no mixed prefill+decode step")
    streams = [done[r] for r in rids]
    require(all(len(s) == n_new and 0 <= min(s) and
                max(s) < tsm.vocab_size for s in streams),
            "malformed token stream")
    if device.type == "cuda":
        require(launches["paged_attention_ragged"] ==
                per_call * len(rows) > 0,
                f"ragged launches {launches} != {per_call} x model calls")
    return dict(launches=launches, streams=streams, engine=eng, rows=rows,
                heads=len(heads), secs=secs, peak=peak,
                counts=dict(rounds=rounds, model_calls=len(rows),
                            mixed_steps=st.mixed_steps,
                            preemptions=preempt))


def phase_quant_serve(torch, device, cfg, tsm8, prompts, tag, say):
    """Phase 3's traffic shape through the int8 model, int8 head, int8 KV
    pages and the prefix cache; the prompts share a system prompt."""
    r = phase_serve(torch, device, cfg, tsm8, prompts, tag, say,
                    "quantized serving (int8 weights, int8 KV, prefix "
                    "cache)", cfg["q_num_blocks"], kv_dtype="int8",
                    prefix_cache=True)
    eng = r["engine"].engine
    cache, ps = eng.cache, eng.prefix_stats
    fp32_bytes = (cache.num_layers * cache.num_blocks * 2 *
                  cache.num_heads * cache.block_size * cache.head_dim * 4)
    small = sum(1 for n in r["rows"] if n <= 256)
    w8 = r["launches"]["w8a16_matmul"]
    say(f"{tag} quantized serving: int8 pool {cache.pool_bytes()} B "
        f"({cache.num_blocks} blocks, {cache.kv_bytes_per_token()} B per "
        f"token) vs {fp32_bytes} B for fp32 pages at the same block count "
        f"({fp32_bytes / cache.pool_bytes():.2f}x); prefix lookups "
        f"{ps.lookups}, hit_blocks {ps.hit_blocks} of {ps.lookup_blocks}, "
        f"tokens_skipped {ps.tokens_skipped}, tokens_computed "
        f"{ps.tokens_computed}; w8a16 launches {w8} (= 4 x "
        f"{cfg['layers']} x {small} model calls of <= 256 rows + "
        f"{r['heads']} head calls); head {tsm8.weight_bytes()} B int8")
    require(ps.hit_blocks > 0 and ps.tokens_skipped > 0,
            "no prefix-cache hit")
    if device.type == "cuda":
        require(w8 == 4 * cfg["layers"] * small + r["heads"] and small > 0,
                f"w8a16 launches {w8} != 4 x layers x {small} small calls "
                f"+ {r['heads']} head calls")
    return r


def teacher_force(torch, device, cfg, core, tsm, prompts, toks,
                  stagger=False, **engine_kw):
    """Serve ``prompts`` through a PagedServingEngine over ``core`` (a
    pool that never preempts), feeding request i the tokens toks[i].
    Returns (hidden [n, new_tokens, d], the engine). ``stagger``: submit
    each prompt once the previous one is admitted, so later prompts find
    its registered prefix pages."""
    from paddle_tpu_torch.inference import PagedServingEngine
    n, n_new = len(prompts), cfg["new_tokens"]
    need = sum(-(-(len(p) + n_new) // cfg["block_size"]) for p in prompts)
    eng = PagedServingEngine(core, n, cfg["block_size"], need + 1,
                             chunk_tokens=cfg["chunk_tokens"],
                             prefill_token_budget=cfg["budget"],
                             **engine_kw)
    rid_of, pending = {}, list(range(n))

    def submit_next():
        i = pending.pop(0)
        rid_of[eng.submit(tsm.embed(prompts[i]))] = i
    submit_next()
    while pending and not stagger:
        submit_next()
    ph = [[] for _ in prompts]
    slot_req = {}
    while any(len(h) < n_new for h in ph):
        events = list(eng.admitted)
        eng.admitted.clear()
        for rid, slot, h in events:
            slot_req[slot] = rid_of[rid]
            ph[rid_of[rid]].append(h[0])
            if pending:
                submit_next()
        x = np.zeros((n, 1, cfg["d"]), np.float32)
        for slot, i in slot_req.items():
            x[slot, 0] = tsm.embed([toks[i][len(ph[i]) - 1]])
        stepping = eng.active.copy()
        out = eng.step(torch.from_numpy(x).to(device))
        if out is not None:
            for slot in np.flatnonzero(stepping & eng.active):
                i = slot_req[int(slot)]
                ph[i].append(out[int(slot), 0])
                if len(ph[i]) == n_new:
                    del slot_req[int(slot)]
                    eng.release(int(slot))
    require(not eng.outcomes or all(o.preemptions == 0
                                    for o in eng.outcomes),
            "teacher-forced pool preempted")
    return torch.stack([torch.stack(h[:n_new]) for h in ph]), eng


def _agreement(ref_logits, logits, divergence):
    """Greedy agreement of ``logits`` with ``ref_logits`` [n, steps, V]:
    (steps agreeing in all, per request the first step whose reference
    top-two gap is below ``divergence``, whether every request agrees up
    to that step)."""
    top2 = ref_logits.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    rt = ref_logits.argmax(-1).cpu().numpy()
    gt = logits.argmax(-1).cpu().numpy()
    first, ok = [], True
    for i in range(rt.shape[0]):
        small = np.flatnonzero(gap[i] < divergence)
        upto = int(small[0]) if small.size else rt.shape[1]
        first.append(upto)
        ok &= bool((rt[i, :upto] == gt[i, :upto]).all())
    return int((rt == gt).sum()), first, ok


def phase_paged_vs_dense(torch, device, cfg, tsm, prompts, tag, say):
    """Dense oracle vs paged engine on the same 4 prompts, teacher-forced
    with the dense engine's greedy tokens. Returns the dense path's
    launch counts, the tokens and the paged hidden rows."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import paged_attention as pa
    core, n_new = tsm.core, cfg["new_tokens"]
    prompts = prompts[:4]
    max_len = max(len(p) for p in prompts) + n_new + 1
    logits = lambda h: tsm.logits(h.reshape(1, -1))[0]  # noqa: E731

    # dense oracle: prefill each prompt, then n_new - 1 decode steps
    pa.reset_launch_count()
    da.reset_launch_count()
    dense = ContinuousBatchingEngine(core, 4, max_len)
    dh = [[] for _ in prompts]
    for i, p in enumerate(prompts):
        slot, h = dense.add_request(tsm.embed(p))
        require(slot == i, "dense slot order")
        dh[i].append(h[0])
    toks = [[int(logits(h[0]).argmax())] for h in dh]
    for _ in range(n_new - 1):
        x = np.stack([tsm.embed([t[-1]]) for t in toks])
        out = dense.step(torch.from_numpy(x).to(device))
        for i in range(4):
            dh[i].append(out[i, 0])
            toks[i].append(int(logits(out[i, 0]).argmax()))
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {"paged_attention_ragged": pa.launch_count(),
                "decode_attention": da.launch_count()}
    if device.type == "cuda":
        require(launches["decode_attention"] ==
                cfg["layers"] * (n_new - 1) and
                launches["paged_attention_ragged"] == 0,
                f"dense decode launches {launches}")

    # paged engine, fed the dense engine's tokens
    pH, _ = teacher_force(torch, device, cfg, core, tsm, prompts, toks)
    dH = torch.stack([torch.stack(h) for h in dh])     # [4, n_new, d]
    dL, pL = tsm.logits(dH), tsm.logits(pH)
    err_h = float((dH - pH).abs().max())
    err_l = float((dL - pL).abs().max())
    tol_h = TOL_REL * float(dH.abs().max())
    tol_l = TOL_REL * float(dL.abs().max())
    agree, first_small, ok = _agreement(dL, pL, tol_l)
    require(ok, f"paged greedy tokens diverge before the first top-two "
            f"gap below {tol_l:.3e}: {first_small}")
    say(f"{tag} paged vs dense: hidden max_abs_diff {err_h:.3e} (tol "
        f"{tol_h:.3e} = {TOL_REL} x max|h|), logits max_abs_diff "
        f"{err_l:.3e} (tol {tol_l:.3e}); greedy tokens agree "
        f"{agree}/{4 * n_new}; first step with top-two gap < tol per "
        f"request: {first_small} (of {n_new}); dense decode launches "
        f"{launches['decode_attention']}")
    require(err_h <= tol_h and err_l <= tol_l,
            "paged and dense hidden rows disagree")
    return launches, toks, pH, first_small


def phase_quant_vs_float(torch, device, cfg, tsm, tsm8, prompts, toks, pH,
                         tag, say):
    """Int8 KV pages, int8 weights and the int8 head, each against the
    float path on the same float weights, teacher-forced with phase 4's
    tokens, under the JAX package's documented bounds."""
    prompts = prompts[:4]
    hk, _ = teacher_force(torch, device, cfg, tsm.core, tsm, prompts, toks,
                          dtype="int8")
    hw, _ = teacher_force(torch, device, cfg, tsm8.core, tsm, prompts,
                          toks)
    m = float(pH.abs().max())
    Lf = tsm.logits(pH)
    lm = float(Lf.abs().max())
    readings = [
        ("int8 KV pages: hidden", hk, float((hk - pH).abs().max()), m,
         BOUND_KV8, tsm.logits(hk)),
        ("int8 weights: hidden", hw, float((hw - pH).abs().max()), m,
         BOUND_W8, tsm.logits(hw)),
        ("int8 head: logits", None, None, lm, BOUND_HEAD8,
         tsm8.logits(pH)),
    ]
    n = len(prompts) * cfg["new_tokens"]
    for what, _, diff, scale, bound, L in readings:
        ldiv = float((L - Lf).abs().max())
        if diff is None:
            diff = ldiv
        agree, first, ok = _agreement(Lf, L, ldiv)
        say(f"{tag} quantized vs float, {what} max_abs_diff {diff:.4e} = "
            f"{diff / scale:.4e} x max|ref| (bound {bound}); logits "
            f"max_abs_diff {ldiv:.4e}; greedy tokens agree {agree}/{n}; "
            f"first step whose float top-two gap is below the logits "
            f"difference, per request: {first}")
        require(diff <= bound * scale, f"{what} over its bound")
        require(ok, f"{what}: greedy tokens diverge before the first "
                f"top-two gap below the divergence")


def phase_prefix(torch, device, cfg, tsm, prompts, toks, tag, say):
    """Prefix adoption on the fp32 pool: the same shared-prompt requests
    (teacher-forced) with the prefix cache and without."""
    prompts = prompts[:4]
    h_off, _ = teacher_force(torch, device, cfg, tsm.core, tsm, prompts,
                             toks, stagger=True)
    h_on, eng = teacher_force(torch, device, cfg, tsm.core, tsm, prompts,
                              toks, stagger=True, prefix_cache=True)
    ps = eng.prefix_stats
    diff = float((h_on - h_off).abs().max())
    tol = TOL_REL * float(h_off.abs().max())
    say(f"{tag} prefix on vs off (fp32 pool): hidden max_abs_diff "
        f"{diff:.3e} (tol {tol:.3e} = {TOL_REL} x max|h|); hit_blocks "
        f"{ps.hit_blocks} of {ps.lookup_blocks}, tokens_skipped "
        f"{ps.tokens_skipped}")
    require(ps.hit_blocks > 0, "no prefix hit with the cache on")
    require(diff <= tol, "prefix adoption changed the hidden rows")


def _moe_cap_pad(cfg, rows):
    from paddle_tpu_torch.inference import moe_capacity
    cap = moe_capacity(cfg["capacity_factor"], rows, cfg["top_k"],
                       cfg["experts"])
    return -(-cap // cfg["block_m"]) * cfg["block_m"]


def phase_gmm(torch, device, cfg, tag, say):
    """gmm against its plain version at the MoE serving shapes: a decode
    call (max_batch rows) and a mixed call (budget + max_batch rows),
    each for ffn1 and ffn2; each timed warm (profiler, back to back) and
    with L2 flushed (CUDA events) beside its bound, the plain version and
    torch.bmm over the equal-capacity layout [E, cap_pad, K] x [E, K, N]
    (the same function for that layout). The bound: bytes against the
    3xTF32 tensor-core floor (3 TF32 products per float32 product), the
    float32 SIMT figure beside it. The kernels-line row sums one layer's
    two mixed calls (the tensor-core kernel), L2 flushed, and gives the
    two decode calls (the rows kernel), warm, as ``decode_ms``."""
    from paddle_tpu_torch.ops.hopper import grouped_gemm as gg
    E, bm, d, ffn = cfg["experts"], cfg["block_m"], cfg["d"], cfg["ffn"]
    iters = cfg["timing_iters"]
    flush = _flush_buffer(torch, device)
    layer = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 max_abs_err=0.0, by=set())
    decode_ms, Ms = 0.0, {}
    for call, rows in (("decode", cfg["max_batch"]),
                       ("mixed", cfg["budget"] + cfg["max_batch"])):
        cap_pad = _moe_cap_pad(cfg, rows)
        M = Ms[call] = E * cap_pad
        be = torch.arange(E, dtype=torch.int32, device=device
                          ).repeat_interleave(cap_pad // bm)
        for name, (K, N) in (("ffn1", (d, ffn)), ("ffn2", (ffn, d))):
            gen = torch.Generator().manual_seed(M + K)
            lhs = torch.randn((M, K), generator=gen).to(device)
            rhs = (torch.randn((E, K, N), generator=gen) /
                   np.sqrt(K)).to(device)
            got = gg.gmm(lhs, rhs, be, block_m=bm)
            ref = gg.gmm_reference(lhs, rhs, be, block_m=bm)
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            again = gg.gmm(lhs, rhs, be, block_m=bm)
            same = bool(torch.equal(again, got))
            require(bool(torch.isfinite(got).all()), f"gmm {call} {name}: "
                    f"non-finite")
            require(err <= TOL_GMM * scale, f"gmm {call} {name} disagrees: "
                    f"{err} vs max|ref| {scale}")
            require(same, f"gmm {call} {name}: two launches differ")
            del again, ref
            l3, r3 = lhs.reshape(E, cap_pad, K), rhs
            fns = (lambda: gg.gmm(lhs, rhs, be, block_m=bm),
                   lambda: gg.gmm_reference(lhs, rhs, be, block_m=bm),
                   lambda: torch.bmm(l3, r3))
            warm = _device(*(_time_ms(torch, f, device, iters)
                             for f in fns))
            ms, plain_ms, lib_ms = (_flushed_ms(torch, f, device, iters,
                                                flush) for f in fns)
            # every expert owns rows, so each weight is read once
            nbytes = (M * K + E * K * N + M * N) * 4
            flops = 2 * M * K * N
            b_ms, b_by = _bound(nbytes, 3 * flops, TF32_FLOP_S)
            simt_ms = _bound(nbytes, flops)[0]
            say(f"{tag} gmm {call} {name} M {M} (E {E} x cap_pad "
                f"{cap_pad}) K {K} N {N}: max_abs_err {err:.3e} (tol "
                f"{TOL_GMM * scale:.3e}), run to run bitwise {same}; L2 "
                f"flushed (CUDA events): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms; warm "
                f"(profiler, back to back): kernel {warm[0]:.4f}, plain "
                f"{warm[1]:.4f}, torch.bmm {warm[2]:.4f} ms; bound "
                f"{b_ms:.4f} ms ({b_by}; 3xTF32 floor: {nbytes} B, "
                f"3 x {flops} TF32 flop at {TF32_FLOP_S:.4g}/s; the float32 "
                f"SIMT figure {simt_ms:.4f} ms)")
            if call == "mixed":
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms),
                                 ("bound_ms", b_ms)):
                    layer[key] += val
                layer["max_abs_err"] = max(layer["max_abs_err"], err)
                layer["by"].add(b_by)
            else:
                decode_ms += warm[0]
            del lhs, rhs, got, l3, r3, fns
    del flush
    say(f"{tag} gmm one layer's ffn1 + ffn2 at a mixed call, L2 flushed: "
        f"kernel {layer['ms']:.4f} ms, plain {layer['plain_ms']:.4f} ms, "
        f"bmm {layer['library_ms']:.4f} ms, bound {layer['bound_ms']:.4f} "
        f"ms; its two decode calls, warm: kernel {decode_ms:.4f} ms")
    return dict(
        name="gmm", route="cuda",
        source="paddle_tpu_torch/csrc/grouped_gemm.cu",
        replaces="paddle_tpu/ops/pallas/grouped_gemm.py:65",
        timed=f"one layer's ffn1 + ffn2 at a mixed call (M {Ms['mixed']}, "
        f"the 3xTF32 tile kernel), L2 flushed, CUDA events per call; "
        f"decode_ms: its two decode calls (M {Ms['decode']}, the rows "
        f"kernel), warm, profiler device time",
        decode_ms=decode_ms,
        max_abs_err=layer["max_abs_err"], ms=layer["ms"],
        plain_ms=layer["plain_ms"], bound_ms=layer["bound_ms"],
        bound_by="bytes" if layer["by"] == {"bytes"} else "operations",
        library_ms=layer["library_ms"])


def build_moe_model(torch, device, cfg, seed, emb):
    from paddle_tpu_torch.inference import MoeServingCore, TokenServingModel
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    core = MoeServingCore(cfg["d"], cfg["heads"], cfg["ffn"],
                          num_experts=cfg["experts"], top_k=cfg["top_k"],
                          capacity_factor=cfg["capacity_factor"],
                          block_m=cfg["block_m"], num_layers=cfg["layers"],
                          device=device, generator=gen)
    return TokenServingModel(core, emb)          # tied head


def phase_moe_serve(torch, device, cfg, tsm_moe, prompts, counts, tag, say):
    """Phase 3's traffic through the MoE model: the same scheduling
    counts, 2 gmm launches per layer per model call, moe.* in the
    registry after every round."""
    seen = []

    def check(eng):
        reg = eng.engine.registry.as_dict()
        seen.append(reg.get("moe.routed_tokens", 0))
        require("moe.overflow_rate" in reg and seen[-1] > 0,
                "moe.* missing from the registry after a round")
    r = phase_serve(torch, device, cfg, tsm_moe, prompts, tag, say,
                    "MoE serving (8 experts, top-2)", cfg["num_blocks"],
                    each_round=check)
    m = tsm_moe.core.moe_metrics()
    g = r["launches"]["gmm"]
    say(f"{tag} MoE serving: scheduling counts {r['counts']} (dense "
        f"phase 3: {counts}); gmm launches {g} (= 2 x {cfg['layers']} x "
        f"{len(r['rows'])} model calls); routed_tokens "
        f"{m['routed_tokens']}, dropped_tokens {m['dropped_tokens']}, "
        f"overflow rate {m['overflow_rate']:.4f}; per-expert load "
        f"{m['load']}; per-expert overflow {m['overflow']}")
    require(r["counts"] == counts, "MoE scheduling counts differ from "
            "phase 3's")
    require(len(seen) == r["counts"]["rounds"], "a round without moe.*")
    if device.type == "cuda":
        require(g == 2 * cfg["layers"] * len(r["rows"]) > 0,
                f"gmm launches {g} != 2 x layers x model calls")
    return r


def phase_moe_vs_fold(torch, device, cfg, tsm_moe, tag, say):
    """Per layer, the gmm path against the per-expert fold on the same
    rows; one whole forward of shard_experts(2) against the unsharded
    fold, bitwise."""
    core = tsm_moe.core
    gen = torch.Generator().manual_seed(5)
    B = cfg["max_batch"]
    dec = torch.randn((B, cfg["d"]), generator=gen)
    dec[B - 3:] = 0.0                    # inactive slots feed zero rows
    inputs = {"decode": dec.to(device),
              "512 rows": torch.randn((512, cfg["d"]),
                                      generator=gen).to(device)}
    worst = {}
    with torch.no_grad():
        for what, x in inputs.items():
            worst[what] = 0.0
            for i, blk in enumerate(core.layers):
                h = blk.ffn_ln(x)
                outs, counts = [], []
                for uk in (True, False):
                    core._use_kernel = uk
                    l0 = core._load[i].clone()
                    d0 = core._dropped[i].clone()
                    outs.append(core._moe_ffn(i, blk, h))
                    counts.append(((core._load[i] - l0).tolist(),
                                   (core._dropped[i] - d0).tolist()))
                require(counts[0] == counts[1], f"layer {i} {what}: "
                        f"routing differs between the paths")
                err = float((outs[0] - outs[1]).abs().max())
                rel = err / max(float(outs[1].abs().max()), 1e-30)
                worst[what] = max(worst[what], rel)
                require(rel <= TOL_REL, f"layer {i} {what}: gmm path vs "
                        f"fold {rel:.3e} x max|out|")
        core._use_kernel = False
        twin = core.truncated(core.num_layers).shard_experts(2)
        x = torch.randn((2, 16, cfg["d"]), generator=gen).to(device)
        causal = torch.full((16, 16), -1e30, device=device).triu(1)
        same = bool(torch.equal(twin(x, attn_mask=causal),
                                core(x, attn_mask=causal)))
        core._use_kernel = None
    say(f"{tag} gmm path vs per-expert fold, worst layer: "
        + ", ".join(f"{k} {v:.3e} x max|out|" for k, v in worst.items())
        + f" (tol {TOL_REL}); routing equal in all {core.num_layers} "
        f"layers; shard_experts(2) forward bitwise equal to the fold: "
        f"{same}")
    require(same, "shard_experts(2) differs from the unsharded fold")


def phase_spec(torch, device, cfg, tsm, tsm_moe, prompts, toks, first_small,
               tag, say):
    """Dense k=4 with a truncated draft, and with the target as its own
    draft (which accepts most proposals: the accept path at work),
    against phase 4's greedy tokens; MoE k=2 with the MoE draft. Returns
    the launches per run."""
    from paddle_tpu_torch.inference import SpeculativeEngine
    from paddle_tpu_torch.ops.hopper import grouped_gemm as gg
    from paddle_tpu_torch.ops.hopper import paged_attention as pa
    n = cfg["spec_requests"]
    prompts, n_new = prompts[:n], cfg["new_tokens"]
    nd = cfg["draft_layers"]
    out = {}
    for label, model, draft, k in (
            (f"dense, {nd}-layer truncated draft", tsm,
             tsm.truncated_draft(nd), cfg["spec_k"]),
            ("dense, self-draft", tsm, None, cfg["spec_k"]),
            (f"MoE, {nd}-layer truncated MoE draft", tsm_moe,
             tsm_moe.truncated_draft(nd), cfg["moe_spec_k"])):
        eng = SpeculativeEngine(
            model, draft, k=k,
            max_batch=cfg["max_batch"], block_size=cfg["block_size"],
            num_blocks=cfg["num_blocks"], chunk_tokens=cfg["chunk_tokens"],
            prefill_token_budget=cfg["budget"])
        pa.reset_launch_count()
        gg.reset_launch_count()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p) for p in prompts]
        done, rounds = {}, 0
        while len(done) < len(rids):
            rounds += 1
            require(rounds < 50 * n_new, "speculative serving did not "
                    "converge")
            eng.step()
            for r in rids:
                if r not in done and r in eng._by_rid and \
                        len(eng.generated(r)) >= n_new:
                    done[r] = eng.generated(r)[:n_new]
                    eng.release(r)
        if device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        eng.check_invariants()
        st = eng.stats
        streams = [done[r] for r in rids]
        out[label] = dict(ragged=pa.launch_count(), gmm=gg.launch_count(),
                          streams=streams)
        say(f"{tag} speculative {label}, k {k}: {n} requests x {n_new} "
            f"tokens in "
            f"{secs:.3f} s = {n * n_new / secs:.2f} tokens/s; {rounds} "
            f"rounds; acceptance rate {st.acceptance_rate:.4f}, tokens per "
            f"target step {st.tokens_per_target_step:.4f}, proposed "
            f"{st.proposed}, accepted {st.accepted}, draft-pool OOM rolls "
            f"{st.draft_oom_rolls}; ragged launches {out[label]['ragged']}"
            f", gmm launches {out[label]['gmm']}")
        require(all(len(s) == n_new and 0 <= min(s) and
                    max(s) < model.vocab_size for s in streams),
                "malformed speculative token stream")
        if model is tsm:
            agree = [sum(a == b for a, b in zip(s, t))
                     for s, t in zip(streams, toks)]
            ok = all(s[:u] == t[:u] for s, t, u in
                     zip(streams, toks, first_small))
            say(f"{tag} speculative {label} vs k=0 greedy tokens: agree "
                f"{agree} of {n_new} per request; first near-tie step "
                f"{first_small}")
            require(ok, "speculative tokens differ from the k=0 tokens "
                    "before the first near-tie")
            if draft is None:
                require(st.accepted > 0, "the self-draft accepted nothing")
        elif device.type == "cuda":
            require(out[label]["gmm"] > 0, "MoE speculation launched no "
                    "gmm")
    return out


# -- phase 18: fork-shared parallel decoding ------------------------------
def _serve_groups(eng, want, n_new, on_round=None, lanes=None):
    """Step ``eng`` until every stream of ``want`` ({rid: n}: a group id
    and its branch count, or a lone rid and 1) has ``n_new`` tokens,
    releasing each stream once it has them. Returns ({rid: member rids},
    {rid: tokens}, rounds); ``lanes`` gets each stream's RNG lane."""
    members, done, rounds = {}, {}, 0
    while True:
        for gid, n in want.items():
            g = eng.group(gid) if n > 1 else {"rids": [gid]}
            if gid not in members and g is not None and \
                    len(g["rids"]) == n:
                members[gid] = list(g["rids"])
        for rids in members.values():
            for r in rids:
                if r not in done and r in eng._by_rid and \
                        len(eng.generated(r)) >= n_new:
                    done[r] = eng.generated(r)[:n_new]
                    if lanes is not None:
                        lanes[r] = eng._by_rid[r].lane
                    eng.release(r)
        if len(members) == len(want) and \
                all(r in done for rids in members.values() for r in rids):
            return members, done, rounds
        rounds += 1
        require(rounds < 100 * n_new, "parallel serving did not converge")
        eng.step()
        if on_round is not None:
            on_round(eng)


def _draw_recorder(tsm):
    """Wrap ``tsm.sample`` to record, per RNG lane, the CDF interval
    [lo, hi) of every token drawn on it (the float64 CDF the sampler
    searches). Returns the {lane: [(lo, hi)]} dict; ``del tsm.sample``
    unwraps."""
    draws = {}
    sample = tsm.sample

    def recording(logits, mode="greedy", temperature=1.0, top_k=None,
                  rng=None, rng_rows=None, logit_mask=None):
        toks, probs = sample(logits, mode, temperature, top_k, rng,
                             rng_rows, logit_mask)
        if rng_rows is not None and probs is not None:
            flat = probs.reshape(-1, probs.shape[-1]).astype(np.float64)
            flat = flat / flat.sum(axis=-1, keepdims=True)
            for i, (r, t) in enumerate(zip(rng_rows, toks.reshape(-1))):
                if r is not None:
                    cdf = np.cumsum(flat[i])
                    draws.setdefault(r, []).append(
                        (float(cdf[t - 1]) if t > 0 else 0.0,
                         float(cdf[t])))
        return toks, probs
    tsm.sample = recording
    return draws


def _first_edge_draw(seed, *intervals):
    """Index of the first draw of the lane seeded ``seed`` whose uniform
    lies within TOL_LANE of an edge of its token's CDF interval in any of
    the runs ``intervals`` ([(lo, hi)] each), else the draws' count."""
    n = min(len(iv) for iv in intervals)
    u = np.random.RandomState(seed).random_sample(n)
    for j in range(n):
        if any(min(u[j] - iv[j][0], iv[j][1] - u[j]) < TOL_LANE
               for iv in intervals):
            return j
    return n


def _near_tie(torch, device, cfg, core, tsm, prompt, stream, **engine_kw):
    """First step of ``stream`` (greedy from ``prompt``) whose top-two
    logit gap is below TOL_REL x max|logits| (phase 4's near-tie rule),
    teacher-forcing the stream through a paged engine over ``core``."""
    h, _ = teacher_force(torch, device, cfg, core, tsm, [prompt], [stream],
                         **engine_kw)
    lg = tsm.logits(h)
    top2 = lg.topk(2, dim=-1).values[0]
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    small = np.flatnonzero(gap < TOL_REL * float(lg.abs().max()))
    return int(small[0]) if small.size else len(stream)


def phase_parallel(torch, device, cfg, tsm, prompts, toks, first_small,
                   tag, say):
    """Fork-shared parallel decoding at full width over phase 3's pool
    shape: greedy groups against phase 4's tokens, the lane oracle,
    shared pages on float and int8 pools, best-of, fork_stream and a
    grammar mask under speculation, and a group against lone submits.
    Returns the ragged launch count of the greedy groups' run."""
    from paddle_tpu_torch.inference import (SpeculativeEngine,
                                            branch_lane_seed,
                                            register_logit_mask)
    from paddle_tpu_torch.ops.hopper import paged_attention as pa
    n_new, n, L = cfg["new_tokens"], cfg["par_n"], cfg["layers"]
    bs, S = cfg["block_size"], cfg["lane_seed"]
    prompts = prompts[:cfg["spec_requests"]]

    def engine(model=tsm, draft=None, k=0, **kw):
        kw = dict(dict(max_batch=cfg["max_batch"], block_size=bs,
                       num_blocks=cfg["num_blocks"],
                       chunk_tokens=cfg["chunk_tokens"],
                       prefill_token_budget=cfg["budget"]), **kw)
        return SpeculativeEngine(model, draft, k=k, **kw)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # 1. greedy groups: every branch is phase 4's greedy stream
    calls = []
    hook = tsm.core.register_forward_pre_hook(
        lambda m, a: calls.append(a[0].shape[1]))
    eng = engine()
    pa.reset_launch_count()
    sync()
    t0 = time.perf_counter()
    gids = [eng.submit(p, n=n) for p in prompts]
    members, done, rounds = _serve_groups(eng, {g: n for g in gids}, n_new)
    sync()
    secs = time.perf_counter() - t0
    hook.remove()
    launches = pa.launch_count()
    ps = eng.engine.parallel_stats
    saved = (n - 1) * sum(len(p) for p in prompts)
    say(f"{tag} parallel greedy: {len(gids)} groups of n={n} x {n_new} "
        f"tokens in {secs:.3f} s = {len(done) * n_new / secs:.2f} "
        f"tokens/s; {rounds} rounds, {len(calls)} model calls; "
        f"parallel.groups {ps.groups}, branches {ps.branches}, "
        f"prefill_tokens_saved {ps.prefill_tokens_saved} (= {n - 1} x "
        f"{sum(len(p) for p in prompts)}), shared_blocks "
        f"{ps.shared_blocks}; ragged launches {launches} (= {L} x "
        f"{len(calls)} model calls); preemptions "
        f"{sum(o.preemptions for o in eng.outcomes)}")
    require(ps.groups == len(gids) and ps.branches == (n - 1) * len(gids)
            and ps.prefill_tokens_saved == saved,
            f"parallel counts {ps.as_dict()} (want groups {len(gids)}, "
            f"branches {(n - 1) * len(gids)}, saved {saved})")
    for i, gid in enumerate(gids):
        u = first_small[i]
        bad = [r for r in members[gid] if done[r][:u] != toks[i][:u]]
        require(not bad, f"group {gid}: branches {bad} differ from phase "
                f"4's greedy tokens before the first near-tie ({u})")
    if device.type == "cuda":
        require(launches == L * len(calls) > 0,
                f"ragged launches {launches} != {L} x {len(calls)} model "
                f"calls")
    eng.check_invariants()
    del eng

    # 2. the lane oracle: a seeded group == n lone lane-seeded submits
    samp = dict(sampling="top_k", top_k=cfg["lane_top_k"], temperature=1.0)
    p = prompts[0]
    runs = {}
    for label in ("group", "lone"):
        eng = engine(**samp)
        draws = _draw_recorder(tsm)
        lanes = {}
        if label == "group":
            want = {eng.submit(p, n=n, seed=S): n}
        else:
            want = {eng.submit(p, seed=branch_lane_seed(S, i)): 1
                    for i in range(n)}
        members, done, _ = _serve_groups(eng, want, n_new, lanes=lanes)
        del tsm.sample
        order = [r for rids in members.values() for r in rids]
        runs[label] = [(done[r], draws[lanes[r]]) for r in order]
        del eng
    agree = []
    for i, ((sg, dg), (sl, dl)) in enumerate(zip(runs["group"],
                                                runs["lone"])):
        j = _first_edge_draw(branch_lane_seed(S, i), dg, dl)
        agree.append((sum(a == b for a, b in zip(sg, sl)), j))
        require(sg[:j] == sl[:j],
                f"lane oracle: branch {i} differs from its lone submit "
                f"before draw {j}, the first within {TOL_LANE} of a CDF "
                f"edge")
    distinct = len({tuple(s) for s, _ in runs["group"]})
    say(f"{tag} parallel lane oracle (top_k {cfg['lane_top_k']}, seed "
        f"{S}): per branch (tokens equal to its lone submit of {n_new}, "
        f"first draw within {TOL_LANE} of a CDF edge): {agree}; "
        f"{distinct} distinct branch streams")
    require(distinct >= 2, "the lane oracle's branches never diverged")

    # 3-4. shared pages on a float pool and on an int8 pool with the
    # prefix cache: 2 full pages + 5 tokens, 3 decode tokens
    p37 = [int(t) for t in np.random.RandomState(cfg["lane_seed"]).randint(
        0, cfg["vocab"], 2 * bs + 5)]
    for label, kw in (("float", {}),
                      ("int8 + prefix", dict(kv_dtype="int8",
                                             prefix_cache=True))):
        use = {}
        for mode in ("group", "lone"):
            eng = engine(**samp, **kw)
            if mode == "group":
                rids = [eng.submit(p37, n=n, seed=S)]
                while len((eng.group(rids[0]) or {"rids": []})["rids"]) < n:
                    eng.step()
                rids = eng.group(rids[0])["rids"]
            else:
                rids = [eng.submit(p37, seed=branch_lane_seed(S, i))
                        for i in range(n)]
            slots = lambda: [eng._by_rid[r].slot for r in rids]  # noqa
            while not all(s is not None and
                          int(eng.engine.lens[s]) >= len(p37) + 3
                          for s in slots()):
                eng.step()
            pe = eng.engine
            use[mode] = (pe.cache.blocks_in_use,
                         pe.cache.share_report(slots()))
            if mode == "group":
                rep = use[mode][1]
                nf = len(p37) // bs
                full = pe.cache.seq_blocks[slots()[0]][:nf]
                tails = {pe.cache.seq_blocks[s][nf] for s in slots()}
                require(all(rep["multiplicity"][b] == n and
                            rep["refcount"][b] >= n for b in full),
                        f"{label}: full prompt pages {full} not shared by "
                        f"the {n} branches: {rep}")
                require(len(tails) == n, f"{label}: tail pages {tails} "
                        f"are not distinct: the COW split did not run")
                eng.check_invariants()
                pe.cache.check_invariants(lens=pe.lens, active=pe.active,
                                          deep=True)
            del eng
        say(f"{tag} parallel shared pages ({label} pool, prompt "
            f"{len(p37)} tokens, 3 decode tokens): group of {n} uses "
            f"{use['group'][0]} blocks, bytes_saved "
            f"{use['group'][1]['bytes_saved']} B; {n} lone streams use "
            f"{use['lone'][0]} blocks; audits held (deep)")

    # 4. a greedy int8 group == the lone int8 stream, to the near-tie
    q = dict(kv_dtype="int8", prefix_cache=True)
    out = {}
    for mode in ("group", "lone"):
        eng = engine(**q)
        want = {eng.submit(p, n=n if mode == "group" else 1):
                n if mode == "group" else 1}
        members, done, _ = _serve_groups(eng, want, n_new)
        out[mode] = [done[r] for rids in members.values() for r in rids]
        del eng
    lone = out["lone"][0]
    u = _near_tie(torch, device, cfg, tsm.core, tsm, p, lone, dtype="int8",
                  prefix_cache=True)
    agree = [sum(a == b for a, b in zip(s, lone)) for s in out["group"]]
    say(f"{tag} parallel int8 pages + prefix cache: greedy group vs lone "
        f"int8 stream, tokens equal {agree} of {n_new}; first near-tie "
        f"step {u}")
    require(all(s[:u] == lone[:u] for s in out["group"]),
            "int8 group differs from the lone int8 stream before the "
            "first near-tie")

    # 5. best-of: the first member at page capacity wins
    mb = -(-len(prompts[1]) // bs) + 1
    eng = engine(max_blocks_per_seq=mb, **samp, seed=S)
    fresh = eng.engine.free_blocks
    gid = eng.submit(prompts[1], n=3, seed=S, best_of=True)
    rounds = 0
    while not (eng.group(gid) or {}).get("done"):
        rounds += 1
        require(rounds < 100 * mb * bs, "best-of did not finish")
        eng.step()
    eng.step()
    g = eng.group(gid)
    st = [o.status for o in eng.outcomes]
    rs = eng.resilience_stats
    for r in g["rids"]:
        eng.release(r)
    say(f"{tag} parallel best-of n=3 (capacity {mb * bs} tokens): winner "
        f"{g['winner']} of {g['rids']}; outcomes {st}; cancelled "
        f"{rs.cancelled}, failed {rs.failed}; free blocks "
        f"{eng.engine.free_blocks} of {fresh} after release")
    require(g["winner"] in g["rids"] and st.count("cancelled") == 2 and
            st.count("finished") == 1, f"best-of outcomes {st}")
    require(rs.cancelled == 2 and rs.failed == 0,
            f"best-of resilience counts {rs.as_dict()}")
    require(eng.engine.free_blocks == fresh,
            "best-of left pages behind after release")
    del eng

    # 6. fork_stream and a grammar mask under speculation (k, draft)
    nd, k = cfg["draft_layers"], cfg["spec_k"]
    draft = tsm.truncated_draft(nd)
    eng = engine(draft=draft, k=k)
    r0 = eng.submit(prompts[0])
    while len(eng.generated(r0)) < n_new // 4:
        eng.step()
    cut = len(eng.generated(r0))
    r1 = eng.fork_stream(r0)
    _, done, _ = _serve_groups(eng, {r0: 1, r1: 1}, n_new)
    u = first_small[0]
    say(f"{tag} parallel fork_stream under k={k} ({nd}-layer draft): "
        f"forked at {cut} tokens; source / clone equal to phase 4's "
        f"tokens {sum(a == b for a, b in zip(done[r0], toks[0]))} / "
        f"{sum(a == b for a, b in zip(done[r1], toks[0]))} of {n_new}; "
        f"first near-tie step {u}")
    require(done[r0][:u] == toks[0][:u] and done[r1][:u] == toks[0][:u],
            "fork_stream clone or source left phase 4's greedy tokens "
            "before the first near-tie")
    eng.check_invariants()
    del eng
    mod = cfg["mask_mod"]
    register_logit_mask(
        "chip_smoke_mod", lambda ts, V: np.arange(V) % mod == len(ts) % mod)
    eng = engine(draft=draft, k=k, **samp)
    gid = eng.submit(prompts[1], n=2, seed=S, logit_mask="chip_smoke_mod")
    members, done, _ = _serve_groups(eng, {gid: 2}, n_new)
    plen = len(prompts[1])
    bad = [(r, i, t) for r, s in done.items() for i, t in enumerate(s)
           if t % mod != (plen + i) % mod]
    st = eng.stats
    say(f"{tag} parallel grammar mask (token id = stream length mod "
        f"{mod}, vocab {cfg['vocab']}) under top_k {cfg['lane_top_k']}, "
        f"k={k}: {sum(len(s) for s in done.values())} tokens, "
        f"{len(bad)} outside the mask; proposed {st.proposed}, accepted "
        f"{st.accepted}, rolled back {st.rolled_back}")
    require(not bad, f"tokens outside the grammar mask: {bad[:5]}")
    require(st.rolled_back > 0, "no rejection: the residual path did "
            "not run under the mask")
    eng.check_invariants()
    del eng, draft

    # 7. printed only: one group against n lone submits at equal pool
    # bytes (bench_extra.py's bench_serving_parallel at full width)
    pb = cfg["par_prompt_blocks"]
    pbench = [int(t) for t in np.random.RandomState(S + 1).randint(
        0, cfg["vocab"], pb * bs)]
    bench = dict(max_batch=n, num_blocks=pb + n + 2,
                 max_blocks_per_seq=pb + 1, prefill_token_budget=None,
                 sampling="top_k", top_k=10, temperature=1.0, seed=7)
    eng = engine(**bench)
    sync()
    t0 = time.perf_counter()
    gid = eng.submit(pbench, n=n, seed=S)
    steps = 0
    while True:
        rids = (eng.group(gid) or {"rids": []})["rids"]
        if len(rids) == n and all(len(eng.generated(r)) >= bs
                                  for r in rids):
            break
        eng.step()
        steps += 1
    sync()
    g_s = time.perf_counter() - t0
    g_tok = sum(min(len(eng.generated(r)), bs) for r in rids)
    pool = eng.engine.cache.pool_bytes()
    del eng
    eng = engine(**bench)
    sync()
    t0 = time.perf_counter()
    rids = [eng.submit(pbench, seed=branch_lane_seed(S, i))
            for i in range(n)]
    for _ in range(steps):
        eng.step()
    sync()
    i_s = time.perf_counter() - t0
    i_tok = sum(min(len(eng.generated(r)), bs) for r in rids)
    require(eng.engine.cache.pool_bytes() == pool, "unequal pool bytes")
    del eng
    say(f"{tag} parallel vs lone at equal pool bytes ({pool} B, "
        f"{pb + n + 1} usable blocks, prompt {pb * bs} tokens, {bs} new "
        f"a stream, {steps} steps each; printed only): group of {n} "
        f"{g_tok} tokens in {g_s:.3f} s = {g_tok / g_s:.2f} tokens/s; "
        f"{n} lone submits {i_tok} tokens in {i_s:.3f} s = "
        f"{i_tok / i_s:.2f} tokens/s")
    return launches


# -- phase 19: snapshots, slices, faults, deadlines, tenants, ragged_step -
def _drive(eng, rids, n_new, done, stop=None, on_round=None, failed=None,
           limit=2000):
    """phase_serve's loop from any point: step, then release each rid of
    ``rids`` that has ``n_new`` tokens (into ``done``); until every rid
    is done or failed (``failed`` collects failure outcomes) or
    ``stop(eng)`` after a round. Returns the rounds run."""
    rounds = 0
    while True:
        if failed is not None:
            for oc in eng.outcomes:
                if oc.failed:
                    failed[oc.rid] = oc
        if all(r in done or (failed is not None and r in failed)
               for r in rids):
            return rounds
        rounds += 1
        require(rounds < limit, "serving did not converge")
        eng.step()
        if on_round is not None:
            on_round(eng)
        for r in rids:
            if r not in done and r in eng._by_rid and \
                    len(eng.generated(r)) >= n_new:
                done[r] = eng.generated(r)[:n_new]
                eng.release(r)
        if stop is not None and stop(eng):
            return rounds


def _after(n):
    """A ``_drive`` stop condition that holds after ``n`` rounds."""
    seen = [0]

    def stop(eng):
        seen[0] += 1
        return seen[0] >= n
    return stop


def _counting(tsm):
    """A forward pre-hook counting ``tsm.core``'s model calls; returns
    (list of call row counts, hook handle)."""
    rows = []
    return rows, tsm.core.register_forward_pre_hook(
        lambda m, a: rows.append(a[0].shape[0] * a[0].shape[1]))


def _upto(streams, ref, first):
    """Requests whose stream differs from ``ref`` before its first
    near-tie step ``first``."""
    return [i for i, (s, t, u) in enumerate(zip(streams, ref, first))
            if s[:u] != t[:u]]


def phase_resilience(torch, device, cfg, tsm, tsm8, prompts, qprompts,
                     serve, qserve, toks, first_small, tag, say):
    """Phase 19: the serving stack's snapshots, slices, fault injection,
    numeric guard, deadlines, tenants and per-phase steps at full width
    over phase 3's (and phase 5's) traffic and pools. Returns nothing;
    every check fails the run."""
    import pickle
    from paddle_tpu_torch.inference import (CrashInjector, EngineCrash,
                                            FaultInjector, PagedKVCache,
                                            RequestOutcome,
                                            SpeculativeEngine)
    from paddle_tpu_torch.ops.hopper import paged_attention as pa
    n_new, L, bs = cfg["new_tokens"], cfg["layers"], cfg["block_size"]
    ref = serve["streams"]

    def engine(model=tsm, draft=None, k=0, **kw):
        kw = dict(dict(max_batch=cfg["max_batch"], block_size=bs,
                       num_blocks=cfg["num_blocks"],
                       chunk_tokens=cfg["chunk_tokens"],
                       prefill_token_budget=cfg["budget"]), **kw)
        return SpeculativeEngine(model, draft, k=k, **kw)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # near-tie steps of all 12 phase-3 streams (phase 4's rule), for the
    # checks whose batching differs from phase 3's
    first12, tol = _first_near_ties(torch, device, cfg, tsm, prompts, ref)
    say(f"{tag} resilience: phase 3's streams' first near-tie steps "
        f"{first12} (of {n_new}; top-two gap < {tol:.3e})")

    # 1. a snapshot in flight (+ a queued request's deadline)
    dl = 2
    rows, hook = _counting(tsm)
    eng = engine()
    rids = [eng.submit(p) for p in prompts]
    late = eng.submit(prompts[0], deadline_steps=dl)
    done, cut = {}, {}

    def at_cut(e):
        # phase 3's preempted requests re-admit within the step that
        # evicts them, so the cut is the first step boundary with a
        # preempted request re-prefilling and requests queued
        pe = e.engine
        return any(pe._requests[s].preemptions > 0 for s in pe._prefills) \
            and pe._queue_len > 0
    r1 = _drive(eng, rids, n_new, done, stop=at_cut)
    require(at_cut(eng), "no step boundary with a preempted request "
            "mid-prefill and requests queued")
    cut_round = r1
    sync()
    t0 = time.perf_counter()
    snap = eng.snapshot()
    t_snap = time.perf_counter() - t0
    blob = pickle.dumps(snap, protocol=pickle.HIGHEST_PROTOCOL)
    nbytes = len(blob)
    cut.update(done=dict(done), rows=len(rows),
               stats=eng.engine.prefill_stats.as_dict())
    n_blocks = len(snap["engine"]["cache"]["blocks"])
    r1 += _drive(eng, rids, n_new, done)
    hook.remove()
    after1 = dict(rows=len(rows) - cut["rows"],
                  stats=eng.engine.prefill_stats.as_dict())
    outs1 = [o.as_dict() for o in eng.outcomes]
    pre1 = sum(o["preemptions"] for o in outs1)
    (dead,) = [o for o in eng.outcomes if o.rid == late]
    require(dead.status == RequestOutcome.FAILED_DEADLINE and
            dead.step == dl + 1 and "2 steps" in dead.reason,
            f"the queued request's deadline outcome {dead.as_dict()} "
            f"(want failed_deadline at step {dl + 1})")
    require([done[r] for r in rids] == ref, "the run with a deadline "
            "request left phase 3's streams")
    counts1 = dict(rounds=r1, model_calls=len(rows),
                   mixed_steps=after1["stats"]["mixed_steps"],
                   preemptions=pre1)
    require(counts1 == serve["counts"], f"the run with a deadline request "
            f"scheduled {counts1}, phase 3 {serve['counts']}")
    del eng
    gc.collect()
    # restore from the unpickled bytes (the timing is the restore's)
    snap = pickle.loads(blob)
    del blob
    sync()
    t0 = time.perf_counter()
    eng = SpeculativeEngine.restore(tsm, None, snap)
    sync()
    t_rest = time.perf_counter() - t0
    eng.check_invariants()
    rows, hook = _counting(tsm)
    done2 = dict(cut["done"])
    _drive(eng, rids, n_new, done2)
    hook.remove()
    after2 = dict(rows=len(rows), stats=eng.engine.prefill_stats.as_dict())
    say(f"{tag} resilience snapshot in flight (round {cut_round}, "
        f"{int(snap['engine']['prefilling'].sum())} slot(s) mid-prefill, "
        f"a preempted one among them, {len(snap['engine']['queue'])} "
        f"queued): {nbytes} B pickled, {n_blocks} pool blocks; snapshot {t_snap:.3f} s, restore (deep audit "
        f"included) {t_rest:.3f} s; the queued request with deadline_steps"
        f" {dl}: {dead.status} at step {dead.step}; after the cut, model "
        f"calls {after1['rows']} / {after2['rows']} (run / restored), "
        f"stats equal {after1['stats'] == after2['stats']}")
    require([done2[r] for r in rids] == ref, "the restored run left phase "
            "3's streams")
    require(after1 == after2 and
            [o.as_dict() for o in eng.outcomes] == outs1,
            f"the restored run scheduled {after2}, the run {after1}")
    del eng

    # 2-3. the quantized pool: a delta snapshot, rehoming
    rows, hook = _counting(tsm8)
    eng = engine(tsm8, kv_dtype="int8", prefix_cache=True,
                 num_blocks=cfg["q_num_blocks"])
    qrids = [eng.submit(p) for p in qprompts]
    qdone = {}
    _drive(eng, qrids, n_new, qdone,
           stop=lambda e: e.engine.cache.allocator.num_cached > 0)
    require(eng.engine.cache.allocator.num_cached > 0,
            "no cached-free page in the quantized run")
    qsnap = eng.snapshot()
    qcut = dict(qdone)
    base = qsnap["engine"]["cache"]
    _drive(eng, qrids, n_new, qdone, stop=_after(3))
    cache = eng.engine.cache
    sync()
    t0 = time.perf_counter()
    delta = cache.snapshot(base=base)
    t_delta = time.perf_counter() - t0
    full = cache.snapshot()
    pay = lambda s: s["payload"].nbytes + s["scale_payload"].nbytes  # noqa
    require(len(delta["blocks"]) < len(full["blocks"]) and
            delta["base_blocks"],
            f"the delta ships {len(delta['blocks'])} rows, the full "
            f"snapshot {len(full['blocks'])}")
    a = PagedKVCache.restore(delta, base=base, device=device)
    b = PagedKVCache.restore(full, device=device)
    live = torch.tensor(sorted(int(x) for x in full["refcount"]),
                        device=device)
    same = all(torch.equal(x[live], y[live]) for x, y in
               zip(a.pools + a.scales, b.pools + b.scales))
    say(f"{tag} resilience delta snapshot (int8 pages + scales, prefix "
        f"cache, 3 rounds after the base): {len(delta['blocks'])} payload "
        f"rows ({pay(delta)} B) + {len(delta['base_blocks'])} from the "
        f"base, against {len(full['blocks'])} rows ({pay(full)} B) in a "
        f"full snapshot; delta taken in {t_delta:.3f} s; base + delta "
        f"restores the full snapshot's live pages bitwise: {same}")
    require(same, "base + delta restored other live pages than the full "
            "snapshot")
    del a, b, delta, full
    _drive(eng, qrids, n_new, qdone)
    hook.remove()
    qref = qserve["streams"]
    require([qdone[r] for r in qrids] == qref,
            "the quantized run with snapshots left phase 5's streams")
    del eng
    # near-tie steps of phase 5's streams (its int8 path and pool)
    hq, _ = teacher_force(torch, device, cfg, tsm8.core, tsm8, qprompts,
                          qref, dtype="int8", prefix_cache=True)
    lq = tsm8.logits(hq)
    top2 = lq.topk(2, dim=-1).values
    gq = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    tq = TOL_REL * float(lq.abs().max())
    firstq = [int(np.flatnonzero(x < tq)[0]) if (x < tq).any()
              else n_new for x in gq]
    del hq, lq, top2
    g = base["geometry"]
    n_live = sum(1 for n in base["refcount"].values() if n > 0)
    n_cached = len(base["cached_order"])
    for nb in (g["num_blocks"] + 90, n_live + 1 + n_cached // 2):
        s2 = dict(qsnap, engine=dict(qsnap["engine"], config=dict(
            qsnap["engine"]["config"], num_blocks=nb)))
        eng = SpeculativeEngine.restore(tsm8, None, s2)
        c = eng.engine.cache
        dropped = c.allocator.reclaimed - base["reclaimed"]
        d = dict(qcut)
        _drive(eng, qrids, n_new, d)
        eng.check_invariants()
        got = [d[r] for r in qrids]
        say(f"{tag} resilience rehome (int8 + prefix cache, snapshot of "
            f"{n_live} live + {n_cached} cached-free blocks of "
            f"{g['num_blocks'] - 1}) into {nb} blocks: {dropped} "
            f"cached-free page(s) dropped; streams equal to phase 5's "
            f"{sum(x == y for x, y in zip(got, qref))} of {len(qrids)} "
            f"(first near-tie steps {firstq})")
        bad = _upto(got, qref, firstq)
        require(not bad, f"rehomed into {nb} blocks: streams {bad} left "
                f"phase 5's before their first near-tie")
        require((dropped > 0) == (nb < g["num_blocks"]),
                f"rehome into {nb} blocks dropped {dropped} pages")
        del eng, c
    del qsnap, base
    gc.collect()

    # 4. a slice: one running request moves to a second engine
    src = engine()
    rid = src.submit(prompts[0])
    _drive(src, [rid], n_new, {},
           stop=lambda e: len(e.generated(rid)) >= n_new // 4)
    head = src.generated(rid)
    slc = src.export_slice(rid)
    src.check_invariants()
    dst = engine(prefix_cache=True)
    got = dst.import_slice(slc)
    rid2 = dst.submit(src.tokens(rid), resume=True)
    tail = {}
    _drive(dst, [rid2], n_new - len(head), tail)
    stream = head + tail[rid2]
    dst.check_invariants()
    hits = dst.engine.prefix_stats.hit_blocks
    say(f"{tag} resilience slice: request {rid} moved after {len(head)} "
        f"tokens, {len(slc['hashes'])} pages ({slc['payload'].nbytes} B) "
        f"exported, {got} imported, {hits} adopted at resume; stream "
        f"equal to phase 3's {sum(x == y for x, y in zip(stream, ref[0]))}"
        f" of {n_new} (first near-tie {first12[0]}); source audit held")
    require(got == len(slc["hashes"]) == hits > 0,
            "the slice's pages were not imported and adopted")
    require(not _upto([stream], ref[:1], first12[:1]),
            "the moved request left phase 3's stream")
    del src, dst, slc

    # 5. a crash at post_prefill, restored from the last step-boundary
    # snapshot (every 4 rounds) and re-driven
    inj = CrashInjector(crash_at={3: "post_prefill", 6: "post_prefill"})
    eng = engine(injector=inj)
    rids = [eng.submit(p) for p in prompts]
    done = {}
    saved = (eng.snapshot(), dict(done))
    rounds, restores = 0, 0
    while not all(r in done for r in rids):
        rounds += 1
        require(rounds < 2000, "the crash run did not converge")
        inj.begin_round()
        try:
            _drive(eng, rids, n_new, done, stop=lambda e: True)
        except EngineCrash:
            del eng
            eng = SpeculativeEngine.restore(tsm, None, saved[0],
                                            injector=inj)
            done = dict(saved[1])
            restores += 1
            continue
        if rounds % 4 == 0:
            saved = (eng.snapshot(), dict(done))
    say(f"{tag} resilience crash: CrashInjector at post_prefill, "
        f"{inj.crashes} crash(es), {restores} restore(s) from the last "
        f"4-round snapshot; {rounds} live rounds; streams equal to phase "
        f"3's: {[done[r] for r in rids] == ref}")
    require(inj.crashes >= 1 and restores == inj.crashes,
            "no injected crash fired")
    require([done[r] for r in rids] == ref,
            "the run re-driven after a crash left phase 3's streams")
    del eng, saved

    # 6. a seeded fault storm: forced OOM sheds and NaN slots. A
    # whole-step OOM sheds only the oldest grower (younger growers
    # requeue), which phase 3's staggered lengths make rare; with no
    # retry budget every eviction it forces is a shed, and a pool with
    # room for all 12 requests keeps every eviction a forced one
    seed = cfg["storm_seed"]
    inj = FaultInjector.storm(seed, cfg["storm_steps"], oom_sheds=3,
                              nan_events=2, max_batch=cfg["max_batch"])
    eng = engine(injector=inj, num_blocks=cfg["storm_num_blocks"],
                 max_preemptions=0)
    quarantined = []
    qseq = eng.engine.cache.quarantine_seq

    def recording(slot, c=eng.engine.cache):
        quarantined.extend((int(b), c._block_hash.get(int(b)))
                           for b in c.seq_blocks[slot]
                           if c.allocator.refcount[b] == 1)
        qseq(slot)
    eng.engine.cache.quarantine_seq = recording
    rids = [eng.submit(p) for p in prompts]
    done, failed, later = {}, {}, []

    def probe(e):
        if quarantined and not later:
            later.append(e.engine.cache.snapshot())
    _drive(eng, rids, n_new, done, failed=failed, on_round=probe)
    eng.check_invariants()
    sheds = [o for o in failed.values()
             if o.status == RequestOutcome.FAILED_OOM]
    nans = [o for o in failed.values()
            if o.status == RequestOutcome.FAILED_NUMERIC]
    oom_steps = set(inj._oom["target"])
    require(len(sheds) >= 3 and len(nans) >= 2,
            f"storm seed {seed}: {len(sheds)} sheds, {len(nans)} NaN "
            f"failures (want >= 3 and >= 2)")
    require(all(o.step in oom_steps for o in sheds),
            f"sheds at steps {[o.step for o in sheds]} outside the "
            f"schedule {sorted(oom_steps)}")
    require(all(o.step in inj.nan_at and f"slot {inj.nan_at[o.step][0]} "
                in o.reason for o in nans),
            f"NaN failures {[o.as_dict() for o in nans]} are not the "
            f"schedule's {inj.nan_at}")
    surv = [i for i, r in enumerate(rids) if r in done]
    bad = _upto([done[rids[i]] for i in surv], [ref[i] for i in surv],
                [first12[i] for i in surv])
    exact = sum(done[rids[i]] == ref[i] for i in surv)
    snap_q = later[0]
    idx = {b: h for h, b in snap_q["hash_index"].items()}
    held = {int(b) for bl in snap_q["seq_blocks"] for b in bl}
    leak = [b for b, h in quarantined
            if b in snap_q["cached_order"] or (h is not None and
                                                idx.get(b) == h)
            or (b in snap_q["blocks"] and b not in held)]
    say(f"{tag} resilience fault storm (seed {seed}, "
        f"{cfg['storm_num_blocks']} blocks, max_preemptions 0, OOM at steps "
        f"{sorted(oom_steps)}, NaN at {inj.nan_at}): {len(sheds)} sheds at "
        f"steps {[o.step for o in sheds]}, {len(nans)} NaN failures at "
        f"{[o.step for o in nans]}, {eng.resilience_stats.as_dict()}; "
        f"{len(surv)} survivors, {exact} equal to phase 3's over all "
        f"{n_new}; {len(quarantined)} quarantined page(s), none in the "
        f"next snapshot as cached or indexed content: {not leak}")
    require(not bad, f"survivors {bad} left phase 3's streams before "
            f"their first near-tie")
    require(not leak, f"quarantined pages {leak} rode a later snapshot")
    del eng, later, snap_q

    # 7. the speculative storm: a draft-pool OOM and corrupted draft
    # logits under k=4 with the truncated draft
    nd, k = cfg["draft_layers"], cfg["spec_k"]
    n4 = cfg["spec_requests"]
    inj = FaultInjector(draft_oom_at={s: FaultInjector.ALL
                                      for s in cfg["storm_draft_oom"]},
                        draft_nan_at={s: list(range(n4))
                                      for s in cfg["storm_draft_nan"]})
    eng = engine(draft=tsm.truncated_draft(nd), k=k, injector=inj)
    rids = [eng.submit(p) for p in prompts[:n4]]
    done = {}
    _drive(eng, rids, n_new, done)
    eng.check_invariants()
    st = eng.stats
    streams = [done[r] for r in rids]
    say(f"{tag} resilience speculative storm (k={k}, {nd}-layer draft): "
        f"{inj.injected_draft_oom} draft-pool OOM(s), "
        f"{st.draft_oom_rolls} roll(s) rolled back, "
        f"{inj.injected_draft_nan} corrupted draft row(s); proposed "
        f"{st.proposed}, accepted {st.accepted}; streams equal to phase "
        f"4's {[sum(a == b for a, b in zip(s, t)) for s, t in zip(streams, toks)]}"
        f" of {n_new} (first near-tie {first_small})")
    require(st.draft_oom_rolls >= 1 and inj.injected_draft_nan >= 1,
            "the draft faults did not fire")
    require(not any(o.failed for o in eng.outcomes),
            "a draft fault failed a request")
    require(not _upto(streams, toks, first_small),
            "the speculative storm left phase 4's tokens before the first "
            "near-tie")
    del eng

    # 8. tenants: a quota'd flooder beside two victims with floors
    victims = {"v1": prompts[0:2], "v2": prompts[2:4]}
    flood = prompts[4:12]
    nb_ = lambda n: -(-n // bs)  # noqa: E731
    quota = nb_(min(len(p) for p in flood) + 1) + 1
    ten = {t: {"reserved_blocks": sum(nb_(len(p) + n_new) for p in ps)}
           for t, ps in victims.items()}
    ten["flood"] = {"quota_blocks": quota}
    eng = engine(tenants=ten)
    vrids = [eng.submit(p, tenant_id=t) for t, ps in victims.items()
             for p in ps]
    frids = [eng.submit(p, tenant_id="flood") for p in flood]
    done, failed = {}, {}
    peak = [0]

    def audit(e):
        e.check_invariants()
        peak[0] = max(peak[0], e.engine.cache.tenant_charge("flood"))
    _drive(eng, vrids, n_new, done, on_round=audit)
    _drive(eng, frids, 10 ** 9, {}, failed=failed, on_round=audit)
    fo = {r: failed.get(r) for r in frids}
    ok = all(o is not None and (
        o.status == RequestOutcome.REJECTED_ADMISSION or
        (o.status == RequestOutcome.FAILED_OOM and "quota" in o.reason))
        for o in fo.values())
    vs = [done[r] for r in vrids]
    ts = eng.tenant_stats
    say(f"{tag} resilience tenants (victim floors "
        f"{[ten[t]['reserved_blocks'] for t in victims]} blocks, flooder "
        f"quota {quota}): flooder outcomes "
        f"{[o.status for o in fo.values()]}, its charge at most "
        f"{peak[0]}; victims' streams equal to phase 3's "
        f"{[sum(a == b for a, b in zip(s, t)) for s, t in zip(vs, ref)]} "
        f"of {n_new}; tenant stats flood {ts['flood'].as_dict()}")
    require(ok, f"a flood request did not end rejected or shed at its "
            f"quota: {[None if o is None else o.as_dict() for o in fo.values()]}")
    require(peak[0] <= quota, "the flooder went over its quota")
    require(ts["v1"].failed == 0 and ts["v2"].failed == 0,
            "a victim failed")
    require(not _upto(vs, ref[:4], first12[:4]),
            "a victim's stream left phase 3's before its near-tie")
    del eng

    # 9. ragged_step=False: phase 3's traffic in per-phase launches
    rows, hook = _counting(tsm)
    eng = engine()
    eng.engine.ragged_step = False
    pa.reset_launch_count()
    sync()
    t0 = time.perf_counter()
    rids = [eng.submit(p) for p in prompts]
    done = {}
    rounds = _drive(eng, rids, n_new, done)
    sync()
    secs = time.perf_counter() - t0
    hook.remove()
    ps_ = eng.engine.prefill_stats
    plan = ps_.chunks + ps_.decode_steps
    launches = pa.launch_count()
    streams = [done[r] for r in rids]
    tps = len(rids) * n_new / secs
    say(f"{tag} resilience ragged_step=False: {rounds} rounds, "
        f"{len(rows)} model calls (= {ps_.chunks} prefill chunks + "
        f"{ps_.decode_steps} decode steps), ragged launches {launches} "
        f"(= {L} x {plan}); streams equal to phase 3's "
        f"{sum(s == t for s, t in zip(streams, ref))} of {len(ref)}; "
        f"{tps:.2f} tokens/s against phase 3's packed "
        f"{len(ref) * n_new / serve['secs']:.2f} (printed only)")
    require(len(rows) == plan, f"{len(rows)} model calls, the plan "
            f"{plan}")
    if device.type == "cuda":
        require(launches == L * plan, f"ragged launches {launches} != "
                f"{L} x {plan}")
    require(not _upto(streams, ref, first12), "per-phase steps left phase "
            "3's streams before the first near-tie")
    del eng
    gc.collect()


# -- phase 20: durability and observability -------------------------------
def _crash_schedule(seed, windows):
    """{live round: phase}: each phase of ``windows`` ({phase: (first,
    last)}) once, at a distinct round drawn from [first, last) with
    ``seed``. A post_prefill crash fires only in a round that completes
    a prefill, so its window is the first rounds (a crash before it
    would shift the live rounds against the engine's)."""
    rng = np.random.RandomState(seed)
    out = {}
    for phase, (first, last) in windows.items():
        free = [r for r in range(first, last) if r not in out]
        out[int(free[rng.randint(len(free))])] = phase
    return out


def _report_tool(name, path, tag, say):
    """``python tools/<name>.py path`` from the checkout; its exit code
    (its first output line is printed)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(root, "tools", name + ".py"), path],
        capture_output=True, text=True, timeout=300, cwd=root)
    lines = (out.stdout.strip() or out.stderr.strip()).splitlines()
    say(f"{tag} {name} on {os.path.basename(path)}: exit {out.returncode}"
        f"; {lines[0] if lines else ''}")
    return out.returncode


def _spans(col, names, replay=False):
    """{name: (count, seconds)} of the collector's complete spans of
    ``names`` (replay-flagged ones only with ``replay``)."""
    out = {n: [0, 0.0] for n in names}
    for ev in col.events:
        if ev.get("ph") == "X" and ev["name"] in out and \
                bool((ev.get("args") or {}).get("replay")) == replay:
            out[ev["name"]][0] += 1
            out[ev["name"]][1] += ev["dur"]
    return {n: tuple(v) for n, v in out.items()}


def phase_observe(torch, device, cfg, tsm, prompts, serve, workdir, tag,
                  say):
    """Phase 20.1: phase 3's traffic with a TraceCollector, a
    HealthMonitor and a CostLedger attached: phase 3's streams and
    counts, the ledger held exactly to the engine's counters, the three
    artifacts read by the repo's report tools."""
    from paddle_tpu_torch.inference import (CostLedger, HealthMonitor,
                                            TraceCollector)
    col, mon, led = TraceCollector(), HealthMonitor(), CostLedger()
    r = phase_serve(torch, device, cfg, tsm, prompts, tag, say,
                    "observed serving (collector, monitor, ledger)",
                    cfg["num_blocks"], collector=col, monitor=mon,
                    ledger=led)
    eng = r["engine"].engine
    require(r["streams"] == serve["streams"],
            "observed serving left phase 3's streams")
    require(r["counts"] == serve["counts"], f"observed serving scheduled "
            f"{r['counts']}, phase 3 {serve['counts']}")
    st, t = eng.prefill_stats, led.totals
    served = sum(tn.stats.tokens_served for tn in eng.tenants.values())
    first = sum(len(p) for p in prompts)
    skipped = led.prefix_saved_tokens + led.replay_saved_tokens
    cons = led.conservation()
    say(f"{tag} observed ledger: rows {t.rows} (engine: {st.prefill_tokens}"
        f" prefill + {served} decode), replay waste {t.waste_rows['replay']}"
        f" rows (engine: {st.prefill_tokens} - {first} first-prefill rows,"
        f" {r['counts']['preemptions']} preemptions), skipped {skipped} "
        f"(engine {eng.prefix_stats.tokens_skipped}); goodput fraction "
        f"{led.goodput_fraction()}, FLOPs {t.flops}, pending "
        f"{led.pending_rows}, conservation {cons['ok']}")
    require(t.rows == st.prefill_tokens + served,
            "the ledger's rows differ from the engine's computed rows")
    require(skipped == eng.prefix_stats.tokens_skipped,
            "the ledger's skipped rows differ from the engine's")
    require(t.waste_rows["replay"] == st.prefill_tokens - first > 0,
            "the ledger's replay waste differs from the preemptions' "
            "recomputed rows")
    require(cons["ok"] and led.pending_rows == 0 and
            t.goodput_rows == first + served, "the ledger does not "
            "balance")
    steps = _spans(col, ("verify",))["verify"]
    spans = _spans(col, ("spec_round", "draft_roll", "verify",
                         "sample_verify", "prefill", "bookkeeping",
                         "model", "admission"))
    total = spans.pop("spec_round")[1]
    shares = {n: round(v[1] / total, 4) for n, v in spans.items()}
    summ = col.request_summary()["overall"]
    lat = {f"{m}_{q}": round(summ[m][q] * 1e3, 3)
           for m in ("ttft_s", "tpot_s") for q in ("p50", "p99")}
    alerts = [(a.step, a.kind) for a in mon.alerts]
    say(f"{tag} observed round phases (share of {steps[0]} rounds, "
        f"{total:.3f} s host clock; verify = the engine step, whose "
        f"prefill / bookkeeping / model / admission phases follow; model "
        f"= launch time, the device time lands at the first readback, "
        f"in sample_verify): {shares}")
    say(f"{tag} observed requests: {summ['requests']}, latency ms {lat}; "
        f"alerts {alerts}; health {mon.report().verdict}; "
        f"{len(prompts) * cfg['new_tokens'] / r['secs']:.2f} tokens/s "
        f"observed against phase 3's "
        f"{len(prompts) * cfg['new_tokens'] / serve['secs']:.2f} (printed "
        f"only)")
    require(summ["requests"] == len(prompts) and steps[0] == r["counts"][
        "rounds"], "the collector missed requests or steps")
    paths = {"trace_report": os.path.join(workdir, "serve.trace.json"),
             "cost_report": os.path.join(workdir, "cost.json"),
             "health_report": os.path.join(workdir, "health.json")}
    sizes = (col.save_chrome_trace(paths["trace_report"]),
             led.save(paths["cost_report"]),
             mon.save(paths["health_report"]))
    say(f"{tag} observed artifacts: trace {sizes[0]} B, cost {sizes[1]} "
        f"B, health {sizes[2]} B")
    for name, path in paths.items():
        require(_report_tool(name, path, tag, say) == 0,
                f"tools/{name}.py refused the port's artifact")
    del r
    gc.collect()


def _durable(torch, device, label, model, draft, k, prompts, n_new,
             engine_kw, crash_at, snapshot_every, workdir, tag, say,
             work=None):
    """Serve ``prompts`` through a RecoverableServer (fsync'd journal,
    files under ``workdir``) with ``CrashInjector(crash_at)``; after each
    EngineCrash recover from the files with a fresh collector, monitor
    and ledger (``work()``: the ledger's WorkModel) and audit. Returns
    the streams; fails unless every crash fired and every outcome was
    delivered exactly once."""
    from paddle_tpu_torch.inference import (CostLedger, CrashInjector,
                                            EngineCrash, HealthMonitor,
                                            RecoverableServer,
                                            SpeculativeEngine,
                                            TraceCollector, load_snapshot)

    def observers():
        return dict(collector=TraceCollector(), monitor=HealthMonitor(),
                    ledger=CostLedger(None if work is None else work()))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    jp = os.path.join(workdir, label + ".wal")
    sp = os.path.join(workdir, label + ".ckpt")
    inj = CrashInjector(crash_at=dict(crash_at))
    srv = RecoverableServer(
        SpeculativeEngine(model, draft, k=k, injector=inj, **engine_kw,
                          **observers()),
        journal_path=jp, snapshot_path=sp, snapshot_every=snapshot_every,
        sync=True)
    t0 = time.perf_counter()
    rids = [srv.submit(p) for p in prompts]
    done, delivered, rounds = {}, [], 0
    saves, loads, recovers, replays = [], [], [], []
    snap_bytes, rep_rounds, rep_tokens = [], 0, 0

    def harvest(s):
        for ev in s.engine.collector.events:
            if ev.get("ph") == "X" and ev["name"] == "snapshot" and \
                    not ev["args"].get("replay"):
                saves.append(ev["dur"])
                snap_bytes.append(ev["args"]["bytes"])

    while len(done) < len(rids):
        rounds += 1
        require(rounds < 100 * len(rids), f"{label}: did not converge")
        try:
            srv.step()
            delivered += srv.drain_outcomes()
            for r in rids:
                if r not in done and len(srv.generated(r)) >= n_new:
                    done[r] = srv.generated(r)[:n_new]
                    srv.release(r)
        except EngineCrash:
            harvest(srv)
            del srv
            gc.collect()
            sync()
            t1 = time.perf_counter()
            blob = load_snapshot(sp)
            loads.append(time.perf_counter() - t1)
            del blob
            t1 = time.perf_counter()
            srv = RecoverableServer.recover(
                model, draft, journal_path=jp, snapshot_path=sp,
                injector=inj, sync=True, **observers())
            sync()
            recovers.append(time.perf_counter() - t1)
            srv.check_invariants()
            replays.append(_spans(srv.engine.collector, ("verify",),
                                  replay=True)["verify"][1])
            rep_rounds += srv.replayed_rounds
            rep_tokens += srv.replayed_tokens
    delivered += srv.drain_outcomes()
    sync()
    secs = time.perf_counter() - t0
    harvest(srv)
    seq, jbytes = srv.journal.seq, os.path.getsize(jp)
    srv.check_invariants()
    led_ok = srv.engine.ledger.conservation()["ok"]
    srv.close()
    got = sorted(oc.rid for oc in delivered)
    ms = lambda v: round(1e3 * max(v), 1) if v else None  # noqa: E731
    say(f"{tag} durable {label}: {len(rids)} requests x {n_new} tokens in "
        f"{secs:.3f} s ({rounds} live rounds incl. crashed ones); "
        f"{inj.crashes} crashes at {sorted(crash_at.items())}, "
        f"{len(recovers)} recoveries; snapshots {len(saves)} (+ snapshot "
        f"0), file bytes max {max(snap_bytes) if snap_bytes else 0}, save "
        f"s mean {np.mean(saves) if saves else 0:.3f} (max ms "
        f"{ms(saves)}); load s {[round(v, 3) for v in loads]}, replay s "
        f"{[round(v, 3) for v in replays]}, whole recovery s "
        f"{[round(v, 3) for v in recovers]}; replayed {rep_rounds} rounds "
        f"/ {rep_tokens} tokens; journal {seq} records appended, "
        f"{jbytes} B on disk at the end (compacted at each snapshot)")
    require(inj.crashes == len(crash_at) == len(recovers),
            f"{label}: {inj.crashes} of {len(crash_at)} crashes fired")
    require(got == sorted(rids) and all(oc.status == "finished"
                                        for oc in delivered),
            f"{label}: outcomes not delivered exactly once ({got})")
    require(led_ok, f"{label}: the last incarnation's ledger does not "
            "balance")
    return [done[r] for r in rids]


def phase_durability(torch, device, cfg, tsm, tsm8, prompts, qprompts,
                     serve, qserve, spec_streams, toks, first_small, seed,
                     tag, say):
    """Phase 20: the passive observability run, then durable crash storms
    through RecoverableServer on the float engine, the quantized engine
    (int8 weights, int8 KV, prefix cache) and k=4 speculation with the
    6-layer draft; each ends with the uninterrupted run's streams."""
    from paddle_tpu_torch.inference import PagedKVCache, WorkModel
    base = dict(max_batch=cfg["max_batch"], block_size=cfg["block_size"],
                chunk_tokens=cfg["chunk_tokens"],
                prefill_token_budget=cfg["budget"])
    with tempfile.TemporaryDirectory() as workdir:
        phase_observe(torch, device, cfg, tsm, prompts, serve, workdir,
                      tag, say)
        # the rounds that complete a prefill: 1-3 (all three runs), then
        # 5-8 (float) and 4-11 (quantized) of phase 3's / phase 5's runs
        later = (4, 40)
        windows = dict(post_prefill=(2, 4), post_admission=later,
                       pre_journal=later, post_journal=later)
        crash_at = _crash_schedule(seed + 20, windows)
        got = _durable(torch, device, "float", tsm, None, 0, prompts,
                       cfg["new_tokens"],
                       dict(base, num_blocks=cfg["num_blocks"]), crash_at,
                       cfg["durable_every"], workdir, tag, say)
        require(got == serve["streams"], "the float crash storm left "
                "phase 3's streams")
        # the w8a16 path streams 1-byte weights: the ledger's work model
        # says so (WorkModel.for_model reads a float ffn1.weight)
        core = tsm8.core
        kvb = PagedKVCache.for_model(core, cfg["block_size"], 2, max_seqs=1,
                                     dtype="int8").kv_bytes_per_token()
        ffn = int(core.layers[0].ffn1.weight_int8.shape[1])

        def work():
            return WorkModel(core.num_layers, core.embed_dim, ffn,
                             kv_token_bytes=kvb, weight_itemsize=1)
        got = _durable(torch, device, "quantized", tsm8, None, 0, qprompts,
                       cfg["new_tokens"],
                       dict(base, num_blocks=cfg["q_num_blocks"],
                            kv_dtype="int8", prefix_cache=True),
                       _crash_schedule(seed + 21, windows),
                       cfg["durable_every"], workdir, tag, say, work=work)
        require(got == qserve["streams"], "the quantized crash storm left "
                "phase 5's streams")
        nd, n = cfg["draft_layers"], cfg["spec_requests"]
        got = _durable(torch, device, "speculative", tsm,
                       tsm.truncated_draft(nd), cfg["spec_k"], prompts[:n],
                       cfg["new_tokens"],
                       dict(base, num_blocks=cfg["num_blocks"]),
                       _crash_schedule(seed + 22, dict(
                           windows, mid_spec_round=later)),
                       cfg["durable_spec_every"], workdir, tag, say)
        require(got == spec_streams, "the speculative crash storm left "
                "phase 11's streams")
        require(not _upto(got, toks, first_small), "the speculative crash "
                "storm left phase 4's tokens before a near-tie")


# -- phase 21: the serving fleet -----------------------------------------
# one prefill-role and two decode-role workers, each its own process
FLEET_ROLES = {"p0": "prefill", "d0": "decode", "d1": "decode"}


def _fleet_spec(cfg, seed, device, root, name):
    """One worker's data-only spec: phase 3's widths, pool and budgets, a
    rolled readout (head_roll=1), seeds from ``seed``, the prefix cache,
    files under ``root``."""
    return dict(vocab=cfg["vocab"], d_model=cfg["d"], heads=cfg["heads"],
                ffn=cfg["ffn"], layers=cfg["layers"], model_seed=seed,
                embed_seed=seed + 1, head_roll=1, device=device.type, k=0,
                max_batch=cfg["max_batch"], block_size=cfg["block_size"],
                num_blocks=cfg["num_blocks"],
                max_blocks_per_seq=cfg["num_blocks"] - 1, prefix_cache=True,
                chunk_tokens=cfg["chunk_tokens"],
                prefill_token_budget=cfg["budget"],
                journal_path=os.path.join(root, f"{name}.wal"),
                snapshot_path=os.path.join(root, f"{name}.ckpt"))


class _Metered:
    """A worker handle that forwards every op and, for the migration ops,
    adds their wall seconds and the slices and page bytes exported."""

    def __init__(self, handle):
        self.handle, self.name, self.role = handle, handle.name, handle.role
        self.slices, self.bytes = 0, 0
        self.secs = {"export_slices": 0.0, "import_slices": 0.0}

    def request(self, op, payload=None, timeout=None):
        t0 = time.perf_counter()
        out = self.handle.request(op, payload, timeout)
        if op in self.secs:
            self.secs[op] += time.perf_counter() - t0
        if op == "export_slices":
            for slc in out["slices"].values():
                if slc is not None:
                    self.slices += 1
                    self.bytes += sum(slc[k].nbytes for k in (
                        "payload", "scale_payload") if k in slc)
        return out

    def kill(self):
        self.handle.kill()

    def close(self):
        self.handle.close()

    def net_stats(self):
        return self.handle.net_stats()


def _gpu_memory_used():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "not measured"


def _first_near_ties(torch, device, cfg, tsm, prompts, streams):
    """(first near-tie step of each greedy stream, the gap bound): phase
    4's rule, every stream teacher-forced through one paged engine."""
    h, _ = teacher_force(torch, device, cfg, tsm.core, tsm, prompts,
                         streams)
    lg = tsm.logits(h)
    top2 = lg.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    tol = TOL_REL * float(lg.abs().max())
    return [int(np.flatnonzero(g < tol)[0]) if (g < tol).any()
            else cfg["new_tokens"] for g in gap], tol


def _fleet_drive(router, n, max_ticks, sup=None, each_tick=None):
    """Router ticks (each followed by a supervisor pass and
    ``each_tick()``) until ``n`` outcomes are drained; returns them."""
    ocs = []
    for _ in range(max_ticks):
        if len(ocs) >= n:
            break
        router.step()
        if sup is not None:
            sup.tick()
        ocs += router.drain_outcomes()
        if each_tick is not None:
            each_tick()
    require(len(ocs) >= n, f"the fleet delivered {len(ocs)} of {n} "
            f"outcomes in {max_ticks} ticks")
    return ocs


def _fleet_verdict(label, router, rids, ocs, ref, first):
    """Every outcome once and FINISHED, every live worker's deep audit
    ok, every stream the single engine's up to its first near-tie;
    returns how many streams equal it over all their tokens."""
    got = [router.generated(x) for x in rids]
    require(sorted(o.rid for o in ocs) == sorted(rids) and
            all(o.status == "finished" for o in ocs) and
            router.stats.delivered == len(rids),
            f"{label}: outcomes not delivered exactly once "
            f"({sorted(o.rid for o in ocs)})")
    for ws in router._live():
        require(router._op(ws, "audit")["ok"],
                f"{label}: worker {ws.name}'s audit failed")
    bad = _upto(got, ref, first)
    require(not bad, f"{label}: streams {bad} left the single engine's "
            "before their first near-tie")
    return sum(g == t for g, t in zip(got, ref))


def phase_fleet(torch, device, cfg, prompts, seed, tag, say):
    """Phase 21: the serving fleet at full width. One spec (phase 3's
    model widths, pool and budgets; float32; seeds from ``seed``) serves
    phase 3's 12 prompts: an in-process single engine (the baseline),
    then three socket workers (one prefill-role, two decode-role; each a
    spawned process with its own CUDA context) behind a prefix-aware
    Router that migrates every finished prefill as a page slice; a
    second such fleet under a FleetSupervisor through a seeded router
    kill and a real SIGKILL, each corpse respawned from its files; and a
    third through a seeded network storm over the resilient sockets. The
    three fleets' nine workers are spawned together (their start-ups
    overlap). Every leg ends with the baseline's streams, each outcome
    delivered once and every worker's audit ok."""
    from paddle_tpu_torch.inference import (FleetSupervisor,
                                            NetworkFaultInjector, Router,
                                            RouterFaultInjector,
                                            SocketWorker,
                                            build_server_from_spec,
                                            read_journal,
                                            token_chain_hashes)
    n_new, bs = cfg["new_tokens"], cfg["block_size"]
    n_tok = len(prompts) * n_new
    ticks = 50 * len(prompts)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()      # the card's memory for the workers
    handles, routers = [], []         # every worker process started here
    with tempfile.TemporaryDirectory() as root:
        def spec(leg, name):
            os.makedirs(os.path.join(root, leg), exist_ok=True)
            return _fleet_spec(cfg, seed, device, os.path.join(root, leg),
                               name)

        try:
            # the three legs' workers, spawned together first: their
            # start-ups (interpreter, torch, CUDA context, model, server)
            # overlap each other and the baseline below; each is ready once
            # its handshake is answered. A SocketWorker's constructor
            # waits for its child to connect back, which the child does
            # once it has imported torch, so the nine are made on nine
            # threads (one after another the imports would not overlap)
            net = NetworkFaultInjector.storm(seed + 40, list(FLEET_ROLES))
            legs = (("disagg", {}), ("storm", {}),
                    ("net", {"net_injector": net}))
            t_spawn = time.perf_counter()
            with ThreadPoolExecutor(len(legs) * len(FLEET_ROLES)) as ex:
                futs = {(leg, n): ex.submit(
                    SocketWorker, spec(leg, n), name=n, role=role,
                    timeout=600.0, wait_ready=False, **kw)
                    for leg, kw in legs for n, role in FLEET_ROLES.items()}
            errs = [f.exception() for f in futs.values()]
            handles.extend(f.result() for f, e in zip(futs.values(), errs)
                           if e is None)
            require(not any(errs), f"a worker did not start: {errs}")
            fleets = {leg: [futs[leg, n].result() for n in FLEET_ROLES]
                      for leg, _ in legs}

            # 1. the baseline: one uninterrupted server built from the spec
            t0 = time.perf_counter()
            srv = build_server_from_spec(spec("solo", "solo"))
            sync()
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rids = [srv.submit(p) for p in prompts]
            done, rounds = {}, 0
            while len(done) < len(rids):
                rounds += 1
                require(rounds < ticks, "the baseline did not converge")
                srv.step()
                for x in rids:
                    if x not in done and len(srv.generated(x)) >= n_new:
                        done[x] = srv.generated(x)[:n_new]
                        srv.release(x)
            sync()
            base_s = time.perf_counter() - t0
            ref = [done[x] for x in rids]
            model = srv.engine.target
            srv.close()
            del srv
            gc.collect()
            first, tol = _first_near_ties(torch, device, cfg, model, prompts,
                                          ref)
            say(f"{tag} fleet baseline: one in-process server from the spec "
                f"(model built in {build_s:.2f} s), {len(prompts)} requests x "
                f"{n_new} tokens in {base_s:.3f} s = {n_tok / base_s:.2f} "
                f"tokens/s, {rounds} rounds; first near-tie steps {first} "
                f"(top-two gap < {tol:.3e})")

            def hash_fn(toks):
                return token_chain_hashes(model, toks, bs)

            ready = []
            for ws in fleets.values():
                for w in ws:
                    w.request("ping")
                    ready.append(round(time.perf_counter() - t_spawn, 2))
            say(f"{tag} fleet: 9 socket workers (3 fleets of p0 prefill, "
                f"d0 and d1 decode) spawned together before the baseline, "
                f"ready at {ready} s after the first spawn")

            # 2. the disaggregated fleet: every prefill migrates
            meters = [_Metered(w) for w in fleets["disagg"]]
            r = Router(meters, hash_fn=hash_fn, migrate=True,
                       journal_path=os.path.join(root, "disagg", "r.wal"))
            routers.append(r)
            t0 = time.perf_counter()
            rids = [r.submit(p, max_new_tokens=n_new) for p in prompts]
            placed = {x for x in rids if r._reqs[x].worker == "p0"}

            def watch():
                placed.update(x for x in rids if r._reqs[x].worker == "p0")
            ocs = _fleet_drive(r, len(rids), ticks, each_tick=watch)
            secs = time.perf_counter() - t0
            used = _gpu_memory_used()
            exact = _fleet_verdict("disaggregated fleet", r, rids, ocs, ref,
                                   first)
            st = r.stats
            require(st.worker_deaths == st.worker_timeouts == 0,
                    f"a worker died or hung with no fault scheduled: "
                    f"{st.as_dict()}")
            require(st.migrations == len(placed) >= 1,
                    f"{st.migrations} migrations for {len(placed)} "
                    "requests placed on the prefill worker")
            ship = {op: round(sum(m.secs[op] for m in meters), 3)
                    for op in meters[0].secs}
            say(f"{tag} fleet disaggregated: {len(rids)} requests x "
                f"{n_new} tokens in {secs:.3f} s = {n_tok / secs:.2f} "
                f"tokens/s (baseline {n_tok / base_s:.2f}; printed only), "
                f"{r.tick} ticks; {len(placed)} placed on p0, "
                f"{st.migrations} migrations, {st.export_batches} export "
                f"batches, {sum(m.slices for m in meters)} slices / "
                f"{sum(m.bytes for m in meters)} B of pages exported, "
                f"{st.migrated_blocks} blocks imported, seconds in the ops "
                f"{ship}; streams equal to the baseline's over all tokens "
                f"{exact} of {len(rids)}; card memory used {used} (the 9 "
                f"workers and this process)")
            r.close()

            # 3. a seeded router kill and a real SIGKILL, respawned from
            # the workers' files
            specs = {n: spec("storm", n) for n in FLEET_ROLES}
            inj = RouterFaultInjector.kill_storm(
                seed + 30, cfg["fleet_kill_window"][1], list(FLEET_ROLES),
                kills=1, first_tick=cfg["fleet_kill_window"][0])
            (kill_tick, sched), = inj.kill_at.items()
            (kill_worker, _), = sched.items()
            victim = "d1" if kill_worker != "d1" else "d0"
            wal = os.path.join(root, "storm", "r.wal")
            r = Router(fleets["storm"], hash_fn=hash_fn, injector=inj,
                       migrate=True, journal_path=wal, backoff_ticks=1)
            routers.append(r)
            sup = FleetSupervisor(r, specs, transport="socket",
                                  socket_timeout=600.0)
            rids = [r.submit(p, max_new_tokens=n_new) for p in prompts]
            killed, spawned, respawn_s = [], {}, []

            def storm():
                now = time.perf_counter()
                if not killed and r.tick >= kill_tick + 2 and any(
                        q.worker == victim and q.generated and not q.terminal
                        for q in r._reqs.values()):
                    r._workers[victim].handle.kill()     # SIGKILL
                    killed.append(r.tick)
                for name, w in r._workers.items():
                    if w.respawned and name not in spawned:
                        spawned[name] = now
                    elif name in spawned and not w.respawned and \
                            w.status == "up":
                        respawn_s.append(round(now - spawned.pop(name), 2))
            t0 = time.perf_counter()
            ocs = _fleet_drive(r, len(rids), ticks, sup, storm)
            for _ in range(ticks):
                if all(w.status == "up" for w in r._workers.values()):
                    break
                r.step()
                sup.tick()
                storm()
            secs = time.perf_counter() - t0
            exact = _fleet_verdict("SIGKILL storm", r, rids, ocs, ref,
                                   first)
            st = r.stats
            events = [(p["worker"], p["event"])
                      for _, k, p in read_journal(wal) if k == "respawn"]
            pairs = all(events[i:i + 2] == [(w, "spawn"), (w, "rejoin")]
                        for i, (w, _) in enumerate(events) if i % 2 == 0)
            live = sup.registry.as_dict()
            require(inj.killed == 1 and len(killed) == 1,
                    f"the storm's kill fired {inj.killed} time(s), the "
                    f"SIGKILL {len(killed)}")
            require(st.worker_deaths == 2 and sup.failed_respawns == 0 and
                    st.respawns == sup.respawns_total == 2 ==
                    live["fleet.respawns"] == len(respawn_s),
                    f"deaths {st.worker_deaths}, respawns {st.respawns} / "
                    f"{sup.respawns_total} / {live['fleet.respawns']}, "
                    f"rejoins seen {len(respawn_s)}; {sup.last_error}")
            require(live["fleet.workers_live"] == 3 and
                    all(w.status == "up" for w in r._workers.values()),
                    "the fleet is not back at 3 of 3 live workers")
            require(pairs and len(events) == 2 * st.respawns,
                    f"the router journal's respawn lane is {events}")
            say(f"{tag} fleet SIGKILL storm: router kill of {kill_worker} "
                f"at tick {kill_tick}, SIGKILL of {victim} at tick "
                f"{killed[0]}; {st.worker_deaths} deaths, "
                f"{st.resubmissions} resubmissions, {st.migrations} "
                f"migrations, {st.respawns} respawns from files (spawn to "
                f"rejoin {respawn_s} s), journal lane {events}; back at 3 "
                f"of 3 live after {r.tick} ticks, {secs:.3f} s; streams "
                f"equal to the baseline's over all tokens {exact} of "
                f"{len(rids)}")
            r.close()

            # 4. a seeded network storm over the resilient sockets
            specs = {n: spec("net", n) for n in FLEET_ROLES}
            r = Router(fleets["net"], hash_fn=hash_fn, migrate=True,
                       journal_path=os.path.join(root, "net", "r.wal"),
                       call_timeout=cfg["fleet_call_timeout"])
            routers.append(r)
            sup = FleetSupervisor(r, specs, transport="socket",
                                  socket_timeout=600.0)
            t0 = time.perf_counter()
            rids = [r.submit(p, max_new_tokens=n_new) for p in prompts]
            ocs = _fleet_drive(r, len(rids), ticks, sup)
            secs = time.perf_counter() - t0
            exact = _fleet_verdict("network storm", r, rids, ocs, ref,
                                   first)
            st = r.stats
            counters = {k: v for k, v in sup.registry.as_dict().items()
                        if k.startswith("net.")}
            require(net.pending == 0, f"{net.pending} network faults "
                    "never fired")
            require(st.respawns == sup.respawns_total == st.worker_deaths
                    == st.worker_timeouts == 0,
                    f"the network storm cost deaths, timeouts or "
                    f"respawns: {st.as_dict()}")
            require(st.net_reconnects >= 1, "no reconnect observed")
            say(f"{tag} fleet network storm: faults fired {net.fired}; "
                f"{st.net_reconnects} reconnects seen by the router, "
                f"{st.degraded_transitions} degraded transitions, 0 "
                f"respawns; net counters {counters}; {st.migrations} "
                f"migrations; {secs:.3f} s (op timeout "
                f"{cfg['fleet_call_timeout']} s); streams equal to the "
                f"baseline's over all tokens {exact} of {len(rids)}")
            r.close()
        finally:
            # every process this phase started, respawned ones included
            for h in handles + [ws.handle for rt in routers
                                for ws in rt._workers.values()]:
                getattr(h, "handle", h).kill()


# -- phase 22: head-sharded serving ---------------------------------------
def _pool_bytes(cfg, kv):
    """Bytes of phase 3's pool (num_blocks pages of every layer) at mp 1:
    the payload, plus one float32 scale per (K|V, head, position) of an
    int8 pool."""
    per_pos = cfg["d"] * (1 if kv == "int8" else 4) + \
        (4 * cfg["heads"] if kv == "int8" else 0)
    return (cfg["layers"] * cfg["num_blocks"] * 2 * cfg["block_size"] *
            per_pos)


def phase_sharded(torch, device, cfg, tsm, prompts, serve, toks, pH, tag,
                  say):
    """Phase 22: phase 3's traffic through ``tsm.shard(mp)``, mp 2 and 4,
    as logical shards on the one card (qkv "weights": per-shard column
    slices), over phase 3's float pool and over an int8 pool (its mp=1
    reference: the same float weights over int8 pages). Streams equal the
    mp=1 run's, one all-reduce per layer per model call, ragged launches
    layers x mp per call, per-device pool bytes the total over mp, the
    scheduling counts mp=1's; an mp=2 snapshot restores at mp=1 and an
    mp=1 snapshot at mp=2, an mp=2 slice imports into an mp=1 pool, each
    continuing phase 3's streams; "activations" hidden states bitwise
    phase 4's teacher-forced mp=1 rows ("weights": within TOL_REL).
    tokens/s at mp 1, 2 and 4 are printed only."""
    from paddle_tpu_torch.inference import SpeculativeEngine
    L, n_new, nb = cfg["layers"], cfg["new_tokens"], cfg["num_blocks"]
    ref = serve["streams"]

    def engine(model, **kw):
        kw = dict(dict(max_batch=cfg["max_batch"],
                       block_size=cfg["block_size"], num_blocks=nb,
                       chunk_tokens=cfg["chunk_tokens"],
                       prefill_token_budget=cfg["budget"]), **kw)
        return SpeculativeEngine(model, None, k=0, **kw)

    t0 = time.perf_counter()
    q1 = phase_serve(torch, device, cfg, tsm, prompts, tag, say,
                     "sharded: the int8-pool reference (mp=1, float "
                     "weights)", nb, kv_dtype="int8")
    del q1["engine"]
    base = {"float32": serve, "int8": q1}
    tps = {}
    for kv in ("float32", "int8"):
        tps[(kv, 1)] = len(prompts) * n_new / base[kv]["secs"]
        for mp in (2, 4):
            t = tsm.shard(mp)
            r = phase_serve(torch, device, cfg, t, prompts, tag, say,
                            f"sharded serving mp={mp} ({kv} pool, qkv "
                            f"{t.core.qkv_shard}, logical shards)", nb,
                            kv_dtype=kv)
            eng = r["engine"].engine
            calls = len(r["rows"])
            tps[(kv, mp)] = len(prompts) * n_new / r["secs"]
            want = _pool_bytes(cfg, kv)
            reg = eng.registry.as_dict()["sharded.allreduce_count"]
            same = sum(a == b for a, b in zip(r["streams"],
                                              base[kv]["streams"]))
            say(f"{tag} sharded mp={mp} {kv}: allreduce_count "
                f"{t.core.allreduce_count} (= {L} x {calls} model calls; "
                f"registry {reg}); pool bytes per device "
                f"{eng.cache.pool_bytes()} of {eng.cache.pool_bytes_total()}"
                f" total (mp=1 pool {want}); streams equal to mp=1's "
                f"{same} of {len(prompts)}; counts {r['counts']}")
            require(r["streams"] == base[kv]["streams"],
                    f"mp={mp} {kv} streams differ from mp=1's")
            require(r["counts"] == base[kv]["counts"],
                    f"mp={mp} {kv} scheduled {r['counts']}, mp=1 "
                    f"{base[kv]['counts']}")
            require(t.core.allreduce_count == L * calls == reg,
                    f"allreduce_count {t.core.allreduce_count} != "
                    f"{L} x {calls}")
            require(eng.cache.pool_bytes() * mp ==
                    eng.cache.pool_bytes_total() == want,
                    "per-device pool bytes != total / mp")
            del r, eng, t
            gc.collect()
    say(f"{tag} sharded tokens/s (printed only; logical shards on one "
        f"card): " + ", ".join(f"{kv} mp={mp} {v:.2f}"
                               for (kv, mp), v in tps.items()))

    # snapshots across widths, cut a third of the way through phase 3's
    # rounds
    cut = serve["counts"]["rounds"] // 3
    for src_mp, dst_mp in ((2, 1), (1, 2)):
        eng = engine(tsm.shard(src_mp) if src_mp > 1 else tsm)
        rids = [eng.submit(p) for p in prompts]
        done = {}
        _drive(eng, rids, n_new, done, stop=_after(cut))
        require(len(done) < len(rids), "every request finished before "
                "the snapshot")
        snap, n_done = eng.snapshot(), len(done)
        del eng
        gc.collect()
        eng = SpeculativeEngine.restore(
            tsm.shard(dst_mp) if dst_mp > 1 else tsm, None, snap)
        require(eng.engine.cache.mp == dst_mp and
                snap["engine"]["cache"]["geometry"]["mp"] == src_mp,
                "restore did not rebuild at the target width")
        _drive(eng, rids, n_new, done)
        got = [done[r] for r in rids]
        say(f"{tag} sharded snapshot mp={src_mp} -> mp={dst_mp} at round "
            f"{cut}: {len(snap['engine']['cache']['blocks'])} pages, "
            f"{n_done} requests done at the cut; streams "
            f"equal to phase 3's {sum(a == b for a, b in zip(got, ref))} "
            f"of {len(ref)}")
        require(got == ref, f"the mp={src_mp} snapshot restored at "
                f"mp={dst_mp} left phase 3's streams")
        del eng, snap
        gc.collect()

    # an mp=2 slice into an mp=1 pool
    src = engine(tsm.shard(2))
    rid = src.submit(prompts[0])
    _drive(src, [rid], n_new, {},
           stop=lambda e: len(e.generated(rid)) >= n_new // 4)
    head = src.generated(rid)
    slc = src.export_slice(rid)
    dst = engine(tsm, prefix_cache=True)
    got = dst.import_slice(slc)
    rid2 = dst.submit(src.tokens(rid), resume=True)
    tail = {}
    _drive(dst, [rid2], n_new - len(head), tail)
    stream = head + tail[rid2]
    dst.check_invariants()
    hits = dst.engine.prefix_stats.hit_blocks
    say(f"{tag} sharded slice mp=2 -> mp=1: {len(slc['hashes'])} pages "
        f"({slc['payload'].shape[3]} heads, canonical), {got} imported, "
        f"{hits} adopted; stream equal to phase 3's "
        f"{sum(x == y for x, y in zip(stream, ref[0]))} of {n_new}")
    require(got == len(slc["hashes"]) == hits > 0 and stream == ref[0],
            "the mp=2 slice did not continue phase 3's stream at mp=1")
    del src, dst, slc

    # hidden states: phase 4's teacher-forced paged run (mp=1) again
    for mode in ("activations", "weights"):
        core = tsm.shard(2, qkv_shard=mode).core
        h, eng = teacher_force(torch, device, cfg, core, tsm, prompts[:4],
                               toks)
        del eng
        err = float((h - pH).abs().max())
        bitwise = bool(torch.equal(h, pH))
        say(f"{tag} sharded hidden states mp=2 qkv {mode} vs mp=1 (4 "
            f"prompts teacher-forced, {n_new} steps, "
            f"{core.allreduce_count} all-reduces): bitwise equal "
            f"{bitwise}, max_abs_diff {err:.3e} (max|h| "
            f"{float(pH.abs().max()):.3e})")
        if mode == "activations":
            require(bitwise, "activations-mode hidden states are not "
                    "bitwise mp=1's")
        else:
            require(err <= TOL_REL * float(pH.abs().max()),
                    "weights-mode hidden states beyond TOL_REL")
    say(f"{tag} phase 22 (sharded serving): "
        f"{time.perf_counter() - t0:.1f} s")


def phase_profile(torch, device, cfg, tsm, tsm_moe, tag, say):
    """Where a model call spends its time: one forward of max_batch rows
    (decode-sized) and one of budget + max_batch rows (mixed-sized, the
    MoE call's gmm at phase 8's mixed shapes), causal, no cache, through
    the dense and the MoE core: host wall per call against the device
    time torch.profiler sums over its kernels, and the costliest
    kernels."""
    iters = cfg["timing_iters"]
    for size, B in (("decode-sized", cfg["max_batch"]),
                    ("mixed-sized", cfg["budget"] + cfg["max_batch"])):
        x = torch.randn((1, B, cfg["d"]), generator=torch.Generator(
            ).manual_seed(9)).to(device)
        causal = torch.full((B, B), -1e30, device=device).triu(1)
        for label, core in (("dense", tsm.core), ("MoE", tsm_moe.core)):
            with torch.no_grad():
                fn = lambda: core(x, attn_mask=causal)  # noqa: E731
                for _ in range(3):
                    fn()
                if device.type != "cuda":
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / iters
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
            ev = [(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)), e.count,
                   e.key) for e in prof.key_averages()]
            ev = [e for e in ev if e[0] > 0]
            dev = sum(e[0] for e in ev) / 1e3
            top = sorted(ev, reverse=True)[:5]
            say(f"{tag} profile, {label} {size} call ({B} rows, "
                f"{cfg['layers']} layers): host wall {wall:.3f} ms per "
                f"call, device busy {dev:.3f} ms ({100 * dev / wall:.1f}%), "
                f"{sum(e[1] for e in ev)} kernel launches; costliest: "
                + "; ".join(f"{k[:48]} x{c} {t / 1e3:.3f} ms"
                            for t, c, k in top))
        del x, causal


# -- the training slice (phases 12-14) ---------------------------------
def _train_cfg(cfg):
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig(
        vocab_size=cfg["train_vocab"], hidden_size=cfg["train_hidden"],
        intermediate_size=cfg["train_ffn"],
        num_hidden_layers=cfg["train_layers"],
        num_attention_heads=cfg["train_heads"],
        num_key_value_heads=cfg["train_kv_heads"],
        max_position_embeddings=cfg["train_seq"])


def _leaf_shapes(cfg):
    """The trainer's 12 parameter shapes (blocks stacked [1, L, ...])."""
    H, F_, V = cfg["train_hidden"], cfg["train_ffn"], cfg["train_vocab"]
    KV = cfg["train_kv_heads"] * (H // cfg["train_heads"])
    lead = (1, cfg["train_layers"])
    return [(V, H), (H,), (H, V)] + [lead + s for s in (
        (H, H), (H, KV), (H, KV), (H, H), (H, F_), (H, F_), (F_, H), (H,),
        (H,))]


def _rel_err(got, ref):
    """max |got - ref| / max |ref| over float32 copies."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def phase_train_kernels(torch, device, cfg, tag, say):
    """Phase 12: the training slice's kernels against their plain versions
    at the shapes the trainer gives them, then timed beside their bound,
    the plain version and one PyTorch call. Returns {name: row}."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper import fused_adamw as fw
    from paddle_tpu_torch.ops.hopper import fused_norm as fn
    F = torch.nn.functional
    iters = cfg["train_timing_iters"]
    B, T, nh = cfg["train_batch"], cfg["train_seq"], cfg["train_heads"]
    H = cfg["train_hidden"]
    hd = H // nh
    bf16 = torch.bfloat16
    rows = {}
    scale = 1.0 / np.sqrt(hd)

    # -- flash attention: small cases in both types, then the slice ----
    small = {
        # name: (B, t_q, t_k, H, D, causal, rate)
        "fp32 causal tail": (2, 200, 200, 4, 128, True, 0.0),
        "fp32 cross-length": (2, 64, 320, 2, 64, True, 0.0),
        "fp32 non-causal tail": (1, 130, 77, 3, 64, False, 0.0),
        "fp32 dropout": (2, 192, 192, 2, 128, True, 0.1),
        "bf16 dropout cross-length": (1, 96, 256, 4, 128, True, 0.1),
        # the float32 cases' bf16 twins: the wgmma kernels' tails,
        # bottom-right offset, sub-box key tail and dropout
        "bf16 causal tail": (2, 200, 200, 4, 128, True, 0.0),
        "bf16 cross-length": (2, 64, 320, 2, 64, True, 0.0),
        "bf16 non-causal tail": (1, 130, 77, 3, 64, False, 0.0),
        "bf16 dropout": (2, 192, 192, 2, 128, True, 0.1),
    }
    for name, (b, tq, tk, h, d, causal, rate) in small.items():
        dt = bf16 if name.startswith("bf16") else torch.float32
        gen = torch.Generator().manual_seed(tq * tk + d)
        q, do = (torch.randn((b, tq, h, d), generator=gen).to(device, dt)
                 for _ in range(2))
        k, v = (torch.randn((b, tk, h, d), generator=gen).to(device, dt)
                for _ in range(2))
        errs = _flash_check(torch, fa, q, k, v, do, causal, 1 / np.sqrt(d),
                            rate, 1234)
        if dt == torch.float32:
            err = max(e[0] for e in errs)
            require(err <= TOL_KERNEL, f"flash {name}: {err}")
        else:
            err = max(e[1] for e in errs)
            require(err <= TOL_BF16_ROW,
                    f"flash {name}: {err} x a row's max|ref|")
        say(f"{tag} flash attention {name} [{b}, {tq}/{tk}, {h}, {d}] vs "
            f"plain: out, dq, dk, dv max_abs_err "
            f"{', '.join(f'{e[0]:.2e}' for e in errs)} (per row, rel. to "
            f"the row's max|ref|: {', '.join(f'{e[1]:.2e}' for e in errs)})")

    # the slice's shape: bf16 causal [B, T, nh, hd]; the plain backward
    # holds [BH, T, T] float32 matrices, so it runs (and is checked) two
    # batch rows at a time
    gen = torch.Generator(device=device).manual_seed(21)
    q, k, v, do = (torch.randn((B, T, nh, hd), generator=gen, device=device,
                               dtype=bf16) for _ in range(4))
    o, lse = fa._fwd_blhd(q, k, v, True, scale, 0.0, None)
    dq, dk, dv = fa._bwd_blhd(q, k, v, o, lse, do, True, scale, 0.0, None)
    # each gradient is written once, with no float atomics: the same bits
    # run to run
    again = fa._bwd_blhd(q, k, v, o, lse, do, True, scale, 0.0, None)
    same = all(bool(torch.equal(x, y)) for x, y in zip((dq, dk, dv), again))
    del again
    say(f"{tag} flash attention backward at the slice's shape, run to run: "
        f"dq, dk, dv bitwise {'equal' if same else 'DIFFERENT'}")
    require(same, "flash backward is not bitwise repeatable")
    pb = min(B, cfg["train_plain_batch"])
    f_abs = f_row = lse_abs = b_abs = b_row = 0.0
    for b0 in range(0, B, pb):
        sl = slice(b0, b0 + pb)
        qs, ks, vs = (fa._to_bhtd(t[sl]) for t in (q, k, v))
        ro, rl = fa.flash_fwd_reference(qs, ks, vs, True, scale)
        e_abs, e_row = _row_err(fa._to_bhtd(o[sl]), ro)
        f_abs, f_row = max(f_abs, e_abs), max(f_row, e_row)
        lse_abs = max(lse_abs, float(
            (lse.view(B, nh, T)[sl].reshape(-1, T) - rl).abs().max()))
        rg = fa.flash_bwd_reference(qs, ks, vs, ro, rl, fa._to_bhtd(do[sl]),
                                    True, scale)
        for g, r in zip((dq, dk, dv), rg):
            e_abs, e_row = _row_err(fa._to_bhtd(g[sl]), r)
            b_abs, b_row = max(b_abs, e_abs), max(b_row, e_row)
        del qs, ks, vs, ro, rl, rg
    say(f"{tag} flash attention bf16 causal [{B}, {T}, {nh}, {hd}] vs plain "
        f"(two rows at a time): forward out {f_abs:.3e} max_abs_err, "
        f"{f_row:.3e} x its row's max|ref|, lse {lse_abs:.3e} (tol "
        f"{TOL_KERNEL}); backward dq, dk, dv {b_abs:.3e} max_abs_err, "
        f"{b_row:.3e} x its row's max|ref| (tol {TOL_BF16_ROW} per row)")
    require(f_row <= TOL_BF16_ROW and b_row <= TOL_BF16_ROW
            and lse_abs <= TOL_KERNEL,
            "flash attention disagrees at the slice's shape")
    pairs = B * T * (T + 1) // 2 * nh          # causal (row, col) pairs
    io = B * T * nh * hd * 2                   # one bf16 [B, T, nh, hd]
    ms_f = _event_ms(torch, lambda: fa._fwd_blhd(q, k, v, True, scale,
                                                 0.0, None), device, iters)
    ms_b = _event_ms(torch, lambda: fa._bwd_blhd(
        q, k, v, o, lse, do, True, scale, 0.0, None), device, iters)
    # the kernels at the plain version's batch too, like for like
    q2, k2, v2, do2 = (t[:pb] for t in (q, k, v, do))
    o2, lse2 = fa._fwd_blhd(q2, k2, v2, True, scale, 0.0, None)
    ms_f2 = _event_ms(torch, lambda: fa._fwd_blhd(q2, k2, v2, True, scale,
                                                  0.0, None), device, iters)
    ms_b2 = _event_ms(torch, lambda: fa._bwd_blhd(
        q2, k2, v2, o2, lse2, do2, True, scale, 0.0, None), device, iters)
    del q2, k2, v2, do2, o2, lse2
    qp, kp, vp, dop = (fa._to_bhtd(t[:pb]) for t in (q, k, v, do))
    op, lp = fa.flash_fwd_reference(qp, kp, vp, True, scale)
    pl_f = _event_ms(torch, lambda: fa.flash_fwd_reference(
        qp, kp, vp, True, scale), device, max(1, iters // 2))
    pl_b = _event_ms(torch, lambda: fa.flash_bwd_reference(
        qp, kp, vp, op, lp, dop, True, scale), device, max(1, iters // 2))
    del qp, kp, vp, dop, op, lp
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    lib_f = _event_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), device, iters)
    out_l = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    lib_b = _event_ms(torch, lambda: torch.autograd.grad(
        out_l, (qt, kt, vt), dot, retain_graph=True), device, iters)
    del out_l, qt, kt, vt, dot
    # forward: QK^T and PV over the causal pairs; q, k, v read, out and
    # lse written. backward, the least work: 5 products of the causal
    # half (QK^T again, dP = dO V^T, dV, dQ, dK) — JAX's split design
    # does 7; q, k, v, o, dO and lse read, dq, dk, dv written
    bf_ms, bf_by = _bound(4 * io + B * nh * T * 4, 4 * hd * pairs,
                          BF16_FLOP_S)
    bb_ms, bb_by = _bound(8 * io + B * nh * T * 4, 10 * hd * pairs,
                          BF16_FLOP_S)
    say(f"{tag} flash attention forward, CUDA events per call: kernel "
        f"{ms_f:.4f} ms (batch {pb}: {ms_f2:.4f}), plain {pl_f:.4f} ms "
        f"(batch {pb}), sdpa(is_causal) {lib_f:.4f} ms, bound "
        f"{bf_ms:.4f} ms ({bf_by}, bf16 tensor-core peak)")
    say(f"{tag} flash attention backward, CUDA events per call: kernel "
        f"{ms_b:.4f} ms (batch {pb}: {ms_b2:.4f}), plain {pl_b:.4f} ms "
        f"(batch {pb}), sdpa backward {lib_b:.4f} ms, bound {bb_ms:.4f} ms "
        f"({bb_by}: 5 products; JAX's split design does 7, "
        f"{bb_ms * 7 / 5:.4f} ms)")
    say(f"{tag} flash attention achieved: forward "
        f"{4 * hd * pairs / ms_f / 1e9:.1f} TFLOP/s; backward "
        f"{10 * hd * pairs / ms_b / 1e9:.1f} TFLOP/s over the 5 products, "
        f"{14 * hd * pairs / ms_b / 1e9:.1f} over the 7 the split design "
        f"runs (bf16 peak {BF16_FLOP_S / 1e12:.0f})")
    if device.type == "cuda":
        # the backward's three kernels apart (profiler device time)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fa._fwd_blhd(q, k, v, True, scale, 0.0, None)
                fa._bwd_blhd(q, k, v, o, lse, do, True, scale, 0.0, None)
            torch.cuda.synchronize()
        split = []
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            for key in ("flash_fwd_wgmma", "flash_delta_kernel",
                        "flash_dq_wgmma", "flash_dkv_wgmma"):
                if key in e.key and us > 0:
                    split.append(f"{key} {us / 1e3 / e.count:.4f} ms "
                                 f"(x{e.count})")
        say(f"{tag} flash attention kernels, profiler device time per "
            f"launch: {', '.join(sorted(split))}")
        from paddle_tpu_torch.ops.hopper import _build
        report = _ptxas_report(_build.build_all()["flash_attention"].ptxas,
                               "_wgmma")
        for name, (regs, st, ld) in sorted(report.items()):
            say(f"{tag} ptxas {name}: {regs} registers at entry (setmaxnreg "
                f"gives the consumers more), spill stores {st} B, spill "
                f"loads {ld} B")
        require(len(report) == 12 and not any(
            st or ld for _, st, ld in report.values()),
            f"the wgmma flash kernels spill or are missing: {report}")
        # the redesigned serving kernels: the 3xTF32 gmm tile kernel, the
        # split-KV kernels over float and int8 pools and dense caches (q
        # float32 / bf16 x three head widths of each span kernel, x two of
        # the paged combine kernel, x one of the dense one) and the w8a16 kernels (x float32 / bf16: the
        # FMA kernel at 1, 2, 4 and 8 rows a block, the tensor-core one at
        # 16 and 32)
        built = _build.build_all()
        for src, key, n in (("grouped_gemm", "gmm_tile_kernel", 1),
                            ("paged_attention", "span_kernel", 6),
                            ("paged_attention", "combine_kernel", 4),
                            ("paged_attention_int8", "span_kernel", 6),
                            ("paged_attention_int8", "combine_kernel", 4),
                            ("decode_attention", "decode_span_kernel", 6),
                            ("decode_attention", "decode_combine_kernel",
                             2),
                            ("int8_matmul", "w8a16_", 12)):
            report = _ptxas_report(built[src].ptxas, key)
            for name, (regs, st, ld) in sorted(report.items()):
                say(f"{tag} ptxas {src} {name}: {regs} registers, spill "
                    f"stores {st} B, spill loads {ld} B")
            require(len(report) == n and not any(
                st or ld for _, st, ld in report.values()),
                f"{key} spills or is missing: {report}")
    common = dict(route="cuda", source="paddle_tpu_torch/csrc/"
                  "flash_attention.cu", plain_batch=pb,
                  timed=f"[{B}, {T}, {nh}, {hd}] bf16 causal, warm, CUDA "
                  f"events per call")
    # max_abs_err: the bf16 slice shape's (out; the largest of dq, dk, dv)
    rows["flash_attention_fwd"] = dict(
        name="flash_attention_fwd",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:157",
        max_abs_err=f_abs, ms=ms_f, plain_ms=pl_f, bound_ms=bf_ms,
        bound_by=bf_by, library_ms=lib_f, **common)
    rows["flash_attention_bwd"] = dict(
        name="flash_attention_bwd",
        replaces="paddle_tpu/ops/pallas/flash_attention.py:382",
        max_abs_err=b_abs, ms=ms_b, plain_ms=pl_b, bound_ms=bb_ms,
        bound_by=bb_by, library_ms=lib_b, **common)
    del q, k, v, do, o, lse, dq, dk, dv

    # -- RMSNorm at [B * T, H] bf16, with and without the residual -----
    gen = torch.Generator(device=device).manual_seed(22)
    x, r = (torch.randn((B * T, H), generator=gen, device=device,
                        dtype=bf16) for _ in range(2))
    w = (1 + 0.1 * torch.randn((H,), generator=gen, device=device)).to(bf16)
    eps = 1e-5
    norm = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    errs = []
    for label, res in (("plain", None), ("residual", r)):
        y, z = fn._rms_fwd(x, res, w, eps)
        ry, rz = fn.rms_fwd_reference(x, res, w, eps)
        e = _rel_err(y, ry)
        require(e <= 2 ** -7 and torch.equal(z, rz),
                f"RMSNorm {label} disagrees: {e} x max|ref|")
        errs.append(e)
        if res is None:
            lib = lambda: F.rms_norm(x, (H,), w, eps)  # noqa: E731
        else:
            lib = lambda: F.rms_norm(x + r, (H,), w, eps)  # noqa: E731
        ms = _event_ms(torch, lambda: fn._rms_fwd(x, res, w, eps), device,
                       iters)
        plain_ms = _event_ms(torch, lambda: fn.rms_fwd_reference(
            x, res, w, eps), device, iters)
        lib_ms = _event_ms(torch, lib, device, iters)
        n_io = 2 if res is None else 4            # x (, r) read; y (, z)
        b_ms, _ = _bound(n_io * x.numel() * 2 + H * 2, 0)
        say(f"{tag} fused_rms_norm {label} [{B * T}, {H}] bf16: "
            f"{e:.3e} x max|ref| (tol 2**-7, one bf16 ulp; z bitwise); "
            f"CUDA events per call: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, F.rms_norm"
            f"{' after x + r' if res is not None else ''} {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms (bytes)")
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", b_ms)):
            norm[key] += val
    say(f"{tag} fused_rms_norm a layer's two calls: kernel {norm['ms']:.4f} "
        f"ms, plain {norm['plain_ms']:.4f} ms, library "
        f"{norm['library_ms']:.4f} ms, bound {norm['bound_ms']:.4f} ms")
    rows["fused_rms_norm"] = dict(
        name="fused_rms_norm", route="cuda",
        source="paddle_tpu_torch/csrc/fused_norm.cu",
        replaces="paddle_tpu/ops/pallas/fused_norm.py:105",
        timed=f"a layer's two calls at [{B * T}, {H}] bf16, warm, CUDA "
        f"events",
        max_abs_err=max(errs), bound_by="bytes", **norm)
    del x, r, w, y, z, ry, rz

    # -- AdamW over the slice's 12 leaves: p, g bf16; m, v, master fp32 -
    gen = torch.Generator(device=device).manual_seed(23)
    leaves = []
    for shape in _leaf_shapes(cfg):
        master = 0.02 * torch.randn(shape, generator=gen, device=device)
        leaves.append(dict(
            p=master.to(bf16), g=(1e-3 * torch.randn(
                shape, generator=gen, device=device)).to(bf16),
            m=1e-4 * torch.randn(shape, generator=gen, device=device),
            v=1e-8 * torch.rand(shape, generator=gen, device=device),
            master=master))
    hyper = (3e-4, 0.9, 0.95, 1e-8, 0.1, 3)
    scal = fw.adamw_scalars(*hyper, device)
    err = 0.0
    for lf in leaves:
        ref = {key: t.clone() for key, t in lf.items()}
        fw.fused_adamw_update(lf["p"], lf["g"], lf["m"], lf["v"],
                              lf["master"], *hyper, scal=scal)
        fw.fused_adamw_reference(ref["p"], ref["g"], ref["m"], ref["v"],
                                 ref["master"], scal)
        for key in ("m", "v", "master"):
            e = float((lf[key] - ref[key]).abs().max())
            err = max(err, e)
            require(e <= 1e-6 * max(float(ref[key].abs().max()), 1e-30),
                    f"AdamW {key} disagrees: {e}")
        require(_rel_err(lf["p"], ref["p"]) <= 2 ** -7, "AdamW p disagrees")
        del ref
    n = sum(lf["p"].numel() for lf in leaves)

    def step_kernel():
        for lf in leaves:
            fw.fused_adamw_update(lf["p"], lf["g"], lf["m"], lf["v"],
                                  lf["master"], *hyper, scal=scal)

    def step_plain():
        for lf in leaves:
            fw.fused_adamw_reference(lf["p"], lf["g"], lf["m"], lf["v"],
                                     lf["master"], scal)

    ms = _event_ms(torch, step_kernel, device, iters)
    plain_ms = _event_ms(torch, step_plain, device, iters)
    del leaves
    # yardstick: torch's fused AdamW over float32 parameters and grads of
    # the same sizes (it keeps no bf16 copy and no separate master)
    params = [torch.zeros(s, device=device, requires_grad=True)
              for s in _leaf_shapes(cfg)]
    for p in params:
        p.grad = torch.zeros_like(p)
    opt = torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1, fused=device.type == "cuda")
    lib_ms = _event_ms(torch, opt.step, device, iters)
    del params, opt
    b_ms, b_by = _bound(30 * n, 0)
    say(f"{tag} fused_adamw 12 leaves, {n} elements (p, g bf16; m, v, "
        f"master fp32): max_abs_err {err:.3e} (m, v, master within 1e-6 x "
        f"max|ref|, p one bf16 ulp); CUDA events per step: kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, torch.optim.AdamW(fused) over fp32 "
        f"params {lib_ms:.4f} ms (28 B/element, no bf16 copy), bound "
        f"{b_ms:.4f} ms ({b_by}, 30 B/element)")
    rows["fused_adamw"] = dict(
        name="fused_adamw", route="cuda",
        source="paddle_tpu_torch/csrc/fused_adamw.cu",
        replaces="paddle_tpu/ops/pallas/fused_adamw.py:67",
        timed="a step's 12 calls, warm, CUDA events",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    return rows


def _ptxas_report(text, key):
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    entry functions whose mangled name holds ``key``, from an
    ``-Xptxas -v`` report; the name shortened to ``<name><D,DROP>``."""
    import re
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1) if key in m.group(1) else None
            continue
        if cur is None:
            continue
        k = re.search(r"(flash_[a-z]+_wgmma)ILi(\d+)ELb(\d)", cur)
        t = re.search(r"(decode_span_kernel|decode_combine_kernel|"
                      r"span_kernel|combine_kernel|w8a16_rows_kernel|"
                      r"w8a16_tc_kernel)I\w*?(?:Li(\d+)E|E)", cur)
        name = (f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k else
                f"{t.group(1)}<{'bf16' if 'bfloat16' in cur else 'f32'}"
                f"{',' + t.group(2) if t.group(2) else ''}>" if t else
                "gmm_tile_kernel" if "gmm_tile_kernel" in cur else cur)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name] = (out.get(name, (0,))[0], int(m.group(1)),
                         int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            old = out.get(name, (0, 0, 0))
            out[name] = (int(m.group(1)), old[1], old[2])
    return out


def _row_err(got, ref):
    """(max |err|, max over rows of max|err| / max|ref| in the row) of
    [BH, T, D] tensors; a row is a query (out, dq) or a key (dk, dv). A
    row whose exact value is 0 (dq of a causal first row: its one key
    gives dS = p (dP - delta) = 0) holds rounding noise only, so no row's
    max|ref| counts below 1e-3 x the tensor's."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().amax(-1)
    row = ref.abs().amax(-1)
    row = row.clamp_min(max(1e-3 * float(row.max()), 1e-30))
    return float(err.max()), float((err / row).max())


def _flash_check(torch, fa, q, k, v, do, causal, scale, rate, seed):
    """[_row_err] of out, dq, dk, dv: the kernels against the plain
    versions (the backward of both from the plain forward's out and
    lse)."""
    B, H = q.shape[0], q.shape[2]
    o, lse = fa._fwd_blhd(q, k, v, causal, scale, rate, seed)
    ro, rl = fa.flash_fwd_reference(*(fa._to_bhtd(t) for t in (q, k, v)),
                                    causal, scale, rate, seed)
    grads = fa._bwd_blhd(q, k, v, fa._from_bhtd(ro, B, H), rl, do, causal,
                         scale, rate, seed)
    ref = fa.flash_bwd_reference(*(fa._to_bhtd(t) for t in (q, k, v)), ro,
                                 rl, fa._to_bhtd(do), causal, scale, rate,
                                 seed)
    out = []
    for got, want in [(o, ro)] + list(zip(grads, ref)):
        got = fa._to_bhtd(got)
        require(bool(torch.isfinite(got).all()), "flash: non-finite")
        out.append(_row_err(got, want))
    return out


def _train_counts():
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper import fused_adamw as fw
    from paddle_tpu_torch.ops.hopper import fused_norm as fn
    return {"flash_attention_fwd": fa.launch_count("fwd"),
            "flash_attention_bwd": fa.launch_count("bwd"),
            "fused_rms_norm": fn.launch_count("rms_norm"),
            "fused_adamw": fw.launch_count()}


def _reset_train_counts():
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper import fused_adamw as fw
    from paddle_tpu_torch.ops.hopper import fused_norm as fn
    for mod in (fa, fw, fn):
        mod.reset_launch_count()


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def phase_train(torch, device, cfg, seed, tag, say):
    """Phase 13: LlamaSpmdTrainer at bench.py's Llama-2-7B proxy widths,
    fp32 moments (the fused AdamW), remat off, chunked CE; 1 warm-up step
    and ``train_steps`` steps on one fixed batch. Returns the launch
    counts of the measured steps."""
    from paddle_tpu_torch.models import LlamaSpmdTrainer
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tc = _train_cfg(cfg)
    B, T, L = cfg["train_batch"], cfg["train_seq"], cfg["train_layers"]
    tr = LlamaSpmdTrainer(tc, compute_dtype=torch.bfloat16, remat=False,
                          ce_remat=True, moments_dtype=torch.float32,
                          seed=seed, device=device)
    require(tr._fused == (device.type == "cuda"),
            "the trainer's kernels are not its CUDA path")
    ids = np.random.RandomState(seed + 2).randint(0, tc.vocab_size, (B, T))
    losses = [float(tr.train_step(ids))]               # warm-up
    steps = cfg["train_steps"]
    _sync(torch, device)
    _reset_train_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = tr.train_step(ids)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    counts = _train_counts()
    losses.append(float(loss))
    tok_s = steps * B * T / wall
    fpt = tr.flops_per_token(T)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 20
            if device.type == "cuda" else float("nan"))
    say(f"{tag} training {tr.param_count()} params ({L} layers of "
        f"Llama-2-7B widths, vocab {tc.vocab_size}, batch {B} x seq {T}, "
        f"bf16, fp32 moments): loss {losses[0]:.4f} (warm-up) -> "
        f"{losses[-1]:.4f} after {steps} more steps; {wall / steps:.4f} s "
        f"per step, {tok_s:.1f} tokens/s, MFU {fpt * tok_s / BF16_FLOP_S:.4f}"
        f" ({fpt} FLOP/token over {BF16_FLOP_S:.3g}; a step's bound at the "
        f"bf16 peak {fpt * B * T / BF16_FLOP_S:.4f} s), peak memory "
        f"{peak:.1f} MiB; launches {counts}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    if device.type == "cuda":
        want = {"flash_attention_fwd": L, "flash_attention_bwd": L,
                "fused_rms_norm": 2 * L, "fused_adamw": 12}
        require(counts == {k: steps * n for k, n in want.items()},
                f"launches {counts} are not {steps} x {want}")
        _profile_step(torch, lambda: tr.train_step(ids), tag, say,
                      "training step", {
                          "flash attention": ("flash_",),
                          "GEMMs (cuBLAS)": ("nvjet", "gemm", "xmma",
                                             "cutlass"),
                          "RMSNorm kernel": ("rms_kernel",),
                          "AdamW kernel": ("adamw_kernel",)})
    del tr
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return counts


def phase_train_paths(torch, device, cfg, seed, tag, say):
    """Phase 14: the kernel path against the plain path (the JAX jnp
    branches in PyTorch) at the same widths and T, batch
    ``train_plain_batch``, from equal weights and state: the loss, every
    leaf's gradient, and params / masters after one step."""
    from paddle_tpu_torch.models import LlamaSpmdTrainer
    from paddle_tpu_torch.models.llama_spmd import tree_get, tree_paths
    tc = _train_cfg(cfg)
    B, T = cfg["train_plain_batch"], cfg["train_seq"]
    ids = np.random.RandomState(seed + 3).randint(0, tc.vocab_size, (B, T))
    trs = []
    for fused in (True, False):
        tr = LlamaSpmdTrainer(tc, compute_dtype=torch.bfloat16, remat=False,
                              moments_dtype=torch.float32, seed=seed + 1,
                              device=device)
        tr._fused = fused
        trs.append(tr)
    a, b = trs
    paths = tree_paths(a.params)
    la = a.loss_fn(a.params, ids, ids)
    lb = b.loss_fn(b.params, ids, ids)
    ga = torch.autograd.grad(la, [tree_get(a.params, p) for p in paths])
    gb = torch.autograd.grad(lb, [tree_get(b.params, p) for p in paths])
    dl = abs(la.item() - lb.item()) / abs(lb.item())
    worst, worst_cos = 0.0, 1.0
    for path, x, y in zip(paths, ga, gb):
        e = _rel_err(x, y)
        cos = float(_cosine(torch, x, y))
        worst, worst_cos = max(worst, e), min(worst_cos, cos)
        say(f"{tag}   grad {'/'.join(path)}: {e:.3e} x max|plain|, cosine "
            f"{cos:.6f}")
    say(f"{tag} kernel path vs plain path, batch {B} x seq {T}: loss "
        f"{la.item():.6f} vs {lb.item():.6f} ({dl:.2e} relative, bound "
        f"{BOUND_TRAIN_LOSS}); gradients worst {worst:.3e} x max|plain| "
        f"(bound {BOUND_TRAIN_GRAD}), worst cosine {worst_cos:.6f} (bound "
        f"{BOUND_TRAIN_COS})")
    require(dl <= BOUND_TRAIN_LOSS, f"losses differ by {dl}")
    require(worst <= BOUND_TRAIN_GRAD and worst_cos >= BOUND_TRAIN_COS,
            "kernel-path gradients disagree with the plain path's")
    del ga, gb, la, lb
    for tr in trs:
        tr.train_step(ids)
    # the first AdamW step moves an entry by lr * g / (|g| + eps): +-lr
    # whatever the gradient's size, so where a gradient is near 0 and its
    # sign differs between the paths the masters differ by 2 lr (plus a
    # few float32 ulps); p is master rounded to bf16, each side within
    # half an ulp (2**-8 relative), so |dp| <= |dmaster| + 2**-7 |p|
    bound_m = 2 * a.lr + 1e-6
    dp = dm = 0.0
    for path in paths:
        pa, pb = (tree_get(t.params, path).detach().float()
                  for t in (a, b))
        slack = float((pa - pb).abs().max()) - 2 ** -7 * float(
            pb.abs().max())
        dp = max(dp, slack)
        dm = max(dm, float((tree_get(a.opt_state, path)["master"]
                            - tree_get(b.opt_state, path)["master"]
                            ).abs().max()))
    say(f"{tag} after one step: masters differ by {dm:.3e}, params by "
        f"{dp:.3e} beyond 2**-7 x max|p| of the leaf (bound {bound_m:.3e} "
        f"for both)")
    require(dm <= bound_m and dp <= bound_m,
            "params after one step disagree between the paths")
    del trs, a, b
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _cosine(torch, x, y):
    x, y = x.float().flatten(), y.float().flatten()
    return (x @ y) / max(float(x.norm() * y.norm()), 1e-30)


# -- the BERT pretraining slice ---------------------------------------------

def _bert_cfg(cfg, hidden_dropout=0.1, attn_dropout=0.1):
    from paddle_tpu_torch.models import BertConfig
    return BertConfig(
        vocab_size=cfg["bert_vocab"], hidden_size=cfg["bert_hidden"],
        num_hidden_layers=cfg["bert_layers"],
        num_attention_heads=cfg["bert_heads"],
        intermediate_size=cfg["bert_ffn"],
        hidden_dropout_prob=hidden_dropout,
        attention_probs_dropout_prob=attn_dropout)


def _bert_batch(torch, device, cfg, batch, seed):
    """bench_extra.py's feed (:216-226): ids and MLM labels uniform over
    the vocabulary, 85% of the labels -100, NSP labels 0/1."""
    rng = np.random.default_rng(seed)
    T, V = cfg["bert_seq"], cfg["bert_vocab"]
    ids = rng.integers(0, V, (batch, T), dtype=np.int64)
    mlm = rng.integers(0, V, (batch, T), dtype=np.int64)
    nsp = rng.integers(0, 2, (batch,), dtype=np.int64)
    mlm[rng.random((batch, T)) > 0.15] = -100
    return [torch.from_numpy(a).to(device) for a in (ids, mlm, nsp)]


def _bf16_ulp_ok(torch, got, want):
    """Every element of bf16 ``got`` within one bf16 ulp of ``want``: the
    ulp of the element, or of 2**-6 x max|want| for smaller elements
    (where LayerNorm's ``xc * rstd * w + b`` cancels, the float32
    rounding of the terms, not the bf16 rounding, sets the error)."""
    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(max(2.0 ** -6 * float(want.abs().max()),
                                   2.0 ** -126))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp).all())


def phase_bert_kernels(torch, device, cfg, tag, say):
    """Phase 15: the LayerNorm and dropout kernels against their plain
    versions at the BERT path's shapes, in float32 and bf16, then timed
    (profiler device sums) beside the bound, the plain version and one
    PyTorch call. Returns {name: row}."""
    from paddle_tpu_torch.ops.hopper import fused_norm as fn
    F = torch.nn.functional
    iters = cfg["bert_timing_iters"]
    R = cfg["bert_batch"] * cfg["bert_seq"]
    H, FF = cfg["bert_hidden"], cfg["bert_ffn"]
    eps = 1e-12
    gen = torch.Generator(device=device).manual_seed(31)
    rows = {}

    # -- LayerNorm (+ residual) ----------------------------------------
    ln = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    ln_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        x, r = (torch.randn((R, H), generator=gen, device=device).to(dt)
                for _ in range(2))
        w = (1 + 0.1 * torch.randn(H, generator=gen, device=device)).to(dt)
        b = (0.1 * torch.randn(H, generator=gen, device=device)).to(dt)
        for res in (None, r):
            y, z = fn._ln_fwd_call(x, res, w, b, eps)
            ry, rz = fn.ln_fwd_reference(x, res, w, b, eps)
            require(torch.equal(z, rz), "LayerNorm: z is not bitwise")
            e = _rel_err(y, ry)
            if dt == torch.float32:
                require(e <= 1e-5, f"LayerNorm fp32 disagrees: {e}")
                ln_err = max(ln_err, float((y - ry).abs().max()))
            else:
                require(_bf16_ulp_ok(torch, y, ry),
                        f"LayerNorm bf16: not within one ulp ({e})")
            say(f"{tag} fused_layer_norm [{R}, {H}] {str(dt)[6:]} "
                f"{'+ residual' if res is not None else 'alone'}: "
                f"{e:.3e} x max|ref| (fp32 tol 1e-5, bf16 one ulp; z "
                f"bitwise)")
        # the backward is plain PyTorch from the saved z
        xs = [t.detach().float().requires_grad_(True) for t in (x, r, w, b)]
        gy = torch.randn((R, H), generator=gen, device=device)
        yk, _ = fn.fused_layer_norm_residual(*xs, eps)
        got = torch.autograd.grad(yk, xs, gy)
        _, rz = fn.ln_fwd_reference(*xs, eps)
        want = fn._ln_core_bwd(eps, rz.detach(), xs[2].detach(), gy, None)
        for a, c in zip(got, want):
            e = _rel_err(a, c)
            require(e <= 1e-5, f"LayerNorm backward disagrees: {e}")
        if dt != torch.float32:
            continue
        # timing at the path's call: float32 with the residual
        t_k = _time_ms(torch, lambda: fn._ln_fwd_call(x, r, w, b, eps),
                       device, iters)
        t_p = _time_ms(torch, lambda: fn.ln_fwd_reference(x, r, w, b, eps),
                       device, iters)
        t_l = _time_ms(torch, lambda: F.layer_norm(x + r, (H,), w, b, eps),
                       device, iters)
        ms, plain_ms, lib_ms = _device(t_k, t_p, t_l)
        b_ms, b_by = _bound(4 * x.numel() * 4 + 2 * H * 4, 10 * x.numel())
        say(f"{tag} fused_layer_norm + residual [{R}, {H}] fp32 per call "
            f"(profiler device time; events {t_k[1]:.4f} ms): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, add + F.layer_norm "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        # a layer's two calls, as the row of the kernels line
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", b_ms)):
            ln[key] = 2 * val
    rows["fused_layer_norm"] = dict(
        name="fused_layer_norm", route="cuda",
        source="paddle_tpu_torch/csrc/fused_norm.cu",
        replaces="paddle_tpu/ops/pallas/fused_norm.py:201",
        timed=f"a layer's two calls at [{R}, {H}] float32 with the "
        f"residual, warm, profiler device time",
        max_abs_err=ln_err, bound_by="bytes", **ln)
    say(f"{tag} fused_layer_norm a layer's two calls: kernel "
        f"{ln['ms']:.4f} ms, plain {ln['plain_ms']:.4f} ms, library "
        f"{ln['library_ms']:.4f} ms, bound {ln['bound_ms']:.4f} ms")

    # -- dropout ---------------------------------------------------------
    p, seed = 0.1, 20240917
    drop = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    div = torch.tensor(np.float32(1 - p), device=device)
    for dt in (torch.float32, torch.bfloat16):
        for width, per_layer in ((H, 2), (FF, 1)):
            x = torch.randn((R, width), generator=gen, device=device).to(dt)
            xg = x.clone().requires_grad_(True)
            y = fn._dropout_via_vjp(xg, p, seed)
            require(torch.equal(y, fn.dropout_reference(x, p, seed)),
                    "dropout: kernel and plain version differ")
            keep = fn.dropout_keep(x.numel(), seed, p, device).view(x.shape)
            kept = float(keep.float().mean())
            # 1e-3 at the path's shapes (>= 5 standard deviations of the
            # share there); five standard deviations at a rehearsal's
            tol = max(1e-3, 5 * (p * (1 - p) / x.numel()) ** 0.5)
            require(abs(kept - (1 - p)) <= tol,
                    f"dropout keeps {kept}, not {1 - p} +- {tol}")
            gy = torch.randn(x.shape, generator=gen, device=device).to(dt)
            gx, = torch.autograd.grad(y, (xg,), gy)
            require(torch.equal(gx, ((gy.float() * keep.float()) / div)
                                .to(dt)),
                    "dropout backward is not gy * keep / (1 - p)")
            say(f"{tag} fused_dropout [{R}, {width}] {str(dt)[6:]} p {p}: "
                f"bitwise equal to the plain version, kept {kept:.6f}, "
                f"backward gy * keep / (1 - p) bitwise")
            if dt != torch.float32:
                continue
            t_k = _time_ms(torch, lambda: fn._fused_dropout(x, p, seed),
                           device, iters)
            t_p = _time_ms(torch, lambda: fn.dropout_reference(x, p, seed),
                           device, iters)
            t_l = _time_ms(torch, lambda: F.dropout(x, p, training=True),
                           device, iters)
            ms, plain_ms, lib_ms = _device(t_k, t_p, t_l)
            b_ms, b_by = _bound(2 * x.numel() * 4, 0)
            say(f"{tag} fused_dropout [{R}, {width}] fp32 per call "
                f"(profiler device time; events {t_k[1]:.4f} ms): kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.dropout "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", lib_ms), ("bound_ms", b_ms)):
                drop[key] += per_layer * val
    rows["fused_dropout"] = dict(
        name="fused_dropout", route="cuda",
        source="paddle_tpu_torch/csrc/fused_norm.cu",
        replaces="paddle_tpu/ops/pallas/fused_norm.py:304",
        timed=f"a layer's three forward calls (2 x [{R}, {H}] + [{R}, "
        f"{FF}]) float32, warm, profiler device time",
        max_abs_err=0.0, bound_by="bytes", **drop)
    say(f"{tag} fused_dropout a layer's three forward calls (2 x [{R}, "
        f"{H}] + [{R}, {FF}]): kernel {drop['ms']:.4f} ms, plain "
        f"{drop['plain_ms']:.4f} ms, library {drop['library_ms']:.4f} ms, "
        f"bound {drop['bound_ms']:.4f} ms")
    return rows


def _bert_counts():
    from paddle_tpu_torch.ops.hopper import fused_norm as fn
    return {"fused_layer_norm": fn.launch_count("layer_norm"),
            "fused_dropout": fn.launch_count("dropout")}


def bert_flops_per_step(bc, batch, seq):
    """6 x tokens x the parameters of every matrix product a token goes
    through (12 layers' q, k, v, out, FFN, the MLM transform and the tied
    decoder), plus the pooler and NSP head per sequence, plus attention's
    two [T, T] products per head (forward 4 T^2 h per layer and
    sequence, three times that with the backward). No recompute."""
    h, f, V, L = (bc.hidden_size, bc.intermediate_size, bc.vocab_size,
                  bc.num_hidden_layers)
    per_token = L * (4 * h * h + 2 * h * f) + h * h + h * V
    per_seq = h * h + 2 * h
    return (6 * batch * seq * per_token + 6 * batch * per_seq
            + 12 * batch * seq * seq * h * L)


def phase_bert_train(torch, device, cfg, seed, tag, say):
    """Phase 16: BERT-base pretraining (bench_extra.py's config #2:
    batch 32 x 128, AdamW(1e-4), FLAGS_tpu_fused_encoder on, float32),
    1 warm-up and ``bert_steps`` steps on one seeded batch. Returns the
    kernels' launch counts over the measured steps and the step's
    figures (seconds, MFU, peak MiB) for phase 23."""
    import paddle_tpu_torch
    from paddle_tpu_torch.models import BertForPretraining
    from paddle_tpu_torch.ops.hopper import fused_norm as fn
    from paddle_tpu_torch.optimizer import AdamW
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bc = _bert_cfg(cfg)
    B, T, L = cfg["bert_batch"], cfg["bert_seq"], bc.num_hidden_layers
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": True})
    try:
        model = BertForPretraining(
            bc, device=device, generator=torch.Generator().manual_seed(seed))
        opt = AdamW(1e-4, parameters=model.parameters())
        ids, mlm, nsp = _bert_batch(torch, device, cfg, B, seed + 4)

        def step():
            loss, _ = model(ids, masked_lm_labels=mlm,
                            next_sentence_label=nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        losses = [float(step())]                       # warm-up
        steps = cfg["bert_steps"]
        _sync(torch, device)
        fn.reset_launch_count()
        t0 = time.perf_counter()
        out = [step() for _ in range(steps)]
        _sync(torch, device)
        wall = time.perf_counter() - t0
        counts = _bert_counts()
        losses += [float(v) for v in out]
        n_params = sum(p.numel() for p in model.parameters())
        flops = bert_flops_per_step(bc, B, T)
        s_step = wall / steps
        peak = (torch.cuda.max_memory_allocated() / 2 ** 20
                if device.type == "cuda" else float("nan"))
        figures = {"s_step": s_step, "peak": peak,
                   "mfu": flops / s_step / FP32_FLOP_S}
        say(f"{tag} BERT-base pretraining, {n_params} params ({L} layers, "
            f"hidden {bc.hidden_size}, vocab {bc.vocab_size}), batch {B} x "
            f"seq {T}, fp32, AdamW(1e-4), fused encoder: loss "
            f"{losses[0]:.4f} (warm-up) -> {losses[-1]:.4f} after {steps} "
            f"steps; {s_step:.4f} s per step, {B / s_step:.1f} sequences/s,"
            f" MFU {flops / s_step / FP32_FLOP_S:.4f} ({flops:.4e} FLOP a "
            f"step over the {FP32_FLOP_S:.3g} fp32 non-tensor peak; a "
            f"step's bound there {flops / FP32_FLOP_S:.4f} s), peak memory "
            f"{peak:.1f} MiB; launches {counts}")
        require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        if device.type == "cuda":
            want = {"fused_layer_norm": 2 * L,
                    "fused_dropout": 2 * (1 + 3 * L)}
            require(counts == {k: steps * n for k, n in want.items()},
                    f"launches {counts} are not {steps} x {want}")
            _profile_step(torch, step, tag, say, "BERT training step", {
                "GEMMs (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass",
                                   "sm90_"),
                "LayerNorm kernel": ("ln_kernel",),
                "dropout kernel": ("dropout_kernel",)})
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": False})
    del model, opt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return counts, figures


def _profile_step(torch, step, tag, say, what, groups):
    """One profiled call of ``step``: host wall, device busy, time by
    kernel group and the costliest kernels."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ev = [(getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0)), e.count, e.key)
          for e in prof.key_averages()]
    ev = [e for e in ev if e[0] > 0]
    busy = sum(e[0] for e in ev) / 1e3
    split = {g: sum(t for t, _, k in ev if any(n in k for n in names))
             / 1e3 for g, names in groups.items()}
    split["other (elementwise, CE, embedding, ...)"] = busy - sum(
        split.values())
    top = sorted(ev, reverse=True)[:8]
    say(f"{tag} profile of one {what}: host wall {wall:.1f} ms "
        f"(profiled), device busy {busy:.1f} ms ({100 * busy / wall:.1f}%),"
        f" {sum(e[1] for e in ev)} kernel launches; by kind: "
        + ", ".join(f"{g} {v:.1f} ms" for g, v in split.items())
        + "; costliest: "
        + "; ".join(f"{k[:60]} x{c} {t / 1e3:.2f} ms" for t, c, k in top))


def phase_bert_paths(torch, device, cfg, seed, tag, say):
    """Phase 17: the kernel path on the card against the plain path on
    the CPU (the kernels' plain versions) at full width, batch
    ``bert_plain_batch``: hidden dropout 0.1 (the hash mask is the same
    on both devices), attention dropout 0 (its Bernoulli bits come from
    each device's own generator), the same weights and seeds. Loss within
    BOUND_BERT_LOSS relative; each gradient within BOUND_BERT_GRAD x
    max|g| and cosine >= BOUND_BERT_COS."""
    import paddle_tpu_torch
    from paddle_tpu_torch.models import BertForPretraining
    bc = _bert_cfg(cfg, hidden_dropout=0.1, attn_dropout=0.0)
    B = cfg["bert_plain_batch"]
    cpu = torch.device("cpu")
    batch = _bert_batch(torch, cpu, cfg, B, seed + 5)
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": True})
    try:
        res = []
        state = None
        for dev in (device, cpu):
            m = BertForPretraining(
                bc, device=dev,
                generator=torch.Generator().manual_seed(seed + 6))
            if state is None:
                state = {k: v.detach().cpu() for k, v in
                         m.state_dict().items()}
            else:
                m.load_state_dict(state)
            ids, mlm, nsp = (t.to(dev) for t in batch)
            loss, _ = m(ids, masked_lm_labels=mlm, next_sentence_label=nsp)
            loss.backward()
            res.append((loss.item(), {n: p.grad.detach().cpu() for n, p in
                                      m.named_parameters()
                                      if p.grad is not None}))
            del m
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": False})
    (lk, gk), (lp, gp) = res
    dl = abs(lk - lp) / abs(lp)
    require(set(gk) == set(gp), "the two paths differ in which parameters "
            "get gradients")
    # the key projection's bias has an exact gradient of 0 (softmax is
    # unchanged by a per-query shift of the scores): both sides hold
    # rounding noise there, so no tensor's max|g| counts below 1e-3 x the
    # model's largest, and noise tensors take no cosine
    floor = 1e-3 * max(float(g.abs().max()) for g in gp.values())
    worst, worst_cos, noise = 0.0, 1.0, []
    for n in gp:
        scale = float(gp[n].abs().max())
        e = float((gk[n] - gp[n]).abs().max()) / max(scale, floor)
        worst = max(worst, e)
        if scale < floor:
            noise.append(n)
            continue
        worst_cos = min(worst_cos, float(_cosine(torch, gk[n], gp[n])))
    say(f"{tag} BERT-base kernel path (card) vs plain path (CPU), batch "
        f"{B} x {cfg['bert_seq']}, hidden dropout 0.1: loss {lk:.7f} vs "
        f"{lp:.7f} ({dl:.2e} relative, bound {BOUND_BERT_LOSS}); "
        f"gradients worst {worst:.3e} x max|g| (bound {BOUND_BERT_GRAD}), "
        f"worst cosine {worst_cos:.7f} (bound {BOUND_BERT_COS}; "
        f"{len(noise)} noise-level tensors: {noise})")
    require(dl <= BOUND_BERT_LOSS, f"losses differ by {dl}")
    require(worst <= BOUND_BERT_GRAD and worst_cos >= BOUND_BERT_COS,
            "the kernel path's gradients disagree with the plain path's")
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# -- phase 23: the nn training surface under AMP -----------------------------

class _LaunchDtypes:
    """Tally the dtype of every LayerNorm / RMSNorm / dropout kernel
    launch inside the block (wraps the wrappers' launch functions; the
    launch counters stay theirs)."""

    def __init__(self):
        from paddle_tpu_torch.ops.hopper import fused_norm as fn
        self._fn = fn
        self.seen = {}

    def __enter__(self):
        fn = self._fn
        self._saved = (fn._launch_norm, fn._launch_dropout)
        norm, drop = self._saved

        def launch_norm(kind, x, *a, **k):
            self.seen.setdefault(kind, set()).add(str(x.dtype)[6:])
            return norm(kind, x, *a, **k)

        def launch_dropout(x, *a, **k):
            self.seen.setdefault("dropout", set()).add(str(x.dtype)[6:])
            return drop(x, *a, **k)
        fn._launch_norm, fn._launch_dropout = launch_norm, launch_dropout
        return self

    def __exit__(self, *exc):
        self._fn._launch_norm, self._fn._launch_dropout = self._saved
        return False


def _free(torch, device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _peak_mib(torch, device):
    return (torch.cuda.max_memory_allocated() / 2 ** 20
            if device.type == "cuda" else float("nan"))


def _grads_agree(torch, ga, gb):
    """(worst max-error over max|g|, worst cosine, noise tensors) of two
    gradient dicts; a tensor whose max|g| is below 1e-2 x the largest
    (bf16 rounding noise) takes no cosine."""
    floor = 1e-2 * max(float(g.abs().max()) for g in gb.values())
    worst, worst_cos, noise = 0.0, 1.0, []
    for n in gb:
        scale = float(gb[n].abs().max())
        worst = max(worst, float((ga[n] - gb[n]).abs().max())
                    / max(scale, floor))
        if scale < floor:
            noise.append(n)
            continue
        worst_cos = min(worst_cos, float(_cosine(torch, ga[n], gb[n])))
    return worst, worst_cos, noise


def _timed_steps(torch, device, step, steps):
    """1 warm-up and ``steps`` timed calls of ``step`` (each returns its
    loss); (losses, seconds per step, launch counts of the timed steps
    from ``_amp_counts``)."""
    losses = [float(step())]
    _sync(torch, device)
    _reset_train_counts()
    t0 = time.perf_counter()
    out = [step() for _ in range(steps)]
    _sync(torch, device)
    wall = time.perf_counter() - t0
    counts = _amp_counts()
    return losses + [float(v) for v in out], wall / steps, counts


def _amp_counts():
    c = _train_counts()
    c.update(_bert_counts())
    del c["fused_adamw"]
    return c


def phase_amp_bert(torch, device, cfg, seed, fp32, tag, say):
    """Phase 23a: BERT-base pretraining as bench_extra.py's AMP-O2 leg
    (:239-271): phase 16's config, batch, labels and fused encoder,
    ``decorate`` bf16, ``auto_cast(level="O2")``, multi-precision AdamW;
    1 warm-up and ``bert_steps`` steps. ``fp32``: phase 16's figures."""
    import paddle_tpu_torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bc = _bert_cfg(cfg)
    B, T, L = cfg["bert_batch"], cfg["bert_seq"], bc.num_hidden_layers
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": True})
    try:
        model = BertForPretraining(
            bc, device=device, generator=torch.Generator().manual_seed(seed))
        amp.decorate(model, level="O2", dtype="bfloat16")
        opt = AdamW(1e-4, parameters=model.parameters(),
                    multi_precision=True)
        ids, mlm, nsp = _bert_batch(torch, device, cfg, B, seed + 4)

        def step():
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                loss, _ = model(ids, masked_lm_labels=mlm,
                                next_sentence_label=nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        with _LaunchDtypes() as dts:
            losses, s_step, counts = _timed_steps(torch, device, step,
                                                  cfg["bert_steps"])
        flops = bert_flops_per_step(bc, B, T)
        peak = _peak_mib(torch, device)
        say(f"{tag} BERT-base pretraining under AMP O2 (bf16 weights, "
            f"fp32 masters, fused encoder), batch {B} x seq {T}: loss "
            f"{losses[0]:.4f} (warm-up) -> {losses[-1]:.4f} after "
            f"{len(losses) - 1} steps; {s_step:.4f} s per step, "
            f"{B / s_step:.1f} sequences/s, MFU {flops / s_step / BF16_FLOP_S:.4f}"
            f" ({flops:.4e} FLOP a step over the {BF16_FLOP_S:.3g} bf16 "
            f"dense peak; a step's bound there {flops / BF16_FLOP_S:.4f} s),"
            f" peak memory {peak:.1f} MiB; launches {counts}, kernel "
            f"dtypes {dts.seen}; phase 16 (fp32) in this run: "
            f"{fp32['s_step']:.4f} s per step, {B / fp32['s_step']:.1f} "
            f"sequences/s, MFU {fp32['mfu']:.4f} against the fp32 "
            f"non-tensor peak ({flops / fp32['s_step'] / BF16_FLOP_S:.4f} "
            f"against the bf16 peak), peak {fp32['peak']:.1f} MiB; O2 "
            f"speed-up x{fp32['s_step'] / s_step:.2f}")
        require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
        require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        if device.type == "cuda":
            steps = cfg["bert_steps"]
            want = {"fused_layer_norm": 2 * L,
                    "fused_dropout": 2 * (1 + 3 * L)}
            got = {k: counts[k] for k in want}
            require(got == {k: steps * n for k, n in want.items()},
                    f"launches {got} are not {steps} x {want}")
            require(dts.seen == {"layer_norm": {"bfloat16"},
                                 "dropout": {"bfloat16"}},
                    f"kernel dtypes under O2: {dts.seen}")
            _profile_step(torch, step, tag, say, "BERT O2 training step", {
                "GEMMs (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass",
                                   "sm90_"),
                "LayerNorm kernel": ("ln_kernel",),
                "dropout kernel": ("dropout_kernel",),
                "casts (copy kernels)": ("copy",)})
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": False})
    del model, opt
    _free(torch, device)


def phase_amp_bert_paths(torch, device, cfg, seed, tag, say):
    """Phase 23a, second leg: the O2 kernel path on the card against the
    plain O2 path on the CPU at batch ``bert_plain_batch`` (hidden
    dropout 0.1 with the hash mask both devices share, attention dropout
    0), the same weights and seeds."""
    import paddle_tpu_torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import BertForPretraining
    bc = _bert_cfg(cfg, hidden_dropout=0.1, attn_dropout=0.0)
    B = cfg["bert_plain_batch"]
    cpu = torch.device("cpu")
    batch = _bert_batch(torch, cpu, cfg, B, seed + 5)
    paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": True})
    t0 = time.perf_counter()
    try:
        res, state = [], None
        for dev in (device, cpu):
            m = BertForPretraining(
                bc, device=dev,
                generator=torch.Generator().manual_seed(seed + 6))
            if state is None:
                state = {k: v.detach().cpu() for k, v in
                         m.state_dict().items()}
            else:
                m.load_state_dict(state)
            amp.decorate(m, level="O2", dtype="bfloat16")
            ids, mlm, nsp = (t.to(dev) for t in batch)
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                loss, _ = m(ids, masked_lm_labels=mlm,
                            next_sentence_label=nsp)
            require(loss.dtype == torch.bfloat16,
                    f"the O2 loss is {loss.dtype}, the reference's is bf16")
            loss.backward()
            res.append((loss.float().item(),
                        {n: p.grad.detach().float().cpu() for n, p in
                         m.named_parameters() if p.grad is not None}))
            del m
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_tpu_fused_encoder": False})
    (lk, gk), (lp, gp) = res
    dl = abs(lk - lp) / abs(lp)
    require(set(gk) == set(gp), "the two O2 paths differ in which "
            "parameters get gradients")
    worst, worst_cos, noise = _grads_agree(torch, gk, gp)
    say(f"{tag} BERT-base O2 kernel path (card) vs plain O2 path (CPU), "
        f"batch {B} x {cfg['bert_seq']}, hidden dropout 0.1: loss "
        f"{lk:.5f} vs {lp:.5f} ({dl:.2e} relative, bound {BOUND_AMP_LOSS});"
        f" gradients worst {worst:.3e} x max|g|, worst cosine "
        f"{worst_cos:.5f} (bound {BOUND_AMP_COS}; {len(noise)} "
        f"noise-level tensors: {noise}); {time.perf_counter() - t0:.1f} s")
    require(dl <= BOUND_AMP_LOSS, f"O2 losses differ by {dl}")
    require(worst_cos >= BOUND_AMP_COS,
            "the O2 kernel path's gradients disagree with the plain path's")
    _free(torch, device)


def _llama_flops_per_token(c, T):
    """phase 13's convention (LlamaSpmdTrainer.flops_per_token)."""
    H, F_, V = c.hidden_size, c.intermediate_size, c.vocab_size
    KV = c.num_key_value_heads * (H // c.num_attention_heads)
    per_layer = 2 * H * H + 2 * H * KV + 3 * H * F_
    return 6 * (c.num_hidden_layers * per_layer + V * H) \
        + 6 * c.num_hidden_layers * H * T


def _greedy_vs_reforward(torch, logits_of, tokens, prompt_len):
    """(steps, per row the first step whose reference gap is a near-tie,
    every row agrees up to it): the generated ``tokens`` [B, P + n]
    against the argmax of one no-cache forward over them (teacher
    forcing: position P - 1 + t predicts token P + t)."""
    with torch.no_grad():
        lg = logits_of(tokens[:, :-1])[:, prompt_len - 1:].float()
    n = tokens.shape[1] - prompt_len
    top2 = lg.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    tol = TOL_TIE_BF16 * float(lg.abs().max())
    ref = lg.argmax(-1).cpu().numpy()
    got = tokens[:, prompt_len:].cpu().numpy()
    first, ok = [], True
    for i in range(tokens.shape[0]):
        small = np.flatnonzero(gap[i] < tol)
        upto = int(small[0]) if small.size else n
        first.append(upto)
        ok &= bool((ref[i, :upto] == got[i, :upto]).all())
    return n, first, ok


def phase_amp_llama(torch, device, cfg, seed, tag, say):
    """Phase 23b: LlamaForCausalLM at phase 13's widths under O2 with
    multi-precision AdamW, then greedy generate with the KV cache."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tc = _train_cfg(cfg)
    B, T, L = cfg["train_batch"], cfg["train_seq"], cfg["train_layers"]
    model = LlamaForCausalLM(tc, device=device,
                             generator=torch.Generator().manual_seed(seed))
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)
    ids = torch.from_numpy(np.random.RandomState(seed + 2).randint(
        0, tc.vocab_size, (B, T))).to(device)

    def step():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    with _LaunchDtypes() as dts:
        losses, s_step, counts = _timed_steps(torch, device, step,
                                              cfg["train_steps"])
    fpt = _llama_flops_per_token(tc, T)
    tok_s = B * T / s_step
    n_params = sum(p.numel() for p in model.parameters())
    say(f"{tag} LlamaForCausalLM under AMP O2, {n_params} params ({L} "
        f"layers of Llama-2-7B widths, vocab {tc.vocab_size}, full "
        f"[B, T, vocab] logits and an fp32 cross entropy), batch {B} x "
        f"seq {T}, multi-precision AdamW: loss {losses[0]:.4f} (warm-up) "
        f"-> {losses[-1]:.4f} after {len(losses) - 1} steps; {s_step:.4f} "
        f"s per step, {tok_s:.1f} tokens/s, MFU "
        f"{fpt * tok_s / BF16_FLOP_S:.4f} ({fpt} FLOP/token over "
        f"{BF16_FLOP_S:.3g}), peak memory {_peak_mib(torch, device):.1f} "
        f"MiB; launches {counts}, kernel dtypes {dts.seen}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    steps = cfg["train_steps"]
    if device.type == "cuda":
        want = {"flash_attention_fwd": L, "flash_attention_bwd": L,
                "fused_rms_norm": 2 * L + 1}
        got = {k: counts[k] for k in want}
        require(got == {k: steps * n for k, n in want.items()},
                f"launches {got} are not {steps} x {want}")
        require(dts.seen == {"rms_norm": {"bfloat16"}},
                f"kernel dtypes under O2: {dts.seen}")
        _profile_step(torch, step, tag, say, "Llama O2 training step", {
            "flash attention": ("flash_",),
            "GEMMs (cuBLAS)": ("nvjet", "gemm", "xmma", "cutlass", "sm90_"),
            "RMSNorm kernel": ("rms_kernel",),
            "casts (copy kernels)": ("copy",)})
    del opt
    _free(torch, device)
    # greedy decode with the cache: the flash kernel at Lq 1
    model.eval()
    P, n = cfg["gen_prompt"], cfg["gen_new"]
    prompt = ids[:cfg["gen_batch"], :P]
    before = fa.launch_count("fwd")
    t0 = time.perf_counter()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        out = model.generate(prompt, max_new_tokens=n)
        _sync(torch, device)
        wall = time.perf_counter() - t0
        launched = fa.launch_count("fwd") - before
        steps_, first, ok = _greedy_vs_reforward(torch, model, out, P)
    say(f"{tag} Llama O2 generate: batch {prompt.shape[0]}, prompt {P}, "
        f"{n} new tokens with the KV cache in {wall:.3f} s "
        f"({prompt.shape[0] * n / wall:.1f} tokens/s); flash forward "
        f"launches {launched}; tokens equal to a no-cache re-forward's "
        f"argmax up to each row's first near-tie (gap < {TOL_TIE_BF16} x "
        f"max|logit|): {ok}, first near-ties {first} of {steps_}")
    require(out.shape == (prompt.shape[0], P + n), "generate's shape")
    require(ok, "cached generate departs from the re-forward's argmax "
            "before a near-tie")
    if device.type == "cuda":
        require(launched == L * n, f"flash launches in generate: "
                f"{launched}, not {L} x {n}")
    del model
    _free(torch, device)


def _gpt_cfg(cfg, recompute):
    from paddle_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=cfg["vocab"], hidden_size=cfg["d"],
                     num_hidden_layers=cfg["layers"],
                     num_attention_heads=cfg["heads"],
                     intermediate_size=cfg["ffn"],
                     max_position_embeddings=cfg["gpt_seq"],
                     recompute=recompute)


def phase_amp_gpt(torch, device, cfg, seed, tag, say):
    """Phase 23c: GPTForCausalLM at GPTConfig's widths under O2 with
    recompute (config #4's regime), then recompute on against off."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gc_ = _gpt_cfg(cfg, True)
    B, T, L = cfg["gpt_batch"], cfg["gpt_seq"], gc_.num_hidden_layers
    ids = torch.from_numpy(np.random.RandomState(seed + 7).randint(
        0, gc_.vocab_size, (B, T))).to(device)
    model = GPTForCausalLM(gc_, device=device,
                           generator=torch.Generator().manual_seed(seed))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)

    def step():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss, _ = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    with _LaunchDtypes() as dts:
        losses, s_step, counts = _timed_steps(torch, device, step,
                                              cfg["gpt_steps"])
    H, F_, V = gc_.hidden_size, gc_.intermediate_size, gc_.vocab_size
    fpt = 6 * (L * (4 * H * H + 2 * H * F_) + V * H) + 6 * L * H * T
    tok_s = B * T / s_step
    say(f"{tag} GPTForCausalLM under AMP O2 with recompute, "
        f"{sum(p.numel() for p in model.parameters())} params (GPTConfig: "
        f"{L} layers, d {H}, vocab {V}, dropout 0.1), batch {B} x seq {T}:"
        f" loss {losses[0]:.4f} (warm-up) -> {losses[-1]:.4f} after "
        f"{len(losses) - 1} steps; {s_step:.4f} s per step, {tok_s:.1f} "
        f"tokens/s, MFU {fpt * tok_s / BF16_FLOP_S:.4f} ({fpt} FLOP/token,"
        f" recompute not counted), peak memory "
        f"{_peak_mib(torch, device):.1f} MiB; launches {counts}, kernel "
        f"dtypes {dts.seen}")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    steps = cfg["gpt_steps"]
    if device.type == "cuda":
        # the flash forward runs again in each block's replay; dropout
        # runs forward (1 + 2 L), in the replay (L: torch's non-reentrant
        # checkpoint stops a replay once the block's last saved tensor is
        # recomputed, before the second hidden dropout, whose backward
        # needs nothing saved) and backward (1 + 2 L)
        want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd": L,
                "fused_dropout": 2 + 5 * L}
        got = {k: counts[k] for k in want}
        require(got == {k: steps * n for k, n in want.items()},
                f"launches {got} are not {steps} x {want}")
        require(dts.seen == {"dropout": {"bfloat16"}},
                f"kernel dtypes under O2: {dts.seen}")
        _profile_step(torch, step, tag, say, "GPT O2 recompute step", {
            "flash attention": ("flash_",),
            "GEMMs (cuBLAS)": ("nvjet", "gemm", "xmma", "cutlass", "sm90_"),
            "dropout kernel": ("dropout_kernel",),
            "casts (copy kernels)": ("copy",)})
    del model, opt
    _free(torch, device)
    # recompute on against off: equal weights, equal generator seeds
    grads, lvals = [], []
    for rc in (True, False):
        m = GPTForCausalLM(_gpt_cfg(cfg, rc), device=device,
                           generator=torch.Generator().manual_seed(seed + 1))
        m.load_state_dict(state)
        amp.decorate(m, level="O2", dtype="bfloat16")
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss, _ = m(ids, labels=ids)
        loss.backward()
        lvals.append(loss.float().item())
        grads.append({n: p.grad.detach().float() for n, p in
                      m.named_parameters()})
        del m, loss
        _free(torch, device)
    worst, worst_cos, noise = _grads_agree(torch, grads[0], grads[1])
    dl = abs(lvals[0] - lvals[1]) / abs(lvals[1])
    say(f"{tag} GPT O2 recompute on vs off (dropout 0.1, one seed): loss "
        f"{lvals[0]:.5f} vs {lvals[1]:.5f} ({dl:.2e} relative, bound "
        f"{BOUND_AMP_LOSS}); gradients worst {worst:.3e} x max|g|, worst "
        f"cosine {worst_cos:.6f} (bound {BOUND_AMP_COS}; {len(noise)} "
        f"noise-level tensors)")
    require(dl <= BOUND_AMP_LOSS and worst_cos >= BOUND_AMP_COS,
            "recompute changes the gradients")
    del grads, state
    _free(torch, device)


def phase_amp_transformer_moe(torch, device, cfg, seed, tag, say):
    """Phase 23d: nn.Transformer() (defaults, pre-norm) with a tied token
    embedding: one O2 step, then an incremental greedy decode through
    gen_cache against full causal re-forwards; MoELayer under O2: the
    routing on the card against the CPU's from the same logits, forward
    and backward against the float32 layer."""
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.framework.op import matmul
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    g = torch.Generator().manual_seed(seed + 8)
    V, B, S = cfg["tf_vocab"], cfg["tf_batch"], cfg["tf_len"]
    model = nn.Transformer(normalize_before=True, device=device, generator=g)
    emb = nn.Embedding(V, model.d_model, device=device, generator=g)
    amp.decorate([model, emb], level="O2", dtype="bfloat16")
    params = list(model.parameters()) + list(emb.parameters())
    opt = AdamW(1e-4, parameters=params, multi_precision=True)
    rng = np.random.RandomState(seed + 9)
    src, tgt = (torch.from_numpy(rng.randint(0, V, (B, S))).to(device)
                for _ in range(2))
    causal = model.generate_square_subsequent_mask(S - 1)

    def logits_of(dec_out):
        return matmul(dec_out, emb.weight, transpose_y=True)

    t0 = time.perf_counter()
    losses = []
    for _ in range(2):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            out = model(emb(src), emb(tgt[:, :-1]), None, causal)
            loss = F.cross_entropy(logits_of(out).reshape(-1, V),
                                   tgt[:, 1:].reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.float().item())
    _sync(torch, device)
    say(f"{tag} nn.Transformer() pre-norm (d {model.d_model}, "
        f"{model.nhead} heads, 6 + 6 layers, FFN 2048, dropout 0.1) under "
        f"O2, batch {B} x {S}: losses {losses} (warm-up, step) in "
        f"{time.perf_counter() - t0:.2f} s")
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    del opt
    model.eval()
    n = cfg["tf_new"]
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        memory = model.encoder(emb(src))
        cache = model.decoder.gen_cache(memory)
        toks = tgt[:, :1]
        step_in = toks
        for _ in range(n):
            h, cache = model.decoder(emb(step_in), memory, None, None, cache)
            step_in = logits_of(h[:, -1:]).argmax(-1)
            toks = torch.cat([toks, step_in], 1)

        def reforward(seq):
            mask = model.generate_square_subsequent_mask(seq.shape[1])
            return logits_of(model.decoder(emb(seq), memory, mask))
        steps_, first, ok = _greedy_vs_reforward(torch, reforward, toks, 1)
    say(f"{tag} nn.Transformer O2 incremental greedy decode through "
        f"gen_cache ({n} tokens, batch {B}): equal to full causal "
        f"re-forwards up to each row's first near-tie: {ok}, first "
        f"near-ties {first}")
    require(ok, "the gen_cache decode departs from the re-forwards")
    del model, emb, memory, cache
    _free(torch, device)

    # MoELayer: routing on the card vs the CPU, O2 vs float32
    N, d, E, k = cfg["moe_tokens"], cfg["moe_d"], 8, 2
    layer = MoELayer(d, num_expert=E, d_hidden=cfg["moe_hidden"], top_k=k,
                     device=device,
                     generator=torch.Generator().manual_seed(seed + 10))
    ref = MoELayer(d, num_expert=E, d_hidden=cfg["moe_hidden"], top_k=k,
                   device=device)
    ref.load_state_dict(layer.state_dict())
    amp.decorate(layer, level="O2", dtype="bfloat16")
    with torch.no_grad():
        # the float32 reference holds the bf16 weights exactly
        for p, q in zip(ref.parameters(), layer.parameters()):
            p.copy_(q.float())
    gx = torch.Generator().manual_seed(seed + 11)
    x = torch.randn(N, d, generator=gx).to(device)
    proj = torch.randn(N, d, generator=gx).to(device)
    cap = max(int(layer.capacity_factor * N * k / E), k)
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        lg = layer.gate(x)[0]
    t0 = time.perf_counter()
    card = list(MoELayer._gshard_routing(lg, k, E, cap))
    host = list(MoELayer._gshard_routing(lg.cpu(), k, E, cap))
    same = all(torch.equal(a.cpu(), b) for c, h in zip(card, host)
               for a, b in list(zip(c, h))[:3])
    vals = max(float((c[3].float().cpu() - h[3].float()).abs().max())
               for c, h in zip(card, host))
    kept = sum(int(c[2].sum()) for c in card)
    say(f"{tag} MoELayer({d}, {E} experts, {cfg['moe_hidden']}, top "
        f"{k}) routing over {N} tokens from the card's bf16 gate logits: "
        f"expert, capacity position and kept flag on the card equal to "
        f"the CPU's: {same}; kept weights differ by {vals:.2e}; "
        f"{kept} of {N * k} slots kept (capacity {cap})")
    require(same, "MoE routing on the card differs from the CPU's")
    require(vals <= 2.0 ** -8, f"kept weights differ by {vals}")
    outs, grads, routes = [], [], []
    for m, amp_on in ((layer, True), (ref, False)):
        xi = x.clone().requires_grad_()
        with amp.auto_cast(enable=amp_on, level="O2", dtype="bfloat16"):
            out = m(xi)
            logits = m.gate.gate(xi)
        (out.float() * proj).sum().add(m.l_aux.float()).backward()
        outs.append(out.detach().float())
        grads.append({"x": xi.grad.float(), **{
            n: p.grad.float() for n, p in m.named_parameters()}})
        routes.append(torch.stack([torch.stack(
            [o.argmax(-1), kp.long()]) for o, _, kp, _ in
            MoELayer._gshard_routing(logits.detach(), k, E, cap)]))
        m.zero_grad(set_to_none=True)
    agree = (routes[0] == routes[1]).all(0).all(0)
    share = float(agree.float().mean())
    err = float((outs[0] - outs[1])[agree].abs().max()) / float(
        outs[1][agree].abs().max())
    worst, worst_cos, noise = _grads_agree(torch, grads[0], grads[1])
    say(f"{tag} MoELayer O2 vs float32 on the card: {share:.4f} of tokens "
        f"routed alike (bf16 gate logits move near-ties); output on them "
        f"within {err:.3e} x max|ref| (bound {BOUND_AMP_OUT}); gradients "
        f"worst cosine {worst_cos:.5f} (bound {BOUND_AMP_COS}; "
        f"{len(noise)} noise-level tensors); {time.perf_counter() - t0:.2f}"
        f" s")
    require(share >= 0.95, f"only {share} of tokens routed alike")
    require(err <= BOUND_AMP_OUT, f"MoE O2 output off by {err}")
    require(worst_cos >= BOUND_AMP_COS, "MoE O2 gradients disagree")
    del layer, ref, outs, grads
    _free(torch, device)


def phase_amp(torch, device, cfg, seed, fp32, tag, say):
    """Phase 23, legs a-d (see the module docstring)."""
    t0 = time.perf_counter()
    phase_amp_bert(torch, device, cfg, seed, fp32, tag, say)
    phase_amp_bert_paths(torch, device, cfg, seed, tag, say)
    phase_amp_llama(torch, device, cfg, seed, tag, say)
    phase_amp_gpt(torch, device, cfg, seed, tag, say)
    phase_amp_transformer_moe(torch, device, cfg, seed, tag, say)
    say(f"{tag} phase 23 (the nn training surface under AMP): "
        f"{time.perf_counter() - t0:.1f} s")


# -- phase 24: the training flagship on a mesh of logical ranks ------------

# the legs: mesh, layers, the trainer's options; each against the
# one-device trainer from the same seed in the same call
MESH_LEGS = {
    "a": (dict(dp=2, pp=2, mp=2), 2, dict(n_micro=4, remat=True)),
    "b": (dict(pp=2, sharding=2, sep=2), 2, dict(n_micro=4, remat=True)),
    "c": (dict(pp=2), 4, dict(n_micro=4, remat=True, n_virtual=2,
                              remat_stage=True)),
}
MESH_STEPS = 3


def _leg_cfg(cfg, layers):
    import dataclasses
    return dataclasses.replace(_train_cfg(cfg), num_hidden_layers=layers)


def _logical(tr, tree):
    """Global block leaves in the logical [1, L, ...] layout (a staged
    [pp, v, lps, ...] leaf is chunk-major per stage)."""
    out = {}
    for path, a in tree.items():
        if path[0] == "blocks":
            if tr._staged():
                a = a.transpose(0, 1)
            a = a.reshape((1, -1) + tuple(a.shape[2 + tr._staged():]))
        out[path] = a
    return out


def mesh_expected(deg, L, n_micro, T, hd, remat, remat_stage=False,
                  n_virtual=1, fused=True, ce_remat=True):
    """Per-step kernel launches and collective calls of the mesh trainer,
    from the schedule: a rank runs each of its stage's L / pp layers on
    each of its n_micro micro-batches (the whole local batch at pp 1);
    remat (or remat_stage) runs each block's forward again in the
    backward; the cross entropy runs nC chunks of at most 256 positions
    per rank (each a checkpoint) plus the final position's dummy chunk on
    the last sep rank."""
    from paddle_tpu_torch.parallel.pipeline import schedule
    D, P, S, Q, M = (deg.get(a, 1) for a in
                     ("dp", "pp", "sharding", "sep", "mp"))
    nm = n_micro if P > 1 else 1
    f = 2 if (remat or (remat_stage and P > 1)) else 1
    execs = D * S * Q * M * L * nm
    Tl = T // Q
    flash = fused and Q == 1 and hd % 64 == 0 and Tl % 128 == 0
    ranks = D * P * S * Q * M
    launches = {"flash_attention_fwd": f * execs if flash else 0,
                "flash_attention_bwd": execs if flash else 0,
                "fused_rms_norm": 2 * f * execs if fused else 0,
                "fused_adamw": (9 * ranks + 3 * D * S * Q * M)
                if fused else 0}
    C = min(256, Tl)
    while Tl % C:
        C //= 2
    nC = Tl // C
    ar = 0
    if M > 1:
        groups = D * S * Q
        # psum after wo and after wd, forward and backward; a replay
        # stops after the last tensor the backward needs (torch's
        # non-reentrant checkpoint), before the region's last psum: a
        # block's replay runs 1 of its 2, a stage's 2 lps - 1
        ar += groups * L * nm * 4
        if remat_stage and P > 1:
            lps = L // (P * n_virtual)
            ar += groups * P * n_virtual * nm * (2 * lps - 1)
        elif remat:
            ar += groups * L * nm
        ar += groups * 2                          # the embedding's psum
        # the CE's max (no backward) and two psums a chunk, again when
        # the chunk is recomputed; the dummy chunk on the last sep rank
        per = (nC * (3 * (2 if ce_remat else 1) + 2) if nC > 1 else 5)
        ar += groups * per + (D * S * 5 if nC > 1 else 0)
    if D * S * Q * M > 1:
        ar += 2                                   # the loss's psum
    # the gradients: a reduce-scatter (sharding > 1: every leaf at these
    # widths has a dim sharding divides) or all-reduce per shard group
    # of more than one replica; then an all-gather per sharding line
    red = 0
    for size, n_groups in ((D * S * Q, 7 * P * M), (D * S * Q * M, 2 * P),
                           (D * S * Q, 2 * M), (D * S * Q * M, 1)):
        red += n_groups if size > 1 else 0
    gather = 0
    if S > 1:
        gather = 9 * D * P * Q * M + 3 * D * Q * M
    sched = schedule(P, nm, n_virtual) if P > 1 else []
    send_ticks = sum(1 for t in sched if any(not sl.emit for sl in t))
    pp = 2 * D * S * Q * M * send_ticks
    ring = D * S * M * L * nm * 2 * (Q - 1) * (f + 1)
    coll = {"all_reduce": ar + (red if S == 1 else 0),
            "reduce_scatter": red if S > 1 else 0,
            "all_gather": gather, "ppermute": pp + ring}
    return launches, coll


def _opt_bytes_by_rank(tr):
    """m / v / master bytes per sharding rank (summed over the ranks
    of that sharding coordinate)."""
    from paddle_tpu_torch.models.llama_spmd import tree_get, tree_paths
    out = {}
    for path in tree_paths(tr.params):
        for k, v in tree_get(tr.opt_state, path).items():
            for c, t in tr._shards(v).items():
                key = (c[2], k)
                out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


def _compare_trainers(torch, ref, got, tag, say, what):
    """(loss relative error, worst gradient error over max|ref|, worst
    cosine) of two (loss, {path: grad}) results; failing the run past
    phase 14's BOUND_TRAIN_*."""
    dl = abs(got[0].item() - ref[0].item()) / abs(ref[0].item())
    worst, worst_cos = 0.0, 1.0
    for path, g in ref[1].items():
        h = got[1][path].to(g.device)
        worst = max(worst, _rel_err(h, g))
        worst_cos = min(worst_cos, float(_cosine(torch, h, g)))
    say(f"{tag}   {what}: loss {got[0].item():.6f} vs {ref[0].item():.6f} "
        f"({dl:.2e} relative, bound {BOUND_TRAIN_LOSS}), gradients worst "
        f"{worst:.3e} x max|ref| (bound {BOUND_TRAIN_GRAD}), worst cosine "
        f"{worst_cos:.6f} (bound {BOUND_TRAIN_COS})")
    require(dl <= BOUND_TRAIN_LOSS, f"{what}: losses differ by {dl}")
    require(worst <= BOUND_TRAIN_GRAD and worst_cos >= BOUND_TRAIN_COS,
            f"{what}: gradients disagree")


def _masters(tr):
    from paddle_tpu_torch.models.llama_spmd import tree_get, tree_paths
    return {p: tr.assemble(p, tree_get(tr.opt_state, p)["master"],
                           owned=True) for p in tree_paths(tr.params)}


def _compare_masters(ref, got, lr, tag, say, what):
    """After one step from equal weights: phase 14's bound (the first
    AdamW step moves an entry by +-lr whatever the gradient's size)."""
    bound = 2 * lr + 1e-6
    dm = max(float((got[p].to(m.device) - m).abs().max())
             for p, m in ref.items())
    say(f"{tag}   {what}: masters after one step differ by {dm:.3e} "
        f"(bound {bound:.3e})")
    require(dm <= bound, f"{what}: masters after one step disagree")


def _timed_train(torch, device, tr, ids, steps):
    """(seconds per step, launches, collectives) of ``steps`` steps."""
    from paddle_tpu_torch.parallel import collective
    _sync(torch, device)
    _reset_train_counts()
    collective.reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = tr.train_step(ids)
    _sync(torch, device)
    wall = (time.perf_counter() - t0) / steps
    require(np.isfinite(float(loss)), "non-finite loss")
    coll = {k: v["calls"] for k, v in collective.counts().items()}
    return wall, _train_counts(), coll


def _one_device(torch, device, tc, seed, ids, steps, **kw):
    """The one-device trainer's loss and gradients at the weights from
    ``seed``, its masters after one step, and its s/step."""
    from paddle_tpu_torch.models import LlamaSpmdTrainer
    one = LlamaSpmdTrainer(tc, compute_dtype=torch.bfloat16, seed=seed,
                           device=device, **kw)
    ref = one.grads(ids)
    one.train_step(ids)
    masters = _masters(one)
    s_step, _, _ = _timed_train(torch, device, one, ids, steps)
    lr = one.lr
    del one
    _free(torch, device)
    return ref, masters, s_step, lr


def phase_mesh(torch, device, cfg, seed, tag, say):
    """Phase 24: the trainer on meshes of logical ranks on one device, at
    bench.py's proxy widths, batch 16 x 2048, bf16, fp32 moments."""
    from paddle_tpu_torch.models import LlamaSpmdTrainer
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    t_phase = time.perf_counter()
    B, T = cfg["train_batch"], cfg["train_seq"]
    hd = cfg["train_hidden"] // cfg["train_heads"]
    ids = np.random.RandomState(seed + 7).randint(0, cfg["train_vocab"],
                                                  (B, T))
    fused = device.type == "cuda"
    steps = MESH_STEPS
    for leg, (deg, L, kw) in MESH_LEGS.items():
        tc = _leg_cfg(cfg, L)
        ref, masters, one_s, lr = _one_device(
            torch, device, tc, seed, ids, steps, remat=kw["remat"])
        n = int(np.prod(list(deg.values())))
        mesh_mod.build_mesh(**deg, devices=[device] * n)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        tr = LlamaSpmdTrainer(tc, compute_dtype=torch.bfloat16, seed=seed,
                              **kw)
        require(tr._fused == fused, "the ranks' kernels are not the CUDA "
                "path")
        name = f"leg ({leg}) {deg}, {L} layers, {kw}"
        loss, grads = tr.grads(ids)
        _compare_trainers(torch, ref, (loss, _logical(tr, grads)), tag, say,
                          f"{name} vs one device")
        del ref, grads
        tr.train_step(ids)                                 # the warm-up
        _compare_masters(masters, _logical(tr, _masters(tr)), lr, tag, say,
                         name)
        del masters
        s_step, launches, coll = _timed_train(torch, device, tr, ids, steps)
        peak = _peak_mib(torch, device)
        fpt = tr.flops_per_token(T)
        tok_s = B * T / s_step
        by_rank = _opt_bytes_by_rank(tr)
        want_l, want_c = mesh_expected(
            deg, L, kw["n_micro"], T, hd, kw["remat"],
            kw.get("remat_stage", False), kw.get("n_virtual", 1), fused)
        say(f"{tag} mesh {name}: {s_step:.4f} s per step ({steps} after a "
            f"warm-up), {tok_s:.1f} tokens/s, MFU "
            f"{fpt * tok_s / BF16_FLOP_S:.4f} ({fpt} FLOP/token over "
            f"{BF16_FLOP_S:.3g}); the one-device trainer {one_s:.4f} s per "
            f"step in this call ({s_step / one_s:.2f}x); peak memory "
            f"{peak:.1f} MiB; m / v / master bytes per sharding rank "
            + ", ".join(f"s{s} {k} {b}" for (s, k), b in sorted(
                by_rank.items()))
            + f"; pipeline {tr.pipeline_stats}; launches {launches} "
            f"(expected {steps} x {want_l}); collectives {coll} (expected "
            f"{steps} x {want_c})")
        require(coll == {k: steps * v for k, v in want_c.items()},
                f"leg ({leg}) collectives {coll} are not {steps} x {want_c}")
        if device.type == "cuda":
            require(launches == {k: steps * v for k, v in want_l.items()},
                    f"leg ({leg}) launches {launches} are not {steps} x "
                    f"{want_l}")
            if leg in ("a", "b"):
                # how much of the step the logical-rank glue leaves idle
                _profile_step(torch, lambda: tr.train_step(ids), tag, say,
                              f"leg ({leg}) step", {
                                  "flash attention": ("flash_",),
                                  "GEMMs (cuBLAS)": ("nvjet", "gemm", "xmma",
                                                     "cutlass", "sm90_"),
                                  "RMSNorm kernel": ("rms_kernel",),
                                  "AdamW kernel": ("adamw_kernel",)})
        del tr
        mesh_mod.set_mesh(None)
        _free(torch, device)
    # (d) the remat policies on one device
    tc = _leg_cfg(cfg, 2)
    res, peaks = {}, {}
    for pol in ("full", "save_attn", "save_dots"):
        tr = LlamaSpmdTrainer(tc, compute_dtype=torch.bfloat16, seed=seed,
                              device=device, remat_policy=pol)
        res[pol] = tr.grads(ids)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        tr.train_step(ids)
        peaks[pol] = _peak_mib(torch, device)
        s_step, launches, _ = _timed_train(torch, device, tr, ids, steps)
        want_l, _ = mesh_expected({}, 2, 1, T, hd, True, fused=fused)
        say(f"{tag} leg (d) one device, remat_policy {pol!r}: {s_step:.4f} "
            f"s per step, {B * T / s_step:.1f} tokens/s, peak memory of a "
            f"step {peaks[pol]:.1f} MiB; launches {launches} (expected "
            f"{steps} x {want_l})")
        if device.type == "cuda":
            require(launches == {k: steps * v for k, v in want_l.items()},
                    f"leg (d) {pol} launches {launches}")
        if pol != "full":
            _compare_trainers(torch, res["full"], res[pol], tag, say,
                              f"leg (d) {pol} vs full")
            res[pol] = None
        del tr
        _free(torch, device)
    if device.type == "cuda":
        require(peaks["full"] < peaks["save_attn"] < peaks["save_dots"],
                f"peak memory not ordered full < save_attn < save_dots: "
                f"{peaks}")
    say(f"{tag} phase 24 took {time.perf_counter() - t_phase:.1f} s")


def fleet_mp_expected(kind, L, mp, tokens, hidden, vocab, itemsize):
    """{kind: (calls, bytes)} of the collectives of one training step of
    a causal LM under ``fleet.init(mp_degree=mp)`` (the Megatron
    pairing; none at mp 1). Llama: per layer the forward all-reduces
    the o and down Row outputs and the backward the q/k/v/gate/up
    Column inputs' gradients (``_c_identity``); the embedding's forward
    and the head's backward add one each; the head gathers its vocab
    chunks once. GPT: per layer proj and fc_out forward, qkv and fc_in
    backward, plus the embedding; its tied head is a plain product. A
    call hands mp tensors of [tokens, hidden] (the gather's: [tokens,
    vocab / mp]) of ``itemsize`` bytes."""
    out = {k: (0, 0) for k in ("all_reduce", "ppermute", "reduce_scatter",
                               "all_gather")}
    if mp == 1:
        return out
    ar = 7 * L + 2 if kind == "llama" else 4 * L + 1
    out["all_reduce"] = (ar, ar * mp * tokens * hidden * itemsize)
    if kind == "llama":
        out["all_gather"] = (1, tokens * vocab * itemsize)
    return out


def _coll_step():
    from paddle_tpu_torch.parallel import collective
    return {k: (v["calls"], v["bytes"])
            for k, v in collective.counts().items()}


def _fleet_init(torch, device, mp):
    """``fleet.init`` with ``mp_degree`` mp, every rank on ``device``;
    mp 1 uninstalls the topology (the plain layers)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.topology import \
        set_hybrid_communicate_group
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    set_hybrid_communicate_group(None)
    mesh_mod.set_mesh(None)
    if mp > 1:
        s = fleet.DistributedStrategy()
        s.hybrid_configs["mp_degree"] = mp
        s.tensor_parallel_configs["tensor_init_seed"] = 2024
        fleet.init(is_collective=True, strategy=s, device=device)


def _mp_leg(torch, device, kind, mp, build, ids, steps, want_l, ref, tag,
            say, profile=False):
    """One model of phase 25 at ``mp``: (loss, grads) of one step from
    the weights ``ref["state"]`` (the generator reseeded), then 1
    warm-up and ``steps`` timed AdamW steps; the launches and the
    collectives of every step checked. Returns (s/step, peak MiB,
    the step's collectives)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import collective
    _fleet_init(torch, device, mp)
    model = build()
    if ref.get("state") is None:
        ref["state"] = {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
    else:
        model.load_state_dict(ref["state"])
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(1e-4, parameters=model.parameters(), multi_precision=True)
    x = torch.from_numpy(ids).to(device)
    gen = getattr(model, "generator", None)

    def step():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss, _ = model(x, labels=x)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if kind == "gpt":
        model.gpt.drop.generator.manual_seed(ref["dropout_seed"])
    collective.reset_counts()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        loss, _ = model(x, labels=x)
    loss.backward()
    coll = _coll_step()
    got = (loss.float().item(), {n: p.grad.detach().float().clone()
                                 for n, p in model.named_parameters()})
    opt.clear_grad()
    del loss
    B, T = ids.shape
    H = model.config.hidden_size
    want_c = fleet_mp_expected(kind, model.config.num_hidden_layers, mp,
                               B * T, H, model.config.vocab_size, 2)
    name = f"{kind} mp {mp}"
    require(coll == want_c, f"{name}: collectives {coll} are not {want_c}")
    if "grads" not in ref:
        ref["loss"], ref["grads"] = got
    else:
        worst, worst_cos, noise = _grads_agree(torch, got[1], ref["grads"])
        dl = abs(got[0] - ref["loss"]) / abs(ref["loss"])
        say(f"{tag}   {name} vs mp 1: loss {got[0]:.5f} vs "
            f"{ref['loss']:.5f} ({dl:.2e} relative, bound "
            f"{BOUND_AMP_LOSS}); gradients worst {worst:.3e} x max|g|, "
            f"worst cosine {worst_cos:.6f} (bound {BOUND_AMP_COS}; "
            f"{len(noise)} noise-level tensors)")
        require(dl <= BOUND_AMP_LOSS and worst_cos >= BOUND_AMP_COS,
                f"{name}: loss or gradients disagree with mp 1")
    del got
    step()                                          # the warm-up
    _sync(torch, device)
    _reset_train_counts()
    collective.reset_counts()
    t0 = time.perf_counter()
    losses = [float(step()) for _ in range(steps)]
    _sync(torch, device)
    s_step = (time.perf_counter() - t0) / steps
    launches = _amp_counts()
    coll_t = _coll_step()
    peak = _peak_mib(torch, device)
    require(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    require(coll_t == {k: (steps * c, steps * b) for k, (c, b) in
                       want_c.items()},
            f"{name}: {steps} steps' collectives {coll_t}")
    if device.type == "cuda":
        require({k: launches[k] for k in want_l} ==
                {k: steps * v for k, v in want_l.items()},
                f"{name}: launches {launches} are not {steps} x {want_l}")
        if profile:
            _profile_step(torch, step, tag, say, f"{name} O2 step", {
                "flash attention": ("flash_",),
                "GEMMs (cuBLAS)": ("nvjet", "gemm", "xmma", "cutlass",
                                   "sm90_"),
                "RMSNorm kernel": ("rms_kernel",),
                "dropout kernel": ("dropout_kernel",),
                "casts (copy kernels)": ("copy",)})
    say(f"{tag} {name}: {s_step:.4f} s per step ({steps} after a warm-up), "
        f"{ids.size / s_step:.1f} tokens/s, peak memory {peak:.1f} MiB; "
        f"losses {[round(v, 4) for v in losses]}; launches {launches} "
        f"(expected {steps} x {want_l}); collectives a step "
        f"{ {k: v for k, v in want_c.items() if v[0]} } "
        f"(calls, bytes; met)")
    del model, opt
    _fleet_init(torch, device, 1)
    _free(torch, device)
    return s_step, peak, want_c


def _mp_layers_alone(torch, device, cfg, seed, tag, say):
    """Phase 25 (c): the four mpu layers at mp 2 against their plain
    layers, float32, forward and backward."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.parallel import collective
    H, F_, V = cfg["train_hidden"], cfg["train_ffn"], cfg["train_vocab"]
    rows = cfg["mp_rows"]
    g = torch.Generator(device).manual_seed(seed + 25)
    ids = torch.randint(0, V, (rows,), generator=g, device=device)
    x = torch.randn(rows, H, generator=g, device=device)
    dy = torch.randn(rows, F_, generator=g, device=device)
    _fleet_init(torch, device, 2)
    try:
        layers = (mpl.VocabParallelEmbedding(V, H, generator=g),
                  mpl.ColumnParallelLinear(H, F_, has_bias=False,
                                           gather_output=True, generator=g),
                  mpl.RowParallelLinear(F_, H, has_bias=False,
                                        input_is_parallel=True,
                                        generator=g))
        emb, col, row = layers
        logits = torch.randn(rows, V, generator=g, device=device)
        collective.reset_counts()
        errs = {}
        # the embedding: exactly the lookup; its gradient
        out = emb(ids)
        errs["VocabParallelEmbedding forward (exact)"] = float(
            (out.detach() - emb.weight.detach()[ids]).abs().max())
        require(torch.equal(out, emb.weight.detach()[ids]),
                "VocabParallelEmbedding differs from the lookup")
        dh = torch.randn(rows, H, generator=g, device=device)
        out.backward(dh)
        w = emb.weight.detach().clone().requires_grad_(True)
        F.embedding(ids, w).backward(dh)
        errs["VocabParallelEmbedding weight grad"] = _rel_err(
            emb.weight.grad, w.grad)
        # Column: the gathered output and both gradients
        xc = x.clone().requires_grad_(True)
        yc = col(xc)
        xr, wr = x.clone().requires_grad_(True), \
            col.weight.detach().clone().requires_grad_(True)
        yr = xr @ wr
        errs["ColumnParallelLinear forward"] = _rel_err(yc.detach(),
                                                        yr.detach())
        yc.backward(dy)
        yr.backward(dy)
        errs["ColumnParallelLinear input grad"] = _rel_err(xc.grad, xr.grad)
        errs["ColumnParallelLinear weight grad"] = _rel_err(col.weight.grad,
                                                            wr.grad)
        # Row on the parallel input
        hin = torch.randn(rows, F_, generator=g, device=device)
        hc = hin.clone().requires_grad_(True)
        zc = row(hc)
        hr, wr = hin.clone().requires_grad_(True), \
            row.weight.detach().clone().requires_grad_(True)
        zr = hr @ wr
        errs["RowParallelLinear forward"] = _rel_err(zc.detach(),
                                                     zr.detach())
        zc.backward(dh)
        zr.backward(dh)
        errs["RowParallelLinear input grad"] = _rel_err(hc.grad, hr.grad)
        errs["RowParallelLinear weight grad"] = _rel_err(row.weight.grad,
                                                         wr.grad)
        # the cross entropy on vocab-parallel logits
        lc = logits.clone().requires_grad_(True)
        loss = mpl.ParallelCrossEntropy()(lc, ids)
        lr_ = logits.clone().requires_grad_(True)
        ref = torch.nn.functional.cross_entropy(lr_, ids, reduction="none")
        errs["ParallelCrossEntropy forward"] = _rel_err(loss[:, 0].detach(),
                                                        ref.detach())
        loss.sum().backward()
        ref.sum().backward()
        errs["ParallelCrossEntropy logits grad"] = _rel_err(lc.grad,
                                                            lr_.grad)
        coll = {k: v["calls"] for k, v in collective.counts().items()}
    finally:
        _fleet_init(torch, device, 1)
    _sync(torch, device)
    worst = max(v for k, v in errs.items() if "exact" not in k)
    say(f"{tag} leg (c) the mpu layers at mp 2, float32, TF32 off, "
        f"{rows} rows at H {H}, FFN {F_}, vocab {V}: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (x max|ref|, bound {BOUND_MP_F32}); collectives {coll}")
    require(worst <= BOUND_MP_F32, f"an mpu layer is off by {worst} x "
            f"max|ref| (bound {BOUND_MP_F32})")
    # the embedding's forward; Column's gather and its input gradient's
    # all-reduce; Row's forward; the cross entropy's three
    require(coll == {"all_reduce": 1 + 1 + 1 + 3, "all_gather": 1,
                     "ppermute": 0, "reduce_scatter": 0},
            f"leg (c) collectives {coll}")
    _free(torch, device)


def phase_fleet_mp(torch, device, cfg, seed, tag, say):
    """Phase 25: ``fleet.init(mp_degree=...)`` on logical mp ranks of the
    one device: Llama (phase 23b's widths) at mp 2 and 4, GPT (phase
    23c's) at mp 2, each against its mp 1 twin; the mpu layers alone."""
    from paddle_tpu_torch.models import GPTForCausalLM, LlamaForCausalLM
    t_phase = time.perf_counter()
    steps = 3
    # (a) Llama: the weights drawn on the device (Llama has no dropout)
    tc = _train_cfg(cfg)
    L = tc.num_hidden_layers
    B, T = cfg["train_batch"], cfg["train_seq"]
    ids = np.random.RandomState(seed + 2).randint(0, tc.vocab_size, (B, T))
    want_l = {"flash_attention_fwd": L, "flash_attention_bwd": L,
              "fused_rms_norm": 2 * L + 1}

    def llama():
        return LlamaForCausalLM(tc, device=device, generator=torch.Generator(
            device).manual_seed(seed))
    ref = {}
    res = {mp: _mp_leg(torch, device, "llama", mp, llama, ids, steps,
                       want_l, ref, tag, say, profile=(mp == 2))
           for mp in (1, 2, 4)}
    del ref
    say(f"{tag} leg (a) Llama O2 s/step at mp 1 / 2 / 4: "
        + " / ".join(f"{res[mp][0]:.4f}" for mp in (1, 2, 4))
        + f" ({res[2][0] / res[1][0]:.3f}x, {res[4][0] / res[1][0]:.3f}x "
        f"mp 1's), peak MiB " + " / ".join(f"{res[mp][1]:.1f}"
                                           for mp in (1, 2, 4)))
    # (b) GPT: CPU generators (they also seed the dropout)
    gc_ = _gpt_cfg(cfg, False)
    Lg = gc_.num_hidden_layers
    ids = np.random.RandomState(seed + 7).randint(
        0, gc_.vocab_size, (cfg["gpt_batch"], cfg["gpt_seq"]))
    want_g = {"flash_attention_fwd": Lg, "flash_attention_bwd": Lg,
              "fused_dropout": 2 + 4 * Lg}

    def gpt():
        return GPTForCausalLM(gc_, device=device,
                              generator=torch.Generator().manual_seed(seed))
    ref = {"dropout_seed": seed + 11}
    resg = {mp: _mp_leg(torch, device, "gpt", mp, gpt, ids, steps, want_g,
                        ref, tag, say) for mp in (1, 2)}
    del ref
    say(f"{tag} leg (b) GPT O2 s/step at mp 1 / 2: {resg[1][0]:.4f} / "
        f"{resg[2][0]:.4f} ({resg[2][0] / resg[1][0]:.3f}x), peak MiB "
        f"{resg[1][1]:.1f} / {resg[2][1]:.1f}")
    _mp_layers_alone(torch, device, cfg, seed, tag, say)
    say(f"{tag} phase 25 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 26: the rest of fleet's hybrid training on logical ranks -------

def fleet_hybrid_expected(leaves, n):
    """{kind: (calls, bytes)} of the collectives of one ZeRO training
    step at ``n`` sharding ranks over the parameters ``leaves`` [(shape,
    itemsize)]: stage 1 all-gathers each parameter with a dimension that
    divides by n after its update, stage 3 at the first forward after a
    step; either way one ``all_gather`` per such parameter, handed its n
    chunks (the parameter's bytes). Nothing else moves: the pipeline's
    micro-batches run on one controller, and the gradients are the
    global batch's (no p2p, no reduction)."""
    out = {k: (0, 0) for k in ("all_reduce", "ppermute", "reduce_scatter",
                               "all_gather")}
    if n <= 1:
        return out
    div = [int(np.prod(s)) * b for s, b in leaves
           if any(d % n == 0 and d >= n for d in s)]
    out["all_gather"] = (len(div), sum(div))
    return out


def zero_bytes_expected(leaves, n, n_states):
    """Bytes of optimizer state each of ``n`` sharding ranks holds:
    ``n_states`` float32 tensors (moments and master) per parameter of
    ``leaves`` [shape], a 1 / n share where a dimension divides by n,
    whole otherwise."""
    total = 0
    for s in leaves:
        numel = int(np.prod(s)) * 4 * n_states
        total += numel // n if any(d % n == 0 and d >= n for d in s) \
            else numel
    return total


def moe_ep_expected(E, cap, d, ep, k, itemsize):
    """{kind: (calls, bytes)} of one MoELayer forward and backward at
    ``ep`` expert-parallel ranks: one all-gather of every rank's [E]
    int32 counts a top-k slot; the dispatch and the combine all-to-alls
    of [E, cap, d] blocks a rank, and their adjoints in the backward."""
    out = {k_: (0, 0) for k_ in ("all_reduce", "ppermute", "reduce_scatter",
                                 "all_gather")}
    if ep <= 1:
        return out
    out["all_gather"] = (k, k * ep * E * 4)
    out["all_to_all"] = (4, 4 * ep * E * cap * d * itemsize)
    return out


def _hybrid_init(torch, device, **degrees):
    """``fleet.init`` with ``degrees`` (pp_degree, sharding_degree, ...),
    every rank on ``device``; no degrees uninstalls the topology."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.topology import \
        set_hybrid_communicate_group
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    set_hybrid_communicate_group(None)
    mesh_mod.set_mesh(None)
    if degrees:
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update(degrees)
        s.pipeline_configs["accumulate_steps"] = 4
        fleet.init(is_collective=True, strategy=s, device=device)
        return s
    return None


def _llama_pipe(torch, device, tc, seed, loss_fn):
    """A PipelineLayer of LayerDescs with LlamaForCausalLM's modules:
    embedding, the decoder layers, the final RMSNorm, the head; and the
    map from its state-dict keys to LlamaForCausalLM's."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer
    g = torch.Generator(device).manual_seed(seed + 40)
    kw = dict(device=device, generator=g)
    L, H, V = tc.num_hidden_layers, tc.hidden_size, tc.vocab_size
    descs = ([LayerDesc(nn.Embedding, V, H, **kw)]
             + [LayerDesc(LlamaDecoderLayer, tc, **kw) for _ in range(L)]
             + [LayerDesc(nn.RMSNorm, H, tc.rms_norm_eps, device=device),
                LayerDesc(nn.Linear, H, V, bias_attr=False, **kw)])
    pipe = PipelineLayer(descs, loss_fn=loss_fn)
    keys = {"run_function.0.weight": "llama.embed_tokens.weight",
            f"run_function.{L + 1}.weight": "llama.norm.weight",
            f"run_function.{L + 2}.weight": "lm_head.weight"}
    for k in pipe.state_dict():
        if k.startswith("run_function.") and k not in keys:
            i, rest = k[len("run_function."):].split(".", 1)
            keys[k] = f"llama.layers.{int(i) - 1}.{rest}"
    return pipe, keys


def _opt_masters(opt, model, keys=None):
    """{name: copy of the fp32 master} of ``model``'s parameters (names
    mapped by ``keys``): a sharding optimizer's gathered (global view),
    a plain one's as held."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        DygraphShardingOptimizer
    sh = getattr(opt, "_sharding", None) or (
        opt if isinstance(opt, DygraphShardingOptimizer) else None)
    out = {}
    for n, p in model.named_parameters():
        if sh is not None:
            leaf = sh._leaves[p]
            v = sh._full(leaf, leaf.master)
        else:
            v = opt._master_weights[p].detach().clone()
        out[keys.get(n, n) if keys else n] = v
    return out


def _masters_agree(torch, got, ref):
    """(worst max-error over max|ref|, worst cosine of the updates
    against the starting weights ``ref["__start"]``)."""
    worst, worst_cos = 0.0, 1.0
    for n, r in ref.items():
        if n == "__start":
            continue
        worst = max(worst, _rel_err(got[n], r))
        d0, d1 = got[n] - ref["__start"][n], r - ref["__start"][n]
        if float(d1.abs().max()) > 0:
            worst_cos = min(worst_cos, float(_cosine(torch, d0, d1)))
    return worst, worst_cos


class _GradCapture:
    """An optimizer stand-in for ``train_batch``: ``step`` first copies
    every gradient (float32, names mapped by ``keys``), then steps."""

    def __init__(self, opt, model, keys):
        self.opt, self.model, self.keys, self.grads = opt, model, keys, None

    def step(self):
        self.grads = {self.keys.get(n, n): p.grad.detach().float().clone()
                      for n, p in self.model.named_parameters()}
        self.opt.step()

    def clear_grad(self):
        self.opt.clear_grad()


def _twin_step(torch, model, opt, ids, n_micro, capture=True):
    """``n_micro`` micro-batches of ``ids`` by hand, each loss scaled by
    1 / n_micro (the pipeline's accumulation), then one step: (mean loss,
    {name: float32 gradient} or None)."""
    from paddle_tpu_torch import amp
    total = None
    for x in ids.chunk(n_micro, 0):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            loss, _ = model(x, labels=x)
        (loss * (1.0 / n_micro)).backward()
        total = loss.detach().float() if total is None \
            else total + loss.detach().float()
    grads = ({n: p.grad.detach().float().clone()
              for n, p in model.named_parameters()} if capture else None)
    opt.step()
    opt.clear_grad()
    return float(total / n_micro), grads


def _agree(torch, tag, say, what, loss, ref_loss, grads, ref_grads,
           masters=None, ref_masters=None):
    dl = abs(loss - ref_loss) / abs(ref_loss)
    worst, worst_cos, noise = _grads_agree(torch, grads, ref_grads)
    line = (f"{tag}   {what}: loss {loss:.5f} vs {ref_loss:.5f} ({dl:.2e} "
            f"relative, bound {BOUND_AMP_LOSS}); gradients worst "
            f"{worst:.3e} x max|g|, worst cosine {worst_cos:.6f} (bound "
            f"{BOUND_AMP_COS}; {len(noise)} noise-level tensors)")
    ok = dl <= BOUND_AMP_LOSS and worst_cos >= BOUND_AMP_COS
    if masters is not None:
        mw, mc = _masters_agree(torch, masters, ref_masters)
        line += (f"; masters after the step worst {mw:.3e} x max|ref| "
                 f"(bound {BOUND_AMP_LOSS}), their updates' worst cosine "
                 f"{mc:.6f} (bound {BOUND_AMP_COS})")
        ok = ok and mw <= BOUND_AMP_LOSS and mc >= BOUND_AMP_COS
    say(line)
    require(ok, f"{what}: outside the bounds")


def _hybrid_launches(torch, device, L, n_micro, what):
    if device.type != "cuda":
        return
    got = {k: v for k, v in _train_counts().items()}
    want = {"flash_attention_fwd": L * n_micro,
            "flash_attention_bwd": L * n_micro,
            "fused_rms_norm": (2 * L + 1) * n_micro, "fused_adamw": 0}
    require(got == want, f"{what}: launches {got} are not {want}")


def _timed(torch, device, fn, steps):
    fn()                                            # the warm-up
    _sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    _sync(torch, device)
    return (time.perf_counter() - t0) / steps


def _pipeline_leg(torch, device, cfg, seed, tag, say, steps):
    """Phase 26 (a), then (d) on (a)'s model: PipelineParallel over a
    PipelineLayer at pp 2 x sharding 2 against LlamaForCausalLM
    accumulating the same 4 micro-batches by hand."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import collective
    tc = _train_cfg(cfg)
    L, V, n_micro = tc.num_hidden_layers, tc.vocab_size, 4
    B, T = cfg["train_batch"], cfg["train_seq"]
    ids = torch.from_numpy(np.random.RandomState(seed + 2).randint(
        0, V, (B, T))).to(device)
    strategy = _hybrid_init(torch, device, pp_degree=2, sharding_degree=2)

    def loss_fn(logits, labels):
        return F.cross_entropy(logits[:, :-1].reshape(-1, V),
                               labels[:, 1:].reshape(-1))
    twin = LlamaForCausalLM(tc, device=device, generator=torch.Generator(
        device).manual_seed(seed))
    pipe, keys = _llama_pipe(torch, device, tc, seed, loss_fn)
    tsd = twin.state_dict()
    pipe.load_state_dict({k: tsd[keys[k]] for k in pipe.state_dict()})
    amp.decorate([twin, pipe], level="O2", dtype="bfloat16")
    start = {n: p.detach().float().clone() for n, p in
             twin.named_parameters()}
    model = fleet.distributed_model(pipe)
    opt = fleet.distributed_optimizer(
        AdamW(1e-4, parameters=pipe.parameters(), multi_precision=True),
        strategy)
    topt = AdamW(1e-4, parameters=twin.parameters(), multi_precision=True)
    require(type(model).__name__ == "PipelineParallel" and
            type(opt._sharding).__name__ == "DygraphShardingOptimizer",
            f"distributed_model / _optimizer gave {type(model).__name__}")
    t_loss, t_grads = _twin_step(torch, twin, topt, ids, n_micro)
    t_masters = _opt_masters(topt, twin)
    t_masters["__start"] = start
    cap = _GradCapture(opt, pipe, keys)
    _reset_train_counts()
    collective.reset_counts()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        loss = float(model.train_batch([ids, ids], cap))
    coll = _coll_step()
    _hybrid_launches(torch, device, L, n_micro, "(a) train_batch")
    leaves = [(tuple(p.shape), p.element_size()) for p in pipe.parameters()]
    want_c = fleet_hybrid_expected(leaves, 2)
    require(coll == want_c, f"(a) collectives {coll} are not {want_c}")
    say(f"{tag} (a) PipelineParallel (pp 2 x sharding 2, logical ranks; "
        f"PipelineLayer of {len(pipe.run_function)} LayerDescs, "
        f"segment_parts {pipe.segment_parts}, accumulate_steps "
        f"{model.accumulate_steps}) + DygraphShardingOptimizer over "
        f"LlamaForCausalLM's modules at phase 23b's widths, batch {B} x "
        f"{T} under O2: one train_batch against LlamaForCausalLM "
        f"accumulating the same {n_micro} micro-batches by hand; "
        f"collectives {({k: v for k, v in coll.items() if v[0]})} (calls, "
        f"bytes; fleet_hybrid_expected met); launches "
        f"{_train_counts() if device.type == 'cuda' else 'n/a'}")
    _agree(torch, tag, say, "(a) pipeline vs twin", loss, t_loss,
           cap.grads, t_grads, _opt_masters(opt, pipe, keys), t_masters)
    del cap, t_grads, t_masters
    sh = opt._sharding
    per_rank = sh.bytes_per_rank()
    shapes = [s for s, _ in leaves]
    want_b = zero_bytes_expected(shapes, 2, 3)
    full_b = zero_bytes_expected(shapes, 1, 3)
    say(f"{tag} (a) optimizer state bytes per sharding rank {per_rank} "
        f"(moments and masters: {want_b} by _shard_spec, of {full_b} "
        f"unsharded; {sum(1 for s in shapes if any(d % 2 == 0 for d in s))}"
        f" of {len(shapes)} leaves divide)")
    require(per_rank == [want_b, want_b], f"(a) bytes per rank {per_rank}")

    def pipe_step():
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return model.train_batch([ids, ids], opt)

    _reset_train_counts()
    collective.reset_counts()
    s_pipe = _timed(torch, device, pipe_step, steps)
    coll_t = _coll_step()
    require(coll_t == {k: ((steps + 1) * c, (steps + 1) * b)
                       for k, (c, b) in want_c.items()},
            f"(a) {steps + 1} steps' collectives {coll_t}")
    s_twin = _timed(torch, device, lambda: _twin_step(
        torch, twin, topt, ids, n_micro, capture=False), steps)
    say(f"{tag} (a) s/step: PipelineParallel + ZeRO-1 {s_pipe:.4f}, the "
        f"twin {s_twin:.4f} ({s_pipe / s_twin:.3f}x), {steps} steps after "
        f"a warm-up; {B * T / s_pipe:.1f} tokens/s")
    del twin, topt
    _free(torch, device)
    _checkpoint_leg(torch, device, cfg, seed, tag, say, model, opt, pipe,
                    keys, ids, n_micro, loss_fn)
    del model, opt, pipe, sh
    _hybrid_init(torch, device)
    _free(torch, device)
    return s_pipe


def _checkpoint_leg(torch, device, cfg, seed, tag, say, model, opt, pipe,
                    keys, ids, n_micro, loss_fn):
    """Phase 26 (d): (a)'s model saved by distributed.checkpoint, loaded
    into an mp 2 and a one-device LlamaForCausalLM; a further step of
    each of (a)'s model and the restored one; PPParallelAdaptor."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    tc = _train_cfg(cfg)
    state = {keys[k]: v for k, v in pipe.state_dict().items()}
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        ckpt.save_state_dict(state, path)
        t_save = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, "state.pdparams"))
        loaded = {}
        for mp in (2, 1):
            _fleet_init(torch, device, mp)
            m = LlamaForCausalLM(tc, device=device, generator=torch.Generator(
                device).manual_seed(seed + 50 + mp))
            amp.decorate(m, level="O2", dtype="bfloat16")
            t0 = time.perf_counter()
            ckpt.load_state_dict(path, target_state_dict=m.state_dict())
            _sync(torch, device)
            t_load = time.perf_counter() - t0
            same = all(torch.equal(v, state[k])
                       for k, v in m.state_dict().items())
            say(f"{tag} (d) distributed.checkpoint: {len(state)} tensors, "
                f"{nbytes} bytes saved in {t_save:.2f} s; loaded into the "
                f"{'mp 2' if mp == 2 else 'one-device'} LlamaForCausalLM "
                f"in {t_load:.2f} s, every tensor bitwise the saved one: "
                f"{same}")
            require(same, f"(d) the mp {mp} model's tensors differ")
            if mp == 1:
                loaded["model"] = m
            del m
    _fleet_init(torch, device, 1)
    m = loaded.pop("model")
    mopt = AdamW(1e-4, parameters=m.parameters(), multi_precision=True)
    # (a)'s model steps on as the pipeline; the restored one as the twin
    cap = _GradCapture(opt, pipe, keys)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        loss = float(model.train_batch([ids, ids], cap))
    r_loss, r_grads = _twin_step(torch, m, mopt, ids, n_micro)
    _agree(torch, tag, say, "(d) a further step of the restored "
           "one-device model vs (a)'s model", r_loss, loss, r_grads,
           cap.grads)
    del m, mopt, cap, r_grads
    # PPParallelAdaptor: the global view to 2 stages and back, exactly
    sd = {k: v for k, v in state.items()}
    stages = ckpt.PPParallelAdaptor.convert(sd, 1, 2, "llama.layers")
    back = ckpt.PPParallelAdaptor.convert(stages, 2, 1, "llama.layers")
    again = ckpt.PPParallelAdaptor.convert(back, 1, 2, "llama.layers")
    exact = (sorted(back) == sorted(sd) and all(back[k] is sd[k] for k in sd)
             and all(sorted(a) == sorted(b) and all(a[k] is b[k] for k in a)
                     for a, b in zip(stages, again)))
    say(f"{tag} (d) PPParallelAdaptor: global -> 2 stage dicts "
        f"({[len(s) for s in stages]} keys) -> global -> stages exact: "
        f"{exact}")
    require(exact, "(d) PPParallelAdaptor round trip")
    _free(torch, device)


def _offload_leg(torch, device, cfg, seed, tag, say, steps):
    """Phase 26 (b): one logical rank, DygraphShardingOptimizer(offload=
    True) against the on-device AdamW from the same weights."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        DygraphShardingOptimizer
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    tc = _train_cfg(cfg)
    B, T = cfg["train_batch"], cfg["train_seq"]
    ids = torch.from_numpy(np.random.RandomState(seed + 2).randint(
        0, tc.vocab_size, (B, T))).to(device)
    _hybrid_init(torch, device)
    state0 = None
    res = {}
    for offload in (False, True):
        m = LlamaForCausalLM(tc, device=device, generator=torch.Generator(
            device).manual_seed(seed))
        if state0 is None:
            state0 = {k: v.detach().clone() for k, v in
                      m.state_dict().items()}
        else:
            m.load_state_dict(state0)
        amp.decorate(m, level="O2", dtype="bfloat16")
        start = {n: p.detach().float().clone() for n, p in
                 m.named_parameters()}
        opt = AdamW(1e-4, parameters=m.parameters(), multi_precision=True)
        if offload:
            opt = DygraphShardingOptimizer(opt, offload=True)
        _free(torch, device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        loss, grads = _twin_step(torch, m, opt, ids, 1)
        masters = {n: v.to(device) for n, v in _opt_masters(opt, m).items()}
        masters["__start"] = start
        s_step = _timed(torch, device, lambda: _twin_step(
            torch, m, opt, ids, 1, capture=False), steps)
        peak = _peak_mib(torch, device)
        # held on the host, out of the next run's peak
        res[offload] = dict(loss=loss, s=s_step, peak=peak, grads={
            k: v.cpu() for k, v in grads.items()}, masters={
            k: ({n: t.cpu() for n, t in v.items()} if k == "__start"
                else v.cpu()) for k, v in masters.items()})
        if offload:
            held = [t for leaf in opt._leaves.values()
                    for per in list(leaf.states.values())
                    + [leaf.master or []] for t in per]
            on_card = [t for t in held if t.device.type != "cpu"]
            pinned = (all(t.is_pinned() for t in held)
                      if device.type == "cuda" else True)
            require(held and not on_card and pinned,
                    f"(b) {len(on_card)} of {len(held)} states on the "
                    f"card, pinned {pinned}")
        del m, opt, grads, masters, start
        _free(torch, device)
    for r in res.values():
        r["grads"] = {k: v.to(device) for k, v in r["grads"].items()}
        r["masters"] = {k: ({n: t.to(device) for n, t in v.items()}
                            if k == "__start" else v.to(device))
                        for k, v in r["masters"].items()}
    on, off = res[False], res[True]
    largest = max(int(np.prod(v.shape)) for v in state0.values())
    say(f"{tag} (b) DygraphShardingOptimizer(offload=True), one logical "
        f"rank, LlamaForCausalLM at phase 23b's widths under O2: peak "
        f"device memory {off['peak']:.1f} MiB against {on['peak']:.1f} MiB"
        f" on the card ({on['peak'] - off['peak']:.1f} MiB less; the "
        f"largest leaf's states {largest * 12 / 2 ** 20:.1f} MiB); s/step "
        f"{off['s']:.4f} against {on['s']:.4f} ({off['s'] / on['s']:.3f}x,"
        f" {steps} steps after a warm-up); states in pinned host memory")
    _agree(torch, tag, say, "(b) offload vs on-card step", off["loss"],
           on["loss"], off["grads"], on["grads"], off["masters"],
           on["masters"])
    if device.type == "cuda":
        require(off["peak"] < on["peak"], "(b) offload did not lower the "
                "peak")
    del res, state0
    _free(torch, device)


def _stage3_leg(torch, device, cfg, seed, tag, say):
    """Phase 26 (c): group_sharded_parallel(..., "p_g_os") at sharding
    2 against the one-device twin."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import collective
    tc = _train_cfg(cfg)
    L = tc.num_hidden_layers
    B, T = cfg["train_batch"], cfg["train_seq"]
    ids = torch.from_numpy(np.random.RandomState(seed + 2).randint(
        0, tc.vocab_size, (B, T))).to(device)
    _hybrid_init(torch, device)
    twin = LlamaForCausalLM(tc, device=device, generator=torch.Generator(
        device).manual_seed(seed))
    _hybrid_init(torch, device, sharding_degree=2)
    m = LlamaForCausalLM(tc, device=device, generator=torch.Generator(
        device).manual_seed(seed + 60))
    m.load_state_dict(twin.state_dict())
    amp.decorate([twin, m], level="O2", dtype="bfloat16")
    start = {n: p.detach().float().clone() for n, p in
             twin.named_parameters()}
    leaves = [(tuple(p.shape), p.element_size()) for p in m.parameters()]
    full = sum(int(np.prod(s)) * b for s, b in leaves)
    want_p = sum(int(np.prod(s)) * b // (2 if any(d % 2 == 0 for d in s)
                                          else 1) for s, b in leaves)
    topt = AdamW(1e-4, parameters=twin.parameters(), multi_precision=True)
    wrapped, opt, _ = group_sharded_parallel(
        m, AdamW(1e-4, parameters=m.parameters(), multi_precision=True),
        "p_g_os")
    per_rank = wrapped.param_bytes_per_rank()
    require(per_rank == [want_p, want_p],
            f"(c) parameter bytes per rank {per_rank}, not {want_p}")
    t_loss, t_grads = _twin_step(torch, twin, topt, ids, 1)
    t_masters = _opt_masters(topt, twin)
    t_masters["__start"] = start
    del twin, topt
    _free(torch, device)
    _reset_train_counts()
    collective.reset_counts()
    loss, grads = _twin_step(torch, wrapped, opt, ids, 1)
    coll = _coll_step()
    _hybrid_launches(torch, device, L, 1, "(c) stage 3 step")
    want_c = fleet_hybrid_expected(leaves, 2)
    require(coll == want_c, f"(c) collectives {coll} are not {want_c}")
    grads = {k.split("_layer.", 1)[-1]: v for k, v in grads.items()}
    masters = {k.split("_layer.", 1)[-1]: v
               for k, v in _opt_masters(opt, wrapped).items()}
    say(f"{tag} (c) group_sharded_parallel(level 'p_g_os') at sharding 2 "
        f"(logical ranks), LlamaForCausalLM at phase 23b's widths under "
        f"O2: parameter bytes per rank between steps {per_rank} of "
        f"{full}; one step's collectives "
        f"{({k: v for k, v in coll.items() if v[0]})} (the forward's "
        f"gathers; fleet_hybrid_expected met)")
    _agree(torch, tag, say, "(c) stage 3 vs twin", loss, t_loss, grads,
           t_grads, masters, t_masters)
    del wrapped, opt, m, grads, masters, t_grads, t_masters
    _hybrid_init(torch, device)
    _free(torch, device)


def _moe_ep_leg(torch, device, cfg, seed, tag, say):
    """Phase 26 (e): MoELayer at ep 2 against ep 1 from the same
    weights, under O2."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.incubate import MoELayer
    from paddle_tpu_torch.parallel import collective
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    N, d, E, k = cfg["moe_tokens"], cfg["moe_d"], 8, 2
    _hybrid_init(torch, device)
    layers = {}
    for ep in (1, 2):
        if ep > 1:
            mesh_mod.build_mesh(dp=ep, devices=[device] * ep)
        m = MoELayer(d, num_expert=E, d_hidden=cfg["moe_hidden"], top_k=k,
                     device=device,
                     generator=torch.Generator().manual_seed(seed + 10))
        amp.decorate(m, level="O2", dtype="bfloat16")
        layers[ep] = m
    require(layers[1].ep_axis is None and layers[2].ep_axis == "dp",
            "(e) ep axes")
    gx = torch.Generator().manual_seed(seed + 11)
    x = torch.randn(N, d, generator=gx).to(device)
    proj = torch.randn(N, d, generator=gx).to(device)
    cap = max(int(layers[1].capacity_factor * N * k / E), k)
    with torch.no_grad(), amp.auto_cast(level="O2", dtype="bfloat16"):
        lg = layers[1].gate(x)[0]
        c1 = MoELayer._gshard_combine(lg, k, E, cap, torch.bfloat16)
        collective.reset_counts()
        c2 = torch.cat(MoELayer._ep_combine(list(lg.chunk(2, 0)), k, E, cap,
                                            torch.bfloat16), 0)
    routed = torch.equal(c1, c2)
    del c1, c2
    outs, grads = {}, {}
    t0 = time.perf_counter()
    for ep, m in layers.items():
        xi = x.clone().requires_grad_()
        collective.reset_counts()
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            out = m(xi)
        (out.float() * proj).sum().add(m.l_aux.float()).backward()
        _sync(torch, device)
        if ep == 2:
            coll = _coll_step()
        outs[ep] = out.detach().float()
        grads[ep] = {"x": xi.grad.float(), **{
            n: p.grad.float() for n, p in m.named_parameters()}}
    wall = time.perf_counter() - t0
    mesh_mod.set_mesh(None)
    want_c = moe_ep_expected(E, cap, d, 2, k, 2)
    require(coll == want_c, f"(e) collectives {coll} are not {want_c}")
    err = _rel_err(outs[2], outs[1])
    worst, worst_cos, noise = _grads_agree(torch, grads[2], grads[1])
    say(f"{tag} (e) MoELayer({d}, {E} experts, {cfg['moe_hidden']}, top "
        f"{k}) over {N} tokens under O2 at ep 2 (logical 'dp' ranks, 4 "
        f"experts and {N // 2} tokens each) against ep 1 from the same "
        f"weights: routing (combine tensor, capacity {cap}) exactly equal: "
        f"{routed}; output within {err:.3e} x max|ref| (bound "
        f"{BOUND_AMP_OUT}); gradients worst cosine {worst_cos:.6f} (bound "
        f"{BOUND_AMP_COS}; {len(noise)} noise-level); forward and backward "
        f"of both in {wall:.2f} s; collectives "
        f"{({k_: v for k_, v in coll.items() if v[0]})} (moe_ep_expected "
        f"met)")
    require(routed, "(e) ep 2 routing differs from ep 1's")
    require(err <= BOUND_AMP_OUT and worst_cos >= BOUND_AMP_COS,
            "(e) ep 2 outside the bounds")
    del layers, outs, grads
    _free(torch, device)


def _train_step_leg(torch, device, cfg, seed, tag, say, steps):
    """Phase 26 (f): TrainStep(grad_accum_steps=4) on the one-device
    Llama against the twin accumulating the same micro-batches."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.train_step import TrainStep
    tc = _train_cfg(cfg)
    L, n_micro = tc.num_hidden_layers, 4
    B, T = cfg["train_batch"], cfg["train_seq"]
    ids = torch.from_numpy(np.random.RandomState(seed + 2).randint(
        0, tc.vocab_size, (B, T))).to(device)
    _hybrid_init(torch, device)
    twin = LlamaForCausalLM(tc, device=device, generator=torch.Generator(
        device).manual_seed(seed))
    m = LlamaForCausalLM(tc, device=device, generator=torch.Generator(
        device).manual_seed(seed + 70))
    m.load_state_dict(twin.state_dict())
    amp.decorate([twin, m], level="O2", dtype="bfloat16")
    topt = AdamW(1e-4, parameters=twin.parameters(), multi_precision=True)
    t_loss, t_grads = _twin_step(torch, twin, topt, ids, n_micro)
    after_twin = {n: p.detach().float() for n, p in twin.named_parameters()}
    del twin, topt
    _free(torch, device)
    ts = TrainStep(m, AdamW(1e-4, parameters=m.parameters(),
                            multi_precision=True), grad_accum_steps=4)
    seen = {}
    apply = ts._apply

    def capture():
        seen.update({n: p.grad.detach().float() / n_micro
                     for n, p in m.named_parameters()})
        apply()
    ts._apply = capture
    micro = ids.chunk(n_micro, 0)

    def step():
        total = 0.0
        for x in micro:
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                total = total + ts(x, x).float()
        return total / n_micro

    _reset_train_counts()
    loss = float(step())
    _hybrid_launches(torch, device, L, n_micro, "(f) TrainStep")
    ts._apply = apply
    after = {n: p.detach().float() for n, p in m.named_parameters()}
    perr = max(_rel_err(after[n], after_twin[n]) for n in after)
    s_step = _timed(torch, device, step, steps)
    say(f"{tag} (f) TrainStep(grad_accum_steps=4) on LlamaForCausalLM at "
        f"phase 23b's widths under O2, micro-batches {B // n_micro} x {T}: "
        f"{s_step:.4f} s per optimizer step ({steps} after a warm-up); "
        f"parameters after the step within {perr:.3e} x max|ref| of the "
        f"twin's (bound {BOUND_AMP_OUT}; TrainStep updates the bf16 "
        f"parameters, the twin its fp32 masters)")
    _agree(torch, tag, say, "(f) TrainStep vs twin", loss, t_loss, seen,
           t_grads)
    require(perr <= BOUND_AMP_OUT, f"(f) parameters off by {perr}")
    del ts, m, seen, t_grads, after, after_twin
    _free(torch, device)
    return s_step


def phase_fleet_hybrid(torch, device, cfg, seed, tag, say):
    """Phase 26: the rest of fleet's hybrid training on logical ranks of
    the one device, at phase 23b's widths: (a) PipelineParallel with
    ZeRO-1 and (d) checkpoint save / reshard on its model, (b) offload,
    (c) stage 3, (e) MoE over an expert-parallel axis, (f) TrainStep."""
    t_phase = time.perf_counter()
    say(f"{tag} phase 26 (fleet's hybrid training on logical ranks): "
        f"pipeline + sharding, checkpoint, offload, stage 3, MoE ep, "
        f"TrainStep")
    steps = 3
    _pipeline_leg(torch, device, cfg, seed, tag, say, steps)
    _offload_leg(torch, device, cfg, seed, tag, say, 2)
    _stage3_leg(torch, device, cfg, seed, tag, say)
    _moe_ep_leg(torch, device, cfg, seed, tag, say)
    _train_step_leg(torch, device, cfg, seed, tag, say, 2)
    say(f"{tag} phase 26 took {time.perf_counter() - t_phase:.1f} s")


# -- phase 27: training across processes ------------------------------
MP_TIMEOUT = 900           # seconds phase 27's two ranks may run
MP_STEPS = 3
ELASTIC_RUN_SECS = 4.0     # a (c) worker's run once its CUDA context is up
ELASTIC_TIMEOUT = 240      # seconds (c) may take in all

# phase 27 (c)'s worker: a CUDA context, a marker line per incarnation,
# then a few seconds of "training"
_ELASTIC_WORKER = """
import os, time
import torch
torch.ones(1, device=os.environ["ELASTIC_DEVICE"]).sum().item()
rank = os.environ["PADDLE_TRAINER_ID"]
with open(os.path.join(os.environ["ELASTIC_TEST_DIR"],
                       "started_rank" + rank), "a") as f:
    f.write(str(os.getpid()) + "\\n")
deadline = time.time() + float(os.environ["ELASTIC_RUN_SECS"])
while time.time() < deadline:
    time.sleep(0.1)
"""


def _fma(a, b, c):
    return a * b + c


def _peer_card():
    import torch
    return (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")


_MP_OUT = {}


def _mp_say(rank, name, obj):
    """One result line, into this rank's own file (two ranks' long
    lines would interleave on a shared stdout)."""
    line = f"RESULT {rank} {name} " + json.dumps(obj) + "\n"
    with open(_MP_OUT["path"], "a") as f:
        f.write(line)
    print(line[:200].rstrip(), flush=True)


def _mp_config(tcfg):
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig(
        vocab_size=tcfg["vocab"], hidden_size=tcfg["hidden"],
        intermediate_size=tcfg["ffn"], num_hidden_layers=tcfg["layers"],
        num_attention_heads=tcfg["heads"],
        num_key_value_heads=tcfg["kv_heads"],
        max_position_embeddings=tcfg["seq"])


def _mp_ids(tcfg):
    if "ids" in tcfg:
        return np.asarray(tcfg["ids"], np.int64)
    return np.random.RandomState(tcfg["ids_seed"]).randint(
        0, tcfg["vocab"], (tcfg["batch"], tcfg["seq"]))


def _mp_trainer(torch, device, tcfg):
    """The trainer of ``tcfg`` on the installed mesh: from the numpy
    tree in ``tcfg["params"]`` (an .npz of '/'-joined paths) or from
    ``tcfg["seed"]``."""
    from paddle_tpu_torch import weights
    from paddle_tpu_torch.models import LlamaSpmdTrainer
    kw = dict(compute_dtype=getattr(torch, tcfg["dtype"]),
              remat=tcfg["remat"], seed=tcfg["seed"])
    if tcfg.get("params"):
        return weights.llama_spmd_trainer(
            weights.load_tree(tcfg["params"]), _mp_config(tcfg), **kw)
    return LlamaSpmdTrainer(_mp_config(tcfg), **kw)


def _digests(torch, tr):
    """{'path@coord': sha256} of this process's parameter shards and
    fp32 masters (bitwise comparisons across processes)."""
    import hashlib
    from paddle_tpu_torch.models.llama_spmd import tree_get, tree_paths
    out = {}
    for path in tree_paths(tr.params):
        leaves = (("", tree_get(tr.params, path)),
                  ("master:", tree_get(tr.opt_state, path)["master"]))
        for pre, leaf in leaves:
            for c, t in tr._shards(leaf).items():
                raw = t.detach().contiguous().cpu().reshape(-1).view(
                    torch.uint8).numpy()
                out[f"{pre}{'/'.join(path)}@{','.join(map(str, c))}"] = \
                    hashlib.sha256(raw.tobytes()).hexdigest()
    return out


def _mp_train_run(torch, device, tr, ids, steps):
    """``steps`` steps of ``tr`` on ``ids``: each loss (float.hex), each
    step's seconds, the launches and collectives of the steps, peak
    memory and the digests of the shards after the last step."""
    from paddle_tpu_torch.parallel import collective
    _sync(torch, device)
    _reset_train_counts()
    collective.reset_counts()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = float(tr.train_step(ids))
        _sync(torch, device)
        secs.append(time.perf_counter() - t0)
        losses.append(loss.hex())
    return dict(losses=losses, step_s=secs, launches=_train_counts(),
                collectives=collective.counts(),
                peak_mib=_peak_mib(torch, device), digests=_digests(torch, tr))


def _mp_collectives(torch, dev, rank):
    """Every eager collective of ``distributed.communication`` across the
    two processes on ``dev``, float32 and int32, each checked exactly;
    returns the counts."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import Group, P2POp, ReduceOp
    from paddle_tpu_torch.parallel import collective
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    collective.reset_counts()
    other = 1 - rank

    def eq(got, want, what):
        want = torch.as_tensor(want, dtype=got.dtype)
        require(got.device == dev and got.dtype == want.dtype
                and torch.equal(got.cpu(), want),
                f"rank {rank} {what}: {got.tolist()} ({got.dtype}) is not "
                f"{want.tolist()}")

    for dt in (torch.float32, torch.int32):
        n = str(dt).split(".")[1]

        def full(v, k=4):
            return torch.full((k,), v, dtype=dt, device=dev)

        for op, x0, want in ((ReduceOp.SUM, rank + 1, 3),
                             (ReduceOp.MAX, rank + 1, 2),
                             (ReduceOp.MIN, rank + 1, 1),
                             (ReduceOp.AVG, 2 * rank + 1, 2)):
            x = full(x0)
            dist.all_reduce(x, op=op)
            eq(x, [want] * 4, f"all_reduce {op} {n}")
        got = []
        dist.all_gather(got, torch.arange(3, dtype=dt, device=dev)
                        + 10 * rank)
        for i, g in enumerate(got):
            eq(g, [10 * i, 10 * i + 1, 10 * i + 2], f"all_gather {n}")
        x = full(0)
        dist.reduce_scatter(x, [full(rank + 1), full(10 * (rank + 1))])
        eq(x, [(3, 30)[rank]] * 4, f"reduce_scatter {n}")
        x = full(rank + 5)
        dist.broadcast(x, src=1)
        eq(x, [6] * 4, f"broadcast {n}")
        x = full(rank + 1)
        dist.reduce(x, dst=0)
        eq(x, [(3, 2)[rank]] * 4, f"reduce {n}")
        x = full(0)
        dist.scatter(x, [full(7), full(8)] if rank == 0 else None, src=0)
        eq(x, [7 + rank] * 4, f"scatter {n}")
        got = []
        dist.alltoall(got, [full(10 * rank + j) for j in range(2)])
        for i, g in enumerate(got):
            eq(g, [10 * i + rank] * 4, f"alltoall {n}")
        x = torch.empty(4, dtype=dt, device=dev)
        dist.alltoall_single(x, torch.arange(4, dtype=dt, device=dev)
                             + 100 * rank)
        eq(x, [2 * rank, 2 * rank + 1, 100 + 2 * rank, 101 + 2 * rank],
           f"alltoall_single {n}")
        if rank == 0:
            dist.send(full(42), dst=1)
        else:
            x = full(0)
            dist.recv(x, src=0)
            eq(x, [42] * 4, f"send / recv {n}")
        y = full(0)
        for task in dist.batch_isend_irecv([
                P2POp(dist.isend, full(20 + rank), other),
                P2POp(dist.irecv, y, other)]):
            task.wait()
        eq(y, [20 + other] * 4, f"batch_isend_irecv {n}")
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    require(objs == [{"rank": 0}, {"rank": 1}], f"all_gather_object {objs}")
    try:
        dist.all_reduce(torch.ones(2, device=dev), op=ReduceOp.PROD)
        require(False, "all_reduce PROD across processes did not raise")
    except NotImplementedError:
        pass
    mesh_mod.build_mesh(dp=2, mp=2, devices=[dev, dev])
    try:
        dist.all_reduce(torch.ones(2, device=dev),
                        group=Group([0, 1], axis="mp"))
        require(False, "an mp-axis group of a hybrid mesh did not raise")
    except NotImplementedError:
        pass
    mesh_mod.set_mesh(None)
    dist.barrier()
    dist.wait(y)
    return collective.counts()


def _mp_dp_step(torch, dev, rank, path):
    """The reference's two-process data-parallel step
    (tests/test_multiprocess.py:41-51) with the port's Linear and SGD
    from the weights in ``path``: per-rank data, gradients all-reduced
    and halved by hand."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn, optimizer
    w = np.load(path)
    lin = nn.Linear(4, 2, device=dev)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w["weight"]))
        lin.bias.copy_(torch.from_numpy(w["bias"]))
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        (2, 4)).astype(np.float32)).to(dev)
    loss = (lin(x) ** 2).mean()
    loss.backward()
    for p in lin.parameters():
        dist.all_reduce(p.grad)
        p.grad.mul_(0.5)
    optimizer.SGD(parameters=lin.parameters(), learning_rate=0.1).step()
    return {"checksum": float(sum(float(p.sum()) for p in
                                  lin.parameters())),
            "weight": lin.weight.tolist(), "bias": lin.bias.tolist()}


def _mp_rpc(rank, endpoint):
    from paddle_tpu_torch.distributed import rpc
    rpc.init_rpc(f"w{rank}", rank=rank, world_size=2,
                 master_endpoint=endpoint)
    out = (rpc.rpc_sync("w1", _fma, args=(3, 4, 5)) if rank == 0 else
           rpc.rpc_sync("w0", _fma, args=(2, 2, 0)))
    require(out == (17, 4)[rank], f"rpc rank {rank}: {out}")
    peer = rpc.rpc_async(f"w{1 - rank}", _peer_card).wait()
    infos = [tuple(i) for i in rpc.get_all_worker_infos()]
    rpc.shutdown()
    return {"value": out, "peer_card": peer, "workers": len(infos)}


def _mp_refusals(torch, rank):
    """A dead rendezvous raises naming the address and the rank; a world
    on distinct cards raises naming item 10b. Runs before the real
    rendezvous (it sets and restores the environment)."""
    import socket
    import paddle_tpu_torch.distributed as dist
    keys = ("PADDLE_MASTER", "PADDLE_TRAINER_ID", "PADDLE_PG_TIMEOUT")
    saved = {k: os.environ.get(k) for k in keys}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
        os.environ.update(PADDLE_MASTER=addr, PADDLE_TRAINER_ID="0",
                          PADDLE_PG_TIMEOUT="5")
        try:
            dist.init_parallel_env()
            require(False, "a rendezvous at a taken port did not raise")
        except RuntimeError as e:
            require(addr in str(e) and "rank=0" in str(e),
                    f"the rendezvous error names no address / rank: {e}")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return addr


def _mp_distinct_cards(torch, rank):
    from paddle_tpu_torch.parallel import mesh as mesh_mod

    class _Props:
        uuid = f"card-{rank}"

    real = torch.cuda.get_device_properties
    torch.cuda.get_device_properties = lambda d: _Props()
    try:
        mesh_mod._check_one_card([torch.device("cuda", 0)])
        require(False, "ranks on distinct cards did not raise")
    except NotImplementedError as e:
        require("10b" in str(e), f"the distinct-card error: {e}")
    finally:
        torch.cuda.get_device_properties = real


def mp_child(cfg_path):
    """One rank of phase 27 (and of the CPU twins in
    tests/test_torch_multiprocess.py), started by the port's launcher:
    the scenarios of the JSON file at ``cfg_path``, each printing a
    ``RESULT <rank> <name> <json>`` line. Exits non-zero on a failed
    check."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(cfg_path) as f:
        cfg = json.load(f)
    dev = torch.device(cfg["device"])
    if dev.type == "cpu":
        torch.set_num_threads(1)
    elif dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    _MP_OUT["path"] = os.path.join(os.path.dirname(cfg_path),
                                   f"rank{rank}.results")
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    if cfg.get("refusals"):
        _mp_say(rank, "rendezvous_refused", _mp_refusals(torch, rank))
    dist.init_parallel_env()
    require(dist.get_world_size() == 2 and dist.get_rank() == rank
            and dist.get_backend() == "gloo",
            f"process group: rank {dist.get_rank()} of "
            f"{dist.get_world_size()} ({dist.get_backend()})")
    _mp_say(rank, "env", {k: os.environ.get(k) for k in (
        "PADDLE_MASTER", "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID")})
    if cfg.get("refusals"):
        _mp_distinct_cards(torch, rank)
        _mp_say(rank, "distinct_cards_refused", True)
    if cfg.get("collectives"):
        _mp_say(rank, "collectives", _mp_collectives(torch, dev, rank))
    # inputs the caller writes while the ranks start
    deadline = time.time() + cfg.get("wait_s", 0)
    for path in cfg.get("wait_for", ()):
        while not os.path.exists(path):
            require(time.time() < deadline, f"no {path} in time")
            time.sleep(0.02)
    if cfg.get("dp_weights"):
        _mp_say(rank, "dp_step", _mp_dp_step(torch, dev, rank,
                                             cfg["dp_weights"]))
    for name, tcfg in cfg.get("trainers", {}).items():
        # the mesh's ranks split over the two processes (one each)
        mesh_mod.build_mesh(**tcfg.get("mesh", dict(mp=2)), devices=[dev])
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        tr = _mp_trainer(torch, dev, tcfg)
        mine = tr.mesh.local_coords()
        require(len(mine) == 1 and tr.mesh.owner(mine[0]) == rank,
                f"rank {rank} holds {mine}")
        _mp_say(rank, name, _mp_train_run(torch, dev, tr, _mp_ids(tcfg),
                                          tcfg["steps"]))
        del tr
        mesh_mod.set_mesh(None)
        _free(torch, dev)
    if cfg.get("rpc"):
        _mp_say(rank, "rpc", _mp_rpc(rank, cfg["rpc"]))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mp_start(child_cfg, workdir, timeout=MP_TIMEOUT):
    """Start the two ranks of ``child_cfg`` through the port's launcher
    (``python -m paddle_tpu_torch.distributed.launch --nproc_per_node
    2``) in a session of their own; returns the handle ``mp_finish``
    reads."""
    path = os.path.join(workdir, "mp_child.json")
    with open(path, "w") as f:
        json.dump(child_cfg, f)
    log = open(os.path.join(workdir, "mp_child.log"), "w+")
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--timeout", str(timeout),
         os.path.join(root, "chip_smoke.py"), "--mp-child", path],
        cwd=root, stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    return proc, log, timeout


def mp_finish(handle):
    """Wait for ``mp_start``'s ranks (killing the whole session past its
    timeout); (exit code, {(rank, name): result}, log text)."""
    import signal
    proc, log, timeout = handle
    try:
        rc = proc.wait(timeout=timeout + 60)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        rc = proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    res = {}
    wd = os.path.dirname(log.name)
    for r in range(2):
        path = os.path.join(wd, f"rank{r}.results")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                _, rank, name, body = line.rstrip("\n").split(" ", 3)
                res[int(rank), name] = json.loads(body)
    return rc, res, text


def mp_expected_cfg(cfg, seed):
    """Phase 27 (b)'s trainer: phase 24's widths, batch and ids."""
    return dict(vocab=cfg["train_vocab"], hidden=cfg["train_hidden"],
                ffn=cfg["train_ffn"], heads=cfg["train_heads"],
                kv_heads=cfg["train_kv_heads"], layers=cfg["train_layers"],
                seq=cfg["train_seq"], batch=cfg["train_batch"],
                ids_seed=seed + 7, seed=seed, dtype="bfloat16", remat=True,
                steps=MP_STEPS)


def _mp_elastic(torch, device, workdir, tag, say):
    """(c): two workers, each with a CUDA context, under the elastic
    supervisor; rank 1 is SIGKILLed mid-run, the pod is relaunched and
    completes."""
    import signal
    import threading
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticSupervisor
    t0 = time.perf_counter()
    script = os.path.join(workdir, "elastic_worker.py")
    with open(script, "w") as f:
        f.write(_ELASTIC_WORKER)
    envs = [dict(os.environ, PADDLE_TRAINER_ID=str(r),
                 ELASTIC_TEST_DIR=workdir, ELASTIC_DEVICE=str(device),
                 ELASTIC_RUN_SECS=str(ELASTIC_RUN_SECS)) for r in range(2)]
    sup = ElasticSupervisor([[sys.executable, script]] * 2, envs,
                            heartbeat_dir=os.path.join(workdir, "beats"),
                            interval=0.2, max_restarts=2,
                            log=lambda *a: say(f"{tag} " + " ".join(
                                map(str, a))))
    box = {}
    th = threading.Thread(target=lambda: box.setdefault("rc", sup.run()))
    th.start()
    markers = [os.path.join(workdir, f"started_rank{r}") for r in range(2)]
    deadline = time.time() + ELASTIC_TIMEOUT / 2
    while time.time() < deadline and not all(map(os.path.exists, markers)):
        time.sleep(0.05)
    started = all(map(os.path.exists, markers))
    if started:
        sup._procs[1].send_signal(signal.SIGKILL)
    th.join(timeout=ELASTIC_TIMEOUT / 2)
    if th.is_alive():
        sup.max_restarts = 0
        sup._kill_all()
        th.join(timeout=30)
    require(started, "(c) the elastic workers never started")
    require(not th.is_alive(), "(c) the elastic supervisor did not finish")
    pids = []
    for m in markers:
        with open(m) as f:
            pids.append([ln for ln in f.read().splitlines() if ln])
    say(f"{tag} phase 27 (c) elastic: rank 1 SIGKILLed holding a "
        f"{device} context; supervisor rc {box.get('rc')}, restarts {sup.restarts}, "
        f"incarnations {[len(p) for p in pids]}, "
        f"{time.perf_counter() - t0:.1f} s")
    require(box.get("rc") == 0 and sup.restarts == 1
            and [len(p) for p in pids] == [2, 2],
            f"(c) rc {box.get('rc')}, restarts {sup.restarts}, pids {pids}")


def phase_multiprocess(torch, device, cfg, seed, tag, say):
    """Phase 27: training across two processes on the one card (Gloo):
    (a) every eager collective exactly, (b) LlamaSpmdTrainer with mp 2
    split across the processes bitwise the one-process logical mp 2 run,
    (c) the elastic supervisor relaunching a SIGKILLed rank, (d) rpc."""
    from paddle_tpu_torch.parallel import collective
    from paddle_tpu_torch.parallel import mesh as mesh_mod
    t_phase = time.perf_counter()
    tcfg = mp_expected_cfg(cfg, seed)
    tc = _mp_config(tcfg)
    hd = tc.hidden_size // tc.num_attention_heads
    # the one-process run: mp 2 as LOGICAL ranks on this device
    mesh_mod.build_mesh(mp=2, devices=[device] * 2)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    tr = _mp_trainer(torch, device, tcfg)
    one = _mp_train_run(torch, device, tr, _mp_ids(tcfg), MP_STEPS)
    del tr
    mesh_mod.set_mesh(None)
    _free(torch, device)
    want_l, want_c = mesh_expected(dict(mp=2), tc.num_hidden_layers, 1,
                                   tcfg["seq"], hd, True,
                                   fused=device.type == "cuda")
    say(f"{tag} phase 27 (b) one process, mp 2 LOGICAL ranks: losses "
        f"{[float.fromhex(x) for x in one['losses']]}, s/step "
        f"{[round(x, 4) for x in one['step_s']]}, peak {one['peak_mib']:.1f} "
        f"MiB, launches {one['launches']}, collectives {one['collectives']}")
    coll_calls = {k: v["calls"] for k, v in one["collectives"].items()}
    require(coll_calls == {k: MP_STEPS * v for k, v in want_c.items()},
            f"one-process collectives {coll_calls} are not {MP_STEPS} x "
            f"{want_c}")
    if device.type == "cuda":
        require(one["launches"] == {k: MP_STEPS * v
                                    for k, v in want_l.items()},
                f"one-process launches {one['launches']}")
    with tempfile.TemporaryDirectory() as wd:
        child = dict(device=str(device), refusals=True, collectives=True,
                     trainers={"trainer": tcfg},
                     rpc=f"127.0.0.1:{_free_port()}")
        t0 = time.perf_counter()
        rc, res, text = mp_finish(mp_start(child, wd))
        wall = time.perf_counter() - t0
        if rc != 0:
            say(f"{tag} phase 27 ranks' log (tail):\n" + text[-6000:])
        require(rc == 0, f"phase 27's ranks exited {rc}")
        for r in range(2):
            for name in ("env", "rendezvous_refused",
                         "distinct_cards_refused", "collectives", "trainer",
                         "rpc"):
                require((r, name) in res, f"rank {r} printed no {name}")
        c = res[0, "collectives"]
        say(f"{tag} phase 27 (a) eager collectives across 2 processes on "
            f"{device} (float32 and int32, every check exact): calls and "
            f"bytes per kind (rank 0) {c}; Gloo took CUDA tensors for "
            f"{sorted(collective.GLOO_CUDA)}, the rest staged: "
            f"{c.get('host_staged', {'bytes': 0})['bytes']} B through "
            f"pinned host memory")
        say(f"{tag} phase 27 (a) rank 1: {res[1, 'collectives']}")
        t = [res[r, "trainer"] for r in range(2)]
        for r in range(2):
            say(f"{tag} phase 27 (b) rank {r} of 2 processes (mp split): "
                f"losses {[float.fromhex(x) for x in t[r]['losses']]}, "
                f"s/step {[round(x, 4) for x in t[r]['step_s']]}, peak "
                f"{t[r]['peak_mib']:.1f} MiB, launches {t[r]['launches']}, "
                f"collectives {t[r]['collectives']}")
        require(t[0]["losses"] == t[1]["losses"],
                f"the two processes' losses differ: {t[0]['losses']} vs "
                f"{t[1]['losses']}")
        require(t[0]["losses"] == one["losses"],
                f"the processes' losses {t[0]['losses']} are not the "
                f"one-process run's {one['losses']}")
        for r in range(2):
            mine = t[r]["digests"]
            bad = [k for k in mine if mine[k] != one["digests"].get(k)]
            require(mine and not bad, f"rank {r}: shards not bitwise the "
                    f"one-process run's: {bad[:4]}")
            require(t[r]["launches"] == {k: v // 2 for k, v in
                                         one["launches"].items()},
                    f"rank {r} launches {t[r]['launches']} are not half "
                    f"the one-process run's {one['launches']}")
            calls = {k: v for k, v in t[r]["collectives"].items()
                     if k != "host_staged"}
            require(calls == one["collectives"],
                    f"rank {r} collectives {calls} are not the one-process "
                    f"run's {one['collectives']}")
        covered = set(t[0]["digests"]) | set(t[1]["digests"])
        require(covered == set(one["digests"]),
                "the two processes do not hold every shard once")
        staged = [t[r]["collectives"].get("host_staged", {"bytes": 0})
                  ["bytes"] for r in range(2)]
        say(f"{tag} phase 27 (b) bitwise: losses equal across the two "
            f"processes and to the one-process run, {len(covered)} shards "
            f"(parameters and fp32 masters) equal by sha256; host-staged "
            f"bytes over {MP_STEPS} steps {staged}; the two ranks' call "
            f"took {wall:.1f} s with start-up and (a), (d)")
        d = [res[r, "rpc"] for r in range(2)]
        say(f"{tag} phase 27 (d) rpc: {d}")
        require([x["value"] for x in d] == [17, 4]
                and all(x["workers"] == 2 for x in d), f"(d) rpc {d}")
        _mp_elastic(torch, device, wd, tag, say)
    # rows 4, 5, 6 and 9 ran in both processes
    launches = {k: t[0]["launches"][k] + t[1]["launches"][k]
                for k in t[0]["launches"]}
    say(f"{tag} phase 27 launches of the two processes together over "
        f"{MP_STEPS} steps: {launches}; took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def run(device, cfg, seed=0, say=print, card=None):
    """All phases on ``device``; returns the kernels line's rows."""
    import torch
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformerInt8
    from paddle_tpu_torch.inference import TokenServingModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card or card_line()
    tag = f"[{card}]"
    from paddle_tpu_torch.ops.hopper import _build
    t0 = time.perf_counter()
    if device.type == "cuda":
        built = _build.build_all()
        say(f"{tag} build: {time.perf_counter() - t0:.2f} s for "
            f"{len(built)} sources in parallel")
        for name, b in built.items():
            for line in b.ptxas.splitlines():
                if "registers" in line or "smem" in line:
                    say(f"{tag} {name}: {line.strip()}")
    rows = phase_kernels(torch, device, cfg, tag, say)
    rows["gmm"] = phase_gmm(torch, device, cfg, tag, say)
    tsm = build_model(torch, device, cfg, seed)
    rng = np.random.RandomState(seed + 1)
    prompts = [list(rng.randint(0, cfg["vocab"], n)) for n in rng.randint(
        cfg["min_prompt"], cfg["max_prompt"] + 1, cfg["n_requests"])]
    serve = phase_serve(torch, device, cfg, tsm, prompts, tag, say,
                        "serving", cfg["num_blocks"])
    # the engine's pool is not needed again; the engine holds reference
    # cycles (its metrics registry), so collect them before the peak
    # memory of the next serving phase is read
    del serve["engine"]
    gc.collect()
    dense_launches, toks, pH, first_small = phase_paged_vs_dense(
        torch, device, cfg, tsm, prompts, tag, say)
    # the quantized model: the same float weights, int8 projections and
    # an int8 head
    tsm8 = TokenServingModel(FusedMultiTransformerInt8.from_float(tsm.core),
                             tsm._embed_np, weight_dtype="int8")
    system = list(rng.randint(0, cfg["vocab"], cfg["system_prompt"]))
    qprompts = [system + list(rng.randint(0, cfg["vocab"], n))
                for n in rng.randint(cfg["min_suffix"],
                                     cfg["max_suffix"] + 1,
                                     cfg["n_requests"])]
    qserve = phase_quant_serve(torch, device, cfg, tsm8, qprompts, tag, say)
    del qserve["engine"]
    phase_quant_vs_float(torch, device, cfg, tsm, tsm8, prompts, toks, pH,
                         tag, say)
    phase_prefix(torch, device, cfg, tsm, qprompts, qserve["streams"], tag,
                 say)
    # the MoE slice: phase 3's traffic through an 8-expert model
    tsm_moe = build_moe_model(torch, device, cfg, seed, tsm._embed_np)
    mserve = phase_moe_serve(torch, device, cfg, tsm_moe, prompts,
                             serve["counts"], tag, say)
    del mserve["engine"]
    gc.collect()
    phase_moe_vs_fold(torch, device, cfg, tsm_moe, tag, say)
    phase_profile(torch, device, cfg, tsm, tsm_moe, tag, say)
    spec = phase_spec(torch, device, cfg, tsm, tsm_moe, prompts, toks,
                      first_small, tag, say)
    phase_parallel(torch, device, cfg, tsm, prompts, toks, first_small, tag,
                   say)
    phase_resilience(torch, device, cfg, tsm, tsm8, prompts, qprompts,
                     serve, qserve, toks, first_small, tag, say)
    phase_durability(torch, device, cfg, tsm, tsm8, prompts, qprompts,
                     serve, qserve,
                     spec[f"dense, {cfg['draft_layers']}-layer truncated "
                          f"draft"]["streams"],
                     toks[:cfg["spec_requests"]], first_small, seed, tag,
                     say)
    phase_fleet(torch, device, cfg, prompts, seed, tag, say)
    phase_sharded(torch, device, cfg, tsm, prompts, serve, toks, pH, tag,
                  say)
    del tsm8
    rows["gmm"]["launches"] = mserve["launches"]["gmm"]
    rows["paged_attention_ragged"]["launches"] = \
        serve["launches"]["paged_attention_ragged"]
    rows["paged_attention_ragged_int8"]["launches"] = \
        qserve["launches"]["paged_attention_ragged"]
    rows["decode_attention"]["launches"] = \
        dense_launches["decode_attention"]
    rows["w8a16_matmul"]["launches"] = qserve["launches"]["w8a16_matmul"]
    # the training slice reads its own peak memory: free the serving
    # models first
    del tsm, tsm_moe, serve, qserve, mserve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rows.update(phase_train_kernels(torch, device, cfg, tag, say))
    counts = phase_train(torch, device, cfg, seed, tag, say)
    for name, n in counts.items():
        rows[name]["launches"] = n
    phase_train_paths(torch, device, cfg, seed, tag, say)
    # the BERT pretraining slice
    rows.update(phase_bert_kernels(torch, device, cfg, tag, say))
    counts, fp32 = phase_bert_train(torch, device, cfg, seed, tag, say)
    for name, n in counts.items():
        rows[name]["launches"] = n
    phase_bert_paths(torch, device, cfg, seed, tag, say)
    # the nn training surface under AMP
    phase_amp(torch, device, cfg, seed, fp32, tag, say)
    # the training flagship on meshes of logical ranks
    phase_mesh(torch, device, cfg, seed, tag, say)
    # Paddle's dygraph tensor parallelism on logical mp ranks
    phase_fleet_mp(torch, device, cfg, seed, tag, say)
    # the rest of fleet's hybrid training on logical ranks
    phase_fleet_hybrid(torch, device, cfg, seed, tag, say)
    # training across two processes on the one card
    phase_multiprocess(torch, device, cfg, seed, tag, say)
    return [rows[k] for k in ("paged_attention_ragged",
                              "paged_attention_ragged_int8",
                              "decode_attention", "w8a16_matmul", "gmm",
                              "flash_attention_fwd", "flash_attention_bwd",
                              "fused_rms_norm", "fused_layer_norm",
                              "fused_dropout", "fused_adamw")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mp-child", default=None,
                    help="run one rank of phase 27 from this JSON file "
                         "(the port's launcher passes it)")
    args = ap.parse_args(argv)
    if args.mp_child:
        try:
            return mp_child(args.mp_child)
        except SmokeFailure as e:
            print(f"chip_smoke: rank FAILED: {e}", file=sys.stderr)
            return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    try:
        kernels = run(torch.device("cuda"), FULL, seed=args.seed,
                      card=card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[{card}] total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
