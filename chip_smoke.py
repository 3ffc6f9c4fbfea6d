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
   ragged paged attention over float32 and over int8 pages (a mixed
   step), dense decode attention, and the w8a16 matmul at 1, 8 and 256
   rows for every projection of the model and its head;
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
8. print the kernels line, the card line and, last, the contract line.
Every number printed carries the card's name and power limit.
"""
import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np

# float32 everywhere; the matmuls and convolutions in full float32
TOL_KERNEL = 1e-4          # kernel vs plain version, max abs error
TOL_W8A16 = 1e-4           # w8a16 vs plain version, relative to max|ref|
TOL_REL = 1e-5             # paged vs dense: hidden / logits, rel. to max
# the JAX package's documented bounds of quantized against float serving
BOUND_KV8 = 0.05           # int8 KV pages: hidden, rel. to max|h_fp|
BOUND_W8 = 0.1             # int8 weights: hidden, rel. to max|h_fp|
BOUND_HEAD8 = 0.02         # int8 head: logits, rel. to max|logits_fp|
HBM_BYTES_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_S = 67e12        # H100 SXM float32 outside the tensor cores

FULL = dict(vocab=50304, d=1024, layers=24, heads=16, ffn=4096,
            block_size=16, max_batch=8, chunk_tokens=128, budget=512,
            n_requests=12, min_prompt=64, max_prompt=960, new_tokens=32,
            num_blocks=260, kernel_pool_blocks=640, timing_iters=20,
            # quantized serving: a shared system prompt + unique suffixes
            system_prompt=256, min_suffix=32, max_suffix=704,
            q_num_blocks=310)


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


def _time_ms(torch, fn, device, iters):
    """(device ms, wall ms) per call after warm-up. Device: the kernels
    ``fn`` launches, summed by CUPTI through torch.profiler (None when the
    profiler records no device time); wall: CUDA events around ``iters``
    back-to-back calls, which includes the host's launch overhead when
    that is the slower side. Off the card both are host-clock times."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        return ms, ms
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    wall = a.elapsed_time(b) / iters
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


def _bound(nbytes, flops):
    t_b, t_f = nbytes / HBM_BYTES_S, flops / FP32_FLOP_S
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
    plan = pa.RaggedPlan(q_lens)
    t_k = _time_ms(torch, lambda: pa.paged_attention_ragged(
        q, pool, btd, q_lens, lensd, plan=plan), device, iters)
    t_p = _time_ms(torch, lambda: pa.paged_attention_ragged_reference(
        q, pool, btd, q_lens, lensd), device, iters)
    t_l = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qp, kt, vt, attn_mask=lmask), device, iters)
    ms, plain_ms, lib_ms = _device(t_k, t_p, t_l)
    # the Pallas module's default tile width, for comparison
    t_64 = _time_ms(torch, lambda: pa.paged_attention_ragged(
        q, pool, btd, q_lens, lensd, tile_q=64), device, iters)
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
    say(f"{tag} paged_attention_ragged device time: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa over gathered pages {lib_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}; {nbytes} B, {flops} flop); "
        f"wall per call: kernel {t_k[1]:.4f}, plain {t_p[1]:.4f}, sdpa "
        f"{t_l[1]:.4f} ms; kernel at tile_q 64 (the Pallas default) "
        f"{_device(t_64)[0]:.4f} ms vs {pa.DEFAULT_TILE_Q_CAP} (default)")
    rows["paged_attention_ragged"] = dict(
        name="paged_attention_ragged", route="cuda",
        source="paddle_tpu_torch/csrc/paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:290",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)

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
    say(f"{tag} paged_attention_ragged int8 pages vs plain: max_abs_err "
        f"{err:.3e} (tol {TOL_KERNEL}) rows {R} q_lens {q_lens}")
    require(err <= TOL_KERNEL, f"int8 ragged kernel disagrees: {err}")
    # yardstick: sdpa over pages gathered and dequantized beforehand
    kq, vq = pa.gather_pages(qpool, btd, kv_scales=scales)
    kqt, vqt = kq.transpose(1, 2), vq.transpose(1, 2)
    t_k = _time_ms(torch, lambda: pa.paged_attention_ragged(
        q, qpool, btd, q_lens, lensd, plan=plan, kv_scales=scales), device,
        iters)
    t_p = _time_ms(torch, lambda: pa.paged_attention_ragged_reference(
        q, qpool, btd, q_lens, lensd, kv_scales=scales), device, iters)
    t_l = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qp, kqt, vqt, attn_mask=lmask), device, iters)
    ms, plain_ms, lib_ms = _device(t_k, t_p, t_l)
    # bound: as above with hd int8 bytes + one f32 scale per (position,
    # head, K|V)
    nbytes = (2 * sum(q_lens) * H * hd * 4 + kv_pos * H * (hd + 4) * 2
              + bt.nbytes + kv_lens.nbytes)
    b_ms, b_by = _bound(nbytes, flops)
    say(f"{tag} paged_attention_ragged int8 pages device time: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa over dequantized "
        f"gathered pages {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{nbytes} B, {flops} flop); wall per call: kernel {t_k[1]:.4f}, "
        f"plain {t_p[1]:.4f}, sdpa {t_l[1]:.4f} ms")
    rows["paged_attention_ragged_int8"] = dict(
        name="paged_attention_ragged_int8", route="cuda",
        source="paddle_tpu_torch/csrc/paged_attention_int8.cu",
        replaces="paddle_tpu/ops/pallas/paged_attention.py:231",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
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
    say(f"{tag} decode_attention vs plain: max_abs_err {err:.3e} "
        f"(tol {TOL_KERNEL}) B {B} S {S}")
    require(err <= TOL_KERNEL, f"decode kernel disagrees: {err}")
    dmask = (torch.arange(S, device=device)[None, :]
             < lens[:, None])[:, None, None]
    t_k = _time_ms(torch, lambda: da.decode_attention(qd, kc, vc, lens),
                   device, iters)
    t_p = _time_ms(torch, lambda: da.decode_attention_reference(
        qd, kc, vc, lens), device, iters)
    t_l = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd[:, :, None], cache[0], cache[1], attn_mask=dmask), device,
        iters)
    ms, plain_ms, lib_ms = _device(t_k, t_p, t_l)
    tot = int(lens.sum())
    nbytes = 2 * B * H * hd * 4 + tot * H * hd * 2 * 4 + B * 4
    b_ms, b_by = _bound(nbytes, tot * 4 * hd * H)
    say(f"{tag} decode_attention device time: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {nbytes} B); wall per call: kernel {t_k[1]:.4f}, plain "
        f"{t_p[1]:.4f}, sdpa {t_l[1]:.4f} ms")
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="paddle_tpu_torch/csrc/decode_attention.cu",
        replaces="paddle_tpu/ops/pallas/decode_attention.py:86",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms)
    rows["w8a16_matmul"] = phase_w8a16(torch, device, cfg, tag, say)
    return rows


def phase_w8a16(torch, device, cfg, tag, say):
    """The w8a16 kernel against its plain version at 1, 8 and 256 rows for
    every projection of a layer and the head; each timed beside its
    bound, the plain version and torch.matmul over the weight dequantized
    beforehand. The kernels-line row sums one layer's four projections
    at 8 rows (a decode step)."""
    from paddle_tpu_torch.ops.hopper import int8_matmul as im
    d, ffn, V = cfg["d"], cfg["ffn"], cfg["vocab"]
    shapes = {"qkv": (d, 3 * d), "out_proj": (d, d), "ffn1": (d, ffn),
              "ffn2": (ffn, d), "head": (d, V)}
    iters = cfg["timing_iters"]
    layer = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                 max_abs_err=0.0, by=set())
    for name, (K, N) in shapes.items():
        gen = torch.Generator().manual_seed(K * 7 + N)
        w = torch.randint(-127, 128, (K, N), generator=gen,
                          dtype=torch.int8).to(device)
        wscale = torch.rand(N, generator=gen).to(device) / 127.0
        wdeq = w.float() * wscale          # the library call's operand
        for M in (1, 8, 256):
            x = torch.randn((M, K), generator=gen).to(device)
            got = im.w8a16_matmul(x, w)
            ref = im.w8a16_matmul_reference(x, w)
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            require(err <= TOL_W8A16 * scale, f"w8a16 {name} M {M} "
                    f"disagrees: {err} vs max|ref| {scale}")
            t_k = _time_ms(torch, lambda: im.w8a16_matmul(x, w), device,
                           iters)
            t_p = _time_ms(torch, lambda: im.w8a16_matmul_reference(x, w),
                           device, iters)
            t_l = _time_ms(torch, lambda: torch.matmul(x, wdeq), device,
                           iters)
            ms, plain_ms, lib_ms = _device(t_k, t_p, t_l)
            nbytes = M * K * 4 + K * N + M * N * 4
            b_ms, b_by = _bound(nbytes, 2 * M * K * N)
            say(f"{tag} w8a16_matmul {name} M {M} K {K} N {N}: max_abs_err "
                f"{err:.3e} (tol {TOL_W8A16 * scale:.3e}); device time "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, matmul over "
                f"the dequantized weight {lib_ms:.4f} ms, bound {b_ms:.4f} "
                f"ms ({b_by}; {nbytes} B); wall kernel {t_k[1]:.4f} ms")
            if M == 8 and name != "head":
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("library_ms", lib_ms),
                                 ("bound_ms", b_ms)):
                    layer[key] += val
                layer["max_abs_err"] = max(layer["max_abs_err"], err)
                layer["by"].add(b_by)
        del w, wdeq
    say(f"{tag} w8a16_matmul one layer's 4 projections at M 8: kernel "
        f"{layer['ms']:.4f} ms, plain {layer['plain_ms']:.4f} ms, matmul "
        f"{layer['library_ms']:.4f} ms, bound {layer['bound_ms']:.4f} ms")
    return dict(
        name="w8a16_matmul", route="cuda",
        source="paddle_tpu_torch/csrc/int8_matmul.cu",
        replaces="paddle_tpu/ops/pallas/int8_matmul.py:61",
        max_abs_err=layer["max_abs_err"], ms=layer["ms"],
        plain_ms=layer["plain_ms"], bound_ms=layer["bound_ms"],
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
                num_blocks, **engine_kw):
    """12 greedy requests through SpeculativeEngine(k=0) with mixed
    steps and preemption. Returns a dict: launches (per kernel), streams,
    the engine, the rows of every model call and the head calls."""
    from paddle_tpu_torch.inference import SpeculativeEngine
    from paddle_tpu_torch.ops.hopper import decode_attention as da
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
    for mod in (pa, da, im):
        mod.reset_launch_count()
    t0 = time.perf_counter()
    rids = [eng.submit(p) for p in prompts]
    done, rounds = {}, 0
    while len(done) < len(rids):
        rounds += 1
        require(rounds < 50 * len(rids), "serving did not converge")
        eng.step()
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
                "w8a16_matmul": im.launch_count()}
    hook.remove()
    del tsm.logits
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0
    outs = eng.outcomes
    preempt = sum(o.preemptions for o in outs)
    st = eng.engine.prefill_stats
    say(f"{tag} {label}: {len(rids)} requests x {n_new} tokens in "
        f"{secs:.3f} s = {len(rids) * n_new / secs:.2f} tokens/s; "
        f"{rounds} rounds, {len(rows)} model calls, {st.mixed_steps} "
        f"mixed steps, {preempt} preemptions "
        f"({eng.engine.resilience_stats.retried} re-admissions), "
        f"ragged launches {launches['paged_attention_ragged']} "
        f"(= {cfg['layers']} x {len(rows)} model calls), peak memory "
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
                cfg["layers"] * len(rows) > 0,
                f"ragged launches {launches} != layers x model calls")
    return dict(launches=launches, streams=streams, engine=eng, rows=rows,
                heads=len(heads))


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
    return launches, toks, pH


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
    dense_launches, toks, pH = phase_paged_vs_dense(
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
    rows["paged_attention_ragged"]["launches"] = \
        serve["launches"]["paged_attention_ragged"]
    rows["paged_attention_ragged_int8"]["launches"] = \
        qserve["launches"]["paged_attention_ragged"]
    rows["decode_attention"]["launches"] = \
        dense_launches["decode_attention"]
    rows["w8a16_matmul"]["launches"] = qserve["launches"]["w8a16_matmul"]
    return [rows[k] for k in ("paged_attention_ragged",
                              "paged_attention_ragged_int8",
                              "decode_attention", "w8a16_matmul")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
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
