#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (paddle_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card; exits non-zero (printing no result) without one, or
when run outside a checkout of the repository. Phases, each of which
fails the run:

1. build the hand-written kernels from paddle_tpu_torch/csrc (nvcc, all
   sources in parallel) and print their register / shared-memory report;
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (float32, max abs error <= 1e-4),
   then time kernel, plain version and one PyTorch library call with
   CUDA events, beside the bytes/FLOP bound of the H100;
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
5. print the kernels line, the card line and, last, the contract line.
Every number printed carries the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np

# float32 everywhere; the matmuls and convolutions in full float32
TOL_KERNEL = 1e-4          # kernel vs plain version, max abs error
TOL_REL = 1e-5             # paged vs dense: hidden / logits, rel. to max
HBM_BYTES_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_S = 67e12        # H100 SXM float32 outside the tensor cores

FULL = dict(vocab=50304, d=1024, layers=24, heads=16, ffn=4096,
            block_size=16, max_batch=8, chunk_tokens=128, budget=512,
            n_requests=12, min_prompt=64, max_prompt=960, new_tokens=32,
            num_blocks=260, kernel_pool_blocks=640, timing_iters=20)


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
    return rows


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


def phase_serve(torch, device, cfg, tsm, prompts, tag, say):
    """12 greedy requests through SpeculativeEngine(k=0) with mixed
    steps and preemption. Returns (launches, streams)."""
    from paddle_tpu_torch.inference import SpeculativeEngine
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import paged_attention as pa
    calls = []
    hook = tsm.core.register_forward_pre_hook(lambda m, a: calls.append(1))
    eng = SpeculativeEngine(
        tsm, None, k=0, max_batch=cfg["max_batch"],
        block_size=cfg["block_size"], num_blocks=cfg["num_blocks"],
        chunk_tokens=cfg["chunk_tokens"],
        prefill_token_budget=cfg["budget"])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    n_new = cfg["new_tokens"]
    pa.reset_launch_count()
    da.reset_launch_count()
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
                "decode_attention": da.launch_count()}
    hook.remove()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else 0
    outs = eng.outcomes
    preempt = sum(o.preemptions for o in outs)
    st = eng.engine.prefill_stats
    say(f"{tag} serving: {len(rids)} requests x {n_new} tokens in "
        f"{secs:.3f} s = {len(rids) * n_new / secs:.2f} tokens/s; "
        f"{rounds} rounds, {len(calls)} model calls, {st.mixed_steps} "
        f"mixed steps, {preempt} preemptions "
        f"({eng.engine.resilience_stats.retried} re-admissions), "
        f"ragged launches {launches['paged_attention_ragged']} "
        f"(= {cfg['layers']} x {len(calls)} model calls), peak memory "
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
                cfg["layers"] * len(calls) > 0,
                f"ragged launches {launches} != layers x model calls")
    return launches, streams


def phase_paged_vs_dense(torch, device, cfg, tsm, prompts, tag, say):
    """Dense oracle vs paged engine on the same 4 prompts, teacher-forced
    with the dense engine's greedy tokens. Returns the dense path's
    launch counts."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            PagedServingEngine)
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
    need = sum(-(-(len(p) + n_new) // cfg["block_size"]) for p in prompts)
    paged = PagedServingEngine(core, 4, cfg["block_size"], need + 1,
                               chunk_tokens=cfg["chunk_tokens"],
                               prefill_token_budget=cfg["budget"])
    rid_of = {paged.submit(tsm.embed(p)): i for i, p in enumerate(prompts)}
    ph = [[] for _ in prompts]
    slot_req = {}
    while any(len(h) < n_new for h in ph):
        for rid, slot, h in paged.admitted:
            slot_req[slot] = rid_of[rid]
            ph[rid_of[rid]].append(h[0])
        paged.admitted.clear()
        x = np.zeros((4, 1, cfg["d"]), np.float32)
        for slot, i in slot_req.items():
            x[slot, 0] = tsm.embed([toks[i][len(ph[i]) - 1]])
        stepping = paged.active.copy()
        out = paged.step(torch.from_numpy(x).to(device))
        if out is not None:
            for slot in np.flatnonzero(stepping & paged.active):
                i = slot_req[int(slot)]
                ph[i].append(out[int(slot), 0])
                if len(ph[i]) == n_new:
                    del slot_req[int(slot)]
                    paged.release(int(slot))
    dH = torch.stack([torch.stack(h) for h in dh])     # [4, n_new, d]
    pH = torch.stack([torch.stack(h[:n_new]) for h in ph])
    dL, pL = tsm.logits(dH), tsm.logits(pH)
    err_h = float((dH - pH).abs().max())
    err_l = float((dL - pL).abs().max())
    tol_h = TOL_REL * float(dH.abs().max())
    tol_l = TOL_REL * float(dL.abs().max())
    top2 = dL.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).cpu().numpy()      # [4, n_new]
    ptoks = pL.argmax(-1).cpu().numpy()
    agree, first_small = 0, []
    for i in range(4):
        small = np.flatnonzero(gap[i] < tol_l)
        upto = int(small[0]) if small.size else n_new
        first_small.append(upto)
        require(list(ptoks[i, :upto]) == toks[i][:upto],
                f"request {i}: paged greedy tokens diverge before step "
                f"{upto} (the first top-two gap below {tol_l:.3e})")
        agree += int((ptoks[i] == np.array(toks[i])).sum())
    say(f"{tag} paged vs dense: hidden max_abs_diff {err_h:.3e} (tol "
        f"{tol_h:.3e} = {TOL_REL} x max|h|), logits max_abs_diff "
        f"{err_l:.3e} (tol {tol_l:.3e}); greedy tokens agree "
        f"{agree}/{4 * n_new}; first step with top-two gap < tol per "
        f"request: {first_small} (of {n_new}); dense decode launches "
        f"{launches['decode_attention']}")
    require(err_h <= tol_h and err_l <= tol_l,
            "paged and dense hidden rows disagree")
    return launches


def run(device, cfg, seed=0, say=print, card=None):
    """All phases on ``device``; returns the kernels line's rows."""
    import torch
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
    serve_launches, _ = phase_serve(torch, device, cfg, tsm, prompts, tag,
                                    say)
    dense_launches = phase_paged_vs_dense(torch, device, cfg, tsm, prompts,
                                          tag, say)
    rows["paged_attention_ragged"]["launches"] = \
        serve_launches["paged_attention_ragged"]
    rows["decode_attention"]["launches"] = \
        dense_launches["decode_attention"]
    return [rows["paged_attention_ragged"], rows["decode_attention"]]


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
