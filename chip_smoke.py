#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero, and no result line is printed):

1. device  — a CUDA card must be present; prints its name and power limit.
2. build   — builds every kernel from ``csrc/`` with nvcc, one process per
             source, all at once: K1 (fused_sampler.cu), K3-K5
             (int8_block.cu) and K2 (fused_head_sample.cu).
3. K1      — the kernel against its plain PyTorch version at the slice's
             shape (2120 rows x 256 classes): bf16 and f32 logits, r 0 and
             0.85, t_post 0, 50 and 99; Philox determinism and sampled
             frequencies over 2000 seeds; kernel and plain times.
4. K2-K5   — the int8 block kernels against their plain versions at the
             flagship shapes (2120 x 1024, 16 heads, condition 8 x 77, MLP
             4096), W8 and W4, dynamic and static scales; K2 against its plain
             version and against K1 on the same logits; eager and CUDA-graph
             times, kernel and plain.
5. slice   — builds the flagship model from ``configs/diffsound_audiocaps.yaml``
             in bf16 on the card (19 layers, d1024, 16 heads, 265 tokens, full
             VQGAN decoder, MelGAN ngf 32) with seeded random weights, checks
             three sampler steps against a loop over the plain step, then
             answers two batch-8 requests of 100 steps each, caption BPE ids
             to wav, and checks what comes out and that every step went
             through K1.
6. serving — the W4A8 static-scale engine of the same model:
             ``quantize_for_serving(weight_bits=4)`` -> ``calibrate_serving_engine``
             on the smoke's captions -> three steps, kernels against the plain
             twins on one supplied noise (each block on the twins' input,
             and the 19-layer outputs and tokens) -> two batch-8, 100-step
             ``generate_int8`` requests to a wav, with the same output checks
             and exact launch counts (K4 = K5 = K3 = 19 x 100, K2 = 100, K1 = 0
             per request).
7. times   — each path's second request: time and clips/s, beside the card's
             name and power limit.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' record. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "diffsound_audiocaps.yaml")
SEED = 1234
BATCH, CTX, N_STEPS = 8, 77, 100
SOT, EOT = 49406, 49407
# K1 checks. Posterior log-probs agree to POST_ATOL (f32 log-space chains whose
# exp/log and sums run in another order in the kernel). With truncation, the
# bisection's comparisons (sum of p above tau < r, p > tau) are discontinuous:
# an ulp of difference in a sum can keep or drop one class at the nucleus
# boundary, which changes that row entirely. bf16 logits make such exact ties
# common. Up to BOUNDARY_ROWS of the rows may do so when r > 0; none may at r = 0.
POST_ATOL = 1e-4
BOUNDARY_ROWS = 1e-3
FREQ_SEEDS = 2000
# K3-K5 checks: bf16 block outputs within BLOCK_TOL (rtol and atol, as the
# JAX package's block tests). The integer dots are exact on both sides; the f32
# LayerNorm and softmax sums run in another order, so an ulp can move a value
# across a .5 step of the int8 grid ("int8 flips"), which moves a few outputs
# by a few bf16 ulps.
BLOCK_TOL = 2e-2
# K2 checks: its f32 LayerNorm sums run in another order than the plain
# version's, so an ulp can move a normalised value across a bf16 rounding
# boundary before the head ("bf16 flips"); one flip moves a logit by about
# |w| * 2^-8 * |xn|, 1e-3 at these weights. Posterior rows agree to
# K2_POST_ATOL; beyond it a row counts as a boundary row, as for K1 (none at
# r = 0). Tokens may differ in BOUNDARY_ROWS of the rows at any r (the logits
# are not bitwise equal, so a Gumbel near-tie can tip).
K2_POST_ATOL = 5e-3
N_LAYER, D_MODEL, N_HEAD, L_TOK, S_COND, D_MLP = 19, 1024, 16, 265, 77, 4096


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, reps: int = 50, replays: int = 10) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph, so the
    host's launch cost is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def phase_kernel(fs, dd, dev):
    """Phase 3: K1 against its plain version on the card; returns (max_abs_err, ms, plain_ms)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K = 257
    rng = np.random.default_rng(SEED)
    logits32 = torch.from_numpy((rng.standard_normal((BATCH, 265, K - 1)) * 3).astype(np.float32)).to(dev)
    xt = torch.from_numpy(rng.integers(0, K, (BATCH, 265)).astype(np.int32)).to(dev)
    gumbel = torch.from_numpy(rng.gumbel(size=(BATCH, 265, K)).astype(np.float32)).to(dev)
    sched = dd.make_schedule(N_STEPS, K, device=dev)
    rows = BATCH * 265
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        logits = logits32.to(dtype)
        for r in (0.0, 0.85):
            for t_post in (0, 50, 99):
                c = fs.step_coeffs(sched, t_post).as_array().contiguous()
                want_tok, want = fs.p_sample_from_indices(logits, xt, c, gumbel=gumbel,
                                                          truncation_r=r, return_log_probs=True)
                tok, got = fs.fused_p_sample(logits, xt, c, 11, 3, truncation_r=r, gumbel=gumbel,
                                             return_log_probs=True)
                torch.cuda.synchronize()
                err = (got - want).abs().amax(dim=-1).flatten()
                boundary = int((err > POST_ATOL).sum())
                tok_diff = int((tok != want_tok).sum())
                row_err = float(err[err <= POST_ATOL].max()) if boundary < rows else float("inf")
                max_err = max(max_err, row_err)
                print(f"  K1 {str(dtype):>14} r={r:<4} t_post={t_post:<2}  max|dpost| "
                      f"{row_err:.3e}  boundary rows {boundary}/{rows}  "
                      f"token mismatches {tok_diff}/{rows}")
                allowed = int(BOUNDARY_ROWS * rows) if r > 0 else 0
                check(boundary <= allowed, f"K1 posterior: {boundary} rows beyond {POST_ATOL}")
                check(tok_diff <= allowed, f"K1 tokens: {tok_diff} rows differ")

    # Philox: determinism, keying, and the sampled distribution
    c0 = fs.step_coeffs(sched, 0).as_array().contiguous()
    masked = torch.full_like(xt, K - 1)
    logits = (logits32 / 3).to(torch.bfloat16)     # broad posteriors at t=0 from all-MASK
    a = fs.fused_p_sample(logits, masked, c0, 5, 7)
    check(torch.equal(a, fs.fused_p_sample(logits, masked, c0, 5, 7)), "K1 Philox: same key, other tokens")
    diff_seed = int((a != fs.fused_p_sample(logits, masked, c0, 6, 7)).sum())
    diff_step = int((a != fs.fused_p_sample(logits, masked, c0, 5, 8)).sum())
    check(diff_seed > rows // 2 and diff_step > rows // 2, "K1 Philox: another key, same tokens")
    _, post = fs.p_sample_from_indices(logits, masked, c0, gumbel=gumbel, return_log_probs=True)
    probe_rows = torch.tensor([0, 777, 1500, rows - 1], device=dev)
    draws = torch.stack([fs.fused_p_sample(logits, masked, c0, s, 0).flatten()[probe_rows]
                         for s in range(FREQ_SEEDS)]).cpu().numpy()
    p = torch.exp(post.flatten(0, 1)[probe_rows]).cpu().double().numpy()
    p /= p.sum(axis=-1, keepdims=True)
    worst = 0.0
    for i in range(len(probe_rows)):
        freq = np.bincount(draws[:, i], minlength=K) / FREQ_SEEDS
        bound = 5.0 * np.sqrt(p[i] * (1 - p[i]) / FREQ_SEEDS) + 2.0 / FREQ_SEEDS
        worst = max(worst, float(np.max(np.abs(freq - p[i]) / bound)))
    print(f"  K1 Philox: other seed changes {diff_seed}/{rows} tokens, other step {diff_step}/{rows}; "
          f"frequencies over {FREQ_SEEDS} seeds within {worst:.2f} of the 5-sigma binomial bound")
    check(worst <= 1.0, "K1 Philox: sampled frequencies off the posterior")

    # times at the main path's call: bf16 logits, r = 0.85, the card's own draws
    c = fs.step_coeffs(sched, 50).as_array().contiguous()
    lb = logits32.to(torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(SEED)
    times = {}
    for name, fn in (("plain", lambda: fs.p_sample_from_indices(lb, xt, c, generator=gen, truncation_r=0.85)),
                     ("kernel", lambda: fs.fused_p_sample(lb, xt, c, 1, 2, truncation_r=0.85)),
                     ("kernel2", lambda: fs.fused_p_sample(lb, xt, c, 1, 2, truncation_r=0.85)),
                     ("plain2", lambda: fs.p_sample_from_indices(lb, xt, c, generator=gen, truncation_r=0.85))):
        times[name] = cuda_time_ms(fn)
    ms = min(times["kernel"], times["kernel2"])
    plain_ms = min(times["plain"], times["plain2"])
    print(f"  K1 time per eager call at (2120, 256) bf16, r=0.85: kernel {times['kernel']:.4f} / "
          f"{times['kernel2']:.4f} ms, plain {times['plain']:.4f} / {times['plain2']:.4f} ms "
          f"(run plain, kernel, kernel, plain)")
    g_kernel = graph_time_ms(lambda: fs.fused_p_sample(lb, xt, c, 1, 2, truncation_r=0.85))
    g_plain = graph_time_ms(lambda: fs.p_sample_from_indices(lb, xt, c, gumbel=gumbel, truncation_r=0.85))
    print(f"  K1 device time per call (CUDA graph of 50 calls): kernel {g_kernel:.4f} ms, "
          f"plain {g_plain:.4f} ms (plain with supplied noise)")
    return max_err, ms, plain_ms


def _ulp_flips(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements off by more than one bf16 ulp of the plain value: differences
    a single final rounding cannot explain (int8 flips upstream)."""
    w = want.float()
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133),
                      torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
    return int(((got.float() - w).abs() > ulp).sum())


def _block_err(got, want, what: str = "") -> float:
    g, w = got.float(), want.float()
    bad = (g - w).abs() > BLOCK_TOL + BLOCK_TOL * w.abs()
    check(not bool(bad.any()), f"{what}{int(bad.sum())} elements beyond {BLOCK_TOL}")
    return float((g - w).abs().max())


def phase_blocks(dev):
    """Phase 4: K3, K4, K5 against their plain versions at the flagship shapes.
    Returns {name: (max_abs_err, ms, plain_ms)} with times of the served mode
    (W4, static scales)."""
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops.quant import quantize_weight, quantize_weight_w4

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(dev).manual_seed(SEED)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=gen, device=dev) * scale
    M = BATCH * L_TOK
    x = rnd(M, D_MODEL).bfloat16()
    mod = rnd(2, D_MODEL, scale=0.2)
    ln = mod.clone()
    ln[0] += 1.0
    ck, cv = rnd(BATCH * S_COND, D_MODEL).bfloat16(), rnd(BATCH * S_COND, D_MODEL).bfloat16()
    dense = lambda n, k: (rnd(n, k, scale=0.03), rnd(n, scale=0.05))
    raw = {"attn": [dense(D_MODEL, D_MODEL) for _ in range(4)],
           "cross": [dense(D_MODEL, D_MODEL) for _ in range(2)],
           "mlp": [dense(D_MLP, D_MODEL), dense(D_MODEL, D_MLP)]}
    # static scales near the dynamic ones: in, out/mid
    static = {"attn": (0.035, 0.02), "cross": (0.035, 0.02), "mlp": (0.035, 0.012)}

    def calls(w4, st, q_valid=L_TOK, kv_valid=S_COND):
        q = quantize_weight_w4 if w4 else quantize_weight
        w = {k: [q(a, b) for a, b in v] for k, v in raw.items()}
        ss = (lambda k: static[k]) if st else (lambda k: None)
        kw = dict(w4=w4)
        return {
            "self_attn_block": (
                lambda: ib.self_attn_block(x, mod, *w["attn"], batch=BATCH, n_head=N_HEAD,
                                           q_valid=q_valid, static_s=ss("attn"), **kw),
                lambda: ib.self_attn_block_reference(x, mod, *w["attn"], batch=BATCH,
                                                     n_head=N_HEAD, q_valid=q_valid,
                                                     static_s=ss("attn"), **kw)),
            "cross_attn_block": (
                lambda: ib.cross_attn_block(x, mod, ck, cv, *w["cross"], batch=BATCH,
                                            n_head=N_HEAD, kv_valid=kv_valid,
                                            static_s=ss("cross"), **kw),
                lambda: ib.cross_attn_block_reference(x, mod, ck, cv, *w["cross"], batch=BATCH,
                                                      n_head=N_HEAD, kv_valid=kv_valid,
                                                      static_s=ss("cross"), **kw)),
            "mlp_block": (
                lambda: ib.mlp_block(x, ln, *w["mlp"], static_s=ss("mlp"), **kw),
                lambda: ib.mlp_block_reference(x, ln, *w["mlp"], static_s=ss("mlp"), **kw)),
        }

    errs = {}
    for w4 in (False, True):
        for st in (False, True):
            for name, (kern, plain) in calls(w4, st).items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = _block_err(got, want)
                errs[name] = max(errs.get(name, 0.0), err)
                print(f"  {name:<17} {'W4' if w4 else 'W8'} {'static ' if st else 'dynamic'}: "
                      f"max|d| {err:.3e}, elements off by > 1 bf16 ulp (int8 flips) "
                      f"{_ulp_flips(got, want)}/{got.numel()}")
    # masked keys: q_valid / kv_valid below the length
    valid = {"self_attn_block": L_TOK - 9, "cross_attn_block": S_COND - 20}
    masked = calls(True, True, *valid.values())
    for name, first in valid.items():
        kern, plain = masked[name]
        print(f"  {name:<17} W4 static, keys from {first} masked: "
              f"max|d| {_block_err(kern(), plain()):.3e}")

    times = {}
    for name, (kern, plain) in calls(True, True).items():
        t = {}
        for tag, fn in (("plain", plain), ("kernel", kern), ("kernel2", kern), ("plain2", plain)):
            t[tag] = cuda_time_ms(fn, iters=20, warmup=3)
        g_kern, g_plain = graph_time_ms(kern, reps=10, replays=5), graph_time_ms(plain, reps=3, replays=3)
        ms, plain_ms = min(t["kernel"], t["kernel2"]), min(t["plain"], t["plain2"])
        print(f"  {name:<17} W4 static, per call: eager kernel {t['kernel']:.4f} / "
              f"{t['kernel2']:.4f} ms, plain {t['plain']:.4f} / {t['plain2']:.4f} ms; "
              f"CUDA graph kernel {g_kern:.4f} ms, plain {g_plain:.4f} ms")
        times[name] = (errs[name], ms, plain_ms)
    return times


def phase_head(fs, dd, dev):
    """Phase 4 (cont.): K2 against its plain version, and against K1 on the
    same logits. Returns (max_abs_err, ms, plain_ms)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    K = 257
    M = BATCH * L_TOK
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    x = (torch.randn((M, D_MODEL), generator=gen, device=dev) * 2).bfloat16()
    norm = torch.stack([1 + 0.1 * torch.randn(D_MODEL, generator=gen, device=dev),
                        0.1 * torch.randn(D_MODEL, generator=gen, device=dev)])
    hw = (torch.randn((D_MODEL, K - 1), generator=gen, device=dev) * 0.1).bfloat16()
    hb = 0.1 * torch.randn(K - 1, generator=gen, device=dev)
    xt = torch.randint(0, K, (M,), generator=gen, device=dev, dtype=torch.int32)
    g = dd.gumbel_from_uniform(torch.rand((M, K), generator=gen, device=dev))
    sched = dd.make_schedule(N_STEPS, K, device=dev)
    max_err = 0.0
    for r in (0.0, 0.85):
        for t_post in (0, 50, 99):
            c = fs.step_coeffs(sched, t_post).as_array().contiguous()
            want_tok, want = fs.head_sample_reference(x, xt, norm, hw, hb, c, gumbel=g,
                                                      truncation_r=r)
            tok, got = fs.fused_head_sample(x, xt, norm, hw, hb, c, 11, 3, truncation_r=r,
                                            gumbel=g, return_log_probs=True)
            torch.cuda.synchronize()
            err = (got - want).abs().amax(dim=-1)
            boundary = int((err > K2_POST_ATOL).sum())
            tok_diff = int((tok != want_tok).sum())
            row_err = float(err[err <= K2_POST_ATOL].max()) if boundary < M else float("inf")
            max_err = max(max_err, row_err)
            print(f"  K2 r={r:<4} t_post={t_post:<2}  max|dpost| {row_err:.3e}  rows beyond 1e-4 "
                  f"{int((err > 1e-4).sum())}/{M}  boundary rows {boundary}/{M}  token "
                  f"mismatches {tok_diff}/{M}")
            check(boundary <= (int(BOUNDARY_ROWS * M) if r > 0 else 0),
                  f"K2 posterior: {boundary} rows beyond {K2_POST_ATOL}")
            check(tok_diff <= int(BOUNDARY_ROWS * M), f"K2 tokens: {tok_diff} rows differ")
    # K2's Philox draws are K1's on the same logits (the plain f32 logits)
    c = fs.step_coeffs(sched, 50).as_array().contiguous()
    logits = fs.head_logits(x, norm, hw, hb)
    k2 = fs.fused_head_sample(x, xt, norm, hw, hb, c, 5, 7, truncation_r=0.85)
    k1 = fs.fused_p_sample(logits[None].contiguous(), xt[None].contiguous(), c, 5, 7,
                           truncation_r=0.85)[0]
    torch.cuda.synchronize()
    diff = int((k1 != k2).sum())
    print(f"  K2 vs K1 on the same logits, Philox draws, r=0.85: {diff}/{M} tokens differ")
    check(diff <= int(BOUNDARY_ROWS * M), "K2 draws differ from K1's")

    t = {}
    kern = lambda: fs.fused_head_sample(x, xt, norm, hw, hb, c, 1, 2, truncation_r=0.85)
    plain = lambda: fs.head_sample_reference(x, xt, norm, hw, hb, c, generator=gen,
                                             truncation_r=0.85)
    for tag, fn in (("plain", plain), ("kernel", kern), ("kernel2", kern), ("plain2", plain)):
        t[tag] = cuda_time_ms(fn, iters=50)
    g_kern = graph_time_ms(kern)
    g_plain = graph_time_ms(lambda: fs.head_sample_reference(x, xt, norm, hw, hb, c, gumbel=g,
                                                             truncation_r=0.85))
    print(f"  K2 per call at (2120, 1024) -> 256, r=0.85: eager kernel {t['kernel']:.4f} / "
          f"{t['kernel2']:.4f} ms, plain {t['plain']:.4f} / {t['plain2']:.4f} ms; CUDA graph "
          f"kernel {g_kern:.4f} ms, plain {g_plain:.4f} ms (plain with supplied noise)")
    return max_err, min(t["kernel"], t["kernel2"]), min(t["plain"], t["plain2"])


def caption_ids(rng) -> torch.Tensor:
    """BPE ids of the form the tokenizer emits: SOT, word ids, EOT, zero padding."""
    ids = np.zeros((BATCH, CTX), np.int32)
    for b in range(BATCH):
        n = int(rng.integers(3, 12))
        ids[b, 0], ids[b, n + 1] = SOT, EOT
        ids[b, 1:n + 1] = rng.integers(256, 49000, n)
    return torch.from_numpy(ids)


def check_plain_loop(model, fs, dd, cond_tokens, dev):
    """Three sampler steps through generate() (kernel) against the same
    steps with the plain step, on one supplied noise."""
    from text_to_sound_synthesis_torch.models.diffusion.process import _timestep_plan

    diff = model.diffusion
    K, L = diff.num_classes, diff.content_seq_len
    ts, t_post = _timestep_plan(N_STEPS, N_STEPS, 49)
    noise = dd.gumbel_from_uniform(torch.rand((len(ts), BATCH, L, K), device=dev,
                                              generator=torch.Generator(dev).manual_seed(SEED)))
    _, got = model.generate(torch.Generator(dev).manual_seed(SEED), cond_tokens,
                            sample_type="top0.85r,fast49", noise=noise, return_tokens=True)
    with torch.no_grad():
        cond_emb = model.embed_condition(cond_tokens)
        tables, kvs = diff.ada_tables(), diff.cond_kvs(cond_emb)
        coeffs = fs.step_coeffs(diff.schedule(dev), t_post).as_array()
        tokens = torch.full((BATCH, L), K - 1, dtype=torch.int32, device=dev)
        for i, t in enumerate(ts):
            logits = diff.backbone_logits(tokens, cond_emb, torch.full((BATCH,), t, device=dev),
                                          mods=[(a[t:t + 1], b[t:t + 1]) for a, b in tables],
                                          cond_kvs=kvs)
            tokens = fs.p_sample_from_indices(logits, tokens, coeffs[i], gumbel=noise[i],
                                              truncation_r=0.85)
    mismatch = int((got != tokens).sum())
    print(f"  slice, 3 steps (top0.85r,fast49) kernel vs plain step: {mismatch}/{got.numel()} tokens differ")
    check(mismatch <= 0.01 * got.numel(), "slice: kernel steps disagree with the plain steps")


def request(generate, vocoder, seed, dev):
    """One request through ``generate(generator) -> (mel, tokens)`` and the
    vocoder, timed on the host clock up to a synchronize; checks the output."""
    t0 = time.perf_counter()
    mel, tokens = generate(torch.Generator(dev).manual_seed(seed))
    wav = vocoder((mel[..., 0].float() + 1.0) / 2.0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(bool(((tokens >= 0) & (tokens < 256)).all()), "slice: tokens outside [0, 256) (MASK left)")
    check(tuple(mel.shape) == (BATCH, 80, 848, 1), f"slice: mel shape {tuple(mel.shape)}")
    check(bool(torch.isfinite(mel).all()), "slice: mel not finite")
    check(tuple(wav.shape) == (BATCH, 848 * 256), f"slice: wav shape {tuple(wav.shape)}")
    check(bool(torch.isfinite(wav).all()), "slice: wav not finite")
    check(float(wav.abs().max()) <= 1.0, "slice: wav outside [-1, 1]")
    return seconds


def check_int8_loop(model, qp, fs, dd, cond_tokens, dev):
    """Three int8 sampler steps (the top0.85r,fast49 plan), kernels against
    the plain twins on one supplied noise. Each step starts both paths from
    the plain path's tokens, so a row that tips at one step does not change
    the next step's inputs. The plain path is the three block twins composed
    here, layer by layer; on its input each block kernel must agree with its
    twin to BLOCK_TOL, as in phase 4. The kernel path is the engine's own
    layer loop. Composed over 19 layers, an int8 flip in one block moves the
    next block's input, and at a static scale a bf16 ulp of a block input can
    move an int8 value by one step, so the two paths drift apart: their
    backbone outputs must agree to STEP_REL (relative, in norm), and at most
    STEP_ROWS of the rows may pick another token per step (near-ties of the
    Gumbel argmax and the nucleus boundary)."""
    from text_to_sound_synthesis_torch.models.diffusion import int8_runtime as rt
    from text_to_sound_synthesis_torch.models.diffusion.process import _timestep_plan
    from text_to_sound_synthesis_torch.ops import int8_block as ib

    STEP_ROWS, STEP_REL = 2e-2, 5e-2
    diff = model.diffusion
    L, K, T = diff.content_seq_len, diff.num_classes, diff.diffusion_step
    w4 = qp.weight_bits == 4
    ts, t_post = _timestep_plan(T, T, 49)
    noise = dd.gumbel_from_uniform(torch.rand((len(ts), BATCH, L, K), device=dev,
                                              generator=torch.Generator(dev).manual_seed(SEED)))
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    with torch.no_grad():
        kvs = rt.precompute_cond_kvs(qp, model.embed_condition(cond_tokens))
        coeffs = fs.step_coeffs(diff.schedule(dev), t_post).as_array().contiguous()
        tokens = torch.full((BATCH * L,), K - 1, dtype=torch.int32, device=dev)
        per_step, block_err, flips, n_out = [], 0.0, 0, 0
        for i, t in enumerate(ts):
            g = noise[i].reshape(BATCH * L, K)
            x = rt._int8_backbone_hidden(qp, tokens.reshape(BATCH, L), t, kvs)
            got = fs.fused_head_sample(x, tokens, qp.norm_out, qp.head_w, qp.head_b, coeffs[i],
                                       0, i, truncation_r=0.85, gumbel=g)
            xp = rt._embed(qp, tokens.reshape(BATCH, L))
            for n, (lyr, (ck, cv), (mod1, mod2), ls) in enumerate(
                    zip(qp.layers, kvs, rt._layer_mods(qp, t), qp.act_scales)):
                blocks = (
                    (ib.self_attn_block, ib.self_attn_block_reference,
                     (mod1, lyr.q.qw, lyr.k.qw, lyr.v.qw, lyr.proj.qw),
                     dict(batch=BATCH, n_head=qp.n_head, q_valid=L, static_s=rt._pair(ls[0:2]))),
                    (ib.cross_attn_block, ib.cross_attn_block_reference,
                     (mod2, ck, cv, lyr.crossq.qw, lyr.crossproj.qw),
                     dict(batch=BATCH, n_head=qp.n_head, kv_valid=ck.shape[0] // BATCH,
                          static_s=rt._pair(ls[2:4]))),
                    (ib.mlp_block, ib.mlp_block_reference, (lyr.ln2_mod, lyr.fc1.qw, lyr.fc2.qw),
                     dict(static_s=rt._pair(ls[4:6]))))
                for kern, plain, args, kw in blocks:
                    want = plain(xp, *args, w4=w4, **kw)
                    y = kern(xp, *args, w4=w4, **kw)
                    err = _block_err(y, want, f"serving step {i}, layer {n}, {kern.__name__}: ")
                    block_err = max(block_err, err)
                    flips, n_out = flips + _ulp_flips(y, want), n_out + want.numel()
                    xp = want
            want, _ = fs.head_sample_reference(xp, tokens, qp.norm_out, qp.head_w, qp.head_b,
                                               coeffs[i], gumbel=g, truncation_r=0.85)
            per_step.append((rel(x, xp), int((got != want).sum())))
            tokens = want
    rows = BATCH * L
    print(f"  serving, 3 steps (top0.85r,fast49) kernels vs plain twins, from the same tokens "
          f"each step: each block on the twins' input within rtol = atol = {BLOCK_TOL} "
          f"(max|d| {block_err:.3e}, elements off by > 1 bf16 ulp {flips}/{n_out}); after "
          f"{len(qp.layers)} layers backbone output relative error "
          f"{[f'{a:.2e}' for a, _ in per_step]}, tokens differing {[b for _, b in per_step]} "
          f"of {rows}")
    check(all(a <= STEP_REL and b <= STEP_ROWS * rows for a, b in per_step),
          "serving: kernel steps disagree with the plain steps")


def _counters():
    from text_to_sound_synthesis_torch.ops import fused_sampler as fs
    from text_to_sound_synthesis_torch.ops import int8_block as ib

    return {"K1": fs.fused_p_sample, "K2": fs.fused_head_sample, "K3": ib.mlp_block,
            "K4": ib.self_attn_block, "K5": ib.cross_attn_block}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA card visible to torch; the port's main path runs only on one",
              file=sys.stderr)
        return 1
    try:
        from text_to_sound_synthesis_torch.models import build_model
        from text_to_sound_synthesis_torch.models.melgan import MelGANGenerator, Vocoder
        from text_to_sound_synthesis_torch.ops import diffusion as dd
        from text_to_sound_synthesis_torch.ops import fused_sampler as fs
        from text_to_sound_synthesis_torch.utils.config import load_yaml_config
        from text_to_sound_synthesis_torch.utils.init import init_random_
    except ImportError as e:
        print(f"error: the port package is not beside this script ({e})", file=sys.stderr)
        return 1
    check("jax" not in sys.modules, "the port imported jax")

    dev = torch.device("cuda", 0)
    name, card = torch.cuda.get_device_name(0), card_line()
    print(f"[1 device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)

    from text_to_sound_synthesis_torch.utils.cuda_build import find_nvcc

    from text_to_sound_synthesis_torch.ops import int8_block as ib

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:   # one nvcc per source, all at once
        list(pool.map(lambda load: load(), (fs.load_kernel, ib.load_kernel, fs.load_head_kernel)))
    print(f"[2 build] csrc/fused_sampler.cu, int8_block.cu, fused_head_sample.cu -> sm_90a "
          f"with {find_nvcc()}: {time.perf_counter() - t0:.1f} s")

    print("[3 K1 vs plain]")
    max_err, k1_ms, plain_ms = phase_kernel(fs, dd, dev)

    print("[4 K2-K5 vs plain]")
    block_res = phase_blocks(dev)
    head_res = phase_head(fs, dd, dev)

    print("[5 slice]")
    cfg = load_yaml_config(CONFIG)
    cfg["model"]["params"]["dtype"] = "bfloat16"
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    with torch.device(dev):
        gen = MelGANGenerator(input_size=80, ngf=32, n_residual_layers=3)
    vocoder = Vocoder(init_random_(gen, torch.Generator(dev).manual_seed(SEED + 1)))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  model: {n_params / 1e6:.1f} M params in {model.dtype}, "
          f"{len(model.diffusion.transformer.blocks)} layers; built and initialised on the card "
          f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    cond_tokens = caption_ids(rng).to(dev)
    check_plain_loop(model, fs, dd, cond_tokens, dev)

    bf16_generate = lambda g: model.generate(g, cond_tokens, sample_type="top0.85r",
                                             return_tokens=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = [request(bf16_generate, vocoder, SEED + i, dev) for i in range(2)]
    bf16_counts = read_counts()
    print(f"  two requests of batch {BATCH} x {N_STEPS} steps: {times[0]:.3f} s, {times[1]:.3f} s; "
          f"launches {bf16_counts}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(bf16_counts["K1"] == 2 * N_STEPS,
          f"K1 launched {bf16_counts['K1']} times, expected {2 * N_STEPS}")

    print("[6 serving]")
    t0 = time.perf_counter()
    qp = model.quantize_for_serving(weight_bits=4)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model.calibrate_serving_engine(qp, torch.Generator(dev).manual_seed(SEED + 3), cond_tokens)
    torch.cuda.synchronize()
    print(f"  W4A8 engine: quantized in {t1 - t0:.1f} s, calibrated ({N_STEPS} plain dynamic "
          f"steps) in {time.perf_counter() - t1:.1f} s; layer 0 scales "
          f"{tuple(round(v, 5) for v in qp.act_scales[0])}")
    check(qp.weight_bits == 4 and len(qp.act_scales) == N_LAYER, "serving: engine not W4 static")
    check_int8_loop(model, qp, fs, dd, cond_tokens, dev)
    int8_generate = lambda g: model.generate_int8(qp, g, cond_tokens, sample_type="top0.85r",
                                                  return_tokens=True)
    torch.cuda.reset_peak_memory_stats()
    int8_times, int8_counts = [], {k: 0 for k in _counters()}
    expect = {"K1": 0, "K2": N_STEPS, "K3": N_LAYER * N_STEPS, "K4": N_LAYER * N_STEPS,
              "K5": N_LAYER * N_STEPS}
    for i in range(2):
        reset_counts()
        int8_times.append(request(int8_generate, vocoder, SEED + i, dev))
        counts = read_counts()
        check(counts == expect, f"serving: launches {counts} per request, expected {expect}")
        int8_counts = {k: int8_counts[k] + v for k, v in counts.items()}
    print(f"  two W4A8 static requests of batch {BATCH} x {N_STEPS} steps: {int8_times[0]:.3f} s, "
          f"{int8_times[1]:.3f} s; launches per request {expect}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print(f"[7 times] on {card}:")
    print(f"  K1 at (2120, 256): {k1_ms:.4f} ms, plain PyTorch step {plain_ms:.4f} ms")
    print(f"  bf16 path, second request (caption ids -> wav, batch {BATCH}, {N_STEPS} steps): "
          f"{times[1]:.3f} s = {BATCH / times[1]:.3f} clips/s")
    print(f"  W4A8 static path, second request (caption ids -> wav, batch {BATCH}, {N_STEPS} "
          f"steps): {int8_times[1]:.3f} s = {BATCH / int8_times[1]:.3f} clips/s")
    tpu = "text_to_sound_synthesis_tpu/ops/"
    src = "text_to_sound_synthesis_torch/csrc/"
    rows = [("fused_p_sample", "fused_sampler.cu", "fused_sampler.py:223", "K1",
             bf16_counts["K1"], (max_err, k1_ms, plain_ms)),
            ("fused_head_sample", "fused_head_sample.cu", "fused_sampler.py:300", "K2",
             int8_counts["K2"], head_res),
            ("mlp_block", "int8_block.cu", "int8_block.py:609", "K3", int8_counts["K3"],
             block_res["mlp_block"]),
            ("self_attn_block", "int8_block.cu", "int8_block.py:375", "K4", int8_counts["K4"],
             block_res["self_attn_block"]),
            ("cross_attn_block", "int8_block.cu", "int8_block.py:455", "K5", int8_counts["K5"],
             block_res["cross_attn_block"])]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + source, "replaces": tpu + replaces,
         "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": pms}
        for name, source, replaces, _, launches, (err, ms, pms) in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
