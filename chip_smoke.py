#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero, and no result line is printed):

1. device  — a CUDA card must be present; prints its name and power limit.
2. build   — builds the fused sampler kernel (K1) from ``csrc/`` with nvcc.
3. K1      — the kernel against its plain PyTorch version at the slice's
             shape (2120 rows x 256 classes): bf16 and f32 logits, r 0 and
             0.85, t_post 0, 50 and 99; Philox determinism and sampled
             frequencies over 2000 seeds; kernel and plain times.
4. slice   — builds the flagship model from ``configs/diffsound_audiocaps.yaml``
             in bf16 on the card (19 layers, d1024, 16 heads, 265 tokens, full
             VQGAN decoder, MelGAN ngf 32) with seeded random weights, checks
             three sampler steps against a loop over the plain step, then
             answers two batch-8 requests of 100 steps each, caption BPE ids
             to wav, and checks what comes out and that every step went
             through the kernel.
5. times   — the second request's time and clips/s, beside the card's name
             and power limit.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' record. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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


def request(model, vocoder, cond_tokens, seed, dev):
    t0 = time.perf_counter()
    mel, tokens = model.generate(torch.Generator(dev).manual_seed(seed), cond_tokens,
                                 sample_type="top0.85r", return_tokens=True)
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

    t0 = time.perf_counter()
    fs.load_kernel()
    print(f"[2 build] K1 csrc/fused_sampler.cu -> sm_90a with {find_nvcc()}: "
          f"{time.perf_counter() - t0:.1f} s")

    print("[3 K1 vs plain]")
    max_err, k1_ms, plain_ms = phase_kernel(fs, dd, dev)

    print("[4 slice]")
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

    torch.cuda.reset_peak_memory_stats()
    fs.fused_p_sample.launches = 0
    times = [request(model, vocoder, cond_tokens, SEED + i, dev) for i in range(2)]
    launches = fs.fused_p_sample.launches
    print(f"  two requests of batch {BATCH} x {N_STEPS} steps: {times[0]:.3f} s, {times[1]:.3f} s; "
          f"K1 launches {launches}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches == 2 * N_STEPS, f"K1 launched {launches} times, expected {2 * N_STEPS}")

    print(f"[5 times] on {card}:")
    print(f"  K1 at (2120, 256): {k1_ms:.4f} ms, plain PyTorch step {plain_ms:.4f} ms")
    print(f"  second request (caption ids -> wav, batch {BATCH}, {N_STEPS} steps): "
          f"{times[1]:.3f} s = {BATCH / times[1]:.3f} clips/s")
    print(json.dumps({"kernels": [{
        "name": "fused_p_sample", "route": "cuda",
        "source": "text_to_sound_synthesis_torch/csrc/fused_sampler.cu",
        "replaces": "text_to_sound_synthesis_tpu/ops/fused_sampler.py:223",
        "launches": launches, "max_abs_err": max_err, "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
