#!/usr/bin/env python3
"""Profile one warm request of each path of the PyTorch port on a CUDA card.

    python3 chip_profile.py [paths...]

Builds the flagship model as ``chip_smoke.py`` does (seeded random weights,
bf16, batch 8, 100 steps, ``top0.85r``), then for the bf16 path
(``generate``; path name ``bf16``), the W4A8 static-scale engine
(``quantize_for_serving(4)`` -> ``calibrate_serving_engine`` ->
``generate_int8``; ``w4``: with its default pair-packed MHA and under
``T2S_ATTN_MHA=base``) and the W8A8 dynamic engine
(``quantize_for_serving()``; ``w8``) on its block path, on its per-dense path
(``generate_int8(impl="pallas_dense")``) and under ``T2S_ATTN_PAIR=1
T2S_MLP_IMPL=chunked`` (K8, K9), the W4A8 engine with the int8 MHA
(``T2S_ATTN_INT8=1 T2S_ATTN_MHA=base``; ``int8mha``) and the W4A8 engine's
long-form request (``generate_long``, 2120 frames, 24 sampler rows;
``long``), the f32 one-hot reference sampler in ``bench.py``'s scope
(sampler + ``decode_code`` on an f32 copy, PyTorch's default precision;
``ref``), then K11 (``k11``), then one Stage-2 train step of the flagship in
f32 at batch 20 (``chip_smoke.FlagshipTrainer``: its config's solver block,
PyTorch's default precision; ``train``), the same with ``dtype: bfloat16``
(f32 parameters; ``train_bf16``), then one Stage-1 SpecVQGAN step
(``configs/vqgan_caps.yaml``'s codec, its PatchGAN, a seeded random LPAPS,
batch 8 of 80 x 848 mels, both optimizers, ``bench_train_stage1``'s
``vqgan_trainer``; ``stage1``) and one MelGAN step (batch 16 x 8192 samples,
its ``melgan_trainer``; ``vocoder``), both in f32 under PyTorch's default
precision, then the AR baseline of ``configs/ar_audiocaps.yaml`` in full
f32 as ``chip_smoke.py`` phase 10d builds it: one batch-8 request (265
cached decodes at top-k 100, then ``decode_code``; ``ar``) and one
``train_ar`` step at batch 8 of 80 x 848 mels (``ar_train``); first, if
named, ``chip_smoke.py`` phase 10e's HTTP server (W4A8 static, batch 8) over
one burst of 32 mel requests from 16 clients (``serve``, before the model
above is built; the profiler sees every thread's kernels, the wall is the
burst's): all of them, or the paths named. One
warm-up request,
one unprofiled request (host clock up to a synchronize), then one request
under ``torch.profiler``. The vocoder is left out. Then K11, which no request
runs, the same way: five ``gn_swish_conv`` calls at each of the flagship
decoder's five stages (its A/B tool's inputs), to split its time between its
launches (a single short call left the profiler without device rows on
three stages of five on the H100). Prints the card line, each path's request (or call) time, its
device time and idle share (1 - device time / unprofiled time), the sha256
of its tokens (all but the long form), and the kernels by device time.
Exits 1 without a CUDA card. Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

import chip_smoke as cs


def profile(name: str, run, what: str = "request without the vocoder") -> None:
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # kernel rows only: an aten op's row repeats the time of the kernels it launched
    device_ms = sum(e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA) / 1e3
    # a request that returns (mel, tokens): its tokens' digest, to hold two trees' requests
    tokens = (f"; tokens sha256 {hashlib.sha256(out[1].cpu().numpy().tobytes()).hexdigest()[:16]}"
              if isinstance(out, tuple) else "")
    print(f"[{name}] {what} {wall:.4f} s; device time {device_ms:.3f} ms; "
          f"idle share {1 - device_ms / (wall * 1e3):.3f}{tokens}")
    print(ka.table(sort_by="self_device_time_total", row_limit=24, max_name_column_width=90))


# a request's sampling, and its tokens returned beside the mel
REQ = dict(sample_type="top0.85r", return_tokens=True)
PATHS = ("bf16", "w4", "w8", "int8mha", "long", "ref", "k11", "train", "train_bf16", "stage1",
         "vocoder", "ar", "ar_train", "serve")


def profile_serve(dev) -> None:
    """``chip_smoke.py`` phase 10e's server (``--int8 --calibrate``, W4A8
    static, batch 8, linger 50 ms) on 127.0.0.1:0, its captions on
    ``$T2S_CLIP_BPE`` or the synthetic merge table: one burst of
    ``SERVE_BURST`` mel requests from ``SERVE_CLIENTS`` clients, as
    ``profile`` times a request."""
    import os
    import tempfile
    import threading

    from text_to_sound_synthesis_torch.tools import bench_serve, serve

    old = os.environ.get("T2S_CLIP_BPE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["T2S_CLIP_BPE"] = old or cs.write_merge_table(os.path.join(tmp, "merges.txt"))
        calib = os.path.join(tmp, "captions.txt")
        with open(calib, "w") as f:
            f.write("\n".join(bench_serve.CAPTIONS) + "\n")
        engine = serve.Engine(serve.get_args(
            ["--config_file", cs._flagship_yaml(os.path.join(tmp, "flagship_bf16.yaml")),
             "--ckpt", "random", "--seed", str(cs.SEED + 2), "--int8", "--calibrate", calib,
             "--batch", str(cs.BATCH), "--max_wait_ms", "50", "--port", "0"]))
        srv = serve.make_server(engine, "127.0.0.1", 0)
        host, port = srv.server_address
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            start = len(engine.timeline)
            profile(f"server burst, W4A8 static, batch {cs.BATCH}: {cs.SERVE_BURST} mel requests "
                    f"from {cs.SERVE_CLIENTS} clients",
                    lambda: bench_serve.burst(host, port, cs.SERVE_BURST, cs.SERVE_CLIENTS) and None,
                    what="burst")
            tl = engine.timeline[start:]
            dispatch = ", ".join(f"{t['dispatch_end'] - t['dispatch_start']:.3f}" for t in tl)
            fetch = ", ".join(f"{t['fetch_end'] - t['dispatch_end']:.3f}" for t in tl)
            print(f"  batches of the three bursts {[t['size'] for t in tl]}; per batch, dispatch "
                  f"(launches) {dispatch} s, then the wait for its fetch {fetch} s")
        finally:
            srv.shutdown()
            srv.server_close()
            engine.close()
            if old is None:
                os.environ.pop("T2S_CLIP_BPE", None)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    paths = set(sys.argv[1:] if argv is None else argv) or set(PATHS)
    if not paths <= set(PATHS):
        print(f"error: paths are {', '.join(PATHS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA card visible to torch", file=sys.stderr)
        return 1
    from text_to_sound_synthesis_torch.models import build_model
    from text_to_sound_synthesis_torch.utils.config import load_yaml_config

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    if "serve" in paths:
        profile_serve(dev)
    cfg = load_yaml_config(cs.CONFIG)
    cfg["model"]["params"]["dtype"] = "bfloat16"
    model = build_model(cfg, device=dev, seed=cs.SEED)
    cond = cs.caption_ids(np.random.default_rng(cs.SEED)).to(dev)
    gen = lambda: torch.Generator(dev).manual_seed(cs.SEED)
    if "bf16" in paths:
        profile("bf16", lambda: model.generate(gen(), cond, **REQ))
    if paths & {"w4", "int8mha", "long"}:
        qp = model.quantize_for_serving(weight_bits=4)
        model.calibrate_serving_engine(qp, gen(), cond)
    if "w4" in paths:
        profile("W4A8 static", lambda: model.generate_int8(qp, gen(), cond, **REQ))
        with cs.switches(T2S_ATTN_MHA="base"):
            profile("W4A8 static, bf16 MHA (T2S_ATTN_MHA=base)",
                    lambda: model.generate_int8(qp, gen(), cond, **REQ))
    if "w8" in paths:
        qp8 = model.quantize_for_serving()
        for impl in ("pallas", "pallas_dense"):
            profile(f"W8A8 dynamic {impl}",
                    lambda: model.generate_int8(qp8, gen(), cond, impl=impl, **REQ))
        with cs.switches(T2S_ATTN_PAIR="1", T2S_MLP_IMPL="chunked"):
            profile("W8A8 dynamic pallas, T2S_ATTN_PAIR=1 T2S_MLP_IMPL=chunked",
                    lambda: model.generate_int8(qp8, gen(), cond, **REQ))
    if "int8mha" in paths:
        with cs.switches(T2S_ATTN_INT8="1", T2S_ATTN_MHA="base"):
            profile("W4A8 static, int8 MHA",
                    lambda: model.generate_int8(qp, gen(), cond, **REQ))
    if "long" in paths:
        profile(f"W4A8 static generate_long, {cs.LONG_FRAMES} frames",
                lambda: model.generate_long(gen(), cond, duration_frames=cs.LONG_FRAMES, qp=qp))
    if "ref" in paths:
        ref = cs.reference_copy(model)
        with cs.pytorch_default_precision():
            with torch.no_grad():
                emb = ref.embed_condition(cond)
            profile("f32 one-hot reference, bench.py's scope",
                    lambda: cs.bench_scope(ref, emb, False, gen()), what="sampler + decode_code")
        del ref
    if "k11" in paths:
        from text_to_sound_synthesis_torch.ops.fused_gn_conv import gn_swish_conv
        from text_to_sound_synthesis_torch.tools import bench_gn_conv as gnt

        with torch.no_grad():
            for H, W, C in gnt.SHAPES:
                args = gnt.stage_inputs(H, W, C, dev)
                profile(f"K11 gn_swish_conv at ({gnt.B}, {H}, {W}, {C})",
                        lambda: [gn_swish_conv(*args, groups=gnt.GROUPS) for _ in range(5)],
                        what="five calls")
    if paths & {"train", "train_bf16", "stage1", "vocoder", "ar", "ar_train"}:
        del model
        torch.cuda.empty_cache()
    for path, dtype in (("train", "float32"), ("train_bf16", "bfloat16")):
        if path in paths:
            tr = cs.FlagshipTrainer(dev, dtype)
            with cs.pytorch_default_precision():
                tr.step()       # the optimizer's moments are made at the first step
                profile(f"Stage-2 train step, flagship {dtype}, batch {cs.TRAIN_BATCH}",
                        lambda: tr.step() and None, what="one step")   # no tokens to digest
            del tr
            torch.cuda.empty_cache()
    from text_to_sound_synthesis_torch.tools import bench_train_stage1 as bt

    if "stage1" in paths:
        state, step, mel, lr = bt.vqgan_trainer(dev, cs.SEED)
        with cs.pytorch_default_precision():
            step(state, mel, lr)
            profile(f"Stage-1 SpecVQGAN train step, vqgan_caps f32, batch {bt.VQGAN_BATCH}",
                    lambda: step(state, mel, lr) and None, what="one step")
        del state, step, mel
        torch.cuda.empty_cache()
    if "vocoder" in paths:
        state, step, wav = bt.melgan_trainer(dev, cs.SEED)
        with cs.pytorch_default_precision():
            step(state, wav)
            profile(f"MelGAN train step, f32, batch {bt.MELGAN_BATCH} x {bt.MELGAN_LEN}",
                    lambda: step(state, wav) and None, what="one step")
        del state, step, wav
        torch.cuda.empty_cache()
    if paths & {"ar", "ar_train"}:
        from text_to_sound_synthesis_torch.models.gpt import ar_sample
        from text_to_sound_synthesis_torch.tools import train_ar
        from text_to_sound_synthesis_torch.utils.dtype import full_f32

        arcfg = load_yaml_config(cs.AR_CONFIG)
        ar = train_ar.build_model(arcfg, dev, cs.SEED + 60)
        feats = torch.randn((cs.BATCH, 512, 1), generator=gen(), device=dev)
        feats = feats / feats.norm(dim=1, keepdim=True)
        steps = cs.AR_HW[0] * cs.AR_HW[1]

        def request():
            tokens = ar_sample(ar.gpt, feats, steps=steps, top_k=cs.AR_TOP_K, generator=gen())
            return ar.decode_to_img(tokens, cs.AR_HW), tokens

        with full_f32():
            if "ar" in paths:
                profile(f"AR baseline request, ar_audiocaps f32, batch {cs.BATCH}, {steps} "
                        f"tokens, top-k {cs.AR_TOP_K}", request, what="sampler + decode_code")
            if "ar_train" in paths:
                bs = int(arcfg["dataloader"]["batch_size"])
                opt = train_ar.build_optimizer(ar, bs * float(arcfg["model"]["base_learning_rate"]))
                mel = torch.rand((bs, *cs.MEL, 1), generator=gen(), device=dev) * 2 - 1
                train_ar.train_step(ar, opt, mel, feats)
                profile(f"AR train step, ar_audiocaps f32, batch {bs}",
                        lambda: train_ar.train_step(ar, opt, mel, feats) and None, what="one step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
