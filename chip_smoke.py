#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on a CUDA card, and check it.

    python3 chip_smoke.py

Phases (any failed check exits nonzero, and no result line is printed):

1. device  — a CUDA card must be present; prints its name and power limit;
             the eight token-grid permuters on ids on the card at their
             grids (PERMUTER_GRIDS): forward equal to the CPU's, reverse of
             forward the identity, no kernel launched.
2. build   — builds every kernel from ``csrc/`` with nvcc, one process per
             source, all at once: K1 (fused_sampler.cu), K3-K9 (int8_block.cu),
             T1-T3 (int8_probe.cu), K2 (fused_head_sample.cu), K10
             (mha_int8.cu) and K11 (gn_swish_conv.cu); prints each one's time.
3. K1      — the kernel against its plain PyTorch version at the slice's
             shape (2120 rows x 256 classes): bf16 and f32 logits, r 0 and
             0.85, t_post 0, 50 and 99; Philox determinism and sampled
             frequencies over 2000 seeds; kernel and plain times, and the
             kernel's at r = 0 (no threshold search), eager and in a CUDA
             graph.
4. K2-K11, T1-T3 — the int8 kernels against their plain versions at the
             flagship shapes (2120 x 1024, 16 heads, condition 8 x 77, MLP
             4096): the blocks K3-K5, W8 and W4, dynamic and static scales
             (K3 with static scales, W8 and W4, bit for bit),
             K4 and K5 (five launches a call: quantize pass, dots on the
             Hopper GEMM's int8 A mode, MHA, quantize pass, proj) with the
             bf16 MHA and with the pair-packed MHA the
             engine serves at this head width (held also to the share of
             outputs more than PAIR_BLOCK_ULPS off, a gate the blocks with the
             bf16 MHA must fail); their quantize pass bit for bit against its
             plain version on the CPU (AdaLN on rows with exact statistics,
             no norm on Gaussian rows; AdaLN on Gaussian rows within one int8
             step on QUANT_SHARE of the values); the wide quantize pass in
             front of K6's fc2 and the MLP middle of K3 and K9 (bf16 and f32
             rows of 4096, the row's own max, given maxima at 1, 4 and 16
             chunks, static) bit for bit against its plain version on the
             CPU; K2 against
             its plain version and against K1 on the same logits at 256, 512
             and 2048 classes (the repo's three codebooks); then, W8,
             dynamic and static, K6 at the per-dense path's six sites and
             single (each a quantize pass and one int8-A-mode dot: the pass
             counted), K7 (the Hopper MHA, mha_sm90.cuh) at 265 and 77 keys with
             and without masked tails, K8
             full and masked, K9 at 4 and 16 chunks (fc1, the wide pass, the
             chunked fc2); then K10, the int8
             MHA, the bf16 MHA with its softmax divide folded, and the
             pair-packed MHA, at 265
             and 77 keys with and without masked tails (their v four times
             larger), K10 also on the share of outputs more than K10_ULPS
             bf16 ulps off and the pair MHA on the share more than
             PAIR_MHA_ULPS off, gates the bf16 MHA must fail; K4, K5 (W8 and
             W4) and K8 with the int8 MHA, dynamic and static scales; eager
             and CUDA-graph times, kernel and plain, for K7 the time of
             ``scaled_dot_product_attention`` on the same tensors, and K10
             and the pair MHA in CUDA graphs at 265 and 77 keys beside K7
             and ``scaled_dot_product_attention``. K11 (no
             request path reaches it) at the flagship decoder's five stages
             (batch 8, bf16, 32 groups) against its twin within GN_TOL (two
             runs bit for bit equal), its
             gradient at GN_GRAD_SHAPE within GN_GRAD_TOL (its backward, given
             one upstream gradient, bit for bit the twin's VJP with cuDNN's
             deterministic algorithms; two runs of the Function's backward
             under the global settings bit for bit equal), the times of kernel,
             twin and the cuDNN composition, then its path, the port's
             ``tools/bench_gn_conv``; T1 (the dot probe) at 2176 x 1024 x 4096,
             its int cases bit for bit and bf16 -> f32 within the bound of an
             f32 sum, ``torch._int_mm`` and bf16 ``torch.matmul`` beside it,
             then its path, the port's ``tools/bench_kernel_dot``; T2 and T3
             (the MLP and self-attention ablation probes) at their tools'
             shapes (2176 x 1024 x 4096; 8 x 272 rows, keys from 265
             masked), each configuration against its twin (T2 ``dots_only``
             and ``mid_bf16`` bit for bit, the others within BLOCK_TOL, four
             of them also on the share of outputs more than T2_ULPS off, a
             gate K3's twin must fail; T3 with dynamic and static scales),
             ``torch._int_mm`` at fc1 and fc2 beside ``dots_only``, then their
             paths, the port's ``tools/bench_mlp_ablate`` and
             ``bench_attn_ablate``.
5. slice   — builds the flagship model from ``configs/diffsound_audiocaps.yaml``
             in bf16 on the card (19 layers, d1024, 16 heads, 265 tokens, full
             VQGAN decoder, MelGAN ngf 32) with seeded random weights, checks
             three sampler steps against a loop over the plain step, then
             answers two batch-8 requests of 100 steps each, caption BPE ids
             to wav, and checks what comes out and that every step went
             through K1 and no other kernel.
5b. one-hot — on the same bf16 model: (a) three steps of the one-hot
             reference sampler (``predict_start`` -> ``truncate_top_r`` ->
             ``q_posterior`` -> Gumbel argmax) against K1 on the same logits,
             each step from the one-hot chain's tokens, at r 0.85 and 0, on
             one supplied noise: posteriors within POST_ATOL (boundary rows
             at most BOUNDARY_ROWS of the rows at r 0.85, none at r 0), tokens
             in at most BOUNDARY_ROWS of the rows; the two samplers' three
             steps end to end within 1 % of the tokens; (b) three one-hot
             requests to a wav (``top100p``, ``top0.85r,q0.5``, ``top0.85r``
             with ``use_fused=False``), every kernel count 0; (c)
             ``reconstruct`` at (8, 80, 848, 1) and ``sample_grid`` at batch 2;
             (d) the codec written as a Lightning ``.ckpt`` and the vocoder as
             ``args.yml`` + a weight-normed ``best_netG.pt``, loaded on the
             card: ``decode_code`` bit for bit the source's, the wav within
             VOC_TOL; (e) ``bench.py``'s scope (sampler + ``decode_code``, no
             CLIP, no MelGAN) timed for an f32 copy on the one-hot sampler,
             the reference's algorithm, beside the bf16 fused path, in turns.
6. serving — the W4A8 static-scale engine of the same model:
             ``quantize_for_serving(weight_bits=4)`` -> ``calibrate_serving_engine``
             on the smoke's captions -> three steps, kernels against the plain
             twins on one supplied noise (each block on the twins' input,
             and the 19-layer outputs; tokens may differ only at near-ties
             within the score error of the rows that did not flip,
             ``_tie_band``, a gate that the kernel path under another noise
             and twice its drift must fail; that band within BAND_RATIO of
             a reference band from the plain twins alone, each kernel
             site's input moved by an ulp on REF_ULP_SHARE of its elements,
             a ceiling that twice the drift must exceed; K4 and K5 with the
             pair-packed MHA, the default at 16 heads of 64, also against
             the PAIR_LOOP_SHARE gate, which they fail with the bf16 MHA),
             and the three steps again under ``T2S_ATTN_MHA=base`` -> four batch-8,
             100-step ``generate_int8`` requests to a wav, in turns with the
             default switches and under ``T2S_ATTN_MHA=base`` (the bf16 MHA),
             with the same output checks and exact launch counts (K4 = K5 =
             K3 = 19 x 100, K2 = 100, the quantize pass 4 x 19 x 100, the
             pair MHA 2 x 19 x 100 by default and 0 under the switch, every
             other kernel, the wide pass, K11 and T1-T3 too, 0 per request).
7. W8      — the W8A8 dynamic engine, ``quantize_for_serving()``: three steps
             of the per-dense path (``impl="pallas_dense"``) and three of
             ``T2S_ATTN_PAIR=1 T2S_MLP_IMPL=chunked``, each kernel call against
             its twin as in phase 6; then seven batch-8, 100-step requests to a
             wav, in turns: the block path twice (the pair MHA 2 x 19 x 100),
             the per-dense path twice
             (K6 multi = 6 x 19 x 100, K7 = 2 x 19 x 100, the quantize pass 5
             x 19 x 100), pair + chunked
             twice (K8 = K9 chunked = 19 x 100) and pair + streamed once
             (K8 = K9 streamed = 19 x 100), K2 = 100 each, the wide pass 19 x
             100 each (K3's, K6's fc2, K9's middle), every other count 0.
8. int8 attention — the W4A8 engine of phase 6 under ``T2S_ATTN_INT8=1
             T2S_ATTN_MHA=base``: three steps checked as in phase 6, then two
             requests (K10 = 2 x 19 x 100, K4 = K5 = K3 = 19 x 100, K2 = 100);
             one W8 request of phase 7's engine under ``T2S_ATTN_PAIR=1
             T2S_ATTN_INT8=1`` (K8 = K3 = 19 x 100, K10 = 2 x 19 x 100, the
             wide pass 19 x 100).
9. long    — one W4A8 ``generate_long`` request, batch 8, 2120 frames: 24
             sampler rows in one sampler call (K2 = 100, K4 = K5 = K3 = 19 x
             100, the pair MHA 2 x 19 x 100), a finite (8, 80, 2120, 1) mel
             whose cross-fade agrees with its segments, then the wav in [-1,
             1].
10. train  — Stage-2 training. (a) the flagship from the YAML in f32
             (19 layers, d1024, 16 heads, 265 tokens; seeded random weights,
             the codec and CLIP frozen), its solver block (AdamW (0.9, 0.96),
             wd 4.5e-2 on the Linear weights, the plateau warmup scheduler, the
             clip at 0.5, EMA 0.99 every 25 steps), 30 steps at batch 20 on one
             batch (mels in [-1, 1], caption BPE ids), PyTorch's default
             precision (f32 matmuls, TF32 cuDNN convs): every loss and grad
             norm finite, the loss under step 1's draws lower at step 30 than
             at step 1, every parameter tensor moved, the EMA changed at step
             25 and at no other step, Lt_count summing to 600; the median
             step time, samples/s and peak memory. On a small config
             (``small_train_config``): (b) three steps on the card against
             the same steps on the CPU in full f32 on supplied draws, within
             TRAIN_RTOL / TRAIN_ATOL / TRAIN_SHARE; (c) 10 steps, a checkpoint,
             a fresh model restored from it, 5 more steps from each: bit for
             bit; (d) a one-rank NCCL group: three steps under DDP bit for bit
             the steps without; (e) the ``Solver`` over an in-memory dataset of
             BPE ids, two epochs with validation and in-training sampling (K1),
             then a fresh ``Solver`` resumed. (f) on phase 5's bf16 model and
             phase 6's W4A8 engine: ``sample_tokens_fused_sharded`` and
             ``sample_tokens_int8_sharded`` with two shards of batch 4 on the
             one card, 10 steps, each bit for bit its per-shard runs with the
             folded seeds, with exact launch counts (K1 = 20; K2 = 20, K3 = K4
             = K5 = 19 x 20, the pair MHA 2 x 19 x 20).
10b. stage-1 — Stage-1 and vocoder training, and the bf16 Stage-2 step; every
             kernel count 0 in each part. (a) the flagship codec's adversarial
             step: ``configs/vqgan_caps.yaml``'s codec (ch 128, 256 x 256
             codebook), its PatchGAN (ndf 64, 3 layers, BatchNorm), a seeded
             random LPAPS, batch 8 of 80 x 848 mels in [-1, 1], disc_start
             0, both optimizers, PyTorch's default precision, S1_STEPS steps
             on one batch: every metric finite, nll_loss lower at the last
             step than at the first, every codec and PatchGAN tensor moved,
             each BatchNorm updated exactly twice a step (the D phase's); the
             median step time, samples/s and peak memory. (b) a small config
             (codec ch 64, 16 x 64 mels, a 2-layer PatchGAN, LPAPS of 16 bins)
             three steps on the card against the CPU in full f32, each from
             the CPU's state, with a constant and with an adaptive
             discriminator weight, disc_start 1, lr 1e-5: metrics, gradients,
             weights and running statistics within S1_RTOL / S1_ATOL /
             S1_GRAD / S1_STATS. (c) the MelGAN step
             at ``bench_train_stage1``'s shape (batch 16 x 8192 samples, ngf
             32, 3 scales), VOC_STEPS steps on one batch: finite metrics,
             the mel reconstruction L1 (the diagnostic the reference keeps
             its best generator by) lower at the last step, every G and D
             tensor moved; its
             time and peak memory. (d) (b)'s codec as a Lightning ``.ckpt``
             into a Diffsound through ``build_model(load_codec=True)``:
             ``decode_code`` bit for bit; (c)'s generator as ``args.yml`` +
             ``best_netG.pt`` through ``load_vocoder``: the wav bit for bit.
             (e) phase 10 (a) again with ``dtype: bfloat16``: the parameters,
             AdamW's moments and the EMA f32, the loss under step 1's draws
             lower at step 30; its time beside (a)'s f32 step.
10c. eval  — evaluation, on phase 5's bf16 model: two of its requests give
             16 decoded 80 x 848 mels (K1 = 2 x 100). (a) Melception (309
             classes, all six taps, seeded random weights) at batch 16 on the
             card in full f32 against the same module on the CPU, within
             MELCEPTION_TOL per tap; its time a batch, GFLOP a mel, peak
             memory, and its error under TF32 convs for the record. (b)
             ``evaluate_folders`` over two directories of those mels (eight
             of each seed): FID, ISc, KID and KL finite. (c) the default
             ``ACTCaptioner`` (12-layer 768-wide encoder, 2-layer decoder,
             4368 words), seeded: beam 3 over four mels on the card against
             the CPU, the tokens equal or their first difference after a
             near-tie within CAPTION_TIE; ``caption_scores``. (d)
             ``griffin_lim``, 32 steps, on one mel's NNLS magnitudes, card
             against CPU (GL_CORR, GL_RMS, GL_SC), and ``mel_to_wav_np`` on
             the card. (a)-(d) launch no kernel. (e) ``eval_int8_drift
             --train_steps 40 --clips 24 --static --w4`` on the flagship from
             the YAML (weights drawn as flax's defaults, in full f32 whatever
             the earlier phases set), with exact launch counts (K1 = 2 x 3 x 100, K2 = 3 x
             100, K3 = K4 = K5 = 3 x 19 x 100, the pair MHA twice that); its
             gate, the seed floor above 0 and drift_ratio <= 1.5 (the JAX
             package's), is checked after phase 11's record. (f) (e) again
             under phase 8's switches, ``T2S_ATTN_INT8=1 T2S_ATTN_MHA=base``
             (K10 in K4 and K5), set for that call only: K10 = 2 x 3 x 19 x
             100, the pair MHA 0, the other counts (e)'s; (e)'s gate.
10d. AR   — in full f32 whatever earlier phases set; every kernel count 0
             (the AR baseline and the denoisers reach no Pallas kernel in the
             JAX package). (a) ``configs/ar_audiocaps.yaml``'s flagship
             (``GPTFeats`` 19 x d1024 x 16 heads, block 266, vocab 256, a
             Conv1d 512 -> 1024 embedder; the codec of (5, 53) tokens),
             seeded through ``train_ar.build_model``: two batch-8 requests of
             L2-normalised (8, 512, 1) features through ``sample`` (265
             cached decodes, top-k 100) and MelGAN to a wav; ``ar_sample``'s
             tokens from the same seed decode to the same mel; every token in
             its step's top 100 of one full forward of the emitted sequence;
             the cached decode, teacher-forced on it, equal to that forward
             within AR_F32_TOL; on a 2-layer copy at full width, greedy
             tokens on the card equal the CPU's or first differ at a near-tie.
             (b) two ``train_ar`` steps at batch 8 of 80 x 848 mels: finite
             losses, the codec unchanged, the decay group the decay mask,
             zero-gradient entries unchanged where undecayed and p (1 - lr
             wd)^2 where decayed, every tensor with a gradient moved; a
             2-layer copy's first loss and gradient norm card against CPU.
             (c) ``Condition2SpecTransformer`` and
             ``UnCondition2SpecTransformer`` at the JAX defaults (DENOISERS),
             one forward each, card against CPU within AR_F32_TOL.
10e. entry — the user-facing tools, as a user runs them, on the flagship YAML
             with ``dtype: bfloat16`` and seeded weights, each tool building
             its own model on the card; captions tokenized with
             ``$T2S_CLIP_BPE`` where it is set, else the synthetic merge
             table ``BPE_MERGES`` written to a temporary directory (the phase
             says which, and whether ``regex`` is importable). (a) the fixed
             captions of ``TOKENIZER_IDS`` (non-ASCII words among them) give
             the JAX package's ids on the synthetic table. (b) the generate
             CLI in-process (``main(argv)``): two captions x ``--replicate
             4``, batch 8, with ``--vocoder`` on the phase's MelGAN written
             as in 5b (d): 8 ``.npy`` + 8 ``.wav``, the mels bit for bit
             ``Diffsound.generate``'s on a generator seeded ``--seed`` (K1 =
             100); then ``--int8 --duration 25 --batch 1``: a wav of
             round(25 x 22050 / 256) x 256 samples (K2 = 100). (c) the HTTP
             server (``--int8 --calibrate``: W4A8 static, ``--batch 8
             --max_wait_ms 50``) on 127.0.0.1:0: ``/healthz``; eight
             concurrent requests of one caption form one batch whose mels are,
             as a set, bit for bit a direct ``generate_int8`` on the same
             captions with the generator in the same state, its launches phase
             6's request's; a 400 and a 404; a burst of 32 mel requests from
             16 clients and 2 wav requests, all 200, at least one dispatch
             begun before the previous batch's fetch ended (the collector's
             and fetcher's timestamps); the burst again without the wavs;
             clips/s, p50 and p95 of each, reported, not gated; then a bf16
             server of batch 1 at
             ``--queue_limit 1``: two requests answered, the third 429. (d)
             ``bench_serve`` in-process at ``--requests 16 --clients 8
             --batch 8``: its JSON line, every request answered.
10f. tail — the long tail. (a) ``configs/ar_audiocaps.yaml``'s flagship with
             ``dtype: bfloat16`` against the same weights in f32 (TF32 off):
             greedy 265 tokens at batch 8, the share equal and each row's
             first difference at a near-tie of the f32 logits on the shared
             prefix, within twice AR_BF16_REL of the largest |f32 logit|;
             the logits on the f32 sequence within AR_BF16_REL of it (a
             limit fixed from readings); a request each way, its time,
             device time and idle share; every kernel count 0. (b)
             ``train_ar``'s step under a one-rank NCCL group (the GPT under
             DDP, lr = 1 x bs x base_lr) two steps bit for bit the steps
             without. (c) the flagship Stage-2 loss at batch 20 with the
             denoiser's ``checkpoint`` on and off: the loss and every
             gradient bit for bit, or within TRAIN_RTOL (it says which);
             whole steps each way in turns, peak memory lower with it; both
             times. (d) ``train_classifier``'s step, Melception (309
             classes) and VGGishish (VGG16 layers, ``use_bn`` both ways) at
             batch 16 of 80 x 848 in full f32: the first step on the card
             against the CPU (CLS_* gates: the loss, the gradients, the
             running statistics; the weights AdamW's first step on the
             card's gradients), two more on the card alone, Melception's
             running statistics untouched; a step's time. (e) the CLIP
             ViT-B/32 vision tower (224 px, batch 16) card against CPU
             within VIT_TOL, its time.
             (f) ``vis_codebook`` on a seeded 10 s wav through
             ``configs/vqgan_caps.yaml``'s seeded codec written as a
             ``.ckpt`` and MelGAN: the 5 x 53 grid equal to ``VQModel.encode``
             on the CPU, the bitrate line 265 x 8 bits over the clip's
             seconds. (g) ``run_parity_gate`` in smoke mode on a proxy
             ``.pth`` of phase 5's weights (``{'model', 'ema'}``),
             ``--replicate 2 --batch 2``, bf16 and ``--int8``: no FAIL, the
             SKIPs naming the absent reference, its samples bit for bit
             ``tools/generate.py``'s, exact launch counts (K1 = 100; K2 =
             100, K3 = K4 = K5 = Kw = 19 x 100, Kp = 2 x 19 x 100). (h)
             ``dryrun.entry()`` on the card, finite; ``dryrun_multichip(1)``
             under NCCL in a spawned process (JAX's mesh at one card: (1, 1)).
10g. model axis — the flagship ``Text2SpecTransformer``'s Stage-2 step
             (seeded weights from the YAML, f32 with TF32 off, batch 4 of
             random codes and unit-norm conditions, supplied draws, AdamW with
             the decay mask, the OR-ed clip, the ``Lt`` update) at a model axis
             of 2 (``parallel.sharding.MegatronText2Spec``): two spawned
             processes on the one card in a gloo group (NCCL refuses two ranks
             on one device; gloo stages the all-reduces and all-gathers through
             the host). Held against one process on the same card, weights,
             batch and draws: the loss and the gradient norm within rtol 1e-5,
             the gathered gradients within 1e-5 of the largest, the updated
             weights within 1e-6 (2 lr where a gradient is within 1e-5 of the
             largest of zero), t and ``Lt_count`` equal; the ranks' replicated
             gradients and weights bit for bit equal. Both steps' times (the
             median of MA_STEPS after the first), the model group's all-reduce
             and all-gather count and bytes a step. No kernel of the port runs
             in it.
11. times  — each path's request time and clips/s, phase 5b's reference and
             fused times in bench.py's scope, the train steps' times (Stage 2
             in f32 and bf16, Stage 1, MelGAN, the AR baseline), the
             evaluation's, the AR request's, the server burst's, phase 10f's
             (the AR request in f32 and bf16, the checkpointed step, the
             classifier steps, the ViT, the gate), phase 10g's two steps,
             beside the card's name and power limit. Every request phase
             counts K11 and T1-T3 at 0.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' record, each kernel with its bound at the timed shapes (the
largest of its bytes over the memory rate, its dots over the tensor cores'
peak rates and its f32 work over the f32 peak). Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
MEL = (80, 848)                 # the flagship's mel: bins, frames
VOC_ARGS = {"n_mel_channels": 80, "ngf": 32, "n_residual_layers": 3}   # MelGAN's args.yml
# K1 checks. Posterior log-probs agree to POST_ATOL (f32 log-space chains whose
# exp/log and sums run in another order in the kernel). With truncation, the
# bisection's comparisons (sum of p above tau < r, p > tau) are discontinuous:
# an ulp of difference in a sum can keep or drop one class at the nucleus
# boundary, which changes that row entirely. bf16 logits make such exact ties
# common. Up to BOUNDARY_ROWS of the rows may do so when r > 0; none may at r = 0.
POST_ATOL = 1e-4
BOUNDARY_ROWS = 1e-3
FREQ_SEEDS = 2000
# K3-K9 checks: bf16 block outputs within BLOCK_TOL (rtol and atol, as the
# JAX package's block tests). The integer dots are exact on both sides; the f32
# LayerNorm and softmax sums run in another order, so an ulp can move a value
# across a .5 step of the int8 grid ("int8 flips"), which moves a few outputs
# by a few bf16 ulps.
BLOCK_TOL = 2e-2
# K10 against its twin, besides BLOCK_TOL: the integer dots are exact, so
# only P's int8 rounding may differ (a P value on a .5 step of its grid after
# an ulp of exp). That moved 0.08-1.04 % of the outputs by more than one bf16
# ulp (H100 runs, PERF.md); at most K10_SHARE of them may lie more than
# K10_ULPS ulps off. The bf16 MHA lies that far from the int8 twin on about
# half of the outputs, so the phase also checks that this gate fails it.
K10_ULPS, K10_SHARE = 2, 2e-2
# The pair-packed MHA against its twin, besides BLOCK_TOL: the same f32 ops in
# another order (both heads' sums, the P V sums), so an output moves by one
# bf16 ulp where its f32 value lies near a rounding step, and by more only
# where a rounded p moved too: on the H100 at most 199 of 2170880 outputs
# (9.2e-5) lay more than one ulp off, none at the GPU tests' small shape
# (PERF.md). At most PAIR_MHA_SHARE of them may. The bf16 MHA, which divides
# before P's rounding, lies that far from the pair twin on 0.9-16 % of the
# outputs (0.3 % at the small shape), so the phase checks that it fails.
PAIR_MHA_ULPS, PAIR_MHA_SHARE = 1, 5e-4
# K4 / K5 with the pair MHA against their pair twins: any int8 block's flips
# and the MHA's, 0.03-0.50 % of the outputs more than one ulp off at phase
# 4's inputs on the H100; the same blocks with the bf16 MHA lie 8.1-19.5 % off
# the pair twins there, and must fail the gate. In the serving loop (the
# calibrated W4A8 engine on the model's activations, three steps together)
# the two read 0.024 % and 2.6 %: PAIR_LOOP_SHARE there.
PAIR_BLOCK_ULPS, PAIR_BLOCK_SHARE, PAIR_LOOP_SHARE = 1, 2e-2, 2.5e-3
# K8 in the serving loop: its two halves run on the model's activations with
# no reset to the twins' input between them, so an int8 flip of the self half
# reaches the cross half, as two blocks composed; JAX holds its pair kernel to
# 3e-2 for the same reason (tests/test_int8_blocks.py, test_attn_pair_block).
# Under dynamic scales on these activations a flip can also tip a near-tie of
# the self-attention's softmax, which moves a whole (query, head) output; K4
# alone then misses BLOCK_TOL on up to 33 of 2170880 elements (1.9 x the
# bound, on the H100; PERF.md). So up to PAIR_OUTLIERS of K8's outputs may lie
# beyond PAIR_TOL there.
PAIR_TOL, PAIR_OUTLIERS = 3e-2, 1e-5
# The int8 loops' token gate (``check_int8_loop``): a row may pick another
# token than the plain path's only at a near-tie, where the plain margin lies
# within the score error the kernel path shows on the rows that did not flip,
# at its TIE_QUANTILE quantile (``_tie_band``, ``_flip_rows``). Two controls
# must fail it: the kernel path's step under another noise, and the plain
# backbone output plus DRIFT_CONTROL times the kernel path's drift from it,
# judged against the kernel path's band. At 2x the drift stays within
# STEP_REL, so this gate alone has to catch it.
TIE_QUANTILE, DRIFT_CONTROL = 0.99, 2.0
# The band comes from the path under test, so a fault that raises every
# row's error alike widens it as much as the flips. Its ceiling comes from the
# plain twins alone: the plain path run again with each kernel site's input
# moved by one bf16 ulp, of a seeded sign, on REF_ULP_SHARE of its elements
# (``_ulp_nudge``; at a static scale such an ulp can move an int8 value by one
# step, the divergence the kernel path may show), whose band against the
# unmoved plain path is the reference band. The kernel path's band, in both
# components and at every step, must be at most BAND_RATIO times it
# (``_band_within``); the plain output plus DRIFT_CONTROL times the kernel
# path's drift, a uniform rise of every row's error, must exceed it. On the
# H100, at every step of the four loops of phases 6-8 (W4A8 pair MHA, W8
# per-dense, W8 pair + chunked, W4A8 int8 MHA), the kernel path's band read
# 0.80-0.96 of the reference band at a share of 1/8 and the control's
# 1.53-1.90, in both components (0.63-0.92 and 1.23-1.79 at a share of 1/2,
# 0.53-0.85 and 1.03-1.64 at 1): one ratio parts them with room on each side.
REF_ULP_SHARE, BAND_RATIO = 0.125, 1.2
# The quantize pass on Gaussian rows with AdaLN: the f32 LayerNorm sums run
# in another order than the twin's, so an ulp of the statistics can move a
# value across a .5 step of the int8 grid: the H100 read 0-3 of 2170880;
# at most QUANT_SHARE of them may move, by one.
QUANT_SHARE = 1e-4

# K2 checks: its f32 LayerNorm sums run in another order than the plain
# version's, so an ulp can move a normalised value across a bf16 rounding
# boundary before the head ("bf16 flips"); one flip moves a logit by about
# |w| * 2^-8 * |xn|, 1e-3 at these weights. Posterior rows agree to
# K2_POST_ATOL; beyond it a row counts as a boundary row, as for K1 (none at
# r = 0). Tokens may differ in BOUNDARY_ROWS of the rows at any r (the logits
# are not bitwise equal, so a Gumbel near-tie can tip).
K2_POST_ATOL = 5e-3
# K11 against its twin, bf16 out (cuDNN's TF32 off for the twin, though with
# bf16-valued operands TF32 would round nothing): the group statistics and the
# conv's f32 sums run in another order, so an f32 value can round to the
# other bf16 neighbour, one bf16 ulp, at most 2^-7 of the value; an
# activation rounded the other way moves an output by |k| 2^-8 |a|, far less.
# Gradients of sum(y.float()^2) through the Function (kernel forward, the
# twin's VJP) and through the twin differ only where y does (the upstream 2 y):
# within GN_GRAD_TOL of each gradient's largest value (the H100 read up to
# 0.42 %, the kernel's gradient, PERF.md). Given one upstream gradient, the
# Function's backward is the twin's VJP recomputed, the same ops on the same
# values: bit for bit equal once cuDNN runs its deterministic algorithms (its
# default backward convs add with atomics, so the twin's VJP itself differs
# from run to run, on the H100 up to 1.1e-4 of x's largest gradient).
GN_TOL, GN_GRAD_TOL = 1e-2, 1e-2
GN_GRAD_SHAPE = (8, 20, 212, 256)
# T2's configurations against their twins: dots_only (integers end to end)
# and mid_bf16 (every op of the middle rounded to bf16 in the twin's order,
# its row scale too) bit for bit, as they read on the H100; the others within
# BLOCK_TOL. mid_bf16b and mid_bf16c change K3's middle by a bf16 rounding,
# so K3's twin misses BLOCK_TOL on only 238-335 of their 2228224 outputs; they,
# fast_sigmoid and no_gelu are also held to at most T2_SHARE of their outputs
# more than T2_ULPS off (the kernels read up to 0.31 % on the H100), a gate
# that K3's twin (and for mid_bf16b / c the other's twin) must fail (27-99 %).
T2_EXACT = ("dots_only", "mid_bf16")
T2_ULPS, T2_SHARE = 1, 3e-2
T2_CONTROLS = {"mid_bf16b": ("K3", "mid_bf16c"), "mid_bf16c": ("K3", "mid_bf16b"),
               "fast_sigmoid": ("K3",), "no_gelu": ("K3",)}
# T1 bf16 -> f32: exact products, f32 sums in another order; each side lies
# within 2 K 2^-24 sum_k |x_k w_k| of the exact sum even where the tensor
# cores' adds truncate (2^-23 per add), so the two within DOT_BOUND_K times
# K 2^-24 sum_k |x_k w_k| of each other. The int cases are exact.
DOT_BOUND_K = 4
# The vocoder loaded from a weight-normed best_netG.pt against the one in
# memory: folding g * v / |v| can move a weight by an f32 ulp (|v| sums in
# another order), which the 31 convs carry to the wav, in [-1, 1].
VOC_TOL = 1e-4
N_LAYER, D_MODEL, N_HEAD, L_TOK, S_COND, D_MLP = 19, 1024, 16, 265, 77, 4096
LONG_FRAMES = 2120

# The least time the card could take for a kernel's work: the largest of the
# bytes it must move (each input read once, each output written once) over
# the memory rate, its dots over the tensor cores' peak rates, and its f32
# work over the f32 peak (``_bound``).
# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
# f32 operations per (row, class) that the sampler step's function needs
# (K1, K2's tail): log-softmax 4, the posterior's log-add-exps 10, the Gumbel
# add and argmax 2. The nucleus threshold's search is the algorithm's cost (a
# bisection in the kernels), not counted.
SAMPLER_OPS = 16
# f32 operations per input element of K11 besides its products: the
# statistics 3 (x, x^2, their sums), the affine 2, swish 5 (negate, exp, add,
# reciprocal, multiply)
GN_F32_OPS = 10


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


# each permuter's grid on the card: the codec's (5, 53) token grid, the
# spirals' even square, Subsample's power-of-two square
PERMUTER_GRIDS = {"Identity": (5, 53), "ColumnMajor": (5, 53), "ZCurve": (5, 53),
                  "Random": (5, 53), "AlternateParsing": (5, 53), "SpiralOut": (8, 8),
                  "SpiralIn": (8, 8), "Subsample": (4, 4)}


def phase_permuters(dev):
    """Phase 1's permuter check (module docstring): each of the eight on a
    batch of ids on the card, forward equal to the CPU's, reverse the
    identity; no kernel launched."""
    from text_to_sound_synthesis_torch.ops import permuter

    reset_counts()
    for name, (H, W) in PERMUTER_GRIDS.items():
        p = getattr(permuter, name)(H, W)
        x = torch.randint(0, 1 << 20, (BATCH, H * W), generator=torch.Generator().manual_seed(SEED))
        fwd = p(x.to(dev))
        check(fwd.device == dev and torch.equal(fwd.cpu(), p(x)),
              f"permuter {name}: the card's forward differs from the CPU's")
        check(torch.equal(p(fwd, reverse=True).cpu(), x), f"permuter {name}: reverse(forward) "
              "is not the identity on the card")
    check(read_counts() == expected_counts(), f"permuters: kernel launches {read_counts()}")
    grids = ", ".join(f"{k} {h}x{w}" for k, (h, w) in PERMUTER_GRIDS.items())
    print(f"  the eight permuters on the card ({grids}), batch {BATCH}: forward equal to the "
          "CPU's, reverse(forward) the identity; no kernel launched")


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
    # what sets K1's pace besides the threshold search: r = 0 skips it
    k1_r0 = lambda: fs.fused_p_sample(lb, xt, c, 1, 2)
    print(f"  K1 at r=0 (no threshold search) beside r=0.85: eager {cuda_time_ms(k1_r0):.4f} / "
          f"{ms:.4f} ms, CUDA graph {graph_time_ms(k1_r0):.4f} / {g_kernel:.4f} ms")
    return max_err, ms, plain_ms


def _ulp_flips(got: torch.Tensor, want: torch.Tensor, ulps: int = 1) -> int:
    """Elements off by more than ``ulps`` bf16 ulps of the plain value: at
    one, differences a single final rounding cannot explain (int8 flips
    upstream)."""
    w = want.float()
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133),
                      torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
    return int(((got.float() - w).abs() > ulps * ulp).sum())


def _ulp_gate(what: str, got, want, ulps: int, share: float, controls=()) -> int:
    """At most ``share`` of ``got``'s elements may lie more than ``ulps`` bf16
    ulps off ``want``, and each control, (label, tensor) of another function
    on the same inputs, must not pass that gate. Prints the readings and
    returns got's count."""
    n, far = want.numel(), _ulp_flips(got, want, ulps)
    ctrl = [(label, _ulp_flips(c, want, ulps)) for label, c in controls]
    print(f"  {what}: elements more than {ulps} bf16 ulps off {far}/{n} (gate {share})"
          + "".join(f"; {label} {c}/{n}" for label, c in ctrl))
    check(far <= share * n, f"{what}: {far}/{n} elements more than {ulps} bf16 ulps off")
    for label, c in ctrl:
        check(c > share * n, f"{what}: the gate passes {label}")
    return far


def _block_err(got, want, what: str = "", tol: float = BLOCK_TOL,
               outliers: float = 0.0):
    """max |d| of got against want; fails if more than ``outliers`` of the
    elements lie beyond rtol = atol = ``tol``. Returns (max |d|, elements
    beyond)."""
    g, w = got.float(), want.float()
    d, bound = (g - w).abs(), tol + tol * w.abs()
    n_bad = int((d > bound).sum())
    check(n_bad <= outliers * d.numel(), f"{what}{n_bad} elements beyond {tol} (worst at "
          f"{float((d / bound).max()):.2f} x the bound, max|d| {float(d.max()):.3e})")
    return float(d.max()), n_bad


def time_pair(label: str, kern, plain):
    """Eager times per call, run plain, kernel, kernel, plain, and CUDA-graph
    times; prints them and returns (kernel ms, plain ms), each the faster of
    its two eager runs."""
    t = {}
    for tag, fn in (("plain", plain), ("kernel", kern), ("kernel2", kern), ("plain2", plain)):
        t[tag] = cuda_time_ms(fn, iters=20, warmup=3)
    g_kern = graph_time_ms(kern, reps=10, replays=5)
    g_plain = graph_time_ms(plain, reps=3, replays=3)
    print(f"  {label}, per call: eager kernel {t['kernel']:.4f} / {t['kernel2']:.4f} ms, plain "
          f"{t['plain']:.4f} / {t['plain2']:.4f} ms; CUDA graph kernel {g_kern:.4f} ms, plain "
          f"{g_plain:.4f} ms")
    return min(t["kernel"], t["kernel2"]), min(t["plain"], t["plain2"])


def _check_outputs(got, want, what: str, tol: float = BLOCK_TOL, outliers: float = 0.0):
    """Kernel output(s) against the plain version's (``_block_err``); returns
    (max |d|, elements off by more than one bf16 ulp, elements, elements
    beyond ``tol``)."""
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    check(len(gots) == len(wants), f"{what}{len(gots)} outputs, expected {len(wants)}")
    err, flips, n, beyond = 0.0, 0, 0, 0
    for g, w in zip(gots, wants):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}{g.dtype} {tuple(g.shape)}, expected {w.dtype} {tuple(w.shape)}")
        e, b = _block_err(g, w, what, tol, outliers)
        err, beyond = max(err, e), beyond + b
        flips, n = flips + _ulp_flips(g, w), n + w.numel()
    return err, flips, n, beyond


def phase_blocks(dev):
    """Phase 4: K3, K4, K5 against their plain versions at the flagship shapes,
    K4 and K5 with the pair-packed MHA (the engine's default at 16 heads of
    64) and with the bf16 MHA. Returns {name: (max_abs_err, ms, plain_ms)}
    with times of the served mode (W4, static scales, the pair MHA)."""
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

    def calls(w4, st, q_valid=L_TOK, kv_valid=S_COND, attn="pair"):
        q = quantize_weight_w4 if w4 else quantize_weight
        w = {k: [q(a, b) for a, b in v] for k, v in raw.items()}
        ss = (lambda k: static[k]) if st else (lambda k: None)
        kw = dict(w4=w4)
        akw = dict(attn=attn, **kw)
        return {
            "self_attn_block": (
                lambda: ib.self_attn_block(x, mod, *w["attn"], batch=BATCH, n_head=N_HEAD,
                                           q_valid=q_valid, static_s=ss("attn"), **akw),
                lambda: ib.self_attn_block_reference(x, mod, *w["attn"], batch=BATCH,
                                                     n_head=N_HEAD, q_valid=q_valid,
                                                     static_s=ss("attn"), **akw)),
            "cross_attn_block": (
                lambda: ib.cross_attn_block(x, mod, ck, cv, *w["cross"], batch=BATCH,
                                            n_head=N_HEAD, kv_valid=kv_valid,
                                            static_s=ss("cross"), **akw),
                lambda: ib.cross_attn_block_reference(x, mod, ck, cv, *w["cross"], batch=BATCH,
                                                      n_head=N_HEAD, kv_valid=kv_valid,
                                                      static_s=ss("cross"), **akw)),
            "mlp_block": (
                lambda: ib.mlp_block(x, ln, *w["mlp"], static_s=ss("mlp"), **kw),
                lambda: ib.mlp_block_reference(x, ln, *w["mlp"], static_s=ss("mlp"), **kw)),
        }

    def pair_gate(label, name, outs):
        """K4 / K5 with the pair MHA against the pair twin, on the share of
        outputs PAIR_BLOCK_ULPS off; K4 / K5 with the bf16 MHA, kernel and
        twin, must fail that gate."""
        got, want = outs["pair"][name]
        _ulp_gate(f"{name:<17} {label}, pair MHA", got, want, PAIR_BLOCK_ULPS, PAIR_BLOCK_SHARE,
                  (("the bf16 MHA, kernel", outs["bf16"][name][0]),
                   ("the bf16 MHA, plain", outs["bf16"][name][1])))

    errs = {}
    for w4 in (False, True):
        for st in (False, True):
            label = f"{'W4' if w4 else 'W8'} {'static ' if st else 'dynamic'}"
            outs = {attn: {name: (kern(), plain())
                           for name, (kern, plain) in calls(w4, st, attn=attn).items()
                           if name != "mlp_block" or attn == "pair"}
                    for attn in ("pair", "bf16")}
            torch.cuda.synchronize()
            if st:   # static K3: integer dots and the twin's f32 ops in its order
                got, want = outs["pair"]["mlp_block"]
                check(torch.equal(got, want), f"mlp_block {label}: {int((got != want).sum())} "
                      "outputs differ from the twin")
                print(f"  mlp_block         {label}: equal to the twin")
            for attn, per in outs.items():
                for name, (got, want) in per.items():
                    err, _ = _block_err(got, want, f"{name} {attn}: ")
                    errs[name] = max(errs.get(name, 0.0), err)
                    mha = "" if name == "mlp_block" else f", {attn} MHA"
                    print(f"  {name:<17} {label}{mha}: max|d| {err:.3e}, elements off by > 1 "
                          f"bf16 ulp (int8 flips) {_ulp_flips(got, want)}/{got.numel()}")
            for name in ("self_attn_block", "cross_attn_block"):
                pair_gate(label, name, outs)
    # masked keys: q_valid / kv_valid below the length
    valid = {"self_attn_block": L_TOK - 9, "cross_attn_block": S_COND - 20}
    outs = {attn: {name: (kern(), plain())
                   for name, (kern, plain) in calls(True, True, *valid.values(), attn=attn).items()
                   if name in valid}
            for attn in ("pair", "bf16")}
    for name, first in valid.items():
        for attn in ("pair", "bf16"):
            print(f"  {name:<17} W4 static, {attn} MHA, keys from {first} masked: max|d| "
                  f"{_block_err(*outs[attn][name], f'{name} masked: ')[0]:.3e}")
        pair_gate(f"W4 static, keys from {first} masked", name, outs)

    # five launches a call: quantize pass, q (k, v) dots, MHA, quantize pass,
    # proj + residual; the passes are counted
    for name in valid:
        passes = ib.quantize_rows.launches
        calls(True, True)[name][0]()
        torch.cuda.synchronize()
        check(ib.quantize_rows.launches == passes + 2, f"{name}: "
              f"{ib.quantize_rows.launches - passes} quantize passes a call, expected 2")
        print(f"  {name:<17} launches a call: 5 (quantize pass, dots, MHA, quantize pass, "
              "proj + residual), the two passes counted")
    times = {}
    for name, (kern, plain) in calls(True, True).items():
        times[name] = (errs[name], *time_pair(f"{name:<17} W4 static" + (
            "" if name == "mlp_block" else ", pair MHA"), kern, plain))
    for name in ("self_attn_block", "cross_attn_block"):
        time_pair(f"{name:<17} W4 static, bf16 MHA", *calls(True, True, attn="bf16")[name])
    return times


def phase_quant_pass(dev):
    """Phase 4 (cont.): the attention blocks' quantize pass against its plain
    version at the flagship shape (2120 x 1024): AdaLN on bf16 and on f32 rows
    (K8's cross half) and no norm on bf16 rows, dynamic and static scales.
    On rows whose LayerNorm statistics are exact in any order (half +2^e,
    half -2^e, e in 3..5) and on Gaussian rows without a norm, its int8 rows and row
    maxima equal those of the plain version run on the CPU (whose divides are
    correctly rounded, as the kernel's; on the card PyTorch divides by a
    Python number through its reciprocal) bit for bit; AdaLN on Gaussian rows
    may move an int8 value by one (an ulp of the statistics), in at most
    QUANT_SHARE of them. Returns (max |d| of the int8 values, ms, plain ms),
    the times of the served mode (AdaLN, bf16, static)."""
    from text_to_sound_synthesis_torch.ops import int8_block as ib

    gen = torch.Generator(dev).manual_seed(SEED + 6)
    M, D = BATCH * L_TOK, D_MODEL
    signs = torch.ones((M, D), device=dev)
    signs[:, D // 2:] = -1.0
    order = torch.argsort(torch.rand((M, D), generator=gen, device=dev), dim=1)
    # e in 3..5: 4^e + 1e-6 rounds to 4^e, whose 1/sqrt is exact on the card and the CPU alike
    exact = signs.gather(1, order) * 2.0 ** torch.randint(3, 6, (M, 1), generator=gen, device=dev)
    gauss = torch.randn((M, D), generator=gen, device=dev) * 2
    mod = torch.randn((2, D), generator=gen, device=dev) * 0.2
    worst = 0
    for norm, dtype in (("adaln", torch.bfloat16), ("adaln", torch.float32),
                        ("none", torch.bfloat16)):
        m = mod if norm == "adaln" else None
        for rows, x in (("+-2^e", exact), ("Gaussian", gauss)):
            for s in (None, 0.035):
                xd = x.to(dtype)
                q, amax = ib.quantize_rows(xd, m, static_s=s)
                torch.cuda.synchronize()
                wq, wamax = ib.quantize_rows_reference(xd.cpu(), None if m is None else m.cpu(),
                                                       static_s=s)
                d = (q.cpu().int() - wq.int()).abs()
                diff, dmax = int((d > 0).sum()), int(d.max())
                worst = max(worst, dmax)
                label = (f"{norm} {str(dtype)[6:]} {rows} rows, "
                         f"{'static' if s else 'dynamic'}")
                if norm == "none" or rows != "Gaussian":
                    check(diff == 0, f"quantize pass {label}: {diff} int8 values differ")
                    check(s is not None or torch.equal(amax.cpu(), wamax),
                          f"quantize pass {label}: row maxima differ")
                else:
                    check(dmax <= 1 and diff <= QUANT_SHARE * d.numel(),
                          f"quantize pass {label}: {diff} int8 values differ, by up to {dmax}")
                maxima = "" if s else ", row maxima equal"   # (checked above where exact)
                print(f"  quantize pass {label}: int8 values off {diff}/{d.numel()} (by up to "
                      f"{dmax}){maxima if norm == 'none' or rows != 'Gaussian' else ''}")
    xb = gauss.bfloat16()
    ms, plain_ms = time_pair("quantize pass, AdaLN, bf16, static",
                             lambda: ib.quantize_rows(xb, mod, static_s=0.035),
                             lambda: ib.quantize_rows_reference(xb, mod, static_s=0.035))
    return float(worst), ms, plain_ms


def phase_wide_pass(dev):
    """Phase 4 (cont.): the wide quantize pass against its plain version at
    the flagship's MLP middle (2120 x 4096): bf16 rows with their own max
    (K6's fc2 input), f32 rows with given per-(row, chunk) maxima at 1, 4 and
    16 chunks (K3's and K9's middle; the maxima those of the rows' chunks),
    and a static scale; its int8 rows and maxima equal those of the plain
    version run on the CPU bit for bit (no statistics: only the row scale's
    divide, correctly rounded on both). Returns (max |d| of the int8 values,
    ms, plain ms), the times at K9's served call (f32, 4 chunks)."""
    from text_to_sound_synthesis_torch.ops import quant

    gen = torch.Generator(dev).manual_seed(SEED + 7)
    M, F = BATCH * L_TOK, D_MLP
    u = torch.randn((M, F), generator=gen, device=dev) * 3
    cases = {"bf16, own max": (u.bfloat16(), None, None)}
    for n in (1, 4, 16):
        cases[f"f32, {n} chunks"] = (u, u.abs().reshape(M, n, -1).amax(-1), None)
    cases["f32, static"] = (u, None, 0.03)
    for label, (x, amax, s) in cases.items():
        q, got = quant.quantize_wide(x, static_s=s, amax=amax)
        torch.cuda.synchronize()
        wq, want = quant.quantize_wide_reference(x.cpu(), static_s=s,
                                                 amax=None if amax is None else amax.cpu())
        diff = int((q.cpu() != wq).sum())
        check(diff == 0, f"wide pass {label}: {diff} int8 values differ")
        check((got is None) == (want is None) and (want is None or torch.equal(got.cpu(), want)),
              f"wide pass {label}: row maxima differ")
        print(f"  wide quantize pass {label}: int8 values equal ({q.numel()}), maxima equal")
    x, amax, _ = cases["f32, 4 chunks"]
    ms, plain_ms = time_pair("wide quantize pass, f32, 4 chunks",
                             lambda: quant.quantize_wide(x, amax=amax),
                             lambda: quant.quantize_wide_reference(x, amax=amax))
    return 0.0, ms, plain_ms


def phase_head(fs, dd, dev):
    """Phase 4 (cont.): K2 against its plain version, and against K1 on the
    same logits, at the codebooks of the repo's configs (256, 512 and 2048
    codes + MASK; the flagship's at every r and t_post checked, the others
    at t_post 50) and at 249 codes, a K - 1 that is no multiple of 8 (the
    wrapper pads the weight's rows). Returns (max_abs_err, ms, plain_ms) at
    the flagship's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    M = BATCH * L_TOK
    max_err = 0.0
    for K in (257, 513, 2049, 250):
        gen = torch.Generator(dev).manual_seed(SEED + 2)
        x = (torch.randn((M, D_MODEL), generator=gen, device=dev) * 2).bfloat16()
        norm = torch.stack([1 + 0.1 * torch.randn(D_MODEL, generator=gen, device=dev),
                            0.1 * torch.randn(D_MODEL, generator=gen, device=dev)])
        hw = (torch.randn((D_MODEL, K - 1), generator=gen, device=dev) * 0.1).bfloat16()
        hb = 0.1 * torch.randn(K - 1, generator=gen, device=dev)
        xt = torch.randint(0, K, (M,), generator=gen, device=dev, dtype=torch.int32)
        g = dd.gumbel_from_uniform(torch.rand((M, K), generator=gen, device=dev))
        sched = dd.make_schedule(N_STEPS, K, device=dev)
        for r in (0.0, 0.85):
            for t_post in ((0, 50, 99) if K == 257 else (50,)):
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
                print(f"  K2 K={K:<4} r={r:<4} t_post={t_post:<2}  max|dpost| {row_err:.3e}  rows "
                      f"beyond 1e-4 {int((err > 1e-4).sum())}/{M}  boundary rows {boundary}/{M}  "
                      f"token mismatches {tok_diff}/{M}")
                check(boundary <= (int(BOUNDARY_ROWS * M) if r > 0 else 0),
                      f"K2 K={K} posterior: {boundary} rows beyond {K2_POST_ATOL}")
                check(tok_diff <= int(BOUNDARY_ROWS * M), f"K2 K={K} tokens: {tok_diff} rows differ")
        # K2's Philox draws are K1's on the same logits (the plain f32 logits)
        c = fs.step_coeffs(sched, 50).as_array().contiguous()
        logits = fs.head_logits(x, norm, hw, hb)
        k2 = fs.fused_head_sample(x, xt, norm, hw, hb, c, 5, 7, truncation_r=0.85)
        k1 = fs.fused_p_sample(logits[None].contiguous(), xt[None].contiguous(), c, 5, 7,
                               truncation_r=0.85)[0]
        torch.cuda.synchronize()
        diff = int((k1 != k2).sum())
        print(f"  K2 K={K} vs K1 on the same logits, Philox draws, r=0.85: {diff}/{M} tokens differ")
        check(diff <= int(BOUNDARY_ROWS * M), f"K2 K={K} draws differ from K1's")
        if K != 257:
            kern = lambda: fs.fused_head_sample(x, xt, norm, hw, hb, c, 1, 2, truncation_r=0.85)
            print(f"  K2 K={K} per call, r=0.85: eager {cuda_time_ms(kern, iters=50):.4f} ms, "
                  f"CUDA graph {graph_time_ms(kern):.4f} ms")
            continue
        flagship = x, xt, norm, hw, hb, g, c
    x, xt, norm, hw, hb, g, c = flagship
    gen = torch.Generator(dev).manual_seed(SEED + 2)

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


def phase_schedules(dev):
    """Phase 4 (cont.): K6-K9, the W8 engine's other schedules, against their
    plain versions at the flagship shapes, W8, dynamic and static scales.
    Returns {name: (max_abs_err, ms, plain_ms)} with times of the served mode
    (W8, dynamic scales): K6 multi per call averaged over a layer's six
    sites, K7 over its two attentions; also the time of PyTorch's one call for
    K7's function."""
    from text_to_sound_synthesis_torch.ops import attention as attn
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import quant

    gen = torch.Generator(dev).manual_seed(SEED + 4)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=gen, device=dev) * scale
    M, D = BATCH * L_TOK, D_MODEL
    x = rnd(M, D).bfloat16()
    h = (rnd(M, D_MLP) * 0.5).bfloat16()          # the fc2 input (GELU2 outputs)
    mods = rnd(4, D, scale=0.2)
    ln = rnd(2, D, scale=0.2)
    ln[0] += 1.0
    ck, cv = rnd(BATCH * S_COND, D).bfloat16(), rnd(BATCH * S_COND, D).bfloat16()
    w = lambda n, k: quant.quantize_weight(rnd(n, k, scale=0.03 * (1024 / k) ** 0.5),
                                           rnd(n, scale=0.05))
    wa = [w(D, D) for _ in range(6)]              # q, k, v, proj, crossq, crossproj
    wm = [w(D_MLP, D), w(D, D_MLP)]               # fc1, fc2
    multi, multi_ref = quant.fused_quant_dense_multi, quant.quant_dense_multi_reference

    def dense_sites(st):
        s = (lambda v: v) if st else (lambda v: None)
        return {"qkv": ((x, wa[0:3]), dict(norm="adaln", mod=mods[0:2], s_static=s(0.035))),
                "proj": ((x, wa[3:4]), dict(residual=x, s_static=s(0.02))),
                "crossq": ((x, wa[4:5]), dict(norm="adaln", mod=mods[2:4], s_static=s(0.035))),
                "crossproj": ((x, wa[5:6]), dict(residual=x, s_static=s(0.02))),
                "fc1": ((x, wm[0:1]), dict(norm="ln", mod=ln, act="gelu2", s_static=s(0.035))),
                "fc2": ((h, wm[1:2]), dict(residual=x, s_static=s(0.01)))}

    def single(st):
        s = 0.035 if st else None
        return {"fc1": ((x, wm[0]), dict(norm="ln", mod=ln, act="gelu2", s_static=s)),
                "proj f32": ((x, wa[3]), dict(residual=x, out_dtype=torch.float32,
                                               s_static=None if s is None else 0.02))}

    def mha_cases():
        self_v = h[:, :D].contiguous()
        return {f"self {L_TOK} keys": ((x, x, self_v), L_TOK),
                f"self {L_TOK} keys, from {L_TOK - 9} masked": ((x, x, self_v), L_TOK - 9),
                f"cross {S_COND} keys": ((x, ck, cv), S_COND),
                f"cross {S_COND} keys, from {S_COND - 20} masked": ((x, ck, cv), S_COND - 20)}

    def pair(st, q_valid=L_TOK, kv_valid=S_COND):
        args = (x, mods, ck, cv, *wa)
        kw = dict(batch=BATCH, n_head=N_HEAD, q_valid=q_valid, kv_valid=kv_valid,
                  static_s=(0.035, 0.02, 0.035, 0.02) if st else None)
        return (lambda: ib.attn_pair_block(*args, **kw),
                lambda: ib.attn_pair_block_reference(*args, **kw))

    def chunked(kern, n, st):
        kw = dict(n_chunks=n, static_s=(0.035, 0.012) if st else None)
        return (lambda: kern(x, ln, *wm, **kw),
                lambda: ib.mlp_chunked_reference(x, ln, *wm, **kw))

    errs = {}

    def run(name, label, kern, plain):
        want = plain()
        got = kern()
        torch.cuda.synchronize()
        err, flips, n, _ = _check_outputs(got, want, f"{name} {label}: ")
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"  {name:<23} {label}: max|d| {err:.3e}, elements off by > 1 bf16 ulp "
              f"{flips}/{n}")

    quant.fused_quant_dense.launches = 0
    for st in (False, True):
        tag = "W8 static " if st else "W8 dynamic"
        for site, (args, kw) in dense_sites(st).items():
            run("fused_quant_dense_multi", f"{tag} {site}", lambda: multi(*args, **kw),
                lambda: multi_ref(*args, **kw))
        for site, (args, kw) in single(st).items():
            run("fused_quant_dense", f"{tag} {site}", lambda: quant.fused_quant_dense(*args, **kw),
                lambda: quant.quant_dense_reference(*args, **kw))
        run("attn_pair_block", tag, *pair(st))
        run("attn_pair_block", f"{tag}, keys from {L_TOK - 9} / {S_COND - 20} masked",
            *pair(st, L_TOK - 9, S_COND - 20))
        run("mlp_block_chunked", f"{tag}, 4 chunks", *chunked(ib.mlp_block_chunked, 4, st))
        run("mlp_block_streamed", f"{tag}, 16 chunks", *chunked(ib.mlp_block_streamed, 16, st))
    for label, (qkv, valid) in mha_cases().items():
        kw = dict(batch=BATCH, n_head=N_HEAD, kv_valid=valid)
        run("fused_mha", label, lambda: attn.fused_mha(*qkv, **kw),
            lambda: attn.mha_reference(*qkv, **kw))
    # a K6 call: one quantize pass (the wide one at fc2's K = 4096) and one dot;
    # a dynamic K9 call: fc1, the wide pass over its middle, the chunked fc2
    for st in (False, True):
        for site, (args, kw) in dense_sites(st).items():
            rows, wide = quant.quantize_rows.launches, quant.quantize_wide.launches
            multi(*args, **kw)
            got = (quant.quantize_rows.launches - rows, quant.quantize_wide.launches - wide)
            check(got == ((0, 1) if site == "fc2" else (1, 0)),
                  f"fused_quant_dense_multi {site}: (row, wide) quantize passes {got}")
        for kern, n in ((ib.mlp_block_chunked, 4), (ib.mlp_block_streamed, 16)):
            wide = quant.quantize_wide.launches
            chunked(kern, n, st)[0]()
            check(quant.quantize_wide.launches - wide == (0 if st else 1),
                  f"{kern.__name__}: {quant.quantize_wide.launches - wide} wide passes a call")
    print("  launches a call: K6 a quantize pass (the wide one at K = 4096) and a dot; K9 fc1, "
          "the wide pass (dynamic scales), the chunked fc2: the passes counted")

    times = {}
    sites = dense_sites(False)
    site_times = [time_pair(f"fused_quant_dense_multi W8 dynamic {site}",
                            lambda: multi(*args, **kw), lambda: multi_ref(*args, **kw))
                  for site, (args, kw) in sites.items()]
    times["fused_quant_dense_multi"] = tuple(sum(t) / len(t) for t in zip(*site_times))
    args, kw = single(False)["fc1"]
    times["fused_quant_dense"] = time_pair(
        "fused_quant_dense W8 dynamic fc1", lambda: quant.fused_quant_dense(*args, **kw),
        lambda: quant.quant_dense_reference(*args, **kw))
    mha_times, sdpa_times = [], []
    for label, (qkv, valid) in mha_cases().items():
        if "masked" not in label:
            kw = dict(batch=BATCH, n_head=N_HEAD, kv_valid=valid)
            mha_times.append(time_pair(f"fused_mha {label}", lambda: attn.fused_mha(*qkv, **kw),
                                       lambda: attn.mha_reference(*qkv, **kw)))
            sdpa_times.append(time_sdpa(f"fused_mha {label}", qkv,
                                        attn.mha_reference(*qkv, **kw)))
    times["fused_mha"] = tuple(sum(t) / len(t) for t in zip(*mha_times))
    times["attn_pair_block"] = time_pair("attn_pair_block W8 dynamic", *pair(False))
    times["mlp_block_chunked"] = time_pair("mlp_block_chunked W8 dynamic, 4 chunks",
                                           *chunked(ib.mlp_block_chunked, 4, False))
    times["mlp_block_streamed"] = time_pair("mlp_block_streamed W8 dynamic, 16 chunks",
                                            *chunked(ib.mlp_block_streamed, 16, False))
    print(f"  per call, the served mode (W8 dynamic): K6 multi averaged over a layer's six "
          f"sites {times['fused_quant_dense_multi'][0]:.4f} ms (plain "
          f"{times['fused_quant_dense_multi'][1]:.4f} ms), K7 over its two attentions "
          f"{times['fused_mha'][0]:.4f} ms (plain {times['fused_mha'][1]:.4f} ms, "
          f"scaled_dot_product_attention {sum(sdpa_times) / len(sdpa_times):.4f} ms)")
    return ({name: (errs[name], *t) for name, t in times.items()},
            quant.fused_quant_dense.launches, {"fused_mha": sum(sdpa_times) / len(sdpa_times)})


def _sdpa(qkv):
    """``scaled_dot_product_attention`` on q, k, v (B*L, D) as (B, H, L, hd)
    views, no key masked, as a function of nothing."""
    hd = D_MODEL // N_HEAD
    q, k, v = (t.view(BATCH, -1, N_HEAD, hd).transpose(1, 2) for t in qkv)
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)


def time_sdpa(label: str, qkv, want) -> float:
    """PyTorch's one call for the bf16 MHA, ``scaled_dot_product_attention``
    on the same q, k, v as (B, H, L, hd) views, no key masked: returns its
    eager time per call, the faster of two runs, as the kernels' (prints its
    CUDA-graph time too). A yardstick only; the port never calls it. Checks
    that it computes the same function (within BLOCK_TOL)."""
    call = _sdpa(qkv)
    _block_err(call().transpose(1, 2).reshape(want.shape), want, f"{label} SDPA: ")
    ms = min(cuda_time_ms(call, iters=20, warmup=3), cuda_time_ms(call, iters=20, warmup=3))
    print(f"  {label}, scaled_dot_product_attention per call: eager {ms:.4f} ms, CUDA graph "
          f"{graph_time_ms(call, reps=10, replays=5):.4f} ms")
    return ms


def phase_int8_attention(dev):
    """Phase 4 (cont.): K10, the folded bf16 MHA and the pair-packed MHA
    against their plain versions at the flagship shapes, then K4, K5 (W8
    and W4) and K8 with the int8 MHA, dynamic and static scales; K10 and the
    pair MHA in CUDA graphs beside K7 and ``scaled_dot_product_attention``.
    Returns ({name: (max_abs_err, ms, plain_ms)}: K10 and the three bf16 MHAs
    averaged over the self and the cross attention, K4 / K5 with the int8
    MHA in the served mode (W4 static); SDPA's eager ms averaged alike)."""
    from text_to_sound_synthesis_torch.ops import attention as attn
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik
    from text_to_sound_synthesis_torch.ops.quant import quantize_weight, quantize_weight_w4

    gen = torch.Generator(dev).manual_seed(SEED + 5)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=gen, device=dev) * scale
    M, D = BATCH * L_TOK, D_MODEL
    x = rnd(M, D).bfloat16()
    v_self = (rnd(M, D) * 0.5).bfloat16()
    mods = rnd(4, D, scale=0.2)
    ck, cv = rnd(BATCH * S_COND, D).bfloat16(), rnd(BATCH * S_COND, D).bfloat16()
    raw = [(rnd(D, D, scale=0.03), rnd(D, scale=0.05)) for _ in range(6)]
    lib = ik.load_kernel()

    def tail(v, keys, valid):
        """v with its masked keys four times larger, so that they set V's
        column scale (taken over all keys, masked ones included)."""
        v = v.clone()
        v.view(BATCH, keys, D)[:, valid:] *= 4
        return v

    cases = {f"self {L_TOK} keys": ((x, x, v_self), L_TOK),
             f"self {L_TOK} keys, from {L_TOK - 9} masked (their v x 4)":
                 ((x, x, tail(v_self, L_TOK, L_TOK - 9)), L_TOK - 9),
             f"cross {S_COND} keys": ((x, ck, cv), S_COND),
             f"cross {S_COND} keys, from {S_COND - 20} masked (their v x 4)":
                 ((x, ck, tail(cv, S_COND, S_COND - 20)), S_COND - 20)}

    def k10(qkv, valid):
        kw = dict(batch=BATCH, n_head=N_HEAD, kv_valid=valid)
        return (lambda: ib.mha_inline_int8(*qkv, **kw),
                lambda: ib.mha_inline_int8_reference(*qkv, **kw).bfloat16())

    def fold(qkv, valid):
        return (lambda: ik.mha(lib, *qkv, BATCH, N_HEAD, valid, mode="bf16_fold"),
                lambda: attn.mha_reference(*qkv, batch=BATCH, n_head=N_HEAD, kv_valid=valid,
                                           fold_div=True))

    def pair_mha(qkv, valid):
        return (lambda: ik.mha(lib, *qkv, BATCH, N_HEAD, valid, mode="pair"),
                lambda: attn.mha_pair_reference(*qkv, batch=BATCH, n_head=N_HEAD, kv_valid=valid))

    def bf16_mha(qkv, valid):
        return (lambda: ik.mha(lib, *qkv, BATCH, N_HEAD, valid),
                lambda: attn.mha_reference(*qkv, batch=BATCH, n_head=N_HEAD, kv_valid=valid))

    def blocks(w4, st):
        q = quantize_weight_w4 if w4 else quantize_weight
        w = [q(a, b) for a, b in raw]
        s2 = (0.035, 0.02) if st else None
        kw = dict(batch=BATCH, n_head=N_HEAD, attn="int8")
        out = {"self_attn_block": (ib.self_attn_block, ib.self_attn_block_reference,
                                   (x, mods[:2], *w[:4]),
                                   dict(q_valid=L_TOK, static_s=s2, w4=w4, **kw)),
               "cross_attn_block": (ib.cross_attn_block, ib.cross_attn_block_reference,
                                    (x, mods[2:], ck, cv, *w[4:]),
                                    dict(kv_valid=S_COND, static_s=s2, w4=w4, **kw))}
        if not w4:
            out["attn_pair_block"] = (ib.attn_pair_block, ib.attn_pair_block_reference,
                                      (x, mods, ck, cv, *w),
                                      dict(q_valid=L_TOK, kv_valid=S_COND,
                                           static_s=None if s2 is None else s2 * 2, **kw))
        return out

    errs = {}

    def run(name, label, kern, plain, tol=BLOCK_TOL, outliers=0.0):
        want = plain()
        got = kern()
        torch.cuda.synchronize()
        err, flips, n, _ = _check_outputs(got, want, f"{name} {label}: ", tol, outliers)
        errs[name] = max(errs.get(name, 0.0), err)
        beyond = int(((got.float() - want.float()).abs()
                      > BLOCK_TOL + BLOCK_TOL * want.float().abs()).sum())
        print(f"  {name:<23} {label}: max|d| {err:.3e}, elements off by > 1 bf16 ulp "
              f"{flips}/{n}, beyond {BLOCK_TOL} {beyond}")
        return got, want

    for label, (qkv, valid) in cases.items():
        got, want = run("mha_inline_int8", label, *k10(qkv, valid))
        # the gates on P's rounding (K10) and on the pair MHA's, each with the
        # bf16 MHA (plain, kernel) as the control that must fail it
        bf16 = (("the bf16 MHA, plain", attn.mha_reference(*qkv, batch=BATCH, n_head=N_HEAD,
                                                           kv_valid=valid)),
                ("the bf16 MHA, kernel", ik.mha(lib, *qkv, BATCH, N_HEAD, valid)))
        _ulp_gate(f"mha_inline_int8         {label}", got, want, K10_ULPS, K10_SHARE, bf16)
        run("mha folded divide", label, *fold(qkv, valid))
        got, want = run("mha pair", label, *pair_mha(qkv, valid))
        _ulp_gate(f"mha pair                {label}", got, want, PAIR_MHA_ULPS, PAIR_MHA_SHARE,
                  bf16)
    for w4 in (False, True):
        for st in (False, True):
            tag = f"{'W4' if w4 else 'W8'} {'static' if st else 'dynamic'}, int8 MHA"
            for name, (kern, plain, args, kw) in blocks(w4, st).items():
                # K8: two blocks, x in f32 between them; with the int8 MHA
                # its flips reach the cross half as in phase 7's serving loop
                gate = (PAIR_TOL, PAIR_OUTLIERS) if name == "attn_pair_block" else (BLOCK_TOL, 0.0)
                run(name, tag, lambda: kern(*args, **kw), lambda: plain(*args, **kw), *gate)

    times = {}
    for name, make in (("mha_inline_int8", k10), ("mha folded divide", fold), ("mha pair", pair_mha),
                       ("mha bf16", bf16_mha)):
        per = [time_pair(f"{name} {label}", *make(qkv, valid))
               for label, (qkv, valid) in cases.items() if "masked" not in label]
        times[name] = (errs.get(name, 0.0), *(sum(t) / len(t) for t in zip(*per)))
    for name, (kern, plain, args, kw) in blocks(True, True).items():
        times[name] = (errs[name], *time_pair(f"{name} W4 static, int8 MHA",
                                              lambda: kern(*args, **kw),
                                              lambda: plain(*args, **kw)))
    print(f"  per call, averaged over the self and the cross attention: K10 "
          f"{times['mha_inline_int8'][1]:.4f} ms (plain {times['mha_inline_int8'][2]:.4f} ms), "
          f"folded bf16 MHA {times['mha folded divide'][1]:.4f} ms (plain "
          f"{times['mha folded divide'][2]:.4f} ms), pair MHA {times['mha pair'][1]:.4f} ms (plain "
          f"{times['mha pair'][2]:.4f} ms), bf16 MHA {times['mha bf16'][1]:.4f} ms: the pair MHA "
          f"{times['mha pair'][1] / times['mha bf16'][1]:.3f} x the bf16 MHA")
    # device time per call (CUDA graphs) at the self and the cross attention's
    # key counts: K10 and the pair MHA beside K7 (the bf16 MHA) and SDPA
    sdpa = []
    for label, (qkv, valid) in cases.items():
        if "masked" in label:
            continue
        want = attn.mha_reference(*qkv, batch=BATCH, n_head=N_HEAD, kv_valid=valid)
        sdpa.append(time_sdpa(f"mha {label}", qkv, want))
        graphs = [(name, graph_time_ms(make(qkv, valid)[0], reps=10, replays=5))
                  for name, make in (("K10", k10), ("pair MHA", pair_mha), ("K7", bf16_mha))]
        graphs.append(("scaled_dot_product_attention", graph_time_ms(_sdpa(qkv), reps=10,
                                                                     replays=5)))
        print(f"  CUDA graph per call, {label}: "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in graphs))
    return times, sum(sdpa) / len(sdpa)


def phase_gn_conv(dev):
    """Phase 4 (cont.): K11 against its plain twin at the flagship decoder's
    five stages (batch 8, bf16, C == Co, 32 groups; random affine and bias),
    its gradient at GN_GRAD_SHAPE, eager and CUDA-graph times of kernel, twin
    and the cuDNN composition (the tool's yardstick), then K11's own path, the
    port's A/B tool, with its launches counted from 0. Returns ((max_abs_err,
    ms, plain_ms) summed over the stages, the tool's launches)."""
    from torch.nn import functional as F

    from text_to_sound_synthesis_torch.ops import fused_gn_conv as gn
    from text_to_sound_synthesis_torch.tools import bench_gn_conv as tool

    torch.backends.cudnn.allow_tf32 = False

    def inputs(H, W, C, seed):
        gen = torch.Generator(dev).manual_seed(seed)
        rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=gen, device=dev) * scale
        return (rnd(tool.B, H, W, C).bfloat16(), 1 + rnd(C, scale=0.2), rnd(C, scale=0.2),
                rnd(3, 3, C, C, scale=0.05), rnd(C, scale=0.1))

    err = ms = plain_ms = 0.0
    for i, (H, W, C) in enumerate(tool.SHAPES):
        args = inputs(H, W, C, SEED + 10 + i)
        kern = lambda: gn.gn_swish_conv(*args, groups=tool.GROUPS)
        plain = lambda: gn.gn_swish_conv_reference(*args, groups=tool.GROUPS)
        label = f"gn_swish_conv ({tool.B},{H},{W},{C})"
        got, want = kern(), plain()
        torch.cuda.synchronize()
        e, flips, n, _ = _check_outputs(got, want, f"{label}: ", GN_TOL)
        check(torch.equal(kern(), got), f"{label}: two runs differ")
        # the cuDNN composition on the same values, bf16 weights and intermediates
        x, gamma, beta, k, b = args
        k_cl = k.permute(3, 2, 0, 1).bfloat16().contiguous(memory_format=torch.channels_last)
        cudnn = lambda: F.conv2d(F.silu(F.group_norm(x.permute(0, 3, 1, 2), tool.GROUPS,
                                                     gamma.bfloat16(), beta.bfloat16(), eps=1e-6)),
                                 k_cl, b.bfloat16(), padding=1)
        d_cudnn = float((cudnn().permute(0, 2, 3, 1).float() - want.float()).abs().max())
        print(f"  {label}: max|d| {e:.3e}, elements off by > 1 bf16 ulp {flips}/{n}, differing "
              f"{int((got != want).sum())}/{n}, two runs bit for bit equal; the cuDNN "
              f"composition max|d| {d_cudnn:.3e}")
        err = max(err, e)
        t_kern, t_plain = time_pair(label, kern, plain)
        t_cudnn = min(cuda_time_ms(cudnn, iters=20, warmup=3) for _ in range(2))
        print(f"  {label}, cuDNN composition per call: eager {t_cudnn:.4f} ms, CUDA graph "
              f"{graph_time_ms(cudnn, reps=10, replays=5):.4f} ms")
        ms, plain_ms = ms + t_kern, plain_ms + t_plain

    # the gradient: Function (kernel forward, the twin's VJP) against the twin,
    # of sum(y^2); then the backward alone, one upstream gradient through both,
    # with cuDNN's deterministic backward convs
    H, W, C = GN_GRAD_SHAPE[1:]
    names = ("x", "gamma", "beta", "kernel", "bias")
    grads, vjps = [], []
    up = None
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for fn in (gn.gn_swish_conv_reference, gn.gn_swish_conv):
            leaves = [t.clone().requires_grad_(True) for t in inputs(H, W, C, SEED + 20)]
            y = fn(*leaves, groups=tool.GROUPS)
            up = 2 * y.detach() if up is None else up          # the twin's 2 y, for both
            grads.append(torch.autograd.grad(y.float().square().sum(), leaves,
                                             retain_graph=True))
            vjps.append(torch.autograd.grad(y, leaves, up))
    torch.cuda.synchronize()
    for name, w, g, vw, vg in zip(names, *grads, *vjps):
        check(g.dtype == w.dtype and g.shape == w.shape, f"K11 grad {name}: {g.dtype} {g.shape}")
        d, top = float((g.float() - w.float()).abs().max()), float(w.float().abs().max())
        dv = float((vg.float() - vw.float()).abs().max())
        print(f"  gn_swish_conv grad of sum(y^2) at {GN_GRAD_SHAPE} wrt {name}: max|d| {d:.3e} "
              f"of max|grad| {top:.3e}; with the twin's upstream 2 y for both, max|d| {dv:.3e}"
              f"{' (equal)' if torch.equal(vg, vw) else ''}")
        check(d <= GN_GRAD_TOL * top, f"K11 grad {name}: max|d| {d:.3e} beyond {GN_GRAD_TOL} "
              f"of {top:.3e}")
        check(torch.equal(vg, vw), f"K11 backward {name}: max|d| {dv:.3e} from the twin's VJP")
    # why the deterministic algorithms: the twin's VJP twice, cuDNN's defaults
    again = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        for _ in range(2):
            leaves = [t.clone().requires_grad_(True) for t in inputs(H, W, C, SEED + 20)]
            y = gn.gn_swish_conv_reference(*leaves, groups=tool.GROUPS)
            again.append(torch.autograd.grad(y, leaves, up))
    print("  the twin's VJP run twice with cuDNN's default backward convs, max|d|: " + ", ".join(
        f"{name} {float((a.float() - b.float()).abs().max()):.3e}"
        for name, a, b in zip(names, *again)))
    # the Function's own backward twice, under the global cuDNN settings
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in inputs(H, W, C, SEED + 20)]
        y = gn.gn_swish_conv(*leaves, groups=tool.GROUPS)
        runs.append(torch.autograd.grad(y, leaves, up))
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    print(f"  gn_swish_conv backward run twice (the Function, global cuDNN settings): bit for bit "
          f"equal {dict(zip(names, same))}")
    check(all(same), "K11 backward: two runs of the Function differ")

    print("  K11's path, the port's A/B tool (python -m text_to_sound_synthesis_torch.tools."
          "bench_gn_conv 10):")
    gn.gn_swish_conv.launches = 0
    check(tool.main(["10"]) == 0, "bench_gn_conv failed")
    launches = gn.gn_swish_conv.launches
    print(f"  K11 launches in the tool run: {launches}")
    return (err, ms, plain_ms), launches


def phase_dot(dev):
    """Phase 4 (cont.): T1 against its plain twin at the probe's fc1 shape
    (int cases bit for bit, bf16 -> f32 within DOT_BOUND_K K 2^-24 sum|x w|),
    the one-call yardsticks against the twin, eager and CUDA-graph times,
    then T1's own path, the port's dot probe, with its launches counted from
    0. Returns ((max_abs_err, ms, plain_ms) of int8 -> int32, the tool's
    launches, the ms of ``torch._int_mm``)."""
    from text_to_sound_synthesis_torch.tools import bench_kernel_dot as tool
    from text_to_sound_synthesis_torch.ops import dot

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = tool.cases(dev)
    x8, w8, xb, wb = tool.inputs(dev)
    bound = DOT_BOUND_K * tool.K * 2.0 ** -24 * (xb.float().abs() @ wb.float().abs())
    err = 0.0
    for name, (dt, _) in dot.CASES.items():
        kern, plain = cases[name]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        check(got.dtype == want.dtype and got.shape == want.shape, f"T1 {name}: {got.dtype}")
        d = (got.double() - want.double()).abs()
        err = max(err, float(d.max()))
        if dt == torch.int8:
            check(torch.equal(got, want), f"T1 {name}: {int((got != want).sum())} outputs differ")
            print(f"  tiled_dot {name}: equal to the twin ({got.numel()} outputs)")
        else:
            over = int((d > bound).sum())
            print(f"  tiled_dot {name}: max|d| {float(d.max()):.3e}, worst at "
                  f"{float((d / bound).max()):.3f} x the bound")
            check(over == 0, f"T1 {name}: {over} outputs beyond the bound")
    int_mm, mm = cases["torch._int_mm int8->int32"][0], cases["torch.matmul bf16->bf16"][0]
    check(torch.equal(int_mm(), cases["int8->int32"][1]()), "torch._int_mm differs from the twin")
    d_mm = float((mm().float() - cases["bf16->f32"][1]()).abs().max())
    print(f"  torch._int_mm equal to the twin; bf16 torch.matmul (bf16 out) max|d| {d_mm:.3e}")

    times = {}
    for name in dot.CASES:
        times[name] = time_pair(f"tiled_dot {name} at {tool.M}x{tool.K}x{tool.N}", *cases[name])
    lib = {}
    for name in ("torch._int_mm int8->int32", "torch.matmul bf16->bf16"):
        call = cases[name][0]
        lib[name] = min(cuda_time_ms(call, iters=20, warmup=3) for _ in range(2))
        print(f"  {name} per call: eager {lib[name]:.4f} ms, CUDA graph "
              f"{graph_time_ms(call, reps=10, replays=5):.4f} ms")

    print("  T1's path, the port's dot probe (python -m text_to_sound_synthesis_torch.tools."
          "bench_kernel_dot 50):")
    dot.tiled_dot.launches = 0
    check(tool.main(["50"]) == 0, "bench_kernel_dot failed")
    launches = dot.tiled_dot.launches
    print(f"  T1 launches in the tool run: {launches}")
    return (err, *times["int8->int32"]), launches, lib["torch._int_mm int8->int32"]


def phase_ablate(dev):
    """Phase 4 (cont.): T2 and T3 at their tools' shapes, each configuration
    against its twin; eager and CUDA-graph times of T2 ``dots_only`` and T3
    ``qkvp_dots_only`` (the rows' times: the GEMM mainloops alone), with
    ``torch._int_mm`` at T2's fc1 and fc2 beside the first; then both paths,
    the port's tools over every configuration, with their launches counted
    from 0. Returns ((max_abs_err, ms, plain_ms), launches) for T2 and T3,
    and the ms of the two ``torch._int_mm`` calls."""
    from text_to_sound_synthesis_torch.ops import attn_ablate as T3
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import mlp_ablate as T2
    from text_to_sound_synthesis_torch.tools import bench_attn_ablate as t3
    from text_to_sound_synthesis_torch.tools import bench_mlp_ablate as t2

    x, mod, w1, w2 = t2.inputs(dev)
    twins = {v: T2.mlp_variant_reference(x, mod, w1, w2, variant=v) for v in T2.FUNCTIONS}
    twins["K3"] = ib.mlp_block_reference(x, mod, w1, w2)
    err2 = 0.0
    for variant in T2.FUNCTIONS:
        got = T2.mlp_variant(x, mod, w1, w2, variant=variant)
        want = twins[variant]
        torch.cuda.synchronize()
        label = f"mlp_variant {variant}: "
        if variant in T2_EXACT:
            check(torch.equal(got, want), f"{label}{int((got != want).sum())} outputs differ")
            e, flips = 0.0, 0
        else:
            e, flips, _, _ = _check_outputs(got, want, label)
        err2 = max(err2, e)
        print(f"  {label}max|d| {e:.3e}, elements off by > 1 bf16 ulp {flips}/{got.numel()}"
              f"{' (equal)' if torch.equal(got, want) else ''}")
        if variant in T2_CONTROLS:
            _ulp_gate(f"mlp_variant {variant}", got, want, T2_ULPS, T2_SHARE,
                      [(f"the {c} twin", twins[c]) for c in T2_CONTROLS[variant]])
    xa, moda, ws = t3.inputs(dev)
    err3 = 0.0
    for variant in T3.FUNCTIONS:
        for ss in (None, t3.STATIC):
            kw = dict(batch=t3.B, n_head=t3.H, q_valid=t3.Q_VALID, variant=variant, static_s=ss)
            got = T3.attn_variant(xa, moda, *ws, **kw)
            want = T3.attn_variant_reference(xa, moda, *ws, **kw)
            torch.cuda.synchronize()
            label = f"attn_variant {variant} {'static' if ss else 'dynamic'}: "
            e, flips, n, _ = _check_outputs(got, want, label)
            err3 = max(err3, e)
            print(f"  {label}max|d| {e:.3e}, elements off by > 1 bf16 ulp {flips}/{n}")

    d2 = time_pair(f"mlp_variant dots_only at {t2.M}x{t2.D}x{t2.DH}",
                   lambda: T2.mlp_variant(x, mod, w1, w2, variant="dots_only"),
                   lambda: T2.mlp_variant_reference(x, mod, w1, w2, variant="dots_only"))
    mm = t2.int_mm_us(dev)
    int_mm_ms = (mm["fc1"] + mm["fc2"]) / 1e3
    print(f"  torch._int_mm at fc1 + fc2, CUDA graph: {mm['fc1']:.1f} + {mm['fc2']:.1f} us")
    kw = dict(batch=t3.B, n_head=t3.H, q_valid=t3.Q_VALID, variant="qkvp_dots_only")
    d3 = time_pair(f"attn_variant qkvp_dots_only at {t3.B}x{t3.Lp}x{t3.D}",
                   lambda: T3.attn_variant(xa, moda, *ws, **kw),
                   lambda: T3.attn_variant_reference(xa, moda, *ws, **kw))

    launches = []
    for fn, tool, names in ((T2.mlp_variant, t2, list(T2.FUNCTIONS) + ["full", "w4_static", "skew4"]),
                            (T3.attn_variant, t3, list(T3.FUNCTIONS[:4]) + [
                                "pair_both", "pair_nofold", "rows2_static_pairdeq", "full",
                                "qkv_fused"])):
        print(f"  {fn.__name__}'s path, the port's probe (python -m "
              f"text_to_sound_synthesis_torch.tools.{tool.__name__.rsplit('.', 1)[1]} "
              f"{' '.join(names)}):")
        fn.launches = 0
        check(tool.main(names) == 0, f"{tool.__name__} failed")
        launches.append(fn.launches)
        print(f"  {fn.__name__} launches in the tool run: {fn.launches}")
    return ((err2, *d2), launches[0]), ((err3, *d3), launches[1]), int_mm_ms


def caption_ids(rng, n: int = BATCH) -> torch.Tensor:
    """BPE ids of the form the tokenizer emits: SOT, word ids, EOT, zero padding."""
    from text_to_sound_synthesis_torch.tools.eval_int8_drift import caption_ids as ids

    return ids(rng, n, CTX)


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
    with torch.no_grad(), model.compute_weights():     # the bf16 weights generate() reads
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
    check(tuple(mel.shape) == (BATCH, *MEL, 1), f"slice: mel shape {tuple(mel.shape)}")
    check(bool(torch.isfinite(mel).all()), "slice: mel not finite")
    check(tuple(wav.shape) == (BATCH, MEL[1] * 256), f"slice: wav shape {tuple(wav.shape)}")
    check(bool(torch.isfinite(wav).all()), "slice: wav not finite")
    check(float(wav.abs().max()) <= 1.0, "slice: wav outside [-1, 1]")
    return seconds


def bench_scope(model, cond_emb, fused: bool, generator):
    """One request in ``bench.py``'s scope: the sampler (the fused one, or
    the one-hot reference) and ``decode_code``, batch and steps as given,
    ``top0.85r``; the condition embedded before, no vocoder. -> (mel, tokens)."""
    from functools import partial

    from text_to_sound_synthesis_torch.models.diffusion.process import (
        sample_tokens, sample_tokens_fused)
    from text_to_sound_synthesis_torch.ops.sampling import truncate_top_r

    with torch.no_grad(), model.compute_weights(model.diffusion, model.codec):
        if fused:
            tokens = sample_tokens_fused(model.diffusion, cond_emb, generator=generator,
                                         truncation_r=0.85)
        else:
            tokens = sample_tokens(model.diffusion, cond_emb, generator=generator,
                                   filter_fn=partial(truncate_top_r, r=0.85))
        return model.decode_tokens(tokens), tokens


def reference_copy(model):
    """The f32 copy of ``model`` that the reference sampler is timed on."""
    import copy

    ref = copy.deepcopy(model).float()
    ref.dtype = torch.float32
    return ref


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's deterministic algorithms for the block (cuDNN's deterministic
    convs among them; an op without one warns), restored after. torch's
    defaults let CUDA backward kernels reduce by atomic adds, so the same
    step run twice need not agree bit for bit on the card."""
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


@contextlib.contextmanager
def pytorch_default_precision():
    """PyTorch's default f32 precision for the block (matmuls in full f32,
    cuDNN convs in TF32), as the reference runs; restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _onehot_steps_vs_k1(model, fs, cond_emb, r, rule, dev):
    """Phase 5b (a): three steps of the one-hot sampler's step
    (``predict_start`` -> a top-r filter -> ``q_posterior`` -> Gumbel argmax)
    against K1 on the same logits, each step from the one-hot chain's
    tokens, on one supplied noise; then the two samplers' three steps end to
    end. ``rule`` is the one-hot side's filter: "sort" (``truncate_top_r``,
    the reference's rule, which ``generate`` runs) or "bisect" (K1's rule,
    ``fused_sampler._truncate_rows``). Returns the counts over the steps'
    rows: posterior rows beyond POST_ATOL, token rows that differ, rows
    whose sort nucleus is not K1's (bisect) plus the classes of one value,
    the one that crosses r and its ties, and rows where those are more than
    one class; then the end-to-end token mismatches and the rows."""
    from functools import partial

    from text_to_sound_synthesis_torch.models.diffusion.process import (
        OneHotDraws, _timestep_plan, sample_tokens, sample_tokens_fused)
    from text_to_sound_synthesis_torch.ops import diffusion as dd
    from text_to_sound_synthesis_torch.ops.sampling import truncate_top_r

    diff = model.diffusion
    K, L = diff.num_classes, diff.content_seq_len
    sched = diff.schedule(dev)
    ts, t_post = _timestep_plan(N_STEPS, N_STEPS, 49)
    filter_fn = None
    if r:
        filter_fn = partial(truncate_top_r if rule == "sort" else fs._truncate_rows, r=r)
    coeffs = fs.step_coeffs(sched, t_post).as_array().contiguous()
    noise = dd.gumbel_from_uniform(torch.rand((len(ts), BATCH, L, K), device=dev,
                                              generator=torch.Generator(dev).manual_seed(SEED + 5)))
    log_z = torch.full((BATCH, L, K), -torch.inf, device=dev)
    log_z[..., -1] = 0.0
    boundary = tok_rows = off_nucleus = tied = 0
    with torch.no_grad(), model.compute_weights(diff):
        for i, (t, tp) in enumerate(zip(ts, t_post)):
            x_t = dd.log_onehot_to_index(log_z)
            t_vec = torch.full((BATCH,), t, dtype=torch.long, device=dev)
            log_x0 = diff.predict_start(x_t, cond_emb, t_vec)
            if r:
                keep_sort = truncate_top_r(log_x0, r) > dd.MIN_LOGP
                keep_bisect = fs._truncate_rows(log_x0, r) > dd.MIN_LOGP
                extra = keep_sort & ~keep_bisect
                hi = torch.where(extra, log_x0, -torch.inf).amax(dim=-1)
                lo = torch.where(extra, log_x0, torch.inf).amin(dim=-1)
                one_value = ~extra.any(dim=-1) | (hi == lo)
                off_nucleus += int(((keep_bisect & ~keep_sort).any(dim=-1) | ~one_value).sum())
                tied += int((extra.sum(dim=-1) > 1).sum())
                log_x0 = filter_fn(log_x0)
            post = dd.q_posterior(sched, log_x0, log_z,
                                  torch.full((BATCH,), tp, dtype=torch.long, device=dev))
            log_z = dd.log_sample_categorical(None, post, noise[i])
            logits = diff.backbone_logits(x_t, cond_emb, t_vec)
            k1_tok, k1_post = fs.fused_p_sample(logits, x_t, coeffs[i], 0, i, truncation_r=r,
                                                gumbel=noise[i], return_log_probs=True)
            err = (k1_post - post).abs().amax(dim=-1).flatten()
            boundary += int((err > POST_ATOL).sum())
            tok_rows += int((k1_tok != dd.log_onehot_to_index(log_z)).sum())
        onehot = sample_tokens(diff, cond_emb, skip_step=49, filter_fn=filter_fn,
                               draws=OneHotDraws(gumbel=noise))
        fused = sample_tokens_fused(diff, cond_emb, generator=torch.Generator(dev).manual_seed(SEED),
                                    truncation_r=r, skip_step=49, noise=noise)
    check(torch.equal(onehot, dd.log_onehot_to_index(log_z)),
          "one-hot: sample_tokens is not its three steps")
    return (boundary, tok_rows, off_nucleus, tied, int((onehot != fused).sum()),
            len(ts) * BATCH * L)


def write_vocoder_dir(vocoder, voc_dir: str) -> str:
    """Write ``vocoder`` in the reference's layout to ``voc_dir``: ``args.yml``
    (``VOC_ARGS``) and a weight-normed ``best_netG.pt``. Returns ``voc_dir``."""
    os.makedirs(voc_dir)
    with open(os.path.join(voc_dir, "args.yml"), "w") as f:
        f.write("".join(f"{k}: {v}\n" for k, v in VOC_ARGS.items()))
    wn = {}
    for k, w in vocoder.gen.state_dict().items():   # weight norm: v = 2 w, g = |w|
        w = w.cpu()
        if k.endswith(".weight"):
            wn[k + "_g"] = w.square().sum(dim=tuple(range(1, w.dim())), keepdim=True).sqrt()
            wn[k + "_v"] = 2 * w
        else:
            wn[k] = w
    torch.save(wn, os.path.join(voc_dir, "best_netG.pt"))
    return voc_dir


def phase_onehot(model, fs, vocoder, cond_tokens, cfg, dev):
    """Phase 5b: the one-hot reference sampler and the rest of the inference
    API on the bf16 flagship (module docstring). Returns the bench-scope
    seconds of the f32 one-hot reference and of the bf16 fused path, each
    in the order they ran."""
    import copy
    import tempfile

    from text_to_sound_synthesis_torch.models import build_model
    from text_to_sound_synthesis_torch.models.melgan import load_vocoder

    with torch.no_grad():
        cond_emb = model.embed_condition(cond_tokens)
    # (a) the one-hot steps against K1, per step and end to end. K1's nucleus
    # (bisection: keep p > tau, the largest set summing below r) leaves out
    # the class that crosses r, which the reference's rule (sort: keep while
    # the sum before a class is below r) keeps, with the classes tied with it
    # (bf16 logits tie often); so at r > 0 K1 is held to the one-hot step
    # under its own rule, and the reference rule to K1's nucleus plus the
    # classes of that one value.
    for r, rule in ((0.0, "sort"), (0.85, "bisect"), (0.85, "sort")):
        boundary, tok_rows, off_nucleus, tied, e2e, rows = _onehot_steps_vs_k1(
            model, fs, cond_emb, r, rule, dev)
        allowed = int(BOUNDARY_ROWS * rows)
        print(f"  (a) one-hot step ({'no filter' if not r else rule + ' rule'}) vs K1, r={r}, 3 "
              f"steps (fast49) from the one-hot chain's tokens: posterior rows beyond {POST_ATOL} "
              f"{boundary}/{rows}, token rows {tok_rows}/{rows}"
              + (f", rows whose sort nucleus is not K1's plus the crossing value's classes "
                 f"{off_nucleus}/{rows} (of which tied, more than one class: {tied})" if r else "")
              + f"; the two samplers end to end: {e2e}/{rows // 3} tokens differ")
        if rule == "sort" and r:
            check(off_nucleus <= allowed, f"one-hot vs K1 at r={r}: {off_nucleus} rows whose "
                  "nuclei differ by more than the crossing value's classes")
            continue
        check(boundary <= (allowed if r > 0 else 0),
              f"one-hot vs K1 at r={r}: {boundary} posterior rows beyond {POST_ATOL}")
        check(tok_rows <= allowed, f"one-hot vs K1 at r={r}: {tok_rows} token rows differ")
        check(e2e <= 0.01 * rows / 3, f"one-hot vs fused sampler at r={r}: {e2e} tokens differ")

    # (b) one-hot requests: no kernel of the port runs
    reqs = [("top100p", None), ("top0.85r,q0.5", None), ("top0.85r", False)]
    times = {}
    for i, (st, use_fused) in enumerate(reqs):
        gen = lambda g, st=st, use_fused=use_fused: model.generate(
            g, cond_tokens, sample_type=st, use_fused=use_fused, return_tokens=True)
        reset_counts()
        times[st] = request(gen, vocoder, SEED + 20 + i, dev)
        counts = read_counts()
        check(counts == expected_counts(), f"one-hot {st}: launches {counts}, expected none")
    print(f"  (b) one-hot requests, batch {BATCH} x {N_STEPS} steps, caption ids -> wav, no kernel "
          "launched: "
          + ", ".join(f"{st}{' use_fused=False' if uf is False else ''} {times[st]:.3f} s"
                      for st, uf in reqs))

    # (c) the codec round trip and the sample grid
    mel_in = (torch.rand((BATCH, *MEL, 1), generator=torch.Generator(dev).manual_seed(SEED + 6),
                         device=dev) * 2 - 1).to(model.dtype)
    rec = model.reconstruct(mel_in)
    check(tuple(rec.shape) == (BATCH, *MEL, 1) and bool(torch.isfinite(rec).all()),
          f"reconstruct: shape {tuple(rec.shape)} or not finite")
    grid = model.sample_grid(torch.Generator(dev).manual_seed(SEED + 7), mel_in[:2],
                             cond_tokens[:2], filter_ratios=(0.0, 0.5))
    names = ["input_image", "reconstruction_image", "cond1_cont1.0_fr0.0_image",
             "cond1_cont1.0_fr0.5_image"]
    check(list(grid) == names, f"sample_grid: keys {list(grid)}")
    for k, v in grid.items():
        check(tuple(v.shape) == (2, *MEL, 1) and bool(torch.isfinite(v).all()),
              f"sample_grid {k}: shape {tuple(v.shape)} or not finite")
    print(f"  (c) reconstruct {(BATCH, *MEL, 1)} and sample_grid (batch 2, filter ratios 0, "
          f"0.5): shapes and finite values as expected")

    # (d) the loaders: write the flagship codec and the vocoder in the
    # reference's layouts, load them on the card, compare with the sources
    with tempfile.TemporaryDirectory() as tmp:
        sd = {k: v.cpu() for k, v in model.codec.state_dict().items()}
        sd["loss.discriminator.main.0.weight"] = torch.zeros(64, 1, 4, 4)
        ckpt = os.path.join(tmp, "codec.ckpt")
        torch.save({"state_dict": sd, "epoch": 1}, ckpt)
        cfg2 = copy.deepcopy(cfg)
        cfg2["model"]["params"]["content_codec_config"]["params"]["ckpt_path"] = ckpt
        loaded = build_model(cfg2, device=dev, seed=SEED + 8)
        code = torch.randint(0, model.diffusion.num_classes - 1, (BATCH, *model.token_hw), device=dev,
                             generator=torch.Generator(dev).manual_seed(SEED + 9))
        with torch.no_grad(), loaded.compute_weights(), model.compute_weights():
            same = torch.equal(loaded.codec.decode_code(code), model.codec.decode_code(code))
        del loaded
        check(same, "codec .ckpt: decode_code differs from the source model's")

        voc2 = load_vocoder(write_vocoder_dir(vocoder, os.path.join(tmp, "vocoder")), device=dev)
        spec = ((rec[:2, ..., 0].float() + 1) / 2).clamp(0, 1)
        voc_err = float((voc2(spec) - vocoder(spec)).abs().max())
    print(f"  (d) codec .ckpt (Lightning layout, a loss.* entry) built and loaded on the card: "
          f"decode_code bit for bit the source's; vocoder args.yml + weight-normed best_netG.pt: "
          f"wav max|d| {voc_err:.3e} against the in-memory vocoder (gate {VOC_TOL})")
    check(voc_err <= VOC_TOL, f"vocoder loaded from best_netG.pt: wav off by {voc_err}")

    # (e) the reference sampler's time in bench.py's scope, the f32 copy under
    # PyTorch's default precision
    ref = reference_copy(model)
    ref_s, fused_s = [], []
    with pytorch_default_precision():
        with torch.no_grad():
            ref_emb = ref.embed_condition(cond_tokens)
        for i, fused in enumerate((True, False, False, True)):   # in turns
            m, emb = (model, cond_emb) if fused else (ref, ref_emb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mel, _ = bench_scope(m, emb, fused, torch.Generator(dev).manual_seed(SEED + 30 + i))
            torch.cuda.synchronize()
            (fused_s if fused else ref_s).append(time.perf_counter() - t0)
            check(tuple(mel.shape) == (BATCH, *MEL, 1) and bool(torch.isfinite(mel).all()),
                  "bench scope: mel shape or not finite")
    del ref
    print(f"  (e) bench.py's scope (sampler + decode_code, batch {BATCH}, {N_STEPS} steps, top0.85r; "
          f"no CLIP, no MelGAN) on {card_line()}: the f32 one-hot reference sampler "
          f"{ref_s[0]:.3f} / {ref_s[1]:.3f} s a request = {BATCH / min(ref_s):.3f} clips/s; the bf16 "
          f"fused path (K1) {fused_s[0]:.3f} / {fused_s[1]:.3f} s = {BATCH / min(fused_s):.3f} "
          f"clips/s (run fused, reference, reference, fused)")
    return ref_s, fused_s


def _plain_layer(schedule: str, qp, rt, xp, lyr, ck, cv, mods, ls, op, attn: str = "bf16"):
    """One layer of the int8 engine on ``schedule`` through ``op(kernel,
    plain, args, kw)``, which checks the kernel on the plain version's input
    and returns the plain output: "blocks" K4 -> K5 -> K3, "pair_chunked" K8
    -> K9 (4 chunks), "dense" six K6 and two K7; the attention blocks with
    the ``attn`` MHA."""
    from text_to_sound_synthesis_torch.ops import attention as ta
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import quant

    (mod1, mod2), H = mods, qp.n_head
    L, S = xp.shape[0] // BATCH, ck.shape[0] // BATCH
    if schedule == "dense":
        dense, ref = quant.fused_quant_dense_multi, quant.quant_dense_multi_reference
        mha = lambda q, k, v, valid: op(ta.fused_mha, ta.mha_reference, (q, k, v),
                                        dict(batch=BATCH, n_head=H, kv_valid=valid))
        q, k, v = op(dense, ref, (xp, (lyr.q.qw, lyr.k.qw, lyr.v.qw)),
                     dict(norm="adaln", mod=mod1, s_static=ls[0]))
        (x,) = op(dense, ref, (mha(q, k, v, L), (lyr.proj.qw,)),
                  dict(residual=xp, s_static=ls[1]))
        (q2,) = op(dense, ref, (x, (lyr.crossq.qw,)), dict(norm="adaln", mod=mod2, s_static=ls[2]))
        (x,) = op(dense, ref, (mha(q2, ck, cv, S), (lyr.crossproj.qw,)),
                  dict(residual=x, s_static=ls[3]))
        (hid,) = op(dense, ref, (x, (lyr.fc1.qw,)),
                    dict(norm="ln", mod=lyr.ln2_mod, act="gelu2", s_static=ls[4]))
        (x,) = op(dense, ref, (hid, (lyr.fc2.qw,)), dict(residual=x, s_static=ls[5]))
        return x
    mlp_args = (lyr.ln2_mod, lyr.fc1.qw, lyr.fc2.qw)
    if schedule == "pair_chunked":
        x = op(ib.attn_pair_block, ib.attn_pair_block_reference,
               (xp, torch.cat([mod1, mod2]), ck, cv, lyr.q.qw, lyr.k.qw, lyr.v.qw, lyr.proj.qw,
                lyr.crossq.qw, lyr.crossproj.qw),
               dict(batch=BATCH, n_head=H, q_valid=L, kv_valid=S, static_s=rt._pair(ls[0:4]),
                    attn=attn))
        return op(ib.mlp_block_chunked, ib.mlp_chunked_reference, (x, *mlp_args),
                  dict(n_chunks=4, static_s=rt._pair(ls[4:6])))
    w4 = dict(w4=qp.weight_bits == 4)
    x = op(ib.self_attn_block, ib.self_attn_block_reference,
           (xp, mod1, lyr.q.qw, lyr.k.qw, lyr.v.qw, lyr.proj.qw),
           dict(batch=BATCH, n_head=H, q_valid=L, static_s=rt._pair(ls[0:2]), attn=attn, **w4))
    x = op(ib.cross_attn_block, ib.cross_attn_block_reference,
           (x, mod2, ck, cv, lyr.crossq.qw, lyr.crossproj.qw),
           dict(batch=BATCH, n_head=H, kv_valid=S, static_s=rt._pair(ls[2:4]), attn=attn, **w4))
    return op(ib.mlp_block, ib.mlp_block_reference, (x, *mlp_args),
              dict(static_s=rt._pair(ls[4:6]), **w4))


def _step_tail(fs, qp, h, xt, coeffs, g):
    """``head_sample_reference``'s top0.85r step on backbone output ``h``:
    its tokens, its scores (the perturbed log-posterior it takes the argmax
    over), the log-probs (M, K), the log of the top-r threshold (M,) and the
    nucleus (M, K)."""
    tokens, post = fs.head_sample_reference(h, xt, qp.norm_out, qp.head_w, qp.head_b, coeffs,
                                            gumbel=g, truncation_r=0.85)
    lp = torch.log_softmax(fs.head_logits(h, qp.norm_out, qp.head_w, qp.head_b), dim=-1)
    lp = torch.cat([lp, torch.full_like(lp[:, :1], fs.MIN_LOGP)], dim=-1).clamp(fs.MIN_LOGP, 0.0)
    tau = fs._bisect_threshold(lp.exp(), 0.85)
    keep = (lp.exp() > tau) | (lp == lp.amax(dim=-1, keepdim=True))
    return tokens, post + g, lp, tau.log()[:, 0], keep


def _at(t, i):
    return t.gather(1, i.long()[:, None])[:, 0]


def _runner_up(plain):
    tokens, s = plain[:2]
    return s.scatter(1, tokens.long()[:, None], float("-inf")).argmax(dim=-1)


def _tie_band(plain, kern):
    """The score error of the kernel path against the plain path, taken on
    the rows where the two pick the same token and neither nucleus edge
    moves at it or at the plain runner-up: the TIE_QUANTILE quantile of
    |d score| at the token plus at the runner-up, and of |d log p| at the
    runner-up plus |d log threshold|. It is read off rows that did not flip,
    so a flipped row's own error never widens it."""
    (a, s_p, lp_p, lt_p, k_p), (b, s_k, lp_k, lt_k, k_k) = plain, kern
    r = _runner_up(plain)
    calm = (a == b) & (_at(k_p, a) == _at(k_k, a)) & (_at(k_p, r) == _at(k_k, r))
    ds = (s_k - s_p).abs()
    err = (_at(ds, a) + _at(ds, r))[calm]
    err_lp = ((_at(lp_k, r) - _at(lp_p, r)).abs() + (lt_k - lt_p).abs())[calm]
    return (float(torch.quantile(err, TIE_QUANTILE)), float(torch.quantile(err_lp, TIE_QUANTILE)))


def _ulp_nudge(x, gen):
    """``x`` with REF_ULP_SHARE of its nonzero finite elements moved by one
    ulp of its dtype, in magnitude, up or down with even odds (``gen`` draws
    which and which way)."""
    if not x.is_floating_point():
        return x
    bits = torch.int16 if x.element_size() == 2 else torch.int32
    u = torch.rand(x.shape, device=x.device, generator=gen)
    half = REF_ULP_SHARE / 2
    step = (u < half).to(bits) - ((u >= half) & (u < REF_ULP_SHARE)).to(bits)
    y = (x.view(bits) + step * ((x != 0) & torch.isfinite(x)).to(bits)).view(x.dtype)
    return torch.where(torch.isfinite(y), y, x)


def _band_within(band, ref_band):
    """Whether ``band`` (score, log p) lies within BAND_RATIO times the
    reference band in both components."""
    return all(b <= BAND_RATIO * r for b, r in zip(band, ref_band))


def _flip_rows(plain, path, band):
    """Each row's token flip between the plain path (its token a) and
    ``path`` (its token b), judged against ``band`` (``_tie_band``). A flip
    is a near-tie when the plain margin score(a) - score(b) is at most the
    band's score error; or, when a or b lies inside one path's nucleus and
    outside the other's, when that class's distance from the plain
    threshold in log p is at most the band's log p error. Returns the rows
    that flipped, those of them that are not near-ties, and the near-tie
    rows: those whose plain runner-up (or whose token or runner-up, by its
    distance from the threshold) lies within the band, and the flips that
    are near-ties."""
    (a, s_p, lp_p, lt_p, k_p), (b, k_k), (eps, eps_lp) = plain, (path[0], path[4]), band
    r = _runner_up(plain)
    edge_close = lambda c: (_at(lp_p, c) - lt_p).abs() <= eps_lp
    tie = _at(s_p, a) - _at(s_p, b) <= eps
    for c in (a, b):
        tie |= (_at(k_p, c) != _at(k_k, c)) & edge_close(c)
    near = (_at(s_p, a) - _at(s_p, r) <= eps) | edge_close(a) | edge_close(r)
    flipped = a != b
    return int(flipped.sum()), int((flipped & ~tie).sum()), int((near | flipped & tie).sum())


def check_int8_loop(model, qp, fs, dd, cond_tokens, dev, schedule: str = "blocks",
                    impl: str = "pallas", attn: str = "bf16"):
    """Three int8 sampler steps (the top0.85r,fast49 plan), kernels against
    the plain twins on one supplied noise (the attention blocks' twins with
    the ``attn`` MHA). Each step starts both paths from
    the plain path's tokens, so a row that tips at one step does not change
    the next step's inputs. The plain path is the twins of ``schedule``
    composed here, layer by layer (``_plain_layer``); on its input each
    kernel call must agree with its twin to BLOCK_TOL, as in phase 4 (K8, two
    blocks with no reset between them, to PAIR_TOL but for PAIR_OUTLIERS of
    its outputs). The
    kernel path is the engine's own layer loop (``impl``, and the switches
    the caller set). Composed over 19 layers, an int8 flip in one block
    moves the next block's input, and at a static scale a bf16 ulp of a block
    input can move an int8 value by one step, so the two paths drift apart:
    their backbone outputs must agree to STEP_REL (relative, in norm), and
    every row that picks another token must be a near-tie (``_flip_rows``):
    the plain path's margin between the two tokens, or at the nucleus edge
    to the threshold, no larger than the score error the kernel path shows
    on the rows that did not flip (``_tie_band``). Both of the gate's
    controls must fail it (TIE_QUANTILE). That band is capped by one the
    kernel path cannot set: the plain path run again with each kernel
    site's input moved by an ulp on REF_ULP_SHARE of its elements
    (``_ulp_nudge``) gives the reference band, and the kernel path's must lie
    within BAND_RATIO of it at every step, where DRIFT_CONTROL times the
    kernel path's drift must not (``_band_within``). With ``attn="pair"``, K4 and
    K5 are also held, over the three steps together, to PAIR_LOOP_SHARE of
    their outputs more than PAIR_BLOCK_ULPS off, a gate that the same blocks
    with the bf16 MHA, on the same inputs, must fail."""
    from text_to_sound_synthesis_torch.models.diffusion import int8_runtime as rt
    from text_to_sound_synthesis_torch.models.diffusion.process import _timestep_plan

    STEP_REL = 5e-2
    diff = model.diffusion
    L, K, T = diff.content_seq_len, diff.num_classes, diff.diffusion_step
    ts, t_post = _timestep_plan(T, T, 49)
    noise, other = (dd.gumbel_from_uniform(torch.rand(
        (len(ts), BATCH, L, K), device=dev, generator=torch.Generator(dev).manual_seed(s)))
        for s in (SEED, SEED + 5))
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    act_s = qp.act_scales or ((None,) * 6,) * len(qp.layers)
    stats = {"err": {}, "flips": 0, "n": 0, "beyond": 0, "pair": (0, 0, 0)}

    def op(kernel, plain, args, kw):
        want = plain(*args, **kw)
        name = kernel.__name__
        gate = (PAIR_TOL, PAIR_OUTLIERS) if name == "attn_pair_block" else (BLOCK_TOL, 0.0)
        got = kernel(*args, **kw)
        err, flips, n, beyond = _check_outputs(got, want,
                                               f"serving step {stats['step']}, {name}: ", *gate)
        stats["err"][name] = max(stats["err"].get(name, 0.0), err)
        stats.update(flips=stats["flips"] + flips, n=stats["n"] + n,
                     beyond=stats["beyond"] + beyond)
        if kw.get("attn") == "pair":
            ctrl = kernel(*args, **{**kw, "attn": "bf16"})
            far = (_ulp_flips(got, want, PAIR_BLOCK_ULPS), _ulp_flips(ctrl, want, PAIR_BLOCK_ULPS),
                   want.numel())
            stats["pair"] = tuple(a + b for a, b in zip(stats["pair"], far))
        return want

    nudge = torch.Generator(dev).manual_seed(SEED + 11)

    def nudged(kernel, plain, args, kw):
        return plain(_ulp_nudge(args[0], nudge), *args[1:], **kw)

    with torch.no_grad():
        kvs = rt.precompute_cond_kvs(qp, model.embed_condition(cond_tokens))
        coeffs = fs.step_coeffs(diff.schedule(dev), t_post).as_array().contiguous()
        tokens = torch.full((BATCH * L,), K - 1, dtype=torch.int32, device=dev)
        per_step = []
        for i, t in enumerate(ts):
            stats["step"] = i
            g = noise[i].reshape(BATCH * L, K)
            x = rt._int8_backbone_hidden(qp, tokens.reshape(BATCH, L), t, kvs, impl=impl)
            got = fs.fused_head_sample(x, tokens, qp.norm_out, qp.head_w, qp.head_b, coeffs[i],
                                       0, i, truncation_r=0.85, gumbel=g)
            xp = rt._embed(qp, tokens.reshape(BATCH, L))
            for lyr, (ck, cv), mods, ls in zip(qp.layers, kvs, rt._layer_mods(qp, t), act_s):
                xp = _plain_layer(schedule, qp, rt, xp, lyr, ck, cv, mods, ls, op, attn)
            plain = _step_tail(fs, qp, xp, tokens, coeffs[i], g)
            kern = (got,) + _step_tail(fs, qp, x, tokens, coeffs[i], g)[1:]
            band = _tie_band(plain, kern)
            noisy = (kern[1] - g + other[i].reshape(BATCH * L, K)).argmax(dim=-1).int()
            drift = (xp.float() + DRIFT_CONTROL * (x.float() - xp.float())).to(x.dtype)
            drifted = _step_tail(fs, qp, drift, tokens, coeffs[i], g)
            xr = rt._embed(qp, tokens.reshape(BATCH, L))
            for lyr, (ck, cv), mods, ls in zip(qp.layers, kvs, rt._layer_mods(qp, t), act_s):
                xr = _plain_layer(schedule, qp, rt, xr, lyr, ck, cv, mods, ls, nudged, attn)
            ref_band = _tie_band(plain, _step_tail(fs, qp, xr, tokens, coeffs[i], g))
            per_step.append((rel(x, xp), _flip_rows(plain, kern, band),
                             _flip_rows(plain, (noisy,) + kern[1:], band),
                             _flip_rows(plain, drifted, band), rel(drift, xp), band, ref_band,
                             _tie_band(plain, drifted)))
            tokens = plain[0]
    rows = BATCH * L
    errs = {k: float(f"{v:.3e}") for k, v in stats["err"].items()}
    pair = f", K8 outputs beyond {PAIR_TOL} {stats['beyond']}" if "attn_pair_block" in errs else ""
    print(f"  {schedule}, {attn} MHA: 3 steps (top0.85r,fast49) kernels vs plain twins, from the same "
          f"tokens each step: each kernel call on the twins' input within its gate (max|d| "
          f"{errs}, elements off by > 1 bf16 ulp {stats['flips']}/{stats['n']}{pair}); after "
          f"{len(qp.layers)} layers backbone output "
          f"relative error {[f'{p[0]:.2e}' for p in per_step]}; of {rows} rows a step, "
          f"band (score, log p) {[f'{p[5][0]:.3e}, {p[5][1]:.3e}' for p in per_step]}, "
          f"near-ties {[p[1][2] for p in per_step]}, tokens differing "
          f"{[p[1][0] for p in per_step]}, of those not near-ties "
          f"{[p[1][1] for p in per_step]}; controls (differing, not near-ties): the kernel path "
          f"under another noise {[p[2][:2] for p in per_step]}, the plain output plus "
          f"{DRIFT_CONTROL}x the kernel path's drift (relative error "
          f"{[f'{p[4]:.2e}' for p in per_step]}) {[p[3][:2] for p in per_step]}")
    ratio = lambda b, r: f"{b[0] / r[0]:.3f}, {b[1] / r[1]:.3f}"
    print(f"  {schedule}, {attn} MHA: band ceiling {BAND_RATIO} x the reference band (the plain "
          f"twins, each kernel site's input moved by 1 ulp on {REF_ULP_SHARE} of its elements): "
          f"reference band (score, log p) {[f'{p[6][0]:.3e}, {p[6][1]:.3e}' for p in per_step]}; "
          f"band / reference: the kernel path {[ratio(p[5], p[6]) for p in per_step]}, the plain "
          f"output plus {DRIFT_CONTROL}x its drift (band "
          f"{[f'{p[7][0]:.3e}, {p[7][1]:.3e}' for p in per_step]}) "
          f"{[ratio(p[7], p[6]) for p in per_step]}")
    check(all(p[0] <= STEP_REL for p in per_step),
          f"serving ({schedule}): kernel steps' backbone outputs disagree with the plain steps'")
    check(all(p[1][1] == 0 for p in per_step),
          f"serving ({schedule}): a token differs from the plain step's where no near-tie is")
    check(all(p[2][1] > 0 for p in per_step),
          f"serving ({schedule}): the near-tie gate passes the kernel path under another noise")
    check(sum(p[3][1] for p in per_step) > 0,
          f"serving ({schedule}): the near-tie gate passes {DRIFT_CONTROL}x the kernel path's drift")
    check(all(_band_within(p[5], p[6]) for p in per_step),
          f"serving ({schedule}): the kernel path's band exceeds {BAND_RATIO}x the reference band")
    check(not any(_band_within(p[7], p[6]) for p in per_step),
          f"serving ({schedule}): the band ceiling passes {DRIFT_CONTROL}x the kernel path's drift")
    if attn == "pair":
        far, ctrl, n = stats["pair"]
        print(f"  K4 / K5 with the pair MHA over the 3 steps: elements more than {PAIR_BLOCK_ULPS} "
              f"bf16 ulps off {far}/{n} (gate {PAIR_LOOP_SHARE}); with the bf16 MHA {ctrl}/{n}")
        check(far <= PAIR_LOOP_SHARE * n, f"serving: K4 / K5 with the pair MHA, {far}/{n} "
              f"elements more than {PAIR_BLOCK_ULPS} bf16 ulps off")
        check(ctrl > PAIR_LOOP_SHARE * n, "serving: the pair-MHA gate passes the bf16 MHA")


@contextlib.contextmanager
def switches(**env):
    """The JAX engine's kernel-selecting switches set for the block, and
    restored after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _counters():
    from text_to_sound_synthesis_torch.ops import attention as attn
    from text_to_sound_synthesis_torch.ops import attn_ablate
    from text_to_sound_synthesis_torch.ops import dot
    from text_to_sound_synthesis_torch.ops import fused_gn_conv as gn
    from text_to_sound_synthesis_torch.ops import fused_sampler as fs
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import mlp_ablate
    from text_to_sound_synthesis_torch.ops import quant

    return {"K1": fs.fused_p_sample, "K2": fs.fused_head_sample, "K3": ib.mlp_block,
            "K4": ib.self_attn_block, "K5": ib.cross_attn_block, "K6": quant.fused_quant_dense,
            "K6m": quant.fused_quant_dense_multi, "K7": attn.fused_mha, "K8": ib.attn_pair_block,
            "K9c": ib.mlp_block_chunked, "K9s": ib.mlp_block_streamed,
            "K10": ib.mha_inline_int8, "Kp": attn.mha_pair, "K11": gn.gn_swish_conv,
            "T1": dot.tiled_dot, "T2": mlp_ablate.mlp_variant, "T3": attn_ablate.attn_variant,
            "Kq": quant.quantize_rows, "Kw": quant.quantize_wide}


def reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in _counters().items()}


def expected_counts(**per_request):
    """Launches of one request: the given counts, the row quantize passes
    (unless given: two a K4 or K5 call, four a K8 call), every other kernel
    0 (the wide pass too, unless given)."""
    per_request.setdefault("Kq", 2 * (per_request.get("K4", 0) + per_request.get("K5", 0))
                           + 4 * per_request.get("K8", 0))
    return {k: per_request.get(k, 0) for k in _counters()}


def phase_w8(model, fs, dd, vocoder, cond_tokens, dev):
    """Phase 7: the W8A8 dynamic engine's kernel schedules (module docstring).
    Returns each path's request times and the launches summed over all
    requests."""
    LN = N_LAYER * N_STEPS
    qp8 = model.quantize_for_serving()
    check(qp8.weight_bits == 8 and qp8.act_scales is None, "W8 serving: engine not W8 dynamic")
    check_int8_loop(model, qp8, fs, dd, cond_tokens, dev, "dense", impl="pallas_dense")
    pair_chunked = dict(T2S_ATTN_PAIR="1", T2S_MLP_IMPL="chunked")
    with switches(**pair_chunked):
        check_int8_loop(model, qp8, fs, dd, cond_tokens, dev, "pair_chunked")
    # path: (switches, impl, launches per request)
    # under dynamic scales one wide pass a K3 or K9 call (its middle), and
    # one a layer of the per-dense path (fc2's input, 4096 wide); each of
    # the other five K6 calls a row pass
    paths = {"blocks": ({}, None, expected_counts(K2=N_STEPS, K3=LN, K4=LN, K5=LN, Kw=LN,
                                                   Kp=2 * LN)),
             "per-dense": ({}, "pallas_dense",
                           expected_counts(K2=N_STEPS, K6m=6 * LN, K7=2 * LN, Kq=5 * LN, Kw=LN)),
             "pair+chunked": (pair_chunked, None,
                              expected_counts(K2=N_STEPS, K8=LN, K9c=LN, Kw=LN)),
             "pair+streamed": (dict(T2S_ATTN_PAIR="1", T2S_MLP_IMPL="streamed"), None,
                               expected_counts(K2=N_STEPS, K8=LN, K9s=LN, Kw=LN))}
    # in turns, so that a drift of the card's clock reaches every path alike
    order = ("blocks", "per-dense", "pair+chunked", "pair+streamed", "pair+chunked", "per-dense",
             "blocks")
    torch.cuda.reset_peak_memory_stats()
    w8_times, w8_counts = {p: [] for p in paths}, {k: 0 for k in _counters()}
    for i, path in enumerate(order):
        env, impl, want = paths[path]
        generate = lambda g: model.generate_int8(qp8, g, cond_tokens, sample_type="top0.85r",
                                                 impl=impl, return_tokens=True)
        with switches(**env):
            reset_counts()
            w8_times[path].append(request(generate, vocoder, SEED + i, dev))
            counts = read_counts()
        check(counts == want, f"W8 {path}: launches {counts} per request, expected {want}")
        w8_counts = {k: w8_counts[k] + v for k, v in counts.items()}
        print(f"  W8 dynamic {path:<13} request of batch {BATCH} x {N_STEPS} steps: "
              f"{w8_times[path][-1]:.3f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return w8_times, w8_counts, qp8


def phase_attention_serving(model, qp, qp8, fs, dd, vocoder, cond_tokens, dev):
    """Phase 8: the engines with the int8 MHA (module docstring). Returns
    each path's request times and the launches summed over its requests."""
    LN = N_LAYER * N_STEPS
    base = dict(T2S_ATTN_INT8="1", T2S_ATTN_MHA="base")
    with switches(**base):
        check_int8_loop(model, qp, fs, dd, cond_tokens, dev, attn="int8")
    # path: (engine, switches, launches per request)
    paths = {"W4A8 static": (qp, base, expected_counts(K2=N_STEPS, K3=LN, K4=LN, K5=LN,
                                                       K10=2 * LN)),
             "W8 dynamic pair": (qp8, dict(T2S_ATTN_PAIR="1", T2S_ATTN_INT8="1"),
                                 expected_counts(K2=N_STEPS, K3=LN, K8=LN, K10=2 * LN, Kw=LN))}
    times, total = {p: [] for p in paths}, {k: 0 for k in _counters()}
    for i, path in enumerate(("W4A8 static", "W8 dynamic pair", "W4A8 static")):
        engine, env, want = paths[path]
        generate = lambda g: model.generate_int8(engine, g, cond_tokens, sample_type="top0.85r",
                                                 return_tokens=True)
        with switches(**env):
            reset_counts()
            times[path].append(request(generate, vocoder, SEED + i, dev))
            counts = read_counts()
        check(counts == want, f"int8 MHA {path}: launches {counts} per request, expected {want}")
        total = {k: total[k] + v for k, v in counts.items()}
        print(f"  {path} request with the int8 MHA, batch {BATCH} x {N_STEPS} steps: "
              f"{times[path][-1]:.3f} s; launches { {k: v for k, v in counts.items() if v} }")
    return times, total


def phase_long(model, qp, vocoder, cond_tokens, dev):
    """Phase 9: one W4A8 ``generate_long`` request (module docstring).
    Returns its seconds, caption ids to wav.

    The cross-fade is checked against the segments it was given (captured
    from the one sampler call): where one segment alone covers a frame its
    weight is 1 and the output is that segment's frame exactly; everywhere
    the output is the weighted mean of the covering segments, recomputed in
    float64 on the host, to a bf16 rounding or two. The mel of random
    weights is not bounded (the codec's decoder ends in a convolution), so
    its range is printed, not checked; the wav is in [-1, 1]."""
    LN = N_LAYER * N_STEPS
    seg, ov = 848, 160
    hop = seg - ov
    n_seg = -(-(LONG_FRAMES - seg) // hop) + 1
    segments = []
    real = model.generate_int8

    def spy(engine, g, c, **kw):
        mel = real(engine, g, c, **kw)
        segments.append(mel)
        return mel

    model.generate_int8 = spy
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        mel = model.generate_long(torch.Generator(dev).manual_seed(SEED), cond_tokens,
                                  duration_frames=LONG_FRAMES, overlap_frames=ov, qp=qp)
        wav = vocoder((mel[..., 0].float() + 1.0) / 2.0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        del model.generate_int8
    want = expected_counts(K2=N_STEPS, K3=LN, K4=LN, K5=LN, Kp=2 * LN)
    rows = [s.shape[0] for s in segments]
    check(rows == [BATCH * n_seg], f"long: sampler calls of {rows} rows, expected one of "
          f"{BATCH * n_seg}")
    check(counts == want, f"long: launches {counts}, expected {want}")
    check(tuple(mel.shape) == (BATCH, 80, LONG_FRAMES, 1), f"long: mel shape {tuple(mel.shape)}")
    check(bool(torch.isfinite(mel).all()), "long: mel not finite")
    check(tuple(wav.shape) == (BATCH, LONG_FRAMES * 256), f"long: wav shape {tuple(wav.shape)}")
    check(bool(torch.isfinite(wav).all()) and float(wav.abs().max()) <= 1.0,
          "long: wav not finite or outside [-1, 1]")
    segs = segments[0].reshape(BATCH, n_seg, 80, seg, 1)
    for i in range(n_seg):
        lo = i * hop + (ov if i else 0)
        hi = min(i * hop + (hop if i < n_seg - 1 else seg), LONG_FRAMES)
        check(torch.equal(mel[:, :, lo:hi], segs[:, i, :, lo - i * hop:hi - i * hop]),
              f"long: frames {lo}-{hi} differ from segment {i}, their only cover")
    s64 = segs.double().cpu()
    ramp = torch.arange(1, ov + 1, dtype=torch.float64) / (ov + 1)
    up = torch.cat([ramp, torch.ones(hop, dtype=torch.float64)])
    num = torch.zeros((BATCH, 80, hop * (n_seg - 1) + seg, 1), dtype=torch.float64)
    den = torch.zeros(hop * (n_seg - 1) + seg, dtype=torch.float64)
    for i in range(n_seg):
        w = (up if i else 1.0) * (up.flip(0) if i < n_seg - 1 else 1.0) * torch.ones(seg)
        num[:, :, i * hop:i * hop + seg] += s64[:, i] * w[None, None, :, None]
        den[i * hop:i * hop + seg] += w
    ref = (num / den[None, None, :, None])[:, :, :LONG_FRAMES]
    err, _ = _block_err(mel.cpu(), ref, "long: cross-fade against its float64 recomputation: ")
    lo_v, hi_v = float(mel.min()), float(mel.max())
    print(f"  W4A8 generate_long, batch {BATCH}, {LONG_FRAMES} frames ({LONG_FRAMES * 256 / 22050:.1f}"
          f" s of audio): {n_seg} segments a caption, one sampler call of {rows[0]} rows; frames "
          f"covered by one segment equal it, the cross-fade within {err:.3e} of its float64 "
          f"recomputation; mel in [{lo_v:.3f}, {hi_v:.3f}] (segments [{float(segs.min()):.3f}, "
          f"{float(segs.max()):.3f}]); {seconds:.3f} s caption ids -> wav; launches "
          f"{ {k: v for k, v in counts.items() if v} }; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return seconds


# -- phase 10: Stage-2 training --------------------------------------------------------

TRAIN_BATCH, TRAIN_STEPS, EMA_INTERVAL = 20, 30, 25    # the flagship config's solver block
SMALL_BATCH = 4
SHARD_BATCH, SHARD_SKIP = 4, 10         # (f): batch 4 a shard, fast10 = 10 steps
# (b) the card's step against the CPU's, both in full f32 (TF32 off for the
# matmuls and cuDNN's convs): the loss and the grad norm within TRAIN_RTOL; the
# weights within TRAIN_ATOL but for at most TRAIN_SHARE of a tensor's values,
# none beyond 2 lr. AdamW's first steps move a weight by lr g / (|g| + eps): a
# gradient rounded another way moves that by a relative 1e-4 or less, except
# near or below eps = 1e-8, where a rounding of 1e-10 moves it by 1e-5; the
# attention keys' biases have a zero gradient in exact arithmetic (the softmax
# does not see a shift all keys share), so each side steps them by its own
# rounding and they are held to 2 lr alone (tests/test_torch_train.py).
TRAIN_RTOL, TRAIN_ATOL, TRAIN_SHARE = 1e-4, 2e-6, 1e-3


def small_train_config() -> dict:
    """The small composite of phase 10 (b)-(e): the flagship's structure at
    toy widths (mel 8 x 32 -> a 4 x 16 grid of 64 codes; 2 denoiser layers of
    d128, 4 heads; a 2-layer CLIP of width 64 over the full vocabulary, 77
    ids) and 100 diffusion steps; its solver block is the flagship's but for
    a larger rate, two epochs and EMA every 2 steps."""
    dd_cfg = dict(double_z=False, z_channels=32, resolution=32, in_channels=1, out_ch=1, ch=16,
                  ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16], dropout=0.0)
    model = {"target": "text_to_sound_synthesis_tpu.models.Diffsound", "params": {
        "content_codec_config": {"target": "text_to_sound_synthesis_tpu.models.vqgan.VQModel",
                                 "params": {"embed_dim": 32, "n_embed": 64, "ddconfig": dd_cfg}},
        "first_stage_permuter_config": {
            "target": "text_to_sound_synthesis_tpu.ops.permuter.ColumnMajor",
            "params": {"H": 4, "W": 16}},
        "condition_codec_config": {"target": "text_to_sound_synthesis_tpu.models.clip.Tokenize",
                                   "params": {"context_length": CTX}},
        "diffusion_config": {
            "target": "text_to_sound_synthesis_tpu.models.diffusion.DiscreteDiffusion",
            "params": {
                "diffusion_step": N_STEPS,
                "transformer_config": {
                    "target": "text_to_sound_synthesis_tpu.models.diffusion.Text2SpecTransformer",
                    "params": dict(n_layer=2, n_embd=128, n_head=4, content_seq_len=64,
                                   condition_dim=64, content_spatial_size=(4, 16))},
                "condition_emb_config": {
                    "target": "text_to_sound_synthesis_tpu.models.clip.CLIPTextEmbedding",
                    "params": dict(embed_dim=64, width=64, layers=2, heads=2,
                                   context_length=CTX)},
                "content_emb_config": {
                    "target": "text_to_sound_synthesis_tpu.models.diffusion.ContentEmbedding",
                    "params": dict(num_embed=64, embed_dim=128, spatial_size=(4, 16))}}}}}
    solver = {
        "base_lr": 1e-3, "adjust_lr": "none", "max_epochs": 2, "save_epochs": 1,
        "validation_epochs": 1, "sample_iterations": 2,
        "ema": {"decay": 0.9, "update_interval": 2},
        "clip_grad_norm": {"target": "text_to_sound_synthesis_tpu.engine.ClipGradNorm",
                           "params": {"start_iteration": 0, "end_iteration": 5000,
                                      "max_norm": 0.5}},
        "optimizers_and_schedulers": [{
            "name": "none",
            "optimizer": {"target": "adamw",
                          "params": {"betas": (0.9, 0.96), "weight_decay": 4.5e-2}},
            "scheduler": {"step_iteration": 1,
                          "target": "text_to_sound_synthesis_tpu.engine.ReduceLROnPlateauWithWarmup",
                          "params": {"factor": 0.5, "patience": 25000, "min_lr": 1e-6,
                                     "threshold": 0.1, "warmup_lr": 2e-3, "warmup": 4}}}]}
    return {"model": model, "solver": solver, "dataloader": {"batch_size": SMALL_BATCH}}


SMALL_MEL = (8, 32)


def _train_draws(gen, B: int, T: int, L: int, K: int):
    """One step's draws (the timesteps', q_sample's noise) from ``gen``, to supply."""
    from text_to_sound_synthesis_torch.engine.train_state import TrainDraws
    from text_to_sound_synthesis_torch.models.diffusion.process import TimestepDraws
    from text_to_sound_synthesis_torch.ops.diffusion import gumbel_from_uniform

    dev = gen.device
    return TrainDraws(
        TimestepDraws(gumbel_from_uniform(torch.rand((B, T), generator=gen, device=dev)),
                      torch.randint(0, T, (B,), generator=gen, device=dev)),
        gumbel_from_uniform(torch.rand((B, L, K), generator=gen, device=dev)))


def _small_state(model, cfg):
    """(train state, step) of the small config's solver block."""
    from text_to_sound_synthesis_torch.engine import (ClipGradNorm, DiffusionTrainState,
                                                      build_optimizer, make_train_step)

    sv = cfg["solver"]
    den = model.diffusion.transformer
    opt = build_optimizer(sv["optimizers_and_schedulers"][0]["optimizer"], den, sv["base_lr"])
    state = DiffusionTrainState.create(den, opt, model.diffusion.diffusion_step)
    return state, lambda ddp=None: make_train_step(
        model, ClipGradNorm(**sv["clip_grad_norm"]["params"]), sv["ema"]["decay"],
        sv["ema"]["update_interval"], ddp=ddp)


def _small_batch(rng, dev, n=SMALL_BATCH):
    mel = rng.uniform(-1, 1, (n, *SMALL_MEL, 1)).astype(np.float32)
    return {"image": torch.from_numpy(mel).to(dev), "condition_token": caption_ids(rng, n).to(dev)}


def _weights_close(got, want, what: str, lr: float) -> int:
    """The (b) gate on one tensor (TRAIN_ATOL / TRAIN_SHARE); -> values beyond TRAIN_ATOL."""
    d = (got.detach().cpu() - want.detach().cpu()).abs()
    check(float(d.max()) <= 2 * lr, f"train (b): {what} off by {float(d.max()):.3e} > 2 lr")
    n = int((d > TRAIN_ATOL).sum())
    if not what.endswith("key.bias"):
        check(n <= TRAIN_SHARE * d.numel(), f"train (b): {what}: {n} of {d.numel()} values "
              f"more than {TRAIN_ATOL} off")
    return n


def _snapshot(model, state):
    return ([p.detach().clone() for _, p in state.named_params()],
            [e.clone() for e in state.ema_params], state.lt.Lt_history.clone(),
            state.lt.Lt_count.clone(),
            [v.clone() for s in state.optimizer.state.values() for v in s.values()
             if torch.is_tensor(v)])


def _snapshots_equal(a, b) -> bool:
    flat = lambda s: [*s[0], *s[1], s[2], s[3], *s[4]]
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


class FlagshipTrainer:
    """The flagship from the YAML on the card with its config's solver block,
    ``dtype`` its compute dtype (f32 parameters either way): the train state,
    the step, the scheduler and one seeded batch of TRAIN_BATCH (also
    ``chip_profile.py train``'s)."""

    def __init__(self, dev, dtype: str = "float32"):
        from text_to_sound_synthesis_torch.engine import (DiffusionTrainState, build_optimizer,
                                                          make_train_step)
        from text_to_sound_synthesis_torch.models import build_model
        from text_to_sound_synthesis_torch.utils.config import (instantiate_from_config,
                                                                load_yaml_config)

        cfg = load_yaml_config(CONFIG)
        cfg["model"]["params"]["dtype"] = dtype
        self.solver_cfg = sv = cfg["solver"]
        oas = sv["optimizers_and_schedulers"][0]
        check(int(cfg["dataloader"]["batch_size"]) == TRAIN_BATCH
              and int(sv["ema"]["update_interval"]) == EMA_INTERVAL,
              "train: the config's solver block moved")
        t0 = time.perf_counter()
        self.model = build_model(cfg, device=dev, seed=SEED + 10)
        self.denoiser = den = self.model.diffusion.transformer
        self.base_lr = float(sv["base_lr"])
        self.sched = instantiate_from_config(oas["scheduler"], base_lr=self.base_lr)
        self.clip = instantiate_from_config(sv["clip_grad_norm"])
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        self.state = DiffusionTrainState.create(
            den, build_optimizer(oas["optimizer"], den, self.base_lr),
            self.model.diffusion.diffusion_step)
        self.step_fn = make_train_step(self.model, self.clip, float(sv["ema"]["decay"]),
                                       EMA_INTERVAL)
        self.gen = torch.Generator(dev).manual_seed(SEED + 10)
        rng = np.random.default_rng(SEED + 10)
        self.batch = {
            "image": torch.rand((TRAIN_BATCH, *MEL, 1), generator=self.gen, device=dev) * 2 - 1,
            "condition_token": caption_ids(rng, TRAIN_BATCH).to(dev)}

    def step(self, draws=None):
        """One step at the scheduler's rate; the scheduler then takes its loss."""
        self.state, m = self.step_fn(self.state, self.batch, self.sched.lr, generator=self.gen,
                                     draws=draws)
        self.sched.step(float(m.loss))
        return m


def _train_flagship(dev, dtype: str = "float32", label: str = "(a)"):
    """(a): the flagship in f32 (or 10b (e) in ``dtype``), the config's solver
    block, TRAIN_STEPS steps on one batch. -> (median step s, samples/s, peak
    GiB, trainable params)."""
    tr = FlagshipTrainer(dev, dtype)
    model, den, sv, clip, base_lr = tr.model, tr.denoiser, tr.solver_cfg, tr.clip, tr.base_lr
    n_train = sum(p.numel() for p in den.parameters())
    print(f"  {label} flagship in {model.dtype}: {n_train / 1e6:.1f} M trainable parameters "
          f"({len(den.blocks)} layers), codec and CLIP frozen; built in {tr.build_s:.1f} s")
    gen = tr.gen
    K, L, T = model.diffusion.num_classes, model.diffusion.content_seq_len, N_STEPS
    first = _train_draws(gen, TRAIN_BATCH, T, L, K)
    start = [p.detach().clone() for p in den.parameters()]
    watch = lambda: [tr.state.ema_params[0].clone(), tr.state.ema_params[-1].clone()]
    losses, norms, secs = [], [], []
    with pytorch_default_precision():
        for i in range(TRAIN_STEPS):
            before = watch()
            t1 = time.perf_counter()
            m = tr.step(first if i in (0, TRAIN_STEPS - 1) else None)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            losses.append(float(m.loss))
            norms.append(float(m.grad_norm))
            state = tr.state
            changed = any(not torch.equal(a, b) for a, b in zip(before, watch()))
            check(changed == (state.step % EMA_INTERVAL == 0),
                  f"train {label}: the EMA {'changed' if changed else 'held'} at step {state.step}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)), f"train {label}: a loss is not finite: {losses}")
    check(all(np.isfinite(norms)), f"train {label}: a grad norm is not finite: {norms}")
    check(losses[-1] < losses[0], f"train {label}: the loss under step 1's draws went from "
          f"{losses[0]:.5f} to {losses[-1]:.5f} at step {TRAIN_STEPS}")
    moved = sum(not torch.equal(a, p) for a, p in zip(start, den.parameters()))
    check(moved == len(start), f"train {label}: {len(start) - moved} parameter tensors did not move")
    check(int(state.lt.Lt_count.sum()) == TRAIN_STEPS * TRAIN_BATCH,
          f"train {label}: Lt_count sums to {float(state.lt.Lt_count.sum())}")
    moments = [v for st in state.optimizer.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0]
    kinds = {t.dtype for t in (*model.parameters(), *moments, *state.ema_params)}
    check(kinds == {torch.float32} and len(moments) == 2 * len(start),
          f"train {label}: parameters, moments and EMA in {kinds}, {len(moments)} moments")
    med = float(np.median(secs[1:]))
    print(f"  {label} {TRAIN_STEPS} steps at batch {TRAIN_BATCH} (AdamW (0.9, 0.96), wd 4.5e-2, "
          f"plateau warmup from {base_lr:g}, clip {clip.max_norm} at every step, EMA "
          f"{sv['ema']['decay']} every {EMA_INTERVAL}): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"under step 1's draws, range [{min(losses):.4f}, {max(losses):.4f}]; grad norm "
          f"{norms[0]:.3f} -> {norms[-1]:.3f}; the EMA moved at step {EMA_INTERVAL} only; "
          f"Lt_count {int(state.lt.Lt_count.sum())}")
    print(f"  {label} step time: first {secs[0]:.3f} s, median of the rest {med:.4f} s "
          f"(min {min(secs[1:]):.4f}, max {max(secs[1:]):.4f}) = {TRAIN_BATCH / med:.2f} "
          f"samples/s; peak memory {peak:.2f} GiB ("
          f"{'matmuls f32, cuDNN convs TF32' if dtype == 'float32' else dtype + ' compute'}; "
          f"parameters, AdamW moments and EMA f32)")
    del tr, model, den, state, start, moments
    torch.cuda.empty_cache()
    return med, TRAIN_BATCH / med, peak, n_train


def _train_card_vs_cpu(dev):
    """(b): three steps of the small config on the card against the same steps
    on the CPU, the draws supplied, in full f32."""
    import copy

    from text_to_sound_synthesis_torch.utils.dtype import full_f32

    from text_to_sound_synthesis_torch.models import build_model

    cfg = small_train_config()
    cpu = build_model(cfg["model"], device="cpu", seed=SEED + 20)
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(SEED + 20)
    batch = _small_batch(rng, "cpu")
    cbatch = {k: v.to(dev) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(SEED + 20)
    diff = cpu.diffusion
    draws = [_train_draws(gen, SMALL_BATCH, diff.diffusion_step, diff.content_seq_len,
                          diff.num_classes) for _ in range(3)]
    lr = cfg["solver"]["base_lr"]
    with full_f32():
        tok_cpu = cpu.encode_content(batch["image"])
        tok_card = card.encode_content(cbatch["image"]).cpu()
        check(torch.equal(tok_cpu, tok_card), f"train (b): the codec's tokens differ in "
              f"{int((tok_cpu != tok_card).sum())} of {tok_cpu.numel()}")
        s_cpu, step_cpu = _small_state(cpu, cfg)
        s_card, step_card = _small_state(card, cfg)
        f_cpu, f_card = step_cpu(), step_card()
        worst = 0.0
        for i, d in enumerate(draws):
            s_cpu, m_cpu = f_cpu(s_cpu, batch, lr, draws=d)
            s_card, m_card = f_card(s_card, cbatch, lr, draws=d)
            check(torch.equal(m_cpu.t, m_card.t.cpu()), f"train (b): step {i + 1}'s t differ")
            for what, a, b in (("loss", m_card.loss, m_cpu.loss),
                               ("grad norm", m_card.grad_norm, m_cpu.grad_norm)):
                rel = abs(float(a) - float(b)) / abs(float(b))
                worst = max(worst, rel)
                check(rel <= TRAIN_RTOL, f"train (b): step {i + 1}'s {what} {float(a):.6f} on "
                      f"the card, {float(b):.6f} on the CPU")
    beyond = 0
    for (n, p), (_, q) in zip(s_card.named_params(), s_cpu.named_params()):
        beyond += _weights_close(p, q, n, lr)
    for (n, _), e, f in zip(s_card.named_params(), s_card.ema_params, s_cpu.ema_params):
        beyond += _weights_close(e, f, "EMA " + n, lr)
    check(torch.equal(s_card.lt.Lt_count.cpu(), s_cpu.lt.Lt_count), "train (b): Lt_count differ")
    hist = (s_card.lt.Lt_history.cpu() - s_cpu.lt.Lt_history).abs().max()
    check(float(hist) <= TRAIN_RTOL * float(s_cpu.lt.Lt_history.abs().max()),
          f"train (b): Lt_history off by {float(hist):.3e}")
    n_vals = sum(p.numel() for _, p in s_cpu.named_params())
    print(f"  (b) small config ({n_vals / 1e6:.2f} M trainable), 3 steps in full f32, card vs "
          f"CPU on the same draws: the codec's tokens equal, loss and grad norm within "
          f"{worst:.2e} (gate {TRAIN_RTOL}), {beyond} of {2 * n_vals} weights and EMA values "
          f"more than {TRAIN_ATOL} off (gate {TRAIN_SHARE} of each tensor), timestep state equal")


def _train_resume(dev):
    """(c): 10 steps, save, restore into a fresh state, 5 more steps from each:
    bit for bit equal."""
    import tempfile

    from text_to_sound_synthesis_torch.engine import checkpoint as ck
    from text_to_sound_synthesis_torch.models import build_model
    from text_to_sound_synthesis_torch.utils.config import instantiate_from_config

    cfg = small_train_config()
    sched_cfg = cfg["solver"]["optimizers_and_schedulers"][0]["scheduler"]
    batch = _small_batch(np.random.default_rng(SEED + 30), dev)

    def run(model, state, step, gen, sched, n):
        losses = []
        for _ in range(n):
            state, m = step(state, batch, sched.lr, generator=gen)
            losses.append(float(m.loss))
            sched.step(losses[-1])
        return losses

    model = build_model(cfg["model"], device=dev, seed=SEED + 30)
    state, make = _small_state(model, cfg)
    step = make()
    gen = torch.Generator(dev).manual_seed(SEED + 30)
    sched = instantiate_from_config(sched_cfg, base_lr=cfg["solver"]["base_lr"])
    run(model, state, step, gen, sched, 10)
    with tempfile.TemporaryDirectory() as tmp:
        path = ck.save_checkpoint(os.path.join(tmp, "last.pth"), ck.train_payload(
            model, state, last_epoch=0, scheduler=sched, generator_states=[gen.get_state()]))
        size = os.path.getsize(path)
        want_losses = run(model, state, step, gen, sched, 5)
        want = _snapshot(model, state)
        model2 = build_model(cfg["model"], device=dev, seed=SEED + 31)
        state2, make2 = _small_state(model2, cfg)
        sched2 = instantiate_from_config(sched_cfg, base_lr=cfg["solver"]["base_lr"])
        host = ck.restore_train_state(ck.load_checkpoint(path), model2, state2, scheduler=sched2)
    gen2 = torch.Generator(dev)
    gen2.set_state(host["generator_states"][0])
    got_losses = run(model2, state2, make2(), gen2, sched2, 5)
    check(host["last_iter"] == 10, f"train (c): restored at step {host['last_iter']}")
    check(got_losses == want_losses and _snapshots_equal(_snapshot(model2, state2), want)
          and sched2.state_dict() == sched.state_dict(),
          "train (c): the resumed run differs from the uninterrupted one")
    print(f"  (c) checkpoint round trip ({size / 2**20:.1f} MiB, the reference's layout): "
          f"10 steps, save, restore into a fresh model, 5 more steps: params, EMA, Adam moments, "
          f"timestep state, scheduler and losses bit for bit those of 15 steps uninterrupted")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train_ddp(dev):
    """(d): a one-rank NCCL group: the step under DDP against the step
    without, three steps on the same draws: bit for bit."""
    import copy

    import torch.distributed as dist

    from text_to_sound_synthesis_torch.models import build_model
    from text_to_sound_synthesis_torch.parallel import init_distributed, wrap_ddp

    cfg = small_train_config()
    plain = build_model(cfg["model"], device=dev, seed=SEED + 40)
    under = copy.deepcopy(plain)
    batch = _small_batch(np.random.default_rng(SEED + 40), dev)
    diff = plain.diffusion
    gen = torch.Generator(dev).manual_seed(SEED + 40)
    draws = [_train_draws(gen, SMALL_BATCH, diff.diffusion_step, diff.content_seq_len,
                          diff.num_classes) for _ in range(3)]
    lr = cfg["solver"]["base_lr"]
    t0 = time.perf_counter()
    init_distributed(dev, init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        s_plain, make_plain = _small_state(plain, cfg)
        s_ddp, make_ddp = _small_state(under, cfg)
        ddp = wrap_ddp(under.diffusion.transformer, dev)
        check(isinstance(ddp, torch.nn.parallel.DistributedDataParallel), "train (d): no DDP")
        f_plain, f_ddp = make_plain(), make_ddp(ddp)
        same = True
        for d in draws:
            s_plain, m_plain = f_plain(s_plain, batch, lr, draws=d)
            s_ddp, m_ddp = f_ddp(s_ddp, batch, lr, draws=d)
            same &= all(torch.equal(a, b) for a, b in zip(m_plain, m_ddp))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    same &= _snapshots_equal(_snapshot(plain, s_plain), _snapshot(under, s_ddp))
    check(same, "train (d): the step under DDP (one rank) differs from the step without")
    print(f"  (d) one-rank {backend} group: 3 steps under DDP bit for bit the steps without "
          f"(params, EMA, Adam moments, timestep state, metrics); group up and down in "
          f"{time.perf_counter() - t0:.1f} s")


class _TokenDataset:
    """In-memory items carrying BPE ids (``condition_token``): no BPE table."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.image = rng.uniform(-1, 1, (n, 1, *SMALL_MEL)).astype(np.float32)
        self.token = caption_ids(rng, n).numpy()

    def __len__(self):
        return len(self.image)

    def __getitem__(self, i):
        return {"image": self.image[i], "condition_token": self.token[i]}


def _train_solver(dev):
    """(e): the Solver on the small config: two epochs of two iterations on an
    in-memory dataset (checkpoints, validation, in-training sampling on K1),
    then a fresh Solver resumed from them."""
    import tempfile

    from text_to_sound_synthesis_torch.data.loader import ShardedLoader
    from text_to_sound_synthesis_torch.engine import Solver
    from text_to_sound_synthesis_torch.engine.logger import Logger
    from text_to_sound_synthesis_torch.models import build_model

    cfg = small_train_config()
    ds = _TokenDataset(2 * SMALL_BATCH, SEED + 50)
    loaders = lambda: {"train_loader": ShardedLoader(ds, SMALL_BATCH, seed=0),
                       "train_iterations": 2,
                       "validation_loader": ShardedLoader(ds, SMALL_BATCH, seed=0, shuffle=False)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        solver = Solver(cfg, build_model(cfg["model"], device=dev, seed=SEED + 50), loaders(),
                        Logger(tmp, "run"), seed=SEED)
        solver.train()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        names = sorted(os.listdir(solver.logger.ckpt_dir))
        samples = os.listdir(os.path.join(solver.logger.run_dir, "samples"))
        resumed = Solver(cfg, build_model(cfg["model"], device=dev, seed=SEED + 51), loaders(),
                         Logger(tmp, "run"), seed=SEED)
        ok = resumed.resume()
    check(solver.state.step == 4, f"train (e): {solver.state.step} steps, expected 4")
    check({"last.pth", "auto_a.pth", "auto_b.pth"} <= set(names), f"train (e): saved {names}")
    check(any(n.endswith(".npy") for n in samples), "train (e): no in-training samples")
    check(ok and resumed.state.step == 4 and resumed.last_epoch == 1,
          f"train (e): resumed at step {resumed.state.step}, epoch {resumed.last_epoch}")
    check(all(torch.equal(a, b) for a, b in zip(resumed.model.parameters(),
                                                solver.model.parameters()))
          and all(torch.equal(a, b) for a, b in zip(resumed.state.ema_params,
                                                    solver.state.ema_params)),
          "train (e): the resumed weights differ from the saved ones")
    print(f"  (e) Solver: 2 epochs x 2 iterations at batch {SMALL_BATCH} with validation and "
          f"in-training sampling in {secs:.1f} s; saved {', '.join(names)}; a fresh Solver "
          f"resumed 'last' (step 4, epoch 1), weights and EMA bit for bit")


def _sharded_samplers(model, qp, cond_tokens, dev):
    """(f): the bf16 fused and the W4A8 int8 sampler, two shards of batch
    SHARD_BATCH on the one card, against per-shard runs with the folded
    seeds, with their launches."""
    from text_to_sound_synthesis_torch.models.diffusion import int8_runtime as rt
    from text_to_sound_synthesis_torch.models.diffusion.process import (
        _timestep_plan, sample_tokens_fused, sample_tokens_fused_sharded)
    from text_to_sound_synthesis_torch.parallel import fold_seed

    n_steps = len(_timestep_plan(N_STEPS, N_STEPS, SHARD_SKIP)[0])
    with torch.no_grad():
        cond_emb = model.embed_condition(cond_tokens[:2 * SHARD_BATCH])
    sched = model.diffusion.schedule(dev)
    LN = N_LAYER * 2 * n_steps
    runs = {
        "bf16 fused": (lambda: sample_tokens_fused_sharded(
            model.diffusion, cond_emb, seed=SEED, devices=[dev, dev], truncation_r=0.85,
            skip_step=SHARD_SKIP),
            lambda c, g: sample_tokens_fused(model.diffusion, c, generator=g, truncation_r=0.85,
                                             skip_step=SHARD_SKIP),
            expected_counts(K1=2 * n_steps)),
        "W4A8 int8": (lambda: rt.sample_tokens_int8_sharded(
            qp, sched, cond_emb, seed=SEED, devices=[dev, dev], truncation_r=0.85,
            skip_step=SHARD_SKIP),
            lambda c, g: rt.sample_tokens_int8(qp, sched, c, generator=g, truncation_r=0.85,
                                               skip_step=SHARD_SKIP),
            expected_counts(K2=2 * n_steps, K3=LN, K4=LN, K5=LN, Kp=2 * LN)),
    }
    launches = {}
    with model.compute_weights(model.diffusion):     # the bf16 weights a request reads
        for name, (sharded, one, want) in runs.items():
            reset_counts()
            got = sharded()
            torch.cuda.synchronize()
            counts = read_counts()
            ref = torch.cat([one(cond_emb[i * SHARD_BATCH:(i + 1) * SHARD_BATCH],
                                 torch.Generator(dev).manual_seed(fold_seed(SEED, i)))
                             for i in range(2)])
            check(counts == want, f"train (f) {name}: launches {counts}, expected {want}")
            check(tuple(got.shape) == (2 * SHARD_BATCH, L_TOK)
                  and bool(((got >= 0) & (got < 256)).all()),
                  f"train (f) {name}: tokens {got.shape}")
            check(torch.equal(got, ref), f"train (f) {name}: the sharded tokens differ from the "
                  f"per-shard runs in {int((got != ref).sum())} of {got.numel()}")
            launches[name] = {k: v for k, v in counts.items() if v}
    print(f"  (f) sharded samplers, two shards of batch {SHARD_BATCH} on the one card, "
          f"{n_steps} steps (top0.85r,fast{SHARD_SKIP}): bf16 fused and W4A8 int8 each bit for "
          f"bit their per-shard runs with the folded seeds; launches {launches}")


def phase_train(model, qp, cond_tokens, dev):
    """Phase 10 (module docstring). Returns (a)'s (median step s, samples/s,
    peak GiB, trainable parameters)."""
    res = _train_flagship(dev)
    _train_card_vs_cpu(dev)
    _train_resume(dev)
    _train_ddp(dev)
    _train_solver(dev)
    _sharded_samplers(model, qp, cond_tokens, dev)
    return res


# -- phase 10b: Stage-1 and vocoder training --------------------------------------------------

S1_STEPS, VOC_STEPS = 12, 20          # steps on one batch: the flagship codec's, MelGAN's
S1_SMALL_DD = dict(double_z=False, z_channels=16, resolution=64, in_channels=1, out_ch=1, ch=64,
                   ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[32], dropout=0.0)
S1_SMALL_MEL, S1_SMALL_BATCH, S1_SMALL_LR = (16, 64), 4, 1e-5
# (b) the small Stage-1 step on the card against the CPU, both in full f32
# (TF32 off), each of the three steps from the CPU's state (weights, Adam
# moments, running statistics, step count), so that one step is compared
# and no step's rounding is carried into the next: Adam's steps move a
# weight by about lr sign(g) whatever g's size, so a gradient whose sign the
# two sides' roundings set apart moves 2 lr apart, and every later forward
# carries that on. Gates, with what the H100 read (PERF.md): the metrics
# within S1_RTOL or S1_ATOL (tests/test_gan_step_parity.py's; 5.4e-5); the
# weights after the step within 2 lr; the BatchNorm running statistics
# within S1_STATS (2.1e-6); each gradient of the step within S1_GRAD[net] of
# its network's largest. The codec's (2.0e-3): LPAPS's VGG is piecewise
# linear (ReLU, max-pool), so its gradient jumps where an input crosses a
# kink, and the two sides' f32 reconstructions, their convolutions summed
# in other orders, cross different ones. The discriminator's (2.6e-2): the
# hinge turns each patch's gradient on or off at a logit of +-1, and the D
# phase reads the reconstruction of the updated codec, which the AE step's
# sign flips move, so a patch that crosses the margin moves the gradient by
# about 1 / (patches). lr 1e-5 (the flagship trains at 8 x 1e-6); the codec
# at ch 64, two and four channels a GroupNorm group (at 16 each group is one
# channel and gives every bias in front of it a zero gradient).
S1_RTOL, S1_ATOL, S1_STATS = 2e-3, 2e-4, 1e-4
S1_GRAD = {"codec": 5e-3, "disc": 1e-1}


def _stage1_small(dev, adaptive: bool, seed: int):
    """(state, step, mel) of the small Stage-1 config on ``dev``, its weights
    made on the CPU from ``seed``: the codec above (8 codes of 16), a PatchGAN
    of ndf 8 and 2 layers, a seeded random LPAPS of 16 bins, disc_start 1."""
    from text_to_sound_synthesis_torch.engine.vqgan_solver import (
        VQGANLossConfig, VQGANTrainState, make_vqgan_train_step)
    from text_to_sound_synthesis_torch.models.discriminator import (NLayerDiscriminator,
                                                                    init_discriminator_)
    from text_to_sound_synthesis_torch.models.lpaps import LPAPS
    from text_to_sound_synthesis_torch.models.vqgan.model import VQModel, init_codec_
    from text_to_sound_synthesis_torch.utils.init import init_random_

    gen = torch.Generator().manual_seed(seed)
    codec = init_codec_(VQModel(S1_SMALL_DD, n_embed=8, embed_dim=16), gen).to(dev)
    disc = init_discriminator_(NLayerDiscriminator(1, 8, 2), gen).to(dev)
    lpaps = LPAPS(n_mels=S1_SMALL_MEL[0])
    init_random_(lpaps.net, gen)
    lpaps = lpaps.init_heads_().to(dev)
    mel = (torch.rand((S1_SMALL_BATCH, *S1_SMALL_MEL, 1), generator=gen) * 2 - 1).to(dev)
    cfg = VQGANLossConfig(disc_start=1, **({"min_adapt_weight": 0.0, "max_adapt_weight": 1e4}
                                          if adaptive else {}))
    return (VQGANTrainState.create(codec, disc, S1_SMALL_LR), make_vqgan_train_step(lpaps, cfg),
            mel)


def _stage1_card_vs_cpu(dev):
    """10b (b): three small steps on the card against the CPU, each from the
    CPU's state, with a constant and with an adaptive discriminator weight.
    Returns the card's state of the adaptive run (for (d))."""
    import copy

    from text_to_sound_synthesis_torch.utils.dtype import full_f32

    worst = {"metric": 0.0, "codec": 0.0, "disc": 0.0, "weight": 0.0, "stats": 0.0}
    kept = None
    for adaptive in (False, True):
        s_cpu, step_cpu, mel_cpu = _stage1_small("cpu", adaptive, SEED + 60)
        s_card, step_card, mel_card = _stage1_small(dev, adaptive, SEED + 60)
        with full_f32():
            for i in range(3):
                for net, opt in (("codec", "ae_opt"), ("disc", "disc_opt")):
                    getattr(s_card, net).load_state_dict(getattr(s_cpu, net).state_dict())
                    getattr(s_card, opt).load_state_dict(    # a copy: no moment shared
                        copy.deepcopy(getattr(s_cpu, opt).state_dict()))
                s_card.step = s_cpu.step
                s_cpu, m_cpu = step_cpu(s_cpu, mel_cpu, S1_SMALL_LR)
                s_card, m_card = step_card(s_card, mel_card, S1_SMALL_LR)
                what = f"stage-1 (b) adaptive={adaptive}, step {i + 1}"
                for k, v in m_cpu.items():
                    a = m_card[k].cpu()
                    if k == "indices":
                        check(torch.equal(v, a), f"{what}: {int((v != a).sum())} codes differ")
                        continue
                    d = abs(float(a) - float(v))
                    check(d <= max(S1_RTOL * abs(float(v)), S1_ATOL),
                          f"{what}: {k} {float(a):.6f} on the card, {float(v):.6f} on the CPU")
                    worst["metric"] = max(worst["metric"], d / max(abs(float(v)), 1e-30))
                for net in ("codec", "disc"):
                    grads = {n: p.grad for n, p in getattr(s_cpu, net).named_parameters()}
                    top = max(float(g.abs().max()) for g in grads.values())
                    for n, p in getattr(s_card, net).named_parameters():
                        d = float((p.grad.cpu() - grads[n]).abs().max())
                        check(d <= S1_GRAD[net] * top, f"{what}: the gradient of {net}.{n} off "
                              f"by {d:.3e} (gate {S1_GRAD[net] * top:.3e})")
                        if top > 0:       # the D's gradients are 0 before disc_start
                            worst[net] = max(worst[net], d / top)
                    want = getattr(s_cpu, net).state_dict()
                    for k, t in getattr(s_card, net).state_dict().items():
                        d = float((t.cpu().double() - want[k].double()).abs().max())
                        if "num_batches" in k:
                            check(d == 0, f"{what}: {k}")
                        elif "running" in k:
                            check(d <= S1_STATS, f"{what}: {k} off by {d:.3e}")
                            worst["stats"] = max(worst["stats"], d)
                        else:
                            check(d <= 2 * S1_SMALL_LR + 1e-7, f"{what}: {net}.{k} off by {d:.3e}")
                            worst["weight"] = max(worst["weight"], d)
        if adaptive:
            kept, d_weight = s_card, float(m_card["d_weight"])
    n_vals = sum(p.numel() for p in (*kept.codec.parameters(), *kept.disc.parameters()))
    print(f"  (b) small config (codec ch 64, {n_vals / 1e6:.2f} M parameters with the PatchGAN; "
          f"mels {S1_SMALL_MEL}, batch {S1_SMALL_BATCH}, lr {S1_SMALL_LR:g}), 3 steps each from "
          f"the CPU's state, full f32, disc_start 1, constant and adaptive weight (d_weight "
          f"{d_weight:.4f} at step 3): codes equal; metrics within {worst['metric']:.2e} "
          f"relative (gate {S1_RTOL} or {S1_ATOL}); gradients within {worst['codec']:.2e} of "
          f"the codec's largest (gate {S1_GRAD['codec']}), {worst['disc']:.2e} of the "
          f"PatchGAN's (gate {S1_GRAD['disc']}); "
          f"weights within {worst['weight']:.2e} (2 lr {2 * S1_SMALL_LR:g}); running "
          f"statistics within {worst['stats']:.2e} (gate {S1_STATS})")
    return kept


def _grad_seen(nets, seen):
    """Mark, per parameter, whether its gradient in this step was nonzero anywhere."""
    for net, module in nets.items():
        for n, p in module.named_parameters():
            hit = p.grad is not None and bool((p.grad != 0).any())
            seen[f"{net}.{n}"] = seen.get(f"{net}.{n}", False) or hit
    return seen


def _check_moved(what, before, nets, seen, logit_bias: str) -> str:
    """Every parameter tensor of ``nets`` moved from ``before``, but a
    discriminator's logit-layer bias (``logit_bias``, a name suffix) whose
    gradient was exactly 0 at every step: with every logit inside the
    hinge's margins, d loss_D / d b = frac(fake > -1) - frac(real < 1) = 0.
    Returns what was exempted."""
    still = [k for k, p in ((f"{net}.{n}", p) for net, m in nets.items()
                            for n, p in m.named_parameters()) if torch.equal(before[k], p)]
    bad = [k for k in still if seen[k] or not k.endswith(logit_bias)]
    check(not bad, f"{what}: parameter tensors did not move: {bad}")
    if not still:
        return ""
    return f" (not {', '.join(still)}: zero gradient, every logit inside the margins)"


def _stage1_flagship(dev):
    """10b (a): the flagship codec's adversarial step, S1_STEPS on one batch.
    -> (median step s, samples/s, peak GiB)."""
    from text_to_sound_synthesis_torch.models.discriminator import FlaxBatchNorm2d
    from text_to_sound_synthesis_torch.tools import bench_train_stage1 as bt

    t0 = time.perf_counter()
    state, step, mel, lr = bt.vqgan_trainer(dev, SEED + 70)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_ae = sum(p.numel() for p in state.codec.parameters())
    n_d = sum(p.numel() for p in state.disc.parameters())
    nets = {"codec": state.codec, "disc": state.disc}
    start = {f"{k}.{n}": p.detach().clone() for k, m in nets.items()
             for n, p in m.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    rows, secs, seen = [], [], {}
    with pytorch_default_precision():
        for _ in range(S1_STEPS):
            t1 = time.perf_counter()
            state, m = step(state, mel, lr)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            rows.append({k: float(v) for k, v in m.items() if k != "indices"})
            _grad_seen(nets, seen)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(v) for r in rows for v in r.values()), f"stage-1 (a): a metric is not "
          f"finite: {rows}")
    check(rows[-1]["nll_loss"] < rows[0]["nll_loss"], f"stage-1 (a): nll_loss went from "
          f"{rows[0]['nll_loss']:.5f} to {rows[-1]['nll_loss']:.5f}")
    exempt = _check_moved("stage-1 (a)", start, nets, seen, f"main.{len(state.disc.main) - 1}.bias")
    norms = [m for m in state.disc.modules() if isinstance(m, FlaxBatchNorm2d)]
    check(len(norms) == 3 and all(int(n.num_batches_tracked) == 2 * S1_STEPS for n in norms),
          f"stage-1 (a): BatchNorm updates {[int(n.num_batches_tracked) for n in norms]}, "
          f"expected {2 * S1_STEPS} each (two a step, the D phase's)")
    check(all(float(n.running_mean.abs().max()) > 0 and not bool((n.running_var == 1).all())
              for n in norms), "stage-1 (a): the running statistics did not move")
    med = float(np.median(secs[1:]))
    print(f"  (a) flagship codec (configs/vqgan_caps.yaml: {n_ae / 1e6:.1f} M parameters, ch "
          f"128, 256 x 256 codebook) + PatchGAN ({n_d / 1e6:.2f} M, ndf 64, 3 layers, BatchNorm) "
          f"+ a seeded random LPAPS, batch {bt.VQGAN_BATCH} of {bt.MEL} mels, disc_start 0, lr {lr:g}, "
          f"built in {build_s:.1f} s; {S1_STEPS} steps: "
          f"nll {rows[0]['nll_loss']:.4f} -> {rows[-1]['nll_loss']:.4f}, p_loss "
          f"{rows[0]['p_loss']:.4f} -> {rows[-1]['p_loss']:.4f}, disc_loss "
          f"{rows[0]['disc_loss']:.4f} -> {rows[-1]['disc_loss']:.4f}, perplexity "
          f"{rows[-1]['perplexity']:.1f}; every codec and PatchGAN tensor moved{exempt}; each "
          f"BatchNorm updated {2 * S1_STEPS} times")
    print(f"  (a) step time: first {secs[0]:.3f} s, median of the rest {med:.4f} s (min "
          f"{min(secs[1:]):.4f}, max {max(secs[1:]):.4f}) = {bt.VQGAN_BATCH / med:.2f} samples/s; "
          f"peak memory {peak:.2f} GiB (f32, cuDNN convs TF32)")
    del state, step, mel, start
    torch.cuda.empty_cache()
    return med, bt.VQGAN_BATCH / med, peak


def _vocoder_flagship(dev):
    """10b (c): the MelGAN step at bench_train_stage1's shape, VOC_STEPS on
    one batch. -> (state, (median step s, samples/s, peak GiB))."""
    from text_to_sound_synthesis_torch.tools import bench_train_stage1 as bt

    state, step, wav = bt.melgan_trainer(dev, SEED + 80)
    n_g = sum(p.numel() for p in state.gen.parameters())
    n_d = sum(p.numel() for p in state.disc.parameters())
    nets = {"gen": state.gen, "disc": state.disc}
    start = {f"{k}.{n}": p.detach().clone() for k, m in nets.items()
             for n, p in m.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    rows, secs, seen = [], [], {}
    with pytorch_default_precision():
        for _ in range(VOC_STEPS):
            t1 = time.perf_counter()
            state, m = step(state, wav)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            rows.append({k: float(v) for k, v in m.items()})
            _grad_seen(nets, seen)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(v) for r in rows for v in r.values()), f"vocoder (c): a metric is not "
          f"finite: {rows}")
    check(rows[-1]["mel_reconstruction"] < rows[0]["mel_reconstruction"],
          f"vocoder (c): mel_reconstruction went from {rows[0]['mel_reconstruction']:.5f} to "
          f"{rows[-1]['mel_reconstruction']:.5f}")
    top = len(state.disc.model["disc_0"].model) - 1
    exempt = _check_moved("vocoder (c)", start, nets, seen, f"layer_{top}.bias")
    med = float(np.median(secs[1:]))
    print(f"  (c) MelGAN (generator {n_g / 1e6:.2f} M, ngf 32; discriminator {n_d / 1e6:.2f} M, 3 "
          f"scales), batch {bt.MELGAN_BATCH} of {bt.MELGAN_LEN}-sample crops, Adam 1e-4 (0.5, 0.9); "
          f"{VOC_STEPS} steps: loss_feat {rows[0]['loss_feat']:.4f} -> {rows[-1]['loss_feat']:.4f}"
          f", loss_D {rows[0]['loss_D']:.4f} -> {rows[-1]['loss_D']:.4f}, mel_reconstruction "
          f"{rows[0]['mel_reconstruction']:.4f} -> {rows[-1]['mel_reconstruction']:.4f}; every "
          f"G and D tensor moved{exempt}")
    print(f"  (c) step time: first {secs[0]:.3f} s, median of the rest {med:.4f} s (min "
          f"{min(secs[1:]):.4f}, max {max(secs[1:]):.4f}) = {bt.MELGAN_BATCH / med:.2f} samples/s "
          f"({bt.MELGAN_BATCH * bt.MELGAN_LEN / 22050 / med:.1f} s of audio a second); peak memory "
          f"{peak:.2f} GiB (f32, cuDNN convs TF32)")
    return state, (med, bt.MELGAN_BATCH / med, peak)


def _stage1_round_trips(dev, s1_state, voc_state):
    """10b (d): (b)'s codec through a Lightning .ckpt into a Diffsound
    (``build_model(load_codec=True)``), (c)'s generator through ``args.yml`` +
    ``best_netG.pt`` and ``load_vocoder``: bit for bit."""
    import copy
    import tempfile

    from text_to_sound_synthesis_torch.engine.checkpoint import save_checkpoint
    from text_to_sound_synthesis_torch.models import build_model
    from text_to_sound_synthesis_torch.models.melgan import Vocoder, load_vocoder
    from text_to_sound_synthesis_torch.tools.train_vqgan import checkpoint_payload

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = save_checkpoint(os.path.join(tmp, "last.ckpt"), checkpoint_payload(s1_state, 1))
        cfg = copy.deepcopy(small_train_config()["model"])
        cfg["params"]["content_codec_config"]["params"] = {
            "embed_dim": 16, "n_embed": 8, "ddconfig": S1_SMALL_DD, "ckpt_path": ckpt}
        loaded = build_model(cfg, device=dev, seed=SEED + 90)
        code = torch.randint(0, 8, (S1_SMALL_BATCH, S1_SMALL_MEL[0] // 2, S1_SMALL_MEL[1] // 2),
                             device=dev, generator=torch.Generator(dev).manual_seed(SEED + 90))
        with torch.no_grad():
            a, b = loaded.codec.decode_code(code), s1_state.codec.eval().decode_code(code)
        check(torch.equal(a, b), "stage-1 (d): decode_code of the loaded codec differs")
        voc_dir = os.path.join(tmp, "melgan")
        os.makedirs(voc_dir)
        with open(os.path.join(voc_dir, "args.yml"), "w") as f:
            f.write("".join(f"{k}: {v}\n" for k, v in VOC_ARGS.items()))
        torch.save(voc_state.gen.state_dict(), os.path.join(voc_dir, "best_netG.pt"))
        voc = load_vocoder(voc_dir, device=dev)
        spec = torch.rand((2, 80, 53), generator=torch.Generator(dev).manual_seed(SEED + 91),
                          device=dev)
        same = torch.equal(voc(spec), Vocoder(voc_state.gen.eval())(spec))
        check(same, "vocoder (d): the wav of the loaded generator differs")
    print(f"  (d) (b)'s codec as a Lightning .ckpt ({os.path.basename(ckpt)}: the codec and "
          f"loss.discriminator.*, both Adams) into a Diffsound by build_model(load_codec=True): "
          f"decode_code bit for bit; (c)'s generator as args.yml + best_netG.pt through "
          f"load_vocoder: the wav bit for bit")


def phase_stage1(dev):
    """Phase 10b (module docstring): every kernel count stays 0. Returns the
    times of (a), (c) and (e)."""
    out = {}
    parts = [("(a)", lambda: out.__setitem__("vqgan", _stage1_flagship(dev))),
             ("(b)", lambda: out.__setitem__("small", _stage1_card_vs_cpu(dev))),
             ("(c)", lambda: out.__setitem__("melgan", _vocoder_flagship(dev))),
             ("(d)", lambda: _stage1_round_trips(dev, out["small"], out["melgan"][0])),
             ("(e)", lambda: out.__setitem__("bf16", _train_flagship(dev, "bfloat16", "(e)")))]
    for label, run in parts:
        reset_counts()
        run()
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts == expected_counts(), f"stage-1 {label}: kernel launches {counts}")
    print(f"  every kernel count 0 in (a)-(e): {expected_counts()}")
    return out["vqgan"], out["melgan"][1], out["bf16"][:3]


# -- phase 10c: evaluation ------------------------------------------------------------------

EVAL_CLASSES = 309          # Melception's head (VGGSound)
EVAL_MELS = 2 * BATCH       # two requests' decoded mels: Melception's batch of 16
# Melception on the card against the CPU, both in full f32: per tap, the largest
# difference over the CPU tap's largest magnitude. In f32 with another summation
# order this is ~1e-6; TF32 convs (10-bit mantissas) give ~1e-3, which the gate
# refuses: the features of two mels differ by ~1 % of their size at random weights.
MELCEPTION_TOL = 1e-4
# beam search on the card against the CPU: the tokens equal, or the first token
# that differs follows a prefix whose two candidates' log-probs (on the CPU) lie
# within this of each other, or the two captions' length-averaged scores do
CAPTION_TIE = 1e-4
CAPTION_BEAM, CAPTION_MELS = 3, 4
# Griffin-Lim, 32 steps, on the card against the CPU: both f32, other FFTs. The
# unit-phase normalisation turns rounding in near-zero bins into phase, which
# the momentum carries on; f32 against f64 on the CPU on a 10 s mel gave a
# waveform correlation of 0.99994, an rms difference of 1.1 % of the rms and
# spectral convergences 2e-6 apart.
GL_ITERS, GL_CORR, GL_RMS, GL_SC = 32, 0.999, 0.05, 1e-4
# the JAX package's gate (tests/test_int8_drift_gate.py). The tool draws the
# flagship's weights with the seeded init, which draws them as the JAX
# package's flax modules do (truncated lecun_normal): on untruncated draws the
# W4A8 engine read 38.6 on an H100, its 4-bit grid set by each output
# channel's largest weight.
MAX_DRIFT_RATIO = 1.5
DRIFT_ARGS = ["--config_file", CONFIG, "--train_steps", "40", "--clips", "24", "--static",
              "--w4", "--device", "cuda"]
DRIFT_CLIPS, DRIFT_BATCH = 24, 8


def _eval_mels(model, cond_tokens, dev):
    """Two bf16 requests of the flagship -> (16, 80, 848) decoded mels in [0, 1]."""
    reset_counts()
    mels = [(model.generate(torch.Generator(dev).manual_seed(SEED + 40 + i), cond_tokens,
                            sample_type="top0.85r")[..., 0].float() + 1.0) / 2.0
            for i in range(2)]
    counts = read_counts()
    check(counts == expected_counts(K1=2 * N_STEPS), f"eval: request launches {counts}")
    mels = torch.cat(mels)
    check(tuple(mels.shape) == (EVAL_MELS, *MEL) and bool(torch.isfinite(mels).all()),
          f"eval: decoded mels {tuple(mels.shape)}")
    return mels


def _eval_melception(mels, dev):
    """(a) Melception at full width on the card against itself on the CPU."""
    import copy

    from torch.utils.flop_counter import FlopCounterMode

    from text_to_sound_synthesis_torch.utils.dtype import full_f32
    from text_to_sound_synthesis_torch.models.melception import Melception
    from text_to_sound_synthesis_torch.models.melception.model import TAPS
    from text_to_sound_synthesis_torch.utils.init import init_random_

    cpu = init_random_(Melception(EVAL_CLASSES, features_list=TAPS),
                       torch.Generator().manual_seed(SEED + 42))
    card = copy.deepcopy(cpu).to(dev)
    with torch.no_grad():
        with full_f32():
            got = card(mels)
            ms = cuda_time_ms(lambda: card(mels), iters=5, warmup=1)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            card(mels)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            with FlopCounterMode(display=False) as fc:
                card(mels[:1])
        with pytorch_default_precision():           # TF32 convs, for the record
            tf32 = card(mels)
            tf32_ms = cuda_time_ms(lambda: card(mels), iters=5, warmup=1)
        t0 = time.perf_counter()
        want = cpu(mels.cpu())
        cpu_s = time.perf_counter() - t0
    errs, tf32_errs = {}, {}
    for k in TAPS:
        scale = float(want[k].abs().max())
        check(tuple(got[k].shape) == tuple(want[k].shape) and bool(torch.isfinite(got[k]).all()),
              f"eval (a): tap {k} {tuple(got[k].shape)}")
        errs[k] = float((got[k].cpu() - want[k]).abs().max()) / scale
        tf32_errs[k] = float((tf32[k].cpu() - want[k]).abs().max()) / scale
    gflop = fc.get_total_flops() / 1e9
    bound_ms = _bound(0, f32=gflop * 1e9 * EVAL_MELS)[0]
    print(f"  (a) Melception ({EVAL_CLASSES} classes, six taps) at batch {EVAL_MELS} of "
          f"{MEL[0]} x {MEL[1]}, full f32 (no TF32): {ms:.2f} ms a batch = {ms / EVAL_MELS:.3f} ms "
          f"a mel, {gflop:.1f} GFLOP a mel (flop_counter) = {gflop * EVAL_MELS / ms:.2f} TFLOP/s; "
          f"peak memory {peak:.2f} GiB above the {held / 2**30:.2f} held; bound "
          f"{bound_ms:.2f} ms (f32 peak); with TF32 convs {tf32_ms:.2f} ms; the CPU's batch "
          f"{cpu_s:.1f} s")
    print(f"      card vs CPU, max |diff| / max |CPU| per tap: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (gate {MELCEPTION_TOL:g}); "
          f"with TF32 convs: {', '.join(f'{k} {v:.2e}' for k, v in tf32_errs.items())}")
    check(max(errs.values()) <= MELCEPTION_TOL, f"eval (a): card vs CPU {errs}")
    return card, ms


def _eval_folders(card, mels):
    """(b) evaluate_folders over two directories of the decoded mels."""
    import tempfile

    from text_to_sound_synthesis_torch.evaluation.features import evaluate_folders

    n = EVAL_MELS // 2
    with tempfile.TemporaryDirectory() as tmp:
        gen, ref = os.path.join(tmp, "gen"), os.path.join(tmp, "ref")
        os.makedirs(gen)
        os.makedirs(ref)
        for i in range(n):
            np.save(os.path.join(gen, f"clip{i}_sample_0.npy"), mels[i].cpu().numpy())
            np.save(os.path.join(ref, f"clip{i}_mel.npy"), mels[n + i].cpu().numpy())
        t0 = time.perf_counter()
        out = evaluate_folders(card, gen, ref, batch_size=EVAL_MELS)
        secs = time.perf_counter() - t0
    check(len(out) == 6 and all(np.isfinite(v) for v in out.values()), f"eval (b): {out}")
    print(f"  (b) evaluate_folders, {n} mels of seed {SEED + 40} against {n} of seed {SEED + 41} "
          f"(random Melception): {', '.join(f'{k} {v:.6g}' for k, v in out.items())}; {secs:.1f} s")


def _eval_captioner(mels, dev):
    """(c) the full-default ACT, seeded: beam search on the card against the CPU."""
    import copy

    from text_to_sound_synthesis_torch.evaluation import caption_metrics as cm
    from text_to_sound_synthesis_torch.models.captioner import ACTCaptioner, beam_decode
    from text_to_sound_synthesis_torch.utils.init import init_random_

    cpu = init_random_(ACTCaptioner(), torch.Generator().manual_seed(SEED + 43))
    card = copy.deepcopy(cpu).to(dev)
    x = mels[:CAPTION_MELS].transpose(1, 2).contiguous()          # (4, 848, 80)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = beam_decode(card, x, beam_size=CAPTION_BEAM)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = beam_decode(cpu, x.cpu(), beam_size=CAPTION_BEAM)
    cpu_s = time.perf_counter() - t0
    ties = []
    for b, (g, w) in enumerate(zip(got, want)):
        if np.array_equal(g, w):
            continue
        k = next((i for i in range(min(len(g), len(w))) if g[i] != w[i]), min(len(g), len(w)))
        with torch.no_grad():
            memory = cpu.encode(x[b:b + 1].cpu())
            score = lambda seq: float(sum(torch.log_softmax(
                cpu.decode(memory, torch.tensor([seq[:i].tolist()]))[0, -1], -1)[int(seq[i])]
                for i in range(1, len(seq)))) / len(seq)
            gap = abs(score(g) - score(w))
            if k < min(len(g), len(w)):
                lp = torch.log_softmax(cpu.decode(memory, torch.tensor([w[:k].tolist()]))[0, -1], -1)
                gap = min(gap, abs(float(lp[int(g[k])] - lp[int(w[k])])))
        ties.append((b, k, gap))
        check(gap <= CAPTION_TIE, f"eval (c): mel {b}: card tokens {g.tolist()} against the "
              f"CPU's {w.tolist()}, first difference at {k}, no near-tie ({gap:.3e})")
    vocab = [f"w{i}" for i in range(cpu.dec_fc.out_features)]
    words = lambda toks: " ".join(vocab[int(t)] for t in toks[1:] if int(t) != cpu.eos_id)
    rng = np.random.default_rng(SEED + 44)
    refs = [[" ".join(vocab[i] for i in rng.integers(10, len(vocab), 6)) for _ in range(2)]
            for _ in got]
    scores = cm.caption_scores([words(t) for t in got], refs)
    check(all(np.isfinite(v) for v in scores.values()), f"eval (c): caption scores {scores}")
    n_params = sum(p.numel() for p in card.parameters())
    res = cm.resolution()
    print(f"  (c) ACTCaptioner (default: {n_params / 1e6:.1f} M params, 12-layer 768-wide "
          f"encoder, 2-layer decoder, {len(vocab)} words), beam {CAPTION_BEAM} over "
          f"{CAPTION_MELS} mels: card {card_s:.2f} s, CPU {cpu_s:.2f} s; tokens "
          f"{'equal' if not ties else f'differ after near-ties {ties}'}, lengths "
          f"{[len(t) for t in got]}; caption_scores against random references (METEOR with "
          f"stemmer {res['stemmer']}, synonyms {res['synonyms']}): "
          f"{', '.join(f'{k} {v:.4f}' for k, v in scores.items())}")
    return card_s


def _eval_griffin_lim(mels, dev):
    """(d) Griffin-Lim on one decoded 80 x 848 mel, 32 steps, card against CPU."""
    from text_to_sound_synthesis_torch.ops import signal as sg

    t0 = time.perf_counter()
    spec = sg._mel_to_stft_np(sg.denormalize_mel_np(mels[0].cpu().numpy()), sg.CANONICAL)
    nnls_s = time.perf_counter() - t0
    mag = torch.from_numpy(spec.astype(np.float32))
    want = sg.griffin_lim(mag, n_iter=GL_ITERS).numpy()
    mag_card = mag.to(dev)
    sg.griffin_lim(mag_card, n_iter=GL_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sg.griffin_lim(mag_card, n_iter=GL_ITERS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = got.cpu().numpy()
    wav = sg.mel_to_wav_np(mels[0].cpu().numpy(), n_iter=GL_ITERS, device=dev)

    def convergence(y):
        s = sg.stft_magnitude_complex(torch.from_numpy(y).double(), sg.CANONICAL).abs().numpy()
        return float(np.linalg.norm(s - spec) / np.linalg.norm(spec))

    corr = float(np.corrcoef(got, want)[0, 1])
    rms = float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2)))
    sc_card, sc_cpu = convergence(got), convergence(want)
    print(f"  (d) griffin_lim, {GL_ITERS} steps on a {MEL[0]} x {MEL[1]} decoded mel "
          f"({got.shape[0]} samples): card {1e3 * secs:.1f} ms (NNLS on the host {nnls_s:.2f} s); "
          f"card vs CPU: correlation {corr:.6f}, rms difference {rms:.2e} of the rms, spectral "
          f"convergence {sc_card:.6f} / {sc_cpu:.6f}")
    check(got.shape == want.shape == wav.shape and np.isfinite(got).all() and np.isfinite(wav).all(),
          f"eval (d): shapes {got.shape} {want.shape} {wav.shape}")
    check(corr >= GL_CORR and rms <= GL_RMS and abs(sc_card - sc_cpu) <= GL_SC,
          f"eval (d): card vs CPU corr {corr}, rms {rms}, convergence {sc_card} / {sc_cpu}")
    return secs


def _eval_drift(dev, part: str = "(e)", **env):
    """(e) the drift gate on the flagship's W4A8 static engine (the JAX
    package's test_w4a8_static_drift_within_reseed_floor protocol); (f) the
    same under ``env``, phase 8's switches (K10 in K4 and K5), set for this
    call only."""
    from text_to_sound_synthesis_torch.tools import eval_int8_drift

    reset_counts()
    t0 = time.perf_counter()
    with switches(**env):
        out = eval_int8_drift.main(DRIFT_ARGS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    LN, requests = N_LAYER * N_STEPS, DRIFT_CLIPS // DRIFT_BATCH
    mha = ({"K10": 2 * requests * LN} if env.get("T2S_ATTN_INT8") == "1"
           else {"Kp": 2 * requests * LN})
    want = expected_counts(K1=2 * requests * N_STEPS, K2=requests * N_STEPS, K3=requests * LN,
                           K4=requests * LN, K5=requests * LN, **mha)
    check(counts == want, f"eval {part}: launches {counts}, expected {want}")
    print(f"  {part} eval_int8_drift {' '.join(DRIFT_ARGS[2:])}"
          f"{''.join(f' {k}={v}' for k, v in env.items())} (flagship, flax's seeded draws, random "
          f"Melception): fid_bf16_vs_int8 {out['fid_bf16_vs_int8']!r}, fid_bf16_seed_floor "
          f"{out['fid_bf16_seed_floor']!r}, drift_ratio {out['drift_ratio']!r} (gate "
          f"{MAX_DRIFT_RATIO}), isc_bf16 {out['isc_bf16']!r}, isc_int8 {out['isc_int8']!r}; "
          f"{secs:.1f} s; launches {counts}")
    torch.cuda.empty_cache()
    return out, secs


def check_drift_gate(out, part: str = "(e)"):
    """(e)'s gate, checked after phase 11 so that a failing gate loses no
    measurement: the floor above 0 and drift_ratio <= MAX_DRIFT_RATIO."""
    check(out["fid_bf16_seed_floor"] > 0,
          f"eval {part}: the seed floor is {out['fid_bf16_seed_floor']}")
    check(out["drift_ratio"] <= MAX_DRIFT_RATIO,
          f"eval {part}: drift_ratio {out['drift_ratio']} > {MAX_DRIFT_RATIO}")


def phase_eval(model, cond_tokens, dev):
    """Phase 10c (module docstring). Returns the times and the drift gate's output."""
    t0 = time.perf_counter()
    mels = _eval_mels(model, cond_tokens, dev)
    reset_counts()
    card, mel_ms = _eval_melception(mels, dev)
    _eval_folders(card, mels)
    del card
    cap_s = _eval_captioner(mels, dev)
    gl_s = _eval_griffin_lim(mels, dev)
    counts = read_counts()
    check(counts == expected_counts(), f"eval (a)-(d): kernel launches {counts}")
    drift, drift_s = _eval_drift(dev)
    drift_k10, drift_k10_s = _eval_drift(dev, "(f)", T2S_ATTN_INT8="1", T2S_ATTN_MHA="base")
    secs = time.perf_counter() - t0
    print(f"  phase 10c: {secs:.1f} s ((a)-(d) launch no kernel: {expected_counts()})")
    return {"melception_ms": mel_ms, "caption_s": cap_s, "gl_s": gl_s, "drift": drift,
            "drift_s": drift_s, "drift_k10": drift_k10, "drift_k10_s": drift_k10_s,
            "seconds": secs}


# -- phase 10d: the AR baseline and the class / unconditional denoisers ------------------

AR_CONFIG = os.path.join(REPO, "configs", "ar_audiocaps.yaml")
AR_HW, AR_TOP_K = (5, 53), 100
# f32 on both sides of each comparison (TF32 off), the same ops summed in
# another order: the cached decode (one query row against the 266-slot cache)
# against the full forward of the same sequence, the card against the CPU.
# Each gate is the largest |difference| over the largest |value| of the
# reference; 19 to 24 f32 layers at d1024 sum to ~1e-6 of it on either side.
AR_F32_TOL = 1e-4
# the train step's loss card against CPU, relative: a mean of 2120 cross
# entropies, each within ~1e-6 of its value on the other side
AR_LOSS_RTOL = 1e-5
# (c)'s denoisers at the JAX package's defaults (24 x d1024 x 1000 classes on
# 5 x 53 tokens; 24 x d512 on 16 x 16), the unconditional one's content
# embedding at its width: the JAX default embedding is 1024 wide and does not fit
DENOISERS = {"Condition2SpecTransformer": {},
             "UnCondition2SpecTransformer": {"content_emb_config": {"params": {"embed_dim": 512}}}}


def _ar_checks(model, feats, tokens):
    """(a)'s checks on the emitted tokens: each inside the top AR_TOP_K of
    its step's logits from one full forward of the emitted sequence; the
    cached decode, teacher-forced on that sequence, equal to the full forward
    within AR_F32_TOL; the full forward's logits finite."""
    gpt = model.gpt
    with torch.no_grad():
        full = gpt(tokens[:, :-1], feats)                     # (B, 1 + 264, 256)
        scale = float(full.abs().max())
        kth = full.sort(dim=-1, descending=True).values[..., AR_TOP_K - 1]
        outside = int((full.gather(-1, tokens[..., None])[..., 0] < kth - AR_F32_TOL * scale).sum())
        cache = gpt.init_cache(tokens.shape[0])
        logits, cache = gpt.decode_prefix(gpt.embed_feats(feats), cache)
        steps = [logits]
        for t in range(tokens.shape[1] - 1):
            logits, cache = gpt.decode_token(tokens[:, t], cache, 1 + t)
            steps.append(logits)
        err = float((torch.stack(steps, 1) - full).abs().max()) / scale
    check(bool(torch.isfinite(full).all()), "AR (a): non-finite logits")
    check(outside == 0, f"AR (a): {outside} tokens outside their step's top {AR_TOP_K}")
    check(err <= AR_F32_TOL, f"AR (a): cached decode vs full forward {err:.2e}")
    return err


def _ar_greedy_card_vs_cpu(cfg, feats, dev):
    """(a) on a 2-layer copy at full width: greedy tokens on the card equal
    the CPU's, or each row's first difference follows a near-tie (the CPU's
    two logits within AR_F32_TOL of its largest |logit|)."""
    import copy

    from text_to_sound_synthesis_torch.models.gpt import ar_sample
    from text_to_sound_synthesis_torch.tools.train_ar import build_model

    small = copy.deepcopy(cfg)
    small["model"]["params"]["transformer_config"]["params"]["GPT_config"]["n_layer"] = 2
    cpu = build_model(small, torch.device("cpu"), SEED + 61)
    card = copy.deepcopy(cpu).to(dev)
    steps = AR_HW[0] * AR_HW[1]
    with torch.no_grad():
        got = ar_sample(card.gpt, feats, steps=steps, top_k=1).cpu()
        want = ar_sample(cpu.gpt, feats.cpu(), steps=steps, top_k=1)
        logits = cpu.gpt(want[:, :-1], feats.cpu())
    scale = float(logits.abs().max())
    far, ties = 0, []
    for b in range(want.shape[0]):
        diff = (got[b] != want[b]).nonzero()
        if len(diff):
            t = int(diff[0])
            margin = float(logits[b, t, want[b, t]] - logits[b, t, got[b, t]])
            ties.append((b, t, margin / scale))
            far += margin > AR_F32_TOL * scale
    print(f"  (a) 2-layer copy at full width, greedy {steps} tokens, card vs CPU: rows equal "
          f"{want.shape[0] - len(ties)}/{want.shape[0]}; first differences (row, step, margin / "
          f"max|logit|) {ties}")
    check(far == 0, f"AR (a): greedy tokens differ from the CPU's past a near-tie: {ties}")


def _ar_train(model, feats, dev, cfg):
    """(b): two train_ar steps at the flagship; card vs CPU on a 2-layer copy."""
    import copy

    from text_to_sound_synthesis_torch.engine.optimizers import decay_mask
    from text_to_sound_synthesis_torch.tools import train_ar

    bs = int(cfg["dataloader"]["batch_size"])
    lr = bs * float(cfg["model"]["base_learning_rate"])
    mel = torch.rand((BATCH, *MEL, 1), generator=torch.Generator(dev).manual_seed(SEED + 62),
                     device=dev) * 2 - 1
    codec0 = {k: v.clone() for k, v in model.codec.state_dict().items()}
    gpt0 = {k: v.detach().clone() for k, v in model.gpt.named_parameters()}
    opt = train_ar.build_optimizer(model, lr)
    model.gpt.train()
    losses, secs, zero = [], [], {}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(train_ar.train_step(model, opt, mel, feats)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        for n, p in model.gpt.named_parameters():
            zero[n] = zero.get(n, True) & (p.grad == 0)
    model.gpt.eval()
    mask = decay_mask(model.gpt)
    decayed = {id(p) for p in opt.param_groups[0]["params"]}
    check({n for n, p in model.gpt.named_parameters() if id(p) in decayed}
          == {n for n, d in mask.items() if d}, "AR (b): the decay group is not the decay mask")
    check(all(torch.equal(v, codec0[k]) for k, v in model.codec.state_dict().items()),
          "AR (b): the frozen codec moved")
    still, moved_zero, unmoved = 0, 0, []
    for n, p in model.gpt.named_parameters():
        p0, z = gpt0[n], zero[n]
        if bool((~z).any()) and not bool((p != p0)[~z].any()):
            unmoved.append(n)
        if mask[n]:
            want = p0[z] * (1 - lr * train_ar.WEIGHT_DECAY) ** 2
            moved_zero += int((p[z] != p0[z]).sum())
            check(bool(((p[z] - want).abs() <= 2 * torch.finfo(torch.float32).eps
                        * p0[z].abs()).all()), f"AR (b): {n}: zero-gradient entries off the decay")
        else:
            still += int(z.sum())
            check(torch.equal(p[z], p0[z]), f"AR (b): {n}: an undecayed zero-gradient entry moved")
    check(not unmoved, f"AR (b): tensors with gradients did not move: {unmoved}")
    check(all(np.isfinite(losses)), f"AR (b): losses {losses}")
    # the first step's loss and gradients, card against CPU, on a 2-layer copy
    small = copy.deepcopy(cfg)
    small["model"]["params"]["transformer_config"]["params"]["GPT_config"]["n_layer"] = 2
    cpu = train_ar.build_model(small, torch.device("cpu"), SEED + 63)
    card = copy.deepcopy(cpu).to(dev)
    z = model.encode_to_z(mel)
    norms = []
    for m, zz, ff in ((card, z, feats), (cpu, z.cpu(), feats.cpu())):
        loss, _ = m.token_loss(zz, ff)
        loss.backward()
        g = torch.sqrt(sum(p.grad.double().square().sum() for p in m.gpt.parameters()))
        norms.append((float(loss.detach()), float(g)))
    (l_card, g_card), (l_cpu, g_cpu) = norms
    print(f"  (b) train_ar at the flagship, batch {BATCH} of {MEL[0]} x {MEL[1]}, lr {lr:g}: "
          f"losses {losses}, {secs[0]:.4f} / {secs[1]:.4f} s a step; the codec unchanged; "
          f"decay on the {len([d for d in mask.values() if d])} Linear / Conv weights of "
          f"{len(mask)} tensors; zero-gradient entries over both steps: {still} undecayed, "
          f"unchanged; decayed ones moved {moved_zero} (each as p (1 - lr wd)^2); 2-layer copy's "
          f"first loss card {l_card!r} / CPU {l_cpu!r}, grad norm {g_card!r} / {g_cpu!r}")
    check(abs(l_card - l_cpu) <= AR_LOSS_RTOL * abs(l_cpu), "AR (b): card vs CPU loss")
    check(abs(g_card - g_cpu) <= AR_F32_TOL * g_cpu, "AR (b): card vs CPU gradient norm")
    return secs


def _denoisers(dev):
    """(c): both denoisers at the JAX package's defaults (``DENOISERS``), one
    forward each at batch 2, card against CPU."""
    import copy

    from text_to_sound_synthesis_torch.models.diffusion import backbone
    from text_to_sound_synthesis_torch.utils.init import init_random_

    gen = torch.Generator().manual_seed(SEED + 64)
    out = []
    for name, kw in DENOISERS.items():
        cpu = init_random_(getattr(backbone, name)(**kw), gen).eval()
        card = copy.deepcopy(cpu).to(dev)
        H, W = cpu.content_emb.spatial_size
        tokens = torch.randint(0, cpu.num_classes, (2, H * W), generator=gen)
        t = torch.tensor([0, 73])
        cond = (torch.tensor([3, cpu.blocks[0].ln2.emb.num_embeddings - 3])
                if name.startswith("Condition") else None)
        with torch.no_grad():
            want = cpu(tokens, cond, t)
            got = card(tokens.to(dev), None if cond is None else cond.to(dev), t.to(dev))
        err = float((got.cpu() - want).abs().max()) / float(want.abs().max())
        n = sum(p.numel() for p in cpu.parameters()) / 1e6
        out.append(f"{name} ({len(cpu.blocks)} x d{cpu.to_logits[1].in_features}, {n:.1f} M, "
                   f"{H} x {W} tokens) {err:.2e}")
        check(tuple(got.shape) == (2, H * W, cpu.num_classes - 1)
              and bool(torch.isfinite(got).all()) and err <= AR_F32_TOL,
              f"denoisers (c): {name}, card vs CPU {err:.2e}")
    print(f"  (c) the JAX defaults, batch 2, card vs CPU, max|d| / max|CPU| (gate {AR_F32_TOL:g}): "
          f"{'; '.join(out)}")


def phase_ar(vocoder, dev):
    """Phase 10d (module docstring). Returns the AR request's and the AR
    train step's times."""
    from text_to_sound_synthesis_torch.models.gpt import ar_sample
    from text_to_sound_synthesis_torch.tools.train_ar import build_model
    from text_to_sound_synthesis_torch.utils.config import load_yaml_config
    from text_to_sound_synthesis_torch.utils.dtype import full_f32

    t_phase = time.perf_counter()
    reset_counts()
    cfg = load_yaml_config(AR_CONFIG)
    with full_f32():
        model = build_model(cfg, dev, SEED + 60)
        n = sum(p.numel() for p in model.gpt.parameters())
        width = cfg["model"]["params"]["transformer_config"]["params"][
            "feat_embedding_config"]["params"]["in_channels"]
        feats = torch.randn((BATCH, width, 1), generator=torch.Generator(dev).manual_seed(SEED + 65),
                            device=dev)
        feats = feats / feats.norm(dim=1, keepdim=True)
        times = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mel = model.sample(feats, AR_HW, top_k=AR_TOP_K,
                               generator=torch.Generator(dev).manual_seed(SEED + 66 + i))
            wav = vocoder((mel[..., 0] + 1.0) / 2.0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        tokens = ar_sample(model.gpt, feats, steps=AR_HW[0] * AR_HW[1], top_k=AR_TOP_K,
                           generator=torch.Generator(dev).manual_seed(SEED + 67))
        check(tuple(tokens.shape) == (BATCH, AR_HW[0] * AR_HW[1]) and int(tokens.min()) >= 0
              and int(tokens.max()) < model.gpt.vocab_size, f"AR (a): tokens {tuple(tokens.shape)}")
        check(torch.equal(model.decode_to_img(tokens, AR_HW), mel),
              "AR (a): sample's mel is not decode_to_img of ar_sample's tokens")
        check(tuple(mel.shape) == (BATCH, *MEL, 1) and bool(torch.isfinite(mel).all()),
              f"AR (a): mel {tuple(mel.shape)}")
        check(bool(torch.isfinite(wav).all()) and float(wav.abs().max()) <= 1.0,
              "AR (a): the wav is not finite in [-1, 1]")
        err = _ar_checks(model, feats, tokens)
        cache_gb = 2 * model.gpt.n_layer * BATCH * model.gpt.block_size * model.gpt.n_embd * 4 / 1e9
        print(f"  (a) {AR_CONFIG[len(REPO) + 1:]}: GPTFeats {model.gpt.n_layer} x d"
              f"{model.gpt.n_embd}, {n / 1e6:.1f} M parameters, f32, KV cache {cache_gb:.2f} GB; "
              f"two requests of batch {BATCH} (features -> {tokens.shape[1]} tokens, top-k "
              f"{AR_TOP_K} -> "
              f"decode_code -> MelGAN): {times[0]:.3f} / {times[1]:.3f} s; every token in its "
              f"step's top {AR_TOP_K}; cached decode vs full forward {err:.2e} (gate "
              f"{AR_F32_TOL:g})")
        _ar_greedy_card_vs_cpu(cfg, feats, dev)
        train_s = _ar_train(model, feats, dev, cfg)
        del model
        _denoisers(dev)
    counts = read_counts()
    check(counts == expected_counts(), f"AR phase: kernel launches {counts}")
    print(f"  phase 10d: {time.perf_counter() - t_phase:.1f} s (launches no kernel)")
    return times, train_s


# -- phase 10e: the entry points -------------------------------------------------------------

# A synthetic CLIP merge table, for machines without the released one
# ($T2S_CLIP_BPE): byte pairs of the captions below, "é" (bytes c3 a9, "Ã©"
# in the byte alphabet) and "ß" ("ÃŁ") among them. It gives a vocabulary of
# 532 ids, SOT 530 and EOT 531, inside the CLIP tower's 49 408 rows.
BPE_MERGES = ("t h", "th e</w>", "i n", "i n</w>", "d o", "do g</w>", "r a", "ra in</w>", "a r",
              "b ar", "c a", "ca f", "\u00c3 \u00a9", "\u00c3 \u00a9</w>", "caf \u00c3\u00a9</w>",
              "\u00c3 \u0141", "s t", "st r")
# each caption's ids on that table, as the JAX package's tokenizer (with
# ``regex``) gives them; tests/test_torch_tokenizer.py holds them to it
TOKENIZER_IDS = {
    "the dog barks in the rain": [513, 517, 521, 74, 338, 515, 513, 519],
    "a caf\u00e9 with na\u00efve jazz":
        [320, 526, 86, 72, 83, 327, 77, 64, 127, 107, 85, 324, 73, 64, 89, 345],
    "stra\u00dfe": [528, 518, 527, 324],
    "\u00dcn\u00efc\u00f6d\u00e9 \u00c0\u00c9\u00ce \u65e5\u672c\u8a9e\u306e\u97f3 \u0663\u0664 \u00bd":
        [127, 120, 77, 127, 107, 66, 127, 114, 67, 525, 127, 254, 524, 127, 362, 162, 245, 98, 162,
         250, 105, 164, 103, 252, 159, 223, 106, 165, 253, 367, 149, 352, 149, 353, 126, 377],
    "tom&#39;s  dog &amp; cat\u3000barks\x85twice\x1cnow":
        [83, 78, 332, 6, 338, 517, 261, 522, 339, 521, 74, 338, 83, 86, 72, 66, 324, 77, 78, 342],
    "it's the DOG's caf\u00e9!!": [72, 339, 6, 338, 513, 517, 6, 338, 526, 0, 256],
}


def write_merge_table(path: str) -> str:
    """Write ``BPE_MERGES`` as a merge table (a header line, then one merge a
    line) to ``path``; returns ``path``."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(("#version: 0.2",) + BPE_MERGES))
    return path


# the entry points' requests: (b) two captions x 4, (c) one caption x BATCH, then
# the burst of SERVE_BURST mel requests from SERVE_CLIENTS clients and two wavs
ENTRY_CAPTIONS = ("a dog barks in the rain", "thunder rumbles while a train passes")
LONG_SECONDS = 25
SERVE_BURST, SERVE_CLIENTS = 32, 16


def _flagship_yaml(path: str) -> str:
    """The flagship config with ``dtype: bfloat16`` (phase 5's model), as a YAML."""
    from text_to_sound_synthesis_torch.utils.config import load_yaml_config, save_config_to_yaml

    cfg = load_yaml_config(CONFIG)
    cfg["model"]["params"]["dtype"] = "bfloat16"
    save_config_to_yaml(cfg, path)
    return path


def _entry_tokenizer(tmp: str) -> str:
    """(a): the fixed captions' ids on the synthetic table against the JAX
    package's. Returns the table (b)-(d) tokenize with."""
    import importlib.util

    from text_to_sound_synthesis_torch.models.clip.tokenizer import ClipBPETokenizer

    synthetic = write_merge_table(os.path.join(tmp, "merges.txt"))
    tok = ClipBPETokenizer(bpe_path=synthetic)
    bad = [c for c, ids in TOKENIZER_IDS.items() if tok.encode(c) != ids]
    print(f"  (a) tokenizer: {len(TOKENIZER_IDS) - len(bad)} of {len(TOKENIZER_IDS)} fixed captions "
          f"(non-ASCII words among them) give the JAX package's ids on the synthetic table; "
          f"`regex` importable on this machine: {importlib.util.find_spec('regex') is not None}")
    check(not bad, f"tokenizer: ids differ from the JAX package's for {bad!r}")
    table = os.environ.get("T2S_CLIP_BPE")
    print(f"      (b)-(d) tokenize with {'$T2S_CLIP_BPE = ' + table if table else 'the synthetic table'}")
    return table or synthetic


def _wav_frames(path: str) -> int:
    import wave

    with wave.open(path) as w:
        check((w.getframerate(), w.getsampwidth(), w.getnchannels()) == (22050, 3, 1),
              f"{path}: not a 22 050 Hz PCM_24 mono wav")
        return w.getnframes()


def _entry_cli(yml: str, voc_dir: str, tmp: str, dev) -> float:
    """(b): the generate CLI in-process, bf16 and ``--int8 --duration``.
    Returns the bf16 run's seconds."""
    from text_to_sound_synthesis_torch.tools import generate as cli

    built, load = [], cli.load_model

    def recording(*args, **kwargs):     # the CLI's model, for the direct comparison
        built.append(load(*args, **kwargs))
        return built[-1]

    cli.load_model = recording
    try:
        out = os.path.join(tmp, "cli_bf16")
        argv = ["--config_file", yml, "--ckpt", "random", "--seed", str(SEED), "--outdir", out,
                "--vocoder", voc_dir, "--replicate", "4", "--batch", "2"]
        for cap in ENTRY_CAPTIONS:
            argv += ["--caption", cap]
        reset_counts()
        t0 = time.perf_counter()
        check(cli.main(argv) == 0, "generate CLI (bf16) failed")
        bf16_s = time.perf_counter() - t0
        counts = read_counts()
        model = built.pop()
        names = [f"caption{c}_sample_{i}" for c in range(2) for i in range(4)]
        check(sorted(os.listdir(out)) == sorted(n + e for n in names for e in (".npy", ".wav")),
              f"generate CLI wrote {sorted(os.listdir(out))}")
        check(counts == expected_counts(K1=N_STEPS), f"generate CLI (bf16): launches {counts}")
        got = np.stack([np.load(os.path.join(out, n + ".npy")) for n in names])
        caps = [c for c in ENTRY_CAPTIONS for _ in range(4)]
        toks = torch.from_numpy(model.text_to_tokens(caps)["token"]).to(dev)
        want = cli.to_spec(model.generate(torch.Generator(dev).manual_seed(SEED), toks))
        check(np.array_equal(got, want.cpu().numpy()),
              "generate CLI (bf16): the mels differ from Diffsound.generate's")
        frames = {_wav_frames(os.path.join(out, n + ".wav")) for n in names}
        check(frames == {MEL[1] * 256}, f"generate CLI (bf16): wav frames {frames}")
        print(f"  (b) generate CLI, bf16, 2 captions x --replicate 4 (batch {BATCH}, {N_STEPS} "
              f"steps) with the MelGAN of {voc_dir[len(tmp) + 1:]}/: {bf16_s:.2f} s (the model's "
              f"build and the eight vocoder calls included); 8 .npy + 8 .wav; the mels bit for "
              f"bit Diffsound.generate's on a generator seeded --seed; launches {counts}")
        del model, want

        out = os.path.join(tmp, "cli_long")
        reset_counts()
        t0 = time.perf_counter()
        check(cli.main(["--config_file", yml, "--ckpt", "random", "--seed", str(SEED + 1),
                        "--outdir", out, "--vocoder", voc_dir, "--int8", "--duration",
                        str(LONG_SECONDS), "--batch", "1", "--replicate", "1", "--caption",
                        ENTRY_CAPTIONS[1]]) == 0, "generate CLI (--int8 --duration) failed")
        long_s = time.perf_counter() - t0
        counts = read_counts()
        n_frames = round(LONG_SECONDS * 22050 / 256)
        spec = np.load(os.path.join(out, "caption0_sample_0.npy"))
        check(spec.shape == (MEL[0], n_frames) and bool(np.isfinite(spec).all()),
              f"generate CLI (--int8 --duration): mel {spec.shape}")
        wav_frames = _wav_frames(os.path.join(out, "caption0_sample_0.wav"))
        check(wav_frames == n_frames * 256, f"generate CLI (--int8 --duration): {wav_frames} frames")
        want = expected_counts(K2=N_STEPS)     # one sampler call of 3 rows; K3-K5 as dynamic
        check(all(counts[k] == want[k] for k in ("K1", "K2", "K11", "T1", "T2", "T3")),
              f"generate CLI (--int8 --duration): launches {counts}")
        print(f"  (b) generate CLI, --int8 (W4A8, dynamic scales) --duration {LONG_SECONDS} "
              f"--batch 1: {long_s:.2f} s (build and quantization included); a {n_frames}-frame "
              f"mel, a wav of {wav_frames} samples; launches {counts}")
    finally:
        cli.load_model = load
        built.clear()
    torch.cuda.empty_cache()
    return bf16_s


def _http(host: str, port: int, method: str, path: str, body=None):
    """One request -> (status, content type, body bytes)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=300)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def _concurrent_http(host: str, port: int, bodies, stagger: float = 0.0):
    """POST /generate each body from its own thread -> [(status, type, body)]."""
    import threading

    out = [None] * len(bodies)

    def post(i):
        out[i] = _http(host, port, "POST", "/generate", bodies[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
        time.sleep(stagger)
    for t in threads:
        t.join(600)
    check(not any(t.is_alive() for t in threads), "server: a request never returned")
    return out


def _burst_numbers(results, wall: float, timeline) -> dict:
    """A burst's mel answers ([(ok, seconds, status)]) and its batches'
    timestamps -> clips/s, p50, p95 and each batch's dispatch and fetch wait."""
    lats = sorted(sec for _, sec, _ in results)
    n = len(lats)
    return {"clips_per_s": n / wall, "p50_s": lats[n // 2], "p95_s": lats[min(n - 1, int(n * 0.95))],
            "wall_s": wall, "batches": [t["size"] for t in timeline],
            "dispatch_s": [t["dispatch_end"] - t["dispatch_start"] for t in timeline],
            "fetch_wait_s": [t["fetch_end"] - t["dispatch_end"] for t in timeline]}


def _burst_line(b: dict) -> str:
    return (f"{b['clips_per_s']:.3f} clips/s ({len(b['batches'])} batches {b['batches']} in "
            f"{b['wall_s']:.3f} s), p50 {b['p50_s']:.3f} s, p95 {b['p95_s']:.3f} s; per batch, "
            f"dispatch (launches) {', '.join(f'{x:.3f}' for x in b['dispatch_s'])} s, then the "
            f"wait for its fetch {', '.join(f'{x:.3f}' for x in b['fetch_wait_s'])} s")


def _entry_server(yml: str, voc_dir: str, tmp: str, dev) -> dict:
    """(c): the W4A8 static server on 127.0.0.1:0, then a bf16 one at a queue
    limit of 1 for the 429. Returns the burst's numbers."""
    import io
    import threading

    from text_to_sound_synthesis_torch.tools import bench_serve, serve
    from text_to_sound_synthesis_torch.tools.generate import to_spec

    calib = os.path.join(tmp, "captions.txt")
    with open(calib, "w") as f:
        f.write("\n".join(bench_serve.CAPTIONS) + "\n")
    t0 = time.perf_counter()
    engine = serve.Engine(serve.get_args(
        ["--config_file", yml, "--ckpt", "random", "--seed", str(SEED + 2), "--int8",
         "--calibrate", calib, "--batch", str(BATCH), "--max_wait_ms", "50", "--vocoder",
         voc_dir, "--port", "0"]))
    ready_s = time.perf_counter() - t0
    check(engine.qp.weight_bits == 4 and engine.qp.act_scales is not None,
          "server: --int8 --calibrate is not the W4A8 static engine")
    srv = serve.make_server(engine, "127.0.0.1", 0)
    host, port = srv.server_address
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        status, ctype, body = _http(host, port, "GET", "/healthz")
        check((status, ctype, json.loads(body)) == (200, "application/json", {
            "status": "ok", "batch": BATCH, "served": 0}), f"server: /healthz {status} {body!r}")
        # one batch of identical captions against a direct generate_int8
        cap = ENTRY_CAPTIONS[0]
        state, n_batches = engine.generator.get_state(), len(engine.timeline)
        reset_counts()
        answers = _concurrent_http(host, port, [{"caption": cap, "format": "mel"}] * BATCH)
        counts = read_counts()
        check([a[0] for a in answers] == [200] * BATCH, f"server: {[a[0] for a in answers]}")
        check([t["size"] for t in engine.timeline[n_batches:]] == [BATCH],
              f"server: {BATCH} concurrent requests made batches "
              f"{[t['size'] for t in engine.timeline[n_batches:]]}")
        LN = N_LAYER * N_STEPS
        expect = expected_counts(K2=N_STEPS, K3=LN, K4=LN, K5=LN, Kp=2 * LN)
        check(counts == expect, f"server: launches {counts} for one batch, expected {expect} "
              "(phase 6's request)")
        got = np.stack([np.load(io.BytesIO(a[2])) for a in answers])
        g = torch.Generator(dev)
        g.set_state(state)
        toks = torch.from_numpy(engine.model.text_to_tokens([cap] * BATCH)["token"]).to(dev)
        want = to_spec(engine.model.generate_int8(engine.qp, g, toks)).cpu().numpy()
        # the callers' rows in the batch follow their arrival: match them as a set
        check(sorted(r.tobytes() for r in got) == sorted(r.tobytes() for r in want),
              "server: the batch's mels differ from a direct generate_int8 on the same captions "
              "and generator state")
        print(f"  (c) server (--int8 --calibrate: W4A8 static, batch {BATCH}, linger 50 ms) ready "
              f"in {ready_s:.1f} s (build, quantization, calibration, warm-up); /healthz 200; "
              f"{BATCH} concurrent requests of one caption: one batch, bit for bit a direct "
              f"generate_int8 on the generator's state, launches {counts}")
        bad = [(_http(host, port, "POST", "/generate", {})[0], 400),
               (_http(host, port, "GET", "/nope")[0], 404),
               (_http(host, port, "POST", "/generate", {"caption": cap, "format": "flac"})[0], 400)]
        check(all(a == b for a, b in bad), f"server: error statuses {bad}")

        # the burst: SERVE_BURST mel requests from SERVE_CLIENTS clients, two wavs beside
        start = len(engine.timeline)
        wavs = []
        wav_thread = threading.Thread(target=lambda: wavs.extend(_concurrent_http(
            host, port, [{"caption": c, "format": "wav"} for c in ENTRY_CAPTIONS])))
        wav_thread.start()
        results, wall = bench_serve.burst(host, port, SERVE_BURST, SERVE_CLIENTS)
        wav_thread.join(600)
        statuses = sorted(st for _, _, st in results) + [w[0] for w in wavs]
        check(statuses == [200] * (SERVE_BURST + 2), f"server burst: statuses {statuses}")
        for status, ctype, body in wavs:
            path = os.path.join(tmp, "served.wav")
            with open(path, "wb") as f:
                f.write(body)
            check(ctype == "audio/wav" and _wav_frames(path) == MEL[1] * 256,
                  f"server: a wav answer of type {ctype}")
        tl = engine.timeline[start:]
        overlaps = sum(tl[i]["dispatch_start"] < tl[i - 1]["fetch_end"] for i in range(1, len(tl)))
        check(overlaps > 0, "server: no dispatch began before the previous batch's fetch ended "
              "(dispatch not pipelined)")
        out = {"with_wavs": _burst_numbers(results, wall, tl), "overlaps": overlaps}
        print(f"  (c) burst of {SERVE_BURST} mel requests from {SERVE_CLIENTS} clients and 2 wav "
              f"requests: all 200; {overlaps} of {len(tl) - 1} dispatches began before the "
              f"previous batch's fetch ended; on {card_line()}: {_burst_line(out['with_wavs'])}")
        # the same burst without the wav requests (the vocoder's work in the
        # handlers is the only difference)
        start = len(engine.timeline)
        results, wall = bench_serve.burst(host, port, SERVE_BURST, SERVE_CLIENTS)
        check(sorted(st for _, _, st in results) == [200] * SERVE_BURST,
              "server burst: a request failed")
        out["mel_only"] = _burst_numbers(results, wall, engine.timeline[start:])
        print(f"  (c) the burst again, mel requests only: {_burst_line(out['mel_only'])}")
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
    del engine
    torch.cuda.empty_cache()

    # a 429: a bf16 server of batch 1 at a queue limit of 1; the collector
    # holds the first request for its launches, the second waits, the third
    # finds the queue full
    engine = serve.Engine(serve.get_args(
        ["--config_file", yml, "--ckpt", "random", "--seed", str(SEED + 3), "--batch", "1",
         "--queue_limit", "1", "--max_wait_ms", "0", "--port", "0"]))
    srv = serve.make_server(engine, "127.0.0.1", 0)
    host, port = srv.server_address
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        answers = _concurrent_http(host, port, [{"caption": c, "format": "mel"} for c in
                                                ("wind", "rain", "a horn")], stagger=0.1)
        statuses = [a[0] for a in answers]
        check(statuses == [200, 200, 429], f"server at a queue limit of 1: statuses {statuses}")
        body = json.loads(answers[2][2])
        check(body == {"error": "request queue full (1 pending)"}, f"server: the 429's body {body}")
        print(f"  (c) bf16 server at --queue_limit 1: statuses {statuses}, the 429's body {body}")
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
    del engine
    torch.cuda.empty_cache()
    return out


def phase_entry(vocoder, dev) -> dict:
    """Phase 10e (module docstring). Returns the server bursts' numbers
    ("with_wavs", "mel_only", "overlaps") and the phase's "seconds"."""
    import tempfile

    from text_to_sound_synthesis_torch.tools import bench_serve

    t_phase = time.perf_counter()
    old = os.environ.get("T2S_CLIP_BPE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["T2S_CLIP_BPE"] = _entry_tokenizer(tmp)
        try:
            yml = _flagship_yaml(os.path.join(tmp, "flagship_bf16.yaml"))
            voc_dir = write_vocoder_dir(vocoder, os.path.join(tmp, "vocoder"))
            _entry_cli(yml, voc_dir, tmp, dev)
            burst = _entry_server(yml, voc_dir, tmp, dev)
            print("  (d) bench_serve --requests 16 --clients 8 --batch 8 (its defaults otherwise: "
                  "--int8 W4A8 dynamic, top0.85r,fast3), its line:", flush=True)
            check(bench_serve.main(["--config_file", yml, "--requests", "16", "--clients", "8",
                                    "--batch", "8", "--port", "0"]) == 0,
                  "bench_serve: a request failed")
        finally:
            if old is None:
                os.environ.pop("T2S_CLIP_BPE", None)
            else:
                os.environ["T2S_CLIP_BPE"] = old
    torch.cuda.empty_cache()
    burst["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 10e: {burst['seconds']:.1f} s")
    return burst


# -- phase 10f: the long tail ----------------------------------------------------------------

VQGAN_CAPS = os.path.join(REPO, "configs", "vqgan_caps.yaml")
# (a) the AR flagship's bf16 compute against its f32 (TF32 off) on the same
# weights: the logits on the f32 sequence within AR_BF16_REL of the largest
# |f32 logit| (measured 1.471e-2 on the H100; 1.3e-2 in the CPU test), a
# limit fixed beforehand, not read off the path under test; a greedy token
# may differ only at a near-tie of the f32 logits on the shared prefix, its
# two logits within the band: twice that limit's |bf16 - f32|, the most two
# logits can move against each other.
AR_BF16_REL = 2e-2
# (d) train_classifier's step at its defaults (batch 16, lr 3e-4, wd 1e-4),
# card against CPU in full f32 on the CPU's threads: the first step from one
# state on both sides, then two more on the card alone, timed. The loss
# within TRAIN_RTOL. Each gradient tensor within CLS_GRAD_TOL of its norm,
# but the conv biases ahead of a BatchNorm, zero in exact arithmetic (both
# sides hold rounding): on the H100 cuDNN's f32 convs (TF32 off) put each
# conv layer's gradient 0.03-0.8 % of its norm from the CPU's (VGG16's 13
# layers, the error growing toward the input), the dense head's 1e-6; the
# gate is 2.5x that. The weights are the first AdamW step (betas 0.9 /
# 0.999, eps 1e-8) on the card's own gradients, w (1 - lr wd) - lr g /
# (|g| + eps), within CLS_ADAM_TOL lr plus two f32 ulps of w: f32 rounds
# the moments, their bias corrections and the two updates of w, a few ulps
# in all, where a gradient of the wrong sign is 2 lr off and a missing step
# 1 lr. (Two sides' weights cannot be held to each other: where they round
# a near-zero gradient to opposite signs, AdamW's step parts them by 2 lr.)
# The running statistics within CLS_STATS_RTOL of their largest.
CLS_CLASSES, CLS_BATCH, CLS_STEPS, CLS_LR, CLS_WD = 309, 16, 3, 3e-4, 1e-4
CLS_MEL = MEL
CLS_ARCHS = (("melception", False), ("vggishish", False), ("vggishish", True))
CLS_GRAD_TOL, CLS_STATS_RTOL, CLS_ADAM_TOL = 2e-2, 1e-5, 1e-5
# (e) ViT-B/32 in full f32, card against CPU: 12 layers at width 768, the
# largest |difference| over the largest |value| (~1e-6 each side)
VIT = dict(input_resolution=224, patch_size=32, width=768, layers=12, heads=12, output_dim=512)
VIT_BATCH, VIT_TOL = 16, 1e-4
GATE_CAPTIONS = ENTRY_CAPTIONS


def _ar_feat_dim(cfg) -> int:
    return int(cfg["model"]["params"]["transformer_config"]["params"]["feat_embedding_config"]
               ["params"]["in_channels"])


def _idle_share(run):
    """(wall s of one run, device ms of one profiled run, idle share =
    1 - device / wall): the device events of ``torch.profiler`` with CUDA
    activity only, summed from its raw results, not through ``key_averages``,
    which builds an event tree in Python for each of a request's kernels
    (~500 a decode step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA) / 1e6
    return wall, device_ms, 1 - device_ms / (wall * 1e3)


def _tail_ar_bf16(vocoder, dev) -> dict:
    """(a): the AR flagship with ``dtype: bfloat16`` against the same weights in f32."""
    import copy

    from text_to_sound_synthesis_torch.models.gpt import ar_sample
    from text_to_sound_synthesis_torch.tools.train_ar import build_model
    from text_to_sound_synthesis_torch.utils.config import load_yaml_config
    from text_to_sound_synthesis_torch.utils.dtype import full_f32

    cfg = load_yaml_config(AR_CONFIG)
    bcfg = copy.deepcopy(cfg)
    bcfg["model"]["params"]["dtype"] = "bfloat16"
    f32, bf16 = build_model(cfg, dev, SEED + 70), build_model(bcfg, dev, SEED + 70)
    check(bf16.dtype == bf16.gpt.dtype == torch.bfloat16 and f32.gpt.dtype == torch.float32
          and all(torch.equal(a, b) for a, b in zip(f32.state_dict().values(),
                                                    bf16.state_dict().values())),
          "tail (a): the bf16 model's f32 weights are not the f32 model's")
    feats = torch.randn((BATCH, _ar_feat_dim(cfg), 1), device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED + 71))
    feats = feats / feats.norm(dim=1, keepdim=True)
    steps = AR_HW[0] * AR_HW[1]
    with torch.no_grad(), full_f32():
        g32 = ar_sample(f32.gpt, feats, steps=steps, top_k=1)
        g16 = ar_sample(bf16.gpt, feats, steps=steps, top_k=1)
        l32 = f32.gpt(g32[:, :-1], feats)
        l16 = bf16.gpt(g32[:, :-1], feats)
    check(l16.dtype == torch.bfloat16 and bf16.gpt.init_cache(1)[0].k.dtype == torch.bfloat16,
          "tail (a): the bf16 model's logits or KV cache are not bf16")
    d = (l16.float() - l32).abs()
    rel = float(d.max() / l32.abs().max())
    check(rel <= AR_BF16_REL, f"tail (a): bf16 logits off f32 by {rel:.3e} of max|f32| "
          f"(limit {AR_BF16_REL:g})")
    band = 2 * AR_BF16_REL * float(l32.abs().max())
    share = float((g16 == g32).float().mean())
    firsts, far = [], 0
    for b in range(BATCH):
        diff = (g16[b] != g32[b]).nonzero()
        if len(diff):
            t = int(diff[0])
            margin = float(l32[b, t, g32[b, t]] - l32[b, t, g16[b, t]])
            firsts.append((b, t, round(margin, 4)))
            far += margin > band
    check(far == 0, f"tail (a): a greedy bf16 token first differs past the band {band:.4f}: "
          f"{firsts}")

    def req(model, seed, what):
        def run():
            mel = model.sample(feats, AR_HW, top_k=AR_TOP_K,
                               generator=torch.Generator(dev).manual_seed(seed))
            wav = vocoder((mel[..., 0].float() + 1.0) / 2.0)
            check(tuple(mel.shape) == (BATCH, *MEL, 1) and bool(torch.isfinite(mel).all())
                  and bool(torch.isfinite(wav).all()), f"tail (a): the {what} request's output")
        return run

    with full_f32():
        res = {k: _idle_share(req(m, SEED + 73, k)) for k, m in (("f32", f32), ("bf16", bf16))}
    print(f"  (a) {AR_CONFIG[len(REPO) + 1:]} with dtype: bfloat16 against the same weights in "
          f"f32 (TF32 off): KV cache and logits bf16, parameters f32; greedy {steps} tokens at "
          f"batch {BATCH}: {100 * share:.2f} % equal, first differences (row, step, f32 margin) "
          f"{firsts} within the band {band:.4f} (2 x {AR_BF16_REL:g} max|f32 logit|); logits "
          f"on the f32 sequence max|d| / max|f32| {rel:.3e} (limit {AR_BF16_REL:g})")
    for k, (wall, dev_ms, idle) in res.items():
        print(f"      {k} request (features -> {steps} tokens top-k {AR_TOP_K} -> decode_code -> "
              f"MelGAN, batch {BATCH}): {wall:.3f} s = {BATCH / wall:.3f} clips/s; device "
              f"{dev_ms:.1f} ms, idle share {idle:.3f}")
    del f32, bf16
    torch.cuda.empty_cache()
    return {**res, "share": share, "rel": rel}


def _tail_train_ar_group(dev):
    """(b): ``train_ar``'s step under a one-rank NCCL group (the GPT under
    DDP) against the step without, two steps, at the rule's lr."""
    import copy

    import torch.distributed as dist

    from text_to_sound_synthesis_torch.parallel import (get_world_size, init_distributed,
                                                        wrap_ddp)
    from text_to_sound_synthesis_torch.tools import train_ar
    from text_to_sound_synthesis_torch.utils.config import load_yaml_config
    from text_to_sound_synthesis_torch.utils.dtype import full_f32

    cfg = load_yaml_config(AR_CONFIG)
    plain = train_ar.build_model(cfg, dev, SEED + 74)
    under = copy.deepcopy(plain)
    gen = torch.Generator(dev).manual_seed(SEED + 75)
    mel = torch.rand((BATCH, *MEL, 1), generator=gen, device=dev) * 2 - 1
    feats = torch.randn((BATCH, _ar_feat_dim(cfg), 1), generator=gen, device=dev)
    init_distributed(dev, init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        backend, world = dist.get_backend(), get_world_size()
        lr = train_ar.learning_rate(cfg, world)
        bs, base = int(cfg["dataloader"]["batch_size"]), float(cfg["model"]["base_learning_rate"])
        check(lr == 1 * bs * base, f"tail (b): lr {lr} is not 1 x {bs} x {base}")
        gpt = wrap_ddp(under.gpt, dev)
        check(isinstance(gpt, torch.nn.parallel.DistributedDataParallel), "tail (b): no DDP")
        opts = train_ar.build_optimizer(plain, lr), train_ar.build_optimizer(under, lr)
        plain.gpt.train()
        under.gpt.train()
        losses = []
        with full_f32(), deterministic_algorithms():
            for _ in range(2):
                losses.append((train_ar.train_step(plain, opts[0], mel, feats),
                               train_ar.train_step(under, opts[1], mel, feats, None, gpt)))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    differ = [n for (n, p), q in zip(plain.named_parameters(), under.parameters())
              if not torch.equal(p, q)]
    differ += [f"AdamW state of {n}" for (n, _), s, t in zip(
        plain.gpt.named_parameters(), opts[0].state.values(), opts[1].state.values())
        if not all(torch.equal(x, y) for x, y in zip(s.values(), t.values()))]
    differ += [f"loss {i + 1}" for i, (a, b) in enumerate(losses) if not torch.equal(a, b)]
    check(not differ, f"tail (b): train_ar's step under DDP (one rank) differs from the step "
          f"without: {differ[:6]}")
    print(f"  (b) train_ar under a one-rank {backend} group, lr = {world} x {bs} x {base:g} = "
          f"{lr:g}: two steps at batch {BATCH} with the GPT under DDP bit for bit the steps "
          f"without (losses, weights, AdamW moments), both under torch's deterministic "
          f"algorithms; the codec outside DDP")
    del plain, under, opts
    torch.cuda.empty_cache()


def _tail_remat(dev) -> dict:
    """(c): the flagship Stage-2 loss and gradients with the denoiser's
    ``checkpoint`` on and off, then whole steps each way: peak memory, time."""
    from text_to_sound_synthesis_torch.models.diffusion.process import sample_timesteps

    tr = FlagshipTrainer(dev)
    model, den = tr.model, tr.denoiser
    diff = model.diffusion
    draws = _train_draws(tr.gen, TRAIN_BATCH, diff.diffusion_step, diff.content_seq_len,
                         diff.num_classes)

    def loss_grads(ck: bool):
        den.checkpoint = ck
        den.zero_grad(set_to_none=True)
        t, pt = sample_timesteps(tr.state.lt, TRAIN_BATCH, draws=draws.timesteps)
        out = model.loss(tr.batch["image"], tr.batch["condition_token"], t, pt,
                         gumbel=draws.gumbel)
        out.loss.backward()
        return out.loss.detach(), [p.grad.clone() for p in den.parameters()]

    with pytorch_default_precision():
        (l0, g0), (l1, g1) = loss_grads(False), loss_grads(True)
        bitwise = torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
        g_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(g1, g0))
        l_rel = abs(float(l1 - l0)) / abs(float(l0))
        del g0, g1
        den.zero_grad(set_to_none=True)
        runs = {False: [], True: []}
        for ck in (False, True, False, True):
            den.checkpoint = ck
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = tr.step()
            torch.cuda.synchronize()
            runs[ck].append((time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30))
            check(np.isfinite(float(m.loss)), f"tail (c): loss {float(m.loss)}")
    den.checkpoint = False
    check(bitwise or (l_rel <= TRAIN_RTOL and g_rel <= TRAIN_RTOL),
          f"tail (c): checkpointing moved the loss by {l_rel:.2e}, a gradient by {g_rel:.2e}")
    (s_plain, gb_plain), (s_ck, gb_ck) = runs[False][-1], runs[True][-1]
    check(gb_ck < gb_plain, f"tail (c): peak memory {gb_ck:.2f} GiB with checkpointing, "
          f"{gb_plain:.2f} without")
    print(f"  (c) the flagship Stage-2 loss at batch {TRAIN_BATCH} (f32, TF32 convs) with "
          f"checkpoint=True against False: "
          f"{'bit for bit (loss and every gradient)' if bitwise else f'within TRAIN_RTOL: loss {l_rel:.2e}, gradients {g_rel:.2e} (the recompute rounds otherwise)'}; "
          f"a whole step (second of each, in turns): {s_plain:.4f} s / {gb_plain:.2f} GiB peak "
          f"without, {s_ck:.4f} s / {gb_ck:.2f} GiB with (PERF.md's record: 22.6 GiB without)")
    del tr, model, den
    torch.cuda.empty_cache()
    return {"plain": runs[False][-1], "checkpoint": runs[True][-1], "bitwise": bitwise}


def _biases_ahead_of_batch_norm(model) -> set:
    """Names of the conv biases followed by a BatchNorm in a Sequential: the
    norm subtracts the batch mean, so their gradient is zero in exact
    arithmetic and each side holds its rounding."""
    out = set()
    for name, seq in model.named_modules():
        if isinstance(seq, torch.nn.Sequential):
            for j in range(len(seq) - 1):
                if (isinstance(seq[j], torch.nn.Conv2d) and seq[j].bias is not None
                        and isinstance(seq[j + 1], torch.nn.modules.batchnorm._BatchNorm)):
                    out.add(f"{name}.{j}.bias" if name else f"{j}.bias")
    return out


def _first_adamw_error(params, before) -> float:
    """The largest |w - (w0 (1 - lr wd) - lr g / (|g| + eps))| over ``params``
    after a first AdamW step from ``before`` (their values before it) on
    their gradients, over CLS_LR, less two f32 ulps of w0; at most
    CLS_ADAM_TOL if the step is that one."""
    worst = 0.0
    for k, p in params:
        g, w = p.grad.double(), before[k].double()
        want = w * (1 - CLS_LR * CLS_WD) - CLS_LR * g / (g.abs() + 1e-8)
        over = (p.detach().double() - want).abs() - 2 ** -22 * w.abs()
        worst = max(worst, float(over.max()) / CLS_LR)
    return worst


def _tail_classifier(dev) -> dict:
    """(d): train_classifier's step, card against CPU in full f32: the first
    from one state on both sides, then two more on the card alone."""
    import copy

    from text_to_sound_synthesis_torch.engine.classifier_solver import (
        ClassifierTrainState, make_classifier_train_step)
    from text_to_sound_synthesis_torch.tools.train_classifier import (build_classifier,
                                                                      init_classifier_)
    from text_to_sound_synthesis_torch.utils.dtype import full_f32

    rng = np.random.default_rng(SEED + 76)
    mel = torch.from_numpy(rng.standard_normal((CLS_BATCH, *CLS_MEL)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, CLS_CLASSES, CLS_BATCH))
    counts = np.bincount(target.numpy(), minlength=CLS_CLASSES).astype(np.float32)
    weights = torch.from_numpy(counts.sum() / np.maximum(counts, 1.0))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, len(os.sched_getaffinity(0))))
    out = {}
    try:
        for i, (arch, use_bn) in enumerate(CLS_ARCHS):
            name = arch + (" use_bn" if use_bn else "")
            card = init_classifier_(build_classifier(arch, CLS_CLASSES, use_bn=use_bn)
                                    .to_empty(device=dev),
                                    torch.Generator(dev).manual_seed(SEED + 77 + i))
            cpu = copy.deepcopy(card).cpu()
            stats0 = {k: v.clone() for k, v in cpu.state_dict().items() if "running" in k}
            before = {k: p.detach().clone() for k, p in card.named_parameters()}
            zero = _biases_ahead_of_batch_norm(cpu)
            sc, sp = (ClassifierTrainState.create(card, CLS_LR, CLS_WD),
                      ClassifierTrainState.create(cpu, CLS_LR, CLS_WD))
            fc, fp = make_classifier_train_step(weights.to(dev)), make_classifier_train_step(weights)
            mc, tc = mel.to(dev), target.to(dev)
            with full_f32():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lc = float(fc(sc, mc, tc)["loss"])
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                t0 = time.perf_counter()
                lp = float(fp(sp, mel, target)["loss"])
                cpu_s = time.perf_counter() - t0
                check(abs(lc - lp) <= TRAIN_RTOL * abs(lp),
                      f"tail (d) {name}: loss card {lc!r} CPU {lp!r}")
                g_err = 0.0
                for (k, a), b in zip(card.named_parameters(), cpu.parameters()):
                    if k in zero:        # zero in exact arithmetic: rounding on both sides
                        continue
                    d = a.grad.cpu().double() - b.grad.double()
                    rel = float(d.norm() / b.grad.double().norm())
                    g_err = max(g_err, rel)
                    check(rel <= CLS_GRAD_TOL, f"tail (d) {name}: {k}.grad off by {rel:.2e} "
                          "of its norm")
                adam = _first_adamw_error(card.named_parameters(), before)
                check(adam <= CLS_ADAM_TOL, f"tail (d) {name}: the weights are {adam:.2e} lr "
                      "off AdamW's first step on the card's gradients")
                sd = cpu.state_dict()
                for k, v in card.state_dict().items():
                    if "running" in k or "num_batches" in k:
                        d = float((v.cpu().double() - sd[k].double()).abs().max())
                        check(d <= CLS_STATS_RTOL * float(sd[k].abs().max()),
                              f"tail (d) {name}: {k} off by {d:.2e}")
                secs = []
                for _ in range(CLS_STEPS - 1):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    loss = float(fc(sc, mc, tc)["loss"])
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    check(np.isfinite(loss), f"tail (d) {name}: loss {loss}")
            moved = [not torch.equal(v.cpu(), stats0[k]) for k, v in card.state_dict().items()
                     if "running" in k]
            if arch == "melception":
                check(not any(moved) and all(torch.equal(v, stats0[k]) for k, v in
                                             cpu.state_dict().items() if "running" in k),
                      "tail (d) melception: the running statistics moved")
            elif use_bn:
                check(all(moved), "tail (d) vggishish use_bn: a BatchNorm kept its statistics")
            n = sum(p.numel() for p in card.parameters())
            out[name] = float(np.median(secs))
            stats = ("running statistics untouched over three steps (the folded affine trained)"
                     if arch == "melception" else f"running statistics within {CLS_STATS_RTOL:g}"
                     if use_bn else "no BatchNorm")
            print(f"  (d) {name} ({n / 1e6:.1f} M parameters, {CLS_CLASSES} classes), batch "
                  f"{CLS_BATCH} of {CLS_MEL[0]} x {CLS_MEL[1]}, lr {CLS_LR:g}, weighted CE, full "
                  f"f32, card vs CPU ({torch.get_num_threads()} threads) on the first step: loss "
                  f"{lc:.6f} / {lp:.6f}; gradients within {g_err:.2e} of their norm (gate "
                  f"{CLS_GRAD_TOL:g}; not the {len(zero)} conv biases ahead of a BatchNorm, zero "
                  f"in exact arithmetic); the weights AdamW's first step on the card's gradients "
                  f"within {adam:.1e} lr (gate {CLS_ADAM_TOL:g} lr + 2 ulps); {stats}; a step on "
                  f"the card {out[name]:.4f} s (median of steps 2-3; the first {first:.4f} s), "
                  f"the CPU's {cpu_s:.1f} s")
            del cpu, card, sc, sp
            torch.cuda.empty_cache()
    finally:
        torch.set_num_threads(threads)
    return out


def _tail_vit(dev) -> float:
    """(e): the CLIP ViT-B/32 vision tower, card against CPU in full f32."""
    import copy

    from text_to_sound_synthesis_torch.models.clip import ClipVisionEncoder
    from text_to_sound_synthesis_torch.utils.dtype import full_f32

    cpu = ClipVisionEncoder(**VIT).init_params(torch.Generator().manual_seed(SEED + 80)).eval()
    card = copy.deepcopy(cpu).to(dev)
    px = VIT["input_resolution"]
    x = torch.randn((VIT_BATCH, 3, px, px), generator=torch.Generator().manual_seed(SEED + 81))
    xd = x.to(dev)
    with torch.no_grad(), full_f32():
        want = cpu(x)
        got = card(xd)
        ms = cuda_time_ms(lambda: card(xd), iters=20, warmup=3)
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    check(tuple(got.shape) == (VIT_BATCH, VIT["output_dim"]) and bool(torch.isfinite(got).all())
          and err <= VIT_TOL, f"tail (e): ViT card vs CPU {err:.2e}")
    n = sum(p.numel() for p in cpu.parameters())
    print(f"  (e) CLIP ViT-B/32 ({n / 1e6:.1f} M, {px} px, width {VIT['width']}, {VIT['layers']} "
          f"layers x {VIT['heads']} heads, output {VIT['output_dim']}), batch {VIT_BATCH}, full "
          f"f32: card vs CPU max|d| / max|CPU| {err:.2e} (gate "
          f"{VIT_TOL:g}); {ms:.3f} ms a batch on the card")
    return ms


def _tail_vis_codebook(vocoder, tmp: str, dev):
    """(f): ``vis_codebook`` on a seeded 10 s wav, the flagship codec and MelGAN."""
    import io

    from text_to_sound_synthesis_torch.models.vqgan.model import VQModel, init_codec_
    from text_to_sound_synthesis_torch.tools import vis_codebook
    from text_to_sound_synthesis_torch.utils.config import load_yaml_config
    from text_to_sound_synthesis_torch.utils.dtype import full_f32
    from text_to_sound_synthesis_torch.utils.io import read_wav, write_wav

    mp = load_yaml_config(VQGAN_CAPS)["model"]["params"]
    codec = init_codec_(VQModel(mp["ddconfig"], n_embed=mp["n_embed"], embed_dim=mp["embed_dim"]),
                        torch.Generator().manual_seed(SEED + 82)).eval()
    ckpt = os.path.join(tmp, "codec.ckpt")
    torch.save({"state_dict": codec.state_dict()}, ckpt)
    wav_path = os.path.join(tmp, "clip.wav")
    write_wav(wav_path, 22050, (np.random.default_rng(SEED + 83).standard_normal(22050 * 10)
                                * 0.1).astype(np.float32))
    out = os.path.join(tmp, "vis")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = vis_codebook.main(["--wav", wav_path, "--config", VQGAN_CAPS, "--ckpt", ckpt,
                                "--vocoder", write_vocoder_dir(vocoder, os.path.join(tmp, "voc")),
                                "--outdir", out])
    secs = time.perf_counter() - t0
    report = buf.getvalue()
    tokens = np.load(os.path.join(out, "tokens.npy"))
    _, spec = vis_codebook.clip_mel(read_wav(wav_path, 22050)[0], MEL[1])
    with torch.no_grad(), full_f32():
        _, vq = codec.encode(torch.from_numpy(2 * spec - 1)[None, :, :, None])
    seconds, n, ne = MEL[1] * 256 / 22050, tokens.size, mp["n_embed"]
    line = (f"codebook bitrate: {n * np.log2(ne) / seconds:.1f} bit/s ({n} tokens x log2({ne}) / "
            f"{seconds:.2f}s)")
    down = 2 ** (len(mp["ddconfig"]["ch_mult"]) - 1)
    check(rc == 0 and tokens.shape == (MEL[0] // down, MEL[1] // down),
          f"tail (f): vis_codebook rc {rc}, {tokens.shape}")
    check(np.array_equal(tokens, vq.indices[0].numpy()),
          f"tail (f): {int((tokens != vq.indices[0].numpy()).sum())} of 265 tokens differ from "
          "VQModel.encode's on the CPU")
    check(line in report, f"tail (f): no line {line!r} in the report")
    check(all(os.path.exists(os.path.join(out, f)) for f in
              ("reconstruction.npy", "reconstruction.wav", "original.wav")), "tail (f): outputs")
    l1 = [r for r in report.splitlines() if r.startswith("reconstruction L1")]
    print(f"  (f) vis_codebook on a seeded 10 s wav, {VQGAN_CAPS[len(REPO) + 1:]}'s codec and "
          f"MelGAN: the {tokens.shape[0]} x {tokens.shape[1]} grid equal to VQModel.encode's on "
          f"the CPU; '{line}'; {l1[0]}; "
          f"tokens, reconstruction and two wavs written; {secs:.1f} s")


def _tail_parity_gate(model, tmp: str, dev) -> dict:
    """(g): ``run_parity_gate`` in smoke mode on a proxy ``.pth`` of phase 5's
    model, bf16 and ``--int8``; its samples against ``tools/generate.py``'s."""
    from text_to_sound_synthesis_torch.tools import generate, run_parity_gate as gate

    pth = os.path.join(tmp, "diffsound_proxy.pth")
    t0 = time.perf_counter()
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    torch.save({"model": sd, "ema": {k[len("transformer."):]: v for k, v in sd.items()
                                     if k.startswith("transformer.transformer.")}}, pth)
    print(f"  (g) the proxy .pth ({os.path.getsize(pth) / 2**30:.2f} GiB) written in "
          f"{time.perf_counter() - t0:.1f} s")
    yml = _flagship_yaml(os.path.join(tmp, "gate_bf16.yaml"))
    common = ["--config_file", yml, "--ckpt", pth, "--replicate", "2", "--batch", "2"]
    for c in GATE_CAPTIONS:
        common += ["--caption", c]
    LN = N_LAYER * N_STEPS
    want = {"bf16": expected_counts(K1=N_STEPS),
            "int8": expected_counts(K2=N_STEPS, K3=LN, K4=LN, K5=LN, Kp=2 * LN, Kw=LN)}
    res = {}
    for mode, extra in (("bf16", []), ("int8", ["--int8"])):
        out = os.path.join(tmp, f"gate_{mode}")
        reset_counts()
        t0 = time.perf_counter()
        rc = gate.main(common + extra + ["--outdir", out])
        secs = time.perf_counter() - t0
        counts = read_counts()
        report = open(os.path.join(out, "PARITY_GATE.md")).read()
        rows = [r.split(" | ") for r in report.splitlines() if r.startswith("| ")
                and not r.startswith("| step")]
        status = {r[0][2:]: r[1] for r in rows}
        skips = [r[2] for r in rows if r[1] == "SKIP" and r[0][2:] in ("roundtrip", "logit_parity")]
        check(rc == 0 and "FAIL" not in status.values(), f"tail (g) {mode}: {status}")
        check(status.get("load") == "PASS" and status.get("generate") == "PASS",
              f"tail (g) {mode}: {status}")
        check(all("T2S_REFERENCE" in s for s in skips), f"tail (g) {mode}: SKIPs {skips}")
        check(counts == want[mode], f"tail (g) {mode}: launches {counts}, expected {want[mode]}")
        direct = os.path.join(tmp, f"generate_{mode}")
        check(generate.main(common + extra + ["--outdir", direct]) == 0, f"tail (g) {mode}: generate")
        names = sorted(os.listdir(os.path.join(out, "samples")))
        check(len(names) == 2 * len(GATE_CAPTIONS) and names == sorted(os.listdir(direct))
              and all(np.array_equal(np.load(os.path.join(out, "samples", n)),
                                     np.load(os.path.join(direct, n))) for n in names),
              f"tail (g) {mode}: the gate's samples are not generate.py's")
        res[mode] = secs
        print(f"  (g) run_parity_gate smoke ({mode}), the flagship bf16 config, a proxy .pth of "
              f"phase 5's weights ({{'model', 'ema'}}), --replicate 2 --batch 2: {status}; "
              f"{len(names)} samples bit for bit generate.py's; launches "
              f"{ {k: v for k, v in counts.items() if v} }; {secs:.1f} s")
    gate._RAW_CACHE.clear()
    return res


def _tail_dryrun(dev) -> float:
    """(h): ``dryrun.entry()`` on the card, then ``dryrun_multichip(1)`` under NCCL."""
    from text_to_sound_synthesis_torch.tools import dryrun

    fn, args = dryrun.entry(dev)
    logp = fn(*args)
    check(tuple(logp.shape) == (1, L_TOK, 257) and bool(torch.isfinite(logp).all())
          and args[0].transformer.to_logits[1].weight.dtype == torch.bfloat16,
          f"tail (h): entry's log p {tuple(logp.shape)}")
    del fn, args, logp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(1, "cuda")
    secs = time.perf_counter() - t0
    print(f"  (h) dryrun.entry(): the flagship denoiser's predict_start in bf16 at batch 1 on "
          f"the card, finite (1, {L_TOK}, 257) log-probabilities; dryrun_multichip(1) under NCCL "
          f"(a spawned rank: one DDP train step, both sharded samplers) in {secs:.1f} s")
    return secs


def phase_tail(model, vocoder, dev) -> dict:
    """Phase 10f (module docstring). Returns its parts' numbers and "seconds"."""
    import tempfile

    t_phase = time.perf_counter()
    parts = {}

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[key] = time.perf_counter() - t0
        return out

    reset_counts()
    res = {"ar": timed("a", _tail_ar_bf16, vocoder, dev)}
    timed("b", _tail_train_ar_group, dev)
    res["remat"] = timed("c", _tail_remat, dev)
    res["classifier"] = timed("d", _tail_classifier, dev)
    res["vit_ms"] = timed("e", _tail_vit, dev)
    counts = read_counts()
    check(counts == expected_counts(), f"tail (a)-(e): kernel launches {counts}")
    old = os.environ.get("T2S_CLIP_BPE")
    with tempfile.TemporaryDirectory() as tmp:
        if old is None:
            os.environ["T2S_CLIP_BPE"] = write_merge_table(os.path.join(tmp, "merges.txt"))
        try:
            reset_counts()
            timed("f", _tail_vis_codebook, vocoder, tmp, dev)
            check(read_counts() == expected_counts(), "tail (f): a kernel launched")
            res["gate"] = timed("g", _tail_parity_gate, model, tmp, dev)
        finally:
            if old is None:
                os.environ.pop("T2S_CLIP_BPE", None)
    res["dryrun_s"] = timed("h", _tail_dryrun, dev)
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 10f: {res['seconds']:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items()) + ")")
    return res


# -- phase 10g: the Megatron model axis ----------------------------------------------------------

MA_BATCH, MA_LR, MA_STEPS = 4, 1e-4, 3   # the global batch, AdamW's lr, timed steps a side
MA_TIMEOUT = 300                         # seconds for the two ranks, the build included


def _sync_step(step, state, batch, draws, dev):
    """One step, waited for; (state, metrics, seconds)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, m = step(state, batch, MA_LR, draws=draws)
    float(m.loss)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state, m, time.perf_counter() - t0


def _model_axis_rank(rank: int, port: int, device_type: str, tiny: bool, queue) -> None:
    """One of phase 10g's two ranks, a (1, 2) gloo group on one card: both
    take the split step and MA_STEPS more; then rank 0 takes the
    one-process step from the same weights, batch and draws, compares the
    two and times MA_STEPS more. Rank 0 puts the numbers in ``queue``; a
    failure on either rank puts its traceback there."""
    import traceback

    import torch.distributed as dist

    try:
        from text_to_sound_synthesis_torch.engine.clip_grad import ClipGradNorm
        from text_to_sound_synthesis_torch.engine.optimizers import build_optimizer
        from text_to_sound_synthesis_torch.engine.train_state import (DiffusionTrainState,
                                                                      make_train_step)
        from text_to_sound_synthesis_torch.parallel import init_distributed, same_across
        from text_to_sound_synthesis_torch.parallel.mesh import make_mesh
        from text_to_sound_synthesis_torch.parallel.sharding import megatron_denoiser
        from text_to_sound_synthesis_torch.tools import dryrun
        from text_to_sound_synthesis_torch.utils.dtype import full_f32

        dev = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        opt_cfg = {"target": "adamw", "params": {"betas": (0.9, 0.96), "weight_decay": 0.045}}
        with full_f32():
            t_build = time.perf_counter()
            init_distributed(dev, init_method=f"tcp://localhost:{port}", rank=rank,
                             world_size=2, backend="gloo")
            mesh = make_mesh(model=2)
            model = dryrun.build_diffusion(tiny, dev, SEED + 70)
            T, L, K = model.diffusion_step, model.content_seq_len, model.num_classes
            tcfg = dryrun.diffusion_params(tiny)["transformer_config"]["params"]
            S, D = tcfg.get("condition_seq_len", dryrun.TINY_COND), tcfg["condition_dim"]
            rng = np.random.default_rng(SEED + 71)
            cond = rng.standard_normal((MA_BATCH, S, D)).astype(np.float32)
            batch = {"x0": torch.from_numpy(rng.integers(0, K - 1, (MA_BATCH, L))).to(dev),
                     "cond": torch.from_numpy(cond / np.linalg.norm(cond, axis=-1,
                                                                  keepdims=True)).to(dev)}
            draws = _train_draws(torch.Generator(dev).manual_seed(SEED + 72), MA_BATCH, T, L, K)

            # the split step: the denoiser over the model axis, the data axis 1 (no DDP)
            den = megatron_denoiser(model.transformer, mesh)
            n_local = sum(p.numel() for p in den.parameters())
            state = DiffusionTrainState.create(den, build_optimizer(opt_cfg, den, MA_LR), T,
                                               with_ema=False)
            step = make_train_step(model, ClipGradNorm(0, 5000, 0.5), ddp=den, mesh=mesh)
            build_s = time.perf_counter() - t_build
            den.axis.reset_counts()
            state, m, first_s = _sync_step(step, state, batch, draws, dev)
            counts = dict(den.axis.counts)
            rep = [n for n, _ in den.named_parameters() if n not in den.split_dims]
            params = dict(den.named_parameters())
            rep_grads_same = same_across(torch.cat([params[n].grad.reshape(-1) for n in rep]),
                                          mesh.model_group)
            rep_same = same_across(torch.cat([params[n].detach().reshape(-1) for n in rep]),
                                    mesh.model_group)
            loss_same = same_across(m.loss.reshape(1), mesh.model_group)
            grads = den.full_grads()
            weights = {k: v.clone() for k, v in den.full_state_dict().items()}
            tp = dict(loss=float(m.loss), norm=float(m.grad_norm), t=m.t.cpu(),
                      count=state.lt.Lt_count.cpu(), hist=state.lt.Lt_history.cpu())
            tp_times = [first_s]
            for _ in range(MA_STEPS):
                state, _, s = _sync_step(step, state, batch, draws, dev)
                tp_times.append(s)
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
            del state, step, den
            if dev.type == "cuda":
                torch.cuda.empty_cache()

            if rank == 0:
                whole = model.transformer          # the weights the split began from
                ref = DiffusionTrainState.create(whole, build_optimizer(opt_cfg, whole, MA_LR),
                                                 T, with_ema=False)
                ref_step = make_train_step(model, ClipGradNorm(0, 5000, 0.5))
                ref, rm, one_first = _sync_step(ref_step, ref, batch, draws, dev)
                g_max = max(float(p.grad.abs().max()) for p in whole.parameters())
                grad_err = max(float((grads[n] - p.grad).abs().max())
                               for n, p in whole.named_parameters()) / g_max
                w_err = w_tiny = 0.0
                for n, p in whole.named_parameters():
                    d = (weights[n] - p.detach()).abs()
                    tiny_g = p.grad.abs() < 1e-5 * g_max
                    w_err = max(w_err, float(torch.where(tiny_g, 0.0, d).max()))
                    w_tiny = max(w_tiny, float(d.max()))
                res = dict(
                    loss=(tp["loss"], float(rm.loss)), norm=(tp["norm"], float(rm.grad_norm)),
                    grad_err=grad_err, w_err=w_err, w_tiny=w_tiny,
                    t_same=bool(torch.equal(tp["t"], rm.t.cpu())),
                    count_same=bool(torch.equal(tp["count"], ref.lt.Lt_count.cpu())),
                    count_sum=int(tp["count"].sum()),
                    hist_rel=float((tp["hist"] - ref.lt.Lt_history.cpu()).abs().max()
                                   / ref.lt.Lt_history.abs().max().cpu()),
                    rep_grads_same=rep_grads_same, rep_same=rep_same, loss_same=loss_same,
                    counts=counts, n_local=n_local,
                    n_whole=sum(p.numel() for p in whole.parameters()), build_s=build_s,
                    tp_times=tp_times, peak_gib=peak / 2 ** 30)
                one_times = [one_first]
                for _ in range(MA_STEPS):
                    ref, _, s = _sync_step(ref_step, ref, batch, draws, dev)
                    one_times.append(s)
                res["one_times"] = one_times
                queue.put({"rank": 0, "result": res})
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:      # noqa: BLE001 - reported to the parent, which fails the phase
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def phase_model_axis(dev, tiny: bool = False) -> dict:
    """Phase 10g (module docstring): the flagship's Stage-2 step at a model
    axis of 2, two gloo processes on one card, against one process. Returns
    its numbers and "seconds". ``tiny``: the dry run's small denoiser (a
    rehearsal on the CPU with ``dev`` the CPU)."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = _free_port()
    procs = [ctx.Process(target=_model_axis_rank, args=(r, port, dev.type, tiny, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    msgs, deadline = [], time.monotonic() + MA_TIMEOUT
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        for p in procs:
            p.join(timeout=1)
        while not queue.empty():
            msgs.append(queue.get())
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    while not queue.empty():
        msgs.append(queue.get())
    errors = [m["error"] for m in msgs if "error" in m]
    check(not errors and all(p.exitcode == 0 for p in procs),
          f"model axis: exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errors))
    res = next(m["result"] for m in msgs if "result" in m)
    (tp_loss, one_loss), (tp_norm, one_norm) = res["loss"], res["norm"]
    loss_rel, norm_rel = abs(tp_loss - one_loss) / abs(one_loss), abs(tp_norm - one_norm) / one_norm
    check(loss_rel <= 1e-5 and norm_rel <= 1e-5,
          f"model axis: loss {tp_loss!r} vs {one_loss!r}, grad norm {tp_norm!r} vs {one_norm!r}")
    check(res["grad_err"] <= 1e-5,
          f"model axis: gradients {res['grad_err']:.3g} of the largest off")
    check(res["w_err"] <= 1e-6 and res["w_tiny"] <= 2 * MA_LR,
          f"model axis: weights {res['w_err']:.3g} off (near-zero gradients {res['w_tiny']:.3g})")
    check(res["t_same"] and res["count_same"] and res["count_sum"] == MA_BATCH
          and res["hist_rel"] <= 1e-4,
          f"model axis: the timestep state differs (sum {res['count_sum']}, "
          f"history {res['hist_rel']:.3g} of its largest)")
    check(res["rep_grads_same"] and res["rep_same"] and res["loss_same"],
          "model axis: the two ranks' replicated gradients, weights or losses differ")
    c = res["counts"]
    res["seconds"] = time.perf_counter() - t_phase
    tp_med, one_med = float(np.median(res["tp_times"][1:])), float(np.median(res["one_times"][1:]))
    res.update(tp_s=tp_med, one_s=one_med)
    what = "the dry run's small" if tiny else "the flagship"
    print(f"  (a) {what} Text2SpecTransformer's Stage-2 step (f32, TF32 off, batch {MA_BATCH}, "
          f"AdamW lr {MA_LR}, the OR-ed clip) at a model axis of 2, two gloo processes on one "
          f"card ({res['n_local'] / 1e6:.1f} M of {res['n_whole'] / 1e6:.1f} M parameters a "
          f"rank), against one process on the same weights, batch and draws: loss rel "
          f"{loss_rel:.3g}, grad norm rel {norm_rel:.3g}, gradients {res['grad_err']:.3g} of the "
          f"largest, weights {res['w_err']:.3g} ({res['w_tiny']:.3g} where a gradient is within "
          f"1e-5 of the largest of 0), t and Lt_count equal (sum {res['count_sum']}); the ranks' "
          f"replicated gradients and weights bit for bit equal")
    print(f"  (b) step times, median of {MA_STEPS} after the first: model axis 2 "
          f"{tp_med:.4f} s (first {res['tp_times'][0]:.3f} s), one process {one_med:.4f} s "
          f"(first {res['one_times'][0]:.3f} s), {tp_med / one_med:.2f} x; per step over the "
          f"model group: {c['all_reduce']} all-reduces, {c['all_reduce_bytes'] / 2 ** 20:.1f} MiB "
          f"a rank, {c['all_gather']} all-gathers, {c['all_gather_bytes'] / 2 ** 20:.1f} MiB; "
          f"a rank's peak memory {res['peak_gib']:.2f} GiB; ranks built in {res['build_s']:.1f} s; "
          f"phase 10g {res['seconds']:.1f} s")
    return res


def _bound(nbytes, **ops):
    """(least ms, what bounds it) for ``nbytes`` moved and ``ops`` operations
    by type. The tensor cores (int8 and bf16 dots, one after the other) and
    the f32 pipe run at the same time as the memory, so the bound is the
    largest of the three times."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_mma = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items() if kind != "f32")
    t_ops = max(t_mma, ops.get("f32", 0) / PEAK_OPS_PER_S["f32"])
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _mean_bound(*bounds):
    """The bound of a time averaged over several calls: their mean, bounded
    by what bounds the largest."""
    return sum(b[0] for b in bounds) / len(bounds), max(bounds)[1]


def _sum_bound(*bounds):
    """The bound of a time summed over several calls: their sum, bounded by
    what bounds the largest."""
    return sum(b[0] for b in bounds), max(bounds)[1]


def kernel_bounds():
    """Each kernel's bound at the shapes its time was taken at (phases 3 and
    4): K1 bf16 logits; K3-K5 W4 static; K6-K9 W8 dynamic; K6 multi over a
    layer's six sites, K7, K10 and the pair MHA over the self and the cross
    attention; K11 summed over the decoder's five stages (x and y in bf16,
    the f32 kernel, gamma, beta and bias read once); T1 int8 -> int32 at the
    fc1 shape; T2
    ``dots_only`` (x, two W8 weights and y; its two int8 dots) and T3
    ``qkvp_dots_only`` (x, four W8 weights and y; its four int8 dots, the
    AdaLN and quantize passes) at their tools' shapes."""
    from text_to_sound_synthesis_torch.tools import bench_attn_ablate as t3
    from text_to_sound_synthesis_torch.tools import bench_gn_conv as gnt
    from text_to_sound_synthesis_torch.tools import bench_kernel_dot as dt
    from text_to_sound_synthesis_torch.tools import bench_mlp_ablate as t2

    B, L, S, D, F, H, C = BATCH, L_TOK, S_COND, D_MODEL, D_MLP, N_HEAD, 256
    M, Ms, hd = B * L, B * S, D // H
    act = lambda rows, width: 2 * rows * width               # bf16 activations
    w8 = lambda n, k: n * k + 8 * n                           # int8, f32 scale and bias
    w4 = lambda n, k: n * k // 2 + 8 * n                      # nibble-packed int4
    norm = 8 * M * D                                          # LayerNorm + quantize, f32
    sampler = M * (C + 1) * SAMPLER_OPS
    mma = lambda keys: 4 * B * H * L * keys * hd              # Q K^T and P V
    soft = lambda keys: 5 * B * H * L * keys                  # f32 softmax
    mlp = lambda w: _bound(2 * act(M, D) + 8 * D + w(F, D) + w(D, F), int8=4 * M * D * F,
                           f32=norm + 8 * M * F + 4 * M * D)
    dense = lambda nbytes, n, k, f32: _bound(nbytes, int8=2 * M * n * k, f32=f32)
    mha = lambda keys, kind, extra: _bound(2 * act(M, D) + 2 * act(B * keys, D),
                                           **{kind: mma(keys)}, f32=soft(keys) + extra(keys))
    gn_stage = lambda h, w, c: _bound(2 * act(gnt.B * h * w, c) + 4 * (9 * c * c + 3 * c),
                                      bf16=18 * gnt.B * h * w * c * c,
                                      f32=GN_F32_OPS * gnt.B * h * w * c)
    M2, M3 = t2.M, t3.M
    return {
        "mlp_variant": _bound(2 * act(M2, t2.D) + w8(t2.DH, t2.D) + w8(t2.D, t2.DH),
                              int8=4 * M2 * t2.D * t2.DH),
        "attn_variant": _bound(2 * act(M3, t3.D) + 8 * t3.D + 4 * w8(t3.D, t3.D),
                               int8=8 * M3 * t3.D * t3.D, f32=2 * 8 * M3 * t3.D + 8 * M3 * t3.D),
        "gn_swish_conv": _sum_bound(*(gn_stage(*shape) for shape in gnt.SHAPES)),
        "make_pallas_dot": _bound(dt.M * dt.K + dt.K * dt.N + 4 * dt.M * dt.N,
                                  int8=2 * dt.M * dt.K * dt.N),
        "fused_p_sample": _bound(act(M, C) + 8 * M, f32=sampler),
        "fused_head_sample": _bound(act(M, D) + 8 * D + 2 * D * C + 4 * C + 8 * M,
                                    bf16=2 * M * D * C, f32=norm + sampler),
        "mlp_block": mlp(w4),
        "self_attn_block": _bound(2 * act(M, D) + 8 * D + 4 * w4(D, D), int8=8 * M * D * D,
                                  bf16=mma(L), f32=norm + soft(L) + 4 * M * D),
        "cross_attn_block": _bound(2 * act(M, D) + 8 * D + 2 * act(Ms, D) + 2 * w4(D, D),
                                   int8=4 * M * D * D, bf16=mma(S), f32=norm + soft(S) + 4 * M * D),
        "fused_quant_dense": dense(act(M, D) + 8 * D + w8(F, D) + act(M, F), F, D,
                                   norm + 8 * M * F),
        "fused_quant_dense_multi": _mean_bound(
            _bound(4 * act(M, D) + 8 * D + 3 * w8(D, D), int8=6 * M * D * D, f32=norm + 6 * M * D),
            dense(3 * act(M, D) + w8(D, D), D, D, 4 * M * D),
            dense(2 * act(M, D) + 8 * D + w8(D, D), D, D, norm + 2 * M * D),
            dense(3 * act(M, D) + w8(D, D), D, D, 4 * M * D),
            dense(act(M, D) + 8 * D + w8(F, D) + act(M, F), F, D, norm + 8 * M * F),
            dense(act(M, F) + w8(D, F) + 2 * act(M, D), D, F, 4 * M * F + 4 * M * D)),
        "fused_mha": _mean_bound(mha(L, "bf16", lambda k: 0), mha(S, "bf16", lambda k: 0)),
        # the pair MHA: K7's bytes and products (the second Q K^T of head B is
        # the kernel's choice, not the function's work)
        "mha_pair": _mean_bound(mha(L, "bf16", lambda k: 0), mha(S, "bf16", lambda k: 0)),
        # the quantize pass, AdaLN, static: x in, int8 out, the LayerNorm and quantize
        "quantize_rows": _bound(act(M, D) + 8 * D + M * D, f32=norm),
        # the wide pass at K9's middle: f32 rows and 4 maxima a row in, int8
        # out; a divide, a round and a max per value (3 f32 operations)
        "quantize_wide": _bound(4 * M * F + 16 * M + M * F, f32=3 * M * F),
        "attn_pair_block": _bound(2 * act(M, D) + 16 * D + 2 * act(Ms, D) + 6 * w8(D, D),
                                  int8=12 * M * D * D, bf16=mma(L) + mma(S),
                                  f32=2 * norm + soft(L) + soft(S) + 8 * M * D),
        "mlp_block_chunked": mlp(w8),
        "mlp_block_streamed": mlp(w8),
        # K10: the quantize pass (abs-max, divide, round of q, k and v) and
        # P's per-row quantize besides the softmax
        "mha_inline_int8": _mean_bound(
            *(mha(keys, "int8", lambda k: 2 * B * H * L * k + 3 * (M + 2 * B * k) * D)
              for keys in (L, S))),
    }


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
    phase_permuters(dev)

    from text_to_sound_synthesis_torch.utils.cuda_build import find_nvcc

    from text_to_sound_synthesis_torch.ops import fused_gn_conv as gn
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik

    t0 = time.perf_counter()
    loads = {"fused_sampler.cu": fs.load_kernel, "int8_block.cu": ib.load_kernel,
             "int8_probe.cu": ik.load_probe_kernel, "fused_head_sample.cu": fs.load_head_kernel,
             "mha_int8.cu": ik.load_mha_int8, "gn_swish_conv.cu": gn.load_kernel}

    def timed(load):
        t = time.perf_counter()
        load()
        return time.perf_counter() - t

    with ThreadPoolExecutor(len(loads)) as pool:   # one nvcc per source, all at once
        secs = dict(zip(loads, pool.map(timed, loads.values())))
    print(f"[2 build] csrc/{', '.join(f'{k} {v:.1f} s' for k, v in secs.items())} -> sm_90a "
          f"with {find_nvcc()}, in parallel: {time.perf_counter() - t0:.1f} s")

    print("[3 K1 vs plain]")
    max_err, k1_ms, plain_ms = phase_kernel(fs, dd, dev)

    print("[4 K2-K11, T1-T3 vs plain]")
    block_res = phase_blocks(dev)
    quant_res = phase_quant_pass(dev)
    wide_res = phase_wide_pass(dev)
    head_res = phase_head(fs, dd, dev)
    sched_res, k6_launches, library = phase_schedules(dev)
    att_res, library["mha_pair"] = phase_int8_attention(dev)
    gn_res, gn_launches = phase_gn_conv(dev)
    dot_res, dot_launches, library["make_pallas_dot"] = phase_dot(dev)
    (t2_res, t2_launches), (t3_res, t3_launches), library["mlp_variant"] = phase_ablate(dev)

    print("[5 slice]")
    cfg = load_yaml_config(CONFIG)
    cfg["model"]["params"]["dtype"] = "bfloat16"
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    with torch.device(dev):
        gen = MelGANGenerator(input_size=VOC_ARGS["n_mel_channels"], ngf=VOC_ARGS["ngf"],
                              n_residual_layers=VOC_ARGS["n_residual_layers"])
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
    check(bf16_counts == expected_counts(K1=2 * N_STEPS),
          f"bf16 path: launches {bf16_counts}, expected {expected_counts(K1=2 * N_STEPS)}")

    print("[5b one-hot sampler, reconstruction, loaders]")
    ref_s, bench_fused_s = phase_onehot(model, fs, vocoder, cond_tokens, cfg, dev)

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
    check_int8_loop(model, qp, fs, dd, cond_tokens, dev, attn="pair")
    with switches(T2S_ATTN_MHA="base"):
        check_int8_loop(model, qp, fs, dd, cond_tokens, dev)
    int8_generate = lambda g: model.generate_int8(qp, g, cond_tokens, sample_type="top0.85r",
                                                  return_tokens=True)
    torch.cuda.reset_peak_memory_stats()
    int8_times, base_times, int8_counts = [], [], {k: 0 for k in _counters()}
    LN = N_LAYER * N_STEPS
    expect = {mode: expected_counts(K2=N_STEPS, K3=LN, K4=LN, K5=LN, Kp=2 * LN * (mode == "pair"))
              for mode in ("pair", "base")}
    # in turns: the default (the pair MHA) and T2S_ATTN_MHA=base (the bf16 MHA)
    for i, mode in enumerate(("pair", "base", "pair", "base")):
        with switches(**({} if mode == "pair" else dict(T2S_ATTN_MHA="base"))):
            reset_counts()
            (int8_times if mode == "pair" else base_times).append(
                request(int8_generate, vocoder, SEED + i, dev))
            counts = read_counts()
        check(counts == expect[mode], f"serving ({mode} MHA): launches {counts} per request, "
              f"expected {expect[mode]}")
        if mode == "pair":
            int8_counts = {k: int8_counts[k] + v for k, v in counts.items()}
    print(f"  W4A8 static requests of batch {BATCH} x {N_STEPS} steps, in turns: the served default "
          f"(pair MHA) {int8_times[0]:.3f} s, {int8_times[1]:.3f} s; T2S_ATTN_MHA=base (bf16 MHA) "
          f"{base_times[0]:.3f} s, {base_times[1]:.3f} s; launches per request {expect['pair']}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print("[7 W8 serving]")
    w8_times, w8_counts, qp8 = phase_w8(model, fs, dd, vocoder, cond_tokens, dev)

    print("[8 int8 attention serving]")
    att_times, att_counts = phase_attention_serving(model, qp, qp8, fs, dd, vocoder, cond_tokens,
                                                    dev)

    print("[9 long-form]")
    long_seconds = phase_long(model, qp, vocoder, cond_tokens, dev)

    print("[10 train]")
    step_s, samples_s, train_peak, n_train = phase_train(model, qp, cond_tokens, dev)

    print("[10b Stage-1 and vocoder training, the bf16 Stage-2 step]")
    s1_times, voc_times, bf16_times = phase_stage1(dev)

    print("[10c evaluation: Melception, evaluate_folders, the ACT captioner, Griffin-Lim, "
          "the int8 drift gate]")
    ev = phase_eval(model, cond_tokens, dev)

    print("[10d the AR baseline (request, train step) and the class-conditional and "
          "unconditional denoisers]")
    ar_times, ar_train_s = phase_ar(vocoder, dev)

    print("[10e the entry points: the tokenizer, the generate CLI, the HTTP server, bench_serve]")
    serve_res = phase_entry(vocoder, dev)

    print("[10f the long tail: the AR baseline in bf16, train_ar over a group, activation "
          "checkpointing, classifier training, the CLIP vision tower, vis_codebook, the parity "
          "gate, the dry run]")
    tail = phase_tail(model, vocoder, dev)

    print("[10g the Megatron model axis: the flagship Stage-2 step over two gloo processes on "
          "the card, against one process]")
    axis = phase_model_axis(dev)

    print(f"[11 times] on {card}:")
    print(f"  K1 at (2120, 256): {k1_ms:.4f} ms, plain PyTorch step {plain_ms:.4f} ms")
    print(f"  bench.py's scope (sampler + decode_code, batch {BATCH}, {N_STEPS} steps): the f32 "
          f"one-hot reference sampler {min(ref_s):.3f} s = {BATCH / min(ref_s):.3f} clips/s, the bf16 "
          f"fused path {min(bench_fused_s):.3f} s = {BATCH / min(bench_fused_s):.3f} clips/s "
          f"(faster of two each)")
    print(f"  bf16 path, second request (caption ids -> wav, batch {BATCH}, {N_STEPS} steps): "
          f"{times[1]:.3f} s = {BATCH / times[1]:.3f} clips/s")
    print(f"  W4A8 static path, second request (caption ids -> wav, batch {BATCH}, {N_STEPS} "
          f"steps): {int8_times[1]:.3f} s = {BATCH / int8_times[1]:.3f} clips/s; under "
          f"T2S_ATTN_MHA=base {base_times[1]:.3f} s ({int8_times[1] / base_times[1]:.3f} x, "
          f"the pair MHA over the bf16 MHA)")
    best = {p: min(t) for p, t in w8_times.items()}
    for path, t in best.items():
        print(f"  W8 dynamic {path} path, faster of its requests (caption ids -> wav, batch "
              f"{BATCH}, {N_STEPS} steps): {t:.3f} s = {BATCH / t:.3f} clips/s, "
              f"{t / best['blocks']:.3f} x the block path")
    w4_att = min(att_times["W4A8 static"])
    print(f"  W4A8 static path with the int8 MHA, faster of its requests: {w4_att:.3f} s = "
          f"{BATCH / w4_att:.3f} clips/s, {w4_att / int8_times[1]:.3f} x the W4A8 request")
    w8_att = att_times["W8 dynamic pair"][0]
    print(f"  W8 dynamic pair path with the int8 MHA: {w8_att:.3f} s = {BATCH / w8_att:.3f} "
          f"clips/s, {w8_att / best['blocks']:.3f} x the W8 block path")
    print(f"  W4A8 generate_long, batch {BATCH}, {LONG_FRAMES} frames: {long_seconds:.3f} s = "
          f"{BATCH / long_seconds:.3f} long clips/s, {long_seconds / int8_times[1]:.3f} x the "
          f"W4A8 request")
    print(f"  Stage-2 train step, flagship f32 ({n_train / 1e6:.1f} M trainable), batch "
          f"{TRAIN_BATCH}: median {step_s:.4f} s = {samples_s:.2f} samples/s; peak memory "
          f"{train_peak:.2f} GiB")
    print(f"  Stage-2 train step, flagship bf16 compute (f32 parameters), batch {TRAIN_BATCH}: "
          f"median {bf16_times[0]:.4f} s = {bf16_times[1]:.2f} samples/s, "
          f"{bf16_times[0] / step_s:.3f} x the f32 step; peak memory {bf16_times[2]:.2f} GiB")
    print(f"  Stage-1 SpecVQGAN step (vqgan_caps, LPAPS, both optimizers), batch 8: median "
          f"{s1_times[0]:.4f} s = {s1_times[1]:.2f} samples/s; peak memory {s1_times[2]:.2f} GiB")
    print(f"  MelGAN step, batch 16 x 8192 samples: median {voc_times[0]:.4f} s = "
          f"{voc_times[1]:.2f} samples/s; peak memory {voc_times[2]:.2f} GiB")
    print(f"  evaluation: Melception at batch {EVAL_MELS} of {MEL[0]} x {MEL[1]} (full f32) "
          f"{ev['melception_ms']:.2f} ms; ACT beam {CAPTION_BEAM} over {CAPTION_MELS} mels "
          f"{ev['caption_s']:.2f} s; griffin_lim {GL_ITERS} steps {1e3 * ev['gl_s']:.1f} ms; the "
          f"drift gate (40 train steps, 3 x {DRIFT_CLIPS} clips, W4A8 static) {ev['drift_s']:.1f} s, "
          f"drift_ratio {ev['drift']['drift_ratio']!r}; with the int8 MHA (K10) "
          f"{ev['drift_k10_s']:.1f} s, drift_ratio {ev['drift_k10']['drift_ratio']!r}; phase 10c "
          f"{ev['seconds']:.1f} s")
    print(f"  AR baseline (ar_audiocaps.yaml: GPTFeats 19 x d1024, f32), second request "
          f"(features -> 265 tokens, top-k {AR_TOP_K} -> decode_code -> MelGAN, batch {BATCH}): "
          f"{ar_times[1]:.3f} s = {BATCH / ar_times[1]:.3f} clips/s; its train step, batch "
          f"{BATCH} of {MEL[0]} x {MEL[1]} (the codec frozen): second {ar_train_s[1]:.4f} s = "
          f"{BATCH / ar_train_s[1]:.2f} samples/s")
    for label, b in (("with 2 wav requests beside", serve_res["with_wavs"]),
                     ("mel requests only", serve_res["mel_only"])):
        print(f"  the HTTP server, W4A8 static, batch {BATCH}, {N_STEPS} steps, a burst of "
              f"{SERVE_BURST} mel requests from {SERVE_CLIENTS} clients, {label}: "
              f"{b['clips_per_s']:.3f} clips/s, p50 {b['p50_s']:.3f} s, p95 {b['p95_s']:.3f} s")
    print(f"  phase 10e (the entry points): {serve_res['seconds']:.1f} s")
    for k in ("f32", "bf16"):
        wall, dev_ms, idle = tail["ar"][k]
        print(f"  AR baseline request in {k} compute (batch {BATCH}, features -> wav): {wall:.3f} s "
              f"= {BATCH / wall:.3f} clips/s, device {dev_ms:.1f} ms, idle share {idle:.3f}")
    (s0, g0), (s1, g1) = tail["remat"]["plain"], tail["remat"]["checkpoint"]
    print(f"  Stage-2 flagship step, f32, batch {TRAIN_BATCH}: {s0:.4f} s, {g0:.2f} GiB peak; with "
          f"activation checkpointing {s1:.4f} s ({s1 / s0:.3f} x), {g1:.2f} GiB peak")
    print(f"  classifier steps (batch {CLS_BATCH} of {MEL[0]} x {MEL[1]}, full f32): "
          + "; ".join(f"{k} {v:.4f} s" for k, v in tail["classifier"].items())
          + f"; ViT-B/32 batch {VIT_BATCH} at 224 px: {tail['vit_ms']:.3f} ms")
    print(f"  run_parity_gate smoke: bf16 {tail['gate']['bf16']:.1f} s, --int8 "
          f"{tail['gate']['int8']:.1f} s; dryrun_multichip(1) {tail['dryrun_s']:.1f} s; phase "
          f"10f {tail['seconds']:.1f} s")
    print(f"  Stage-2 flagship step, f32 (TF32 off), batch {MA_BATCH}: at a model axis of 2 (two "
          f"gloo processes on one card) {axis['tp_s']:.4f} s, one process {axis['one_s']:.4f} s "
          f"(medians of {MA_STEPS}); phase 10g {axis['seconds']:.1f} s")
    print(f"  K11 over the decoder's five stages (no request path): {gn_res[1]:.4f} ms, plain "
          f"twin {gn_res[2]:.4f} ms; T1 int8 -> int32 at 2176x1024x4096: {dot_res[1]:.4f} ms, "
          f"torch._int_mm {library['make_pallas_dot']:.4f} ms")
    print(f"  T2 dots_only (K3's two GEMMs alone): {t2_res[1]:.4f} ms, K3 {block_res['mlp_block'][1]:.4f}"
          f" ms; T3 qkvp_dots_only (K4's four GEMMs alone): {t3_res[1]:.4f} ms, K4 "
          f"{block_res['self_attn_block'][1]:.4f} ms; torch._int_mm at fc1 + fc2 "
          f"{library['mlp_variant']:.4f} ms")
    tpu = "text_to_sound_synthesis_tpu/ops/"
    src = "text_to_sound_synthesis_torch/csrc/"
    rows = [("fused_p_sample", "fused_sampler.cu", tpu + "fused_sampler.py:223",
             bf16_counts["K1"], (max_err, k1_ms, plain_ms)),
            ("fused_head_sample", "fused_head_sample.cu", tpu + "fused_sampler.py:300",
             int8_counts["K2"], head_res),
            ("mlp_block", "int8_block.cu", tpu + "int8_block.py:609", int8_counts["K3"],
             block_res["mlp_block"]),
            ("self_attn_block", "int8_block.cu", tpu + "int8_block.py:375", int8_counts["K4"],
             block_res["self_attn_block"]),
            ("cross_attn_block", "int8_block.cu", tpu + "int8_block.py:455", int8_counts["K5"],
             block_res["cross_attn_block"]),
            ("fused_quant_dense", "int8_block.cu", tpu + "quant.py:170", k6_launches,
             sched_res["fused_quant_dense"]),
            ("fused_quant_dense_multi", "int8_block.cu", tpu + "quant.py:260", w8_counts["K6m"],
             sched_res["fused_quant_dense_multi"]),
            ("quantize_rows", "int8_quant.cuh", tpu + "int8_block.py:375", int8_counts["Kq"],
             quant_res),
            ("quantize_wide", "int8_quant.cuh", tpu + "int8_block.py:687", w8_counts["Kw"],
             wide_res),
            ("fused_mha", "mha_sm90.cuh", tpu + "attention.py:56", w8_counts["K7"],
             sched_res["fused_mha"]),
            ("attn_pair_block", "int8_block.cu", tpu + "int8_block.py:530", w8_counts["K8"],
             sched_res["attn_pair_block"]),
            ("mlp_block_chunked", "int8_block.cu", tpu + "int8_block.py:687", w8_counts["K9c"],
             sched_res["mlp_block_chunked"]),
            ("mlp_block_streamed", "int8_block.cu", tpu + "int8_block.py:770", w8_counts["K9s"],
             sched_res["mlp_block_streamed"]),
            ("mha_inline_int8", "mha_int8.cu", tpu + "int8_block.py:128", att_counts["K10"],
             att_res["mha_inline_int8"]),
            ("mha_pair", "mha_sm90.cuh", tpu + "int8_block.py:244", int8_counts["Kp"],
             att_res["mha pair"]),
            # K11 and T1-T3 run on no request path: their launches are their tools' runs
            ("gn_swish_conv", "gn_swish_conv.cu", tpu + "fused_gn_conv.py:289", gn_launches,
             gn_res),
            ("make_pallas_dot", "int8_probe.cu", "tools/bench_kernel_dot.py:34", dot_launches,
             dot_res),
            ("mlp_variant", "int8_probe.cu", "tools/bench_mlp_ablate.py:37", t2_launches, t2_res),
            ("attn_variant", "int8_probe.cu", "tools/bench_attn_ablate.py:35", t3_launches, t3_res)]
    check(all(launches > 0 for _, _, _, launches, _ in rows), "a kernel was never launched")
    bounds = kernel_bounds()
    print(json.dumps({"kernels": [
        {"name": fn, "route": "cuda", "source": src + source, "replaces": replaces,
         "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": pms,
         "bound_ms": bounds[fn][0], "bound_by": bounds[fn][1], "library_ms": library.get(fn)}
        for fn, source, replaces, launches, (err, ms, pms) in rows]}))
    check_drift_gate(ev["drift"])
    check_drift_gate(ev["drift_k10"], "(f)")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
