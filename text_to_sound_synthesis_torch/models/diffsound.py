"""Diffsound composite: frozen spec codec + text codec + diffusion generator.

Port of ``text_to_sound_synthesis_tpu/models/diffsound.py`` (reference
``DALLE``, ``Diffsound/sound_synthesis/modeling/models/dalle_spec.py``) for the
bf16 generation path: caption BPE ids -> CLIP text tower -> index-carrying
reverse sampler (fused sampler kernel per step) -> VQGAN ``decode_code``; and
for the int8 serving path: ``quantize_for_serving`` -> ``calibrate_serving_engine``
-> ``generate_int8`` (``models/diffusion/int8_runtime.py``); and long-form
generation on either, ``generate_long``.

Unlike the JAX package's plain object over three parameter trees, this is one
``nn.Module`` laid out as the reference's ``DALLE``: ``content_codec`` (VQModel),
``transformer`` (DiscreteDiffusion, holding ``condition_emb`` = the CLIP tower
and ``transformer`` = the denoiser). The JAX package's names ``codec``,
``cond`` and ``diffusion`` are properties onto those children.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn

from ..ops import permuter as permuter_ops
from ..utils.config import instantiate_from_config, register
from ..utils.init import init_random_
from .clip.text_model import CLIPTextEmbedding
from .clip.tokenize import Tokenize
from .diffusion.process import DiscreteDiffusion, sample_tokens_fused
from .vqgan.model import VQModel

__all__ = ["Diffsound", "build_model", "crossfade", "parse_sample_type"]


def parse_sample_type(sample_type: str):
    """'top0.85r[,fastN][,qR]' -> (truncation_r, top_k, skip_step, resample_q),
    the reference's string protocol (generate_samples_batch.py:143,
    dalle_spec.py:205-223). The JAX package returns a filter function in
    place of (truncation_r, top_k)."""
    parts = sample_type.split(",") if sample_type else [""]
    head = parts[0]
    truncation_r, top_k = 0.0, 0
    if head.startswith("top"):
        if head.endswith("r"):
            truncation_r = float(head[3:-1])
        elif head.endswith("p"):
            top_k = int(head[3:-1])
        else:
            raise ValueError(f"bad sample_type head: {head!r}")
    skip_step, resample_q = 0, 0.0
    for p in parts[1:]:
        if p.startswith("fast"):
            skip_step = int(p[4:])
        elif p.startswith("q"):
            resample_q = float(p[1:])
    return truncation_r, top_k, skip_step, resample_q


@register(
    "text_to_sound_synthesis_tpu.models.Diffsound",
    "sound_synthesis.modeling.models.dalle_spec.DALLE",
)
class Diffsound(nn.Module):
    def __init__(
        self,
        *,
        content_codec_config: Mapping[str, Any],
        condition_codec_config: Mapping[str, Any],
        diffusion_config: Mapping[str, Any],
        first_stage_permuter_config: Optional[Mapping[str, Any]] = None,
        content_info: Mapping[str, Any] = {"key": "image"},
        condition_info: Mapping[str, Any] = {"key": "text"},
        dtype: Any = torch.float32,
    ):
        super().__init__()
        if isinstance(dtype, str):  # config files say e.g. dtype: bfloat16
            dtype = getattr(torch, dtype)
        if not isinstance(dtype, torch.dtype):
            raise TypeError(f"dtype must name a torch dtype, got {dtype!r}")
        self.dtype = dtype
        self.content_info = dict(content_info)
        self.condition_info = dict(condition_info)
        if (content_codec_config.get("params") or {}).get("ckpt_path"):
            raise NotImplementedError(
                "loading the stage-1 codec checkpoint waits for the checkpoint "
                "loaders (ROADMAP, port queue); load weights with convert.from_jax")
        self.content_codec: VQModel = instantiate_from_config(content_codec_config)
        self.condition_codec: Tokenize = instantiate_from_config(condition_codec_config)
        self.transformer: DiscreteDiffusion = instantiate_from_config(diffusion_config)
        self.permuter = (instantiate_from_config(first_stage_permuter_config)
                         if first_stage_permuter_config else permuter_ops.Identity())
        H, W = self.transformer._emb_params().get("spatial_size", (5, 53))
        self.token_hw = (int(H), int(W))
        self.to(dtype)

    # the JAX package's names for the three parts
    @property
    def codec(self) -> VQModel:
        return self.content_codec

    @property
    def cond(self) -> Optional[CLIPTextEmbedding]:
        return self.transformer.condition_emb

    @property
    def diffusion(self) -> DiscreteDiffusion:
        return self.transformer

    @property
    def text_codec(self) -> Tokenize:
        return self.condition_codec

    def init_params(self, generator: torch.Generator) -> "Diffsound":
        """Seeded random init of every parameter, in place, on its device."""
        init_random_(self, generator)
        return self

    # -- tokenization and the three stages ----------------------------------

    def text_to_tokens(self, texts: Sequence[str]) -> dict:
        """Host-side BPE: captions -> {'token': (B, 77) int32, 'mask': ...}
        (numpy). Needs the CLIP BPE merge table."""
        return self.condition_codec.get_tokens(texts)

    @torch.no_grad()
    def embed_condition(self, cond_tokens: torch.Tensor) -> torch.Tensor:
        """(B, 77) BPE ids -> frozen CLIP features (B, 77, 512)."""
        return self.cond(cond_tokens)

    @torch.no_grad()
    def encode_content(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, H, W, 1) in [-1, 1] -> (B, L) permuted token ids."""
        grid = self.content_codec.encode_indices(mel.to(self.dtype))
        return self.permuter(grid.reshape(grid.shape[0], -1))

    @torch.no_grad()
    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, L) permuted token ids -> mel (B, H, W, 1) in [-1, 1]."""
        H, W = self.token_hw
        grid = self.permuter(tokens, reverse=True).reshape(-1, H, W)
        return self.content_codec.decode_code(grid)

    @torch.no_grad()
    def generate(
        self,
        generator: torch.Generator,
        cond_tokens: torch.Tensor,
        *,
        sample_type: str = "top0.85r",
        filter_ratio: float = 0.0,
        content_tokens: Optional[torch.Tensor] = None,
        return_tokens: bool = False,
        noise: Optional[torch.Tensor] = None,
    ):
        """BPE ids (B, 77) -> mel (B, H, W, 1) in [-1, 1] (DALLE.generate_content).

        Always the index-carrying sampler with the fused step kernel; covers
        'top<r>r' and no-truncation heads with optional ',fast<k>'. ``noise``
        (n_steps, B, L, K) supplies the Gumbel noise in place of the kernel's
        Philox draws (tests and checks)."""
        truncation_r, top_k, skip_step, resample_q = parse_sample_type(sample_type)
        if top_k:
            raise NotImplementedError(
                "top-k ('top<k>p') sampling waits for the one-hot sample_tokens "
                "port (ROADMAP, port queue)")
        if resample_q:
            raise NotImplementedError(
                "the 'q<rate>' resample wrapper waits for the one-hot sample_tokens "
                "port (ROADMAP, port queue)")
        cond_emb = self.embed_condition(cond_tokens)
        tokens = sample_tokens_fused(
            self.transformer, cond_emb, generator=generator, truncation_r=truncation_r,
            skip_step=skip_step, content_tokens=content_tokens, filter_ratio=filter_ratio,
            noise=noise)
        mel = self.decode_tokens(tokens)
        if return_tokens:
            return mel, tokens
        return mel

    # -- int8 serving mode ----------------------------------------------------

    def quantize_for_serving(self, *, weight_bits: int = 8):
        """The denoiser -> int8 serving engine (``weight_bits=4``: W4A8,
        nibble-packed weights), on the model's device. The codec and the
        text tower stay as they are."""
        from .diffusion.int8_runtime import quantize_denoiser

        tcfg = (self.diffusion.transformer_config or {}).get("params", {})
        return quantize_denoiser(self.diffusion, n_head=int(tcfg.get("n_head", 16)),
                                 seq_len=self.diffusion.content_seq_len,
                                 num_timesteps=self.diffusion.diffusion_step,
                                 weight_bits=weight_bits)

    @staticmethod
    def _int8_sample_type(sample_type: str):
        """(truncation_r, skip_step) of a top-r sample type; raises for the
        rest, as the JAX package does."""
        head = sample_type.split(",")[0]
        if not (head.startswith("top") and head.endswith("r")):
            raise ValueError(
                f"int8 serving supports top-r truncation sampling, got {sample_type!r}")
        r, _, skip_step, resample_q = parse_sample_type(sample_type)
        if resample_q:
            raise ValueError("int8 serving does not support q-resample wrappers")
        return r, skip_step

    @torch.no_grad()
    def calibrate_serving_engine(self, qp, generator: torch.Generator,
                                 cond_tokens: torch.Tensor, *, sample_type: str = "top0.85r",
                                 margin: float = 1.0):
        """Static-scale calibration: run the dynamic engine's sampler on
        ``cond_tokens`` (representative captions), record the per-site maxima
        and set the engine's ``act_scales`` (in place; returns the engine).
        A W4 engine is calibrated on its unpacked twin."""
        from .diffusion.calibrate import calibrate_act_scales

        r, skip_step = self._int8_sample_type(sample_type)
        cond_emb = self.embed_condition(cond_tokens)
        qp.act_scales = calibrate_act_scales(
            qp, self.diffusion.schedule(cond_emb.device), cond_emb, generator=generator,
            truncation_r=r, skip_step=skip_step, margin=margin)
        return qp

    @torch.no_grad()
    def generate_int8(self, qp, generator: torch.Generator, cond_tokens: torch.Tensor, *,
                      sample_type: str = "top0.85r", impl: Optional[str] = None,
                      return_tokens: bool = False, noise: Optional[torch.Tensor] = None):
        """``generate`` on the int8 serving engine ``qp`` (top-r sampling only):
        BPE ids (B, 77) -> mel (B, H, W, 1). ``impl`` picks the layers' kernel
        path, "pallas" (the block kernels, the default) or "pallas_dense" (the
        per-dense kernels); ``noise`` as in ``generate``."""
        from .diffusion.int8_runtime import sample_tokens_int8

        r, skip_step = self._int8_sample_type(sample_type)
        cond_emb = self.embed_condition(cond_tokens)
        tokens = sample_tokens_int8(qp, self.diffusion.schedule(cond_emb.device), cond_emb,
                                    generator=generator, truncation_r=r, skip_step=skip_step,
                                    noise=noise, impl=impl)
        mel = self.decode_tokens(tokens)
        if return_tokens:
            return mel, tokens
        return mel

    # -- long-form generation -------------------------------------------------

    @property
    def time_downsample(self) -> int:
        """The codec's temporal downsampling (16 for ch_mult [1,1,2,2,4])."""
        return 2 ** (len(self.codec.decoder.up) - 1)

    @torch.no_grad()
    def generate_long(self, generator: torch.Generator, cond_tokens: torch.Tensor, *,
                      duration_frames: int, overlap_frames: int = 160,
                      sample_type: str = "top0.85r", qp=None, impl: Optional[str] = None):
        """Long-form generation beyond the 848-frame window: BPE ids (B, 77) ->
        mel (B, n_mels, duration_frames, 1), each frame a weighted mean of
        the codec's mels for it (in [-1, 1] only as far as the codec's are:
        its decoder ends in a convolution).

        Each caption is repeated ``n`` times, so the ``n`` overlapping
        full-length segments of every caption come from ONE sampler call of
        B * n rows (``generate``, or with ``qp`` the int8 engine's
        ``generate_int8`` on the ``impl`` path); their mels are cross-faded:
        each segment is weighted by linear ramps over its overlaps (the two
        ramps multiply where they meet, when the overlap passes half a
        segment), and the sum is divided by the summed weight."""
        seg = self.time_downsample * self.token_hw[1]
        if not 0 < overlap_frames < seg:
            raise ValueError(f"overlap_frames must be in (0, {seg}), got {overlap_frames}")
        if qp is not None:
            gen = lambda c: self.generate_int8(qp, generator, c, sample_type=sample_type,
                                               impl=impl)
        else:
            gen = lambda c: self.generate(generator, c, sample_type=sample_type)
        if duration_frames <= seg:
            return gen(cond_tokens)[:, :, :duration_frames]
        B = cond_tokens.shape[0]
        hop = seg - overlap_frames
        n = math.ceil((duration_frames - seg) / hop) + 1
        mels = gen(cond_tokens.repeat_interleave(n, dim=0))
        n_mels = mels.shape[1]
        mels = mels.reshape(B, n, n_mels, seg, 1)
        return crossfade(mels, overlap_frames)[:, :, :duration_frames]


def crossfade(mels: torch.Tensor, overlap_frames: int) -> torch.Tensor:
    """(B, n, n_mels, seg, 1) overlapping segments -> (B, n_mels, hop * (n - 1)
    + seg, 1), in the segments' dtype: the JAX ``generate_long`` blend
    (``diffsound.py:393-434``), operation by operation."""
    B, n, n_mels, seg, _ = mels.shape
    hop = seg - overlap_frames
    dt, dev = mels.dtype, mels.device
    ramp = torch.arange(1, overlap_frames + 1, dtype=dt, device=dev) / (overlap_frames + 1)
    up = torch.cat([ramp, torch.ones(seg - overlap_frames, dtype=dt, device=dev)])
    down = up.flip(0)
    out = torch.zeros((B, n_mels, hop * (n - 1) + seg, 1), dtype=dt, device=dev)
    wsum = torch.zeros(hop * (n - 1) + seg, dtype=dt, device=dev)
    for i in range(n):
        w = torch.ones(seg, dtype=dt, device=dev)
        if i > 0:
            w = w * up
        if i < n - 1:
            w = w * down
        sl = slice(i * hop, i * hop + seg)
        out[:, :, sl] = out[:, :, sl] + mels[:, i] * w[None, None, :, None]
        wsum[sl] = wsum[sl] + w
    return out / wsum[None, None, :, None]


def build_model(config: Mapping[str, Any], *, device: Any = "cuda", seed: int = 0) -> Diffsound:
    """``build_model(config['model'])`` of the reference
    (``sound_synthesis/modeling/build.py:4-5``). The modules are made without
    storage, then materialised on ``device`` (the card unless the caller asks
    for another) and initialised there at random from a generator seeded with
    ``seed``. ``device="meta"`` leaves them without storage (shape
    inspection)."""
    with torch.device("meta"):
        model = instantiate_from_config(config.get("model", config))
    model = model.to_empty(device=device)
    if torch.device(device).type != "meta":
        model.init_params(torch.Generator(device).manual_seed(seed))
    return model
