"""Diffsound composite: frozen spec codec + text codec + diffusion generator.

Port of ``text_to_sound_synthesis_tpu/models/diffsound.py`` (reference
``DALLE``, ``Diffsound/sound_synthesis/modeling/models/dalle_spec.py``) for the
generation path: caption BPE ids -> CLIP text tower -> reverse sampler (the
index-carrying one with the fused sampler kernel per step, or the one-hot
reference sampler for top-k and ``q<rate>``) -> VQGAN ``decode_code``; the
int8 serving path: ``quantize_for_serving`` -> ``calibrate_serving_engine``
-> ``generate_int8`` (``models/diffusion/int8_runtime.py``); long-form
generation on either, ``generate_long``; the codec round trip
``reconstruct`` and the training-time ``sample_grid``; the Stage-2 training
loss ``loss`` (the frozen codec and text tower under ``no_grad``, the
denoiser's VLB). ``build_model`` loads the stage-1 codec checkpoint a config
names (``ckpt_path``).

Unlike the JAX package's plain object over three parameter trees, this is one
``nn.Module`` laid out as the reference's ``DALLE``: ``content_codec`` (VQModel),
``transformer`` (DiscreteDiffusion, holding ``condition_emb`` = the CLIP tower
and ``transformer`` = the denoiser). The JAX package's names ``codec``,
``cond`` and ``diffusion`` are properties onto those children.

``dtype`` is the compute dtype, as flax's ``dtype`` is in the JAX package:
the parameters, their gradients, the optimizer's moments and the EMA stay
f32, and each entry point runs its forward on ``dtype`` copies of the
weights it reads (``compute_weights``). The copies are kept: a request
casts only what changed since the last one, and the training loss casts the
denoiser, the one part that takes a gradient, afresh each step, a cast that
autograd carries back to the f32 parameters. With ``bfloat16`` a request
computes what a model stored in bf16 computed before: the same rounded
weights, the same ops. The parts refuse to run on their f32 storage outside
``compute_weights`` (``utils/dtype.py``). A process that only serves may
store the weights in the compute dtype once, ``model.to(model.dtype)``:
then nothing is cast or kept.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from functools import partial
from typing import Any, Iterator, Mapping, Optional, Sequence

import torch
from torch import nn

from ..convert.checkpoint import load_torch_state_dict
from ..ops import permuter as permuter_ops
from ..ops.sampling import truncate_top_k, truncate_top_r
from ..utils.config import instantiate_from_config, register
from ..utils.init import init_random_
from .clip.text_model import CLIPTextEmbedding
from .clip.tokenize import Tokenize
from .diffusion.process import (DiscreteDiffusion, OneHotDraws, sample_tokens,
                                sample_tokens_fused)
from .vqgan.model import VQModel

__all__ = ["Diffsound", "build_model", "crossfade", "parse_sample_type"]


def _computes(*parts: str):
    """Run the method inside ``compute_weights`` over the named children
    (all of the model when none is named)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(self, *args, **kwargs):
            with self.compute_weights(*(getattr(self, p) for p in parts)):
                return fn(self, *args, **kwargs)
        return inner
    return wrap


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
        self.content_info = dict(content_info)
        self.condition_info = dict(condition_info)
        # trained stage-1 weights for the frozen codec (dalle_spec.py:45-49),
        # loaded by build_model after the random init
        self.codec_ckpt_path = (content_codec_config.get("params") or {}).get("ckpt_path")
        self.content_codec: VQModel = instantiate_from_config(content_codec_config)
        self.condition_codec: Tokenize = instantiate_from_config(condition_codec_config)
        self.transformer: DiscreteDiffusion = instantiate_from_config(diffusion_config)
        self.permuter = (instantiate_from_config(first_stage_permuter_config)
                         if first_stage_permuter_config else permuter_ops.Identity())
        H, W = self.transformer._emb_params().get("spatial_size", (5, 53))
        self.token_hw = (int(H), int(W))
        self.dtype = dtype

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self._dtype

    @dtype.setter
    def dtype(self, dtype: torch.dtype) -> None:
        """Set the compute dtype: mark the parts with it, so that they refuse
        to run on weights held in another (``utils/dtype.py``; unmarked in
        f32), and drop the copies kept for the old one."""
        self._dtype = dtype
        self._compute_copies: dict = {}
        for part in (self.content_codec, self.transformer, self.transformer.transformer,
                     self.transformer.condition_emb):
            if part is not None:
                part.compute_dtype = None if dtype == torch.float32 else dtype

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
        """Seeded random init of every parameter, in place, on its device, as
        the JAX package's flax defaults draw them (``utils.init.init_random_``).
        The draws are made in the compute dtype, so a bf16 model holds (in
        f32) the values a model stored in bf16 was given."""
        init_random_(self, generator, draw_dtype=self.dtype)
        return self

    @contextlib.contextmanager
    def compute_weights(self, *parts: Optional[nn.Module]) -> Iterator["Diffsound"]:
        """Within the block, every floating parameter and buffer of ``parts``
        (the whole model when none is given) reads as its copy in the compute
        dtype: the f32 weights rounded to ``dtype``. A tensor that takes a
        gradient, under autograd, is cast afresh and the cast recorded, so
        the gradient reaches the f32 parameter. Any other tensor reads a
        copy kept from an earlier block, made anew only when the tensor
        changed since (its version counter: an optimizer step, an in-place
        write or a load; or its storage: ``.to``), so a request casts
        nothing twice. A write through ``.data`` is not seen: set ``dtype``
        again after one, which drops the copies. Tensors already in ``dtype`` are left
        alone, so the blocks nest. A no-op in f32."""
        swapped = []
        if self.dtype != torch.float32:
            grad, memo = torch.is_grad_enabled(), {}
            for part in (parts or (self,)):
                for m in (part.modules() if part is not None else ()):
                    for store in (m._parameters, m._buffers):
                        for k, t in store.items():
                            if t is None or not t.is_floating_point() or t.dtype == self.dtype:
                                continue
                            if id(t) not in memo:
                                memo[id(t)] = (t.to(self.dtype) if grad and t.requires_grad
                                               else self._kept_copy(t))
                            swapped.append((store, k, t))
                            store[k] = memo[id(t)]
        try:
            yield self
        finally:
            for store, k, t in reversed(swapped):
                store[k] = t

    def _kept_copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in the compute dtype, cast again only when ``t`` changed."""
        stamp = (t._version, t.data_ptr(), t.device)
        kept = self._compute_copies.get(id(t))
        if kept is None or kept[0] is not t or kept[1] != stamp:
            kept = (t, stamp, t.detach().to(self.dtype))
            self._compute_copies[id(t)] = kept
        return kept[2]

    def _load_codec_params(self) -> None:
        """Replace the codec's weights with the trained stage-1 weights at
        ``content_codec_config.params.ckpt_path``: a torch ``.ckpt``, ``.pth``
        or ``.pt`` holding the reference's ``VQModel`` state dict, bare or
        under ``state_dict``. The training wrapper's ``loss.*`` entries are
        dropped; any other missing or unexpected key raises."""
        path = str(self.codec_ckpt_path)
        if os.path.isdir(path) or not path.endswith((".ckpt", ".pth", ".pt")):
            raise ValueError(
                f"codec checkpoint {path!r}: the port reads a torch .ckpt, .pth or .pt; an "
                "orbax tree (the JAX trainers' layout) needs JAX to read and waits for the "
                "training port (ROADMAP, port queue)")
        sd = {k: v for k, v in load_torch_state_dict(path).items() if not k.startswith("loss.")}
        self.content_codec.load_state_dict(sd)

    # -- tokenization and the three stages ----------------------------------

    def text_to_tokens(self, texts: Sequence[str]) -> dict:
        """Host-side BPE: captions -> {'token': (B, 77) int32, 'mask': ...}
        (numpy). Needs the CLIP BPE merge table."""
        return self.condition_codec.get_tokens(texts)

    @torch.no_grad()
    @_computes("cond")
    def embed_condition(self, cond_tokens: torch.Tensor) -> torch.Tensor:
        """(B, 77) BPE ids -> frozen CLIP features (B, 77, 512)."""
        return self.cond(cond_tokens)

    @torch.no_grad()
    @_computes("content_codec")
    def encode_content(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, H, W, 1) in [-1, 1] -> (B, L) permuted token ids."""
        grid = self.content_codec.encode_indices(mel.to(self.dtype))
        return self.permuter(grid.reshape(grid.shape[0], -1))

    @torch.no_grad()
    @_computes("content_codec")
    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, L) permuted token ids -> mel (B, H, W, 1) in [-1, 1]."""
        H, W = self.token_hw
        grid = self.permuter(tokens, reverse=True).reshape(-1, H, W)
        return self.content_codec.decode_code(grid)

    # -- training ------------------------------------------------------------

    def loss(self, mel: torch.Tensor, cond_tokens: torch.Tensor, t: torch.Tensor,
             pt: torch.Tensor, *, generator: Optional[torch.Generator] = None,
             gumbel: Optional[torch.Tensor] = None, is_train: bool = True,
             denoiser: Optional[nn.Module] = None):
        """The Stage-2 training loss (``DALLE.forward``): mel (B, H, W, 1) in
        [-1, 1] -> tokens by the frozen codec, BPE ids (B, 77) -> features
        by the frozen text tower, both under ``no_grad`` (they take no
        gradient), then ``DiscreteDiffusion.train_loss`` (its ``generator``,
        ``gumbel``, ``is_train`` and ``denoiser``). Returns its
        ``DiffusionLossOutput``."""
        tokens = self.encode_content(mel)
        cond_emb = self.embed_condition(cond_tokens)
        with self.compute_weights(self.diffusion.transformer):
            return self.diffusion.train_loss(tokens, cond_emb, t, pt, generator=generator,
                                             gumbel=gumbel, is_train=is_train, denoiser=denoiser)

    @torch.no_grad()
    def reconstruct(self, mel: torch.Tensor) -> torch.Tensor:
        """Codec round trip, mel -> tokens -> mel (DALLE.reconstruct,
        dalle_spec.py:249-261)."""
        return self.decode_tokens(self.encode_content(mel))

    @torch.no_grad()
    @_computes()
    def generate(
        self,
        generator: torch.Generator,
        cond_tokens: torch.Tensor,
        *,
        sample_type: str = "top0.85r",
        filter_ratio: float = 0.0,
        content_tokens: Optional[torch.Tensor] = None,
        return_tokens: bool = False,
        noise=None,
        use_fused: Optional[bool] = None,
    ):
        """BPE ids (B, 77) -> mel (B, H, W, 1) in [-1, 1] (DALLE.generate_content).

        ``sample_type`` is the reference's string, 'top<r>r' or 'top<k>p' or
        no truncation, then ',fast<k>' and ',q<rate>'. Two samplers run it,
        by the JAX package's rule: the index-carrying sampler with the fused
        step kernel (K1) takes no-truncation and 'top<r>r' heads without
        ',q'; everything else, and anything with ``use_fused=False``, goes to
        the one-hot ``sample_tokens`` (plain PyTorch, no kernel).
        ``use_fused=True`` on a sample type the fused sampler does not cover
        takes the one-hot one too, as in the JAX package. The default
        (``None``) is fused wherever it covers, as the JAX package's default
        on its accelerator; the JAX package's default on the CPU is one-hot,
        so a comparison with it there passes ``use_fused=False``.

        ``noise`` supplies the draws (tests and checks): for the fused
        sampler the Gumbel noise (n_steps, B, L, K) in place of the kernel's
        Philox draws; for the one-hot one a ``OneHotDraws``."""
        truncation_r, _, skip_step, resample_q = parse_sample_type(sample_type)
        head = sample_type.split(",")[0] if sample_type else ""
        fused_ok = resample_q == 0.0 and (not head.startswith("top") or head.endswith("r"))
        cond_emb = self.embed_condition(cond_tokens)
        if (fused_ok if use_fused is None else use_fused and fused_ok):
            if isinstance(noise, OneHotDraws):
                raise TypeError("the fused sampler takes its noise as one tensor")
            tokens = sample_tokens_fused(
                self.transformer, cond_emb, generator=generator, truncation_r=truncation_r,
                skip_step=skip_step, content_tokens=content_tokens, filter_ratio=filter_ratio,
                noise=noise)
        else:
            filter_fn = None
            if head.startswith("top"):
                filter_fn = (partial(truncate_top_r, r=float(head[3:-1])) if head.endswith("r")
                             else partial(truncate_top_k, k=int(head[3:-1])))
            if noise is not None and not isinstance(noise, OneHotDraws):
                raise TypeError("the one-hot sampler takes its draws as a OneHotDraws")
            tokens = sample_tokens(
                self.transformer, cond_emb, generator=generator, content_tokens=content_tokens,
                filter_ratio=filter_ratio, skip_step=skip_step, filter_fn=filter_fn,
                resample_q=resample_q, draws=noise)
        mel = self.decode_tokens(tokens)
        if return_tokens:
            return mel, tokens
        return mel

    @torch.no_grad()
    def sample_grid(self, generator: torch.Generator, mel: torch.Tensor,
                    cond_tokens: torch.Tensor, *,
                    filter_ratios: Sequence[float] = (0.0, 0.5, 1.0),
                    sample_type: str = "top0.85r", use_fused: Optional[bool] = None,
                    noises: Optional[Sequence] = None) -> dict:
        """Training-time visualization grid (DALLE.sample, dalle_spec.py:263-338):
        the input, its codec reconstruction, and generations started from
        increasingly corrupted encodings of the input (filter_ratio 0 = pure
        text-to-sound), under the JAX package's keys. ``noises``, one per
        filter ratio, is ``generate``'s ``noise`` for each."""
        out = {"input_image": mel, "reconstruction_image": self.reconstruct(mel)}
        content = self.encode_content(mel)
        for i, fr in enumerate(filter_ratios):
            out[f"cond1_cont1.0_fr{fr}_image"] = self.generate(
                generator, cond_tokens, sample_type=sample_type, filter_ratio=fr,
                content_tokens=content if fr > 0 else None, use_fused=use_fused,
                noise=None if noises is None else noises[i])
        return out

    # -- int8 serving mode ----------------------------------------------------

    @torch.no_grad()
    @_computes("transformer")
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
                      sample_type: str = "top0.85r", use_fused: Optional[bool] = None,
                      qp=None, impl: Optional[str] = None):
        """Long-form generation beyond the 848-frame window: BPE ids (B, 77) ->
        mel (B, n_mels, duration_frames, 1), each frame a weighted mean of
        the codec's mels for it (in [-1, 1] only as far as the codec's are:
        its decoder ends in a convolution).

        Each caption is repeated ``n`` times, so the ``n`` overlapping
        full-length segments of every caption come from ONE sampler call of
        B * n rows (``generate`` with ``use_fused``, or with ``qp`` the int8
        engine's ``generate_int8`` on the ``impl`` path); their mels are cross-faded:
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
            gen = lambda c: self.generate(generator, c, sample_type=sample_type,
                                          use_fused=use_fused)
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


def build_model(config: Mapping[str, Any], *, device: Any = "cuda", seed: int = 0,
                load_codec: bool = True) -> Diffsound:
    """``build_model(config['model'])`` of the reference
    (``sound_synthesis/modeling/build.py:4-5``). The modules are made without
    storage, then materialised on ``device`` (the card unless the caller asks
    for another) and initialised there at random from a generator seeded with
    ``seed`` (``Diffsound.init_params``); then, when the
    config names a codec ``ckpt_path`` and ``load_codec`` is set, the codec's
    trained weights replace its random ones
    (the JAX package's ``init_params(load_codec=True)``; callers that load
    the whole model from elsewhere pass False). ``device="meta"`` leaves the
    modules without storage (shape inspection) and loads nothing. The model
    comes back in eval mode: dropout acts only in the training loss."""
    with torch.device("meta"):
        model = instantiate_from_config(config.get("model", config))
    model = model.to_empty(device=device)
    if torch.device(device).type != "meta":
        model.init_params(torch.Generator(device).manual_seed(seed))
        if load_codec and model.codec_ckpt_path:
            model._load_codec_params()
    return model.eval()
