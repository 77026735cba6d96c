"""Diffsound composite: frozen spec codec + text codec + diffusion generator.

Port of ``text_to_sound_synthesis_tpu/models/diffsound.py`` (reference
``DALLE``, ``Diffsound/sound_synthesis/modeling/models/dalle_spec.py``) for the
bf16 generation path: caption BPE ids -> CLIP text tower -> index-carrying
reverse sampler (fused sampler kernel per step) -> VQGAN ``decode_code``.

Unlike the JAX package's plain object over three parameter trees, this is one
``nn.Module`` laid out as the reference's ``DALLE``: ``content_codec`` (VQModel),
``transformer`` (DiscreteDiffusion, holding ``condition_emb`` = the CLIP tower
and ``transformer`` = the denoiser). The JAX package's names ``codec``,
``cond`` and ``diffusion`` are properties onto those children.
"""

from __future__ import annotations

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

__all__ = ["Diffsound", "build_model", "parse_sample_type"]


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


def build_model(config: Mapping[str, Any], *, device: Any = "cpu", seed: int = 0) -> Diffsound:
    """``build_model(config['model'])`` of the reference
    (``sound_synthesis/modeling/build.py:4-5``). The modules are made without
    storage, then materialised on ``device`` and initialised there at random
    from a generator seeded with ``seed``. ``device="meta"`` leaves them
    without storage (shape inspection)."""
    with torch.device("meta"):
        model = instantiate_from_config(config.get("model", config))
    model = model.to_empty(device=device)
    if torch.device(device).type != "meta":
        model.init_params(torch.Generator(device).manual_seed(seed))
    return model
