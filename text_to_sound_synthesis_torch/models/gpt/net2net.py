"""Net2Net AR composite: frozen VQ codec + conditioning + GPT (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/gpt/net2net.py`` (reference
``Net2NetTransformer``, ``Codebook/specvqgan/models/cond_transformer.py:20-194``):
a mel is encoded to permuted tokens (``encode_to_z``), raw text features pass
through unchanged (``RawFeatsStage``), the GPT is trained on next-token cross
entropy, sampled top-k, and its tokens decoded back to a mel. The modules keep
the reference's names, ``transformer`` (the GPT) and ``first_stage_model``
(the codec), so a reference state dict loads as it is; ``gpt`` and ``codec``
name them as the JAX package does.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from ...ops import permuter as permuter_ops
from ...utils.config import instantiate_from_config, register
from ...utils.dtype import ComputeDtype
from ...utils.init import init_random_
from ..vqgan.model import VQModel, init_codec_
from .model import GPT, GPTClass, GPTFeats, GPTFeatsClass, ar_sample

__all__ = ["Net2NetTransformer"]


@register(
    "text_to_sound_synthesis_tpu.models.gpt.Net2NetTransformer",
    "specvqgan.models.cond_transformer.Net2NetTransformer",
)
class Net2NetTransformer(ComputeDtype, nn.Module):
    """``cond_stage_config`` (the raw-features stage passes features through),
    ``cond_stage_key``, ``first_stage_key``, ``downsample_cond_size`` and
    ``base_learning_rate`` are accepted for config parity.

    ``dtype`` is the compute dtype, as in the JAX module, which passes it to
    the codec and to the GPT (a config sets it as ``model.params.dtype``,
    e.g. ``bfloat16``): the parameters, their gradients and the AdamW
    moments stay f32; the GPT computes on copies of its weights in
    ``dtype`` (``models/gpt/model.py``), the codec's token paths run inside
    ``compute_weights`` on copies of its own, kept until a weight changes
    (``utils/dtype.py::ComputeDtype``); the attention's softmax and the loss
    run in f32. The default, f32, computes as before."""

    def __init__(self, *, transformer_config: Mapping[str, Any],
                 first_stage_config: Mapping[str, Any],
                 cond_stage_config: Optional[Mapping[str, Any]] = None,
                 first_stage_permuter_config: Optional[Mapping[str, Any]] = None,
                 cond_stage_key: str = "feature", first_stage_key: str = "image",
                 downsample_cond_size: int = -1, pkeep: float = 1.0,
                 base_learning_rate: Optional[float] = None, dtype: Any = torch.float32):
        super().__init__()
        self.first_stage_key, self.cond_stage_key = first_stage_key, cond_stage_key
        self.pkeep = float(pkeep)
        self.first_stage_model: VQModel = instantiate_from_config(first_stage_config)
        target = str(transformer_config.get("target", "mingpt.GPTFeats"))
        gpt_cls = (GPTFeatsClass if target.endswith("GPTFeatsClass")
                   else GPTClass if target.endswith("GPTClass") else GPTFeats)
        self.transformer: GPT = gpt_cls(**dict(transformer_config.get("params") or {}))
        self.permuter = (instantiate_from_config(first_stage_permuter_config)
                         if first_stage_permuter_config else permuter_ops.Identity())
        self.dtype = dtype

    def _marked_parts(self) -> tuple:
        """The codec refuses its f32 weights outside ``compute_weights``; the
        GPT takes the compute dtype as its own."""
        return (self.first_stage_model, self.transformer)

    @property
    def gpt(self) -> GPT:
        return self.transformer

    @property
    def codec(self) -> VQModel:
        return self.first_stage_model

    def init_params(self, generator: torch.Generator) -> "Net2NetTransformer":
        """Seeded init in place, on the parameters' device, as the JAX
        package's ``init_params``: the codec as a codec trained from scratch
        (``init_codec_``), the GPT as flax's defaults (``init_random_``)."""
        init_codec_(self.first_stage_model, generator)
        init_random_(self.transformer, generator)
        return self

    # -- token paths ---------------------------------------------------------

    @torch.no_grad()
    def encode_to_z(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, H, W, 1) in [-1, 1] -> (B, h w) permuted token ids."""
        with self.compute_weights(self.first_stage_model):
            idx = self.first_stage_model.encode_indices(mel.to(self.dtype))
        return self.permuter(idx.reshape(idx.shape[0], -1).long())

    @torch.no_grad()
    def decode_to_img(self, tokens: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        """(B, h w) permuted token ids -> mel (B, H, W, 1), in the compute dtype."""
        H, W = hw
        grid = self.permuter(tokens, reverse=True).reshape(-1, H, W)
        with self.compute_weights(self.first_stage_model):
            return self.first_stage_model.decode_code(grid)

    # -- training loss -------------------------------------------------------

    def loss(self, mel: torch.Tensor, cond, generator: Optional[torch.Generator] = None,
             gpt: Optional[nn.Module] = None):
        """Next-token cross entropy (cond_transformer.py:68-116, 353-359) on
        the codec's tokens of ``mel``: ``token_loss(encode_to_z(mel), ...)``."""
        return self.token_loss(self.encode_to_z(mel), cond, generator, gpt)

    def token_loss(self, z: torch.Tensor, cond, generator: Optional[torch.Generator] = None,
                   gpt: Optional[nn.Module] = None):
        """The targets are the whole token sequence ``z`` (B, L), the inputs
        the conditioning and z[:, :-1]. ``pkeep < 1``: each input token is
        kept with probability pkeep, else replaced by a uniform id drawn from
        ``generator`` (required then); the targets stay clean. ``gpt`` runs
        the GPT in its place (its DDP wrapper under a process group). Returns
        (mean loss, logits (B, L, vocab))."""
        z_in = z[:, :-1]
        if self.pkeep < 1.0:
            if generator is None:
                raise ValueError("pkeep < 1 training needs a generator")
            keep = torch.rand(z_in.shape, generator=generator, device=z.device) < self.pkeep
            rand = torch.randint(0, self.first_stage_model.quantize.n_e, z_in.shape,
                                 generator=generator, device=z.device)
            z_in = torch.where(keep, z_in, rand)
        logits = (gpt or self.transformer)(z_in, cond)
        logits = logits[:, logits.shape[1] - z.shape[1]:]     # predictions for z[0..L-1]
        # over (B L, vocab) rows: CUDA's (B, vocab, L) form sums by atomic adds,
        # so its value is not reproducible bit for bit
        loss = nn.functional.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                                           z.reshape(-1))
        return loss, logits

    # -- sampling ------------------------------------------------------------

    @torch.no_grad()
    def sample(self, cond, hw: Tuple[int, int], *, steps: Optional[int] = None,
               top_k: int = 100, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Conditioning -> mel (B, H, W, 1) through the KV-cached sampler."""
        tokens = ar_sample(self.transformer, cond, steps=steps or hw[0] * hw[1], top_k=top_k,
                           temperature=temperature, generator=generator)
        return self.decode_to_img(tokens, hw)
