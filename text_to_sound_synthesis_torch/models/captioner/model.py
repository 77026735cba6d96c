"""ACT: Audio Captioning Transformer — the "audiocaption loss" scorer (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/captioner/model.py``. Parity
targets: ``Codebook/AudiocaptionLoss/models/AudioTransformer.py``
(``AudioTransformer_80:185-244``: per-bin BN, (4, 80) mel patches -> 768-d ViT
with CLS token, 12 layers / 12 heads / MLP 3072, 527-class head) and
``TransModel.py`` (``ACT:43-162``: relu(Linear(527 -> nhid)) memory, sinusoidal
positional encoding, torch-default post-norm TransformerDecoder, word_emb *
sqrt(nhid), tied greedy/beam decoding in ``tools/beam.py``).

The reference's ACT source is not in the repository, so its ``state_dict``
names cannot be checked: the attributes carry the JAX package's module names
(``encoder.block_0.qkv``, ``dec_0.self_q``, ``dec_fc``, ...), and
``convert/from_jax.py::load_captioner`` maps a JAX parameter tree onto them.
As in the JAX package: LayerNorm eps 1e-6 (flax's), GELU the tanh
approximation (flax's ``nn.gelu``), the encoder's ``bn0`` a folded per-bin
affine, a -inf causal mask, the sinusoidal table built in float64. Beam
search ranks each beam's next tokens with ``np.argsort(-logp)`` on the host,
as the JAX package does, so both take the same token on a tie.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.config import register

__all__ = ["ViTBlock", "AudioPatchEncoder", "DecoderLayer", "ACTCaptioner", "greedy_decode",
           "beam_decode"]

LN_EPS = 1e-6   # flax's LayerNorm default, as the JAX package runs it


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # flax nn.gelu's default


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.proj = nn.Linear(inner, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(B, N, 3, self.heads, self.dim_head)
        q, k, v = qkv.unbind(2)
        att = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(self.dim_head)
        att = torch.softmax(att.float(), dim=-1).to(x.dtype)
        y = torch.einsum("bhnm,bmhd->bnhd", att, v).reshape(B, N, -1)
        x = x + self.proj(y)
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


class AudioPatchEncoder(nn.Module):
    """mel (B, T, n_mels) -> per-token class logits (B, 1 + T/patch_t, num_classes)."""

    def __init__(self, patch_size: Tuple[int, int] = (4, 80), num_classes: int = 527,
                 dim: int = 768, depth: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 dim_head: int = 64, max_patches: int = 215):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.depth = depth
        pt, pm = self.patch_size
        # bn0: per-mel-bin affine (eval-mode BN folded, as the JAX package stores it)
        self.bn0_scale = nn.Parameter(torch.ones(pm))
        self.bn0_shift = nn.Parameter(torch.zeros(pm))
        self.patch_proj = nn.Linear(pt * pm, dim)
        self.cls_token = nn.Parameter(torch.randn(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.randn(1, max_patches + 1, dim))
        for i in range(depth):
            setattr(self, f"block_{i}", ViTBlock(dim, heads, dim_head, mlp_dim))
        self.head_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, num_classes)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        B, T, M = mel.shape
        pt, pm = self.patch_size
        if M != pm:
            raise ValueError(f"mel bins {M} != patch width {pm}")
        x = mel * self.bn0_scale + self.bn0_shift
        n = T // pt
        x = self.patch_proj(x[:, : n * pt].reshape(B, n, pt * pm))
        x = torch.cat([self.cls_token.expand(B, 1, -1).to(x.dtype), x], dim=1)
        x = x + self.pos_embedding[:, : n + 1].to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        return self.head(self.head_norm(x))


class DecoderLayer(nn.Module):
    """torch TransformerDecoderLayer, post-norm, relu or gelu FF."""

    def __init__(self, nhid: int, nhead: int, dim_feedforward: int, activation: str = "relu"):
        super().__init__()
        self.nhead = nhead
        for name in ("self", "cross"):
            for part in ("q", "k", "v", "out"):
                setattr(self, f"{name}_{part}", nn.Linear(nhid, nhid))
        self.norm1 = nn.LayerNorm(nhid, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(nhid, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(nhid, eps=LN_EPS)
        self.ff1 = nn.Linear(nhid, dim_feedforward)
        self.ff2 = nn.Linear(dim_feedforward, nhid)
        self.act = F.relu if activation == "relu" else _gelu

    def _mha(self, name: str, q_in, kv_in, mask):
        B, L, D = q_in.shape
        S, H = kv_in.shape[1], self.nhead
        q = getattr(self, f"{name}_q")(q_in).reshape(B, L, H, D // H)
        k = getattr(self, f"{name}_k")(kv_in).reshape(B, S, H, D // H)
        v = getattr(self, f"{name}_v")(kv_in).reshape(B, S, H, D // H)
        att = torch.einsum("blhd,bshd->bhls", q, k) / math.sqrt(D // H)
        if mask is not None:
            att = att + mask
        att = torch.softmax(att.float(), dim=-1).to(q_in.dtype)
        y = torch.einsum("bhls,bshd->blhd", att, v).reshape(B, L, D)
        return getattr(self, f"{name}_out")(y)

    def forward(self, tgt, memory, tgt_mask):
        tgt = self.norm1(tgt + self._mha("self", tgt, tgt, tgt_mask))
        tgt = self.norm2(tgt + self._mha("cross", tgt, memory, None))
        return self.norm3(tgt + self.ff2(self.act(self.ff1(tgt))))


def _sinusoidal_pe(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((length, dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


@register("text_to_sound_synthesis_tpu.models.captioner.ACTCaptioner")
class ACTCaptioner(nn.Module):
    def __init__(self, ntoken: int = 4368, nhid: int = 768, nhead: int = 4, nlayers: int = 2,
                 dim_feedforward: int = 2048, activation: str = "gelu",
                 encoder_num_classes: int = 527, encoder_depth: int = 12, max_len: int = 30,
                 sos_id: int = 0, eos_id: int = 9):
        super().__init__()
        self.nhid, self.nlayers = nhid, nlayers
        self.max_len, self.sos_id, self.eos_id = max_len, sos_id, eos_id
        self.encoder = AudioPatchEncoder(num_classes=encoder_num_classes, depth=encoder_depth)
        self.encoder_linear = nn.Linear(encoder_num_classes, nhid)
        self.word_emb = nn.Embedding(ntoken, nhid)
        for i in range(nlayers):
            setattr(self, f"dec_{i}", DecoderLayer(nhid, nhead, dim_feedforward, activation))
        self.dec_fc = nn.Linear(nhid, ntoken)

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, T, n_mels) -> memory (B, N, nhid)."""
        return F.relu(self.encoder_linear(self.encoder(mel)))

    def decode(self, memory: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """memory (B, N, nhid); tgt token ids (B, L) -> logits (B, L, ntoken)."""
        L = tgt.shape[1]
        x = self.word_emb(tgt.long()) * math.sqrt(self.nhid)
        x = x + torch.from_numpy(_sinusoidal_pe(L, self.nhid)).to(x)[None]
        mask = torch.triu(torch.full((L, L), float("-inf"), device=x.device), diagonal=1)
        for i in range(self.nlayers):
            x = getattr(self, f"dec_{i}")(x, memory, mask[None, None])
        return self.dec_fc(x)

    def forward(self, mel: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(mel), tgt)


@torch.no_grad()
def greedy_decode(model: ACTCaptioner, mel: torch.Tensor,
                  max_len: Optional[int] = None) -> np.ndarray:
    """Greedy caption decoding (AudiocaptionLoss greedy path) on ``mel``'s
    device: each step re-decodes the prefix. -> (B, <= max_len) int32 tokens."""
    max_len = max_len or model.max_len
    B = mel.shape[0]
    memory = model.encode(mel)
    tokens = np.full((B, 1), model.sos_id, np.int32)
    done = np.zeros(B, bool)
    for _ in range(max_len - 1):
        logits = model.decode(memory, torch.from_numpy(tokens).to(mel.device))
        nxt = logits[:, -1].argmax(-1).cpu().numpy()
        nxt = np.where(done, model.eos_id, nxt)
        tokens = np.concatenate([tokens, nxt[:, None].astype(np.int32)], axis=1)
        done |= nxt == model.eos_id
        if done.all():
            break
    return tokens


@torch.no_grad()
def beam_decode(model: ACTCaptioner, mel: torch.Tensor, beam_size: int = 3,
                max_len: Optional[int] = None) -> List[np.ndarray]:
    """Beam search (AudiocaptionLoss/tools/beam.py semantics: length-averaged
    log-prob scoring, EOS-terminated) on ``mel``'s device, one sample at a
    time, each prefix decoded at its own length. Returns the best token row
    per sample."""
    max_len = max_len or model.max_len
    out = []
    for b in range(mel.shape[0]):
        memory = model.encode(mel[b: b + 1])
        beams: List[Tuple[List[int], float, bool]] = [([model.sos_id], 0.0, False)]
        for _ in range(max_len - 1):
            cand: List[Tuple[List[int], float, bool]] = []
            for seq, score, finished in beams:
                if finished:
                    cand.append((seq, score, True))
                    continue
                prefix = torch.tensor([seq], dtype=torch.int32, device=mel.device)
                logits = model.decode(memory, prefix)[0, -1]
                logp = torch.log_softmax(logits.float(), -1).cpu().numpy()
                top = np.argsort(-logp)[:beam_size]
                for t in top:
                    cand.append((seq + [int(t)], score + float(logp[t]),
                                 int(t) == model.eos_id))
            cand.sort(key=lambda c: c[1] / len(c[0]), reverse=True)
            beams = cand[:beam_size]
            if all(f for _, _, f in beams):
                break
        out.append(np.asarray(beams[0][0], np.int32))
    return out
