"""Token-grid permuters: ``Identity`` and ``ColumnMajor``.

Port of ``text_to_sound_synthesis_tpu/ops/permuter.py`` (the two permuters the
Diffsound configs use). Index tables are numpy, built once; each device gets
its own cached copy, so applying a permutation costs one gather and no host
copy after the first call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import register

__all__ = ["Identity", "ColumnMajor"]


class _IndexPermuter:
    """Precomputed forward/backward index permutation over L = H*W tokens."""

    def __init__(self, idx: np.ndarray):
        self.forward_idx = np.asarray(idx, np.int64)
        self.backward_idx = np.argsort(self.forward_idx)
        self._on_device: dict = {}

    def _index(self, L: int, reverse: bool, device: torch.device) -> torch.Tensor:
        key = (L, reverse, str(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(self._idx_for(L, reverse), device=device)
        return self._on_device[key]

    def _idx_for(self, L: int, reverse: bool) -> np.ndarray:
        return self.backward_idx if reverse else self.forward_idx

    def __call__(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """x: (..., L) token ids (or any per-position tensor)."""
        return x.index_select(-1, self._index(x.shape[-1], reverse, x.device))


@register(
    "text_to_sound_synthesis_tpu.ops.permuter.Identity",
    "specvqgan.modules.transformer.permuter.Identity",
)
class Identity(_IndexPermuter):
    def __init__(self, H: int = 1, W: int = 1):
        super().__init__(np.arange(H * W))
        self.H, self.W = H, W

    def __call__(self, x, reverse: bool = False):
        return x


@register(
    "text_to_sound_synthesis_tpu.ops.permuter.ColumnMajor",
    "specvqgan.modules.transformer.permuter.ColumnMajor",
)
class ColumnMajor(_IndexPermuter):
    """Row-major (H, W) grid -> time-major order, column by column
    (permuter.py:21-55). Sequences longer than H*W (a multiple of it)
    re-derive the index for the scaled width, as the reference does."""

    def __init__(self, H: int, W: int):
        self.H, self.W = H, W
        self._by_len: dict = {}
        super().__init__(np.arange(H * W).reshape(H, W).T.ravel())

    def _idx_for(self, L: int, reverse: bool) -> np.ndarray:
        base = self.H * self.W
        if L == base:
            return super()._idx_for(L, reverse)
        if L % base != 0:
            raise ValueError(
                f"sequence length {L} is not a multiple of H*W = {base}")
        if L not in self._by_len:
            w = self.W * (L // base)
            idx = np.arange(self.H * w).reshape(self.H, w).T.ravel()
            self._by_len[L] = (idx, np.argsort(idx))
        fwd, bwd = self._by_len[L]
        return bwd if reverse else fwd
