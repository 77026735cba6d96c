"""Token-grid permuters: factorization orders for the (H, W) code grid.

Port of ``text_to_sound_synthesis_tpu/ops/permuter.py``: ``Identity``,
``ColumnMajor`` (the time-major order the Diffsound and AR configs use),
``Subsample`` (hierarchical 2x2), ``ZCurve`` (Morton order), ``SpiralOut``,
``SpiralIn``, ``Random`` and ``AlternateParsing``, each registered under the
JAX package's name and the reference's
(``specvqgan.modules.transformer.permuter.*``). Index tables are numpy, built
once; each device gets its own cached copy, so applying a permutation costs
one gather and no host copy after the first call.

A sequence longer than H*W keeps its first H*W positions, permuted, as the
JAX package's ``jnp.take`` does (``ColumnMajor`` instead re-derives its index
for a multiple of H*W). A shorter one raises ``ValueError``: JAX fills the
missing positions with INT_MIN, and on a card an out-of-range gather would
abort the context.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import register

__all__ = [
    "Identity", "ColumnMajor", "Subsample", "ZCurve",
    "SpiralOut", "SpiralIn", "Random", "AlternateParsing",
]


class _IndexPermuter:
    """Precomputed forward/backward index permutation over L = H*W tokens."""

    def __init__(self, idx: np.ndarray):
        self.forward_idx = np.array(idx, np.int64)   # a copy: SpiralIn hands a reversed view
        self.backward_idx = np.argsort(self.forward_idx)
        self._on_device: dict = {}

    def _index(self, L: int, reverse: bool, device: torch.device) -> torch.Tensor:
        key = (L, reverse, str(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(self._idx_for(L, reverse), device=device)
        return self._on_device[key]

    def _idx_for(self, L: int, reverse: bool) -> np.ndarray:
        if L < len(self.forward_idx):
            raise ValueError(f"sequence length {L} is shorter than the permuter's "
                             f"{len(self.forward_idx)} positions")
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


@register(
    "text_to_sound_synthesis_tpu.ops.permuter.Subsample",
    "specvqgan.modules.transformer.permuter.Subsample",
)
class Subsample(_IndexPermuter):
    """Coarse-to-fine 2x2 hierarchical order (permuter.py:57-80)."""

    def __init__(self, H: int, W: int):
        C = 1
        idx = np.arange(H * W).reshape(C, H, W)
        while min(H, W) > 1:
            idx = idx.reshape(C, H // 2, 2, W // 2, 2)
            idx = idx.transpose(0, 2, 4, 1, 3)
            idx = idx.reshape(C * 4, H // 2, W // 2)
            H, W, C = H // 2, W // 2, C * 4
        assert H == W == 1, "Subsample requires power-of-two square-reducible grids"
        super().__init__(idx.ravel())


def _morton(i: int, j: int) -> int:
    z = 0
    for bit in range(32):
        z |= ((j >> bit) & 1) << (2 * bit)
        z |= ((i >> bit) & 1) << (2 * bit + 1)
    return z


@register(
    "text_to_sound_synthesis_tpu.ops.permuter.ZCurve",
    "specvqgan.modules.transformer.permuter.ZCurve",
)
class ZCurve(_IndexPermuter):
    """Morton (Z-order) curve (permuter.py:98-115)."""

    def __init__(self, H: int, W: int):
        codes = [_morton(i, j) for i in range(H) for j in range(W)]
        super().__init__(np.argsort(codes))


def _spiral_path(size: int) -> np.ndarray:
    """Outward spiral visit order over a ``size x size`` grid (the walk of
    the reference's SpiralOut, permuter.py:117-168): start at (size/2,
    size/2-1), alternate runs of decreasing-row / increasing-col then
    increasing-row / decreasing-col with run lengths 1,1,2,2,3,3,... and a
    final (size-1)-long closing run of increasing rows. Only an even
    ``size`` is covered in full."""
    if size < 2 or size % 2:
        raise ValueError(f"spiral permuters need an even square grid, got {size}")
    i, j = size // 2, size // 2 - 1
    path = [i * size + j]
    run = 0
    for ring in range(1, size // 2 + 1):
        run += 1
        for _ in range(run):
            i -= 1
            path.append(i * size + j)
        for _ in range(run):
            j += 1
            path.append(i * size + j)
        run += 1
        closing = ring == size // 2
        for _ in range(run - 1 if closing else run):
            i += 1
            path.append(i * size + j)
        if not closing:
            for _ in range(run):
                j -= 1
                path.append(i * size + j)
    assert len(path) == size * size
    return np.asarray(path)


@register(
    "text_to_sound_synthesis_tpu.ops.permuter.SpiralOut",
    "specvqgan.modules.transformer.permuter.SpiralOut",
)
class SpiralOut(_IndexPermuter):
    """Center-outward spiral order (permuter.py:117-174). Square grids only."""

    def __init__(self, H: int, W: int):
        if H != W:
            raise ValueError("SpiralOut requires a square grid (reference asserts H == W)")
        super().__init__(_spiral_path(W))


@register(
    "text_to_sound_synthesis_tpu.ops.permuter.SpiralIn",
    "specvqgan.modules.transformer.permuter.SpiralIn",
)
class SpiralIn(_IndexPermuter):
    """Outside-inward spiral = SpiralOut's path reversed (permuter.py:177-235)."""

    def __init__(self, H: int, W: int):
        if H != W:
            raise ValueError("SpiralIn requires a square grid (reference asserts H == W)")
        super().__init__(_spiral_path(W)[::-1])


@register(
    "text_to_sound_synthesis_tpu.ops.permuter.Random",
    "specvqgan.modules.transformer.permuter.Random",
)
class Random(_IndexPermuter):
    """Fixed pseudo-random order, the reference's
    ``np.random.RandomState(1).permutation(H*W)`` (permuter.py:238-250): an
    order a checkpoint was trained in, not a draw, so it takes no generator."""

    def __init__(self, H: int, W: int):
        super().__init__(np.random.RandomState(1).permutation(H * W))


@register(
    "text_to_sound_synthesis_tpu.ops.permuter.AlternateParsing",
    "specvqgan.modules.transformer.permuter.AlternateParsing",
)
class AlternateParsing(_IndexPermuter):
    """Boustrophedon (snake) order: odd rows reversed (permuter.py:253-269)."""

    def __init__(self, H: int, W: int):
        idx = np.arange(H * W).reshape(H, W)
        idx[1::2] = idx[1::2, ::-1]
        super().__init__(idx.ravel())
