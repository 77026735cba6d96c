"""Reading the reference's released torch checkpoints into the port's modules.

The port's module names are the reference's, so a released state dict loads
as it is once two things are undone: the wrapping of PyTorch-Lightning
``.ckpt`` files (``{"state_dict": ...}``) and MelGAN's weight norm, folded
into plain weights. Behaves as ``load_torch_state_dict`` and
``fold_weight_norm`` of the JAX package's ``convert/torch_to_jax.py``, with
torch tensors in place of numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

__all__ = ["load_torch_state_dict", "fold_weight_norm"]


def load_torch_state_dict(path: str, key: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A torch checkpoint -> a flat {name: float32 tensor} dict on the CPU.

    ``key`` selects a sub-dict ('model' / 'ema' of the stage-2 solver's
    checkpoints); without it a PyTorch-Lightning ``{"state_dict": ...}`` is
    unwrapped and anything else is taken as the state dict. Entries that are
    not tensors are dropped. The file is unpickled whole (its hyper-parameters
    and callbacks too), so load only checkpoints you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None:
        obj = obj[key]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {name: t.detach().to(torch.float32) for name, t in obj.items()
            if isinstance(t, torch.Tensor)}


def fold_weight_norm(sd: Mapping[str, torch.Tensor], base: str) -> torch.Tensor:
    """``base.weight_g`` / ``base.weight_v`` -> the plain weight
    g * v / ||v|| (torch ``weight_norm``, dim 0: the norm over every axis but
    the first); ``base.weight`` itself when the layer has no weight norm."""
    if base + ".weight" in sd:
        return sd[base + ".weight"]
    g, v = sd[base + ".weight_g"], sd[base + ".weight_v"]
    norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return g * v / norm.clamp(min=1e-12)
