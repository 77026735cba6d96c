"""The weights bridge: JAX-package parameter trees -> the port's modules.

Each ``*_state_dict`` function takes a flax parameter tree of the JAX package
(nested mappings whose leaves are arrays; pass ``jax.device_get(params)`` or
any tree of numpy arrays — this module never imports JAX) and returns the
port's state dict under the reference's names. Each ``load_*`` function loads
that into a port module with ``load_state_dict(strict=True)``, so a missing or
extra tensor, or a shape mismatch, raises.

Layout rules (the inverse of ``convert/torch_to_jax.py``):

* Dense:            flax (in, out)        -> torch (out, in)
* Conv2d:           flax HWIO             -> torch OIHW
* Conv1d:           flax WIO (k, I, O)    -> torch (O, I, k)
* ConvTranspose1d:  JAX (k, Cout, Cin)    -> torch (Cin, Cout, k)
* LayerNorm / GroupNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = [
    "clip_text_state_dict", "diffusion_state_dict", "vqgan_state_dict",
    "melgan_generator_state_dict",
    "load_clip_text", "load_diffusion", "load_vqgan", "load_melgan_generator",
    "load_diffsound",
]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v, dtype=np.float32)
    return out


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _dense(w):
    return w.T


def _conv2d(w):
    return w.transpose(3, 2, 0, 1)


def _conv1d(w):
    return w.transpose(2, 1, 0)


def _convtranspose1d(w):
    return w.transpose(2, 1, 0)


def _leaf(leaf: str, w: np.ndarray, kernel_tf: Callable) -> Tuple[str, np.ndarray]:
    """flax leaf name -> torch leaf name and layout."""
    if leaf == "kernel":
        return "weight", kernel_tf(w)
    if leaf in ("scale", "embedding"):
        return "weight", w
    if leaf == "bias":
        return "bias", w
    raise KeyError(f"unmapped leaf {leaf!r}")


def _load(module: nn.Module, sd: Mapping[str, np.ndarray]) -> nn.Module:
    module.load_state_dict(
        {k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return module


# -- CLIP text tower -----------------------------------------------------------

_CLIP_SUB = {"ln_1": "ln_1", "ln_2": "ln_2", "attn_out_proj": "attn.out_proj",
             "mlp_c_fc": "mlp.c_fc", "mlp_c_proj": "mlp.c_proj"}


def clip_text_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``CLIPTextEmbedding`` tree -> reference CLIP text-tower names."""
    p = _params(params)
    p = p.get("text", p)
    sd = {}
    for path, w in _flatten(p).items():
        head = path[0]
        if head in ("positional_embedding", "text_projection"):
            sd[head] = w
        elif head in ("token_embedding", "ln_final"):
            name, v = _leaf(path[-1], w, _dense)
            sd[f"{head}.{name}"] = v
        elif head.startswith("resblock_"):
            base = f"transformer.resblocks.{head.split('_')[1]}"
            sub, leaf = path[1], path[-1]
            if sub == "attn_in_proj":
                sd[f"{base}.attn.in_proj_{'weight' if leaf == 'kernel' else 'bias'}"] = (
                    _dense(w) if leaf == "kernel" else w)
            else:
                name, v = _leaf(leaf, w, _dense)
                sd[f"{base}.{_CLIP_SUB[sub]}.{name}"] = v
        else:
            raise KeyError(f"unmapped clip param {'/'.join(path)}")
    return sd


def load_clip_text(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, clip_text_state_dict(params))


# -- diffusion denoiser --------------------------------------------------------

_BLOCK_SUB = {"mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2"}


def diffusion_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``DiscreteDiffusion`` tree -> the reference ``DiffusionTransformer``'s
    denoiser names (``transformer.*``)."""
    p = _params(params)["backbone"]
    sd = {}
    for path, w in _flatten(p).items():
        head, leaf = path[0], path[-1]
        if head == "content_emb":
            torch_name = f"content_emb.{path[1]}"
        elif head == "norm_out":
            torch_name = "to_logits.0"
        elif head == "head":
            torch_name = "to_logits.1"
        elif head.startswith("block_"):
            sub = path[1]
            torch_name = f"blocks.{head.split('_')[1]}." + ".".join(
                [_BLOCK_SUB.get(sub, sub)] + list(path[2:-1]))
        else:
            raise KeyError(f"unmapped diffusion param {'/'.join(path)}")
        name, v = _leaf(leaf, w, _dense)
        sd[f"transformer.{torch_name}.{name}"] = v
    return sd


def load_diffusion(module: nn.Module, params: Mapping) -> nn.Module:
    """Load the denoiser of a port ``DiscreteDiffusion`` (its ``condition_emb``,
    if any, is loaded by ``load_clip_text``)."""
    sd = diffusion_state_dict(params)
    _load(module.transformer, {k[len("transformer."):]: v for k, v in sd.items()})
    return module


# -- VQGAN -----------------------------------------------------------------------

def _vqgan_name(path: Tuple[str, ...]) -> str:
    segs = []
    for n in path[:-1]:
        if n.startswith(("down_", "up_")):
            segs.append(n.replace("_", "."))        # down_0_block_1 -> down.0.block.1
        elif n.startswith("mid_"):
            segs.append("mid." + n[len("mid_"):])
        elif n == "norm" and segs and segs[-1].split(".")[-1] in (
                "norm", "norm1", "norm2", "norm_out"):
            continue                                # GroupNorm32's inner level
        else:
            segs.append(n)
    return ".".join(segs)


def vqgan_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``VQModel`` tree -> reference SpecVQGAN names."""
    sd = {}
    for path, w in _flatten(_params(params)).items():
        if path[0] == "quantize":
            sd["quantize.embedding.weight"] = w
            continue
        name, v = _leaf(path[-1], w, _conv2d)
        sd[f"{_vqgan_name(path)}.{name}"] = v
    return sd


def load_vqgan(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, vqgan_state_dict(params))


# -- MelGAN generator --------------------------------------------------------------

def melgan_generator_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``MelGANGenerator`` tree -> the reference's flat ``model.N`` names
    (weight norm already folded)."""
    flat = _flatten(_params(params))
    n_up = len({p[0] for p in flat if p[0].startswith("up_")})
    n_res = len({p[0] for p in flat if p[0].startswith("res_0_")})
    index_of = {"conv_in": 1}
    idx = 2
    for i in range(n_up):
        index_of[f"up_{i}"] = idx + 1     # after the LeakyReLU
        idx += 2
        for j in range(n_res):
            index_of[f"res_{i}_{j}"] = idx
            idx += 1
    index_of["conv_out"] = idx + 2        # after LeakyReLU, ReflectionPad
    sd = {}
    for path, w in flat.items():
        mod, leaf = path[0], path[-1]
        base = f"model.{index_of[mod]}"
        if mod.startswith("res_"):
            base += {"conv1": ".block.2", "conv2": ".block.4", "shortcut": ".shortcut"}[path[1]]
        name, v = _leaf(leaf, w, _convtranspose1d if mod.startswith("up_") else _conv1d)
        sd[f"{base}.{name}"] = v
    return sd


def load_melgan_generator(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, melgan_generator_state_dict(params))


# -- the composite -------------------------------------------------------------------

def load_diffsound(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """JAX ``Diffsound`` params ``{"codec", "cond", "diffusion"}`` -> port ``Diffsound``."""
    load_vqgan(model.codec, params["codec"])
    if params.get("cond") is not None:
        load_clip_text(model.cond, params["cond"])
    load_diffusion(model.diffusion, params["diffusion"])
    return model
