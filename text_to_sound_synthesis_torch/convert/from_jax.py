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
* BatchNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``, its ``batch_stats``
  ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.quant import QuantizedWeight

__all__ = [
    "clip_text_state_dict", "diffusion_state_dict", "vqgan_state_dict",
    "vqgan1d_state_dict", "melgan_generator_state_dict", "discriminator_state_dict",
    "melgan_discriminator_state_dict", "vggishish_state_dict", "lpaps_state_dict",
    "load_clip_text", "load_diffusion", "load_vqgan", "load_vqgan1d", "load_melgan_generator",
    "load_discriminator", "load_melgan_discriminator", "load_vggishish", "load_lpaps",
    "load_diffsound", "load_int8_engine", "melception_state_dict", "load_melception",
    "captioner_state_dict", "load_captioner", "denoiser_state_dict", "load_denoiser",
    "rnn_embedder_state_dict", "gpt_state_dict", "load_gpt", "net2net_state_dict",
    "load_net2net",
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


def _denoiser_state_dict(p: Mapping) -> Dict[str, np.ndarray]:
    """A denoiser's tree (``content_emb``, ``block_i``, ``norm_out``,
    ``head``) -> the reference's names (``to_logits.0/1``, ``blocks.i.mlp.0/2``);
    a bare parameter (``content_emb/height_emb`` under ``pos_emb_type=
    "parameter"``) keeps its name."""
    sd = {}
    for path, w in _flatten(p).items():
        head, leaf = path[0], path[-1]
        if head == "content_emb" and len(path) == 2:
            sd[f"content_emb.{leaf}"] = w
            continue
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
        sd[f"{torch_name}.{name}"] = v
    return sd


def diffusion_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``DiscreteDiffusion`` tree -> the reference ``DiffusionTransformer``'s
    denoiser names (``transformer.*``)."""
    return {f"transformer.{k}": v
            for k, v in _denoiser_state_dict(_params(params)["backbone"]).items()}


def denoiser_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """A standalone ``Condition2SpecTransformer`` or ``UnCondition2SpecTransformer``
    tree -> the reference ``Condition2ImageTransformer`` /
    ``UnCondition2ImageTransformer``'s names (``blocks.i.ln2``: the class AdaLN
    or the LayerNorm)."""
    return _denoiser_state_dict(_params(params))


def load_denoiser(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, denoiser_state_dict(params))


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


def vqgan1d_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``VQModel1d`` tree -> the port's names (the 2-D codec's, 1-D kernels)."""
    sd = {}
    for path, w in _flatten(_params(params)).items():
        if path[0] == "quantize":
            sd["quantize.embedding.weight"] = w
            continue
        name, v = _leaf(path[-1], w, _conv1d)
        sd[f"{_vqgan_name(path)}.{name}"] = v
    return sd


def load_vqgan1d(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, vqgan1d_state_dict(params))


# -- PatchGAN discriminators -------------------------------------------------------

def discriminator_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """``NLayerDiscriminator`` (2-D) or a 1-D variant's variables
    (``params`` and, with BatchNorm, ``batch_stats``) -> the reference's
    ``main.N`` names: conv_0 at 0, conv_i at 3 i - 1, norm_i at 3 i, conv_out
    after the last LeakyReLU. ``num_batches_tracked``, which flax does not
    keep, is 0; ActNorm's (C,) loc / scale become (1, C, 1, 1) and its
    ``initialized`` flag 1."""
    p = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    n_mid = len({k[0] for k in p if k[0].startswith("conv_") and k[0] not in ("conv_0",
                                                                             "conv_out")})
    sd = {}
    for (mod, leaf), w in p.items():
        if mod.startswith("conv_"):
            ends = {"conv_0": 0, "conv_out": 3 * n_mid + 2}
            idx = ends[mod] if mod in ends else 3 * int(mod[5:]) - 1
            name, v = _leaf(leaf, w, _conv2d if w.ndim == 4 else _conv1d)
            sd[f"main.{idx}.{name}"] = v
        else:
            base = f"main.{3 * int(mod.split('_')[1])}"
            if leaf in ("loc", "scale") and (mod, "bias") not in p:     # ActNorm
                sd[f"{base}.{leaf}"] = w.reshape(1, -1, 1, 1)
                sd[f"{base}.initialized"] = np.array(1, np.uint8)
            else:
                sd[f"{base}.{'weight' if leaf == 'scale' else 'bias'}"] = w
    for (mod, leaf), w in stats.items():
        base = f"main.{3 * int(mod.split('_')[1])}"
        sd[f"{base}.running_{leaf}"] = w
        sd[f"{base}.num_batches_tracked"] = np.array(0, np.int64)
    return sd


def load_discriminator(module: nn.Module, variables: Mapping) -> nn.Module:
    return _load(module, discriminator_state_dict(variables))


def melgan_discriminator_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``MelGANDiscriminator`` tree -> the reference's
    ``model.disc_i.model.layer_k`` names (``layer_0.1``, ``layer_k.0``, a bare
    last layer)."""
    flat = _flatten(_params(params))
    top = {}
    for disc, layer, _ in flat:
        top[disc] = max(top.get(disc, 0), int(layer[len("layer_"):]))
    sd = {}
    for (disc, layer, leaf), w in flat.items():
        k = int(layer[len("layer_"):])
        sub = "" if k == top[disc] else (".1" if k == 0 else ".0")
        name, v = _leaf(leaf, w, _conv1d)
        sd[f"model.{disc}.model.{layer}{sub}.{name}"] = v
    return sd


def load_melgan_discriminator(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, melgan_discriminator_state_dict(params))


# -- VGGishish and LPAPS ------------------------------------------------------------

def _vgg_feature_index(conv_layers) -> Dict[int, int]:
    """conv i -> its index in the reference's ``features`` Sequential."""
    out, conv_i, idx = {}, 0, 0
    for v in conv_layers:
        if v == "MP":
            idx += 1
        else:
            out[conv_i] = idx
            conv_i += 1
            idx += 2
    return out


def vggishish_state_dict(params: Mapping, conv_layers=None) -> Dict[str, np.ndarray]:
    """``VGGishish`` tree -> ``features.N`` / ``classifier.{0,2,4}``; fc1's
    rows go from flax's (5, 10, C) flatten to torch's (C, 5, 10)."""
    from ..models.lpaps.vggishish import VGG16_LAYERS

    fi = _vgg_feature_index(conv_layers or VGG16_LAYERS)
    sd = {}
    for (mod, leaf), w in _flatten(_params(params)).items():
        if mod.startswith("conv_"):
            name, v = _leaf(leaf, w, _conv2d)
            sd[f"features.{fi[int(mod[5:])]}.{name}"] = v
        else:
            ci = {"fc1": 0, "fc2": 2, "fc3": 4}[mod]
            if leaf == "kernel" and mod == "fc1":
                w = w.reshape(5, 10, -1, w.shape[-1]).transpose(3, 2, 0, 1).reshape(w.shape[-1], -1)
            elif leaf == "kernel":
                w = _dense(w)
            sd[f"classifier.{ci}.{'weight' if leaf == 'kernel' else 'bias'}"] = w
    return sd


def load_vggishish(module: nn.Module, params: Mapping, conv_layers=None) -> nn.Module:
    return _load(module, vggishish_state_dict(params, conv_layers))


def lpaps_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``LPAPS`` tree -> ``scaling_layer.{shift,scale}``, ``net.sliceS.N`` (the
    slice holding feature N) and ``lin{i}.model.1.weight`` (1, C, 1, 1)."""
    from ..models.lpaps.vggishish import VGG16_LAYERS, tap_indices

    fi = _vgg_feature_index(VGG16_LAYERS)
    cuts = [i + 1 for i in tap_indices(VGG16_LAYERS)]
    sd = {}
    for path, w in _flatten(_params(params)).items():
        head = path[0]
        if head in ("shift", "scale"):
            sd[f"scaling_layer.{head}"] = w
        elif head.startswith("lin"):
            sd[f"{head}.model.1.weight"] = w.reshape(1, -1, 1, 1)
        else:                                   # net/conv_i/{kernel,bias}
            idx = fi[int(path[1][5:])]
            s = next(k for k, c in enumerate(cuts) if idx < c) + 1
            name, v = _leaf(path[-1], w, _conv2d)
            sd[f"net.slice{s}.{idx}.{name}"] = v
    return sd


def load_lpaps(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, lpaps_state_dict(params))


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


# -- evaluation: Melception and the ACT captioner ----------------------------------

#: the BatchNorm variance that makes the eval-mode affine exactly the folded one:
#: in f32, 1 - 1e-3 plus BatchNorm2d's eps 1e-3 rounds to 1.0, whose 1 / sqrt is 1
MELCEPTION_UNIT_VAR = np.float32(1.0 - 1e-3)


def melception_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``Melception`` tree -> torchvision Inception3 names. The JAX tree holds
    each BasicConv2d's BatchNorm folded (``bn_scale`` / ``bn_shift``); it goes
    back as weight = bn_scale, bias = bn_shift, running_mean = 0 and
    running_var = ``MELCEPTION_UNIT_VAR``, which makes the eval-mode
    BatchNorm the folded affine exactly."""
    sd = {}
    for path, w in _flatten(_params(params)).items():
        base, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "fc_kernel":
            sd["fc.weight"] = _dense(w)
        elif leaf == "fc_bias":
            sd["fc.bias"] = w
        elif leaf == "kernel":                       # <block>.conv.kernel
            sd[f"{base}.weight"] = _conv2d(w)
        elif leaf in ("bn_scale", "bn_shift"):
            sd[f"{base}.bn.{'weight' if leaf == 'bn_scale' else 'bias'}"] = w
            if leaf == "bn_scale":
                sd[f"{base}.bn.running_mean"] = np.zeros_like(w)
                sd[f"{base}.bn.running_var"] = np.full_like(w, MELCEPTION_UNIT_VAR)
                sd[f"{base}.bn.num_batches_tracked"] = np.array(0, np.int64)
        else:
            raise KeyError(f"unmapped melception param {'/'.join(path)}")
    return sd


def load_melception(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, melception_state_dict(params))


def captioner_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``ACTCaptioner`` tree -> the port's names, which are the JAX package's
    module names (``encoder.block_0.qkv.weight``, ``dec_0.self_q.weight``,
    ``word_emb.weight``, ...); the encoder's raw parameters (``bn0_scale``,
    ``bn0_shift``, ``cls_token``, ``pos_embedding``) keep their names."""
    sd = {}
    for path, w in _flatten(_params(params)).items():
        base, leaf = ".".join(path[:-1]), path[-1]
        if leaf in ("kernel", "scale", "embedding", "bias"):
            name, w = _leaf(leaf, w, _dense)
            sd[f"{base}.{name}"] = w
        else:
            sd[".".join(path)] = w
    return sd


def load_captioner(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, captioner_state_dict(params))


# -- the AR baseline: the GPT family and Net2Net ---------------------------------------

def rnn_embedder_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``RNNEmbedder`` tree (``cell_i``, flax LSTM or GRU cells) -> torch
    ``nn.LSTM`` / ``nn.GRU`` names, the inverse of the JAX package's
    ``convert/torch_to_jax.py::convert_rnn_embedder``: gate rows stacked in
    torch's order (LSTM i, f, g, o; GRU r, z, n). flax keeps one bias a gate
    where torch splits it into ``bias_ih`` and ``bias_hh``: it goes to
    ``bias_ih`` and ``bias_hh`` is 0, but for the GRU's new gate, whose hidden
    bias sits inside the reset product and stays apart (``hn``)."""
    p = _params(params)
    sd = {}
    for i in range(len(p)):
        cell = _flatten(p[f"cell_{i}"])
        lstm = ("ii", "kernel") in cell
        gates = "ifgo" if lstm else "rzn"
        sd[f"weight_ih_l{i}"] = np.concatenate([_dense(cell[(f"i{g}", "kernel")]) for g in gates])
        sd[f"weight_hh_l{i}"] = np.concatenate([_dense(cell[(f"h{g}", "kernel")]) for g in gates])
        H = sd[f"weight_hh_l{i}"].shape[1]
        zero = np.zeros(H, np.float32)
        if lstm:
            sd[f"bias_ih_l{i}"] = np.concatenate([cell[(f"h{g}", "bias")] for g in gates])
            sd[f"bias_hh_l{i}"] = np.zeros(4 * H, np.float32)
        else:
            sd[f"bias_ih_l{i}"] = np.concatenate([cell[(f"i{g}", "bias")] for g in gates])
            sd[f"bias_hh_l{i}"] = np.concatenate([zero, zero, cell[("hn", "bias")]])
    return sd


def _embedder_state_dict(tree: Mapping) -> Dict[str, np.ndarray]:
    """A feature or class embedder's tree -> its torch names: Conv1d (WIO
    kernel), Linear, Embed or an ``RNNEmbedder``."""
    if "cell_0" in tree:
        return rnn_embedder_state_dict(tree)
    sd = {}
    for (leaf,), w in _flatten(tree).items():
        name, v = _leaf(leaf, w, _conv1d if w.ndim == 3 else _dense)
        sd[name] = v
    return sd


_GPT_SUB = {"mlp_fc1": "mlp.0", "mlp_fc2": "mlp.2"}


def gpt_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """``GPT``, ``GPTFeats``, ``GPTClass`` or ``GPTFeatsClass`` tree -> minGPT
    names (``tok_emb``, ``pos_emb``, ``blocks.i.attn.key``, ``blocks.i.mlp.0/2``,
    ``ln_f``, ``head``, and ``embedder`` / ``feat_embedder`` / ``cls_embedder``)."""
    p = _params(params)
    sd = {}
    for path, w in _flatten(p.get("gpt", p)).items():
        head = path[0]
        if head == "pos_emb":
            sd["pos_emb"] = w
            continue
        if head.startswith("block_"):
            head = f"blocks.{head.split('_')[1]}." + ".".join(
                [_GPT_SUB.get(path[1], path[1])] + list(path[2:-1]))
        elif head in ("embedder", "feat_embedder", "cls_embedder"):
            continue
        name, v = _leaf(path[-1], w, _dense)
        sd[f"{head}.{name}"] = v
    for emb in ("embedder", "feat_embedder", "cls_embedder"):
        if emb in p:
            sd.update({f"{emb}.{k}": v for k, v in _embedder_state_dict(p[emb]).items()})
    return sd


def load_gpt(module: nn.Module, params: Mapping) -> nn.Module:
    return _load(module, gpt_state_dict(params))


def net2net_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``Net2NetTransformer`` params ``{"codec", "gpt"}`` -> the reference's
    ``first_stage_model.*`` and ``transformer.*``."""
    sd = {f"first_stage_model.{k}": v for k, v in vqgan_state_dict(params["codec"]).items()}
    sd.update({f"transformer.{k}": v for k, v in gpt_state_dict(params["gpt"]).items()})
    return sd


def load_net2net(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    return _load(model, net2net_state_dict(params))


# -- the composite -------------------------------------------------------------------

def load_diffsound(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """JAX ``Diffsound`` params ``{"codec", "cond", "diffusion"}`` -> port ``Diffsound``."""
    load_vqgan(model.codec, params["codec"])
    if params.get("cond") is not None:
        load_clip_text(model.cond, params["cond"])
    load_diffusion(model.diffusion, params["diffusion"])
    return model


# -- the int8 serving engine ------------------------------------------------------------

def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _qweight(w):
    """JAX QuantizedWeight (w_q (K, N), scale (1, N), bias (1, N)) -> the
    port's (N, K) layout; the int8 values are copied exactly."""
    w_q = torch.from_numpy(np.ascontiguousarray(np.asarray(w.w_q, dtype=np.int8).T))
    return QuantizedWeight(w_q, _t(w.scale).reshape(-1), _t(w.bias).reshape(-1))


def load_int8_engine(qp: Any, device: Any = "cuda"):
    """A JAX ``Int8Denoiser`` (its leaves as arrays, e.g. after
    ``jax.device_get``) -> the port's ``Int8Denoiser`` with the same int8
    values, scales, ``act_scales`` and ``weight_bits``, on ``device`` (the
    card unless the caller asks for another)."""
    from ..models.diffusion.int8_runtime import DENSE_FIELDS, Int8Denoiser, Int8Layer

    layers = []
    for lyr in qp.layers:
        dense = {f: _qweight(getattr(lyr, f)) for f in DENSE_FIELDS}
        layers.append(Int8Layer(
            **dense, ln2_mod=_t(lyr.ln2_mod), ada1=_t(lyr.ada1), ada2=_t(lyr.ada2),
            ck_w=_t(lyr.ck_w, torch.bfloat16), ck_b=_t(lyr.ck_b),
            cv_w=_t(lyr.cv_w, torch.bfloat16), cv_b=_t(lyr.cv_b)))
    act = qp.act_scales
    engine = Int8Denoiser(
        layers, tok_emb=_t(qp.tok_emb, torch.bfloat16), pos_emb=_t(qp.pos_emb, torch.bfloat16),
        norm_out=_t(qp.norm_out), head_w=_t(qp.head_w, torch.bfloat16), head_b=_t(qp.head_b),
        n_head=int(qp.n_head), seq_len=int(qp.seq_len), num_timesteps=int(qp.num_timesteps),
        act_scales=None if act is None else tuple(tuple(float(s) for s in row) for row in act),
        weight_bits=int(qp.weight_bits))
    return engine.to(device)
