"""Megatron tensor parallelism of the Stage-2 denoiser over a mesh's model
axis: the port's counterpart of ``text_to_sound_synthesis_tpu/parallel/sharding.py``.

**Placement** (``megatron_placement``): JAX's ``megatron_param_shardings``
rule, written on the port's ``state_dict`` names (the reference's: ``mlp.0``
and ``mlp.2`` where flax has ``mlp_fc1`` and ``mlp_fc2``). A torch ``Linear``
keeps its weight as (out, in), the transpose of flax's (in, out) kernel, so:

- column-parallel, the q / k / v and fc1 weights, split on their outputs,
  the weight's rows (dim 0);
- row-parallel, the attention ``proj`` and fc2 weights, split on their
  inputs, the weight's columns (dim 1);
- every ``nn.Embedding`` split on the feature axis (dim 1): the content
  ``emb``, ``height_emb``, ``width_emb`` and AdaLN's timestep ``emb``;
- everything else replicated: the norms, AdaLN's ``linear``, the head,
  every bias. Where a split does not divide, the tensor is replicated, as
  JAX falls back.

**Storage** (``shard_dims``, ``shard_state_dict``, ``gather_state_dict``):
JAX replicates every bias. Here a column-parallel layer's bias lives as the
rank's slice, Megatron's layout (the rank adds only its own outputs); the
row-parallel biases stay whole. ``gather_state_dict`` returns every tensor
whole, so checkpoints and the samplers only ever see whole weights.

**Runtime** (``MegatronText2Spec``). Under GSPMD XLA inserts the collectives
the layout needs; here they are written out, Megatron's two operators as
``torch.autograd.Function``\\ s over the model group:

- f, identity forward and all-reduce backward, at a column-parallel layer's
  input (once per distinct input: the self-attention's q, k and v share it);
- g, all-reduce forward and identity backward, at a row-parallel layer's
  output, so one all-reduce lands after each attention ``proj`` and each fc2;
- each attention's heads split into contiguous groups by model rank;
- a feature-split embedding is all-gathered after its lookup (backward: the
  rank's slice of the gradient, which every rank of the group holds whole).

Every activation outside the split layers (the residual stream, the norms,
the head, the loss) is the same on every rank of a model group, so the
replicated parameters take the same gradients there. The random draws of a
step (timesteps, q-sample noise) must be the same across a model group: seed
them by the data coordinate. Dropout (0 in every released config) draws
each rank's own mask of its own slice, so above 0 the split run is a
different draw from one process's and need not equal it bit for bit.

Only ``Text2SpecTransformer`` splits, as only it is split in the JAX package
(the dry run, ``tests/test_parallel.py``); the class-conditional and
unconditional denoisers refuse a model axis above 1.
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from ..models.diffusion.backbone import (AdaLayerNorm, MultiHeadAttention, SelfCrossBlock,
                                         Text2SpecTransformer)
from ..models.diffusion.embeddings import ContentEmbedding

__all__ = ["megatron_placement", "shard_dims", "shard_state_dict", "gather_state_dict",
           "ModelAxis", "ColumnParallelLinear", "RowParallelLinear", "MegatronText2Spec",
           "megatron_denoiser"]

COL_PARALLEL = ("query", "key", "value", "mlp.0")   # weight (out, in): split the rows
ROW_PARALLEL = ("proj", "mlp.2")                    # weight (out, in): split the columns
EMBEDDINGS = ("emb", "height_emb", "width_emb")     # nn.Embedding (num, D): split D


def _layer(name: str) -> Tuple[str, str]:
    """(the layer's own name, the leaf) of a state_dict name: 'blocks.0.mlp.0.weight'
    -> ('mlp.0', 'weight'), 'blocks.0.attn1.query.bias' -> ('query', 'bias')."""
    parts = name.split(".")
    if len(parts) >= 3 and parts[-3] == "mlp":
        return "mlp." + parts[-2], parts[-1]
    return (parts[-2] if len(parts) >= 2 else ""), parts[-1]


def _rule(name: str, shape: Sequence[int]) -> Optional[int]:
    layer, leaf = _layer(name)
    if len(shape) < 2 or leaf != "weight":
        return None
    if layer in COL_PARALLEL:
        return 0
    if layer in ROW_PARALLEL:
        return 1
    if layer in EMBEDDINGS:
        return 1
    return None


def megatron_placement(shapes: Mapping[str, Sequence[int]], model: int) -> Dict[str, Optional[int]]:
    """{state_dict name: the dim split over the model axis, or None when
    replicated}: JAX's rule (module docstring), ``shapes`` whole."""
    out = {}
    for name, shape in shapes.items():
        dim = _rule(name, tuple(shape))
        out[name] = dim if dim is not None and shape[dim] % model == 0 else None
    return out


def shard_dims(shapes: Mapping[str, Sequence[int]], model: int) -> Dict[str, int]:
    """{name: split dim} of the tensors a model rank holds a slice of: the
    placement's, plus each column-parallel layer's bias (dim 0) where its
    weight is split."""
    place = megatron_placement(shapes, model)
    dims = {n: d for n, d in place.items() if d is not None}
    for name, d in place.items():
        if d == 0 and _layer(name)[0] in COL_PARALLEL:
            bias = name[:-len("weight")] + "bias"
            if bias in shapes:
                dims[bias] = 0
    return dims


def shard_state_dict(state_dict: Mapping[str, torch.Tensor], model: int,
                     index: int) -> Dict[str, torch.Tensor]:
    """Model rank ``index``'s tensors of a whole denoiser ``state_dict``:
    slice ``index`` of ``model`` equal ones on each split dim, the rest as
    they are."""
    dims = shard_dims({k: v.shape for k, v in state_dict.items()}, model)
    return {k: (v.chunk(model, dims[k])[index].contiguous() if k in dims else v)
            for k, v in state_dict.items()}


def gather_state_dict(state_dict: Mapping[str, torch.Tensor], dims: Mapping[str, int],
                      group=None) -> Dict[str, torch.Tensor]:
    """The whole tensors from every model rank's ``state_dict`` (split on
    ``dims``): one all-gather over ``group`` of the split tensors, packed
    flat in one dtype at a time, then each cut out and joined on its dim.
    Exact (no arithmetic). Without a group, or with nothing split, returns
    ``state_dict`` as it is."""
    out = dict(state_dict)
    split = [k for k in state_dict if k in dims]
    if not split or not dist.is_initialized():
        return out
    size = dist.get_world_size(group)
    for dtype in sorted({state_dict[k].dtype for k in split}, key=str):
        names = [k for k in split if state_dict[k].dtype == dtype]
        flat = torch.cat([state_dict[k].detach().reshape(-1) for k in names])
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat, group=group)
        offset = 0
        for k in names:
            local = state_dict[k]
            n = local.numel()
            out[k] = torch.cat([p[offset:offset + n].view(local.shape) for p in parts],
                               dim=dims[k])
            offset += n
    return out


class ModelAxis:
    """This rank's place on the model axis (its group, their count, its
    index) and the collectives over it, with their counts and bytes."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        self.counts = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0,
                       "all_gather_bytes": 0}

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group, in place."""
        self.counts["all_reduce"] += 1
        self.counts["all_reduce_bytes"] += t.numel() * t.element_size()
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, joined on the last dim in rank order."""
        self.counts["all_gather"] += 1
        self.counts["all_gather_bytes"] += t.numel() * t.element_size() * self.size
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """f: identity forward, all-reduce backward."""
        return _CopyToModel.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """g: all-reduce forward, identity backward."""
        return _ReduceFromModel.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All-gather of the feature slices forward, the rank's slice backward."""
        return _GatherFromModel.apply(x, self)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce_(grad.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_gather_last(x)

    @staticmethod
    def backward(ctx, grad):
        a = ctx.axis
        return grad.chunk(a.size, dim=-1)[a.index].contiguous(), None


def _shard_param(p: torch.Tensor, axis: ModelAxis, dim: Optional[int]) -> nn.Parameter:
    t = p.detach() if dim is None else p.detach().chunk(axis.size, dim)[axis.index]
    return nn.Parameter(t.clone(), requires_grad=p.requires_grad)


class ColumnParallelLinear(nn.Linear):
    """A ``Linear``'s slice of outputs: the rows of its weight and the
    entries of its bias that are model rank i's. Its input is the same on
    every rank of the group (the caller applies f)."""

    def __init__(self, src: nn.Linear, axis: ModelAxis):
        out = src.out_features // axis.size
        super().__init__(src.in_features, out, bias=src.bias is not None, device="meta")
        self.weight = _shard_param(src.weight, axis, 0)
        if src.bias is not None:
            self.bias = _shard_param(src.bias, axis, 0)


class RowParallelLinear(nn.Linear):
    """A ``Linear``'s slice of inputs: the columns of its weight that are
    model rank i's; the bias whole, added after g sums the slices' products."""

    def __init__(self, src: nn.Linear, axis: ModelAxis):
        super().__init__(src.in_features // axis.size, src.out_features,
                         bias=src.bias is not None, device="meta")
        self.weight = _shard_param(src.weight, axis, 1)
        if src.bias is not None:
            self.bias = _shard_param(src.bias, axis, None)
        self.axis = axis

    def forward(self, x):
        y = self.axis.reduce(F.linear(x, self.weight))
        return y if self.bias is None else y + self.bias


def _embedding(src: nn.Embedding, axis: ModelAxis) -> nn.Embedding:
    e = nn.Embedding(src.num_embeddings, src.embedding_dim // axis.size, device="meta")
    e.weight = _shard_param(src.weight, axis, 1)
    return e


class _ContentEmbedding(ContentEmbedding):
    """The token and position tables split on D: the local sum, then one
    all-gather (bare position parameters stay whole and add after it)."""

    def __init__(self, src: ContentEmbedding, axis: ModelAxis):
        nn.Module.__init__(self)
        self.num_embed, self.spatial_size = src.num_embed, src.spatial_size
        self.emb = _embedding(src.emb, axis)
        for name in ("height_emb", "width_emb"):
            e = getattr(src, name)
            setattr(self, name, _embedding(e, axis) if isinstance(e, nn.Embedding)
                    else _shard_param(e, axis, None))
        self.axis = axis

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        tok = self.emb(index.clamp(min=0))
        h, w = (e if isinstance(e, torch.Tensor) else e.weight
                for e in (self.height_emb, self.width_emb))
        pos = (h[:, None, :] + w[None, :, :]).reshape(1, -1, h.shape[-1])
        pos = pos[:, : tok.shape[1], :].to(tok.dtype)
        if pos.shape[-1] == tok.shape[-1]:
            return self.axis.gather(tok + pos)
        return self.axis.gather(tok) + pos


class _AdaLayerNorm(AdaLayerNorm):
    """AdaLN with its timestep table split on D, all-gathered after the lookup."""

    def __init__(self, src: AdaLayerNorm, axis: ModelAxis):
        nn.Module.__init__(self)
        self.diffusion_step = src.diffusion_step
        self.split = isinstance(src.emb, nn.Embedding)
        self.emb = _embedding(src.emb, axis) if self.split else copy.deepcopy(src.emb)
        self.linear = copy.deepcopy(src.linear)
        self.layernorm = copy.deepcopy(src.layernorm)
        self.axis = axis

    def modulation(self, t: torch.Tensor) -> torch.Tensor:
        e = self.emb(t)
        if self.split:
            e = self.axis.gather(e)
        return self.linear(nn.functional.silu(e.to(self.linear.weight.dtype)))


class _Attention(nn.Module):
    """``MultiHeadAttention`` over this rank's contiguous group of heads:
    q / k / v column-parallel, ``proj`` row-parallel."""

    def __init__(self, src: MultiHeadAttention, axis: ModelAxis):
        super().__init__()
        self.n_head = src.n_head // axis.size
        for name in ("query", "key", "value"):
            setattr(self, name, ColumnParallelLinear(getattr(src, name), axis))
        self.proj = RowParallelLinear(src.proj, axis)
        self.attn_drop = copy.deepcopy(src.attn_drop)
        self.resid_drop = copy.deepcopy(src.resid_drop)
        self.axis = axis

    def forward(self, x, kv, *, kv_cache=None):
        if kv_cache is not None:
            raise ValueError("a model-parallel attention projects its own keys and values")
        B, L, _ = x.shape
        S = kv.shape[1]
        xf = self.axis.copy(x)
        kvf = xf if kv is x else self.axis.copy(kv)
        q = self.query(xf)
        hd = q.shape[-1] // self.n_head
        q = q.reshape(B, L, self.n_head, hd).transpose(1, 2)
        k = self.key(kvf).reshape(B, S, self.n_head, hd)
        v = self.value(kvf).reshape(B, S, self.n_head, hd)
        att = (q @ k.permute(0, 2, 3, 1)) / math.sqrt(hd)
        att = self.attn_drop(torch.softmax(att.float(), dim=-1).to(x.dtype))
        y = (att @ v.transpose(1, 2)).transpose(1, 2).reshape(B, L, -1)
        return self.resid_drop(self.proj(y))


class _MLP(nn.Sequential):
    """fc1 column-parallel (f at its input), the activation on the slice,
    fc2 row-parallel; the names stay ``mlp.0`` ... ``mlp.3``."""

    def __init__(self, src: nn.Sequential, axis: ModelAxis):
        fc1, act, fc2, drop = src
        super().__init__(ColumnParallelLinear(fc1, axis), copy.deepcopy(act),
                         RowParallelLinear(fc2, axis), copy.deepcopy(drop))
        self.axis = axis

    def forward(self, x):
        return super().forward(self.axis.copy(x))


class MegatronText2Spec(Text2SpecTransformer):
    """A ``Text2SpecTransformer`` split over a mesh's model axis (module
    docstring), built from a whole one that every rank holds alike. Its
    ``state_dict`` names are the whole model's, its tensors this rank's
    (``split_dims`` says which are slices, and of which dim). The forward is
    the whole model's: token ids, condition and t in, the whole logits out,
    the same on every rank of the model group. ``full_state_dict`` gathers
    the whole weights."""

    def __init__(self, den: Text2SpecTransformer, mesh):
        nn.Module.__init__(self)
        heads = den.blocks[0].attn1.n_head if len(den.blocks) else 0
        if mesh.model < 2 or heads % mesh.model:
            raise ValueError(f"a model axis of {mesh.model} does not split {heads} heads")
        if den.checkpoint:
            raise ValueError("activation checkpointing is not supported on a model axis")
        self.axis = axis = ModelAxis(mesh.model_group, mesh.model, mesh.model_index)
        self.checkpoint = False
        self.content_emb = _ContentEmbedding(den.content_emb, axis)
        blocks = []
        for src in den.blocks:        # SelfCrossBlock's children, in its order
            blk = SelfCrossBlock.__new__(SelfCrossBlock)
            nn.Module.__init__(blk)
            blk.ln1 = _AdaLayerNorm(src.ln1, axis)
            blk.ln1_1 = _AdaLayerNorm(src.ln1_1, axis)
            blk.attn1 = _Attention(src.attn1, axis)
            blk.attn2 = _Attention(src.attn2, axis)
            blk.ln2 = copy.deepcopy(src.ln2)
            blk.mlp = _MLP(src.mlp, axis)
            blocks.append(blk)
        self.blocks = nn.ModuleList(blocks)
        self.to_logits = copy.deepcopy(den.to_logits)
        whole = den.state_dict()
        self.split_dims = shard_dims({k: v.shape for k, v in whole.items()}, mesh.model)
        want = {k: v.shape for k, v in shard_state_dict(whole, mesh.model, 0).items()}
        got = {k: v.shape for k, v in self.state_dict().items()}
        if got != want:
            raise ValueError("the split denoiser's tensors differ from the placement's: "
                             + ", ".join(k for k in want if got.get(k) != want[k]))

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole denoiser's ``state_dict``, gathered over the model group."""
        return gather_state_dict(self.state_dict(), self.split_dims, self.axis.group)

    def full_grads(self) -> Dict[str, torch.Tensor]:
        """Every parameter's gradient, the split ones gathered whole."""
        return gather_state_dict({n: p.grad for n, p in self.named_parameters()},
                                 self.split_dims, self.axis.group)

    def sharded_mask(self, names: Sequence[str]) -> List[bool]:
        """Which of the named tensors are slices (the others replicated)."""
        return [n in self.split_dims for n in names]


def megatron_denoiser(den: nn.Module, mesh) -> nn.Module:
    """``den`` split over ``mesh``'s model axis (``MegatronText2Spec``), or
    ``den`` itself at a model axis of 1. Only a ``Text2SpecTransformer``
    splits: the class-conditional and unconditional denoisers raise
    ``ValueError`` above 1 (no JAX path runs them on one)."""
    if mesh.model == 1:
        return den
    if not isinstance(den, Text2SpecTransformer) or not all(
            isinstance(b, SelfCrossBlock) for b in den.blocks):
        raise ValueError(f"{type(den).__name__} does not run on a model axis "
                         f"(only Text2SpecTransformer splits)")
    return MegatronText2Spec(den, mesh)
