"""Per-layer activation checkpointing of the port's ``Text2SpecTransformer``
(``checkpoint=True``, the counterpart of JAX's ``nn.remat`` per block):
the loss and every gradient bit for bit the plain pass's, at dropout 0 and
at dropout 0.1 under one seed (the recompute replays the dropout's random
state), in f32 and in a bf16 ``Diffsound``'s training loss; both within the
Stage-2 train tests' tolerance of JAX's ``Text2SpecTransformer(checkpoint=
True)`` on the same weights (the loss within rtol 1e-5, each gradient within
1e-4 of its tensor's largest magnitude or 1e-7 of the largest of all,
``tests/_torch_tiny.py::assert_grads_close``). Sizes: 2 layers of d32, 2
heads, 16 tokens of 10 codes + MASK, 4 steps, a condition of 5 x 8."""

import copy
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from text_to_sound_synthesis_tpu.models.diffusion.backbone import (
    Text2SpecTransformer as JText2Spec)
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.models.diffusion.backbone import Text2SpecTransformer

from tests._torch_tiny import TRAIN_CFG, assert_grads_close, batch, tbatch

torch.set_num_threads(1)

CFG = dict(n_layer=2, n_embd=32, n_head=2, content_seq_len=16, condition_dim=8,
           diffusion_step=4, content_spatial_size=(2, 8),
           content_emb_config={"params": dict(num_embed=10, embed_dim=32, spatial_size=(2, 8))})
B, S = 3, 5


def _inputs():
    rng = np.random.default_rng(3)
    return (rng.integers(0, 11, (B, 16)).astype(np.int32),
            rng.standard_normal((B, S, 8)).astype(np.float32),
            rng.integers(0, 4, (B,)).astype(np.int32),
            rng.integers(0, 10, (B, 16)).astype(np.int32))


@lru_cache(maxsize=None)
def _jax_params():
    tokens, cond, t, _ = _inputs()
    p = JText2Spec(**CFG).init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(cond),
                               jnp.asarray(t))
    rng = np.random.default_rng(1)    # nonzero biases and positions
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), p)


def _port(checkpoint, pdrop=0.0):
    m = Text2SpecTransformer(**CFG, checkpoint=checkpoint, attn_pdrop=pdrop, resid_pdrop=pdrop)
    return from_jax.load_denoiser(m, _jax_params())


def _loss_and_grads(model, seed=0):
    tokens, cond, t, target = (torch.from_numpy(a).long() if a.dtype == np.int32
                               else torch.from_numpy(a) for a in _inputs())
    model.zero_grad(set_to_none=True)
    torch.manual_seed(seed)
    logits = model(tokens, cond, t)
    loss = torch.nn.functional.cross_entropy(logits.transpose(1, 2), target)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("pdrop", [0.0, 0.1])
def test_checkpoint_is_bit_for_bit_the_plain_pass(pdrop):
    plain, remat = _port(False, pdrop).train(), _port(True, pdrop).train()
    want_loss, want = _loss_and_grads(plain)
    got_loss, got = _loss_and_grads(remat)
    assert torch.equal(got_loss, want_loss)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if pdrop:       # the dropout acts: another seed, another loss
        assert not torch.equal(_loss_and_grads(remat, seed=1)[0], want_loss)


def test_checkpoint_recomputes_only_under_autograd(monkeypatch):
    """Under ``no_grad`` the blocks run plainly; with gradients on, each
    block goes through ``torch.utils.checkpoint`` once."""
    import text_to_sound_synthesis_torch.models.diffusion.backbone as bb

    calls = []
    real = bb._recompute
    monkeypatch.setattr(bb, "_recompute", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    model = _port(True)
    tokens, cond, t, _ = _inputs()
    args = (torch.from_numpy(tokens).long(), torch.from_numpy(cond), torch.from_numpy(t).long())
    with torch.no_grad():
        y0 = model(*args)
    assert calls == []
    y1 = model(*args)
    assert calls == [{"use_reentrant": False}] * CFG["n_layer"]
    assert torch.equal(y0, y1.detach())


@pytest.mark.parametrize("checkpoint", [False, True])
def test_loss_and_gradients_match_jax_remat(checkpoint):
    tokens, cond, t, target = _inputs()
    jm = JText2Spec(**CFG, checkpoint=True)
    p = _jax_params()

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(tokens), jnp.asarray(cond), jnp.asarray(t))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(target)).mean()

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p)
    model = _port(checkpoint)
    got_loss, _ = _loss_and_grads(model)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    want = from_jax.denoiser_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    assert_grads_close(model, want, f"checkpoint={checkpoint}")


def test_bf16_training_loss_with_checkpoint_is_bit_for_bit():
    """A bf16 ``Diffsound``'s training loss (the denoiser on bf16 copies of
    its f32 weights, lent by ``compute_weights`` for the forward only): with
    the denoiser's ``checkpoint`` set, the recompute in the backward reads
    the same copies, and the loss and the f32 gradients are the plain
    pass's bit for bit."""
    cfg = copy.deepcopy(TRAIN_CFG)
    cfg["params"]["dtype"] = "bfloat16"
    b = tbatch(batch(1))
    t = torch.tensor([0, 1, 2, 3])
    pt = torch.full((4,), 0.25)
    out = []
    for checkpoint in (False, True):
        model = build_model(cfg, device="cpu", seed=0, load_codec=False)
        den = model.diffusion.transformer
        den.checkpoint = checkpoint
        gumbel = torch.from_numpy(np.random.default_rng(2).gumbel(size=(4, 16, 11))
                                  .astype(np.float32))
        loss = model.loss(b["image"], b["condition_token"], t, pt, gumbel=gumbel).loss
        loss.backward()
        out.append((loss.detach(), {n: p.grad.clone() for n, p in den.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for k in g0:
        assert g1[k].dtype == torch.float32 and torch.equal(g0[k], g1[k]), k
