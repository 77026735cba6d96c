"""The AR baseline's compute dtype: the port's ``Net2NetTransformer(dtype=
bfloat16)`` against the JAX package's on the same weights (bridged by
``convert.from_jax.load_net2net``, perturbed so that the zero-initialised
``pos_emb`` and biases reach the output), its greedy tokens, the f32
default, and a bf16 train step that keeps the parameters, gradients and
AdamW moments in f32. Sizes are ``tests/test_torch_gpt.py``'s Net2Net
(vocab 10, block 17, 2 layers, d16, a 2 x 8 grid)."""

import copy
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.models import gpt as jgpt
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models import gpt as tgpt
from text_to_sound_synthesis_torch.models.gpt.model import ar_sample
from text_to_sound_synthesis_torch.tools import train_ar

torch.set_num_threads(1)

# bf16 logits of two layers at d16: each side rounds every op's output to
# bf16 (8 bits of mantissa); the two orders of rounding and two libraries'
# erf / rsqrt part by a few ulps of the logits' scale (|logit| <= 3.2):
# measured 0.043 against JAX, 0.033 against the port's f32 model; the gate,
# 0.1, is 6 ulps at 2. The same bound holds the bf16 port to its f32 model.
BF16_ATOL = 0.1
DDCONFIG = dict(double_z=False, z_channels=16, resolution=16, in_channels=1, out_ch=1, ch=8,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], dropout=0.0)


def _cfg(pfx):
    return dict(
        transformer_config={"params": {
            "feat_embedding_config": {"target": "torch.nn.Conv1d",
                                      "params": {"in_channels": 8, "out_channels": 16,
                                                 "kernel_size": 1}},
            "GPT_config": dict(vocab_size=10, block_size=17, n_layer=2, n_head=2, n_embd=16)}},
        first_stage_config={"target": f"{pfx}.models.vqgan.VQModel",
                            "params": {"embed_dim": 16, "n_embed": 10, "ddconfig": DDCONFIG}},
        first_stage_permuter_config={"target": f"{pfx}.ops.permuter.ColumnMajor",
                                     "params": {"H": 2, "W": 8}})


@lru_cache(maxsize=None)
def _params():
    jm = jgpt.Net2NetTransformer(**_cfg("text_to_sound_synthesis_tpu"))
    init = jax.jit(jm.init_params, static_argnames=("mel_shape", "cond_shape"))
    p = init(jax.random.PRNGKey(0), mel_shape=(1, 4, 16, 1), cond_shape=(1, 8, 1))
    rng = np.random.default_rng(5)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), p)


def _port(dtype):
    m = tgpt.Net2NetTransformer(**_cfg("text_to_sound_synthesis_torch"), dtype=dtype)
    return from_jax.load_net2net(m, _params())


def _inputs():
    rng = np.random.default_rng(10)
    return (rng.uniform(-1, 1, (2, 4, 16, 1)).astype(np.float32),
            rng.standard_normal((2, 8, 1)).astype(np.float32))


def test_bf16_loss_logits_match_jax():
    """The JAX module with ``dtype=bfloat16`` (eager: under ``jit`` XLA fuses
    bf16 roundings away) and the port's on the same f32 weights. The bf16
    codec's tokens may part at a codebook near-tie (1 of 32 here): at least
    90 % equal. On JAX's tokens the GPT's logits lie within ``BF16_ATOL``
    and the loss within 1e-2 relative."""
    jm = jgpt.Net2NetTransformer(**_cfg("text_to_sound_synthesis_tpu"), dtype=jnp.bfloat16)
    port = _port("bfloat16")
    assert port.dtype == torch.bfloat16 and port.gpt.dtype == torch.bfloat16
    mel, feats = _inputs()
    p = _params()
    z = np.asarray(jm.encode_to_z(p, jnp.asarray(mel)))
    assert (port.encode_to_z(torch.from_numpy(mel)).numpy() == z).mean() >= 0.9
    z_in = jnp.asarray(z[:, :-1])
    logits = jm.gpt.apply(p["gpt"], z_in, jnp.asarray(feats))[:, -z.shape[1]:]
    loss = jnp.mean(-jnp.take_along_axis(jax.nn.log_softmax(logits.astype(jnp.float32)),
                                         jnp.asarray(z)[..., None], -1))
    got_loss, got_logits = port.token_loss(torch.tensor(z).long(), torch.from_numpy(feats))
    assert got_logits.dtype == torch.bfloat16 and logits.dtype == jnp.bfloat16
    np.testing.assert_allclose(got_logits.float().detach().numpy(),
                               np.asarray(logits, np.float32), atol=BF16_ATOL)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-2)
    # and the bf16 logits stay within the same bound of the f32 model's
    _, f32_logits = _port(torch.float32).token_loss(torch.tensor(z).long(),
                                                    torch.from_numpy(feats))
    np.testing.assert_allclose(got_logits.float().detach().numpy(),
                               f32_logits.detach().numpy(), atol=BF16_ATOL)


def test_bf16_greedy_tokens_equal_or_part_at_a_near_tie():
    """Greedy (top-1) cached sampling, JAX's ``ar_sample`` in bf16 against the
    port's: the tokens are equal, or the first that differs is a near-tie of
    the f32 model's logits on the shared prefix (top-2 margin within
    2 x ``BF16_ATOL``). The port's KV cache is bf16."""
    jm = jgpt.Net2NetTransformer(**_cfg("text_to_sound_synthesis_tpu"), dtype=jnp.bfloat16)
    port = _port("bfloat16")
    assert port.gpt.init_cache(2)[0].k.dtype == torch.bfloat16
    _, feats = _inputs()
    p = _params()
    want = np.asarray(jgpt.ar_sample(jm.gpt, p["gpt"], jax.random.PRNGKey(0),
                                     jnp.asarray(feats), steps=16, top_k=1))
    got = ar_sample(port.gpt, torch.from_numpy(feats), steps=16, top_k=1,
                    generator=torch.Generator().manual_seed(0)).numpy()
    f32 = _port(torch.float32)
    for b in range(2):
        diff = np.flatnonzero(want[b] != got[b])
        if diff.size:
            t = int(diff[0])
            prefix = torch.from_numpy(got[b:b + 1, :t].astype(np.int64))
            logits = f32.gpt(prefix, torch.from_numpy(feats[b:b + 1]))[0, -1].detach()
            top2 = torch.topk(logits, 2).values
            assert float(top2[0] - top2[1]) <= 2 * BF16_ATOL, (b, t)


def _composed(g, idx, feats):
    """``GPTFeats``' forward composed by hand from its modules, in the dtype
    their weights are stored in."""
    with torch.no_grad():
        x = torch.cat([g.embedder(feats.transpose(1, 2).to(g.head.weight.dtype)),
                       g.tok_emb(idx)], dim=1)
        x = x + g.pos_emb[:, : x.shape[1]]
        for blk in g.blocks:
            x = x + blk.attn(blk.ln1(x))
            x = x + blk.mlp(blk.ln2(x))
        return g.head(g.ln_f(x))


def test_f32_default_computes_as_before():
    """The default dtype is f32: no copies are made, and the forward is bit
    for bit the modules composed by hand (the f32 path of the parent)."""
    port = _port(torch.float32)
    assert port.dtype == torch.float32 and port.gpt.dtype == torch.float32
    mel, feats = _inputs()
    z = port.encode_to_z(torch.from_numpy(mel))
    _, logits = port.token_loss(z, torch.from_numpy(feats))
    g = port.gpt
    assert torch.equal(logits.detach(), _composed(g, z[:, :-1], torch.from_numpy(feats)))
    assert not port._compute_copies and not g._compute_copies
    assert g.init_cache(1)[0].k.dtype == torch.float32


def test_bf16_computes_on_bf16_weights():
    """bf16 compute is a forward on the weights rounded to bf16, not f32
    compute rounded at the end (``BF16_ATOL`` cannot tell the two apart):
    the logits are bit for bit the modules composed by hand on a copy of the
    GPT stored in bf16, and differ from the f32 forward rounded to bf16."""
    port = _port("bfloat16")
    mel, feats = _inputs()
    z = port.encode_to_z(torch.from_numpy(mel))
    _, logits = port.token_loss(z, torch.from_numpy(feats))
    stored = copy.deepcopy(port.gpt).to(torch.bfloat16)
    want = _composed(stored, z[:, :-1], torch.from_numpy(feats))
    assert want.dtype == torch.bfloat16
    assert torch.equal(logits.detach(), want)
    f32 = _composed(_port(torch.float32).gpt, z[:, :-1], torch.from_numpy(feats))
    assert not torch.equal(logits.detach(), f32.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_step_keeps_f32_state(dtype):
    """A step of ``train_ar.train_step`` (AdamW) in bf16 compute: the
    parameters, their gradients and AdamW's moments stay f32 and move; the
    frozen codec is unchanged."""
    port = _port(dtype)
    port.codec.requires_grad_(False).eval()
    codec_before = {k: v.clone() for k, v in port.codec.state_dict().items()}
    before = {k: v.detach().clone() for k, v in port.gpt.named_parameters()}
    opt = train_ar.build_optimizer(port, 1e-3)
    mel, feats = _inputs()
    loss = train_ar.train_step(port, opt, torch.from_numpy(mel), torch.from_numpy(feats))
    assert torch.isfinite(loss)
    for k, v in port.gpt.named_parameters():
        assert v.dtype == torch.float32 and v.grad.dtype == torch.float32, k
        st = opt.state[v]
        assert st["exp_avg"].dtype == torch.float32 and st["exp_avg_sq"].dtype == torch.float32
    moved = [k for k, v in port.gpt.named_parameters() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)
    for k, v in port.codec.state_dict().items():
        assert torch.equal(v, codec_before[k]), k


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_bf16_recurrent_embedders_read_their_copies(kind):
    """A recurrent feature embedder in bf16 compute runs on the bf16 copies
    ``compute_weights`` lends it (torch's RNNs rebuild their flat weight list
    when a weight is swapped), and stays within ``BF16_ATOL`` of the f32
    model's logits on the same weights."""
    emb = {"target": f"torch.nn.{kind}", "params": {"input_size": 8, "hidden_size": 16}}
    gcfg = dict(vocab_size=10, block_size=17, n_layer=2, n_head=2, n_embd=16)
    f32 = tgpt.GPTFeats(feat_embedding_config=emb, GPT_config=gcfg)
    from text_to_sound_synthesis_torch.utils.init import init_random_
    init_random_(f32, torch.Generator().manual_seed(0))
    bf16 = tgpt.GPTFeats(feat_embedding_config=emb, GPT_config=gcfg, dtype="bfloat16")
    bf16.load_state_dict(f32.state_dict())
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((2, 8, 3)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 10, (2, 5)))
    with torch.no_grad():
        want, got = f32(idx, feats), bf16(idx, feats)
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=BF16_ATOL)
    # bit for bit the modules composed by hand on a copy stored in bf16
    assert torch.equal(got, _composed(copy.deepcopy(bf16).to(torch.bfloat16), idx, feats))
