"""The port's AR baseline against the JAX package's: the GPT (full forward,
the n_unmasked prefix, cached decode), every feature embedder, the class
variants, ``ar_sample`` and ``Net2NetTransformer``'s loss, on the same numpy
inputs and the JAX init bridged by ``convert.from_jax`` (perturbed, so that
the zero-initialised ``pos_emb`` and biases reach the output), f32 both sides.
Sizes are ``tests/test_gpt.py``'s (vocab 12, block 18, 2 layers, d16)."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.convert.torch_to_jax import convert_rnn_embedder
from text_to_sound_synthesis_tpu.models import gpt as jgpt
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models import gpt as tgpt
from text_to_sound_synthesis_torch.models.gpt.model import RNNEmbedder

torch.set_num_threads(1)

# tests/test_gpt.py holds the JAX cached decode to its full forward within 2e-5
ATOL = 2e-5
GCFG = dict(vocab_size=12, block_size=18, n_layer=2, n_head=2, n_embd=16)
EMBEDDERS = {
    "conv1d": {"target": "torch.nn.Conv1d",
               "params": {"in_channels": 8, "out_channels": 16, "kernel_size": 1}},
    "conv1d_k3": {"target": "torch.nn.Conv1d",
                  "params": {"in_channels": 8, "out_channels": 16, "kernel_size": 3,
                             "padding": 1}},
    "linear": {"target": "torch.nn.Linear", "params": {"in_features": 8, "out_features": 16}},
    "identity": {"target": "torch.nn.Identity"},
    "lstm": {"target": "torch.nn.LSTM",
             "params": {"input_size": 8, "hidden_size": 16, "num_layers": 2}},
    "gru": {"target": "torch.nn.GRU",
            "params": {"input_size": 8, "hidden_size": 16, "num_layers": 2}},
}


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@lru_cache(maxsize=None)
def _gpt(n_unmasked=0):
    jm = jgpt.GPT(**GCFG, n_unmasked=n_unmasked)
    p = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32)), 0)
    return jm, p, from_jax.load_gpt(tgpt.GPT(**GCFG, n_unmasked=n_unmasked), p)


def _feats_pair(kind):
    emb = EMBEDDERS[kind]
    width = 16 if kind == "identity" else 8
    jm = jgpt.GPTFeats(feat_embedding_config=emb, GPT_config=GCFG)
    feats = np.random.default_rng(5).standard_normal((2, width, 3)).astype(np.float32)
    p = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.zeros((2, 4), jnp.int32),
                           jnp.asarray(feats)), 1)
    port = from_jax.load_gpt(tgpt.GPTFeats(feat_embedding_config=emb, GPT_config=GCFG), p)
    return jm, p, port, feats


@pytest.mark.parametrize("prefix", [0, 3])
@pytest.mark.parametrize("n_unmasked", [0, 3])
def test_gpt_forward_matches_jax(prefix, n_unmasked):
    """The full forward with and without a prepended embedding, causal and
    with minGPT's unmasked [:n, :n] prefix."""
    jm, p, port = _gpt(n_unmasked)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 12, (2, 7)).astype(np.int32)
    emb = rng.standard_normal((2, prefix, 16)).astype(np.float32) if prefix else None
    want = np.asarray(jm.apply(p, jnp.asarray(idx), None if emb is None else jnp.asarray(emb)))
    with torch.no_grad():
        got = port(_t(idx).long(), None if emb is None else _t(emb)).numpy()
    assert got.shape == (2, prefix + 7, 12)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n_unmasked", [0, 3])
def test_cached_decode_matches_full_forward_and_jax(n_unmasked):
    """``decode_prefix`` then ``decode_token`` equal the full forward's logits
    from position Tc - 1 on, and JAX's same calls on the same cache steps;
    the cache keeps its (B, block, H, hd) shape and is written in place."""
    jm, p, port = _gpt(n_unmasked)
    rng = np.random.default_rng(3)
    Tc = 3
    emb = rng.standard_normal((2, Tc, 16)).astype(np.float32)
    idx = rng.integers(0, 12, (2, 5)).astype(np.int32)
    with torch.no_grad():
        full = port(_t(idx).long(), _t(emb)).numpy()
        cache = port.init_cache(2)
        k0 = cache[0].k
        logits, cache = port.decode_prefix(_t(emb), cache)
        got = [logits.numpy()]
        for t in range(5):
            logits, cache = port.decode_token(_t(idx[:, t]).long(), cache, Tc + t)
            got.append(logits.numpy())
    assert cache[0].k is k0 and k0.shape == (2, 18, 2, 8)
    got = np.stack(got, 1)
    np.testing.assert_allclose(got, full[:, Tc - 1:], atol=ATOL)
    jcache = jm.apply(p, 2, method=jm.init_cache)
    jl, jcache = jm.apply(p, jnp.asarray(emb), jcache, method=jm.decode_prefix)
    want = [np.asarray(jl)]
    for t in range(5):
        jl, jcache = jm.apply(p, jnp.asarray(idx[:, t]), jcache, Tc + t, method=jm.decode_token)
        want.append(np.asarray(jl))
    np.testing.assert_allclose(got, np.stack(want, 1), atol=ATOL)
    np.testing.assert_allclose(cache[1].v.numpy()[:, :Tc + 5], np.asarray(jcache[1].v)[:, :Tc + 5],
                               atol=ATOL)


def test_decode_embedded_steps_match_full_forward():
    """Causal prefix fed one embedding at a time (``decode_embedded``), then
    tokens, with a tensor position."""
    jm, p, port = _gpt(0)
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((2, 3, 16)).astype(np.float32)
    idx = rng.integers(0, 12, (2, 4)).astype(np.int32)
    with torch.no_grad():
        full = port(_t(idx).long(), _t(emb)).numpy()
        cache, got = port.init_cache(2), []
        for t in range(3):
            logits, cache = port.decode_embedded(_t(emb[:, t:t + 1]), cache, torch.tensor(t))
            got.append(logits.numpy())
        for t in range(4):
            logits, cache = port.decode_token(_t(idx[:, t]).long(), cache, torch.tensor(3 + t))
            got.append(logits.numpy())
    np.testing.assert_allclose(np.stack(got, 1), full, atol=ATOL)


@pytest.mark.parametrize("kind", list(EMBEDDERS))
def test_gptfeats_embedders_match_jax(kind):
    """Each feature embedder (Conv1d k1 / k3 padded, Linear, Identity, a
    two-layer LSTM and GRU) through ``GPTFeats``' forward."""
    jm, p, port, feats = _feats_pair(kind)
    idx = np.random.default_rng(6).integers(0, 12, (2, 4)).astype(np.int32)
    want = np.asarray(jm.apply(p, jnp.asarray(idx), jnp.asarray(feats)))
    with torch.no_grad():
        got = port(_t(idx).long(), _t(feats)).numpy()
    assert got.shape == (2, 3 + 4, 12)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_rnn_embedder_state_dict_round_trips_through_jax_converter(kind):
    """The port's LSTM / GRU state dict, sent through the JAX package's
    ``convert_rnn_embedder``, gives back the JAX parameters it was bridged
    from, and torch's module on it equals JAX's ``RNNEmbedder``."""
    jm = jgpt.RNNEmbedder(hidden_size=16, num_layers=2, kind=kind)
    x = np.random.default_rng(7).standard_normal((3, 6, 8)).astype(np.float32)
    p = _perturbed(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 2, 8))), 2)
    port = RNNEmbedder(8, 16, 2, kind)
    port.load_state_dict({k: _t(v) for k, v in from_jax.rnn_embedder_state_dict(p).items()})
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    back = convert_rnn_embedder(sd, jax.tree_util.tree_map(np.zeros_like, p), kind=kind)
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    want, got = flat(p), flat(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), want[k], atol=1e-6, err_msg=str(k))
    with torch.no_grad():
        y = port(_t(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jm.apply(p, jnp.asarray(x))), atol=ATOL)


def test_gptclass_matches_jax():
    tcfg = {"params": {"num_embeddings": 5, "features": 16}}
    jm = jgpt.GPTClass(token_embedding_config=tcfg, GPT_config=GCFG)
    cls = np.asarray([1, 4], np.int32)
    idx = np.random.default_rng(8).integers(0, 12, (2, 4)).astype(np.int32)
    p = _perturbed(jm.init(jax.random.PRNGKey(3), jnp.asarray(idx), jnp.asarray(cls)), 3)
    port = from_jax.load_gpt(tgpt.GPTClass(token_embedding_config=tcfg, GPT_config=GCFG), p)
    want = np.asarray(jm.apply(p, jnp.asarray(idx), jnp.asarray(cls)))
    with torch.no_grad():
        got = port(_t(idx).long(), _t(cls)).numpy()
        got_col = port(_t(idx).long(), _t(cls[:, None])).numpy()
    assert got.shape == (2, 1 + 4, 12)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got_col, got)


def test_gptfeatsclass_matches_jax():
    """The prefix concat(feat emb, class emb), dict and tuple forms, and
    ``ar_sample`` through it."""
    tcfg = {"params": {"num_embeddings": 5, "features": 16}}
    kw = dict(feat_embedding_config=EMBEDDERS["conv1d"], token_embedding_config=tcfg,
              GPT_config=GCFG)
    jm = jgpt.GPTFeatsClass(**kw)
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((2, 8, 3)).astype(np.float32)
    cls = np.asarray([[1], [4]], np.int32)
    idx = rng.integers(0, 12, (2, 4)).astype(np.int32)
    jcond = {"feature": jnp.asarray(feats), "target": jnp.asarray(cls)}
    p = _perturbed(jm.init(jax.random.PRNGKey(4), jnp.asarray(idx), jcond), 4)
    port = from_jax.load_gpt(tgpt.GPTFeatsClass(**kw), p)
    want = np.asarray(jm.apply(p, jnp.asarray(idx), jcond))
    with torch.no_grad():
        got = port(_t(idx).long(), {"feature": _t(feats), "target": _t(cls)}).numpy()
        emb_tuple = port.embed_feats((_t(feats), _t(cls[:, 0]))).numpy()
        tokens = tgpt.ar_sample(port, {"feature": _t(feats), "target": _t(cls)}, steps=5, top_k=1)
    assert got.shape == (2, 3 + 1 + 4, 12)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(emb_tuple, np.asarray(jm.apply(p, jcond, method=jm.embed_feats)),
                               atol=ATOL)
    jtok = jgpt.ar_sample(jm, p, jax.random.PRNGKey(0), jcond, steps=5, top_k=1)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("kind", ["conv1d", "lstm"])
def test_ar_sample_greedy_equals_jax_and_topk_support(kind):
    """Greedy (top-k 1) tokens equal JAX's on the same weights; at top-k 3
    every token lies in the top 3 of its step's logits, recomputed by one
    full forward of the emitted sequence."""
    jm, p, port, feats = _feats_pair(kind)
    jtok = np.asarray(jgpt.ar_sample(jm, p, jax.random.PRNGKey(0), jnp.asarray(feats),
                                     steps=10, top_k=1))
    tok = tgpt.ar_sample(port, _t(feats), steps=10, top_k=1)
    assert tok.shape == (2, 10)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    tok = tgpt.ar_sample(port, _t(feats), steps=10, top_k=3,
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = port(tok[:, :-1], _t(feats))[:, 3 - 1:]
    third = logits.sort(dim=-1, descending=True).values[..., 2]
    assert bool((logits.gather(-1, tok[..., None])[..., 0] >= third).all())
    assert ((tok >= 0) & (tok < 12)).all()


# -- Net2Net -----------------------------------------------------------------

DDCONFIG = dict(double_z=False, z_channels=16, resolution=16, in_channels=1, out_ch=1, ch=8,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], dropout=0.0)


def _net2net_cfg(pkeep=1.0, pfx="text_to_sound_synthesis_tpu"):
    return dict(
        transformer_config={"params": {
            "feat_embedding_config": EMBEDDERS["conv1d"],
            "GPT_config": dict(vocab_size=10, block_size=17, n_layer=2, n_head=2, n_embd=16)}},
        first_stage_config={"target": f"{pfx}.models.vqgan.VQModel",
                            "params": {"embed_dim": 16, "n_embed": 10, "ddconfig": DDCONFIG}},
        first_stage_permuter_config={"target": f"{pfx}.ops.permuter.ColumnMajor",
                                     "params": {"H": 2, "W": 8}},
        pkeep=pkeep)


@lru_cache(maxsize=None)
def _net2net():
    jm = jgpt.Net2NetTransformer(**_net2net_cfg())
    init = jax.jit(jm.init_params, static_argnames=("mel_shape", "cond_shape"))
    p = _perturbed(init(jax.random.PRNGKey(0), mel_shape=(1, 4, 16, 1), cond_shape=(1, 8, 1)), 5)
    port = from_jax.load_net2net(tgpt.Net2NetTransformer(**_net2net_cfg()), p)
    return jm, p, port


def _mel_feats():
    rng = np.random.default_rng(10)
    return (rng.uniform(-1, 1, (2, 4, 16, 1)).astype(np.float32),
            rng.standard_normal((2, 8, 1)).astype(np.float32))


def test_net2net_loss_matches_jax():
    """pkeep 1: the tokens, the next-token cross entropy and its logits."""
    jm, p, port = _net2net()
    mel, feats = _mel_feats()
    z = port.encode_to_z(_t(mel))
    np.testing.assert_array_equal(z.numpy(),
                                  np.asarray(jax.jit(jm.encode_to_z)(p, jnp.asarray(mel))))
    loss, logits = jax.jit(jm.loss)(p, jnp.asarray(mel), jnp.asarray(feats))
    got_loss, got_logits = port.loss(_t(mel), _t(feats))
    assert got_logits.shape == (2, 16, 10)
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(logits), atol=ATOL)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-6)


def test_net2net_pkeep_corrupts_inputs_only(monkeypatch):
    """pkeep < 1: a generator is required; an input token is replaced with
    probability (1 - pkeep) (n - 1) / n; the targets stay the clean tokens
    (the loss read against them)."""
    _, p, _ = _net2net()
    port = from_jax.load_net2net(tgpt.Net2NetTransformer(**_net2net_cfg(pkeep=0.3)), p)
    mel, feats = _mel_feats()
    mel = np.repeat(mel, 64, axis=0)
    feats = np.repeat(feats, 64, axis=0)
    with pytest.raises(ValueError):
        port.loss(_t(mel), _t(feats))
    seen = {}
    forward = tgpt.GPTFeats.forward

    def spy(self, idx, cond):
        seen["z_in"] = idx
        return forward(self, idx, cond)

    monkeypatch.setattr(tgpt.GPTFeats, "forward", spy)
    loss, logits = port.loss(_t(mel), _t(feats), generator=torch.Generator().manual_seed(0))
    z = port.encode_to_z(_t(mel))
    changed = float((seen["z_in"] != z[:, :-1]).float().mean())
    assert abs(changed - 0.7 * 9 / 10) < 0.03
    clean = torch.nn.functional.cross_entropy(logits.float().transpose(1, 2), z)
    assert float(loss) == float(clean)
    l_a, _ = port.loss(_t(mel), _t(feats), generator=torch.Generator().manual_seed(1))
    assert float(l_a) != float(loss)


def test_net2net_sample_and_registry():
    """``sample`` decodes (B, 4, 16, 1) mels from the greedy tokens JAX
    picks; the config's target names build the port's class."""
    from text_to_sound_synthesis_torch.utils.config import instantiate_from_config

    jm, p, port = _net2net()
    _, feats = _mel_feats()
    sample = jax.jit(lambda p, k, f: jm.sample(p, k, f, (2, 8), top_k=1))
    want = np.asarray(sample(p, jax.random.PRNGKey(0), jnp.asarray(feats)))
    got = port.sample(_t(feats), (2, 8), top_k=1).numpy()
    assert got.shape == (2, 4, 16, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)
    for target in ("text_to_sound_synthesis_tpu.models.gpt.Net2NetTransformer",
                   "specvqgan.models.cond_transformer.Net2NetTransformer"):
        m = instantiate_from_config({"target": target, "params": _net2net_cfg()})
        assert type(m) is tgpt.Net2NetTransformer and type(m.gpt) is tgpt.GPTFeats
