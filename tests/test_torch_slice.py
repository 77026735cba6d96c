"""The port's bf16-path slice as a whole: BPE ids -> CLIP -> sampler -> VQGAN
-> MelGAN, against the JAX package.

The JAX side is a tiny Diffsound made of the JAX sub-modules (the JAX
``build_model`` needs the CLIP BPE table, which is absent) driven by a loop
built only from the JAX package's public pieces: ``_timestep_plan``,
``ada_tables``, ``cond_kvs``, ``backbone_logits``, ``step_coeffs``,
``p_sample_from_indices(return_log_probs=True)`` + argmax over the same
Gumbel noise, and ``Diffsound.decode_tokens``. The port runs
``build_model`` -> ``convert.from_jax.load_diffsound`` -> ``Diffsound.generate``
with that noise supplied per step.
"""

import os
import subprocess
import sys
from functools import lru_cache, partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.convert import torch_to_jax as t2j
from text_to_sound_synthesis_tpu.models.clip.text_model import CLIPTextEmbedding as JClip
from text_to_sound_synthesis_tpu.models.diffsound import Diffsound as JDiffsound
from text_to_sound_synthesis_tpu.models.diffusion.process import (
    DiscreteDiffusion as JDiffusion, _timestep_plan)
from text_to_sound_synthesis_tpu.models.melgan.generator import MelGANGenerator as JMelGAN
from text_to_sound_synthesis_tpu.models.melgan.interface import Vocoder as JVocoder
from text_to_sound_synthesis_tpu.models.vqgan.model import VQModel as JVQModel
from text_to_sound_synthesis_tpu.ops import fused_sampler as jfs
from text_to_sound_synthesis_tpu.ops import permuter as jperm
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models import Diffsound, build_model, parse_sample_type
from text_to_sound_synthesis_torch.models.diffusion.process import OneHotDraws
from text_to_sound_synthesis_torch.models.diffusion.process import _timestep_plan as port_plan
from text_to_sound_synthesis_torch.models.melgan import MelGANGenerator, Vocoder
from text_to_sound_synthesis_torch.ops import permuter as tperm
from text_to_sound_synthesis_torch.utils.config import load_yaml_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, CTX, T_STEPS = 2, 12, 4
VQ_DD = dict(double_z=False, z_channels=16, resolution=16, in_channels=1, out_ch=1, ch=8,
             ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
CLIP_CFG = dict(num_embed=64, embed_dim=8, width=8, layers=1, heads=2, context_length=CTX)
TRANSFORMER_CFG = {"params": dict(n_layer=2, n_embd=16, n_head=2, content_seq_len=16,
                                  condition_dim=8, content_spatial_size=(2, 8))}
CONTENT_EMB_CFG = {"params": dict(num_embed=10, embed_dim=16, spatial_size=(2, 8))}
TINY_CFG = {
    "target": "text_to_sound_synthesis_tpu.models.Diffsound",
    "params": {
        "content_codec_config": {"target": "text_to_sound_synthesis_tpu.models.vqgan.VQModel",
                                 "params": {"embed_dim": 16, "n_embed": 10, "ddconfig": VQ_DD}},
        "first_stage_permuter_config": {
            "target": "text_to_sound_synthesis_tpu.ops.permuter.ColumnMajor",
            "params": {"H": 2, "W": 8}},
        "condition_codec_config": {"target": "text_to_sound_synthesis_tpu.models.clip.Tokenize",
                                   "params": {"context_length": CTX}},
        "diffusion_config": {
            "target": "text_to_sound_synthesis_tpu.models.diffusion.DiscreteDiffusion",
            "params": {
                "diffusion_step": T_STEPS,
                "transformer_config": {
                    "target": "text_to_sound_synthesis_tpu.models.diffusion.Text2SpecTransformer",
                    **TRANSFORMER_CFG},
                "condition_emb_config": {
                    "target": "text_to_sound_synthesis_tpu.models.clip.CLIPTextEmbedding",
                    "params": CLIP_CFG},
                "content_emb_config": {
                    "target": "text_to_sound_synthesis_tpu.models.diffusion.ContentEmbedding",
                    **CONTENT_EMB_CFG},
            },
        },
    },
}
# float32 both sides: the tokens must agree exactly (same noise, posteriors
# within 5e-5), the decoded mel and the wav within a few layers' rounding
ATOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@lru_cache(maxsize=None)
def _jax_slice():
    """JAX sub-modules, their params, and a JAX Diffsound used for decode_tokens."""
    jvq = JVQModel(ddconfig=VQ_DD, n_embed=10, embed_dim=16)
    jclip = JClip(**CLIP_CFG)
    jdiff = JDiffusion(transformer_config=TRANSFORMER_CFG, content_emb_config=CONTENT_EMB_CFG,
                       diffusion_step=T_STEPS)
    jgen = JMelGAN(input_size=4, ngf=4)
    k = jax.random.split(jax.random.PRNGKey(0), 4)
    params = _np({
        "codec": jax.jit(jvq.init)(k[0], jnp.zeros((1, 4, 16, 1))),
        "cond": jax.jit(jclip.init)(k[1], jnp.zeros((1, CTX), jnp.int32)),
        "diffusion": jax.jit(jdiff.init)(k[2], jnp.zeros((1, 16), jnp.int32),
                                         jnp.zeros((1, CTX, 8)), jnp.zeros((1,), jnp.int32)),
    })
    gen_params = _np(jax.jit(jgen.init)(k[3], jnp.zeros((1, 16, 4))))
    jds = object.__new__(JDiffsound)  # decode_tokens reads only these three
    jds.codec, jds.permuter, jds.token_hw = jvq, jperm.ColumnMajor(2, 8), (2, 8)
    return jclip, jdiff, jds, params, (jgen, gen_params)


@lru_cache(maxsize=None)
def _port_slice():
    _, _, _, params, (_, gen_params) = _jax_slice()
    model = from_jax.load_diffsound(build_model(TINY_CFG, device="cpu"), params)
    gen = from_jax.load_melgan_generator(MelGANGenerator(input_size=4, ngf=4), gen_params)
    return model, Vocoder(gen)


def _cond_tokens():
    toks = np.zeros((B, CTX), np.int32)
    toks[:, 0] = 62                         # SOT, a few word ids, EOT, zero padding
    toks[0, 1:4], toks[0, 4] = [5, 17, 33], 63
    toks[1, 1:7], toks[1, 7] = [9, 2, 40, 41, 3, 8], 63
    return toks


def _jax_generate(cond_tokens, noise, r, skip):
    jclip, jdiff, jds, params, (jgen, gen_params) = _jax_slice()
    dp = params["diffusion"]
    apply = lambda method, *a, **kw: jax.jit(partial(jdiff.apply, method=method, **kw))(dp, *a)
    cond_emb = jax.jit(jclip.apply)(params["cond"], jnp.asarray(cond_tokens))
    sched = jdiff.schedule()
    K = jdiff.num_classes
    ts, t_post = _timestep_plan(T_STEPS, T_STEPS, skip)
    tables = apply(jdiff.ada_tables)
    kvs = apply(jdiff.cond_kvs, cond_emb)
    tokens = jnp.full((B, 16), K - 1, jnp.int32)
    for idx, (t, tp) in enumerate(zip(np.asarray(ts), np.asarray(t_post))):
        mods = [(a[t][None], b[t][None]) for a, b in tables]
        logits = apply(jdiff.backbone_logits, tokens, cond_emb, jnp.full((B,), t, jnp.int32),
                       mods=mods, cond_kvs=kvs)
        _, post = jfs.p_sample_from_indices(logits, tokens, jfs.step_coeffs(sched, tp),
                                            jax.random.PRNGKey(0), truncation_r=r,
                                            return_log_probs=True)
        tokens = jnp.argmax(post + noise[idx], axis=-1).astype(jnp.int32)
    mel = jds.decode_tokens(params, tokens)
    wav = JVocoder(jgen, gen_params)((np.asarray(mel)[..., 0] + 1.0) / 2.0)
    return np.asarray(tokens), np.asarray(mel), wav


@pytest.mark.parametrize("sample_type", ["top0.85r", "top0.85r,fast1", ""])
def test_generate_matches_jax_slice(sample_type):
    r, _, skip, _ = parse_sample_type(sample_type)
    n_steps = len(port_plan(T_STEPS, T_STEPS, skip)[0])
    assert n_steps == len(_timestep_plan(T_STEPS, T_STEPS, skip)[0])
    noise = np.random.default_rng(1).gumbel(size=(n_steps, B, 16, 11)).astype(np.float32)
    want_tok, want_mel, want_wav = _jax_generate(_cond_tokens(), noise, r, skip)

    model, vocoder = _port_slice()
    mel, tokens = model.generate(torch.Generator().manual_seed(0),
                                 torch.from_numpy(_cond_tokens()), sample_type=sample_type,
                                 noise=torch.from_numpy(noise), return_tokens=True)
    wav = vocoder((mel[..., 0] + 1.0) / 2.0)
    np.testing.assert_array_equal(tokens.numpy(), want_tok)
    assert mel.shape == (B, 4, 16, 1) and wav.shape == (B, 16 * 256)
    np.testing.assert_allclose(mel.numpy(), want_mel, atol=ATOL)
    np.testing.assert_allclose(wav.numpy(), want_wav, atol=ATOL)


def test_generate_with_kernel_draws_is_seeded():
    """No supplied noise: draws come from (seed_base, step); seed_base from the generator."""
    model, _ = _port_slice()
    cond = torch.from_numpy(_cond_tokens())
    run = lambda seed: model.generate(torch.Generator().manual_seed(seed), cond,
                                      return_tokens=True)[1]
    a = run(0)
    assert torch.equal(a, run(0))
    assert not torch.equal(a, run(1))
    assert ((a >= 0) & (a < 10)).all()   # 100 % unmasked after the last step


def test_generate_from_partly_noised_content():
    model, _ = _port_slice()
    content = torch.from_numpy(np.random.default_rng(2).integers(0, 10, (B, 16)).astype(np.int32))
    mel, tokens = model.generate(torch.Generator().manual_seed(0),
                                 torch.from_numpy(_cond_tokens()), filter_ratio=0.5,
                                 content_tokens=content, return_tokens=True)
    assert mel.shape == (B, 4, 16, 1) and ((tokens >= 0) & (tokens < 10)).all()
    with pytest.raises(ValueError, match="out of range"):
        model.generate(torch.Generator().manual_seed(0), torch.from_numpy(_cond_tokens()),
                       filter_ratio=0.5, content_tokens=content + 20)


def _jdiffsound():
    """A JAX Diffsound over the slice's modules, for its inference methods."""
    jclip, jdiff, jds, params, _ = _jax_slice()
    j = object.__new__(JDiffsound)
    j.codec, j.permuter, j.token_hw = jds.codec, jds.permuter, jds.token_hw
    j.cond, j.diffusion = jclip, jdiff
    return j, params


def jax_draws(key, n_steps: int, start: str = "mask") -> OneHotDraws:
    """The draws the JAX one-hot ``sample_tokens`` makes from ``key``, in its
    order: a start key split off first (``uniform`` tokens or the
    ``q_sample`` start's Gumbel noise), then ``split(key, 4)`` a step for the
    step's Gumbel noise, the q-resample's coin and the resample's noise."""
    t = lambda a: torch.from_numpy(np.array(a))
    first = None
    if start == "uniform":
        key, k = jax.random.split(key)
        first = t(jax.random.randint(k, (B, 16), 0, 11 - 2))
    elif start == "q_sample":
        key, k = jax.random.split(key)
        first = t(jax.random.gumbel(k, (B, 16, 11)))
    g, coin, g2 = [], [], []
    for _ in range(n_steps):
        key, k_samp, k_q, k_samp2 = jax.random.split(key, 4)
        g.append(np.asarray(jax.random.gumbel(k_samp, (B, 16, 11))))
        coin.append(np.asarray(jax.random.uniform(k_q)))
        g2.append(np.asarray(jax.random.gumbel(k_samp2, (B, 16, 11))))
    return OneHotDraws(gumbel=t(np.stack(g)), coin=t(np.stack(coin)), gumbel2=t(np.stack(g2)),
                       start=first)


@pytest.mark.parametrize("sample_type", ["top100p", "top0.85r,q0.5"])
def test_onehot_sample_types_match_jax(sample_type):
    """Top-k and the q-resample wrapper go to the one-hot sampler by default;
    under JAX's draws the tokens are JAX's one-hot sampler's (k 100 beyond
    the 10 codes keeps every class, as JAX's clamped index does)."""
    jds, params = _jdiffsound()
    model, vocoder = _port_slice()
    key = jax.random.PRNGKey(2)
    want_mel, want_tok = jds.generate(params, key, jnp.asarray(_cond_tokens()),
                                      sample_type=sample_type, use_fused=False,
                                      return_tokens=True)
    mel, tokens = model.generate(torch.Generator().manual_seed(0),
                                 torch.from_numpy(_cond_tokens()), sample_type=sample_type,
                                 noise=jax_draws(key, T_STEPS), return_tokens=True)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(mel.numpy(), np.asarray(want_mel), atol=ATOL)
    assert vocoder((mel[..., 0] + 1.0) / 2.0).shape == (B, 16 * 256)


def test_parse_sample_type():
    assert parse_sample_type("top0.85r") == (0.85, 0, 0, 0.0)
    assert parse_sample_type("top0.85r,fast2") == (0.85, 0, 2, 0.0)
    assert parse_sample_type("top0.85r,q0.5") == (0.85, 0, 0, 0.5)
    assert parse_sample_type("top100p") == (0.0, 100, 0, 0.0)
    with pytest.raises(ValueError):
        parse_sample_type("topXq")


def test_composite_state_dict_has_reference_layout():
    """The whole model's state dict is the released DALLE layout: the JAX
    package's converters, given the reference's prefixes, rebuild every tree."""
    _, _, _, params, _ = _jax_slice()
    model, _ = _port_slice()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    got = {
        "codec": t2j.convert_vqgan(sd, params["codec"], prefix="content_codec."),
        "cond": t2j.convert_clip_text(sd, params["cond"], prefix="transformer.condition_emb."),
        "diffusion": t2j.convert_diffusion(sd, params["diffusion"], prefix="transformer."),
    }
    for part in got:
        gl = jax.tree_util.tree_leaves_with_path(got[part])
        wl = jax.tree_util.tree_leaves_with_path(params[part])
        assert [p for p, _ in gl] == [p for p, _ in wl]
        for (path, g), (_, w) in zip(gl, wl):
            np.testing.assert_array_equal(g, w, err_msg=part + jax.tree_util.keystr(path))


def test_build_flagship_from_yaml_without_bpe_table():
    """The repo's YAML builds the port's flagship model (on the meta device:
    shapes only); the tokenizer is built lazily, so no BPE table is needed."""
    model = build_model(load_yaml_config(os.path.join(REPO, "configs", "diffsound_audiocaps.yaml")),
                        device="meta")
    assert isinstance(model, Diffsound)
    assert model.token_hw == (5, 53)
    assert model.diffusion.num_classes == 257 and model.diffusion.content_seq_len == 265
    assert len(model.diffusion.transformer.blocks) == 19
    assert model.diffusion.transformer.to_logits[1].weight.shape == (256, 1024)
    assert model.cond.token_embedding.weight.shape == (49408, 512)
    assert model.codec.decoder.conv_in.weight.shape == (512, 256, 3, 3)
    assert model.dtype == torch.float32


@pytest.mark.parametrize("L", [265, 2 * 265])
def test_column_major_matches_jax(L):
    """Forward and reverse order, including the long-form width re-derivation."""
    x = np.random.default_rng(3).integers(0, 256, (2, L)).astype(np.int32)
    ours, ref = tperm.ColumnMajor(5, 53), jperm.ColumnMajor(5, 53)
    fwd = ours(torch.from_numpy(x))
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(ref(jnp.asarray(x))))
    np.testing.assert_array_equal(ours(fwd, reverse=True).numpy(), x)


def test_tokenizer_is_built_at_first_use():
    """Building needs no BPE table; tokenizing needs one."""
    from text_to_sound_synthesis_torch.models.clip.tokenizer import find_default_bpe

    model, _ = _port_slice()
    try:
        find_default_bpe()
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            model.text_to_tokens(["a dog barks"])
    else:
        assert model.text_to_tokens(["a dog barks"])["token"].shape == (1, CTX)


@pytest.mark.parametrize("kind", ["linear", "conv", "embedding", "zeros"])
def test_seeded_init_lecun_normal_draws_flax_defaults(kind):
    """``init_random_``'s default draws each weight as the JAX package's flax
    module does by default: Dense and Conv ``lecun_normal`` (a normal
    truncated at two standard deviations, variance 1 / fan_in), Embed an
    untruncated normal of variance 1 / features, and the parameters that the
    JAX package's modules initialise to zeros (the GPT's ``pos_emb``,
    ``ContentEmbedding``'s ``height_emb`` / ``width_emb`` under
    ``pos_emb_type="parameter"``) zeros. Held by the draws' largest |w| and
    standard deviation, in units of 1 / sqrt(fan_in), beside flax's own init
    of the same shape; a bf16 draw holds bf16 values."""
    import flax.linen as fnn
    from text_to_sound_synthesis_torch.utils.init import init_random_

    key, bound = jax.random.PRNGKey(0), 2.0 / 0.87962566103423978
    if kind == "zeros":
        from text_to_sound_synthesis_torch.models.diffusion.embeddings import ContentEmbedding
        from text_to_sound_synthesis_torch.models.gpt import GPT
        from text_to_sound_synthesis_tpu.models.diffusion.embeddings import \
            ContentEmbedding as JContentEmbedding
        from text_to_sound_synthesis_tpu.models.gpt import GPT as JGPT

        gcfg = dict(vocab_size=12, block_size=18, n_layer=1, n_head=2, n_embd=16)
        gpt = init_random_(GPT(**gcfg), torch.Generator().manual_seed(0))
        emb = init_random_(ContentEmbedding(10, (3, 4), 16, pos_emb_type="parameter"),
                           torch.Generator().manual_seed(0))
        jg = JGPT(**gcfg).init(key, jnp.zeros((1, 2), jnp.int32))["params"]
        je = JContentEmbedding(10, (3, 4), 16, pos_emb_type="parameter").init(
            key, jnp.zeros((1, 12), jnp.int32))["params"]
        for port, flax in ((gpt.pos_emb, jg["pos_emb"]), (emb.height_emb, je["height_emb"]),
                           (emb.width_emb, je["width_emb"])):
            assert port.shape == flax.shape and not port.any() and not np.asarray(flax).any()
        assert gpt.tok_emb.weight.std() > 0 and emb.emb.weight.std() > 0
        return
    if kind == "linear":
        port, fan_in = torch.nn.Linear(1024, 512), 1024
        flax = fnn.Dense(512).init(key, jnp.zeros((1, 1024)))["params"]["kernel"]
    elif kind == "conv":
        port, fan_in = torch.nn.Conv2d(64, 128, 3), 64 * 9
        flax = fnn.Conv(128, (3, 3)).init(key, jnp.zeros((1, 8, 8, 64)))["params"]["kernel"]
    else:
        port, fan_in = torch.nn.Embedding(4096, 64), 64
        flax = fnn.Embed(4096, 64).init(key, jnp.zeros((1,), jnp.int32))["params"]["embedding"]
    f = np.asarray(flax) * fan_in ** 0.5
    w = init_random_(port, torch.Generator().manual_seed(0)).weight.detach().numpy() \
        * fan_in ** 0.5
    assert abs(w.std() - 1) < 0.02 and abs(f.std() - 1) < 0.02
    if kind == "embedding":
        assert f.max() > 4 and abs(w.max() / f.max() - 1) < 0.15
    else:
        assert bound - 0.01 < np.abs(w).max() <= bound + 1e-5
        assert bound - 0.01 < np.abs(f).max() <= bound + 1e-5
        assert not port.bias.any()
        init_random_(port, torch.Generator().manual_seed(0), draw_dtype=torch.bfloat16)
        assert torch.equal(port.weight.bfloat16().float(), port.weight)


def test_import_does_not_load_jax():
    """The package and every module of the port, the int8 serving engine's,
    the training engine's (Stage 1, the vocoder's and Stage 2), the data
    pipeline's, the data-parallel layer's, the evaluation's (its models
    and tools), the AR baseline's (its models and tools), the
    user-facing tools (generate, serve, bench_serve, extract_text_features,
    check_artifacts), the long tail (classifier training, the CLIP vision
    tower, vis_codebook, run_parity_gate, dryrun) and the model axis (the
    mesh, the Megatron sharding, utils/misc) included, import without JAX;
    the CLIP tokenizer without ``regex``."""
    mods = ["text_to_sound_synthesis_torch", "text_to_sound_synthesis_torch.models.diffsound",
            "text_to_sound_synthesis_torch.models.diffusion.int8_runtime",
            "text_to_sound_synthesis_torch.models.diffusion.calibrate",
            "text_to_sound_synthesis_torch.ops.quant", "text_to_sound_synthesis_torch.ops.attention",
            "text_to_sound_synthesis_torch.ops.int8_block",
            "text_to_sound_synthesis_torch.ops.fused_sampler",
            "text_to_sound_synthesis_torch.convert.from_jax",
            "text_to_sound_synthesis_torch.convert.checkpoint",
            "text_to_sound_synthesis_torch.ops.sampling", "text_to_sound_synthesis_torch.ops.signal",
            "text_to_sound_synthesis_torch.utils.io", "text_to_sound_synthesis_torch.utils.artifacts",
            "text_to_sound_synthesis_torch.models.melgan.interface",
            "text_to_sound_synthesis_torch.engine", "text_to_sound_synthesis_torch.engine.solver",
            "text_to_sound_synthesis_torch.engine.train_state",
            "text_to_sound_synthesis_torch.engine.checkpoint",
            "text_to_sound_synthesis_torch.engine.optimizers",
            "text_to_sound_synthesis_torch.engine.schedulers",
            "text_to_sound_synthesis_torch.engine.clip_grad",
            "text_to_sound_synthesis_torch.engine.ema", "text_to_sound_synthesis_torch.engine.logger",
            "text_to_sound_synthesis_torch.data.datasets", "text_to_sound_synthesis_torch.data.loader",
            "text_to_sound_synthesis_torch.data.transforms",
            "text_to_sound_synthesis_torch.native.npy_loader",
            "text_to_sound_synthesis_torch.parallel.distributed",
            "text_to_sound_synthesis_torch.tools.train_diffsound",
            "text_to_sound_synthesis_torch.ops.gan",
            "text_to_sound_synthesis_torch.models.vqgan.quantize",
            "text_to_sound_synthesis_torch.models.vqgan.model",
            "text_to_sound_synthesis_torch.models.vqgan.modules1d",
            "text_to_sound_synthesis_torch.models.discriminator",
            "text_to_sound_synthesis_torch.models.lpaps.vggishish",
            "text_to_sound_synthesis_torch.models.lpaps.lpaps",
            "text_to_sound_synthesis_torch.models.melgan.discriminator",
            "text_to_sound_synthesis_torch.engine.vqgan_solver",
            "text_to_sound_synthesis_torch.engine.vocoder_solver",
            "text_to_sound_synthesis_torch.tools.train_vqgan",
            "text_to_sound_synthesis_torch.tools.train_vocoder",
            "text_to_sound_synthesis_torch.tools.prepare_data",
            "text_to_sound_synthesis_torch.tools.bench_train_stage1",
            "text_to_sound_synthesis_torch.utils.dtype",
            "text_to_sound_synthesis_torch.tools.bench_bf16_request",
            "text_to_sound_synthesis_torch.evaluation.metrics",
            "text_to_sound_synthesis_torch.evaluation.features",
            "text_to_sound_synthesis_torch.evaluation.caption_metrics",
            "text_to_sound_synthesis_torch.evaluation.synonyms",
            "text_to_sound_synthesis_torch.models.melception",
            "text_to_sound_synthesis_torch.models.captioner",
            "text_to_sound_synthesis_torch.tools.evaluate",
            "text_to_sound_synthesis_torch.tools.eval_captions",
            "text_to_sound_synthesis_torch.tools.eval_int8_drift",
            "text_to_sound_synthesis_torch.models.gpt",
            "text_to_sound_synthesis_torch.models.gpt.net2net",
            "text_to_sound_synthesis_torch.tools.train_ar",
            "text_to_sound_synthesis_torch.tools.generate_ar",
            "text_to_sound_synthesis_torch.models.clip.tokenizer",
            "text_to_sound_synthesis_torch.models.clip.word_split",
            "text_to_sound_synthesis_torch.tools.generate",
            "text_to_sound_synthesis_torch.tools.serve",
            "text_to_sound_synthesis_torch.tools.bench_serve",
            "text_to_sound_synthesis_torch.tools.extract_text_features",
            "text_to_sound_synthesis_torch.tools.check_artifacts",
            "text_to_sound_synthesis_torch.engine.classifier_solver",
            "text_to_sound_synthesis_torch.tools.train_classifier",
            "text_to_sound_synthesis_torch.models.clip.vision_model",
            "text_to_sound_synthesis_torch.tools.vis_codebook",
            "text_to_sound_synthesis_torch.tools.run_parity_gate",
            "text_to_sound_synthesis_torch.tools.dryrun",
            "text_to_sound_synthesis_torch.parallel.mesh",
            "text_to_sound_synthesis_torch.parallel.sharding",
            "text_to_sound_synthesis_torch.utils.misc"]
    code = (f"import importlib, sys; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in ('jax', 'flax', 'orbax', 'text_to_sound_synthesis_tpu', 'regex') "
            "if m in sys.modules]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
