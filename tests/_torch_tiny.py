"""The tiny Stage-2 training geometry shared by the port's training tests
and their worker processes (no JAX here: the workers are fresh interpreters
that run the port alone).

2 denoiser layers of d64, 2 heads, 16 tokens of 10 codes + MASK, 4
diffusion steps; the VQGAN of ``tests/test_composite.py``'s TINY_MODEL_CFG
(mel 4 x 16 -> a 2 x 8 grid); a 1-layer CLIP over a 64-word vocabulary.
"""

import numpy as np
import torch

B, CTX, T, L, K, VOCAB = 4, 12, 4, 16, 11, 64
VQ_DD = dict(double_z=False, z_channels=16, resolution=16, in_channels=1, out_ch=1, ch=8,
             ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], dropout=0.0)
CLIP_CFG = dict(num_embed=VOCAB, embed_dim=8, width=8, layers=1, heads=2, context_length=CTX)
TRANSFORMER_CFG = {"params": dict(n_layer=2, n_embd=64, n_head=2, content_seq_len=L,
                                  condition_dim=8, content_spatial_size=(2, 8))}
CONTENT_EMB_CFG = {"params": dict(num_embed=K - 1, embed_dim=64, spatial_size=(2, 8))}
TRAIN_CFG = {
    "target": "text_to_sound_synthesis_tpu.models.Diffsound",
    "params": {
        "content_codec_config": {"target": "text_to_sound_synthesis_tpu.models.vqgan.VQModel",
                                 "params": {"embed_dim": 16, "n_embed": K - 1,
                                            "ddconfig": VQ_DD}},
        "first_stage_permuter_config": {
            "target": "text_to_sound_synthesis_tpu.ops.permuter.ColumnMajor",
            "params": {"H": 2, "W": 8}},
        "condition_codec_config": {"target": "text_to_sound_synthesis_tpu.models.clip.Tokenize",
                                   "params": {"context_length": CTX}},
        "diffusion_config": {
            "target": "text_to_sound_synthesis_tpu.models.diffusion.DiscreteDiffusion",
            "params": {
                "diffusion_step": T,
                "auxiliary_loss_weight": 5e-4,
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
OPT_CFG = {"target": "adamw", "params": {"betas": (0.9, 0.96), "weight_decay": 0.045}}


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (B, 4, 16, 1)).astype(np.float32),
            "condition_token": rng.integers(0, VOCAB, (B, CTX)).astype(np.int32)}


def tbatch(b):
    return {"image": torch.from_numpy(b["image"]),
            "condition_token": torch.from_numpy(b["condition_token"]).long()}


# -- Stage 1: the codec of the JAX Stage-1 tests at ch 64, a 2-layer PatchGAN ------------------

S1_DD = dict(double_z=False, z_channels=16, resolution=32, in_channels=1, out_ch=1, ch=64,
             ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16], dropout=0.0)
S1_B, S1_MEL = 4, (16, 32)        # the global batch, mel bins x frames


def stage1_state(seed=0, lr=1e-4):
    """A fresh ``VQGANTrainState`` of the tiny codec (8 codes of 16) and
    PatchGAN (ndf 8, 2 layers, BatchNorm), from the training initialisers."""
    from text_to_sound_synthesis_torch.engine.vqgan_solver import VQGANTrainState
    from text_to_sound_synthesis_torch.models.discriminator import (NLayerDiscriminator,
                                                                    init_discriminator_)
    from text_to_sound_synthesis_torch.models.vqgan.model import VQModel, init_codec_

    gen = torch.Generator().manual_seed(seed)
    codec = init_codec_(VQModel(S1_DD, n_embed=8, embed_dim=16), gen)
    disc = init_discriminator_(NLayerDiscriminator(1, 8, 2), gen)
    return VQGANTrainState.create(codec, disc, lr)


def stage1_batches(n=2):
    """``n`` global batches of mels in [-1, 1], (S1_B, 16, 32, 1)."""
    rng = np.random.default_rng(41)
    return [torch.from_numpy(rng.uniform(-1, 1, (S1_B, *S1_MEL, 1)).astype(np.float32))
            for _ in range(n)]


def mark_zero_grads(nets, noisy):
    """Mark, in ``noisy`` (name -> bool tensor), the values whose gradient in
    the last step lay below 1e-6 of their network's largest: zero in exact
    arithmetic, so Adam steps each side's rounding there. ``nets`` maps a
    prefix to a module (None: skipped); the marks accumulate over steps."""
    for net, module in nets.items():
        if module is None:
            continue
        grads = {f"{net}.{n}": p.grad for n, p in module.named_parameters()}
        top = max(float(g.abs().max()) for g in grads.values())
        for k, g in grads.items():
            noisy[k] = noisy.get(k, False) | (g.abs() < 1e-6 * top)
    return noisy


# -- one GAN step from the JAX step's state: its gradients, read off Adam's first moment ------

def set_adam_state(opt, named, mu, nu, count):
    """Give the torch Adam ``opt`` over ``named`` (name -> parameter) an
    optax Adam's state: the moments ``mu`` / ``nu`` (name -> array, the
    port's layouts) after ``count`` updates. The two compute the same update
    from the same state."""
    for n, p in named.items():
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": torch.tensor(np.array(mu[n], np.float32)),
                        "exp_avg_sq": torch.tensor(np.array(nu[n], np.float32))}


def adam_grads(mu, mu_before, b1):
    """The gradient an Adam took at its last update, from its first moment
    after and before it (name -> array): mu = b1 mu_before + (1 - b1) g."""
    return {k: (np.asarray(m, np.float64) - b1 * np.asarray(mu_before[k], np.float64)) / (1 - b1)
            for k, m in mu.items()}


def assert_grads_close(module, want, what):
    """Each parameter's gradient within 1e-4 of its tensor's largest
    magnitude, or 1e-7 of the largest of all, whichever is larger (a tensor
    whose gradient is zero in exact arithmetic holds each side's rounding:
    the attention keys' biases, as the softmax does not see a shift all keys
    share). An all-zero ``want`` must be met exactly."""
    top = max(float(np.abs(w).max()) for w in want.values())
    got = {n: p.grad for n, p in module.named_parameters()}
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k].numpy() if got[k] is not None else np.zeros_like(w)
        atol = max(1e-4 * float(np.abs(w).max()), 1e-7 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} {k}")


#: the AR baseline's tiny Net2Net (tests/test_torch_ar_tools.py, the gloo
#: train_ar step of tests/_torch_mp_worker.py)
AR_MODEL = {
    "target": "text_to_sound_synthesis_tpu.models.gpt.Net2NetTransformer",
    "base_learning_rate": 1e-4,
    "params": {
        "transformer_config": {"params": {
            "feat_embedding_config": {"target": "torch.nn.Conv1d",
                                      "params": {"in_channels": 8, "out_channels": 16,
                                                 "kernel_size": 1}},
            "GPT_config": dict(vocab_size=10, block_size=17, n_layer=1, n_head=2, n_embd=16),
        }},
        "first_stage_config": {
            "target": "text_to_sound_synthesis_tpu.models.vqgan.VQModel",
            "params": {"embed_dim": 16, "n_embed": 10,
                       "ddconfig": dict(double_z=False, z_channels=16, resolution=16,
                                        in_channels=1, out_ch=1, ch=8, ch_mult=[1, 2],
                                        num_res_blocks=1, attn_resolutions=[8], dropout=0.0)}},
        "first_stage_permuter_config": {
            "target": "text_to_sound_synthesis_tpu.ops.permuter.ColumnMajor",
            "params": {"H": 2, "W": 8}},
    },
}
AR_BS = 4       # the global batch


def ar_batches(n=2):
    """``n`` global AR batches: (mel (AR_BS, 4, 16, 1), features (AR_BS, 8, 1))."""
    rng = np.random.default_rng(41)
    return [(torch.from_numpy(rng.uniform(-1, 1, (AR_BS, 4, 16, 1)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((AR_BS, 8, 1)).astype(np.float32)))
            for _ in range(n)]
