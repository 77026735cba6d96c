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
