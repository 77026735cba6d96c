"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card. Skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX (the repo's conftest imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from text_to_sound_synthesis_torch.ops import diffusion as dd
from text_to_sound_synthesis_torch.ops import fused_sampler as fs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same check on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_p_sample_kernel_matches_plain(cuda, dtype):
    """Slice shape (8 x 265 rows, 256 classes), r = 0, supplied noise:
    posterior within 1e-4 (f32 log-space, another summation order), tokens equal."""
    rng = np.random.default_rng(4)
    K = 257
    logits = torch.from_numpy((rng.standard_normal((8, 265, K - 1)) * 3).astype(np.float32))
    xt = torch.from_numpy(rng.integers(0, K, (8, 265)).astype(np.int32))
    g = torch.from_numpy(rng.gumbel(size=(8, 265, K)).astype(np.float32))
    logits, xt, g = logits.to(cuda, dtype), xt.to(cuda), g.to(cuda)
    sched = dd.make_schedule(100, K, device=cuda)
    launches = fs.fused_p_sample.launches
    for t_post in (0, 50, 99):
        c = fs.step_coeffs(sched, t_post).as_array().contiguous()
        want_tok, want = fs.p_sample_from_indices(logits, xt, c, gumbel=g, return_log_probs=True)
        tok, got = fs.fused_p_sample(logits, xt, c, 1, 2, gumbel=g, return_log_probs=True)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-4
        assert torch.equal(tok, want_tok)
    assert fs.fused_p_sample.launches == launches + 3
