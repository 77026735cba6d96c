"""The port's fused sampler step (K1) against the JAX package.

The same numpy inputs and noise go through the JAX functions and the port's;
on the CPU the port's ``fused_p_sample`` runs its plain PyTorch version. The
CUDA kernel itself is checked on the card (``tests/test_torch_kernels_gpu.py``
and ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from text_to_sound_synthesis_tpu.ops import diffusion as jdd
from text_to_sound_synthesis_tpu.ops import fused_sampler as jfs
from text_to_sound_synthesis_torch.ops import diffusion as tdd
from text_to_sound_synthesis_torch.ops import fused_sampler as tfs

torch.set_num_threads(1)

T, K, B, L = 10, 7, 2, 5
# posterior log-probs: f32 log-space chains of ~10 ops on values up to |70|;
# the two frameworks' exp/log differ by an ulp or two
POST_ATOL = 5e-5


def _inputs(B, L, K, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, L, K - 1)) * 2).astype(np.float32)
    xt = rng.integers(0, K, (B, L)).astype(np.int32)
    xt[0, 0] = K - 1                      # at least one MASK state
    xt[-1, -1] = 0
    return logits, xt


def _jax_coeffs(T, K, t_post):
    return jfs.step_coeffs(jdd.make_schedule(T, K), jnp.asarray(t_post))


def _port_coeffs(T, K, t_post):
    return tfs.step_coeffs(tdd.make_schedule(T, K), t_post).as_array()


@pytest.mark.parametrize("kind", ["mask_and_uniform", "mask_only", "uniform_only"])
@pytest.mark.parametrize("T_, K_", [(100, 257), (10, 7)])
def test_make_schedule_bit_identical(kind, T_, K_):
    want = jdd.make_schedule(T_, K_, kind)
    got = tdd.make_schedule(T_, K_, kind)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert g.dtype == torch.float32


@pytest.mark.parametrize("t_post", [0, 37, 99])
def test_step_coeffs_bit_identical(t_post):
    want = np.asarray(_jax_coeffs(100, 257, t_post).as_array())
    got = _port_coeffs(100, 257, t_post)
    np.testing.assert_array_equal(got.numpy(), want)
    # the (n_steps, 10) table the sampler loop reads holds the same rows
    table = tfs.step_coeffs(tdd.make_schedule(100, 257), [99, t_post, 0]).as_array()
    np.testing.assert_array_equal(table[1].numpy(), want)


@pytest.mark.parametrize("r", [0.0, 0.85])
@pytest.mark.parametrize("t_post", [0, 4, T - 1])
def test_posterior_matches_jax(t_post, r):
    logits, xt = _inputs(B, L, K)
    coeffs = _jax_coeffs(T, K, t_post)
    _, want = jfs.p_sample_from_indices(jnp.asarray(logits), jnp.asarray(xt), coeffs,
                                        jax.random.PRNGKey(0), truncation_r=r,
                                        return_log_probs=True)
    with pltpu.force_tpu_interpret_mode():
        _, want_kernel = jfs.fused_p_sample(jnp.asarray(logits), jnp.asarray(xt), coeffs,
                                            jnp.asarray(7, jnp.int32), truncation_r=r,
                                            row_block=8, return_log_probs=True)
    _, got = tfs.fused_p_sample(torch.from_numpy(logits), torch.from_numpy(xt),
                                _port_coeffs(T, K, t_post), 7, 0, truncation_r=r,
                                return_log_probs=True)
    assert got.shape == (B, L, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POST_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=POST_ATOL)


@pytest.mark.parametrize("r", [0.0, 0.85])
def test_posterior_matches_jax_at_flagship_classes(r):
    """K = 257 (256 codes + MASK), the width the kernel runs at."""
    logits, xt = _inputs(1, 64, 257, seed=1)
    coeffs = _jax_coeffs(100, 257, 50)
    _, want = jfs.p_sample_from_indices(jnp.asarray(logits), jnp.asarray(xt), coeffs,
                                        jax.random.PRNGKey(0), truncation_r=r,
                                        return_log_probs=True)
    _, got = tfs.p_sample_from_indices(torch.from_numpy(logits), torch.from_numpy(xt),
                                       _port_coeffs(100, 257, 50), truncation_r=r,
                                       return_log_probs=True,
                                       generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POST_ATOL)


@pytest.mark.parametrize("r", [0.0, 0.85])
def test_tokens_are_gumbel_argmax_of_jax_posterior(r):
    logits, xt = _inputs(B, L, K)
    coeffs = _jax_coeffs(T, K, 4)
    _, post = jfs.p_sample_from_indices(jnp.asarray(logits), jnp.asarray(xt), coeffs,
                                        jax.random.PRNGKey(0), truncation_r=r,
                                        return_log_probs=True)
    g = np.random.default_rng(3).gumbel(size=(B, L, K)).astype(np.float32)
    got = tfs.fused_p_sample(torch.from_numpy(logits), torch.from_numpy(xt),
                             _port_coeffs(T, K, 4), 0, 0, truncation_r=r,
                             gumbel=torch.from_numpy(g))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.argmax(np.asarray(post) + g, axis=-1))


def test_cpu_draws_keyed_on_seed_and_step():
    logits, _ = _inputs(4, 64, 257, seed=2)
    lt, xtt = torch.from_numpy(logits), torch.full((4, 64), 256, dtype=torch.int32)
    c = _port_coeffs(100, 257, 0)  # all-MASK at t=0: draws follow the broad model posterior
    a = tfs.fused_p_sample(lt, xtt, c, 5, 3)
    np.testing.assert_array_equal(a.numpy(), tfs.fused_p_sample(lt, xtt, c, 5, 3).numpy())
    assert not torch.equal(a, tfs.fused_p_sample(lt, xtt, c, 5, 4))
    assert not torch.equal(a, tfs.fused_p_sample(lt, xtt, c, 6, 3))
    assert ((a >= 0) & (a < 257)).all()


def test_wrapper_rejects_other_devices_and_seeds():
    logits, xt = _inputs(B, L, K)
    c = _port_coeffs(T, K, 1)
    with pytest.raises(ValueError):
        tfs.fused_p_sample(torch.from_numpy(logits), torch.from_numpy(xt), c, 2**32, 0)
    with pytest.raises(ValueError):
        tfs.fused_p_sample(torch.from_numpy(logits).to("meta"), torch.from_numpy(xt).to("meta"),
                           c.to("meta"), 0, 0)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises instead of carrying on without the kernel."""
    from text_to_sound_synthesis_torch.utils import cuda_build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()

