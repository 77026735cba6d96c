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



# ---------------------------------------------------------------------------
# The kernels' threshold search: the 24-step bisection's least grid point
# ---------------------------------------------------------------------------

def _lane_sum(p):
    """f(g) as the kernels take it: p (R, NJ * 32) holds class 32 j + lane at
    [j][lane]; each lane sums its p > g in j order from 0, then the warp's
    xor butterfly (f32 adds, as on the card). Returns a function of g (R, N):
    N thresholds a row, each summed on its own."""
    R, C = p.shape
    lanes = p.reshape(R, C // 32, 1, 32)
    idx = torch.arange(32)

    def f(g):
        v = torch.zeros(R, g.shape[1], 32)
        for j in range(C // 32):
            v = v + torch.where(lanes[:, j] > g[..., None], lanes[:, j], 0.0)
        for o in (16, 8, 4, 2, 1):
            v = v + v[..., idx ^ o]
        return v[..., 0]
    return f


def _row_sum(p):
    """f(g) as the plain twin takes it: torch's sum of the p > g, a threshold
    column at a time (the shape ``_bisect_threshold`` sums in)."""
    return lambda g: torch.cat([torch.where(p > g[:, i:i + 1], p, 0.0).sum(dim=-1, keepdim=True)
                                for i in range(g.shape[1])], dim=1)


def _bisect(f, r, rows):
    lo, hi = torch.zeros(rows, 1), torch.ones(rows, 1)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        take = f(mid) < r
        hi, lo = torch.where(take, mid, hi), torch.where(take, lo, mid)
    return hi


def _least_grid_point(f, p, r):
    """The least g = m 2^-24 (m >= 1) with f(g) < r, without a search: f
    depends on g only through the set {p > g}, which is the same at g and at
    the largest of 2^-24 and the ceil(p 2^24) 2^-24 at most g, so the least
    is among those points and 1 (f(1) = 0 < r)."""
    R = len(p)
    grid = (torch.ceil(p * 2.0**24) / 2.0**24).clamp(2.0**-24, 1.0)
    cand = torch.cat([torch.full((R, 1), 2.0**-24), grid, torch.ones(R, 1)], dim=1)
    cand = torch.sort(cand, dim=1).values
    below = f(cand) < r
    first = below.float().argmax(dim=1, keepdim=True)   # f is non-increasing: the first below
    assert below.any(dim=1).all()
    return cand.gather(1, first)


def _threshold_rows(case, K, rows=8):
    """(p (rows, NJ * 32) with the K - 1 real classes' probabilities, 0
    beyond; r) for a named case."""
    rng = np.random.default_rng(K)
    logits = rng.standard_normal((rows, K - 1)).astype(np.float32) * 3
    r = 0.85
    if case == "ties_at_top":
        logits[:, rng.permutation(K - 1)[:5]] = logits.max() + 1.0
    elif case == "dominant":
        logits[:, 7] = 30.0
    elif case == "uniform":
        logits[:] = 0.5
    elif case == "r_max":
        r = 1.0 - 2.0**-24
    p = torch.softmax(torch.from_numpy(logits), dim=-1)
    nj = -(-K // 32)
    return torch.nn.functional.pad(p, (0, 32 * nj - (K - 1))), r


@pytest.mark.parametrize("case", ["gaussian", "ties_at_top", "dominant", "uniform", "r_max"])
@pytest.mark.parametrize("K", [257, 2049])
def test_bisection_threshold_is_the_least_grid_point(K, case):
    """The 24-step bisection ends at the least m 2^-24 whose f is below r
    (``sampler_body.cuh::search_threshold``'s note; any search of that grid
    on the same f ends there, so a 2^k-ary one gives the same threshold),
    for the kernels' f (lane sums, butterfly) and for the twin's
    (``_bisect_threshold``, which ``_truncate_rows`` uses)."""
    p, r = _threshold_rows(case, K)
    f = _lane_sum(p)
    want = _least_grid_point(f, p, r)
    assert torch.equal(_bisect(f, r, len(p)), want)
    twin = tfs._bisect_threshold(p, r)
    assert torch.equal(twin, _least_grid_point(_row_sum(p), p, r))
    assert ((want > 0) & (want <= 1)).all() and ((twin > 0) & (twin <= 1)).all()


@pytest.mark.parametrize("km1", [1, 99, 249, 256, 2048])
def test_head_weight_rows_pads_to_a_16_byte_pitch(km1):
    """K2's weight: the tensor itself when its rows are a multiple of 8
    classes, else a view of zero-padded rows; a base off 16 bytes is copied."""
    w = torch.randn(64, km1).bfloat16()
    v = tfs.head_weight_rows(w)
    assert torch.equal(v, w) and v.stride(1) == 1 and v.stride(0) % 8 == 0
    assert v.data_ptr() % 16 == 0 and (v is w) == (km1 % 8 == 0)
    assert tfs.head_weight_rows(v) is v
    off = torch.empty(64 * km1 + 8, dtype=torch.bfloat16)[1:1 + 64 * km1].view(64, km1)
    off.copy_(w)
    assert torch.equal(tfs.head_weight_rows(off), w) and tfs.head_weight_rows(off).data_ptr() % 16 == 0


def test_seed_and_step_as_int32_tensors():
    """Each key word may be an int32 tensor of one element on the logits'
    device, read as its 32 bits: the same tokens as the int form."""
    logits, _ = _inputs(4, 64, 257, seed=2)
    lt, xtt = torch.from_numpy(logits), torch.full((4, 64), 256, dtype=torch.int32)
    c = _port_coeffs(100, 257, 0)
    key = lambda v: torch.tensor([v], dtype=torch.int32)
    a = tfs.fused_p_sample(lt, xtt, c, 5, 3)
    assert torch.equal(a, tfs.fused_p_sample(lt, xtt, c, key(5), key(3)))
    assert torch.equal(a, tfs.fused_p_sample(lt, xtt, c, 5, torch.tensor(3, dtype=torch.int32)))
    assert torch.equal(tfs.fused_p_sample(lt, xtt, c, 2**31 + 5, 3),
                       tfs.fused_p_sample(lt, xtt, c, key(-2**31 + 5), 3))
    for bad in (torch.tensor([5]), torch.tensor([5, 6], dtype=torch.int32),
                key(5).to("meta")):
        with pytest.raises(ValueError, match="one int32"):
            tfs.fused_p_sample(lt, xtt, c, bad, 3)


def test_bench_sampler_needs_a_card():
    """The sampler A/B tool takes no arguments (an unknown one exits 2), and
    without a card exits 1."""
    from text_to_sound_synthesis_torch.tools import bench_sampler

    with pytest.raises(SystemExit) as e:
        bench_sampler.main(["--search-bits", "3"])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        assert bench_sampler.main([]) == 1
