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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_p_sample_kernel_matches_plain_truncated(cuda, dtype):
    """As above at r = 0.85 (the threshold search), chip_smoke.py's gates: an
    ulp of a sum may move one class across the nucleus boundary, which
    changes that row, in at most 0.1 % of the rows; the rest within 1e-4."""
    rng = np.random.default_rng(5)
    K, rows = 257, 8 * 265
    logits = torch.from_numpy((rng.standard_normal((8, 265, K - 1)) * 3).astype(np.float32))
    xt = torch.from_numpy(rng.integers(0, K, (8, 265)).astype(np.int32))
    g = torch.from_numpy(rng.gumbel(size=(8, 265, K)).astype(np.float32))
    logits, xt, g = logits.to(cuda, dtype), xt.to(cuda), g.to(cuda)
    sched = dd.make_schedule(100, K, device=cuda)
    for t_post in (0, 50, 99):
        c = fs.step_coeffs(sched, t_post).as_array().contiguous()
        want_tok, want = fs.p_sample_from_indices(logits, xt, c, gumbel=g, truncation_r=0.85,
                                                  return_log_probs=True)
        tok, got = fs.fused_p_sample(logits, xt, c, 1, 2, gumbel=g, truncation_r=0.85,
                                     return_log_probs=True)
        torch.cuda.synchronize()
        assert int(((got - want).abs().amax(dim=-1) > 1e-4).sum()) <= rows // 1000
        assert int((tok != want_tok).sum()) <= rows // 1000


@pytest.mark.gpu
def test_sampler_kernels_read_seed_and_step_from_device(cuda):
    """The int form and the device-tensor form of (seed, step) draw the same
    tokens, an int32 read as its 32 bits; a CUDA graph captured with the
    tensors draws for the values they hold when it replays."""
    K, M, D = 257, 2 * 265, 256
    g = torch.Generator(cuda).manual_seed(3)
    logits = torch.randn((2, 265, K - 1), generator=g, device=cuda).bfloat16()
    xt = torch.randint(0, K, (2, 265), generator=g, device=cuda, dtype=torch.int32)
    c = fs.step_coeffs(dd.make_schedule(100, K, device=cuda), 0).as_array().contiguous()
    key = lambda v: torch.tensor([v], dtype=torch.int32, device=cuda)
    x = torch.randn((M, D), generator=g, device=cuda).bfloat16()
    norm = torch.stack([torch.ones(D, device=cuda), torch.zeros(D, device=cuda)])
    hw = (0.1 * torch.randn((D, K - 1), generator=g, device=cuda)).bfloat16()
    hb = torch.zeros(K - 1, device=cuda)
    k1 = lambda s, t: fs.fused_p_sample(logits, xt, c, s, t, truncation_r=0.85)
    k2 = lambda s, t: fs.fused_head_sample(x, xt.flatten(), norm, hw, hb, c, s, t,
                                           truncation_r=0.85)
    for kernel in (k1, k2):
        assert torch.equal(kernel(5, 7), kernel(key(5), key(7)))
        assert torch.equal(kernel(5, 7), kernel(5, key(7)))
        assert torch.equal(kernel(2**31 + 5, 7), kernel(key(-2**31 + 5), 7))
        assert not torch.equal(kernel(5, 7), kernel(5, 8))
    seed, step = key(5), key(7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k1(seed, step)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k1(seed, step)
    for s_, t_ in ((5, 7), (6, 7), (5, 9)):
        seed.fill_(s_)
        step.fill_(t_)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, k1(s_, t_))


# ---------------------------------------------------------------------------
# K3-K5 (int8 blocks) and K2 (fused head + sampler)
# ---------------------------------------------------------------------------

# (batch, sequence, width, heads, condition length, MLP width): a small shape
# with a head width of 32, and the flagship's
SHAPES = {"small": (2, 40, 128, 4, 16, 512), "flagship": (8, 265, 1024, 16, 77, 4096)}
# bf16 block outputs; an int8 flip upstream (the f32 LayerNorm sums run in
# another order) moves an output by a few bf16 ulps
BLOCK_TOL = 2e-2


def _block_inputs(dev, shape, w4):
    from text_to_sound_synthesis_torch.ops.quant import quantize_weight, quantize_weight_w4

    B, L, D, H, S, Dh = shape
    g = torch.Generator(dev).manual_seed(7)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
    q = quantize_weight_w4 if w4 else quantize_weight
    dense = lambda n, k: q(rnd(n, k, scale=0.03 * (1024 / k) ** 0.5), rnd(n, scale=0.05))
    mod = rnd(2, D, scale=0.2)
    ln = mod.clone()
    ln[0] += 1.0
    return dict(x=rnd(B * L, D).bfloat16(), mod=mod, ln=ln,
                ck=rnd(B * S, D).bfloat16(), cv=rnd(B * S, D).bfloat16(),
                attn=[dense(D, D) for _ in range(4)], cross=[dense(D, D) for _ in range(2)],
                mlp=[dense(Dh, D), dense(D, Dh)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["small", "flagship"])
@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_int8_block_kernels_match_plain(cuda, shape, w4, static):
    from text_to_sound_synthesis_torch.ops import int8_block as ib

    B, L, D, H, S, Dh = SHAPES[shape]
    d = _block_inputs(cuda, SHAPES[shape], w4)
    ss = (0.035, 0.02) if static else None
    cases = [
        (ib.self_attn_block, ib.self_attn_block_reference, (d["x"], d["mod"], *d["attn"]),
         dict(batch=B, n_head=H, q_valid=L - 3)),
        (ib.cross_attn_block, ib.cross_attn_block_reference,
         (d["x"], d["mod"], d["ck"], d["cv"], *d["cross"]), dict(batch=B, n_head=H, kv_valid=S - 4)),
        (ib.mlp_block, ib.mlp_block_reference, (d["x"], d["ln"], *d["mlp"]), {}),
    ]
    for kernel, plain, args, kw in cases:
        launches, passes = kernel.launches, ib.quantize_rows.launches
        wide = ib.quantize_wide.launches
        got = kernel(*args, static_s=ss, w4=w4, **kw)
        want = plain(*args, static_s=ss, w4=w4, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == launches + 1
        # the attention blocks' two quantize passes (their AdaLN, their proj input)
        assert ib.quantize_rows.launches == passes + (0 if kernel is ib.mlp_block else 2)
        # K3's dynamic middle: the wide pass between fc1 and fc2
        assert ib.quantize_wide.launches == wide + (kernel is ib.mlp_block and not static)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=BLOCK_TOL, atol=BLOCK_TOL)
        if static and kernel is ib.mlp_block:
            # no row max and no softmax to sum in another order: bit for bit
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K6 (per-dense), K7 (MHA), K8 (attention pair) and K9 (chunked MLP)
# ---------------------------------------------------------------------------

def _ulp_flips(got, want, ulps: int) -> int:
    """Elements of got more than ``ulps`` bf16 ulps off the plain value."""
    w = want.float()
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133),
                      torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
    return int(((got.float() - w).abs() > ulps * ulp).sum())


def _ulp_gate(got, want, ulps: int, share: float, controls=()):
    """At most ``share`` of got's elements more than ``ulps`` bf16 ulps off
    want; each control (another function on the same inputs) more."""
    n = want.numel()
    assert _ulp_flips(got, want, ulps) <= share * n
    for c in controls:
        assert _ulp_flips(c, want, ulps) > share * n


def _check_kernel(kernel, got, want, launches, tol=BLOCK_TOL):
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["small", "flagship"])
@pytest.mark.parametrize("static", [False, True])
def test_per_dense_kernels_match_plain(cuda, shape, static):
    """K6 at the engine's four per-dense sites (q/k/v AdaLN, proj + residual,
    fc1 LN + GELU2, fc2 at K = 4 D + residual) and K7 at the self and the
    cross attention's key counts, with masked tails."""
    from text_to_sound_synthesis_torch.ops import attention as attn
    from text_to_sound_synthesis_torch.ops import quant

    B, L, D, H, S, Dh = SHAPES[shape]
    d = _block_inputs(cuda, SHAPES[shape], False)
    x, multi = d["x"], quant.fused_quant_dense_multi
    s = (lambda v: v) if static else (lambda v: None)
    h = (torch.randn((B * L, Dh), generator=torch.Generator(cuda).manual_seed(9), device=cuda)
         * 0.5).bfloat16()
    sites = [((x, d["attn"][:3]), dict(norm="adaln", mod=d["mod"], s_static=s(0.035))),
             ((x, d["attn"][3:]), dict(residual=x, s_static=s(0.02))),
             ((x, d["mlp"][:1]), dict(norm="ln", mod=d["ln"], act="gelu2", s_static=s(0.035))),
             ((h, d["mlp"][1:]), dict(residual=x, s_static=s(0.01)))]
    for args, kw in sites:
        launches, rows, wide = multi.launches, quant.quantize_rows.launches, quant.quantize_wide.launches
        got = multi(*args, **kw)
        _check_kernel(multi, got, quant.quant_dense_multi_reference(*args, **kw), launches)
        # one quantize pass a call: the wide one past the row pass's 1024
        # (fc2 at the flagship's K = 4096), the row pass else
        K = args[0].shape[1]
        assert (quant.quantize_rows.launches - rows, quant.quantize_wide.launches - wide) == (
            (0, 1) if K > quant.ROW_PASS_K else (1, 0))
    for k, v, valid in ((x, h[:, :D].contiguous(), L - 3), (d["ck"], d["cv"], S - 4)):
        kw = dict(batch=B, n_head=H, kv_valid=valid)
        launches = attn.fused_mha.launches
        got = attn.fused_mha(x, k, v, **kw)
        _check_kernel(attn.fused_mha, got, attn.mha_reference(x, k, v, **kw), launches)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("norm", ["none", "ln", "adaln"])
def test_fused_quant_dense_kernel_combinations(cuda, norm, out_dtype):
    """K6 single-weight, small shape: every (act, residual, scale) at one norm."""
    from text_to_sound_synthesis_torch.ops import quant

    d = _block_inputs(cuda, SHAPES["small"], False)
    mod = d["ln"] if norm == "ln" else d["mod"]
    for act in ("none", "gelu2"):
        for residual in (None, d["x"], d["x"].float()):
            for s_static in (None, 0.035):
                kw = dict(norm=norm, mod=mod, act=act, residual=residual, out_dtype=out_dtype,
                          s_static=s_static)
                launches = quant.fused_quant_dense.launches
                got = quant.fused_quant_dense(d["x"], d["attn"][0], **kw)
                want = quant.quant_dense_reference(d["x"], d["attn"][0], **kw)
                _check_kernel(quant.fused_quant_dense, got, want, launches)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["small", "flagship"])
@pytest.mark.parametrize("static", [False, True])
def test_pair_and_chunked_kernels_match_plain(cuda, shape, static):
    """K8 (x in f32 between its halves) with masked keys, and K9 chunked at 4
    chunks and streamed at 16 (4 at the small shape, whose chunks must stay
    128 wide)."""
    from text_to_sound_synthesis_torch.ops import int8_block as ib

    B, L, D, H, S, Dh = SHAPES[shape]
    d = _block_inputs(cuda, SHAPES[shape], False)
    mods = torch.cat([d["mod"], d["mod"].flip(1)]).contiguous()
    pair_kw = dict(batch=B, n_head=H, q_valid=L - 3, kv_valid=S - 4,
                   static_s=(0.035, 0.02, 0.035, 0.02) if static else None)
    args = (d["x"], mods, d["ck"], d["cv"], *d["attn"], *d["cross"])
    launches, passes = ib.attn_pair_block.launches, ib.quantize_rows.launches
    got = ib.attn_pair_block(*args, **pair_kw)
    _check_kernel(ib.attn_pair_block, got, ib.attn_pair_block_reference(*args, **pair_kw),
                  launches)
    assert ib.quantize_rows.launches == passes + 4
    ss = (0.035, 0.012) if static else None
    for kernel, n_chunks in ((ib.mlp_block_chunked, 4), (ib.mlp_block_streamed, min(16, Dh // 128))):
        launches, wide = kernel.launches, ib.quantize_wide.launches
        got = kernel(d["x"], d["ln"], *d["mlp"], n_chunks=n_chunks, static_s=ss)
        torch.cuda.synchronize()
        assert ib.quantize_wide.launches == wide + (not static)
        want = ib.mlp_chunked_reference(d["x"], d["ln"], *d["mlp"], n_chunks=n_chunks,
                                        static_s=ss)
        _check_kernel(kernel, got, want, launches)
        if static:
            # the int8 middle is exact and the chunk flushes run in the twin's order
            assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["small", "flagship"])
def test_fused_head_sample_kernel_matches_plain(cuda, shape):
    """Posterior within 5e-3 (an LN output may round to the other bf16
    neighbour before the head), at most 0.1 % of tokens differ."""
    B, L, D, _, _, _ = SHAPES[shape]
    M, K = B * L, 257
    g = torch.Generator(cuda).manual_seed(8)
    x = (torch.randn((M, D), generator=g, device=cuda) * 2).bfloat16()
    norm = torch.stack([1 + 0.1 * torch.randn(D, generator=g, device=cuda),
                        0.1 * torch.randn(D, generator=g, device=cuda)])
    hw = (torch.randn((D, K - 1), generator=g, device=cuda) * 0.1).bfloat16()
    hb = 0.1 * torch.randn(K - 1, generator=g, device=cuda)
    xt = torch.randint(0, K, (M,), generator=g, device=cuda, dtype=torch.int32)
    noise = dd.gumbel_from_uniform(torch.rand((M, K), generator=g, device=cuda))
    c = fs.step_coeffs(dd.make_schedule(100, K, device=cuda), 50).as_array().contiguous()
    launches = fs.fused_head_sample.launches
    want_tok, want = fs.head_sample_reference(x, xt, norm, hw, hb, c, gumbel=noise)
    tok, got = fs.fused_head_sample(x, xt, norm, hw, hb, c, 1, 2, gumbel=noise,
                                    return_log_probs=True)
    torch.cuda.synchronize()
    assert fs.fused_head_sample.launches == launches + 1
    assert float((got - want).abs().max()) <= 5e-3
    assert int((tok != want_tok).sum()) <= max(1, M // 1000)


def _head_case(dev, M, D, K, seed):
    g = torch.Generator(dev).manual_seed(seed)
    x = (torch.randn((M, D), generator=g, device=dev) * 2).bfloat16()
    norm = torch.stack([1 + 0.1 * torch.randn(D, generator=g, device=dev),
                        0.1 * torch.randn(D, generator=g, device=dev)])
    hw = (torch.randn((D, K - 1), generator=g, device=dev) * 0.1).bfloat16()
    hb = 0.1 * torch.randn(K - 1, generator=g, device=dev)
    xt = torch.randint(0, K, (M,), generator=g, device=dev, dtype=torch.int32)
    noise = dd.gumbel_from_uniform(torch.rand((M, K), generator=g, device=dev))
    return x, xt, norm, hw, hb, noise


def _check_head(dev, M, D, K, seed):
    """test_fused_head_sample_kernel_matches_plain's gates at (M, D, K)."""
    x, xt, norm, hw, hb, noise = _head_case(dev, M, D, K, seed)
    c = fs.step_coeffs(dd.make_schedule(100, K, device=dev), 50).as_array().contiguous()
    launches = fs.fused_head_sample.launches
    want_tok, want = fs.head_sample_reference(x, xt, norm, hw, hb, c, gumbel=noise)
    tok, got = fs.fused_head_sample(x, xt, norm, hw, hb, c, 1, 2, gumbel=noise,
                                    return_log_probs=True)
    torch.cuda.synchronize()
    assert fs.fused_head_sample.launches == launches + 1
    assert float((got - want).abs().max()) <= 5e-3
    assert int((tok != want_tok).sum()) <= max(1, M // 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [100, 250, 257, 513, 2049])
@pytest.mark.parametrize("M", [1, 63, 65, 2120])
def test_fused_head_sample_kernel_at_each_class_count(cuda, K, M):
    """The codebooks JAX serves (256, 512 and 2048 codes + MASK: one column
    pass, two, eight through the f32 scratch; 99 and 249, K - 1 no multiple
    of 8: the weight's rows padded by the wrapper) at ragged row counts, D
    1024."""
    _check_head(cuda, M, 1024, K, seed=K + M)


@pytest.mark.gpu
def test_fused_head_sample_takes_padded_and_unaligned_operands(cuda):
    """A weight view with a padded row pitch (``head_weight_rows``), taken as
    it is, and x, norm_out and head_w at bases off 16 bytes, which the
    wrapper copies: the contiguous operands' tokens and posterior."""
    M, D, K = 65, 256, 250
    x, xt, norm, hw, hb, noise = _head_case(cuda, M, D, K, seed=9)
    c = fs.step_coeffs(dd.make_schedule(100, K, device=cuda), 50).as_array().contiguous()

    def off(t):
        v = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)[1:1 + t.numel()].view(t.shape)
        return v.copy_(t)

    run = lambda x_, n_, w_: fs.fused_head_sample(x_, xt, n_, w_, hb, c, 1, 2, gumbel=noise,
                                                  truncation_r=0.85, return_log_probs=True)
    want = run(x, norm, hw)
    padded = fs.head_weight_rows(hw)
    assert padded.stride(0) == 256
    for got in (run(x, norm, padded), run(off(x), off(norm), off(hw))):
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 96, 1056, 4096])
def test_fused_head_sample_kernel_at_ragged_widths(cuda, D):
    """D slices past the width (zero-filled) and the widest D."""
    _check_head(cuda, 65, D, 257, seed=D)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [257, 513, 2049])
def test_fused_head_sample_draws_equal_k1_on_exact_logits(cuda, K):
    """Rows of +-4, half of each sign, normalise to +-1 under gamma 1, beta 0
    whatever the order of the statistics' sums; head weights and biases on a
    2^-6 grid make every logit an exact f32 sum. So K2's logits are the plain
    ones bit for bit, and its Philox tokens and its posterior are K1's on
    them."""
    M, D = 2120, 1024
    g = torch.Generator(cuda).manual_seed(K)
    sign = torch.ones((M, D), device=cuda)
    sign[:, D // 2:] = -1
    x = (4 * sign.gather(1, torch.rand((M, D), generator=g, device=cuda).argsort(dim=1)))
    x = x.bfloat16()
    norm = torch.stack([torch.ones(D, device=cuda), torch.zeros(D, device=cuda)])
    hw = (torch.randint(-8, 9, (D, K - 1), generator=g, device=cuda) / 64).bfloat16()
    hb = torch.randint(-8, 9, (K - 1,), generator=g, device=cuda) / 64
    xt = torch.randint(0, K, (M,), generator=g, device=cuda, dtype=torch.int32)
    c = fs.step_coeffs(dd.make_schedule(100, K, device=cuda), 50).as_array().contiguous()
    logits = fs.head_logits(x, norm, hw, hb)
    for r in (0.0, 0.85):
        tok2, post2 = fs.fused_head_sample(x, xt, norm, hw, hb, c, 5, 7, truncation_r=r,
                                           return_log_probs=True)
        tok1, post1 = fs.fused_p_sample(logits[None], xt[None], c, 5, 7, truncation_r=r,
                                        return_log_probs=True)
        torch.cuda.synchronize()
        assert torch.equal(tok2, tok1[0]) and torch.equal(post2, post1[0])


# ---------------------------------------------------------------------------
# K10 (int8 MHA) and the bf16 MHA with its softmax divide folded
# ---------------------------------------------------------------------------

# K10 against its twin: the integer dots are exact, so only P's int8 rounding
# may differ (a P value on a .5 step of its grid after an ulp of exp). At the
# flagship shape that moved 0.08-1.04 % of the outputs by more than one bf16
# ulp (H100 runs); at most K10_SHARE of them may lie more than K10_ULPS ulps
# off. The bf16 MHA lies that far from the int8 twin on about half of them.
K10_ULPS, K10_SHARE = 2, 2e-2


def _share_beyond_ulps(got, want, ulps):
    w = want.float()
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133),
                      torch.exp2(torch.floor(torch.log2(w.abs())) - 7))
    return float(((got.float() - w).abs() > ulps * ulp).float().mean())


def _masked_tail_x4(v, batch, valid):
    """v with the keys at or beyond ``valid`` four times larger, so that they
    set V's column scale (taken over all keys, masked ones included)."""
    v = v.clone()
    v.view(batch, -1, v.shape[1])[:, valid:] *= 4
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["small", "flagship"])
def test_int8_and_folded_mha_match_plain(cuda, shape):
    """K10 against its twin, rounded once to bf16, and the folded bf16 MHA
    (``int8_kernels.mha(mode="bf16_fold")``, the blocks' ``attn="bf16_fold"``)
    against ``mha_reference(fold_div=True)``, at the self and the cross
    attention's key counts with and without masked tails (their v four times
    larger)."""
    from text_to_sound_synthesis_torch.ops import attention as attn
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik

    B, L, D, H, S, Dh = SHAPES[shape]
    d = _block_inputs(cuda, SHAPES[shape], False)
    x = d["x"]
    v = (torch.randn((B * L, D), generator=torch.Generator(cuda).manual_seed(9), device=cuda)
         * 0.5).bfloat16()
    for k, v, valid in ((x, v, L), (x, _masked_tail_x4(v, B, L - 3), L - 3), (d["ck"], d["cv"], S),
                        (d["ck"], _masked_tail_x4(d["cv"], B, S - 4), S - 4)):
        kw = dict(batch=B, n_head=H, kv_valid=valid)
        launches = ib.mha_inline_int8.launches
        got = ib.mha_inline_int8(x, k, v, **kw)
        want = ib.mha_inline_int8_reference(x, k, v, **kw).bfloat16()
        _check_kernel(ib.mha_inline_int8, got, want, launches)
        assert _share_beyond_ulps(got, want, K10_ULPS) <= K10_SHARE
        assert _share_beyond_ulps(attn.mha_reference(x, k, v, **kw), want, K10_ULPS) > K10_SHARE
        got = ik.mha(ik.load_kernel(), x, k, v, B, H, valid, mode="bf16_fold")
        torch.cuda.synchronize()
        want = attn.mha_reference(x, k, v, fold_div=True, **kw)
        torch.testing.assert_close(got.float(), want.float(), rtol=BLOCK_TOL, atol=BLOCK_TOL)


# K8 with the int8 MHA: its two halves run with x in f32 between them, so an
# int8 flip of the self half (of q, k, P or the proj input) reaches the cross
# half's quantize. At static scales this moved 94-98 of 2170880 flagship
# outputs beyond BLOCK_TOL, and one beyond 3e-2 (0.031 at a value of 0.016;
# H100 runs). JAX holds its pair kernel to 3e-2 for the same reason
# (tests/test_int8_blocks.py, test_attn_pair_block); chip_smoke.py lets
# PAIR_OUTLIERS of K8's outputs lie beyond it.
PAIR_TOL, PAIR_OUTLIERS = 3e-2, 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["small", "flagship"])
@pytest.mark.parametrize("attn", ["int8", "bf16_fold"])
@pytest.mark.parametrize("static", [False, True])
def test_attention_blocks_with_other_mha_match_plain(cuda, shape, attn, static):
    """K4 and K5 (W8 and W4) and K8 with ``attn``; K10 counts one launch per
    int8 MHA, the blocks one each. K8 with the int8 MHA within PAIR_TOL but
    for PAIR_OUTLIERS of its outputs."""
    from text_to_sound_synthesis_torch.ops import int8_block as ib

    B, L, D, H, S, Dh = SHAPES[shape]
    ss = (0.035, 0.02) if static else None
    for w4 in (False, True):
        d = _block_inputs(cuda, SHAPES[shape], w4)
        cases = [
            (ib.self_attn_block, ib.self_attn_block_reference, (d["x"], d["mod"], *d["attn"]),
             dict(q_valid=L - 3, static_s=ss, w4=w4), 1),
            (ib.cross_attn_block, ib.cross_attn_block_reference,
             (d["x"], d["mod"], d["ck"], d["cv"], *d["cross"]),
             dict(kv_valid=S - 4, static_s=ss, w4=w4), 1)]
        if not w4:
            mods = torch.cat([d["mod"], d["mod"].flip(1)]).contiguous()
            cases.append((ib.attn_pair_block, ib.attn_pair_block_reference,
                          (d["x"], mods, d["ck"], d["cv"], *d["attn"], *d["cross"]),
                          dict(q_valid=L - 3, kv_valid=S - 4, static_s=None if ss is None else ss * 2),
                          2))
        for kernel, plain, args, kw, n_mha in cases:
            k10 = ib.mha_inline_int8.launches
            launches = kernel.launches
            got = kernel(*args, batch=B, n_head=H, attn=attn, **kw)
            want = plain(*args, batch=B, n_head=H, attn=attn, **kw)
            if kernel is ib.attn_pair_block and attn == "int8":
                torch.cuda.synchronize()
                assert kernel.launches == launches + 1 and got.shape == want.shape
                d = (got.float() - want.float()).abs()
                beyond = int((d > PAIR_TOL + PAIR_TOL * want.float().abs()).sum())
                assert beyond <= PAIR_OUTLIERS * d.numel()
            else:
                _check_kernel(kernel, got, want, launches)
            assert ib.mha_inline_int8.launches == k10 + (n_mha if attn == "int8" else 0)


# the pair-packed MHA takes heads of 64: the flagship, and a small shape of two
PAIR_SHAPES = {"small64": (2, 40, 128, 2, 16, 512), "flagship": SHAPES["flagship"]}
# The pair MHA against its twin: f32 sums in another order move an output by
# one bf16 ulp at a rounding step, by more only where a rounded p moved too;
# at most PAIR_MHA_SHARE of the outputs may lie more than PAIR_MHA_ULPS off
# (the H100 read at most 9.2e-5, none at small64). The MHA that divides before
# P's rounding (the bf16 MHA beside "pair", the pair MHA beside "pair_nofold")
# lies that far on 0.3-16 %, and must fail the gate. K4 / K5 with the pair
# MHA: int8 flips too (up to 0.17 % of outputs more than one ulp off here on
# the H100, 0.50 % at chip_smoke.py's inputs), with the bf16 MHA 7.9-24 %.
PAIR_MHA_ULPS, PAIR_MHA_SHARE = 1, 5e-4
PAIR_BLOCK_ULPS, PAIR_BLOCK_SHARE = 1, 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(PAIR_SHAPES))
@pytest.mark.parametrize("mode", ["pair", "pair_nofold"])
def test_pair_mha_matches_plain(cuda, shape, mode):
    """The pair-packed MHA (``int8_kernels.mha(mode="pair")``, the blocks'
    ``attn="pair"``) and T3's ``pair_nofold`` against
    ``mha_pair_reference``, at the self (265) and the cross attention's (77)
    key counts, with and without masked tails: bf16 outputs of f32 sums run
    in another order, within BLOCK_TOL and the PAIR_MHA gate."""
    from text_to_sound_synthesis_torch.ops import attention as attn
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik

    B, L, D, H, S, Dh = PAIR_SHAPES[shape]
    d = _block_inputs(cuda, PAIR_SHAPES[shape], False)
    x = d["x"]
    lib = ik.load_kernel()                # the engine's MHAs; T3's pair_nofold is the probe's
    mode_lib = ik.load_probe_kernel() if mode == "pair_nofold" else lib
    v = torch.randn((B * L, D), generator=torch.Generator(cuda).manual_seed(9), device=cuda).bfloat16()
    for k, v, valid in ((x, v, L), (x, v, L - 3), (d["ck"], d["cv"], S), (d["ck"], d["cv"], S - 4)):
        got = ik.mha(mode_lib, x, k, v, B, H, valid, mode=mode)
        torch.cuda.synchronize()
        want = attn.mha_pair_reference(x, k, v, batch=B, n_head=H, kv_valid=valid,
                                       fold=mode == "pair")
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=BLOCK_TOL, atol=BLOCK_TOL)
        if mode == "pair":
            controls = (ik.mha(lib, x, k, v, B, H, valid),
                        attn.mha_reference(x, k, v, batch=B, n_head=H, kv_valid=valid))
        else:
            controls = (ik.mha(lib, x, k, v, B, H, valid, mode="pair"),)
        _ulp_gate(got, want, PAIR_MHA_ULPS, PAIR_MHA_SHARE, controls)


# Key counts at and beside the attention kernels' bucket edges (K10: 32, 96,
# 160, 288; the bf16 and pair MHAs: 32, 80, 144, 272), the cross attention's
# 77 and the self attention's 265
EDGE_KEYS = (1, 31, 32, 33, 77, 80, 265, 272)


@pytest.mark.gpu
@pytest.mark.parametrize("keys", EDGE_KEYS)
@pytest.mark.parametrize("batch", [1, 8])
def test_mha_kernels_at_bucket_edges(cuda, keys, batch):
    """K10 (16 heads of 64, 32 of 32) and the pair MHA (``mha_pair``, and
    T3's ``pair_nofold``) against their twins at 265 queries and ``keys``
    keys, the last three masked where there are more than three: within
    BLOCK_TOL and chip_smoke.py's gates (K10_ULPS / K10_SHARE, PAIR_MHA_ULPS
    / PAIR_MHA_SHARE); each wrapper counts its launch."""
    from text_to_sound_synthesis_torch.ops import attention as attn
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik

    L, D = 265, 1024
    g = torch.Generator(cuda).manual_seed(keys * 10 + batch)
    rnd = lambda rows: torch.randn((rows, D), generator=g, device=cuda).bfloat16()
    q, k, v = rnd(batch * L), rnd(batch * keys), rnd(batch * keys)
    valid = keys - 3 if keys > 3 else keys
    for H in (16, 32):
        kw = dict(batch=batch, n_head=H, kv_valid=valid)
        launches = ib.mha_inline_int8.launches
        got = ib.mha_inline_int8(q, k, v, **kw)
        want = ib.mha_inline_int8_reference(q, k, v, **kw).bfloat16()
        _check_kernel(ib.mha_inline_int8, got, want, launches)
        assert _share_beyond_ulps(got, want, K10_ULPS) <= K10_SHARE
    kw = dict(batch=batch, n_head=16, kv_valid=valid)
    launches = attn.mha_pair.launches
    got = attn.mha_pair(q, k, v, **kw)
    want = attn.mha_pair_reference(q, k, v, **kw)
    _check_kernel(attn.mha_pair, got, want, launches)
    _ulp_gate(got, want, PAIR_MHA_ULPS, PAIR_MHA_SHARE)
    got = ik.mha(ik.load_probe_kernel(), q, k, v, batch, 16, valid, mode="pair_nofold")
    torch.cuda.synchronize()
    want = attn.mha_pair_reference(q, k, v, fold=False, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    _ulp_gate(got, want, PAIR_MHA_ULPS, PAIR_MHA_SHARE)


@pytest.mark.gpu
@pytest.mark.parametrize("keys", EDGE_KEYS)
def test_k10_quantize_pass_writes_vt_slot_layout(cuda, keys):
    """K10's quantize pass writes V^T bit for bit as ``vt_slot_layout`` lays
    out V quantized with the pass's own column scales (batch 2, 8 heads of
    64: D 512 is eight blocks of 64 columns)."""
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik

    B, L, D = 2, 40, 512
    g = torch.Generator(cuda).manual_seed(keys)
    q, k, v = (torch.randn((B * n, D), generator=g, device=cuda).bfloat16() for n in (L, keys, keys))
    scratch = {}
    ik.mha_int8(ik.load_mha_int8(), q, k, v, B, 8, keys, scratch)
    torch.cuda.synchronize()
    sv = scratch["sv"]
    vq = torch.round(v.float().reshape(B, keys, D) / sv[:, None, :]).clamp(-127, 127)
    assert torch.equal(scratch["vt"], ik.vt_slot_layout(vq.to(torch.int8).reshape(B * keys, D), B))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(PAIR_SHAPES))
@pytest.mark.parametrize("static", [False, True])
def test_attention_blocks_with_pair_mha_match_plain(cuda, shape, static):
    """K4 and K5 (W8 and W4) with ``attn="pair"``, the engine's default at a
    head width of 64; one launch each, within BLOCK_TOL and the PAIR_BLOCK
    gate, which the blocks with the bf16 MHA (kernel, twin) fail."""
    from text_to_sound_synthesis_torch.ops import int8_block as ib

    B, L, D, H, S, Dh = PAIR_SHAPES[shape]
    ss = (0.035, 0.02) if static else None
    for w4 in (False, True):
        d = _block_inputs(cuda, PAIR_SHAPES[shape], w4)
        for kernel, plain, args, kw in (
                (ib.self_attn_block, ib.self_attn_block_reference, (d["x"], d["mod"], *d["attn"]),
                 dict(q_valid=L - 3)),
                (ib.cross_attn_block, ib.cross_attn_block_reference,
                 (d["x"], d["mod"], d["ck"], d["cv"], *d["cross"]), dict(kv_valid=S - 4))):
            launches = kernel.launches
            kw.update(batch=B, n_head=H, static_s=ss, w4=w4)
            got = kernel(*args, attn="pair", **kw)
            want = plain(*args, attn="pair", **kw)
            _check_kernel(kernel, got, want, launches)
            _ulp_gate(got, want, PAIR_BLOCK_ULPS, PAIR_BLOCK_SHARE,
                      (kernel(*args, attn="bf16", **kw), plain(*args, attn="bf16", **kw)))


# ---------------------------------------------------------------------------
# T2 and T3, the MLP and self-attention ablation probes, at their tools' shapes
# ---------------------------------------------------------------------------

# T2's outputs against its twins: dots_only is integers end to end (bf16 of
# an exact int32 sum) and mid_bf16 rounds every op of the middle to bf16 in
# the twin's order, its row scale too, so both are equal (as on the H100); the
# others are int8 blocks, BLOCK_TOL. mid_bf16b and mid_bf16c change K3's
# middle by a bf16 rounding (K3's twin misses BLOCK_TOL on only 238-335
# outputs): they, fast_sigmoid and no_gelu are also held to at most T2_SHARE
# of their outputs more than T2_ULPS off (the kernels read up to 0.31 %),
# which K3's twin (and for mid_bf16b / c the other's twin) must fail (27-99 %).
T2_EXACT = ("dots_only", "mid_bf16")
T2_ULPS, T2_SHARE = 1, 3e-2
T2_CONTROLS = {"mid_bf16b": ("K3", "mid_bf16c"), "mid_bf16c": ("K3", "mid_bf16b"),
               "fast_sigmoid": ("K3",), "no_gelu": ("K3",)}


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["dots_only", "no_prologue", "ln_onepass", "no_gelu",
                                     "no_quant_mid", "no_deq_mid", "mid_bf16", "mid_bf16b",
                                     "mid_bf16c", "fast_sigmoid"])
def test_mlp_ablate_kernels_match_plain(cuda, variant):
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import mlp_ablate as T2
    from text_to_sound_synthesis_torch.tools import bench_mlp_ablate as tool

    x, mod, w1, w2 = tool.inputs(cuda)
    launches = T2.mlp_variant.launches
    got = T2.mlp_variant(x, mod, w1, w2, variant=variant)
    want = T2.mlp_variant_reference(x, mod, w1, w2, variant=variant)
    if variant in T2_EXACT:
        torch.cuda.synchronize()
        assert T2.mlp_variant.launches == launches + 1 and torch.equal(got, want)
    else:
        _check_kernel(T2.mlp_variant, got, want, launches)
    if variant in T2_CONTROLS:
        twin = lambda c: (ib.mlp_block_reference(x, mod, w1, w2) if c == "K3" else
                          T2.mlp_variant_reference(x, mod, w1, w2, variant=c))
        _ulp_gate(got, want, T2_ULPS, T2_SHARE, [twin(c) for c in T2_CONTROLS[variant]])


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["qkvp_dots_only", "no_softmax", "no_av", "no_scores", "pair",
                                     "pair_nofold"])
@pytest.mark.parametrize("static", [False, True])
def test_attn_ablate_kernels_match_plain(cuda, variant, static):
    """At the tool's padded shape: 8 x 272 rows, keys from 265 masked."""
    from text_to_sound_synthesis_torch.ops import attn_ablate as T3
    from text_to_sound_synthesis_torch.tools import bench_attn_ablate as tool

    x, mod, ws = tool.inputs(cuda)
    kw = dict(batch=tool.B, n_head=tool.H, q_valid=tool.Q_VALID, variant=variant,
              static_s=(0.05, 0.05) if static else None)
    launches = T3.attn_variant.launches
    got = T3.attn_variant(x, mod, *ws, **kw)
    _check_kernel(T3.attn_variant, got, T3.attn_variant_reference(x, mod, *ws, **kw), launches)


# ---------------------------------------------------------------------------
# K11 (fused GroupNorm -> swish -> conv3x3, with its gradient) and T1 (the
# bare tiled dot)
# ---------------------------------------------------------------------------

# K11's bf16 output against the twin (TF32 off): the statistics are summed in
# another order and the conv's f32 sums too, so an f32 pre-rounding value can
# land on the other side of a bf16 rounding boundary: one bf16 ulp, at most
# 2^-7 of the value (an activation rounded the other way moves an output by
# |k| * 2^-8 * |a|, far less).
GN_TOL = 1e-2
# gradients of sum(y.float()^2) through the Function (kernel forward, the
# twin's VJP) and through the twin: the upstream gradients 2 y differ where y
# does, by a bf16 ulp (the H100 read up to 0.42 % of a gradient's largest
# value at the flagship stage, chip_smoke.py); given one upstream gradient
# the Function's backward is the twin's VJP, the same ops on the same values:
# bit for bit equal with cuDNN's deterministic algorithms (its default
# backward convs add with atomics, so the twin's VJP differs run to run)
GN_GRAD_TOL = 1e-2


def _gn_inputs(dev, B, H, W, C, Co, beta_shift=0.0, seed=5):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((B, H, W, C), generator=g, device=dev).bfloat16()
    gamma = 1 + 0.2 * torch.randn(C, generator=g, device=dev)
    beta = beta_shift + 0.2 * torch.randn(C, generator=g, device=dev)
    k = torch.randn((3, 3, C, Co), generator=g, device=dev) * 0.05
    return x, gamma, beta, k, 0.1 * torch.randn(Co, generator=g, device=dev)


# (B, H, W, C, Co, groups): the decoder's five stages and its channel
# transitions, C 32 (half a 64-channel chunk), 64, 96 (a chunk and a half) and
# 2048, W 1, H 1, widths no multiple of a strip or a tile, B 1, 8 groups
GN_SHAPES = [(8, 20, 212, 256, 256, 32),   # a flagship decoder stage
             (2, 5, 53, 64, 128, 32),      # ragged rows (W = 53)
             (2, 5, 53, 64, 128, 8),
             (8, 5, 53, 512, 512, 32), (8, 10, 106, 256, 256, 32), (8, 40, 424, 128, 128, 32),
             (8, 80, 848, 128, 128, 32),   # the other four stages
             (8, 10, 106, 512, 256, 32), (8, 40, 424, 256, 128, 32),   # C != Co
             (2, 5, 53, 32, 128, 8), (2, 6, 37, 96, 256, 32), (2, 5, 53, 2048, 128, 32),
             (1, 7, 1, 64, 128, 32), (3, 1, 9, 64, 256, 8), (1, 1, 1, 32, 128, 32),
             (1, 3, 301, 64, 128, 32), (1, 9, 67, 128, 384, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GN_SHAPES)
@pytest.mark.parametrize("beta_shift", [0.0, 6.0])               # 6: the zero ring matters
def test_gn_swish_conv_kernel_matches_plain(cuda, shape, beta_shift):
    """Within GN_TOL of the twin; two runs bit for bit equal; f32 refused."""
    from text_to_sound_synthesis_torch.ops import fused_gn_conv as gn

    B, H, W, C, Co, G = shape
    args = _gn_inputs(cuda, B, H, W, C, Co, beta_shift)
    launches = gn.gn_swish_conv.launches
    got = gn.gn_swish_conv(*args, groups=G)
    want = gn.gn_swish_conv_reference(*args, groups=G)
    _check_kernel(gn.gn_swish_conv, got, want, launches, tol=GN_TOL)
    assert torch.equal(gn.gn_swish_conv(*args, groups=G), got)
    with pytest.raises(TypeError):
        gn.gn_swish_conv(args[0].float(), *args[1:], groups=G)


@pytest.mark.gpu
@pytest.mark.parametrize("plan", [(3, 128), (7, 128), (32, 256), (55, 128), (76, 256),
                                  (141, 128), (77, 256)])
def test_gn_swish_conv_plans_agree(cuda, plan):
    """Every plan (strip pitch, tile rows) gives the same bits: a tile's sums
    run in one fixed order whatever its geometry; at the widest pitches the
    halo window fills the buffer."""
    from text_to_sound_synthesis_torch.ops import fused_gn_conv as gn

    args = _gn_inputs(cuda, 2, 6, 300, 96, 256, 6.0)
    a = gn._prepare(*args, groups=32)
    want = gn._run(a).clone()
    a["plan"] = plan
    assert torch.equal(gn._run(a), want)
    torch.testing.assert_close(want.float(), gn.gn_swish_conv_reference(*args, groups=32).float(),
                               rtol=GN_TOL, atol=GN_TOL)


@pytest.mark.gpu
def test_gn_swish_conv_refuses_plans_beyond_the_halo(cuda):
    from text_to_sound_synthesis_torch.ops import fused_gn_conv as gn

    a = gn._prepare(*_gn_inputs(cuda, 1, 4, 500, 64, 256), groups=32)
    for plan in [(78, 256), (142, 128), (2, 128), (7, 64)]:
        a["plan"] = plan
        with pytest.raises(RuntimeError):
            gn._run(a, "conv")


@pytest.mark.gpu
def test_gn_swish_conv_gradient_matches_plain(cuda):
    from text_to_sound_synthesis_torch.ops import fused_gn_conv as gn

    grads, vjps, up = [], [], None
    # the twin's backward convs, run here: full f32, deterministic
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for fn in (gn.gn_swish_conv_reference, gn.gn_swish_conv):
            leaves = [t.clone().requires_grad_(True) for t in _gn_inputs(cuda, 2, 5, 53, 64, 128)]
            y = fn(*leaves, groups=32)
            up = 2 * y.detach() if up is None else up      # the twin's upstream, for both
            grads.append(torch.autograd.grad(y.float().square().sum(), leaves,
                                             retain_graph=True))
            vjps.append(torch.autograd.grad(y, leaves, up))
    for want, got, vwant, vgot in zip(*grads, *vjps):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert float((got.float() - want.float()).abs().max()) <= GN_GRAD_TOL * float(
            want.float().abs().max())
        assert torch.equal(vgot, vwant)


@pytest.mark.gpu
def test_gn_swish_conv_backward_is_deterministic(cuda):
    """Two runs of the Function's backward, under the global cuDNN settings
    (its own are the deterministic algorithms), give the same gradients, bit
    for bit, at a flagship decoder stage."""
    from text_to_sound_synthesis_torch.ops import fused_gn_conv as gn

    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in _gn_inputs(cuda, 8, 20, 212, 256, 256)]
        y = gn.gn_swish_conv(*leaves, groups=32)
        runs.append(torch.autograd.grad(y, leaves, torch.ones_like(y)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["int8->int32", "int8->f32", "bf16->f32"])
def test_tiled_dot_kernel_matches_plain(cuda, case):
    """The probe's fc1 shape; the int cases bit for bit, bf16 -> f32 within
    4 K 2^-24 sum_k |x_k w_k|: each side within 2 K 2^-24 of the exact sum in
    any order, even where the tensor cores' adds truncate (2^-23 per add)."""
    from text_to_sound_synthesis_torch.ops import dot as D
    from text_to_sound_synthesis_torch.tools import bench_kernel_dot as tool

    torch.backends.cuda.matmul.allow_tf32 = False
    kern, plain = tool.cases(cuda)[case]
    launches = D.tiled_dot.launches
    got, want = kern(), plain()
    torch.cuda.synchronize()
    assert D.tiled_dot.launches == launches + 1
    assert got.dtype == want.dtype and got.shape == want.shape == (tool.M, tool.N)
    if case.startswith("int8"):
        assert torch.equal(got, want)
    else:
        x8, w8, xb, wb = tool.inputs(cuda)
        bound = 4 * tool.K * 2.0 ** -24 * (xb.float().abs() @ wb.float().abs())
        assert bool(((got - want).abs() <= bound).all())


# ---------------------------------------------------------------------------
# The Hopper mainloop (csrc/int8_gemm_sm90.cuh) at ragged and edge shapes:
# K3's two launches (fc1 on the LN panel, the static fc2 in the int8 A mode),
# T1's int8 dots and T2's fc1 epilogues (K6's and K9's launches further down). Integer sums are exact, so every
# launch that is bit-equal to its twin at the flagship is so here too.
# ---------------------------------------------------------------------------

# rows: one, a warpgroup's edge, a tile's edge, past a tile, the flagship's
# 2120 (17 tiles, the last of 72 rows) and the probes' 2176
SM90_ROWS = [1, 63, 65, 129, 2120, 2176]


def _mlp_inputs(dev, M, D, Dh, w4, seed=11):
    """x (M, D) bf16 whose rows are half +2^e, half -2^e (e in -1..1 per row),
    in a random order: their mean (0) and variance (4^e) are exact in f32
    whatever order the sums run in, so the kernel's LayerNorm and the twin's
    agree bit for bit and no int8 flip can hide or fake a difference of the
    GEMM (on Gaussian rows an ulp of the statistics moves a value across a .5
    step now and then, whatever the mainloop). The LN
    affine, the weights and biases are Gaussian."""
    from text_to_sound_synthesis_torch.ops.quant import quantize_weight, quantize_weight_w4

    g = torch.Generator(dev).manual_seed(seed)
    rnd = lambda *s, scale=1.0: torch.randn(s, generator=g, device=dev) * scale
    q = quantize_weight_w4 if w4 else quantize_weight
    signs = torch.ones((M, D), device=dev)
    signs[:, D // 2:] = -1.0
    order = torch.argsort(torch.rand((M, D), generator=g, device=dev), dim=1)
    x = signs.gather(1, order) * 2.0 ** torch.randint(-1, 2, (M, 1), generator=g, device=dev)
    ln = rnd(2, D, scale=0.2)
    ln[0] += 1.0
    return (x.bfloat16(), ln, q(rnd(Dh, D, scale=0.03 * (1024 / D) ** 0.5), rnd(Dh, scale=0.05)),
            q(rnd(D, Dh, scale=0.03 * (1024 / Dh) ** 0.5), rnd(D, scale=0.05)))


def _counters_zero(dev):
    """The stream-K counters (the workspace's tail) are back at zero."""
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik

    ws = ik.workspace(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return int(ws[-sms:].abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("M", SM90_ROWS)
@pytest.mark.parametrize("width", [(128, 512), (1024, 4096)])
@pytest.mark.parametrize("w4", [False, True])
def test_sm90_mlp_static_matches_plain_bitwise(cuda, M, width, w4):
    """K3 with static scales, W8 and W4: fc1 on the panel (K = D: 128 or
    1024; N = Dh) with the GELU2 -> int8 epilogue, fc2 in the int8 A mode (K
    = Dh: 512 or 4096; N = D: 128 or 1024; at the flagship 17 x 8 = 136 tiles,
    the stream-K tail) with the residual epilogue: equal to the twin bit for
    bit, and the stream-K counters back at zero."""
    from text_to_sound_synthesis_torch.ops import int8_block as ib

    D, Dh = width
    x, ln, w1, w2 = _mlp_inputs(cuda, M, D, Dh, w4)
    launches = ib.mlp_block.launches
    got = ib.mlp_block(x, ln, w1, w2, static_s=(0.035, 0.012), w4=w4)
    want = ib.mlp_block_reference(x, ln, w1, w2, static_s=(0.035, 0.012), w4=w4)
    torch.cuda.synchronize()
    assert ib.mlp_block.launches == launches + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = got != want
    assert torch.equal(got, want), (int(diff.sum()), int(diff.any(1).sum()), int(diff.any(0).sum()))
    assert _counters_zero(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("M", SM90_ROWS)
@pytest.mark.parametrize("w4", [False, True])
def test_sm90_fc1_row_max_epilogue(cuda, M, w4):
    """K3's dynamic fc1 (the panel, GELU2 -> f32 with the kEfMax row max per
    N chunk, 1 and 4 chunks as K3 and K9 take it) at D 1024 -> 4096: the
    output within BLOCK_TOL of the twin's middle (the f32 LayerNorm sums run
    in another order: int8 flips), each row max equal to the max |u| of the
    kernel's own output over its chunk."""
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik
    from text_to_sound_synthesis_torch.ops.quant import _deq, _gelu2, _prologue, _quantize_rows, int_dot

    x, ln, w1, _ = _mlp_inputs(cuda, M, 1024, 4096, w4)
    lib = ik.load_kernel()
    w_plain = ib._plain_weights((w1,), w4)[0]
    qx, s = _quantize_rows(_prologue(x.float(), ln[0:1], ln[1:2], "ln"))
    want = _gelu2(_deq(int_dot(qx, w_plain.w_q), s, w_plain))
    for nch in (1, 4):
        u = torch.empty((M, 4096), dtype=torch.float32, device=cuda)
        amax = torch.empty((M, nch), dtype=torch.float32, device=cuda)
        ik.dense(lib, x, (w1,), (u,), norm="ln", mod=ln, gelu=True, amax_out=amax, nch=nch, w4=w4)
        torch.cuda.synchronize()
        torch.testing.assert_close(u, want, rtol=BLOCK_TOL, atol=BLOCK_TOL)
        assert torch.equal(amax, u.abs().reshape(M, nch, -1).amax(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("M", SM90_ROWS)
@pytest.mark.parametrize("N", [128, 1024, 4096])
@pytest.mark.parametrize("K", [64, 1024, 4096])
def test_sm90_tiled_dot_int_matches_plain_bitwise(cuda, M, N, K):
    """T1's int8 cases on the int8 A mode at ragged rows, one to 32 column
    tiles and K from half a step (its TMA boxes zero-filled past K) to 32
    steps: int32 and f32 outputs equal to the twin's; counters back at zero."""
    from text_to_sound_synthesis_torch.ops import dot as D

    g = torch.Generator(cuda).manual_seed(M + N + K)
    x = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
    w = D.k_contiguous(torch.randint(-127, 128, (K, N), generator=g, device=cuda, dtype=torch.int8))
    for out_dtype in (torch.int32, torch.float32):
        got = D.tiled_dot(x, w, out_dtype)
        want = D.tiled_dot_reference(x, w, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), int((got != want).sum())
    assert _counters_zero(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 65, 2120])
@pytest.mark.parametrize("variant", ["dots_only", "mid_bf16", "no_quant_mid", "no_deq_mid"])
def test_sm90_mlp_ablate_epilogues(cuda, M, variant):
    """T2's fc1 epilogues on the panel at ragged rows (D 1024 -> 4096):
    dots_only (kEpiWrap8, then the raw bf16 fc2) and mid_bf16 (kEfMidBf16)
    equal to their twins; no_quant_mid (kEpiClip8) and no_deq_mid
    (kEpiShift8, both storing the panel's row max for fc2) within BLOCK_TOL."""
    from text_to_sound_synthesis_torch.ops import mlp_ablate as T2

    x, ln, w1, w2 = _mlp_inputs(cuda, M, 1024, 4096, False)
    launches = T2.mlp_variant.launches
    got = T2.mlp_variant(x, ln, w1, w2, variant=variant)
    want = T2.mlp_variant_reference(x, ln, w1, w2, variant=variant)
    if variant in T2_EXACT:
        torch.cuda.synchronize()
        assert T2.mlp_variant.launches == launches + 1 and torch.equal(got, want)
    else:
        _check_kernel(T2.mlp_variant, got, want, launches)


@pytest.mark.gpu
def test_sm90_refuses_what_it_does_not_take(cuda):
    """A shape outside the kernels' limits raises from the wrapper, before a
    launch: N not a multiple of 128, K not a multiple of 64 (T1)."""
    from text_to_sound_synthesis_torch.ops import dot as D

    x = torch.zeros((8, 96), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        D.tiled_dot(x, D.k_contiguous(torch.zeros((96, 128), dtype=torch.int8, device=cuda)),
                    torch.int32)
    x = torch.zeros((8, 128), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        D.tiled_dot(x, D.k_contiguous(torch.zeros((128, 192), dtype=torch.int8, device=cuda)),
                    torch.int32)
    # the quantize passes: the row pass's width (a multiple of 128, at most
    # 1024) and its f32 rows (AdaLN only); the wide pass's width and chunks (a
    # multiple of 4); K6 with a norm past the row pass, or any K not a
    # multiple of 64; K9's chunks narrower than 128
    from text_to_sound_synthesis_torch.ops import int8_block as ib
    from text_to_sound_synthesis_torch.ops import quant

    mod = lambda K: torch.zeros((2, K), device=cuda)
    for K in (192, 2048):
        with pytest.raises(ValueError):
            quant.quantize_rows(torch.zeros((8, K), dtype=torch.bfloat16, device=cuda), mod(K))
    with pytest.raises(TypeError):
        quant.quantize_rows(torch.zeros((8, 256), device=cuda), mod(256), norm="ln")
    with pytest.raises(ValueError):
        quant.quantize_wide(torch.zeros((8, 130), device=cuda))
    with pytest.raises(ValueError):
        quant.quantize_wide(torch.zeros((8, 24), device=cuda),   # chunks of 6
                            amax=torch.ones((8, 4), device=cuda))
    d = _block_inputs(cuda, SHAPES["small"], False)
    w = quant.quantize_weight(torch.zeros((128, 2048), device=cuda))
    with pytest.raises(ValueError):
        quant.fused_quant_dense(torch.zeros((8, 2048), dtype=torch.bfloat16, device=cuda), w,
                                norm="ln", mod=mod(2048))
    w = quant.quantize_weight(torch.zeros((128, 96), device=cuda))
    with pytest.raises(ValueError):
        quant.fused_quant_dense(torch.zeros((8, 96), dtype=torch.bfloat16, device=cuda), w)
    with pytest.raises(ValueError):
        ib.mlp_block_chunked(d["x"], d["ln"], *d["mlp"], n_chunks=8)


# ---------------------------------------------------------------------------
# The Hopper MHA (csrc/mha_sm90.cuh: K7, the blocks' "bf16" and "bf16_fold"
# MHAs, T3's probe modes) and the attention blocks' quantize pass
# ---------------------------------------------------------------------------

# every key bucket's edge (32, 144, 272) and the flagship's 77 and 265 keys
MHA90_KEYS = [32, 77, 144, 265, 272]
# The bf16 MHA against its twin: f32 sums in another order move an output by
# an ulp at a rounding step, by more only where a rounded p moved too: the
# H100 read at most 2.4e-4 of the outputs more than one bf16 ulp off
# (PERF.md), at every shape below.
MHA90_SHARE = 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("mode", ["bf16", "bf16_fold"])
@pytest.mark.parametrize("batch", [1, 8])
def test_sm90_mha_matches_plain(cuda, hd, mode, batch):
    """The Hopper MHA against ``mha_reference`` (``fold_div`` for
    "bf16_fold") at 265 queries (four 64-query tiles and a ragged fifth), at
    each of MHA90_KEYS with and without a masked tail of 5 keys whose v is
    four times larger: within BLOCK_TOL, at most MHA90_SHARE of the outputs
    more than one bf16 ulp off; ``fused_mha`` counts one launch a call."""
    from text_to_sound_synthesis_torch.ops import attention as attn
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik

    H = 16 if hd == 64 else 4
    D, Lq = hd * H, 265
    g = torch.Generator(cuda).manual_seed(hd + batch)
    q = torch.randn((batch * Lq, D), generator=g, device=cuda).bfloat16()
    lib = ik.load_kernel()
    for Lkv in MHA90_KEYS:
        k = torch.randn((batch * Lkv, D), generator=g, device=cuda).bfloat16()
        v = torch.randn((batch * Lkv, D), generator=g, device=cuda).bfloat16()
        for valid in (Lkv, Lkv - 5):
            vv = _masked_tail_x4(v, batch, valid)
            kw = dict(batch=batch, n_head=H, kv_valid=valid)
            want = attn.mha_reference(q, k, vv, fold_div=mode == "bf16_fold", **kw)
            if mode == "bf16":
                launches = attn.fused_mha.launches
                got = attn.fused_mha(q, k, vv, **kw)
                _check_kernel(attn.fused_mha, got, want, launches)
            else:
                got = ik.mha(lib, q, k, vv, batch, H, valid, mode=mode)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(), rtol=BLOCK_TOL,
                                           atol=BLOCK_TOL)
            assert _ulp_flips(got, want, 1) <= MHA90_SHARE * want.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("probe", ["no_softmax", "no_av", "no_scores"])
def test_sm90_mha_probe_modes_match_plain(cuda, probe):
    """T3's MHA modes of the Hopper MHA (the probe library) against
    ``mha_probe_reference`` at T3's shape, 8 x 272 rows, keys from 265
    masked: within BLOCK_TOL and MHA90_SHARE."""
    from text_to_sound_synthesis_torch.ops import attn_ablate as ab
    from text_to_sound_synthesis_torch.ops import int8_kernels as ik

    B, L, H, D = 8, 272, 16, 1024
    g = torch.Generator(cuda).manual_seed(21)
    q, k, v = (torch.randn((B * L, D), generator=g, device=cuda).bfloat16() for _ in range(3))
    got = ik.mha(ik.load_probe_kernel(), q, k, v, B, H, 265, mode=probe)
    torch.cuda.synchronize()
    want = ab.mha_probe_reference(q, k, v, batch=B, n_head=H, kv_valid=265, probe=probe)
    torch.testing.assert_close(got.float(), want.float(), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    assert _ulp_flips(got, want, 1) <= MHA90_SHARE * want.numel()


def _pm_rows(dev, M, K, g):
    """(M, K) rows half +2^e, half -2^e (e in 3..5 per row), in a random
    order: their LayerNorm statistics are exact in f32 in any order, and
    4^e + 1e-6 rounds to 4^e, whose 1/sqrt is exact: the card's rsqrtf and
    the CPU's torch.rsqrt agree there (elsewhere they may differ by an ulp)."""
    signs = torch.ones((M, K), device=dev)
    signs[:, K // 2:] = -1.0
    order = torch.argsort(torch.rand((M, K), generator=g, device=dev), dim=1)
    return signs.gather(1, order) * 2.0 ** torch.randint(3, 6, (M, 1), generator=g, device=dev)


def _half_rows(dev, M, K, g, e: int = -3):
    """(M, K) rows whose quotients by their row scale sit on half-integers:
    (n + 0.5) 2^e for n in -127..126, and 127 2^e once a row, so that the
    row max is 127 2^e and s = max / 127 is 2^e: every value exact in bf16
    and f32, every h / s a tie for rint, inside quant_div's band."""
    n = torch.randint(-127, 127, (M, K), generator=g, device=dev).float() + 0.5
    n[torch.arange(M, device=dev), torch.randint(0, K, (M,), generator=g, device=dev)] = 127.0
    return n * 2.0 ** e


# the row pass's grid edges: one and two rows a block, about one wave of the
# 132 SMs (131, 132, 133 rows), 2112 = 132 x 16 and the flagship's 2120
# (one wave of 1060 blocks) beside 2121, and two flagships' rows
ROW_PASS_M = [1, 65, 131, 132, 133, 2112, 2120, 2121, 4240]


@pytest.mark.gpu
@pytest.mark.parametrize("M", ROW_PASS_M)
@pytest.mark.parametrize("K", [128, 640, 1024])
@pytest.mark.parametrize("case", ["adaln bf16", "adaln f32", "none bf16", "ln bf16"])
@pytest.mark.parametrize("static", [False, True])
def test_quantize_rows_kernel_matches_plain_bitwise(cuda, M, K, case, static):
    """The quantize pass against its plain version run on the CPU, where the
    twins' divides are correctly rounded (on the card PyTorch divides by a
    Python number through its reciprocal): int8 rows and row maxima equal bit
    for bit. AdaLN on rows whose statistics are exact in any order
    (``_pm_rows``), no norm on Gaussian rows and on rows of half-integer
    quotients (``_half_rows``: quant_div's band); one launch a call. AdaLN on
    Gaussian rows too: there an ulp of the statistics may move an int8 value
    by one, in at most 1e-4 of them."""
    from text_to_sound_synthesis_torch.ops import int8_block as ib

    norm, dtype = case.split()
    dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(cuda).manual_seed(M + K)
    mod = torch.randn((2, K), generator=g, device=cuda) * 0.2 if norm != "none" else None
    s = 0.035 if static else None
    kw = dict(static_s=s, norm="ln" if norm == "ln" else "adaln")
    xs = [_pm_rows(cuda, M, K, g)] if norm != "none" else [_half_rows(cuda, M, K, g)]
    xs.append(torch.randn((M, K), generator=g, device=cuda) * 2)
    for i, x in enumerate(xs):
        x = x.to(dtype)
        launches = ib.quantize_rows.launches
        q, amax = ib.quantize_rows(x, mod, **kw)
        torch.cuda.synchronize()
        assert ib.quantize_rows.launches == launches + 1
        wq, wamax = ib.quantize_rows_reference(x.cpu(), None if mod is None else mod.cpu(), **kw)
        assert q.dtype == torch.int8 and q.shape == (M, K)
        assert (amax is None) == static
        exact = norm == "none" or i == 0
        if exact:
            assert torch.equal(q.cpu(), wq), int((q.cpu() != wq).sum())
            assert static or torch.equal(amax.cpu(), wamax)
        else:
            d = (q.cpu().int() - wq.int()).abs()
            assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-4 * d.numel()


# ---------------------------------------------------------------------------
# K6 and K9 on the Hopper mainloop: the wide quantize pass, every int8 A mode
# epilogue K6 takes, and K9's chunked epilogue, each against its plain
# version bit for bit. The row scales the plain versions use are taken on the
# CPU, whose divides are correctly rounded as the kernels' are (on the card
# PyTorch divides by a Python number through its reciprocal).
# ---------------------------------------------------------------------------

def _amax_rows(dev, M, nch, g):
    """(M, nch) row maxima: powers of two and Gaussian magnitudes, some below
    the 1e-8 floor."""
    a = torch.rand((M, nch), generator=g, device=dev) * 4
    a[::7] = 2.0 ** torch.randint(-3, 4, (a[::7].shape[0], nch), generator=g, device=dev).float()
    a[::11] = 1e-9
    return a


def _wide_cases():
    """(K, mode) of the wide pass: widths a multiple of 16 (16-byte units)
    and not (K 4, 12, 1028: 4-value units and a tail), each with the row's
    own max, a static scale, and given maxima at 1, 4 and 16 chunks where
    they divide K into multiples of 4, and at chunk widths 4 and 12 (12 at K
    12 is one chunk)."""
    cases = []
    for K in (4, 12, 1024, 1028, 4096):
        nchs = [n for n in (1, 4, 16) if K % (4 * n) == 0]
        widths = [c for c in (4, 12) if K % c == 0 and K // c not in nchs]
        cases += [(K, m) for m in ["own max", "static"] + [f"nch {n}" for n in nchs]
                  + [f"cw {c}" for c in widths]]
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 65, 2120])
@pytest.mark.parametrize("K,mode", _wide_cases())
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sm90_quantize_wide_matches_plain_bitwise(cuda, M, K, mode, dtype):
    """The wide pass against its plain version run on the CPU: the row's own
    max (K6's fc2), given per-(row, chunk) maxima at 1, 4 and 16 chunks (the
    MLP middle of K3 and K9) and at chunk widths 4 and 12, a static scale;
    every fifth row (``_half_rows``) with quotients on half-integers, where
    quant_div's band hands the rounding to the exact divide; int8 rows and
    maxima equal bit for bit; one launch a call."""
    from text_to_sound_synthesis_torch.ops import quant

    g = torch.Generator(cuda).manual_seed(M + K)
    x = torch.randn((M, K), generator=g, device=cuda) * 2
    half = torch.arange(M, device=cuda) % 5 == 1
    x[half] = _half_rows(cuda, int(half.sum()), K, g)
    x = x.to(dtype)
    kind, n = mode.split()[0], mode.split()[-1]
    nch = None if kind in ("own", "static") else int(n) if kind == "nch" else K // int(n)
    amax = None if nch is None else _amax_rows(cuda, M, nch, g)
    if nch is not None:   # the maxima of the chunks themselves where they are not tiny
        own = x.float().abs().reshape(M, nch, -1).amax(-1)
        amax = torch.where(torch.arange(M, device=cuda)[:, None] % 3 == 0, own, amax)
        amax[half] = 127.0 * 2.0 ** -3        # s = 2^-3: the half rows' ties
    s = 0.035 if mode == "static" else None
    launches = quant.quantize_wide.launches
    q, got_amax = quant.quantize_wide(x, static_s=s, amax=amax)
    torch.cuda.synchronize()
    assert quant.quantize_wide.launches == launches + 1
    wq, wamax = quant.quantize_wide_reference(x.cpu(), static_s=s,
                                              amax=None if amax is None else amax.cpu())
    assert q.dtype == torch.int8 and q.shape == (M, K)
    assert torch.equal(q.cpu(), wq), int((q.cpu() != wq).sum())
    assert (got_amax is None) == (wamax is None)
    if wamax is not None:
        assert torch.equal(got_amax.cpu(), wamax)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_passes_refuse_unaligned_inputs(cuda, dtype):
    """Inputs whose base is not 16-byte aligned (a view one element into a
    flat buffer) are refused by the wrappers with ValueError, before any
    launch: both passes load 16 bytes at a time."""
    from text_to_sound_synthesis_torch.ops import quant

    M = 130
    for K, fn in ((1024, lambda x: quant.quantize_rows(x, None, static_s=None)),
                  (4096, lambda x: quant.quantize_wide(x)),
                  (4096, lambda x: quant.quantize_wide(x, static_s=0.03))):
        buf = torch.randn(M * K + 8, device=cuda).to(dtype)
        x = buf[1:1 + M * K].view(M, K)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        rows, wide = quant.quantize_rows.launches, quant.quantize_wide.launches
        with pytest.raises(ValueError):
            fn(x)
        assert (quant.quantize_rows.launches, quant.quantize_wide.launches) == (rows, wide)


# every (act, residual, out) combination K6 takes
K6_EPILOGUES = [(act, res, out) for act in ("none", "gelu2") for res in (None, "bf16", "f32")
                for out in ("bf16", "f32")]


@pytest.mark.gpu
@pytest.mark.parametrize("M", SM90_ROWS)
@pytest.mark.parametrize("epi", K6_EPILOGUES, ids=lambda e: "-".join(map(str, e)))
@pytest.mark.parametrize("static", [False, True])
def test_sm90_int8_dense_epilogues_match_plain_bitwise(cuda, M, epi, static):
    """K6's dot launch (the int8 A mode, ``quant._dense_int8``) in each of its
    epilogue instantiations, at ragged rows, two weights sharing A (K 1024, N
    512), against ``_dense_int8_reference`` on the card with the row scales
    taken on the CPU: equal bit for bit; counters back at zero."""
    from text_to_sound_synthesis_torch.ops import quant

    act, res, out = epi
    g = torch.Generator(cuda).manual_seed(M)
    K, N = 1024, 512
    qa = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
    amax = None if static else _amax_rows(cuda, M, 1, g)[:, 0].contiguous()
    ws = [quant.quantize_weight(torch.randn((N, K), generator=g, device=cuda) * 0.03,
                                torch.randn(N, generator=g, device=cuda) * 0.05) for _ in range(2)]
    residual = None if res is None else torch.randn((M, N), generator=g, device=cuda).to(
        torch.bfloat16 if res == "bf16" else torch.float32)
    kw = dict(residual=residual, out_dtype=torch.bfloat16 if out == "bf16" else torch.float32,
              gelu=act == "gelu2")
    got = quant._dense_int8(qa, amax, ws, 0.035 if static else None, False, **kw)
    s = quant._row_scale(None if static else amax.cpu(), 0.035)
    want = quant._dense_int8_reference(qa, s if static else s.to(cuda), ws, False, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), int((a != b).sum())
    assert _counters_zero(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("M", SM90_ROWS)
@pytest.mark.parametrize("nch", [1, 4, 16])
@pytest.mark.parametrize("static", [False, True])
def test_sm90_chunked_epilogue_matches_plain_bitwise(cuda, M, nch, static):
    """K9's fc2 (the chunked epilogue, data-parallel) at 1, 4 and 16 chunks
    of K 4096 (N 1024: at 2120 rows 136 tiles), against
    ``_dense_int8_reference`` on the card with the per-(row, chunk) scales
    taken on the CPU: the f32 flushes in the twin's order, equal bit for bit."""
    from text_to_sound_synthesis_torch.ops import quant

    g = torch.Generator(cuda).manual_seed(M + nch)
    K, N = 4096, 1024
    qa = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
    amax = None if static else _amax_rows(cuda, M, nch, g)
    w = quant.quantize_weight(torch.randn((N, K), generator=g, device=cuda) * 0.015,
                              torch.randn(N, generator=g, device=cuda) * 0.05)
    x = torch.randn((M, N), generator=g, device=cuda).bfloat16()
    (got,) = quant._dense_int8(qa, amax, (w,), 0.012 if static else None, False, residual=x,
                               n_chunks=nch)
    s = quant._row_scale(None if static else amax.cpu(), 0.012)
    (want,) = quant._dense_int8_reference(qa, s if static else s.to(cuda), (w,), False,
                                          residual=x, n_chunks=nch)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want), int((got != want).sum())
