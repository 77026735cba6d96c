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
        launches = kernel.launches
        got = kernel(*args, static_s=ss, w4=w4, **kw)
        want = plain(*args, static_s=ss, w4=w4, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == launches + 1
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=BLOCK_TOL, atol=BLOCK_TOL)
        if static and kernel is ib.mlp_block:
            # no row max and no softmax to sum in another order: bit for bit
            assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K6 (per-dense), K7 (MHA), K8 (attention pair) and K9 (chunked MLP)
# ---------------------------------------------------------------------------

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
        launches = multi.launches
        got = multi(*args, **kw)
        _check_kernel(multi, got, quant.quant_dense_multi_reference(*args, **kw), launches)
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
    launches = ib.attn_pair_block.launches
    got = ib.attn_pair_block(*args, **pair_kw)
    _check_kernel(ib.attn_pair_block, got, ib.attn_pair_block_reference(*args, **pair_kw),
                  launches)
    ss = (0.035, 0.012) if static else None
    for kernel, n_chunks in ((ib.mlp_block_chunked, 4), (ib.mlp_block_streamed, min(16, Dh // 128))):
        launches = kernel.launches
        got = kernel(d["x"], d["ln"], *d["mlp"], n_chunks=n_chunks, static_s=ss)
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
    (``int8_kernels.mha(fold_div=True)``, the blocks' ``attn="bf16_fold"``)
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
        got = ik.mha(ik.load_kernel(), x, k, v, B, H, valid, fold_div=True)
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
