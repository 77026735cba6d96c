"""The quantize passes' arithmetic on the card, modelled on the CPU.

``csrc/int8_quant.cuh`` quantizes a value under a dynamic row scale as
``quant_div``: t = h * y with y = rcp_refined(s), within an ulp of 1 / s;
where t clipped to +-127 lies more than ``kQuantBand`` = 2^-13 from a
half-integer, its rounding is taken as the integer, and inside that band the
correctly rounded h / s (``div_rn_by``) decides. Here that rule, in numpy
float32, is held against the twin's integer (``quant._quantize_rows``:
round(h / s) clipped to +-127, h / s correctly rounded) for s = max(amax,
1e-8) / 127 over many amax, h at and around every half-integer quotient and
the +-127 edge, and y each f32 within a step of the nearest to 1 / s.

The row pass (``quant_rows_kernel``) sums a row's LayerNorm statistics in
the order of the GEMM's LN panel and of the row pass it replaced: lane l of
a warp its values x[128 c + 4 l + e] in order of c, then e, then the warp's
xor butterfly (each of the row's two warps alike, from the row staged in
shared memory). A torch model of that order equals the twin and JAX's
``_prologue`` + ``_quant`` bit for bit on rows whose statistics are exact in
any order, and on Gaussian rows moves at most 1e-4 of the int8 values, by
one: an ulp of the statistics.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_to_sound_synthesis_tpu.ops import int8_block as JB
from text_to_sound_synthesis_tpu.ops import quant as JQ
from text_to_sound_synthesis_torch.ops import quant as TQ

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BAND = np.float32(2.0 ** -13)          # kQuantBand
MAGIC = np.float32(12582912.0)         # 1.5 * 2^23: rint on the adder (round_clip_q)
F32 = np.float32


# ---------------------------------------------------------------------------
# quant_div's rule
# ---------------------------------------------------------------------------

def rule(h, y):
    """quant_div's fast path in f32: (its integer, decided), decided False
    where t clipped lies within the band of a half-integer."""
    with np.errstate(all="ignore"):
        t = h * y
    c = np.fmin(np.fmax(t, F32(-127.0)), F32(127.0))       # fmaxf / fminf: NaN -> -127
    u = c + MAGIC
    d = np.abs(c - (u - MAGIC))
    return u.view(np.int32) - 0x4B400000, d < F32(0.5) - BAND


def twin_int(h, s):
    """The twin's integer: round(h / s) (half to even), clipped to +-127."""
    return np.clip(np.rint(h / s), -127, 127).astype(np.int32)


def row_scale(amax):
    """max(amax, 1e-8) / 127 in f32, as the twin and the kernel take it."""
    return np.maximum(amax, F32(1e-8)) / F32(127.0)


def _amax(family: str, rng) -> np.ndarray:
    if family == "gaussian":
        return np.abs(rng.standard_normal(400) * 3).astype(F32)
    if family == "powers of two":
        return (2.0 ** np.arange(-30, 30)).astype(F32) * F32(127.0) ** rng.integers(0, 2, 60)
    if family == "below the floor":
        return np.concatenate([[0.0], 10.0 ** -rng.uniform(8, 30, 40)]).astype(F32)
    return (10.0 ** rng.uniform(-6, 6, 400)).astype(F32)        # "wide range"


def _hs(s: np.ndarray, rng) -> np.ndarray:
    """(len(s), n) values h for each scale: every half-integer quotient n +
    0.5 (n -128..127) and its f32 neighbours up to 8 steps off, the quotients
    126.5, 127, 127.5, 128 and their neighbours, +-127 s, and uniform h."""
    q = np.concatenate([np.arange(-128, 128) + 0.5, [126.5, 127.0, 127.5, 128.0, -127.0]])
    base = (q[None, :] * s[:, None].astype(np.float64)).astype(F32)
    out, up, down = [base], base, base
    for _ in range(8):
        up, down = np.nextafter(up, F32(np.inf)), np.nextafter(down, F32(-np.inf))
        out += [up, down]
    out.append((rng.uniform(-130, 130, (len(s), 2000)) * s[:, None]).astype(F32))
    return np.concatenate(out, axis=1)


FAMILIES = ["gaussian", "powers of two", "below the floor", "wide range"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("step", [-1, 0, 1])
def test_quant_div_rule_gives_the_twins_integer(family, step):
    """Outside the band the rule's integer is the twin's, for y the f32
    nearest 1 / s or one step below or above it (within 1.5 ulps of 1 / s:
    more than rcp_refined's one ulp); the band holds every exact
    half-integer quotient and is narrow: under 1e-3 of uniform values."""
    rng = np.random.default_rng(10 * FAMILIES.index(family) + step + 1)
    s = row_scale(_amax(family, rng))
    y = (1.0 / s.astype(np.float64)).astype(F32)
    for _ in range(abs(step)):
        y = np.nextafter(y, F32(np.inf if step > 0 else -np.inf))
    h = _hs(s, rng)
    got, decided = rule(h, y[:, None])
    want = twin_int(h, s[:, None])
    assert np.array_equal(got[decided], want[decided]), int((got[decided] != want[decided]).sum())
    final = np.where(decided, got, want)             # inside the band, div_rn_by: the twin's h / s
    assert np.array_equal(final, want)
    exact_half = (h / s[:, None]) % 1 == 0.5
    assert not decided[exact_half & (np.abs(h / s[:, None]) < 127)].any()
    uniform = decided[:, -2000:]
    assert (~uniform).mean() < 1e-3


def test_quant_div_band_is_wider_than_the_error_it_covers():
    """The band against the worst |t - h / s| where |t| <= 128, y within 1.5
    ulps of 1 / s: (1.5 2^-23 + 2^-24 + 2^-24) 128 ~ 2^-14.7 < 2^-13; found
    over many s and h, the largest gap stays under the band."""
    rng = np.random.default_rng(7)
    s = row_scale(np.abs(rng.standard_normal(2000) * 5).astype(F32))
    worst = 0.0
    for step in (-1, 0, 1):
        y = (1.0 / s.astype(np.float64)).astype(F32)
        for _ in range(abs(step)):
            y = np.nextafter(y, F32(np.inf if step > 0 else -np.inf))
        h = (rng.uniform(-128, 128, (len(s), 500)) * s[:, None]).astype(F32)
        gap = np.abs((h * y[:, None]).astype(np.float64) - (h / s[:, None]).astype(np.float64))
        worst = max(worst, float(gap[np.abs(h * y[:, None]) <= 128].max()))
    assert worst < 2.0 ** -14.5 < BAND


def test_quant_div_rule_at_special_values():
    """NaN goes to -127 as round_clip_q takes it; +-inf and huge h clip to
    +-127; zeros and subnormal h give 0."""
    s = row_scale(np.array([1.0, 1e-9, 300.0], F32))
    y = (1.0 / s.astype(np.float64)).astype(F32)
    h = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38, 0.0, -0.0, 1e-45], F32)
    got, decided = rule(h[None, :], y[:, None])
    assert decided.all()
    assert (got[:, 0] == -127).all() and (got[:, 1] == 127).all() and (got[:, 2] == -127).all()
    assert (got[:, 3] == 127).all() and (got[:, 4] == -127).all() and (got[:, 5:] == 0).all()


# ---------------------------------------------------------------------------
# the row pass's statistics order
# ---------------------------------------------------------------------------

def _lane_sum(a):
    """(M, C, 32, 4) values x[128 c + 4 l + e] -> (M, 32): lane l's sum in
    order of c, then e, from 0."""
    s = torch.zeros(a.shape[0], 32)
    for c in range(a.shape[1]):
        for e in range(4):
            s = s + a[:, c, :, e]
    return s


def _butterfly(s):
    """(M, 32) -> (M, 1): the warp's xor butterfly (every lane ends equal)."""
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, torch.arange(32) ^ o]
    return s[:, :1]


def row_stats_model(xf):
    """The row pass's mean and 1 / std in the kernel's order (rstd as
    torch.rsqrt, the twin's; the kernel's rsqrtf may differ by an ulp)."""
    M, K = xf.shape
    lanes = xf.reshape(M, K // 128, 32, 4)
    kf = torch.tensor(float(K))
    mean = _butterfly(_lane_sum(lanes)) / kf
    d = lanes - mean[:, :, None, None]
    return mean, torch.rsqrt(_butterfly(_lane_sum(d * d)) / kf + TQ.LN_EPS)


def row_pass_model(x, mod, norm, static_s):
    """The row pass with the kernel's statistics order, else the twin's ops."""
    xf = x.float()
    mean, rstd = row_stats_model(xf)
    h = (xf - mean) * rstd
    m0, m1 = mod.float()[0:1], mod.float()[1:2]
    h = h * (1.0 + m0) + m1 if norm == "adaln" else h * m0 + m1
    q, _ = TQ._quant(h, static_s)
    return q, (h.abs().amax(dim=-1) if static_s is None else None)


def _pm_rows(rng, M, K):
    """Rows half +2^e, half -2^e (e 3..5 a row) in random order: their
    statistics are exact in f32 in any order, and 4^e + 1e-6 rounds to 4^e."""
    signs = np.where(np.arange(K) < K // 2, 1.0, -1.0)
    rows = np.stack([rng.permutation(signs) for _ in range(M)])
    return (rows * 2.0 ** rng.integers(3, 6, (M, 1))).astype(np.float32)


@pytest.mark.parametrize("K", [128, 640, 1024])
@pytest.mark.parametrize("norm", ["adaln", "ln"])
@pytest.mark.parametrize("static", [False, True])
def test_row_pass_order_is_exact_on_pm_rows(K, norm, static):
    """On +-2^e rows the model of the kernel's order equals the twin bit for
    bit, int8 rows and row maxima, and JAX's ``_prologue`` + ``_quant``."""
    rng = np.random.default_rng(K + 2 * static)
    x = _pm_rows(rng, 48, K)
    mod = (rng.standard_normal((2, K)) * 0.2).astype(np.float32)
    s = 0.035 if static else None
    tx, tmod = torch.from_numpy(x).bfloat16(), torch.from_numpy(mod)
    q, amax = row_pass_model(tx, tmod, norm, s)
    wq, wamax = TQ.quantize_rows_reference(tx, tmod, static_s=s, norm=norm)
    assert torch.equal(q, wq)
    assert static or torch.equal(amax, wamax)
    jh = JQ._prologue(jnp.asarray(tx.float().numpy()), jnp.asarray(mod[0:1]),
                      jnp.asarray(mod[1:2]), norm)
    jq, _ = JB._quant(jh, s)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


@pytest.mark.parametrize("K", [640, 1024])
@pytest.mark.parametrize("norm", ["adaln", "ln"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_pass_order_moves_gaussian_rows_by_an_ulp(K, norm, dtype):
    """On Gaussian rows the kernel's order gives a mean and 1 / std within
    rounding error of the twin's (2^-16 of the rows' mean |x|, 2^-17 of 1 /
    std), and moves at most 1e-4 of the int8 values, by one (static and
    dynamic scales): the difference is the statistics' last bits."""
    rng = np.random.default_rng(K + (dtype == torch.float32))
    x = torch.from_numpy((rng.standard_normal((256, K)) * 2).astype(np.float32)).to(dtype)
    mod = torch.from_numpy((rng.standard_normal((2, K)) * 0.2).astype(np.float32))
    xf = x.float()
    mean, rstd = row_stats_model(xf)
    wmean = xf.mean(dim=-1, keepdim=True)
    wrstd = torch.rsqrt((xf - wmean).square().mean(dim=-1, keepdim=True) + TQ.LN_EPS)
    assert ((mean - wmean).abs() <= 2.0 ** -16 * xf.abs().mean(dim=-1, keepdim=True)).all()
    assert ((rstd - wrstd).abs() <= 2.0 ** -17 * wrstd).all()
    for s in (None, 0.035):
        q, _ = row_pass_model(x, mod, norm, s)
        wq, _ = TQ.quantize_rows_reference(x, mod, static_s=s, norm=norm)
        d = (q.int() - wq.int()).abs()
        assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-4 * d.numel()


# ---------------------------------------------------------------------------
# the timing tool
# ---------------------------------------------------------------------------

def test_bench_quant_needs_a_card():
    """``tools.bench_quant``: unknown names exit 2; without a card, run as a
    module, it exits nonzero and prints nothing on stdout."""
    from text_to_sound_synthesis_torch.tools import bench_quant

    assert bench_quant.main(["nope"]) == 2
    proc = subprocess.run([sys.executable, "-m", "text_to_sound_synthesis_torch.tools.bench_quant"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr and proc.stdout == ""


def test_bench_quant_bounds():
    """The tool's bounds: bytes at 3.35 TB/s for every form (the row pass
    AdaLN static 2 M D + M D + 8 D bytes, as ``chip_smoke.kernel_bounds``
    counts it; the wide pass at 4 chunks 4 M Dh + M Dh + 16 M)."""
    from text_to_sound_synthesis_torch.tools import bench_quant as bq

    M, D, DH = bq.M, bq.D, bq.DH
    assert bq.work("rows_adaln_static")[0] == 3 * M * D + 8 * D
    assert bq.work("rows_none_dynamic")[0] == 3 * M * D + 4 * M
    assert bq.work("wide_f32_4chunks")[0] == 5 * M * DH + 16 * M
    assert bq.work("wide_bf16_own")[0] == 3 * M * DH + 4 * M
    for name in bq.NAMES:
        nbytes, ops = bq.work(name)
        assert bq.bound_us(name) == pytest.approx(1e6 * nbytes / 3.35e12)
        assert ops / 67e12 < nbytes / 3.35e12
    assert bq.bound_us("rows_adaln_static") == pytest.approx(1.95, abs=0.01)
    assert bq.bound_us("wide_f32_4chunks") == pytest.approx(12.97, abs=0.01)
