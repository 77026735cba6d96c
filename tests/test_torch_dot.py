"""T1, the bare tiled dot of the dot probe, against the JAX package; and the
port's two A/B tools.

The port's twin (``ops/dot.py::tiled_dot_reference``) and its wrapper on a
CPU tensor are held against JAX ``tools/bench_kernel_dot.py::make_pallas_dot``
run in TPU interpret mode on the CPU, in the probe's three cases, with the
tool's module-level M, K, N cut to 256 x 128 x 512. The integer cases are
exact on both sides (int32 sums; |sum| <= 128 * 127^2 < 2^24, so the f32
conversion is exact too). bf16 -> f32: the products are exact in f32, the
sums run in another order, so each output may differ by the standard bound
of an f32 sum in any order, 2 * K * 2^-24 * sum_k |x_k w_k| (both sides
within half of it of the exact sum).

The tools' shape tables are the JAX tools', and without a card both exit
nonzero. The CUDA kernel is checked against the same twin on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from text_to_sound_synthesis_torch.ops import dot as D

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(M=256, K=128, N=512)


def _load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_dot():
    return _load_jax_tool("bench_kernel_dot")


def _operands(seed=0):
    """The JAX tool's inputs: int8 in [-127, 127], bf16 = int8 / 127."""
    rng = np.random.default_rng(seed)
    x8 = rng.integers(-127, 128, (SMALL["M"], SMALL["K"])).astype(np.int8)
    w8 = rng.integers(-127, 128, (SMALL["K"], SMALL["N"])).astype(np.int8)
    return x8, w8


def _bf16_bound(xb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    return 2 * xb.shape[1] * 2.0 ** -24 * (xb.float().abs() @ wb.float().abs())


@pytest.mark.parametrize("case", list(D.CASES))
def test_twin_and_wrapper_match_pallas_dot(jax_dot, monkeypatch, case):
    for k, v in SMALL.items():
        monkeypatch.setattr(jax_dot, k, v)
    x8, w8 = _operands()
    dt, out_dt = D.CASES[case]
    if dt == torch.int8:
        xj, wj = jnp.asarray(x8), jnp.asarray(w8)
        xt, wt = torch.from_numpy(x8), torch.from_numpy(w8)
        acc = jnp.int32 if out_dt == torch.int32 else jnp.float32
        fn = jax_dot.make_pallas_dot(128, acc=acc)
    else:
        xj = (jnp.asarray(x8, jnp.float32) / 127.0).astype(jnp.bfloat16)
        wj = (jnp.asarray(w8, jnp.float32) / 127.0).astype(jnp.bfloat16)
        xt = (torch.from_numpy(x8).float() / 127.0).bfloat16()
        wt = (torch.from_numpy(w8).float() / 127.0).bfloat16()
        fn = jax_dot.make_pallas_dot(128, acc=jnp.float32, out_dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.array(fn(xj, wj))
    launches = D.tiled_dot.launches
    for got in (D.tiled_dot_reference(xt, wt, out_dt), D.tiled_dot(xt, D.k_contiguous(wt), out_dt)):
        assert got.dtype == out_dt and tuple(got.shape) == (SMALL["M"], SMALL["N"])
        if dt == torch.int8:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            assert bool(((got - torch.from_numpy(want)).abs() <= _bf16_bound(xt, wt)).all())
    assert D.tiled_dot.launches == launches         # a CPU tensor runs the twin
    if dt == torch.int8:     # and both equal the exact integer product
        exact = x8.astype(np.int64) @ w8.astype(np.int64)
        np.testing.assert_array_equal(want.astype(np.int64), exact)


def test_k_contiguous_layout():
    w = torch.arange(12, dtype=torch.int8).reshape(3, 4)
    v = D.k_contiguous(w)
    assert torch.equal(v, w) and v.t().is_contiguous() and tuple(v.t().shape) == (4, 3)


def test_tiled_dot_refuses():
    x, w = torch.zeros((8, 64), dtype=torch.int8), torch.zeros((64, 128), dtype=torch.int8)
    with pytest.raises(TypeError):
        D.tiled_dot(x, w, torch.bfloat16)                 # not one of the probe's cases
    with pytest.raises(TypeError):
        D.tiled_dot(x, w.bfloat16(), torch.float32)       # mixed operands
    with pytest.raises(ValueError):
        D.tiled_dot(x, w[:32], torch.int32)               # K mismatch
    with pytest.raises(ValueError):
        D.tiled_dot(x.to("meta"), w.to("meta"), torch.int32)   # neither cpu nor cuda


def test_tool_tables_match_jax_tools(jax_dot):
    from text_to_sound_synthesis_torch.tools import bench_kernel_dot as port

    assert (port.M, port.K, port.N, port.ITERS) == (jax_dot.M, jax_dot.K, jax_dot.N,
                                                     jax_dot.ITERS)
    assert set(D.CASES) == {"int8->int32", "int8->f32", "bf16->f32"}
    assert port.K % 64 == 0 and port.N % D.TILE[1] == 0      # inside the kernel's limits


@pytest.mark.parametrize("tool", ["bench_gn_conv", "bench_kernel_dot"])
def test_tools_exit_nonzero_without_a_card(tool):
    proc = subprocess.run([sys.executable, "-m", f"text_to_sound_synthesis_torch.tools.{tool}", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr and proc.stdout == ""
