"""The benchmark's own arithmetic and wiring, on the CPU.

    python -m pytest t2s_benchmark -q
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from t2s_benchmark import rates, roofline
from t2s_benchmark.reference import denoiser as rden
from t2s_benchmark.trace import Timeline

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_rate_counts_whole_requests_only():
    recs = [{"end": 10.0 + 3 * i, "clips": 64} for i in range(1, 5)]   # ends 13, 16, 19, 22
    rate, done = rates.completed_rate(recs, start=10.0, seconds=10.0, unit="clips")
    assert [r["end"] for r in done] == [13.0, 16.0, 19.0]
    assert rate == pytest.approx(3 * 64 / 9.0)
    # a request cut off by the window's end moves nothing, however long it runs
    recs[-1]["end"] = 95.0
    assert rates.completed_rate(recs, 10.0, 10.0, "clips")[0] == rate
    assert rates.completed_rate(recs[-1:], 10.0, 10.0, "clips") == (None, [])


def test_rate_over_whole_steps():
    assert rates.steps_rate(25, 20, start=3.0, end=13.0) == pytest.approx(50.0)


def test_idle_from_an_overlapping_timeline():
    ns = 1_000_000_000
    tl = Timeline((0, 10 * ns), spans=[("request", 0, 10 * ns), ("sampler", 1 * ns, 6 * ns)],
                  device=[("a", 1 * ns, 3 * ns), ("b", 2 * ns, 4 * ns),   # overlap: busy 1..4
                          ("c", 5 * ns, 6 * ns), ("d", 9 * ns, 12 * ns),  # cut at the window
                          ("e", 11 * ns, 13 * ns)])                        # outside it
    assert tl.busy_s() == pytest.approx(3 + 1 + 1)
    assert tl.idle_pct() == pytest.approx(50.0)
    assert Timeline((0, ns)).idle_pct() is None
    assert tl.idle_gaps() == [["request", pytest.approx(3.0)], ["request", pytest.approx(1.0)],
                              ["sampler", pytest.approx(1.0)]]
    assert tl.top_ops(2) == [["a", pytest.approx(2.0)], ["b", pytest.approx(2.0)]]


def test_sampler_step_ops_by_hand():
    B, L, S, D, H, n_layer, K = 2, 5, 3, 8, 2, 3, 17
    ops = roofline.sampler_step_ops(B, L, S, D, H, n_layer, K)
    M = B * L
    dots = 2 * M * (3 * D * D + D * D + D * D + D * D + D * 4 * D + 4 * D * D)
    attn = 2 * 2 * B * H * L * (L + S) * (D // H)
    assert ops["dense"] == n_layer * dots
    assert ops["attn_head"] == n_layer * attn + 2 * M * D * (K - 1)


def test_int8_step_bound_is_the_larger_of_bytes_and_products():
    t_small = roofline.int8_step_bound(1, 265, 77, 1024, 16, 19, 257)
    t_big = roofline.int8_step_bound(64, 265, 77, 1024, 16, 19, 257)
    ops = roofline.sampler_step_ops(64, 265, 77, 1024, 16, 19, 257)
    assert t_big >= ops["dense"] / roofline.PEAK["int8"]        # never under the products alone
    assert t_small < t_big < 64 * t_small


def test_counted_flops_of_a_tiny_denoiser_by_hand():
    n_layer, D, H, L, S, Dc, K, B = 1, 8, 2, 6, 4, 4, 5, 2
    shapes = {"content_emb.emb.weight": (K, D), "content_emb.height_emb.weight": (2, D),
              "content_emb.width_emb.weight": (3, D), "to_logits.0.weight": (D,),
              "to_logits.0.bias": (D,), "to_logits.1.weight": (K - 1, D),
              "to_logits.1.bias": (K - 1,)}
    p = "blocks.0."
    for ln in ("ln1.", "ln1_1."):
        shapes.update({p + ln + "emb.weight": (10, D), p + ln + "linear.weight": (2 * D, D),
                       p + ln + "linear.bias": (2 * D,)})
    for a, kv in (("attn1.", D), ("attn2.", Dc)):
        for n in ("query", "key", "value", "proj"):
            shapes[p + a + n + ".weight"] = (D, kv if n in ("key", "value") else D)
            shapes[p + a + n + ".bias"] = (D,)
    shapes.update({p + "ln2.weight": (D,), p + "ln2.bias": (D,), p + "mlp.0.weight": (4 * D, D),
                   p + "mlp.0.bias": (4 * D,), p + "mlp.2.weight": (D, 4 * D),
                   p + "mlp.2.bias": (D,)})
    w = {rden.DEN + k: torch.empty(v, device="meta") for k, v in shapes.items()}
    toks = torch.zeros((B, L), dtype=torch.long, device="meta")
    t = torch.zeros((B,), dtype=torch.long, device="meta")
    cond = torch.zeros((B, S, Dc), device="meta")
    got = roofline.counted_flops(lambda: rden.head_logits(
        w, rden.denoiser(w, toks, t, cond, n_layer=1, n_head=H, H=2, W=3)))
    M = B * L
    ada = 2 * (2 * B * D * 2 * D)
    dense = 2 * M * D * D * 4 + 2 * M * D * D * 2 + 2 * B * S * Dc * D * 2 + 2 * M * D * 4 * D * 2
    attn = 2 * 2 * B * L * (L + S) * D
    head = 2 * M * D * (K - 1)
    assert got == ada + dense + attn + head


def test_every_entry_resolves_to_its_files():
    import importlib

    assert BENCH["paths"] == ["t2s_benchmark"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("t2s_benchmark/")
    for cell in BENCH["workloads"]:
        mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
        mod = importlib.import_module(f"t2s_benchmark.drivers.{mix['driver']}")
        assert hasattr(mod, mod.DRIVER) and mod.LIMITS
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def _imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_nothing_imports_jax_and_the_reference_nothing_of_the_program():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "text_to_sound_synthesis_tpu"}, path
    for path in (HERE / "reference").rglob("*.py"):
        assert "text_to_sound_synthesis_torch" not in _imports(path), path


def test_a_run_without_a_card_exits_nonzero_and_prints_no_metric():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "-m", "t2s_benchmark.run", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert "needs" in proc.stderr
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
