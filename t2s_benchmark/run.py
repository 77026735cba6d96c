"""Run one cell of the benchmark once.

    python -m t2s_benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration file (``configs/``) and traffic mix (``traffic/<mix>.json``);
the mix names its driver (``drivers/<driver>.py``); each per-layer metric is
read by ``metrics/<metric>.py``. Set-up (imports, weights, engine builds,
calibration, warm-up) is timed from the start of the process; then the
window runs for ``--seconds``; then, with the program's state freed, the
check holds what the timed path produced to the plain reference.

Without ``--trace`` the result line carries the cell's end-to-end metrics;
with ``--trace 1`` the window runs under the profiler and the line carries
the per-layer metrics, ``busy_s`` / ``window_s`` and a breakdown. The last
line of standard output is the result; the numbers the check compared,
each beside its limit, are the last lines of standard error and the last
key of the result. Exit codes: 0 done, 2 no suitable card, 3 a JAX module
was loaded, 1 anything else.
"""

import time

PROCESS_START = time.perf_counter()

import argparse   # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "text_to_sound_synthesis_tpu")


def load_cell(name: str):
    """(benchmark, workload entry, configuration entry, configuration dict, mix dict)."""
    import yaml

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = yaml.safe_load((ROOT / conf["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, conf, config, mix


def metrics_of(bench: dict, cell: str, kind: str):
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, run: dict):
    """The value ``metrics/<name>.py`` reads from the traced run, or None."""
    spec = importlib.util.spec_from_file_location(f"t2s_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def set_cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def stray_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def make_driver(cell, config, mix, seed, device, tracer):
    mod = importlib.import_module(f"t2s_benchmark.drivers.{mix['driver']}")
    return getattr(mod, mod.DRIVER)(config, mix, seed, device, tracer), mod.LIMITS


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench, cell, conf, config, mix = load_cell(args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return run(args, bench, cell, config, mix, device)


def run(args, bench, cell, config, mix, device) -> int:
    """A run on ``device`` (the card; the CPU in the benchmark's own tests)."""
    import torch

    from .trace import Tracer

    cuda = device.type == "cuda"
    tracer = Tracer(bool(args.trace), device)
    driver, limits = make_driver(cell, config, mix, args.seed, device, tracer)
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - PROCESS_START
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with tracer.window():
        e2e = driver.run_window(args.seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e["peak_mem_gib"] = peak / 2**30
    e2e["setup_s"] = setup_s
    attempted, failed = driver.attempted()
    work = driver.work()
    driver.release()
    readings = driver.check()
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if args.trace:
        tl = tracer.timeline
        run_info = dict(work, timeline=tl)
        metrics = {}
        for m in metrics_of(bench, cell["name"], "per_layer"):
            v = read_metric(m["name"], run_info)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": tl.top_ops(), "idle_gaps": tl.idle_gaps()}
    else:
        units = {m["name"]: m["unit"] for m in metrics_of(bench, cell["name"], "end_to_end")}
        result["metrics"] = {k: {"value": e2e[k], "unit": u} for k, u in units.items()}
    result["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if args.trace:
        result["device"].update(busy_s=tl.busy_s(), window_s=tl.window_s)
    result["checks"] = checks

    stray = stray_modules()
    if stray:
        print(f"refusing to report: JAX modules loaded in this process: {stray}",
              file=sys.stderr)
        return 3
    for name, seconds in getattr(driver, "phases", ()):
        print(f"set-up {name}: {seconds:.3f} s", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']:.6g} limit {c['limit']:.6g}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
