"""Read the check's numbers for the program and for the control, seed by seed.

    python -m t2s_benchmark.control --workload NAME --seconds S --seeds N [N ...]

For each seed: set-up, a short window at the cell's own load, then the
check's numbers twice: once of what the program produced, once with the
control in the program's place (the reference computed in the next lower
precision than the configuration states, or, for a training cell, each
planted fault). One JSON line per seed. The benchmark's runs never run
this; its readings set the limits (PERF.md gives them).
"""

import argparse
import json
import sys

from . import run as bench_run
from .trace import Tracer


def readings(cell, config, mix, seed: int, seconds: float, device, controls=None) -> dict:
    tracer = Tracer(False, device)
    driver, limits = bench_run.make_driver(cell, config, mix, seed, device, tracer)
    driver.setup()
    driver.run_window(seconds)
    driver.release()
    out = {"seed": seed, "program": driver.check()}
    out["worst_leaves"] = getattr(driver, "worst", None)
    out["detail"] = getattr(driver, "detail", None)
    for control in controls or sys.modules[type(driver).__module__].CONTROLS:
        out[control] = driver.check(control=control)
        out[control + "_worst_leaves"] = getattr(driver, "worst", None)
        out[control + "_detail"] = getattr(driver, "detail", None)
    out["limits"] = limits
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=None,
                   help="the controls to read (default: all the driver names)")
    args = p.parse_args(argv)
    _, cell, _, config, mix = bench_run.load_cell(args.workload)
    bench_run.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps(readings(cell, config, mix, seed, args.seconds, device, args.controls)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
