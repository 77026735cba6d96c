"""Compare the machine code (SASS) of two versions of a CUDA source, function
by function, on a machine with the CUDA toolkit.

    python -m text_to_sound_synthesis_torch.tools.sass_diff OLD.cu NEW.cu \
        [--rename PATTERN REPLACEMENT ...]

Both are compiled to sm_90a cubins with the package's device flags (each with
its own directory on the include path), disassembled with ``cuobjdump
-sass``, and each kernel's instructions compared (addresses
and the anonymous namespace's per-file tag left out). It prints how many of
OLD's functions are identical in NEW, which differ and which are new: the
check that a template flag added to a kernel left its other instantiations'
code as it was. ``--rename`` maps OLD's (mangled) function names through a
regular expression first, for a template parameter that changed type (a
bool flag become an int mode) but not the code of its old values. Exits
nonzero if any function of OLD differs or is missing.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

from ..utils.cuda_build import find_nvcc

_DEVICE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-cubin")


def sass(source: str, out_dir: str) -> Dict[str, List[str]]:
    """{kernel name: its SASS lines} of ``source`` built for sm_90a."""
    nvcc = find_nvcc()
    cubin = os.path.join(out_dir, f"{len(os.listdir(out_dir))}.cubin")
    subprocess.run([nvcc, *_DEVICE_FLAGS, "-I", os.path.dirname(os.path.abspath(source)), "-o",
                    cubin, source], check=True)
    objdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([objdump, "-sass", cubin], check=True, capture_output=True,
                          text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "ANON", m.group(1))
            funcs[name] = []
        elif name and line.strip():
            funcs[name].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    return funcs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rename", nargs=2, action="append", default=[],
                    metavar=("PATTERN", "REPLACEMENT"),
                    help="re.sub applied to OLD's function names before matching")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        old, new = sass(args.old, tmp), sass(args.new, tmp)
    for pattern, repl in args.rename:
        old = {re.sub(pattern, repl, k): v for k, v in old.items()}
    same = [k for k in old if new.get(k) == old[k]]
    print(f"{args.old}: {len(old)} functions; {args.new}: {len(new)}; identical SASS {len(same)}")
    print("differ or missing:", [k for k in old if k not in same])
    print("new:", [k for k in new if k not in old])
    return 0 if len(same) == len(old) else 1


if __name__ == "__main__":
    sys.exit(main())
