"""Compare the machine code (SASS) of two versions of CUDA sources, function
by function, on a machine with the CUDA toolkit.

    python -m text_to_sound_synthesis_torch.tools.sass_diff OLD.cu --new NEW.cu [NEW2.cu ...] \
        [--moved PATTERN ...] [--rename PATTERN REPLACEMENT ...] [--count REGEX ...]

Each source is compiled to an sm_90a cubin with the package's device flags
(with its own directory on the include path), disassembled with ``cuobjdump
-sass``, and each kernel's instructions compared (addresses, the anonymous
namespace's per-file tag, the file's ELF header flags and the padding left
out). NEW may
be several sources, the translation units that OLD's functions were split
into: their functions are pooled. It prints how many of OLD's functions are identical in NEW, which
differ, which are gone and which are new: the check that a template flag
added to a kernel, or code moved between files, left the other
instantiations' code as it was (for the first three that differ, it prints
where they part). ``--moved`` names OLD's functions (regular
expressions, matched in full) that are expected to be gone, moved onto
another kernel. ``--rename`` maps OLD's (mangled) function names through a
regular expression first, for a template parameter that changed type (a bool
flag become an int mode) but not the code of its old values. ``--count``
prints, for each NEW function, how many of its instructions match each
expression (``CALL``: a call makes ptxas serialize the kernel's wgmma;
``HGMMA``: the wgmma themselves). Exits nonzero if any function of OLD
differs, or is gone without matching ``--moved``.
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
    return parse(subprocess.run([objdump, "-sass", cubin], check=True, capture_output=True,
                                text=True).stdout)


def parse(text: str) -> Dict[str, List[str]]:
    """{kernel name: its SASS lines} of ``cuobjdump -sass`` output."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "ANON", m.group(1))
            funcs[name] = []
        elif name and line.strip() and not line.strip().startswith(".headerflags"):
            # (.headerflags, repeated under each function, are the file's ELF flags)
            # (the padding before the encoding comment follows the file's longest line)
            funcs[name].append(" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).split()))
    return funcs


def compare(old: Dict[str, List[str]], new: Dict[str, List[str]], moved: Sequence[str] = ()):
    """(identical, differ, gone as expected, gone unexpectedly, new) names."""
    same = [k for k in old if new.get(k) == old[k]]
    differ = [k for k in old if k in new and new[k] != old[k]]
    gone = [k for k in old if k not in new]
    expected = [k for k in gone if any(re.fullmatch(p, k) for p in moved)]
    return same, differ, expected, [k for k in gone if k not in expected], \
        [k for k in new if k not in old]


def counts(funcs: Dict[str, List[str]], patterns: Sequence[str]) -> Dict[str, List[int]]:
    """{function: [instructions matching each pattern]} (re.search on each line)."""
    return {k: [sum(1 for line in v if re.search(p, line)) for p in patterns]
            for k, v in funcs.items()}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("--new", nargs="+", required=True, metavar="NEW")
    ap.add_argument("--moved", action="append", default=[], metavar="PATTERN",
                    help="an OLD function expected to be gone (re.fullmatch on its name)")
    ap.add_argument("--rename", nargs=2, action="append", default=[],
                    metavar=("PATTERN", "REPLACEMENT"),
                    help="re.sub applied to OLD's function names before matching")
    ap.add_argument("--count", action="append", default=[], metavar="REGEX",
                    help="print each NEW function's instructions matching REGEX (e.g. CALL)")
    args = ap.parse_args(argv)
    sources = args.new
    new: Dict[str, List[str]] = {}
    clash = []
    with tempfile.TemporaryDirectory() as tmp:
        old = sass(args.old, tmp)
        for source in sources:
            for k, v in sass(source, tmp).items():
                if k in new and new[k] != v:
                    clash.append(k)
                new[k] = v
    for pattern, repl in args.rename:
        old = {re.sub(pattern, repl, k): v for k, v in old.items()}
    same, differ, expected, lost, added = compare(old, new, args.moved)
    differ += [k for k in clash if k in old and k not in differ]
    same = [k for k in same if k not in clash]
    print(f"{args.old}: {len(old)} functions; {' + '.join(sources)}: {len(new)}; "
          f"identical SASS {len(same)}")
    print("differ:", differ)
    print(f"gone, moved as expected ({len(expected)}):", expected)
    print("gone, not expected:", lost)
    print(f"new ({len(added)}):", added)
    for k in differ[:3]:   # where the first few part
        first = next((i for i, (a, b) in enumerate(zip(old[k], new[k])) if a != b),
                     min(len(old[k]), len(new[k])))
        print(f"{k}: {len(old[k])} lines in OLD, {len(new[k])} in NEW; first difference at line "
              f"{first}:\n  OLD {old[k][first:first + 3]}\n  NEW {new[k][first:first + 3]}")
    for k, n in counts(new, args.count).items() if args.count else ():
        print(f"{k}: " + ", ".join(f"{p} {c}" for p, c in zip(args.count, n)))
    return 0 if not differ and not lost else 1


if __name__ == "__main__":
    sys.exit(main())
