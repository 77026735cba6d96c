#!/bin/bash
# A/B of the int8 kernels against the parent commit, in one call on a card:
# for a change that replaces the parent's code, so that the two cannot sit
# side by side in one tree.
#
#   mkdir -p _scratch/parent && git archive HEAD | tar -x -C _scratch/parent   # where git is
#   [AB_OUT=dir] bash text_to_sound_synthesis_torch/tools/ab_parent.sh [SASS_DIFF_ARGS...]   # on the card
#
# Builds both trees' kernels (each tree has its own build/), runs the A/B tools
# parent / change / change / parent ($AB_TOOLS, by default bench_attn_ablate
# full pair_both: K4 with the bf16 and with the pair MHA; e.g. AB_TOOLS="-m
# text_to_sound_synthesis_torch.tools.bench_kernel_dot 200" for the GEMMs'
# tools; AB_COPY="text_to_sound_synthesis_torch/tools/bench_schedules.py" to run a
# tool the parent lacks), then the change's chip_profile.py (copied over the
# parent's, so that both profile the same requests) in the parent and in the change, on the
# paths $AB_PROFILE names (all by default; the full tables go to
# $AB_OUT/profile_{parent,change}.txt, build/ab by default, and each path's
# summary line is printed), and, given arguments, tools.sass_diff with the parent's
# int8_block.cu as OLD and those arguments after it (e.g. --new
# ...int8_block.cu ...int8_probe.cu --moved REGEX ...). Prints the card's name
# and power limit first.
cd "$(dirname "$0")/../.." || exit 1
PARENT=_scratch/parent
[ -f "$PARENT/chip_smoke.py" ] || { echo "unpack the parent into $PARENT first" >&2; exit 1; }
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
OUT=${AB_OUT:-build/ab}
mkdir -p "$OUT"

build() {   # every library the tools and chip_profile.py load, in parallel, with their seconds
  (cd "$1" && timeout 900 python - <<'PY'
import concurrent.futures as cf
import time

from text_to_sound_synthesis_torch.ops import fused_gn_conv as gn
from text_to_sound_synthesis_torch.ops import fused_sampler as fs
from text_to_sound_synthesis_torch.ops import int8_kernels as ik

loads = [ik.load_kernel, fs.load_kernel, fs.load_head_kernel, ik.load_mha_int8, gn.load_kernel]
loads += [ik.load_probe_kernel] if hasattr(ik, "load_probe_kernel") else []


def timed(f):
    t = time.perf_counter()
    f()
    return f"{f.__module__.rsplit('.', 1)[1]}.{f.__name__} {time.perf_counter() - t:.1f} s"


t0 = time.perf_counter()
with cf.ThreadPoolExecutor(len(loads)) as pool:
    print("build:", "; ".join(pool.map(timed, loads)), f"(all {time.perf_counter() - t0:.1f} s)")
PY
  )
}

AB_TOOLS=${AB_TOOLS:--m text_to_sound_synthesis_torch.tools.bench_attn_ablate full pair_both}

tools() {
  echo "=== A/B tools in ${1}"
  # shellcheck disable=SC2086   # AB_TOOLS is the tool's command line, split on purpose
  (cd "$1" && timeout 600 python $AB_TOOLS)
}

# the change's profile script and the files named in $AB_COPY (tools the
# parent lacks) over the parent's, so that both trees run the same measurements
for f in chip_profile.py ${AB_COPY}; do cp "$f" "$PARENT/$f"; done
echo "=== build: parent"; build "$PARENT"
echo "=== build: change"; build .
tools "$PARENT"; tools .; tools .; tools "$PARENT"
for side in parent change; do
  dir=$([ "$side" = parent ] && echo "$PARENT" || echo .)
  echo "=== chip_profile.py: ${side}"
  # shellcheck disable=SC2086   # AB_PROFILE is a list of path names
  (cd "$dir" && timeout 900 python3 chip_profile.py $AB_PROFILE) > "$OUT/profile_${side}.txt" 2>&1
  grep "^\[" "$OUT/profile_${side}.txt"
done
if [ $# -gt 0 ]; then
  echo "=== sass_diff"
  timeout 900 python -m text_to_sound_synthesis_torch.tools.sass_diff \
    "$PARENT/text_to_sound_synthesis_torch/csrc/int8_block.cu" "$@"
fi
