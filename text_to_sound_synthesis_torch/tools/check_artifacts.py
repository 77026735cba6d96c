"""Verify hand-supplied released artifacts against the manifest.

    python -m text_to_sound_synthesis_torch.tools.check_artifacts [ROOT]   # default ./artifacts
    python -m text_to_sound_synthesis_torch.tools.check_artifacts ROOT --need melception diffsound_ckpt

The port of ``tools/check_artifacts.py``, on the port's ``utils/artifacts.py``
(the replacement of the reference's downloader, ``Codebook/specvqgan/util.py:7-57``):
nothing is fetched; the manifest's filenames and pinned MD5s validate what
the user placed under an artifact root. Prints a row and a detail line per
artifact. Exit code 0 when every requested artifact is present (and
MD5-clean where a pin exists), 1 otherwise. Runs on the host alone.
"""

from __future__ import annotations

import argparse
import sys

from ..utils.artifacts import ARTIFACTS, verify


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("root", nargs="?", default="artifacts")
    p.add_argument("--need", nargs="*", default=None,
                   help=f"subset to require (default: all). Known: {sorted(ARTIFACTS)}")
    args = p.parse_args(argv)

    if args.need:
        unknown = [n for n in args.need if n not in ARTIFACTS]
        if unknown:
            p.error(f"unknown artifact names {unknown}; known: {sorted(ARTIFACTS)}")

    rows = verify(args.root, args.need)
    width = max(len(r.name) for r in rows)
    ok = True
    for r in rows:
        mark = {"ok": "OK      ", "unpinned": "UNPINNED",
                "bad_md5": "BAD MD5 ", "missing": "MISSING "}[r.status]
        print(f"{r.name:<{width}}  {mark}  {r.path or '-'}")
        print(f"{'':<{width}}            {r.detail}")
        if r.status in ("missing", "bad_md5"):
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
