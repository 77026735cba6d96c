"""Released-artifact manifest: expected filenames + MD5s.

A copy of the JAX package's ``utils/artifacts.py`` (standard library only):
the counterpart of the reference's download registry
(``Codebook/specvqgan/util.py:7-57``). Nothing is downloaded; the manifest
lets users VERIFY hand-supplied copies (filename conventions, pinned MD5s
where the reference publishes them) and lets tools find a local artifact
root.

Entries with ``md5=None`` have no published checksum (the HF/GDrive Diffsound
releases publish none); they are matched by filename pattern and verified by
presence only, and their observed MD5 is reported so users can pin it in an
``ARTIFACTS.lock`` of their own.
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
from typing import Dict, List, NamedTuple, Optional

__all__ = ["ARTIFACTS", "ArtifactSpec", "md5sum", "locate", "verify"]


class ArtifactSpec(NamedTuple):
    filename: str                 # canonical filename (fnmatch pattern allowed)
    md5: Optional[str]            # pinned checksum, or None if unpublished
    url: str                      # where the reference fetches/publishes it
    role: str                     # what it is for
    kind: str = "file"            # "file" | "dir"


# Pinned names/MD5s below mirror specvqgan/util.py:7-27 verbatim (they are the
# public release's identity, not code); the Diffsound/vocoder rows follow the
# filenames used by generate_samples_batch.py:29-40 and readme.md:3-11.
ARTIFACTS: Dict[str, ArtifactSpec] = {
    "lpaps": ArtifactSpec(
        "lpaps.pt", "f8d4e7dba2b870222fe2bee26f85e7c9",
        "https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a/specvqgan_public/lpaps.pt",
        "LPAPS perceptual-loss lin heads (stage-1 training)"),
    "vggishish": ArtifactSpec(
        "vggishish16.pt", "197040c524a07ccacf7715d7080a80bd",
        "https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a/specvqgan_public/vggishish16.pt",
        "VGGish-ish VGG16 perceptual backbone"),
    "vggishish_mean_std": ArtifactSpec(
        "train_means_stds_melspec_10s_22050hz.txt", "f449c6fd0e248936c16f6d22492bb625",
        "https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a/specvqgan_public/train_means_stds_melspec_10s_22050hz.txt",
        "per-mel-bin train mean/std (StandardNormalizeAudio)"),
    "melception": ArtifactSpec(
        "melception-21-05-10T09-28-40.pt", "a71a41041e945b457c7d3d814bbcf72d",
        "https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a/specvqgan_public/melception-21-05-10T09-28-40.pt",
        "Melception (Inception3, 309 VGGSound classes) eval extractor"),
    # --- Diffsound releases (HF Dongchao/Diffsound; no published MD5s) ------
    "diffsound_ckpt": ArtifactSpec(
        "diffsound*.pth", None,
        "https://huggingface.co/Dongchao/Diffsound",
        "stage-2 diffusion checkpoint ({'model','ema',...} dict)"),
    "codebook_ckpt": ArtifactSpec(
        "*codebook*.ckpt", None,
        "https://huggingface.co/Dongchao/Diffsound",
        "stage-1 SpecVQGAN codebook (Lightning .ckpt; only needed to "
        "initialise training — the .pth embeds the codec)"),
    "vocoder": ArtifactSpec(
        "vocoder", None,
        "https://huggingface.co/Dongchao/Diffsound",
        "MelGAN logdir containing best_netG.pt + args.yml", kind="dir"),
    "gt_mels": ArtifactSpec(
        "gt_mels", None, "(user-extracted, feature_extraction recipe)",
        "AudioCaps val ground-truth mel .npy dir (eval input2)", kind="dir"),
    "val_csv": ArtifactSpec(
        "*val*.csv", None, "(AudioCaps metadata)",
        "val csv rows `name,caption` for generation"),
}


def md5sum(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def locate(root: str, name: str) -> Optional[str]:
    """Find the artifact ``name`` under ``root`` (top level, then one level
    deep — release bundles often keep a flat or one-dir layout)."""
    spec = ARTIFACTS[name]
    if not os.path.isdir(root):
        return None
    candidates: List[str] = []
    for base, dirs, files in os.walk(root):
        depth = os.path.relpath(base, root).count(os.sep)
        if depth > 1:
            dirs[:] = []
            continue
        pool = dirs if spec.kind == "dir" else files
        for entry in pool:
            if fnmatch.fnmatch(entry, spec.filename):
                candidates.append(os.path.join(base, entry))
        if spec.kind == "dir":
            # a vocoder dir may be named anything — accept any dir holding
            # best_netG.pt + args.yml (mel2wav/interface.py:21-34)
            if name == "vocoder":
                for entry in dirs:
                    p = os.path.join(base, entry)
                    if (os.path.isfile(os.path.join(p, "best_netG.pt"))
                            and os.path.isfile(os.path.join(p, "args.yml"))):
                        candidates.append(p)
    return sorted(candidates)[0] if candidates else None


class ArtifactStatus(NamedTuple):
    name: str
    status: str        # "ok" | "unpinned" | "bad_md5" | "missing"
    path: Optional[str]
    detail: str


def verify(root: str, names: Optional[List[str]] = None) -> List[ArtifactStatus]:
    """Scan ``root`` for every (requested) artifact and check pinned MD5s."""
    out = []
    for name in names or list(ARTIFACTS):
        spec = ARTIFACTS[name]
        path = locate(root, name)
        if path is None:
            out.append(ArtifactStatus(
                name, "missing", None,
                f"expected {spec.filename!r} ({spec.role}); source: {spec.url}"))
        elif spec.kind == "dir" or spec.md5 is None:
            detail = spec.role
            if spec.kind == "file":
                detail += f"; md5 {md5sum(path)} (no published pin)"
            out.append(ArtifactStatus(name, "unpinned", path, detail))
        else:
            got = md5sum(path)
            if got == spec.md5:
                out.append(ArtifactStatus(name, "ok", path, f"md5 {got}"))
            else:
                out.append(ArtifactStatus(
                    name, "bad_md5", path,
                    f"md5 {got} != pinned {spec.md5} — corrupt or wrong file"))
    return out
