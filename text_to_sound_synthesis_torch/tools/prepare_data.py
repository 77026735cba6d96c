"""Offline feature extraction: wav -> canonical mel ``.npy`` files.

    python -m text_to_sound_synthesis_torch.tools.prepare_data -i wavs/ \\
        -o features/train/melspec_10s_22050hz [-l 220500] [-n 8]

The port of ``tools/prepare_data.py`` (reference
``Codebook/feature_extraction/extract_mel_spectrogram.py``, the 2022-12-06
recipe): each wav under the input directory is read at 22 050 Hz
(``utils/io.py::read_wav``), padded or cut to ``--length`` samples, taken
through the canonical ``TRANSFORMS`` chain (``ops/signal.py::wav_to_mel_np``,
numpy on the host) and saved as ``<name>_mel.npy`` (80 x frames, [0, 1]).
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob

import numpy as np


def process_one(audio_path: str, save_dir: str, length: int) -> str:
    from ..ops.signal import wav_to_mel_np
    from ..utils.io import read_wav

    wav, _ = read_wav(audio_path, target_sr=22050)
    y = np.zeros(length, np.float32)
    y[: min(len(wav), length)] = wav[:length]
    mel = wav_to_mel_np(y)
    name = os.path.splitext(os.path.basename(audio_path))[0]
    out = os.path.join(save_dir, name + "_mel.npy")
    np.save(out, mel)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="wav -> canonical mel .npy (PyTorch port)")
    p.add_argument("-i", "--input_dir", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("-l", "--length", type=int, default=220500)
    p.add_argument("-n", "--num_worker", type=int, default=os.cpu_count())
    args = p.parse_args(argv)

    paths = sorted(glob(os.path.join(args.input_dir, "**", "*.wav"), recursive=True))
    os.makedirs(args.output_dir, exist_ok=True)
    print(f"{len(paths)} wavs -> {args.output_dir}")
    if args.num_worker and args.num_worker > 1 and len(paths) > 1:
        from functools import partial
        from multiprocessing import get_context

        with get_context("spawn").Pool(args.num_worker) as pool:
            for i, _ in enumerate(pool.imap_unordered(
                    partial(process_one, save_dir=args.output_dir, length=args.length), paths)):
                if (i + 1) % 100 == 0:
                    print(f"{i + 1}/{len(paths)}")
    else:
        for i, path in enumerate(paths):
            process_one(path, args.output_dir, args.length)
            if (i + 1) % 100 == 0:
                print(f"{i + 1}/{len(paths)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
