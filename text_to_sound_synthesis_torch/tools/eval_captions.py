"""Audiocaption-loss evaluation: caption generated audio, score vs references.

Port of the JAX package's ``tools/eval_captions.py``; ``--ckpt`` takes a
``torch.save``d state dict of the port's ``ACTCaptioner`` (its names are the
JAX package's modules; ``convert/from_jax.py::captioner_state_dict`` writes
one from a JAX parameter tree). The captioner runs on the card unless
``--device cpu``. The tool prints which stemmer and which synonym table
METEOR used: a host without nltk takes the lite stemmer and the vendored
table, and its METEOR differs.

Parity target: ``Codebook/AudiocaptionLoss/eval.py`` — run the ACT captioner
over generated sample mels, compute BLEU/CIDEr/ROUGE/METEOR (+SPICE/SPIDEr
when external SPICE scores are supplied), and select the top-k samples per
source clip by SPICE when available (the reference's behavior,
``eval.py:27-59``), else CIDEr.

SPICE execution path (the scene-graph scorer is a Java coco-caption stack,
external in the reference too): ``--emit_spice_input DIR`` writes the
predictions/references CSVs in the reference's exact format and prints the
one offline command to produce ``spice_scores.json``; feed that back via
``--spice_scores`` to get per-file SPICE selection and the true SPIDEr.

Usage:
  python -m text_to_sound_synthesis_torch.tools.eval_captions --samples_dir samples/ \
      --refs refs.csv --ckpt act.pt --vocab vocab.txt [--select_topk 2 --select_out best/] \
      [--emit_spice_input spice_io/] [--spice_scores spice_io/spice_scores.json] [--device cpu]
refs.csv rows: clip_name,caption (multiple rows per clip allowed).
"""

import argparse
import csv
import os
import shutil
from collections import defaultdict
from glob import glob

import numpy as np


def _emit_spice_input(outdir, per_file, cands, ref_sets, n_refs=5):
    """Write the two CSVs the reference's coco-caption stack consumes.

    Format per ``Codebook/AudiocaptionLoss/eval_metrics.py:271-306``:
    predictions.csv rows {file_name, caption_predicted}; references.csv rows
    {file_name, caption_reference_01..caption_reference_05} (AudioCaps ships
    5 refs/clip; fewer are cycled to fill the fixed-width columns, which
    leaves SPICE unchanged — it scores against the union of references).

    The offline run (needs Java 8 + the coco-caption checkout the reference
    vendors; neither ships with this repository):

      cd <reference checkout>/Codebook/AudiocaptionLoss && python -c "
      import json; from eval_metrics import evaluate_metrics_from_files
      m = evaluate_metrics_from_files('<DIR>/predictions.csv',
                                      '<DIR>/references.csv')
      json.dump({k: {'scores': v['scores']} for k, v in m.items()},
                open('<DIR>/spice_scores.json', 'w'))"

    then rerun this tool with ``--spice_scores <DIR>/spice_scores.json``.
    """
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "predictions.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, ["file_name", "caption_predicted"])
        w.writeheader()
        for path, cand in zip(per_file, cands):
            w.writerow({"file_name": os.path.basename(path),
                        "caption_predicted": cand})
    cols = [f"caption_reference_{i + 1:02d}" for i in range(n_refs)]
    with open(os.path.join(outdir, "references.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, ["file_name"] + cols)
        w.writeheader()
        for path, rs in zip(per_file, ref_sets):
            row = {"file_name": os.path.basename(path)}
            for i, col in enumerate(cols):
                row[col] = rs[i % len(rs)]
            w.writerow(row)
    print(f"wrote coco-caption input CSVs -> {outdir}\n"
          f"offline SPICE recipe: see text_to_sound_synthesis_torch/tools/eval_captions.py "
          f"(_emit_spice_input docstring); rerun with "
          f"--spice_scores {outdir}/spice_scores.json")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--samples_dir", required=True, help="dir of <clip>_sample_<i>.npy mels")
    p.add_argument("--refs", required=True, help="csv of clip_name,caption")
    p.add_argument("--ckpt", required=True, help="torch state dict of the port's ACTCaptioner")
    p.add_argument("--vocab", required=True, help="one word per line; ids = row index")
    p.add_argument("--beam", type=int, default=3)
    p.add_argument("--model_json", default=None,
                   help="JSON dict of ACTCaptioner field overrides (e.g. "
                        '\'{"nlayers": 2, "encoder_depth": 12}\') matching '
                        "the checkpoint's architecture")
    p.add_argument("--select_topk", type=int, default=0)
    p.add_argument("--select_out", default=None)
    p.add_argument("--select_metric", default="auto",
                   choices=["auto", "cider", "bleu_4", "rouge_l", "meteor", "spice"],
                   help="'auto' (default) selects by SPICE when --spice_scores "
                        "is given — the reference's behavior "
                        "(AudiocaptionLoss/eval.py:27-59) — else by CIDEr. "
                        "'spice' requires --spice_scores from an external "
                        "coco-caption Java run (not bundled)")
    p.add_argument("--spice_scores", default=None,
                   help="per-file SPICE scores computed externally (see "
                        "--emit_spice_input for the recipe). Accepts a flat "
                        "JSON {sample_filename: score} or the coco-caption "
                        "total_metrics JSON ({'SPICE': {'scores': {...}}}); "
                        "enables SPICE top-k selection and the true SPIDEr")
    p.add_argument("--emit_spice_input", default=None, metavar="DIR",
                   help="write predictions.csv + references.csv in the "
                        "reference coco-caption format and print the exact "
                        "offline command that produces --spice_scores")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.select_metric == "spice" and not args.spice_scores:
        p.error("--select_metric spice needs --spice_scores "
                "(external coco-caption Java run)")
    if args.select_metric == "auto":
        args.select_metric = "spice" if args.spice_scores else "cider"

    import torch

    from ..evaluation import caption_metrics as cm
    from ..evaluation.caption_metrics import caption_scores, tokenize_caption
    from ..models.captioner import ACTCaptioner, beam_decode
    from ..parallel.distributed import local_device

    with open(args.vocab) as f:
        vocab = [w.strip() for w in f]
    id2word = dict(enumerate(vocab))

    overrides = {}
    if args.model_json:
        import json

        overrides = json.loads(args.model_json)
    device = local_device(args.device)
    with torch.device(device):
        model = ACTCaptioner(ntoken=len(vocab), **overrides)
    sd = torch.load(args.ckpt, map_location=device, weights_only=True)
    model.load_state_dict(sd, strict=True)
    model.eval()
    res = cm.resolution()
    print(f"METEOR: stemmer {res['stemmer']}, synonyms {res['synonyms']}")

    refs = defaultdict(list)
    with open(args.refs) as f:
        for row in csv.reader(f):
            if len(row) >= 2:
                refs[row[0]].append(row[1])

    files = sorted(glob(os.path.join(args.samples_dir, "*.npy")))
    cands, ref_sets, clip_of, per_file = [], [], [], []
    for path in files:
        clip = os.path.basename(path).split("_sample_")[0]
        if clip not in refs:
            continue
        spec = np.load(path)  # (80, T) in [0, 1]
        mel = torch.from_numpy(np.ascontiguousarray(spec.T[None], np.float32)).to(device)
        toks = beam_decode(model, mel, beam_size=args.beam)[0]  # mel (1, T, 80)
        words = [id2word.get(int(t), "") for t in toks[1:] if int(t) != model.eos_id]
        cand = " ".join(w for w in words if w)
        cands.append(cand)
        ref_sets.append(refs[clip])
        clip_of.append(clip)
        per_file.append(path)

    if args.emit_spice_input:
        _emit_spice_input(args.emit_spice_input, per_file, cands, ref_sets)

    spice_by_file = None
    if args.spice_scores:
        import json

        with open(args.spice_scores) as f:
            spice_by_file = json.load(f)
        if "SPICE" in spice_by_file and isinstance(spice_by_file["SPICE"], dict):
            # coco-caption total_metrics layout: {'SPICE': {'scores':
            # {file: f}}} (eval_metrics.py:231-237) — accept it verbatim
            spice_by_file = spice_by_file["SPICE"]["scores"]

    scores = caption_scores(
        cands, ref_sets,
        spice_scores=[spice_by_file.get(os.path.basename(p), 0.0)
                      for p in per_file] if spice_by_file else None)
    for k, v in scores.items():
        print(f"{k}: {v:.4f}")

    if args.select_topk and args.select_out:
        def score_one(path, cand, rs):
            if args.select_metric == "spice":
                return float(spice_by_file.get(os.path.basename(path), 0.0))
            ct = [tokenize_caption(cand)]
            rt = [[tokenize_caption(r) for r in rs]]
            return {"cider": lambda: cm.cider_d(ct, rt),
                    "bleu_4": lambda: cm.bleu(ct, rt)[3],
                    "rouge_l": lambda: cm.rouge_l(ct, rt),
                    "meteor": lambda: cm.meteor(ct, rt)}[args.select_metric]()

        os.makedirs(args.select_out, exist_ok=True)
        by_clip = defaultdict(list)
        for path, cand, rs in zip(per_file, cands, ref_sets):
            s = score_one(path, cand, rs)
            by_clip[os.path.basename(path).split("_sample_")[0]].append((s, path))
        for clip, entries in by_clip.items():
            entries.sort(reverse=True)
            for s, path in entries[: args.select_topk]:
                shutil.copy(path, os.path.join(args.select_out, os.path.basename(path)))
        print(f"selected top-{args.select_topk} per clip -> {args.select_out}")
    return scores


if __name__ == "__main__":
    main()
