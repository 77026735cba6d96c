"""Offline text-feature extraction for the AR baseline's conditioning dirs.

    python -m text_to_sound_synthesis_torch.tools.extract_text_features --mode clip \\
        --clip_ckpt ViT-B-32.pt --captions caps.csv --outdir cls_token_512/ [--device cuda]
    python -m text_to_sound_synthesis_torch.tools.extract_text_features --mode bert \\
        --bert_path ./bert-base-uncased --captions caps.csv --outdir cls_token_768/

The port of ``tools/extract_text_features.py`` (reference
``Codebook/generete_text_fea/generate_fea_clip.py``, CLIP ViT-B/32 512-d
caption vectors, and ``predict_one.py``, BERT CLS 768-d vectors): rows of
``clip_name,caption`` -> one ``<clip_name>.txt`` a row, the vector in
``np.savetxt``'s ``%.8f``. ``--mode clip`` runs the port's text tower,
``CLIPTextEmbedding(normalize=True, pick_last_embedding=True,
embed_dim=512)`` (the EOT feature through ``text_projection``, L2-normed, as
``model.encode_text`` is used there), on the card unless ``--device cpu``;
without a card it exits nonzero. ``--clip_ckpt`` is the released CLIP
(a TorchScript archive) or a torch state dict under OpenAI's names; its text
tower's weights are loaded as they are, the vision tower's ignored. Without
it the weights are seeded random, with a warning. ``--mode bert`` runs
``transformers``' ``BertModel`` from a local directory, on the host, and
needs that package. Captions need the CLIP BPE merge table
(``$T2S_CLIP_BPE``).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys


def get_args(argv=None):
    p = argparse.ArgumentParser(description="caption feature extraction (PyTorch port)")
    p.add_argument("--mode", choices=["clip", "bert"], default="clip")
    p.add_argument("--captions", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--clip_ckpt", default=None,
                   help="released CLIP ViT-B/32 .pt, or a state dict under its names (else "
                        "random)")
    p.add_argument("--bert_path", default="bert-base-uncased",
                   help="local transformers BertModel directory")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0, help="the random CLIP weights' seed")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    import numpy as np

    with open(args.captions) as f:
        rows = [(r[0], r[1]) for r in csv.reader(f) if len(r) >= 2]
    os.makedirs(args.outdir, exist_ok=True)

    feats = extract_clip(rows, args) if args.mode == "clip" else extract_bert(rows, args)
    for (name, _), vec in zip(rows, feats):
        np.savetxt(os.path.join(args.outdir, name + ".txt"), vec[None], fmt="%.8f")
    print(f"wrote {len(rows)} feature files to {args.outdir}")
    return 0


def clip_state_dict(path: str):
    """The released CLIP's state dict: a TorchScript archive's, or a pickled
    state dict's (``convert.checkpoint.load_torch_state_dict``)."""
    import torch

    from ..convert.checkpoint import load_torch_state_dict

    try:
        archive = torch.jit.load(path, map_location="cpu")
    except RuntimeError:        # not a TorchScript archive
        return load_torch_state_dict(path)
    return {k: v.float() for k, v in archive.state_dict().items()}


def extract_clip(rows, args):
    import numpy as np
    import torch

    from ..models.clip import CLIPTextEmbedding, Tokenize
    from ..parallel.distributed import local_device
    from ..utils.init import init_random_

    device = local_device(args.device)
    # the EOT-projected 512-d vector (generate_fea_clip.py uses model.encode_text)
    with torch.device("meta"):
        emb = CLIPTextEmbedding(normalize=True, pick_last_embedding=True, embed_dim=512)
    emb = emb.to_empty(device=device).eval()
    if args.clip_ckpt:
        own = emb.state_dict()
        emb.load_state_dict({k: v for k, v in clip_state_dict(args.clip_ckpt).items()
                             if k in own})
    else:
        init_random_(emb, torch.Generator(device).manual_seed(args.seed))
        print("WARNING: random CLIP weights (pass --clip_ckpt)", file=sys.stderr)
    codec = Tokenize(context_length=77)
    out = []
    with torch.no_grad():
        for i in range(0, len(rows), args.batch):
            caps = [c for _, c in rows[i:i + args.batch]]
            toks = torch.from_numpy(codec.get_tokens(caps)["token"]).to(device)
            out.append(emb(toks).float().cpu().numpy())
    return np.concatenate(out)


def extract_bert(rows, args):
    import numpy as np
    import torch

    try:
        from transformers import BertModel, BertTokenizer
    except ImportError as e:
        raise RuntimeError("--mode bert needs the transformers package, which is not "
                           "installed") from e
    tok = BertTokenizer.from_pretrained(args.bert_path)
    model = BertModel.from_pretrained(args.bert_path).eval()
    out = []
    with torch.no_grad():
        for i in range(0, len(rows), args.batch):
            caps = [c for _, c in rows[i:i + args.batch]]
            enc = tok(caps, padding=True, truncation=True, max_length=64,
                      return_tensors="pt")
            hidden = model(**enc).last_hidden_state  # (B, L, 768)
            out.append(hidden[:, 0].numpy())          # CLS vectors
    return np.concatenate(out)


if __name__ == "__main__":
    sys.exit(main())
