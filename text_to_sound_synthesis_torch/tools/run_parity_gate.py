"""One-command released-artifact parity gate of the port.

    python -m text_to_sound_synthesis_torch.tools.run_parity_gate \\
        --config_file configs/diffsound_audiocaps.yaml --ckpt diffsound_audiocaps.pth \\
        --vocoder vocoder_logs/ --melception melception.pt --gt_mels audiocaps_val_mels/ \\
        --csv audiocaps_val.csv --outdir parity_run/ [--int8] [--device cuda]
    python -m text_to_sound_synthesis_torch.tools.run_parity_gate --real artifacts/ \\
        --outdir parity_real/

The port of ``tools/run_parity_gate.py``, with its steps, flags and report
(plus ``--int8``, which generates on the W4A8 serving engine, and
``--device``). Given the released reference files it runs the parity
sequence and writes a ``PARITY_GATE.md`` table of (step, status, detail):

  1. load          -- the released ``.pth`` straight into the port (its
                      reference names need no converter), the denoiser's EMA
                      preferred (the JAX tool's ``convert`` step)
  2. roundtrip     -- mels through the port's codec against the reference's
                      own torch modules: exact code indices, the decode within
                      ``--thresh_roundtrip``
  3. logit_parity  -- the CLIP text tower and the denoiser's logits against
                      the reference's (EMA weights, the inference weights of
                      ``generate_samples_batch.py:82-87``)
  4. generate      -- the captions through the port's ``tools/generate.py``
                      (``--replicate``, ``--sample_type``, ``--seed``): on the
                      card the fused sampler's kernel each step, and with
                      ``--int8`` the serving engine's kernels
  5. metrics       -- FID / KL on Melception's features of the generated and
                      the ground-truth mels (``evaluation/``), FID and KL
                      checked against the reference's own metric code on the
                      same features where its sources are mounted

The reference's torch modules (``TorchTwins``) are built from its sources
under ``$T2S_REFERENCE`` (the checkout of the reference code) at the geometry of
``--config_file`` and take their weights from the same released file, on the
host's CPU. A step whose input is absent is SKIP, with the reason (the
reference's sources, the ground-truth mels, Melception); the gate FAILs only
on a measured mismatch or an error. Smoke mode (no artifacts: a proxy
``.pth`` of the reference's ``{'model', 'ema'}`` layout, ad-hoc
``--caption``s, ``--melception random``) runs every step it can.

``--real ROOT`` finds the checkpoint, the vocoder, Melception, the
ground-truth mels and the val csv under ROOT by the artifact manifest
(``utils/artifacts.py``), checks the pinned MD5s, and FAILs (not SKIPs) on
any that is missing: in real mode an absent artifact fails the gate.
Explicit flags override single discoveries. The released files are not in
the repository yet, so the real run waits for them. Captions need the CLIP
BPE merge table (``$T2S_CLIP_BPE``).
"""

from __future__ import annotations

import argparse
import csv as csv_mod
import importlib.util
import os
import sys
import time
from glob import glob

import numpy as np

REF = os.environ.get("T2S_REFERENCE", "")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PASS, FAIL, SKIP = "PASS", "FAIL", "SKIP"


def get_args(argv=None):
    p = argparse.ArgumentParser(description="released-artifact parity gate (PyTorch port)")
    p.add_argument("--real", default=None, metavar="ROOT",
                   help="artifact root: find the released files by the manifest, check their "
                        "MD5s, and FAIL on missing inputs")
    p.add_argument("--config_file", default=None)
    p.add_argument("--ckpt", default=None, help="released diffsound .pth")
    p.add_argument("--vocoder", default=None, help="MelGAN logdir")
    p.add_argument("--melception", default=None,
                   help="melception .pt; 'random' = smoke mode (metrics marked SKIP)")
    p.add_argument("--gt_mels", default=None, help="dir of ground-truth [0,1] mel .npy files")
    p.add_argument("--csv", default=None, help="val csv rows: name,caption")
    p.add_argument("--caption", action="append", default=None,
                   help="ad-hoc captions instead of --csv")
    p.add_argument("--outdir", default="parity_run")
    p.add_argument("--replicate", type=int, default=2)
    p.add_argument("--sample_type", default="top0.85r")
    p.add_argument("--batch", type=int, default=5)
    p.add_argument("--limit", type=int, default=0, help="cap the number of csv rows (0 = all)")
    p.add_argument("--num_classes", type=int, default=309,
                   help="melception classes (VGGSound release: 309)")
    p.add_argument("--thresh_roundtrip", type=float, default=1e-4)
    p.add_argument("--thresh_logits", type=float, default=3e-4)
    p.add_argument("--int8", action="store_true",
                   help="generate on the W4A8 serving engine (generate.py --int8)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.real is None and (args.config_file is None or args.ckpt is None):
        p.error("--config_file and --ckpt are required unless --real is given")
    return args


def _discover_real(args, record) -> bool:
    """Fill ``args`` from the artifact root; a FAIL row for anything missing.
    False when a required artifact is absent (the gate cannot go on)."""
    from ..utils.artifacts import verify

    if args.config_file is None:
        args.config_file = os.path.join(REPO, "configs", "diffsound_audiocaps.yaml")
    required = {"diffsound_ckpt": "ckpt", "melception": "melception",
                "vocoder": "vocoder", "gt_mels": "gt_mels", "val_csv": "csv"}
    ok = True
    for status in verify(args.real, list(required)):
        dest = required[status.name]
        if getattr(args, dest) is not None:     # an explicit flag overrides
            record("artifact", PASS, f"{status.name}: --{dest} override {getattr(args, dest)}")
            continue
        if status.status == "missing":
            record("artifact", FAIL, f"{status.name} MISSING — {status.detail}")
            ok = False
        elif status.status == "bad_md5":
            record("artifact", FAIL, f"{status.name}: {status.detail}")
            ok = False
        else:
            setattr(args, dest, status.path)
            record("artifact", PASS, f"{status.name}: {status.path} ({status.detail})")
    return ok


def _load_module_from_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _add_ref_paths():
    for p in (f"{REF}/Codebook", f"{REF}/Diffsound") if REF else ():
        if os.path.isdir(p) and p not in sys.path:
            sys.path.append(p)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


_RAW_CACHE: dict = {}


def _torch_load_cached(path):
    """One deserialization a checkpoint a run (the flagship ``.pth`` is
    GBs); ``weights_only=False``: released dicts carry pickled objects."""
    import torch

    key = os.path.abspath(path)
    if key not in _RAW_CACHE:
        _RAW_CACHE[key] = torch.load(key, map_location="cpu", weights_only=False)
    return _RAW_CACHE[key]


def _params(config, key):
    return dict((config["model"]["params"][key] or {}).get("params") or {})


class TorchTwins:
    """The reference's torch modules at the config's geometry, weights from
    the released file (the file the port loaded), on the CPU."""

    def __init__(self, config, ckpt_path):
        import torch

        self.torch = torch
        if not REF or not os.path.isdir(REF):
            raise FileNotFoundError(f"the reference sources are not mounted at "
                                    f"$T2S_REFERENCE={REF or '(unset)'}")
        _add_ref_paths()
        from sound_synthesis.modeling.transformers.transformer_utils import Block as TBlock
        from specvqgan.modules.diffusionmodules.model import Decoder as TDecoder
        from specvqgan.modules.diffusionmodules.model import Encoder as TEncoder
        from specvqgan.modules.vqvae.quantize import VectorQuantizer as TQuant

        clip_model = _load_module_from_file(
            "ref_clip_model_gate", f"{REF}/Diffsound/sound_synthesis/modeling/modules/clip/model.py")
        raw = _torch_load_cached(ckpt_path)
        sd = raw.get("model", raw)
        self.has_ema = "ema" in raw

        # -- codec --
        cc = _params(config, "content_codec_config")
        dd, zc, ne = dict(cc["ddconfig"]), cc["embed_dim"], cc["n_embed"]
        self.enc = TEncoder(**dd).eval()
        self.dec = TDecoder(**dd).eval()
        self.quant = TQuant(ne, zc, beta=0.25).eval()
        self.qconv = torch.nn.Conv2d(dd["z_channels"], zc, 1)
        self.pqconv = torch.nn.Conv2d(zc, dd["z_channels"], 1)
        self.enc.load_state_dict(_strip(sd, "content_codec.encoder."))
        self.dec.load_state_dict(_strip(sd, "content_codec.decoder."))
        self.quant.load_state_dict(_strip(sd, "content_codec.quantize."))
        self.qconv.load_state_dict(_strip(sd, "content_codec.quant_conv."))
        self.pqconv.load_state_dict(_strip(sd, "content_codec.post_quant_conv."))

        # -- CLIP text tower (condition_emb's attribute layout) --
        dp = _params(config, "diffusion_config")
        cp = dict(dp["condition_emb_config"].get("params") or {})
        width, heads, ctx = cp.get("width", 512), cp.get("heads", 8), cp.get("context_length", 77)
        ce = _strip(sd, "transformer.condition_emb.")
        mask = torch.full((ctx, ctx), float("-inf")).triu(1)
        n_blocks = len({k.split(".")[2] for k in ce if k.startswith("transformer.resblocks.")})
        self.clip_blocks = torch.nn.ModuleList(
            [clip_model.ResidualAttentionBlock(width, heads, mask)
             for _ in range(n_blocks)]).eval()
        for i, b in enumerate(self.clip_blocks):
            b.load_state_dict(_strip(ce, f"transformer.resblocks.{i}."))
        self.tok_emb = torch.nn.Embedding(*ce["token_embedding.weight"].shape)
        self.tok_emb.load_state_dict({"weight": ce["token_embedding.weight"]})
        self.pos_emb = ce["positional_embedding"]
        self.ln_final = torch.nn.LayerNorm(width)
        self.ln_final.load_state_dict({"weight": ce["ln_final.weight"],
                                       "bias": ce["ln_final.bias"]})

        # -- the denoiser (its EMA preferred, as the port's load) --
        bb = (_strip(raw["ema"], "transformer.") if self.has_ema
              else _strip(sd, "transformer.transformer."))
        tcfg = dict(dp["transformer_config"].get("params") or {})
        H, W = tuple(tcfg.get("content_spatial_size", (5, 53)))
        n_embd, n_layer = int(tcfg.get("n_embd", 1024)), int(tcfg.get("n_layer", 19))
        self.blocks = torch.nn.ModuleList([
            TBlock(condition_seq_len=ctx, n_embd=n_embd, n_head=int(tcfg.get("n_head", 16)),
                   seq_len=H * W, attn_pdrop=0.0, resid_pdrop=0.0,
                   mlp_hidden_times=int(tcfg.get("mlp_hidden_times", 4)),
                   activate=tcfg.get("block_activate", "GELU2"), attn_type="selfcross",
                   condition_dim=int(width), diffusion_step=int(dp.get("diffusion_step", 100)),
                   timestep_type=tcfg.get("timestep_type", "adalayernorm"), mlp_type="fc")
            for _ in range(n_layer)]).eval()
        for i, b in enumerate(self.blocks):
            b.load_state_dict(_strip(bb, f"blocks.{i}."))
        K = bb["content_emb.emb.weight"].shape[0]
        self.content_emb = torch.nn.Embedding(K, n_embd)
        self.content_emb.load_state_dict({"weight": bb["content_emb.emb.weight"]})
        self.h_emb = torch.nn.Embedding(H, n_embd)
        self.h_emb.load_state_dict({"weight": bb["content_emb.height_emb.weight"]})
        self.w_emb = torch.nn.Embedding(W, n_embd)
        self.w_emb.load_state_dict({"weight": bb["content_emb.width_emb.weight"]})
        self.ln_out = torch.nn.LayerNorm(n_embd)
        self.ln_out.load_state_dict({"weight": bb["to_logits.0.weight"],
                                     "bias": bb["to_logits.0.bias"]})
        self.head = torch.nn.Linear(n_embd, K - 1)
        self.head.load_state_dict({"weight": bb["to_logits.1.weight"],
                                   "bias": bb["to_logits.1.bias"]})
        self.hw = (H, W)

    def codec_roundtrip(self, x_nhwc):
        """(B, H, W, 1) [-1, 1] -> (indices, reconstruction NHWC)."""
        torch = self.torch
        xt = torch.from_numpy(np.transpose(x_nhwc, (0, 3, 1, 2)))
        with torch.no_grad():
            zq, _, (_, _, idx) = self.quant(self.qconv(self.enc(xt)))
            rec = self.dec(self.pqconv(zq)).numpy()
        return idx.numpy().ravel(), np.transpose(rec, (0, 2, 3, 1))

    def encode_text(self, tokens):
        torch = self.torch
        with torch.no_grad():
            x = self.tok_emb(torch.from_numpy(tokens.astype(np.int64))) + self.pos_emb
            x = x.permute(1, 0, 2)
            for b in self.clip_blocks:
                x = b(x)
            x = self.ln_final(x.permute(1, 0, 2))
            return (x / x.norm(dim=-1, keepdim=True)).numpy()

    def denoiser_logits(self, tokens, cond, tstep):
        torch = self.torch
        H, W = self.hw
        with torch.no_grad():
            emb = self.content_emb(torch.from_numpy(tokens.astype(np.int64)))
            pos = self.h_emb(torch.arange(H)).unsqueeze(1) + self.w_emb(torch.arange(W)).unsqueeze(0)
            h = emb + pos.reshape(1, H * W, -1)
            for b in self.blocks:
                h, _ = b(h, torch.from_numpy(cond), torch.from_numpy(tstep.astype(np.int64)))
            return self.head(self.ln_out(h)).numpy()


def load_released(config, ckpt: str, device, seed: int = 0):
    """Step 1: the config's composite on ``device`` with the released file's
    weights, the denoiser's EMA preferred -> (model, whether the file has an
    EMA section)."""
    from ..engine.checkpoint import load_weights
    from ..models.diffsound import build_model

    raw = _torch_load_cached(ckpt)
    model = build_model(config, device=device, seed=seed, load_codec=False)
    load_weights(model, raw, prefer_ema=True)
    return model, bool(raw.get("ema"))


def _generate_argv(args, samples_dir):
    argv = ["--config_file", args.config_file, "--ckpt", args.ckpt, "--outdir", samples_dir,
            "--replicate", str(args.replicate), "--sample_type", args.sample_type,
            "--batch", str(args.batch), "--seed", str(args.seed), "--device", args.device]
    if args.int8:
        argv.append("--int8")
    if args.csv:
        path = args.csv
        if args.limit:
            path = os.path.join(args.outdir, "_val_limited.csv")
            with open(args.csv) as f, open(path, "w", newline="") as g:
                w = csv_mod.writer(g)
                for i, row in enumerate(csv_mod.reader(f)):
                    if i >= args.limit:
                        break
                    w.writerow(row)
        argv += ["--csv", path]
    else:
        for c in (args.caption or ["a dog barks"]):
            argv += ["--caption", c]
    if args.vocoder:
        argv += ["--vocoder", args.vocoder]
    return argv


def main(argv=None) -> int:
    args = get_args(argv)
    t_start = time.time()
    os.makedirs(args.outdir, exist_ok=True)
    rows = []   # (step, status, detail)

    def record(step, status, detail):
        rows.append((step, status, detail))
        print(f"[gate] {step:<14} {status}  {detail}", flush=True)

    import torch

    from ..parallel.distributed import local_device
    from ..utils.config import load_yaml_config
    from ..utils.dtype import full_f32
    from . import generate as gen_cli

    device = local_device(args.device)
    if args.real is not None and not _discover_real(args, record):
        return _write_report(args, rows, t_start)
    config = load_yaml_config(args.config_file)

    # ---- 1. load ------------------------------------------------------------
    try:
        model, has_ema = load_released(config, args.ckpt, device, args.seed)
        record("load", PASS, f"{os.path.basename(args.ckpt)} -> the port's codec, text tower "
                             f"and denoiser ({'EMA-preferred' if has_ema else 'no EMA section; raw model'})")
    except Exception as e:  # noqa: BLE001 - the gate reports, it does not crash
        record("load", FAIL, repr(e))
        return _write_report(args, rows, t_start)

    # ---- the reference's torch modules -----------------------------------------
    twins, twin_err = None, None
    try:
        twins = TorchTwins(config, args.ckpt)
    except Exception as e:  # noqa: BLE001
        twin_err = repr(e)

    # ---- 2. codec roundtrip --------------------------------------------------
    rng = np.random.default_rng(args.seed)
    gt_paths = sorted(glob(os.path.join(args.gt_mels, "*.npy"))) if args.gt_mels else []
    if gt_paths:
        mels01 = np.stack([np.load(p) for p in gt_paths[:4]])
        x = (mels01 * 2.0 - 1.0)[..., None].astype(np.float32)
        src = f"{min(4, len(gt_paths))} ground-truth mels"
    else:      # at the native geometry the token grid implies
        down = model.time_downsample
        x = rng.uniform(-1, 1, (2, model.token_hw[0] * down, model.token_hw[1] * down,
                                1)).astype(np.float32)
        src = "synthetic mels (no --gt_mels)"
    if twins is None:
        record("roundtrip", SKIP, f"torch twins unavailable: {twin_err}")
    else:
        try:
            idx_t, rec_t = twins.codec_roundtrip(x)
            with torch.no_grad(), full_f32(), model.compute_weights(model.codec):
                xrec, vq = model.codec(torch.from_numpy(x).to(device, model.dtype))
            idx_p = vq.indices.cpu().numpy().ravel()
            exact = bool((idx_p == idx_t).all())
            err = float(np.abs(xrec.float().cpu().numpy() - rec_t).max())
            ok = exact and err <= args.thresh_roundtrip
            record("roundtrip", PASS if ok else FAIL,
                   f"{src}: indices {'EXACT' if exact else 'MISMATCH'}, "
                   f"decode max|d|={err:.2e} (thresh {args.thresh_roundtrip:g})")
        except Exception as e:  # noqa: BLE001
            record("roundtrip", FAIL, repr(e))

    # ---- 3. CLIP and denoiser logit parity -----------------------------------------
    if twins is None:
        record("logit_parity", SKIP, f"torch twins unavailable: {twin_err}")
    else:
        try:
            caps = (args.caption or ["a dog barks", "rain falls on a roof"])[:2]
            toks = np.asarray(model.text_to_tokens(caps)["token"])
            with torch.no_grad(), full_f32():
                cond_p = model.embed_condition(torch.from_numpy(toks).long().to(device))
                cond_t = twins.encode_text(toks)
                d_cond = float(np.abs(cond_p.float().cpu().numpy() - cond_t).max())
                K, seq = model.diffusion.num_classes, model.diffusion.content_seq_len
                B = cond_t.shape[0]
                tokens = rng.integers(0, K, (B, seq))
                tstep = rng.integers(0, model.diffusion.diffusion_step, (B,))
                with model.compute_weights(model.diffusion.transformer):
                    got = model.diffusion.backbone_logits(
                        torch.from_numpy(tokens).to(device), cond_p,
                        torch.from_numpy(tstep).to(device)).float().cpu().numpy()
            want = twins.denoiser_logits(tokens, cond_t, tstep)
            scale = float(np.abs(want).max()) or 1.0
            d_log = float(np.abs(got - want).max()) / scale
            ok = d_cond <= args.thresh_logits and d_log <= args.thresh_logits
            record("logit_parity", PASS if ok else FAIL,
                   f"cond max|d|={d_cond:.2e}; denoiser rel max|d|={d_log:.2e} "
                   f"(thresh {args.thresh_logits:g}, EMA weights)")
        except Exception as e:  # noqa: BLE001
            record("logit_parity", FAIL, repr(e))
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- 4. generation ----------------------------------------------------------
    samples_dir = os.path.join(args.outdir, "samples")
    try:
        gen_cli.main(_generate_argv(args, samples_dir))
        n = len(glob(os.path.join(samples_dir, "*.npy")))
        record("generate", PASS if n else FAIL,
               f"{n} samples (replicate={args.replicate}, {args.sample_type}"
               f"{', int8 W4A8' if args.int8 else ''}) -> {samples_dir}")
    except Exception as e:  # noqa: BLE001
        record("generate", FAIL, repr(e))

    # ---- 5. metrics ---------------------------------------------------------------
    if not (args.gt_mels and args.melception):
        record("metrics", SKIP, "needs --gt_mels and --melception (released 309-class weights)")
    else:
        try:
            record("metrics", *_run_metrics(args, samples_dir, gt_paths, device))
        except Exception as e:  # noqa: BLE001
            # a random-Melception smoke run may fail on its geometry (tiny
            # proxy mels are below Inception's): a SKIP, not a parity failure
            record("metrics", SKIP if args.melception == "random" else FAIL, repr(e))

    return _write_report(args, rows, t_start)


def _run_metrics(args, samples_dir, gt_paths, device):
    import torch

    from ..evaluation.features import FakesFolder, extract_features
    from ..evaluation.metrics import calculate_fid, calculate_kl
    from ..models.melception import Melception, load_melception_checkpoint
    from ..utils.init import init_random_

    for probe_path in sorted(glob(os.path.join(samples_dir, "*.npy")))[:1] + gt_paths[:1]:
        shape = np.load(probe_path).shape
        if min(shape[-2:]) < 32:
            raise ValueError(f"{probe_path}: mel {shape} below Melception's minimum geometry")
    mel_model = Melception(num_classes=args.num_classes).to(device)
    smoke = args.melception == "random"
    if smoke:
        init_random_(mel_model, torch.Generator(device).manual_seed(0))
    else:
        load_melception_checkpoint(mel_model, args.melception)
    f1 = extract_features(mel_model, FakesFolder(samples_dir), batch_size=args.batch)
    f2 = extract_features(mel_model, FakesFolder(args.gt_mels), batch_size=args.batch)
    fid = calculate_fid(f1["2048"], f2["2048"])["frechet_inception_distance"]
    kl = calculate_kl(f1["logits"], f1["file_path_"], f2["logits"], f2["file_path_"],
                      "caps")["kullback_leibler_divergence"]
    detail = (f"FID={fid:.4f} KL={kl:.4f} "
              f"({'RANDOM melception — smoke only' if smoke else args.melception})")

    # the port's metric code against the reference's own on the same
    # features (Codebook/evaluation/metrics/{fid,kl}.py)
    _add_ref_paths()
    try:
        from evaluation.metrics.fid import calculate_fid as ref_fid  # type: ignore
        from evaluation.metrics.kl import calculate_kl as ref_kl  # type: ignore

        rf = ref_fid({"2048": torch.from_numpy(np.asarray(f1["2048"], np.float64))},
                     {"2048": torch.from_numpy(np.asarray(f2["2048"], np.float64))},
                     "2048")["frechet_inception_distance"]
        rk = ref_kl({"logits": torch.from_numpy(np.asarray(f1["logits"], np.float64)),
                     "file_path_": f1["file_path_"]},
                    {"logits": torch.from_numpy(np.asarray(f2["logits"], np.float64)),
                     "file_path_": f2["file_path_"]},
                    "logits", "caps")["kullback_leibler_divergence"]
        ok = (abs(rf - fid) <= 1e-4 * max(1.0, abs(rf))
              and abs(rk - kl) <= 1e-4 * max(1.0, abs(rk)))
        detail += f"; ref-code FID={rf:.4f} KL={rk:.4f} ({'match' if ok else 'MISMATCH'})"
        return (SKIP if smoke else PASS if ok else FAIL), detail
    except Exception as e:  # noqa: BLE001
        return (SKIP if smoke else PASS), detail + f"; ref-code cross-check unavailable: {e!r}"


def _write_report(args, rows, t_start) -> int:
    path = os.path.join(args.outdir, "PARITY_GATE.md")
    with open(path, "w") as f:
        f.write("# Released-artifact parity gate\n\n")
        f.write(f"config: `{args.config_file}`  \nckpt: `{args.ckpt}`  \n"
                f"elapsed: {time.time() - t_start:.1f}s\n\n")
        f.write("| step | status | detail |\n|---|---|---|\n")
        for step, status, detail in rows:
            f.write(f"| {step} | {status} | {detail} |\n")
        statuses = [s for _, s, _ in rows]
        verdict = (FAIL if FAIL in statuses
                   else (PASS if statuses.count(PASS) >= 3 else "PARTIAL"))
        f.write(f"\n**Gate: {verdict}** ({statuses.count(PASS)} pass / "
                f"{statuses.count(SKIP)} skip / {statuses.count(FAIL)} fail)\n")
    print(f"[gate] report -> {path}")
    return 1 if any(s == FAIL for _, s, _ in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
