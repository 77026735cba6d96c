"""Each cell cut to a size a CPU test holds: the same files, narrower and shallower.

The benchmark's own tests drive whole runs of these on the CPU (the program's
kernels run their plain twins there); the cells themselves run only at the
sizes ``BENCHMARK.json`` names.
"""

import argparse
import contextlib
import importlib
import io
import json

import torch
import yaml

from . import run as bench_run

HERE = bench_run.HERE


def _yaml(name):
    return yaml.safe_load((HERE / "configs" / name).read_text())


def _mix(name, **kw):
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    mix.update(kw)
    return mix


def diffsound_config():
    c = _yaml("diffsound_audiocaps.yaml")
    m = c["model"]["params"]
    m["content_codec_config"]["params"]["ddconfig"].update(ch=8, ch_mult=[1, 1, 1, 1, 2],
                                                           num_res_blocks=1, z_channels=16)
    m["content_codec_config"]["params"].update(embed_dim=16, n_embed=64)
    d = m["diffusion_config"]["params"]
    d["diffusion_step"] = 12
    d["transformer_config"]["params"].update(n_layer=2, n_embd=128, n_head=2, condition_dim=64)
    d["condition_emb_config"]["params"].update(embed_dim=64, width=64, layers=2, heads=2)
    d["content_emb_config"]["params"].update(num_embed=64, embed_dim=128)
    c["vocoder"] = {"input_size": 80, "ngf": 4, "n_residual_layers": 1}
    return c


def vqgan_config():
    c = _yaml("vqgan_caps.yaml")
    c["model"]["params"]["ddconfig"].update(ch=8, ch_mult=[1, 1, 1, 1, 2], num_res_blocks=1,
                                            z_channels=16)
    c["model"]["params"].update(embed_dim=16, n_embed=32)
    return c


def _data(config, **kw):
    config["dataloader"].update(kw)
    return config


CELLS = {
    "caps.w4a8.b64": lambda: (diffsound_config(), _mix("offline_b64", batch=2,
                                                       calibration_batch=2, check_block=2,
                                                       check_among_first=1)),
    "caps.bf16.b64": lambda: (diffsound_config(), _mix("offline_b64_bf16", batch=2,
                                                       check_block=2, check_among_first=1)),
    "caps.train.f32": lambda: (_data(diffsound_config(), batch_size=2), _mix("stage2_train_b20")),
    "vqgan.train": lambda: (_data(vqgan_config(), batch_size=2, spec_crop_len=128),
                            _mix("stage1_train_b8")),
}


# At two layers of width 128 the int8 engine's rounding moves a larger share of
# the sampled tokens than at the published widths: sound tiny runs read
# token_mismatch 0.006-0.013, the A4 control 0.14 (CPU, 2 seeds). A tiny
# request has 530 tokens, so one token is 0.0019: the bf16 runs read
# 0.0019-0.0038, the float8 control 0.021 (CPU, 2 seeds).
TINY_LIMITS = {"caps.w4a8.b64": {"token_mismatch": 0.04},
               "caps.bf16.b64": {"token_mismatch": 0.01}}


# a window that holds whole tiny requests on a loaded CPU too (a bf16 request
# there takes about 0.3 s alone and over 1 s beside other work)
WINDOW_S = 3.0


def run_tiny(cell: str, seed: int = 5, seconds: float = WINDOW_S, trace: int = 0) -> dict:
    """One whole run of ``cell`` at the tiny size on the CPU; its result line."""
    config, mix = CELLS[cell]()
    bench = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    out, err = io.StringIO(), io.StringIO()
    limits = importlib.import_module(f"t2s_benchmark.drivers.{mix['driver']}").LIMITS
    saved = dict(limits)
    limits.update(TINY_LIMITS.get(cell, {}))
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench_run.run(args, bench, {"name": cell, "chips": 1}, config, mix,
                               torch.device("cpu"))
    finally:
        limits.clear()
        limits.update(saved)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])
