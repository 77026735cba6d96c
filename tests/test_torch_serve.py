"""The port's HTTP server (``text_to_sound_synthesis_torch/tools/serve.py``)
against the JAX package's ``tools/serve.py``, on the CPU.

The HTTP contract: the JAX server's ``make_handler`` imports no JAX until a
wav is asked for, so both handlers are driven with the same stub engine and
the same raw requests, and must answer the same bytes (status line, headers,
bodies: JSON errors, the mel ``.npy``, the PCM_24 wav). The micro-batcher:
the port's ``Engine`` at the tiny composite of ``tests/test_composite.py``,
its captions tokenized on ``chip_smoke.py``'s synthetic merge table.
"""

import io
import json
import os
import socket
import sys
import threading
import time
import warnings
from argparse import Namespace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import serve as jax_serve  # noqa: E402  (tools/serve.py)
from text_to_sound_synthesis_torch.models.diffusion.int8_runtime import (  # noqa: E402
    sample_tokens_int8_sharded)
from text_to_sound_synthesis_torch.tools import bench_serve  # noqa: E402
from text_to_sound_synthesis_torch.tools import generate as port_generate  # noqa: E402
from text_to_sound_synthesis_torch.tools import serve as port_serve  # noqa: E402

from tests.test_cli import _plain  # noqa: E402
from tests.test_composite import TINY_MODEL_CFG  # noqa: E402

torch.set_num_threads(1)


# -- the HTTP contract ---------------------------------------------------------------------

class StubEngine:
    """What ``make_handler`` reads of an engine: ``args``, ``served``,
    ``vocoder`` and ``generate``, which raises the given module's errors for
    the captions that name them."""

    def __init__(self, module, vocoder: bool):
        self.module = module
        self.args = Namespace(batch=4, sample_rate=22050)
        self.served = 7
        self.vocoder = self._vocode if vocoder else None

    @staticmethod
    def _vocode(spec):
        t = np.arange(spec.shape[-1] * 4, dtype=np.float64)
        return np.sin(t[None] * 0.01) * spec.mean(axis=(1, 2))[:, None] * 1.7   # clipped at 1

    def generate(self, caption):
        if caption == "overload":
            raise self.module.Overloaded("request queue full (64 pending)")
        if caption == "slow":
            raise self.module.DispatchTimeout("generation did not complete in 120.0s")
        if caption == "boom":
            raise RuntimeError("ValueError('bad batch')")
        rng = np.random.default_rng(len(caption))
        return rng.uniform(0, 1, (4, 16)).astype(np.float32)


def _post(path, obj=None, raw=None):
    body = raw if raw is not None else json.dumps(obj).encode()
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n").encode() + body


REQUESTS = [
    b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET /nope HTTP/1.1\r\nHost: x\r\n\r\n",
    _post("/nope", {"caption": "a dog"}),
    _post("/generate", {}),
    _post("/generate", {"caption": 5}),
    _post("/generate", {"caption": ""}),
    _post("/generate", {"caption": "a dog", "format": "flac"}),
    _post("/generate", {"caption": "a dog", "format": "mel"}),
    _post("/generate", {"caption": "a dog barks", "format": "wav"}),
    _post("/generate", {"caption": "rain"}),
    _post("/generate", {"caption": "overload", "format": "mel"}),
    _post("/generate", {"caption": "slow", "format": "mel"}),
    _post("/generate", {"caption": "boom", "format": "mel"}),
    _post("/generate", raw=b"{not json"),
    (b"POST /generate HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n"),
]


def _exchange(handler, requests):
    """Each raw request to a server of ``handler`` -> the raw response bytes."""
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    out = []
    try:
        for req in requests:
            with socket.create_connection(srv.server_address, timeout=30) as s:
                s.sendall(req)
                chunks = []
                while chunk := s.recv(65536):
                    chunks.append(chunk)
            out.append(b"".join(chunks))
    finally:
        srv.shutdown()
        srv.server_close()
    return out


@pytest.mark.parametrize("vocoder", [True, False])
def test_http_contract_equals_jax(monkeypatch, vocoder):
    """Status codes, headers and bodies, the mel .npy and the PCM_24 wav
    bytes included, equal to the JAX server's for every request."""
    monkeypatch.setattr(BaseHTTPRequestHandler, "date_time_string",
                        lambda self, timestamp=None: "Thu, 01 Jan 2026 00:00:00 GMT")
    got = _exchange(port_serve.make_handler(StubEngine(port_serve, vocoder)), REQUESTS)
    want = _exchange(jax_serve.make_handler(StubEngine(jax_serve, vocoder)), REQUESTS)
    assert len(got) == len(want) == len(REQUESTS)
    for req, g, w in zip(REQUESTS, got, want):
        assert g == w, req
    codes = [int(r.split(b" ", 2)[1]) for r in got]
    assert codes == [200, 404, 404, 400, 400, 400, 400, 200, 200 if vocoder else 400, 200,
                     429, 503, 500, 500, 400]
    spec = np.load(io.BytesIO(got[7].split(b"\r\n\r\n", 1)[1]))
    assert spec.shape == (4, 16) and spec.dtype == np.float32
    kind = b"audio/wav" if vocoder else b"application/octet-stream"
    assert b"Content-Type: " + kind in got[9]


def test_server_class():
    srv = port_serve.make_server(StubEngine(port_serve, False), "127.0.0.1", 0)
    try:
        assert srv.request_queue_size == 256 and srv.server_address[1] > 0
    finally:
        srv.server_close()


# -- the micro-batcher on the tiny composite ----------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny composite's YAML, the synthetic merge table in $T2S_CLIP_BPE,
    and a caption file for --calibrate."""
    d = tmp_path_factory.mktemp("serve")
    cfg = str(d / "tiny.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"model": _plain(TINY_MODEL_CFG)}, f)
    calib = d / "captions.txt"
    calib.write_text("a dog barks\nrain falls on the roof\n")
    old = os.environ.get("T2S_CLIP_BPE")
    os.environ["T2S_CLIP_BPE"] = chip_smoke.write_merge_table(str(d / "merges.txt"))
    yield cfg, str(calib)
    if old is None:
        os.environ.pop("T2S_CLIP_BPE")
    else:
        os.environ["T2S_CLIP_BPE"] = old


def _engine(cfg, *extra, batch=4, wait_ms=400):
    args = port_serve.get_args(["--config_file", cfg, "--ckpt", "random", "--batch", str(batch),
                                "--max_wait_ms", str(wait_ms), "--device", "cpu", *extra])
    return port_serve.Engine(args)


def _concurrently(engine, captions, timeout=60):
    """``engine.generate`` for each caption from its own thread -> the
    results (a spectrogram or the exception), in order."""
    out = [None] * len(captions)

    def call(i, c):
        try:
            out[i] = engine.generate(c)
        except Exception as e:  # noqa: BLE001 — the test reads it
            out[i] = e

    ts = [threading.Thread(target=call, args=(i, c)) for i, c in enumerate(captions)]
    for t in ts:
        t.start()
        time.sleep(0.01)
    for t in ts:
        t.join(timeout)
        assert not t.is_alive()
    return out


def _direct(engine, captions, state, run=None):
    """The spectrograms of one direct call on ``captions`` padded to the
    batch, the generator in ``state``."""
    g = torch.Generator(engine.device)
    g.set_state(state)
    caps = captions + [""] * (engine.args.batch - len(captions))
    toks = torch.from_numpy(engine.model.text_to_tokens(caps)["token"])
    mel = (run or (lambda g, t: engine.model.generate(g, t)))(g, toks)
    return port_generate.to_spec(mel).numpy()


def test_batcher_shares_batches_and_pads(tiny):
    """Two concurrent callers share one batch, padded to --batch; a lone
    caller is dispatched after the linger; ``served`` counts requests; a
    batch of identical captions equals a direct ``generate`` on the same
    padded captions with the generator in the same state, bit for bit."""
    cfg, _ = tiny
    engine = _engine(cfg)
    try:
        seen = []
        run = engine._run
        engine._run = lambda g, toks: (seen.append(tuple(toks.shape)), run(g, toks))[1]
        state = engine.generator.get_state()
        specs = _concurrently(engine, ["a dog barks", "a dog barks"])
        assert [t["size"] for t in engine.timeline] == [2]      # one batch
        assert seen == [(4, 12)] and engine.served == 2
        want = _direct(engine, ["a dog barks", "a dog barks"], state)
        np.testing.assert_array_equal(specs[0], want[0])
        np.testing.assert_array_equal(specs[1], want[1])

        t0 = time.perf_counter()
        engine.generate("rain")
        assert time.perf_counter() - t0 >= 0.4                  # the linger
        assert engine.timeline[1]["size"] == 1 and engine.served == 3

        state = engine.generator.get_state()
        specs = _concurrently(engine, ["thunder"] * 4)          # a full batch, no padding
        assert engine.timeline[2]["size"] == 4 and engine.served == 7
        want = _direct(engine, ["thunder"] * 4, state)
        # the callers' rows follow their arrival: match them as a set
        assert sorted(s.tobytes() for s in specs) == sorted(w.tobytes() for w in want)
        assert len({s.tobytes() for s in specs}) == 4           # one draw a row
        assert all(t["dispatch_start"] <= t["dispatch_end"] <= t["fetch_end"]
                   for t in engine.timeline)
    finally:
        engine.close()


def test_batcher_429_503_500(tiny):
    """429 past --queue_limit, 503 past --request_timeout_s (a ``_run`` that
    blocks), 500 for every caller of a batch whose ``_run`` raises; the loop
    serves again after each."""
    cfg, _ = tiny
    engine = _engine(cfg, "--queue_limit", "2", "--request_timeout_s", "30", wait_ms=1)
    run, release = engine._run, threading.Event()
    try:
        def blocked(g, toks):
            release.wait(30)
            return run(g, toks)

        engine._run = blocked
        waiting = []
        for cap in ("a dog", "rain", "wind"):   # the collector holds the first, inside _run
            waiting.append(threading.Thread(target=engine.generate, args=(cap,)))
            waiting[-1].start()
            time.sleep(0.3)
        with pytest.raises(port_serve.Overloaded):     # 2 pending
            engine.generate("thunder")
        release.set()
        for t in waiting:
            t.join(30)
            assert not t.is_alive()

        release.clear()
        engine.args.request_timeout_s = 0.2
        with pytest.raises(port_serve.DispatchTimeout):
            engine.generate("a dog")
        release.set()
        engine.args.request_timeout_s = 30

        def broken(g, toks):
            raise ValueError("bad batch")

        engine._run = broken
        errs = _concurrently(engine, ["a dog", "rain"])
        assert all(isinstance(e, RuntimeError) and "bad batch" in str(e) for e in errs)
        engine._run = run
        served = engine.served
        assert engine.generate("a dog").shape == (4, 16)
        assert engine.served == served + 1
    finally:
        release.set()
        engine.close()


def test_int8_refusals(tiny, monkeypatch):
    """The int8 branches refuse anything but top-r sampling and refuse
    q-resample, with the JAX server's messages: the model's on one device,
    the sharded branch's own."""
    cfg, _ = tiny
    for sample_type, msg in (("top100p", "supports top-r truncation sampling"),
                             ("top0.85r,q0.5", "does not support q-resample wrappers")):
        with pytest.raises(ValueError, match=msg):
            _engine(cfg, "--int8", "--sample_type", sample_type)
    monkeypatch.setattr(port_serve, "serving_devices", lambda device: [device, device])
    for sample_type, msg in (("top100p", "supports top-r sampling only"),
                             ("top0.85r,q0.5", "does not support q-resample$")):
        with pytest.raises(ValueError, match=msg):
            _engine(cfg, "--int8", "--sample_type", sample_type)


def test_int8_static_and_sharded(tiny, monkeypatch):
    """--int8 --calibrate serves the static engine: a batch equals a direct
    ``generate_int8`` with the engine's ``qp``. On two devices (the CPU
    twice) a batch that divides splits: equal to ``sample_tokens_int8_sharded``
    on the same devices with the batch's seed; one that does not divide
    warns and serves on one device."""
    cfg, calib = tiny
    engine = _engine(cfg, "--int8", "--calibrate", calib, batch=2)
    try:
        assert engine.qp.act_scales is not None and engine.qp.weight_bits == 4
        state = engine.generator.get_state()
        specs = _concurrently(engine, ["a dog barks"])
        want = _direct(engine, ["a dog barks"], state,
                       lambda g, t: engine.model.generate_int8(engine.qp, g, t))
        np.testing.assert_array_equal(specs[0], want[0])
    finally:
        engine.close()

    monkeypatch.setattr(port_serve, "serving_devices", lambda device: ["cpu", "cpu"])
    engine = _engine(cfg, "--int8", "--weight_bits", "8", "--seed", "3", batch=2)
    try:
        seeds = torch.Generator().manual_seed(3)
        torch.randint(0, 2**62, (1,), generator=seeds)          # the warm-up's batch
        seed = int(torch.randint(0, 2**62, (1,), generator=seeds))
        specs = _concurrently(engine, ["a dog barks", "rain"])
        model = engine.model
        toks = torch.from_numpy(model.text_to_tokens(["a dog barks", "rain"])["token"])
        tokens = sample_tokens_int8_sharded(engine.qp, model.diffusion.schedule("cpu"),
                                            model.embed_condition(toks), seed=seed,
                                            devices=["cpu", "cpu"], truncation_r=0.85)
        want = port_generate.to_spec(model.decode_tokens(tokens)).numpy()
        np.testing.assert_array_equal(np.stack(specs), want)
    finally:
        engine.close()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        engine = _engine(cfg, "--int8", batch=3, wait_ms=1)
    try:
        assert any(issubclass(x.category, RuntimeWarning) and "does not divide" in str(x.message)
                   for x in w)
        assert engine.generate("rain").shape == (4, 16)
    finally:
        engine.close()


def test_bench_serve_runs(tiny, capsys):
    """``bench_serve.main`` over real HTTP on the CPU: its JSON line has the
    JAX tool's keys, every request answered."""
    cfg, _ = tiny
    assert bench_serve.main(["--config_file", cfg, "--no-int8", "--sample_type", "top0.85r",
                             "--batch", "2", "--max_wait_ms", "5", "--clients", "3",
                             "--requests", "6", "--port", "0", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"mode", "sample_type", "batch", "clients", "requests", "ok", "errors",
                        "wall_s", "clips_per_sec", "p50_s", "p95_s"}
    assert out["ok"] == 6 and out["errors"] == 0 and out["mode"] == "bf16"


@pytest.mark.parametrize("tool", ["serve", "bench_serve"])
def test_tools_refuse_a_missing_card(tool, monkeypatch):
    """On the card by default: without one the tool raises before any work."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"text_to_sound_synthesis_torch.tools.{tool}")
    argv = ["--config_file", "none.yaml", "--ckpt", "random"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(argv if tool == "serve" else argv[:2])
