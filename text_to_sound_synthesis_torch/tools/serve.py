"""Text-to-sound HTTP serving daemon of the port.

    python -m text_to_sound_synthesis_torch.tools.serve \\
        --config_file configs/diffsound_audiocaps.yaml --ckpt diffsound_ckpt.pth \\
        --vocoder vocoder_logs/ --port 8900 [--int8 [--calibrate CAPTIONS_TXT]] \\
        [--batch 8] [--max_wait_ms 50] [--device cuda]

The port of ``tools/serve.py``: it loads the config and checkpoint once
(``generate.load_model``), warms the generate path, then micro-batches
concurrent requests. Callers block while the collector waits up to
``--max_wait_ms`` for up to ``--batch`` captions; one batch, padded with
``""`` to the one fixed batch size, serves them all. The engine is the model
in its config's compute dtype, or with ``--int8`` the int8 serving engine
(W4A8 by default; ``--calibrate`` bakes static activation scales from a
caption file). With more than one card and ``--batch`` a multiple of the
card count, ``--int8`` splits each batch across the cards
(``sample_tokens_int8_sharded``).

API (byte for byte the JAX server's):
  POST /generate   {"caption": "...", "format": "wav"|"mel"}
      -> audio/wav bytes (PCM_24), or application/octet-stream .npy for "mel"
      (one generator seeded --seed advances per dispatched batch; requests
      share a batch's draw)
  GET  /healthz    -> {"status": "ok", "batch": N, "served": count}
  429 when --queue_limit requests are pending, 503 when a request waits
  longer than --request_timeout_s, 500 when its batch failed.

Dispatch is pipelined on the card: the collector thread launches batch n on
one dedicated CUDA stream and queues a copy of its spectrogram into a pinned
host buffer behind an event; the fetcher thread waits on that event and
answers the callers, while the collector already launches batch n + 1. The
vocoder runs in each request's handler thread, at batch 1.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import queue
import sys
import threading
import time

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser(description="text-to-sound HTTP server (PyTorch port)")
    p.add_argument("--config_file", required=True)
    p.add_argument("--ckpt", required=True,
                   help="torch .pth / .ckpt / .pt (reference or Solver layout), or 'random'")
    p.add_argument("--vocoder", default=None, help="MelGAN logdir (args.yml + best_netG.pt)")
    p.add_argument("--griffin_lim", action="store_true")
    p.add_argument("--sample_type", default="top0.85r")
    p.add_argument("--int8", action="store_true", help="serve through the int8 engine")
    p.add_argument("--weight_bits", type=int, default=4, choices=[8, 4],
                   help="with --int8: weight storage width. 4 (default) = nibble-packed W4A8; "
                        "8 = plain int8")
    p.add_argument("--calibrate", default=None, metavar="CAPTIONS_TXT",
                   help="with --int8: calibrate static activation scales on these captions "
                        "(one per line) and serve the static-scale engine "
                        "(models/diffusion/calibrate.py)")
    p.add_argument("--batch", type=int, default=8,
                   help="max micro-batch (the one batch shape served)")
    p.add_argument("--max_wait_ms", type=int, default=50,
                   help="batcher linger before dispatching a partial batch")
    p.add_argument("--queue_limit", type=int, default=64,
                   help="max pending requests; beyond this POSTs get 429")
    p.add_argument("--request_timeout_s", type=float, default=120.0,
                   help="max seconds a request waits for its batch; 503 after")
    p.add_argument("--sample_rate", type=int, default=22050,
                   help="output WAV sample rate (the mel recipe's 22050)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


class Overloaded(Exception):
    """Request queue full — caller should back off (HTTP 429)."""


class DispatchTimeout(Exception):
    """Batch did not complete within --request_timeout_s (HTTP 503)."""


def serving_devices(device):
    """The devices a sharded int8 engine may split a batch over: every
    visible card for a CUDA ``device``, else ``device`` alone."""
    import torch

    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Engine:
    """Warm model + micro-batching dispatcher. Thread-safe."""

    def __init__(self, args):
        import torch

        from ..parallel.distributed import local_device
        from ..utils.config import load_yaml_config
        from .generate import load_model, make_vocoder

        self.args = args
        self.device = local_device(args.device)
        self.model = load_model(load_yaml_config(args.config_file), args.ckpt, args.seed,
                                self.device)
        self.vocoder = make_vocoder(args, self.device)

        model = self.model
        devices = [torch.device(d) for d in serving_devices(self.device)]
        ndev = len(devices)
        if args.int8 and ndev > 1 and args.batch % ndev != 0:
            import warnings

            warnings.warn(
                f"--batch {args.batch} does not divide the {ndev} available devices; serving on "
                f"ONE card and idling {ndev - 1}. Pick a batch size divisible by the device "
                "count for sharded serving.", RuntimeWarning, stacklevel=2)
        stream_devices, self.qp = [self.device], None
        if args.int8 and ndev > 1 and args.batch % ndev == 0:
            # data-parallel serving: each card samples its slice of the batch
            # (sample_tokens_int8_sharded: a seed folded from the batch's own)
            from ..models.diffsound import parse_sample_type
            from ..models.diffusion.int8_runtime import sample_tokens_int8_sharded

            head = args.sample_type.split(",")[0]
            if not (head.startswith("top") and head.endswith("r")):
                raise ValueError("int8 serving supports top-r sampling only, "
                                 f"got {args.sample_type!r}")
            r, _, skip, resample_q = parse_sample_type(args.sample_type)
            if resample_q:
                raise ValueError("int8 serving does not support q-resample")
            qp = self.qp = self._maybe_calibrate(
                model.quantize_for_serving(weight_bits=args.weight_bits))
            sched = model.diffusion.schedule(self.device)
            # the batches' seeds come from a host generator: a draw from a
            # card's generator would wait for the card
            seeds = torch.Generator().manual_seed(args.seed)
            print(f"[serve] int8 sharded over {ndev} devices", flush=True)

            def run(generator, toks):
                seed = int(torch.randint(0, 2**62, (1,), generator=seeds))
                tokens = sample_tokens_int8_sharded(qp, sched, model.embed_condition(toks),
                                                    seed=seed, devices=devices,
                                                    truncation_r=r, skip_step=skip)
                return model.decode_tokens(tokens)

            stream_devices = devices
        elif args.int8:
            model._int8_sample_type(args.sample_type)   # refused before the engine is built
            qp = self.qp = self._maybe_calibrate(
                model.quantize_for_serving(weight_bits=args.weight_bits))
            run = lambda g, toks: model.generate_int8(qp, g, toks,  # noqa: E731
                                                      sample_type=args.sample_type)
        else:
            run = lambda g, toks: model.generate(g, toks,  # noqa: E731
                                                 sample_type=args.sample_type)
        self.streams = {}
        # ONE stream a card for every batch: the int8 GEMM's stream-K
        # workspace is one a card and serves one stream at a time
        # (ops/int8_kernels.py::workspace)
        for d in stream_devices:
            if d.type == "cuda" and d not in self.streams:
                self.streams[d] = torch.cuda.Stream(d)
                self.streams[d].wait_stream(torch.cuda.current_stream(d))   # the weights' writes
        self._run = run
        # bounded: under sustained overload we reject (429) instead of
        # growing the backlog without bound
        self._q: "queue.Queue" = queue.Queue(maxsize=args.queue_limit)
        self.generator = torch.Generator(self.device).manual_seed(args.seed)
        self.served = 0
        self.timeline = []     # a dict a dispatched batch: its host-clock times
        self._warm()
        # pipelined dispatch: the collector only enqueues device work, the
        # fetcher waits for it — batch n's fetch overlaps batch n + 1's
        # launches and compute. Depth 2 bounds the batches in flight.
        self._fetch_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._threads = [threading.Thread(target=self._collector, daemon=True),
                         threading.Thread(target=self._fetcher, daemon=True)]
        for t in self._threads:
            t.start()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the collector and the fetcher once the requests queued before
        are answered."""
        self._q.put(None)
        for t in self._threads:
            t.join(timeout)

    def _maybe_calibrate(self, qp):
        """--calibrate: bake static activation scales from a caption file."""
        if not self.args.calibrate:
            return qp
        import torch

        with open(self.args.calibrate) as f:
            caps = [ln.strip() for ln in f if ln.strip()]
        if not caps:
            raise ValueError(f"no captions in {self.args.calibrate}")
        caps = [caps[i % len(caps)] for i in range(self.args.batch)]
        toks = self._tokens(caps)
        t0 = time.time()
        qp = self.model.calibrate_serving_engine(qp, self._calib_generator(), toks,
                                                 sample_type=self.args.sample_type)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        print(f"[serve] static calibration: {time.time() - t0:.1f}s "
              f"({len(set(caps))} captions)", flush=True)
        return qp

    def _calib_generator(self):
        import torch

        return torch.Generator(self.device).manual_seed(self.args.seed + 7777)

    def _tokens(self, caps):
        """Caption BPE ids on the device, copied from pinned memory: a copy
        from pageable memory would wait for the stream's earlier batch."""
        import torch

        ids = torch.from_numpy(self.model.text_to_tokens(caps)["token"])
        if self.device.type == "cuda":
            ids = ids.pin_memory()
        return ids.to(self.device, non_blocking=True)

    @contextlib.contextmanager
    def _on_device(self):
        """The collector's context: inference mode, the card as the current
        device and the engine's streams as the current streams. All three
        are thread-local, so the thread that launches enters them itself."""
        import torch

        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode())
            # the model's card last, so it is the current device in the block
            for d, s in sorted(self.streams.items(), key=lambda kv: kv[0] == self.device):
                stack.enter_context(torch.cuda.stream(s))
            if self.device.type == "cuda":
                stack.enter_context(torch.cuda.device(self.device))
            yield

    def _launch(self, caps):
        """Launch one batch -> (event or None, its spectrogram on the host):
        the host buffer is complete once the event has passed."""
        import torch

        from .generate import to_spec

        with self._on_device():
            spec = to_spec(self._run(self.generator, self._tokens(caps)))
            if self.device.type != "cuda":
                return None, spec
            # a fresh pinned buffer a batch: the callers keep views of it,
            # so no buffer is written again while one may still be read
            host = torch.empty(spec.shape, dtype=spec.dtype, pin_memory=True)
            host.copy_(spec, non_blocking=True)
            event = torch.cuda.Event(blocking=True)    # its waiter sleeps, off the CPU
            event.record(self.streams[self.device])
            return event, host

    def _warm(self):
        t0 = time.time()
        event, spec = self._launch(["warmup"] * self.args.batch)
        if event is not None:
            event.synchronize()
        print(f"[serve] warm-up: {time.time() - t0:.1f}s (batch {self.args.batch})", flush=True)

    def _collector(self):
        while True:
            first = self._q.get()           # block for the first request
            if first is None:               # close()
                self._fetch_q.put(None)
                return
            batch = [first]
            deadline = time.time() + self.args.max_wait_ms / 1000.0
            while len(batch) < self.args.batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    req = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if req is None:             # close(): serve this batch first
                    self._q.put(None)
                    break
                batch.append(req)
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — a bad batch must not kill the loop
                for _, done in batch:
                    done["error"] = repr(e)
                    done["event"].set()

    def _dispatch(self, batch):
        caps = [req["caption"] for req, _ in batch]
        # pad to the one batch shape served
        caps = caps + [""] * (self.args.batch - len(caps))
        times = {"dispatch_start": time.perf_counter(), "size": len(batch)}
        event, host = self._launch(caps)
        times["dispatch_end"] = time.perf_counter()
        self.timeline.append(times)
        self._fetch_q.put((batch, event, host, times))

    def _fetcher(self):
        while True:
            item = self._fetch_q.get()
            if item is None:                # close()
                return
            batch, event, host, times = item
            try:
                if event is not None:
                    event.synchronize()     # releases the GIL while the card works
                spec = host.numpy()
                times["fetch_end"] = time.perf_counter()
                for i, (req, done) in enumerate(batch):
                    done["spec"] = spec[i]
                    done["event"].set()
                self.served += len(batch)
            except Exception as e:  # noqa: BLE001 — a bad fetch must not kill the loop
                for _, done in batch:
                    done["error"] = repr(e)
                    done["event"].set()

    def generate(self, caption: str) -> np.ndarray:
        done = {"event": threading.Event()}
        try:
            self._q.put_nowait(({"caption": caption}, done))
        except queue.Full:
            raise Overloaded(
                f"request queue full ({self.args.queue_limit} pending)")
        if not done["event"].wait(timeout=self.args.request_timeout_s):
            # a wedged dispatch must not hang the handler thread forever
            raise DispatchTimeout(
                f"generation did not complete in {self.args.request_timeout_s}s")
        if "error" in done:
            raise RuntimeError(done["error"])
        return done["spec"]


def make_handler(engine):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *hargs):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "batch": engine.args.batch,
                                 "served": engine.served})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                caption = req.get("caption")
                if not caption or not isinstance(caption, str):
                    self._json(400, {"error": "missing 'caption'"})
                    return
                fmt = req.get("format", "wav" if engine.vocoder else "mel")
                if fmt not in ("wav", "mel"):
                    self._json(400, {"error": f"unknown format {fmt!r} "
                                              "(expected 'wav' or 'mel')"})
                    return
                if fmt == "wav" and engine.vocoder is None:
                    self._json(400, {"error": "format='wav' requested but the "
                                              "server has no vocoder (start "
                                              "with --vocoder or --griffin_lim)"})
                    return
                spec = engine.generate(caption)
                if fmt == "mel":
                    buf = io.BytesIO()
                    np.save(buf, spec.astype(np.float32))
                    body, ctype = buf.getvalue(), "application/octet-stream"
                else:
                    from ..utils.io import wav_bytes

                    wav = engine.vocoder(spec[None])[0]
                    body = wav_bytes(engine.args.sample_rate, wav, subtype="PCM_24")
                    ctype = "audio/wav"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Overloaded as e:
                self._json(429, {"error": str(e)})
            except DispatchTimeout as e:
                self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._json(500, {"error": repr(e)})

    return Handler


def make_server(engine, host: str, port: int):
    """A threading HTTP server of ``engine`` on (host, port); port 0 takes
    a free one (``server_address`` says which)."""
    from http.server import ThreadingHTTPServer

    class _Server(ThreadingHTTPServer):
        # the stdlib's accept backlog is 5: a 64-way burst of connects gets
        # connection resets before the handler ever runs
        request_queue_size = 256

    return _Server((host, port), make_handler(engine))


def main(argv=None) -> int:
    args = get_args(argv)
    engine = Engine(args)
    srv = make_server(engine, args.host, args.port)
    print(f"[serve] listening on http://{args.host}:{srv.server_address[1]} "
          f"(int8={args.int8}, vocoder={'yes' if engine.vocoder else 'mel-only'})",
          flush=True)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
