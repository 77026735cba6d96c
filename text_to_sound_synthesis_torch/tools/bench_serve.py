"""Serving throughput of the port: a burst of concurrent clients at a live
``serve.Engine`` over real HTTP, p50 / p95 latency and served clips/s.

    python -m text_to_sound_synthesis_torch.tools.bench_serve \\
        --config_file configs/diffsound_audiocaps.yaml --ckpt random --int8 --static \\
        --sample_type top0.85r,fast3 --batch 32 --clients 64 --requests 128 [--device cuda]

The port of ``tools/bench_serve.py``: the engine loads, calibrates with
``--static`` (on ``CAPTIONS``) and warms; one warm batch of ``--batch``
requests; then ``--requests`` requests, at most ``--clients`` in flight, each
a ``mel`` request for one of ``CAPTIONS``. Prints one JSON line with the JAX
tool's keys: {"mode", "sample_type", "batch", "clients", "requests", "ok",
"errors", "wall_s", "clips_per_sec", "p50_s", "p95_s"}, and the card's name
and power limit on stderr. Exits 1 when a request failed. Captions need the
CLIP BPE merge table (``$T2S_CLIP_BPE``). On the card unless ``--device
cpu``; without a card it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

CAPTIONS = [
    "a dog barks loudly in the distance",
    "rain falls steadily on a tin roof",
    "an engine revs and then idles",
    "birds chirp in the morning",
    "waves crash against the rocks",
    "a crowd applauds and cheers",
    "thunder rumbles during a storm",
    "a train passes blowing its horn",
]


def get_args(argv=None):
    p = argparse.ArgumentParser(description="serving throughput (PyTorch port)")
    p.add_argument("--config_file", default="configs/diffsound_audiocaps.yaml")
    p.add_argument("--ckpt", default="random")
    p.add_argument("--int8", action="store_true", default=True)
    p.add_argument("--no-int8", dest="int8", action="store_false")
    p.add_argument("--weight_bits", type=int, default=4, choices=[8, 4])
    p.add_argument("--static", action="store_true",
                   help="calibrate static activation scales first")
    p.add_argument("--sample_type", default="top0.85r,fast3")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--max_wait_ms", type=int, default=100)
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--requests", type=int, default=128)
    p.add_argument("--port", type=int, default=8931, help="0 takes a free port")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def post_mel(host: str, port: int, caption: str, timeout: float = 300.0):
    """One ``mel`` request -> (ok, seconds, status): ok for a 200 with a
    body (an .npy of a spectrogram)."""
    import http.client

    t0 = time.time()
    status, data = None, b""
    try:
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        conn.request("POST", "/generate", json.dumps({"caption": caption, "format": "mel"}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        status = resp.status
        conn.close()
    except OSError:
        pass
    return status == 200 and len(data) > 128, time.time() - t0, status


def burst(host: str, port: int, n: int, clients: int):
    """``n`` requests, at most ``clients`` in flight -> ([(ok, seconds,
    status)], wall seconds)."""
    results: list = []
    sem = threading.Semaphore(clients)

    def worker(i):
        with sem:
            results.append(post_mel(host, port, CAPTIONS[i % len(CAPTIONS)]))

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    t0 = time.time()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return results, time.time() - t0


def main(argv=None) -> int:
    args = get_args(argv)
    from . import card_line
    from . import serve as serve_mod

    calib = None
    if args.static:
        calib = tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False)
        calib.write("\n".join(CAPTIONS) + "\n")
        calib.close()
    srv_argv = ["--config_file", args.config_file, "--ckpt", args.ckpt,
                "--sample_type", args.sample_type, "--batch", str(args.batch),
                "--max_wait_ms", str(args.max_wait_ms),
                "--queue_limit", str(max(256, 4 * args.clients)),
                "--weight_bits", str(args.weight_bits), "--port", str(args.port),
                "--device", args.device]
    if args.int8:
        srv_argv.append("--int8")
    if calib:
        srv_argv += ["--calibrate", calib.name]
    try:
        sargs = serve_mod.get_args(srv_argv)
        engine = serve_mod.Engine(sargs)          # loads, calibrates, warms
    finally:
        if calib:
            os.unlink(calib.name)
    if engine.device.type == "cuda":
        print(card_line(), file=sys.stderr)
    srv = serve_mod.make_server(engine, sargs.host, args.port)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        # warm probe: one full batch, so the served batch shape runs once more
        warm, wall = burst(sargs.host, port, args.batch, args.batch)
        print(f"warm batch: {wall:.1f}s ({sum(ok for ok, _, _ in warm)}/{len(warm)} ok)",
              file=sys.stderr)
        results, wall = burst(sargs.host, port, args.requests, args.clients)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
    lats = sorted(s for ok, s, _ in results if ok)
    n_ok = len(lats)
    out = {
        "mode": f"{'int8' if args.int8 else 'bf16'}"
                f"{'_w4' if args.int8 and args.weight_bits == 4 else ''}"
                f"{'_static' if args.static else ''}",
        "sample_type": args.sample_type,
        "batch": args.batch,
        "clients": args.clients,
        "requests": args.requests,
        "ok": n_ok,
        "errors": len(results) - n_ok,
        "wall_s": round(wall, 2),
        "clips_per_sec": round(n_ok / wall, 2) if wall > 0 else None,
        "p50_s": round(lats[n_ok // 2], 2) if n_ok else None,
        "p95_s": round(lats[min(n_ok - 1, int(n_ok * 0.95))], 2) if n_ok else None,
    }
    print(json.dumps(out))
    return 0 if out["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
