#!/usr/bin/env python
"""Serving throughput: concurrent clients against the dynamic-batching
codec server (serve.py), measured end-to-end through the real socket
protocol — WAV bytes in, container bytes out.

  python benchmarks/serve_bench.py [--cpu] [--clients 8] [--requests 64]
                                   [--seconds 2.0] [--filters-n 1024]

Reports requests/s, encoded audio-seconds per wall second, and the
batching ratio (requests per device batch — the whole point of the
dynamic batcher). The first pass is a compile warmup and is excluded.

On a GPU machine run WITHOUT --cpu; quality is identical either way (the
quantizer is deterministic), only throughput changes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=64,
                    help="total requests per measured pass")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="clip length per request")
    ap.add_argument("--filters-n", type=int, default=1024)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--inflight-depth", type=int, default=2,
                    help="dispatched-but-unfinalized batch bound")
    ap.add_argument("--decode", action="store_true",
                    help="also measure the decode direction")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from audiocodec_tpu.utils import compile_cache

    compile_cache.enable()

    from audiocodec_tpu import serve
    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.io.wav import write_wav_bytes

    sr, n = 44100, args.filters_n
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64)

    rng = np.random.default_rng(0)
    samples = int(sr * args.seconds) // n * n
    clip_seconds = samples / sr
    # a handful of distinct clips so responses aren't trivially cached
    blobs = []
    for i in range(4):
        t = np.arange(samples) / sr
        x = (0.3 * np.sin(2 * np.pi * (330 + 110 * i) * t)
             + 0.03 * rng.standard_normal(samples)).astype(np.float32)
        blobs.append(write_wav_bytes(x[:, None], sr))

    with serve.CodecServer(
        codec, sr, port=0, max_batch=args.max_batch, max_wait_ms=3.0,
        min_blocks=8, inflight_depth=args.inflight_depth,
    ) as server:

        def run_pass(measure_decode=False):
            per_client = max(1, args.requests // args.clients)
            results = [None] * args.clients
            barrier = threading.Barrier(args.clients + 1)

            def worker(ci):
                with serve.Client(port=server.port) as c:
                    barrier.wait()
                    payloads = []
                    for k in range(per_client):
                        acz = c.encode(blobs[(ci + k) % len(blobs)])
                        payloads.append(acz)
                    if measure_decode:
                        for acz in payloads:
                            c.decode(acz)
                    results[ci] = len(payloads)

            threads = [
                threading.Thread(target=worker, args=(i,))
                for i in range(args.clients)
            ]
            for t in threads:
                t.start()
            barrier.wait()
            t0 = time.perf_counter()
            for t in threads:
                t.join()
            dt = time.perf_counter() - t0
            total = sum(r or 0 for r in results)
            return total, dt

        # warmup pass (compiles, connection setup) — must exercise
        # every direction the measured pass will
        run_pass(measure_decode=args.decode)
        with serve.Client(port=server.port) as c:
            stats0 = c.stats()
        total, dt = run_pass(measure_decode=args.decode)
        with serve.Client(port=server.port) as c:
            stats1 = c.stats()

        reqs = stats1["encode_requests"] - stats0["encode_requests"]
        batches = stats1["encode_batches"] - stats0["encode_batches"]
        row = {
            "backend": jax.default_backend(),
            "clients": args.clients,
            "requests": total,
            "clip_seconds": round(clip_seconds, 3),
            "wall_s": round(dt, 3),
            "requests_per_s": round(total / dt, 2),
            "audio_s_per_s": round(total * clip_seconds / dt, 1),
            "batching_ratio": round(reqs / max(batches, 1), 2),
            "inflight_depth": args.inflight_depth,
            "decode_included": bool(args.decode),
        }
        # request-cycle decomposition (cumulative stage seconds across
        # the measured pass; batch-loop stages serialize on one thread,
        # readback/pack overlap in the pool) — the term-by-term
        # attribution of the gap to the transport ceiling
        stages = {}
        for k in ("t_parse_s", "t_acquire_s", "t_dispatch_s",
                  "t_readback_s", "t_pack_s"):
            if k in stats1:
                stages[k] = round(stats1[k] - stats0.get(k, 0.0), 3)
        if stages:
            row["stage_s"] = stages
            loop_busy = sum(
                stages.get(k, 0.0)
                for k in ("t_parse_s", "t_acquire_s", "t_dispatch_s")
            )
            row["batch_loop_busy_frac"] = round(loop_busy / dt, 3)
        print(json.dumps(row))


if __name__ == "__main__":
    main()
