#!/usr/bin/env python
"""Paired end-to-end timing of the dense MDCT form against its earlier one.

At the one-pass tiers the MDCT is ``y[t] = x[t] @ cur + x[t-1] @ prev``.
The codec computes it as ONE GEMM against ``[cur | prev]`` and a shifted
add (ops/dct.two_tap, the "one_gemm" form). The earlier form ("two_matmul")
built two zero-padded copies of the frames, ran two GEMMs and added their
rounded results. This script swaps the earlier form back in for
``ops.dct.two_tap`` (which mdct.py calls through the module) and times
jit(round_trip_quantized) at B=32 x 10 s mono, 44.1 kHz, N=1024,
alternating the two forms pair by pair in one process (A B, B A, ...),
each reading the median of several calls.

    python benchmarks/dense_form_ab.py [--pairs 12] [--reps 15]

Prints one JSON line per tier (f32-default, bf16-fast, int8) with both
medians, the pairs each form won, and the card with its power limit.
Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def two_matmul(xb, mat2, *, fast_bf16=False, precision="highest"):
    """The earlier dense form: x[t] @ cur and x[t-1] @ prev from two
    zero-padded frame copies, each product rounded, then added."""
    import jax.numpy as jnp

    from audiocodec_tpu.ops import dct

    n = mat2.shape[-1] // 2
    zero = jnp.zeros_like(xb[..., :1, :])
    kw = dict(fast_bf16=fast_bf16, precision=precision)
    return (dct.dct4(jnp.concatenate([xb, zero], axis=-2), mat2[:, :n], **kw)
            + dct.dct4(jnp.concatenate([zero, xb], axis=-2), mat2[:, n:],
                       **kw))


def median_ms(fn, codec, x, reps: int) -> float:
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(codec, x))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        card = ""
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.ops import dct
    from audiocodec_tpu.utils import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" or not card:
        print("dense_form_ab: JAX found no GPU", file=sys.stderr)
        return 2
    compile_cache.enable()
    sr, n, batch = 44100, 1024, 32
    samples = 430 * n
    rng = np.random.default_rng(0)
    t = np.arange(samples) / sr
    base = (0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.3 * np.sin(2 * np.pi * 1320 * t)
            + 0.05 * rng.normal(size=samples)).astype(np.float32)
    wave = base[None, :, None] * rng.uniform(
        0.5, 1.0, (batch, 1, 1)).astype(np.float32)
    common = dict(sample_rate=sr, filters_n=n, bark_bands_n=64)
    tiers = {
        "f32-default": Codec.create(**common, dct_precision="default"),
        "bf16-fast": Codec.create(
            **common, compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="default", bark_precision="default"),
        "int8": Codec.create(
            **common, compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="int8", bark_precision="default"),
    }
    one_gemm = dct.two_tap
    forms = {"one_gemm": one_gemm, "two_matmul": two_matmul}
    for name, codec in tiers.items():
        x = jax.device_put(jnp.asarray(wave, codec.mdct.compute_dtype))
        fns = {}
        for form, impl in forms.items():
            # each form gets its own jit, traced (and compiled) while
            # dct.two_tap is that form
            dct.two_tap = impl
            fns[form] = jax.jit(lambda c, v: c.round_trip_quantized(v))
            jax.block_until_ready(fns[form](codec, x))
        dct.two_tap = one_gemm
        for fn in fns.values():  # warm both before the first pair
            median_ms(fn, codec, x, args.reps)
        ms = {form: [] for form in forms}
        for i in range(args.pairs):
            order = list(forms) if i % 2 == 0 else list(forms)[::-1]
            for form in order:
                ms[form].append(median_ms(fns[form], codec, x, args.reps))
        won = sum(a < b for a, b in zip(ms["one_gemm"], ms["two_matmul"]))
        print(json.dumps({
            "tier": name,
            "one_gemm_median_ms": round(statistics.median(ms["one_gemm"]), 4),
            "two_matmul_median_ms": round(
                statistics.median(ms["two_matmul"]), 4),
            "one_gemm_pairs_won": f"{won}/{args.pairs}",
            "reps_per_reading": args.reps,
            "card": card, "device": dev.device_kind,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
