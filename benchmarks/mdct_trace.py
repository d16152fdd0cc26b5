#!/usr/bin/env python
"""Where the quantized round trip's device time goes, from a profiler trace.

For each precision tier (f32-highest, f32-default, bf16-fast, int8) at
B=32 x 10 s mono 44.1 kHz, N=1024, traces a few steady-state calls of
jit(round_trip_quantized) and splits the device time into GEMMs (cuBLAS
calls and Triton GEMM fusions), the non-GEMM kernels inside the MDCT's
named scopes (``mdct_transform``, ``mdct_inverse_transform``: transposes,
fold/unfold, the dense form's zero-pad concatenations) and the rest.

    python benchmarks/mdct_trace.py

XLA's command buffers (CUDA graphs) are turned off for this process so
that every kernel shows up in the trace under its HLO op; wall times from
this script therefore include per-kernel launch overhead and are not the
benchmark's. Prints one JSON line per tier, with the card and its power
limit. Fails without a GPU.
"""

from __future__ import annotations

import glob
import json
import os
import re
import subprocess
import sys
import tempfile

if "xla_gpu_enable_command_buffer" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_gpu_enable_command_buffer="
    ).strip()

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCOPES = ("mdct_transform", "mdct_inverse_transform")
_GEMM = re.compile(r"gemm|cublas|matmul| dot\(", re.IGNORECASE)
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")


def hlo_ops(hlo_text: str) -> dict:
    """HLO instruction name -> (is_gemm, op_name scope)."""
    ops = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            scope = re.search(r'op_name="([^"]*)"', m.group(2))
            # the op's own text, without the metadata (whose op_name can
            # name a matmul that an elementwise fusion merely consumes)
            body = re.sub(r"metadata=\{[^}]*\}", "", m.group(2))
            ops[m.group(1)] = (bool(_GEMM.search(body)),
                               scope.group(1) if scope else "")
    return ops


def split_trace(xplane_path: str, hlo: dict, calls: int) -> dict:
    """Device time per call: total, GEMM, non-GEMM inside SCOPES, and the
    largest ops, from the GPU planes of one xplane file."""
    import jax

    data = jax.profiler.ProfileData.from_file(xplane_path)
    total = gemm = scoped = 0
    per_op: dict = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op") or ev.name
                is_gemm, scope = hlo.get(op, (False, ""))
                dur = ev.duration_ns
                total += dur
                if is_gemm:
                    gemm += dur
                elif any(s in scope for s in SCOPES):
                    scoped += dur
                key = (op, is_gemm, next((s for s in SCOPES if s in scope),
                                         ""))
                per_op[key] = per_op.get(key, 0) + dur
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    ms = 1e6 * calls
    return {
        "device_ms": round(total / ms, 4),
        "gemm_ms": round(gemm / ms, 4),
        "mdct_non_gemm_ms": round(scoped / ms, 4),
        "mdct_non_gemm_share": round(scoped / max(total, 1), 4),
        "top_ops_ms": [[k[0][:48], k[1], k[2], round(v / ms, 4)]
                       for k, v in top],
    }


def main() -> int:
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.CalledProcessError):
        card = []
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.utils import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" or not card:
        print("mdct_trace: JAX found no GPU", file=sys.stderr)
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
        "f32-highest": Codec.create(**common),
        "f32-default": Codec.create(**common, dct_precision="default"),
        "bf16-fast": Codec.create(
            **common, compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="default", bark_precision="default"),
        "int8": Codec.create(
            **common, compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="int8", bark_precision="default"),
    }
    rtq = jax.jit(lambda c, x: c.round_trip_quantized(x))
    calls = 3
    for name, codec in tiers.items():
        x = jax.device_put(jnp.asarray(wave, codec.mdct.compute_dtype))
        hlo = hlo_ops(rtq.lower(codec, x).compile().as_text())
        jax.block_until_ready(rtq(codec, x))
        logdir = tempfile.mkdtemp(prefix="mdct_trace_")
        jax.profiler.start_trace(logdir)
        for _ in range(calls):
            jax.block_until_ready(rtq(codec, x))
        jax.profiler.stop_trace()
        path = glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                      "*.xplane.pb"))[0]
        print(json.dumps({"tier": name, **split_trace(path, hlo, calls),
                          "card": card[0], "device": dev.device_kind}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
