#!/usr/bin/env python
"""Headline benchmark: quantized encode/decode throughput on one GPU.

Workload (BASELINE.md config 3): 10 s mono 44.1 kHz clips, filters_n=1024,
bark_bands_n=64, B=32 per call, one jit program — MDCT -> tonality ->
masking threshold -> quantize -> dequantize -> inverse MDCT
(round_trip_quantized) at dct_precision="default". Three deployments are
measured: float32, bfloat16 fast, and bfloat16 fast with the int8
transform; each line carries its quantized SNR. dct_precision is not
bitstream-critical (step sizes derive from the transmitted sidecar on
both ends).

Timing: best of several calls, each ending in block_until_ready; the
first call (compilation) is not counted. The script fails when JAX finds
no GPU: a CPU number is not a device number.

Reference baseline: TF 2.21 on 1 CPU core measures ~92 audio-seconds/sec
on its full lossy-encode chain — MDCT -> threshold -> NOISE INJECTION ->
inverse (BASELINE.md; the reference has no quantizer, so noise injection
IS its encode). vs_baseline therefore compares lossy-encode capability
for capability, not op for op.

Each line printed is one JSON object; the last one holds every config.
"""

import json
import sys

import numpy as np

BASELINE_AUDIO_SEC_PER_SEC = 92.0  # reference TF-CPU, measured (BASELINE.md)


def main():
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.utils import compile_cache, profiling

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX found no GPU (platform {dev.platform})",
              file=sys.stderr)
        return 2
    compile_cache.enable()

    sample_rate, duration_s, filters_n, batch = 44100, 10.0, 1024, 32
    samples = int(sample_rate * duration_s) // filters_n * filters_n
    rng = np.random.default_rng(0)
    t = np.arange(samples) / sample_rate
    base = (
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.3 * np.sin(2 * np.pi * 1320 * t)
        + 0.05 * rng.normal(size=samples)
    ).astype(np.float32)
    scales = rng.uniform(0.5, 1.0, size=(batch, 1, 1)).astype(np.float32)
    wave = base[None, :, None] * scales

    common = dict(sample_rate=sample_rate, filters_n=filters_n,
                  bark_bands_n=64)
    configs = {
        "f32": Codec.create(**common, dct_precision="default"),
        "bf16": Codec.create(
            **common, compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="default", bark_precision="default"),
        "bf16_int8": Codec.create(
            **common, compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="int8", bark_precision="default"),
    }
    rtq = jax.jit(lambda c, x: c.round_trip_quantized(x))
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    results = {}
    for name, codec in configs.items():
        x = jax.device_put(jnp.asarray(wave, codec.mdct.compute_dtype))
        seconds = profiling.time_fn(rtq, codec, x, iters=10)
        out = np.asarray(rtq(codec, x).astype(jnp.float32),
                         dtype=np.float64)[:, filters_n:-filters_n]
        ref = np.asarray(x.astype(jnp.float32), dtype=np.float64)
        snr = 10 * np.log10((ref**2).sum() / ((ref - out) ** 2).sum())
        value = batch * duration_s / seconds
        results[name] = {
            "audio_sec_per_sec": round(value, 1),
            "ms_per_call": round(seconds * 1e3, 4),
            "snr_db": round(float(snr), 3),
            "vs_baseline": round(value / BASELINE_AUDIO_SEC_PER_SEC, 2),
        }
        print(json.dumps({"config": name, **results[name],
                          "device": device}), flush=True)
    print(json.dumps({
        "metric": "encode_pipeline_throughput",
        "unit": "audio-sec/sec",
        "workload": "round_trip_quantized B=32 x 10 s mono 44.1 kHz N=1024",
        "configs": results,
        "device": device,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
