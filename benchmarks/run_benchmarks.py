#!/usr/bin/env python
"""Full benchmark suite: the five BASELINE.json configs on real hardware.

  1. MDCT analysis-synthesis round trip, 1 s mono 16 kHz sine, N=256
     (perfect-reconstruction check + throughput)
  2. Psychoacoustic masking threshold on a two-tone signal
  3. Full encode/decode of a 10 s mono 44.1 kHz clip with quantization
     (SNR-gated)
  4. Batched encode of a 1k-clip 44.1 kHz corpus (jit, sharded batch,
     includes host->device transfer)
  5. Stereo 48 kHz long-form streaming encode/decode, chunked overlap-add

Timing: best-of wall time; every timed region ends in a host readback of
its result, so the device work is complete. Multi-iteration regions chain
on-device via lax.scan over loop-variant data so nothing hoists.

Prints one JSON line per config, each naming the device it ran on. The
rows gate on quality (SNR, NMR, bitrate, lossless ratio), never on
throughput: no floor has been measured on the GPU yet.
Use --quick for small shapes (CI smoke).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE = {  # measured TF-CPU numbers from BASELINE.md
    "full_encode_decode": 92.0,  # audio-sec/sec
}

# Quality gates: a regression that moves bytes or audible quality fails
# its row whatever the speed.
GATES = {
    # lossless archival mode (config 6). Ratio nominals: music-ish 0.616
    # (0.569 at level 2, whose measured entropy floor on that workload is
    # 0.551 — DESIGN.md §22b), sine 0.033-0.051 (a pad-tail order
    # near-tie moves the deflate-raw payload; both sides of the tie are
    # inside the gate), noise 1.005, silence 0.0006.
    "lossless_music_ratio": 0.70,
    "lossless_music_lpc_ratio": 0.60,    # nominal 0.569; floor 0.551
    "lossless_sine_ratio": 0.06,
    "lossless_noise_ratio": 1.01,
    "lossless_silence_ratio": 0.01,
    "streaming_snr_floor": 26.0,         # quantized stereo nominal 28.41 dB
    "bf16_snr_floor": 17.2,              # dense-bf16 nominal 17.36 dB
    # noise-to-mask ratio, mean((err/threshold)^2) on the quantized path.
    # A psycho-model regression that moves noise above the masking
    # threshold at constant power blows this up while raw SNR stays put.
    # Measured nominals: 0.0213 (config 3, f32), 0.0217 (bf16), 0.0014
    # (streaming stereo sines); ceiling ~4x the batch nominals.
    "nmr_ceiling": 0.08,
    # .acz bitrate on the config-3 signal (two tones + 0.05 noise — only
    # ~40% zero codes, so run-length Rice wins just barely there; tonal
    # content compresses 2-6x better). Nominal 141.7 kbps auto-coded; a
    # quantizer or entropy-coder regression shows up here before SNR moves.
    "full_kbps_ceiling": 150.0,
    # .acs container bitrate on the config-5 stereo sines (tonal content;
    # raw run-length-Rice payloads, no deflate wrapper, per-chunk sidecar
    # resets). Measured nominal 43.3 kbps for the 48 kHz stereo pair.
    "streaming_kbps_ceiling": 48.0,
}


def nmr_quantized(codec, x, drown=0.0):
    """Mean squared noise-to-mask ratio of the quantized path (the metric
    of parallel/train.py's perceptual loss, used here as a quality gate
    that raw SNR cannot replace)."""
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu import quantize as _quantize

    @jax.jit
    def _nmr(c, x):
        spec = c.mdct.transform(x)
        tonality = c.psycho.tonality(spec)
        threshold = c.psycho.global_masking_threshold(spec, tonality, drown)
        codes, delta = _quantize.quantize(spec, threshold)
        err = _quantize.dequantize(
            codes, delta, dtype=c.mdct.compute_dtype
        ) - spec
        r = (err / threshold).astype(jnp.float32)
        return jnp.mean(r * r)

    return float(_nmr(codec, x))


def snr_db(x, y):
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    return 10 * np.log10((x**2).sum() / max(((x - y) ** 2).sum(), 1e-30))


def timed(fn, iters=3):
    """Best-of wall seconds of fn() (fn must end in a host readback of its
    result); the first call, which compiles, is not counted."""
    fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def config1_mdct_roundtrip(quick):
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.mdct import MDCT

    n = 256
    sr = 16000
    mdct = MDCT.create(n)
    t = np.arange(sr) / sr
    wave = (0.8 * np.sin(2 * np.pi * 880 * t)).astype(np.float32)
    wave = wave[: sr // n * n]
    batch = 4 if quick else 64
    x = jnp.asarray(np.tile(wave[None, :, None], (batch, 1, 1)))

    @jax.jit
    def rt_err(x):
        y = mdct.inverse_transform(mdct.transform(x))
        return jnp.max(jnp.abs(x - y[:, n:-n]))

    err = float(rt_err(x))

    def make_chain(length):
        # feedback through abs: the MDCT is linear and XLA's simplifier
        # can decouple a linear op on a scalar-scaled carry — the output
        # must drive the next input
        @jax.jit
        def chain(x0):
            def body(c, _):
                y = mdct.inverse_transform(mdct.transform(c))
                nxt = jnp.abs(y[:, n:-n]) * 0.4 + c * 0.4
                return nxt, jnp.float32(0)
            c, _ = jax.lax.scan(body, x0, None, length=length)
            return jnp.sum(jnp.abs(c))
        return lambda: float(chain(x))

    length = 2 if quick else 512
    dt = timed(make_chain(length)) / length
    audio_s = batch * wave.size / sr
    thr = audio_s / dt
    # Gate: PR error at the reference's own tolerance.
    ok = bool(err < 1e-5)
    return {
        "config": "mdct_roundtrip",
        "pr_max_abs_error": err,
        "throughput_audio_s_per_s": round(thr, 1),
        "pass": ok,
    }


def config2_psycho_twotone(quick):
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.mdct import MDCT
    from audiocodec_tpu.psycho import PsychoacousticModel

    sr, n = 44100, 1024
    mdct = MDCT.create(n)
    pa = PsychoacousticModel.create(sr, filter_bands_n=n, bark_bands_n=64)
    t = np.arange(sr) / sr
    wave = (
        0.5 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 3000 * t)
    ).astype(np.float32)
    wave = wave[: wave.size // n * n]
    x = jnp.asarray(wave[None, :, None])

    @jax.jit
    def threshold(x):
        spec = mdct.transform(x)
        return pa.global_masking_threshold(spec, pa.tonality(spec))

    thr = np.asarray(threshold(x))
    # masking sanity: at the 440 Hz masker's bin, the two-tone threshold
    # must sit far above the threshold-in-quiet at that same bin
    bin_440 = int(440 / (sr / 2) * n)
    thr_silence = np.asarray(threshold(jnp.zeros_like(x)))
    quiet_floor = float(thr_silence[0, 1:-1, bin_440, 0].mean())
    near_masker = float(thr[0, 1:-1, bin_440, 0].mean())
    def make_chain(length):
        @jax.jit
        def chain(x):
            def body(c, _):
                return c * 0.999, jnp.sum(threshold(c))
            _, s = jax.lax.scan(body, x, None, length=length)
            return jnp.sum(s)
        return lambda: float(chain(x))

    length = 2 if quick else 256
    dt = timed(make_chain(length)) / length
    return {
        "config": "psycho_twotone",
        "masker_to_floor_ratio": round(near_masker / quiet_floor, 1),
        "throughput_audio_s_per_s": round((wave.size / sr) / dt, 1),
        "pass": bool(near_masker > 10 * quiet_floor),
    }


def config3_full_encode_decode(quick):
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.codec import Codec

    sr, n = 44100, 1024
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64)
    dur = 2.0 if quick else 10.0
    t = np.arange(int(sr * dur)) / sr
    rng = np.random.default_rng(0)
    wave = (
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.3 * np.sin(2 * np.pi * 1320 * t)
        + 0.05 * rng.normal(size=t.size)
    ).astype(np.float32)
    wave = wave[: wave.size // n * n]
    batch = 2 if quick else 32
    x = jnp.asarray(np.tile(wave[None, :, None], (batch, 1, 1)))

    out = np.asarray(jax.jit(codec.round_trip_quantized)(x))[:, n:-n]
    snr = snr_db(np.asarray(x), out)

    def make_chain(length):
        @jax.jit
        def chain(c, x0):
            def body(acc, i):
                xi = x0 * (1.0 + 0.001 * i.astype(jnp.float32))
                return acc + jnp.sum(jnp.abs(c.round_trip_quantized(xi))), None
            acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(length))
            return acc
        return lambda: float(chain(codec, x))

    length = 2 if quick else 16
    dt = timed(make_chain(length)) / length
    audio_s = batch * wave.size / sr
    thr = audio_s / dt
    nmr = nmr_quantized(codec, x)

    # Bitrate of the actual .acz container on one clip: the coder choice
    # (rice vs run-length rice vs zlib) and the quantizer both land here.
    from audiocodec_tpu.io import bitstream

    codes, bark = jax.jit(codec.encode_bitstream)(x[:1])
    c0, b0 = np.asarray(codes), np.asarray(bark)
    dur = wave.size / sr
    pack_kw = dict(
        sample_rate=sr, filters_n=n, bark_bands_n=64,
        alpha=codec.psycho.alpha, window_type="vorbis",
        compute_dtype="float32",
    )
    size_auto = len(bitstream.pack(c0, b0, entropy="auto", **pack_kw))
    size_rice = len(bitstream.pack(c0, b0, entropy="rice", **pack_kw))
    size_zlib = len(bitstream.pack(c0, b0, entropy="zlib", **pack_kw))
    kbps = size_auto * 8 / dur / 1000

    # Gates: a real quality regression (>0.5 dB below the 18.96 dB
    # nominal), a psycho-model regression (NMR) or a bitrate regression
    # fails loudly. "auto" must also never pick a coder worse than the
    # alternatives it costs.
    ok = bool(snr > (15.0 if quick else 18.5))
    ok = ok and nmr < GATES["nmr_ceiling"]
    ok = ok and size_auto <= min(size_rice, size_zlib)
    if not quick:
        ok = ok and kbps <= GATES["full_kbps_ceiling"]
    return {
        "config": "full_encode_decode",
        "snr_db": float(round(snr, 2)),
        "nmr": float(round(nmr, 4)),
        "kbps": float(round(kbps, 1)),
        "kbps_rice": float(round(size_rice * 8 / dur / 1000, 1)),
        "kbps_zlib": float(round(size_zlib * 8 / dur / 1000, 1)),
        "throughput_audio_s_per_s": round(thr, 1),
        "vs_reference_cpu": round(thr / REFERENCE["full_encode_decode"], 1),
        "pass": ok,
    }


def config3b_full_encode_decode_bf16(quick):
    """The speed configuration: bfloat16 compute with native-bf16 DCT
    matmuls (f32 accumulation) — the reference offers a bf16 path too."""
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.codec import Codec

    sr, n = 44100, 1024
    codec = Codec.create(
        sr, filters_n=n, bark_bands_n=64,
        compute_dtype=jnp.bfloat16, fast_bf16=True,
        # the recommended bf16 deployment: dense one-GEMM formulation —
        # faster AND more accurate than the sparse bf16 fold (the folded
        # intermediate no longer rounds to bf16 before the matmul)
        dct_precision="default",
    )
    dur = 2.0 if quick else 10.0
    t = np.arange(int(sr * dur)) / sr
    rng = np.random.default_rng(0)
    wave = (
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.05 * rng.normal(size=t.size)
    ).astype(np.float32)
    wave = wave[: wave.size // n * n]
    batch = 2 if quick else 32
    x = jnp.asarray(
        np.tile(wave[None, :, None], (batch, 1, 1)), dtype=jnp.bfloat16
    )

    out = np.asarray(
        jax.jit(codec.round_trip_quantized)(x).astype(jnp.float32)
    )[:, n:-n]
    snr = snr_db(np.asarray(x.astype(jnp.float32)), out)

    def make_chain(length):
        @jax.jit
        def chain(c, x0):
            def body(acc, i):
                xi = x0 * (1.0 + 0.001 * i.astype(jnp.bfloat16))
                out = c.round_trip_quantized(xi)
                return acc + jnp.sum(jnp.abs(out).astype(jnp.float32)), None
            acc, _ = jax.lax.scan(body, jnp.float32(0), jnp.arange(length))
            return acc
        return lambda: float(chain(codec, x))

    length = 2 if quick else 16
    dt = timed(make_chain(length)) / length
    audio_s = batch * wave.size / sr
    thr = audio_s / dt
    nmr = nmr_quantized(codec, x)
    return {
        "config": "full_encode_decode_bf16",
        "snr_db": float(round(snr, 2)),
        "snr_signal": "sine(440)+noise 10s B=32 N=1024 (not bench.py's)",
        "nmr": float(round(nmr, 4)),
        "throughput_audio_s_per_s": round(thr, 1),
        # the reference was only ever measured in f32 on CPU; no bf16
        # reference number exists, so label the denominator honestly
        "vs_reference_cpu_f32": round(
            thr / REFERENCE["full_encode_decode"], 1
        ),
        # NOTE this 10 s sine+noise signal is config 3's, NOT bench.py's
        # two-tone+noise headline signal — which is why this row's bf16
        # SNR (nominal 17.36 dB) differs from BENCH's 18.98 dB; both are
        # correct for their own workloads. Quick mode runs a shorter
        # signal so only the catastrophic gate applies there.
        "pass": bool(
            snr > (10.0 if quick else GATES["bf16_snr_floor"])
            and nmr < GATES["nmr_ceiling"]
        ),
    }


def config4_corpus(quick):
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.parallel import make_corpus_encoder, make_mesh

    sr, n = 44100, 1024
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64)
    clips_n = 32 if quick else 1024
    dur = 2.0 if quick else 10.0
    samples = int(sr * dur) // n * n
    batch = 8 if quick else 64

    mesh = make_mesh()
    encoder = make_corpus_encoder(codec, mesh, quantized=True)

    rng = np.random.default_rng(0)
    base = rng.uniform(-0.6, 0.6, (batch, samples, 1)).astype(np.float32)

    from audiocodec_tpu.parallel import waveform_sharding

    wsh = waveform_sharding(mesh)

    # NOTE every ingest loop stages batches with an EXPLICIT
    # jax.device_put (what the production loaders do) before invoking the
    # jitted encoder.
    def run_corpus():
        # fresh host batch every step: includes H2D transfer like a real
        # ingestion pipeline
        for start in range(0, clips_n, batch):
            hb = base * np.float32(1.0 - 0.3 * (start / max(clips_n, 1)))
            codes, delta = encoder(jax.device_put(hb, wsh))
        # single readback at the end drains the pipeline
        return float(jnp.sum(jnp.abs(delta)))

    dt_ingest = timed(run_corpus, iters=2)

    # int16 wire (parallel/pipeline.py wire_dtype): half the H2D bytes,
    # dequantized to float on-device inside the encode program. Same
    # methodology as the float baseline — fresh loop-variant host batch
    # each step (including the host-side int16 conversion, a real wire
    # cost) through the same mesh-sharded encoder.
    import functools

    @functools.partial(jax.jit, in_shardings=(waveform_sharding(mesh),))
    def encode_i16(b):
        x = b.astype(jnp.float32) * (1.0 / 32768.0)
        return codec.encode_quantized(x)[:2]

    def run_corpus_i16():
        for start in range(0, clips_n, batch):
            hb = base * np.float32(1.0 - 0.3 * (start / max(clips_n, 1)))
            hb16 = np.clip(np.rint(hb * 32768.0), -32768, 32767).astype(
                np.int16
            )
            codes, delta = encode_i16(jax.device_put(hb16, wsh))
        return float(jnp.sum(jnp.abs(delta)))

    dt_ingest_i16 = timed(run_corpus_i16, iters=2)

    # cached-PCM ingest (parallel/pipeline.build_corpus_cache): repeat
    # epochs read page-cached int16 straight off a memmap — no WAV parse,
    # no float round trip, no host conversion; only memmap read + H2D +
    # encode remain. This is the epoch>=2 production ingest path.
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".npy", delete=False) as tf:
        cache_file = tf.name
    all16 = np.clip(np.rint(base * 32768.0), -32768, 32767).astype(np.int16)
    cache_arr = np.lib.format.open_memmap(
        cache_file, mode="w+", dtype=np.int16,
        shape=(clips_n, samples, 1),
    )
    for start in range(0, clips_n, batch):
        cache_arr[start : start + batch] = all16
    cache_arr.flush()
    del cache_arr

    # meta sidecar so CachedCorpusLoader (the production epoch>=2 path,
    # with its prefetch thread overlapping staging and encode) can drive
    # the measurement
    np.savez(
        cache_file + ".meta.npz",
        status=np.zeros(clips_n, dtype=np.int32),
        sample_rate=np.asarray([sr], dtype=np.int64),
        clip_seconds=np.asarray([samples / sr], dtype=np.float64),
    )
    from audiocodec_tpu.parallel.pipeline import CachedCorpusLoader

    def run_corpus_cached():
        loader = CachedCorpusLoader(
            cache_file, batch_size=batch, prefetch=2, sharding=wsh
        )
        for dev, status in loader:
            codes, delta = encode_i16(dev)
        return float(jnp.sum(jnp.abs(delta)))

    dt_ingest_cached = timed(run_corpus_cached, iters=2)

    # transport ceiling: a bare staged device_put of one int16 batch,
    # measured in the same process state as the ingest loops. When this
    # ceiling sits at/near the end-to-end ingest numbers, ingest is
    # transport-bound — the software path (C++ direct decode, PCM cache,
    # contiguous staging, explicit puts) is not the limiter.
    one = np.ascontiguousarray(np.load(cache_file, mmap_mode="r")[:batch])

    def _staged_put():
        return jax.block_until_ready(jax.device_put(one, wsh))

    t_put = timed(_staged_put, iters=3)
    put_ceiling = (batch * samples / sr) / t_put
    os.unlink(cache_file)
    os.unlink(cache_file + ".meta.npz")

    # device-resident throughput: batches pre-staged, scan-chained
    steps = clips_n // batch
    xs = jnp.asarray(
        np.stack(
            [base * np.float32(1.0 - 0.2 * i / steps) for i in range(min(steps, 8))]
        )
    )

    @jax.jit
    def chain(c, xs):
        def body(acc, xi):
            codes, delta, _ = c.encode_quantized(xi)
            return acc + jnp.sum(jnp.abs(delta)), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), xs)
        return acc

    dt_dev = timed(lambda: float(chain(codec, xs))) / xs.shape[0] * steps
    audio_s = clips_n * samples / sr
    thr_dev = audio_s / dt_dev
    thr_i16 = audio_s / dt_ingest_i16
    thr_cached = audio_s / dt_ingest_cached
    ok = True  # informational row: no GPU floor measured yet
    return {
        "config": "corpus_batched_encode",
        "clips": clips_n,
        "throughput_audio_s_per_s": round(thr_dev, 1),
        # end-to-end (ingest-bound) numbers, honest next to the device
        # number: f32 wire / int16 wire / cached-PCM memmap (epoch >= 2)
        "ingest_bound_audio_s_per_s": round(audio_s / dt_ingest, 1),
        "ingest_int16_wire_audio_s_per_s": round(thr_i16, 1),
        "ingest_cached_pcm_audio_s_per_s": round(thr_cached, 1),
        "ingest_put_ceiling_audio_s_per_s": round(put_ceiling, 1),
        "pass": ok,
    }


def config5_streaming(quick):
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu import streaming
    from audiocodec_tpu.codec import Codec

    sr, n = 48000, 1024
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64)
    minutes = 0.05 if quick else 60.0
    chunk_blocks = 32 if quick else 256
    total_blocks = int(minutes * 60 * sr) // n
    total_blocks -= total_blocks % chunk_blocks
    samples = total_blocks * n

    rng = np.random.default_rng(0)
    t = np.arange(samples) / sr
    wave = np.stack(
        [
            0.4 * np.sin(2 * np.pi * 440 * t),
            0.4 * np.sin(2 * np.pi * 554 * t),
        ],
        axis=-1,
    ).astype(np.float32)
    x = jnp.asarray(wave[None])

    stream_rt = jax.jit(
        lambda c, x: jnp.sum(
            jnp.abs(streaming.streaming_round_trip(c, x, chunk_blocks))
        )
    )
    dt = timed(lambda: float(stream_rt(codec, x)), iters=2)
    # production-precision variant: the streaming steps follow the dense
    # one-GEMM formulation at dct_precision="default"
    codec_d = Codec.create(
        sr, filters_n=n, bark_bands_n=64, dct_precision="default"
    )
    dt_d = timed(lambda: float(stream_rt(codec_d, x)), iters=2)
    audio_s = samples / sr
    thr = audio_s / dt
    thr_d = audio_s / dt_d

    # Quality gates on a short prefix of the SAME stereo signal through
    # the SAME chunked path (deterministic quantized streaming): SNR for
    # gross regressions, NMR for psycho-model regressions SNR cannot see.
    n_head = max(1, min(4, total_blocks // chunk_blocks))
    head = x[:, : n_head * chunk_blocks * n]
    out = np.asarray(
        jax.jit(
            lambda c, x: streaming.streaming_round_trip(c, x, chunk_blocks)
        )(codec, head)
    )[:, n:-n]
    snr = snr_db(np.asarray(head), out)
    nmr = nmr_quantized(codec, head)

    # Actual .acs container bitrate on the head — stereo sines are the
    # run-length coder's best case (>99% zero codes) and a regression in
    # either quantizer or entropy coder shows up here first.
    import os
    import tempfile

    from audiocodec_tpu.io import stream_container as sc

    with tempfile.TemporaryDirectory() as td:
        acs = os.path.join(td, "bench.acs")
        sc.encode_stream(codec, head, acs, chunk_blocks=chunk_blocks)
        acs_bytes = os.path.getsize(acs)
    head_s = head.shape[1] / sr
    kbps = acs_bytes * 8 / head_s / 1000

    ok = bool(snr > GATES["streaming_snr_floor"] and nmr < GATES["nmr_ceiling"])
    if not quick:
        ok = ok and bool(kbps <= GATES["streaming_kbps_ceiling"])
    return {
        "config": "streaming_longform",
        "audio_minutes": round(audio_s / 60, 2),
        "channels": 2,
        "snr_db": float(round(snr, 2)),
        "nmr": float(round(nmr, 4)),
        "acs_kbps": float(round(kbps, 1)),
        "throughput_audio_s_per_s": round(thr, 1),
        "realtime_factor": round(thr, 1),
        "default_precision_audio_s_per_s": round(thr_d, 1),
        "pass": ok,
    }


def config6_lossless(quick):
    """Lossless archival mode: exactness is a hard gate and the per-class
    compression ratios catch coder/selector regressions; throughput is
    reported. The mode is entropy-coder-bound (its device work is five
    shifted subtractions), so it runs pinned to the CPU backend."""
    import jax

    from audiocodec_tpu import lossless

    cpu = jax.local_devices(backend="cpu")[0]
    rng = np.random.default_rng(0)
    secs = 2 if quick else 30
    sr = 44100
    t = np.arange(sr * secs) / sr
    l = (12000 * np.sin(2 * np.pi * 440 * t)
         + rng.normal(0, 120, t.size)).astype(np.int32)
    music = np.stack([l, (l * 0.9 + rng.normal(0, 90, t.size)).astype(np.int32)],
                     axis=1)
    sine = (20000 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)
            ).astype(np.int32)[:, None]
    noise = rng.integers(-32768, 32767, size=(sr, 2), dtype=np.int16)
    silence = np.zeros((sr * 5, 2), dtype=np.int16)

    ratios = {}
    exact = True
    with jax.default_device(cpu):
        for name, x in [("music", music), ("sine", sine),
                        ("noise", noise), ("silence", silence)]:
            blob = lossless.encode_lossless(np.asarray(x, np.int32), sr)
            y, _, _ = lossless.decode_lossless(blob)
            exact = exact and bool(
                np.array_equal(np.asarray(x, np.int32), y)
            )
            ratios[name] = round(len(blob) / (x.size * 2), 4)

        blob = lossless.encode_lossless(music, sr)  # warm jit for shape
        enc_dt = timed(lambda: len(lossless.encode_lossless(music, sr)),
                       iters=2)
        dec_dt = timed(lambda: int(lossless.decode_lossless(blob)[0][0, 0]),
                       iters=2)
        # level-2 (quantized LPC) tier: exactness is the same hard gate;
        # the ratio gate is RELATIVE — the tier must actually beat the
        # fixed ladder on predictable content, else its margin logic
        # regressed. Throughput is informational (the tier is the
        # opt-in "max" mode; FLAC -8 is slow on purpose too).
        blob2 = lossless.encode_lossless(music, sr, level=2)
        y2, _, _ = lossless.decode_lossless(blob2)
        exact = exact and bool(np.array_equal(np.asarray(music, np.int32), y2))
        ratio_l2 = len(blob2) / (music.size * 2)
        enc2_dt = timed(
            lambda: len(lossless.encode_lossless(music, sr, level=2)),
            iters=2,
        )
        dec2_dt = timed(lambda: int(lossless.decode_lossless(blob2)[0][0, 0]),
                        iters=2)
    enc_thr = secs / enc_dt
    dec_thr = secs / dec_dt
    enc2_thr = secs / enc2_dt
    dec2_thr = secs / dec2_dt

    ok = exact and bool(
        ratios["music"] <= GATES["lossless_music_ratio"]
        and ratios["sine"] <= GATES["lossless_sine_ratio"]
        and ratios["noise"] <= GATES["lossless_noise_ratio"]
        and ratios["silence"] <= GATES["lossless_silence_ratio"]
        and ratio_l2 < ratios["music"]
        and ratio_l2 <= GATES["lossless_music_lpc_ratio"]
    )
    return {
        "config": "lossless_archival",
        "bit_exact": exact,
        "ratio": ratios,
        "ratio_music_lpc": round(ratio_l2, 4),
        "decode_audio_s_per_s": round(dec_thr, 1),
        "lpc_decode_audio_s_per_s": round(dec2_thr, 1),
        "throughput_audio_s_per_s": round(enc_thr, 1),
        "lpc_encode_audio_s_per_s": round(enc2_thr, 1),
        "pass": ok,
    }


CONFIGS = [
    config1_mdct_roundtrip,
    config2_psycho_twotone,
    config3_full_encode_decode,
    config3b_full_encode_decode_bf16,
    config4_corpus,
    config5_streaming,
    config6_lossless,
]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument(
        "--only", type=str, default="", help="comma-separated config indices"
    )
    args = parser.parse_args()

    import jax

    from audiocodec_tpu.utils import compile_cache

    compile_cache.enable()
    device = {"platform": jax.devices()[0].platform,
              "kind": jax.devices()[0].device_kind,
              "count": len(jax.devices())}
    only = {int(i) for i in args.only.split(",") if i}
    for i, cfg in enumerate(CONFIGS, start=1):
        if only and i not in only:
            continue
        res = cfg(args.quick)
        print(json.dumps({**res, "device": device}), flush=True)


if __name__ == "__main__":
    main()
