#!/usr/bin/env python
"""Run the codec's main path once on an NVIDIA GPU and check every result.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded phase only

Configuration: the reference's calibrated one, which is also the CLI
default — 44.1 kHz, filters_n=1024, bark_bands_n=64, stereo — with
signals made from fixed seeds. One process drives the card. The CPU
references run in the same process on ``jax.devices("cpu")``, and the CLI
is called in-process through ``audiocodec_tpu.__main__.main(argv)``.

Phases (one card), each gated against a reference:

* long_form  — 1 h of stereo 48 kHz through the CLI (encode
  --chunk-blocks 256, decode): decoded SNR and peak device memory.
* mdct       — 32 x 10 s stereo: round-trip SNR at "highest" and
  "default", forward transform (also the dense one-pass form at TF32 and
  bf16) against the float64 numpy reference.
* quantized  — round_trip_quantized at four tiers at B=32 x 10 s: SNR and
  codes against the CPU backend on two 2-clip slices, where the code
  differences come from (spectrum, step sizes), step time, and whether
  XLA lowered the int8 tier to an int8 GEMM.
* wire       — GPU encode -> pack -> CPU unpack: the decoder's step sizes
  bit-identical to the encoder's; for a TNS stream the number of
  differing step sizes is reported.
* served     — serve.CodecServer: 8 concurrent clients byte-identical to
  the offline composition, one live session byte-identical to
  encode_stream.
* lossless   — level 1 bit-exact round trip.
* training   — one parallel/train.py step against the CPU backend.
* gpu_lane   — ``pytest -m gpu`` (tests/test_gpu_hw.py) in-process.

``--multi`` (four cards): the corpus encoder at the f32-highest,
bf16-fast and int8 tiers on a dp=4 and a dp=2 x sp=2 mesh against the
single-device encode, and one sharded train step.

The first line printed is the card's name and power limit as nvidia-smi
gives them, and every later line carries them. The last line is one JSON
object with the device JAX reports. Without a GPU, or when any phase
fails, the script exits non-zero and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR, N, BARK = 44100, 1024, 64
CLIP_BLOCKS = 430  # 10 s at 44.1 kHz, whole MDCT blocks
BATCH = 32  # clips per call in the mdct and quantized phases
LONG_SECONDS = 3600
CARD = ""
FAILED: list[str] = []


def say(msg: str) -> None:
    print(f"{msg}  [{CARD}]", flush=True)


def gate(name: str, value, limit: str, ok: bool) -> None:
    """Print a measured value beside its tolerance; record a failure."""
    say(f"{name}: {value} (limit {limit}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        FAILED.append(name)


def run_phase(name: str, fn) -> None:
    t0 = time.perf_counter()
    say(f"== phase {name}")
    try:
        fn()
    except Exception:  # noqa: BLE001 — report the phase and go on
        traceback.print_exc()
        FAILED.append(name)
        say(f"phase {name}: ERROR")
    say(f"phase {name}: {time.perf_counter() - t0:.1f} s wall")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi listed no GPU")
    return out[0].strip()


def snr_db(ref, out) -> float:
    ref = np.asarray(ref, np.float64)
    err = ref - np.asarray(out, np.float64)
    return float(10 * np.log10((ref**2).sum() / max((err**2).sum(), 1e-30)))


def tones(batch, samples, channels, seed, sr=SR):
    """Two tones plus noise per channel, each clip at its own level (the
    benchmark's signal family)."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sr
    out = np.empty((batch, samples, channels), np.float32)
    for c in range(channels):
        base = (0.4 * np.sin(2 * np.pi * (440 + 110 * c) * t)
                + 0.3 * np.sin(2 * np.pi * (1320 + 55 * c) * t))
        noise = 0.05 * rng.standard_normal((batch, samples))
        scale = rng.uniform(0.5, 1.0, (batch, 1))
        out[:, :, c] = (scale * (base[None] + noise)).astype(np.float32)
    return out


def timed(fn, *args, reps: int = 5) -> float:
    """Best-of wall seconds of fn(*args) ending in block_until_ready
    (the first call, which compiles, is not counted)."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def cpu_device():
    import jax

    return jax.devices("cpu")[0]


def on_cpu(*trees):
    import jax

    out = jax.device_put(trees, cpu_device())
    return out if len(trees) > 1 else out[0]


# -- phases -------------------------------------------------------------------


def phase_long_form():
    import jax

    from audiocodec_tpu.__main__ import main as cli
    from audiocodec_tpu.io import wav

    sr, seconds = 48000, LONG_SECONDS
    tmp = tempfile.mkdtemp(prefix="smoke_long_")
    try:
        src = os.path.join(tmp, "hour.wav")
        acs = os.path.join(tmp, "hour.acs")
        dec = os.path.join(tmp, "hour_dec.wav")
        minute = sr * 60
        x = np.concatenate([
            tones(1, minute, 2, seed=100 + k, sr=sr)[0] * 0.8
            for k in range(seconds // 60)
        ])
        wav.write_wav(src, x, sr)
        del x
        t0 = time.perf_counter()
        rc = cli(["encode", src, acs, "--chunk-blocks", "256"])
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc2 = cli(["decode", acs, dec])
        t_dec = time.perf_counter() - t0
        gate("long_form_cli_rc", (rc, rc2), "(0, 0)", rc == 0 and rc2 == 0)
        ref, _ = wav.read_wav(src)
        out, _ = wav.read_wav(dec)
        same_len = out.shape == ref.shape
        gate("long_form_length", out.shape[1], f"== {ref.shape[1]}",
             same_len)
        snr = snr_db(ref[0], out[0, : ref.shape[1]]) if same_len else 0.0
        gate("long_form_snr_db", round(snr, 3), ">= 15", snr >= 15.0)
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", 0)
        say(f"long_form: {seconds} s stereo {sr} Hz, encode {t_enc:.1f} s "
            f"({seconds / t_enc:.1f} audio-s/s), decode {t_dec:.1f} s "
            f"({seconds / t_dec:.1f} audio-s/s), .acs "
            f"{os.path.getsize(acs)} bytes, peak device memory "
            f"{peak / 2**20:.1f} MiB")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mdct():
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.mdct import MDCT
    from audiocodec_tpu.ops import mdct_reference

    x = tones(BATCH, CLIP_BLOCKS * N, 2, seed=1)
    xd = jax.device_put(x)
    fwd = jax.jit(lambda m, v: m.transform(v))
    rt = jax.jit(lambda m, v: m.inverse_transform(m.transform(v)))
    m_hi = MDCT.create(N)
    y = np.asarray(fwd(m_hi, xd))
    ref = mdct_reference.forward(x, N, "vorbis")
    err = float(np.max(np.abs(y - ref)))
    gate("mdct_forward_vs_float64_max_abs", f"{err:.3e}", "<= 1e-5",
         err <= 1e-5)
    # the dense one-GEMM form (ops/dct.two_tap) at the one-pass tiers,
    # as XLA compiled it for the card, against the same float64 reference:
    # TF32 operands keep 10 mantissa bits and bf16 8, so each tier is
    # held to a few of its own roundings of the frame's peak
    for name, kw, limit in (
        ("default", dict(dct_precision="default"), 2e-3),
        ("bf16-fast", dict(compute_dtype=jnp.bfloat16, fast_bf16=True,
                           dct_precision="default"), 2e-2),
    ):
        m = MDCT.create(N, **kw)
        v = jax.device_put(jnp.asarray(x, m.compute_dtype))
        got = np.asarray(fwd(m, v).astype(jnp.float32), np.float64)
        rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        gate(f"mdct_forward_vs_float64_max_abs_over_peak_{name}",
             f"{rel:.3e}", f"<= {limit:g}", rel <= limit)
    # float32 itself bounds "highest": the CPU backend's round trip of
    # these signals reaches 123-126 dB and the H100's 120 dB, while TF32
    # would read ~67 dB — the gate sits between
    for prec, limit in (("highest", 115.0), ("default", 60.0)):
        m = MDCT.create(N, dct_precision=prec)
        out = np.asarray(rt(m, xd))[:, N:-N]
        snr = snr_db(x, out)
        m_c, x_c = on_cpu(m, x[:2])
        snr_c = snr_db(x[:2], np.asarray(rt(m_c, x_c))[:, N:-N])
        gate(f"mdct_round_trip_snr_db_{prec}",
             f"{snr:.3f} (cpu backend, 2 clips: {snr_c:.3f})",
             f">= {limit}", snr >= limit)
        t = timed(rt, m, xd)
        say(f"mdct round trip {prec}: {t * 1e3:.3f} ms per {BATCH} x "
            f"{CLIP_BLOCKS} blocks stereo "
            f"({BATCH * CLIP_BLOCKS * N / SR / t:.1f} audio-s/s)")


def _tiers():
    import jax.numpy as jnp

    from audiocodec_tpu.codec import Codec

    base = dict(sample_rate=SR, filters_n=N, bark_bands_n=BARK)
    return {
        "f32-highest": Codec.create(**base),
        "f32-default": Codec.create(**base, dct_precision="default"),
        "bf16-fast": Codec.create(
            **base, compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="default", bark_precision="default"),
        "int8": Codec.create(
            **base, compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="int8", bark_precision="default"),
    }


def _int8_gemm_report(hlo_text: str) -> tuple[bool, list[str]]:
    """Whether a dot of the compiled module (on a GPU, inside a Triton
    GEMM fusion or a cuBLAS call) multiplies s8 operands, and the lines
    that say so. Operand types are looked up within each computation."""
    types: dict = {}
    hits = []
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            types = {}  # a new computation: names are local to it
            for name, ty in re.findall(r"([\w.\-]+):\s*(\w+)\[", line):
                types[name] = ty
            continue
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\w+)\[", line)
        if m:
            types[m.group(1)] = m.group(2)
        d = re.search(r"\bdot\(([^)]*)\)", line)
        if d:
            ops = re.findall(r"%?([\w.\-]+)(?:,|$)", d.group(1).strip())
            if ops and all(types.get(o) == "s8" for o in ops):
                hits.append(line.strip())
    return bool(hits), hits[:2]


# Lowest share of codes that must agree with the CPU backend's, per tier
# and per clip pair, just below the readings on an H100 80GB HBM3 at 700 W
# (f32-default 0.99648-0.99649, bf16-fast 0.98878-0.98886, int8
# 0.98789-0.98801). At "highest" both backends compute float32. At the
# one-pass tiers the masking threshold's Bark contractions run at TF32 on
# the card (bark_precision="default"), so step sizes differ and codes near
# a rounding boundary move by one step: 81-95% of the flips sit at bins
# whose step size differs. At bf16 the rest come from the quantizer's own
# rounding (XLA may keep the spectrum's float32 sum where it fuses the
# division) and, at int8, from the frames' int8 rounding; the phase prints
# that attribution.
MIN_AGREE = {"f32-highest": 0.999, "f32-default": 0.995,
             "bf16-fast": 0.987, "int8": 0.986}


def _stages(codec, x):
    """Spectrum, step sizes and codes of encode_quantized, in one program."""
    codes, delta, _ = codec.encode_quantized(x)
    return codec.mdct.transform(x), delta, codes


def _bits_differ(a, b) -> np.ndarray:
    """Elementwise: float32 (or exactly widened bf16) bit patterns differ."""
    a = np.asarray(a).astype(np.float32)
    b = np.asarray(b).astype(np.float32)
    return a.view(np.uint32) != b.view(np.uint32)


def phase_quantized():
    import jax
    import jax.numpy as jnp

    x = tones(BATCH, CLIP_BLOCKS * N, 1, seed=2)
    rtq = jax.jit(lambda c, v: c.round_trip_quantized(v))
    enc = jax.jit(lambda c, v: c.encode_quantized(v)[0])
    stages = jax.jit(_stages)
    pairs = ((0, 2), (2, 4))  # two clip pairs: two readings per tier
    for name, codec in _tiers().items():
        dtype = codec.mdct.compute_dtype
        xd = jax.device_put(jnp.asarray(x, dtype))
        x4 = np.asarray(jnp.asarray(x[:4], dtype).astype(jnp.float32))
        out = np.asarray(rtq(codec, xd).astype(jnp.float32))[:4, N:-N]
        spec, delta, codes = (np.asarray(a)[:4] for a in stages(codec, xd))
        c_cpu, x_cpu = on_cpu(codec, jnp.asarray(x[:4], dtype))
        out_c = np.asarray(rtq(c_cpu, x_cpu).astype(jnp.float32))[:, N:-N]
        spec_c, delta_c, codes_c = (np.asarray(a)
                                    for a in stages(c_cpu, x_cpu))
        floor = MIN_AGREE[name]
        for lo, hi in pairs:
            snr_g = snr_db(x4[lo:hi], out[lo:hi])
            snr_c = snr_db(x4[lo:hi], out_c[lo:hi])
            gate(f"quantized_{name}_clips{lo}-{hi - 1}_snr_gpu_minus_cpu_db",
                 f"{snr_g - snr_c:+.4f} (gpu {snr_g:.3f}, cpu {snr_c:.3f})",
                 "|d| <= 0.1", abs(snr_g - snr_c) <= 0.1)
            d = codes[lo:hi].astype(np.int64) - codes_c[lo:hi]
            agree = float(np.mean(d == 0))
            dmax = int(np.max(np.abs(d)))
            gate(f"quantized_{name}_clips{lo}-{hi - 1}_codes_agree",
                 f"{agree:.6f} max|d| {dmax}", f">= {floor}, max|d| <= 1",
                 agree >= floor and dmax <= 1)
        # where the flips come from: spectrum, step sizes, and the
        # quantizer's own rounding (quantize.quantize at deadzone 0.5)
        # redone on the CPU from the card's spectrum and step sizes
        requant = np.asarray(jax.jit(
            lambda a, b: jnp.round(a / b).astype(jnp.int32))(
                *on_cpu(jnp.asarray(spec), jnp.asarray(delta))))
        s32, s32_c = spec.astype(np.float32), spec_c.astype(np.float32)
        s_diff = _bits_differ(s32, s32_c)
        s_max = float(np.max(np.abs(s32 - s32_c)) / np.max(np.abs(s32_c)))
        d_diff = _bits_differ(delta, delta_c)
        flips = codes != codes_c
        say(f"quantized {name} stages, gpu vs cpu on 4 clips: spectrum "
            f"values differing {s_diff.mean():.6f} (max |d|/peak "
            f"{s_max:.3e}), step sizes differing {d_diff.mean():.6f}, codes "
            f"differing {flips.mean():.6f}, of which at a differing step "
            f"size {float(np.mean(d_diff[flips])) if flips.any() else 0:.4f}"
            f"; the card's codes vs its spectrum and steps quantized on the "
            f"cpu differing {float(np.mean(requant != codes)):.6f}")
        t = timed(rtq, codec, xd)
        say(f"quantized {name}: {t * 1e3:.3f} ms per {BATCH} x "
            f"{CLIP_BLOCKS} blocks mono "
            f"({BATCH * CLIP_BLOCKS * N / SR / t:.1f} audio-s/s)")
        if name == "int8":
            used, lines = _int8_gemm_report(
                enc.lower(codec, xd).compile().as_text())
            say(f"int8: s8 x s8 GEMM in compiled HLO: {used}")
            for ln in lines:
                say(f"  hlo: {ln[:240]}")


def phase_wire():
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu import quantize
    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.io import bitstream
    from audiocodec_tpu.ops import dct

    x = jax.device_put(tones(4, CLIP_BLOCKS * N, 2, seed=3))

    @jax.jit
    def enc(c, v):
        """The encoder's own step sizes, from the program that quantizes
        (quantize_frames with no extra scale)."""
        spec, bark16, thr, _ = c.analyze_for_quantization(c.mdct.transform(v))
        codes, delta = quantize.quantize(spec, thr)
        return codes, bark16, delta

    steps = jax.jit(lambda c, b: quantize.step_size(
        c.psycho.bark_intensity_to_threshold(b.astype(c.mdct.compute_dtype))))
    expand = jax.jit(lambda c, b, prec: jnp.einsum(
        "nbic,ij->nbjc", b.astype(jnp.float32), c.psycho.W_inv,
        precision=prec), static_argnums=2)
    for bp in ("highest", "default"):
        codec = Codec.create(SR, filters_n=N, bark_bands_n=BARK,
                             dct_precision=bp, bark_precision=bp)
        codes, bark16, d_enc = enc(codec, x)
        blob = bitstream.pack(
            np.asarray(codes[:1]), np.asarray(bark16[:1]), sample_rate=SR,
            filters_n=N, bark_bands_n=BARK, alpha=codec.psycho.alpha,
            window_type=codec.mdct.window_type, compute_dtype="float32",
            bark_precision=bp, sidecar_grid=codec.sidecar_grid)
        codes_c, bark_c, meta = bitstream.unpack(blob)
        with jax.default_device(cpu_device()):
            dec = Codec.create(SR, filters_n=N, bark_bands_n=BARK,
                               bark_precision=meta["bark_precision"])
            d_cpu = np.asarray(steps(dec, jnp.asarray(bark_c)))
        d_enc = np.asarray(d_enc)[:1]
        diff = int(np.sum(d_enc.view(np.uint32) != d_cpu.view(np.uint32)))
        same_codes = np.array_equal(codes_c, np.asarray(codes[:1]))
        gate(f"wire_step_sizes_bits_differing_{bp}",
             f"{diff} of {d_cpu.size}", "== 0", diff == 0 and same_codes)
        # what the expansion alone would give at the wire precision,
        # without the HIGHEST pin
        prec = dct.PRECISIONS[bp]
        u_gpu = np.asarray(expand(codec, bark16, prec))[:1]
        u_cpu = np.asarray(expand(*on_cpu(codec, jnp.asarray(bark_c)), prec))
        n_u = int(np.sum(u_gpu.view(np.uint32) != u_cpu.view(np.uint32)))
        say(f"wire {bp}: the W_inv expansion at {bp} precision, unpinned, "
            f"differs GPU vs CPU in {n_u} of {u_cpu.size} values")
    # TNS streams also scale their step sizes by the transmitted
    # reflection indices (tns.scaled_threshold: sin, sqrt, pow). Reported,
    # not gated: the decoder's steps from the unpacked container, on each
    # backend, on a signal with attacks that make TNS fire.
    from audiocodec_tpu import tns

    c_t = Codec.create(SR, filters_n=N, bark_bands_n=BARK)
    xt = tones(2, CLIP_BLOCKS * N, 2, seed=8) * 0.5
    xt[:, :: SR // 4] += 0.45  # an attack every quarter second
    codes_t, bark_t, idx = jax.jit(lambda c, v: c.quantize_frames_tns(
        c.mdct.transform(v)))(c_t, jax.device_put(xt))
    blob = bitstream.pack(
        np.asarray(codes_t), np.asarray(bark_t), sample_rate=SR,
        filters_n=N, bark_bands_n=BARK, alpha=c_t.psycho.alpha,
        window_type=c_t.mdct.window_type, compute_dtype="float32",
        bark_precision=c_t.psycho.bark_precision,
        sidecar_grid=c_t.sidecar_grid, tns_idx=np.asarray(idx),
        tns_band_start=c_t.tns_band_start)
    _, bark_c, meta = bitstream.unpack(blob)
    tns_steps = jax.jit(lambda c, b, i: quantize.step_size(
        tns.scaled_threshold(c.psycho.bark_intensity_to_threshold(
            b.astype(c.mdct.compute_dtype)), i, meta["tns_band_start"])))
    d_gpu = np.asarray(tns_steps(c_t, bark_t, idx))
    d_cpu = np.asarray(tns_steps(*on_cpu(c_t, jnp.asarray(bark_c),
                                         jnp.asarray(meta["tns_idx"]))))
    fired = float(np.mean(np.any(np.asarray(idx) != 0, axis=2)))
    n_tns = int(np.sum(_bits_differ(d_gpu, d_cpu)))
    say(f"wire tns (not gated): step sizes differing GPU encoder vs CPU "
        f"decoder {n_tns} of {d_cpu.size}; TNS fired in {fired:.4f} of "
        "frame-channels")
    # the float32 square root on its own, GPU vs CPU, on the same input
    inten = np.asarray(expand(codec, bark16, jax.lax.Precision.HIGHEST))
    sq_gpu = np.asarray(jax.jit(jnp.sqrt)(inten))
    sq_cpu = np.asarray(jax.jit(jnp.sqrt)(on_cpu(inten)))
    n_sq = int(np.sum(sq_gpu.view(np.uint32) != sq_cpu.view(np.uint32)))
    say(f"wire: jnp.sqrt in float32 differs GPU vs CPU in {n_sq} of "
        f"{inten.size} values (the step-size path uses a correctly "
        "rounded root)")


def phase_served():
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu import native, serve
    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.io import bitstream
    from audiocodec_tpu.io import stream_container as sc
    from audiocodec_tpu.io.wav import read_wav_bytes, write_wav_bytes

    codec = Codec.create(SR, filters_n=N, bark_bands_n=BARK)
    clips = tones(8, CLIP_BLOCKS * N, 2, seed=4) * 0.8
    blobs = [write_wav_bytes(c, SR) for c in clips]
    results: dict = {}

    with serve.CodecServer(codec, SR, port=0, max_batch=8,
                           max_wait_ms=50.0) as server:
        def client(i):
            try:
                with serve.Client(port=server.port) as c:
                    acz = c.encode(blobs[i])
                    results[i] = (acz, c.decode(acz))
            except Exception as e:  # noqa: BLE001 — reported below
                results[i] = e

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        say(f"served: 8 clients x 10 s stereo encode+decode in {wall:.2f} s "
            f"(cold, compiles included), stats {server.stats}")

        enc = jax.jit(lambda c, v: c.quantize_frames(c.mdct.transform(v)))
        same = 0
        snrs = []
        for i in range(8):
            got = results.get(i)
            if not isinstance(got, tuple):
                say(f"served client {i}: {got!r}")
                continue
            wave, _ = read_wav_bytes(blobs[i])
            codes, bark = enc(codec, jnp.asarray(wave, jnp.float32))
            want = bitstream.pack(
                codes, bark, sample_rate=SR, filters_n=N,
                bark_bands_n=BARK, alpha=codec.psycho.alpha,
                window_type=codec.mdct.window_type,
                compute_dtype="float32", ms=False,
                bark_precision=codec.psycho.bark_precision,
                entropy="rrice" if native.available() else "zlib",
                sidecar_grid=codec.sidecar_grid,
                orig_samples=wave.shape[1])
            same += got[0] == want
            out, _ = read_wav_bytes(got[1])
            snrs.append(snr_db(wave, out[:, : wave.shape[1]]))
        gate("served_containers_byte_identical", f"{same}/8", "8/8",
             same == 8)
        gate("served_decoded_snr_db_min", round(min(snrs or [0.0]), 3),
             ">= 15", bool(snrs) and min(snrs) >= 15.0)

        # one live session: begin / chunk / finish
        chunk_blocks = 64
        x = clips[0][: (CLIP_BLOCKS // chunk_blocks) * chunk_blocks * N]
        step = chunk_blocks * N
        with serve.Client(port=server.port) as c:
            parts = [c.begin_stream(channels=2, chunk_blocks=chunk_blocks)]
            for k in range(0, x.shape[0], step):
                parts.append(c.feed(x[k: k + step]))
            parts.append(c.finish_stream())
    tmp = tempfile.mkdtemp(prefix="smoke_acs_")
    try:
        path = os.path.join(tmp, "offline.acs")
        sc.encode_stream(codec, jnp.asarray(x[None]), path,
                         chunk_blocks=chunk_blocks)
        with open(path, "rb") as f:
            offline = f.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gate("served_session_bytes_equal_encode_stream",
         b"".join(parts) == offline, "True", b"".join(parts) == offline)


def phase_lossless():
    from audiocodec_tpu import lossless

    x = np.round(tones(1, SR * 30, 2, seed=5)[0] * 20000).astype(np.int32)
    t0 = time.perf_counter()
    blob = lossless.encode_lossless(x, SR, bits=16, level=1)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    y, rate, bits = lossless.decode_lossless(blob)
    t_dec = time.perf_counter() - t0
    exact = bool(np.array_equal(y, x)) and rate == SR and bits == 16
    gate("lossless_level1_bit_exact", exact, "True", exact)
    say(f"lossless level 1: 30 s stereo, ratio "
        f"{len(blob) / (x.size * 2):.4f}, encode {t_enc:.2f} s, decode "
        f"{t_dec:.2f} s (cold)")


def _train_loss(devices, codec_kw, x, dp=None, sp=1):
    import jax

    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.parallel import mesh as pmesh
    from audiocodec_tpu.parallel import train

    mesh = pmesh.make_mesh(devices=devices, dp=dp, sp=sp)
    with jax.default_device(devices[0]):
        codec = Codec.create(**codec_kw)
        step, opt = train.make_train_step(codec, mesh)
        state = train.init_state(codec, opt)
    state = jax.device_put(state, pmesh.replicated(mesh))
    xs = jax.device_put(x, pmesh.waveform_sharding(mesh))
    state, loss = step(state, xs)
    state, loss2 = step(state, xs)
    return float(loss), float(loss2)


def phase_training():
    import jax

    kw = dict(sample_rate=SR, filters_n=N, bark_bands_n=BARK)
    x = tones(8, 64 * N, 1, seed=6)
    g1, g2 = _train_loss(jax.devices()[:1], kw, x)
    c1, c2 = _train_loss(jax.devices("cpu")[:1], kw, x)
    rel = abs(g1 - c1) / abs(c1)
    gate("train_loss_rel_diff_vs_cpu", f"{rel:.3e} (gpu {g1:.6e}, cpu "
         f"{c1:.6e})", "<= 1e-3", rel <= 1e-3 and np.isfinite(g2))


def phase_gpu_lane():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu_hw.py")])
    gate("gpu_lane_pytest_rc", int(rc), "== 0", int(rc) == 0)


# Lowest share of codes a sharded corpus encode must share with the
# one-device encode. At bf16-fast on a dp=2 x sp=2 mesh the spectrum and
# the step sizes are bit-identical to one card's, yet 0.2358% of the codes
# differ, in every frame (0.997642 in two four-card runs, H100 80GB HBM3 at
# 700 W): the quantizer's division sees the spectrum's float32 sum in one
# program and its bf16 rounding in the other, as XLA's fusion (which may
# keep excess precision) differs between them. Float32 and int8 hold 0.999.
MULTI_MIN_AGREE = {"f32-highest": 0.999, "bf16-fast": 0.997, "int8": 0.999}


def phase_multi():
    import jax
    import jax.numpy as jnp

    from audiocodec_tpu.parallel import corpus
    from audiocodec_tpu.parallel import mesh as pmesh

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--multi needs 4 GPUs, JAX sees {len(devs)}")
    x = tones(8, CLIP_BLOCKS * N, 2, seed=7)
    tiers = _tiers()
    fwd = jax.jit(lambda c, v: c.mdct.transform(v))
    for name in ("f32-highest", "bf16-fast", "int8"):
        codec = tiers[name]
        xc = np.asarray(jnp.asarray(x, codec.mdct.compute_dtype))
        single = corpus.make_corpus_encoder(
            codec, pmesh.make_mesh(devices=devs[:1]))
        codes1, delta1 = (np.asarray(a) for a in single(xc))
        spec1 = np.asarray(fwd(codec, jax.device_put(xc, devs[0])))
        for dp, sp in ((4, 1), (2, 2)):
            mesh = pmesh.make_mesh(devices=devs[:4], dp=dp, sp=sp)
            run = corpus.make_corpus_encoder(codec, mesh)
            xs = jax.device_put(xc, pmesh.waveform_sharding(mesh))
            codes, delta = (np.asarray(a) for a in run(xc))
            d = codes.astype(np.int64) - codes1
            agree = float(np.mean(d == 0))
            dmax = int(np.max(np.abs(d)))
            floor = MULTI_MIN_AGREE[name]
            gate(f"multi_corpus_{name}_dp{dp}_sp{sp}_codes_agree",
                 f"{agree:.6f} max|d| {dmax}", f">= {floor}, max|d| <= 1",
                 agree >= floor and dmax <= 1)
            # where they differ: the spectrum, the step sizes, which frames
            spec = np.asarray(fwd(codec, xs))
            frames = np.unique(np.nonzero(d)[1])
            say(f"multi corpus {name} dp={dp} sp={sp} vs one device: "
                f"spectrum values differing "
                f"{_bits_differ(spec, spec1).mean():.6f}, step sizes "
                f"differing {_bits_differ(delta, delta1).mean():.6f}, "
                f"frames with a differing code {frames.size} of "
                f"{codes.shape[1]} (first {frames[:6].tolist()})")
            t = timed(run, xs)
            say(f"multi corpus {name} dp={dp} sp={sp}: {t * 1e3:.3f} ms per "
                f"8 x 10 s stereo ({80 / t:.1f} audio-s/s)")
        t1 = timed(single, jax.device_put(xc, devs[0]))
        say(f"multi corpus {name} single device: {t1 * 1e3:.3f} ms per "
            f"8 x 10 s stereo ({80 / t1:.1f} audio-s/s)")
    kw = dict(sample_rate=SR, filters_n=N, bark_bands_n=BARK)
    xt = tones(8, 64 * N, 1, seed=6)
    s1, _ = _train_loss(devs[:1], kw, xt)
    s4, s4b = _train_loss(devs[:4], kw, xt, dp=4)
    rel = abs(s4 - s1) / abs(s1)
    gate("multi_train_loss_rel_diff_dp4_vs_single",
         f"{rel:.3e} (dp4 {s4:.6e}, single {s1:.6e})", "<= 1e-3",
         rel <= 1e-3 and np.isfinite(s4b))


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: only the sharded corpus and train "
                         "phase")
    args = ap.parse_args(argv)

    try:
        CARD = card_line()
    except (OSError, subprocess.SubprocessError, RuntimeError) as e:
        print(f"chip_smoke: no NVIDIA GPU ({e})", file=sys.stderr)
        return 2
    print(CARD, flush=True)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform})",
              file=sys.stderr)
        return 2
    from audiocodec_tpu.utils import compile_cache

    say(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}, "
        f"compile cache {compile_cache.enable()}")

    if args.multi:
        phases = [("multi", phase_multi)]
    else:
        phases = [
            ("long_form", phase_long_form), ("mdct", phase_mdct),
            ("quantized", phase_quantized), ("wire", phase_wire),
            ("served", phase_served), ("lossless", phase_lossless),
            ("training", phase_training), ("gpu_lane", phase_gpu_lane),
        ]
    for name, fn in phases:
        run_phase(name, fn)

    if FAILED:
        say(f"FAILED: {', '.join(FAILED)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
