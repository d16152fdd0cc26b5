"""Rate-distortion sweep: SNR / NMR vs actual container bitrate.

Sweeps the rate-control knob (threshold_scale — the one scalar the
bitstream records, io/FORMATS.md) over a signal and reports the measured
.acz bitrate with the auto-picked entropy coder next to SNR and NMR at
each point. This is the codec's quality story in one table: where SNR
degrades gracefully as kbps drops, and where NMR crosses ~1 (noise
reaching the masking threshold).

Usage:  python benchmarks/rd_curve.py [--signal tones|noise|speechlike|clicks]
                                      [--seconds 10] [--markdown]
                                      [--deadzone 0.5,0.9,1.0] [--tns]
                                      [--nf] [--tmask 130] [--bs]

With --deadzone the sweep runs MATCHED-RATE: each zero-bin width is
rate-controlled to the same kbps targets (the container's real packed
size), so the SNR/NMR columns compare equal-bitrate points. This is the
measurement behind rate.resolve_deadzone's auto ladder.

With --tns the sweep compares temporal noise shaping off/on at matched
rate, adding a pre-echo column (error energy in the 12 ms before each
attack) when the signal is "clicks" — the measurement behind
tns.STEP_SCALE_EXP and docs/DESIGN.md §11.

With --nf the sweep compares noise filling off/on at matched rate,
adding a band-energy-error column (the spectral-holes metric that SNR
cannot see) — the measurement behind nf.py's level calibration.

With --bs the sweep compares block switching off/on at matched rate —
the measurement behind blockswitch.DETECT_RATIO and the min-pooling
choice (docs/DESIGN.md §14).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCALES = [0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0]


def make_signal(kind: str, sr: int, seconds: float):
    """-> (wave float32, click sample positions — empty unless 'clicks')."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(0)
    clicks = []
    if kind == "tones":
        x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(
            2 * np.pi * 1320 * t
        )
    elif kind == "noise":
        x = 0.3 * rng.normal(size=t.size)
    elif kind == "clicks":
        # castanet-like bursts over a quiet tonal bed — the pre-echo
        # victim TNS exists for (docs/DESIGN.md §11)
        x = 0.02 * np.sin(2 * np.pi * 330 * t)
        for s0 in range(9000, t.size - 3000, 16384):
            clicks.append(s0)
            dt = np.arange(2000)
            burst = np.exp(-dt / 300.0) * rng.normal(size=2000)
            x[s0 : s0 + 2000] += 0.8 * burst / np.max(np.abs(burst))
    elif kind == "harmonics":
        # a bright harmonic stack reaching past the BWE crossover
        # (~10.5 kHz) — the content class whose zeroed high band reads
        # as structure, not noise (bwe.py)
        f0 = 330.0
        k_max = int((sr / 2 - 1) // f0)
        x = sum(
            (0.5 / k) * np.sin(2 * np.pi * k * f0 * t + 2.39996 * k)
            for k in range(1, k_max + 1)
        )
        x = 0.6 * x / np.max(np.abs(x)) + 0.01 * rng.normal(size=t.size)
    else:  # speechlike: tones + noise + amplitude modulation
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t) ** 2
        x = env * (
            0.35 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * np.sin(2 * np.pi * 660 * t)
            + 0.08 * rng.normal(size=t.size)
        )
    return np.clip(x, -0.99, 0.99).astype(np.float32), clicks


def pre_echo_energy(err: np.ndarray, clicks, sr: int) -> float:
    """Error energy in the 12 ms ending 1 ms before each attack."""
    w, g = int(0.012 * sr), int(0.001 * sr)
    return float(
        sum((err[s0 - g - w : s0 - g] ** 2).sum() for s0 in clicks)
    )


def tns_sweep(codec, x, dur, clicks, args):
    """Matched-rate TNS off/on comparison (the --deadzone pattern)."""
    import jax.numpy as jnp

    from audiocodec_tpu import metrics, rate
    from audiocodec_tpu.io import bitstream

    sr = codec.psycho.sample_rate
    targets = [float(k) for k in args.targets.split(",")]
    n = codec.mdct.filters_n
    wave = np.asarray(x)[0, :, 0]
    rows = []
    for target in targets:
        for tns_on in (False, True):
            res = rate.encode_with_target_bitrate(
                codec, x, target, tns=tns_on
            )
            codes, bark, meta = bitstream.unpack(res.packed)
            ti = meta["tns_idx"]
            out = codec.decode_bitstream(
                jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
                threshold_scale=res.threshold_scale,
                dz_recon=meta["dz_recon"],
                tns_idx=None if ti is None else jnp.asarray(ti),
                tns_band_start=meta["tns_band_start"] or None,
            )[:, n:-n]
            ev = metrics.evaluate(codec, x, out)
            row = {
                "target_kbps": target,
                "tns": tns_on,
                "kbps": round(res.kbps, 1),
                "snr_db": round(ev["snr_db"], 2),
                "nmr": round(ev["nmr"], 4),
            }
            if clicks:
                err = np.asarray(out)[0, :, 0] - wave[: out.shape[1]]
                row["pre_echo"] = float(
                    f"{pre_echo_energy(err, clicks, sr):.3e}"
                )
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.markdown:
        cols = "| target | tns | kbps | SNR dB | NMR |" + (
            " pre-echo |" if clicks else ""
        )
        print(f"\n{cols} ({args.signal}, {dur:.0f}s mono)")
        print("|---" * (6 if clicks else 5) + "|")
        for r in rows:
            pe = f" {r['pre_echo']:.2e} |" if clicks else ""
            print(f"| {r['target_kbps']} | {r['tns']} | {r['kbps']} "
                  f"| {r['snr_db']} | {r['nmr']} |{pe}")
    return rows


def bs_sweep(codec, x, dur, clicks, args):
    """Matched-rate block-switching off/on comparison (the --tns
    pattern): on the clicks signal the pre-echo column is the payoff —
    quantization noise of a switched frame is confined to ~1/8 of the
    frame span. Compare with --tns rows: the two attack treatments are
    composable (--bs gates TNS off only on the switched frames)."""
    import jax.numpy as jnp

    from audiocodec_tpu import metrics, rate
    from audiocodec_tpu.io import bitstream

    sr = codec.psycho.sample_rate
    targets = [float(k) for k in args.targets.split(",")]
    n = codec.mdct.filters_n
    wave = np.asarray(x)[0, :, 0]
    rows = []
    for target in targets:
        for bs_on in (False, True):
            res = rate.encode_with_target_bitrate(
                codec, x, target, bs=bs_on
            )
            codes, bark, meta = bitstream.unpack(res.packed)
            bsf = meta["bs_flags"]
            out = codec.decode_bitstream(
                jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
                threshold_scale=res.threshold_scale,
                dz_recon=meta["dz_recon"],
                bs_flags=None if bsf is None else jnp.asarray(bsf),
            )[:, n:-n]
            ev = metrics.evaluate(codec, x, out)
            row = {
                "target_kbps": target,
                "bs": bs_on,
                "short_frames": 0 if bsf is None else int(bsf.sum()),
                "kbps": round(res.kbps, 1),
                "snr_db": round(ev["snr_db"], 2),
                "nmr": round(ev["nmr"], 4),
            }
            if clicks:
                err = np.asarray(out)[0, :, 0] - wave[: out.shape[1]]
                row["pre_echo"] = float(
                    f"{pre_echo_energy(err, clicks, sr):.3e}"
                )
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.markdown:
        cols = "| target | bs | short | kbps | SNR dB | NMR |" + (
            " pre-echo |" if clicks else ""
        )
        print(f"\n{cols} ({args.signal}, {dur:.0f}s mono)")
        print("|---" * (7 if clicks else 6) + "|")
        for r in rows:
            pe = f" {r['pre_echo']:.2e} |" if clicks else ""
            print(f"| {r['target_kbps']} | {r['bs']} "
                  f"| {r['short_frames']} | {r['kbps']} "
                  f"| {r['snr_db']} | {r['nmr']} |{pe}")
    return rows


def tmask_sweep(codec, x, dur, clicks, args):
    """Temporal-masking off/on: equal-scale bit savings, then matched-rate
    SNR/NMR (the --tns pattern). The NMR column uses the SIMULTANEOUS
    threshold — tmask's claim is precisely that the extra noise it allows
    sits in post-masking shadows that column cannot see, so read it next
    to the kbps column: bits saved at equal (raw-NMR) quality elsewhere."""
    import jax.numpy as jnp

    from audiocodec_tpu import metrics, rate
    from audiocodec_tpu.io import bitstream

    tm = float(args.tmask)
    n = codec.mdct.filters_n
    rows = []

    # equal-scale savings: same threshold_scale, bits with vs without
    meta_kw = dict(
        sample_rate=codec.psycho.sample_rate, filters_n=n,
        bark_bands_n=codec.psycho.bark_bands_n, alpha=codec.psycho.alpha,
        window_type=codec.mdct.window_type,
    )
    for scale in (1.0, 4.0):
        sizes = {}
        for tmv in (0.0, tm):
            c, b = codec.quantize_frames(
                codec.mdct.transform(x), threshold_scale=scale, tmask=tmv
            )
            sizes[tmv] = len(bitstream.pack(
                np.asarray(c), np.asarray(b), **meta_kw
            ))
        row = {
            "scale": scale,
            "bytes_off": sizes[0.0],
            "bytes_on": sizes[tm],
            "saved_pct": round(100 * (1 - sizes[tm] / sizes[0.0]), 2),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    targets = [float(k) for k in args.targets.split(",")]
    for target in targets:
        for tmv in (0.0, tm):
            res = rate.encode_with_target_bitrate(
                codec, x, target, tmask=tmv
            )
            codes, bark, meta = bitstream.unpack(res.packed)
            out = codec.decode_bitstream(
                jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
                threshold_scale=res.threshold_scale,
                dz_recon=meta["dz_recon"],
            )[:, n:-n]
            ev = metrics.evaluate(codec, x, out)
            row = {
                "target_kbps": target,
                "tmask": tmv,
                "kbps": round(res.kbps, 1),
                "scale": round(res.threshold_scale, 3),
                "snr_db": round(ev["snr_db"], 2),
                "nmr": round(ev["nmr"], 4),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.markdown:
        print(f"\n| target | tmask | kbps | scale | SNR dB | NMR | "
              f"({args.signal}, {dur:.0f}s mono)")
        print("|---|---|---|---|---|---|")
        for r in rows:
            if "target_kbps" not in r:
                continue
            print(f"| {r['target_kbps']} | {r['tmask']} | {r['kbps']} "
                  f"| {r['scale']} | {r['snr_db']} | {r['nmr']} |")
    return rows


def band_energy_err_db(codec, x, out):
    """Mean |per-frame band energy error| in dB over the noise-fill band —
    the 'spectral holes' metric SNR cannot see (silence in a zeroed band
    barely moves total SNR but reads as a dull/swirly timbre)."""
    bs = codec.nf_band_start
    ref = np.asarray(codec.mdct.transform(x))[:, :, bs:, :]
    dec = np.asarray(codec.mdct.transform(out))[:, :, bs:, :]
    e_ref = (ref**2).sum(axis=2)
    e_dec = (dec[:, : ref.shape[1]] ** 2).sum(axis=2)
    return float(
        np.abs(10 * np.log10((e_dec + 1e-12) / (e_ref + 1e-12))).mean()
    )


def hi_band_stats(codec, x, out, start):
    """(energy error dB, spectral-flatness delta) above the crossover.

    Flatness (geomean/mean of per-bin power, per frame, averaged) is the
    texture metric energy cannot see: harmonic content sits near 0,
    white fill near 1. Noise filling matches the ENERGY but pushes
    flatness toward 1; replication should hold it near the original's.
    """
    ref = np.asarray(codec.mdct.transform(x))[:, :, start:, :]
    dec = np.asarray(codec.mdct.transform(out))[:, : ref.shape[1], start:, :]

    def flatness(s):
        p = s.astype(np.float64) ** 2 + 1e-20
        return float(
            np.exp(np.log(p).mean(axis=2)).__truediv__(p.mean(axis=2)).mean()
        )

    e_err = float(np.abs(
        10 * np.log10(((dec**2).sum(axis=2) + 1e-12)
                      / ((ref**2).sum(axis=2) + 1e-12))
    ).mean())
    return e_err, abs(flatness(dec) - flatness(ref))


def bwe_sweep(codec, x, dur, args):
    """Matched-rate bandwidth-extension comparison at low rates: both
    arms run noise filling (the honest baseline — energy restoration is
    table stakes); the bwe arm additionally replicates structure above
    the crossover. Columns report the high-band energy error AND the
    high-band spectral-flatness delta — the hiss-vs-harmonics metric
    that energy matching cannot see."""
    import jax.numpy as jnp

    from audiocodec_tpu import metrics, rate
    from audiocodec_tpu.io import bitstream

    targets = [float(k) for k in args.targets.split(",")]
    n = codec.mdct.filters_n
    start = codec.bwe_start
    rows = []
    for target in targets:
        for bwe_on in (False, True):
            res = rate.encode_with_target_bitrate(
                codec, x, target, nf=True, bwe=bwe_on
            )
            codes, bark, meta = bitstream.unpack(res.packed)
            nfl = meta["nf_levels"]
            bweg = meta["bwe_gains"]
            out = codec.decode_bitstream(
                jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
                threshold_scale=res.threshold_scale,
                dz_recon=meta["dz_recon"],
                nf_levels=None if nfl is None else jnp.asarray(nfl),
                nf_band_start=(None if nfl is None
                               else meta["nf_band_start"]),
                nf_seed=np.uint32(meta["nf_seed"]),
                bwe_gains=None if bweg is None else jnp.asarray(bweg),
                bwe_start=meta["bwe_start"],
            )[:, n:-n]
            ev = metrics.evaluate(codec, x, out)
            e_err, flat_d = hi_band_stats(codec, x, out, start)
            rows.append({
                "target_kbps": target,
                "bwe": bwe_on,
                "kbps": round(res.kbps, 1),
                "snr_db": round(ev["snr_db"], 2),
                "nmr": round(ev["nmr"], 4),
                "hi_err_db": round(e_err, 2),
                "hi_flat_delta": round(flat_d, 4),
            })
            print(json.dumps(rows[-1]), flush=True)
    if args.markdown:
        print(f"\n| target | bwe | kbps | SNR dB | NMR | hi err dB | "
              f"hi flat Δ | ({args.signal}, {dur:.0f}s mono, nf on) |")
        print("|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['target_kbps']} | {r['bwe']} | {r['kbps']} "
                  f"| {r['snr_db']} | {r['nmr']} | {r['hi_err_db']} "
                  f"| {r['hi_flat_delta']} | |")
    return rows


def nf_sweep(codec, x, dur, args):
    """Matched-rate noise-filling off/on comparison: same kbps targets,
    columns report SNR (expected to dip slightly — the fill is synthetic
    noise), NMR, and the band-energy error the fill exists to repair."""
    import jax.numpy as jnp

    from audiocodec_tpu import metrics, rate
    from audiocodec_tpu.io import bitstream

    targets = [float(k) for k in args.targets.split(",")]
    n = codec.mdct.filters_n
    rows = []
    for target in targets:
        for nf_on in (False, True):
            res = rate.encode_with_target_bitrate(
                codec, x, target, nf=nf_on
            )
            codes, bark, meta = bitstream.unpack(res.packed)
            nfl = meta["nf_levels"]
            out = codec.decode_bitstream(
                jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
                threshold_scale=res.threshold_scale,
                dz_recon=meta["dz_recon"],
                nf_levels=None if nfl is None else jnp.asarray(nfl),
                nf_band_start=(None if nfl is None
                               else meta["nf_band_start"]),
                nf_seed=np.uint32(meta["nf_seed"]),
            )[:, n:-n]
            ev = metrics.evaluate(codec, x, out)
            rows.append({
                "target_kbps": target,
                "nf": nf_on,
                "kbps": round(res.kbps, 1),
                "snr_db": round(ev["snr_db"], 2),
                "nmr": round(ev["nmr"], 4),
                "band_err_db": round(band_energy_err_db(codec, x, out), 2),
            })
            print(json.dumps(rows[-1]), flush=True)
    if args.markdown:
        print(f"\n| target | nf | kbps | SNR dB | NMR | band err dB | "
              f"({args.signal}, {dur:.0f}s mono) |")
        print("|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['target_kbps']} | {r['nf']} | {r['kbps']} "
                  f"| {r['snr_db']} | {r['nmr']} | {r['band_err_db']} | |")
    return rows


def deadzone_sweep(codec, x, dur, args):
    """Matched-rate dead-zone comparison: every width rate-controlled to
    the same targets; rows report the container's REAL kbps next to
    SNR/NMR so equal-rate points are compared."""
    import jax.numpy as jnp

    from audiocodec_tpu import metrics, rate
    from audiocodec_tpu.io import bitstream

    zones = [float(z) for z in args.deadzone.split(",")]
    targets = [float(k) for k in args.targets.split(",")]
    n = codec.mdct.filters_n
    rows = []
    for target in targets:
        for z in zones:
            res = rate.encode_with_target_bitrate(
                codec, x, target, deadzone=z
            )
            codes, bark, meta = bitstream.unpack(res.packed)
            out = codec.decode_bitstream(
                jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
                threshold_scale=res.threshold_scale,
                dz_recon=meta["dz_recon"],
            )[:, n:-n]
            ev = metrics.evaluate(codec, x, out)
            rows.append({
                "target_kbps": target,
                "deadzone": z,
                "kbps": round(res.kbps, 1),
                "snr_db": round(ev["snr_db"], 2),
                "nmr": round(ev["nmr"], 4),
            })
            print(json.dumps(rows[-1]), flush=True)
    if args.markdown:
        print(f"\n| target | deadzone | kbps | SNR dB | NMR | "
              f"({args.signal}, {dur:.0f}s mono) |")
        print("|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['target_kbps']} | {r['deadzone']} | {r['kbps']} "
                  f"| {r['snr_db']} | {r['nmr']} | |")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--signal", default="speechlike",
                    choices=["tones", "noise", "speechlike", "clicks",
                             "harmonics"])
    ap.add_argument("--tns", action="store_true",
                    help="matched-rate TNS off/on comparison (use "
                         "--signal clicks for the pre-echo column)")
    ap.add_argument("--nf", action="store_true",
                    help="matched-rate noise-filling off/on comparison "
                         "with a band-energy-error column")
    ap.add_argument("--bwe", action="store_true",
                    help="matched-rate bandwidth-extension comparison "
                         "(nf on in both arms; use --signal harmonics) "
                         "with high-band energy-error and spectral-"
                         "flatness-delta columns")
    ap.add_argument("--bs", action="store_true",
                    help="matched-rate block-switching off/on comparison "
                         "(use --signal clicks for the pre-echo column)")
    ap.add_argument("--tmask", type=float, default=0.0,
                    help="temporal-masking decay in dB/s; switches to an "
                         "off/on sweep: equal-scale bit savings plus "
                         "matched-rate SNR/NMR (try 130; --signal clicks "
                         "shows the biggest shadows)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--markdown", action="store_true",
                    help="also print a markdown table")
    ap.add_argument("--deadzone", default="",
                    help="comma-separated zero-bin widths; switches to a "
                         "matched-rate sweep (rate-controlled to shared "
                         "kbps targets) comparing the widths")
    ap.add_argument("--targets", default="40,64,96,128",
                    help="kbps targets for the --deadzone sweep")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (quality numbers are "
                         "platform-independent)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from audiocodec_tpu.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    from audiocodec_tpu import metrics
    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.io import bitstream

    sr, n = 44100, 1024
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64)
    wave, clicks = make_signal(args.signal, sr, args.seconds)
    wave = wave[: wave.size // n * n]
    dur = wave.size / sr
    x = jnp.asarray(wave[None, :, None])

    if args.tns:
        return tns_sweep(codec, x, dur, clicks, args)
    if args.nf:
        return nf_sweep(codec, x, dur, args)
    if args.bwe:
        return bwe_sweep(codec, x, dur, args)
    if args.tmask:
        return tmask_sweep(codec, x, dur, clicks, args)
    if args.bs:
        return bs_sweep(codec, x, dur, clicks, args)
    if args.deadzone:
        return deadzone_sweep(codec, x, dur, args)

    # one jitted program per sweep point is wasteful; scale is a traced
    # scalar so every point reuses ONE compiled encode and ONE decode
    @jax.jit
    def encode(c, x, scale):
        codes, bark = c.quantize_frames(
            c.mdct.transform(x), 0.0, threshold_scale=scale
        )
        return codes, bark

    @jax.jit
    def decode(c, codes, bark, scale):
        return c.decode_bitstream(codes, bark, threshold_scale=scale)

    pack_kw = dict(
        sample_rate=sr, filters_n=n, bark_bands_n=64,
        alpha=codec.psycho.alpha, window_type="vorbis",
        compute_dtype="float32",
    )
    rows = []
    for scale in SCALES:
        s = jnp.float32(scale)
        codes, bark = encode(codec, x, s)
        out = decode(codec, codes, bark, s)[:, n:-n]
        blob = bitstream.pack(
            np.asarray(codes), np.asarray(bark),
            threshold_scale=scale, **pack_kw,
        )
        kbps = len(blob) * 8 / dur / 1000
        ev = metrics.evaluate(codec, x, out)
        rows.append({
            "threshold_scale": scale,
            "kbps": round(kbps, 1),
            "snr_db": round(ev["snr_db"], 2),
            "nmr": round(ev["nmr"], 4),
        })
        print(json.dumps(rows[-1]), flush=True)

    if args.markdown:
        print(f"\n| scale | kbps | SNR dB | NMR | ({args.signal}, "
              f"{dur:.0f}s mono {sr/1000:.1f} kHz) |")
        print("|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['threshold_scale']} | {r['kbps']} | "
                  f"{r['snr_db']} | {r['nmr']} | |")
    return rows


if __name__ == "__main__":
    main()
