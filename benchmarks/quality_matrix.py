#!/usr/bin/env python
"""Quality matrix: the coded-path feature set at matched bitrates.

For each (signal, target kbps), rate-controls four encoder variants —
baseline (plain rounding), +deadzone(auto), +tns, +tns+nf — and reports
the measured kbps, SNR, NMR, the band-energy error (spectral holes), and
on the clicks signal the pre-echo energy. Everything decodes through the
real container round trip, so the numbers are the product's. Writes
benchmarks/QUALITY.md.

Usage: python benchmarks/quality_matrix.py [--cpu] [--seconds 8]
       [--targets 40,64,96] [--signals speechlike,clicks,noise,tones]

Quality numbers are platform-independent (the quantizer is
deterministic); --cpu forces the CPU backend.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rd_curve import band_energy_err_db, make_signal, pre_echo_energy  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--targets", default="40,64,96")
    ap.add_argument("--signals",
                    default="speechlike,clicks,noise,tones")
    ap.add_argument("--out", default="benchmarks/QUALITY.md")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from audiocodec_tpu.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    from audiocodec_tpu import metrics, rate
    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.io import bitstream

    sr, n = 44100, 1024
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64)
    targets = [float(k) for k in args.targets.split(",")]
    variants = [
        ("baseline", dict(deadzone=0.5, tns=False, nf=False)),
        ("+dz", dict(deadzone="auto", tns=False, nf=False)),
        ("+dz+tns", dict(deadzone="auto", tns=True, nf=False)),
        ("+dz+tns+nf", dict(deadzone="auto", tns=True, nf=True)),
        ("+tmask", dict(deadzone=0.5, tns=False, nf=False,
                        tmask=130.0)),
        ("+bs", dict(deadzone=0.5, tns=False, nf=False, bs=True)),
        ("full", dict(deadzone="auto", tns=True, nf=True,
                      tmask=130.0, bs=True)),
    ]
    rows = []
    for signame in args.signals.split(","):
        wave, clicks = make_signal(signame, sr, args.seconds)
        wave = wave[: wave.size // n * n]
        dur = wave.size / sr
        x = jnp.asarray(wave[None, :, None])
        for target in targets:
            for vname, kw in variants:
                res = rate.encode_with_target_bitrate(
                    codec, x, target, **kw
                )
                codes, bark, meta = bitstream.unpack(res.packed)
                ti = meta["tns_idx"]
                nfl = meta["nf_levels"]
                bsf = meta["bs_flags"]
                out = codec.decode_bitstream(
                    jnp.asarray(codes),
                    jnp.asarray(bark, dtype=jnp.bfloat16),
                    threshold_scale=res.threshold_scale,
                    dz_recon=meta["dz_recon"],
                    tns_idx=None if ti is None else jnp.asarray(ti),
                    tns_band_start=meta["tns_band_start"] or None,
                    nf_levels=None if nfl is None else jnp.asarray(nfl),
                    nf_band_start=(None if nfl is None
                                   else meta["nf_band_start"]),
                    nf_seed=np.uint32(meta["nf_seed"]),
                    bs_flags=None if bsf is None else jnp.asarray(bsf),
                )[:, n:-n]
                ev = metrics.evaluate(codec, x, out)
                row = {
                    "signal": signame,
                    "target_kbps": target,
                    "variant": vname,
                    "kbps": round(res.kbps, 1),
                    "snr_db": round(ev["snr_db"], 2),
                    "nmr": round(ev["nmr"], 4),
                    "band_err_db": round(
                        band_energy_err_db(codec, x, out), 2
                    ),
                }
                if clicks:
                    err = np.asarray(out)[0, :, 0] - wave[: out.shape[1]]
                    row["pre_echo"] = float(
                        f"{pre_echo_energy(err, clicks, sr):.3e}"
                    )
                rows.append(row)
                print(json.dumps(row), flush=True)

    lines = [
        "# Quality matrix — coded-path features at matched bitrate",
        "",
        "Rate-controlled to shared targets; every row decodes through the",
        "real container. `band err` = mean |per-frame band-energy error|",
        "above bin N/16 (the spectral-holes metric); `pre-echo` = error",
        "energy in the 12 ms before each attack (clicks signal only).",
        f"Signals: {args.seconds:.0f} s mono {sr/1000:.1f} kHz, N={n}.",
        "Generated by benchmarks/quality_matrix.py.",
        "",
        "What the matrix shows (and the honest caveats):",
        "",
        "- **Dead zone** buys +1–1.7 dB SNR at matched rate on dense",
        "  content (speechlike/noise at 40–96 kbps) and is",
        "  neutral-to-slightly-negative on sparse tonal content — the",
        "  basis of `rate.resolve_deadzone`'s auto ladder.",
        "- **TNS** is the clicks story: pre-echo energy drops 13–90× at",
        "  equal-or-better SNR; on stationary signals it is neutral (the",
        "  gain gate keeps the filter off).",
        "- **Noise filling** collapses the spectral-holes metric (band",
        "  err 5.6 → 0.4 dB where holes dominate) at an SNR cost that",
        "  approaches its structural 3 dB bound exactly when MOST of the",
        "  signal sits in holes (noise content: lost-energy ≈ total",
        "  error, and replacing silence with independent noise of matched",
        "  power doubles that error). SNR is the wrong lens for the",
        "  benefit — noise-for-noise substitution is perceptually neutral",
        "  (NMR stays put) while silence is not; the band err column is",
        "  the one NF exists to fix.",
        "- **Block switching** (`+bs`) is the other clicks story:",
        "  transient frames quantize in the short (time-split) basis",
        "  against the min-pooled threshold, confining their noise to",
        "  ~1/8 of the frame span — pre-echo drops 14-127x at matched",
        "  rate with SNR up to +2.7 dB (the rate saved on smeared",
        "  noise re-spends on signal). Composes with TNS: `full` keeps",
        "  both (TNS gates off only on switched frames).",
        "- **Temporal masking** (`+tmask`, 130 dB/s) frees bits wherever",
        "  frame-to-frame level drops (after attacks, decaying notes,",
        "  modulation troughs); at matched rate those bits move to frames",
        "  the mask exposes. Its NMR column uses the SIMULTANEOUS-only",
        "  threshold, which by construction counts shadow noise that",
        "  post-masking hides — expect NMR to read higher at equal",
        "  audibility. The clearest evidence is equal-scale container",
        "  size (rd_curve --tmask: 34–39 % smaller on transient",
        "  content).",
        "- **Tonal content saturates** below the targets (~29–32 kbps",
        "  floor at the scale cap): the two-tone signal simply needs no",
        "  more bits, so all variants tie within ~2 dB of the 50 dB",
        "  ceiling.",
        "",
        "| signal | target | variant | kbps | SNR dB | NMR | band err dB"
        " | pre-echo |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        pe = f"{r['pre_echo']:.2e}" if "pre_echo" in r else "—"
        lines.append(
            f"| {r['signal']} | {r['target_kbps']:.0f} | {r['variant']} "
            f"| {r['kbps']} | {r['snr_db']} | {r['nmr']} "
            f"| {r['band_err_db']} | {pe} |"
        )
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
