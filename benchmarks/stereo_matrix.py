#!/usr/bin/env python
"""Stereo matrix: joint-coding variants at matched bitrates.

For each (stereo signal, target kbps), rate-controls L/R, M/S, and
M/S + intensity (plus the low-rate ladder) and reports the measured
kbps, SNR, NMR, and the stereo-IMAGE metrics the mono matrix cannot
see: the energy ratio and correlation of the decoded side channel
above the intensity crossover vs the original. Everything decodes
through the real container round trip. Writes benchmarks/STEREO.md.

Usage: python benchmarks/stereo_matrix.py [--cpu] [--seconds 6]
       [--targets 48,96]

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


def make_stereo(name: str, sr: int, seconds: float) -> np.ndarray:
    """[samples, 2] float32 test scenes with distinct stereo images."""
    rng = np.random.default_rng(0xD0)
    t = np.arange(int(sr * seconds)) / sr

    def stack(f0, parts, amp):
        s = np.zeros_like(t)
        for k in range(1, parts + 1):
            if f0 * k < sr * 0.475:
                s += (amp / k) * np.sin(
                    2 * np.pi * f0 * k * t + rng.uniform(0, 2 * np.pi)
                )
        return s

    if name == "pannedmix":
        # the intensity use case: instruments level-panned L/R over a
        # centered bass, with a whisper of wide ambience
        mel = stack(2000, 3, 0.25) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
        bright = stack(7000, 2, 0.18) * (
            1 + 0.4 * np.sin(2 * np.pi * 5 * t)
        )
        bass = stack(110, 6, 0.3)
        amb = 0.01 * rng.standard_normal((2, t.size))
        L = bass * 0.7 + 1.0 * mel + 0.25 * bright + amb[0]
        R = bass * 0.7 + 0.3 * mel + 0.95 * bright + amb[1]
    elif name == "pannedtones":
        # hard pans straddling the intensity AND bwe crossovers
        lo = stack(6100, 3, 0.2)
        hi = 0.2 * np.sin(2 * np.pi * 12500 * t)
        bass = stack(220, 4, 0.3)
        L = bass + 1.0 * lo + 0.2 * hi
        R = bass + 0.25 * lo + 0.9 * hi
    elif name == "wideamb":
        # the adversarial case: DECORRELATED width (projections ~0 —
        # intensity drops this above the crossover, honestly shown)
        center = stack(500, 8, 0.25)
        amb = 0.12 * rng.standard_normal((2, t.size))
        L = center + amb[0]
        R = center + amb[1]
    else:
        raise SystemExit(f"unknown signal {name!r}")
    x = np.stack([L, R], axis=-1)
    x = 0.7 * x / np.abs(x).max()
    return x.astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--targets", default="48,96")
    ap.add_argument("--signals", default="pannedmix,pannedtones,wideamb")
    ap.add_argument("--out", default="benchmarks/STEREO.md")
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
    ist = codec.is_start
    targets = [float(k) for k in args.targets.split(",")]
    variants = [
        ("L/R", dict(ms=False)),
        ("M/S", dict(ms=True)),
        ("M/S+is", dict(ms=True, intensity=True)),
        ("M/S+is+bwe+nf", dict(ms=True, intensity=True, bwe=True,
                               nf=True, deadzone="auto")),
    ]

    def side_band(x_arr):
        f = codec.mdct.transform(jnp.asarray(x_arr))
        return np.asarray(codec.to_mid_side(f))[..., ist:, 1]

    rows = []
    for signame in args.signals.split(","):
        wave = make_stereo(signame, sr, args.seconds)
        wave = wave[: wave.shape[0] // n * n]
        x = jnp.asarray(wave[None])
        s_ref = side_band(x)
        for target in targets:
            for vname, kw in variants:
                res = rate.encode_with_target_bitrate(
                    codec, x, target, **kw
                )
                codes, bark, meta = bitstream.unpack(res.packed)
                dec_kw = dict(
                    threshold_scale=res.threshold_scale,
                    dz_recon=meta["dz_recon"],
                    nf_levels=(None if meta["nf_levels"] is None
                               else jnp.asarray(meta["nf_levels"])),
                    nf_band_start=(None if meta["nf_levels"] is None
                                   else meta["nf_band_start"]),
                    nf_seed=np.uint32(meta["nf_seed"]),
                    bwe_gains=(None if meta["bwe_gains"] is None
                               else jnp.asarray(meta["bwe_gains"])),
                    bwe_start=meta.get("bwe_start") or None,
                )
                cj = jnp.asarray(codes)
                bj = jnp.asarray(bark, dtype=jnp.bfloat16)
                if meta["ms"]:
                    isg = meta.get("is_gains")
                    out = codec.decode_bitstream_ms(
                        cj, bj,
                        is_gains=(None if isg is None
                                  else jnp.asarray(isg)),
                        is_start=meta.get("is_start") or None,
                        **dec_kw,
                    )
                else:
                    out = codec.decode_bitstream(cj, bj, **dec_kw)
                out = out[:, n:-n]
                ev = metrics.evaluate(codec, x, out)
                s_got = side_band(np.asarray(out, np.float32))
                m = min(s_ref.shape[1], s_got.shape[1])
                sr_, sg_ = s_ref[:, :m], s_got[:, :m]
                e = float((sg_**2).sum() / max((sr_**2).sum(), 1e-30))
                corr = float(
                    (sr_ * sg_).sum()
                    / np.sqrt((sr_**2).sum() * (sg_**2).sum() + 1e-30)
                )
                row = {
                    "signal": signame,
                    "target_kbps": target,
                    "variant": vname,
                    "kbps": round(res.kbps, 1),
                    "snr_db": round(ev["snr_db"], 2),
                    "nmr": round(ev["nmr"], 4),
                    "side_e": round(e, 3),
                    "side_corr": round(corr, 3),
                }
                rows.append(row)
                print(json.dumps(row), flush=True)

    lines = [
        "# Stereo matrix — joint coding at matched bitrate",
        "",
        "Rate-controlled to shared targets; every row decodes through",
        "the real container. `side E` / `side corr` = energy ratio and",
        "correlation of the decoded SIDE channel above the intensity",
        f"crossover (bin {ist}, ~6 kHz) vs the original — the stereo-",
        "image metrics SNR cannot see.",
        f"Signals: {args.seconds:.0f} s stereo {sr/1000:.1f} kHz, N={n}.",
        "Generated by benchmarks/stereo_matrix.py.",
        "",
        "What the matrix shows:",
        "",
        "- **M/S vs L/R**: joint coding wins wherever channels",
        "  correlate (center-heavy content), by the min-channel sidecar",
        "  halving plus the side channel's cheap codes.",
        "- **Intensity** converts the coded side band into per-group pan",
        "  gains: on panned content the SNR at matched rate rises while",
        "  side corr stays ~unchanged — the bits the side codes used to",
        "  cost move into the mid. The known trade shows honestly on",
        "  `wideamb`: DECORRELATED width above the crossover projects",
        "  to ~0 and its side energy drops — intensity is an opt-in",
        "  low-rate tool, not a default.",
        "- **+bwe+nf** composes: intensity scales the bwe-reconstructed",
        "  mid, so panned content ABOVE the bwe crossover keeps its",
        "  image too (pannedtones' 12.5 kHz pan).",
        "- **NMR reads higher under intensity** by construction: the",
        "  metric counts the dropped side detail as noise bin-by-bin,",
        "  but on pans that detail IS the image the gains restore —",
        "  side corr stays ~0.99 while NMR jumps. SNR + side corr are",
        "  the lens for this tool; NMR is the lens for nf/tns.",
        "",
        "| signal | target | variant | kbps | SNR dB | NMR | side E"
        " | side corr |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['signal']} | {r['target_kbps']:.0f} | {r['variant']} "
            f"| {r['kbps']} | {r['snr_db']} | {r['nmr']} "
            f"| {r['side_e']} | {r['side_corr']} |"
        )
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
