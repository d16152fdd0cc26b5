#!/usr/bin/env python
"""FEC calibration probe: overhead vs recovery quality.

Measures, on a music-like mono signal (the lossy_transport_demo mix,
folded to mono), for fec scale multipliers in {4, 6, 8}:

  - byte overhead of the redundant members at EQUAL main scale;
  - recovery quality when the "network" drops chunks: SNR inside the
    outages vs the clean decode, fec-rebuilt vs plain concealment, at
    MATCHED total bitrate (the plain stream's scale is re-searched so
    both files spend the same bytes).

Run: python benchmarks/fec_probe.py [--cpu]   (results in DESIGN.md §20)
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from examples.lossy_transport_demo import make_music  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--chunk-blocks", type=int, default=32)
    ap.add_argument("--scale", type=float, default=4.0,
                    help="main threshold scale of the fec arm")
    ap.add_argument("--signal", choices=["music", "harmonics"],
                    default="music")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from audiocodec_tpu.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp

    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.io import stream_container as sc

    sr, n = 44100, 1024
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64)
    if args.signal == "music":
        wave = make_music(sr, args.seconds).mean(axis=1, keepdims=True)
    else:
        t = np.arange(int(sr * args.seconds)) / sr
        wave = sum(
            a * np.sin(2 * np.pi * f * t)
            for a, f in ((0.3, 220.0), (0.2, 440.0), (0.15, 660.0),
                         (0.1, 1320.0), (0.06, 2640.0), (0.04, 5280.0))
        ).astype(np.float32)[:, None]
    chunk = args.chunk_blocks * n
    usable = wave.shape[0] - wave.shape[0] % chunk
    x = jnp.asarray(np.ascontiguousarray(wave[None, :usable], np.float32))
    tmp = tempfile.mkdtemp()

    def encode(path, scale, fec):
        sc.encode_stream(codec, x, path, chunk_blocks=args.chunk_blocks,
                         threshold_scale=scale, deadzone=0.6, tns=True,
                         nf=True, fec=fec)
        return os.path.getsize(path)

    def kbps(nbytes):
        return nbytes * 8 / (usable / sr) / 1000

    def decode(path, conceal=False):
        return np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, conceal=conceal)],
            axis=1)

    def drop(path, lost):
        with sc.StreamReader(path) as r:
            offs = [r._index[i] for i in lost]
            n_chunks = r.n_chunks
        with open(path, "r+b") as f:
            for off in offs:
                f.seek(off + 12)
                f.write(b"\xde\xad\xbe\xef")
        return n_chunks

    base = os.path.join(tmp, "base.acs")
    b0 = encode(base, args.scale, 0.0)
    print(f"signal: {usable / sr:.1f}s mono {sr} Hz, "
          f"{args.chunk_blocks}-block chunks "
          f"({args.chunk_blocks * n / sr:.2f}s each)")
    print(f"plain stream @ scale {args.scale:g}: {b0} B = "
          f"{kbps(b0):.1f} kbit/s")

    lost = [3, 8, 13]
    for mult in (4.0, 6.0, 8.0):
        fpath = os.path.join(tmp, f"fec{mult:g}.acs")
        bf = encode(fpath, args.scale, mult)
        over = 100.0 * (bf - b0) / b0
        clean = decode(fpath)

        # matched-rate plain arm: bisect the plain scale to the fec
        # stream's byte count (payload shrinks monotonically in scale)
        ppath = os.path.join(tmp, f"plain{mult:g}.acs")
        lo, hi = args.scale / 8, args.scale
        for _ in range(12):
            mid = (lo * hi) ** 0.5
            bp = encode(ppath, mid, 0.0)
            if bp > bf:
                lo = mid
            else:
                hi = mid
        clean_p = decode(ppath)

        drop(fpath, lost)
        drop(ppath, lost)
        out_f = decode(fpath, conceal=True)
        out_p = decode(ppath, conceal=True)

        mask = np.zeros(clean.shape[1], bool)
        for i in lost:
            mask[i * chunk : (i + 1) * chunk] = True

        def span_snr(out, ref):
            e = ref[0, mask, 0] - out[0, mask, 0]
            return 10 * np.log10(
                (ref[0, mask, 0] ** 2).sum() / max((e ** 2).sum(), 1e-30))

        src = np.asarray(x)[:, : clean.shape[1] - 2 * n]

        def full_snr(out):
            o = out[:, n : n + src.shape[1]]
            e = src - o
            return 10 * np.log10(
                (src ** 2).sum() / max((e ** 2).sum(), 1e-30))

        print(f"fec x{mult:g}: {bf} B = {kbps(bf):.1f} kbit/s "
              f"(+{over:.1f}% overhead) | outage SNR vs clean decode: "
              f"fec {span_snr(out_f, clean):.2f} dB vs conceal "
              f"{span_snr(out_p, clean_p):.2f} dB (matched "
              f"{kbps(bp):.1f} kbit/s) | whole-file SNR vs source: "
              f"fec {full_snr(out_f):.2f} / conceal {full_snr(out_p):.2f} "
              f"/ no-loss-at-this-rate {full_snr(clean_p):.2f} dB")


if __name__ == "__main__":
    main()
