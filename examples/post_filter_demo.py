#!/usr/bin/env python
"""Example: train the MDCT-domain decoder post-filter and measure the gain.

Encodes audio at a coarse (low-bitrate) quantization scale, trains the
post-filter (models/post_filter.py) against the real codec chain, then
compares held-out decode SNR with and without enhancement.

  python examples/post_filter_demo.py [--steps 400] [--scale 8]

Gains are strongest where the filter has structure to exploit: coarse
scales and narrow-band tonal content (the defaults land ~+0.3 dB at
N=64; the tuned test config in tests/test_models.py measures +0.5-0.7). Wider N spreads the tones over more near-silent bins and needs
longer training / richer data to match.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tonal_batch(rng, batch, samples, sr):
    f = rng.uniform(300, 3000, (batch, 2))
    a = rng.uniform(0.2, 0.4, (batch, 2))
    ph = rng.uniform(0, 2 * np.pi, (batch, 2))
    t = np.arange(samples)
    x = sum(
        a[:, i : i + 1] * np.sin(2 * np.pi * f[:, i : i + 1] / sr * t[None]
                                 + ph[:, i : i + 1])
        for i in range(2)
    )
    return x[:, :, None].astype(np.float32)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--scale", type=float, default=8.0,
                        help="threshold scale (higher = coarser/lower rate)")
    parser.add_argument("--filters-n", type=int, default=64)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from audiocodec_tpu.utils import compile_cache


    compile_cache.enable()

    from audiocodec_tpu import quantize as _q
    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.models import post_filter as pf
    from audiocodec_tpu.parallel import make_mesh, mesh as _mesh

    sr, n = 16000, args.filters_n
    codec = Codec.create(sr, filters_n=n, bark_bands_n=32)
    cfg = pf.PostFilter(filters_n=n, hidden_n=2 * n)
    mesh = make_mesh()
    step, opt = pf.make_train_step(
        codec, cfg, mesh,
        optimizer=optax.adam(1e-3),
        threshold_scale=args.scale,
    )
    params = pf.init_params(jax.random.key(0), cfg)
    opt_state = opt.init(params)

    samples = 16 * n
    sharding = _mesh.waveform_sharding(mesh)
    for i in range(args.steps):
        rng = np.random.default_rng(i)
        x = jax.device_put(
            jnp.asarray(tonal_batch(rng, 8, samples, sr)), sharding
        )
        params, opt_state, loss = step(params, opt_state, x)
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")

    held = jnp.asarray(
        tonal_batch(np.random.default_rng(9999), 4, samples, sr)
    )
    spec = codec.mdct.transform(held)
    thr = codec.psycho.global_masking_threshold(
        spec, codec.psycho.tonality(spec)
    ) * args.scale
    codes, delta = _q.quantize(spec, thr)

    def snr(decoded):
        out = np.asarray(decoded)[:, n:-n]
        ref = np.asarray(held)
        return 10 * np.log10(
            (ref**2).sum() / max(((ref - out) ** 2).sum(), 1e-30)
        )

    raw = snr(codec.decode_quantized(codes, delta))
    enh = snr(pf.decode_enhanced(codec, cfg, params, codes, delta))
    print(f"held-out decode SNR at {args.scale}x threshold scale: "
          f"raw {raw:.2f} dB -> enhanced {enh:.2f} dB (+{enh - raw:.2f})")


if __name__ == "__main__":
    main()
