#!/usr/bin/env python
"""Example: train through the codec (the differentiable-pipeline use case).

The reference exists to slot a codec into neural audio pipelines (its two
ops are differentiable @tf.function graphs); this example shows the
framework's version of that story end to end: learn per-band spectral
gains that undo a simulated channel tilt, with gradients flowing through
the MDCT, the psychoacoustic masking threshold, and the straight-through
quantizer — sharded over every available device.

  python examples/train_spectral_gains.py [--steps 200]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--filters-n", type=int, default=256)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from audiocodec_tpu.codec import Codec
    from audiocodec_tpu.parallel import mesh as _mesh
    from audiocodec_tpu.parallel import train as _train

    from audiocodec_tpu.utils import compile_cache


    compile_cache.enable()

    n = args.filters_n
    sr = 16000
    codec = Codec.create(sr, filters_n=n, bark_bands_n=32)
    mesh = _mesh.make_mesh()
    print(f"devices: {jax.device_count()}, mesh: {dict(mesh.shape)}")

    # a toy "channel": the input arrives spectrally tilted; the gains must
    # learn to flatten it so the decoded waveform matches the clean target
    rng = np.random.default_rng(0)
    batch = max(8, jax.device_count())
    clean = rng.uniform(-0.6, 0.6, (batch, 32 * n, 1)).astype(np.float32)
    x = jax.device_put(
        jnp.asarray(clean), _mesh.waveform_sharding(mesh)
    )

    optimizer = optax.adam(3e-2)
    train_step, optimizer = _train.make_train_step(codec, mesh, optimizer)
    state = _train.init_state(codec, optimizer)
    # start deliberately mis-gained
    state = _train.TrainState(
        gains=state.gains * 0.4, opt_state=state.opt_state
    )

    for step in range(args.steps):
        state, loss = train_step(state, x)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.6f}  "
                  f"mean gain {float(jnp.mean(state.gains)):.3f}")

    final = float(jnp.mean(state.gains))
    print(f"final mean gain: {final:.3f} (target ~1.0)")


if __name__ == "__main__":
    main()
