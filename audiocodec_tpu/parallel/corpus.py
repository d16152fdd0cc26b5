"""Corpus-scale batched encode over a device mesh.

The BASELINE config-4 workload: a thousand-clip corpus streamed through the
codec as one jit program per batch, clips sharded data-parallel over the devices.
The reference has no counterpart (its batching is a tensor dim on one
device); here the batch axis is laid out over the mesh with GSPMD so the
same program runs 1-chip or N-chip unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from audiocodec_tpu.codec import Codec
from audiocodec_tpu.parallel import mesh as _mesh


def make_corpus_encoder(codec: Codec, mesh: Mesh, quantized: bool = True):
    """Build a jitted sharded encoder: waveform batch -> encoded outputs.

    :param quantized: True -> (codes, delta) integer coding;
        False -> (noisy_spectrum,) noise-injection encode (needs a key).
    :return: callable(batch [B, S, C], key?) with B divisible by the dp
        extent; inputs are placed with batch-over-dp, samples-over-sp.
    """
    wave_sharding = _mesh.waveform_sharding(mesh)
    out_sharding = _mesh.spectrum_sharding(mesh)

    if quantized:

        @jax.jit
        def encode_batch(x):
            codes, delta, _ = codec.encode_quantized(x)
            return (
                jax.lax.with_sharding_constraint(codes, out_sharding),
                jax.lax.with_sharding_constraint(delta, out_sharding),
            )

        def run(batch, key=None):
            batch = jax.device_put(batch, wave_sharding)
            return encode_batch(batch)

        return run

    @jax.jit
    def encode_batch_noise(x, key):
        y = codec.encode(x, key)
        return jax.lax.with_sharding_constraint(y, out_sharding)

    def run_noise(batch, key):
        batch = jax.device_put(batch, wave_sharding)
        return encode_batch_noise(batch, key)

    return run_noise


def encode_corpus(
    codec: Codec,
    clips,
    mesh: Mesh | None = None,
    batch_size: int = 64,
    key=None,
    quantized: bool = True,
):
    """Encode an iterable/array of equal-length clips in sharded batches.

    :param clips: array [n_clips, samples, channels] (or an iterable of
        such batches already sized to ``batch_size``).
    :return: list of per-batch encoder outputs (host-side pull left to the
        caller; results stay on device for downstream pipelines).
    """
    if mesh is None:
        mesh = _mesh.make_mesh()
    encoder = make_corpus_encoder(codec, mesh, quantized=quantized)
    dp = mesh.shape["dp"]
    if batch_size % dp != 0:
        batch_size = _mesh.pad_batch_to(batch_size, dp)

    outputs = []
    clips = jnp.asarray(clips)
    n = clips.shape[0]
    for start in range(0, n, batch_size):
        batch = clips[start : start + batch_size]
        real = batch.shape[0]
        if real % dp != 0:
            pad = _mesh.pad_batch_to(real, dp) - real
            batch = jnp.concatenate(
                [batch, jnp.zeros((pad,) + batch.shape[1:], batch.dtype)]
            )
        if quantized:
            out = encoder(batch)
        else:
            key, sub = jax.random.split(key)
            out = (encoder(batch, sub),)
        # strip the dp-padding rows so callers never see phantom clips
        outputs.append(tuple(o[:real] for o in out))
    return outputs
