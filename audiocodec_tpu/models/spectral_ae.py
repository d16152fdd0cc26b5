"""Neural spectral autoencoder: a learned bottleneck over MDCT frames.

The model family the reference's design anticipates but never ships: its
transforms are differentiable precisely so a neural network can learn a
compact representation between analysis and synthesis (reference
audiocodec/psychoacoustic.py:151-167 — noise injection "simulates"
quantization for exactly this training setup). This is the canonical
neural audio codec shape (SoundStream/Lyra-style bottleneck, but spectral
rather than waveform-domain): frames -> encoder MLP -> low-dim latent ->
decoder MLP -> frames, trained end to end through the REAL codec chain
against a waveform + noise-to-mask perceptual loss.

Accelerator-first design decisions:

* Per-frame dense layers contract over the filter-band axis N with
  everything else (batch, blocks, channels) batched — each layer is one
  [B*T*C, N] @ [N, H] matmul; no convolutions over time, so blocks
  shard over the ``sp`` mesh axis with zero halo (the codec's MDCT carries
  the only cross-block coupling).
* Parameters are a plain pytree dict (no framework), replicated over the
  mesh; batches shard dp x sp; GSPMD inserts the gradient psums.
* Bottleneck noise: during training, uniform noise of one latent
  quantization step is added to the latent (straight-through-free,
  classic neural-codec relaxation); at inference the latent is rounded to
  that grid, giving an actual discrete code of
  ``latent_n * log2(2/latent_step)`` bits/frame/channel.
* dtype policy matches the framework: parameters are created in
  ``compute_dtype``, inputs must already be ``compute_dtype``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import optax

from audiocodec_tpu.codec import Codec
from audiocodec_tpu.parallel import mesh as _mesh
from audiocodec_tpu.utils import dtypes as _dtypes


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[],
    meta_fields=["filters_n", "hidden_n", "latent_n", "latent_step"],
)
@dataclasses.dataclass(frozen=True)
class SpectralAE:
    """Static architecture config (a leaf-free pytree, safe as jit static).

    :param filters_n: MDCT filter bands N (the frame width).
    :param hidden_n: hidden layer width.
    :param latent_n: bottleneck width (the learned code per frame/channel).
    :param latent_step: quantization step of the latent grid; the trained
        latent lives in [-1, 1] (tanh), so bits/frame/channel =
        latent_n * log2(2 / latent_step).
    """

    filters_n: int = 1024
    hidden_n: int = 512
    latent_n: int = 64
    latent_step: float = 1.0 / 32.0

    def bits_per_frame(self) -> float:
        """Code size of one frame of one channel at the latent grid."""
        import math

        return self.latent_n * math.log2(2.0 / self.latent_step)


def init_params(key, cfg: SpectralAE, compute_dtype=jnp.float32) -> dict:
    """He-initialized encoder/decoder MLP parameters as a flat dict pytree."""
    dtype = _dtypes.canonicalize_compute_dtype(compute_dtype)
    n, h, z = cfg.filters_n, cfg.hidden_n, cfg.latent_n
    ks = jax.random.split(key, 4)

    def dense(k, fan_in, fan_out):
        w = jax.random.normal(k, (fan_in, fan_out), dtype=jnp.float32)
        return (w * (2.0 / fan_in) ** 0.5).astype(dtype)

    return {
        "enc_w1": dense(ks[0], n, h),
        "enc_b1": jnp.zeros((h,), dtype),
        "enc_w2": dense(ks[1], h, z),
        "enc_b2": jnp.zeros((z,), dtype),
        "dec_w1": dense(ks[2], z, h),
        "dec_b1": jnp.zeros((h,), dtype),
        "dec_w2": dense(ks[3], h, n),
        "dec_b2": jnp.zeros((n,), dtype),
    }


def _dense(x, w, b):
    """Contract the band axis of [B, T, N, C] frames: one batched
    matmul per layer ('btnc,nh->bthc'); f32 accumulation under bf16."""
    y = jnp.einsum(
        "btnc,nh->bthc", x, w, preferred_element_type=jnp.float32
    ).astype(x.dtype)
    return y + b[None, None, :, None]


def encode_frames(params: dict, frames: jax.Array) -> jax.Array:
    """[B, blocks, N, C] spectrum -> [B, blocks, latent_n, C] in [-1, 1]."""
    hidden = jax.nn.gelu(_dense(frames, params["enc_w1"], params["enc_b1"]))
    return jnp.tanh(_dense(hidden, params["enc_w2"], params["enc_b2"]))


def decode_frames(params: dict, latents: jax.Array) -> jax.Array:
    """[B, blocks, latent_n, C] -> reconstructed [B, blocks, N, C]."""
    hidden = jax.nn.gelu(_dense(latents, params["dec_w1"], params["dec_b1"]))
    return _dense(hidden, params["dec_w2"], params["dec_b2"])


def quantize_latents(cfg: SpectralAE, latents: jax.Array) -> jax.Array:
    """Round to the latent grid (inference-time discrete code)."""
    step = jnp.asarray(cfg.latent_step, latents.dtype)
    return jnp.round(latents / step) * step


def apply(
    cfg: SpectralAE,
    params: dict,
    frames: jax.Array,
    *,
    key=None,
    quantized: bool = False,
) -> jax.Array:
    """Full bottleneck pass over spectrum frames.

    :param key: when given, adds U(-step/2, step/2) noise to the latent —
        the training-time relaxation of the quantizer.
    :param quantized: round the latent to the grid (deterministic
        inference; mutually exclusive with ``key``).
    """
    if key is not None and quantized:
        raise ValueError(
            "apply(key=..., quantized=True) is ambiguous: pass key for the "
            "training-time noise relaxation OR quantized=True for rounded "
            "discrete-code inference, not both"
        )
    z = encode_frames(params, frames)
    if key is not None:
        z = z + jax.random.uniform(
            key, z.shape, dtype=z.dtype,
            minval=-cfg.latent_step / 2, maxval=cfg.latent_step / 2,
        )
    elif quantized:
        z = quantize_latents(cfg, z)
    return decode_frames(params, z)


def perceptual_loss(
    codec: Codec,
    cfg: SpectralAE,
    params: dict,
    x: jax.Array,
    key,
    nmr_weight: float = 0.1,
    nmr_floor: float = 1e-3,
) -> jax.Array:
    """Waveform MSE + noise-to-mask ratio through the real codec chain.

    The masking threshold of the ORIGINAL spectrum weights the
    reconstruction error exactly as the codec's quantizer would be judged:
    error below threshold is inaudible and cheap, error above is penalized
    (the perceptual calibration of reference psychoacoustic.py:151-167).

    :param nmr_floor: denominator floor on the threshold, in spectrum
        amplitude units (default ≈ −60 dB of a full-scale frame). This
        floor is load-bearing for a GENERATIVE model: at the quiet
        threshold's own scale (~1e-5) a quiet bin is weighted ~1e8×
        a tonal bin, so the loss optimum is the decoder that outputs
        exactly zero everywhere — the bottleneck collapses and training
        plateaus at 0 dB SNR (measured). A scalar quantizer never sees
        this because its quiet-bin error is exactly zero by construction;
        an MLP decoder's can't be.
    """
    spec = codec.mdct.transform(x)
    tonality = codec.psycho.tonality(spec)
    threshold = codec.psycho.global_masking_threshold(spec, tonality)
    recon = apply(cfg, params, spec, key=key)
    decoded = codec.mdct.inverse_transform(recon)
    n = codec.mdct.filters_n
    wave_mse = jnp.mean((decoded[:, n:-n] - x) ** 2)
    thr_f = jnp.maximum(threshold, nmr_floor)
    nmr = jnp.mean(((recon - spec) / thr_f) ** 2)
    return wave_mse + nmr_weight * nmr


def make_train_step(
    codec: Codec,
    cfg: SpectralAE,
    mesh,
    optimizer=None,
    remat: bool = False,
    nmr_weight: float = 0.1,
    nmr_floor: float = 1e-3,
):
    """Jitted sharded train step: (params, opt_state, x, key) ->
    (params, opt_state, loss).

    Batches shard dp x sp (parallel.mesh.waveform_sharding); parameters
    replicate; the dp-mean gradient psum is GSPMD-inserted. ``remat``
    rematerializes the forward (jax.checkpoint) so the spectrum/threshold
    intermediates are not kept alive for the backward pass.
    """
    if optimizer is None:
        optimizer = optax.adam(1e-3)
    wave_sharding = _mesh.waveform_sharding(mesh)
    repl = _mesh.replicated(mesh)

    def loss_fn(params, x, key):
        return perceptual_loss(
            codec, cfg, params, x, key, nmr_weight, nmr_floor
        )

    if remat:
        loss_fn = jax.checkpoint(loss_fn)

    @functools.partial(
        jax.jit,
        in_shardings=(repl, repl, wave_sharding, repl),
        out_shardings=(repl, repl, repl),
        donate_argnums=(0, 1),
    )
    def train_step(params, opt_state, x, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step, optimizer
