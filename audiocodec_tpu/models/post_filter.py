"""MDCT-domain neural post-filter: enhance decoded spectra.

The decoder-side counterpart of models/spectral_ae.py, following the
MDCT-domain post-filter pattern of the coded-speech enhancement
literature (e.g. arXiv:2201.12039): a small residual network runs on the
DEQUANTIZED spectrum — after entropy decoding, before the inverse MDCT —
and predicts a correction that pushes quantization noise back under the
masking threshold. Uniquely to a codec (vs blind denoising), the decoder
KNOWS the per-band quantization step size ``delta`` (it derives it from
the transmitted sidecar), so the filter is conditioned on the exact noise
magnitude of every bin.

Shape choices match the autoencoder family: the band axis is the only
contraction (each layer is one [B·T·C, ·] @ [·, H] matmul; blocks
stay a batch dim). Unlike the autoencoder, the ±1-frame temporal context
shifts along the blocks axis, so ``sp`` sharding incurs a one-frame halo
(a GSPMD-inserted collective-permute — the same class as the MDCT fold's
own halo, and equally cheap). The output head is
ZERO-initialized: the untrained filter is exactly the identity, so
enhancement can only be learned, never regressed into by init noise.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import optax

from audiocodec_tpu import quantize as _quantize
from audiocodec_tpu.codec import Codec
from audiocodec_tpu.parallel import mesh as _mesh
from audiocodec_tpu.utils import dtypes as _dtypes


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[],
    meta_fields=["filters_n", "hidden_n"],
)
@dataclasses.dataclass(frozen=True)
class PostFilter:
    """Static architecture config.

    :param filters_n: MDCT filter bands N.
    :param hidden_n: hidden width of the residual MLP.
    """

    filters_n: int = 1024
    hidden_n: int = 512


def init_params(key, cfg: PostFilter, compute_dtype=jnp.float32) -> dict:
    """He-init hidden layer; ZERO-init output head (identity start)."""
    dtype = _dtypes.canonicalize_compute_dtype(compute_dtype)
    n, h = cfg.filters_n, cfg.hidden_n
    w1 = jax.random.normal(key, (4 * n, h), dtype=jnp.float32)
    return {
        "w1": (w1 * (2.0 / (4 * n)) ** 0.5).astype(dtype),
        "b1": jnp.zeros((h,), dtype),
        "w2": jnp.zeros((h, n), dtype),
        "b2": jnp.zeros((n,), dtype),
    }


def _delta_features(delta: jax.Array) -> jax.Array:
    """Per-bin noise-magnitude conditioning: log10(delta), squashed to
    O(1) (deltas span ~[1e-12, 1])."""
    return jnp.log(jnp.maximum(delta, 1e-12)) * (1.0 / (12.0 * 2.302585))


def apply(cfg: PostFilter, params: dict, spec_q: jax.Array,
          delta: jax.Array) -> jax.Array:
    """Enhanced spectrum = spec_q + residual(spec_q, delta).

    :param spec_q: dequantized spectrum [B, blocks, N, C].
    :param delta: per-bin quantization step sizes, same shape (the decoder
        derives these from the transmitted sidecar — quantize.step_size).
    """
    # +-1 frame of temporal context: quantization noise is independent
    # across frames while tonal content is strongly correlated, so the
    # filter can average it down — the per-bin prior alone (cell-centroid
    # shrinkage) is worth far less.
    prev = jnp.concatenate([spec_q[:, :1], spec_q[:, :-1]], axis=1)
    nxt = jnp.concatenate([spec_q[:, 1:], spec_q[:, -1:]], axis=1)
    feats = jnp.concatenate(
        [prev, spec_q, nxt, _delta_features(delta).astype(spec_q.dtype)],
        axis=2,
    )
    hidden = jax.nn.gelu(
        jnp.einsum(
            "btnc,nh->bthc", feats, params["w1"],
            preferred_element_type=jnp.float32,
        ).astype(spec_q.dtype)
        + params["b1"][None, None, :, None]
    )
    resid = jnp.einsum(
        "bthc,hn->btnc", hidden, params["w2"],
        preferred_element_type=jnp.float32,
    ).astype(spec_q.dtype) + params["b2"][None, None, :, None]
    # The correction is expressed in units of the quantization step: the
    # true error of every bin lies in [-delta/2, delta/2], so scaling by
    # delta bounds what the network can (and needs to) do per bin and
    # keeps optimizer steps proportionate to the noise being removed.
    return spec_q + resid * delta.astype(spec_q.dtype)


def enhancement_loss(
    codec: Codec, cfg: PostFilter, params: dict, x: jax.Array,
    nmr_weight: float = 0.1, threshold_scale: float = 1.0,
) -> jax.Array:
    """Train against the REAL quantized codec: encode x, enhance the
    dequantized spectrum, and score the decoded waveform + the residual
    noise-to-mask ratio against the clean original.

    :param threshold_scale: quantize coarser than nominal (the rate
        controller's low-bitrate regime — where a post-filter has real
        structure to restore; at nominal scale the codec is already
        transparent-ish and there is little to gain).
    """
    spec = codec.mdct.transform(x)
    tonality = codec.psycho.tonality(spec)
    threshold = codec.psycho.global_masking_threshold(spec, tonality)
    threshold = threshold * jnp.asarray(threshold_scale, threshold.dtype)
    codes, delta = _quantize.quantize(spec, threshold)
    spec_q = _quantize.dequantize(codes, delta, dtype=spec.dtype)
    enhanced = apply(cfg, params, spec_q, delta)
    decoded = codec.mdct.inverse_transform(enhanced)
    n = codec.mdct.filters_n
    wave_mse = jnp.mean((decoded[:, n:-n] - x) ** 2)
    # NMR with a floored denominator: near-silent bins have thresholds
    # down at the quiet floor (~1e-9 amplitude), and dividing a learned
    # residual by them explodes the gradients (observed divergence);
    # perceptually those bins contribute nothing to begin with.
    thr_f = jnp.maximum(threshold, jnp.asarray(1e-5, threshold.dtype))
    nmr = jnp.mean(((enhanced - spec) / thr_f) ** 2)
    return wave_mse + nmr_weight * nmr


def make_train_step(
    codec: Codec, cfg: PostFilter, mesh, optimizer=None,
    remat: bool = False, nmr_weight: float = 0.1,
    threshold_scale: float = 1.0,
):
    """Jitted sharded train step: (params, opt_state, x) ->
    (params, opt_state, loss). Batches shard dp x sp, params replicate.
    Train at the ``threshold_scale`` (bitrate regime) the filter will
    serve at."""
    if optimizer is None:
        optimizer = optax.adam(1e-3)
    wave_sharding = _mesh.waveform_sharding(mesh)
    repl = _mesh.replicated(mesh)

    def loss_fn(params, x):
        return enhancement_loss(
            codec, cfg, params, x, nmr_weight, threshold_scale
        )

    if remat:
        loss_fn = jax.checkpoint(loss_fn)

    @functools.partial(
        jax.jit,
        in_shardings=(repl, repl, wave_sharding),
        out_shardings=(repl, repl, repl),
        donate_argnums=(0, 1),
    )
    def train_step(params, opt_state, x):
        loss, grads = jax.value_and_grad(loss_fn)(params, x)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step, optimizer


def decode_enhanced(codec: Codec, cfg: PostFilter, params: dict,
                    codes: jax.Array, delta: jax.Array) -> jax.Array:
    """Decoder-side integration: dequantize -> post-filter -> inverse MDCT
    (one jittable program; drop-in for Codec.decode_quantized)."""
    spec_q = _quantize.dequantize(
        codes, delta, dtype=codec.mdct.compute_dtype
    )
    return codec.mdct.inverse_transform(
        apply(cfg, params, spec_q, delta.astype(codec.mdct.compute_dtype))
    )
