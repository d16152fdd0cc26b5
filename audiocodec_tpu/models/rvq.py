"""Residual vector quantization over the spectral autoencoder latent.

The modern neural-codec bottleneck (SoundStream / EnCodec style): instead
of rounding each latent dimension to a scalar grid (spectral_ae's
``quantize_latents``), the WHOLE latent vector is matched against a
learned codebook, and the match repeats over the residual across a few
stages. A 64-dim latent at the scalar grid costs
``latent_n * log2(2/step)`` = 384 bits/frame; four RVQ stages of 1024
codewords cost 40 — an order of magnitude — at comparable distortion once
the codebooks are trained. The reference anticipates trainable bottlenecks
(its noise injection exists to "simulate quantization" differentiably —
reference audiocodec/psychoacoustic.py:151-167) but ships none; this is
the framework's production discrete-code path.

Accelerator-first design decisions:

* Nearest-codeword search is TWO matmuls, never a gather: scores are
  ``residual @ codebookᵀ`` ([M, D] @ [D, K]) and the selected codeword is
  ``one_hot(argmin) @ codebook`` ([M, K] @ [K, D]). A one-hot matmul
  is one GEMM on the tensor cores and is differentiable.
* The stage loop is a ``lax.scan`` over stacked codebooks ``[S, K, D]`` —
  one compiled body, S small (4-8), carries the residual.
* Codebooks learn by exponential-moving-average k-means (VQ-VAE-2), not
  gradients: per-stage assignment counts and vector sums are contractions
  over the batch axes, so under a dp-sharded batch GSPMD inserts the
  cross-device psum automatically — the EMA update is single-program.
* Dead codewords (EMA count below threshold) reseed from random batch
  vectors inside the same jit (no host round-trip).
* The straight-through estimator routes decoder gradients through the
  quantizer; a commitment term keeps the encoder near its codewords.

Discrete codes pack host-side at exactly ``S * log2(K)`` bits per frame
per channel (fixed-width — RVQ indices are near-uniform, so entropy
coding buys little without a learned prior).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax

from audiocodec_tpu.codec import Codec
from audiocodec_tpu.models import spectral_ae as _sae
from audiocodec_tpu.parallel import mesh as _mesh
from audiocodec_tpu.utils import dtypes as _dtypes


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[],
    meta_fields=[
        "stages", "codebook_size", "dim", "ema_decay", "reseed_threshold",
        "commitment_weight",
    ],
)
@dataclasses.dataclass(frozen=True)
class RVQ:
    """Static RVQ architecture config (leaf-free pytree, jit-static).

    :param stages: number of residual quantization stages S.
    :param codebook_size: codewords per stage K (power of two, so codes
        pack at fixed width).
    :param dim: latent vector dimension D (must equal the autoencoder's
        ``latent_n``).
    :param ema_decay: EMA k-means decay γ for counts and vector sums.
    :param reseed_threshold: EMA count below which a codeword is dead and
        reseeds from a random batch vector.
    :param commitment_weight: β of the encoder commitment loss
        ``β·mean((z − sg(q))²)``.
    """

    stages: int = 4
    codebook_size: int = 1024
    dim: int = 64
    ema_decay: float = 0.99
    reseed_threshold: float = 1.0
    commitment_weight: float = 0.25

    def __post_init__(self):
        if self.stages < 1:
            raise ValueError(f"stages must be >= 1, got {self.stages}")
        k = self.codebook_size
        if k < 2 or (k & (k - 1)) != 0:
            raise ValueError(
                f"codebook_size must be a power of two >= 2 (codes pack "
                f"at fixed bit width), got {k}"
            )

    @property
    def bits_per_index(self) -> int:
        return int(math.log2(self.codebook_size))

    def bits_per_frame(self) -> float:
        """Code size of one frame of one channel: S·log2(K)."""
        return self.stages * self.bits_per_index


def init_state(key, cfg: RVQ, compute_dtype=jnp.float32) -> dict:
    """Codebooks + EMA statistics as a flat dict pytree.

    Codebooks start at small random vectors (the first EMA updates snap
    them onto the data); EMA counts start at 1 so no codeword is born
    dead, and EMA sums start consistent (sum = count · codeword).
    """
    dtype = _dtypes.canonicalize_compute_dtype(compute_dtype)
    s, k, d = cfg.stages, cfg.codebook_size, cfg.dim
    codebooks = (
        jax.random.normal(key, (s, k, d), dtype=jnp.float32) * 0.1
    ).astype(dtype)
    # EMA state is always f32: counts/sums accumulate thousands of steps
    # and bf16's 8-bit mantissa would stall the running means. ema_sum =
    # count * codeword keeps mean == codeword at init; the multiply also
    # guarantees a DISTINCT buffer from codebooks (same-dtype astype is a
    # no-copy alias, which train_step's donation would reject).
    count = jnp.ones((s, k), jnp.float32)
    return {
        "codebooks": codebooks,
        "ema_count": count,
        "ema_sum": count[..., None] * codebooks.astype(jnp.float32),
    }


def _flatten_latents(z: jax.Array, dim: int) -> jax.Array:
    """[B, T, Z, C] (frames convention, channels last) -> [M, Z]."""
    if z.shape[-2] != dim:
        raise ValueError(
            f"latent axis {z.shape[-2]} != RVQ dim {dim}; RVQ.dim must "
            "equal the autoencoder's latent_n"
        )
    return jnp.moveaxis(z, -1, -2).reshape(-1, dim)


def _unflatten_latents(flat: jax.Array, shape) -> jax.Array:
    """[M, Z] -> [B, T, Z, C] matching ``shape``."""
    b, t, zdim, c = shape
    return jnp.moveaxis(flat.reshape(b, t, c, zdim), -1, -2)


def _nearest(residual: jax.Array, codebook: jax.Array):
    """One stage: indices + selected codewords via two matmuls.

    argmin over ‖r − c‖² drops the ‖r‖² constant: minimize
    ‖c‖² − 2·r·c. Scores accumulate in f32 (bf16 inputs would otherwise
    mis-rank near-ties)."""
    scores = jnp.einsum(
        "md,kd->mk", residual, codebook,
        preferred_element_type=jnp.float32,
    )
    sq = jnp.sum(
        codebook.astype(jnp.float32) ** 2, axis=-1
    )
    idx = jnp.argmin(sq[None, :] - 2.0 * scores, axis=-1)
    onehot = jax.nn.one_hot(idx, codebook.shape[0], dtype=residual.dtype)
    q = jnp.einsum(
        "mk,kd->md", onehot, codebook,
        preferred_element_type=jnp.float32,
    ).astype(residual.dtype)
    return idx.astype(jnp.int32), onehot, q


def quantize(cfg: RVQ, state: dict, z: jax.Array):
    """RVQ the latent with a straight-through estimator.

    :param z: [B, blocks, latent_n, C] autoencoder latents.
    :returns: (z_q, codes, commitment) — ``z_q`` has the quantized value
        and identity gradient; ``codes`` is int32 [B, blocks, C, S];
        ``commitment`` is the scalar β-weighted encoder commitment loss.
    """
    flat = _flatten_latents(z, cfg.dim)

    def stage_codes(residual, codebook):
        idx, _, q = _nearest(residual, codebook)
        return residual - q, idx

    final_residual, codes = jax.lax.scan(
        stage_codes, jax.lax.stop_gradient(flat), state["codebooks"]
    )
    quant = jax.lax.stop_gradient(flat) - final_residual  # sum of stages
    z_q_flat = flat + jax.lax.stop_gradient(quant - flat)  # STE
    z_q = _unflatten_latents(z_q_flat, z.shape)
    b, t, zdim, c = z.shape
    codes = jnp.moveaxis(codes, 0, -1).reshape(b, t, c, cfg.stages)
    commitment = cfg.commitment_weight * jnp.mean(
        (flat - jax.lax.stop_gradient(quant)) ** 2
    )
    return z_q, codes, commitment


def ema_update(cfg: RVQ, state: dict, z: jax.Array, key) -> dict:
    """One EMA k-means step of every stage's codebook from batch ``z``.

    Counts and sums contract over the batch axis; with ``z`` dp-sharded
    and the state replicated, GSPMD turns those contractions into psums —
    every device applies the identical global update. Dead codewords
    (EMA count < ``reseed_threshold``) reseed from random batch vectors.
    """
    flat = jax.lax.stop_gradient(_flatten_latents(z, cfg.dim)).astype(
        jnp.float32
    )
    m = flat.shape[0]
    decay = cfg.ema_decay

    def stage(residual, codebook):
        _, onehot, q = _nearest(
            residual.astype(codebook.dtype), codebook
        )
        oh32 = onehot.astype(jnp.float32)
        count = jnp.sum(oh32, axis=0)  # [K]  (psum under dp)
        vec_sum = jnp.einsum(
            "mk,md->kd", oh32, residual,
            preferred_element_type=jnp.float32,
        )
        return residual - q.astype(jnp.float32), (count, vec_sum)

    keys = jax.random.split(key, cfg.stages)
    _, (counts, sums) = jax.lax.scan(stage, flat, state["codebooks"])
    new_count = decay * state["ema_count"] + (1 - decay) * counts
    new_sum = decay * state["ema_sum"] + (1 - decay) * sums

    # Laplace-smoothed means; smoothing keeps near-empty codewords from
    # collapsing to huge vectors when their count underflows.
    n_total = jnp.sum(new_count, axis=-1, keepdims=True)
    k = cfg.codebook_size
    smoothed = (
        (new_count + 1e-5) / (n_total + k * 1e-5) * n_total
    )
    means = new_sum / smoothed[..., None]

    # Dead-code reseed: draw one random batch vector per codeword slot
    # (per stage) and splice it in where the EMA count says dead.
    def reseed(cb_mean, count, kk):
        pick = jax.random.randint(kk, (k,), 0, m)
        fresh = flat[pick]
        dead = (count < cfg.reseed_threshold)[:, None]
        return jnp.where(dead, fresh, cb_mean)

    reseeded = jax.vmap(reseed)(means, new_count, keys)
    dtype = state["codebooks"].dtype
    return {
        "codebooks": reseeded.astype(dtype),
        "ema_count": new_count,
        "ema_sum": new_sum,
    }


def decode_codes(cfg: RVQ, state: dict, codes: jax.Array) -> jax.Array:
    """int32 codes [B, blocks, C, S] -> latents [B, blocks, dim, C].

    The decode-side lookup is the same one-hot matmul per stage, summed."""
    onehot = jax.nn.one_hot(
        codes, cfg.codebook_size, dtype=state["codebooks"].dtype
    )  # [B, T, C, S, K]
    z = jnp.einsum(
        "btcsk,skd->btcd", onehot, state["codebooks"],
        preferred_element_type=jnp.float32,
    ).astype(state["codebooks"].dtype)
    return jnp.moveaxis(z, -1, -2)


def pack_codes(cfg: RVQ, codes) -> bytes:
    """Fixed-width bit-pack int codes host-side: S·log2(K) bits/frame.

    Layout: little-endian bit order within the flattened [B, T, C, S]
    index sequence; trailing bits of the final byte are zero."""
    bits = cfg.bits_per_index
    flat = np.asarray(codes, dtype=np.uint32).reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= cfg.codebook_size):
        raise ValueError("codes out of range for the codebook")
    bitmat = (flat[:, None] >> np.arange(bits, dtype=np.uint32)) & 1
    return np.packbits(
        bitmat.astype(np.uint8), bitorder="little"
    ).tobytes()


def unpack_codes(cfg: RVQ, data: bytes, shape) -> np.ndarray:
    """Inverse of :func:`pack_codes` for a known [B, T, C, S] shape."""
    bits = cfg.bits_per_index
    n = int(np.prod(shape))
    raw = np.frombuffer(data, dtype=np.uint8)
    bitmat = np.unpackbits(raw, bitorder="little")[: n * bits]
    if bitmat.size < n * bits:
        raise ValueError("truncated RVQ code payload")
    bitmat = bitmat.reshape(n, bits).astype(np.uint32)
    flat = (bitmat << np.arange(bits, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32
    )
    return flat.reshape(shape).astype(np.int32)


def perceptual_loss(
    codec: Codec,
    ae_cfg: _sae.SpectralAE,
    rvq_cfg: RVQ,
    params: dict,
    rvq_state: dict,
    x: jax.Array,
    nmr_weight: float = 0.1,
    nmr_floor: float = 1e-3,
    quantizer_gate=1.0,
):
    """Waveform MSE + NMR through codec chain, RVQ in the bottleneck.

    Same perceptual calibration as spectral_ae.perceptual_loss (the
    masking threshold of the ORIGINAL spectrum judges the error), but the
    bottleneck is the straight-through RVQ instead of noise relaxation,
    plus the commitment term. Returns (loss, z) — the pre-quantization
    latents feed the EMA update without a second encoder pass.

    :param quantizer_gate: 0.0 bypasses the quantizer (decoder sees the
        continuous latent, commitment off), 1.0 engages it. A traced
        scalar, so one compiled program serves the warmup schedule:
        engaging the quantizer at init drives the classic VQ cold-start
        collapse (the commitment term drags the encoder toward the
        near-zero random codebooks faster than EMA k-means can chase the
        latents, and the whole bottleneck settles at zero).
    """
    spec = codec.mdct.transform(x)
    tonality = codec.psycho.tonality(spec)
    threshold = codec.psycho.global_masking_threshold(spec, tonality)
    z = _sae.encode_frames(params, spec)
    z_q, _codes, commitment = quantize(rvq_cfg, rvq_state, z)
    gate = jnp.asarray(quantizer_gate, z.dtype)
    z_q = z + gate * (z_q - z)  # STE already rides z's gradient
    commitment = gate * commitment
    recon = _sae.decode_frames(params, z_q)
    decoded = codec.mdct.inverse_transform(recon)
    n = codec.mdct.filters_n
    wave_mse = jnp.mean((decoded[:, n:-n] - x) ** 2)
    # ~-60 dB floor; at the raw quiet-threshold scale the loss optimum
    # is a collapsed all-zero decoder (see spectral_ae.perceptual_loss)
    thr_f = jnp.maximum(threshold, nmr_floor)
    nmr = jnp.mean(((recon - spec) / thr_f) ** 2)
    return wave_mse + nmr_weight * nmr + commitment, z


def make_train_step(
    codec: Codec,
    ae_cfg: _sae.SpectralAE,
    rvq_cfg: RVQ,
    mesh,
    optimizer=None,
    remat: bool = False,
    nmr_weight: float = 0.1,
    nmr_floor: float = 1e-3,
    warmup_steps: int = 0,
):
    """Jitted sharded joint step: (params, rvq_state, opt_state, x, key,
    step) -> (params, rvq_state, opt_state, loss).

    Autoencoder parameters move by Adam on the perceptual loss (the STE
    carries decoder gradients through the quantizer; the commitment term
    pulls the encoder toward its codewords); codebooks move by the EMA
    k-means update in the SAME program — batches shard dp×sp, the EMA's
    batch contractions psum across devices, and all state stays replicated
    and bit-identical on every device.

    :param warmup_steps: for ``step < warmup_steps`` the decoder trains
        on the CONTINUOUS latent while EMA k-means fits the codebooks to
        the live latent distribution; the quantizer then engages with
        codebooks already on the data. Without warmup, joint training
        from scratch collapses the bottleneck (see perceptual_loss).
        ``step`` is a traced int32 scalar — one compiled program covers
        both phases.
    """
    if optimizer is None:
        optimizer = optax.adam(1e-3)
    wave_sharding = _mesh.waveform_sharding(mesh)
    repl = _mesh.replicated(mesh)

    def loss_fn(params, rvq_state, x, gate):
        loss, z = perceptual_loss(
            codec, ae_cfg, rvq_cfg, params, rvq_state, x, nmr_weight,
            nmr_floor, quantizer_gate=gate,
        )
        return loss, z

    if remat:
        loss_fn = jax.checkpoint(loss_fn)

    @functools.partial(
        jax.jit,
        in_shardings=(repl, repl, repl, wave_sharding, repl, repl),
        out_shardings=(repl, repl, repl, repl),
        donate_argnums=(0, 1, 2),
    )
    def train_step(params, rvq_state, opt_state, x, key, step):
        gate = (step >= warmup_steps).astype(jnp.float32)
        (loss, z), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, rvq_state, x, gate
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        rvq_state = ema_update(rvq_cfg, rvq_state, z, key)
        return params, rvq_state, opt_state, loss

    return train_step, optimizer


def encode_discrete(
    codec: Codec,
    ae_cfg: _sae.SpectralAE,
    rvq_cfg: RVQ,
    params: dict,
    rvq_state: dict,
    x: jax.Array,
):
    """Waveform -> int32 RVQ codes [B, blocks+1, C, S] (inference)."""
    spec = codec.mdct.transform(x)
    z = _sae.encode_frames(params, spec)
    _, codes, _ = quantize(rvq_cfg, rvq_state, z)
    return codes


def decode_discrete(
    codec: Codec,
    ae_cfg: _sae.SpectralAE,
    rvq_cfg: RVQ,
    params: dict,
    rvq_state: dict,
    codes: jax.Array,
):
    """int32 RVQ codes -> waveform [B, samples, C] (inference)."""
    z = decode_codes(rvq_cfg, rvq_state, codes)
    recon = _sae.decode_frames(params, z)
    return codec.mdct.inverse_transform(recon)
