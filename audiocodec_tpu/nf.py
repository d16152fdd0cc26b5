"""Noise filling — spectral-hole repair for low-rate bitstreams.

At aggressive rates the dead-zone quantizer zeroes long runs of
above-audibility bins (the threshold scale pushed the step past their
amplitude), which decodes as "spectral holes": a dull, swirly timbre that
raw SNR barely sees but ears do. The codec-standard fix (AAC PNS /
USAC noise filling) is to transmit a tiny per-frame noise level and have
the DECODER re-synthesize the zeroed bins with shaped noise — the
spectrum's energy envelope is restored for ~1 byte/frame/channel, since
noise-like content needs only the right power, not the right phase. The
reference has no quantizer at all (its "encode" is noise injection over
EVERY bin — /root/reference/audiocodec/psychoacoustic.py:151-167); this
module is framework-added surface on the coded-bitstream paths, and is in
spirit the reference's own noise model applied *selectively* where the
bitstream lost the content.

Accelerator-friendly shape: the encoder-side level analysis is two masked
fused multiply-reduces per frame; the decoder fill is one PRNG tensor,
one compare, and one fused multiply-add — no gather, no sort, no
data-dependent shapes.

Wire format: uint8 levels per (frame, channel), log-coding the noise
half-width in units of each bin's own quantization step — so the fill
rides the SAME step-size derivation both sides already agree on
(bit-identical thresholds), and silence/no-hole frames transmit 0
(deflates to nothing).
The fill noise is drawn per GLOBAL frame index (``jax.random.fold_in``
of a seed carried in the container), so a chunked .acs decode, a
mid-stream seek, and a monolithic .acz decode of the same signal all
reconstruct bit-identical waveforms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from audiocodec_tpu.utils import dtypes as _dtypes

# Levels are log-coded: level 0 = no fill, else the noise half-width in
# units of the bin's step size is a = 2^((level - LEVEL_BIAS) / LEVEL_K).
# The RATIO a spans ~15 octaves in practice (at mild scales holes sit
# just under the zero bin, a ~ 0.5; at aggressive scales the energy-
# matched ratio collapses to 1e-4 yet still carries audible absolute
# energy because the steps are huge) — a linear uint8 step cannot hold
# that range. K=16 gives 0.38 dB resolution; levels 1..255 span
# a in [2^-14.9, 2^0.94].
LEVEL_K = 16.0
LEVEL_BIAS = 240.0


def level_to_amp(levels: jax.Array, dtype) -> jax.Array:
    """uint8 levels -> noise half-width in step units (0 stays 0)."""
    lv = levels.astype(dtype)
    amp = jnp.exp2((lv - dtype.type(LEVEL_BIAS)) / dtype.type(LEVEL_K))
    return jnp.where(lv > 0, amp, 0.0)


def default_band_start(filters_n: int) -> int:
    """First bin the fill covers. Below ~1.3 kHz (bin N/16 at 44.1 kHz,
    N=1024) holes are rare (strong tonal content keeps steps small) and
    injected low-frequency noise reads as rumble, not texture."""
    return filters_n // 16


def _check_band(band_start: int, band_end: int) -> None:
    """The fill band must be non-empty — an INVERTED band (band_end <=
    band_start, e.g. a bwe crossover below the fill's start at extreme
    sample-rate/filters_n combinations) would make fill() concatenate a
    wrong-width spectrum: the encoder would happily write a container
    its own decoder crashes on. Both sides share this check, so the
    encode fails loudly instead."""
    if band_end <= band_start:
        raise ValueError(
            f"noise-fill band is empty: band_start={band_start} >= "
            f"band_end={band_end} (with bandwidth extension the bwe "
            "crossover caps the fill band — this configuration puts it "
            "at or below the fill's start; disable --nf or --bwe, or "
            "change filters_n/sample_rate)"
        )


def _work_dtype(spec: jax.Array):
    # ONE shared definition across nf/bwe/intensity (utils.dtypes)
    return _dtypes.sidecar_work_dtype(spec)


def analyze(spec: jax.Array, codes: jax.Array, delta: jax.Array,
            band_start: int, *, deadzone: float = 0.5,
            band_end: int | None = None,
            exclude: jax.Array | None = None) -> jax.Array:
    """Per-(frame, channel) fill level from the encoder's zeroed residual.

    The level is the uniform-noise half-width ``a`` (in units of each
    bin's step size) whose TOTAL power matches the total energy the
    quantizer zeroed: a = sqrt(3 * sum(x^2) / sum(delta^2)) over the
    zeroed in-band bins. The fill is therefore threshold-shaped (each
    bin gets noise proportional to its own step size — constant
    audibility relative to the masking floor) at exactly the lost
    energy. NOT the per-bin-relative mean sqrt(3*mean((x/delta)^2)):
    that estimator is dominated by near-threshold holes and pours their
    relative level into genuinely empty bins whose absolute step is
    large — measured +26 dB band-energy overshoot on a tone+noise mix
    (the energy-matched form reconstructs band energy to within ~1 dB).
    Digital silence gives a = 0 (no fill) naturally; ``a`` is capped at
    sqrt(3) * deadzone — the residual bound of the zero bin — so the fill
    can never exceed the energy the zero bin may legally hide.

    :param spec: the spectrum the quantizer saw (post mid/side rotation,
        post TNS filter) [B, frames, N, C].
    :param codes: the integer codes quantize() produced from it.
    :param delta: the step sizes quantize() used (threshold-scale and
        TNS-gain included).
    :param band_end: one past the last bin the fill covers (None = the
        full band). Bandwidth extension (bwe.py) owns [bwe_start, N)
        when active, so both sides cap the noise fill there.
    :param exclude: static bool [N, C] mask of bins some OTHER mechanism
        owns (intensity.owned_mask when intensity stereo is active):
        excluded zero bins are neither metered here nor filled by
        fill(). Without it the analyzer would count deliberately-dropped
        side content as holes and pour noise over the pan-reconstructed
        image. Both sides must pass the same mask (derived from the
        container's recorded crossover).
    :return: uint8 [B, frames, C] levels in LEVEL_STEP units.
    """
    wdt = _work_dtype(spec)
    end = spec.shape[-2] if band_end is None else band_end
    _check_band(band_start, end)
    s = spec[..., band_start:end, :].astype(wdt)
    d = delta[..., band_start:end, :].astype(wdt)
    zero = (codes[..., band_start:end, :] == 0).astype(wdt)
    if exclude is not None:
        zero = zero * (~jnp.asarray(exclude)[band_start:end, :]).astype(
            wdt
        )
    cnt = jnp.sum(zero, axis=-2)  # [B, F, C]
    e_lost = jnp.sum(jnp.square(s) * zero, axis=-2)
    e_cap = jnp.sum(jnp.square(d) * zero, axis=-2)
    a = jnp.sqrt(3.0 * e_lost / jnp.maximum(e_cap, 1e-30))
    a = jnp.minimum(a, jnp.asarray(3.0**0.5 * deadzone, wdt))
    level = jnp.round(LEVEL_BIAS + LEVEL_K * jnp.log2(jnp.maximum(a, 1e-30)))
    # keep everything the wire can represent: at aggressive threshold
    # scales the RATIO collapses (steps are huge) while the absolute
    # lost energy stays audible — a "too small to matter" cutoff above
    # the representable floor measurably re-opens spectral holes
    level = jnp.where((cnt > 0) & (a > 2.0 ** ((1 - LEVEL_BIAS) / LEVEL_K)),
                      level, 0.0)
    return jnp.clip(level, 0, 255).astype(jnp.uint8)


def fill(spec: jax.Array, codes: jax.Array, delta: jax.Array,
         levels: jax.Array, band_start: int, seed,
         frame_offset=0, band_end: int | None = None,
         exclude: jax.Array | None = None) -> jax.Array:
    """Decoder fill: add uniform noise of half-width
    ``level_to_amp(level) * delta`` to every in-band zero-code bin.

    Noise is drawn per (batch, GLOBAL frame) key — ``fold_in(fold_in(
    key(seed), batch), frame_offset + frame)`` — so the same frame gets
    the same noise no matter how the stream was chunked or where a seek
    entered it. The noise RMS is level*step/sqrt(3) <= deadzone*threshold*
    scale/sqrt(3): at or below the very noise budget the masking model
    allots the bin, so the fill stays inaudible as noise.

    :param spec: dequantized spectrum [B, F, N, C] (before the TNS
        inverse filter and the mid/side derotation — the fill happens in
        the coded domain, where ``delta`` is defined).
    :param levels: uint8 [B, F, C] from :func:`analyze` (the container's
        ``nfl`` member).
    :param seed: int32 noise seed (the container's recorded value) —
        traced or static.
    :param frame_offset: global index of ``spec``'s first frame (chunked
        decoders pass their running frame count; monolithic decoders 0).
    :param band_end: one past the last filled bin (None = the full band);
        must MATCH the encoder's analyze() cap — with bandwidth extension
        active both sides use bwe_start, derived from the container.
        The noise tensor's shape depends on it, so a mismatched cap would
        also desync the fill noise of bins below it.
    :param exclude: static bool [N, C] bins another mechanism owns —
        must MATCH the encoder's analyze() mask (see there). The noise
        DRAW is unaffected (same tensor shape), only the write mask, so
        unexcluded bins keep bit-identical noise either way.
    :return: spectrum with holes filled, same shape/dtype as ``spec``.
    """
    b_n, f_n, n_bins, c_n = spec.shape
    end = n_bins if band_end is None else band_end
    _check_band(band_start, end)
    band = spec[..., band_start:end, :]
    m = band.shape[-2]
    key = jax.random.key(jnp.asarray(seed, jnp.uint32))

    def frame_noise(kb, f):
        return jax.random.uniform(
            jax.random.fold_in(kb, f), (m, c_n), band.dtype, -1.0, 1.0
        )

    def batch_noise(b):
        kb = jax.random.fold_in(key, b)
        return jax.vmap(lambda f: frame_noise(kb, f))(
            frame_offset + jnp.arange(f_n)
        )

    noise = jax.vmap(batch_noise)(jnp.arange(b_n))  # [B, F, M, C]
    amp = level_to_amp(levels, band.dtype)
    amp = amp[..., None, :] * delta[..., band_start:end, :].astype(band.dtype)
    hole = codes[..., band_start:end, :] == 0
    if exclude is not None:
        hole = hole & ~jnp.asarray(exclude)[band_start:end, :]
    band = band + jnp.where(hole, noise * amp, 0.0)
    return jnp.concatenate(
        [spec[..., :band_start, :], band, spec[..., end:, :]], axis=-2
    )
