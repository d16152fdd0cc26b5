"""Temporal noise shaping (TNS) — pre-echo control without block switching.

A transient inside an MDCT frame makes quantization noise audible BEFORE
the attack (pre-echo): the synthesis window spreads the frame's noise
uniformly across its 2N samples, while the attack only masks what follows
it. The AAC-family fix (Herre & Johnston 1996; ISO/IEC 13818-7 §14) is
open-loop linear prediction ALONG FREQUENCY: a frame whose time envelope
is peaky has strongly correlated MDCT coefficients across bins (duality:
peaky in time <=> smooth/predictable in frequency), so an order-p
predictor A(z) run over the frequency axis whitens the coefficients
before quantization; the decoder runs the inverse filter 1/A(z), which
re-imposes the time envelope on everything in the frame — INCLUDING the
quantization noise, concentrating it under the attack where it is masked.
The reference has no transient handling at all (its encode is
MDCT -> threshold -> noise -> iMDCT, /root/reference/audiocodec); this
module is framework-added surface on the coded-bitstream paths.

Accelerator-friendly shape: every stage is static-shape and batched over
(batch, frame, channel) lanes with the fixed filter order unrolled —
autocorrelation is p+1 fused multiply-reduces over the band,
Levinson-Durbin is p unrolled vectorized steps, the encoder filter is p
shifted fused multiply-adds along frequency, and the decoder filter is a
``lax.scan`` over frequency bins carrying a [lanes, p] state (unrolled
8x to amortize step overhead). Enable/disable is a per-(frame, channel)
``where`` on the coefficient indices — no data-dependent control flow.

Wire format: the container carries ONLY the int8 reflection-coefficient
indices (shape [B, frames, order, C]; ``0`` everywhere = identity filter,
so disabled frames cost nothing after deflate). Both sides rebuild the
LPC taps from the DEQUANTIZED reflection coefficients, so encoder and
decoder apply exactly inverse filters by construction. |k| < 1 for every
representable index, which guarantees the decoder's all-pole filter is
stable (Levinson step-up preserves minimum phase).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax

# Fixed filter order. 8 covers the envelope detail order-20 AAC filters
# chase while keeping the sidecar at 8 bytes/frame/channel pre-deflate.
ORDER = 8

# Reflection coefficients are quantized uniformly in the arcsine domain
# (denser near |k|=1 where the filter is most sensitive): 4-bit signed
# indices in [-QMAX, QMAX], k = sin(idx * pi/2 / (QMAX + 1)).
QMAX = 7
_QSTEP = (math.pi / 2.0) / (QMAX + 1)

# Step-size normalization exponent — part of the wire format. The
# decoder's all-pole filter amplifies in-band quantization noise power by
# the prediction gain G = 1/prod(1 - k_i^2) (the closed-form impulse-
# response energy of 1/A for reflection coefficients k). Scaling the
# in-band step sizes by (1/sqrt(G))^gamma compensates: gamma=1 preserves
# the unfiltered noise power exactly; gamma=0 keeps raw steps (max rate
# saving, noise grows by G). Matched-rate sweeps on a click train over a
# tonal bed (docs/DESIGN.md §12) put gamma=0.75 at equal-or-better SNR
# than TNS-off at EVERY rate with 2-3x lower pre-echo energy — gamma=1
# gives up ~0.2 dB at low rates, gamma=0 up to 1.2 dB at high rates.
STEP_SCALE_EXP = 0.75


def default_band_start(filters_n: int) -> int:
    """First bin the filter covers. Below ~1.3 kHz (bin N/16 at 44.1 kHz,
    N=1024) temporal masking is long enough that pre-echo is inaudible and
    prediction would spend its gain on the strongest tonal partials."""
    return max(ORDER + 1, filters_n // 16)


def _work_dtype(spec: jax.Array):
    # Filter math runs in f32 (bf16 spectra upcast: an 8-tap recurrence
    # in bf16 loses ~2 decimal digits), except f64 pipelines stay f64 —
    # the x64 test configuration must not round-trip through f32.
    return jnp.float64 if spec.dtype == jnp.float64 else jnp.float32


def _lanes_last(spec: jax.Array, band_start: int) -> jax.Array:
    # [B, F, N, C] -> [B, F, C, M] band view (frequency last so the
    # per-bin ops below are contiguous lane math)
    band = spec[..., band_start:, :]
    return jnp.moveaxis(band, -2, -1).astype(_work_dtype(spec))


def analyze(spec: jax.Array, band_start: int, *, order: int = ORDER,
            gain_min: float = 1.25) -> jax.Array:
    """Per-frame TNS analysis -> quantized reflection-coefficient indices.

    :param spec: MDCT spectra [B, frames, N, C] (the domain that will be
        quantized — after any mid/side rotation).
    :param band_start: first bin the filter covers (see
        :func:`default_band_start`).
    :param gain_min: prediction-gain gate; frames whose order-p gain
        r[0]/err is below it transmit all-zero indices (identity filter).
        1.25 ~= 1 dB of whitening — below that the sidecar + noise-shape
        churn isn't worth it.
    :return: int8 [B, frames, order, C] indices in [-QMAX, QMAX].
    """
    if spec.shape[-2] - band_start <= order:
        raise ValueError(
            f"TNS band ({spec.shape[-2]} - {band_start}) must exceed the "
            f"filter order {order}"
        )
    s = _lanes_last(spec, band_start)  # [B, F, C, M] f32
    m = s.shape[-1]
    # autocorrelation over the band, lags 0..p (f32; the analysis only
    # steers the quantized filter, it is not bitstream-critical)
    r = [jnp.sum(s * s, axis=-1)]
    for i in range(1, order + 1):
        r.append(jnp.sum(s[..., : m - i] * s[..., i:], axis=-1))
    # white-noise correction keeps Levinson regular on silent/flat frames
    r0 = r[0] * (1.0 + 1e-6) + 1e-20
    # Levinson-Durbin, order unrolled, vectorized over [B, F, C]
    err = r0
    a: list[jax.Array] = []  # a[j] holds coefficient a_{j+1}
    ks = []
    for i in range(1, order + 1):
        acc = r[i]
        for j in range(1, i):
            acc = acc + a[j - 1] * r[i - j]
        k = -acc / err
        k = jnp.clip(k, -0.999, 0.999)
        new_a = [a[j] + k * a[i - 2 - j] for j in range(i - 1)]
        a = new_a + [k]
        err = err * (1.0 - k * k)
        ks.append(k)
    gain = r0 / jnp.maximum(err, 1e-30)
    enable = gain > gain_min  # [B, F, C]
    kq = jnp.stack(ks, axis=-1)  # [B, F, C, p]
    idx = jnp.clip(
        jnp.round(jnp.arcsin(kq) / _QSTEP), -QMAX, QMAX
    ).astype(jnp.int8)
    idx = jnp.where(enable[..., None], idx, jnp.int8(0))
    return jnp.moveaxis(idx, -1, -2)  # [B, F, p, C]


def lpc_from_indices(idx: jax.Array) -> jax.Array:
    """Dequantize reflection indices and step up to LPC taps.

    :param idx: int8 [B, frames, order, C].
    :return: f32 [B, frames, order, C] taps a_1..a_p of
        A(z) = 1 + sum_i a_i z^-i. All-zero indices give all-zero taps
        (identity filter) exactly.
    """
    k = jnp.sin(idx.astype(jnp.float32) * _QSTEP)  # [B, F, p, C]
    order = k.shape[-2]
    a: list[jax.Array] = []
    for i in range(1, order + 1):
        ki = k[..., i - 1, :]
        new_a = [a[j] + ki * a[i - 2 - j] for j in range(i - 1)]
        a = new_a + [ki]
    return jnp.stack(a, axis=-2)  # [B, F, p, C]


def scaled_threshold(threshold: jax.Array, idx: jax.Array,
                     band_start: int) -> jax.Array:
    """Noise-gain-compensated quantization thresholds for TNS frames.

    Both encoder (quantize) and decoder (dequantize) derive step sizes
    from THIS function so they stay bit-identical — the scale is a pure
    function of the transmitted indices. All-zero indices multiply by
    exactly 1.0, so non-fired frames keep their unfiltered steps.

    :param threshold: [B, F, N, C] masking threshold (already including
        any rate-control scale).
    """
    k = jnp.sin(idx.astype(jnp.float32) * _QSTEP)  # [B, F, p, C]
    inv_gain = jnp.sqrt(jnp.prod(1.0 - k * k, axis=-2, keepdims=True))
    c = (inv_gain ** STEP_SCALE_EXP).astype(threshold.dtype)  # [B, F, 1, C]
    return jnp.concatenate(
        [threshold[..., :band_start, :], threshold[..., band_start:, :] * c],
        axis=-2,
    )


def filter_forward(spec: jax.Array, idx: jax.Array,
                   band_start: int) -> jax.Array:
    """Encoder filter: e[k] = s[k] + sum_i a_i s[k-i] along frequency,
    zero history at the band edge. Bins below ``band_start`` pass through.
    p shifted fused multiply-adds — XLA fuses the whole band update."""
    wdt = _work_dtype(spec)
    a = lpc_from_indices(idx).astype(wdt)  # [B, F, p, C]
    band = spec[..., band_start:, :].astype(wdt)  # [B, F, M, C]
    out = band
    for i in range(1, a.shape[-2] + 1):
        shifted = jnp.pad(band[..., : band.shape[-2] - i, :],
                          ((0, 0), (0, 0), (i, 0), (0, 0)))
        out = out + a[..., i - 1 : i, :] * shifted
    return jnp.concatenate(
        [spec[..., :band_start, :],
         out.astype(spec.dtype)], axis=-2)


def filter_inverse(spec: jax.Array, idx: jax.Array,
                   band_start: int) -> jax.Array:
    """Decoder filter: s[k] = e[k] - sum_i a_i s[k-i] — the exact inverse
    recurrence of :func:`filter_forward` (an all-pole scan along
    frequency, stable because every representable |k| < 1)."""
    wdt = _work_dtype(spec)
    a = lpc_from_indices(idx).astype(wdt)  # [B, F, p, C]
    order = a.shape[-2]
    band = spec[..., band_start:, :].astype(wdt)  # [B, F, M, C]
    e = jnp.moveaxis(band, -2, 0)  # [M, B, F, C]
    a_scan = jnp.moveaxis(a, -2, 0)  # [p, B, F, C]

    def step(state, e_k):
        # state: [p, B, F, C] = s[k-1], ..., s[k-p]
        y = e_k - jnp.sum(a_scan * state, axis=0)
        return jnp.concatenate([y[None], state[:-1]], axis=0), y

    state0 = jnp.zeros_like(a_scan)
    _, s = lax.scan(step, state0, e, unroll=8)
    out = jnp.moveaxis(s, 0, -2)  # [B, F, M, C]
    return jnp.concatenate(
        [spec[..., :band_start, :],
         out.astype(spec.dtype)], axis=-2)
