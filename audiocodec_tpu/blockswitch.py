"""Block switching: per-frame long/short transform selection for transients.

The classic pre-echo weapon besides TNS (tns.py): when a frame contains an
attack, quantization noise of the long transform smears over the whole
2N-sample span — audible BEFORE the attack, where there is nothing to mask
it. AAC switches the filter bank to eight short windowed MDCTs for such
frames ("EIGHT_SHORT"). This module is the batched, static-shape formulation of the
same idea, exploiting a structural property of this codec's filter bank:

**The long and short representations are one orthogonal matrix apart.**
This MDCT's polyphase fold is *exactly* invertible per frame (the window-
completion rule makes the diamond fold matrix invertible — ops/folding.py;
reference audiocodec/mdctransformer.py:217-226 carries the same property),
so perfect reconstruction never depends on overlap-add window conditions.
The long spectrum of frame t is  y = O_N f / s  with O_N the orthonormal
DCT-IV and f the folded frame. Re-transforming the SAME folded frame with
a block-diagonal bank of ``factor`` orthonormal DCT-IVs of size
M = N/factor gives a short-time representation

    y_short = BD(O_M) f / s = [BD(O_M) @ O_N] y = T y,       T orthogonal.

Each short sub-spectrum covers one M-sample segment of the folded frame,
and the fold maps every folded sample to <= 2 output samples — so
quantization noise added in sub-block s of a short frame lands in a
~2M-sample window instead of ~2N: the pre-echo span shrinks by
``factor`` (46 ms -> 5.8 ms at N=1024, factor=8, 44.1 kHz — under the
~15 ms pre-masking horizon).

Because T is a plain orthogonal change of basis applied AFTER the
standard transform, block switching composes with every MDCT lowering
(sparse / dense / Pallas kernels untouched), the psycho model keeps
operating on the long spectrum (which it needs anyway — the Bark sidecar
is unchanged), and the per-frame choice is one jnp.where — no
data-dependent control flow, fully batched.

Honest difference from AAC: the eight sub-transforms act on the *folded*
frame with rectangular segment boundaries rather than on re-windowed time
samples, so short frames trade some stop-band attenuation for the exact-
reconstruction and composability properties above. Short frames are only
selected on transients, where tonality is low and temporal resolution —
not leakage — is what matters.

Bitstream contract: the per-frame flags ride the container (they are as
bit-critical as the sidecar — the decoder must invert the same basis and
derive the same pooled thresholds). Threshold pooling (`pool_threshold`)
is elementwise reshape/mean/sqrt — deterministic, no matmul-precision
caveat. The T matmul itself is encoder/decoder-local (not a shared
derivation): its lowering precision affects only the codes one end
produces / the spectrum the other reconstructs, never a cross-end
derivation — exactly like dct_precision — so it FOLLOWS the codec's
precision ladder ("int8" maps to one-pass float: the switched input is
spectra, where flat per-row int8 error is the measured failure mode —
docs/DESIGN.md §3c). At the default "highest" this is the same pinning
as ops/dct.py; at one-pass it cuts the feature's matmul cost.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from audiocodec_tpu.ops import dct as _dct

FACTOR = 8  # sub-blocks per short frame (AAC's eight-short)

# Loud/quiet contrast above which a frame goes short: the loudest
# sub-block's energy exceeds the mean of the 3 quietest sub-blocks'
# by this factor (30 = ~15 dB). The fold mirrors time around the block
# center, so time ORDER is not preserved in the folded envelope — an
# onset/offset shows up as coexisting loud and quiet sub-blocks, which
# is precisely when long-transform noise (scaled to the loud part)
# lands audibly in the quiet part. Max/mean caps at `factor` and
# misses onsets filling half the frame; a preceding-sub-blocks onset
# test is defeated by the time mirroring. Stationary content measures
# < 10 (tones at the sub-block-period boundary are the worst case);
# real attacks measure 10^2..10^4.
DETECT_RATIO = 30.0

# Two floors: quiet sub-blocks below DETECT_NOISE_REL of the frame's
# loudest count as that level in the contrast denominator (silence ->
# loud fires at a bounded, not infinite, ratio), and frames whose total
# spectral energy sits below the ABSOLUTE floor never switch (nothing
# audible to pre-echo into). The floor is absolute — NOT relative to
# the batch/file maximum — so flags stay a pure per-frame function and
# chunked encodes match whole-file encodes bit-exactly. Spectra are
# normalized to ]-1, 1[; 1e-12 total frame energy is ~-100 dBFS.
DETECT_NOISE_REL = 1e-4
DETECT_FLOOR = 1e-12


@functools.lru_cache(maxsize=8)
def _transition_matrix_f64(filters_n: int, factor: int) -> np.ndarray:
    """T = BD(O_M) @ O_N, float64 host precompute ([N, N], orthogonal)."""
    if filters_n % factor != 0:
        raise ValueError(
            f"filters_n={filters_n} not divisible by factor={factor}"
        )
    m = filters_n // factor
    o_n = _dct.dct4_matrix(filters_n)
    o_m = _dct.dct4_matrix(m)
    bd = np.zeros((filters_n, filters_n), dtype=np.float64)
    for s in range(factor):
        bd[s * m : (s + 1) * m, s * m : (s + 1) * m] = o_m
    # y [.., N] is applied as y @ T_right, so T_right = (BD @ O_N)^T =
    # O_N @ BD^T (both symmetric => O_N @ BD). Orthogonal either way.
    return o_n @ bd


def transition_matrices(filters_n: int, factor: int = FACTOR,
                        dtype=jnp.float32):
    """(fwd, inv) right-multiply matrices: y_short = y @ fwd,
    y_long = y_short @ inv. float64 pipelines get float64 copies."""
    t = _transition_matrix_f64(filters_n, factor)
    mat_dtype = (
        jnp.float64 if jnp.dtype(dtype) == jnp.dtype(jnp.float64)
        else jnp.float32
    )
    return (
        jnp.asarray(t, dtype=mat_dtype),
        jnp.asarray(t.T, dtype=mat_dtype),
    )


def _apply(spectrum: jax.Array, mat: jax.Array,
           precision: str = "highest") -> jax.Array:
    """[B, F, N, C] @ [N, N] along the bin axis at the ladder precision
    (default HIGHEST — an accelerator's f32 default rounds its inputs,
    TF32 on an H100; same pinning as ops/dct.py; "int8" maps to one-pass float, see module
    docstring)."""
    if precision == "int8":
        precision = "default"
    y = jnp.einsum(
        "bfnc,nk->bfkc",
        spectrum.astype(mat.dtype),
        mat,
        precision=_dct.PRECISIONS[precision],
    )
    return y.astype(spectrum.dtype)


def split_spectrum(spectrum: jax.Array, flags: jax.Array,
                   factor: int = FACTOR,
                   precision: str = "highest") -> jax.Array:
    """Long spectrum -> the switched representation.

    :param spectrum: [B, frames, N, C] long-transform spectrum.
    :param flags: [B, frames] bool — True = this frame uses the short
        basis (its N bins become ``factor`` concatenated M-bin
        sub-spectra, time-ordered).
    :return: same shape; long frames pass through untouched.
    """
    fwd, _ = transition_matrices(spectrum.shape[2], factor,
                                 spectrum.dtype)
    short = _apply(spectrum, fwd, precision)
    return jnp.where(flags[:, :, None, None], short, spectrum)


def merge_spectrum(spectrum_sw: jax.Array, flags: jax.Array,
                   factor: int = FACTOR,
                   precision: str = "highest") -> jax.Array:
    """The switched representation -> long spectrum (exact inverse of
    :func:`split_spectrum`; T is orthogonal)."""
    _, inv = transition_matrices(spectrum_sw.shape[2], factor,
                                 spectrum_sw.dtype)
    long = _apply(spectrum_sw, inv, precision)
    return jnp.where(flags[:, :, None, None], long, spectrum_sw)


def detect(spectrum: jax.Array, factor: int = FACTOR,
           ratio: float = DETECT_RATIO,
           precision: str = "highest") -> jax.Array:
    """Per-frame transient flags from the short-basis time envelope.

    By Parseval, the energy of sub-spectrum s in the short basis IS the
    energy of segment s of the folded frame — an 8-point envelope at
    M-sample resolution, obtained without touching the waveform (note
    the fold mirrors time around the block center, so this is a
    |t - center|-folded envelope, not a time-ordered one). A frame
    switches short on loud/quiet CONTRAST: the loudest sub-block
    exceeds the mean of the 3 quietest (floored at DETECT_NOISE_REL of
    the peak) by ``ratio`` — a transient boundary inside the frame,
    which is exactly when long-transform noise scaled to the loud part
    lands audibly in the quiet part. Channels are pooled (max): joint
    stereo needs one flag per frame, and an attack in either channel
    pre-echoes in both after the M/S rotation.

    :param spectrum: [B, frames, N, C] LONG spectrum (pre-quantization).
    :return: bool [B, frames].
    """
    b, f, n, c = spectrum.shape
    fwd, _ = transition_matrices(n, factor, spectrum.dtype)
    # The flags this produces are TRANSMITTED (the decoder never re-runs
    # detection), so the matmul lowering here is purely an encoder-local
    # decision knob — it may follow the cheap end of the ladder. A
    # borderline transient flipping between precisions changes which
    # basis a frame uses, not the wire contract.
    short = _apply(spectrum, fwd, precision)
    e = jnp.sum(
        short.astype(jnp.float32).reshape(b, f, factor, n // factor, c)
        ** 2,
        axis=3,
    )  # [B, F, factor, C]
    e = jnp.max(e, axis=-1)  # channel pool -> [B, F, factor]
    peak = jnp.max(e, axis=-1)
    quiet = jnp.mean(jnp.sort(e, axis=-1)[..., :3], axis=-1)
    contrast = peak > ratio * jnp.maximum(
        quiet, jnp.maximum(DETECT_NOISE_REL * peak, 1e-30)
    )
    frame_e = jnp.sum(e, axis=-1)
    loud = frame_e > DETECT_FLOOR
    # NOTE: deliberately a pure PER-FRAME function (no positional edge
    # handling): chunked/streaming encodes then produce bit-identical
    # flags to a whole-file encode automatically, for any chunking. The
    # first/last frames fold against the zero boundary block, so loud
    # content there reads as contrast and switches them — harmless:
    # they are the padding frames a round trip slices off.
    return jnp.logical_and(contrast, loud)


def pool_threshold(threshold: jax.Array, flags: jax.Array,
                   factor: int = FACTOR) -> jax.Array:
    """Masking threshold for the switched representation.

    Short-basis bin j of every sub-block spans the ``factor`` long bins
    [factor*j, factor*(j+1)); MIN-pooling their threshold amplitudes
    keeps the noise in every one of those bands below ITS own
    threshold — the conservative choice, exactly the rationale of the
    mid/side min-channel threshold. (RMS pooling — equal noise-energy
    budget — was measured at matched rate: same pre-echo and SNR, but
    fine-grid NMR up to 35x worse at 48 kbps because noise
    redistributes within a group above the quieter bins' thresholds;
    min costs nothing because rate control re-spends the margin.)
    Elementwise reshape/min only — the decoder reproduces it bit-exactly
    from the transmitted sidecar and flags, with no matmul-lowering
    caveat. Part of the wire format: both sides must pool identically.

    :param threshold: [B, frames, N, C] long-basis threshold amplitudes.
    :param flags: [B, frames] bool.
    :return: [B, frames, N, C] — pooled+tiled where short, untouched
        where long.
    """
    b, f, n, c = threshold.shape
    m = n // factor
    grouped = threshold.reshape(b, f, m, factor, c)
    pooled = jnp.min(grouped, axis=3)  # [B,F,M,C]
    tiled = jnp.tile(pooled, (1, 1, factor, 1))  # [B,F,N,C]
    return jnp.where(flags[:, :, None, None], tiled, threshold)


def pack_flags(flags: np.ndarray) -> np.ndarray:
    """bool [B, frames] -> uint8 bitmap [B, ceil(frames/8)] (container
    wire form; np.packbits big-endian bit order)."""
    return np.packbits(np.asarray(flags, dtype=bool), axis=-1)


def unpack_flags(bits: np.ndarray, frames: int) -> np.ndarray:
    """Inverse of :func:`pack_flags`."""
    out = np.unpackbits(np.asarray(bits, dtype=np.uint8), axis=-1)
    if out.shape[-1] < frames:
        raise ValueError(
            f"flag bitmap holds {out.shape[-1]} frames < {frames}"
        )
    return out[..., :frames].astype(bool)
