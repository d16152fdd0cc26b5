"""Bandwidth extension — spectral gap filling by low-band replication.

At low rates the quantizer zeroes most of the high band; noise filling
(nf.py) restores its ENERGY but paints every hole with white texture. For
harmonic content that reads as hiss where there used to be brightness —
the high band of voices and instruments is mostly shifted copies of the
low band's structure. The codec-standard fix (xHE-AAC's Intelligent Gap
Filling, HE-AAC's SBR) is to rebuild zeroed high-band bins by COPYING the
decoded low band up in frequency and scaling it to a transmitted
per-group energy envelope: phase-plausible harmonics for ~1 uint8 per
(frame, 16-bin group, channel). The reference has no quantizer or
bitstream at all (/root/reference/audiocodec/psychoacoustic.py:151-167 —
its "encode" is noise injection); this module is framework-added surface
on the coded paths, a sibling of nf.py.

Accelerator-friendly shape: the copy-up map is a STATIC index vector, so the fill is
one gather (compiled to slices), one fused multiply, one where — no
data-dependent shapes, no sort. Encoder analysis is two masked
multiply-reduces per group.

Wire format: uint8 gains per (frame, group, channel), log-coding the
amplitude ratio between the lost energy and the decoder's own
reconstruction of the source region. The source is the PLAIN
``codes * delta`` product (no dead-zone offset), so both sides derive it
bit-identically from data they already share; gain 0 = nothing to fill.
Gains are a pure per-frame function of (codes, delta, spectrum), so
chunked .acs decodes, seeks, and monolithic .acz decodes reconstruct
bit-identical waveforms with no carried state.

Composition with noise filling: when BWE is active it OWNS
[start, filters_n) — the encoder and decoder both cap nf's band at
``start`` (nf.analyze/fill band_end), so holes below the crossover get
noise, holes above get structure, and nothing is filled twice.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from audiocodec_tpu.utils import dtypes as _dtypes

# Bins per transmitted gain group. Coarser groups halve the side-info
# rate but smear the envelope across ~690 Hz (at 44.1 kHz, N=1024);
# 16 bins ~ the ERB scale's resolution in the replicated range.
GROUP = 16

# Gains are log-coded: level 0 = no fill, else the amplitude ratio is
# g = 2^((level - BIAS) / K). K=4 gives 1.5 dB (amplitude) steps over
# a +-191 dB representable span (in practice the per-bin FILL_CLAMP,
# not the grid, bounds the fill) — envelope resolution far inside
# what hearing resolves at 10+ kHz,
# and the coarse grid is what makes the member compress: measured vs
# the K=16 grid it deflates ~30% smaller at a fill-energy match that
# moved from 0.998 to 1.002 of the lost energy (i.e., not at all).
LEVEL_K = 4.0
LEVEL_BIAS = 128.0

# Per-bin fill ceiling in units of the TARGET bin's own step size. A bin
# that coded to zero had |x| < deadzone*delta <= ~delta, so any fill
# louder than delta is provably louder than what was lost AT THAT BIN —
# without the clamp, group-energy matching concentrates a spread-out
# loss onto the source's copied peaks and pushes them past the masking
# threshold (measured: NMR 0.74 -> 2.53 at 32 kbps on a harmonic
# stack; clamped, the energy win survives and NMR stays put). The
# clamp is part of the FORMAT: both sides derive it from delta alone.
FILL_CLAMP = 1.0


def default_start(filters_n: int, sample_rate: int) -> int:
    """Default crossover bin: ~10.5 kHz scaled to the configuration,
    clipped so a source region exists (start >= GROUP) and at least one
    group is replicated, rounded to a GROUP multiple."""
    bin_hz = sample_rate / (2.0 * filters_n)
    start = int(round(10500.0 / bin_hz / GROUP)) * GROUP
    return int(np.clip(start, GROUP, filters_n - GROUP))


def validate_start(filters_n: int, start: int) -> None:
    """Raise unless ``start`` is a legal crossover for this band count."""
    if (
        not GROUP <= start <= filters_n - GROUP
        or start % GROUP
        or (filters_n - start) % GROUP
    ):
        raise ValueError(
            f"bwe start {start} must be a multiple of {GROUP} in "
            f"[{GROUP}, {filters_n - GROUP}] for filters_n={filters_n}"
        )


def n_groups(filters_n: int, start: int) -> int:
    return (filters_n - start) // GROUP


def source_index(filters_n: int, start: int) -> np.ndarray:
    """Static copy-up map: target bin ``start + j`` reads source bin
    ``index[j]``. The source region is the widest GROUP-multiple window
    ending at the crossover, tiled upward when the target is wider
    (every tile keeps group alignment, so one gain scales a contiguous
    source slice)."""
    validate_start(filters_n, start)
    width = filters_n - start
    src_width = min(width, (start // GROUP) * GROUP)
    return (start - src_width) + (np.arange(width) % src_width)


def gain_to_amp(gains: jax.Array, dtype) -> jax.Array:
    """uint8 gains -> linear amplitude ratio (0 stays 0)."""
    g = gains.astype(dtype)
    amp = jnp.exp2((g - dtype.type(LEVEL_BIAS)) / dtype.type(LEVEL_K))
    return jnp.where(g > 0, amp, 0.0)


def _work_dtype(spec: jax.Array):
    # ONE shared definition across nf/bwe/intensity (utils.dtypes)
    return _dtypes.sidecar_work_dtype(spec)


def analyze(spec: jax.Array, codes: jax.Array, delta: jax.Array,
            start: int, exclude: jax.Array | None = None) -> jax.Array:
    """Per-(frame, group, channel) replication gain from the encoder's
    zeroed residual.

    The gain matches group ENERGY: g = sqrt(sum(x^2) / sum(src^2)) over
    the group's zero-coded target bins, with src the decoder's plain
    ``codes * delta`` reconstruction at the mapped-down positions — the
    exact array the decoder will scale, so the filled group lands at the
    lost energy. Groups whose source is (near) silent transmit 0: copying
    silence cannot restore anything, and a huge gain on numerical dust
    would be noise with an envelope. Digital silence gives 0 naturally.

    :param spec: the spectrum the quantizer saw (post mid/side rotation,
        post TNS filter, post block-switch split) [B, frames, N, C].
    :param codes: the integer codes quantize() produced from it.
    :param delta: the step sizes quantize() used.
    :param start: first replicated bin (validate_start-legal).
    :param exclude: static bool [N, C] mask of bins another mechanism
        owns (intensity.owned_mask when intensity stereo is active):
        excluded bins are neither metered nor filled — without it the
        replicator would read the deliberately-dropped side band as
        holes and stack its fill on the pan-reconstructed image. Both
        sides pass the same mask (derived from the container's recorded
        crossover).
    :return: uint8 [B, frames, n_groups, C] gains.
    """
    wdt = _work_dtype(spec)
    idx = jnp.asarray(source_index(spec.shape[-2], start))
    src = (codes.astype(wdt) * delta.astype(wdt))[..., idx, :]
    tgt = spec[..., start:, :].astype(wdt)
    zero = (codes[..., start:, :] == 0).astype(wdt)
    if exclude is not None:
        zero = zero * (~jnp.asarray(exclude)[start:, :]).astype(wdt)

    def group_sum(a):
        b, f, w, c = a.shape
        return jnp.sum(
            a.reshape(b, f, w // GROUP, GROUP, c), axis=-2
        )  # [B, F, G, C]

    e_lost = group_sum(jnp.square(tgt) * zero)
    e_src = group_sum(jnp.square(src) * zero)
    g = jnp.sqrt(e_lost / jnp.maximum(e_src, 1e-30))
    level = jnp.round(LEVEL_BIAS + LEVEL_K * jnp.log2(jnp.maximum(g, 1e-30)))
    # a source group far under the lost energy (past the grid's +191 dB
    # ceiling) carries no structure worth amplifying (and the wire
    # can't code the gain); silent sources (e_src ~ 0) fall out here too
    level = jnp.where(
        (e_lost > 0) & (g <= 2.0 ** ((255 - LEVEL_BIAS) / LEVEL_K)),
        level, 0.0,
    )
    return jnp.clip(level, 0, 255).astype(jnp.uint8)


def fill(spec: jax.Array, codes: jax.Array, delta: jax.Array,
         gains: jax.Array, start: int,
         exclude: jax.Array | None = None) -> jax.Array:
    """Decoder fill: every zero-coded bin above ``start`` receives its
    group gain times the plain ``codes * delta`` reconstruction of its
    mapped-down source bin.

    :param spec: dequantized spectrum [B, F, N, C] (before the TNS
        inverse filter and the mid/side derotation — the fill happens in
        the coded domain, where ``delta`` is defined; same point as
        nf.fill).
    :param gains: uint8 [B, F, n_groups, C] from :func:`analyze` (the
        container's ``bwe`` member).
    :return: spectrum with the high band rebuilt, same shape/dtype.
    """
    idx = jnp.asarray(source_index(spec.shape[-2], start))
    src = (codes.astype(spec.dtype) * delta.astype(spec.dtype))[..., idx, :]
    amp = gain_to_amp(gains, spec.dtype)  # [B, F, G, C]
    amp = jnp.repeat(amp, GROUP, axis=-2)  # [B, F, W, C]
    hole = codes[..., start:, :] == 0
    if exclude is not None:
        # must MATCH the encoder's analyze() mask (see there)
        hole = hole & ~jnp.asarray(exclude)[start:, :]
    # per-bin ceiling: never louder than the bin's own step size (see
    # FILL_CLAMP) — sign rides the source, magnitude saturates
    cap = spec.dtype.type(FILL_CLAMP) * delta[..., start:, :].astype(
        spec.dtype
    )
    fill_v = jnp.clip(amp * src, -cap, cap)
    band = spec[..., start:, :] + jnp.where(hole, fill_v, 0.0)
    return jnp.concatenate([spec[..., :start, :], band], axis=-2)
