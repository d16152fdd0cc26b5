"""Intensity stereo — pan-coded side channel above a crossover.

Joint mid/side coding spends real bits on the side channel's high band
even though hearing localizes there by LEVEL only (binaural phase
sensitivity fades above ~2 kHz). Intensity stereo — AAC's IS tool, here
rebuilt for this codec's coded domain — stops coding the side channel
at/above a crossover bin entirely and instead transmits ONE signed
log-gain per (frame, 16-bin group): the least-squares projection of the
side spectrum onto the decoder's own plain ``codes * delta`` mid
reconstruction. The decoder rebuilds side = gain * mid_hat bin-by-bin,
which restores the image (pan AND polarity) of level-panned content
exactly. Measured on a panned harmonic mix at ~72 kbps: bytes drop 20%
at EQUAL scale, and at matched bytes SNR is +2.7 dB over plain M/S with
the side-band image correlation unchanged (0.994); at ~44 kbps the
matched-rate win is +1..2 dB. The known limitation is inherent to the
model: side content UNCORRELATED with the mid (wide ambience,
out-of-phase effects) projects to ~0 and is dropped above the
crossover, so the mode is opt-in for low-rate use. The reference has no
quantizer or bitstream at all
(/root/reference/audiocodec/psychoacoustic.py:151-167 — its "encode" is
noise injection); this is framework-added surface on the coded paths, a
sibling of nf.py/bwe.py.

Accelerator-friendly shape: the source is the other channel at the SAME bin — one
slice, one fused multiply under a static mask; encoder analysis is two
masked multiply-reduces per group (the projection). No gathers, no
data-dependent shapes.

Wire format: uint8 per (frame, group) — one channel's worth. 0 = no
fill (silent or image-dust groups); otherwise bit 7 is the projection
SIGN and bits 0-6 a 1.5 dB log magnitude grid whose usable span is
[-131, +18] dB around unity (hard pans sit at 0 dB; levels past
LEVEL_MAX decode as the GAIN_CEIL = 8x ceiling, bounding what a
corrupt container can inject). Gains are a pure per-frame function of
(codes, delta, spectrum), so chunked .acs decodes, seeks, and
monolithic .acz decodes reconstruct bit-identical waveforms with no
carried state.

Composition: intensity OWNS (side channel, [start, N)) — the encoder
zeroes those codes (:func:`force_codes`), and noise filling / bandwidth
extension exclude the region on BOTH sides (:func:`owned_mask` ->
their ``exclude`` mask): without the exclusion, nf would meter the
deliberately-dropped side energy as "holes" and pour noise over the
pan-reconstructed image. Short block-switch frames are NOT forced (the
split basis has no frequency axis, so per-frequency-group gains are
meaningless there): their side codes stay, their gains read 0, and the
decoder's zero-bin fill mask makes that consistent with no extra wire.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from audiocodec_tpu.utils import dtypes as _dtypes

# Bins per transmitted gain group — matches bwe.GROUP: ~690 Hz at
# 44.1 kHz/N=1024, inside the ERB resolution of the coded range.
GROUP = 16

# Log grid for the gain MAGNITUDE: |g| = 2^((level - BIAS) / K), K=4 ->
# 1.5 dB (amplitude) steps. BIAS=88 centers the 7-bit span on the
# gains panning actually produces (|side/mid| <= 1 for in-phase pans):
# the usable levels 1..LEVEL_MAX cover [-131, +18] dB around unity —
# floor far under image audibility, ceiling GAIN_CEIL = 8x. The
# ceiling is a FORMAT rule enforced on the fill too: legitimate
# projections sit within a few dB of unity, so capping at +18 dB
# bounds what a corrupt (CRC-evading) container can inject while
# costing nothing real. Levels above LEVEL_MAX decode as the ceiling.
LEVEL_K = 4.0
LEVEL_BIAS = 88.0
GAIN_CEIL = 8.0
LEVEL_MAX = int(LEVEL_BIAS + LEVEL_K * np.log2(GAIN_CEIL))  # = 100
_SIGN_BIT = 128


def default_start(filters_n: int, sample_rate: int) -> int:
    """Default crossover bin: ~6 kHz scaled to the configuration —
    above the binaural-phase-sensitive range, below where panned
    brightness lives — rounded to a GROUP multiple and clipped so at
    least one group is coded."""
    bin_hz = sample_rate / (2.0 * filters_n)
    start = int(round(6000.0 / bin_hz / GROUP)) * GROUP
    return int(np.clip(start, GROUP, filters_n - GROUP))


def validate_start(filters_n: int, start: int) -> None:
    """Raise unless ``start`` is a legal crossover for this band count."""
    if (
        not GROUP <= start <= filters_n - GROUP
        or start % GROUP
        or (filters_n - start) % GROUP
    ):
        raise ValueError(
            f"intensity start {start} must be a multiple of {GROUP} in "
            f"[{GROUP}, {filters_n - GROUP}] for filters_n={filters_n}"
        )


def n_groups(filters_n: int, start: int) -> int:
    return (filters_n - start) // GROUP


def owned_mask(filters_n: int, start: int) -> np.ndarray:
    """Static bool [N, 2]: True where intensity owns the bin (side
    channel at/above the crossover). Noise filling and bandwidth
    extension take this as their ``exclude`` mask on both sides of the
    wire, so the dropped side band is never double-filled."""
    validate_start(filters_n, start)
    m = np.zeros((filters_n, 2), dtype=bool)
    m[start:, 1] = True
    return m


def force_codes(codes: jax.Array, start: int,
                bs_flags: jax.Array | None = None) -> jax.Array:
    """Encoder-side: zero the side-channel codes at/above ``start``
    (the bits intensity replaces with gains). Short block-switch frames
    keep their codes — see the module docstring.

    Measured dead end — per-group ADAPTIVE forcing (keep a group's
    side codes when the mid can't explain them; wire-free, since the
    decoder fills only zero bins): every gate tried re-spends the
    feature's whole win. A correlation gate (rho^2 over the group)
    keeps 90% of groups on the panned-mix scene (the ambience bed
    dominates bin count) and packs LARGER than plain M/S once the
    kept groups' noisy gains ride along (51.4 vs 48.8 kB, vs 41.4
    forced); a coded-residual gate (unexplained fraction of the coded
    side energy) fixes wideamb (side E 0.62 vs 0.03) but keeps 41% on
    pannedmix for the same > plain-M/S size. The ambient groups of
    the two scenes are locally indistinguishable — both code at +-1
    relative to their own thresholds — so no local gate can separate
    'width worth its bits' from 'masked dust'. Like per-band M/S
    (DESIGN.md §15), the honest surface is the binary flag.
    """
    _check_stereo(codes)
    validate_start(codes.shape[-2], start)
    keep = ~jnp.asarray(owned_mask(codes.shape[-2], start))
    if bs_flags is not None:
        keep = keep | bs_flags[:, :, None, None]
    return jnp.where(keep, codes, 0)


def mid_reference(codes: jax.Array, delta: jax.Array, dtype,
                  bwe_gains: jax.Array | None = None,
                  bwe_start: int = 0,
                  exclude: jax.Array | None = None) -> jax.Array:
    """The full-band MID spectrum both sides project onto / scale:
    the plain ``codes * delta`` product, with the bwe reconstruction
    applied when bandwidth extension is active — everything here is
    deterministic from wire data (no dead-zone offset, no fill noise),
    so encoder and decoder derive it bit-identically. Without the bwe
    term the mid is ~0 above the bwe crossover exactly where bwe
    rebuilds it, and the top band's image would collapse to center.

    :return: [B, F, N] mid reconstruction.
    """
    _check_stereo(codes)
    plain = codes.astype(dtype) * delta.astype(dtype)
    if bwe_gains is not None:
        from audiocodec_tpu import bwe as _bwe

        plain = _bwe.fill(plain, codes, delta, bwe_gains, bwe_start,
                          exclude=exclude)
    return plain[..., 0]


def gain_to_amp(gains: jax.Array, dtype) -> jax.Array:
    """uint8 wire gains -> signed linear amplitude (0 stays 0).

    Magnitude levels above LEVEL_MAX decode as GAIN_CEIL — the format's
    injection bound (see the grid comment)."""
    g = gains.astype(jnp.int32)
    lvl = jnp.minimum(g & (_SIGN_BIT - 1), LEVEL_MAX)
    mag = jnp.exp2(
        (lvl.astype(dtype) - dtype.type(LEVEL_BIAS))
        / dtype.type(LEVEL_K)
    )
    sign = jnp.where(g >= _SIGN_BIT, dtype.type(-1.0), dtype.type(1.0))
    return jnp.where(g > 0, sign * mag, dtype.type(0.0))


def _check_stereo(spec: jax.Array) -> None:
    if spec.shape[-1] != 2:
        raise ValueError(
            "intensity stereo needs the mid/side layout (exactly 2 "
            f"channels), got {spec.shape[-1]}"
        )


def analyze(spec: jax.Array, codes: jax.Array, delta: jax.Array,
            start: int, mid_ref: jax.Array | None = None) -> jax.Array:
    """Per-(frame, group) signed image gain of the dropped side band.

    The gain is the least-squares projection of the side spectrum onto
    the decoder's mid reconstruction: g = sum(side * mid_hat) /
    sum(mid_hat^2) over the group's ZERO-coded side bins — after
    :func:`force_codes` that is the whole group, and on unforced
    (short block-switch) frames the projection naturally restricts to
    genuinely-zero bins whose gains are zeroed by the caller anyway.
    Projection, not energy matching: it restores the CORRELATED image
    component exactly (pan and polarity) and sends decorrelated
    residue to ~0 instead of painting it as a false image (measured:
    proj keeps side-band correlation at 0.993-0.994 where energy
    matching reads 0.991-0.992 with a 2% energy overshoot). Groups
    whose mid is (near) silent transmit 0: nothing to pan.

    :param spec: the mid/side spectrum the quantizer saw (post
        rotation, post TNS filter) [B, frames, N, 2] — NOT
        block-switch-split (frequency groups are meaningless there).
    :param codes: the integer codes — AFTER :func:`force_codes`.
    :param delta: the step sizes quantize() used.
    :param start: first owned bin (validate_start-legal).
    :param mid_ref: the mid spectrum the DECODER will scale, full-band
        [B, frames, N]. None = the plain ``codes * delta`` mid. With
        bandwidth extension active both sides MUST pass the
        bwe-reconstructed mid instead (see Codec._intensity_mid_ref):
        above the bwe crossover the plain mid is ~0 exactly where bwe
        rebuilds it, so projecting onto the plain mid would transmit 0
        and the decoder's fill would write gain*0 — the top band's
        image would silently collapse to center.
    :return: uint8 [B, frames, n_groups] wire gains.
    """
    _check_stereo(spec)
    validate_start(spec.shape[-2], start)
    wdt = _dtypes.sidecar_work_dtype(spec)
    if mid_ref is None:
        mid_hat = (codes.astype(wdt) * delta.astype(wdt))[..., start:, 0]
    else:
        mid_hat = mid_ref.astype(wdt)[..., start:]
    side = spec[..., start:, 1].astype(wdt)
    zero = (codes[..., start:, 1] == 0).astype(wdt)

    def group_sum(a):
        b, f, w = a.shape
        return jnp.sum(a.reshape(b, f, w // GROUP, GROUP), axis=-1)

    num = group_sum(side * mid_hat * zero)
    den = group_sum(jnp.square(mid_hat) * zero)
    g = num / jnp.maximum(den, 1e-30)
    mag = jnp.abs(g)
    level = jnp.round(
        LEVEL_BIAS + LEVEL_K * jnp.log2(jnp.maximum(mag, 1e-30))
    )
    level = jnp.clip(level, 1, LEVEL_MAX)
    # below the grid floor (-131 dB re the mid) the projection is image
    # dust, not placement — transmit 0; silent mids (den ~ 0) fall out
    # here too
    level = jnp.where(
        mag >= 2.0 ** ((1 - LEVEL_BIAS) / LEVEL_K), level, 0.0
    )
    return jnp.where(
        (g < 0) & (level > 0), level + _SIGN_BIT, level
    ).astype(jnp.uint8)


def fill(spec: jax.Array, codes: jax.Array, delta: jax.Array,
         gains: jax.Array, start: int,
         mid_ref: jax.Array | None = None) -> jax.Array:
    """Decoder: every zero-coded side bin at/above ``start`` becomes
    its group gain times the mid reconstruction at the same bin. No
    per-bin delta clamp, deliberately: unlike nf/bwe hole filling, the
    dropped bins held REAL content well above their step size —
    clamping at delta collapses the rebuilt image to numerical dust
    (measured: side-band energy 0.016 of the original with the clamp,
    1.017 without). The grid ceiling (GAIN_CEIL = 8x) bounds the fill
    instead.

    :param spec: dequantized mid/side spectrum [B, F, N, 2] (before the
        TNS inverse filter and the stereo derotation — the fill happens
        in the coded domain, where ``delta`` is defined; same point as
        nf.fill / bwe.fill).
    :param gains: uint8 [B, F, n_groups] from :func:`analyze` (the
        container's ``isg`` member).
    :param mid_ref: the mid spectrum to scale, full-band [B, F, N];
        None = the plain ``codes * delta`` mid. Must MATCH what the
        encoder's analyze() projected onto — with bandwidth extension
        active both sides pass the bwe-reconstructed mid (see analyze).
    :return: spectrum with the side image rebuilt, same shape/dtype.
    """
    _check_stereo(spec)
    validate_start(spec.shape[-2], start)
    if mid_ref is None:
        mid_hat = (codes.astype(spec.dtype)
                   * delta.astype(spec.dtype))[..., start:, 0]
    else:
        mid_hat = mid_ref.astype(spec.dtype)[..., start:]
    amp = gain_to_amp(gains, spec.dtype)  # [B, F, G]
    amp = jnp.repeat(amp, GROUP, axis=-1)  # [B, F, W]
    hole = codes[..., start:, 1] == 0
    side = spec[..., start:, 1] + jnp.where(hole, amp * mid_hat, 0.0)
    return jnp.concatenate(
        [
            spec[..., :start, :],
            jnp.stack([spec[..., start:, 0], side], axis=-1),
        ],
        axis=-2,
    )
