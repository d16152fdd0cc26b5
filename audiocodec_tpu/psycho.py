"""Psychoacoustic model (Bark-domain masking).

Capability parity with the reference's ``PsychoacousticModel``
(audiocodec/psychoacoustic.py:13-339), redesigned for JAX:

* Pure-functional pytree dataclass; all Bark-domain precomputes (W, W_inv,
  spreading matrix, threshold in quiet) are built in numpy float64 on the
  host and downcast once (mirrors psychoacoustic.py:60-69).
* The masking einsum chain is reassociated so the reference's 5-D
  [B, blocks, bark, bark, C] intermediate (its peak-memory hot spot,
  psychoacoustic.py:195-207) is never materialized: since the per-band
  offset depends only on the *output* Bark index, the superposition is
  (I^alpha @ spreading) * offset_factor — two matmuls' worth of work,
  zero extra memory, same numbers.
* ``add_noise`` takes an explicit ``jax.random`` key instead of relying on
  global RNG state (the reference uses tf.random.normal with the global
  seed, psychoacoustic.py:165) — a deliberate, documented API difference.

All formulas follow Zolzer, "Digital Audio Signal Processing" ch. 9, as in
the reference (equation citations inline below).

Shape contract (identical to the reference):
  spectra   [batches_n, blocks_n, filter_bands_n, channels_n]
  tonality  [batches_n, blocks_n, 1, channels_n]
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from audiocodec_tpu.utils import dtypes as _dtypes

# dB level corresponding to |amplitude| = 1.0, calibrated against MP3
# encodings (reference psychoacoustic.py:46-52).
DB_MAX = 120.0
# Intensity floor guarding logs/pows and their gradients
# (reference psychoacoustic.py:54-56, gradient-NaN note at :311).
INTENSITY_EPS = 1e-14


def freq2bark(frequencies):
    """Empirical Bark scale: bark = 6 * asinh(f / 600)."""
    return 6.0 * np.arcsinh(np.asarray(frequencies) / 600.0)


def bark2freq(bark_band):
    """Inverse empirical Bark scale: f = 600 * sinh(bark / 6)."""
    return 600.0 * np.sinh(np.asarray(bark_band) / 6.0)


def _bark_freq_mapping(
    sample_rate: float, filter_bands_n: int, bark_bands_n: int
):
    """Linear-frequency <-> Bark band overlap matrices, float64.

    W [filter_bands_n, bark_bands_n]: fractional overlap of each filter band
    with each Bark band, normalized by the filter bandwidth (rows sum to 1).
    W_inv [bark_bands_n, filter_bands_n]: overlap normalized by the Bark
    bandwidth, transposed (rows sum to 1). Intensities are mapped linearly;
    the square root to amplitudes is applied downstream
    (reference psychoacoustic.py:257-299 — following the code, not the
    1/sqrt(k) ASCII art in its docstring).
    """
    max_frequency = sample_rate / 2.0
    max_bark = freq2bark(max_frequency)
    bark_band_width = max_bark / bark_bands_n
    filter_band_width = max_frequency / filter_bands_n

    bark_idx = np.arange(bark_bands_n, dtype=np.float64)[None, :]
    freq_idx = np.arange(filter_bands_n, dtype=np.float64)[:, None]

    bark_low_hz = bark2freq(bark_band_width * bark_idx)
    bark_high_hz = bark2freq(bark_band_width * (bark_idx + 1.0))
    freq_low = filter_band_width * freq_idx
    freq_high = freq_low + filter_band_width

    lo = np.clip(bark_low_hz, freq_low, freq_high)
    hi = np.clip(bark_high_hz, freq_low, freq_high)
    overlap = hi - lo

    W = overlap / filter_band_width
    W_inv = (overlap / (bark_high_hz - bark_low_hz)).T
    return W, W_inv


def _bark_freq_mapping_calibrated(
    sample_rate: float, filter_bands_n: int, bark_bands_n: int
):
    """Centroid-preserving analysis matrix for calibrated mode.

    Each filter band's intensity is split between the two Bark bands
    whose CENTERS bracket the filter band's center (triangular kernel)
    instead of rectangular overlap binning. Rows still sum to 1 (energy
    conservation is untouched); what changes is that a tonal masker's
    effective Bark position becomes its true position instead of its
    band's center — rectangular binning quantizes masker positions by
    up to half a Bark band, which on the lower masking skirt
    (~-27 dB/Bark) is a ±7 dB resolution-dependent threshold error at
    48 bands (measured; DESIGN.md §4b).
    """
    max_frequency = sample_rate / 2.0
    max_bark = freq2bark(max_frequency)
    step = max_bark / bark_bands_n
    fc = (np.arange(filter_bands_n) + 0.5) * max_frequency / filter_bands_n
    pos = (freq2bark(fc) - 0.5 * step) / step  # fractional center index
    lo = np.clip(np.floor(pos).astype(int), 0, bark_bands_n - 1)
    hi = np.clip(lo + 1, 0, bark_bands_n - 1)
    wfrac = np.clip(pos - lo, 0.0, 1.0)
    W = np.zeros((filter_bands_n, bark_bands_n))
    np.add.at(W, (np.arange(filter_bands_n), lo), 1.0 - wfrac)
    np.add.at(W, (np.arange(filter_bands_n), hi), wfrac)
    return W


def _spreading_matrix_integrated(
    bark_bands_n: int, max_bark: float, alpha: float
):
    """Band-integrated spreading matrix for calibrated mode.

    Each entry is the AVERAGE prototype intensity over the target
    band's width (33-point trapezoid in float64 on host) instead of a
    point sample — point sampling at band-step granularity (plus the
    reference construction's half-step offset) makes the steep masking
    skirts resolution-dependent by several dB. Converges to the
    continuous band average as resolution grows, so different
    bark_bands_n agree.
    """
    step = max_bark / bark_bands_n
    d = (
        np.arange(bark_bands_n)[None, :] - np.arange(bark_bands_n)[:, None]
    ).astype(np.float64)
    u = np.linspace(-0.5, 0.5, 33)
    # the reference construction samples the prototype at a half-step
    # offset (z index n - r + c lands on (c - r + 0.5)*step); anchoring
    # to the 1024/64 standard keeps that offset as a FIXED bark shift
    # (half of the 64-band step) so every resolution reproduces the
    # default configuration's masking pattern instead of shifting its
    # skirts by its own half step
    anchor_shift = 0.5 * (max_bark / 64.0)
    z = (d[:, :, None] + u[None, None, :]) * step + anchor_shift
    f_spreading = 15.81 + 7.5 * (z + 0.474) - 17.5 * np.sqrt(
        1.0 + (z + 0.474) ** 2
    )
    vals = 10.0 ** (alpha * f_spreading / 10.0)
    # np.trapezoid is numpy >= 2.0; fall back to its pre-2.0 name
    trap = getattr(np, "trapezoid", None) or np.trapz
    return trap(vals, u, axis=2)


def _quiet_threshold_freq_amp(
    sample_rate: float, filter_bands_n: int, db_min: float
):
    """Threshold-in-quiet per FILTER band, [1, 1, filter_bands_n, 1]
    amplitudes — the calibrated mode's fine-grid quiet floor.

    The Bark-domain quiet threshold samples a steeply-sloped curve at
    band midpoints: the lowest Bark band's midpoint moves with
    bark_bands_n, shifting its threshold by >10 dB between 48 and 96
    bands (the curve rises ~-0.8 log-slope toward DC and k^4 toward
    Nyquist). Evaluating on the filter-band grid removes that
    resolution dependence entirely (measured: quiet-level agreement
    across configs goes from ~2.5 dB worst to ~0.6 dB; DESIGN.md §4b).
    """
    fc = (
        (np.arange(filter_bands_n) + 0.5)
        * (sample_rate / 2.0)
        / filter_bands_n
    )
    f_khz = fc / 1000.0
    quiet_db = np.clip(
        3.64 * f_khz**-0.8
        - 6.5 * np.exp(-0.6 * (f_khz - 3.3) ** 2)
        + 1e-3 * f_khz**4,
        db_min,
        DB_MAX,
    )
    # Anchor to the 1024/64 standard's level convention: the rectangular
    # W_inv splits a Bark band's quiet intensity across the filter bands
    # it covers, so per-band quiet intensity = I_quiet / n_default(f)
    # with n_default(f) = (Hz width of a 64-band Bark band at f) /
    # (the 1024-band filter width) — evaluated CONTINUOUSLY here
    # (dHz/dbark = 100 cosh(bark/6)), which is exactly what removes the
    # midpoint-sampling resolution dependence while keeping the default
    # configuration's absolute levels.
    max_bark = freq2bark(sample_rate / 2.0)
    bark_width_hz = 100.0 * np.cosh(freq2bark(fc) / 6.0) * (max_bark / 64.0)
    filter_bw_default = (sample_rate / 2.0) / 1024.0
    n_default = np.maximum(bark_width_hz / filter_bw_default, 1e-6)
    intensity = 10.0 ** ((quiet_db - DB_MAX) / 10.0) / n_default
    amp = np.sqrt(intensity)
    return amp.reshape(1, 1, -1, 1)


def _spreading_matrix(bark_bands_n: int, max_bark: float, alpha: float):
    """Toeplitz-like matrix of shifted spreading prototypes, float64.

    Prototype (Zolzer eq. 9.15): 15.81 + 7.5(z+0.474) - 17.5 sqrt(1+(z+0.474)^2)
    dB, evaluated on 2*bark_bands_n points over [-max_bark, max_bark],
    converted to intensity with the alpha exponent baked in, then each row
    shifted by one bin (reference psychoacoustic.py:212-230 — vectorized
    here, no map_fn / Python loop over rows).
    """
    z = np.linspace(-max_bark, max_bark, 2 * bark_bands_n)
    f_spreading = 15.81 + 7.5 * (z + 0.474) - 17.5 * np.sqrt(
        1.0 + (z + 0.474) ** 2
    )
    f_intensity = 10.0 ** (alpha * f_spreading / 10.0)
    # Row `row` reads f_intensity[bark_bands_n - row : 2*bark_bands_n - row]:
    # a sliding window — realized with stride tricks instead of a loop.
    starts = bark_bands_n - np.arange(bark_bands_n)
    idx = starts[:, None] + np.arange(bark_bands_n)[None, :]
    return f_intensity[idx]


def _quiet_threshold_intensity(
    bark_bands_n: int, max_bark: float, db_min: float
):
    """Threshold-in-quiet intensity per Bark band, [1, 1, bark_bands_n, 1].

    Zolzer eq. 9.3 evaluated at the Bark band midpoints (in kHz), clipped to
    [db_min, DB_MAX], converted to intensity relative to DB_MAX
    (reference psychoacoustic.py:232-255).
    """
    bark_band_width = max_bark / bark_bands_n
    mid_bark = bark_band_width * np.arange(bark_bands_n, dtype=np.float64) + (
        bark_band_width / 2.0
    )
    mid_khz = bark2freq(mid_bark) / 1000.0
    quiet_db = np.clip(
        3.64 * mid_khz**-0.8
        - 6.5 * np.exp(-0.6 * (mid_khz - 3.3) ** 2)
        + 1e-3 * mid_khz**4,
        db_min,
        DB_MAX,
    )
    intensity = 10.0 ** ((quiet_db - DB_MAX) / 10.0)
    return intensity.reshape(1, 1, -1, 1)


def temporal_masking_window(decay_db_per_frame: float,
                            horizon_db: float = 30.0) -> int:
    """The exact number of past frames :func:`temporal_masking` spans —
    the log-doubling window 2^ceil(log2(w+1)) - 1 over the smallest w
    whose decayed contribution stays within ``horizon_db`` of a masker.
    Streaming encoders carry THIS many context frames for bit-exact
    chunk-boundary continuity with a whole-file encode."""
    if not decay_db_per_frame > 0:
        raise ValueError(
            f"decay must be positive, got {decay_db_per_frame}"
        )
    w = int(np.ceil(horizon_db / decay_db_per_frame))
    return 2 ** max(1, int(np.ceil(np.log2(w + 1)))) - 1


def temporal_masking(bark_intensity, decay_db_per_frame: float,
                     frame_axis: int = 1, context=None,
                     horizon_db: float = 30.0):
    """Forward (post-)masking: spread each frame's Bark masking intensity
    over the following frames with an exponential decay, as a decayed
    running max — I'_t = max_k  lambda^k * I_{t-k}  with
    lambda = 10^(-decay/10).

    A loud sound keeps masking for ~100-200 ms after it ends (Zolzer ch.
    9.1: post-masking), which per-frame simultaneous masking cannot see.
    Raising the threshold of the frames in a masker's shadow saves bits
    exactly where quantization noise is least audible. The effect is
    purely encoder-side here: it is applied BEFORE the bfloat16 Bark
    sidecar is rounded, so the decoder re-derives identical step sizes
    from the transmitted sidecar with no format change (like ``drown``).

    Parallel formulation: the max over the window is computed by
    log-doubling — ceil(log2(window+1)) shifted-scaled elementwise maxes,
    all parallel over frames (no scan carry), fusable by XLA into the
    surrounding threshold program. The window is truncated where the
    decayed contribution falls ``horizon_db`` below the masker (inaudible
    next to the frame's own simultaneous masking).

    :param bark_intensity: [..., frames, bark_bands_n, channels] masking
        intensities (any rank; ``frame_axis`` selects the time axis).
    :param decay_db_per_frame: decay of the masking intensity per frame
        hop, in dB (> 0). For N=1024 at 44.1 kHz (23 ms hop) ~3 dB/frame
        matches the literature's 100-200 ms post-masking span.
    :param context: optional trailing frames of the PREVIOUS chunk's
        (pre-spread) intensities, prepended along ``frame_axis`` and
        trimmed from the output — streaming encoders pass the last
        :func:`temporal_masking_window` frames so chunk boundaries spread
        identically to a whole-file encode.
    :return: spread intensities, same shape as ``bark_intensity`` (>= it
        pointwise; equal wherever no earlier frame shadows).
    """
    window = temporal_masking_window(decay_db_per_frame, horizon_db)
    x = bark_intensity
    n_ctx = 0
    if context is not None:
        if context.ndim != x.ndim:
            raise ValueError(
                f"context rank {context.ndim} != input rank {x.ndim}"
            )
        n_ctx = context.shape[frame_axis]
        x = jnp.concatenate([context.astype(x.dtype), x], axis=frame_axis)

    def shifted(arr, k):
        pad = [(0, 0)] * arr.ndim
        pad[frame_axis] = (k, 0)
        # zero-fill: intensities are >= the 1e-14 floor, so a zero frame
        # never wins the max (silence before the clip masks nothing)
        return jax.lax.slice_in_dim(
            jnp.pad(arr, pad), 0, arr.shape[frame_axis], axis=frame_axis
        )

    steps = max(1, int(np.ceil(np.log2(window + 1))))
    shift = 1
    for _ in range(steps):
        if shift >= x.shape[frame_axis]:
            # a shift past the array is an exact no-op (the zero-filled
            # frames never win the max against positive intensities):
            # stop so tiny decays (astronomical windows) stay O(log
            # frames) in ops and pad widths — chunked/whole equality is
            # unaffected because skipped steps change nothing
            break
        # lambda^shift precomputed in float64 on host, downcast once
        lam = _dtypes.scalar(
            10.0 ** (-decay_db_per_frame * shift / 10.0), x.dtype
        )
        x = jnp.maximum(x, shifted(x, shift) * lam)
        shift *= 2
    if n_ctx:
        x = jax.lax.slice_in_dim(
            x, n_ctx, x.shape[frame_axis], axis=frame_axis
        )
    return x


def _exact_sqrt(x: jax.Array) -> jax.Array:
    """Correctly rounded square root, the same bits on every backend.

    A GPU's float32 sqrt is approximate (off by an ulp in about a fifth
    of the roots, measured on an H100), while the CPU's is correctly
    rounded. The root is taken in float64, which is correctly
    rounded on both, and rounded once to float32: for sqrt, 53 >= 2*24+2
    bits make that equal to the correctly rounded float32 root. Lower
    precisions round on from that float32 value, as XLA's own upcast
    does."""
    if x.dtype == jnp.float64:
        return jnp.sqrt(x)
    with jax.enable_x64(True):
        root = jnp.sqrt(x.astype(jnp.float64)).astype(jnp.float32)
    return root.astype(x.dtype)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "W", "W_inv", "quiet_threshold_intensity", "spreading_matrix",
        "bark_grid", "quiet_threshold_freq_amp",
    ],
    meta_fields=[
        "sample_rate", "filter_bands_n", "bark_bands_n", "alpha",
        "compute_dtype", "max_bark", "bark_precision", "calibrated",
    ],
)
@dataclasses.dataclass(frozen=True)
class PsychoacousticModel:
    """Bark-scale masking model as an immutable pytree.

    :param sample_rate: input sample rate in Hz.
    :param filter_bands_n: number of MDCT filter bands (default 1024).
    :param bark_bands_n: number of Bark bands (default 64); 1024/64 are the
        standard-MP3 defaults and deviating shifts absolute threshold levels
        (same caveat as reference psychoacoustic.py:18-23).
    :param alpha: exponent for non-linear masking superposition
        (1.0 = linear; 0.6 default).
    :param compute_dtype: float64, float32 (default) or bfloat16; float16 is
        rejected — insufficient exponent range for the 1e-14 intensity floor.
    :param bark_precision: matmul precision of the encoder-side Bark
        contractions (W and spreading): "highest" (default — true-f32
        thresholds), "high", or "default" (TF32 on an H100, ~1e-3
        relative threshold error — inaudible next to quantization noise).
        The W_inv sidecar expansion always runs at HIGHEST (see
        :meth:`_bark_intensity_to_freq_ampl`).
    :param calibrated: False (default) keeps reference parity, including
        the reference's documented caveat that deviating from
        1024/64 bands shifts absolute threshold levels
        (/root/reference/audiocodec/psychoacoustic.py:20-23 — its "todo
        normalization"). True fixes that todo: thresholds become
        invariant to (filter_bands_n, bark_bands_n), anchored to the
        1024/64 standard, via four measured normalizations (W_inv level
        scalar, fine-grid quiet floor, band-integrated spreading,
        centroid-preserving analysis kernel — DESIGN.md §4b has the
        per-term measurements). Model-level only: the coded-bitstream
        path pins parity mode, so containers are unaffected.
    """

    sample_rate: float
    filter_bands_n: int
    bark_bands_n: int
    alpha: float
    compute_dtype: object
    max_bark: float
    bark_precision: str
    calibrated: bool
    W: jax.Array
    W_inv: jax.Array
    quiet_threshold_intensity: jax.Array
    spreading_matrix: jax.Array
    bark_grid: jax.Array  # linspace(0, max_bark, bark_bands_n)
    quiet_threshold_freq_amp: object  # calibrated mode only, else None

    @classmethod
    def create(
        cls,
        sample_rate,
        filter_bands_n: int = 1024,
        bark_bands_n: int = 64,
        alpha: float = 0.6,
        compute_dtype=jnp.float32,
        bark_precision: str = "highest",
        calibrated: bool = False,
    ) -> "PsychoacousticModel":
        from audiocodec_tpu.ops import dct as _dct

        if bark_precision not in _dct.PRECISIONS:
            raise ValueError(
                f"bark_precision must be one of {sorted(_dct.PRECISIONS)}, "
                f"got {bark_precision!r}"
            )
        dtype = _dtypes.canonicalize_compute_dtype(compute_dtype)
        max_bark = float(freq2bark(sample_rate / 2.0))
        # dB floor implied by the intensity floor: amplitude_to_dB(1e-14)
        # = 10*log10(max(EPS, EPS^2)) + 120 = -20 dB
        # (reference psychoacoustic.py:58 and the clamp at :83-84).
        db_min = 10.0 * math.log10(INTENSITY_EPS) + DB_MAX
        W, W_inv = _bark_freq_mapping(sample_rate, filter_bands_n, bark_bands_n)
        quiet_freq = None
        if calibrated:
            # Level anchor: the rectangular W_inv splits a Bark band's
            # threshold intensity across its filter bands, so per-band
            # levels scale with filter_bands_n/bark_bands_n. This scalar
            # pins them to what the 1024/64 standard configuration
            # produces (exactly 1.0 there, so calibrated mode is
            # anchored, not re-tuned).
            W_inv = W_inv * (
                (filter_bands_n * 64.0) / (1024.0 * bark_bands_n)
            )
            W = _bark_freq_mapping_calibrated(
                sample_rate, filter_bands_n, bark_bands_n
            )
            spreading = _spreading_matrix_integrated(
                bark_bands_n, max_bark, alpha
            )
            quiet_freq = _quiet_threshold_freq_amp(
                sample_rate, filter_bands_n, db_min
            )
        else:
            spreading = _spreading_matrix(bark_bands_n, max_bark, alpha)
        as_compute = lambda v: jnp.asarray(v, dtype=dtype)
        return cls(
            sample_rate=float(sample_rate),
            filter_bands_n=filter_bands_n,
            bark_bands_n=bark_bands_n,
            alpha=float(alpha),
            compute_dtype=dtype,
            max_bark=max_bark,
            bark_precision=bark_precision,
            calibrated=bool(calibrated),
            W=as_compute(W),
            W_inv=as_compute(W_inv),
            quiet_threshold_intensity=as_compute(
                _quiet_threshold_intensity(bark_bands_n, max_bark, db_min)
            ),
            spreading_matrix=as_compute(spreading),
            bark_grid=as_compute(
                np.linspace(0.0, max_bark, bark_bands_n)
            ),
            quiet_threshold_freq_amp=(
                None if quiet_freq is None else as_compute(quiet_freq)
            ),
        )

    # -- dB utilities --------------------------------------------------------

    @property
    def _matmul_precision(self):
        from audiocodec_tpu.ops import dct as _dct

        return _dct.PRECISIONS[self.bark_precision]

    @property
    def _eps(self):
        return _dtypes.scalar(INTENSITY_EPS, self.compute_dtype)

    @property
    def dB_MAX(self):
        return DB_MAX

    @property
    def dB_MIN(self):
        return 10.0 * math.log10(INTENSITY_EPS) + DB_MAX

    def amplitude_to_dB(self, mdct_amplitude: jax.Array) -> jax.Array:
        """Amplitude in [-1, 1] -> dB in [dB_MIN, dB_MAX].

        Intensity (amplitude squared) 1.0 maps to dB_MAX; the intensity is
        floored at INTENSITY_EPS (reference psychoacoustic.py:71-85).
        """
        intensity = jnp.maximum(self._eps, mdct_amplitude**2)
        ln10 = _dtypes.scalar(math.log(10.0), self.compute_dtype)
        return 10.0 * jnp.log(intensity) / ln10 + _dtypes.scalar(
            DB_MAX, self.compute_dtype
        )

    def amplitude_to_dB_norm(self, mdct_amplitude: jax.Array) -> jax.Array:
        """Amplitude in [-1, 1] -> normalized dB in [0, 1]
        (reference psychoacoustic.py:87-100)."""
        db = self.amplitude_to_dB(mdct_amplitude)
        return (db - self.dB_MIN) / (self.dB_MAX - self.dB_MIN)

    # -- perceptual core -----------------------------------------------------

    def tonality(self, mdct_amplitudes: jax.Array) -> jax.Array:
        """Tonality in [0, 1] (0 = noise, 1 = tonal) from the spectral
        flatness measure, Zolzer eqs. 9.10-9.11
        (reference psychoacoustic.py:103-120).

        :param mdct_amplitudes: [batches_n, blocks_n, filter_bands_n, channels_n].
        :return: [batches_n, blocks_n, 1, channels_n].
        """
        _dtypes.check_input_dtype(
            mdct_amplitudes, self.compute_dtype, "tonality input"
        )
        intensity = mdct_amplitudes**2
        geo_mean = jnp.exp(
            jnp.mean(
                jnp.log(jnp.maximum(self._eps, intensity)),
                axis=2,
                keepdims=True,
            )
        )
        arith_mean = jnp.mean(intensity, axis=2, keepdims=True) + self._eps
        ln10 = _dtypes.scalar(math.log(10.0), self.compute_dtype)
        sfm = 10.0 * jnp.log(geo_mean / arith_mean) / ln10
        return jnp.minimum(sfm / -60.0, 1.0)

    def _masking_intensity_in_bark(
        self, mdct_amplitudes, tonality_per_block, drown=0.0
    ):
        """Masked intensity per Bark band
        [batches_n, blocks_n, bark_bands_n, channels_n].

        Masking offset O(i) = tonality*(14.5 + i_bark) + (1-tonality)*5.5,
        scaled by (1 - drown); applied as 10^(-alpha*O/10) on the *output*
        Bark index, so it factors out of the spreading contraction — the
        reference's 5-D masking_matrix (psychoacoustic.py:195-197) is
        algebraically (I^alpha @ spreading) * offset_factor and never needs
        to exist.
        """
        alpha = _dtypes.scalar(self.alpha, self.compute_dtype)
        grid = self.bark_grid.reshape(1, 1, -1, 1)
        offset = (1.0 - drown) * (
            tonality_per_block * grid + 9.0 * tonality_per_block + 5.5
        )
        offset_factor = jnp.power(
            _dtypes.scalar(10.0, self.compute_dtype), -alpha * offset / 10.0
        )

        intensities_in_bark = self._to_bark_intensity(mdct_amplitudes)
        amp_alpha = jnp.power(
            jnp.maximum(self._eps, intensities_in_bark), alpha
        )
        # Non-linear superposition (Zolzer eq. 9.17, transposed), with the
        # diagonal offset folded in *after* the contraction — preserves the
        # pow -> matmul -> pow order of operations exactly.
        # einsum accumulates bf16 inputs in f32 (its default promoted
        # accumulator); cast back so the compute-dtype contract holds.
        spread = jnp.einsum(
            "nbic,ij->nbjc",
            amp_alpha,
            self.spreading_matrix,
            precision=self._matmul_precision,
        ).astype(self.compute_dtype)
        masked = spread * offset_factor
        return jnp.power(jnp.maximum(self._eps, masked), 1.0 / alpha)

    def global_masking_threshold(
        self, mdct_amplitudes, tonality_per_block, drown=0.0
    ) -> jax.Array:
        """Global masking threshold as per-filter-band amplitudes (>= 0).

        max(masking, threshold-in-quiet) in the Bark domain, mapped back to
        filter-band amplitudes (reference psychoacoustic.py:122-148).

        :param mdct_amplitudes: [batches_n, blocks_n, filter_bands_n, channels_n].
        :param tonality_per_block: [batches_n, blocks_n, 1, channels_n]
            (from :meth:`tonality`).
        :param drown: 0..1, raises the threshold to drown out audible content.
        """
        _dtypes.check_input_dtype(
            mdct_amplitudes, self.compute_dtype, "global_masking_threshold input"
        )
        with jax.named_scope("global_masking_threshold"):
            global_in_bark = self.global_masking_intensity_in_bark(
                mdct_amplitudes, tonality_per_block, drown
            )
            thr = self._bark_intensity_to_freq_ampl(global_in_bark)
            if self.calibrated:
                # calibrated mode refines the quiet floor on the fine
                # filter-band grid — the Bark-midpoint sampling of the
                # steep quiet curve is the dominant resolution
                # dependence at the spectrum edges (DESIGN.md §4b)
                thr = jnp.maximum(thr, self.quiet_threshold_freq_amp)
            return thr

    def global_masking_intensity_in_bark(
        self, mdct_amplitudes, tonality_per_block, drown=0.0
    ) -> jax.Array:
        """The Bark-domain global masking intensity
        [batches_n, blocks_n, bark_bands_n, channels_n]: max(masking,
        threshold-in-quiet), before mapping back to filter bands.

        This compact representation (bark_bands_n << filter_bands_n) is
        what a bitstream transmits so the decoder can reconstruct the
        quantization step sizes (see codec.Codec.encode_bitstream)."""
        masking = self._masking_intensity_in_bark(
            mdct_amplitudes, tonality_per_block, drown
        )
        return jnp.maximum(masking, self.quiet_threshold_intensity)

    def bark_intensity_to_threshold(self, bark_intensity) -> jax.Array:
        """Bark-domain masking intensity -> per-filter-band threshold
        amplitudes (the decoder-side half of global_masking_threshold)."""
        return self._bark_intensity_to_freq_ampl(bark_intensity)

    def add_noise(
        self, key: jax.Array, mdct_amplitudes, masking_threshold
    ) -> jax.Array:
        """Add inaudible Gaussian noise shaped by the masking threshold.

        sigma = threshold / 6 ("3-sigma both directions": 0.2% exceedance,
        reference psychoacoustic.py:151-167). Takes an explicit PRNG key —
        the one deliberate API difference from the reference's global-seeded
        tf.random.normal.
        """
        noise = masking_threshold * jax.random.normal(
            key, mdct_amplitudes.shape, dtype=self.compute_dtype
        ) * _dtypes.scalar(1.0 / 6.0, self.compute_dtype)
        return mdct_amplitudes + noise

    # -- Bark mapping ---------------------------------------------------------

    def _to_bark_intensity(self, mdct_amplitudes) -> jax.Array:
        """Filter-band amplitudes -> Bark-band intensities
        (reference psychoacoustic.py:301-315)."""
        return jnp.einsum(
            "nbic,ij->nbjc",
            mdct_amplitudes**2,
            self.W,
            precision=self._matmul_precision,
        ).astype(self.compute_dtype)

    def _bark_intensity_to_freq_ampl(self, bark_intensity) -> jax.Array:
        """Bark-band intensities -> filter-band amplitudes: linear intensity
        split, then sqrt (reference psychoacoustic.py:317-331).

        This is the sidecar expansion that encoder and decoder both run
        to derive step sizes, so every backend must get the same bits:
        the contraction is pinned to HIGHEST whatever ``bark_precision``
        says (a TF32 product rounds W_inv's entries), and the square
        root is correctly rounded (:func:`_exact_sqrt`). On the CPU both
        were already exact, so neither changes a bit there."""
        intensity = jnp.einsum(
            "nbic,ij->nbjc",
            bark_intensity,
            self.W_inv,
            precision=jax.lax.Precision.HIGHEST,
        ).astype(self.compute_dtype)
        return _exact_sqrt(jnp.maximum(self._eps, intensity))
