"""Drop-in API compatibility with the reference library.

The reference is used as::

    from audiocodec.mdctransformer import MDCTransformer
    from audiocodec import psychoacoustic
    mdct = MDCTransformer(filters_n, window_type)
    pa = psychoacoustic.PsychoacousticModel(sample_rate, ...)

This module lets that code run on JAX by switching only the import::

    from audiocodec_tpu.compat import MDCTransformer, PsychoacousticModel

Constructor signatures match the reference exactly
(audiocodec/mdctransformer.py:13-14, psychoacoustic.py:13-15). The
``precompute_dtype`` argument is pinned: this framework ALWAYS precomputes
in float64 on the host (the reference's default) and downcasts once;
passing a lower-precision precompute_dtype emits a UserWarning instead of
silently changing numerics. Dtypes may be passed as jnp dtypes, numpy
dtypes, or strings.

One semantic difference is unavoidable: JAX has no global RNG, so
``add_noise`` here draws from an internal counter-based key stream seeded
per instance (deterministic per construction order, like TF's global seed
behaves within one program). Pass ``key=`` explicitly for reproducible
pipelines — or use the native API (audiocodec_tpu.PsychoacousticModel).
"""

from __future__ import annotations

import itertools
import warnings

import jax
import functools

import jax.numpy as jnp

from audiocodec_tpu import mdct as _mdct
from audiocodec_tpu import psycho as _psycho

_instance_counter = itertools.count()


def _check_precompute_dtype(precompute_dtype):
    """This framework always precomputes in float64 on the host (the
    reference's *default*, mdctransformer.py:14). A non-default request is
    honored in spirit — results are at least as accurate — but the exact
    low-precision rounding of e.g. a float32 precompute is not reproduced,
    so say so loudly rather than silently.

    Why not honor it exactly: the reference's f32-precompute numbers are
    the rounding trail of ITS computation graph — a dense polyphase
    convolution plus `tf.linalg.inv` in float32
    (mdctransformer.py:176-190). This rebuild derives the same constants
    through a different, closed-form graph (sparse diamond fold, exact
    2x2 block inverse — ops/folding.py:16-37), so running OUR precompute
    in float32 would produce a THIRD set of values: strictly less
    accurate than the float64 path while still not bit-matching TF's
    float32. Between two ways to deviate, the shim picks the one that is
    a numerical superset of both, and warns."""
    if precompute_dtype is None:
        return
    name = getattr(precompute_dtype, "name", None) or str(precompute_dtype)
    if "float64" in name or "f64" in name:
        return
    warnings.warn(
        f"precompute_dtype={name!r} requested, but audiocodec_tpu always "
        "precomputes constants in float64 on the host and downcasts once "
        "to compute_dtype; a reduced-precision precompute is not "
        "reproduced bit-for-bit (it would only be less accurate).",
        stacklevel=3,
    )


def _canonical(dtype):
    """Accept tf-style/np/str dtype spellings."""
    name = getattr(dtype, "name", None) or str(dtype)
    name = name.split(".")[-1].strip("'<>")
    return jnp.dtype(name)


class MDCTransformer:
    """Reference-signature wrapper over audiocodec_tpu.mdct.MDCT
    (reference: audiocodec/mdctransformer.py:12-59)."""

    def __init__(self, filters_n=1024, window_type="vorbis",
                 compute_dtype=jnp.float32, precompute_dtype=None):
        _check_precompute_dtype(precompute_dtype)
        self._m = _mdct.MDCT.create(
            filters_n=filters_n,
            window_type=window_type,
            compute_dtype=_canonical(compute_dtype),
        )
        self.filters_n = filters_n
        self.window_type = window_type

    @functools.cached_property
    def H(self):
        """[2, filters_n, filters_n] analysis polyphase tensor, the exact
        attribute the reference exposes (mdctransformer.py:58):
        y[n] = x[n] @ H[0] + x[n-1] @ H[1], unscaled. Built lazily on first
        access (the compute path never materializes it), then cached like
        the reference's stored attribute.
        """
        from audiocodec_tpu.ops import folding as _folding

        h0, h1 = _folding.dense_fold_matrices(
            self.filters_n, self.window_type
        )
        return jnp.asarray(
            jnp.stack([jnp.asarray(h0), jnp.asarray(h1)]),
            dtype=self._m.compute_dtype,
        )

    @functools.cached_property
    def H_inv(self):
        """[2, filters_n, filters_n] synthesis polyphase tensor
        (mdctransformer.py:59): out[n] = z[n] @ H_inv[0] + z[n-1] @ H_inv[1].
        """
        from audiocodec_tpu.ops import folding as _folding

        g0, g1 = _folding.dense_unfold_matrices(
            self.filters_n, self.window_type
        )
        return jnp.asarray(
            jnp.stack([jnp.asarray(g0), jnp.asarray(g1)]),
            dtype=self._m.compute_dtype,
        )

    def transform(self, x):
        return self._m.transform(jnp.asarray(x))

    def inverse_transform(self, mdct_amplitudes):
        return self._m.inverse_transform(jnp.asarray(mdct_amplitudes))


class PsychoacousticModel:
    """Reference-signature wrapper over audiocodec_tpu.psycho
    (reference: audiocodec/psychoacoustic.py:13-69)."""

    def __init__(self, sample_rate, filter_bands_n=1024, bark_bands_n=64,
                 alpha=0.6, compute_dtype=jnp.float32,
                 precompute_dtype=None):
        _check_precompute_dtype(precompute_dtype)
        self._p = _psycho.PsychoacousticModel.create(
            sample_rate,
            filter_bands_n=filter_bands_n,
            bark_bands_n=bark_bands_n,
            alpha=alpha,
            compute_dtype=_canonical(compute_dtype),
        )
        self.sample_rate = sample_rate
        self.filter_bands_n = filter_bands_n
        self.bark_bands_n = bark_bands_n
        self.alpha = alpha
        self._noise_key = jax.random.key(next(_instance_counter))

    # attribute surface the reference exposes
    @property
    def compute_dtype(self):
        return self._p.compute_dtype

    @property
    def max_frequency(self):
        """Nyquist (reference: audiocodec/psychoacoustic.py:61)."""
        return self.sample_rate / 2.0

    @property
    def max_bark(self):
        """Bark value at Nyquist (reference: psychoacoustic.py:62)."""
        return self._p.max_bark

    @property
    def bark_band_width(self):
        """Bark width per Bark band (reference: psychoacoustic.py:63)."""
        return self._p.max_bark / self.bark_bands_n

    def freq2bark(self, frequencies):
        """bark = 6*asinh(f/600) (reference: psychoacoustic.py:333)."""
        return 6.0 * jnp.arcsinh(jnp.asarray(frequencies) / 600.0)

    def bark2freq(self, bark_band):
        """f = 600*sinh(b/6) (reference: psychoacoustic.py:337)."""
        return 600.0 * jnp.sinh(jnp.asarray(bark_band) / 6.0)

    @property
    def W(self):
        return self._p.W

    @property
    def W_inv(self):
        return self._p.W_inv

    @property
    def spreading_matrix(self):
        return self._p.spreading_matrix

    @property
    def quiet_threshold_intensity(self):
        return self._p.quiet_threshold_intensity

    def amplitude_to_dB(self, mdct_amplitude):
        return self._p.amplitude_to_dB(jnp.asarray(mdct_amplitude))

    def amplitude_to_dB_norm(self, mdct_amplitude):
        return self._p.amplitude_to_dB_norm(jnp.asarray(mdct_amplitude))

    def tonality(self, mdct_amplitudes):
        return self._p.tonality(jnp.asarray(mdct_amplitudes))

    def global_masking_threshold(self, mdct_amplitudes, tonality_per_block,
                                 drown=0.0):
        return self._p.global_masking_threshold(
            jnp.asarray(mdct_amplitudes),
            jnp.asarray(tonality_per_block),
            drown,
        )

    def add_noise(self, mdct_amplitudes, masking_threshold, key=None):
        """Reference call shape (no key). Without ``key``, an internal
        stream advances per call — analogous to TF's global-seed RNG."""
        if key is None:
            self._noise_key, key = jax.random.split(self._noise_key)
        return self._p.add_noise(
            key, jnp.asarray(mdct_amplitudes), jnp.asarray(masking_threshold)
        )
