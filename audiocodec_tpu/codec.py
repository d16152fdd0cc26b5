"""End-to-end perceptual codec pipeline as single jit-compiled programs.

Composes the MDCT filter bank and the psychoacoustic model exactly the way
the reference's tests / intended use do (SURVEY.md §3.5; reference has no
pipeline object of its own):

  wav -> MDCT.transform -> tonality -> global_masking_threshold
      -> add_noise | quantize                                  ["encode"]
      -> MDCT.inverse_transform                                ["decode"]

Everything here is a pure function of (codec pytree, arrays, PRNG key), so
the whole chain traces into ONE XLA program — fold, DCT matmul, Bark
matmuls, masking, and noise all fuse; no host round trips between stages.
"""

from __future__ import annotations

import dataclasses
import functools
import typing

import jax
import jax.numpy as jnp

from audiocodec_tpu import blockswitch as _blockswitch
from audiocodec_tpu import bwe as _bwe
from audiocodec_tpu import intensity as _intensity
from audiocodec_tpu import nf as _nf
from audiocodec_tpu import psycho as _psycho
from audiocodec_tpu import quantize as _quantize
from audiocodec_tpu import scq as _scq
from audiocodec_tpu import tns as _tns
from audiocodec_tpu.mdct import MDCT
from audiocodec_tpu.psycho import PsychoacousticModel


class EncodedFrames(typing.NamedTuple):
    """One encode's transmissible payload (Codec.encode_frames): the
    optional members are None exactly when their feature was off, so
    callers never index variable-length tuples (the positional-unpack
    coupling that broke once per added sidecar)."""

    codes: jax.Array  # int32 [B, frames, N, C]
    bark16: jax.Array  # bfloat16 [B, frames, bark_n, C or 1 (ms)]
    tns_idx: jax.Array | None  # int8 [B, frames, order, C]
    nf_levels: jax.Array | None  # uint8 [B, frames, C]
    bs_flags: jax.Array | None = None  # bool [B, frames] (blockswitch)
    bwe_gains: jax.Array | None = None  # uint8 [B, frames, groups, C]
    is_gains: jax.Array | None = None  # uint8 [B, frames, groups] (ms)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["mdct", "psycho"],
    meta_fields=["sidecar_grid"],
)
@dataclasses.dataclass(frozen=True)
class Codec:
    """MDCT + psychoacoustic model bundled as one pytree."""

    mdct: MDCT
    psycho: PsychoacousticModel
    # levels-per-octave of the sidecar's log grid (scq.py); 0 = legacy
    # raw-bfloat16 sidecars. Encoder-side: the wire records the grid, so
    # decoders never need a matching field.
    sidecar_grid: int = _scq.DEFAULT_K2

    @classmethod
    def create(
        cls,
        sample_rate,
        filters_n: int = 1024,
        bark_bands_n: int = 64,
        alpha: float = 0.6,
        window_type="vorbis",
        compute_dtype=jnp.float32,
        fast_bf16: bool = False,
        dct_precision: str = "highest",
        bark_precision: str | None = None,
        sidecar_grid: int = _scq.DEFAULT_K2,
    ) -> "Codec":
        """Build the codec pytree.

        :param bark_precision: matmul precision of the psychoacoustic
            Bark contractions; defaults to ``dct_precision`` (one knob for
            the whole pipeline). Decoders of transmitted bitstreams must
            use the precision recorded in the container — it is
            step-size-critical (the Bark sidecar expands through W_inv).
        :param sidecar_grid: levels per octave of the Bark sidecar's log
            grid (scq.py); 0 ships legacy raw-bfloat16 sidecars. The
            default (4 -> 0.75 dB steps) shrinks the sidecar — the
            LARGEST member of low-rate containers — ~3.4x at measured-
            unchanged SNR/NMR. Recorded in containers; decode needs no
            matching knob.
        """
        if sidecar_grid:
            _scq.validate_k2(sidecar_grid)
        return cls(
            sidecar_grid=int(sidecar_grid),
            mdct=MDCT.create(
                filters_n=filters_n,
                window_type=window_type,
                compute_dtype=compute_dtype,
                fast_bf16=fast_bf16,
                dct_precision=dct_precision,
            ),
            psycho=PsychoacousticModel.create(
                sample_rate,
                filter_bands_n=filters_n,
                bark_bands_n=bark_bands_n,
                alpha=alpha,
                compute_dtype=compute_dtype,
                # one precision knob for the whole pipeline by default:
                # the Bark contractions follow the DCT's precision ladder
                # (their ~1e-3 relative threshold error at "default" is
                # inaudible next to quantization noise). Containers record
                # the encoder's bark_precision so decoders reconstruct
                # bit-identical step sizes.
                # "int8" is an MDCT-only mode: the Bark ladder stays on
                # lax.Precision (bark_precision is step-size-critical and
                # its container enum does not include int8), so an int8
                # pipeline pairs with one-pass "default" Bark matmuls.
                bark_precision=(
                    ("default" if dct_precision == "int8" else dct_precision)
                    if bark_precision is None
                    else bark_precision
                ),
            ),
        )

    # -- reference-parity path: noise injection ------------------------------

    def encode(self, x: jax.Array, key: jax.Array, drown=0.0) -> jax.Array:
        """Lossy "encode": spectrum with masked noise injected.

        :param x: waveform [batches_n, samples_n, channels_n] in [-1, 1].
        :param key: PRNG key for the noise.
        :return: noisy spectrum [batches_n, blocks_n + 1, filters_n, channels_n].
        """
        spectrum = self.mdct.transform(x)
        tonality = self.psycho.tonality(spectrum)
        threshold = self.psycho.global_masking_threshold(
            spectrum, tonality, drown
        )
        return self.psycho.add_noise(key, spectrum, threshold)

    def decode(self, spectrum: jax.Array) -> jax.Array:
        """Decode: inverse MDCT. [B, blocks, N, C] -> [B, (blocks+1)*N, C]."""
        return self.mdct.inverse_transform(spectrum)

    def round_trip(self, x: jax.Array, key: jax.Array, drown=0.0) -> jax.Array:
        """encode + decode in one program. Output has filters_n padding
        samples at each end relative to the input (blocks+1 framing twice)."""
        return self.decode(self.encode(x, key, drown))

    # -- quantized path -------------------------------------------------------

    def encode_quantized(self, x: jax.Array, drown=0.0):
        """Deterministic encode to integer codes + step sizes.

        :return: (codes int32 [B, blocks+1, N, C], step sizes, threshold).
        """
        spectrum = self.mdct.transform(x)
        tonality = self.psycho.tonality(spectrum)
        threshold = self.psycho.global_masking_threshold(
            spectrum, tonality, drown
        )
        codes, delta = _quantize.quantize(spectrum, threshold)
        return codes, delta, threshold

    def decode_quantized(self, codes: jax.Array, delta: jax.Array) -> jax.Array:
        """Codes + step sizes -> waveform."""
        spectrum = _quantize.dequantize(
            codes, delta, dtype=self.mdct.compute_dtype
        )
        return self.decode(spectrum)

    def round_trip_quantized(self, x: jax.Array, drown=0.0) -> jax.Array:
        codes, delta, _ = self.encode_quantized(x, drown)
        return self.decode_quantized(codes, delta)

    # -- bitstream path: what actually gets transmitted -----------------------

    @staticmethod
    def to_mid_side(x: jax.Array) -> jax.Array:
        """Stereo (channels last, size 2) -> mid/side, orthonormal. Works on
        waveforms and spectra alike (the MDCT is linear, so transforming
        then rotating equals rotating then transforming)."""
        scale = jnp.asarray(1.0 / jnp.sqrt(2.0), dtype=x.dtype)
        mid = (x[..., 0:1] + x[..., 1:2]) * scale
        side = (x[..., 0:1] - x[..., 1:2]) * scale
        return jnp.concatenate([mid, side], axis=-1)

    @staticmethod
    def from_mid_side(ms: jax.Array) -> jax.Array:
        """Inverse of :meth:`to_mid_side` (self-inverse up to roundoff)."""
        return Codec.to_mid_side(ms)

    def encode_bitstream_ms(self, x: jax.Array, drown=0.0,
                            deadzone: float = 0.5, tmask: float = 0.0):
        """Joint-stereo encode: quantize mid/side spectra against the
        conservative per-band min of the LEFT/RIGHT masking thresholds.

        Thresholds must come from the signal the listener hears (L/R) —
        masking the side channel by its own (tiny) energy would faithfully
        code inaudible content and GROW the file. With min(L, R) the
        quantization noise stays below audibility in both output channels
        (the orthonormal rotation splits each M/S noise power equally into
        L and R), while correlated content drives the side codes to zero.

        The transmitted sidecar is the per-band MIN over channels of the
        Bark intensity — a single channel's worth (halving the sidecar),
        and since the Bark→threshold map is positive-linear, the threshold
        it yields lower-bounds both channels' thresholds (conservative).

        :param x: stereo waveform [B, S, 2].
        :return: (codes [B, blocks+1, N, 2], bark16 [B, blocks+1, bark, 1]).
        """
        return self.quantize_frames(self.mdct.transform(x), drown, ms=True,
                                    deadzone=deadzone, tmask=tmask)

    def _ms_threshold(self, bark16_min: jax.Array) -> jax.Array:
        thr = self.psycho.bark_intensity_to_threshold(
            bark16_min.astype(self.mdct.compute_dtype)
        )
        return jnp.broadcast_to(thr, thr.shape[:-1] + (2,))

    def decode_bitstream_ms(self, codes: jax.Array, bark16: jax.Array,
                            threshold_scale=1.0,
                            dz_recon: float = 0.0,
                            tns_idx: jax.Array | None = None,
                            tns_band_start: int | None = None,
                            nf_levels: jax.Array | None = None,
                            nf_band_start: int | None = None,
                            nf_seed=0, nf_frame_offset=0,
                            bs_flags: jax.Array | None = None,
                            bwe_gains: jax.Array | None = None,
                            bwe_start: int | None = None,
                            is_gains: jax.Array | None = None,
                            is_start: int | None = None
                            ) -> jax.Array:
        """Inverse of :meth:`encode_bitstream_ms` -> L/R waveform.

        :param dz_recon: dead-zone reconstruction offset (the container's
            ``dzr`` field; 0 for plain-rounded streams).
        :param tns_idx: TNS reflection indices from the encoder (the
            ``tns`` container member); None for unfiltered streams. The
            inverse filter runs in the coded (mid/side) domain, before
            the stereo derotation — mirroring the encoder's order.
        :param tns_band_start: the band start the ENCODER filtered from
            (the container records it); defaults to this codec's own.
        :param nf_levels: noise-fill levels from the encoder (the ``nfl``
            container member); None for unfilled streams. Filling happens
            in the coded domain before the TNS inverse filter (nf.py).
        :param nf_seed: the container's recorded noise seed;
            ``nf_frame_offset`` is the global index of ``codes``' first
            frame (nonzero for chunked/seeking decoders).
        :param bwe_gains: bandwidth-extension replication gains from the
            encoder (the ``bwe`` container member); None for
            non-replicated streams. The copy-up happens in the coded
            domain, before the noise fill (which it caps at
            ``bwe_start``) and the TNS inverse filter (bwe.py).
        :param is_gains: intensity-stereo image gains from the encoder
            (the ``isg`` container member); None for fully-coded
            streams. The side rebuild happens in the coded domain, and
            nf/bwe exclude the owned region exactly as the encoder did
            (intensity.py).
        """
        thr = self._ms_threshold(bark16) * jnp.asarray(
            threshold_scale, dtype=self.mdct.compute_dtype
        )
        if tns_idx is not None:
            tbs = (self.tns_band_start if tns_band_start is None
                   else tns_band_start)
            thr = _tns.scaled_threshold(thr, tns_idx, tbs)
        if bs_flags is not None:
            thr = _blockswitch.pool_threshold(thr, bs_flags)
        delta = _quantize.step_size(thr)
        spec_ms = _quantize.dequantize(
            codes, delta, dtype=self.mdct.compute_dtype,
            recon_offset=dz_recon,
        )
        excl = ist = None
        if is_gains is not None:
            ist = self.is_start if is_start is None else is_start
            excl = jnp.asarray(
                _intensity.owned_mask(self.mdct.filters_n, ist)
            )
        bst = None
        if bwe_gains is not None:
            bst = self.bwe_start if bwe_start is None else bwe_start
            spec_ms = _bwe.fill(spec_ms, codes, delta, bwe_gains, bst,
                                exclude=excl)
        if nf_levels is not None:
            bs_nf = (self.nf_band_start if nf_band_start is None
                     else nf_band_start)
            spec_ms = _nf.fill(spec_ms, codes, delta, nf_levels, bs_nf,
                               nf_seed, nf_frame_offset, band_end=bst,
                               exclude=excl)
        if is_gains is not None:
            # with bwe active the fill scales the bwe-reconstructed mid
            # — the exact reference the encoder projected onto
            mid_ref = None
            if bwe_gains is not None:
                mid_ref = _intensity.mid_reference(
                    codes, delta, self.mdct.compute_dtype,
                    bwe_gains=bwe_gains, bwe_start=bst, exclude=excl,
                )
            spec_ms = _intensity.fill(spec_ms, codes, delta, is_gains,
                                      ist, mid_ref=mid_ref)
        if bs_flags is not None:
            spec_ms = _blockswitch.merge_spectrum(
                spec_ms, bs_flags, precision=self.mdct.dct_precision
            )
        if tns_idx is not None:
            spec_ms = _tns.filter_inverse(spec_ms, tns_idx, tbs)
        return self.decode(self.from_mid_side(spec_ms))

    def encode_bitstream(self, x: jax.Array, drown=0.0,
                         deadzone: float = 0.5, tmask: float = 0.0):
        """Encode to the transmissible representation: integer codes plus
        the Bark-domain masking intensity (bark_bands_n << filter_bands_n
        values per block) from which the decoder re-derives step sizes.

        The Bark intensity is rounded to bfloat16 *before* deriving the
        encoder's own quantization steps, so encoder and decoder use
        bit-identical thresholds. (bfloat16, not float16: intensities reach
        the 1e-14 floor, below float16's exponent range — the same reason
        the compute-dtype whitelist excludes float16.)

        :return: (codes int32 [B, blocks+1, N, C],
                  bark_intensity bfloat16 [B, blocks+1, bark_bands_n, C]).
        """
        return self.quantize_frames(self.mdct.transform(x), drown,
                                    deadzone=deadzone, tmask=tmask)

    def analyze_for_quantization(self, frames: jax.Array, drown=0.0,
                                 ms: bool = False, tmask: float = 0.0,
                                 tmask_context: jax.Array | None = None,
                                 bs: bool = False):
        """The bitstream-compatibility-critical analysis, in ONE place:
        tonality -> Bark masking intensity -> bf16-rounded sidecar ->
        threshold (and the mid/side rotation + min-channel sidecar when
        ``ms``). Everything that quantizes for a bitstream (.acz, .acs,
        rate control) goes through here so encoder and decoder can never
        derive different step sizes.

        :param tmask: forward (post-)masking decay in dB per SECOND
            (0 = off, ~130 matches the literature's 100-200 ms span —
            see psycho.temporal_masking). Purely encoder-side: the spread
            intensity is what the bf16 sidecar rounds, so decoders derive
            matching steps from the container with no format change.
        :param tmask_context: previous chunk's trailing pre-spread Bark
            intensities for streaming continuity (see
            :meth:`tmask_context_frames`).
        :param bs: block switching (blockswitch.py) — detect transient
            frames from the (pre-rotation) long spectrum. The returned
            spectrum/threshold are still long-basis: callers apply
            split_spectrum / pool_threshold at the bit-exactness-correct
            point (pooling LAST, after every threshold scaling — the
            decoders mirror that order).
        :return: (quantizable spectrum, bark16 sidecar, base threshold,
            bs_flags bool [B, frames] or None).
        """
        bs_flags = (
            _blockswitch.detect(
                frames, precision=self.mdct.dct_precision
            ) if bs else None
        )
        tonality = self.psycho.tonality(frames)
        bark = self.psycho.global_masking_intensity_in_bark(
            frames, tonality, drown
        )
        if tmask:
            bark = _psycho.temporal_masking(
                bark, self._tmask_db_per_frame(tmask),
                context=tmask_context,
            )
        if ms:
            if frames.shape[-1] != 2:
                raise ValueError("joint stereo needs exactly 2 channels")
            bark_m = jnp.min(bark, axis=-1, keepdims=True)
            bark16 = (_scq.snap(bark_m, self.sidecar_grid)
                      if self.sidecar_grid else bark_m.astype(jnp.bfloat16))
            return (self.to_mid_side(frames), bark16,
                    self._ms_threshold(bark16), bs_flags)
        bark16 = (_scq.snap(bark, self.sidecar_grid)
                  if self.sidecar_grid else bark.astype(jnp.bfloat16))
        threshold = self.psycho.bark_intensity_to_threshold(
            bark16.astype(self.mdct.compute_dtype)
        )
        return frames, bark16, threshold, bs_flags

    def _tmask_db_per_frame(self, tmask_db_per_s: float) -> float:
        """dB-per-second forward-masking decay -> dB per frame hop
        (one frame advances filters_n samples)."""
        return (
            float(tmask_db_per_s) * self.mdct.filters_n
            / self.psycho.sample_rate
        )

    def tmask_context_frames(self, tmask_db_per_s: float) -> int:
        """Context frames a streaming encoder carries for bit-exact
        chunk-boundary temporal masking (psycho.temporal_masking_window
        at this codec's frame rate)."""
        return _psycho.temporal_masking_window(
            self._tmask_db_per_frame(tmask_db_per_s)
        )

    def bark_intensity(self, frames: jax.Array, drown=0.0) -> jax.Array:
        """Pre-spread Bark masking intensity of ``frames`` — what
        streaming encoders carry as temporal-masking context (recomputing
        it from the same frames is bit-identical to the values
        analyze_for_quantization derived)."""
        return self.psycho.global_masking_intensity_in_bark(
            frames, self.psycho.tonality(frames), drown
        )

    def quantize_frames(self, frames: jax.Array, drown=0.0,
                        threshold_scale=1.0, ms: bool = False,
                        deadzone: float = 0.5, nf: bool = False,
                        tmask: float = 0.0,
                        tmask_context: jax.Array | None = None,
                        bs: bool = False, bwe: bool = False,
                        intensity: bool = False):
        """Spectral frames -> (codes, bf16 Bark sidecar); the frame-level
        half of encode_bitstream[_ms], shared with the streaming container.

        :param threshold_scale: multiplies the quantization thresholds
            (> 1 = coarser codes / fewer bits). Unlike ``drown`` it is
            unbounded, which makes it the rate-control knob (see rate.py);
            the decoder must apply the same scale.
        :param ms: joint mid/side coding (stereo frames only) — quantizes
            the rotated spectra against the conservative min-channel
            threshold (see encode_bitstream_ms).
        :param deadzone: zero-bin half-width in step units (static Python
            float; 0.5 = plain rounding — see quantize.quantize). A
            non-default value obliges the decoder to apply the matching
            reconstruction offset, so it must be recorded in the
            container (the ``dzr`` field).
        :param nf: noise filling (nf.py) — additionally returns uint8
            fill levels [B, frames, C] measured from what the quantizer
            zeroed; the decoder re-synthesizes those bins with matching
            shaped noise (the ``nfl`` container member). All-zero levels
            mean nothing to fill.
        :param tmask: forward-masking decay in dB/s (0 = off); encoder-
            side only, flows into the sidecar — see
            analyze_for_quantization.
        :param bs: block switching (blockswitch.py) — transient frames
            quantize in the short (time-split) basis against the
            MIN-pooled threshold, confining their quantization noise to
            ~2·N/8 samples instead of ~2·N (pre-echo). The per-frame
            flags are appended to the return and are bitstream-critical
            (the ``bsw`` container member). Noise-fill levels are zeroed
            on short frames (an attack masks; holes are a stationary
            phenomenon).
        :param bwe: bandwidth extension (bwe.py) — additionally returns
            uint8 replication gains [B, frames, groups, C]: the decoder
            rebuilds zero-coded bins above the crossover
            (:attr:`bwe_start`) by copying the decoded low band up and
            scaling each 16-bin group to the transmitted envelope (the
            ``bwe`` container member). With ``nf`` too, the noise fill
            caps at the crossover — BWE owns the top. Gains are zeroed
            on short block-switch frames (the split basis is not a
            frequency axis).
        :param intensity: intensity stereo (intensity.py, requires
            ``ms``) — the side channel stops being coded at/above the
            crossover (:attr:`is_start`): its codes are forced to zero
            (saving their bits) and uint8 per-(frame, group) signed
            image gains are appended to the return; the decoder
            rebuilds side = gain * decoded mid there (the ``isg``
            container member). Measured +2.7 dB SNR at matched bytes
            on panned content; side content uncorrelated with the mid
            is dropped above the crossover — an explicit low-rate
            trade. nf/bwe exclude the owned region on both sides.
        """
        spec_q, bark16, threshold, bs_flags = self.analyze_for_quantization(
            frames, drown, ms=ms, tmask=tmask,
            tmask_context=tmask_context, bs=bs,
        )
        threshold = threshold * jnp.asarray(
            threshold_scale, dtype=self.mdct.compute_dtype
        )
        if bs:
            spec_q = _blockswitch.split_spectrum(
                spec_q, bs_flags, precision=self.mdct.dct_precision
            )
            threshold = _blockswitch.pool_threshold(threshold, bs_flags)
        codes, delta = _quantize.quantize(spec_q, threshold,
                                          deadzone=deadzone)
        excl = None
        if intensity:
            codes, excl = self._intensity_force(codes, bs_flags, ms)
        out = (codes, bark16)
        if nf:
            nfl = _nf.analyze(spec_q, codes, delta, self.nf_band_start,
                              deadzone=deadzone,
                              band_end=self.bwe_start if bwe else None,
                              exclude=excl)
            if bs:
                nfl = jnp.where(bs_flags[:, :, None],
                                jnp.zeros_like(nfl), nfl)
            out = out + (nfl,)
        if bwe:
            gains = _bwe.analyze(spec_q, codes, delta, self.bwe_start,
                                 exclude=excl)
            if bs:
                gains = jnp.where(bs_flags[:, :, None, None],
                                  jnp.zeros_like(gains), gains)
            out = out + (gains,)
        if intensity:
            out = out + (self._intensity_gains(
                spec_q, codes, delta, bs_flags,
                bwe_gains=gains if bwe else None, excl=excl,
            ),)
        if bs:
            out = out + (bs_flags,)
        return out

    def quantize_frames_fec(self, frames: jax.Array, drown=0.0,
                            threshold_scale=1.0, ms: bool = False,
                            deadzone: float = 0.5, tpool: int = 4):
        """Coarse redundant coding for stream FEC members
        (io/stream_container): plain quantize (no feature ladder)
        against a TIME-POOLED Bark sidecar — one level row per
        ``tpool`` frames, the MAX masking intensity of the group,
        snapped on this codec's sidecar grid. The sidecar dominates a
        redundant copy's bytes (its codes shrink with the fec scale,
        per-frame sidecar rows do not), and a loud group member masking
        for its quieter neighbors only coarsens an already-coarse
        emergency copy.

        :return: (codes [B, T, N, C], pooled bark16
            [B, ceil(T/tpool), bark_n, C or 1]). Quantization used
            exactly the repeat-expanded pooled sidecar, so a decoder
            expanding it the same way derives bit-identical step sizes.
        """
        tonality = self.psycho.tonality(frames)
        bark = self.psycho.global_masking_intensity_in_bark(
            frames, tonality, drown
        )
        if ms:
            if frames.shape[-1] != 2:
                raise ValueError("joint stereo needs exactly 2 channels")
            bark = jnp.min(bark, axis=-1, keepdims=True)
        b, t, nb, cc = bark.shape
        tpool = max(1, int(tpool))
        g = -(-t // tpool)
        pad = g * tpool - t
        if pad:
            bark = jnp.concatenate(
                [bark, jnp.repeat(bark[:, -1:], pad, axis=1)], axis=1
            )
        pooled = bark.reshape(b, g, tpool, nb, cc).max(axis=2)
        bark16 = (_scq.snap(pooled, self.sidecar_grid)
                  if self.sidecar_grid else pooled.astype(jnp.bfloat16))
        b16f = jnp.repeat(bark16, tpool, axis=1)[:, :t]
        if ms:
            spec = self.to_mid_side(frames)
            threshold = self._ms_threshold(b16f)
        else:
            spec = frames
            threshold = self.psycho.bark_intensity_to_threshold(
                b16f.astype(self.mdct.compute_dtype)
            )
        threshold = threshold * jnp.asarray(
            threshold_scale, dtype=self.mdct.compute_dtype
        )
        codes, _ = _quantize.quantize(spec, threshold, deadzone=deadzone)
        return codes, bark16

    def encode_frames(self, frames: jax.Array, drown=0.0,
                      threshold_scale=1.0, ms: bool = False,
                      deadzone: float = 0.5, tns: bool = False,
                      nf: bool = False, tmask: float = 0.0,
                      tmask_context: jax.Array | None = None,
                      bs: bool = False, bwe: bool = False,
                      intensity: bool = False) -> EncodedFrames:
        """One entry point for every coded-bitstream encode: wraps
        :meth:`quantize_frames` / :meth:`quantize_frames_tns` and always
        returns an :class:`EncodedFrames` (absent features are None) —
        the CLI, containers, and dryrun all unpack THIS, not
        flag-dependent tuple arities.
        """
        fn = self.quantize_frames_tns if tns else self.quantize_frames
        out = fn(
            frames, drown, threshold_scale=threshold_scale, ms=ms,
            deadzone=deadzone, nf=nf, tmask=tmask,
            tmask_context=tmask_context, bs=bs, bwe=bwe,
            intensity=intensity,
        )
        i = 3 if tns else 2
        nfl = out[i] if nf else None
        i += 1 if nf else 0
        gains = out[i] if bwe else None
        i += 1 if bwe else 0
        isg = out[i] if intensity else None
        i += 1 if intensity else 0
        return EncodedFrames(out[0], out[1], out[2] if tns else None,
                             nfl, out[i] if bs else None, gains, isg)

    @property
    def tns_band_start(self) -> int:
        """First bin TNS filters cover (tns.default_band_start)."""
        return _tns.default_band_start(self.mdct.filters_n)

    @property
    def nf_band_start(self) -> int:
        """First bin noise filling covers (nf.default_band_start)."""
        return _nf.default_band_start(self.mdct.filters_n)

    @property
    def bwe_start(self) -> int:
        """First bin bandwidth extension replicates
        (bwe.default_start for this configuration)."""
        return _bwe.default_start(
            self.mdct.filters_n, self.psycho.sample_rate
        )

    @property
    def is_start(self) -> int:
        """First bin intensity stereo owns (intensity.default_start
        for this configuration)."""
        return _intensity.default_start(
            self.mdct.filters_n, self.psycho.sample_rate
        )

    def _intensity_force(self, codes, bs_flags, ms):
        """The ONE encoder-side intensity setup (shared by both
        quantize paths and rate.py): force the owned side band's codes
        to zero and build the nf/bwe exclusion mask."""
        if not ms:
            raise ValueError("intensity stereo requires ms=True (it "
                             "codes the mid/side layout)")
        codes = _intensity.force_codes(codes, self.is_start, bs_flags)
        excl = jnp.asarray(
            _intensity.owned_mask(self.mdct.filters_n, self.is_start)
        )
        return codes, excl

    def _intensity_gains(self, spec, codes, delta, bs_flags,
                         bwe_gains=None, excl=None):
        """Encoder-side image gains; with bwe active the projection
        reference is the bwe-reconstructed mid (intensity.mid_reference
        — otherwise the top band's image would collapse to center)."""
        mid_ref = None
        if bwe_gains is not None:
            mid_ref = _intensity.mid_reference(
                codes, delta, self.mdct.compute_dtype,
                bwe_gains=bwe_gains, bwe_start=self.bwe_start,
                exclude=excl,
            )
        isg = _intensity.analyze(spec, codes, delta, self.is_start,
                                 mid_ref=mid_ref)
        if bs_flags is not None:
            # short frames kept their side codes (force_codes) and the
            # split basis has no frequency axis — no gains
            isg = jnp.where(bs_flags[:, :, None],
                            jnp.zeros_like(isg), isg)
        return isg

    def quantize_frames_tns(self, frames: jax.Array, drown=0.0,
                            threshold_scale=1.0, ms: bool = False,
                            deadzone: float = 0.5, nf: bool = False,
                            tmask: float = 0.0,
                            tmask_context: jax.Array | None = None,
                            bs: bool = False, bwe: bool = False,
                            intensity: bool = False):
        """:meth:`quantize_frames` with temporal noise shaping: frames
        whose spectrum is predictable along frequency (peaky time
        envelopes — transients) are whitened by an order-8 LPC filter
        before quantization, so the decoder's inverse filter concentrates
        quantization noise under the attack instead of smearing it across
        the frame as pre-echo (tns.py). In-band step sizes shrink by the
        gain-compensation rule (tns.scaled_threshold) so the shaped noise
        keeps roughly the unfiltered power — measured equal-or-better SNR
        at matched rate with 2-3x less pre-echo energy.

        :return: (codes, bark16, tns_idx int8 [B, frames, order, C]). The
            indices are bitstream-critical whenever any is nonzero — the
            decoder must inverse-filter with exactly these and derive the
            same scaled steps (the ``tns`` container member); all-zero
            means no frame fired (identity, unscaled). With ``nf`` a
            fourth element is appended: uint8 fill levels [B, frames, C]
            measured in the TNS-filtered domain (where the decoder fills
            BEFORE inverse filtering, so the fill noise gets the frame's
            time envelope too — exactly the AAC ordering).
        """
        spec_q, bark16, threshold, bs_flags = self.analyze_for_quantization(
            frames, drown, ms=ms, tmask=tmask,
            tmask_context=tmask_context, bs=bs,
        )
        tbs = self.tns_band_start
        tns_idx = _tns.analyze(spec_q, tbs)
        if bs:
            # short frames never TNS-filter (the block switch IS their
            # pre-echo treatment, and the LPC-along-frequency model does
            # not hold in the split basis): zeroed indices make every
            # TNS op an identity there, on both sides of the wire.
            tns_idx = jnp.where(bs_flags[:, :, None, None],
                                jnp.zeros_like(tns_idx), tns_idx)
        spec_f = _tns.filter_forward(spec_q, tns_idx, tbs)
        threshold = threshold * jnp.asarray(
            threshold_scale, dtype=self.mdct.compute_dtype
        )
        threshold = _tns.scaled_threshold(threshold, tns_idx, tbs)
        if bs:
            spec_f = _blockswitch.split_spectrum(
                spec_f, bs_flags, precision=self.mdct.dct_precision
            )
            threshold = _blockswitch.pool_threshold(threshold, bs_flags)
        codes, delta = _quantize.quantize(spec_f, threshold,
                                          deadzone=deadzone)
        excl = None
        if intensity:
            codes, excl = self._intensity_force(codes, bs_flags, ms)
        out = (codes, bark16, tns_idx)
        if nf:
            nfl = _nf.analyze(spec_f, codes, delta, self.nf_band_start,
                              deadzone=deadzone,
                              band_end=self.bwe_start if bwe else None,
                              exclude=excl)
            if bs:
                nfl = jnp.where(bs_flags[:, :, None],
                                jnp.zeros_like(nfl), nfl)
            out = out + (nfl,)
        if bwe:
            # analyzed in the TNS-filtered domain (where the decoder
            # fills, before its inverse filter) — same ordering as nf
            gains = _bwe.analyze(spec_f, codes, delta, self.bwe_start,
                                 exclude=excl)
            if bs:
                gains = jnp.where(bs_flags[:, :, None, None],
                                  jnp.zeros_like(gains), gains)
            out = out + (gains,)
        if intensity:
            # analyzed in the TNS-filtered domain too (the decoder
            # rebuilds the side there, before its inverse filter)
            out = out + (self._intensity_gains(
                spec_f, codes, delta, bs_flags,
                bwe_gains=gains if bwe else None, excl=excl,
            ),)
        if bs:
            out = out + (bs_flags,)
        return out

    def decode_bitstream(self, codes: jax.Array, bark16: jax.Array,
                         threshold_scale=1.0,
                         dz_recon: float = 0.0,
                         tns_idx: jax.Array | None = None,
                         tns_band_start: int | None = None,
                         nf_levels: jax.Array | None = None,
                         nf_band_start: int | None = None,
                         nf_seed=0, nf_frame_offset=0,
                         bs_flags: jax.Array | None = None,
                         bwe_gains: jax.Array | None = None,
                         bwe_start: int | None = None) -> jax.Array:
        """Inverse of :meth:`encode_bitstream`: codes + Bark intensities ->
        waveform [B, (blocks+1)*N, C].

        :param dz_recon: dead-zone reconstruction offset (the container's
            ``dzr`` field; 0 for plain-rounded streams).
        :param tns_idx: TNS reflection indices from the encoder (the
            ``tns`` container member); None for unfiltered streams.
        :param tns_band_start: the band start the ENCODER filtered from
            (the container records it); defaults to this codec's own.
        :param nf_levels: noise-fill levels from the encoder (the ``nfl``
            container member); None for unfilled streams. Filling happens
            in the coded domain before the TNS inverse filter (nf.py).
        :param nf_seed: the container's recorded noise seed;
            ``nf_frame_offset`` is the global index of ``codes``' first
            frame (nonzero for chunked/seeking decoders).
        :param bs_flags: per-frame block-switch flags from the encoder
            (the ``bsw`` container member, bool [B, frames]); None for
            long-only streams. Threshold pooling mirrors the encoder's
            order exactly (pool LAST, after every scaling) so step sizes
            stay bit-identical.
        :param bwe_gains: bandwidth-extension replication gains from the
            encoder (the ``bwe`` container member); None for
            non-replicated streams. The copy-up happens in the coded
            domain, before the noise fill (which it caps at
            ``bwe_start``) and the TNS inverse filter (bwe.py).
        """
        threshold = self.psycho.bark_intensity_to_threshold(
            bark16.astype(self.mdct.compute_dtype)
        ) * jnp.asarray(threshold_scale, dtype=self.mdct.compute_dtype)
        if tns_idx is not None:
            tbs = (self.tns_band_start if tns_band_start is None
                   else tns_band_start)
            threshold = _tns.scaled_threshold(threshold, tns_idx, tbs)
        if bs_flags is not None:
            threshold = _blockswitch.pool_threshold(threshold, bs_flags)
        delta = _quantize.step_size(threshold)
        spec = _quantize.dequantize(codes, delta,
                                    dtype=self.mdct.compute_dtype,
                                    recon_offset=dz_recon)
        bst = None
        if bwe_gains is not None:
            bst = self.bwe_start if bwe_start is None else bwe_start
            spec = _bwe.fill(spec, codes, delta, bwe_gains, bst)
        if nf_levels is not None:
            bs_nf = (self.nf_band_start if nf_band_start is None
                     else nf_band_start)
            spec = _nf.fill(spec, codes, delta, nf_levels, bs_nf,
                            nf_seed, nf_frame_offset, band_end=bst)
        if bs_flags is not None:
            spec = _blockswitch.merge_spectrum(
                spec, bs_flags, precision=self.mdct.dct_precision
            )
        if tns_idx is not None:
            spec = _tns.filter_inverse(spec, tns_idx, tbs)
        return self.decode(spec)
