"""End-to-end codec pipeline tests (SURVEY.md §3.5 composition +
the quantized path that is new in this framework)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiocodec_tpu import quantize
from audiocodec_tpu.codec import Codec
from tests.test_mdct import sine_wav


def snr_db(x, y):
    noise = np.asarray(x, dtype=np.float64) - np.asarray(y, dtype=np.float64)
    return 10 * np.log10(
        np.sum(np.asarray(x, dtype=np.float64) ** 2)
        / max(np.sum(noise**2), 1e-30)
    )


class TestNoisePath:
    def test_round_trip_audible_fidelity(self):
        """Full encode (with masked noise) + decode keeps high SNR: the
        injected noise sits below the masking threshold by construction."""
        filters_n = 256
        codec = Codec.create(16000, filters_n=filters_n, bark_bands_n=64)
        wave = sine_wav(0.8, 880, sample_rate=16000, duration_sec=1.0)
        wave = wave[:, : filters_n * (wave.shape[1] // filters_n)]
        out = codec.round_trip(wave, jax.random.key(0))
        # output has filters_n padding twice (encode pads a block, decode
        # pads another): interior comparison
        inner = out[:, 2 * filters_n : 2 * filters_n + wave.shape[1] - 2 * filters_n]
        ref = wave[:, filters_n:-filters_n]
        assert inner.shape == ref.shape
        # ~20 dB is the masking model's calibration point for a loud pure
        # tone: the noise fills the spectrum right up to the threshold.
        assert snr_db(ref, inner) > 15.0

    def test_encode_shapes(self):
        codec = Codec.create(44100, filters_n=128)
        wave = jnp.zeros((3, 10 * 128, 2), dtype=jnp.float32)
        spec = codec.encode(wave, jax.random.key(1))
        assert spec.shape == (3, 11, 128, 2)
        out = codec.decode(spec)
        assert out.shape == (3, 12 * 128, 2)

    def test_single_jit_program(self):
        """The whole chain jits as one program over the codec pytree."""
        codec = Codec.create(44100, filters_n=128)
        wave = jnp.ones((1, 8 * 128, 1), dtype=jnp.float32) * 0.3

        @jax.jit
        def pipeline(c, x, key):
            return c.round_trip(x, key)

        out = pipeline(codec, wave, jax.random.key(2))
        assert out.shape == (1, 10 * 128, 1)
        assert bool(jnp.all(jnp.isfinite(out)))


class TestQuantizedPath:
    def test_quantize_dequantize_error_bounded(self):
        """|dequantize(quantize(x)) - x| <= delta/2 everywhere."""
        rng = np.random.default_rng(0)
        amps = jnp.asarray(
            rng.uniform(-1, 1, size=(2, 4, 64, 1)), dtype=jnp.float32
        )
        thr = jnp.full_like(amps, 0.01)
        codes, delta = quantize.quantize(amps, thr)
        recon = quantize.dequantize(codes, delta)
        assert codes.dtype == jnp.int32
        err = jnp.abs(recon - amps)
        assert bool(jnp.all(err <= delta / 2 + 1e-7))

    def test_round_trip_quantized_snr(self):
        filters_n = 256
        codec = Codec.create(16000, filters_n=filters_n)
        wave = sine_wav(0.8, 880, sample_rate=16000, duration_sec=1.0)
        wave = wave[:, : filters_n * (wave.shape[1] // filters_n)]
        out = codec.round_trip_quantized(wave)
        inner = out[:, 2 * filters_n : wave.shape[1]]
        ref = wave[:, filters_n:-filters_n]
        assert snr_db(ref, inner) > 20.0

    def test_quantized_nmr_gate(self):
        """Noise-to-mask ratio of the quantized path: mean((err/thr)^2)
        is ~1/9 by construction (step = 2*thr/sqrt(3) -> uniform noise of
        power thr^2/9). A psychoacoustic regression that moves noise above
        the masking threshold at CONSTANT power blows this up while raw
        SNR stays put — so this gate sees what the SNR gates cannot."""
        filters_n = 256
        codec = Codec.create(16000, filters_n=filters_n, bark_bands_n=32)
        rng = np.random.default_rng(7)
        t = np.arange(40 * filters_n) / 16000
        wave = jnp.asarray(
            np.clip(
                0.5 * np.sin(2 * np.pi * 700 * t)
                + 0.1 * rng.normal(size=t.size),
                -1, 1,
            ).astype(np.float32)[None, :, None]
        )
        spec = codec.mdct.transform(wave)
        tonality = codec.psycho.tonality(spec)
        threshold = codec.psycho.global_masking_threshold(spec, tonality)
        codes, delta = quantize.quantize(spec, threshold)
        err = quantize.dequantize(codes, delta) - spec
        nmr = float(jnp.mean((err / threshold) ** 2))
        # nominal ~0.11; ceiling at ~2x nominal, floor guards against a
        # degenerate all-zero-codes regression reporting nmr ~ 0.33
        # (err = spec >> thr would instead explode upward)
        assert 0.01 < nmr < 0.25, nmr

    def test_quantized_noise_comparable_to_injection(self):
        """Quantization noise power is calibrated to the noise-injection
        path: SNRs should be within a few dB of each other."""
        filters_n = 256
        codec = Codec.create(16000, filters_n=filters_n)
        wave = sine_wav(0.5, 440, sample_rate=16000, duration_sec=1.0)
        wave = wave[:, : filters_n * (wave.shape[1] // filters_n)]
        ref = wave[:, filters_n:-filters_n]

        out_q = codec.round_trip_quantized(wave)[:, 2 * filters_n : wave.shape[1]]
        out_n = codec.round_trip(wave, jax.random.key(3))[
            :, 2 * filters_n : wave.shape[1]
        ]
        snr_q = snr_db(ref, out_q)
        snr_n = snr_db(ref, out_n)
        # The deadzone of the mid-tread quantizer zeroes sub-threshold bands
        # outright, so the quantized path may beat the additive-noise path —
        # but it must never be meaningfully worse.
        assert snr_q >= snr_n - 3.0

    def test_ste_gradient(self):
        """Straight-through estimator passes gradients to amplitudes only."""
        amps = jnp.asarray([[0.5, -0.3]], dtype=jnp.float32)
        thr = jnp.asarray([[0.1, 0.1]], dtype=jnp.float32)

        def loss(a, t):
            return jnp.sum(quantize.quantize_ste(a, t) ** 2)

        ga, gt = jax.grad(loss, argnums=(0, 1))(amps, thr)
        assert bool(jnp.all(jnp.isfinite(ga)))
        assert bool(jnp.all(gt == 0.0))


class TestDrown:
    def test_drown_degrades_quality(self):
        """Higher drown -> more noise -> lower SNR (monotone behavior)."""
        filters_n = 256
        codec = Codec.create(16000, filters_n=filters_n)
        wave = sine_wav(0.8, 880, sample_rate=16000, duration_sec=1.0)
        wave = wave[:, : filters_n * (wave.shape[1] // filters_n)]
        ref = wave[:, filters_n:-filters_n]
        key = jax.random.key(4)
        snrs = []
        for drown in (0.0, 0.5, 1.0):
            out = codec.round_trip(wave, key, drown=drown)
            snrs.append(snr_db(ref, out[:, 2 * filters_n : wave.shape[1]]))
        assert snrs[0] > snrs[1] > snrs[2]


class TestDctPrecisionKnob:
    def test_precision_levels_accepted(self):
        from audiocodec_tpu.mdct import MDCT

        for p in ("highest", "high", "default"):
            MDCT.create(64, dct_precision=p)
        import pytest as _pytest

        with _pytest.raises(ValueError, match="dct_precision"):
            MDCT.create(64, dct_precision="fast")

    def test_high_precision_close_to_highest(self):
        from audiocodec_tpu.mdct import MDCT

        m1 = MDCT.create(64)
        m2 = MDCT.create(64, dct_precision="high")
        x = sine_wav(0.8, 880, sample_rate=16000, duration_sec=0.1)
        x = x[:, : 64 * (x.shape[1] // 64)]
        a = np.asarray(m1.transform(x))
        b = np.asarray(m2.transform(x))
        np.testing.assert_allclose(a, b, atol=1e-4)


class TestBarkPrecisionKnob:
    def test_codec_threads_precision_to_psycho(self):
        from audiocodec_tpu.codec import Codec

        c = Codec.create(44100, filters_n=64, bark_bands_n=16,
                         dct_precision="default")
        assert c.psycho.bark_precision == "default"
        assert Codec.create(
            44100, filters_n=64, bark_bands_n=16
        ).psycho.bark_precision == "highest"

    def test_invalid_rejected(self):
        import pytest as _pytest

        from audiocodec_tpu.psycho import PsychoacousticModel

        with _pytest.raises(ValueError, match="bark_precision"):
            PsychoacousticModel.create(44100, bark_precision="fast")

    def test_threshold_matches_across_precisions_on_cpu(self):
        """On CPU every precision level is exact f32, so the knob must not
        change the math — only the lowering."""
        import jax.numpy as _jnp

        from audiocodec_tpu.mdct import MDCT
        from audiocodec_tpu.psycho import PsychoacousticModel

        m = MDCT.create(64)
        rng = np.random.default_rng(5)
        x = _jnp.asarray(rng.uniform(-0.8, 0.8, (1, 10 * 64, 1)),
                         _jnp.float32)
        spec = m.transform(x)
        thr = []
        for p in ("highest", "default"):
            pa = PsychoacousticModel.create(
                16000, filter_bands_n=64, bark_bands_n=16, bark_precision=p
            )
            thr.append(
                np.asarray(
                    pa.global_masking_threshold(spec, pa.tonality(spec))
                )
            )
        np.testing.assert_allclose(thr[0], thr[1], rtol=1e-6)


class TestInt8Codec:
    """dct_precision="int8" composed through the quantized path
    (docs/DESIGN.md §3c): the int8 tier must stay within 0.1 dB
    SNR of the "default" tier and keep NMR at the codec's own
    calibration level (measured: default 0.0213 / int8-XLA 0.0247 /
    int8-Pallas 0.0295, all below the 1/36+margin line)."""

    def _signal(self, sr=16000, filters_n=256, seconds=2.0, seed=0):
        rng = np.random.default_rng(seed)
        t = np.arange(int(sr * seconds) // filters_n * filters_n) / sr
        base = (
            0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.3 * np.sin(2 * np.pi * 1320 * t)
            + 0.05 * rng.normal(size=t.size)
        ).astype(np.float32)
        return jnp.asarray(base[None, :, None])

    def test_composed_snr_within_tenth_db_of_default(self):
        n = 256
        x = self._signal(filters_n=n)
        outs = {}
        for prec in ("default", "int8"):
            c = Codec.create(16000, filters_n=n, bark_bands_n=32,
                             dct_precision=prec)
            out = c.round_trip_quantized(x)[:, n:-n]
            outs[prec] = snr_db(x, out)
        assert float(outs["int8"]) > float(outs["default"]) - 0.1, outs

    def test_composed_nmr_gate(self):
        n = 256
        x = self._signal(filters_n=n)
        ref = Codec.create(16000, filters_n=n, bark_bands_n=32)
        c = Codec.create(16000, filters_n=n, bark_bands_n=32,
                         dct_precision="int8")
        out = c.round_trip_quantized(x)[:, n:-n]
        from audiocodec_tpu import metrics as _metrics

        val = float(_metrics.nmr(ref, x, out))
        # codec's own calibration is 1/36 ~ 0.028; the int8 analysis adds
        # ~0.003-0.006 of white transform error. Gate at ~2x headroom so
        # only a real regression (flat-error synthesis, scale bug) trips.
        assert val < 0.06, val

    def test_bark_precision_defaults_to_float_ladder(self):
        """int8 is MDCT-only: the Bark contractions (step-size-critical,
        container-recorded) must fall back to "default", never "int8"."""
        c = Codec.create(16000, filters_n=256, bark_bands_n=32,
                         dct_precision="int8")
        assert c.psycho.bark_precision == "default"
        import pytest as _pytest

        from audiocodec_tpu.psycho import PsychoacousticModel

        with _pytest.raises(ValueError, match="bark_precision"):
            PsychoacousticModel.create(16000, bark_precision="int8")

    def test_serialization_round_trip(self, tmp_path):
        from audiocodec_tpu.utils import serialization

        c = Codec.create(16000, filters_n=256, bark_bands_n=32,
                         dct_precision="int8")
        path = str(tmp_path / "codec.json")
        serialization.save_codec(path, c)
        c2 = serialization.load_codec(path)
        assert c2.mdct.dct_precision == "int8"
        x = self._signal(filters_n=256)
        np.testing.assert_array_equal(
            np.asarray(c.round_trip_quantized(x)),
            np.asarray(c2.round_trip_quantized(x)),
        )

    def test_stream_container_round_trip(self, tmp_path):
        """The .acs container path composes with the int8 analysis tier
        (synthesis maps to one-pass float; wire format unchanged — int8
        is not a recorded precision, both ends rebuild step sizes from
        the transmitted sidecar)."""
        from audiocodec_tpu.io import stream_container as sc

        n = 256
        c = Codec.create(16000, filters_n=n, bark_bands_n=32,
                         dct_precision="int8")
        x = self._signal(filters_n=n, seconds=1.0)
        x = x[:, : x.shape[1] // (8 * n) * (8 * n)]  # chunk-multiple
        path = str(tmp_path / "s.acs")
        sc.encode_stream(c, x, path, chunk_blocks=8)
        out = np.concatenate(
            [np.asarray(ch) for ch in sc.decode_stream(c, path)], axis=1
        )
        # stream output carries the usual N-sample boundary pads: the
        # interior aligns at offset 2N against x[N:-N]
        deg = jnp.asarray(out[:, 2 * n:2 * n + x.shape[1] - 2 * n])
        assert float(snr_db(x[:, n:-n], deg)) > 15.0
