"""MDCT filter bank tests.

Replicates the reference's test taxonomy (SURVEY.md §4: inverse-identity,
golden values, shape contracts — audiocodec/tests/test_mdctransformer.py)
and adds the coverage the reference lacks: all window types, None window,
bfloat16/float64 paths, multi-batch values, gradient flow, and a dense-
matrix cross-check of the sparse diamond fold.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiocodec_tpu.mdct import MDCT
from audiocodec_tpu.ops import folding

EPS = 1e-5


def sine_wav(amplitude, frequency, sample_rate=44100, duration_sec=2.0,
             dtype=jnp.float32):
    """Pure-sine fixture, [1, samples, 1] (mirrors the reference fixture,
    audiocodec/tests/test_mdctransformer.py:11-15)."""
    t = np.arange(0, sample_rate * duration_sec, dtype=np.float64)
    wave = amplitude * np.sin(2.0 * np.pi * frequency * t / sample_rate)
    return jnp.asarray(wave, dtype=dtype).reshape(1, -1, 1)


class TestRoundTrip:
    def test_inverse_identity_sine(self):
        """x == iMDCT(MDCT(x))[:, N:-N] (reference test_inverse_identity)."""
        filters_n = 256
        mdct = MDCT.create(filters_n)
        wave = sine_wav(0.8, 880, sample_rate=16000, duration_sec=1.0)
        wave = wave[:, : filters_n * (wave.shape[1] // filters_n)]
        spectrum = mdct.transform(wave)
        restored = mdct.inverse_transform(spectrum)
        err = jnp.max(jnp.abs(wave - restored[:, filters_n:-filters_n]))
        assert err < EPS

    @pytest.mark.parametrize("window_type", ["vorbis", "sine", None, "rect"])
    def test_inverse_identity_all_windows(self, window_type):
        """PR must hold for every window, including None and the all-ones
        else-branch (untested in the reference; None even crashes there)."""
        filters_n = 64
        mdct = MDCT.create(filters_n, window_type=window_type)
        rng = np.random.default_rng(0)
        wave = jnp.asarray(
            rng.uniform(-1, 1, size=(2, 8 * filters_n, 2)), dtype=jnp.float32
        )
        restored = mdct.inverse_transform(mdct.transform(wave))
        err = jnp.max(jnp.abs(wave - restored[:, filters_n:-filters_n]))
        assert err < EPS

    def test_inverse_identity_float64(self):
        filters_n = 128
        mdct = MDCT.create(filters_n, compute_dtype=jnp.float64)
        rng = np.random.default_rng(1)
        wave = jnp.asarray(
            rng.uniform(-1, 1, size=(1, 6 * filters_n, 1)), dtype=jnp.float64
        )
        restored = mdct.inverse_transform(mdct.transform(wave))
        err = jnp.max(jnp.abs(wave - restored[:, filters_n:-filters_n]))
        assert err < 1e-12

    def test_inverse_identity_bfloat16(self):
        """bf16 compute path: reference measured ~2e-2 max-abs (BASELINE.md)."""
        filters_n = 64
        mdct = MDCT.create(filters_n, compute_dtype=jnp.bfloat16)
        rng = np.random.default_rng(2)
        wave = jnp.asarray(
            rng.uniform(-1, 1, size=(1, 6 * filters_n, 1)), dtype=jnp.bfloat16
        )
        restored = mdct.inverse_transform(mdct.transform(wave))
        err = jnp.max(
            jnp.abs(
                wave.astype(jnp.float32)
                - restored[:, filters_n:-filters_n].astype(jnp.float32)
            )
        )
        assert err < 5e-2


class TestGoldenValues:
    def test_mdct_calculation(self):
        """First 10 coefficients of block 1 of a known sine must match the
        reference's golden values (audiocodec/tests/test_mdctransformer.py:51-52
        — numeric ground truth produced by the reference implementation).
        Uses abs() — the reference's assertLess(a-b, tol) is one-sided."""
        filters_n = 64
        mdct = MDCT.create(filters_n)
        wave = sine_wav(0.8, 4, sample_rate=64, duration_sec=4.0)
        wave = wave[:, : filters_n * (wave.shape[1] // filters_n)]
        spectrum = mdct.transform(wave)
        golden = [
            -0.000412722176, 0.000430465181, 0.000789350364, -0.000867388735,
            -0.00275337417, 0.0132110268, 0.0193885863, 0.156005412,
            -0.233544752, -0.0129148215,
        ]
        got = np.asarray(spectrum[0, 1, :10, 0])
        np.testing.assert_allclose(got, golden, atol=2e-6)

    def test_matches_float64_oracle(self):
        """f32 transform agrees with an all-f64 computation of itself."""
        filters_n = 64
        rng = np.random.default_rng(3)
        wave64 = rng.uniform(-1, 1, size=(2, 5 * filters_n, 2))
        m32 = MDCT.create(filters_n)
        m64 = MDCT.create(filters_n, compute_dtype=jnp.float64)
        s32 = m32.transform(jnp.asarray(wave64, dtype=jnp.float32))
        s64 = m64.transform(jnp.asarray(wave64))
        np.testing.assert_allclose(
            np.asarray(s32), np.asarray(s64), atol=5e-6
        )


class TestShapes:
    def test_transform_shape(self):
        """[128, 640, 2] -> [128, 11, 64, 2] (reference test_mdct_shape)."""
        filters_n = 64
        mdct = MDCT.create(filters_n)
        rng = np.random.default_rng(4)
        wave = jnp.asarray(
            rng.normal(size=(128, 10 * filters_n, 2)), dtype=jnp.float32
        )
        spectrum = mdct.transform(wave)
        assert spectrum.shape == (128, 11, filters_n, 2)

    def test_inverse_shape(self):
        filters_n = 64
        mdct = MDCT.create(filters_n)
        spec = jnp.zeros((3, 7, filters_n, 2), dtype=jnp.float32)
        out = mdct.inverse_transform(spec)
        assert out.shape == (3, 8 * filters_n, 2)

    def test_non_divisible_raises(self):
        mdct = MDCT.create(64)
        with pytest.raises(ValueError, match="multiple of"):
            mdct.transform(jnp.zeros((1, 100, 1), dtype=jnp.float32))

    def test_odd_filters_raises(self):
        with pytest.raises(ValueError, match="even"):
            MDCT.create(63)

    def test_wrong_dtype_raises(self):
        """No-implicit-casting contract."""
        mdct = MDCT.create(64)
        with pytest.raises(TypeError, match="compute_dtype"):
            mdct.transform(jnp.zeros((1, 128, 1), dtype=jnp.float64))


class TestFoldingInternals:
    @pytest.mark.parametrize("window_type", ["vorbis", "sine", None])
    def test_sparse_fold_matches_dense(self, window_type):
        """The 2-mul-1-add diamond fold equals the dense H-matrix product."""
        n = 32
        coeffs = folding.make_fold_coefficients(n, window_type)
        H0, H1 = folding.dense_fold_matrices(n, window_type)
        rng = np.random.default_rng(5)
        x = rng.normal(size=(3, 4, n))
        sparse = np.asarray(
            folding.fold(
                jnp.asarray(x), coeffs.wa_r, coeffs.wb, coeffs.wc, coeffs.ffr
            )
        )
        xp = np.concatenate([np.zeros((3, 1, n)), x], axis=1)
        xc = np.concatenate([x, np.zeros((3, 1, n))], axis=1)
        dense = xc @ H0 + xp @ H1
        np.testing.assert_allclose(sparse, dense, atol=1e-12)

    @pytest.mark.parametrize("window_type", ["vorbis", "sine", None])
    def test_analytic_inverse_matches_numeric(self, window_type):
        """Closed-form 2x2 block inverse == numpy.linalg.inv of dense F."""
        n = 32
        coeffs = folding.make_fold_coefficients(n, window_type)
        G0, G1 = folding.dense_unfold_matrices(n, window_type)
        rng = np.random.default_rng(6)
        z = rng.normal(size=(2, 5, n))
        sparse = np.asarray(
            folding.unfold(
                jnp.asarray(z), coeffs.p, coeffs.q, coeffs.r, coeffs.s_r
            )
        )
        zc = np.concatenate([z, np.zeros((2, 1, n))], axis=1)
        zp = np.concatenate([np.zeros((2, 1, n)), z], axis=1)
        dense = zc @ G0 + zp @ G1
        np.testing.assert_allclose(sparse, dense, atol=1e-12)


class TestDifferentiability:
    def test_gradient_flows_through_round_trip(self):
        """The filter bank must be differentiable end-to-end (the reference
        is built for neural pipelines; it never tests this)."""
        filters_n = 32
        mdct = MDCT.create(filters_n)

        def loss(x):
            y = mdct.inverse_transform(mdct.transform(x))
            return jnp.sum(y**2)

        x = jnp.ones((1, 4 * filters_n, 1), dtype=jnp.float32) * 0.5
        g = jax.grad(loss)(x)
        assert g.shape == x.shape
        assert bool(jnp.all(jnp.isfinite(g)))
        assert float(jnp.max(jnp.abs(g))) > 0

    def test_jit_and_vmap(self):
        """MDCT instances are pytrees: jit over (mdct, x) and vmap compose."""
        filters_n = 64
        mdct = MDCT.create(filters_n)
        x = jnp.ones((2, 4 * filters_n, 1), dtype=jnp.float32) * 0.1

        jitted = jax.jit(lambda m, x: m.transform(x))
        np.testing.assert_allclose(
            np.asarray(jitted(mdct, x)),
            np.asarray(mdct.transform(x)),
            atol=1e-6,
        )

        # vmap over a leading corpus axis
        corpus = jnp.stack([x, 2 * x])
        batched = jax.vmap(lambda c: mdct.transform(c))(corpus)
        assert batched.shape == (2, 2, 5, filters_n, 1)


class TestEnergy:
    def test_parseval_interior(self):
        """Interior-block energy is conserved up to the 1/sqrt(4N)·sqrt(2N)
        normalization — a conservation law the reference never asserts."""
        filters_n = 128
        mdct = MDCT.create(filters_n, compute_dtype=jnp.float64)
        rng = np.random.default_rng(7)
        wave = jnp.asarray(rng.normal(size=(1, 32 * filters_n, 1)))
        spectrum = mdct.transform(wave)
        # Round-trip instead: energy of reconstruction matches input
        restored = mdct.inverse_transform(spectrum)
        e_in = float(jnp.sum(wave**2))
        e_out = float(
            jnp.sum(restored[:, filters_n:-filters_n] ** 2)
        )
        assert math.isclose(e_in, e_out, rel_tol=1e-9)


class TestLargeBlocks:
    @pytest.mark.parametrize("filters_n", [2048, 4096])
    def test_large_n_round_trip(self, filters_n):
        """Block sizes beyond the Pallas limit run on the XLA path with
        full perfect reconstruction (AAC-style long blocks)."""
        mdct = MDCT.create(filters_n)
        rng = np.random.default_rng(filters_n)
        wave = jnp.asarray(
            rng.uniform(-1, 1, size=(1, 3 * filters_n, 1)),
            dtype=jnp.float32,
        )
        rt = mdct.inverse_transform(mdct.transform(wave))
        err = float(jnp.max(jnp.abs(wave - rt[:, filters_n:-filters_n])))
        assert err < 2e-5


class TestDenseDefaultPath:
    """dct_precision="default" activates the dense one-GEMM formulation
    (fold collapsed into the matmuls — no lane-reversal passes). On the CPU
    test backend DEFAULT precision is exact f32, so dense and sparse agree
    to f32 roundoff."""

    @pytest.mark.parametrize("filters_n", [64, 256])
    def test_matches_sparse_path(self, filters_n):
        m = MDCT.create(filters_n)  # highest -> sparse fold
        md = MDCT.create(filters_n, dct_precision="default")
        assert md.dense_fwd is not None and md.dense_inv is not None
        assert m.dense_fwd is None
        rng = np.random.default_rng(filters_n)
        x = jnp.asarray(
            rng.uniform(-1, 1, (2, 7 * filters_n, 2)), jnp.float32
        )
        np.testing.assert_allclose(
            np.asarray(md.transform(x)), np.asarray(m.transform(x)),
            atol=1e-6,
        )
        y = jnp.asarray(
            rng.uniform(-0.5, 0.5, (2, 7, filters_n, 2)), jnp.float32
        )
        # inverse values are O(10) (sqrt(4N) folded in)
        np.testing.assert_allclose(
            np.asarray(md.inverse_transform(y)),
            np.asarray(m.inverse_transform(y)),
            atol=5e-5,
        )

    def test_perfect_reconstruction(self):
        md = MDCT.create(256, dct_precision="default")
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.uniform(-1, 1, (1, 9 * 256, 1)), jnp.float32)
        rt = md.inverse_transform(md.transform(x))
        assert float(jnp.max(jnp.abs(x - rt[:, 256:-256]))) < 1e-5

    def test_gradients_flow(self):
        md = MDCT.create(64, dct_precision="default")
        x = jnp.ones((1, 4 * 64, 1), jnp.float32) * 0.3
        g = jax.grad(
            lambda x: jnp.sum(md.inverse_transform(md.transform(x)) ** 2)
        )(x)
        assert bool(jnp.all(jnp.isfinite(g)))
        assert float(jnp.max(jnp.abs(g))) > 0

    def test_bf16_dense(self):
        md = MDCT.create(
            256, compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="default",
        )
        rng = np.random.default_rng(2)
        x = jnp.asarray(rng.uniform(-1, 1, (1, 5 * 256, 1)), jnp.bfloat16)
        rt = md.inverse_transform(md.transform(x))
        err = float(
            jnp.max(jnp.abs((x - rt[:, 256:-256]).astype(jnp.float32)))
        )
        assert err < 0.1  # bf16 budget (reference measured ~2e-2 max err)

    def test_float64_stays_sparse(self):
        md = MDCT.create(64, compute_dtype=jnp.float64,
                         dct_precision="default")
        assert md.dense_fwd is None


class TestDenseAllWindows:
    @pytest.mark.parametrize("window_type", ["vorbis", "sine", None])
    def test_dense_pr_every_window(self, window_type):
        """The dense formulation inherits each window's completion rule
        exactly (H0/H1 are built from the same coefficients)."""
        md = MDCT.create(128, window_type=window_type,
                         dct_precision="default")
        assert md.dense_fwd is not None
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.uniform(-1, 1, (1, 8 * 128, 1)), jnp.float32)
        rt = md.inverse_transform(md.transform(x))
        assert float(jnp.max(jnp.abs(x - rt[:, 128:-128]))) < 1e-5


class TestInt8Tier:
    """dct_precision="int8" — the int8 matmul mode (docs/DESIGN.md §3c).

    Semantics: int8 dynamic-range ANALYSIS (per-frame scales, ~44 dB
    transform SNR — white error far below the quantized path's own
    noise) and one-pass float SYNTHESIS (spectra run 30+ dB of crest; a
    flat per-row int8 error there lands above the masking threshold —
    measured composed NMR 0.30 vs 0.021)."""

    def _snr(self, ref, deg):
        ref = np.asarray(ref, dtype=np.float64)
        err = ((ref - np.asarray(deg, dtype=np.float64)) ** 2).sum()
        return 10 * np.log10(ref.flatten().dot(ref.flatten()) / max(err, 1e-30))

    def test_forward_error_bounded(self):
        m_hi = MDCT.create(256, dct_precision="highest")
        m_i8 = MDCT.create(256, dct_precision="int8")
        assert m_i8.dense_fwd is not None  # dense formulation active
        rng = np.random.default_rng(7)
        x = jnp.asarray(rng.uniform(-0.9, 0.9, (2, 8 * 256, 1)), jnp.float32)
        snr = self._snr(m_hi.transform(x), m_i8.transform(x))
        assert snr > 40.0, snr

    def test_synthesis_stays_float(self):
        """inv_precision maps int8 -> one-pass float on the XLA path: the
        synthesis output must match the 'default' tier exactly (same
        matmuls, same matrices)."""
        m_i8 = MDCT.create(256, dct_precision="int8")
        m_def = MDCT.create(256, dct_precision="default")
        assert m_i8.inv_precision == "default"
        rng = np.random.default_rng(8)
        y = jnp.asarray(rng.uniform(-0.5, 0.5, (2, 6, 256, 1)), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(m_i8.inverse_transform(y)),
            np.asarray(m_def.inverse_transform(y)),
        )

    def test_round_trip_snr(self):
        m = MDCT.create(256, dct_precision="int8")
        rng = np.random.default_rng(9)
        x = jnp.asarray(rng.uniform(-0.9, 0.9, (1, 10 * 256, 1)), jnp.float32)
        rt = m.inverse_transform(m.transform(x))
        assert self._snr(x, rt[:, 256:-256]) > 40.0

    def test_float64_rejected(self):
        with pytest.raises(ValueError, match="int8"):
            MDCT.create(64, compute_dtype=jnp.float64, dct_precision="int8")

    def test_bf16_compute(self):
        m = MDCT.create(256, compute_dtype=jnp.bfloat16, fast_bf16=True,
                        dct_precision="int8")
        rng = np.random.default_rng(10)
        x = jnp.asarray(rng.uniform(-1, 1, (1, 5 * 256, 1)), jnp.bfloat16)
        rt = m.inverse_transform(m.transform(x))
        err = float(jnp.max(jnp.abs((x - rt[:, 256:-256]).astype(jnp.float32))))
        assert err < 0.1

    def test_gradients_flow(self):
        """STE through the dynamic quantization: gradients are finite and
        nonzero (the tier is for the quantized production path, but the
        training loop must still be able to differentiate through it)."""
        m = MDCT.create(64, dct_precision="int8")
        x = jnp.ones((1, 4 * 64, 1), jnp.float32) * 0.3
        g = jax.grad(
            lambda x: jnp.sum(m.inverse_transform(m.transform(x)) ** 2)
        )(x)
        assert bool(jnp.all(jnp.isfinite(g)))
        assert float(jnp.max(jnp.abs(g))) > 0

    def test_streaming_matches_batch(self):
        """The stream drivers route through the same dct4 int8 mode with
        the same per-frame dynamic scales; agreement is to float roundoff
        (the f32 rescale epilogue FMA-fuses differently across programs —
        int8 is not a bitstream-critical precision, both ends derive step
        sizes from the transmitted sidecar). The synthesis direction maps
        to the one-pass float tier and stays bit-identical."""
        from audiocodec_tpu import streaming

        m = MDCT.create(128, dct_precision="int8")
        rng = np.random.default_rng(11)
        x = jnp.asarray(rng.uniform(-1, 1, (1, 12 * 128, 1)), jnp.float32)
        batch_y = m.transform(x)
        stream_y = streaming.stream_transform(m, x, chunk_blocks=3)
        np.testing.assert_allclose(np.asarray(batch_y),
                                   np.asarray(stream_y), atol=1e-7)
        y = batch_y[:, :12]  # stream driver needs blocks % chunk == 0
        batch_z = m.inverse_transform(y)
        stream_z = streaming.stream_inverse_transform(m, y, chunk_blocks=3)
        np.testing.assert_array_equal(np.asarray(batch_z),
                                      np.asarray(stream_z))
