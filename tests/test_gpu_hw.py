"""Opt-in hardware lane: numerics on a real GPU (``pytest -m gpu``).

These are the checks a CPU run cannot see: the compiled GPU programs
(cuBLAS/Triton GEMMs, TF32 at the one-pass tiers, fused reductions) must
hold the quality gates, and every wire-steering derivation must agree
with the CPU backend in the same process, so that a stream encoded on
the card decodes identically anywhere.

Deselected by default (pyproject addopts); on a CPU-only machine the
tests skip. chip_smoke.py runs this lane on the card.

Shapes are kept small: these are numerics gates, not benchmarks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", autouse=True)
def require_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("hardware lane requires a GPU backend")


def _on_cpu(fn, *args):
    """Run ``fn`` jitted on the CPU backend of this same process."""
    return jax.jit(fn)(*jax.device_put(args, jax.devices("cpu")[0]))


class TestQuantizedQualityOnHardware:
    """SNR gates for the production paths, on-device end to end."""

    @staticmethod
    def _two_tone(sr, dur, dtype):
        t = np.arange(int(sr * dur)) / sr
        rng = np.random.default_rng(0)
        wave = (
            0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.3 * np.sin(2 * np.pi * 1320 * t)
            + 0.05 * rng.normal(size=t.size)
        ).astype(np.float32)
        wave = wave[: wave.size // 1024 * 1024]
        return jnp.asarray(wave[None, :, None], dtype=dtype)

    @staticmethod
    def _snr(x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        return 10 * np.log10((x**2).sum() / max(((x - y) ** 2).sum(), 1e-30))

    def test_f32_quantized_snr(self):
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(44100, filters_n=1024, bark_bands_n=64)
        x = self._two_tone(44100, 2.0, jnp.float32)
        out = np.asarray(jax.jit(codec.round_trip_quantized)(x))[:, 1024:-1024]
        # the CPU backend gives 18.96 dB on this workload; ~0.5 dB margin
        assert self._snr(np.asarray(x), out) > 18.4

    def test_dense_default_production_path_snr(self):
        """The production path (dct_precision="default": dense one-GEMM
        MDCT + one-pass Bark contractions) must hold the f32 quality gate
        on the card, where DEFAULT really is TF32."""
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(
            44100, filters_n=1024, bark_bands_n=64, dct_precision="default"
        )
        assert codec.mdct.dense_fwd is not None
        assert codec.psycho.bark_precision == "default"
        x = self._two_tone(44100, 2.0, jnp.float32)
        out = np.asarray(jax.jit(codec.round_trip_quantized)(x))[:, 1024:-1024]
        assert self._snr(np.asarray(x), out) > 18.4

    def test_bf16_fast_quantized_snr(self):
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(
            44100, filters_n=1024, bark_bands_n=64,
            compute_dtype=jnp.bfloat16, fast_bf16=True,
        )
        x = self._two_tone(44100, 2.0, jnp.bfloat16)
        out = np.asarray(
            jax.jit(codec.round_trip_quantized)(x).astype(jnp.float32)
        )[:, 1024:-1024]
        assert self._snr(np.asarray(x.astype(jnp.float32)), out) > 16.0


class TestResamplerOnHardware:
    """The polyphase conv lowers to a cuDNN/XLA convolution; verify the
    quality claims survive compiled GPU execution (f32 HIGHEST path)."""

    def test_tone_snr_on_device(self):
        from audiocodec_tpu.resample import Resampler

        r = Resampler.create(44100, 16000)
        t = np.arange(44100 * 2) / 44100
        x = jnp.asarray(
            np.sin(2 * np.pi * 1000 * t).astype(np.float32)[None, :, None]
        )
        y = np.asarray(jax.jit(lambda r, x: r.resample(x))(r, x))[0, :, 0]
        ref = np.sin(2 * np.pi * 1000 * np.arange(y.size) / 16000)
        m = slice(2000, y.size - 2000)
        err = ref[m] - y[m]
        snr = 10 * np.log10((ref[m] ** 2).sum() / (err**2).sum())
        assert snr > 90.0

    def test_matches_cpu_reference(self):
        """Device conv vs host float64 reference of the same tap matrix:
        the HIGHEST-precision conv must stay within f32 accumulation
        error (a silent one-pass bf16 lowering would show ~1e-3)."""
        from audiocodec_tpu.resample import Resampler

        r = Resampler.create(16000, 48000)
        rng = np.random.default_rng(1)
        x = rng.uniform(-0.8, 0.8, (1, 4000, 1)).astype(np.float32)
        got = np.asarray(r.resample(jnp.asarray(x)))
        # host float64 oracle via the same windows
        k = np.asarray(r.kernel, dtype=np.float64)[:, 0, :]  # [L, W]
        xp = np.zeros(r.pad_left + x.shape[1] + r.window_n, np.float64)
        xp[r.pad_left : r.pad_left + x.shape[1]] = x[0, :, 0]
        blocks = got.shape[1] // r.up
        want = np.empty((blocks, r.up))
        for b in range(blocks):
            want[b] = k @ xp[b * r.down : b * r.down + r.window_n]
        want = want.reshape(-1)[: got.shape[1]]
        np.testing.assert_allclose(got[0, :, 0], want, atol=5e-6)


class TestRVQOnHardware:
    """One-hot matmul codeword lookup on the card: argmin/one-hot must
    agree with the CPU result on identical inputs."""

    def test_quantize_matches_cpu(self):
        from audiocodec_tpu.models import rvq as _rvq

        rcfg = _rvq.RVQ(stages=3, codebook_size=64, dim=16)
        state = _rvq.init_state(jax.random.key(0), rcfg)
        rng = np.random.default_rng(2)
        z = jnp.asarray(rng.normal(size=(2, 8, 16, 1)) * 0.3, jnp.float32)
        z_q, codes, _ = jax.jit(
            lambda s, z: _rvq.quantize(rcfg, s, z)
        )(state, z)
        # decode path reproduces the quantized latents exactly
        z_dec = _rvq.decode_codes(rcfg, state, codes)
        np.testing.assert_allclose(
            np.asarray(z_dec), np.asarray(z_q), atol=1e-5
        )
        assert int(np.asarray(codes).min()) >= 0
        assert int(np.asarray(codes).max()) < 64


class TestCodedToolsOnHardware:
    """TNS + noise filling compile and hold their quality contracts on
    the real device: the TNS inverse is a lax.scan over frequency and
    the fill is a per-frame threefry draw — both only meaningfully
    covered by compiled execution."""

    @staticmethod
    def _snr(x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        return 10 * np.log10((x**2).sum() / max(((x - y) ** 2).sum(), 1e-30))

    def test_tns_nf_round_trip_on_device(self):
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(44100, filters_n=1024, bark_bands_n=64)
        t = np.arange(4 * 44100) / 44100
        rng = np.random.default_rng(5)
        wave = (
            0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.normal(size=t.size)
        ).astype(np.float32)
        wave = wave[: wave.size // 1024 * 1024]
        x = jnp.asarray(wave[None, :, None])

        @jax.jit
        def enc_dec(c, xx):
            frames = c.mdct.transform(xx)
            codes, bark, tns_idx, nfl = c.quantize_frames_tns(
                frames, threshold_scale=4.0, nf=True
            )
            out = c.decode_bitstream(
                codes, bark, threshold_scale=4.0,
                tns_idx=tns_idx, nf_levels=nfl,
            )
            return out, nfl

        out, nfl = enc_dec(codec, x)
        out = np.asarray(out)[:, 1024:-1024]
        assert np.isfinite(out).all()
        # scale-4 quantization of a HEAVILY noisy signal (the -10 dB
        # white-noise bed itself quantizes coarsely): the CPU backend
        # gives 4.96 dB — gate at that minus a margin
        assert self._snr(wave[None, :, None], out) > 4.0

    def test_fill_noise_matches_cpu(self):
        """The fill is bitstream-adjacent: the device's threefry draw
        must equal the CPU decoder's (format guarantee — a stream
        encoded here must decode identically anywhere)."""
        from audiocodec_tpu import nf

        rng = np.random.default_rng(6)
        spec = jnp.asarray(rng.normal(size=(1, 4, 256, 1)).astype(np.float32))
        codes = jnp.zeros((1, 4, 256, 1), jnp.int32)
        delta = jnp.full((1, 4, 256, 1), 0.5, jnp.float32)
        levels = jnp.full((1, 4, 1), 200, jnp.uint8)
        dev = np.asarray(
            jax.jit(lambda *a: nf.fill(*a, 16, 9))(
                spec, codes, delta, levels
            )
        )
        cpu = _on_cpu(
            lambda *a: nf.fill(*a, 16, 9), np.asarray(spec),
            np.asarray(codes), np.asarray(delta), np.asarray(levels),
        )
        np.testing.assert_allclose(dev, np.asarray(cpu), atol=1e-6)


class TestBlockSwitchTmaskOnHardware:
    """Block switching + temporal masking on compiled GPU programs.

    The transition einsum runs at Precision.HIGHEST (cuBLAS float32 — a
    different summation order from CPU f32), and the detector's
    contrast decision must survive it; the tmask log-doubling maxes are
    trivially portable but only compiled execution proves the fused
    program. The bitstream-critical derivations (flag bits, min-pooled
    thresholds from a given sidecar) must MATCH the CPU decoder exactly."""

    @staticmethod
    def _click_signal():
        rng = np.random.default_rng(7)
        n = 1024 * 64
        t = np.arange(n) / 44100
        x = 0.02 * np.sin(2 * np.pi * 330 * t)
        x += 0.003 * rng.standard_normal(n)
        for s0 in (20 * 1024, 40 * 1024 + 512):
            x[s0 : s0 + 600] += 0.8 * np.exp(
                -np.arange(600) / 120.0
            ) * rng.standard_normal(600)
        return x.astype(np.float32)

    def test_bs_flags_match_cpu(self):
        """The per-frame flags ARE wire bits: device and CPU encoders
        must agree on them for the same input."""
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(44100, filters_n=1024, bark_bands_n=64)
        x = jnp.asarray(self._click_signal()[None, :, None])

        @jax.jit
        def flags_of(c, xx):
            return c.analyze_for_quantization(
                c.mdct.transform(xx), bs=True
            )[3]

        dev = np.asarray(flags_of(codec, x))
        cpu_codec = Codec.create(44100, filters_n=1024, bark_bands_n=64)
        cpu = np.asarray(
            _on_cpu(flags_of, cpu_codec, np.asarray(x))
        )
        assert dev.any()
        np.testing.assert_array_equal(dev, cpu)

    def test_bs_round_trip_on_device(self):
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(44100, filters_n=1024, bark_bands_n=64)
        wave = self._click_signal()
        x = jnp.asarray(wave[None, :, None])

        @jax.jit
        def enc_dec(c, xx):
            enc = c.encode_frames(c.mdct.transform(xx), bs=True)
            out = c.decode_bitstream(
                enc.codes, enc.bark16, bs_flags=enc.bs_flags
            )
            return out, enc.bs_flags

        out, flags = enc_dec(codec, x)
        out = np.asarray(out)[:, 1024:-1024]
        assert np.asarray(flags).any()
        assert np.isfinite(out).all()
        snr = 10 * np.log10(
            (wave**2).sum() / ((wave - out[0, :, 0]) ** 2).sum()
        )
        assert snr > 6.0  # noisy-bed clicks at scale 1: ~8.7 nominal

    def test_tmask_sidecar_matches_cpu(self):
        """tmask flows into the bf16 sidecar (wire bytes): the spread
        intensities must round to identical bfloat16 on both backends
        (elementwise maxes/multiplies — no matmul in the spread)."""
        from audiocodec_tpu import psycho

        rng = np.random.default_rng(8)
        bark = (10.0 ** rng.uniform(-12, 0, (1, 48, 64, 1))).astype(
            np.float32
        )

        def spread16(b):
            return psycho.temporal_masking(b, 3.0).astype(jnp.bfloat16)

        dev = np.asarray(
            jax.jit(spread16)(jnp.asarray(bark))
        ).view(np.uint16)
        cpu = np.asarray(
            _on_cpu(spread16, bark)
        ).view(np.uint16)
        np.testing.assert_array_equal(dev, cpu)

    def test_full_ladder_on_device(self):
        """The --preset low ladder (dz+tns+bs+nf+tmask) compiles and
        decodes cleanly as ONE program on the chip."""
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(44100, filters_n=1024, bark_bands_n=64)
        wave = self._click_signal()
        x = jnp.asarray(wave[None, :, None])

        @jax.jit
        def enc_dec(c, xx):
            enc = c.encode_frames(
                c.mdct.transform(xx), deadzone=1.0, tns=True, nf=True,
                tmask=130.0, bs=True,
            )
            return c.decode_bitstream(
                enc.codes, enc.bark16, dz_recon=0.45,
                tns_idx=enc.tns_idx, nf_levels=enc.nf_levels,
                bs_flags=enc.bs_flags,
            )

        out = np.asarray(enc_dec(codec, x))[:, 1024:-1024]
        assert np.isfinite(out).all()
        snr = 10 * np.log10(
            (wave**2).sum() / ((wave - out[0, :, 0]) ** 2).sum()
        )
        # ~7.96 nominal: nf's structural SNR cost (DESIGN.md §12) plus
        # the wide dead zone, on a noisy-bed transient signal
        assert snr > 5.5


class TestStereoToolsOnHardware:
    """Intensity stereo + grid-quantized sidecar on compiled GPU
    programs. The scq snap's f32 log2/round and the intensity
    projection's reductions are the wire-steering math; only compiled
    execution proves the fused programs, and the decode must agree with
    the CPU decoder given the same wire data."""

    @staticmethod
    def _panned_signal():
        rng = np.random.default_rng(9)
        n = 1024 * 48
        t = np.arange(n) / 44100
        bass = 0.3 * np.sin(2 * np.pi * 220 * t)
        lo = sum(0.2 / k * np.sin(2 * np.pi * 6100 * k * t)
                 for k in (1, 2))
        hi = 0.2 * np.sin(2 * np.pi * 12500 * t)
        amb = 0.01 * rng.standard_normal((2, n))
        L = bass + 1.0 * lo + 0.2 * hi + amb[0]
        R = bass + 0.25 * lo + 0.9 * hi + amb[1]
        return np.stack([L, R], axis=-1).astype(np.float32)

    def test_intensity_wire_decodes_identically_on_cpu(self):
        """Device-encoded (codes, sidecar levels, gains) must decode to
        the same waveform on CPU within float-fusion tolerance — the
        wire is the contract, not the backend."""
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(44100, filters_n=1024, bark_bands_n=64)
        x = jnp.asarray(self._panned_signal()[None])

        @jax.jit
        def enc(c, xx):
            return c.encode_frames(
                c.mdct.transform(xx), threshold_scale=8.0, ms=True,
                nf=True, bwe=True, intensity=True,
            )

        e = enc(codec, x)
        codes = np.asarray(e.codes)
        bark = np.asarray(e.bark16)
        nfl = np.asarray(e.nf_levels)
        bweg = np.asarray(e.bwe_gains)
        isg = np.asarray(e.is_gains)
        # the forced side band is all-zero on the wire
        assert (codes[..., codec.is_start :, 1] == 0).all()
        assert (isg > 0).any()

        @jax.jit
        def dec(c, co, ba, nl, bg, ig):
            return c.decode_bitstream_ms(
                co, ba, threshold_scale=8.0, nf_levels=nl,
                bwe_gains=bg, is_gains=ig,
            )

        dev = np.asarray(dec(codec, e.codes, e.bark16, e.nf_levels,
                             e.bwe_gains, e.is_gains))
        cpu_codec = Codec.create(44100, filters_n=1024, bark_bands_n=64)
        cpu = np.asarray(
            _on_cpu(dec, cpu_codec, codes, bark, nfl, bweg, isg)
        )
        assert np.isfinite(dev).all()
        err = np.abs(dev - cpu)
        scale = np.abs(cpu).max()
        assert err.max() <= 2e-4 * max(scale, 1.0), (
            f"device and CPU decodes of the same wire diverge: "
            f"max err {err.max():.3e} at signal scale {scale:.3f}"
        )

    def test_scq_levels_are_on_grid_and_decode_bit_exact(self):
        """Device-snapped sidecars must contain ONLY grid-table values
        (levels_from_bark16 raises otherwise) and reconstruct to the
        identical bfloat16 bits through the shared table."""
        from audiocodec_tpu import scq
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(44100, filters_n=1024, bark_bands_n=64)
        x = jnp.asarray(self._panned_signal()[None])

        @jax.jit
        def sidecar(c, xx):
            return c.analyze_for_quantization(
                c.mdct.transform(xx), ms=True
            )[1]

        bark16 = np.asarray(sidecar(codec, x))
        lv = scq.levels_from_bark16(bark16, codec.sidecar_grid)
        back = scq.bark16_from_levels(lv, codec.sidecar_grid,
                                      bark16.shape)
        np.testing.assert_array_equal(
            np.asarray(back).view(np.uint16), bark16.view(np.uint16)
        )


class TestInt8OnHardware:
    """The int8 tier (s8 x s8 -> s32 dot_general) compiled for the card:
    the transform's error bound, and the analysis against an exact host
    emulation of the same arithmetic (ops/mdct_reference.py)."""

    def _snr(self, ref, deg):
        ref = np.asarray(ref, dtype=np.float64).ravel()
        err = ref - np.asarray(deg, dtype=np.float64).ravel()
        return 10 * np.log10(ref.dot(ref) / max(err.dot(err), 1e-30))

    def test_int8_kernels_compile_and_bound_error(self):
        from audiocodec_tpu.mdct import MDCT

        m_hi = MDCT.create(1024, dct_precision="highest")
        m_i8 = MDCT.create(1024, dct_precision="int8")
        rng = np.random.default_rng(0)
        x = jnp.asarray(
            rng.uniform(-0.9, 0.9, (2, 8 * 1024, 1)), jnp.float32
        )
        got = np.asarray(jax.jit(m_i8.transform)(x))
        want = jax.jit(m_hi.transform)(x)
        assert self._snr(want, got) > 40.0
        y = jnp.asarray(
            rng.uniform(-0.5, 0.5, (2, 8, 1024, 1)), jnp.float32
        )
        got = np.asarray(jax.jit(m_i8.inverse_transform)(y))
        want = jax.jit(m_hi.inverse_transform)(y)
        # the synthesis runs at the one-pass float tier (TF32 here)
        assert self._snr(want, got) > 38.0

    def test_int8_matches_host_emulation(self):
        """Integer products are exact in int32 and the per-row scales
        deterministic: only the float32 rescale epilogue may differ by
        ulps."""
        from audiocodec_tpu.mdct import MDCT
        from audiocodec_tpu.ops import mdct_reference

        m_i8 = MDCT.create(1024, dct_precision="int8")
        rng = np.random.default_rng(1)
        x = rng.uniform(-0.9, 0.9, (2, 6 * 1024, 2)).astype(np.float32)
        got = np.asarray(jax.jit(m_i8.transform)(jnp.asarray(x)))
        want = mdct_reference.int8_forward(x, m_i8)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)

    def test_int8_codec_snr_gate_on_device(self):
        """Composed quantized SNR through the compiled int8 kernels."""
        from audiocodec_tpu.codec import Codec

        sr = 44100
        codec = Codec.create(
            sr, filters_n=1024, bark_bands_n=64,
            compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="int8",
        )
        t = np.arange(int(sr * 2.0) // 1024 * 1024) / sr
        rng = np.random.default_rng(2)
        x = jnp.asarray(
            np.clip(
                0.4 * np.sin(2 * np.pi * 440 * t)
                + 0.3 * np.sin(2 * np.pi * 1320 * t)
                + 0.05 * rng.normal(size=t.size), -1, 1
            ).astype(np.float32)[None, :, None],
            dtype=jnp.bfloat16,
        )
        out = np.asarray(
            jax.jit(codec.round_trip_quantized)(x).astype(jnp.float32)
        )[:, 1024:-1024]
        ref = np.asarray(x.astype(jnp.float32), dtype=np.float64)
        err = ((ref - out.astype(np.float64)) ** 2).sum()
        snr = 10 * np.log10((ref**2).sum() / max(err, 1e-30))
        # bf16-fast default gates at 16.0 on this two-tone family; int8
        # adds ~0.1 dB of transform noise
        assert snr > 15.8, snr


class TestWireContractOnHardware:
    """Step sizes are derived on both ends of the wire from the sidecar:
    a GPU encoder and a CPU decoder must get identical bits at every
    bark_precision tier (the W_inv expansion is pinned to HIGHEST)."""

    @pytest.mark.parametrize("bark_precision", ["highest", "default"])
    def test_step_sizes_match_cpu(self, bark_precision):
        from audiocodec_tpu import quantize
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(44100, filters_n=1024, bark_bands_n=64,
                             bark_precision=bark_precision)
        rng = np.random.default_rng(11)
        t = np.arange(32 * 1024) / 44100
        x = (0.3 * np.sin(2 * np.pi * 523 * t)[:, None]
             + 0.05 * rng.standard_normal((t.size, 2))).astype(np.float32)

        def steps(c, bark16):
            return quantize.step_size(c.psycho.bark_intensity_to_threshold(
                bark16.astype(jnp.float32)))

        bark16 = jax.jit(
            lambda c, xx: c.encode_bitstream(xx)[1]
        )(codec, jnp.asarray(x[None]))
        dev = np.asarray(jax.jit(steps)(codec, bark16))
        cpu = np.asarray(_on_cpu(steps, codec, np.asarray(bark16)))
        np.testing.assert_array_equal(dev.view(np.uint32),
                                      cpu.view(np.uint32))


class TestGoldenVectorsOnHardware:
    """Every committed golden container (tests/vectors/) decodes on the
    card within test_vectors.py's own tolerances: codes bit-exact, PCM
    within +-4 LSB, lossless containers bit-exact."""

    @pytest.mark.parametrize("name", [
        "test_plain", "test_ladder", "test_stereo_ms", "test_scq",
        "test_intensity", "test_bwe", "test_cbr_stream",
    ])
    def test_lossy_vector_decodes(self, name):
        import json
        import os

        import test_vectors as tv

        from audiocodec_tpu.codec import Codec

        codec = Codec.create(tv.SR, filters_n=tv.N, bark_bands_n=tv.BARK)
        with open(os.path.join(tv.VEC_DIR, "manifest.json")) as f:
            manifest = json.load(f)
        getattr(tv.TestVectors(), name)(codec, manifest)

    @pytest.mark.parametrize("name", ["lossless_v2", "lossless_v3"])
    def test_lossless_vector_decodes(self, name):
        import os

        import test_vectors as tv

        from audiocodec_tpu import lossless

        with open(os.path.join(tv.VEC_DIR, name + ".bin"), "rb") as f:
            blob = f.read()
        ref = np.load(os.path.join(tv.VEC_DIR, name + ".pcm.npy"))
        y, _, _ = lossless.decode_lossless(blob)
        np.testing.assert_array_equal(y, ref)


class TestDenseFormOnHardware:
    """The dense MDCT form (one GEMM against both fold taps and a shifted
    add, ops/dct.two_tap) on the card at the codec's real width, against
    the same formula in float64 from the bf16-rounded operands."""

    def test_bf16_dense_matches_float64_at_full_width(self):
        from audiocodec_tpu.mdct import MDCT
        from audiocodec_tpu.ops import dct

        m = MDCT.create(1024, compute_dtype=jnp.bfloat16, fast_bf16=True,
                        dct_precision="default")
        rng = np.random.default_rng(12)
        x = jnp.asarray(rng.uniform(-1, 1, (8, 430, 1024)), jnp.bfloat16)
        got = np.asarray(jax.jit(lambda v, w: dct.two_tap(
            v, w, fast_bf16=True, precision="default"))(x, m.dense_fwd),
            np.float64)
        x64 = np.asarray(x, np.float64)
        w64 = np.asarray(m.dense_fwd.astype(jnp.bfloat16), np.float64)
        z = x64 @ w64
        want = np.zeros(got.shape)
        want[:, :-1] += z[..., :1024]
        want[:, 1:] += z[..., 1024:]
        # one bf16 rounding of the float32 sum: 2^-8 relative at most
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                   atol=2.0 ** -9 * np.abs(want).max())

    def test_bf16_dense_round_trip_snr(self):
        from audiocodec_tpu.codec import Codec

        codec = Codec.create(
            44100, filters_n=1024, bark_bands_n=64,
            compute_dtype=jnp.bfloat16, fast_bf16=True,
            dct_precision="default", bark_precision="default",
        )
        x = TestQuantizedQualityOnHardware._two_tone(44100, 2.0,
                                                     jnp.bfloat16)
        out = np.asarray(
            jax.jit(codec.round_trip_quantized)(x).astype(jnp.float32)
        )[:, 1024:-1024]
        snr = TestQuantizedQualityOnHardware._snr(
            np.asarray(x.astype(jnp.float32)), out)
        assert snr > 16.0, snr

    def test_gradient_through_dense_form(self):
        from audiocodec_tpu.mdct import MDCT

        m = MDCT.create(1024, compute_dtype=jnp.bfloat16, fast_bf16=True,
                        dct_precision="default")
        x = jnp.ones((1, 8 * 1024, 1), jnp.bfloat16) * 0.3
        g = jax.jit(jax.grad(lambda v: jnp.sum(
            m.inverse_transform(m.transform(v)).astype(jnp.float32) ** 2
        )))(x)
        assert bool(jnp.all(jnp.isfinite(g.astype(jnp.float32))))
        assert float(jnp.max(jnp.abs(g.astype(jnp.float32)))) > 0
