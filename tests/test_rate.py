"""Rate control tests: hit a target bitrate by threshold scaling."""

import jax.numpy as jnp
import numpy as np
import pytest

from audiocodec_tpu import native, rate
from audiocodec_tpu.codec import Codec

pytestmark = pytest.mark.skipif(
    not native.available(), reason="rate control packs via the Rice coder"
)


@pytest.fixture(scope="module")
def codec():
    return Codec.create(16000, filters_n=256, bark_bands_n=32)


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(0)
    t = np.arange(2 * 16000) / 16000
    wave = np.clip(
        0.4 * np.sin(2 * np.pi * 440 * t) + 0.15 * rng.normal(size=t.size),
        -1, 1,
    ).astype(np.float32)
    wave = wave[: wave.size // 256 * 256]
    return jnp.asarray(wave[None, :, None])


class TestRateControl:
    @pytest.mark.parametrize("target", [32.0, 64.0])
    def test_hits_target_bitrate(self, codec, clip, target):
        res = rate.encode_with_target_bitrate(codec, clip, target)
        assert abs(res.kbps - target) <= 0.10 * target
        # the packed bytes decode
        from audiocodec_tpu.io import bitstream

        codes, bark, meta = bitstream.unpack(res.packed)
        out = codec.decode_bitstream(
            jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
            threshold_scale=meta["threshold_scale"],
        )
        assert out.shape[1] == clip.shape[1] + 2 * 256
        assert bool(jnp.all(jnp.isfinite(out)))

    def test_lower_bitrate_lower_quality(self, codec, clip):
        from audiocodec_tpu.io import bitstream

        def snr_at(kbps):
            res = rate.encode_with_target_bitrate(codec, clip, kbps)
            codes, bark, meta = bitstream.unpack(res.packed)
            out = codec.decode_bitstream(
                jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
                threshold_scale=meta["threshold_scale"],
            )
            a = np.asarray(clip[0, :, 0], dtype=np.float64)
            b = np.asarray(out[0, 256 : 256 + clip.shape[1], 0],
                           dtype=np.float64)
            return 10 * np.log10((a**2).sum() / ((a - b) ** 2).sum())

        assert snr_at(96.0) > snr_at(24.0)

    def test_ms_rate_control(self, codec, clip):
        stereo = jnp.concatenate([clip, clip * 0.97], axis=-1)
        res = rate.encode_with_target_bitrate(
            codec, stereo, 64.0, ms=True
        )
        assert abs(res.kbps - 64.0) <= 0.10 * 64.0
        assert res.bark16.shape[-1] == 1  # single-channel sidecar

    def test_single_clip_enforced(self, codec, clip):
        batch = jnp.concatenate([clip, clip], axis=0)
        with pytest.raises(ValueError, match="single clip"):
            rate.encode_with_target_bitrate(codec, batch, 64.0)

    def test_ms_rate_controlled_file_decodes_via_library(self, codec, clip):
        """The full ms + rate-control path through pack/unpack and the
        PUBLIC decode_bitstream_ms(threshold_scale=...) API."""
        from audiocodec_tpu.io import bitstream

        stereo = jnp.concatenate([clip, clip * 0.97], axis=-1)
        res = rate.encode_with_target_bitrate(codec, stereo, 48.0, ms=True)
        codes, bark, meta = bitstream.unpack(res.packed)
        assert meta["threshold_scale"] == pytest.approx(
            res.threshold_scale, rel=1e-12
        )
        out = codec.decode_bitstream_ms(
            jnp.asarray(codes), jnp.asarray(bark, dtype=jnp.bfloat16),
            threshold_scale=meta["threshold_scale"],
        )
        a = np.asarray(stereo[0, :, :], dtype=np.float64)
        b = np.asarray(out[0, 256 : 256 + stereo.shape[1], :],
                       dtype=np.float64)
        snr = 10 * np.log10((a**2).sum() / ((a - b) ** 2).sum())
        assert snr > 3.0  # 48 kbps stereo is coarse but must be coherent

    def test_bad_target_rejected(self, codec, clip):
        for bad in (0.0, -5.0, float("nan")):
            with pytest.raises(ValueError, match="positive"):
                rate.encode_with_target_bitrate(codec, clip, bad)


class TestBatchRateControl:
    def test_batch_each_clip_hits_target(self, codec, clip):
        """Every clip of a batch converges to its own scale (trials are
        vmapped — 2 device passes for the whole batch)."""
        rng = np.random.default_rng(3)
        quiet = jnp.asarray(
            np.clip(
                0.05 * rng.normal(size=clip.shape), -1, 1
            ).astype(np.float32)
        )
        batch = jnp.concatenate([clip, quiet], axis=0)
        results = rate.encode_with_target_bitrate_batch(codec, batch, 48.0)
        assert len(results) == 2
        for res in results:
            assert abs(res.kbps - 48.0) <= 0.15 * 48.0
        # the louder clip needs a larger scale to fit the same budget
        assert results[0].threshold_scale > results[1].threshold_scale

    def test_batch_matches_single(self, codec, clip):
        single = rate.encode_with_target_bitrate(codec, clip, 64.0)
        batched = rate.encode_with_target_bitrate_batch(
            codec, clip, 64.0, trials_per_round=6
        )[0]
        assert abs(single.kbps - batched.kbps) <= 0.10 * 64.0


class TestReservoirAllocate:
    """rate.reservoir_allocate: demand-proportional bits under a hard
    excursion bound (the CBR bit reservoir's allocation core)."""

    DEMAND = np.array([100.0, 100.0, 400.0, 100.0, 100.0])

    def test_zero_reservoir_is_equal_shares(self):
        t = rate.reservoir_allocate(self.DEMAND, 800.0, 0.0)
        np.testing.assert_allclose(t, 160.0, rtol=1e-9)

    def test_large_reservoir_reproduces_demand(self):
        t = rate.reservoir_allocate(self.DEMAND, 800.0, 1e9)
        np.testing.assert_allclose(t, self.DEMAND, rtol=1e-9)

    @pytest.mark.parametrize("reservoir", [10.0, 50.0, 120.0, 300.0])
    def test_excursion_bound_and_budget(self, reservoir):
        t = rate.reservoir_allocate(self.DEMAND, 800.0, reservoir)
        dev = np.cumsum(t) - 160.0 * np.arange(1, 6)
        assert np.abs(dev).max() <= reservoir * (1 + 1e-9) + 1e-6
        assert abs(t.sum() - 800.0) <= 1e-6 * 800.0 + 1.0

    def test_hard_chunk_gains_monotonically_with_reservoir(self):
        prev = rate.reservoir_allocate(self.DEMAND, 800.0, 0.0)[2]
        for r in (20.0, 50.0, 100.0, 240.0):
            cur = rate.reservoir_allocate(self.DEMAND, 800.0, r)[2]
            assert cur >= prev - 1e-9
            prev = cur

    def test_bound_is_hard_under_concentrated_demand(self):
        """Adversarial case for the renormalization pass: demand piled
        into one chunk far above share+reservoir. Renormalizing AFTER
        clamping used to push chunks back over the bound; the final
        projection must keep every prefix excursion within ±reservoir
        even when that means returning slightly under budget."""
        demand = np.array([1.0, 1.0, 1e6, 1.0, 1.0, 1.0, 1.0, 1.0])
        budget, reservoir = 8000.0, 200.0
        t = rate.reservoir_allocate(demand, budget, reservoir)
        share = budget / demand.shape[0]
        dev = np.cumsum(t) - share * np.arange(1, demand.shape[0] + 1)
        assert np.abs(dev).max() <= reservoir * (1 + 1e-9) + 1e-6, dev
        # budget is best-effort inside the hard bound
        assert t.sum() <= budget * (1 + 1e-9)
        assert (t >= 0).all()

    def test_floor_respected(self):
        t = rate.reservoir_allocate(
            np.array([1.0, 1.0, 1000.0]), 300.0, 1e9, floor=40.0
        )
        assert (t >= 40.0 - 1e-9).all()

    def test_validation(self):
        with pytest.raises(ValueError, match="reservoir"):
            rate.reservoir_allocate(self.DEMAND, 800.0, -1.0)
        with pytest.raises(ValueError, match="demand"):
            rate.reservoir_allocate(np.zeros(3), 800.0, 10.0)


class TestPerClipTargets:
    def test_vector_targets_each_clip_converges(self, codec, clip):
        batch = jnp.concatenate([clip, clip], axis=0)
        targets = np.array([24.0, 72.0])
        results = rate.encode_with_target_bitrate_batch(
            codec, batch, targets
        )
        for res, tgt in zip(results, targets):
            assert abs(res.kbps - tgt) <= 0.15 * tgt
        # same content at a 3x budget must quantize finer
        assert results[1].threshold_scale < results[0].threshold_scale

    def test_vector_target_validation(self, codec, clip):
        batch = jnp.concatenate([clip, clip], axis=0)
        with pytest.raises(ValueError, match="one value per clip"):
            rate.encode_with_target_bitrate_batch(
                codec, batch, np.array([24.0, 48.0, 96.0])
            )
        with pytest.raises(ValueError, match="positive"):
            rate.encode_with_target_bitrate_batch(
                codec, batch, np.array([24.0, -1.0])
            )
