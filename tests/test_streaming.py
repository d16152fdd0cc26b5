"""Streaming (chunked, carried-state) encode/decode tests.

The key property: chunk-streamed output is bit-identical (up to f32
associativity) to the one-shot batch transform, for any chunking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiocodec_tpu import streaming
from audiocodec_tpu.codec import Codec
from audiocodec_tpu.mdct import MDCT


@pytest.fixture(scope="module")
def mdct():
    return MDCT.create(64)


def _wave(b=2, blocks=12, n=64, c=2, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.uniform(-1, 1, size=(b, blocks * n, c)), dtype=jnp.float32
    )


class TestStreamEqualsBatch:
    @pytest.mark.parametrize("chunk_blocks", [1, 2, 3, 4, 6, 12])
    def test_transform_matches_batch(self, mdct, chunk_blocks):
        x = _wave()
        batch = mdct.transform(x)
        streamed = streaming.stream_transform(mdct, x, chunk_blocks)
        np.testing.assert_allclose(
            np.asarray(streamed), np.asarray(batch), atol=1e-6
        )

    @pytest.mark.parametrize("chunk_blocks", [1, 2, 4])
    def test_inverse_matches_batch(self, mdct, chunk_blocks):
        rng = np.random.default_rng(1)
        y = jnp.asarray(
            rng.uniform(-0.5, 0.5, size=(2, 8, 64, 2)), dtype=jnp.float32
        )
        batch = mdct.inverse_transform(y)
        streamed = streaming.stream_inverse_transform(mdct, y, chunk_blocks)
        np.testing.assert_allclose(
            np.asarray(streamed), np.asarray(batch), atol=1e-5
        )

    def test_manual_step_loop_matches_batch(self, mdct):
        """Host-driven step/flush loop (the real-time API) == batch."""
        x = _wave(b=1, blocks=6, c=1, seed=2)
        batch = np.asarray(mdct.transform(x))

        carry = streaming.mdct_stream_init(mdct, 1, 1)
        frames = []
        for start in range(0, 6 * 64, 2 * 64):
            chunk = x[:, start : start + 2 * 64]
            carry, f = streaming.mdct_stream_step(mdct, carry, chunk)
            frames.append(np.asarray(f))
        frames.append(np.asarray(streaming.mdct_stream_flush(mdct, carry)))
        streamed = np.concatenate(frames, axis=1)
        np.testing.assert_allclose(streamed, batch, atol=1e-6)


class TestStreamingRoundTrip:
    def test_quantized_streaming_round_trip(self):
        codec = Codec.create(16000, filters_n=64, bark_bands_n=16)
        x = _wave(b=1, blocks=12, c=1, seed=3) * 0.5
        out = streaming.streaming_round_trip(codec, x, chunk_blocks=4)
        assert out.shape == (1, x.shape[1] + 2 * 64, 1)
        # matches the non-streaming quantized round trip exactly
        batch = codec.round_trip_quantized(x)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(batch), atol=1e-5
        )

    def test_streaming_is_resumable(self):
        """Carry state fully captures the stream: splitting a session into
        two step sequences gives identical frames (checkpoint/resume)."""
        mdct = MDCT.create(64)
        x = _wave(b=1, blocks=8, c=1, seed=4)

        carry = streaming.mdct_stream_init(mdct, 1, 1)
        carry, f1 = streaming.mdct_stream_step(mdct, carry, x[:, : 4 * 64])
        # "checkpoint": serialize carry to host, restore, continue
        restored = jnp.asarray(np.asarray(carry))
        _, f2 = streaming.mdct_stream_step(mdct, restored, x[:, 4 * 64 :])
        streamed = np.concatenate([np.asarray(f1), np.asarray(f2)], axis=1)
        batch = np.asarray(mdct.transform(x))[:, :-1]
        np.testing.assert_allclose(streamed, batch, atol=1e-6)

    def test_bad_chunk_size_raises(self, mdct):
        x = _wave(b=1, blocks=5, c=1)
        with pytest.raises(ValueError, match="multiple of"):
            streaming.stream_transform(mdct, x, chunk_blocks=2)


class TestStreamDenseMode:
    """dct_precision="default" MDCTs carry the dense one-GEMM
    formulation; the streaming steps must follow it so stream == batch
    holds bit-exactly in that mode too."""

    @pytest.fixture()
    def mdct_dense(self):
        m = MDCT.create(64, dct_precision="default")
        assert m.dense_fwd is not None
        return m

    @pytest.mark.parametrize("chunk_blocks", [1, 3, 4, 12])
    def test_transform_bit_identical(self, mdct_dense, chunk_blocks):
        x = _wave(seed=7)
        batch = np.asarray(mdct_dense.transform(x))
        streamed = np.asarray(
            streaming.stream_transform(mdct_dense, x, chunk_blocks)
        )
        np.testing.assert_allclose(streamed, batch, atol=1e-6)

    @pytest.mark.parametrize("chunk_blocks", [1, 2, 4])
    def test_inverse_bit_identical(self, mdct_dense, chunk_blocks):
        rng = np.random.default_rng(8)
        y = jnp.asarray(
            rng.uniform(-0.5, 0.5, size=(2, 8, 64, 2)), dtype=jnp.float32
        )
        batch = np.asarray(mdct_dense.inverse_transform(y))
        streamed = np.asarray(
            streaming.stream_inverse_transform(mdct_dense, y, chunk_blocks)
        )
        np.testing.assert_allclose(streamed, batch, atol=1e-5)

    def test_step_flush_round_trip(self, mdct_dense):
        """Manual step/flush loop through BOTH directions reconstructs."""
        m = mdct_dense
        x = _wave(b=1, blocks=6, c=1, seed=9)
        enc = streaming.mdct_stream_init(m, 1, 1)
        frames = []
        for start in range(0, 6 * 64, 3 * 64):
            enc, f = streaming.mdct_stream_step(m, enc, x[:, start:start + 3 * 64])
            frames.append(f)
        frames.append(streaming.mdct_stream_flush(m, enc))
        y = jnp.concatenate(frames, axis=1)

        dec = streaming.imdct_stream_init(m, 1, 1)
        outs = []
        for start in range(0, y.shape[1], 2):
            dec, s = streaming.imdct_stream_step(m, dec, y[:, start:start + 2])
            outs.append(s)
        outs.append(streaming.imdct_stream_flush(m, dec))
        rt = np.concatenate([np.asarray(o) for o in outs], axis=1)
        # rt has (blocks+2)*N samples (blocks+1 framing applied twice)
        err = np.abs(np.asarray(x)[0, :, 0] - rt[0, 64:-64, 0]).max()
        assert err < 1e-5
