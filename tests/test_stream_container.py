"""Seekable stream container (.acs) tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from audiocodec_tpu import native
from audiocodec_tpu.codec import Codec
from audiocodec_tpu.io import stream_container as sc

pytestmark = pytest.mark.skipif(
    not native.available(), reason="stream container needs the Rice coder"
)


@pytest.fixture(scope="module")
def codec():
    return Codec.create(16000, filters_n=64, bark_bands_n=16)


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(0)
    t = np.arange(24 * 64) / 16000
    wave = (
        0.5 * np.sin(2 * np.pi * 500 * t)
        + 0.1 * rng.normal(size=t.size)
    ).astype(np.float32)
    return jnp.asarray(np.clip(wave, -1, 1)[None, :, None])


class TestContainerRoundTrip:
    def test_write_read_chunks(self, codec, signal, tmp_path):
        path = str(tmp_path / "s.acs")
        n_chunks = sc.encode_stream(codec, signal, path, chunk_blocks=8)
        assert n_chunks == 4  # 3 body chunks + flush frame
        with sc.StreamReader(path) as r:
            assert r.n_chunks == 4
            assert r.meta["filters_n"] == 64
            chunk = r.read_chunk(0)
            assert chunk.codes.shape == (8, 64, 1)
            assert chunk.bark.shape == (8, 16, 1)
            assert chunk.tns is None  # non-TNS stream
            assert chunk.nfl is None  # non-noise-filling stream
            # flush chunk is a single frame
            assert r.read_chunk(3).codes.shape == (1, 64, 1)

    def test_full_decode_matches_monolithic(self, codec, signal, tmp_path):
        """Streaming encode+decode == the monolithic bitstream round trip."""
        path = str(tmp_path / "m.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        chunks = list(sc.decode_stream(codec, path))
        streamed = np.concatenate([np.asarray(c) for c in chunks], axis=1)

        codes, bark16 = codec.encode_bitstream(signal)
        mono = np.asarray(codec.decode_bitstream(codes, bark16))
        np.testing.assert_allclose(streamed, mono, atol=1e-5)

    def test_seek_mid_stream(self, codec, signal, tmp_path):
        """Decoding from chunk k matches the same samples of a full decode
        (one-frame context re-priming works)."""
        path = str(tmp_path / "k.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        full = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        partial = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path, start_chunk=2)],
            axis=1,
        )
        # chunk 0,1 cover 16 blocks = 16*64 samples of output
        np.testing.assert_allclose(
            partial, full[:, 16 * 64 :], atol=1e-6
        )

    def test_wrong_dtype_input_rejected(self, codec, signal, tmp_path):
        """The no-implicit-casting contract: a float64 signal into an f32
        codec's stream encoder must raise, not silently downcast (the
        device-commit asarray must not swallow the check)."""
        bad = np.asarray(signal, dtype=np.float64)
        with pytest.raises(TypeError, match="never casts implicitly"):
            sc.encode_stream(
                codec, bad, str(tmp_path / "x.acs"), chunk_blocks=8
            )

    def test_jitted_chunk_path_bit_identical_to_eager(
        self, codec, signal, tmp_path
    ):
        """encode_stream's jitted per-chunk step must produce the exact
        bytes of an eager per-chunk loop (the pre-jit implementation): the
        container path is bitstream-critical, so compiling it may not
        change a single code."""
        from audiocodec_tpu import streaming

        path = str(tmp_path / "jit.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)

        eager_path = str(tmp_path / "eager.acs")
        mdct = codec.mdct
        chunk = 8 * mdct.filters_n
        with sc.StreamWriter(
            eager_path,
            sample_rate=codec.psycho.sample_rate,
            filters_n=mdct.filters_n,
            bark_bands_n=codec.psycho.bark_bands_n,
            alpha=codec.psycho.alpha,
            window_type=mdct.window_type,
            channels=1,
            compute_dtype=str(jnp.dtype(mdct.compute_dtype)),
            sidecar_grid=codec.sidecar_grid,
        ) as w:
            carry = streaming.mdct_stream_init(mdct, 1, 1)
            for start in range(0, signal.shape[1], chunk):
                carry, frames = streaming.mdct_stream_step(
                    mdct, carry, signal[:, start : start + chunk]
                )
                w.append(*codec.quantize_frames(frames, 0.0))
            last = streaming.mdct_stream_flush(mdct, carry)
            w.append(*codec.quantize_frames(last, 0.0))

        with open(path, "rb") as f1, open(eager_path, "rb") as f2:
            assert f1.read() == f2.read()

    def test_bad_magic_raises(self, tmp_path):
        path = str(tmp_path / "x.acs")
        with open(path, "wb") as f:
            f.write(b"nope" * 10)
        with pytest.raises(ValueError, match="magic"):
            sc.StreamReader(path)

    def test_chunk_index_bounds(self, codec, signal, tmp_path):
        path = str(tmp_path / "b.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        with sc.StreamReader(path) as r:
            with pytest.raises(IndexError):
                r.read_chunk(99)

    def test_corruption_detected(self, codec, signal, tmp_path):
        path = str(tmp_path / "c.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        with sc.StreamReader(path) as r:
            off = r._index[1]
        with open(path, "r+b") as f:
            f.seek(off + 12)
            f.write(b"\xff\xff")  # flip payload bytes
        with sc.StreamReader(path) as r:
            r.read_chunk(0)  # untouched chunk still reads
            with pytest.raises(ValueError, match="CRC"):
                r.read_chunk(1)

    def test_concealment_survives_corrupt_chunk(self, codec, signal,
                                                tmp_path):
        """With conceal=True a CRC-failing chunk is synthesized (spectral
        repetition + fade) instead of raising: stream length is preserved,
        output stays finite, chunks outside the outage are untouched, and
        decoding recovers at the next good chunk."""
        path = str(tmp_path / "pl.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        clean = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        with sc.StreamReader(path) as r:
            off = r._index[1]
        with open(path, "r+b") as f:
            f.seek(off + 12)
            f.write(b"\xff\xff")
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, conceal=True)],
            axis=1,
        )
        assert out.shape == clean.shape
        assert np.isfinite(out).all()
        n = 64  # filters_n of the fixture codec
        # chunk 0's interior is decoded from untouched data
        np.testing.assert_allclose(out[:, : 7 * n], clean[:, : 7 * n],
                                   atol=1e-6)
        # after one overlap frame into chunk 2, decode recovers exactly
        np.testing.assert_allclose(out[:, 17 * n :], clean[:, 17 * n :],
                                   atol=1e-6)
        # the concealed region fades rather than slamming to zero
        lost = out[:, 8 * n : 16 * n]
        assert np.abs(lost).max() > 0

    def test_concealment_off_still_raises(self, codec, signal, tmp_path):
        path = str(tmp_path / "pl2.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        with sc.StreamReader(path) as r:
            off = r._index[1]
        with open(path, "r+b") as f:
            f.seek(off + 12)
            f.write(b"\xff\xff")
        with pytest.raises(ValueError, match="CRC"):
            for _ in sc.decode_stream(codec, path):
                pass

    def test_interpolative_concealment_keeps_energy(self, codec, signal,
                                                    tmp_path):
        """With BOTH neighbors readable (the usual single-loss case),
        concealment interpolates the spectral envelope instead of
        fading toward silence: on stationary content the concealed
        region keeps most of the signal's energy (a decay-only fill
        of 0.8^k would retain ~18% mean power)."""
        path = str(tmp_path / "ik.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        clean = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        with sc.StreamReader(path) as r:
            off = r._index[1]
        with open(path, "r+b") as f:
            f.seek(off + 12)
            f.write(b"\xff\xff")
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, conceal=True)],
            axis=1,
        )
        n = 64
        lost = out[:, 9 * n : 15 * n]  # interior of the concealed chunk
        ref = clean[:, 9 * n : 15 * n]
        ratio = float((lost**2).sum() / (ref**2).sum())
        assert 0.5 < ratio < 2.0, ratio

    def test_concealment_consecutive_losses_decay(self, codec, signal,
                                                  tmp_path):
        """Two corrupt chunks in a row keep fading — a long outage decays
        toward silence instead of freezing a tone."""
        path = str(tmp_path / "pl3.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        with sc.StreamReader(path) as r:
            offs = [r._index[1], r._index[2]]
        with open(path, "r+b") as f:
            for off in offs:
                f.seek(off + 12)
                f.write(b"\xff\xff")
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, conceal=True)],
            axis=1,
        )
        assert np.isfinite(out).all()
        n = 64
        e1 = (out[:, 9 * n : 10 * n] ** 2).sum()
        e2 = (out[:, 17 * n : 18 * n] ** 2).sum()
        assert e2 < e1  # still decaying through the second lost chunk

    def test_conceal_bounds_corrupt_blocks_header(self, codec, signal,
                                                  tmp_path):
        """A corrupted per-chunk 'blocks' field is an untrusted u32; the
        concealment path must size the synthesized chunk from the
        stream's UNIFORM body size, never from the corrupt header (which
        could demand a multi-gigabyte tensor)."""
        import struct

        path = str(tmp_path / "hb.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        clean = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        with sc.StreamReader(path) as r:
            off = r._index[1]
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(struct.pack("<I", 5_000_000))  # absurd blocks field
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, conceal=True)],
            axis=1,
        )
        assert out.shape == clean.shape  # concealed at the body size
        assert np.isfinite(out).all()

    def test_conceal_seek_past_corrupt_prefix(self, codec, signal,
                                              tmp_path):
        """Seeking into an nf stream whose PREFIX holds a corrupt chunk
        must still decode under conceal (the frame-offset prefix sum
        falls back to the uniform body size)."""
        import struct

        path = str(tmp_path / "sp.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8, nf=True)
        full = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        with sc.StreamReader(path) as r:
            off = r._index[0]
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(struct.pack("<I", 7)) # wrong blocks -> payload fails
        seek = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, start_chunk=2,
                                       conceal=True)],
            axis=1,
        )
        # chunks >= 2 are untouched; the guarded prefix sum restores the
        # exact global frame offsets, so the noise fill reproduces and
        # the seek matches the clean full decode sample-exactly
        np.testing.assert_allclose(
            seek, full[:, -seek.shape[1]:], atol=1e-6
        )

    def test_conceal_after_seek_extrapolates_from_prev(self, codec,
                                                       signal, tmp_path):
        """When the first chunk AFTER a seek is lost, concealment must
        extrapolate from the seek-primed previous frame, not silence."""
        path = str(tmp_path / "cs.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        with sc.StreamReader(path) as r:
            off = r._index[2]
        with open(path, "r+b") as f:
            f.seek(off + 12)
            f.write(b"\xff\xff")
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, start_chunk=2,
                                       conceal=True)],
            axis=1,
        )
        n = 64
        # interior of the concealed first post-seek chunk is nonzero
        assert np.abs(out[:, n : 7 * n]).max() > 1e-4

    def test_corrupt_blocks_header_fails_crc(self, codec, signal,
                                             tmp_path):
        """hcrc streams chain the per-chunk header fields into the CRC:
        a flipped blocks field must raise, not silently truncate the
        decode (the payload bytes alone still checksum clean)."""
        import struct

        path = str(tmp_path / "hc.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        with sc.StreamReader(path) as r:
            assert r.meta.get("hcrc") == 1
            off = r._index[1]
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(struct.pack("<I", 7))  # plausible but wrong blocks
        with sc.StreamReader(path) as r:
            with pytest.raises(ValueError, match="CRC"):
                r.read_chunk(1)

    def test_nf_seed_above_int31_decodes(self, codec, signal, tmp_path):
        """Seeds in [2^31, 2^32) are legal wire values and must decode
        (they overflow jit's Python-int argument parsing unless the
        decoder converts to uint32 first)."""
        path = str(tmp_path / "bigseed.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8, nf=True,
                         nf_seed=2**31 + 12345)
        out = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        assert np.isfinite(out).all()

    def test_corrupt_trailer_rejected(self, codec, signal, tmp_path):
        """Implausible trailer fields must be a clean ValueError, not a
        multi-terabyte allocation or struct crash."""
        path = str(tmp_path / "t.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        blob = bytearray(open(path, "rb").read())
        import struct as _struct

        blob[-16:] = _struct.pack("<QQ", 2**40, 12)  # absurd n_chunks
        evil = str(tmp_path / "evil.acs")
        open(evil, "wb").write(bytes(blob))
        with pytest.raises(ValueError, match="corrupt|bounds"):
            sc.StreamReader(evil)

    def test_truncated_file_rejected(self, codec, signal, tmp_path):
        path = str(tmp_path / "tr.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8)
        blob = open(path, "rb").read()
        cut = str(tmp_path / "cut.acs")
        open(cut, "wb").write(blob[: len(blob) // 2])
        with pytest.raises(ValueError, match="corrupt|bounds|truncated"):
            r = sc.StreamReader(cut)
            for i in range(r.n_chunks):
                r.read_chunk(i)

    def test_drown_plumbed_through_stream(self, codec, signal, tmp_path):
        """encode_stream(drown=1.0) must produce coarser codes than 0.0."""
        a = str(tmp_path / "d0.acs")
        b = str(tmp_path / "d1.acs")
        sc.encode_stream(codec, signal, a, chunk_blocks=8, drown=0.0)
        sc.encode_stream(codec, signal, b, chunk_blocks=8, drown=1.0)
        import os as _os

        assert _os.path.getsize(b) < _os.path.getsize(a)


@pytest.fixture(scope="module")
def stereo_signal():
    rng = np.random.default_rng(7)
    t = np.arange(24 * 64) / 16000
    left = 0.5 * np.sin(2 * np.pi * 500 * t) + 0.1 * rng.normal(size=t.size)
    right = 0.45 * np.sin(2 * np.pi * 500 * t) + 0.1 * rng.normal(size=t.size)
    wave = np.stack([left, right], axis=-1).astype(np.float32)
    return jnp.asarray(np.clip(wave, -1, 1)[None])


class TestCBR:
    """Constant-bitrate streams: per-chunk scales on the wire."""

    def _loud_quiet(self, chunks=6, chunk_blocks=8, n=64):
        rng = np.random.default_rng(3)
        s = chunks * chunk_blocks * n
        t = np.arange(s) / 8000.0
        x = 0.4 * np.sin(2 * np.pi * 440 * t)
        x += 0.05 * rng.standard_normal(s)
        x[s // 2 :] *= 0.05
        return jnp.asarray(x.astype(np.float32)[None, :, None])

    def test_round_trip_and_seek(self, codec, tmp_path):
        x = self._loud_quiet()
        path = str(tmp_path / "c.acs")
        n_chunks, scales, kbps = sc.encode_stream_cbr(
            codec, x, path, chunk_blocks=8, target_kbps=48.0
        )
        assert n_chunks == 7 and len(scales) == 6
        with sc.StreamReader(path) as r:
            assert r.meta["cbr"] == 1
            chunk = r.read_chunk(0)
            assert chunk.tscale == scales[0]
            assert r.chunk_blocks(0) == 8  # header read skips the scale
        full = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        assert np.isfinite(full).all()
        seek = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, start_chunk=3)],
            axis=1,
        )
        np.testing.assert_allclose(seek, full[:, -seek.shape[1]:],
                                   atol=1e-6)

    def test_scales_adapt_to_content(self, codec, tmp_path):
        """The dense and silent halves must not share one scale (that is
        the whole point over the stream-global ABR search)."""
        rng = np.random.default_rng(4)
        s = 6 * 8 * 64
        x = np.zeros(s, np.float32)
        x[: s // 2] = np.clip(
            0.6 * rng.standard_normal(s // 2), -1, 1
        )  # bit-hungry broadband
        x = jnp.asarray(x[None, :, None])
        path = str(tmp_path / "ad.acs")
        _, scales, _ = sc.encode_stream_cbr(
            codec, x, path, chunk_blocks=8, target_kbps=24.0
        )
        assert len(set(round(v, 6) for v in scales)) > 1
        # silence needs no coarsening; broadband at a low target does
        assert min(scales[:3]) > max(scales[3:]) or max(scales) > min(
            scales
        )

    def test_per_chunk_scale_list_contract(self, codec, signal, tmp_path):
        with pytest.raises(ValueError, match="one value per body chunk"):
            sc.encode_stream(codec, signal, str(tmp_path / "x.acs"),
                             chunk_blocks=8, threshold_scale=[1.0, 2.0])
        # writer-level contract: tscale exactly when the header says cbr
        w = sc.StreamWriter(
            str(tmp_path / "w.acs"), sample_rate=44100, filters_n=64,
            bark_bands_n=16, alpha=0.6, window_type="vorbis", channels=1,
            cbr=True,
        )
        codes = np.zeros((4, 64, 1), np.int32)
        bark = np.zeros((4, 16, 1), np.float32).astype(jnp.bfloat16)
        with pytest.raises(ValueError, match="threshold scale"):
            w.append(codes, bark)
        w.append(codes, bark, tscale=2.0)
        w.close()

    def test_corrupt_scale_field_fails_crc(self, codec, signal, tmp_path):
        import struct

        path = str(tmp_path / "cs.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8,
                         threshold_scale=[2.0, 2.0, 2.0])
        with sc.StreamReader(path) as r:
            off = r._index[1]
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(struct.pack("<d", 512.0))  # legal value, wrong CRC
        with sc.StreamReader(path) as r:
            r.read_chunk(0)
            with pytest.raises(ValueError, match="CRC"):
                r.read_chunk(1)

    def test_matches_global_scale_stream(self, codec, signal, tmp_path):
        """A CBR stream whose chunks all carry scale s decodes
        bit-identically to the stream-global scale-s stream."""
        pa = str(tmp_path / "g.acs")
        pb = str(tmp_path / "p.acs")
        sc.encode_stream(codec, signal, pa, chunk_blocks=8,
                         threshold_scale=3.0)
        sc.encode_stream(codec, signal, pb, chunk_blocks=8,
                         threshold_scale=[3.0, 3.0, 3.0])
        a = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, pa)], axis=1
        )
        b = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, pb)], axis=1
        )
        np.testing.assert_array_equal(a, b)

    def _verse_chorus(self, chunks=6, chunk_blocks=32, n=64, sr=16000.0):
        """Alternating quiet tone (easy) / dense harmonic stack (hard,
        tonal = low masking = genuinely bit-hungry) chunks."""
        s = chunks * chunk_blocks * n
        t = np.arange(s) / sr
        x = 0.04 * np.sin(2 * np.pi * 330 * t)
        seg = chunk_blocks * n
        for i in range(1, chunks, 2):
            sl = slice(i * seg, (i + 1) * seg)
            for k, f in enumerate(
                [220, 440, 660, 880, 1320, 1980, 2640, 3520, 4700, 6200]
            ):
                x[sl] += (0.25 / (1 + 0.35 * k)) * np.sin(
                    2 * np.pi * f * t[sl] + 0.7 * k
                )
        return jnp.asarray(np.clip(x, -1, 1).astype(np.float32)[None, :, None])

    def test_reservoir_round_trip_and_excursion_bound(
        self, codec, tmp_path
    ):
        """The bit reservoir redistributes bits toward hard chunks while
        the stream's running size stays within the bound (+ the per-chunk
        search tolerance) of the constant-rate schedule; the wire format
        is plain cbr — any decoder reads it."""
        x = self._verse_chorus()
        path = str(tmp_path / "rsv.acs")
        reservoir_kbits = 1.5
        n_chunks, scales, kbps = sc.encode_stream_cbr(
            codec, x, path, chunk_blocks=32, target_kbps=24.0,
            reservoir_kbits=reservoir_kbits,
        )
        assert n_chunks == 7 and len(scales) == 6
        assert abs(kbps - 24.0) <= 0.15 * 24.0
        with sc.StreamReader(path) as r:
            assert r.meta["cbr"] == 1
            sizes = np.array([r.chunk_bytes(i) for i in range(6)])
        dev_kbit = (
            np.cumsum(sizes) - sizes.mean() * np.arange(1, 7)
        ) * 8.0 / 1000.0
        # bound on the targets + 5% per-chunk convergence tolerance
        # accumulated over the prefix
        slack = 0.05 * sizes.mean() * 8.0 / 1000.0 * 6
        assert np.abs(dev_kbit).max() <= reservoir_kbits + slack
        # hard (odd) chunks must have drawn real bits from easy ones
        assert sizes[1::2].mean() > 1.2 * sizes[0::2].mean()
        out = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        assert np.isfinite(out).all()

    def test_reservoir_improves_worst_chunk_nmr(self, codec, tmp_path):
        """At a matched rate the reservoir must beat plain CBR where it
        counts: the worst hard chunk's noise-to-mask ratio (SNR cannot
        see this — the whole point of the reallocation)."""
        from audiocodec_tpu import metrics

        x = self._verse_chorus()
        n = 64
        s = x.shape[1]
        seg = 32 * n
        p0 = str(tmp_path / "plain.acs")
        p1 = str(tmp_path / "rsv.acs")
        _, _, k0 = sc.encode_stream_cbr(
            codec, x, p0, chunk_blocks=32, target_kbps=24.0
        )
        _, _, k1 = sc.encode_stream_cbr(
            codec, x, p1, chunk_blocks=32, target_kbps=24.0,
            reservoir_kbits=1.5,
        )
        assert abs(k1 - k0) <= 0.2 * k0  # matched rate comparison

        def worst_hard_nmr(path):
            out = np.concatenate(
                [np.asarray(c) for c in sc.decode_stream(codec, path)],
                axis=1,
            )[:, n : n + s]  # decode leads with the N-sample boundary pad
            return max(
                float(
                    metrics.nmr_db(
                        codec,
                        x[:, i * seg : (i + 1) * seg],
                        jnp.asarray(out[:, i * seg : (i + 1) * seg]),
                    )
                )
                for i in range(1, 6, 2)
            )

        assert worst_hard_nmr(p1) < worst_hard_nmr(p0) - 1.0

    def test_reservoir_validation(self, codec, signal, tmp_path):
        with pytest.raises(ValueError, match="reservoir"):
            sc.encode_stream_cbr(
                codec, signal, str(tmp_path / "bad.acs"), chunk_blocks=8,
                target_kbps=48.0, reservoir_kbits=-1.0,
            )


class TestFuzz:
    def test_byte_flip_fuzz_raises_or_conceals(self, codec, tmp_path):
        """Random single-byte corruption anywhere in a stream using
        EVERY wire feature (cbr + tns + nf + hcrc) must either decode,
        raise ValueError, or conceal — never crash, hang, or allocate
        unboundedly. 60 seeded flips cover header, scale fields, chunk
        headers, payloads, index, and trailer."""
        import resource

        # ru_maxrss is a PROCESS-WIDE high-water mark: late in a full
        # suite run it reflects everything before this test. Guard the
        # test's own contribution — an alloc bomb here must raise the
        # mark past whatever the session already peaked at.
        rss0_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024

        rng = np.random.default_rng(0)
        t = np.arange(6 * 8 * 64) / 16000
        x = jnp.asarray(
            (0.3 * np.sin(2 * np.pi * 500 * t)
             + 0.05 * rng.standard_normal(t.size))
            .astype(np.float32)[None, :, None]
        )
        path = str(tmp_path / "f.acs")
        sc.encode_stream(codec, x, path, chunk_blocks=8,
                         threshold_scale=[2.0] * 6, tns=True, nf=True)
        blob = bytearray(open(path, "rb").read())
        outcomes = {"ok": 0, "valueerror": 0}
        for i in range(60):
            pos = int(rng.integers(0, len(blob)))
            old = blob[pos]
            blob[pos] ^= int(rng.integers(1, 256))
            evil = str(tmp_path / "evil.acs")
            open(evil, "wb").write(bytes(blob))
            for conceal in (False, True):
                try:
                    for c in sc.decode_stream(codec, evil,
                                              conceal=conceal):
                        assert np.isfinite(np.asarray(c)).all()
                    outcomes["ok"] += 1
                except ValueError:
                    outcomes["valueerror"] += 1
                except IndexError:
                    # StreamReader construction may reject via bounds
                    outcomes["valueerror"] += 1
            blob[pos] = old
        # both outcomes must actually occur across the corpus
        assert outcomes["ok"] > 0 and outcomes["valueerror"] > 0, outcomes
        # and nothing ballooned the process (the alloc-bomb guard):
        # the high-water mark may not grow more than ~1 GB over where
        # the session stood when the test began (the historical npy
        # zlib bomb peaked +1.6 GB)
        peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        assert peak_mb - rss0_mb < 1024, (
            f"peak RSS grew {rss0_mb:.0f} -> {peak_mb:.0f} MB"
        )


class TestStreamFeatureParity:
    """.acs carries everything .acz does: joint stereo + rate control
    (BASELINE config 5 is an hour of stereo streaming)."""

    def test_ms_stream_matches_monolithic_ms(self, codec, stereo_signal,
                                             tmp_path):
        path = str(tmp_path / "ms.acs")
        sc.encode_stream(codec, stereo_signal, path, chunk_blocks=8, ms=True)
        with sc.StreamReader(path) as r:
            assert r.meta["ms"] is True
            # the min-channel sidecar is single-channel, codes are M/S
            chunk = r.read_chunk(0)
            assert chunk.codes.shape == (8, 64, 2)
            assert chunk.bark.shape == (8, 16, 1)
        streamed = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        codes, bark16 = codec.encode_bitstream_ms(stereo_signal)
        mono = np.asarray(codec.decode_bitstream_ms(codes, bark16))
        np.testing.assert_allclose(streamed, mono, atol=1e-5)

    def test_threshold_scale_persisted_and_honored(self, codec,
                                                   stereo_signal, tmp_path):
        """Scaled stream decodes bit-identically to the .acz path with the
        same scale — the step-size invariant under rate control."""
        path = str(tmp_path / "scaled.acs")
        sc.encode_stream(
            codec, stereo_signal, path, chunk_blocks=8, threshold_scale=3.5
        )
        with sc.StreamReader(path) as r:
            assert r.meta["threshold_scale"] == 3.5
        streamed = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        frames = codec.mdct.transform(stereo_signal)
        codes, bark16 = codec.quantize_frames(frames, threshold_scale=3.5)
        mono = np.asarray(
            codec.decode_bitstream(codes, bark16, threshold_scale=3.5)
        )
        np.testing.assert_allclose(streamed, mono, atol=1e-5)

    @pytest.mark.skipif(
        not native.available(), reason="rate control packs via Rice"
    )
    def test_rate_controlled_stream(self, codec, tmp_path):
        rng = np.random.default_rng(1)
        t = np.arange(96 * 64) / 16000
        wave = np.stack(
            [
                0.4 * np.sin(2 * np.pi * 440 * t)
                + 0.1 * rng.normal(size=t.size),
                0.4 * np.sin(2 * np.pi * 660 * t)
                + 0.1 * rng.normal(size=t.size),
            ],
            axis=-1,
        ).astype(np.float32)
        x = jnp.asarray(np.clip(wave, -1, 1)[None])
        path = str(tmp_path / "rc.acs")
        # target chosen inside the achievable range for this tiny stream
        # (floor ~99 kbps: sidecar + 1-bit/value Rice minimum + framing)
        n_chunks, tscale, kbps = sc.encode_stream_with_target_bitrate(
            codec, x, path, chunk_blocks=8, target_kbps=150.0, ms=True,
        )
        assert n_chunks == 13
        assert tscale > 0
        # sampled-scale estimate on stationary content: within 15%
        assert abs(kbps - 150.0) <= 0.15 * 150.0
        # and it decodes
        out = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        assert out.shape[1] == (96 + 2) * 64  # blocks+1 framing, twice
        assert np.all(np.isfinite(out))

    def test_ms_needs_stereo(self, codec, signal, tmp_path):
        with pytest.raises(ValueError, match="stereo"):
            sc.encode_stream(
                codec, signal, str(tmp_path / "x.acs"), chunk_blocks=8,
                ms=True,
            )


class TestDensePrecisionStream:
    """dct_precision="default" codecs (dense one-GEMM MDCT) must seek
    correctly: the carry re-priming uses the RAW previous frame in dense
    mode, not its DCT (regression: double-DCT corrupted the overlap)."""

    @pytest.fixture(scope="class")
    def dense_codec(self):
        return Codec.create(
            16000, filters_n=64, bark_bands_n=16, dct_precision="default"
        )

    def test_round_trip(self, dense_codec, signal, tmp_path):
        path = str(tmp_path / "d.acs")
        sc.encode_stream(dense_codec, signal, path, chunk_blocks=8)
        out = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(dense_codec, path)],
            axis=1,
        )
        x = np.asarray(signal)
        rec = out[:, 64:-64]
        snr = 10 * np.log10(
            (x**2).sum() / max(((x - rec) ** 2).sum(), 1e-30)
        )
        assert snr > 10

    def test_seek_matches_full_decode(self, dense_codec, signal, tmp_path):
        path = str(tmp_path / "ds.acs")
        sc.encode_stream(dense_codec, signal, path, chunk_blocks=8)
        full = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(dense_codec, path)],
            axis=1,
        )
        partial = np.concatenate(
            [
                np.asarray(c)
                for c in sc.decode_stream(dense_codec, path, start_chunk=2)
            ],
            axis=1,
        )
        np.testing.assert_allclose(partial, full[:, 16 * 64 :], atol=1e-6)


class TestFEC:
    """Forward error correction: every chunk carries a coarse redundant
    copy of its predecessor (encode_stream fec=...), and conceal-mode
    decode rebuilds a lost chunk from it instead of extrapolating."""

    def _corrupt(self, path, chunk_i, delta=12):
        with sc.StreamReader(path) as r:
            off = r._index[chunk_i]
        with open(path, "r+b") as f:
            f.seek(off + delta)
            f.write(b"\xff\xff")

    def test_no_loss_decode_identical(self, codec, signal, tmp_path):
        """The fec member is pure redundancy: a clean fec stream decodes
        bit-identically to the same signal's plain stream."""
        plain = str(tmp_path / "p.acs")
        fec = str(tmp_path / "f.acs")
        sc.encode_stream(codec, signal, plain, chunk_blocks=8)
        sc.encode_stream(codec, signal, fec, chunk_blocks=8, fec=6.0)
        a = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, plain)], axis=1
        )
        b = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, fec)], axis=1
        )
        np.testing.assert_array_equal(a, b)
        with sc.StreamReader(fec) as r:
            assert r.meta["fec"]["scale"] == 6.0
            assert r.read_chunk(0).fec is None  # nothing precedes chunk 0
            assert r.read_chunk(1).fec is not None
            # the member parses back to the predecessor's coarse coding
            codes, bark, scale = sc.parse_fec_member(
                r.read_chunk(1).fec, r.meta
            )
            assert codes.shape == (8, 64, 1)
            assert bark.shape == (8, 16, 1)
            assert scale == pytest.approx(6.0)

    def test_fec_rebuilds_lost_chunk(self, codec, signal, tmp_path):
        """A CRC-failing chunk is rebuilt from its successor's redundant
        copy: much closer to the clean decode than concealment, and
        sample-exact outside the outage (+ one overlap frame)."""
        fec = str(tmp_path / "f.acs")
        plain = str(tmp_path / "p.acs")
        sc.encode_stream(codec, signal, fec, chunk_blocks=8, fec=4.0)
        sc.encode_stream(codec, signal, plain, chunk_blocks=8)
        clean = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, fec)], axis=1
        )
        self._corrupt(fec, 1)
        self._corrupt(plain, 1)
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, fec, conceal=True)], axis=1
        )
        con = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, plain, conceal=True)],
            axis=1,
        )
        assert out.shape == clean.shape
        n = 64
        lost = slice(8 * n, 16 * n)

        def span_snr(rec):
            e = clean[0, lost, 0] - rec[0, lost, 0]
            return 10 * np.log10(
                (clean[0, lost, 0] ** 2).sum() / max((e**2).sum(), 1e-30)
            )

        # real (coarse) spectral data beats spectral extrapolation by a
        # wide margin on this tonal signal
        assert span_snr(out) > span_snr(con) + 6.0
        assert span_snr(out) > 5.0
        # exact before the outage and after one overlap frame past it
        np.testing.assert_allclose(out[:, : 7 * n], clean[:, : 7 * n],
                                   atol=1e-6)
        np.testing.assert_allclose(out[:, 17 * n :], clean[:, 17 * n :],
                                   atol=1e-6)

    def test_consecutive_losses_fall_back(self, codec, signal, tmp_path):
        """Chunk k's redundancy rides chunk k+1 — when BOTH are lost,
        chunk k falls back to plain concealment and chunk k+1 is rebuilt
        from chunk k+2's copy. The decode completes at full length."""
        path = str(tmp_path / "f2.acs")
        sc.encode_stream(codec, signal, path, chunk_blocks=8, fec=4.0)
        clean = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        self._corrupt(path, 0)
        self._corrupt(path, 1)
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, conceal=True)], axis=1
        )
        assert out.shape == clean.shape
        assert np.isfinite(out).all()
        n = 64
        # chunk 2 onward (+ one overlap frame) is exact again
        np.testing.assert_allclose(out[:, 17 * n :], clean[:, 17 * n :],
                                   atol=1e-6)

    def test_garbage_fec_member_falls_back(self, codec, signal, tmp_path):
        """A fec member that fails its plausibility parse (version skew)
        downgrades to plain concealment instead of raising."""
        path = str(tmp_path / "g.acs")
        # hand-build a 2-chunk fec stream whose members are garbage (the
        # chunk CRC covers them, so they arrive "intact" but unparseable)
        enc = codec.encode_bitstream(signal[:, : 8 * 64])
        with sc.StreamWriter(
            path, sample_rate=16000, filters_n=64, bark_bands_n=16,
            alpha=codec.psycho.alpha, window_type=codec.mdct.window_type,
            channels=1, fec_scale=4.0,
            sidecar_grid=codec.sidecar_grid,
        ) as w:
            codes, bark = enc
            w.append(codes, bark, fec=b"")
            w.append(codes, bark, fec=b"\x07garbage-not-a-member")
        with sc.StreamReader(path) as r:
            assert r.n_chunks == 2
        self._corrupt(path, 0)
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, conceal=True)], axis=1
        )
        assert np.isfinite(out).all()

    def test_writer_contract(self, codec, signal, tmp_path):
        path = str(tmp_path / "w.acs")
        with pytest.raises(ValueError, match="fec_scale"):
            sc.StreamWriter(
                path, sample_rate=16000, filters_n=64, bark_bands_n=16,
                alpha=0.6, window_type="vorbis", channels=1,
                fec_scale=0.5,
            )
        enc = codec.encode_bitstream(signal[:, : 8 * 64])
        with sc.StreamWriter(
            path, sample_rate=16000, filters_n=64, bark_bands_n=16,
            alpha=0.6, window_type="vorbis", channels=1, fec_scale=4.0,
            sidecar_grid=codec.sidecar_grid,
        ) as w:
            with pytest.raises(ValueError, match="fec"):
                w.append(*enc)  # declared fec, none passed
            w.append(*enc, fec=b"")
        path2 = str(tmp_path / "w2.acs")
        with sc.StreamWriter(
            path2, sample_rate=16000, filters_n=64, bark_bands_n=16,
            alpha=0.6, window_type="vorbis", channels=1,
            sidecar_grid=codec.sidecar_grid,
        ) as w:
            with pytest.raises(ValueError, match="fec"):
                w.append(*enc, fec=b"")  # fec on an undeclared stream

    def test_fec_composes_with_feature_ladder(self, codec, stereo_signal,
                                              tmp_path):
        """fec + ms + tns + nf: the redundant copy is PLAIN-quantized, so
        it recovers a lost chunk of a full-ladder stream too."""
        path = str(tmp_path / "l.acs")
        sc.encode_stream(codec, stereo_signal, path, chunk_blocks=8,
                         ms=True, tns=True, nf=True, fec=4.0)
        clean = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, path)], axis=1
        )
        self._corrupt(path, 1)
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, path, conceal=True)], axis=1
        )
        assert out.shape == clean.shape
        n = 64
        lost = slice(8 * n, 16 * n)
        e = clean[0, lost] - out[0, lost]
        snr = 10 * np.log10(
            (clean[0, lost] ** 2).sum() / max((e**2).sum(), 1e-30)
        )
        assert snr > 3.0
        np.testing.assert_allclose(out[:, 17 * n :], clean[:, 17 * n :],
                                   atol=1e-6)


class TestDTX:
    """Discontinuous transmission: gated chunks become ~(9+4C)-byte
    silent records (magic ACS3); the decoder runs the STANDARD synthesis
    step on synthesized zero codes (carry/seek machinery untouched) and
    adds comfort noise at the recorded per-channel RMS."""

    SR, N, CB = 16000, 256, 8

    def _mixed_signal(self, channels=1, floor=5e-5):
        """4 tone chunks, 5 noise-floor chunks, 3 tone chunks."""
        cs = self.CB * self.N
        samples = 12 * cs
        t = np.arange(samples) / self.SR
        rng = np.random.default_rng(0)
        sig = np.zeros((samples, channels), np.float32)
        for ch in range(channels):
            sig[: 4 * cs, ch] = 0.4 * np.sin(
                2 * np.pi * (440 + 20 * ch) * t[: 4 * cs])
            sig[4 * cs: 9 * cs, ch] = floor * rng.standard_normal(5 * cs)
            sig[9 * cs:, ch] = 0.3 * np.sin(
                2 * np.pi * (660 + 20 * ch) * t[9 * cs:])
        return jnp.asarray(sig[None])

    @pytest.fixture(scope="class")
    def codec(self):
        return Codec.create(self.SR, filters_n=self.N, bark_bands_n=32)

    def test_round_trip_and_size(self, codec, tmp_path):
        x = self._mixed_signal()
        p0 = str(tmp_path / "plain.acs")
        p1 = str(tmp_path / "dtx.acs")
        sc.encode_stream(codec, x, p0, chunk_blocks=self.CB)
        sc.encode_stream(codec, x, p1, chunk_blocks=self.CB, dtx=-70.0)
        import os

        assert os.path.getsize(p1) < 0.7 * os.path.getsize(p0)
        with open(p1, "rb") as f:
            assert f.read(4) == b"ACS3"
        with open(p0, "rb") as f:
            assert f.read(4) != b"ACS3"  # non-DTX magic unchanged
        out = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, p1)], axis=1
        )
        cs = self.CB * self.N
        sig = np.asarray(x)[0, :, 0]
        # coded spans keep quality
        ref = sig[cs: 3 * cs]
        deg = out[0, cs + self.N: 3 * cs + self.N, 0]
        snr = 10 * np.log10((ref**2).sum() / ((ref - deg) ** 2).sum())
        assert snr > 20.0, snr
        # gated span decodes comfort noise at the recorded RMS
        mid = out[0, 5 * cs + self.N: 8 * cs + self.N, 0]
        rms = float(np.sqrt((mid**2).mean()))
        assert 2e-5 < rms < 1.5e-4, rms

    def test_digital_silence_decodes_to_silence(self, codec, tmp_path):
        cs = self.CB * self.N
        sig = np.zeros((1, 6 * cs, 1), np.float32)
        t = np.arange(2 * cs) / self.SR
        sig[0, :2 * cs, 0] = 0.4 * np.sin(2 * np.pi * 440 * t)
        p = str(tmp_path / "sil.acs")
        sc.encode_stream(codec, jnp.asarray(sig), p,
                         chunk_blocks=self.CB, dtx=-70.0)
        out = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, p)], axis=1
        )
        # level 0 on the wire -> EXACT zeros in the gated interior
        # (one chunk of hangover after the tone, plus its window tail)
        np.testing.assert_array_equal(out[:, 5 * cs:], 0.0)

    def test_hangover_keeps_post_speech_chunk(self, codec, tmp_path):
        x = self._mixed_signal()
        p = str(tmp_path / "h.acs")
        sc.encode_stream(codec, x, p, chunk_blocks=self.CB, dtx=-70.0)
        with sc.StreamReader(p) as r:
            silent = [
                r.read_chunk(i).silent is not None
                for i in range(r.n_chunks)
            ]
        # chunk 4 is the first below-gate chunk but follows active
        # content: the one-chunk hangover keeps it coded
        assert silent[:6] == [False] * 5 + [True]
        assert silent[9] is False  # tone resumes

    def test_seek_matches_full_decode(self, codec, tmp_path):
        x = self._mixed_signal()
        p = str(tmp_path / "s.acs")
        sc.encode_stream(codec, x, p, chunk_blocks=self.CB, dtx=-70.0)
        full = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, p)], axis=1
        )
        cs = self.CB * self.N
        for start in (6, 9):  # inside the gated span; at the tone resume
            part = np.concatenate(
                [np.asarray(c)
                 for c in sc.decode_stream(codec, p, start_chunk=start)],
                axis=1,
            )
            np.testing.assert_allclose(
                part, full[:, start * cs:], atol=1e-6
            )

    def test_stereo_ms_composes(self, tmp_path):
        codec = Codec.create(self.SR, filters_n=self.N, bark_bands_n=32)
        x = self._mixed_signal(channels=2)
        p = str(tmp_path / "ms.acs")
        sc.encode_stream(codec, x, p, chunk_blocks=self.CB, dtx=-70.0,
                         ms=True, tns=True, nf=True, bs=True)
        out = np.concatenate(
            [np.asarray(c) for c in sc.decode_stream(codec, p)], axis=1
        )
        assert np.isfinite(out).all()
        cs = self.CB * self.N
        sig = np.asarray(x)[0, cs: 3 * cs]
        deg = out[0, cs + self.N: 3 * cs + self.N]
        snr = 10 * np.log10(
            (sig**2).sum() / ((sig - deg) ** 2).sum()
        )
        assert snr > 15.0, snr

    def test_corrupt_silent_record_fails_crc_and_conceals(
        self, codec, tmp_path
    ):
        x = self._mixed_signal()
        p = str(tmp_path / "c.acs")
        sc.encode_stream(codec, x, p, chunk_blocks=self.CB, dtx=-70.0)
        with sc.StreamReader(p) as r:
            off = r._index[6]  # a silent record (see hangover test)
            assert r.read_chunk(6).silent is not None
        blob = bytearray(open(p, "rb").read())
        blob[off + 3] ^= 0xFF  # flip inside the record body
        open(p, "wb").write(bytes(blob))
        with sc.StreamReader(p) as r:
            with pytest.raises(ValueError, match="CRC|corrupt"):
                r.read_chunk(6)
        out = np.concatenate(
            [np.asarray(c)
             for c in sc.decode_stream(codec, p, conceal=True)], axis=1
        )
        assert np.isfinite(out).all()

    def test_validation(self, codec, tmp_path):
        x = self._mixed_signal()
        with pytest.raises(ValueError, match="fec or cbr"):
            sc.encode_stream(codec, x, str(tmp_path / "x.acs"),
                             chunk_blocks=self.CB, dtx=-70.0, fec=4.0)
        with pytest.raises(ValueError, match="fec or cbr"):
            sc.encode_stream(codec, x, str(tmp_path / "x.acs"),
                             chunk_blocks=self.CB, dtx=-70.0,
                             threshold_scale=[1.0] * 12)
        with pytest.raises(ValueError, match="dtx_level"):
            sc.StreamWriter(
                str(tmp_path / "y.acs"), sample_rate=self.SR,
                filters_n=self.N, bark_bands_n=32, alpha=0.6,
                window_type="vorbis", channels=1,
                compute_dtype="float32", dtx_level=5.0,
            )

    def test_tampered_silent_blocks_bounded(self, codec, tmp_path):
        """A tampered silent-record frame count must fail loudly BEFORE
        any allocation (the bounded-memory decode invariant): patch the
        u32 to a huge value and re-CRC so only the cap can catch it."""
        import struct
        import zlib

        x = self._mixed_signal()
        p = str(tmp_path / "t.acs")
        sc.encode_stream(codec, x, p, chunk_blocks=self.CB, dtx=-70.0)
        with sc.StreamReader(p) as r:
            off = r._index[6]
            assert r.read_chunk(6).silent is not None
        blob = bytearray(open(p, "rb").read())
        # silent record: marker | u32 blocks | f32 level | u32 crc
        huge = struct.pack("<I", 1 << 30)
        blob[off + 1:off + 5] = huge
        body = bytes(blob[off:off + 1 + 4 + 4])
        blob[off + 9:off + 13] = struct.pack(
            "<I", zlib.crc32(body)
        )
        open(p, "wb").write(bytes(blob))
        with sc.StreamReader(p) as r:
            with pytest.raises(ValueError, match="implausible|corrupt"):
                r.read_chunk(6)

    def test_append_silent_requires_dtx_stream(self, tmp_path):
        w = sc.StreamWriter(
            str(tmp_path / "z.acs"), sample_rate=self.SR,
            filters_n=self.N, bark_bands_n=32, alpha=0.6,
            window_type="vorbis", channels=1, compute_dtype="float32",
        )
        with pytest.raises(ValueError, match="dtx"):
            w.append_silent(8, [0.0])
        w.close()
