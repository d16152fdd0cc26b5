"""Chunked streaming MDCT encode/decode with one-block carried state.

The reference processes long audio as one giant graph — memory grows
linearly and there is no chunking (SURVEY.md §5). But the polyphase fold
couples only *adjacent* blocks (2-tap kernel), so a streaming encoder needs
exactly one block of carried state per boundary. This module provides:

* a pure step/flush API (`mdct_stream_step` / `imdct_stream_step`), usable
  from a host loop for true real-time streaming — each step is one jitted
  program over a chunk; and
* `scan`-based whole-signal drivers (`stream_transform`,
  `stream_inverse_transform`, `streaming_round_trip`) for long-form
  offline encode (BASELINE config 5: 1 h stereo) at bounded memory.

Chunk-streamed output is bit-identical to the batch transform: the frames
are the same mathematical objects, just produced K blocks at a time. The
streaming steps follow the MDCT's formulation — sparse fold at
multi-pass precision, the dense one-GEMM form at dct_precision="default"
and "int8" — so bit-identity holds in both modes. By construction the
stream is also resumable: (carry block, block offset) is
the entire codec state at any chunk boundary — checkpoint those two and
re-enter anywhere (the framework's failure-recovery story; the reference
has none, SURVEY.md §5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from audiocodec_tpu.mdct import MDCT
from audiocodec_tpu.ops import dct as _dct
from audiocodec_tpu.utils import dtypes as _dtypes


# -- low-level fold pieces ---------------------------------------------------


def _to_next(mdct: MDCT, blocks):
    """Lower-half contribution a block makes to the *next* output frame."""
    h = mdct.filters_n // 2
    xl, xu = blocks[..., :h], blocks[..., h:]
    return jnp.flip(xl, axis=-1) * mdct.wa_r + xu * mdct.wb


def _to_cur(mdct: MDCT, blocks):
    """Upper-half contribution a block makes to its *own* output frame."""
    h = mdct.filters_n // 2
    xl, xu = blocks[..., :h], blocks[..., h:]
    return xl * mdct.wc - jnp.flip(xu, axis=-1) * mdct.ffr


def _out_cur(mdct: MDCT, z):
    """Synthesis contributions of frame z to its own output block."""
    h = mdct.filters_n // 2
    zl = z[..., :h]
    return jnp.concatenate(
        [jnp.flip(zl * mdct.p, axis=-1), zl * mdct.q], axis=-1
    )


def _out_prev(mdct: MDCT, z):
    """Synthesis contributions of frame z to the *next* output block."""
    h = mdct.filters_n // 2
    zu = z[..., h:]
    return jnp.concatenate(
        [zu * mdct.r, jnp.flip(zu, axis=-1) * mdct.s_r], axis=-1
    )


def _dense_frames(mdct: MDCT, ext, mat2, precision):
    """Dense mode over K+1 carried-in blocks [..., K+1, N] -> K frames:
    frame[j] = ext[j+1] @ cur + ext[j] @ prev, the batch form's GEMM and
    add (ops/dct.two_tap) without its edge padding."""
    z = _dct.dense_gemm(ext, mat2, fast_bf16=mdct.fast_bf16,
                        precision=precision)
    n = mdct.filters_n
    return (z[..., 1:, :n] + z[..., :-1, n:]).astype(ext.dtype)


def _dense_tail(mdct: MDCT, last, mat2, precision):
    """Dense mode's final frame: the last block's ``prev`` tap alone, from
    the same GEMM (so the int8 tier keeps the batch form's scale)."""
    z = _dct.dense_gemm(last, mat2, fast_bf16=mdct.fast_bf16,
                        precision=precision)
    return z[..., mdct.filters_n:].astype(last.dtype)


# -- streaming analysis ------------------------------------------------------


def mdct_stream_init(mdct: MDCT, batches_n: int, channels_n: int):
    """Zero carry: one time-domain block [B, C, N]."""
    return jnp.zeros(
        (batches_n, channels_n, mdct.filters_n), dtype=mdct.compute_dtype
    )


def mdct_stream_step(mdct: MDCT, carry, chunk):
    """Encode one chunk.

    :param carry: [B, C, N] — last block of the previous chunk.
    :param chunk: [B, K*N, C] waveform samples, K >= 1.
    :return: (new_carry, frames [B, K, N, C]) — the same K frames the batch
        transform would produce at this offset.
    """
    _dtypes.check_input_dtype(chunk, mdct.compute_dtype, "stream chunk")
    n = mdct.filters_n
    b, samples, c = chunk.shape
    if samples % n != 0:
        raise ValueError(f"chunk samples {samples} not a multiple of N={n}")
    k = samples // n
    xb = jnp.transpose(chunk, (0, 2, 1)).reshape(b, c, k, n)
    ext = jnp.concatenate([carry[:, :, None, :], xb], axis=2)  # [B,C,K+1,N]
    if mdct.dense_fwd is not None:
        # dense formulation — same numbers as the batch transform in this
        # mode (ops/dct.two_tap): y = cur @ A0 + prev @ A1, one GEMM
        frames = _dense_frames(mdct, ext, mdct.dense_fwd, mdct.dct_precision)
    else:
        folded = jnp.concatenate(
            [_to_next(mdct, ext[:, :, :-1]), _to_cur(mdct, ext[:, :, 1:])],
            axis=-1,
        )
        frames = _dct.dct4(folded, mdct.dct_mat_fwd,
                           fast_bf16=mdct.fast_bf16,
                           precision=mdct.dct_precision)
    return xb[:, :, -1], jnp.transpose(frames, (0, 2, 3, 1))


def mdct_stream_flush(mdct: MDCT, carry):
    """Final frame after the last chunk: the carried block's tail-out.

    :return: [B, 1, N, C] — matches the batch transform's last (+1) frame.
    """
    if mdct.dense_fwd is not None:
        frame = _dense_tail(mdct, carry[:, :, None, :], mdct.dense_fwd,
                            mdct.dct_precision)
        return jnp.transpose(frame, (0, 2, 3, 1))
    lower = _to_next(mdct, carry)  # [B, C, N/2]
    folded = jnp.concatenate([lower, jnp.zeros_like(lower)], axis=-1)
    frame = _dct.dct4(
        folded[:, :, None, :], mdct.dct_mat_fwd, fast_bf16=mdct.fast_bf16,
        precision=mdct.dct_precision,
    )
    return jnp.transpose(frame, (0, 2, 3, 1))


# -- streaming synthesis -----------------------------------------------------


def imdct_stream_init(mdct: MDCT, batches_n: int, channels_n: int):
    """Zero carry: one spectral frame (post-DCT) [B, C, N]."""
    return jnp.zeros(
        (batches_n, channels_n, mdct.filters_n), dtype=mdct.compute_dtype
    )


def imdct_stream_step(mdct: MDCT, carry, frames):
    """Decode one chunk of spectral frames.

    :param carry: [B, C, N] — DCT of the previous chunk's last frame.
    :param frames: [B, K, N, C] mdct amplitudes.
    :return: (new_carry, samples [B, K*N, C]).
    """
    _dtypes.check_input_dtype(frames, mdct.compute_dtype, "stream frames")
    n = mdct.filters_n
    b, k, _, c = frames.shape
    yb = jnp.transpose(frames, (0, 3, 1, 2))
    if mdct.dense_inv is not None:
        # dense mode: the carry is the previous chunk's last RAW spectral
        # frame (pre-matmul) instead of its DCT — the step/flush API is
        # carry-opaque, and zeros init works for both representations.
        ext = jnp.concatenate([carry[:, :, None, :], yb], axis=2)
        out = _dense_frames(mdct, ext, mdct.dense_inv, mdct.inv_precision)
        samples = jnp.transpose(out.reshape(b, c, k * n), (0, 2, 1))
        return yb[:, :, -1], samples
    z = _dct.dct4(yb, mdct.dct_mat_inv, fast_bf16=mdct.fast_bf16,
                  precision=mdct.inv_precision)
    ext = jnp.concatenate([carry[:, :, None, :], z], axis=2)  # [B,C,K+1,N]
    out = _out_cur(mdct, ext[:, :, 1:]) + _out_prev(mdct, ext[:, :, :-1])
    samples = jnp.transpose(out.reshape(b, c, k * n), (0, 2, 1))
    return z[:, :, -1], samples


def imdct_stream_flush(mdct: MDCT, carry):
    """Final N output samples after the last chunk: the carry's tail-out."""
    if mdct.dense_inv is not None:
        out = _dense_tail(mdct, carry, mdct.dense_inv, mdct.inv_precision)
        return jnp.transpose(out, (0, 2, 1))
    out = _out_prev(mdct, carry)  # [B, C, N]
    return jnp.transpose(out, (0, 2, 1))


# -- whole-signal scan drivers ----------------------------------------------


def stream_transform(mdct: MDCT, x, chunk_blocks: int):
    """Batch-equivalent transform via lax.scan over fixed-size chunks.

    :param x: [B, S, C] with S a multiple of chunk_blocks * N.
    :return: [B, blocks+1, N, C] — bit-identical to mdct.transform(x).
    """
    n = mdct.filters_n
    b, s, c = x.shape
    chunk = chunk_blocks * n
    if s % chunk != 0:
        raise ValueError(
            f"samples {s} must be a multiple of chunk_blocks*N={chunk}"
        )
    chunks = jnp.transpose(x, (0, 2, 1)).reshape(b, c, s // chunk, chunk)

    def body(carry, ck):  # ck: [B, C, chunk]
        chunk_bsc = jnp.transpose(ck, (0, 2, 1))
        carry, frames = mdct_stream_step(mdct, carry, chunk_bsc)
        return carry, frames

    carry0 = mdct_stream_init(mdct, b, c)
    carry, frames = jax.lax.scan(
        body, carry0, jnp.moveaxis(chunks, 2, 0)
    )  # frames: [n_chunks, B, K, N, C]
    frames = jnp.moveaxis(frames, 0, 1).reshape(b, -1, n, c)
    last = mdct_stream_flush(mdct, carry)
    return jnp.concatenate([frames, last], axis=1)


def stream_inverse_transform(mdct: MDCT, y, chunk_blocks: int):
    """Batch-equivalent inverse transform via lax.scan over chunks.

    :param y: [B, blocks, N, C] with blocks a multiple of chunk_blocks.
    :return: [B, (blocks+1)*N, C] — matches mdct.inverse_transform(y).
    """
    n = mdct.filters_n
    b, blocks, _, c = y.shape
    if blocks % chunk_blocks != 0:
        raise ValueError(
            f"blocks {blocks} must be a multiple of chunk_blocks="
            f"{chunk_blocks}"
        )
    grouped = y.reshape(b, blocks // chunk_blocks, chunk_blocks, n, c)

    def body(carry, frames):
        carry, samples = imdct_stream_step(mdct, carry, frames)
        return carry, samples

    carry0 = imdct_stream_init(mdct, b, c)
    carry, sample_chunks = jax.lax.scan(body, carry0, jnp.moveaxis(grouped, 1, 0))
    samples = jnp.moveaxis(sample_chunks, 0, 1).reshape(b, -1, c)
    tail = imdct_stream_flush(mdct, carry)
    return jnp.concatenate([samples, tail], axis=1)


def streaming_round_trip(codec, x, chunk_blocks: int, key=None, drown=0.0):
    """Long-form chunked encode/decode: per-chunk masking + quantization
    (or noise injection when a key is given) with carried fold state.

    Bounded memory: peak live state is one chunk + two carry blocks,
    regardless of signal length. [B, S, C] -> [B, S + 2N, C].
    """
    mdct = codec.mdct
    n = mdct.filters_n
    b, s, c = x.shape
    chunk = chunk_blocks * n
    if s % chunk != 0:
        raise ValueError(
            f"samples {s} must be a multiple of chunk_blocks*N={chunk}"
        )
    chunks = jnp.transpose(x, (0, 2, 1)).reshape(b, c, s // chunk, chunk)
    use_noise = key is not None
    n_chunks = s // chunk
    if use_noise:
        all_keys = jax.random.split(key, n_chunks + 1)
        keys, flush_key = all_keys[:-1], all_keys[-1]
    else:
        keys = jnp.zeros((n_chunks,), dtype=jnp.uint32)
        flush_key = keys[0]

    def lossy(frames, k):
        tonality = codec.psycho.tonality(frames)
        threshold = codec.psycho.global_masking_threshold(
            frames, tonality, drown
        )
        if use_noise:
            return codec.psycho.add_noise(k, frames, threshold)
        from audiocodec_tpu import quantize as _quantize

        codes, delta = _quantize.quantize(frames, threshold)
        return _quantize.dequantize(codes, delta, dtype=mdct.compute_dtype)

    def body(carry, ck_key):
        ck, k = ck_key
        enc_carry, dec_carry = carry
        chunk_bsc = jnp.transpose(ck, (0, 2, 1))
        enc_carry, frames = mdct_stream_step(mdct, enc_carry, chunk_bsc)
        frames = lossy(frames, k)
        dec_carry, samples = imdct_stream_step(mdct, dec_carry, frames)
        return (enc_carry, dec_carry), samples

    carry0 = (
        mdct_stream_init(mdct, b, c),
        imdct_stream_init(mdct, b, c),
    )
    (enc_carry, dec_carry), sample_chunks = jax.lax.scan(
        body, carry0, (jnp.moveaxis(chunks, 2, 0), keys)
    )
    body_samples = jnp.moveaxis(sample_chunks, 0, 1).reshape(b, -1, c)

    # flush: final encoder frame, lossy-process it, decode it, then the
    # decoder's own tail
    last_frame = mdct_stream_flush(mdct, enc_carry)
    last_frame = lossy(last_frame, flush_key)
    dec_carry, last_samples = imdct_stream_step(mdct, dec_carry, last_frame)
    tail = imdct_stream_flush(mdct, dec_carry)
    return jnp.concatenate([body_samples, last_samples, tail], axis=1)
