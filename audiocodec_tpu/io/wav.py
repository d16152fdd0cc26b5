"""WAV read/write in the framework's tensor convention.

The reference has no audio I/O at all — its tests synthesize sines
in-memory (SURVEY.md §2.2). This gives the framework a real ingress/egress:
stdlib ``wave`` + numpy, supporting 16/24/32-bit integer PCM and 32-bit
float, mapped to the [-1, 1] [batches, samples, channels] convention.
"""

from __future__ import annotations

import wave

import numpy as np


def _parse_riff(buf: bytes):
    """Minimal RIFF/WAVE parser: (format_code, channels, rate, bits, data).

    Written by hand instead of stdlib ``wave`` because wave.open rejects
    IEEE-float files (format 3) and cannot distinguish 32-bit int PCM from
    float32 — both of which the native decoder supports and this fallback
    must match.
    """
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        clen = int.from_bytes(buf[pos + 4 : pos + 8], "little")
        body = buf[pos + 8 : pos + 8 + clen]
        if cid == b"fmt " and clen >= 16:
            code = int.from_bytes(body[0:2], "little")
            if code == 0xFFFE and clen >= 40:  # WAVE_FORMAT_EXTENSIBLE
                code = int.from_bytes(body[24:26], "little")
            fmt = (
                code,
                int.from_bytes(body[2:4], "little"),
                int.from_bytes(body[4:8], "little"),
                int.from_bytes(body[14:16], "little"),
            )
        elif cid == b"data":
            data = body
        pos += 8 + clen + (clen & 1)  # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError("malformed wav (missing fmt/data chunk)")
    return (*fmt, data)


def read_wav(path: str, dtype=np.float32):
    """Read a WAV file (PCM 16/24/32-bit or IEEE float32).

    :return: (data [1, samples, channels] in [-1, 1], sample_rate).
    """
    with open(path, "rb") as f:
        return read_wav_bytes(f.read(), dtype)


def read_wav_bytes(buf: bytes, dtype=np.float32):
    """:func:`read_wav` for an in-memory WAV blob (serving ingress)."""
    code, channels, rate, bits, frames = _parse_riff(buf)

    if code == 3 and bits == 32:
        x = np.frombuffer(frames, dtype="<f4").astype(np.float64)
    elif code == 1 and bits == 16:
        x = np.frombuffer(frames, dtype="<i2").astype(np.float64) / 32768.0
    elif code == 1 and bits == 32:
        x = np.frombuffer(frames, dtype="<i4").astype(np.float64) / 2147483648.0
    elif code == 1 and bits == 24:
        raw = np.frombuffer(frames, dtype=np.uint8)
        raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
        as32 = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
        x = as32.astype(np.float64) / float(1 << 23)
    else:
        raise ValueError(
            f"unsupported encoding: format code {code}, {bits}-bit "
            "(want PCM 16/24/32 or float32)"
        )

    x = x[: len(x) - len(x) % channels].reshape(-1, channels)
    return x[None, :, :].astype(dtype), rate


def read_wav_int(path: str):
    """Read integer PCM WAV without any float conversion.

    The lossless path (lossless.py) must see the EXACT stored sample
    values — the float ingress above divides by 32768/2^23 and would
    round-trip 16-bit PCM only by luck of the scale factor.

    :return: (data int32 [samples, channels], sample_rate, bits) with
        bits in {16, 24}. 32-bit int and float sources raise: their
        difference signals overflow the int32 residual pipeline (and
        float WAVs have no integer identity to preserve).
    """
    with open(path, "rb") as f:
        return read_wav_int_bytes(f.read())


def read_wav_int_bytes(buf: bytes):
    """:func:`read_wav_int` for an in-memory WAV blob."""
    code, channels, rate, bits, frames = _parse_riff(buf)
    if code == 3:
        raise ValueError(
            "lossless mode needs integer PCM input; this WAV is float32 "
            "(decode it with the lossy path, or convert to PCM first)"
        )
    if code != 1 or bits not in (16, 24):
        raise ValueError(
            f"lossless mode supports 16/24-bit integer PCM; this WAV is "
            f"format code {code}, {bits}-bit"
        )
    if bits == 16:
        x = np.frombuffer(frames, dtype="<i2").astype(np.int32)
    else:
        raw = np.frombuffer(frames, dtype=np.uint8)
        raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
        x = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x)
    x = x[: len(x) - len(x) % channels].reshape(-1, channels)
    if x.shape[0] == 0:
        raise ValueError("empty WAV data chunk")
    return x, rate, bits


def read_wav_i16_bytes(buf: bytes):
    """Raw PCM16 frames WITHOUT float conversion, or None if the WAV is
    not 16-bit integer PCM.

    Serving wire-format fast path (serve.py): shipping int16 to the
    device and dequantizing there halves H2D bytes; int16/32768 is exactly representable in float32, so the device
    dequant is bit-identical to the float ingress path.

    :return: (int16 [samples, channels], sample_rate) or None.
    """
    code, channels, rate, bits, frames = _parse_riff(buf)
    if code != 1 or bits != 16:
        return None
    x = np.frombuffer(frames, dtype="<i2")
    x = x[: len(x) - len(x) % channels].reshape(-1, channels)
    if x.shape[0] == 0:
        raise ValueError("empty WAV data chunk")
    return x, rate


def write_wav_int(path: str, data, sample_rate: int, bits: int) -> None:
    """Write int32 [samples, channels] as exact 16/24-bit integer PCM."""
    x = np.asarray(data, dtype=np.int32)
    if x.ndim != 2:
        raise ValueError(f"write_wav_int takes [samples, channels]; got {x.shape}")
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if x.min() < lo or x.max() > hi:
        raise ValueError(f"samples outside the {bits}-bit range")
    if bits == 16:
        pcm = x.astype("<i2").tobytes()
    elif bits == 24:
        u = (x.ravel() & 0xFFFFFF).astype(np.uint32)
        b = np.empty((u.size, 3), dtype=np.uint8)
        b[:, 0] = u & 0xFF
        b[:, 1] = (u >> 8) & 0xFF
        b[:, 2] = (u >> 16) & 0xFF
        pcm = b.tobytes()
    else:
        raise ValueError(f"unsupported bit depth: {bits}")
    with wave.open(path, "wb") as f:
        f.setnchannels(x.shape[1])
        f.setsampwidth(bits // 8)
        f.setframerate(sample_rate)
        f.writeframes(pcm)


def write_wav_bytes(data, sample_rate: int, width: int = 2) -> bytes:
    """:func:`write_wav` to an in-memory WAV blob (serving egress)."""
    import io

    buf = io.BytesIO()
    _write_wav_to(buf, data, sample_rate, width)
    return buf.getvalue()


def write_wav(path: str, data, sample_rate: int, width: int = 2) -> None:
    """Write [samples, channels] or [1, samples, channels] in [-1, 1]."""
    _write_wav_to(path, data, sample_rate, width)


def _write_wav_to(dest, data, sample_rate: int, width: int = 2) -> None:
    x = np.asarray(data, dtype=np.float64)
    if x.ndim == 3:
        if x.shape[0] != 1:
            raise ValueError(
                f"write_wav takes a single clip; got batch {x.shape[0]}"
            )
        x = x[0]
    if x.ndim == 1:
        x = x[:, None]
    x = np.clip(x, -1.0, 1.0)

    if width == 2:
        pcm = (x * 32767.0).round().astype("<i2").tobytes()
    elif width == 4:
        pcm = (x * 2147483647.0).round().astype("<i4").tobytes()
    else:
        raise ValueError(f"unsupported sample width: {width} bytes")

    with wave.open(dest, "wb") as f:
        f.setnchannels(x.shape[1])
        f.setsampwidth(width)
        f.setframerate(sample_rate)
        f.writeframes(pcm)
