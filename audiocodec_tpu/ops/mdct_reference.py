"""Plain float64 numpy reference of the MDCT, from its direct definition.

Independent of the device formulations in mdct.py (sparse fold + DCT-IV
matmul, or the dense one-GEMM form): each frame is a windowed 2N-sample
segment projected onto the MDCT cosine basis, and synthesis is the
windowed basis expansion with overlap-add. Tests and chip_smoke.py
compare the transform against it.

Conventions matched to mdct.MDCT (its blocks+1 framing and scaling):

  X[t, k] = 1/(sqrt(2) N) * sum_n w[n] x_t[n] cos(pi/N (n + 1/2 - N/2)(k + 1/2))
  y      += 2 sqrt(2)     * w[n] * sum_k X[t, k] cos(pi/N (n + 1/2 - N/2)(k + 1/2))

where x_t is samples [(t-1) N, (t+1) N) of the signal with N zeros on
each end, and w is the full 2N-sample analysis window (its last quarter
given by windows.window_completion). Synthesis with the same window is
the exact inverse only for windows that satisfy Princen-Bradley ("sine",
"vorbis").
"""

from __future__ import annotations

import numpy as np

from audiocodec_tpu.ops import windows as _windows


def full_window(filters_n: int, window_type) -> np.ndarray:
    """The 2N-sample analysis window, float64."""
    w = _windows.window_coefficients(filters_n, window_type)
    return np.concatenate([w, _windows.window_completion(w, filters_n)])


def basis(filters_n: int) -> np.ndarray:
    """[2N, N] MDCT cosine basis, float64."""
    n = np.arange(2 * filters_n, dtype=np.float64)[:, None]
    k = np.arange(filters_n, dtype=np.float64)[None, :]
    return np.cos(np.pi / filters_n * (n + 0.5 - filters_n / 2) * (k + 0.5))


def forward(x, filters_n: int, window_type="vorbis") -> np.ndarray:
    """[B, S, C] signal -> [B, S/N + 1, N, C] spectrum, float64."""
    x = np.asarray(x, dtype=np.float64)
    b, s, c = x.shape
    n = filters_n
    blocks = s // n
    xp = np.concatenate([np.zeros((b, n, c)), x, np.zeros((b, n, c))], 1)
    blk = xp.reshape(b, blocks + 2, n, c)
    # frame t is blocks t and t+1 of the padded signal: [B, T, 2N, C]
    seg = np.concatenate([blk[:, :-1], blk[:, 1:]], axis=2)
    seg = seg * full_window(n, window_type)[None, None, :, None]
    y = np.einsum("btnc,nk->btkc", seg, basis(n), optimize=True)
    return y / (np.sqrt(2.0) * n)


def inverse(y, filters_n: int, window_type="vorbis") -> np.ndarray:
    """[B, T, N, C] spectrum -> [B, (T + 1) N, C] signal, float64."""
    y = np.asarray(y, dtype=np.float64)
    b, t, n, c = y.shape
    seg = np.einsum("btkc,nk->btnc", y, basis(n), optimize=True)
    seg = seg * (2.0 * np.sqrt(2.0) * full_window(n, window_type))[
        None, None, :, None
    ]
    out = np.zeros((b, t + 1, n, c))
    out[:, :-1] += seg[:, :, :n]
    out[:, 1:] += seg[:, :, n:]
    return out.reshape(b, (t + 1) * n, c)


def int8_matmul(rows, mat) -> np.ndarray:
    """Host emulation of ops.dct._int8_matmul in float32 arithmetic: per
    row symmetric int8 quantization, one global int8 scale for ``mat``,
    an exact integer product, one float32 rescale."""
    f32 = np.float32
    u = np.asarray(rows, dtype=f32)
    m = np.asarray(mat, dtype=f32)
    s_r = np.max(np.abs(u), axis=-1, keepdims=True) + f32(1e-12)
    q = np.clip(np.round(u * (f32(127.0) / s_r)), -127, 127)
    s_m = np.max(np.abs(m)) + f32(1e-12)
    qm = np.clip(np.round(m * (f32(127.0) / s_m)), -127, 127)
    acc = q.astype(np.int64) @ qm.astype(np.int64)
    return acc.astype(f32) * (s_r * (s_m * f32(1.0 / (127.0 * 127.0))))


def int8_forward(x, mdct) -> np.ndarray:
    """Host emulation of ``mdct.transform`` at dct_precision="int8" (the
    dense form: one :func:`int8_matmul` of the blocks against both taps,
    then the shifted sum)."""
    x = np.asarray(x, dtype=np.float32)
    b, s, c = x.shape
    n = mdct.filters_n
    xb = np.transpose(x, (0, 2, 1)).reshape(b, c, s // n, n)
    z = int8_matmul(xb, mdct.dense_fwd)
    y = np.zeros((b, c, s // n + 1, n), np.float32)
    y[:, :, :-1] += z[..., :n]
    y[:, :, 1:] += z[..., n:]
    return np.transpose(y, (0, 2, 3, 1))
