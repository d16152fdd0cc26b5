"""Orthonormal DCT-IV as a dense matmul.

The reference implements DCT-IV via a zero-interleaved upsample fed to an
FFT-based DCT-III (audiocodec/mdctransformer.py:311-347). For the block
sizes a codec uses (N <= 4096), a direct [N, N] cosine matmul is one GEMM
on the tensor cores, fuses with the neighboring fold, and is more accurate
than an FFT decomposition.

DCT-IV:  y_k = sqrt(2/N) * sum_n x_n cos(pi/N (n+1/2)(k+1/2))

The transform matrix is symmetric and orthogonal, hence self-inverse —
the same matmul serves analysis and synthesis (reference notes the same
property, mdctransformer.py:319).

Precision policy (mirrors reference audiocodec/mdctransformer.py:326-344,
which upcasts bfloat16 to float32 around the DCT): for bfloat16 compute,
inputs are upcast to float32, the matmul runs in float32, and the result is
downcast — unless fast_bf16=True, which runs a bf16 matmul with float32
accumulation (preferred_element_type) for maximum throughput.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def dct4_matrix(filters_n: int) -> np.ndarray:
    """The [N, N] orthonormal DCT-IV matrix in float64 (host precompute)."""
    n = np.arange(filters_n, dtype=np.float64) + 0.5
    return np.sqrt(2.0 / filters_n) * np.cos(
        np.pi / filters_n * np.outer(n, n)
    )


# What each tier means for a float32 matmul (jax.lax.Precision): on an
# NVIDIA H100 "highest" is true float32 and "high" and "default" are BOTH
# TF32 (10-bit mantissa inputs, float32 accumulation), so the two lower
# tiers compute the same thing there; on the CPU all three are float32.
PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}

# The MDCT additionally accepts the "int8" mode (dynamic-range int8
# matmuls with int32 accumulation). The psychoacoustic Bark contractions
# do NOT accept it: bark_precision is recorded on the wire and its enum
# stays on the lax.Precision ladder.
MDCT_PRECISIONS = frozenset(PRECISIONS) | {"int8"}


def int8_rowquant(u: jnp.ndarray):
    """Symmetric per-row (last-axis) dynamic int8 quantization.

    scale = max|row| + 1e-12 (kept, divided out as s/127 on dequant),
    round-to-nearest, clip to ±127. Returns (int8 codes, f32 scale with
    keepdims)."""
    uf = u.astype(jnp.float32)
    s = jnp.max(jnp.abs(uf), axis=-1, keepdims=True) + jnp.float32(1e-12)
    q = jnp.clip(
        jnp.round(uf * (jnp.float32(127.0) / s)), -127.0, 127.0
    ).astype(jnp.int8)
    return q, s


def _int8_matmul(x: jnp.ndarray, mat: jnp.ndarray) -> jnp.ndarray:
    """x [..., K] @ mat [K, M] as an s8 x s8 -> s32 matmul, float32 out.

    The signal is dynamically requantized per row (per frame): scale =
    max|row|/127, symmetric round-to-nearest, int8. The matrix is
    quantized against one global scale — it is a loop-invariant pytree
    leaf, so XLA hoists its quantization out of scans and runs it once
    per program otherwise. Products accumulate in int32 (exact) and the
    two scales rescale the result in one fused epilogue.

    Error model: uniform ~ rowmax/(127*sqrt(12)) per output element —
    white across the frame, ~45 dB below a uniform-range signal.
    Intended for the QUANTIZED
    codec path, whose own noise floor sits far above that; fidelity
    paths keep the float ladder.
    """
    q, s_r = int8_rowquant(x)
    mf = mat.astype(jnp.float32)
    s_m = jnp.max(jnp.abs(mf)) + jnp.float32(1e-12)
    qm = jnp.clip(
        jnp.round(mf * (jnp.float32(127.0) / s_m)), -127.0, 127.0
    ).astype(jnp.int8)
    y32 = jax.lax.dot_general(
        q, qm,
        (((q.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return y32.astype(jnp.float32) * (
        s_r * (s_m * jnp.float32(1.0 / (127.0 * 127.0)))
    )


def dct4(
    x: jnp.ndarray,
    dct_mat: jnp.ndarray,
    *,
    fast_bf16: bool = False,
    precision: str = "highest",
) -> jnp.ndarray:
    """Apply DCT-IV along the last axis: x [..., N] @ dct_mat [N, N].

    ``dct_mat`` is expected in float32 (or float64 for a float64 pipeline).
    bfloat16 inputs are upcast to the matrix dtype around the matmul unless
    ``fast_bf16`` is set.

    float32 matmuls default to Precision.HIGHEST: an accelerator's default
    f32 matmul rounds its inputs (TF32 on an H100, ~3 decimal digits),
    which caps the round-trip SNR far below float32's. The ``precision`` knob
    trades that accuracy back for speed (see PRECISIONS).
    """
    if precision == "int8":
        return _int8_matmul(x, dct_mat).astype(x.dtype)
    prec = PRECISIONS[precision]
    if x.dtype == jnp.bfloat16:
        if fast_bf16:
            y = jnp.matmul(
                x,
                dct_mat.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
        else:
            y = jnp.matmul(x.astype(dct_mat.dtype), dct_mat, precision=prec)
        return y.astype(jnp.bfloat16)
    return jnp.matmul(
        x,
        dct_mat,
        precision=prec,
        preferred_element_type=x.dtype,
    )


def dense_gemm(
    x: jnp.ndarray,
    mat2: jnp.ndarray,
    *,
    fast_bf16: bool = False,
    precision: str = "highest",
) -> jnp.ndarray:
    """x [..., K] @ mat2 [K, 2M]: the dense MDCT's one GEMM against both
    taps ``[cur | prev]``, not yet rounded to x's dtype (float32 for
    float32 and bfloat16 inputs). Operand handling as in :func:`dct4`; at
    "int8" one global scale covers both taps."""
    if precision == "int8":
        return _int8_matmul(x, mat2)
    prec = PRECISIONS[precision]
    if x.dtype == jnp.bfloat16:
        if fast_bf16:
            return jnp.matmul(x, mat2.astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32)
        return jnp.matmul(x.astype(mat2.dtype), mat2, precision=prec)
    return jnp.matmul(x, mat2, precision=prec, preferred_element_type=x.dtype)


def two_tap(
    x: jnp.ndarray,
    mat2: jnp.ndarray,
    *,
    fast_bf16: bool = False,
    precision: str = "highest",
) -> jnp.ndarray:
    """[..., T, K] -> [..., T+1, M]: y[t] = x[t] @ cur + x[t-1] @ prev
    with ``mat2 = [cur | prev]`` and zero frames beyond both ends.

    One GEMM over the unpadded frames (:func:`dense_gemm`), then one
    shifted add that XLA fuses with the padding and the single rounding
    to x's dtype.
    """
    z = dense_gemm(x, mat2, fast_bf16=fast_bf16, precision=precision)
    m = z.shape[-1] // 2
    lead = [(0, 0)] * (z.ndim - 2)
    y = (jnp.pad(z[..., :m], lead + [(0, 1), (0, 0)])
         + jnp.pad(z[..., m:], lead + [(1, 0), (0, 0)]))
    return y.astype(x.dtype)
