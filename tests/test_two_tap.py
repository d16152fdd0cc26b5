"""The dense MDCT form (ops/dct.two_tap): one GEMM of the frames against
both fold taps ``[cur | prev]`` and one shifted add, against the same
formula in float64 numpy and against two separate products; its edges,
its gradient, and the MDCT's use of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiocodec_tpu.mdct import MDCT
from audiocodec_tpu.ops import dct
from audiocodec_tpu.ops import mdct_reference

SHAPES = [  # (rows, frames, K, N)
    (1, 3, 64, 128),
    (2, 7, 128, 128),
    (1, 127, 64, 256),
    (1, 128, 64, 128),
    (2, 230, 128, 128),
]
TIERS = {  # name -> (operand dtype, fast_bf16, precision)
    "f32": (jnp.float32, False, "default"),
    "bf16-fast": (jnp.bfloat16, True, "default"),
}


def _operands(r, t, k, n, dtype=jnp.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.uniform(-1, 1, (r, t, k)), dtype)
    mat2 = jnp.asarray(rng.uniform(-1, 1, (k, 2 * n)) / np.sqrt(k),
                       jnp.float32)
    return x, mat2


def _exact(x, mat2, dtype=jnp.float32):
    """float64 numpy of the formula, from the operands as the GEMM sees
    them (the matrix rounded to ``dtype``)."""
    x = np.asarray(x, np.float64)
    w = np.asarray(jnp.asarray(mat2, dtype), np.float64)
    n = w.shape[1] // 2
    r, t, _ = x.shape
    y = np.zeros((r, t + 1, n))
    y[:, :t] += x @ w[:, :n]
    y[:, 1:] += x @ w[:, n:]
    return y


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_float64(tier, shape):
    dtype, fast, prec = TIERS[tier]
    x, mat2 = _operands(*shape, dtype=dtype)
    got = dct.two_tap(x, mat2, fast_bf16=fast, precision=prec)
    assert got.dtype == dtype
    want = _exact(x, mat2, dtype)
    assert got.shape == want.shape
    # float32 output: accumulation roundoff; bf16: one rounding of the
    # float32 sum, half an ulp (2^-9 relative)
    rtol = 1e-6 if dtype == jnp.float32 else 2.0 ** -8
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_two_separate_products(shape):
    """The one-GEMM form equals zero-padded x @ cur plus x @ prev."""
    x, mat2 = _operands(*shape, seed=1)
    n = mat2.shape[1] // 2
    zero = jnp.zeros_like(x[:, :1])
    hi = jax.lax.Precision.HIGHEST
    two = (jnp.matmul(jnp.concatenate([x, zero], 1), mat2[:, :n],
                      precision=hi)
           + jnp.matmul(jnp.concatenate([zero, x], 1), mat2[:, n:],
                        precision=hi))
    got = dct.two_tap(x, mat2, precision="highest")
    np.testing.assert_allclose(np.asarray(got), np.asarray(two), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_edge_frames_take_one_tap(tier):
    """Frame 0 has no previous frame and frame T no current one: each is
    exactly one product, rounded once."""
    dtype, fast, prec = TIERS[tier]
    x, mat2 = _operands(2, 5, 64, 128, dtype=dtype, seed=2)
    y = dct.two_tap(x, mat2, fast_bf16=fast, precision=prec)
    z = dct.dense_gemm(x, mat2, fast_bf16=fast, precision=prec)
    np.testing.assert_array_equal(np.asarray(y[:, 0]),
                                  np.asarray(z[:, 0, :128].astype(dtype)))
    np.testing.assert_array_equal(np.asarray(y[:, -1]),
                                  np.asarray(z[:, -1, 128:].astype(dtype)))


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_gradient_adjoint_identity(tier):
    """<T x, g> == <x, T* g> with T* the autodiff VJP of two_tap."""
    dtype, fast, prec = TIERS[tier]
    x, mat2 = _operands(1, 6, 64, 128, dtype=jnp.float32, seed=3)
    mat2 = mat2.astype(dtype).astype(jnp.float32)
    g = np.random.default_rng(4).standard_normal((1, 7, 128))
    lhs = float(np.sum(_exact(x, mat2) * g))
    _, vjp = jax.vjp(lambda v: dct.two_tap(v, mat2, precision="highest"), x)
    (dx,) = vjp(jnp.asarray(g, jnp.float32))
    rhs = float(np.sum(np.asarray(x, np.float64) * np.asarray(dx)))
    assert abs(lhs - rhs) <= 1e-5 * np.sum(np.abs(g))
    # and the VJP runs at the tier's own dtype, finite
    xt = x.astype(dtype)
    _, vjp_t = jax.vjp(lambda v: dct.two_tap(v, mat2, fast_bf16=fast,
                                             precision=prec), xt)
    (dxt,) = vjp_t(jnp.asarray(g, dtype))
    assert dxt.dtype == dtype
    assert bool(jnp.all(jnp.isfinite(dxt.astype(jnp.float32))))


@pytest.mark.parametrize("window", ["vorbis", "sine"])
def test_mdct_bf16_dense_path_is_two_tap(window):
    """The bf16 one-pass MDCT is exactly two_tap over its blocks."""
    n = 256
    m = MDCT.create(n, window_type=window, compute_dtype=jnp.bfloat16,
                    fast_bf16=True, dct_precision="default")
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(-1, 1, (2, 6 * n, 2)), jnp.bfloat16)
    xb = jnp.transpose(x, (0, 2, 1)).reshape(4, 6, n)
    want = dct.two_tap(xb, m.dense_fwd, fast_bf16=True, precision="default")
    got = jnp.transpose(m.transform(x), (0, 3, 1, 2)).reshape(4, 7, n)
    np.testing.assert_array_equal(np.asarray(got).view(np.uint16),
                                  np.asarray(want).view(np.uint16))


@pytest.mark.parametrize("k, n", [(64, 128), (256, 256)])
def test_int8_gemm_matches_host_emulation(k, n):
    """At "int8" the one GEMM quantizes the frames per row and both taps
    under one scale (ops/mdct_reference.int8_matmul emulates it)."""
    x, mat2 = _operands(2, 9, k, n, seed=8)
    got = np.asarray(dct.dense_gemm(x, mat2, precision="int8"))
    want = mdct_reference.int8_matmul(np.asarray(x), np.asarray(mat2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_dense_matrix_layout():
    """dense_fwd/dense_inv are [N, 2N] = [cur | prev], None off the
    dense tiers."""
    m = MDCT.create(128, dct_precision="default")
    assert m.dense_fwd.shape == (128, 256) and m.dense_inv.shape == (128, 256)
    assert MDCT.create(128).dense_fwd is None
    assert MDCT.create(128, dct_precision="int8").dense_inv is not None
