"""MDCT against the independent float64 reference (ops/mdct_reference.py).

Both device formulations are checked: the sparse fold + one DCT-IV
matmul ("highest") and the dense one-GEMM form ("default"). The int8
tier is checked against a host emulation of the same arithmetic, and
both gradients against the reference through the adjoint identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from audiocodec_tpu.mdct import MDCT
from audiocodec_tpu.ops import mdct_reference as ref

PATHS = {"sparse": "highest", "dense": "default"}
SHAPES = [
    (1, 3, 1),  # a few frames
    (2, 7, 2),  # batch and stereo
    (1, 127, 1),  # odd frame count
    (1, 128, 1),  # power-of-two block count (129 frames)
    (2, 230, 2),  # long, batched, stereo
]


def _mdct(path, n=256, **kw):
    m = MDCT.create(n, dct_precision=PATHS[path], **kw)
    assert (m.dense_fwd is not None) == (path == "dense")
    return m


def _signal(shape, n, seed, dtype=jnp.float32):
    b, blocks, c = shape
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(-1, 1, (b, blocks * n, c)), dtype=dtype)


def _spectrum(b, blocks, n, c, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        rng.uniform(-0.5, 0.5, (b, blocks, n, c)), dtype=jnp.float32
    )


def _max_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)))


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_reference(path, shape):
    m = _mdct(path)
    x = _signal(shape, 256, shape[1])
    want = ref.forward(np.asarray(x), 256, "vorbis")
    assert m.transform(x).shape == want.shape
    # f32 products summed over 2N taps: ~1e-7 per output at O(1) values
    assert _max_err(m.transform(x), want) < 1e-5


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("blocks", [3, 127, 128, 230])
def test_inverse_matches_reference(path, blocks):
    m = _mdct(path)
    y = _spectrum(2, blocks, 256, 2, blocks)
    want = ref.inverse(np.asarray(y), 256, "vorbis")
    got = m.inverse_transform(y)
    assert got.shape == want.shape
    # outputs are O(sqrt(4N)) = O(32): f32 rounding there is ~4e-6
    assert _max_err(got, want) < 1e-4


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("n", [256, 512, 1024, 2048])
def test_block_sizes(path, n):
    m = _mdct(path, n)
    x = _signal((1, 3, 2), n, n)
    assert _max_err(m.transform(x), ref.forward(np.asarray(x), n)) < 1e-5
    y = _spectrum(1, 3, n, 2, n)
    scale = np.sqrt(4.0 * n)
    err = _max_err(m.inverse_transform(y), ref.inverse(np.asarray(y), n))
    assert err < 4e-6 * scale


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("window", ["sine", "vorbis", None, "rect"])
def test_every_window(path, window):
    m = _mdct(path, window_type=window)
    x = _signal((1, 6, 1), 256, 5)
    want = ref.forward(np.asarray(x), 256, window)
    assert _max_err(m.transform(x), want) < 1e-5
    if window in ("sine", "vorbis"):
        y = _spectrum(1, 6, 256, 1, 6)
        want_y = ref.inverse(np.asarray(y), 256, window)
        assert _max_err(m.inverse_transform(y), want_y) < 1e-4
    else:
        # the all-ones window is not Princen-Bradley: its synthesis is the
        # completion rule's exact inverse, checked on the reconstruction
        rt = m.inverse_transform(m.transform(x))[:, 256:-256]
        assert _max_err(rt, np.asarray(x, np.float64)) < 1e-5


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_bf16_fast(path, shape):
    m = _mdct(path, compute_dtype=jnp.bfloat16, fast_bf16=True)
    x = _signal(shape, 256, 7, dtype=jnp.bfloat16)
    want = ref.forward(np.asarray(x.astype(jnp.float32)), 256)
    got = m.transform(x)
    assert got.dtype == jnp.bfloat16
    # bf16 keeps 8 mantissa bits: matrix, operand and output rounding
    # each contribute ~2^-9 of the frame's scale
    assert _max_err(got.astype(jnp.float32), want) < 1e-2 * np.abs(want).max()
    y = m.transform(x)
    want_y = ref.inverse(np.asarray(y.astype(jnp.float32)), 256)
    got_y = m.inverse_transform(y).astype(jnp.float32)
    assert _max_err(got_y, want_y) < 1e-2 * np.abs(want_y).max()


@pytest.mark.parametrize(
    "n, shape", [(256, s) for s in SHAPES]
    + [(512, (1, 5, 1)), (1024, (2, 4, 2)), (2048, (1, 3, 1))],
)
def test_int8_matches_host_emulation(n, shape):
    m = MDCT.create(n, dct_precision="int8")
    x = _signal(shape, n, shape[1]) * 0.9
    want = ref.int8_forward(np.asarray(x), m)
    got = np.asarray(m.transform(x))
    # integer products are exact and the scales deterministic: only the
    # float32 rescale and the sum of the two halves may differ by ulps
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_adjoint_identity(path, n, direction):
    """<T x, y> == <x, T* y>: T from the float64 reference, T* from the
    device path's autodiff gradient (its VJP)."""
    m = _mdct(path, n)
    if direction == "forward":
        x = _signal((1, 4, 2), n, 1)
        ref_t, fn = ref.forward, m.transform
        y = np.random.default_rng(2).standard_normal((1, 5, n, 2))
    else:
        x = _spectrum(1, 4, n, 2, 1)
        ref_t, fn = ref.inverse, m.inverse_transform
        y = np.random.default_rng(2).standard_normal((1, 5 * n, 2))
    lhs = float(np.sum(ref_t(np.asarray(x), n) * y))
    _, vjp = jax.vjp(fn, x)
    (t_star_y,) = vjp(jnp.asarray(y, jnp.float32))
    rhs = float(np.sum(np.asarray(x, np.float64) * np.asarray(t_star_y)))
    norm = np.linalg.norm(np.asarray(x)) * np.linalg.norm(
        np.asarray(t_star_y)
    )
    assert abs(lhs - rhs) < 1e-5 * norm


@pytest.mark.parametrize(
    "kwargs, exc, match",
    [
        (dict(filters_n=255), ValueError, "even"),
        (dict(dct_precision="fastest"), ValueError, "dct_precision"),
        (dict(compute_dtype=jnp.float64, dct_precision="int8"),
         ValueError, "int8"),
        (dict(compute_dtype=jnp.float16), TypeError, "float16"),
        (dict(use_pallas=True), TypeError, "use_pallas"),
        (dict(pallas_kernel="mono"), TypeError, "pallas_kernel"),
    ],
)
def test_create_validation(kwargs, exc, match):
    with pytest.raises(exc, match=match):
        MDCT.create(**{"filters_n": 256, **kwargs})


@pytest.mark.parametrize(
    "call, exc, match",
    [
        (lambda m: m.transform(jnp.zeros((1, 512, 1), jnp.bfloat16)),
         TypeError, "transform input"),
        (lambda m: m.transform(jnp.zeros((1, 300, 1), jnp.float32)),
         ValueError, "multiple"),
        (lambda m: m.inverse_transform(jnp.zeros((1, 2, 128, 1),
                                                 jnp.float32)),
         ValueError, "filters_n"),
        (lambda m: m.inverse_transform(jnp.zeros((1, 0, 256, 1),
                                                 jnp.float32)),
         ValueError, "at least one"),
    ],
)
def test_call_validation(call, exc, match):
    with pytest.raises(exc, match=match):
        call(MDCT.create(256))
