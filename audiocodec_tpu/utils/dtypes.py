"""Dtype policy for the audio codec.

Mirrors the reference's precompute-in-float64-then-downcast discipline
(reference: audiocodec/mdctransformer.py:31-35) and its compute-dtype
whitelist with float16 explicitly banned for insufficient exponent range
(reference: audiocodec/psychoacoustic.py:31-33,42-43).

All precomputation in this framework happens in *numpy* float64 on the host,
which is unaffected by JAX's x64 flag; results are downcast to the compute
dtype exactly once, at model construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Compute dtypes the framework accepts. float16 is deliberately excluded:
# its 5-bit exponent cannot represent the 1e-14 intensity floor used by the
# psychoacoustic model (bfloat16's 8-bit exponent can).
ALLOWED_COMPUTE_DTYPES = (jnp.float64, jnp.float32, jnp.bfloat16)


def canonicalize_compute_dtype(compute_dtype) -> jnp.dtype:
    """Validate and canonicalize a compute dtype.

    :raises TypeError: if the dtype is not float64/float32/bfloat16
        (same contract as reference audiocodec/psychoacoustic.py:42-43).
    :raises RuntimeError: if float64 is requested but jax x64 is disabled.
    """
    dtype = jnp.dtype(compute_dtype)
    if dtype not in [jnp.dtype(d) for d in ALLOWED_COMPUTE_DTYPES]:
        raise TypeError(
            "compute_dtype must be float64, float32 or bfloat16, got "
            f"{dtype}. (float16 lacks the exponent range for the intensity "
            "floor of 1e-14 used by the psychoacoustic model.)"
        )
    if dtype == jnp.dtype(jnp.float64) and not jax.config.jax_enable_x64:
        raise RuntimeError(
            "compute_dtype=float64 requires jax x64 mode. Enable it with "
            "jax.config.update('jax_enable_x64', True) before constructing "
            "the model."
        )
    return dtype


def check_input_dtype(x: jax.Array, compute_dtype, what: str = "input") -> None:
    """Enforce the no-implicit-casting contract of the reference API.

    Inputs must already be of the compute dtype
    (reference: audiocodec/mdctransformer.py:23, psychoacoustic.py:30).
    """
    if x.dtype != jnp.dtype(compute_dtype):
        raise TypeError(
            f"{what} must be of compute_dtype {jnp.dtype(compute_dtype)}, "
            f"got {x.dtype}; this framework never casts implicitly."
        )


def scalar(value: float, dtype) -> np.ndarray:
    """A 0-d numpy constant in the given dtype (host-side, trace-friendly)."""
    return np.asarray(value, dtype=jnp.dtype(dtype))


def sidecar_work_dtype(spec: jax.Array):
    """Work dtype for sidecar-steering math (nf/bwe/intensity gain
    analysis): f32 — it only picks a uint8 wire value — except f64
    pipelines stay f64 so the x64 test configuration never narrows.
    ONE definition: the three coded-path modules must agree, or their
    encoder-side gains diverge between features."""
    return jnp.float64 if spec.dtype == jnp.float64 else jnp.float32
