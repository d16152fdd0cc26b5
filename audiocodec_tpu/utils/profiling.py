"""Observability: profiler traces and stage timing.

The reference's only tracing hook is a single tf.name_scope
(psychoacoustic.py:138). Here every pipeline stage runs under
jax.named_scope (searchable in XLA/profiler dumps), and this module adds
the user-facing entry points: a trace context manager for the JAX profiler
and a stage timer.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a JAX profiler trace of the enclosed block.

    View with TensorBoard or xprof:  trace("/tmp/codec-trace")
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, iters: int = 10, **kwargs) -> float:
    """Best-of-`iters` wall seconds for fn(*args), each call ending in
    ``block_until_ready`` on its outputs (JAX dispatch is asynchronous;
    without the wait the time is the enqueue). The first call, which
    compiles, is not counted."""
    jax.block_until_ready(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - t0)
    return best
