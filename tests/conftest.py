"""Test configuration.

Default lane: run on CPU with 8 virtual devices so sharded paths are
exercised without several accelerators, and enable x64 so float64
compute-dtype paths (the reference's precompute precision) can be verified.
Run it with ``JAX_PLATFORMS=cpu python -m pytest tests/``.

Hardware lane (``pytest -m gpu``): keep the machine's GPU backend and run
the opt-in numerics tests in tests/test_gpu_hw.py — compiled GPU programs
against the CPU backend in the same process. Compiles go through the
persistent compilation cache (audiocodec_tpu/utils/compile_cache.py)."""

import os

# Must be set before the first jax backend initialization. Harmless for
# the hardware lane (it only affects the CPU platform).
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()


def _hardware_lane(config) -> bool:
    markexpr = config.getoption("-m") or ""
    return "gpu" in markexpr and "not gpu" not in markexpr


def pytest_configure(config):
    import jax

    if _hardware_lane(config):
        from audiocodec_tpu.utils import compile_cache

        compile_cache.enable()
    else:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
