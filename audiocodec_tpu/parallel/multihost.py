"""Multi-host (multi-process) initialization and mesh construction.

Single-host multi-chip needs nothing special — parallel.mesh.make_mesh over
jax.devices(). For several hosts (or one process per GPU), JAX's
distributed runtime must be initialized once per process before any
device access; afterwards jax.devices() is the GLOBAL device list and the
same GSPMD programs in this package run unchanged — XLA chooses the
collectives (NCCL on GPUs).

This module is a thin, testable wrapper: on a single host it is a no-op,
so the same launcher script works everywhere.

    from audiocodec_tpu.parallel import multihost
    multihost.initialize()               # no-op on single host
    mesh = multihost.global_mesh(sp=1)   # dp spans every device

The codec's collectives are tiny (a one-block ppermute halo for sp, psum
for metrics/gradients), so cross-host placement of the sp axis is avoided
by default: global_mesh puts sp within hosts and dp across them.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               auto: bool = False):
    """Initialize jax.distributed when running multi-process.

    Explicit arguments (or JAX_NUM_PROCESSES > 1) trigger initialization.
    Under a cluster launcher that JAX can autodetect (e.g. SLURM), opt
    in to argument-free initialization with ``auto=True``; otherwise
    pass ``coordinator_address`` / ``num_processes`` / ``process_id``:

        multihost.initialize(auto=True)   # launcher autodetection
        multihost.initialize()            # single host: clean no-op

    Returns True when jax.distributed was initialized.
    """
    world = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if world <= 1 and coordinator_address is None and not auto:
        return False
    if auto and coordinator_address is None and num_processes is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return True


def global_mesh(sp: int = 1) -> Mesh:
    """A (dp, sp) mesh over ALL devices in the job (all hosts).

    The sp axis is laid out within a host's devices (contiguous in the
    global device enumeration, so its halo collective stays within a
    host); dp spans the rest, crossing hosts only for gradient psums.
    """
    devices = np.asarray(jax.devices())
    if devices.size % sp != 0:
        raise ValueError(
            f"total devices {devices.size} not divisible by sp={sp}"
        )
    return Mesh(devices.reshape(devices.size // sp, sp), ("dp", "sp"))


def process_local_batch(global_batch: int) -> int:
    """Per-process share of a global batch (for building host-local data)."""
    n = jax.process_count()
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}"
        )
    return global_batch // n
