"""Device meshes and sharding layouts for the codec.

Two mesh axes cover every parallelism the workload has:

* ``dp`` (data / clip parallelism): the batch axis of a corpus. Embarrassingly
  parallel; no communication except metric reductions.
* ``sp`` (sequence parallelism): the samples/blocks axis of long-form audio.
  The MDCT's polyphase fold couples *adjacent* blocks only (a 2-tap kernel,
  SURVEY.md §5), so sharding the sequence axis needs exactly a one-block halo
  — GSPMD materializes it as a collective-permute between devices when the fold's
  shifted concatenation crosses a shard boundary.

There is no tensor dimension with enough arithmetic intensity to justify
TP of the [N, N] DCT matmul at codec sizes; replicating the (<=4 MB at
N=1024, f32) DCT matrix is the right call on any real mesh.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: int | None = None,
    dp: int | None = None,
    sp: int = 1,
    devices=None,
) -> Mesh:
    """Build a (dp, sp) mesh over the available devices.

    :param n_devices: total devices to use (default: all).
    :param dp: data-parallel extent (default: n_devices // sp).
    :param sp: sequence-parallel extent (default 1).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if dp is None:
        if n_devices % sp != 0:
            raise ValueError(f"n_devices={n_devices} not divisible by sp={sp}")
        dp = n_devices // sp
    if dp * sp != n_devices:
        raise ValueError(f"dp*sp={dp * sp} != n_devices={n_devices}")
    mesh_devices = np.asarray(devices).reshape(dp, sp)
    return Mesh(mesh_devices, axis_names=("dp", "sp"))


def waveform_sharding(mesh: Mesh) -> NamedSharding:
    """[batch, samples, channels]: batch over dp, samples over sp."""
    return NamedSharding(mesh, P("dp", "sp", None))


def spectrum_sharding(mesh: Mesh) -> NamedSharding:
    """[batch, blocks, bands, channels]: batch over dp, blocks over sp.

    Bands stay unsharded — the DCT matmul and Bark matmuls contract over
    them, and at codec sizes replicating beats an all-reduce every block.
    """
    return NamedSharding(mesh, P("dp", "sp", None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_batch_to(n: int, multiple: int) -> int:
    """Smallest batch size >= n divisible by ``multiple`` (for even dp)."""
    return int(math.ceil(n / multiple) * multiple)
