"""Child process for the two-process jax.distributed smoke test.

Run as:  python tests/_multihost_child.py <process_id> <port>
Each process brings 4 virtual CPU devices (XLA_FLAGS set by the parent
test); the pair forms an 8-device global mesh. Exercises the non-no-op
branch of parallel.multihost.initialize.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    pid, port = int(sys.argv[1]), sys.argv[2]

    from audiocodec_tpu.parallel import multihost

    ok = multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert ok is True, "initialize must take the distributed branch"
    assert jax.process_count() == 2, jax.process_count()

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = multihost.global_mesh(sp=1)
    total = jax.device_count()
    assert mesh.shape == {"dp": total, "sp": 1}, mesh.shape
    assert multihost.process_local_batch(2 * total) == total

    # A real cross-process collective: a dp-sharded global array summed
    # under jit (GSPMD inserts the psum) must equal the single-process
    # result sum(range(total)) on BOTH processes.
    sharding = NamedSharding(mesh, PartitionSpec("dp"))
    global_shape = (total,)

    def local_data(index):
        (sl,) = index
        return np.arange(*sl.indices(total), dtype=np.float32)

    arr = jax.make_array_from_callback(global_shape, sharding, local_data)
    got = float(jax.jit(lambda a: a.sum())(arr))
    want = float(total * (total - 1) / 2)
    assert got == want, (got, want)
    print(f"MULTIHOST_OK {total}", flush=True)


if __name__ == "__main__":
    main()
