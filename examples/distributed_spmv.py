"""Row-sharded SpMV over a device mesh (halo vs all-gather exchange).

    python examples/distributed_spmv.py [m] [devices] [--cpu-mesh]

Uses the devices JAX finds (all of them unless ``devices`` is given);
``--cpu-mesh`` runs the same program on ``devices`` (default 8) virtual
CPU devices instead. The banded
matrix qualifies for the halo exchange (two neighbor ppermutes moving
O(bandwidth) x bytes); the printed counters show the traffic ratio vs
the all-gather form.
"""

import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    m = int(args[0]) if args else 65536
    ndev = int(args[1]) if len(args) > 1 else None

    import os

    import jax

    if "--cpu-mesh" in sys.argv:
        ndev = ndev or 8
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={ndev}"
        )
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import scipy.sparse as sp

    from benchmark_spmv_using_csr5_tpu.parallel.distributed import (
        distribute_csr,
        distributed_spmv,
        make_mesh,
    )
    from benchmark_spmv_using_csr5_tpu.utils import synth

    a = sp.csr_matrix(synth.banded(m, 11, dtype=np.float32))
    mesh = make_mesh(ndev)
    x = np.random.default_rng(0).integers(1, 10, m).astype(np.float32)

    da_full = distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh)
    da_halo = distribute_csr(
        a.indptr, a.indices, a.data, a.shape, mesh, halo="auto"
    )
    fn_full = jax.jit(lambda xx: distributed_spmv(da_full, xx, mesh))
    fn_halo = jax.jit(lambda xx: distributed_spmv(da_halo, xx, mesh))
    y_full = np.asarray(fn_full(jnp.asarray(x)))
    y_halo = np.asarray(fn_halo(jnp.asarray(x)))
    y_ref = a @ x
    print(f"mesh: {mesh}")
    print(
        f"all-gather exchange: {da_full.x_bytes_exchanged():,} B/device, "
        f"max rel err {np.abs(y_full - y_ref).max() / np.abs(y_ref).max():.2e}"
    )
    print(
        f"halo exchange {da_halo.halo}: "
        f"{da_halo.x_bytes_exchanged():,} B/device, "
        f"max rel err {np.abs(y_halo - y_ref).max() / np.abs(y_ref).max():.2e}"
    )


if __name__ == "__main__":
    main()
