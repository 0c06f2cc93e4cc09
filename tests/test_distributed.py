"""Distributed (multi-device) tests on the virtual 8-device CPU mesh:
row-block partitioning, all-gather and halo exchange of x, distributed
solvers.
The new capability vs the single-device reference (SURVEY.md section 5,
BASELINE.json multi-host configs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu.models.solvers import conjugate_gradient
from benchmark_spmv_using_csr5_tpu.parallel.distributed import (
    distribute_csr,
    distributed_spmv,
    make_mesh,
)
from benchmark_spmv_using_csr5_tpu.utils import synth

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs the virtual multi-device mesh"
)


def _dist_err(a_sp, n_dev, sigma=-1):
    mesh = make_mesh(n_dev)
    da = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh, sigma=sigma
    )
    x = synth.dense_x(a_sp.shape[1], dtype=a_sp.dtype)
    y = np.asarray(jax.jit(lambda xx: distributed_spmv(da, xx, mesh))(jnp.asarray(x)))
    y_ref = a_sp @ x
    return np.abs(y - y_ref).max() / max(1e-30, np.abs(y_ref).max())


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_distributed_spmv_matches(n_dev):
    a_sp = synth.banded(1024, 9, dtype=np.float32)
    assert _dist_err(a_sp, n_dev) < 1e-5


def test_distributed_uneven_rows():
    # m not divisible by D: last shard is ragged, one shard nearly empty
    a_sp = synth.banded(1001, 7, dtype=np.float32)
    assert _dist_err(a_sp, 8) < 1e-5


def test_distributed_power_law():
    a_sp = synth.power_law(2000, 2000, 6.0, seed=3).astype(np.float32)
    assert _dist_err(a_sp, 4) < 1e-5


def test_distributed_empty_shard():
    # fewer rows than devices * 1: some shards have zero nonzeros
    a_sp = sp.csr_matrix(
        (np.ones(3, np.float32), ([0, 1, 2], [0, 1, 2])), shape=(9, 9)
    )
    assert _dist_err(a_sp, 8) < 1e-6


def test_distributed_pallas_backend():
    # the distributed result equals the single-device executor's exactly
    # on integer data (shards stack aligned window maps; one device keeps
    # the wrapped ones)
    from benchmark_spmv_using_csr5_tpu import build_csr5, csr5_spmv

    a_sp = synth.banded(1024, 9, dtype=np.float32)
    mesh = make_mesh(4)
    da = distribute_csr(a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh)
    assert not da.local.win_rel
    x = np.random.default_rng(0).integers(1, 10, 1024).astype(np.float32)
    y = np.asarray(jax.jit(lambda xx: distributed_spmv(da, xx, mesh))(jnp.asarray(x)))
    a5 = build_csr5((a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape))
    np.testing.assert_array_equal(y, np.asarray(csr5_spmv(a5, x)))
    np.testing.assert_array_equal(y, a_sp @ x)


def test_weak_scaling_harness():
    # correctness/plumbing of the weak-scaling sweep on the virtual mesh
    # (absolute times are meaningless on CPU; efficiencies just have to
    # be computed and finite)
    from benchmark_spmv_using_csr5_tpu.parallel import scaling

    pts = scaling.weak_scaling(
        device_counts=[1, 2], rows_per_device=2048, iters=3
    )
    assert [p.devices for p in pts] == [1, 2]
    assert all(np.isfinite(p.efficiency) and p.efficiency > 0 for p in pts)
    assert "weak-eff" in scaling.report(pts)


def test_distributed_cg():
    m = 256
    a_sp = synth.banded(m, 5, dtype=np.float32)
    a_sp = sp.csr_matrix((a_sp + a_sp.T) * 0.5 + sp.eye(m) * 50.0).astype(
        np.float32
    )
    mesh = make_mesh(4)
    da = distribute_csr(a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh)
    step = jax.jit(lambda xx: distributed_spmv(da, xx, mesh))
    b = jnp.ones((m,), jnp.float32)
    x, res = conjugate_gradient(step, b, iters=100)
    np.testing.assert_allclose(a_sp @ np.asarray(x), np.ones(m), atol=1e-3)


@pytest.mark.parametrize("n_dev,R", [(4, 8), (8, 16)])
def test_distributed_spmm_sharded_rhs(n_dev, R):
    from benchmark_spmv_using_csr5_tpu.parallel.distributed import distributed_spmm

    a_sp = synth.banded(1024, 9, dtype=np.float32)
    mesh = make_mesh(n_dev)
    da = distribute_csr(a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh)
    rng = np.random.default_rng(4)
    xm = rng.integers(1, 10, (a_sp.shape[1], R)).astype(np.float32)
    ym = np.asarray(
        jax.jit(lambda xx: distributed_spmm(da, xx, mesh))(jnp.asarray(xm))
    )
    y_ref = a_sp @ xm
    assert ym.shape == y_ref.shape
    np.testing.assert_allclose(
        ym, y_ref, atol=2e-5 * max(1.0, np.abs(y_ref).max())
    )


def test_distributed_spmm_ragged_rhs():
    from benchmark_spmv_using_csr5_tpu.parallel.distributed import distributed_spmm

    a_sp = synth.power_law(600, 600, 5.0, dtype=np.float32)
    mesh = make_mesh(4)
    da = distribute_csr(a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh)
    xm = synth.dense_x(600, dtype=np.float32)[:, None] * np.ones(
        (1, 6), np.float32
    )  # R=6 not divisible by 4 devices
    ym = np.asarray(distributed_spmm(da, jnp.asarray(xm), mesh))
    y_ref = a_sp @ xm
    np.testing.assert_allclose(
        ym, y_ref, atol=2e-5 * max(1.0, np.abs(y_ref).max())
    )


def test_halo_exchange_matches_allgather():
    """Banded matrix: halo='auto' builds column-window shards and two
    neighbor ppermutes replace the all-gather, with identical results and
    an x-bytes-exchanged reduction."""
    a_sp = sp.csr_matrix(synth.banded(4096, 9, dtype=np.float32))
    mesh = make_mesh(8)
    x = np.random.default_rng(0).integers(1, 10, 4096).astype(np.float32)
    da_full = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh
    )
    da_halo = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh, halo="auto"
    )
    assert da_halo.halo is not None
    h_l, h_r = da_halo.halo
    assert h_l <= 128 and h_r <= 128  # bandwidth 9 rounds to one lane-block
    # the observability counter: halos move far fewer x bytes per device
    assert (
        da_halo.x_bytes_exchanged() < da_full.x_bytes_exchanged() // 4
    )
    y_full = np.asarray(
        jax.jit(lambda xx: distributed_spmv(da_full, xx, mesh))(jnp.asarray(x))
    )
    y_halo = np.asarray(
        jax.jit(lambda xx: distributed_spmv(da_halo, xx, mesh))(jnp.asarray(x))
    )
    y_ref = a_sp @ x
    np.testing.assert_allclose(y_full, y_ref, rtol=1e-5)
    np.testing.assert_allclose(y_halo, y_ref, rtol=1e-5)


def test_halo_rejected_for_scattered():
    """Uniform-random columns: the halo would span the whole row of
    devices, so 'auto' must fall back to the all-gather form."""
    a_sp = synth.random_csr(1024, 1024, 0.02, dtype=np.float32)
    mesh = make_mesh(8)
    da = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh, halo="auto"
    )
    assert da.halo is None


def test_halo_rounding_cannot_exceed_neighbor_shard():
    """A needed halo of 905 columns (n_per=512 per device... ) — more
    precisely: a halo that fits n_per BEFORE 128-rounding but exceeds it
    after must be rejected, not produce negative neighbor slices."""
    # n=1024 over 8 devices -> n_per=128. A row in device 1's block
    # reading a column 100 left of its window needs hl=100 <= 128 (pre-
    # round OK) but rounds to 128 (still OK); craft hl=130 -> rounds 256
    # > 128 -> must fall back to all-gather.
    m = n = 1024
    diag = sp.eye(m, n, format="csr", dtype=np.float32)
    extra = sp.csr_matrix(
        (np.ones(1, np.float32), ([200], [200 - 130])), shape=(m, n)
    )
    a_sp = (diag + extra).tocsr()
    mesh = make_mesh(8)
    da = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh, halo="auto"
    )
    assert da.halo is None or (da.halo[0] <= 128 and da.halo[1] <= 128)
    x = np.random.default_rng(0).integers(1, 10, n).astype(np.float32)
    y = np.asarray(
        jax.jit(lambda xx: distributed_spmv(da, xx, mesh))(jnp.asarray(x))
    )
    np.testing.assert_allclose(y, a_sp @ x, rtol=1e-5)


def test_handle_reinput_replaces_matrix():
    """input_csr with device arrays after a numpy input must not convert
    the stale host copy of the first matrix."""
    from benchmark_spmv_using_csr5_tpu.models.handle import SpMVHandle

    a1 = sp.csr_matrix(synth.banded(600, 5, dtype=np.float32))
    a2 = sp.csr_matrix(synth.banded(600, 9, dtype=np.float32))
    h = SpMVHandle(600, 600)
    h.input_csr(a1.nnz, a1.indptr, a1.indices, a1.data).as_csr5()
    h.as_csr()
    h.input_csr(
        a2.nnz,
        jnp.asarray(a2.indptr, jnp.int32),
        jnp.asarray(a2.indices, jnp.int32),
        jnp.asarray(a2.data),
    ).as_csr5()
    x = np.random.default_rng(1).integers(1, 10, 600).astype(np.float32)
    h.set_x(x)
    y = np.asarray(h.spmv(1.0))
    np.testing.assert_allclose(y, a2 @ x, rtol=1e-5)


# ---------------------------------------------------------------------------
# device-side shard conversion (round 4): every device converts its own
# resident shard under one shard_map (ops/convert_device wiring)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("halo", ["none", "auto"])
def test_distribute_csr_device_convert(halo):
    a_sp = synth.banded(1024, 9, dtype=np.float32)
    mesh = make_mesh(4)
    da_h = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh, halo=halo
    )
    da_d = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh, halo=halo,
        convert="device",
    )
    assert (da_d.halo is None) == (da_h.halo is None)
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    y_h = np.asarray(
        jax.jit(lambda xx: distributed_spmv(da_h, xx, mesh))(jnp.asarray(x))
    )
    y_d = np.asarray(
        jax.jit(lambda xx: distributed_spmv(da_d, xx, mesh))(jnp.asarray(x))
    )
    np.testing.assert_array_equal(y_d, y_h)
    np.testing.assert_allclose(y_d, a_sp @ x, rtol=1e-5, atol=1e-5)


def test_distribute_csr_device_convert_uneven_and_empty():
    # 5 devices over 520 rows: ragged last shard + shards with uneven nnz
    a_sp = synth.banded(520, 7, dtype=np.float32)
    mesh = make_mesh(5)
    da_d = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh,
        convert="device",
    )
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    y_d = np.asarray(
        jax.jit(lambda xx: distributed_spmv(da_d, xx, mesh))(jnp.asarray(x))
    )
    np.testing.assert_allclose(y_d, a_sp @ x, rtol=1e-5, atol=1e-5)


def test_distribute_csr_device_convert_scattered_fallback_or_exact():
    # power-law columns: whatever path the uniform-statics gate takes,
    # the result must match the host-converted distribution
    a_sp = sp.csr_matrix(synth.power_law(800, 800, 6.0, dtype=np.float32))
    mesh = make_mesh(4)
    da_h = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh
    )
    da_d = distribute_csr(
        a_sp.indptr, a_sp.indices, a_sp.data, a_sp.shape, mesh,
        convert="device",
    )
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    y_h = np.asarray(
        jax.jit(lambda xx: distributed_spmv(da_h, xx, mesh))(jnp.asarray(x))
    )
    y_d = np.asarray(
        jax.jit(lambda xx: distributed_spmv(da_d, xx, mesh))(jnp.asarray(x))
    )
    np.testing.assert_allclose(y_d, y_h, rtol=1e-6, atol=1e-6)
