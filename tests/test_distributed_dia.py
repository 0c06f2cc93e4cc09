"""Distributed DIA on the virtual 8-device CPU mesh: row-block sharded
diagonal matrices with neighbor-halo x exchange (the structured-format
counterpart of test_distributed.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu.parallel.distributed import make_mesh
from benchmark_spmv_using_csr5_tpu.parallel.distributed_dia import (
    distribute_dia,
    distributed_dia_spmm,
    distributed_dia_spmv,
)
from benchmark_spmv_using_csr5_tpu.utils import synth

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs the virtual multi-device mesh"
)


def _spmv_err(a_sp, n_dev, alpha=1.0):
    mesh = make_mesh(n_dev)
    dd = distribute_dia(a_sp.tocsr(), mesh)
    assert dd is not None
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    y = np.asarray(
        jax.jit(
            lambda xx: distributed_dia_spmv(dd, xx, mesh, alpha)
        )(jnp.asarray(x))
    )
    y_ref = alpha * (a_sp @ x)
    return dd, np.abs(y - y_ref).max() / max(1e-30, np.abs(y_ref).max())


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_distributed_dia_spmv_matches(n_dev):
    a_sp = synth.banded(1024, 9, dtype=np.float32)
    dd, err = _spmv_err(a_sp, n_dev)
    assert dd.halo is not None  # banded: neighbor halos, not all-gather
    assert err < 1e-5


def test_distributed_dia_uneven_rows_alpha():
    # m not divisible by D*128; alpha scaling
    a_sp = synth.banded(1000, 7, dtype=np.float32)
    dd, err = _spmv_err(a_sp, 8, alpha=2.5)
    assert err < 1e-5


def test_distributed_dia_tridiagonal_xla_backend():
    a_sp = synth.banded(2048, 3, dtype=np.float32)
    dd, err = _spmv_err(a_sp, 4)
    assert dd.halo == (128, 128)  # +-1 band rounds to one lane block
    assert err < 1e-5


def test_distributed_dia_rejects_scattered():
    a_sp = synth.random_csr(1024, 1024, 0.02, dtype=np.float32)
    mesh = make_mesh(4)
    assert distribute_dia(a_sp, mesh) is None


def test_distributed_dia_halo_traffic_counter():
    a_sp = synth.banded(4096, 9, dtype=np.float32)
    mesh = make_mesh(8)
    dd = distribute_dia(a_sp.tocsr(), mesh)
    # two 128-wide lane halos vs an all-gather of 7 shards
    assert dd.x_bytes_exchanged() == (128 + 128) * 4
    assert dd.x_bytes_exchanged() < 7 * dd.rows_per_shard * 4


def test_distributed_dia_wide_offsets_fall_back_to_gather():
    # a diagonal 16384+256 to the right: the halo would exceed the
    # neighbor shard (rp = 256 rows at this size), so halo must be None
    # and the all-gather path must still be exact
    m = 1024
    far = 16384 + 256
    n = m + far
    diags = sp.diags(
        [np.ones(m), np.ones(m)], [0, far], shape=(m, n), format="csr"
    ).astype(np.float32)
    mesh = make_mesh(4)
    dd = distribute_dia(diags, mesh)
    assert dd is not None and dd.halo is None
    x = synth.dense_x(n, dtype=np.float32)
    y = np.asarray(
        jax.jit(
            lambda xx: distributed_dia_spmv(dd, xx, mesh, 1.0)
        )(jnp.asarray(x))
    )
    y_ref = diags @ x
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5


@pytest.mark.parametrize("R", [4, 6])
def test_distributed_dia_spmm(R):
    a_sp = synth.banded(1024, 5, dtype=np.float32)
    mesh = make_mesh(4)
    dd = distribute_dia(a_sp.tocsr(), mesh)
    rng = np.random.default_rng(3)
    xm = rng.integers(1, 10, (1024, R)).astype(np.float32)
    ym = np.asarray(
        jax.jit(
            lambda xx: distributed_dia_spmm(dd, xx, mesh, 1.0)
        )(jnp.asarray(xm))
    )
    y_ref = a_sp @ xm
    np.testing.assert_allclose(
        ym, y_ref, atol=2e-5 * max(1.0, np.abs(y_ref).max())
    )
