"""CSR5 executor tests in f32 (the precision the benchmark cells run).

Equivalence: the executor must match scipy (independent oracle) on every
edge case, all sigmas, every window anchoring and column-plane encoding,
and with alpha scaling -- the unit-level version of the reference's
end-to-end 1%% check (CSR5_cuda/main.cu:361-384), at f32 tolerance.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu import (
    CSR5Config,
    build_csr5,
    csr5_spmv,
    csr5_spmv_xla,
    csr_from_scipy,
)
from benchmark_spmv_using_csr5_tpu.utils import synth


def small_cfg(sigma=None, m=0, nnz=0):
    """A small tile-padding quantum keeps the padded tile count small."""
    from benchmark_spmv_using_csr5_tpu import compute_sigma

    return CSR5Config(sigma=sigma or compute_sigma(m, nnz), tiles_per_block=8)


def run_f32(a_sp, config=None, alpha=1.0):
    a_sp = a_sp.astype(np.float32)
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    if config is None:
        config = small_cfg(m=a_sp.shape[0], nnz=a_sp.nnz)
    a5 = build_csr5(csr_from_scipy(a_sp), config)
    y = np.asarray(csr5_spmv_xla(a5, x, alpha=alpha))
    y_ref = alpha * (a_sp.astype(np.float64) @ x.astype(np.float64))
    assert y.dtype == np.float32
    return y, y_ref


def _assert_close(y, y_ref, rtol=2e-5):
    np.testing.assert_allclose(y, y_ref, atol=rtol * max(1.0, np.abs(y_ref).max()))


def test_kernel_edge_cases(edge_matrix):
    name, a_sp = edge_matrix
    y, y_ref = run_f32(a_sp)
    _assert_close(y, y_ref)


@pytest.mark.parametrize("sigma", [8, 16, 24, 32])
def test_kernel_sigmas(sigma):
    a_sp = synth.power_law(700, 600, 8.0, seed=11)
    y, y_ref = run_f32(a_sp, small_cfg(sigma=sigma))
    _assert_close(y, y_ref)


def test_kernel_alpha():
    a_sp = synth.banded(300, 9)
    y, y_ref = run_f32(a_sp, alpha=-1.75)
    _assert_close(y, y_ref)


def test_kernel_row_spanning_many_tiles():
    # one row of 20000 nnz spans ~20 tiles: the scatter-add of every
    # tile's partial row sum replaces the calibrator's block-edge atomics
    # (csr5_spmv_cuda.h:335-381)
    a_sp = synth.single_dense_row(32, 30000, row_nnz=20000)
    y, y_ref = run_f32(a_sp)
    _assert_close(y, y_ref, rtol=1e-4)


def test_kernel_tier2_fori_gather():
    # scattered columns: long per-tile page lists (no contiguous pages)
    a_sp = synth.random_csr(1200, 30_000, 0.004, seed=13).astype(np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), small_cfg(sigma=8))
    assert not a5.pages_contig and a5.pmax > 16, a5.pmax
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    _assert_close(np.asarray(csr5_spmv_xla(a5, x)), a_sp @ x)


def test_kernel_bf16_values():
    # bf16-stored values (half the value plane), products in x's f32
    import jax.numpy as jnp

    a_sp = synth.banded(400, 9).astype(np.float32)
    a5 = build_csr5(
        csr_from_scipy(a_sp), small_cfg(sigma=8), value_dtype=jnp.bfloat16
    )
    assert a5.val_tiles.dtype == jnp.bfloat16
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    y = np.asarray(csr5_spmv_xla(a5, x))
    assert y.dtype == np.float32
    # bf16 has an 8-bit mantissa: ~0.4% relative per value
    _assert_close(y, a_sp @ x, rtol=1e-2)


def test_kernel_tier2_unpacked_wide():
    # > 512 distinct pages per tile: no packed column plane, raw int32
    # columns are read instead
    a_sp = synth.random_csr(64, 150_000, 0.00035, seed=7).astype(np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), small_cfg(sigma=16))
    assert a5.pmax > 512 and a5.col_packed is None
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    _assert_close(np.asarray(csr5_spmv_xla(a5, x)), a_sp @ x)


def test_kernel_packed_tier1():
    # sigma=16 keeps only the packed column plane; the executor decodes
    # local page indices identically to the raw plane
    a_sp = synth.scattered_band(5000, 6, 4000, dtype=np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), small_cfg(sigma=16))
    assert a5.col_packed is not None and a5.col_idx_tiles is None
    assert not a5.pages_contig
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    _assert_close(np.asarray(csr5_spmv_xla(a5, x)), a_sp @ x)


def test_effective_block_default_128():
    # the tile count pads to a multiple of tiles_per_block (128 by
    # default) on big matrices, while a one-tile matrix keeps one tile
    a = synth.banded(20000, 27, dtype=np.float32)
    a5 = build_csr5(csr_from_scipy(a))  # default config
    assert a5.config.tiles_per_block == 128
    assert a5.num_tiles % 128 == 0
    b = synth.banded(60, 3, dtype=np.float32)
    b5 = build_csr5(csr_from_scipy(b))
    assert b5.num_tiles == 1


def test_aligned_batched_pass2_b8():
    """Aligned and wrapped window maps give identical, exact results."""
    a = sp.csr_matrix(synth.banded(2000, 9, dtype=np.float32))
    csr = (a.indptr, a.indices, a.data, a.shape)
    x = np.random.default_rng(0).integers(1, 10, 2000).astype(np.float32)
    al = build_csr5(csr, CSR5Config(sigma=8, tiles_per_block=16), win_mode="aligned")
    assert not al.win_rel
    y = np.asarray(csr5_spmv(al, x))
    np.testing.assert_array_equal(y, a @ x)
    wr = build_csr5(csr, CSR5Config(sigma=8, tiles_per_block=16))
    assert wr.win_rel
    np.testing.assert_array_equal(np.asarray(csr5_spmv(wr, x)), y)


def test_index_arithmetic_stays_int32():
    """With x64 on (as in the tests and the bench process) the executor's
    index planes stay int32, so f32 cells trace the same program."""
    import jax

    a = sp.csr_matrix(synth.banded(500, 9, dtype=np.float32))
    a5 = build_csr5((a.indptr, a.indices, a.data, a.shape))
    x = np.ones(500, np.float32)
    import re

    jaxpr = str(jax.make_jaxpr(csr5_spmv_xla)(a5, x))
    # int64 scalar literals are fine; no int64 array may appear
    assert not re.search(r"i64\[\d", jaxpr), re.findall(r".*i64\[\d.*", jaxpr)[:3]
