"""Dense band-block SpMM (ops/bandmm.py) vs the scipy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu.ops.bandmm import (
    bandmm_spmm,
    bandmm_spmv,
    build_bandblock,
)
from benchmark_spmv_using_csr5_tpu.utils import synth


def _check_spmm(a, rhs, alpha=1.0, precision="highest", seed=0):
    # generous waste gate: these tests check correctness on small
    # matrices whose K/nnz ratio would fail the profitability gate.
    # precision="highest" requires the f32-stored plane (bf16 default)
    bb = build_bandblock(
        (a.indptr, a.indices, a.data, a.shape), max_bytes_ratio=100.0,
        value_dtype=np.float32 if precision == "highest" else None,
    )
    assert bb is not None
    rng = np.random.default_rng(seed)
    xm = rng.integers(1, 10, (a.shape[1], rhs)).astype(np.float32)
    y = np.asarray(bandmm_spmm(bb, xm, alpha=alpha, precision=precision))
    y_ref = alpha * (a @ xm)
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=0)
    return bb


def test_banded_exact_highest():
    a = sp.csr_matrix(synth.banded(4000, 27, dtype=np.float32))
    bb = _check_spmm(a, 8)
    assert bb.K == 384  # 128-aligned window + 128 rows + bw 27


def test_default_precision_exact_for_integer_values():
    # bf16 operands with f32 accumulation: exact while the operands are
    # integer-class (the benchmark value convention)
    a = sp.csr_matrix(synth.banded(3000, 9, dtype=np.float32))
    _check_spmm(a, 4, precision="bf16")


def test_alpha_and_ragged_tail():
    # m not a multiple of 128: the last block is ragged
    a = sp.csr_matrix(synth.banded(1000, 5, dtype=np.float32))
    _check_spmm(a, 3, alpha=2.5)


def test_empty_rows_and_spmv():
    a = sp.csr_matrix(synth.banded(2000, 7, dtype=np.float32)).tolil()
    a[100:300] = 0  # empty rows inside one block
    a = a.tocsr()
    bb = build_bandblock(
        (a.indptr, a.indices, a.data, a.shape), max_bytes_ratio=100.0,
        value_dtype=np.float32,
    )
    assert bb is not None
    x = np.random.default_rng(1).integers(1, 10, 2000).astype(np.float32)
    y = np.asarray(bandmm_spmv(bb, x, precision="highest"))
    np.testing.assert_allclose(y, a @ x, rtol=0, atol=0)


def test_columns_confined_below_right_edge():
    # nx_pad = c0.max()+K can be SMALLER than n when all nonzeros sit in
    # low columns; the x plane must truncate, not negative-pad (regression)
    m, n = 300, 10_000
    rows = np.arange(m)
    cols = rows % 50
    a = sp.csr_matrix(
        (np.arange(1, m + 1, dtype=np.float32), (rows, cols)), shape=(m, n)
    )
    bb = build_bandblock(
        (a.indptr, a.indices, a.data, a.shape), max_bytes_ratio=1000.0,
        value_dtype=np.float32,
    )
    assert bb is not None and bb.nx_pad < n
    rng = np.random.default_rng(4)
    xm = rng.integers(1, 10, (n, 2)).astype(np.float32)
    y = np.asarray(bandmm_spmm(bb, xm, precision="highest"))
    np.testing.assert_allclose(y, a @ xm, rtol=0, atol=0)


def test_rn_layout_matches_nr():
    a = sp.csr_matrix(synth.banded(3000, 27, dtype=np.float32))
    bb = build_bandblock(
        (a.indptr, a.indices, a.data, a.shape), max_bytes_ratio=100.0,
        value_dtype=np.float32,
    )
    rng = np.random.default_rng(3)
    xm = rng.integers(1, 10, (a.shape[1], 5)).astype(np.float32)
    y_nr = np.asarray(
        bandmm_spmm(bb, xm, precision="highest")
    )
    y_rn = np.asarray(
        bandmm_spmm(
            bb, np.ascontiguousarray(xm.T), precision="highest", layout="rn",
        )
    )
    np.testing.assert_array_equal(y_rn, y_nr.T)
    np.testing.assert_array_equal(y_nr, a @ xm)


def test_precision_gate_auto_dtype():
    # integer-class values round-trip bf16 -> auto storage is bf16;
    # decade-spread floats do not -> auto keeps f32 and precision="auto"
    # escalates to HIGHEST (exact products).
    import jax.numpy as jnp

    a = sp.csr_matrix(synth.banded(2000, 9, dtype=np.float32))
    bb_int = build_bandblock(
        (a.indptr, a.indices, a.data, a.shape), max_bytes_ratio=100.0
    )
    assert bb_int.dense.dtype == jnp.bfloat16

    rng = np.random.default_rng(7)
    a.data = (
        rng.uniform(0.1, 1.0, a.nnz) * 10.0 ** rng.integers(-1, 2, a.nnz)
    ).astype(np.float32)
    bb_f = build_bandblock(
        (a.indptr, a.indices, a.data, a.shape), max_bytes_ratio=100.0
    )
    assert bb_f.dense.dtype == jnp.float32
    xm = rng.uniform(0.5, 1.5, (a.shape[1], 3)).astype(np.float32)
    # precision="auto" on the f32 plane = HIGHEST: exact f32 products
    y = np.asarray(bandmm_spmm(bb_f, xm))
    y_ref = (a.astype(np.float64) @ xm.astype(np.float64)).astype(np.float32)
    rel = np.abs(y - y_ref) / np.maximum(np.abs(y_ref), 1e-30)
    assert rel.max() <= 1e-5
    # the forced-bf16 path stays within the documented ~2^-8 bound but
    # is measurably NOT exact on these values
    bb16 = build_bandblock(
        (a.indptr, a.indices, a.data, a.shape), max_bytes_ratio=100.0,
        value_dtype=jnp.bfloat16,
    )
    y16 = np.asarray(
        bandmm_spmm(bb16, xm, precision="bf16")
    )
    rel16 = np.abs(y16 - y_ref) / np.maximum(np.abs(y_ref), 1e-30)
    assert 1e-5 < rel16.max() <= 0.01


def test_scattered_rejects():
    a = sp.csr_matrix(
        synth.power_law(20_000, 20_000, 8.0, dtype=np.float32)
    )
    assert build_bandblock((a.indptr, a.indices, a.data, a.shape)) is None


def test_waste_gate_rejects_sparse_wide_band():
    # one nonzero per row but a 3000-wide window: dense bytes blow the
    # ratio gate even though K itself is small enough
    m = 20_000
    rows = np.arange(m)
    cols = (rows * 977) % 3000 + (rows // 128) * 128
    cols = np.minimum(cols, m - 1)
    a = sp.csr_matrix(
        (np.ones(m, np.float32), (rows, cols)), shape=(m, m)
    )
    assert build_bandblock((a.indptr, a.indices, a.data, a.shape)) is None


def test_rectangular():
    # m > n and windows clipped at the right edge
    a = sp.csr_matrix(synth.banded(1500, 11, dtype=np.float32))[:, :600]
    a = sp.csr_matrix(a)
    bb = build_bandblock(
        (a.indptr, a.indices, a.data, a.shape), max_bytes_ratio=100.0,
        value_dtype=np.float32,
    )
    if bb is None:
        pytest.skip("gate rejected the clipped band")
    rng = np.random.default_rng(2)
    xm = rng.integers(1, 10, (600, 2)).astype(np.float32)
    y = np.asarray(bandmm_spmm(bb, xm, precision="highest"))
    np.testing.assert_allclose(y, a @ xm, rtol=0, atol=0)


@pytest.mark.parametrize("R", [1, 8, 16])
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_batched_product_each_precision_and_width(precision, R):
    """The one batched dot_general: every block's window gather and
    product, at each precision and rhs width, exact on integer data."""
    a = sp.csr_matrix(synth.banded(1500, 27, dtype=np.float32))
    bb = _check_spmm(a, R, precision=precision, seed=R)
    assert bb.dense.dtype == (np.float32 if precision == "highest" else jnp.bfloat16)


def test_precision_names():
    import jax.numpy as jnp

    a = sp.csr_matrix(synth.banded(600, 5, dtype=np.float32))
    bb16 = build_bandblock((a.indptr, a.indices, a.data, a.shape), max_bytes_ratio=100.0)
    assert bb16.dense.dtype == jnp.bfloat16
    xm = np.ones((600, 2), np.float32)
    with pytest.raises(ValueError, match="f32 dense plane"):
        bandmm_spmm(bb16, xm, precision="highest")
    with pytest.raises(ValueError, match="precision must be"):
        bandmm_spmm(bb16, xm, precision="default")
