"""DIA (diagonal) format tests: conversion, gating, kernel vs scipy.

The DIA path is the framework's structured-matrix format expansion
(the reference declares but never implements a second format,
ANONYMOUSLIB_FORMAT_HYB5, CSR5_cuda/detail/common.h:21).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu import build_dia, dia_spmv
from benchmark_spmv_using_csr5_tpu.utils import synth


def _host(a_sp):
    a = sp.csr_matrix(a_sp)
    return (a.indptr, a.indices, a.data, a.shape)


def test_dia_build_matches_scipy_dia():
    a = sp.csr_matrix(synth.banded(700, 9, dtype=np.float32))
    d = build_dia(_host(a))
    assert d is not None
    ad = a.todia()
    assert sorted(d.offsets) == sorted(int(o) for o in ad.offsets)
    # data[k, i] = A[i, i+off] (scipy stores data[k, j] = A[j-off, j]);
    # _data_diag gives the (ndiag, m_pad) view of either storage layout
    from benchmark_spmv_using_csr5_tpu.ops.dia import _data_diag

    dense = a.toarray()
    data = np.asarray(_data_diag(d))
    for k, off in enumerate(d.offsets):
        for i in range(a.shape[0]):
            j = i + off
            expect = dense[i, j] if 0 <= j < a.shape[1] else 0.0
            assert data[k, i] == expect, (k, off, i)


@pytest.mark.parametrize("diags,alpha", [(3, 1.0), (27, -1.75)])
def test_dia_spmv_vs_scipy(diags, alpha):
    a = sp.csr_matrix(synth.banded(5000, diags, dtype=np.float32))
    d = build_dia(_host(a))
    assert d is not None
    x = synth.dense_x(a.shape[1], dtype=np.float32)
    y = np.asarray(dia_spmv(d, x, alpha=alpha))
    y_ref = alpha * (a @ x)
    np.testing.assert_allclose(
        y, y_ref, atol=2e-5 * max(1.0, np.abs(y_ref).max())
    )


def test_dia_duplicate_entries_summed():
    # repeated (row, col) coordinates sum, like the CSR oracle
    rows = np.array([0, 0, 1, 2])
    cols = np.array([1, 1, 2, 3])
    vals = np.array([1.0, 2.0, 5.0, 7.0], np.float32)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(4, 4))
    acsr = a.tocsr()  # scipy sums on conversion
    # build from the raw duplicate COO->CSR (keep duplicates)
    ptr = np.array([0, 2, 3, 4, 4])
    d = build_dia((ptr, cols, vals, (4, 4)))
    assert d is not None
    x = np.arange(1, 5, dtype=np.float32)
    y = np.asarray(dia_spmv(d, x))
    np.testing.assert_allclose(y, acsr @ x, atol=1e-6)


def test_dia_gates_unstructured():
    r = sp.random(500, 500, 0.01, format="csr", dtype=np.float32, random_state=3)
    assert build_dia((r.indptr, r.indices, r.data, r.shape)) is None
    # empty matrix
    e = sp.csr_matrix((4, 4), dtype=np.float32)
    assert build_dia((e.indptr, e.indices, e.data, e.shape)) is None


def test_dia_rectangular():
    a = sp.diags(
        [np.ones(300, np.float32)], [40], shape=(300, 400), format="csr"
    )
    d = build_dia((a.indptr, a.indices, a.data, a.shape))
    assert d is not None
    x = synth.dense_x(400, dtype=np.float32)
    y = np.asarray(dia_spmv(d, x))
    np.testing.assert_allclose(y, a @ x, atol=1e-5)


def test_dia_spmm_vs_scipy():
    from benchmark_spmv_using_csr5_tpu.ops.dia import dia_spmm

    a = sp.csr_matrix(synth.banded(3000, 9, dtype=np.float32))
    d = build_dia(_host(a))
    xm = np.random.default_rng(5).integers(1, 10, (a.shape[1], 4)).astype(
        np.float32
    )
    ym = np.asarray(dia_spmm(d, xm, alpha=0.5))
    y_ref = 0.5 * (a @ xm)
    np.testing.assert_allclose(
        ym, y_ref, atol=2e-5 * max(1.0, np.abs(y_ref).max())
    )


@pytest.mark.parametrize("layout", ["diag", "interleaved"])
def test_dia_layouts_match_oracle(layout):
    from benchmark_spmv_using_csr5_tpu.ops.dia import build_dia, dia_spmm, dia_spmv

    a = sp.csr_matrix(synth.banded(3000, 7, dtype=np.float32))
    d = build_dia((a.indptr, a.indices, a.data, a.shape), layout=layout)
    assert d is not None and d.interleaved == (layout == "interleaved")
    rng = np.random.default_rng(0)
    x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
    xm = rng.integers(1, 10, (a.shape[1], 3)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(dia_spmv(d, jnp.asarray(x))), a @ x)
    np.testing.assert_array_equal(np.asarray(dia_spmm(d, jnp.asarray(xm))), a @ xm)


def test_dia_far_offset_whole_x_path():
    """An offset far beyond the band (right of the 128-row padding)."""
    off = 16384 + 256
    m, n = 600, off + 1000
    a = sp.diags(
        [np.ones(m, np.float32), np.ones(m, np.float32)],
        [0, off],
        shape=(m, n),
        format="csr",
    )
    d = build_dia((a.indptr, a.indices, a.data, a.shape))
    assert d is not None and d.offsets == (0, off)
    x = synth.dense_x(n, dtype=np.float32)
    y = np.asarray(dia_spmv(d, x))
    np.testing.assert_allclose(y, a @ x, atol=1e-5)


@pytest.mark.parametrize("spmm", [False, True])
def test_dia_bf16_plane_exact_on_integers(spmm):
    """value_dtype="auto" stores integer-valued diagonals in bf16; products
    and sums must still run in x's f32 (a bf16 accumulator would round
    these ~3000-magnitude sums to 8 mantissa bits)."""
    from benchmark_spmv_using_csr5_tpu.ops.dia import dia_spmm

    a = sp.csr_matrix(synth.banded(4000, 27, dtype=np.float32)) * 16.0
    d = build_dia(_host(a), value_dtype="auto")
    assert d.data.dtype == jnp.bfloat16
    rng = np.random.default_rng(2)
    if spmm:
        xm = rng.integers(1, 10, (a.shape[1], 3)).astype(np.float32)
        y = np.asarray(dia_spmm(d, jnp.asarray(xm)))
        ref = a @ xm
    else:
        x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
        y = np.asarray(dia_spmv(d, jnp.asarray(x)))
        ref = a @ x
    assert y.dtype == np.float32
    np.testing.assert_array_equal(y, ref)


def test_dia_bf16_gate_reads_summed_duplicates():
    """Two bf16-exact duplicates (1 and 2^-8) sum to 1 + 2^-8, which bf16
    cannot hold: the gate must see the summed plane and keep f32."""
    ptr = np.array([0, 2, 3, 4, 5])
    cols = np.array([0, 0, 1, 2, 3])
    vals = np.array([1.0, 2.0**-8, 3.0, 5.0, 7.0], np.float32)
    d = build_dia((ptr, cols, vals, (4, 4)), value_dtype="auto")
    assert d.data.dtype == jnp.float32
    x = np.ones(4, np.float32)
    np.testing.assert_array_equal(
        np.asarray(dia_spmv(d, x)), np.array([1.0 + 2.0**-8, 3.0, 5.0, 7.0], np.float32)
    )


def test_native_dia_build_matches_numpy():
    """The native plan+fill (round 5) must reproduce the numpy
    repeat/unique/add.at route plane-for-plane, duplicates included."""
    import scipy.sparse as sp

    from benchmark_spmv_using_csr5_tpu.ops.dia import build_dia
    from benchmark_spmv_using_csr5_tpu.utils import nativelib, synth

    if not nativelib.available():
        import pytest

        pytest.skip("native lib unavailable")
    a = sp.csr_matrix(synth.banded(3000, 7, dtype=np.float32))
    # inject duplicate coordinates via a doubled entry pattern
    dup = a + a
    for mat in (a, dup.tocsr()):
        csr = (mat.indptr, mat.indices, mat.data, mat.shape)
        d_nat = build_dia(csr)  # f32 interleaved -> native path
        assert d_nat is not None
        # force the numpy route by using f64 values (native is f32-only)
        mat64 = mat.astype(np.float64)
        d_np = build_dia(
            (mat64.indptr, mat64.indices, mat64.data, mat64.shape)
        )
        assert d_np is not None
        assert d_nat.offsets == d_np.offsets
        np.testing.assert_array_equal(
            np.asarray(d_nat.data),
            np.asarray(d_np.data).astype(np.float32),
        )


def test_native_dia_plan_rejects_scattered():
    from benchmark_spmv_using_csr5_tpu.ops.dia import build_dia
    from benchmark_spmv_using_csr5_tpu.utils import synth

    a = synth.random_csr(400, 400, 0.05, seed=1).tocsr().astype(np.float32)
    assert build_dia((a.indptr, a.indices, a.data, a.shape)) is None
