"""IEEE f64 CSR5 SpMV vs the scipy f64 oracle.

The reference's default value type is double (CSR5_cuda/Makefile:4). With
x64 enabled, f64 values are stored and multiplied in f64 by the same
executor as f32. Values are random non-dyadic f64 spread over decades, so
any f32 step on the way would show as ~1e-7 relative error.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu import build_csr5, csr5_spmv
from benchmark_spmv_using_csr5_tpu.utils import synth


def _f64_values(a_sp, seed=0, signed=False, decades=1):
    rng = np.random.default_rng(seed)
    a = sp.csr_matrix(a_sp).astype(np.float64)
    a.data = rng.uniform(0.1, 1.0, a.nnz) * 10.0 ** rng.integers(
        -decades, decades + 1, a.nnz
    )
    if signed:
        a.data *= np.where(rng.uniform(size=a.nnz) < 0.5, -1.0, 1.0)
    return a


def _rel(a, y, x, alpha=1.0):
    """Error relative to the row's |A||x| mass (what a sum of products
    can promise when terms of both signs cancel)."""
    y_ref = alpha * (a @ x)
    scale = np.maximum(np.abs(a).dot(np.abs(x)) * abs(alpha), 1e-300)
    return np.abs(np.asarray(y) - y_ref) / scale


def _run(a, alpha=1.0, seed=1):
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, a.shape[1])
    a5 = build_csr5((a.indptr, a.indices, a.data, a.shape))
    assert a5.val_tiles.dtype == np.float64
    y = csr5_spmv(a5, x, alpha=alpha)
    assert y.dtype == np.float64
    return _rel(a, y, x, alpha)


def test_df64_banded_beats_f32():
    a = _f64_values(synth.banded(3000, 9))
    rel64 = _run(a).max()
    assert rel64 < 1e-10
    # the same data through f32 storage loses ~7 decimal digits
    a32 = a.astype(np.float32)
    a5 = build_csr5((a32.indptr, a32.indices, a32.data, a32.shape))
    x = np.random.default_rng(1).uniform(-1.0, 1.0, a.shape[1])
    y32 = np.asarray(csr5_spmv(a5, x.astype(np.float32))).astype(np.float64)
    rel32 = _rel(a, y32, x).max()
    assert rel32 > 1e-9  # the data genuinely stresses f32
    assert rel64 < rel32 * 1e-3


@pytest.mark.parametrize(
    "make,alpha",
    [
        (lambda: synth.banded(1200, 5), 2.5),
        (lambda: synth.power_law(900, 900, 6.0), 1.0),  # empty rows
        (lambda: synth.scattered_band(1500, 8, 700), 1.0),
        (lambda: synth.single_dense_row(16, 9000, row_nnz=6000), -0.5),
    ],
    ids=["banded_alpha", "powerlaw_empty_rows", "scattered", "row_spans_tiles"],
)
def test_f64_matches_oracle(make, alpha):
    assert _run(_f64_values(make(), seed=5), alpha=alpha).max() < 1e-10


def _tile_scale(a, x, T):
    """Per-row structural scale: the executor takes each row's sum as the
    difference of two running prefixes of its tile, so its absolute error
    scales with the |a||x| mass of the row's tile(s), not of the row."""
    prods = np.abs(a.data) * np.abs(x)[a.indices]
    nt = -(-len(prods) // T)
    pad = np.zeros(nt * T)
    pad[: len(prods)] = prods
    tile_mass = pad.reshape(nt, T).sum(axis=1)
    rp = a.indptr
    t0 = np.minimum(rp[:-1] // T, nt - 1)
    t1 = np.minimum(np.maximum(rp[1:] - 1, rp[:-1]) // T, nt - 1)
    row = np.abs(a).dot(np.abs(x))
    return np.maximum(np.maximum(row, np.maximum(tile_mass[t0], tile_mass[t1])), 1e-300)


def test_df64_error_model_decade_spread():
    # 7-decade mixed-sign values and x: within f64 rounding of the tile's
    # prefix mass (a short row beside large values in its tile sees the
    # amplification; the f32 version of this bound is ~1e-4)
    rng = np.random.default_rng(0)
    a = _f64_values(synth.banded(2000, 27), signed=True, decades=3)
    x = rng.uniform(0.1, 1.0, 2000) * 10.0 ** rng.integers(-3, 4, 2000)
    a5 = build_csr5((a.indptr, a.indices, a.data, a.shape))
    err = np.abs(np.asarray(csr5_spmv(a5, x)) - a @ x)
    assert (err / _tile_scale(a, x, a5.config.tile_nnz)).max() < 1e-12
