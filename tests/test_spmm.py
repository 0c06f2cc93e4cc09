"""SpMM (multi-rhs SpMV) tests: the CSR5 executor vs scipy, over edge
shapes and rhs counts.

The reference has no SpMM; this is the BASELINE.json configs[3]
capability (8-64 rhs columns on CSR5 tiles).
"""

import numpy as np
import pytest

from benchmark_spmv_using_csr5_tpu import (
    CSR5Config,
    build_csr5,
    csr5_spmm,
    csr5_spmm_xla,
    csr_from_scipy,
)
from benchmark_spmv_using_csr5_tpu.utils import synth


def _x_mat(n, R, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 10, size=(n, R)).astype(np.float32)


@pytest.mark.parametrize("R", [1, 2, 8])
def test_spmm_pallas_matches_scipy(R):
    a_sp = synth.banded(320, 9).astype(np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), CSR5Config(sigma=8, tiles_per_block=4))
    X = _x_mat(a_sp.shape[1], R)
    Y = np.asarray(csr5_spmm(a5, X, alpha=2.0))
    Y_ref = 2.0 * (a_sp @ X)
    np.testing.assert_allclose(Y, Y_ref, atol=2e-5 * max(1.0, np.abs(Y_ref).max()))


def test_spmm_rn_layout_matches_nr():
    # each column of the SpMM is exactly the SpMV of that column
    from benchmark_spmv_using_csr5_tpu import csr5_spmv

    a_sp = synth.banded(320, 9).astype(np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), CSR5Config(sigma=8, tiles_per_block=4))
    X = _x_mat(a_sp.shape[1], 4)
    Y = np.asarray(csr5_spmm(a5, X))
    for r in range(4):
        np.testing.assert_array_equal(Y[:, r], np.asarray(csr5_spmv(a5, X[:, r])))


def test_spmm_xla_matches_scipy():
    a_sp = synth.power_law(400, 350, 6.0, seed=8).astype(np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), CSR5Config(sigma=8, tiles_per_block=8))
    X = _x_mat(350, 4)
    Y = np.asarray(csr5_spmm_xla(a5, X, alpha=-0.5))
    Y_ref = -0.5 * (a_sp @ X)
    np.testing.assert_allclose(Y, Y_ref, atol=2e-5 * max(1.0, np.abs(Y_ref).max()))


def test_spmm_edge_cases(edge_matrix):
    name, a_sp = edge_matrix
    a_sp = a_sp.astype(np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), CSR5Config(sigma=8, tiles_per_block=4))
    X = _x_mat(a_sp.shape[1], 2)
    Y = np.asarray(csr5_spmm(a5, X))
    Y_ref = a_sp @ X
    np.testing.assert_allclose(
        Y, Y_ref, atol=2e-5 * max(1.0, np.abs(Y_ref).max()), err_msg=name
    )


@pytest.mark.parametrize("R", [16, 64])
def test_spmm_supported_gate(R):
    # no rhs cap: wide X runs through the same executor
    a_sp = synth.banded(500, 9).astype(np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp))
    X = _x_mat(a_sp.shape[1], R)
    np.testing.assert_array_equal(np.asarray(csr5_spmm(a5, X)), a_sp @ X)
