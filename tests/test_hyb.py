"""HYB5 (DIA + CSR5 hybrid) tests — the format the reference declares
(ANONYMOUSLIB_FORMAT_HYB5, common.h:21) but never implements."""

import numpy as np
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu import build_hyb, hyb_spmm, hyb_spmv
from benchmark_spmv_using_csr5_tpu.utils import synth


def _mixed_matrix(m=1500, diags=5, extra_density=0.002, seed=0):
    """Dense band + scattered noise: the HYB sweet spot."""
    band = sp.csr_matrix(synth.banded(m, diags, dtype=np.float32))
    noise = sp.random(
        m, m, extra_density, format="csr", dtype=np.float32, random_state=seed
    )
    noise.data[:] = np.round(noise.data * 8) + 1
    return sp.csr_matrix(band + noise)


def _host(a):
    return (a.indptr, a.indices, a.data, a.shape)


def test_hyb_splits_mixed():
    a = _mixed_matrix()
    h = build_hyb(_host(a))
    assert h.dia is not None and h.csr5 is not None
    assert h.dia.nnz_stored + h.csr5.nnz_stored == a.nnz
    # the band went to DIA
    assert h.dia.ndiag >= 5
    x = synth.dense_x(a.shape[1], dtype=np.float32)
    y = np.asarray(hyb_spmv(h, x, alpha=1.25))
    y_ref = 1.25 * (a @ x)
    np.testing.assert_allclose(
        y, y_ref, atol=2e-5 * max(1.0, np.abs(y_ref).max())
    )


def test_hyb_pure_banded_has_no_csr5():
    a = sp.csr_matrix(synth.banded(1000, 7, dtype=np.float32))
    h = build_hyb(_host(a))
    assert h.dia is not None and h.csr5 is None
    x = synth.dense_x(1000, dtype=np.float32)
    y = np.asarray(hyb_spmv(h, x))
    np.testing.assert_allclose(y, a @ x, atol=1e-4)


def test_hyb_unstructured_has_no_dia():
    a = sp.random(800, 800, 0.01, format="csr", dtype=np.float32, random_state=2)
    h = build_hyb(_host(a))
    assert h.dia is None and h.csr5 is not None
    x = synth.dense_x(800, dtype=np.float32)
    y = np.asarray(hyb_spmv(h, x))
    np.testing.assert_allclose(
        y, a @ x, atol=2e-5 * max(1.0, np.abs(a @ x).max())
    )


def test_hyb_spmm_mixed():
    """Multi-rhs HYB: DIA and CSR5 halves each handle (n, R) inputs."""
    a = _mixed_matrix(m=900)
    h = build_hyb(_host(a))
    assert h.dia is not None and h.csr5 is not None
    rng = np.random.default_rng(3)
    xm = rng.integers(1, 10, size=(a.shape[1], 4)).astype(np.float32)
    y = np.asarray(hyb_spmm(h, xm, alpha=0.5))
    y_ref = 0.5 * (a @ xm)
    assert y.shape == y_ref.shape
    np.testing.assert_allclose(
        y, y_ref, atol=2e-5 * max(1.0, np.abs(y_ref).max())
    )


def test_hyb_spmm_xla_dia_fallback_matches():
    """dia_spmm / dia_spmv (HYB's DIA half) agree with the oracle."""
    from benchmark_spmv_using_csr5_tpu.ops.dia import build_dia, dia_spmm, dia_spmv

    a = sp.csr_matrix(synth.banded(700, 5, dtype=np.float32))
    d = build_dia(_host(a))
    rng = np.random.default_rng(4)
    xm = rng.integers(1, 10, size=(700, 3)).astype(np.float32)
    ym = np.asarray(dia_spmm(d, xm))
    np.testing.assert_allclose(ym, a @ xm, atol=1e-4)
    yv = np.asarray(dia_spmv(d, xm[:, 0], alpha=2.0))
    np.testing.assert_allclose(yv, 2.0 * (a @ xm[:, 0]), atol=1e-4)


def test_hyb_empty():
    e = sp.csr_matrix((16, 16), dtype=np.float32)
    h = build_hyb(_host(e))
    assert h.dia is None and h.csr5 is None
    y = np.asarray(hyb_spmv(h, synth.dense_x(16, dtype=np.float32)))
    assert (y == 0).all()
