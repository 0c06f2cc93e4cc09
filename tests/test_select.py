"""Format auto-selection tests (ops/select.py): one structural pass
picks DIA / HYB5 / CSR5 from the structure."""

import numpy as np
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu import select_format, analyze_diagonals
from benchmark_spmv_using_csr5_tpu.utils import synth


def _host(a_sp):
    a = sp.csr_matrix(a_sp)
    return a.indptr, a.indices, a.shape


def test_banded_selects_dia():
    rp, ci, shape = _host(synth.banded(5000, 27, dtype=np.float32))
    assert select_format(rp, ci, shape) == "dia"


def test_tridiag_selects_dia():
    rp, ci, shape = _host(synth.banded(1000, 3, dtype=np.float32))
    assert select_format(rp, ci, shape) == "dia"


def test_powerlaw_selects_csr5():
    rp, ci, shape = _host(synth.power_law(3000, 3000, 6.0, dtype=np.float32))
    assert select_format(rp, ci, shape) == "csr5"


def test_scattered_band_selects_csr5():
    rp, ci, shape = _host(
        synth.scattered_band(4000, 10, 1500, dtype=np.float32)
    )
    assert select_format(rp, ci, shape) == "csr5"


def test_mixed_selects_hyb():
    # dense tridiagonal core + scattered noise: the HYB5 shape
    m = 4000
    band = sp.csr_matrix(synth.banded(m, 3, dtype=np.float32))
    rng = np.random.default_rng(0)
    noise = sp.random(
        m, m, density=0.001, format="csr", random_state=rng, dtype=np.float32
    )
    a = (band + noise).tocsr()
    rp, ci, shape = a.indptr, a.indices, a.shape
    st = analyze_diagonals(rp, ci, shape)
    assert not st.dia_ok  # noise spreads over too many diagonals
    assert st.dense_share > 0.5
    assert select_format(rp, ci, shape) == "hyb"


def test_stats_shape():
    a = sp.csr_matrix(synth.banded(1000, 5, dtype=np.float32))
    st = analyze_diagonals(a.indptr, a.indices, a.shape)
    assert st.ndiag == len(a.todia().offsets)
    assert st.dia_ok and st.nnz == a.nnz


def test_empty_matrix():
    rp = np.zeros(11, np.int64)
    ci = np.zeros(0, np.int64)
    assert select_format(rp, ci, (10, 10)) == "csr5"


# ---------------------------------------------------------------------------
# select_plan: auto-reorder
# ---------------------------------------------------------------------------


def test_plan_scrambled_band_auto_rcm():
    # a banded matrix hidden behind a random symmetric permutation: the
    # recoverable-locality shape — the plan must detect it and apply RCM
    from benchmark_spmv_using_csr5_tpu.ops.select import apply_plan, select_plan

    a = sp.csr_matrix(synth.scattered_band(8000, 8, 200, dtype=np.float32))
    rng = np.random.default_rng(0)
    perm = rng.permutation(8000)
    a = a[perm][:, perm].tocsr()
    plan = select_plan(a.indptr, a.indices, a.shape)
    assert plan.format == "csr5"
    assert plan.reorder == "rcm"
    assert plan.bandwidth_after * 4 <= plan.bandwidth_before
    csr2, p2 = apply_plan((a.indptr, a.indices, a.data, a.shape), plan)
    assert p2 is not None
    # SpMV relation holds through the applied plan
    x = rng.uniform(size=8000).astype(np.float32)
    a2 = sp.csr_matrix((csr2[2], csr2[1], csr2[0]), shape=csr2[3])
    np.testing.assert_allclose(
        a2 @ x[p2], (a @ x)[p2], rtol=1e-5, atol=1e-6
    )


def test_plan_powerlaw_stays_raw():
    # uniform-random columns are RCM-immune (the measured tier-2 floor):
    # the gain gate must refuse the reorder
    from benchmark_spmv_using_csr5_tpu.ops.select import select_plan

    a = sp.csr_matrix(synth.power_law(6000, 6000, 8.0, dtype=np.float32))
    plan = select_plan(a.indptr, a.indices, a.shape)
    assert plan.format == "csr5"
    assert plan.reorder is None
    assert plan.bandwidth_after is not None  # attempted, rejected


def test_plan_banded_skips_reorder_attempt():
    # DIA-class matrix: no reorder attempt at all (format != csr5)
    from benchmark_spmv_using_csr5_tpu.ops.select import apply_plan, select_plan

    a = sp.csr_matrix(synth.banded(5000, 27, dtype=np.float32))
    plan = select_plan(a.indptr, a.indices, a.shape)
    assert plan.format == "dia"
    assert plan.reorder is None and plan.bandwidth_after is None
    csr2, p2 = apply_plan((a.indptr, a.indices, a.data, a.shape), plan)
    assert p2 is None


def test_plan_narrow_band_csr5_skips_attempt():
    # CSR5 but already inside the contiguous-gather reach: no RCM attempt
    from benchmark_spmv_using_csr5_tpu.ops.select import select_plan

    a = sp.csr_matrix(synth.scattered_band(4000, 10, 900, dtype=np.float32))
    plan = select_plan(a.indptr, a.indices, a.shape)
    assert plan.format == "csr5"
    assert plan.reorder is None and plan.bandwidth_after is None
