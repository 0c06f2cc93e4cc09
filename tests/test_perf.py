"""The peak table behind every roofline share (utils/perf.py)."""

import pytest

from benchmark_spmv_using_csr5_tpu.utils import perf


def test_h100_kind_resolves():
    # device_kind as JAX reports the H100 SXM; NVIDIA's data sheet: 3.35 TB/s
    assert perf.device_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100", ""])
def test_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peak bandwidth"):
        perf.device_hbm_gbps(kind)


def test_pct_of_peak():
    # 3.35 GB in 1 ms is 3350 GB/s: all of the H100's peak
    assert perf.pct_of_peak(3.35e9, 1.0, 3350.0) == pytest.approx(100.0)
    assert perf.pct_of_peak(1.675e9, 1.0, 3350.0) == pytest.approx(50.0)


def test_spmv_metrics_uses_given_peak():
    m, nnz = 1000, 5000
    met = perf.spmv_metrics(m, nnz, 0.01, 4, roofline_gbps=3350.0)
    b = perf.get_bytes(m, nnz, 4, 4)
    assert met.gbps == pytest.approx(b / (1e6 * 0.01))
    assert met.pct_of_roofline == pytest.approx(100.0 * met.gbps / 3350.0)
    assert met.roofline_gbps == 3350.0
