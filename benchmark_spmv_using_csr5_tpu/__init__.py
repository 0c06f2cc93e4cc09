"""benchmark_spmv_using_csr5_tpu: a CSR5 sparse linear-algebra library in
JAX, built from scratch with the capabilities of
``weifengliu-ssslab/Benchmark_SpMV_using_CSR5`` (Liu & Vinter, ICS '15).

Public API (the anonymouslibHandle analogue lives in models.handle):

    >>> from benchmark_spmv_using_csr5_tpu import SpMVHandle
    >>> h = SpMVHandle(m, n).input_csr(nnz, row_ptr, col_idx, values)
    >>> h.set_sigma(AUTO_TUNED_SIGMA).as_csr5()
    >>> h.set_x(x)
    >>> y = h.spmv(alpha)
"""

from .config import AUTO_TUNED_SIGMA, CSR5Config, Format, Status, compute_sigma
from .models.formats import COOMatrix, CSR5Matrix, CSRMatrix, csr_from_numpy, csr_from_scipy
from .models.handle import SpMVHandle
from .ops.convert import build_csr5, build_csr5_autotuned, csr5_to_csr
from .ops.csr5_spmv import csr5_spmm, csr5_spmm_xla, csr5_spmv, csr5_spmv_xla
from .ops.dia import DIAMatrix, build_dia, dia_spmm, dia_spmv
from .ops.hyb import HYBMatrix, build_hyb, hyb_spmm, hyb_spmv
from .ops.reference import coo_spmv, csr_spmm, csr_spmv
from .ops.select import analyze_diagonals, select_format

__version__ = "0.1.0"

__all__ = [
    "AUTO_TUNED_SIGMA",
    "CSR5Config",
    "Format",
    "Status",
    "compute_sigma",
    "COOMatrix",
    "CSRMatrix",
    "CSR5Matrix",
    "csr_from_numpy",
    "csr_from_scipy",
    "SpMVHandle",
    "build_csr5",
    "build_csr5_autotuned",
    "csr5_to_csr",
    "csr5_spmm",
    "csr5_spmm_xla",
    "csr5_spmv",
    "csr5_spmv_xla",
    "csr_spmv",
    "csr_spmm",
    "coo_spmv",
    "DIAMatrix",
    "build_dia",
    "dia_spmm",
    "dia_spmv",
    "HYBMatrix",
    "build_hyb",
    "hyb_spmm",
    "hyb_spmv",
    "analyze_diagonals",
    "select_format",
]
