"""End-to-end benchmark harness.

Reproduces the shape of the reference benchmark drivers
(``CSR5_cuda/main.cu:17-116`` / ``call_anonymouslib``):

1. load matrix -> CSR
2. reference SpMV -> y_ref (the golden model, main.cu:336-355)
3. asCSR5 with conversion timing (anonymouslib_cuda.h:211-214)
4. one checked spmv + the 1%-relative validation (main.cu:361-384)
5. ``warmup`` untimed runs then ``num_run`` timed runs (main.cu:85-101)
6. report ms / GB/s / GFLOPS (detail/utils.h:10-20) + %-of-HBM-roofline

Timing: the NUM_RUN loop runs *on device* inside one jitted
``lax.fori_loop`` whose iterations are data-dependent (y feeds a
tiny-scaled perturbation of x), so XLA can neither hoist nor merge them;
the loop total is timed on the host around ``block_until_ready`` -- the
device-side analogue of the reference's timed loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AUTO_TUNED_SIGMA, CSR5Config, compute_sigma
from ..ops.convert import build_csr5
from ..ops.csr5_spmv import csr5_spmm_xla, csr5_spmv_xla
from ..utils import perf, progress


@dataclasses.dataclass
class BenchResult:
    name: str
    m: int
    n: int
    nnz: int
    sigma: int
    dtype: str
    backend: str
    convert_ms: float
    convert_phases: dict
    spmv_ms: float
    gbps: float
    gflops: float
    nnz_per_sec: float
    pct_of_roofline: float
    check_ok: bool
    max_rel_err: float
    #: on-device value-plane storage dtype ("bfloat16" when the lossless
    #: auto gate engaged; results are then bit-identical to f32 storage)
    storage: str = ""
    #: the peak the roofline share divides by, and whose it is
    roofline_gbps: float = 0.0
    device_kind: str = ""

    def report(self) -> str:
        """The reference's output lines (main.cu:104-106, :361-384)."""
        ok = "PASS!" if self.check_ok else "NOT PASS!"
        ph = " ".join(f"{k}={v:.1f}" for k, v in self.convert_phases.items())
        return (
            f"[{self.name}] ({self.m}, {self.n}) nnz = {self.nnz}, sigma = {self.sigma}\n"
            f"CSR->CSR5 time = {self.convert_ms:.3f} ms ({ph})\n"
            f"CSR5-based SpMV time = {self.spmv_ms:.4f} ms, "
            f"{self.gbps:.2f} GB/s, {self.gflops:.2f} GFlops, "
            f"{self.pct_of_roofline:.1f}% of {self.roofline_gbps:g} GB/s "
            f"({self.device_kind}) "
            f"[{self.backend}{', ' + self.storage if self.storage else ''}]\n"
            f"Check... {ok} (max rel err {self.max_rel_err:.2e})"
        )


@jax.jit
def _rel_max(y, y_ref, floor):
    diff = jnp.abs(y - y_ref.astype(y.dtype))
    rel = diff / jnp.maximum(jnp.abs(y_ref), 1e-30)
    return jnp.max(jnp.where(diff < floor, 0.0, rel))


def rel_err_device(y_dev, y_ref_host) -> float:
    """max relative error of a device result vs a host oracle, reduced
    on device (only the scalar is read back)."""
    floor = 1e-6 * max(1.0, float(np.abs(y_ref_host).max()))
    return float(_rel_max(y_dev, jnp.asarray(y_ref_host), floor))


def time_spmv_device_loop(spmv_fn, x, num_run: int, operands=None) -> float:
    """Mean ms per spmv over a data-dependent on-device loop.

    ``operands`` (any pytree, e.g. the CSR5Matrix) is passed to the jit as
    an argument: closing over large device arrays would embed them in the
    program as constants. ``spmv_fn(operands, xx)`` when operands is
    given, else ``spmv_fn(xx)``.
    """

    @jax.jit
    def run_k(operands, x, k_iters):
        def body(_, carry):
            acc, xx = carry
            y = spmv_fn(operands, xx) if operands is not None else spmv_fn(xx)
            # depend on ALL of y: XLA moves a slice of y into the
            # elementwise ops that produce it, so a few-element tap would
            # time only those elements (e.g. of a DIA product)
            acc = acc + jnp.sum(y).astype(acc.dtype)
            # re-derive x with a tiny-scaled dependency on acc: forces the
            # loop body to stay sequential; a 0.0 scale can be folded away
            # by XLA (loop-invariant hoisting), 1e-30 cannot and perturbs
            # the values by less than one ulp
            xx = x + acc[0] * jnp.asarray(1e-30, x.dtype)
            return acc, xx

        acc, _ = jax.lax.fori_loop(
            0, k_iters, body, (jnp.zeros((1,), x.dtype), x)
        )
        return acc

    # min over samples of the full loop minus a 1-iteration loop: the
    # difference removes the dispatch and the loop's fixed cost
    def sample(k, reps=5):
        best = float("inf")
        jax.block_until_ready(run_k(operands, x, k))  # compile + warm
        progress.emit(f"timing:warm k={k}")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(run_k(operands, x, k))
            best = min(best, time.perf_counter() - t0)
            progress.emit(f"timing:rep k={k}")
        return best

    t_full = sample(num_run)
    t_one = sample(1)
    return max(t_full - t_one, 1e-9) / max(num_run - 1, 1) * 1e3


def run_benchmark(
    name: str,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape,
    x: Optional[np.ndarray] = None,
    sigma: int = AUTO_TUNED_SIGMA,
    num_run: int = 50,
    roofline_gbps: Optional[float] = None,
    num_rhs: int = 1,
    autotune: bool = False,
) -> BenchResult:
    """Benchmark SpMV (num_rhs=1) or SpMM (num_rhs>1) on one matrix.

    f64 values run in f64 when ``jax_enable_x64`` is on (and are narrowed
    to f32 at conversion otherwise)."""
    m, n = shape
    dtype = values.dtype
    if x is None:
        rng = np.random.default_rng(0)
        x = rng.integers(1, 10, size=(n, num_rhs) if num_rhs > 1 else n).astype(
            dtype
        )  # main.cu:323-326

    # the executor consumes only the converted form: read nnz from the
    # host row pointer instead of uploading the CSR
    nnz = int(row_ptr[-1])
    xd = jnp.asarray(x)

    # golden model (main.cu:336-355): sparse-aware host oracle
    import scipy.sparse as sp

    progress.emit("golden")
    a_sp = sp.csr_matrix((values, col_idx, row_ptr), shape=shape)
    y_ref = a_sp @ x

    progress.emit("convert")
    t0 = time.perf_counter()
    cfg = CSR5Config(sigma=compute_sigma(m, nnz, sigma))
    csr = (row_ptr, col_idx, values, shape)
    # "auto" storage: bf16 value plane only when provably lossless
    # (bit-identical results, half the value bytes)
    if autotune and sigma == AUTO_TUNED_SIGMA:
        # an explicitly requested sigma always wins over the re-tune
        from ..ops.convert import build_csr5_autotuned

        a5 = build_csr5_autotuned(csr, cfg, value_dtype="auto")
    else:
        a5 = build_csr5(csr, cfg, value_dtype="auto")
    convert_ms = (time.perf_counter() - t0) * 1e3
    from ..ops.convert import last_convert_phases

    convert_phases = dict(last_convert_phases)

    if num_rhs > 1:
        backend = "csr5-spmm"
        spmv_fn = lambda a, xx: csr5_spmm_xla(a, xx)  # noqa: E731
    else:
        backend = "csr5"
        spmv_fn = lambda a, xx: csr5_spmv_xla(a, xx)  # noqa: E731

    # correctness at the reference tolerance (main.cu:361-384); the
    # reduction runs on device
    progress.emit("check")
    max_rel = rel_err_device(spmv_fn(a5, xd), y_ref)
    check_ok = bool(max_rel <= 0.01)

    progress.emit("timing")  # jit compile + min-of-samples device loops
    spmv_ms = time_spmv_device_loop(spmv_fn, xd, num_run, operands=a5)
    progress.emit("timing:done")
    kind = perf.device_kind()
    peak = roofline_gbps if roofline_gbps is not None else perf.device_hbm_gbps(kind)
    met = perf.spmv_metrics(
        m,
        nnz,
        spmv_ms,
        dtype.itemsize,
        roofline_gbps=peak,
        num_rhs=num_rhs,
        n=n,
    )
    return BenchResult(
        name=name,
        m=m,
        n=n,
        nnz=nnz,
        sigma=a5.sigma,
        dtype=str(dtype),
        backend=backend,
        storage=str(np.dtype(a5.val_tiles.dtype)),
        convert_ms=convert_ms,
        convert_phases=convert_phases,
        spmv_ms=spmv_ms,
        gbps=met.gbps,
        gflops=met.gflops,
        nnz_per_sec=met.nnz_per_sec,
        pct_of_roofline=met.pct_of_roofline,
        check_ok=check_ok,
        max_rel_err=max_rel,
        roofline_gbps=peak,
        device_kind=kind,
    )
