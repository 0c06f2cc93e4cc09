"""Performance model, timers and roofline reporting.

Keeps the reference's exact metric formulation
(``CSR5_cuda/detail/utils.h:10-20``, ``main.cu:101-106``):

- ``bytes = (m+1+nnz)*sizeof(index) + (2*nnz+m)*sizeof(value)``
- ``flops = 2*nnz``
- ``GB/s = bytes / (1e6 * time_ms)``; ``GFLOPS = flops / (1e6 * time_ms)``

plus the percent of the device's published memory bandwidth for the same
bytes model. The reference byte model is not a roofline of this executor
(which moves more bytes than it counts); it is kept for comparison with
the paper.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax

#: Published peak device-memory bandwidth (GB/s) by ``device_kind`` as JAX
#: reports it. Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part
#: (3.35 TB/s HBM3, at the full 700 W power limit). A device missing here
#: is an error, never a default.
HBM_GBPS_BY_DEVICE = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def get_bytes(m: int, nnz: int, index_bytes: int = 4, value_bytes: int = 8) -> int:
    """Bytes-moved model: getB (detail/utils.h:10-16)."""
    return (m + 1 + nnz) * index_bytes + (2 * nnz + m) * value_bytes


def get_flops(nnz: int) -> int:
    """FLOP model: getFLOP = 2*nnz (detail/utils.h:18-20)."""
    return 2 * nnz


def device_kind(device=None) -> str:
    return (device or jax.devices()[0]).device_kind


def device_hbm_gbps(kind: Optional[str] = None) -> float:
    """Published peak bandwidth of ``kind`` (default: the first device)."""
    kind = kind if kind is not None else device_kind()
    try:
        return HBM_GBPS_BY_DEVICE[kind]
    except KeyError:
        raise ValueError(
            f"no published peak bandwidth for device kind {kind!r}; "
            f"known kinds: {sorted(HBM_GBPS_BY_DEVICE)}"
        ) from None


def pct_of_peak(nbytes: float, time_ms: float, peak_gbps: Optional[float] = None) -> float:
    """Percent of the peak bandwidth that ``nbytes`` moved in ``time_ms``
    would take (peak: the first device's, unless given)."""
    peak = peak_gbps if peak_gbps is not None else device_hbm_gbps()
    return 100.0 * nbytes / (time_ms * 1e-3) / (peak * 1e9)


@dataclasses.dataclass
class SpmvMetrics:
    """The headline metric line (main.cu:104-106) + roofline extension."""

    time_ms: float
    gbps: float
    gflops: float
    nnz_per_sec: float
    roofline_gbps: float
    pct_of_roofline: float

    def __str__(self):
        return (
            f"CSR5-based SpMV time = {self.time_ms:.4f} ms, "
            f"{self.gbps:.2f} GB/s, {self.gflops:.2f} GFlops "
            f"({self.pct_of_roofline:.1f}% of {self.roofline_gbps:.0f} GB/s roofline)"
        )


def spmv_metrics(
    m: int,
    nnz: int,
    time_ms: float,
    value_bytes: int,
    index_bytes: int = 4,
    roofline_gbps: Optional[float] = None,
    num_rhs: int = 1,
    n: Optional[int] = None,
) -> SpmvMetrics:
    """SpMV metrics; for SpMM (num_rhs>1) flops scale by R and the bytes
    model adds the marginal (x + y) vector traffic per extra rhs."""
    b = get_bytes(m, nnz, index_bytes, value_bytes)
    if num_rhs > 1:
        b += (num_rhs - 1) * ((n or m) + m) * value_bytes
    fl = get_flops(nnz) * num_rhs
    roofline = roofline_gbps if roofline_gbps is not None else device_hbm_gbps()
    gbps = b / (1e6 * time_ms)
    return SpmvMetrics(
        time_ms=time_ms,
        gbps=gbps,
        gflops=fl / (1e6 * time_ms),
        nnz_per_sec=nnz / (time_ms * 1e-3),
        roofline_gbps=roofline,
        pct_of_roofline=100.0 * gbps / roofline,
    )


class Timer:
    """Wall timer with device synchronisation.

    The anonymouslib_timer analogue (utils_cuda.h:6-23): cudaEvent sync
    becomes ``jax.block_until_ready`` walls.
    """

    def __init__(self):
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop_ms(self, *block_on) -> float:
        for v in block_on:
            jax.block_until_ready(v)
        return (time.perf_counter() - self._t0) * 1e3


def benchmark(
    fn: Callable,
    *args,
    warmup: int = 50,
    num_run: int = 200,
    **kwargs,
) -> float:
    """Mean ms per call after warmup (main.cu:85-101 harness shape:
    50 warmup calls, NUM_RUN timed calls, one sync at each end)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    t = Timer().start()
    for _ in range(num_run):
        out = fn(*args, **kwargs)
    ms = t.stop_ms(out)
    return ms / num_run
