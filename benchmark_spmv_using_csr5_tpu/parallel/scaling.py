"""Weak-scaling measurement for distributed CSR5 SpMV.

Measures nnz/s scaling efficiency for any mesh the runtime exposes: real
multi-device meshes when available, or the virtual host-device mesh for CI
(where absolute times are meaningless but the harness and collectives are
exercised end-to-end).

Weak scaling: the per-device problem size is fixed (rows_per_device x
bandwidth), so the global matrix grows with D; efficiency(D) =
(nnz_rate(D) / D) / nnz_rate(1).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import synth
from .distributed import distribute_csr, distributed_spmv, make_mesh


@dataclasses.dataclass
class ScalePoint:
    devices: int
    nnz: int
    ms_per_spmv: float
    nnz_per_sec: float
    efficiency: float  # vs 1-device nnz/s per device
    #: (max - min) / min over the measurement repeats at this D — the
    #: noise indicator (virtual meshes timeshare the host's cores)
    spread: float = 0.0


def _time_distributed(da, mesh, x, iters: int) -> float:
    # da is passed to the jit as an ARGUMENT: closing over the
    # DistributedCSR5 pytree would embed its arrays as program constants
    @jax.jit
    def loop(da, x, k):
        def body(_, carry):
            acc, xx = carry
            y = distributed_spmv(da, xx, mesh)
            acc = acc + y.ravel()[:1]
            return acc, x + acc[0] * jnp.asarray(1e-30, x.dtype)

        acc, _ = jax.lax.fori_loop(0, k, body, (jnp.zeros((1,), x.dtype), x))
        return acc

    def sample(k, reps=3):
        best = float("inf")
        jax.block_until_ready(loop(da, x, k))
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(da, x, k))
            best = min(best, time.perf_counter() - t0)
        return best

    return max(sample(iters) - sample(1), 1e-9) / max(iters - 1, 1) * 1e3


def weak_scaling(
    device_counts: Optional[List[int]] = None,
    rows_per_device: int = 65536,
    bandwidth: int = 27,
    iters: int = 20,
    matrix_factory: Optional[Callable[[int], "object"]] = None,
    repeats: int = 1,
) -> List[ScalePoint]:
    """Weak-scaling sweep over mesh sizes; returns one ScalePoint per D.

    ``repeats > 1`` measures each D that many times and keeps the MIN,
    recording the min-to-max spread.
    """
    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= n_avail]
    points: List[ScalePoint] = []
    base_rate = None
    for d in device_counts:
        m = rows_per_device * d
        a = (
            matrix_factory(m)
            if matrix_factory is not None
            else synth.banded(m, bandwidth, dtype=np.float32)
        )
        mesh = make_mesh(d)
        da = distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh)
        x = jnp.asarray(synth.dense_x(m, dtype=np.float32))
        samples = [
            _time_distributed(da, mesh, x, iters)
            for _ in range(max(repeats, 1))
        ]
        ms = min(samples)
        spread = (max(samples) - ms) / ms if ms > 0 else 0.0
        rate = a.nnz / (ms * 1e-3)
        if base_rate is None:
            base_rate = rate
        points.append(
            ScalePoint(
                devices=d,
                nnz=int(a.nnz),
                ms_per_spmv=ms,
                nnz_per_sec=rate,
                efficiency=rate / d / base_rate,
                spread=spread,
            )
        )
    return points


def report(points: List[ScalePoint]) -> str:
    lines = ["devices      nnz    ms/spmv      nnz/s   weak-eff   spread"]
    for p in points:
        lines.append(
            f"{p.devices:7d} {p.nnz:9d} {p.ms_per_spmv:9.3f} "
            f"{p.nnz_per_sec:11.3e} {p.efficiency:9.2%} {p.spread:8.1%}"
        )
    return "\n".join(lines)
