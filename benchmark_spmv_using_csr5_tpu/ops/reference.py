"""Golden SpMV / SpMM kernels in pure jax.numpy.

The analogue of the reference's serial CSR oracle
(``CSR5_cuda/main.cu:336-355``): simple, obviously-correct formulations used
to validate the CSR5 executor, and as the always-available fallback
compute path. All are jittable with static shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.formats import COOMatrix, CSRMatrix


def _row_ids(row_ptr: jax.Array, m: int, nnz: int) -> jax.Array:
    """Per-nonzero row index from row_ptr (a jittable COO expansion)."""
    return jnp.repeat(
        jnp.arange(m, dtype=row_ptr.dtype),
        jnp.diff(row_ptr),
        total_repeat_length=nnz,
    )


@partial(jax.jit, static_argnames=("transpose",))
def csr_spmv(a: CSRMatrix, x: jax.Array, alpha=1.0, transpose: bool = False) -> jax.Array:
    """y = alpha * A @ x (or alpha * A.T @ x) via segment-sum.

    Oracle parity with the serial loop at main.cu:336-355.
    """
    rows = _row_ids(a.row_ptr, a.m, a.nnz)
    if transpose:
        prod = a.values * jnp.take(x, rows)
        y = jax.ops.segment_sum(prod, a.col_idx, num_segments=a.n)
    else:
        prod = a.values * jnp.take(x, a.col_idx)
        y = jax.ops.segment_sum(prod, rows, num_segments=a.m, indices_are_sorted=True)
    return (alpha * y).astype(x.dtype)


@jax.jit
def coo_spmv(a: COOMatrix, x: jax.Array, alpha=1.0) -> jax.Array:
    prod = a.values * jnp.take(x, a.col)
    y = jax.ops.segment_sum(prod, a.row, num_segments=a.shape[0])
    return (alpha * y).astype(x.dtype)


@jax.jit
def csr_spmm(a: CSRMatrix, x: jax.Array, alpha=1.0) -> jax.Array:
    """Y = alpha * A @ X for dense X of shape (n, k) (multi-RHS SpMV)."""
    rows = _row_ids(a.row_ptr, a.m, a.nnz)
    prod = a.values[:, None] * jnp.take(x, a.col_idx, axis=0)
    y = jax.ops.segment_sum(prod, rows, num_segments=a.m, indices_are_sorted=True)
    return (alpha * y).astype(x.dtype)


@jax.jit
def csr_spmv_scan(a: CSRMatrix, x: jax.Array, alpha=1.0) -> jax.Array:
    """Prefix-sum formulation: y[r] = P[end(r)] - P[end(r-1)] with
    P = cumsum of products in element order.

    This is the mathematical core the CSR5 executor blocks: it computes
    the same prefix structure tile-locally and scatter-adds the row
    windows instead of one global scan. Kept as an independent oracle so
    the tiled executor can be differenced against both formulations.
    """
    prod = a.values * jnp.take(x, a.col_idx)
    pre = jnp.cumsum(prod)
    pre = jnp.concatenate([jnp.zeros((1,), pre.dtype), pre])
    y = pre[a.row_ptr[1:]] - pre[a.row_ptr[:-1]]
    return (alpha * y).astype(x.dtype)


def csr_spmv_numpy(row_ptr, col_idx, values, x, alpha=1.0):
    """Host-side numpy oracle (exact serial semantics, main.cu:336-355)."""
    import numpy as np

    m = len(row_ptr) - 1
    y = np.zeros(m, dtype=np.result_type(values.dtype, x.dtype))
    for i in range(m):
        s = 0.0
        for j in range(row_ptr[i], row_ptr[i + 1]):
            s += values[j] * x[col_idx[j]]
        y[i] = alpha * s
    return y
