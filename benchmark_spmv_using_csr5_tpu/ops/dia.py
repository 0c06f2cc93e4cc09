"""DIA (diagonal) format: the structured-matrix fast path.

The reference declares a second format slot it never implements
(``ANONYMOUSLIB_FORMAT_HYB5``, CSR5_cuda/detail/common.h:21); this module
fills that "format expansion" slot. For matrices whose nonzeros
concentrate on few diagonals (banded systems — the structured half of the
SpMV benchmark space), DIA streams ONLY the value planes (4 B/nnz f32, vs
8 for CSR5's val+col) and replaces the x gather with *static* diagonal
shifts: each diagonal offset is a compile-time constant, so
``y = sum_k data[k] * x[off_k:]`` is a sum of statically shifted slices,
which XLA fuses into one elementwise pass.

:func:`build_dia` gates: matrices with more than ``max_diags`` distinct
diagonals or a sparse diagonal fill ratio convert to ``None`` (DIA would
waste bandwidth on stored zeros; CSR5 stays the general path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass, static_field

#: rows per slab of the interleaved layout; m is padded to a multiple
LANES = 128
#: hard cap on stored diagonals (work per output row scales with it)
MAX_DIAGS = 96
#: minimum nnz / (ndiag * m) so stored zeros don't dominate the stream
MIN_FILL = 0.2


@pytree_dataclass
class DIAMatrix:
    """Diagonal-storage sparse matrix: data[k, i] = A[i, i + offsets[k]].

    ``data`` rows are zero-filled where a diagonal leaves the matrix.
    ``offsets`` is a static (hashable) tuple, so the executor specializes
    its shifts per sparsity pattern (the analogue of the reference's
    per-sigma kernel specialization).

    Two storage layouts (``interleaved`` static flag):

    - interleaved (default): ``data`` is (m_pad/128, ndiag, 128), so a
      128-row slab of every diagonal is one contiguous block; the
      distributed layer row-shards it by reshape.
    - diag-major: ``data`` is (ndiag, m_pad), the natural export view
      (:func:`_data_diag`).
    """

    shape: Tuple[int, int] = static_field()
    offsets: Tuple[int, ...] = static_field()
    nnz_stored: int = static_field()
    data: jax.Array  # (ndiag, m_pad) float, or interleaved 3D
    m_pad: int = static_field(default=0)
    interleaved: bool = static_field(default=False)

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.data.dtype


def _as_host(csr):
    if isinstance(csr, tuple):
        row_ptr, col_idx, values, shape = csr
    elif hasattr(csr, "indptr"):
        row_ptr, col_idx, values, shape = csr.indptr, csr.indices, csr.data, csr.shape
    else:
        row_ptr, col_idx, values, shape = csr.row_ptr, csr.col_idx, csr.values, csr.shape
    return (
        np.asarray(row_ptr, np.int64),
        np.asarray(col_idx, np.int64),
        np.asarray(values),
        tuple(shape),
    )


def build_dia(
    csr,
    max_diags: int = MAX_DIAGS,
    min_fill: float = MIN_FILL,
    value_dtype=None,
    layout: str = "interleaved",
) -> Optional[DIAMatrix]:
    """CSR -> DIA, or None when the matrix is not diagonal-structured.

    Host-side vectorised numpy, like :func:`build_csr5` (one-time
    preprocessing). Duplicate (row, col) entries are summed, matching the
    oracle semantics of repeated-coordinate Matrix Market files.
    """
    row_ptr, col_idx, values, (m, n) = _as_host(csr)
    nnz = int(values.shape[0])
    if nnz == 0:
        return None
    m_pad = -(-m // LANES) * LANES
    interleaved = layout == "interleaved"

    # native two-pass build: the numpy route walks three nnz-scale int64
    # temps (repeat'd rows, offsets, unique's sort) and finishes with
    # np.add.at; the native plan+fill are two plain CSR passes (and the
    # plan bails at the (max_diags+1)-th distinct offset, so non-diagonal
    # matrices reject in one cheap scan)
    from ..utils import nativelib

    data = None
    if interleaved and values.dtype == np.float32:
        plan = nativelib.dia_plan(row_ptr, col_idx, m, n, max_diags)
        if plan is not None:
            if isinstance(plan, int):  # -1: more than max_diags offsets
                return None
            uniq = plan
            if nnz < min_fill * len(uniq) * m:
                return None
            data = nativelib.dia_fill(
                row_ptr, col_idx, values, uniq, m, n, m_pad,
                arena="dia:data",
            )
    if data is None:
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
        off = col_idx - rows
        uniq, inv = np.unique(off, return_inverse=True)
        if len(uniq) > max_diags or nnz < min_fill * len(uniq) * m:
            return None
        # np.add.at sums duplicates (scipy .dia_matrix parity); the
        # interleaved layout is scattered into directly (no second
        # nnz-scale buffer for a reshape+transpose)
        if interleaved:
            data = np.zeros((m_pad // LANES, len(uniq), LANES), values.dtype)
            np.add.at(data, (rows >> 7, inv, rows & (LANES - 1)), values)
        else:
            data = np.zeros((len(uniq), m_pad), values.dtype)
            np.add.at(data, (inv, rows), values)
    if value_dtype == "auto":
        # lossless-only bf16 (the bandmm/CSR5 storage gate): DIA's data
        # plane IS its whole stream, so this halves both the upload and
        # the executor's memory traffic (it multiplies in x's precision;
        # exact round-trip => bit-identical results). The gate reads the
        # built plane, where duplicate entries are already summed: two
        # bf16-exact duplicates can sum to a value bf16 cannot hold.
        from .bandmm import _bf16_roundtrip_exact

        value_dtype = None
        if data.dtype == np.float32 and _bf16_roundtrip_exact(data.reshape(-1)):
            import ml_dtypes

            value_dtype = ml_dtypes.bfloat16
    # arena-backed planes MUST upload with a copy (on the CPU backend
    # jnp.asarray can alias the host buffer, which the arena reuses)
    if value_dtype is not None:
        # cast on host (halves the uploaded bytes, not just the stored);
        # arena-bounced against the fresh-mapping first-write pathology
        from ..utils.hostmem import arena_take

        d16 = arena_take(data.shape, np.dtype(value_dtype), "dia:d16",
                         zero=False)
        np.copyto(d16, data, casting="unsafe")
        d = jnp.array(d16)
    else:
        d = jnp.array(data)
    return DIAMatrix(
        shape=(m, n),
        offsets=tuple(int(o) for o in uniq),
        nnz_stored=nnz,
        data=d,
        m_pad=m_pad,
        interleaved=interleaved,
    )


def _data_diag(dia: DIAMatrix) -> jax.Array:
    """(ndiag, m_pad) view of the value planes regardless of layout."""
    if dia.interleaved:
        return dia.data.transpose(1, 0, 2).reshape(dia.ndiag, dia.m_pad)
    return dia.data


def _diag(dia: DIAMatrix, k: int) -> jax.Array:
    """(m_pad,) values of diagonal k, read in place (no layout transpose)."""
    if dia.interleaved:
        return dia.data[:, k, :].reshape(dia.m_pad)
    return dia.data[k]


@jax.jit
def dia_spmm(dia: DIAMatrix, xm: jax.Array, alpha=1.0) -> jax.Array:
    """Y = alpha * A @ X for X (n, R): the value planes are read once for
    all R right-hand sides."""
    m, n = dia.shape
    offs = dia.offsets
    acc_dt = jnp.promote_types(xm.dtype, dia.data.dtype)
    pad_l = max(0, -min(offs))
    pad_r = max(0, dia.m_pad + max(offs) - n)
    xp = jnp.pad(
        (xm * jnp.asarray(alpha, xm.dtype)).astype(acc_dt), ((pad_l, pad_r), (0, 0))
    )
    acc = jnp.zeros((dia.m_pad, xm.shape[1]), acc_dt)
    for k, off in enumerate(offs):
        xs = jax.lax.dynamic_slice(xp, (pad_l + off, 0), (dia.m_pad, xm.shape[1]))
        acc = acc + _diag(dia, k).astype(acc_dt)[:, None] * xs
    return acc[:m].astype(xm.dtype)


@jax.jit
def dia_spmv(dia: DIAMatrix, x: jax.Array, alpha=1.0) -> jax.Array:
    """y = alpha * A @ x. Static offsets keep every slice static:
    y[i] = sum_k data[k,i] * x[i+off_k]. Products and sums are taken in
    x's precision (or the plane's, if wider), never in a bf16 plane's.
    """
    m, n = dia.shape
    offs = dia.offsets
    acc_dt = jnp.promote_types(x.dtype, dia.data.dtype)
    pad_l = max(0, -min(offs))
    pad_r = max(0, dia.m_pad + max(offs) - n)
    xp = jnp.pad((x * jnp.asarray(alpha, x.dtype)).astype(acc_dt), (pad_l, pad_r))
    acc = jnp.zeros(dia.m_pad, acc_dt)
    for k, off in enumerate(offs):
        acc = acc + _diag(dia, k).astype(acc_dt) * jax.lax.dynamic_slice(
            xp, (pad_l + off,), (dia.m_pad,)
        )
    return acc[:m].astype(x.dtype)
