"""HYB5: the hybrid DIA + CSR5 format.

The reference *declares* ``ANONYMOUSLIB_FORMAT_HYB5 = 2``
(CSR5_cuda/detail/common.h:21) but never implements it; this module
builds it. Nonzeros on *dense* diagonals (fill ratio above ``diag_fill``)
execute through the DIA executor's static shifts (no column stream, no
gather); the irregular remainder goes through the general CSR5 executor;
``y = A_dia x + A_csr5 x``. This is the classic structured+scattered
split (cf. ELL+COO "HYB" on GPUs).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CSR5Config
from ..models.formats import CSR5Matrix
from ..utils.pytree import pytree_dataclass, static_field
from .convert import build_csr5
from .csr5_spmv import csr5_spmm_xla, csr5_spmv_xla
from .dia import LANES, MAX_DIAGS, DIAMatrix, dia_spmm, dia_spmv


@pytree_dataclass
class HYBMatrix:
    """DIA part + CSR5 part; either may be None (degenerate splits)."""

    shape: Tuple[int, int] = static_field()
    nnz_stored: int = static_field()
    dia: Optional[DIAMatrix] = None
    csr5: Optional[CSR5Matrix] = None

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.nnz_stored


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


def build_hyb(
    csr,
    diag_fill: float = 0.5,
    max_diags: int = MAX_DIAGS,
    config: Optional[CSR5Config] = None,
) -> HYBMatrix:
    """Split nonzeros into dense diagonals (DIA) and the rest (CSR5).

    A diagonal is "dense" when it holds at least ``diag_fill`` of its
    maximum possible length; the densest ``max_diags`` qualify. Either
    side may come out empty (pure-banded -> no CSR5 part, unstructured
    -> no DIA part), in which case the corresponding field is None.
    """
    row_ptr, col_idx, values, (m, n) = _as_host(csr)
    nnz = int(values.shape[0])
    if nnz == 0:
        return HYBMatrix(shape=(m, n), nnz_stored=0)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
    off = col_idx - rows
    uniq, inv, counts = np.unique(off, return_inverse=True, return_counts=True)
    # max length of diagonal o on an (m, n) matrix
    length = np.minimum(m, n - uniq) - np.maximum(0, -uniq)
    fill = counts / np.maximum(length, 1)
    dense = fill >= diag_fill
    if dense.sum() > max_diags:
        cut = np.sort(fill[dense])[::-1][max_diags - 1]
        dense &= fill >= cut
        # ties may still exceed the cap: keep the first max_diags
        keep_idx = np.flatnonzero(dense)[:max_diags]
        dense = np.zeros_like(dense)
        dense[keep_idx] = True

    on_dia = dense[inv]
    dia = None
    if on_dia.any():
        sel = np.flatnonzero(on_dia)
        d_rows = rows[sel]
        d_off = off[sel]
        d_uniq = uniq[dense]
        m_pad = -(-m // LANES) * LANES
        # interleaved (m_pad/128, ndiag, 128) layout (see DIAMatrix),
        # scattered into directly
        data = np.zeros((m_pad // LANES, len(d_uniq), LANES), values.dtype)
        k = np.searchsorted(d_uniq, d_off)
        np.add.at(data, (d_rows >> 7, k, d_rows & (LANES - 1)), values[sel])
        dia = DIAMatrix(
            shape=(m, n),
            offsets=tuple(int(o) for o in d_uniq),
            nnz_stored=int(len(sel)),
            data=jnp.asarray(data),
            m_pad=m_pad,
            interleaved=True,
        )

    csr5 = None
    if not on_dia.all():
        keep = ~on_dia
        r_rows = rows[keep]
        counts_r = np.bincount(r_rows, minlength=m)
        rp2 = np.zeros(m + 1, np.int64)
        np.cumsum(counts_r, out=rp2[1:])
        csr5 = build_csr5(
            (rp2, col_idx[keep].astype(np.int32), values[keep], (m, n)),
            config,
        )

    return HYBMatrix(shape=(m, n), nnz_stored=nnz, dia=dia, csr5=csr5)


def hyb_spmv(h: HYBMatrix, x: jax.Array, alpha=1.0) -> jax.Array:
    """y = alpha * A @ x = DIA part + CSR5 part."""
    parts = []
    if h.dia is not None:
        parts.append(dia_spmv(h.dia, x, alpha))
    if h.csr5 is not None:
        parts.append(csr5_spmv_xla(h.csr5, x, alpha))
    if not parts:
        return jnp.zeros(h.m, x.dtype)
    return sum(parts[1:], parts[0])


def hyb_spmm(h: HYBMatrix, x: jax.Array, alpha=1.0) -> jax.Array:
    """Y = alpha * A @ X for X (n, R): DIA part + CSR5 part."""
    parts = []
    if h.dia is not None:
        parts.append(dia_spmm(h.dia, x, alpha))
    if h.csr5 is not None:
        parts.append(csr5_spmm_xla(h.csr5, x, alpha))
    if not parts:
        return jnp.zeros((h.m, x.shape[1]), x.dtype)
    return sum(parts[1:], parts[0])
