"""CSR5 SpMV/SpMM executor.

:func:`csr5_spmv_xla` implements the tile/prefix/window decomposition of
the reference's three-kernel pipeline (``spmv_csr5_compute_kernel`` +
``spmv_csr5_calibrate_kernel`` + ``spmv_csr5_tail_partition_kernel``,
csr5_spmv_cuda.h:275-419) with stock XLA operations: an x gather per
element, a per-tile inclusive prefix sum, a routed window extraction at
every row end, and a scatter-add of the row windows into y (which takes
the calibrator's place). It is the only executor; ``csr5_spmv`` is its
reference-API name.

Both compute ``y = alpha * A @ x`` like ``anonymouslibHandle::spmv``
(anonymouslib_cuda.h:262-285). The scatter-add may run as atomics, so the
order of the partial sums of a row that spans tiles is not fixed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.formats import CSR5Matrix, col_tiles_of


@jax.jit
def csr5_spmv_xla(a5: CSR5Matrix, x: jax.Array, alpha=1.0) -> jax.Array:
    """y = alpha * A @ x over the CSR5 tiles (see the module docstring)."""
    p = a5.num_tiles
    sig, omega = a5.sigma, a5.omega
    T = sig * omega
    m = a5.m

    xg = jnp.take(x, col_tiles_of(a5).reshape(-1), fill_value=0).reshape(
        p, sig, omega
    )
    prod = (a5.val_tiles * xg).astype(x.dtype)

    # tile-local inclusive prefix in element order (lane-major)
    elem = jnp.swapaxes(prod, 1, 2).reshape(p, T)  # [t, l*sig + s]
    P = jnp.cumsum(elem, axis=1)

    # routed window extraction: W_end[t, d] = P[t, win_end[t, d]]
    # (lane bits are 16-22; wrapped maps carry wrap-flag bits at 23/24)
    win_end = ((a5.win_map >> 16) & 127) * sig + (a5.win_map & 0xFFFF)
    # (a vmapped take, not take_along_axis, which widens indices to int64
    # under x64)
    W_end = jax.vmap(lambda r, i: jnp.take(r, i, mode="clip"))(
        P, win_end
    )

    rs = a5.tile_ptr[:-1]
    base = (rs // 128) * 128
    a = (rs - base)[:, None]  # (p, 1)
    # int32 indices whether or not x64 is enabled
    d = jnp.arange(a5.capw, dtype=jnp.int32)[None, :]
    if a5.win_rel:
        # wrapped maps (ops/convert.py): slot d = row base+d for
        # d >= rs%128, else base+capw+d; the wrap seam is consecutive rows
        W_prev = jnp.where(d == a, 0.0, jnp.roll(W_end, 1, axis=1))
        W2 = W_end - W_prev
        rows = base[:, None] + d + (d < a).astype(jnp.int32) * a5.capw
    else:
        # aligned maps: mask slots before the tile's first row
        W_prev = jnp.concatenate(
            [jnp.zeros((p, 1), P.dtype), W_end[:, :-1]], axis=1
        )
        W_prev = jnp.where(d - 1 >= a, W_prev, 0.0)
        W2 = jnp.where(d >= a, W_end - W_prev, 0.0)
        rows = base[:, None] + d  # (p, capw), all < m_pad
    y_pad = jnp.zeros(a5.m_pad, x.dtype).at[rows.reshape(-1)].add(W2.reshape(-1))
    return (alpha * y_pad[:m]).astype(x.dtype)


#: the reference-API name of the executor (anonymouslib_cuda.h:262-285)
csr5_spmv = csr5_spmv_xla


@jax.jit
def csr5_spmm_xla(a5: CSR5Matrix, x: jax.Array, alpha=1.0) -> jax.Array:
    """Y = alpha * A @ X for X (n, R), vmapped over right-hand sides."""
    return jax.vmap(
        lambda col: csr5_spmv_xla(a5, col, alpha), in_axes=1, out_axes=1
    )(x)


#: multi-rhs entry point (the reference has no SpMM)
csr5_spmm = csr5_spmm_xla
