"""Distributed (multi-device) DIA SpMV/SpMM: the structured-matrix fast
path over a device mesh.

The reference is single-device (SURVEY.md section 2.2); the CSR5
distributed layer (``parallel/distributed.py``) covers general matrices.
Diagonal-structured matrices deserve their own distribution because DIA
row-blocks are the *ideal* halo case:

- the interleaved value layout ``(m_pad/128, ndiag, 128)`` row-shards by
  a plain reshape to ``(D, rp/128, ndiag, 128)`` — no per-shard
  re-conversion, no static re-padding, one host scatter total;
- the diagonal offsets are global compile-time statics shared by every
  shard (each shard's executor is the SAME trace — offsets shift by the
  uniform halo width, not by device);
- the x window a row block reads is exactly ``[r0+min_off, r1+max_off)``
  — a single-hop neighbor halo of O(bandwidth) bytes, never the O(n)
  all-gather, whenever the band fits a neighbor shard.

Each shard then runs the unmodified single-device DIA executor
(``ops/dia.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.sharding import Mesh

from ..ops.dia import (
    LANES,
    MAX_DIAGS,
    MIN_FILL,
    DIAMatrix,
    _as_host,
    dia_spmm,
    dia_spmv,
)
from ..utils.hostmem import prefaulted
from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class DistributedDIA:
    """Row-block-partitioned DIA matrix.

    ``data`` is ``(D, rp/128, ndiag, 128)`` sharded on the leading axis;
    ``halo=(H_l, H_r)`` means x is exchanged with two neighbor
    ``ppermute`` halos (lane-rounded widths); ``halo=None`` falls back to
    the full all-gather (x wider than the row grid, or a band too wide for
    single-hop halos)."""

    shape: Tuple[int, int] = static_field()
    offsets: Tuple[int, ...] = static_field()
    nnz_stored: int = static_field()
    num_devices: int = static_field()
    rows_per_shard: int = static_field()
    halo: Optional[Tuple[int, int]] = static_field(default=None)
    data: jax.Array = None

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    def x_bytes_exchanged(self, itemsize: int = 4) -> int:
        """Per-device x bytes received per spmv (halo-vs-gather counter,
        parity with DistributedCSR5.x_bytes_exchanged)."""
        D = self.num_devices
        if self.halo is None:
            n_per = -(-max(self.n, D * self.rows_per_shard) // D)
            return (D - 1) * n_per * itemsize
        return (self.halo[0] + self.halo[1]) * itemsize


def distribute_dia(
    csr,
    mesh: Mesh,
    max_diags: int = MAX_DIAGS,
    min_fill: float = MIN_FILL,
    value_dtype=None,
) -> Optional[DistributedDIA]:
    """CSR -> row-block DIA over ``mesh``, or None when the matrix is not
    diagonal-structured (same gates as :func:`..ops.dia.build_dia`).

    The per-shard row count is rounded to LANES so every shard is a whole
    number of 128-row slabs; the value planes are built once on the host
    (prefaulted scatter) and row-sharded by reshape.
    """
    row_ptr, col_idx, values, (m, n) = _as_host(csr)
    nnz = int(values.shape[0])
    if nnz == 0:
        return None
    D = mesh.devices.size
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))
    off = col_idx - rows
    uniq, inv = np.unique(off, return_inverse=True)
    if len(uniq) > max_diags or nnz < min_fill * len(uniq) * m:
        return None
    rp = -(-m // (D * LANES)) * LANES
    nd = len(uniq)
    data = prefaulted((D * rp // LANES, nd, LANES), values.dtype)
    np.add.at(data, (rows >> 7, inv, rows & (LANES - 1)), values)

    offsets = tuple(int(o) for o in uniq)
    h_l = -(-max(0, -offsets[0]) // LANES) * LANES
    h_r = -(-max(0, offsets[-1]) // LANES) * LANES
    halo: Optional[Tuple[int, int]] = (h_l, h_r)
    if D == 1:
        halo = (0, 0) if n <= rp else None
    elif h_l > rp or h_r > rp or n > D * rp:
        # band wider than a neighbor shard, or x extends beyond the row
        # grid (wide rectangular matrix): single-hop halos can't cover it
        halo = None

    d = jnp.asarray(data.reshape(D, rp // LANES, nd, LANES))
    if value_dtype is not None:
        d = d.astype(value_dtype)
    axis = mesh.axis_names[0]
    d = jax.device_put(d, NamedSharding(mesh, P(axis)))
    return DistributedDIA(
        shape=(m, n),
        offsets=offsets,
        nnz_stored=nnz,
        num_devices=D,
        rows_per_shard=rp,
        halo=halo,
        data=d,
    )


def _halo_widths(dd: DistributedDIA) -> Tuple[int, int]:
    """Lane-rounded [left, right] x window extents; the stored halo in
    halo mode, or recomputed from the offsets for the all-gather path."""
    if dd.halo is not None:
        return dd.halo
    h_l = -(-max(0, -dd.offsets[0]) // LANES) * LANES
    h_r = -(-max(0, dd.offsets[-1]) // LANES) * LANES
    return h_l, h_r


def _local_dia(dd: DistributedDIA, data_local: jax.Array) -> DIAMatrix:
    """The per-shard single-device DIAMatrix: offsets shift by the uniform
    left halo width, so every shard shares ONE trace."""
    h_l, h_r = _halo_widths(dd)
    rp = dd.rows_per_shard
    return DIAMatrix(
        shape=(rp, h_l + rp + h_r),
        offsets=tuple(o + h_l for o in dd.offsets),
        nnz_stored=dd.nnz_stored,
        data=data_local,
        m_pad=rp,
        interleaved=True,
    )


def _exchange_x(dd: DistributedDIA, x_shard, axis, h_l, h_r):
    """Assemble [left halo | own block | right halo] rows of x for this
    shard: two neighbor ppermutes (halo mode) or an all-gather + local
    window slice (fallback). Works for x (rp,) vectors and (rp, R)
    matrices alike (halo slices run along axis 0)."""
    D = dd.num_devices
    rp = dd.rows_per_shard
    if dd.halo is not None:
        fwd = [(i, i + 1) for i in range(D - 1)]
        bwd = [(i + 1, i) for i in range(D - 1)]
        parts = []
        if h_l:
            # edge device 0 receives ppermute zero-fill = zero x padding
            parts.append(jax.lax.ppermute(x_shard[rp - h_l:], axis, fwd))
        parts.append(x_shard)
        if h_r:
            parts.append(jax.lax.ppermute(x_shard[:h_r], axis, bwd))
        return jnp.concatenate(parts) if len(parts) > 1 else x_shard
    # all-gather fallback: whole x on every device, window sliced locally
    x_full = jax.lax.all_gather(x_shard, axis, tiled=True)
    pad = [(h_l, h_r)] + [(0, 0)] * (x_shard.ndim - 1)
    x_pad = jnp.pad(x_full, pad)
    d = jax.lax.axis_index(axis)
    start = (d * rp,) + (0,) * (x_shard.ndim - 1)
    return jax.lax.dynamic_slice(
        x_pad, start, (h_l + rp + h_r,) + x_shard.shape[1:]
    )


def distributed_dia_spmv(
    dd: DistributedDIA,
    x: jax.Array,
    mesh: Mesh,
    alpha=1.0,
) -> jax.Array:
    """y = alpha * A @ x, A row-sharded DIA, x exchanged by neighbor
    halos (or all-gathered when the band demands it)."""
    axis = mesh.axis_names[0]
    D = dd.num_devices
    rp = dd.rows_per_shard
    h_l, h_r = _halo_widths(dd)
    n_x = D * rp if dd.halo is not None else D * (-(-max(dd.n, D * rp) // D))
    x_pad = jnp.zeros(n_x, x.dtype).at[: dd.n].set(x)

    def local_step(data_local, x_shard):
        a = _local_dia(dd, data_local[0])
        x_loc = _exchange_x(dd, x_shard, axis, h_l, h_r)
        return dia_spmv(a, x_loc, alpha)[None]

    y = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
        check_rep=False,
    )(dd.data, x_pad)
    return y.reshape(-1)[: dd.m]


def distributed_dia_spmm(
    dd: DistributedDIA,
    xm: jax.Array,
    mesh: Mesh,
    alpha=1.0,
) -> jax.Array:
    """Y = alpha * A @ X for X (n, R): the value planes stream once per
    shard and re-use across all R right-hand sides; the halo exchange
    moves (H_l+H_r)*R elements per device instead of (D-1)*n_per*R."""
    axis = mesh.axis_names[0]
    D = dd.num_devices
    rp = dd.rows_per_shard
    R = xm.shape[1]
    h_l, h_r = _halo_widths(dd)
    n_x = D * rp if dd.halo is not None else D * (-(-max(dd.n, D * rp) // D))
    x_pad = jnp.zeros((n_x, R), xm.dtype).at[: dd.n].set(xm)

    def local_step(data_local, x_shard):
        a = _local_dia(dd, data_local[0])
        x_loc = _exchange_x(dd, x_shard, axis, h_l, h_r)
        return dia_spmm(a, x_loc, alpha)[None]

    y = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
        check_rep=False,
    )(dd.data, x_pad)
    return y.reshape(-1, R)[: dd.m]
