"""Distributed (multi-chip / multi-host) CSR5 SpMV.

The reference is single-device (SURVEY.md section 2.2); this layer is the
new capability mandated by BASELINE.json: row-block partitioning of the
matrix across a ``jax.sharding.Mesh``, with the x vector exchanged by an
in-``shard_map`` all-gather (or neighbor halos), and y produced row-sharded.

Design (scaling-book style): 1-D mesh axis ``"rows"``; A's rows are split
into contiguous blocks (one per device); each device holds the CSR5 tiles
of its block (padded to a common static tile count so the stacked plan is
one array with a leading device axis). x is row-sharded; inside the
shard_map each device all-gathers x, runs the single-device CSR5 executor
on its local tiles, and emits its y block. Collectives ride the mesh axis
(NCCL on GPUs).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import AUTO_TUNED_SIGMA, CSR5Config, compute_sigma
from ..models.formats import CSR5Matrix, CSRMatrix, csr_from_numpy
from ..ops.convert import build_csr5
from ..ops.csr5_spmv import csr5_spmm_xla, csr5_spmv_xla
from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class DistributedCSR5:
    """Row-block-partitioned CSR5: every plan array gains a leading device
    axis; statics are uniform across shards (padded to the max).

    ``halo``: None => x is exchanged with a full all-gather; (H_l, H_r)
    => every shard was built over the column window
    [d*n_per - H_l, (d+1)*n_per + H_r) and x is exchanged with two
    neighbor ``ppermute`` halos instead (O(H) bytes, not O(n))."""

    shape: Tuple[int, int] = static_field()
    config: CSR5Config = static_field()
    num_devices: int = static_field()
    rows_per_shard: int = static_field()
    halo: Optional[Tuple[int, int]] = static_field(default=None)
    local: CSR5Matrix = None  # all leaves stacked: (D, ...)

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    def x_bytes_exchanged(self, itemsize: int = 4) -> int:
        """Per-device x bytes received during one spmv: the observability
        counter for the halo-vs-all-gather reduction."""
        D = self.num_devices
        n_per = -(-self.n // D)
        if self.halo is None:
            return (D - 1) * n_per * itemsize  # all-gather receives
        return (self.halo[0] + self.halo[1]) * itemsize


def make_mesh(n_devices: Optional[int] = None, axis: str = "rows") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def _pad_shard_statics(shards: Sequence[CSR5Matrix]) -> Sequence[CSR5Matrix]:
    """Re-pad every shard to common (p, capw, pmax) statics so they stack."""
    p = max(s.num_tiles for s in shards)
    capw = max(s.capw for s in shards)
    pmax = max(s.pmax for s in shards)
    m_pad = max(s.m_pad for s in shards)
    n_pad = max(s.n_pad for s in shards)
    # contiguous-page mode only survives stacking when every shard uses it
    # with the same page-range width (pages[t] = pages[t,0] + arange(pmax))
    contig = all(s.pages_contig for s in shards) and all(
        s.pmax == pmax for s in shards
    )
    # the packed column plane survives stacking only if every shard has it
    # (the per-element local page indices stay valid under the slot-axis
    # sentinel padding and the contig->list demotion: both preserve each
    # page's rank in the tile's list)
    packed = all(s.col_packed is not None for s in shards)
    # the raw column plane may have been dropped at conversion (upload
    # compression); if the packed plane does not survive stacking, decode
    # the missing raw planes (exact inverse) so the executors keep a
    # column source. When packed survives, a uniformly-None raw plane is
    # fine — every executor goes through col_tiles_of / col_packed.
    raw = all(s.col_idx_tiles is not None for s in shards)
    if not raw and not packed:
        from ..models.formats import col_tiles_of

        shards = [
            s
            if s.col_idx_tiles is not None
            else dataclasses.replace(s, col_idx_tiles=col_tiles_of(s))
            for s in shards
        ]
        raw = True
    out = []
    for s in shards:
        dp = p - s.num_tiles
        sig, om = s.sigma, s.omega

        def padp(a, fill=0):  # pad leading tile axis
            w = [(0, dp)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, w, constant_values=fill)

        wpad = capw - s.capw
        # extend window maps monotonically (repeat last element => zero diff)
        win_map = jnp.pad(s.win_map, ((0, dp), (0, wpad)), mode="edge")
        out.append(
            dataclasses.replace(
                s,
                num_tiles=p,
                capw=capw,
                pmax=pmax,
                m_pad=m_pad,
                n_pad=n_pad,
                # per-shard data statics must be uniform to stack; the
                # executors only use them for final slicing, which the
                # distributed wrapper does itself
                nnz_stored=p * sig * om,
                tail_row_start=0,
                tile_ptr=jnp.pad(s.tile_ptr, (0, dp), mode="edge"),
                tile_dirty=padp(s.tile_dirty),
                y_offset=padp(s.y_offset),
                seg_offset=padp(s.seg_offset),
                bit_flag=padp(s.bit_flag),
                empty_offset_ptr=jnp.pad(s.empty_offset_ptr, (0, dp), mode="edge"),
                col_idx_tiles=padp(s.col_idx_tiles) if raw else None,
                val_tiles=padp(s.val_tiles),
                col_packed=padp(s.col_packed) if packed else None,
                # tile-axis pads use page 0 (padded tiles have all
                # val==0); slot-axis pads use the sentinel page
                pages=jnp.pad(
                    jnp.pad(s.pages, ((0, dp), (0, 0))),
                    ((0, 0), (0, pmax - s.pmax)),
                    constant_values=n_pad // 128,
                ),
                page_cnt=padp(s.page_cnt),
                win_map=win_map,
                pages_contig=contig,
            )
        )
    return out


def _stack_shards(shards: Sequence[CSR5Matrix]) -> CSR5Matrix:
    eo_max = max(s.empty_offset.shape[0] for s in shards) or 1
    shards = [
        dataclasses.replace(
            s,
            empty_offset=jnp.pad(s.empty_offset, (0, eo_max - s.empty_offset.shape[0]))
        )
        for s in shards
    ]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *shards)


def _halo_widths(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    m: int,
    D: int,
    rows_per: int,
    n_per: int,
) -> Optional[Tuple[int, int]]:
    """(H_l, H_r) such that shard d only reads x columns inside
    [d*n_per - H_l, (d+1)*n_per + H_r), or None when a single-hop halo
    cannot cover the spread (H would exceed a neighbor shard)."""
    hl = hr = 0
    for d in range(D):
        r0, r1 = d * rows_per, min((d + 1) * rows_per, m)
        if r0 >= r1:
            continue
        lo, hi = int(row_ptr[r0]), int(row_ptr[r1])
        if lo >= hi:
            continue
        cmin = int(col_idx[lo:hi].min())
        cmax = int(col_idx[lo:hi].max())
        hl = max(hl, d * n_per - cmin)
        hr = max(hr, cmax + 1 - (d + 1) * n_per)
    hl, hr = max(hl, 0), max(hr, 0)
    # round to the 128-lane grain so every shard's column window (and so
    # its page structure) stays lane-aligned; check the neighbor-shard
    # bound AFTER rounding (a rounded halo > n_per would slice negative
    # lengths out of the neighbor's x shard in distributed_spmv)
    hl = -(-hl // 128) * 128
    hr = -(-hr // 128) * 128
    if hl > n_per or hr > n_per:
        return None  # needs columns beyond the nearest neighbor's shard
    return (hl, hr)


def _convert_shards_on_device(shard_csrs, cfg: CSR5Config, mesh: Mesh):
    """All shards converted ON THEIR OWN DEVICES under one shard_map.

    The raw per-shard CSR arrays (padded to a uniform nnz) are placed
    row-sharded, then every device runs the jittable conversion
    (ops/convert_device.build_csr5_device) on its resident shard — one
    trace, D parallel conversions, zero host round-trips after the
    upload. Statics come from a host pre-pass (plan_statics per shard,
    unified to the max — the same reduce-before-build split the
    reference uses to size its offset table, format_cuda.h:362-523).
    Returns None when the shards cannot share uniform statics (mixed
    gather modes / page-list widths); the caller then takes the host
    pipeline + repad path.
    """
    from ..ops.convert_device import (
        PlanStatics,
        build_csr5_device,
        plan_statics,
    )

    stats = [
        plan_statics(rp, ci, shp, cfg, win_mode="aligned")
        for rp, ci, _v, shp in shard_csrs
    ]
    if len({(s.pages_contig, s.pmax) for s in stats}) != 1:
        return None
    uni = PlanStatics(
        config=cfg,
        p_pad=max(s.p_pad for s in stats),
        capw=max(s.capw for s in stats),
        pmax=stats[0].pmax,
        pages_contig=stats[0].pages_contig,
        win_rel=False,
        tail_row_start=0,
        eo_width=max(s.eo_width for s in stats),
        m=shard_csrs[0][3][0],
        n=max(shp[1] for _rp, _ci, _v, shp in shard_csrs),
    )

    # pad every shard to one nnz (pad cols repeat the shard's last real
    # column, pad values are zero — byte-for-byte the convention
    # build_csr5_device itself uses for its tile padding)
    nnz_max = max(len(ci) for _rp, ci, _v, _s in shard_csrs)
    vdt = shard_csrs[0][2].dtype
    rp_s, ci_s, v_s = [], [], []
    for rp, ci, v, _shp in shard_csrs:
        pad = nnz_max - len(ci)
        last = ci[-1] if len(ci) else np.int32(0)
        ci_s.append(np.concatenate([ci, np.full(pad, last, np.int32)]))
        v_s.append(np.concatenate([v, np.zeros(pad, vdt)]))
        rp_s.append(np.asarray(rp, np.int64))

    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis))
    rp_d = jax.device_put(np.stack(rp_s), sharding)
    ci_d = jax.device_put(np.stack(ci_s), sharding)
    v_d = jax.device_put(np.stack(v_s), sharding)

    def local_convert(rp, ci, v):
        a5 = build_csr5_device(rp[0], ci[0], v[0], uni)
        return jax.tree.map(lambda a: a[None], a5)

    return shard_map(
        local_convert,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_rep=False,
    )(rp_d, ci_d, v_d)


def distribute_csr(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape: Tuple[int, int],
    mesh: Mesh,
    sigma: int = AUTO_TUNED_SIGMA,
    halo: str = "none",
    convert: str = "host",
) -> DistributedCSR5:
    """Partition A into contiguous row blocks (one per mesh device) and
    convert each block to CSR5 with uniform static shapes.

    ``halo``: "none" => shards address the full x (exchanged by
    all-gather). "auto" => when the matrix's column spread allows a
    single-hop halo cheaper than the gather (banded / stencil / RCM-
    reordered), shards are built over per-device column windows and x is
    exchanged with two neighbor ppermutes (see ``distributed_spmv``).

    ``convert``: "host" (default) converts each shard with the host
    pipeline and uploads the finished planes. "device" uploads the RAW
    per-shard CSR arrays and runs the jittable conversion
    (ops/convert_device.build_csr5_device) under ONE shard_map — every
    device converts its own resident shard in parallel with no host
    round-trip, the multi-chip analogue of the reference's all-on-device
    asCSR5 (format_cuda.h:97-744). Falls back to "host" when the
    per-shard plans cannot share uniform statics (mixed gather modes).
    """
    m, n = shape
    D = mesh.devices.size
    rows_per = -(-m // D)
    sig = compute_sigma(m, len(values), sigma)
    cfg = CSR5Config(sigma=sig)
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)

    halo_wid = None
    if halo == "auto" and D > 1:
        n_per = -(-n // D)
        hw = _halo_widths(row_ptr, col_idx, m, D, rows_per, n_per)
        # only worth the window build when it moves fewer x bytes than
        # the all-gather would
        if hw is not None and hw[0] + hw[1] < (D - 1) * n_per:
            halo_wid = hw

    shard_csrs = []  # host (row_ptr, col_idx, values, (rows_per, n_loc))
    for d in range(D):
        if halo_wid is not None:
            n_per = -(-n // D)
            c0 = d * n_per - halo_wid[0]
            n_loc = n_per + halo_wid[0] + halo_wid[1]
        else:
            c0, n_loc = 0, n
        r0, r1 = d * rows_per, min((d + 1) * rows_per, m)
        if r0 >= m:
            # empty shard: one padded tile
            shard_csrs.append(
                (
                    np.zeros(rows_per + 1, np.int64),
                    np.zeros(0, np.int32),
                    np.zeros(0, values.dtype),
                    (rows_per, n_loc),
                )
            )
            continue
        lo, hi = int(row_ptr[r0]), int(row_ptr[r1])
        lrp = np.zeros(rows_per + 1, dtype=np.int64)
        lrp[: r1 - r0 + 1] = np.asarray(row_ptr[r0 : r1 + 1]) - lo
        lrp[r1 - r0 + 1 :] = lrp[r1 - r0]
        cols = np.asarray(col_idx[lo:hi], np.int32)
        if c0:
            cols = cols - np.int32(c0)
        shard_csrs.append((lrp, cols, values[lo:hi], (rows_per, n_loc)))

    stacked = None
    if convert == "device":
        stacked = _convert_shards_on_device(shard_csrs, cfg, mesh)
    if stacked is None:
        # aligned window maps: shards must share one window anchoring to
        # stack (a shard with small row spans would otherwise pick the
        # relative mode while another picks aligned). A 1-device mesh has
        # no cross-shard padding, so it keeps the wrapped mode (what the
        # dist1 bench case measures).
        wm = "aligned" if D > 1 else "auto"
        shards = [
            build_csr5(csr_from_numpy(*c), cfg, win_mode=wm)
            for c in shard_csrs
        ]
        stacked = _stack_shards(_pad_shard_statics(shards))
        axis = mesh.axis_names[0]
        sharding = NamedSharding(mesh, P(axis))
        stacked = jax.tree.map(
            lambda a: jax.device_put(a, sharding), stacked
        )
    return DistributedCSR5(
        shape=shape,
        config=cfg,
        num_devices=D,
        rows_per_shard=rows_per,
        halo=halo_wid,
        local=stacked,
    )


def distributed_spmv(
    da: DistributedCSR5, x: jax.Array, mesh: Mesh, alpha=1.0
) -> jax.Array:
    """y = alpha * A @ x with A row-sharded and x gathered over the mesh.

    x arrives row-sharded over the mesh axis (length padded to D*ceil(n/D));
    each shard all-gathers x (or receives its neighbor halos), applies its
    local CSR5 tiles, and returns its y row block.
    """
    axis = mesh.axis_names[0]
    D = da.num_devices
    n_per = -(-da.n // D)
    x_pad = jnp.zeros(n_per * D, x.dtype).at[: da.n].set(x)
    halo = da.halo

    def local_step(local_a5: CSR5Matrix, x_shard: jax.Array) -> jax.Array:
        # squeeze the leading device axis shard_map leaves on each leaf
        a5 = jax.tree.map(lambda a: a[0], local_a5)
        if halo is not None:
            # neighbor halos: O(H) bytes instead of the O(n)
            # all-gather; shard d was built over the column window
            # [d*n_per - H_l, (d+1)*n_per + H_r), so its x is
            # [left tail | own shard | right head]. Edge devices receive
            # ppermute's zero-fill, matching the window's zero padding.
            h_l, h_r = halo
            from_left = jax.lax.ppermute(
                x_shard[n_per - h_l :] if h_l else x_shard[:0],
                axis,
                [(i, i + 1) for i in range(D - 1)],
            )
            from_right = jax.lax.ppermute(
                x_shard[:h_r],
                axis,
                [(i + 1, i) for i in range(D - 1)],
            )
            x_full = jnp.concatenate([from_left, x_shard, from_right])
        else:
            x_full = jax.lax.all_gather(x_shard, axis, tiled=True)[: da.n]
        return csr5_spmv_xla(a5, x_full, alpha)[None]

    y = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis),
        check_rep=False,
    )(da.local, x_pad)
    return y.reshape(-1)[: da.m]


def distributed_spmm(
    da: DistributedCSR5,
    xm: jax.Array,
    mesh: Mesh,
    alpha=1.0,
) -> jax.Array:
    """Y = alpha * A @ X with A row-sharded and the RHS columns sharded.

    The 2D decomposition of BASELINE.json configs[3] ("SpMM ... multi-chip
    with sharded RHS") on a 1D mesh, executed as a SUMMA-style ring: each
    of the D steps applies the local A row block to the currently-held
    X column shard, then ``ppermute``s the shards one hop around the mesh,
    so the collective can overlap the next step's compute. After D steps
    every device holds its Y row block for ALL right-hand sides; no final
    gather is needed.
    """
    if da.halo is not None:
        raise ValueError(
            "distributed_spmm needs full-x shards; build with halo='none'"
        )
    axis = mesh.axis_names[0]
    D = da.num_devices
    n, R = xm.shape[0], xm.shape[1]
    r_per = -(-R // D)
    x_pad = jnp.zeros((n, r_per * D), xm.dtype).at[:, :R].set(xm)

    perm = [(i, (i + 1) % D) for i in range(D)]

    def local_step(local_a5: CSR5Matrix, x_shard: jax.Array) -> jax.Array:
        a5 = jax.tree.map(lambda a: a[0], local_a5)
        my = jax.lax.axis_index(axis).astype(jnp.int32)
        m_local = da.rows_per_shard
        y_rows = jnp.zeros((m_local, r_per * D), x_shard.dtype)
        xs = x_shard
        for t in range(D):
            # after t hops this device holds the shard of device my - t
            src = jax.lax.rem(my - t + D, jnp.int32(D)).astype(jnp.int32)
            y_loc = csr5_spmm_xla(a5, xs, alpha)[:m_local]
            y_rows = jax.lax.dynamic_update_slice(
                y_rows, y_loc, (jnp.int32(0), src * jnp.int32(r_per))
            )
            if t + 1 < D:
                xs = jax.lax.ppermute(xs, axis, perm)
        return y_rows[None]

    y = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(axis), P(None, axis)),
        out_specs=P(axis),
        check_rep=False,
    )(da.local, x_pad)
    # (D, m_local, R_pad) row blocks -> (m, R)
    return y.reshape(-1, r_per * D)[: da.m, :R]
