"""Device-side (jittable) CSR -> CSR5 conversion.

The reference converts entirely on-device (``format_cuda.h:97-744``); the
host pipeline in :mod:`.convert` is the right default on this platform
(6 MB/s device->host readback makes device conversion of host data a
loss), but shards that already LIVE on device — the distributed layer,
device-resident solver pipelines — should not round-trip through the
host. This module provides every conversion stage as a jittable
function, composed by :func:`build_csr5_device`.

XLA needs static shapes, so the data-dependent plan parameters (tile
count, window size ``capw``, page-list width ``pmax``, ...) are split
into a tiny host pre-pass, :func:`plan_statics` — the analogue of the
reference's own two-phase reduce-then-build structure
(``format_cuda.h:362-523`` sizes the offset table with a scan before
filling it). Given the same statics, every array produced here matches
the host converter bit-for-bit (tests/test_convert_device.py), so a
distributed program can plan once on host and convert each device-
resident shard under ``jit``/``shard_map`` without any transfer.

Stage-by-stage parity (same mapping as the host pipeline):

==========================================  ===============================
reference kernel                            here
==========================================  ===============================
generate_partition_pointer_s1               ``convert.tile_partition_pointer``
(format_cuda.h:21-42)                       (already jittable)
generate_partition_pointer_s2               ``convert.tile_dirty_flags``
(format_cuda.h:44-95)                       (already jittable)
generate_partition_descriptor_s1/_s2        ``tile_descriptor``
(format_cuda.h:129-267)                     (bit_flag/y_offset/seg_offset)
generate_partition_descriptor_s3+_offset    ``tile_empty_offsets``
(format_cuda.h:269-523)                     (static-width padded table)
aosoa_transpose (format_cuda.h:525-744)     ``tile_payload`` (swapaxes)
(execution plan)                            ``tile_page_lists`` /
                                            ``tile_window_maps`` /
                                            ``packed_columns``
==========================================  ===============================
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CSR5Config, compute_sigma
from ..models.formats import CSR5Matrix
from .convert import (
    CONTIG_PAGE_CAP,
    PAGE_COLS,
    _as_host_csr,
    tile_dirty_flags,
    tile_partition_pointer,
)


class PlanStatics(NamedTuple):
    """Host-known static plan parameters (the shape-bearing scalars XLA
    cannot derive from traced data). Produced by :func:`plan_statics`."""

    config: CSR5Config
    p_pad: int  # padded tile count
    capw: int  # window-map width (slots per tile)
    pmax: int  # page-list width
    pages_contig: bool
    win_rel: bool
    tail_row_start: int
    eo_width: int  # per-tile empty-offset table width (max nseg, dirty)
    m: int
    n: int


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("p", "tile_nnz"))
def tile_heads(row_ptr: jax.Array, p: int, tile_nnz: int) -> jax.Array:
    """(p*tile_nnz,) bool: nonzero begins a row, tile-leading bit forced
    (format_cuda.h:171-175). Index = global element order (pad elements
    past nnz never start a row)."""
    nnz_pad = p * tile_nnz
    nonempty = jnp.diff(row_ptr) > 0
    starts = jnp.where(nonempty, row_ptr[:-1], nnz_pad)  # drop empty rows
    heads = jnp.zeros(nnz_pad, bool)
    heads = heads.at[starts].set(True, mode="drop")
    return heads.at[jnp.arange(p) * tile_nnz].set(True)


@partial(jax.jit, static_argnames=("p", "sigma", "omega"))
def tile_descriptor(heads: jax.Array, p: int, sigma: int, omega: int):
    """bit_flag words + y_offset + seg_offset + per-tile segment counts.

    Jittable parity with the host ``convert._descriptor``
    (format_cuda.h:129-267). ``heads`` is flat (p*sigma*omega,) in element
    order: flat index t*T + l*sigma + s -> reshape (p, omega, sigma).
    """
    fl = heads.reshape(p, omega, sigma)
    nwords = (sigma + 31) // 32
    pad = nwords * 32 - sigma
    bits = jnp.pad(fl, ((0, 0), (0, 0), (0, pad))).reshape(
        p, omega, nwords, 32
    )
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    words = (bits.astype(jnp.uint32) * weights).sum(
        axis=-1, dtype=jnp.uint32
    )  # (p, omega, nwords), bit i of word w = head at s = w*32+i
    bit_flag = words.transpose(0, 2, 1)

    lane_cnt = fl.sum(axis=2, dtype=jnp.int32)  # (p, omega)
    y_offset = jnp.concatenate(
        [
            jnp.zeros((p, 1), jnp.int32),
            jnp.cumsum(lane_cnt[:, :-1], axis=1, dtype=jnp.int32),
        ],
        axis=1,
    )

    # seg_offset: distance-1 to the next flagged lane strictly right
    # (omega-l-1 if none; scansum semantics, format_cuda.h:200-240)
    has = lane_cnt > 0
    lane_or_inf = jnp.where(has, jnp.arange(omega, dtype=jnp.int32), omega)
    # nxt[l] = min_{l' >= l} lane_or_inf[l']: reversed inclusive cummin
    nxt = jnp.flip(
        jax.lax.associative_scan(
            jnp.minimum, jnp.flip(lane_or_inf, axis=1), axis=1
        ),
        axis=1,
    )
    next_flagged = jnp.concatenate(
        [nxt[:, 1:], jnp.full((p, 1), omega, jnp.int32)], axis=1
    )
    seg_offset = jnp.clip(
        next_flagged - jnp.arange(omega, dtype=jnp.int32)[None, :] - 1,
        0,
        omega,
    )
    nseg = lane_cnt.sum(axis=1, dtype=jnp.int32)
    return bit_flag, y_offset, seg_offset, nseg


@partial(jax.jit, static_argnames=("p", "tile_nnz", "eo_width"))
def tile_empty_offsets(
    row_ptr: jax.Array,
    heads: jax.Array,
    dirty: jax.Array,
    tile_ptr: jax.Array,
    p: int,
    tile_nnz: int,
    eo_width: int,
) -> jax.Array:
    """(p, eo_width) int32 padded empty-offset table: entry (t, k) is the
    row offset from tile_ptr[t] of the k-th segment head of dirty tile t
    (parity with format_cuda.h:362-523; the host pipeline stores the same
    values ragged as ``empty_offset_ptr``/``empty_offset``). Slots past
    the tile's segment count (and all slots of clean tiles) hold 0.
    """
    fl = heads.reshape(p, tile_nnz)  # element order within tile
    # global element index of each slot; its row via binary search
    gidx = (
        jnp.arange(p, dtype=jnp.int32)[:, None] * tile_nnz
        + jnp.arange(tile_nnz, dtype=jnp.int32)[None, :]
    )
    rows = (
        jnp.searchsorted(row_ptr.astype(jnp.int64), gidx.astype(jnp.int64), side="right").astype(
            jnp.int32
        )
        - 1
    )
    offs = rows - tile_ptr[:p, None]
    k = jnp.cumsum(fl, axis=1, dtype=jnp.int32) - 1  # ordinal per head
    slot = jnp.where(fl & dirty[:, None], k, eo_width)  # drop non-heads
    out = jnp.zeros((p, eo_width), jnp.int32)
    t_idx = jnp.broadcast_to(jnp.arange(p)[:, None], slot.shape)
    return out.at[t_idx, slot].set(offs, mode="drop")


@partial(
    jax.jit, static_argnames=("p", "tile_nnz", "m", "sigma", "capw", "win_rel")
)
def tile_window_maps(
    row_ptr: jax.Array,
    tile_ptr: jax.Array,
    p: int,
    tile_nnz: int,
    m: int,
    sigma: int,
    capw: int,
    win_rel: bool,
) -> jax.Array:
    """(p, capw) int32 packed monotone row-end maps (sublane | lane<<16),
    wrapped or aligned anchoring — the jittable twin of the host block in
    ``convert.build_csr5``."""
    rs = tile_ptr[:p, None].astype(jnp.int32)
    d = jnp.arange(capw, dtype=jnp.int32)[None, :]
    if win_rel:
        off = rs & 127
        ridx = jnp.minimum(
            (rs - off) + d + jnp.where(d < off, capw, 0) + 1, m
        )
    else:
        ridx = jnp.minimum((rs // 128) * 128 + d + 1, m)
    win_end = jnp.clip(
        row_ptr[ridx].astype(jnp.int64)
        - 1
        - (jnp.arange(p, dtype=jnp.int64) * tile_nnz)[:, None],
        0,
        tile_nnz - 1,
    ).astype(jnp.int32)
    out = (win_end % sigma) | ((win_end // sigma) << 16)
    # flag bits, bit-for-bit with the host conversion and for BOTH
    # anchorings: bit 23 = first-row slot (d == rs%128),
    # bit 24 = d >= rs%128 (see convert.build_csr5)
    off = rs & 127
    return (
        out
        | jnp.where(d >= off, jnp.int32(1 << 24), jnp.int32(0))
        | jnp.where(d == off, jnp.int32(1 << 23), jnp.int32(0))
    )


@partial(
    jax.jit,
    static_argnames=("pmax", "page_sentinel", "contig"),
)
def tile_page_lists(
    col2d: jax.Array, pmax: int, page_sentinel: int, contig: bool
):
    """Per-tile distinct x-page lists from (p, tile_nnz) padded columns.

    Returns (pages (p, pmax) int32, page_cnt (p,) int32). Contig mode
    emits the consecutive range [lo, lo+pmax) like the host pipeline;
    list mode compacts the sorted distinct pages with sentinel padding.
    """
    p = col2d.shape[0]
    ps = jnp.sort(col2d >> 7, axis=1)
    first = jnp.concatenate(
        [
            jnp.ones((p, 1), bool),
            ps[:, 1:] != ps[:, :-1],
        ],
        axis=1,
    )
    page_cnt = first.sum(axis=1, dtype=jnp.int32)
    if contig:
        lo = jnp.minimum(ps[:, 0], page_sentinel + 1 - pmax)
        pages = lo[:, None] + jnp.arange(pmax, dtype=jnp.int32)[None, :]
        return pages, page_cnt
    pos = jnp.cumsum(first.astype(jnp.int32), axis=1) - 1
    slot = jnp.where(first, pos, pmax)  # drop duplicates
    t_idx = jnp.broadcast_to(jnp.arange(p)[:, None], slot.shape)
    pages = jnp.full((p, pmax), page_sentinel, jnp.int32)
    return pages.at[t_idx, slot].set(ps, mode="drop"), page_cnt


@partial(jax.jit, static_argnames=("sigma", "omega", "contig"))
def packed_columns(
    col2d: jax.Array,
    pages: jax.Array,
    sigma: int,
    omega: int,
    contig: bool,
) -> jax.Array:
    """(p, sigma/2, omega) int32 stream-compressed column plane: uint16
    ``lane | local_page<<7`` codes of sigma-row pairs (s, s+sigma/2)
    combined into one word (the host pipeline's col_packed)."""
    p = col2d.shape[0]
    pg = col2d >> 7
    if contig:
        local = pg - pages[:, 0:1]
    else:
        # rank of each element's page in its tile's sorted distinct list
        local = jax.vmap(
            lambda lst, q: jnp.searchsorted(lst, q).astype(jnp.int32)
        )(pages, pg)
    code = (col2d & 127) | (local << 7)  # (p, T) int32 of uint16 codes
    c = code.reshape(p, omega, sigma)
    s2 = sigma // 2
    return (c[:, :, :s2] | (c[:, :, s2:] << 16)).swapaxes(1, 2)


@partial(jax.jit, static_argnames=("sigma", "omega"))
def tile_payload(flat: jax.Array, sigma: int, omega: int) -> jax.Array:
    """AoS->SoA tile transpose on device: flat (p*omega*sigma,) element
    order -> (p, sigma, omega) (format_cuda.h:525-744)."""
    p = flat.shape[0] // (omega * sigma)
    return flat.reshape(p, omega, sigma).swapaxes(1, 2)


# ---------------------------------------------------------------------------
# host pre-pass + orchestrator
# ---------------------------------------------------------------------------


def plan_statics(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    shape,
    config: Optional[CSR5Config] = None,
    win_mode: str = "auto",
) -> PlanStatics:
    """The tiny host pre-pass sizing the static plan parameters.

    Reads only ``row_ptr`` (m+1 int) and the column plane once; the
    reference sizes its offset table with the same reduce-before-build
    split (format_cuda.h:362-523). For distributed use, run once on the
    GLOBAL matrix so every shard shares uniform statics.
    """
    m, n = shape
    nnz = int(len(col_idx))
    if config is None:
        config = CSR5Config(sigma=compute_sigma(m, nnz))
    T = config.tile_nnz
    p = max(1, -(-nnz // T))
    # same small-matrix quantum rule as the host pipeline (bit-for-bit)
    from .convert import _pow2_at_least

    quantum = min(config.tiles_per_block, _pow2_at_least(p, 1))
    p_pad = -(-p // quantum) * quantum

    row_ptr = np.asarray(row_ptr, np.int64)
    bounds = np.arange(p_pad + 1, dtype=np.int64) * T
    tile_ptr = np.clip(np.searchsorted(row_ptr, bounds, side="right") - 1, 0, m)
    span_max = int((tile_ptr[1:] - tile_ptr[:-1]).max())
    win_rel = win_mode != "aligned"
    if win_rel:
        capw = -(-(span_max + 1) // 128) * 128
    else:  # aligned maps (the distributed layer's stackable mode)
        capw = 128
        while capw < span_max + 1 + 128:
            capw *= 2

    n_pad = -(-max(n, 1) // PAGE_COLS) * PAGE_COLS
    page_sentinel = n_pad // PAGE_COLS
    # per-tile page span / distinct count, identical to the host pipeline
    # (pad elements repeat the last real column: no new page)
    col_flat = np.zeros(p_pad * T, dtype=np.int32)
    col_flat[:nnz] = col_idx
    if nnz:
        col_flat[nnz:] = col_flat[nnz - 1]
    from ..utils import nativelib

    plan = nativelib.page_plan(col_flat, p_pad, T, page_sentinel + 1)
    if plan is not None:
        _lo, _cnt, pspan, cnt_max, _ = plan
    else:
        ps = np.sort(col_flat.reshape(p_pad, T) >> 7, axis=1)
        first = np.ones((p_pad, T), dtype=bool)
        first[:, 1:] = ps[:, 1:] != ps[:, :-1]
        pspan = int((ps[:, -1] - ps[:, 0]).max()) + 1
        cnt_max = int(first.sum(axis=1).max())

    contig = pspan <= CONTIG_PAGE_CAP and max(pspan, 2) <= page_sentinel + 1
    pmax = max(pspan, 2) if contig else max(-(-cnt_max // 8) * 8, 2)

    # eo_width: max segments of any dirty tile (0 when no tile is dirty)
    empty = (np.diff(row_ptr) == 0).astype(np.int64)
    e_prefix = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(empty, out=e_prefix[1:])
    start, stop = tile_ptr[:-1], np.minimum(tile_ptr[1:], m - 1)
    dirty = (e_prefix[stop + 1] - e_prefix[np.minimum(start + 1, m)]) > 0
    if dirty.any():
        heads = np.zeros(p_pad * T, dtype=bool)
        nonzero_rows = np.diff(row_ptr) > 0
        heads[row_ptr[:-1][nonzero_rows]] = True
        heads[np.arange(p_pad) * T] = True
        nseg = heads.reshape(p_pad, T).sum(axis=1)
        eo_width = int(nseg[dirty].max())
    else:
        eo_width = 0

    return PlanStatics(
        config=config,
        p_pad=p_pad,
        capw=capw,
        pmax=pmax,
        pages_contig=contig,
        win_rel=win_rel,
        tail_row_start=int(tile_ptr[p - 1]),
        eo_width=eo_width,
        m=m,
        n=n,
    )


def build_csr5_device(
    row_ptr: jax.Array,
    col_idx: jax.Array,
    values: jax.Array,
    statics: PlanStatics,
) -> CSR5Matrix:
    """CSR (device arrays) -> CSR5, all array stages under jit.

    Produces the same CSR5Matrix as the host ``convert.build_csr5`` given
    matching statics (value-exact; tests/test_convert_device.py), except
    the ragged parity table ``empty_offset`` which is stored padded per
    tile (same values; ``empty_offset_ptr`` then counts ``eo_width`` per
    dirty tile). Use :func:`plan_statics` for the host pre-pass.
    """
    cfg = statics.config
    omega, sig = cfg.omega, cfg.sigma
    T = cfg.tile_nnz
    p_pad, m, n = statics.p_pad, statics.m, statics.n
    nnz = int(col_idx.shape[0])
    nnz_pad = p_pad * T

    row_ptr = jnp.asarray(row_ptr).astype(jnp.int64)
    pad_col = col_idx[-1] if nnz else jnp.int32(0)
    col_flat = jnp.full(nnz_pad, pad_col, jnp.int32).at[:nnz].set(col_idx)
    val_flat = jnp.zeros(nnz_pad, values.dtype).at[:nnz].set(values)

    tile_ptr = tile_partition_pointer(row_ptr, p_pad, T)
    dirty = tile_dirty_flags(row_ptr.astype(jnp.int32), tile_ptr)
    heads = tile_heads(row_ptr, p_pad, T)
    bit_flag, y_offset, seg_offset, nseg = tile_descriptor(
        heads, p_pad, sig, omega
    )
    eo_pad = tile_empty_offsets(
        row_ptr, heads, dirty, tile_ptr, p_pad, T, max(statics.eo_width, 1)
    )

    n_pad = -(-max(n, 1) // PAGE_COLS) * PAGE_COLS
    page_sentinel = n_pad // PAGE_COLS
    col2d = col_flat.reshape(p_pad, T)
    pages, page_cnt = tile_page_lists(
        col2d, statics.pmax, page_sentinel, statics.pages_contig
    )
    win_map = tile_window_maps(
        row_ptr, tile_ptr, p_pad, T, m, sig, statics.capw, statics.win_rel
    )
    col_packed = None
    if statics.pmax <= 512 and sig % 16 == 0:
        col_packed = packed_columns(
            col2d, pages, sig, omega, statics.pages_contig
        )

    eo_ptr = jnp.concatenate(
        [
            jnp.zeros(1, jnp.int32),
            jnp.cumsum(
                jnp.where(dirty, eo_pad.shape[1], 0).astype(jnp.int32)
            ),
        ]
    )
    return CSR5Matrix(
        shape=(m, n),
        config=cfg,
        num_tiles=p_pad,
        nnz_stored=nnz,
        row_ptr=row_ptr.astype(jnp.int32),
        tile_ptr=tile_ptr,
        tile_dirty=dirty,
        y_offset=y_offset,
        seg_offset=seg_offset,
        bit_flag=bit_flag,
        empty_offset_ptr=eo_ptr,
        empty_offset=eo_pad.reshape(-1),
        col_idx_tiles=tile_payload(col_flat, sig, omega),
        val_tiles=tile_payload(val_flat, sig, omega),
        pages=pages,
        pages_contig=statics.pages_contig,
        page_cnt=page_cnt,
        win_map=win_map,
        col_packed=col_packed,
        win_rel=statics.win_rel,
        tail_row_start=statics.tail_row_start,
        capw=statics.capw,
        pmax=statics.pmax,
        m_pad=-(-(m + statics.capw + 128) // 1024) * 1024,
        n_pad=n_pad,
    )
