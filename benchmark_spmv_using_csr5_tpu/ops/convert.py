"""CSR <-> CSR5 conversion (the asCSR5 / asCSR analogue).

Re-designs the reference conversion pipeline
(``anonymouslibHandle::asCSR5``, ``CSR5_cuda/anonymouslib_cuda.h:106-220``;
kernels in ``CSR5_cuda/detail/cuda/format_cuda.h``) as fully vectorised
array transforms. Stage-by-stage correspondence:

==========================================  ===============================
reference kernel                            here
==========================================  ===============================
generate_partition_pointer_s1 (binary       ``tile_partition_pointer``
search, format_cuda.h:21-42)                (searchsorted; jittable)
generate_partition_pointer_s2 (empty-row    ``tile_dirty_flags``
dirty bit, format_cuda.h:44-95)             (prefix-count of empty rows)
generate_partition_descriptor_s1 (bit       ``_descriptor`` (vectorised
flags via atomicOr, format_cuda.h:129-159)  scatter + packbits)
generate_partition_descriptor_s2            ``_descriptor`` (popcount
(y_offset/scansum via warp scan,            prefix + next-flagged-lane
format_cuda.h:161-267)                      distance)
generate_partition_descriptor_s3 +          ``_empty_offsets``
_offset (empty-row indirection,             (vectorised searchsorted)
format_cuda.h:269-523)
aosoa_transpose (smem tile transpose,       reshape (p, omega, sigma) ->
format_cuda.h:525-744)                      swapaxes -> (p, sigma, omega)
==========================================  ===============================

On top of the parity metadata, the conversion emits the *execution
plan*: per-tile distinct 128-column x-page lists (the code book of the
packed column plane) and monotone row-end window maps for the segmented
sum. Both are pure derivations of (row_ptr, col_idx, omega, sigma).

The driver is host-side vectorised numpy (conversion is one-time
preprocessing, exactly like the reference's asCSR5 phase, and ragged
outputs -- empty_offset, page lists -- need data-dependent shapes that jit
cannot produce in one pass). The hot sub-steps also exist as jitted JAX
functions for on-device use; ``convert_timings`` reports the same phase
breakdown the reference prints (anonymouslib_cuda.h:211-214).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AUTO_TUNED_SIGMA, CSR5Config, compute_sigma
from ..models.formats import CSR5Matrix, CSRMatrix
from ..utils import progress
from ..utils.hostmem import arena_take

#: columns per x-page
PAGE_COLS = 128
#: max page span for the contiguous-pages mode (every tile's pages are
#: one consecutive range)
CONTIG_PAGE_CAP = 8


# ---------------------------------------------------------------------------
# jittable parity stages
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("num_tiles", "tile_nnz"))
def tile_partition_pointer(row_ptr: jax.Array, num_tiles: int, tile_nnz: int) -> jax.Array:
    """tile_ptr[t] = row containing nonzero t*tile_nnz.

    Parity with generate_partition_pointer_s1_kernel (format_cuda.h:21-42):
    binary-search the right boundary of row_ptr for each tile boundary.
    """
    bounds = jnp.arange(num_tiles + 1, dtype=jnp.int64) * tile_nnz
    idx = jnp.searchsorted(row_ptr.astype(jnp.int64), bounds, side="right") - 1
    return jnp.clip(idx, 0, row_ptr.shape[0] - 1).astype(jnp.int32)


@jax.jit
def tile_dirty_flags(row_ptr: jax.Array, tile_ptr: jax.Array) -> jax.Array:
    """dirty[t] = tile's row range contains an empty row.

    Parity with generate_partition_pointer_s2_kernel (format_cuda.h:44-95,
    dirty-bit mask at :92). The row owning the tile's first nonzero is never
    empty, so only rows in [tile_ptr[t]+1, min(tile_ptr[t+1], m-1)] matter —
    the same clamped range the host conversion uses (build_csr5), so the two
    stages agree element-for-element (tests/test_convert.py).
    """
    m = row_ptr.shape[0] - 1
    empty = (jnp.diff(row_ptr) == 0).astype(jnp.int32)
    e_prefix = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(empty)])
    start = tile_ptr[:-1]
    stop = jnp.minimum(tile_ptr[1:], m - 1)
    return (e_prefix[stop + 1] - e_prefix[jnp.minimum(start + 1, m)]) > 0


# ---------------------------------------------------------------------------
# host-side vectorised conversion
# ---------------------------------------------------------------------------


#: phase timings (ms) of the most recent build_csr5 call -- the
#: malloc/tile_ptr/tile_desc/transpose breakdown the reference prints
#: (anonymouslib_cuda.h:211-214)
last_convert_phases: dict = {}


def _pow2_at_least(x: int, lo: int) -> int:
    v = lo
    while v < x:
        v *= 2
    return v


def _descriptor(
    heads: np.ndarray, p: int, sigma: int, omega: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """bit_flag words + y_offset + seg_offset + per-tile segment counts.

    heads: (p*sigma*omega,) bool, True where a nonzero begins a row, with
    the tile-leading bit forced (format_cuda.h:161-267 semantics).
    Element (t, s, l) = flat t*T + l*sigma + s, so reshape to (p, omega,
    sigma): lane-major element order.
    """
    fl = heads.reshape(p, omega, sigma)
    # pack along sigma into ceil(sigma/32) uint32 words per lane
    nwords = (sigma + 31) // 32
    pad = nwords * 32 - sigma
    bits = np.ascontiguousarray(np.pad(fl, ((0, 0), (0, 0), (0, pad))))
    words = np.packbits(bits, axis=-1, bitorder="little")  # (p,om,nwords*4) u8
    words = words.view(np.uint32)  # (p, omega, nwords), little-endian host
    bit_flag = words.transpose(0, 2, 1)  # (p, nwords, omega)

    lane_cnt = fl.sum(axis=2, dtype=np.int32)  # (p, omega)
    y_offset = np.zeros_like(lane_cnt)
    np.cumsum(lane_cnt[:, :-1], axis=1, out=y_offset[:, 1:])

    # seg_offset: distance-1 to the next lane (to the right) holding any
    # flag; omega-l-1 if none (scansum semantics, format_cuda.h:200-240)
    has = lane_cnt > 0  # (p, omega)
    nxt = np.full((p, omega + 1), omega, dtype=np.int32)
    for l in range(omega - 1, -1, -1):  # noqa: E741
        nxt[:, l] = np.where(has[:, l], l, nxt[:, l + 1])
    next_flagged = np.minimum(np.roll(nxt[:, :-1], -1, axis=1), omega)
    next_flagged[:, omega - 1] = omega
    seg_offset = np.clip(
        next_flagged - np.arange(omega, dtype=np.int32)[None, :] - 1, 0, omega
    )
    nseg = lane_cnt.sum(axis=1, dtype=np.int64)  # (p,)
    return bit_flag, y_offset.astype(np.int32), seg_offset.astype(np.int32), nseg


def _empty_offsets(
    row_ptr: np.ndarray,
    heads: np.ndarray,
    dirty: np.ndarray,
    tile_ptr: np.ndarray,
    nseg: np.ndarray,
    p: int,
    tile_nnz: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged ordinal->row-offset table for dirty tiles.

    Parity with generate_partition_descriptor_offset_kernel
    (format_cuda.h:362-523): for the k-th segment head of a dirty tile, the
    actual row offset from tile_ptr[t], found by binary search.
    """
    counts = np.where(dirty, nseg, 0).astype(np.int64)
    eo_ptr = np.zeros(p + 1, dtype=np.int64)
    np.cumsum(counts, out=eo_ptr[1:])
    total = int(eo_ptr[-1])
    if total == 0:
        return eo_ptr.astype(np.int32), np.zeros(0, np.int32)
    # global element index of every head, in element order, per tile
    head_pos = np.nonzero(heads)[0]  # sorted; element order == flat order?
    # heads is in (t, l, s) flat layout = element order within tile: flat
    # index t*T + l*sigma + s == global element order index. Yes.
    head_tile = head_pos // tile_nnz
    keep = dirty[head_tile]
    hp = head_pos[keep]
    rows = np.searchsorted(row_ptr, hp, side="right") - 1
    offs = rows - tile_ptr[head_tile[keep]]
    return eo_ptr.astype(np.int32), offs.astype(np.int32)


def _as_host_csr(csr) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]:
    """Extract host (row_ptr, col_idx, values, shape) from a CSRMatrix,
    scipy.sparse matrix, or (row_ptr, col_idx, values, shape) tuple.

    Conversion runs on the host, so callers holding host arrays should
    pass them directly instead of a device CSRMatrix (which is read back).
    """
    if isinstance(csr, tuple):
        row_ptr, col_idx, values, shape = csr
    elif hasattr(csr, "indptr"):  # scipy.sparse csr_matrix / csr_array
        row_ptr, col_idx, values, shape = csr.indptr, csr.indices, csr.data, csr.shape
    else:
        row_ptr, col_idx, values, shape = csr.row_ptr, csr.col_idx, csr.values, csr.shape
    return (
        np.asarray(row_ptr, dtype=np.int64),
        np.ascontiguousarray(col_idx, dtype=np.int32)
        if isinstance(col_idx, np.ndarray)
        else np.asarray(col_idx, dtype=np.int32),
        np.asarray(values),
        tuple(shape),
    )


def build_csr5(
    csr,
    config: Optional[CSR5Config] = None,
    sigma: int = AUTO_TUNED_SIGMA,
    value_dtype=None,
    win_mode: str = "auto",
) -> CSR5Matrix:
    """CSR -> CSR5: the asCSR5() analogue (anonymouslib_cuda.h:106-220).

    ``csr`` may be a CSRMatrix, a scipy.sparse CSR matrix, or a host tuple
    ``(row_ptr, col_idx, values, shape)``; host inputs skip the slow
    device readback. ``value_dtype`` overrides the stored value dtype --
    ``jnp.bfloat16`` halves the value plane (the executor multiplies in
    x's precision regardless); ``value_dtype="auto"`` stores bf16 only when every value
    provably round-trips f32->bf16->f32 (then results are bit-identical
    to f32 storage — the bandmm precision-gate semantics) and f32
    otherwise. ``win_mode="aligned"`` forces the 128-aligned window maps
    (the distributed layer needs uniform maps across shards).

    When the stream-compressed ``col_packed`` plane exists, the raw
    4 B/nnz ``col_idx_tiles`` plane is NOT uploaded (it is exactly
    reconstructible — :func:`..models.formats.col_tiles_of`), which cuts
    the payload from 10 to 6 B/nnz (4 with bf16 values).
    """
    row_ptr, col_idx, values, (m, n) = _as_host_csr(csr)
    nnz = int(values.shape[0])
    if config is None:
        config = CSR5Config(sigma=compute_sigma(m, nnz, sigma))
    elif sigma != AUTO_TUNED_SIGMA and sigma != config.sigma:
        config = CSR5Config(
            omega=config.omega, sigma=sigma, tiles_per_block=config.tiles_per_block
        )
    omega, sig = config.omega, config.sigma
    T = config.tile_nnz
    _ph = {}
    _t0 = time.perf_counter()

    def _mark(name):
        nonlocal _t0
        now = time.perf_counter()
        _ph[name] = _ph.get(name, 0.0) + (now - _t0) * 1e3
        _t0 = now
        progress.emit(f"convert:{name}")

    p = max(1, -(-nnz // T))  # every tile padded; tail is the last tile
    # pad the tile count to a multiple of tiles_per_block; the quantum
    # shrinks to the next pow2 >= p for small matrices so a 1-tile matrix
    # does not pad out to tiles_per_block tiles
    quantum = min(config.tiles_per_block, _pow2_at_least(p, 1))
    p_pad = -(-p // quantum) * quantum
    nnz_pad = p_pad * T

    # nnz-scale scratch comes from the process-lifetime arena (utils/
    # hostmem.py): repeated conversions reuse already-touched pages
    # instead of first-touching fresh mappings every time
    col_flat = arena_take(nnz_pad, np.int32, "cv:col_flat", zero=False)
    val_flat = arena_take(nnz_pad, values.dtype, "cv:val_flat", zero=False)
    col_flat[:nnz] = col_idx
    val_flat[:nnz] = values
    val_flat[nnz:] = 0
    if nnz:
        # pad columns repeat the last real column (values stay zero): a
        # zero pad column would stretch the tail tile's x-page span to
        # [0, last], breaking the contiguous-pages gather mode
        col_flat[nnz:] = col_idx[-1] if len(col_idx) else 0
    else:
        col_flat[:] = 0

    _mark("malloc")
    # --- partition pointer + dirty bits (format_cuda.h:21-95) ----------
    bounds = np.arange(p_pad + 1, dtype=np.int64) * T
    tile_ptr = np.clip(np.searchsorted(row_ptr, bounds, side="right") - 1, 0, m)
    empty = arena_take(m, np.int64, "cv:empty", zero=False)
    emp_b = arena_take(m, np.bool_, "cv:emptyb", zero=False)
    np.equal(row_ptr[1:], row_ptr[:-1], out=emp_b)
    # widen bool->int64 before the cumsum (numpy's bool cumsum is far
    # slower); both scratch planes live in the arena
    np.copyto(empty, emp_b, casting="unsafe")
    e_prefix = arena_take(m + 1, np.int64, "cv:eprefix", zero=False)
    e_prefix[0] = 0
    np.cumsum(empty, out=e_prefix[1:])
    start, stop = tile_ptr[:-1], np.minimum(tile_ptr[1:], m - 1)
    dirty = (e_prefix[stop + 1] - e_prefix[np.minimum(start + 1, m)]) > 0
    tail_row_start = int(tile_ptr[p - 1])

    _mark("tile_ptr")
    from ..utils import nativelib

    # --- bit flags + descriptor (format_cuda.h:129-267) -----------------
    # native single row-walk when available (the numpy path materialises
    # an nnz_pad bool heads plane + packbits passes); element order in a
    # tile is lane-major:
    # flat index t*T + l*sig + s
    nd = nativelib.descriptor(row_ptr, p_pad, sig, omega)
    if nd is not None:
        bit_flag, y_offset, seg_offset, nseg = nd
        eo_ptr, eo = nativelib.empty_offsets(
            row_ptr, tile_ptr[:-1], dirty, nseg, p_pad, T
        )
    else:
        heads = np.zeros(nnz_pad, dtype=bool)
        nonempty = np.diff(row_ptr) > 0
        heads[row_ptr[:-1][nonempty]] = True
        # forced tile-leading bit (format_cuda.h:171-175)
        heads_forced = heads.copy()
        heads_forced[np.arange(p_pad) * T] = True
        bit_flag, y_offset, seg_offset, nseg = _descriptor(
            heads_forced, p_pad, sig, omega
        )
        # --- empty-row indirection (format_cuda.h:269-523) --------------
        eo_ptr, eo = _empty_offsets(
            row_ptr, heads_forced, dirty, tile_ptr[:-1], nseg, p_pad, T
        )

    _mark("tile_desc")
    # --- execution plan -------------------------------------------------
    # per-tile distinct x-page lists, vectorised: sort pages within each
    # tile, mark firsts, compact by prefix position. Dead slots hold the
    # sentinel page n_pad//128, which matches no real column.
    n_pad = -(-max(n, 1) // PAGE_COLS) * PAGE_COLS
    page_sentinel = n_pad // PAGE_COLS

    from ..utils import nativelib

    plan = nativelib.page_plan(col_flat, p_pad, T, page_sentinel + 1)
    if plan is not None:
        # native single-pass page stats (bitmap per tile; avoids
        # nnz-scale numpy temporaries)
        page_lo, page_cnt, span_max, cnt_max, make_lists = plan
        pages_sorted = None
    else:
        # numpy fallback: in-place ndarray.sort (no extra nnz-scale temp)
        pages_sorted = (col_flat >> 7).reshape(p_pad, T)
        pages_sorted.sort(axis=1)
        first = np.ones((p_pad, T), dtype=bool)
        first[:, 1:] = pages_sorted[:, 1:] != pages_sorted[:, :-1]
        page_cnt = first.sum(axis=1, dtype=np.int32)
        page_lo = pages_sorted[:, 0].astype(np.int32)
        span_max = int((pages_sorted[:, -1] - pages_sorted[:, 0]).max()) + 1
        cnt_max = int(page_cnt.max())

    # contig needs the (pmax,128) slab to fit inside x2d's sentinel+1 rows
    if span_max <= CONTIG_PAGE_CAP and max(span_max, 2) <= page_sentinel + 1:
        # contiguous-pages mode: every tile's pages are the consecutive
        # range [pages[t,0], pages[t,0]+pmax); pages beyond the tile's
        # span match no columns (harmless). pmax is the exact max span
        pmax = max(span_max, 2)
        lo = np.minimum(page_lo, page_sentinel + 1 - pmax)
        pages = lo[:, None] + np.arange(pmax, dtype=np.int32)[None, :]
        pages_contig = True
    else:
        # round the list width to a multiple of 8
        pmax = max(-(-cnt_max // 8) * 8, 2)
        pages_contig = False
        if plan is not None:
            pages = make_lists(pmax, page_sentinel, arena="cv:pages")
        else:
            pages = np.full((p_pad, pmax), page_sentinel, dtype=np.int32)
            # NB: cumsum on a bool array takes numpy's slow bool->int64
            # path; cast first
            pos = np.cumsum(first.astype(np.int32), axis=1, dtype=np.int32) - 1
            tsel, esel = np.nonzero(first)
            pages[tsel, pos[tsel, esel]] = pages_sorted[tsel, esel]

    # --- stream-compressed column plane ---------------------------------
    # uint16 code "lane(7b) | local_page(<=9b)" per element, where
    # local_page indexes the tile's page list; pairs of sigma-rows
    # combine into one int32 plane (``col_packed``), HALVING the stored
    # column bytes (6 B/elem with f32 values, 4 with bf16). Valid while
    # every local index fits 9 bits (pmax <= 512).
    #
    # The packed plane is kept (and the raw plane dropped) for
    # sigma % 16 == 0, which keeps each int32 pair within one
    # (sigma, omega) tile of even height. Other sigmas upload the raw
    # int32 plane: uploading the 2 B/nnz codes and decoding them on the
    # device was measured slower end to end on banded2M (PERF.md).
    col16 = None
    if pmax <= 512 and sig % 16 == 0:
        if pages_contig:
            # local = page - slab_lo, broadcast per tile; all temps are
            # arena-backed (3 nnz-scale planes otherwise churn fresh
            # mappings every conversion)
            cf2 = col_flat.reshape(p_pad, T)
            t1 = arena_take((p_pad, T), np.int32, "cv:c16a", zero=False)
            t2 = arena_take((p_pad, T), np.int32, "cv:c16b", zero=False)
            np.right_shift(cf2, 7, out=t1)
            np.subtract(t1, lo[:, None], out=t1)  # local page index
            np.left_shift(t1, 7, out=t1)
            np.bitwise_and(cf2, 127, out=t2)
            np.bitwise_or(t1, t2, out=t1)
            col16 = arena_take(nnz_pad, np.uint16, "cv:col16", zero=False)
            np.copyto(col16, t1.reshape(-1), casting="unsafe")
        else:
            col16 = nativelib.col_local_packed(
                col_flat, p_pad, T, page_sentinel + 1, arena="cv:col16"
            )
            if col16 is None:
                # numpy fallback: rank pages within each tile via argsort
                pg2 = (col_flat >> 7).reshape(p_pad, T)
                order = np.argsort(pg2, axis=1, kind="stable")
                ps = np.take_along_axis(pg2, order, axis=1)
                fst = np.ones_like(ps, dtype=bool)
                fst[:, 1:] = ps[:, 1:] != ps[:, :-1]
                loc_sorted = np.cumsum(fst.astype(np.int32), axis=1) - 1
                local = np.empty_like(loc_sorted)
                np.put_along_axis(local, order, loc_sorted, axis=1)
                cf2 = col_flat.reshape(p_pad, T)
                col16 = ((cf2 & 127) | (local << 7)).astype(np.uint16).reshape(-1)

    # monotone row-end window maps: win_end[t,d] = in-tile
    # position of the last element of the row at window slot d:
    # clip(row_ptr[min(row0+d+1, m)]-1 - t*T, 0, T-1). Monotone with
    # repeats => empty rows and beyond-span slots auto-produce zero diffs.
    #
    # Two window anchorings:
    # - wrapped (``win_rel``, the default): capw = ceil((span_max+1)/128)
    #   *128 slots per tile. Slot d maps to row base+d for d >= rs%128 and
    #   WRAPS to row base+capw+d for d < rs%128 (base = rs rounded down to
    #   128). The executor then diffs with a roll(1) (the wrap seam
    #   last-slot->slot0 is exactly consecutive rows), needs no
    #   leading-slot masks and no pow2 rounding, and has one fewer
    #   128-slot group than the aligned mode at every span.
    # - aligned: slot d = row base+d over G=capw/128 groups; slots
    #   d < rs-base are masked by the executor. Kept for the distributed layer,
    #   whose shard re-padding edge-extends win_map along the slot axis
    #   (monotone for aligned maps, wrong for wrapped ones).
    span = tile_ptr[1:] - tile_ptr[:-1]  # rows spanned (excl. carry row)
    win_rel = win_mode != "aligned"
    rs = tile_ptr[:-1][:, None]  # (p,1)
    if win_rel:
        capw = -(-(int(span.max()) + 1) // 128) * 128
        off = rs & 127
        d = np.arange(capw)[None, :]
        ridx = arena_take((p_pad, capw), np.int64, "cv:ridx", zero=False)
        np.add(rs - off, d + 1, out=ridx)
        wmask = arena_take((p_pad, capw), np.bool_, "cv:wmask", zero=False)
        np.less(d, off, out=wmask)
        np.add(ridx, capw, out=ridx, where=wmask)
        np.minimum(ridx, m, out=ridx)
    else:
        capw = _pow2_at_least(int(span.max()) + 1 + 128, 128)
        d = np.arange(capw)[None, :]
        ridx = arena_take((p_pad, capw), np.int64, "cv:ridx", zero=False)
        np.add((rs // 128) * 128, d + 1, out=ridx)
        np.minimum(ridx, m, out=ridx)
    # win_end / win_map built in-place over two arena planes (out-of-place
    # numpy here cost seconds of fresh-mapping first-touch per conversion)
    wq = arena_take((p_pad, capw), np.int64, "cv:wq", zero=False)
    np.take(row_ptr, ridx, out=wq)
    np.subtract(wq, 1, out=wq)
    np.subtract(wq, (np.arange(p_pad, dtype=np.int64) * T)[:, None], out=wq)
    np.clip(wq, 0, T - 1, out=wq)
    np.floor_divide(wq, sig, out=ridx)  # ridx reused as the slot-row plane
    np.left_shift(ridx, 16, out=ridx)
    np.remainder(wq, sig, out=wq)
    np.bitwise_or(wq, ridx, out=wq)
    win_map = arena_take((p_pad, capw), np.int32, "cv:winmap", zero=False)
    np.copyto(win_map, wq, casting="unsafe")
    # flag bits (packed next to sub|lane<<16; bits 0-9 sub, 16-22 lane):
    # bit 23 = this slot is the tile's FIRST row (d == rs%128, the
    # W_prev reset), bit 24 = d >= rs%128 (wrapped: the group-0
    # high-part mask; aligned: the valid-slot mask). Set for BOTH
    # anchorings (identical formula). Readers must mask lane reads with
    # (wm >> 16) & 127. Checkpoint FORMAT_VERSION 3 depends on them.
    off_all = rs & 127
    fmask = arena_take((p_pad, capw), np.bool_, "cv:wmask", zero=False)
    np.greater_equal(d, off_all, out=fmask)
    np.add(win_map, 1 << 24, out=win_map, where=fmask)
    np.equal(d, off_all, out=fmask)
    np.add(win_map, 1 << 23, out=win_map, where=fmask)

    _mark("plan")
    # --- AoS->SoA tile transpose (format_cuda.h:525-744) ----------------
    # done in native C++ on host (numpy's strided copy of this
    # permutation is slow), then uploaded in final layout. Uploads are
    # issued LAST, after all host work.
    from ..utils import nativelib

    # resolve the stored value dtype up front, mirroring what
    # jnp.asarray(...).astype(value_dtype) produced on device: f64 narrows
    # to f32 when x64 is off; value_dtype (e.g. bfloat16) overrides.
    if value_dtype == "auto":
        # the bandmm precision gate, applied to storage: bf16 only when
        # every value survives f32->bf16->f32 unchanged — the executor
        # multiplies in x's precision, so results are then bit-identical
        # to f32 storage while the value plane halves (2 B/nnz)
        from .bandmm import _bf16_roundtrip_exact

        if val_flat.dtype in (
            np.float32,
            np.float64,
        ) and _bf16_roundtrip_exact(values):
            import ml_dtypes

            value_dtype = ml_dtypes.bfloat16
        else:
            value_dtype = None
    if value_dtype is not None:
        vdt = np.dtype(value_dtype)  # ml_dtypes types are numpy-compatible
    elif val_flat.dtype == np.float64 and not jax.config.jax_enable_x64:
        vdt = np.dtype(np.float32)
    else:
        vdt = val_flat.dtype
    if val_flat.dtype == vdt:
        val_cast = val_flat
    else:
        val_cast = arena_take(nnz_pad, vdt, "cv:valcast", zero=False)
        np.copyto(val_cast, val_flat, casting="unsafe")

    # the raw column plane is redundant whenever col_packed exists (exact
    # decode via models.formats.col_tiles_of): skip its transpose AND its
    # 4 B/nnz upload
    drop_raw = col16 is not None
    pk_tr = (
        nativelib.pack_col16(col16, p_pad, sig, omega, arena="cv:pktr")
        if col16 is not None
        else None
    )
    col_tr = (
        None
        if drop_raw
        else nativelib.tile_transpose(
            col_flat, p_pad, sig, omega, arena="cv:coltr"
        )
    )
    val_tr = nativelib.tile_transpose(val_cast, p_pad, sig, omega, arena="cv:valtr")
    _mark("transpose")  # host work only; the device uploads time as "upload"
    # NB: arena-backed host planes MUST be uploaded with jnp.array
    # (copy=True): on the CPU backend jnp.asarray can alias the host
    # buffer zero-copy, and the arena reuses that memory on the next
    # conversion
    pages_dev = jnp.array(pages, jnp.int32)
    if drop_raw:
        col_tiles = None
    elif col_tr is not None:
        col_tiles = jnp.array(col_tr)  # (p, sig, om), pure upload
    else:
        col_tiles = jnp.swapaxes(
            jnp.asarray(col_flat, jnp.int32).reshape(p_pad, omega, sig), 1, 2
        )
    if val_tr is not None:
        val_tiles = jnp.array(val_tr)
    else:
        val_tiles = jnp.swapaxes(
            jnp.asarray(val_flat).reshape(p_pad, omega, sig), 1, 2
        )
        if value_dtype is not None:
            val_tiles = val_tiles.astype(value_dtype)
    col_packed = None
    if col16 is not None:
        if pk_tr is not None:
            col_packed = jnp.array(pk_tr)
        else:
            # combine sigma-row pairs (s, s+sigma/2) into int32 on device
            c32 = jnp.asarray(col16).reshape(p_pad, omega, sig).astype(jnp.int32)
            s2 = sig // 2
            col_packed = jnp.swapaxes(
                c32[:, :, :s2] | (c32[:, :, s2:] << 16), 1, 2
            )
    # force the payload transfers to complete here so their cost is
    # attributed to this phase (async uploads otherwise land inside
    # whatever phase first touches the arrays)
    payload = tuple(
        t for t in (col_tiles, val_tiles, col_packed) if t is not None
    )
    jax.block_until_ready(payload)
    _mark("upload")
    # uploaded payload observability: how many bytes crossed to the
    # device and the achieved rate
    uploaded = [val_tiles]
    if col_tiles is not None:
        uploaded.append(col_tiles)
    if col_packed is not None:
        uploaded.append(col_packed)
    up_bytes = sum(t.size * t.dtype.itemsize for t in uploaded)
    _ph["upload_mb"] = up_bytes / 1e6
    if _ph.get("upload", 0.0) > 0:
        _ph["upload_gbps"] = up_bytes / 1e6 / _ph["upload"]
    last_convert_phases.clear()
    last_convert_phases.update(_ph)
    jdt = jnp.int32
    return CSR5Matrix(
        shape=(m, n),
        config=config,
        num_tiles=p_pad,
        nnz_stored=nnz,
        row_ptr=jnp.array(row_ptr, jdt),
        tile_ptr=jnp.asarray(tile_ptr, jdt),
        tile_dirty=jnp.asarray(dirty),
        y_offset=jnp.asarray(y_offset, jdt),
        seg_offset=jnp.asarray(seg_offset, jdt),
        bit_flag=jnp.asarray(bit_flag),
        empty_offset_ptr=jnp.asarray(eo_ptr, jdt),
        empty_offset=jnp.asarray(eo, jdt),
        col_idx_tiles=col_tiles,
        val_tiles=val_tiles,
        pages=pages_dev,
        pages_contig=pages_contig,
        page_cnt=jnp.asarray(page_cnt, jdt),
        win_map=jnp.array(win_map, jdt),
        col_packed=col_packed,
        win_rel=win_rel,
        tail_row_start=tail_row_start,
        capw=capw,
        pmax=pmax,
        # +capw+128 headroom: a tile's row windows reach capw rows past
        # the 128-aligned block of its first row (1024-multiple)
        m_pad=-(-(m + capw + 128) // 1024) * 1024,
        n_pad=n_pad,
    )


def build_csr5_autotuned(
    csr, config: Optional[CSR5Config] = None, value_dtype=None
) -> CSR5Matrix:
    """Two-stage conversion with a structure-aware sigma re-tune.

    The reference sigma heuristic (``compute_sigma``, parity with
    anonymouslib_cuda.h:295-318) sees only mean nnz/row. When the
    conversion lands in the scattered regime (pages not contiguous), a
    smaller sigma keeps the per-tile page lists short:

    - short scattered rows (heuristic sigma <= 16): sigma=8
    - long scattered rows (heuristic sigma >= 24): sigma=16, which keeps
      the packed column plane

    These targets were chosen for an earlier executor and have not been
    re-tuned for the current one.

    Converts once with the heuristic; a non-contiguous result rebuilds
    at the regime target. Costs one extra conversion pass — use for
    matrices that will be applied many times.
    """
    a5 = build_csr5(csr, config, value_dtype=value_dtype)
    if not a5.pages_contig:
        target = 8 if a5.config.sigma <= 16 else 16
        if a5.config.sigma != target:
            cfg_t = CSR5Config(
                omega=a5.config.omega,
                sigma=target,
                tiles_per_block=a5.config.tiles_per_block,
            )
            a5 = build_csr5(csr, cfg_t, value_dtype=value_dtype)
    return a5


def csr5_to_csr(a5: CSR5Matrix) -> CSRMatrix:
    """CSR5 -> CSR: the asCSR() analogue (anonymouslib_cuda.h:79-103).

    Inverts the AoS->SoA transpose and drops padding; exact round-trip.
    """
    from ..models.formats import col_tiles_of

    p, sig, omega = a5.num_tiles, a5.sigma, a5.omega
    col_flat = jnp.swapaxes(col_tiles_of(a5), 1, 2).reshape(p * sig * omega)
    val_flat = jnp.swapaxes(a5.val_tiles, 1, 2).reshape(p * sig * omega)
    return CSRMatrix(
        row_ptr=a5.row_ptr,
        col_idx=col_flat[: a5.nnz_stored],
        values=val_flat[: a5.nnz_stored],
        shape=a5.shape,
    )


def convert_timings(csr: CSRMatrix, config: Optional[CSR5Config] = None) -> dict:
    """Phase-timed conversion, mirroring the reference's breakdown print
    (malloc / tile_ptr / tile_desc / transpose, anonymouslib_cuda.h:211-214).
    """
    t0 = time.perf_counter()
    a5 = build_csr5(csr, config)
    jax.block_until_ready(a5.val_tiles)
    total = (time.perf_counter() - t0) * 1e3
    out = {"total_ms": total, "csr5": a5}
    out.update({f"{k}_ms": round(v, 3) for k, v in last_convert_phases.items()})
    return out
