"""Sparse matrix containers: COO, CSR and CSR5.

The data model of the framework. The reference keeps raw pointers inside
``anonymouslibHandle`` (``CSR5_cuda/anonymouslib_cuda.h:28-53``); here each
format is an immutable pytree dataclass so matrices flow through ``jit`` /
``shard_map`` like any other JAX value.

CSR5 layout (reference: SURVEY.md section 2.0; ``anonymouslib_cuda.h:106-220``,
``format_cuda.h``): CSR plus tiling metadata over tiles of omega x sigma
nonzeros, with ``col_idx``/``values`` tile-transposed (AoS->SoA,
``format_cuda.h:525-744``) so each lane's sigma elements sit in one
column of a (sigma, omega) tile. Deviation from the reference's packed
descriptor (``anonymouslib_cuda.h:121-134`` packs
y_offset/scansum_offset/bit_flag into shared 32-bit words): the descriptor
is stored as structure-of-arrays -- ``y_offset``/``seg_offset`` as narrow
integer planes and ``bit_flag`` as ceil(sigma/32) packed uint32 words per
lane. SoA planes are contiguous (tiles, omega) arrays with the same
compressed footprint; the information content is identical to the packed
descriptor, so conversion back to CSR is exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..config import CSR5Config
from ..utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class COOMatrix:
    """Coordinate-format sparse matrix (the .mtx on-disk model).

    Mirrors the COO stage of the reference loader (``main.cu:211-238``).
    """

    row: jax.Array  # (nnz,) int32
    col: jax.Array  # (nnz,) int32
    values: jax.Array  # (nnz,) float
    shape: Tuple[int, int] = static_field()

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype


@pytree_dataclass
class CSRMatrix:
    """Compressed sparse row matrix.

    The canonical input format of the reference
    (``anonymouslibHandle::inputCSR``, ``anonymouslib_cuda.h:62-76``).
    """

    row_ptr: jax.Array  # (m+1,) int32
    col_idx: jax.Array  # (nnz,) int32
    values: jax.Array  # (nnz,) float
    shape: Tuple[int, int] = static_field()

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    def to_coo(self) -> COOMatrix:
        counts = jnp.diff(self.row_ptr)
        rows = jnp.repeat(
            jnp.arange(self.m, dtype=self.row_ptr.dtype),
            counts,
            total_repeat_length=self.nnz,
        )
        return COOMatrix(rows, self.col_idx, self.values, self.shape)


@pytree_dataclass
class CSR5Matrix:
    """CSR5 tiled sparse matrix + its execution plan.

    Field-by-field parity with the reference's auxiliary arrays
    (``anonymouslib_cuda.h:40-53``):

    ==================  =====================================================
    reference           here
    ==================  =====================================================
    _csr5_partition_    ``tile_ptr`` (row index; the MSB dirty bit of
    pointer             format_cuda.h:92 is stored as the separate boolean
                        plane ``tile_dirty``)
    _csr5_partition_    ``y_offset`` + ``seg_offset`` + ``bit_flag`` SoA
    descriptor          planes (format_cuda.h:129-267)
    _csr5_partition_    ``empty_offset_ptr`` / ``empty_offset``
    descriptor_offset   (format_cuda.h:269-523)
    _tail_partition_    ``tail_row_start`` (anonymouslib_cuda.h:165-167)
    start
    d_col_idx/d_val     ``col_idx_tiles`` / ``val_tiles`` -- tile-transposed
    (transposed)        (p, sigma, omega) planes (format_cuda.h:525-744)
    ==================  =====================================================

    Deviations from the reference:

    - The tail partition is stored as one final zero-padded tile instead of
      raw CSR (the reference computes it with a separate CSR-vector kernel,
      csr5_spmv_cuda.h:384-419; here one executor handles all tiles).
    - The *execution plan* fields (``pages``/``page_cnt``, ``win_map``)
      are conversion-time derivations of the descriptor: per-tile distinct
      128-column x-page lists (which also encode ``col_packed``), and
      monotone row-end maps for the segmented-sum window extraction.
    - There is no calibrator (``anonymouslib_cuda.h:49``): the executor
      scatter-adds every tile's row windows into y.
    """

    shape: Tuple[int, int] = static_field()
    config: CSR5Config = static_field()
    #: number of stored tiles incl. padded tail tile(s)
    num_tiles: int = static_field()
    #: true (unpadded) nonzero count
    nnz_stored: int = static_field()

    # CSR row pointer retained for the tail partition semantics + asCSR
    row_ptr: jax.Array  # (m+1,) int32

    # --- CSR5 parity metadata -------------------------------------------
    tile_ptr: jax.Array  # (p+1,) int32: row index where each tile starts
    tile_dirty: jax.Array  # (p,) bool: empty row inside tile's row range
    y_offset: jax.Array  # (p, omega) int32: segments in lanes < l
    seg_offset: jax.Array  # (p, omega) int32: CSR5 scansum offset per lane
    bit_flag: jax.Array  # (p, ceil(sigma/32), omega) uint32 packed head bits
    empty_offset_ptr: jax.Array  # (p+1,) int32
    empty_offset: jax.Array  # (num_offsets,) int32

    # --- tile-transposed payload ----------------------------------------
    # element (t, s, l) = CSR element t*omega*sigma + l*sigma + s.
    # col_idx_tiles may be None when ``col_packed`` is present: the packed
    # plane + ``pages`` reconstruct it exactly (:func:`col_tiles_of`), so
    # the conversion skips uploading the redundant 4 B/nnz raw plane.
    col_idx_tiles: Optional[jax.Array]  # (p, sigma, omega) int32 or None
    val_tiles: jax.Array  # (p, sigma, omega) float

    # --- execution plan -------------------------------------------------
    #: (p, pmax) int32: distinct col>>7 x-pages per tile; slots past
    #: page_cnt hold the sentinel n_pad//128 (a guaranteed-zero x row that
    #: never matches any real col>>7).
    pages: jax.Array
    page_cnt: jax.Array  # (p,) int32
    #: (p, capw) int32 packed row-end map: s | (lane << 16). The
    #: in-tile position of the last element of row base+d is
    #: lane*sigma + s (monotone; repeats encode empty rows).
    win_map: jax.Array
    #: (p, sigma/2, omega) int32 stream-compressed column plane, or None
    #: when pmax > 512. Each int32 packs the uint16 codes
    #: ``lane | local_page<<7`` of tile elements (s, l) and (s+sigma/2, l),
    #: where local_page is the index into ``pages[t]`` (== page - pages[t,0]
    #: in contiguous mode). Half the bytes of the int32 column plane.
    col_packed: Optional[jax.Array] = None

    # --- static plan parameters -----------------------------------------
    # CHECKPOINT CONTRACT (utils/checkpoint.py): loaders default-fill any
    # static field absent from an older checkpoint, so a field default
    # added here MUST mean "feature off / pre-feature layout" — i.e. a
    # pre-feature checkpoint filled with the default must compute
    # bit-identically to how it did when saved. A defaulted field that
    # changes numerics requires a checkpoint.FORMAT_VERSION bump instead.
    #: True when win_map slots are anchored at each tile's OWN first row
    #: (wrapped: slot d < row_start%128 holds row base+capw+d).
    #: False = slots anchored at the 128-aligned base row.
    win_rel: bool = static_field(default=False)
    tail_row_start: int = static_field(default=0)
    capw: int = static_field(default=128)
    pmax: int = static_field(default=8)
    #: True when every tile's x-pages are the consecutive range
    #: [pages[t,0], pages[t,0]+pmax)
    pages_contig: bool = static_field(default=False)
    m_pad: int = static_field(default=0)
    n_pad: int = static_field(default=0)

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.nnz_stored

    @property
    def dtype(self):
        return self.val_tiles.dtype

    @property
    def sigma(self) -> int:
        return self.config.sigma

    @property
    def omega(self) -> int:
        return self.config.omega


def col_tiles_of(a5: CSR5Matrix) -> jax.Array:
    """The (p, sigma, omega) int32 column plane, decoding ``col_packed``
    when the raw plane was dropped at conversion time.

    The packed code of element (t, s, l) is ``lane | local_page << 7``
    where ``local_page`` indexes ``pages[t]`` and the original column is
    ``pages[t][local_page] * 128 + lane`` — an exact inverse (pad
    elements round-trip too: their codes point at real pages). Jittable;
    used by asCSR and the SpMV executor.
    """
    if a5.col_idx_tiles is not None:
        return a5.col_idx_tiles
    cp = a5.col_packed  # (p, sigma/2, omega) int32, two codes per word
    p, s2, om = cp.shape
    codes = jnp.concatenate(
        [cp & 0xFFFF, (cp >> 16) & 0xFFFF], axis=1
    )  # (p, sigma, omega), row s holds element (t, s, l)'s code
    lane = codes & 127
    local = codes >> 7
    page = jnp.take_along_axis(
        a5.pages, local.reshape(p, 2 * s2 * om), axis=1
    ).reshape(p, 2 * s2, om)
    return page * 128 + lane


def csr_from_numpy(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    shape: Tuple[int, int],
    dtype=None,
) -> CSRMatrix:
    """Build a device CSRMatrix from host arrays (the inputCSR analogue)."""
    dtype = dtype or values.dtype
    return CSRMatrix(
        row_ptr=jnp.asarray(row_ptr, dtype=jnp.int32),
        col_idx=jnp.asarray(col_idx, dtype=jnp.int32),
        values=jnp.asarray(values, dtype=dtype),
        shape=tuple(shape),
    )


def csr_from_scipy(sp_mat, dtype=None) -> CSRMatrix:
    """Convert a scipy.sparse matrix (tests / host-side tooling only)."""
    csr = sp_mat.tocsr()
    return csr_from_numpy(csr.indptr, csr.indices, csr.data, csr.shape, dtype)
