"""Dense band-block SpMM: multi-rhs sparse products as one batched matmul.

SpMM on the CSR5 executor costs R x the SpMV: the per-element x gather,
window extraction and y update are all repeated per right-hand side. For
matrices whose 128-row blocks touch a bounded column window (banded,
stencil, RCM-reordered), this module stores each block DENSE over its
window and contracts all blocks in one batched product:

    Y^T[:, blk] (R,128) = X^T[:, c0(blk) : c0(blk)+K] (R,K) @ A_blk^T (K,128)

- the dense plane is read ONCE for all R right-hand sides;
- the FLOPs run as one ``dot_general`` with a batch dimension, which XLA
  hands to the matrix units;
- zero-padding waste is bounded by the build gate (``max_bytes_ratio``
  vs the CSR5 stream) so unsuitable matrices reject to CSR5.

Precision semantics. ``precision="highest"`` multiplies f32 operands at
``Precision.HIGHEST`` (exact f32 products; without it an f32 product may
run in TF32). ``precision="bf16"`` rounds both operands to bf16 and
accumulates in f32 (``preferred_element_type``): EXACT for integer-class
values (the benchmark convention, main.cu:317-326) and <= ~2^-8 relative
for general floats (inside the reference's 1%% validation gate,
main.cu:361-384). The AUTO gate (default) keeps real-valued users safe
without an oracle: ``build_bandblock`` stores bf16 only when every matrix
value round-trips bf16 EXACTLY, otherwise it stores f32, and
``bandmm_spmm(precision="auto")`` follows the stored dtype.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.hostmem import arena_take
from ..utils.pytree import pytree_dataclass, static_field

LANES = 128
#: per-block column-window width cap (waste bound)
MAX_K = 4096
#: reject when the dense plane exceeds this multiple of the CSR5 stream
#: (val+col = 8 B/nnz) — beyond it the amortization over R right-hand
#: sides cannot win against the CSR5 executor
MAX_BYTES_RATIO = 10.0


@pytree_dataclass
class BandBlockMatrix:
    """Dense band-block form: 128-row blocks over per-block 128-aligned
    column windows of uniform (static) width K."""

    dense: jax.Array  # (m_pad, K) f32/bf16: block b rows = [b*128, b*128+128)
    c0: jax.Array  # (1, nblk) int32: window start PAGE (column / 128) per block
    shape: tuple = static_field()
    K: int = static_field()
    nx_pad: int = static_field()  # padded x^T columns
    nnz_stored: int = static_field(default=0)

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
    def num_blocks(self) -> int:
        return self.dense.shape[0] // LANES

    @property
    def dense_bytes(self) -> int:
        return self.dense.size * self.dense.dtype.itemsize


def build_bandblock(
    csr,
    max_k: int = MAX_K,
    max_bytes_ratio: float = MAX_BYTES_RATIO,
    value_dtype=None,
) -> Optional[BandBlockMatrix]:
    """CSR -> dense band-block form, or None when the matrix's 128-row
    blocks do not have bounded column windows (the gate: uniform window
    width K <= max_k AND dense bytes <= max_bytes_ratio x the 8 B/nnz
    CSR5 stream). ``csr`` is (row_ptr, col_idx, values, shape), a scipy
    CSR matrix, or a CSRMatrix (host arrays preferred; see convert).

    ``value_dtype=None`` (default) auto-selects the storage: **bfloat16**
    when every value round-trips bf16 exactly (integer-class values — the
    A-side rounding error is then provably zero, and the plane's reads
    and upload halve), **float32** otherwise (real-valued data;
    ``precision="auto"`` then runs exact HIGHEST products). Pass an
    explicit dtype to override the gate."""
    from ..utils import progress
    from .convert import _as_host_csr

    progress.emit("bandmm:build")
    row_ptr, col_idx, values, (m, n) = _as_host_csr(csr)
    nnz = int(values.shape[0])
    if nnz == 0 or m == 0:
        return None
    nblk = -(-m // LANES)
    m_pad = nblk * LANES

    # per-block column ranges (one reduceat pass)
    starts = row_ptr[np.minimum(np.arange(nblk) * LANES, m)].astype(np.int64)
    ends = row_ptr[np.minimum(np.arange(1, nblk + 1) * LANES, m)].astype(
        np.int64
    )
    ne = np.flatnonzero(ends > starts)
    cmin = np.zeros(nblk, np.int64)
    cmax = np.zeros(nblk, np.int64)
    if ne.size:
        cmin[ne] = np.minimum.reduceat(col_idx, starts[ne])
        cmax[ne] = np.maximum.reduceat(col_idx, starts[ne])
    # window start 128-aligned; uniform K = max padded span
    c0 = (cmin >> 7) << 7
    span = int((cmax - c0 + 1).max()) if nblk else 1
    K = -(-max(span, 1) // LANES) * LANES
    if K > max_k:
        return None
    dense_bytes = m_pad * K * 4
    if dense_bytes > max_bytes_ratio * nnz * 8:
        return None

    # window starts are stored as page indices (column / 128)
    c0_meta = np.zeros((1, nblk), np.int32)
    c0_meta[0, :] = c0 >> 7
    from ..utils import nativelib

    dense = nativelib.bandblock_fill(
        row_ptr, col_idx, values, c0_meta[0], m, m_pad, K, arena="bb:dense"
    )
    if dense is None:
        # numpy fallback: flat scatter idx = row*K + (col - c0[row>>7]);
        # CSR (row, col) pairs are unique so fancy assignment is race-free
        dense = arena_take((m_pad, K), np.float32, "bb:dense")
        rows = arena_take(nnz, np.int64, "bb:rows", zero=False)
        _expand_rows(row_ptr, m, rows)
        idx = arena_take(nnz, np.int64, "bb:idx", zero=False)
        c0e = arena_take(nnz, np.int64, "bb:c0e", zero=False)
        np.right_shift(rows, 7, out=idx)  # owning block of each nonzero
        np.take(c0, idx, out=c0e)  # its window start
        np.subtract(col_idx, c0e, out=idx)  # window-local column
        np.multiply(rows, K, out=rows)  # rows not needed past this point
        np.add(idx, rows, out=idx)
        dense.reshape(-1)[idx] = values
    if value_dtype is None:
        import ml_dtypes

        # the precision gate: bf16 storage only when provably lossless
        # for the matrix values (see module docstring)
        value_dtype = (
            ml_dtypes.bfloat16 if _bf16_roundtrip_exact(values) else np.float32
        )
    vdt = np.dtype(value_dtype)
    if vdt != np.float32:
        d16 = arena_take((m_pad, K), vdt, "bb:dense16", zero=False)
        np.copyto(d16, dense, casting="unsafe")
        dense = d16
    return BandBlockMatrix(
        dense=jnp.array(dense),
        c0=jnp.array(c0_meta),
        shape=(m, n),
        K=K,
        nx_pad=int(c0.max()) + K,
        nnz_stored=nnz,
    )


def _bf16_roundtrip_exact(values: np.ndarray) -> bool:
    """True iff every value survives f32 -> bf16 -> f32 unchanged (then
    bf16 storage introduces zero A-side error). The temporaries are
    arena buffers, reused across calls."""
    import ml_dtypes

    nnz = int(values.shape[0])
    if nnz == 0:
        return True
    v32 = np.asarray(values)
    if v32.dtype != np.float32:
        buf = arena_take(nnz, np.float32, "bb:v32", zero=False)
        np.copyto(buf, v32, casting="unsafe")
        v32 = buf
    b16 = arena_take(nnz, ml_dtypes.bfloat16, "bb:v16", zero=False)
    np.copyto(b16, v32, casting="unsafe")
    rt = arena_take(nnz, np.float32, "bb:v16r", zero=False)
    np.copyto(rt, b16, casting="unsafe")
    return bool(np.array_equal(rt, v32))


def _expand_rows(row_ptr: np.ndarray, m: int, out: np.ndarray) -> None:
    """out[k] = row of nonzero k (np.repeat into an arena buffer)."""
    # np.repeat allocates; keep it but bounce through the arena target so
    # repeated builds reuse pages
    out[:] = np.repeat(np.arange(m, dtype=np.int64), np.diff(row_ptr))


@partial(jax.jit, static_argnames=("precision", "rn"))
def _bandmm_jit(bb: BandBlockMatrix, xm, alpha, precision: str, rn: bool):
    R = xm.shape[0] if rn else xm.shape[1]
    nblk = bb.num_blocks
    op_dt = jnp.float32 if precision == "highest" else jnp.bfloat16
    # x^T (R, nx_pad). nx_pad can be SMALLER than n (nonzero columns
    # confined below the right edge): columns >= nx_pad are referenced by
    # no window, so truncate before padding
    xt = (xm if rn else xm.T).astype(jnp.float32) * jnp.asarray(
        alpha, jnp.float32
    )
    xt = xt[:, : bb.nx_pad]
    xt = jnp.pad(xt, ((0, 0), (0, bb.nx_pad - xt.shape[1]))).astype(op_dt)
    # (nblk, R, K): each block's x window, one dynamic slice per block
    win = jax.vmap(
        lambda c: jax.lax.dynamic_slice(xt, (jnp.zeros_like(c), c * LANES), (R, bb.K))
    )(bb.c0[0])
    a = bb.dense.reshape(nblk, LANES, bb.K).astype(op_dt)
    yb = jax.lax.dot_general(
        win,
        a,
        (((2,), (2,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST
        if precision == "highest"
        else jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32,
    )  # (nblk, R, 128)
    yt = jnp.swapaxes(yb, 0, 1).reshape(R, nblk * LANES)[:, : bb.m]
    return yt.astype(xm.dtype) if rn else yt.T.astype(xm.dtype)


def bandmm_spmm(
    bb: BandBlockMatrix,
    x_mat: jax.Array,
    alpha=1.0,
    precision: str = "auto",
    layout: str = "nr",
) -> jax.Array:
    """Y = alpha * A @ X as one batched band-block product.

    ``layout="nr"`` (default): X (n, R) in, Y (m, R) out. ``layout="rn"``:
    X^T (R, n) in, Y^T (R, m) out. ``precision="auto"`` (default) follows
    the storage gate: ``"highest"`` on an f32-built plane (real-valued
    matrices), ``"bf16"`` on a bf16 plane (integer-class matrices, where
    it is exact). ``"bf16"`` forces bf16 operands with f32 accumulation
    (<= ~2^-8 relative on general floats, inside the reference 1%% gate);
    ``"highest"`` forces exact f32 products and needs an f32-built matrix
    (``build_bandblock(value_dtype=np.float32)``).
    """
    if precision == "auto":
        precision = "highest" if bb.dense.dtype == jnp.float32 else "bf16"
    if precision not in ("highest", "bf16"):
        raise ValueError(f"precision must be auto, highest or bf16, not {precision!r}")
    if precision == "highest" and bb.dense.dtype != jnp.float32:
        raise ValueError(
            "precision='highest' needs an f32 dense plane: "
            "build_bandblock(..., value_dtype=np.float32)"
        )
    return _bandmm_jit(bb, x_mat, alpha, precision, layout == "rn")


def bandmm_spmv(
    bb: BandBlockMatrix, x: jax.Array, alpha=1.0, **kw
) -> jax.Array:
    """y = alpha * A @ x (runs as R=1 SpMM; the CSR5 executor is the better
    SpMV — this exists for API completeness and tests)."""
    return bandmm_spmm(bb, x[:, None], alpha, **kw)[:, 0]
