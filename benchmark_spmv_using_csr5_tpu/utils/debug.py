"""Debug printers — parity with the reference's ``print_tile`` /
``print_1darray`` helpers (CSR5_cuda/detail/utils.h:22-55), which its
kernels call from commented-out diagnostics (format_cuda.h:348-357).

These operate on the converted :class:`CSR5Matrix`, rendering one tile's
payload in element order together with its decoded descriptor — the
first tool to reach for when a kernel result diverges on one tile.
"""

from __future__ import annotations

import sys

import numpy as np

from ..models.formats import CSR5Matrix, col_tiles_of


def print_1darray(arr, name: str = "array", file=sys.stdout) -> None:
    """The reference's print_1darray (detail/utils.h:44-55)."""
    a = np.asarray(arr)
    print(f"{name} ({a.shape}):\n{a}", file=file)


def tile_to_string(a5: CSR5Matrix, t: int) -> str:
    """Render tile t: columns/values in (sigma, omega) layout plus the
    decoded descriptor (bit flags, y_offset, seg_offset, dirty bit)."""
    sig, om = a5.sigma, a5.omega
    col = np.asarray(col_tiles_of(a5)[t])
    val = np.asarray(a5.val_tiles[t]).astype(np.float64)
    bf = np.asarray(a5.bit_flag[t])  # (nwords, omega)
    yo = np.asarray(a5.y_offset[t])
    so = np.asarray(a5.seg_offset[t])
    dirty = bool(np.asarray(a5.tile_dirty[t]))
    rs = int(np.asarray(a5.tile_ptr[t]))

    flags = np.zeros((sig, om), np.int8)
    for s in range(sig):
        flags[s] = (bf[s // 32] >> (s % 32)) & 1

    lines = [
        f"tile {t}: row_start={rs} dirty={dirty}",
        f"  y_offset[:8]  = {yo[:8].tolist()}",
        f"  seg_offset[:8]= {so[:8].tolist()}",
    ]
    show = min(om, 8)
    for s in range(sig):
        row = " ".join(
            f"{'*' if flags[s, l] else ' '}{col[s, l]:>7}:{val[s, l]:<6g}"
            for l in range(show)
        )
        lines.append(f"  s={s:<2} {row}{' ...' if om > show else ''}")
    lines.append("  (* marks a row-head bit; first 8 of omega lanes shown)")
    return "\n".join(lines)


def print_tile(a5: CSR5Matrix, t: int, file=sys.stdout) -> None:
    """The reference's print_tile (detail/utils.h:22-42), tile-transposed layout."""
    print(tile_to_string(a5, t), file=file)
