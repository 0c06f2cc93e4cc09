"""Global configuration, tunables and status codes.

Re-design of the reference's shared constants layer:
  - status codes / format enum mirror ``CSR5_cuda/detail/common.h:13-22``
  - tile tunables (omega, sigma) mirror
    ``CSR5_cuda/detail/cuda/common_cuda.h:11-15`` and siblings. Here omega
    is a format parameter fixed at 128 lanes (the window maps of
    ops/convert.py encode lane indices in 7 bits), not the warp width.
  - the sigma auto-tuning heuristic mirrors
    ``CSR5_cuda/anonymouslib_cuda.h:295-318`` (CUDA) and
    ``CSR5_opencl_nvidia/anonymouslib_opencl.h:341-357`` (OpenCL), with
    sigma snapped to multiples of 8.

The reference keeps six per-backend copies of these constants; here a single
:class:`CSR5Config` collapses them into one runtime-configurable object that
is hashable (usable as a static jit argument, the analogue of the
reference's template parameters / OpenCL JIT re-specialisation,
``anonymouslib_opencl.h:363-479``).
"""

from __future__ import annotations

import dataclasses
import enum

import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Status codes (parity with ANONYMOUSLIB_* codes, detail/common.h:13-18).
# The library raises exceptions instead of returning ints, but the codes
# are preserved for API compatibility with the reference benchmark drivers.
# ---------------------------------------------------------------------------


class Status(enum.IntEnum):
    SUCCESS = 0
    INVALID_HANDLE = -1
    UNSUPPORTED_CSR5_OMEGA = -2
    UNSUPPORTED_CSR5_SIGMA = -3
    UNSUPPORTED_COMPUTE_CAPABILITY = -4
    UNSUPPORTED_VALUE_TYPE = -5


class Format(enum.IntEnum):
    """Storage format state of a matrix handle (detail/common.h:20-22)."""

    CSR = 0
    CSR5 = 1
    HYB5 = 2  # declared but unused by the reference; kept for parity


#: Sentinel requesting the sigma auto-tune heuristic
#: (ANONYMOUSLIB_AUTO_TUNED_SIGMA, anonymouslib_cuda.h:299).
AUTO_TUNED_SIGMA = -1

#: Tile width granule. The reference's omega is the SIMD width of its
#: target (32 CUDA warp / 4 AVX2 / 8 AVX-512 / 64 AMD wavefront, SURVEY.md
#: section 2.0); here omega is a multiple of 128 lanes.
LANES = 128

#: sigma granule of the auto-tune heuristic
SIGMA_QUANTUM = 8


@dataclasses.dataclass(frozen=True)
class CSR5Config:
    """Static CSR5 tiling configuration (jit-hashable).

    Mirrors the reference tunable set: omega/sigma
    (``common_cuda.h:11-15``). A fresh config is a new static jit argument,
    i.e. changing sigma re-specialises the executor, mirroring the OpenCL
    backend's re-JIT on ``setSigma`` (``anonymouslib_opencl.h:363-479``).
    """

    #: Tile width = number of lanes cooperating on a tile.
    omega: int = LANES
    #: Tile height = consecutive nonzeros per lane.
    sigma: int = 16
    #: The tile count is padded to a multiple of this (or to the next
    #: power of two for smaller matrices). Stored in checkpoints.
    tiles_per_block: int = 128
    #: Index dtype name (int32; the reference templates iT/uiT).
    index_dtype: str = "int32"

    @property
    def tile_nnz(self) -> int:
        return self.omega * self.sigma

    @property
    def idt(self):
        return jnp.dtype(self.index_dtype)

    def __post_init__(self):
        if self.omega % LANES != 0:
            raise ValueError(
                f"omega={self.omega} must be a multiple of "
                f"{LANES} (Status.UNSUPPORTED_CSR5_OMEGA)"
            )
        if self.sigma < 1 or self.sigma > 1024:
            raise ValueError(
                f"sigma={self.sigma} out of range (Status.UNSUPPORTED_CSR5_SIGMA)"
            )


def compute_sigma(m: int, nnz: int, sigma: int = AUTO_TUNED_SIGMA) -> int:
    """Sigma auto-tune heuristic.

    Behavioural parity with ``anonymouslibHandle::computeSigma``
    (``anonymouslib_cuda.h:295-318``): pick sigma from the mean nnz/row with
    breakpoints (r, s, t, u). The CUDA backend uses (4, 32, 256, 6); here
    the mapping is snapped to multiples of 8 while keeping the same
    piecewise shape (not re-tuned for the current executor):

    - short rows (nnz/row <= r): small sigma
    - medium rows: sigma tracks nnz/row
    - long rows (nnz/row > t): small sigma again (fast-track tiles dominate)
    """
    if sigma != AUTO_TUNED_SIGMA:
        return int(sigma)
    r, s, t, u = 8, 32, 256, 8
    nnz_per_row = nnz / max(m, 1)
    if nnz_per_row <= r:
        sig = r
    elif nnz_per_row <= s:
        sig = int(nnz_per_row)
    elif nnz_per_row <= t:
        sig = s
    else:
        sig = u
    sig = max(SIGMA_QUANTUM, (sig // SIGMA_QUANTUM) * SIGMA_QUANTUM)
    return sig
