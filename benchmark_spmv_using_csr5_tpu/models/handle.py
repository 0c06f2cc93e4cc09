"""SpMVHandle: the anonymouslibHandle-compatible stateful API.

Mirrors the public interface of ``anonymouslibHandle<iT,uiT,vT>``
(``CSR5_cuda/anonymouslib_cuda.h:16-23``): ``warmup()``, ``inputCSR()``,
``asCSR()``, ``asCSR5()``, ``setX()``, ``spmv()``, ``setSigma()``,
``destroy()`` -- with snake_case JAX-native spellings (camelCase aliases
provided). The handle owns the format state machine CSR <-> CSR5
(anonymouslib_cuda.h:28-53) so reference benchmark drivers translate 1:1.

Functional users should prefer the pure API (build_csr5 / csr5_spmv);
the handle is a thin stateful veneer over it.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AUTO_TUNED_SIGMA, CSR5Config, Format, Status, compute_sigma
from ..ops.convert import build_csr5, build_csr5_autotuned, csr5_to_csr
from ..ops.csr5_spmv import csr5_spmm, csr5_spmv
from ..ops.reference import csr_spmv
from .formats import CSR5Matrix, CSRMatrix


class SpMVHandle:
    """Stateful matrix handle with the reference's lifecycle semantics."""

    def __init__(self, m: int, n: int):
        self.shape = (int(m), int(n))
        self._format: Optional[Format] = None
        self._csr: Optional[CSRMatrix] = None
        self._csr5: Optional[CSR5Matrix] = None
        self._host_csr = None  # host-side (row_ptr, col_idx, values, shape)
        self._x: Optional[jax.Array] = None
        self._sigma: int = AUTO_TUNED_SIGMA

    # -- lifecycle (anonymouslib_cuda.h:62-103,106-220) -------------------

    def warmup(self) -> "SpMVHandle":
        """Stabilise compilation caches before timing (format_cuda.h:7-19).

        The analogue of the reference's warmup kernel is forcing the jit
        trace and compile ahead of the timed region.
        """
        if self._format == Format.CSR5:
            _ = self.spmv(1.0)
        return self

    def input_csr(self, nnz: int, row_ptr, col_idx, values) -> "SpMVHandle":
        # a re-input replaces ALL matrix state (a stale host copy from an
        # earlier input would otherwise win over device-array input in
        # as_csr5 and silently convert the wrong matrix)
        self._host_csr = None
        self._csr5 = None
        if not isinstance(values, jax.Array):
            # keep a host copy: conversion is host-side, so host input
            # need not be read back from the device
            self._host_csr = (
                np.asarray(row_ptr, np.int64),
                np.asarray(col_idx, np.int32),
                np.asarray(values),
                self.shape,
            )
        row_ptr = jnp.asarray(row_ptr, jnp.int32)
        col_idx = jnp.asarray(col_idx, jnp.int32)
        values = jnp.asarray(values)
        if int(row_ptr[-1]) != nnz or col_idx.shape[0] != nnz:
            raise ValueError(f"inconsistent nnz={nnz} (Status.INVALID_HANDLE)")
        self._csr = CSRMatrix(row_ptr, col_idx, values, self.shape)
        self._format = Format.CSR
        return self

    def as_csr5(self) -> "SpMVHandle":
        if self._format == Format.CSR5:
            return self
        if self._csr is None:
            raise ValueError("inputCSR first (Status.INVALID_HANDLE)")
        sigma = self.compute_sigma()
        cfg = CSR5Config(sigma=sigma)
        src = self._host_csr if self._host_csr is not None else self._csr
        if self._sigma == AUTO_TUNED_SIGMA:
            # auto sigma: the structure-aware re-tune (computeSigma
            # extended: a scattered conversion rebuilds at a smaller
            # sigma). An explicit setSigma skips it, like the reference's
            # fixed-sigma path (anonymouslib_cuda.h:295).
            self._csr5 = build_csr5_autotuned(src, cfg)
        else:
            self._csr5 = build_csr5(src, cfg)
        self._format = Format.CSR5
        return self

    def as_csr(self) -> "SpMVHandle":
        if self._format == Format.CSR:
            return self
        if self._csr5 is None:
            raise ValueError("asCSR5 first (Status.INVALID_HANDLE)")
        self._csr = csr5_to_csr(self._csr5)
        self._csr5 = None
        self._format = Format.CSR
        return self

    def set_x(self, x) -> "SpMVHandle":
        """Bind the dense x vector (setX analogue; the CUDA texture-object
        binding of anonymouslib_cuda.h:222-260 has no equivalent here: x
        is an ordinary device array)."""
        x = jnp.asarray(x)
        if x.shape[0] != self.shape[1]:
            raise ValueError("x length != n (Status.INVALID_HANDLE)")
        self._x = x
        return self

    def set_sigma(self, sigma: int) -> "SpMVHandle":
        """Select sigma or request auto-tuning (anonymouslib_cuda.h:295-318).

        Like the OpenCL backend's re-JIT on setSigma
        (anonymouslib_opencl.h:363-479), changing sigma re-specialises the
        jitted executor (sigma is a static argument)."""
        self._sigma = int(sigma)
        if self._format == Format.CSR5:
            # force re-conversion with the new sigma
            self.as_csr()
            self.as_csr5()
        return self

    def compute_sigma(self) -> int:
        m, _ = self.shape
        nnz = self._csr.nnz if self._csr is not None else 0
        return compute_sigma(m, nnz, self._sigma)

    def spmv(self, alpha, y_out=None) -> jax.Array:
        """y = alpha * A @ x (anonymouslib_cuda.h:262-285)."""
        if self._x is None:
            raise ValueError("setX first (Status.INVALID_HANDLE)")
        if self._format == Format.CSR5:
            y = csr5_spmv(self._csr5, self._x, alpha)
        elif self._format == Format.CSR:
            y = csr_spmv(self._csr, self._x, alpha)
        else:
            raise ValueError("no matrix loaded (Status.INVALID_HANDLE)")
        return y

    def spmm(self, x_mat, alpha=1.0) -> jax.Array:
        """Y = alpha * A @ X for X (n, R) (multi-rhs extension; the
        reference has no SpMM -- BASELINE.json configs[3])."""
        x_mat = jnp.asarray(x_mat)
        if x_mat.ndim != 2 or x_mat.shape[0] != self.shape[1]:
            raise ValueError("X must be (n, R) (Status.INVALID_HANDLE)")
        if self._format != Format.CSR5:
            raise ValueError("asCSR5 first (Status.INVALID_HANDLE)")
        return csr5_spmm(self._csr5, x_mat, alpha)

    def destroy(self) -> int:
        """Release state; converts back to CSR first like the reference's
        destroy() -> asCSR() (anonymouslib_cuda.h:287-292)."""
        if self._format == Format.CSR5:
            self.as_csr()
        self._csr = None
        self._csr5 = None
        self._host_csr = None
        self._x = None
        self._format = None
        return int(Status.SUCCESS)

    # -- camelCase aliases for reference-driver parity --------------------
    inputCSR = input_csr
    asCSR5 = as_csr5
    asCSR = as_csr
    setX = set_x
    setSigma = set_sigma
    computeSigma = compute_sigma

    # -- introspection -----------------------------------------------------
    @property
    def format(self) -> Optional[Format]:
        return self._format

    @property
    def csr5(self) -> Optional[CSR5Matrix]:
        return self._csr5

    @property
    def csr(self) -> Optional[CSRMatrix]:
        return self._csr
