"""Solve a 2D Poisson problem with CG on the CSR5 executor.

    python examples/poisson_cg.py [grid_side]

Builds the standard 5-point finite-difference Laplacian (SPD, 5
diagonals), converts to CSR5, and solves A x = b with the framework's
conjugate-gradient solver. Runs on whatever backend JAX selects (the GPU
when one is present, the CPU otherwise).
"""

import sys
import time

import jax
import numpy as np
import scipy.sparse as sp

sys.path.insert(0, ".")

from benchmark_spmv_using_csr5_tpu import build_csr5, csr5_spmv
from benchmark_spmv_using_csr5_tpu.models import solvers


def laplacian_2d(k: int) -> sp.csr_matrix:
    one = np.ones(k)
    t = sp.diags([-one, 2 * one, -one], [-1, 0, 1], shape=(k, k))
    eye = sp.identity(k)
    return (sp.kron(eye, t) + sp.kron(t, eye)).tocsr().astype(np.float32)


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    a = laplacian_2d(k)
    m = a.shape[0]
    print(f"2D Poisson {k}x{k}: m={m}, nnz={a.nnz}")

    a5 = build_csr5((a.indptr, a.indices, a.data, a.shape))
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(m).astype(np.float32)
    b = (a @ x_true).astype(np.float32)

    # the matrix is a jit argument (a closure would embed it as constants)
    solve = jax.jit(
        lambda a5, b: solvers.conjugate_gradient(lambda v: csr5_spmv(a5, v), b, iters=300)
    )
    t0 = time.perf_counter()
    x, res = solve(a5, b)
    x = np.asarray(x)
    dt = time.perf_counter() - t0
    rel = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
    print(f"CG 300 iters in {dt:.2f} s  |r|/|b| = {rel:.2e}")


if __name__ == "__main__":
    main()
