"""PageRank over a synthetic power-law web graph via CSR5 SpMV.

    python examples/pagerank.py [nodes]
"""

import sys
import time

import jax
import numpy as np
import scipy.sparse as sp

sys.path.insert(0, ".")

from benchmark_spmv_using_csr5_tpu import build_csr5, csr5_spmv
from benchmark_spmv_using_csr5_tpu.models import solvers
from benchmark_spmv_using_csr5_tpu.utils import synth


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    g = sp.csr_matrix(synth.power_law(n, n, 12.0, dtype=np.float32))
    g.data[:] = 1.0
    # column-stochastic transition matrix P^T (rank flows along P^T r)
    out_deg = np.maximum(np.asarray(g.sum(axis=1)).ravel(), 1.0)
    pt = sp.diags(1.0 / out_deg) @ g
    pt = sp.csr_matrix(pt.T).astype(np.float32)
    print(f"graph: n={n}, edges={g.nnz}")

    a5 = build_csr5((pt.indptr, pt.indices, pt.data, pt.shape))
    # the matrix is a jit argument (a closure would embed it as constants)
    rank = jax.jit(
        lambda a5: solvers.pagerank(lambda v: csr5_spmv(a5, v), n, damping=0.85, iters=50)
    )
    t0 = time.perf_counter()
    r = np.asarray(rank(a5))
    dt = time.perf_counter() - t0
    top = np.argsort(r)[-5:][::-1]
    print(f"PageRank 50 iters in {dt:.2f} s; top nodes: {top} (mass {r[top].sum():.3f})")


if __name__ == "__main__":
    main()
