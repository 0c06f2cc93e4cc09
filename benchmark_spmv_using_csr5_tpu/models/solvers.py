"""Iterative solvers built on CSR5 SpMV -- the library's "model families".

The reference is a kernel benchmark with no end-user algorithms; these
solvers are the standard consumers of SpMV and demonstrate the framework
end-to-end (single-device and distributed). All are jittable with static
iteration counts via ``lax.fori_loop``/``lax.while_loop``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

SpMV = Callable[[jax.Array], jax.Array]


@partial(jax.jit, static_argnames=("spmv", "max_iters"))
def cg_solve(
    spmv: SpMV, b: jax.Array, tol: float = 0.0, max_iters: int = 50
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """CG for SPD A until ||r|| <= tol * ||b|| or ``max_iters`` steps.

    Returns (x, final residual norm, iterations taken)."""
    x0 = jnp.zeros_like(b)
    rs0 = jnp.vdot(b, b)
    stop = jnp.asarray(tol, rs0.dtype) ** 2 * rs0

    def cond(state):
        i, _, _, _, rs = state
        return (i < max_iters) & (rs > stop)

    def body(state):
        i, x, r, p, rs = state
        ap = spmv(p)
        denom = jnp.vdot(p, ap)
        alpha = jnp.where(denom != 0, rs / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        beta = jnp.where(rs != 0, rs_new / rs, 0.0)
        p = r + beta * p
        return i + 1, x, r, p, rs_new

    i, x, _, _, rs = jax.lax.while_loop(cond, body, (0, x0, b, b, rs0))
    return x, jnp.sqrt(rs), i


def conjugate_gradient(
    spmv: SpMV, b: jax.Array, iters: int = 50, tol: float = 0.0
) -> Tuple[jax.Array, jax.Array]:
    """CG for SPD A: ``iters`` steps, or fewer once ||r|| <= tol * ||b||.
    Returns (x, final residual norm)."""
    x, res, _ = cg_solve(spmv, b, tol, iters)
    return x, res


@partial(jax.jit, static_argnames=("spmv", "iters"))
def bicgstab(spmv: SpMV, b: jax.Array, iters: int = 50) -> Tuple[jax.Array, jax.Array]:
    """BiCGSTAB for general square A."""
    x = jnp.zeros_like(b)
    r = b
    rhat = r
    rho = alpha = omega = jnp.asarray(1.0, b.dtype)
    v = p = jnp.zeros_like(b)

    def body(_, state):
        x, r, rho, alpha, omega, v, p = state
        rho_new = jnp.vdot(rhat, r)
        beta = (rho_new / jnp.where(rho == 0, 1.0, rho)) * (
            alpha / jnp.where(omega == 0, 1.0, omega)
        )
        p = r + beta * (p - omega * v)
        v = spmv(p)
        denom = jnp.vdot(rhat, v)
        alpha = rho_new / jnp.where(denom == 0, 1.0, denom)
        s = r - alpha * v
        t = spmv(s)
        tt = jnp.vdot(t, t)
        omega = jnp.where(tt != 0, jnp.vdot(t, s) / tt, 0.0)
        x = x + alpha * p + omega * s
        r = s - omega * t
        return x, r, rho_new, alpha, omega, v, p

    x, r, *_ = jax.lax.fori_loop(0, iters, body, (x, r, rho, alpha, omega, v, p))
    return x, jnp.linalg.norm(r)


@partial(
    jax.jit, static_argnames=("spmv_lo", "spmv_hi", "outer_iters", "inner_iters")
)
def iterative_refinement(
    spmv_lo: SpMV,
    spmv_hi: SpMV,
    b: jax.Array,
    outer_iters: int = 5,
    inner_iters: int = 50,
) -> Tuple[jax.Array, jax.Array]:
    """Mixed-precision solve of SPD ``A x = b`` to high-precision accuracy.

    Iterative refinement: the inner CG runs on the cheaper low-precision
    operator (``spmv_lo``, e.g. an f32 matrix), while residuals are formed
    with the high-precision operator (``spmv_hi``, e.g. an f64 matrix,
    which moves twice the bytes per SpMV). Error contracts by ~the f32 accuracy factor per outer
    iteration, reaching f64-level solution accuracy with a handful of
    cheap-inner-solve rounds. Returns (x_hi, final residual norm).
    """
    dtype_hi = b.dtype
    x = jnp.zeros_like(b)

    def outer(_, x):
        r = b - spmv_hi(x)
        d, _ = conjugate_gradient(
            spmv_lo, r.astype(jnp.float32), iters=inner_iters
        )
        return x + d.astype(dtype_hi)

    x = jax.lax.fori_loop(0, outer_iters, outer, x)
    r = b - spmv_hi(x)
    return x, jnp.linalg.norm(r)


@partial(jax.jit, static_argnames=("spmv", "n", "iters", "seed", "dtype"))
def power_iteration(
    spmv: SpMV, n: int, iters: int = 100, seed: int = 0, dtype=jnp.float32
) -> Tuple[jax.Array, jax.Array]:
    """Dominant eigenpair of A by power iteration."""
    v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, v):
        w = spmv(v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = jax.lax.fori_loop(0, iters, body, v0)
    lam = jnp.vdot(v, spmv(v))
    return lam, v


@partial(jax.jit, static_argnames=("spmv_T", "n", "iters", "dtype"))
def pagerank(
    spmv_T: SpMV, n: int, damping: float = 0.85, iters: int = 50, dtype=jnp.float32
) -> jax.Array:
    """PageRank via repeated A^T @ r (spmv_T must apply the column-
    stochastic transition matrix)."""
    r = jnp.full((n,), 1.0 / n, dtype)

    def body(_, r):
        r = damping * spmv_T(r) + (1.0 - damping) / n
        return r / jnp.maximum(jnp.sum(r), 1e-30)

    return jax.lax.fori_loop(0, iters, body, r)


@partial(jax.jit, static_argnames=("spmv", "restart", "outer_iters"))
def gmres(
    spmv: SpMV, b: jax.Array, restart: int = 20, outer_iters: int = 5
) -> Tuple[jax.Array, jax.Array]:
    """Restarted GMRES(m) for general square A.

    Arnoldi with modified Gram-Schmidt inside ``fori_loop`` (the
    orthogonalisation loop is masked to the current column, keeping the
    trace static), then the small (m+1, m) least-squares solve on
    device. Returns (x, final residual norm).
    """
    m = restart
    n = b.shape[0]

    def cycle(_, x):
        r = b - spmv(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), b.dtype)
        V = V.at[0].set(r / jnp.where(beta > 1e-30, beta, 1.0))
        H = jnp.zeros((m + 1, m), b.dtype)

        def arnoldi(j, VH):
            V, H = VH
            w = spmv(V[j])

            def mgs(i, wH):
                w, H = wH
                hij = jnp.where(i <= j, jnp.vdot(V[i], w), 0.0)
                return w - hij * V[i], H.at[i, j].set(hij)

            w, H = jax.lax.fori_loop(0, m + 1, mgs, (w, H))
            hn = jnp.linalg.norm(w)
            H = H.at[j + 1, j].add(hn - H[j + 1, j])
            V = V.at[j + 1].set(w / jnp.where(hn > 1e-30, hn, 1.0))
            return V, H

        V, H = jax.lax.fori_loop(0, m, arnoldi, (V, H))
        e1 = jnp.zeros(m + 1, b.dtype).at[0].set(beta)
        y = jnp.linalg.lstsq(H, e1)[0]
        return x + V[:m].T @ y

    x = jax.lax.fori_loop(0, outer_iters, cycle, jnp.zeros_like(b))
    return x, jnp.linalg.norm(b - spmv(x))


@partial(jax.jit, static_argnames=("spmv", "iters"))
def lanczos(
    spmv: SpMV, v0: jax.Array, iters: int = 30
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Symmetric Lanczos tridiagonalisation (no reorthogonalisation).

    Returns (alphas, betas, eigvals of the tridiagonal T) — the extremal
    eigenvalues of T approximate A's spectrum edges (condition-number
    estimation for the CG/IR solvers).
    """
    v = v0 / jnp.linalg.norm(v0)
    init = (
        jnp.zeros_like(v),
        v,
        jnp.asarray(0.0, v.dtype),
        jnp.zeros(iters, v.dtype),
        jnp.zeros(iters, v.dtype),
    )

    def body(j, st):
        v_prev, v, beta_prev, al, be = st
        w = spmv(v) - beta_prev * v_prev
        alpha = jnp.vdot(v, w)
        w = w - alpha * v
        beta = jnp.linalg.norm(w)
        v_next = w / jnp.where(beta > 1e-30, beta, 1.0)
        return v, v_next, beta, al.at[j].set(alpha), be.at[j].set(beta)

    _, _, _, al, be = jax.lax.fori_loop(0, iters, body, init)
    T = (
        jnp.diag(al)
        + jnp.diag(be[:-1], 1)
        + jnp.diag(be[:-1], -1)
    )
    return al, be, jnp.linalg.eigvalsh(T)
