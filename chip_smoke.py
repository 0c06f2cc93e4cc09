#!/usr/bin/env python
"""Smoke run of the library's main path on NVIDIA GPUs, in one process.

    python chip_smoke.py             # one GPU: phases 1-5 below
    python chip_smoke.py --cards 4   # four GPUs: the multi-card path only

Every phase goes through the public entry points and is checked against a
scipy oracle (computed in f64) at a stated tolerance; a failed check
raises, so the exit code is non-zero. Each timed phase prints the
device-loop ms per call, GB/s by the reference byte model (getB,
detail/utils.h:10-16) and that rate's share of the card's published peak
(utils/perf.py).

1. CSR5 the user's way: banded2M (2M rows, 28 diagonals, 56M nnz) through
   SpMVHandle and through build_csr5 + csr5_spmv, exact; a 1M-row
   power-law matrix with real values; the plain segment-sum CSR SpMV
   (ops/reference.csr_spmv) timed beside the CSR5 executor on both.
2. SpMM, R=8 and R=16 on banded500k: csr5_spmm and the band-block product
   at HIGHEST, exact; the band-block product on real values at HIGHEST
   (no TF32) and with a forced bf16 plane.
3. select_format -> DIA on a tridiagonal 500k matrix and on banded2M
   (bf16 planes, exact); HYB5 on the hybmix400k matrix.
4. IEEE f64 on banded500k with real values.
5. The 700x700 9-point Laplacian written as .mtx, read back with the
   native loader, solved with CG in f64.

With ``--cards 4``: an SPD banded 8M-row matrix through distributed_spmv
(all-gather and halo exchange), distributed_spmm, distributed_dia_spmv and
CG on the distributed operator, each compared with the one-card executor
and scipy.

The earlier lines name the card (nvidia-smi), the jax/jaxlib versions,
XLA_FLAGS and the compile-cache directory; the last line is one JSON
object: {"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}.
The script refuses to run (non-zero exit, no result line) when JAX finds
no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: rows of the banded matrix of the multi-card path
FOUR_CARD_ROWS = 8_000_000


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--cards",
        type=int,
        choices=(1, 4),
        default=1,
        help="1: the one-GPU phases; 4: only the multi-card path",
    )
    return ap.parse_args(argv)


def require_gpus(count: int) -> list:
    """The JAX devices, or SystemExit when there are not ``count`` GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found platform {devs[0].platform!r}"
        )
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs; JAX found {len(devs)}")
    return devs


def print_environment(cache_dir: str) -> None:
    import jax
    import jaxlib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache_dir}")


def rel_err(y, y_ref) -> float:
    """max_i |y_i - ref_i| / |ref_i| (0 where both are 0), on device."""
    import jax.numpy as jnp

    ref = jnp.asarray(y_ref)
    d = jnp.abs(jnp.asarray(y).astype(ref.dtype) - ref)
    return float(jnp.max(jnp.where(d == 0, 0.0, d / jnp.abs(ref))))


def check(phase: str, err: float, tol: float) -> None:
    print(f"[{phase}] max rel err {err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{phase}: max rel err {err:.3e} > tol {tol:.3e}")


def timed(phase: str, fn, operands, x, m, nnz, value_bytes, num_rhs=1, num_run=50):
    """Device-loop ms of ``fn(operands, x)`` with getB GB/s and share of
    the card's peak."""
    from benchmark_spmv_using_csr5_tpu.bench.harness import time_spmv_device_loop
    from benchmark_spmv_using_csr5_tpu.utils import perf

    ms = time_spmv_device_loop(fn, x, num_run, operands=operands)
    met = perf.spmv_metrics(
        m, nnz, ms, value_bytes, num_rhs=num_rhs, n=x.shape[0]
    )
    print(
        f"[{phase}] {ms:.4f} ms, {met.gbps:.1f} GB/s (getB), "
        f"{met.pct_of_roofline:.1f}% of {met.roofline_gbps:g} GB/s",
        flush=True,
    )
    return ms


def _host(a):
    return (a.indptr, a.indices, a.data, a.shape)


def phase_csr5(rng):
    import jax.numpy as jnp

    from benchmark_spmv_using_csr5_tpu import (
        SpMVHandle,
        build_csr5,
        csr5_spmv,
        csr_from_numpy,
        csr_spmv,
    )
    from benchmark_spmv_using_csr5_tpu.utils import synth

    a = synth.banded(2_000_000, 27, dtype=np.float32)  # integers in [1, 9]
    m, n = a.shape
    x = rng.integers(1, 10, n).astype(np.float32)
    y_ref = a.astype(np.float64) @ x.astype(np.float64)

    t0 = time.perf_counter()
    h = SpMVHandle(m, n).input_csr(a.nnz, a.indptr, a.indices, a.data)
    h.as_csr5().set_x(x)
    print(f"[csr5 handle banded2M] as_csr5 {1e3 * (time.perf_counter() - t0):.0f} ms")
    check("csr5 handle banded2M", rel_err(h.spmv(1.0), y_ref), 0.0)

    t0 = time.perf_counter()
    a5 = build_csr5(_host(a), value_dtype="auto")
    print(
        f"[csr5 banded2M] build_csr5 {1e3 * (time.perf_counter() - t0):.0f} ms, "
        f"sigma {a5.sigma}, values {a5.val_tiles.dtype}"
    )
    xd = jnp.asarray(x)
    check("csr5 banded2M", rel_err(csr5_spmv(a5, xd), y_ref), 0.0)
    timed("csr5 banded2M", csr5_spmv, a5, xd, m, a.nnz, 4)
    csr = csr_from_numpy(a.indptr, a.indices, a.data, a.shape)
    check("segment-sum banded2M", rel_err(csr_spmv(csr, xd), y_ref), 0.0)
    timed("segment-sum banded2M", csr_spmv, csr, xd, m, a.nnz, 4)
    del h, a5, csr

    # real values: the CSR5 executor takes f32 prefix sums over each
    # 1024-element tile, and a row's sum is the difference of two running
    # prefixes, so its rounding error scales with the tile's prefix mass
    # (up to ~1e3 times a short row's own sum here), not with the row: the
    # tolerance is the reference's own 1% gate (main.cu:361-384), and the
    # segment-sum oracle is held to the same. Values and x are positive.
    p = synth.power_law(1_000_000, 1_000_000, 8.0, dtype=np.float32)
    p.data = rng.uniform(0.1, 1.0, p.nnz).astype(np.float32)
    xp = rng.uniform(0.5, 1.5, p.shape[1]).astype(np.float32)
    yp_ref = p.astype(np.float64) @ xp.astype(np.float64)
    p5 = build_csr5(_host(p), value_dtype="auto")
    xpd = jnp.asarray(xp)
    print(f"[csr5 powerlaw1M] nnz {p.nnz}, sigma {p5.sigma}")
    check("csr5 powerlaw1M", rel_err(csr5_spmv(p5, xpd), yp_ref), 1e-2)
    timed("csr5 powerlaw1M", csr5_spmv, p5, xpd, p.shape[0], p.nnz, 4)
    pcsr = csr_from_numpy(p.indptr, p.indices, p.data, p.shape)
    check("segment-sum powerlaw1M", rel_err(csr_spmv(pcsr, xpd), yp_ref), 1e-2)
    timed("segment-sum powerlaw1M", csr_spmv, pcsr, xpd, p.shape[0], p.nnz, 4)
    return a  # banded2M, reused by the DIA phase


def phase_spmm(rng):
    import jax.numpy as jnp
    import ml_dtypes

    from benchmark_spmv_using_csr5_tpu import build_csr5, csr5_spmm
    from benchmark_spmv_using_csr5_tpu.ops.bandmm import bandmm_spmm, build_bandblock
    from benchmark_spmv_using_csr5_tpu.utils import synth

    a = synth.banded(500_000, 27, dtype=np.float32)
    m, n = a.shape
    a5 = build_csr5(_host(a), value_dtype="auto")
    bb = build_bandblock(_host(a), value_dtype=np.float32)
    for R in (8, 16):
        xm = rng.integers(1, 10, (n, R)).astype(np.float32)
        y_ref = a.astype(np.float64) @ xm.astype(np.float64)
        xd = jnp.asarray(xm)
        check(f"csr5_spmm R={R}", rel_err(csr5_spmm(a5, xd), y_ref), 0.0)
        timed(f"csr5_spmm R={R}", csr5_spmm, a5, xd, m, a.nnz, 4, num_rhs=R)
        fn = lambda b_, x_: bandmm_spmm(b_, x_, precision="highest")  # noqa: E731
        check(f"bandmm highest R={R}", rel_err(fn(bb, xd), y_ref), 0.0)
        timed(f"bandmm highest R={R}", fn, bb, xd, m, a.nnz, 4, num_rhs=R)

    # real values: the auto gate keeps an f32 plane and multiplies at
    # HIGHEST (f32 products; TF32 would show ~1e-3); a forced bf16 plane
    # rounds both operands to 8 mantissa bits: <= 2^-8 relative for sums
    # of positive terms
    a.data = rng.uniform(0.1, 1.0, a.nnz).astype(np.float32)
    xm = rng.uniform(0.5, 1.5, (n, 8)).astype(np.float32)
    y_ref = a.astype(np.float64) @ xm.astype(np.float64)
    xd = jnp.asarray(xm)
    bb_auto = build_bandblock(_host(a))
    print(f"[bandmm real values] auto plane {bb_auto.dense.dtype}")
    check("bandmm auto real R=8", rel_err(bandmm_spmm(bb_auto, xd), y_ref), 1e-5)
    bb16 = build_bandblock(_host(a), value_dtype=ml_dtypes.bfloat16)
    fn16 = lambda b_, x_: bandmm_spmm(b_, x_, precision="bf16")  # noqa: E731
    check("bandmm bf16 real R=8", rel_err(fn16(bb16, xd), y_ref), 2.0**-8)
    timed("bandmm bf16 real R=8", fn16, bb16, xd, m, a.nnz, 4, num_rhs=8)


def phase_dia_hyb(rng, banded2m):
    import jax.numpy as jnp

    from benchmark_spmv_using_csr5_tpu import (
        build_dia,
        build_hyb,
        dia_spmv,
        hyb_spmv,
        select_format,
    )
    from benchmark_spmv_using_csr5_tpu.bench.case_runner import hybmix_matrix
    from benchmark_spmv_using_csr5_tpu.utils import synth

    tri = synth.banded(500_000, 2, dtype=np.float32)  # offsets -1, 0, 1
    for name, a in (("tridiag500k", tri), ("banded2M", banded2m)):
        fmt = select_format(a.indptr, a.indices, a.shape)
        if fmt != "dia":
            raise AssertionError(f"select_format({name}) = {fmt!r}, expected 'dia'")
        d = build_dia(_host(a), value_dtype="auto")
        x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
        y_ref = a.astype(np.float64) @ x.astype(np.float64)
        xd = jnp.asarray(x)
        print(f"[dia {name}] {d.ndiag} diagonals, plane {d.data.dtype}")
        check(f"dia {name}", rel_err(dia_spmv(d, xd), y_ref), 0.0)
        timed(f"dia {name}", dia_spmv, d, xd, a.shape[0], a.nnz, 4)

    a = hybmix_matrix()
    fmt = select_format(a.indptr, a.indices, a.shape)
    h = build_hyb(_host(a))
    x = rng.integers(1, 10, a.shape[1]).astype(np.float32)
    y_ref = a.astype(np.float64) @ x.astype(np.float64)
    xd = jnp.asarray(x)
    print(
        f"[hyb hybmix400k] select_format -> {fmt}; split "
        f"{h.dia.ndiag if h.dia is not None else 0} diagonals + "
        f"{h.csr5.nnz if h.csr5 is not None else 0} CSR5 nnz"
    )
    check("hyb hybmix400k", rel_err(hyb_spmv(h, xd), y_ref), 0.0)
    timed("hyb hybmix400k", hyb_spmv, h, xd, a.shape[0], a.nnz, 4)


def phase_f64(rng):
    import jax.numpy as jnp

    from benchmark_spmv_using_csr5_tpu import build_csr5, csr5_spmv
    from benchmark_spmv_using_csr5_tpu.bench.case_runner import _f64_banded

    a = _f64_banded(500_000, 27)
    x = rng.uniform(0.5, 1.5, a.shape[1])
    a5 = build_csr5(_host(a))
    if a5.val_tiles.dtype != jnp.float64:
        raise AssertionError(f"f64 values stored as {a5.val_tiles.dtype}")
    xd = jnp.asarray(x)
    # positive terms; f64 prefix differencing keeps ~1e-13 relative
    check("csr5 f64 banded500k", rel_err(csr5_spmv(a5, xd), a @ x), 1e-10)
    timed("csr5 f64 banded500k", csr5_spmv, a5, xd, a.shape[0], a.nnz, 8)


def lap2d_9pt(g: int):
    """The g x g grid's 9-point Laplacian: 8 on the diagonal, -1 for each
    of the 8 neighbours (symmetric, diagonally dominant: SPD)."""
    import scipy.sparse as sp

    m = g * g
    i, j = np.divmod(np.arange(m), g)
    rows, cols = [np.arange(m)], [np.arange(m)]
    vals = [np.full(m, 8.0)]
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == dj == 0:
                continue
            ok = (i + di >= 0) & (i + di < g) & (j + dj >= 0) & (j + dj < g)
            rows.append(np.flatnonzero(ok))
            cols.append((i[ok] + di) * g + j[ok] + dj)
            vals.append(np.full(int(ok.sum()), -1.0))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m, m),
    )


def phase_solver():
    import jax
    import jax.numpy as jnp

    from benchmark_spmv_using_csr5_tpu import build_csr5, csr5_spmv
    from benchmark_spmv_using_csr5_tpu.models.solvers import cg_solve
    from benchmark_spmv_using_csr5_tpu.utils import mmio, nativelib

    data = os.path.join(HERE, "data")
    os.makedirs(data, exist_ok=True)
    path = os.path.join(data, "lap2d9_700.mtx")
    a = lap2d_9pt(700)
    mmio.write_mtx(path, a.indptr, a.indices, a.data, a.shape)
    rp, ci, v, shape = nativelib.load_matrix_market(path)
    print(f"[cg lap2d 700x700] {path}: {shape[0]} rows, {len(v)} nnz")
    a5 = build_csr5((rp, ci, v, shape))
    b = jnp.ones(shape[0], jnp.float64)
    tol = 1e-8
    solve = jax.jit(
        lambda a5, b: cg_solve(lambda p: csr5_spmv(a5, p), b, tol, 20_000)
    )
    t0 = time.perf_counter()
    x, res, iters = solve(a5, b)
    x = np.asarray(x)
    dt = time.perf_counter() - t0
    true_res = np.linalg.norm(1.0 - a @ x) / np.sqrt(shape[0])
    print(
        f"[cg lap2d 700x700] {int(iters)} iterations, {dt:.2f} s incl. compile, "
        f"|r|/|b| {float(res) / np.sqrt(shape[0]):.3e} (recurrence), "
        f"{true_res:.3e} (scipy)"
    )
    check("cg lap2d 700x700 residual", true_res, 1e-7)


def spd_banded(m: int):
    """Symmetric 27-diagonal banded matrix: -1 off the diagonal, 27 on it
    (strictly diagonally dominant, so SPD)."""
    import scipy.sparse as sp

    from benchmark_spmv_using_csr5_tpu.utils import synth

    a = synth.banded(m, 26, dtype=np.float32)  # offsets -13..13
    a.data[:] = -1.0
    return (a + sp.identity(m, dtype=np.float32, format="csr") * 28.0).tocsr()


def phase_four_cards(rng):
    import jax
    import jax.numpy as jnp

    from benchmark_spmv_using_csr5_tpu import build_csr5, csr5_spmm, csr5_spmv
    from benchmark_spmv_using_csr5_tpu.models.solvers import cg_solve
    from benchmark_spmv_using_csr5_tpu.parallel.distributed import (
        distribute_csr,
        distributed_spmm,
        distributed_spmv,
        make_mesh,
    )
    from benchmark_spmv_using_csr5_tpu.parallel.distributed_dia import (
        distribute_dia,
        distributed_dia_spmv,
    )

    m = FOUR_CARD_ROWS
    a = spd_banded(m)
    mesh = make_mesh(4)
    print(f"[4 cards] banded {m} rows, {a.nnz} nnz, mesh {mesh.devices.size} devices")
    x = rng.integers(1, 10, m).astype(np.float32)
    xd = jnp.asarray(x)
    y_ref = a.astype(np.float64) @ x.astype(np.float64)

    a5 = build_csr5(_host(a))
    y1 = csr5_spmv(a5, xd)
    check("1 card csr5_spmv", rel_err(y1, y_ref), 0.0)
    timed("1 card csr5_spmv", csr5_spmv, a5, xd, m, a.nnz, 4)

    for halo in ("none", "auto"):
        t0 = time.perf_counter()
        da = distribute_csr(a.indptr, a.indices, a.data, a.shape, mesh, halo=halo)
        print(
            f"[4 cards halo={halo}] distribute_csr {time.perf_counter() - t0:.1f} s, "
            f"exchange {da.halo}, {da.x_bytes_exchanged():,} B/device"
        )
        if halo == "auto" and da.halo is None:
            raise AssertionError("banded matrix did not take the halo exchange")
        fn = lambda d_, x_: distributed_spmv(d_, x_, mesh)  # noqa: E731
        y = jax.jit(fn)(da, xd)
        check(f"4 cards spmv halo={halo} vs 1 card", rel_err(y, y1), 0.0)
        check(f"4 cards spmv halo={halo} vs scipy", rel_err(y, y_ref), 0.0)
        timed(f"4 cards spmv halo={halo}", fn, da, xd, m, a.nnz, 4)
        if halo == "none":
            da_full = da

    R = 8
    xm = jnp.asarray(rng.integers(1, 10, (m, R)).astype(np.float32))
    ym1 = csr5_spmm(a5, xm)
    ym_ref = a.astype(np.float64) @ np.asarray(xm).astype(np.float64)
    ym = jax.jit(lambda d_, x_: distributed_spmm(d_, x_, mesh))(da_full, xm)
    check(f"4 cards spmm R={R} vs 1 card", rel_err(ym, ym1), 0.0)
    check(f"4 cards spmm R={R} vs scipy", rel_err(ym, ym_ref), 0.0)

    dd = distribute_dia(a, mesh)
    if dd is None:
        raise AssertionError("banded matrix rejected by distribute_dia")
    dfn = lambda d_, x_: distributed_dia_spmv(d_, x_, mesh)  # noqa: E731
    yd = jax.jit(dfn)(dd, xd)
    check("4 cards dia spmv vs 1 card", rel_err(yd, y1), 0.0)
    check("4 cards dia spmv vs scipy", rel_err(yd, y_ref), 0.0)
    timed("4 cards dia spmv", dfn, dd, xd, m, a.nnz, 4)

    # CG in f32 on the distributed operator and on one card: the operator
    # is well conditioned (diagonal 27 against 26 off-diagonal -1s)
    b = jnp.ones(m, jnp.float32)
    tol = 1e-5
    cg4 = jax.jit(
        lambda d_, b_: cg_solve(lambda p: distributed_spmv(d_, p, mesh), b_, tol, 500)
    )
    cg1 = jax.jit(lambda a_, b_: cg_solve(lambda p: csr5_spmv(a_, p), b_, tol, 500))
    x4, r4, it4 = cg4(da_full, b)
    x1, r1, it1 = cg1(a5, b)
    true_res = np.linalg.norm(1.0 - a @ np.asarray(x4, np.float64)) / np.sqrt(m)
    print(
        f"[4 cards cg] {int(it4)} iterations (1 card: {int(it1)}), "
        f"|r|/|b| {true_res:.3e} (scipy)"
    )
    # f32 dot products summed in another order across devices: the two
    # solutions agree to the solve's own accuracy
    check("4 cards cg solution vs 1 card", rel_err(x4, x1), 1e-4)
    check("4 cards cg residual", true_res, 1e-4)


def main(argv=None) -> int:
    args = parse_args(argv)
    devs = require_gpus(args.cards)
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import jax

    from benchmark_spmv_using_csr5_tpu.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)  # f32 phases stay f32
    print_environment(enable_compile_cache())
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_four_cards(rng)
    else:
        banded2m = phase_csr5(rng)
        phase_spmm(rng)
        phase_dia_hyb(rng, banded2m)
        phase_f64(rng)
        phase_solver()
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
