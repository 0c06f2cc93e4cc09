"""CLI: ``python -m benchmark_spmv_using_csr5_tpu.bench.cli <matrix.mtx>``.

Parity with the reference usage ``./spmv example.mtx`` (README.md:27,
main.cu:146-155), extended with synthetic generators and format options:

    cli.py matrix.mtx [--sigma N] [--dtype float32|float64]
           [--num-run N] [--spmm K] [--format csr5|dia|hyb|bandblock|auto]
    cli.py --synthetic banded:500000:27
    cli.py --synthetic powerlaw:1000000:8
    cli.py --synthetic random:100000:0.0001
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import AUTO_TUNED_SIGMA
from ..utils import mmio, synth
from ..utils.compile_cache import enable_compile_cache
from .harness import run_benchmark


def load_matrix(args):
    dtype = np.dtype(args.dtype)
    if args.synthetic:
        kind, *params = args.synthetic.split(":")
        if kind == "banded":
            m, bw = int(params[0]), int(params[1])
            a = synth.banded(m, bw, dtype=dtype)
        elif kind == "powerlaw":
            m, mean = int(params[0]), float(params[1])
            a = synth.power_law(m, m, mean, dtype=dtype)
        elif kind == "random":
            m, dens = int(params[0]), float(params[1])
            a = synth.random_csr(m, m, dens, dtype=dtype)
        elif kind == "scatband":
            m, npr, bw = int(params[0]), int(params[1]), int(params[2])
            a = synth.scattered_band(m, npr, bw, dtype=dtype)
        elif kind == "fem":
            m = int(params[0])
            nb = int(params[1]) if len(params) > 1 else 21
            nbw = int(params[2]) if len(params) > 2 else 1400
            a = synth.fem_blocks(m, neighbors=nb, node_bandwidth=nbw,
                                 dtype=dtype)
        else:
            raise SystemExit(f"unknown synthetic kind {kind!r}")
        return a.indptr, a.indices, a.data.astype(dtype), a.shape, args.synthetic
    if not args.matrix:
        raise SystemExit("usage: cli.py <matrix.mtx> | --synthetic KIND:...")
    rp, ci, v, shape = mmio.read_mtx_csr(args.matrix, dtype=dtype)
    return rp, ci, v, shape, args.matrix


def main(argv=None):
    ap = argparse.ArgumentParser(description="CSR5 SpMV benchmark")
    ap.add_argument("matrix", nargs="?", help=".mtx file (Matrix Market)")
    ap.add_argument(
        "--synthetic",
        help="banded:M:BW | powerlaw:M:MEAN | random:M:DENSITY | "
        "scatband:M:NNZROW:BW | fem:M[:NEIGHBORS[:NODEBW]]",
    )
    ap.add_argument("--sigma", type=int, default=AUTO_TUNED_SIGMA)
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--num-run", type=int, default=50)
    ap.add_argument(
        "--spmm",
        type=int,
        default=1,
        metavar="K",
        help="benchmark SpMM with K right-hand sides instead of SpMV",
    )
    ap.add_argument(
        "--format",
        default="csr5",
        choices=["csr5", "dia", "hyb", "bandblock", "auto"],
        help="storage format: csr5 (general), dia (diagonal-structured; "
        "streams no column indices), hyb (dense diagonals via DIA + "
        "remainder via CSR5), bandblock (dense 128-row band blocks "
        "contracted in one batched matmul — the multi-rhs --spmm path "
        "whose dense plane is read once for all rhs), or auto (one "
        "structural pass picks the format; ops/select.py)",
    )
    ap.add_argument(
        "--autotune",
        action="store_true",
        help="structure-aware sigma re-tune: reconvert at sigma=8 "
        "(short scattered rows) or 16 (long scattered rows) when the "
        "matrix's tiles touch non-contiguous column pages (one extra "
        "conversion pass)",
    )
    ap.add_argument(
        "--reorder",
        choices=["none", "rcm", "auto"],
        default="none",
        help="locality-preserving symmetric permutation before conversion "
        "(bandwidth reduction restores x locality for irregular "
        "matrices; square matrices only). 'auto' detects "
        "scattered-with-recoverable-locality structure and applies RCM "
        "only when it shrinks the bandwidth >=4x (ops/select.py)",
    )
    args = ap.parse_args(argv)
    import jax

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    rp, ci, v, shape, name = load_matrix(args)
    if args.reorder == "auto":
        from ..ops.select import apply_plan, select_plan

        if shape[0] == shape[1]:
            plan = select_plan(rp, ci, shape)
            if plan.reorder is not None:
                (rp, ci, v, shape), _ = apply_plan(
                    (rp, ci, v, shape), plan
                )
                name = f"{name}+{plan.reorder}"
                print(
                    f"[{name}] auto-reorder: bandwidth "
                    f"{plan.bandwidth_before} -> {plan.bandwidth_after} "
                    f"({plan.plan_ms:.0f} ms)"
                )
    elif args.reorder != "none":
        import scipy.sparse as sp

        from ..utils import reorder as _reorder

        if shape[0] != shape[1]:
            raise SystemExit("--reorder requires a square matrix")
        a_perm, _ = _reorder.reorder_for_locality(
            sp.csr_matrix((v, ci, rp), shape=shape), method=args.reorder
        )
        rp, ci, v = a_perm.indptr, a_perm.indices, a_perm.data
        name = f"{name}+{args.reorder}"
    fmt = args.format
    if fmt == "auto":
        from ..ops.select import select_format

        fmt = select_format(rp, ci, shape)
        if args.spmm > 1:
            # multi-rhs: take the band-block path whenever the matrix's
            # 128-row blocks have bounded windows
            from ..ops.bandmm import build_bandblock

            if build_bandblock((rp, ci, v, shape)) is not None:
                fmt = "bandblock"
            elif fmt != "dia":
                fmt = "csr5"
        print(f"[{name}] auto-selected format: {fmt}")
    if fmt == "dia":
        return _run_dia(args, name, rp, ci, v, shape)
    if fmt == "hyb":
        return _run_hyb(args, name, rp, ci, v, shape)
    if fmt == "bandblock":
        return _run_bandblock(args, name, rp, ci, v, shape)
    res = run_benchmark(
        name,
        rp,
        ci,
        v,
        shape,
        sigma=args.sigma,
        num_run=args.num_run,
        num_rhs=args.spmm,
        autotune=args.autotune,
    )
    print(res.report())
    return 0 if res.check_ok else 1


def _run_bandblock(args, name, rp, ci, v, shape):
    """Band-block benchmark path (ops/bandmm.py): dense 128-row blocks
    over bounded column windows, one batched (R,K)@(K,128) contraction
    — the dense plane is read once for all --spmm K rhs."""
    import time

    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp

    from ..ops.bandmm import bandmm_spmm, build_bandblock
    from .harness import rel_err_device, time_spmv_device_loop

    R = max(args.spmm, 1)
    t0 = time.perf_counter()
    bb = build_bandblock((rp, ci, v, shape))
    build_ms = (time.perf_counter() - t0) * 1e3
    if bb is None:
        raise SystemExit(
            "matrix's 128-row blocks have no bounded column windows "
            "(or the dense plane would exceed the waste gate); use "
            "--format csr5"
        )
    rng = np.random.default_rng(0)
    xm = rng.integers(1, 10, (shape[1], R)).astype(np.float32)
    xd = jnp.asarray(xm)
    y_ref = sp.csr_matrix((v.astype(np.float32), ci, rp), shape=shape) @ xm
    rel = rel_err_device(bandmm_spmm(bb, xd), y_ref)
    ok = rel <= 0.01
    ms = time_spmv_device_loop(
        lambda b_, x_: bandmm_spmm(b_, x_), xd, args.num_run, operands=bb
    )
    gflops = 2 * bb.nnz * R / (ms * 1e-3) / 1e9
    print(
        f"[{name}] ({shape[0]}, {shape[1]}) nnz = {bb.nnz}, "
        f"K = {bb.K}, dense = {bb.dense_bytes / 1e6:.0f} MB "
        f"({bb.dense.dtype})\n"
        f"CSR->bandblock time = {build_ms:.3f} ms\n"
        f"bandblock SpMM({R}) time = {ms:.4f} ms "
        f"({ms / R:.4f} ms/rhs), {gflops:.2f} GFlops [bandmm]\n"
        f"Check... {'PASS!' if ok else 'NOT PASS!'} (max rel err {rel:.2e})"
    )
    return 0 if ok else 1


def _run_hyb(args, name, rp, ci, v, shape):
    """HYB5-format benchmark path (SpMV only)."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from ..ops.hyb import build_hyb, hyb_spmv
    from ..utils import perf
    from .harness import time_spmv_device_loop

    if args.spmm > 1:
        raise SystemExit("--format hyb supports SpMV only (--spmm 1)")
    h = build_hyb((rp, ci, v, shape))
    m, n = shape
    rng = np.random.default_rng(0)
    x = rng.integers(1, 10, n).astype(v.dtype)
    y_ref = sp.csr_matrix((v, ci, rp), shape=shape) @ x
    xd = jnp.asarray(x)
    y = np.asarray(hyb_spmv(h, xd))
    maxrel = float(
        (np.abs(y - y_ref) / np.maximum(np.abs(y_ref), 1e-30)).max()
    )
    ms = time_spmv_device_loop(
        lambda h_, x_: hyb_spmv(h_, x_), xd, args.num_run, operands=h
    )
    met = perf.spmv_metrics(m, len(v), ms, v.dtype.itemsize, n=n)
    ok = maxrel <= 0.01
    nd = h.dia.ndiag if h.dia is not None else 0
    cn = h.csr5.nnz_stored if h.csr5 is not None else 0
    print(
        f"[{name}] ({m}, {n}) nnz = {len(v)}, hyb split: {nd} diagonals + "
        f"{cn} csr5 nnz\n"
        f"HYB5-based SpMV time = {ms:.4f} ms, {met.gbps:.2f} GB/s, "
        f"{met.gflops:.2f} GFlops, {met.pct_of_roofline:.1f}% of "
        f"{met.roofline_gbps:g} GB/s (CSR byte model) [hyb]\n"
        f"Check... {'PASS!' if ok else 'NOT PASS!'} (max rel err {maxrel:.2e})"
    )
    return 0 if ok else 1


def _run_dia(args, name, rp, ci, v, shape):
    """DIA-format benchmark path (same report shape as the CSR5 one)."""
    import jax.numpy as jnp
    import scipy.sparse as sp

    from ..ops.dia import build_dia, dia_spmm, dia_spmv
    from ..utils import perf
    from .harness import time_spmv_device_loop

    d = build_dia((rp, ci, v, shape))
    if d is None:
        raise SystemExit(
            "matrix is not diagonal-structured; use --format csr5"
        )
    m, n = shape
    rng = np.random.default_rng(0)
    x = rng.integers(
        1, 10, (n, args.spmm) if args.spmm > 1 else n
    ).astype(v.dtype)
    y_ref = sp.csr_matrix((v, ci, rp), shape=shape) @ x
    fn = dia_spmm if args.spmm > 1 else dia_spmv
    xd = jnp.asarray(x)
    y = np.asarray(fn(d, xd))
    maxrel = float(
        (np.abs(y - y_ref) / np.maximum(np.abs(y_ref), 1e-30)).max()
    )
    ms = time_spmv_device_loop(
        lambda d_, x_: fn(d_, x_), xd, args.num_run, operands=d
    )
    met = perf.spmv_metrics(
        m, len(v), ms, v.dtype.itemsize, num_rhs=args.spmm, n=n
    )
    ok = maxrel <= 0.01
    print(
        f"[{name}] ({m}, {n}) nnz = {len(v)}, ndiag = {d.ndiag}\n"
        f"DIA-based SpMV time = {ms:.4f} ms, {met.gbps:.2f} GB/s, "
        f"{met.gflops:.2f} GFlops, {met.pct_of_roofline:.1f}% of "
        f"{met.roofline_gbps:g} GB/s (CSR byte model) [dia]\n"
        f"Check... {'PASS!' if ok else 'NOT PASS!'} (max rel err {maxrel:.2e})"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
