#!/usr/bin/env python
"""Profile the SpMV executors on the accelerator with jax.profiler.

    python scripts/profile_csr5.py [--out DIR] [--calls N]

Traces N back-to-back calls of the CSR5 executor and of the plain
segment-sum CSR SpMV (ops/reference.csr_spmv) on banded2M (2M rows, 56M
nnz) and on a 1M-row power-law matrix, then reduces each trace to device
time per operation: the operations ranked by total device time, their
share of the device-busy time, and the device's idle share of the traced
window. The raw traces and the optimized HLO of each executor stay under
DIR (default chiprun_out/profile).
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def device_op_times(xplane_path: str) -> dict:
    """{line name: {op name: [total ns, count]}} over the GPU planes, plus
    the busy/idle share of the window on the busiest line."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    lines = {}
    spans = collections.defaultdict(list)
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            key = f"{plane.name} | {line.name}"
            agg = lines.setdefault(key, {})
            for ev in line.events:
                a = agg.setdefault(ev.name, [0.0, 0])
                a[0] += ev.duration_ns
                a[1] += 1
                spans[key].append((ev.start_ns, ev.start_ns + ev.duration_ns))
    shares = {}
    for key, iv in spans.items():
        iv.sort()
        busy, end = 0.0, -1.0
        for s, e in iv:
            if s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        window = iv[-1][1] - iv[0][0] if iv else 0.0
        shares[key] = {"busy_ns": busy, "window_ns": window}
    return {"lines": lines, "busy": shares}


def trace(fn, operands, x, calls: int, outdir: str) -> str:
    import jax

    jax.block_until_ready(fn(operands, x))  # compile outside the trace
    with jax.profiler.trace(outdir):
        for _ in range(calls):
            y = fn(operands, x)
        jax.block_until_ready(y)
    return sorted(glob.glob(os.path.join(outdir, "plugins/profile/*/*.xplane.pb")))[-1]


def report(name: str, red: dict, calls: int) -> dict:
    out = {}
    for key, agg in red["lines"].items():
        total = sum(v[0] for v in agg.values())
        if not total:
            continue
        b = red["busy"][key]
        print(
            f"[{name}] {key}: {total / calls / 1e3:.1f} us/call over "
            f"{len(agg)} ops; busy {b['busy_ns'] / 1e6:.3f} ms of a "
            f"{b['window_ns'] / 1e6:.3f} ms window"
        )
        top = sorted(agg.items(), key=lambda kv: -kv[1][0])[:12]
        for op, (ns, cnt) in top:
            print(
                f"    {ns / total:6.1%}  {ns / calls / 1e3:9.1f} us/call  "
                f"x{cnt // calls:<3d} {op[:110]}"
            )
        out[key] = {
            "us_per_call": total / calls / 1e3,
            "busy_ns": b["busy_ns"],
            "window_ns": b["window_ns"],
            "top": [[op, ns / calls / 1e3, cnt] for op, (ns, cnt) in top],
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out", "profile"))
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from benchmark_spmv_using_csr5_tpu import build_csr5, csr5_spmv, csr_from_numpy, csr_spmv
    from benchmark_spmv_using_csr5_tpu.utils import synth
    from benchmark_spmv_using_csr5_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("profile_csr5: the traces reduce GPU planes; no GPU found")
    enable_compile_cache()
    print(f"device: {jax.devices()[0].device_kind}")
    rng = np.random.default_rng(0)
    banded = synth.banded(2_000_000, 27, dtype=np.float32)
    plaw = synth.power_law(1_000_000, 1_000_000, 8.0, dtype=np.float32)
    results = {}
    for mname, a in (("banded2M", banded), ("powerlaw1M", plaw)):
        x = jnp.asarray(rng.integers(1, 10, a.shape[1]).astype(np.float32))
        host = (a.indptr, a.indices, a.data, a.shape)
        t0 = time.perf_counter()
        a5 = build_csr5(host, value_dtype="auto")
        print(
            f"[{mname}] build_csr5 {time.perf_counter() - t0:.2f} s, sigma "
            f"{a5.sigma}, values {a5.val_tiles.dtype}, packed cols "
            f"{a5.col_packed is not None}, capw {a5.capw}, tiles {a5.num_tiles}"
        )
        csr = csr_from_numpy(*host)
        for ename, fn, ops in (("csr5", csr5_spmv, a5), ("segment_sum", csr_spmv, csr)):
            name = f"{ename} {mname}"
            outdir = os.path.join(args.out, name.replace(" ", "_"))
            path = trace(fn, ops, x, args.calls, outdir)
            results[name] = report(name, device_op_times(path), args.calls)
            # the optimized HLO names the fusions the trace reports
            with open(os.path.join(outdir, "hlo.txt"), "w") as f:
                f.write(jax.jit(fn).lower(ops, x).compile().as_text())
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
