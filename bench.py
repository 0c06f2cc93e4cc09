#!/usr/bin/env python
"""Round benchmark: ``python bench.py``.

Runs every case of :data:`CASES` in ONE case_runner child process (the
only process that touches the device) and
prints JSON summary lines to stdout; the LAST line is the round result:
  {"metric": ..., "value": N, "unit": ..., "check": bool, "device": {...}, ...}

Primary metric: CSR5 SpMV percent of the device's published peak memory
bandwidth (the reference bytes model, detail/utils.h:10-16) on banded500k.
The child prints one JSON line per finished case; this parent re-emits
the cumulative summary after every case, so the latest complete summary
is always the last stdout line, and writes the full record to
``BENCH_full.json``.
"""

import json
import os
import subprocess
import sys
import threading

#: the primary first, then the seconds-scale cases, then the big ones
CASES = [
    "banded500k",
    "dia_tridiag500k",
    "f64_banded500k",  # IEEE f64 (the reference's default value type)
    "hybmix400k",  # HYB5 format slot: banded core + noise vs pure CSR5
    "scrambled300k",
    "scrambled300k_rcm",
    "mtx_lap2d_490k",
    "mtx_powlaw300k",
    "scatband300k",
    "powerlaw200k",
    "dist1_banded500k",  # distributed path on a 1-device mesh
    "fem3block600k",  # FEM dense-row-block class (cant/consph shape)
    "dia_banded2M",
    "spmm8_banded500k",
    "spmm16_banded500k",  # band-block path: one dense read for all rhs
    "spmmf8_banded500k",  # float-valued SpMM: the bandmm precision gate
    "banded2M",
    "banded20M",
]
PRIMARY = "banded500k"
#: wall-clock bound on the whole child run
TIMEOUT_S = 3000

_here = os.path.dirname(os.path.abspath(__file__))


def _summary(results: dict) -> dict:
    """COMPACT summary (well under 1 KB): per-case extras go to
    BENCH_full.json and the earlier stdout line."""
    primary = results.get(PRIMARY)
    out = {
        "metric": "csr5_spmv_pct_peak_bw_banded500k_f32",
        "value": primary["pct_roofline"] if primary else 0.0,
        "unit": (
            f"% of {primary['roofline_gbps']:g} GB/s ({primary['device']['kind']})"
            if primary
            else "%"
        ),
        "check": len(results) == len(CASES)
        and all(r.get("check_ok", False) for r in results.values()),
        "cases_done": len(results),
        "cases_total": len(CASES),
        "full": "BENCH_full.json",
    }
    if primary:
        out["gflops"] = primary["gflops"]
        out["gnnz_per_s"] = round(primary["nnz_per_sec"] / 1e9, 3)
        out["primary_ms"] = primary["spmv_ms"]
        out["device"] = primary["device"]
    else:
        out["error"] = "primary benchmark did not land"
    return out


def _full_record(results: dict) -> dict:
    """The complete per-case record: compact fields + full extras."""
    out = _summary(results)
    out["extras"] = {
        k: {kk: vv for kk, vv in r.items() if kk != "name"}
        for k, r in results.items()
    }
    return out


def _emit(results: dict) -> None:
    """Write the full record to BENCH_full.json, print the full extras on
    an earlier stdout line, and print the compact summary LAST."""
    full = _full_record(results)
    with open(os.path.join(_here, "BENCH_full.json"), "w") as f:
        json.dump(full, f)
    print(json.dumps(full), flush=True)
    print(json.dumps(_summary(results)), flush=True)


def run_suite(names, results) -> None:
    """Run ``names`` in one case_runner child, collecting its results."""
    from benchmark_spmv_using_csr5_tpu.utils.compile_cache import compile_cache_dir

    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=compile_cache_dir())
    proc = subprocess.Popen(
        [sys.executable, "-m", "benchmark_spmv_using_csr5_tpu.bench.case_runner", *names],
        stdout=subprocess.PIPE,
        stderr=sys.stderr,
        text=True,
        cwd=_here,
        env=env,
    )
    # a hung child is killed, which ends the read loop below
    timer = threading.Timer(TIMEOUT_S, proc.kill)
    timer.start()
    try:
        for line in proc.stdout:
            try:
                res = json.loads(line)
            except ValueError:
                continue
            if "hb" in res:  # progress heartbeat, not a result
                continue
            name = res.get("name")
            if "error" in res:
                print(f"[{name}] failed: {res['error']}", file=sys.stderr)
                continue
            results[name] = res
            _emit(results)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def main():
    results = {}
    run_suite(CASES, results)
    _emit(results)


if __name__ == "__main__":
    main()
