"""The benchmark record must stay machine-parseable.

A reader of bench.py's output parses the FINAL stdout line; these tests
pin the contract: the compact summary stays small no matter how many
cases land, names its device and peak, and reports check=false unless
every case landed and passed.
"""

import importlib.util
import json
import os

_here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, fname):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_here, fname)
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def _fake_results(names):
    # representative per-case payload (the convert_phases_ms dicts are
    # the bulk of it)
    case = {
        "gflops": 132.5,
        "pct_roofline": 99.0,
        "spmv_ms": 0.2122,
        "nnz_per_sec": 6.6e10,
        "backend": "csr5",
        "check_ok": True,
        "max_rel_err": 0.0,
        "sigma": 24,
        "convert_ms": 38400.0,
        "convert_phases_ms": {
            "malloc": 872.3,
            "tile_ptr": 196.7,
            "tile_desc": 217.8,
            "plan": 1651.1,
            "transpose": 3339.1,
            "upload": 29672.4,
        },
        "roofline_gbps": 3350.0,
        "device": _DEVICE,
    }
    return {n: dict(case) for n in names}


def test_compact_summary_fits_driver_tail():
    bench = _load("bench_mod", "bench.py")
    for n in (0, 1, 15, 40):
        names = ["banded500k"] + [f"case{i}" for i in range(n)]
        line = json.dumps(bench._summary(_fake_results(names)))
        assert len(line) < 1024, (n, len(line))
    s = bench._summary(_fake_results(bench.CASES))
    assert s["value"] == 99.0
    assert s["primary_ms"] == 0.2122
    assert s["check"] is True
    assert s["unit"] == "% of 3350 GB/s (NVIDIA H100 80GB HBM3)"
    assert s["device"] == _DEVICE
    assert "extras" not in s
    full = bench._full_record(_fake_results(bench.CASES))
    assert "extras" in full and "banded500k" in full["extras"]
    # a case that did not land fails the check
    partial = _fake_results(bench.CASES[:-1])
    assert bench._summary(partial)["check"] is False


def test_compact_summary_without_primary():
    bench = _load("bench_mod", "bench.py")
    s = bench._summary({})
    assert s["value"] == 0.0 and "error" in s and s["check"] is False
    assert len(json.dumps(s)) < 1024
