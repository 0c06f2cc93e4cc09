"""Test configuration: CPU backend with an 8-device virtual mesh + x64.

Tests run on the platform JAX_PLATFORMS names, the CPU by default;
multi-device sharding is exercised on a virtual 8-device host mesh, and
f64 oracles need x64 enabled before JAX initialises. Tests that need an
NVIDIA GPU carry the ``gpu`` marker and skip elsewhere; on the card run
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from benchmark_spmv_using_csr5_tpu.utils import synth  # noqa: E402


@pytest.fixture(params=list(synth.EDGE_CASE_MATRICES.keys()))
def edge_matrix(request):
    """One scipy CSR matrix per registered edge case."""
    return request.param, synth.EDGE_CASE_MATRICES[request.param]()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on other platforms)"
    )


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests unless the first device is a GPU; decided
    per test, never at import."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU")
