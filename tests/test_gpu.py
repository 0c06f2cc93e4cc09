"""Checks that run only on an NVIDIA GPU (the ``gpu`` marker; they skip
elsewhere). On the card: ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.

They pin what a CPU run cannot show: the card's device_kind is in the peak
table, every executor compiles for the GPU and agrees with scipy, and f32
matrix products at HIGHEST do not drop to TF32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu import build_csr5, build_dia, csr5_spmm, csr5_spmv, dia_spmv
from benchmark_spmv_using_csr5_tpu.ops.bandmm import bandmm_spmm, build_bandblock
from benchmark_spmv_using_csr5_tpu.utils import perf, synth

pytestmark = pytest.mark.gpu


def test_gpu_device_kind_has_a_peak():
    assert perf.device_hbm_gbps(jax.devices()[0].device_kind) > 0


@pytest.mark.parametrize("sigma", [8, 16, 24])
def test_gpu_csr5_exact(sigma):
    from benchmark_spmv_using_csr5_tpu import CSR5Config

    a = sp.csr_matrix(synth.power_law(20_000, 20_000, 8.0, dtype=np.float32))
    a.data = np.random.default_rng(0).integers(1, 10, a.nnz).astype(np.float32)
    a5 = build_csr5((a.indptr, a.indices, a.data, a.shape), CSR5Config(sigma=sigma))
    x = np.random.default_rng(1).integers(1, 10, a.shape[1]).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(csr5_spmv(a5, x)), a @ x)
    xm = np.random.default_rng(2).integers(1, 10, (a.shape[1], 4)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(csr5_spmm(a5, xm)), a @ xm)


def test_gpu_dia_bf16_exact():
    a = sp.csr_matrix(synth.banded(50_000, 27, dtype=np.float32))
    d = build_dia((a.indptr, a.indices, a.data, a.shape), value_dtype="auto")
    assert d.data.dtype == jnp.bfloat16
    x = np.random.default_rng(1).integers(1, 10, a.shape[1]).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(dia_spmv(d, x)), a @ x)


def test_gpu_bandmm_highest_is_not_tf32():
    a = sp.csr_matrix(synth.banded(20_000, 27, dtype=np.float32))
    rng = np.random.default_rng(3)
    a.data = rng.uniform(0.1, 1.0, a.nnz).astype(np.float32)
    bb = build_bandblock((a.indptr, a.indices, a.data, a.shape))
    assert bb.dense.dtype == jnp.float32
    xm = rng.uniform(0.5, 1.5, (a.shape[1], 8)).astype(np.float32)
    y = np.asarray(bandmm_spmm(bb, xm))
    ref = a.astype(np.float64) @ xm.astype(np.float64)
    # TF32 keeps 10 mantissa bits (~1e-3 relative); HIGHEST is f32-exact
    assert (np.abs(y - ref) / ref).max() < 1e-5
