"""Device-side conversion tests: every jittable stage must match the
host converter value-for-value, and the resulting CSR5Matrix must run.

The reference converts on-device (format_cuda.h:97-744); here the same
claim is checked by building each matrix twice — host numpy/native
pipeline vs jitted stages — and comparing all planes bit-for-bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu import CSR5Config, build_csr5, csr5_spmv_xla, csr_from_scipy
from benchmark_spmv_using_csr5_tpu.models.formats import col_tiles_of
from benchmark_spmv_using_csr5_tpu.ops.convert_device import (
    build_csr5_device,
    plan_statics,
)
from benchmark_spmv_using_csr5_tpu.utils import synth


def _build_both(a_sp, config=None):
    a_sp = sp.csr_matrix(a_sp).astype(np.float32)
    host = build_csr5(csr_from_scipy(a_sp), config)
    statics = plan_statics(a_sp.indptr, a_sp.indices, a_sp.shape, config)
    dev = build_csr5_device(
        jnp.asarray(a_sp.indptr, jnp.int64),
        jnp.asarray(a_sp.indices, jnp.int32),
        jnp.asarray(a_sp.data),
        statics,
    )
    return host, dev, a_sp


CASES = {
    "banded": lambda: synth.banded(900, 9),
    "scattered": lambda: synth.scattered_band(800, 6, 500, seed=2),
    "powerlaw_empty_rows": lambda: synth.power_law(700, 600, 8.0, seed=11),
    "random": lambda: synth.random_csr(500, 400, 0.03, seed=3),
    "single_dense_row": lambda: sp.csr_matrix(
        np.ones((1, 700), np.float32)
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_build_matches_host(name):
    host, dev, _ = _build_both(CASES[name]())
    assert dev.config == host.config
    for f in (
        "num_tiles",
        "nnz_stored",
        "capw",
        "pmax",
        "pages_contig",
        "win_rel",
        "tail_row_start",
        "m_pad",
        "n_pad",
    ):
        assert getattr(dev, f) == getattr(host, f), f
    for f in (
        "row_ptr",
        "tile_ptr",
        "tile_dirty",
        "y_offset",
        "seg_offset",
        "bit_flag",
        "pages",
        "page_cnt",
        "win_map",
        "val_tiles",
    ):
        np.testing.assert_array_equal(
            np.asarray(getattr(dev, f)), np.asarray(getattr(host, f)), err_msg=f
        )
    # the device twin always materialises col_idx_tiles; the host build
    # may keep only the packed plane, which decodes to the same columns
    np.testing.assert_array_equal(
        np.asarray(dev.col_idx_tiles), np.asarray(col_tiles_of(host))
    )
    assert (dev.col_packed is None) == (host.col_packed is None)
    if dev.col_packed is not None:
        np.testing.assert_array_equal(
            np.asarray(dev.col_packed), np.asarray(host.col_packed)
        )


@pytest.mark.parametrize("sigma", [8, 16, 24])
def test_device_build_sigmas(sigma):
    cfg = CSR5Config(sigma=sigma, tiles_per_block=8)
    host, dev, _ = _build_both(synth.power_law(600, 500, 7.0, seed=5), cfg)
    np.testing.assert_array_equal(
        np.asarray(dev.win_map), np.asarray(host.win_map)
    )
    np.testing.assert_array_equal(
        np.asarray(dev.bit_flag), np.asarray(host.bit_flag)
    )
    np.testing.assert_array_equal(
        np.asarray(dev.val_tiles), np.asarray(host.val_tiles)
    )


def test_device_empty_offsets_match_ragged():
    # the device table is padded per dirty tile; values must match the
    # host ragged table slice-for-slice
    host, dev, _ = _build_both(CASES["powerlaw_empty_rows"]())
    dirty = np.asarray(host.tile_dirty)
    assert dirty.any(), "case must exercise dirty tiles"
    h_ptr = np.asarray(host.empty_offset_ptr)
    h_eo = np.asarray(host.empty_offset)
    w = dev.empty_offset.shape[0] // dev.num_tiles
    d_eo = np.asarray(dev.empty_offset).reshape(dev.num_tiles, w)
    for t in np.nonzero(dirty)[0]:
        vals = h_eo[h_ptr[t] : h_ptr[t + 1]]
        np.testing.assert_array_equal(d_eo[t, : len(vals)], vals, err_msg=str(t))


def test_device_built_matrix_runs():
    a_sp = sp.csr_matrix(CASES["scattered"]()).astype(np.float32)
    cfg = CSR5Config(sigma=8, tiles_per_block=8)
    _, dev, _ = _build_both(a_sp, cfg)
    x = synth.dense_x(a_sp.shape[1], dtype=np.float32)
    y_ref = a_sp @ x
    scale = max(1.0, np.abs(y_ref).max())
    y_xla = np.asarray(csr5_spmv_xla(dev, x))
    np.testing.assert_allclose(y_xla, y_ref, atol=2e-5 * scale)


def test_device_build_aligned_mode():
    # the distributed layer's stackable window anchoring
    from benchmark_spmv_using_csr5_tpu import build_csr5 as _b

    a_sp = sp.csr_matrix(CASES["banded"]()).astype(np.float32)
    host = _b(csr_from_scipy(a_sp), win_mode="aligned")
    statics = plan_statics(
        a_sp.indptr, a_sp.indices, a_sp.shape, win_mode="aligned"
    )
    dev = build_csr5_device(
        jnp.asarray(a_sp.indptr, jnp.int64),
        jnp.asarray(a_sp.indices, jnp.int32),
        jnp.asarray(a_sp.data),
        statics,
    )
    assert not dev.win_rel and dev.capw == host.capw
    np.testing.assert_array_equal(
        np.asarray(dev.win_map), np.asarray(host.win_map)
    )
