"""CSR->CSR5 conversion tests: round-trip, descriptor parity, plan
invariants.

The reference has no unit tests (SURVEY.md section 4); its only conversion
check is the asCSR5/asCSR round-trip in the AVX2 driver
(CSR5_avx2/main.cpp:41-45). These tests recreate that plus descriptor-level
property tests against brute-force oracles.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu import CSR5Config, build_csr5, csr5_to_csr, csr_from_scipy
from benchmark_spmv_using_csr5_tpu.ops.convert import (
    tile_dirty_flags,
    tile_partition_pointer,
)
from benchmark_spmv_using_csr5_tpu.utils import synth


def roundtrip(a_sp, config=None):
    csr = csr_from_scipy(a_sp)
    a5 = build_csr5(csr, config)
    back = csr5_to_csr(a5)
    np.testing.assert_array_equal(np.asarray(back.row_ptr), np.asarray(csr.row_ptr))
    np.testing.assert_array_equal(np.asarray(back.col_idx), np.asarray(csr.col_idx))
    np.testing.assert_array_equal(np.asarray(back.values), np.asarray(csr.values))
    return a5


def test_roundtrip_edge_cases(edge_matrix):
    name, a_sp = edge_matrix
    roundtrip(a_sp)


@pytest.mark.parametrize("sigma", [8, 16, 32])
def test_roundtrip_sigmas(sigma):
    a_sp = synth.random_csr(500, 400, 0.03, seed=3)
    a5 = roundtrip(a_sp, CSR5Config(sigma=sigma))
    assert a5.sigma == sigma
    # repeated round-trip (the x5 loop of CSR5_avx2/main.cpp:41-45)
    for _ in range(4):
        a5 = roundtrip(a_sp, CSR5Config(sigma=sigma))


def test_tile_ptr_matches_bruteforce():
    a_sp = synth.power_law(400, 400, 6.0, seed=7)
    csr = csr_from_scipy(a_sp)
    cfg = CSR5Config(sigma=8)
    a5 = build_csr5(csr, cfg)
    rp = np.asarray(csr.row_ptr)
    T = cfg.tile_nnz
    tp = np.asarray(a5.tile_ptr)
    for t in range(a5.num_tiles + 1):
        boundary = t * T
        expect = int(np.searchsorted(rp, boundary, side="right")) - 1
        expect = max(0, min(expect, len(rp) - 1))
        assert tp[t] == expect, f"tile {t}"
    # jittable stage agrees
    jtp = np.asarray(tile_partition_pointer(csr.row_ptr, a5.num_tiles, T))
    np.testing.assert_array_equal(jtp, tp)


def test_dirty_bits_mark_empty_rows():
    a_sp = synth.power_law(300, 300, 4.0, seed=1)
    csr = csr_from_scipy(a_sp)
    a5 = build_csr5(csr, CSR5Config(sigma=8))
    rp = np.asarray(csr.row_ptr)
    tp = np.asarray(a5.tile_ptr)
    dirty = np.asarray(a5.tile_dirty)
    m = csr.m
    for t in range(a5.num_tiles):
        lo, hi = tp[t], min(tp[t + 1], m - 1)
        has_empty = any(rp[r] == rp[r + 1] for r in range(lo, hi + 1))
        assert bool(dirty[t]) == has_empty, f"tile {t}: [{lo},{hi}]"
    # jittable stage agrees value-for-value with the host conversion
    jd = np.asarray(tile_dirty_flags(csr.row_ptr, a5.tile_ptr))
    np.testing.assert_array_equal(jd, dirty)


def test_seg_offset_matches_bruteforce():
    """seg_offset oracle (scansum parity, format_cuda.h:200-240):
    seg_offset[t, l] = number of flag-free lanes between lane l and the
    next lane holding any bit flag (omega-l-1 when none follows)."""
    for a_sp in (
        synth.power_law(300, 300, 4.0, seed=11),
        synth.random_csr(200, 150, 0.05, seed=5),
        sp.csr_matrix(synth.banded(600, 9, dtype=np.float32)),
    ):
        csr = csr_from_scipy(a_sp)
        cfg = CSR5Config(sigma=8)
        a5 = build_csr5(csr, cfg)
        rp = np.asarray(csr.row_ptr)
        sig, om = cfg.sigma, cfg.omega
        T = sig * om
        nnz_pad = a5.num_tiles * T
        heads = np.zeros(nnz_pad, bool)
        nonempty = np.diff(rp) > 0
        heads[rp[:-1][nonempty]] = True
        heads[np.arange(a5.num_tiles) * T] = True  # forced tile-leading bit
        seg = np.asarray(a5.seg_offset)
        for t in range(a5.num_tiles):
            lane_has = heads[t * T : (t + 1) * T].reshape(om, sig).any(axis=1)
            for l in range(om):  # noqa: E741
                nxt = om  # sentinel: no flagged lane after l
                for l2 in range(l + 1, om):
                    if lane_has[l2]:
                        nxt = l2
                        break
                expect = max(0, min(nxt - l - 1, om))
                assert seg[t, l] == expect, (t, l)


def test_bit_flags_and_y_offset():
    a_sp = synth.random_csr(200, 150, 0.05, seed=5)
    csr = csr_from_scipy(a_sp)
    cfg = CSR5Config(sigma=8)
    a5 = build_csr5(csr, cfg)
    rp = np.asarray(csr.row_ptr)
    sig, om = cfg.sigma, cfg.omega
    T = sig * om
    nnz_pad = a5.num_tiles * T
    heads = np.zeros(nnz_pad, bool)
    nonempty = np.diff(rp) > 0
    heads[rp[:-1][nonempty]] = True
    heads[np.arange(a5.num_tiles) * T] = True  # forced tile-leading bit
    bf = np.asarray(a5.bit_flag)  # (p, W, om)
    yo = np.asarray(a5.y_offset)
    for t in range(a5.num_tiles):
        seen = 0
        for l in range(om):  # noqa: E741
            assert yo[t, l] == seen
            for s in range(sig):
                bit = (bf[t, s // 32, l] >> (s % 32)) & 1
                expect = heads[t * T + l * sig + s]
                assert bool(bit) == bool(expect), (t, s, l)
                seen += int(bit)


def test_empty_offset_rows():
    a_sp = synth.power_law(300, 300, 4.0, seed=2)
    csr = csr_from_scipy(a_sp)
    cfg = CSR5Config(sigma=8)
    a5 = build_csr5(csr, cfg)
    rp = np.asarray(csr.row_ptr)
    tp = np.asarray(a5.tile_ptr)
    eo_ptr = np.asarray(a5.empty_offset_ptr)
    eo = np.asarray(a5.empty_offset)
    dirty = np.asarray(a5.tile_dirty)
    T = cfg.tile_nnz
    assert (eo >= 0).all()
    for t in range(a5.num_tiles):
        cnt = eo_ptr[t + 1] - eo_ptr[t]
        if not dirty[t]:
            assert cnt == 0
            continue
        offs = eo[eo_ptr[t] : eo_ptr[t + 1]]
        # offsets are monotone non-decreasing and start at 0 (the carry row)
        assert offs[0] == 0
        assert (np.diff(offs) >= 0).all()
        # each offset maps to a non-empty row except possibly ordinal 0
        for k, off in enumerate(offs[1:], 1):
            r = tp[t] + off
            assert rp[r + 1] > rp[r], (t, k)


def test_window_maps_monotone():
    for name, make in synth.EDGE_CASE_MATRICES.items():
        a_sp = make()
        a5 = build_csr5(csr_from_scipy(a_sp))
        wm = np.asarray(a5.win_map)
        # lane bits 16-22; wrapped maps add wrap-flag bits at 23/24
        we = ((wm >> 16) & 127) * a5.sigma + (wm & 0xFFFF)
        if a5.win_rel:
            # wrapped maps (slot d = row base+d, wrapping below rs%128):
            # monotone in ROW order, i.e. after rotating each tile's slots
            # so the tile's first row comes first
            off = np.asarray(a5.tile_ptr[:-1]) & 127
            idx = (np.arange(a5.capw)[None, :] + off[:, None]) % a5.capw
            we = np.take_along_axis(we, idx, axis=1)
        assert (np.diff(we, axis=1) >= 0).all(), name
        assert we.min() >= 0 and we.max() < a5.config.tile_nnz, name


def test_sigma_autotune():
    from benchmark_spmv_using_csr5_tpu import compute_sigma

    assert compute_sigma(1000, 2000) == 8  # short rows
    assert compute_sigma(1000, 24_000) == 24  # medium: tracks nnz/row
    assert compute_sigma(1000, 100_000) == 32  # long rows cap
    assert compute_sigma(10, 10_000) == 8  # very long rows -> small sigma
    assert compute_sigma(1000, 0, sigma=16) == 16  # explicit passthrough


def _decode_col_packed(a5):
    """Reconstruct global columns from the packed plane + page lists."""
    cp = np.asarray(a5.col_packed)
    lo, hi = cp & 0xFFFF, (cp >> 16) & 0xFFFF
    c16 = np.concatenate([lo, hi], axis=1)  # (p, sigma, omega)
    lane = c16 & 127
    local = c16 >> 7
    pages = np.asarray(a5.pages)  # (p, pmax) sorted, sentinel-padded
    page = np.take_along_axis(
        np.repeat(pages[:, :, None], c16.shape[2], axis=2), local, axis=1
    )
    return page * 128 + lane


@pytest.mark.parametrize(
    "make",
    [
        lambda: synth.banded(1500, 9, dtype=np.float32),  # contig tier 0
        lambda: synth.scattered_band(900, 6, 2500, dtype=np.float32),  # tier 1
        lambda: synth.random_csr(300, 20_000, 0.01, seed=5).astype(
            np.float32
        ),  # list mode
    ],
)
def test_col_packed_decodes_to_columns(make):
    from benchmark_spmv_using_csr5_tpu.models.formats import col_tiles_of

    a_sp = make()
    # packing is kept for sigma % 16 == 0; the build then drops the
    # redundant raw plane, and both the numpy decode and col_tiles_of
    # reconstruct the tile-transposed columns bit-for-bit
    a5 = build_csr5(csr_from_scipy(a_sp), CSR5Config(sigma=16))
    assert a5.col_packed is not None and a5.col_idx_tiles is None
    assert a5.pmax <= 512
    p, T = a5.num_tiles, a5.config.tile_nnz
    cols = np.full(p * T, a_sp.indices[-1], np.int64)
    cols[: a_sp.nnz] = sp.csr_matrix(a_sp).indices
    expect = np.swapaxes(cols.reshape(p, 128, 16), 1, 2)
    np.testing.assert_array_equal(_decode_col_packed(a5), expect)
    np.testing.assert_array_equal(np.asarray(col_tiles_of(a5)), expect)


def test_col_packed_absent_beyond_pmax512():
    # > 512 distinct pages per tile: wide uniform-random columns
    a_sp = synth.random_csr(64, 150_000, 0.00035, seed=7).astype(np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), CSR5Config(sigma=16))
    assert a5.pmax > 512
    assert a5.col_packed is None


def test_col_packed_absent_for_unaligned_sigma():
    # sigma=24 -> (12,128) half-planes would be ragged: packing is skipped
    a_sp = synth.banded(1500, 9, dtype=np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), CSR5Config(sigma=24))
    assert a5.col_packed is None


def test_col_packed_numpy_fallback_matches_native():
    """The argsort fallback and the native rank pass agree bit-for-bit."""
    from benchmark_spmv_using_csr5_tpu.utils import nativelib

    if not nativelib.available():
        pytest.skip("native lib unavailable")
    a_sp = synth.random_csr(300, 20_000, 0.01, seed=9).astype(np.float32)
    csr = a_sp.tocsr()
    from benchmark_spmv_using_csr5_tpu.models.formats import col_tiles_of

    a5 = build_csr5(
        (csr.indptr, csr.indices, csr.data, csr.shape),
        CSR5Config(sigma=16),
    )
    assert a5.col_packed is not None and not a5.pages_contig
    T = a5.config.tile_nnz
    p = a5.num_tiles
    col_flat = np.zeros(p * T, np.int32)
    back = np.swapaxes(np.asarray(col_tiles_of(a5)), 1, 2).reshape(-1)
    col_flat[:] = back
    native = nativelib.col_local_packed(col_flat, p, T, a5.n_pad // 128 + 1)
    # numpy fallback re-derivation
    pg2 = (col_flat >> 7).reshape(p, T)
    order = np.argsort(pg2, axis=1, kind="stable")
    ps = np.take_along_axis(pg2, order, axis=1)
    fst = np.ones_like(ps, dtype=bool)
    fst[:, 1:] = ps[:, 1:] != ps[:, :-1]
    loc_sorted = np.cumsum(fst.astype(np.int32), axis=1) - 1
    local = np.empty_like(loc_sorted)
    np.put_along_axis(local, order, loc_sorted, axis=1)
    cf2 = col_flat.reshape(p, T)
    expect = ((cf2 & 127) | (local << 7)).astype(np.uint16).reshape(-1)
    np.testing.assert_array_equal(native, expect)


def test_debug_tile_printer():
    """print_tile parity helper (detail/utils.h:22-55): renders flags and
    payload without error, marking row heads."""
    import io

    from benchmark_spmv_using_csr5_tpu.utils import debug

    a_sp = synth.power_law(300, 300, 5.0, dtype=np.float32)
    a5 = build_csr5(csr_from_scipy(a_sp), CSR5Config(sigma=8))
    buf = io.StringIO()
    debug.print_tile(a5, 0, file=buf)
    out = buf.getvalue()
    assert "tile 0" in out and "row_start=0" in out and "*" in out
    debug.print_1darray(a5.tile_ptr, "tile_ptr", file=buf)
    assert "tile_ptr" in buf.getvalue()


def test_autotuned_retunes_scattered_only():
    from benchmark_spmv_using_csr5_tpu import build_csr5_autotuned

    # scattered short rows: heuristic sigma 16 -> retuned to 8
    scat = sp.csr_matrix(synth.scattered_band(2000, 16, 1500, dtype=np.float32))
    a5 = build_csr5_autotuned((scat.indptr, scat.indices, scat.data, scat.shape))
    assert not a5.pages_contig and a5.config.sigma == 8
    # banded: contiguous pages, heuristic sigma kept
    band = sp.csr_matrix(synth.banded(2000, 27, dtype=np.float32))
    b5 = build_csr5_autotuned((band.indptr, band.indices, band.data, band.shape))
    assert b5.pages_contig and b5.config.sigma == 24
    # scattered LONG rows (fem block class, heuristic sigma >= 24):
    # retuned to 16, keeping the packed column plane
    fem = sp.csr_matrix(
        synth.fem_blocks(6000, neighbors=17, node_bandwidth=1200)
    )
    f5 = build_csr5_autotuned((fem.indptr, fem.indices, fem.data, fem.shape))
    assert not f5.pages_contig and f5.config.sigma == 16
    assert f5.col_packed is not None


def test_sigma4_short_row_parity():
    """The reference's small-sigma configurations (sigma=4 for
    nnz/row <= 4, anonymouslib_cuda.h:295-318; AVX-512/Phi sigma=12):
    conversion, round-trip and the XLA executor accept ANY sigma >= 1.
    The auto-tune heuristic itself snaps to multiples of 8."""
    import scipy.sparse as sp

    from benchmark_spmv_using_csr5_tpu.ops.csr5_spmv import csr5_spmv_xla

    a = sp.csr_matrix(synth.banded(2000, 3, dtype=np.float32))
    x = np.random.default_rng(0).integers(1, 10, 2000).astype(np.float32)
    for sig in (2, 4, 12):
        a5 = build_csr5(csr_from_scipy(a), CSR5Config(sigma=sig))
        y = np.asarray(csr5_spmv_xla(a5, x))
        np.testing.assert_array_equal(y, a @ x)
        back = csr5_to_csr(a5)
        np.testing.assert_array_equal(np.asarray(back.col_idx), a.indices)


def test_value_dtype_auto_bf16_when_lossless():
    """value_dtype="auto" (the storage precision gate):
    integer-class values store bf16 with BIT-IDENTICAL results; values
    that do not round-trip bf16 keep f32 storage."""
    import jax.numpy as jnp

    from benchmark_spmv_using_csr5_tpu.ops.csr5_spmv import csr5_spmv_xla

    a = sp.csr_matrix(synth.banded(3000, 9, dtype=np.float32))
    csr = (a.indptr, a.indices, a.data, a.shape)
    x = np.random.default_rng(0).integers(1, 10, 3000).astype(np.float32)
    auto = build_csr5(csr, CSR5Config(sigma=16), value_dtype="auto")
    assert auto.val_tiles.dtype == jnp.bfloat16
    f32 = build_csr5(csr, CSR5Config(sigma=16))
    assert f32.val_tiles.dtype == jnp.float32
    np.testing.assert_array_equal(
        np.asarray(csr5_spmv_xla(auto, x)), np.asarray(csr5_spmv_xla(f32, x))
    )
    # non-representable values: gate keeps f32
    af = a.copy()
    af.data = af.data * np.float32(1.0009765625)  # needs >8 mantissa bits
    keep = build_csr5(
        (af.indptr, af.indices, af.data, af.shape),
        CSR5Config(sigma=16),
        value_dtype="auto",
    )
    assert keep.val_tiles.dtype == jnp.float32


def test_raw_cols_dropped_only_when_packed():
    # sigma=24 has no packed plane -> raw cols must stay
    a = sp.csr_matrix(synth.banded(2000, 9, dtype=np.float32))
    a5 = build_csr5(csr_from_scipy(a), CSR5Config(sigma=24))
    assert a5.col_packed is None and a5.col_idx_tiles is not None
    # sigma=16 packs -> raw plane dropped, asCSR still exact (roundtrip
    # helper covers the decode)
    b5 = build_csr5(csr_from_scipy(a), CSR5Config(sigma=16))
    assert b5.col_packed is not None and b5.col_idx_tiles is None
    roundtrip(a, CSR5Config(sigma=16))


def test_upload_accounting_recorded():
    from benchmark_spmv_using_csr5_tpu.ops.convert import last_convert_phases

    a = sp.csr_matrix(synth.banded(2000, 9, dtype=np.float32))
    a5 = build_csr5(csr_from_scipy(a), CSR5Config(sigma=16))
    mb = last_convert_phases.get("upload_mb")
    assert mb is not None and mb > 0
    # payload = val (4 B) + packed col (2 B) per stored element
    expect = (a5.val_tiles.size * 4 + a5.col_packed.size * 4) / 1e6
    assert abs(mb - expect) < 1e-6
