"""Checkpoint/resume tests: CSR5 conversion persistence (SURVEY section 5:
the reference has no checkpointing; conversion is the artifact worth
persisting here)."""

import numpy as np
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu import (
    CSR5Config,
    build_csr5,
    csr5_spmv_xla,
    csr_from_scipy,
)
from benchmark_spmv_using_csr5_tpu.utils import checkpoint, synth


def _roundtrip(a5, tmp_path):
    p = str(tmp_path / "ck.npz")
    checkpoint.save_csr5(p, a5)
    return checkpoint.load_csr5(p)


def test_checkpoint_roundtrip_exact(tmp_path):
    a_sp = sp.csr_matrix(synth.power_law(400, 400, 6.0, dtype=np.float32))
    a5 = build_csr5(csr_from_scipy(a_sp), CSR5Config(sigma=16))
    back = _roundtrip(a5, tmp_path)
    assert back.config == a5.config
    assert back.shape == a5.shape and back.capw == a5.capw
    assert back.win_rel == a5.win_rel and back.pmax == a5.pmax
    import dataclasses

    for f in dataclasses.fields(a5):
        v0, v1 = getattr(a5, f.name), getattr(back, f.name)
        if hasattr(v0, "shape"):
            np.testing.assert_array_equal(
                np.asarray(v0), np.asarray(v1), err_msg=f.name
            )
        else:
            assert v0 == v1, f.name
    # restored matrix computes
    x = synth.dense_x(400, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(csr5_spmv_xla(back, x)),
        np.asarray(csr5_spmv_xla(a5, x)),
        atol=0,
    )


def test_checkpoint_bf16_and_packed(tmp_path):
    import jax.numpy as jnp

    a_sp = sp.csr_matrix(synth.banded(600, 9, dtype=np.float32))
    a5 = build_csr5(
        csr_from_scipy(a_sp), CSR5Config(sigma=16), value_dtype=jnp.bfloat16
    )
    assert a5.col_packed is not None
    back = _roundtrip(a5, tmp_path)
    assert back.val_tiles.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back.val_tiles.astype(jnp.float32)),
        np.asarray(a5.val_tiles.astype(jnp.float32)),
    )
    np.testing.assert_array_equal(
        np.asarray(back.col_packed), np.asarray(a5.col_packed)
    )


def test_checkpoint_dia_roundtrip(tmp_path):
    from benchmark_spmv_using_csr5_tpu.ops.dia import build_dia, dia_spmv

    a = sp.csr_matrix(synth.banded(800, 5, dtype=np.float32))
    d = build_dia((a.indptr, a.indices, a.data, a.shape))
    p = str(tmp_path / "dia.npz")
    checkpoint.save_dia(p, d)
    back = checkpoint.load_dia(p)
    assert back.offsets == d.offsets and back.shape == d.shape
    np.testing.assert_array_equal(np.asarray(back.data), np.asarray(d.data))
    x = synth.dense_x(800, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(dia_spmv(back, x)), a @ x, atol=1e-4
    )


def test_checkpoint_type_mismatch(tmp_path):
    import pytest as _pytest

    a_sp = sp.csr_matrix(synth.banded(300, 5, dtype=np.float32))
    a5 = build_csr5(csr_from_scipy(a_sp))
    p = str(tmp_path / "x.npz")
    checkpoint.save_csr5(p, a5)
    with _pytest.raises(ValueError, match="DIAMatrix"):
        checkpoint.load_dia(p)
