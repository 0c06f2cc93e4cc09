"""Every container is a frozen dataclass registered as a pytree, with the
leaves and static fields (jit cache key, checkpoint layout) unchanged."""

import dataclasses

import jax
import numpy as np
import pytest
import scipy.sparse as sp

from benchmark_spmv_using_csr5_tpu.models.formats import (
    COOMatrix,
    CSR5Matrix,
    CSRMatrix,
)
from benchmark_spmv_using_csr5_tpu.ops.bandmm import BandBlockMatrix
from benchmark_spmv_using_csr5_tpu.ops.dia import DIAMatrix
from benchmark_spmv_using_csr5_tpu.ops.hyb import HYBMatrix
from benchmark_spmv_using_csr5_tpu.parallel.distributed import DistributedCSR5
from benchmark_spmv_using_csr5_tpu.parallel.distributed_dia import DistributedDIA
from benchmark_spmv_using_csr5_tpu.utils import synth

LAYOUT = {
    COOMatrix: (["row", "col", "values"], ["shape"]),
    CSRMatrix: (["row_ptr", "col_idx", "values"], ["shape"]),
    CSR5Matrix: (
        [
            "row_ptr", "tile_ptr", "tile_dirty", "y_offset", "seg_offset",
            "bit_flag", "empty_offset_ptr", "empty_offset", "col_idx_tiles",
            "val_tiles", "pages", "page_cnt", "win_map", "col_packed",
        ],
        [
            "shape", "config", "num_tiles", "nnz_stored", "win_rel",
            "tail_row_start", "capw", "pmax", "pages_contig", "m_pad", "n_pad",
        ],
    ),
    DIAMatrix: (["data"], ["shape", "offsets", "nnz_stored", "m_pad", "interleaved"]),
    HYBMatrix: (["dia", "csr5"], ["shape", "nnz_stored"]),
    BandBlockMatrix: (["dense", "c0"], ["shape", "K", "nx_pad", "nnz_stored"]),
    DistributedCSR5: (
        ["local"], ["shape", "config", "num_devices", "rows_per_shard", "halo"]
    ),
    DistributedDIA: (
        ["data"],
        ["shape", "offsets", "nnz_stored", "num_devices", "rows_per_shard", "halo"],
    ),
}


@pytest.mark.parametrize("cls", list(LAYOUT), ids=lambda c: c.__name__)
def test_leaves_and_statics(cls, ):
    data, meta = LAYOUT[cls]
    fields = dataclasses.fields(cls)
    assert [f.name for f in fields if not f.metadata.get("static")] == data
    assert [f.name for f in fields if f.metadata.get("static")] == meta
    assert cls.__dataclass_params__.frozen


def test_csr5_flatten_order_and_replace():
    from benchmark_spmv_using_csr5_tpu import build_csr5

    a = sp.csr_matrix(synth.banded(300, 5, dtype=np.float32))
    a5 = build_csr5((a.indptr, a.indices, a.data, a.shape))
    leaves, treedef = jax.tree_util.tree_flatten(a5)
    expect = [
        getattr(a5, n) for n in LAYOUT[CSR5Matrix][0] if getattr(a5, n) is not None
    ]
    assert len(leaves) == len(expect)
    assert all(x is y for x, y in zip(leaves, expect))
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.capw == a5.capw and back.config == a5.config
    b5 = dataclasses.replace(a5, tail_row_start=7)
    assert b5.tail_row_start == 7 and b5.val_tiles is a5.val_tiles
    with pytest.raises(dataclasses.FrozenInstanceError):
        a5.capw = 1
