"""Checkpoint / resume for converted matrices.

The reference has no persistence (SURVEY.md section 5: its nearest
analogue is the in-place asCSR5/asCSR round-trip, and its mmio write
routines are dead code). Here the expensive artifact worth persisting is
the CSR -> CSR5 conversion (tile metadata + execution plan): `save_csr5`
serialises a :class:`CSR5Matrix` to one compressed ``.npz`` and
`load_csr5` restores it bit-for-bit, so long-running services can skip
reconversion on restart.
"""

from __future__ import annotations

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CSR5Config
from ..models.formats import CSR5Matrix
from ..ops.dia import DIAMatrix

#: bump when the CSR5Matrix field layout changes
#: v2: wrapped win_map carries wrap-flag bits 23/24 (convert.build_csr5)
#: v3: aligned win_map carries the same bits
FORMAT_VERSION = 3


def _pack_fields(obj) -> tuple:
    """Split a struct dataclass into (arrays, static-json) dicts."""
    arrays = {}
    static = {"__version__": FORMAT_VERSION, "__type__": type(obj).__name__}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "config":
            static["config"] = [v.omega, v.sigma, v.tiles_per_block]
        elif v is None:
            static.setdefault("__none__", []).append(f.name)
        elif isinstance(v, (jax.Array, np.ndarray)):
            arr = np.asarray(v)
            if arr.dtype == jnp.bfloat16:
                # npz has no bf16: store the raw bits and remember
                arrays[f.name] = arr.view(np.uint16)
                static.setdefault("__bf16__", []).append(f.name)
            else:
                arrays[f.name] = arr
        elif isinstance(v, tuple):
            static[f.name] = list(v)
        else:
            static[f.name] = v
    return arrays, static


def _unpack_fields(cls, path: str, expect_type: str):
    with np.load(path, allow_pickle=False) as z:
        static = json.loads(str(z["__static__"]))
        if static.pop("__version__") != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version in {path}")
        if static.pop("__type__", expect_type) != expect_type:
            raise ValueError(f"{path} does not hold a {expect_type}")
        none_fields = set(static.pop("__none__", []))
        bf16_fields = set(static.pop("__bf16__", []))
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name == "config":
                om, sig, tpb = static["config"]
                kwargs["config"] = CSR5Config(
                    omega=om, sigma=sig, tiles_per_block=tpb
                )
            elif f.name in none_fields:
                kwargs[f.name] = None
            elif f.name in z.files:
                arr = z[f.name]
                if f.name in bf16_fields:
                    kwargs[f.name] = jnp.asarray(arr).view(jnp.bfloat16)
                else:
                    dev = jnp.asarray(arr)
                    if dev.dtype != arr.dtype:
                        # jnp.asarray silently narrows f64/i64 when
                        # jax_enable_x64 is off (JAX's default), which
                        # would break the documented exact round-trip
                        raise ValueError(
                            f"loading {path}: field {f.name!r} is "
                            f"{arr.dtype} but jax would narrow it to "
                            f"{dev.dtype}; enable jax_enable_x64 or save "
                            f"the checkpoint at a narrower dtype"
                        )
                    kwargs[f.name] = dev
            elif f.name in static:
                v = static[f.name]
                kwargs[f.name] = tuple(v) if isinstance(v, list) else v
            elif f.default is not dataclasses.MISSING:
                # Static field added after this checkpoint was written.
                # CONTRACT (models/formats.py): a defaulted static field's
                # default must mean "feature off / pre-feature layout" so
                # old checkpoints keep computing identically. If a future
                # defaulted field changes numerics, bump FORMAT_VERSION
                # instead of relying on this fill. Warn so a misloading
                # checkpoint is diagnosable rather than silently wrong.
                warnings.warn(
                    f"loading {path}: field {f.name!r} absent from the "
                    f"checkpoint; filled with its default {f.default!r} "
                    f"(pre-feature semantics)",
                    stacklevel=3,
                )
                kwargs[f.name] = f.default
            else:
                raise ValueError(
                    f"loading {path}: field {f.name!r} missing and has "
                    f"no default"
                )
    return cls(**kwargs)


def save_csr5(path: str, a5: CSR5Matrix) -> None:
    """Serialise a CSR5Matrix (arrays + static plan) to ``path`` (.npz)."""
    arrays, static = _pack_fields(a5)
    np.savez_compressed(path, __static__=json.dumps(static), **arrays)


def load_csr5(path: str) -> CSR5Matrix:
    """Restore a CSR5Matrix saved by :func:`save_csr5` (exact round-trip)."""
    return _unpack_fields(CSR5Matrix, path, "CSR5Matrix")


def save_dia(path: str, dia: DIAMatrix) -> None:
    """Serialise a DIAMatrix to ``path`` (.npz)."""
    arrays, static = _pack_fields(dia)
    np.savez_compressed(path, __static__=json.dumps(static), **arrays)


def load_dia(path: str) -> DIAMatrix:
    """Restore a DIAMatrix saved by :func:`save_dia` (exact round-trip)."""
    return _unpack_fields(DIAMatrix, path, "DIAMatrix")
