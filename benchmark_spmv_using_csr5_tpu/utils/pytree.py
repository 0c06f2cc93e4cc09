"""Frozen dataclasses registered as JAX pytrees.

Every sparse-matrix container in the package is one of these, so matrices
flow through ``jit`` and ``shard_map`` as arguments. Fields are pytree
leaves unless declared with :func:`static_field`; static fields are part
of the treedef (and so of the jit cache key).
"""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """``@dataclasses.dataclass(frozen=True)`` + pytree registration; leaf
    order is field declaration order. Copy with ``dataclasses.replace``."""
    return jax.tree_util.register_dataclass(dataclasses.dataclass(frozen=True)(cls))


def static_field(**kwargs):
    """A dataclass field kept in the treedef instead of as a leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)
