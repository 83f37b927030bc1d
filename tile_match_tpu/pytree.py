"""Frozen dataclasses that are JAX pytrees.

``@pytree_dataclass`` turns a class into a frozen ``dataclasses.dataclass``
registered with ``jax.tree_util.register_dataclass``: every field is a leaf,
so instances pass through ``jit``/``vmap``/``lax.scan`` and ``jax.tree.map``
like tuples.  ``.replace(**changes)`` returns a copy with fields replaced.
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
