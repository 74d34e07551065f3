"""Frozen dataclasses registered as JAX pytrees."""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Make ``cls`` a frozen dataclass whose fields are all pytree leaves.

    Instances flatten by field (path keys are the field names), rebuild
    under ``jit``/``vmap``/``shard_map``, and gain ``.replace(**changes)``,
    which returns a copy with those fields swapped.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)
