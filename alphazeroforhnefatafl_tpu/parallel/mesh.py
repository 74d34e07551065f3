"""Device mesh and sharding helpers.

The reference has no distributed runtime of any kind (SURVEY.md §2:
"Parallelism & communication components: NONE"); this module is the new L0
layer. Scaling follows the standard JAX recipe: build a
``jax.sharding.Mesh``, annotate array shardings with ``NamedSharding`` /
``PartitionSpec``, and let XLA place the collectives, which it hands to
NCCL on GPUs. The cards of one host are joined all to all by NVLink (no
torus), so a 1-D ``dp`` mesh follows the algorithm alone.

For this workload the natural axes are:

- ``dp``  — data parallelism for the learner (batch sharded, params
            replicated, psum gradient all-reduce inserted by XLA), and
- game-batch sharding for self-play actors (pure DP of games: each device
  steps its own slice of the lockstep batch; no cross-device traffic inside
  a step).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("dp",),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a mesh over the available devices.

    Defaults to a 1-D ``dp`` mesh over all devices. Pass e.g.
    ``axis_sizes=(hosts, cards)`` with ``axis_names=("dp_outer", "dp")`` for
    a 2-D layout that keeps gradient reductions on NVLink within a host
    before crossing the network between hosts.
    """
    devices = list(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    if int(np.prod(axis_sizes)) != len(devices):
        raise ValueError(
            f"mesh {tuple(axis_sizes)} does not cover {len(devices)} devices"
        )
    dev_array = np.asarray(devices).reshape(tuple(axis_sizes))
    return Mesh(dev_array, tuple(axis_names))


def auto_mesh(
    *batch_sizes: int, devices: Optional[Sequence[jax.Device]] = None
) -> Mesh:
    """Largest 1-D ``dp`` mesh whose size divides every given batch size.

    The training loop calls this so arbitrary user batch sizes never trip
    sharding divisibility; with indivisible sizes it degrades toward fewer
    devices (worst case a 1-device mesh).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    while n > 1 and any(b % n != 0 for b in batch_sizes):
        n -= 1
    if n < len(devices):
        import warnings

        warnings.warn(
            f"auto_mesh: batch sizes {batch_sizes} are not divisible by the "
            f"{len(devices)} available devices; using a {n}-device mesh "
            f"({len(devices) - n} devices idle). Pick batch sizes divisible "
            f"by the device count to use the full machine.",
            stacklevel=2,
        )
    return make_mesh((n,), ("dp",), devices[:n])


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Shard the leading (batch) dimension over ``axis``; replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree, axis: str = "dp"):
    """Device-put a pytree with its leading axis sharded over the mesh."""
    sh = batch_sharding(mesh, axis)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def replicate(mesh: Mesh, tree):
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)


def shard_host_batch(mesh: Mesh, tree, axis: str = "dp"):
    """Form a globally batch-sharded pytree from per-host local data.

    Multi-host: every process passes its own slice of the global batch
    (per-host replay semantics — see ``parallel/launch.py``) and the pieces
    are assembled into one global array. Single-process: a plain sharded
    ``device_put``.
    """
    sh = batch_sharding(mesh, axis)
    if jax.process_count() == 1:
        return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(sh, np.asarray(x)), tree
    )
