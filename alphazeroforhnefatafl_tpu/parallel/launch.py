"""Multi-host launch and process-group initialization.

The reference is single-process (SURVEY.md §2). Multi-host scaling here
follows the standard JAX recipe: every host runs the same program,
``jax.distributed.initialize`` forms the process group, and all arrays live
on a global mesh spanning every card — XLA hands the collectives to NCCL,
which rides NVLink within a host and the network between hosts.

For the AlphaZero loop the multi-host layout is:

- **Self-play**: each host steps its own slice of the global game batch
  (pure data parallelism of games; zero cross-host traffic inside a step).
- **Learner**: the training batch is sharded over the global ``dp`` axis;
  XLA's psum gradient all-reduce keeps params in sync, so the per-iteration
  "weights broadcast to actors" of classic AlphaZero is free — actors read
  the same replicated params the learner just updated.
- **Replay**: host-local buffers; each host trains on its own shard's
  samples while psum averages the gradients (equivalent in expectation to a
  global buffer).

Without a real cluster this module is exercised via
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` single-process tests,
``__graft_entry__.dryrun_multichip`` and the two-process CPU group of
``tests/test_multiprocess.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import jax


@dataclass(frozen=True)
class HostTopology:
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> HostTopology:
    """Initialize the JAX process group when running multi-host.

    No-ops (single process) when no coordinator is configured — so the same
    entry point works on one host and on a pod. Arguments default to the
    standard env vars (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``) used by most launchers.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    # NOT `process_id or env`: 0 is a legitimate explicit id and must not
    # fall through to a stale JAX_PROCESS_ID in the environment.
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return HostTopology(
        process_id=jax.process_index(),
        num_processes=jax.process_count(),
        local_devices=jax.local_device_count(),
        global_devices=jax.device_count(),
    )


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch owned by this host (equal split)."""
    count = jax.process_count()
    if global_batch % count:
        # A silent floor-split would orphan the remainder games: no host
        # owns them, but global assembly still expects global_batch rows.
        raise ValueError(
            f"global batch {global_batch} must be divisible by the "
            f"process count {count}"
        )
    per = global_batch // count
    start = jax.process_index() * per
    return slice(start, start + per)
