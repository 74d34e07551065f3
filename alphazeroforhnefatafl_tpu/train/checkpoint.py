"""Checkpoint / resume for the AlphaZero loop.

The reference has no training checkpointing (SURVEY.md §5); its closest
analogues are FEN snapshots and in-memory undo history. Here a checkpoint
captures the full loop state — params, optimizer state, replay buffer
contents, PRNG key and iteration counter — so any host restart resumes at the
last iteration boundary.

On-disk layout, one directory per saved iteration::

    <dir>/<iteration>/manifest.json      leaf paths and shapes, extra keys
    <dir>/<iteration>/state.npz          train_state/..., rng, extra/...
    <dir>/<iteration>/replay_host<k>.npz replay buffer of process k

Each iteration is written under ``<iteration>.partial`` and renamed into
place once complete, so a crash mid-save never leaves a directory that
:meth:`CheckpointManager.latest_iteration` would pick up.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import jax
import numpy as np

from .learner import TrainState
from .replay import ReplayBuffer

_MANIFEST = "manifest.json"
_STATE = "state.npz"


def _replay_state(replay: ReplayBuffer) -> Dict[str, Any]:
    return {
        "board": replay.board,
        "side": replay.side,
        "reps": replay.reps,
        "policy_idx": replay.policy_idx,
        "policy_p": replay.policy_p,
        "value": replay.value,
        "write": np.asarray(replay.write, np.int64),
        "size": np.asarray(replay.size, np.int64),
        "total_added": np.asarray(replay.total_added, np.int64),
    }


def _restore_replay(replay: ReplayBuffer, st: Dict[str, Any]) -> None:
    replay.board[...] = st["board"]
    replay.side[...] = st["side"]
    replay.reps[...] = st["reps"]
    replay.policy_idx[...] = st["policy_idx"]
    replay.policy_p[...] = st["policy_p"]
    replay.value[...] = st["value"]
    replay.write = int(st["write"])
    replay.size = int(st["size"])
    replay.total_added = int(st["total_added"])


def _leaf_paths(tree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs with the path spelled ``a/b/0/c`` from the
    attribute, dict and sequence keys of ``tree``."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for k in path:
            if hasattr(k, "name"):
                parts.append(str(k.name))
            elif hasattr(k, "key"):
                parts.append(str(k.key))
            elif hasattr(k, "idx"):
                parts.append(str(k.idx))
            else:  # pragma: no cover - future key types
                parts.append(str(k))
        out.append(("/".join(parts), leaf))
    return out


def _leaf_path_shapes(tree) -> Dict[str, Any]:
    """Map leaf path -> shape (the structure a checkpoint is checked by)."""
    return {p: list(np.shape(leaf)) for p, leaf in _leaf_paths(tree)}


def _host_value(x) -> np.ndarray:
    """Host copy of a leaf. A replicated global array on a multi-host mesh is
    not fully addressable; any local shard then holds the whole value."""
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        x = x.addressable_data(0)
    return np.asarray(x)


def _flat_arrays(prefix: str, tree) -> Dict[str, np.ndarray]:
    return {f"{prefix}/{p}": _host_value(leaf) for p, leaf in _leaf_paths(tree)}


def _like(template_leaf, value: np.ndarray):
    """``value`` placed like ``template_leaf`` (same sharding for arrays)."""
    if isinstance(template_leaf, jax.Array):
        return jax.make_array_from_callback(
            value.shape, template_leaf.sharding, lambda idx: value[idx]
        )
    return value


def _rebuild(prefix: str, template, arrays) -> Any:
    leaves = [_like(leaf, arrays[f"{prefix}/{p}"]) for p, leaf in _leaf_paths(template)]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template), leaves
    )


def _structure_mismatch(want: Dict[str, Any], got: Dict[str, Any]) -> str:
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    shape_diff = sorted(p for p in set(want) & set(got) if want[p] != got[p])
    return "; ".join(
        filter(
            None,
            [
                missing and f"template-only leaves {missing[:4]}",
                extra and f"on-disk-only leaves {extra[:4]}",
                shape_diff
                and (
                    f"shape mismatches "
                    f"{[(p, want[p], got[p]) for p in shape_diff[:4]]}"
                ),
            ],
        )
    )


class CheckpointManager:
    """Iteration-boundary checkpointing with retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_iterations(self) -> List[int]:
        return sorted(
            int(d)
            for d in os.listdir(self.directory)
            if d.isdigit() and os.path.isfile(os.path.join(self.directory, d, _MANIFEST))
        )

    def latest_iteration(self) -> Optional[int]:
        its = self.all_iterations()
        return its[-1] if its else None

    def _manifest(self, iteration: int) -> Dict[str, Any]:
        with open(os.path.join(self.directory, str(iteration), _MANIFEST)) as f:
            return json.load(f)

    def save(
        self,
        iteration: int,
        train_state: TrainState,
        replay: Optional[ReplayBuffer],
        rng: jax.Array,
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Write iteration ``iteration``. Replay buffers are HOST-LOCAL (each
        process keeps its own games), so every process writes its own replay
        file; process 0 writes the replicated state and the manifest."""
        extra = extra or {}
        final = os.path.join(self.directory, str(iteration))
        partial = final + ".partial"
        multi_host = jax.process_count() > 1
        if jax.process_index() == 0:
            shutil.rmtree(partial, ignore_errors=True)
            os.makedirs(partial)
        if multi_host:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices(f"ckpt_mkdir_{iteration}")
        if replay is not None:
            np.savez(
                os.path.join(partial, f"replay_host{jax.process_index()}.npz"),
                **_replay_state(replay),
            )
        if jax.process_index() == 0:
            arrays = _flat_arrays("train_state", train_state)
            arrays["rng"] = _host_value(rng)
            for key, value in extra.items():
                arrays.update(_flat_arrays(f"extra/{key}", value))
            np.savez(os.path.join(partial, _STATE), **arrays)
            manifest = {
                "iteration": iteration,
                "train_state": _leaf_path_shapes(train_state),
                "extra_keys": sorted(extra),
                "replay_hosts": jax.process_count() if replay is not None else 0,
            }
            with open(os.path.join(partial, _MANIFEST), "w") as f:
                json.dump(manifest, f)
        if multi_host:
            multihost_utils.sync_global_devices(f"ckpt_written_{iteration}")
        if jax.process_index() == 0:
            shutil.rmtree(final, ignore_errors=True)
            os.replace(partial, final)
            for old in self.all_iterations()[: -self.max_to_keep or None]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        if multi_host:
            multihost_utils.sync_global_devices(f"ckpt_done_{iteration}")

    def saved_extra_keys(self, iteration: Optional[int] = None) -> Tuple[str, ...]:
        """Keys of the ``extra`` payload the on-disk checkpoint was saved
        with (empty for ungated runs). Lets the caller build the matching
        restore template instead of guessing and catching mismatches."""
        step = iteration if iteration is not None else self.latest_iteration()
        if step is None:
            return ()
        return tuple(self._manifest(step)["extra_keys"])

    def restore(
        self,
        train_state: TrainState,
        replay: Optional[ReplayBuffer],
        iteration: Optional[int] = None,
        extra_template: Optional[Dict[str, Any]] = None,
    ) -> Tuple[int, TrainState, jax.Array, Dict[str, Any]]:
        """Restore a checkpoint into ``train_state``'s structure and
        shardings. ``replay=None`` skips the replay payload (the Elo-ladder
        params-only path). ``extra_template`` selects which ``extra`` entries
        to restore (e.g. the gating incumbent params); without it the
        returned extra is empty."""
        step = iteration if iteration is not None else self.latest_iteration()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        manifest = self._manifest(step)
        detail = _structure_mismatch(
            _leaf_path_shapes(train_state), manifest["train_state"]
        )
        if detail:
            raise ValueError(
                f"checkpoint {self.directory}:{step} was saved with a "
                f"different architecture than the restore template "
                f"(check --channels/--blocks/--norm): {detail}"
            )
        missing = sorted(set(extra_template or {}) - set(manifest["extra_keys"]))
        if missing:
            raise KeyError(f"checkpoint {self.directory}:{step} has no extra {missing}")
        step_dir = os.path.join(self.directory, str(step))
        with np.load(os.path.join(step_dir, _STATE)) as z:
            restored = _rebuild("train_state", train_state, z)
            rng = jax.numpy.asarray(z["rng"])
            extra = {
                key: _rebuild(f"extra/{key}", tmpl, z)
                for key, tmpl in (extra_template or {}).items()
            }
        if replay is not None:
            path = os.path.join(step_dir, f"replay_host{jax.process_index()}.npz")
            with np.load(path) as z:
                _restore_replay(replay, {k: z[k] for k in z.files})
        return step, restored, rng, extra
