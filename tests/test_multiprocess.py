"""True multi-process jax.distributed smoke test on CPU.

Spawns two worker processes that form a process group through
``parallel.launch.initialize_distributed`` (the multi-host entry point of
the framework) and run a global psum across both hosts' devices — the
communication pattern of the DP learner's gradient all-reduce, exercised
without accelerators (SURVEY.md §4: distributed testing designed fresh;
the reference has no multi-process code at all).
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.getcwd())
from alphazeroforhnefatafl_tpu.parallel.launch import (
    initialize_distributed,
    local_batch_slice,
)

coord, pid = sys.argv[1], int(sys.argv[2])
topo = initialize_distributed(coord, num_processes=2, process_id=pid)
assert topo.num_processes == 2, topo
assert topo.global_devices == 4, topo

import jax.numpy as jnp
x = jnp.ones((jax.local_device_count(),))
out = jax.pmap(lambda v: jax.lax.psum(v, "i"), axis_name="i")(x)
assert float(out[0]) == topo.global_devices, out

sl = local_batch_slice(8)
assert sl == slice(pid * 4, pid * 4 + 4), sl
try:
    local_batch_slice(9)  # not divisible by 2 processes -> must raise
except ValueError:
    pass
else:
    raise AssertionError("local_batch_slice(9) silently orphaned a game")
print(f"WORKER{pid}_OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_psum(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=os.getcwd(),
        )
        for pid in range(2)
    ]
    outs = []
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=150)
        outs.append(out)
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    for pid in range(2):
        assert f"WORKER{pid}_OK" in outs[pid], outs[pid]


LOOP_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.getcwd())
from alphazeroforhnefatafl_tpu.parallel.launch import initialize_distributed

coord, pid = sys.argv[1], int(sys.argv[2])
topo = initialize_distributed(coord, num_processes=2, process_id=pid)
assert topo.global_devices == 4, topo

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu.train.loop import LoopConfig, run_loop
from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayConfig

env = make_env("brandubh")
from alphazeroforhnefatafl_tpu.train.replay import ReplayBuffer
cfg = LoopConfig(
    preset="brandubh",
    iterations=1,
    games_per_iteration=4,     # 2 per host
    train_steps_per_iteration=1,
    train_batch_size=8,        # GLOBAL batch; 4 sampled per host
    min_replay_size=4,
    replay_capacity=512,
    channels=8,
    blocks=1,
    arena_games=0,
    seed=11,
    mcts=MCTSConfig(num_simulations=2, max_children=8, max_depth=8),
    selfplay=SelfPlayConfig(batch_size=2, temp_threshold=2, max_game_len=6, policy_k=8),
)
replay = ReplayBuffer(env, cfg.replay_capacity, cfg.selfplay.policy_k)
state = run_loop(env, cfg, replay=replay)
assert int(state.step) == 1, state.step

# Params ended replicated over all four global devices and identical on
# both hosts (the psum grad all-reduce keeps them in sync).
import numpy as np
leaf = jax.tree_util.tree_leaves(state.params)[0]
assert len(leaf.sharding.device_set) == 4, leaf.sharding
# Digest of this host's self-play games: the per-host replays must DIFFER
# (each host folds its process index into the self-play key; identical
# digests would mean duplicated games across the pod).
import hashlib
digest = hashlib.sha1(
    np.ascontiguousarray(replay.board[: replay.size]).tobytes()
    + np.ascontiguousarray(replay.policy_p[: replay.size]).tobytes()
).hexdigest()[:16]
print(f"LOOPWORKER{pid}_OK {float(np.asarray(leaf).sum()):.6f} {digest}", flush=True)
"""


def test_two_process_training_loop(tmp_path):
    """One full AlphaZero iteration across a REAL two-process group: each
    host plays its own self-play games into a local replay and contributes
    its slice of the global dp-sharded learner batch
    (make_array_from_process_local_data); params stay replicated/identical."""
    coord = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "loop_worker.py"
    script.write_text(LOOP_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=os.getcwd(),
        )
        for pid in range(2)
    ]
    outs = []
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=420)
        outs.append(out)
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    sums, digests = [], []
    for pid in range(2):
        line = [l for l in outs[pid].splitlines() if f"LOOPWORKER{pid}_OK" in l]
        assert line, outs[pid]
        sums.append(line[0].split()[-2])
        digests.append(line[0].split()[-1])
    # Same final params on both hosts...
    assert sums[0] == sums[1], sums
    # ...from DIFFERENT per-host self-play games (process index folded into
    # the self-play key; identical replays would halve the pod's data).
    assert digests[0] != digests[1], digests
