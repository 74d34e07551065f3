"""The ``.npz`` + JSON-manifest checkpoint format: round trip, retention,
latest and mid-run restore, and crash-safety of partial writes."""

import json
import os

import numpy as np
import pytest

import jax

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.models.network import make_network
from alphazeroforhnefatafl_tpu.train.checkpoint import CheckpointManager
from alphazeroforhnefatafl_tpu.train.learner import init_train_state, make_optimizer
from alphazeroforhnefatafl_tpu.train.replay import ReplayBuffer


def _state(seed):
    env = make_env("brandubh")
    net = make_network(env.n, channels=8, blocks=1)
    return env, init_train_state(
        net, jax.random.PRNGKey(seed), env.num_observation_planes, make_optimizer()
    )


def _replay(env, seed):
    rb = ReplayBuffer(env, capacity=32, policy_k=4)
    rng = np.random.RandomState(seed)
    for arr in (rb.board, rb.side, rb.reps, rb.policy_idx, rb.policy_p, rb.value):
        arr[...] = rng.randint(0, 3, arr.shape).astype(arr.dtype)
    rb.write, rb.size, rb.total_added = 5, 21, 37
    return rb


def _equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb)
    )


def test_npz_round_trip_with_replay_and_extra(tmp_path):
    env, state = _state(0)
    _, other = _state(1)
    replay = _replay(env, 0)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    rng = jax.random.PRNGKey(9)
    mgr.save(3, state, replay, rng, extra={"incumbent_params": other.params})
    assert sorted(os.listdir(tmp_path / "ck" / "3")) == [
        "manifest.json", "replay_host0.npz", "state.npz",
    ]
    assert mgr.saved_extra_keys() == ("incumbent_params",)

    _, template = _state(5)
    fresh = ReplayBuffer(env, capacity=32, policy_k=4)
    it, restored, rng2, extra = mgr.restore(
        template, fresh, extra_template={"incumbent_params": template.params}
    )
    assert it == 3
    assert _equal(restored, state)
    assert _equal(extra["incumbent_params"], other.params)
    assert np.array_equal(np.asarray(rng2), np.asarray(rng))
    for k in ("board", "side", "reps", "policy_idx", "policy_p", "value"):
        assert np.array_equal(getattr(fresh, k), getattr(replay, k)), k
    assert (fresh.write, fresh.size, fresh.total_added) == (5, 21, 37)
    # Params-only restore skips replay and extra.
    _, ts, _, ex = mgr.restore(template, None)
    assert _equal(ts.params, state.params) and ex == {}


def test_retention_latest_and_mid_restore(tmp_path):
    env, state = _state(0)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    saved = {}
    for it in range(4):
        s = state.replace(step=state.step + it)
        mgr.save(it, s, None, jax.random.PRNGKey(it))
        saved[it] = s
    assert mgr.all_iterations() == [2, 3] and mgr.latest_iteration() == 3
    _, latest, _, _ = mgr.restore(state, None)
    assert int(latest.step) == 3
    _, mid, rng, _ = mgr.restore(state, None, iteration=2)
    assert int(mid.step) == 2
    assert np.array_equal(np.asarray(rng), np.asarray(jax.random.PRNGKey(2)))
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, None, iteration=0)


def test_partial_write_is_ignored_and_structure_checked(tmp_path):
    env, state = _state(0)
    d = tmp_path / "ck"
    mgr = CheckpointManager(str(d))
    assert mgr.latest_iteration() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, None)
    mgr.save(0, state, None, jax.random.PRNGKey(0))
    # A save that died before its rename leaves only a .partial directory.
    os.makedirs(d / "1.partial")
    (d / "1.partial" / "state.npz").write_bytes(b"truncated")
    assert mgr.latest_iteration() == 0
    # The manifest records every leaf path and shape of the train state.
    manifest = json.loads((d / "0" / "manifest.json").read_text())
    assert manifest["train_state"]["params/stem/conv/kernel"] == [3, 3, 6, 8]
    env2 = make_env("brandubh")
    wide = init_train_state(
        make_network(env2.n, channels=16, blocks=1), jax.random.PRNGKey(0),
        env2.num_observation_planes, make_optimizer(),
    )
    with pytest.raises(ValueError, match="different architecture"):
        mgr.restore(wide, None)
    with pytest.raises(KeyError):
        mgr.restore(state, None, extra_template={"incumbent_params": state.params})
