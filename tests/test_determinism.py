"""Seeded determinism (SURVEY.md §5, race-detection row): this build's
answer to the reference's absence of concurrency hazards is determinism by
construction — jit purity plus threaded PRNG keys. This pins it: the same
seed must reproduce the identical self-play trajectory bit-for-bit."""

import numpy as np
import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu.train.replay import ReplayBuffer
from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayActor, SelfPlayConfig
from tests.test_mcts import make_fake_evaluate


def _run_once(seed: int):
    env = make_env("brandubh")
    cfg = SelfPlayConfig(batch_size=4, temp_threshold=4, max_game_len=24, policy_k=8)
    actor = SelfPlayActor(
        env,
        make_fake_evaluate(env),
        MCTSConfig(num_simulations=8, max_children=16, max_depth=16),
        cfg,
    )
    replay = ReplayBuffer(env, 2_048, cfg.policy_k)
    stats = actor.play(None, replay, jax.random.PRNGKey(seed), num_games=4)
    return replay, stats


def test_selfplay_trajectory_is_seed_deterministic():
    r1, s1 = _run_once(seed=123)
    r2, s2 = _run_once(seed=123)
    assert s1.as_dict() == s2.as_dict()
    assert r1.size == r2.size and r1.size > 0
    for field in ("board", "side", "reps", "policy_idx", "policy_p", "value"):
        a, b = getattr(r1, field), getattr(r2, field)
        assert np.array_equal(a, b), f"replay.{field} differs under equal seed"


def test_selfplay_trajectory_depends_on_seed():
    r1, _ = _run_once(seed=123)
    r3, _ = _run_once(seed=124)
    # Different seeds must explore differently (catches a silently ignored
    # key as aggressively as the equality above catches nondeterminism).
    same = r1.size == r3.size and np.array_equal(
        r1.board[: r1.size], r3.board[: r3.size]
    )
    assert not same, "trajectory identical under different seeds"
