"""The full AlphaZero iteration sharded over a dp mesh (SURVEY.md §7 stage
5): self-play game batch, learner batch and arena batch all ride the
8-virtual-device CPU mesh, with shardings asserted on the live arrays."""

import json

import numpy as np
import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.parallel.mesh import (
    auto_mesh,
    batch_sharding,
    make_mesh,
    replicate,
)
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu.train.arena import play_match
from alphazeroforhnefatafl_tpu.train.loop import LoopConfig, run_loop
from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayActor, SelfPlayConfig
from alphazeroforhnefatafl_tpu.utils.metrics import MetricsLogger


def test_auto_mesh_divisibility():
    assert auto_mesh(32, 8).size == 8
    assert auto_mesh(32, 6).size == 2
    assert auto_mesh(7, 5).size == 1


def test_selfplay_actor_game_batch_is_sharded():
    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)

    def evaluate(params, obs):
        b = obs.shape[0]
        return jnp.zeros((b, env.num_actions)), jnp.zeros((b,))

    actor = SelfPlayActor(
        env,
        evaluate,
        MCTSConfig(num_simulations=2, max_children=8, max_depth=8),
        SelfPlayConfig(batch_size=8, max_game_len=8, policy_k=8),
        sharding=sh,
    )
    states = actor._reset_batch()
    assert states.board.sharding == sh
    assert len(states.board.sharding.device_set) == 8
    # One move keeps the game batch sharded.
    out = actor._move(None, states, jnp.zeros((8,)), jax.random.PRNGKey(0))
    new_states = out[0]
    assert len(new_states.board.sharding.device_set) == 8


def test_full_iteration_sharded_with_gating(tmp_path):
    """selfplay -> train -> arena, all on the 8-device mesh, gating live."""
    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    cfg = LoopConfig(
        preset="brandubh",
        iterations=2,
        games_per_iteration=8,
        train_steps_per_iteration=2,
        train_batch_size=16,
        min_replay_size=8,
        replay_capacity=4_096,
        channels=8,
        blocks=1,
        arena_games=8,
        arena_sims=2,
        arena_every=1,
        arena_max_game_len=16,
        seed=5,
        mcts=MCTSConfig(num_simulations=4, max_children=8, max_depth=8),
        selfplay=SelfPlayConfig(
            batch_size=8, temp_threshold=4, max_game_len=16, policy_k=8
        ),
    )
    mpath = tmp_path / "m.jsonl"
    state = run_loop(env, cfg, log=MetricsLogger(jsonl_path=str(mpath)), mesh=mesh)

    # Params replicated over all 8 devices; finite after sharded training.
    leaf = jax.tree_util.tree_leaves(state.params)[0]
    assert len(leaf.sharding.device_set) == 8
    assert np.isfinite(np.asarray(leaf, np.float32)).all()
    assert int(state.step) == 4

    lines = [json.loads(l) for l in open(mpath)]
    assert len(lines) == 2
    # Arena gating ran every iteration and recorded a promotion decision.
    assert all("arena/promoted" in l and "arena/score" in l for l in lines)
    # Metrics carry per-iteration step attribution.
    assert [l["step"] for l in lines] == [0, 1]


def test_play_match_stacked_params_sharded():
    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)

    # A deterministic fake net: value prefers boards with more defenders, so
    # the match is well-defined; both players share it (self-match).
    def evaluate(params, obs):
        logits = jnp.tile(params["bias"], (obs.shape[0], 1))
        value = jnp.sum(obs[..., 1], axis=(1, 2)) * 0.01
        return logits, value

    params = {"bias": jnp.zeros((env.num_actions,))}
    params2 = {"bias": jnp.full((env.num_actions,), 0.1)}
    res = play_match(
        env,
        evaluate,
        params,
        params2,
        MCTSConfig(num_simulations=4, max_children=8, max_depth=8),
        num_games=8,
        max_game_len=12,
        rng=jax.random.PRNGKey(1),
        sharding=sh,
    )
    assert res.games == 8
    assert res.candidate_wins + res.incumbent_wins + res.draws + res.truncated == 8

    # Deterministic in the rng: replay gives the identical result.
    res2 = play_match(
        env,
        evaluate,
        params,
        params2,
        MCTSConfig(num_simulations=4, max_children=8, max_depth=8),
        num_games=8,
        max_game_len=12,
        rng=jax.random.PRNGKey(1),
        sharding=sh,
    )
    assert res2.as_dict() == res.as_dict()


def test_play_match_rejects_odd_games():
    env = make_env("brandubh")

    def evaluate(params, obs):
        return jnp.zeros((obs.shape[0], env.num_actions)), jnp.zeros((obs.shape[0],))

    try:
        play_match(env, evaluate, None, None, MCTSConfig(), num_games=3)
    except ValueError:
        pass
    else:
        raise AssertionError("odd num_games should be rejected")


def test_metrics_logger_step_attribution(tmp_path):
    path = tmp_path / "m.jsonl"
    log = MetricsLogger(jsonl_path=str(path))
    log.scalar("a", 1.0, step=0)
    log.scalar("b", 2.0, step=0)
    # A scalar for a NEW step flushes the previous step's buffer first.
    log.scalar("a", 3.0, step=1)
    log.flush()
    lines = [json.loads(l) for l in open(path)]
    assert [l["step"] for l in lines] == [0, 1]
    assert lines[0]["a"] == 1.0 and lines[0]["b"] == 2.0
    assert lines[1]["a"] == 3.0 and "b" not in lines[1]


def test_gumbel_loop_iteration(tmp_path):
    """One full gated iteration with gumbel root selection on the mesh."""
    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    cfg = LoopConfig(
        preset="brandubh",
        iterations=1,
        games_per_iteration=8,
        train_steps_per_iteration=1,
        train_batch_size=16,
        min_replay_size=8,
        replay_capacity=1_024,
        channels=8,
        blocks=1,
        arena_games=8,
        arena_sims=2,
        arena_every=1,
        arena_max_game_len=8,
        seed=6,
        mcts=MCTSConfig(
            num_simulations=6, max_children=8, max_depth=8,
            root_selection="gumbel", gumbel_considered=4,
        ),
        selfplay=SelfPlayConfig(
            batch_size=8, temp_threshold=2, max_game_len=10, policy_k=8
        ),
    )
    state = run_loop(env, cfg, mesh=mesh)
    assert int(state.step) == 1
    leaf = jax.tree_util.tree_leaves(state.params)[0]
    assert len(leaf.sharding.device_set) == 8


def test_step_many_dp_sharded_matches_unsharded():
    """``step_many`` under a jit whose game batch is dp-sharded over the
    8-device mesh must match the unsharded step field-for-field and keep
    the batch sharded (pure DP of games)."""
    from alphazeroforhnefatafl_tpu.parallel.mesh import batch_sharding, shard_batch

    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)
    B = 16
    s = env.reset_batch(B)
    m = np.asarray(jax.vmap(env.legal_mask)(s))
    a = jnp.asarray(
        [int(np.nonzero(m[b])[0][b % 3]) for b in range(B)], jnp.int32
    )
    ns, info = jax.jit(env.step_many, out_shardings=sh)(
        shard_batch(mesh, s), shard_batch(mesh, a)
    )
    ns2, info2 = jax.vmap(lambda ss, aa: env.step(ss, aa, validate=False))(s, a)
    for f in (
        "board", "side_to_play", "reps", "mid_pair", "recent_plays",
        "rep_first_i", "plays_since_capture", "turn", "terminated", "result",
        "reason",
    ):
        assert np.array_equal(
            np.asarray(getattr(ns, f)), np.asarray(getattr(ns2, f))
        ), f
    for f in ("captures", "n_captures", "result", "reward_mover",
              "legal_mask", "invalid"):
        assert np.array_equal(
            np.asarray(getattr(info, f)), np.asarray(getattr(info2, f))
        ), f
    assert len(ns.board.sharding.device_set) == 8
    assert ns.board.sharding.shard_shape(ns.board.shape)[0] == B // 8
