"""Device-side episode accumulation (``SelfPlayConfig.scan_moves``).

The scan path advances many moves per dispatch entirely on device and the
host stitches episodes out of the emitted position stream. Truth anchor: it
must produce bit-identical games to the per-move host loop for the same seed
(the RNG discipline is one ``split`` per move in both paths), and must be
seed-deterministic on its own.
"""

import numpy as np
import jax

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayActor, SelfPlayConfig
from tests.test_mcts import make_fake_evaluate


class _Recorder:
    """Replay stand-in that keeps each episode's ``add`` payload."""

    def __init__(self):
        self.episodes = []

    def add(self, board, side, reps, pidx, pp, z):
        self.episodes.append(
            tuple(np.asarray(a).copy() for a in (board, side, reps, pidx, pp, z))
        )


def _run(scan_moves, *, batch_size=1, seed=7, num_games=3, resign=None,
         gumbel=False, sample_early=False):
    env = make_env("brandubh")
    cfg = SelfPlayConfig(
        batch_size=batch_size,
        temp_threshold=4,
        max_game_len=20,
        policy_k=8,
        scan_moves=scan_moves,
        resign_threshold=resign,
        gumbel_sample_temp_moves=sample_early,
    )
    actor = SelfPlayActor(
        env,
        make_fake_evaluate(env),
        MCTSConfig(
            num_simulations=8,
            max_children=16,
            max_depth=16,
            **(
                {"root_selection": "gumbel", "gumbel_considered": 4}
                if gumbel
                else {}
            ),
        ),
        cfg,
    )
    rec = _Recorder()
    stats = actor.play(None, rec, jax.random.PRNGKey(seed), num_games=num_games)
    return rec.episodes, stats


def test_scan_path_matches_host_loop_bitwise():
    # batch_size=1 so both paths emit the one slot's episode stream in
    # order; scan_moves=6 < game length forces episodes to span chunk
    # boundaries (exercising the pending-segment stitching).
    host_eps, _ = _run(0)
    scan_eps, _ = _run(6)
    n = min(len(host_eps), len(scan_eps))
    assert n >= 3
    for i in range(n):
        for h, s, name in zip(
            host_eps[i],
            scan_eps[i],
            ("board", "side", "reps", "pidx", "pp", "z"),
        ):
            assert np.array_equal(h, s), f"episode {i} field {name} differs"


def test_scan_path_seed_deterministic_multislot():
    e1, s1 = _run(5, batch_size=4, num_games=6)
    e2, s2 = _run(5, batch_size=4, num_games=6)
    assert s1.as_dict() == s2.as_dict()
    assert len(e1) == len(e2) >= 6
    for a, b in zip(e1, e2):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    e3, _ = _run(5, batch_size=4, num_games=6, seed=8)
    assert not all(
        len(a[1]) == len(b[1]) and np.array_equal(a[0], b[0])
        for a, b in zip(e1, e3)
    )


def _sharded_actor(scan_moves, batch=8, max_len=8):
    from alphazeroforhnefatafl_tpu.core.env import KernelDispatch
    from alphazeroforhnefatafl_tpu.parallel.mesh import batch_sharding, make_mesh

    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)
    actor = SelfPlayActor(
        env,
        make_fake_evaluate(env),
        MCTSConfig(num_simulations=4, max_children=8, max_depth=8),
        SelfPlayConfig(
            batch_size=batch, max_game_len=max_len, policy_k=8,
            temp_threshold=4, scan_moves=scan_moves,
        ),
        sharding=sh,
        dispatch=KernelDispatch(mesh),
    )
    return env, actor


def test_sharded_scan_chunk_no_collectives_and_matches_per_move():
    """The sharded scan chunk (whole move scan inside one shard_map) must
    contain no cross-device collectives, and its emitted position stream
    must be bit-identical to driving the per-move sharded path with the
    same split discipline."""
    import jax.numpy as jnp

    T = 4
    env, actor = _sharded_actor(T)
    _, per_move = _sharded_actor(0)
    B, L = 8, 8
    states0 = actor._reset_batch()
    rng = jax.random.PRNGKey(5)
    carry = (
        states0,
        jnp.zeros((B,), jnp.int32),
        rng,
        jnp.zeros((B, 2), jnp.int32),
        jnp.ones((B,), bool),
        jnp.full((B,), -1, jnp.int8),
        jax.random.PRNGKey(9),
    )
    hlo = actor._scan_chunk.lower(None, carry).compile().as_text()
    assert "all-gather" not in hlo
    assert "all-reduce" not in hlo

    _, ys = actor._scan_chunk(None, carry)
    ys = {k: np.asarray(v) for k, v in ys.items()}

    # Replicate with the per-move sharded path (same one-split-per-move
    # chain; the shard-index fold happens inside both local programs).
    states = per_move._reset_batch()
    ep_len = np.zeros(B, np.int64)
    for t in range(T):
        temps = jnp.asarray((ep_len < 4).astype(np.float32))
        b_board = np.asarray(states.board)
        b_side = np.asarray(states.side_to_play)
        rng, sub = jax.random.split(rng)
        states, actions, info, top_a, top_p, root_v, _fb, _ = per_move._move(
            None, states, temps, sub
        )
        done = np.asarray(states.terminated)
        results = np.asarray(states.result)
        ep_len += 1
        truncate = (ep_len >= L) & ~done
        end = done | truncate
        assert np.array_equal(ys["board"][t], b_board), t
        assert np.array_equal(ys["side"][t], b_side.astype(np.int8)), t
        assert np.array_equal(ys["top_a"][t], np.asarray(top_a)), t
        assert np.allclose(ys["top_p"][t], np.asarray(top_p)), t
        assert np.allclose(ys["root_v"][t], np.asarray(root_v)), t
        assert np.array_equal(ys["ended"][t], end), t
        from alphazeroforhnefatafl_tpu.core.env import DRAW

        exp_result = np.where(done, results, DRAW).astype(np.int32)
        assert np.array_equal(ys["result"][t], exp_result), t
        ep_len[end] = 0
        reset_mask = jnp.asarray(end)
        fresh = per_move._reset_batch()

        def where_reset(f, c):
            d = reset_mask.reshape(reset_mask.shape + (1,) * (c.ndim - 1))
            return jnp.where(d, f, c)

        states = jax.tree_util.tree_map(where_reset, fresh, states)


def test_sharded_scan_play_full_games():
    _, actor = _sharded_actor(4)
    s1 = actor.play(None, None, jax.random.PRNGKey(1), num_games=8)
    assert s1.games >= 8 and s1.positions > 0
    _, actor2 = _sharded_actor(4)
    s2 = actor2.play(None, None, jax.random.PRNGKey(1), num_games=8)
    assert s1.as_dict() == s2.as_dict()


def test_scan_path_with_resignation_runs_and_counts():
    eps, stats = _run(
        6, batch_size=4, num_games=6, resign=0.2, seed=3
    )
    d = stats.as_dict()
    assert stats.games >= 6
    assert stats.positions == stats.length_sum == sum(len(e[1]) for e in eps)
    assert (
        stats.attacker_wins + stats.defender_wins + stats.draws == stats.games
    )
    assert stats.truncated <= stats.draws
    assert 0.0 <= d["resign_fp_rate"] <= 1.0


def test_scan_path_gumbel_matches_host_loop_bitwise():
    """Gumbel root selection (with and without the temperature-phase
    sampling mitigation) through the device-side scan must replicate the
    per-move host loop bit-for-bit — the production gumbel arm runs with
    scan_moves > 0."""
    for sample_early in (False, True):
        host_eps, _ = _run(0, gumbel=True, sample_early=sample_early)
        scan_eps, _ = _run(6, gumbel=True, sample_early=sample_early)
        n = min(len(host_eps), len(scan_eps))
        assert n >= 3
        for i in range(n):
            for h, s, name in zip(
                host_eps[i],
                scan_eps[i],
                ("board", "side", "reps", "pidx", "pp", "z"),
            ):
                assert np.array_equal(h, s), (
                    f"sample_early={sample_early} episode {i} field {name}"
                )
