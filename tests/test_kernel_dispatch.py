"""Production multi-device move dispatch.

On a >1-device dp mesh, plain jit all-gathers the game batch around the
search's top_k/scatter-add families (GSPMD refuses to batch-partition them)
— measured: seven all-gathers per actor move, some ``f32[B, A]``-sized. The
production actor/arena therefore run the WHOLE move function inside one
``shard_map`` over the dp axis (``KernelDispatch``). These tests run that
exact production path on the 8-virtual-device CPU mesh and assert the
lowered move program contains NO all-gather at all.
"""

import numpy as np
import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core.env import (
    KernelDispatch,
    auto_dispatch,
    make_env,
)
from alphazeroforhnefatafl_tpu.parallel.mesh import batch_sharding, make_mesh
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu.train.arena import play_match
from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayActor, SelfPlayConfig


def _fake_evaluate(env):
    def evaluate(params, obs):
        b = obs.shape[0]
        value = jnp.sum(obs[..., 1], axis=(1, 2)) * 0.01
        return jnp.zeros((b, env.num_actions)), value

    return evaluate


def _make_actor(env, sh, dispatch, **mcts_kw):
    return SelfPlayActor(
        env,
        _fake_evaluate(env),
        MCTSConfig(num_simulations=4, max_children=8, max_depth=8, **mcts_kw),
        SelfPlayConfig(batch_size=8, max_game_len=8, policy_k=8),
        sharding=sh,
        dispatch=dispatch,
    )


def test_auto_dispatch_rule():
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)
    d = auto_dispatch(sh)
    assert d is not None and d.mesh is mesh and d.axis == "dp"
    assert auto_dispatch(None) is None
    one = make_mesh(axis_sizes=(1,), axis_names=("dp",), devices=jax.devices()[:1])
    assert auto_dispatch(batch_sharding(one)) is None
    # A replicated batch axis (P(None)) must NOT dispatch: a shard_map with
    # a None axis would make every device redundantly step the whole batch.
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert auto_dispatch(NamedSharding(mesh, P(None))) is None


def test_actor_move_has_no_allgather_under_dispatch():
    """Lower the production actor move fn (whole-move shard_map) on the
    8-device mesh: the compiled program must
    contain no all-gather — the game batch stays data-parallel through the
    root mask, every search wave's step, and the root step."""
    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)
    actor = _make_actor(env, sh, KernelDispatch(mesh))
    states = actor._reset_batch()
    temps = jnp.zeros((8,))
    rng = jax.random.PRNGKey(0)
    hlo = actor._move.lower(None, states, temps, rng).compile().as_text()
    assert "all-gather" not in hlo, "game batch was all-gathered in the move"
    assert "all-reduce" not in hlo
    # Control: the same move WITHOUT the dispatch does all-gather (this is
    # what the dispatch exists to prevent; if GSPMD learns to partition
    # these ops the dispatch can be retired).
    plain = _make_actor(env, sh, None)
    hlo_plain = plain._move.lower(None, states, temps, rng).compile().as_text()
    assert "all-gather" in hlo_plain


def test_actor_move_dispatch_matches_plain_path():
    """With exploration noise disabled, the shard_map path must produce the
    same search outputs (policy targets, root values) as the plain path —
    sharding is semantically invisible."""
    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)
    a_disp = _make_actor(
        env, sh, KernelDispatch(mesh), dirichlet_eps=0.0
    )
    a_plain = _make_actor(env, sh, None, dirichlet_eps=0.0)
    states = a_plain._reset_batch()
    temps = jnp.zeros((8,))
    rng = jax.random.PRNGKey(3)
    out_d = a_disp._move(None, states, temps, rng)
    out_p = a_plain._move(None, states, temps, rng)
    # top_a, top_p, root_value are rng-free with noise off; actions are not
    # (argmax tie-breaks use per-shard-folded keys).
    for i in (3, 4, 5):
        assert np.allclose(np.asarray(out_d[i]), np.asarray(out_p[i])), i
    # And the dispatched batch stays sharded over all 8 devices.
    assert len(out_d[0].board.sharding.device_set) == 8


def test_actor_play_full_games_under_dispatch():
    """The full play() loop (reset/flush/where_reset host logic) works with
    the shard_map dispatch path."""
    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)
    actor = _make_actor(env, sh, KernelDispatch(mesh))
    stats = actor.play(None, None, jax.random.PRNGKey(1), num_games=8)
    assert stats.games >= 8
    assert stats.positions > 0


def test_arena_match_no_allgather_under_dispatch():
    """play_match with the whole-move shard_map dispatch: no all-gather in
    the lowered move fn, valid + replay-deterministic results."""
    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)
    evaluate = _fake_evaluate(env)
    params = {"b": jnp.zeros((4,))}
    params2 = {"b": jnp.ones((4,))}
    cfg = MCTSConfig(num_simulations=4, max_children=8, max_depth=8)
    kwargs = dict(
        num_games=8, max_game_len=10, rng=jax.random.PRNGKey(2), sharding=sh,
        dispatch=KernelDispatch(mesh),
    )
    res = play_match(env, evaluate, params, params2, cfg, **kwargs)
    assert res.games == 8
    assert res.candidate_wins + res.incumbent_wins + res.draws + res.truncated == 8
    res2 = play_match(env, evaluate, params, params2, cfg, **kwargs)
    assert res2.as_dict() == res.as_dict()

    from alphazeroforhnefatafl_tpu.train.arena import _match_move_fn

    move = _match_move_fn(
        env, evaluate, cfg, 8, sh, KernelDispatch(mesh)
    )
    states = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sh), env.reset_batch(8)
    )
    stacked = jax.tree_util.tree_map(
        lambda c, i: jnp.stack([c, i]), params, params2
    )
    hlo = move.lower(
        stacked, jnp.int32(0), states, jax.random.PRNGKey(0)
    ).compile().as_text()
    assert "all-gather" not in hlo


def test_arena_shard_pair_evaluate_owner_layout():
    """Each shard's net ownership under the shard-local pair evaluate must
    reproduce the global half-split: candidate owns the first half of the
    batch exactly when i0 == 0 selects it."""
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    from alphazeroforhnefatafl_tpu.train.arena import _shard_pair_evaluate

    # Nets are scalars; "evaluate" returns the chosen net's scalar so the
    # output reveals ownership per game.
    def evaluate(net, obs):
        return jnp.full((obs.shape[0],), net), None

    ev = _shard_pair_evaluate(evaluate, "dp", 16, 2)
    stacked = jnp.asarray([10.0, 20.0])

    def run(i0, obs):
        out, _ = ev((stacked, i0), obs)
        return out

    obs = jnp.zeros((16, 1))
    got = jax.jit(
        lambda i0, o: jax.shard_map(
            run, mesh=mesh, in_specs=(P(), P("dp")), out_specs=P("dp"),
            check_vma=False,
        )(i0, o)
    )(jnp.int32(0), obs)
    np.testing.assert_array_equal(np.asarray(got), [10.0] * 8 + [20.0] * 8)
    got1 = jax.jit(
        lambda i0, o: jax.shard_map(
            run, mesh=mesh, in_specs=(P(), P("dp")), out_specs=P("dp"),
            check_vma=False,
        )(i0, o)
    )(jnp.int32(1), obs)
    np.testing.assert_array_equal(np.asarray(got1), [20.0] * 8 + [10.0] * 8)


def test_multi_leaf_under_dispatch_no_allgather():
    """The round-5 multi-leaf search (leaves_per_wave=2) composes with the
    whole-move shard_map: still zero all-gathers, and the dispatched outputs
    match the plain single-program path exactly (noise off)."""
    env = make_env("brandubh")
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))
    sh = batch_sharding(mesh)
    a_disp = _make_actor(
        env, sh, KernelDispatch(mesh),
        dirichlet_eps=0.0, leaves_per_wave=2,
    )
    states = a_disp._reset_batch()
    temps = jnp.zeros((8,))
    rng = jax.random.PRNGKey(7)
    hlo = a_disp._move.lower(None, states, temps, rng).compile().as_text()
    assert "all-gather" not in hlo
    assert "all-reduce" not in hlo
    a_plain = _make_actor(env, sh, None, dirichlet_eps=0.0, leaves_per_wave=2)
    out_d = a_disp._move(None, states, temps, rng)
    out_p = a_plain._move(None, states, temps, rng)
    for i in (3, 4, 5, 6):  # top_a, top_p, root_value, fallback rate
        assert np.allclose(np.asarray(out_d[i]), np.asarray(out_p[i])), i
