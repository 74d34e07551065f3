"""Tests for the compat reference-IO helpers and the parallel layer
(8-virtual-device mesh sharding of the train step and env step)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.compat.reference_io import (
    board_to_matrix,
    get_all_possible_moves,
    read_entries,
    validate_moves,
    write_to_file,
)
from alphazeroforhnefatafl_tpu.core import fen
from alphazeroforhnefatafl_tpu.core.oracle import Game
from alphazeroforhnefatafl_tpu.core.rules import BOARDS, BRANDUBH


def test_board_to_matrix_reference_encoding():
    # Reference semantics (game/main.rs:55-83): corners 20, throne 30,
    # soldier +1 (both sides!), king +5.
    board = fen.board_from_fen(BOARDS.BRANDUBH)
    m = board_to_matrix(board)
    assert m[0, 0] == 20 and m[6, 6] == 20
    assert m[3, 3] == 35  # throne 30 + king 5
    assert m[0, 3] == 1  # attacker soldier
    assert m[2, 3] == 1  # defender soldier: side-blind, same value
    fixed = board_to_matrix(board, fix_side_blindness=True)
    assert fixed[2, 3] == 3 and fixed[0, 3] == 1


def test_possible_moves_and_masks():
    game = Game(BRANDUBH, BOARDS.BRANDUBH)
    moves = get_all_possible_moves(game)
    assert len(moves) == 40  # brandubh opening mobility for the attacker
    assert validate_moves(game, moves) == [1] * len(moves)


def test_replay_file_round_trip(tmp_path):
    path = str(tmp_path / "replay.txt")
    board = fen.board_from_fen(BOARDS.BRANDUBH)
    m = board_to_matrix(board)
    for i in range(3):
        write_to_file(path, m, [1, 0, 1], i, i + 1, max_entries=1000)
    entries = read_entries(path, side_len=7)
    assert len(entries) == 3
    mat, vec, v1, v2 = entries[1]
    assert np.array_equal(mat, m)
    assert vec.tolist() == [1, 0, 1]
    assert (v1, v2) == (1, 2)


def test_replay_file_eviction(tmp_path):
    # FIFO eviction semantics of game/main.rs:103-106 (line-based bound).
    path = str(tmp_path / "replay.txt")
    m = np.zeros((2, 2), dtype=int)
    write_to_file(path, m, [1], 7, 8, max_entries=5)
    n_lines_1 = len(open(path).read().splitlines())
    write_to_file(path, m, [1], 9, 10, max_entries=5)
    lines = open(path).read().splitlines()
    # One line was evicted before appending the second entry.
    assert len(lines) == 2 * n_lines_1 - 1


def test_multichip_dryrun_via_graft_entry():
    import __graft_entry__ as g

    assert len(jax.devices()) == 8, "conftest should expose 8 virtual devices"
    g.dryrun_multichip(8)


def test_sharded_selfplay_env_step_matches_single_device():
    """The dp-sharded env step must produce identical states to unsharded."""
    from alphazeroforhnefatafl_tpu.core.env import make_env
    from alphazeroforhnefatafl_tpu.parallel.mesh import batch_sharding, make_mesh, shard_batch

    env = make_env("brandubh")
    B = 16
    mesh = make_mesh(axis_sizes=(8,), axis_names=("dp",))

    def step_all(states):
        masks = jax.vmap(env.legal_mask)(states)
        action = jnp.argmax(masks, axis=-1).astype(jnp.int32)
        new_states, _ = jax.vmap(lambda s, a: env.step(s, a, validate=False))(
            states, action
        )
        return new_states

    plain = jax.jit(step_all)(env.reset_batch(B))
    sharded_in = shard_batch(mesh, env.reset_batch(B))
    sharded = jax.jit(step_all)(sharded_in)
    for a, b in zip(jax.tree_util.tree_leaves(plain), jax.tree_util.tree_leaves(sharded)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_initialize_distributed_single_process():
    from alphazeroforhnefatafl_tpu.parallel.launch import (
        initialize_distributed,
        local_batch_slice,
    )

    topo = initialize_distributed()
    assert topo.num_processes == 1
    assert topo.global_devices == 8
    assert local_batch_slice(64) == slice(0, 64)
    # Any batch divides one process; the non-divisible ValueError path is
    # covered in tests/test_multiprocess.py's two-process group.


def test_env_value_identity():
    """Two make_env(preset) instances are EQUAL and hash alike, so every
    lru_cache keyed on the env (the arena move-fn cache) hits across
    instances instead of re-tracing per construction."""
    from alphazeroforhnefatafl_tpu.core.env import TaflEnv, make_env
    from alphazeroforhnefatafl_tpu.core.rules import PRESETS
    from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig
    from alphazeroforhnefatafl_tpu.train.arena import _match_move_fn

    rules, board = PRESETS["brandubh"]
    a, b = TaflEnv(rules, board), TaflEnv(rules, board)
    assert a is not b and a == b and hash(a) == hash(b)
    assert a == make_env("brandubh") and a != make_env("copenhagen")

    def evaluate(params, obs):
        return obs, obs

    cfg = MCTSConfig(num_simulations=2, max_children=4)
    before = _match_move_fn.cache_info()
    _match_move_fn(a, evaluate, cfg, 2, None, None)
    _match_move_fn(b, evaluate, cfg, 2, None, None)
    info = _match_move_fn.cache_info()
    assert info.currsize <= before.currsize + 1 and info.hits >= before.hits + 1


def test_to_tile_traceable_and_consistent():
    """core.actions.to_tile works on plain ints AND under jit (regression:
    it used np.where, which raises on tracers), and agrees with
    decode_to_tiles for every action id."""
    import jax
    import jax.numpy as jnp

    from alphazeroforhnefatafl_tpu.core import actions

    n = 7
    ids = list(range(actions.num_actions(n)))
    fr, fc, d, dist = actions.decode(n, jnp.arange(actions.num_actions(n)))
    tr, tc = jax.jit(actions.to_tile)(fr, fc, d, dist)
    for a in ids[:: max(1, len(ids) // 97)]:
        (r1, c1), (r2, c2) = actions.decode_to_tiles(n, a)
        fr_i, fc_i, d_i, k_i = actions.decode(n, a)
        assert actions.to_tile(fr_i, fc_i, d_i, k_i) == (r2, c2)
        assert (int(tr[a]), int(tc[a])) == (r2, c2)
