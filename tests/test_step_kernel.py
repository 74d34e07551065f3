"""The batched env step — ``jit(vmap(step))``, what ``TaflEnv.step_many``
runs — against the Python oracle, game by game.

Every case loads the same positions into both engines (the oracle from the
FEN of the env's board) and compares boards, captures, results and reasons
and the next player's legal mask. Dense random boards fire captures,
shieldwalls and flood-fill outcomes far more often than playouts from the
start position, so they stay beside the fixtures.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core import actions as A
from alphazeroforhnefatafl_tpu.core import fen
from alphazeroforhnefatafl_tpu.core.env import (
    DRAW,
    ONGOING,
    R_DRAW_NO_PLAYS,
    R_DRAW_REPETITION,
    TaflEnv,
    make_env,
)
from alphazeroforhnefatafl_tpu.core.oracle import GameLogic, GameState, Play
from alphazeroforhnefatafl_tpu.core.rules import PRESETS, Side
from tests.test_env_differential import oracle_legal_action_mask, oracle_result


def batched_step(env):
    return jax.jit(
        lambda s, a: jax.vmap(lambda ss, aa: env.step(ss, aa, validate=False))(s, a)
    )


def oracle_state(env, states, b) -> GameState:
    """Game ``b`` of a batch as an oracle state loaded by FEN (repetition
    history starts empty, as for every position loaded here)."""
    side = Side(int(states.side_to_play[b]))
    return GameState.from_fen(fen.board_to_fen(np.asarray(states.board[b])), side)


def assert_step_matches(logic, n, ostate, action, new_states, info, b, ctx):
    """Apply ``action`` to ``ostate`` on the oracle and compare game ``b``."""
    src, dst = A.decode_to_tiles(n, int(action))
    new_o, ocaps, _ = logic.do_valid_play(Play.from_tiles(src, dst), ostate)
    ctx = f"{ctx} game {b} play {fen.play_to_str(src, dst)}"
    assert not bool(info.invalid[b]), ctx
    ecaps = {tuple(t) for t in np.argwhere(np.asarray(info.captures[b]))}
    assert ecaps == ocaps, f"{ctx}: captures oracle={ocaps} env={ecaps}"
    assert np.array_equal(np.asarray(new_states.board[b]), new_o.board), ctx
    assert int(new_states.reps[b, 0]) == new_o.repetitions.attacker_reps, ctx
    assert int(new_states.reps[b, 1]) == new_o.repetitions.defender_reps, ctx
    ores, oreason = oracle_result(new_o)
    assert int(new_states.result[b]) == ores, ctx
    if ores != ONGOING:
        assert bool(new_states.terminated[b]), ctx
        if ores == DRAW:
            expect = {0: R_DRAW_REPETITION, 1: R_DRAW_NO_PLAYS}[int(oreason)]
        else:
            expect = int(oreason)
        assert int(new_states.reason[b]) == expect, ctx
    assert np.array_equal(
        np.asarray(info.legal_mask[b]), oracle_legal_action_mask(logic, new_o)
    ), f"{ctx}: next legal mask"
    return new_o


def random_legal_actions(rng, masks):
    return jnp.asarray(
        [int(rng.choice(np.nonzero(m)[0])) if m.any() else 0 for m in masks],
        jnp.int32,
    )


@pytest.mark.parametrize("preset", ["brandubh", "copenhagen", "tablut", "magpie"])
def test_batched_step_matches_oracle(preset):
    """Random playouts of a batch of games, every game replayed on the
    oracle move by move (finished games restart in both engines)."""
    rules, start = PRESETS[preset]
    env = make_env(preset)
    n = env.n
    logic = GameLogic(rules, n)
    B, steps = 6, 24
    rng = np.random.RandomState(hash(preset) % (2**31))
    step = batched_step(env)
    states = env.reset_batch(B)
    games = [GameState.from_fen(start, rules.starting_side) for _ in range(B)]
    for t in range(steps):
        masks = np.stack([oracle_legal_action_mask(logic, g) for g in games])
        acts = random_legal_actions(rng, masks)
        states, info = step(states, acts)
        for b in range(B):
            games[b] = assert_step_matches(
                logic, n, games[b], acts[b], states, info, b, f"{preset} step {t}"
            )
        done = np.asarray(states.terminated)
        if done.any():
            fresh = env.reset_batch(B)
            d = jnp.asarray(done)
            states = jax.tree_util.tree_map(
                lambda f, c: jnp.where(d.reshape((-1,) + (1,) * (c.ndim - 1)), f, c),
                fresh,
                states,
            )
            for b in np.nonzero(done)[0]:
                games[b] = GameState.from_fen(start, rules.starting_side)


def test_batched_step_shieldwall_fixture():
    """The corner-closing shieldwall fixture (game/game/logic.rs:1108-1123)
    through the batched step: the oracle and the fixture's expected
    captures agree with it."""
    from alphazeroforhnefatafl_tpu.core.rules import COPENHAGEN

    board_fen = "9/9/9/9/6t2/7tT/7tT/7tT/9"
    env = TaflEnv(COPENHAGEN, board_fen)
    states = env.reset_batch(1)  # attacker to move
    action = jnp.asarray([A.encode_from_tiles(9, (4, 6), (4, 8))], jnp.int32)
    new_states, info = batched_step(env)(states, action)
    logic = GameLogic(COPENHAGEN, 9)
    assert_step_matches(
        logic, 9, oracle_state(env, states, 0), action[0], new_states, info, 0,
        "shieldwall",
    )
    caps = {tuple(t) for t in np.argwhere(np.asarray(info.captures[0]))}
    assert caps == {(5, 8), (6, 8), (7, 8)}


def test_batched_step_exit_fort_fixture():
    """A defender move completing a bulge exit fort (logic.rs:1215-1233)
    must end the game with an ExitFort win, as on the oracle."""
    from alphazeroforhnefatafl_tpu.core.env import WIN_DEFENDER
    from alphazeroforhnefatafl_tpu.core.rules import COPENHAGEN, WinReason

    env = TaflEnv(COPENHAGEN, "4t4/1t7/9/9/5T3/6TTT/5T2K/6TTT/9")
    states = env.reset_batch(1).replace(side_to_play=jnp.ones((1,), jnp.int32))
    action = jnp.asarray([A.encode_from_tiles(9, (4, 5), (5, 5))], jnp.int32)
    ns, info = batched_step(env)(states, action)
    logic = GameLogic(COPENHAGEN, 9)
    assert_step_matches(
        logic, 9, oracle_state(env, states, 0), action[0], ns, info, 0, "exit fort"
    )
    assert int(ns.result[0]) == WIN_DEFENDER
    assert int(ns.reason[0]) == int(WinReason.EXIT_FORT)


def test_batched_step_dense_boards():
    """Dense random boards, a batch at a time, each game against the oracle
    loaded from its FEN."""
    from tests.test_env_golden import random_dense_board

    env = make_env("copenhagen")
    n = env.n
    logic = GameLogic(PRESETS["copenhagen"][0], n)
    rng = np.random.RandomState(7)
    B = 8
    step = batched_step(env)
    for round_i in range(4):
        boards = np.stack([random_dense_board(rng, n) for _ in range(B)])
        side = rng.randint(0, 2)
        states = env.reset_batch(B).replace(
            board=jnp.asarray(boards, jnp.int8),
            side_to_play=jnp.full((B,), side, jnp.int32),
        )
        games = [oracle_state(env, states, b) for b in range(B)]
        masks = np.stack([oracle_legal_action_mask(logic, g) for g in games])
        acts = random_legal_actions(rng, masks)
        new_states, info = step(states, acts)
        for b in range(B):
            if masks[b].any():
                assert_step_matches(
                    logic, n, games[b], acts[b], new_states, info, b,
                    f"round {round_i}",
                )


def test_batched_step_repetition_loss_fixture():
    """The repetition-loss sequence (logic.rs:1405-1421) played through the
    batched step and the oracle side by side: the game ends at the same ply
    (defender wins, attacker repeated 3x)."""
    from alphazeroforhnefatafl_tpu.core.env import WIN_DEFENDER
    from alphazeroforhnefatafl_tpu.core.rules import WinReason

    rules, start = PRESETS["brandubh"]
    env = make_env("brandubh")
    logic = GameLogic(rules, 7)
    step = batched_step(env)
    states = env.reset_batch(1)
    game = GameState.from_fen(start, rules.starting_side)
    moves = ["d6-f6", "d5-f5", "f6-d6", "f5-d5"] * 3 + ["d6-f6"]
    for i, mv in enumerate(moves):
        src, dst = mv.split("-")
        aid = A.encode_from_tiles(7, fen.tile_from_str(src), fen.tile_from_str(dst))
        states, info = step(states, jnp.asarray([aid], jnp.int32))
        game = assert_step_matches(logic, 7, game, aid, states, info, 0, mv)
        assert bool(states.terminated[0]) == (i == len(moves) - 1), mv
    assert int(states.result[0]) == WIN_DEFENDER
    assert int(states.reason[0]) == int(WinReason.REPETITION)
