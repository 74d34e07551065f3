"""The batched root legal mask, ``TaflEnv.legal_mask_many`` (``vmap`` of the
ray scan), against the oracle's legal plays on random boards: every preset,
the start positions, and the reference's 15x15 and 21x21 board sizes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core import fen
from alphazeroforhnefatafl_tpu.core.env import TaflEnv, make_env
from alphazeroforhnefatafl_tpu.core.oracle import GameLogic, GameState
from alphazeroforhnefatafl_tpu.core.rules import (
    CELL_ATT,
    CELL_DEF,
    CELL_KING,
    EMPTY,
    PRESETS,
    Side,
)
from tests.test_env_differential import oracle_legal_action_mask


def random_boards(rng, n, B):
    boards = np.zeros((B, n, n), np.int8)
    for b in range(B):
        density = rng.uniform(0.1, 0.45)
        cells = rng.rand(n, n) < density
        sides_r = rng.rand(n, n) < 0.5
        boards[b][cells & sides_r] = CELL_ATT
        boards[b][cells & ~sides_r] = CELL_DEF
        for rc in [(0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1), (n // 2, n // 2)]:
            boards[b][rc] = EMPTY
        empt = np.argwhere(boards[b] == EMPTY)
        kr, kc = empt[rng.randint(len(empt))]
        boards[b][kr, kc] = CELL_KING
    return boards


def assert_masks_match_oracle(env, rules, boards, sides):
    states = env.reset_batch(len(boards)).replace(
        board=jnp.asarray(boards, jnp.int8), side_to_play=jnp.asarray(sides, jnp.int32)
    )
    got = np.asarray(jax.jit(env.legal_mask_many)(states))
    logic = GameLogic(rules, env.n)
    for b, (board, side) in enumerate(zip(boards, sides)):
        ostate = GameState.from_fen(fen.board_to_fen(board), Side(int(side)))
        want = oracle_legal_action_mask(logic, ostate)
        diff = np.nonzero(want != got[b])[0]
        assert not diff.size, (
            f"board {b} side {int(side)}: actions {diff[:10]} differ on\n"
            f"{fen.board_to_display_str(board)}"
        )


@pytest.mark.parametrize("preset", ["copenhagen", "brandubh", "tablut", "magpie"])
def test_batched_legal_mask_matches_oracle(preset):
    env = make_env(preset)
    rng = np.random.RandomState(42)
    B = 7
    boards = random_boards(rng, env.n, B)
    sides = rng.randint(0, 2, size=B).astype(np.int32)
    assert_masks_match_oracle(env, PRESETS[preset][0], boards, sides)


def test_batched_legal_mask_start_positions():
    rules, start = PRESETS["copenhagen"]
    env = make_env("copenhagen")
    B = 5
    boards = np.stack([fen.board_from_fen(start)] * B)
    sides = np.asarray([0, 1, 0, 1, 0], np.int32)
    assert_masks_match_oracle(env, rules, boards, sides)


@pytest.mark.parametrize("n", [15, 21])
def test_batched_legal_mask_large_boards(n):
    """The reference's Large/Huge board sizes (game/game/mod.rs:119-125)."""
    rules = PRESETS["copenhagen"][0]
    env = TaflEnv(rules, fen.board_to_fen(np.zeros((n, n), np.int8)))
    rng = np.random.RandomState(n)
    B = 3
    boards = random_boards(rng, n, B)
    sides = rng.randint(0, 2, size=B).astype(np.int32)
    assert_masks_match_oracle(env, rules, boards, sides)
