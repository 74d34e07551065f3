"""Checks that only an NVIDIA GPU can run: the compiled GPU programs against
the same programs on the CPU backend of the same process.

They skip elsewhere (the ``gpu`` fixture decides, at run time);
``python -m pytest -m gpu tests/test_gpu.py`` runs them on the card, and
``chip_smoke.py`` runs them as its last phase.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.core.rules import CELL_ATT, CELL_DEF, CELL_KING, EMPTY
from alphazeroforhnefatafl_tpu.models.network import make_network


def dense_boards(rng, n: int, count: int) -> np.ndarray:
    """Random positions with one king and 15-40% piece density; corners
    and throne empty unless the king stands on the throne. (Self-contained:
    this module also runs inside chip_smoke.py's process, where ``tests``
    need not be importable as a package.)"""
    boards = np.zeros((count, n, n), np.int8)
    for board in boards:
        cells = rng.rand(n, n) < rng.uniform(0.15, 0.4)
        attacker = rng.rand(n, n) < 0.5
        board[cells & attacker] = CELL_ATT
        board[cells & ~attacker] = CELL_DEF
        for r, c in [(0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1), (n // 2, n // 2)]:
            board[r, c] = EMPTY
        empties = np.argwhere(board == EMPTY)
        kr, kc = empties[rng.randint(len(empties))]
        board[kr, kc] = CELL_KING
    return boards


@pytest.mark.gpu
def test_step_many_gpu_matches_cpu(gpu):
    """The env step is integer arithmetic: the GPU program must reproduce
    the CPU program bit for bit, on dense boards where captures, shieldwalls
    and flood-fill outcomes fire often."""
    env = make_env("copenhagen")
    cpu = jax.devices("cpu")[0]
    rng = np.random.RandomState(0)
    B = 512
    boards = dense_boards(rng, env.n, B)
    states = env.reset_batch(B).replace(
        board=jnp.asarray(boards, jnp.int8),
        side_to_play=jnp.asarray(rng.randint(0, 2, B), jnp.int32),
    )
    step = jax.jit(env.step_many)
    masks = np.asarray(jax.jit(env.legal_mask_many)(jax.device_put(states, cpu)))
    actions = np.asarray(
        [rng.choice(np.nonzero(m)[0]) if m.any() else 0 for m in masks], np.int32
    )
    want = step(jax.device_put(states, cpu), jax.device_put(actions, cpu))
    got = step(jax.device_put(states, gpu), jax.device_put(actions, gpu))
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
def test_flagship_forward_gpu_matches_f32_cpu(gpu):
    """The bf16 flagship forward on the GPU against the float32 forward on
    the CPU at the highest matmul precision. bf16 keeps 8 mantissa bits:
    the logits drift by ~1.3% of their norm through the trunk, and the f32
    value head scales that drift by its pre-tanh magnitude (the tolerances
    of chip_smoke.py's net phase)."""
    env = make_env("copenhagen")
    net = make_network(env.n, channels=64, blocks=6)
    params = net.init(jax.random.PRNGKey(0), env.num_observation_planes)
    params["value"]["fc2"]["kernel"] = jax.random.normal(
        jax.random.PRNGKey(1), params["value"]["fc2"]["kernel"].shape
    ) / np.sqrt(net.value_hidden)
    rng = np.random.RandomState(1)
    boards = dense_boards(rng, env.n, 64)
    states = env.reset_batch(64).replace(board=jnp.asarray(boards, jnp.int8))
    obs = jax.vmap(env.observe)(states)
    cpu = jax.devices("cpu")[0]
    logits, value = jax.jit(net.apply)(jax.device_put(params, gpu), jax.device_put(obs, gpu))
    ref = dataclasses.replace(net, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        ref_logits, ref_value = jax.jit(ref.apply)(
            jax.device_put(params, cpu), jax.device_put(obs, cpu)
        )
    logits, ref_logits = np.asarray(logits), np.asarray(ref_logits)
    rel = np.linalg.norm(logits - ref_logits) / np.linalg.norm(ref_logits)
    assert rel <= 2e-2
    assert np.max(np.abs(np.asarray(value) - np.asarray(ref_value))) <= 5e-2
