"""The plain-JAX policy/value network: parameter shapes, GroupNorm, and the
bf16 forward against its float32 reference."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.models.network import (
    GROUPNORM_EPS,
    group_norm,
    make_network,
    net_flops_per_eval,
)


def test_flagship_param_shapes():
    """Copenhagen 64 channels / 6 GroupNorm blocks: every leaf's shape and
    the total count (the analytic FLOP count shares these dimensions)."""
    env = make_env("copenhagen")
    net = make_network(env.n, channels=64, blocks=6)
    params = net.init(jax.random.PRNGKey(0), env.num_observation_planes)
    c, p, n = 64, 4 * (env.n - 1), env.n
    assert params["stem"]["conv"]["kernel"].shape == (3, 3, 6, c)
    assert "bias" not in params["stem"]["conv"]
    assert len(params["blocks"]) == 6
    for blk in params["blocks"]:
        assert blk["conv1"]["kernel"].shape == (3, 3, c, c)
        assert blk["conv2"]["kernel"].shape == (3, 3, c, c)
        assert blk["norm1"]["scale"].shape == blk["norm2"]["bias"].shape == (c,)
    assert params["policy"]["out"]["kernel"].shape == (1, 1, c, p)
    assert params["value"]["fc1"]["kernel"].shape == (n * n * 8, 128)
    assert params["value"]["fc2"]["kernel"].shape == (128, 1)
    assert not np.any(np.asarray(params["value"]["fc2"]["kernel"]))
    total = sum(x.size for x in jax.tree_util.tree_leaves(params))
    convs = 3 * 3 * 6 * c + 6 * 2 * 9 * c * c + 9 * c * c + c * p + p + c * 8 + 8
    norms = 2 * c * (1 + 12 + 1)
    dense = n * n * 8 * 128 + 128 + 128 + 1
    assert total == convs + norms + dense
    assert net_flops_per_eval(n, 6, 64, 6) == pytest.approx(117_801_984.0)


def test_norm_free_params_and_validation():
    net = make_network(7, channels=8, blocks=2, norm="none")
    params = net.init(jax.random.PRNGKey(0), 6)
    assert all(not np.any(np.asarray(b["skip_gain"])) for b in params["blocks"])
    assert "bias" in params["stem"]["conv"] and "norm" not in params["stem"]
    with pytest.raises(ValueError):
        make_network(7, norm="batch")


def test_group_norm_matches_numpy():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 5, 12).astype(np.float32) * 3 + 1
    p = {"scale": rng.rand(12).astype(np.float32), "bias": rng.randn(12).astype(np.float32)}
    groups = 4
    got = np.asarray(group_norm(jnp.asarray(x), p, groups))
    xg = x.astype(np.float64).reshape(3, 5, 5, groups, 3)
    mean = xg.mean(axis=(1, 2, 4), keepdims=True)
    var = xg.var(axis=(1, 2, 4), keepdims=True)
    want = ((xg - mean) / np.sqrt(var + GROUPNORM_EPS)).reshape(x.shape)
    want = want * p["scale"] + p["bias"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm", ["group", "none"])
def test_bf16_forward_matches_f32_reference(norm):
    """bf16 compute against the same params in float32 at the highest
    matmul precision: bf16 keeps 8 mantissa bits, so a small trunk's logits
    agree to ~1% of their norm."""
    env = make_env("brandubh")
    net = make_network(env.n, channels=16, blocks=2, norm=norm)
    params = net.init(jax.random.PRNGKey(0), env.num_observation_planes)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(1), x.shape), params
    )
    obs = jax.random.uniform(jax.random.PRNGKey(2), (8, env.n, env.n, 6))
    logits, value = jax.jit(net.apply)(params, obs)
    assert logits.shape == (8, env.num_actions) and value.shape == (8,)
    assert logits.dtype == jnp.float32 and value.dtype == jnp.float32
    ref = dataclasses.replace(net, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        rl, rv = jax.jit(ref.apply)(params, obs)
    rel = np.linalg.norm(np.asarray(logits - rl)) / np.linalg.norm(np.asarray(rl))
    assert 0 < rel <= 2e-2
    assert np.max(np.abs(np.asarray(value - rv))) <= 5e-2
