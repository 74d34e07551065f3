"""Policy/value networks for tafl AlphaZero.

The reference intended a libtorch NN backend (``tch = "0.18.1"`` in
``/root/reference/Cargo.toml:8``) behind the ``nnet.predict(board) ->
(policy, value)`` boundary of its MCTS (``src/mcts.py:85``) but contains zero
NN code; this module supplies that component as plain JAX: a frozen
description of the architecture, a nested dict of parameters
(:func:`init_params`), and a pure ``apply(params, obs)``.

- NHWC layout and bfloat16 compute (f32 params, f32 heads).
- GroupNorm instead of BatchNorm: stateless, so the apply function stays a
  pure ``params -> logits`` map under jit with no mutable batch stats.
- The policy head is a convolution to ``4*(N-1)`` move planes whose flatten
  order matches the action encoding (from-tile major, then direction, then
  distance — see :mod:`alphazeroforhnefatafl_tpu.core.actions`), keeping the
  whole policy in one fused reshape instead of a giant dense layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
from jax import lax

_lecun_normal = jax.nn.initializers.lecun_normal()
GROUPNORM_EPS = 1e-6


def _conv_params(rng, k: int, cin: int, cout: int, bias: bool) -> Dict[str, Any]:
    p = {"kernel": _lecun_normal(rng, (k, k, cin, cout), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((cout,), jnp.float32)
    return p


def _dense_params(rng, din: int, dout: int) -> Dict[str, Any]:
    return {
        "kernel": _lecun_normal(rng, (din, dout), jnp.float32),
        "bias": jnp.zeros((dout,), jnp.float32),
    }


def _norm_params(c: int) -> Dict[str, Any]:
    return {"scale": jnp.ones((c,), jnp.float32), "bias": jnp.zeros((c,), jnp.float32)}


def conv(x: jax.Array, p: Dict[str, Any], dtype) -> jax.Array:
    """'SAME' stride-1 NHWC convolution computed in ``dtype``."""
    y = lax.conv_general_dilated(
        x.astype(dtype),
        p["kernel"].astype(dtype),
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def group_norm(x: jax.Array, p: Dict[str, Any], groups: int) -> jax.Array:
    """GroupNorm over (H, W, channels-in-group) of an NHWC tensor.

    Statistics and the affine transform are computed in float32 whatever
    the input dtype; the result is cast back to it.
    """
    b, h, w, c = x.shape
    xf = x.astype(jnp.float32).reshape(b, h, w, groups, c // groups)
    mean = jnp.mean(xf, axis=(1, 2, 4), keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=(1, 2, 4), keepdims=True)
    y = ((xf - mean) * lax.rsqrt(var + GROUPNORM_EPS)).reshape(b, h, w, c)
    return (y * p["scale"] + p["bias"]).astype(x.dtype)


@dataclasses.dataclass(frozen=True)
class PolicyValueNet:
    """AlphaZero-style residual policy/value network.

    Input: ``float32[B, N, N, C_in]`` observation planes (``TaflEnv.observe``).
    Output: ``(policy_logits[B, A], value[B])`` with ``A = N*N*4*(N-1)`` and
    value in [-1, 1] from the perspective of the player to move (the negamax
    convention of the reference MCTS, ``src/mcts.py:67-69``).
    """

    board_size: int
    channels: int = 64
    blocks: int = 6
    value_hidden: int = 128
    #: Compute dtype of the trunk and the policy head's 3x3 conv; the final
    #: policy conv and the value head always run in float32.
    dtype: Any = jnp.bfloat16
    #: "group" (GroupNorm residual blocks) or "none" (norm-free SkipInit
    #: trunk, De & Smith 2020: pre-activation convs whose residual branch is
    #: scaled by a learnable scalar gain initialized at 0, so the network
    #: starts as the identity and needs no normalization).
    norm: str = "group"

    def __post_init__(self):
        if self.norm not in ("group", "none"):
            raise ValueError(f"norm={self.norm!r}; expected 'group' or 'none'")

    @property
    def groups(self) -> int:
        return min(32, self.channels)

    @property
    def move_planes(self) -> int:
        return 4 * (self.board_size - 1)

    def init(self, rng: jax.Array, num_planes: int) -> Dict[str, Any]:
        """Fresh parameters: lecun-normal kernels, zero biases, unit norm
        scales, zero SkipInit gains and a zero final value layer."""
        c, n = self.channels, self.board_size
        norm_free = self.norm == "none"
        keys = iter(jax.random.split(rng, 2 * self.blocks + 5))
        stem = {"conv": _conv_params(next(keys), 3, num_planes, c, bias=norm_free)}
        if not norm_free:
            stem["norm"] = _norm_params(c)
        blocks = []
        for _ in range(self.blocks):
            blk = {
                "conv1": _conv_params(next(keys), 3, c, c, bias=norm_free),
                "conv2": _conv_params(next(keys), 3, c, c, bias=norm_free),
            }
            if norm_free:
                blk["skip_gain"] = jnp.zeros((1,), jnp.float32)
            else:
                blk["norm1"] = _norm_params(c)
                blk["norm2"] = _norm_params(c)
            blocks.append(blk)
        policy = {
            # Bias only on the norm-free path: GroupNorm would cancel it.
            "conv": _conv_params(next(keys), 3, c, c, bias=norm_free),
            "out": _conv_params(next(keys), 1, c, self.move_planes, bias=True),
        }
        if not norm_free:
            policy["norm"] = _norm_params(c)
        value = {
            "conv": _conv_params(next(keys), 1, c, 8, bias=True),
            "fc1": _dense_params(next(keys), n * n * 8, self.value_hidden),
            # Zero final layer: the value starts at 0 (the draw value) for
            # every position instead of a random tanh output that the first
            # large updates can saturate.
            "fc2": {
                "kernel": jnp.zeros((self.value_hidden, 1), jnp.float32),
                "bias": jnp.zeros((1,), jnp.float32),
            },
        }
        return {"stem": stem, "blocks": blocks, "policy": policy, "value": value}

    def apply(self, params: Dict[str, Any], x: jax.Array) -> Tuple[jax.Array, jax.Array]:
        dt, g = self.dtype, self.groups
        relu = jax.nn.relu
        x = x.astype(dt)
        if self.norm == "none":
            x = conv(x, params["stem"]["conv"], dt)
            for blk in params["blocks"]:
                y = conv(relu(x), blk["conv1"], dt)
                y = conv(relu(y), blk["conv2"], dt)
                x = x + blk["skip_gain"].astype(dt) * y
            x = relu(x)
            p = relu(conv(x, params["policy"]["conv"], dt))
        else:
            x = relu(group_norm(conv(x, params["stem"]["conv"], dt), params["stem"]["norm"], g))
            for blk in params["blocks"]:
                y = relu(group_norm(conv(x, blk["conv1"], dt), blk["norm1"], g))
                y = group_norm(conv(y, blk["conv2"], dt), blk["norm2"], g)
                x = relu(x + y)
            pp = params["policy"]
            p = relu(group_norm(conv(x, pp["conv"], dt), pp["norm"], g))

        # Policy head: one output plane per (direction, distance) pair, in the
        # action-encoding order dir-major then distance.
        f32 = jnp.float32
        p = conv(p, params["policy"]["out"], f32)
        policy_logits = p.reshape(p.shape[0], -1)

        vp = params["value"]
        v = relu(conv(x.astype(f32), vp["conv"], f32))
        v = v.reshape(v.shape[0], -1)
        v = relu(v @ vp["fc1"]["kernel"] + vp["fc1"]["bias"])
        v = v @ vp["fc2"]["kernel"] + vp["fc2"]["bias"]
        return policy_logits, jnp.tanh(v)[:, 0]


def make_network(
    board_size: int, channels: int = 64, blocks: int = 6, norm: str = "group"
) -> PolicyValueNet:
    return PolicyValueNet(
        board_size=board_size, channels=channels, blocks=blocks, norm=norm
    )


def init_params(net: PolicyValueNet, rng: jax.Array, num_planes: int):
    return net.init(rng, num_planes)


def net_flops_per_eval(
    n: int, in_planes: int, channels: int, blocks: int, value_hidden: int = 128
) -> float:
    """Analytic forward-pass FLOPs of :class:`PolicyValueNet` (MACs x 2).

    Counts the conv/dense contractions (norms and elementwise are noise at
    these shapes); identical for the group-norm and norm-free trunks. Kept
    analytic so the figure is deterministic and independent of the
    compiler's cost model.
    """
    nn2 = n * n
    conv_f = lambda cin, cout, k: 2.0 * nn2 * cin * cout * k * k
    f = conv_f(in_planes, channels, 3)  # stem
    f += blocks * 2 * conv_f(channels, channels, 3)  # residual trunk
    f += conv_f(channels, channels, 3)  # policy head 3x3
    f += conv_f(channels, 4 * (n - 1), 1)  # policy head 1x1 -> move planes
    f += conv_f(channels, 8, 1)  # value head 1x1
    f += 2.0 * (nn2 * 8) * value_hidden + 2.0 * value_hidden  # dense stack
    return f
