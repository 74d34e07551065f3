"""AlphaZero learner: loss and data-parallel train step.

The reference has no training loop at all (SURVEY.md §5); this supplies the
learner half of the AlphaZero iteration. The loss is the standard AlphaZero
objective the reference's MCTS was built to consume (``src/mcts.py`` produces
visit-count policy targets and negamax values):

    L = CE(pi_target, policy_logits) + (z - v)^2   (+ weight decay via adamw)

Data parallelism is expressed with ``jax.sharding``: the batch is sharded
over the ``dp`` mesh axis, params are replicated, and XLA inserts the psum
gradient all-reduce, which runs as an NCCL all-reduce across GPUs — the
distributed learner the reference never had.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import optax

from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: jax.Array  # int32


@pytree_dataclass
class Batch:
    """One training batch of self-play positions."""

    obs: jax.Array  # f32[B, N, N, C]
    policy_target: jax.Array  # f32[B, A] (visit-count distribution, sums to 1)
    value_target: jax.Array  # f32[B] in [-1, 1], mover perspective
    legal_mask: jax.Array  # bool[B, A]


def make_optimizer(
    learning_rate: float = 2e-3, weight_decay: float = 1e-4, warmup_steps: int = 200
) -> optax.GradientTransformation:
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=learning_rate,
        warmup_steps=warmup_steps,
        decay_steps=200_000,
        end_value=learning_rate * 0.05,
    )
    return optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(schedule, weight_decay=weight_decay),
    )


def init_train_state(net, rng: jax.Array, num_planes: int, optimizer) -> TrainState:
    from ..models.network import init_params

    params = init_params(net, rng, num_planes)
    return TrainState(
        params=params, opt_state=optimizer.init(params), step=jnp.int32(0)
    )


def loss_fn(net, params, batch: Batch) -> Tuple[jax.Array, Dict[str, jax.Array]]:
    logits, value = net.apply(params, batch.obs)
    # Mask illegal actions out of the cross entropy: targets are zero there,
    # and masking keeps the normalizer consistent with play-time softmax.
    neg_inf = jnp.finfo(logits.dtype).min
    masked_logits = jnp.where(batch.legal_mask, logits, neg_inf)
    logp = jax.nn.log_softmax(masked_logits, axis=-1)
    policy_loss = -jnp.mean(
        jnp.sum(jnp.where(batch.legal_mask, batch.policy_target * logp, 0.0), axis=-1)
    )
    value_loss = jnp.mean((batch.value_target - value) ** 2)
    loss = policy_loss + value_loss
    metrics = {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "value_mean": jnp.mean(value),
    }
    return loss, metrics


def make_train_step(net, optimizer):
    """Build a pure ``(state, batch) -> (state, metrics)`` step.

    Shard the batch over a ``dp`` mesh axis and replicate params (see
    :mod:`alphazeroforhnefatafl_tpu.parallel.mesh`); jit then inserts the
    gradient all-reduce automatically.
    """

    def train_step(state: TrainState, batch: Batch):
        grad_fn = jax.value_and_grad(
            lambda p: loss_fn(net, p, batch), has_aux=True
        )
        (loss, metrics), grads = grad_fn(state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        metrics["grad_norm"] = optax.global_norm(grads)
        return (
            TrainState(params=params, opt_state=opt_state, step=state.step + 1),
            metrics,
        )

    return train_step
