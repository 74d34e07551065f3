"""Benchmark of the tafl AlphaZero stack on one GPU.

Prints ONE JSON line::

    {"metric": "env_steps_per_sec_per_chip_11x11", "value": ..., "unit": ...,
     "vs_baseline": ..., "mcts_sims_per_s": ..., "mcts_sims_per_s_800": ...,
     "platform": ..., "device_kind": ..., "device_count": ..., "card": ...}

- ``value``: env steps/s — Copenhagen 11x11, 4,096 lockstep games, a
  random-legal policy with auto-reset, one jitted 32-step ``lax.scan`` of
  ``TaflEnv.step_many`` per call. ``vs_baseline`` divides it by a target of
  100k env steps/s.
- ``mcts_sims_per_s``: batched MCTS with the flagship 64-channel / 6-block
  net on 1,024 games, 128 simulations and 32 children per move, one leaf per
  wave, exact top-k (the self-play search). ``mcts_sims_per_s_800``: the
  same at 800 simulations and 128 children through ``search_in_chunks``.
- ``mfu_128`` / ``mfu_800``: NN-forward FLOP/s (one forward per simulation)
  over the bf16 peak of the card, from :data:`PEAKS`.

Every rate is best-of-N with the mean beside it, timed on the host clock
around calls that end in ``block_until_ready``; compilation is excluded and
reported as ``compile_s``. Without a GPU the script exits non-zero, unless
the CPU was asked for explicitly (``JAX_PLATFORMS=cpu``): then it runs a
small rehearsal whose line says ``"platform": "cpu"`` and carries no MFU or
peak fields.
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.models.network import (
    init_params,
    make_network,
    net_flops_per_eval,
)
from alphazeroforhnefatafl_tpu.search.mcts import MCTS, MCTSConfig
from alphazeroforhnefatafl_tpu.utils.compile_cache import enable_compile_cache

TARGET_STEPS_PER_S = 100_000.0

#: Published dense peaks per ``device_kind`` (NVIDIA H100 SXM data sheet:
#: 989 TFLOP/s bf16 without sparsity, 3.35 TB/s HBM3), at the card's full
#: 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_kind: str) -> dict:
    """The peak table's entry for ``device_kind``; an unknown kind raises."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add it to "
            f"bench.PEAKS with its source"
        )
    return PEAKS[device_kind]


def card_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout
    return out.strip().splitlines()[0]


def build_rollout(env, batch: int, chunk: int, record: int = 0):
    """Jitted ``(state, mask, rng) -> (state, mask, rng, dones, trace)``:
    ``chunk`` random-legal steps of ``batch`` games with auto-reset.

    ``trace`` holds, for the first ``record`` games and every step, the
    action, the post-step board, result and reason, and the next player's
    legal mask (before any auto-reset) — what a move-by-move replay on the
    oracle compares. It is empty when ``record`` is 0.
    """

    def policy_step(carry, _):
        # The legal mask is carried from the previous step's info — the env
        # already computes the next player's mask for the NoPlays outcome
        # check, so recomputing it here would double the ray-scan work.
        state, mask, rng = carry
        rng, k = jax.random.split(rng)
        noise = jax.random.uniform(k, mask.shape, dtype=jnp.float32)
        action = jnp.argmax(mask * noise, axis=-1).astype(jnp.int32)
        state, info = env.step_many(state, action)
        trace = {}
        if record:
            trace = dict(
                action=action[:record],
                board=state.board[:record],
                result=state.result[:record],
                reason=state.reason[:record],
                legal=info.legal_mask[:record],
            )
        # Auto-reset finished games so the batch stays saturated.
        fresh = env.reset_batch(batch)
        fresh_mask = jax.vmap(env.legal_mask)(fresh)
        done = state.terminated

        def where_done(f, c):
            d = done.reshape(done.shape + (1,) * (c.ndim - 1))
            return jnp.where(d, f, c)

        state = jax.tree_util.tree_map(where_done, fresh, state)
        mask = jnp.where(done[:, None], fresh_mask, info.legal_mask)
        return (state, mask, rng), (info.terminated.sum(), trace)

    def rollout(state, mask, rng):
        (state, mask, rng), (dones, trace) = jax.lax.scan(
            policy_step, (state, mask, rng), None, length=chunk
        )
        return state, mask, rng, dones.sum(), trace

    return jax.jit(rollout)


def _timed(fn, iters: int):
    """(compile_s, [per-call seconds]) of ``fn()``, each call synced."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return compile_s, times


def bench_env(batch: int, chunk: int, iters: int) -> dict:
    env = make_env("copenhagen")
    rollout = build_rollout(env, batch, chunk)
    carry = [env.reset_batch(batch), None, jax.random.PRNGKey(0)]
    carry[1] = jax.jit(jax.vmap(env.legal_mask))(carry[0])

    def call():
        state, mask, rng, dones, _ = rollout(*carry)
        carry[:] = [state, mask, rng]
        return dones

    compile_s, times = _timed(call, iters)
    steps = batch * chunk
    return {
        "metric": "env_steps_per_sec_per_chip_11x11",
        "value": steps / min(times),
        "unit": "steps/s",
        "vs_baseline": steps / min(times) / TARGET_STEPS_PER_S,
        "mean_value": steps * len(times) / sum(times),
        "env_config": f"b{batch}_scan{chunk}",
        "timing": f"best_of_{iters}_calls_block_until_ready",
        "env_compile_s": compile_s,
    }


def bench_mcts(batch, sims, children, iters, chunk=0) -> tuple:
    """(compile_s, best sims/s, mean sims/s) of one batched search of the
    flagship net at ``sims`` simulations, one leaf per wave."""
    env = make_env("copenhagen")
    net = make_network(env.n, channels=64, blocks=6)
    params = init_params(net, jax.random.PRNGKey(0), env.num_observation_planes)
    mcts = MCTS(
        env,
        net.apply,
        MCTSConfig(num_simulations=sims, max_children=children, dirichlet_eps=0.0),
    )
    state = env.reset_batch(batch)
    legal = jax.jit(env.legal_mask_many)(state)
    rngs = iter(jax.random.split(jax.random.PRNGKey(1), iters + 1))
    if chunk:
        run = lambda: mcts.search_in_chunks(
            params, state, legal, next(rngs), add_noise=False, chunk=chunk
        ).root_visits
    else:
        search = jax.jit(
            lambda p, s, l, r: mcts.search(p, s, l, r, add_noise=False).root_visits
        )
        run = lambda: search(params, state, legal, next(rngs))
    compile_s, times = _timed(run, iters)
    return (
        compile_s,
        batch * sims / min(times),
        batch * sims * len(times) / sum(times),
    )


def main() -> int:
    enable_compile_cache()
    dev = jax.devices()[0]
    rehearsal = jax.config.jax_platforms == "cpu"
    if dev.platform != "gpu" and not rehearsal:
        print(
            f"bench.py needs a GPU; JAX found {dev.platform!r} "
            "(set JAX_PLATFORMS=cpu for a CPU rehearsal)",
            file=sys.stderr,
        )
        return 1
    device = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    if rehearsal:
        rec = bench_env(batch=256, chunk=8, iters=2)
        c, best, mean = bench_mcts(16, 16, 16, iters=1)
        rec.update(
            mcts_sims_per_s=best,
            mcts_sims_per_s_mean=mean,
            mcts_config="b16_s16_k16_L1_exact",
            mcts_compile_s=c,
        )
        rec.update(device)
        print(json.dumps(rec), flush=True)
        return 0

    peaks = peaks_for(dev.device_kind)
    card = card_name_and_power_limit()
    rec = bench_env(batch=4096, chunk=32, iters=8)
    c128, best128, mean128 = bench_mcts(1024, 128, 32, iters=3)
    c800, best800, mean800 = bench_mcts(1024, 800, 128, iters=2, chunk=100)
    env = make_env("copenhagen")
    flops = net_flops_per_eval(env.n, env.num_observation_planes, 64, 6)
    rec.update(
        mcts_sims_per_s=best128,
        mcts_sims_per_s_mean=mean128,
        mcts_config="b1024_s128_k32_L1_exact",
        mcts_compile_s=c128,
        mcts_sims_per_s_800=best800,
        mcts_sims_per_s_800_mean=mean800,
        mcts_config_800="b1024_s800_k128_c100_L1_exact",
        mcts_800_compile_s=c800,
        # One forward per simulation, so evals/s == sims/s; everything the
        # search spends beyond the forward (traversal, env steps, backup)
        # shows up as lost MFU.
        net_flops_per_eval=flops,
        mfu_128=best128 * flops / peaks["bf16_flops"],
        mfu_800=best800 * flops / peaks["bf16_flops"],
        peak_bf16_flops=peaks["bf16_flops"],
        card=card,
    )
    rec.update(device)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
