"""Capture a jax.profiler trace of one chunked MCTS search on the GPU, to
attribute the wave cost by kernel.

Run from the repo root; writes the trace under traces/wave:

    python scripts/profile_wave.py --batch 1024 --sims 800 --children 128 \
        --chunk 100
"""

import argparse
import time

import numpy as np
import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.models.network import init_params, make_network
from alphazeroforhnefatafl_tpu.search.mcts import MCTS, MCTSConfig


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--sims", type=int, default=800)
    p.add_argument("--children", type=int, default=128)
    p.add_argument("--chunk", type=int, default=100)
    p.add_argument("--leaves", type=int, default=1)
    p.add_argument("--trace-dir", default="traces/wave")
    a = p.parse_args()

    env = make_env("copenhagen")
    net = make_network(env.n, channels=64, blocks=6)
    params = init_params(net, jax.random.PRNGKey(0), env.num_observation_planes)
    mcts = MCTS(
        env,
        lambda p_, obs: net.apply(p_, obs),
        MCTSConfig(
            num_simulations=a.sims, max_children=a.children, dirichlet_eps=0.0,
            leaves_per_wave=a.leaves,
        ),
    )
    state = env.reset_batch(a.batch)
    legal = jax.jit(jax.vmap(env.legal_mask))(state)

    def run(rng):
        res = mcts.search_in_chunks(
            params, state, legal, rng, add_noise=False, chunk=a.chunk
        )
        return jnp.sum(res.root_visits) + jnp.sum(res.action_probs)

    # Warm (compile) outside the trace.
    np.asarray(run(jax.random.PRNGKey(1)))
    t0 = time.perf_counter()
    # Perfetto trace: a trace.json.gz we can parse directly (gzip+json),
    # no TensorBoard round-trip needed for op attribution.
    with jax.profiler.trace(a.trace_dir, create_perfetto_trace=True):
        np.asarray(run(jax.random.PRNGKey(2)))
    print(
        f"traced one search in {time.perf_counter() - t0:.2f}s -> {a.trace_dir}"
    )


if __name__ == "__main__":
    main()
