"""MCTS throughput bench: simulations/s on 11x11 Copenhagen (BASELINE.md
config 4). Run from the repo root. One JSON line per configuration.

Each search is timed on the host clock around a call that ends in a
host-fetched checksum of its outputs (one call = num_sims waves).
"""

import argparse
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.models.network import init_params, make_network
from alphazeroforhnefatafl_tpu.search.mcts import MCTS, MCTSConfig


def bench(batch: int, sims: int, children: int, iters: int, channels=64, blocks=6,
          chunk=0, node_read="auto", unroll=4, norm="group", leaves=1,
          max_depth=64):
    env = make_env("copenhagen")
    net = make_network(env.n, channels=channels, blocks=blocks, norm=norm)
    params = init_params(net, jax.random.PRNGKey(0), env.num_observation_planes)
    evaluate = lambda p, obs: net.apply(p, obs)
    cfg = MCTSConfig(
        num_simulations=sims, max_children=children, dirichlet_eps=0.0,
        node_read=node_read, traverse_unroll=unroll, leaves_per_wave=leaves,
        max_depth=max_depth,
    )
    mcts = MCTS(env, evaluate, cfg)

    state = env.reset_batch(batch)
    legal = jax.jit(jax.vmap(env.legal_mask))(state)

    if chunk:
        def run(params, state, legal, rng):
            res = mcts.search_in_chunks(
                params, state, legal, rng, add_noise=False, chunk=chunk
            )
            return (
                jnp.sum(res.root_visits)
                + jnp.sum(res.action_probs)
                + jnp.sum(res.root_value)
            )
    else:
        def run(params, state, legal, rng):
            res = mcts.search(params, state, legal, rng, add_noise=False)
            # Consume the outputs a real caller consumes; checksum forces sync.
            return (
                jnp.sum(res.root_visits)
                + jnp.sum(res.action_probs)
                + jnp.sum(res.root_value)
            )

        run = jax.jit(run)
    rng = jax.random.PRNGKey(1)

    t0 = time.perf_counter()
    np.asarray(run(params, state, legal, rng))
    compile_s = time.perf_counter() - t0

    # Time each search separately; report the fastest and the mean.
    per_iter = []
    for i in range(iters):
        rng, sub = jax.random.split(rng)
        t0 = time.perf_counter()
        np.asarray(run(params, state, legal, sub))
        per_iter.append(time.perf_counter() - t0)
    dt = min(per_iter)
    sims_per_s = batch * sims / dt
    print(
        json.dumps(
            {
                "metric": f"mcts_sims_per_s_11x11_b{batch}_s{sims}_k{children}"
                + (f"_c{chunk}" if chunk else "")
                + f"_{node_read}_u{unroll}"
                + (f"_L{leaves}" if leaves > 1 else "")
                + (f"_d{max_depth}" if max_depth != 64 else "")
                + ("_nf" if norm == "none" else ""),
                "value": round(sims_per_s, 1),
                "unit": "sims/s",
                "compile_s": round(compile_s, 1),
                "best_ms_per_search": round(dt * 1000, 1),
                "mean_ms_per_search": round(
                    sum(per_iter) / len(per_iter) * 1000, 1
                ),
                "iter_ms": [round(t * 1000, 1) for t in per_iter],
            }
        ),
        flush=True,
    )
    return sims_per_s


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--children", type=int, default=128)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--chunk", type=int, default=0,
                   help="use search_in_chunks with this wave-chunk size")
    p.add_argument("--node-read", default="auto", choices=["auto", "gather", "dot"])
    p.add_argument("--unroll", type=int, default=4,
                   help="traversal levels per while-loop iteration")
    p.add_argument("--norm", default="group", choices=["group", "none"],
                   help="'none' = norm-free NFResBlock trunk")
    p.add_argument("--leaves", type=int, default=1,
                   help="leaves per tree per wave (virtual-loss multi-leaf)")
    p.add_argument("--max-depth", type=int, default=64)
    a = p.parse_args()
    bench(a.batch, a.sims, a.children, a.iters, chunk=a.chunk,
          node_read=a.node_read, unroll=a.unroll, norm=a.norm,
          leaves=a.leaves, max_depth=a.max_depth)
