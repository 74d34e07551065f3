"""Learning-curve ladder over a run's retained checkpoints.

    python scripts/eval_run.py \
        --ckpt runs/copenhagen_r4/keep --games 24 --sims 128

Restores every step directory under --ckpt (params-only), skipping any that
fail to restore (e.g. checkpoints from a differently-configured writer),
then round-robins them plus a fresh init and fits Bradley-Terry Elo.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.models.network import make_network
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu.train.arena import ladder
from alphazeroforhnefatafl_tpu.train.checkpoint import CheckpointManager
from alphazeroforhnefatafl_tpu.train.learner import init_train_state, make_optimizer


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--preset", default="copenhagen")
    p.add_argument("--games", type=int, default=24)
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--children", type=int, default=32)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--norm", default="group", choices=["group", "none"])
    p.add_argument("--max-steps", type=int, default=8,
                   help="ladder size: evenly-spaced steps across the run")
    p.add_argument("--max-game-len", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument(
        "--anchors",
        default="",
        help="comma-separated net-free anchors to ladder alongside the "
        "checkpoints: uniform,material,random (train/anchors.py). Fixed "
        "external reference points, comparable across runs/rounds.",
    )
    a = p.parse_args()
    if a.cpu:
        jax.config.update("jax_platforms", "cpu")

    env = make_env(a.preset)
    net = make_network(env.n, channels=a.channels, blocks=a.blocks, norm=a.norm)
    opt = make_optimizer()
    base = init_train_state(
        net, jax.random.PRNGKey(0), env.num_observation_planes, opt
    )
    mgr = CheckpointManager(a.ckpt)
    steps = mgr.all_iterations()
    if len(steps) > a.max_steps:
        # Evenly spaced across the run, always including the last.
        import numpy as np

        idx = np.unique(
            np.round(np.linspace(0, len(steps) - 1, a.max_steps)).astype(int)
        )
        steps = [steps[i] for i in idx]
    named = [("init", base.params)]
    for s in steps:
        try:
            _, ts, _, _ = mgr.restore(base, None, iteration=s)
            named.append((f"iter{s:03d}", ts.params))
        except Exception as e:  # skip foreign/corrupt steps
            print(f"skip step {s}: {type(e).__name__}", file=sys.stderr)

    if a.anchors:
        from alphazeroforhnefatafl_tpu.train.anchors import (
            ANCHOR_CODES,
            ANCHOR_NET,
            anchor_params,
            make_anchored_evaluate,
        )

        # Wrap every entry so anchors and checkpoints share one pytree shape.
        named = [(n, anchor_params(p_, ANCHOR_NET)) for n, p_ in named]
        for name in a.anchors.split(","):
            named.append(
                (f"anchor_{name}", anchor_params(base.params, ANCHOR_CODES[name]))
            )
        evaluate = make_anchored_evaluate(
            lambda p_, obs: net.apply(p_, obs), env
        )
    else:
        evaluate = jax.jit(lambda p_, obs: net.apply(p_, obs))
    print(f"laddering {[n for n, _ in named]}", file=sys.stderr)
    ratings, wins, games = ladder(
        env,
        evaluate,
        named,
        MCTSConfig(
            num_simulations=a.sims, max_children=a.children, dirichlet_eps=0.0
        ),
        games_per_pair=a.games,
        rng=jax.random.PRNGKey(a.seed),
        max_game_len=a.max_game_len,
    )
    if "anchor_uniform" in ratings:
        # Re-anchor the scale to the net-free uniform-prior MCTS: a fixed
        # external zero point, comparable across runs and rounds.
        shift = ratings["anchor_uniform"]
        ratings = {k: v - shift for k, v in ratings.items()}
    print(json.dumps({"ratings": ratings, "wins": wins.tolist()}))


if __name__ == "__main__":
    main()
