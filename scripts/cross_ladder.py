"""Cross-RUN Elo ladder: round-robin checkpoints from DIFFERENT runs plus a
fresh init and fixed net-free anchors, one Bradley-Terry fit.

    python scripts/cross_ladder.py \
        --entry r4_final=runs/copenhagen_r4/ckpt:107 \
        --entry gated=runs/cop_r5_gated/ckpt:latest \
        --anchors uniform,random --games 16 --sims 128

Every entry is ``name=ckpt_dir:step`` (``step`` = integer, ``latest`` or ``mid``);
all entries must share one net architecture (--channels/--blocks/--norm).
eval_run.py ladders WITHIN one run; this script is the cross-run/round
companion (VERDICT r2 #3: strength claims need fixed external anchors).
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
    p.add_argument("--entry", action="append", default=[],
                   help="name=ckpt_dir:step (step int, 'latest' or 'mid'); repeatable")
    p.add_argument("--preset", default="copenhagen")
    p.add_argument("--games", type=int, default=16)
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--children", type=int, default=32)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--norm", default="group", choices=["group", "none"])
    p.add_argument("--max-game-len", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-init", action="store_true",
                   help="skip the fresh-init entry")
    p.add_argument("--anchors", default="uniform,random",
                   help="comma-separated: uniform,material,random ('' = none)")
    p.add_argument("--out", default=None, help="write the JSON result here too")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    a = p.parse_args()
    if a.cpu:
        jax.config.update("jax_platforms", "cpu")
    env = make_env(a.preset)
    net = make_network(env.n, channels=a.channels, blocks=a.blocks, norm=a.norm)
    base = init_train_state(
        net, jax.random.PRNGKey(0), env.num_observation_planes, make_optimizer()
    )
    named = [] if a.no_init else [("init", base.params)]
    for spec in a.entry:
        name, eq, loc = spec.partition("=")
        ckpt_dir, colon, step = loc.rpartition(":")
        if not (eq and colon and name and ckpt_dir and step):
            p.error(
                f"--entry {spec!r}: expected name=ckpt_dir:step "
                "(step = integer, 'latest' or 'mid')"
            )
        mgr = CheckpointManager(ckpt_dir)
        if step == "latest":
            it = mgr.latest_iteration()
        elif step == "mid":
            steps = mgr.all_iterations()
            it = steps[len(steps) // 2]
        else:
            it = int(step)
        _, ts, _, _ = mgr.restore(base, None, iteration=it)
        named.append((name, ts.params))
        print(f"loaded {name} <- {ckpt_dir}:{it}", file=sys.stderr)

    anchors = [s for s in a.anchors.split(",") if s]
    if anchors:
        from alphazeroforhnefatafl_tpu.train.anchors import (
            ANCHOR_CODES,
            ANCHOR_NET,
            anchor_params,
            make_anchored_evaluate,
        )

        named = [(n, anchor_params(p_, ANCHOR_NET)) for n, p_ in named]
        named += [
            (f"anchor_{n}", anchor_params(base.params, ANCHOR_CODES[n]))
            for n in anchors
        ]
        evaluate = make_anchored_evaluate(lambda p_, obs: net.apply(p_, obs), env)
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
    out = {
        "ratings": {k: round(float(v), 1) for k, v in ratings.items()},
        "score_matrix": wins.tolist(),
        "games_matrix": games.tolist(),
        "config": {
            "games_per_pair": a.games, "sims": a.sims,
            "children": a.children, "max_game_len": a.max_game_len,
        },
    }
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
