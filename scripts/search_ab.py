"""Search-config A/B arena: same net, two MCTSConfigs head-to-head.

Built for the round-5 question "does the multi-leaf search give up strength
for its speed?" — pits config A vs config B with one checkpoint via
train.arena.play_config_match (candidate = A).

    python scripts/search_ab.py \
        --ckpt runs/copenhagen_r4ab_puct/ckpt --games 64 --sims 128 \
        --a leaves=2 --b leaves=1
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
from alphazeroforhnefatafl_tpu.train.arena import play_config_match
from alphazeroforhnefatafl_tpu.train.checkpoint import CheckpointManager
from alphazeroforhnefatafl_tpu.train.learner import init_train_state, make_optimizer


def parse_cfg(spec: str, sims: int, children: int) -> MCTSConfig:
    kw = {}
    for part in filter(None, spec.split(",")):
        k, _, v = part.partition("=")
        kw[k] = v
    return MCTSConfig(
        num_simulations=sims,
        max_children=children,
        dirichlet_eps=0.0,
        leaves_per_wave=int(kw.pop("leaves", 1)),
        virtual_loss=float(kw.pop("vloss", 1.0)),
        **kw,
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--step", default="latest")
    p.add_argument("--games", type=int, default=64)
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--children", type=int, default=32)
    p.add_argument("--max-game-len", type=int, default=300)
    p.add_argument("--a", default="leaves=2")
    p.add_argument("--b", default="leaves=1")
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--norm", default="group", choices=["group", "none"])
    p.add_argument("--preset", default="copenhagen")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--cpu", action="store_true")
    a = p.parse_args()
    if a.cpu:
        jax.config.update("jax_platforms", "cpu")

    env = make_env(a.preset)
    net = make_network(env.n, channels=a.channels, blocks=a.blocks, norm=a.norm)
    base = init_train_state(
        net, jax.random.PRNGKey(0), env.num_observation_planes, make_optimizer()
    )
    mgr = CheckpointManager(a.ckpt)
    it = mgr.latest_iteration() if a.step == "latest" else int(a.step)
    _, ts, _, _ = mgr.restore(base, None, iteration=it)
    print(f"loaded {a.ckpt}:{it}", file=sys.stderr)

    res = play_config_match(
        env,
        jax.jit(lambda p_, obs: net.apply(p_, obs)),
        ts.params,
        ts.params,
        parse_cfg(a.a, a.sims, a.children),
        parse_cfg(a.b, a.sims, a.children),
        num_games=a.games,
        max_game_len=a.max_game_len,
        rng=jax.random.PRNGKey(a.seed),
    )
    out = {"a": a.a, "b": a.b, "sims": a.sims, "ckpt_step": it, **res.as_dict()}
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
