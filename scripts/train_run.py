"""Long-form training driver: the full AlphaZero loop with every knob
exposed, metrics/checkpoints under runs/<name>/, and a wall-clock deadline
that stops cleanly (and resumably) at an iteration boundary.

Run from the repo root:

    python scripts/train_run.py --name copenhagen_r4 --hours 6 \
        --iterations 400 --games 256 --selfplay-batch 256 --sims 128 \
        --arena-games 64 --gumbel
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from alphazeroforhnefatafl_tpu.core.env import make_env
from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig
from alphazeroforhnefatafl_tpu.train.loop import LoopConfig, run_loop
from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayConfig
from alphazeroforhnefatafl_tpu.utils.compile_cache import enable_compile_cache
from alphazeroforhnefatafl_tpu.utils.metrics import MetricsLogger


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--name", required=True)
    p.add_argument("--preset", default="copenhagen")
    p.add_argument("--hours", type=float, default=None, help="wall-clock budget")
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--games", type=int, default=256, help="self-play games/iter")
    p.add_argument("--selfplay-batch", type=int, default=256)
    p.add_argument("--max-game-len", type=int, default=256)
    p.add_argument("--temp-threshold", type=int, default=12)
    p.add_argument("--resign", type=float, default=None,
                   help="resign threshold (e.g. 0.95); None disables")
    p.add_argument("--resign-min-moves", type=int, default=0,
                   help="no resignation before this many moves (guards the "
                        "instant-resign feedback collapse)")
    p.add_argument("--sims", type=int, default=128)
    p.add_argument("--search-chunk", type=int, default=0,
                   help=">0: chunk-compiled search (required for 800-sim "
                        "budgets; e.g. 100)")
    p.add_argument("--scan-moves", type=int, default=0,
                   help=">0: device-side episode accumulation — this many "
                        "moves per dispatch via lax.scan (on multi-device "
                        "meshes the whole scan runs inside one shard_map)")
    p.add_argument("--children", type=int, default=32)
    p.add_argument("--leaves", type=int, default=1,
                   help="MCTS leaves per tree per wave (virtual-loss "
                        "multi-leaf; must divide --sims)")
    p.add_argument("--gumbel", action="store_true", help="gumbel root selection")
    p.add_argument("--gumbel-considered", type=int, default=16)
    p.add_argument("--gumbel-sample-early", action="store_true",
                   help="draw-collapse mitigation: sample the improved "
                        "policy during the temperature phase instead of "
                        "always playing the halving winner")
    p.add_argument("--alpha-scale", type=float, default=None,
                   help="dirichlet alpha = scale / num_legal (puct only)")
    p.add_argument("--train-steps", type=int, default=160)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--min-replay", type=int, default=4096)
    p.add_argument("--replay-capacity", type=int, default=300_000)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--norm", default="group", choices=["group", "none"],
                   help="'none' = norm-free NFResBlock trunk")
    p.add_argument("--arena-games", type=int, default=64)
    p.add_argument("--arena-sims", type=int, default=64)
    p.add_argument("--arena-max-len", type=int, default=200)
    p.add_argument("--arena-every", type=int, default=1)
    p.add_argument("--gate", type=float, default=0.55)
    p.add_argument("--gate-on", default="score",
                   choices=["score", "decisive", "wilson"],
                   help="'decisive' gates on decisive-game win rate "
                        "(draw-robust); 'wilson' on its Wilson lower bound "
                        "at --gate-z (set --gate ~0.5 then)")
    p.add_argument("--gate-min-decisive", type=int, default=4)
    p.add_argument("--gate-z", type=float, default=1.0,
                   help="one-sided normal quantile for --gate-on wilson")
    p.add_argument("--checkpoint-every", type=int, default=2)
    p.add_argument("--checkpoint-keep", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = p.parse_args()
    enable_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    run_dir = os.path.join("runs", args.name)
    os.makedirs(run_dir, exist_ok=True)
    # .jsonl: one record appended per invocation (resumes included), so the
    # file is a history, not a single JSON document (advisor r4).
    with open(os.path.join(run_dir, "config.jsonl"), "a") as f:
        f.write(json.dumps(vars(args)) + "\n")

    env = make_env(args.preset)
    cfg = LoopConfig(
        preset=args.preset,
        iterations=args.iterations,
        games_per_iteration=args.games,
        train_steps_per_iteration=args.train_steps,
        train_batch_size=args.batch,
        min_replay_size=args.min_replay,
        replay_capacity=args.replay_capacity,
        learning_rate=args.lr,
        channels=args.channels,
        blocks=args.blocks,
        norm=args.norm,
        arena_games=args.arena_games,
        arena_sims=args.arena_sims,
        arena_max_game_len=args.arena_max_len,
        arena_every=args.arena_every,
        gate_threshold=args.gate,
        gate_on=args.gate_on,
        gate_min_decisive=args.gate_min_decisive,
        gate_z=args.gate_z,
        checkpoint_dir=os.path.join(run_dir, "ckpt"),
        checkpoint_every=args.checkpoint_every,
        checkpoint_keep=args.checkpoint_keep,
        seed=args.seed,
        mcts=MCTSConfig(
            num_simulations=args.sims,
            max_children=args.children,
            root_selection="gumbel" if args.gumbel else "puct",
            gumbel_considered=args.gumbel_considered,
            dirichlet_alpha_scale=args.alpha_scale,
            leaves_per_wave=args.leaves,
        ),
        selfplay=SelfPlayConfig(
            batch_size=args.selfplay_batch,
            temp_threshold=args.temp_threshold,
            max_game_len=args.max_game_len,
            resign_threshold=args.resign,
            resign_min_moves=args.resign_min_moves,
            search_chunk=args.search_chunk,
            scan_moves=args.scan_moves,
            gumbel_sample_temp_moves=args.gumbel_sample_early,
        ),
    )
    deadline = time.time() + args.hours * 3600 if args.hours else None
    log = MetricsLogger(jsonl_path=os.path.join(run_dir, "metrics.jsonl"))
    state = run_loop(env, cfg, log=log, deadline=deadline)
    print(f"done: step={int(state.step)}")


if __name__ == "__main__":
    main()
