"""Command-line interface.

The L3 application layer. ``play`` is the successor of the reference's
interactive demo loop (``/root/reference/game/main.rs:135-162``): print the
board, prompt for a move like ``a8-a11``, apply it, report the outcome —
plus an optional MCTS opponent the reference never had. ``selfplay``,
``train`` and ``bench`` drive the AlphaZero stack.

Usage::

    python -m alphazeroforhnefatafl_tpu.cli play --preset brandubh
    python -m alphazeroforhnefatafl_tpu.cli selfplay --preset brandubh --games 8
    python -m alphazeroforhnefatafl_tpu.cli train --preset brandubh --iterations 3
    python -m alphazeroforhnefatafl_tpu.cli bench
"""

from __future__ import annotations

import argparse
import sys


def _add_common(p):
    from .core.rules import PRESETS

    p.add_argument(
        "--preset",
        default="brandubh",
        choices=sorted(PRESETS.keys()),
        help="ruleset preset name",
    )
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--seed", type=int, default=0)


def _maybe_cpu(args):
    if getattr(args, "cpu", False):
        import jax

        jax.config.update("jax_platforms", "cpu")


def cmd_play(args):
    _maybe_cpu(args)
    from .core import fen
    from .core.oracle import Game, InvalidPlayError, Play
    from .core.rules import PRESETS, Side

    rules, board = PRESETS[args.preset]
    game = Game(rules, board)
    mcts_side = None
    if args.ai is not None:
        mcts_side = Side.ATTACKER if args.ai == "attacker" else Side.DEFENDER
        ai = _make_ai(args)

    print(f"alphazeroforhnefatafl: {args.preset}")
    while True:
        print("Board:")
        print(fen.board_to_display_str(game.state.board))
        print(f"{game.state.side_to_play.name.title()} to play.")
        if mcts_side is not None and game.state.side_to_play == mcts_side:
            mv = ai(game)
            print(f"AI plays {mv}")
            outcome = game.do_play(mv)
        else:
            try:
                line = input("Please enter your move: ").strip()
            except EOFError:
                return
            if line in ("quit", "exit"):
                return
            if line == "undo":
                game.undo_last_play()
                continue
            try:
                play = Play.from_str(line)
            except Exception as e:
                print(f"Invalid move ({e}). Try again.")
                continue
            try:
                outcome = game.do_play(play)
            except InvalidPlayError as e:
                print(f"Invalid move ({e.reason.name}). Try again.")
                continue
        if outcome is not None:
            if outcome.winner is None:
                print(f"Game over. Draw ({outcome.draw_reason.name}).")
            else:
                print(
                    f"Game over. Winner is {outcome.winner.name.title()} "
                    f"({outcome.win_reason.name})."
                )
            print("Final board:")
            print(fen.board_to_display_str(game.state.board))
            return


def _make_ai(args):
    """Build an MCTS move chooser over the oracle game (host-side play)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from .core import actions as A
    from .core.env import TaflEnv
    from .core.oracle import Play
    from .core.rules import PRESETS
    from .models.network import make_network, init_params
    from .search.mcts import MCTS, MCTSConfig

    rules, board = PRESETS[args.preset]
    env = TaflEnv(rules, board)
    net = make_network(env.n, channels=32, blocks=3)
    params = init_params(net, jax.random.PRNGKey(args.seed), env.num_observation_planes)
    mcts = MCTS(
        env,
        jax.jit(lambda p, o: net.apply(p, o)),
        MCTSConfig(num_simulations=args.sims, dirichlet_eps=0.0),
    )
    search = jax.jit(lambda s, l, r: mcts.search(params, s, l, r, add_noise=False))
    rng_holder = [jax.random.PRNGKey(args.seed)]

    def choose(game) -> Play:
        s = env.reset().replace(
            board=jnp.asarray(game.state.board, jnp.int8),
            side_to_play=jnp.int32(int(game.state.side_to_play)),
        )
        batch = jax.tree_util.tree_map(lambda x: x[None], s)
        legal = jax.vmap(env.legal_mask)(batch)
        rng_holder[0], sub = jax.random.split(rng_holder[0])
        result = search(batch, legal, sub)
        action = int(np.asarray(result.action_probs)[0].argmax())
        src, dst = A.decode_to_tiles(env.n, action)
        return Play.from_tiles(src, dst)

    return choose


def cmd_selfplay(args):
    _maybe_cpu(args)
    import jax

    from .core.env import make_env
    from .models.network import make_network, init_params
    from .search.mcts import MCTSConfig
    from .train.replay import ReplayBuffer
    from .train.selfplay import SelfPlayActor, SelfPlayConfig

    env = make_env(args.preset)
    net = make_network(
        env.n, channels=args.channels, blocks=args.blocks, norm=args.norm
    )
    params = init_params(net, jax.random.PRNGKey(args.seed), env.num_observation_planes)
    sp_cfg = SelfPlayConfig(batch_size=args.batch)
    actor = SelfPlayActor(
        env,
        jax.jit(lambda p, o: net.apply(p, o)),
        MCTSConfig(num_simulations=args.sims),
        sp_cfg,
    )
    replay = ReplayBuffer(env, 100_000, sp_cfg.policy_k)
    import time

    t0 = time.perf_counter()
    stats = actor.play(params, replay, jax.random.PRNGKey(args.seed), args.games)
    dt = time.perf_counter() - t0
    d = stats.as_dict()
    d["wall_s"] = round(dt, 2)
    d["games_per_hour"] = round(stats.games / dt * 3600, 1)
    import json

    print(json.dumps(d, indent=2))


def cmd_train(args):
    _maybe_cpu(args)
    from .core.env import make_env
    from .search.mcts import MCTSConfig
    from .train.loop import LoopConfig, run_loop
    from .train.selfplay import SelfPlayConfig

    env = make_env(args.preset)
    cfg = LoopConfig(
        preset=args.preset,
        iterations=args.iterations,
        games_per_iteration=args.games,
        train_steps_per_iteration=args.train_steps,
        train_batch_size=args.batch,
        min_replay_size=args.min_replay,
        channels=args.channels,
        blocks=args.blocks,
        norm=args.norm,
        arena_games=args.arena_games,
        checkpoint_dir=args.checkpoint_dir,
        seed=args.seed,
        mcts=MCTSConfig(
            num_simulations=args.sims,
            root_selection="gumbel" if args.gumbel else "puct",
            dirichlet_alpha_scale=args.alpha_scale,
        ),
        selfplay=SelfPlayConfig(batch_size=args.selfplay_batch),
    )
    run_loop(env, cfg)


def cmd_bench(args):
    _maybe_cpu(args)
    import bench

    return bench.main()


def cmd_ladder(args):
    """Round-robin the checkpoints in a run directory and fit Elo ratings."""
    _maybe_cpu(args)
    import json

    import jax

    from .core.env import make_env
    from .models.network import make_network
    from .search.mcts import MCTSConfig
    from .train.arena import ladder
    from .train.checkpoint import CheckpointManager
    from .train.learner import init_train_state, make_optimizer

    env = make_env(args.preset)
    net = make_network(
        env.n, channels=args.channels, blocks=args.blocks, norm=args.norm
    )
    opt = make_optimizer()
    base = init_train_state(
        net, jax.random.PRNGKey(0), env.num_observation_planes, opt
    )
    mgr = CheckpointManager(args.ckpt)
    steps = mgr.all_iterations()
    named = [("init", base.params)]
    for s in steps:
        _, ts, _, _ = mgr.restore(base, None, iteration=s)
        named.append((f"iter{s}", ts.params))
    evaluate = jax.jit(lambda p, obs: net.apply(p, obs))
    ratings, wins, games = ladder(
        env,
        evaluate,
        named,
        MCTSConfig(num_simulations=args.sims, max_children=32, dirichlet_eps=0.0),
        games_per_pair=args.games,
    )
    print(json.dumps({"ratings": ratings}, indent=2))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="alphazeroforhnefatafl_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("play", help="interactive game (reference demo successor)")
    _add_common(p)
    p.add_argument("--ai", choices=["attacker", "defender"], default=None)
    p.add_argument("--sims", type=int, default=64)
    p.set_defaults(fn=cmd_play)

    p = sub.add_parser("selfplay", help="run self-play games")
    _add_common(p)
    p.add_argument("--games", type=int, default=8)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--sims", type=int, default=32)
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--blocks", type=int, default=3)
    p.add_argument("--norm", default="group", choices=["group", "none"])
    p.set_defaults(fn=cmd_selfplay)

    p = sub.add_parser("train", help="run the AlphaZero loop")
    _add_common(p)
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--games", type=int, default=16)
    p.add_argument("--train-steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--min-replay", type=int, default=256)
    p.add_argument("--sims", type=int, default=32)
    p.add_argument("--selfplay-batch", type=int, default=8)
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--blocks", type=int, default=3)
    p.add_argument("--norm", default="group", choices=["group", "none"])
    p.add_argument("--arena-games", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--gumbel", action="store_true",
                   help="gumbel sequential-halving root selection")
    p.add_argument("--alpha-scale", type=float, default=None,
                   help="dirichlet alpha = scale / num_legal_moves")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("bench", help="run the headline benchmark")
    _add_common(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("ladder", help="Elo ladder over a run's checkpoints")
    _add_common(p)
    p.add_argument("--ckpt", required=True, help="checkpoint directory of a run")
    p.add_argument("--games", type=int, default=16)
    p.add_argument("--sims", type=int, default=64)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--norm", default="group", choices=["group", "none"])
    p.set_defaults(fn=cmd_ladder)

    args = parser.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
