"""Smoke run of the tafl AlphaZero stack on NVIDIA GPUs.

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-cards  # the dp loop on four cards, and its
                                       # comparison with one card

Phases (one card), each printed with its result, tolerance and compile time:

1. device  — JAX's platform is ``gpu``; the card's name and power limit; the
   compilation-cache directory.
2. env     — Copenhagen 11x11, 4,096 games, one jitted 32-step scan of
   ``step_many`` (random-legal policy, auto-reset); 64 of the games replayed
   move by move on ``core/oracle.py``: boards, legal masks, results and
   reasons must match exactly (all integer state, tolerance 0).
3. net     — the flagship forward (64 channels, 6 GroupNorm blocks, bf16
   compute, f32 params) at B=1,024 against the same params in float32 under
   ``default_matmul_precision("highest")``.
4. search  — ``MCTS`` on 1,024 games, 128 simulations, 32 children, one leaf
   per wave, exact top-k: visits add up to the budget, no policy mass on
   illegal actions, every value finite.
5. trainer — ``run_loop`` at the flagship width (the path of ``cli train``):
   2 iterations of 512 self-play games at 128 sims with ``max_game_len`` cut
   from 256 to 64, 20 learner steps at batch 512, an arena of 64 games at
   64 sims; then a checkpoint restore that must equal the live state exactly,
   and a resume that runs exactly one more iteration.
6. gpu tests — the tests marked ``gpu`` (``tests/test_gpu.py``), in this
   process.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the script exits non-zero and never prints it.
Without a GPU it exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: Scratch checkpoint directory (``runs/**/ckpt*/`` is git-ignored).
CKPT_DIR = os.path.join(ROOT, "runs", "chip_smoke", "ckpt")

#: bf16 keeps 8 mantissa bits (relative rounding ~4e-3 per op); through the
#: 13-conv trunk the logits drift by about 1.3% of their norm (H100, seed 7),
#: inside 2%. The f32 value head reads that bf16 trunk, so its pre-tanh
#: error is the trunk's relative error times the pre-activation, which
#: reaches ~3 with random weights: the worst of 1,024 values is off by up
#: to ~0.04, hence 5e-2 on the max (2e-2 would hold only for values near 0).
NET_LOGITS_REL_L2 = 2e-2
NET_VALUE_ABS = 5e-2


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Shapes of every phase; :data:`FULL` is what the script runs."""

    preset: str = "copenhagen"
    channels: int = 64
    blocks: int = 6
    env_games: int = 4096
    env_steps: int = 32
    replay_games: int = 64
    net_batch: int = 1024
    search_games: int = 1024
    sims: int = 128
    children: int = 32
    selfplay_games: int = 512
    max_game_len: int = 64
    train_steps: int = 20
    train_batch: int = 512
    arena_games: int = 64
    arena_sims: int = 64
    replay_capacity: int = 40_000


FULL = Sizes()


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 2: env against the oracle
# ---------------------------------------------------------------------------


def _oracle_codes(state):
    """(result, reason) of an oracle state in the env's integer codes."""
    from alphazeroforhnefatafl_tpu.core import env as E
    from alphazeroforhnefatafl_tpu.core.rules import DrawReason, Side

    o = state.outcome
    if o is None:
        return E.ONGOING, E.R_NONE
    if o.winner is None:
        draw = {DrawReason.REPETITION: E.R_DRAW_REPETITION, DrawReason.NO_PLAYS: E.R_DRAW_NO_PLAYS}
        return E.DRAW, draw[o.draw_reason]
    win = E.WIN_ATTACKER if o.winner == Side.ATTACKER else E.WIN_DEFENDER
    return win, int(o.win_reason)


def replay_on_oracle(preset: str, trace) -> int:
    """Replay the recorded games on the oracle; returns plays compared."""
    import numpy as np

    from alphazeroforhnefatafl_tpu.core import actions as A
    from alphazeroforhnefatafl_tpu.core.oracle import GameLogic, GameState, Play
    from alphazeroforhnefatafl_tpu.core.rules import PRESETS

    rules, fen0 = PRESETS[preset]
    tr = {k: np.asarray(v) for k, v in trace.items()}
    steps, games = tr["action"].shape
    n = tr["board"].shape[-1]
    logic = GameLogic(rules, n)
    for g in range(games):
        st = GameState.from_fen(fen0, rules.starting_side)
        for t in range(steps):
            src, dst = A.decode_to_tiles(n, int(tr["action"][t, g]))
            st, _, _ = logic.do_play(Play.from_tiles(src, dst), st)
            where = f"game {g} step {t}"
            check(np.array_equal(st.board, tr["board"][t, g]), f"board differs at {where}")
            result, reason = _oracle_codes(st)
            check(
                (result, reason) == (int(tr["result"][t, g]), int(tr["reason"][t, g])),
                f"result/reason differ at {where}",
            )
            mask = np.zeros(tr["legal"].shape[-1], bool)
            if st.ongoing:
                for play in logic.all_plays(st):
                    mask[A.encode_from_tiles(n, play.from_tile, play.to)] = True
            check(np.array_equal(mask, tr["legal"][t, g]), f"legal mask differs at {where}")
            if not st.ongoing:
                st = GameState.from_fen(fen0, rules.starting_side)
    return steps * games


def phase_env(s: Sizes):
    import jax

    from alphazeroforhnefatafl_tpu.core.env import make_env
    from bench import build_rollout

    env = make_env(s.preset)
    rollout = build_rollout(env, s.env_games, s.env_steps, record=s.replay_games)
    state = env.reset_batch(s.env_games)
    mask = jax.jit(env.legal_mask_many)(state)
    t0 = time.perf_counter()
    out = jax.block_until_ready(rollout(state, mask, jax.random.PRNGKey(0)))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(rollout(*out[:3]))
    step_s = time.perf_counter() - t0
    plays = replay_on_oracle(s.preset, out[4])
    log(
        "env",
        result="ok",
        oracle_plays_compared=plays,
        tolerance="exact",
        games=s.env_games,
        steps_per_call=s.env_steps,
        env_steps_per_s=s.env_games * s.env_steps / step_s,
        compile_s=round(compile_s, 2),
    )
    return out[0]


# ---------------------------------------------------------------------------
# Phase 3: the flagship forward against float32
# ---------------------------------------------------------------------------


def random_params(net, num_planes: int, seed: int):
    """Init params with the zero-initialized final value layer drawn at
    random too, so the value head's output is not trivially 0."""
    import jax

    params = net.init(jax.random.PRNGKey(seed), num_planes)
    fc2 = params["value"]["fc2"]
    fc2["kernel"] = jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(seed + 1), fc2["kernel"].shape
    )
    return params


def phase_net(s: Sizes, states):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from alphazeroforhnefatafl_tpu.core.env import make_env
    from alphazeroforhnefatafl_tpu.models.network import make_network

    env = make_env(s.preset)
    net = make_network(env.n, channels=s.channels, blocks=s.blocks)
    ref_net = dataclasses.replace(net, dtype=jnp.float32)
    params = random_params(net, env.num_observation_planes, seed=7)
    roots = jax.tree_util.tree_map(lambda x: x[: s.net_batch], states)
    obs = jax.jit(jax.vmap(env.observe))(roots)
    t0 = time.perf_counter()
    logits, value = jax.block_until_ready(jax.jit(net.apply)(params, obs))
    compile_s = time.perf_counter() - t0
    with jax.default_matmul_precision("highest"):
        ref_logits, ref_value = jax.jit(ref_net.apply)(params, obs)
    logits, value = np.asarray(logits, np.float64), np.asarray(value, np.float64)
    ref_logits, ref_value = np.asarray(ref_logits, np.float64), np.asarray(ref_value, np.float64)
    check(np.all(np.isfinite(logits)) and np.all(np.isfinite(value)), "non-finite forward")
    rel = np.linalg.norm(logits - ref_logits) / np.linalg.norm(ref_logits)
    vabs = float(np.max(np.abs(value - ref_value)))
    log(
        "net",
        result="ok" if rel <= NET_LOGITS_REL_L2 and vabs <= NET_VALUE_ABS else "FAIL",
        batch=s.net_batch,
        logits_rel_l2=rel,
        logits_tol=NET_LOGITS_REL_L2,
        value_max_abs=vabs,
        value_rms=float(np.sqrt(np.mean((value - ref_value) ** 2))),
        value_tol=NET_VALUE_ABS,
        value_std=float(np.std(ref_value)),
        compile_s=round(compile_s, 2),
    )
    check(rel <= NET_LOGITS_REL_L2, f"logits rel L2 {rel} > {NET_LOGITS_REL_L2}")
    check(vabs <= NET_VALUE_ABS, f"value max abs {vabs} > {NET_VALUE_ABS}")


# ---------------------------------------------------------------------------
# Phase 4: search
# ---------------------------------------------------------------------------


def phase_search(s: Sizes, states):
    import jax
    import numpy as np

    from alphazeroforhnefatafl_tpu.core.env import make_env
    from alphazeroforhnefatafl_tpu.models.network import make_network
    from alphazeroforhnefatafl_tpu.search.mcts import MCTS, MCTSConfig

    env = make_env(s.preset)
    net = make_network(env.n, channels=s.channels, blocks=s.blocks)
    params = random_params(net, env.num_observation_planes, seed=11)
    cfg = MCTSConfig(num_simulations=s.sims, max_children=s.children, dirichlet_eps=0.0)
    mcts = MCTS(env, net.apply, cfg)
    roots = jax.tree_util.tree_map(lambda x: x[: s.search_games], states)
    legal = jax.jit(env.legal_mask_many)(roots)
    search = jax.jit(lambda p, st, lg, r: mcts.search(p, st, lg, r, add_noise=False))
    t0 = time.perf_counter()
    jax.block_until_ready(search(params, roots, legal, jax.random.PRNGKey(0)))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(search(params, roots, legal, jax.random.PRNGKey(1)))
    search_s = time.perf_counter() - t0
    visits = np.asarray(res.root_visits)
    probs = np.asarray(res.action_probs)
    lg = np.asarray(legal)
    check(np.all(visits == s.sims), f"root visits {np.unique(visits)} != {s.sims}")
    check(np.all(probs[~lg] == 0), "policy mass on illegal actions")
    check(np.allclose(probs.sum(-1), 1.0, atol=1e-5), "policy does not sum to 1")
    for name in ("action_probs", "root_value", "prior_fallback_rate"):
        check(np.all(np.isfinite(np.asarray(getattr(res, name)))), f"non-finite {name}")
    check(np.all(np.isfinite(np.asarray(res.tree.child_W))), "non-finite tree values")
    log(
        "search",
        result="ok",
        games=s.search_games,
        sims=s.sims,
        children=s.children,
        leaves_per_wave=1,
        topk="exact",
        sims_per_s=s.search_games * s.sims / search_s,
        compile_s=round(compile_s, 2),
    )


# ---------------------------------------------------------------------------
# Phase 5: trainer, checkpoint and resume
# ---------------------------------------------------------------------------


def loop_config(s: Sizes, iterations: int, checkpoint_dir):
    from alphazeroforhnefatafl_tpu.search.mcts import MCTSConfig
    from alphazeroforhnefatafl_tpu.train.loop import LoopConfig
    from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayConfig

    # runs/copenhagen_r4ab_puct/config.jsonl, with max_game_len and the
    # arena cap cut to 64, the replay capacity cut to 40k positions and the
    # step/iteration counts cut to a smoke run's.
    return LoopConfig(
        preset=s.preset,
        iterations=iterations,
        games_per_iteration=s.selfplay_games,
        train_steps_per_iteration=s.train_steps,
        train_batch_size=s.train_batch,
        min_replay_size=s.train_batch,
        replay_capacity=s.replay_capacity,
        channels=s.channels,
        blocks=s.blocks,
        arena_games=s.arena_games,
        arena_sims=s.arena_sims,
        arena_max_game_len=s.max_game_len,
        arena_every=1,
        gate_on="decisive",
        gate_threshold=0.55,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=1,
        seed=42,
        mcts=MCTSConfig(
            num_simulations=s.sims, max_children=s.children, dirichlet_alpha_scale=10.0
        ),
        selfplay=SelfPlayConfig(
            batch_size=s.selfplay_games,
            temp_threshold=12,
            max_game_len=s.max_game_len,
            resign_threshold=0.95,
            resign_min_moves=20,
        ),
    )


class _Rows:
    """A ``MetricsLogger`` whose JSON lines are kept in memory."""

    def __init__(self):
        import io

        from alphazeroforhnefatafl_tpu.utils.metrics import MetricsLogger

        self.buf = io.StringIO()
        self.logger = MetricsLogger(stream=self.buf)

    def iterations(self):
        rows = [json.loads(line) for line in self.buf.getvalue().splitlines()]
        return [r for r in rows if "selfplay/games" in r]


def _finite(x) -> bool:
    return isinstance(x, float) and x == x and abs(x) != float("inf")


def _tree_equal(a, b) -> bool:
    import jax
    import numpy as np

    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb)
    )


def phase_trainer(s: Sizes):
    import jax
    import numpy as np

    from alphazeroforhnefatafl_tpu.core.env import make_env
    from alphazeroforhnefatafl_tpu.models.network import make_network
    from alphazeroforhnefatafl_tpu.train.checkpoint import CheckpointManager
    from alphazeroforhnefatafl_tpu.train.learner import init_train_state, make_optimizer
    from alphazeroforhnefatafl_tpu.train.loop import run_loop
    from alphazeroforhnefatafl_tpu.train.replay import ReplayBuffer

    env = make_env(s.preset)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        cfg = loop_config(s, iterations=2, checkpoint_dir=CKPT_DIR)
        out = _Rows()
        replay = ReplayBuffer(env, cfg.replay_capacity, cfg.selfplay.policy_k)
        t0 = time.perf_counter()
        state = run_loop(env, cfg, log=out.logger, replay=replay)
        loop_s = time.perf_counter() - t0
        rows = out.iterations()
        check(len(rows) == 2, f"{len(rows)} iterations logged, expected 2")
        check(int(state.step) == 2 * s.train_steps, f"learner step {int(state.step)}")
        for r in rows:
            log(
                "trainer",
                iteration=r["step"],
                games=r["selfplay/games"],
                positions=r["selfplay/positions"],
                selfplay_s=round(r["time/selfplay_s"], 2),
                train_s=round(r["time/train_s"], 2),
                loss=r.get("train/loss"),
                arena_games=r.get("arena/games"),
            )
        for r in rows:
            check(_finite(r.get("train/loss")), "non-finite or missing loss")

        net = make_network(env.n, channels=s.channels, blocks=s.blocks)
        template = init_train_state(
            net, jax.random.PRNGKey(0), env.num_observation_planes,
            make_optimizer(learning_rate=cfg.learning_rate),
        )
        mgr = CheckpointManager(CKPT_DIR)
        check(mgr.latest_iteration() == 1, f"latest checkpoint {mgr.latest_iteration()}")
        fresh = ReplayBuffer(env, cfg.replay_capacity, cfg.selfplay.policy_k)
        _, restored, _, _ = mgr.restore(template, fresh)
        check(_tree_equal(restored.params, state.params), "restored params differ")
        check(_tree_equal(restored.opt_state, state.opt_state), "restored optimizer state differs")
        check(int(restored.step) == int(state.step), "restored step differs")
        for k in ("board", "side", "reps", "policy_idx", "policy_p", "value"):
            check(np.array_equal(getattr(fresh, k), getattr(replay, k)), f"restored replay.{k} differs")
        check(
            (fresh.size, fresh.write, fresh.total_added)
            == (replay.size, replay.write, replay.total_added),
            "restored replay counters differ",
        )

        out2 = _Rows()
        t0 = time.perf_counter()
        state3 = run_loop(
            env, loop_config(s, iterations=3, checkpoint_dir=CKPT_DIR), log=out2.logger
        )
        resume_s = time.perf_counter() - t0
        its = [r["step"] for r in out2.iterations()]
        check(its == [2], f"resume ran iterations {its}, expected [2]")
        check(int(state3.step) == 3 * s.train_steps, f"resumed learner step {int(state3.step)}")
        log(
            "trainer",
            result="ok",
            first_run_s=round(loop_s, 2),
            restore="exact",
            resume_iterations=its,
            resume_run_s=round(resume_s, 2),
            cuts="max_game_len 256->64, arena cap 300->64, replay 600k->40k",
        )
    finally:
        shutil.rmtree(os.path.dirname(CKPT_DIR), ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 6: the tests marked gpu
# ---------------------------------------------------------------------------


class _Outcomes:
    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_gpu_tests():
    import pytest

    outcomes = _Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(ROOT, "tests", "test_gpu.py")],
        plugins=[outcomes],
    )
    c = outcomes.counts
    ok = rc == 0 and c["failed"] == 0 and c["skipped"] == 0 and c["passed"] > 0
    log("gpu_tests", result="ok" if ok else "FAIL", seconds=round(time.perf_counter() - t0, 2), **c)
    check(ok, f"gpu tests {c} rc={rc}")


# ---------------------------------------------------------------------------
# --four-cards: the dp loop against one card
# ---------------------------------------------------------------------------


def phase_four_cards(s: Sizes, cards: int = 4):
    import jax
    import numpy as np

    from alphazeroforhnefatafl_tpu.core.env import make_env
    from alphazeroforhnefatafl_tpu.models.network import make_network
    from alphazeroforhnefatafl_tpu.parallel.mesh import (
        auto_mesh,
        batch_sharding,
        replicate,
        shard_batch,
    )
    from alphazeroforhnefatafl_tpu.train.learner import make_optimizer, make_train_step
    from alphazeroforhnefatafl_tpu.train.loop import run_loop
    from alphazeroforhnefatafl_tpu.train.replay import ReplayBuffer, make_batch_builder
    from alphazeroforhnefatafl_tpu.train.selfplay import SelfPlayActor

    check(len(jax.devices()) == cards, f"{len(jax.devices())} devices, expected {cards}")
    env = make_env(s.preset)
    cfg = loop_config(s, iterations=1, checkpoint_dir=None)
    mesh = auto_mesh(cfg.train_batch_size, cfg.selfplay.batch_size)
    check(mesh.size == cards, f"dp mesh of {mesh.size} devices")
    out = _Rows()
    replay = ReplayBuffer(env, cfg.replay_capacity, cfg.selfplay.policy_k)
    t0 = time.perf_counter()
    state = run_loop(env, cfg, log=out.logger, mesh=mesh, replay=replay)
    loop_s = time.perf_counter() - t0
    rows = out.iterations()
    check(len(rows) == 1 and _finite(rows[0].get("train/loss")), "dp iteration")
    for leaf in jax.tree_util.tree_leaves(state):
        check(
            leaf.sharding.is_fully_replicated and len(leaf.sharding.device_set) == cards,
            "train state not replicated on every card",
        )
    net = make_network(env.n, channels=s.channels, blocks=s.blocks)
    evaluate = jax.jit(net.apply)
    actor = SelfPlayActor(env, evaluate, cfg.mcts, cfg.selfplay, sharding=batch_sharding(mesh))
    board = actor._reset_batch().board
    per_card = board.sharding.shard_shape(board.shape)[0]
    check(
        per_card == s.selfplay_games // cards and len(board.sharding.device_set) == cards,
        f"self-play batch sharded {per_card} games per card",
    )
    log(
        "four_cards",
        iteration_s=round(loop_s, 2),
        games=rows[0]["selfplay/games"],
        selfplay_s=round(rows[0]["time/selfplay_s"], 2),
        train_s=round(rows[0]["time/train_s"], 2),
        arena_games=rows[0].get("arena/games"),
        games_per_card=per_card,
        params="replicated",
    )

    # One learner step from the same params and batch, on 4 cards and on 1.
    optimizer = make_optimizer(learning_rate=cfg.learning_rate)
    step = jax.jit(make_train_step(net, optimizer))
    sample = replay.sample(np.random.RandomState(0), s.train_batch)
    batch = make_batch_builder(env)(
        sample.board, sample.side, sample.reps, sample.policy_idx, sample.policy_p, sample.value
    )
    one = jax.devices()[0]
    host_state = jax.device_get(state)
    host_batch = jax.device_get(batch)
    s1, m1 = step(jax.device_put(host_state, one), jax.device_put(host_batch, one))
    s4, m4 = step(replicate(mesh, host_state), shard_batch(mesh, host_batch))
    p0 = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(host_state.params)])
    u1 = np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(s1.params)]) - p0
    u4 = np.concatenate([np.ravel(np.asarray(x)) for x in jax.tree_util.tree_leaves(s4.params)]) - p0
    upd_rel = float(np.linalg.norm(u4 - u1) / np.linalg.norm(u1))
    loss_rel = abs(float(m4["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    gn_rel = abs(float(m4["grad_norm"]) - float(m1["grad_norm"])) / float(m1["grad_norm"])
    # The 4-card step sums per-card partial gradients (psum) where the
    # 1-card step reduces one batch, and each card compiles its bf16 convs
    # for a quarter of the batch. Loss and gradient norm agree to ~1e-4;
    # Adam divides each gradient entry by its own running RMS, which
    # magnifies reordering noise in near-zero entries, so the update agrees
    # to ~1e-2 (four H100s). A wrong shard or a missing psum is off by O(1).
    tol = {"loss_rel": 1e-3, "grad_norm_rel": 1e-2, "update_rel_l2": 5e-2}
    ok = loss_rel <= tol["loss_rel"] and gn_rel <= tol["grad_norm_rel"] and upd_rel <= tol["update_rel_l2"]
    log(
        "four_cards",
        result="ok" if ok else "FAIL",
        learner_step="4 cards vs 1",
        loss_rel=loss_rel,
        grad_norm_rel=gn_rel,
        update_rel_l2=upd_rel,
        tolerances=json.dumps(tol).replace(" ", ""),
    )
    check(ok, "4-card learner step disagrees with 1-card step")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the dp loop on four cards and its comparison with one card",
    )
    args = ap.parse_args(argv)

    import jax

    sys.path.insert(0, ROOT)
    from alphazeroforhnefatafl_tpu.utils.compile_cache import enable_compile_cache
    from bench import card_name_and_power_limit

    cache_dir = enable_compile_cache()
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    cards = 4 if args.four_cards else 1
    if len(devices) < cards:
        print(f"chip_smoke.py needs {cards} GPUs; JAX found {len(devices)}", file=sys.stderr)
        return 1
    card = card_name_and_power_limit()
    log("device", platform=dev.platform, kind=repr(dev.device_kind), count=len(devices), cache=cache_dir)
    print(card, flush=True)

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(FULL, cards)
    else:
        states = phase_env(FULL)
        phase_net(FULL, states)
        phase_search(FULL, states)
        phase_trainer(FULL)
        phase_gpu_tests()
    log("done", seconds=round(time.perf_counter() - t0, 2))
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
