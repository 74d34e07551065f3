"""Batched self-play actor.

The self-play driver the reference never wrote (its MCTS at ``src/mcts.py``
implies an AlphaZero-general-style Coach above it; SURVEY.md §1 L2). Design:
a lockstep batch of B games lives on device; each move runs one batched MCTS
(one fused NN forward per simulation wave), samples actions with a
temperature schedule, and steps all games in one fused env step. The host
only orchestrates the move loop and flushes finished episodes to the replay
buffer — the parallelism of this workload is batch-of-games data parallelism
(SURVEY.md §5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..core.env import DRAW, TaflEnv
from ..search.mcts import MCTS, MCTSConfig, select_actions
from .replay import ReplayBuffer


@dataclass(frozen=True)
class SelfPlayConfig:
    batch_size: int = 64
    temp_threshold: int = 12  # moves with temp=1 before switching to argmax
    max_game_len: int = 256  # length cap; see bootstrap_truncated
    policy_k: int = 128  # sparse policy-target width
    #: EXPERIMENTAL: value target for games cut at max_game_len = the final
    #: position's MCTS root value (sign-adjusted per side) instead of a hard
    #: draw. Off by default: in an 11x11 A/B it reinforced a shuffling
    #: equilibrium (the net predicts ~0, truncations get ~0 targets, long
    #: drawish play is never penalized) and lost -100 Elo to the hard-draw
    #: labeling at equal budget.
    bootstrap_truncated: bool = False
    #: AlphaZero-style resignation: a game ends as a loss for the mover when
    #: their MCTS root value stays below -resign_threshold for
    #: resign_consecutive of their moves. None disables. A random
    #: resign_disable_frac of games ignores resignation and plays to the end
    #: so the false-positive rate (mover would NOT have lost) is measurable
    #: from SelfPlayStats.
    resign_threshold: "float | None" = None
    resign_consecutive: int = 2
    resign_disable_frac: float = 0.1
    #: No resignation before this many moves have been played. Guards the
    #: feedback collapse observed in runs/brandubh_r3_gated: once the net
    #: is confident the attacker loses, games resign by move ~3 (resign
    #: fraction 99%, avg length 3.1 vs 13 at run start) and self-play stops
    #: producing mid-game positions. 0 keeps the prior behavior byte-stable.
    resign_min_moves: int = 0
    #: >0: run each move's search via ``MCTS.search_in_chunks`` with this
    #: wave-chunk size instead of one monolithic jitted move: the chunked
    #: path compiles ONE reusable chunk executable whatever the simulation
    #: budget. Single-device only (multi-device self-play uses the jitted
    #: shard_map move).
    search_chunk: int = 0
    #: >0: device-side episode accumulation — one jitted ``lax.scan``
    #: advances this many MOVES per call entirely on device (search, action
    #: selection, env step, resignation streaks, auto-reset), emitting the
    #: per-move position stream + end events; the host gets ONE transfer per
    #: chunk instead of ~8 device round-trips per move and stitches episodes
    #: by game slot. RNG-compatible with the host loop: with resignation off
    #: the two paths produce bit-identical games for the same seed (tested).
    #: Mutually exclusive with search_chunk (the search must inline into the
    #: scan body). On a >1-device mesh the WHOLE move scan runs as the local
    #: program of one ``shard_map`` — zero collectives, one global transfer
    #: per chunk (tested collective-free on the 8-device CPU mesh).
    scan_moves: int = 0
    #: Gumbel draw-collapse mitigation: during the temperature phase
    #: (move < temp_threshold) SAMPLE the move from the improved policy
    #: softmax(logits + sigma(completed Q)) instead of playing the
    #: deterministic sequential-halving winner (Danihelka et al. 2022 §5's
    #: stochastic variant). Round-2 evidence: always-argmax gumbel self-play
    #: on 11x11 collapsed to 86-93% draws because the deterministic winner
    #: reinforces shuffling lines (docs/EXPERIMENTS.md). Off by default
    #: (keeps the round-2 program byte-stable); no effect under PUCT.
    gumbel_sample_temp_moves: bool = False


@dataclass
class SelfPlayStats:
    games: int = 0
    positions: int = 0
    attacker_wins: int = 0
    defender_wins: int = 0
    draws: int = 0
    truncated: int = 0
    length_sum: int = 0
    resigned: int = 0
    #: monitoring games (resignation disabled) whose would-have-resigned
    #: prediction could be checked against the real outcome:
    resign_checked: int = 0
    resign_false_positive: int = 0  # mover did NOT go on to lose
    #: mean of per-search prior-fallback rates (legal-masked NN policy summed
    #: to zero -> uniform fallback; the reference's one error log,
    #: src/mcts.py:96, counted as a metric per SURVEY §5):
    fallback_sum: float = 0.0
    fallback_searches: int = 0

    def as_dict(self):
        g = max(self.games, 1)
        return {
            "games": self.games,
            "positions": self.positions,
            "attacker_win_rate": self.attacker_wins / g,
            "defender_win_rate": self.defender_wins / g,
            "draw_rate": self.draws / g,
            "truncated": self.truncated,
            "avg_length": self.length_sum / g,
            "resigned": self.resigned,
            "resign_fp_rate": (
                self.resign_false_positive / self.resign_checked
                if self.resign_checked
                else 0.0
            ),
            # Denominator for the fp rate: without it, per-iteration rates
            # cannot be aggregated into a run-level figure.
            "resign_checked": self.resign_checked,
            "prior_fallback_rate": (
                self.fallback_sum / self.fallback_searches
                if self.fallback_searches
                else 0.0
            ),
        }


class SelfPlayActor:
    """Runs lockstep self-play games and feeds a replay buffer."""

    def __init__(
        self,
        env: TaflEnv,
        evaluate: Callable,
        mcts_config: MCTSConfig,
        config: SelfPlayConfig,
        sharding=None,
        dispatch="auto",
    ):
        """``sharding``: optional ``NamedSharding`` (e.g. ``P("dp")`` over a
        mesh) for the lockstep game batch — each device steps its own slice
        of the games with zero cross-device traffic (pure DP of games,
        SURVEY.md §5). Params should then be replicated over the same mesh.

        ``dispatch``: how the move program runs under that mesh — ``"auto"``
        (whole-move ``shard_map`` whenever the mesh has >1 device; GSPMD
        refuses to batch-partition the search's top_k/scatter families, so
        plain jit would all-gather the game batch), ``None`` to force the
        single-program path, or an explicit
        :class:`~alphazeroforhnefatafl_tpu.core.env.KernelDispatch`.
        """
        from ..core.env import auto_dispatch

        self.env = env
        self.cfg = config
        if dispatch == "auto":
            dispatch = auto_dispatch(sharding)
        if sharding is None:
            dispatch = None
        self.dispatch = dispatch
        if (config.search_chunk > 0 or config.scan_moves > 0) and sharding is not None:
            if sharding.mesh.size > 1:
                if config.search_chunk > 0:
                    raise ValueError(
                        "search_chunk (chunk-compiled large-budget search) is "
                        "a single-device path; use sims that fit one jitted "
                        "move on sharded meshes (scan_moves works sharded)"
                    )
            else:
                # 1-device mesh: placement is trivial, the single-program
                # chunked path is equivalent.
                sharding = None
                dispatch = self.dispatch = None
        if config.search_chunk > 0 and config.scan_moves > 0:
            raise ValueError(
                "scan_moves inlines the search into a device scan; it cannot "
                "combine with the chunk-compiled search (search_chunk)"
            )
        self.mcts = MCTS(env, evaluate, mcts_config)

        def move_tail(states, legal, action_probs, best_action, root_v, fb,
                      temps, r_sample, rng):
            """Action selection + env step + sparse top-K policy target —
            the ONE shared tail of every move path (monolithic, chunked
            search, device scan), so the documented bit-identical-for-a-seed
            guarantee between them cannot drift."""
            if mcts_config.root_selection == "gumbel":
                # Exploration comes from the sampled root Gumbels; play the
                # sequential-halving winner (no temperature) — unless the
                # temperature-phase sampling mitigation is on (see
                # SelfPlayConfig.gumbel_sample_temp_moves).
                actions = best_action
                if config.gumbel_sample_temp_moves:
                    sampled = select_actions(
                        action_probs, legal, temps, r_sample
                    )
                    actions = jnp.where(temps > 0, sampled, actions)
            else:
                actions = select_actions(action_probs, legal, temps, r_sample)
            new_states, info = env.step_many(states, actions)
            top_p, top_a = jax.lax.top_k(action_probs, config.policy_k)
            top_a = jnp.where(top_p > 0, top_a, -1)
            return (
                new_states,
                actions,
                info,
                top_a.astype(jnp.int32),
                top_p,
                root_v,
                fb,
                rng,
            )

        def move_fn(params, states, temps, rng):
            rng, r_search, r_sample = jax.random.split(rng, 3)
            legal = env.legal_mask_many(states)
            result = self.mcts.search(params, states, legal, r_search, add_noise=True)
            return move_tail(
                states, legal, result.action_probs, result.best_action,
                result.root_value, result.prior_fallback_rate, temps, r_sample,
                rng,
            )

        if sharding is None:
            if config.search_chunk > 0:
                # Large-budget path: the search runs as repeated calls of ONE
                # compiled chunk-wave executable (tree carried on device);
                # only the pre/post stages are separately jitted, at ~S/chunk
                # extra dispatches per move.
                jit_legal = jax.jit(lambda s: env.legal_mask_many(s))
                jit_post = jax.jit(move_tail)

                def move_chunked(params, states, temps, rng):
                    # Same key derivation as the monolithic move_fn, so the
                    # two paths are bit-identical for a given seed.
                    rng, r_search, r_sample = jax.random.split(rng, 3)
                    legal = jit_legal(states)
                    res = self.mcts.search_in_chunks(
                        params, states, legal, r_search, add_noise=True,
                        chunk=config.search_chunk,
                    )
                    return jit_post(
                        states, legal, res.action_probs, res.best_action,
                        res.root_value, res.prior_fallback_rate, temps,
                        r_sample, rng,
                    )

                self._move = move_chunked
            else:
                self._move = jax.jit(move_fn)
            self._reset_batch = jax.jit(lambda: env.reset_batch(config.batch_size))
            if config.scan_moves > 0:
                self._scan_chunk = jax.jit(
                    self._build_scan_chunk(move_fn)
                )
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            repl = NamedSharding(sharding.mesh, P())
            if dispatch is not None:
                # Whole-move shard_map: each device runs the full search +
                # step program on its own slice of the game batch (pure DP of
                # games; zero collectives — asserted by
                # tests/test_kernel_dispatch.py). The rng folds in the shard
                # index so exploration noise is independent across shards;
                # the replicated carried-rng output is the pre-fold key
                # (callers split fresh keys per move anyway).
                axis = dispatch.axis

                def move_sharded(params, states, temps, rng):
                    def local(params, states, temps, rng):
                        out = move_fn(
                            params,
                            states,
                            temps,
                            jax.random.fold_in(rng, jax.lax.axis_index(axis)),
                        )
                        return out[:-1] + (rng,)

                    return jax.shard_map(
                        local,
                        mesh=dispatch.mesh,
                        in_specs=(P(), P(axis), P(axis), P()),
                        out_specs=(P(axis),) * 7 + (P(),),
                        check_vma=False,
                    )(params, states, temps, rng)

                jit_move = move_sharded
            else:
                jit_move = move_fn
            # (states, actions, info, top_a, top_p, root_value, fb, rng):
            # everything batched over games except the carried rng key.
            self._move = jax.jit(
                jit_move,
                out_shardings=(sharding,) * 7 + (repl,),
            )
            self._reset_batch = jax.jit(
                lambda: env.reset_batch(config.batch_size), out_shardings=sharding
            )
            if config.scan_moves > 0:
                # Sharded scan path: the WHOLE move scan is the local program
                # of one shard_map — each device advances its slice of the
                # games for scan_moves moves with zero collectives; the host
                # receives one global [T, B, ...] transfer per chunk. The
                # carried keys stay replicated (split happens identically on
                # every shard); per-move exploration keys fold in the shard
                # index, mirroring the per-move sharded path above.
                if dispatch is None:
                    raise ValueError(
                        "scan_moves on a >1-device mesh requires the "
                        "shard_map dispatch (dispatch='auto')"
                    )
                mesh_size = dispatch.mesh.size
                if config.batch_size % mesh_size:
                    raise ValueError(
                        f"scan_moves: batch_size ({config.batch_size}) must "
                        f"be a multiple of the mesh size ({mesh_size})"
                    )
                axis = dispatch.axis
                local_chunk = self._build_scan_chunk(
                    move_fn,
                    batch=config.batch_size // mesh_size,
                    key_xform=lambda k: jax.random.fold_in(
                        k, jax.lax.axis_index(axis)
                    ),
                )
                P_ = P
                carry_specs = (
                    P_(axis),  # states (spec prefix over the EnvState tree)
                    P_(axis),  # ep_len
                    P_(),      # rng (replicated, identical split chain)
                    P_(axis),  # resign streaks
                    P_(axis),  # resign enabled
                    P_(axis),  # would-resign side
                    P_(),      # resign rng (replicated; redraws fold idx)
                )
                ys_spec = P_(None, axis)  # [T, B_local, ...] per shard

                def scan_sharded(params, carry):
                    return jax.shard_map(
                        local_chunk,
                        mesh=dispatch.mesh,
                        in_specs=(P_(), carry_specs),
                        out_specs=(carry_specs, ys_spec),
                        check_vma=False,
                    )(params, carry)

                self._scan_chunk = jax.jit(scan_sharded)

    def _build_scan_chunk(self, move_fn, batch=None, key_xform=None):
        """Device move loop: one jitted ``lax.scan`` advancing ``scan_moves``
        moves — search, action selection, env step, resignation streak
        tracking and auto-reset all on device — emitting the position stream
        and end events as scan ys (ONE host transfer per chunk).

        RNG discipline mirrors the host loop exactly (one ``split`` per move
        feeding the move fn), so with resignation off the two paths play
        bit-identical games; resignation's enable redraws consume a separate
        carried key, leaving the action stream untouched.

        ``batch``/``key_xform`` parametrize the sharded variant: the scan
        runs as the LOCAL program of a whole-chunk ``shard_map`` (``batch`` =
        per-device games, ``key_xform`` folds the shard index into each
        move's key so exploration is independent across shards while the
        carried key stays replicated).
        """
        env, config = self.env, self.cfg
        B = config.batch_size if batch is None else batch
        L = config.max_game_len
        resign_on = config.resign_threshold is not None
        rows = jnp.arange(B)

        def chunk(params, carry):
            def body(carry, _):
                states, ep_len, rng, streak, enabled, would, resign_rng = carry
                rng, sub = jax.random.split(rng)
                if key_xform is not None:
                    sub = key_xform(sub)
                temps = (ep_len < config.temp_threshold).astype(jnp.float32)
                b_board = states.board
                b_side = states.side_to_play
                b_reps = states.reps[rows, b_side]

                new_states, actions, info, top_a, top_p, root_v, fb, _ = move_fn(
                    params, states, temps, sub
                )
                done = new_states.terminated
                results = new_states.result
                new_len = ep_len + 1
                truncate = (new_len >= L) & ~done
                if resign_on:
                    low = root_v < -config.resign_threshold
                    cur = streak[rows, b_side]
                    streak = streak.at[rows, b_side].set(
                        jnp.where(low, cur + 1, 0)
                    )
                    trig = (
                        streak[rows, b_side] >= config.resign_consecutive
                    ) & (new_len >= config.resign_min_moves)
                    resign_now = trig & enabled & ~done & ~truncate
                    first = trig & ~enabled & (would < 0)
                    would = jnp.where(first, b_side.astype(jnp.int8), would)
                else:
                    resign_now = jnp.zeros((B,), bool)
                end = done | truncate | resign_now
                result_out = jnp.where(
                    done, results, jnp.where(resign_now, 1 - b_side, DRAW)
                ).astype(jnp.int32)

                fresh = env.reset_batch(B)

                def where_end(f, c):
                    d = end.reshape(end.shape + (1,) * (c.ndim - 1))
                    return jnp.where(d, f, c)

                states_next = jax.tree_util.tree_map(where_end, fresh, new_states)
                ep_len = jnp.where(end, 0, new_len)
                streak = jnp.where(end[:, None], 0, streak)
                resign_rng, k = jax.random.split(resign_rng)
                if key_xform is not None:
                    k = key_xform(k)
                redraw = jax.random.uniform(k, (B,)) >= config.resign_disable_frac
                enabled = jnp.where(end, redraw, enabled)
                monitor = jnp.where(end, would, -1).astype(jnp.int8)
                would = jnp.where(end, jnp.int8(-1), would)

                ys = dict(
                    board=b_board,
                    side=b_side.astype(jnp.int8),
                    reps=b_reps.astype(jnp.int8),
                    top_a=top_a,
                    top_p=top_p,
                    root_v=root_v,
                    fb=fb,
                    ended=end,
                    result=result_out,
                    truncated=truncate,
                    resigned=resign_now,
                    monitor=monitor,
                )
                return (
                    states_next, ep_len, rng, streak, enabled, would, resign_rng
                ), ys

            return jax.lax.scan(body, carry, None, length=config.scan_moves)

        return chunk

    def _play_scan(
        self,
        params,
        replay: Optional[ReplayBuffer],
        rng: jax.Array,
        num_games: int,
        stats: SelfPlayStats,
    ) -> SelfPlayStats:
        """Scan-path ``play``: device-side episode accumulation (see
        ``SelfPlayConfig.scan_moves``)."""
        cfg = self.cfg
        B = cfg.batch_size
        states = self._reset_batch()
        resign_rng, en_key = jax.random.split(jax.random.fold_in(rng, 0x5EED))
        enabled = (
            jax.random.uniform(en_key, (B,)) >= cfg.resign_disable_frac
        )
        carry = (
            states,
            jnp.zeros((B,), jnp.int32),
            rng,
            jnp.zeros((B, 2), jnp.int32),
            enabled,
            jnp.full((B,), -1, jnp.int8),
            resign_rng,
        )
        # Per-slot pending positions carried across chunks (list of per-chunk
        # array dicts).
        pend = [[] for _ in range(B)]
        completed = 0
        while completed < num_games:
            carry, ys = self._scan_chunk(params, carry)
            ys_np = {k: np.asarray(v) for k, v in ys.items()}
            completed += self._flush_scan_chunk(ys_np, pend, replay, stats)
        return stats

    _POS_FIELDS = ("board", "side", "reps", "top_a", "top_p", "root_v")

    def _flush_scan_chunk(self, ys, pend, replay, stats) -> int:
        """Stitch episodes out of one chunk's position stream: each slot's
        timeline is cut at its end events; completed episodes get final
        value targets and go to replay. Returns episodes completed."""
        cfg = self.cfg
        n_done = 0
        B = ys["ended"].shape[1]
        stats.fallback_sum += float(ys["fb"].sum())
        stats.fallback_searches += int(ys["fb"].size)
        for g in range(B):
            seg = {f: ys[f][:, g] for f in self._POS_FIELDS}
            events = np.nonzero(ys["ended"][:, g])[0]
            start = 0
            for t in events:
                parts = pend[g] + [
                    {f: seg[f][start : t + 1] for f in self._POS_FIELDS}
                ]
                pend[g] = []
                ep = {
                    f: np.concatenate([p[f] for p in parts])
                    for f in self._POS_FIELDS
                }
                start = t + 1
                length = len(ep["side"])
                r = int(ys["result"][t, g])
                truncated = bool(ys["truncated"][t, g])
                resigned = bool(ys["resigned"][t, g])
                monitor = int(ys["monitor"][t, g])
                sides = ep["side"]
                if truncated and cfg.bootstrap_truncated:
                    v_last = float(ep["root_v"][length - 1])
                    z = np.where(
                        sides == sides[length - 1], v_last, -v_last
                    ).astype(np.float32)
                elif r == DRAW:
                    z = np.zeros(length, np.float32)
                else:
                    z = np.where(sides == r, 1.0, -1.0).astype(np.float32)
                if replay is not None:
                    replay.add(
                        ep["board"], sides, ep["reps"], ep["top_a"],
                        ep["top_p"], z,
                    )
                stats.games += 1
                stats.positions += length
                stats.length_sum += length
                if truncated:
                    stats.truncated += 1
                    stats.draws += 1
                    if monitor >= 0:
                        stats.resign_checked += 1
                        stats.resign_false_positive += 1  # draw, not a loss
                else:
                    if r == DRAW:
                        stats.draws += 1
                    elif r == 0:
                        stats.attacker_wins += 1
                    else:
                        stats.defender_wins += 1
                    if resigned:
                        stats.resigned += 1
                    elif monitor >= 0:
                        stats.resign_checked += 1
                        if r != 1 - monitor:
                            stats.resign_false_positive += 1
                n_done += 1
            if start < seg["side"].shape[0]:
                pend[g].append(
                    {f: seg[f][start:] for f in self._POS_FIELDS}
                )
        return n_done

    def play(
        self,
        params,
        replay: Optional[ReplayBuffer],
        rng: jax.Array,
        num_games: int,
        stats: Optional[SelfPlayStats] = None,
    ) -> SelfPlayStats:
        """Play at least ``num_games`` complete games, writing every finished
        episode's positions (with final-outcome value targets) to ``replay``."""
        env, cfg = self.env, self.cfg
        B, L, K = cfg.batch_size, cfg.max_game_len, cfg.policy_k
        n = env.n
        stats = stats or SelfPlayStats()
        if cfg.scan_moves > 0:
            return self._play_scan(params, replay, rng, num_games, stats)

        states = self._reset_batch()
        # Loop-invariant fresh batch for masked per-move resets (computing it
        # inside the loop paid a jitted dispatch per move for nothing).
        fresh = self._reset_batch()
        # Per-game episode buffers (host, numpy).
        ep_board = np.zeros((B, L, n, n), np.int8)
        ep_side = np.zeros((B, L), np.int8)
        ep_reps = np.zeros((B, L), np.int8)
        ep_pidx = np.full((B, L, K), -1, np.int32)
        ep_pp = np.zeros((B, L, K), np.float32)
        ep_rootv = np.zeros((B, L), np.float32)
        ep_len = np.zeros((B,), np.int32)

        # Resignation bookkeeping (host): per-game streak of mover root
        # values below -threshold, an enable flag (a random fraction plays
        # to the end for false-positive monitoring), and for monitoring
        # games the side that WOULD have resigned first.
        resign_on = cfg.resign_threshold is not None
        np_rng = np.random.RandomState(
            int(np.asarray(jax.random.randint(rng, (), 0, 2**31 - 1)))
        )
        resign_streak = np.zeros((B, 2), np.int32)  # per (game, side)
        would_resign_side = np.full((B,), -1, np.int8)
        resign_enabled = np_rng.rand(B) >= cfg.resign_disable_frac

        completed = 0
        while completed < num_games:
            move_idx = ep_len  # per-game move count
            temps = jnp.asarray((move_idx < cfg.temp_threshold).astype(np.float32))
            # Snapshot position before the move (host copies).
            b_board = np.asarray(states.board)
            b_side = np.asarray(states.side_to_play).astype(np.int8)
            b_reps = np.asarray(
                states.reps[np.arange(B), np.asarray(states.side_to_play)]
            ).astype(np.int8)

            rng, sub = jax.random.split(rng)
            states, actions, info, top_a, top_p, root_v, fb, _ = self._move(
                params, states, temps, sub
            )
            stats.fallback_sum += float(np.asarray(fb).sum())
            stats.fallback_searches += B

            top_a_np = np.asarray(top_a)
            top_p_np = np.asarray(top_p)
            root_v_np = np.asarray(root_v)
            # Vectorized episode-buffer writes (no Python loop over the game
            # batch).
            g_idx = np.nonzero(ep_len < L)[0]
            t_idx = ep_len[g_idx]
            ep_board[g_idx, t_idx] = b_board[g_idx]
            ep_side[g_idx, t_idx] = b_side[g_idx]
            ep_reps[g_idx, t_idx] = b_reps[g_idx]
            ep_pidx[g_idx, t_idx] = top_a_np[g_idx]
            ep_pp[g_idx, t_idx] = top_p_np[g_idx]
            ep_rootv[g_idx, t_idx] = root_v_np[g_idx]
            ep_len += 1

            done = np.asarray(states.terminated)
            results = np.asarray(states.result)
            truncate = (ep_len >= L) & ~done
            if resign_on:
                # root_v is from the mover's (b_side) perspective; each side
                # keeps its own consecutive-low streak (movers alternate).
                low = root_v_np < -cfg.resign_threshold
                rows = np.arange(B)
                mover = b_side.astype(np.int64)
                cur = resign_streak[rows, mover]
                resign_streak[rows, mover] = np.where(low, cur + 1, 0)
                trig = (resign_streak[rows, mover] >= cfg.resign_consecutive) & (
                    ep_len >= cfg.resign_min_moves
                )
                resign_now = trig & resign_enabled & ~done & ~truncate
                first = trig & ~resign_enabled & (would_resign_side < 0)
                would_resign_side[first] = b_side[first]
            else:
                resign_now = np.zeros((B,), bool)
            for g in range(B):
                if not (done[g] or truncate[g] or resign_now[g]):
                    continue
                length = int(min(ep_len[g], L))
                if done[g]:
                    r = int(results[g])
                elif resign_now[g]:
                    r = 1 - int(b_side[g])  # mover resigns; opponent wins
                else:
                    r = DRAW
                sides = ep_side[g, :length]
                if not done[g] and not resign_now[g] and cfg.bootstrap_truncated:
                    # Horizon cut: bootstrap from the last root value,
                    # sign-adjusted to each position's mover.
                    v_last = float(ep_rootv[g, length - 1])
                    last_side = sides[length - 1]
                    z = np.where(sides == last_side, v_last, -v_last).astype(
                        np.float32
                    )
                elif r == DRAW:
                    z = np.zeros(length, np.float32)
                else:
                    z = np.where(sides == r, 1.0, -1.0).astype(np.float32)
                if replay is not None:
                    replay.add(
                        ep_board[g, :length],
                        sides,
                        ep_reps[g, :length],
                        ep_pidx[g, :length],
                        ep_pp[g, :length],
                        z,
                    )
                stats.games += 1
                stats.positions += length
                stats.length_sum += length
                if done[g] or resign_now[g]:
                    if r == DRAW:
                        stats.draws += 1
                    elif r == 0:
                        stats.attacker_wins += 1
                    else:
                        stats.defender_wins += 1
                    if resign_now[g]:
                        stats.resigned += 1
                    elif would_resign_side[g] >= 0:
                        # Monitoring game played to the end: the prediction
                        # was wrong iff the flagged mover did NOT lose.
                        stats.resign_checked += 1
                        if r != 1 - int(would_resign_side[g]):
                            stats.resign_false_positive += 1
                else:
                    stats.truncated += 1
                    stats.draws += 1
                    if would_resign_side[g] >= 0:
                        stats.resign_checked += 1
                        stats.resign_false_positive += 1  # draw, not a loss
                completed += 1
                ep_len[g] = 0
                resign_streak[g] = 0  # both sides
                would_resign_side[g] = -1
                resign_enabled[g] = np_rng.rand() >= cfg.resign_disable_frac

            # Reset finished/truncated/resigned games on device — skipped
            # entirely on the (majority of) moves where no game ended, saving
            # a per-leaf dispatch each.
            ended = done | truncate | resign_now
            if ended.any():
                reset_mask = jnp.asarray(ended)

                def where_reset(f, c):
                    d = reset_mask.reshape(
                        reset_mask.shape + (1,) * (c.ndim - 1)
                    )
                    return jnp.where(d, f, c)

                states = jax.tree_util.tree_map(where_reset, fresh, states)

        return stats
