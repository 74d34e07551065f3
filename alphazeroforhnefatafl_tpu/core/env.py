"""Vectorized pure-JAX tafl environment.

Array re-design of the reference's Rust game engine
(``/root/reference/game/game/logic.rs``): instead of per-tile iterators,
pointer flood fills and early-exit scans, every rule is a fixed-shape array
program — jit-able, vmap-able over thousands of lockstep games and shardable
over a device mesh.

Key representation decisions:

- Board: ``int8[N, N]`` cell codes (0 empty, 1 attacker soldier, 2 defender
  soldier, 3 king). The successor of the reference's bitfield board
  (``game/board/state.rs:116-121``); planes are friendlier to XLA fusion than
  bit-packed words, and the king position is derived, not stored in spare
  bits (``board/state.rs:127-147``).
- Actions: ``from_flat * 4(N-1) + dir * (N-1) + (dist-1)`` — the fixed-size
  encoding of ``Play { from, AxisOffset }`` (``game/play.rs:23-27``); see
  :mod:`alphazeroforhnefatafl_tpu.core.actions`.
- Legal moves: the per-piece ray walk of ``ValidPlayIterator``
  (``game/play.rs:189-225``) becomes a vectorized shifted cumulative-AND over
  "passable" boards, one unrolled scan per direction.
- Flood fills (``logic.rs:309-401``) become bounded 4-neighbor dilation
  fixpoints under ``lax.while_loop``.
- The ruleset is static (trace-time): each :class:`Ruleset` specializes its
  own compiled XLA program.

Differentially tested against the Python oracle
(:mod:`alphazeroforhnefatafl_tpu.core.oracle`), which transcribes the Rust
semantics tile by tile.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .fen import board_from_fen
from ..utils.pytree import pytree_dataclass
from .rules import (
    CELL_ATT,
    CELL_DEF,
    CELL_KING,
    EMPTY,
    PIECE_CLASSES,
    EnclosureWinRules,
    KingAttack,
    KingStrength,
    PieceType,
    Ruleset,
    Side,
    ThroneRule,
    WinReason,
)

# Piece-class indices (board cell code - 1).
CLS_ATT, CLS_DEF, CLS_KING = 0, 1, 2

# Direction tables matching actions.DIR_OFFSETS: up, down, left, right.
DR = np.array([-1, 1, 0, 0], dtype=np.int32)
DC = np.array([0, 0, -1, 1], dtype=np.int32)

# Result codes.
ONGOING = -1
WIN_ATTACKER = 0
WIN_DEFENDER = 1
DRAW = 2

# Win/draw reason codes (match rules.WinReason; draws offset by 16).
R_NONE = -1
R_DRAW_REPETITION = 16
R_DRAW_NO_PLAYS = 17


class KernelDispatch(NamedTuple):
    """How a game-batched move program should run under a multi-device mesh.

    GSPMD refuses to batch-partition the search's ``top_k``/``scatter-add``
    families: under a >1-device dp mesh, plain ``jit`` all-gathers the game
    batch around them (measured on the 8-device CPU mesh: seven all-gathers
    per move, some ``f32[B, A]``-sized). Production move functions
    (self-play actor, arena) therefore run their WHOLE body — root mask,
    search waves, env steps, policy extraction — inside one ``shard_map``
    over the dp axis when a dispatch is active, so every device advances its
    own games with zero cross-device traffic (pure DP of games, SURVEY.md
    §5).
    """

    mesh: Any
    axis: str = "dp"


def auto_dispatch(sharding) -> "KernelDispatch | None":
    """The production dispatch rule for a game batch with ``sharding``:
    whole-move ``shard_map`` on a >1-device mesh; ``None`` on a single
    device, where the single-program path stays byte-stable for the compile
    cache."""
    if sharding is None:
        return None
    mesh = sharding.mesh
    if mesh.size <= 1:
        return None
    # spec[0] can be None (replicated batch axis, e.g. P(None)) — then there
    # is nothing to shard the games over and a shard_map with a None axis
    # would make every device redundantly step the whole batch.
    axis = sharding.spec[0] if sharding.spec else "dp"
    if axis is None:
        return None
    if isinstance(axis, tuple):  # P(("dp", "x"), ...) — not a layout we emit
        axis = axis[0]
    if axis not in mesh.axis_names:
        return None
    return KernelDispatch(mesh=mesh, axis=axis)


@pytree_dataclass
class EnvState:
    """Per-game mutable state (``game/game/state.rs:119-133``), as a pytree.

    The repetition tracker (``state.rs:41-114``) is carried as a 4-slot ring
    of encoded ShortPlayRecords plus per-side counters and mid-pair toggles.
    """

    board: jax.Array  # int8[N, N]
    side_to_play: jax.Array  # int32 scalar: 0 attacker, 1 defender
    recent_plays: jax.Array  # int32[4] encoded records, -1 = empty
    rep_first_i: jax.Array  # int32 ring index
    reps: jax.Array  # int32[2] consecutive repetition counts (att, def)
    mid_pair: jax.Array  # bool[2]
    plays_since_capture: jax.Array  # int32
    turn: jax.Array  # int32
    terminated: jax.Array  # bool
    result: jax.Array  # int32: ONGOING / WIN_ATTACKER / WIN_DEFENDER / DRAW
    reason: jax.Array  # int32: WinReason code, R_DRAW_*, or R_NONE


@pytree_dataclass
class StepInfo:
    """Effects of a step (``PlayEffects``, ``game/game/mod.rs:56-61``)."""

    captures: jax.Array  # bool[N, N] captured tiles
    n_captures: jax.Array  # int32
    terminated: jax.Array  # bool: game ended on this step
    result: jax.Array  # int32 result code
    reason: jax.Array  # int32 reason code
    reward_mover: jax.Array  # f32: +1 mover won, -1 mover lost, 0 otherwise
    legal_mask: jax.Array  # bool[A]: legal actions for the next player
    invalid: jax.Array  # bool: the supplied action was illegal (no-op applied)


@dataclass(frozen=True)
class _ClassCfg:
    """Static, per-piece-class rule constants derived from a Ruleset."""

    throne_entry_blocked: bool
    throne_pass_blocked: bool
    corner_entry_blocked: bool
    slow: bool
    hostile_throne: bool
    hostile_corner: bool
    hostile_edge: bool


def _class_cfg(rules: Ruleset, cls: int) -> _ClassCfg:
    piece = PIECE_CLASSES[cls]
    is_king = piece.piece_type == PieceType.KING
    tm = rules.throne_movement
    return _ClassCfg(
        throne_entry_blocked=(
            tm == ThroneRule.NO_ENTRY or (tm == ThroneRule.KING_ENTRY and not is_king)
        ),
        throne_pass_blocked=(
            tm == ThroneRule.NO_PASS or (tm == ThroneRule.KING_PASS and not is_king)
        ),
        corner_entry_blocked=not rules.may_enter_corners.contains(piece),
        slow=rules.slow_pieces.contains(piece),
        hostile_throne=rules.hostility.throne.contains(piece),
        hostile_corner=rules.hostility.corners.contains(piece),
        hostile_edge=rules.hostility.edge.contains(piece),
    )


def _shift2d(x: jax.Array, dr: int, dc: int, fill=False) -> jax.Array:
    """Static shift: ``out[r, c] = x[r + dr, c + dc]``, out-of-bounds -> fill.

    Implemented as pad+slice so XLA fuses it into surrounding elementwise ops.
    """
    n0, n1 = x.shape[-2], x.shape[-1]
    pr, pc = abs(dr), abs(dc)
    pad = [(0, 0)] * (x.ndim - 2) + [(pr, pr), (pc, pc)]
    padded = jnp.pad(x, pad, constant_values=fill)
    return jax.lax.slice_in_dim(
        jax.lax.slice_in_dim(padded, pr + dr, pr + dr + n0, axis=-2),
        pc + dc,
        pc + dc + n1,
        axis=-1,
    )


def _dilate4(x: jax.Array) -> jax.Array:
    """4-neighbor dilation (clipped at the board edge)."""
    return (
        x
        | _shift2d(x, 1, 0)
        | _shift2d(x, -1, 0)
        | _shift2d(x, 0, 1)
        | _shift2d(x, 0, -1)
    )


class TaflEnv:
    """A tafl environment specialized to one ruleset and starting board.

    All methods are pure functions of their inputs and safe under
    ``jax.jit`` / ``jax.vmap`` / ``shard_map`` (the env object itself carries
    only static configuration and numpy constants).
    """

    def __init__(self, rules: Ruleset, start_board_fen: str):
        self.rules = rules
        self._start_fen = start_board_fen
        start = board_from_fen(start_board_fen)
        self.n = int(start.shape[0])
        n = self.n
        self.num_actions = n * n * 4 * (n - 1)
        self._start_board = start

        # Geometry constants (game/board/geometry.rs:8-24).
        self.throne = (n // 2, n // 2)
        throne_mask = np.zeros((n, n), dtype=bool)
        throne_mask[self.throne] = True
        corner_mask = np.zeros((n, n), dtype=bool)
        for t in [(0, 0), (0, n - 1), (n - 1, 0), (n - 1, n - 1)]:
            corner_mask[t] = True
        edge_mask = np.zeros((n, n), dtype=bool)
        edge_mask[0, :] = edge_mask[-1, :] = edge_mask[:, 0] = edge_mask[:, -1] = True
        self.throne_mask = throne_mask
        self.corner_mask = corner_mask
        self.edge_mask = edge_mask

        # Static per-class rule constants.
        self.cls_cfg = tuple(_class_cfg(rules, c) for c in range(3))

        # Per-class static boards.
        self._special_hostile = np.stack(
            [
                (throne_mask & cfg.hostile_throne) | (corner_mask & cfg.hostile_corner)
                for cfg in self.cls_cfg
            ]
        )  # bool[3, N, N]: empty-special-tile hostility (logic.rs:76-82, in-bounds part)
        self._occupiable = np.stack(
            [
                ~(throne_mask & cfg.throne_entry_blocked)
                & ~(corner_mask & cfg.corner_entry_blocked)
                for cfg in self.cls_cfg
            ]
        )  # bool[3, N, N]: coords_occupiable ignoring occupancy (logic.rs:250-266)

    # Value identity: two envs with the same ruleset and starting FEN are
    # the same compiled program. This keys every lru_cache on the env
    # (the arena move-fn cache) by VALUE, so
    # repeated make_env(preset) calls in one process reuse traced/compiled
    # functions instead of re-tracing per instance.
    def __eq__(self, other):
        return (
            type(other) is TaflEnv
            and self.rules == other.rules
            and self._start_fen == other._start_fen
        )

    def __hash__(self):
        return hash((self.rules, self._start_fen))

    # ------------------------------------------------------------------
    # Construction / reset
    # ------------------------------------------------------------------

    def reset(self) -> EnvState:
        """Initial state (``GameState::new``, ``game/game/state.rs:136-145``)."""
        return EnvState(
            board=jnp.asarray(self._start_board, dtype=jnp.int8),
            side_to_play=jnp.int32(int(self.rules.starting_side)),
            recent_plays=jnp.full((4,), -1, dtype=jnp.int32),
            rep_first_i=jnp.int32(0),
            reps=jnp.zeros((2,), dtype=jnp.int32),
            mid_pair=jnp.zeros((2,), dtype=bool),
            plays_since_capture=jnp.int32(0),
            turn=jnp.int32(0),
            terminated=jnp.asarray(False),
            result=jnp.int32(ONGOING),
            reason=jnp.int32(R_NONE),
        )

    def reset_batch(self, batch_size: int) -> EnvState:
        """A batch of fresh games (leading axis added to every leaf)."""
        s = self.reset()
        return jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (batch_size,) + x.shape), s
        )

    # ------------------------------------------------------------------
    # Legal move generation
    # ------------------------------------------------------------------

    def _class_ray_mask(self, board: jax.Array, cls: int) -> jax.Array:
        """Legal-destination mask ``bool[N, N, 4, N-1]`` for a piece of class
        ``cls`` standing on each tile.

        Vectorization of ``ValidPlayIterator`` + ``validate_play_for_side``
        (``game/play.rs:189-225``, ``game/game/logic.rs:159-214``): for each
        direction, destination at distance k is legal iff all tiles at
        distances 1..k-1 are passable and the destination is occupiable and
        empty.
        """
        n = self.n
        cfg = self.cls_cfg[cls]
        empty = board == EMPTY
        dest_ok = empty & jnp.asarray(self._occupiable[cls])
        pass_ok = empty & ~jnp.asarray(self.throne_mask & cfg.throne_pass_blocked)
        # Corners are never passable (logic.rs:144-147); geometrically a ray
        # can only hit a corner as its final in-bounds tile, so no term needed.

        per_dir = []
        for d in range(4):
            dr, dc = int(DR[d]), int(DC[d])
            cum = jnp.ones((n, n), dtype=bool)
            ks = []
            max_dist = 1 if cfg.slow else n - 1
            for k in range(1, n):
                if k > max_dist:
                    ks.append(jnp.zeros((n, n), dtype=bool))
                    continue
                ks.append(_shift2d(dest_ok, dr * k, dc * k) & cum)
                cum = cum & _shift2d(pass_ok, dr * k, dc * k)
            per_dir.append(jnp.stack(ks, axis=-1))  # [N, N, N-1]
        return jnp.stack(per_dir, axis=-2)  # [N, N, 4, N-1]

    def legal_mask_for_side(self, board: jax.Array, side: jax.Array) -> jax.Array:
        """Full legal-action mask ``bool[A]`` for ``side`` on ``board``.

        The reference computes this lazily per piece
        (``game/main.rs:33-43``); here it is one fused array program.
        """
        # Group piece classes with identical static config to skip duplicate
        # ray scans (common: attacker and defender soldiers share rules).
        cfg_to_mask: Dict[Any, jax.Array] = {}

        def ray(cls: int) -> jax.Array:
            key = self.cls_cfg[cls]
            if key not in cfg_to_mask:
                cfg_to_mask[key] = self._class_ray_mask(board, cls)
            return cfg_to_mask[key]

        att_sel = (board == CELL_ATT) & (side == int(Side.ATTACKER))
        def_sel = (board == CELL_DEF) & (side == int(Side.DEFENDER))
        king_sel = (board == CELL_KING) & (side == int(Side.DEFENDER))
        mask = (
            (ray(CLS_ATT) & att_sel[:, :, None, None])
            | (ray(CLS_DEF) & def_sel[:, :, None, None])
            | (ray(CLS_KING) & king_sel[:, :, None, None])
        )
        return mask.reshape(self.num_actions)

    def legal_mask(self, state: EnvState) -> jax.Array:
        """Legal actions for the player to move; all-false when terminal."""
        m = self.legal_mask_for_side(state.board, state.side_to_play)
        return m & ~state.terminated

    def legal_mask_many(self, states: EnvState) -> jax.Array:
        """Batched root legal mask, ``vmap(legal_mask)``. Used by the
        self-play/arena root-mask sites; step-time masks come out of the step
        itself (``info.legal_mask``)."""
        return jax.vmap(self.legal_mask)(states)

    # ------------------------------------------------------------------
    # Hostility boards (logic.rs:76-114)
    # ------------------------------------------------------------------

    def _hostile_boards(self, board: jax.Array) -> jax.Array:
        """``bool[3, N, N]``: per subject class, which in-bounds tiles are
        hostile (``tile_hostile``, ``logic.rs:85-99``)."""
        empty = board == EMPTY
        king_hostile_when_enemy = self.rules.king_attack in (
            KingAttack.ARMED,
            KingAttack.ANVIL,
        )
        # Enemy-occupied terms.
        att_enemy = (board == CELL_DEF) | (
            (board == CELL_KING) if king_hostile_when_enemy else jnp.zeros_like(empty)
        )
        def_enemy = board == CELL_ATT
        special = jnp.asarray(self._special_hostile)
        return jnp.stack(
            [
                att_enemy | (empty & special[CLS_ATT]),
                def_enemy | (empty & special[CLS_DEF]),
                def_enemy | (empty & special[CLS_KING]),
            ]
        )

    def _coords_hostile(
        self, hostile: jax.Array, r: jax.Array, c: jax.Array, cls: jax.Array
    ) -> jax.Array:
        """``coords_hostile`` (``logic.rs:103-114``) with dynamic class index:
        out-of-bounds coordinates are hostile iff the edge is hostile to cls."""
        n = self.n
        in_b = (r >= 0) & (r < n) & (c >= 0) & (c < n)
        rc = jnp.clip(r, 0, n - 1)
        cc = jnp.clip(c, 0, n - 1)
        on_board = hostile[cls, rc, cc]
        edge_h = jnp.asarray(
            np.array([cfg.hostile_edge for cfg in self.cls_cfg], dtype=bool)
        )[cls]
        return jnp.where(in_b, on_board, edge_h)

    # ------------------------------------------------------------------
    # Captures (logic.rs:604-699, 859-879) and shieldwalls (471-569)
    # ------------------------------------------------------------------

    def _shieldwall_captures(
        self, board: jax.Array, side: jax.Array, tr: jax.Array, tc: jax.Array
    ) -> jax.Array:
        """Shieldwall capture mask ``bool[N, N]`` (``logic.rs:471-569``).

        The reference walks the destination's edge lane tile by tile
        (``logic.rs:485-528``); the walk continues exactly while tiles are
        "wall extenders" (enemy pinned from off-edge by a friendly piece, not
        a closing corner), so the scan reduces to finding the first
        non-extender tile in each direction and classifying it. All four edge
        lanes are scanned together and the active one selected with one-hot
        compares, which keeps the step free of data-dependent gathers at the
        cost of 4x the (trivial) lane arithmetic.
        """
        sw = self.rules.shieldwall
        n = self.n
        if sw is None:
            return jnp.zeros((n, n), dtype=bool)

        # Case priority mirrors logic.rs:538-549: row 0, row N-1, col 0, col N-1.
        case = jnp.where(
            tr == 0,
            0,
            jnp.where(tr == n - 1, 1, jnp.where(tc == 0, 2, jnp.where(tc == n - 1, 3, 4))),
        )

        # lanes[k]: the edge lane for case k; pins[k]: the lane one tile
        # off-edge (the "away_from_edge" side). Shapes [4, N].
        lanes = jnp.stack([board[0, :], board[n - 1, :], board[:, 0], board[:, n - 1]])
        pins = jnp.stack([board[1, :], board[n - 2, :], board[:, 1], board[:, n - 2]])
        pos0 = jnp.where(jnp.arange(4) < 2, tc, tr)[:, None]  # [4, 1]

        idx = jnp.arange(n)
        occupied = lanes != EMPTY
        lane_side = jnp.where(lanes == jnp.int8(CELL_ATT), 0, 1)
        friendly = occupied & (lane_side == side)
        enemy = occupied & (lane_side != side)
        pin_occ = pins != EMPTY
        pin_side = jnp.where(pins == jnp.int8(CELL_ATT), 0, 1)
        enemy_pinned = enemy & pin_occ & (pin_side == side)
        corner = (idx == 0) | (idx == n - 1)
        cc = corner & bool(sw.corners_may_close)
        ext = enemy_pinned & ~cc
        # Tiles that close the wall when hit (logic.rs:493-528): a friendly
        # piece, an empty closing corner, or a pinned enemy on a closing
        # corner (added to the wall *and* closing it).
        closer = friendly | (~occupied & cc) | (enemy_pinned & cc)

        def scan_dir(direction: int) -> Tuple[jax.Array, jax.Array]:
            """Returns (success bool[4], wall bool[4, N]) per edge lane."""
            if direction > 0:
                cand = ~ext & (idx > pos0)
                q = jnp.min(jnp.where(cand, idx, n), axis=-1)  # n = off-board
                q_in = q < n
            else:
                cand = ~ext & (idx < pos0)
                q = jnp.max(jnp.where(cand, idx, -1), axis=-1)  # -1 = off-board
                q_in = q >= 0
            q_onehot = idx == q[:, None]  # all-false lane when q is off-board
            close = q_in & jnp.any(q_onehot & closer, axis=-1)
            incl_q = q_in & jnp.any(q_onehot & enemy_pinned & cc, axis=-1)
            lo = jnp.minimum(pos0[:, 0], q)
            hi = jnp.maximum(pos0[:, 0], q)
            between = (idx > lo[:, None]) & (idx < hi[:, None])  # all extenders
            count = hi - lo - 1 + incl_q.astype(jnp.int32)
            success = close & (count >= 2)
            wall = between | (q_onehot & incl_q[:, None])
            return success, wall

        s_neg, w_neg = scan_dir(-1)
        s_pos, w_pos = scan_dir(+1)
        # Reference tries -1 first, then +1 (logic.rs:551-554).
        success = s_neg | s_pos
        wall = jnp.where(s_neg[:, None], w_neg, w_pos)

        # Filter by capturable piece classes (logic.rs:560-565) with boolean
        # algebra instead of an index gather.
        cap_att, cap_def, cap_king = (
            sw.captures.contains(p) for p in PIECE_CLASSES
        )
        cls_ok = (
            ((lanes == CELL_ATT) & cap_att)
            | ((lanes == CELL_DEF) & cap_def)
            | ((lanes == CELL_KING) & cap_king)
        )
        wall = wall & cls_ok & success[:, None]

        # Scatter each lane back to 2-D and select the active case.
        z = jnp.zeros((n, n), dtype=bool)
        lane2d = (
            z.at[0, :].set(wall[0]),
            z.at[n - 1, :].set(wall[1]),
            z.at[:, 0].set(wall[2]),
            z.at[:, n - 1].set(wall[3]),
        )
        out = z
        for k in range(4):
            out = out | (lane2d[k] & (case == k))
        return out

    def _captures(
        self,
        board: jax.Array,  # board with the play applied (board2)
        side: jax.Array,
        moving_cell: jax.Array,
        tr: jax.Array,
        tc: jax.Array,
        king_r: jax.Array,
        king_c: jax.Array,
    ) -> jax.Array:
        """Capture mask for a play (``get_captures``, ``logic.rs:604-699``)."""
        rules = self.rules
        n = self.n
        hostile = self._hostile_boards(board)

        # Is the moving piece allowed to initiate captures? (logic.rs:609-611)
        king_attacks = rules.king_attack in (KingAttack.ARMED, KingAttack.HAMMER)
        may_attack = (moving_cell != CELL_KING) | bool(king_attacks)

        # King status on the post-move board (logic.rs:225-245).
        thr_r, thr_c = self.throne
        king_beside_throne = (jnp.abs(king_r - thr_r) + jnp.abs(king_c - thr_c)) == 1
        king_on_throne = (king_r == thr_r) & (king_c == thr_c)
        if rules.king_strength == KingStrength.STRONG:
            king_strong = jnp.asarray(True)
        elif rules.king_strength == KingStrength.WEAK:
            king_strong = jnp.asarray(False)
        else:
            king_strong = king_beside_throne | king_on_throne

        # Strong-king-beside-throne special case precondition (logic.rs:621-632).
        special_rules_on = (
            rules.king_strength == KingStrength.STRONG_BY_THRONE
            and rules.throne_movement in (ThroneRule.NO_ENTRY, ThroneRule.KING_ENTRY)
        )

        # Linnaean capture precondition (logic.rs:859-879): king on throne and
        # exactly 3 of the throne's neighbors hostile to the king.
        if rules.linnaean_capture:
            linn_nbr_hostile = jnp.int32(0)
            for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                linn_nbr_hostile += hostile[CLS_KING, thr_r + dr, thr_c + dc].astype(
                    jnp.int32
                )
            linn_ok = (
                (side == int(Side.ATTACKER))
                & king_on_throne
                & (linn_nbr_hostile == 3)
            )
        else:
            linn_ok = jnp.asarray(False)

        cap = jnp.zeros((n, n), dtype=bool)
        for d in range(4):
            dr, dc = int(DR[d]), int(DC[d])
            nr, nc = tr + dr, tc + dc
            in_b = (nr >= 0) & (nr < n) & (nc >= 0) & (nc < n)
            nrc, ncc = jnp.clip(nr, 0, n - 1), jnp.clip(nc, 0, n - 1)
            q = board[nrc, ncc]
            q_is_def = (q == CELL_DEF) | (q == CELL_KING)
            enemy = in_b & jnp.where(
                side == int(Side.ATTACKER), q_is_def, q == CELL_ATT
            )
            q_cls = jnp.clip(q - 1, 0, 2).astype(jnp.int32)

            fr_r, fr_c = tr + 2 * dr, tc + 2 * dc
            far_hostile = self._coords_hostile(hostile, fr_r, fr_c, q_cls)

            # --- king target ---
            # Perpendicular hostility for a strong king (logic.rs:647-674).
            if dr == 0:
                p1 = self._coords_hostile(hostile, nrc + 1, ncc, jnp.int32(CLS_KING))
                p2 = self._coords_hostile(hostile, nrc - 1, ncc, jnp.int32(CLS_KING))
            else:
                p1 = self._coords_hostile(hostile, nrc, ncc + 1, jnp.int32(CLS_KING))
                p2 = self._coords_hostile(hostile, nrc, ncc - 1, jnp.int32(CLS_KING))
            perp_hostile = p1 & p2
            king_custodian = far_hostile & (~king_strong | perp_hostile)
            if special_rules_on:
                # All 4 neighbors of the king are the throne or hostile
                # (out-of-bounds neighbors are vacuously fine, as the
                # reference iterates in-bounds neighbors only).
                all_nbr = jnp.asarray(True)
                for dr2, dc2 in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    ar, ac = nrc + dr2, ncc + dc2
                    a_in = (ar >= 0) & (ar < n) & (ac >= 0) & (ac < n)
                    arc, acc = jnp.clip(ar, 0, n - 1), jnp.clip(ac, 0, n - 1)
                    is_throne = (arc == thr_r) & (acc == thr_c)
                    h = hostile[CLS_KING, arc, acc]
                    all_nbr &= ~a_in | is_throne | h
                king_special = king_beside_throne & all_nbr
            else:
                king_special = jnp.asarray(False)
            king_captured = king_special | king_custodian

            # --- soldier target ---
            if rules.linnaean_capture:
                linn_here = (
                    linn_ok
                    & (fr_r == thr_r)
                    & (fr_c == thr_c)
                    & (q == CELL_DEF)
                )
            else:
                linn_here = jnp.asarray(False)
            soldier_captured = far_hostile | linn_here

            captured = (
                enemy
                & may_attack
                & jnp.where(q == CELL_KING, king_captured, soldier_captured)
            )
            cap = cap.at[nrc, ncc].max(captured)

        # Shieldwall captures are merged in (logic.rs:691-696); unlike normal
        # captures they are not gated on the king's right to attack.
        cap = cap | self._shieldwall_captures(board, side, tr, tc)
        return cap

    # ------------------------------------------------------------------
    # Enclosures (logic.rs:309-463) / exit forts (572-601) / surround win
    # ------------------------------------------------------------------

    @staticmethod
    def _seg_spread(reach: jax.Array, allowed: jax.Array, axis: int) -> jax.Array:
        """Propagate ``reach`` along contiguous ``allowed`` runs of one axis.

        One segmented OR-scan in each direction: within every maximal run of
        allowed tiles, a run becomes fully reached if any of its tiles is.
        The combine op is the standard segmented-scan monoid (gate, value).
        """

        def combine(a, b):
            g1, v1 = a
            g2, v2 = b
            return g1 & g2, (v1 & g2) | v2

        axis = axis % reach.ndim  # reverse=True requires a nonnegative axis
        elems = (allowed, reach & allowed)
        _, fwd = jax.lax.associative_scan(combine, elems, axis=axis)
        _, bwd = jax.lax.associative_scan(combine, elems, axis=axis, reverse=True)
        return fwd | bwd

    def _flood(self, seed: jax.Array, allowed: jax.Array, fail_fn=None) -> jax.Array:
        """Connected component of ``allowed`` containing ``seed`` (4-conn).

        Fixpoint of row/column segmented-scan propagation replacing the
        reference's span flood fill (``logic.rs:309-401``): each pass spreads
        the region across whole runs at once, so the loop converges in
        O(#bends of the region) passes instead of O(diameter) dilations.

        ``fail_fn(reach) -> bool`` (optional) marks the fill as already
        doomed (e.g. the region touched a corner). Once true it stays true
        under the monotone growth of ``reach``, so the fill's growth is
        frozen — the lockstep batch's while loop runs only as long as its
        slowest *undecided* game, the batched analogue of the reference's
        early-abort flags (``logic.rs:346-374``). The returned partial region
        still contains the disqualifying tiles, so callers' final fail
        checks see the same verdict.
        """
        seed = seed & allowed

        def cond(carry):
            reach, changed = carry
            return changed

        def body(carry):
            reach, _ = carry
            a = allowed
            if fail_fn is not None:
                a = jnp.where(fail_fn(reach), reach, allowed)
            new = self._seg_spread(reach, a, axis=-1)
            new = self._seg_spread(new, a, axis=-2)
            return new, jnp.any(new != reach)

        reach, _ = jax.lax.while_loop(cond, body, (seed, jnp.asarray(True)))
        return reach

    def _enclosure_secure(
        self,
        board: jax.Array,
        hostile: jax.Array,
        boundary: jax.Array,  # bool[N,N] boundary pieces (all of one side)
        region: jax.Array,  # bool[N,N] enclosed region (occupied+unoccupied)
        boundary_cls: int,  # piece class of boundary pieces
        hostile_soldier_cls: int,  # soldier class of the opposing side
        inside_safe: bool,
        outside_safe: bool,
    ) -> jax.Array:
        """Vectorized ``enclosure_secure`` (``logic.rs:408-463``)."""
        if inside_safe and outside_safe:
            return jnp.asarray(True)
        cfg = self.cls_cfg[boundary_cls]
        special_h = jnp.asarray(self._special_hostile[boundary_cls])
        tile_h = hostile[boundary_cls]
        occupied = board != EMPTY
        occupiable_hs = jnp.asarray(self._occupiable[hostile_soldier_cls])

        axis_safe = []
        for axis_dirs in (((-1, 0), (1, 0)), ((0, -1), (0, 1))):
            dir_safe_any = jnp.zeros_like(boundary)
            for dr, dc in axis_dirs:
                # For each boundary cell, look at neighbor (r+dr, c+dc).
                n_inside = _shift2d(region, dr, dc, fill=False)
                n_special_h = _shift2d(special_h, dr, dc, fill=False)
                n_tile_h = _shift2d(tile_h, dr, dc, fill=False)
                n_occupied = _shift2d(occupied, dr, dc, fill=False)
                n_occupiable = _shift2d(occupiable_hs, dr, dc, fill=False)
                in_b = _shift2d(jnp.ones_like(boundary), dr, dc, fill=False)
                known_side = (inside_safe & n_inside) | (outside_safe & ~n_inside)
                safe_a = known_side & ~n_special_h
                safe_b = ~n_tile_h & (n_occupied | ~n_occupiable)
                oob_safe = ~in_b & (not cfg.hostile_edge)
                dir_safe_any = dir_safe_any | (in_b & (safe_a | safe_b)) | oob_safe
            axis_safe.append(dir_safe_any)
        secure_cell = axis_safe[0] & axis_safe[1]
        return ~jnp.any(boundary & ~secure_cell)

    def _surround_win(
        self,
        board: jax.Array,
        hostile: jax.Array,
        king_r: jax.Array,
        king_c: jax.Array,
        live: jax.Array,
    ) -> jax.Array:
        """Attacker enclosure win (``logic.rs:720-734``).

        ``live`` gates the fill's seed: a game where the outcome cannot apply
        (defender just moved) contributes zero flood passes to the lockstep
        batch's shared while loop.
        """
        rules = self.rules
        assert rules.enclosure_win is not None
        n = self.n
        defenders = (board == CELL_DEF) | (board == CELL_KING)
        allowed = (board == EMPTY) | defenders
        seed = (jnp.zeros((n, n), dtype=bool).at[king_r, king_c].set(True)) & live

        fail_mask = jnp.asarray(self.corner_mask)  # abort_on_corner
        if rules.enclosure_win == EnclosureWinRules.WITHOUT_EDGE_ACCESS:
            fail_mask = fail_mask | jnp.asarray(self.edge_mask)
        reach = self._flood(
            seed, allowed, fail_fn=lambda r: jnp.any(r & fail_mask)
        )
        fail = jnp.any(reach & jnp.asarray(self.corner_mask))
        if rules.enclosure_win == EnclosureWinRules.WITHOUT_EDGE_ACCESS:
            fail = fail | jnp.any(reach & jnp.asarray(self.edge_mask))
        boundary = _dilate4(reach) & ~reach & (board == CELL_ATT)
        all_defenders_in = jnp.sum(reach & defenders) == jnp.sum(defenders)
        secure = self._enclosure_secure(
            board,
            hostile,
            boundary,
            reach,
            boundary_cls=CLS_ATT,
            hostile_soldier_cls=CLS_DEF,
            inside_safe=False,
            outside_safe=True,
        )
        return ~fail & all_defenders_in & secure

    def _exit_fort(
        self,
        board: jax.Array,
        hostile: jax.Array,
        king_r: jax.Array,
        king_c: jax.Array,
        live: jax.Array,
    ) -> jax.Array:
        """Exit-fort detection (``logic.rs:572-601``).

        The fill only runs where it can matter (defender just moved AND the
        king is at an edge — the reference's first check, ``logic.rs:575``);
        other games get an empty seed and cost the batch nothing.
        """
        n = self.n
        king_at_edge = (
            (king_r == 0) | (king_r == n - 1) | (king_c == 0) | (king_c == n - 1)
        )
        empty = board == EMPTY
        king_seed = jnp.zeros((n, n), dtype=bool).at[king_r, king_c].set(True)
        seed = king_seed & live & king_at_edge
        # Enclosed pieces: king only; fill region is king + connected empties.
        allowed = empty | king_seed
        attackers = board == CELL_ATT
        corner = jnp.asarray(self.corner_mask)
        reach = self._flood(
            seed,
            allowed,
            fail_fn=lambda r: jnp.any(_dilate4(r) & attackers) | jnp.any(r & corner),
        )
        dil = _dilate4(reach)
        # Attacker adjacent to (or inside) the region kills the fort: the
        # flood scan hits a piece that can neither enclose nor be enclosed
        # (logic.rs:285-292 returning None).
        fail_neither = jnp.any(dil & (board == CELL_ATT))
        fail_corner = jnp.any(reach & jnp.asarray(self.corner_mask))
        boundary = dil & ~reach & (board == CELL_DEF)
        # King must have an empty in-bounds neighbor (logic.rs:590-592).
        king_free = jnp.asarray(False)
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ar, ac = king_r + dr, king_c + dc
            in_b = (ar >= 0) & (ar < n) & (ac >= 0) & (ac < n)
            arc, acc = jnp.clip(ar, 0, n - 1), jnp.clip(ac, 0, n - 1)
            king_free = king_free | (in_b & (board[arc, acc] == EMPTY))
        secure = self._enclosure_secure(
            board,
            hostile,
            boundary,
            reach,
            boundary_cls=CLS_DEF,
            hostile_soldier_cls=CLS_ATT,
            inside_safe=True,
            outside_safe=False,
        )
        return king_at_edge & ~fail_neither & ~fail_corner & king_free & secure

    # ------------------------------------------------------------------
    # Step
    # ------------------------------------------------------------------

    def step(
        self, state: EnvState, action: jax.Array, *, validate: bool = True
    ) -> Tuple[EnvState, StepInfo]:
        """Apply one action (``do_valid_play``, ``logic.rs:782-820``).

        With ``validate=True`` (default) the action is checked against the
        full legal mask; illegal actions (or stepping a terminated game)
        leave the state unchanged and set ``info.invalid``. Pass
        ``validate=False`` on hot paths that already mask actions (MCTS,
        self-play) to skip the extra ray scan — mirroring the reference's
        ``do_valid_play`` fast path vs ``do_play`` (``logic.rs:782,827``).
        """
        action = jnp.asarray(action, dtype=jnp.int32)
        ap = self._apply_play(state, action, validate=validate)
        return self._finish_step(state, action, ap)

    def _apply_play(
        self, state: EnvState, action: jax.Array, *, validate: bool
    ) -> Dict[str, jax.Array]:
        """Array phase of a step: decode, move, capture (no outcome logic)."""
        n = self.n
        board = state.board
        side = state.side_to_play

        per_tile = 4 * (n - 1)
        from_flat = action // per_tile
        rem = action % per_tile
        d = rem // (n - 1)
        dist = rem % (n - 1) + 1
        fr, fc = from_flat // n, from_flat % n
        dr, dc = jnp.asarray(DR)[d], jnp.asarray(DC)[d]
        tr, tc = fr + dr * dist, fc + dc * dist
        to_in_bounds = (tr >= 0) & (tr < n) & (tc >= 0) & (tc < n)
        trc, tcc = jnp.clip(tr, 0, n - 1), jnp.clip(tc, 0, n - 1)

        moving_cell = board[fr, fc]
        moving_side = jnp.where(moving_cell == CELL_ATT, 0, 1)
        valid = (
            ~state.terminated
            & to_in_bounds
            & (moving_cell != EMPTY)
            & (moving_side == side)
        )
        if validate:
            valid = valid & self.legal_mask_for_side(board, side)[action]

        # Move the piece (board/state.rs:218-223).
        board2 = board.at[fr, fc].set(EMPTY).at[trc, tcc].set(moving_cell)
        # King position on the post-move board (the reference's king-nibble,
        # board/state.rs:127-147, derived instead of stored).
        kflat = jnp.argmax((board2 == CELL_KING).reshape(-1))
        king_r, king_c = kflat // n, kflat % n

        cap = self._captures(board2, side, moving_cell, trc, tcc, king_r, king_c)
        board3 = jnp.where(cap, jnp.int8(EMPTY), board2)
        return dict(
            valid=valid,
            moving_cell=moving_cell,
            trc=trc,
            tcc=tcc,
            king_r=king_r,
            king_c=king_c,
            board3=board3,
            cap=cap,
            king_captured=cap[king_r, king_c],
        )

    def _finish_step(
        self, state: EnvState, action: jax.Array, ap: Dict[str, jax.Array]
    ) -> Tuple[EnvState, StepInfo]:
        """Outcome phase of a step: repetition, flood-fill outcomes, priority
        select, freeze, info."""
        rules = self.rules
        n = self.n
        side = state.side_to_play
        valid = ap["valid"]
        moving_cell = ap["moving_cell"]
        trc, tcc = ap["trc"], ap["tcc"]
        king_r, king_c = ap["king_r"], ap["king_c"]
        board3 = ap["board3"]
        cap = ap["cap"]
        captured_any = jnp.any(cap)
        n_captures = jnp.sum(cap).astype(jnp.int32)
        king_captured = ap["king_captured"]

        # --- repetition tracking (state.rs:92-113) ---
        rec = side + 2 * captured_any.astype(jnp.int32) + 4 * action
        oldest = state.recent_plays[state.rep_first_i]
        match = (~captured_any) & (oldest == rec)
        mid = state.mid_pair[side]
        incr = match & ~mid
        new_rep_side = jnp.where(match, state.reps[side] + incr.astype(jnp.int32), 0)
        reps = state.reps.at[side].set(new_rep_side)
        new_mid_side = jnp.where(match, ~mid, False)
        mid_pair = state.mid_pair.at[side].set(new_mid_side)
        recent = state.recent_plays.at[state.rep_first_i].set(rec)
        rep_first_i = (state.rep_first_i + 1) % 4

        # plays_since_capture increments on non-capturing plays and is never
        # reset, matching the reference exactly (logic.rs:797-799).
        psc = state.plays_since_capture + (~captured_any).astype(jnp.int32)

        # --- outcome (logic.rs:702-771), evaluated on board3 ---
        n_att = jnp.sum(board3 == CELL_ATT)
        n_def = jnp.sum((board3 == CELL_DEF) | (board3 == CELL_KING))
        other_count = jnp.where(side == int(Side.ATTACKER), n_def, n_att)
        o_all_captured = other_count == 0

        is_attacker = side == int(Side.ATTACKER)
        o_king_captured = is_attacker & king_captured
        if rules.enclosure_win is not None:
            o_enclosed = is_attacker & self._surround_win(
                board3,
                self._hostile_boards(board3),
                king_r,
                king_c,
                live=is_attacker,
            )
        else:
            o_enclosed = jnp.asarray(False)

        is_defender = ~is_attacker
        to_at_edge = (trc == 0) | (trc == n - 1) | (tcc == 0) | (tcc == n - 1)
        to_at_corner = jnp.asarray(self.corner_mask)[trc, tcc]
        escape_tile = to_at_edge if rules.edge_escape else to_at_corner
        o_king_escaped = is_defender & (moving_cell == CELL_KING) & escape_tile
        if rules.exit_fort:
            o_exit_fort = is_defender & self._exit_fort(
                board3,
                self._hostile_boards(board3),
                king_r,
                king_c,
                live=is_defender,
            )
        else:
            o_exit_fort = jnp.asarray(False)

        if rules.repetition_rule is not None:
            o_repetition = reps[side] >= rules.repetition_rule.n_repetitions
            rep_is_loss = rules.repetition_rule.is_loss
        else:
            o_repetition = jnp.asarray(False)
            rep_is_loss = False

        # Opponent legal moves on the post-capture board double as the
        # NoPlays check (logic.rs:760-768) and the next root policy mask.
        next_mask = self.legal_mask_for_side(board3, 1 - side)
        o_no_plays = ~jnp.any(next_mask)

        # Priority select (the reference's early returns, logic.rs:709-768).
        win_side = side  # for AllCaptured / NoPlays wins
        other = 1 - side

        def _res(win: jax.Array) -> jax.Array:
            return win.astype(jnp.int32)

        candidates = [
            (o_all_captured, _res(win_side), jnp.int32(WinReason.ALL_CAPTURED)),
            (o_king_captured, jnp.int32(WIN_ATTACKER), jnp.int32(WinReason.KING_CAPTURED)),
            (o_enclosed, jnp.int32(WIN_ATTACKER), jnp.int32(WinReason.ENCLOSED)),
            (o_king_escaped, jnp.int32(WIN_DEFENDER), jnp.int32(WinReason.KING_ESCAPED)),
            (o_exit_fort, jnp.int32(WIN_DEFENDER), jnp.int32(WinReason.EXIT_FORT)),
            (
                o_repetition,
                _res(other) if rep_is_loss else jnp.int32(DRAW),
                jnp.int32(WinReason.REPETITION) if rep_is_loss else jnp.int32(R_DRAW_REPETITION),
            ),
            (
                o_no_plays,
                jnp.int32(DRAW) if rules.draw_on_no_plays else _res(win_side),
                jnp.int32(R_DRAW_NO_PLAYS) if rules.draw_on_no_plays else jnp.int32(WinReason.NO_PLAYS),
            ),
        ]
        result = jnp.int32(ONGOING)
        reason = jnp.int32(R_NONE)
        done = jnp.asarray(False)
        for cond_i, res_i, reason_i in candidates:
            take = cond_i & ~done
            result = jnp.where(take, res_i, result)
            reason = jnp.where(take, reason_i, reason)
            done = done | cond_i

        # --- freeze + info ---
        reward_mover = jnp.where(
            result == side, 1.0, jnp.where(result == other, -1.0, 0.0)
        ).astype(jnp.float32)

        new_state = EnvState(
            board=board3,
            side_to_play=other,
            recent_plays=recent,
            rep_first_i=rep_first_i,
            reps=reps,
            mid_pair=mid_pair,
            plays_since_capture=psc,
            turn=state.turn + 1,
            terminated=done,
            result=result,
            reason=reason,
        )
        # Invalid action or terminal state: freeze.
        new_state = jax.tree_util.tree_map(
            lambda new, old: jnp.where(valid, new, old), new_state, state
        )
        info = StepInfo(
            captures=cap & valid,
            n_captures=jnp.where(valid, n_captures, 0),
            terminated=done & valid,
            result=jnp.where(valid, result, state.result),
            reason=jnp.where(valid, reason, state.reason),
            reward_mover=jnp.where(valid, reward_mover, 0.0),
            legal_mask=next_mask & ~done & valid,
            invalid=~valid,
        )
        return new_state, info

    def step_many(
        self, states: EnvState, actions: jax.Array, *, validate: bool = False
    ) -> Tuple[EnvState, StepInfo]:
        """Batched step, ``vmap(step)``. Under a >1-device dp mesh the
        production callers run their whole move function inside
        ``shard_map`` (see :class:`KernelDispatch`), so this executes
        per-shard."""
        return jax.vmap(lambda s, a: self.step(s, a, validate=validate))(
            states, actions
        )

    # ------------------------------------------------------------------
    # Observation (NN input planes)
    # ------------------------------------------------------------------

    def observe(self, state: EnvState) -> jax.Array:
        """NN input planes ``float32[N, N, C]`` (NHWC layout).

        Successor of the reference's ``board_to_matrix`` sketch
        (``game/main.rs:55-83``), fixing its side-blind encoding: attacker,
        defender and king get separate planes, plus special tiles and
        side-to-move / repetition context.
        """
        b = state.board
        side = state.side_to_play.astype(jnp.float32)
        planes = [
            (b == CELL_ATT).astype(jnp.float32),
            ((b == CELL_DEF) | (b == CELL_KING)).astype(jnp.float32),
            (b == CELL_KING).astype(jnp.float32),
            jnp.asarray(self.throne_mask | self.corner_mask, dtype=jnp.float32),
            jnp.full((self.n, self.n), side, dtype=jnp.float32),
            jnp.full(
                (self.n, self.n),
                state.reps[state.side_to_play].astype(jnp.float32) / 3.0,
                dtype=jnp.float32,
            ),
        ]
        return jnp.stack(planes, axis=-1)

    @property
    def num_observation_planes(self) -> int:
        return 6


@functools.lru_cache(maxsize=None)
def make_env(preset: str) -> TaflEnv:
    """Construct an env from a named preset (see ``rules.PRESETS``)."""
    from .rules import PRESETS

    rules, board = PRESETS[preset]
    return TaflEnv(rules, board)
