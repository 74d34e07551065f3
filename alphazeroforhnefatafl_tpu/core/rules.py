"""Declarative tafl rule configuration.

Array-friendly re-design of the reference's rules model
(``/root/reference/game/rules.rs:6-117``, ``game/pieces.rs:13-273``) and rule
presets (``game/preset.rs:12-134``). Rulesets are frozen, hashable dataclasses:
a :class:`Ruleset` is closed over at JAX trace time, so every ruleset
specializes its own compiled XLA program (the config system of the reference,
where ``Ruleset`` is a const struct, maps to static trace-time configuration
here).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Optional, Tuple


class Side(enum.IntEnum):
    """The two sides of a tafl game (``game/pieces.rs:13-27``)."""

    ATTACKER = 0
    DEFENDER = 1

    @property
    def other(self) -> "Side":
        return Side.DEFENDER if self is Side.ATTACKER else Side.ATTACKER


class PieceType(enum.IntEnum):
    """Piece-type bitflag values (``game/pieces.rs:31-38``)."""

    KING = 0b0000_0001
    SOLDIER = 0b0000_0010
    KNIGHT = 0b0000_0100
    COMMANDER = 0b0000_1000
    GUARD = 0b0001_0000
    MERCENARY = 0b0010_0000


@dataclass(frozen=True)
class Piece:
    """A piece belonging to a particular side (``game/pieces.rs:62-98``)."""

    piece_type: PieceType
    side: Side

    @staticmethod
    def king() -> "Piece":
        return Piece(PieceType.KING, Side.DEFENDER)

    @staticmethod
    def attacker(piece_type: PieceType = PieceType.SOLDIER) -> "Piece":
        return Piece(piece_type, Side.ATTACKER)

    @staticmethod
    def defender(piece_type: PieceType = PieceType.SOLDIER) -> "Piece":
        return Piece(piece_type, Side.DEFENDER)


KING = Piece.king()
ATT_SOLDIER = Piece.attacker()
DEF_SOLDIER = Piece.defender()

# Board-plane cell codes used throughout the JAX env and the oracle.
EMPTY = 0
CELL_ATT = 1  # attacker soldier
CELL_DEF = 2  # defender soldier
CELL_KING = 3  # king (defender)

#: The three piece classes of a "basic" board, indexed by ``cell_code - 1``.
PIECE_CLASSES: Tuple[Piece, ...] = (ATT_SOLDIER, DEF_SOLDIER, KING)


def piece_to_cell(piece: Piece) -> int:
    """Map a basic piece to its board cell code."""
    if piece.piece_type == PieceType.KING:
        if piece.side != Side.DEFENDER:
            raise ValueError("basic boards support only a defender king")
        return CELL_KING
    if piece.piece_type != PieceType.SOLDIER:
        raise ValueError(f"basic boards support only soldiers and a king, got {piece}")
    return CELL_ATT if piece.side == Side.ATTACKER else CELL_DEF


def cell_to_piece(cell: int) -> Optional[Piece]:
    if cell == EMPTY:
        return None
    return PIECE_CLASSES[cell - 1]


@dataclass(frozen=True)
class PieceSet:
    """A set of (piece type x side) combinations, as a 16-bit mask.

    Bit layout mirrors ``game/pieces.rs:157-273``: attacker piece types in the
    low byte, defender piece types in the high byte.
    """

    mask: int = 0

    @staticmethod
    def none() -> "PieceSet":
        return PieceSet(0)

    @staticmethod
    def all() -> "PieceSet":
        return PieceSet(0xFFFF)

    @staticmethod
    def from_piece_type(*piece_types: PieceType) -> "PieceSet":
        """Include the given piece types on *both* sides (``pieces.rs:226-229``)."""
        m = 0
        for pt in piece_types:
            m |= int(pt) | (int(pt) << 8)
        return PieceSet(m)

    @staticmethod
    def from_piece(*pieces: Piece) -> "PieceSet":
        m = 0
        for p in pieces:
            m |= int(p.piece_type) << (8 * int(p.side))
        return PieceSet(m)

    @staticmethod
    def from_side(side: Side) -> "PieceSet":
        """All piece types of one side (``pieces.rs:204-208``)."""
        return PieceSet(0xFF << (8 * int(side)))

    def contains(self, piece: Piece) -> bool:
        return bool(self.mask & (int(piece.piece_type) << (8 * int(piece.side))))

    def contains_cell(self, cell: int) -> bool:
        """Whether the set contains the piece class of a board cell code."""
        if cell == EMPTY:
            return False
        return self.contains(PIECE_CLASSES[cell - 1])

    def class_tuple(self) -> Tuple[bool, bool, bool]:
        """Static per-piece-class membership (att soldier, def soldier, king)."""
        return tuple(self.contains(p) for p in PIECE_CLASSES)  # type: ignore[return-value]

    def __or__(self, other: "PieceSet") -> "PieceSet":
        return PieceSet(self.mask | other.mask)


class ThroneRule(enum.IntEnum):
    """Who may occupy/pass through the throne (``game/rules.rs:6-17``)."""

    NO_THRONE = 0
    NO_PASS = 1
    KING_PASS = 2
    NO_ENTRY = 3
    KING_ENTRY = 4


class KingStrength(enum.IntEnum):
    """When the king must be fully surrounded to be captured (``rules.rs:22-30``)."""

    STRONG = 0
    STRONG_BY_THRONE = 1
    WEAK = 2


class KingAttack(enum.IntEnum):
    """Whether the king may participate in captures (``rules.rs:34-42``)."""

    ARMED = 0
    ANVIL = 1
    HAMMER = 2


class EnclosureWinRules(enum.IntEnum):
    """When the attacker wins by enclosing all defenders (``rules.rs:64-69``)."""

    WITH_EDGE_ACCESS = 0
    WITHOUT_EDGE_ACCESS = 1


@dataclass(frozen=True)
class HostilityRules:
    """What special tiles are hostile to what pieces (``rules.rs:47-51``)."""

    throne: PieceSet
    corners: PieceSet
    edge: PieceSet


@dataclass(frozen=True)
class ShieldwallRules:
    """Shieldwall capture rules (``rules.rs:55-60``)."""

    corners_may_close: bool
    captures: PieceSet


@dataclass(frozen=True)
class RepetitionRule:
    """Consequence of repeated plays (``rules.rs:73-79``)."""

    n_repetitions: int
    is_loss: bool


@dataclass(frozen=True)
class Ruleset:
    """A full set of rules for a tafl game (``game/rules.rs:83-117``).

    Frozen and hashable so it can serve as a static (trace-time) argument to
    jitted environment functions.
    """

    edge_escape: bool
    king_strength: KingStrength
    king_attack: KingAttack
    shieldwall: Optional[ShieldwallRules]
    exit_fort: bool
    throne_movement: ThroneRule
    may_enter_corners: PieceSet
    hostility: HostilityRules
    slow_pieces: PieceSet
    starting_side: Side
    enclosure_win: Optional[EnclosureWinRules]
    repetition_rule: Optional[RepetitionRule]
    draw_on_no_plays: bool
    linnaean_capture: bool

    def with_(self, **kwargs) -> "Ruleset":
        """Struct-update-style override (mirrors Rust ``Ruleset { x, ..BASE }``)."""
        return replace(self, **kwargs)


# ---------------------------------------------------------------------------
# Presets (``game/preset.rs:12-124``)
# ---------------------------------------------------------------------------

#: Rules for Copenhagen Hnefatafl (``game/preset.rs:12-34``).
COPENHAGEN = Ruleset(
    edge_escape=False,
    king_strength=KingStrength.STRONG,
    king_attack=KingAttack.ARMED,
    shieldwall=ShieldwallRules(
        corners_may_close=True, captures=PieceSet.from_piece_type(PieceType.SOLDIER)
    ),
    exit_fort=True,
    throne_movement=ThroneRule.KING_ENTRY,
    may_enter_corners=PieceSet.from_piece_type(PieceType.KING),
    hostility=HostilityRules(
        throne=PieceSet.all(),
        corners=PieceSet.from_piece_type(PieceType.SOLDIER),
        edge=PieceSet.none(),
    ),
    slow_pieces=PieceSet.none(),
    starting_side=Side.ATTACKER,
    enclosure_win=EnclosureWinRules.WITHOUT_EDGE_ACCESS,
    repetition_rule=RepetitionRule(n_repetitions=3, is_loss=True),
    draw_on_no_plays=False,
    linnaean_capture=False,
)

#: Rules for Federation Brandubh (``game/preset.rs:37-56``).
BRANDUBH = Ruleset(
    edge_escape=False,
    king_strength=KingStrength.STRONG_BY_THRONE,
    king_attack=KingAttack.ARMED,
    shieldwall=None,
    exit_fort=False,
    throne_movement=ThroneRule.KING_ENTRY,
    may_enter_corners=PieceSet.from_piece_type(PieceType.KING),
    hostility=HostilityRules(
        throne=PieceSet.from_piece_type(PieceType.SOLDIER),
        corners=PieceSet.all(),
        edge=PieceSet.none(),
    ),
    slow_pieces=PieceSet.none(),
    starting_side=Side.ATTACKER,
    enclosure_win=EnclosureWinRules.WITHOUT_EDGE_ACCESS,
    repetition_rule=RepetitionRule(n_repetitions=3, is_loss=True),
    draw_on_no_plays=False,
    linnaean_capture=False,
)

#: Rules for Magpie (``game/preset.rs:59-78``).
MAGPIE = Ruleset(
    edge_escape=False,
    king_strength=KingStrength.STRONG,
    king_attack=KingAttack.ARMED,
    shieldwall=None,
    exit_fort=False,
    throne_movement=ThroneRule.KING_ENTRY,
    may_enter_corners=PieceSet.from_piece_type(PieceType.KING),
    hostility=HostilityRules(
        throne=PieceSet.all(),
        corners=PieceSet.all(),
        edge=PieceSet.none(),
    ),
    slow_pieces=PieceSet.from_piece_type(PieceType.KING),
    starting_side=Side.ATTACKER,
    enclosure_win=None,
    repetition_rule=None,
    draw_on_no_plays=False,
    linnaean_capture=False,
)

#: Rules for Linnaeus Tablut (``game/preset.rs:81-100``).
TABLUT = Ruleset(
    edge_escape=True,
    king_strength=KingStrength.STRONG_BY_THRONE,
    king_attack=KingAttack.ARMED,
    shieldwall=None,
    exit_fort=False,
    throne_movement=ThroneRule.NO_ENTRY,
    may_enter_corners=PieceSet.all(),
    hostility=HostilityRules(
        throne=PieceSet.all(),
        corners=PieceSet.none(),
        edge=PieceSet.none(),
    ),
    slow_pieces=PieceSet.none(),
    starting_side=Side.ATTACKER,
    enclosure_win=None,
    repetition_rule=RepetitionRule(n_repetitions=3, is_loss=False),
    draw_on_no_plays=True,
    linnaean_capture=True,
)

#: Rules for Koch Hnefatafl (``game/preset.rs:105-124``).
KOCH = Ruleset(
    edge_escape=False,
    king_strength=KingStrength.STRONG_BY_THRONE,
    king_attack=KingAttack.ARMED,
    shieldwall=None,
    exit_fort=False,
    throne_movement=ThroneRule.KING_ENTRY,
    may_enter_corners=PieceSet.from_piece_type(PieceType.KING),
    hostility=HostilityRules(
        throne=PieceSet.all(),
        corners=PieceSet.from_piece_type(PieceType.SOLDIER),
        edge=PieceSet.none(),
    ),
    slow_pieces=PieceSet.none(),
    starting_side=Side.ATTACKER,
    enclosure_win=EnclosureWinRules.WITHOUT_EDGE_ACCESS,
    repetition_rule=RepetitionRule(n_repetitions=3, is_loss=True),
    draw_on_no_plays=False,
    linnaean_capture=False,
)


class BOARDS:
    """Starting positions as FEN strings (``game/preset.rs:127-134``)."""

    COPENHAGEN = "3ttttt3/5t5/11/t4T4t/t3TTT3t/tt1TTKTT1tt/t3TTT3t/t4T4t/11/5t5/3ttttt3"
    BRANDUBH = "3t3/3t3/3T3/ttTKTtt/3T3/3t3/3t3"
    MAGPIE = "3t3/1t3t1/3T3/t1TKT1t/3T3/1t3t1/3t3"
    TABLUT = "3ttt3/4t4/4T4/t3T3t/ttTTKTTtt/t3T3t/4T4/4t4/3ttt3"


PRESETS = {
    "copenhagen": (COPENHAGEN, BOARDS.COPENHAGEN),
    "brandubh": (BRANDUBH, BOARDS.BRANDUBH),
    "magpie": (MAGPIE, BOARDS.MAGPIE),
    "tablut": (TABLUT, BOARDS.TABLUT),
    "koch": (KOCH, BOARDS.BRANDUBH),  # reference demo pairs KOCH rules w/ BRANDUBH board (game/main.rs:137-140)
}


# ---------------------------------------------------------------------------
# Outcome enums (``game/game/mod.rs:17-70``)
# ---------------------------------------------------------------------------


class WinReason(enum.IntEnum):
    """Why a game has been won (``game/game/mod.rs:17-33``)."""

    KING_ESCAPED = 0
    EXIT_FORT = 1
    KING_CAPTURED = 2
    ALL_CAPTURED = 3
    ENCLOSED = 4
    NO_PLAYS = 5
    REPETITION = 6


class DrawReason(enum.IntEnum):
    """Why a game has been drawn (``game/game/mod.rs:37-42``)."""

    REPETITION = 0
    NO_PLAYS = 1


class PlayInvalid(enum.IntEnum):
    """Why a play is invalid (``game/error.rs:50-71``)."""

    GAME_OVER = 0
    NO_PIECE = 1
    WRONG_PLAYER = 2
    OUT_OF_BOUNDS = 3
    NO_COMMON_AXIS = 4
    BLOCKED_BY_PIECE = 5
    MOVE_THROUGH_BLOCKED_TILE = 6
    MOVE_ONTO_BLOCKED_TILE = 7
    TOO_FAR = 8
