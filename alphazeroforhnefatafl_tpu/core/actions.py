"""Fixed-shape action space for tafl moves.

The reference represents a move as ``Play { from: Tile, movement: AxisOffset }``
(``game/play.rs:23-27``) — source tile plus axis and signed displacement. A
batched policy head needs a *fixed-size integer action space*, so a move is
encoded as

    action = from_flat * (4 * (N - 1)) + direction * (N - 1) + (distance - 1)

with ``from_flat = row * N + col``, ``direction in {0: up, 1: down, 2: left,
3: right}`` and ``distance in 1..N-1``. Total size ``N^2 * 4 * (N-1)``
(11x11 -> 4840). This is a bijection onto the reference's
``(from, axis, displacement)`` triple: direction encodes (axis, sign) and
distance the magnitude, so play equality (used by the repetition rule,
``game/game/state.rs:15-29``) carries over to action-id equality.

All helpers work on plain ints, numpy arrays and traced jnp arrays alike.
"""

from __future__ import annotations

from typing import Tuple

# direction -> (d_row, d_col)
DIR_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1))
UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3


def num_actions(n: int) -> int:
    return n * n * 4 * (n - 1)


def encode(n: int, from_row, from_col, direction, distance):
    """Encode (tile, direction, distance) -> action id."""
    from_flat = from_row * n + from_col
    return from_flat * (4 * (n - 1)) + direction * (n - 1) + (distance - 1)


def decode(n: int, action):
    """Decode action id -> (from_row, from_col, direction, distance)."""
    per_tile = 4 * (n - 1)
    from_flat = action // per_tile
    rem = action % per_tile
    direction = rem // (n - 1)
    distance = rem % (n - 1) + 1
    return from_flat // n, from_flat % n, direction, distance


def to_tile(from_row, from_col, direction, distance):
    """Destination tile of a move (``game/play.rs:59-67``). May be out of
    bounds. Pure arithmetic (no np/jnp dispatch) so it genuinely works on
    plain ints, numpy arrays and traced jnp arrays alike."""
    sign = direction % 2 * 2 - 1  # up/left -> -1, down/right -> +1
    to_row = from_row + sign * distance * (direction <= 1)
    to_col = from_col + sign * distance * (direction >= 2)
    return to_row, to_col


def encode_from_tiles(n: int, src: Tuple[int, int], dst: Tuple[int, int]) -> int:
    """Encode a (src, dst) tile pair as an action id (python ints only).

    Mirrors ``Play::from_tiles`` (``game/play.rs:36-49``); raises on disjoint
    tiles or zero displacement.
    """
    (r1, c1), (r2, c2) = src, dst
    if r1 == r2 and c1 != c2:
        direction = LEFT if c2 < c1 else RIGHT
        distance = abs(c2 - c1)
    elif c1 == c2 and r1 != r2:
        direction = UP if r2 < r1 else DOWN
        distance = abs(r2 - r1)
    else:
        raise ValueError(f"disjoint or identical tiles: {src} -> {dst}")
    return int(encode(n, r1, c1, direction, distance))


def decode_to_tiles(n: int, action: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Decode an action id to ((from_row, from_col), (to_row, to_col))."""
    fr, fc, d, dist = decode(n, int(action))
    dr, dc = DIR_OFFSETS[d]
    return (int(fr), int(fc)), (int(fr + dr * dist), int(fc + dc * dist))
