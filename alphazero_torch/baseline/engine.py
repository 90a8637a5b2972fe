"""Bitboard position + hand-crafted evaluation.

The port's own copy of ``alphazero_tpu/baseline/engine.py`` (the port
imports nothing of the JAX package), with the same Zobrist seed, so that
position keys agree across the packages. Behaviour-equivalent to the
reference engine's state and eval (``src/baseline/state.py``,
``eval.py``), with the same feature set and weights:

- two 64-bit pawn sets + side to move; incremental Zobrist hashing
- shift/mask move generation (White: +8 / +7&~FILE_H / +9&~FILE_A;
  Black mirrored), straight moves need an empty target, diagonals any
  non-own target
- terminal: a pawn on the opponent's home rank, or an empty side
- evaluation (centipawns, White-positive): material 100, advancement
  12/rank, centralization +4 on files C-F, mobility 4 * move-count
  difference, protected pawns +10, hanging pawns -25 (undefended) / -10
  (defended), 7th-rank +180 with +260 more for an unstoppable step,
  promotion race max(0, 70 - 10*distance)
"""

from __future__ import annotations

import numpy as np

from alphazero_torch.baseline.constants import (
    BLACK,
    FILE_A,
    FILE_H,
    RANK_1,
    RANK_2,
    RANK_7,
    RANK_8,
    SCORE_WIN,
    START_BLACK,
    START_WHITE,
    U64,
    WHITE,
)

# Zobrist keys (fixed seed for reproducible hashes)
_Z_RNG = np.random.default_rng(0xA1FA2E50)
Z_PIECE = [[int(x) for x in _Z_RNG.integers(0, 1 << 63, 64, dtype=np.int64)]
           for _ in range(2)]
Z_SIDE = int(_Z_RNG.integers(0, 1 << 63, dtype=np.int64))

_CENTER_FILES = 0x3C3C3C3C3C3C3C3C  # files C-F


def _bits(bb: int):
    while bb:
        lsb = bb & -bb
        yield lsb.bit_length() - 1
        bb ^= lsb


class BitboardPosition:
    """Mutable Breakthrough position on two bitboards."""

    __slots__ = ("white", "black", "turn", "key")

    def __init__(self, white: int = START_WHITE, black: int = START_BLACK,
                 turn: int = WHITE):
        self.white = white
        self.black = black
        self.turn = turn
        self.key = self._full_hash()

    def _full_hash(self) -> int:
        h = 0
        for sq in _bits(self.white):
            h ^= Z_PIECE[0][sq]
        for sq in _bits(self.black):
            h ^= Z_PIECE[1][sq]
        if self.turn == BLACK:
            h ^= Z_SIDE
        return h

    def clone(self) -> "BitboardPosition":
        p = BitboardPosition.__new__(BitboardPosition)
        p.white, p.black, p.turn, p.key = (self.white, self.black,
                                           self.turn, self.key)
        return p

    # -- move generation -----------------------------------------------------
    def move_targets(self):
        """(fwd, diag_left, diag_right) destination bitboards for the side
        to move. Shift deltas: White +8/+7/+9, Black -8/-9/-7."""
        occ = self.white | self.black
        empty = ~occ & U64
        if self.turn == WHITE:
            own = self.white
            fwd = ((own << 8) & empty) & U64
            dl = ((own << 7) & ~FILE_H & ~own) & U64
            dr = ((own << 9) & ~FILE_A & ~own) & U64
        else:
            own = self.black
            fwd = ((own >> 8) & empty) & U64
            dl = ((own >> 9) & ~FILE_H & ~own) & U64
            dr = ((own >> 7) & ~FILE_A & ~own) & U64
        return fwd, dl, dr

    def legal_moves(self):
        """List of (from_sq, to_sq)."""
        fwd, dl, dr = self.move_targets()
        s = 1 if self.turn == WHITE else -1
        moves = [(to - 8 * s, to) for to in _bits(fwd)]
        moves += [(to - 7 * s if s == 1 else to + 9, to) for to in _bits(dl)]
        moves += [(to - 9 * s if s == 1 else to + 7, to) for to in _bits(dr)]
        return moves

    def captures_and_promotions(self):
        """Moves that capture or land on the final rank (quiescence set)."""
        fwd, dl, dr = self.move_targets()
        opp = self.black if self.turn == WHITE else self.white
        final = RANK_8 if self.turn == WHITE else RANK_1
        out = []
        if self.turn == WHITE:
            for to in _bits((dl & (opp | final))):
                out.append((to - 7, to))
            for to in _bits((dr & (opp | final))):
                out.append((to - 9, to))
            for to in _bits((fwd & final)):
                out.append((to - 8, to))
        else:
            for to in _bits((dl & (opp | final))):
                out.append((to + 9, to))
            for to in _bits((dr & (opp | final))):
                out.append((to + 7, to))
            for to in _bits((fwd & final)):
                out.append((to + 8, to))
        return out

    def has_moves(self) -> bool:
        fwd, dl, dr = self.move_targets()
        return bool(fwd | dl | dr)

    # -- transitions -----------------------------------------------------------
    def make(self, from_sq: int, to_sq: int) -> int:
        """Apply a move; returns an undo cookie (captured bitboard bit or 0)."""
        fm, tm = 1 << from_sq, 1 << to_sq
        captured = 0
        if self.turn == WHITE:
            self.white ^= fm | tm
            self.key ^= Z_PIECE[0][from_sq] ^ Z_PIECE[0][to_sq]
            if self.black & tm:
                captured = tm
                self.black ^= tm
                self.key ^= Z_PIECE[1][to_sq]
        else:
            self.black ^= fm | tm
            self.key ^= Z_PIECE[1][from_sq] ^ Z_PIECE[1][to_sq]
            if self.white & tm:
                captured = tm
                self.white ^= tm
                self.key ^= Z_PIECE[0][to_sq]
        self.turn = -self.turn
        self.key ^= Z_SIDE
        return captured

    def unmake(self, from_sq: int, to_sq: int, captured: int) -> None:
        self.turn = -self.turn
        self.key ^= Z_SIDE
        fm, tm = 1 << from_sq, 1 << to_sq
        if self.turn == WHITE:
            self.white ^= fm | tm
            self.key ^= Z_PIECE[0][from_sq] ^ Z_PIECE[0][to_sq]
            if captured:
                self.black ^= captured
                self.key ^= Z_PIECE[1][to_sq]
        else:
            self.black ^= fm | tm
            self.key ^= Z_PIECE[1][from_sq] ^ Z_PIECE[1][to_sq]
            if captured:
                self.white ^= captured
                self.key ^= Z_PIECE[0][to_sq]

    def make_null(self) -> None:
        self.turn = -self.turn
        self.key ^= Z_SIDE

    # -- terminal ---------------------------------------------------------------
    def winner(self):
        if self.white & RANK_8 or self.black == 0:
            return WHITE
        if self.black & RANK_1 or self.white == 0:
            return BLACK
        return None

    def is_terminal(self) -> bool:
        return self.winner() is not None

    def __str__(self) -> str:
        rows = ["  A B C D E F G H"]
        for r in range(7, -1, -1):
            cells = []
            for f in range(8):
                m = 1 << (r * 8 + f)
                cells.append("W" if self.white & m else
                             "B" if self.black & m else ".")
            rows.append(f"{r + 1} " + " ".join(cells))
        rows.append(f"turn: {'White' if self.turn == WHITE else 'Black'}")
        return "\n".join(rows)


def from_board(board, turn: int) -> BitboardPosition:
    """The position of an (8, 8) board of WHITE / BLACK / 0 with row r on
    rank r + 1 (the env's and the oracle's board): square r * 8 + c."""
    w = b = 0
    for r in range(8):
        for c in range(8):
            v = board[r, c]
            if v == WHITE:
                w |= 1 << (r * 8 + c)
            elif v == BLACK:
                b |= 1 << (r * 8 + c)
    return BitboardPosition(w, b, int(turn))


# -----------------------------------------------------------------------------
# Evaluation
# -----------------------------------------------------------------------------

def _attacks_of(bb: int, color: int) -> int:
    """Squares attacked (diagonally) by the given pawn set."""
    if color == WHITE:
        return (((bb << 7) & ~FILE_H) | ((bb << 9) & ~FILE_A)) & U64
    return (((bb >> 9) & ~FILE_H) | ((bb >> 7) & ~FILE_A)) & U64


def _popcount(x: int) -> int:
    return x.bit_count()


def _mobility_count(pos: BitboardPosition, color: int) -> int:
    saved = pos.turn
    pos.turn = color
    fwd, dl, dr = pos.move_targets()
    pos.turn = saved
    return _popcount(fwd) + _popcount(dl) + _popcount(dr)


def evaluate(pos: BitboardPosition) -> int:
    """Centipawn score from White's perspective."""
    w, b = pos.white, pos.black

    score = 100 * (_popcount(w) - _popcount(b))

    # advancement: 12 per rank advanced from home
    for r in range(8):
        rank_mask = RANK_1 << (8 * r)
        score += 12 * r * _popcount(w & rank_mask)
        score -= 12 * (7 - r) * _popcount(b & rank_mask)

    # centralization on files C-F
    score += 4 * (_popcount(w & _CENTER_FILES) - _popcount(b & _CENTER_FILES))

    # mobility
    score += 4 * (_mobility_count(pos, WHITE) - _mobility_count(pos, BLACK))

    # protection / hanging
    w_att, b_att = _attacks_of(w, WHITE), _attacks_of(b, BLACK)
    score += 10 * _popcount(w & w_att)
    score -= 10 * _popcount(b & b_att)
    w_hanging = w & b_att
    b_hanging = b & w_att
    score -= 25 * _popcount(w_hanging & ~w_att) + 10 * _popcount(
        w_hanging & w_att)
    score += 25 * _popcount(b_hanging & ~b_att) + 10 * _popcount(
        b_hanging & b_att)

    # near-promotion: pawn on the 7th rank (one step from winning); +260 more
    # per pawn that actually has a winning step available
    w7, b2 = w & RANK_7, b & RANK_2
    empty = ~(w | b) & U64
    if w7:
        score += 180 * _popcount(w7)
        srcs = ((((w7 << 8) & empty) >> 8)
                | ((((w7 << 7) & ~FILE_H) & ~w) >> 7)
                | ((((w7 << 9) & ~FILE_A) & ~w) >> 9))
        score += 260 * _popcount(srcs)
    if b2:
        score -= 180 * _popcount(b2)
        srcs = ((((b2 >> 8) & empty) << 8)
                | ((((b2 >> 9) & ~FILE_H) & ~b) << 9)
                | ((((b2 >> 7) & ~FILE_A) & ~b) << 7))
        score -= 260 * _popcount(srcs)
    # promotion race bonus per pawn: max(0, 70 - 10*distance)
    for sq in _bits(w):
        score += max(0, 70 - 10 * (7 - sq // 8))
    for sq in _bits(b):
        score -= max(0, 70 - 10 * (sq // 8))

    return score
