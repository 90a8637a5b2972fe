"""Breakthrough in plain numpy: the benchmark's reference rules.

Written from the rules, not from the program: an 8x8 board, White (+1)
starts on rows 0-1 and moves toward row 7, Black (-1) on rows 6-7 toward
row 0. A piece moves one row forward, straight onto an empty square or
diagonally onto a square that does not hold a piece of its own (a capture
if it holds the opponent's). A player wins by reaching the far row, by
taking every opposing piece, or by leaving the opponent without a move.

Actions are canonical, seen from the mover's side with the board turned
by 180 degrees for Black: ``action = (row * 8 + col) * 3 + dir``, with dir
0 straight, 1 toward column - 1, 2 toward column + 1.

Every function works on a batch: ``board`` (N, 8, 8) int8, ``turn`` (N,)
int8.
"""

from __future__ import annotations

import numpy as np

WHITE, BLACK = 1, -1
NUM_ACTIONS = 192


def initial(n: int):
    """(board, turn) of ``n`` games at the start."""
    board = np.zeros((n, 8, 8), np.int8)
    board[:, 0:2] = WHITE
    board[:, 6:8] = BLACK
    return board, np.full(n, WHITE, np.int8)


def canonical(board: np.ndarray, turn: np.ndarray) -> np.ndarray:
    """The boards seen from the side to move."""
    flip = (turn == BLACK)[:, None, None]
    return np.where(flip, board[:, ::-1, ::-1], board)


def legal_mask(board: np.ndarray, turn: np.ndarray) -> np.ndarray:
    """(N, 192) legal canonical actions of the side to move (a finished
    game's mask is the caller's to clear)."""
    canon = canonical(board, turn)
    t = turn[:, None, None]
    mine = canon == t
    n = board.shape[0]
    mask = np.zeros((n, 8, 8, 3), bool)
    ahead = np.zeros_like(canon)
    ahead[:, :-1] = canon[:, 1:]              # the square one row ahead
    own_ahead = np.zeros_like(mine)
    own_ahead[:, :-1] = mine[:, 1:]
    mask[:, :7, :, 0] = mine[:, :7] & (ahead[:, :7] == 0)
    mask[:, :7, 1:, 1] = mine[:, :7, 1:] & ~own_ahead[:, :7, :-1]
    mask[:, :7, :-1, 2] = mine[:, :7, :-1] & ~own_ahead[:, :7, 1:]
    return mask.reshape(n, NUM_ACTIONS)


def step(board: np.ndarray, turn: np.ndarray, action: np.ndarray):
    """Play the legal canonical ``action`` in each live game. Returns
    (board, turn, winner): the winner is the mover where the move won,
    else 0."""
    n = board.shape[0]
    action = np.asarray(action, np.int64)
    sq, d = np.divmod(action, 3)
    r, c = np.divmod(sq, 8)
    tr, tc = r + 1, c + np.where(d == 1, -1, np.where(d == 2, 1, 0))
    black = turn == BLACK
    fr_r, fr_c = np.where(black, 7 - r, r), np.where(black, 7 - c, c)
    to_r, to_c = np.where(black, 7 - tr, tr), np.where(black, 7 - tc, tc)
    out = board.copy()
    idx = np.arange(n)
    out[idx, to_r, to_c] = turn
    out[idx, fr_r, fr_c] = 0
    won = (tr == 7) | ~(out == -turn[:, None, None]).any((1, 2))
    nxt = (-turn).astype(np.int8)
    stuck = ~won & ~legal_mask(out, nxt).any(1)
    winner = np.where(won | stuck, turn, 0).astype(np.int8)
    return out, nxt, winner


def planes(board: np.ndarray, turn: np.ndarray) -> np.ndarray:
    """(N, 3, 8, 8) float32 network input: the mover's pieces, the
    opponent's, ones."""
    canon = canonical(board, turn)
    t = turn[:, None, None]
    ones = np.ones_like(canon, bool)
    return np.stack([canon == t, canon == -t, ones], 1).astype(np.float32)


def encode_move(move, turn: int) -> int:
    """An absolute (from_row, from_col, to_row, to_col) move of the side
    ``turn`` as its canonical action; -1 for no move of one row ahead."""
    fr, fc, tr, tc = (int(v) for v in move)
    if turn == BLACK:
        fr, fc, tr, tc = 7 - fr, 7 - fc, 7 - tr, 7 - tc
    d = {0: 0, -1: 1, 1: 2}.get(tc - fc)
    if d is None or tr != fr + 1:
        return -1
    return (fr * 8 + fc) * 3 + d
