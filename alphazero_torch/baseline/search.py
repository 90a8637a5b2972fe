"""Iterative-deepening PVS search for the baseline engine.

The port's own copy of ``alphazero_tpu/baseline/search.py``. Same
capability set as the reference search (``src/baseline/search.py``):
aspiration windows (+-40, widening on fail), Zobrist transposition table
with EXACT/LOWER/UPPER bounds and depth-preferred replacement, null-move
pruning (R=2, guarded), move ordering TT move > promotions > captures >
killers > history, PVS zero-window re-searches, late-move reductions,
killer (2/ply) and history (depth^2) updates on beta cutoffs,
capture+promotion quiescence with stand-pat, mate-distance scoring WIN -
ply, and soft/hard time limits (0.85/0.98 of budget) checked every 2048
nodes. A search under a time limit is therefore not deterministic; one
with a large ``time_ms`` and a fixed ``max_depth`` is.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from alphazero_torch.baseline.constants import (
    BLACK,
    RANK_1,
    RANK_8,
    SCORE_INF,
    SCORE_WIN,
    WHITE,
)
from alphazero_torch.baseline.engine import BitboardPosition, evaluate

EXACT, LOWER, UPPER = 0, 1, 2

ASPIRATION = 40
NULL_R = 2
MAX_PLY = 128

_ORD_TT = 10_000_000
_ORD_PROMO = 5_000_000
_ORD_CAPTURE = 2_000
_ORD_KILLER = 1_000


class TTEntry:
    __slots__ = ("key", "depth", "score", "flag", "move")

    def __init__(self, key, depth, score, flag, move):
        self.key = key
        self.depth = depth
        self.score = score
        self.flag = flag
        self.move = move


class TranspositionTable:
    """Dict-backed TT with depth-preferred, exact-preferred replacement."""

    def __init__(self, max_entries: int = 2_000_000):
        self.table: dict = {}
        self.max_entries = max_entries

    def probe(self, key: int) -> Optional[TTEntry]:
        e = self.table.get(key)
        return e if e is not None and e.key == key else None

    def store(self, key: int, depth: int, score: int, flag: int,
              move) -> None:
        old = self.table.get(key)
        if old is not None and old.key == key:
            if old.depth > depth and not (flag == EXACT and old.flag != EXACT):
                return
        elif len(self.table) >= self.max_entries:
            self.table.clear()  # simple full-flush like a generation reset
        self.table[key] = TTEntry(key, depth, score, flag, move)

    def clear(self) -> None:
        self.table.clear()


class Search:
    def __init__(self, time_limit_ms: int = 1000, max_depth: int = 64,
                 tt: Optional[TranspositionTable] = None):
        self.time_limit_ms = time_limit_ms
        self.max_depth = max_depth
        self.tt = tt or TranspositionTable()
        self.nodes = 0
        self._killers: List[List[Optional[Tuple[int, int]]]] = []
        self._history: dict = {}
        self._stop = False
        self._soft_deadline = 0.0
        self._hard_deadline = 0.0

    # -- public -----------------------------------------------------------
    def search(self, pos: BitboardPosition,
               time_ms: Optional[int] = None,
               max_depth: Optional[int] = None
               ) -> Tuple[Optional[Tuple[int, int]], int, dict]:
        """Returns (best_move, score_for_side_to_move, info)."""
        budget = (time_ms or self.time_limit_ms) / 1000.0
        start = time.perf_counter()
        self._soft_deadline = start + 0.85 * budget
        self._hard_deadline = start + 0.98 * budget
        self._stop = False
        self.nodes = 0
        self._killers = [[None, None] for _ in range(MAX_PLY)]
        self._history = {}

        moves = pos.legal_moves()
        if not moves:
            return None, -SCORE_WIN, {"depth": 0, "nodes": 0}
        best_move, best_score = moves[0], -SCORE_INF
        depth_reached = 0

        limit = max_depth or self.max_depth
        alpha, beta = -SCORE_INF, SCORE_INF
        for depth in range(1, limit + 1):
            score, move = self._root(pos, depth, alpha, beta)
            if self._stop:
                break
            # aspiration: widen and re-search on fail
            if score <= alpha or score >= beta:
                alpha, beta = -SCORE_INF, SCORE_INF
                score, move = self._root(pos, depth, alpha, beta)
                if self._stop:
                    break
            if move is not None:
                best_move, best_score = move, score
                depth_reached = depth
            if time.perf_counter() > self._soft_deadline:
                break
            if abs(score) >= SCORE_WIN - MAX_PLY:
                break  # proven mate
            alpha, beta = score - ASPIRATION, score + ASPIRATION

        elapsed = time.perf_counter() - start
        info = {"depth": depth_reached, "nodes": self.nodes,
                "time": elapsed,
                "nps": int(self.nodes / max(elapsed, 1e-9))}
        return best_move, best_score, info

    # -- internals ---------------------------------------------------------
    def _check_time(self) -> None:
        if self.nodes % 2048 == 0:
            if time.perf_counter() > self._hard_deadline:
                self._stop = True

    def _root(self, pos: BitboardPosition, depth: int, alpha: int,
              beta: int) -> Tuple[int, Optional[Tuple[int, int]]]:
        best_move = None
        tt_entry = self.tt.probe(pos.key)
        tt_move = tt_entry.move if tt_entry else None
        moves = self._ordered_moves(pos, tt_move, 0)
        best = -SCORE_INF
        for i, (frm, to) in enumerate(moves):
            cap = pos.make(frm, to)
            score = -self._negamax(pos, depth - 1, -beta, -alpha, 1)
            pos.unmake(frm, to, cap)
            if self._stop:
                return best, best_move
            if score > best:
                best, best_move = score, (frm, to)
            alpha = max(alpha, score)
            if alpha >= beta:
                break
        if best_move is not None:
            self.tt.store(pos.key, depth, best, EXACT, best_move)
        return best, best_move

    def _negamax(self, pos: BitboardPosition, depth: int, alpha: int,
                 beta: int, ply: int) -> int:
        self.nodes += 1
        self._check_time()
        if self._stop:
            return 0

        winner = pos.winner()
        if winner is not None:
            # previous mover won; side to move is lost
            return -(SCORE_WIN - ply)

        if depth <= 0:
            return self._quiescence(pos, alpha, beta, ply)

        alpha_orig = alpha
        entry = self.tt.probe(pos.key)
        tt_move = None
        if entry is not None:
            tt_move = entry.move
            if entry.depth >= depth:
                if entry.flag == EXACT:
                    return entry.score
                if entry.flag == LOWER:
                    alpha = max(alpha, entry.score)
                elif entry.flag == UPPER:
                    beta = min(beta, entry.score)
                if alpha >= beta:
                    return entry.score

        # null-move pruning: guarded like the reference (depth>=4, enough
        # material and mobility, no immediate promotion threat)
        own = pos.white if pos.turn == WHITE else pos.black
        opp_near = (pos.black & (RANK_1 << 8)) if pos.turn == WHITE else (
            pos.white & (RANK_8 >> 8))
        if (depth >= 4 and (pos.white | pos.black).bit_count() >= 6
                and not opp_near):
            moves = pos.legal_moves()
            if len(moves) >= 6:
                pos.make_null()
                score = -self._negamax(pos, depth - 1 - NULL_R, -beta,
                                       -beta + 1, ply + 1)
                pos.make_null()
                if self._stop:
                    return 0
                if score >= beta:
                    return beta
        else:
            moves = None

        moves = self._ordered_moves(pos, tt_move, ply, moves)
        if not moves:
            return -(SCORE_WIN - ply)  # stuck: side to move loses

        opp = pos.black if pos.turn == WHITE else pos.white
        final = RANK_8 if pos.turn == WHITE else RANK_1
        best = -SCORE_INF
        best_move = None
        for i, (frm, to) in enumerate(moves):
            is_capture = bool(opp & (1 << to))
            is_promo = bool((1 << to) & final)
            cap = pos.make(frm, to)

            if i == 0:
                score = -self._negamax(pos, depth - 1, -beta, -alpha,
                                       ply + 1)
            else:
                # LMR for late quiet moves
                r = 1 if (depth >= 3 and i >= 6 and not is_capture
                          and not is_promo) else 0
                score = -self._negamax(pos, depth - 1 - r, -alpha - 1,
                                       -alpha, ply + 1)
                if score > alpha and r:
                    score = -self._negamax(pos, depth - 1, -alpha - 1,
                                           -alpha, ply + 1)
                if beta > score > alpha:
                    score = -self._negamax(pos, depth - 1, -beta, -alpha,
                                           ply + 1)
            pos.unmake(frm, to, cap)
            if self._stop:
                return 0

            if score > best:
                best, best_move = score, (frm, to)
            alpha = max(alpha, score)
            if alpha >= beta:
                if not is_capture and not is_promo and ply < MAX_PLY:
                    k = self._killers[ply]
                    if k[0] != (frm, to):
                        k[1] = k[0]
                        k[0] = (frm, to)
                    h = self._history
                    h[(frm, to)] = h.get((frm, to), 0) + depth * depth
                break

        flag = (EXACT if alpha_orig < best < beta
                else LOWER if best >= beta else UPPER)
        self.tt.store(pos.key, depth, best, flag, best_move)
        return best

    def _quiescence(self, pos: BitboardPosition, alpha: int, beta: int,
                    ply: int) -> int:
        self.nodes += 1
        self._check_time()
        if self._stop:
            return 0
        winner = pos.winner()
        if winner is not None:
            return -(SCORE_WIN - ply)

        stand = evaluate(pos)
        if pos.turn == BLACK:
            stand = -stand
        if stand >= beta:
            return beta
        alpha = max(alpha, stand)

        opp = pos.black if pos.turn == WHITE else pos.white
        caps = pos.captures_and_promotions()
        # order: promotions first, then captures (MVV is uniform here)
        final = RANK_8 if pos.turn == WHITE else RANK_1
        caps.sort(key=lambda m: ((1 << m[1]) & final, (1 << m[1]) & opp),
                  reverse=True)
        for frm, to in caps:
            cap = pos.make(frm, to)
            score = -self._quiescence(pos, -beta, -alpha, ply + 1)
            pos.unmake(frm, to, cap)
            if self._stop:
                return 0
            if score >= beta:
                return beta
            alpha = max(alpha, score)
        return alpha

    def _ordered_moves(self, pos: BitboardPosition, tt_move, ply: int,
                       moves=None):
        if moves is None:
            moves = pos.legal_moves()
        opp = pos.black if pos.turn == WHITE else pos.white
        final = RANK_8 if pos.turn == WHITE else RANK_1
        killers = self._killers[ply] if ply < MAX_PLY else (None, None)
        hist = self._history

        def key(m):
            to_bit = 1 << m[1]
            s = 0
            if m == tt_move:
                s += _ORD_TT
            if to_bit & final:
                s += _ORD_PROMO
            if to_bit & opp:
                s += _ORD_CAPTURE
            else:
                # killer/history apply to every non-capture, including
                # quiet promotions (reference baseline/search.py:273-285);
                # _ORD_PROMO dominates, so on promos this only tiebreaks
                if m == killers[0] or m == killers[1]:
                    s += _ORD_KILLER
                s += hist.get(m, 0)
            return -s

        moves.sort(key=key)
        return moves
