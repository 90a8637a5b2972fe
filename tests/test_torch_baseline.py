"""The PyTorch port's copy of the baseline engine (``alphazero_torch/
baseline/``): the 13 cases of ``tests/test_baseline.py`` on the port's
engine against the port's ``OracleGame``, and a differential test
against the JAX package's engine: the same legal moves, Zobrist keys,
winners and evaluations on random positions, and the same (best move,
score, nodes) from fixed-depth searches. Every comparison is exact."""

import time

import numpy as np
import pytest

from alphazero_tpu import baseline as jbaseline
from alphazero_tpu.env import OracleGame as JOracle

from alphazero_torch.baseline import (
    BLACK,
    WHITE,
    BitboardPosition,
    Search,
    evaluate,
    from_board,
)
from alphazero_torch.env import OracleGame


def oracle_to_bitboard(g: OracleGame) -> BitboardPosition:
    w = b = 0
    for r in range(8):
        for c in range(8):
            if g.board[r, c] == 1:
                w |= 1 << (r * 8 + c)
            elif g.board[r, c] == -1:
                b |= 1 << (r * 8 + c)
    return BitboardPosition(w, b, g.turn)


def moves_as_coords(pos: BitboardPosition):
    return sorted((f // 8, f % 8, t // 8, t % 8)
                  for f, t in pos.legal_moves())


class TestState:
    def test_initial_movegen(self):
        pos = BitboardPosition()
        assert len(pos.legal_moves()) == 22

    def test_exact_moves_two_pieces(self):
        # white d4 (sq 27), black e5 (sq 36)
        pos = BitboardPosition(1 << 27, 1 << 36, WHITE)
        moves = set(pos.legal_moves())
        assert moves == {(27, 35), (27, 34), (27, 36)}

    def test_make_unmake_roundtrip(self):
        pos = BitboardPosition()
        key0, w0, b0 = pos.key, pos.white, pos.black
        for frm, to in list(pos.legal_moves())[:5]:
            cap = pos.make(frm, to)
            assert pos.key != key0
            pos.unmake(frm, to, cap)
            assert (pos.key, pos.white, pos.black, pos.turn) == (
                key0, w0, b0, WHITE)

    def test_capture_updates_hash_incrementally(self):
        pos = BitboardPosition(1 << 27, 1 << 36, WHITE)
        cap = pos.make(27, 36)
        assert cap == 1 << 36
        assert pos.black == 0
        fresh = BitboardPosition(pos.white, pos.black, pos.turn)
        assert fresh.key == pos.key

    def test_winner(self):
        assert BitboardPosition(1 << 63, 1 << 8, WHITE).winner() == WHITE
        assert BitboardPosition(1 << 8, 1 << 3, BLACK).winner() == BLACK
        assert BitboardPosition(1 << 20, 0, WHITE).winner() == WHITE
        assert BitboardPosition().winner() is None


class TestCompatibility:
    """Cross-implementation differential tests (reference
    tests/test_compatibility.py): bitboard engine vs the game oracle."""

    def test_initial_position_matches(self):
        g = OracleGame()
        pos = oracle_to_bitboard(g)
        assert moves_as_coords(pos) == sorted(g.get_legal_moves())

    def test_random_positions_match(self):
        rng = np.random.default_rng(11)
        for _ in range(20):
            g = OracleGame()
            for _ in range(int(rng.integers(0, 40))):
                if g.is_terminal():
                    break
                g.step_action(int(rng.choice(g.get_legal_actions())))
            if g.is_terminal():
                continue
            for turn in (WHITE, BLACK):
                gg = OracleGame(g.board, turn)
                if gg.is_terminal():
                    continue
                pos = oracle_to_bitboard(gg)
                assert moves_as_coords(pos) == sorted(gg.get_legal_moves())

    def test_terminal_agreement(self):
        rng = np.random.default_rng(13)
        g = OracleGame()
        while not g.is_terminal():
            g.step_action(int(rng.choice(g.get_legal_actions())))
        pos = oracle_to_bitboard(g)
        assert pos.is_terminal()
        assert pos.winner() == g.winner


class TestSearch:
    def test_finds_winning_promotion(self):
        # white g7 can promote; black far away
        pos = BitboardPosition(1 << 54, 1 << 8, WHITE)
        move, score, info = Search(time_limit_ms=500).search(pos)
        assert move[0] == 54 and move[1] // 8 == 7
        assert score > 20_000

    def test_finds_forced_defensive_capture(self):
        # black pawn on b2 (sq 9) threatens to promote; white a1 (sq 0) must
        # capture it diagonally forward
        pos = BitboardPosition((1 << 0) | (1 << 40), (1 << 9) | (1 << 55),
                               WHITE)
        move, score, info = Search(time_limit_ms=1000).search(pos)
        assert move == (0, 9)

    def test_eval_symmetry(self):
        assert evaluate(BitboardPosition()) == 0
        # mirrored colors give negated score
        pos = BitboardPosition(1 << 27, (1 << 36) | (1 << 44), WHITE)
        w, b = pos.white, pos.black
        mw = mb = 0
        for sq in range(64):
            if w & (1 << sq):
                mb |= 1 << (63 - sq)
            if b & (1 << sq):
                mw |= 1 << (63 - sq)
        mirrored = BitboardPosition(mw, mb, BLACK)
        assert evaluate(mirrored) == -evaluate(pos)

    def test_perf_smoke(self):
        # reference bar: 1000 movegen+make cycles < 1s (test_baseline.py:83)
        pos = BitboardPosition()
        t0 = time.perf_counter()
        n = 0
        for _ in range(1000):
            moves = pos.legal_moves()
            frm, to = moves[n % len(moves)]
            cap = pos.make(frm, to)
            pos.unmake(frm, to, cap)
            n += 1
        assert time.perf_counter() - t0 < 1.0

    def test_search_reports_nps(self):
        move, score, info = Search(time_limit_ms=300).search(
            BitboardPosition())
        assert info["nodes"] > 100
        assert info["nps"] > 1000
        assert move in BitboardPosition().legal_moves()


# -----------------------------------------------------------------------------
# Differential: the port's engine against the JAX package's
# -----------------------------------------------------------------------------

def _random_games(seed, n, max_plies=60):
    """``n`` live oracle games (both packages' oracles, in step) after a
    seeded number of random plies."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        t, j = OracleGame(), JOracle()
        for _ in range(int(rng.integers(0, max_plies))):
            if t.is_terminal():
                break
            a = int(rng.choice(t.get_legal_actions()))
            t.step_action(a)
            j.step_action(a)
        out.append((t, j))
    return out


def _jax_position(pos: BitboardPosition) -> "jbaseline.BitboardPosition":
    return jbaseline.BitboardPosition(pos.white, pos.black, pos.turn)


def test_from_board_is_the_oracles_position():
    """``from_board`` gives the bit of square r * 8 + c to the piece on
    (r, c), White's home on ranks 1-2."""
    pos = from_board(OracleGame().board, WHITE)
    assert (pos.white, pos.black, pos.turn) == (0xFFFF, 0xFFFF << 48, WHITE)
    for t, _ in _random_games(5, 8):
        pos = from_board(t.board, t.turn)
        assert pos.key == oracle_to_bitboard(t).key
        assert (pos.white, pos.black) == (oracle_to_bitboard(t).white,
                                          oracle_to_bitboard(t).black)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_positions_equal_jax(seed):
    """legal_moves, captures_and_promotions, key, winner and evaluate on
    random positions (both sides to move), along every legal move made
    and unmade."""
    for t, j in _random_games(seed, 12):
        np.testing.assert_array_equal(t.board, j.board)
        for turn in (WHITE, BLACK):
            pos = from_board(t.board, turn)
            jpos = _jax_position(pos)
            assert pos.legal_moves() == jpos.legal_moves()
            assert (pos.captures_and_promotions()
                    == jpos.captures_and_promotions())
            assert (pos.key, pos.winner(), evaluate(pos)) == (
                jpos.key, jpos.winner(), jbaseline.evaluate(jpos))
            for frm, to in pos.legal_moves():
                cap, jcap = pos.make(frm, to), jpos.make(frm, to)
                assert (cap, pos.key, pos.winner(), evaluate(pos)) == (
                    jcap, jpos.key, jpos.winner(), jbaseline.evaluate(jpos))
                pos.unmake(frm, to, cap)
                jpos.unmake(frm, to, jcap)
            assert (pos.white, pos.black, pos.key) == (jpos.white,
                                                       jpos.black, jpos.key)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_fixed_depth_searches_equal_jax(seed):
    """(best_move, score, nodes, depth) of ``Search.search`` at a fixed
    depth (1-4: depth 3 reaches late-move reductions, depth 4 null-move
    pruning) with a time budget that never binds, on fresh engines."""
    for t, _ in _random_games(seed, 4):
        pos = from_board(t.board, t.turn)
        for depth in (1, 2, 3, 4):
            got = Search().search(pos.clone(), time_ms=10**7,
                                  max_depth=depth)
            want = jbaseline.Search().search(_jax_position(pos),
                                             time_ms=10**7, max_depth=depth)
            assert (got[0], got[1], got[2]["nodes"], got[2]["depth"]) == (
                want[0], want[1], want[2]["nodes"], want[2]["depth"])


def test_one_engine_over_a_game_equals_jax():
    """One engine per side for a whole game, as the anchor plays it: the
    transposition table, killers and history carry across moves; every
    move, score and node count equal, to the end of the game."""
    engines = {WHITE: (Search(), jbaseline.Search()),
               BLACK: (Search(), jbaseline.Search())}
    t = OracleGame()
    while not t.is_terminal():
        pos = from_board(t.board, t.turn)
        mine, theirs = engines[t.turn]
        got = mine.search(pos, time_ms=10**7, max_depth=2)
        want = theirs.search(_jax_position(pos), time_ms=10**7, max_depth=2)
        assert (got[0], got[1], got[2]["nodes"]) == (want[0], want[1],
                                                     want[2]["nodes"])
        frm, to = got[0]
        t.step((frm // 8, frm % 8, to // 8, to % 8))
    assert t.move_count > 10
