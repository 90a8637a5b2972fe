"""The PyTorch port's strength gates (``alphazero_torch/strength/``) held
against the JAX package's, on the CPU at a tiny size.

The JAX gates are scripts that run when imported, so each test rebuilds
a script's loop from the JAX package's functions and plays it beside the
port's module, both under shared toy evaluators (``tests/test_mcts.py``'s
exact evaluator and a second one with other integer weights):

- ``quant_match``: the same openings, final boards and scores as
  ``scripts/eval_quant_match.py``'s ``play_paired_matches`` with its pair
  evaluator (``:90-95``);
- ``asym_match``: the same as ``scripts/eval_asym_match.py``'s loop with
  its ``asym_move`` (``:103-112``), at two different simulation counts;
- ``vs_baseline``: the same moves and results as
  ``scripts/eval_vs_baseline.py``'s games, with the baseline at a fixed
  depth (its time budget never binds);
- the int8-static calibration: the JAX gates' replay rule, and the
  random-play positions where there is no replay file;
- each module's ``main`` on a tiny port checkpoint, ``--cpu``.

Every comparison is exact.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from alphazero_tpu.arena import match as jmatch
from alphazero_tpu.baseline import BitboardPosition as JPosition
from alphazero_tpu.baseline import Search as JSearch
from alphazero_tpu.config import tiny_config as jtiny
from alphazero_tpu.env import OracleGame as JOracle
from alphazero_tpu.env import breakthrough as jenv
from alphazero_tpu.search import mcts as jmcts
from tests.test_mcts import _BASE_W, _SQ_OF_ACTION, fake_eval_jax
from tests.test_torch_mcts import fake_eval_torch

from alphazero_torch.arena import match
from alphazero_torch.config import tiny_config
from alphazero_torch.env import OracleGame
from alphazero_torch.strength import asym_match, common, quant_match
from alphazero_torch.strength import vs_baseline

_BASE_W_B = ((np.arange(len(_BASE_W)) * 3) % 7 + 1).astype(_BASE_W.dtype)


def eval_b_jax(planes):
    """The second player's toy evaluator: other integer priors, values
    at minus one half of the first's."""
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    w = jnp.asarray(_BASE_W_B) * (1.0 + mine[:, jnp.asarray(_SQ_OF_ACTION)])
    v = -(mine.sum(-1) - theirs.sum(-1)) / 32.0
    return w.astype(jnp.float32), v.astype(jnp.float32)


def eval_b_torch(planes):
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    w = torch.from_numpy(_BASE_W_B) * (
        1.0 + mine[:, torch.from_numpy(_SQ_OF_ACTION).long()])
    v = -(mine.sum(-1) - theirs.sum(-1)) / 32.0
    return w.float(), v.float()


def _assert_states_equal(got, want):
    for f in ("board", "turn", "winner", "done", "move_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


# -----------------------------------------------------------------------------
# quant_match: scripts/eval_quant_match.py
# -----------------------------------------------------------------------------

def test_quant_match_equals_jax_script(monkeypatch):
    pairs, sims, seed = 3, 10, 2026
    finals = {}

    def record(module, key):
        inner = module._match_move

        def move(*a, **kw):
            finals[key] = inner(*a, **kw)
            return finals[key]
        monkeypatch.setattr(module, "_match_move", move)

    record(jmatch, "jax")
    record(match, "torch")

    # the script's loop (eval_quant_match.py:90-104)
    def pair_eval_fn(planes, a_to_move):
        pa, va = fake_eval_jax(planes)
        pb, vb = eval_b_jax(planes)
        sel = a_to_move[:, None]
        return jnp.where(sel, pa, pb), jnp.where(a_to_move, va, vb)

    rng = random.Random(seed)
    openings = [jmatch.random_opening(rng) for _ in range(pairs)]
    want = jmatch.play_paired_matches(None, None, None, None, openings,
                                      jtiny(), num_simulations=sims,
                                      pair_eval_fn=pair_eval_fn)
    got = quant_match.play(fake_eval_torch, eval_b_torch, pairs, sims, seed,
                           tiny_config(), "cpu")
    assert got == want and sum(got) == 2 * pairs
    _assert_states_equal(finals["torch"], finals["jax"])


# -----------------------------------------------------------------------------
# asym_match: scripts/eval_asym_match.py
# -----------------------------------------------------------------------------

def _jax_asym_match(pairs, sims_a, sims_b, seed, cfg):
    """The script's loop, eval_asym_match.py:99-140, with the toy
    evaluators."""

    def spec_for(sims):
        return jmcts.SearchSpec(num_simulations=sims, c_puct=cfg.c_puct,
                                fpu_reduction=cfg.fpu_reduction)

    @jax.jit
    def asym_move(states, a_is_white):
        a_to_move = jnp.where(states.turn == jenv.WHITE, a_is_white,
                              ~a_is_white)
        acts_a = jnp.argmax(jmcts.root_action_probs(
            jmcts.search(states, fake_eval_jax, spec_for(sims_a)), 0.0),
            -1).astype(jnp.int32)
        acts_b = jnp.argmax(jmcts.root_action_probs(
            jmcts.search(states, eval_b_jax, spec_for(sims_b)), 0.0),
            -1).astype(jnp.int32)
        return jenv.step(states, jnp.where(a_to_move, acts_a, acts_b))

    rng = random.Random(seed)
    openings = [jmatch.random_opening(rng) for _ in range(pairs)]
    B = 2 * len(openings)
    states = jenv.EnvState(
        board=jnp.asarray(np.stack([g.board for g in openings
                                    for _ in range(2)]), jnp.int8),
        turn=jnp.asarray([g.turn for g in openings for _ in range(2)],
                         jnp.int8),
        winner=jnp.zeros((B,), jnp.int8),
        done=jnp.zeros((B,), jnp.bool_),
        move_count=jnp.zeros((B,), jnp.int32),
    )
    a_is_white = jnp.asarray([i % 2 == 0 for i in range(B)])
    for _ in range(cfg.max_game_length):
        if bool(np.all(np.asarray(states.done))):
            break
        states = asym_move(states, a_is_white)
    winners = np.asarray(states.winner)
    aw = np.asarray(a_is_white)
    wins_a = int(np.where(aw, winners == jenv.WHITE,
                          winners == jenv.BLACK).sum())
    wins_b = int(np.where(aw, winners == jenv.BLACK,
                          winners == jenv.WHITE).sum())
    return wins_a, wins_b, states


@pytest.mark.parametrize("sims_a,sims_b,seed", [(14, 6, 2026),
                                                (5, 12, 2027)])
def test_asym_match_equals_jax_script(sims_a, sims_b, seed):
    pairs = 3
    want = _jax_asym_match(pairs, sims_a, sims_b, seed, jtiny())
    got = asym_match.play(fake_eval_torch, eval_b_torch, pairs, sims_a,
                          sims_b, seed, tiny_config(), "cpu")
    assert got[:2] == want[:2] and sum(got[:2]) == 2 * pairs
    _assert_states_equal(got[2], want[2])


def test_measure_ratio_times_in_turns(monkeypatch):
    """A warm-up search with each evaluator, then int8, bf16, bf16, int8;
    the ratio is the sum of int8's rates over the sum of bf16's."""
    evals = {"int8": fake_eval_torch, "bf16": eval_b_torch}
    name_of = {id(fn): name for name, fn in evals.items()}
    order, real = [], asym_match._greedy

    def greedy(states, eval_fn, spec):
        order.append(name_of[id(eval_fn)])
        return real(states, eval_fn, spec)

    monkeypatch.setattr(asym_match, "_greedy", greedy)
    out = asym_match.measure_ratio(evals, 2, 4, 2026, tiny_config(), "cpu")
    assert order == ["int8", "bf16", "int8", "bf16", "bf16", "int8"]
    assert (out["games"], out["sims"]) == (4, 4)
    assert len(out["int8_sims_per_s"]) == len(out["bf16_sims_per_s"]) == 2
    assert out["ratio"] == pytest.approx(
        sum(out["int8_sims_per_s"]) / sum(out["bf16_sims_per_s"]))


# -----------------------------------------------------------------------------
# vs_baseline: scripts/eval_vs_baseline.py
# -----------------------------------------------------------------------------

def _jax_vs_baseline(n_games, opening_plies, depth, sims):
    """The script's games (eval_vs_baseline.py:59-110) one after another,
    the toy evaluator for the net and the baseline at a fixed depth; each
    game's move list and whether AlphaZero won."""
    spec = jmcts.SearchSpec(num_simulations=sims, c_puct=1.5)

    @jax.jit
    def az_move(states):
        tree = jmcts.search(states, fake_eval_jax, spec)
        return jmcts.root_action_probs(tree, 0.0).argmax(-1)

    out = []
    for i in range(n_games):
        az_white = i % 2 == 0
        pair = i // 2
        g = (JOracle() if opening_plies == 0 or pair == 0 else
             jmatch.random_opening(random.Random(1000 + pair),
                                   opening_plies))
        moves = []
        engine = JSearch(time_limit_ms=10**7)
        while not g.is_terminal() and g.move_count < 512:
            if (g.turn == jenv.WHITE) == az_white:
                states = jenv.EnvState(
                    board=jnp.asarray(g.board[None]),
                    turn=jnp.asarray([g.turn], jnp.int8),
                    winner=jnp.zeros((1,), jnp.int8),
                    done=jnp.zeros((1,), bool),
                    move_count=jnp.asarray([g.move_count], jnp.int32))
                move = g.decode_action(int(np.asarray(az_move(states))[0]))
            else:
                w = b = 0
                for r in range(8):
                    for c in range(8):
                        v = g.board[r, c]
                        if v == jenv.WHITE:
                            w |= 1 << (r * 8 + c)
                        elif v == jenv.BLACK:
                            b |= 1 << (r * 8 + c)
                (frm, to), _, _ = engine.search(JPosition(w, b, g.turn),
                                                time_ms=10**7,
                                                max_depth=depth)
                move = (frm // 8, frm % 8, to // 8, to % 8)
            g.step(move)
            moves.append(move)
        wl = g.get_result()
        out.append((moves, (wl[0] == 1.0) == az_white))
    return out


class _Recorded(OracleGame):
    def step(self, move):
        self.moves = getattr(self, "moves", []) + [tuple(move)]
        super().step(move)


def _with_moves(game: OracleGame) -> _Recorded:
    """``game`` as a ``_Recorded`` game that lists the moves it is given
    from now on."""
    g = _Recorded.__new__(_Recorded)
    g.__dict__.update(game.__dict__)
    g.moves = []
    return g


def test_vs_baseline_equals_jax_script(monkeypatch):
    n_games, plies, depth, sims = 4, 4, 2, 24
    want = _jax_vs_baseline(n_games, plies, depth, sims)

    real = vs_baseline.make_opening
    monkeypatch.setattr(vs_baseline, "make_opening", lambda pair, plies: (
        _with_moves(real(pair, plies))))
    cfg = tiny_config(num_simulations_inference=sims)
    ended = []
    out = vs_baseline.play_games(
        vs_baseline.alphazero_player(fake_eval_torch, cfg, "cpu"),
        list(range(n_games)), 10**7, plies, max_depth=depth,
        on_end=lambda i, g, won: ended.append(i))
    assert sorted(ended) == list(range(n_games))
    for i, (moves, won) in enumerate(want):
        assert out["games"][i].moves == moves, i
        assert out["az_won"][i] == won, i
    assert out["az_moves"] + out["baseline_moves"] == sum(
        len(m) for m, _ in want)
    assert out["baseline_nodes"] > 0


def test_vs_baseline_openings_follow_the_script():
    """Pair 0 and opening_plies 0 are the standard start; pair k the
    seeded random opening of Random(1000 + k)."""
    start = OracleGame()
    for pair, plies in ((0, 4), (3, 0)):
        np.testing.assert_array_equal(
            vs_baseline.make_opening(pair, plies).board, start.board)
    for pair in (1, 5):
        want = jmatch.random_opening(random.Random(1000 + pair), 4)
        got = vs_baseline.make_opening(pair, 4)
        np.testing.assert_array_equal(got.board, want.board)
        assert (got.turn, got.move_count) == (want.turn, want.move_count)


# -----------------------------------------------------------------------------
# calibration and the modules' entry points
# -----------------------------------------------------------------------------

def test_calibration_follows_the_jax_rule(tmp_path):
    ck = tmp_path / "checkpoints"
    (ck / "iteration_3").mkdir(parents=True)
    states = np.random.default_rng(0).integers(
        0, 2, (700, 3, 8, 8)).astype(np.uint8)
    np.savez(ck / "training_data.npz", states=states)
    got, what = common.calibration_batches(str(ck / "iteration_3"), "cpu")
    # eval_quant_match.py:66-73
    ci = np.sort(np.random.RandomState(42).choice(len(states), 512,
                                                  replace=False))
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), states[ci][i * 256:(i + 1) * 256].astype(
                np.float32))
    assert "512 replay positions" in what

    # an archive has no replay file: 1,024 random-play positions
    got, what = common.calibration_batches(common.ARCHIVE, "cpu")
    assert [tuple(b.shape) for b in got] == [(512, 3, 8, 8)] * 2
    assert "1024 random-play positions" in what
    from alphazero_torch.env import breakthrough as tenv

    np.testing.assert_array_equal(
        got[1].numpy(),
        tenv.encoded_state(common.random_positions(512, 52)).numpy())


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    from alphazero_torch.train import Trainer

    ck = tmp_path_factory.mktemp("strength") / "checkpoints"
    cfg = tiny_config(checkpoint_dir=str(ck), num_blocks=1, num_filters=8)
    Trainer(cfg, seed=3, device="cpu").save(1)
    return str(ck / "iteration_1")


def test_quant_and_asym_match_mains(tiny_checkpoint, capsys, monkeypatch):
    monkeypatch.setenv("AZTPU_MATCH_SEED", "7")
    quant_match.main([tiny_checkpoint, "1", "2", "--cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("device: cpu")
    assert "calibrated on 1024 random-play positions" in out[1]
    assert out[-1].startswith("int8-static ") and "over 2 games at 2 sims" \
        in out[-1] and "(seed 7," in out[-1]

    monkeypatch.setenv("AZTPU_QUANT_FLAVOR", "dynamic")
    quant_match.main([tiny_checkpoint, "1", "2", "--cpu"])
    assert "int8-dynamic" in capsys.readouterr().out

    asym_match.main([tiny_checkpoint, "1", "3", "2", "--cpu",
                     "--ratio-from-card"])
    out = capsys.readouterr().out.splitlines()
    assert out[2].startswith("ratio {")
    assert "bf16@2 over 2 games" in out[-1]


def test_vs_baseline_main(tiny_checkpoint, capsys, monkeypatch):
    monkeypatch.setattr(vs_baseline, "Config", lambda: tiny_config(
        num_simulations_inference=4))
    vs_baseline.main([tiny_checkpoint, "2", "5", "2", "--cpu"])
    out = capsys.readouterr().out.splitlines()
    games = [line for line in out if line.startswith("game ")]
    assert {g.split(":")[0] for g in games} == {"game 1/2", "game 2/2"}
    assert "(4 sims) vs baseline (5ms, openings=2): " in out[-1]
