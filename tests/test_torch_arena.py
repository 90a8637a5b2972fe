"""PyTorch port's arena and search context held against the JAX package's.

``search(..., eval_ctx=)`` under a shared evaluator that switches its
weights by the per-game flag (float64 trees, visit counts equal); paired
matches under a shared pair evaluator (the same final boards and results);
``ArenaState``, ``select_matchup`` and ``OracleGame`` against the JAX
package's; ``run_arena`` over two tiny port checkpoints, as
``tests/test_arena_integration.py`` runs the JAX one.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from alphazero_tpu.arena import elo as jelo
from alphazero_tpu.arena import match as jmatch
from alphazero_tpu.arena import runner as jrunner
from alphazero_tpu.config import tiny_config as jtiny
from alphazero_tpu.env import OracleGame as JOracle
from alphazero_tpu.search import mcts as jmcts
from tests.test_mcts import _BASE_W, _SQ_OF_ACTION, states_from_games
from tests.test_torch_mcts import _games, _noise, torch_states_from_games

from alphazero_torch.arena import elo, match, runner
from alphazero_torch.config import tiny_config
from alphazero_torch.env import OracleGame
from alphazero_torch.search import mcts as tmcts

# the second player's prior weights: another set of small integers
_BASE_W_B = ((np.arange(len(_BASE_W)) * 3) % 7 + 1).astype(_BASE_W.dtype)


def ctx_eval_jax(planes, a_to_move):
    """tests/test_mcts.py's exact toy evaluator with the weights of player
    A or B by game: integer priors, values in sixteenths."""
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    boost = 1.0 + mine[:, _SQ_OF_ACTION]
    w = jnp.where(a_to_move[:, None], jnp.asarray(_BASE_W) * boost,
                  jnp.asarray(_BASE_W_B) * boost)
    v = (mine.sum(-1) - theirs.sum(-1)) / 16.0
    return w.astype(jnp.float32), jnp.where(a_to_move, v, -v / 2).astype(
        jnp.float32)


def ctx_eval_torch(planes, a_to_move):
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    boost = 1.0 + mine[:, torch.from_numpy(_SQ_OF_ACTION).long()]
    w = torch.where(a_to_move[:, None], torch.from_numpy(_BASE_W) * boost,
                    torch.from_numpy(_BASE_W_B) * boost)
    v = (mine.sum(-1) - theirs.sum(-1)) / 16.0
    return w.float(), torch.where(a_to_move, v, -v / 2).float()


@pytest.mark.parametrize("noise", [False, True], ids=["plain", "noise"])
def test_search_eval_ctx_equals_jax(noise):
    games = _games(23, 12)
    ctx = np.asarray([i % 3 != 0 for i in range(len(games))])
    nz = _noise(5, games) if noise else None
    spec = jmcts.SearchSpec(num_simulations=40,
                            value_dtype=jnp.dtype("float64"))
    with jax.enable_x64():
        tree = jax.jit(lambda s, c, n: jmcts.search(
            s, ctx_eval_jax, spec, eval_ctx=c, root_noise=n))(
            states_from_games(games), jnp.asarray(ctx),
            None if nz is None else jnp.asarray(nz))
        want = np.asarray(jmcts.root_child_visits(tree))
    got = tmcts.search(
        torch_states_from_games(games), ctx_eval_torch,
        tmcts.SearchSpec(num_simulations=40, value_dtype=torch.float64),
        eval_ctx=torch.from_numpy(ctx),
        root_noise=None if nz is None else torch.from_numpy(nz))
    np.testing.assert_array_equal(tmcts.root_child_visits(got).numpy(), want)
    # the context matters: without it the search sees player A everywhere
    alone = tmcts.search(
        torch_states_from_games(games),
        lambda p: ctx_eval_torch(p, torch.ones(p.shape[0], dtype=bool)),
        tmcts.SearchSpec(num_simulations=40, value_dtype=torch.float64))
    assert not torch.equal(tmcts.root_child_visits(alone),
                           tmcts.root_child_visits(got))


def test_paired_matches_equal_jax(monkeypatch):
    """The same openings and a shared pair evaluator: the same final
    boards, winners and (wins_a, wins_b) in both packages."""
    rng = random.Random(11)
    openings_j = [JOracle()] + [jmatch.random_opening(rng) for _ in range(3)]
    openings_t = [OracleGame()]
    rng = random.Random(11)
    openings_t += [match.random_opening(rng) for _ in range(3)]
    for a, b in zip(openings_j, openings_t):
        np.testing.assert_array_equal(a.board, b.board)
        assert a.turn == b.turn

    finals = {}

    def record(module, key):
        inner = module._match_move

        def move(*a, **kw):
            finals[key] = inner(*a, **kw)
            return finals[key]
        monkeypatch.setattr(module, "_match_move", move)

    record(jmatch, "jax")
    record(match, "torch")
    kw = dict(num_simulations=12, max_moves=300)
    want = jmatch.play_paired_matches(None, None, None, None, openings_j,
                                      jtiny(), pair_eval_fn=ctx_eval_jax,
                                      **kw)
    got = match.play_paired_matches(None, None, openings_t, tiny_config(),
                                    pair_eval_fn=ctx_eval_torch,
                                    device="cpu", **kw)
    assert got == want and sum(got) == 8
    for f in ("board", "turn", "winner", "done"):
        np.testing.assert_array_equal(
            getattr(finals["torch"], f).numpy(),
            np.asarray(getattr(finals["jax"], f)))


def test_arena_state_and_matchmaking_equal_jax(tmp_path):
    jst = jelo.ArenaState(jtiny(checkpoint_dir=str(tmp_path / "j")))
    tst = elo.ArenaState(tiny_config(checkpoint_dir=str(tmp_path / "t")))
    rng = np.random.default_rng(3)
    names = [f"iteration_{i}" for i in range(1, 8)]
    for _ in range(25):
        a, b = rng.choice(names, 2, replace=False)
        wa = int(rng.integers(0, 5))
        for st in (jst, tst):
            st.record_match(str(a), str(b), wa, 4 - wa)
    assert tst.ratings == pytest.approx(jst.ratings, rel=0, abs=0)
    assert tst.leaderboard() == jst.leaderboard()
    assert tst.best_model == jst.best_model
    assert tst.match_counts == jst.match_counts
    reloaded = elo.ArenaState(tst.cfg)
    assert reloaded.ratings == tst.ratings
    assert reloaded.match_counts == tst.match_counts
    assert elo.expected_score(1400, 1000) == jelo.expected_score(1400, 1000)
    # the same choices from the same seed, exploration included
    rj, rt = random.Random(5), random.Random(5)
    for _ in range(40):
        assert runner.select_matchup(tst, rt) == jrunner.select_matchup(
            jst, rj)
    assert runner.select_matchup(elo.ArenaState(
        tiny_config(checkpoint_dir=str(tmp_path / "empty")))) is None


def test_oracle_move_for_move_equal_jax():
    rng = np.random.default_rng(8)
    for _ in range(12):
        j, t = JOracle(), OracleGame()
        while not t.is_terminal():
            assert j.get_legal_actions() == t.get_legal_actions()
            assert (j.get_legal_actions_reference_order()
                    == t.get_legal_actions_reference_order())
            np.testing.assert_array_equal(j.get_encoded_state(),
                                          t.get_encoded_state())
            a = int(rng.choice(t.get_legal_actions()))
            assert j.decode_action(a) == t.decode_action(a)
            assert t.encode_action(t.decode_action(a)) == a
            j.step_action(a)
            t.step_action(a)
            np.testing.assert_array_equal(j.board, t.board)
            assert (j.turn, j.winner, j.move_count) == (t.turn, t.winner,
                                                        t.move_count)
        assert j.is_terminal() and j.get_result() == t.get_result()
        assert str(j) == str(t)


def test_run_arena_one_round(tmp_path):
    """discover -> select -> load -> play paired matches -> record ELO ->
    model_best, over two tiny port checkpoints with different weights."""
    import os

    from alphazero_torch.train import Trainer

    cfg = tiny_config(checkpoint_dir=str(tmp_path / "ckpt"), num_blocks=1,
                      num_filters=8, num_simulations=4,
                      num_simulations_inference=4, max_game_length=160)
    for it, seed in ((1, 0), (2, 99)):
        Trainer(cfg, seed=seed, device="cpu").save(it)
    runner.run_arena(cfg, max_rounds=1, seed=7, device="cpu")

    state = elo.ArenaState(cfg)
    assert set(state.ratings) == {"iteration_1", "iteration_2"}
    assert len(state.matches) == 1
    m = state.matches[0]
    assert m["wins_a"] + m["wins_b"] == 4
    assert state.get_match_count("iteration_1", "iteration_2") == 4
    ra, rb = state.ratings["iteration_1"], state.ratings["iteration_2"]
    assert np.isclose(ra + rb, 2000.0)
    assert state.best_model in ("iteration_1", "iteration_2")
    assert os.path.isdir(cfg.checkpoint_path(cfg.best_model))
    # the loader rebuilds each checkpoint's own architecture and weights
    net = runner.load_model(cfg.replace(num_blocks=5), cfg.checkpoint_path(
        "iteration_2"), device="cpu")
    assert len(net.blocks) == 1


def test_entry_points_raise_without_a_card_unless_given_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from alphazero_torch.bench import run_bench

    cfg = tiny_config(checkpoint_dir=str(tmp_path))
    calls = [
        lambda: match.play_paired_matches(None, None, [OracleGame()], cfg,
                                          pair_eval_fn=ctx_eval_torch),
        lambda: runner.run_arena(cfg, max_rounds=1),
        lambda: runner.load_model(cfg, str(tmp_path)),
        lambda: run_bench(archive=None, cfg=cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # on the CPU, asked for: a match runs (the kernels' plain versions)
    assert sum(match.play_paired_matches(
        None, None, [OracleGame()], cfg, num_simulations=2,
        pair_eval_fn=ctx_eval_torch, device="cpu")) == 2
