"""The tree check on trees the program searched on the CPU: a sound tree
reads no mismatch, and a tree changed after the search does."""

import numpy as np
import pytest
import torch

from benchmark.lib import program, refenv, treecheck, weights

SIMS = 48


@pytest.fixture(scope="module")
def searched():
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import mcts
    from alphazero_torch.train import selfplay

    cfg = program.program_config(
        {"num_blocks": 2, "num_filters": 32, "se_ratio": 8},
        num_simulations=SIMS)
    w = weights.seeded(weights.leaf_shapes(2, 32, 8), 2 ** 40 + 9, "cpu")
    net = program.build_net(cfg, w, "cpu")
    eval_fn = mcts.make_net_evaluator(net, torch.float32)
    spec = selfplay.search_spec(cfg)
    gen = torch.Generator().manual_seed(5)
    states = env.initial_state((4,), device="cpu")
    tree = mcts.init_tree(states, spec)
    for _ in range(5):
        states, *_ = selfplay.selfplay_move_autoreset(
            states, gen, eval_fn, spec, 16, tree)
    return tree


def judge(tree, lane, rows=None):
    return treecheck.judge(
        tree.rows[lane].numpy() if rows is None else rows,
        tree.root_state.board[lane].numpy(),
        int(tree.root_state.turn[lane]), int(tree.root_visit[lane]),
        float(tree.root_vsum[lane]), SIMS, 1.5, root_noise=True)


@pytest.mark.parametrize("lane", range(4))
def test_a_sound_tree_reads_no_mismatch(searched, lane):
    j = judge(searched, lane)
    assert j.tree_mismatch == 0 and j.env_mismatch == 0
    assert j.select_gap <= treecheck.SELECT_TOL
    assert len(j.planes) == len(j.prior) == len(j.value)


def _flat(tree, lane):
    rows = tree.rows[lane].numpy().copy()
    return rows, rows.reshape(rows.shape[0], -1)


def test_an_extra_visit_is_a_mismatch(searched):
    rows, flat = _flat(searched, 0)
    a = int(flat[0, 384:576].argmax())
    flat[0, 384 + a] += 1
    assert judge(searched, 0, rows).tree_mismatch > 0


def test_a_choice_against_the_scores_is_a_mismatch(searched):
    # the root's priors reversed after the search: the edges the search
    # chose are no longer the best by PUCT
    rows, flat = _flat(searched, 1)
    legal = flat[0, :192] != treecheck.ILLEGAL
    flat[0, 192:384][legal] = flat[0, 192:384][legal][::-1].copy()
    j = judge(searched, 1, rows)
    assert j.select_gap > treecheck.SELECT_TOL and j.tree_mismatch > 0


def test_a_child_on_another_square_is_an_env_mismatch(searched):
    # a root edge's child pointer moved to an action that is illegal there
    rows, flat = _flat(searched, 2)
    board = searched.root_state.board[2].numpy()[None]
    turn = searched.root_state.turn[2].numpy()[None]
    legal = refenv.legal_mask(board, turn)[0]
    illegal = int(np.flatnonzero(~legal)[0])
    flat[0, illegal] = treecheck.UNALLOCATED
    assert judge(searched, 2, rows).env_mismatch > 0
