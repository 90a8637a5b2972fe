"""Batched model-vs-model matches.

Port of ``alphazero_tpu/arena/match.py``. All games of a match run as ONE
lockstep batch; each move runs a single batched search where a per-game
flag, the search's ``eval_ctx``, routes every evaluation to the searching
player's net: both nets are evaluated on the whole batch and rows are
selected, one forward each instead of two half-batches.

Match semantics: greedy most-visited move, no Dirichlet noise,
``num_simulations_inference`` simulations, paired games from a shared
opening with colours swapped, random 6-move openings, at most
``max_game_length`` moves.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np
import torch

from alphazero_torch import resolve_device
from alphazero_torch.config import Config
from alphazero_torch.env import OracleGame
from alphazero_torch.env import breakthrough as env
from alphazero_torch.env.oracle import live_states
from alphazero_torch.search import (
    SearchSpec,
    Tree,
    init_tree,
    make_net_evaluator,
    root_action_probs,
    search,
)

RANDOM_OPENING_MOVES = 6


def random_opening(rng: random.Random,
                   num_moves: int = RANDOM_OPENING_MOVES) -> OracleGame:
    """A random legal opening of ``num_moves`` plies."""
    g = OracleGame()
    for _ in range(num_moves):
        if g.is_terminal():
            break
        moves = g.get_legal_actions()
        if not moves:
            break
        g.step_action(rng.choice(moves))
    return g


def select_evaluator(eval_a, eval_b):
    """eval_fn(planes, a_to_move (B,) bool): both evaluators on the whole
    batch, rows selected by ``a_to_move``. Two MuZero evaluators give a
    recurrent pair (``muzero_inference.PairEvaluator``) that shares the
    tree's latent store; a MuZero net plays only a MuZero net."""
    from alphazero_torch.search.mcts import is_recurrent

    if is_recurrent(eval_a) or is_recurrent(eval_b):
        if not (is_recurrent(eval_a) and is_recurrent(eval_b)):
            raise ValueError("a MuZero net searches its own hidden states: "
                             "it plays another MuZero net only")
        from alphazero_torch.models.muzero_inference import PairEvaluator

        return PairEvaluator(eval_a, eval_b)

    def eval_fn(planes, a_to_move):
        pa, va = eval_a(planes)
        pb, vb = eval_b(planes)
        return (torch.where(a_to_move[:, None], pa, pb),
                torch.where(a_to_move, va, vb))

    return eval_fn


def make_pair_evaluator(net_a, net_b, dtype):
    """``select_evaluator`` over the two nets' evaluators in ``dtype``.
    The two nets may differ in architecture."""
    return select_evaluator(make_net_evaluator(net_a, dtype),
                            make_net_evaluator(net_b, dtype))


def paired_states(openings: List[OracleGame], device) -> env.EnvState:
    """Each opening twice in a row (games 2k and 2k+1), move counts from
    zero, on ``device``."""
    states = live_states([g for g in openings for _ in range(2)],
                         resolve_device(device))
    states.move_count.zero_()
    return states


def wins(states: env.EnvState, a_is_white: torch.Tensor) -> Tuple[int, int]:
    """(wins_a, wins_b) over the batch; unfinished games count for
    neither."""
    winners = states.winner.cpu().numpy()
    a_white = a_is_white.cpu().numpy()
    a_won = np.where(a_white, winners == env.WHITE, winners == env.BLACK)
    b_won = np.where(a_white, winners == env.BLACK, winners == env.WHITE)
    return int(a_won.sum()), int(b_won.sum())


def _match_move(states: env.EnvState, a_is_white: torch.Tensor, eval_fn,
                spec: SearchSpec, tree: Tree | None = None) -> env.EnvState:
    """One greedy lockstep move for all games of a match. ``tree``, the
    tree of an earlier move of the match, is reset in place and searched,
    so that every move replays the first one's captured simulation (with
    this move's ``a_to_move`` copied into its context buffer)."""
    a_to_move = torch.where(states.turn == env.WHITE, a_is_white, ~a_is_white)
    if tree is not None:
        tree = init_tree(states, spec, tree=tree)
    tree = search(states, eval_fn, spec, tree=tree, eval_ctx=a_to_move)
    actions = root_action_probs(tree, 0.0).argmax(-1).int()  # most visited
    return env.step(states, actions)


def play_paired_matches(
    net_a,
    net_b,
    openings: List[OracleGame],
    cfg: Config,
    num_simulations: int | None = None,
    max_moves: int | None = None,
    pair_eval_fn=None,
    device="cuda",
) -> Tuple[int, int]:
    """Play each opening twice (colours swapped) in one lockstep batch on
    ``device``.

    Returns (wins_a, wins_b). Game 2k: A as White; game 2k+1: B as White.
    The default evaluator runs the nets at ``cfg.inference_dtype``.
    ``pair_eval_fn(planes, a_to_move)`` overrides it, to match two
    inference paths over the same weights (e.g. int8 against bf16); the
    nets are ignored then.
    """
    dev = resolve_device(device)
    sims = num_simulations or cfg.num_simulations_inference
    spec = SearchSpec(num_simulations=sims, c_puct=cfg.c_puct,
                      fpu_reduction=cfg.fpu_reduction)
    max_moves = max_moves or cfg.max_game_length

    states = paired_states(openings, dev)
    a_is_white = torch.arange(states.turn.shape[0], device=dev) % 2 == 0

    eval_fn = pair_eval_fn or make_pair_evaluator(
        net_a, net_b, getattr(torch, cfg.inference_dtype))
    tree = init_tree(states, spec)
    for _ in range(max_moves):
        if bool(states.done.all()):
            break
        states = _match_move(states, a_is_white, eval_fn, spec, tree)
    return wins(states, a_is_white)
