"""Self-play actor: batched noisy MCTS games producing training examples.

Port of ``alphazero_tpu/train/selfplay.py``:

- N games advance in lockstep; every move runs a full search with root
  Dirichlet noise;
- temperature 1 for the first ``temperature_threshold`` moves of each
  game, then 0 (argmax);
- actions are sampled from the visit-count distribution (Gumbel-max over
  log-probabilities, as ``jax.random.categorical`` does);
- finished games emit (planes uint8, visit probs f32, WL f32) examples
  with WL from the side of the player who moved.

Per-move outputs stay on the device; the host syncs a done flag every
``CHECK_EVERY`` moves and copies the recorded episodes once at the end.
Randomness comes from one ``torch.Generator`` on the games' device.
Each lockstep move is a move record (``alphazero_torch.tracing.move``), its
body the span ``selfplay.move``, holding the search's spans and the host's
work around them: ``selfplay.reset_tree``, ``selfplay.sample`` and
``selfplay.autoreset``.

A game loop keeps one tree for all its moves: a fresh-root move resets it
in place (``init_tree(..., tree=)``) and tree reuse re-roots it in place
(``advance_root``), so on the card every move replays the simulation the
first one captured (``search/graph.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from alphazero_torch import resolve_device, tracing
from alphazero_torch.config import Config
from alphazero_torch.env import breakthrough as env
from alphazero_torch.search import (
    SearchSpec,
    Tree,
    advance_root,
    init_tree,
    root_action_probs,
    root_value,
    search,
)

CHECK_EVERY = 8


def search_spec(cfg: Config) -> SearchSpec:
    return SearchSpec(
        num_simulations=cfg.num_simulations,
        num_actions=cfg.num_actions,
        c_puct=cfg.c_puct,
        fpu_reduction=cfg.fpu_reduction,
        tree_reuse=cfg.tree_reuse,
        dirichlet_alpha=cfg.dirichlet_alpha,
        dirichlet_epsilon=cfg.dirichlet_epsilon,
        value_dtype=getattr(torch, cfg.value_dtype),
    )


def _searched_move(states, tree, generator, eval_fn, spec,
                   temperature_threshold):
    """Search + sample + step core shared by all move variants. ``tree``
    is a tree rooted at ``states`` (reused, or reset to fresh roots) or
    None (a new one). Returns (tree, planes, probs, actions, new_states)."""
    planes = env.encoded_state(states)
    tree = search(states, eval_fn, spec, generator=generator,
                  add_noise=True, tree=tree)

    with tracing.span("selfplay.sample"):
        temp = torch.where(states.move_count < temperature_threshold, 1.0,
                           0.0)
        probs = root_action_probs(tree, temp)

        # Finished games have no legal actions; give them a dummy action
        # (step() freezes them).
        safe = torch.where(states.done[:, None],
                           torch.full_like(probs, 1.0 / probs.shape[-1]),
                           probs)
        u = torch.rand(safe.shape, generator=generator, device=safe.device)
        gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
        actions = (torch.log(safe.clamp_min(1e-30)) + gumbel).argmax(-1)
        new_states = env.step(states, actions)
    return tree, planes, probs, actions.int(), new_states


def selfplay_move(states: env.EnvState, generator: torch.Generator, eval_fn,
                  spec: SearchSpec, temperature_threshold: int,
                  tree: Tree | None = None):
    """One lockstep move for a batch of games (fresh root per move).

    Returns (new_states, planes, probs, actions, root_values): the encoded
    position before the move, the visit-count policy recorded as a
    training target, and the sampled action applied. ``tree``, a tree of
    an earlier move at this shape, is reset to the fresh roots in place and
    searched (its buffers and captured simulation serve every move);
    None searches a new tree.
    """
    with tracing.move():
        tree, planes, probs, actions, new_states = _fresh_move(
            states, tree, generator, eval_fn, spec, temperature_threshold)
        return new_states, planes, probs, actions, root_value(tree)


def _fresh_move(states, tree, generator, eval_fn, spec,
                temperature_threshold):
    """``_searched_move`` on ``tree`` reset to fresh roots at ``states`` in
    place, or on a new tree where ``tree`` is None."""
    if tree is not None:
        with tracing.span("selfplay.reset_tree"):
            tree = init_tree(states, spec, tree=tree)
    return _searched_move(states, tree, generator, eval_fn, spec,
                          temperature_threshold)


def selfplay_move_tree(states: env.EnvState, tree: Tree,
                       generator: torch.Generator, eval_fn,
                       spec: SearchSpec, temperature_threshold: int):
    """One lockstep move WITH between-move tree reuse: searches the given
    tree (rooted at ``states``), then re-roots it at the chosen child, in
    place. Returns (new_states, planes, probs, actions, root_values,
    new_tree), ``new_tree`` being ``tree``."""
    with tracing.move():
        stree, planes, probs, actions, new_states = _searched_move(
            states, tree, generator, eval_fn, spec, temperature_threshold)
        values = root_value(stree)
        new_tree = advance_root(stree, actions, new_states, spec)
        return new_states, planes, probs, actions, values, new_tree


def _emit_examples(planes_all, probs_all, mover_all, m_idx, g_idx, winners,
                   actions_all=None, left=None):
    """(state, pi, WL-from-mover) examples for the selected (move, game)
    pairs. With ``actions_all`` (M, B) and ``left`` (the moves of its
    game after each pair) each example is a trajectory's ply, (state, pi,
    WL, action played, moves left), and the pairs must come game by game
    in move order."""
    white_won = (winners == env.WHITE).astype(np.float32)
    mover_is_white = (mover_all[m_idx, g_idx] == env.WHITE)
    win = np.where(mover_is_white, white_won, 1.0 - white_won)
    wls = np.stack([win, 1.0 - win], axis=-1).astype(np.float32)
    sel_planes = planes_all[m_idx, g_idx]
    sel_probs = probs_all[m_idx, g_idx]
    if actions_all is not None:
        acts = actions_all[m_idx, g_idx]
        return [(sel_planes[j], sel_probs[j], wls[j], int(acts[j]),
                 int(left[j])) for j in range(len(m_idx))]
    return [(sel_planes[j], sel_probs[j], wls[j]) for j in range(len(m_idx))]


def _to_numpy(recorded: List[torch.Tensor], dtype=None) -> np.ndarray:
    t = torch.stack(recorded)
    if dtype is not None:
        t = t.to(dtype)
    return t.cpu().numpy()


def selfplay_games(
    eval_fn,
    cfg: Config,
    generator: torch.Generator,
    num_games: int | None = None,
    max_moves: int | None = None,
    device="cuda",
    trajectory: bool = False,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray, np.ndarray]], dict]:
    """Play ``num_games`` lockstep self-play games to completion.

    Returns (examples, stats): examples are (planes (3,8,8) uint8 0/1,
    probs (192,) f32, wl (2,) f32) tuples; stats carries counters.
    ``generator`` must live on ``device``. With ``trajectory`` (MuZero's
    learner) each example also holds the action played and the moves left
    in its game, and the examples come game by game in move order.
    """
    dev = resolve_device(device)
    num_games = num_games or cfg.parallel_games
    max_moves = max_moves or cfg.max_game_length
    spec = search_spec(cfg)

    states = env.initial_state((num_games,), device=dev)
    tree = init_tree(states, spec)

    rec_planes, rec_probs, rec_mover, rec_active = [], [], [], []
    rec_actions = []
    moves_played = 0
    for m in range(max_moves):
        pre_turn = states.turn
        pre_active = ~states.done
        if spec.tree_reuse:
            states, planes, probs, actions, _, tree = selfplay_move_tree(
                states, tree, generator, eval_fn, spec,
                cfg.temperature_threshold)
        else:
            states, planes, probs, actions, _ = selfplay_move(
                states, generator, eval_fn, spec, cfg.temperature_threshold,
                tree)
        rec_actions.append(actions)
        rec_planes.append(planes)
        rec_probs.append(probs)
        rec_mover.append(pre_turn)
        rec_active.append(pre_active)
        moves_played = m + 1
        if (m + 1) % CHECK_EVERY == 0:
            with tracing.span("host.wait"):
                finished = bool(states.done.all())
            if finished:
                break

    planes_all = _to_numpy(rec_planes, torch.uint8)     # (M, B, 3, 8, 8)
    probs_all = _to_numpy(rec_probs)                    # (M, B, A)
    mover_all = _to_numpy(rec_mover)                    # (M, B)
    active_all = _to_numpy(rec_active)                  # (M, B)
    winner = states.winner.cpu().numpy()                # (B,)
    finished = states.done.cpu().numpy()                # (B,)

    # Emit every move of every FINISHED game (unfinished histories are
    # discarded, like the reference).
    emit = active_all & finished[None, :]               # (M, B)
    m_idx, g_idx = np.nonzero(emit)
    if trajectory:
        # game by game, in move order; a game's active moves are its first
        order = np.lexsort((m_idx, g_idx))
        m_idx, g_idx = m_idx[order], g_idx[order]
        plies = emit.sum(0)
        examples = _emit_examples(planes_all, probs_all, mover_all,
                                  m_idx, g_idx, winner[g_idx],
                                  _to_numpy(rec_actions),
                                  plies[g_idx] - 1 - m_idx)
    else:
        examples = _emit_examples(planes_all, probs_all, mover_all,
                                  m_idx, g_idx, winner[g_idx])

    stats = {
        "games": int(finished.sum()),
        "moves": int(emit.sum()),
        # only simulations that advanced a LIVE game count: frozen lanes
        # run masked no-op simulations in lockstep
        "simulations": int(active_all.sum()) * spec.num_simulations,
        "examples": len(examples),
        "moves_played": moves_played,
    }
    return examples, stats


def _reset_ended(states: env.EnvState, ended: torch.Tensor) -> env.EnvState:
    with tracing.span("selfplay.autoreset"):
        fresh = env.initial_state(tuple(states.turn.shape),
                                  device=states.device)
        return env.select_state(ended, fresh, states)


def selfplay_move_autoreset(states: env.EnvState, generator: torch.Generator,
                            eval_fn, spec: SearchSpec,
                            temperature_threshold: int,
                            tree: Tree | None = None):
    """One lockstep move where finished lanes immediately restart at the
    initial position, so every evaluation in every lane is real work.
    Returns (new_states, planes, probs, ended, winner): ``ended`` flags
    lanes whose episode completed ON this move, with ``winner`` its
    result; new_states holds fresh games for those lanes. ``tree`` as in
    ``selfplay_move``."""
    return _autoreset_move(states, generator, eval_fn, spec,
                           temperature_threshold, tree)[:5]


def _autoreset_move(states, generator, eval_fn, spec, temperature_threshold,
                    tree):
    """``selfplay_move_autoreset``'s move, with the actions played as a
    sixth result."""
    with tracing.move():
        _, planes, probs, actions, new_states = _fresh_move(
            states, tree, generator, eval_fn, spec, temperature_threshold)
        ended = new_states.done
        winner = new_states.winner
        return (_reset_ended(new_states, ended), planes, probs, ended, winner,
                actions)


def selfplay_move_autoreset_tree(states: env.EnvState, tree: Tree,
                                 generator: torch.Generator, eval_fn,
                                 spec: SearchSpec,
                                 temperature_threshold: int):
    """Auto-reset move with tree reuse: lanes whose episode ended restart
    with an EMPTY root (force_fresh); other lanes keep the chosen child's
    subtree. Returns (new_states, planes, probs, ended, winner, tree)."""
    with tracing.move():
        stree, planes, probs, actions, new_states = _searched_move(
            states, tree, generator, eval_fn, spec, temperature_threshold)
        ended = new_states.done
        winner = new_states.winner
        reset = _reset_ended(new_states, ended)
        new_tree = advance_root(stree, actions, reset, spec,
                                force_fresh=ended)
        return reset, planes, probs, ended, winner, new_tree


def selfplay_games_continuous(
    eval_fn,
    cfg: Config,
    generator: torch.Generator,
    num_games: int | None = None,
    max_moves: int | None = None,
    device="cuda",
    trajectory: bool = False,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray, np.ndarray]], dict]:
    """Play AT LEAST ``num_games`` self-play games with auto-resetting
    lanes. Every completed episode contributes all of its moves; episodes
    still in flight when the target is reached are discarded.
    ``trajectory`` as in ``selfplay_games``."""
    dev = resolve_device(device)
    num_games = num_games or cfg.parallel_games
    max_moves = max_moves or cfg.max_game_length
    spec = search_spec(cfg)
    B = min(num_games, cfg.parallel_games)

    states = env.initial_state((B,), device=dev)
    tree = init_tree(states, spec)

    rec_planes, rec_probs, rec_mover, rec_ended, rec_winner = \
        [], [], [], [], []
    rec_actions = []
    # generous cap: resets keep lanes busy, so num_games episodes need
    # about (num_games / B) * avg_game_length lockstep moves
    move_cap = max_moves * (num_games // B + 2)
    moves_played = 0
    completed = 0
    for m in range(move_cap):
        pre_turn = states.turn
        if spec.tree_reuse:
            (states, planes, probs, ended, winner,
             tree) = selfplay_move_autoreset_tree(
                states, tree, generator, eval_fn, spec,
                cfg.temperature_threshold)
        else:
            (states, planes, probs, ended, winner,
             actions) = _autoreset_move(states, generator, eval_fn, spec,
                                        cfg.temperature_threshold, tree)
            rec_actions.append(actions)
        rec_planes.append(planes)
        rec_probs.append(probs)
        rec_mover.append(pre_turn)
        rec_ended.append(ended)
        rec_winner.append(winner)
        moves_played = m + 1
        if (m + 1) % CHECK_EVERY == 0:
            with tracing.span("host.wait"):
                completed += int(torch.stack(rec_ended[-CHECK_EVERY:]).sum())
            if completed >= num_games:
                break

    mover_all = _to_numpy(rec_mover)                    # (M, B)
    ended_all = _to_numpy(rec_ended)                    # (M, B)
    winner_all = _to_numpy(rec_winner)                  # (M, B)
    planes_all = _to_numpy(rec_planes, torch.uint8)     # (M, B, 3, 8, 8)
    probs_all = _to_numpy(rec_probs)                    # (M, B, A)

    M = ended_all.shape[0]
    # Episode id per (move, lane): number of endings strictly BEFORE m.
    ep_id = np.zeros((M, B), np.int32)
    ep_id[1:] = np.cumsum(ended_all[:-1], axis=0)
    n_eps = ep_id[-1] + ended_all[-1]                   # completed per lane
    max_eps = int(n_eps.max()) if M else 0
    winner_of = np.zeros((B, max_eps + 1), np.int8)
    em, eb = np.nonzero(ended_all)
    winner_of[eb, ep_id[em, eb]] = winner_all[em, eb]
    ended_flag = np.zeros((B, max_eps + 1), bool)
    ended_flag[eb, ep_id[em, eb]] = True

    # emit moves belonging to COMPLETED episodes only
    lane = np.broadcast_to(np.arange(B)[None, :], (M, B))
    emit = ended_flag[lane, ep_id]
    m_idx, g_idx = np.nonzero(emit)
    if trajectory:
        if spec.tree_reuse:
            raise ValueError("trajectories are recorded without tree reuse")
        # game by game (lane, then episode), in move order
        order = np.lexsort((m_idx, g_idx))
        m_idx, g_idx = m_idx[order], g_idx[order]
        last = np.zeros((B, max_eps + 1), np.int64)
        last[eb, ep_id[em, eb]] = em
        winners = winner_of[g_idx, ep_id[m_idx, g_idx]]
        examples = _emit_examples(
            planes_all, probs_all, mover_all, m_idx, g_idx, winners,
            _to_numpy(rec_actions), last[g_idx, ep_id[m_idx, g_idx]] - m_idx)
    else:
        winners = winner_of[g_idx, ep_id[m_idx, g_idx]]
        examples = _emit_examples(planes_all, probs_all, mover_all,
                                  m_idx, g_idx, winners)

    stats = {
        "games": int(n_eps.sum()),
        "moves": int(emit.sum()),
        "simulations": moves_played * B * spec.num_simulations,
        "examples": len(examples),
        "moves_played": moves_played,
    }
    return examples, stats
