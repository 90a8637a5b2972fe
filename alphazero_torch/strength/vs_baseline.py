"""Absolute strength anchor: AlphaZero against the classical engine.

Port of ``scripts/eval_vs_baseline.py``. Plays N games, colours
alternating (AlphaZero White in even games), between a net (greedy
``num_simulations_inference``-simulation search, no noise, bf16
evaluator) and the baseline alpha-beta engine (``baseline/``) at a fixed
time budget a move, and reports the score.

    python -m alphazero_torch.strength.vs_baseline [weights] [games] \\
        [baseline_ms] [opening_plies]

``weights`` is a port checkpoint directory or an archive npz (default:
the trained archive). Defaults: 10 games, 500 ms, no opening plies. With
``opening_plies`` > 0, games 2k and 2k+1 share the seeded random opening
``random_opening(random.Random(1000 + k), opening_plies)`` (pair 0 is the
standard start). A game stops at 512 plies. ``--cpu`` runs on the CPU.

The AlphaZero moves of all games run in lockstep, one batched search per
round over the games where AlphaZero is to move; each game's moves stay
its own. The baseline moves run one game at a time, each game with its
own engine (and transposition table). The baseline's search is bounded
by the wall clock, so its moves are not reproducible; tests fix its depth
(``max_depth``) instead.
"""

from __future__ import annotations

import argparse
import random
import time
from typing import Callable, Dict, List, Optional

import torch

from alphazero_torch import resolve_device
from alphazero_torch.arena.match import random_opening
from alphazero_torch.baseline import Search, from_board
from alphazero_torch.config import Config
from alphazero_torch.env import WHITE, OracleGame
from alphazero_torch.env.oracle import live_states
from alphazero_torch.search import (
    SearchSpec,
    make_net_evaluator,
    root_action_probs,
    search,
)
from alphazero_torch.strength.common import (
    ARCHIVE,
    device_line,
    load_net,
)

MAX_PLIES = 512
OPENING_SEED = 1000


def make_opening(pair: int, opening_plies: int) -> OracleGame:
    if opening_plies == 0 or pair == 0:
        return OracleGame()
    return random_opening(random.Random(OPENING_SEED + pair), opening_plies)


def alphazero_player(eval_fn, cfg: Config, device
                     ) -> Callable[[List[OracleGame]], List[int]]:
    """games -> the greedy most-visited action of each, by one batched
    search at ``cfg.num_simulations_inference`` with no noise."""
    dev = resolve_device(device)
    spec = SearchSpec(num_simulations=cfg.num_simulations_inference,
                      c_puct=cfg.c_puct, fpu_reduction=cfg.fpu_reduction)

    def actions(games: List[OracleGame]) -> List[int]:
        states = live_states(games, dev)
        tree = search(states, eval_fn, spec)
        return root_action_probs(tree, 0.0).argmax(-1).tolist()

    return actions


def play_games(az_actions: Callable[[List[OracleGame]], List[int]],
               game_ids: List[int], baseline_ms: int, opening_plies: int,
               max_depth: Optional[int] = None, on_end=None) -> Dict:
    """Plays the games ``game_ids`` (game i: AlphaZero White when i is
    even, opening of pair i // 2) to the end or ``MAX_PLIES``.

    Returns {"games": {i: OracleGame}, "az_won": {i: bool}, and the
    seconds and counts of both players' moves}. ``on_end(i, game, won)``
    is called as each game ends."""
    games = {i: make_opening(i // 2, opening_plies) for i in game_ids}
    engines = {i: Search(time_limit_ms=baseline_ms) for i in game_ids}
    az_white = {i: i % 2 == 0 for i in game_ids}
    stats = {"az_rounds": 0, "az_moves": 0, "az_s": 0.0,
             "baseline_moves": 0, "baseline_s": 0.0, "baseline_nodes": 0,
             "baseline_depth": 0}
    won: Dict[int, bool] = {}

    def live(i):
        return not games[i].is_terminal() and games[i].move_count < MAX_PLIES

    def finish(i):
        if i not in won and not live(i):
            w, _ = games[i].get_result()
            won[i] = (w == 1.0) == az_white[i]
            if on_end is not None:
                on_end(i, games[i], won[i])

    while len(won) < len(game_ids):
        az = [i for i in game_ids
              if live(i) and (games[i].turn == WHITE) == az_white[i]]
        if az:
            t0 = time.perf_counter()
            acts = az_actions([games[i] for i in az])
            stats["az_s"] += time.perf_counter() - t0
            stats["az_rounds"] += 1
            stats["az_moves"] += len(az)
            for i, a in zip(az, acts):
                games[i].step_action(int(a))
                finish(i)
        for i in game_ids:
            if not live(i) or (games[i].turn == WHITE) == az_white[i]:
                finish(i)
                continue
            t0 = time.perf_counter()
            pos = from_board(games[i].board, games[i].turn)
            (frm, to), _, info = engines[i].search(
                pos, time_ms=baseline_ms, max_depth=max_depth)
            stats["baseline_s"] += time.perf_counter() - t0
            stats["baseline_moves"] += 1
            stats["baseline_nodes"] += info["nodes"]
            stats["baseline_depth"] += info["depth"]
            games[i].step((frm // 8, frm % 8, to // 8, to % 8))
            finish(i)
    return {"games": games, "az_won": won, **stats}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m alphazero_torch.strength.vs_baseline",
        description="AlphaZero against the classical baseline engine")
    p.add_argument("weights", nargs="?", default=ARCHIVE)
    p.add_argument("games", nargs="?", type=int, default=10)
    p.add_argument("baseline_ms", nargs="?", type=int, default=500)
    p.add_argument("opening_plies", nargs="?", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = Config()
    game_ids = list(range(args.games))

    net = load_net(args.weights, dev)
    print(f"weights: {args.weights}; device: {device_line(dev)}", flush=True)
    az = alphazero_player(make_net_evaluator(net, torch.bfloat16), cfg, dev)

    def on_end(i, game, won):
        tag = (f"opening {i // 2}" if args.opening_plies else
               "standard start")
        print(f"game {i + 1}/{args.games}: AZ as "
              f"{'White' if i % 2 == 0 else 'Black'} ({tag}) -> "
              f"{'WIN' if won else 'loss'} in {game.move_count} plies",
              flush=True)

    t0 = time.time()
    out = play_games(az, game_ids, args.baseline_ms, args.opening_plies,
                     on_end=on_end)
    wins = sum(out["az_won"].values())
    n = len(game_ids)
    print(f"AZ move rounds {out['az_rounds']} ({out['az_moves']} moves) "
          f"{out['az_s']:.1f} s, {out['az_s'] / max(out['az_rounds'], 1):.3f}"
          f" s a round; baseline {out['baseline_moves']} moves "
          f"{out['baseline_s']:.1f} s, "
          f"{out['baseline_nodes'] / max(out['baseline_s'], 1e-9):.0f} "
          f"nodes/s, mean depth "
          f"{out['baseline_depth'] / max(out['baseline_moves'], 1):.2f}",
          flush=True)
    print(f"\n{args.weights} ({cfg.num_simulations_inference} sims) vs "
          f"baseline ({args.baseline_ms}ms, openings={args.opening_plies})"
          f": {wins}/{n} "
          f"({100 * wins / n:.0f}%) in {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
