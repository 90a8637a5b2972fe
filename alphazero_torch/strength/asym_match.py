"""Equal-compute strength gate: int8-static at more simulations against
bf16.

Port of ``scripts/eval_asym_match.py``. The equal-sims gate
(``quant_match``) measures quantisation's strength cost at a fixed node
budget; the production question is strength per second. This plays
paired, colour-swapped games where player A searches with the int8-static
evaluator at ``sims_a`` and player B with the bf16 evaluator at
``sims_b``: with sims_a / sims_b at the two evaluators' measured speed
ratio both players spend the same time a move, and an int8 score of 50%
or more means int8 is at least as strong at any fixed time budget.

Asymmetric simulation counts need two searches: every ply runs both on
the full batch and picks each game's action by side to move (twice the
evaluation work, irrelevant for a strength measurement).

    python -m alphazero_torch.strength.asym_match [weights] [pairs] \\
        [sims_a] [sims_b] [--ratio-from-card]

Defaults: the trained archive, 16 pairs = 32 games, 300 against 200.
``--ratio-from-card`` first times both evaluators in turns at the match's
own shape (2 x pairs games, one search of ``sims_b`` simulations from the
openings: a warm-up search with each, then int8, bf16, bf16, int8), prints
the sims/s ratio and plays at sims_a = round(sims_b x ratio).
``AZTPU_MATCH_SEED`` seeds the openings (default 2026); ``--cpu`` runs on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

import torch

from alphazero_torch import resolve_device
from alphazero_torch.arena.match import paired_states, random_opening, wins
from alphazero_torch.config import Config
from alphazero_torch.env import breakthrough as env
from alphazero_torch.search import (
    SearchSpec,
    make_net_evaluator,
    root_action_probs,
    search,
)
from alphazero_torch.strength.common import (
    ARCHIVE,
    device_line,
    int8_evaluator,
    load_net,
    synchronize,
)


def spec_for(cfg: Config, sims: int) -> SearchSpec:
    return SearchSpec(num_simulations=sims, c_puct=cfg.c_puct,
                      fpu_reduction=cfg.fpu_reduction)


def _greedy(states, eval_fn, spec) -> torch.Tensor:
    return root_action_probs(search(states, eval_fn, spec),
                             0.0).argmax(-1).int()


def asym_move(states: env.EnvState, a_is_white: torch.Tensor, ev_a, ev_b,
              spec_a: SearchSpec, spec_b: SearchSpec) -> env.EnvState:
    """One greedy lockstep move: side A's and side B's searches both run
    on the full batch; each game takes the action of its side to move."""
    a_to_move = torch.where(states.turn == env.WHITE, a_is_white, ~a_is_white)
    acts_a = _greedy(states, ev_a, spec_a)
    acts_b = _greedy(states, ev_b, spec_b)
    return env.step(states, torch.where(a_to_move, acts_a, acts_b))


def play(ev_a, ev_b, pairs: int, sims_a: int, sims_b: int, seed: int,
         cfg: Config, device):
    """(wins_a, wins_b, final states) of ``pairs`` openings from
    ``random.Random(seed)``, each played twice (A White in game 2k), for at
    most ``cfg.max_game_length`` lockstep moves."""
    dev = resolve_device(device)
    rng = random.Random(seed)
    states = paired_states([random_opening(rng) for _ in range(pairs)], dev)
    a_is_white = torch.arange(2 * pairs, device=dev) % 2 == 0
    spec_a, spec_b = spec_for(cfg, sims_a), spec_for(cfg, sims_b)
    for _ in range(cfg.max_game_length):
        if bool(states.done.all()):
            break
        states = asym_move(states, a_is_white, ev_a, ev_b, spec_a, spec_b)
    return (*wins(states, a_is_white), states)


def measure_ratio(evals: dict, pairs: int, sims: int, seed: int,
                  cfg: Config, device) -> dict:
    """int8 over bf16 sims/s at the match's shape: one search of ``sims``
    from the 2 x ``pairs`` opening positions, a warm-up with each, then
    timed in turns (int8, bf16, bf16, int8), as sums over the turns."""
    dev = resolve_device(device)
    rng = random.Random(seed)
    states = paired_states([random_opening(rng) for _ in range(pairs)], dev)
    spec = spec_for(cfg, sims)
    rates = {name: [] for name in evals}
    for name in ("int8", "bf16", "int8", "bf16", "bf16", "int8"):
        synchronize(dev)
        t0 = time.perf_counter()
        _greedy(states, evals[name], spec).cpu()
        dt = time.perf_counter() - t0
        rates[name].append(2 * pairs * sims / dt)
    # the first of each name was the warm-up
    timed = {name: r[1:] for name, r in rates.items()}
    return {"games": 2 * pairs, "sims": sims,
            "int8_sims_per_s": timed["int8"], "bf16_sims_per_s": timed["bf16"],
            "ratio": sum(timed["int8"]) / sum(timed["bf16"])}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m alphazero_torch.strength.asym_match",
        description="int8-static at sims_a against bf16 at sims_b")
    p.add_argument("weights", nargs="?", default=ARCHIVE)
    p.add_argument("pairs", nargs="?", type=int, default=16)
    p.add_argument("sims_a", nargs="?", type=int, default=300)
    p.add_argument("sims_b", nargs="?", type=int, default=200)
    p.add_argument("--ratio-from-card", action="store_true",
                   help="time both evaluators first and play at "
                        "sims_a = round(sims_b x measured ratio)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = Config()
    seed = int(os.environ.get("AZTPU_MATCH_SEED", "2026"))

    net = load_net(args.weights, dev)
    print(f"weights: {args.weights}; device: {device_line(dev)}", flush=True)
    eval_int8, what = int8_evaluator(net, args.weights, dev)
    print(f"quant flavor: int8-static; scales {what}", flush=True)
    evals = {"int8": eval_int8,
             "bf16": make_net_evaluator(net, torch.bfloat16)}

    sims_a = args.sims_a
    if args.ratio_from_card:
        timing = measure_ratio(evals, args.pairs, args.sims_b, seed, cfg,
                               dev)
        sims_a = round(args.sims_b * timing["ratio"])
        print("ratio " + json.dumps(dict(timing, sims_a=sims_a,
                                         device=device_line(dev))),
              flush=True)

    t0 = time.time()
    wins_a, wins_b, _ = play(evals["int8"], evals["bf16"], args.pairs,
                             sims_a, args.sims_b, seed, cfg, dev)
    n = 2 * args.pairs
    draws = n - wins_a - wins_b
    print(f"int8-static@{sims_a} {wins_a} - {wins_b} bf16@{args.sims_b} over "
          f"{n} games ({draws} unfinished); int8 equal-compute score "
          f"{100 * (wins_a + 0.5 * draws) / n:.1f}% (seed {seed}, "
          f"{time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
