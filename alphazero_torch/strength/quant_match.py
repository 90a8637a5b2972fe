"""Strength match at equal simulations: int8 evaluator against bf16, one
set of weights.

Port of ``scripts/eval_quant_match.py``: paired games (shared random
openings, colours swapped, the arena's protocol) in one lockstep batch,
where player A searches with the int8-quantised net and player B with the
bf16 net, both from the same weights. Both evaluators run on the full
batch at every evaluation and rows are picked by side to move. A 50%
score means quantisation is strength-neutral at this simulation count.

    python -m alphazero_torch.strength.quant_match [weights] [pairs] [sims]

``weights`` is a port checkpoint directory or an archive npz (default:
the trained archive ``artifacts/model_r5_latest.npz``); 16 pairs = 32
games; ``cfg.num_simulations_inference`` (200) simulations.
``AZTPU_MATCH_SEED`` seeds the openings (default 2026);
``AZTPU_QUANT_FLAVOR`` is ``static`` (default, the flavour that ships) or
``dynamic``. ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import random
import time

import torch

from alphazero_torch import resolve_device
from alphazero_torch.arena.match import (
    play_paired_matches,
    random_opening,
    select_evaluator,
)
from alphazero_torch.config import Config
from alphazero_torch.search import make_net_evaluator
from alphazero_torch.strength.common import (
    ARCHIVE,
    device_line,
    int8_evaluator,
    load_net,
)


def play(eval_int8, eval_bf16, pairs: int, sims: int, seed: int,
         cfg: Config, device):
    """(wins_int8, wins_bf16) of ``pairs`` openings from
    ``random.Random(seed)``, each played twice (int8 White in game 2k)."""
    rng = random.Random(seed)
    openings = [random_opening(rng) for _ in range(pairs)]
    return play_paired_matches(
        None, None, openings, cfg, num_simulations=sims,
        pair_eval_fn=select_evaluator(eval_int8, eval_bf16), device=device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m alphazero_torch.strength.quant_match",
        description="int8 against bf16 on one set of weights, equal sims")
    p.add_argument("weights", nargs="?", default=ARCHIVE)
    p.add_argument("pairs", nargs="?", type=int, default=16)
    p.add_argument("sims", nargs="?", type=int, default=None)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    cfg = Config()
    sims = args.sims or cfg.num_simulations_inference
    seed = int(os.environ.get("AZTPU_MATCH_SEED", "2026"))
    flavor = os.environ.get("AZTPU_QUANT_FLAVOR", "static")

    net = load_net(args.weights, dev)
    print(f"weights: {args.weights}; device: {device_line(dev)}", flush=True)
    eval_int8, what = int8_evaluator(net, args.weights, dev, flavor)
    print(f"quant flavor: int8-{flavor}; scales {what}", flush=True)
    eval_bf16 = make_net_evaluator(net, torch.bfloat16)

    t0 = time.time()
    wins_q, wins_f = play(eval_int8, eval_bf16, args.pairs, sims, seed, cfg,
                          dev)
    n = 2 * args.pairs
    draws = n - wins_q - wins_f
    print(f"int8-{flavor} {wins_q} - {wins_f} bf16 over {n} games at {sims} "
          f"sims ({draws} unfinished); int8 score "
          f"{100 * (wins_q + 0.5 * draws) / n:.1f}% (seed {seed}, "
          f"{time.time() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
