#!/usr/bin/env python3
"""One captured 16-simulation search profile of each evaluator, int8-static
and bf16, at the strength gates' shape: the 32 games of 16 paired random
openings (``asym_match.measure_ratio``'s positions, seed 2026) on the
archived net.

    python3 scripts/gate_profiles.py [weights] [pairs]

Each profile is ``chip_smoke.profile_search`` (after a search that
captured): wall, device busy and idle share, host ms per simulation and
the kernels that took most device time, one line each; the tables go
where ``chip_smoke.py`` writes its profiles, as
``chip_smoke_profile_gates_<evaluator>.txt``. Needs a CUDA card.
"""

import os
import random
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    import chip_smoke
    from alphazero_torch.arena.match import paired_states, random_opening
    from alphazero_torch.search.mcts import make_net_evaluator
    from alphazero_torch.strength.common import (device_line,
                                                 int8_evaluator, load_net)

    weights = argv[0] if argv else chip_smoke.ARCHIVE
    pairs = int(argv[1]) if len(argv) > 1 else 16
    dev = torch.device("cuda")
    net = load_net(weights, dev)
    evals = {"int8": int8_evaluator(net, weights, dev)[0],
             "bf16": make_net_evaluator(net, torch.bfloat16)}
    rng = random.Random(2026)
    states = paired_states([random_opening(rng) for _ in range(pairs)], dev)
    print(f"weights: {weights}; device: {device_line(dev)}; "
          f"{2 * pairs} games", flush=True)
    for name, fn in evals.items():
        chip_smoke.profile_search(states, fn, tag=f"gates_{name}")


if __name__ == "__main__":
    main(sys.argv[1:])
