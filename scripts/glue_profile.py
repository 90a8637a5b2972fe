#!/usr/bin/env python3
"""Captured 16-simulation search profiles of a tree of this repository,
their device kernels counted by class: the port's hand kernels, cuDNN's
and cuBLAS's, and the rest (PyTorch's own elementwise, reduction and copy
kernels), launches and device ms each.

    python3 scripts/glue_profile.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``alphazero_torch`` is profiled (this one
by default; an unpacked ``git archive`` of another commit compares two
trees in one call on the card). Profiles: the bf16 evaluator from the
initial position at 512, 128, 32 and one games, the int8-static one at
512 (``chip_smoke.profile_search`` and ``chip_smoke.launch_classes`` of
this checkout), each a JSON line on stdout; the tables go where
``chip_smoke.py`` writes its profiles, as
``chip_smoke_profile_<tag>_<evaluator>_<games>.txt``. Needs a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("bf16", 512), ("bf16", 128), ("bf16", 32), ("bf16", 1),
         ("int8", 512))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="glue")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("glue_profile: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.ROOT = HERE                      # profile tables go here

    import alphazero_torch
    from alphazero_torch import cuda_build
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.search import mcts
    from alphazero_torch.strength.common import (device_line,
                                                 int8_evaluator, load_net)

    if not alphazero_torch.__file__.startswith(root):
        raise RuntimeError(f"imported {alphazero_torch.__file__}, not the "
                           f"package under {root}")
    dev = torch.device("cuda")
    cuda_build.build(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    net = load_net(smoke.ARCHIVE, dev)
    evals = {"bf16": mcts.make_net_evaluator(net, torch.bfloat16),
             "int8": int8_evaluator(net, smoke.ARCHIVE, dev)[0]}
    card = device_line(dev)
    for name, games in CASES:
        p = smoke.profile_search(env.initial_state((games,), device=dev),
                                 evals[name], tag=f"{args.tag}_{name}_{games}")
        print(json.dumps({
            "root": root, "evaluator": name, "games": games,
            "sims": smoke.PROFILE_SIMS, "wall_ms": p["wall_s"] * 1e3,
            "busy_ms": p["busy_s"] * 1e3, "classes": p["classes"],
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
