#!/usr/bin/env python3
"""Times the bf16 evaluator's residual tower both ways on the card, at the
batches the port runs, to find where the fused route starts to win
(``models/inference.py:B_MIN``):

- per-layer: the 20 blocks as 40 ``conv3x3`` and 20 ``se_residual``
  launches, each ``conv3x3`` a programmatic dependent launch;
- fused: one ``fused.tower_forward`` launch.

    python3 scripts/tower_crossover.py [--out chiprun_out/tower_crossover.json]

Each route is captured as a CUDA graph (``CHAIN`` towers in a row, each
on the one before's output, so that the per-layer route keeps its
programmatic launches across blocks as in the captured simulation) and
timed by CUDA events around ``REPLAYS`` replays queued behind a device
sleep; the routes are timed in turns (per-layer, fused, fused,
per-layer) ``TURNS`` times. The whole forward (``inference_apply``, its
input conv and heads included) is timed the same way, with the route
forced through ``inference.B_MIN``. The tower's input is the archived
20x128 net's input conv on random-play positions. The fused route takes
batches in whole thread blocks of ``fused.TB`` boards, so at one board it
is timed at ``fused.TB``. Prints one JSON line a batch, then the smallest
batch at which the fused tower's median was the lower, and writes every
reading to ``--out``. Needs one CUDA card.
"""

import argparse
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCHES = (1, 32, 128, 160, 192, 224, 256, 264, 268, 320, 384, 448, 512)
CHAIN, REPLAYS, TURNS = 8, 25, 4


def captured(fn):
    """``fn`` captured once as a CUDA graph after a warm-up on a side
    stream; returns the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def replay_ms(graph, per_replay: int) -> float:
    """Device ms a unit: ``REPLAYS`` replays between two events, queued
    behind a device sleep, over ``REPLAYS * per_replay`` units."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * per_replay)


def per_layer_tower(prep, x):
    from alphazero_torch.models import conv as cv
    from alphazero_torch.models import epilogue

    for b in prep["blocks"]:
        y = cv.conv3x3(x, b["conv1"], b["bn1"], relu=True,
                       image=b["conv1_image"])
        y = cv.conv3x3(y, b["conv2"], b["bn2"], image=b["conv2_image"])
        x = epilogue.se_residual(y, x, b["fc1"], b["fc2"])
    return x


def fused_tower(prep, x):
    from alphazero_torch.models import fused

    B = x.shape[0]
    return fused.tower_forward(x.reshape(B * 64, -1), prep["tower"],
                               len(prep["blocks"])).view(x.shape)


def chained(tower, prep, x):
    def run():
        y = x
        for _ in range(CHAIN):
            y = tower(prep, y)
        return y
    return run


def forward_with(b_min, prep, planes):
    from alphazero_torch.models import inference

    def run():
        saved, inference.B_MIN = inference.B_MIN, b_min
        try:
            for _ in range(CHAIN):
                inference.inference_apply(prep, planes)
        finally:
            inference.B_MIN = saved
    return run


def in_turns(graphs, per_replay):
    """{route: [ms, ...]} from ``TURNS`` rounds of a, b, b, a."""
    out = {k: [] for k in graphs}
    a, b = list(graphs)
    for _ in range(TURNS):
        for k in (a, b, b, a):
            out[k].append(replay_ms(graphs[k], per_replay))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "tower_crossover.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tower_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import epilogue, fused, inference
    from alphazero_torch.models.convert import load_archive
    from alphazero_torch.strength.common import device_line

    dev = torch.device("cuda")
    card = device_line(dev)
    net = load_archive(cs.ARCHIVE, device=dev)
    prep = inference.prepare_inference(net, torch.bfloat16)
    if prep["tower"] is None:
        sys.exit("tower_crossover: the archived net packs no tower")
    rows = []
    for B in BATCHES:
        Bf = max(B, fused.TB)
        planes = env.encoded_state(cs.random_positions(Bf, B)).to(dev)
        with torch.no_grad():
            x = epilogue.bn_act(inference._conv(
                planes.permute(0, 2, 3, 1).to(
                    torch.bfloat16, memory_format=torch.contiguous_format),
                prep["input_conv"]), prep["input_bn"])
            want = per_layer_tower(prep, x[:Bf]).float()
            got = fused_tower(prep, x[:Bf]).float()
            diff = float((got - want).abs().max())
            tower = in_turns(
                {"per_layer": captured(chained(per_layer_tower, prep,
                                               x[:B])),
                 "fused": captured(chained(fused_tower, prep, x[:Bf]))},
                CHAIN)
            forward = in_turns(
                {"per_layer": captured(forward_with(10 ** 9, prep,
                                                    planes[:B])),
                 "fused": captured(forward_with(0, prep, planes[:Bf]))},
                CHAIN)
        row = {"boards": B, "fused_boards": Bf, "card": card,
               "tower_max_abs_diff": diff,
               **{f"tower_{k}_ms": v for k, v in tower.items()},
               **{f"forward_{k}_ms": v for k, v in forward.items()}}
        for kind in ("tower", "forward"):
            for route in ("per_layer", "fused"):
                row[f"{kind}_{route}_median_ms"] = statistics.median(
                    row[f"{kind}_{route}_ms"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    wins = [r["boards"] for r in rows if r["boards"] % fused.TB == 0
            and r["tower_fused_median_ms"] < r["tower_per_layer_median_ms"]]
    summary = {"card": card, "smallest_winning_batch": min(wins, default=None),
               "B_MIN": inference.B_MIN, "chain": CHAIN,
               "replays": REPLAYS, "turns": TURNS}
    print("tower_crossover " + json.dumps(summary), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"summary": summary, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
