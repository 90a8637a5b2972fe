#!/usr/bin/env python3
"""The share of conv outputs that float32 sums in the conv kernel's order
round away from float64 sums, on the archived net's 41 ``conv3x3`` sites.

    python3 scripts/conv_unequal_share.py [positions]

Runs the bf16 evaluator's forward (``models/inference.py``) of the
archived 20x128 net on the CPU over ``positions`` random-play positions
(default 64; ``chip_smoke.random_positions``), records the input of every
``conv.conv3x3`` call, and holds ``conv.conv3x3_kernel_order`` (float32
sums k-step by k-step, the kernel's k order) against
``conv3x3_plain(..., f64_sums=True)`` as ``conv.card_check`` holds the
kernel: prints, per site and in all, the unequal elements, those more
than one bf16 step apart (and the most steps), those outside
``conv.sum_error_bound`` beside one step, and the
``conv.CONV_UNEQUAL_SHARE`` it would give (the larger of 1e-4 and the
share). CPU only, about a minute.
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    import chip_smoke
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import conv, inference
    from alphazero_torch.models.convert import load_archive

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    positions = int(argv[0]) if argv else 64
    net = load_archive(chip_smoke.ARCHIVE, device="cpu")
    prep = inference.prepare_inference(net, torch.bfloat16)
    planes = env.encoded_state(chip_smoke.random_positions(positions, 81))
    sites = chip_smoke.conv_sites(prep, planes)
    names = [f"block {i} conv{j}" for i in range(len(prep["blocks"]))
             for j in (1, 2)] + ["policy_conv"]
    total = {"unequal": 0, "elements": 0, "beyond_one_step": 0,
             "outside_bound": 0, "max_steps": 0.0}
    for name, (x, w, _, _, _) in zip(names, sites):
        got = conv.conv3x3_kernel_order(x, w)
        r = conv.card_check(x, w, None, {"none": got}, 1.0)
        for k in total:
            total[k] = max(total[k], r[k]) if k == "max_steps" \
                else total[k] + r[k]
        print(f"{name}: {r['unequal']} of {r['elements']} unequal, "
              f"{r['beyond_one_step']} beyond one bf16 step (up to "
              f"{r['max_steps']}), {r['outside_bound']} outside the f32 "
              f"bound", flush=True)
    share = total["unequal"] / total["elements"]
    print(f"{len(sites)} sites x {positions} positions: {json.dumps(total)}; "
          f"share {share:.3e}; CONV_UNEQUAL_SHARE = max(1e-4, share) = "
          f"{max(1e-4, share):.3e}")


if __name__ == "__main__":
    main(sys.argv[1:])
