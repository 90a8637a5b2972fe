"""Times the fused-tower forward beside the layer-by-layer bf16 net.

    python -m alphazero_torch.bench_fused [B] [evals] [--archive NPZ] [--cpu]

Counterpart of the JAX package's ``scripts/bench_fused.py``: first the
numerics line (largest difference in a policy probability and in the
value between ``fused_apply`` and ``policy_value_apply`` on the bf16
net), then milliseconds per evaluation and evaluations per second of
both, over ``evals`` evaluations in a row on one batch of ``B``
positions. On the card the whole loop is timed between two CUDA events;
with ``--cpu`` (small sizes only) by the host's clock. The net is the
default 20x128 SE-ResNet with random weights from seed 0, or the archive
given.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Callable, Dict

import numpy as np
import torch

from alphazero_torch import resolve_device
from alphazero_torch.config import Config
from alphazero_torch.models import fused
from alphazero_torch.models.network import (
    build_network,
    policy_value_apply,
    wl_to_value,
)


def random_planes(B: int, seed: int = 0) -> torch.Tensor:
    """(B, 3, 8, 8) float32 planes: sparse mine/theirs, a plane of ones."""
    rng = np.random.default_rng(seed)
    mine = rng.random((B, 1, 8, 8)) < 0.2
    theirs = (~mine) & (rng.random((B, 1, 8, 8)) < 0.2)
    return torch.from_numpy(np.concatenate(
        [mine, theirs, np.ones((B, 1, 8, 8))], 1).astype(np.float32))


def _chain_ms(eval_fn: Callable, planes: torch.Tensor, evals: int) -> float:
    """Milliseconds per evaluation over ``evals`` evaluations in a row,
    each fed the planes plus zero times the previous value."""
    def loop(n):
        p = planes
        for _ in range(n):
            _, val = eval_fn(p)
            p = p + (val[:, None, None, None] * 0).to(p.dtype)
        return p

    loop(min(evals, 3))                                      # warm-up
    if planes.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        loop(evals)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / evals
    t0 = time.perf_counter()
    loop(evals)
    return (time.perf_counter() - t0) * 1e3 / evals


def bench_fused(net, planes: torch.Tensor, evals: int) -> Dict[str, float]:
    """Numerics and times of the fused path and of the layer-by-layer
    bf16 copy of ``net`` (a float32 ``AlphaZeroNet``) on ``planes``, which
    lie on the net's device."""
    packed = fused.pack_weights(net)
    net_bf = copy.deepcopy(net).to(torch.bfloat16).eval()

    def layers_eval(p):
        return policy_value_apply(net_bf, p.to(torch.bfloat16))

    def fused_eval(p):
        pol, wl = fused.fused_apply(packed, p)
        return torch.softmax(pol, -1), wl_to_value(wl)

    pf, vf = fused_eval(planes)
    pr, vr = layers_eval(planes)
    out = {"B": planes.shape[0], "evals": evals,
           "num_blocks": packed["num_blocks"],
           "max_prob_diff": float((pf - pr).abs().max()),
           "max_value_diff": float((vf - vr).abs().max())}
    launches = fused.tower_forward.launches
    for name, fn in (("layers", layers_eval), ("fused", fused_eval)):
        ms = _chain_ms(fn, planes, evals)
        out[f"{name}_ms_per_eval"] = ms
        out[f"{name}_evals_per_s"] = planes.shape[0] * 1e3 / ms
    out["tower_launches"] = fused.tower_forward.launches - launches
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=512)
    ap.add_argument("evals", nargs="?", type=int, default=800)
    ap.add_argument("--archive", help="npz archive of trained weights")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain tower; small sizes only)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    if args.archive:
        from alphazero_torch.models.convert import load_archive

        net = load_archive(args.archive, device=dev)
    else:
        net = build_network(Config(), device=dev,
                            generator=torch.Generator().manual_seed(0))
    out = bench_fused(net, random_planes(args.B).to(dev), args.evals)
    print(f"max |prob diff| = {out['max_prob_diff']:.5f}, "
          f"max |value diff| = {out['max_value_diff']:.5f}", flush=True)
    for name in ("layers", "fused"):
        print(f"{name}: {out[f'{name}_ms_per_eval']:.3f} ms/eval "
              f"({out[f'{name}_evals_per_s']:,.0f} evals/s)", flush=True)
    out["device"] = (torch.cuda.get_device_name(0) if dev.type == "cuda"
                     else "cpu")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
