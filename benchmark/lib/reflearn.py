"""The learner's step in plain PyTorch: the benchmark's reference.

The training contract of the configuration (``benchmark/configs``): the
policy's soft-target cross-entropy plus the win/loss cross-entropy, both
means over the batch; BatchNorm on the batch's statistics (biased
variance); a per-example horizontal mirror (the board's columns reversed,
the policy's squares mirrored and its two diagonal directions swapped);
the gradients' global norm clipped to ``grad_clip_norm`` (untouched below
it, scaled to it above), then ``weight_decay * param`` added, then Adam
(``betas``, ``eps``) and a step of ``-lr``.

``train`` runs ``steps`` steps in float32 with TF32 off, or with the
forward under bfloat16 autocast (the control), or with half of each batch
left out (a fault).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.lib import refnet

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def mirror_gather() -> np.ndarray:
    """g with mirrored_policy = policy[g]."""
    g = np.zeros(192, np.int64)
    swap = (0, 2, 1)
    for a in range(192):
        sq, d = divmod(a, 3)
        r, c = divmod(sq, 8)
        g[(r * 8 + 7 - c) * 3 + swap[d]] = a
    return g


def train(w: Dict[str, torch.Tensor], batches: List[Batch], hp: dict,
          steps: int, precision: str = "float32", half_batch: bool = False):
    """Returns (losses (steps,), the first step's gradient as Adam takes
    it (clipped, decay added) by leaf, the parameters' change over the
    ``steps`` by leaf)."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in w.items() if k.startswith("params/")}
    stats = {k: v for k, v in w.items() if k.startswith("batch_stats/")}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2 = hp["betas"]
    lr, eps, wd, clip = hp["lr"], hp["eps"], hp["weight_decay"], \
        hp["grad_clip_norm"]
    dev = next(iter(params.values())).device
    g_idx = torch.from_numpy(mirror_gather()).to(dev)
    losses, first = [], None
    for t in range(1, steps + 1):
        planes, pi, wl, mirror = batches[t - 1]
        planes = planes.float()
        mm = mirror[:, None]
        pi = torch.where(mm, pi[:, g_idx], pi)
        planes = torch.where(mm[..., None, None], planes.flip(-1), planes)
        if half_batch:
            n = planes.shape[0] // 2
            planes, pi, wl = planes[:n], pi[:n], wl[:n]
        cast = (torch.autocast(dev.type, dtype=torch.bfloat16)
                if precision == "bfloat16" else contextlib.nullcontext())
        with refnet.exact_float32(), cast:
            pol, wll = refnet.forward({**params, **stats}, planes,
                                      train=True)
            loss = (-(pi * torch.log_softmax(pol.float(), -1)).sum(-1).mean()
                    - (wl * torch.log_softmax(wll.float(), -1)).sum(-1)
                    .mean())
            grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
            scale = 1.0 if norm < clip else float(clip / norm)
            if t == 1:
                first = {}
            for (k, p), g in zip(params.items(), grads):
                g = g * scale + wd * p
                if t == 1:
                    first[k] = g.clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        losses.append(float(loss.detach()))
    return (np.array(losses), first,
            {k: p.detach() - w[k] for k, p in params.items()})


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keys: List[str]) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's."""
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
               for k in keys)


def numbers(losses_p, grad_p, change_p, losses_r, grad_r,
            change_r) -> Dict[str, float]:
    """The learner's numbers: each step's loss, the first gradient by
    leaf, the parameters' change by leaf. Leaves whose reference gradient
    is under a thousandth of the median leaf's move by rounding alone
    and are left out of the change."""
    keys = sorted(grad_r)
    gn = {k: float(grad_r[k].double().norm()) for k in keys}
    med = float(np.median(list(gn.values())))
    moving = [k for k in keys if gn[k] >= 1e-3 * med]
    lp, lr_ = np.asarray(losses_p, np.float64), np.asarray(losses_r)
    return {"loss_gap": float(np.max(np.abs(lp - lr_) / np.abs(lr_))),
            "grad_gap": leaf_gap(grad_p, grad_r, keys),
            "change_gap": leaf_gap(change_p, change_r, moving),
            "leaves_left_out": len(keys) - len(moving)}
