"""The comparisons shared by the drivers' checks."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import refnet, treecheck, weights
from benchmark.lib.cell import Cell

Numbers = Dict[str, float]


def load_weights(cell: Cell) -> Dict[str, torch.Tensor]:
    """The configuration's weights on the cell's device: the archive it
    names, or weights drawn from the seed."""
    c, dev = cell.config, torch.device(cell.device)
    if "archive" in c["weights"]:
        return weights.archive(cell.path(c["weights"]["archive"]), dev)
    shapes = weights.leaf_shapes(c["num_blocks"], c["num_filters"],
                                 c["se_ratio"], c["input_planes"],
                                 c["num_actions"])
    return weights.seeded(shapes, cell.seed, dev)


def evaluator_numbers(w: Dict[str, torch.Tensor],
                      judged: List[treecheck.Judged], dev: torch.device,
                      control: bool = False) -> Numbers:
    """The judged trees' priors and values against the reference net's in
    float32. With ``control`` the reference in float8 takes the
    program's place: its priors and values at the same positions are
    compared instead of the program's."""
    if not judged or not sum(len(j.prior) for j in judged):
        return {"policy_tv_mean": float("inf"),
                "value_err_mean": float("inf"), "positions": 0}
    planes = torch.from_numpy(np.concatenate([j.planes for j in judged]))
    legal = torch.from_numpy(np.concatenate([j.legal for j in judged]))
    planes, legal = planes.to(dev), legal.to(dev)
    prior, value = refnet.evaluate(w, planes, legal)
    if control:
        p8, v8 = refnet.evaluate(w, planes, legal, fp8=True)
        has_v = np.concatenate([~np.isnan(j.value) for j in judged])
        judged = [treecheck.Judged(
            planes=None, legal=None, prior=p8.cpu().numpy(),
            value=np.where(has_v, v8.cpu().numpy(), np.nan))]
    return treecheck.compare(judged, prior.cpu().numpy().astype(np.float64),
                             value.cpu().numpy().astype(np.float64))
