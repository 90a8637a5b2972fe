"""The weights a cell runs on, in the archive's scheme (see ``refnet``).

Either the trained archive that the configuration names, read from the
checkout, or weights drawn from the seed on the device: a few large draws
from one ``torch.Generator`` on the card, cut into the leaves and scaled so
that activations keep about unit variance through the tower (convolutions
and dense layers N(0, 1/fan_in), BatchNorm statistics near 0 and 1). Both
sides of a comparison take the same tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Shapes = List[Tuple[str, Tuple[int, ...], str]]


def leaf_shapes(blocks: int, filters: int, se_ratio: int,
                input_planes: int = 3, num_actions: int = 192,
                value_channels: int = 32, value_hidden: int = 128) -> Shapes:
    """(key, shape, kind) of every leaf; kind is ``kernel``, ``bias``,
    ``scale``, ``mean`` or ``var``."""
    C, H, S = filters, filters // se_ratio, 64
    out: Shapes = []

    def conv(name, k, cin, cout):
        out.append((f"params/{name}/kernel", (k, k, cin, cout), "kernel"))

    def bn(name, c):
        out.extend([(f"params/{name}/scale", (c,), "scale"),
                    (f"params/{name}/bias", (c,), "bias"),
                    (f"batch_stats/{name}/mean", (c,), "mean"),
                    (f"batch_stats/{name}/var", (c,), "var")])

    def dense(name, n_in, n_out):
        out.extend([(f"params/{name}/kernel", (n_in, n_out), "kernel"),
                    (f"params/{name}/bias", (n_out,), "bias")])

    conv("input_conv", 3, input_planes, C)
    bn("input_bn", C)
    for i in range(blocks):
        conv(f"block_{i}/conv1", 3, C, C)
        bn(f"block_{i}/bn1", C)
        conv(f"block_{i}/conv2", 3, C, C)
        bn(f"block_{i}/bn2", C)
        dense(f"block_{i}/se/fc1", C, H)
        dense(f"block_{i}/se/fc2", H, 2 * C)
    conv("policy_conv", 3, C, C)
    bn("policy_bn", C)
    dense("policy_fc", C * S, num_actions)
    conv("value_conv", 1, C, value_channels)
    bn("value_bn", value_channels)
    dense("value_fc1", value_channels * S, value_hidden)
    dense("value_fc2", value_hidden, 2)
    return out


def count_params(shapes: Shapes) -> int:
    """Trained parameters (BatchNorm statistics are not)."""
    return sum(int(np.prod(s)) for k, s, _ in shapes
               if k.startswith("params/"))


def seeded(shapes: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [int(np.prod(s)) for _, s, _ in shapes]
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (key, shape, kind), n in zip(shapes, sizes):
        z, u = normal[at:at + n], uniform[at:at + n]
        at += n
        if kind == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            t = z * fan_in ** -0.5
        elif kind in ("bias", "mean"):
            t = z * 0.05
        else:                                   # scale, var
            t = 0.8 + 0.4 * u
        out[key] = t.view(shape).clone()
    return out


def archive(path: str, device) -> Dict[str, torch.Tensor]:
    """The archive's weights as float32 tensors on ``device``."""
    with np.load(path) as data:
        return {k: torch.from_numpy(np.asarray(data[k], np.float32))
                .to(device) for k in data.files if k != "__meta__"}

