"""The system under test, ``alphazero_torch``, as the drivers build it.

This is the one module of the harness besides the drivers that imports
the program. It turns the benchmark's weights (the archive's scheme, see
``refnet``) into the program's net, builds the program's CUDA libraries
in parallel at set-up, and reads the program's counters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from alphazero_torch import cuda_build
from alphazero_torch.config import Config
from alphazero_torch.models.network import AlphaZeroNet
from alphazero_torch.search import graph, mcts

_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias",
           ("params", "scale"): "weight",
           ("batch_stats", "mean"): "running_mean",
           ("batch_stats", "var"): "running_var"}
_FLATTENED = ("policy_fc", "value_fc1")


def program_config(cfg: dict, **kw) -> Config:
    """The program's ``Config`` for a configuration file's sizes."""
    return Config(num_blocks=cfg["num_blocks"],
                  num_filters=cfg["num_filters"],
                  se_ratio=cfg["se_ratio"], **kw)


def module_name(key: str) -> str:
    """Archive key -> the program's ``state_dict`` key."""
    collection, _, path = key.partition("/")
    module, _, leaf = path.rpartition("/")
    parts = module.split("/")
    if parts[0].startswith("block_"):
        parts = ["blocks", parts[0][len("block_"):]] + parts[1:]
    return ".".join(parts) + "." + _LEAVES[(collection, leaf)]


def _program_layout(key: str, t: torch.Tensor) -> torch.Tensor:
    module = key.split("/")[-2]
    if t.dim() == 4:                                   # HWIO -> OIHW
        return t.permute(3, 2, 0, 1)
    if t.dim() == 2 and module in _FLATTENED:
        n_in, n_out = t.shape                          # (h, w, c) -> (c, h, w)
        return t.reshape(64, n_in // 64, n_out).permute(2, 1, 0) \
                .reshape(n_out, n_in)
    if t.dim() == 2:
        return t.T
    return t


def build_net(cfg: Config, weights: Dict[str, torch.Tensor],
              device) -> AlphaZeroNet:
    """The program's float32 net in eval mode on ``device``, holding
    ``weights``; the module is made on the device, not on the host."""
    with torch.device(device):
        net = AlphaZeroNet(cfg.num_blocks, cfg.num_filters, cfg.se_ratio,
                           cfg.num_actions, cfg.input_planes, cfg.board_size)
    sd = {module_name(k): _program_layout(k, v) for k, v in weights.items()}
    own = net.state_dict()
    sd.update({k: v for k, v in own.items() if k.endswith("batches_tracked")})
    net.load_state_dict(sd)
    return net.eval()


def build_kernels() -> None:
    """Every CUDA library of the program, built in parallel where not yet
    built (under ``build/kernels`` in the checkout)."""
    cuda_build.build(sorted(p.stem for p in cuda_build.CSRC.glob("*.cu")))


@dataclasses.dataclass
class Counters:
    simulations: int
    depth_sum: int
    captures: int
    replays: int


def counters() -> Counters:
    """The search's counters (a read of the card for the depth sum)."""
    return Counters(mcts.STATS.simulations, mcts.STATS.depth_sum,
                    graph.STATS.captures, graph.STATS.replays)


def window_counters(before: Counters, lanes: int) -> Dict[str, float]:
    """What the search counted since ``before``: simulations, captures
    (none is made inside a window: every shape was warmed up), replays
    and the mean edge depth a game walked."""
    now = counters()
    sims = now.simulations - before.simulations
    return {"simulations": sims, "captures": now.captures - before.captures,
            "replays": now.replays - before.replays,
            "mean_depth": ((now.depth_sum - before.depth_sum)
                           / max(1, sims * lanes))}
