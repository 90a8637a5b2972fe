"""SE-ResNet policy/value network, inference only.

Port of ``alphazero_tpu/models/network.py``:

- 3x3 input conv -> BN -> ReLU
- N SE-residual blocks: conv3x3-BN-ReLU, conv3x3-BN, LC0-style SE (scale
  AND shift: fc2 emits 2C, split into sigmoid gate then bias,
  y = x*gate + bias), +skip, ReLU
- policy head: conv3x3 -> BN -> ReLU -> FC(C*64 -> 192)
- value head: conv1x1 -> 32 -> BN -> ReLU -> FC(2048 -> 128) -> ReLU ->
  FC(-> 2) win/loss logits

The module is NCHW throughout, PyTorch's habit. The two dense layers after
a flatten (``policy_fc``, ``value_fc1``) therefore take their inputs in
(c, h, w) order; ``models/convert.py`` permutes the JAX package's
(h, w, c)-ordered weights once at load. Convolutions and dense layers are
``F.conv2d`` / ``F.linear``, as the JAX package left them to XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alphazero_torch import resolve_device
from alphazero_torch.config import Config


class SqueezeExcite(nn.Module):
    """LC0-style squeeze-excitation: global pool -> bottleneck MLP that
    emits per-channel (sigmoid gate, bias); output = x * gate + bias."""

    def __init__(self, channels: int, se_ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // se_ratio)
        self.fc2 = nn.Linear(channels // se_ratio, 2 * channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.mean(dim=(2, 3))                       # (B, C)
        h = self.fc2(F.relu(self.fc1(pooled)))
        gate, bias = h.chunk(2, dim=-1)
        gate, bias = gate[:, :, None, None], bias[:, :, None, None]
        return x * torch.sigmoid(gate) + bias


class SEResBlock(nn.Module):
    def __init__(self, channels: int, se_ratio: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(channels, eps=1e-5)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(channels, eps=1e-5)
        self.se = SqueezeExcite(channels, se_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.se(self.bn2(self.conv2(y)))
        return F.relu(y + x)


class AlphaZeroNet(nn.Module):
    """Policy (192 logits) + win/loss (2 logits) network.

    Input: (B, 3, 8, 8) float planes (mine/theirs/ones, mover's side).
    Output logits are float32 whatever the module's dtype.
    """

    def __init__(self, num_blocks: int = 20, num_filters: int = 128,
                 se_ratio: int = 8, num_actions: int = 192,
                 input_planes: int = 3, board_size: int = 8):
        super().__init__()
        C, S = num_filters, board_size * board_size
        self.input_conv = nn.Conv2d(input_planes, C, 3, padding=1, bias=False)
        self.input_bn = nn.BatchNorm2d(C, eps=1e-5)
        self.blocks = nn.ModuleList(
            SEResBlock(C, se_ratio) for _ in range(num_blocks))
        self.policy_conv = nn.Conv2d(C, C, 3, padding=1, bias=False)
        self.policy_bn = nn.BatchNorm2d(C, eps=1e-5)
        self.policy_fc = nn.Linear(C * S, num_actions)
        self.value_conv = nn.Conv2d(C, 32, 1, bias=False)
        self.value_bn = nn.BatchNorm2d(32, eps=1e-5)
        self.value_fc1 = nn.Linear(32 * S, 128)
        self.value_fc2 = nn.Linear(128, 2)

    def forward(self, planes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.relu(self.input_bn(self.input_conv(planes)))
        for block in self.blocks:
            x = block(x)

        p = F.relu(self.policy_bn(self.policy_conv(x)))
        policy_logits = self.policy_fc(p.flatten(1))

        v = F.relu(self.value_bn(self.value_conv(x)))
        v = F.relu(self.value_fc1(v.flatten(1)))
        wl_logits = self.value_fc2(v)
        return policy_logits.float(), wl_logits.float()


def build_network(cfg: Config, device="cuda",
                  generator: torch.Generator | None = None) -> AlphaZeroNet:
    """A randomly initialised net in eval mode on ``device``.

    Weights are drawn on the CPU from ``generator`` (PyTorch's default
    initialisers, run under a seeded RNG fork) and then moved, so a seed
    gives the same net on every device.
    """
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        if generator is not None:
            torch.random.default_generator.manual_seed(int(torch.randint(
                0, 2 ** 62, (), generator=generator)))
        net = AlphaZeroNet(cfg.num_blocks, cfg.num_filters, cfg.se_ratio,
                           cfg.num_actions, cfg.input_planes, cfg.board_size)
    return net.to(dev).eval()


def wl_to_value(wl_logits: torch.Tensor) -> torch.Tensor:
    """(B, 2) win/loss logits -> (B,) scalar value = P(win) - P(loss)."""
    wl = torch.softmax(wl_logits, dim=-1)
    return wl[..., 0] - wl[..., 1]


@torch.no_grad()
def policy_value_apply(net: AlphaZeroNet, planes: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference: (policy_probs (B,192) f32, value (B,) f32)."""
    policy_logits, wl_logits = net(planes)
    return torch.softmax(policy_logits, dim=-1), wl_to_value(wl_logits)


def count_params(net: nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())
