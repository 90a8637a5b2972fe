"""KataGo's nested-bottleneck residual net: the port's third network family.

The body of KataGo's public self-play and release nets (``b28c512nbt``;
KataGo's training code, ``modelconfigs.py`` and ``model_pytorch.py``:
``NestedBottleneckResBlock``, ``ResBlock`` with ``c_gpool``, ``KataGPool``,
``KataValueHeadGPool``, ``PolicyHead``, ``ValueHead``), fitted to
Breakthrough's 8 x 8 board. With N(.) a BatchNorm (a per-channel affine
at inference), C the trunk, M the mid width, G the pooled channels and R =
M - G:

- input: ``x = conv3x3_{3->C}(planes)``;
- each block, pre-activation: ``t = conv1x1_{C->M}(relu(N_p(x)))``, then
  ``INNER`` (two) residual blocks at width M, ``t = t + conv3x3_{M->M}(relu(
  N_2(conv3x3_{M->M}(relu(N_1(t))))))``, then ``x = x +
  conv1x1_{M->C}(relu(N_q(t)))``;
- in the first inner block of every ``GPOOL_EVERY``-th (third) block the first
  conv splits: ``r = conv3x3_{M->R}(u)``, ``g = relu(N_g(conv3x3_{M->G}(
  u)))``, and the board's pool of g, ``[mean(g), mean(g) (sqrt(64) -
  14) / 10, max(g)]`` (3G), goes through a dense layer (no bias) into a
  bias of r's R channels: ``v = relu(N_2(r + W_g pool))``, then ``t = t +
  conv3x3_{R->M}(v)``;
- ``y = relu(N_final(x))``;
- policy: ``p = conv1x1_{C->P}(y)``, ``q = relu(N_g1(conv1x1_{C->P}(y)))``,
  ``p = relu(N_p2(p + W_pg pool(q)))`` with the same pool, ``logits =
  conv1x1_{P->3}(p)``: three planes a square, action 3s + d, the env's
  (8, 8, 3) layout;
- value: ``v = relu(N_v1(conv1x1_{C->V}(y)))``, its board mean m, ``h =
  relu(W_1 [m, -0.6 m, 0.26 m] + b_1)``, then 2 win/loss logits.

Convolutions and the pooled dense layers have no bias (each feeds a
norm); the value head's dense layers have. The board is always the whole
8 x 8, so the pools and norms need no mask and sqrt(area) is 8.

This module is the float32 net: what the learner trains and what the CPU
evaluates. The bf16 search evaluator on the card is
``models/nbt_inference.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alphazero_torch.models.network import BatchNorm2d

SQUARES = 64
# KataGPool's scale of the mean, (sqrt(area) - 14) / 10, and the value
# head's third term, ((sqrt(area) - 14)^2 / 100 - 0.1), at area 64
GPOOL_SCALE = -0.6
VALUE_SCALE = 0.26
POLICY_PLANES = 3
INNER = 2                       # residual blocks inside each block
# blocks 3, 6, 9, ... (counted from 1) pool: b18c384nbt's placement, taken
# for b28c512nbt
GPOOL_EVERY = 3


def board_pool(g: torch.Tensor) -> torch.Tensor:
    """KataGPool of an NCHW map over the whole board: (B, 3G) = [mean,
    mean * GPOOL_SCALE, max]."""
    mean = g.mean((2, 3))
    return torch.cat([mean, mean * GPOOL_SCALE, g.amax((2, 3))], 1)


def value_pool(v: torch.Tensor) -> torch.Tensor:
    """KataValueHeadGPool over the whole board: (B, 3V) = [mean, mean *
    GPOOL_SCALE, mean * VALUE_SCALE]."""
    mean = v.mean((2, 3))
    return torch.cat([mean, mean * GPOOL_SCALE, mean * VALUE_SCALE], 1)


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)


def is_gpool_block(b: int) -> bool:
    """Whether block ``b`` (from 0) pools: blocks ``GPOOL_EVERY``, 2
    ``GPOOL_EVERY``, ... counted from 1."""
    return (b + 1) % GPOOL_EVERY == 0


class InnerBlock(nn.Module):
    """A pre-activation residual block at the mid width; with ``gpool``
    its first conv's last G outputs are pooled into a bias of the
    others."""

    def __init__(self, mid: int, gpool: int = 0):
        super().__init__()
        self.gpool = gpool
        regular = mid - gpool
        self.norm1 = BatchNorm2d(mid)
        self.conv1 = _conv(mid, regular, 3)
        if gpool:
            self.convg = _conv(mid, gpool, 3)
            self.normg = BatchNorm2d(gpool)
            self.gpool_fc = nn.Linear(3 * gpool, regular, bias=False)
        self.norm2 = BatchNorm2d(regular)
        self.conv2 = _conv(regular, mid, 3)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        u = F.relu(self.norm1(t))
        r = self.conv1(u)
        if self.gpool:
            g = F.relu(self.normg(self.convg(u)))
            r = r + self.gpool_fc(board_pool(g))[:, :, None, None]
        return t + self.conv2(F.relu(self.norm2(r)))


class NestedBlock(nn.Module):
    def __init__(self, trunk: int, mid: int, gpool: int = 0):
        super().__init__()
        self.norm_pre = BatchNorm2d(trunk)
        self.conv_down = _conv(trunk, mid, 1)
        self.inner = nn.ModuleList(
            InnerBlock(mid, gpool if i == 0 else 0) for i in range(INNER))
        self.norm_post = BatchNorm2d(mid)
        self.conv_up = _conv(mid, trunk, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.conv_down(F.relu(self.norm_pre(x)))
        for block in self.inner:
            t = block(t)
        return x + self.conv_up(F.relu(self.norm_post(t)))


class NbtNet(nn.Module):
    """Policy (192 logits) + win/loss (2 logits) network on KataGo's
    nested-bottleneck body.

    Input: (B, 3, 8, 8) float planes (mine / theirs / ones, mover's side).
    Output logits are float32."""

    def __init__(self, blocks: int = 28, trunk: int = 512, mid: int = 256,
                 gpool: int = 64, head: int = 64,
                 value_hidden: int = 128, num_actions: int = 192,
                 input_planes: int = 3,
                 board_size: int = 8):
        super().__init__()
        if (num_actions, board_size) != (192, 8):
            raise ValueError("the policy's three planes a square map "
                             "Breakthrough's 192 actions on an 8 x 8 board")
        if not 0 < gpool < mid:
            raise ValueError(f"gpool {gpool} must lie between 0 and mid "
                             f"{mid}")
        self.input_conv = _conv(input_planes, trunk, 3)
        self.blocks = nn.ModuleList(
            NestedBlock(trunk, mid,
                        gpool if is_gpool_block(b) else 0)
            for b in range(blocks))
        self.norm_final = BatchNorm2d(trunk)
        self.policy_conv = _conv(trunk, head, 1)
        self.policy_gconv = _conv(trunk, head, 1)
        self.policy_gnorm = BatchNorm2d(head)
        self.policy_gpool_fc = nn.Linear(3 * head, head, bias=False)
        self.policy_norm = BatchNorm2d(head)
        self.policy_out = _conv(head, POLICY_PLANES, 1)
        self.value_conv = _conv(trunk, head, 1)
        self.value_norm = BatchNorm2d(head)
        self.value_fc1 = nn.Linear(3 * head, value_hidden)
        self.value_fc2 = nn.Linear(value_hidden, 2)

    def forward(self, planes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.input_conv(planes)
        for block in self.blocks:
            x = block(x)
        y = F.relu(self.norm_final(x))

        p = self.policy_conv(y)
        q = F.relu(self.policy_gnorm(self.policy_gconv(y)))
        p = p + self.policy_gpool_fc(board_pool(q))[:, :, None, None]
        p = self.policy_out(F.relu(self.policy_norm(p)))
        policy_logits = p.permute(0, 2, 3, 1).flatten(1)   # 3s + d

        v = F.relu(self.value_norm(self.value_conv(y)))
        h = F.relu(self.value_fc1(value_pool(v)))
        wl_logits = self.value_fc2(h)
        return policy_logits.float(), wl_logits.float()


def nbt_from_config(cfg) -> NbtNet:
    return NbtNet(cfg.nbt_blocks, cfg.nbt_trunk, cfg.nbt_mid, cfg.nbt_gpool,
                  cfg.nbt_head, cfg.nbt_value_hidden,
                  cfg.num_actions, cfg.input_planes, cfg.board_size)
