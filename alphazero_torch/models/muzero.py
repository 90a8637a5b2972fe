"""MuZero's board-game networks: the port's fourth network family.

Schrittwieser et al., "Mastering Atari, Go, Chess and Shogi by Planning
with a Learned Model" (Nature 588, 2020; arXiv:1911.08265), Methods
"Network architecture" and "Network input", and its ``pseudocode.py``
(``initial_inference``, ``recurrent_inference``), fitted to Breakthrough.
Three functions of a hidden state ``s`` of C planes of 8 x 8:

- the representation ``h``: ``s = scale(tower_h(planes))``, the planes
  the other bodies take (mine / theirs / ones, the mover's frame);
- the dynamics ``g``: ``s' = scale(tower_g([s ; A(a)]))``, the state
  beside the action's 3 planes, and the reward ``r = tanh(reward_head(
  s'))``, one scalar a transition for the player who took ``a``;
- the prediction ``f``: policy logits (192, the env's (8, 8, 3) layout)
  and win/loss logits, from the SE-ResNet's heads at width C.

A tower is ``x = relu(BN(conv3x3(input)))`` and ``B`` post-activation
residual blocks, ``x = relu(x + BN2(conv3x3(relu(BN1(conv3x3(x))))))``
(AlphaZero's block, no squeeze-excite). ``scale`` maps a board's state
to [0, 1] over all its C x 64 values, ``(s - min) / max(max - min,
SCALE_EPS)``. The action's planes (``action_planes``) follow the paper's
chess encoding in the canonical frame of ``env/breakthrough.py``: a
one-hot from-square, a one-hot to-square where the target is on the
board, and a plane of ones where it is; Breakthrough has no promotions,
so the chess encoding's promotion planes are dropped. The reward head
has the value head's widths (1x1 conv to 32, BN, ReLU, 2048 -> 128,
ReLU, 128 -> 1).

This module is the float32 net: what the learner trains (the unrolled
loss, ``train/learner.py``) and what the CPU searches with. The bf16
search evaluator on the card is ``models/muzero_inference.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alphazero_torch.models.network import BatchNorm2d

SQUARES = 64
SCALE_EPS = 1e-5
ACTION_PLANES = 3        # beside g's input: from, to, target on the board
VALUE_CHANNELS, VALUE_HIDDEN = 32, 128


def action_planes(actions: torch.Tensor, dtype=torch.float32
                  ) -> torch.Tensor:
    """(B,) canonical actions -> (B, 3, 8, 8) planes on their device: the
    from-square, the to-square where it lies on the board, and ones where
    it does. Action ``a = (row * 8 + col) * 3 + dir`` moves from (row, col)
    to (row + 1, col + (0, -1, +1)[dir])."""
    a = actions.long()
    sq, d = a // 3, a % 3
    row, col = sq // 8, sq % 8
    to_col = col + torch.where(d == 2, 1, torch.where(d == 1, -1, 0))
    on = (row + 1 < 8) & (to_col >= 0) & (to_col < 8)
    squares = torch.arange(SQUARES, device=a.device)
    frm = (squares[None] == sq[:, None])
    to = (squares[None] == ((row + 1) * 8 + to_col)[:, None]) & on[:, None]
    ones = on[:, None].expand(-1, SQUARES)
    return torch.stack([frm, to, ones], 1).to(dtype).view(-1, 3, 8, 8)


def scale_state(s: torch.Tensor) -> torch.Tensor:
    """Each board's (C, 8, 8) state min-max scaled to [0, 1] over all its
    values."""
    flat = s.flatten(1)
    lo = flat.amin(1, keepdim=True)
    hi = flat.amax(1, keepdim=True)
    return ((flat - lo) / (hi - lo).clamp_min(SCALE_EPS)).view(s.shape)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class ResBlock(nn.Module):
    """AlphaZero's post-activation residual block."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = _conv3(channels, channels)
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = _conv3(channels, channels)
        self.bn2 = BatchNorm2d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(x + self.bn2(self.conv2(y)))


class Tower(nn.Module):
    """An input conv with its BN and ReLU, then ``blocks`` residual blocks;
    the state before ``scale``."""

    def __init__(self, cin: int, channels: int, blocks: int):
        super().__init__()
        self.conv = _conv3(cin, channels)
        self.bn = BatchNorm2d(channels)
        self.blocks = nn.ModuleList(ResBlock(channels) for _ in range(blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.conv(x)))
        for block in self.blocks:
            x = block(x)
        return x


class MuZeroNet(nn.Module):
    """MuZero's representation, dynamics and prediction nets for
    Breakthrough. ``forward(planes)`` is ``predict(represent(planes))``,
    the evaluation of a real position; the search and the learner call the
    three functions. Outputs are float32."""

    def __init__(self, blocks: int = 16, filters: int = 256,
                 num_actions: int = 192, input_planes: int = 3,
                 board_size: int = 8):
        super().__init__()
        if (num_actions, board_size) != (192, 8):
            raise ValueError("MuZero's action planes encode Breakthrough's "
                             "192 actions on an 8 x 8 board")
        C, S = filters, board_size * board_size
        self.represent_tower = Tower(input_planes, C, blocks)
        self.dynamics_tower = Tower(C + ACTION_PLANES, C, blocks)
        self.reward_conv = nn.Conv2d(C, VALUE_CHANNELS, 1, bias=False)
        self.reward_bn = BatchNorm2d(VALUE_CHANNELS)
        self.reward_fc1 = nn.Linear(VALUE_CHANNELS * S, VALUE_HIDDEN)
        self.reward_fc2 = nn.Linear(VALUE_HIDDEN, 1)
        self.policy_conv = _conv3(C, C)
        self.policy_bn = BatchNorm2d(C)
        self.policy_fc = nn.Linear(C * S, num_actions)
        self.value_conv = nn.Conv2d(C, VALUE_CHANNELS, 1, bias=False)
        self.value_bn = BatchNorm2d(VALUE_CHANNELS)
        self.value_fc1 = nn.Linear(VALUE_CHANNELS * S, VALUE_HIDDEN)
        self.value_fc2 = nn.Linear(VALUE_HIDDEN, 2)

    @property
    def filters(self) -> int:
        return self.policy_conv.out_channels

    def represent(self, planes: torch.Tensor) -> torch.Tensor:
        """h: (B, 3, 8, 8) planes -> (B, C, 8, 8) state in [0, 1]."""
        return scale_state(self.represent_tower(planes))

    def dynamics(self, s: torch.Tensor, actions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """g: the state and (B,) actions -> (next state, (B,) reward in
        [-1, 1] for the player who took the action)."""
        x = torch.cat([s, action_planes(actions, s.dtype)], 1)
        s2 = scale_state(self.dynamics_tower(x))
        r = F.relu(self.reward_bn(self.reward_conv(s2)))
        r = F.relu(self.reward_fc1(r.flatten(1)))
        return s2, torch.tanh(self.reward_fc2(r)[:, 0]).float()

    def predict(self, s: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """f: the state -> (policy logits (B, 192), win/loss logits
        (B, 2))."""
        p = F.relu(self.policy_bn(self.policy_conv(s)))
        policy_logits = self.policy_fc(p.flatten(1))
        v = F.relu(self.value_bn(self.value_conv(s)))
        v = F.relu(self.value_fc1(v.flatten(1)))
        return policy_logits.float(), self.value_fc2(v).float()

    def forward(self, planes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.predict(self.represent(planes))


def muzero_from_config(cfg) -> MuZeroNet:
    return MuZeroNet(cfg.mz_blocks, cfg.mz_filters, cfg.num_actions,
                     cfg.input_planes, cfg.board_size)
