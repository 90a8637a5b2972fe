"""SE-ResNet policy/value network.

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

In train mode BatchNorm follows Flax's defaults, which the JAX package
trains with (see ``BatchNorm2d`` below); ``build_network`` and the weight
loaders return the net in eval mode.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from alphazero_torch import resolve_device
from alphazero_torch.config import Config


class _AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce over ``group`` whose backward is one too: the
    gradient of every rank's loss with respect to the global sum reaches
    every rank's local share of it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with Flax's training semantics: the running
    statistics decay by 0.99 per step (``momentum=0.01`` in PyTorch's
    convention; PyTorch's default would be 0.1), and the running variance
    takes the BIASED batch variance, as the normalisation itself does
    (PyTorch's own update takes the unbiased one, larger by n/(n-1),
    n = B*64). Eval mode, parameters and buffers are ``nn.BatchNorm2d``'s.

    With a ``process_group`` (``parallel.replicate`` attaches it; it is no
    part of the ``state_dict``) train mode takes the statistics of the
    GLOBAL batch, as the JAX package's mesh does: the per-channel sums of
    x and x^2 and the count are summed over the group in float32 by one
    all-reduce that autograd carries back (a second in the backward), and
    the variance is Flax's fast one, max(E[x^2] - E[x]^2, 0). A copy of
    the module (``copy.deepcopy``, as the search evaluator's bf16 net is
    made) keeps no group: a process group cannot be copied.
    """

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.01)
        self.process_group = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["process_group"] = None
        return state

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._global_batch_forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    def _global_batch_forward(self, x: torch.Tensor) -> torch.Tensor:
        C = x.shape[1]
        xf = x.float()
        count = torch.full((1,), x.numel() // C, dtype=torch.float32,
                           device=x.device)
        sums = _AllReduceSum.apply(
            torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]),
            self.process_group)
        n = sums[2 * C]
        mean = sums[:C] / n
        var = (sums[C:2 * C] / n - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * scale[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


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
        self.bn1 = BatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(channels)
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
        self.input_bn = BatchNorm2d(C)
        self.blocks = nn.ModuleList(
            SEResBlock(C, se_ratio) for _ in range(num_blocks))
        self.policy_conv = nn.Conv2d(C, C, 3, padding=1, bias=False)
        self.policy_bn = BatchNorm2d(C)
        self.policy_fc = nn.Linear(C * S, num_actions)
        self.value_conv = nn.Conv2d(C, 32, 1, bias=False)
        self.value_bn = BatchNorm2d(32)
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
                  generator: torch.Generator | None = None) -> nn.Module:
    """A randomly initialised net of ``cfg.body`` in eval mode on
    ``device``: the SE-ResNet (``AlphaZeroNet``), the encoder body
    (``models/encoder.py:EncoderNet``), the nested-bottleneck body
    (``models/nbt.py:NbtNet``) or MuZero's nets
    (``models/muzero.py:MuZeroNet``).

    Weights are drawn on the CPU from ``generator`` (the modules' own
    initialisers, run under a seeded RNG fork) and then moved, so a seed
    gives the same net on every device.
    """
    if cfg.body not in ("se_resnet", "encoder", "nbt", "muzero"):
        raise ValueError(f"body={cfg.body!r}: expected 'se_resnet', "
                         "'encoder', 'nbt' or 'muzero'")
    dev = resolve_device(device)
    if cfg.body == "muzero" and dev.type == "cuda":
        from alphazero_torch.models import conv

        if cfg.mz_filters not in conv.CHANNELS:
            raise ValueError(
                f"on a CUDA card MuZero's width is one that conv3x3 is "
                f"compiled for, {conv.CHANNELS}, got {cfg.mz_filters}")
    if cfg.body == "nbt" and dev.type == "cuda":
        from alphazero_torch.models import conv

        if cfg.nbt_mid not in conv.CHANNELS:
            raise ValueError(
                f"on a CUDA card the nbt body's mid width is one that "
                f"conv3x3 is compiled for, {conv.CHANNELS}, got "
                f"{cfg.nbt_mid}")
    if cfg.body == "encoder" and dev.type == "cuda":
        from alphazero_torch.models import attention as att

        widths = (cfg.enc_heads, cfg.enc_embed / cfg.enc_heads,
                  cfg.smolgen_gen)
        if widths != (att.KERNEL_HEADS, att.KERNEL_DIM, att.KERNEL_GEN):
            raise ValueError(
                f"on a CUDA card the encoder takes {att.KERNEL_HEADS} heads "
                f"of {att.KERNEL_DIM} and smolgen {att.KERNEL_GEN} a head "
                f"(the widths smolgen_attention is compiled for), got "
                f"{cfg.enc_heads} heads of {widths[1]:g} and smolgen "
                f"{cfg.smolgen_gen}")
    with torch.random.fork_rng(devices=[]):
        if generator is not None:
            torch.random.default_generator.manual_seed(int(torch.randint(
                0, 2 ** 62, (), generator=generator)))
        if cfg.body == "encoder":
            from alphazero_torch.models.encoder import encoder_from_config

            net = encoder_from_config(cfg)
        elif cfg.body == "nbt":
            from alphazero_torch.models.nbt import nbt_from_config

            net = nbt_from_config(cfg)
        elif cfg.body == "muzero":
            from alphazero_torch.models.muzero import muzero_from_config

            net = muzero_from_config(cfg)
        else:
            net = AlphaZeroNet(cfg.num_blocks, cfg.num_filters,
                               cfg.se_ratio, cfg.num_actions,
                               cfg.input_planes, cfg.board_size)
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
