"""The bf16 search evaluator's forward, as the JAX package compiles it.

In the JAX package the evaluator is traced inside the jitted move
(``alphazero_tpu/search/mcts.py:717-725``), so XLA keeps the net's NHWC
layout (the planes are transposed once, ``network.py:126``) and fuses the
glue between the convolutions into their neighbours. This module does the
same for the port's ``AlphaZeroNet``:

- ``prepare_inference`` casts the weights once, on the net's device: the
  convolutions' in ``torch.channels_last``, each BatchNorm as float32
  (mean, mul, beta) with ``mul = rsqrt(var + eps) * gamma`` (not folded
  into the conv, as the JAX bf16 net does not fold), the dense layers as
  (in, out) matrices, ``policy_fc`` and ``value_fc1`` back in the JAX
  package's (h, w, c) input order (``fused._hwc_dense``), since an NHWC
  flatten is (h, w, c) while ``models/convert.py`` permuted those two for
  the NCHW module;
- ``inference_apply`` runs the forward on NHWC maps, so nothing is
  transposed: each block's two 3x3 convolutions and the policy head's
  are ``conv.conv3x3`` with their BatchNorm as its epilogue (``conv1``
  and the policy conv with ReLU, ``conv2`` the affine alone), and
  ``epilogue.se_residual`` ends each block; the input conv (cin 3) and
  the value head's 1x1 conv are ``F.conv2d`` on channels-last operands
  (cuDNN on the card), each followed by ``epilogue.bn_act``; the dense
  layers are matrix products, each product and each bias add rounded
  apart as Flax's ``nn.Dense`` rounds.

The residual tower has a second route, chosen by the batch's shape
(``fused_tower``): on the card in bfloat16 at the width the fused kernel
takes (C 128), a batch of ``B_MIN`` or more boards in whole thread blocks
of ``fused.TB`` runs all its blocks as one ``fused.tower_forward`` launch
on the NHWC map viewed as ``(B*64, C)`` rows, in place of two
``conv3x3`` and one ``se_residual`` launch a block. It is the same net in
the same precision (bf16 operands, float32 sums) with each BatchNorm
folded into its conv (``fused.pack_weights``), which moves rounding points
and nothing else; the input conv and both heads are the same on both
routes.

On the card ``conv3x3`` and the two epilogues are hand-written kernels
and take bfloat16 only (``conv3x3`` reads its weights in an image that
``prepare_inference`` packs once, ``conv.weight_image``); on the CPU
their plain versions run, in any float dtype (the tests run float32
against Flax), and the tower takes the per-layer route.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from alphazero_torch.models import conv as cv
from alphazero_torch.models import epilogue, fused
from alphazero_torch.models.network import AlphaZeroNet

# The fewest boards whose tower runs as one ``fused.tower_forward`` launch.
# The kernel is one wave of TB boards a thread block up to 528 boards, so
# it takes about the same time at any batch up to there, while the
# per-layer route's 40 ``conv3x3`` and 20 ``se_residual`` launches grow
# with the batch: the smallest multiple of TB at which the fused tower
# took less time, both routes timed as CUDA-graph replays of the 20x128
# archive net's tower on an H100 (scripts/tower_crossover.py; PERF.md §6).
B_MIN = 268


def _copy(t: torch.Tensor, dev: torch.device, dtype: torch.dtype,
          **kw) -> torch.Tensor:
    """A copy of ``t`` that shares no memory with the net's parameters."""
    return t.detach().to(device=dev, dtype=dtype, copy=True, **kw)


def prepare_inference(net: AlphaZeroNet, dtype: torch.dtype = torch.bfloat16
                      ) -> Dict[str, Any]:
    """The net's weights for ``inference_apply`` in ``dtype``, on the net's
    device: a snapshot that later training does not change. Each
    ``conv3x3`` site keeps its channels-last OIHW weights (the CPU's plain
    version reads them) and, on a card in bfloat16 at a width the kernel
    takes, their image under ``<name>_image`` (else None). Under
    ``"tower"`` it keeps ``tower_operands(net)`` where ``packs_tower``
    holds, else None."""
    dev = next(net.parameters()).device

    def conv(c: torch.nn.Conv2d) -> torch.Tensor:
        return _copy(c.weight, dev, dtype, memory_format=torch.channels_last)

    def image(w: torch.Tensor):
        return (cv.weight_image(w) if dev.type == "cuda"
                and dtype == torch.bfloat16 and w.shape[0] in cv.CHANNELS
                else None)

    def conv3x3(name: str, c: torch.nn.Conv2d) -> Dict[str, Any]:
        w = conv(c)
        return {name: w, f"{name}_image": image(w)}

    def bn(b: torch.nn.BatchNorm2d):
        # on the host in float32, so that the card's constants are the CPU's
        f = lambda v: v.detach().to("cpu", torch.float32)
        mul = torch.rsqrt(f(b.running_var) + b.eps) * f(b.weight)
        return tuple(_copy(v, dev, torch.float32)
                     for v in (f(b.running_mean), mul, f(b.bias)))

    def dense(fc: torch.nn.Linear, flattened: bool = False):
        kernel = (torch.from_numpy(fused._hwc_dense(fc)) if flattened
                  else fc.weight.detach().T.contiguous())
        return _copy(kernel, dev, dtype), _copy(fc.bias, dev, dtype)

    return {
        "dtype": dtype,
        "input_conv": conv(net.input_conv), "input_bn": bn(net.input_bn),
        "blocks": [{**conv3x3("conv1", b.conv1), "bn1": bn(b.bn1),
                    **conv3x3("conv2", b.conv2), "bn2": bn(b.bn2),
                    "fc1": dense(b.se.fc1), "fc2": dense(b.se.fc2)}
                   for b in net.blocks],
        **conv3x3("policy_conv", net.policy_conv),
        "policy_bn": bn(net.policy_bn),
        "policy_fc": dense(net.policy_fc, flattened=True),
        "value_conv": conv(net.value_conv), "value_bn": bn(net.value_bn),
        "value_fc1": dense(net.value_fc1, flattened=True),
        "value_fc2": dense(net.value_fc2),
        "tower": (tower_operands(net) if packs_tower(
            dev, dtype, net.input_conv.out_channels) else None),
    }


def tower_operands(net: AlphaZeroNet) -> Dict[str, torch.Tensor]:
    """What ``fused.tower_forward`` reads of ``fused.pack_weights(net)``,
    on the net's device: the kernel's operands and ``"wconv"`` (the block
    count, and what the plain version reads); not the heads' copies."""
    packed = fused.pack_weights(net)
    return {k: packed[k] for k in
            ("wconv", *(k for k, _, _ in fused._KERNEL_OPERANDS))}


def packs_tower(dev: torch.device, dtype: torch.dtype, C: int) -> bool:
    """Whether ``prepare_inference`` keeps the fused tower's operands: on a
    card, in bfloat16, at the one width the kernel takes."""
    return dev.type == "cuda" and dtype == torch.bfloat16 and C == fused._C


def fused_tower(prep: Dict[str, Any], B: int) -> bool:
    """Whether ``inference_apply`` runs the tower of B boards as one
    ``fused.tower_forward`` launch: the tower's operands are there and B
    is at least ``B_MIN`` whole thread blocks of the kernel."""
    return prep["tower"] is not None and B % fused.TB == 0 and B >= B_MIN


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME conv of the NHWC map ``x`` by the channels-last OIHW ``w``, no
    bias: an NHWC view of the channels-last result."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def _dense(x: torch.Tensor, p) -> torch.Tensor:
    return x @ p[0] + p[1]


@torch.no_grad()
def inference_apply(prep: Dict[str, Any], planes: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, 8, 8) planes -> (policy_logits (B, 192), wl_logits (B, 2)),
    float32, through the weights of ``prepare_inference``."""
    # NHWC in the evaluator's dtype: one copy
    x = planes.permute(0, 2, 3, 1).to(prep["dtype"],
                                      memory_format=torch.contiguous_format)
    x = epilogue.bn_act(_conv(x, prep["input_conv"]), prep["input_bn"])
    B = x.shape[0]
    if fused_tower(prep, B):
        # the NHWC map is already the kernel's game-major rows: no copy
        x = fused.tower_forward(x.reshape(B * 64, -1), prep["tower"],
                                len(prep["blocks"])).view(x.shape)
    else:
        for b in prep["blocks"]:
            y = cv.conv3x3(x, b["conv1"], b["bn1"], relu=True,
                           image=b["conv1_image"])
            y = cv.conv3x3(y, b["conv2"], b["bn2"], image=b["conv2_image"])
            x = epilogue.se_residual(y, x, b["fc1"], b["fc2"])

    p = cv.conv3x3(x, prep["policy_conv"], prep["policy_bn"], relu=True,
                   image=prep["policy_conv_image"])
    policy_logits = _dense(p.reshape(B, -1), prep["policy_fc"])
    v = epilogue.bn_act(_conv(x, prep["value_conv"]), prep["value_bn"])
    v = torch.relu(_dense(v.reshape(B, -1), prep["value_fc1"]))
    wl_logits = _dense(v, prep["value_fc2"])
    return policy_logits.float(), wl_logits.float()
