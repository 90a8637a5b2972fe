"""The nested-bottleneck body's bf16 search evaluator.

``prepare`` casts ``NbtNet``'s weights once, on the net's device, into the
layout ``apply`` reads: each 1x1 conv as an (in, out) matrix in the
evaluator's dtype (the policy head's two 1x1 convs side by side in one),
each 3x3 conv of the tower in OIHW with, on a card, its ``conv3x3`` image,
each norm as the float32 (mean, mul, beta) that the kernels take (``mul =
rsqrt(var + eps) * gamma``), the pooled dense layers as float32 (3G, R)
matrices. A pooling block's first conv is one M -> M conv, its R regular
and G pooled output channels side by side, and its second conv takes the
R channels zero-padded to M (weights zero there), since ``conv3x3`` takes
cin = cout: 25% of that conv's products are on zeros.

``apply`` runs the forward on bf16 (B*64, C) rows, copying nothing from
the host, so a search captures it as it captures the SE evaluator. The
input conv is ``F.conv2d`` on channels-last maps (3 planes in); every 3x3
conv of the tower is one ``conv.conv3x3`` launch, the first of a regular
inner block with its norm and ReLU as the epilogue; the 1x1 convs are
cuBLAS products; every other residual add, norm and activation of the
tower is one ``nbt_epilogue.residual_act`` or ``gpool_bias`` launch, or,
where no residual is added (after the input conv, each 1x1 conv down and
the value head's conv), one ``epilogue.bn_act`` launch, so the norm-act
comes before a conv as a pass of its own and the conv's halo reads zeros,
as KataGo pads its activated maps. The value head's three
pooled terms, ``[m, -0.6 m, 0.26 m]`` of the board mean m, are folded into
one (V, hidden) matrix; its two small dense layers run in float32. On the
CPU the same code runs with the plain versions in any float dtype.

The norms are not folded into the conv weights: each 3x3 conv's norm is
its epilogue or the next kernel's prologue at no extra pass, and a fold
would move the bf16 rounding points.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from alphazero_torch.models import conv
from alphazero_torch.models.epilogue import bn_act
from alphazero_torch.models.nbt import (GPOOL_SCALE, POLICY_PLANES, SQUARES,
                                        VALUE_SCALE, NbtNet)
from alphazero_torch.models.nbt_epilogue import gpool_bias, residual_act


def prepare(net: NbtNet, dtype: torch.dtype = torch.bfloat16
            ) -> Dict[str, Any]:
    """``net``'s weights for ``apply`` in ``dtype`` on the net's device: a
    snapshot that later training does not change."""
    dev = next(net.parameters()).device
    on_card = dev.type == "cuda" and dtype == torch.bfloat16

    def cast(t: torch.Tensor, dt=dtype) -> torch.Tensor:
        return t.detach().to(device=dev, dtype=dt, copy=True).contiguous()

    def bn(b) -> Tuple[torch.Tensor, ...]:
        f = lambda t: t.detach().float()
        mul = torch.rsqrt(f(b.running_var) + b.eps) * f(b.weight)
        return tuple(cast(v, torch.float32)
                     for v in (f(b.running_mean), mul, f(b.bias)))

    def mat(*convs: torch.nn.Conv2d) -> torch.Tensor:
        """The 1x1 convs' (in, out) matrix, side by side."""
        return cast(torch.cat([c.weight.detach()[:, :, 0, 0].T
                               for c in convs], 1))

    def conv3(w: torch.Tensor) -> Dict[str, Any]:
        w = cast(w)
        return {"w": w, "image": conv.weight_image(w) if on_card else None}

    def inner(blk) -> Dict[str, Any]:
        out = {"norm1": bn(blk.norm1), "norm2": bn(blk.norm2)}
        if blk.gpool:
            regular = blk.conv1.weight.shape[0]
            w2 = blk.conv2.weight.detach()
            out.update(
                conv1=conv3(torch.cat([blk.conv1.weight.detach(),
                                       blk.convg.weight.detach()], 0)),
                conv2=conv3(F.pad(w2, (0, 0, 0, 0, 0,
                                       w2.shape[0] - w2.shape[1]))),
                normg=bn(blk.normg), regular=regular,
                gpool_w=cast(blk.gpool_fc.weight.T, torch.float32))
        else:
            out.update(conv1=conv3(blk.conv1.weight),
                       conv2=conv3(blk.conv2.weight))
        return out

    blocks = [{"norm_pre": bn(b.norm_pre), "down": mat(b.conv_down),
               "inner": [inner(i) for i in b.inner],
               "norm_post": bn(b.norm_post), "up": mat(b.conv_up)}
              for b in net.blocks]
    fc1 = net.value_fc1.weight.detach().float()
    V = fc1.shape[1] // 3
    folded = (fc1[:, :V] + GPOOL_SCALE * fc1[:, V:2 * V]
              + VALUE_SCALE * fc1[:, 2 * V:])
    return {
        "dtype": dtype,
        "input_conv": cast(net.input_conv.weight).to(
            memory_format=torch.channels_last),
        "blocks": blocks, "norm_final": bn(net.norm_final),
        "policy": mat(net.policy_conv, net.policy_gconv),
        "policy_gnorm": bn(net.policy_gnorm), "policy_norm": bn(net.policy_norm),
        "policy_gpool_w": cast(net.policy_gpool_fc.weight.T, torch.float32),
        "policy_out": mat(net.policy_out),
        "value_conv": mat(net.value_conv), "value_norm": bn(net.value_norm),
        "value_fc1": (cast(folded.T, torch.float32),
                      cast(net.value_fc1.bias, torch.float32)),
        "value_fc2": (cast(net.value_fc2.weight.T, torch.float32),
                      cast(net.value_fc2.bias, torch.float32)),
    }


def _norm_act(y: torch.Tensor, B: int, bn) -> torch.Tensor:
    """``epilogue.bn_act`` of (B*64, C) rows as (B*64, C) rows."""
    return bn_act(y.view(B, 8, 8, -1), bn).view(y.shape)


def _conv3(u: torch.Tensor, B: int, site: Dict[str, Any], bn=None,
           relu: bool = False) -> torch.Tensor:
    """The 3x3 conv of (B*64, M) rows as (B*64, M) rows."""
    M = u.shape[1]
    y = conv.conv3x3(u.view(B, 8, 8, M), site["w"], bn, relu, site["image"])
    return y.view(B * SQUARES, M)


@torch.no_grad()
def apply(prep: Dict[str, Any], planes: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, 8, 8) planes -> (policy_logits (B, 192), wl_logits (B, 2)),
    float32, through the weights of ``prepare``."""
    B, dt = planes.shape[0], prep["dtype"]
    x = F.conv2d(planes.to(dt).contiguous(memory_format=torch.channels_last),
                 prep["input_conv"], padding=1)
    x = x.permute(0, 2, 3, 1).reshape(B * SQUARES, -1)
    blocks = prep["blocks"]
    a = _norm_act(x, B, blocks[0]["norm_pre"])
    for n, blk in enumerate(blocks):
        t = a @ blk["down"]
        inner = blk["inner"]
        u = _norm_act(t, B, inner[0]["norm1"])
        for i, site in enumerate(inner):
            after = (inner[i + 1]["norm1"] if i + 1 < len(inner)
                     else blk["norm_post"])
            if "regular" in site:
                y = _conv3(u, B, site["conv1"]).view(B, SQUARES, -1)
                v = gpool_bias(y, site["normg"], site["gpool_w"],
                               site["norm2"], site["regular"], y.shape[2])
                y = _conv3(v.view(B * SQUARES, -1), B, site["conv2"])
            else:
                h = _conv3(u, B, site["conv1"], site["norm2"], relu=True)
                y = _conv3(h, B, site["conv2"])
            t, u = residual_act(y, after, t)
        after = (blocks[n + 1]["norm_pre"] if n + 1 < len(blocks)
                 else prep["norm_final"])
        x, a = residual_act(u @ blk["up"], after, x)

    P = prep["policy_out"].shape[0]
    pq = (a @ prep["policy"]).view(B, SQUARES, 2 * P)
    p = gpool_bias(pq, prep["policy_gnorm"], prep["policy_gpool_w"],
                   prep["policy_norm"], P, P)
    logits = (p.view(B * SQUARES, P) @ prep["policy_out"]).view(
        B, SQUARES * POLICY_PLANES).float()
    v = _norm_act(a @ prep["value_conv"], B, prep["value_norm"])
    m = v.view(B, SQUARES, -1).float().mean(1)
    h = torch.relu(torch.addmm(prep["value_fc1"][1], m,
                               prep["value_fc1"][0]))
    return logits, torch.addmm(prep["value_fc2"][1], h, prep["value_fc2"][0])
