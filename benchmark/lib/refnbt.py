"""KataGo's nested-bottleneck residual net (b28c512nbt) in plain PyTorch: a
reference forward that imports nothing of the program or of JAX.

The benchmark's check and the tests (``tests/test_torch_nbt.py``) both
hold the program to it. It reads the weights by the names and layouts of
the program's ``NbtNet.state_dict()``: convolutions OIHW, dense layers
(out, in), each norm as BatchNorm's ``weight``, ``bias``,
``running_mean`` and ``running_var``. With N(.) such a norm at inference,
``(x - mean) / sqrt(var + 1e-5) * weight + bias``, C the trunk, M the
mid width, G the pooled channels, R = M - G:

- ``x = conv3x3(planes)``; each block ``t = conv1x1(relu(N_p(x)))``, its
  inner blocks ``t = t + conv3x3(relu(N_2(conv3x3(relu(N_1(t))))))``,
  then ``x = x + conv1x1(relu(N_q(t)))``;
- a pooling inner block (``conv1`` of R outputs beside ``convg`` of G):
  ``g = relu(N_g(convg(u)))``, ``pool = [mean(g), -0.6 mean(g), max(g)]``
  over the 64 squares, ``v = relu(N_2(conv1(u) + W_g pool))``;
- ``y = relu(N_final(x))``; policy ``p = conv1x1(y)``, ``q =
  relu(N_g1(conv1x1(y)))``, ``p = relu(N_p2(p + W_pg pool(q)))``, three
  logits a square from a last conv1x1, action 3s + d; value ``v =
  relu(N_v1(conv1x1(y)))``, its mean m, ``relu(W_1 [m, -0.6 m, 0.26 m] +
  b_1)``, then 2 win/loss logits. The value is P(win) - P(loss).

Departures from KataGo (the configuration's ``reduced`` and
``assumed``): Breakthrough's 3 input planes through one 3x3 conv, with no
global input features, in place of KataGo's input stage; three policy
planes (192 actions), without the pass logit or the extra policy
channels; win/loss value logits, without KataGo's no-result, score, lead,
variance-time, ownership and score-belief heads; a fixed 8 x 8 board, so
the norms and pools run over all 64 squares with no mask and sqrt(area)
is 8; ReLU throughout; KataGo's norms (BatchNorm or fixup scale and bias)
as BatchNorm's inference affine.

``forward`` runs in float32, with TF32 off for convolutions and matrix
products under ``exact_float32``. With ``fp8=True`` the operands of every
convolution and dense layer are first rounded to float8 e4m3 with one
scale a tensor (its largest magnitude mapped to 448) and the products
summed in float32: the control, a precision below the bf16 that the
search's evaluator states. With ``calibrate=True`` every norm first takes
the mean and the biased variance of its input over the batch and the
squares, in float32, and writes them into ``p`` as its running
statistics, as a trained BatchNorm's would be: one pass calibrates the
net in order.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-5
FP8_MAX = 448.0
SQUARES = 64


@contextlib.contextmanager
def exact_float32():
    """float32 convolutions and matrix products without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _count(p: Params, pattern: str) -> int:
    found = {int(m.group(1)) for k in p for m in [re.match(pattern, k)] if m}
    return max(found) + 1 if found else 0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Ref:
    def __init__(self, p: Params, fp8: bool, calibrate: bool):
        self.p, self.fp8, self.calibrate = p, fp8, calibrate

    def conv(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.p[f"{name}.weight"]
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, padding=w.shape[-1] // 2)

    def dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        w = self.p[f"{name}.weight"]
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        y = x @ w.T
        bias = self.p.get(f"{name}.bias")
        return y if bias is None else y + bias

    def norm_relu(self, x: torch.Tensor, name: str) -> torch.Tensor:
        p = self.p
        if self.calibrate:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            p[f"{name}.running_mean"] = mean
            p[f"{name}.running_var"] = var
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        scale = p[f"{name}.weight"] / torch.sqrt(var + EPS)
        y = ((x - mean[:, None, None]) * scale[:, None, None]
             + p[f"{name}.bias"][:, None, None])
        return torch.relu(y)


def _pool(g: torch.Tensor, third: str) -> torch.Tensor:
    mean = g.mean((2, 3))
    last = g.amax((2, 3)) if third == "max" else mean * 0.26
    return torch.cat([mean, mean * ((SQUARES ** 0.5 - 14) / 10), last], 1)


def forward(p: Params, planes: torch.Tensor, fp8: bool = False,
            calibrate: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, 8, 8) planes -> (policy logits (B, 192), win/loss logits
    (B, 2))."""
    r = _Ref(p, fp8, calibrate)
    x = r.conv(planes.float(), "input_conv")
    for b in range(_count(p, r"blocks\.(\d+)\.")):
        pre = f"blocks.{b}"
        t = r.conv(r.norm_relu(x, f"{pre}.norm_pre"), f"{pre}.conv_down")
        for i in range(_count(p, rf"{pre}\.inner\.(\d+)\.")):
            name = f"{pre}.inner.{i}"
            u = r.norm_relu(t, f"{name}.norm1")
            y = r.conv(u, f"{name}.conv1")
            if f"{name}.convg.weight" in p:
                g = r.norm_relu(r.conv(u, f"{name}.convg"), f"{name}.normg")
                y = y + r.dense(_pool(g, "max"),
                                f"{name}.gpool_fc")[:, :, None, None]
            t = t + r.conv(r.norm_relu(y, f"{name}.norm2"), f"{name}.conv2")
        x = x + r.conv(r.norm_relu(t, f"{pre}.norm_post"), f"{pre}.conv_up")
    y = r.norm_relu(x, "norm_final")

    pol = r.conv(y, "policy_conv")
    q = r.norm_relu(r.conv(y, "policy_gconv"), "policy_gnorm")
    pol = pol + r.dense(_pool(q, "max"), "policy_gpool_fc")[:, :, None, None]
    pol = r.conv(r.norm_relu(pol, "policy_norm"), "policy_out")
    policy = pol.permute(0, 2, 3, 1).reshape(planes.shape[0], -1)
    v = r.norm_relu(r.conv(y, "value_conv"), "value_norm")
    h = torch.relu(r.dense(_pool(v, "mean"), "value_fc1"))
    return policy, r.dense(h, "value_fc2")


@torch.no_grad()
def calibrate(p: Params, planes: torch.Tensor) -> None:
    """Sets every norm's running statistics in ``p``, in order, to those
    of its input over ``planes`` (float32, TF32 off)."""
    with exact_float32():
        forward(p, planes, calibrate=True)


@torch.no_grad()
def evaluate(p: Params, planes: torch.Tensor, legal: torch.Tensor,
             fp8: bool = False, block: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Priors over the legal actions (renormalised; uniform where the legal
    mass is 0) and values P(win) - P(loss), float32, in blocks of
    ``block`` positions so that the reference fits beside anything."""
    priors, values = [], []
    with exact_float32():
        for s in range(0, planes.shape[0], block):
            pol, wl = forward(p, planes[s:s + block], fp8=fp8)
            prob = torch.softmax(pol, -1) * legal[s:s + block]
            mass = prob.sum(-1, keepdim=True)
            lg = legal[s:s + block].float()
            uniform = lg / lg.sum(-1, keepdim=True).clamp_min(1)
            priors.append(torch.where(mass > 0, prob / mass.clamp_min(1e-30),
                                      uniform))
            wl = torch.softmax(wl, -1)
            values.append(wl[:, 0] - wl[:, 1])
    return torch.cat(priors), torch.cat(values)
