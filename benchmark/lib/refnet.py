"""The SE-ResNet in plain PyTorch: the benchmark's reference forward.

It reads the weights in the archive's own scheme (``params/<module>/...``
and ``batch_stats/<module>/...``, Flax's module paths): convolution
kernels HWIO, dense kernels (in, out), and the two dense layers after a
flatten (``policy_fc``, ``value_fc1``) in (h, w, c) input order. The net:

- a 3x3 input conv, BatchNorm, ReLU;
- blocks of conv3x3, BN, ReLU, conv3x3, BN, then Leela Chess Zero's
  squeeze-excitation with scale and shift (the pooled map through
  ``fc1``, ReLU and ``fc2``, whose 2C outputs split into a sigmoid gate
  and a bias: ``y * gate + bias``), the skip added, ReLU;
- a policy head (conv3x3, BN, ReLU, dense to 192 logits) and a value head
  (conv1x1 to 32, BN, ReLU, dense to 128, ReLU, dense to 2 win/loss
  logits); the value is P(win) - P(loss).

``forward`` runs in float32 with TF32 off (``exact_float32``). With
``fp8=True`` every convolution's and dense layer's operands are first
rounded to float8 e4m3 (a scale per tensor, its largest magnitude mapped
to 448) and the products summed in float32: the control, a precision
below the bf16 that the configurations state for the search's evaluator.
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


def num_blocks(p: Params) -> int:
    found = {int(m.group(1)) for k in p
             for m in [re.match(r"params/block_(\d+)/", k)] if m}
    return max(found) + 1 if found else 0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _conv(x, kernel, fp8):
    w = kernel.permute(3, 2, 0, 1)                   # HWIO -> OIHW
    if fp8:
        x, w = _fp8(x), _fp8(w)
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


def _dense(x, p, name, fp8):
    k, b = p[f"params/{name}/kernel"], p[f"params/{name}/bias"]
    if fp8:
        x, k = _fp8(x), _fp8(k)
    return x @ k + b


def _bn_eval(x, p, name):
    mean = p[f"batch_stats/{name}/mean"]
    var = p[f"batch_stats/{name}/var"]
    mul = torch.rsqrt(var + EPS) * p[f"params/{name}/scale"]
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + p[f"params/{name}/bias"][:, None, None])


def _bn_train(x, p, name):
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    mul = torch.rsqrt(var + EPS) * p[f"params/{name}/scale"]
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + p[f"params/{name}/bias"][:, None, None])


def forward(p: Params, planes: torch.Tensor, fp8: bool = False,
            train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 3, 8, 8) planes -> (policy logits (N, 192), win/loss logits
    (N, 2)). ``train`` normalises by the batch's statistics (biased
    variance), as a training step does; otherwise by the stored ones."""
    bn = _bn_train if train else _bn_eval
    x = planes.float()
    x = F.relu(bn(_conv(x, p["params/input_conv/kernel"], fp8), p,
                  "input_bn"))
    for i in range(num_blocks(p)):
        pre = f"block_{i}"
        y = F.relu(bn(_conv(x, p[f"params/{pre}/conv1/kernel"], fp8), p,
                      f"{pre}/bn1"))
        y = bn(_conv(y, p[f"params/{pre}/conv2/kernel"], fp8), p,
               f"{pre}/bn2")
        h = F.relu(_dense(y.mean((2, 3)), p, f"{pre}/se/fc1", fp8))
        gate, shift = _dense(h, p, f"{pre}/se/fc2", fp8).chunk(2, dim=-1)
        y = y * torch.sigmoid(gate)[:, :, None, None] + shift[:, :, None, None]
        x = F.relu(y + x)
    n = x.shape[0]
    pol = F.relu(bn(_conv(x, p["params/policy_conv/kernel"], fp8), p,
                    "policy_bn"))
    pol = _dense(pol.permute(0, 2, 3, 1).reshape(n, -1), p, "policy_fc", fp8)
    v = F.relu(bn(_conv(x, p["params/value_conv/kernel"], fp8), p,
                  "value_bn"))
    v = F.relu(_dense(v.permute(0, 2, 3, 1).reshape(n, -1), p, "value_fc1",
                      fp8))
    return pol, _dense(v, p, "value_fc2", fp8)


@torch.no_grad()
def evaluate(p: Params, planes: torch.Tensor, legal: torch.Tensor,
             fp8: bool = False, block: int = 2048
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
