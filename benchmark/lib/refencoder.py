"""Leela Chess Zero's BT4 attention body in plain PyTorch: a reference
forward that imports nothing of the program or of JAX.

The benchmark's check and the tests (``tests/test_torch_encoder.py``)
both hold the program to it.

It reads the weights by the names and layouts of the program's
``EncoderNet.state_dict()`` (dense weights (out, in)). With T = 64 squares
of the canonical frame (square 8r + c holds the planes at row r, column
c), E the embedding, H heads of D = E / H, and N layers:

- ``x = mish([planes_s ; onehot(s)] W_emb + b_emb)``, then the input gates
  ``x * gate_mult[s] + gate_add[s]``;
- each layer: smolgen (``c = x W_c`` flattened over the board, ``h1 =
  LN(swish(c W_1 + b_1))``, ``h2 = LN(swish(h1 W_2 + b_2))`` over the whole
  H x G vector, head h's bias ``h2_h W_gen`` with one ``W_gen`` for all
  layers); ``a = softmax(Q K^T / sqrt(D) + bias) V``; ``x = LN1(alpha x +
  a W_o + b_o)``; ``x = LN2(alpha x + mish(x W_1 + b_1) W_2 + b_2)``, with
  ``alpha = (2N)^(1/4)`` and LayerNorm's epsilon 1e-3;
- policy: ``p = mish(x W_p + b)``, ``L = (p W_q + b)(p W_k + b)^T /
  sqrt(P)``; action 3s + d (d: forward, left, right) takes ``L[s, 8(r + 1)
  + c + (0, -1, +1)[d]]``, or 0 where that square is off the board;
- value: ``mish(x W_v + b)`` to 32 a square, flattened, ``mish`` of a dense
  layer to 128, then 2 win/loss logits; the value is P(win) - P(loss).

``forward`` runs in float32, with TF32 off under ``exact_float32``. With
``fp8=True`` the operands of every matrix product (each dense layer, Q
K^T, the softmax's product with V, smolgen's generator and the policy's q
k^T) are first rounded to float8 e4m3 with one scale a tensor (its
largest magnitude mapped to 448) and the products summed in float32: the
control, a precision below the bf16 that the search's evaluator states.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-3
FP8_MAX = 448.0
T = 64


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


def num_layers(p: Params) -> int:
    found = {int(m.group(1)) for k in p
             for m in [re.match(r"layers\.(\d+)\.", k)] if m}
    return max(found) + 1 if found else 0


def action_targets() -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat index s * 64 + target, on-board) of each of the 192 actions."""
    index, valid = [], []
    for a in range(192):
        s, d = divmod(a, 3)
        r, c = divmod(s, 8)
        tr, tc = r + 1, c + (0, -1, 1)[d]
        ok = tr < 8 and 0 <= tc < 8
        index.append(s * T + tr * 8 + tc if ok else 0)
        valid.append(ok)
    return torch.tensor(index), torch.tensor(valid)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _dense(x: torch.Tensor, p: Params, name: str, fp8: bool) -> torch.Tensor:
    y = _mm(x, p[f"{name}.weight"].T, fp8)
    bias = p.get(f"{name}.bias")
    return y if bias is None else y + bias


def _ln(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], EPS)


def forward(p: Params, planes: torch.Tensor, heads: int, fp8: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, 8, 8) planes -> (policy logits (B, 192), win/loss logits
    (B, 2))."""
    B = planes.shape[0]
    tokens = planes.float().reshape(B, -1, T).transpose(1, 2)
    onehot = torch.eye(T, device=planes.device).expand(B, T, T)
    x = F.mish(_dense(torch.cat([tokens, onehot], -1), p, "embed", fp8))
    x = x * p["gate_mult"] + p["gate_add"]
    N = num_layers(p)
    alpha = (2.0 * N) ** 0.25
    E = x.shape[-1]
    D = E // heads
    for i in range(N):
        pre = f"layers.{i}"
        c = _dense(x, p, f"{pre}.sg_compress", fp8).reshape(B, -1)
        h = _ln(F.silu(_dense(c, p, f"{pre}.sg_dense1", fp8)), p,
                f"{pre}.sg_ln1")
        h = _ln(F.silu(_dense(h, p, f"{pre}.sg_dense2", fp8)), p,
                f"{pre}.sg_ln2")
        bias = _dense(h.view(B, heads, -1), p, "smolgen_gen",
                      fp8).view(B, heads, T, T)
        q, k, v = (_dense(x, p, f"{pre}.{n}", fp8).view(B, T, heads, D)
                   .transpose(1, 2) for n in "qkv")
        logits = _mm(q, k.transpose(-1, -2), fp8) / math.sqrt(D) + bias
        a = _mm(torch.softmax(logits, -1), v, fp8)
        a = a.transpose(1, 2).reshape(B, T, E)
        x = _ln(alpha * x + _dense(a, p, f"{pre}.o", fp8), p, f"{pre}.ln1")
        f = _dense(F.mish(_dense(x, p, f"{pre}.ffn1", fp8)), p,
                   f"{pre}.ffn2", fp8)
        x = _ln(alpha * x + f, p, f"{pre}.ln2")

    pol = F.mish(_dense(x, p, "policy_embed", fp8))
    q, k = _dense(pol, p, "policy_q", fp8), _dense(pol, p, "policy_k", fp8)
    L = _mm(q, k.transpose(-1, -2), fp8).flatten(1) / math.sqrt(q.shape[-1])
    index, valid = action_targets()
    policy = torch.where(valid.to(L.device), L[:, index.to(L.device)], 0.0)
    v = F.mish(_dense(x, p, "value_embed", fp8)).reshape(B, -1)
    v = F.mish(_dense(v, p, "value_fc1", fp8))
    return policy, _dense(v, p, "value_fc2", fp8)


@torch.no_grad()
def evaluate(p: Params, planes: torch.Tensor, legal: torch.Tensor,
             heads: int, fp8: bool = False, block: int = 256
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Priors over the legal actions (renormalised; uniform where the legal
    mass is 0) and values P(win) - P(loss), float32, in blocks of
    ``block`` positions so that the reference fits beside anything."""
    priors, values = [], []
    with exact_float32():
        for s in range(0, planes.shape[0], block):
            pol, wl = forward(p, planes[s:s + block], heads, fp8=fp8)
            prob = torch.softmax(pol, -1) * legal[s:s + block]
            mass = prob.sum(-1, keepdim=True)
            lg = legal[s:s + block].float()
            uniform = lg / lg.sum(-1, keepdim=True).clamp_min(1)
            priors.append(torch.where(mass > 0, prob / mass.clamp_min(1e-30),
                                      uniform))
            wl = torch.softmax(wl, -1)
            values.append(wl[:, 0] - wl[:, 1])
    return torch.cat(priors), torch.cat(values)
