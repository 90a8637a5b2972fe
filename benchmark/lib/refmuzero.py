"""MuZero's board-game networks, unrolled loss and backup in plain PyTorch:
a reference that imports nothing of the program or of JAX.

Schrittwieser et al., arXiv:1911.08265: Methods "Network architecture",
"Network input" and "Training", and ``pseudocode.py``
(``initial_inference``, ``recurrent_inference``, ``expand_node``,
``backpropagate``, ``scale_gradient``, ``make_target``,
``update_weights``). The benchmark's check and the tests
(``tests/test_torch_muzero.py``) hold the program to it. It reads the
weights by the names and layouts of the program's
``MuZeroNet.state_dict()``: convolutions OIHW, dense layers (out, in),
each norm as BatchNorm's ``weight``, ``bias``, ``running_mean`` and
``running_var``. With N(.) such a norm at inference, ``(x - mean) /
sqrt(var + 1e-5) * weight + bias``, and C the width:

- a tower (``represent_tower``, ``dynamics_tower``): ``x = relu(N(
  conv3x3(input)))``, then each block ``x = relu(x + N_2(conv3x3(relu(
  N_1(conv3x3(x))))))``;
- ``scale(s) = (s - min) / max(max - min, 1e-5)`` over a board's C x 64
  values;
- ``represent(planes) = scale(tower_h(planes))``;
- ``dynamics(s, a) = s' = scale(tower_g(cat[s, A(a)]))`` on the literal
  C + 3 channel concatenation, and ``r = tanh(W_2 relu(W_1 relu(N_r(
  conv1x1(s')))))``; ``A(a)`` is a one-hot from-square plane, a one-hot
  to-square plane where the target lies on the board and a plane of ones
  where it does, in the action's own (mover's) frame, action ``a = (row
  * 8 + col) * 3 + dir`` moving to ``(row + 1, col + (0, -1, +1)[dir])``;
- ``predict(s)``: policy ``W_p relu(N_p(conv3x3(s)))`` over the (c, h, w)
  flatten, 192 logits; value ``W_2 relu(W_1 relu(N_v(conv1x1(s))))``, 2
  win/loss logits, the value P(win) - P(loss).

Departures from the paper (the configuration's ``reduced`` and
``assumed``): the input stage is Breakthrough's 3 planes (mine, theirs,
ones) in place of the board-game history planes; the action planes are
the chess encoding's from, to and on-board planes with the promotion
planes dropped (Breakthrough has none); the value is win/loss logits in
place of a scalar; the reward head has the value head's widths and one
tanh scalar (the paper gives no form); ``scale``'s epsilon is 1e-5; the
backup is the negamax form at discount 1 (``backup``: ``G <- r - G`` an
edge up, the paper's pseudocode written for one player's view); the
search's selection keeps the port's PUCT rule (c_puct, unvisited q = 0)
in place of pb_c and MinMaxStats, which for values bounded in [-1, 1]
differs by a factor of under 4% on the exploration term over 800 visits;
the actions past a game's end are drawn uniformly from the seed, as the
pseudocode draws them, and their targets are absorbing (value 0 as
win/loss (1/2, 1/2), reward 0, no policy loss).

``represent``, ``dynamics`` and ``predict`` run in float32, with TF32 off
under ``exact_float32``. With ``fp8=True`` the operands of every
convolution and dense layer are first rounded to float8 e4m3 with one
scale a tensor (its largest magnitude mapped to 448), the products summed
in float32: the control, a precision below the bf16 that the search's
evaluator states. With ``calibrate=True`` every norm first takes the mean
and the biased variance of its input over the batch and the squares and
writes them into ``p`` as its running statistics; with ``train=True`` it
normalises by them without writing (the learner's BatchNorm in train
mode).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-5
SCALE_EPS = 1e-5
FP8_MAX = 448.0
SQUARES = 64
ILLEGAL, UNALLOCATED = -2.0, -1.0


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


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def action_planes(actions: torch.Tensor) -> torch.Tensor:
    """(B,) canonical actions -> (B, 3, 8, 8) float32 planes."""
    out = torch.zeros((actions.shape[0], 3, 8, 8), dtype=torch.float32,
                      device=actions.device)
    for i, a in enumerate(actions.tolist()):
        sq, d = divmod(int(a), 3)
        row, col = divmod(sq, 8)
        out[i, 0, row, col] = 1.0
        tc = col + (0, -1, 1)[d]
        if row + 1 < 8 and 0 <= tc < 8:
            out[i, 1, row + 1, tc] = 1.0
            out[i, 2] = 1.0
    return out


def scale_gradient(x: torch.Tensor, s: float) -> torch.Tensor:
    """The pseudocode's ``scale_gradient``: the value of ``x``, its
    gradient times ``s``."""
    return x * s + x.detach() * (1 - s)


class _Ref:
    def __init__(self, p: Params, fp8: bool, calibrate: bool, train: bool):
        self.p, self.fp8 = p, fp8
        self.calibrate, self.train = calibrate, train

    def conv(self, x, name):
        w = self.p[f"{name}.weight"]
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, padding=w.shape[-1] // 2)

    def dense(self, x, name):
        w = self.p[f"{name}.weight"]
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return x @ w.T + self.p[f"{name}.bias"]

    def norm_relu(self, x, name):
        p = self.p
        if self.calibrate or self.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            if self.calibrate:
                p[f"{name}.running_mean"] = mean.detach()
                p[f"{name}.running_var"] = var.detach()
        else:
            mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        scale = p[f"{name}.weight"] / torch.sqrt(var + EPS)
        return torch.relu((x - mean[:, None, None]) * scale[:, None, None]
                          + p[f"{name}.bias"][:, None, None])

    def norm(self, x, name):
        """The norm without the ReLU: a block's second."""
        p = self.p
        if self.calibrate or self.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            if self.calibrate:
                p[f"{name}.running_mean"] = mean.detach()
                p[f"{name}.running_var"] = var.detach()
        else:
            mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        scale = p[f"{name}.weight"] / torch.sqrt(var + EPS)
        return ((x - mean[:, None, None]) * scale[:, None, None]
                + p[f"{name}.bias"][:, None, None])

    def tower(self, x, pre):
        x = self.norm_relu(self.conv(x, f"{pre}.conv"), f"{pre}.bn")
        n = 1 + max(int(m.group(1)) for k in self.p
                    for m in [re.match(rf"{pre}\.blocks\.(\d+)\.", k)] if m)
        for i in range(n):
            b = f"{pre}.blocks.{i}"
            y = self.norm_relu(self.conv(x, f"{b}.conv1"), f"{b}.bn1")
            x = torch.relu(x + self.norm(self.conv(y, f"{b}.conv2"),
                                         f"{b}.bn2"))
        return x


def scale(s: torch.Tensor) -> torch.Tensor:
    flat = s.flatten(1)
    lo, hi = flat.amin(1, keepdim=True), flat.amax(1, keepdim=True)
    return ((flat - lo) / (hi - lo).clamp_min(SCALE_EPS)).view(s.shape)


def represent(p: Params, planes: torch.Tensor, fp8: bool = False,
              calibrate: bool = False, train: bool = False) -> torch.Tensor:
    """h: (B, 3, 8, 8) planes -> (B, C, 8, 8) hidden state."""
    r = _Ref(p, fp8, calibrate, train)
    return scale(r.tower(planes.float(), "represent_tower"))


def dynamics(p: Params, s: torch.Tensor, actions: torch.Tensor,
             fp8: bool = False, calibrate: bool = False, train: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g: (B, C, 8, 8) state and (B,) actions -> (next state, (B,)
    reward), the conv on the literal C + 3 channel concatenation."""
    r = _Ref(p, fp8, calibrate, train)
    x = torch.cat([s.float(), action_planes(actions.cpu()).to(s.device)], 1)
    s2 = scale(r.tower(x, "dynamics_tower"))
    h = r.norm_relu(r.conv(s2, "reward_conv"), "reward_bn")
    h = torch.relu(r.dense(h.flatten(1), "reward_fc1"))
    return s2, torch.tanh(r.dense(h, "reward_fc2")[:, 0])


def predict(p: Params, s: torch.Tensor, fp8: bool = False,
            calibrate: bool = False, train: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f: (B, C, 8, 8) state -> (policy logits (B, 192), win/loss logits
    (B, 2))."""
    r = _Ref(p, fp8, calibrate, train)
    pol = r.norm_relu(r.conv(s, "policy_conv"), "policy_bn")
    pol = r.dense(pol.flatten(1), "policy_fc")
    v = r.norm_relu(r.conv(s, "value_conv"), "value_bn")
    v = torch.relu(r.dense(v.flatten(1), "value_fc1"))
    return pol, r.dense(v, "value_fc2")


def priors_values(pol: torch.Tensor, wl: torch.Tensor,
                  legal: torch.Tensor | None = None):
    """Priors (renormalised over ``legal`` where given; uniform where its
    mass is 0) and values P(win) - P(loss)."""
    prob = torch.softmax(pol, -1)
    if legal is not None:
        prob = prob * legal
        mass = prob.sum(-1, keepdim=True)
        lg = legal.float()
        prob = torch.where(mass > 0, prob / mass.clamp_min(1e-30),
                           lg / lg.sum(-1, keepdim=True).clamp_min(1))
    wl = torch.softmax(wl, -1)
    return prob, wl[:, 0] - wl[:, 1]


@torch.no_grad()
def calibrate(p: Params, planes: torch.Tensor, actions: torch.Tensor) -> None:
    """Sets every norm's running statistics in ``p``: h's and f's over
    ``planes`` and their states, g's and the reward head's over those
    states and ``actions`` (float32, TF32 off)."""
    with exact_float32():
        s = represent(p, planes, calibrate=True)
        predict(p, s, calibrate=True)
        dynamics(p, s, actions, calibrate=True)


# -----------------------------------------------------------------------------
# The unrolled loss
# -----------------------------------------------------------------------------

def unrolled_loss(p: Params, planes: torch.Tensor, actions: torch.Tensor,
                  target_pi: torch.Tensor, target_wl: torch.Tensor,
                  target_r: torch.Tensor, pi_mask: torch.Tensor,
                  train: bool = True) -> Dict[str, torch.Tensor]:
    """The pseudocode's ``update_weights`` loss for a batch of B positions
    unrolled K steps: ``planes`` (B, 3, 8, 8), ``actions`` (B, K),
    ``target_pi`` (B, K+1, 192), ``target_wl`` (B, K+1, 2), ``target_r``
    (B, K) (the reward of step k+1's transition), ``pi_mask`` (B, K+1)
    (0 on absorbing steps, which have no policy target). Step 0 is h then
    f, step k >= 1 g then f; each step's loss is the policy's soft
    cross-entropy, the win/loss cross-entropy and, for k >= 1, the reward's
    squared error, each a batch mean; a recurrent step's loss has its
    gradient scaled by 1/K and each state after g by 1/2
    (``scale_gradient``), so the loss's value is the plain sum of the
    steps'. Returns the loss and its policy, value and reward parts.
    ``train``: the norms take the batch's statistics, as the learner's do.
    """
    K = actions.shape[1]
    s = represent(p, planes, train=train)
    totals = {"loss_pi": 0.0, "loss_wl": 0.0, "loss_r": 0.0}
    loss = 0.0
    for k in range(K + 1):
        if k:
            s, r = dynamics(p, s, actions[:, k - 1], train=train)
        pol, wl = predict(p, s, train=train)
        l_pi = -(pi_mask[:, k] * (target_pi[:, k] * torch.log_softmax(
            pol, -1)).sum(-1)).mean()
        l_wl = -(target_wl[:, k] * torch.log_softmax(wl, -1)).sum(-1).mean()
        l_r = ((r - target_r[:, k - 1]) ** 2).mean() if k else 0.0
        step = l_pi + l_wl + l_r
        loss = loss + (scale_gradient(step, 1.0 / K) if k else step)
        totals["loss_pi"] = totals["loss_pi"] + l_pi.detach()
        totals["loss_wl"] = totals["loss_wl"] + l_wl.detach()
        if k:
            totals["loss_r"] = totals["loss_r"] + l_r.detach()
            s = scale_gradient(s, 0.5)
    return {"loss": loss, **totals}


# -----------------------------------------------------------------------------
# The backup
# -----------------------------------------------------------------------------

def backup(path: list, leaf_value: float, reward_of, visits, vsum
           ) -> float:
    """One simulation's backup in the negamax form at discount 1, in
    float32 as the search keeps it: ``path`` is the walked (node, action)
    edges from the root, ``reward_of(node, action)`` the reward of the
    edge's transition (the mover's). ``G`` starts as the leaf's value (the
    player to move there); each edge from the deepest up sets ``G = r -
    G``, gains a visit and adds ``-G`` to its value sum (kept for the
    child's mover, as the tree keeps it); returns the root's ``G``."""
    G = np.float32(leaf_value)
    for node, a in reversed(path):
        G = np.float32(np.float32(reward_of(node, a)) - G)
        visits[node, a] += 1
        vsum[node, a] = np.float32(vsum[node, a] + np.float32(-G))
    return float(G)
