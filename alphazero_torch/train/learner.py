"""Learner: losses, optimizer, LR schedule and the train step.

Port of ``alphazero_tpu/train/learner.py``, with the same training
contract:

- policy loss: soft-target cross-entropy, -mean(sum(pi * log_softmax))
- value loss: win/loss cross-entropy (soft targets)
- total = policy + value, unweighted
- global-norm clip 1.0, then L2-style weight decay 1e-4 added to the
  *clipped* gradient, then Adam scaling, then ``-lr``
- cosine-annealing LR advanced once per ``learn()`` call (NOT per
  minibatch), T_max always taken from the live config
- horizontal-mirror augmentation: a per-sample random mirror on the
  device (state column flip + a constant 192-permutation of the policy)

MuZero's net (``models/muzero.py``) trains on the unrolled loss of the
paper's ``update_weights`` (``muzero_loss_fn``): from each sampled
position, h then f, and K times g then f along the game's later actions,
against the policy, win/loss and reward targets of ``ReplayBuffer.unroll``;
the mirror flips the planes and maps the actions and policies through the
same permutation.

The optimizer is ``torch.optim.Adam(weight_decay=...)``, which adds
``weight_decay * param`` to the gradient before the moments, after a clip
written out here: ``clip_grad_norm_`` scales by ``clip / (norm + 1e-6)``,
while the JAX package (optax) leaves gradients under the limit untouched
and scales the rest by ``clip / norm``. The step updates the net and the
optimizer in place and returns the metrics as tensors on the device, so
that a run of steps needs no host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from alphazero_torch import resolve_device, tracing
from alphazero_torch.config import Config
from alphazero_torch.models.muzero import MuZeroNet
from alphazero_torch.models.network import AlphaZeroNet
from alphazero_torch.parallel.mesh import all_reduce_mean_

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mirror_permutation(board_size: int = 8) -> np.ndarray:
    """perm such that mirrored_policy[perm[a]] = policy[a]: square column
    mirrored, diag-left <-> diag-right."""
    perm = np.zeros(board_size * board_size * 3, np.int32)
    dir_swap = {0: 0, 1: 2, 2: 1}
    for sq in range(board_size * board_size):
        r, c = divmod(sq, board_size)
        msq = r * board_size + (board_size - 1 - c)
        for d in range(3):
            perm[sq * 3 + d] = msq * 3 + dir_swap[d]
    return perm


_MIRROR_PERM = mirror_permutation()
# inverse permutation: mirrored[a] = original[inv[a]]
_MIRROR_GATHER = np.argsort(_MIRROR_PERM).astype(np.int64)


@dataclasses.dataclass
class TrainState:
    """The float32 training net, its optimizer and the two counters; all
    tensors live on ``device``."""
    net: AlphaZeroNet
    opt: torch.optim.Adam
    learn_calls: int = 0    # cosine schedule position (per learn())
    iteration: int = 0
    mirror_gather: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device


def cosine_lr(cfg: Config, learn_calls: int) -> float:
    """torch CosineAnnealingLR closed form: eta_min + (base - eta_min) *
    (1 + cos(pi * t / T_max)) / 2, with T_max from the live config."""
    cos = math.cos(math.pi * float(learn_calls) / cfg.lr_t_max)
    return cfg.lr_eta_min + (cfg.learning_rate - cfg.lr_eta_min) * (
        1.0 + cos) / 2.0


def make_optimizer(cfg: Config, net: AlphaZeroNet) -> torch.optim.Adam:
    """L2 decay -> Adam scaling -> -lr; the clip comes before it in
    ``train_step``, which also sets the rate from the cosine position."""
    return torch.optim.Adam(net.parameters(), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def create_train_state(cfg: Config, net: AlphaZeroNet,
                       device="cuda") -> TrainState:
    """A fresh train state around ``net`` (moved to ``device``, float32)."""
    dev = resolve_device(device)
    net = net.to(dev, torch.float32)
    return TrainState(net=net, opt=make_optimizer(cfg, net),
                      mirror_gather=torch.from_numpy(_MIRROR_GATHER).to(dev))


def loss_fn(net: AlphaZeroNet, states, target_pi, target_wl):
    policy_logits, wl_logits = net(states)
    log_pi = torch.log_softmax(policy_logits, dim=-1)
    loss_pi = -(target_pi * log_pi).sum(-1).mean()
    log_wl = torch.log_softmax(wl_logits, dim=-1)
    loss_wl = -(target_wl * log_wl).sum(-1).mean()
    return loss_pi + loss_wl, loss_pi, loss_wl


def scale_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The value of ``x`` with its gradient times ``scale`` (the paper's
    ``scale_gradient``)."""
    return x * scale + x.detach() * (1.0 - scale)


def muzero_loss_fn(net, states, actions, target_pi, target_wl, target_r,
                   pi_mask):
    """MuZero's unrolled loss over a batch of B positions and K steps:
    ``actions`` (B, K), ``target_pi`` (B, K+1, A), ``target_wl`` (B, K+1,
    2), ``target_r`` (B, K), ``pi_mask`` (B, K+1), as
    ``ReplayBuffer.unroll`` gives them. Each step's loss is the policy's
    soft cross-entropy (masked on absorbing steps), the win/loss
    cross-entropy and, past step 0, the reward's squared error (the
    pseudocode's ``scalar_loss`` for board games), each a batch mean; a
    recurrent step's gradient is scaled by 1/K and the state after each g
    by 1/2. Returns (loss, loss_pi, loss_wl, loss_r), the parts summed over
    the steps."""
    K = actions.shape[1]
    s = net.represent(states)
    loss = loss_pi = loss_wl = loss_r = 0.0
    for k in range(K + 1):
        if k:
            s, r = net.dynamics(s, actions[:, k - 1])
        policy_logits, wl_logits = net.predict(s)
        l_pi = -(pi_mask[:, k] * (target_pi[:, k] * torch.log_softmax(
            policy_logits, dim=-1)).sum(-1)).mean()
        l_wl = -(target_wl[:, k] * torch.log_softmax(
            wl_logits, dim=-1)).sum(-1).mean()
        step = l_pi + l_wl
        if k:
            l_r = ((r - target_r[:, k - 1]) ** 2).mean()
            step = scale_gradient(step + l_r, 1.0 / K)
            loss_r = loss_r + l_r.detach()
            s = scale_gradient(s, 0.5)
        loss = loss + step
        loss_pi = loss_pi + l_pi.detach()
        loss_wl = loss_wl + l_wl.detach()
    return loss, loss_pi, loss_wl, loss_r


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place to a global norm of at most
    ``max_norm``, as optax does: untouched under the limit, ``g / norm *
    max_norm`` above it. No host sync. Returns the norm before the clip."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def train_step(state: TrainState, batch: Batch, mirror_bits: torch.Tensor,
               cfg: Config, mesh=None) -> Dict[str, torch.Tensor]:
    """One SGD step on ``state``, in place. ``batch`` is (planes
    (B,3,8,8), target policy (B,192), target WL (B,2)) on the state's
    device; ``mirror_bits`` (B,) bool selects per-sample horizontal
    mirroring. Returns loss, loss_pi, loss_wl (0-dim tensors) and lr.

    With a ``parallel.Mesh`` (and ``state`` replicated over it) the batch
    is this rank's shard of the global batch: the gradients are averaged
    over the group before the clip, and the losses returned are the
    global batch's (``parallel.sharded_train_step``). The forward, the
    backward (with the gradients' average) and the clip with the optimizer
    are the spans ``learn.forward``, ``learn.backward`` and
    ``learn.optimizer`` (``alphazero_torch.tracing``).

    MuZero's net takes ``ReplayBuffer.unroll``'s six tensors (planes,
    actions, target_pi, target_wl, target_r, pi_mask) as its ``batch`` and
    the unrolled loss (``muzero_loss_fn``); its metrics add ``loss_r``."""
    muzero = isinstance(state.net, MuZeroNet)
    if muzero:
        states, actions, target_pi, target_wl, target_r, pi_mask = batch
        # the mirror is an involution: its gather maps actions as well
        actions = torch.where(mirror_bits[:, None],
                              state.mirror_gather[actions], actions)
    else:
        states, target_pi, target_wl = batch
    states = states.float()

    m = mirror_bits[:, None]
    if muzero:
        m = m[..., None]
    target_pi = torch.where(m, target_pi[..., state.mirror_gather],
                            target_pi)
    states = torch.where(mirror_bits[:, None, None, None], states.flip(-1),
                         states)

    lr = cosine_lr(cfg, state.learn_calls)
    for group in state.opt.param_groups:
        group["lr"] = lr

    state.net.train()
    state.opt.zero_grad(set_to_none=True)
    with tracing.span("learn.forward"):
        if muzero:
            loss, loss_pi, loss_wl, loss_r = muzero_loss_fn(
                state.net, states, actions, target_pi, target_wl, target_r,
                pi_mask)
        else:
            loss, loss_pi, loss_wl = loss_fn(state.net, states, target_pi,
                                             target_wl)
    params = list(state.net.parameters())
    with tracing.span("learn.backward"):
        loss.backward()
        if mesh is not None:
            # BatchNorm's backward all-reduce already carried every rank's
            # loss through the global statistics: average once, here, in
            # the same all-reduce as the losses
            losses = torch.stack([loss, loss_pi, loss_wl]).detach()
            all_reduce_mean_(mesh, [p.grad for p in params] + [losses])
            loss, loss_pi, loss_wl = losses
    with tracing.span("learn.optimizer"):
        clip_by_global_norm_(params, cfg.grad_clip_norm)
        state.opt.step()
    out = {"loss": loss.detach(), "loss_pi": loss_pi.detach(),
           "loss_wl": loss_wl.detach(), "lr": lr}
    if muzero:
        out["loss_r"] = loss_r
    return out


def update_rows(states, policies, wls, s_upd, p_upd, w_upd, start: int):
    """In-place row-span write into the device-resident replay window:
    numpy blocks ``*_upd`` go to rows [start, start + len) of the three
    device tensors, which are returned."""
    for buf, upd in ((states, s_upd), (policies, p_upd), (wls, w_upd)):
        buf[start:start + len(upd)].copy_(torch.from_numpy(upd))
    return states, policies, wls


def train_epoch(state: TrainState, buf: Batch, base_idx: torch.Tensor,
                mirror: torch.Tensor, cfg: Config, mesh=None
                ) -> Dict[str, torch.Tensor]:
    """A whole learn epoch over the device-resident replay window.

    ``buf`` is ((N,3,8,8) uint8 planes, (N,A) f32 policies, (N,2) f32 WL)
    on the device; ``base_idx``/``mirror`` are the (steps, B)
    ``epoch_batches`` outputs, also on the device. Each step gathers its
    minibatch on the device and runs ``train_step``, so the host uploads
    no batch and reads no metric per step. Returns the metrics stacked
    over steps ((steps,) per key). With ``mesh`` the window is this
    rank's replay shard and every step is ``train_step``'s sharded one."""
    states_u8, policies, wls = buf
    steps = []
    for bi, mi in zip(base_idx, mirror):
        batch = (states_u8[bi], policies[bi], wls[bi])
        steps.append(train_step(state, batch, mi, cfg, mesh=mesh))
    out = {k: torch.stack([s[k] for s in steps])
           for k in ("loss", "loss_pi", "loss_wl")}
    out["lr"] = torch.full((len(steps),), steps[0]["lr"],
                           device=states_u8.device)
    return out
