"""MuZero's search evaluator: the representation at a search's root, the
dynamics and prediction at every other simulation, and the latent store.

``Evaluator`` is what ``mcts.make_net_evaluator`` returns for a
``MuZeroNet``: ``initial(planes, store, slot)`` evaluates real positions
(h, then f) and ``recurrent(latent, action, store, slot)`` a stored hidden
state and an action (g, then f); both write the new hidden state into the
tree's latent store at ``store[:, slot]`` and return float32 priors and
values (and g's rewards), copying nothing from the host, so that a search
captures the recurrent call as it captures the other bodies' evaluators.
In float32 it runs the module's ``represent``, ``dynamics`` and
``predict``; in bf16 the route below.

The bf16 route (``prepare``, ``initial_apply``, ``recurrent_apply``) runs
on (B*64, C) rows, a row a square of a board:

- every 3x3 conv of both towers and the policy head is one ``conv3x3``
  launch, the first conv of a block with its BN and ReLU as the epilogue,
  the second with its BN's affine; each block closes with one
  ``residual_act`` launch, ``relu(x + y)`` (its norm the identity), so the
  BNs are not folded into the convs: they are the convs' epilogues at no
  extra pass, and a fold would move the bf16 rounding points;
- h's input conv (3 planes) runs on ``conv3x3`` at width C with the planes
  and the weights zero-padded to C input channels: it runs once a search,
  at the root, so the 98.8% of its products on zeros cost one launch in
  800 simulations;
- g's input conv over [s ; A(a)] (C + 3 channels) is folded: ``conv3x3``
  of s, then ``action_term``, which adds the action planes' term gathered
  from the conv's taps and the input BN's affine and ReLU (the taps, and
  the plane of ones' conv clipped at the board's edges, are tables that
  ``prepare`` makes once; ``csrc/muzero_kernels.cu`` says why the padding
  needs nothing else). A 264-channel conv3x3 would need a width the
  kernel is not compiled for and 3% more products; the fold adds 259/256
  of nothing;
- ``scale`` is one ``latent_scale`` launch a tower, which writes the
  scaled state both as the next net's input and into the store;
- f's policy conv is ``conv3x3`` with its BN and ReLU; f's value head and
  g's reward head both read the new state, so their 1x1 convs are one
  (C, 64) product, their BNs one ``epilogue.bn_act`` launch on the 64
  channels, their first dense layers one (4096, 256) block-diagonal
  product; the second layers and the reward's tanh are small products and
  one op each, rounded apart as Flax's ``nn.Dense`` rounds.

On a CUDA tensor ``action_term`` and ``latent_scale`` launch their
kernels (``<wrapper>.launches`` counts them) or raise; on a CPU tensor
they run their plain versions, ``action_term_plain`` and
``latent_scale_plain``, in any float dtype, with which the kernels are
bit-equal.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import I, LL, P
from alphazero_torch.models import conv
from alphazero_torch.models.epilogue import BN, bn_act, check_bn
from alphazero_torch.models.muzero import (SCALE_EPS, SQUARES,
                                           VALUE_CHANNELS, MuZeroNet)
from alphazero_torch.models.nbt_epilogue import residual_act

LIB = cuda_build.Library("muzero_kernels",
                         action_term_bf16=[P] * 8 + [LL, I, P],
                         latent_scale_bf16=[P] * 4 + [LL, LL, I, P])
# what latent_scale's kernel takes: C a multiple of 8 up to this
MAX_SCALE_CHANNELS = 256


# -----------------------------------------------------------------------------
# The action's term of g's input conv
# -----------------------------------------------------------------------------

def action_tables(w_act: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (C, 3, 3, 3) OIHW taps of g's input conv on the three action
    planes -> (taps (2, 9, C): the from- and to-square planes' taps, ones
    (64, C): the conv of the plane of ones, its taps summed in float64
    over those on the board), float32 on ``w_act``'s device."""
    w = w_act.detach().double()
    C = w.shape[0]
    taps = w[:, :2].permute(1, 2, 3, 0).reshape(2, 9, C)
    q = torch.arange(SQUARES, device=w.device)
    ones = torch.zeros((SQUARES, C), dtype=torch.float64, device=w.device)
    for ky in range(3):
        for kx in range(3):
            r, c = q // 8 + ky - 1, q % 8 + kx - 1
            on = ((r >= 0) & (r < 8) & (c >= 0) & (c < 8)).double()
            ones += on[:, None] * w[None, :, 2, ky, kx]
    return taps.float().contiguous(), ones.float().contiguous()


def _taps_at(sq: torch.Tensor) -> torch.Tensor:
    """(B, 64) tap index of input square ``sq[b]`` seen from each output
    square, or -1 where it lies outside the 3 x 3 window."""
    q = torch.arange(SQUARES, device=sq.device)
    dr = sq[:, None] // 8 - q // 8
    dc = sq[:, None] % 8 - q % 8
    ok = (dr.abs() <= 1) & (dc.abs() <= 1)
    return torch.where(ok, (dr + 1) * 3 + dc + 1, -1)


def action_term_plain(y: torch.Tensor, action: torch.Tensor,
                      taps: torch.Tensor, ones: torch.Tensor, bn: BN
                      ) -> torch.Tensor:
    """What ``action_term`` computes on the (B*64, C) rows ``y`` (the conv
    of the state) and the (B,) actions: ``relu(((y + ((tf + tt) + to)) -
    mean) * mul + beta)`` in float32, rounded to ``y``'s dtype once, where
    tf, tt and to are the from-square's, the to-square's and the plane of
    ones' terms (0 where absent), added in that order."""
    B, C = action.shape[0], y.shape[1]
    a = action.long()
    frm, d = a // 3, a % 3
    step = (d == 2).long() - (d == 1).long()
    to_col = frm % 8 + step
    on = (frm // 8 + 1 < 8) & (to_col >= 0) & (to_col < 8)
    tf = _taps_at(frm)
    tt = torch.where(on[:, None], _taps_at(frm + 8 + step), -1)
    t = torch.zeros((B, SQUARES, C), dtype=torch.float32, device=y.device)
    t = torch.where((tf >= 0)[..., None], t + taps[0][tf.clamp_min(0)], t)
    t = torch.where((tt >= 0)[..., None], t + taps[1][tt.clamp_min(0)], t)
    t = torch.where(on[:, None, None], t + ones[None], t)
    mean, mul, beta = bn
    s = y.view(B, SQUARES, C).float() + t
    out = torch.relu((s - mean) * mul + beta)
    return out.to(y.dtype).view(B * SQUARES, C)


@cuda_build.counted
def action_term(y: torch.Tensor, action: torch.Tensor, taps: torch.Tensor,
                ones: torch.Tensor, bn: BN) -> torch.Tensor:
    """g's input conv finished: the (B*64, C) rows ``y`` = conv3x3 of the
    state, plus the (B,) actions' term from ``action_tables``, through the
    input BN and ReLU, as ``action_term_plain`` computes them; new rows. On
    a CUDA tensor one launch of ``action_term_kernel`` (bfloat16 rows, C a
    multiple of 8); on a CPU tensor the plain version."""
    if y.dim() != 2 or y.shape[0] != SQUARES * action.shape[0]:
        raise ValueError(f"y must be (B*64, C) for {action.shape[0]} "
                         f"actions, got {tuple(y.shape)}")
    C = y.shape[1]
    if tuple(taps.shape) != (2, 9, C) or tuple(ones.shape) != (SQUARES, C):
        raise ValueError(f"taps {tuple(taps.shape)} and ones "
                         f"{tuple(ones.shape)} do not fit C {C}")
    if y.device.type == "cpu":
        return action_term_plain(y, action, taps, ones, bn)
    dev = y.device
    if C % 8:
        raise ValueError(f"the kernel takes C a multiple of 8, got {C}")
    cuda_build.check_operand("y", y, dev, torch.bfloat16)
    cuda_build.check_operand("action", action, dev, torch.int32,
                             (action.shape[0],), aligned=False)
    cuda_build.check_operand("taps", taps, dev, torch.float32)
    cuda_build.check_operand("ones", ones, dev, torch.float32)
    check_bn(bn, C, dev)
    cuda_build.check_device(dev)
    out = torch.empty_like(y)
    cuda_build.launch(
        action_term, LIB.action_term_bf16, y.data_ptr(), action.data_ptr(),
        taps.data_ptr(), ones.data_ptr(), *(t.data_ptr() for t in bn),
        out.data_ptr(), action.shape[0], C,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


# -----------------------------------------------------------------------------
# scale, and the store's write
# -----------------------------------------------------------------------------

def latent_scale_plain(x: torch.Tensor, store: torch.Tensor | None = None,
                       slot: torch.Tensor | None = None) -> torch.Tensor:
    """What ``latent_scale`` computes: each board's (64, C) state of the
    (B*64, C) rows ``x`` as ``(x - min) / max(max - min, 1e-5)`` in
    float32, rounded to ``x``'s dtype once; new rows, also written into
    ``store[:, slot]`` where a store is given."""
    C = x.shape[1]
    xf = x.float().view(-1, SQUARES * C)
    lo = xf.amin(1, keepdim=True)
    hi = xf.amax(1, keepdim=True)
    out = ((xf - lo) / (hi - lo).clamp_min(SCALE_EPS)).to(x.dtype)
    if store is not None:
        store.index_copy_(1, slot.view(1).long(),
                          out.view(-1, 1, SQUARES, C).to(store.dtype))
    return out.view(x.shape)


@cuda_build.counted
def latent_scale(x: torch.Tensor, store: torch.Tensor | None = None,
                 slot: torch.Tensor | None = None) -> torch.Tensor:
    """MuZero's ``scale`` of the (B*64, C) rows ``x``, as
    ``latent_scale_plain`` computes it; new rows, and with ``store`` (B,
    slots, 64, C) the same values at ``store[b, slot]``, ``slot`` a ()
    int32 tensor read where it lies. On a CUDA tensor one launch of
    ``latent_scale_kernel`` (bfloat16, C a multiple of 8 up to
    ``MAX_SCALE_CHANNELS``); on a CPU tensor the plain version."""
    if x.dim() != 2 or x.shape[0] % SQUARES:
        raise ValueError(f"x must be (B*64, C), got {tuple(x.shape)}")
    B, C = x.shape[0] // SQUARES, x.shape[1]
    if store is not None and (store.dim() != 4 or store.shape[0] != B
                              or tuple(store.shape[2:]) != (SQUARES, C)
                              or slot is None):
        raise ValueError(f"store must be (B, slots, 64, C) for B {B}, C "
                         f"{C} with a slot, got {tuple(store.shape)}")
    if x.device.type == "cpu":
        return latent_scale_plain(x, store, slot)
    dev = x.device
    if C % 8 or C > MAX_SCALE_CHANNELS:
        raise ValueError(f"the kernel takes C a multiple of 8 up to "
                         f"{MAX_SCALE_CHANNELS}, got {C}")
    cuda_build.check_operand("x", x, dev, torch.bfloat16)
    if store is not None:
        cuda_build.check_operand("store", store, dev, torch.bfloat16)
        cuda_build.check_operand("slot", slot, dev, torch.int32, (),
                                 aligned=False)
    cuda_build.check_device(dev)
    out = torch.empty_like(x)
    cuda_build.launch(
        latent_scale, LIB.latent_scale_bf16, x.data_ptr(), out.data_ptr(),
        None if store is None else store.data_ptr(),
        None if store is None else slot.data_ptr(),
        0 if store is None else store.shape[1], B, C,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


# -----------------------------------------------------------------------------
# The bf16 route
# -----------------------------------------------------------------------------

def prepare(net: MuZeroNet, dtype: torch.dtype = torch.bfloat16
            ) -> Dict[str, Any]:
    """``net``'s weights for ``initial_apply`` and ``recurrent_apply`` in
    ``dtype`` on the net's device: a snapshot that later training does not
    change. Each 3x3 conv keeps its OIHW weights and, on a card in bf16,
    its ``conv3x3`` image; each BN its float32 (mean, mul, beta)."""
    dev = next(net.parameters()).device
    on_card = dev.type == "cuda" and dtype == torch.bfloat16
    C = net.filters

    def cast(t: torch.Tensor, dt=dtype) -> torch.Tensor:
        return t.detach().to(device=dev, dtype=dt, copy=True).contiguous()

    def bn(b) -> BN:
        # on the host in float32, so that the card's constants are the CPU's
        f = lambda v: v.detach().to("cpu", torch.float32)
        mul = torch.rsqrt(f(b.running_var) + b.eps) * f(b.weight)
        return tuple(cast(v, torch.float32)
                     for v in (f(b.running_mean), mul, f(b.bias)))

    def conv3(w: torch.Tensor) -> Dict[str, Any]:
        w = cast(w)
        return {"w": w, "image": conv.weight_image(w) if on_card else None}

    def tower(t, w_in) -> Dict[str, Any]:
        return {"conv": conv3(w_in), "bn": bn(t.bn),
                "blocks": [{"conv1": conv3(b.conv1.weight), "bn1": bn(b.bn1),
                            "conv2": conv3(b.conv2.weight), "bn2": bn(b.bn2)}
                           for b in t.blocks]}

    def hwc(fc: torch.nn.Linear, channels: int) -> torch.Tensor:
        """A dense layer over an NCHW flatten as an (in, out) matrix over
        the (h, w, c) flatten of NHWC rows."""
        w = fc.weight.detach()
        out = w.shape[0]
        return w.view(out, channels, SQUARES).permute(2, 1, 0).reshape(
            SQUARES * channels, out)

    w_h = net.represent_tower.conv.weight.detach()
    w_g = net.dynamics_tower.conv.weight.detach()
    taps, ones = action_tables(w_g[:, C:])
    V, H = VALUE_CHANNELS, net.value_fc1.out_features
    fc1 = torch.zeros((SQUARES * 2 * V, 2 * H), dtype=torch.float32,
                      device=dev)
    # rows (h, w, c) over the value's and the reward's channels side by side
    fc1.view(SQUARES, 2 * V, 2 * H)[:, :V, :H] = hwc(
        net.value_fc1, V).view(SQUARES, V, H)
    fc1.view(SQUARES, 2 * V, 2 * H)[:, V:, H:] = hwc(
        net.reward_fc1, V).view(SQUARES, V, H)
    vr_bn = tuple(torch.cat(p) for p in zip(bn(net.value_bn),
                                             bn(net.reward_bn)))
    return {
        "dtype": dtype, "filters": C,
        "represent": tower(net.represent_tower,
                           F.pad(w_h, (0, 0, 0, 0, 0, C - w_h.shape[1]))),
        "dynamics": {**tower(net.dynamics_tower, w_g[:, :C]),
                     "taps": cast(taps, torch.float32),
                     "ones": cast(ones, torch.float32)},
        "identity": tuple(cast(t, torch.float32) for t in (
            torch.zeros(C), torch.ones(C), torch.zeros(C))),
        "policy_conv": conv3(net.policy_conv.weight),
        "policy_bn": bn(net.policy_bn),
        "policy_fc": (cast(hwc(net.policy_fc, C)), cast(net.policy_fc.bias)),
        "vr_conv": cast(torch.cat([net.value_conv.weight.detach(),
                                   net.reward_conv.weight.detach()])
                        [:, :, 0, 0].T),
        "vr_bn": vr_bn,
        "vr_fc1": (cast(fc1), cast(torch.cat([net.value_fc1.bias.detach(),
                                              net.reward_fc1.bias.detach()]))),
        "value_fc2": (cast(net.value_fc2.weight.T),
                      cast(net.value_fc2.bias)),
        "reward_fc2": (cast(net.reward_fc2.weight.T),
                       cast(net.reward_fc2.bias)),
    }


def _conv3(x: torch.Tensor, B: int, site: Dict[str, Any], bn=None,
           relu: bool = False) -> torch.Tensor:
    """The 3x3 conv of (B*64, C) rows as (B*64, C) rows."""
    C = x.shape[1]
    y = conv.conv3x3(x.view(B, 8, 8, C), site["w"], bn, relu, site["image"])
    return y.view(B * SQUARES, C)


def _blocks(prep: Dict[str, Any], x: torch.Tensor, B: int,
            blocks) -> torch.Tensor:
    for blk in blocks:
        y = _conv3(x, B, blk["conv1"], blk["bn1"], relu=True)
        y = _conv3(y, B, blk["conv2"], blk["bn2"])
        _, x = residual_act(y, prep["identity"], x)
    return x


def _dense(x: torch.Tensor, p) -> torch.Tensor:
    return x @ p[0] + p[1]


def _heads(prep: Dict[str, Any], s: torch.Tensor, B: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f's policy and win/loss logits and g's reward head, float32, from
    the (B*64, C) rows of a state."""
    p = _conv3(s, B, prep["policy_conv"], prep["policy_bn"], relu=True)
    policy_logits = _dense(p.view(B, -1), prep["policy_fc"])
    vr = bn_act((s @ prep["vr_conv"]).view(B, 8, 8, -1), prep["vr_bn"])
    h = torch.relu(_dense(vr.reshape(B, -1), prep["vr_fc1"]))
    H = h.shape[1] // 2
    wl_logits = _dense(h[:, :H], prep["value_fc2"])
    reward = torch.tanh(_dense(h[:, H:], prep["reward_fc2"]).float())[:, 0]
    return policy_logits.float(), wl_logits.float(), reward


@torch.no_grad()
def initial_apply(prep: Dict[str, Any], planes: torch.Tensor,
                  store: torch.Tensor | None = None,
                  slot: torch.Tensor | None = None):
    """h then f: (B, 3, 8, 8) planes -> (policy logits (B, 192), win/loss
    logits (B, 2), state rows (B*64, C)), the state also written into
    ``store[:, slot]`` where a store is given."""
    B, C, dt = planes.shape[0], prep["filters"], prep["dtype"]
    x = F.pad(planes.permute(0, 2, 3, 1).to(dt),
              (0, C - planes.shape[1])).contiguous()
    t = prep["represent"]
    x = _conv3(x.view(B * SQUARES, C), B, t["conv"], t["bn"], relu=True)
    s = latent_scale(_blocks(prep, x, B, t["blocks"]), store, slot)
    policy_logits, wl_logits, _ = _heads(prep, s, B)
    return policy_logits, wl_logits, s


@torch.no_grad()
def recurrent_apply(prep: Dict[str, Any], latent: torch.Tensor,
                    action: torch.Tensor,
                    store: torch.Tensor | None = None,
                    slot: torch.Tensor | None = None):
    """g then f: the (B*64, C) rows of a state and (B,) int32 actions ->
    (policy logits, win/loss logits, reward (B,), next state rows), the
    state also written into ``store[:, slot]`` where a store is given."""
    B = action.shape[0]
    t = prep["dynamics"]
    y = _conv3(latent, B, t["conv"])
    x = action_term(y, action, t["taps"], t["ones"], t["bn"])
    s = latent_scale(_blocks(prep, x, B, t["blocks"]), store, slot)
    policy_logits, wl_logits, reward = _heads(prep, s, B)
    return policy_logits, wl_logits, reward, s


# -----------------------------------------------------------------------------
# The search's evaluator
# -----------------------------------------------------------------------------

def _wl_value(wl_logits: torch.Tensor) -> torch.Tensor:
    wl = torch.softmax(wl_logits, dim=-1)
    return wl[..., 0] - wl[..., 1]


class Evaluator:
    """MuZero's evaluator for ``mcts.search``: a snapshot of the net's
    weights in ``dtype``. ``latent_shape`` is a state's (64, C) and
    ``dtype`` the latent store's."""

    recurrent_evaluator = True

    def __init__(self, net: MuZeroNet, dtype: torch.dtype):
        self.dtype = dtype
        self.latent_shape = (SQUARES, net.filters)
        if dtype == torch.float32:
            net.eval()
            self.net, self.prep = net, None
        else:
            self.net, self.prep = None, prepare(net, dtype)

    @staticmethod
    def _store(rows: torch.Tensor, store, slot) -> None:
        if store is not None:
            store.index_copy_(1, slot.view(1).long(),
                              rows.view(store.shape[0], 1, *store.shape[2:])
                              .to(store.dtype))

    def _rows(self, s: torch.Tensor) -> torch.Tensor:
        """An NCHW state of the module as (B*64, C) rows."""
        return s.permute(0, 2, 3, 1).reshape(-1, s.shape[1])

    def _nchw(self, rows: torch.Tensor, B: int) -> torch.Tensor:
        return rows.view(B, 8, 8, -1).permute(0, 3, 1, 2).float()

    @torch.no_grad()
    def initial(self, planes: torch.Tensor, store=None, slot=None):
        """(B, 3, 8, 8) planes -> (priors (B, 192), values (B,), state rows
        (B*64, C)); the state is written into ``store[:, slot]``."""
        if self.prep is None:
            s = self.net.represent(planes.float())
            pol, wl = self.net.predict(s)
            rows = self._rows(s)
            self._store(rows, store, slot)
        else:
            pol, wl, rows = initial_apply(self.prep, planes, store, slot)
        return torch.softmax(pol, dim=-1), _wl_value(wl), rows

    @torch.no_grad()
    def recurrent(self, latent: torch.Tensor, action: torch.Tensor,
                  store=None, slot=None):
        """(B*64, C) state rows and (B,) int32 actions -> (priors, values,
        rewards (B,), next state rows); the next state is written into
        ``store[:, slot]``."""
        B = action.shape[0]
        if self.prep is None:
            s, reward = self.net.dynamics(self._nchw(latent, B), action)
            pol, wl = self.net.predict(s)
            rows = self._rows(s)
            self._store(rows, store, slot)
        else:
            pol, wl, reward, rows = recurrent_apply(self.prep, latent,
                                                    action, store, slot)
        return torch.softmax(pol, dim=-1), _wl_value(wl), reward, rows


class PairEvaluator:
    """Two MuZero evaluators searched in one batch (the arena): every call
    takes ``ctx``, (B,) bool, and each lane's results and stored state are
    the first evaluator's where it is set, else the second's."""

    recurrent_evaluator = True

    def __init__(self, a: Evaluator, b: Evaluator):
        if (a.latent_shape, a.dtype) != (b.latent_shape, b.dtype):
            raise ValueError(
                f"a MuZero pair shares one latent store: states "
                f"{a.latent_shape} in {a.dtype} against {b.latent_shape} "
                f"in {b.dtype}")
        self.a, self.b = a, b
        self.latent_shape, self.dtype = a.latent_shape, a.dtype

    @staticmethod
    def _pick(ctx, x, y):
        return torch.where(ctx.view(-1, *([1] * (x.dim() - 1))), x, y)

    def _select(self, ctx, ra, rb, store, slot):
        B = ctx.shape[0]
        out = [self._pick(ctx, x, y) for x, y in zip(ra[:-1], rb[:-1])]
        rows = self._pick(ctx, ra[-1].view(B, -1),
                          rb[-1].view(B, -1)).view(ra[-1].shape)
        Evaluator._store(rows, store, slot)
        return (*out, rows)

    def initial(self, planes, store=None, slot=None, ctx=None):
        return self._select(ctx, self.a.initial(planes),
                            self.b.initial(planes), store, slot)

    def recurrent(self, latent, action, store=None, slot=None, ctx=None):
        return self._select(ctx, self.a.recurrent(latent, action),
                            self.b.recurrent(latent, action), store, slot)
