"""MuZero's board-game configuration in the harness: its weights drawn from
the seed and calibrated, its model FLOPs a board, and the check of a
search's stored states, rewards, priors and values against the reference
(``refmuzero``). Imports nothing of the program.

The weights are named and laid out as the program's
``MuZeroNet.state_dict()`` (convolutions OIHW, dense layers (out, in),
each norm as BatchNorm's weight, bias and running statistics), which the
reference reads too. They are drawn on the device by ``weights.seeded``
(a few large draws from one generator): every convolution and dense
matrix N(0, 1/fan_in), each norm's scale uniform in [0.8, 1.2] and its
bias N(0, 0.05^2), the dense layers' biases N(0, 0.05^2). Each residual
branch's last norm (a block's ``bn2``: its scale and bias) is then
multiplied by 1/sqrt(blocks), as Fixup and SkipInit scale residual
branches at initialisation (Zhang et al., 2019; De and Smith, 2020), so
that 16 blocks, and a path of some ten dynamics steps, are not chaotic,
as a trained net is not. The scale goes on the norm and not on the conv
before it, which the calibrated norm would undo. Then each norm's
running statistics are calibrated by the reference in float32
(``refmuzero.calibrate``) over positions drawn from the seed (random
legal playouts, ``nbt.calibration_planes``): h's and f's over their
planes and states, g's and the reward head's over those states and one
random legal action each. The configuration's ``weights`` names the
count (``calibrated_positions``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import nbt, refenv, refmuzero, weights

T = 64
VALUE_CHANNELS, VALUE_HIDDEN = 32, 128


def leaf_shapes(cfg: dict) -> weights.Shapes:
    """(name, shape, kind) of every parameter and statistic, convolutions
    given as (kh, kw, in, out) and dense layers as (in, out) for the draw
    (``seeded`` turns them into the program's layout)."""
    C, B = cfg["mz_filters"], cfg["mz_blocks"]
    out: weights.Shapes = []

    def conv(name, k, cin, cout):
        out.append((f"{name}.weight", (k, k, cin, cout), "kernel"))

    def dense(name, n_in, n_out):
        out.append((f"{name}.weight", (n_in, n_out), "kernel"))
        out.append((f"{name}.bias", (n_out,), "bias"))

    def norm(name, n):
        out.extend([(f"{name}.weight", (n,), "scale"),
                    (f"{name}.bias", (n,), "bias"),
                    (f"{name}.running_mean", (n,), "mean"),
                    (f"{name}.running_var", (n,), "var")])

    for tower, cin in (("represent_tower", cfg["input_planes"]),
                       ("dynamics_tower", C + cfg["mz_action_planes"])):
        conv(f"{tower}.conv", 3, cin, C)
        norm(f"{tower}.bn", C)
        for b in range(B):
            pre = f"{tower}.blocks.{b}"
            conv(f"{pre}.conv1", 3, C, C)
            norm(f"{pre}.bn1", C)
            conv(f"{pre}.conv2", 3, C, C)
            norm(f"{pre}.bn2", C)
    conv("reward_conv", 1, C, VALUE_CHANNELS)
    norm("reward_bn", VALUE_CHANNELS)
    dense("reward_fc1", VALUE_CHANNELS * T, VALUE_HIDDEN)
    dense("reward_fc2", VALUE_HIDDEN, 1)
    conv("policy_conv", 3, C, C)
    norm("policy_bn", C)
    dense("policy_fc", C * T, cfg["num_actions"])
    conv("value_conv", 1, C, VALUE_CHANNELS)
    norm("value_bn", VALUE_CHANNELS)
    dense("value_fc1", VALUE_CHANNELS * T, VALUE_HIDDEN)
    dense("value_fc2", VALUE_HIDDEN, 2)
    return out


def count_params(cfg: dict) -> int:
    """Trained parameters (the norms' statistics are not)."""
    return sum(int(np.prod(s)) for k, s, _ in leaf_shapes(cfg)
               if not k.endswith(("running_mean", "running_var")))


def calibration_actions(planes: np.ndarray, seed: int) -> np.ndarray:
    """One random legal action drawn from ``seed`` for each position of
    ``planes`` (the mover's frame, so an action of the mover's own)."""
    rng = np.random.default_rng((seed, 3))
    mine, theirs = planes[:, 0] > 0.5, planes[:, 1] > 0.5
    board = mine.astype(np.int8) - theirs.astype(np.int8)
    legal = refenv.legal_mask(board, np.ones(len(board), np.int8))
    return np.where(legal, rng.random(legal.shape), -1.0).argmax(1)


def seeded(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights drawn on ``device`` from ``seed``, by name, with
    every norm's statistics calibrated over positions drawn from it."""
    shapes = leaf_shapes(cfg)
    drawn = weights.seeded(shapes, seed, device)
    out = {}
    for k, shape, kind in shapes:
        t = drawn[k]
        if kind == "kernel" and len(shape) == 4:
            t = t.permute(3, 2, 0, 1)                  # (kh, kw, i, o): OIHW
        elif kind == "kernel":
            t = t.T                                    # (in, out): (out, in)
        if ".bn2." in k and kind in ("scale", "bias"):
            t = t * cfg["mz_blocks"] ** -0.5
        out[k] = t.contiguous()
    n = int(cfg["weights"]["calibrated_positions"])
    planes = nbt.calibration_planes(n, seed)
    actions = calibration_actions(planes, seed)
    refmuzero.calibrate(out, torch.from_numpy(planes).to(device),
                        torch.from_numpy(actions).to(device))
    return out


def forward_flops(cfg: dict, initial: bool = False) -> int:
    """Model FLOPs of one evaluated board (a multiply-add counts two): the
    recurrent inference (g on C + 3 input channels, the reward head, f) or,
    with ``initial``, the initial inference (h on the input planes, f).
    Not counted: the norms, activations, residual adds and scale."""
    C, B = cfg["mz_filters"], cfg["mz_blocks"]
    conv3 = lambda cin, cout: 2 * T * 9 * cin * cout
    head = 2 * T * C * VALUE_CHANNELS + 2 * VALUE_CHANNELS * T * VALUE_HIDDEN
    f = (conv3(C, C) + 2 * C * T * cfg["num_actions"] + head
         + 2 * VALUE_HIDDEN * 2)
    tower = 2 * B * conv3(C, C)
    if initial:
        return conv3(cfg["input_planes"], C) + tower + f
    return (conv3(C + cfg["mz_action_planes"], C) + tower + head
            + 2 * VALUE_HIDDEN + f)


def evaluator_numbers(w: Dict[str, torch.Tensor], judged: List,
                      dev: torch.device, control: bool = False,
                      block: int = 256) -> Dict[str, float]:
    """The judged trees' stored states, rewards, priors and values against
    the reference's in float32, one step at a time: a root's state by
    ``represent`` from its planes, every other node's state, reward,
    priors and value by ``dynamics`` and ``predict`` from its parent's
    STORED state (as float32) and its edge's action, so that errors do not
    compound along a path. With ``control`` the reference in float8 takes
    the program's place. Returns ``latent_err_max`` (absolute: states lie
    in [0, 1]), ``reward_err_mean``/``_max``, ``policy_tv_mean``/``_max``,
    ``value_err_mean``/``_max`` and the counts."""
    inf = float("inf")
    nodes = sum(len(j.action) for j in judged)
    if not judged or not nodes:
        return {"latent_err_max": inf, "policy_tv_mean": inf,
                "value_err_mean": inf, "reward_err_mean": inf,
                "positions": 0}
    lat = lambda a: torch.from_numpy(a).to(dev).float().view(
        -1, 8, 8, a.shape[-1]).permute(0, 3, 1, 2)
    lat_err = 0.0
    tv, dv, dr = [], [], []
    with refmuzero.exact_float32(), torch.no_grad():
        roots = np.stack([j.root_planes for j in judged])
        s_root = refmuzero.represent(w, torch.from_numpy(roots).to(dev))
        if control:
            got = refmuzero.represent(w, torch.from_numpy(roots).to(dev),
                                      fp8=True)
        else:
            got = lat(np.stack([j.root_latent for j in judged]))
        lat_err = float((got - s_root).abs().max())
        parent = np.concatenate([j.parent_latent for j in judged])
        action = np.concatenate([j.action for j in judged])
        stored = np.concatenate([j.latent for j in judged])
        prior = np.concatenate([j.prior for j in judged])
        value = np.concatenate([j.value for j in judged])
        reward = np.concatenate([j.reward for j in judged])
        for s in range(0, nodes, block):
            sl = slice(s, s + block)
            sp = lat(parent[sl])
            a = torch.from_numpy(action[sl]).to(dev)
            s2, r = refmuzero.dynamics(w, sp, a)
            p, v = refmuzero.priors_values(*refmuzero.predict(w, s2))
            if control:
                g2, gr = refmuzero.dynamics(w, sp, a, fp8=True)
                gp, gv = refmuzero.priors_values(
                    *refmuzero.predict(w, g2, fp8=True))
            else:
                g2 = lat(stored[sl])
                gr = torch.from_numpy(reward[sl]).to(dev)
                gp = torch.from_numpy(prior[sl]).to(dev)
                gv = torch.from_numpy(value[sl]).to(dev)
            lat_err = max(lat_err, float((g2 - s2).abs().max()))
            tv.append(0.5 * (gp.double() - p.double()).abs().sum(-1))
            dv.append((gv.double() - v.double()).abs())
            dr.append((gr.double() - r.double()).abs())
    tv, dv, dr = (torch.cat(x).cpu().numpy() for x in (tv, dv, dr))
    return {"latent_err_max": lat_err,
            "policy_tv_mean": float(tv.mean()),
            "policy_tv_max": float(tv.max()),
            "value_err_mean": float(dv.mean()),
            "value_err_max": float(dv.max()),
            "reward_err_mean": float(dr.mean()),
            "reward_err_max": float(dr.max()),
            "positions": int(nodes)}
