"""The nested-bottleneck body's configuration in the harness: its weights
drawn from the seed and calibrated, its model FLOPs a board, and the check
of a search's priors and values against the reference (``refnbt``).
Imports nothing of the program.

The weights are named and laid out as the program's
``NbtNet.state_dict()`` (convolutions OIHW, dense layers (out, in), each
norm as BatchNorm's weight, bias and running statistics), which the
reference reads too. They are drawn on the device by ``weights.seeded`` (a
few large draws from one generator): every convolution and dense matrix
N(0, 1/fan_in), but the last conv of each residual branch (an inner
block's second 3x3 conv, a block's 1x1 conv up) N(0, 1/(fan_in blocks)),
the value head's biases N(0, 0.05^2), each norm's scale uniform in [0.8,
1.2] and its bias N(0, 0.05^2). The branches' scale keeps the sum of the
28 blocks' outputs at the trunk's own variance, as Fixup and SkipInit
scale residual branches at initialisation (Zhang et al., 2019; De and
Smith, 2020), so that the random net is not chaotic, as a trained net is
not: with every branch at N(0, 1/fan_in), bf16's own rounding moved the
priors 0.12 in total variation from float32's, half the float8
control's 0.22, and a search whose second half of each batch took the
first half's mean read 0.13-0.16, inside any limit that bf16 passes
(PERF.md, section 6). Then each norm's running
statistics are calibrated by the reference in float32 (``refnbt.calibrate``)
over positions drawn from the seed, each a
random legal playout of 0 to ``CALIBRATION_PLIES`` - 1 plies from the
initial position: the mean and variance of its input, as a trained
BatchNorm's running statistics would be. Without them the trunk, a sum of
28 blocks' outputs, would grow from block to block. The configuration's
``weights`` names the count (``calibrated_positions``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import refenv, refnbt, treecheck, weights

T = 64
CALIBRATION_PLIES = 40
# the last conv of each residual branch, drawn at 1/sqrt(blocks) the scale
BRANCH_ENDS = ("conv2.weight", "conv_up.weight")
# the pooling blocks' spacing (the configuration's ``assumed`` placement)
GPOOL_EVERY = 3


def is_gpool_block(b: int) -> bool:
    """Whether block ``b`` (from 0) pools: 3, 6, ..., counted from 1."""
    return (b + 1) % GPOOL_EVERY == 0


def leaf_shapes(cfg: dict) -> weights.Shapes:
    """(name, shape, kind) of every parameter and statistic, convolutions
    given as (kh, kw, in, out) and dense layers as (in, out) for the draw
    (``seeded`` turns them into the program's layout)."""
    C, M, G = cfg["nbt_trunk"], cfg["nbt_mid"], cfg["nbt_gpool"]
    H, V = cfg["nbt_head"], cfg["nbt_value_hidden"]
    out: weights.Shapes = []

    def conv(name, k, cin, cout):
        out.append((f"{name}.weight", (k, k, cin, cout), "kernel"))

    def dense(name, n_in, n_out, bias=True):
        out.append((f"{name}.weight", (n_in, n_out), "kernel"))
        if bias:
            out.append((f"{name}.bias", (n_out,), "bias"))

    def norm(name, n):
        out.extend([(f"{name}.weight", (n,), "scale"),
                    (f"{name}.bias", (n,), "bias"),
                    (f"{name}.running_mean", (n,), "mean"),
                    (f"{name}.running_var", (n,), "var")])

    conv("input_conv", 3, cfg["input_planes"], C)
    for b in range(cfg["nbt_blocks"]):
        pre = f"blocks.{b}"
        norm(f"{pre}.norm_pre", C)
        conv(f"{pre}.conv_down", 1, C, M)
        for i in range(cfg["nbt_inner"]):
            name = f"{pre}.inner.{i}"
            gp = G if i == 0 and is_gpool_block(b) else 0
            norm(f"{name}.norm1", M)
            conv(f"{name}.conv1", 3, M, M - gp)
            if gp:
                conv(f"{name}.convg", 3, M, gp)
                norm(f"{name}.normg", gp)
                dense(f"{name}.gpool_fc", 3 * gp, M - gp, bias=False)
            norm(f"{name}.norm2", M - gp)
            conv(f"{name}.conv2", 3, M - gp, M)
        norm(f"{pre}.norm_post", M)
        conv(f"{pre}.conv_up", 1, M, C)
    norm("norm_final", C)
    conv("policy_conv", 1, C, H)
    conv("policy_gconv", 1, C, H)
    norm("policy_gnorm", H)
    dense("policy_gpool_fc", 3 * H, H, bias=False)
    norm("policy_norm", H)
    conv("policy_out", 1, H, 3)
    conv("value_conv", 1, C, H)
    norm("value_norm", H)
    dense("value_fc1", 3 * H, V)
    dense("value_fc2", V, 2)
    return out


def count_params(cfg: dict) -> int:
    """Trained parameters (the norms' statistics are not)."""
    return sum(int(np.prod(s)) for k, s, _ in leaf_shapes(cfg)
               if not k.endswith(("running_mean", "running_var")))


def calibration_planes(n: int, seed: int) -> np.ndarray:
    """(n, 3, 8, 8) planes of positions drawn from ``seed``: lane i plays
    random legal moves from the initial position for a ply count drawn in
    [0, CALIBRATION_PLIES), stopping before a move that ends its game."""
    rng = np.random.default_rng((seed, 2))
    plies = rng.integers(0, CALIBRATION_PLIES, n)
    board, turn = refenv.initial(n)
    for ply in range(CALIBRATION_PLIES):
        live = np.flatnonzero(plies > ply)
        if not len(live):
            break
        legal = refenv.legal_mask(board[live], turn[live])
        pick = np.where(legal, rng.random(legal.shape), -1.0).argmax(1)
        b, t, w = refenv.step(board[live], turn[live], pick)
        go = w == 0
        board[live[go]], turn[live[go]] = b[go], t[go]
        plies[live[~go]] = ply
    return refenv.planes(board, turn)


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
        if k.endswith(BRANCH_ENDS):
            t = t * cfg["nbt_blocks"] ** -0.5
        out[k] = t.contiguous()
    planes = torch.from_numpy(calibration_planes(
        int(cfg["weights"]["calibrated_positions"]), seed))
    refnbt.calibrate(out, planes.to(device))
    return out


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one evaluated board (a multiply-add counts two):
    every convolution and dense layer, a pooling block's at its published
    widths (R and G outputs, an R-channel input to its second conv). Not
    counted: the norms, activations, pools and residual adds."""
    C, M, G = cfg["nbt_trunk"], cfg["nbt_mid"], cfg["nbt_gpool"]
    H, V, A = cfg["nbt_head"], cfg["nbt_value_hidden"], cfg["input_planes"]
    conv3 = lambda cin, cout: 2 * T * 9 * cin * cout
    total = conv3(A, C)
    for b in range(cfg["nbt_blocks"]):
        total += 2 * (2 * T * C * M)                    # 1x1 down and up
        for i in range(cfg["nbt_inner"]):
            if i == 0 and is_gpool_block(b):
                total += (conv3(M, M - G) + conv3(M, G) + conv3(M - G, M)
                          + 2 * 3 * G * (M - G))
            else:
                total += 2 * conv3(M, M)
    return (total + 2 * (2 * T * C * H) + 2 * 3 * H * H + 2 * T * H * 3
            + 2 * T * C * H + 2 * 3 * H * V + 2 * V * 2)


def evaluator_numbers(w: Dict[str, torch.Tensor],
                      judged: List[treecheck.Judged], dev: torch.device,
                      control: bool = False) -> Dict[str, float]:
    """``checks.evaluator_numbers`` for the nested-bottleneck body: the
    judged trees' priors and values against the reference's in float32,
    in blocks of 256 positions; with ``control`` the reference in float8
    in the program's place."""
    if not judged or not sum(len(j.prior) for j in judged):
        return {"policy_tv_mean": float("inf"),
                "value_err_mean": float("inf"), "positions": 0}
    planes = torch.from_numpy(np.concatenate([j.planes for j in judged]))
    legal = torch.from_numpy(np.concatenate([j.legal for j in judged]))
    planes, legal = planes.to(dev), legal.to(dev)
    prior, value = refnbt.evaluate(w, planes, legal)
    if control:
        p8, v8 = refnbt.evaluate(w, planes, legal, fp8=True)
        has_v = np.concatenate([~np.isnan(j.value) for j in judged])
        judged = [treecheck.Judged(
            planes=None, legal=None, prior=p8.cpu().numpy(),
            value=np.where(has_v, v8.cpu().numpy(), np.nan))]
    return treecheck.compare(judged, prior.cpu().numpy().astype(np.float64),
                             value.cpu().numpy().astype(np.float64))
