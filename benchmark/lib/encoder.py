"""The encoder body's configuration in the harness: its weights drawn from
the seed, its model FLOPs a board, and the check of a search's priors and
values against the reference (``refencoder``). Imports nothing of the
program.

The weights are named and laid out as the program's
``EncoderNet.state_dict()`` (dense weights (out, in)), which the reference
reads too. They are drawn on the device by ``weights.seeded`` (a few large
draws from one generator): every dense matrix N(0, 1/fan_in), biases and
the input gates' shifts N(0, 0.05^2), LayerNorm scales and the gates'
multipliers uniform in [0.8, 1.2].
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import refencoder, treecheck, weights

T = 64
VALUE_EMBED, VALUE_HIDDEN = 32, 128


def leaf_shapes(cfg: dict) -> weights.Shapes:
    """(name, shape, kind) of every parameter, dense weights given as
    (in, out) for the draw (``seeded`` transposes them)."""
    E, H, F = cfg["enc_embed"], cfg["enc_heads"], cfg["enc_ffn"]
    C, Hd, G = (cfg["smolgen_compress"], cfg["smolgen_hidden"],
                cfg["smolgen_gen"])
    P, A = cfg["enc_policy_embed"], cfg["input_planes"]
    out: weights.Shapes = []

    def dense(name, n_in, n_out, bias=True):
        out.append((f"{name}.weight", (n_in, n_out), "kernel"))
        if bias:
            out.append((f"{name}.bias", (n_out,), "bias"))

    def ln(name, n):
        out.extend([(f"{name}.weight", (n,), "scale"),
                    (f"{name}.bias", (n,), "bias")])

    dense("embed", A + T, E)
    out.extend([("gate_mult", (T, E), "scale"), ("gate_add", (T, E), "bias")])
    for i in range(cfg["enc_layers"]):
        pre = f"layers.{i}"
        for n in "qkvo":
            dense(f"{pre}.{n}", E, E)
        ln(f"{pre}.ln1", E)
        dense(f"{pre}.ffn1", E, F)
        dense(f"{pre}.ffn2", F, E)
        ln(f"{pre}.ln2", E)
        dense(f"{pre}.sg_compress", E, C, bias=False)
        dense(f"{pre}.sg_dense1", T * C, Hd)
        ln(f"{pre}.sg_ln1", Hd)
        dense(f"{pre}.sg_dense2", Hd, H * G)
        ln(f"{pre}.sg_ln2", H * G)
    dense("smolgen_gen", G, T * T, bias=False)
    dense("policy_embed", E, P)
    dense("policy_q", P, P)
    dense("policy_k", P, P)
    dense("value_embed", E, VALUE_EMBED)
    dense("value_fc1", T * VALUE_EMBED, VALUE_HIDDEN)
    dense("value_fc2", VALUE_HIDDEN, 2)
    return out


def count_params(cfg: dict) -> int:
    return sum(int(np.prod(s)) for _, s, _ in leaf_shapes(cfg))


def seeded(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights drawn on ``device`` from ``seed``, by name."""
    shapes = leaf_shapes(cfg)
    drawn = weights.seeded(shapes, seed, device)
    return {k: (drawn[k].T.contiguous() if kind == "kernel" else drawn[k])
            for k, _, kind in shapes}


def forward_flops(cfg: dict) -> int:
    """Model FLOPs of one evaluated board (a multiply-add counts two):
    every dense layer, Q K^T and the softmax's product with V, smolgen's
    four products and the policy's q k^T. Not counted: LayerNorm, the
    activations, the softmax, the input gates and the residual adds."""
    E, H, F, N = (cfg["enc_embed"], cfg["enc_heads"], cfg["enc_ffn"],
                  cfg["enc_layers"])
    C, Hd, G = (cfg["smolgen_compress"], cfg["smolgen_hidden"],
                cfg["smolgen_gen"])
    P, A = cfg["enc_policy_embed"], cfg["input_planes"]
    layer = (2 * T * E * 3 * E                   # Q, K, V
             + 2 * T * E * E                     # O
             + 2 * 2 * T * E * F                 # the feed-forward pair
             + 2 * 2 * T * T * E                 # Q K^T and P V, all heads
             + 2 * T * E * C                     # smolgen: compress
             + 2 * T * C * Hd + 2 * Hd * H * G   # its two dense layers
             + 2 * H * G * T * T)                # and the generator
    return (2 * T * (A + T) * E                  # input stage
            + N * layer
            + 2 * T * E * P + 2 * 2 * T * P * P  # policy embedding, q, k
            + 2 * T * T * P                      # q k^T
            + 2 * T * E * VALUE_EMBED
            + 2 * T * VALUE_EMBED * VALUE_HIDDEN + 2 * VALUE_HIDDEN * 2)


def evaluator_numbers(w: Dict[str, torch.Tensor],
                      judged: List[treecheck.Judged], heads: int,
                      dev: torch.device, control: bool = False
                      ) -> Dict[str, float]:
    """``checks.evaluator_numbers`` for the encoder: the judged trees'
    priors and values against the reference's in float32; with
    ``control`` the reference in float8 in the program's place."""
    if not judged or not sum(len(j.prior) for j in judged):
        return {"policy_tv_mean": float("inf"),
                "value_err_mean": float("inf"), "positions": 0}
    planes = torch.from_numpy(np.concatenate([j.planes for j in judged]))
    legal = torch.from_numpy(np.concatenate([j.legal for j in judged]))
    planes, legal = planes.to(dev), legal.to(dev)
    prior, value = refencoder.evaluate(w, planes, legal, heads)
    if control:
        p8, v8 = refencoder.evaluate(w, planes, legal, heads, fp8=True)
        has_v = np.concatenate([~np.isnan(j.value) for j in judged])
        judged = [treecheck.Judged(
            planes=None, legal=None, prior=p8.cpu().numpy(),
            value=np.where(has_v, v8.cpu().numpy(), np.nan))]
    return treecheck.compare(judged, prior.cpu().numpy().astype(np.float64),
                             value.cpu().numpy().astype(np.float64))
