"""MuZero's kernels, launch by launch of one self-play move of B lanes, at
the configuration's published widths (C filters, blocks a tower):

- ``conv3x3_kernel``: every 3x3 conv of both towers and of the policy
  head. The root's representation: h's input conv at its published shape,
  3 -> C (the launch runs it on planes zero-padded to C: the padding is
  not counted), its 2 x blocks tower convs and f's policy conv. Each
  simulation's dynamics and prediction: g's input conv folded to C -> C
  (the action planes' term is ``action_term_kernel``'s, counted there),
  its 2 x blocks tower convs and f's policy conv. Each input and output
  byte once, the bf16 weights once, the epilogue's f32 norm once;
- ``action_term_kernel``: g's input conv finished, a simulation's one
  launch: the conv's bf16 output read and the activated map written once,
  the f32 tables (2 x 9 x C taps, 64 x C ones) and norm once; 6
  operations an element (three table terms, the add, the affine, the
  ReLU);
- ``residual_act_kernel``: each block's close, h's blocks at the root
  and g's each simulation: the residual add and the ReLU (the norm the
  identity), counted as ``rooflines/nbt.py`` counts the kernel: 4
  operations an element, the conv's output and the residual read once,
  the sum and the activated map written once, bf16, the f32 norm once;
- ``latent_scale_kernel``: MuZero's scale, one a simulation and one a
  search at the root, reading a state once and writing it twice (the next
  net's input and the latent store's slot), bf16; 4 operations an
  element (the min, the max, the subtract, the divide)."""

from __future__ import annotations

from typing import List, Tuple

from benchmark.rooflines import nbt

T = 64
BF16, F32 = 2, 4


def conv3x3_sites(cfg: dict, sims: int) -> List[Tuple[int, int]]:
    """(cin, cout) of each conv3x3 launch of one move of ``sims``
    simulations, as published."""
    C, B = cfg["mz_filters"], cfg["mz_blocks"]
    root = [(cfg["input_planes"], C)] + [(C, C)] * (2 * B + 1)
    return root + [(C, C)] * ((2 * B + 2) * sims)


def conv3x3_ops(B: int, cin: int, cout: int) -> int:
    return 2 * B * T * 9 * cin * cout


def conv3x3_bytes(B: int, cin: int, cout: int) -> int:
    return B * T * (cin + cout) * BF16 + 9 * cin * cout * BF16 + 3 * cout * F32


def residual_sites(cfg: dict, sims: int) -> List[Tuple[int]]:
    """(channels,) of each residual_act launch of one move of ``sims``
    simulations."""
    return [(cfg["mz_filters"],)] * (cfg["mz_blocks"] * (sims + 1))


# the kernel's operations and bytes a launch, as the nbt body's
residual_ops, residual_bytes = nbt.residual_ops, nbt.residual_bytes


def action_term_ops(B: int, C: int) -> int:
    return 6 * B * T * C


def action_term_bytes(B: int, C: int) -> int:
    return 2 * B * T * C * BF16 + (18 + T + 3) * C * F32 + B * 4


def latent_scale_ops(B: int, C: int) -> int:
    return 4 * B * T * C


def latent_scale_bytes(B: int, C: int) -> int:
    return 3 * B * T * C * BF16
