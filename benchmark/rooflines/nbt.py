"""The nested-bottleneck body's kernels, launch by launch of one forward
of B boards, at the configuration's published widths (C trunk, M mid, G
pooled, R = M - G, H head):

- ``conv3x3_kernel``: every 3x3 conv of the tower, M -> M, and in a
  pooling block M -> R beside M -> G (one M -> M launch) and R -> M (the
  launch takes the R channels zero-padded to M: the padding is not
  counted); each input and output byte once, the bf16 weights once;
- ``gpool_bias_kernel``: the pooling blocks' (R regular, G pooled of an
  M-wide map) and the policy head's (H and H); the pool (2 a pooled value
  for the norm and its sum) and the product (2 x 3G x R a board) as
  operations; the input's R + G channels, the R regular outputs (the
  padding's zeros are not counted), the f32 matrix and norms once;
- ``residual_act_kernel``: each inner block's close (M) and each
  block's close (C), a residual add and the next norm-act; 4 operations
  an element (the add, the affine, the ReLU); y and the residual read
  once, the output and the sum written once, bf16. (The norm-acts
  without a residual are ``bn_act_kernel``'s, which no metric of this
  body reads.)"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.lib.nbt import is_gpool_block

T = 64
BF16, F32 = 2, 4


def _widths(cfg: dict):
    M, G = cfg["nbt_mid"], cfg["nbt_gpool"]
    return cfg["nbt_trunk"], M, G, M - G, cfg["nbt_head"]


def _gpool_blocks(cfg: dict) -> int:
    return sum(is_gpool_block(b)
               for b in range(cfg["nbt_blocks"]))


def conv3x3_sites(cfg: dict) -> List[Tuple[int, int]]:
    """(cin, cout) of each conv3x3 launch of a forward, as published."""
    C, M, G, R, H = _widths(cfg)
    pooled = _gpool_blocks(cfg)
    regular = 2 * cfg["nbt_inner"] * cfg["nbt_blocks"] - 2 * pooled
    return [(M, M)] * (regular + pooled) + [(R, M)] * pooled


def conv3x3_ops(B: int, cin: int, cout: int) -> int:
    return 2 * B * T * 9 * cin * cout


def conv3x3_bytes(B: int, cin: int, cout: int) -> int:
    return B * T * (cin + cout) * BF16 + 9 * cin * cout * BF16 + 3 * cout * F32


def gpool_sites(cfg: dict) -> List[Tuple[int, int]]:
    """(regular, pooled) of each gpool_bias launch of a forward."""
    C, M, G, R, H = _widths(cfg)
    return [(R, G)] * _gpool_blocks(cfg) + [(H, H)]


def gpool_ops(B: int, regular: int, pooled: int) -> int:
    return B * (4 * T * pooled + 2 * 3 * pooled * regular + 4 * T * regular)


def gpool_bytes(B: int, regular: int, pooled: int) -> int:
    return (B * T * (2 * regular + pooled) * BF16
            + (3 * pooled * regular + 3 * (pooled + regular)) * F32)


def residual_sites(cfg: dict) -> List[Tuple[int]]:
    """(channels,) of each residual_act launch of a forward."""
    C, M, G, R, H = _widths(cfg)
    return ([(M,)] * cfg["nbt_inner"] + [(C,)]) * cfg["nbt_blocks"]


def residual_ops(B: int, channels: int) -> int:
    return B * T * channels * 4


def residual_bytes(B: int, channels: int) -> int:
    return B * T * channels * BF16 * 4 + 3 * channels * F32
