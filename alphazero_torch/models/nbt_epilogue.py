"""The nested-bottleneck body's residual adds, norms and global pooling.

Two hand kernels (``csrc/nbt_kernels.cu``) do all the elementwise work of
the bf16 evaluator's tower (``models/nbt_inference.py``) between its
convolutions, on bf16 (rows, C) maps, a row a square of a board:

- ``residual_act(y, bn, residual)``: ``s = residual + y`` (rounded to
  bf16 once) and its norm-act ``relu(((s - mean) * mul) + beta)``, the
  BatchNorm's float32 (mean, mul, beta) as ``epilogue.bn_act`` takes it:
  the close of every inner and outer block of the pre-activation tower.
  The norm-acts without a residual (after the input conv, the 1x1 convs
  down and the value head's conv) are ``epilogue.bn_act``'s.
- ``gpool_bias(y, bn_g, w, bn, regular, cout)``: KataGo's global-pooling
  bias. Of a (B, 64, cin) map whose first ``regular`` channels are r and
  next G are g: ``g = relu(N_g(g))``, ``pool = [mean(g), -0.6 mean(g),
  max(g)]`` over the 64 squares, ``out = relu(N(r + pool @ w))``, zeros
  from ``regular`` to ``cout``: the first inner block of every pooling
  block (the zeros pad R to the next conv's width) and the policy head.

On a CUDA tensor each is one launch (``<wrapper>.launches`` counts them);
on a CPU tensor each runs its plain version, ``residual_act_plain`` and
``gpool_bias_plain``, in any float dtype.

How far the kernels may be from their plain versions: ``residual_act``
not at all (both round where the plain version rounds, the affine without
FMA). ``gpool_bias`` sums the pool and the product in float32 in its own
order, so an output may round to the neighbouring bf16 value, or, where
``r + bias`` and the norm's terms cancel, differ by some float32 steps of
those terms; ``gpool_card_check`` holds the kernel to that on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import I, LL, P
from alphazero_torch.models.epilogue import BN, bn_act_plain, check_bn
from alphazero_torch.models.nbt import SQUARES, board_pool

LIB = cuda_build.Library("nbt_kernels",
                         residual_act_bf16=[P] * 7 + [LL, I, P],
                         gpool_bias_bf16=[P] * 9 + [I] * 5 + [P])
# what gpool_bias's kernel takes (nbt_kernels.cu: kMaxPooled, kMaxRegular)
MAX_POOLED, MAX_REGULAR = 128, 256
# the share of gpool_bias's outputs that may differ from its plain version
# on the card, each by the rounding of a float32 sum taken in another order
GPOOL_UNEQUAL_SHARE = 1e-3


def residual_act_plain(y: torch.Tensor, bn: BN, residual: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``residual_act`` computes: ``(s, relu(bn(s)))`` with ``s =
    residual + y`` in float32 rounded to ``y``'s dtype once; the norm-act
    is ``epilogue.bn_act_plain``'s."""
    s = (residual.float() + y.float()).to(y.dtype)
    return s, bn_act_plain(s, bn, relu=True)


def gpool_bias_plain(y: torch.Tensor, bn_g: BN, w: torch.Tensor, bn: BN,
                     regular: int, cout: int) -> torch.Tensor:
    """What ``gpool_bias`` computes on the (B, 64, cin) map ``y``: its
    channels ``regular`` to ``regular + G`` normed, ReLU'd and pooled in
    float32 (not rounded), the pool's product with ``w`` (3G, regular)
    added to the first ``regular`` channels in float32, their norm-act
    rounded to ``y``'s dtype once, then zeros up to ``cout`` channels."""
    G = w.shape[0] // 3
    mean, mul, beta = bn_g
    g = torch.relu((y[..., regular:regular + G].float() - mean) * mul
                   + beta)
    bias = board_pool(g.transpose(1, 2)[..., None]) @ w.float()
    mean, mul, beta = bn
    v = torch.relu((y[..., :regular].float() + bias[:, None, :] - mean)
                   * mul + beta).to(y.dtype)
    if cout == regular:
        return v
    return torch.cat([v, v.new_zeros(v.shape[:-1] + (cout - regular,))], -1)


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or t.shape[1] % 8:
        raise ValueError(f"{name} must be (rows, C) with C a multiple of "
                         f"8, got {tuple(t.shape)}")


@cuda_build.counted
def residual_act(y: torch.Tensor, bn: BN, residual: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, relu(bn(s)))`` of the (rows, C) map ``y`` with ``s = residual
    + y``, as ``residual_act_plain`` computes them; new tensors. On a CUDA
    tensor one launch of ``residual_act_kernel`` (bfloat16, contiguous, C
    a multiple of 8); on a CPU tensor the plain version."""
    _check_rows("y", y)
    if residual.shape != y.shape:
        raise ValueError(f"residual {tuple(residual.shape)} and y "
                         f"{tuple(y.shape)} differ")
    if y.device.type == "cpu":
        return residual_act_plain(y, bn, residual)
    dev = y.device
    cuda_build.check_operand("y", y, dev, torch.bfloat16)
    cuda_build.check_operand("residual", residual, dev, torch.bfloat16)
    check_bn(bn, y.shape[1], dev)
    cuda_build.check_device(dev)
    out, s = torch.empty_like(y), torch.empty_like(y)
    cuda_build.launch(
        residual_act, LIB.residual_act_bf16, y.data_ptr(), residual.data_ptr(),
        *(t.data_ptr() for t in bn), s.data_ptr(), out.data_ptr(),
        y.shape[0], y.shape[1], torch.cuda.current_stream(dev).cuda_stream)
    return s, out


@cuda_build.counted
def gpool_bias(y: torch.Tensor, bn_g: BN, w: torch.Tensor, bn: BN,
               regular: int, cout: int) -> torch.Tensor:
    """KataGo's global-pooling bias of the (B, 64, cin) map ``y``, as
    ``gpool_bias_plain`` computes it; a new (B, 64, cout) map. ``w`` is
    the float32 (3G, regular) matrix, ``bn_g`` the pooled channels' norm
    and ``bn`` the regular ones'. On a CUDA tensor one launch of
    ``gpool_bias_kernel`` (bfloat16 maps; widths multiples of 8, G up to
    ``MAX_POOLED``, regular up to ``MAX_REGULAR``); on a CPU tensor the
    plain version."""
    if y.dim() != 3 or y.shape[1] != SQUARES:
        raise ValueError(f"y must be (B, {SQUARES}, cin), got "
                         f"{tuple(y.shape)}")
    G = w.shape[0] // 3
    if tuple(w.shape) != (3 * G, regular) or regular + G > y.shape[2] \
            or cout < regular:
        raise ValueError(f"w {tuple(w.shape)}, regular {regular} and cout "
                         f"{cout} do not fit a map of {y.shape[2]} "
                         "channels")
    if y.device.type == "cpu":
        return gpool_bias_plain(y, bn_g, w, bn, regular, cout)
    dev = y.device
    B, _, cin = y.shape
    if (G > MAX_POOLED or regular > MAX_REGULAR or regular % 8 or cin % 8
            or cout % 8):
        raise ValueError(f"the kernel takes widths that are multiples of 8, "
                         f"G up to {MAX_POOLED} and regular up to "
                         f"{MAX_REGULAR}; got regular {regular}, G {G}, cin "
                         f"{cin}, cout {cout}")
    cuda_build.check_operand("y", y, dev, torch.bfloat16)
    cuda_build.check_operand("w", w, dev, torch.float32, aligned=False)
    check_bn(bn_g, G, dev)
    check_bn(bn, regular, dev)
    cuda_build.check_device(dev)
    out = torch.empty((B, SQUARES, cout), dtype=y.dtype, device=dev)
    cuda_build.launch(
        gpool_bias, LIB.gpool_bias_bf16, y.data_ptr(),
        *(t.data_ptr() for t in bn_g), w.data_ptr(),
        *(t.data_ptr() for t in bn), out.data_ptr(), B, regular, G, cin,
        cout, torch.cuda.current_stream(dev).cuda_stream)
    return out


def gpool_card_check(y: torch.Tensor, bn_g: BN, w: torch.Tensor, bn: BN,
                     regular: int, cout: int, got: torch.Tensor) -> dict:
    """What the card holds ``gpool_bias``'s output ``got`` to, against
    ``gpool_bias_plain`` on the same operands: at most a share
    ``GPOOL_UNEQUAL_SHARE`` of the outputs unequal, the padding exactly 0,
    and each output within one bf16 step of the larger of the two plus
    2^-18 of ``|mul| (|y| + |bias terms| + |mean|)``: float32 sums of the
    pool (64 terms) and of the product (3G terms) in another order, some
    2^-20 of the magnitudes summed, with room. Returns ``far``,
    ``unequal_share``, ``max_abs_err`` and ``ok``."""
    want = gpool_bias_plain(y, bn_g, w, bn, regular, cout)
    G = w.shape[0] // 3
    mean, mul, beta = (t.double() for t in bn_g)
    g = torch.relu((y[..., regular:regular + G].double() - mean) * mul
                   + beta)
    pool = torch.cat([g.mean(1), 0.6 * g.mean(1), g.amax(1)], 1)
    terms = pool @ w.double().abs()                        # (B, regular)
    mean, mul, _ = (t.double() for t in bn)
    mag = mul.abs() * (y[..., :regular].double().abs() + terms[:, None, :]
                       + mean.abs())
    gv, wv = got[..., :regular].double(), want[..., :regular].double()
    m = torch.maximum(gv.abs(), wv.abs())
    step = 2.0 ** (torch.floor(torch.log2(m.clamp_min(2 ** -60))) - 7)
    d = (gv - wv).abs()
    far = int((d > step + 2 ** -18 * mag).sum())
    pad = int((got[..., regular:] != 0).sum())
    unequal = float((got != want).double().mean())
    return {"far": far + pad, "unequal_share": unequal,
            "max_abs_err": float(d.max()),
            "ok": far + pad == 0 and unequal <= GPOOL_UNEQUAL_SHARE}
