"""The encoder body's DeepNorm residual and LayerNorm as one kernel.

``deepnorm_ln`` computes ``LayerNorm(o + alpha x)`` over the last axis of
the (rows, E) token rows, with LayerNorm's ``gamma``, ``beta`` and
``eps``: the close of both halves of every encoder layer
(``models/encoder.py``). On a CUDA tensor it is one launch of
``deepnorm_ln_kernel`` (``csrc/encoder_kernels.cu``), which reads ``o``
and ``x`` once, keeps the row in registers and writes the normed row once,
in bfloat16 at BT4's width (E 1024) alone; on a CPU tensor it runs
``deepnorm_ln_plain``, the ``torch.add`` and ``F.layer_norm`` pair, in any
float dtype. The wrapper counts its launches in ``deepnorm_ln.launches``.

How far the kernel may be from its plain version: both round the sum once
to bf16 and the normed row once, and take the mean, the variance and the
affine in float32 on the rounded sum, so they differ by the order of the
row's sums and the last bits of ``rsqrt``: an output may round to the
neighbouring bf16 value, and where ``gamma (s - mean) rstd`` and ``beta``
cancel, by some float32 steps of those terms. ``card_check`` holds the
kernel to that on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import F32, I, LL, P
from alphazero_torch.models.encoder import LN_EPS

LIB = cuda_build.Library("encoder_kernels",
                         deepnorm_ln_bf16=[P] * 5 + [LL, I, F32, F32, P])
KERNEL_WIDTH = 1024                  # BT4's embedding width
# the share of deepnorm_ln's outputs that may differ from its plain version
# on the card (``card_check``): 5e-6 to 1.7e-5 measured at 1 to 512 boards
# on random operands and on a seeded BT4 layer's
UNEQUAL_SHARE = 1e-4


def deepnorm_ln_plain(o: torch.Tensor, x: torch.Tensor, alpha: float,
                      gamma: torch.Tensor, beta: torch.Tensor,
                      eps: float = LN_EPS) -> torch.Tensor:
    """What ``deepnorm_ln`` computes: ``F.layer_norm(o + alpha x)`` over
    the last axis, the sum rounded to the operands' dtype first, as
    ``torch.add`` rounds it."""
    return F.layer_norm(torch.add(o, x, alpha=alpha), (o.shape[-1],), gamma,
                        beta, eps)


def check_shapes(o: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> None:
    """Raises unless ``o`` and ``x`` are (rows, E) alike and ``gamma`` and
    ``beta`` (E,)."""
    if o.dim() != 2 or tuple(x.shape) != tuple(o.shape):
        raise ValueError(f"o and x must be (rows, E) alike, got "
                         f"{tuple(o.shape)} and {tuple(x.shape)}")
    E = o.shape[1]
    if tuple(gamma.shape) != (E,) or tuple(beta.shape) != (E,):
        raise ValueError(f"gamma {tuple(gamma.shape)} and beta "
                         f"{tuple(beta.shape)} do not fit width {E}")


def check_kernel_operands(o: torch.Tensor, x: torch.Tensor,
                          gamma: torch.Tensor, beta: torch.Tensor) -> None:
    """Raises on what the kernel does not take: a width other than
    ``KERNEL_WIDTH``, operands on other devices, a dtype other than
    bfloat16, or a tensor that is not contiguous and 16-byte aligned."""
    check_shapes(o, x, gamma, beta)
    if o.shape[1] != KERNEL_WIDTH:
        raise ValueError(f"the kernel takes width {KERNEL_WIDTH}, got "
                         f"{o.shape[1]}")
    for name, t in (("o", o), ("x", x), ("gamma", gamma), ("beta", beta)):
        cuda_build.check_operand(name, t, o.device, torch.bfloat16)


@cuda_build.counted
def deepnorm_ln(o: torch.Tensor, x: torch.Tensor, alpha: float,
                gamma: torch.Tensor, beta: torch.Tensor,
                eps: float = LN_EPS) -> torch.Tensor:
    """``LayerNorm(o + alpha x)`` of (rows, E) rows, as
    ``deepnorm_ln_plain`` computes it; a new (rows, E) tensor. On a CUDA
    tensor one launch of ``deepnorm_ln_kernel`` (bfloat16, contiguous, E
    1024); on a CPU tensor the plain version."""
    if o.device.type == "cpu":
        check_shapes(o, x, gamma, beta)
        return deepnorm_ln_plain(o, x, alpha, gamma, beta, eps)
    check_kernel_operands(o, x, gamma, beta)
    dev = o.device
    cuda_build.check_device(dev)
    out = torch.empty_like(o)
    cuda_build.launch(
        deepnorm_ln, LIB.deepnorm_ln_bf16, o.data_ptr(), x.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), o.shape[0],
        o.shape[1], alpha, eps, torch.cuda.current_stream(dev).cuda_stream)
    return out


def card_check(o: torch.Tensor, x: torch.Tensor, alpha: float,
               gamma: torch.Tensor, beta: torch.Tensor, got: torch.Tensor,
               eps: float = LN_EPS) -> dict:
    """What the card holds ``deepnorm_ln``'s output ``got`` to, against
    ``deepnorm_ln_plain`` on the same bf16 operands: at most a share
    ``UNEQUAL_SHARE`` of the outputs unequal, and each within two bf16
    steps of the larger of the two, plus 2^-16 of ``|gamma| rstd (|s -
    mean| + mean |s|)``: the error of a float32 mean and rstd taken in
    another order (some 2^-19 of the row's mean |s| and of rstd, here with
    room), which shows where the affine's terms cancel. Returns ``far``
    (outputs past that), ``unequal_share``, ``max_abs_err`` and ``ok``."""
    want = deepnorm_ln_plain(o, x, alpha, gamma, beta, eps)
    s = torch.add(o, x, alpha=alpha).double()
    mean = s.mean(-1, keepdim=True)
    rstd = torch.rsqrt(s.var(-1, unbiased=False, keepdim=True) + eps)
    terms = (gamma.double().abs() * rstd
             * ((s - mean).abs() + s.abs().mean(-1, keepdim=True)))
    g, w = got.double(), want.double()
    m = torch.maximum(g.abs(), w.abs())
    step = 2.0 ** (torch.floor(torch.log2(m.clamp_min(2 ** -60))) - 7)
    d = (g - w).abs()
    far = int((d > 2 * step + 2 ** -16 * terms).sum())
    unequal = float((got != want).double().mean())
    return {"far": far, "unequal_share": unequal,
            "max_abs_err": float(d.max()),
            "ok": far == 0 and unequal <= UNEQUAL_SHARE}
