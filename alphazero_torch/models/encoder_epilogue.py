"""The encoder body's DeepNorm residual and LayerNorm as one kernel, and
its feed-forward's first product with the bias and Mish as another.

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

``dense_mish`` computes ``mish(x W + b)`` for (rows, K) token rows and a
(K, N) matrix: the feed-forward's first product (K 1024, N 1536) and the
policy embedding (1024, 1024) of BT4. On a CUDA tensor it is one launch
of ``dense_mish_kernel`` (``csrc/encoder_kernels.cu``): bf16 operands,
float32 sums on ``wgmma``, the bias and Mish taken on the float32 sum and
the result rounded to bf16 once, W read from ``dense_image``'s packed
form (which ``encoder_inference.prepare`` makes once on a card), K a
multiple of 64 and N of 256; on a CPU tensor it runs ``dense_mish_plain``
in any float dtype. It counts its launches in ``dense_mish.launches``.
How far the kernel may be from its plain version: the same products
summed in another order, Mish from the special function unit's ``exp2``
and a fast reciprocal, one rounding: an output may round to the
neighbouring bf16 value, and where the sum cancels, differ by some float32
steps of the sum of |x W| (``dense_card_check``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import F32, I, LL, P
from alphazero_torch.models.encoder import LN_EPS

LIB = cuda_build.Library("encoder_kernels", init="dense_mish_init",
                         deepnorm_ln_bf16=[P] * 5 + [LL, I, F32, F32, P],
                         dense_mish_bf16=[P] * 4 + [LL, I, I, I, P])
KERNEL_WIDTH = 1024                  # BT4's embedding width
# the share of deepnorm_ln's outputs that may differ from its plain version
# on the card (``card_check``): 5e-6 to 1.7e-5 measured at 1 to 512 boards
# on random operands and on a seeded BT4 layer's
UNEQUAL_SHARE = 1e-4
# a tile of dense_image: the output columns of one tile of dense_mish by
# one 128-byte row of k
TILE_N, TILE_K = 256, 64
# the share of dense_mish's outputs that may differ from its plain version
# on the card (``dense_card_check``): a float32 sum a few steps off, or
# Mish a few ulps off, flips the bf16 rounding of 3.1e-4 to 7.5e-4 of them,
# measured at 1 to 512 boards on random operands and on a seeded BT4
# layer's; a wrong tile or row reads near 1
DENSE_UNEQUAL_SHARE = 3e-3


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


def dense_image(w: torch.Tensor) -> torch.Tensor:
    """The (K, N) matrix ``w`` as ``dense_mish_kernel`` streams it: tiles
    of ``TILE_N`` output columns by ``TILE_K`` k, tile (n, k) the ``[n,
    k]`` entry of a (N / 256, K / 64, 256, 64) tensor, each tile's rows a
    column's 64 k (128 bytes in bf16) with the 128-byte swizzle."""
    K, N = w.shape
    t = w.T.reshape(N // TILE_N, TILE_N, K // TILE_K, 8, 8)
    t = t.transpose(1, 2)                 # (tile n, tile k, row, piece, 8)
    # piece j of row r goes to piece j ^ (r % 8)
    r = torch.arange(TILE_N, device=w.device)
    src = torch.arange(8, device=w.device)[None, :] ^ (r[:, None] % 8)
    t = t.gather(-2, src[..., None].expand(t.shape))
    return t.reshape(N // TILE_N, K // TILE_K, TILE_N, TILE_K).contiguous()


def dense_mish_plain(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """What ``dense_mish`` computes: ``F.mish(x w + b)`` in float32 on the
    operands' values, rounded to ``x``'s dtype once."""
    return F.mish(torch.addmm(b.float(), x.float(), w.float())).to(x.dtype)


def check_dense_shapes(x: torch.Tensor, w: torch.Tensor,
                       b: torch.Tensor) -> None:
    """Raises unless ``x`` is (rows, K), ``w`` (K, N) and ``b`` (N,)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] \
            or tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and b "
                         f"{tuple(b.shape)} do not fit (rows, K) x (K, N) "
                         f"+ (N,)")


def check_dense_kernel_operands(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor,
                                image: torch.Tensor | None) -> None:
    """Raises on what the kernel does not take: K not a multiple of
    ``TILE_K`` or N of ``TILE_N``, operands on other devices, a dtype other
    than bfloat16, a tensor that is not contiguous and 16-byte aligned, or
    an ``image`` (if given) of another shape."""
    check_dense_shapes(x, w, b)
    K, N = w.shape
    if K % TILE_K or N % TILE_N:
        raise ValueError(f"the kernel takes K a multiple of {TILE_K} and N "
                         f"of {TILE_N}, got K {K} and N {N}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        cuda_build.check_operand(name, t, x.device, torch.bfloat16)
    if image is not None:
        cuda_build.check_operand("image", image, x.device, torch.bfloat16,
                                 (N // TILE_N, K // TILE_K, TILE_N, TILE_K))


@cuda_build.counted
def dense_mish(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               image: torch.Tensor | None = None) -> torch.Tensor:
    """``mish(x w + b)`` of (rows, K) rows, as ``dense_mish_plain``
    computes it; a new (rows, N) tensor. On a CUDA tensor one launch of
    ``dense_mish_kernel`` (bfloat16, contiguous, K a multiple of 64, N of
    256), which reads ``w`` from ``image``, ``dense_image(w)`` (packed here
    when not given); on a CPU tensor the plain version."""
    if x.device.type == "cpu":
        check_dense_shapes(x, w, b)
        return dense_mish_plain(x, w, b)
    check_dense_kernel_operands(x, w, b, image)
    if image is None:
        image = dense_image(w)
    dev = x.device
    cuda_build.check_device(dev)
    K, N = w.shape
    out = torch.empty((x.shape[0], N), dtype=x.dtype, device=dev)
    cuda_build.launch(
        dense_mish, LIB.dense_mish_bf16, x.data_ptr(), image.data_ptr(),
        b.data_ptr(), out.data_ptr(), x.shape[0], K, N,
        LIB.multiprocessors(dev), torch.cuda.current_stream(dev).cuda_stream)
    return out


def dense_card_check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     got: torch.Tensor) -> dict:
    """What the card holds ``dense_mish``'s output ``got`` to, against
    ``dense_mish_plain`` on the same bf16 operands (float32 products,
    TF32 off): at most a share ``DENSE_UNEQUAL_SHARE`` of the outputs
    unequal, and each within two bf16 steps of the larger of the two, plus
    2^-16 of ``|x| |w| + |b|``: the error of a float32 sum of K products
    taken in another order (some 2^-19 of that sum of magnitudes, here with
    room), which shows where the sum cancels (Mish's slope is at most
    1.1). Returns ``far`` (outputs past that), ``unequal_share``,
    ``max_abs_err`` and ``ok``."""
    want = dense_mish_plain(x, w, b)
    terms = torch.addmm(b.float().abs(), x.float().abs(), w.float().abs())
    g, h = got.float(), want.float()
    m = torch.maximum(g.abs(), h.abs())
    step = 2.0 ** (torch.floor(torch.log2(m.clamp_min(2 ** -60))) - 7)
    d = (g - h).abs()
    far = int((d > 2 * step + 2 ** -16 * terms).sum())
    unequal = float((got != want).float().mean())
    return {"far": far, "unequal_share": unequal,
            "max_abs_err": float(d.max()),
            "ok": far == 0 and unequal <= DENSE_UNEQUAL_SHARE}
