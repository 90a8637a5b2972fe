"""The bf16 evaluator's 3x3 convolutions, with the BatchNorm as their
epilogue.

The JAX package's bf16 net runs its tower convolutions
(``alphazero_tpu/models/network.py:66-67``, ``:71-72``) and the policy
head's (``:151-152``) as ``nn.Conv`` with ``dtype=bf16``, which XLA
compiles: a 3x3 SAME conv, bf16 in, f32 sums, bf16 out, then
``nn.BatchNorm`` on that bf16 output. Its one TPU kernel on this net, the
fused tower (``alphazero_tpu/models/fused.py:202-213``), computes the same
conv in its body as nine shifted matmuls summed in f32. The port runs it
as one hand-written kernel, ``csrc/conv_kernels.cu``, on NHWC bf16 maps
``(B, 8, 8, C)``, C 32, 128 or 256:

    y   = bf16(conv3x3(x, w))                       f32 sums
    out = y, or bn_act_plain(y, bn, relu)           the epilogue

``conv3x3`` launches it on a CUDA tensor or raises; on a CPU tensor it
runs ``conv3x3_plain``: ``F.conv2d`` on the channels-last operands and
``epilogue.bn_act_plain``, the computation the evaluator made before the
kernel. The kernel reads its weights in an image of its own, which
``weight_image`` packs once (``models/inference.py:prepare_inference``).
Every launch is a programmatic dependent one: the kernel fetches its
weights before the kernel ahead of it on the stream has finished, so the
image must be complete before the launch, as ``weight_image`` makes it.
``conv_launch_shape`` picks its pieces (channels and boards) from the
batch, or at C 256 from some 400 boards a second kernel of the same
products, persistent over groups of four boards with both tiles a block
(``persistent_launch``; ``conv3x3.persistent.launches`` counts its
launches); every launch gives the same bits.

How far the kernel may be from its plain version: with the BatchNorm,
not at all from ``bn_act_plain`` of its own conv (the epilogue rounds the
sum to bf16 first, as Flax does, and runs the affine without FMA). The
conv alone sums in f32 in its own order (k = tap * C + ci, in k-steps of
16), fixed by C, so a board's output does not depend on the batch. On the
card it is held to ``conv3x3_plain(..., f64_sums=True)``: at most
``CONV_UNEQUAL_SHARE`` of the elements unequal, or twice cuDNN's share on
the same operands if that is larger, and every element within one bf16
step (``epilogue.steps_apart``) or, where the terms cancel, within the
float32 sum's own error bound beside that step (``sum_error_bound``;
``card_check``). Float32 sums in any order cannot promise one step where
the terms cancel: on the archived net's sites, sums in the kernel's order
land up to 7 steps from the float64 sums (``conv3x3_kernel_order``,
``scripts/conv_unequal_share.py``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import I, P, align
from alphazero_torch.models import epilogue
from alphazero_torch.models.epilogue import BN

# conv3x3_init opts the kernel in to its shared memory
LIB = cuda_build.Library("conv_kernels", init="conv3x3_init",
                         conv3x3_smem_bytes=[I] * 3,
                         conv3x3_bf16=[P] * 6 + [I] * 6 + [P],
                         conv3x3_persistent_smem_bytes=[],
                         conv3x3_persistent_bf16=[P] * 6 + [I] * 3 + [P])
# what the kernel takes: cin = cout = C
CHANNELS = (32, 128, 256)
# K values (bf16) in a row of the weight image: 128 bytes, one row of the
# card's 128-byte shared-memory swizzle
CHUNK_K = 64
# A block's shared memory after the opt-in (conv_kernels.cu: kSmemOptIn)
_SMEM_OPT_IN = 232_448
# The kernel's launch shapes (conv_kernels.cu: CONV_SHAPES) in the launch
# rule's order: (channels a piece, boards a piece, one a consumer
# warpgroup). The order is measured (scripts/conv_launch_sweep.py on an
# H100): where several shapes fill one wave, the first of them in this
# list was the fastest or within 2% of it.
_WIDE = ((16, 1), (16, 2), (64, 1), (128, 1), (128, 2), (128, 3), (128, 4))
SHAPES = {32: ((32, 1), (32, 2), (32, 3), (32, 4)), 128: _WIDE, 256: _WIDE}
# The share of a conv's elements that may differ from conv3x3_plain(...,
# f64_sums=True) on the card, each by one bf16 step: 1e-4, or what f32
# sums in the kernel's k order give on the archived net's 41 conv sites
# (conv3x3_kernel_order; scripts/conv_unequal_share.py), whichever is
# larger.
CONV_UNEQUAL_SHARE = 1e-4
# The persistent path (conv_kernels.cu: persistent_conv3x3_kernel) takes
# C PERSISTENT_C in groups of four boards a block, a consumer warpgroup
# each, and both tiles of their outputs
PERSISTENT_C = 256
_BOARDS_A_BLOCK = 4
# a consumer warp's scratch on the persistent path, for its epilogue's
# transposition (four warps a warpgroup)
_SCRATCH_BYTES = 512
# the kernel's epilogues, in its numbering: (BatchNorm, ReLU)
EPILOGUES = {"none": (False, False), "affine": (True, False),
             "affine_relu": (True, True)}
_EPI = {v: i for i, v in enumerate(EPILOGUES.values())}


# -----------------------------------------------------------------------------
# Weight image
# -----------------------------------------------------------------------------

def tile_width(C: int) -> int:
    """The kernel's N: output channels of one tile (C 256 is two)."""
    return min(C, 128)


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``w`` (C, C, 3, 3) -> its (C, K) matrix, k = (ky * 3 + kx) * C +
    ci, zero-padded to a multiple of ``CHUNK_K``: the conv as the kernel
    multiplies it."""
    cout, cin = w.shape[:2]
    wk = w.permute(0, 2, 3, 1).reshape(cout, 9 * cin)
    pad = -(9 * cin) % CHUNK_K
    return F.pad(wk, (0, pad)) if pad else wk.contiguous()


def weight_image_kmajor(wk: torch.Tensor, n: int) -> torch.Tensor:
    """``wk`` (cout, K), K a multiple of ``CHUNK_K`` -> the image that a
    kernel copies into shared memory chunk by chunk and its tensor cores
    read by descriptor: (cout / n, K / 64, n, 64), any dtype. A chunk is 64
    K values (128 bytes in bf16) for the ``n`` output channels of a tile,
    stored ``[n][64]`` (K-major) with the card's 128-byte swizzle: the
    8-value piece ``j`` of row ``r`` lies at piece ``j ^ (r % 8)``. So
    element ``[t, c, r, p*8 + e]`` is ``wk[t*n + r, 64c + (p ^ (r % 8))*8 +
    e]``."""
    cout, K = wk.shape
    if K % CHUNK_K or cout % n:
        raise ValueError(f"K {K} must be a multiple of {CHUNK_K} and cout "
                         f"{cout} of {n}")
    w = wk.reshape(cout // n, n, K // CHUNK_K, CHUNK_K // 8, 8)
    w = w.permute(0, 2, 1, 3, 4)                     # [t, c, r, piece, e]
    r = torch.arange(n, device=wk.device)[:, None]
    piece = torch.arange(CHUNK_K // 8, device=wk.device)[None, :]
    w = w[:, :, r, piece ^ (r % 8)]
    return w.reshape(cout // n, K // CHUNK_K, n, CHUNK_K).contiguous()


def weight_image(w: torch.Tensor) -> torch.Tensor:
    """The conv kernel's image of the OIHW weights ``w`` (C, C, 3, 3), C
    one of ``CHANNELS``: (C / N, ceil(9C / 64), N, 64) with N =
    ``tile_width(C)``, in ``w``'s dtype and on its device. On a card it
    returns once the image is complete there: the kernel reads its image
    before it waits for the kernel launched ahead of it."""
    C = w.shape[0]
    if tuple(w.shape) != (C, C, 3, 3) or C not in CHANNELS:
        raise ValueError(f"the conv kernel takes (C, C, 3, 3) weights with "
                         f"C one of {CHANNELS}, got {tuple(w.shape)}")
    image = weight_image_kmajor(kmajor(w), tile_width(C))
    if image.is_cuda:
        torch.cuda.current_stream(image.device).synchronize()
    return image


def image_weights(image: torch.Tensor) -> torch.Tensor:
    """The inverse of ``weight_image``: the OIHW weights of an image."""
    tiles, chunks, n, _ = image.shape
    C = tiles * n
    r = torch.arange(n, device=image.device)[:, None]
    piece = torch.arange(CHUNK_K // 8, device=image.device)[None, :]
    w = torch.empty((tiles, chunks, n, CHUNK_K // 8, 8), dtype=image.dtype,
                    device=image.device)
    w[:, :, r, piece ^ (r % 8)] = image.reshape(tiles, chunks, n,
                                                CHUNK_K // 8, 8)
    wk = w.permute(0, 2, 1, 3, 4).reshape(C, chunks * CHUNK_K)[:, :9 * C]
    return wk.reshape(C, 3, 3, C).permute(0, 3, 1, 2).contiguous()


# -----------------------------------------------------------------------------
# Plain versions
# -----------------------------------------------------------------------------

def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, bn: BN | None = None,
                  relu: bool = False, f64_sums: bool = False
                  ) -> torch.Tensor:
    """What ``conv3x3`` computes: the SAME conv of the NHWC map ``x`` by
    the OIHW ``w`` (channels-last or not), no bias, as ``F.conv2d`` on the
    channels-last operands, in ``x``'s dtype (an NHWC view of the
    channels-last result); then ``bn_act_plain(y, bn, relu)`` with ``bn``.
    With ``f64_sums`` the conv is summed in float64 and rounded through
    float32 to ``x``'s dtype."""
    if relu and bn is None:
        raise ValueError("the ReLU is the BatchNorm's: relu needs bn")
    xc = x.permute(0, 3, 1, 2)
    if f64_sums:
        y = F.conv2d(xc.double(), w.double(), padding=1).float().to(x.dtype)
    else:
        y = F.conv2d(xc, w, padding=1)
    y = y.permute(0, 2, 3, 1)
    return y if bn is None else epilogue.bn_act_plain(y, bn, relu)


def conv3x3_kernel_order(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv's float32 sums in the kernel's order, emulated: the sum of
    each k-step's 16 products (k = tap * C + ci) taken exactly (float64)
    and rounded to float32, then added to the float32 sum k-step by k-step;
    rounded to ``x``'s dtype. (The tensor cores' own rounding inside a
    k-step is not documented; this is the order, not the bits.)"""
    B, C = x.shape[0], x.shape[3]
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, ky:ky + 8, kx:kx + 8, :]
                        for ky in range(3) for kx in range(3)], dim=3)
    cols = cols.reshape(B * 64, 9 * C)                 # k = tap * C + ci
    wk = w.double().permute(0, 2, 3, 1).reshape(w.shape[0], 9 * C).T
    acc = torch.zeros((B * 64, w.shape[0]), dtype=torch.float32)
    for k in range(0, 9 * C, 16):
        acc = acc + (cols[:, k:k + 16] @ wk[k:k + 16]).float()
    return acc.reshape(B, 8, 8, -1).to(x.dtype)


def sum_error_bound(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """How far a float32 sum of the conv's 9C terms may be from the exact
    sum, an element, in any order: ``2 * 9C * 2**-24`` times the sum of
    the terms' magnitudes (the conv of ``|x|`` by ``|w|``, in float64).
    That is the recursive sum's bound, ``(n - 1) u`` of the magnitudes
    (Higham, Accuracy and Stability of Numerical Algorithms, 4.2), with
    the unit roundoff doubled for adders that truncate where they align,
    as tensor cores do. Where the terms cancel it is many bf16 steps of the
    result."""
    C = x.shape[3]
    mag = F.conv2d(x.permute(0, 3, 1, 2).double().abs(), w.double().abs(),
                   padding=1).permute(0, 2, 3, 1)
    return mag * (2 * 9 * C * 2.0 ** -24)


def card_check(x: torch.Tensor, w: torch.Tensor, bn: BN,
               outs: Dict[str, torch.Tensor], limit: float
               ) -> Dict[str, float]:
    """What the card holds ``conv3x3`` to, on one site: ``outs`` are its
    outputs with no epilogue (``"none"``), the affine (``"affine"``) and
    the affine with ReLU (``"affine_relu"``; either may be left out). The
    conv alone against
    ``conv3x3_plain(x, w, f64_sums=True)``: at most a share ``limit`` of
    the elements unequal, and every element within one bf16 step
    (``epilogue.steps_apart``) or, where the terms cancel, within one step
    and ``sum_error_bound`` (``beyond_one_step`` counts those elements);
    each epilogue bit-equal to ``bn_act_plain`` of the ``"none"``
    output. Returns the counts and ``ok``."""
    ref = conv3x3_plain(x, w, f64_sums=True)
    none = outs["none"]
    unequal = int((none != ref).sum())
    steps = epilogue.steps_apart(none, ref)
    beyond = steps > 1.0
    outside = 0
    if bool(beyond.any()):
        d = (none.double() - ref.double()).abs()
        step = d / steps.double().clamp_min(1e-300)
        outside = int(((d > step + sum_error_bound(x, w)) & beyond).sum())
    epi_unequal = sum(
        int((outs[k] != epilogue.bn_act_plain(none, bn, k == "affine_relu"))
            .sum()) for k in ("affine", "affine_relu") if k in outs)
    return {"ok": outside == 0 and unequal <= limit * none.numel()
            and epi_unequal == 0,
            "unequal": unequal, "elements": none.numel(),
            "max_steps": float(steps.max()),
            "beyond_one_step": int(beyond.sum()),
            "outside_bound": outside, "epilogue_unequal": epi_unequal}


# -----------------------------------------------------------------------------
# The kernel's launch
# -----------------------------------------------------------------------------

def conv_stages(C: int, np_: int, per: int) -> int:
    """Stages of the weight ring of ``conv3x3_kernel<C, np_, per>``
    (``conv_kernels.cu:ring_stages``): as many chunks of ``np_`` channels
    as fit beside ``per`` boards' padded rows, the zero row, the BatchNorm
    constants and the mbarriers (16 bytes a stage, 8 for the constants'),
    and no more than the ``ceil(9C / 64)`` chunks of a piece."""
    fixed = per * 64 * (C + 8) * 2 + (C + 8) * 2 + 3 * C * 4 + 8
    fit = (_SMEM_OPT_IN - 1024 - fixed) // (np_ * CHUNK_K * 2 + 16)
    return min(fit, -(-9 * C // CHUNK_K))


def conv_smem_bytes(C: int, np_: int, per: int) -> int:
    """A block's shared memory in ``conv3x3_kernel<C, np_, per>``
    (``conv_kernels.cu:Smem``): the ring, ``per`` boards' padded rows, the
    zero row, the BatchNorm constants and the mbarriers, and 1024 bytes of
    slack to align the ring."""
    stages = conv_stages(C, np_, per)
    size = (stages * (np_ * CHUNK_K * 2 + 16) + per * 64 * (C + 8) * 2
            + (C + 8) * 2 + 3 * C * 4 + 8)
    return align(size, 8) + 1024


def persistent_stages() -> int:
    """Stages of the persistent path's weight ring (``conv_kernels.cu:
    persistent_stages``): as many 16 KB chunks as fit beside four boards'
    unpadded rows (32 KB each), the zero row, the BatchNorm constants, the
    consumer warps' scratch and the mbarriers."""
    return (_SMEM_OPT_IN - 1024 - _persistent_fixed()) // (
        128 * CHUNK_K * 2 + 16)


def _persistent_fixed() -> int:
    """The persistent path's shared memory besides the ring's stages."""
    C = PERSISTENT_C
    return (_BOARDS_A_BLOCK * 64 * C * 2 + C * 2 + 3 * C * 4
            + _BOARDS_A_BLOCK * 4 * _SCRATCH_BYTES + 8)


def persistent_smem_bytes() -> int:
    """A block's shared memory on the persistent path (``conv_kernels.cu:
    PSmem``): the ring, four boards' rows, the zero row, the BatchNorm
    constants, the consumer warps' scratch, the mbarriers and 1024 bytes of
    slack to align the ring."""
    size = (persistent_stages() * (128 * CHUNK_K * 2 + 16)
            + _persistent_fixed())
    return align(size, 8) + 1024


def persistent_launch(B: int, sms: int) -> Dict[str, int]:
    """The persistent path's launch for B boards on a card of ``sms``
    multiprocessors: groups of four boards, walked by a ``grid`` of at most
    one block an SM in ``rounds`` (block b takes group r * grid + b in
    round r), as few blocks as give the fewest rounds."""
    groups = -(-B // _BOARDS_A_BLOCK)
    rounds = -(-groups // sms)
    return {"path": "persistent", "grid": -(-groups // rounds),
            "groups": groups, "rounds": rounds,
            "smem": persistent_smem_bytes(), "stages": persistent_stages()}


def block_work(shape: Dict[str, int]) -> int:
    """A launch's most work a block: output channels times boards (the
    products of one block, whose chain sets the launch's time)."""
    if shape["path"] == "persistent":
        return shape["rounds"] * _BOARDS_A_BLOCK * PERSISTENT_C
    run = -(-shape["pieces"] // shape["grid"])
    return run * shape["per"] * shape["np"]


def conv_launch_shape(B: int, C: int, sms: int) -> Dict[str, int]:
    """The kernel's launch for B boards at width C on a card of ``sms``
    multiprocessors. At C ``PERSISTENT_C`` the persistent path
    (``persistent_launch``) wherever it gives a block no more products than
    the pieces below: from 397 boards on 132 multiprocessors up to 528, and
    at batches whose runs of pieces are as long (1,031 boards, not 600).
    Otherwise ``wave_shape``: ``pieces`` of work, each ``per`` boards (one
    a consumer warpgroup) and ``np`` output channels of a tile; a ``grid``
    of at most one block an SM, each taking a run of consecutive pieces;
    the ``smem`` bytes a block. Every shape and either path runs the same
    products in the same order on a board's elements, so the launch changes
    no bit (``scripts/conv_launch_sweep.py`` times them all)."""
    shape = wave_shape(B, C, sms)
    if C == PERSISTENT_C:
        persistent = persistent_launch(B, sms)
        if block_work(persistent) <= block_work(shape):
            return persistent
    return shape


def wave_shape(B: int, C: int, sms: int) -> Dict[str, int]:
    """The launch of ``conv3x3_kernel<C, NP, PER>`` for B boards: the first
    shape of ``SHAPES[C]`` whose pieces take the fewest waves (one, up to
    528 boards at C 128 on 132 multiprocessors): a block's work as small as
    the card allows, since one board's chain of products is bound by its
    latency, not by the tensor cores; at one board eight blocks of 16
    channels each, at 512 four boards and a whole tile."""
    def waves(shape):
        np_, per = shape
        return -(-(-(-B // per) * (C // np_)) // sms)

    return launch_in_shape(B, C, *min(SHAPES[C], key=waves), sms)


def launch_in_shape(B: int, C: int, np_: int, per: int, sms: int
                    ) -> Dict[str, int]:
    """The launch of B boards at width C in pieces of ``np_`` channels and
    ``per`` boards (one of ``SHAPES[C]``): its ``pieces``, and a ``grid``
    of at most ``sms`` blocks, each taking a run of ``ceil(pieces /
    grid)`` consecutive pieces (the kernel's own count), as few blocks as
    give the shortest run."""
    pieces = -(-B // per) * (C // np_)
    run = -(-pieces // sms)
    return {"path": "waves", "grid": max(1, -(-pieces // run)),
            "pieces": pieces, "np": np_, "per": per,
            "smem": conv_smem_bytes(C, np_, per),
            "stages": conv_stages(C, np_, per)}


# -----------------------------------------------------------------------------
# Wrapper
# -----------------------------------------------------------------------------

@cuda_build.counted
def conv3x3(x: torch.Tensor, w: torch.Tensor, bn: BN | None = None,
            relu: bool = False, image: torch.Tensor | None = None
            ) -> torch.Tensor:
    """The SAME 3x3 conv of the NHWC map ``x`` (B, 8, 8, C) by the OIHW
    weights ``w`` (C, C, 3, 3), rounded to ``x``'s dtype, then, with ``bn``
    = float32 (mean, mul, beta) of C, the inference BatchNorm and, with
    ``relu``, its ReLU; a new contiguous map. On a CUDA tensor one launch
    of ``conv3x3_kernel``, which reads ``image`` (``weight_image(w)``, made
    once, and not written since by the kernel launched just before: the
    kernel reads it before it waits for that one) and takes contiguous
    bfloat16 maps with C one of ``CHANNELS``; on a CPU tensor
    ``conv3x3_plain``."""
    epilogue.check_map("x", x)
    C = x.shape[3]
    if tuple(w.shape) != (C, C, 3, 3):
        raise ValueError(f"w must be ({C}, {C}, 3, 3) for the map's {C} "
                         f"channels, got {tuple(w.shape)}")
    if relu and bn is None:
        raise ValueError("the ReLU is the BatchNorm's: relu needs bn")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bn, relu).contiguous()
    dev = x.device
    cuda_build.check_operand("x", x, dev, torch.bfloat16)
    if C not in CHANNELS:
        raise ValueError(f"the kernel takes C one of {CHANNELS}, got {C}")
    if image is None:
        raise ValueError("a CUDA launch needs the weight image "
                         "(weight_image(w), made once)")
    N = tile_width(C)
    cuda_build.check_operand("image", image, dev, torch.bfloat16,
                             (C // N, -(-9 * C // CHUNK_K), N, CHUNK_K))
    if bn is not None:
        epilogue.check_bn(bn, C, dev)
    cuda_build.check_device(dev)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    B = x.shape[0]
    if B == 0:
        return out
    shape = conv_launch_shape(B, C, LIB.multiprocessors(dev))
    consts = (None, None, None) if bn is None else \
        tuple(t.data_ptr() for t in bn)
    epi = _EPI[(bn is not None, relu)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if shape["path"] == "persistent":
        cuda_build.launch(
            conv3x3, LIB.conv3x3_persistent_bf16, x.data_ptr(),
            image.data_ptr(), *consts, out.data_ptr(), B, epi, shape["grid"],
            stream, path=conv3x3.persistent)
    else:
        cuda_build.launch(
            conv3x3, LIB.conv3x3_bf16, x.data_ptr(), image.data_ptr(),
            *consts, out.data_ptr(), B, C, epi, shape["grid"], shape["np"],
            shape["per"], stream)
    return out


# the launches that took the persistent path (C 256 at large batches)
cuda_build.count_path(conv3x3, "persistent")
