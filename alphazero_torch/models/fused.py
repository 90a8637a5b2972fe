"""Fused SE-ResNet tower inference: one CUDA kernel for the whole tower.

Port of ``alphazero_tpu/models/fused.py``, with the same public names.
BatchNorm is folded into the conv weights and biases on the host
(``pack_weights``), so the tower is, per block,

    conv3x3 + bias + ReLU -> conv3x3 + bias -> SE scale-and-shift
    -> + skip -> ReLU

on ``(B*64, 128)`` bfloat16 activations whose rows are game-major,
``h*8 + w`` within a game. ``tower_forward`` computes all blocks in one
launch of the hand-written kernel in ``csrc/tower_kernel.cu`` when its
input lies on a CUDA device, and runs the plain version beside it,
``_tower_plain``, when its input lies on the CPU. It never falls back: on
a CUDA tensor it launches the kernel or raises. The kernel's tensor cores
read the conv weights from shared memory in a layout of their own, so
``pack_weights`` also makes that image once (``wconv_smem_image``).

Scope: the tower only (C = 128). The input conv (Cin = 3) and the two
heads stay ``F.conv2d`` / ``torch.matmul`` in ``fused_apply``, as the JAX
package left them to XLA. The search's bf16 evaluator runs its tower
through ``tower_forward`` at batches of ``models/inference.py:B_MIN`` or
more boards (``inference.fused_tower``), with the input conv and heads of
its own per-layer route; the JAX package wires no evaluator to its tower.
``alphazero_torch.bench_fused`` times ``fused_apply`` beside the
layer-by-layer net.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import I, P
from alphazero_torch.models.conv import weight_image_kmajor

# Games per thread block of the CUDA kernel: a batch must be a multiple of
# it. A game is the 64 rows of one warpgroup's matrix multiply and a thread
# block has four such warpgroups, so 512 positions give 128 thread blocks,
# one on each of 128 of the card's 132 SMs.
TB = 4
# Input channels per weight chunk of the kernel's shared-memory ring: 64
# bf16 are one 128-byte row of the swizzled image.
_CHUNK_K = 64
_C = 128
LIB = cuda_build.Library("tower_kernel",
                         tower_forward_bf16=[P] * 10 + [I, I, P])


# -----------------------------------------------------------------------------
# Host-side weight packing (BN folding)
# -----------------------------------------------------------------------------

def _bn_fold(kernel: np.ndarray, bn: Dict[str, np.ndarray]):
    """Fold inference BatchNorm into an HWIO conv kernel and a bias.

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv(x) * s + (beta - mean * s),   s = gamma / sqrt(var + eps)

    float32 numpy, in the JAX package's operation order, so that the
    packed arrays of the two packages agree bit for bit."""
    eps = 1e-5
    s = bn["scale"] / np.sqrt(bn["var"] + eps)
    return kernel * s, bn["bias"] - bn["mean"] * s


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _hwio(conv: torch.nn.Conv2d) -> np.ndarray:
    return _np(conv.weight).transpose(2, 3, 1, 0)            # OIHW -> HWIO


def _bn(bn: torch.nn.BatchNorm2d) -> Dict[str, np.ndarray]:
    return {"scale": _np(bn.weight), "bias": _np(bn.bias),
            "mean": _np(bn.running_mean), "var": _np(bn.running_var)}


def _hwc_dense(fc: torch.nn.Linear) -> np.ndarray:
    """The (in, out) kernel of a dense layer after a flatten, with the
    input back in the JAX package's (h, w, c) order: undoes the
    (c, h, w) permutation that ``models/convert.py`` applied at load."""
    w = _np(fc.weight)                                       # (out, c*64)
    n_out, n_in = w.shape
    return np.ascontiguousarray(
        w.reshape(n_out, n_in // 64, 64).transpose(2, 1, 0)
    ).reshape(n_in, n_out)


def wconv_smem_image(wconv: torch.Tensor) -> torch.Tensor:
    """``wconv[i, j, tap, cin, cout]`` -> the image of it that the CUDA
    kernel copies into shared memory chunk by chunk and its tensor cores
    read by descriptor: ``(n, 2, 9, 2, 128, 64)``, any dtype.

    Each conv's image is ``conv.weight_image_kmajor`` of its (cout, K)
    matrix (k = tap*128 + cin) at a tile of 128 output channels, the
    layout the bf16 conv kernel reads too: a chunk is one half of a tap's
    input channels, stored ``[cout][cin]`` (K-major) in rows of 64 values,
    128 bytes in bf16, with the card's 128-byte swizzle applied: the
    8-value piece ``j`` of row ``cout`` lies at piece ``j ^ (cout % 8)``.
    So element ``[i, j, tap, half, cout, p, e]`` of the image (row pieces
    ``p``, ``e`` within a piece) is ``wconv[i, j, tap, half*64 + (p ^
    (cout % 8))*8 + e, cout]``."""
    n = wconv.shape[0]
    # every conv's (cout, K) rows stacked: one tile of 128 rows a conv
    wk = wconv.reshape(n * 2, 9 * _C, _C).transpose(1, 2)
    image = weight_image_kmajor(wk.reshape(n * 2 * _C, 9 * _C), _C)
    return image.reshape(n, 2, 9, _C // _CHUNK_K, _C, _CHUNK_K)


def pack_weights(net) -> Dict[str, Any]:
    """``AlphaZeroNet`` (float32) -> packed, BN-folded tensors for the fused
    forward, on the net's device, in the JAX package's layouts:
    ``wconv[i, j, ky*3+kx, cin, cout]``, ``k_in``/``k_pol``/``k_val`` HWIO,
    ``policy_fc``/``value_fc1`` (in, out) with the input in (h, w, c) order.

    Two keys are this port's own. ``"f32"`` holds float32 copies of the
    (bf16-rounded) weights outside the tower in the layouts ``F.conv2d``
    and ``torch.matmul`` take (OIHW convs, (in, out) dense), so that
    ``fused_apply`` converts nothing per call. ``"wconv_smem"`` holds the
    values of ``"wconv"`` in the CUDA kernel's shared-memory layout
    (``wconv_smem_image``); the plain version reads ``"wconv"``."""
    n = len(net.blocks)
    C = net.input_conv.out_channels
    if C != _C:
        raise ValueError(f"the fused tower is specialised to C={_C}, "
                         f"got {C}")
    device = net.input_conv.weight.device

    wconv = np.zeros((n, 2, 9, C, C), np.float32)
    bconv = np.zeros((n, 2, C), np.float32)
    wse1 = np.zeros((n, C, 128), np.float32)    # fc1 zero-padded to 128
    bse1 = np.zeros((n, 128), np.float32)
    wse2g = np.zeros((n, 128, C), np.float32)   # fc2 gate half
    wse2b = np.zeros((n, 128, C), np.float32)   # fc2 bias half
    bse2g = np.zeros((n, C), np.float32)
    bse2b = np.zeros((n, C), np.float32)

    for i, block in enumerate(net.blocks):
        for j, (conv, bn) in enumerate(((block.conv1, block.bn1),
                                        (block.conv2, block.bn2))):
            kf, bf = _bn_fold(_hwio(conv), _bn(bn))
            wconv[i, j] = kf.reshape(9, C, C)
            bconv[i, j] = bf
        se_hidden = block.se.fc1.out_features
        wse1[i, :, :se_hidden] = _np(block.se.fc1.weight).T
        bse1[i, :se_hidden] = _np(block.se.fc1.bias)
        w2 = _np(block.se.fc2.weight).T                      # (h, 2C)
        b2 = _np(block.se.fc2.bias)                          # (2C,)
        wse2g[i, :se_hidden] = w2[:, :C]
        wse2b[i, :se_hidden] = w2[:, C:]
        bse2g[i], bse2b[i] = b2[:C], b2[C:]

    # input conv + heads (outside the kernel), BN folded
    k_in, b_in = _bn_fold(_hwio(net.input_conv), _bn(net.input_bn))
    k_pol, b_pol = _bn_fold(_hwio(net.policy_conv), _bn(net.policy_bn))
    k_val, b_val = _bn_fold(_hwio(net.value_conv), _bn(net.value_bn))

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)) \
            .to(device)

    def bf(x):
        return f32(x).to(torch.bfloat16)

    packed = {
        "wconv": bf(wconv), "bconv": f32(bconv),
        "wse1": bf(wse1), "bse1": f32(bse1),
        "wse2g": bf(wse2g), "wse2b": bf(wse2b),
        "bse2g": f32(bse2g), "bse2b": f32(bse2b),
        "k_in": bf(k_in), "b_in": f32(b_in),
        "k_pol": bf(k_pol), "b_pol": f32(b_pol),
        "policy_fc": bf(_hwc_dense(net.policy_fc)),
        "policy_fc_b": f32(_np(net.policy_fc.bias)),
        "k_val": bf(k_val), "b_val": f32(b_val),
        "value_fc1": bf(_hwc_dense(net.value_fc1)),
        "value_fc1_b": f32(_np(net.value_fc1.bias)),
        "value_fc2": bf(_np(net.value_fc2.weight).T),
        "value_fc2_b": f32(_np(net.value_fc2.bias)),
        "num_blocks": n,
    }
    oihw = lambda k: packed[k].float().permute(3, 2, 0, 1).contiguous()
    packed["wconv_smem"] = wconv_smem_image(packed["wconv"])
    packed["f32"] = {
        "k_in": oihw("k_in"), "k_pol": oihw("k_pol"), "k_val": oihw("k_val"),
        "policy_fc": packed["policy_fc"].float(),
        "value_fc1": packed["value_fc1"].float(),
        "value_fc2": packed["value_fc2"].float(),
    }
    return packed


# -----------------------------------------------------------------------------
# The tower: plain version and kernel wrapper
# -----------------------------------------------------------------------------

def _shift_masks() -> np.ndarray:
    """(9, 64) f32 validity per shift k = (dy+1)*3 + (dx+1): output row
    (h, w) is valid iff the source (h+dy, w+dx) is on the board."""
    m = np.zeros((9, 64), np.float32)
    for k in range(9):
        dy, dx = k // 3 - 1, k % 3 - 1
        for h in range(8):
            for w in range(8):
                if 0 <= h + dy < 8 and 0 <= w + dx < 8:
                    m[k, h * 8 + w] = 1.0
    return m


_MASKS = _shift_masks()


def _conv9(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of (R, C) float32 rows (game-major, h*8+w) as nine
    row-shifted, edge-masked (R, C) x (C, C) float32 matmuls. A row whose
    source crosses the board's edge is masked, which also covers rows that
    would read the next game or wrap around the batch."""
    R = x.shape[0]
    masks = torch.from_numpy(_MASKS).to(x.device)
    acc = torch.zeros((R, w9.shape[2]), dtype=torch.float32, device=x.device)
    for k in range(9):
        s = (k // 3 - 1) * 8 + (k % 3 - 1)
        shifted = torch.roll(x, -s, 0) if s else x            # out[r]=x[r+s]
        acc = acc + (shifted * masks[k].repeat(R // 64)[:, None]) @ w9[k]
    return acc


def _tower_plain(x2d: torch.Tensor, packed, num_blocks: int) -> torch.Tensor:
    """The tower in plain PyTorch with the kernel's rounding points: bf16
    operands, products summed in float32 (both operands upcast; a product
    of two bf16 values is exact in float32, so only the order of the sum
    differs from the kernel's), bias and ReLU in float32, then one rounding
    to bf16. The second conv, the SE gate and shift and the residual add
    stay in float32 until the block's single final rounding."""
    G = x2d.shape[0] // 64
    x = x2d
    for i in range(num_blocks):
        w = packed["wconv"][i].float()                       # (2, 9, C, C)
        bc = packed["bconv"][i]
        y = _conv9(x.float(), w[0]) + bc[0]
        y = torch.relu(y).to(torch.bfloat16)
        y = _conv9(y.float(), w[1]) + bc[1]                  # (R, C) f32

        # SE (LC0 scale-and-shift); fc1 is zero-padded to 128 columns, so
        # the hidden vector is zero beyond the real bottleneck width
        pooled = y.view(G, 64, _C).mean(1)                   # (G, C) f32
        h = pooled.to(torch.bfloat16).float() @ packed["wse1"][i].float() \
            + packed["bse1"][i]
        h = torch.relu(h).to(torch.bfloat16).float()
        gate = torch.sigmoid(h @ packed["wse2g"][i].float()
                             + packed["bse2g"][i])
        sbias = h @ packed["wse2b"][i].float() + packed["bse2b"][i]
        y = (y.view(G, 64, _C) * gate[:, None, :]
             + sbias[:, None, :]).view(G * 64, _C)
        x = torch.relu(y + x.float()).to(torch.bfloat16)
    return x


_KERNEL_OPERANDS = (("wconv_smem", torch.bfloat16,
                     (2, 9, _C // _CHUNK_K, _C, _CHUNK_K)),
                    ("bconv", torch.float32, (2, _C)),
                    ("wse1", torch.bfloat16, (_C, 128)),
                    ("bse1", torch.float32, (128,)),
                    ("wse2g", torch.bfloat16, (128, _C)),
                    ("wse2b", torch.bfloat16, (128, _C)),
                    ("bse2g", torch.float32, (_C,)),
                    ("bse2b", torch.float32, (_C,)))


@cuda_build.counted
def tower_forward(x2d: torch.Tensor, packed, num_blocks: int) -> torch.Tensor:
    """(B*64, 128) bf16 tower input -> (B*64, 128) bf16 tower output after
    ``num_blocks`` blocks; B must be a multiple of ``TB``. On a CUDA tensor
    one kernel launch computes every block: a thread block keeps the
    activations of ``TB`` games in shared memory, one game to each
    warpgroup, and streams ``packed["wconv_smem"]`` through a ring there
    for the tensor cores to read; the other operands are read as the
    plain version reads them. On a CPU tensor the plain version runs,
    which reads ``packed["wconv"]``."""
    if x2d.dtype != torch.bfloat16:
        raise TypeError(f"the tower takes bfloat16 activations, got "
                        f"{x2d.dtype}")
    if x2d.dim() != 2 or x2d.shape[1] != _C:
        raise ValueError(f"the tower takes (B*64, {_C}) rows, got "
                         f"{tuple(x2d.shape)}: it is specialised to "
                         f"C={_C}")
    if x2d.shape[0] % (TB * 64):
        raise ValueError(f"batch must be a multiple of {TB} games "
                         f"({TB * 64} rows), got {x2d.shape[0]} rows")
    if not 0 <= num_blocks <= packed["wconv"].shape[0]:
        raise ValueError(f"num_blocks {num_blocks} outside the "
                         f"{packed['wconv'].shape[0]} packed blocks")
    if x2d.device.type == "cpu":
        return _tower_plain(x2d, packed, num_blocks)

    dev = x2d.device
    # the input is never copied
    cuda_build.check_operand("the tower input", x2d, dev, torch.bfloat16)
    n = packed["wconv"].shape[0]
    for key, dtype, shape in _KERNEL_OPERANDS:
        cuda_build.check_operand(f"packed[{key!r}]", packed[key], dev, dtype,
                                 (n,) + shape, dtype_error=ValueError)
    cuda_build.check_device(dev)
    out = torch.empty_like(x2d)
    cuda_build.launch(
        tower_forward, LIB.tower_forward_bf16, x2d.data_ptr(), out.data_ptr(),
        *(packed[key].data_ptr() for key, _, _ in _KERNEL_OPERANDS),
        x2d.shape[0] // 64, num_blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    return out


# -----------------------------------------------------------------------------
# Full fused forward: input conv + tower + heads
# -----------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, 8, 8) -> (B, 64*C) flattened in (h, w, c) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _act(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.relu(y + bias).to(torch.bfloat16)


def _chan(bias: torch.Tensor) -> torch.Tensor:
    return bias[None, :, None, None]


@torch.no_grad()
def tower_input(packed, planes: torch.Tensor) -> torch.Tensor:
    """(B, 3, 8, 8) planes -> the tower's (B*64, 128) bf16 input rows: the
    BN-folded input conv, bias and ReLU."""
    x = planes.to(torch.bfloat16).float()
    x = _act(F.conv2d(x, packed["f32"]["k_in"], padding=1),
             _chan(packed["b_in"]))
    return _rows(x).reshape(planes.shape[0] * 64, _C)


@torch.no_grad()
def heads(packed, t2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tower's (B*64, 128) bf16 output rows -> (policy_logits,
    wl_logits), float32."""
    w = packed["f32"]
    B = t2d.shape[0] // 64
    t = t2d.view(B, 8, 8, _C).permute(0, 3, 1, 2).float()    # NCHW view

    p = _act(F.conv2d(t, w["k_pol"], padding=1), _chan(packed["b_pol"]))
    policy = _rows(p).float() @ w["policy_fc"] + packed["policy_fc_b"]

    v = _act(F.conv2d(t, w["k_val"]), _chan(packed["b_val"]))
    v = _act(_rows(v).float() @ w["value_fc1"], packed["value_fc1_b"])
    wl = v.float() @ w["value_fc2"] + packed["value_fc2_b"]
    return policy.float(), wl.float()


def fused_apply(packed, planes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, 8, 8) planes -> (policy_logits, wl_logits), float32.

    Numerically equivalent to the bf16 net's inference forward (BN folded;
    the rounding points differ at the 1e-2 level in a logit).

    The input conv and the heads follow the JAX package's rounding: bf16
    operands, float32 sums, bias and ReLU in float32, then one rounding
    to bf16. ``F.conv2d`` and ``torch.matmul`` on bf16 tensors return
    bf16, one rounding more, before the bias; so, on the card as on the
    CPU, the bf16-rounded operands are upcast and the product runs in
    float32 (every product of two bf16 values is exact there). That keeps
    the tolerance against the JAX package at the order of the sums alone
    and costs time: the 128->128 policy conv runs at the float32 rate
    (``bench_fused`` reports it inside the fused path's time)."""
    t = tower_forward(tower_input(packed, planes), packed,
                      num_blocks=packed["num_blocks"])
    return heads(packed, t)
