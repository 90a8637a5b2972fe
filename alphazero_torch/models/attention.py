"""The encoder body's attention with its smolgen bias.

``smolgen_attention`` computes, for every board and head of the packed
QKV projection's output, ``softmax(Q K^T / sqrt(D) + S) V`` with the 64 x
64 bias ``S`` generated from the head's smolgen vector and the shared
``W_gen`` (``models/encoder.py``). On a CUDA tensor it is one launch of
``smolgen_attention_kernel`` (``csrc/attention_kernels.cu``), which keeps
the bias and the logits out of device memory and takes the encoder's BT4
widths alone (32 heads of 32, smolgen 256 a head) in bfloat16; on a CPU
tensor it runs ``smolgen_attention_plain``, in any float dtype. The
wrapper counts its launches in ``smolgen_attention.launches``. The kernel
reads ``W_gen`` from ``wgen_image``'s packed form, which
``encoder_inference.prepare`` makes once on a card.

How far the kernel may be from its plain version: both take float32 sums
of bf16 operands and round ``exp(l - max)`` to bf16 before the product
with V, so they differ by the order of the sums, the special function
unit's ``exp2`` (two ulps) against ``exp`` and the last bits of the row
sums: a few steps of bf16 in an output, far less than the bf16 rounding of
the inputs.
"""

from __future__ import annotations

import math

import torch

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import I, P

LIB = cuda_build.Library("attention_kernels",
                         smolgen_attention_bf16=[P] * 4 + [I] * 4 + [P])
TOKENS = 64
# the widths the kernel is compiled for: BT4's heads, head width and
# smolgen's width a head
KERNEL_HEADS, KERNEL_DIM, KERNEL_GEN = 32, 32, 256
# a tile of wgen_image: the positions one block of the kernel's cluster
# covers in a chunk (two query rows' keys), by one 128-byte row of k
TILE_POSITIONS, TILE_K = 128, 64


def k_order(width: int) -> torch.Tensor:
    """The order in which ``wgen_image`` lays out k (``width`` a multiple of
    32): within each 32, the kernel's k-step h's register pair u of lane t,
    place 16 h + 8 u + 2 t + e, holds k 8 t + 4 h + 2 u + e, so that a lane
    reads its smolgen operands of two k-steps as one 16-byte load."""
    place = torch.arange(width)
    h, u = place % 32 // 16, place % 16 // 8
    t, e = place % 8 // 2, place % 2
    return place // 32 * 32 + 8 * t + 4 * h + 2 * u + e


def wgen_image(wgen_t: torch.Tensor) -> torch.Tensor:
    """``W_gen`` (4096, G) as the kernel streams it: G padded with zeros to
    a multiple of 64 and put in ``k_order``, then tiles of 128 positions by
    64 k, tile (p, k) the ``[p, k]`` entry of a (32, G / 64, 128, 64)
    tensor, each tile's rows a position's 64 k (128 bytes in bf16) with the
    128-byte swizzle."""
    P, G = wgen_t.shape
    kt = -(-G // TILE_K)
    w = torch.nn.functional.pad(wgen_t, (0, kt * TILE_K - G))
    w = w[:, k_order(kt * TILE_K).to(w.device)]
    w = w.reshape(P // TILE_POSITIONS, TILE_POSITIONS, kt, 8, 8)
    w = w.transpose(1, 2)                 # (tile p, tile k, row, piece, 8)
    # piece j of row n goes to piece j ^ (n % 8)
    n = torch.arange(TILE_POSITIONS, device=w.device)
    src = torch.arange(8, device=w.device)[None, :] ^ (n[:, None] % 8)
    w = w.gather(-2, src[..., None].expand(w.shape))
    return w.reshape(P // TILE_POSITIONS, kt, TILE_POSITIONS,
                     TILE_K).contiguous()


def smolgen_attention_plain(qkv: torch.Tensor, s: torch.Tensor,
                            wgen_t: torch.Tensor, heads: int
                            ) -> torch.Tensor:
    """What ``smolgen_attention`` computes, in float32 on the operands'
    values: ``qkv`` (B*64, 3E) is Q | K | V with head h at columns
    ``h*D ..``, ``s`` (B, H, G) the smolgen vectors, ``wgen_t`` (4096, G)
    ``W_gen`` transposed; the result (B*64, E) in ``qkv``'s dtype. The
    softmax's numerators are rounded to that dtype before the product
    with V and its sums are not, as the kernel rounds them."""
    T = TOKENS
    B, E = qkv.shape[0] // T, qkv.shape[1] // 3
    D = E // heads
    q, k, v = qkv.float().view(B, T, 3, heads, D).permute(2, 0, 3, 1, 4)
    bias = (s.float() @ wgen_t.float().T).view(B, heads, T, T)
    logits = q @ k.transpose(-1, -2) / math.sqrt(D) + bias
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    a = (e.to(qkv.dtype).float() @ v) / e.sum(-1, keepdim=True)
    return a.transpose(1, 2).reshape(B * T, E).to(qkv.dtype)


@cuda_build.counted
def smolgen_attention(qkv: torch.Tensor, s: torch.Tensor,
                      wgen_t: torch.Tensor, heads: int,
                      image: torch.Tensor | None = None) -> torch.Tensor:
    """The attention of every board and head, as
    ``smolgen_attention_plain`` describes its operands; a new (B*64, E)
    tensor. On a CUDA tensor one launch of ``smolgen_attention_kernel``
    (bfloat16, contiguous, H 32, D 32, G 256), which reads ``W_gen`` from
    ``image``, ``wgen_image(wgen_t)`` (packed here when not given); on a
    CPU tensor the plain version."""
    if qkv.dim() != 2 or qkv.shape[0] % TOKENS or qkv.shape[1] % (3 * heads):
        raise ValueError(f"qkv must be (B*64, 3E) with E a multiple of "
                         f"{heads} heads, got {tuple(qkv.shape)}")
    B, E = qkv.shape[0] // TOKENS, qkv.shape[1] // 3
    G = wgen_t.shape[-1]
    if tuple(s.shape) != (B, heads, G) or \
            tuple(wgen_t.shape) != (TOKENS * TOKENS, G):
        raise ValueError(f"s {tuple(s.shape)} and wgen_t "
                         f"{tuple(wgen_t.shape)} do not fit {B} boards of "
                         f"{heads} heads")
    if qkv.device.type == "cpu":
        return smolgen_attention_plain(qkv, s, wgen_t, heads)
    if (heads, E // heads, G) != (KERNEL_HEADS, KERNEL_DIM, KERNEL_GEN):
        raise ValueError(
            f"the kernel takes {KERNEL_HEADS} heads of {KERNEL_DIM} and "
            f"smolgen {KERNEL_GEN} a head, got {heads} of {E // heads} and "
            f"{G}")
    dev = qkv.device
    for name, t, shape in (("qkv", qkv, (B * TOKENS, 3 * E)),
                           ("s", s, (B, heads, G)),
                           ("wgen_t", wgen_t, (TOKENS * TOKENS, G))):
        cuda_build.check_operand(name, t, dev, torch.bfloat16, shape)
    if image is None:
        image = wgen_image(wgen_t)
    cuda_build.check_operand("image", image, dev, torch.bfloat16,
                             (TOKENS * TOKENS // TILE_POSITIONS, G // TILE_K,
                              TILE_POSITIONS, TILE_K))
    cuda_build.check_device(dev)
    out = torch.empty((B * TOKENS, E), dtype=qkv.dtype, device=dev)
    cuda_build.launch(
        smolgen_attention, LIB.smolgen_attention_bf16, qkv.data_ptr(),
        s.data_ptr(), image.data_ptr(), out.data_ptr(), B, heads,
        E // heads, G, torch.cuda.current_stream(dev).cuda_stream)
    return out
