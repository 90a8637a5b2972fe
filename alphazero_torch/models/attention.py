"""The encoder body's attention with its smolgen bias.

``smolgen_attention`` computes, for every board and head of the packed
QKV projection's output, ``softmax(Q K^T / sqrt(D) + S) V`` with the 64 x
64 bias ``S`` generated from the head's smolgen vector and the shared
``W_gen`` (``models/encoder.py``). On a CUDA tensor it is one launch of
``smolgen_attention_kernel`` (``csrc/attention_kernels.cu``), which keeps
the bias and the logits out of device memory and takes the encoder's BT4
widths alone (32 heads of 32, smolgen 256 a head) in bfloat16; on a CPU
tensor it runs ``smolgen_attention_plain``, in any float dtype. The
wrapper counts its launches in ``smolgen_attention.launches``.

How far the kernel may be from its plain version: both take float32 sums
of bf16 operands and round ``exp(l - max)`` to bf16 before the product
with V, so they differ by the order of the sums, ``exp2`` against ``exp``
and the last bits of the row sums: a few steps of bf16 in an output, far
less than the bf16 rounding of the inputs.
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
                      wgen_t: torch.Tensor, heads: int) -> torch.Tensor:
    """The attention of every board and head, as
    ``smolgen_attention_plain`` describes its operands; a new (B*64, E)
    tensor. On a CUDA tensor one launch of ``smolgen_attention_kernel``
    (bfloat16, contiguous, H 32, D 32, G 256); on a CPU tensor the plain
    version."""
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
    cuda_build.check_device(dev)
    out = torch.empty((B * TOKENS, E), dtype=qkv.dtype, device=dev)
    cuda_build.launch(
        smolgen_attention, LIB.smolgen_attention_bf16, qkv.data_ptr(),
        s.data_ptr(), wgen_t.data_ptr(), out.data_ptr(), B, heads,
        E // heads, G, torch.cuda.current_stream(dev).cuda_stream)
    return out
