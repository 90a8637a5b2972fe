"""The epilogues around the convolutions of the bf16 search evaluator.

The JAX package's bf16 net runs inside the jitted move, where XLA fuses
the glue between its convolutions into their neighbours. The port does
the same with two hand-written kernels (``csrc/epilogue_kernels.cu``) on
NHWC bf16 maps ``(B, 8, 8, C)``:

- ``bn_act``: an inference BatchNorm and its ReLU, in Flax's order
  (``flax.linen.normalization._normalize``): the conv's bf16 output, then
  ``((y - mean) * mul) + beta`` in float32, then one cast, where ``mul =
  rsqrt(var + eps) * gamma`` is computed once, when the weights are
  prepared (``models/inference.py``). The BatchNorm is not folded into the
  conv weights: the JAX bf16 net does not fold, and folding would move the
  bf16 rounding points.
- ``se_residual``: the tail of a tower block
  (``alphazero_tpu/models/network.py:74-77``, ``quant.py:185-186``): an
  optional BatchNorm affine, the LC0 scale-and-shift squeeze-excite and
  ``relu(y * gate + shift + x)``, rounded to bf16 after each operation as
  the plain version's separate operations round.

Each has a plain PyTorch version beside it (``bn_act_plain``,
``se_residual_plain``), which is the reference: a wrapper runs it for a
tensor on the CPU, and on a CUDA tensor launches its kernel or raises
(a dtype other than bfloat16, a map that is not contiguous, a failed
build). Each wrapper counts its launches in ``<function>.launches``.

``se_residual``'s kernel is persistent: a block an SM walks over every
grid-th board with up to four warpgroups, each taking one board at a
time: its ``y`` straight into registers, its ``x`` by a bulk async copy
into the warpgroup's own stages in shared memory, asked for ahead.
``se_launch_shape`` sizes the grid, the warpgroups and the stages from
B, C and H at each launch; the kernel takes C a multiple of 8 up to
``MAX_SE_CHANNELS`` and H up to ``MAX_SE_HIDDEN`` (the layout's shared
memory, ``se_smem_bytes``, stays within ``SMEM_PER_BLOCK``).

How far the kernels may be from their plain versions: ``bn_act`` not at
all. ``se_residual`` rounds where its plain version rounds and takes the
sums of the pool and the dense layers in float64 in its own order, which
depends on C and H alone (so a board's result does not depend on the
batch), rounded through float32 as the plain version with ``f64_sums``
takes them; the two differ only where a sum is not exact in float64 or
the sigmoids differ in a last bit. On the card ``se_residual`` is held to
that: every element at most one step of bf16 away (``steps_apart``) and
at most ``SE_UNEQUAL_SHARE`` of them unequal. ``se_residual_bound`` is
the looser bound between the plain version and another computation whose
sums may each round to a neighbouring value, such as Flax's under XLA.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import I, LL, P, align

# se_residual_init opts se_residual's kernel in to its shared memory
LIB = cuda_build.Library("epilogue_kernels", init="se_residual_init",
                         bn_act_bf16=[P] * 5 + [LL, I, I, P],
                         se_residual_bf16=[P] * 10 + [I] * 6 + [P])
# a block's dynamic shared memory on an H100 after the kernel's opt-in
SMEM_PER_BLOCK = 232_448
# what se_residual's kernel takes: channels (a multiple of 8; a thread
# holds its rows of a board in at most 16 vectors of registers) and SE
# hidden units (at C 256, se_ratio 8's 32 units keep four stages beside two
# warpgroups: 203,520 bytes). The net has 128 and 16.
MAX_SE_CHANNELS, MAX_SE_HIDDEN = 256, 32
_SE_MAX_STAGES = 8                      # a block's; its mbarriers hold 31
# the share of se_residual's elements that may differ from
# se_residual_plain(..., f64_sums=True) on the card, each by one step
SE_UNEQUAL_SHARE = 1e-5

BN = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]        # mean, mul, beta
Dense = Tuple[torch.Tensor, torch.Tensor]                   # (in, out), bias


# -----------------------------------------------------------------------------
# Plain versions
# -----------------------------------------------------------------------------

def bn_act_plain(y: torch.Tensor, bn: BN, relu: bool = True
                 ) -> torch.Tensor:
    """What ``bn_act`` computes: ``((f32(y) - mean) * mul) + beta``, then
    ReLU, in ``y``'s dtype; without ``relu`` the affine of
    ``se_residual``'s BatchNorm."""
    mean, mul, beta = bn
    out = (y.float() - mean) * mul + beta
    if relu:
        out = torch.relu(out)
    return out.to(y.dtype)


def se_gate_shift_plain(y: torch.Tensor, fc1: Dense, fc2: Dense,
                        f64_sums: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The squeeze-excite's (B, C) sigmoid gate and shift of the NHWC map
    ``y``, in its dtype: the mean over the squares, each matrix product
    and each bias add rounded apart, as Flax's ``nn.Dense`` rounds. With
    ``f64_sums`` the mean and the products are summed in float64 and
    rounded through float32 to ``y``'s dtype."""
    if f64_sums:
        dt = y.dtype
        pooled = y.double().mean(dim=(1, 2)).float().to(dt)
        mm = lambda a, w: (a.double() @ w.double()).float().to(dt)
    else:
        pooled, mm = y.mean(dim=(1, 2)), torch.matmul
    h = torch.relu(mm(pooled, fc1[0]) + fc1[1])
    h = mm(h, fc2[0]) + fc2[1]
    gate, shift = h.chunk(2, dim=-1)
    return torch.sigmoid(gate), shift


def se_residual_plain(y: torch.Tensor, x: torch.Tensor, fc1: Dense,
                      fc2: Dense, bn: BN | None = None,
                      f64_sums: bool = False) -> torch.Tensor:
    """What ``se_residual`` computes: ``y' = bn_act_plain(y, bn, False)``
    (or ``y``), then ``relu(y' * gate + shift + x)``; ``f64_sums`` as in
    ``se_gate_shift_plain``."""
    if bn is not None:
        y = bn_act_plain(y, bn, relu=False)
    gate, shift = se_gate_shift_plain(y, fc1, fc2, f64_sums)
    return torch.relu(y * gate[:, None, None, :] + shift[:, None, None, :]
                      + x)


def steps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``|a - b|`` in steps of their dtype at the larger magnitude of the
    two, element by element (0 where they are equal)."""
    d = (a.float() - b.float()).abs()
    return d / (_two_steps(torch.maximum(a.abs(), b.abs()), a.dtype) / 2)


def _two_steps(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Twice the spacing of ``dtype``'s values at ``|t|``: a step there, or
    at a neighbour across a power of two."""
    info = torch.finfo(dtype)
    _, exp = torch.frexp(t.float().abs().clamp_min(info.tiny))
    return torch.pow(2.0, exp.float()) * info.eps


def se_residual_bound(y: torch.Tensor, x: torch.Tensor, fc1: Dense,
                      fc2: Dense, bn: BN | None = None) -> torch.Tensor:
    """How far apart two computations of ``se_residual`` may be, an
    element, when both round at the plain version's points but take the
    float32 sums of the pool and of the SE's two dense layers in other
    orders (the kernel against the plain version's library reductions;
    either against XLA). Each rounded sum may then land on the neighbouring
    value of the maps' dtype, one step: the pool, each product and each
    bias add. A step in the pool or in the hidden layer is carried on by
    the next layer's absolute weights, the sigmoid's slope is at most 1/4,
    and the multiply and the two adds after the gate round once each. Each
    step is taken at twice its size at the plain version's values."""
    step = lambda t: _two_steps(t, y.dtype)
    if bn is not None:
        y = bn_act_plain(y, bn, relu=False)
    w1, b1, w2, b2 = (t.float() for t in (*fc1, *fc2))
    pooled = y.mean(dim=(1, 2))
    dot1 = pooled.float() @ w1
    d_hidden = step(pooled) @ w1.abs() + step(dot1) + step(dot1 + b1)
    hidden = torch.relu(pooled @ fc1[0] + fc1[1]).float()
    dot2 = hidden @ w2
    d_g = d_hidden @ w2.abs() + step(dot2) + step(dot2 + b2)
    C = y.shape[3]
    gate, shift = se_gate_shift_plain(y, fc1, fc2)
    d_gate = d_g[:, :C] / 4 + step(gate)
    yf = y.float()
    t1 = yf * gate.float()[:, None, None, :]
    t2 = t1 + shift.float()[:, None, None, :]
    return (yf.abs() * d_gate[:, None, None, :] + d_g[:, None, None, C:]
            + step(t1) + step(t2) + step(t2 + x.float()))


# -----------------------------------------------------------------------------
# se_residual's launch shape
# -----------------------------------------------------------------------------

def se_smem_bytes(C: int, H: int, waves: int, stages: int) -> int:
    """A block's shared memory in ``se_residual_kernel``
    (``epilogue_kernels.cu:se_layout``): 256 bytes of mbarriers, the bf16
    weights w1 and w2, each warpgroup's scratch (float64: 1024 partial
    column sums, pooled, hidden; bf16 gate and shift), then the stages, a
    board's ``x`` each."""
    scratch = 256 + align(2 * C * H, 16) + align(4 * C * H, 16)
    per_wave = align(8 * (1024 + C + H), 16) + 4 * C
    return align(scratch + waves * per_wave, 128) + stages * 128 * C


def se_launch_shape(B: int, C: int, H: int, sms: int) -> Dict[str, int]:
    """``se_residual_kernel``'s launch for B boards on a card of ``sms``
    multiprocessors: ``grid`` blocks (one an SM at most), ``waves``
    warpgroups a block (four; two past C 128, where a thread holds 16
    vectors of a board; no more than the block's boards), ``stages``
    boards in shared memory a block,
    the same number for each warpgroup (as many as fit, up to its boards,
    eight a block at most), and its ``smem`` bytes. Raises if no layout
    fits."""
    grid = max(1, min(B, sms))
    per_block = -(-B // grid)
    waves = min(4 if C <= 128 else 2, per_block)
    for w in range(waves, 0, -1):
        fit = (SMEM_PER_BLOCK - se_smem_bytes(C, H, w, 0)) // (128 * C)
        own = min(fit, _SE_MAX_STAGES) // w
        own = min(own, -(-per_block // w))
        if own >= 1:
            return {"grid": grid, "waves": w, "stages": w * own,
                    "smem": se_smem_bytes(C, H, w, w * own)}
    raise ValueError(f"se_residual's layout at C {C}, H {H} needs "
                     f"{se_smem_bytes(C, H, 1, 1)} bytes of shared memory "
                     f"for one stage, past {SMEM_PER_BLOCK}")


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------

def check_map(name: str, t: torch.Tensor, like: torch.Tensor | None = None
              ) -> None:
    """Raises unless ``t`` is a (B, 8, 8, C) map (shaped ``like``, if
    given)."""
    if t.dim() != 4 or tuple(t.shape[1:3]) != (8, 8) \
            or (like is not None and t.shape != like.shape):
        raise ValueError(f"{name} must be a (B, 8, 8, C) map"
                         + ("" if like is None else
                            f" like {tuple(like.shape)}")
                         + f", got {tuple(t.shape)}")


def check_bn(bn: BN, C: int, dev: torch.device) -> None:
    """Raises unless the BatchNorm's constants are launch operands: (C,)
    float32 on ``dev``."""
    for name, t in zip(("mean", "mul", "beta"), bn):
        cuda_build.check_operand(name, t, dev, torch.float32, (C,))


@cuda_build.counted
def bn_act(y: torch.Tensor, bn: BN) -> torch.Tensor:
    """Inference BatchNorm (``bn`` = float32 (mean, mul, beta) of C) and
    ReLU on the NHWC map ``y`` (B, 8, 8, C); a new map of ``y``'s dtype. On
    a CUDA tensor one launch of ``bn_act_kernel``, which takes contiguous
    bfloat16 maps with C a multiple of 8; on a CPU tensor
    ``bn_act_plain``."""
    check_map("y", y)
    if y.device.type == "cpu":
        return bn_act_plain(y, bn)
    C = y.shape[3]
    dev = y.device
    cuda_build.check_operand("y", y, dev, torch.bfloat16)
    check_bn(bn, C, dev)
    if C % 8:
        raise ValueError(f"the kernel takes C a multiple of 8, got {C}")
    cuda_build.check_device(dev)
    out = torch.empty_like(y)
    cuda_build.launch(
        bn_act, LIB.bn_act_bf16, y.data_ptr(), *(t.data_ptr() for t in bn),
        out.data_ptr(), y.numel(), C, LIB.multiprocessors(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    return out


@cuda_build.counted
def se_residual(y: torch.Tensor, x: torch.Tensor, fc1: Dense, fc2: Dense,
                bn: BN | None = None) -> torch.Tensor:
    """The tail of a tower block on NHWC maps (B, 8, 8, C): ``y`` (the
    second conv's output) through the optional BatchNorm ``bn``, the
    squeeze-excite with ``fc1`` = ((C, H) kernel, (H,) bias) and ``fc2`` =
    ((H, 2C), (2C,)) in the maps' dtype, then ``relu(y * gate + shift +
    x)``; a new map. On a CUDA tensor one launch of
    ``se_residual_kernel`` in ``se_launch_shape``, which takes contiguous
    bfloat16 maps and weights, C a multiple of 8 up to ``MAX_SE_CHANNELS``
    and H up to ``MAX_SE_HIDDEN``; on a CPU tensor
    ``se_residual_plain``."""
    check_map("y", y)
    check_map("x", x, y)
    if y.device.type == "cpu":
        return se_residual_plain(y, x, fc1, fc2, bn)
    B, C = y.shape[0], y.shape[3]
    H = fc1[0].shape[-1]
    dev = y.device
    for name, t, shape in (("y", y, None), ("x", x, None),
                           ("fc1 kernel", fc1[0], (C, H)),
                           ("fc1 bias", fc1[1], (H,)),
                           ("fc2 kernel", fc2[0], (H, 2 * C)),
                           ("fc2 bias", fc2[1], (2 * C,))):
        cuda_build.check_operand(name, t, dev, torch.bfloat16, shape)
    if bn is not None:
        check_bn(bn, C, dev)
    if C % 8 or C > MAX_SE_CHANNELS or not 0 < H <= MAX_SE_HIDDEN:
        raise ValueError(f"the kernel takes C a multiple of 8 up to "
                         f"{MAX_SE_CHANNELS} and H up to {MAX_SE_HIDDEN}, "
                         f"got C {C}, H {H}")
    cuda_build.check_device(dev)
    out = torch.empty_like(y)
    if B == 0:
        return out
    shape = se_launch_shape(B, C, H, LIB.multiprocessors(dev))
    consts = (None, None, None) if bn is None else \
        tuple(t.data_ptr() for t in bn)
    cuda_build.launch(
        se_residual, LIB.se_residual_bf16, y.data_ptr(), x.data_ptr(),
        out.data_ptr(), *consts, fc1[0].data_ptr(), fc1[1].data_ptr(),
        fc2[0].data_ptr(), fc2[1].data_ptr(), B, C, H, shape["grid"],
        shape["waves"], shape["stages"],
        torch.cuda.current_stream(dev).cuda_stream)
    return out
