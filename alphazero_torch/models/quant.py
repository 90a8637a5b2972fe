"""Post-training int8 inference path for the SE-ResNet.

Port of ``alphazero_tpu/models/quant.py``, with its public names and its
scheme:

- BatchNorm folded into the conv before it (``_fold``);
- conv weights symmetric per output channel in int8, scale = amax/127
  (``_quant_weight``);
- activations symmetric per tensor in int8: DYNAMIC by default (the scale
  from the live batch's amax, a device scalar: the host never reads it),
  or STATIC from ``calibrate`` (one device tensor of 2N+1 scales per
  evaluator);
- the input conv and the 2N tower 3x3 convs in s8 x s8 -> s32, each ONE
  launch of the hand-written kernel in ``csrc/qconv_kernel.cu``
  (``qconv3x3``: quantise on load, exact s32 sums, dequantise, bias and
  ReLU); each block's tail (SE and residual) ONE launch of
  ``epilogue.se_residual`` (``csrc/epilogue_kernels.cu``), with no
  BatchNorm affine since the s8 conv added the folded bias; everything
  else in ``dtype`` (bf16 by default): the policy 3x3 conv, the value 1x1
  conv (``F.conv2d``, as the JAX package left them to XLA) and the dense
  heads; logits in float32.

Activations are NHWC, as in the JAX package, so the dense heads take the
JAX package's (h, w, c)-ordered kernels unchanged. ``QuantParams`` has the
JAX package's structure (``qk`` HWIO int8, ``scale``, ``bias``, the folded
float convs as (HWIO kernel, bias), SE and FC params as {"kernel" (in,
out), "bias"}), with torch tensors, plus each s8 conv's weights in the
kernel's shared-memory image under ``"wk"`` (``wk_smem_image``);
``models/convert.quant_params_from_numpy`` carries the JAX package's
QuantParams across.

``qconv3x3`` launches its kernel on a CUDA tensor or raises; on a CPU
tensor it runs ``qconv_plain``, which rounds as the kernel does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from alphazero_torch import cuda_build
from alphazero_torch.cuda_build import I, LL, P
from alphazero_torch.models import epilogue, fused
from alphazero_torch.models.network import AlphaZeroNet, wl_to_value

LIB = cuda_build.Library(
    "qconv_kernel",
    qconv3x3_s8=[P, I, LL, LL, LL, LL, P, P, P, P, P, I, P, I, I, I, I, P])
# K bytes in a row of the kernel's weight image: at cin 128 one tap, and
# one row of the card's 128-byte shared-memory swizzle
_CHUNK = 128
# what the kernel takes: input channels (3: the input conv, as im2col rows)
# and output channels (the N of its wgmma)
_CINS = (3, 32, 128)
_COUTS = (32, 128)


# -----------------------------------------------------------------------------
# Folding and weight quantisation
# -----------------------------------------------------------------------------

def _fold(kernel: torch.Tensor, bn_p: Dict[str, torch.Tensor],
          bn_s: Dict[str, torch.Tensor], eps: float = 1e-5
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold an inference-mode BatchNorm into the HWIO conv kernel before
    it: (kernel * inv, beta - mean * inv), inv = gamma / sqrt(var + eps)."""
    inv = bn_p["scale"] / torch.sqrt(bn_s["var"] + eps)
    return kernel * inv, bn_p["bias"] - bn_s["mean"] * inv


def _quant_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an HWIO kernel: (qk, scale)."""
    amax = kernel.abs().amax(dim=(0, 1, 2))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(kernel / scale), -127, 127).to(torch.int8)
    return q, scale


def kernel_weights(qk: torch.Tensor) -> torch.Tensor:
    """HWIO int8 (3, 3, cin, cout) -> (cout, K) int8, K-major in the order
    of the kernel's products: k = tap*cin + ci, tap = ky*3 + kx (for cin 3
    the im2col row), zero-padded to a multiple of 128."""
    H, W, cin, cout = qk.shape
    K = H * W * cin
    wk = torch.zeros((cout, -(-K // _CHUNK) * _CHUNK), dtype=torch.int8,
                     device=qk.device)
    wk[:, :K] = qk.reshape(K, cout).T
    return wk


def wk_smem_image(wk: torch.Tensor) -> torch.Tensor:
    """``kernel_weights``' (cout, K) -> the image that the CUDA kernel
    copies into shared memory chunk by chunk and its tensor cores read by
    descriptor: (K/128, cout, 128). A chunk is 128 bytes of K for every
    output channel, stored [cout][128] with the card's 128-byte swizzle:
    the 16-byte piece ``j`` of row ``n`` lies at piece ``j ^ (n % 8)``. So
    element ``[i, n, p*16 + e]`` of the image is ``wk[n, 128*i + (p ^ (n %
    8))*16 + e]``."""
    cout, K = wk.shape
    w = wk.reshape(cout, K // _CHUNK, 8, 16).permute(1, 0, 2, 3)
    n = torch.arange(cout, device=wk.device)[:, None]
    piece = torch.arange(8, device=wk.device)[None, :]
    return w[:, n, piece ^ (n % 8)].reshape(K // _CHUNK, cout,
                                             _CHUNK).contiguous()


def qconv_entry(qk: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One s8 conv of a QuantParams: the JAX package's entry plus its
    weights in the kernel's layout."""
    return {"qk": qk, "scale": scale, "bias": bias,
            "wk": wk_smem_image(kernel_weights(qk))}


# -----------------------------------------------------------------------------
# The s8 conv: plain version and kernel
# -----------------------------------------------------------------------------

def qconv_plain(x: torch.Tensor, xs: torch.Tensor, entry, relu: bool = False,
                out_dtype: torch.dtype = torch.bfloat16,
                sums: bool = False):
    """What ``qconv3x3`` computes, in plain PyTorch. ``x`` is (B, 8, 8, cin),
    any strides; returns (B, 8, 8, cout) contiguous in ``out_dtype``, and
    with ``sums`` also the int32 sums. The sums come from ``F.conv2d`` in
    float64 on the int8 values: exact, since |sum| <= 9*128*127^2 < 2^53
    (float32 is not: 2^24 is smaller)."""
    xq = torch.clamp(torch.round(x.float() / xs), -127, 127)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   entry["qk"].permute(3, 2, 0, 1).double(), padding=1)
    acc = acc.to(torch.int32).permute(0, 2, 3, 1)
    out = (acc.float() * (xs * entry["scale"]) + entry["bias"]).to(out_dtype)
    if relu:
        out = torch.relu(out)
    out = out.contiguous()
    return (out, acc.contiguous()) if sums else out


@cuda_build.counted
def qconv3x3(x: torch.Tensor, xs: torch.Tensor, entry, relu: bool = False,
             out_dtype: torch.dtype = torch.bfloat16, sums: bool = False):
    """s8 x s8 -> s32 3x3 SAME conv of ``x`` (B, 8, 8, cin), float32 or
    bfloat16 with any strides (NCHW planes are read in place through a
    permuted view), quantised on load with the device scalar ``xs``;
    dequantised with ``entry``'s weight scales and bias, ReLU if asked.
    Returns (B, 8, 8, cout) in ``out_dtype`` (bf16 or f32), and with
    ``sums`` the int32 sums too. On a CUDA tensor one launch of
    ``qconv3x3_kernel``, which takes cin 3, 32 or 128, cout 32 or 128 and
    any B >= 1, with ``entry["wk"]`` in ``wk_smem_image``'s form; on a CPU
    tensor ``qconv_plain``."""
    if x.dim() != 4 or tuple(x.shape[1:3]) != (8, 8) \
            or x.shape[3] != entry["qk"].shape[2]:
        raise ValueError(f"qconv3x3 takes (B, 8, 8, {entry['qk'].shape[2]}) "
                         f"activations, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qconv3x3 reads float32 or bfloat16 and writes "
                        f"either, got {x.dtype} -> {out_dtype}")
    if x.device.type == "cpu":
        return qconv_plain(x, xs, entry, relu, out_dtype, sums)

    wk, ws, bias = entry["wk"], entry["scale"], entry["bias"]
    cin, cout = x.shape[3], wk.shape[1] if wk.dim() == 3 else -1
    if cin not in _CINS or cout not in _COUTS \
            or tuple(wk.shape) != (-(-9 * cin // _CHUNK), cout, _CHUNK):
        raise ValueError(f"the kernel takes cin in {_CINS} and cout in "
                         f"{_COUTS}, with int8 weights in wk_smem_image's "
                         f"(ceil(9*cin/128), cout, 128) form; got "
                         f"{tuple(wk.shape)} for cin {cin}")
    dev = x.device
    cuda_build.check_operand("wk", wk, dev, torch.int8,
                             dtype_error=ValueError)
    for name, t, shape in (("xs", xs, None), ("scale", ws, (cout,)),
                           ("bias", bias, (cout,))):
        cuda_build.check_operand(name, t, dev, torch.float32, shape,
                                 aligned=False, dtype_error=ValueError)
    if xs.numel() != 1:
        raise ValueError(f"xs must be a float32 scalar, got "
                         f"{tuple(xs.shape)}")
    cuda_build.check_device(dev)
    if min(x.stride()) < 0:
        raise ValueError("negative strides")
    B = x.shape[0]
    out = torch.empty((B, 8, 8, cout), dtype=out_dtype, device=dev)
    acc = (torch.empty((B, 8, 8, cout), dtype=torch.int32, device=dev)
           if sums else None)
    cuda_build.launch(
        qconv3x3, LIB.qconv3x3_s8, x.data_ptr(),
        int(x.dtype == torch.bfloat16), *x.stride(), xs.data_ptr(),
        wk.data_ptr(), ws.data_ptr(), bias.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), acc.data_ptr() if sums else None,
        B, cin, cout, int(relu), torch.cuda.current_stream(dev).cuda_stream)
    return (out, acc) if sums else out


# -----------------------------------------------------------------------------
# The quantised network
# -----------------------------------------------------------------------------

def _hwio(conv: torch.nn.Conv2d) -> torch.Tensor:
    return conv.weight.detach().float().cpu().permute(2, 3, 1, 0)


def _bn(bn: torch.nn.BatchNorm2d):
    t = lambda v: v.detach().float().cpu()
    return ({"scale": t(bn.weight), "bias": t(bn.bias)},
            {"mean": t(bn.running_mean), "var": t(bn.running_var)})


def _dense(fc: torch.nn.Linear, flattened: bool = False) -> Dict[str, Any]:
    """{"kernel" (in, out), "bias"} of a dense layer; ``flattened``: its
    input is a flattened map, put back in the JAX package's (h, w, c)
    order."""
    kernel = (torch.from_numpy(fused._hwc_dense(fc)) if flattened
              else fc.weight.detach().float().cpu().T.contiguous())
    return {"kernel": kernel, "bias": fc.bias.detach().float().cpu()}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def quantize_network(net: AlphaZeroNet) -> Dict[str, Any]:
    """Fold BN and quantise the net's weights into a QuantParams dict on
    the net's device (folding and rounding run in float32 on the host).
    The int8 evaluator is the SE-ResNet's: any other net raises."""
    if not isinstance(net, AlphaZeroNet):
        raise ValueError(f"the int8 evaluator quantises the SE-ResNet's "
                         f"convolutions; {type(net).__name__} has none "
                         "(the encoder body searches with the bf16 "
                         "evaluator: selfplay_quant 'off')")

    def entry(conv, bn):
        folded, bias = _fold(_hwio(conv), *_bn(bn))
        return qconv_entry(*_quant_weight(folded), bias)

    blocks = [{"conv1": entry(b.conv1, b.bn1), "conv2": entry(b.conv2, b.bn2),
               "se": {"fc1": _dense(b.se.fc1), "fc2": _dense(b.se.fc2)}}
              for b in net.blocks]
    qp = {
        "input": entry(net.input_conv, net.input_bn),
        "blocks": blocks,
        # the policy and value heads stay float, as in the JAX package
        "policy": _fold(_hwio(net.policy_conv), *_bn(net.policy_bn)),
        "policy_fc": _dense(net.policy_fc, flattened=True),
        "value_conv": _fold(_hwio(net.value_conv), *_bn(net.value_bn)),
        "value_fc1": _dense(net.value_fc1, flattened=True),
        "value_fc2": _dense(net.value_fc2),
    }
    return _to(qp, next(net.parameters()).device)


def scale_points(num_blocks: int) -> List[str]:
    """The quantisation points in forward order: ``input``, ``b{i}c1``,
    ``b{i}c2``."""
    return ["input"] + [f"b{i}c{j}" for i in range(num_blocks)
                        for j in (1, 2)]


def _prepare(qp: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """The float weights cast to ``dtype`` once (the float convs OIHW), so
    a forward converts nothing."""
    dense = lambda p: (p["kernel"].to(dtype), p["bias"].to(dtype))
    conv = lambda kb: (kb[0].permute(3, 2, 0, 1).to(dtype).contiguous(),
                       kb[1].to(dtype)[:, None, None])
    return {
        "dtype": dtype, "input": qp["input"],
        "blocks": [(b["conv1"], b["conv2"], dense(b["se"]["fc1"]),
                    dense(b["se"]["fc2"])) for b in qp["blocks"]],
        "policy": conv(qp["policy"]), "policy_fc": dense(qp["policy_fc"]),
        "value_conv": conv(qp["value_conv"]),
        "value_fc1": dense(qp["value_fc1"]),
        "value_fc2": dense(qp["value_fc2"]),
    }


def _amax(x: torch.Tensor) -> torch.Tensor:
    return x.abs().amax().float()


def _qconv(x: torch.Tensor, e: Dict[str, torch.Tensor], dtype: torch.dtype,
           xs: torch.Tensor | None = None, relu: bool = False
           ) -> torch.Tensor:
    """s8 conv of ``x`` with input scale ``xs``: None computes it from the
    live batch on the device, max(amax(|x|), 1e-6) / 127."""
    if xs is None:
        xs = torch.clamp_min(_amax(x), 1e-6) / 127.0
    return qconv3x3(x, xs, e, relu=relu, out_dtype=dtype)


def _float_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
    return torch.relu(y + b).permute(0, 2, 3, 1)


def _forward(prep: Dict[str, Any], planes: torch.Tensor,
             scales: torch.Tensor | None = None,
             collect: list | None = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    dtype = prep["dtype"]

    def xs(x, i, key):
        if collect is not None:
            collect.append((key, _amax(x)))
        return None if scales is None else scales[i]

    x = planes.permute(0, 2, 3, 1)                     # NHWC view, no copy
    x = _qconv(x, prep["input"], dtype, xs(x, 0, "input"), relu=True)
    for i, (c1, c2, fc1, fc2) in enumerate(prep["blocks"]):
        y = _qconv(x, c1, dtype, xs(x, 2 * i + 1, f"b{i}c1"), relu=True)
        y = _qconv(y, c2, dtype, xs(y, 2 * i + 2, f"b{i}c2"))
        x = epilogue.se_residual(y, x, fc1, fc2)

    B = x.shape[0]
    p = _float_conv(x, *prep["policy"]).reshape(B, -1)
    policy_logits = p @ prep["policy_fc"][0] + prep["policy_fc"][1]
    v = _float_conv(x, *prep["value_conv"]).reshape(B, -1)
    v = torch.relu(v @ prep["value_fc1"][0] + prep["value_fc1"][1])
    wl_logits = v @ prep["value_fc2"][0] + prep["value_fc2"][1]
    return policy_logits.float(), wl_logits.float()


def _scale_vector(qp: Dict[str, Any], act_scales) -> torch.Tensor | None:
    """``calibrate``'s {point: scale} as one float32 device tensor in
    forward order."""
    if act_scales is None:
        return None
    dev = qp["input"]["wk"].device
    return torch.stack([torch.as_tensor(act_scales[k], dtype=torch.float32)
                        .to(dev).reshape(())
                        for k in scale_points(len(qp["blocks"]))])


@torch.no_grad()
def quant_apply(qp: Dict[str, Any], planes: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16,
                act_scales: Dict[str, Any] | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 forward: (B, 3, 8, 8) planes -> (policy_logits, wl_logits),
    float32. ``act_scales`` (from ``calibrate``) switches activation
    quantisation from dynamic to static."""
    return _forward(_prepare(qp, dtype), planes,
                    _scale_vector(qp, act_scales))


@torch.no_grad()
def calibrate(qp: Dict[str, Any], planes_batches: List[torch.Tensor],
              margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """Static per-tensor activation scales from calibration data.

    Runs the dynamic int8 forward (in bf16, as the JAX package does) over
    ``planes_batches`` recording each quantisation point's input amax;
    returns {point: scale}, scale = margin * max(max over batches of amax,
    1e-6) / 127, each a device scalar."""
    prep = _prepare(qp, torch.bfloat16)
    dev = qp["input"]["wk"].device
    maxes: Dict[str, torch.Tensor] = {}
    for planes in planes_batches:
        rec: list = []
        _forward(prep, torch.as_tensor(planes).to(dev), None, rec)
        for k, v in rec:
            maxes[k] = torch.maximum(maxes[k], v) if k in maxes else v
    return {k: margin * torch.clamp_min(v, 1e-6) / 127.0
            for k, v in maxes.items()}


def make_quant_evaluator(net: AlphaZeroNet | None,
                         dtype: torch.dtype = torch.bfloat16,
                         act_scales: Dict[str, Any] | None = None,
                         qp: Dict[str, Any] | None = None):
    """Search evaluator (the contract of ``search.make_net_evaluator``)
    over the int8-quantised net: eval_fn(planes) -> (policy_probs, value),
    float32. Pass a precomputed ``qp`` to skip folding and quantising
    again. The float weights are cast and the static scales stacked once,
    here."""
    if qp is None:
        qp = quantize_network(net)
    prep = _prepare(qp, dtype)
    scales = _scale_vector(qp, act_scales)

    @torch.no_grad()
    def eval_fn(planes: torch.Tensor):
        policy_logits, wl_logits = _forward(prep, planes, scales)
        return torch.softmax(policy_logits, dim=-1), wl_to_value(wl_logits)

    return eval_fn
