"""The encoder body's bf16 search evaluator.

``prepare`` casts ``EncoderNet``'s weights once, on the net's device, into
the layout ``apply`` reads: every dense matrix as (in, out) in the
evaluator's dtype, the Q, K and V projections packed into one E x 3E
matrix (and the attention policy's q and k into one), the input stage's
position term ``W_emb[3:] + b_emb`` summed once in float32, and ``W_gen``
as the (4096, G) matrix that ``attention.smolgen_attention`` takes (on a
card also packed once into the kernel's ``attention.wgen_image``); on a
card the feed-forward's first matrix and the policy embedding's are also
packed once into ``dense_mish``'s ``encoder_epilogue.dense_image``.

``apply`` runs the forward on the (B*64, E) token rows, copying nothing
from the host, so a search captures it as it captures the SE evaluator.
The dense layers are bf16 matrix products with float32 sums (cuBLAS on
the card), biases added by ``addmm``. The feed-forward's first product
and the policy embedding, each with its bias and the Mish after it, are
one ``dense_mish`` launch on the card (``models/encoder_epilogue.py``:
float32 sums, Mish on the float32 sum, one rounding to bf16), 16 a
forward. The DeepNorm residual ``o + alpha x`` and the LayerNorm after
it, twice a layer, are one ``deepnorm_ln`` launch on the card (the sum
rounded to bf16, float32 statistics); smolgen's LayerNorms are PyTorch's
own ``layer_norm``, the input stage's and the value head's ``mish`` and
smolgen's ``silu`` PyTorch's; the attention with its smolgen bias is one
``smolgen_attention`` launch a layer. On the CPU the same code runs with
the plain versions, the attention's, ``dense_mish_plain`` and
``torch.add`` then ``layer_norm``, in any float dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from alphazero_torch.models.attention import smolgen_attention, wgen_image
from alphazero_torch.models.encoder import LN_EPS, TOKENS, EncoderNet
from alphazero_torch.models.encoder_epilogue import (deepnorm_ln,
                                                      dense_image,
                                                      dense_mish)


def prepare(net: EncoderNet, dtype: torch.dtype = torch.bfloat16
            ) -> Dict[str, Any]:
    """``net``'s weights for ``apply`` in ``dtype`` on the net's device: a
    snapshot that later training does not change."""
    dev = next(net.parameters()).device

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(device=dev, dtype=dtype, copy=True).contiguous()

    def dense(*fcs: torch.nn.Linear) -> Tuple[torch.Tensor, torch.Tensor]:
        """(in, out) matrix of the layers side by side, and their biases."""
        w = torch.cat([fc.weight.detach().T for fc in fcs], 1)
        b = torch.cat([fc.bias.detach() for fc in fcs])
        return cast(w), cast(b)

    def ln(m: torch.nn.LayerNorm) -> Tuple[torch.Tensor, torch.Tensor]:
        return cast(m.weight), cast(m.bias)

    def dense_with_image(fc: torch.nn.Linear) -> Tuple[torch.Tensor, ...]:
        """``dense(fc)`` and, on a card, ``dense_mish``'s packed image."""
        w, b = dense(fc)
        return w, b, dense_image(w) if dev.type == "cuda" else None

    planes = net.embed.in_features - TOKENS
    emb = net.embed.weight.detach().float()
    layers = [{
        "compress": cast(layer.sg_compress.weight.T),
        "sg1": dense(layer.sg_dense1), "sg_ln1": ln(layer.sg_ln1),
        "sg2": dense(layer.sg_dense2), "sg_ln2": ln(layer.sg_ln2),
        "qkv": dense(layer.q, layer.k, layer.v), "o": dense(layer.o),
        "ln1": ln(layer.ln1), "ffn1": dense_with_image(layer.ffn1),
        "ffn2": dense(layer.ffn2), "ln2": ln(layer.ln2),
    } for layer in net.layers]
    wgen_t = cast(net.smolgen_gen.weight)
    return {
        "dtype": dtype, "heads": net.layers[0].heads, "alpha": net.alpha,
        "embed": cast(emb[:, :planes].T),
        "position": cast(emb[:, planes:].T + net.embed.bias.detach().float()),
        "gate_mult": cast(net.gate_mult), "gate_add": cast(net.gate_add),
        "layers": layers,
        "wgen_t": wgen_t,
        "wgen_image": wgen_image(wgen_t) if dev.type == "cuda" else None,
        "policy_embed": dense_with_image(net.policy_embed),
        "policy_qk": dense(net.policy_q, net.policy_k),
        "policy_index": net.policy_index.to(dev),
        "policy_valid": net.policy_valid.to(dev, torch.float32),
        "value_embed": dense(net.value_embed),
        "value_fc1": dense(net.value_fc1), "value_fc2": dense(net.value_fc2),
    }


def _dense(x: torch.Tensor, p) -> torch.Tensor:
    return torch.addmm(p[1], x, p[0])


def _ln(x: torch.Tensor, p) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[0], p[1], LN_EPS)


@torch.no_grad()
def apply(prep: Dict[str, Any], planes: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, 8, 8) planes -> (policy_logits (B, 192), wl_logits (B, 2)),
    float32, through the weights of ``prepare``."""
    B, dt, H = planes.shape[0], prep["dtype"], prep["heads"]
    tokens = planes.flatten(2).transpose(1, 2).to(dt)           # (B, 64, 3)
    x = F.mish(torch.matmul(tokens, prep["embed"]) + prep["position"])
    x = torch.addcmul(prep["gate_add"], x, prep["gate_mult"])
    x = x.reshape(B * TOKENS, -1)
    for L in prep["layers"]:
        c = (x @ L["compress"]).view(B, -1)
        h = _ln(F.silu(_dense(c, L["sg1"])), L["sg_ln1"])
        s = _ln(F.silu(_dense(h, L["sg2"])), L["sg_ln2"]).view(B, H, -1)
        a = smolgen_attention(_dense(x, L["qkv"]), s, prep["wgen_t"], H,
                              prep["wgen_image"])
        x = deepnorm_ln(_dense(a, L["o"]), x, prep["alpha"], *L["ln1"])
        f = _dense(dense_mish(x, *L["ffn1"]), L["ffn2"])
        x = deepnorm_ln(f, x, prep["alpha"], *L["ln2"])

    p = dense_mish(x, *prep["policy_embed"])
    qk = _dense(p, prep["policy_qk"]).view(B, TOKENS, -1)
    P = qk.shape[-1] // 2
    logits = torch.bmm(qk[..., :P], qk[..., P:].transpose(1, 2)).float()
    logits = (logits.flatten(1)[:, prep["policy_index"]]
              * (prep["policy_valid"] / math.sqrt(P)))
    v = F.mish(_dense(x, prep["value_embed"])).view(B, -1)
    v = F.mish(_dense(v, prep["value_fc1"]))
    return logits, _dense(v, prep["value_fc2"]).float()
