"""Leela Chess Zero's BT4 attention body: the port's second network family.

The transformer that replaced the T40-style SE-ResNets in Lc0's training
runs (``BT4-1024x15x32h``; lczero-training, ``tf/tfprocess.py``: the
attention body, ``smolgen``, the DeepNorm encoder layers and the attention
policy head), fitted to Breakthrough. A board is T = 64 tokens, one a
square of the canonical frame of ``env.encoded_state`` (square s = 8r + c
holds the planes at row r, column c). With E the embedding, H heads of
D = E / H, F the feed-forward width and N layers:

- input: ``x = mish([planes_s ; onehot(s)] W_emb + b_emb)`` (Breakthrough's
  3 planes and a position term in place of chess's 112-plane input
  stage), then Lc0's input gates ``x = x * gate_mult[s] + gate_add[s]``;
- N encoder layers, each:

  - smolgen: ``c = x W_c`` (E -> ``smolgen_compress`` a square, no bias),
    flattened over the board; ``h1 = LN(swish(c W_1 + b_1))``
    (``smolgen_hidden``); ``h2 = LN(swish(h1 W_2 + b_2))`` (H x
    ``smolgen_gen``, one LayerNorm over the whole vector); head h's 64 x 64
    bias is ``h2_h W_gen``, with ``W_gen`` (``smolgen_gen`` x 4096, no
    bias) one matrix shared by all layers;
  - attention: ``softmax(Q_h K_h^T / sqrt(D) + S_h) V_h``, heads
    concatenated, then ``W_o``;
  - DeepNorm residuals, post-LayerNorm with the skip scaled by
    ``alpha = (2N)^(1/4)``: ``x = LN1(alpha x + attn)``, ``x =
    LN2(alpha x + W_2f mish(W_1f x))``;

- policy (Lc0's attention policy): ``p = mish(x W_p + b)``, ``q = p W_q +
  b``, ``k = p W_k + b``, ``L = q k^T / sqrt(P)``; the logit of action a =
  3s + d is ``L[s, to(s, d)]`` with ``to(s, d) = 8(r + 1) + c + (0, -1,
  +1)[d]`` in ``env.decode_action_to_move``'s order; an action whose target
  is off the board takes logit 0 (it is never legal);
- value: ``mish(x W_v + b)`` to 32 a square, flattened, ``mish(. W + b)`` to
  128, then 2 win/loss logits: the SE net's value-head widths.

LayerNorm's epsilon is 1e-3, as Lc0's. Initialisation follows DeepNet:
every dense matrix N(0, 1/fan_in), those of V, O and the feed-forward
layers times ``beta = (8N)^(-1/4)``; biases 0, LayerNorms and gates 1 and 0.

This module is the float32 net: what the learner trains and what the CPU
evaluates. The bf16 search evaluator on the card is
``models/encoder_inference.py``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-3
TOKENS = 64


def deepnorm_alpha(layers: int) -> float:
    return (2.0 * layers) ** 0.25


def deepnet_beta(layers: int) -> float:
    return (8.0 * layers) ** -0.25


def policy_gather_index(board_size: int = 8) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(index into the flattened 64 x 64 map, on-board mask) of each of
    the 192 actions: action 3s + d reads ``L[s, to(s, d)]``; an action
    whose target is off the board reads index 0 and is masked to 0."""
    index, valid = [], []
    for s in range(board_size * board_size):
        r, c = divmod(s, board_size)
        for dc in (0, -1, 1):
            tr, tc = r + 1, c + dc
            ok = tr < board_size and 0 <= tc < board_size
            index.append(s * TOKENS + tr * board_size + tc if ok else 0)
            valid.append(ok)
    return torch.tensor(index), torch.tensor(valid)


class EncoderLayer(nn.Module):
    def __init__(self, embed: int, heads: int, ffn: int, compress: int,
                 hidden: int, gen: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(embed, embed)
        self.k = nn.Linear(embed, embed)
        self.v = nn.Linear(embed, embed)
        self.o = nn.Linear(embed, embed)
        self.ln1 = nn.LayerNorm(embed, eps=LN_EPS)
        self.ffn1 = nn.Linear(embed, ffn)
        self.ffn2 = nn.Linear(ffn, embed)
        self.ln2 = nn.LayerNorm(embed, eps=LN_EPS)
        self.sg_compress = nn.Linear(embed, compress, bias=False)
        self.sg_dense1 = nn.Linear(TOKENS * compress, hidden)
        self.sg_ln1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.sg_dense2 = nn.Linear(hidden, heads * gen)
        self.sg_ln2 = nn.LayerNorm(heads * gen, eps=LN_EPS)

    def smolgen(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 64, E) -> the (B, H, gen) vectors that ``W_gen`` turns into
        each head's attention bias."""
        B = x.shape[0]
        c = self.sg_compress(x).reshape(B, -1)
        h = self.sg_ln1(F.silu(self.sg_dense1(c)))
        h = self.sg_ln2(F.silu(self.sg_dense2(h)))
        return h.view(B, self.heads, -1)

    def forward(self, x: torch.Tensor, gen: nn.Linear,
                alpha: float) -> torch.Tensor:
        B, T, E = x.shape
        H = self.heads
        D = E // H
        bias = gen(self.smolgen(x)).view(B, H, T, T)
        q, k, v = (f(x).view(B, T, H, D).transpose(1, 2)
                   for f in (self.q, self.k, self.v))
        logits = q @ k.transpose(-1, -2) / math.sqrt(D) + bias
        a = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(B, T, E)
        x = self.ln1(alpha * x + self.o(a))
        return self.ln2(alpha * x + self.ffn2(F.mish(self.ffn1(x))))


class EncoderNet(nn.Module):
    """Policy (192 logits) + win/loss (2 logits) network on BT4's body.

    Input: (B, 3, 8, 8) float planes (mine / theirs / ones, mover's side).
    Output logits are float32."""

    def __init__(self, layers: int = 15, embed: int = 1024, heads: int = 32,
                 ffn: int = 1536, compress: int = 32, hidden: int = 256,
                 gen: int = 256, policy_embed: int = 1024,
                 num_actions: int = 192, input_planes: int = 3,
                 board_size: int = 8):
        super().__init__()
        if embed % heads:
            raise ValueError(f"embed {embed} is not a multiple of heads "
                             f"{heads}")
        if (num_actions, board_size) != (192, 8):
            raise ValueError("the attention policy maps Breakthrough's 192 "
                             "actions on an 8 x 8 board")
        self.alpha = deepnorm_alpha(layers)
        self.embed = nn.Linear(input_planes + TOKENS, embed)
        self.gate_mult = nn.Parameter(torch.ones(TOKENS, embed))
        self.gate_add = nn.Parameter(torch.zeros(TOKENS, embed))
        self.layers = nn.ModuleList(
            EncoderLayer(embed, heads, ffn, compress, hidden, gen)
            for _ in range(layers))
        self.smolgen_gen = nn.Linear(gen, TOKENS * TOKENS, bias=False)
        self.policy_embed = nn.Linear(embed, policy_embed)
        self.policy_q = nn.Linear(policy_embed, policy_embed)
        self.policy_k = nn.Linear(policy_embed, policy_embed)
        self.value_embed = nn.Linear(embed, 32)
        self.value_fc1 = nn.Linear(TOKENS * 32, 128)
        self.value_fc2 = nn.Linear(128, 2)
        index, valid = policy_gather_index(board_size)
        self.register_buffer("policy_index", index, persistent=False)
        self.register_buffer("policy_valid", valid, persistent=False)
        self.register_buffer("onehot", torch.eye(TOKENS), persistent=False)
        self._init_deepnet(layers)

    def _init_deepnet(self, layers: int) -> None:
        beta = deepnet_beta(layers)
        scaled = {id(m) for layer in self.layers
                  for m in (layer.v, layer.o, layer.ffn1, layer.ffn2)}
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    std = m.in_features ** -0.5
                    m.weight.normal_(0.0, std * (beta if id(m) in scaled
                                                 else 1.0))
                    if m.bias is not None:
                        m.bias.zero_()

    def forward(self, planes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = planes.shape[0]
        tokens = planes.flatten(2).transpose(1, 2)              # (B, 64, 3)
        onehot = self.onehot.to(tokens.dtype).expand(B, -1, -1)
        x = F.mish(self.embed(torch.cat([tokens, onehot], -1)))
        x = x * self.gate_mult + self.gate_add
        for layer in self.layers:
            x = layer(x, self.smolgen_gen, self.alpha)

        p = F.mish(self.policy_embed(x))
        q, k = self.policy_q(p), self.policy_k(p)
        L = (q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])).flatten(1)
        policy_logits = L[:, self.policy_index] * self.policy_valid

        v = F.mish(self.value_embed(x)).flatten(1)
        v = F.mish(self.value_fc1(v))
        wl_logits = self.value_fc2(v)
        return policy_logits.float(), wl_logits.float()


def encoder_from_config(cfg) -> EncoderNet:
    return EncoderNet(cfg.enc_layers, cfg.enc_embed, cfg.enc_heads,
                      cfg.enc_ffn, cfg.smolgen_compress, cfg.smolgen_hidden,
                      cfg.smolgen_gen, cfg.enc_policy_embed, cfg.num_actions,
                      cfg.input_planes, cfg.board_size)
