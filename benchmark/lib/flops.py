"""Model FLOPs of one evaluated board, from a configuration's shapes.

A multiply-add counts two. Counted: every convolution and dense layer
(the input conv, two 3x3 convs a block, the SE block's two dense layers,
the policy conv and dense layer, the value conv and two dense layers).
Not counted: BatchNorm, activations, pooling, the residual add and the
softmaxes, which are elementwise."""

BOARD = 64


def forward_flops(cfg: dict) -> int:
    C = cfg["num_filters"]
    H = C // cfg["se_ratio"]
    P = cfg.get("input_planes", 3)
    A = cfg.get("num_actions", 192)
    conv3 = 2 * BOARD * 9 * C * C
    block = 2 * conv3 + 2 * C * H + 2 * H * 2 * C
    return (2 * BOARD * 9 * P * C                 # input conv
            + cfg["num_blocks"] * block
            + conv3 + 2 * BOARD * C * A           # policy head
            + 2 * BOARD * C * 32                  # value conv 1x1
            + 2 * BOARD * 32 * 128 + 2 * 128 * 2)  # value dense layers


def train_flops(cfg: dict) -> int:
    """A training example: the forward and a backward of twice its
    FLOPs."""
    return 3 * forward_flops(cfg)
