"""``se_residual_kernel``: a block's tail on B boards' bf16 NHWC maps of C
channels with H hidden SE units: the pool, fc1 (C -> H), ReLU, fc2 (H ->
2C), the sigmoid gate and shift, the skip added and ReLU. Each input and
output byte counted once."""

KERNEL = "se_residual_kernel"


def ops(B: int, C: int, H: int) -> int:
    elementwise = 4 * 64 * C                    # y*gate + shift + x, ReLU
    return B * (64 * C + 2 * C * H + 2 * H * 2 * C + elementwise)


def bytes_moved(B: int, C: int, H: int) -> int:
    maps = 3 * B * 64 * C * 2                   # y and x in, out, bf16
    dense = (C * H + H + H * 2 * C + 2 * C) * 2
    return maps + dense
