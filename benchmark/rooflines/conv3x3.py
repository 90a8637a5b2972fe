"""``conv3x3_kernel``: a SAME 3x3 convolution of B boards' bf16 NHWC maps,
C channels in and out, with the BatchNorm's float32 (mean, mul, beta) as
its epilogue. Each input and output byte counted once."""

KERNEL = "conv3x3_kernel"


def ops(B: int, C: int) -> int:
    return 2 * B * 64 * 9 * C * C


def bytes_moved(B: int, C: int) -> int:
    maps = 2 * B * 64 * C * 2                  # x in, y out, bf16
    return maps + 9 * C * C * 2 + 3 * C * 4    # weights bf16, affine f32
