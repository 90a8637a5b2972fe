"""``smolgen_attention_kernel``: one encoder layer's attention of B boards
with its smolgen bias (H heads of D, G smolgen values a head, 64 tokens, E
= H D). Counted: the bias product (2 G 64^2 a head), Q K^T and P V (2 64^2
D each); each input byte once (Q, K and V of the packed projection, the
smolgen vectors, W_gen) and the output, all bf16."""

KERNEL = "smolgen_attention_kernel"
T = 64


def ops(B: int, H: int, D: int, G: int) -> int:
    return B * H * (2 * G * T * T + 4 * T * T * D)


def bytes_moved(B: int, H: int, D: int, G: int) -> int:
    E = H * D
    return 2 * (3 * B * T * E + B * H * G + G * T * T + B * T * E)
