"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A share of one
is stated with the card's power limit beside it."""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12

# a configuration's "precision" name -> its dense peak
FLOPS = {"bfloat16": BF16_FLOPS, "tf32": TF32_FLOPS, "float32": FP32_FLOPS,
         "int8": INT8_OPS}
