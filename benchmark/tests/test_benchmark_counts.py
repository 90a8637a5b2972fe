"""The yardstick's counts against hand counts, for both configurations."""

import json
import os

import pytest

from benchmark.lib import flops, weights
from benchmark.rooflines import conv3x3, se_residual

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,want", [
    # 41 3x3 convs of 2*64*9*C*C, the input conv 2*64*9*3*C, the value
    # conv 2*64*C*32, the policy dense 2*64*C*192, the value dense
    # 2*2048*128 + 2*128*2, the SE dense 20 * (2*C*H + 2*H*2C)
    ("az-20x128-se", 41 * 18_874_368 + 442_368 + 524_288 + 3_145_728
     + 524_288 + 512 + 20 * 12_288),
    ("lc0-20x256-se", 41 * 75_497_472 + 884_736 + 1_048_576 + 6_291_456
     + 524_288 + 512 + 20 * 49_152),
])
def test_forward_flops_match_the_hand_count(name, want):
    cfg = config(name)
    assert flops.forward_flops(cfg) == want
    assert flops.train_flops(cfg) == 3 * want


def test_flagship_forward_is_778_7_mflop_a_board():
    assert flops.forward_flops(config("az-20x128-se")) == 778_732_032


def test_flagship_parameter_count():
    cfg = config("az-20x128-se")
    shapes = weights.leaf_shapes(cfg["num_blocks"], cfg["num_filters"],
                                 cfg["se_ratio"])
    assert weights.count_params(shapes) == cfg["parameters"] == 8_027_970


@pytest.mark.parametrize("B,C,ops,nbytes", [
    # 2*B*64*9*C*C; x and y bf16 (2*B*64*C*2), weights 9*C*C*2, affine 3*C*4
    (512, 128, 9_663_676_416, 16_777_216 + 294_912 + 1_536),
    (1, 128, 18_874_368, 32_768 + 294_912 + 1_536),
    (512, 256, 38_654_705_664, 33_554_432 + 1_179_648 + 3_072),
])
def test_conv3x3_ops_and_bytes(B, C, ops, nbytes):
    assert conv3x3.ops(B, C) == ops
    assert conv3x3.bytes_moved(B, C) == nbytes


@pytest.mark.parametrize("B,C,H,nbytes", [
    # y, x in and the output, bf16: 3*B*64*C*2; fc1, fc2 and biases bf16
    (512, 128, 16, 25_165_824 + 2 * (2048 + 16 + 4096 + 256)),
    (512, 256, 32, 50_331_648 + 2 * (8192 + 32 + 16384 + 512)),
])
def test_se_residual_bytes(B, C, H, nbytes):
    assert se_residual.bytes_moved(B, C, H) == nbytes
    # pool, two dense layers and four elementwise operations an element
    assert se_residual.ops(B, C, H) == B * (64 * C + 6 * C * H + 256 * C)
