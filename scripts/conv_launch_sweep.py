#!/usr/bin/env python3
"""Times the conv kernel (``models/conv.py:conv3x3``) in every launch
shape at a range of batches, beside cuDNN, and checks that every shape
gives the same bits.

    python3 scripts/conv_launch_sweep.py

For C 128 and 256, random maps and weights from a seed, the affine and
ReLU epilogue, and B from 1 to 512 boards: one JSON line a (C, B) with
``F.conv2d`` (cuDNN, channels-last bf16), each shape ``p<per>h<half>``
(boards a piece, half a tile or not; ``conv.conv_launch_shape``) and the
shape the rule picks, in device ms (``chip_smoke.cuda_ms``). Fails if two
shapes differ in a bit. Needs a CUDA card; about half a minute.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BATCHES = (1, 2, 8, 16, 32, 64, 96, 128, 192, 256, 384, 512)
SHAPES = ((4, 0), (4, 1), (2, 0), (2, 1), (1, 0), (1, 1))


def main():
    import chip_smoke as cs
    from alphazero_torch.models import conv
    from alphazero_torch.strength.common import device_line

    dev = torch.device("cuda")
    lib = conv._lib()
    sms = conv.multiprocessors(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(f"device: {device_line(dev)}", flush=True)
    for C in (128, 256):
        g = torch.Generator().manual_seed(C)
        x = torch.randn((BATCHES[-1], 8, 8, C), generator=g).to(
            dev, torch.bfloat16)
        w = (torch.randn((C, C, 3, 3), generator=g) * (9 * C) ** -0.5).to(
            dev, torch.bfloat16, memory_format=torch.channels_last)
        image = conv.weight_image(w)
        bn = tuple(t.to(dev) for t in (
            torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
            torch.randn(C, generator=g)))
        for B in BATCHES:
            xb = x[:B].contiguous()
            row = {"C": C, "B": B, "cudnn": cs.cuda_ms(
                lambda i: torch.nn.functional.conv2d(
                    xb.permute(0, 3, 1, 2), w, padding=1), what="cuDNN")}
            ref = None
            for per, half in SHAPES:
                out = torch.empty_like(xb)
                pieces = -(-B // per) * (C // 128) << half
                grid = min(pieces, sms)

                def run(i):
                    rc = lib.conv3x3_bf16(
                        xb.data_ptr(), image.data_ptr(),
                        *(t.data_ptr() for t in bn), out.data_ptr(), B, C,
                        2, grid, half, per, stream)
                    cs.check(rc == 0, f"launch failed: CUDA error {rc}")

                run(0)
                torch.cuda.synchronize()
                ref = out.clone() if ref is None else ref
                cs.check(torch.equal(out, ref),
                         f"C {C}, B {B}: shape {per}, {half} differs")
                row[f"p{per}h{half}"] = cs.cuda_ms(run, what="conv3x3")
            shape = conv.conv_launch_shape(B, C, sms)
            row["rule"] = f"p{shape['per']}h{shape['half']}"
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
