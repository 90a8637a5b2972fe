#!/usr/bin/env python3
"""Times the conv kernel (``models/conv.py:conv3x3``) in every launch
shape at a range of batches, beside cuDNN, and checks that every shape
gives the same bits.

    python3 scripts/conv_launch_sweep.py

For C 128 and 256, random maps and weights from a seed, the affine and
ReLU epilogue, and B from 1 to 512 boards: one JSON line a (C, B) with
the bound (``chip_smoke.conv_bound_ms``), the wrapper's launch (the shape
``conv.conv_launch_shape`` picks, ``rule``) and ``F.conv2d`` (cuDNN,
channels-last bf16, the conv alone) timed in turns (kernel, cuDNN, cuDNN,
kernel: ``kernel_turns``, ``cudnn_turns``), then every shape of
``conv.SHAPES[C]`` once, ``n<channels a piece>p<boards a piece>``, and at
C 256 the persistent path (``persistent``), in device ms
(``chip_smoke.cuda_ms``). Fails if two launches differ in a bit. Needs a
CUDA card; about a minute.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BATCHES = (1, 2, 8, 16, 32, 64, 96, 128, 192, 256, 384, 396, 400, 512, 528,
           600, 1031)


def main():
    import chip_smoke as cs
    from alphazero_torch.models import conv
    from alphazero_torch.strength.common import device_line

    dev = torch.device("cuda")
    lib = conv.LIB
    sms = conv.LIB.multiprocessors(dev)
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
            xb_cl = xb.permute(0, 3, 1, 2)
            shape = conv.conv_launch_shape(B, C, sms)
            kernel = lambda i: conv.conv3x3(xb, w, bn, True, image)
            cudnn = lambda i: torch.nn.functional.conv2d(xb_cl, w, padding=1)
            turns = [cs.cuda_ms(kernel, what="conv3x3"),
                     cs.cuda_ms(cudnn, what="cuDNN"),
                     cs.cuda_ms(cudnn, what="cuDNN"),
                     cs.cuda_ms(kernel, what="conv3x3")]
            rule = "persistent" if shape["path"] == "persistent" else \
                f"n{shape['np']}p{shape['per']}"
            row = {"C": C, "B": B, "bound": cs.conv_bound_ms(B, C)[0],
                   "rule": rule,
                   "kernel": (turns[0] + turns[3]) / 2,
                   "cudnn": (turns[1] + turns[2]) / 2,
                   "kernel_turns": [turns[0], turns[3]],
                   "cudnn_turns": [turns[1], turns[2]]}
            ref = conv.conv3x3(xb, w, bn, True, image)
            for np_, per in conv.SHAPES[C]:
                out = torch.empty_like(xb)
                s = conv.launch_in_shape(B, C, np_, per, sms)

                def run(i):
                    rc = lib.conv3x3_bf16(
                        xb.data_ptr(), image.data_ptr(),
                        *(t.data_ptr() for t in bn), out.data_ptr(), B, C,
                        2, s["grid"], np_, per, stream)
                    cs.check(rc == 0, f"launch failed: CUDA error {rc}")

                run(0)
                torch.cuda.synchronize()
                cs.check(torch.equal(out, ref),
                         f"C {C}, B {B}: shape n{np_}p{per} differs from "
                         f"the rule's {rule}")
                row[f"n{np_}p{per}"] = cs.cuda_ms(run, what="conv3x3")
            if C == conv.PERSISTENT_C:
                out = torch.empty_like(xb)
                s = conv.persistent_launch(B, sms)

                def run(i):
                    rc = lib.conv3x3_persistent_bf16(
                        xb.data_ptr(), image.data_ptr(),
                        *(t.data_ptr() for t in bn), out.data_ptr(), B, 2,
                        s["grid"], stream)
                    cs.check(rc == 0, f"launch failed: CUDA error {rc}")

                run(0)
                torch.cuda.synchronize()
                cs.check(torch.equal(out, ref),
                         f"C {C}, B {B}: the persistent path differs from "
                         f"the rule's {rule}")
                row["persistent"] = cs.cuda_ms(run, what="conv3x3")
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
