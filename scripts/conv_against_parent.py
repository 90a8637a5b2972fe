#!/usr/bin/env python3
"""Holds the conv kernel bit for bit to an earlier version of itself on
the card: every launch shape of this tree's ``conv3x3_kernel`` against the
earlier kernel in its own launch rule.

    git show 8aae90f:alphazero_torch/csrc/conv_kernels.cu > /tmp/old.cu
    python3 scripts/conv_against_parent.py /tmp/old.cu

The earlier source is one with the C interface of commit ``8aae90f``
(``conv3x3_bf16(..., grid, half, per, stream)``, pieces of one, two or
four boards and a whole or half tile). It is built with ``nvcc`` into a
temporary directory outside the repository. Inputs: every ``conv3x3`` site of one bf16
forward of the archived net on 512 random-play positions (41 sites,
``chip_smoke.conv_sites``) at 512, 128, 32 and 1 boards, and C 32 and 256
on random maps and weights at 512 and 1 boards, each in its three
epilogues (none, affine, affine and ReLU). Prints the elements compared
and the unequal ones; exits 1 if any element differs. Needs one CUDA card
and ``nvcc``.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from alphazero_torch.cuda_build import NVCC_FLAGS, _nvcc  # noqa: E402

BATCHES = (512, 128, 32, 1)


def build(source: str) -> ctypes.CDLL:
    out = tempfile.mkdtemp(prefix="conv_parent_")
    lib = os.path.join(out, "libconv_parent.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib, source], check=True,
                   stdout=subprocess.DEVNULL)
    handle = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.conv3x3_init.argtypes = [ctypes.POINTER(i)]
    handle.conv3x3_bf16.argtypes = [p] * 6 + [i] * 6 + [p]
    return handle


def parent_shape(B: int, C: int, sms: int):
    """The earlier kernel's launch rule: (grid, half, per)."""
    tiles = C // min(C, 128)
    for per, half in ((1, 1), (1, 0), (2, 0), (4, 0)):
        if half and C < 128:
            continue
        pieces = -(-B // per) * tiles << half
        if pieces <= sms:
            break
    return max(1, min(pieces, sms)), half, per


def main(argv) -> int:
    if not torch.cuda.is_available() or len(argv) != 1:
        print("usage, on a CUDA card: conv_against_parent.py "
              "OLD_CONV_KERNELS_CU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from alphazero_torch.env import breakthrough as env
    from alphazero_torch.models import conv, inference
    from alphazero_torch.models.convert import load_archive
    from alphazero_torch.strength.common import device_line

    dev = torch.device("cuda")
    old = build(argv[0])
    sms = ctypes.c_int(0)
    if old.conv3x3_init(ctypes.byref(sms)) != 0:
        sys.exit("conv_against_parent: the old conv3x3_init failed")
    lib = conv.LIB
    conv.LIB.multiprocessors(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(f"device: {device_line(dev)}", flush=True)

    net = load_archive(cs.ARCHIVE, device=dev)
    prep = inference.prepare_inference(net, torch.bfloat16)
    planes = env.encoded_state(cs.random_positions(cs.GAMES, 81)).to(dev)
    cases = [(x, w, bn, image, BATCHES)
             for x, w, bn, _, image in cs.conv_sites(prep, planes)]
    g = torch.Generator().manual_seed(14)
    for C in (32, 256):
        x = torch.randn((cs.GAMES, 8, 8, C), generator=g).to(
            dev, torch.bfloat16)
        w = (torch.randn((C, C, 3, 3), generator=g) * (9 * C) ** -0.5).to(
            dev, torch.bfloat16, memory_format=torch.channels_last)
        bn = tuple(t.to(dev) for t in (
            torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
            torch.randn(C, generator=g)))
        cases.append((x, w, bn, conv.weight_image(w), (cs.GAMES, 1)))

    counts = {}
    for x, w, bn, image, batches in cases:
        C = x.shape[3]
        for B in batches:
            xb = x[:B].contiguous()
            for epi, (affine, relu) in enumerate(conv.EPILOGUES.values()):
                consts = ((t.data_ptr() for t in bn) if affine
                          else (None,) * 3)
                want = torch.empty_like(xb)
                grid, half, per = parent_shape(B, C, sms.value)
                rc = old.conv3x3_bf16(xb.data_ptr(), image.data_ptr(),
                                      *consts, want.data_ptr(), B, C, epi,
                                      grid, half, per, stream)
                cs.check(rc == 0, f"old kernel: CUDA error {rc}")
                for np_, per in conv.SHAPES[C]:
                    s = conv.launch_in_shape(B, C, np_, per, sms.value)
                    got = torch.empty_like(xb)
                    consts = ((t.data_ptr() for t in bn) if affine
                              else (None,) * 3)
                    rc = lib.conv3x3_bf16(xb.data_ptr(), image.data_ptr(),
                                          *consts, got.data_ptr(), B, C, epi,
                                          s["grid"], np_, per, stream)
                    cs.check(rc == 0, f"kernel: CUDA error {rc}")
                    torch.cuda.synchronize()
                    key = f"C{C} B{B} n{np_}p{per}"
                    n, bad = counts.get(key, (0, 0))
                    counts[key] = (n + got.numel(),
                                   bad + int((got != want).sum()))
    unequal = sum(bad for _, bad in counts.values())
    elements = sum(n for n, _ in counts.values())
    print(json.dumps({"elements": elements, "unequal": unequal,
                      "by_case": counts}), flush=True)
    if unequal:
        print("conv_against_parent: outputs differ", file=sys.stderr)
        return 1
    print(f"every shape bit-equal to the old kernel: {elements} elements, "
          f"{len(cases) - 2} sites x {BATCHES} boards and C 32 and 256 x "
          f"(512, 1), three epilogues", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
