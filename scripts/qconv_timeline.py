#!/usr/bin/env python3
"""Per-block timeline of the s8 conv kernel (``qconv3x3_kernel``) on the card.

    python3 scripts/qconv_timeline.py

Writes a copy of ``alphazero_torch/csrc/qconv_kernel.cu`` with ``clock64``
stamps at the points of a block's life (barriers set up; each position
quantised by the producer; each consumer's first position received, its
products done, its epilogue done; the first staged input landed), builds it
with ``nvcc`` into ``build/qconv_timeline/``, runs it at 512 positions for
the input conv (cin 3, float32 planes) and a tower conv (128 -> 128, bf16),
checks the output against ``qconv_plain`` and prints, for each stamp, the
median and the largest number of SM cycles after the block's start over the
blocks. The stamps are inserted by text replacement: if the kernel's source
changes where they go, the script stops and names the line it did not find.
Needs one CUDA card and ``nvcc``; nothing else of the repository is changed.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from alphazero_torch.cuda_build import NVCC_FLAGS, _nvcc  # noqa: E402
from alphazero_torch.models import quant  # noqa: E402

SRC = os.path.join(ROOT, "alphazero_torch", "csrc", "qconv_kernel.cu")
OUT = os.path.join(ROOT, "build", "qconv_timeline")
POSITIONS = 512
SLOTS = 64                              # stamps a block

# (text in the source, text that replaces it)
STAMPS = [
    ("  int bulk;                             // each position contiguous: staged",
     "  int bulk;\n  unsigned long long* trace;"),
    ("constexpr int kPositions = 4;",
     "#define TR(i) (a.trace[blockIdx.x * 64 + (i)] = clock64())\n"
     "constexpr int kPositions = 4;"),
    ("  const int tid = threadIdx.x;\n  const bool im2col",
     "  const int tid = threadIdx.x;\n  if (tid == 0) TR(0);\n"
     "  const bool im2col"),
    ("  __syncthreads();                      // the only block-wide barrier",
     "  __syncthreads();\n  if (tid == 0) TR(1);"),
    ("      if (use > 0) mbar_wait(smem_addr(&s.empty[w]), (use - 1) & 1);",
     "      if (use > 0) mbar_wait(smem_addr(&s.empty[w]), (use - 1) & 1);\n"
     "      if (ptid == 0 && n == 0) TR(6);"),
    ("      mbar_arrive(smem_addr(&s.full[w]));\n",
     "      mbar_arrive(smem_addr(&s.full[w]));\n"
     "      if (ptid == 0 && n < 4) TR(2 + n);\n"),
    ("    mbar_wait(smem_addr(&s.full[wg]), it & 1);",
     "    mbar_wait(smem_addr(&s.full[wg]), it & 1);\n"
     "    if ((tid & 127) == 0 && it == 0) TR(8 + wg);"),
    ("    wgmma_wait<0>();\n    fence_accumulators(acc);",
     "    wgmma_wait<0>();\n    fence_accumulators(acc);\n"
     "    if ((tid & 127) == 0 && it == 0) TR(12 + wg);"),
    ("    if (a.acc) {\n#pragma unroll\n      for (int nt",
     "    if ((tid & 127) == 0 && it == 0) TR(16 + wg);\n"
     "    if (a.acc) {\n#pragma unroll\n      for (int nt"),
    ("                void* stream) {",
     "                void* stream, void* trace) {"),
    ("               positions, cin, relu, bulk};",
     "               positions, cin, relu, bulk,\n"
     "               (unsigned long long*)trace};"),
]
NAMES = {1: "barriers set up", 6: "first input in hand",
         **{2 + n: f"position {n} quantised" for n in range(4)},
         **{8 + w: f"consumer {w} starts" for w in range(4)},
         **{12 + w: f"consumer {w} products done" for w in range(4)},
         **{16 + w: f"consumer {w} stored" for w in range(4)}}


def build() -> ctypes.CDLL:
    text = open(SRC).read()
    for old, new in STAMPS:
        if text.count(old) != 1:
            sys.exit(f"qconv_timeline: the kernel source no longer has, once: "
                     f"{old!r}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu, lib = os.path.join(OUT, "qconv_stamped.cu"), os.path.join(
        OUT, "libqconv_stamped.so")
    open(cu, "w").write(text)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib, cu], check=True,
                   stdout=subprocess.DEVNULL)
    handle = ctypes.CDLL(lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    handle.qconv3x3_s8.argtypes = [p, i, ll, ll, ll, ll, p, p, p, p, p, i, p,
                                   i, i, i, i, p, p]
    return handle


def timeline(lib, cin: int, dev) -> None:
    g = torch.Generator().manual_seed(cin)
    qk, scale = quant._quant_weight(torch.randn((3, 3, cin, 128),
                                                generator=g) * 0.1)
    e = {k: v.to(dev) for k, v in
         quant.qconv_entry(qk, scale, torch.zeros(128)).items()}
    if cin == 3:                        # the planes, read in place
        x = (torch.rand((POSITIONS, 3, 8, 8), generator=g) < 0.3).float()
        x = x.to(dev).permute(0, 2, 3, 1)
    else:
        x = (torch.randn((POSITIONS, 8, 8, cin), generator=g) * 2).to(
            dev, torch.bfloat16)
    xs = (x.float().abs().amax() / 127).reshape(())
    out = torch.empty((POSITIONS, 8, 8, 128), dtype=torch.bfloat16,
                      device=dev)
    blocks = -(-POSITIONS // 4)
    trace = torch.zeros((blocks, SLOTS), dtype=torch.int64, device=dev)
    for _ in range(5):                  # the last launch's stamps stay
        rc = lib.qconv3x3_s8(
            x.data_ptr(), int(x.dtype == torch.bfloat16), *x.stride(),
            xs.data_ptr(), e["wk"].data_ptr(), e["scale"].data_ptr(),
            e["bias"].data_ptr(), out.data_ptr(), 1, None, POSITIONS, cin,
            128, 1, torch.cuda.current_stream().cuda_stream,
            trace.data_ptr())
        if rc != 0:
            sys.exit(f"qconv_timeline: launch failed, CUDA error {rc}")
    torch.cuda.synchronize()
    if not torch.equal(out, quant.qconv_plain(x, xs, e, True)):
        sys.exit("qconv_timeline: the stamped kernel differs from qconv_plain")
    t = trace.cpu().numpy()
    rel = t - t[:, :1]
    print(f"cin {cin} -> 128, {POSITIONS} positions, {blocks} blocks: SM "
          f"cycles after the block's start, median and largest")
    for k in sorted(NAMES):
        if (t[:, k] != 0).any():
            col = rel[t[:, k] != 0, k]
            print(f"  {NAMES[k]:28s} {int(np.median(col)):8d} "
                  f"{int(col.max()):8d}")


def main() -> int:
    if not torch.cuda.is_available():
        print("qconv_timeline: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                           "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    lib = build()
    for cin in (3, 128):
        timeline(lib, cin, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
