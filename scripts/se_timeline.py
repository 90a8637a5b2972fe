#!/usr/bin/env python3
"""Per-warpgroup timeline of the block-tail kernel (``se_residual_kernel``)
on the card.

    python3 scripts/se_timeline.py

Writes a copy of ``alphazero_torch/csrc/epilogue_kernels.cu`` with
``clock64`` stamps at the points of a warpgroup's first board (the block's
barriers set up; the board's y loaded and its column sums written; pooled,
the weights in hand, fc1, fc2, x landed, the board written) and at the
warpgroup's end, builds it with ``nvcc`` into ``build/se_timeline/``, runs
it with the wrapper's launch shape at 1, 128 and 512 boards of C 128 and
H 16 (the archived net's widths, with bn2) and at 512 without it (the int8
tail), checks each output bit-equal to the unstamped kernel's, and prints,
for each stamp, the median and the largest number of SM cycles after the
warpgroup's start over the warpgroups, beside the unstamped kernel's
device time (CUDA events around 50 launches queued behind a device sleep).
The stamps are inserted by text replacement: if the kernel's source
changes where they go, the script stops and names the text it did not
find. Needs one CUDA card and ``nvcc``; nothing else of the repository is
changed.
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
from alphazero_torch.models import epilogue  # noqa: E402

SRC = os.path.join(ROOT, "alphazero_torch", "csrc", "epilogue_kernels.cu")
OUT = os.path.join(ROOT, "build", "se_timeline")
SLOTS = 16                              # stamps a warpgroup
C, H = 128, 16

_FIRST = "if (t == 0 && i == 0) TR({});"
# (text in the source, text that replaces it)
STAMPS = [
    ("  int own;                              // stages a warpgroup",
     "  int own;\n  unsigned long long* trace;"),
    ("template <int KMAX, int CC, int HH>\n__global__",
     "#define TR(k) (a.trace[(blockIdx.x * 4 + wave) * 16 + (k)] = "
     "clock64())\ntemplate <int KMAX, int CC, int HH>\n__global__"),
    ("  const int wave = tid >> 7, t = tid & 127, bar_id = 1 + wave;\n",
     "  const int wave = tid >> 7, t = tid & 127, bar_id = 1 + wave;\n"
     "  if (t == 0) TR(0);\n"),
    ("  __syncthreads();                      // the only block-wide barrier",
     "  __syncthreads();\n  if (t == 0) TR(1);"),
    ("    wave_sync(bar_id);\n\n    // the pool:",
     "    wave_sync(bar_id);\n    " + _FIRST.format(3) + "\n    // the pool:"),
    ("    wave_sync(bar_id);\n\n    // fc1:",
     "    wave_sync(bar_id);\n    " + _FIRST.format(4) + "\n    // fc1:"),
    ("    if (i == 0) mbar_wait(smem_addr(w_full), 0);",
     "    if (i == 0) mbar_wait(smem_addr(w_full), 0);\n    "
     + _FIRST.format(5)),
    ("    wave_sync(bar_id);\n\n    // fc2,",
     "    wave_sync(bar_id);\n    " + _FIRST.format(6) + "\n    // fc2,"),
    ("    wave_sync(bar_id);\n\n    // out =",
     "    wave_sync(bar_id);\n    " + _FIRST.format(7) + "\n    // out ="),
    ("    mbar_wait(smem_addr(&x_full[s]), parity);",
     "    mbar_wait(smem_addr(&x_full[s]), parity);\n    "
     + _FIRST.format(8)),
    ("    // the stage is read:",
     "    " + _FIRST.format(9) + "\n    // the stage is read:"),
    ("        fetch_x(i + own);\n      }\n    }\n  }\n}",
     "        fetch_x(i + own);\n      }\n    }\n  }\n"
     "  if (t == 0) TR(10);\n}"),
    ("                     int waves, int stages, void* stream) {",
     "                     int waves, int stages, void* stream, "
     "void* trace) {"),
    ("                 boards, C, H, waves, stages / waves};",
     "                 boards, C, H, waves, stages / waves,\n"
     "                 (unsigned long long*)trace};"),
]
NAMES = {1: "barriers set up", 3: "y in, column sums written",
         4: "pooled", 5: "weights in hand", 6: "fc1 done", 7: "fc2 done",
         8: "x landed", 9: "first board written", 10: "last board written"}


def build() -> ctypes.CDLL:
    text = open(SRC).read()
    for old, new in STAMPS:
        if text.count(old) != 1:
            sys.exit(f"se_timeline: the kernel source no longer has, once: "
                     f"{old!r}")
        text = text.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu, lib = os.path.join(OUT, "se_stamped.cu"), os.path.join(
        OUT, "libse_stamped.so")
    open(cu, "w").write(text)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", lib, cu], check=True,
                   stdout=subprocess.DEVNULL)
    handle = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.se_residual_init.argtypes = [ctypes.POINTER(i)]
    handle.se_residual_bf16.argtypes = [p] * 10 + [i] * 6 + [p, p]
    return handle


def device_ms(fn, iters=50):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(60 * 2_000_000))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timeline(lib, B: int, affine: bool, sms: int, dev) -> None:
    g = torch.Generator().manual_seed(B)
    y = (torch.randn((B, 8, 8, C), generator=g) * 2).to(dev, torch.bfloat16)
    x = torch.randn((B, 8, 8, C), generator=g).relu().to(dev, torch.bfloat16)
    w = lambda *s: (torch.randn(s, generator=g) * 0.3).to(dev, torch.bfloat16)
    fc1, fc2 = (w(C, H), w(H)), (w(H, 2 * C), w(2 * C))
    bn = tuple((torch.rand(C, generator=g) + 0.5).to(dev)
               for _ in range(3)) if affine else None
    consts = (None,) * 3 if bn is None else tuple(t.data_ptr() for t in bn)
    shape = epilogue.se_launch_shape(B, C, H, sms)
    trace = torch.zeros((shape["grid"] * 4, SLOTS), dtype=torch.int64,
                        device=dev)
    out = torch.empty_like(y)
    for _ in range(5):                  # the last launch's stamps stay
        rc = lib.se_residual_bf16(
            y.data_ptr(), x.data_ptr(), out.data_ptr(), *consts,
            fc1[0].data_ptr(), fc1[1].data_ptr(), fc2[0].data_ptr(),
            fc2[1].data_ptr(), B, C, H, shape["grid"], shape["waves"],
            shape["stages"], torch.cuda.current_stream().cuda_stream,
            trace.data_ptr())
        if rc != 0:
            sys.exit(f"se_timeline: launch failed, CUDA error {rc}")
    torch.cuda.synchronize()
    want = epilogue.se_residual(y, x, fc1, fc2, bn)
    if not torch.equal(out, want):
        sys.exit("se_timeline: the stamped kernel differs from se_residual")
    ms = device_ms(lambda: epilogue.se_residual(y, x, fc1, fc2, bn))
    t = trace.cpu().numpy()
    t = t[t[:, 0] != 0]
    rel = t - t[:, :1]
    print(f"{B} boards, C {C}, H {H}, {'bn2' if affine else 'no affine'}: "
          f"{shape}; unstamped kernel {ms:.7f} ms on the device; SM cycles "
          f"after a warpgroup's start, median and largest over "
          f"{len(t)} warpgroups")
    for k in sorted(NAMES):
        if (t[:, k] != 0).any():
            col = rel[t[:, k] != 0, k]
            print(f"  {NAMES[k]:22s} {int(np.median(col)):8d} "
                  f"{int(col.max()):8d}")


def main() -> int:
    if not torch.cuda.is_available():
        print("se_timeline: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                           "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    lib = build()
    sms = ctypes.c_int(0)
    if lib.se_residual_init(ctypes.byref(sms)) != 0:
        sys.exit("se_timeline: se_residual_init failed")
    for B, affine in ((1, True), (128, True), (512, True), (512, False)):
        timeline(lib, B, affine, sms.value, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
