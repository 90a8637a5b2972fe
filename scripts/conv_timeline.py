#!/usr/bin/env python3
"""Per-block timeline of the bf16 conv kernel (``conv3x3_kernel``) on the
card.

    python3 scripts/conv_timeline.py [B ...]

Builds ``alphazero_torch/csrc/conv_kernels.cu`` with ``-DCONV_TIMELINE``
into ``build/conv_timeline/``: each block then writes ``%globaltimer``
(ns) and ``clock64`` (SM cycles) at the points the kernel stamps (its
start, its barriers set up, each weight chunk's copy issued and its wait
returned, the kernel ahead finished (``griddepcontrol.wait`` returned),
the board's rows in shared memory, the last ``wgmma_wait<0>``,
the BatchNorm constants in, the stores done; the first piece of each
block). For each batch (by default 1, 32, 128 and 512 boards) at C 128
with the affine and ReLU, the wrapper's launch shape, it launches the
stamped kernel ``LAUNCHES`` times back to back, queued behind a device
sleep as ``chip_smoke.cuda_ms`` queues them, checks every output
bit-equal to the unstamped ``conv.conv3x3``, and prints for each stamp
the median and the largest ns after the block's start over the blocks of
the last launch (SM cycles beside), the launch's span (first start to
last store), the gap from one launch's last store to the next one's first
start and to its wait's return, the period from one launch's last store
to the next one's, and the unstamped kernel's device time
(``chip_smoke.cuda_ms``).
Needs one CUDA card and ``nvcc``; nothing else of the repository is
changed.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from alphazero_torch.cuda_build import CSRC, NVCC_FLAGS, _nvcc  # noqa: E402

OUT = os.path.join(ROOT, "build", "conv_timeline")
SLOTS = 96                              # conv_kernels.cu: kSlots
LAUNCHES = 8
C = 128
BATCHES = (1, 32, 128, 512)
NAMES = {0: "kernel start", 1: "barriers set up",
         2: "board rows in shared memory", 3: "last wgmma_wait<0>",
         4: "BatchNorm constants in", 5: "stores done",
         6: "kernel ahead finished (wait returned)"}
NAMES.update({48 + c: f"chunk {c} copy issued" for c in range(36)})
NAMES.update({8 + c: f"chunk {c} landed (wait returned)" for c in range(36)})


def build() -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libconv_stamped.so")
    log = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-DCONV_TIMELINE", "-o", lib,
         str(CSRC / "conv_kernels.cu")], check=True, capture_output=True,
        text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "spill" in line or "Used" in line or "C75" in line:
            print(f"ptxas (stamped): {line.strip()}")
    handle = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.conv3x3_init.argtypes = [ctypes.POINTER(i)]
    handle.conv3x3_bf16.argtypes = [p] * 6 + [i] * 6 + [p, p]
    return handle


def timeline(lib, B: int, sms: int, dev) -> dict:
    import chip_smoke as cs
    from alphazero_torch.models import conv

    g = torch.Generator().manual_seed(B)
    x = torch.randn((B, 8, 8, C), generator=g).to(dev, torch.bfloat16)
    w = (torch.randn((C, C, 3, 3), generator=g) * (9 * C) ** -0.5).to(
        dev, torch.bfloat16, memory_format=torch.channels_last)
    bn = tuple(t.to(dev) for t in (
        torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
        torch.randn(C, generator=g)))
    image = conv.weight_image(w)
    shape = conv.conv_launch_shape(B, C, sms)
    grid = shape["grid"]
    trace = torch.zeros((LAUNCHES, grid, SLOTS, 2), dtype=torch.int64,
                        device=dev)
    outs = [torch.empty_like(x) for _ in range(LAUNCHES)]
    want = conv.conv3x3(x, w, bn, True, image)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = [shape[k] for k in ("grid", "np", "per")]
    torch.cuda._sleep(int(20 * 2_000_000))     # queue the launches
    for i in range(LAUNCHES):
        rc = lib.conv3x3_bf16(
            x.data_ptr(), image.data_ptr(), *(t.data_ptr() for t in bn),
            outs[i].data_ptr(), B, C, 2, *args, stream, trace[i].data_ptr())
        if rc != 0:
            sys.exit(f"conv_timeline: launch failed, CUDA error {rc}")
    torch.cuda.synchronize()
    if not all(torch.equal(o, want) for o in outs):
        sys.exit("conv_timeline: the stamped kernel differs from conv3x3")
    ms = cs.cuda_ms(lambda i: conv.conv3x3(x, w, bn, True, image),
                    what="conv3x3")
    t = trace.cpu().numpy()
    ns, cyc = t[..., 0].astype(np.int64), t[..., 1].astype(np.int64)
    start, end = ns[:, :, 0], ns[:, :, 5]
    span = end.max(1) - start.min(1)
    gaps = start[1:].min(1) - end[:-1].max(1)
    waited = ns[1:, :, 6].min(1) - end[:-1].max(1)
    period = end[1:].max(1) - end[:-1].max(1)
    print(f"{B} boards, C {C}, affine and ReLU: {shape}; unstamped kernel "
          f"{ms:.7f} ms on the device; {LAUNCHES} stamped launches back to "
          f"back: span (first start to last store) median "
          f"{int(np.median(span))} ns, gap to the next launch's first "
          f"start median {int(np.median(gaps))} ns (min {int(gaps.min())}) "
          f"and to its first wait's return {int(np.median(waited))} ns; "
          f"period (last store to last store) median "
          f"{int(np.median(period))} ns; "
          f"blocks' starts spread {int(np.ptp(start[-1]))} ns. Last launch, "
          f"ns after each block's start (median, largest), after its wait "
          f"returned (median; a launch queued behind another starts its "
          f"blocks early), SM cycles after its start (median)")
    last_ns, last_cyc = ns[-1], cyc[-1]
    rows = {}
    order = [0, 1, 6, 2, *range(8, 44), 3, 4, 5, *range(48, 84)]
    for k in order:
        seen = last_ns[:, k] != 0
        if not seen.any():
            continue
        d = last_ns[seen, k] - last_ns[seen, 0]
        dw = last_ns[seen, k] - last_ns[seen, 6]
        dc = last_cyc[seen, k] - last_cyc[seen, 0]
        rows[NAMES[k]] = (int(np.median(d)), int(d.max()),
                          int(np.median(dw)), int(np.median(dc)))
        print(f"  {NAMES[k]:38s}" + "".join(f" {v:8d}" for v in rows[NAMES[k]]))
    return {"B": B, "shape": shape, "ms": ms,
            "span_ns": int(np.median(span)), "gap_ns": int(np.median(gaps)),
            "wait_gap_ns": int(np.median(waited)),
            "period_ns": int(np.median(period)),
            "stamps": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_timeline: no CUDA device", file=sys.stderr)
        return 1
    from alphazero_torch.models import conv

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                           "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    lib = build()
    sms = ctypes.c_int(0)
    if lib.conv3x3_init(ctypes.byref(sms)) != 0:
        sys.exit("conv_timeline: conv3x3_init failed")
    conv.LIB.multiprocessors(dev)
    batches = [int(b) for b in sys.argv[1:]] or BATCHES
    out = [timeline(lib, B, sms.value, dev) for B in batches]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
