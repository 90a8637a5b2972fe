#!/usr/bin/env python3
"""Per-block timeline of the bf16 conv kernel (``conv3x3_kernel`` and, at
C 256, ``persistent_conv3x3_kernel``) on the card.

    python3 scripts/conv_timeline.py [--channels C] [--waves] [B ...]

Builds ``alphazero_torch/csrc/conv_kernels.cu`` with ``-DCONV_TIMELINE``
into ``build/conv_timeline/``: each block then writes ``%globaltimer``
(ns) and ``clock64`` (SM cycles) at the points the kernel stamps (its
start, its barriers set up, each weight chunk's copy issued and its wait
returned, the kernel ahead finished (``griddepcontrol.wait`` returned),
the board's rows in shared memory, the last ``wgmma_wait<0>``,
the BatchNorm constants in, the stores done; the first piece of each
block, and of its last piece where it has more than one; on the
persistent path a piece is a tile, and the second pair of warpgroups
stamps its rows, each tile's first chunk, products and stores). For each
batch (by default 1, 32, 128 and 512 boards) at C 128, or at the width
``--channels`` gives (128 or 256), with the affine and ReLU, in the
wrapper's launch (``--waves``: in ``conv.wave_shape``'s, the
``conv3x3_kernel`` launch, where the wrapper would take the persistent
path), it launches the stamped kernel ``LAUNCHES`` times
back to back, queued behind a device sleep as ``chip_smoke.cuda_ms``
queues them, checks every output bit-equal to the unstamped
``conv.conv3x3``, and prints for each stamp the median and the largest ns
after the block's start over the blocks of the last launch (SM cycles
beside), the launch's span (first start to last store), the gap from one
launch's last store to the next one's first start and to its wait's
return, the period from one launch's last store to the next one's, and
the unstamped kernel's device time in the same launch
(``chip_smoke.cuda_ms``), and the SM cycles a block's thread 0 spent
waiting for weight chunks. Needs one CUDA card and ``nvcc``; nothing else
of the repository is changed.
"""

import argparse
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
SLOTS = 160                             # conv_kernels.cu: kSlots
LAUNCHES = 8
BATCHES = (1, 32, 128, 512)
NAMES = {0: "kernel start", 1: "barriers set up",
         2: "board rows in shared memory", 3: "last wgmma_wait<0>",
         4: "BatchNorm constants in", 5: "stores done",
         6: "kernel ahead finished (wait returned)",
         140: "last piece: start", 141: "last piece: last wgmma_wait<0>",
         142: "last piece: stores done", 143: "second pair: rows in",
         144: "second pair: tile 0 chunk 0 landed",
         145: "second pair: tile 0 last wgmma_wait<0>",
         146: "second pair: tile 0 stores done",
         147: "second pair: tile 1 chunk 0 landed",
         148: "second pair: tile 1 last wgmma_wait<0>",
         149: "second pair: tile 1 stores done"}
NAMES.update({48 + c: f"chunk {c} copy issued" for c in range(36)})
NAMES.update({8 + c: f"chunk {c} landed (wait returned)" for c in range(36)})
NAMES.update({96 + c: f"last piece: chunk {c} landed" for c in range(36)})
ORDER = [0, 1, 6, 2, *range(8, 44), 3, 4, 5, 140, *range(96, 132), 141, 142,
         *range(143, 150), *range(48, 84)]
ENDS = (5, 142, 149)                    # a block's last stores


def build():
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
    handle.conv3x3_persistent_bf16.argtypes = [p] * 6 + [i] * 3 + [p, p]
    return handle


def launcher(lib, shape, x, image, bn, out, B, C, stream, trace=None):
    """One launch of the shape's kernel (stamped if ``lib`` is the stamped
    build and ``trace`` given)."""
    ptrs = (x.data_ptr(), image.data_ptr(), *(t.data_ptr() for t in bn),
            out.data_ptr())
    extra = () if trace is None else (trace.data_ptr(),)
    if shape["path"] == "persistent":
        return lib.conv3x3_persistent_bf16(*ptrs, B, 2, shape["grid"],
                                           stream, *extra)
    return lib.conv3x3_bf16(*ptrs, B, C, 2, shape["grid"], shape["np"],
                            shape["per"], stream, *extra)


def timeline(lib, B: int, C: int, shape: dict, dev) -> dict:
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
    grid = shape["grid"]
    trace = torch.zeros((LAUNCHES, grid, SLOTS, 2), dtype=torch.int64,
                        device=dev)
    outs = [torch.empty_like(x) for _ in range(LAUNCHES)]
    want = conv.conv3x3(x, w, bn, True, image)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    torch.cuda._sleep(int(20 * 2_000_000))     # queue the launches
    for i in range(LAUNCHES):
        rc = launcher(lib, shape, x, image, bn, outs[i], B, C, stream,
                      trace[i])
        if rc != 0:
            sys.exit(f"conv_timeline: launch failed, CUDA error {rc}")
    torch.cuda.synchronize()
    if not all(torch.equal(o, want) for o in outs):
        sys.exit("conv_timeline: the stamped kernel differs from conv3x3")
    plain = torch.empty_like(x)

    def unstamped(i):
        rc = launcher(conv.LIB, shape, x, image, bn, plain, B, C, stream)
        cs.check(rc == 0, f"launch failed: CUDA error {rc}")

    ms = cs.cuda_ms(unstamped, what="conv3x3")
    cs.check(torch.equal(plain, want), "the launch differs from conv3x3")
    t = trace.cpu().numpy()
    ns, cyc = t[..., 0].astype(np.int64), t[..., 1].astype(np.int64)
    start = ns[:, :, 0]
    end = np.max(np.stack([ns[:, :, k] for k in ENDS]), axis=0)
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
    waits = t[-1, :, 150, :]
    print(f"  thread 0 of a block waited on weight chunks {int(np.median(waits[:, 0]))} "
          f"SM cycles (median over the blocks; largest "
          f"{int(waits[:, 0].max())}), {int(np.median(waits[:, 1]))} waits "
          f"past 100 cycles")
    last_ns, last_cyc = ns[-1], cyc[-1]
    rows = {}
    for k in ORDER:
        seen = last_ns[:, k] != 0
        if not seen.any():
            continue
        d = last_ns[seen, k] - last_ns[seen, 0]
        dw = last_ns[seen, k] - last_ns[seen, 6]
        dc = last_cyc[seen, k] - last_cyc[seen, 0]
        rows[NAMES[k]] = (int(np.median(d)), int(d.max()),
                          int(np.median(dw)), int(np.median(dc)))
        print(f"  {NAMES[k]:38s}" + "".join(f" {v:8d}" for v in rows[NAMES[k]]))
    return {"B": B, "C": C, "shape": shape, "ms": ms,
            "span_ns": int(np.median(span)), "gap_ns": int(np.median(gaps)),
            "wait_gap_ns": int(np.median(waited)),
            "period_ns": int(np.median(period)),
            "chunk_wait_cycles": int(np.median(waits[:, 0])),
            "stamps": rows}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--channels", type=int, default=128,
                        choices=(128, 256))
    parser.add_argument("--waves", action="store_true")
    parser.add_argument("batches", type=int, nargs="*")
    opts = parser.parse_args()
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
    out = []
    for B in opts.batches or BATCHES:
        C = opts.channels
        rule = conv.wave_shape if opts.waves else conv.conv_launch_shape
        out.append(timeline(lib, B, C, rule(B, C, sms.value), dev))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
