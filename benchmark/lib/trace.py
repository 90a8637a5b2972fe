"""A traced stretch of a run, read from the profiler's device timeline.

``record`` runs a function under ``torch.profiler`` (host and device
activity) inside a host span named ``STRETCH``, synchronises the card at
its end, writes the Chrome trace to a file and reads it back. ``Trace``
holds the device operations (kernels, copies, sets) and the host spans,
and gives what the metric readers need:

- ``busy_s``: the length of the UNION of the device operations' intervals
  inside the stretch. Operations overlap on the timeline (a kernel
  started as a programmatic dependent launch begins before the one ahead
  of it ends), so durations are never summed for it;
- ``idle_gaps``: the stretch less that union, longest first, each named
  by the innermost host span that was open at the gap's middle;
- ``device_ops``: device time by operation name, the most first.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import Callable, List, Tuple

import torch

STRETCH = "benchmark.stretch"
# the port's hand-written kernels and the libraries' names, to sort a
# trace's kernels into three classes (a copy of chip_smoke.launch_classes)
HAND_KERNELS = ("descend_kernel", "commit_path_kernel", "commit_edges_kernel",
                "fetch_rows_kernel", "encode_planes_kernel", "expand_kernel",
                "conv3x3_kernel", "se_residual_kernel", "bn_act_kernel",
                "qconv3x3_kernel", "tower_kernel")
LIBRARY_WORDS = ("cudnn", "cublas", "nvjet", "cutlass", "gemm", "fprop",
                 "nhwcaddpadding", "memset")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function",
             "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Op:
    name: str
    start: float          # microseconds, the trace's clock
    end: float
    cat: str = ""


@dataclasses.dataclass
class Trace:
    device: List[Op]
    host: List[Op]
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def union(self) -> List[Tuple[float, float]]:
        """The device operations' intervals merged, clipped to the
        stretch."""
        spans = sorted((max(o.start, self.start), min(o.end, self.end))
                       for o in self.device)
        merged: List[Tuple[float, float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union()) / 1e6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        edges = [self.start]
        for s, e in self.union():
            edges += [s, e]
        edges.append(self.end)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:top]
        return [(self._host_at(t + g / 2), g / 1e6) for g, t in gaps]

    def _host_at(self, t: float) -> str:
        inner = [o for o in self.host if o.start <= t <= o.end
                 and o.name != STRETCH]
        if not inner:
            return "host: none"
        return "host: " + max(inner, key=lambda o: o.start).name

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        by = defaultdict(float)
        for o in self.device:
            by[o.name] += (o.end - o.start) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def launch_classes(self) -> dict:
        """Kernels by class (the port's hand kernels, cuDNN's and cuBLAS's,
        the rest: PyTorch's own), with launches and device seconds."""
        out = {c: {"launches": 0, "seconds": 0.0}
               for c in ("hand", "library", "rest")}
        for o in self.kernels():
            low = o.name.lower()
            c = ("hand" if any(k in o.name for k in HAND_KERNELS) else
                 "library" if any(w in low for w in LIBRARY_WORDS) else
                 "rest")
            out[c]["launches"] += 1
            out[c]["seconds"] += (o.end - o.start) / 1e6
        return out

    def kernels(self, word: str = "") -> List[Op]:
        """The kernels (not copies or sets) whose name holds ``word``."""
        return [o for o in self.device if o.cat == "kernel"
                and word in o.name]


def record(fn: Callable[[], None], path: str) -> Trace:
    """``fn`` under the profiler, on the card; its Chrome trace goes to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    return read(path)


def read(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, stretch = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        op = Op(e.get("name", "?"), float(e["ts"]),
                float(e["ts"]) + float(e["dur"]), cat)
        if cat in DEVICE_CATS:
            device.append(op)
        elif cat in HOST_CATS:
            host.append(op)
            if op.name == STRETCH and cat == "user_annotation":
                stretch = op
    if stretch is None:
        raise RuntimeError(f"the trace {path} holds no {STRETCH} span")
    if not device:
        raise RuntimeError(f"the trace {path} holds no device operation: "
                           f"the profiler saw nothing run on the card")
    os.remove(path)
    return Trace(device=device, host=host, start=stretch.start,
                 end=stretch.end)
