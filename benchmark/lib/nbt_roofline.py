"""The share of a kernel's roofline over the nested-bottleneck body's
traced stretch, for the metrics ``<kernel>_roofline.selfplay`` of its
self-play cell: every launch in the stretch is one of a forward's sites
(``rooflines/nbt.py``), all at the cell's lane count, in equal numbers, so
the least time of the stretch's launches is their count times the mean of
a forward's sites' least times (each the larger of its operations at the
bf16 peak and its bytes at the memory's), over the sum of their traced
times."""

from __future__ import annotations

from typing import Callable, List, Optional

from benchmark.lib import peaks


def share_pct(run, kernel: str, sites: Callable[[dict], List[tuple]],
              ops: Callable, bytes_moved: Callable) -> Optional[float]:
    c = run.cell.config
    if run.trace is None or run.driver.kind != "selfplay" \
            or c.get("body") != "nbt":
        return None
    ks = run.trace.kernels(kernel)
    if not ks:
        return None
    B = int(run.cell.traffic["lanes"])
    forward = sites(c)
    bound = sum(max(ops(B, *s) / peaks.BF16_FLOPS,
                    bytes_moved(B, *s) / peaks.HBM_BYTES_PER_S)
                for s in forward) / len(forward)
    spent = sum(k.end - k.start for k in ks) / 1e6
    return 100.0 * bound * len(ks) / spent
