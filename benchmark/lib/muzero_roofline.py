"""The share of a kernel's roofline over MuZero's traced self-play move,
for the metrics ``<kernel>_roofline.selfplay`` of its cell: the least time
of the stretch's launches of the kernel (each the larger of its operations
at the bf16 peak and its bytes at the memory's, summed over the launches
of the sites ``rooflines/muzero.py`` lists for the move, all at the cell's
lane count) over the sum of their traced times."""

from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark.lib import peaks


def muzero_run(run) -> bool:
    return (run.trace is not None and run.driver.kind == "selfplay"
            and run.cell.config.get("body") == "muzero")


def share_pct(run, kernel: str, sites: List[Tuple], ops, bytes_moved
              ) -> Optional[float]:
    """``sites``: the argument tuples (after the lane count) of every launch
    of ``kernel`` that the stretch made."""
    if not muzero_run(run):
        return None
    ks = run.trace.kernels(kernel)
    if not ks or not sites:
        return None
    B = int(run.cell.traffic["lanes"])
    bound = sum(max(ops(B, *s) / peaks.BF16_FLOPS,
                    bytes_moved(B, *s) / peaks.HBM_BYTES_PER_S)
                for s in sites)
    # the trace's launches are the sites' in number; a mean per launch
    # keeps the share right if the stretch ran more or fewer of them
    bound *= len(ks) / len(sites)
    spent = sum(k.end - k.start for k in ks) / 1e6
    return 100.0 * bound / spent
