"""What the per-layer metric readers (``benchmark/metrics/<name>.py``)
share. A reader is given the ``Run`` and returns its number, or None
where the run holds nothing for it to read: then the metric is left out
of the result."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from benchmark.lib import flops, peaks
from benchmark.lib.cell import Cell
from benchmark.lib.trace import Trace


@dataclasses.dataclass
class Run:
    cell: Cell
    driver: Any                   # the cell's driver, after its window
    trace: Optional[Trace]        # the traced stretch, in a --trace 1 run
    stretch_units: int = 0        # simulations (or steps) in the stretch


def idle_share_pct(run: Run, kind: str) -> Optional[float]:
    """The share of the traced stretch in which no device operation ran
    (gaps in the union of their intervals), in percent."""
    if run.trace is None or run.driver.kind != kind:
        return None
    return 100.0 * run.trace.idle_share()


def search_mfu_pct(run: Run, kind: str) -> Optional[float]:
    """Model FLOPs of every board the window's searches evaluated (the
    roots' and one a simulation) over the window, against the dense peak
    of the configuration's search precision, in percent."""
    st = run.driver.window_stats
    if run.driver.kind != kind or not st.get("boards"):
        return None
    rate = st["boards"] * flops.forward_flops(run.cell.config) / st["seconds"]
    return 100.0 * rate / peaks.FLOPS[run.cell.config["search_precision"]]


def learn_mfu_pct(run: Run) -> Optional[float]:
    """Forward and backward FLOPs of every example the window trained,
    against the dense peak of the precision the configuration states for
    the learner's convolutions, in percent."""
    st = run.driver.window_stats
    if run.driver.kind != "learn" or not st.get("examples"):
        return None
    rate = st["examples"] * flops.train_flops(run.cell.config) / st["seconds"]
    return 100.0 * rate / peaks.FLOPS[run.cell.config["train_precision"]]


def launches_per_sim(run: Run, kind: str) -> Optional[float]:
    if run.trace is None or run.driver.kind != kind \
            or not run.stretch_units:
        return None
    return len(run.trace.kernels()) / run.stretch_units


def roofline_pct(run: Run, kind: str, roof, *shape_keys) -> Optional[float]:
    """The sum over the traced launches of ``roof.KERNEL`` of each one's
    least time (the larger of its operations at the bf16 peak and its
    bytes at the memory's) over the sum of their traced times, in
    percent. Every launch of the stretch is at the cell's lane count; the
    widths are the configuration's."""
    if run.trace is None or run.driver.kind != kind:
        return None
    ks = run.trace.kernels(roof.KERNEL)
    if not ks:
        return None
    c = run.cell.config
    dims = {"C": c["num_filters"], "H": c["num_filters"] // c["se_ratio"]}
    B = int(run.cell.traffic["lanes"])
    args = [B] + [dims[k] for k in shape_keys]
    bound = max(roof.ops(*args) / peaks.BF16_FLOPS,
                roof.bytes_moved(*args) / peaks.HBM_BYTES_PER_S)
    spent = sum(k.end - k.start for k in ks) / 1e6
    return 100.0 * bound * len(ks) / spent

