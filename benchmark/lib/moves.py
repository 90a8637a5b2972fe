"""What the move-record readers (``benchmark/metrics/``) share: the
program's self-play move records (``alphazero_torch.tracing.MOVES``),
read for the window as ``spans.window_requests`` reads the bot's request
records, and the device allocations that every record counts.

The window is untraced in every run: in a ``--trace 1`` run the profiler
starts only after it. Each function returns None where the run holds
nothing to read: a run without a trace (the readers run only in a
``--trace 1`` run), a cell of another kind, too few records, or a program
whose tracing keeps no move records (``MOVES``) or no allocations
(``allocs``).
"""

from __future__ import annotations

import statistics
from typing import List, Optional

from benchmark.lib import spans


def window_moves(run) -> Optional[List[dict]]:
    """The selfplay cell's move records of the window, in order: of all
    the run's move records the last ``stretch_units /
    traffic["simulations"]`` are the traced stretch's and are dropped, and
    the ``window_stats["moves"]`` before them are the window's. Their
    device times are resolved first (``tracing.settle``)."""
    if run.trace is None or run.driver.kind != "selfplay":
        return None
    tracing = spans.program_tracing()
    if tracing is None or not hasattr(tracing, "MOVES"):
        return None
    tracing.settle()
    moves = list(tracing.MOVES)
    n = int(run.driver.window_stats.get("moves", 0))
    k = int(run.stretch_units) // int(run.cell.traffic["simulations"])
    if not n or len(moves) < n + k:
        return None
    return moves[len(moves) - n - k:len(moves) - k]


def sims_device_share_pct(run) -> Optional[float]:
    """The device seconds of the window's ``search.simulations`` (each
    move's CUDA event pair) over the window's seconds, in percent; None
    where a pair was not read (on the CPU). The window's seconds are the
    driver's, from before its first move to a synchronisation after its
    last. The span from the first record's ``t0`` to the last one's ``t1``
    would leave out what the card still runs of the last move's replays
    when the host closes its record, up to a whole move when the host is a
    move ahead (over 10 moves at C 256 that span read 110%)."""
    recs = window_moves(run)
    if recs is None:
        return None
    device = [r["device"].get(spans.REPLAYS) for r in recs]
    if any(d is None for d in device):
        return None
    return 100.0 * sum(device) / run.driver.window_stats["seconds"]


def glue_host_p50_s(run) -> Optional[float]:
    """The median over the window's moves of ``selfplay.move``'s host time
    less ``search.simulations`` and less ``host.wait``: the host's own
    work a move, around the replays and outside its waits on the card."""
    recs = window_moves(run)
    if recs is None:
        return None
    return statistics.median(
        r["spans"]["selfplay.move"] - r["spans"].get(spans.REPLAYS, 0.0)
        - r["spans"].get("host.wait", 0.0) for r in recs)


def allocs_per_record(recs: Optional[List[dict]]) -> Optional[float]:
    """The device allocations the records counted, over their number; a
    record that ran nothing on the card counts none (its allocations go to
    the next record that did). None where no record counted any (on the
    CPU, or a program whose records keep no ``allocs``)."""
    if not recs:
        return None
    allocs = [r.get("allocs") for r in recs]
    if all(a is None for a in allocs):
        return None
    return sum(a for a in allocs if a is not None) / len(recs)
