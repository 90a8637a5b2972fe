"""What the span readers (``benchmark/metrics/``) share: the program's own
spans (``alphazero_torch.tracing``), read from the traced stretch's host
timeline, and the web server's request records, read for the window.
Besides ``program.py`` and the drivers, the one module of the harness that
reads the program, and only when a reader asks.

Each function returns None where the run holds nothing to read: a run
without a trace (``--trace 0``; a trace needs the card), a cell of another
kind, or a program without ``alphazero_torch.tracing``, which then has
neither the spans nor the records.
"""

from __future__ import annotations

import importlib
import statistics
from collections import defaultdict
from typing import Dict, List, Optional

REPLAYS = "search.simulations"


def program_tracing():
    """The program's ``tracing`` module, or None where it has none."""
    try:
        return importlib.import_module("alphazero_torch.tracing")
    except ModuleNotFoundError:
        return None


def idle_by_span(run, kind: str) -> Optional[Dict[str, float]]:
    """The traced stretch's idle time (its gaps in the union of device
    intervals), in seconds, by the innermost program span (a
    ``user_annotation`` named in ``tracing.NAMES``) open on the host at each
    gap's middle; under "" where none was."""
    if run.trace is None or run.driver.kind != kind:
        return None
    tracing = program_tracing()
    if tracing is None:
        return None
    names = set(tracing.NAMES)
    spans = [o for o in run.trace.host
             if o.cat == "user_annotation" and o.name in names]
    if not spans:
        return None
    edges = [run.trace.start]
    for s, e in run.trace.union():
        edges += [s, e]
    edges.append(run.trace.end)
    by: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [o for o in spans if o.start <= mid <= o.end]
        name = max(inner, key=lambda o: o.start).name if inner else ""
        by[name] += (b - a) / 1e6
    return dict(by)


def idle_in_replays_pct(run, kind: str) -> Optional[float]:
    """Idle time under ``search.simulations`` (the replays' launches and
    the eager simulations) over the stretch, in percent."""
    by = idle_by_span(run, kind)
    if by is None:
        return None
    return 100.0 * by.get(REPLAYS, 0.0) / run.trace.window_s


def idle_in_glue_pct(run, kind: str) -> Optional[float]:
    """Idle time under any other program span (the move's host work around
    the simulations) over the stretch, in percent. What is under no
    program span is the driver's own."""
    by = idle_by_span(run, kind)
    if by is None:
        return None
    glue = sum(v for k, v in by.items() if k and k != REPLAYS)
    return 100.0 * glue / run.trace.window_s


def window_requests(run) -> Optional[List[dict]]:
    """The bot cell's ``/api/move`` records of the window, in order: of all
    the run's ``/api/move`` records the last ``traffic["traced_requests"]``
    are the traced stretch's and are dropped, and the
    ``window_stats["requests"]`` before them are the window's. ``/api/new``
    records never count."""
    if run.trace is None or run.driver.kind != "bot":
        return None
    tracing = program_tracing()
    if tracing is None:
        return None
    moves = [r for r in list(tracing.REQUESTS) if r["path"] == "/api/move"]
    n = int(run.driver.window_stats.get("requests", 0))
    k = int(run.cell.traffic["traced_requests"])
    if not n or len(moves) < n + k:
        return None
    return moves[len(moves) - n - k:len(moves) - k]


def _median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def handler_p50_s(run) -> Optional[float]:
    """Median over the window's records of ``web.request`` less
    ``bot.search`` (0 where the user's move ended the game)."""
    recs = window_requests(run)
    if recs is None:
        return None
    return _median([r["spans"]["web.request"]
                    - r["spans"].get("bot.search", 0.0) for r in recs])


def _sims_device(recs: List[dict]) -> List[tuple]:
    """(record, device seconds of its ``search.simulations``) for each
    record that searched and whose device time was read."""
    return [(r, r["device"][REPLAYS]) for r in recs
            if r["device"].get(REPLAYS) is not None]


def search_host_p50_s(run) -> Optional[float]:
    """Median over the window's records that searched of ``bot.search``
    less the device interval of its simulations."""
    recs = window_requests(run)
    if recs is None:
        return None
    return _median([r["spans"]["bot.search"] - d
                    for r, d in _sims_device(recs)])


def sims_device_p50_s(run) -> Optional[float]:
    """Median device interval of the window's ``search.simulations``."""
    recs = window_requests(run)
    if recs is None:
        return None
    return _median([d for _, d in _sims_device(recs)])


def transport_p50_s(run) -> Optional[float]:
    """The window's median round trip on the client's clock less the
    median ``web.request`` on the server's: a difference of medians, not
    a median of differences (the driver keeps only the round trips'
    quantiles)."""
    recs = window_requests(run)
    if recs is None:
        return None
    return run.driver.window_stats["p50"] - _median(
        [r["spans"]["web.request"] for r in recs])
