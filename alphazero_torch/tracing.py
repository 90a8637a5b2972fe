"""The program's spans, and the web server's record of each request.

A span (``with span(name):``) is a ``torch.profiler.record_function``
named from ``NAMES``, so that a profiler recording the thread puts it on
the clock of the device's kernels, and an idle gap of the device can be
put down to the span the host was in. It costs a few microseconds and is
opened per move, per request or per learner step, never per simulation:
no span of ``NAMES`` lies inside a simulation (which a replay runs on the
card without the host), a replay loop or a capture.

A request record (``with request(path):``, one per HTTP request) holds
the spans its thread opens while it is open: each span's host-clock
duration (``time.perf_counter_ns``), summed by name, and, for a span
given a CUDA ``device``, the device time of its body, from a pair of
CUDA events on the current stream. The pairs are resolved when the
request closes, after the handler has read its result back to the host,
so they have completed and reading them waits for nothing; a pair still
running reads None rather than wait. A span given a CPU device reads
None. Closed records go to ``REQUESTS``, the newest 4096, each when its
handler returns, just after its reply is written:

    {"path": str, "spans": {name: seconds},
     "device": {name: seconds or None}}

The stage spans inside a simulation (``mcts.descend``, ``mcts.evaluate``,
``mcts.expand``, ``mcts.backprop``) are plain ``record_function``s and not
in ``NAMES``: they are recorded only where a simulation runs on the host,
at a capture or in an eager search.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.profiler import record_function

NAMES = (
    # the self-play host loop (train/selfplay.py)
    "selfplay.move", "selfplay.reset_tree", "selfplay.sample",
    "selfplay.autoreset",
    # a search (search/mcts.py:search)
    "search.root", "search.noise", "search.simulations",
    # MuZero's representation of the roots, inside search.root
    "search.represent",
    # the web server (web/server.py)
    "web.request", "bot.search",
    # a learner step (train/learner.py:train_step)
    "learn.forward", "learn.backward", "learn.optimizer",
)
_NAMES = frozenset(NAMES)

REQUESTS: collections.deque = collections.deque(maxlen=4096)

_open = threading.local()      # .request: the thread's open record


class _Request:
    """An open request's spans: host nanoseconds by name, and by name the
    event pairs of its device spans (None for a span on the CPU)."""

    def __init__(self, path: str):
        self.path = path
        self.spans: dict = {}
        self.events: dict = {}

    def close(self) -> dict:
        device = {}
        for name, pairs in self.events.items():
            if pairs is None or not all(end.query() for _, end in pairs):
                device[name] = None
            else:
                device[name] = sum(s.elapsed_time(e) for s, e in pairs) / 1e3
        return {"path": self.path,
                "spans": {n: ns / 1e9 for n, ns in self.spans.items()},
                "device": device}


class span:
    """``with span(name, device=None):`` a ``record_function(name)``; inside
    a request record, also the body's host time and, with a CUDA
    ``device``, its device time on that device's current stream. Raises
    ``ValueError`` for a name outside ``NAMES``."""

    __slots__ = ("name", "device", "_fn", "_req", "_t0", "_start")

    def __init__(self, name: str, device: torch.device | None = None):
        if name not in _NAMES:
            raise ValueError(f"{name!r} is not a span of tracing.NAMES")
        self.name, self.device = name, device

    def __enter__(self) -> "span":
        self._fn = record_function(self.name)
        self._fn.__enter__()
        self._req = req = getattr(_open, "request", None)
        self._start = None
        if req is not None:
            dev = self.device
            if dev is not None and dev.type == "cuda":
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record(torch.cuda.current_stream(dev))
            elif dev is not None:
                req.events.setdefault(self.name, None)
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        req = self._req
        if req is not None:
            ns = time.perf_counter_ns() - self._t0
            req.spans[self.name] = req.spans.get(self.name, 0) + ns
            if self._start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self.device))
                pairs = req.events.get(self.name)
                if pairs is None:
                    req.events[self.name] = pairs = []
                pairs.append((self._start, end))
        self._fn.__exit__(*exc)
        return False


@contextlib.contextmanager
def request(path: str):
    """``with request(path):`` one request's record, open on this thread,
    its body a ``web.request`` span; appended to ``REQUESTS`` at its end,
    whether the body returned or raised."""
    req = _Request(path)
    outer = getattr(_open, "request", None)
    _open.request = req
    try:
        with span("web.request"):
            yield
    finally:
        _open.request = outer
        REQUESTS.append(req.close())
