"""The program's spans, and the records of its units of work.

A span (``with span(name):``) is a ``torch.profiler.record_function``
named from ``NAMES``, so that a profiler recording the thread puts it on
the clock of the device's kernels, and an idle gap of the device can be
put down to the span the host was in. While no profiler runs it enters
no ``record_function`` (which costs some 10 us an enter and exit and
would record nothing). It is opened per move, per request or per learner
step, never per simulation: no span of ``NAMES`` lies inside a simulation
(which a replay runs on the card without the host), a replay loop or a
capture. ``host.wait`` wraps each wait of the host on the card on the
move and request paths (a read of a device value: the noise's rejection
loop, the bot's readback; a copy from pageable memory: the bot's
position), and never one inside ``search.simulations``.

A record holds the spans its thread opens while it is open: a web
request's (``with request(path):``, one per HTTP POST, its body the span
``web.request``) or a self-play move's (``with move():``, one per
lockstep move, its body ``selfplay.move``). A record opened inside
another is kept apart: the inner one takes the spans until it closes.
For each span it keeps the interval ``(name, start_ns, end_ns)`` on
``time.time_ns()``, the clock of ``torch.profiler``'s Chrome trace
(``ts`` x 1000 + ``baseTimeNanoseconds``), in the order they closed, and
its host time summed by name; for a span given a CUDA ``device``, the
device time of its body, from a pair of CUDA events on that device's
current stream (a span given a CPU device reads None); and the caching
allocator's device allocations (``num_device_alloc``, cudaMalloc and
cuMemMap calls) since the previous record that ran on the same device
closed: one read of the allocator's statistics per record, None for a
record with no CUDA span, or the first on its device.

Nothing in a record waits for the card. A pair still running when its
record closes (a move's replays: the host is a move ahead) reads None
until a later close, or ``settle()``, finds it complete; its events are
then kept for later spans, since making a CUDA event costs more than
recording one. Closed records
go to ``REQUESTS`` and ``MOVES``, the newest 4096 each, each when its
body ends (a request's just after its reply is written):

    {"spans": {name: seconds}, "device": {name: seconds or None},
     "allocs": int or None, "intervals": [(name, start_ns, end_ns)],
     "t0": ns, "t1": ns}

and a request's also its ``"path"``.

The stage spans inside a simulation (``mcts.descend``, ``mcts.evaluate``,
``mcts.expand``, ``mcts.backprop``) are plain ``record_function``s and not
in ``NAMES``: they are recorded only where a simulation runs on the host,
at a capture or in an eager search.
"""

from __future__ import annotations

import collections
import threading
import time

import torch
from torch.autograd import profiler as _profiler
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
    # the host waiting on the card: a read of a device value, a copy
    "host.wait",
)
_NAMES = frozenset(NAMES)

REQUESTS: collections.deque = collections.deque(maxlen=4096)
MOVES: collections.deque = collections.deque(maxlen=4096)

_open = threading.local()      # .record: the thread's open record
_lock = threading.Lock()       # guards _pending and _allocs
_pending: collections.deque = collections.deque()   # (record, pairs, index)
_allocs: dict = {}             # device index -> num_device_alloc at a close
_free: dict = collections.defaultdict(list)   # device index -> events


def _device_allocs(index: int) -> int:
    return torch.cuda.memory_stats_as_nested_dict(index)["num_device_alloc"]


def _complete(pairs: dict) -> bool:
    return all(end.query() for ps in pairs.values() for _, end in ps)


def _event(index: int) -> torch.cuda.Event:
    """A timing event of device ``index``: a resolved pair's, or new."""
    try:
        return _free[index].pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _resolve(rec: dict, pairs: dict, index: int) -> None:
    """The device times of ``rec``'s completed ``pairs``, whose events
    go back to device ``index``'s free list."""
    for name, ps in pairs.items():
        rec["device"][name] = sum(s.elapsed_time(e) for s, e in ps) / 1e3
        for s, e in ps:
            _free[index] += (s, e)


def _settle() -> None:
    """Resolves the pending records, oldest first, up to the first whose
    pairs are still running (the caller holds ``_lock``)."""
    while _pending and _complete(_pending[0][1]):
        _resolve(*_pending.popleft())


def settle() -> None:
    """Resolves the device times of closed records whose event pairs have
    completed since they closed; a pair still running stays None. Waits
    for nothing."""
    with _lock:
        _settle()


class _Record:
    """An open record: its spans' intervals, the event pairs of its device
    spans by name (None for a span on the CPU), and the index of the CUDA
    device they ran on."""

    __slots__ = ("_body", "_sink", "_fields", "_outer", "t0", "intervals",
                 "events", "device")

    def __init__(self, body: str, sink: collections.deque, fields: dict):
        self._body = span(body)
        self._sink, self._fields = sink, fields
        self.intervals: list = []
        self.events: dict = {}
        self.device = None

    def __enter__(self) -> "_Record":
        self._outer = getattr(_open, "record", None)
        _open.record = self
        self.t0 = time.time_ns()
        self._body.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._body.__exit__(*exc)
        t1 = time.time_ns()
        _open.record = self._outer
        self._sink.append(self._close(t1))
        return False

    def _close(self, t1: int) -> dict:
        host: dict = {}
        for name, s, e in self.intervals:
            host[name] = host.get(name, 0) + e - s
        rec = dict(self._fields,
                   spans={n: ns / 1e9 for n, ns in host.items()},
                   device=dict.fromkeys(self.events), allocs=None,
                   intervals=self.intervals, t0=self.t0, t1=t1)
        pairs = {n: ps for n, ps in self.events.items() if ps is not None}
        with _lock:
            _settle()
            if pairs and _complete(pairs):
                _resolve(rec, pairs, self.device)
            elif pairs:
                _pending.append((rec, pairs, self.device))
            if self.device is not None:
                now = _device_allocs(self.device)
                before = _allocs.get(self.device)
                _allocs[self.device] = now
                if before is not None:
                    rec["allocs"] = now - before
        return rec


class span:
    """``with span(name, device=None):`` a ``record_function(name)`` while
    a profiler runs; inside a record, also the body's interval and, with a
    CUDA ``device``, its device time on that device's current stream.
    Raises ``ValueError`` for a name outside ``NAMES``."""

    __slots__ = ("name", "device", "_fn", "_rec", "_t0", "_start")

    def __init__(self, name: str, device: torch.device | None = None):
        if name not in _NAMES:
            raise ValueError(f"{name!r} is not a span of tracing.NAMES")
        self.name, self.device = name, device

    def __enter__(self) -> "span":
        self._fn = None
        if getattr(_profiler, "_is_profiler_enabled", True):
            self._fn = record_function(self.name)
            self._fn.__enter__()
        self._rec = rec = getattr(_open, "record", None)
        self._start = None
        if rec is not None:
            dev = self.device
            if dev is not None and dev.type == "cuda":
                rec.device = (dev.index if dev.index is not None
                              else torch.cuda.current_device())
                self._start = _event(rec.device)
                self._start.record(torch.cuda.current_stream(rec.device))
            elif dev is not None:
                rec.events.setdefault(self.name, None)
            self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self._rec
        if rec is not None:
            rec.intervals.append((self.name, self._t0, time.time_ns()))
            if self._start is not None:
                end = _event(rec.device)
                end.record(torch.cuda.current_stream(rec.device))
                pairs = rec.events.get(self.name)
                if pairs is None:
                    rec.events[self.name] = pairs = []
                pairs.append((self._start, end))
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def request(path: str) -> _Record:
    """``with request(path):`` one request's record, open on this thread,
    its body a ``web.request`` span; appended to ``REQUESTS`` at its end,
    whether the body returned or raised."""
    return _Record("web.request", REQUESTS, {"path": path})


def move() -> _Record:
    """``with move():`` one self-play move's record, open on this thread,
    its body a ``selfplay.move`` span; appended to ``MOVES`` at its end,
    whether the body returned or raised."""
    return _Record("selfplay.move", MOVES, {})
