"""The port's spans and request records (``alphazero_torch/tracing.py``).

(a) Under ``torch.profiler`` on the CPU, one continuous self-play move
    emits its spans, the search's inside ``selfplay.move`` in the order
    the host runs them; one learner step emits its three.
(b) Through ``tests/test_torch_web.py``'s server, each POST leaves one
    record whose spans nest (``web.request`` >= ``bot.search`` >= the
    search's spans >= 0) and whose device times are None on the CPU.
(c) ``span`` and ``request`` themselves: the names, the bound on
    ``REQUESTS``, a record per thread, a body that raises.
(d) ``gpu``: on the card the bot's record holds the device time of its
    simulations, from its events; a steady-state captured move reads the
    card nowhere outside ``host.wait``, and its record's pair and
    allocations are read.
(e) Move records: their schema and nesting, ``host.wait`` never inside
    the simulations, the intervals on the profiler's clock, the pending
    pairs resolved by a later close or ``settle``.
"""

import collections
import contextlib
import json
import threading
import time
import urllib.error

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from alphazero_torch import tracing
from alphazero_torch.config import tiny_config
from alphazero_torch.env import breakthrough as tenv
from alphazero_torch.models.network import build_network
from alphazero_torch.search import init_tree, make_net_evaluator
from alphazero_torch.search import mcts as tmcts
from alphazero_torch.train import learner
from alphazero_torch.train import selfplay as tsp
# by the name pytest gives it, so that the gpu cases run without the
# conftest (``python -m pytest --noconftest -m gpu tests/...``)
from test_torch_web import call, dyadic_eval
from test_torch_web import server  # noqa: F401 (a fixture)


def _spans(prof) -> dict:
    """name -> [(start, end)] of the events of ``tracing.NAMES``."""
    out = collections.defaultdict(list)
    for e in prof.events():
        if e.name in tracing.NAMES:
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config(num_blocks=1, num_filters=8, num_simulations=4,
                      parallel_games=4)
    net = build_network(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return cfg, net


# -----------------------------------------------------------------------------
# (a) the self-play move's and the learner step's spans
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("reuse", [False, True])
def test_a_selfplay_move_emits_its_spans_nested(tiny, reuse):
    cfg, net = tiny
    cfg = cfg.replace(tree_reuse=reuse)
    spec = tsp.search_spec(cfg)
    states = tenv.initial_state((4,), device="cpu")
    tree = init_tree(states, spec)
    gen = torch.Generator().manual_seed(0)
    eval_fn = make_net_evaluator(net)
    move = (tsp.selfplay_move_autoreset_tree if reuse else
            lambda s, t, *a: tsp.selfplay_move_autoreset(s, *a, t))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        move(states, tree, gen, eval_fn, spec, cfg.temperature_threshold)
    spans = _spans(prof)
    # the noise's read of its rejection loop, once a round, inside the noise
    waits = spans.pop("host.wait")
    (n0, n1), = spans["search.noise"]
    assert waits and all(n0 <= s <= e <= n1 for s, e in waits)
    order = ([] if reuse else ["selfplay.reset_tree"]) + [
        "search.root", "search.noise", "search.simulations",
        "selfplay.sample", "selfplay.autoreset"]
    assert sorted(spans) == sorted(order + ["selfplay.move"])
    assert all(len(v) == 1 for v in spans.values())
    (m0, m1), = spans["selfplay.move"]
    ranges = [spans[n][0] for n in order]
    assert all(m0 <= s <= e <= m1 for s, e in ranges)
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))


def test_a_learner_step_emits_forward_backward_optimizer(tiny):
    cfg, net = tiny
    state = learner.create_train_state(cfg, build_network(
        cfg, device="cpu", generator=torch.Generator().manual_seed(1)),
        "cpu")
    g = torch.Generator().manual_seed(2)
    B = 4
    batch = ((torch.rand((B, 3, 8, 8), generator=g) < 0.5).to(torch.uint8),
             torch.softmax(torch.randn((B, 192), generator=g), -1),
             torch.softmax(torch.randn((B, 2), generator=g), -1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        learner.train_step(state, batch, torch.zeros(B, dtype=torch.bool),
                           cfg)
    spans = _spans(prof)
    order = ["learn.forward", "learn.backward", "learn.optimizer"]
    assert sorted(spans) == sorted(order)
    ranges = [spans[n][0] for n in order]
    assert all(a[1] <= b[0] for a, b in zip(ranges, ranges[1:]))


# -----------------------------------------------------------------------------
# (b) the web server's records
# -----------------------------------------------------------------------------

@pytest.fixture
def fresh(monkeypatch):
    """An empty ``REQUESTS`` for the test's own records."""
    monkeypatch.setattr(tracing, "REQUESTS", collections.deque(
        maxlen=tracing.REQUESTS.maxlen))


def _records(n):
    """The records, once there are ``n``: a handler appends its record
    after writing the reply, so the client may read the reply first."""
    deadline = time.monotonic() + 30
    while True:
        recs = list(tracing.REQUESTS)
        if len(recs) >= n or time.monotonic() > deadline:
            return recs
        time.sleep(0.01)


def test_each_post_leaves_one_record_that_nests(server, fresh):  # noqa: F811
    r = call(server, "/api/new", {"white_type": "human",
                                  "black_type": "alphazero"})
    call(server, "/api/config")                       # a GET: no record
    r = call(server, "/api/move", {"move": r["legal_moves"][0]})
    assert "bot_move" in r
    recs = _records(2)
    assert [x["path"] for x in recs] == ["/api/new", "/api/move"]
    new, move = recs
    assert "bot.search" not in new["spans"] and new["device"] == {}
    s = move["spans"]
    assert s["web.request"] >= s["bot.search"] >= (
        s["search.root"] + s["search.simulations"])
    assert s["search.root"] >= 0 and s["search.simulations"] >= 0
    assert "search.noise" not in s                    # the bot adds none
    assert move["device"] == {"search.simulations": None}


def test_a_rejected_post_still_leaves_its_record(server, fresh):  # noqa: F811
    call(server, "/api/new", {"white_type": "human", "black_type": "human"})
    with pytest.raises(urllib.error.HTTPError):
        call(server, "/api/move", {"move": [0, 0, 0, 0]})
    recs = _records(2)
    assert [x["path"] for x in recs] == ["/api/new", "/api/move"]
    assert "bot.search" not in recs[1]["spans"]


# -----------------------------------------------------------------------------
# (c) span and request
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["search.bogus", "mcts.descend", "",
                                  "web.request "])
def test_a_name_outside_names_raises(name):
    with pytest.raises(ValueError, match="NAMES"):
        tracing.span(name)


def test_requests_stay_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "REQUESTS",
                        collections.deque(maxlen=tracing.REQUESTS.maxlen))
    n = tracing.REQUESTS.maxlen
    for i in range(n + 10):
        with tracing.request(f"/x{i}"):
            pass
    paths = [r["path"] for r in tracing.REQUESTS]
    assert len(paths) == n == 4096
    assert paths == [f"/x{i}" for i in range(10, n + 10)]


def test_spans_outside_a_request_record_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "REQUESTS", collections.deque(maxlen=8))
    with tracing.span("bot.search"):
        pass
    assert not tracing.REQUESTS
    with tracing.request("/x"):
        for _ in range(3):
            with tracing.span("search.simulations",
                              device=torch.device("cpu")):
                pass
    rec, = tracing.REQUESTS
    assert set(rec["spans"]) == {"web.request", "search.simulations"}
    assert rec["device"] == {"search.simulations": None}


def test_a_record_is_the_threads_own_and_kept_when_the_body_raises(
        monkeypatch):
    monkeypatch.setattr(tracing, "REQUESTS", collections.deque(maxlen=64))
    barrier = threading.Barrier(4)

    def handler(i):
        with tracing.request(f"/t{i}"):
            barrier.wait(timeout=30)
            if i % 2:
                with tracing.span("bot.search"):
                    pass
            barrier.wait(timeout=30)

    threads = [threading.Thread(target=handler, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    by_path = {r["path"]: r for r in tracing.REQUESTS}
    assert sorted(by_path) == [f"/t{i}" for i in range(4)]
    for i in range(4):
        assert ("bot.search" in by_path[f"/t{i}"]["spans"]) == bool(i % 2)

    with pytest.raises(RuntimeError):
        with tracing.request("/raise"):
            with tracing.span("bot.search"):
                raise RuntimeError("handler failed")
    assert tracing.REQUESTS[-1]["path"] == "/raise"
    assert "bot.search" in tracing.REQUESTS[-1]["spans"]
    with tracing.span("bot.search"):                  # the record is closed
        pass
    assert len(tracing.REQUESTS) == 5


# -----------------------------------------------------------------------------
# (d) on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_bot_record_holds_the_simulations_device_time(
        cuda, monkeypatch, tmp_path):
    from alphazero_torch.env import OracleGame
    from alphazero_torch.web import server as tserver

    monkeypatch.setattr(tmcts, "make_net_evaluator",
                        lambda *a, **kw: dyadic_eval)
    cfg = tiny_config(num_blocks=1, num_filters=8,
                      num_simulations_inference=64,
                      checkpoint_dir=str(tmp_path))
    bot = tserver.BotService(cfg, cuda)
    recs = []
    for _ in range(3):                                # the first captures
        with tracing.request("/api/move"):
            bot.alphazero_move(OracleGame())
        recs.append(tracing.REQUESTS[-1])
    for rec in recs:
        d = rec["device"]["search.simulations"]
        assert d is not None and 0 < d <= rec["spans"]["bot.search"]
        assert rec["spans"]["bot.search"] >= rec["spans"]["search.root"]
    # a steady-state bot move waits on the card in host.wait alone
    with _reads_only_in_host_wait(monkeypatch):
        with tracing.request("/api/move"):
            bot.alphazero_move(OracleGame())
    rec = tracing.REQUESTS[-1]
    assert rec["device"]["search.simulations"] > 0
    assert isinstance(rec["allocs"], int) and rec["allocs"] >= 0


@contextlib.contextmanager
def _reads_only_in_host_wait(monkeypatch):
    """``set_sync_debug_mode("error")``, lifted inside ``host.wait`` alone:
    any other wait of the host on the card raises."""
    real = tracing.span

    class lifted(real):
        __slots__ = ()

        def __enter__(self):
            if self.name == "host.wait":
                torch.cuda.set_sync_debug_mode(0)
            return super().__enter__()

        def __exit__(self, *exc):
            if self.name == "host.wait":
                torch.cuda.set_sync_debug_mode("error")
            return super().__exit__(*exc)

    monkeypatch.setattr(tracing, "span", lifted)
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        monkeypatch.setattr(tracing, "span", real)


@pytest.mark.gpu
def test_cuda_captured_move_reads_the_card_only_in_host_wait(
        cuda, monkeypatch, tiny):
    """A steady-state captured move under ``set_sync_debug_mode("error")``,
    which ``host.wait`` alone lifts for its body: any other read of the
    card by the host raises. Its record holds the replays' device time
    once settled, and its allocations."""
    cfg, _ = tiny
    net = build_network(cfg, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    eval_fn = make_net_evaluator(net)
    spec = tsp.search_spec(cfg)
    states = tenv.initial_state((4,), device=cuda)
    tree = init_tree(states, spec)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(3):                                # the first captures
        states = tsp.selfplay_move_autoreset(
            states, gen, eval_fn, spec, cfg.temperature_threshold, tree)[0]
    torch.cuda.synchronize()
    monkeypatch.setattr(tracing, "MOVES", collections.deque(maxlen=8))
    with _reads_only_in_host_wait(monkeypatch):
        for _ in range(3):
            states = tsp.selfplay_move_autoreset(
                states, gen, eval_fn, spec, cfg.temperature_threshold,
                tree)[0]
    torch.cuda.synchronize()
    tracing.settle()
    assert len(tracing.MOVES) == 3
    for rec in tracing.MOVES:
        d = rec["device"]["search.simulations"]
        assert d is not None and d > 0
        assert isinstance(rec["allocs"], int) and rec["allocs"] >= 0
        assert rec["spans"]["host.wait"] > 0


# -----------------------------------------------------------------------------
# (e) move records
# -----------------------------------------------------------------------------

@pytest.fixture
def moves(monkeypatch):
    """Empty ``MOVES`` and ``REQUESTS`` for the test's own records."""
    monkeypatch.setattr(tracing, "MOVES", collections.deque(maxlen=4096))
    monkeypatch.setattr(tracing, "REQUESTS", collections.deque(maxlen=4096))


def _cpu_move(tiny, reuse=False):
    cfg, net = tiny
    cfg = cfg.replace(tree_reuse=reuse)
    spec = tsp.search_spec(cfg)
    states = tenv.initial_state((4,), device="cpu")
    tree = init_tree(states, spec)
    gen = torch.Generator().manual_seed(0)
    eval_fn = make_net_evaluator(net)
    if reuse:
        tsp.selfplay_move_autoreset_tree(states, tree, gen, eval_fn, spec,
                                         cfg.temperature_threshold)
    else:
        tsp.selfplay_move_autoreset(states, gen, eval_fn, spec,
                                    cfg.temperature_threshold, tree)


@pytest.mark.parametrize("reuse", [False, True])
def test_a_move_record_holds_its_spans_intervals_and_no_allocs(
        tiny, moves, reuse):
    _cpu_move(tiny, reuse)
    rec, = tracing.MOVES
    assert not tracing.REQUESTS
    assert set(rec) == {"spans", "device", "allocs", "intervals", "t0", "t1"}
    names = ([] if reuse else ["selfplay.reset_tree"]) + [
        "selfplay.move", "search.root", "search.noise", "host.wait",
        "search.simulations", "selfplay.sample", "selfplay.autoreset"]
    assert sorted(rec["spans"]) == sorted(names)
    assert rec["device"] == {"search.simulations": None}
    assert rec["allocs"] is None                      # on the CPU
    # the intervals, in the order they closed, inside the record and the
    # move's body; each name's host time is the sum of its intervals
    iv = rec["intervals"]
    assert iv[-1][0] == "selfplay.move"
    _, m0, m1 = iv[-1]
    assert rec["t0"] <= m0 <= m1 <= rec["t1"]
    assert all(m0 <= s <= e <= m1 for _, s, e in iv)
    assert [e for _, _, e in iv] == sorted(e for _, _, e in iv)
    for name, seconds in rec["spans"].items():
        assert seconds * 1e9 == pytest.approx(
            sum(e - s for n, s, e in iv if n == name))
    assert rec["spans"]["selfplay.move"] >= sum(
        rec["spans"][n] for n in names if n not in ("selfplay.move",
                                                    "host.wait"))


def test_records_inside_records_are_kept_apart(moves):
    with tracing.move():
        with tracing.span("search.root"):
            pass
        with tracing.request("/inner"):
            with tracing.span("bot.search"):
                pass
            with tracing.move():
                with tracing.span("host.wait"):
                    pass
        with tracing.span("selfplay.sample"):
            pass
    inner_move, outer = tracing.MOVES
    request, = tracing.REQUESTS
    assert set(outer["spans"]) == {"selfplay.move", "search.root",
                                   "selfplay.sample"}
    assert set(request["spans"]) == {"web.request", "bot.search"}
    assert request["path"] == "/inner"
    assert set(inner_move["spans"]) == {"selfplay.move", "host.wait"}
    assert outer["t0"] < request["t0"] < inner_move["t0"] \
        <= inner_move["t1"] < request["t1"] < outer["t1"]
    assert all(r["allocs"] is None and r["device"] == {}
               for r in (outer, request, inner_move))


@pytest.mark.parametrize("name", ["host.wait", "search.noise"])
def test_host_wait_is_a_name_of_names(name):
    assert name in tracing.NAMES
    with tracing.span(name):
        pass
    with pytest.raises(ValueError, match="NAMES"):
        tracing.span(name + "s")


@pytest.mark.parametrize("bot", [False, True])
def test_no_host_wait_opens_inside_the_simulations(tiny, monkeypatch, bot):
    """The CPU's eager search, which reads the card once a descent level
    (unspanned), with a stub that records the spans open at each
    ``host.wait``: the noise's waits lie in ``search.noise``, the bot's in
    ``bot.search`` after the search, none in ``search.simulations``."""
    real = tracing.span
    stack, waits = [], []

    class recording(real):
        __slots__ = ()

        def __enter__(self):
            if self.name == "host.wait":
                waits.append(tuple(stack))
            stack.append(self.name)
            return super().__enter__()

        def __exit__(self, *exc):
            stack.pop()
            return super().__exit__(*exc)

    monkeypatch.setattr(tracing, "span", recording)
    tmcts.STATS.reset()
    if bot:
        from alphazero_torch.env import OracleGame
        from alphazero_torch.web import server as tserver

        cfg, _ = tiny
        monkeypatch.setattr(tmcts, "make_net_evaluator",
                            lambda *a, **kw: dyadic_eval)
        svc = tserver.BotService(cfg.replace(num_simulations_inference=8),
                                 "cpu")
        svc.alphazero_move(OracleGame())
        # the position's copy to the card, and the read of the move
        assert waits == [("bot.search",)] * 2
    else:
        _cpu_move(tiny)
        assert waits and all(w[-1] == "search.noise" for w in waits)
    assert tmcts.STATS.levels > 0                     # the unspanned reads
    assert not any("search.simulations" in w for w in waits)


def test_intervals_lie_on_the_profilers_clock(tiny, moves, tmp_path):
    """Each record interval against the same span in a CPU profiler's
    Chrome trace (``ts`` x 1000 + ``baseTimeNanoseconds``): within 1 ms
    at both ends, after one warm-up span."""
    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("learn.forward"):            # the warm-up
            pass
        _cpu_move(tiny)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    traced = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"] in tracing.NAMES:
            s = float(e["ts"]) * 1e3 + base
            traced[e["name"]].append((s, s + float(e["dur"]) * 1e3))
    rec, = tracing.MOVES
    seen = collections.Counter()
    for name, s, e in sorted(rec["intervals"], key=lambda x: x[1]):
        ts, te = sorted(traced[name])[seen[name]]
        seen[name] += 1
        assert abs(ts - s) < 1e6 and abs(te - e) < 1e6, (name, ts - s,
                                                          te - e)
    assert sum(seen.values()) == len(rec["intervals"]) >= 8


class _Event:
    """A stand-in for a CUDA event: complete or not, at a time in ms."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_a_pair_still_running_reads_none_until_it_completes(monkeypatch,
                                                             moves):
    """A closed record whose pair is still running waits in the pending
    queue, oldest first: a later close resolves it once it completes,
    and so does ``settle``; neither waits for it."""
    monkeypatch.setattr(tracing, "_pending", collections.deque())
    monkeypatch.setattr(tracing, "_free", collections.defaultdict(list))
    first = {"device": {"search.simulations": None}}
    second = {"device": {"search.simulations": None}}
    end1, end2 = _Event(5.0, done=False), _Event(9.0, done=False)
    tracing._pending.append(
        (first, {"search.simulations": [(_Event(1.0), end1)]}, 0))
    tracing._pending.append(
        (second, {"search.simulations": [(_Event(2.0), end2),
                                         (_Event(10.0), _Event(12.0))]},
         0))
    tracing.settle()
    assert first["device"]["search.simulations"] is None
    end2.done = True                                  # the older one runs
    tracing.settle()
    assert second["device"]["search.simulations"] is None
    end1.done = True
    with tracing.move():                              # a later close
        pass
    assert first["device"]["search.simulations"] == pytest.approx(4e-3)
    assert second["device"]["search.simulations"] == pytest.approx(9e-3)
    assert not tracing._pending
    # their events serve later spans
    assert len(tracing._free[0]) == 6 and end1 in tracing._free[0]
