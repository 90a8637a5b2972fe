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
    simulations, from its events.
"""

import collections
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
