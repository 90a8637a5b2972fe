"""The PyTorch port's web server (``alphazero_torch/web/server.py``).

(a) The five cases of ``tests/test_web.py``: the HTTP surface driven
    end to end against a live server on 127.0.0.1 (port 0) with a tiny
    random model on the CPU.
(b) The static files, byte-equal to the JAX package's.
(c) The bot against the JAX package's bot: both ``make_net_evaluator``s
    swapped for ``tests/test_mcts.py``'s exact toy evaluator (each bot
    imports it inside ``_build``); the same action and the same
    evaluation (exactly) over a sequence of positions.
(d) ``gpu``: the bot's search on the card at B = 1 and B = 2 and 200
    simulations against the CPU's, whole trees bit-equal under an
    evaluator whose every sum is exact; the bot answering from another
    thread, as the server's handler threads do.

The JAX package is imported only inside (b)'s and (c)'s tests, so that
the ``gpu`` cases run where JAX is not installed (``python -m pytest
--noconftest -m gpu tests/test_torch_web.py``).
"""

import functools
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch.config import tiny_config
from alphazero_torch.env import OracleGame
from alphazero_torch.env import breakthrough as tenv
from alphazero_torch.search import mcts as tmcts
from alphazero_torch.web import server as tserver

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def server():
    cfg = tiny_config(num_blocks=2, num_filters=8, num_simulations=4)
    session = tserver.GameSession(cfg, device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                tserver.make_handler(session, cfg))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)


def call(base, path, body=None):
    if body is None:
        req = urllib.request.Request(base + path)
    else:
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


# -----------------------------------------------------------------------------
# (a) the HTTP surface
# -----------------------------------------------------------------------------

def test_config_and_models(server):
    cfg = call(server, "/api/config")
    assert cfg == {"board_size": 8, "num_actions": 192}
    models = call(server, "/api/models")
    assert models["current"] == "random"


def test_new_game_human_vs_alphazero(server):
    r = call(server, "/api/new",
             {"white_type": "human", "black_type": "alphazero"})
    assert r["turn"] == "white"
    assert len(r["legal_moves"]) == 22
    board = np.asarray(r["board"])
    assert (board[0:2] == 1).all() and (board[6:8] == -1).all()


def test_human_move_triggers_bot_reply(server):
    call(server, "/api/new",
         {"white_type": "human", "black_type": "alphazero"})
    r = call(server, "/api/move", {"move": [1, 3, 2, 3]})
    assert r["moved_player"] == "white"
    assert "bot_move" in r and "evaluation" in r
    assert r["turn"] == "white"          # bot (black) already replied
    assert -1.0 <= r["evaluation"] <= 1.0


def test_illegal_move_rejected(server):
    call(server, "/api/new",
         {"white_type": "human", "black_type": "alphazero"})
    with pytest.raises(urllib.error.HTTPError) as e:
        call(server, "/api/move", {"move": [0, 0, 4, 4]})
    assert e.value.code == 400


def test_bot_vs_bot_move_and_state(server):
    call(server, "/api/new",
         {"white_type": "alphazero", "black_type": "baseline"})
    r = call(server, "/api/state")
    assert r["turn"] == "black"          # white bot moved on /api/new
    r2 = call(server, "/api/bot_move", {})
    assert "bot_move" in r2 and "engine" in r2  # baseline reports depth/nps
    assert r2["engine"]["nodes"] > 0


# -----------------------------------------------------------------------------
# (b) the static files
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["index.html", "app.js", "style.css"])
def test_static_files_equal_jax(name, server):
    import alphazero_tpu.web.server as jserver

    want = (Path(jserver.STATIC_DIR) / name).read_bytes()
    assert (Path(tserver.STATIC_DIR) / name).read_bytes() == want
    path = "/" if name == "index.html" else f"/{name}"
    with urllib.request.urlopen(server + path, timeout=60) as r:
        assert r.read() == want


# -----------------------------------------------------------------------------
# (c) the bot against the JAX package's
# -----------------------------------------------------------------------------

def test_bot_equals_jax_bot_under_toy_evaluator(monkeypatch, tmp_path):
    import alphazero_tpu.search.mcts as jmcts
    from alphazero_tpu.config import tiny_config as jtiny
    from alphazero_tpu.env import OracleGame as JOracle
    from alphazero_tpu.web import server as jserver
    from tests.test_mcts import fake_eval_jax
    from tests.test_torch_mcts import fake_eval_torch

    monkeypatch.setattr(jmcts, "make_net_evaluator",
                        lambda *a, **kw: fake_eval_jax)
    monkeypatch.setattr(tmcts, "make_net_evaluator",
                        lambda *a, **kw: fake_eval_torch)
    kw = dict(num_blocks=1, num_filters=8, num_simulations_inference=48,
              checkpoint_dir=str(tmp_path))
    jbot = jserver.BotService(jtiny(**kw))
    tbot = tserver.BotService(tiny_config(**kw), device="cpu")
    assert tbot.model_name == jbot.model_name == "random"

    rng = np.random.default_rng(4)
    t, j = OracleGame(), JOracle()
    for ply in range(24):
        if t.is_terminal():
            break
        got, want = tbot.alphazero_move(t), jbot.alphazero_move(j)
        assert got[0] == want[0], ply
        assert got[1] == want[1], ply
        assert t.get_legal_action_mask()[got[0]]
        # the bot's move every third ply, random ones between, so that
        # both sides to move and varied positions are searched
        a = got[0] if ply % 3 == 0 else int(rng.choice(t.get_legal_actions()))
        t.step_action(a)
        j.step_action(a)
    assert ply >= 12


# -----------------------------------------------------------------------------
# (d) on the card
# -----------------------------------------------------------------------------

A = 192
_W = torch.tensor((np.arange(A) * 5) % 8 + 1, dtype=torch.float32)
_SQ = torch.arange(A) // 3


@functools.cache
def _dyadic_weights(device):
    # on the card once, not at every call: a copy from the host could not
    # be captured in a CUDA graph
    return _W.to(device), _SQ.to(device)


def dyadic_eval(planes):
    """Integer policy weights and values in sixteenths: every output and
    every sum the search takes is exact in float32 in any order."""
    B = planes.shape[0]
    mine = planes[:, 0].reshape(B, 64)
    theirs = planes[:, 1].reshape(B, 64)
    weights, squares = _dyadic_weights(planes.device)
    w = weights * (1.0 + mine[:, squares])
    return w, (mine.sum(-1) - theirs.sum(-1)) / 16.0


def _midgames(seed, n):
    rng = np.random.default_rng(seed)
    games = []
    for _ in range(n):
        g = OracleGame()
        for _ in range(int(rng.integers(4, 30))):
            if g.is_terminal():
                break
            g.step_action(int(rng.choice(g.get_legal_actions())))
        games.append(g if not g.is_terminal() else OracleGame())
    return games


def _states(games, dev):
    return tenv.EnvState(
        board=torch.tensor(np.stack([g.board for g in games]),
                           dtype=torch.int8, device=dev),
        turn=torch.tensor([g.turn for g in games], dtype=torch.int8,
                          device=dev),
        winner=torch.zeros(len(games), dtype=torch.int8, device=dev),
        done=torch.zeros(len(games), dtype=torch.bool, device=dev),
        move_count=torch.tensor([g.move_count for g in games],
                                dtype=torch.int32, device=dev))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2])
def test_cuda_bot_search_equals_cpu(cuda, batch):
    from alphazero_torch.search import kernels as K

    games = _midgames(30 + batch, batch)
    spec = tmcts.SearchSpec(num_simulations=200)
    want = tmcts.search(_states(games, "cpu"), dyadic_eval, spec)
    launches = (K.descend.launches, K.commit_edges.launches)
    got = tmcts.search(_states(games, cuda), dyadic_eval, spec)
    torch.cuda.synchronize()
    assert (K.descend.launches, K.commit_edges.launches) == (
        launches[0] + 200, launches[1] + 200)
    assert torch.equal(got.rows.cpu(), want.rows)
    assert torch.equal(got.root_visit.cpu(), want.root_visit)
    assert torch.equal(got.root_vsum.cpu(), want.root_vsum)


@pytest.mark.gpu
def test_cuda_bot_answers_from_another_thread(cuda, monkeypatch, tmp_path):
    """The bot built on the card and asked from a new thread (as the
    server's handler threads ask it): its move and evaluation are the CPU
    bot's."""
    monkeypatch.setattr(tmcts, "make_net_evaluator",
                        lambda *a, **kw: dyadic_eval)
    cfg = tiny_config(num_blocks=1, num_filters=8,
                      num_simulations_inference=200,
                      checkpoint_dir=str(tmp_path))
    bots = {"cuda": tserver.BotService(cfg), "cpu": tserver.BotService(
        cfg, device="cpu")}
    assert bots["cuda"].device.type == "cuda"
    assert bots["cuda"].device.index is not None
    for game in _midgames(40, 3):
        out = {}
        for name, bot in bots.items():
            t = threading.Thread(
                target=lambda: out.update({name: bot.alphazero_move(game)}))
            t.start()
            t.join(timeout=300)
            assert not t.is_alive()
        assert out["cuda"] == out["cpu"]
