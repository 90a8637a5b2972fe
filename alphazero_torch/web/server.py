"""Web UI / JSON API server (stdlib http.server, no Flask dependency).

Port of ``alphazero_tpu/web/server.py`` with the same HTTP surface:

  GET  /                    the web UI
  GET  /api/models          available checkpoints + current selection
  GET  /api/config          board constants for the frontend
  POST /api/models/select   {model}
  POST /api/new             {white_type, black_type} in
                            {human, alphazero, baseline}; a bot White
                            moves immediately
  POST /api/move            {move: [fr, fc, tr, tc]} -> validate, step,
                            auto bot reply
  POST /api/bot_move        force the side to move (bot) to move
  GET  /api/state           current board/turn/legal moves/result

Bot move semantics are the JAX package's: AlphaZero = greedy most-visited
move of one batched search (batch 1) at ``num_simulations_inference``
with no noise, on the card unless the server was given the CPU, plus a
White-positive evaluation from the root value; baseline = alpha-beta
search on a time budget. The bot's evaluator is the net at
``cfg.inference_dtype`` (bf16), as the JAX package keeps web, arena and
anchors in bf16.

``ThreadingHTTPServer`` answers each request on a new thread. Grad mode
and the current CUDA device are per thread in PyTorch, so the bot sets
both inside ``alphazero_move``; ``GameSession.lock`` is held across the
whole search.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from alphazero_torch import resolve_device
from alphazero_torch.baseline import Search, from_board
from alphazero_torch.config import Config
from alphazero_torch.env import BLACK, WHITE, OracleGame
from alphazero_torch.env.oracle import live_states
from alphazero_torch.search import (
    init_tree,
    root_action_probs,
    root_value,
    search,
)
from alphazero_torch.train import checkpoint as ckpt
from alphazero_torch.utils import setup_logging

log = setup_logging()

STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")
BASELINE_TIME_MS = 2000


class BotService:
    """Holds the loaded model's evaluator and the single-game search."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # handler threads start on device 0: pin the index now
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.model_name = "random"
        self._eval_fn = None
        self._load_initial()

    def _load_initial(self) -> None:
        """best -> latest -> random."""
        best = self.cfg.checkpoint_path(self.cfg.best_model)
        if os.path.isdir(best):
            self.load(self.cfg.best_model)
            return
        latest = ckpt.get_latest_iteration(self.cfg)
        if latest > 0:
            self.load(f"iteration_{latest}")
            return
        self._build(None)
        self.model_name = "random"

    def load(self, name: str) -> tuple[bool, str]:
        path = self.cfg.checkpoint_path(name)
        if not os.path.isdir(path):
            return False, f"Model not found: {name}"
        try:
            self._build(path)
            self.model_name = name
            return True, f"Loaded {name}"
        except Exception as e:  # noqa: BLE001 (reported to the client)
            log.exception("loading %s failed", name)
            return False, f"Error loading model: {e}"

    def _build(self, path: Optional[str]) -> None:
        # imported here, as the JAX package does, so that tests can swap
        # the evaluator for a toy one
        from alphazero_torch.search.mcts import (
            SearchSpec,
            make_net_evaluator,
        )

        if path is None:
            from alphazero_torch.models.network import build_network

            net = build_network(self.cfg, self.device,
                                generator=torch.Generator().manual_seed(0))
        else:
            from alphazero_torch.arena.runner import load_model

            net = load_model(self.cfg, path, self.device)
        self._eval_fn = make_net_evaluator(
            net, getattr(torch, self.cfg.inference_dtype))
        self._spec = SearchSpec(
            num_simulations=self.cfg.num_simulations_inference,
            c_puct=self.cfg.c_puct, fpu_reduction=self.cfg.fpu_reduction)
        self._tree = None

    def alphazero_move(self, game: OracleGame) -> tuple[int, float]:
        """(action, evaluation): greedy most-visited; eval White-positive."""
        dev = self.device
        on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
        with torch.inference_mode(), on_card:
            states = live_states([game], dev)
            # one batch-1 tree, reset for every move: on the card every
            # move replays the simulation the first one captured (always
            # under inference mode, in which its tensors were made)
            self._tree = init_tree(states, self._spec, tree=self._tree)
            tree = search(states, self._eval_fn, self._spec, tree=self._tree)
            action = int(root_action_probs(tree, 0.0).argmax(-1)[0])
            ev = float(root_value(tree)[0])
        if game.turn == BLACK:
            ev = -ev
        return action, ev


class GameSession:
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.lock = threading.Lock()
        self.game: Optional[OracleGame] = None
        self.white_type = "human"
        self.black_type = "alphazero"
        self.bot = BotService(cfg, device)
        self.baseline = Search(time_limit_ms=BASELINE_TIME_MS)

    # -- helpers --------------------------------------------------------
    def board_json(self) -> dict:
        g = self.game
        return {
            "board": [[int(v) for v in row] for row in g.board],
            "turn": "white" if g.turn == WHITE else "black",
        }

    def legal_moves_json(self) -> list:
        return [list(m) for m in self.game.get_legal_moves()]

    def result_str(self) -> Optional[str]:
        if not self.game.is_terminal():
            return None
        w, _ = self.game.get_result()
        return "White wins!" if w == 1.0 else "Black wins!"

    def state_response(self) -> dict:
        r = self.board_json()
        r["game_over"] = self.game.is_terminal()
        r["result"] = self.result_str()
        r["legal_moves"] = ([] if self.game.is_terminal()
                            else self.legal_moves_json())
        r["model"] = self.bot.model_name
        return r

    # -- bot dispatch ------------------------------------------------------
    def resolve_bot_move(self) -> dict:
        turn = self.game.turn
        ptype = self.white_type if turn == WHITE else self.black_type
        if ptype == "alphazero":
            return self.make_alphazero_move()
        if ptype == "baseline":
            return self.make_baseline_move()
        return {"error": "It is human turn"}

    def _after_bot_move(self, move, ev: float) -> dict:
        r = self.board_json()
        r.update({
            "bot_move": list(move),
            "evaluation": ev,
            "game_over": self.game.is_terminal(),
            "result": self.result_str(),
            "legal_moves": ([] if self.game.is_terminal()
                            else self.legal_moves_json()),
        })
        return r

    def make_alphazero_move(self) -> dict:
        action, ev = self.bot.alphazero_move(self.game)
        move = self.game.decode_action(action)
        self.game.step(move)
        return self._after_bot_move(move, ev)

    def make_baseline_move(self) -> dict:
        pos = from_board(self.game.board, self.game.turn)
        (frm, to), score, info = self.baseline.search(
            pos, time_ms=BASELINE_TIME_MS)
        move = (frm // 8, frm % 8, to // 8, to % 8)
        self.game.step(move)
        ev = score / 1000.0
        if self.game.turn == WHITE:  # mover was black: flip to White-positive
            ev = -ev
        r = self._after_bot_move(move, max(-1.0, min(1.0, ev)))
        r["engine"] = {"depth": info["depth"], "nodes": info["nodes"],
                       "nps": info["nps"]}
        return r


def make_handler(session: GameSession, cfg: Config):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        # -- plumbing -----------------------------------------------------
        def _json(self, payload: dict, status: int = 200) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if not n:
                return {}
            try:
                return json.loads(self.rfile.read(n))
            except json.JSONDecodeError:
                return {}

        def _static(self, name: str) -> None:
            path = os.path.join(STATIC_DIR, name)
            if not os.path.isfile(path):
                self._json({"error": "not found"}, 404)
                return
            ctype = ("text/html" if name.endswith(".html") else
                     "application/javascript" if name.endswith(".js") else
                     "text/css" if name.endswith(".css") else "text/plain")
            with open(path, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # -- routes -------------------------------------------------------
        def do_GET(self):
            if self.path in ("/", "/index.html"):
                return self._static("index.html")
            if self.path in ("/app.js", "/style.css"):
                return self._static(self.path[1:])
            if self.path == "/api/models":
                models = [{"name": n, "path": p,
                           "size_mb": round(_dir_size(p) / 2**20, 2)}
                          for n, p in ckpt.list_checkpoints(cfg).items()]
                best = cfg.checkpoint_path(cfg.best_model)
                if os.path.isdir(best):
                    models.append({"name": cfg.best_model, "path": best,
                                   "size_mb": round(_dir_size(best) / 2**20,
                                                    2)})
                return self._json({"models": models,
                                   "current": session.bot.model_name})
            if self.path == "/api/config":
                return self._json({"board_size": cfg.board_size,
                                   "num_actions": cfg.num_actions})
            if self.path == "/api/state":
                with session.lock:
                    if session.game is None:
                        return self._json({"error": "No game in progress"},
                                          400)
                    return self._json(session.state_response())
            self._json({"error": "not found"}, 404)

        def do_POST(self):
            data = self._body()
            if self.path == "/api/models/select":
                name = data.get("model")
                if not name:
                    return self._json({"error": "No model specified"}, 400)
                with session.lock:
                    ok, msg = session.bot.load(name)
                if not ok:
                    status = 404 if "not found" in msg.lower() else 500
                    return self._json({"error": msg}, status)
                return self._json({"success": True,
                                   "current": session.bot.model_name,
                                   "message": msg})

            if self.path == "/api/new":
                with session.lock:
                    session.white_type = data.get("white_type", "human")
                    session.black_type = data.get("black_type", "alphazero")
                    session.game = OracleGame()
                    r = session.board_json()
                    r.update({
                        "white_type": session.white_type,
                        "black_type": session.black_type,
                        "game_over": False,
                        "model": session.bot.model_name,
                        "legal_moves": session.legal_moves_json(),
                    })
                    if session.white_type != "human":
                        r.update(session.resolve_bot_move())
                return self._json(r)

            if self.path == "/api/move":
                with session.lock:
                    if session.game is None:
                        return self._json({"error": "No game in progress"},
                                          400)
                    move_data = data.get("move")
                    if not move_data or len(move_data) != 4:
                        return self._json({"error": "Invalid move format"},
                                          400)
                    move = tuple(int(x) for x in move_data)
                    if move not in session.game.get_legal_moves():
                        return self._json({"error": "Illegal move"}, 400)
                    session.game.step(move)
                    just_moved = ("white" if session.game.turn == BLACK
                                  else "black")
                    if session.game.is_terminal():
                        r = session.board_json()
                        r.update({"game_over": True,
                                  "result": session.result_str(),
                                  "legal_moves": [],
                                  "moved_player": just_moved})
                        return self._json(r)
                    r = session.board_json()
                    r["moved_player"] = just_moved
                    nxt = (session.white_type
                           if session.game.turn == WHITE
                           else session.black_type)
                    if nxt != "human":
                        r.update(session.resolve_bot_move())
                    else:
                        r["legal_moves"] = session.legal_moves_json()
                return self._json(r)

            if self.path == "/api/bot_move":
                with session.lock:
                    if session.game is None:
                        return self._json({"error": "No game in progress"},
                                          400)
                    if session.game.is_terminal():
                        return self._json(
                            {"error": "Game already finished"}, 400)
                    r = session.resolve_bot_move()
                return self._json(r)

            self._json({"error": "not found"}, 404)

    return Handler


def _dir_size(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    return total


def serve(cfg: Config, host: str = "0.0.0.0", port: int = 5051,
          device="cuda") -> None:
    """Serve until interrupted (or ``shutdown()``); port 0 picks a free
    port, which the log line names."""
    session = GameSession(cfg, device)
    with ThreadingHTTPServer((host, port),
                             make_handler(session, cfg)) as httpd:
        log.info("web server on http://%s:%d (model: %s, on %s)", host,
                 httpd.server_address[1], session.bot.model_name,
                 session.bot.device)
        httpd.serve_forever()
