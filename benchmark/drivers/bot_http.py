"""A person playing the web bot: one closed-loop user over HTTP.

The program's web server (``web/server.py``: ``GameSession`` and
``make_handler`` in a ``ThreadingHTTPServer``) listens on 127.0.0.1 at a
port the system picks, in a thread of this process, and serves the
configuration's weights from a ``model_best`` checkpoint written under the
run's ``TMPDIR`` at set-up, as it would serve a user's. The user starts
each game with ``/api/new``, the bot's colour alternating by game, and
answers every bot move at once (no think time) with a legal move drawn
from the seed, by ``/api/move``; the server replies with the bot's move
(one batch-1 search of ``num_simulations_inference`` simulations). The
latency is each ``/api/move`` round trip on the host's clock.

For the check every reply is kept, and after each bot move the bot's tree
is copied on the device; after the window the reference replays every
game by the rules (each board the server reported, each tree's root) and
a sample of the trees, drawn from the seed, is judged (``treecheck``),
the bot's move held to be the root's most visited.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import refenv, treecheck
from benchmark.lib.cell import Cell
from benchmark.lib.checks import Numbers, evaluator_numbers, load_weights


def _p(values: List[float], q: float) -> float:
    """The nearest-rank ``q`` quantile."""
    s = sorted(values)
    return s[max(0, int(np.ceil(q * len(s))) - 1)]


class Driver:
    kind = "bot"

    def __init__(self, cell: Cell):
        self.cell = cell
        self.sims = int(cell.traffic["simulations"])
        self.dev = torch.device(cell.device)
        self.rng = np.random.default_rng(cell.seed)
        self.window_stats: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.httpd = self.thread = None

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from http.server import ThreadingHTTPServer

        from alphazero_torch.train import checkpoint, learner
        from alphazero_torch.web import server

        from benchmark.lib import program

        c = self.cell.config
        if self.dev.type == "cuda":
            program.build_kernels()
        self.weights = load_weights(self.cell)
        cfg = program.program_config(
            c, num_simulations_inference=self.sims,
            inference_dtype=c["search_precision"],
            checkpoint_dir=os.path.join(self.cell.tmpdir, "checkpoints"))
        self.c_puct = cfg.c_puct
        net = program.build_net(cfg, self.weights, self.dev)
        checkpoint.save_iteration_checkpoint(
            cfg, learner.create_train_state(cfg, net, self.dev), 0,
            name=cfg.best_model)
        del net
        self.session = server.GameSession(cfg, device=self.dev)
        self.httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), server.make_handler(self.session, cfg))
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.bot_white = bool(self.rng.integers(2))
        self.log: List[dict] = []
        self._new_game()
        for _ in range(int(self.cell.traffic["warmup_requests"])):
            self._user_move(timed=False)

    def _post(self, path: str, payload: dict) -> dict:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            conn.request("POST", path, body=json.dumps(payload),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        if resp.status != 200 or "error" in body:
            self.failed += 1
        return body

    def _snapshot(self) -> dict:
        tree = self.session.bot._tree
        with torch.inference_mode():
            return {"rows": tree.rows[0].clone(),
                    "root_visit": tree.root_visit[0].clone(),
                    "root_vsum": tree.root_vsum[0].clone()}

    def _new_game(self) -> None:
        bot = "alphazero"
        white, black = (bot, "human") if self.bot_white else ("human", bot)
        r = self._post("/api/new", {"white_type": white,
                                    "black_type": black})
        entry = {"kind": "new", "reply": r}
        if "bot_move" in r:
            entry["tree"] = self._snapshot()
        self.log.append(entry)
        self.legal = r.get("legal_moves", [])
        self.bot_white = not self.bot_white

    def _user_move(self, timed: bool = True) -> float:
        if not self.legal:
            self._new_game()
        move = self.legal[int(self.rng.integers(len(self.legal)))]
        t0 = time.perf_counter()
        r = self._post("/api/move", {"move": move})
        dt = time.perf_counter() - t0
        entry = {"kind": "move", "move": move, "reply": r}
        if "bot_move" in r:
            entry["tree"] = self._snapshot()
        self.log.append(entry)
        self.legal = [] if r.get("game_over") else r.get("legal_moves", [])
        if timed:
            self.attempted += 1
        return dt

    # -- the window -------------------------------------------------------
    def _searches(self) -> int:
        return sum(1 for e in self.log if "tree" in e)

    def window(self, seconds: float) -> Dict[str, float]:
        from benchmark.lib import program

        self.failed = 0
        lat: List[float] = []
        before, counted = self._searches(), program.counters()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(self._user_move())
        elapsed = time.perf_counter() - t0
        searches = self._searches() - before
        self.window_stats = {
            "seconds": elapsed, "requests": len(lat),
            "p50": _p(lat, 0.5), "p95": _p(lat, 0.95),
            "boards": searches * (self.sims + 1), "searches": searches,
            **program.window_counters(counted, 1)}
        return {"bot_move_p95_s": self.window_stats["p95"]}

    def stretch(self) -> int:
        """A few more requests, as in the window; returns the simulations
        they ran, as the search counted them."""
        from benchmark.lib import program

        before = program.counters()
        for _ in range(int(self.cell.traffic["traced_requests"])):
            self._user_move(timed=False)
        return program.counters().simulations - before.simulations

    def release(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.thread.join(timeout=60)
            self.httpd = None
        self.session = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def replay_games(self) -> int:
        """Every reply against the rules, game by game: the user's moves
        legal, each reported board the reference's, each tree rooted at
        the position the bot saw. Returns the mismatches."""
        bad = 0
        board = turn = None
        for e in self.log:
            r = e["reply"]
            if e["kind"] == "new":
                b, t = refenv.initial(1)
                board, turn = b, t
            else:
                a = refenv.encode_move(e["move"], int(turn[0]))
                legal = refenv.legal_mask(board, turn)[0]
                if a < 0 or not legal[a]:
                    bad += 1
                    continue
                board, turn, w = refenv.step(board, turn, np.array([a]))
                if w[0] and (not r.get("game_over") or "bot_move" in r):
                    bad += 1
            if "bot_move" in r:
                e["root"] = (board[0].copy(), int(turn[0]))
                a = refenv.encode_move(r["bot_move"], int(turn[0]))
                e["action"] = a
                legal = refenv.legal_mask(board, turn)[0]
                if a < 0 or not legal[a]:
                    bad += 1
                    continue
                board, turn, w = refenv.step(board, turn, np.array([a]))
                if bool(w[0]) != bool(r.get("game_over")):
                    bad += 1
            reported = np.array(r.get("board", []), np.int8)
            if reported.shape != (8, 8) or (reported != board[0]).any():
                bad += 1
        return bad

    def check(self, control: bool = False) -> Numbers:
        bad_env = self.replay_games()
        trees = [e for e in self.log if "tree" in e and "root" in e]
        n = min(int(self.cell.traffic["check_trees"]), len(trees))
        # a generator of its own: every check of a run judges one sample
        pick_rng = np.random.default_rng((self.cell.seed, 1))
        pick = sorted(pick_rng.choice(len(trees), n, replace=False)) \
            if n else []
        judged, bad_tree = [], 0
        for k in pick:
            e = trees[k]
            t = {key: v.cpu().numpy() for key, v in e["tree"].items()}
            j = treecheck.judge(t["rows"], e["root"][0], e["root"][1],
                                int(t["root_visit"]), float(t["root_vsum"]),
                                self.sims, self.c_puct, root_noise=False)
            # the bot plays the most visited move, the first of equals
            bad_tree += int(int(j.root_visits.argmax()) != e["action"])
            judged.append(j)
        numbers = evaluator_numbers(self.weights, judged, self.dev,
                                    control=control)
        numbers["tree_mismatch"] = bad_tree + sum(j.tree_mismatch
                                                  for j in judged)
        numbers["env_mismatch"] = bad_env + sum(j.env_mismatch
                                                for j in judged)
        numbers["select_gap"] = max((j.select_gap for j in judged),
                                    default=0.0)
        numbers["trees_judged"] = len(judged)
        return numbers
