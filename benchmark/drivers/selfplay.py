"""Continuous self-play: the trainer's self-play at a fixed lane count.

Every lane plays its own game; all lanes move in lockstep through the
program's ``selfplay_move_autoreset`` with one tree kept across moves (as
``selfplay_games_continuous`` keeps it), so every move replays the
simulation that the first move captured, and a lane whose game ended
starts a new one at once: every search is real work. Dirichlet noise at
the root, temperature 1 for a game's first ``temperature_moves`` moves
and then the most visited move, no tree reuse, the bf16 evaluator.

The rate is every simulation of every lane over the whole window.

For the check, ``check_lanes`` lanes drawn from the seed are copied on
the device after every move (their root, the move's training target, the
move's outcome) and, on a share ``tree_share`` of the moves, their whole
tree; after the window a sample of those trees, drawn from the seed, is
judged (``treecheck``) and their positions evaluated by the reference
net, and every copied move's outcome is held to the rules.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import refenv, treecheck
from benchmark.lib.cell import Cell
from benchmark.lib.checks import Numbers, evaluator_numbers, load_weights


class Driver:
    kind = "selfplay"

    def __init__(self, cell: Cell):
        self.cell = cell
        t = cell.traffic
        self.lanes, self.sims = int(t["lanes"]), int(t["simulations"])
        self.dev = torch.device(cell.device)
        self.rng = np.random.default_rng(cell.seed)
        self.window_stats: Dict[str, float] = {}
        self.attempted = self.failed = 0

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from alphazero_torch.env import breakthrough as env
        from alphazero_torch.search import mcts
        from alphazero_torch.train import selfplay

        from benchmark.lib import program

        c, t = self.cell.config, self.cell.traffic
        if self.dev.type == "cuda":
            program.build_kernels()
        self.weights = load_weights(self.cell)
        self.cfg = program.program_config(
            c, num_simulations=self.sims, parallel_games=self.lanes,
            c_puct=t["c_puct"], dirichlet_alpha=t["dirichlet_alpha"],
            dirichlet_epsilon=t["dirichlet_epsilon"],
            temperature_threshold=t["temperature_moves"], tree_reuse=False)
        net = program.build_net(self.cfg, self.weights, self.dev)
        self.eval_fn = mcts.make_net_evaluator(
            net, getattr(torch, c["search_precision"]))
        del net
        self.spec = selfplay.search_spec(self.cfg)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(self.cell.seed)
        self.states = env.initial_state((self.lanes,), device=self.dev)
        self.tree = mcts.init_tree(self.states, self.spec)
        self._move = selfplay.selfplay_move_autoreset
        self.watch = torch.from_numpy(np.sort(self.rng.choice(
            self.lanes, min(int(t["check_lanes"]), self.lanes),
            replace=False))).to(self.dev)
        self.records: List[dict] = []
        for _ in range(int(t["warmup_moves"])):
            self.move(record=False)
        self._sync()

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def move(self, record: bool = True) -> None:
        """One lockstep move of every lane; copies the watched lanes."""
        w = self.watch
        pre = self.states
        self.states, planes, probs, ended, winner = self._move(
            pre, self.gen, self.eval_fn, self.spec,
            self.cfg.temperature_threshold, self.tree)
        if not record:
            return
        rec = {"board": pre.board[w], "turn": pre.turn[w],
               "move_count": pre.move_count[w], "planes": planes[w],
               "probs": probs[w], "ended": ended[w], "winner": winner[w],
               "next_board": self.states.board[w],
               "next_turn": self.states.turn[w],
               "next_move_count": self.states.move_count[w]}
        if self.rng.random() < float(self.cell.traffic["tree_share"]):
            tr = self.tree
            rec.update(rows=tr.rows[w], root_visit=tr.root_visit[w],
                       root_vsum=tr.root_vsum[w],
                       root_board=tr.root_state.board[w],
                       root_turn=tr.root_state.turn[w])
        self.records.append(rec)

    # -- the window -------------------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        from benchmark.lib import program

        self._sync()
        before = program.counters()
        t0 = time.perf_counter()
        moves = 0
        while time.perf_counter() - t0 < seconds:
            self.move()
            moves += 1
        self._sync()
        elapsed = time.perf_counter() - t0
        self.attempted = moves * self.lanes
        sims = moves * self.lanes * self.sims
        self.window_stats = {
            "seconds": elapsed, "moves": moves,
            # the root's evaluation and one a simulation, every lane
            "boards": moves * self.lanes * (self.sims + 1),
            **program.window_counters(before, self.lanes)}
        return {"selfplay_sims_per_s": sims / elapsed}

    def stretch(self) -> int:
        """One more move, as in the window (for the profiler); returns the
        simulations (of the whole batch) it ran, as the search counted
        them."""
        from benchmark.lib import program

        before = program.counters()
        self.move(record=False)
        return program.counters().simulations - before.simulations

    def release(self) -> None:
        """Free the program's state; the copies stay."""
        self.eval_fn = self.tree = self.states = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def _host_records(self) -> List[dict]:
        return [{k: v.cpu().numpy() for k, v in r.items()}
                for r in self.records]

    def judged(self, recs: List[dict]):
        trees = [(i, lane) for i, r in enumerate(recs) if "rows" in r
                 for lane in range(len(r["turn"]))]
        n = min(int(self.cell.traffic["check_trees"]), len(trees))
        # a generator of its own: every check of a run judges one sample
        pick_rng = np.random.default_rng((self.cell.seed, 1))
        pick = sorted(pick_rng.choice(len(trees), n, replace=False)) \
            if n else []
        out = []
        for k in pick:
            i, lane = trees[k]
            r = recs[i]
            out.append(treecheck.judge(
                r["rows"][lane], r["root_board"][lane],
                int(r["root_turn"][lane]), int(r["root_visit"][lane]),
                float(r["root_vsum"][lane]), self.sims, self.spec.c_puct,
                root_noise=True))
        return out

    def outcome_mismatches(self, recs: List[dict]) -> int:
        """Every copied move against the rules: the recorded planes, the
        training target against the root's visits, the move played (a
        visited one, the most visited after the temperature moves) and
        the next root, a new game where this one ended."""
        bad = 0
        start_board, _ = refenv.initial(1)
        tm = int(self.cell.traffic["temperature_moves"])
        for r in recs:
            boards, turns = r["board"], r["turn"]
            planes = refenv.planes(boards, turns)
            bad += int((planes != r["planes"]).any((1, 2, 3)).sum())
            for j in range(len(turns)):
                probs = r["probs"][j]
                cand = np.flatnonzero(probs > 0)
                greedy = r["move_count"][j] >= tm
                if "rows" in r:
                    visits = r["rows"][j].reshape(
                        r["rows"].shape[1], -1)[0, 2 * 192:3 * 192]
                    want = (np.eye(192)[visits.argmax()] if greedy
                            else visits / visits.sum())
                    bad += int(np.abs(probs - want).max() > 1e-6)
                if greedy and len(cand) != 1:
                    bad += 1
                    continue
                b, t, w = refenv.step(np.repeat(boards[j:j + 1], len(cand),
                                                0),
                                      np.repeat(turns[j:j + 1], len(cand)),
                                      cand)
                if r["ended"][j]:
                    ok = ((w == r["winner"][j]) & (w != 0)).any() and (
                        (r["next_board"][j] == start_board[0]).all()
                        and r["next_turn"][j] == refenv.WHITE
                        and r["next_move_count"][j] == 0)
                else:
                    ok = ((b == r["next_board"][j]).all((1, 2))
                          & (t == r["next_turn"][j]) & (w == 0)).any() and (
                        r["next_move_count"][j] == r["move_count"][j] + 1)
                bad += int(not ok)
        return bad

    def check(self, control: bool = False) -> Numbers:
        recs = self._host_records()
        judged = self.judged(recs)
        numbers = evaluator_numbers(self.weights, judged, self.dev,
                                    control=control)
        numbers["tree_mismatch"] = sum(j.tree_mismatch for j in judged)
        numbers["env_mismatch"] = (sum(j.env_mismatch for j in judged)
                                   + self.outcome_mismatches(recs))
        numbers["select_gap"] = max((j.select_gap for j in judged),
                                    default=0.0)
        numbers["trees_judged"] = len(judged)
        return numbers
