"""Continuous self-play with MuZero's board-game nets and their bf16
evaluator, searched over the tree's latent store.

``selfplay.Driver`` (``selfplay.py``: its lanes, window, records, tree
copies and the rules' check of every copied move) with another net and
another tree check: the configuration's MuZero nets (``body`` "muzero",
16 + 16 blocks of 256 at the paper's widths), on weights drawn on the
card from the seed and calibrated (``lib/muzero.py``), searched through
the program's ``Config``, ``build_network``'s net and
``make_net_evaluator``, which gives MuZero's recurrent evaluator and its
bf16 route (``models/muzero_inference.py``). A copied tree takes its
reward and latent stores with it; the judged trees are replayed with the
backup with rewards (``lib/muzero_treecheck.py``) and every node's stored
state, reward, priors and value compared with the reference one step at
a time from its parent's stored state (``muzero.evaluator_numbers``).

A program without MuZero's body refuses the configuration when its
``Config`` is made, the first thing set-up does.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.drivers import selfplay
from benchmark.lib import muzero, muzero_treecheck
from benchmark.lib.checks import Numbers

# the configuration's sizes that the program's Config takes
MZ_FIELDS = ("mz_blocks", "mz_filters")


class Driver(selfplay.Driver):
    def setup(self) -> None:
        from alphazero_torch.config import Config
        from alphazero_torch.env import breakthrough as env
        from alphazero_torch.models.network import build_network
        from alphazero_torch.search import mcts
        from alphazero_torch.train import selfplay as program_selfplay

        from benchmark.lib import program

        c, t = self.cell.config, self.cell.traffic
        self.cfg = Config(
            body="muzero", **{k: c[k] for k in MZ_FIELDS},
            num_simulations=self.sims, parallel_games=self.lanes,
            c_puct=t["c_puct"], dirichlet_alpha=t["dirichlet_alpha"],
            dirichlet_epsilon=t["dirichlet_epsilon"],
            temperature_threshold=t["temperature_moves"], tree_reuse=False)
        if self.dev.type == "cuda":
            program.build_kernels()
        self.weights = muzero.seeded(c, self.cell.seed, self.dev)
        with torch.device(self.dev):
            net = build_network(self.cfg, self.dev)
        own = net.state_dict()
        net.load_state_dict({**self.weights, **{
            k: v for k, v in own.items() if k.endswith("batches_tracked")}})
        self.eval_fn = mcts.make_net_evaluator(
            net, getattr(torch, c["search_precision"]))
        del net
        self.spec = program_selfplay.search_spec(self.cfg)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(self.cell.seed)
        self.states = env.initial_state((self.lanes,), device=self.dev)
        self.tree = mcts.init_tree(self.states, self.spec)
        self._move = program_selfplay.selfplay_move_autoreset
        self.watch = torch.from_numpy(np.sort(self.rng.choice(
            self.lanes, min(int(t["check_lanes"]), self.lanes),
            replace=False))).to(self.dev)
        self.records: List[dict] = []
        for _ in range(int(t["warmup_moves"])):
            self.move(record=False)
        self._sync()

    def move(self, record: bool = True) -> None:
        """``selfplay.Driver.move``; a copied tree takes its reward store
        and its latent store (the bf16 bits, as int16) with it."""
        n = len(self.records)
        super().move(record)
        if record and "rows" in self.records[n]:
            w, tr = self.watch, self.tree
            latent = tr.latent[w]
            if latent.dtype == torch.bfloat16:
                latent = latent.view(torch.int16)
            self.records[n].update(reward=tr.reward[w], latent=latent)

    def judged(self, recs: List[dict]):
        trees = [(i, lane) for i, r in enumerate(recs) if "rows" in r
                 for lane in range(len(r["turn"]))]
        n = min(int(self.cell.traffic["check_trees"]), len(trees))
        pick_rng = np.random.default_rng((self.cell.seed, 1))
        pick = sorted(pick_rng.choice(len(trees), n, replace=False)) \
            if n else []
        out = []
        for k in pick:
            i, lane = trees[k]
            r = recs[i]
            latent = r["latent"][lane]
            if latent.dtype == np.int16:
                latent = torch.from_numpy(latent).view(torch.bfloat16)
            else:
                latent = torch.from_numpy(latent)
            out.append(muzero_treecheck.judge(
                r["rows"][lane], r["reward"][lane],
                latent.float().numpy(), r["root_board"][lane],
                int(r["root_turn"][lane]), int(r["root_visit"][lane]),
                float(r["root_vsum"][lane]), self.sims, self.spec.c_puct))
        return out

    def check(self, control: bool = False) -> Numbers:
        recs = self._host_records()
        judged = self.judged(recs)
        numbers = muzero.evaluator_numbers(self.weights, judged, self.dev,
                                           control=control)
        numbers["tree_mismatch"] = sum(j.tree_mismatch for j in judged)
        numbers["env_mismatch"] = (sum(j.env_mismatch for j in judged)
                                   + self.outcome_mismatches(recs))
        numbers["select_gap"] = max((j.select_gap for j in judged),
                                    default=0.0)
        numbers["trees_judged"] = len(judged)
        return numbers
