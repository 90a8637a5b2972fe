"""The learn phase of a training iteration: the program's ``train_epoch``
over a device-resident replay buffer.

Set-up fills the buffer's ``buffer_size`` examples on the device from the
seed (random positions of some 16 pieces a side as input planes, soft
policy targets, a won or lost result), draws one epoch's batches as the
program's ``epoch_batches`` does (every example in both orientations
once, shuffled by a numpy generator from the seed: rows of a batch all
differ), and builds the program's training state (the float32 net from
the configuration's weights, Adam). It runs the epoch's first three
steps through ``train_epoch`` (one step, then two), keeping the losses,
Adam's first moment after step one and the parameters' change over the
three steps, and hands that same state to the window, which runs the
epoch on from step four in chunks of ``chunk_steps`` steps, the card
synchronised after each chunk. The rate is every example trained in the
window over the window.

The check trains the reference (``reflearn``) three steps on the same
rows from the same weights and compares each step's loss, the first
gradient as Adam took it (its first moment over ``1 - beta1``), and the
parameters' change.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark.lib import reflearn
from benchmark.lib.cell import Cell
from benchmark.lib.checks import Numbers, load_weights

CHECK_STEPS = 3


class Driver:
    kind = "learn"

    def __init__(self, cell: Cell):
        self.cell = cell
        t = cell.traffic
        self.B, self.N = int(t["batch"]), int(t["buffer"])
        self.dev = torch.device(cell.device)
        self.window_stats: Dict[str, float] = {}
        self.attempted = self.failed = 0

    def hyper(self) -> dict:
        c = self.cfg
        from alphazero_torch.train import learner

        return {"betas": (0.9, 0.999), "eps": 1e-8,
                "weight_decay": c.weight_decay,
                "grad_clip_norm": c.grad_clip_norm,
                "lr": learner.cosine_lr(c, 0)}

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from alphazero_torch.train import learner

        from benchmark.lib import program

        if self.dev.type == "cuda":
            program.build_kernels()
        self.weights = load_weights(self.cell)
        self.cfg = program.program_config(
            self.cell.config, batch_size=self.B, buffer_size=self.N)
        net = program.build_net(self.cfg, self.weights, self.dev)
        self.state = learner.create_train_state(self.cfg, net, self.dev)
        self.names = {program.module_name(k): k for k in self.weights
                      if k.startswith("params/")}
        self._fill_buffer()
        self._train_epoch = learner.train_epoch
        self.losses = []
        before = {self.names[n]: p.detach().clone()
                  for n, p in self.state.net.named_parameters()}
        self.run_steps(0, 1)
        beta1 = self.state.opt.defaults["betas"][0]
        # a step that left Adam without a moment took no gradient
        self.first_grad = {
            self.names[n]: self.state.opt.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)) / (1 - beta1)
            for n, p in self.state.net.named_parameters()}
        self.run_steps(1, CHECK_STEPS - 1)
        self.change = {self.names[n]: p.detach() - before[self.names[n]]
                       for n, p in self.state.net.named_parameters()}
        self.check_losses = torch.cat(self.losses)
        self.losses = []
        self.next_step = CHECK_STEPS
        self._sync()

    def _fill_buffer(self) -> None:
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.cell.seed)
        occ = torch.rand((self.N, 64), generator=gen, device=self.dev)
        mine, theirs = occ < 0.25, (occ >= 0.25) & (occ < 0.5)
        planes = torch.stack([mine, theirs, torch.ones_like(mine)], 1)
        self.planes = planes.view(self.N, 3, 8, 8).to(torch.uint8)
        logits = 2.0 * torch.randn((self.N, 192), generator=gen,
                                   device=self.dev)
        self.policies = torch.softmax(logits, -1)
        won = torch.rand((self.N, 1), generator=gen, device=self.dev) < 0.5
        self.wls = torch.cat([won, ~won], 1).float()
        rng = np.random.default_rng(self.cell.seed)
        n_aug = 2 * self.N
        steps = -(-n_aug // self.B)
        idx = np.resize(rng.permutation(n_aug), steps * self.B) \
            .reshape(steps, self.B)
        self.base_idx = torch.from_numpy(idx % self.N).to(self.dev)
        self.mirror = torch.from_numpy(idx >= self.N).to(self.dev)
        self.check_batches = [
            (self.planes[self.base_idx[i]], self.policies[self.base_idx[i]],
             self.wls[self.base_idx[i]], self.mirror[i])
            for i in range(CHECK_STEPS)]

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run_steps(self, start: int, n: int) -> None:
        """Steps ``start`` to ``start + n - 1`` of the epoch (wrapping at its
        end) through the program's ``train_epoch``."""
        rows = torch.arange(start, start + n, device=self.dev) \
            % self.base_idx.shape[0]
        out = self._train_epoch(self.state,
                                (self.planes, self.policies, self.wls),
                                self.base_idx[rows], self.mirror[rows],
                                self.cfg)
        self.losses.append(out["loss"])

    # -- the window -------------------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        chunk = int(self.cell.traffic["chunk_steps"])
        self._sync()
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.run_steps(self.next_step, chunk)
            self.next_step += chunk
            steps += chunk
            self._sync()
        elapsed = time.perf_counter() - t0
        losses = torch.cat(self.losses)
        self.attempted = steps
        self.failed = int((~torch.isfinite(losses)).sum())
        self.window_stats = {"seconds": elapsed, "steps": steps,
                             "examples": steps * self.B}
        return {"learn_examples_per_s": steps * self.B / elapsed}

    def stretch(self) -> int:
        """One more chunk of steps, as in the window; returns the steps."""
        n = int(self.cell.traffic["traced_steps"])
        self.run_steps(self.next_step, n)
        self.next_step += n
        return n

    def release(self) -> None:
        self.state = self.planes = self.policies = self.wls = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    def reference(self, **kw):
        return reflearn.train(self.weights, self.check_batches, self.hyper(),
                              CHECK_STEPS, **kw)

    def check(self, control: bool = False) -> Numbers:
        ref = self.reference()
        if control:
            prog = self.reference(precision="bfloat16")
        else:
            prog = (self.check_losses.cpu().numpy(), self.first_grad,
                    self.change)
        return reflearn.numbers(*prog, *ref)
