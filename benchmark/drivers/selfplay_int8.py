"""Continuous self-play with the int8-static evaluator.

``selfplay.Driver`` (``selfplay.py``) with the evaluator the JAX
package's round-5 production self-play runs, and the port's ``train
--selfplay-quant static``: the net quantised to int8 (``models/quant.py``)
with activation scales calibrated as ``Trainer._selfplay_evaluator``
calibrates them. After the base class's set-up (the bf16 evaluator
and its warm-up moves) the lanes play ``calibration_moves`` more moves
with the bf16 evaluator; from the seed, ``calibration_rows`` of those
moves' root planes are drawn with replacement, in batches of
``calibration_batch``, and ``quant.calibrate`` sets the scales. The int8
evaluator then plays the ``warmup_moves`` moves that capture its search,
and the window goes on from there. The check is the base class's:
the judged trees' priors and values against the reference net in
float32.
"""

from __future__ import annotations

import torch

from benchmark.drivers import selfplay


class Driver(selfplay.Driver):
    def setup(self) -> None:
        from alphazero_torch.env import breakthrough as env
        from alphazero_torch.models import quant

        from benchmark.lib import program

        super().setup()
        t = self.cell.traffic
        roots = []
        for _ in range(int(t["calibration_moves"])):
            roots.append(env.encoded_state(self.states))
            self.move(record=False)
        planes = torch.cat(roots)
        n, bs = int(t["calibration_rows"]), int(t["calibration_batch"])
        idx = torch.from_numpy(self.rng.integers(0, planes.shape[0],
                                                 size=n)).to(self.dev)
        net = program.build_net(self.cfg, self.weights, self.dev)
        qp = quant.quantize_network(net)
        scales = quant.calibrate(qp, [planes[idx[i:i + bs]]
                                      for i in range(0, n, bs)])
        self.eval_fn = quant.make_quant_evaluator(net, act_scales=scales,
                                                  qp=qp)
        del net, roots, planes
        for _ in range(int(t["warmup_moves"])):
            self.move(record=False)
        self._sync()
