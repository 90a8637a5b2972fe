"""PyTorch port's Trainer and checkpoints on the CPU, at ``tiny_config``
size: the contract of the JAX package's ``tests/test_trainer.py``."""

import json
import math
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch.config import tiny_config
from alphazero_torch.train import Trainer, cosine_lr
from alphazero_torch.train import checkpoint as ckpt


def make_tiny_trainer(tmp_path, seed=0, **kw):
    base = dict(checkpoint_dir=str(tmp_path / "ckpt"), num_simulations=8,
                parallel_games=4, batch_size=16, selfplay_batches=1,
                num_blocks=1, num_filters=8)
    base.update(kw)
    return Trainer(tiny_config(**base), seed=seed, device="cpu")


def _fixed_examples(n=64):
    rng = np.random.default_rng(0)
    ex = []
    for _ in range(n):
        s = (rng.random((3, 8, 8)) < 0.3).astype(np.float32)
        p = np.zeros(192, np.float32)
        p[rng.integers(192)] = 1.0
        ex.append((s, p, np.array([1.0, 0.0], np.float32)))
    return ex


def _equal_states(a, b):
    sa, sb = a.net.state_dict(), b.net.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_trainer_raises_without_a_card_and_for_quant(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(tiny_config(checkpoint_dir=str(tmp_path)))
    # the int8 self-play evaluator is ported: both flavours build one, an
    # unknown flavour is refused
    for flavor in ("static", "dynamic"):
        eval_fn = make_tiny_trainer(
            tmp_path, selfplay_quant=flavor)._selfplay_evaluator()
        policy, value = eval_fn(torch.zeros((2, 3, 8, 8)))
        assert policy.shape == (2, 192) and value.shape == (2,)
    with pytest.raises(ValueError, match="selfplay_quant"):
        make_tiny_trainer(tmp_path, selfplay_quant="int4")


def test_selfplay_produces_valid_examples(tmp_path):
    tr = make_tiny_trainer(tmp_path)
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    examples, stats = tr.execute_selfplay()
    assert stats["games"] >= 4
    assert len(examples) == stats["examples"] == stats["moves"] > 0
    s, p, wl = examples[0]
    assert s.shape == (3, 8, 8) and s.dtype == np.uint8
    assert p.shape == (192,) and p.sum() == pytest.approx(1.0, abs=1e-4)
    assert sorted(wl.tolist()) == [0.0, 1.0]
    # the bf16 evaluator is a copy: the f32 training net is untouched
    assert next(tr.net.parameters()).dtype == torch.float32
    for k, v in tr.net.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("device_replay", [True, False])
def test_learn_reduces_loss_on_fixed_buffer(tmp_path, device_replay):
    tr = make_tiny_trainer(tmp_path, device_replay=device_replay)
    assert tr.learn() == {}                              # empty buffer
    tr.buffer.add(_fixed_examples())
    m1 = tr.learn(epochs=1)
    for _ in range(8):
        m2 = tr.learn(epochs=1)
    assert m2["loss"] < m1["loss"]
    assert all(math.isfinite(v) for v in m2.values())
    assert tr.state.learn_calls == 9
    assert m2["lr"] == pytest.approx(cosine_lr(tr.cfg, 8), rel=1e-6)
    assert not tr.net.training


def test_device_replay_and_host_batches_train_alike(tmp_path):
    """The device-resident window and per-step host batches are the same
    training run, bit for bit, also after the ring grows and wraps."""
    a = make_tiny_trainer(tmp_path, device_replay=True, buffer_size=100)
    b = make_tiny_trainer(tmp_path, device_replay=False, buffer_size=100)
    for n in (40, 30, 50):                               # 120 > capacity
        ex = _fixed_examples(n)
        a.buffer.add(ex)
        b.buffer.add(ex)
        assert a.learn() == b.learn()
        np.testing.assert_array_equal(a._dev_replay[0].numpy(),
                                      a.buffer.states)
        np.testing.assert_array_equal(a._dev_replay[1].numpy(),
                                      a.buffer.policies)
    _equal_states(a.state, b.state)


def test_two_iterations_and_resume_round_trip(tmp_path):
    tr = make_tiny_trainer(tmp_path)
    m1 = tr.run_iteration()
    m2 = tr.run_iteration()
    assert (m1["iteration"], m2["iteration"]) == (1, 2)
    assert m1["examples_new"] > 0 and math.isfinite(m2["loss"])
    assert m2["buffer"] == m1["examples_new"] + m2["examples_new"]
    assert tr.state.learn_calls == 2
    assert m2["lr"] == pytest.approx(cosine_lr(tr.cfg, 1), rel=1e-6)
    cfg = tr.cfg
    for it in (1, 2):
        path = cfg.checkpoint_path(f"iteration_{it}")
        assert os.path.isdir(path) and not os.path.exists(path + ".tmp")
        assert ckpt.checkpoint_arch(path) == {
            "num_blocks": 1, "num_filters": 8, "se_ratio": 8,
            "scan_blocks": False}
    assert ckpt.get_latest_iteration(cfg) == 2
    assert sorted(ckpt.list_checkpoints(cfg)) == ["iteration_1",
                                                  "iteration_2"]
    with open(cfg.checkpoint_path("metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [line["iteration"] for line in lines] == [1, 2]
    with np.load(cfg.checkpoint_path("training_data.npz")) as data:
        assert len(data["states"]) == m2["buffer"]

    # another seed: everything it holds after resume() comes from disk
    tr2 = make_tiny_trainer(tmp_path, seed=9)
    assert tr2.resume() == 2 and tr2.iteration == 2
    assert len(tr2.buffer) == len(tr.buffer) == m2["buffer"]
    assert tr2.state.learn_calls == 2 and tr2.state.iteration == 2
    _equal_states(tr.state, tr2.state)
    for p, q in zip(tr.net.parameters(), tr2.net.parameters()):
        sa, sb = tr.state.opt.state[p], tr2.state.opt.state[q]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
        assert float(sa["step"]) == float(sb["step"])
    # and the two go on training alike
    ex = _fixed_examples(32)
    tr.buffer = tr2.buffer.__class__(64)
    tr2.buffer = tr2.buffer.__class__(64)
    tr._dev_replay = tr2._dev_replay = None
    tr.buffer.add(ex)
    tr2.buffer.add(ex)
    tr.np_rng = np.random.default_rng(3)
    tr2.np_rng = np.random.default_rng(3)
    assert tr.learn() == tr2.learn()
    _equal_states(tr.state, tr2.state)

    ckpt.sync_best_model(cfg, "iteration_2")
    assert ckpt.checkpoint_arch(cfg.checkpoint_path(cfg.best_model))[
        "num_filters"] == 8


def test_checkpoint_arch_wins_over_the_live_config(tmp_path):
    tr = make_tiny_trainer(tmp_path, num_blocks=2, num_filters=16)
    tr.save(1)
    tr2 = make_tiny_trainer(tmp_path)                    # 1 block x 8
    assert tr2.resume() == 1
    assert (tr2.cfg.num_blocks, tr2.cfg.num_filters) == (2, 16)
    _equal_states(tr.state, tr2.state)


def test_t_max_follows_live_config_after_resume(tmp_path):
    """The checkpoint carries the schedule position, but T_max always
    comes from the live config."""
    tr = make_tiny_trainer(tmp_path)
    tr.state.learn_calls = 50
    tr.save(1)
    tr2 = make_tiny_trainer(tmp_path, lr_t_max=100)
    tr2.resume()
    assert tr2.state.learn_calls == 50
    want = 1e-5 + (tr2.cfg.learning_rate - 1e-5) * (
        1 + math.cos(math.pi * 50 / 100)) / 2
    assert cosine_lr(tr2.cfg, tr2.state.learn_calls) == pytest.approx(
        want, rel=1e-9)


def test_train_forever_stops_at_max_iterations(tmp_path):
    tr = make_tiny_trainer(tmp_path)
    tr.train_forever(max_iterations=1)
    assert tr.iteration == 1
    tr2 = make_tiny_trainer(tmp_path)
    tr2.train_forever(max_iterations=1)                  # resumes, stops
    assert tr2.iteration == 1 and len(tr2.buffer) == len(tr.buffer)


def test_profile_dir_traces_a_phase_once(tmp_path):
    tr = make_tiny_trainer(tmp_path)
    tr.profile_dir = str(tmp_path / "prof")
    tr.buffer.add(_fixed_examples(16))
    tr.learn()
    table = os.path.join(tr.profile_dir, "learn", "key_averages.txt")
    assert os.path.exists(table)
    assert os.path.exists(os.path.join(tr.profile_dir, "learn",
                                       "trace.json"))
    os.remove(table)
    tr.learn()                                           # untraced
    assert not os.path.exists(table)
