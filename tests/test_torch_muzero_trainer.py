"""MuZero's nets on the port's normal path, on the CPU at a tiny size: the
Trainer's iterations (self-play over the latent store, the trajectory
replay, the unrolled learn step, checkpoint and resume keeping the arch),
the arena's match between two MuZero checkpoints, a web bot move from one,
the CLI's ``--body muzero`` and the refusals (tree reuse, int8, a MuZero
net against another body)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch.arena.match import play_paired_matches, random_opening
from alphazero_torch.arena.runner import load_model
from alphazero_torch.config import tiny_muzero_config
from alphazero_torch.env import OracleGame
from alphazero_torch.models.muzero import MuZeroNet
from alphazero_torch.models.network import build_network
from alphazero_torch.train import Trainer
from alphazero_torch.train import checkpoint as ckpt
from alphazero_torch.train.replay import load_training_data, ReplayBuffer
from alphazero_torch.web import server


def _cfg(tmp_path, **kw):
    base = dict(checkpoint_dir=str(tmp_path / "ckpt"), num_simulations=6,
                num_simulations_inference=6, parallel_games=4,
                batch_size=16, selfplay_batches=1, mz_filters=8,
                max_game_length=160)
    base.update(kw)
    return tiny_muzero_config(**base)


def _equal_nets(a, b):
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def test_two_iterations_checkpoint_and_resume_the_muzero_nets(tmp_path):
    tr = Trainer(_cfg(tmp_path), seed=0, device="cpu")
    assert isinstance(tr.net, MuZeroNet) and tr.buffer.actions is not None
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    m = tr.run_iteration()
    assert m["iteration"] == 1 and m["examples_new"] > 0
    assert np.isfinite(m["loss_r"]) and m["loss"] > m["loss_pi"]
    changed = [k for k, v in tr.net.state_dict().items()
               if not torch.equal(before[k], v)]
    # g, its reward head and h all learned
    for part in ("dynamics_tower", "reward_fc2", "represent_tower"):
        assert any(k.startswith(part) for k in changed), part
    # the replay holds whole games in order: a game's last ply has 0 left
    n = len(tr.buffer)
    left = tr.buffer.left[:n]
    ends = np.flatnonzero(left == 0)
    assert ends[-1] == n - 1
    assert (np.diff(left)[np.diff(left) != -1] > 0).all()
    path = tr.cfg.checkpoint_path("iteration_1")
    assert ckpt.checkpoint_arch(path) == {**tr.cfg.arch(),
                                          "scan_blocks": False}
    # a live config of another body: the checkpoint's arch wins, and the
    # trajectories come back from disk with their actions
    other = Trainer(_cfg(tmp_path).replace(body="se_resnet", num_blocks=1,
                                           num_filters=8),
                    seed=3, device="cpu")
    assert other.resume() == 1
    assert other.cfg.arch() == tr.cfg.arch()
    _equal_nets(tr.net, other.net)
    assert other.muzero and len(other.buffer) == len(tr.buffer)
    again = Trainer(_cfg(tmp_path), seed=3, device="cpu")
    assert again.resume() == 1 and len(again.buffer) == n
    assert np.array_equal(again.buffer.actions[:n], tr.buffer.actions[:n])
    m2 = again.run_iteration()
    assert m2["iteration"] == 2 and m2["buffer"] > n
    _equal_nets(tr.net, load_model(tiny_muzero_config().replace(
        body="se_resnet"), path, device="cpu"))


def test_a_plain_buffer_loads_no_trajectories(tmp_path):
    """A trajectory buffer takes nothing from a data file without actions;
    a plain one takes a MuZero file's examples."""
    tr = Trainer(_cfg(tmp_path, parallel_games=2), seed=1, device="cpu")
    ex, _ = tr.execute_selfplay()
    tr.append_data(ex)
    data = tr._data_path()
    plain = ReplayBuffer(1000)
    assert load_training_data(data, plain) == len(ex)
    from alphazero_torch.train.replay import append_training_data

    old = str(tmp_path / "old.npz")
    append_training_data(old, [e[:3] for e in ex])
    assert load_training_data(old, ReplayBuffer(1000, trajectory=True)) == 0


def test_the_web_bot_and_the_arena_take_muzero_checkpoints(tmp_path):
    cfg = _cfg(tmp_path)
    tr = Trainer(cfg, seed=1, device="cpu")
    tr.save(1)
    Trainer(cfg, seed=2, device="cpu").save(2)
    bot = server.BotService(cfg.replace(body="se_resnet"), device="cpu")
    ok, msg = bot.load("iteration_1")
    assert ok, msg
    game = OracleGame()
    action, value = bot.alphazero_move(game)
    assert action in game.get_legal_actions() and -1.0 <= value <= 1.0
    # a second move replays on the same tree and store
    game.step_action(action)
    action, _ = bot.alphazero_move(game)
    assert action in game.get_legal_actions()
    import random

    a = load_model(cfg, cfg.checkpoint_path("iteration_1"), "cpu")
    b = load_model(cfg, cfg.checkpoint_path("iteration_2"), "cpu")
    openings = [random_opening(random.Random(0))]
    wa, wb = play_paired_matches(a, b, openings, cfg.replace(
        inference_dtype="float32"), num_simulations=4, max_moves=200,
        device="cpu")
    assert wa + wb == 2


def test_the_refusals(tmp_path):
    with pytest.raises(ValueError, match="tree_reuse"):
        Trainer(_cfg(tmp_path, tree_reuse=True), device="cpu")
    with pytest.raises(ValueError, match="selfplay_quant"):
        Trainer(_cfg(tmp_path, selfplay_quant="static"), device="cpu")
    from alphazero_torch.arena.match import make_pair_evaluator

    mz = build_network(_cfg(tmp_path), "cpu")
    se = build_network(tiny_muzero_config(body="se_resnet"), "cpu")
    with pytest.raises(ValueError, match="MuZero"):
        make_pair_evaluator(mz, se, torch.float32)


def test_the_cli_sizes_the_muzero_nets():
    from alphazero_torch.main import build_config, build_parser

    parse = build_parser().parse_args
    cfg = build_config(parse(["train", "--body", "muzero", "--blocks", "3",
                              "--filters", "32"]))
    assert (cfg.body, cfg.mz_blocks, cfg.mz_filters, cfg.num_filters) == \
        ("muzero", 3, 32, 128)
    cfg = build_config(parse(["train", "--body", "muzero"]))
    assert (cfg.mz_blocks, cfg.mz_filters, cfg.mz_unroll) == (16, 256, 5)
