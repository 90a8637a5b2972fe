"""The nested-bottleneck body on the port's normal path, on the CPU at a tiny
size: the Trainer's iteration (self-play, a learn step, checkpoint and
resume keeping the arch), the arena's load of an nbt checkpoint, a web bot
move from one, and the CLI's ``--body nbt``."""

import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch.arena.runner import load_model
from alphazero_torch.config import tiny_nbt_config
from alphazero_torch.env import OracleGame
from alphazero_torch.models.nbt import NbtNet
from alphazero_torch.train import Trainer
from alphazero_torch.train import checkpoint as ckpt
from alphazero_torch.web import server


def _cfg(tmp_path, **kw):
    base = dict(checkpoint_dir=str(tmp_path / "ckpt"), num_simulations=8,
                num_simulations_inference=8, parallel_games=4,
                batch_size=16, selfplay_batches=1)
    base.update(kw)
    return tiny_nbt_config(**base)


def _equal_nets(a, b):
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def test_an_iteration_checkpoints_and_resumes_the_nbt_body(tmp_path):
    tr = Trainer(_cfg(tmp_path), seed=0, device="cpu")
    assert isinstance(tr.net, NbtNet)
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    m = tr.run_iteration()
    assert m["iteration"] == 1 and m["examples_new"] > 0
    changed = [k for k, v in tr.net.state_dict().items()
               if not torch.equal(before[k], v)]
    # the learn step moved the weights and BatchNorm's running statistics
    assert any(k.endswith("conv1.weight") for k in changed)
    assert any(k.endswith("running_mean") for k in changed)
    path = tr.cfg.checkpoint_path("iteration_1")
    assert ckpt.checkpoint_arch(path) == {**tr.cfg.arch(),
                                          "scan_blocks": False}
    # a live config of the other body: the checkpoint's arch wins
    other = Trainer(_cfg(tmp_path).replace(body="se_resnet", num_blocks=1,
                                           num_filters=8),
                    seed=3, device="cpu")
    assert other.resume() == 1
    assert other.cfg.arch() == tr.cfg.arch()
    _equal_nets(tr.net, other.net)
    # the arena's loader builds it from the checkpoint alone
    _equal_nets(tr.net, load_model(tiny_nbt_config().replace(
        body="se_resnet"), path, device="cpu"))


def test_the_web_bot_moves_with_an_nbt_checkpoint(tmp_path):
    cfg = _cfg(tmp_path)
    tr = Trainer(cfg, seed=1, device="cpu")
    tr.save(1)
    bot = server.BotService(cfg.replace(body="se_resnet"), device="cpu")
    ok, msg = bot.load("iteration_1")
    assert ok, msg
    game = OracleGame()
    action, value = bot.alphazero_move(game)
    assert action in game.get_legal_actions() and -1.0 <= value <= 1.0


def test_the_cli_sizes_the_nbt_body():
    """``--body nbt --blocks 3`` sets the nested-bottleneck body's blocks
    and keeps its published widths; ``--filters`` is refused for it."""
    from alphazero_torch.main import build_config, build_parser

    parse = build_parser().parse_args
    cfg = build_config(parse(["train", "--body", "nbt", "--blocks", "3"]))
    assert (cfg.body, cfg.nbt_blocks, cfg.nbt_trunk, cfg.nbt_mid) == \
        ("nbt", 3, 512, 256)
    with pytest.raises(SystemExit, match="--filters"):
        build_config(parse(["train", "--body", "nbt", "--filters", "64"]))
