"""The encoder body on the port's normal path, on the CPU at a tiny size:
the Trainer's iteration (self-play, learn, checkpoint, resume), the
arena's and the web bot's loads of an encoder checkpoint, a web bot move,
and ``python -m alphazero_torch train --body encoder`` end to end."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from alphazero_torch.arena.runner import load_model
from alphazero_torch.config import tiny_encoder_config
from alphazero_torch.env import OracleGame
from alphazero_torch.models.encoder import EncoderNet
from alphazero_torch.train import Trainer
from alphazero_torch.train import checkpoint as ckpt
from alphazero_torch.web import server

ROOT = Path(__file__).resolve().parent.parent


def _cfg(tmp_path, **kw):
    base = dict(checkpoint_dir=str(tmp_path / "ckpt"), num_simulations=8,
                num_simulations_inference=8, parallel_games=4,
                batch_size=16, selfplay_batches=1, enc_layers=1)
    base.update(kw)
    return tiny_encoder_config(**base)


def _equal_nets(a, b):
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka


def test_an_iteration_checkpoints_and_resumes_the_encoder(tmp_path):
    tr = Trainer(_cfg(tmp_path), seed=0, device="cpu")
    assert isinstance(tr.net, EncoderNet)
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    m = tr.run_iteration()
    assert m["iteration"] == 1 and m["examples_new"] > 0
    assert any(not torch.equal(before[k], v)
               for k, v in tr.net.state_dict().items())
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
    _equal_nets(tr.net, load_model(tiny_encoder_config().replace(
        body="se_resnet"), path, device="cpu"))


def test_the_web_bot_moves_with_an_encoder_checkpoint(tmp_path):
    cfg = _cfg(tmp_path)
    tr = Trainer(cfg, seed=1, device="cpu")
    tr.save(1)
    bot = server.BotService(cfg.replace(body="se_resnet"), device="cpu")
    ok, msg = bot.load("iteration_1")
    assert ok, msg
    game = OracleGame()
    action, value = bot.alphazero_move(game)
    assert action in game.get_legal_actions() and -1.0 <= value <= 1.0


def test_train_with_the_encoder_body_through_the_cli(tmp_path):
    """``python -m alphazero_torch train --cpu --body encoder`` with one
    layer (``--blocks``) at BT4's widths: self-play, learn and a
    checkpoint whose arch is the encoder's. The CLI runs as its module
    does, with the learner's batch cut to 32 so that a step of a
    1024-wide layer stays small on the CPU."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    cli = ("import sys\n"
           "from alphazero_torch import main as m\n"
           "build = m.build_config\n"
           "m.build_config = lambda a: build(a).replace(batch_size=32)\n"
           "m.main(sys.argv[1:])\n")
    cmd = [sys.executable, "-c", cli, "train", "--cpu",
           "--body", "encoder", "--blocks", "1",
           "--sims", "4", "--games", "1", "--iterations", "1",
           "--selfplay-batches", "1", "--buffer", "4096"]
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    ck = tmp_path / "checkpoints"
    with open(ck / "metrics.jsonl") as f:
        assert [json.loads(line)["iteration"] for line in f] == [1]
    arch = json.loads((ck / "iteration_1" / "alphazero_meta.json")
                      .read_text())["arch"]
    assert (arch["body"], arch["enc_layers"], arch["enc_embed"],
            arch["enc_heads"]) == ("encoder", 1, 1024, 32)


def test_the_cli_keeps_filters_for_the_se_resnet():
    """``--filters`` sizes the SE-ResNet alone: with ``--body encoder`` it
    is refused, where it would otherwise be silently ignored."""
    from alphazero_torch.main import build_config, build_parser

    parse = build_parser().parse_args
    assert build_config(parse(["train", "--filters", "64"])).num_filters \
        == 64
    with pytest.raises(SystemExit, match="--filters"):
        build_config(parse(["train", "--body", "encoder", "--filters",
                            "64"]))
