"""CLI of the PyTorch port: train | web | arena.

    python -m alphazero_torch train     # restartable self-play training loop
    python -m alphazero_torch web       # human-vs-bot web UI + JSON API
    python -m alphazero_torch arena     # continuous ELO matchmaking daemon

The flags of the JAX package's ``main.py`` that mean something here; on
the card by default, on the CPU with ``--cpu``. ``--scan-blocks`` belongs
to JAX and is not offered. Several cards, one process each:

    torchrun --nproc-per-node N -m alphazero_torch train --distributed

(NCCL; with ``--cpu``, gloo processes on the CPU).
"""

from __future__ import annotations

import argparse

from alphazero_torch.config import Config


def add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--body", default=None,
                   choices=["se_resnet", "encoder", "nbt", "muzero"],
                   help="the net: the SE-ResNet, Leela Chess Zero's BT4 "
                        "attention body, KataGo's nested-bottleneck body "
                        "or MuZero's board-game nets (the last three by "
                        "default at their published widths)")
    p.add_argument("--blocks", type=int, default=None,
                   help="residual blocks, the encoder's layers, the "
                        "nested-bottleneck body's blocks or each MuZero "
                        "tower's blocks")
    p.add_argument("--filters", type=int, default=None,
                   help="the SE-ResNet's or MuZero's filters")
    p.add_argument("--sims", type=int, default=None)
    p.add_argument("--games", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--profile", nargs="?", const="profile", default=None,
                   metavar="DIR",
                   help="write one torch.profiler trace per phase "
                        "(selfplay, learn) into DIR")
    p.add_argument("--value-dtype", default=None,
                   choices=["float32", "float16"],
                   help="dtype of the search tree rows; the CUDA tree "
                        "kernels take float32 only (float16 is for CPU "
                        "numerics tests)")
    p.add_argument("--selfplay-quant", default=None,
                   choices=["off", "dynamic", "static"],
                   help="int8 self-play evaluator (static: scales "
                        "calibrated on replay positions); learning stays "
                        "float32")
    p.add_argument("--host-replay", action="store_true",
                   help="stream learn batches from the host instead of "
                        "the device-resident replay window")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--distributed", action="store_true",
                   help="join the process group torchrun describes: one "
                        "process per card (NCCL), or gloo processes on the "
                        "CPU with --cpu; train shards its learner batch")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection: raise where a "
                        "backward pass makes a NaN")


def build_config(args) -> Config:
    over = {}
    if args.body is not None:
        over["body"] = args.body
    if args.blocks is not None:
        over[{"encoder": "enc_layers", "nbt": "nbt_blocks",
              "muzero": "mz_blocks"}.get(args.body, "num_blocks")] = \
            args.blocks
    if args.filters is not None:
        if args.body in ("encoder", "nbt"):
            raise SystemExit(f"--filters sizes the SE-ResNet or MuZero; the "
                             f"{args.body} body takes its published widths")
        over["mz_filters" if args.body == "muzero" else "num_filters"] = \
            args.filters
    if args.sims is not None:
        over["num_simulations"] = args.sims
        over["num_simulations_inference"] = max(1, args.sims // 2)
    if args.games is not None:
        over["parallel_games"] = args.games
    if getattr(args, "selfplay_batches", None) is not None:
        over["selfplay_batches"] = args.selfplay_batches
    if getattr(args, "buffer", None) is not None:
        over["buffer_size"] = args.buffer
    if args.value_dtype is not None:
        over["value_dtype"] = args.value_dtype
    if args.host_replay:
        over["device_replay"] = False
    if args.selfplay_quant is not None:
        over["selfplay_quant"] = args.selfplay_quant
    return Config(checkpoint_dir=args.checkpoint_dir, **over)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m alphazero_torch",
        description="AlphaZero for Breakthrough on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)

    p_train = sub.add_parser("train", help="run the training loop")
    add_common(p_train)
    p_train.add_argument("--iterations", type=int, default=None,
                         help="stop after N iterations (default: forever)")
    p_train.add_argument("--selfplay-batches", type=int, default=None,
                         help="self-play rounds per iteration (games/iter "
                              "= batches x games)")
    p_train.add_argument("--buffer", type=int, default=None,
                         help="replay buffer capacity")

    p_web = sub.add_parser("web", help="web UI / JSON API server")
    add_common(p_web)
    p_web.add_argument("--host", default="0.0.0.0")
    p_web.add_argument("--port", type=int, default=5051)

    p_arena = sub.add_parser("arena", help="continuous ELO matchmaking")
    add_common(p_arena)
    p_arena.add_argument("--rounds", type=int, default=None)
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    cfg = build_config(args)

    from alphazero_torch.utils import (
        enable_debug_checks,
        init_distributed,
        setup_logging,
    )

    log = setup_logging()
    if args.debug_nans:
        enable_debug_checks()
    mesh = None
    if args.distributed:
        from alphazero_torch.parallel import make_mesh

        # before anything touches the card: it takes LOCAL_RANK's
        rank = init_distributed(device=device if args.cpu else None)
        mesh = make_mesh(device=device if args.cpu else None)
        device = mesh.device
        log.info("process group: rank %d of %d (%s) on %s", rank,
                 mesh.world, mesh.backend, device)
    if args.command == "train":
        from alphazero_torch.models.network import count_params
        from alphazero_torch.train import Trainer

        trainer = Trainer(cfg, seed=args.seed, device=device, mesh=mesh)
        trainer.profile_dir = args.profile
        log.info("model: %s, %s params on %s", trainer.cfg.arch(),
                 f"{count_params(trainer.net):,}", trainer.device)
        trainer.train_forever(max_iterations=args.iterations)
    elif args.command == "web":
        from alphazero_torch.web import serve

        serve(cfg, host=args.host, port=args.port, device=device)
    elif args.command == "arena":
        from alphazero_torch.arena import run_arena

        run_arena(cfg, max_rounds=args.rounds, seed=args.seed, device=device)
