"""Central configuration of the PyTorch port.

The same fields and defaults as the JAX package's ``Config``, kept as an
independent copy so this package never imports the JAX one. Board
geometry, net size, MCTS constants and the training schedule follow the
reference contract.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Config:
    # --- Game (Breakthrough) ---
    board_size: int = 8
    num_actions: int = 192          # 64 squares x 3 directions
    input_planes: int = 3           # mine / theirs / ones

    # --- Model ---
    # "se_resnet" (the SE-ResNet of models/network.py, sized by the three
    # fields below), "encoder" (Leela Chess Zero's BT4 attention body,
    # models/encoder.py, sized by the enc_* and smolgen_* fields), "nbt"
    # (KataGo's nested-bottleneck residual net, models/nbt.py, sized by the
    # nbt_* fields) or "muzero" (MuZero's board-game representation,
    # dynamics and prediction nets, models/muzero.py, sized by the mz_*
    # fields; searched over a latent store in the tree)
    body: str = "se_resnet"
    num_blocks: int = 20
    num_filters: int = 128
    se_ratio: int = 8
    # the encoder body at BT4-1024x15x32h's widths: 15 layers of 1024
    # (32 heads of 32), feed-forward 1536; smolgen compresses a square to
    # 32 values, has a hidden width of 256 and 256 a head; the attention
    # policy's embedding is 1024 wide. On a CUDA card the heads, their
    # width and smolgen's width a head are BT4's alone (build_network)
    enc_layers: int = 15
    enc_embed: int = 1024
    enc_heads: int = 32
    enc_ffn: int = 1536
    smolgen_compress: int = 32
    smolgen_hidden: int = 256
    smolgen_gen: int = 256
    enc_policy_embed: int = 1024
    # the nested-bottleneck body at KataGo b28c512nbt's widths: 28 blocks on
    # a trunk of 512, each a 1x1 conv down to 256, two inner 3x3 residual
    # blocks and a 1x1 conv back up; every third block (3, 6, ..., 27)
    # pools 64 channels of its first inner block over the board into a
    # bias of the other 192; policy and value heads 64 wide, the value's
    # hidden layer 128. On a CUDA card nbt_mid is a conv3x3 width
    # (build_network)
    nbt_blocks: int = 28
    nbt_trunk: int = 512
    nbt_mid: int = 256
    nbt_gpool: int = 64
    nbt_head: int = 64
    nbt_value_hidden: int = 128
    # MuZero's board-game nets at the paper's widths: a representation and
    # a dynamics tower of 16 post-activation residual blocks of 256 each
    # (the action's 3 planes are models/muzero.py's ACTION_PLANES). On a
    # CUDA card mz_filters is a conv3x3 width (build_network)
    mz_blocks: int = 16
    mz_filters: int = 256
    # the learner's unroll of the dynamics: K = 5 recurrent steps a sample
    mz_unroll: int = 5

    # --- MCTS ---
    num_simulations: int = 400
    num_simulations_inference: int = 200
    c_puct: float = 1.5
    fpu_reduction: float = 0.0      # FPU disabled: unvisited q = 0
    dirichlet_alpha: float = 0.35
    dirichlet_epsilon: float = 0.25
    temperature_threshold: int = 16  # tau=1 for the first N moves, then 0
    # Between-move tree reuse in self-play: off by default (fresh searches
    # per move); on doubles search-tree memory for subtree headroom.
    tree_reuse: bool = False

    # --- Training ---
    batch_size: int = 1024
    learning_rate: float = 1e-3
    lr_t_max: int = 200              # cosine period in learn() calls
    lr_eta_min: float = 1e-5
    weight_decay: float = 1e-4
    grad_clip_norm: float = 1.0
    parallel_games: int = 128
    selfplay_batches: int = 8
    buffer_size: int = 300_000
    training_epochs: int = 1

    # --- Self-play loop shape ---
    max_game_length: int = 512       # hard cap on moves per self-play game
    continuous_selfplay: bool = True  # auto-reset finished lanes

    # --- Precision ---
    # Search evaluator dtype; the trained params stay f32 and the bfloat16
    # evaluator runs a bf16 copy (make_net_evaluator).
    inference_dtype: str = "bfloat16"
    train_dtype: str = "float32"
    # Dtype of the fused search-tree rows. The CUDA tree kernels take
    # float32 only; "float16" stays for CPU numerics tests (exact for
    # integers <= 2048, i.e. <= 2047-slot trees).
    value_dtype: str = "float32"

    # --- Self-play evaluator quantization ("off" | "static" | "dynamic") ---
    selfplay_quant: str = "off"

    # --- Learn-phase data path ---
    device_replay: bool = True

    # --- Compile/runtime trade of the JAX package (kept for field parity) ---
    scan_blocks: bool = False

    # --- Paths ---
    checkpoint_dir: str = "checkpoints"
    best_model: str = "model_best"
    data_file: str = "training_data.npz"
    arena_state: str = "arena_state.json"

    def arch(self) -> dict:
        """The fields a checkpoint records, so that its net can be built
        from it alone (``with_arch``): the SE-ResNet's three sizes, or the
        encoder body's, the nested-bottleneck body's or MuZero's."""
        names = {"encoder": ENCODER_ARCH, "nbt": NBT_ARCH,
                 "muzero": MUZERO_ARCH}.get(
            self.body, ("num_blocks", "num_filters", "se_ratio"))
        return {k: getattr(self, k) for k in names}

    def with_arch(self, arch: dict) -> "Config":
        """This config with a checkpoint's recorded ``arch`` in place of
        its own; a record without ``body`` is an SE-ResNet's."""
        arch = {"body": "se_resnet", **arch}
        return self.replace(**{k: arch[k] for k in
                               ("num_blocks", "num_filters", "se_ratio",
                                *ENCODER_ARCH, *NBT_ARCH, *MUZERO_ARCH)
                               if k in arch})

    def checkpoint_path(self, filename: str) -> str:
        return os.path.join(self.checkpoint_dir, filename)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


ENCODER_ARCH = ("body", "enc_layers", "enc_embed", "enc_heads", "enc_ffn",
                "smolgen_compress", "smolgen_hidden", "smolgen_gen",
                "enc_policy_embed")
NBT_ARCH = ("body", "nbt_blocks", "nbt_trunk", "nbt_mid", "nbt_gpool",
            "nbt_head", "nbt_value_hidden")
MUZERO_ARCH = ("body", "mz_blocks", "mz_filters")


def tiny_config(**kw) -> Config:
    """A small config for tests: 2-block/32-filter net, few sims."""
    base = dict(num_blocks=2, num_filters=32, num_simulations=16,
                parallel_games=8, batch_size=32, max_game_length=256)
    base.update(kw)
    return Config(**base)


def tiny_encoder_config(**kw) -> Config:
    """``tiny_config`` with a small encoder body for tests: 2 layers of 64
    (4 heads of 16), feed-forward 96, smolgen 8 / 32 / 32."""
    base = dict(body="encoder", enc_layers=2, enc_embed=64, enc_heads=4,
                enc_ffn=96, smolgen_compress=8, smolgen_hidden=32,
                smolgen_gen=32, enc_policy_embed=64)
    base.update(kw)
    return tiny_config(**base)


def tiny_nbt_config(**kw) -> Config:
    """``tiny_config`` with a small nested-bottleneck body for tests: 3
    blocks on a trunk of 32, mid 16, the third block pooling 8 channels,
    heads of 8 and a value hidden layer of 16."""
    base = dict(body="nbt", nbt_blocks=3, nbt_trunk=32, nbt_mid=16,
                nbt_gpool=8, nbt_head=8, nbt_value_hidden=16)
    base.update(kw)
    return tiny_config(**base)


def tiny_muzero_config(**kw) -> Config:
    """``tiny_config`` with small MuZero nets for tests: 2 blocks of 32 in
    each tower, an unroll of 3 steps."""
    base = dict(body="muzero", mz_blocks=2, mz_filters=32, mz_unroll=3)
    base.update(kw)
    return tiny_config(**base)
