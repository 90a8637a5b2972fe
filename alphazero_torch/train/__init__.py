from alphazero_torch.train.learner import (
    TrainState,
    cosine_lr,
    create_train_state,
    train_step,
)
from alphazero_torch.train.replay import ReplayBuffer
from alphazero_torch.train.selfplay import (
    selfplay_games,
    selfplay_games_continuous,
    selfplay_move,
)
from alphazero_torch.train.trainer import Trainer

__all__ = [
    "TrainState", "cosine_lr", "create_train_state", "train_step",
    "ReplayBuffer", "selfplay_games", "selfplay_games_continuous",
    "selfplay_move", "Trainer",
]
