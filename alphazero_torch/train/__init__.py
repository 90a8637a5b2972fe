from alphazero_torch.train.selfplay import (
    selfplay_games,
    selfplay_games_continuous,
    selfplay_move,
)

__all__ = ["selfplay_games", "selfplay_games_continuous", "selfplay_move"]
