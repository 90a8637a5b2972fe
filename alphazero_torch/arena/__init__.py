from alphazero_torch.arena.elo import ArenaState
from alphazero_torch.arena.match import play_paired_matches, random_opening
from alphazero_torch.arena.runner import run_arena, select_matchup

__all__ = ["ArenaState", "play_paired_matches", "random_opening",
           "run_arena", "select_matchup"]
