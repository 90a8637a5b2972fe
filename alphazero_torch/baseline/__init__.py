"""Classical Breakthrough engine (host-side alpha-beta).

The port's own copy of ``alphazero_tpu/baseline/``: pure Python on the
host, where the control-flow-heavy recursion belongs. Bitboard state with
Zobrist hashing, iterative-deepening PVS with a transposition table,
aspiration windows, null-move pruning, LMR, killer/history ordering,
quiescence; hand-crafted evaluation. The web server's baseline player and
the strength anchor (``strength/vs_baseline.py``) play with it.
"""

from alphazero_torch.baseline.constants import BLACK, SCORE_WIN, WHITE
from alphazero_torch.baseline.engine import (
    BitboardPosition,
    evaluate,
    from_board,
)
from alphazero_torch.baseline.search import Search, TranspositionTable

__all__ = ["BitboardPosition", "Search", "TranspositionTable", "evaluate",
           "from_board", "WHITE", "BLACK", "SCORE_WIN"]
