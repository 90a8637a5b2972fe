"""Host-side scalar Breakthrough game.

The port's own copy of ``alphazero_tpu/env/oracle.py`` (the port imports
nothing of the JAX package): a plain-numpy, single-game implementation of
the contract of the batched env (``env/breakthrough.py``), in the same
plane-mask formulation. The arena builds its openings with it; tests hold
it move for move against the JAX package's oracle.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from alphazero_torch.env.breakthrough import (
    BLACK,
    BOARD_SIZE,
    EMPTY,
    NUM_ACTIONS,
    WHITE,
    EnvState,
    decode_action_to_move,
    encode_move_to_action,
)

Move = Tuple[int, int, int, int]


class OracleGame:
    """Scalar Breakthrough game with the reference's observable API.

    Semantics parity targets (reference file:line):
      - rules/turn order:      game.py:109-173
      - win conditions:        game.py:175-215
      - canonical encoding:    game.py:225-307
    """

    def __init__(self, board: Optional[np.ndarray] = None, turn: int = WHITE):
        if board is None:
            board = np.zeros((BOARD_SIZE, BOARD_SIZE), np.int8)
            board[0:2, :] = WHITE
            board[6:8, :] = BLACK
        self.board = np.array(board, np.int8, copy=True)
        self.turn = int(turn)
        self.winner: int = 0
        self.move_count: int = 0

    # -- copies ---------------------------------------------------------
    def clone(self) -> "OracleGame":
        g = OracleGame.__new__(OracleGame)
        g.board = self.board.copy()
        g.turn = self.turn
        g.winner = self.winner
        g.move_count = self.move_count
        return g

    # -- canonical plane algebra (mirrors breakthrough.py) ---------------
    def _canonical_board(self) -> np.ndarray:
        return self.board if self.turn == WHITE else self.board[::-1, ::-1]

    def _legal_plane_mask(self) -> np.ndarray:
        """(8, 8, 3) boolean canonical legality planes."""
        canon = self._canonical_board()
        mine = canon == self.turn
        theirs = canon == -self.turn
        empty = ~(mine | theirs)

        def fwd(x):
            out = np.zeros_like(x)
            out[:-1, :] = x[1:, :]
            return out

        open_fwd = fwd(~mine)
        mask = np.zeros((BOARD_SIZE, BOARD_SIZE, 3), bool)
        mask[:, :, 0] = mine & fwd(empty)
        mask[:, 1:, 1] = mine[:, 1:] & open_fwd[:, :-1]
        mask[:, :-1, 2] = mine[:, :-1] & open_fwd[:, 1:]
        return mask

    # -- public API -------------------------------------------------------
    def get_legal_action_mask(self) -> np.ndarray:
        if self.winner != 0:
            return np.zeros(NUM_ACTIONS, bool)
        return self._legal_plane_mask().reshape(NUM_ACTIONS)

    def get_legal_actions(self) -> List[int]:
        return np.flatnonzero(self.get_legal_action_mask()).tolist()

    def get_legal_moves(self) -> List[Move]:
        return [self.decode_action(a) for a in self.get_legal_actions()]

    def get_legal_actions_reference_order(self) -> List[int]:
        """Legal canonical actions in the reference's child-insertion order.

        The reference scans absolute (row, col) ascending with directions
        0,1,2 (game.py:117-148); for Black that corresponds to descending
        canonical squares. Needed to replicate dict-insertion tie-breaking
        in MCTS parity tests.
        """
        actions = self.get_legal_actions()
        if self.turn == WHITE:
            return sorted(actions)
        # descending square, ascending direction within a square
        return sorted(actions, key=lambda a: (-(a // 3), a % 3))

    def encode_action(self, move: Move) -> int:
        return encode_move_to_action(move, self.turn)

    def decode_action(self, action: int) -> Move:
        return decode_action_to_move(action, self.turn)

    def step_action(self, action: int) -> None:
        self.step(self.decode_action(action))

    def step(self, move: Move) -> None:
        fr_r, fr_c, to_r, to_c = move
        mover = self.turn
        self.board[to_r, to_c] = self.board[fr_r, fr_c]
        self.board[fr_r, fr_c] = EMPTY

        home = BOARD_SIZE - 1 if mover == WHITE else 0
        if to_r == home or not np.any(self.board == -mover):
            self.winner = mover
        self.turn = -mover
        self.move_count += 1
        # Stuck player loses (game.py:189-215 via get_result fallback).
        if self.winner == 0 and not self.get_legal_action_mask().any():
            self.winner = mover

    def is_terminal(self) -> bool:
        return self.winner != 0

    def get_result(self) -> Tuple[float, float]:
        """(win, loss) from WHITE's perspective; (0, 0) while in progress."""
        if self.winner == WHITE:
            return (1.0, 0.0)
        if self.winner == BLACK:
            return (0.0, 1.0)
        return (0.0, 0.0)

    def get_reward(self) -> float:
        w, l = self.get_result()
        return w - l

    def get_encoded_state(self) -> np.ndarray:
        """(3, 8, 8) float32 planes: mine / theirs / ones."""
        canon = self._canonical_board()
        planes = np.zeros((3, BOARD_SIZE, BOARD_SIZE), np.float32)
        planes[0] = canon == self.turn
        planes[1] = canon == -self.turn
        planes[2] = 1.0
        return planes

    def __str__(self) -> str:
        sym = {WHITE: "o", BLACK: "x", EMPTY: "."}
        rows = ["  a b c d e f g h"]
        for r in range(BOARD_SIZE - 1, -1, -1):
            rows.append(f"{r + 1} " + " ".join(sym[int(v)] for v in self.board[r]))
        rows.append(f"Turn: {'White' if self.turn == WHITE else 'Black'}")
        return "\n".join(rows)


def live_states(games: List[OracleGame], device) -> EnvState:
    """The env's batched state of live oracle games on ``device``: their
    boards, sides to move and move counts, no winner yet."""
    B = len(games)
    return EnvState(
        board=torch.from_numpy(np.stack([g.board for g in games])
                               .astype(np.int8)).to(device),
        turn=torch.tensor([g.turn for g in games], dtype=torch.int8,
                          device=device),
        winner=torch.zeros((B,), dtype=torch.int8, device=device),
        done=torch.zeros((B,), dtype=torch.bool, device=device),
        move_count=torch.tensor([g.move_count for g in games],
                                dtype=torch.int32, device=device),
    )
