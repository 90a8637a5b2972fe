"""Vectorized Breakthrough environment on torch tensors.

Port of ``alphazero_tpu/env/breakthrough.py``. Every function works on the
trailing (8, 8) board axes and broadcasts over leading batch dimensions.
The contract is the same as the JAX package's:

- 8x8 board, WHITE=+1 starts on rows 0-1 and moves toward row 7,
  BLACK=-1 starts on rows 6-7 and moves toward row 0.
- Forward moves need an empty target; diagonal moves need a target that
  is not the mover's own piece (captures happen only diagonally).
- Actions are canonical, from the mover's side with the board rotated 180
  degrees for Black: ``action = (row*8 + col)*3 + dir`` with dir
  0=forward, 1=diag-left, 2=diag-right.
- Win by reaching the far row, or by capturing every opposing piece; a
  player left with no legal move loses.
- Finished games are frozen: ``step`` is a no-op on them, so lockstep
  batches never need compaction.

Functions are pure: they return new tensors and never write their inputs.
"""

from __future__ import annotations

import dataclasses

import torch

from alphazero_torch import resolve_device

WHITE = 1
BLACK = -1
EMPTY = 0
BOARD_SIZE = 8
NUM_SQUARES = 64
NUM_ACTIONS = 192
NUM_PLANES = 3

# dir -> column delta in the canonical frame (forward, diag-left, diag-right)
_DIR_DCOL = (0, -1, 1)


@dataclasses.dataclass
class EnvState:
    """Struct-of-tensors game state; all fields share leading batch dims.

    board:      (..., 8, 8) int8, absolute orientation (+1 white, -1 black)
    turn:       (...,) int8, player to move (+1 / -1)
    winner:     (...,) int8, 0 while in progress
    done:       (...,) bool
    move_count: (...,) int32, plies played
    """

    board: torch.Tensor
    turn: torch.Tensor
    winner: torch.Tensor
    done: torch.Tensor
    move_count: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.board.device


def select_state(mask: torch.Tensor, new: EnvState, old: EnvState
                 ) -> EnvState:
    """Per-game choice: ``new`` where ``mask`` (batch-shaped) is true."""
    def sel(a, b):
        m = mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim))
        return torch.where(m, a, b)

    return EnvState(*(sel(getattr(new, f.name), getattr(old, f.name))
                      for f in dataclasses.fields(EnvState)))


def initial_state(batch_shape: tuple = (), device="cuda") -> EnvState:
    """Starting position, broadcast to ``batch_shape`` leading dims."""
    dev = resolve_device(device)
    board = torch.zeros((BOARD_SIZE, BOARD_SIZE), dtype=torch.int8,
                        device=dev)
    board[0:2] = WHITE
    board[6:8] = BLACK
    batch_shape = tuple(batch_shape)
    return EnvState(
        board=board.expand(batch_shape + (BOARD_SIZE, BOARD_SIZE)).clone(),
        turn=torch.full(batch_shape, WHITE, dtype=torch.int8, device=dev),
        winner=torch.zeros(batch_shape, dtype=torch.int8, device=dev),
        done=torch.zeros(batch_shape, dtype=torch.bool, device=dev),
        move_count=torch.zeros(batch_shape, dtype=torch.int32, device=dev),
    )


# -----------------------------------------------------------------------------
# Canonical-frame plane algebra
# -----------------------------------------------------------------------------

def _canonical_board(board: torch.Tensor, turn: torch.Tensor) -> torch.Tensor:
    """Board rotated 180 degrees when Black is to move (mover's side)."""
    return torch.where((turn == WHITE)[..., None, None], board,
                       board.flip(-2, -1))


def canonical_planes(state: EnvState) -> tuple[torch.Tensor, torch.Tensor]:
    """(mine, theirs) boolean planes in the canonical frame."""
    canon = _canonical_board(state.board, state.turn)
    t = state.turn[..., None, None]
    return canon == t, canon == -t


def _shift_fwd(x: torch.Tensor) -> torch.Tensor:
    """y[..., r, c] = x[..., r+1, c]; False past the far row."""
    return torch.cat([x[..., 1:, :], torch.zeros_like(x[..., :1, :])], dim=-2)


def _shift_col(x: torch.Tensor, dc: int) -> torch.Tensor:
    """y[..., r, c] = x[..., r, c+dc]; False outside the board."""
    pad = torch.zeros_like(x[..., :, :1])
    if dc == -1:
        return torch.cat([pad, x[..., :, :-1]], dim=-1)
    return torch.cat([x[..., :, 1:], pad], dim=-1)


def legal_action_mask(state: EnvState) -> torch.Tensor:
    """(..., 192) boolean mask over canonical actions; terminal states
    report no legal actions."""
    mine, theirs = canonical_planes(state)
    empty = ~(mine | theirs)
    # "target not own piece" aligned at the source square; the shifts pad
    # with False so off-board targets are illegal.
    open_fwd = _shift_fwd(~mine)

    fwd = mine & _shift_fwd(empty)
    dl = mine & _shift_col(open_fwd, -1)
    dr = mine & _shift_col(open_fwd, +1)

    mask = torch.stack([fwd, dl, dr], dim=-1)  # (..., 8, 8, 3)
    mask = mask.reshape(mask.shape[:-3] + (NUM_ACTIONS,))
    return mask & ~state.done[..., None]


def num_legal_actions(state: EnvState) -> torch.Tensor:
    return legal_action_mask(state).sum(-1)


# -----------------------------------------------------------------------------
# Transition
# -----------------------------------------------------------------------------

def step(state: EnvState, action: torch.Tensor) -> EnvState:
    """Apply canonical ``action`` (...,); no-op on finished games.

    Callers must supply actions drawn from ``legal_action_mask``: legality
    is not re-checked, and an illegal action mutates the board
    nonsensically. Win ordering: the piece moves (capture by overwrite),
    then win by far-row arrival, then win by elimination; finally the
    mover also wins if the opponent is left with no legal reply.
    """
    action = action.long()
    sq, d = action // 3, action % 3
    r, c = sq // BOARD_SIZE, sq % BOARD_SIZE
    # _DIR_DCOL[d] without a host-to-device table copy per call
    dc = (d == 2).long() - (d == 1).long()
    to_r, to_c = r + 1, c + dc

    is_black = state.turn == BLACK

    def to_abs(row, col):
        return (torch.where(is_black, BOARD_SIZE - 1 - row, row),
                torch.where(is_black, BOARD_SIZE - 1 - col, col))

    fr_r, fr_c = to_abs(r, c)
    tr_r, tr_c = to_abs(to_r, to_c)
    from_idx = fr_r * BOARD_SIZE + fr_c
    to_idx = tr_r * BOARD_SIZE + tr_c

    flat = state.board.reshape(state.board.shape[:-2] + (NUM_SQUARES,))
    lane = torch.arange(NUM_SQUARES, device=action.device)
    turn_b = state.turn[..., None]
    new_flat = torch.where(lane == to_idx[..., None], turn_b, flat)
    new_flat = torch.where(lane == from_idx[..., None],
                           torch.zeros((), dtype=torch.int8,
                                       device=action.device), new_flat)
    new_board = new_flat.reshape(state.board.shape)

    reached_home = to_r == (BOARD_SIZE - 1)  # canonical far row
    opp_alive = (new_flat == -turn_b).any(-1)
    winner = torch.where(reached_home | ~opp_alive, state.turn,
                         torch.zeros_like(state.turn))
    moved = EnvState(
        board=new_board,
        turn=-state.turn,
        winner=winner,
        done=winner != 0,
        move_count=state.move_count + 1,
    )

    # Stuck opponent loses (only checked when no winner yet).
    stuck = (moved.winner == 0) & (num_legal_actions(moved) == 0)
    moved.winner = torch.where(stuck, state.turn, moved.winner)
    moved.done = moved.done | stuck

    # Freeze finished games: lockstep batches step everything every ply.
    out = select_state(state.done, state, moved)
    out.done = state.done | moved.done
    return out


# -----------------------------------------------------------------------------
# Observations and results
# -----------------------------------------------------------------------------

def encoded_state(state: EnvState, dtype=torch.float32) -> torch.Tensor:
    """(..., 3, 8, 8) network input planes: mine / theirs / ones."""
    mine, theirs = canonical_planes(state)
    ones = torch.ones_like(mine)
    return torch.stack([mine, theirs, ones], dim=-3).to(dtype)


def result_wl(state: EnvState) -> torch.Tensor:
    """(..., 2) (win, loss) from WHITE's side; zeros while in progress."""
    w = (state.winner == WHITE).float()
    l = (state.winner == BLACK).float()
    return torch.stack([w, l], dim=-1)


def terminal_value_for_player_to_move(state: EnvState) -> torch.Tensor:
    """Value of a terminal state from the side of the player to move."""
    white_value = ((state.winner == WHITE).float()
                   - (state.winner == BLACK).float())
    return torch.where(state.turn == WHITE, white_value, -white_value)


# -----------------------------------------------------------------------------
# Host-side conversion helpers (web UI / interop)
# -----------------------------------------------------------------------------

def decode_action_to_move(action: int, turn: int) -> tuple[int, int, int, int]:
    """Canonical action -> absolute (from_row, from_col, to_row, to_col)."""
    sq, d = divmod(int(action), 3)
    r, c = divmod(sq, BOARD_SIZE)
    to_r, to_c = r + 1, c + _DIR_DCOL[d]
    if turn == BLACK:
        r, c = BOARD_SIZE - 1 - r, BOARD_SIZE - 1 - c
        to_r, to_c = BOARD_SIZE - 1 - to_r, BOARD_SIZE - 1 - to_c
    return r, c, to_r, to_c


def encode_move_to_action(move: tuple[int, int, int, int], turn: int) -> int:
    """Absolute move -> canonical action index."""
    fr_r, fr_c, to_r, to_c = move
    if turn == BLACK:
        fr_r, fr_c = BOARD_SIZE - 1 - fr_r, BOARD_SIZE - 1 - fr_c
        to_r, to_c = BOARD_SIZE - 1 - to_r, BOARD_SIZE - 1 - to_c
    dc = to_c - fr_c
    d = 0 if dc == 0 else (1 if dc == -1 else 2)
    return (fr_r * BOARD_SIZE + fr_c) * 3 + d
