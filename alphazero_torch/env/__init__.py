from alphazero_torch.env.breakthrough import (
    BLACK,
    BOARD_SIZE,
    EMPTY,
    NUM_ACTIONS,
    NUM_PLANES,
    WHITE,
    EnvState,
    decode_action_to_move,
    encode_move_to_action,
    encoded_state,
    initial_state,
    legal_action_mask,
    num_legal_actions,
    result_wl,
    select_state,
    step,
    terminal_value_for_player_to_move,
)
from alphazero_torch.env.oracle import OracleGame

__all__ = [
    "BLACK", "BOARD_SIZE", "EMPTY", "NUM_ACTIONS", "NUM_PLANES", "WHITE",
    "EnvState", "decode_action_to_move", "encode_move_to_action",
    "encoded_state", "initial_state", "legal_action_mask",
    "num_legal_actions", "OracleGame", "result_wl", "select_state", "step",
    "terminal_value_for_player_to_move",
]
