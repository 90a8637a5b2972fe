"""Bitboard constants (the port's copy of ``alphazero_tpu/baseline/
constants.py``). Square i = rank(i//8)*8 + file(i%8); rank 0 is
White's home row (White moves toward rank 7)."""

WHITE = 1
BLACK = -1

U64 = (1 << 64) - 1

FILE_A = 0x0101010101010101
FILE_H = 0x8080808080808080
RANK_1 = 0x00000000000000FF
RANK_2 = 0x000000000000FF00
RANK_7 = 0x00FF000000000000
RANK_8 = 0xFF00000000000000

START_WHITE = 0x000000000000FFFF  # ranks 1-2
START_BLACK = 0xFFFF000000000000  # ranks 7-8

SCORE_WIN = 30_000
SCORE_INF = 1 << 20
