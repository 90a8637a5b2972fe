"""The caching allocator's device allocations (cudaMalloc and cuMemMap
calls) a self-play move of the window: the sum of the window's move
records' ``allocs`` over their number. A record counts what was allocated
since the record before it closed, the driver's own copies between moves
included."""

from benchmark.lib import moves


def read(run):
    return moves.allocs_per_record(moves.window_moves(run))
