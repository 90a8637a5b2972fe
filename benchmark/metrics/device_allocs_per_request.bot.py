"""The caching allocator's device allocations (cudaMalloc and cuMemMap
calls) a bot move of the window: the sum of the window's ``/api/move``
records' ``allocs`` over their number. A record counts what was
allocated since the last record that ran on the card closed, the
driver's own copies between requests included."""

from benchmark.lib import moves, spans


def read(run):
    return moves.allocs_per_record(spans.window_requests(run))
