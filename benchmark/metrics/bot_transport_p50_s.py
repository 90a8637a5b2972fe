"""The time of a bot move outside the server's handler: the window's
median ``/api/move`` round trip less the median ``web.request`` (a
difference of medians)."""

from benchmark.lib import spans


def read(run):
    return spans.transport_p50_s(run)
