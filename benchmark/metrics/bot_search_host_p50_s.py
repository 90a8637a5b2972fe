"""The search's host time in a bot move: the median over the window's
``/api/move`` records that searched of ``bot.search`` less the device
interval of ``search.simulations``."""

from benchmark.lib import spans


def read(run):
    return spans.search_host_p50_s(run)
