"""The web server's own time in a bot move: the median over the window's
``/api/move`` records of ``web.request`` less ``bot.search``."""

from benchmark.lib import spans


def read(run):
    return spans.handler_p50_s(run)
