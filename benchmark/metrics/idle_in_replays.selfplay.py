"""The device's idle time in the traced stretch of the selfplay cells
whose gap fell while the host was in ``search.simulations`` (the replays'
launches), over the stretch, in percent."""

from benchmark.lib import spans


def read(run):
    return spans.idle_in_replays_pct(run, "selfplay")
