"""The device's idle share in the traced stretch of the selfplay cells: gaps
in the union of every kernel's, copy's and set's interval, in percent."""

from benchmark.lib import readers


def read(run):
    return readers.idle_share_pct(run, "selfplay")
