"""``conv3x3_kernel``'s share of its roofline in the traced stretch of the
self-play cells, in percent."""

from benchmark.lib import readers
from benchmark.rooflines import conv3x3


def read(run):
    return readers.roofline_pct(run, "selfplay", conv3x3, "C")
