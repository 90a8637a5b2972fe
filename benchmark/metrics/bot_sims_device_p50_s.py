"""The device time of a bot move's simulations: the median over the
window's ``/api/move`` records of the ``search.simulations`` interval
between its two CUDA events."""

from benchmark.lib import spans


def read(run):
    return spans.sims_device_p50_s(run)
