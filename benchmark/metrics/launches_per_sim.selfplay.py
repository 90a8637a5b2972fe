"""Device kernels in the traced stretch over the simulations it ran (the
selfplay cells)."""

from benchmark.lib import readers


def read(run):
    return readers.launches_per_sim(run, "selfplay")
