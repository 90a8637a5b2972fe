"""The host's own work a self-play move, untraced: the median over the
window's move records of ``selfplay.move`` less ``search.simulations``
and less ``host.wait`` (the root, the noise, the sampling, the autoreset
and the tree's reset, which the card may wait on)."""

from benchmark.lib import moves


def read(run):
    return moves.glue_host_p50_s(run)
