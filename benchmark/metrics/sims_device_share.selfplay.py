"""The share of the untraced window in which the card runs the replays:
the device seconds of the window's ``search.simulations`` (each move
record's CUDA event pair) over the window's seconds, in percent. 100%
less it bounds the root's and the glue's device work and the idle time
together."""

from benchmark.lib import moves


def read(run):
    return moves.sims_device_share_pct(run)
