"""``conv3x3_kernel``'s share of its roofline over the nested-bottleneck
body's tower in its self-play cell's traced stretch, in percent: every
3x3 conv at its published shape (M -> M, M -> R beside M -> G, R -> M;
``rooflines/nbt.py``)."""

from benchmark.lib.nbt_roofline import share_pct
from benchmark.rooflines import nbt


def read(run):
    return share_pct(run, "conv3x3_kernel", nbt.conv3x3_sites,
                     nbt.conv3x3_ops, nbt.conv3x3_bytes)
