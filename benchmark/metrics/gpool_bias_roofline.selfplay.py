"""``gpool_bias_kernel``'s share of its roofline in the nested-bottleneck
body's self-play cell's traced stretch, in percent (``rooflines/nbt.py``:
the pooling blocks' and the policy head's launches)."""

from benchmark.lib.nbt_roofline import share_pct
from benchmark.rooflines import nbt


def read(run):
    return share_pct(run, "gpool_bias_kernel", nbt.gpool_sites,
                     nbt.gpool_ops, nbt.gpool_bytes)
