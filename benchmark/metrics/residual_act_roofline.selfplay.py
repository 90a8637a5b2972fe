"""``residual_act_kernel``'s share of its roofline in the
nested-bottleneck body's self-play cell's traced stretch, in percent
(``rooflines/nbt.py``: the norm-acts and residual closes of a forward)."""

from benchmark.lib.nbt_roofline import share_pct
from benchmark.rooflines import nbt


def read(run):
    return share_pct(run, "residual_act_kernel", nbt.residual_sites,
                     nbt.residual_ops, nbt.residual_bytes)
