"""``conv3x3_kernel``'s share of its roofline over MuZero's traced
self-play move, in percent: every 3x3 conv of both towers and the policy
head at its published shape (``rooflines/muzero.py``)."""

from benchmark.lib.muzero_roofline import share_pct
from benchmark.rooflines import muzero


def read(run):
    c = run.cell.config
    if c.get("body") != "muzero":
        return None
    sites = muzero.conv3x3_sites(c, int(run.cell.traffic["simulations"]))
    return share_pct(run, "conv3x3_kernel", sites, muzero.conv3x3_ops,
                     muzero.conv3x3_bytes)
