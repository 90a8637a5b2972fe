"""``residual_act_kernel``'s share of its roofline over MuZero's traced
self-play move, in percent: every block's close of both towers, the
residual add and the ReLU (its norm the identity), h's at the search's
root and g's each simulation (``rooflines/muzero.py``)."""

from benchmark.lib.muzero_roofline import share_pct
from benchmark.rooflines import muzero


def read(run):
    c = run.cell.config
    if c.get("body") != "muzero":
        return None
    sites = muzero.residual_sites(c, int(run.cell.traffic["simulations"]))
    return share_pct(run, "residual_act_kernel", sites,
                     muzero.residual_ops, muzero.residual_bytes)
