"""``latent_scale_kernel``'s share of its roofline over MuZero's traced
self-play move, in percent: the latent store's writes, one launch a
simulation and one at the search's root (h's state), each reading a state
once and writing it twice (``rooflines/muzero.py``)."""

from benchmark.lib.muzero_roofline import share_pct
from benchmark.rooflines import muzero


def read(run):
    c = run.cell.config
    if c.get("body") != "muzero":
        return None
    sites = [(c["mz_filters"],)] * (int(run.cell.traffic["simulations"]) + 1)
    return share_pct(run, "latent_scale_kernel", sites,
                     muzero.latent_scale_ops, muzero.latent_scale_bytes)
