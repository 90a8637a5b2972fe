"""``action_term_kernel``'s share of its roofline over MuZero's traced
self-play move, in percent: one launch a simulation, g's input conv
finished with the action planes' term, the norm and the ReLU
(``rooflines/muzero.py``)."""

from benchmark.lib.muzero_roofline import share_pct
from benchmark.rooflines import muzero


def read(run):
    c = run.cell.config
    if c.get("body") != "muzero":
        return None
    sites = [(c["mz_filters"],)] * int(run.cell.traffic["simulations"])
    return share_pct(run, "action_term_kernel", sites,
                     muzero.action_term_ops, muzero.action_term_bytes)
