"""MuZero's model FLOPs over the window against the bf16 dense peak, in
percent (its self-play cell): every simulation's recurrent inference (g
with the reward head, then f) on every lane, and every search's initial
inference (h, then f) on every lane's root (``muzero.forward_flops``)."""

from benchmark.lib import muzero, peaks


def read(run):
    st = run.driver.window_stats
    c = run.cell.config
    if (run.driver.kind != "selfplay" or c.get("body") != "muzero"
            or not st.get("moves")):
        return None
    lanes, sims = int(run.cell.traffic["lanes"]), int(
        run.cell.traffic["simulations"])
    flop = st["moves"] * lanes * (sims * muzero.forward_flops(c)
                                  + muzero.forward_flops(c, initial=True))
    return 100.0 * flop / st["seconds"] / peaks.FLOPS[c["search_precision"]]
