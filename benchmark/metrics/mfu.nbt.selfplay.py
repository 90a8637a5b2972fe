"""The nested-bottleneck body's model FLOPs of every board the window's
searches evaluated (the roots' and one a simulation) over the window,
against the bf16 dense peak, in percent (the body's self-play cell)."""

from benchmark.lib import nbt, peaks


def read(run):
    st = run.driver.window_stats
    c = run.cell.config
    if (run.driver.kind != "selfplay" or c.get("body") != "nbt"
            or not st.get("boards")):
        return None
    rate = st["boards"] * nbt.forward_flops(c) / st["seconds"]
    return 100.0 * rate / peaks.FLOPS[c["search_precision"]]
