"""The device's idle time in the traced stretch of the selfplay cells
whose gap fell while the host was in any other program span (the tree's
reset, the root's expansion, the noise, the sampling, the autoreset),
over the stretch, in percent. The rest of ``device_idle_share.selfplay``
is the driver's own time.

The stretch is one move, the first after the driver's read of its
counters has drained the card, so the root's eager launches run one by
one on an idle card: the reading is mostly how the stretch starts, not the
steady state of the window, and no claim of a gain rests on it until the
stretch takes two or more moves with the first left out."""

from benchmark.lib import spans


def read(run):
    return spans.idle_in_glue_pct(run, "selfplay")
