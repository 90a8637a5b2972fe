"""The searches' model FLOPs over the window against the bf16 dense peak,
in percent (the bot cells)."""

from benchmark.lib import readers


def read(run):
    return readers.search_mfu_pct(run, "bot")
