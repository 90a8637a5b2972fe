"""The learner's model FLOPs (forward and backward) over the window
against the dense peak of its convolutions' precision, in percent."""

from benchmark.lib import readers


def read(run):
    return readers.learn_mfu_pct(run)
