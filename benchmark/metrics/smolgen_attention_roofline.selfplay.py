"""``smolgen_attention_kernel``'s share of its roofline in the traced
stretch of the encoder's self-play cell, in percent: over its launches
(all at the cell's lane count), the least time of each (the larger of its
operations at the bf16 peak and its bytes at the memory's) over the sum
of their traced times."""

from benchmark.lib import peaks
from benchmark.rooflines import smolgen_attention as roof


def read(run):
    if run.trace is None or run.driver.kind != "selfplay":
        return None
    ks = run.trace.kernels(roof.KERNEL)
    if not ks:
        return None
    c = run.cell.config
    H = c["enc_heads"]
    args = (int(run.cell.traffic["lanes"]), H, c["enc_embed"] // H,
            c["smolgen_gen"])
    bound = max(roof.ops(*args) / peaks.BF16_FLOPS,
                roof.bytes_moved(*args) / peaks.HBM_BYTES_PER_S)
    spent = sum(k.end - k.start for k in ks) / 1e6
    return 100.0 * bound * len(ks) / spent
