"""The eval pass's share of the card's peak: useful forward FLOPs of the
traced batches (from the reference's rulebooks of each) over the traced
window's wall time times 989 TFLOP/s (bf16), in %."""

from portbench.core.flops import PEAK_BF16, useful_forward_flops


def read(record):
    tr = record.get("trace")
    stats = record.get("rulebook_stats")
    if record.get("mode") != "eval" or tr is None or not stats:
        return None
    flops = sum(useful_forward_flops(record["cfg"], s) for s in stats)
    return 100.0 * flops / (tr.window_s * PEAK_BF16)
