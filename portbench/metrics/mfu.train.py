"""The whole train step's share of the card's peak: useful FLOPs of the
traced steps (three times the forward's, less the stem's skipped dgrad,
from the reference's rulebooks of each traced batch) over the traced
window's wall time times 989 TFLOP/s (bf16), in %."""

from portbench.core.flops import PEAK_BF16, train_step_flops


def read(record):
    tr = record.get("trace")
    stats = record.get("rulebook_stats")
    if record.get("mode") != "train" or tr is None or not stats:
        return None
    flops = sum(train_step_flops(record["cfg"], s) for s in stats)
    return 100.0 * flops / (tr.window_s * PEAK_BF16)
