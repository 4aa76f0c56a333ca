"""The whole request's share of the card's peak: useful forward FLOPs of
the traced sweeps (a batch of one, from the reference's rulebooks of each
sweep) over the traced window's wall time times 989 TFLOP/s (bf16), in %."""

import dataclasses

from portbench.core.flops import PEAK_BF16, useful_forward_flops


def read(record):
    tr = record.get("trace")
    stats = record.get("rulebook_stats")
    if record.get("mode") != "online" or tr is None or not stats:
        return None
    cfg = record["cfg"]
    one = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=1))
    flops = sum(useful_forward_flops(one, s) for s in stats)
    return 100.0 * flops / (tr.window_s * PEAK_BF16)
