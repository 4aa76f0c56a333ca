"""Host time of the recompute a train step, in ms: the port's process-wide
counters of rematerialised blocks (``sparse_rcnn_tpu_torch/models/layers.py
::REMAT``), its host ns spent recomputing (the ``remat`` spans' own
durations) over the backward passes that recomputed, over every step of
the run (check steps, warm-up and window). None where the port keeps no
such counters, or no pass recomputed."""

import sys


def read(record):
    layers = sys.modules.get("sparse_rcnn_tpu_torch.models.layers")
    counters = getattr(layers, "REMAT", None)
    if record.get("mode") != "train" or counters is None or not counters.passes:
        return None
    return counters.ns / counters.passes / 1e6
