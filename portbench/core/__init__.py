"""The harness's general code: scenes, weights, spans, the device trace, the
FLOP and byte arithmetic, and the loops that the traffic mixes name."""
