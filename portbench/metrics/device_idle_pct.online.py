"""The share of the traced online window in which the device runs no
kernel, copy or memset, in %."""


def read(record):
    tr = record.get("trace")
    if record.get("mode") != "online" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
