"""Device busy time a train step: the union of every kernel, copy and memset
interval of the traced steps, divided by their count, in ms."""


def read(record):
    tr = record.get("trace")
    if record.get("mode") != "train" or tr is None or not record.get("traced"):
        return None
    return 1e3 * tr.busy_s / record["traced"]
