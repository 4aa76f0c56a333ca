"""Host time a sweep after the device's work: the harness's spans around
``fetch_eval_outputs`` and ``infer.py::scene_result`` over the traced
requests, divided by their count, in ms."""


def read(record):
    if record.get("mode") != "online" or not record.get("traced") \
            or "online_host_s" not in record:
        return None
    return 1e3 * record["online_host_s"] / record["traced"]
