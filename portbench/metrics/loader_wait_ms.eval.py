"""The eval Loaders' wait a batch: their ``wait_s`` summed over the
Loaders that fed the window's ``run_eval`` pass, over their
``batches_out``, in ms."""


def read(record):
    ld = record.get("loader")
    if record.get("mode") != "eval" or not ld or not ld["batches_out"]:
        return None
    return 1e3 * ld["wait_s"] / ld["batches_out"]
