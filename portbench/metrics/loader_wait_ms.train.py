"""The training Loader's wait a batch: the change of the Loader's ``wait_s``
over the window divided by the change of its ``batches_out``, in ms."""


def read(record):
    ld = record.get("loader")
    if record.get("mode") != "train" or not ld or not ld["batches_out"]:
        return None
    return 1e3 * ld["wait_s"] / ld["batches_out"]
