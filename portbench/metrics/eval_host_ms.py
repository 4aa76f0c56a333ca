"""Host scoring a scene in the eval pass: ``run_eval``'s own ``eval_host_s``
over the scenes it scored, in ms."""


def read(record):
    ev = record.get("eval")
    if record.get("mode") != "eval" or not ev or not ev.get("scenes"):
        return None
    return 1e3 * ev["eval_host_s"] / ev["scenes"]
