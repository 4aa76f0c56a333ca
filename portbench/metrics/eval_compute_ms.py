"""The evaluators' final ``compute`` a scene: ``run_eval``'s own
``eval_compute_s`` (the duration of its ``eval.compute`` span) over the
scenes it scored, in ms. None for a program whose ``run_eval`` does not
time it."""


def read(record):
    ev = record.get("eval")
    if record.get("mode") != "eval" or not ev or not ev.get("scenes") \
            or "eval_compute_s" not in ev:
        return None
    return 1e3 * ev["eval_compute_s"] / ev["scenes"]
