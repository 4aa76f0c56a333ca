"""The readings that the limits of ``limits/<cell>.json`` are set from, for
many seeds in one process (set-up is long, so one process serves them all).

    python3 portbench/readings.py --workload config2-train --seeds 1,2,3 \
        [--program] [--control] [--half-batch] [--seconds 2] [--out FILE]

``--program`` runs the cell itself (a short window) and keeps the numbers
it compares: the lower readings. ``--control`` puts the reference, computed
in fp8 (``reference/srcnn/precision.py``), in the program's place: the
upper readings. ``--half-batch`` (training) reads the fault "half of the
batch left out, the mean taken over the rest", and ``--stale-answer``
(served answers) the fault "an answer altered where it is produced": each
scene answered with the answer to the one before (its RPN outputs,
proposals, masks and labels); both planted in the reference put in the
program's place, which the float32 reference then follows by stages as it
follows the program. One JSON line per seed and reading.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.core import common  # noqa: E402


def reference_readings(conf: dict, traffic: dict, seed: int, device, what=("control",),
                       overrides=None) -> dict:
    """The numbers of each planted reading of ``what`` of one seed, each
    against the float32 reference: ``control`` (the reference in fp8) for
    every mode; ``half_batch`` for training; ``stale_answer`` (each
    scene answered with the previous scene's answer) for served answers."""
    import torch
    from portbench.core.modes.train import loader_seed
    from portbench.core.scenes import write_pool
    from portbench.core.weights import seeded_state_dict
    from portbench.reference import check as RC
    from portbench.reference.batches import read_scene, scene_files
    from portbench.reference.srcnn.config import load_config
    from portbench.reference.srcnn.train import loop as RL

    def paint_from(a):
        return RC.paint(a["masks"], a["scores"], a["pmask"])

    d = tempfile.mkdtemp(prefix="portbench_", dir=os.environ.get("TMPDIR"))
    split = "train" if traffic["mode"] == "train" else "val"
    try:
        cfg = load_config(os.path.join(common.ROOT, conf["file"]),
                          common.run_overrides(d, overrides))
        write_pool(common.scene_recipe(conf["file"]), cfg, d, split, traffic["pool"])
        model = RL.build_model(RL.train_cfg(cfg), device)
        init = {k: v.cpu() for k, v in seeded_state_dict(model, seed, device).items()}
        del model
        out = {}
        if traffic["mode"] == "train":
            lseed = loader_seed(seed)
            steps = traffic["check_steps"]
            ref = RC.train_reference(cfg, init, lseed, device, steps)
            for w in what:
                got = RC.train_reference(cfg, init, lseed, device, steps,
                                         mode="fp8" if w == "control" else "f32",
                                         drop_half=w == "half_batch")
                got["batches"] = None
                out[w] = RC.train_numbers(got, ref)
            return out
        files = scene_files(cfg, "val")
        k = traffic.get("check_requests", traffic.get("check_scenes"))
        scenes = [read_scene(cfg, files[i], i) for i in range(min(k, len(files)))]
        batches = [{key: v[None] for key, v in s.items()} for s in scenes]
        valid = [s["valid"] for s in scenes]
        for w in what:
            if w == "control":
                got = RC.eval_reference(cfg, init, batches, device, mode="fp8")
            else:
                own = RC.eval_reference(cfg, init, batches, device)
                got = [dict(own[i - 1]) for i in range(len(own))]
                for g in got:
                    g["inst"] = paint_from(g)
            ref = RC.eval_reference(cfg, init, batches, device, follow=[g["rpn"] for g in got])
            out[w] = RC.answer_numbers(got, ref, valid)
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for the limits of a cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--half-batch", action="store_true")
    ap.add_argument("--stale-answer", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.set_environment()
    bench = common.load_bench()
    wl, conf, traffic = common.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    from portbench.core.runner import run_cell, setup_device
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        rows = []
        if args.program:
            res, numbers, _ = run_cell(bench, wl, conf, traffic, seed, args.seconds, False,
                                       "cuda", time.perf_counter())
            rows.append({"reading": "program", "correct": res["correct"], **numbers})
        what = [w for w, on in (("control", args.control), ("half_batch", args.half_batch),
                                ("stale_answer", args.stale_answer)) if on]
        if what:
            got = reference_readings(conf, traffic, seed, setup_device("cuda"), what)
            rows += [{"reading": w, **got[w]} for w in what]
        for r in rows:
            line = json.dumps({"workload": args.workload, "seed": seed, **r})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
