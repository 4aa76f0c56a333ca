"""Config 3's overflow counters over the benchmark's pool of train rooms.

Writes the pool of ``config3-train`` (``portbench/configs/config3_s3dis.*``,
16 synthetic rooms of 524,288 points) into a temporary directory, then runs
the port's ``prepare_inputs`` on each room as the file reads it and on the
first batches the train ``Loader`` makes of a seed (augmented and cropped),
and prints one JSON line a scene: ``voxel_overflow``,
``hierarchy_overflow``, ``dense_tail_oob`` and the live sites at each
scale; then a line of the totals and the most sites at each scale against
the capacities::

    python3 benchmarks/config3_overflow.py [--seed 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONF = "portbench/configs/config3_s3dis.yaml"
COUNTERS = ("voxel_overflow", "hierarchy_overflow", "dense_tail_oob")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pool", type=int, default=16)
    args = ap.parse_args(argv)

    import torch
    from portbench.core import common
    from portbench.core.scenes import write_pool
    from sparse_rcnn_tpu_torch.data.datasets import build_dataset
    from sparse_rcnn_tpu_torch.data.pipeline import Loader, collate
    from sparse_rcnn_tpu_torch.train import loop as TL

    d = tempfile.mkdtemp(prefix="config3_overflow_", dir=os.environ.get("TMPDIR"))
    try:
        cfg = common.load_cfg(CONF, d)
        write_pool(common.scene_recipe(CONF), cfg, d, "train", args.pool)
        tcfg = TL.train_cfg(cfg)
        caps = list(cfg.scale_capacities())
        total = {k: 0 for k in COUNTERS}
        most = [0] * len(caps)

        @torch.no_grad()
        def one(kind, i, host):
            batch = TL.to_device(host, args.device, TL.TRAIN_KEYS)
            _, _, scales, _, aux = TL.prepare_inputs(tcfg, batch)
            row = {"scenes": kind, "i": i, **{k: int(aux[k]) for k in COUNTERS},
                   "sites": [int(s.nvalid.sum()) for s in scales]}
            for k in COUNTERS:
                total[k] += row[k]
            for s, n in enumerate(row["sites"]):
                most[s] = max(most[s], n)
            print(json.dumps(row), flush=True)

        ds = build_dataset(cfg, "train")
        for i in range(len(ds)):
            one("raw", i, collate([ds[i]]))
        loader = Loader(cfg, "train", seed=args.seed)
        try:
            for i, host in zip(range(args.pool), loader):
                one("loader", i, host)
        finally:
            loader.close()
        print(json.dumps({"total": total, "most_sites": most, "capacities": caps,
                          "scenes": 2 * args.pool, "seed": args.seed}), flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
