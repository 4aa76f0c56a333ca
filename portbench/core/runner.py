"""One run of one cell on a device: the context a mode runs in, the mode,
the per-layer metrics and the result's fields."""

from __future__ import annotations

import dataclasses
import importlib
import os
import shutil
import sys
import tempfile
from typing import Callable, Dict, Optional

import torch

from . import common


@dataclasses.dataclass
class Context:
    workload: dict
    conf: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    scene_dir: str
    overrides: Optional[dict] = None
    hooks: Dict[str, Callable] = dataclasses.field(default_factory=dict)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    @property
    def conf_path(self) -> str:
        return os.path.join(common.ROOT, self.conf["file"])

    @property
    def trace_path(self) -> str:
        return os.path.join(self.scene_dir, "trace.json")

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def free(self) -> None:
        if self.cuda:
            torch.cuda.empty_cache()

    def setup_model(self, split: str):
        """What every mode sets up first: the port's config with the pool of
        ``split`` written from the configuration's scene recipe, the port's
        model in the train form (as a checkpoint holds it) with the weights
        drawn from the seed, and a host copy of those weights for the
        reference. Returns (config, model, weights on the host)."""
        from sparse_rcnn_tpu_torch.train import loop as TL
        from .scenes import write_pool
        from .weights import seeded_state_dict
        cfg = common.load_cfg(self.conf["file"], self.scene_dir, self.overrides)
        write_pool(common.scene_recipe(self.conf["file"]), cfg, self.scene_dir, split,
                   self.traffic["pool"])
        model = TL.build_model(TL.train_cfg(cfg), self.device)
        init = seeded_state_dict(model, self.seed, self.device)
        model.load_state_dict(init)
        return cfg, model, {k: v.detach().to("cpu", copy=True) for k, v in init.items()}

    def ref_cfg(self):
        """The reference's config of the same file and scenes."""
        from ..reference.srcnn.config import load_config
        return load_config(self.conf_path, common.run_overrides(self.scene_dir, self.overrides))


def setup_device(name: str, deterministic: bool = True) -> torch.device:
    """The device settings of the entry point whose job a mode runs (the
    port's ``infer.setup_device``): TF32 off; ``deterministic`` (the train
    entry point) makes cuDNN pick deterministic algorithms, and otherwise
    cuDNN keeps torch's defaults, as ``infer.py`` and ``eval.py`` leave it."""
    device = torch.device(name)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = False
        torch.cuda.reset_peak_memory_stats(device)
    return device


def run_cell(bench: dict, wl: dict, conf: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float, overrides: Optional[dict] = None,
             hooks: Optional[dict] = None):
    """(result, numbers compared, limits) of one run of cell ``wl``."""
    mode = importlib.import_module(f"portbench.core.modes.{traffic['mode']}")
    dev = setup_device(device, mode.DETERMINISTIC)
    scene_dir = tempfile.mkdtemp(prefix="portbench_", dir=os.environ.get("TMPDIR"))
    try:
        ctx = Context(wl, conf, traffic, seed, seconds, trace, dev, t_start, scene_dir,
                      overrides, hooks or {})
        out = mode.run(ctx)
    finally:
        shutil.rmtree(scene_dir, ignore_errors=True)
    rec = out["record"]
    print(f"window steps {out['attempted']}, reference {rec.get('reference_s', 0):.1f} s",
          file=sys.stderr)
    if rec.get("returned"):
        # calls returned in each quarter of the window: a warm-up shows here
        r = rec["returned"]
        q = [sum(1 for x in r if k * r[-1] / 4 <= x < (k + 1) * r[-1] / 4 + (k == 3))
             for k in range(4)]
        print(f"window calls by quarter {q}", file=sys.stderr)
    lims = common.limits(wl["name"])
    numbers = out["numbers"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": common.judge(numbers, lims), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device_info}
    if trace:
        record = out["record"]
        for m in bench["per_layer"]:
            if wl["name"] not in m.get("workloads", [wl["name"]]):
                continue
            v = common.read_metric(m["name"], record)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        tr = record.get("trace")
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.top_ops(),
                                   "idle_gaps": tr.idle_by_span(out["spans"])}
    return result, numbers, lims
