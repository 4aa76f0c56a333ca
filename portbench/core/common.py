"""What every run shares: the checkout's cache directories, the card check,
the configuration, the per-layer metric readers, the check that neither
JAX nor the JAX package was loaded, and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from typing import Dict, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # portbench/
ROOT = os.path.dirname(BENCH)                                         # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "sparse_rcnn_tpu")


def set_environment() -> None:
    """Before numpy or torch is imported: one thread for every math library
    on the host (the Loader's augmentation multiplies small matrices; a
    pool of spinning BLAS threads per call competes with the thread that
    launches the step's kernels); fixed cache directories inside the
    checkout (the port's own build directory,
    ``sparse_rcnn_tpu_torch/_build/``, already is one); no Flax behind any
    library."""
    for v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[v] = "1"
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` equal, as whole names, to JAX's,
    Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str):
    """(workload, config entry, traffic parameters) of cell ``name``."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(BENCH, "traffic", f"{wl['traffic']}.json")) as f:
        traffic = json.load(f)
    return wl, conf, traffic


def load_cfg(conf_file: str, data_root: str, overrides: Optional[dict] = None):
    """The port's config from the configuration's file, with ``data_root``
    pointed at the scenes this run wrote."""
    from sparse_rcnn_tpu_torch.config import load_config
    return load_config(os.path.join(ROOT, conf_file), run_overrides(data_root, overrides))


def run_overrides(data_root: str, overrides: Optional[dict] = None) -> dict:
    """``data.data_root`` set to ``data_root``, over ``overrides`` (the
    tests' tiny sizes; none in a benchmark run)."""
    def merge(a: dict, b: dict) -> dict:
        out = dict(a)
        for k, v in b.items():
            out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
        return out
    return merge(overrides or {}, {"data": {"data_root": data_root}})


def scene_recipe(conf_file: str) -> dict:
    with open(os.path.join(ROOT, conf_file.rsplit(".", 1)[0] + ".scenes.json")) as f:
        return json.load(f)


def limits(workload: str) -> Dict[str, float]:
    with open(os.path.join(BENCH, "limits", f"{workload}.json")) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def judge(numbers: Dict[str, float], lims: Dict[str, float]) -> bool:
    """Every compared number within its limit (a missing or NaN one fails)."""
    return all(k in numbers and numbers[k] <= lims[k] for k in lims)


def read_metric(name: str, record: dict) -> Optional[float]:
    """The per-layer metric ``name`` from ``metrics/<name>.py::read``; None
    when its reader finds nothing to read."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    v = mod.read(record)
    return None if v is None or not math.isfinite(v) else float(v)


def emit(result: dict, numbers: Dict[str, float], lims: Dict[str, float]) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output,
    with the same numbers under ``checks`` as its last key."""
    for k in lims:
        print(f"check {k}: {numbers.get(k)!r} limit {lims[k]!r}", file=sys.stderr)
    result["checks"] = {k: {"value": numbers.get(k), "limit": lims[k]} for k in lims}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
