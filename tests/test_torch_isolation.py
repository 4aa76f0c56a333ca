"""The port stands alone: importing every module of ``sparse_rcnn_tpu_torch``
(the data layer, its C++ host core's binding, the pooling ops, the
data-parallel package ``parallel/``, the profiling and FLOP utilities and the
tools included),
``chip_smoke.py``, the on-card test file and the port's benchmark scripts loads
neither jax, orbax nor anything of ``sparse_rcnn_tpu`` (checked in a fresh
interpreter),
and ``chip_smoke.py`` refuses to run without a CUDA card or without the rest of
the repo, printing no result."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import sparse_rcnn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
need = {pkg.__name__ + "." + m for m in (
    "train.__main__", "train.loop", "data.gt", "data.augment", "data.pipeline",
    "models.targets", "models.losses", "models.convert", "models.unet", "models.layers",
    "ops.hierarchy", "ops.rulebook", "eval", "utils.metrics", "utils.logging",
    "train.checkpoint", "train.evaluate", "data.ply", "data.datasets", "native",
    "ops.pooling", "parallel", "parallel.context", "parallel.data_parallel",
    "utils.profiling", "utils.flops", "tools", "tools.size_capacities",
    "tools.preprocess_scannet", "tools.convert_checkpoint", "ops.consts",
    "ops.index_grad")}
from sparse_rcnn_tpu_torch.data.datasets import S3DISDataset, ScanNetDataset, SemanticKITTIDataset
from sparse_rcnn_tpu_torch.data.pipeline import Loader, device_batches, host_voxelize_scene
from sparse_rcnn_tpu_torch.data.ply import read_ply, write_ply
from sparse_rcnn_tpu_torch.models.layers import SparseDropout, sparse_dropout
from sparse_rcnn_tpu_torch.native import subm_rulebook, voxelize_scene
from sparse_rcnn_tpu_torch.ops.pooling import avg_pool, global_pool, max_pool
from sparse_rcnn_tpu_torch.models.convert import convert_variables
from sparse_rcnn_tpu_torch.models.unet import DenseTail, gather_from_grid, scatter_to_grid
from sparse_rcnn_tpu_torch.models.layers import remat
from sparse_rcnn_tpu_torch.ops.rulebook import downsample_sites
from sparse_rcnn_tpu_torch.parallel.context import World, shard_context
from sparse_rcnn_tpu_torch.parallel.data_parallel import (
    init, make_parallel_eval_step, make_parallel_train_step, replicate_state)
from sparse_rcnn_tpu_torch.utils.profiling import StepTimer, maybe_trace
from sparse_rcnn_tpu_torch.utils.flops import collect_rulebook_stats, useful_forward_flops
from sparse_rcnn_tpu_torch.tools.size_capacities import main as size_main
from sparse_rcnn_tpu_torch.tools.preprocess_scannet import process_scene
from sparse_rcnn_tpu_torch.tools.convert_checkpoint import convert_state
assert need <= set(names), sorted(need - set(names))
import chip_smoke
import tests.test_torch_kernel_cuda
import benchmarks.profile_torch_slice
import benchmarks.eval_step_syncs
import benchmarks.eval_scoring_split
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "sparse_rcnn_tpu"))
print(len(names), "modules")
assert not bad, bad
"""


def _run(args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    res = _run(["-c", _IMPORT_ALL])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 20


def test_train_cli_help():
    res = _run(["-m", "sparse_rcnn_tpu_torch.train", "--help"])
    assert res.returncode == 0, res.stderr
    assert "--log-file" in res.stdout and "--profile" in res.stdout
    assert "ROADMAP" not in res.stdout


@pytest.mark.parametrize("tool", ["size_capacities", "preprocess_scannet",
                                  "convert_checkpoint"])
def test_tool_cli_help(tool):
    res = _run(["-m", f"sparse_rcnn_tpu_torch.tools.{tool}", "--help"])
    assert res.returncode == 0, res.stderr
    assert "--config" in res.stdout or "--raw" in res.stdout


def test_chip_smoke_help():
    res = _run(["chip_smoke.py", "--help"])
    assert res.returncode == 0, res.stderr
    assert "--out-dir" in res.stdout


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke would run for real")
    res = _run(["chip_smoke.py"])
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
