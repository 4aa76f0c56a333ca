"""Edge cases of the optimizer's kernels (``sparse_rcnn_tpu_torch/ops/optim.py``)
and the helpers that run them against their plain versions.

``tests/test_torch_kernel_cuda.py`` holds the kernels to the plain versions
on these cases on the card, and ``chip_smoke.py`` phase 3 does the same and
times config 1's and config 2's shapes. Imports no JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.ops import optim as OPT
from sparse_rcnn_tpu_torch.train import loop as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_C = OPT.CHUNK

# (name, sizes or a config's name, kind, gradients, count, EMA): "clip" gradients have
# a norm far past the clip of 10, "keep" one below it, "zero" all zero (norm 0, kept),
# "nan" one NaN entry. "views" puts every tensor at an odd offset of its storage (not
# 16-byte aligned: the kernels' plain loads); "channels_last" and the configs store
# every 5-D gradient channels-last, as cuDNN returns a conv3d weight's; "long" is two
# launches of tensors.
OPTIM_CASES = [
    ("one_entry", [1], "adamw", "clip", 1, False),
    ("chunk_edges", [_C - 1, _C, _C + 1], "adamw", "clip", 1, False),
    ("odd_sizes", [7, 1001, 3, 2 * _C + 5], "adamw", "keep", 3, False),
    ("views", [_C + 3, 9, 4 * _C], "adamw", "clip", 2, True),
    ("channels_last", [(32, 16, 3, 3, 3), (128, 128, 2, 2, 2), (7, 5, 3, 1, 2), (3, 2, 4, 4),
                       (5,)], "adamw", "clip", 1, True),
    ("keep", [1000, 3000, 5], "adamw", "keep", 1, False),
    ("zero", [1000, 3000], "adamw", "zero", 1, False),
    ("nan", [1000, 3000, 17], "adamw", "nan", 1, False),
    ("count_1e4", [5000, 33], "adamw", "clip", 10 ** 4, False),
    ("ema", [5000, 33], "adamw", "clip", 2, True),
    ("sgd", [5000, 33], "sgd", "clip", 1, False),
    ("sgd_ema", [(16, 8, 3, 3, 3), 33], "sgd", "keep", 7, True),
    ("ema_only", [5000, 33, 1], "ema", "clip", 1, True),
    ("long", [(i * 997) % 3000 + 1 for i in range(OPT.MAX_TENSORS + 5)], "adamw", "clip", 1,
     True),
    ("config2", "config2_scannet_2cm", "adamw", "clip", 1, False),
]
GRAD_SCALE = {"clip": 3.0, "keep": 1e-4, "zero": 0.0, "nan": 1.0}


def config_shapes(config: str) -> list:
    """The shapes of the parameters of ``configs/<config>.yaml``, in
    ``model.parameters()`` order (a model on the meta device: no weights)."""
    cfg = load_config(os.path.join(ROOT, "configs", f"{config}.yaml"))
    return [tuple(p.shape) for p in TL.build_model(TL.train_cfg(cfg), "meta").parameters()]


def case_shapes(sizes) -> list:
    """A case's shapes: a config's, or each size as a shape (an int as 1-D)."""
    if isinstance(sizes, str):
        return config_shapes(sizes)
    return [(s,) if isinstance(s, int) else tuple(s) for s in sizes]


def layout(name: str) -> str:
    """The gradients' layout of case ``name``: "offset", or "channels_last"
    (every 4-D and 5-D gradient; also the configs', as in a train step)."""
    return {"views": "offset", "one_entry": "contiguous"}.get(name, "channels_last")


def fresh(t: torch.Tensor, offset: int = None) -> torch.Tensor:
    """A copy of ``t`` in its own storage and layout: a 1-D tensor at
    ``offset`` entries into it (by default its own offset modulo 4, so a
    copy keeps its alignment), any other in ``t``'s memory format."""
    if t.dim() != 1:
        return torch.empty_like(t).copy_(t)
    off = t.storage_offset() % 4 if offset is None else offset
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    return buf[off:].copy_(t)


def optim_case(device, shapes, grads="clip", seed=0, layout="contiguous") -> dict:
    """Gradients, parameters, moments and an EMA copy of ``shapes``, from a
    numpy seed, on ``device``; ``layout`` as :func:`layout` gives it (for
    the gradients; "offset" for every list)."""
    rng = np.random.default_rng(seed)

    def fill(scale, positive=False):
        out = []
        for s in shapes:
            x = rng.standard_normal(s).astype(np.float32) * np.float32(scale)
            out.append(torch.from_numpy(np.abs(x) if positive else x).to(device))
        return out
    lists = {"grads": fill(GRAD_SCALE[grads]), "params": fill(1.0), "mu": fill(0.1),
             "nu": fill(0.01, positive=True), "ema": fill(1.0)}
    if grads == "nan":
        lists["grads"][-1].view(-1)[lists["grads"][-1].numel() // 2] = float("nan")
    if layout == "offset":
        return {k: [fresh(t.reshape(-1), 1).view(t.shape) for t in v] for k, v in lists.items()}
    if layout == "channels_last":
        fmt = {4: torch.channels_last, 5: torch.channels_last_3d}
        lists["grads"] = [g.contiguous(memory_format=fmt[g.dim()]) if g.dim() in fmt else g
                          for g in lists["grads"]]
    return lists


def run_optim(lists: dict, kind: str, count: int, ema: bool, kernel: bool) -> tuple:
    """The norm and one optimizer call on copies of ``lists``, by the kernels
    or by the plain versions: (norm, params, mu, nu, ema) after it."""
    c = {k: [fresh(t) for t in v] for k, v in lists.items()}
    step = OPT.Step(kind, lr=3e-3, count=count, clip=10.0, weight_decay=0.05,
                    ema_decay=np.float32(0.9) if ema else None)
    norm = None
    if kind != "ema":
        norm = (OPT.global_norm_kernel if kernel else OPT.global_norm_reference)(c["grads"])
    nu = c["nu"] if kind == "adamw" else None
    (OPT.optim_apply_kernel if kernel else OPT.optim_apply_reference)(
        norm, c["grads"], c["params"], c["mu"], nu, c["ema"] if ema else None, step)
    return norm, c["params"], c["mu"], nu, c["ema"] if ema else None


def same_bits(a, b) -> bool:
    """Bit for bit, a NaN equal to any NaN; lists and None element-wise."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, list):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    nan = torch.tensor(float("nan"), device=a.device)
    return torch.equal(torch.where(a.isnan(), nan, a).view(torch.int32),
                       torch.where(b.isnan(), nan, b).view(torch.int32))
