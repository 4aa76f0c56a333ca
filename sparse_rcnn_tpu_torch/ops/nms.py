"""3D boxes, IoU, top-k and greedy NMS with a fixed budget (port of ``ops/nms.py``).

Boxes are axis-aligned 3D: (x1, y1, z1, x2, y2, z2) in stride-1 voxel units.
Ties are broken as the JAX package breaks them: ``lax.top_k`` and
``jnp.argmax`` both take the lower index first, which a stable descending
sort and ``torch.argmax`` (first maximum) reproduce.

:func:`nms_3d` takes a batch of scenes. On CUDA tensors it runs the
hand-written kernel of ``csrc/nms.cu`` (built with ``nvcc -fmad=false`` at
first use into ``sparse_rcnn_tpu_torch/_build/`` beside the other
libraries, bound with ``ctypes``): the whole batch in one launch, a block a
scene, no host sync, bit-equal on the card to the plain loop
:func:`nms_3d_reference`, which every other device runs scene by scene.
There is no fallback: a CUDA tensor gets the kernel or an exception.
``NMS`` counts the launches.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from . import sparse_conv as sc
from ..utils.profiling import count

_SRC = Path(__file__).resolve().parent / "csrc" / "nms.cu"
_LIB = sc.Library(_SRC, "nms", {
    "nms_3d": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float]
              + [ctypes.c_void_p] * 3,
    "nms_3d_max_candidates": [],
}, flags=("-fmad=false",))


def box_volume(boxes: torch.Tensor) -> torch.Tensor:
    d = torch.clamp(boxes[..., 3:] - boxes[..., :3], min=0.0)
    return d[..., 0] * d[..., 1] * d[..., 2]


def box_iou_3d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a [N, 6], b [M, 6] → [N, M]."""
    lo = torch.maximum(a[:, None, :3], b[None, :, :3])
    hi = torch.minimum(a[:, None, 3:], b[None, :, 3:])
    inter = torch.prod(torch.clamp(hi - lo, min=0.0), dim=-1)
    union = box_volume(a)[:, None] + box_volume(b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_3d_reference(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float, max_outputs: int):
    """Greedy NMS of one scene with a static output budget, the plain loop.

    boxes [N, 6], scores [N], valid bool[N] → (keep_idx int32[max_outputs]
    (-1 padded), keep_mask bool[max_outputs]).
    """
    n = boxes.shape[0]
    dev = boxes.device
    iou = box_iou_3d(boxes, boxes)
    neg_inf = scores.new_full((), float("-inf"))
    s = torch.where(valid, scores, neg_inf)
    rows = torch.arange(n, device=dev)
    keep_idx = torch.full((max_outputs,), -1, dtype=torch.int32, device=dev)
    keep_mask = torch.zeros((max_outputs,), dtype=torch.bool, device=dev)
    # the winner is a 1-element index: a 0-d tensor index is read on the host
    for i in range(max_outputs):
        best = torch.argmax(s).reshape(1)
        ok = s[best][0] > neg_inf
        keep_idx[i] = torch.where(ok, best[0].to(torch.int32), -1)
        keep_mask[i] = ok
        # suppress the winner and everything overlapping it
        suppress = (iou[best][0] >= iou_threshold) | (rows == best)
        s = torch.where(ok & suppress, neg_inf, s)
    return keep_idx, keep_mask


class Nms3dKernel:
    """``nms_3d`` of ``csrc/nms.cu`` and a count of its launches (a plain
    integer that goes up by one for each launch and nowhere else)."""

    def __init__(self):
        self.launches = 0

    def load(self):
        return _LIB.get().nms_3d

    def __call__(self, boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float, max_outputs: int):
        """boxes f32 [..., N, 6], scores f32 [..., N], valid bool [..., N] on
        one CUDA device → (keep_idx int32 [..., max_outputs], keep_mask bool
        [..., max_outputs]), each scene as :func:`nms_3d_reference`."""
        dev = boxes.device
        if dev.type != "cuda" or scores.device != dev or valid.device != dev:
            raise ValueError(f"nms_3d kernel: boxes, scores and valid must be on one CUDA "
                             f"device, got {boxes.device}, {scores.device}, {valid.device}")
        if boxes.dtype != torch.float32 or scores.dtype != torch.float32 \
                or valid.dtype != torch.bool:
            raise TypeError(f"nms_3d kernel takes float32 boxes and scores and bool valid, got "
                            f"{boxes.dtype}, {scores.dtype}, {valid.dtype}")
        lead, n = boxes.shape[:-2], boxes.shape[-2] if boxes.dim() >= 2 else -1
        if n < 0 or boxes.shape[-1] != 6 or scores.shape != lead + (n,) \
                or valid.shape != scores.shape:
            raise ValueError(f"nms_3d: boxes {tuple(boxes.shape)} must be [..., N, 6], scores "
                             f"{tuple(scores.shape)} and valid {tuple(valid.shape)} [..., N]")
        b = math.prod(lead)
        keep_idx = torch.empty(lead + (max_outputs,), dtype=torch.int32, device=dev)
        keep_mask = torch.empty(lead + (max_outputs,), dtype=torch.bool, device=dev)
        if b == 0 or max_outputs == 0:
            return keep_idx, keep_mask
        most = _LIB.get().nms_3d_max_candidates()       # the kernel's registers a block
        if n > most or b * n * 6 >= 2 ** 31 or b * max_outputs >= 2 ** 31:
            raise ValueError(f"nms_3d kernel: {b} scenes of {n} candidates, {max_outputs} "
                             f"outputs: at most {most} candidates a scene")
        boxes, scores, valid = boxes.contiguous(), scores.contiguous(), valid.contiguous()
        fn = self.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), b, n, max_outputs,
                     iou_threshold, keep_idx.data_ptr(), keep_mask.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"nms_3d kernel launch failed: CUDA error {err}")
        self.launches += 1
        count("nms_scenes", b)
        return keep_idx, keep_mask


NMS = Nms3dKernel()


def nms_3d(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
           iou_threshold: float, max_outputs: int):
    """Greedy NMS with a static output budget, per scene of a batch.

    boxes [..., N, 6], scores [..., N], valid bool[..., N] → (keep_idx
    int32[..., max_outputs] (-1 padded), keep_mask bool[..., max_outputs]):
    the kernel on CUDA tensors, one launch; :func:`nms_3d_reference` scene
    by scene on any other device.
    """
    if boxes.device.type == "cuda":
        return NMS(boxes, scores, valid, iou_threshold, max_outputs)
    n = boxes.shape[-2]
    kept = [nms_3d_reference(bx, s, v, iou_threshold, max_outputs) for bx, s, v in zip(
        boxes.reshape(-1, n, 6), scores.reshape(-1, n), valid.reshape(-1, n))]
    shape = boxes.shape[:-2] + (max_outputs,)
    return tuple(torch.stack(k).reshape(shape) for k in zip(*kept))


def topk_rows(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Top-k over valid entries along the last axis: (values, idx int32[..., k],
    mask bool[..., k]); ties keep the lower index first."""
    masked = torch.where(valid, scores, scores.new_full((), float("-inf")))
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return vals, idx.to(torch.int32), torch.isfinite(vals)
