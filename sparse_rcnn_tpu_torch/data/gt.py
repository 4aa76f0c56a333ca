"""Device-side ground truth from labeled point clouds (port of ``data/gt.py``).

Segment ops over static capacities, per scene:

  * per-voxel instance/semantic labels: segment max over the point→voxel
    map (a voxel takes the highest id among its points),
  * instance AABBs: segment min/max of point positions per instance id,
  * instance classes: segment max of point semantic labels per instance.

The JAX ``segment_max``/``segment_min`` become ``scatter_reduce`` with
``include_self=False`` on tensors initialised to the JAX identity (the
dtype's lowest value for max, +inf for min), so empty segments come out as
in the JAX package and are clamped to -1 the same way. JAX drops segment
ids outside ``[0, num_segments)``; here they go to the scratch segment that
is cut off. Max and min do not depend on the order of the reduction, so
the results are the same bit for bit on every device. Positions are in
rebased stride-1 voxel units (``position / voxel_size - base``), the frame
of the voxel coordinates.
"""

from __future__ import annotations

import torch

from ..models.targets import SceneGT
from ..ops.consts import device_tensor
from ..ops.voxelize import segment_offsets


def _segment(values, seg, num_segments: int, reduce: str, init):
    """``jax.ops.segment_{max,min}`` over dim 0 (``seg`` in [0, num_segments))."""
    shape = (num_segments,) + tuple(values.shape[1:])
    out = torch.full(shape, init, dtype=values.dtype, device=values.device)
    index = seg.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce(0, index, values, reduce, include_self=False)


def build_scene_gt(points, valid, point_instance, point_semantic, p2v,
                   voxel_capacity: int, voxel_size, max_instances: int,
                   base=None) -> SceneGT:
    """Batched: points [B,N,3], labels int32[B,N], p2v int32[B,N] → SceneGT.

    ``base`` int32[B,3]: the per-scene integer rebase applied to voxel
    coords (``ops.voxelize.rebase_coords``); boxes get the same shift.
    """
    dev = points.device
    vs = device_tensor(voxel_size, points.dtype, dev)
    if base is None:
        base = torch.zeros((points.shape[0], 3), dtype=torch.int32, device=dev)
    i32_min = torch.iinfo(torch.int32).min
    inf = float("inf")
    per = []
    for pts, vld, pinst, psem, pv, bs in zip(points, valid, point_instance,
                                             point_semantic, p2v, base):
        pos = pts / vs - bs.to(pts.dtype)        # rebased stride-1 voxel units

        # per-voxel labels (segment max over the p2v map)
        seg_v = torch.where((pv >= 0) & vld, pv, voxel_capacity).to(torch.int64)
        minus1 = torch.full_like(pinst, -1)
        vinst = _segment(torch.where(vld, pinst, minus1), seg_v, voxel_capacity + 1,
                         "amax", i32_min)[:voxel_capacity]
        vsem = _segment(torch.where(vld, psem, minus1), seg_v, voxel_capacity + 1,
                        "amax", i32_min)[:voxel_capacity]
        vinst = torch.clamp(vinst, min=-1)       # empty segments: dtype min → -1
        vsem = torch.clamp(vsem, min=-1)

        # instance boxes
        has_inst = (pinst >= 0) & vld
        seg_i = torch.where(has_inst & (pinst < max_instances), pinst,
                            max_instances).to(torch.int64)
        lo = _segment(torch.where(has_inst[:, None], pos, pos.new_full((), 1e9)), seg_i,
                      max_instances + 1, "amin", inf)[:max_instances]
        hi = _segment(torch.where(has_inst[:, None], pos, pos.new_full((), -1e9)), seg_i,
                      max_instances + 1, "amax", -inf)[:max_instances]
        # every point without a countable instance sits in the scratch segment
        counts = segment_offsets(torch.sort(seg_i).values, max_instances + 1).diff()
        ivalid = counts[:max_instances] > 0
        boxes = torch.where(ivalid[:, None], torch.cat([lo, hi], -1), 0.0)

        # instance classes
        icls = _segment(torch.where(has_inst, psem, minus1), seg_i, max_instances + 1,
                        "amax", i32_min)[:max_instances]
        icls = torch.where(ivalid, torch.clamp(icls, min=-1), -1)
        per.append((boxes, icls.to(torch.int32), ivalid, vinst.to(torch.int32),
                    vsem.to(torch.int32)))
    boxes, classes, ivalid, vinst, vsem = (torch.stack(x) for x in zip(*per))
    return SceneGT(boxes=boxes, classes=classes, valid=ivalid,
                   voxel_instance=vinst, voxel_semantic=vsem)
