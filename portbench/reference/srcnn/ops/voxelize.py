"""Frozen copy of ``sparse_rcnn_tpu_torch/ops/voxelize.py`` at commit 4dd78ef, for the benchmark's
reference (edits: operands through ``precision.q``; the mask read in the
reference's own dtype; no CUDA kernels).

Voxelization and devoxelization (port of ``ops/voxelize.py``).

Quantize points to integer voxel coordinates, deduplicate into a sorted
table of fixed capacity, average features per voxel, and keep the
point→voxel map so per-voxel predictions can be projected back onto points
(the instance metric is computed on points).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..sparse import SENTINEL_COORD, SparseTensor, row_mask
from . import coords as coord_ops
from .consts import device_tensor


def segment_offsets(sorted_seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The bounds of the segments of ``sorted_seg`` (ids in [0, num_segments),
    sorted ascending): int64[num_segments + 1], segment s from ``[s]`` to
    ``[s + 1]``, so their ``diff`` is ``torch.bincount(sorted_seg,
    minlength=num_segments)``, found with no host read (on the card
    ``bincount`` reads the largest id to size its output)."""
    ids = torch.arange(num_segments + 1, dtype=sorted_seg.dtype, device=sorted_seg.device)
    return torch.searchsorted(sorted_seg, ids)


def voxelize_scene(
    points: torch.Tensor, feats: torch.Tensor, valid: torch.Tensor,
    voxel_size, capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxelize one scene: points [N, 3], feats [N, C], valid bool[N].

    Returns (vcoords int32[M, 3] sorted, vfeats [M, C] segment means,
    n_voxels int32, p2v int32[N] (-1 for invalid/dropped points), overflow).
    """
    vs = device_tensor(voxel_size, points.dtype, points.device)
    ic = torch.floor(points / vs).to(torch.int32)
    ucoords, n_voxels, p2v, overflow = coord_ops.unique_coords(ic, valid, capacity)
    # segment mean; dropped points go to a scratch bucket at index capacity.
    # Each voxel's points are summed in point order over a stable sort by
    # voxel (no atomics, unlike index_add_), so the means are the same from
    # run to run and on both devices. The segments' bounds come from the
    # sorted ids and go in as trusted offsets (``unsafe``: segment_reduce
    # checks lengths on the host).
    seg = torch.where(p2v >= 0, p2v, capacity).to(torch.int64)
    order = torch.argsort(seg, stable=True)
    offsets = segment_offsets(seg[order], capacity + 1)
    counts = offsets.diff()
    sums = torch.segment_reduce(feats[order], "sum", offsets=offsets, axis=0,
                                unsafe=True)
    vfeats = sums[:capacity] / torch.clamp(counts[:capacity].to(feats.dtype),
                                           min=1.0)[:, None]
    return ucoords, vfeats, n_voxels, p2v, overflow


def voxelize_batch(points: torch.Tensor, feats: torch.Tensor,
                   valid: torch.Tensor, voxel_size, capacity: int):
    """Voxelize a batch of scenes → (SparseTensor, p2v int32[B, N], overflow[B])."""
    per = [voxelize_scene(p, f, m, voxel_size, capacity)
           for p, f, m in zip(points, feats, valid)]
    vc, vf, nv, p2v, ovf = (torch.stack(x) for x in zip(*per))
    mask = row_mask(nv, capacity)
    st = SparseTensor(
        coords=torch.where(mask[..., None], vc, SENTINEL_COORD),
        feats=vf * mask[..., None].to(vf.dtype), nvalid=nv, stride=1)
    return st, p2v, ovf


def rebase_coords(st: SparseTensor, margin: int = 2):
    """Shift each scene's coords so its minimum live coordinate sits at
    ``margin``. Returns (rebased SparseTensor, base int32[B, 3]) with
    ``new == old - base`` on live rows; padding rows keep the sentinel."""
    mask = st.row_mask
    big = coord_ops.COORD_OFFSET
    cmin = torch.where(mask[..., None], st.coords, big).amin(dim=1)   # [B, 3]
    any_live = mask.any(dim=1)
    base = torch.where(any_live[:, None], cmin - margin, 0).to(torch.int32)
    new = torch.where(mask[..., None], st.coords - base[:, None, :], SENTINEL_COORD)
    return st.replace(coords=new.to(torch.int32)), base


def devoxelize(voxel_values: torch.Tensor, p2v: torch.Tensor, fill_value=0):
    """Map per-voxel values [B, M, ...] back to points via p2v [B, N].

    Points whose voxel was dropped (p2v == -1) get ``fill_value``.
    """
    m = voxel_values.shape[1]
    safe = p2v.clamp(0, m - 1).to(torch.int64)
    out = torch.stack([v[s] for v, s in zip(voxel_values, safe)])
    keep = (p2v >= 0).reshape(p2v.shape + (1,) * (out.ndim - p2v.ndim))
    return torch.where(keep, out, out.new_full((), fill_value))
