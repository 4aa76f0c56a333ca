"""3D RoI crop over sparse voxel tables (port of ``ops/roi.py``).

A static D³ lattice per box is sampled with trilinear interpolation over 8
sparse lookups per sample point. Empty space (no voxel at a corner)
contributes zero, exactly like the implicit zeros of the sparse tensor.
All functions are per scene.
"""

from __future__ import annotations

import torch

from . import coords as coord_ops
from . import index_grad
from .consts import device_tensor

# corner c of a unit cell: (c >> 2 & 1, c >> 1 & 1, c & 1)
_CORNERS = [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)]


def _table(table_coords, table_nvalid):
    m = table_coords.shape[0]
    mask = torch.arange(m, dtype=torch.int32, device=table_coords.device) < table_nvalid
    return coord_ops.pack_coords(table_coords, mask)


def roi_grid_positions(boxes: torch.Tensor, grid: int) -> torch.Tensor:
    """Sample positions for each box: [P, grid³, 3] (stride-1 voxel units).

    Cell-center convention: g_i = lo + (i + 0.5) / grid * (hi - lo).
    """
    lo, hi = boxes[..., :3], boxes[..., 3:]
    steps = (torch.arange(grid, dtype=boxes.dtype, device=boxes.device) + 0.5) / grid
    gx, gy, gz = torch.meshgrid(steps, steps, steps, indexing="ij")
    offs = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    return lo[:, None, :] + offs[None, :, :] * (hi - lo)[:, None, :]


def sample_trilinear(table_coords, table_nvalid, feats, positions,
                     stride: int = 1) -> torch.Tensor:
    """Trilinearly sample sparse per-voxel features at continuous positions.

    table_coords int32[M, 3] sorted site set at ``stride``; feats [M, C];
    positions float[..., 3] in stride-1 voxel units → float[..., C], zero
    where no voxels exist. A voxel (i,j,k) at stride s covers [i*s, (i+1)*s)
    and its feature sits at the cell centre (i + 0.5) * s. The sum over
    the 8 corners is :func:`.index_grad.corner_gather`, whose backward on
    the card is the ``roi_crop_grad`` kernel.
    """
    table = _table(table_coords, table_nvalid)
    q = positions / stride - 0.5
    base = torch.floor(q).to(torch.int32)
    frac = q - base
    offs = device_tensor(_CORNERS, torch.int32, positions.device)
    shape = (8,) + (1,) * (base.ndim - 1) + (3,)
    offs = offs.reshape(shape)
    cc = base[None] + offs
    w = torch.prod(torch.where(offs > 0, frac[None], 1.0 - frac[None]), dim=-1)
    idx = coord_ops.table_lookup_bulk(table, coord_ops.pack_coords(cc))
    return index_grad.corner_gather(feats, idx, w)


def sample_nearest(table_coords, table_nvalid, values, positions,
                   stride: int = 1, fill_value=-1) -> torch.Tensor:
    """Nearest-voxel sampling of per-voxel labels: values at
    floor(position / stride), or ``fill_value`` where empty."""
    m = table_coords.shape[0]
    table = _table(table_coords, table_nvalid)
    cc = torch.floor(positions / stride).to(torch.int32)
    idx = coord_ops.table_lookup_bulk(table, coord_ops.pack_coords(cc))
    val = values[idx.clamp(0, m - 1).to(torch.int64)]
    return torch.where(idx >= 0, val, values.new_full((), fill_value))


def roi_crop(table_coords, table_nvalid, feats, boxes, grid: int,
             stride: int = 1) -> torch.Tensor:
    """Crop [P, grid, grid, grid, C] features per box (one scene)."""
    pos = roi_grid_positions(boxes, grid)
    sampled = sample_trilinear(table_coords, table_nvalid, feats, pos, stride)
    return sampled.reshape(boxes.shape[0], grid, grid, grid, feats.shape[-1])
