"""Fixed-capacity batched sparse voxel tensor (port of ``sparse.py``).

Each scene owns a row table of fixed capacity; ``nvalid`` marks how many
rows are live. Rows are sorted lexicographically by coordinate per scene,
padding rows hold the sentinel coordinate ``COORD_OFFSET - 1`` and zero
features.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops import coords as coord_ops

SENTINEL_COORD = coord_ops.COORD_OFFSET - 1


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """A batch of sparse voxel grids with fixed row capacity.

    coords int32[B, M, 3], feats float[B, M, C], nvalid int32[B], and the
    voxel ``stride`` of this site set relative to the finest level.
    """

    coords: torch.Tensor
    feats: torch.Tensor
    nvalid: torch.Tensor
    stride: int = 1

    @property
    def batch_size(self) -> int:
        return self.coords.shape[0]

    @property
    def capacity(self) -> int:
        return self.coords.shape[1]

    @property
    def row_mask(self) -> torch.Tensor:
        """bool[B, M] — True for live rows."""
        return row_mask(self.nvalid, self.capacity)

    def replace(self, **changes) -> "SparseTensor":
        return dataclasses.replace(self, **changes)


def row_mask(nvalid: torch.Tensor, capacity: int) -> torch.Tensor:
    """bool[B, capacity]: row i of scene b is live iff i < nvalid[b]."""
    rows = torch.arange(capacity, dtype=torch.int32, device=nvalid.device)
    return rows[None, :] < nvalid[:, None]


def make_sparse_tensor(coords: torch.Tensor, feats: torch.Tensor,
                       nvalid: torch.Tensor, stride: int = 1,
                       assume_sorted: bool = False) -> SparseTensor:
    """Build a SparseTensor, sorting rows lexicographically per scene
    (``assume_sorted``: the live rows are sorted already, as the host
    voxelizer's are).

    Padding rows may hold anything; they are rewritten to the sentinel
    coordinate and zero features.
    """
    mask = row_mask(nvalid, coords.shape[1])
    coords = torch.where(mask[..., None], coords, SENTINEL_COORD)
    feats = feats * mask[..., None].to(feats.dtype)
    if assume_sorted:
        return SparseTensor(coords=coords, feats=feats, nvalid=nvalid, stride=stride)
    keys = coord_ops.pack_coords(coords, mask)
    order = torch.sort(keys, dim=1, stable=True).indices
    coords = torch.gather(coords, 1, order[..., None].expand_as(coords))
    feats = torch.gather(feats, 1, order[..., None].expand_as(feats))
    return SparseTensor(coords=coords, feats=feats, nvalid=nvalid, stride=stride)
