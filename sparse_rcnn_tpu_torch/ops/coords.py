"""Coordinate machinery for sparse voxel tables (port of ``ops/coords.py``).

Every (x, y, z) coordinate packs into ONE int64 key,
``(x + 2^15) << 32 | (y + 2^15) << 16 | (z + 2^15)``, which sorts in the
same order as the JAX package's (hi, lo) uint32 pair (torch's uint32 support
is thin). Invalid rows get :data:`SENTINEL_KEY`, larger than any real key,
so they sort last. A sorted table is searched with ``torch.searchsorted``:
the same row-or-−1 answer as the JAX package's sort-merge lookup, which was
a TPU choice.

All functions here are per scene; callers loop over the batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .consts import device_tensor

# Coordinates must lie in [-COORD_OFFSET, COORD_OFFSET): 16 bits per axis.
COORD_BITS = 16
COORD_OFFSET = 1 << (COORD_BITS - 1)
# Real keys are < 2^48, so this sorts after every one of them.
SENTINEL_KEY = 1 << (3 * COORD_BITS)
# What the JAX package's unpack of its sentinel key pair gives: the unused
# rows of a table built by unique_coords hold it, so tables compare bit for
# bit with the reference.
_UNUSED_ROW = (-COORD_OFFSET - 1, COORD_OFFSET - 1, COORD_OFFSET - 1)
_FIELD = (1 << COORD_BITS) - 1


def pack_coords(coords: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int coords [..., 3] → int64 lexicographic keys [...] (sentinel where
    ``valid`` is False)."""
    c = coords.to(torch.int64) + COORD_OFFSET
    key = (c[..., 0] << (2 * COORD_BITS)) | (c[..., 1] << COORD_BITS) | c[..., 2]
    if valid is not None:
        key = torch.where(valid, key, SENTINEL_KEY)
    return key


def unpack_coords(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_coords` (undefined for the sentinel) → int32 [..., 3]."""
    x = (keys >> (2 * COORD_BITS)) - COORD_OFFSET
    y = ((keys >> COORD_BITS) & _FIELD) - COORD_OFFSET
    z = (keys & _FIELD) - COORD_OFFSET
    return torch.stack([x, y, z], dim=-1).to(torch.int32)


def table_lookup_bulk(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Row of each query key in the sorted key table ``table`` [M], or -1.

    Sentinel queries (invalid rows) miss, even though the table's own
    padding rows hold the sentinel too. Returns int32 of ``queries``' shape.
    """
    m = table.shape[0]
    flat = queries.reshape(-1)
    pos = torch.searchsorted(table, flat)
    hit = table[pos.clamp(max=m - 1)] == flat
    found = (pos < m) & hit & (flat != SENTINEL_KEY)
    return torch.where(found, pos, -1).to(torch.int32).reshape(queries.shape)


def unique_coords(
    coords: torch.Tensor, valid: torch.Tensor, capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate coords [N, 3] into a sorted unique table of fixed capacity.

    Returns ``(ucoords int32[capacity, 3], n_unique, inverse int32[N],
    overflow)``: rows >= n_unique of ``ucoords`` hold the unused-row value;
    ``inverse`` maps each input row to its unique row (-1 for invalid rows
    and overflow victims); ``overflow`` counts unique coords that did not
    fit. On overflow the lexicographically smallest ``capacity`` coords are
    kept (the deterministic drop policy).
    """
    n = coords.shape[0]
    dev = coords.device
    keys = pack_coords(coords, valid)
    skeys, order = torch.sort(keys, stable=True)
    is_valid = skeys != SENTINEL_KEY
    prev = torch.cat([skeys.new_full((1,), SENTINEL_KEY), skeys[:-1]])
    is_new = (skeys != prev) & is_valid
    rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    n_total = is_new.sum()
    n_unique = torch.clamp(n_total, max=capacity)
    overflow = n_total - n_unique
    fits = (rank >= 0) & (rank < capacity) & is_valid

    # each head writes its rank's row; every other key goes to a scratch row
    # past the table, cut off after (no boolean index: that reads its count
    # on the host)
    heads = is_new & fits
    ukeys = torch.full((capacity + 1,), SENTINEL_KEY, dtype=torch.int64, device=dev)
    ukeys[torch.where(heads, rank, capacity)] = skeys
    ucoords = unpack_coords(ukeys[:capacity])
    unused = torch.arange(capacity, device=dev) >= n_unique
    ucoords = torch.where(unused[:, None],
                          device_tensor(_UNUSED_ROW, torch.int32, dev), ucoords)

    inverse = torch.empty(n, dtype=torch.int32, device=dev)
    inverse[order] = torch.where(fits, rank, -1).to(torch.int32)
    return ucoords, n_unique.to(torch.int32), inverse, overflow.to(torch.int32)


def kernel_offsets(kernel_size, centered: bool = True,
                   device=None) -> torch.Tensor:
    """The K = kx*ky*kz integer offsets of a conv kernel, int32 [K, 3].

    dx outer, dz inner. ``centered=True`` gives [-(k//2), k - k//2) per axis
    (the submanifold convention); ``centered=False`` gives [0, k) (the
    non-overlapping downsample convention, k == stride).
    """
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * 3
    axes = [range(-(k // 2), k - k // 2) if centered else range(k)
            for k in kernel_size]
    offs = [(dx, dy, dz) for dx in axes[0] for dy in axes[1] for dz in axes[2]]
    return device_tensor(offs, torch.int32, "cpu" if device is None else device)
