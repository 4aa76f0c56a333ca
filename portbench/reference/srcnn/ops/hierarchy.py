"""Frozen copy of ``sparse_rcnn_tpu_torch/ops/hierarchy.py`` at commit 4dd78ef, for the benchmark's
reference (edits: operands through ``precision.q``; the mask read in the
reference's own dtype; no CUDA kernels).

Multi-scale site sets and rulebooks for a sparse UNet (port of
``ops/hierarchy.py``).

The whole hierarchy is built once per forward pass from the input site set;
every layer on a scale shares its tables. The JAX package's ``map_scenes``
becomes a plain loop over the batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..sparse import SparseTensor, row_mask
from . import rulebook as rb


@dataclasses.dataclass(frozen=True)
class ScaleSet:
    """Site set + rulebooks at one scale of the hierarchy.

    coords   int32[B, M_s, 3] (sorted per scene, sentinel padding)
    nvalid   int32[B]
    subm_idx int32[B, K, M_s] submanifold rulebook at this scale (None at
             the scales that the dense tail runs)
    down_idx int32[B, 8, M_{s+1}] strided rulebook into the next-coarser
             scale (None at the coarsest scale)
    up_idx   int32[B, 8, M_s] inverse rulebook from the next-coarser scale
             back to this one (None at the coarsest scale)
    """

    coords: torch.Tensor
    nvalid: torch.Tensor
    subm_idx: Optional[torch.Tensor] = None
    down_idx: Optional[torch.Tensor] = None
    up_idx: Optional[torch.Tensor] = None

    @property
    def row_mask(self) -> torch.Tensor:
        return row_mask(self.nvalid, self.coords.shape[1])


def _per_scene(fn, *args):
    """Apply ``fn`` to each scene of ``args`` and stack each output."""
    outs = [fn(*scene) for scene in zip(*args)]
    return tuple(torch.stack(x) for x in zip(*outs))


def build_hierarchy(st: SparseTensor, num_scales: int,
                    capacities: Sequence[int], kernel_size: int = 3,
                    subm_scales: Optional[int] = None):
    """Build all site sets and rulebooks for a ``num_scales``-deep sparse UNet.

    ``subm_scales``: rulebooks only for scales below it (None = all). The
    scales that the dense tail runs need their site sets (to gather its
    outputs back) but no rulebooks; the last sparse scale still gets its
    down and up rulebooks, into the tail's first scale.

    Returns (scales: List[ScaleSet], overflow int32[B, num_scales-1] — the
    coarse sites dropped at each downsample step).
    """
    if len(capacities) < num_scales:
        raise ValueError(f"{len(capacities)} capacities for {num_scales} scales")
    coords, nvalid = st.coords, st.nvalid
    scales: List[ScaleSet] = []
    overflows = []
    n_subm = num_scales if subm_scales is None else subm_scales
    for s in range(num_scales):
        subm = None
        if s < n_subm:
            (subm,) = _per_scene(
                lambda c, n: (rb.submanifold_rulebook(c, n, kernel_size),),
                coords, nvalid)
        if s < num_scales - 1:
            cap_next = capacities[s + 1]
            if s < n_subm:
                oc, on, ovf, down, up = _per_scene(
                    lambda c, n: rb.downsample_with_rulebooks(c, n, 2, cap_next),
                    coords, nvalid)
            else:
                oc, on, ovf = _per_scene(
                    lambda c, n: rb.downsample_sites(c, n, 2, cap_next),
                    coords, nvalid)
                down = up = None
            overflows.append(ovf)
            scales.append(ScaleSet(coords, nvalid, subm, down, up))
            coords, nvalid = oc, on
        else:
            scales.append(ScaleSet(coords, nvalid, subm))
    if overflows:
        overflow = torch.stack(overflows, dim=-1)
    else:
        overflow = torch.zeros((st.batch_size, 0), dtype=torch.int32,
                               device=st.coords.device)
    return scales, overflow
