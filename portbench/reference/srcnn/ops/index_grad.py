"""The RoI crop's corner sum and the mask read as plain autograd composites.

Stands in for ``sparse_rcnn_tpu_torch/ops/index_grad.py`` at commit
4dd78ef: the same two reads, with autograd's own backward (an accumulating
``index_put_``) instead of the hand-written kernels and their maps.
"""

from __future__ import annotations

from typing import Optional

import torch


def corner_gather(feats: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_c feats[idx[c]] · w[c] over the 8 corners (−1 = none): feats [M, C],
    idx int32 [8, ...], w [8, ...] → [..., C] in feats' dtype."""
    m = feats.shape[0]
    safe = idx.clamp(0, m - 1).to(torch.int64)
    val = feats[safe] * (idx >= 0)[..., None].to(feats.dtype)
    return torch.sum(val * w[..., None].to(feats.dtype), dim=0)


def mask_read(mask: torch.Tensor, cell: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``mask[p, cell[p, n]]``: mask [P, ...] at cell int32 [P, N]."""
    prow = torch.arange(mask.shape[0], device=mask.device)[:, None]
    return mask.reshape(mask.shape[0], -1)[prow, cell.to(torch.int64)]
