"""Per-RoI mask + classification heads (port of ``models/heads.py``).

The RoI crop yields a dense [B, P, D, D, D, C] block (the JAX layout,
channels last, kept at the public functions). The heads run dense 3D convs
on it: torch's NCDHW inside, NDHWC outside. The mask branch upsamples D →
2D with a transposed conv; the class branch pools and classifies
(background = logit index ``num_classes``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import RoIConfig
from ..ops import index_grad
from .layers import MLP


def _conv3d(conv: nn.Conv3d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` applied in ``dtype`` (flax's ``nn.Conv(dtype=...)``)."""
    return nn.functional.conv3d(x.to(dtype), conv.weight.to(dtype),
                                conv.bias.to(dtype), padding=conv.padding)


class RoIHead(nn.Module):
    """[B, P, D, D, D, C] → (cls_logits [B, P, K+1], mask_logits [B, P, 2D, 2D, 2D])."""

    def __init__(self, in_channels: int, cfg: RoIConfig, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h = cfg.hidden
        self.dtype = dtype
        self.num_classes = num_classes
        # flax nn.Conv defaults: SAME padding, bias
        self.conv1 = nn.Conv3d(in_channels, h, 3, padding=1)
        self.conv2 = nn.Conv3d(h, h, 3, padding=1)
        self.cls = MLP(h, (h, num_classes + 1), dtype=torch.float32)
        self.up = nn.ConvTranspose3d(h, h, 2, stride=2)
        self.mask_pred = nn.Conv3d(h, 1, 1)

    def forward(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each scene's RoIs go through the head alone: cuDNN and cuBLAS
        pick their algorithms, and with them the order of a sum, by the
        shapes they are given, so a call over the whole batch would make a
        scene's logits depend on the other scenes in it."""
        outs = [self._scene(x) for x in roi_feats]
        return torch.stack([c for c, _ in outs]), torch.stack([m for _, m in outs])

    def _scene(self, roi_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[P, D, D, D, C] → (cls_logits [P, K+1], mask_logits [P, 2D, 2D, 2D])."""
        p, d = roi_feats.shape[:2]
        cd = self.dtype
        x = roi_feats.permute(0, 4, 1, 2, 3)
        x = torch.relu(_conv3d(self.conv1, x, cd))
        x = torch.relu(_conv3d(self.conv2, x, cd))

        pooled = x.mean(dim=(2, 3, 4))                            # [P, h]
        cls_logits = self.cls(pooled)

        up = self.up
        m = nn.functional.conv_transpose3d(x.to(cd), up.weight.to(cd), up.bias.to(cd),
                                           stride=2)
        m = _conv3d(self.mask_pred, torch.relu(m), torch.float32)
        dm = 2 * d
        return cls_logits, m.reshape(p, dm, dm, dm)


def mask_cells(boxes: torch.Tensor, positions: torch.Tensor, g: int):
    """Each position's nearest cell in each box's grid of g³ and whether it
    lies inside the box: boxes [P, 6], positions [N, 3] → (cell int32
    [P, N], the flat index into the box's grid, a position outside clamped
    onto the border cells; inside bool [P, N])."""
    cells, inside = [], None
    for a in range(3):
        lo = boxes[:, a:a + 1]
        hi = boxes[:, 3 + a:4 + a]
        rel = (positions[None, :, a] - lo) / torch.clamp(hi - lo, min=1e-6)
        in_a = (rel >= 0.0) & (rel < 1.0)
        inside = in_a if inside is None else (inside & in_a)
        # clamp before the int cast: XLA saturates an out-of-range
        # float→int32 conversion, C++ leaves it undefined
        cell = torch.clamp(rel * g, -1.0, float(g)).to(torch.int32)
        cells.append(cell.clamp(0, g - 1))
    cx, cy, cz = cells
    return (cx * g + cy) * g + cz, inside


def sample_mask_at_positions(mask_logits: torch.Tensor, boxes: torch.Tensor,
                             positions: torch.Tensor, keep: Optional[torch.Tensor] = None):
    """Evaluate each RoI's mask grid at scene positions (one scene).

    mask_logits [P, G, G, G], boxes [P, 6], positions [N, 3] → (logits
    [P, N], inside bool[P, N]); nearest-cell sampling in the box-normalised
    grid (:func:`mask_cells`). The logits are read in bf16, as the JAX
    package reads them (its row gather casts to bf16 even in f32 configs),
    then returned in the mask logits' dtype. The read is
    :func:`.index_grad.mask_read`, whose backward on the card is the
    ``mask_read_grad`` kernel; ``keep`` (bool [P, N], None: every entry)
    is its contract: the caller's cotangent is exactly 0 wherever ``keep``
    is false.
    """
    cell, inside = mask_cells(boxes, positions, mask_logits.shape[-1])
    logits = index_grad.mask_read(mask_logits.to(torch.bfloat16), cell, keep)
    return logits.to(mask_logits.dtype), inside


class SemanticHead(nn.Module):
    """Auxiliary per-voxel semantic logits on the finest decoder features."""

    def __init__(self, in_channels: int, num_classes: int, hidden: int = 64):
        super().__init__()
        self.mlp = MLP(in_channels, (hidden, num_classes + 1), dtype=torch.float32)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.mlp(feats)
