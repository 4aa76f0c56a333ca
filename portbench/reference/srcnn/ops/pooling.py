"""Frozen copy of ``sparse_rcnn_tpu_torch/ops/pooling.py`` at commit 4dd78ef, for the benchmark's
reference (edits: operands through ``precision.q``; the mask read in the
reference's own dtype; no CUDA kernels).

Sparse pooling (port of ``ops/pooling.py``).

Max and average pooling reuse the strided (k == s) rulebook ``down_idx``
[B, 8, M_out]: a coarse site pools over its up to 8 children, one masked
reduce over the gathered rows. Global pooling reduces each scene's live rows.

The children's gather has a backward of its own (:class:`_GatherChildren`):
autograd's backward of ``feats[clamped idx]`` would add every missing child
into row 0, one long run that the card's sorted ``index_put_`` adds
serially. In a strided rulebook each fine row is the child of one coarse
site at one tap, so the backward writes each live entry's cotangent to its
own row and each dead entry's to a slot of its own past the end, cut off
after; nothing accumulates.

Max-pool gradients split a tie evenly among the tied children
(``torch.amax``), as JAX's ``reduce_max`` does: after a ReLU many children
tie at exactly 0.
"""

from __future__ import annotations

import torch

from ..sparse import row_mask


def _flat_rows(feats: torch.Tensor, idx: torch.Tensor):
    """Row of each entry of idx [B, K, M_out] in feats.reshape(B·M, C), and
    whether the entry is a child."""
    b, m = feats.shape[:2]
    live = idx >= 0
    base = torch.arange(b, device=idx.device)[:, None, None] * m
    return torch.where(live, idx.to(torch.int64) + base, 0), live


class _GatherChildren(torch.autograd.Function):
    """feats [B, M, C], idx [B, K, M_out] → rows [B, K, M_out, C], zero where
    idx < 0. The backward scatters to distinct rows only (module docstring)."""

    @staticmethod
    def forward(ctx, feats, idx):
        c = feats.shape[-1]
        flat, live = _flat_rows(feats, idx)
        rows = feats.reshape(-1, c)[flat.reshape(-1)].reshape(*idx.shape, c)
        ctx.save_for_backward(flat, live)
        ctx.feats_shape = feats.shape
        return torch.where(live[..., None], rows, rows.new_zeros(()))

    @staticmethod
    def backward(ctx, g):
        flat, live = ctx.saved_tensors
        b, m, c = ctx.feats_shape
        n = flat.numel()
        spare = b * m + torch.arange(n, device=flat.device).reshape(flat.shape)
        dst = torch.where(live, flat, spare).reshape(-1)
        out = g.new_zeros((b * m + n, c))
        out[dst] = g.reshape(-1, c)
        return out[:b * m].reshape(b, m, c), None


def max_pool(feats: torch.Tensor, down_idx: torch.Tensor) -> torch.Tensor:
    """Batched sparse max pool: feats [B, M, C], down_idx [B, K, M_out] →
    [B, M_out, C]; 0 at a site with no child."""
    live = (down_idx >= 0)[..., None]
    g = torch.where(live, _GatherChildren.apply(feats, down_idx),
                    feats.new_full((), -torch.inf))
    out = torch.amax(g, dim=1)
    return torch.where(live.any(dim=1), out, out.new_zeros(())).to(feats.dtype)


def avg_pool(feats: torch.Tensor, down_idx: torch.Tensor) -> torch.Tensor:
    """Batched sparse average pool over the live children."""
    cnt = (down_idx >= 0).sum(dim=1).to(feats.dtype)
    s = _GatherChildren.apply(feats, down_idx).sum(dim=1)
    return (s / torch.clamp(cnt, min=1.0)[..., None]).to(feats.dtype)


def global_pool(feats: torch.Tensor, nvalid: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """[B, M, C] → [B, C] over live rows."""
    mask = row_mask(nvalid, feats.shape[1])[..., None]
    if mode == "max":
        return torch.amax(torch.where(mask, feats, feats.new_full((), -torch.inf)), dim=1)
    s = torch.sum(feats * mask.to(feats.dtype), dim=1)
    return s / torch.clamp(nvalid[:, None].to(feats.dtype), min=1.0)
