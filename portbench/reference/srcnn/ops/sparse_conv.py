"""Sparse convolution over gather-form rulebooks: the plain paths only.

Frozen copy of ``sparse_rcnn_tpu_torch/ops/sparse_conv.py`` at commit
4dd78ef (``sparse_conv_reference``, ``sparse_conv_wgrad_reference``,
``transpose_rulebooks``, ``SparseConvFunction``, ``sparse_conv``,
``sparse_conv_t``), with the CUDA kernels taken out: the forward, the
dgrad and the wgrad run the plain versions on every device. Each operand
goes through :func:`..precision.q` (the identity in float32 mode).

    out[b, i] = Σ_k (idx[b, k, i] ≥ 0 ? feats[b, idx[b, k, i]] : 0) @ W[k]
"""

from __future__ import annotations

import torch

from . import rulebook as rb
from ..precision import q


def sparse_conv_reference(feats: torch.Tensor, idx: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Masked row gather and one f32 einsum per tap, summed in tap order."""
    out_dtype = torch.promote_types(feats.dtype, weights.dtype)
    feats, weights = q(feats), q(weights)
    b, m_in, cin = feats.shape
    m_out = idx.shape[-1]
    acc = torch.zeros((b, m_out, weights.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    if m_in == 0:
        return acc.to(out_dtype)
    w = weights.to(torch.float32)
    for k in range(weights.shape[0]):
        ix = idx[:, k, :].to(torch.int64)
        hit = (ix >= 0) & (ix < m_in)
        rows = ix.clamp(0, m_in - 1)[..., None].expand(b, m_out, cin)
        g = torch.gather(feats, 1, rows).to(torch.float32) * hit[..., None]
        acc = acc + torch.einsum("bmc,cd->bmd", g, w[k])
    return acc.to(out_dtype)


def sparse_conv_wgrad_reference(feats: torch.Tensor, t_idx: torch.Tensor,
                                g: torch.Tensor) -> torch.Tensor:
    """Per tap, a masked gather of ``g`` by ``t_idx[:, k]`` and one f32
    einsum with ``feats``, summed over scenes and rows → f32 [K, Cin, Cout]."""
    feats, g = q(feats), q(g)
    b, m_in, cin = feats.shape
    m_out, cout = g.shape[1], g.shape[2]
    k_taps = t_idx.shape[1]
    out = torch.zeros((k_taps, cin, cout), dtype=torch.float32, device=feats.device)
    if m_out == 0 or m_in == 0:
        return out
    f = feats.to(torch.float32)
    for k in range(k_taps):
        ix = t_idx[:, k, :].to(torch.int64)
        hit = (ix >= 0) & (ix < m_out)
        rows = ix.clamp(0, m_out - 1)[..., None].expand(b, m_in, cout)
        gk = torch.gather(g, 1, rows).to(torch.float32) * hit[..., None]
        out[k] = torch.einsum("bmc,bmd->cd", f, gk)
    return out


def transpose_rulebooks(idx: torch.Tensor, m_in: int) -> torch.Tensor:
    return torch.stack([rb.transpose_rulebook(ix, m_in) for ix in idx])


class SparseConvFunction(torch.autograd.Function):
    """The gather-form backward: dgrad as the forward on (g, t_idx, Wᵀ),
    wgrad by the plain wgrad; the index arrays get no gradient."""

    @staticmethod
    def forward(ctx, feats, idx, t_idx, weights):
        ctx.save_for_backward(feats, idx, t_idx, weights)
        return sparse_conv_reference(feats, idx, weights)

    @staticmethod
    def backward(ctx, g):
        feats, idx, t_idx, weights = ctx.saved_tensors
        g = g.to(feats.dtype).contiguous()
        if t_idx is None:
            t_idx = transpose_rulebooks(idx, feats.shape[1])
        d_f = d_w = None
        if ctx.needs_input_grad[0]:
            w_t = weights.transpose(1, 2).to(g.dtype).contiguous()
            d_f = sparse_conv_reference(g, t_idx, w_t).to(feats.dtype)
        if ctx.needs_input_grad[3]:
            d_w = sparse_conv_wgrad_reference(feats, t_idx, g).to(weights.dtype)
        return d_f, None, None, d_w


def sparse_conv(feats, idx, weights):
    return SparseConvFunction.apply(feats, idx, None, weights)


def sparse_conv_t(feats, idx, t_idx, weights):
    want = (idx.shape[0], idx.shape[1], feats.shape[1])
    if tuple(t_idx.shape) != want:
        raise ValueError(f"t_idx shape {tuple(t_idx.shape)}, expected {want}")
    return SparseConvFunction.apply(feats, idx, t_idx.contiguous(), weights)
