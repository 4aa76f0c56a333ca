"""Sparse convolution over gather-form rulebooks, forward and backward
(port of ``ops/sparse_conv.py``).

    out[b, i] = Σ_k (idx[b, k, i] ≥ 0 ? feats[b, idx[b, k, i]] : 0) @ W[k]

Shapes: feats [B, M_in, Cin], idx int32[B, K, M_out] (-1 = no neighbour),
W [K, Cin, Cout] → out [B, M_out, Cout], summed in float32 and returned in
promote(feats, W).

The backward (:class:`SparseConvFunction`, the JAX package's custom VJP
``_bwd``/``_bwd_t``) is scatter-free. With ``t_idx[k]`` the per-tap
transpose of ``idx[k]`` (``t_idx[k, j] = i`` iff ``idx[k, i] = j``):

    d_feats[j] = Σ_k g[t_idx[k, j]] @ W[k]ᵀ       (dgrad)
    d_W[k]     = Σ_j feats[j]ᵀ ⊗ g[t_idx[k, j]]   (wgrad)

On a CUDA tensor these run on the hand-written kernels of
``csrc/sparse_conv.cu`` (the library ``native.libraries.SPARSE_CONV``): the fused
gather-GEMM, the port of the TPU kernel
``sparse_rcnn_tpu/ops/pallas_conv.py::tap_accumulate_matmul``, for the
forward and (on g, t_idx, Wᵀ) for the dgrad; a two-pass deterministic
kernel for the wgrad. On a CPU tensor they run the plain versions
:func:`sparse_conv_reference` and :func:`sparse_conv_wgrad_reference`.
There is no fallback: a CUDA tensor gets the kernels or an exception.
Their launches count as the roles ``forward``, ``dgrad`` and ``wgrad``.
"""

from __future__ import annotations

import torch

from . import rulebook as rb
from ..native import libraries as NL

# wgrad row chunks: at least 256 rows each, at most 256 chunks per scene
# (the partials buffer is K · chunks · Cin · Cout f32), 32-row aligned
_WGRAD_MIN_ROWS = 256
_WGRAD_MAX_CHUNKS = 256


def sparse_conv_reference(feats: torch.Tensor, idx: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """The plain version: masked row gather and one f32 einsum per tap,
    summed in tap order (as ``gather_matmul_conv`` in the JAX package)."""
    out_dtype = torch.promote_types(feats.dtype, weights.dtype)
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
    """The plain wgrad: per tap, a masked gather of ``g`` by ``t_idx[:, k]``
    and one f32 einsum with ``feats``, summed over scenes and rows.
    feats [B, M_in, Cin], t_idx [B, K, M_in], g [B, M_out, Cout] →
    f32 [K, Cin, Cout]."""
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


def conv_kernel(feats: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
                role: str = "forward") -> torch.Tensor:
    """The fused gather-GEMM kernel, its launch counted as ``role``: the
    forward, or the dgrad (the same kernel on g, t_idx and Wᵀ)."""
    if feats.dim() != 3 or idx.dim() != 3 or weights.dim() != 3:
        raise ValueError("sparse_conv wants feats [B,M_in,Cin], idx [B,K,M_out], "
                         f"W [K,Cin,Cout]; got {tuple(feats.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(weights.shape)}")
    b, m_in, cin = feats.shape
    k, wcin, cout = weights.shape
    m_out = idx.shape[-1]
    if idx.shape[0] != b or idx.shape[1] != k or wcin != cin:
        raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, idx "
                         f"{tuple(idx.shape)}, W {tuple(weights.shape)}")
    NL.check_tensors(role, {"feats": feats, "W": weights}, {"idx": idx})
    dtype = NL.dtype_code(role, ("feats", "W"), feats, weights)
    out = torch.empty((b, m_out, cout), dtype=feats.dtype, device=feats.device)
    if b == 0 or m_out == 0 or cout == 0:
        return out
    NL.launch(role, NL.load(NL.SPARSE_CONV).sparse_conv_forward, feats.device,
              feats.data_ptr(), idx.data_ptr(), weights.data_ptr(), out.data_ptr(),
              b, m_in, m_out, k, cin, cout, dtype)
    return out


def wgrad_chunks(m_in: int) -> tuple:
    """(rows per chunk, chunks per scene) of the wgrad kernel's first pass:
    a function of the shape alone, so the sum order never changes."""
    n = max(1, min(_WGRAD_MAX_CHUNKS, -(-m_in // _WGRAD_MIN_ROWS)))
    per_chunk = -(-m_in // n)
    rows = -(-per_chunk // 32) * 32
    return rows, -(-m_in // rows)


def wgrad_kernel(feats: torch.Tensor, t_idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The two-pass deterministic wgrad kernel (one launch of role
    ``wgrad``): feats [B, M_in, Cin], t_idx int32 [B, K, M_in], g
    [B, M_out, Cout] → d_W f32 [K, Cin, Cout]."""
    if feats.dim() != 3 or t_idx.dim() != 3 or g.dim() != 3:
        raise ValueError("sparse_conv wgrad wants feats [B,M_in,Cin], t_idx "
                         f"[B,K,M_in], g [B,M_out,Cout]; got {tuple(feats.shape)}, "
                         f"{tuple(t_idx.shape)}, {tuple(g.shape)}")
    if (t_idx.shape[0] != feats.shape[0] or g.shape[0] != feats.shape[0]
            or t_idx.shape[2] != feats.shape[1] or t_idx.shape[1] > 65535):
        raise ValueError(f"shape mismatch: feats {tuple(feats.shape)}, t_idx "
                         f"{tuple(t_idx.shape)}, g {tuple(g.shape)}")
    NL.check_tensors("wgrad", {"feats": feats, "g": g}, {"t_idx": t_idx})
    dtype = NL.dtype_code("wgrad", ("feats", "g"), feats, g)
    b, m_in, cin = feats.shape
    m_out, cout = g.shape[1], g.shape[2]
    k = t_idx.shape[1]
    if b == 0 or m_in == 0 or m_out == 0:
        return torch.zeros((k, cin, cout), dtype=torch.float32, device=feats.device)
    rows, n_chunks = wgrad_chunks(m_in)
    partials = torch.empty((k, b * n_chunks, cin, cout), dtype=torch.float32,
                           device=feats.device)
    out = torch.empty((k, cin, cout), dtype=torch.float32, device=feats.device)
    NL.launch("wgrad", NL.load(NL.SPARSE_CONV).sparse_conv_wgrad, feats.device,
              feats.data_ptr(), t_idx.data_ptr(), g.data_ptr(), partials.data_ptr(),
              out.data_ptr(), b, m_in, m_out, k, cin, cout, rows, n_chunks, dtype)
    return out


def conv_forward(feats, idx, weights):
    """The forward: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if feats.device.type == "cpu":
        return sparse_conv_reference(feats, idx, weights)
    return conv_kernel(feats, idx, weights)


def conv_dgrad(g, t_idx, weights):
    """d_feats [B, M_in, Cin] in g's dtype from the cotangent g [B, M_out, Cout]:
    the forward's gather-GEMM on (g, t_idx, Wᵀ)."""
    w_t = weights.transpose(1, 2).to(g.dtype).contiguous()      # [K, Cout, Cin]
    if g.device.type == "cpu":
        return sparse_conv_reference(g, t_idx, w_t)
    return conv_kernel(g, t_idx, w_t, "dgrad")


def conv_wgrad(feats, t_idx, g):
    """d_W f32 [K, Cin, Cout]: the wgrad kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if feats.device.type == "cpu":
        return sparse_conv_wgrad_reference(feats, t_idx, g)
    return wgrad_kernel(feats, t_idx, g)


def transpose_rulebooks(idx: torch.Tensor, m_in: int) -> torch.Tensor:
    """Per-scene :func:`.rulebook.transpose_rulebook`: [B, K, M_out] → [B, K, M_in]."""
    return torch.stack([rb.transpose_rulebook(ix, m_in) for ix in idx])


class SparseConvFunction(torch.autograd.Function):
    """Sparse conv with the gather-form backward of the JAX package's
    ``sparse_conv``/``sparse_conv_t`` custom VJP: the cotangent is cast to
    the feats dtype; the dgrad (skipped when the feats need no gradient) is
    returned in the feats dtype; the wgrad is summed in f32 and returned in
    the weights' dtype; the index arrays get no gradient. Without a
    ``t_idx`` the backward transposes ``idx`` itself."""

    @staticmethod
    def forward(ctx, feats, idx, t_idx, weights):
        ctx.save_for_backward(feats, idx, t_idx, weights)
        return conv_forward(feats, idx, weights)

    @staticmethod
    def backward(ctx, g):
        feats, idx, t_idx, weights = ctx.saved_tensors
        g = g.to(feats.dtype).contiguous()
        if t_idx is None:
            t_idx = transpose_rulebooks(idx, feats.shape[1])
        d_f = d_w = None
        if ctx.needs_input_grad[0]:
            d_f = conv_dgrad(g, t_idx, weights).to(feats.dtype)
        if ctx.needs_input_grad[3]:
            d_w = conv_wgrad(feats, t_idx, g).to(weights.dtype)
        return d_f, None, None, d_w


def sparse_conv(feats: torch.Tensor, idx: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Sparse conv, differentiable in feats and W: the CUDA kernels on a CUDA
    tensor, the plain versions on a CPU tensor."""
    return SparseConvFunction.apply(feats, idx, None, weights)


def sparse_conv_t(feats: torch.Tensor, idx: torch.Tensor, t_idx: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Sparse conv with the caller's transposed rulebook ``t_idx``
    [B, K, M_in] (t_idx[k] is the per-tap transpose of idx[k]; the
    rulebook dualities give it for free: ``subm_idx`` flipped along K for
    a submanifold conv, ``up_idx`` for a down conv and ``down_idx`` for an
    up conv). The forward equals :func:`sparse_conv`; the backward's dgrad
    and wgrad gather through ``t_idx`` instead of transposing ``idx``.
    """
    want = (idx.shape[0], idx.shape[1], feats.shape[1])
    if tuple(t_idx.shape) != want:
        raise ValueError(f"t_idx shape {tuple(t_idx.shape)}, expected {want}")
    return SparseConvFunction.apply(feats, idx, t_idx.contiguous(), weights)
