"""Masked BatchNorm + ReLU, the backbone's norm, as one autograd Function
over the hand-written kernels of ``csrc/batch_norm.cu``.

    training:  count = max(Σ m, 1);  mean = Σ x·m / count;
               var = Σ (x − mean)²·m / count             (f32, biased)
    both:      rstd = rsqrt(var + ε);  inv = (rstd · scale) in the compute type
               y = relu(((x − mean) · inv + bias) · m)    (each operation rounded to it)
    backward:  g' = g·[z > 0]·m (z the ReLU's input), x̂ = (x − mean)·rstd
               dx = m · scale·rstd/n · (n·g' − Σg' − x̂·Σg'x̂)   (training; f32, cast once)
               dx = m · scale·rstd · g'                        (running statistics)
               dscale = Σ g'·x̂,  dbias = Σ g'

It replaces no TPU kernel: the JAX package's BatchNorm is plain XLA. The
port ran it as an eager chain (``models/layers.py::MaskedBatchNorm.normalize``
and the ReLU after it): about 66 launches a norm a train step, some 146
bytes an entry with the f32 temporaries of the whole activation, and on an
H100 154 ms of a config-3 train step (44 norms, 36 recomputed) and 78 ms of
a config-2 one: the largest block of device time in ``config3-train`` and
of host launches in the other train cells. Bytes bound it; the kernels
read each live entry once a pass (8 B an entry forward in bf16, 10 B
backward) and skip the dead rows.

On CUDA tensors :func:`masked_bn_relu` runs the kernels (library
``native.libraries.BATCH_NORM``, built with ``-fmad=false``), counted as
the roles ``bn_stats`` (each pass of the statistics: two a training
forward), ``bn_apply`` (the vectors and the normalisation: one a forward)
and ``bn_grad`` (the gradient's sums and the input's gradient: two a
backward). The vectors (count, mean, var, the running statistics' update,
rstd, inv) repeat the chain's torch operations on [C] one rounding each,
so given the same sums they, the running statistics and the output are the
chain's bit for bit. The statistics and the gradient's sums are fixed-order f32 sums
(per-block partials, then a finish in a fixed order, no atomics), so a
recomputed forward gives the first run's bits. Under data parallel
(:mod:`..parallel.context`) the two statistics' sums are all-reduced where
the chain all-reduced them, and the gradient's sums once in the backward
for the input's gradient (the parameters' gradients stay this rank's, as
the chain's are). Every other device runs the plain chain; a CUDA tensor
gets the kernels or an exception.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..native import libraries as NL
from ..parallel import context as DPC

ROWS_PER_BLOCK = 128          # the least rows a partial block of the sums takes
MAX_BLOCKS = 1024             # partial blocks of the sums


def sum_blocks(rows: int) -> int:
    """The partial blocks of a sum over ``rows`` rows: a function of the
    rows alone, so the order of the sums is too."""
    return max(1, min(MAX_BLOCKS, -(-rows // ROWS_PER_BLOCK)))


def _lib():
    return NL.load(NL.BATCH_NORM)


def _check(role: str, x: torch.Tensor, mask: torch.Tensor, floats: dict = {},
           like_x: dict = {}) -> int:
    """x [rows, C] f32 or bf16, mask bool [rows], ``floats`` (name →
    (tensor, entries)) f32 vectors and ``like_x`` of x's shape and type
    (``vecs``: [3 C]), all on one CUDA device and contiguous; returns x's
    dtype code."""
    NL.check_tensors(role, {"x": x, "mask": mask, **{n: t for n, (t, _) in floats.items()},
                            **like_x}, {})
    if x.dim() != 2 or mask.shape != x.shape[:1]:
        raise ValueError(f"{role} kernel takes x [rows, C] and mask [rows], got "
                         f"{tuple(x.shape)} and {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{role} kernel takes a bool mask, got {mask.dtype}")
    code = NL.dtype_code(role, ("x", "x"), x, x)
    c = x.shape[1]
    for n, t in like_x.items():
        want = (3 * c,) if n == "vecs" else x.shape
        if t.shape != want or t.dtype != x.dtype:
            raise TypeError(f"{role} kernel takes {n} {list(want)} of x's type, got "
                            f"{t.dtype} {tuple(t.shape)}")
    for n, (t, want) in floats.items():
        if t.dtype != torch.float32 or t.shape != (want,):
            raise TypeError(f"{role} kernel takes {n} [{want}] of float32, got {t.dtype} "
                            f"{tuple(t.shape)}")
    return code


def bn_stats_kernel(x: torch.Tensor, mask: torch.Tensor,
                    s1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bn_stats``: without ``s1`` the sums s1 = [Σ_live x (C), Σ m] (C + 1
    floats), with them Σ_live (x − mean)² (C floats), mean = s1[:C] /
    max(s1[C], 1); f32, in the kernels' fixed order."""
    rows, c = x.shape
    code = _check("bn_stats", x, mask, {} if s1 is None else {"s1": (s1, c + 1)})
    width = c + (s1 is None)
    blocks = sum_blocks(rows)
    partials = torch.empty(blocks * width, dtype=torch.float32, device=x.device)
    out = torch.empty(width, dtype=torch.float32, device=x.device)
    NL.launch("bn_stats", _lib().bn_stats, x.device, x.data_ptr(), mask.data_ptr(),
              None if s1 is None else s1.data_ptr(), rows, c, code, blocks,
              partials.data_ptr(), out.data_ptr())
    return out


def bn_apply_kernel(x, mask, scale, bias, running_mean, running_var, momentum: float,
                    epsilon: float, s1=None, s2=None, update: bool = False) -> tuple:
    """``bn_apply``: the vectors from the sums ``s1``, ``s2`` (None: the
    running statistics; moved when ``update``), then relu(((x − mean) · inv
    + bias) · m). Returns (y, stats = [mean, rstd, n] f32, vecs = [mean,
    inv, bias] in x's type), the last two for the backward."""
    c = x.shape[1]
    sums = {} if s1 is None else {"s1": (s1, c + 1), "s2": (s2, c)}
    code = _check("bn_apply", x, mask, {"scale": (scale, c), "bias": (bias, c),
                                        "rmean": (running_mean, c), "rvar": (running_var, c),
                                        **sums})
    if update and s1 is None:
        raise ValueError("bn_apply kernel: the running statistics move only with the sums")
    y = torch.empty_like(x)
    stats = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    vecs = torch.empty(3 * c, dtype=x.dtype, device=x.device)
    NL.launch("bn_apply", _lib().bn_apply, x.device, x.data_ptr(), mask.data_ptr(),
              None if s1 is None else s1.data_ptr(), None if s2 is None else s2.data_ptr(),
              scale.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
              running_var.data_ptr(), x.shape[0], c, code, momentum, 1 - momentum, epsilon,
              int(update), y.data_ptr(), stats.data_ptr(), vecs.data_ptr())
    return y, stats, vecs


def bn_grad_sums_kernel(x, mask, g, stats, vecs) -> torch.Tensor:
    """``bn_grad``'s sums: [Σ_live g' (C), Σ_live g'·x̂ (C)] f32, from
    ``bn_apply``'s stats and vecs."""
    rows, c = x.shape
    code = _check("bn_grad", x, mask, {"stats": (stats, 2 * c + 1)}, {"g": g, "vecs": vecs})
    blocks = sum_blocks(rows)
    partials = torch.empty(blocks * 2 * c, dtype=torch.float32, device=x.device)
    out = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    NL.launch("bn_grad", _lib().bn_grad_sums, x.device, x.data_ptr(), mask.data_ptr(),
              g.data_ptr(), stats.data_ptr(), vecs.data_ptr(), rows, c, code, blocks,
              partials.data_ptr(), out.data_ptr())
    return out


def bn_grad_input_kernel(x, mask, g, stats, vecs, scale,
                         sums: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bn_grad``'s input gradient dx in x's type; ``sums`` (the global
    [Σg', Σg'x̂]) for the batch statistics, None for the running ones."""
    c = x.shape[1]
    code = _check("bn_grad", x, mask, {"stats": (stats, 2 * c + 1), "scale": (scale, c),
                                       **({} if sums is None else {"sums": (sums, 2 * c)})},
                  {"g": g, "vecs": vecs})
    dx = torch.empty_like(x)
    NL.launch("bn_grad", _lib().bn_grad_input, x.device, x.data_ptr(), mask.data_ptr(),
              g.data_ptr(), stats.data_ptr(), vecs.data_ptr(), scale.data_ptr(),
              None if sums is None else sums.data_ptr(), x.shape[0], c, code, dx.data_ptr())
    return dx


# The kernels' plain versions, over x [rows, C] and mask [rows] (the CPU
# tests and the card's hold the kernels to them; the norm itself runs the
# chain, ``models/layers.py::MaskedBatchNorm.normalize``, on other devices).


def bn_stats_reference(x, mask, s1=None) -> torch.Tensor:
    """:func:`bn_stats_kernel` as the chain sums, in torch's order."""
    m, f = mask[:, None].to(torch.float32), x.to(torch.float32)
    if s1 is None:
        return torch.cat([(f * m).sum(0), m.sum()[None]])
    mean = s1[:-1] / torch.clamp(s1[-1], min=1.0)
    return (torch.square(f - mean) * m).sum(0)


def bn_apply_reference(x, mask, scale, bias, running_mean, running_var, momentum: float,
                       epsilon: float, s1=None, s2=None, update: bool = False) -> tuple:
    """:func:`bn_apply_kernel` as the chain's operations."""
    c = x.shape[1]
    if s1 is None:
        mean, var, count = running_mean, running_var, torch.zeros_like(running_mean[:1])
    else:
        count = torch.clamp(s1[-1], min=1.0)
        mean = s1[:-1] / count
        var = s2 / count
        if update:
            running_mean.mul_(momentum).add_((1 - momentum) * mean)
            running_var.mul_(momentum).add_((1 - momentum) * var)
        count = count.reshape(1)
    rstd = torch.rsqrt(var + epsilon)
    vecs = torch.cat([mean.to(x.dtype), (rstd * scale).to(x.dtype), bias.to(x.dtype)])
    y = torch.relu(((x - vecs[:c]) * vecs[c:2 * c] + vecs[2 * c:]) * mask[:, None].to(x.dtype))
    return y, torch.cat([mean, rstd, count]), vecs


def _grad_terms(x, mask, g, stats, vecs) -> tuple:
    """g' = g·[z > 0]·m and x̂ = (x − mean)·rstd, f32."""
    c = x.shape[1]
    z = ((x - vecs[:c]) * vecs[c:2 * c] + vecs[2 * c:]) * mask[:, None].to(x.dtype)
    xh = (x.to(torch.float32) - stats[:c]) * stats[c:2 * c]
    return torch.where(z > 0, g.to(torch.float32), 0.0), xh


def bn_grad_sums_reference(x, mask, g, stats, vecs) -> torch.Tensor:
    """:func:`bn_grad_sums_kernel`: [Σ g', Σ g'·x̂], f32 in torch's order."""
    gp, xh = _grad_terms(x, mask, g, stats, vecs)
    return torch.cat([gp.sum(0), (gp * xh).sum(0)])


def bn_grad_input_reference(x, mask, g, stats, vecs, scale, sums=None) -> torch.Tensor:
    """:func:`bn_grad_input_kernel`: the backward's formula in f32, cast
    once to x's type; with :func:`bn_grad_sums_reference` the oracle that
    the CPU tests hold to autograd through the chain."""
    c = x.shape[1]
    gp, xh = _grad_terms(x, mask, g, stats, vecs)
    rstd = stats[c:2 * c]
    if sums is None:
        dx = scale * rstd * gp
    else:
        n = stats[2 * c]
        dx = scale * rstd / n * (n * gp - sums[:c] - xh * sums[c:])
    return torch.where(mask[:, None], dx, 0.0).to(x.dtype)


class _MaskedBNReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, scale, bias, running_mean, running_var, momentum, epsilon,
                training, update):
        c = x.shape[-1]
        xf, mf = x.reshape(-1, c), mask.reshape(-1)
        world = DPC.current()
        s1 = s2 = None
        if training:
            s1 = bn_stats_kernel(xf, mf)
            if world is not None:
                DPC.all_reduce_(s1, world)
            s2 = bn_stats_kernel(xf, mf, s1)
            if world is not None:
                DPC.all_reduce_(s2, world)
        y, stats, vecs = bn_apply_kernel(xf, mf, scale, bias, running_mean, running_var,
                                         momentum, epsilon, s1, s2, update)
        ctx.world, ctx.training = world, training
        ctx.save_for_backward(xf, mf, stats, vecs, scale)
        return y.view_as(x)

    @staticmethod
    def backward(ctx, g):
        xf, mf, stats, vecs, scale = ctx.saved_tensors
        gf = g.contiguous().view(xf.shape)
        sums = bn_grad_sums_kernel(xf, mf, gf, stats, vecs)
        dx = None
        if ctx.needs_input_grad[0]:
            glob = None
            if ctx.training:
                glob = sums
                if ctx.world is not None:
                    glob = DPC.all_reduce_(sums.clone(), ctx.world)
            dx = bn_grad_input_kernel(xf, mf, gf, stats, vecs, scale, glob).view_as(g)
        c = xf.shape[1]
        return dx, None, sums[c:], sums[:c], None, None, None, None, None, None


def masked_bn_relu(x: torch.Tensor, mask: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                   momentum: float, epsilon: float, training: bool,
                   update: bool) -> torch.Tensor:
    """relu(masked BN(x)) on the card: x [..., C] in the compute type, mask
    bool [...]; ``training`` normalises with the batch statistics (moving
    the running ones when ``update``), else with the running ones. Raises
    for what the kernels do not take."""
    if not (x.is_cuda and mask.is_cuda):
        raise ValueError(f"masked_bn_relu runs on CUDA tensors, got {x.device}, {mask.device}")
    return _MaskedBNReLU.apply(x.contiguous(), mask.contiguous(), scale, bias, running_mean,
                               running_var, momentum, epsilon, training, update)
