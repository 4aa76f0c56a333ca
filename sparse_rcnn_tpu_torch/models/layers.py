"""Sparse layer modules over the gather-form conv (port of ``models/layers.py``).

Each module holds only parameters; rulebooks come in as arguments (built
once per forward by :mod:`..ops.hierarchy`). Parameter and buffer names
follow the flax tree of the JAX package (``kernel``, ``scale``, ``mean`` …)
so that :mod:`.transfer` maps one onto the other by path.

Row masking invariant: padding rows carry zero features in and out of every
layer. Convs keep it by construction (their rulebook entries are -1);
BN re-masks explicitly.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import batch_norm as BN
from ..ops import sparse_conv as sc
from ..parallel import context as DPC
from ..utils.profiling import count, span

# True while a rematerialised block recomputes its forward in the backward
# (:func:`remat`): MaskedBatchNorm then leaves its running statistics alone
_RECOMPUTING = False


class SparseConv(nn.Module):
    """Generic sparse conv: feats [B,M_in,Cin] × idx [B,K,M_out] → [B,M_out,Cout].

    Serves submanifold, strided-downsample and inverse conv alike — the
    rulebook determines the geometry.
    """

    def __init__(self, in_features: int, features: int, num_taps: int,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(num_taps, in_features, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, feats, idx, t_idx=None):
        x = feats.to(self.dtype).contiguous()
        w = self.kernel.to(self.dtype).contiguous()
        idx = idx.contiguous()
        if t_idx is None:
            out = sc.sparse_conv(x, idx, w)
        else:
            out = sc.sparse_conv_t(x, idx, t_idx, w)
        if self.bias is not None:
            # bias only on live rows (rows with any rulebook hit)
            live = (idx >= 0).any(dim=1)
            out = out + self.bias.to(out.dtype) * live[..., None].to(out.dtype)
        return out


class SubMConv3d(nn.Module):
    """Submanifold conv: output sites == input sites (kernel k, odd)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = SparseConv(in_features, features, kernel_size ** 3,
                               use_bias, dtype)

    def forward(self, feats, subm_idx):
        # reversing the centered-offset enumeration negates every offset,
        # which IS the transposed rulebook
        return self.conv(feats, subm_idx, torch.flip(subm_idx, dims=(1,)))


class MaskedBatchNorm(nn.Module):
    """BatchNorm over live rows only (padding rows excluded from statistics),
    then the ReLU that follows every norm of the backbone: ``relu(BN(x))``.

    Training mode (``self.training``) normalises with the masked f32 batch
    statistics (biased variance) and updates the running ones as flax does:
    ``ra = momentum * ra + (1 - momentum) * batch`` — torch's ``momentum``
    means the reverse. Eval mode uses the running statistics. Statistics are
    f32; the normalisation runs in the compute dtype and is re-masked. The
    forward that :func:`remat` recomputes in the backward moves no running
    statistic (flax's ``nn.remat`` updates them once per step).

    Under data parallel (:func:`..parallel.context.shard_context`) the
    statistics are the global batch's, as GSPMD gives JAX's: one
    differentiable all-reduce of ``Σ f·m`` and ``Σ m`` gives the mean, a
    second one of ``Σ (f − mean)²·m`` the variance. Every rank then holds
    the same statistics and moves its running ones identically.

    On CUDA tensors the norm and its ReLU are the hand-written kernels of
    :mod:`..ops.batch_norm` (one autograd Function, the same arithmetic);
    on every other device :meth:`normalize`, the eager chain, and
    ``torch.relu``.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("mean", torch.empty(num_features))
        self.register_buffer("var", torch.empty(num_features))

    def forward(self, feats, mask):
        if feats.device.type == "cuda":
            return self.fused(feats, mask)
        return torch.relu(self.normalize(feats, mask))

    def fused(self, feats, mask):
        """The norm and its ReLU as the kernels' autograd Function."""
        if feats.dtype != self.dtype:
            raise TypeError(f"MaskedBatchNorm of {self.dtype} takes features of that type on "
                            f"the card, got {feats.dtype}")
        return BN.masked_bn_relu(feats, mask, self.scale, self.bias, self.mean, self.var,
                                 self.momentum, self.epsilon, self.training,
                                 self.training and not _RECOMPUTING)

    def normalize(self, feats, mask):
        """The norm without its ReLU as the eager chain: the kernels' plain
        twin, run on every device but CUDA."""
        if self.training:
            m = mask[..., None].to(torch.float32)
            f32 = feats.to(torch.float32)
            world = DPC.current()
            if world is None:
                count = torch.clamp(m.sum(), min=1.0)
                mean = (f32 * m).sum(dim=(0, 1)) / count
                var = (torch.square(f32 - mean) * m).sum(dim=(0, 1)) / count
            else:
                sums = DPC.all_reduce_sum(
                    torch.cat([(f32 * m).sum(dim=(0, 1)), m.sum()[None]]), world)
                count = torch.clamp(sums[-1].detach(), min=1.0)
                mean = sums[:-1] / count
                var = DPC.all_reduce_sum(
                    (torch.square(f32 - mean) * m).sum(dim=(0, 1)), world) / count
            if not _RECOMPUTING:
                with torch.no_grad():
                    self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                    self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        cd = self.dtype
        inv = (torch.rsqrt(var + self.epsilon) * self.scale).to(cd)
        out = (feats.to(cd) - mean.to(cd)) * inv + self.bias.to(cd)
        return out * mask[..., None].to(cd)


@contextlib.contextmanager
def _recomputing():
    global _RECOMPUTING
    was, _RECOMPUTING = _RECOMPUTING, True
    try:
        yield
    finally:
        _RECOMPUTING = was


class RematCounters:
    """What :func:`remat` recomputed in this process, as plain integers:
    ``ns`` of host time spent recomputing (the ``remat`` spans' own
    durations, kept outside ``recording()`` too) and ``passes``, the
    backward passes that recomputed at least one block."""

    def __init__(self):
        self.ns = self.passes = 0
        self.armed = False       # a forward ran blocks that its backward will recompute


REMAT = RematCounters()


def remat(block: nn.Module, *args):
    """``block(*args)`` without keeping its activations for the backward
    (flax's ``nn.remat``): ``torch.utils.checkpoint`` runs the forward again
    in the backward. The recomputed forward sees the same inputs, weights and
    batch statistics, so it gives the same bits; it moves no BN running
    statistic. Under data parallel it runs in the data-parallel context of
    the first run (the backward may run on another thread), so every rank
    issues the same collectives again, in the same order. Without a
    gradient to take, the block just runs.

    Each recompute is the span ``remat`` (counter ``remat_blocks``), opened
    under the span that the thread of the forward waits in (``backward``),
    and goes into :data:`REMAT`."""
    if not (torch.is_grad_enabled() and block.training):
        return block(*args)
    calls = []
    world = DPC.current()
    waiter = threading.get_ident()

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            REMAT.armed = True
            return block(*a)
        if REMAT.armed:
            REMAT.passes += 1
            REMAT.armed = False
        s = span("remat", waiter)
        try:
            with s, _recomputing(), DPC.shard_context(world):
                count("remat_blocks")
                return block(*a)
        finally:
            REMAT.ns += s.ns
    return checkpoint(run, *args, use_reentrant=False)


class SparseBasicBlock(nn.Module):
    """Residual block: (BN + ReLU → SubM) × 2 + skip, pre-activation style.
    A 1×1 projection through the centre tap when the widths differ."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn1 = MaskedBatchNorm(in_features, dtype=dtype)
        self.conv1 = SubMConv3d(in_features, features, kernel_size, dtype=dtype)
        self.bn2 = MaskedBatchNorm(features, dtype=dtype)
        self.conv2 = SubMConv3d(features, features, kernel_size, dtype=dtype)
        self.proj = (SubMConv3d(in_features, features, 1, dtype=dtype)
                     if in_features != features else None)

    def forward(self, feats, subm_idx, mask):
        x = self.conv1(self.bn1(feats, mask), subm_idx)
        x = self.conv2(self.bn2(x, mask), subm_idx)
        residual = feats
        if self.proj is not None:
            c = subm_idx.shape[1] // 2
            residual = self.proj(feats, subm_idx[:, c:c + 1, :])
        return x + residual


class Dense(nn.Linear):
    """flax ``nn.Dense``: f32 parameters, the product in ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, use_bias: bool = True):
        super().__init__(in_features, features, bias=use_bias)
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        bias = None if self.bias is None else self.bias.to(d)
        return nn.functional.linear(x.to(d), self.weight.to(d), bias)


def sparse_dropout(feats: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """``where(keep, feats / (1 - rate), 0)`` in feats' dtype. The division
    is the product with the reciprocal of ``1 - rate`` rounded to that
    dtype: what XLA compiles JAX's division by a constant into, in the
    jitted train step."""
    scale = float(torch.tensor(1.0 - rate, dtype=feats.dtype).reciprocal())
    return torch.where(keep, feats * scale, feats.new_zeros(())).to(feats.dtype)


class SparseDropout(nn.Module):
    """Feature dropout (port of ``SparseDropout``); inert when not training.
    The keep mask, each entry kept with probability ``1 - rate``, is drawn
    scene by scene, scene b's from ``generators[b]`` (the torch default
    generator without): a scene's mask depends neither on the other scenes
    of its batch nor on the rank that holds it."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, feats, generators: Optional[Sequence[torch.Generator]] = None):
        if self.rate <= 0.0 or not self.training:
            return feats
        if generators is None:
            generators = [None] * feats.shape[0]
        if len(generators) != feats.shape[0]:
            raise ValueError(f"{len(generators)} dropout generators for {feats.shape[0]} scenes")
        u = torch.stack([torch.rand(feats.shape[1:], generator=g, device=feats.device)
                         for g in generators])
        return sparse_dropout(feats, u < 1.0 - self.rate, self.rate)


class MLP(nn.Module):
    """Plain per-row MLP with ReLU between layers (used by heads)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense{i}", Dense(in_features, f, dtype))
            in_features = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"dense{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The port's own seeded init, drawn on the CPU from ``generator`` so one
    seed gives the same weights on every device. Sparse kernels: He normal
    over fan_in = K·Cin (``_kaiming_init`` of the JAX package); dense and
    conv weights: normal with variance 1/fan_in (flax's lecun default, not
    truncated); biases 0; BN scale 1, bias 0, running mean 0, var 1.
    """
    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    for mod in model.modules():
        if isinstance(mod, SparseConv):
            k, cin, _ = mod.kernel.shape
            mod.kernel.copy_(normal(mod.kernel.shape, math.sqrt(2.0 / (k * cin))))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, MaskedBatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
        elif isinstance(mod, (nn.Linear, nn.Conv3d, nn.ConvTranspose3d)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose3d):
                fan_in = w.shape[0] * w[0, 0].numel()
            else:
                fan_in = w[0].numel()
            w.copy_(normal(w.shape, math.sqrt(1.0 / fan_in)))
            if mod.bias is not None:
                mod.bias.zero_()
    return model
