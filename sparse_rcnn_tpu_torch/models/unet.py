"""Sparse UNet backbone with the optional masked dense tail (port of
``models/unet.py``).

Encoder: per scale, residual submanifold blocks, then a kernel-2/stride-2
sparse conv to the next-coarser site set. Decoder: inverse conv back up,
skip-concat with the encoder features on the same cached site set, then
more submanifold blocks. The forward consumes a prebuilt hierarchy
(:mod:`..ops.hierarchy`), so every layer reuses the same rulebooks.

Dense tail (``dense_from_scale``): from that scale down the features are
scattered onto a dense [E/2^s]³ grid and the blocks run as masked dense 3D
convs (``nn.Conv3d``, cuDNN on the card). Empty cells hold zeros and every
conv is re-masked to the occupied cells, so the tail computes the
submanifold sums exactly (``tests/test_torch_dense_tail.py``); its scales
need site sets but no rulebooks. Grids keep the JAX package's layout
[B, X, Y, Z, C]; a conv sees them as NCDHW views in channels-last memory.

With ``remat`` every residual block is recomputed in the backward
(:func:`.layers.remat`). ``downsample`` ``maxpool`` or ``avgpool`` replaces a
sparse scale's down conv by a pool over each coarse site's children
(:mod:`..ops.pooling`) and a bias-free 1×1 projection ``down{s}_proj``; the
dense tail always downsamples by strided convs. ``dropout`` adds
:class:`.layers.SparseDropout` after each sparse encoder and decoder block
stack (``enc{s}_drop``, ``dec{s}_drop``), drawing each scene's mask from
the generator the forward is given for it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import pooling as pool_ops
from ..ops.consts import device_tensor
from ..ops.hierarchy import ScaleSet
from .layers import (Dense, MaskedBatchNorm, SparseBasicBlock, SparseConv, SparseDropout,
                     SubMConv3d, remat)


def _grid_slots(coords, nvalid, extent):
    """Flat cell of each row of ``coords`` [B, M, 3] in the batch's grids
    [B · X·Y·Z], and whether the row is live and inside ``extent``."""
    dx, dy, dz = extent
    b, m, _ = coords.shape
    live = torch.arange(m, dtype=torch.int32, device=coords.device)[None, :] < nvalid[:, None]
    lim = device_tensor([dx, dy, dz], torch.int32, coords.device)
    inb = live & ((coords >= 0) & (coords < lim)).all(-1)
    flat = ((coords[..., 0].to(torch.int64) * dy + coords[..., 1]) * dz + coords[..., 2])
    flat = flat + torch.arange(b, device=coords.device)[:, None] * (dx * dy * dz)
    return flat, inb


def _scatter(feats, flat, inb, extent):
    """feats [B, M, C] → grid [B, X, Y, Z, C]: live in-extent rows to their
    cells, which are distinct; every other row to a slot of its own past the
    grid, cut off after (the JAX package's distinct drop slots)."""
    b, m, c = feats.shape
    cells = b * extent[0] * extent[1] * extent[2]
    spare = cells + torch.arange(b * m, device=feats.device).reshape(b, m)
    dst = torch.where(inb, flat, spare).reshape(-1)
    grid = feats.new_zeros((cells + b * m, c))
    grid[dst] = feats.reshape(-1, c)
    return grid[:cells].reshape(b, *extent, c)


def _gather(grid, flat, inb):
    """grid [B, X, Y, Z, C] → rows [B, M, C] at ``flat``, zero where not ``inb``."""
    c = grid.shape[-1]
    rows = grid.reshape(-1, c)[torch.where(inb, flat, 0)]
    return torch.where(inb[..., None], rows, rows.new_zeros(()))


class _ScatterToGrid(torch.autograd.Function):
    """Live in-extent sites map to distinct cells, so the scatter's backward
    is the gather of the cotangent, and the gather's the scatter: both are
    written out, with no accumulating index_put_ (the autograd of a gather
    through a clamped index adds every dead row into cell 0, serially on the
    card)."""

    @staticmethod
    def forward(ctx, feats, flat, inb, extent):
        ctx.save_for_backward(flat, inb)
        return _scatter(feats, flat, inb, extent)

    @staticmethod
    def backward(ctx, g):
        flat, inb = ctx.saved_tensors
        return _gather(g.contiguous(), flat, inb), None, None, None


class _GatherFromGrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, flat, inb):
        ctx.save_for_backward(flat, inb)
        ctx.extent = tuple(grid.shape[1:4])
        return _gather(grid, flat, inb)

    @staticmethod
    def backward(ctx, g):
        flat, inb = ctx.saved_tensors
        return _scatter(g.contiguous(), flat, inb, ctx.extent), None, None


def scatter_to_grid(coords: torch.Tensor, nvalid: torch.Tensor, feats: torch.Tensor,
                    extent) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse rows → dense grid: (grid [B, X, Y, Z, C], occ bool[B, X, Y, Z]).
    Padding rows and sites outside [0, extent) are dropped."""
    extent = tuple(int(e) for e in extent)
    flat, inb = _grid_slots(coords, nvalid, extent)
    grid = _ScatterToGrid.apply(feats, flat, inb, extent)
    occ = _scatter(inb[..., None].to(torch.uint8), flat, inb, extent)[..., 0].bool()
    return grid, occ


def gather_from_grid(grid: torch.Tensor, coords: torch.Tensor,
                     nvalid: torch.Tensor) -> torch.Tensor:
    """Dense grid [B, X, Y, Z, C] → rows [B, M, C] at each live in-extent
    site of ``coords``; zero at every other row."""
    flat, inb = _grid_slots(coords, nvalid, tuple(grid.shape[1:4]))
    return _GatherFromGrid.apply(grid, flat, inb)


def _conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` (an ``nn.Conv3d`` or ``nn.ConvTranspose3d`` without bias) on
    x [B, X, Y, Z, C] in ``dtype`` (flax's ``nn.Conv(dtype=...)``): the
    parameters stay f32, the inputs and the product are cast.

    Each scene is convolved alone, as a batch of 1: the conv libraries pick
    their algorithm, and with it the order of a sum, by the batch's shape,
    so a batched call would make a scene's result depend on the other
    scenes in the batch (the JAX package's is bit-equal alone or batched)."""
    w = conv.weight.to(dtype)
    outs = []
    for xb in x.to(dtype).permute(0, 4, 1, 2, 3).split(1):
        if isinstance(conv, nn.ConvTranspose3d):
            outs.append(nn.functional.conv_transpose3d(xb, w, stride=conv.stride))
        else:
            outs.append(nn.functional.conv3d(xb, w, stride=conv.stride, padding=conv.padding))
    return torch.cat(outs).permute(0, 2, 3, 4, 1)


def _bn(bn: MaskedBatchNorm, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """Masked BN over the occupied cells of x [B, X, Y, Z, C]."""
    b = x.shape[0]
    return bn(x.reshape(b, -1, x.shape[-1]), occ.reshape(b, -1)).reshape(x.shape)


class DenseBasicBlock(nn.Module):
    """The residual block of masked dense 3D convs: the submanifold block's
    exact dense twin (pre-activation, re-masked after every conv)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bn1 = MaskedBatchNorm(in_features, dtype=dtype)
        # flax's SAME padding: 1 for the 3³ kernels, none for the 1³ one
        self.conv1 = nn.Conv3d(in_features, features, 3, padding=1, bias=False)
        self.bn2 = MaskedBatchNorm(features, dtype=dtype)
        self.conv2 = nn.Conv3d(features, features, 3, padding=1, bias=False)
        self.proj = (nn.Conv3d(in_features, features, 1, bias=False)
                     if in_features != features else None)

    def forward(self, x, occ):
        om = occ[..., None].to(self.dtype)
        h = _conv(self.conv1, torch.relu(_bn(self.bn1, x, occ)), self.dtype) * om
        h = _conv(self.conv2, torch.relu(_bn(self.bn2, h, occ)), self.dtype) * om
        residual = x
        if self.proj is not None:
            residual = _conv(self.proj, x, self.dtype) * om
        return h + residual


class DenseTail(nn.Module):
    """The dense UNet over scales [start, ns): encoder blocks and k2s2 down
    convs, the mirror decoder with transposed k2s2 up convs and skip-concat.
    Takes the ``start`` scale's grid and occupancy; returns each scale's
    decoder grid, ``start`` first. Occupancy goes down by a 2³ max-pool;
    the validation makes every extent even, so no conv needs padding."""

    def __init__(self, widths: Sequence[int], start: int, blocks_per_scale: int = 1,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.widths = tuple(widths)
        self.start = start
        self.blocks_per_scale = blocks_per_scale
        self.dtype = dtype
        self.remat = remat
        ns = len(self.widths)
        for s in range(start, ns):
            for b in range(blocks_per_scale):
                self.add_module(f"enc{s}_block{b}", DenseBasicBlock(
                    self.widths[s], self.widths[s], dtype))
            if s < ns - 1:
                self.add_module(f"down{s}_bn", MaskedBatchNorm(self.widths[s], dtype=dtype))
                self.add_module(f"down{s}_conv", nn.Conv3d(
                    self.widths[s], self.widths[s + 1], 2, stride=2, bias=False))
        for s in range(ns - 2, start - 1, -1):
            self.add_module(f"up{s}_bn", MaskedBatchNorm(self.widths[s + 1], dtype=dtype))
            self.add_module(f"up{s}_conv", nn.ConvTranspose3d(
                self.widths[s + 1], self.widths[s], 2, stride=2, bias=False))
            cin = 2 * self.widths[s]
            for b in range(blocks_per_scale):
                self.add_module(f"dec{s}_block{b}", DenseBasicBlock(
                    cin, self.widths[s], dtype))
                cin = self.widths[s]

    def _block(self, name, x, occ):
        block = getattr(self, name)
        return remat(block, x, occ) if self.remat else block(x, occ)

    def forward(self, grid: torch.Tensor, occ: torch.Tensor) -> List[torch.Tensor]:
        ns, cd = len(self.widths), self.dtype
        x, skips, occs = grid, [], []
        for s in range(self.start, ns):
            for b in range(self.blocks_per_scale):
                x = self._block(f"enc{s}_block{b}", x, occ)
            skips.append(x)
            occs.append(occ)
            if s < ns - 1:
                x = torch.relu(_bn(getattr(self, f"down{s}_bn"), x, occ))
                occ = nn.functional.max_pool3d(
                    occ[:, None].to(torch.float32), 2, stride=2)[:, 0] > 0.5
                x = _conv(getattr(self, f"down{s}_conv"), x, cd) * occ[..., None].to(cd)

        outputs = [None] * (ns - self.start)
        outputs[-1] = x
        for s in range(ns - 2, self.start - 1, -1):
            i = s - self.start
            up = torch.relu(_bn(getattr(self, f"up{s}_bn"), outputs[i + 1], occs[i + 1]))
            up = _conv(getattr(self, f"up{s}_conv"), up, cd) * occs[i][..., None].to(cd)
            x = torch.cat([up, skips[i]], dim=-1)
            for b in range(self.blocks_per_scale):
                x = self._block(f"dec{s}_block{b}", x, occs[i])
            outputs[i] = x
        return outputs


class SparseUNet(nn.Module):
    """Returns per-scale decoder features, finest first: out[s] has shape
    [B, M_s, widths[s]] on the scale-s site set."""

    def __init__(self, in_channels: int, widths: Sequence[int],
                 blocks_per_scale: int = 1, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32,
                 dense_from_scale: Optional[int] = None,
                 grid_extent: Optional[Sequence[int]] = None, remat: bool = False,
                 downsample: str = "conv", dropout: float = 0.0):
        super().__init__()
        if downsample not in ("conv", "maxpool", "avgpool"):
            raise ValueError(f"backbone.downsample={downsample!r}")
        self.downsample = downsample
        self.dropout = dropout
        self.widths = tuple(widths)
        self.blocks_per_scale = blocks_per_scale
        self.remat = remat
        ns = len(self.widths)
        self.dense_from_scale = dense_from_scale
        self.n_sparse = dense_from_scale or ns
        if self.n_sparse < ns:
            if grid_extent is None:
                raise ValueError("dense_from_scale needs grid_extent")
            self.grid_extent = tuple(int(e) for e in grid_extent)
        self.stem = SubMConv3d(in_channels, self.widths[0], kernel_size, dtype=dtype)
        for s in range(self.n_sparse):
            cin = self.widths[s]
            for b in range(blocks_per_scale):
                self.add_module(f"enc{s}_block{b}", SparseBasicBlock(
                    cin, self.widths[s], kernel_size, dtype))
            if dropout > 0:
                self.add_module(f"enc{s}_drop", SparseDropout(dropout))
            if s < ns - 1:
                self.add_module(f"down{s}_bn", MaskedBatchNorm(cin, dtype=dtype))
                if downsample == "conv":
                    self.add_module(f"down{s}_conv", SparseConv(
                        cin, self.widths[s + 1], 8, dtype=dtype))
                else:
                    self.add_module(f"down{s}_proj", Dense(
                        cin, self.widths[s + 1], dtype, use_bias=False))
        if self.n_sparse < ns:
            self.dense_tail = DenseTail(self.widths, self.n_sparse, blocks_per_scale,
                                        dtype, remat)
        dec_top = self.n_sparse - 1 if self.n_sparse < ns else ns - 2
        for s in range(dec_top, -1, -1):
            self.add_module(f"up{s}_bn", MaskedBatchNorm(self.widths[s + 1], dtype=dtype))
            self.add_module(f"up{s}_conv", SparseConv(
                self.widths[s + 1], self.widths[s], 8, dtype=dtype))
            cin = 2 * self.widths[s]      # up output concatenated with the skip
            for b in range(blocks_per_scale):
                self.add_module(f"dec{s}_block{b}", SparseBasicBlock(
                    cin, self.widths[s], kernel_size, dtype))
                cin = self.widths[s]
            if dropout > 0:
                self.add_module(f"dec{s}_drop", SparseDropout(dropout))

    def _block(self, name, x, idx, mask):
        block = getattr(self, name)
        return remat(block, x, idx, mask) if self.remat else block(x, idx, mask)

    def forward(self, feats: torch.Tensor, scales: List[ScaleSet],
                generators: Optional[Sequence[torch.Generator]] = None) -> List[torch.Tensor]:
        """``generators``: the dropout masks' sources in training mode, one
        per scene."""
        ns, n_sparse = len(self.widths), self.n_sparse
        if len(scales) != ns:
            raise ValueError(f"{len(scales)} scales for {ns} widths")
        masks = [sc.row_mask for sc in scales]
        x = self.stem(feats, scales[0].subm_idx)
        skips = []
        for s in range(n_sparse):
            for b in range(self.blocks_per_scale):
                x = self._block(f"enc{s}_block{b}", x, scales[s].subm_idx, masks[s])
            if self.dropout > 0:
                x = getattr(self, f"enc{s}_drop")(x, generators)
            skips.append(x)
            if s < ns - 1:
                x = torch.relu(getattr(self, f"down{s}_bn")(x, masks[s]))
                if self.downsample == "conv":
                    # t(down) == up
                    x = getattr(self, f"down{s}_conv")(x, scales[s].down_idx,
                                                       scales[s].up_idx)
                else:
                    pool = (pool_ops.max_pool if self.downsample == "maxpool"
                            else pool_ops.avg_pool)
                    x = getattr(self, f"down{s}_proj")(pool(x, scales[s].down_idx))
                    x = x * masks[s + 1][..., None].to(x.dtype)

        outputs = [None] * ns
        if n_sparse < ns:
            s0 = n_sparse
            ext = tuple(e >> s0 for e in self.grid_extent)
            grid, occ = scatter_to_grid(scales[s0].coords, scales[s0].nvalid, x, ext)
            # every dense scale's decoder grid back onto its site set
            for s, out in enumerate(self.dense_tail(grid, occ), start=s0):
                outputs[s] = gather_from_grid(out, scales[s].coords, scales[s].nvalid)
        else:
            outputs[ns - 1] = x
        for s in range(min(n_sparse, ns - 1) - 1, -1, -1):
            up = torch.relu(getattr(self, f"up{s}_bn")(outputs[s + 1], masks[s + 1]))
            # t(up) == down
            up = getattr(self, f"up{s}_conv")(up, scales[s].up_idx, scales[s].down_idx)
            x = torch.cat([up, skips[s]], dim=-1)
            for b in range(self.blocks_per_scale):
                x = self._block(f"dec{s}_block{b}", x, scales[s].subm_idx, masks[s])
            if self.dropout > 0:
                x = getattr(self, f"dec{s}_drop")(x, generators)
            outputs[s] = x
        return outputs
