"""The port's CUDA kernels against their plain versions, on the card: the
sparse conv's (forward, dgrad, wgrad), the gather-form backwards of the
RoI crop and the bf16 mask read (``roi_crop_grad``, ``mask_read_map``,
``mask_read_grad``), and the optimizer's (``global_sumsq_*``,
``optim_apply``), and the greedy 3D NMS (``nms_3d``).

This file imports neither jax nor the JAX package, so that it also runs on a
machine that has a card and no JAX. ``tests/conftest.py`` imports jax, so
run it there without the conftest files:

    python -m pytest --noconftest -o markers=cuda -m cuda tests/test_torch_kernel_cuda.py -q

Without a card every test here skips. Tolerances: f32 1e-5 (TF32 off; the
kernel sums taps in the plain version's order); bf16 1e-2 (both sum in f32
and round once to bf16: at most one bf16 ulp, 2^-8 relative). The two
indexing backwards add each row's entries in the order of CUDA's
``index_put_``, their plain version, and are held to it bit for bit; the
mask read's map, built per proposal by a kernel, is held to the plain
stable sort bit for bit, on ``benchmarks/mask_map_cases.py``'s cases. The
optimizer's kernels repeat their plain versions' float32 operations in
their order and are held to them bit for bit too (NaN counts as equal to
NaN), on ``benchmarks/optim_cases.py``'s cases, which ``chip_smoke.py``
runs too. The NMS kernel is held to the plain loop ``nms_3d_reference``
bit for bit on ``keep_idx`` and ``keep_mask``, on
``benchmarks/nms_cases.py``'s cases, which ``chip_smoke.py`` runs too.
The eval pass's overlap counts (plain torch ops on the card) are held to
the counts taken on the host from the fetched ``point_mask_bits``, and the
mAP that ``run_eval`` scores from them to the mask path's, exactly.
"""

import os

import numpy as np
import pytest
import torch

from benchmarks import mask_map_cases as MC
from benchmarks import nms_cases as NC
from benchmarks import optim_cases as OC
from sparse_rcnn_tpu_torch.config import RPNConfig, load_config
from sparse_rcnn_tpu_torch.data.pipeline import Loader
from sparse_rcnn_tpu_torch.models import rpn as PRpn
from sparse_rcnn_tpu_torch.native import libraries as NL
from sparse_rcnn_tpu_torch.ops import index_grad as IG
from sparse_rcnn_tpu_torch.ops import nms as PN
from sparse_rcnn_tpu_torch.ops import optim as OPT
from sparse_rcnn_tpu_torch.ops import sparse_conv as SC
from sparse_rcnn_tpu_torch.train import evaluate as EV
from sparse_rcnn_tpu_torch.train import loop as TL
from sparse_rcnn_tpu_torch.utils.metrics import InstanceAPEvaluator

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (K, Cin, Cout, M_in, M_out, dtype[, liveness]): the tap counts of the UNet,
# the stem's Cin=3, a decoder concat width, ragged M (not a multiple of 8);
# then the paths of the kernel's dead-tile skip and its copy widths: live
# rows ending at 60 % of M (dead tail tiles), every entry -1, the second
# scene live only to 30 % of M, Cin 3 in bf16 (6-byte rows, plain loads),
# Cin 24, Cout 24 and 64, M below one 64-row tile, and Cin 40 / Cout 80
# (two channel chunks, two output-channel tiles)
CASES = [
    (27, 3, 16, 200, 200, "float32"),
    (27, 16, 24, 203, 203, "float32"),
    (8, 16, 32, 200, 131, "float32"),
    (8, 32, 16, 131, 200, "float32"),
    (1, 32, 16, 77, 77, "float32"),
    (27, 16, 16, 200, 200, "bfloat16"),
    (8, 16, 32, 200, 131, "bfloat16"),
    (1, 32, 16, 77, 77, "bfloat16"),
    (27, 16, 16, 300, 300, "float32", "tail60"),
    (27, 16, 16, 300, 300, "bfloat16", "tail60"),
    (27, 16, 16, 300, 300, "float32", "dead"),
    (27, 16, 16, 300, 300, "bfloat16", "dead"),
    (27, 16, 16, 300, 300, "float32", "mixed"),
    (27, 16, 16, 300, 300, "bfloat16", "mixed"),
    (27, 3, 16, 200, 200, "bfloat16"),
    (27, 24, 24, 150, 150, "bfloat16"),
    (27, 16, 64, 200, 200, "float32"),
    (27, 16, 64, 200, 200, "bfloat16"),
    (27, 16, 16, 40, 37, "float32"),
    (27, 16, 16, 40, 37, "bfloat16"),
    (8, 40, 80, 100, 100, "float32"),
    (8, 40, 80, 100, 100, "bfloat16"),
]


def case_id(c):
    return "K{}_{}x{}_M{}to{}_{}".format(*c) + "".join(f"_{x}" for x in c[6:])


def apply_liveness(ix, live):
    """Kill rows of a gather index [B, K, M] in place: ``tail60`` every
    entry of rows from 60 % of M on, ``half`` from 50 %, ``dead`` every
    entry, ``mixed`` the second scene's rows from 30 % of M on,
    ``scene0_dead`` every entry of the first scene; ``stages`` the rows of
    the second and of the fourth and fifth 32-row stages on every tap
    (stages with no live row for any tap, which the wgrad kernel neither
    stages nor multiplies) and every row of tap 3."""
    m = ix.shape[-1]
    if live == "tail60":
        ix[:, :, int(0.6 * m):] = -1
    elif live == "half":
        ix[:, :, m // 2:] = -1
    elif live == "dead":
        ix[:] = -1
    elif live == "mixed":
        ix[1, :, int(0.3 * m):] = -1
    elif live == "scene0_dead":
        ix[0] = -1
    elif live == "stages":
        ix[:, :, 32:64] = -1
        ix[:, :, 96:160] = -1
        ix[:, 3] = -1
    return ix


def apply_rulebook_liveness(idx, t_idx, live):
    """Kill rows of the transposed rulebook t_idx [B, K, M_in] (the wgrad's
    gather index) with :func:`apply_liveness`, and the entries of idx
    [B, K, M_out] that pointed at them, so both stay per-tap transposes."""
    apply_liveness(t_idx, live)
    safe = np.where(idx >= 0, idx, 0)
    idx[(idx >= 0) & (np.take_along_axis(t_idx, safe, axis=2) < 0)] = -1
    return idx, t_idx


def make_inputs(seed, k, cin, cout, m_in, m_out, batch=2):
    """Random feats/W and an idx with about 30 % of entries -1."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, m_in, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * np.sqrt(2.0 / (k * cin))).astype(np.float32)
    idx = rng.integers(0, m_in, size=(batch, k, m_out)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.3] = -1
    return feats, idx, w


def make_rulebook_inputs(seed, k, cin, cout, m_in, m_out, batch=2):
    """Random feats/W and a rulebook idx [B, K, M_out] that is injective per
    tap, as every conv rulebook is (about 70 % of min(M_in, M_out) pairs
    live), with its per-tap transpose t_idx [B, K, M_in]."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, m_in, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * np.sqrt(2.0 / (k * cin))).astype(np.float32)
    idx = np.full((batch, k, m_out), -1, np.int32)
    t_idx = np.full((batch, k, m_in), -1, np.int32)
    live = int(0.7 * min(m_in, m_out))
    for b in range(batch):
        for t in range(k):
            outs = rng.choice(m_out, live, replace=False)
            ins = rng.choice(m_in, live, replace=False)
            idx[b, t, outs] = ins
            t_idx[b, t, ins] = outs
    return feats, idx, t_idx, w


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cuda_kernel_matches_reference(cuda_device, case):
    k, cin, cout, m_in, m_out, dt, *live = case
    feats, idx, w = make_inputs(sum(case[:5]), k, cin, cout, m_in, m_out)
    apply_liveness(idx, live[0] if live else None)
    f = torch.from_numpy(feats).to(cuda_device, TORCH_DT[dt])
    ix = torch.from_numpy(idx).to(cuda_device)
    tw = torch.from_numpy(w).to(cuda_device, TORCH_DT[dt])
    before = NL.LAUNCHES["forward"]
    got = SC.sparse_conv(f, ix, tw)
    torch.cuda.synchronize()
    assert NL.LAUNCHES["forward"] == before + 1
    assert got.dtype == TORCH_DT[dt] and got.shape == (2, m_out, cout)
    want = SC.sparse_conv_reference(f, ix, tw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dt])


@pytest.mark.cuda
def test_cuda_kernel_refuses_mixed_dtypes(cuda_device):
    feats, idx, w = make_inputs(3, 8, 4, 4, 30, 20)
    f = torch.from_numpy(feats).to(cuda_device)
    ix = torch.from_numpy(idx).to(cuda_device)
    tw = torch.from_numpy(w).to(cuda_device, torch.bfloat16)
    before = NL.LAUNCHES["forward"]
    with pytest.raises(TypeError):
        SC.sparse_conv(f, ix, tw)
    assert NL.LAUNCHES["forward"] == before


# the backward kernels: wgrad sums up to B * M_in products per entry in
# another order than the plain version's einsum, so f32 and bf16 inputs
# alike (bf16 products are exact in f32) are held to 1e-4 of the largest
# entry; the dgrad is the forward kernel and keeps the forward's tolerances
def _wgrad_close(got, want):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cuda_backward_kernels_match_reference(cuda_device, case):
    k, cin, cout, m_in, m_out, dt, *live = case
    feats, idx, t_idx, w = make_rulebook_inputs(sum(case[:5]), k, cin, cout, m_in, m_out)
    apply_liveness(t_idx, live[0] if live else None)      # the dgrad's gather index
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(2, m_out, cout)).astype(np.float32))
    f = torch.from_numpy(feats).to(cuda_device, TORCH_DT[dt])
    ti = torch.from_numpy(t_idx).to(cuda_device)
    tw = torch.from_numpy(w).to(cuda_device, TORCH_DT[dt])
    g = g.to(cuda_device, TORCH_DT[dt])
    before = (NL.LAUNCHES["dgrad"], NL.LAUNCHES["wgrad"])
    d_f = SC.conv_dgrad(g, ti, tw)
    d_w = SC.conv_wgrad(f, ti, g)
    d_w2 = SC.conv_wgrad(f, ti, g)
    torch.cuda.synchronize()
    assert (NL.LAUNCHES["dgrad"], NL.LAUNCHES["wgrad"]) == (before[0] + 1, before[1] + 2)
    assert d_f.dtype == TORCH_DT[dt] and d_f.shape == (2, m_in, cin)
    assert d_w.dtype == torch.float32 and d_w.shape == (k, cin, cout)
    assert torch.equal(d_w, d_w2)                 # no atomics: bit-identical
    w_t = tw.transpose(1, 2).contiguous()
    torch.testing.assert_close(d_f.float(), SC.sparse_conv_reference(g, ti, w_t).float(),
                               **TOL[dt])
    _wgrad_close(d_w, SC.sparse_conv_wgrad_reference(f, ti, g))


@pytest.mark.cuda
def test_cuda_sparse_conv_has_grad_fn(cuda_device):
    feats, idx, t_idx, w = make_rulebook_inputs(4, 27, 16, 16, 300, 300)
    f = torch.from_numpy(feats).to(cuda_device).requires_grad_(True)
    tw = torch.from_numpy(w).to(cuda_device).requires_grad_(True)
    ix = torch.from_numpy(idx).to(cuda_device)
    out = SC.sparse_conv_t(f, ix, torch.from_numpy(t_idx).to(cuda_device), tw)
    assert out.grad_fn is not None
    before = (NL.LAUNCHES["dgrad"], NL.LAUNCHES["wgrad"])
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (NL.LAUNCHES["dgrad"], NL.LAUNCHES["wgrad"]) == (before[0] + 1, before[1] + 1)
    fc = f.detach().cpu().requires_grad_(True)
    wc = tw.detach().cpu().requires_grad_(True)
    SC.sparse_conv_t(fc, ix.cpu(), torch.from_numpy(t_idx), wc).square().sum().backward()
    torch.testing.assert_close(f.grad.cpu(), fc.grad, **TOL["float32"])
    _wgrad_close(tw.grad.cpu(), wc.grad)


# (K, Cin, Cout, M_in, M_out, dtype[, liveness of t_idx]): the wgrad kernel's
# paths. Several row chunks with a ragged last one (M 1000: 3 x 256 + 232),
# K1 and K8 (one block of 1 and of 8 warps) above one chunk, a scene all
# dead beside a live one, the stem's Cin 3 (4-wide tile; bf16 rows of 6 bytes
# by plain loads) with half the rows dead, whole dead stages and a dead tap,
# Cin 40 x Cout 80 (two input- and three output-channel tiles), Cin 24 x
# Cout 24, and odd widths (4-byte copies in f32, plain loads in bf16)
WGRAD_CASES = [
    (27, 16, 16, 1000, 1000, "float32"),
    (27, 16, 16, 1000, 1000, "bfloat16"),
    (1, 32, 16, 700, 700, "float32"),
    (1, 32, 16, 700, 700, "bfloat16"),
    (8, 16, 32, 600, 400, "float32"),
    (8, 16, 32, 600, 400, "bfloat16"),
    (8, 32, 16, 400, 600, "float32"),
    (27, 16, 16, 520, 520, "float32", "scene0_dead"),
    (27, 16, 16, 520, 520, "bfloat16", "scene0_dead"),
    (27, 3, 16, 600, 600, "float32", "half"),
    (27, 3, 16, 600, 600, "bfloat16", "half"),
    (27, 16, 16, 600, 600, "float32", "stages"),
    (27, 32, 32, 600, 600, "bfloat16", "stages"),
    (27, 40, 80, 300, 300, "float32"),
    (27, 24, 24, 300, 300, "bfloat16"),
    (8, 5, 7, 300, 300, "float32"),
    (8, 5, 7, 300, 300, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGRAD_CASES, ids=case_id)
def test_cuda_wgrad_kernel_matches_reference(cuda_device, case):
    k, cin, cout, m_in, m_out, dt, *live = case
    feats, _, t_idx, _ = make_rulebook_inputs(sum(case[:5]), k, cin, cout, m_in, m_out)
    apply_liveness(t_idx, live[0] if live else None)
    g = np.random.default_rng(2).normal(size=(2, m_out, cout)).astype(np.float32)
    f = torch.from_numpy(feats).to(cuda_device, TORCH_DT[dt])
    ti = torch.from_numpy(t_idx).to(cuda_device)
    g = torch.from_numpy(g).to(cuda_device, TORCH_DT[dt])
    before = NL.LAUNCHES["wgrad"]
    d_w = SC.conv_wgrad(f, ti, g)
    d_w2 = SC.conv_wgrad(f, ti, g)
    torch.cuda.synchronize()
    assert NL.LAUNCHES["wgrad"] == before + 2
    assert d_w.dtype == torch.float32 and d_w.shape == (k, cin, cout)
    assert torch.equal(d_w, d_w2)                 # no atomics: bit-identical
    _wgrad_close(d_w, SC.sparse_conv_wgrad_reference(f, ti, g))


# (M, C, P, D, dtype, case): the RoI crop's backward over P boxes of D^3
# samples: about 40 % of the corners dead; every corner dead; every live
# corner into row 0 (today's row-0 run); M below one block with P = 1; C of
# 3 (4 lanes a row), 16 (two rows a warp), 32 and 40 (two channel passes)
ROI_GRAD_CASES = [
    (300, 16, 4, 3, "float32", "random"),
    (300, 16, 4, 3, "bfloat16", "random"),
    (300, 32, 4, 3, "float32", "random"),
    (300, 32, 4, 3, "bfloat16", "random"),
    (300, 32, 4, 3, "bfloat16", "all_dead"),
    (300, 16, 4, 3, "float32", "one_row"),
    (300, 32, 4, 3, "bfloat16", "one_row"),
    (5, 16, 1, 3, "float32", "random"),
    (300, 3, 2, 3, "float32", "random"),
    (300, 40, 2, 3, "float32", "random"),
]


def roi_grad_inputs(device, m, c, p, d, dt, case):
    rng = np.random.default_rng(m + c + p)
    s = p * d ** 3
    idx = rng.integers(0, m, (8, s)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.4] = -1
    if case == "all_dead":
        idx[:] = -1
    elif case == "one_row":
        idx[idx >= 0] = 0
    g = torch.from_numpy(rng.normal(size=(s, c)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 1, (8, s)).astype(np.float32))
    return (g.to(device, TORCH_DT[dt]), w.to(device, TORCH_DT[dt]),
            torch.from_numpy(idx).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROI_GRAD_CASES, ids=lambda c: "M{}_C{}_P{}_D{}_{}_{}".format(*c))
def test_cuda_roi_crop_grad_bit_equal_to_index_put(cuda_device, case):
    m = case[0]
    g, w, idx = roi_grad_inputs(cuda_device, *case)
    rmap = IG.roi_crop_map(idx, m)
    before = NL.LAUNCHES["roi_crop_grad"]
    got = IG.roi_crop_grad(g, w, idx, rmap, m)
    again = IG.roi_crop_grad(g, w, idx, rmap, m)
    want = IG.roi_crop_grad_reference(g, w, idx, m)
    torch.cuda.synchronize()
    assert NL.LAUNCHES["roi_crop_grad"] == before + 2
    assert got.dtype == g.dtype and got.shape == (m, g.shape[1])
    assert torch.equal(got, again)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


# (P, G, N, case): the mask read's backward; "border" sends 70 % of a
# proposal's points to one cell (the border cells of a box that holds
# few points), "one_cell" every point of proposal 0 to cell 0 (a run of N
# entries, 156 lane passes at N 5000), "tail" runs shorter than a warp
MASK_GRAD_CASES = [
    (4, 6, 3000, "random"),
    (5, 6, 4000, "border"),
    (3, 6, 5000, "one_cell"),
    (1, 14, 2000, "random"),
    (2, 4, 37, "tail"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MASK_GRAD_CASES, ids=lambda c: "P{}_G{}_N{}_{}".format(*c))
def test_cuda_mask_read_grad_bit_equal_to_index_put(cuda_device, case):
    p, grid, n, kind = case
    cells = grid ** 3
    rng = np.random.default_rng(p + n)
    cell = rng.integers(0, cells, (p, n)).astype(np.int32)
    if kind == "border":
        cell[rng.random((p, n)) < 0.7] = cells - 1
    elif kind == "one_cell":
        cell[0] = 0
    cell = torch.from_numpy(cell).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(p, n)).astype(np.float32)).to(cuda_device,
                                                                        torch.bfloat16)
    rmap = IG.mask_read_map(cell, cells)
    before = NL.LAUNCHES["mask_read_grad"]
    got = IG.mask_read_grad(g, cell, rmap, cells)
    again = IG.mask_read_grad(g, cell, rmap, cells)
    want = IG.mask_read_grad_reference(g, cell, cells)
    torch.cuda.synchronize()
    assert NL.LAUNCHES["mask_read_grad"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (p, cells)
    assert torch.equal(got, again)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("case", MC.MASK_MAP_CASES, ids=lambda c: c[0])
def test_cuda_mask_read_map_and_grad_bit_equal_to_plain(cuda_device, case):
    """The map kernel's (perm, offsets, lanes) equal the plain stable sort's
    (up to the kept entries), and ``mask_read_grad`` over that map equals
    ``index_put_`` over every entry, bits of ±0 included; each identical
    across two runs, one count a launch."""
    name, p, grid, n, kind = case
    g, cell, keep, cells = MC.mask_case(p, grid, n, kind, cuda_device, 7)
    before = (NL.LAUNCHES["mask_read_map"], NL.LAUNCHES["mask_read_grad"])
    rec = MC.check_mask_case(g, cell, keep, cells, MC.FORCED_UNIT.get(kind))
    torch.cuda.synchronize()
    assert (NL.LAUNCHES["mask_read_map"], NL.LAUNCHES["mask_read_grad"]) == (before[0] + 2,
                                                                        before[1] + 2)
    assert rec["map_bit_equal"] and rec["map_bit_identical"], rec
    assert rec["bit_equal"] and rec["bit_identical"], rec
    if kind == "all_outside":
        assert rec["kept"] == 0
    elif kind in ("long_inside_run", "full_unit"):
        assert rec["longest_kept_row"] > 32 * 32 and rec["kept_in_lanes"] > 0


@pytest.mark.cuda
def test_cuda_mask_read_map_refuses_cpu_tensors_and_big_grids(cuda_device):
    cell = torch.zeros((2, 40), dtype=torch.int32)
    before = NL.LAUNCHES["mask_read_map"]
    with pytest.raises(ValueError):
        IG.mask_read_map_kernel(cell, 27)
    with pytest.raises(ValueError):
        IG.mask_read_map_kernel(cell.to(cuda_device), 27, torch.ones((2, 40), dtype=torch.bool))
    big = IG.map_max_cells(cell.to(cuda_device).device) + 1
    with pytest.raises(ValueError, match="tiling over cells"):
        IG.mask_read_map_kernel(cell.to(cuda_device), big)
    assert NL.LAUNCHES["mask_read_map"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_index_reads_backward_through_the_kernels(cuda_device, dt):
    """The autograd Functions on the card: one launch each, gradients equal
    to autograd's own backward of the composite reads."""
    g, w, idx = roi_grad_inputs(cuda_device, 300, 16, 4, 3, dt, "random")
    feats = torch.from_numpy(np.random.default_rng(5).normal(size=(300, 16)).astype(
        np.float32)).to(cuda_device, TORCH_DT[dt])
    w = w.float().reshape(8, 4, 27)
    idx = idx.reshape(8, 4, 27)
    grads = []
    for composite in (False, True):
        f = feats.clone().requires_grad_(True)
        before = NL.LAUNCHES["roi_crop_grad"]
        if composite:
            live = (idx >= 0)[..., None].to(f.dtype)
            out = torch.sum(f[idx.clamp(0, 299).long()] * live * w[..., None].to(f.dtype), 0)
        else:
            out = IG.corner_gather(f, idx, w)
        out.backward(g.reshape(4, 27, 16))
        torch.cuda.synchronize()
        assert NL.LAUNCHES["roi_crop_grad"] == before + (0 if composite else 1)
        grads.append((out.detach(), f.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])

    rng = np.random.default_rng(6)
    cell = torch.from_numpy(rng.integers(0, 216, (3, 500)).astype(np.int32)).to(cuda_device)
    mask = torch.from_numpy(rng.normal(size=(3, 6, 6, 6)).astype(np.float32)).to(
        cuda_device, TORCH_DT[dt])
    ct = torch.from_numpy(rng.normal(size=(3, 500)).astype(np.float32)).to(cuda_device)
    grads = []
    for composite in (False, True):
        m = mask.clone().requires_grad_(True)
        before = NL.LAUNCHES["mask_read_grad"]
        bf = m.to(torch.bfloat16)
        if composite:
            out = bf.reshape(3, -1)[torch.arange(3, device=cuda_device)[:, None], cell.long()]
        else:
            out = IG.mask_read(bf, cell)
        out.to(m.dtype).backward(ct.to(m.dtype))
        torch.cuda.synchronize()
        assert NL.LAUNCHES["mask_read_grad"] == before + (0 if composite else 1)
        grads.append((out.detach(), m.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])

    # with keep, and a cotangent of 0 where it is false: the map of the kept
    # entries, one launch of each kernel, the composite's gradient
    keep = torch.from_numpy(rng.random((3, 500)) < 0.3).to(cuda_device)
    m = mask.clone().requires_grad_(True)
    before = (NL.LAUNCHES["mask_read_map"], NL.LAUNCHES["mask_read_grad"])
    out = IG.mask_read(m.to(torch.bfloat16), cell, keep)
    out.to(m.dtype).backward(torch.where(keep, ct, 0.0).to(m.dtype))
    torch.cuda.synchronize()
    assert (NL.LAUNCHES["mask_read_map"], NL.LAUNCHES["mask_read_grad"]) == (before[0] + 1,
                                                                        before[1] + 1)
    c = mask.clone().requires_grad_(True)
    bf = c.to(torch.bfloat16)
    want = bf.reshape(3, -1)[torch.arange(3, device=cuda_device)[:, None], cell.long()]
    want.to(c.dtype).backward(torch.where(keep, ct, 0.0).to(c.dtype))
    assert torch.equal(out.detach(), want.detach()) and torch.equal(m.grad, c.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("case", OC.OPTIM_CASES, ids=lambda c: c[0])
def test_cuda_optimizer_kernels_bit_equal_to_plain(cuda_device, case):
    name, sizes, kind, grads, count, ema = case
    shapes = OC.case_shapes(sizes)
    lists = OC.optim_case(cuda_device, shapes, grads, seed=len(shapes), layout=OC.layout(name))
    before = (NL.LAUNCHES["global_norm"], NL.LAUNCHES["optim_apply"])
    got, again = (OC.run_optim(lists, kind, count, ema, kernel=True) for _ in range(2))
    want = OC.run_optim(lists, kind, count, ema, kernel=False)
    torch.cuda.synchronize()
    launches = len(OPT.chunk_plan([g.numel() for g in lists["grads"]])[1])
    assert (NL.LAUNCHES["global_norm"] - before[0], NL.LAUNCHES["optim_apply"] - before[1]) == (
        0 if kind == "ema" else 2 * (launches + 1), 2 * launches)
    for what, g, a, w in zip(("norm", "params", "mu", "nu", "ema"), got, again, want):
        assert OC.same_bits(g, a), f"{name}: {what} differs run to run"
        assert OC.same_bits(g, w), f"{name}: {what} differs from the plain version"
    if grads == "nan":
        assert all(p.isnan().all() for p in got[1])


@pytest.mark.cuda
def test_cuda_optimizer_kernels_refuse_a_cpu_tensor(cuda_device):
    lists = OC.optim_case(cuda_device, [(100,), (200,), (300,)])
    lists["grads"][1] = lists["grads"][1].cpu()
    with pytest.raises(ValueError):
        OPT.global_norm(lists["grads"])
    norm = OPT.global_norm([g.to(cuda_device) for g in lists["grads"]])
    with pytest.raises(ValueError):
        OPT.optim_apply(norm, lists["grads"], lists["params"], lists["mu"], lists["nu"], None,
                        OPT.Step("adamw", lr=1e-3, count=1, clip=10.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c[0] for c in NC.NMS_CASES])
def test_cuda_nms_kernel_bit_equal_to_plain(cuda_device, name):
    c = NC.nms_case(name, cuda_device, seed=7)
    before = NL.LAUNCHES["nms_3d"]
    got, again = (PN.nms_3d(c["boxes"], c["scores"], c["valid"], c["threshold"], c["p"])
                  for _ in range(2))
    want = NC.run_plain(c)
    assert NL.LAUNCHES["nms_3d"] == before + 2
    for what, g, a, w in zip(("keep_idx", "keep_mask"), got, again, want):
        assert torch.equal(g, a), f"{name}: {what} differs run to run"
        assert torch.equal(g, w), f"{name}: {what} differs from the plain loop"


@pytest.mark.cuda
def test_cuda_select_proposals_one_nms_launch(cuda_device, monkeypatch):
    """select_proposals on a seeded batch: one NMS launch for both scenes,
    outputs equal to the same function with the plain loop scene by scene."""
    rng = np.random.default_rng(11)
    b, m = 2, 6000
    obj = torch.from_numpy(rng.normal(size=(b, m)).astype(np.float32)).to(cuda_device)
    boxes = torch.from_numpy(np.stack([NC.scene_boxes(rng, m) for _ in range(b)])).to(
        cuda_device)
    valid = torch.from_numpy(rng.random((b, m)) < 0.8).to(cuda_device)
    cfg = RPNConfig(num_proposals=128, pre_nms_topk=512)
    before = NL.LAUNCHES["nms_3d"]
    got = PRpn.select_proposals(obj, boxes, valid, cfg)
    assert NL.LAUNCHES["nms_3d"] == before + 1
    monkeypatch.setattr(PN, "nms_3d", lambda bx, s, v, t, p: NC.run_plain(
        {"boxes": bx, "scores": s, "valid": v, "threshold": t, "p": p}))
    want = PRpn.select_proposals(obj, boxes, valid, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


CONFIG2 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "config2_scannet_2cm.yaml")


@pytest.mark.cuda
def test_cuda_eval_pass_counts_score_as_the_fetched_masks(cuda_device, monkeypatch):
    """Config 2's eval form on 4 synthetic val scenes of 262,144 points in
    batches of 2, seeded weights. Each scene's overlap counts, made on the
    card after the step, equal the counts taken on the host from its
    fetched ``point_mask_bits`` (the evaluator's f32 matmul and sums over
    the valid points); ``run_eval``'s mAP dict, per class and per scene,
    equals the dict from the same fetched outputs scored through
    ``postprocess_scene`` and ``add_scene``. The counts queue no host
    sync."""
    cfg = load_config(CONFIG2, {"data": {"dataset": "synthetic", "val_scenes": 4}})
    nc = cfg.model.num_classes
    model = TL.build_model(cfg, cuda_device, torch.Generator().manual_seed(3))
    batches = list(Loader(cfg, "val", train=False, threads=False))
    assert len(batches) == 2 and batches[0]["valid"].shape == (2, 262144)
    fetched = []
    fetch = EV.fetch_eval_outputs

    def spy(out):
        host = fetch(out)
        fetched.append(host)
        return host
    monkeypatch.setattr(EV, "fetch_eval_outputs", spy)
    res = EV.run_eval(cfg, model, batches, num_scenes=4, per_class=True, per_scene=True)
    assert res["scenes"] == 4 and len(fetched) == 2
    ev = InstanceAPEvaluator(nc)
    for out, batch in zip(fetched, batches):
        w = EV.overlap_width(batch)
        assert out["overlap_inter"].shape == (2, cfg.model.rpn.num_proposals, w)
        for b in range(2):
            o, (valid, pinst, psem) = EV._scene_slice(out, batch, b)
            masks, scores, pred_cls, pmask = EV.postprocess_scene(o, 0, nc)
            pm = masks[:, valid]
            gm = np.stack([pinst[valid] == g for g in range(w)])
            inter = pm.astype(np.float32) @ gm.astype(np.float32).T
            np.testing.assert_array_equal(o["overlap_inter"][0].astype(np.float32), inter)
            np.testing.assert_array_equal(o["overlap_pred_sum"][0], pm.sum(axis=1))
            np.testing.assert_array_equal(o["overlap_gt_sum"][0], gm.sum(axis=1))
            for got, want in zip(EV.scene_scores(o, 0, nc), (scores, pred_cls, pmask)):
                np.testing.assert_array_equal(got, want)
            ev.add_scene(masks, scores, pred_cls, pmask, pinst,
                         EV._gt_classes_from_points(pinst, psem, valid), valid)
    want = ev.compute(per_class=True)
    np.testing.assert_equal({k: res[k] for k in want}, want)
    np.testing.assert_equal(res["per_scene_mAP@0.5"],
                            [round(float(x), 4) if np.isfinite(x) else None
                             for x in ev.per_scene_map(0.5)])
    # the counts read nothing back on the host
    dev = TL.to_device(batches[0], cuda_device, TL.BATCH_KEYS + ("point_instance",))
    instance = dev.pop("point_instance")
    raw = TL.eval_step(cfg, model, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        counts = EV.overlap_counts(raw["point_mask_logits"] > 0, dev["valid"], instance,
                                   EV.overlap_width(batches[0]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for got, k in zip(counts, EV.OVERLAP_KEYS):
        np.testing.assert_array_equal(got.cpu().numpy(), fetched[0][k])
