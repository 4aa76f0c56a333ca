"""The port's CUDA sparse-conv kernels (forward, dgrad, wgrad) against their
plain versions, on the card.

This file imports neither jax nor the JAX package, so that it also runs on a
machine that has a card and no JAX. ``tests/conftest.py`` imports jax, so
run it there without the conftest files:

    python -m pytest --noconftest -o markers=cuda -m cuda tests/test_torch_kernel_cuda.py -q

Without a card every test here skips. Tolerances: f32 1e-5 (TF32 off; the
kernel sums taps in the plain version's order); bf16 1e-2 (both sum in f32
and round once to bf16: at most one bf16 ulp, 2^-8 relative).
"""

import numpy as np
import pytest
import torch

from sparse_rcnn_tpu_torch.ops import sparse_conv as SC

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
    before = SC.KERNEL.launches
    got = SC.sparse_conv(f, ix, tw)
    torch.cuda.synchronize()
    assert SC.KERNEL.launches == before + 1
    assert got.dtype == TORCH_DT[dt] and got.shape == (2, m_out, cout)
    want = SC.sparse_conv_reference(f, ix, tw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dt])


@pytest.mark.cuda
def test_cuda_kernel_refuses_mixed_dtypes(cuda_device):
    feats, idx, w = make_inputs(3, 8, 4, 4, 30, 20)
    f = torch.from_numpy(feats).to(cuda_device)
    ix = torch.from_numpy(idx).to(cuda_device)
    tw = torch.from_numpy(w).to(cuda_device, torch.bfloat16)
    before = SC.KERNEL.launches
    with pytest.raises(TypeError):
        SC.sparse_conv(f, ix, tw)
    assert SC.KERNEL.launches == before


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
    before = (SC.DGRAD.launches, SC.WGRAD.launches)
    d_f = SC.conv_dgrad(g, ti, tw)
    d_w = SC.conv_wgrad(f, ti, g)
    d_w2 = SC.conv_wgrad(f, ti, g)
    torch.cuda.synchronize()
    assert (SC.DGRAD.launches, SC.WGRAD.launches) == (before[0] + 1, before[1] + 2)
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
    before = (SC.DGRAD.launches, SC.WGRAD.launches)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (SC.DGRAD.launches, SC.WGRAD.launches) == (before[0] + 1, before[1] + 1)
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
    before = SC.WGRAD.launches
    d_w = SC.conv_wgrad(f, ti, g)
    d_w2 = SC.conv_wgrad(f, ti, g)
    torch.cuda.synchronize()
    assert SC.WGRAD.launches == before + 2
    assert d_w.dtype == torch.float32 and d_w.shape == (k, cin, cout)
    assert torch.equal(d_w, d_w2)                 # no atomics: bit-identical
    _wgrad_close(d_w, SC.sparse_conv_wgrad_reference(f, ti, g))
