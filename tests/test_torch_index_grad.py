"""The gather-form backwards of the RoI crop and the bf16 mask read
(``sparse_rcnn_tpu_torch/ops/index_grad.py``) on the CPU, where they run
their plain versions, against the JAX package; their maps against numpy.

- gradients of ``sample_trilinear`` and ``sample_mask_at_positions`` against
  ``jax.vjp`` of the JAX functions on the same numpy inputs, f32 and bf16;
- forward values and CPU gradients bit-equal to the composite ops the port
  ran before (``feats[safe] * live * w`` summed over corners; the 4-index
  bf16 read), with autograd's own backward of those ops;
- each map's permutation and offsets exactly a numpy stable argsort, dead
  corners out;
- the mask loss's cotangent is exactly 0 at points outside a box, so a sum
  that leaves them out is the same sum (on the card every entry stays: see
  ``csrc/index_grad.cu``);
- a forward under ``torch.no_grad()``, or on the CPU, builds no map; the
  kernels' wrappers refuse CPU tensors.

Tolerances: f32 gradients 1e-5 (sums of a few products in another order);
bf16 1e-2 of the largest entry (each package rounds each product and its
sums to bf16 at other places: a few bf16 ulps of 2^-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.models import heads as JHd
from sparse_rcnn_tpu.ops import roi as JRoi
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.models import detector as PDet
from sparse_rcnn_tpu_torch.models import heads as PHd
from sparse_rcnn_tpu_torch.ops import index_grad as IG
from sparse_rcnn_tpu_torch.ops import roi as PRoi
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_heads import _site_table, random_boxes
from tests.test_torch_train import OVERRIDES, _batch

T = torch.from_numpy
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def crop_inputs(rng, c=16, p=6, d=3):
    """A table of 500 sites in 512 rows, feats [512, c], and the D³ sample
    positions of p boxes, some reaching past the occupied cube (dead
    corners, clamped to row 0 by the composite)."""
    coords, n = _site_table(rng, 500, 512)
    feats = rng.normal(size=(512, c)).astype(np.float32)
    feats[n:] = 0
    boxes = random_boxes(rng, p, span=10.0)
    pos = np.array(JRoi.roi_grid_positions(jnp.asarray(boxes), d))
    g_out = rng.normal(size=pos.shape[:-1] + (c,)).astype(np.float32)
    return coords, n, feats, pos, g_out


def composite_trilinear(coords, n, feats, pos):
    """The crop as the port computed it before (``ops/roi.py``)."""
    m = coords.shape[0]
    table = PRoi._table(coords, n)
    q = pos - 0.5
    base = torch.floor(q).to(torch.int32)
    frac = q - base
    offs = torch.tensor(PRoi._CORNERS, dtype=torch.int32).reshape(8, 1, 1, 3)
    w = torch.prod(torch.where(offs > 0, frac[None], 1.0 - frac[None]), dim=-1)
    idx = PRoi.coord_ops.table_lookup_bulk(table, PRoi.coord_ops.pack_coords(base[None] + offs))
    safe = idx.clamp(0, m - 1).to(torch.int64)
    val = feats[safe] * (idx >= 0)[..., None].to(feats.dtype)
    return torch.sum(val * w[..., None].to(feats.dtype), dim=0)


def composite_mask_read(ml, boxes, pos):
    """The 4-index bf16 read the port ran before (``models/heads.py``)."""
    g, p = ml.shape[-1], ml.shape[0]
    cells = []
    for a in range(3):
        lo, hi = boxes[:, a:a + 1], boxes[:, 3 + a:4 + a]
        rel = (pos[None, :, a] - lo) / torch.clamp(hi - lo, min=1e-6)
        cell = torch.clamp(rel * g, -1.0, float(g)).to(torch.int32)
        cells.append(cell.clamp(0, g - 1).to(torch.int64))
    cx, cy, cz = cells
    prow = torch.arange(p)[:, None]
    return ml.to(torch.bfloat16)[prow, cx, cy, cz].to(ml.dtype)


def mask_inputs(rng, p=5, g=6, n=300):
    ml = rng.normal(size=(p, g, g, g)).astype(np.float32)
    boxes = random_boxes(rng, p, span=6.0)
    boxes[-1] = [40, 40, 40, 41, 41, 41]                 # a box that holds no point
    pos = np.concatenate([rng.uniform(-2, 14, (n, 3)),
                          [[32767.5, 32767.5, 32767.5]]]).astype(np.float32)
    g_out = rng.normal(size=(p, n + 1)).astype(np.float32)
    return ml, boxes, pos, g_out


def jax_vjp(fn, x, ct):
    """(fn(x), its vjp at the cotangent ct), jitted as one program."""
    @jax.jit
    def run(x, ct):
        out, vjp = jax.vjp(fn, x)
        return out, vjp(ct)[0]
    return run(x, ct)


def close_to_max(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("dt", DTYPES)
def test_sample_trilinear_grad_matches_jax(rng, dt):
    tdt, jdt = DTYPES[dt]
    coords, n, feats, pos, g_out = crop_inputs(rng)
    f = T(feats).to(tdt).requires_grad_(True)
    out = PRoi.sample_trilinear(T(coords), torch.tensor(n), f, T(pos))
    out.backward(T(g_out).to(tdt))
    want_out, want = jax_vjp(lambda x: JRoi.sample_trilinear(
        jnp.asarray(coords), jnp.int32(n), x, jnp.asarray(pos)), jnp.asarray(feats, jdt),
        jnp.asarray(g_out, jdt))
    if dt == "float32":
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), 1e-5, 1e-5)
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(want), 1e-5, 1e-5)
    else:
        close_to_max(out.detach().float(), want_out, 1e-2)
        close_to_max(f.grad.float(), want, 1e-2)
    assert f.grad[n:].abs().max() == 0 and f.grad[:n].abs().max() > 0


@pytest.mark.parametrize("dt", DTYPES)
def test_sample_mask_grad_matches_jax(rng, dt):
    tdt, jdt = DTYPES[dt]
    ml, boxes, pos, g_out = mask_inputs(rng)
    m = T(ml).to(tdt).requires_grad_(True)
    logits, inside = PHd.sample_mask_at_positions(m, T(boxes), T(pos))
    logits.backward(T(g_out).to(tdt))
    _, want = jax_vjp(lambda x: JHd.sample_mask_at_positions(
        x, jnp.asarray(boxes), jnp.asarray(pos))[0], jnp.asarray(ml, jdt), jnp.asarray(g_out, jdt))
    close_to_max(m.grad.float(), want, 1e-2 if dt == "bfloat16" else 1e-5)
    assert not inside[-1].any()


@pytest.mark.parametrize("dt", DTYPES)
def test_forward_and_cpu_backward_bit_equal_to_composite(rng, dt):
    tdt = DTYPES[dt][0]
    coords, n, feats, pos, g_out = crop_inputs(rng)
    grads = []
    for fn in (PRoi.sample_trilinear, composite_trilinear):
        f = T(feats).to(tdt).requires_grad_(True)
        with TL.deterministic_on_cpu("cpu"):
            out = fn(T(coords), torch.tensor(n), f, T(pos))
            out.backward(T(g_out).to(tdt))
        grads.append((out.detach(), f.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])

    ml, boxes, pos, g_out = mask_inputs(rng)
    grads = []
    for fn in (lambda *a: PHd.sample_mask_at_positions(*a)[0], composite_mask_read):
        m = T(ml).to(tdt).requires_grad_(True)
        with TL.deterministic_on_cpu("cpu"):
            out = fn(m, T(boxes), T(pos))
            out.backward(T(g_out).to(tdt))
        grads.append((out.detach(), m.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


def test_crop_weight_grad_as_composite(rng):
    """Positions carry no gradient in the model, but a caller's may: the
    sampling weights then get the composite's own backward."""
    coords, n, feats, pos, g_out = crop_inputs(rng)
    grads = []
    for fn in (PRoi.sample_trilinear, composite_trilinear):
        p = T(pos).requires_grad_(True)
        fn(T(coords), torch.tensor(n), T(feats), p).backward(T(g_out))
        grads.append(p.grad)
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)


def numpy_map(key, rows):
    order = np.argsort(key, kind="stable")
    return order, np.searchsorted(key[order], np.arange(rows + 1), side="left")


@pytest.mark.parametrize("case", ["random", "all_dead", "one_row", "few_rows"])
def test_roi_crop_map_matches_numpy(rng, case):
    m = 200
    idx = rng.integers(0, m, (8, 4, 27)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.4] = -1
    if case == "all_dead":
        idx[:] = -1
    elif case == "one_row":                     # every entry into row 7
        idx[:] = 7
    elif case == "few_rows":
        m = 3
        idx = np.where(idx >= 0, idx % 3, -1).astype(np.int32)
    perm, offsets = IG.roi_crop_map(T(idx), m)
    key = np.where(idx >= 0, idx, m).ravel()
    want_perm, want_off = numpy_map(key, m)
    assert perm.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    live = int((idx >= 0).sum())
    assert offsets[-1] == live and (idx.ravel()[perm[live:].numpy()] < 0).all()


def test_mask_read_map_matches_numpy(rng):
    p, cells, n = 5, 27, 400
    cell = rng.integers(0, cells, (p, n)).astype(np.int32)
    cell[1] = 0                                  # one proposal into one cell
    cell[2, :300] = cells - 1                    # a long run on its border cell
    perm, offsets = IG.mask_read_map(T(cell), cells)
    want_perm, want_off = numpy_map((cell + np.arange(p)[:, None] * cells).ravel(), p * cells)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    assert offsets[-1] == p * n


def test_outside_box_entries_carry_zero_cotangent():
    """The premise under which the mask read's backward may leave a point
    out: ``models/losses.py::masked_mean`` weights the mask loss by 0 at
    points outside the box, so their cotangent is exactly 0; the plain sum
    with them left out is then the same bit for bit."""
    cfg = load_config(overrides=OVERRIDES)
    model = TL.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    batch = TL.to_device(_batch(), "cpu", TL.TRAIN_KEYS)
    reads = []
    real = PDet.sample_mask_at_positions

    def record(ml, boxes, pos):
        logits, inside = real(ml, boxes, pos)
        logits.retain_grad()
        reads.append((ml, boxes, pos, logits, inside))
        return logits, inside

    st, _, scales, gt, _ = TL.prepare_inputs(cfg, batch)
    model.train()
    PDet.sample_mask_at_positions = record
    try:
        out = model(st.feats, scales, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid)
        total, _ = TL.compute_losses(cfg, out, scales, gt, st.row_mask)
    finally:
        PDet.sample_mask_at_positions = real
    total.backward()
    assert len(reads) == cfg.data.batch_size
    g_all = torch.stack([r[3].grad for r in reads])
    inside = torch.stack([r[4] for r in reads])
    assert (~inside).any() and g_all[inside].abs().max() > 0
    assert torch.equal(g_all[~inside], torch.zeros_like(g_all[~inside]))
    for ml, boxes, pos, logits, ins in reads:
        g = logits.grad.to(torch.bfloat16)
        grid = ml.shape[-1]
        cell = torch.stack([torch.clamp((pos[None, :, a] - boxes[:, a:a + 1])
                                        / torch.clamp(boxes[:, 3 + a:4 + a] - boxes[:, a:a + 1],
                                                      min=1e-6) * grid, -1.0, float(grid))
                            .to(torch.int32).clamp(0, grid - 1) for a in range(3)])
        cell = (cell[0] * grid + cell[1]) * grid + cell[2]
        with TL.deterministic_on_cpu("cpu"):
            every = IG.mask_read_grad_reference(g, cell, grid ** 3)
            left_out = IG.mask_read_grad_reference(torch.where(ins, g, 0), cell, grid ** 3)
        assert torch.equal(every, left_out)


def test_no_map_without_a_gradient_or_on_the_cpu(rng, monkeypatch):
    """Meta tensors stand in for the card's: the map is built in a forward
    that wants a gradient, never under ``torch.no_grad()``, and never for a
    CPU tensor (whose backward is the plain version)."""
    calls = []
    for name in ("roi_crop_map", "mask_read_map"):
        real = getattr(IG, name)
        monkeypatch.setattr(IG, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    coords, n, feats, pos, _ = crop_inputs(rng)
    ml, boxes, mpos, _ = mask_inputs(rng)

    def both(dev, grad):
        f = T(feats).to(dev).requires_grad_(grad)
        PRoi.sample_trilinear(T(coords).to(dev), torch.tensor(n, device=dev), f,
                              T(pos).to(dev))
        PHd.sample_mask_at_positions(T(ml).to(dev).requires_grad_(grad), T(boxes).to(dev),
                                     T(mpos).to(dev))

    both("meta", True)
    assert calls == ["roi_crop_map", "mask_read_map"]
    with torch.no_grad():
        both("meta", True)
    both("meta", False)
    both("cpu", True)
    assert calls == ["roi_crop_map", "mask_read_map"]


def test_kernel_wrappers_refuse_cpu_tensors():
    g = torch.zeros(10, 4)
    rmap = IG.roi_crop_map(torch.full((8, 10), -1, dtype=torch.int32), 5)
    before = (IG.ROI_CROP_GRAD.launches, IG.MASK_READ_GRAD.launches)
    with pytest.raises(ValueError):
        IG.ROI_CROP_GRAD(g, torch.zeros(8, 10), rmap, 5)
    with pytest.raises(ValueError):
        IG.MASK_READ_GRAD(torch.zeros(2, 5, dtype=torch.bfloat16),
                          IG.mask_read_map(torch.zeros(2, 5, dtype=torch.int32), 3), 6)
    assert (IG.ROI_CROP_GRAD.launches, IG.MASK_READ_GRAD.launches) == before
