"""The gather-form backwards of the RoI crop and the bf16 mask read
(``sparse_rcnn_tpu_torch/ops/index_grad.py``) on the CPU, where they run
their plain versions, against the JAX package; their maps against numpy.

- gradients of ``sample_trilinear`` and ``sample_mask_at_positions`` against
  ``jax.vjp`` of the JAX functions on the same numpy inputs, f32 and bf16;
- forward values and CPU gradients bit-equal to the composite ops the port
  ran before (``feats[safe] * live * w`` summed over corners; the 4-index
  bf16 read), with autograd's own backward of those ops;
- each map's permutation and offsets exactly a numpy stable argsort, dead
  corners out; the mask map with ``keep`` holds the kept entries only, the
  others past ``offsets[rows]``, and gives each kept entry its lane in
  ``index_put_``'s pass over the whole run (an all-outside proposal, a long
  run inside one cell);
- the mask loss's cotangent is exactly 0 wherever it weights a point by 0
  (outside a box, a slot whose box holds no point), so a sum that leaves
  them out is the same
  sum: the mask kernel's order over the map with ``keep`` (emulated in
  numpy float32) is bit-equal to CUDA ``index_put_``'s over every entry
  (emulated the same way) on the train path's real inputs, and a sum over
  the kept entries alone in ``index_put_``'s pattern is not, in general;
  the training loss passes its weights as ``keep``, and the painter hands
  them to each scene's read;
- ``mask_read`` without ``keep`` reads and differentiates as before;
- a forward under ``torch.no_grad()``, or on the CPU, builds no map; the
  kernels' wrappers refuse CPU tensors.

Tolerances: f32 gradients 1e-5 (sums of a few products in another order);
bf16 1e-2 of the largest entry (each package rounds each product and its
sums to bf16 at other places: a few bf16 ulps of 2^-8).
"""

from types import SimpleNamespace

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
from sparse_rcnn_tpu_torch.models.targets import roi_targets
from sparse_rcnn_tpu_torch.native import libraries as NL
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


def numpy_lanes(key, rows):
    """Each entry's lane in CUDA ``index_put_``'s pass over its row's whole
    run: its rank f in the run (stable), f mod 32 where f < 32 floor(n / 32),
    else ``IG.TAIL``."""
    order, off = numpy_map(key, rows)
    rank = np.empty_like(key)
    rank[order] = np.arange(key.size) - off[key[order]]
    tail = np.diff(off)[key] // 32 * 32
    return np.where(rank < tail, rank % 32, IG.TAIL)


def test_mask_read_map_matches_numpy(rng):
    p, cells, n = 5, 27, 400
    cell = rng.integers(0, cells, (p, n)).astype(np.int32)
    cell[1] = 0                                  # one proposal into one cell
    cell[2, :300] = cells - 1                    # a long run on its border cell
    perm, offsets, lanes = IG.mask_read_map(T(cell), cells)
    key = (cell + np.arange(p)[:, None] * cells).ravel()
    want_perm, want_off = numpy_map(key, p * cells)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    assert offsets[-1] == p * n
    assert lanes.dtype == torch.uint8
    np.testing.assert_array_equal(lanes.numpy(), numpy_lanes(key, p * cells)[want_perm])


def mask_map_case(rng, case, p=6, cells=27, n=500):
    """(cell, keep) of a mask read: random cells, about 30 % of the points
    kept; ``all_outside`` keeps no point of proposal 1 (a box that holds no
    point; its points all on one border cell); ``long_inside_run`` keeps 300
    points of proposal 2 in one cell, among outside points on the same
    cell."""
    cell = rng.integers(0, cells, (p, n)).astype(np.int32)
    keep = rng.random((p, n)) < 0.3
    if case == "all_outside":
        keep[1] = False
        cell[1] = cells - 1
    elif case == "long_inside_run":
        cell[2, :450] = 13
        keep[2] = False
        keep[2, rng.choice(450, 300, replace=False)] = True
    return cell, keep


@pytest.mark.parametrize("case", ["random", "all_outside", "long_inside_run"])
def test_mask_read_map_with_keep_matches_numpy(rng, case):
    cell, keep = mask_map_case(rng, case)
    p, n = cell.shape
    cells, rows = 27, cell.shape[0] * 27
    perm, offsets, lanes = IG.mask_read_map(T(cell), cells, T(keep))
    key = (cell + np.arange(p)[:, None] * cells).ravel()
    want_perm, want_off = numpy_map(np.where(keep.ravel(), key, rows), rows)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    kept = int(keep.sum())
    assert offsets[-1] == kept and not keep.ravel()[perm[kept:].numpy()].any()
    np.testing.assert_array_equal(lanes[:kept].numpy(), numpy_lanes(key, rows)[want_perm[:kept]])
    if case == "all_outside":
        assert (offsets[cells:2 * cells + 1] == offsets[cells]).all()
    elif case == "long_inside_run":
        assert offsets.diff().max() == 300 and (lanes[:kept] < IG.TAIL).any()


def run_sum(v, lanes):
    """A run's f32 sum as CUDA ``index_put_`` adds it (``csrc/index_grad.cu``):
    lane l adds the values whose lane is l, in order, a shuffle-down tree
    sums the 32 lanes into lane 0, which adds the tail (lane ``IG.TAIL``) in
    order."""
    acc = np.zeros(32, np.float32)
    for x, l in zip(v, lanes):
        if l < IG.TAIL:
            acc[l] = np.float32(acc[l] + x)
    for off in (16, 8, 4, 2, 1):
        acc[:off] = (acc[:off] + acc[off:2 * off]).astype(np.float32)
    total = acc[0]
    for x, l in zip(v, lanes):
        if l == IG.TAIL:
            total = np.float32(total + x)
    return total


def bf16_bits(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).view(torch.int16)


def index_put_order(g, key, rows):
    """CUDA ``index_put_(accumulate=True)`` of g (float32 holding bf16
    values) at the rows ``key`` into zeros, every entry, as bf16 bits."""
    order, off = numpy_map(key, rows)
    lanes = numpy_lanes(key, rows)
    out = np.zeros(rows, np.float32)
    for r in np.flatnonzero(np.diff(off)):
        e = order[off[r]:off[r + 1]]
        out[r] = run_sum(g[e], lanes[e])
    return bf16_bits(out)


def kernel_order(g, rmap, rows):
    """The ``mask_read_grad`` kernel's sum over a map, as bf16 bits."""
    perm, offsets, lanes = (t.numpy() for t in rmap)
    out = np.zeros(rows, np.float32)
    for r in range(rows):
        i = slice(offsets[r], offsets[r + 1])
        out[r] = run_sum(g[perm[i]], lanes[i])
    return bf16_bits(out)


def test_lanes_keep_index_put_grouping():
    """Why the mask map carries lanes: one row of 64 entries whose kept
    entries (ranks 1, 2 and 3: lanes 1, 2, 3) are a, -a and a small c.
    ``index_put_`` over the whole run adds them as b + (a + c) (the tree
    pairs lanes 0-2 and 1-3 first); the kept entries alone, fewer than 32,
    would be a sequential (a + b) + c = c, which rounds to another bf16."""
    a, c = np.float32(0.11376953), np.float32(-8.08388e-07)   # both bf16 values
    g = np.zeros((1, 64), np.float32)
    g[0, 1:4] = a, -a, c
    keep = g != 0
    cell = np.zeros((1, 64), np.int32)
    want = index_put_order(g.ravel(), cell.ravel(), 1)
    rmap = IG.mask_read_map(T(cell), 1, T(keep))
    assert torch.equal(kernel_order(g.ravel(), rmap, 1), want)
    alone = np.float32(np.float32(a - a) + c)
    assert not torch.equal(bf16_bits([alone]), want)


def test_outside_box_entries_carry_zero_cotangent():
    """The premise under which the mask read's backward may leave a point
    out: the training loss passes as ``keep`` the entries it weights
    (``mask_weight > 0``: inside the box, live, a foreground proposal), and
    ``models/losses.py::masked_mean`` weights every other one by 0, so its
    cotangent is exactly 0 (at points outside a box, and in a slot whose box
    holds no point); the plain sum with them left out is then the same bit
    for bit."""
    cfg = load_config(overrides=OVERRIDES)
    model = TL.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    batch = TL.to_device(_batch(), "cpu", TL.TRAIN_KEYS)
    reads = []
    real = PDet.sample_mask_at_positions

    def record(ml, boxes, pos, keep=None):
        logits, inside = real(ml, boxes, pos, keep)
        logits.retain_grad()
        reads.append((ml, boxes, pos, logits, inside, keep))
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
    tt = roi_targets(out["crop_boxes"], out["proposal_mask"], scales[0].coords,
                        scales[0].nvalid, gt, cfg.model)
    keep = torch.stack([r[5] for r in reads])
    assert torch.equal(keep, tt.mask_weight > 0)
    g_all = torch.stack([r[3].grad for r in reads])
    inside = torch.stack([r[4] for r in reads])
    assert (~inside).any() and not keep[~inside].any() and g_all[keep].abs().max() > 0
    assert torch.equal(g_all[~keep], torch.zeros_like(g_all[~keep]))
    empty = ~inside.any(-1)                      # slots whose box holds no point
    assert empty.any() and torch.equal(g_all[empty], torch.zeros_like(g_all[empty]))
    for ml, boxes, pos, logits, _, kp in reads:
        g = logits.grad.to(torch.bfloat16)
        grid = ml.shape[-1]
        cell = torch.stack([torch.clamp((pos[None, :, a] - boxes[:, a:a + 1])
                                        / torch.clamp(boxes[:, 3 + a:4 + a] - boxes[:, a:a + 1],
                                                      min=1e-6) * grid, -1.0, float(grid))
                            .to(torch.int32).clamp(0, grid - 1) for a in range(3)])
        cell = (cell[0] * grid + cell[1]) * grid + cell[2]
        with TL.deterministic_on_cpu("cpu"):
            every = IG.mask_read_grad_reference(g, cell, grid ** 3)
            left_out = IG.mask_read_grad_reference(torch.where(kp, g, 0), cell, grid ** 3)
        assert torch.equal(every, left_out)
        # the card's order: the kernel over the map of the kept points is
        # CUDA index_put_ over every point, bit for bit
        rows = cell.shape[0] * grid ** 3
        key = (cell + torch.arange(cell.shape[0])[:, None] * grid ** 3).reshape(-1).numpy()
        gf = g.float().reshape(-1).numpy()
        rmap = IG.mask_read_map(cell, grid ** 3, kp)
        assert torch.equal(kernel_order(gf, rmap, rows), index_put_order(gf, key, rows))


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
    before = dict(NL.LAUNCHES)
    with pytest.raises(ValueError):
        IG.roi_crop_grad_kernel(g, torch.zeros(8, 10), rmap, 5)
    cell = torch.zeros(2, 5, dtype=torch.int32)
    for keep in (torch.ones(2, 5, dtype=torch.bool), None):
        with pytest.raises(ValueError):
            IG.mask_read_map_kernel(cell, 3, keep)
    with pytest.raises(ValueError):
        IG.mask_read_grad_kernel(torch.zeros(2, 5, dtype=torch.bfloat16),
                                 IG.mask_read_map(cell, 3), 6)
    assert dict(NL.LAUNCHES) == before


def test_mask_read_without_keep_as_before(rng, monkeypatch):
    """``mask_read`` without ``keep``: the same values and CPU gradient as
    the 4-index read it replaced, and on meta tensors (the card's stand-in)
    a map of every entry."""
    ml, boxes, pos, g_out = mask_inputs(rng)
    p, grid = ml.shape[0], ml.shape[-1]
    _, inside = PHd.sample_mask_at_positions(T(ml), T(boxes), T(pos))
    cell = torch.from_numpy(rng.integers(0, grid ** 3, (p, pos.shape[0])).astype(np.int32))
    grads = []
    for keep in (None, inside):
        m = T(ml).to(torch.bfloat16).requires_grad_(True)
        out = IG.mask_read(m, cell, keep)
        out.backward(T(g_out).to(torch.bfloat16))
        grads.append((out.detach(), m.grad))
    m = T(ml).to(torch.bfloat16)
    want = m.reshape(p, -1)[torch.arange(p)[:, None], cell.long()]
    assert torch.equal(grads[0][0], want) and torch.equal(grads[1][0], want)
    assert torch.equal(grads[0][1], grads[1][1])    # the CPU adds every entry either way
    calls = []
    real = IG.mask_read_map
    monkeypatch.setattr(IG, "mask_read_map", lambda *a: calls.append(a) or real(*a))
    IG.mask_read(m.to("meta").requires_grad_(True), cell.to("meta"))
    assert len(calls) == 1 and calls[0][2] is None


def test_painter_passes_keep_to_the_read(rng, monkeypatch):
    """``paint_instance_masks`` hands each scene's ``keep`` to its read (no
    ``keep``: every entry), and the logits do not depend on it."""
    ml, boxes, pos, _ = mask_inputs(rng)
    keep = torch.from_numpy(rng.random((2, ml.shape[0], pos.shape[0])) < 0.5)
    out = {"mask_logits": T(np.stack([ml, ml[::-1]])),
           "crop_boxes": T(np.stack([boxes, boxes[::-1]]))}
    scales = [SimpleNamespace(coords=T(np.stack([pos, pos]) - 0.5))]    # centres at pos
    calls = []
    real = IG.mask_read
    monkeypatch.setattr(IG, "mask_read", lambda m, c, k=None: calls.append(k) or real(m, c, k))
    got = [PDet.paint_instance_masks(out, scales, masked=False, keep=k) for k in (None, keep)]
    assert calls[:2] == [None, None]
    assert torch.equal(calls[2], keep[0]) and torch.equal(calls[3], keep[1])
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
