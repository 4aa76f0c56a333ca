"""The port's masked dense tail against the JAX package, at the shapes of
``tests/parity/test_dense_tail.py`` (widths (6, 10, 14), extent 64³, 4096
points, batch 2).

Tolerances:
 * integer tables (site sets, rulebooks, occupancy, ``dense_tail_oob``) and
   the f32 scatter/gather with their backward: bit-exact (data movement only);
 * port dense-1 against JAX dense-1, f32, from one set of flax weights:
   1e-4 relative / 1e-5 absolute (the same f32 products summed in other
   orders through a few layers, as ``tests/test_torch_backbone.py``);
 * the same in bf16: 3e-2 of each scale's largest entry (a few bf16 roundings,
   2^-8 each, land on other sides in the two packages' conv orders);
 * port dense against port sparse after the weight conversion: 2e-3, the
   JAX package's own sparse ≡ dense tolerance (f32 sums of dense and of
   gathered products in different orders);
 * a dense-1 train step: loss parts 1e-5 relative, every gradient 1e-4 of
   its largest entry (as ``tests/test_torch_train.py``'s full loss).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.config import load_config as jax_load_config
from sparse_rcnn_tpu.models import losses as JLoss
from sparse_rcnn_tpu.models import unet as JU
from sparse_rcnn_tpu.ops import hierarchy as JH
from sparse_rcnn_tpu.ops import rulebook as JR
from sparse_rcnn_tpu.ops import voxelize as JV
from sparse_rcnn_tpu.train import loop as JTL
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.models import unet as PU
from sparse_rcnn_tpu_torch.models.layers import init_params
from sparse_rcnn_tpu_torch.models.convert import convert_backbone
from sparse_rcnn_tpu_torch.models.transfer import from_flax
from sparse_rcnn_tpu_torch.ops import hierarchy as PH
from sparse_rcnn_tpu_torch.ops import rulebook as PR
from sparse_rcnn_tpu_torch.ops import voxelize as PV
from sparse_rcnn_tpu_torch.train import loop as TL
from tests.test_torch_backbone import _random_variables
from tests.test_torch_sites import eq, site_table

WIDTHS = (6, 10, 14)
EXTENT = (64, 64, 64)
CAPS = (4096, 2048, 1024)
SCENE = dict(seed=3, batch_size=2, num_points=4096, num_instances=4, num_classes=5,
             extent=3.0)
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = 3e-2
SPARSE_TOL = dict(rtol=2e-3, atol=2e-3)
# the config of tests/parity/test_dense_tail.py's train step
OVERRIDES = {
    "data": {"num_points": 4096, "voxel_capacity": 4096, "batch_size": 2,
             "voxel_size": [0.05] * 3},
    "model": {"backbone": {"widths": list(WIDTHS), "blocks_per_scale": 1,
                           "dense_from_scale": 1, "grid_extent": list(EXTENT)},
              "rpn": {"hidden": 8, "num_proposals": 8, "pre_nms_topk": 32,
                      "rpn_scales": [0, 1]},
              "roi": {"grid_size": 4, "hidden": 8, "mask_grid": 8},
              "num_classes": 5, "max_instances": 8},
    "train": {"warmup_steps": 1, "total_steps": 10},
}
TRAIN_SCENE = dict(seed=0, batch_size=2, num_points=4096, num_instances=4, num_classes=5,
                   extent=3.0)


def _batch(spec=SCENE):
    kw = dict(spec)
    return synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)


def _port_tables(b, subm_scales):
    st, _, _ = PV.voxelize_batch(*(torch.from_numpy(b[k]) for k in ("points", "feats", "valid")),
                                 (0.05,) * 3, CAPS[0])
    st, _ = PV.rebase_coords(st)
    scales, hovf = PH.build_hierarchy(st, len(WIDTHS), CAPS, 3, subm_scales=subm_scales)
    assert int(hovf.sum()) == 0
    return st, scales


@jax.jit
def _jax_tables(points, feats, valid):
    st, _, _ = JV.voxelize_batch(points, feats, valid, jnp.asarray([0.05] * 3), CAPS[0])
    st, _ = JV.rebase_coords(st)
    return st, [JH.build_hierarchy(st, len(WIDTHS), CAPS, 3, subm_scales=s)[0] for s in (1, 2)]


@pytest.fixture(scope="module")
def tables():
    b = _batch()
    jst, jscales = _jax_tables(*(jnp.asarray(b[k]) for k in ("points", "feats", "valid")))
    return b, jst, dict(zip((1, 2), jscales))


@pytest.mark.parametrize("capacity", [512, 40])   # 40 overflows
def test_downsample_sites_bit_exact(rng, capacity):
    c, n = site_table(rng, 400, 512, -9, 9)
    want = jax.jit(JR.downsample_sites, static_argnums=(2, 3))(
        jnp.asarray(c), jnp.int32(n), 2, capacity)
    got = PR.downsample_sites(torch.from_numpy(c), torch.tensor(n, dtype=torch.int32), 2,
                              capacity)
    for name, a, w in zip(("coords", "n_out", "overflow"), got, want):
        eq(a, w, name)
    assert (int(want[2]) > 0) == (capacity == 40)
    # the site set of downsample_with_rulebooks, without its rulebooks
    full = PR.downsample_with_rulebooks(torch.from_numpy(c), torch.tensor(n, dtype=torch.int32),
                                        2, capacity)
    for a, w in zip(got, full[:3]):
        eq(a, w)


@pytest.mark.parametrize("subm_scales", [1, 2])
def test_build_hierarchy_subm_scales(tables, subm_scales):
    b, jst, jscales = tables
    st, scales = _port_tables(b, subm_scales)
    eq(st.coords, jst.coords, "coords")
    for s, (p, j) in enumerate(zip(scales, jscales[subm_scales])):
        for f in ("coords", "nvalid", "subm_idx", "down_idx", "up_idx"):
            if getattr(j, f) is None:
                assert getattr(p, f) is None, f"scale {s} {f}"
            else:
                eq(getattr(p, f), getattr(j, f), f"scale {s} {f}")
    # the last sparse scale keeps its rulebooks into the tail; the tail has none
    assert scales[subm_scales - 1].down_idx is not None
    assert all(sc.subm_idx is None for sc in scales[subm_scales:])


def test_scatter_gather_bit_exact(tables):
    """Scatter and gather at scale 1 with a live site moved outside the
    extent (dropped), forward and backward, against ``jax.vjp``."""
    b, _, _ = tables
    _, scales = _port_tables(b, 1)
    coords, nvalid = scales[1].coords.clone(), scales[1].nvalid
    coords[0, 3] = torch.tensor([40, 2, 5], dtype=torch.int32)       # x ≥ 32
    coords[1, 0] = torch.tensor([1, -1, 0], dtype=torch.int32)       # y < 0
    ext = tuple(e >> 1 for e in EXTENT)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, coords.shape[1], 5)).astype(np.float32)
    g_grid = rng.normal(size=(2, *ext, 5)).astype(np.float32)
    g_rows = rng.normal(size=feats.shape).astype(np.float32)
    jc, jn = jnp.asarray(coords.numpy()), jnp.asarray(nvalid.numpy())

    (jgrid, jocc), vjp = jax.vjp(lambda f: JU.scatter_to_grid(jc, jn, f, ext), jnp.asarray(feats))
    (jd_feats,) = vjp((jnp.asarray(g_grid), np.zeros(jocc.shape, jax.dtypes.float0)))
    f = torch.from_numpy(feats).requires_grad_()
    grid, occ = PU.scatter_to_grid(coords, nvalid, f, ext)
    (d_feats,) = torch.autograd.grad(grid, f, torch.from_numpy(g_grid))
    eq(grid.detach(), jgrid, "grid")
    eq(occ, jocc, "occ")
    eq(d_feats, jd_feats, "scatter backward")
    assert int(occ.sum()) == int(nvalid.sum()) - 2

    jrows, vjp = jax.vjp(lambda g: JU.gather_from_grid(g, jc, jn), jgrid)
    (jd_grid,) = vjp(jnp.asarray(g_rows))
    gr = grid.detach().requires_grad_()
    rows = PU.gather_from_grid(gr, coords, nvalid)
    (d_grid,) = torch.autograd.grad(rows, gr, torch.from_numpy(g_rows))
    eq(rows.detach(), jrows, "gather")
    eq(d_grid, jd_grid, "gather backward")
    assert not rows[0, 3].any() and not rows[1, 0].any()


def test_dense_tail_oob_counter():
    """``dense_tail_oob`` of ``prepare_inputs`` against JAX's with a grid too
    small for the scenes (and 0 at the test's own extent)."""
    b = _batch(TRAIN_SCENE)
    for ext, dropped in (((64, 64, 64), False), ((16, 16, 64), True)):
        ov = {**OVERRIDES, "model": {**OVERRIDES["model"], "backbone": {
            **OVERRIDES["model"]["backbone"], "grid_extent": list(ext)}}}
        want = jax.jit(lambda bb: JTL.prepare_inputs(jax_load_config(overrides=ov), bb)[4])(
            {k: jnp.asarray(v) for k, v in b.items()})
        aux = TL.prepare_inputs(load_config(overrides=ov), TL.to_device(b, "cpu",
                                                                         TL.TRAIN_KEYS))[4]
        for k in ("dense_tail_oob", "hierarchy_overflow", "voxel_overflow"):
            eq(aux[k], want[k], k)
        assert (int(aux["dense_tail_oob"]) > 0) == dropped


def _jax_unet_vars(dense, jst, jscales, rng):
    net = JU.SparseUNet(widths=WIDTHS, blocks_per_scale=1,
                        dense_from_scale=1 if dense else None,
                        grid_extent=EXTENT if dense else None)
    v = _random_variables(jax.eval_shape(
        lambda f, sc: net.init(jax.random.PRNGKey(0), f, sc, train=False),
        jst.feats, jscales), rng)
    return net, v


def _port_unet(state, dense, dtype=torch.float32):
    with torch.device("meta"):
        m = PU.SparseUNet(3, WIDTHS, dtype=dtype, dense_from_scale=1 if dense else None,
                          grid_extent=EXTENT if dense else None)
    m = m.to_empty(device="cpu")
    m.load_state_dict(state)
    return m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_dense1_per_scale_matches_jax(tables, dtype, train):
    b, jst, jscales = tables
    st, scales = _port_tables(b, 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    net, v = _jax_unet_vars(True, jst, jscales[1], np.random.default_rng(1))
    net = net.clone(dtype=jdt)
    want, upd = jax.jit(lambda v_, f, sc: net.apply(v_, f, sc, train, mutable=["batch_stats"]))(
        v, jst.feats, jscales[1])
    port = _port_unet(from_flax(jax.device_get(v["params"]), jax.device_get(v["batch_stats"])),
                      True, tdt).train(train)
    assert "dense_tail.up1_conv.weight" in port.state_dict()
    with torch.no_grad():
        got = port(st.feats, scales)
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == tdt and g.shape == (2, CAPS[s], WIDTHS[s])
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, err_msg=f"scale {s}", **TOL)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=BF16_TOL * np.abs(w).max(),
                                       err_msg=f"scale {s}")
    if train:     # the running statistics moved as flax's, once
        sd = port.state_dict()
        for k, val in from_flax({}, jax.device_get(upd["batch_stats"])).items():
            np.testing.assert_allclose(sd[k].numpy(), val.numpy(), err_msg=k,
                                       **(TOL if dtype == "float32" else
                                          dict(rtol=BF16_TOL, atol=BF16_TOL)))


def test_dense_matches_sparse_after_conversion(tables):
    """One set of sparse weights (seeded init, BN statistics and affine
    parameters made non-trivial) run fully sparse, and converted to dense-1
    and dense-2, give the same per-scale outputs."""
    b, _, _ = tables
    with torch.device("meta"):
        sparse = PU.SparseUNet(3, WIDTHS)
    sparse = init_params(sparse.to_empty(device="cpu"), torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    sparse_sd = {k: (torch.rand(v.shape, generator=gen) + 0.5 if k.endswith((".var", ".scale"))
                     else torch.randn(v.shape, generator=gen) * 0.3 if k.endswith((".mean", ".bias"))
                     else v) for k, v in sparse.state_dict().items()}
    st, scales_sp = _port_tables(b, None)
    with torch.no_grad():
        want = _port_unet(sparse_sd, False).eval()(st.feats, scales_sp)
        for s0 in (1, 2):
            with torch.device("meta"):
                m = PU.SparseUNet(3, WIDTHS, dense_from_scale=s0, grid_extent=EXTENT)
            m = m.to_empty(device="cpu")
            m.load_state_dict(convert_backbone(sparse_sd, s0))
            got = m.eval()(st.feats, _port_tables(b, s0)[1])
            for s, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"dense-{s0} scale {s}",
                                           **SPARSE_TOL)


@jax.jit
def _jax_step(params, batch_stats, batch):
    cfg = jax_load_config(overrides=OVERRIDES)
    model = JTL.build_model(cfg)
    st, _, scales, gt, _ = JTL.prepare_inputs(cfg, batch)

    def loss_fn(p):
        out, upd = model.apply({"params": p, "batch_stats": batch_stats}, st.feats, scales,
                               train=True, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid,
                               mutable=["batch_stats"])
        _, parts = JTL.compute_losses(cfg, out, scales, gt, st.row_mask)
        return JLoss.total_loss(parts, cfg.train.loss_weights), (parts, upd["batch_stats"])

    (total, (parts, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return total, parts, grads, stats


def jax_variables(overrides, batch, rng):
    """Random flax variables of the JAX detector of ``overrides``, in its
    train form (from ``jax.eval_shape``, which compiles nothing; see
    ``_random_variables``)."""
    cfg = JTL.train_cfg(jax_load_config(overrides=overrides))
    st, _, scales, _, _ = jax.eval_shape(lambda bt: JTL.prepare_inputs(cfg, bt), batch)
    v = _random_variables(jax.eval_shape(
        lambda f, sc: JTL.build_model(cfg).init(jax.random.PRNGKey(0), f, sc, train=False),
        st.feats, scales), rng)
    return jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def test_dense1_train_step_matches_jax():
    b = _batch(TRAIN_SCENE)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    params, stats = jax_variables(OVERRIDES, batch, np.random.default_rng(3))
    assert "dense_tail" in params["backbone"]
    jtotal, jparts, jgrads, jstats = jax.device_get(_jax_step(params, stats, batch))
    cfg = load_config(overrides=OVERRIDES)
    model = TL.build_model(cfg, "cpu")
    model.load_state_dict(from_flax(params, stats))
    total, parts, grads, aux = TL.loss_and_grads(cfg, model, TL.to_device(b, "cpu",
                                                                         TL.TRAIN_KEYS))
    assert int(aux["dense_tail_oob"]) == 0
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    jg = from_flax(jgrads, {})
    assert sorted(names) == sorted(jg)
    for name, g in zip(names, grads):
        want = jg[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=name)
    assert grads[names.index("backbone.dense_tail.enc2_block0.conv1.weight")].any()
    sd = model.state_dict()
    for k, v in from_flax({}, jstats).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), err_msg=k, **TOL)


# the eval form (dense-1) and the train form (dense-2) of one per-mode config
FORMS_CFG = {**OVERRIDES, "model": {**OVERRIDES["model"], "backbone": {
    **OVERRIDES["model"]["backbone"], "dense_from_scale_train": 2}}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["eval", "train"])
def test_scene_alone_equals_scene_in_batch(dtype, form):
    """With a dense tail, each scene's eval outputs at batch 2 are
    ``torch.equal`` to that scene run alone, as the JAX package's are: the
    tail's convs see one scene at a time, so the conv library cannot pick
    another algorithm (another order of sums) for another batch shape."""
    cfg = load_config(overrides={**FORMS_CFG, "model": {**FORMS_CFG["model"], "backbone": {
        **FORMS_CFG["model"]["backbone"], "dtype": dtype}}})
    if form == "train":
        cfg = TL.train_cfg(cfg)
    assert cfg.model.backbone.dense_from_scale == (1 if form == "eval" else 2)
    model = TL.build_model(cfg, "cpu", torch.Generator().manual_seed(0))
    batch = TL.to_device(_batch(SCENE), "cpu")
    both = TL.eval_step(cfg, model, batch)
    for b in range(2):
        alone = TL.eval_step(cfg, model, {k: v[b:b + 1] for k, v in batch.items()})
        for key in ("point_mask_logits", "proposal_scores", "cls_logits"):
            assert both[key].dtype == alone[key].dtype
            assert torch.equal(both[key][b:b + 1], alone[key]), (key, b)
