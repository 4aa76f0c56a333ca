"""Site tables of the port against the JAX package: SparseTensor
construction, coordinate dedup, voxelization, rebase, devoxelize, every rulebook and the hierarchy. All
integer tables bit-exact, overflowing scenes included; voxel features (f32
segment means) to 1e-6."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu import sparse as JS
from sparse_rcnn_tpu.ops import coords as JC
from sparse_rcnn_tpu.ops import hierarchy as JH
from sparse_rcnn_tpu.ops import rulebook as JR
from sparse_rcnn_tpu.ops import voxelize as JV
from sparse_rcnn_tpu_torch import sparse as PS
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.ops import coords as PC
from sparse_rcnn_tpu_torch.ops import hierarchy as PH
from sparse_rcnn_tpu_torch.ops import rulebook as PR
from sparse_rcnn_tpu_torch.ops import voxelize as PV
from sparse_rcnn_tpu_torch.train import loop as TL

SENT = PC.COORD_OFFSET - 1
CONFIG1 = os.path.join(os.path.dirname(__file__), "..", "configs", "config1_tiny_5cm.yaml")


def eq(port, ref, what=""):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref), err_msg=what)


def site_table(rng, n, cap, lo=-6, hi=6):
    c = np.unique(rng.integers(lo, hi, size=(n, 3)).astype(np.int32), axis=0)
    c = c[np.lexsort((c[:, 2], c[:, 1], c[:, 0]))][:cap]
    pad = np.full((cap, 3), SENT, np.int32)
    pad[:len(c)] = c
    return pad, len(c)


@pytest.mark.parametrize("capacity", [512, 100])   # 100 overflows
def test_unique_coords(rng, capacity):
    c = rng.integers(-5, 5, size=(600, 3)).astype(np.int32)
    valid = rng.random(600) < 0.9
    ref = jax.jit(JC.unique_coords, static_argnums=2)(jnp.asarray(c), jnp.asarray(valid),
                                                       capacity)
    got = PC.unique_coords(torch.from_numpy(c), torch.from_numpy(valid), capacity)
    for name, a, b in zip(("ucoords", "n_unique", "inverse", "overflow"), got, ref):
        eq(a, b, name)
    assert (int(ref[3]) > 0) == (capacity == 100)


def test_make_sparse_tensor(rng):
    """Rows sorted per scene (duplicates in input order), padding rewritten
    to the sentinel and zero features."""
    c = rng.integers(-4, 4, size=(2, 40, 3)).astype(np.int32)
    f = rng.normal(size=(2, 40, 5)).astype(np.float32)
    n = np.array([30, 7], np.int32)
    ref = JS.make_sparse_tensor(jnp.asarray(c), jnp.asarray(f), jnp.asarray(n))
    got = PS.make_sparse_tensor(torch.from_numpy(c), torch.from_numpy(f), torch.from_numpy(n))
    eq(got.coords, ref.coords, "coords")
    eq(got.feats, ref.feats, "feats")
    eq(got.nvalid, ref.nvalid, "nvalid")
    assert (got.coords[1, 7:] == SENT).all() and not got.feats[1, 7:].any()


def test_kernel_offsets():
    for k, centered in ((3, True), (1, True), (2, False)):
        eq(PC.kernel_offsets(k, centered), JC.kernel_offsets(k, centered))


@pytest.mark.parametrize("capacity", [1024, 300])   # 300 overflows
def test_voxelize_rebase_devoxelize(capacity):
    b = synthetic.generate_batch(3, 2, num_points=1024, num_instances=4)
    vs = (0.25, 0.25, 0.25)
    jst, jp2v, jovf = jax.jit(JV.voxelize_batch, static_argnums=4)(
        jnp.asarray(b["points"]), jnp.asarray(b["feats"]), jnp.asarray(b["valid"]),
        jnp.asarray(vs), capacity)
    pst, pp2v, povf = PV.voxelize_batch(torch.from_numpy(b["points"]),
                                        torch.from_numpy(b["feats"]),
                                        torch.from_numpy(b["valid"]), vs, capacity)
    eq(pst.coords, jst.coords, "coords")
    eq(pst.nvalid, jst.nvalid, "nvalid")
    eq(pp2v, jp2v, "p2v")
    eq(povf, jovf, "overflow")
    assert (int(jovf.sum()) > 0) == (capacity == 300)
    np.testing.assert_allclose(pst.feats.numpy(), np.asarray(jst.feats), rtol=1e-6, atol=1e-6)

    jst2, jbase = jax.jit(JV.rebase_coords, static_argnames="margin")(jst, margin=2)
    pst2, pbase = PV.rebase_coords(pst, margin=2)
    eq(pst2.coords, jst2.coords, "rebased coords")
    eq(pbase, jbase, "base")

    vals = np.arange(2 * capacity, dtype=np.float32).reshape(2, capacity)
    eq(PV.devoxelize(torch.from_numpy(vals), pp2v, fill_value=-7.0),
       jax.jit(JV.devoxelize)(jnp.asarray(vals), jp2v, fill_value=-7.0), "devoxelize")


def test_submanifold_and_transpose(rng):
    c, n = site_table(rng, 300, 384)
    for k in (1, 3):
        ref = jax.jit(JR.submanifold_rulebook, static_argnums=2)(jnp.asarray(c), jnp.int32(n), k)
        got = PR.submanifold_rulebook(torch.from_numpy(c), torch.tensor(n, dtype=torch.int32), k)
        eq(got, ref, f"subm k={k}")
    # transpose_rulebook against JAX, and the duality t(subm) == subm[::-1]
    eq(PR.transpose_rulebook(got, 384),
       jax.jit(JR.transpose_rulebook, static_argnums=1)(ref, 384), "transpose")
    eq(PR.transpose_rulebook(got, 384), torch.flip(got, dims=(0,)), "t(subm)")


@pytest.mark.parametrize("capacity", [512, 40])   # 40 overflows
def test_downsample_with_rulebooks(rng, capacity):
    c, n = site_table(rng, 400, 512, -9, 9)
    ct, nt = torch.from_numpy(c), torch.tensor(n, dtype=torch.int32)
    ref = jax.jit(JR.downsample_with_rulebooks, static_argnums=(2, 3))(
        jnp.asarray(c), jnp.int32(n), 2, capacity)
    got = PR.downsample_with_rulebooks(ct, nt, 2, capacity)
    for name, a, b in zip(("coords", "n_out", "overflow", "down", "up"), got, ref):
        eq(a, b, name)
    assert (int(ref[2]) > 0) == (capacity == 40)
    oc, on, _, down, up = got
    eq(PR.transpose_rulebook(down, 512), up, "t(down) == up")
    eq(PR.transpose_rulebook(up, capacity), down, "t(up) == down")
    if capacity == 512:   # the lookup oracles see every coarse site
        eq(PR.strided_rulebook(ct, nt, oc, on, 2),
           jax.jit(JR.strided_rulebook, static_argnums=4)(
               jnp.asarray(c), jnp.int32(n), jnp.asarray(oc.numpy()), jnp.int32(int(on)), 2),
           "strided oracle")
        eq(PR.strided_rulebook(ct, nt, oc, on, 2), down, "down == strided")
        eq(PR.inverse_rulebook(oc, on, ct, nt, 2), up, "up == inverse")


def _tables_jax(cfg, b):
    def f(points, feats, valid):
        st, p2v, _ = JV.voxelize_batch(points, feats, valid,
                                       jnp.asarray(cfg.data.voxel_size),
                                       cfg.data.voxel_capacity)
        st, _ = JV.rebase_coords(st, margin=2)
        scales, hovf = JH.build_hierarchy(st, len(cfg.model.backbone.widths),
                                          cfg.scale_capacities(),
                                          cfg.model.backbone.kernel_size)
        return st.coords, p2v, scales, hovf
    return jax.jit(f)(*(jnp.asarray(b[k]) for k in ("points", "feats", "valid")))


def _check_hierarchy(cfg, b):
    jc, jp2v, jscales, jhovf = _tables_jax(cfg, b)
    st, p2v, scales, _, aux = TL.prepare_inputs(cfg, TL.to_device(b, "cpu"))
    eq(st.coords, jc, "coords")
    eq(p2v, jp2v, "p2v")
    eq(aux["hierarchy_overflow"], jhovf.sum(), "hierarchy overflow")
    for s, (p, j) in enumerate(zip(scales, jscales)):
        for f in ("coords", "nvalid", "subm_idx", "down_idx", "up_idx"):
            if getattr(j, f) is None:
                assert getattr(p, f) is None
            else:
                eq(getattr(p, f), getattr(j, f), f"scale {s} {f}")
    return aux


def test_build_hierarchy_with_overflow():
    cfg = load_config(overrides={
        "data": {"num_points": 2048, "voxel_capacity": 1024, "batch_size": 2,
                 "voxel_size": [0.1, 0.1, 0.1]},
        "model": {"backbone": {"widths": [8, 16, 24], "capacities": [1024, 384, 128]}}})
    b = synthetic.generate_batch(5, 2, num_points=2048)
    aux = _check_hierarchy(cfg, b)
    assert int(aux["hierarchy_overflow"]) > 0


def test_build_hierarchy_config1_capacity():
    """One scene at config 1's own size: 32768 points and capacity."""
    cfg = load_config(CONFIG1)
    b = synthetic.generate_batch(1, 1, num_points=cfg.data.num_points)
    _check_hierarchy(cfg, b)
