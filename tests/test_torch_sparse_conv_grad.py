"""The port's sparse-conv backward (``SparseConvFunction``) against ``jax.vjp``
of JAX ``sparse_conv`` and ``sparse_conv_t``.

On the CPU the port's dgrad and wgrad run their plain versions
(``sparse_conv_reference`` on g, t_idx, Wᵀ and ``sparse_conv_wgrad_reference``).
JAX runs its shared backward under the executor modes ``scan`` and
``pallas``; ``pallas`` runs the Pallas kernel in interpret mode, as
``tests/parity/test_pallas_conv.py`` does, and ``auto`` is restored after.
Rulebooks are random but per-tap injective, as every conv rulebook is.
Tolerances: f32 1e-5 (the same products summed in other orders); bf16 1e-2
(the cotangent is rounded to bf16 before the gathers, and d_feats and d_W
are rounded once to bf16 from f32 sums: one bf16 ulp, 2^-8 relative). The
CUDA kernels are held against these plain versions in
``tests/test_torch_kernel_cuda.py`` (on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.ops import sparse_conv as JSC
from sparse_rcnn_tpu_torch.native import libraries as NL
from sparse_rcnn_tpu_torch.ops import sparse_conv as SC
from tests.test_torch_kernel_cuda import (TOL, TORCH_DT, apply_rulebook_liveness,
                                          make_rulebook_inputs)

# (K, Cin, Cout, M_in, M_out, dtype, feats need a gradient, caller gives
# t_idx[, rows of M_in killed in both rulebooks: see apply_liveness])
CASES = [
    (27, 16, 24, 203, 203, "float32", True, True),     # submanifold, ragged M
    (27, 3, 16, 120, 120, "float32", False, True),     # the stem: no dgrad
    (8, 16, 32, 200, 131, "float32", True, True),      # down conv
    (8, 32, 16, 131, 200, "float32", True, False),     # up conv, t_idx built
    (1, 32, 16, 77, 77, "float32", True, False),       # 1x1 projection
    (27, 16, 16, 200, 200, "bfloat16", True, True),
    (8, 16, 32, 200, 131, "bfloat16", True, False),
    # two scenes of different liveness
    (27, 16, 16, 200, 200, "float32", True, True, "mixed"),
    # the stem's Cin 3 with half the rows dead
    (27, 3, 16, 120, 120, "float32", False, True, "half"),
    # 32-row stages dead on every tap (the wgrad kernel skips them) and a dead tap
    (27, 16, 16, 200, 200, "float32", True, False, "stages"),
]
MODES = ("scan", "pallas")


def case_id(c):
    return "K{}_{}x{}_M{}to{}_{}_{}_{}".format(
        *c[:6], "dgrad" if c[6] else "nodgrad", "t_idx" if c[7] else "transpose"
    ) + "".join(f"_{x}" for x in c[8:])


def _jax_vjp(mode, feats, idx, t_idx, w, g, dt):
    """(d_feats, d_W) of JAX sparse_conv(_t) under executor ``mode``."""
    try:
        JSC.set_executor_mode(mode)

        @jax.jit
        def vjp(f, w_, ct):
            if t_idx is None:
                _, fn = jax.vjp(lambda a, b: JSC.sparse_conv(a, jnp.asarray(idx), b), f, w_)
            else:
                _, fn = jax.vjp(lambda a, b: JSC.sparse_conv_t(
                    a, jnp.asarray(idx), jnp.asarray(t_idx), b), f, w_)
            return fn(ct)

        d_f, d_w = vjp(jnp.asarray(feats).astype(dt), jnp.asarray(w).astype(dt),
                       jnp.asarray(g).astype(dt))
        return (np.asarray(d_f.astype(jnp.float32)), np.asarray(d_w.astype(jnp.float32)))
    finally:
        JSC.set_executor_mode("auto")


def _port_grads(feats, idx, t_idx, w, g, dt, feats_grad):
    f = torch.from_numpy(feats).to(TORCH_DT[dt]).requires_grad_(feats_grad)
    tw = torch.from_numpy(w).to(TORCH_DT[dt]).requires_grad_(True)
    ix = torch.from_numpy(idx)
    if t_idx is None:
        out = SC.sparse_conv(f, ix, tw)
    else:
        out = SC.sparse_conv_t(f, ix, torch.from_numpy(t_idx), tw)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g).to(out.dtype))
    assert tw.grad.dtype == TORCH_DT[dt]
    return f.grad, tw.grad


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_backward_matches_jax_vjp(case, monkeypatch):
    k, cin, cout, m_in, m_out, dt, feats_grad, given, *live = case
    feats, idx, t_idx, w = make_rulebook_inputs(sum(case[:5]), k, cin, cout, m_in, m_out)
    apply_rulebook_liveness(idx, t_idx, live[0] if live else None)
    g = np.random.default_rng(7).normal(size=(2, m_out, cout)).astype(np.float32)
    dgrads = []
    real = SC.conv_dgrad
    monkeypatch.setattr(SC, "conv_dgrad", lambda *a: dgrads.append(1) or real(*a))
    d_f, d_w = _port_grads(feats, idx, t_idx if given else None, w, g, dt, feats_grad)
    assert len(dgrads) == int(feats_grad)
    for mode in MODES:
        want_f, want_w = _jax_vjp(mode, feats, idx, t_idx if given else None, w, g, dt)
        np.testing.assert_allclose(d_w.float().numpy(), want_w, err_msg=f"{mode} d_W",
                                   **TOL[dt])
        if feats_grad:
            assert d_f.dtype == TORCH_DT[dt]
            np.testing.assert_allclose(d_f.float().numpy(), want_f,
                                       err_msg=f"{mode} d_feats", **TOL[dt])
        else:
            assert d_f is None


def test_transpose_rulebooks_matches_jax():
    _, idx, t_idx, _ = make_rulebook_inputs(3, 8, 4, 4, 131, 200)
    got = SC.transpose_rulebooks(torch.from_numpy(idx), 131).numpy()
    np.testing.assert_array_equal(got, t_idx)
    want = np.stack([np.asarray(jax.jit(
        lambda ix: JSC.rb.transpose_rulebook(ix, 131))(jnp.asarray(i))) for i in idx])
    np.testing.assert_array_equal(got, want)


def test_wgrad_wrapper_refuses_cpu_tensors():
    """The wgrad kernel path takes CUDA tensors only: it raises before any build."""
    feats, idx, t_idx, w = make_rulebook_inputs(2, 8, 4, 4, 30, 20)
    g = torch.zeros((2, 20, 4))
    before = NL.LAUNCHES["wgrad"]
    with pytest.raises(ValueError, match="CUDA"):
        SC.wgrad_kernel(torch.from_numpy(feats), torch.from_numpy(t_idx), g)
    assert NL.LAUNCHES["wgrad"] == before


def test_wgrad_chunks_cover_rows():
    for m in (1, 31, 32, 255, 256, 1000, 32768, 262144):
        rows, n = SC.wgrad_chunks(m)
        assert rows % 32 == 0 and rows * n >= m > rows * (n - 1)
        assert n <= 256


def test_sparse_conv_t_backward_gathers_through_t_idx():
    """``sparse_conv_t``'s backward reads the caller's ``t_idx``: the true
    transpose gives the gradients of ``sparse_conv`` (which transposes
    ``idx`` itself), and an all-missing one gives zero gradients."""
    feats, idx, t_idx, w = make_rulebook_inputs(9, 8, 4, 6, 50, 40)
    g = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 40, 6)).astype(np.float32))

    def grads(t):
        f = torch.from_numpy(feats).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        ix = torch.from_numpy(idx)
        out = SC.sparse_conv(f, ix, tw) if t is None else SC.sparse_conv_t(f, ix, t, tw)
        out.backward(g)
        return f.grad, tw.grad

    want = grads(None)
    for got, ref in zip(grads(torch.from_numpy(t_idx)), want):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    for got in grads(torch.full_like(torch.from_numpy(t_idx), -1)):
        assert not got.any()
