"""The sparse conv of the port against the JAX package.

On the CPU the port's wrapper runs its plain version
(``sparse_conv_reference``), held here against JAX ``gather_matmul_conv``,
``pallas_conv(interpret=True)`` and ``tap_accumulate_matmul(interpret=True)``
(the Pallas kernel run as ``tests/parity/test_pallas_conv.py`` runs it).
Tolerances: f32 1e-5 (the same products summed in other orders); bf16
outputs 1e-2 (both sum in f32 and round once to bf16, so they differ by at
most one bf16 ulp, 2^-8 relative). The CUDA kernel itself is held against
the plain version in ``tests/test_torch_kernel_cuda.py``, which skips
without a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_rcnn_tpu.ops import pallas_conv as JPC
from sparse_rcnn_tpu.ops import sparse_conv as JSC
from sparse_rcnn_tpu_torch.native import libraries as NL
from sparse_rcnn_tpu_torch.ops import sparse_conv as SC
from tests.test_torch_kernel_cuda import (CASES, TOL, TORCH_DT, apply_liveness, case_id,
                                          make_inputs)


_gather_matmul_conv = jax.jit(JSC.gather_matmul_conv)
_pallas_conv = jax.jit(functools.partial(JPC.pallas_conv, interpret=True))


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_reference_matches_jax_executors(case):
    k, cin, cout, m_in, m_out, dt, *live = case
    feats, idx, w = make_inputs(sum(case[:5]), k, cin, cout, m_in, m_out)
    apply_liveness(idx, live[0] if live else None)
    jf, jw = jnp.asarray(feats).astype(dt), jnp.asarray(w).astype(dt)
    tf, tw = torch.from_numpy(feats).to(TORCH_DT[dt]), torch.from_numpy(w).to(TORCH_DT[dt])
    got = SC.sparse_conv(tf, torch.from_numpy(idx), tw)
    assert got.dtype == TORCH_DT[dt] and got.shape == (2, m_out, cout)
    got = got.float().numpy()
    np.testing.assert_allclose(got, as_f32(_gather_matmul_conv(jf, jnp.asarray(idx), jw)),
                               **TOL[dt])
    np.testing.assert_allclose(got, as_f32(_pallas_conv(jf, jnp.asarray(idx), jw)), **TOL[dt])


def test_reference_matches_tap_accumulate_matmul():
    """The Pallas kernel proper, on rows gathered and zero-masked in advance."""
    feats, idx, w = make_inputs(5, 27, 16, 16, 200, 200, batch=1)
    g = feats[0][np.clip(idx[0], 0, None)] * (idx[0] >= 0)[..., None]   # [K, M, Cin]
    ref = np.asarray(JPC.tap_accumulate_matmul(jnp.asarray(g), jnp.asarray(w), interpret=True))
    got = SC.sparse_conv_reference(torch.from_numpy(feats), torch.from_numpy(idx),
                                   torch.from_numpy(w))[0].numpy()
    np.testing.assert_allclose(got, ref, **TOL["float32"])


def test_sparse_conv_t_checks_transpose_shape():
    feats, idx, w = make_inputs(1, 8, 4, 4, 30, 20)
    f, ix, tw = torch.from_numpy(feats), torch.from_numpy(idx), torch.from_numpy(w)
    t_idx = torch.full((2, 8, 30), -1, dtype=torch.int32)
    torch.testing.assert_close(SC.sparse_conv_t(f, ix, t_idx, tw), SC.sparse_conv(f, ix, tw))
    with pytest.raises(ValueError):
        SC.sparse_conv_t(f, ix, t_idx[:, :, :20], tw)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel path takes CUDA tensors only: it raises before any build."""
    feats, idx, w = make_inputs(2, 8, 4, 4, 30, 20)
    before = NL.LAUNCHES["forward"]
    with pytest.raises(ValueError, match="CUDA"):
        SC.conv_kernel(torch.from_numpy(feats), torch.from_numpy(idx), torch.from_numpy(w))
    assert NL.LAUNCHES["forward"] == before
