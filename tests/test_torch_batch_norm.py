"""The masked BN + ReLU (``sparse_rcnn_tpu_torch/ops/batch_norm.py``) on the
CPU, where the kernels cannot run:

- tensors that are not on a CUDA device take the plain chain
  (``MaskedBatchNorm.normalize`` and ``torch.relu``) and launch no
  ``bn_*`` kernel;
- the kernels' backward, written in plain torch (``bn_grad_sums_reference``
  and ``bn_grad_input_reference``, the oracle the card's tests hold the
  kernels to), equals autograd through the plain chain: masked rows, a
  batch whose rows are all padding (the count clamped to 1), the running
  statistics, to 2e-6 of the largest entry (or of 1) with float32 or
  float64 features (the same mathematics; the statistics and the oracle's
  sums are f32 and differ in their order) and 2e-2 with bf16 ones (the
  chain's backward rounds to bf16 after each operation, 2^-8 each; the
  oracle sums in f32 and rounds once; measured at most 5.2e-3);
- the autograd Function, run over the kernels' plain versions, gives the
  chain's output, gradients and running statistics (momentum 0.9 and 0.5),
  and moves no running statistic in a recomputed forward.
"""

import pytest
import torch

from sparse_rcnn_tpu_torch.models import layers as PL
from sparse_rcnn_tpu_torch.native import libraries as NL
from sparse_rcnn_tpu_torch.ops import batch_norm as BN

ROLES = ("bn_stats", "bn_apply", "bn_grad")


def _inputs(dtype, live=(37, 0, 50), c=8, seed=0):
    """feats [B, 50, c] with rows past each scene's live count zero, the
    mask, and BN parameters with running statistics away from 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    b, m = len(live), 50
    mask = torch.arange(m)[None, :] < torch.tensor(live)[:, None]
    feats = (torch.randn(b, m, c, generator=g, dtype=torch.float64) * 3 + 2) * mask[..., None]
    params = {"scale": torch.rand(c, generator=g, dtype=torch.float64) + 0.5,
              "bias": torch.randn(c, generator=g, dtype=torch.float64) * 0.5,
              "mean": torch.randn(c, generator=g, dtype=torch.float64),
              "var": torch.rand(c, generator=g, dtype=torch.float64) + 0.5}
    return feats.to(dtype), mask, {k: v.to(torch.float32) for k, v in params.items()}


def _module(c, params, dtype, momentum=0.9):
    bn = PL.MaskedBatchNorm(c, momentum=momentum, dtype=dtype).to(dtype if dtype ==
                                                                  torch.float64 else None)
    bn.load_state_dict({k: v.to(bn.scale.dtype) for k, v in params.items()})
    return bn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_cpu_runs_the_plain_chain_and_no_kernel(dtype, training):
    feats, mask, params = _inputs(dtype)
    bn, plain = _module(8, params, dtype), _module(8, params, dtype)
    bn.train(training)
    plain.train(training)
    before = {r: NL.LAUNCHES[r] for r in ROLES}
    x = feats.clone().requires_grad_()
    out = bn(x, mask)
    out.float().square().sum().backward()
    assert {r: NL.LAUNCHES[r] for r in ROLES} == before
    want = torch.relu(plain.normalize(feats, mask))
    assert out.dtype == dtype and torch.equal(out, want)
    assert torch.equal(bn.mean, plain.mean) and torch.equal(bn.var, plain.var)
    assert not out[~mask].any() and not x.grad[~mask].any()


def _chain_grads(feats, mask, params, g, training, dtype):
    """relu(normalize) and autograd's gradients of <out, g> with respect to
    feats, scale and bias, with the statistics the chain used."""
    bn = _module(feats.shape[-1], params, dtype)
    bn.train(training)
    x = feats.clone().requires_grad_()
    out = torch.relu(bn.normalize(x, mask))
    (out.to(torch.float64) * g.to(torch.float64)).sum().backward()
    return out, (x.grad, bn.scale.grad, bn.bias.grad), bn


def _oracle(feats, mask, params, g, training, dtype):
    """The kernels' backward in plain torch from the forward's vectors."""
    c = feats.shape[-1]
    x, m, gf = feats.reshape(-1, c), mask.reshape(-1), g.reshape(-1, c)
    s1 = s2 = None
    if training:
        s1 = BN.bn_stats_reference(x, m)
        s2 = BN.bn_stats_reference(x, m, s1)
    _, stats, vecs = BN.bn_apply_reference(x, m, params["scale"], params["bias"],
                                           params["mean"].clone(), params["var"].clone(), 0.9,
                                           1e-5, s1, s2, training)
    sums = BN.bn_grad_sums_reference(x, m, gf, stats, vecs)
    dx = BN.bn_grad_input_reference(x, m, gf, stats, vecs, params["scale"],
                                    sums if training else None)
    return dx.reshape(feats.shape), sums[c:], sums[:c]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 2e-6), (torch.float32, 2e-6),
                                       (torch.bfloat16, 2e-2)], ids=["f64", "f32", "bf16"])
@pytest.mark.parametrize("case", ["ragged", "all_padding", "eval"])
def test_backward_formula_equals_autograd_through_the_chain(dtype, tol, case):
    live = (0, 0, 0) if case == "all_padding" else (37, 0, 50)
    feats, mask, params = _inputs(dtype, live)
    training = case != "eval"
    g = torch.randn(feats.shape, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64).to(dtype)
    out, want, _ = _chain_grads(feats, mask, params, g, training, dtype)
    got = _oracle(feats, mask, params, g, training, dtype)
    for name, a, b in zip(("dx", "dscale", "dbias"), got, want):
        b = b.to(a.dtype)
        err = (a - b).abs().max().item()
        assert err <= tol * max(b.abs().max().item(), 1.0), (name, err)
    assert not got[0][~mask].any()
    if case == "all_padding":
        assert not out.any() and not got[0].any()


def _plain_kernels(monkeypatch):
    """Every kernel of the Function as its plain version, counted."""
    for name in ("bn_stats", "bn_apply", "bn_grad_sums", "bn_grad_input"):
        ref = getattr(BN, f"{name}_reference")
        role = "bn_grad" if name.startswith("bn_grad") else name

        def run(*a, _ref=ref, _role=role, **k):
            NL.LAUNCHES[_role] += 1
            return _ref(*a, **k)
        monkeypatch.setattr(BN, f"{name}_kernel", run)


@pytest.mark.parametrize("momentum", [0.9, 0.5])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_function_over_plain_kernels_equals_the_chain(monkeypatch, momentum, training):
    _plain_kernels(monkeypatch)
    monkeypatch.setattr(BN, "masked_bn_relu", BN._MaskedBNReLU.apply)   # CPU tensors
    feats, mask, params = _inputs(torch.float32, seed=5)
    g = torch.randn(feats.shape, generator=torch.Generator().manual_seed(6))
    bn, plain = _module(8, params, torch.float32, momentum), \
        _module(8, params, torch.float32, momentum)
    bn.train(training)
    plain.train(training)
    before = {r: NL.LAUNCHES[r] for r in ROLES}
    x, xp = feats.clone().requires_grad_(), feats.clone().requires_grad_()
    out = bn.fused(x, mask)
    (out * g).sum().backward()
    want = torch.relu(plain.normalize(xp, mask))
    (want * g).sum().backward()
    assert {r: NL.LAUNCHES[r] - before[r] for r in ROLES} == \
        {"bn_stats": 2 * training, "bn_apply": 1, "bn_grad": 2}
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    for a, b in ((x.grad, xp.grad), (bn.scale.grad, plain.scale.grad),
                 (bn.bias.grad, plain.bias.grad), (bn.mean, plain.mean), (bn.var, plain.var)):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    if training:
        assert not torch.equal(bn.mean, params["mean"])     # the running statistics moved
    # a recomputed forward (remat's) moves no running statistic and gives the same bits
    mean, var = bn.mean.clone(), bn.var.clone()
    with PL._recomputing():
        again = bn.fused(feats, mask)
    assert torch.equal(bn.mean, mean) and torch.equal(bn.var, var)
    if training:
        first = _module(8, params, torch.float32, momentum).train().fused(feats, mask)
        assert torch.equal(again, first)
    with pytest.raises(TypeError, match="takes features of that type"):
        bn.fused(feats.double(), mask)


def test_kernels_refuse_cpu_tensors():
    feats, mask, params = _inputs(torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        BN.masked_bn_relu(feats, mask, params["scale"], params["bias"], params["mean"],
                          params["var"], 0.9, 1e-5, True, True)
    with pytest.raises(ValueError, match="CUDA device"):
        BN.bn_stats_kernel(feats.reshape(-1, 8), mask.reshape(-1))
