"""Cases of the masked BN + ReLU kernels (``sparse_rcnn_tpu_torch/ops/batch_norm.py``)
and the helpers that run them against the plain chain.

``tests/test_torch_kernel_cuda.py`` holds the kernels to the chain on these
cases on the card and ``chip_smoke.py`` phase 3 does the same on the main
path's norms and times them. Imports no JAX.

What :func:`compare` checks, and the tolerances (each gap is a largest
absolute difference over a scale, below):

- ``vectors_bit_equal``, ``apply_bit_equal``: ``bn_apply`` against the
  chain's operations (``bn_apply_reference``) on the same sums: its
  vectors and the running statistics it moves, then its output, bit for
  bit;
- ``stats_gap``: the two passes of ``bn_stats`` against float64 sums of
  the same terms, over the sum of their magnitudes: both are f32 sums of up
  to 1,024 rows in order per thread and a tree, at most 1024 · 2^-24 =
  6.1e-5 in the worst case; held to :data:`STATS_TOL` = 1e-4;
- ``grad_gap``: dx, dscale and dbias of the kernels' backward against
  autograd through the chain (``MaskedBatchNorm.normalize`` and
  ``torch.relu``), over each one's largest entry: f32 2e-4 (the sums'
  orders: torch's column sums over 10^5 rows and more lose about 1e-4),
  bf16 3e-2 (the chain's backward rounds to bf16 after each of its
  operations, 2^-8 each; the kernels sum in f32 and round once). The two
  take their statistics in other orders, so at an entry whose ReLU input
  lies within an ulp or so of 0 the two ReLUs may differ (``relu_flips``,
  entries where one output is 0 and the other not): dx is compared where
  they agree, and each flipped entry widens its channel's dscale and dbias
  tolerance by what it can move them, |g| (1 + |x̂|). ``relu_flips`` is held
  to :data:`FLIP_TOL` of the live entries;
- ``grad_input_bit_equal``: ``bn_grad``'s input gradient against
  ``bn_grad_input_reference`` on the same sums, bit for bit;
- ``bit_identical``: a second run of the whole forward and backward gives
  the same bits (no atomics).
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from sparse_rcnn_tpu_torch import infer
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data.pipeline import Loader
from sparse_rcnn_tpu_torch.models import layers as PL
from sparse_rcnn_tpu_torch.native import libraries as NL
from sparse_rcnn_tpu_torch.ops import batch_norm as BN
from sparse_rcnn_tpu_torch.train import loop as TL

WIDTHS = (32, 64, 96, 128, 160, 192, 256)   # every backbone width x 1 or 2
STATS_TOL = 1e-4
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
FLIP_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ROLES = ("bn_stats", "bn_apply", "bn_grad")
HBM_BYTES_PER_S = 3.35e12

# (C, dtype, kind): "ragged" three scenes of 3,001 rows live to 100 %, 37 % and
# 0.3 %; "all_padding" a scene with no live row beside two live ones; "eval" the
# running statistics; "big" two scenes of 262,144 rows, 60 % and 20 % live (config
# 2's first scale, 1,024 blocks of the sums); "odd" C = 40 in bf16 and C = 6 in f32
# (C not a multiple of a 16-byte lane: one entry a lane)
BN_CASES = ([(c, dt, "ragged") for c in WIDTHS for dt in DTYPES]
            + [(c, dt, k) for c in (32, 160) for dt in DTYPES for k in ("all_padding", "eval")]
            + [(32, "bfloat16", "big"), (160, "float32", "big"),
               (40, "bfloat16", "ragged"), (6, "float32", "ragged")])


def case_id(case) -> str:
    return "C{}_{}_{}".format(*case)


def make_case(c: int, dtype: str, kind: str, device, seed: int) -> dict:
    """x [B, M, C] (zero past each scene's live rows, as the backbone's
    padding), mask, g, and a norm's parameters and running statistics."""
    rng = np.random.default_rng(seed)
    if kind == "big":
        m, live = 262144, (0.6, 0.2)
    else:
        m, live = 3001, (1.0, 0.0, 0.5) if kind == "all_padding" else (1.0, 0.37, 0.003)
    mask = np.arange(m)[None, :] < np.round(np.array(live) * m)[:, None]
    x = (rng.normal(size=(len(live), m, c)) * rng.uniform(0.5, 3, c) + rng.normal(size=c))
    dt = DTYPES[dtype]
    return {
        "x": torch.from_numpy((x * mask[..., None]).astype(np.float32)).to(device, dt),
        "mask": torch.from_numpy(mask).to(device),
        "g": torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)).to(device, dt),
        "params": {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in (
            ("scale", rng.uniform(0.5, 1.5, c)), ("bias", rng.normal(size=c) * 0.5),
            ("mean", rng.normal(size=c)), ("var", rng.uniform(0.5, 2.0, c)))},
        "training": kind != "eval", "dtype": dt}


def module(case) -> PL.MaskedBatchNorm:
    """A fresh norm of the case's width, parameters and mode."""
    c = case["x"].shape[-1]
    bn = PL.MaskedBatchNorm(c, dtype=case["dtype"]).to(case["x"].device)
    bn.load_state_dict(case["params"])
    return bn.train(case["training"])


def run(case, fused: bool) -> dict:
    """One forward and backward of a fresh norm, through the kernels
    (``fused``) or the chain: y, the gradients of <y, g> and the running
    statistics after."""
    bn = module(case)
    x = case["x"].clone().requires_grad_()
    y = bn.fused(x, case["mask"]) if fused else torch.relu(bn.normalize(x, case["mask"]))
    y.backward(case["g"])
    return {"y": y.detach(), "dx": x.grad, "dscale": bn.scale.grad, "dbias": bn.bias.grad,
            "mean": bn.mean, "var": bn.var}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _gap(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max()
                 .clamp(min=1e-30)) if want.numel() else 0.0


def stats_gaps(x, m, s1, s2) -> tuple:
    """The gaps of the two passes' sums against float64 sums of the same
    terms (pass 2 about pass 1's mean), over the sums of their magnitudes."""
    f, w = x.double(), m[:, None].double()
    mean = (s1[:-1] / torch.clamp(s1[-1], min=1.0)).double()
    want1 = torch.cat([(f * w).sum(0), w.sum()[None]])
    want2 = ((f - mean) ** 2 * w).sum(0)
    mag1 = torch.cat([(f.abs() * w).sum(0), w.sum()[None]]).clamp(min=1e-30)
    return (float(((s1.double() - want1).abs() / mag1).max()),
            float(((s2.double() - want2).abs() / want2.clamp(min=1e-30)).max()))


def compare(case) -> dict:
    """Every check of the module docstring on one case; ``ok`` if all hold."""
    dt, c = case["dtype"], case["x"].shape[-1]
    x, m, g = case["x"].reshape(-1, c), case["mask"].reshape(-1), case["g"].reshape(-1, c)
    p, training = case["params"], case["training"]
    rec = {"rows": x.shape[0], "C": c, "dtype": str(dt).replace("torch.", ""),
           "training": training, "live_rows": int(m.sum())}
    s1 = s2 = None
    rec["stats_gap_mean"] = rec["stats_gap_var"] = 0.0
    if training:
        s1 = BN.bn_stats_kernel(x, m)
        s2 = BN.bn_stats_kernel(x, m, s1)
        rec["stats_gap_mean"], rec["stats_gap_var"] = stats_gaps(x, m, s1, s2)
    out = {}
    for side, fn in (("kernel", BN.bn_apply_kernel), ("plain", BN.bn_apply_reference)):
        run_stats = [p["mean"].clone(), p["var"].clone()]
        out[side] = (*fn(x, m, p["scale"], p["bias"], *run_stats, 0.9, 1e-5, s1, s2, training),
                     *run_stats)
    (y, stats, vecs, *_), want = out["kernel"], out["plain"]
    rec["vectors_bit_equal"] = all(bit_equal(a, b) for a, b in zip(out["kernel"][1:],
                                                                   want[1:]))
    rec["apply_bit_equal"] = bit_equal(y, want[0])
    sums = BN.bn_grad_sums_kernel(x, m, g, stats, vecs) if training else None
    rec["grad_input_bit_equal"] = bit_equal(
        BN.bn_grad_input_kernel(x, m, g, stats, vecs, p["scale"], sums),
        BN.bn_grad_input_reference(x, m, g, stats, vecs, p["scale"], sums))
    mean, rstd = stats[:c], stats[c:2 * c]
    got, again, want = run(case, True), run(case, True), run(case, False)
    rec["bit_identical"] = all(bit_equal(got[k], again[k]) for k in got)
    flip = ((got["y"] > 0) != (want["y"] > 0)).reshape(-1, c)
    rec["relu_flips"] = int(flip.sum())
    xh = (x.double() - mean.double()) * rstd.double()
    allow = (g.double().abs() * (1 + xh.abs()) * flip).sum(0)
    rec["grad_gap"] = {
        "dx": _gap(torch.where(flip, 0, got["dx"].reshape(-1, c)),
                   torch.where(flip, 0, want["dx"].reshape(-1, c))),
        **{k: float(((got[k].double() - want[k].double()).abs() - allow).clamp(min=0).max()
                    / want[k].double().abs().max().clamp(min=1e-30))
           for k in ("dscale", "dbias")}}
    rec["y_gap"] = _gap(got["y"], want["y"])
    rec["running_gap"] = max(_gap(got[k], want[k]) for k in ("mean", "var"))
    rec["padding_zero"] = not (got["y"][~case["mask"]].any() or got["dx"][~case["mask"]].any())
    rec["ok"] = (rec["vectors_bit_equal"] and rec["apply_bit_equal"]
                 and rec["grad_input_bit_equal"] and rec["bit_identical"]
                 and rec["padding_zero"]
                 and max(rec["stats_gap_mean"], rec["stats_gap_var"]) <= STATS_TOL
                 and max(rec["grad_gap"].values()) <= GRAD_TOL[dt]
                 and rec["relu_flips"] <= FLIP_TOL[dt] * max(rec["live_rows"] * c, 1)
                 and rec["running_gap"] <= STATS_TOL)
    return rec


# --------------------------------------------------------------------------
# the main path's norms: captured in one train step, checked and timed


def capture_step(cfg, state, batch) -> tuple:
    """One ``TL.train_step`` with every norm's call recorded: ([(module, x,
    mask, recomputing)], the step's launches of :data:`ROLES`); x and mask
    are copies of the norm's input."""
    calls, forward = [], PL.MaskedBatchNorm.forward

    def spy(bn, feats, mask):
        calls.append((bn, feats.detach().clone(), mask.clone(), PL._RECOMPUTING))
        return forward(bn, feats, mask)
    before = {r: NL.LAUNCHES[r] for r in ROLES}
    PL.MaskedBatchNorm.forward = spy
    try:
        TL.train_step(cfg, state, batch)
        torch.cuda.synchronize()
    finally:
        PL.MaskedBatchNorm.forward = forward
    return calls, {r: NL.LAUNCHES[r] - before[r] for r in ROLES}


def case_from(bn, x, mask, seed: int) -> dict:
    """A case of :func:`compare` from a captured norm (training mode)."""
    g = torch.randn(x.shape, generator=torch.Generator(x.device).manual_seed(seed),
                    device=x.device, dtype=torch.float32).to(x.dtype)
    return {"x": x, "mask": mask, "g": g, "training": True, "dtype": x.dtype,
            "params": {k: v.detach().clone() for k, v in bn.state_dict().items()}}


def norm_bytes(x, mask) -> dict:
    """Bytes once of one norm: forward reads the live rows of x and writes
    y, backward reads the live rows of x and g and writes dx; each reads the
    mask."""
    c, es = x.shape[-1], x.element_size()
    rows, live = mask.numel(), int(mask.sum())
    return {"forward": live * c * es + rows * c * es + rows,
            "backward": 2 * live * c * es + rows * c * es + rows}


def time_norm(bn, x, mask, recomputing: bool, backward: bool, time_ms, seed: int) -> dict:
    """Card ms of one captured norm (a copy of ``bn`` in training mode): the
    kernels' forward and, with ``backward``, their backward (``kernel_*``),
    the chain's (``plain_*``); each role's kernels alone (``*_ms`` by role);
    and the bound from :func:`norm_bytes`."""
    bn = copy.deepcopy(bn).train()
    params = [bn.scale, bn.bias]
    g = case_from(bn, x, mask, seed)["g"]
    c = x.shape[-1]
    xf, mf, gf = x.reshape(-1, c), mask.reshape(-1), g.reshape(-1, c)
    rec = {"rows": mf.numel(), "C": c, "live": int(mf.sum()), "recomputing": recomputing}

    def forward(plain):
        with torch.no_grad(), (PL._recomputing() if recomputing else contextlib.nullcontext()):
            return torch.relu(bn.normalize(x, mask)) if plain else bn.fused(x, mask)

    def backward_of(plain):
        xr = x.clone().requires_grad_()
        y = torch.relu(bn.normalize(xr, mask)) if plain else bn.fused(xr, mask)
        return lambda: torch.autograd.grad(y, [xr] + params, g, retain_graph=True)
    s1 = BN.bn_stats_kernel(xf, mf)
    s2 = BN.bn_stats_kernel(xf, mf, s1)
    scale, bias = bn.scale.detach(), bn.bias.detach()
    run_stats = (bn.mean.clone(), bn.var.clone(), bn.momentum, bn.epsilon)
    _, stats, vecs = BN.bn_apply_kernel(xf, mf, scale, bias, *run_stats, s1, s2)
    rec["bn_stats_ms"] = time_ms(lambda: BN.bn_stats_kernel(xf, mf, BN.bn_stats_kernel(xf, mf)))
    rec["bn_apply_ms"] = time_ms(lambda: BN.bn_apply_kernel(xf, mf, scale, bias, *run_stats,
                                                            s1, s2))
    rec["kernel_fwd_ms"] = time_ms(lambda: forward(False))
    rec["plain_fwd_ms"] = time_ms(lambda: forward(True))
    nbytes = norm_bytes(x, mask)
    rec["bound_fwd_ms"] = nbytes["forward"] / HBM_BYTES_PER_S * 1e3
    if backward:
        rec["bn_grad_ms"] = time_ms(lambda: BN.bn_grad_input_kernel(
            xf, mf, gf, stats, vecs, scale, BN.bn_grad_sums_kernel(xf, mf, gf, stats, vecs)))
        rec["kernel_bwd_ms"] = time_ms(backward_of(False))
        rec["plain_bwd_ms"] = time_ms(backward_of(True))
        rec["bound_bwd_ms"] = nbytes["backward"] / HBM_BYTES_PER_S * 1e3
    return rec


def step_norms(calls, time_ms, checked: bool = True) -> dict:
    """Every captured norm of a train step timed (the backward once a
    module, at its last call: the recomputed one under remat) and, if
    ``checked``, compared (:func:`compare` on its input); their sums."""
    last = {id(bn): i for i, (bn, *_) in enumerate(calls)}
    recs = []
    for i, (bn, x, mask, recomputing) in enumerate(calls):
        rec = time_norm(bn, x, mask, recomputing, last[id(bn)] == i, time_ms, seed=i)
        if checked and not recomputing:
            rec.update(compare(case_from(bn, x, mask, seed=i)))
        recs.append(rec)
    keys = ("bn_stats_ms", "bn_apply_ms", "bn_grad_ms", "kernel_fwd_ms", "kernel_bwd_ms",
            "plain_fwd_ms", "plain_bwd_ms", "bound_fwd_ms", "bound_bwd_ms")
    total = {k: sum(r.get(k, 0.0) for r in recs) for k in keys}
    total.update(kernel_ms=total["kernel_fwd_ms"] + total["kernel_bwd_ms"],
                 plain_ms=total["plain_fwd_ms"] + total["plain_bwd_ms"],
                 bound_ms=total["bound_fwd_ms"] + total["bound_bwd_ms"],
                 norms=len(last), calls=len(calls),
                 recomputed=sum(r["recomputing"] for r in recs))
    checked_recs = [r for r in recs if "ok" in r]
    if checked_recs:
        total.update(
            ok=all(r["ok"] for r in checked_recs),
            vectors_bit_equal=all(r["vectors_bit_equal"] for r in checked_recs),
            apply_bit_equal=all(r["apply_bit_equal"] for r in checked_recs),
            grad_input_bit_equal=all(r["grad_input_bit_equal"] for r in checked_recs),
            bit_identical=all(r["bit_identical"] for r in checked_recs),
            stats_gap=max(max(r["stats_gap_mean"], r["stats_gap_var"]) for r in checked_recs),
            relu_flips=sum(r["relu_flips"] for r in checked_recs),
            grad_gap=max(max(r["grad_gap"].values()) for r in checked_recs))
    return {"total": total, "norms": recs}


def count_norms(model) -> int:
    """The model's masked BN + ReLU modules."""
    return sum(isinstance(m, PL.MaskedBatchNorm) for m in model.modules())


def measure_step(config: str, sets: list, device, time_ms, checked: bool = True) -> dict:
    """One warm ``TL.train_step`` of ``config`` with ``sets`` (seeded init),
    then one captured (:func:`capture_step`) and its norms timed and checked
    (:func:`step_norms`): the config's name, the model's norms, the step's
    launches by role, the sums and the per-norm records."""
    cfg = load_config(config, infer.parse_overrides(sets))
    state = TL.init_state(cfg, device, torch.Generator().manual_seed(cfg.train.seed))
    stream = Loader(cfg, seed=cfg.train.seed, threads=False)
    batches = [TL.to_device(next(stream), device, TL.TRAIN_KEYS) for _ in range(2)]
    TL.train_step(cfg, state, batches[0])
    calls, launches = capture_step(cfg, state, batches[1])
    res = step_norms(calls, time_ms, checked)
    return {"config": cfg.name, "modules": count_norms(state.model), "launches": launches,
            "total": res["total"], "norms": res["norms"]}
