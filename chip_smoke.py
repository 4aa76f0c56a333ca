#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sparse_rcnn_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero without one. Phases, any failure exits
nonzero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the sparse-conv kernels from ``sparse_rcnn_tpu_torch/ops/csrc``;
3. the forward kernel against its plain version on random inputs at every
   conv shape of a config-1 forward (f32 and bf16), a ragged M, a
   config-2-sized shape and the edge cases of its dead-tile skip and copy
   widths (``EDGE_CONVS``), with kernel, plain, library and bound times and
   the share of (64-row tile, tap) pairs with no live entry; then the
   backward kernels (dgrad and wgrad) the same way, the edge cases for
   both, the wgrad checked bit-identical across two launches and with its
   share of (32-row stage, tap) pairs with no live entry;
4. the config-1 inference slice on the card: ``infer.main`` on 3 val scenes
   (the forward count must rise by 10 per forward); tie-breaking of sort
   and argmax on the card; then the same weights and scenes on the CPU,
   where the plain versions run: site tables and rulebooks bit-exact,
   floats to tolerance, proposal masks and classes exact; warm ms per scene
   split into hierarchy, backbone and heads; the forward kernel against its
   plain version, timed, on the inputs the main path's 10 convs gave it;
5. the committed JAX-init weights (``tests/fixtures``) reproduce
   ``tests/e2e/golden_config1.npz`` on the card;
6. the config-1 training slice on the card: ``python -m
   sparse_rcnn_tpu_torch.train``'s ``main`` for 5 steps (per step 10
   forward, 9 dgrad and 10 wgrad launches; finite losses); one step's loss
   parts and gradients and the params after 3 steps, card against CPU; a
   step's gradients twice from one state, bit-identical on the card and on
   the CPU; warm ms per train step split into prepare (with GT), forward
   (with losses), backward and optimizer; the backward kernels timed on the
   inputs the main path gave them;
7. the committed weights reproduce JAX's 3-step train trajectory
   ``tests/fixtures/golden_config1_train.npz`` on the card;
8. config 2 (``configs/config2_scannet_2cm.yaml``, ``data.dataset=synthetic``
   the only override) at full width, bf16: ``infer.main`` on one batch
   (dense tail from scale 2; one launch per sparse conv) and
   ``train.main`` for 3 steps (dense tail from scale 3; forward, dgrad and
   wgrad launches per step; finite losses, parameters f32); on
   ``bench.py``'s scenes (262144 points, 12 instances, augmented and
   cropped): one scene's integer tables and dense occupancy bit-exact
   against the CPU, the overflow counters (0) and ``dense_tail_oob``
   against a count of the dropped sites made in numpy from the points,
   every sparse conv of one eval forward and every dgrad and wgrad of one
   train step against its plain version, dense-2 against the same weights
   converted to fully sparse in f32 and bf16 on a batch that drops no
   site, one train step bit-identical run to run and with remat (peak
   memory of each), the wgrad partials buffer, and warm ms per scene of
   the eval step and per train step;
9. evaluation over a split, checkpoints and the CLIs, config 1 at full
   width on 3 val scenes: ``train.main`` for 4 steps with an eval and a
   checkpoint every 2 (2 ``eval`` lines of 3 scenes, ``_best/best.json``;
   per step 10 forward, 9 dgrad and 10 wgrad launches, plus 10 forward per
   eval forward); the step-2 checkpoint ``torch.equal`` to the same 2 steps
   run here, a save and restore too, and one step from it bit-equal to one
   from memory; ``train.main --resume`` to 6 steps, ``eval.main --best
   --per-scene`` and ``infer.main --best``; ``run_eval`` on the card equal
   to the CPU's for the same weights and scenes (largest difference of any
   mAP entry at most 1e-6), ``point_mask_bits`` equal to ``np.packbits``.
   Then config 2 at full width, bf16: ``train.main`` for 2 steps with a
   checkpoint every step and an eval at step 2, ``eval.main --best`` on 3
   val scenes in batches of 2 (the last wrap-padded; 23 forward launches an
   eval forward; the dense-3 train form scored as dense-2). Figures: the
   warm eval split per scene of both configs, the bytes a config-2 batch
   fetches against its f32 logits, the config-2 checkpoint's size and save
   and restore ms, and the card's name and power limit, in an
   ``eval_checkpoints`` JSON line;
10. a ``kernels`` JSON line (config-2 figures at the top level, config 1's
   under ``config1``; launches of every path under ``launches_by_path``),
   then as the last line ``{"ok": true, "device": {...}}``.

TF32 is off throughout (cuDNN and matmul) and cuDNN runs deterministic
algorithms, so every f32 comparison holds f32 against f32. Detailed
records go to ``--out-dir`` (by default ``chiprun_out/chip_smoke/``), with
config 1's checkpoints; config 2's go to a temporary ``_chip_smoke_*``
directory in the checkout, removed at the end.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import sparse_rcnn_tpu_torch.train.__main__ as train_cli
from benchmarks import profile_torch_slice as PROF
from sparse_rcnn_tpu_torch import eval as eval_cli
from sparse_rcnn_tpu_torch import infer
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.data.augment import augment_scene
from sparse_rcnn_tpu_torch.data.pipeline import EvalBatches, TrainStream, collate
from sparse_rcnn_tpu_torch.models.convert import convert_variables, tree_boundary
from sparse_rcnn_tpu_torch.models.layers import SparseConv
from sparse_rcnn_tpu_torch.models.transfer import from_flax, unflatten_variables
from sparse_rcnn_tpu_torch.models.unet import scatter_to_grid
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc
from sparse_rcnn_tpu_torch.train import checkpoint as CK
from sparse_rcnn_tpu_torch.train import loop as TL
from sparse_rcnn_tpu_torch.train.evaluate import fetch_eval_outputs, run_eval

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
CONFIG1 = os.path.join(ROOT, "configs", "config1_tiny_5cm.yaml")
GOLDEN = os.path.join(ROOT, "tests", "e2e", "golden_config1.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_config1_params.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_config1_train.npz")
CONFIG2 = os.path.join(ROOT, "configs", "config2_scannet_2cm.yaml")
C2_SET = ["data.dataset=synthetic"]      # the only override of config 2
C2_TRAIN_STEPS = 3
# phase 9: the in-training eval, checkpoints and the eval CLI over 3 val
# scenes (config 2's batch of 2 wrap-pads the last)
EVAL_SCENES = 3
C1_EVAL_SET = [f"data.val_scenes={EVAL_SCENES}", "train.eval_every=2",
               "train.checkpoint_every=2", f"train.eval_scenes={EVAL_SCENES}",
               "train.log_every=1"]
C2_EVAL_SET = [f"data.val_scenes={EVAL_SCENES}", "train.eval_every=2",
               "train.checkpoint_every=1", f"train.eval_scenes={EVAL_SCENES}",
               "train.log_every=1"]
# dense-2 against fully sparse in bf16, per scale, of the largest entry: the
# two forms round to bf16 after different sums (dense convs against
# gathered taps) through up to 16 blocks
DENSE_SPARSE_BF16 = 5e-2

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM bytes/s and
# flop/s per input type (f32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# (name, K, Cin, Cout, M_in, M_out): the 10 sparse convs of one config-1
# forward (widths [16, 32], capacities 32768 / 24576), in launch order
CONFIG1_CONVS = [
    ("stem", 27, 3, 16, 32768, 32768),
    ("enc0.conv1", 27, 16, 16, 32768, 32768),
    ("enc0.conv2", 27, 16, 16, 32768, 32768),
    ("down0", 8, 16, 32, 32768, 24576),
    ("enc1.conv1", 27, 32, 32, 24576, 24576),
    ("enc1.conv2", 27, 32, 32, 24576, 24576),
    ("up0", 8, 32, 16, 24576, 32768),
    ("dec0.conv1", 27, 32, 16, 32768, 32768),
    ("dec0.conv2", 27, 16, 16, 32768, 32768),
    ("dec0.proj", 1, 32, 16, 32768, 32768),
]
EXTRA_CONVS = [  # (name, K, Cin, Cout, M_in, M_out, dtype)
    ("ragged_m1000", 27, 16, 16, 1000, 1000, torch.float32),
    ("config2_k27_32x32", 27, 32, 32, 262144, 262144, torch.bfloat16),
]
# (name, K, Cin, Cout, M_in, M_out, live rows per scene): the paths of the
# gather-GEMM's dead-tile skip and copy widths, as the kernel is launched
# (for the dgrad, Cin is the cotangent's width), f32 and bf16. Scene b's
# rows from live_rows[b] * M_out on are -1 on every tap, like the rows past
# a scene's valid count in a rulebook; "all_dead" is timed against
# "dead_tail_60" (a dead tile should cost only its read of idx).
EDGE_CONVS = [
    ("dead_tail_60", 27, 16, 16, 32768, 32768, (0.6,)),
    ("all_dead", 27, 16, 16, 32768, 32768, (0.0,)),
    ("cin3", 27, 3, 16, 32768, 32768, (0.6,)),
    ("cin24_cout24", 27, 24, 24, 16384, 16384, (1.0,)),
    ("cout64", 27, 16, 64, 16384, 16384, (1.0,)),
    ("m_below_tile", 27, 16, 16, 100, 37, (1.0,)),
    ("b2_mixed", 27, 16, 16, 16384, 16384, (1.0, 0.3)),
]
TILE_M = 64                     # output rows per block of the gather-GEMM
WGRAD_STAGE = 32                # rows per stage of the wgrad kernel's first pass
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# wgrad against its plain version: up to B*M products per entry summed in
# another order (bf16 products are exact in f32): 1e-4 of the largest entry
WGRAD_RTOL = 1e-4
TRAIN_STEPS = 5
SPIN_CYCLES = 2_000_000         # about 1 ms of the card's clock
# ``time_ms`` arguments of the kernel, plain and library timings; fewer
# (QUICK_REPS) on config 2's main path, whose convs move 16x the rows
REPS = {"kernel": dict(reps=30, inner=10), "plain": dict(reps=20, inner=1),
        "library": dict(reps=20, inner=10)}
QUICK_REPS = {"kernel": dict(reps=10, inner=5), "plain": dict(reps=5, inner=1),
              "library": dict(reps=5, inner=2)}
PER_STEP = (10, 9, 10)          # forward, dgrad (the stem's input needs none), wgrad
# card against CPU, one config-1 step, per parameter relative to the
# largest entry of its gradient. Outside the RoI head: with the mask weight
# 0, f32 sums of up to 32768*27 products in other orders through ~20
# layers, 1e-4 (measured worst 1.1e-5); with the full loss the card also
# adds the bf16-read mask-logit gradient in f32 (CUDA index_put_
# accumulates in f32) where the CPU adds it in bf16, 1e-3 (measured worst
# 1.1e-5). The RoI head's dense convs (cuDNN) run on a trilinear crop whose
# box corners differ between the devices in their last bits (proposals are
# decoded through exp), which moves the sampling weights and flips a ReLU
# at a few of the ~11k x 32 positions that their bias gradients sum over:
# 1e-2 for either weighting (measured worst 1.4e-3, conv1.bias).
GRAD_TOL = {"mask0": 1e-4, "full": 1e-3}
GRAD_TOL_ROI_HEAD = 1e-2
LOSS_WEIGHTS = {"mask0": [1.0, 1.0, 1.0, 0.0], "full": [1.0, 1.0, 1.0, 1.0]}
# params after a few Adam steps: every entry within 2 * (sum of the applied
# lrs), the most two updates with |update| <= 1 can part, and at most
# PARAM_OUTLIERS of the entries past PARAM_ATOL (tests/test_torch_train_steps.py)
PARAM_ATOL = 1e-6
PARAM_OUTLIERS = 2.5e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 30, warmup: int = 3, inner: int = 10) -> float:
    """Median over ``reps`` of the mean of ``inner`` back-to-back warm runs
    between two CUDA events. Before each, the card spins for about a
    millisecond (``torch.cuda._sleep``), so that the host has queued the
    runs before the start event fires: a kernel of a few microseconds is
    then timed on the card, not at the rate the host launches it, and the
    events' own cost is spread over ``inner`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# --------------------------------------------------------------------------
# phase 1 and 2


def card_info() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    log("TF32 off: torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False; cudnn.deterministic = True")
    return smi


def build() -> None:
    t0 = time.perf_counter()
    so, messages = sc.build_kernel()
    sc.KERNEL.load()
    sc.WGRAD.load()
    log(f"[phase 2] built {os.path.relpath(so, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in messages.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log(f"  nvcc: {line.strip()}")


# --------------------------------------------------------------------------
# phase 3: the kernel against its plain version


def kill_rows(miss, live_rows):
    """Mark scene b's rows from ``live_rows[b]`` of the last axis on as dead."""
    m = miss.shape[-1]
    for b, frac in enumerate(live_rows):
        miss[b, :, int(frac * m):] = True
    return miss


def conv_inputs(k, cin, cout, m_in, m_out, dtype, seed, live_rows=(1.0,)):
    """Random feats/W and an idx with about 30 % of entries -1, on the card,
    one scene per entry of ``live_rows`` (see ``kill_rows``)."""
    b = len(live_rows)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    feats = torch.randn((b, m_in, cin), generator=g, device=DEVICE).to(dtype)
    w = (torch.randn((k, cin, cout), generator=g, device=DEVICE)
         * (2.0 / (k * cin)) ** 0.5).to(dtype)
    rows = torch.randint(0, m_in, (b, k, m_out), generator=g, device=DEVICE,
                         dtype=torch.int32)
    miss = kill_rows(torch.rand((b, k, m_out), generator=g, device=DEVICE) < 0.3, live_rows)
    idx = torch.where(miss, -1, rows).contiguous()
    return feats, idx, w


def dead_pair_share(idx, m_in, tile=TILE_M) -> float:
    """Share of the (``tile``-row tile, tap) pairs of idx [B, K, M] with no
    entry in [0, M_in): the pairs the gather-GEMM (64-row tiles) and the
    wgrad (32-row stages of t_idx; its row chunks are 32-row aligned) skip."""
    b, k, m = idx.shape
    live = ((idx >= 0) & (idx < m_in)).to(torch.uint8)
    live = torch.nn.functional.pad(live, (0, -m % tile)).reshape(b, k, -1, tile)
    return 1.0 - live.amax(-1).float().mean().item()


def library_fn(feats, idx, w):
    """The nearest library composition, two calls: an im2col row gather
    ``feats[idx]`` and one ``torch.matmul`` with W as [K*Cin, Cout] (the
    JAX package's ``concat_matmul_conv``). Input prep (a zero row for the
    -1 entries, idx as [B*M_out, K] rows into the flattened batch) is done
    once, outside the timing."""
    b, m_in, cin = feats.shape
    k, _, cout = w.shape
    m_out = idx.shape[-1]
    fz = torch.cat([feats.reshape(b * m_in, cin), feats.new_zeros((1, cin))])
    base = torch.arange(b, device=idx.device)[:, None, None] * m_in
    ix = torch.where(idx >= 0, idx + base, b * m_in).to(torch.int64)
    ix = ix.permute(0, 2, 1).reshape(b * m_out, k).contiguous()
    w2 = w.reshape(k * cin, cout)
    return lambda: torch.matmul(fz[ix].reshape(b * m_out, k * cin), w2)


def measure_conv(name, feats, idx, w, kernel=sc.KERNEL, reps=None) -> dict:
    """The gather-GEMM ``kernel`` (the forward, or the dgrad on g, t_idx and
    Wᵀ) against its plain version on these inputs, with kernel, plain,
    library and bound times (``reps``: the ``time_ms`` arguments of each,
    by default ``REPS``). The bound counts the bytes of idx, feats, W and
    out, each once, and the products of this idx's live entries."""
    reps = reps or REPS
    dtype = feats.dtype
    b, m_in, cin = feats.shape
    k, _, cout = w.shape
    m_out = idx.shape[-1]
    got = kernel(feats, idx, w)
    want = sc.sparse_conv_reference(feats, idx, w)
    lib = library_fn(feats, idx, w)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), **TOL[dtype])
    esz = feats.element_size()
    nnz = int((idx >= 0).sum().item())
    nbytes = (idx.numel() * 4 + feats.numel() * esz + w.numel() * esz
              + b * m_out * cout * esz)
    flops = 2 * nnz * cin * cout
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rec = {
        "conv": name, "dtype": str(dtype).replace("torch.", ""), "K": k, "B": b,
        "Cin": cin, "Cout": cout, "M_in": m_in, "M_out": m_out,
        "live_taps": nnz, "dead_pair_share": dead_pair_share(idx, m_in),
        "max_abs_err": err, "tol": TOL[dtype], "ok": bool(ok),
        "kernel_ms": time_ms(lambda: kernel(feats, idx, w), **reps["kernel"]),
        "plain_ms": time_ms(lambda: sc.sparse_conv_reference(feats, idx, w), **reps["plain"]),
        "library_ms": time_ms(lib, **reps["library"]),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    log(f"  {name:18s} {rec['dtype']:8s} K{k:<2d} {cin:>2d}->{cout:<2d} "
        f"M {m_in}->{m_out} B{b} live {nnz / idx.numel():.3f} "
        f"dead (tile, tap) {rec['dead_pair_share']:.3f}: "
        f"kernel_ms={rec['kernel_ms']:.4f} "
        f"plain_ms={rec['plain_ms']:.4f} library_ms(2 calls)={rec['library_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
        f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
    return rec


def require_ok(recs, what):
    bad = [r["conv"] + "/" + r["dtype"] for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"{what}: kernel disagrees with its plain version: {bad}")


def phase_kernel() -> list:
    log("[phase 3] sparse_conv kernel vs plain version on random inputs "
        "(f32 rtol=1e-5 atol=1e-5; bf16 rtol=1e-2 atol=1e-2 against the plain "
        "version on the same bf16 inputs, f32 accumulation)")
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, *shape) in enumerate(CONFIG1_CONVS):
            recs.append(measure_conv(name, *conv_inputs(*shape, dtype, seed=i)))
    for i, (name, *shape, dtype) in enumerate(EXTRA_CONVS):
        recs.append(measure_conv(name, *conv_inputs(*shape, dtype, seed=100 + i)))
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, *shape, live_rows) in enumerate(EDGE_CONVS):
            recs.append(measure_conv(name, *conv_inputs(*shape, dtype, seed=300 + i,
                                                        live_rows=live_rows)))
    require_ok(recs, "random inputs")
    dead_tile_cost(recs, "forward")
    return recs


def dead_tile_cost(recs, role, unit="64-row tile") -> None:
    """Log the all-dead K27 16->16 case's time beside the same shape with
    live rows ending at 60 % of M (``EDGE_CONVS``), and the share of dead
    (``unit``, tap) pairs of each."""
    by = {(r["conv"], r["dtype"]): r for r in recs}
    for dt in ("float32", "bfloat16"):
        dead, tail = by[("all_dead", dt)], by[("dead_tail_60", dt)]
        log(f"  {role} {dt}: all -1 idx {dead['kernel_ms']:.4f} ms vs live rows to 60 % "
            f"of M {tail['kernel_ms']:.4f} ms (ratio {dead['kernel_ms'] / tail['kernel_ms']:.3f}), "
            f"K{dead['K']} {dead['Cin']}->{dead['Cout']}, M {dead['M_out']}; dead ({unit}, tap) "
            f"pairs {dead['dead_pair_share']:.3f} and {tail['dead_pair_share']:.3f}")


# --------------------------------------------------------------------------
# phase 4: the config-1 slice on the card, against the CPU


def tables(st, p2v, scales, aux) -> dict:
    out = {"coords": st.coords, "nvalid": st.nvalid, "p2v": p2v}
    for s, sc_ in enumerate(scales):
        for f in ("coords", "nvalid", "subm_idx", "down_idx", "up_idx"):
            if getattr(sc_, f) is not None:
                out[f"s{s}.{f}"] = getattr(sc_, f)
    out.update({k: v for k, v in aux.items() if v.dtype != torch.float32})
    return {k: v.cpu() for k, v in out.items()}


def run_scene(cfg, model, batch, device):
    tb = TL.to_device(batch, device)
    with torch.no_grad():
        st, p2v, scales, _, aux = TL.prepare_inputs(cfg, tb)
        out = model(st.feats, scales)
        res = infer.to_host(TL.finish(cfg, out, scales, p2v))
    return tables(st, p2v, scales, aux), res


def check_ties() -> None:
    """``lax.top_k`` and ``jnp.argmax`` take the lower index among ties. The
    port's ``topk_rows`` (a stable descending sort) and ``nms_3d``
    (``torch.argmax``) rely on the card doing the same: both are held here
    against numpy on vectors full of ties, at the RPN's candidate length."""
    rng = np.random.default_rng(0)
    x = np.round(rng.normal(size=57344), 1).astype(np.float32)
    x[rng.random(x.size) < 0.3] = -1e9          # masked rows tie at -1e9
    x[:5] = -np.inf
    t = torch.from_numpy(x).cuda()
    order = torch.sort(t, descending=True, stable=True).indices.cpu().numpy()
    if not np.array_equal(order, np.argsort(-x, kind="stable")):
        raise AssertionError("stable descending sort breaks ties differently on the card")
    y = np.zeros(128, np.float32)
    y[[7, 40, 99]] = 3.0
    cases = [x[:128], x[:1000], x, y, np.full(128, -np.inf, np.float32)]
    for v in cases:
        got = int(torch.argmax(torch.from_numpy(v).cuda()))
        if got != int(np.argmax(v)):
            raise AssertionError(f"torch.argmax on the card gave {got}, numpy "
                                 f"{int(np.argmax(v))} (length {v.size})")
    log("  tie-breaking on the card: stable descending sort and argmax take "
        "the lower index, as numpy and lax.top_k/jnp.argmax do")


def capture(fn, name: str) -> list:
    """Run ``fn`` and return the arguments of every call it makes to
    ``sc.<name>`` (``conv_forward``, ``conv_dgrad`` or ``conv_wgrad``, the
    dispatchers of the sparse conv's autograd Function). The calls still
    launch the kernels."""
    calls = []
    real = getattr(sc, name)

    def recording(*args):
        calls.append(args)
        return real(*args)

    setattr(sc, name, recording)
    try:
        fn()
    finally:
        setattr(sc, name, real)
    return calls


def main_path_convs(cfg, model, batch) -> list:
    """The kernel against its plain version, timed, on the inputs that the
    10 convs of one config-1 forward give it (this run's rulebooks)."""
    calls = capture(lambda: run_scene(cfg, model, batch, DEVICE), "conv_forward")
    shapes = [(f.shape[0], w.shape[0], w.shape[1], w.shape[2], f.shape[1], i.shape[-1])
              for f, i, w in calls]
    want = [(cfg.data.batch_size, *c[1:]) for c in CONFIG1_CONVS]
    if shapes != want:
        raise AssertionError(f"config-1 conv shapes {shapes}, expected {want}")
    log("  sparse_conv kernel vs plain version on the inputs of the main path "
        "(scene 0; tolerances as in phase 3)")
    recs = [measure_conv(name, *call) for (name, *_), call in zip(CONFIG1_CONVS, calls)]
    require_ok(recs, "main-path inputs")
    return recs


def timed_split(cfg, model, batch, reps: int = 5) -> dict:
    """Warm ms of one scene, split into hierarchy (voxelize + rulebooks),
    backbone and heads (RPN, NMS, RoI, mask painting, devoxelize)."""
    tb = TL.to_device(batch, DEVICE)
    split = {"hierarchy": [], "backbone": [], "heads": [], "total": []}
    with torch.no_grad():
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, p2v, scales, _, _ = TL.prepare_inputs(cfg, tb)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outs = model.backbone(st.feats, scales)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            TL.finish(cfg, model.heads(outs, scales), scales, p2v)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for key, dt in (("hierarchy", t1 - t0), ("backbone", t2 - t1),
                            ("heads", t3 - t2), ("total", t3 - t0)):
                split[key].append(dt * 1e3)
    return {k: statistics.median(v[1:]) for k, v in split.items()}


def phase_slice(out_dir: str, no_ckpt: str) -> tuple:
    """``no_ckpt``: a checkpoint directory that holds none (the seeded init)."""
    cfg = load_config(CONFIG1)
    n_scenes = 3
    log(f"[phase 4] {cfg.name} at full width (widths {list(cfg.model.backbone.widths)}, "
        f"{cfg.data.num_points} points, capacities {list(cfg.scale_capacities())}), "
        f"{n_scenes} val scenes, seeded init train.seed={cfg.train.seed}")

    # the main path, through the entry point a user calls
    reset_counts()
    infer.main(["--config", CONFIG1, "--num-scenes", str(n_scenes), "--set",
                f"train.checkpoint_dir={no_ckpt}", "--out-dir", os.path.join(out_dir, "infer"),
                "--device", DEVICE])
    torch.cuda.synchronize()
    launches = sc.KERNEL.launches
    if counts()[1:] != (0, 0):
        raise AssertionError(f"inference launched backward kernels: {counts()}")
    forwards = -(-n_scenes // cfg.data.batch_size)
    log(f"  sparse_conv launches in infer.main: {launches} "
        f"({forwards} forwards, 10 expected per forward)")
    if launches != 10 * forwards:
        raise AssertionError(f"expected {10 * forwards} kernel launches, got {launches}")
    for i in range(n_scenes):
        with np.load(os.path.join(out_dir, "infer", f"scene{i:04d}.npz")) as f:
            if not (np.isfinite(f["scores"]).all() and f["points"].shape[1] == 3
                    and f["instance"].shape == (f["points"].shape[0],)):
                raise AssertionError(f"infer output scene{i:04d}.npz malformed")

    check_ties()
    # the same weights and scenes on the card and on the CPU
    seed = cfg.train.seed
    m_gpu = TL.build_model(cfg, DEVICE, torch.Generator().manual_seed(seed))
    m_cpu = TL.build_model(cfg, "cpu", torch.Generator().manual_seed(seed))
    batches = list(itertools.islice(EvalBatches(cfg, "val"), n_scenes))
    worst = {}
    for i, batch in enumerate(batches):
        before = sc.KERNEL.launches
        tab_g, res_g = run_scene(cfg, m_gpu, batch, DEVICE)
        torch.cuda.synchronize()
        if sc.KERNEL.launches - before != 10:
            raise AssertionError(f"scene {i}: {sc.KERNEL.launches - before} launches, not 10")
        tab_c, res_c = run_scene(cfg, m_cpu, batch, "cpu")
        for key in tab_c:
            if not torch.equal(tab_g[key], tab_c[key]):
                raise AssertionError(f"scene {i}: table {key} differs between card and CPU")
        for key in ("proposal_mask", "point_semantic_pred"):
            if not np.array_equal(res_g[key], res_c[key]):
                raise AssertionError(f"scene {i}: {key} differs between card and CPU")
        tol = {"proposal_scores": (1e-4, 1e-4), "cls_logits": (1e-4, 1e-4),
               # bf16-read logits: one f32 ulp can move them one bf16 ulp
               "point_mask_logits": (1e-2, 1e-3)}
        for key, (rtol, atol) in tol.items():
            np.testing.assert_allclose(res_g[key], res_c[key], rtol=rtol, atol=atol,
                                       err_msg=f"scene {i}: {key}")
            worst[key] = max(worst.get(key, 0.0),
                             float(np.abs(res_g[key] - res_c[key]).max()))
        for b in range(cfg.data.batch_size):
            g = infer.scene_result(res_g, b, cfg.model.num_classes)
            c = infer.scene_result(res_c, b, cfg.model.num_classes)
            if not np.array_equal(g[2], c[2]):
                raise AssertionError(f"scene {i}: pred_cls differs between card and CPU")
            log(f"  scene {i}: {int(g[3].sum())} instances, {int((g[0] >= 0).sum())} "
                f"labeled points; voxels {tab_g['nvalid'].tolist()}, overflow "
                f"voxel={int(tab_g['voxel_overflow'])} "
                f"hierarchy={int(tab_g['hierarchy_overflow'])}; tables bit-exact, "
                f"masks/classes exact vs CPU, "
                f"instance points differing {int((g[0] != c[0]).sum())}")
    log(f"  card vs CPU max abs diff: {json.dumps(worst)} "
        "(tolerances rtol/atol 1e-4/1e-4 for scores and cls logits, "
        "1e-2/1e-3 for point-mask logits)")
    split = [timed_split(cfg, m_gpu, b) for b in batches]
    per = {k: statistics.mean(s[k] for s in split) for k in split[0]}
    log(f"  warm ms per scene (host clock, synchronised, median of 5 per scene, "
        f"mean of {len(split)} scenes): " + json.dumps({k: round(v, 3) for k, v in per.items()}))
    return launches, per, main_path_convs(cfg, m_gpu, batches[0])


# --------------------------------------------------------------------------
# phase 5: the reference on the card


def phase_golden() -> int:
    with np.load(FIXTURE) as f:
        flat = {k: f[k] for k in f.files}
    spec = json.loads(str(flat.pop("__config__")))
    cfg = load_config(overrides=spec["overrides"])
    model = TL.build_model(cfg, DEVICE)
    model.load_state_dict(from_flax(*unflatten_variables(flat)))
    kw = dict(spec["scene"])
    batch = synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw)
    before = sc.KERNEL.launches
    out = infer.to_host(TL.eval_step(cfg, model, TL.to_device(batch, DEVICE)))
    torch.cuda.synchronize()
    launches = sc.KERNEL.launches - before
    inst, scores, pred_cls, pmask = infer.scene_result(out, 0, cfg.model.num_classes)
    want = np.load(GOLDEN)
    np.testing.assert_array_equal(pred_cls.astype(np.int32), want["pred_cls"])
    np.testing.assert_array_equal(pmask.astype(np.int32), want["pmask"])
    np.testing.assert_allclose(scores.astype(np.float32), want["scores"],
                               rtol=1e-4, atol=1e-5)
    diff = np.nonzero(inst != want["instance"])[0]
    # a point may flip only where a valid proposal's logit sits within 1e-4 of 0
    logits = out["point_mask_logits"][0][pmask]
    near_zero = (np.abs(logits[:, diff]) < 1e-4).any(axis=0)
    if not near_zero.all():
        raise AssertionError(f"golden: {int((~near_zero).sum())} points differ "
                             "with no logit near 0")
    log(f"[phase 5] golden_config1 on the card from the JAX-init weights: pred_cls, "
        f"pmask exact, scores within rtol 1e-4/atol 1e-5, instance differs on "
        f"{len(diff)} points (allowed: logit within 1e-4 of 0); {launches} kernel launches")
    if launches != 10:
        raise AssertionError(f"golden forward launched the kernel {launches} times, not 10")
    return len(diff)


# --------------------------------------------------------------------------
# phase 3, backward: the dgrad and wgrad kernels against their plain versions


def bwd_inputs(k, cin, cout, m_in, m_out, dtype, seed, live_rows=(1.0,)):
    """Random feats [B, M_in, Cin], cotangent g [B, M_out, Cout], W and a
    transposed rulebook t_idx [B, K, M_in] with about 30 % of entries -1,
    one scene per entry of ``live_rows`` (see ``kill_rows``)."""
    b = len(live_rows)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    feats = torch.randn((b, m_in, cin), generator=gen, device=DEVICE).to(dtype)
    g = torch.randn((b, m_out, cout), generator=gen, device=DEVICE).to(dtype)
    w = (torch.randn((k, cin, cout), generator=gen, device=DEVICE)
         * (2.0 / (k * cin)) ** 0.5).to(dtype)
    rows = torch.randint(0, m_out, (b, k, m_in), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    miss = kill_rows(torch.rand((b, k, m_in), generator=gen, device=DEVICE) < 0.3, live_rows)
    return feats, torch.where(miss, -1, rows).contiguous(), g, w


def measure_dgrad(name, g, t_idx, w, reps=None) -> dict:
    """The dgrad: the gather-GEMM kernel on (g, t_idx, Wᵀ), measured as the
    forward is (``measure_conv``)."""
    rec = measure_conv(name, g, t_idx, w.transpose(1, 2).contiguous(), kernel=sc.DGRAD,
                       reps=reps)
    rec["role"] = "dgrad"
    return rec


def wgrad_library_fn(feats, t_idx, g):
    """The nearest library composition of the wgrad, two calls: a row gather
    ``g[t_idx]`` ([K, B*M_in, Cout], a zero row for the -1 entries) and one
    ``torch.matmul`` with featsᵀ [Cin, B*M_in]. Index prep is done once,
    outside the timing."""
    b, m_in, cin = feats.shape
    m_out, cout = g.shape[1], g.shape[2]
    k = t_idx.shape[1]
    gz = torch.cat([g.reshape(b * m_out, cout), g.new_zeros((1, cout))])
    base = torch.arange(b, device=t_idx.device)[:, None, None] * m_out
    ix = torch.where(t_idx >= 0, t_idx + base, b * m_out).to(torch.int64)
    ix = ix.permute(1, 0, 2).reshape(k, b * m_in).contiguous()
    f_t = feats.reshape(b * m_in, cin).t()
    return lambda: torch.matmul(f_t, gz[ix])


def measure_wgrad(name, feats, t_idx, g, reps=None) -> dict:
    """The wgrad kernel against its plain version on these inputs, checked
    bit-identical across two launches, with kernel, plain, library and
    bound times and the share of (32-row stage, tap) pairs of t_idx with no
    live entry. The bound counts the bytes of t_idx, feats, g and the f32
    out, each once, and the products of t_idx's live entries."""
    reps = reps or REPS
    dtype = feats.dtype
    b, m_in, cin = feats.shape
    cout = g.shape[2]
    k = t_idx.shape[1]
    got = sc.WGRAD(feats, t_idx, g)
    again = sc.WGRAD(feats, t_idx, g)
    want = sc.sparse_conv_wgrad_reference(feats, t_idx, g)
    lib = wgrad_library_fn(feats, t_idx, g)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, again))
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    ok = same and torch.allclose(got, want, rtol=WGRAD_RTOL, atol=WGRAD_RTOL * scale)
    esz = feats.element_size()
    nnz = int((t_idx >= 0).sum().item())
    nbytes = t_idx.numel() * 4 + feats.numel() * esz + g.numel() * esz + k * cin * cout * 4
    flops = 2 * nnz * cin * cout
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rec = {
        "conv": name, "role": "wgrad", "dtype": str(dtype).replace("torch.", ""), "K": k,
        "Cin": cin, "Cout": cout, "M_in": m_in, "M_out": g.shape[1], "B": b, "live_taps": nnz,
        "dead_pair_share": dead_pair_share(t_idx, g.shape[1], WGRAD_STAGE), "max_abs_err": err,
        "tol": {"rtol": WGRAD_RTOL, "atol": WGRAD_RTOL * scale},
        "bit_identical": same, "ok": bool(ok),
        "kernel_ms": time_ms(lambda: sc.WGRAD(feats, t_idx, g), **reps["kernel"]),
        "plain_ms": time_ms(lambda: sc.sparse_conv_wgrad_reference(feats, t_idx, g),
                            **reps["plain"]),
        "library_ms": time_ms(lib, **reps["library"]),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    log(f"  {name:18s} {rec['dtype']:8s} K{k:<2d} {cin:>2d}->{cout:<2d} "
        f"M {m_in}<-{g.shape[1]} B{b} live {nnz / t_idx.numel():.3f} "
        f"dead (stage, tap) {rec['dead_pair_share']:.3f}: "
        f"kernel_ms={rec['kernel_ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"library_ms(2 calls)={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}) max_abs_err={err:.3e} bit_identical={same} "
        f"{'ok' if ok else 'MISMATCH'}")
    return rec


def phase_backward_kernels() -> list:
    log("[phase 3, backward] dgrad (the gather-GEMM on g, t_idx, Wᵀ; tolerances as "
        "the forward's) and wgrad (rtol 1e-4, atol 1e-4 x max |plain|; bit-identical "
        "across two launches) vs their plain versions on random inputs")
    recs = []
    shapes = ([(name, *shape, dtype) for dtype in (torch.float32, torch.bfloat16)
               for name, *shape in CONFIG1_CONVS] + EXTRA_CONVS)
    for i, (name, k, cin, cout, m_in, m_out, dtype) in enumerate(shapes):
        feats, t_idx, g, w = bwd_inputs(k, cin, cout, m_in, m_out, dtype, seed=200 + i)
        recs.append(measure_dgrad(name, g, t_idx, w))
        recs.append(measure_wgrad(name, feats, t_idx, g))
    # the edge cases, launched at their shapes. The dgrad's gather reads g
    # (the conv's Cout wide) through t_idx into the conv's M_in rows; the
    # wgrad's reads g through t_idx [B, K, M_in] of the conv's own shape,
    # its dead rows the rows of feats that its stages walk
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, k, cin_l, cout_l, m_in_l, m_out_l, live_rows) in enumerate(EDGE_CONVS):
            _, t_idx, g, w = bwd_inputs(k, cout_l, cin_l, m_out_l, m_in_l, dtype,
                                        seed=400 + i, live_rows=live_rows)
            recs.append(measure_dgrad(name, g, t_idx, w))
            feats, t_idx, g, _ = bwd_inputs(k, cin_l, cout_l, m_in_l, m_out_l, dtype,
                                            seed=500 + i, live_rows=live_rows)
            recs.append(measure_wgrad(name, feats, t_idx, g))
    require_ok(recs, "backward kernels, random inputs")
    dead_tile_cost([r for r in recs if r["role"] == "dgrad"], "dgrad")
    dead_tile_cost([r for r in recs if r["role"] == "wgrad"], "wgrad", "32-row stage")
    return recs


# --------------------------------------------------------------------------
# phase 6: the config-1 training slice on the card, against the CPU


def counts() -> tuple:
    return sc.KERNEL.launches, sc.DGRAD.launches, sc.WGRAD.launches


def reset_counts() -> None:
    sc.KERNEL.launches = sc.DGRAD.launches = sc.WGRAD.launches = 0


def grad_errors(grads_a, grads_b, names) -> dict:
    """max |a - b| / max |b| per parameter."""
    out = {}
    for n, a, b in zip(names, grads_a, grads_b):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        out[n] = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
    return out


def params_close(got: dict, want: dict, lr_sum: float, what: str) -> dict:
    diffs = torch.cat([(got[k].detach().float().cpu() - want[k].detach().float().cpu())
                       .abs().ravel() for k in want])
    share = (diffs > PARAM_ATOL).float().mean().item()
    rec = {"max_abs_diff": diffs.max().item(), "share_past_atol": share,
           "bound": 2 * lr_sum}
    if rec["max_abs_diff"] > 2 * lr_sum or share > PARAM_OUTLIERS:
        raise AssertionError(f"{what}: params differ {rec}")
    return rec


def step_split(cfg, state, batch, reps: int = 5) -> dict:
    """Warm ms of one train step (host clock, synchronised after each
    stage), split as ``TL.train_step`` runs it: prepare (voxelize,
    hierarchy, GT), forward (model in training mode and losses), backward,
    optimizer (``benchmarks/profile_torch_slice.py::train_step``)."""
    split = [PROF.train_step(cfg, state, batch) for _ in range(reps + 1)]
    return {k: statistics.median(s[k] for s in split[1:]) for k in split[0]}


def main_path_backward(cfg, model, batch) -> tuple:
    """The dgrad and wgrad kernels against their plain versions, timed, on
    the inputs that one config-1 train step's backward gives them."""
    dg = []
    wg = capture(lambda: dg.extend(capture(
        lambda: TL.loss_and_grads(cfg, model, batch), "conv_dgrad")), "conv_wgrad")
    if (len(dg), len(wg)) != PER_STEP[1:]:
        raise AssertionError(f"{len(dg)} dgrad and {len(wg)} wgrad calls in one step")
    log("  dgrad and wgrad kernels vs plain versions on the inputs of the main path "
        "(one config-1 train step, in backward order; tolerances as in phase 3)")

    def name(w):
        return f"K{w.shape[0]} {w.shape[1]}->{w.shape[2]}"
    d = [measure_dgrad(name(w), g, t, w) for g, t, w in dg]
    w_ = [measure_wgrad(f"K{t.shape[1]} {f.shape[2]}->{g.shape[2]}", f, t, g)
          for f, t, g in wg]
    require_ok(d + w_, "backward kernels, main-path inputs")
    log("  dead pairs on the main path, dgrad (64-row tile, tap): "
        + ", ".join(f"{r['dead_pair_share']:.3f}" for r in d)
        + "; wgrad (32-row stage, tap): "
        + ", ".join(f"{r['dead_pair_share']:.3f}" for r in w_))
    return d, w_


def phase_train(out_dir: str) -> dict:
    """``train.main``'s checkpoints go to ``out_dir``/ckpt_train."""
    cfg = load_config(CONFIG1)
    log(f"[phase 6] {cfg.name} training at full width (widths "
        f"{list(cfg.model.backbone.widths)}, {cfg.data.num_points} points, capacities "
        f"{list(cfg.scale_capacities())}, {cfg.model.num_classes} classes, AdamW, "
        f"clip {cfg.train.grad_clip}), seeded init train.seed={cfg.train.seed}")
    log_path = os.path.join(out_dir, "train_log.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)

    # the main path, through the entry point a user calls
    reset_counts()
    ckpt = os.path.join(out_dir, "ckpt_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    train_cli.main(["--config", CONFIG1, "--set", f"train.total_steps={TRAIN_STEPS}",
                    "--set", "train.log_every=1", "--set", f"train.checkpoint_dir={ckpt}",
                    "--device", DEVICE, "--log-file", log_path])
    torch.cuda.synchronize()
    launches = counts()
    want = tuple(TRAIN_STEPS * n for n in PER_STEP)
    log(f"  launches in train.main over {TRAIN_STEPS} steps (forward, dgrad, wgrad): "
        f"{launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"train.main launched {launches}, expected {want}")
    with open(log_path) as f:
        lines = [json.loads(line) for line in f]
    steps = [r for r in lines if r["kind"] == "train"]
    keys = ("rpn_obj", "rpn_box", "roi_cls", "roi_mask", "semantic", "total", "grad_norm")
    if len(steps) != TRAIN_STEPS or not all(np.isfinite(r[k]) for r in steps for k in keys):
        raise AssertionError(f"train.main logged {steps}")
    log("  losses per step: " + json.dumps([{k: round(r[k], 5) for k in ("step",) + keys}
                                            for r in steps]))

    # the same weights and batches on the card and on the CPU
    stream = TrainStream(cfg, seed=cfg.train.seed)
    batches = [next(stream) for _ in range(3)]
    init = TL.build_model(cfg, "cpu", torch.Generator().manual_seed(cfg.train.seed))
    names = [n for n, _ in init.named_parameters()]
    report = {"launches": launches, "losses": steps}
    for wname, weights in LOSS_WEIGHTS.items():
        cfg_w = load_config(CONFIG1, {"train": {"loss_weights": weights}})
        res = {}
        for dev in (DEVICE, "cpu"):
            model = copy.deepcopy(init).to(dev)
            before = counts()
            res[dev] = TL.loss_and_grads(cfg_w, model, TL.to_device(batches[0], dev,
                                                                     TL.TRAIN_KEYS))
            torch.cuda.synchronize()
            delta = tuple(a - b for a, b in zip(counts(), before))
            if dev == DEVICE and delta != PER_STEP:
                raise AssertionError(f"one train step launched {delta}, expected {PER_STEP}")
        (tg, pg, gg, _), (tc, pc, gc, _) = res[DEVICE], res["cpu"]
        for k in pc:
            np.testing.assert_allclose(float(pg[k]), float(pc[k]), rtol=1e-4,
                                       err_msg=f"{wname} {k}")
        parts_rel = max(abs(float(pg[k]) - float(pc[k])) / abs(float(pc[k])) for k in pc)
        errs = grad_errors(gg, gc, names)
        rest = {n: e for n, e in errs.items() if not n.startswith("roi_head.")}
        roi = {n: e for n, e in errs.items() if n.startswith("roi_head.")}
        w_rest, w_roi = max(rest, key=rest.get), max(roi, key=roi.get)
        log(f"  loss weights {weights}: card vs CPU loss parts within rtol 1e-4 "
            f"(worst {parts_rel:.3e}; {json.dumps({k: float(pg[k]) for k in pg})}); grads worst "
            f"|card - cpu| / max|cpu|: {rest[w_rest]:.3e} ({w_rest}; tolerance "
            f"{GRAD_TOL[wname]}), RoI head {roi[w_roi]:.3e} ({w_roi}; tolerance "
            f"{GRAD_TOL_ROI_HEAD}); median {statistics.median(errs.values()):.3e}")
        if rest[w_rest] > GRAD_TOL[wname] or roi[w_roi] > GRAD_TOL_ROI_HEAD:
            raise AssertionError(f"{wname}: grads differ: {w_rest} {rest[w_rest]}, "
                                 f"{w_roi} {roi[w_roi]}")
        report[f"grad_err_{wname}"] = errs
        report[f"loss_parts_rel_err_{wname}"] = parts_rel

    # params after 3 steps, card and CPU
    states = {}
    for dev in (DEVICE, "cpu"):
        st = TL.init_state(cfg, model=copy.deepcopy(init).to(dev))
        for b in batches:
            TL.train_step(cfg, st, TL.to_device(b, dev, TL.TRAIN_KEYS))
        states[dev] = st
    lr_sum = sum(TL.make_schedule(cfg)(i) for i in range(3))
    report["params_after_3"] = params_close(states[DEVICE].model.state_dict(),
                                            states["cpu"].model.state_dict(), lr_sum,
                                            "card vs CPU after 3 steps")
    log(f"  params and BN statistics after 3 steps, card vs CPU: "
        f"{json.dumps(report['params_after_3'])} (allowed: all within the bound, at "
        f"most {PARAM_OUTLIERS} of the entries past {PARAM_ATOL})")

    # run to run: one step twice from the same state, on the card and on
    # the CPU (where the plain versions run): bit-identical on both
    for dev in (DEVICE, "cpu"):
        runs = [TL.loss_and_grads(cfg, copy.deepcopy(init).to(dev),
                                  TL.to_device(batches[0], dev, TL.TRAIN_KEYS))
                for _ in range(2)]
        rr = {n: (a - b).abs().max().item() for n, a, b in zip(names, runs[0][2], runs[1][2])}
        report[f"run_to_run_{dev}"] = {"grad_max_abs_diff": max(rr.values()),
                                       "params_differing": sorted(n for n, v in rr.items() if v),
                                       "loss": [float(r[0]) for r in runs]}
        log(f"  run to run, one step's gradients on {dev}: max |diff| "
            f"{max(rr.values()):.3e}, parameters differing: "
            f"{sorted(n for n, v in rr.items() if v) or 'none'}; loss "
            f"{float(runs[0][0])!r} vs {float(runs[1][0])!r}")
        if max(rr.values()) != 0 or float(runs[0][0]) != float(runs[1][0]):
            raise AssertionError(f"one step on {dev} is not bit-identical run to run: "
                                 f"{report[f'run_to_run_{dev}']}")

    state =TL.init_state(cfg, model=copy.deepcopy(init).to(DEVICE))
    split = [step_split(cfg, state, TL.to_device(b, DEVICE, TL.TRAIN_KEYS)) for b in batches]
    report["step_ms"] = {k: statistics.mean(s[k] for s in split) for k in split[0]}
    log("  warm ms per train step (host clock, synchronised after each stage, median "
        f"of 5 per batch, mean of {len(split)} batches): "
        + json.dumps({k: round(v, 3) for k, v in report["step_ms"].items()}))
    report["dgrad_main_path"], report["wgrad_main_path"] = main_path_backward(
        cfg, copy.deepcopy(init).to(DEVICE), TL.to_device(batches[0], DEVICE, TL.TRAIN_KEYS))
    return report


# --------------------------------------------------------------------------
# phase 7: JAX's train trajectory on the card


def phase_golden_train() -> dict:
    with np.load(FIXTURE) as f:
        flat = {k: f[k] for k in f.files}
    spec = json.loads(str(flat.pop("__config__")))
    with np.load(TRAIN_FIXTURE) as f:
        want = {k: f[k] for k in f.files}
    meta = json.loads(str(want.pop("__config__")))
    cfg = load_config(overrides={**spec["overrides"], "train": meta["train"]})
    model = TL.build_model(cfg, DEVICE)
    model.load_state_dict(from_flax(*unflatten_variables(flat)))
    state = TL.init_state(cfg, model=model)
    kw = dict(spec["scene"])
    batch = TL.to_device(synthetic.generate_batch(kw.pop("seed"), kw.pop("batch_size"), **kw),
                         DEVICE, TL.TRAIN_KEYS)
    worst = {}
    for i in range(meta["steps"]):
        _, m = TL.train_step(cfg, state, batch)
        for k, tol in (("rpn_obj", 1e-4), ("rpn_box", 1e-4), ("roi_cls", 1e-4),
                       ("roi_mask", 1e-4), ("semantic", 1e-4), ("total", 1e-4),
                       ("grad_norm", 1e-3)):
            ref = float(want[f"metrics/{k}"][i])
            np.testing.assert_allclose(float(m[k]), ref, rtol=tol, err_msg=f"step {i} {k}")
            worst[k] = max(worst.get(k, 0.0), abs(float(m[k]) - ref) / abs(ref))
    lr_sum = sum(TL.make_schedule(cfg)(i) for i in range(meta["steps"]))
    params = params_close(model.state_dict(), from_flax(*unflatten_variables(
        {k: v for k, v in want.items() if not k.startswith("metrics/")})), lr_sum,
        "golden train trajectory")
    log(f"[phase 7] golden_config1_train on the card from the JAX-init weights, "
        f"{meta['steps']} steps: loss parts within rtol 1e-4 and grad_norm 1e-3 of JAX "
        f"(worst relative {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}); "
        f"params and BN statistics {json.dumps(params)}")
    return {"metrics_rel_err": worst, "params": params}


# --------------------------------------------------------------------------
# phase 8: config 2 (ScanNet 2 cm) on the card: dense tail, bf16


def sparse_convs(model) -> int:
    """The backbone's sparse convs: launches of one forward."""
    return sum(isinstance(m, SparseConv) for m in model.backbone.modules())


def config2_scenes(cfg, n: int = 4) -> list:
    """``bench.py``'s config-2 scenes through the port's own generator and
    augmentation: seeds 100+i, 12 instances, 18 classes, extent 8.0, then
    the config's augmentation and crop to ``scene_bounds``, rng seed 7."""
    rng = np.random.default_rng(7)
    return [augment_scene(synthetic.generate_scene(
        100 + i, num_points=cfg.data.num_points, num_instances=12, num_classes=18,
        extent=8.0), cfg.data, rng) for i in range(n)]


def oob_sites(cfg, batch, s0: int) -> int:
    """The sites of scale ``s0`` that fall outside the dense grid, counted
    in numpy from the points, apart from the port's voxelize, rebase and
    hierarchy: voxel = floor(point / voxel size), rebased to a least
    coordinate of 2 per scene (``rebase_coords``' margin), halved ``s0``
    times."""
    vs = np.asarray(cfg.data.voxel_size, np.float32)
    ext = np.asarray(cfg.model.backbone.grid_extent) >> s0
    n = 0
    for pts, valid in zip(batch["points"], batch["valid"]):
        c = np.unique(np.floor(pts[valid.astype(bool)] / vs).astype(np.int64), axis=0)
        c = np.unique((c - c.min(0) + 2) >> s0, axis=0)
        n += int(((c < 0) | (c >= ext)).any(1).sum())
    return n


def int_tables(cfg, batch, device) -> dict:
    """Site sets, rulebooks (none at the dense scales), counters and the
    dense tail's occupancy of ``batch`` on ``device``."""
    with torch.no_grad():
        st, p2v, scales, _, aux = TL.prepare_inputs(cfg, TL.to_device(batch, device,
                                                                        TL.TRAIN_KEYS))
        s0 = cfg.model.backbone.dense_from_scale
        sc0 = scales[s0]
        ext = [e >> s0 for e in cfg.model.backbone.grid_extent]
        _, occ = scatter_to_grid(sc0.coords, sc0.nvalid,
                                 sc0.coords.new_zeros(sc0.coords.shape[:2] + (1,)), ext)
    out = tables(st, p2v, scales, aux)
    out["occupancy"] = occ.cpu()
    return out


def dense_vs_sparse(cfg, sd, batch) -> dict:
    """Per-scale backbone outputs of weights ``sd`` run in the eval form
    (dense tail) and converted to the fully sparse form, in f32 and in bf16:
    max |dense - sparse| / max |sparse| per scale. f32 within 2e-3 (rtol and
    atol, ``tests/parity/test_dense_tail.py``); bf16 within
    ``DENSE_SPARSE_BF16`` of each scale's largest entry. Also the warm ms
    of each form's backbone forward."""
    res = {}
    for dtype in ("float32", "bfloat16"):
        c_d = load_config(CONFIG2, infer.parse_overrides(C2_SET + [f"model.backbone.dtype={dtype}"]))
        c_s = load_config(CONFIG2, infer.parse_overrides(C2_SET + [
            f"model.backbone.dtype={dtype}", "model.backbone.dense_from_scale=None",
            "model.backbone.dense_from_scale_train=None"]))
        outs = []
        for form, c, weights in (("dense-2", c_d, sd),
                                 ("sparse", c_s, convert_variables(sd, None))):
            model = TL.build_model(c, DEVICE)
            model.load_state_dict(weights)
            with torch.no_grad():
                st, _, scales, _, _ = TL.prepare_inputs(c, TL.to_device(batch, DEVICE))
                outs.append([o.float() for o in model.backbone(st.feats, scales)])
                res[f"backbone_ms_{form}_{dtype}"] = timed_steps(
                    lambda _: model.backbone(st.feats, scales), [None], reps=3)["median"]
        errs = []
        for s, (d, sp) in enumerate(zip(*outs)):
            scale = sp.abs().max().item()
            errs.append((d - sp).abs().max().item() / scale)
            ok = (torch.allclose(d, sp, rtol=2e-3, atol=2e-3) if dtype == "float32"
                  else errs[-1] <= DENSE_SPARSE_BF16)
            if not ok:
                raise AssertionError(f"dense-2 != sparse at scale {s} in {dtype}: "
                                     f"max |diff| / max |sparse| {errs[-1]:.3e}")
        res[dtype] = errs
    errs = {k: [float(f"{e:.3e}") for e in res[k]] for k in ("float32", "bfloat16")}
    log("  dense-2 vs fully sparse, same weights, per scale max |dense - sparse| / max "
        f"|sparse|: {json.dumps(errs)} (f32 rtol=atol=2e-3, bf16 {DENSE_SPARSE_BF16} of the largest entry); backbone "
        "forward, warm ms (median of 3): " + json.dumps(
            {k: round(v, 3) for k, v in res.items() if k.startswith("backbone_ms")}))
    return res


def timed_steps(fn, items, reps: int) -> dict:
    """Host ms of ``fn(item)`` ending in a synchronise, warm: median, min and
    max over ``reps`` runs of every item after one warm-up run each."""
    times = []
    for i, it in enumerate(items):
        for r in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(it)
            torch.cuda.synchronize()
            if r:
                times.append((time.perf_counter() - t0) * 1e3)
    return {"median": statistics.median(times), "min": min(times), "max": max(times),
            "n": len(times)}


def phase_config2(out_dir: str, tmp_dir: str) -> dict:
    """``tmp_dir``: where ``train.main`` saves its checkpoint (140 MB)."""
    cfg = load_config(CONFIG2, infer.parse_overrides(C2_SET))
    tcfg = TL.train_cfg(cfg)
    bb = cfg.model.backbone
    log(f"[phase 8] {cfg.name} (--set {' '.join(C2_SET)}) at full width: widths "
        f"{list(bb.widths)}, {bb.blocks_per_scale} blocks per scale, {bb.dtype}, dense tail "
        f"from scale {bb.dense_from_scale} (eval) and {tcfg.model.backbone.dense_from_scale} "
        f"(train), grid {list(bb.grid_extent)}, {cfg.data.num_points} points, batch "
        f"{cfg.data.batch_size}, capacities {list(cfg.scale_capacities())}")
    sets = sum((["--set", x] for x in C2_SET), [])
    init = TL.build_model(tcfg, DEVICE, torch.Generator().manual_seed(cfg.train.seed))
    ev = TL.eval_model(cfg, init)
    n_eval, n_train = sparse_convs(ev), sparse_convs(init)
    rep = {"sparse_convs": {"eval": n_eval, "train": n_train}}

    # the main paths, through the entry points a user calls
    reset_counts()
    infer.main(["--config", CONFIG2, *sets, "--set",
                f"train.checkpoint_dir={os.path.join(tmp_dir, 'none')}",
                "--num-scenes", str(cfg.data.batch_size),
                "--out-dir", os.path.join(out_dir, "infer_config2"), "--device", DEVICE])
    torch.cuda.synchronize()
    rep["launches_infer"] = counts()
    log(f"  launches in infer.main, one batch (forward, dgrad, wgrad): {counts()}, "
        f"expected ({n_eval}, 0, 0)")
    if counts() != (n_eval, 0, 0):
        raise AssertionError(f"config-2 infer.main launched {counts()}")
    log_path = os.path.join(out_dir, "train_log_config2.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    reset_counts()
    state = train_cli.main(["--config", CONFIG2, *sets, "--set",
                            f"train.total_steps={C2_TRAIN_STEPS}", "--set", "train.log_every=1",
                            "--set", f"train.checkpoint_dir={os.path.join(tmp_dir, 'phase8')}",
                            "--device", DEVICE, "--log-file", log_path])
    torch.cuda.synchronize()
    rep["launches_train"] = counts()
    want = (C2_TRAIN_STEPS * n_train, C2_TRAIN_STEPS * (n_train - 1), C2_TRAIN_STEPS * n_train)
    log(f"  launches in train.main over {C2_TRAIN_STEPS} steps: {counts()}, expected {want}")
    if counts() != want:
        raise AssertionError(f"config-2 train.main launched {counts()}, expected {want}")
    with open(log_path) as f:
        steps = [r for r in map(json.loads, f) if r["kind"] == "train"]
    keys = ("rpn_obj", "rpn_box", "roi_cls", "roi_mask", "semantic", "total", "grad_norm")
    if len(steps) != C2_TRAIN_STEPS or not all(np.isfinite(r[k]) for r in steps for k in keys):
        raise AssertionError(f"config-2 train.main logged {steps}")
    if not all(t.dtype == torch.float32 for t in state.model.state_dict().values()):
        raise AssertionError("config-2 training left a parameter or statistic not in f32")
    rep["losses"] = steps
    log("  losses per step: " + json.dumps([{k: round(r[k], 5) for k in ("step",) + keys}
                                            for r in steps]) + "; parameters stay f32")
    del state

    scenes = config2_scenes(cfg)
    bs = cfg.data.batch_size
    batches = [collate(scenes[i:i + bs]) for i in range(0, len(scenes), bs)]
    # the integer tables of one scene, card against CPU
    one = {k: v[:1] for k, v in batches[0].items()}
    tab_g, tab_c = int_tables(cfg, one, DEVICE), int_tables(cfg, one, "cpu")
    for key in tab_c:
        if not torch.equal(tab_g[key], tab_c[key]):
            raise AssertionError(f"config 2: table {key} differs between card and CPU")
    log(f"  scene 0 tables (site sets, rulebooks of scales 0-1, none at 2-4, counters, "
        f"occupancy of the scale-2 grid, {int(tab_g['occupancy'].sum())} cells): "
        f"card and CPU bit-exact ({len(tab_c)} tables)")
    # counters of the bench batches, eval and train forms
    rep["counters"] = []
    for i, b in enumerate(batches):
        for c in (cfg, tcfg):
            with torch.no_grad():
                aux = TL.prepare_inputs(c, TL.to_device(b, DEVICE, TL.TRAIN_KEYS))[4]
            cnt = {k: int(aux[k]) for k in ("voxel_overflow", "hierarchy_overflow",
                                            "dense_tail_oob", "gt_instance_overflow")}
            cnt["voxels"] = float(aux["voxels_per_scene"])
            s0 = c.model.backbone.dense_from_scale
            want = oob_sites(c, b, s0)
            rep["counters"].append({"batch": i, "dense_from_scale": s0, **cnt})
            log(f"  batch {i}, dense-{s0}: {json.dumps(cnt)}; sites outside the grid "
                f"counted from the points: {want}")
            if cnt["dense_tail_oob"] != want or cnt["voxel_overflow"] or cnt["hierarchy_overflow"]:
                raise AssertionError(f"config 2, batch {i}: counters {cnt}, {want} sites "
                                     "outside the grid counted from the points")
    # dense == sparse holds where the tail drops no site
    exact = [i for i, r in enumerate(rep["counters"])
             if r["dense_from_scale"] == bb.dense_from_scale and not r["dense_tail_oob"]]
    if not exact:
        raise AssertionError("config 2: every bench batch drops sites from the dense grid")

    # eval: the forward kernel on one forward's inputs
    tb = [TL.to_device(b, DEVICE) for b in batches]
    calls = capture(lambda: TL.eval_step(cfg, ev, tb[0]), "conv_forward")
    if len(calls) != n_eval:
        raise AssertionError(f"{len(calls)} forward convs in one config-2 forward")
    log(f"  sparse_conv kernel vs plain version on the {n_eval} convs of one config-2 eval "
        "forward (bf16 rtol=atol=1e-2)")
    rep["forward_main_path"] = [measure_conv(f"K{w.shape[0]} {w.shape[1]}->{w.shape[2]}",
                                             f, i, w, reps=QUICK_REPS) for f, i, w in calls]
    require_ok(rep["forward_main_path"], "config-2 forward, main-path inputs")
    rep["dense_vs_sparse"] = dense_vs_sparse(cfg, ev.state_dict(),
                                             batches[rep["counters"][exact[0]]["batch"]])
    eval_ms = timed_steps(lambda b: TL.eval_step(cfg, ev, b), tb, reps=4)
    rep["eval_ms_per_scene"] = {k: v / bs if k != "n" else v for k, v in eval_ms.items()}
    log("  eval step, warm ms per scene (host clock, synchronised, 4 runs of each batch "
        "after one): " + json.dumps({k: round(v, 3) for k, v in
                                     rep["eval_ms_per_scene"].items()}))
    del tb, calls

    # train: the backward kernels on one step's inputs, run to run, remat
    trb = [TL.to_device(b, DEVICE, TL.TRAIN_KEYS) for b in batches]
    dg = []
    wg = capture(lambda: dg.extend(capture(
        lambda: TL.loss_and_grads(tcfg, copy.deepcopy(init), trb[0]), "conv_dgrad")),
        "conv_wgrad")
    if (len(dg), len(wg)) != (n_train - 1, n_train):
        raise AssertionError(f"{len(dg)} dgrad and {len(wg)} wgrad calls in one step")
    log(f"  dgrad and wgrad kernels vs plain versions on the inputs of one config-2 train "
        f"step ({len(dg)} and {len(wg)} calls, bf16; tolerances as in phase 3)")
    rep["dgrad_main_path"] = [measure_dgrad(f"K{w.shape[0]} {w.shape[1]}->{w.shape[2]}",
                                            g, t, w, reps=QUICK_REPS) for g, t, w in dg]
    rep["wgrad_main_path"] = [measure_wgrad(f"K{t.shape[1]} {f.shape[2]}->{g.shape[2]}",
                                            f, t, g, reps=QUICK_REPS) for f, t, g in wg]
    require_ok(rep["dgrad_main_path"] + rep["wgrad_main_path"],
               "config-2 backward, main-path inputs")
    partials = [t.shape[1] * f.shape[0] * sc.wgrad_chunks(f.shape[1])[1] * f.shape[2]
                * g.shape[2] * 4 for f, t, g in wg]
    rep["wgrad_partials_max_bytes"] = max(partials)
    log(f"  wgrad partials buffer: largest {max(partials) / 2**20:.1f} MiB "
        f"(K x B*chunks x Cin x Cout f32), sum over the step {sum(partials) / 2**20:.1f} MiB")
    del dg, wg

    runs = {}
    for remat in (False, True):
        c = load_config(CONFIG2, infer.parse_overrides(
            C2_SET + [f"model.backbone.remat={remat}"]))
        for rerun in (0, 1) if not remat else (0,):
            model = TL.build_model(TL.train_cfg(c), DEVICE)
            model.load_state_dict(init.state_dict())
            st = TL.init_state(c, model=model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, m = TL.train_step(c, st, trb[0])
            torch.cuda.synchronize()
            runs[(remat, rerun)] = (st.model.state_dict(), {k: float(v) for k, v in m.items()},
                                    torch.cuda.max_memory_allocated())
            del st, model
    base = runs[(False, 0)]
    for key, what in (((False, 1), "run to run"), ((True, 0), "remat on vs off")):
        sd, met, _ = runs[key]
        differ = sorted(k for k in base[0] if not torch.equal(base[0][k], sd[k]))
        log(f"  one train step from one state, {what}: parameters and BN statistics "
            f"differing {differ or 'none'}; loss {met['total']!r} vs {base[1]['total']!r}")
        if differ or met != base[1]:
            raise AssertionError(f"config-2 train step, {what}: {differ}, {met} vs {base[1]}")
    rep["peak_bytes"] = {"remat_off": base[2], "remat_on": runs[(True, 0)][2]}
    log(f"  torch.cuda.max_memory_allocated over one train step: remat off "
        f"{base[2] / 2**30:.3f} GiB, remat on {runs[(True, 0)][2] / 2**30:.3f} GiB")
    del runs, base

    state = TL.init_state(cfg, model=copy.deepcopy(init))
    rep["train_ms_per_step"] = timed_steps(lambda b: TL.train_step(cfg, state, b), trb, reps=2)
    log("  train step, warm ms per step (host clock, synchronised, 2 runs of each batch "
        "after one): " + json.dumps({k: round(v, 3) for k, v in
                                     rep["train_ms_per_step"].items()}))
    return rep


# --------------------------------------------------------------------------
# phase 9: evaluation over a split, checkpoints, and the CLIs on the card


def state_tensors(state) -> dict:
    """Every tensor of a train state, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name in ("mu", "nu", "acc_grads"):
        out.update({f"{name}.{i}": t for i, t in enumerate(getattr(state.opt_state, name) or [])})
    out.update({f"ema.{i}": t for i, t in enumerate(state.ema_params or [])})
    return out


def require_equal_states(a, b, what: str) -> int:
    """``torch.equal`` on every tensor of two train states, and equal counts;
    returns the number of tensors compared."""
    ta, tb = state_tensors(a), state_tensors(b)
    counts_a = (a.step, a.opt_state.count, a.opt_state.mini_step)
    counts_b = (b.step, b.opt_state.count, b.opt_state.mini_step)
    differ = sorted(k for k in ta if not torch.equal(ta[k], tb[k]))
    if sorted(ta) != sorted(tb) or differ or counts_a != counts_b:
        raise AssertionError(f"{what}: tensors differing {differ[:8]}, counts {counts_a} "
                             f"vs {counts_b}")
    return len(ta)


def jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def per_scene_split(res: dict) -> dict:
    return {k[len("eval_"):]: res[k] / res["scenes"] for k in
            ("eval_wall_s", "eval_dev_s", "eval_fetch_s", "eval_host_s")}


def run_cli(fn, argv, what: str):
    """``fn(argv)`` with the launch counts set to 0 just before it; returns
    (its result, the counts just after)."""
    reset_counts()
    out = fn(argv)
    torch.cuda.synchronize()
    got = counts()
    log(f"  {what}: launches (forward, dgrad, wgrad) {got}")
    return out, got


def expect(got, want, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: {got}, expected {want}")


def phase_eval_checkpoints(out_dir: str, tmp_dir: str, smi: str, c2_convs) -> dict:
    """``tmp_dir`` takes the config-2 checkpoints (140 MB each); ``c2_convs``:
    config 2's sparse convs in the eval and the train form (phase 8)."""
    cfg = load_config(CONFIG1, infer.parse_overrides(C1_EVAL_SET))
    n = EVAL_SCENES
    log(f"[phase 9] evaluation over a split, checkpoints and the CLIs: {cfg.name}, "
        f"{n} val scenes, eval and checkpoint every 2 steps")
    ck1 = os.path.join(out_dir, "ckpt_config1")
    for d in (ck1, ck1 + "_best"):
        shutil.rmtree(d, ignore_errors=True)
    sets = sum((["--set", x] for x in C1_EVAL_SET + [f"train.checkpoint_dir={ck1}"]), [])
    log_path = os.path.join(out_dir, "train_eval_log.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    rep = {"launches": {}}

    # a. train.main, 4 steps, an eval and a checkpoint every 2
    _, got = run_cli(train_cli.main, ["--config", CONFIG1, *sets, "--set",
                                      "train.total_steps=4", "--device", DEVICE,
                                      "--log-file", log_path], "config1 train.main, 4 steps")
    evals_fwd = 2 * n // cfg.data.batch_size        # 2 evals of 3 scenes, batch 1
    expect(got, (4 * PER_STEP[0] + PER_STEP[0] * evals_fwd, 4 * PER_STEP[1], 4 * PER_STEP[2]),
           "config1 train.main launches")
    rep["launches"]["config1 train.main (4 steps, 2 evals)"] = got
    lines = jsonl(log_path)
    evals = [r for r in lines if r["kind"] == "eval"]
    if [(r["step"], r["scenes"]) for r in evals] != [(2, n), (4, n)]:
        raise AssertionError(f"config1 train.main evals: {evals}")
    if not os.path.isfile(os.path.join(CK.best_dir(ck1), "best.json")):
        raise AssertionError("config1 train.main wrote no best.json")
    if CK.make_manager(ck1).all_steps() != [2, 4]:
        raise AssertionError(f"config1 checkpoints {CK.make_manager(ck1).all_steps()}")
    log("  evals: " + json.dumps([{k: r[k] for k in ("step", "scenes", "mAP@0.25", "mAP@0.5")}
                                  for r in evals]))

    # b. the step-2 checkpoint against the same 2 steps in this process (the
    # schedule reads total_steps); then one step from each, bit for bit
    seed = cfg.train.seed
    cfg = load_config(CONFIG1, infer.parse_overrides(C1_EVAL_SET + ["train.total_steps=4"]))
    mem = TL.init_state(cfg, DEVICE, torch.Generator().manual_seed(seed))
    stream = TrainStream(cfg, seed=seed)
    for _ in range(2):
        TL.train_step(cfg, mem, TL.to_device(next(stream), DEVICE, TL.TRAIN_KEYS))
    restored = CK.restore(CK.make_manager(ck1), TL.init_state(
        cfg, DEVICE, torch.Generator().manual_seed(seed + 1)), step=2)
    n_t = require_equal_states(restored, mem, "train.main's step-2 checkpoint vs 2 steps here")
    rt_mgr = CK.make_manager(os.path.join(tmp_dir, "roundtrip"))
    CK.save(rt_mgr, mem)
    require_equal_states(CK.restore(rt_mgr, TL.init_state(
        cfg, DEVICE, torch.Generator().manual_seed(seed + 1))), mem, "save and restore")
    batch = TL.to_device(next(stream), DEVICE, TL.TRAIN_KEYS)
    _, m_mem = TL.train_step(cfg, mem, batch)
    _, m_res = TL.train_step(cfg, restored, batch)
    require_equal_states(restored, mem, "one step from the restored state vs from memory")
    if {k: float(v) for k, v in m_mem.items()} != {k: float(v) for k, v in m_res.items()}:
        raise AssertionError(f"step metrics differ: {m_mem} vs {m_res}")
    log(f"  the step-2 checkpoint equals 2 steps in this process ({n_t} tensors, "
        "torch.equal), a save and restore too, and one step from it equals one from "
        "memory bit for bit (parameters, moments, BN statistics, loss parts)")
    del mem, restored

    # c. resume to 6, then eval --best --per-scene and infer --best
    _, got = run_cli(train_cli.main, ["--config", CONFIG1, *sets, "--set",
                                      "train.total_steps=6", "--device", DEVICE, "--resume",
                                      "--log-file", log_path], "config1 train.main --resume")
    expect(got, (2 * PER_STEP[0] + PER_STEP[0] * n, 2 * PER_STEP[1], 2 * PER_STEP[2]),
           "config1 train.main --resume launches")
    rep["launches"]["config1 train.main --resume (2 steps, 1 eval)"] = got
    lines = jsonl(log_path)
    resumed = [r["step"] for r in lines if r["kind"] == "resume"]
    after = [r["step"] for r in lines if r["kind"] == "train"][-2:]
    if resumed != [4] or after != [5, 6]:
        raise AssertionError(f"resume: {resumed}, steps after it {after}")
    res1, got = run_cli(eval_cli.main, ["--config", CONFIG1, *sets, "--best", "--per-scene",
                                        "--device", DEVICE], "config1 eval.main --best")
    expect(got, (PER_STEP[0] * n, 0, 0), "config1 eval.main launches")
    rep["launches"]["config1 eval.main --best (3 scenes)"] = got
    if res1["scenes"] != n or len(res1["per_scene_mAP@0.5"]) != n:
        raise AssertionError(f"config1 eval.main: {res1}")
    inf_dir = os.path.join(out_dir, "infer_best")
    _, got = run_cli(infer.main, ["--config", CONFIG1, *sets, "--best", "--num-scenes", str(n),
                                  "--out-dir", inf_dir, "--device", DEVICE],
                     "config1 infer.main --best")
    expect(got, (PER_STEP[0] * n, 0, 0), "config1 infer.main launches")
    rep["launches"]["config1 infer.main --best (3 scenes)"] = got
    for i in range(n):
        with np.load(os.path.join(inf_dir, f"scene{i:04d}.npz")) as f:
            if f["instance"].shape != (f["points"].shape[0],) or not np.isfinite(f["scores"]).all():
                raise AssertionError(f"infer --best scene{i:04d}.npz malformed")

    # d. run_eval on the card against the CPU, the same weights and scenes
    best = CK.make_manager(CK.best_dir(ck1))
    res, states = {}, {}
    for dev in (DEVICE, "cpu"):
        states[dev] = CK.restore(best, TL.init_state(cfg, dev,
                                                     torch.Generator().manual_seed(seed)))
        res[dev] = run_eval(cfg, states[dev], EvalBatches(cfg, "val"), per_class=True,
                            per_scene=True)
    keys = [k for k in res["cpu"] if k.startswith(("mAP", "AP@", "scene_map50", "semantic"))]
    if sorted(res[DEVICE]) != sorted(res["cpu"]) or res[DEVICE]["scenes"] != n:
        raise AssertionError(f"run_eval keys or scenes differ: {res}")
    diff = max(abs(res[DEVICE][k] - res["cpu"][k]) for k in keys)
    log(f"  run_eval card vs CPU, {len(keys)} entries: largest |difference| {diff!r} "
        f"(bar 1e-6); per-scene mAP@0.5 {res[DEVICE]['per_scene_mAP@0.5']} vs "
        f"{res['cpu']['per_scene_mAP@0.5']}")
    if diff > 1e-6 or res[DEVICE]["per_scene_mAP@0.5"] != res["cpu"]["per_scene_mAP@0.5"]:
        raise AssertionError("run_eval on the card differs from the CPU")
    rep["card_vs_cpu_max_abs_diff"] = diff
    raw = TL.eval_step(cfg, states[DEVICE], TL.to_device(next(iter(EvalBatches(cfg, "val"))), DEVICE))
    want = np.packbits(raw["point_mask_logits"].cpu().numpy() > 0, axis=-1)
    if not np.array_equal(raw["point_mask_bits"].cpu().numpy(), want):
        raise AssertionError("point_mask_bits on the card differ from np.packbits")
    log("  point_mask_bits on the card equal np.packbits(point_mask_logits > 0) exactly")
    rep["config1_eval"] = res1
    del raw, states

    # e. config 2 at full width, bf16: train.main 2 steps, then eval.main --best
    cfg2 = load_config(CONFIG2, infer.parse_overrides(C2_SET + C2_EVAL_SET))
    ck2 = os.path.join(tmp_dir, "ckpt_config2")
    sets2 = sum((["--set", x] for x in C2_SET + C2_EVAL_SET + [f"train.checkpoint_dir={ck2}"]),
                [])
    n_eval, n_train = c2_convs
    state, got = run_cli(train_cli.main, ["--config", CONFIG2, *sets2, "--set",
                                          "train.total_steps=2", "--device", DEVICE],
                         "config2 train.main, 2 steps")
    evals_fwd = -(-n // cfg2.data.batch_size)
    expect(got, (2 * n_train + evals_fwd * n_eval, 2 * (n_train - 1), 2 * n_train),
           "config2 train.main launches")
    rep["launches"]["config2 train.main (2 steps, 1 eval)"] = got
    res2, got = run_cli(eval_cli.main, ["--config", CONFIG2, *sets2, "--best",
                                        "--device", DEVICE], "config2 eval.main --best")
    expect(got, (evals_fwd * n_eval, 0, 0), "config2 eval.main launches")
    rep["launches"]["config2 eval.main --best (3 scenes)"] = got
    if res2["scenes"] != n:
        raise AssertionError(f"config2 eval.main scored {res2['scenes']} scenes, not {n}")
    bb = cfg2.model.backbone
    ev = TL.eval_model(cfg2, state)
    forms = (state.model.backbone.dense_from_scale, ev.backbone.dense_from_scale,
             tree_boundary({k[len("backbone."):]: v for k, v in
                            CK.make_manager(ck2).load(2)["model"].items()
                            if k.startswith("backbone.")}))
    if forms != (bb.dense_from_scale_train, bb.dense_from_scale, bb.dense_from_scale_train):
        raise AssertionError(f"config 2 forms (train, eval, checkpoint): {forms}")
    log(f"  config 2: the train form (dense-{forms[0]}, also in the checkpoint) is scored "
        f"in the eval form (dense-{forms[1]}), {n_eval} forward launches an eval forward")

    # f. figures: bytes a config-2 batch fetches, checkpoint size and times
    out = TL.eval_step(cfg2, ev, TL.to_device(next(iter(EvalBatches(cfg2, "val"))), DEVICE))
    host = fetch_eval_outputs(out)
    fetch = {"logits_bytes": out["point_mask_logits"].numel() * 4,
             "bits_bytes": out["point_mask_bits"].numel(),
             "fetched_bytes": sum(v.nbytes for v in host.values() if hasattr(v, "nbytes"))}
    del out, host, ev
    mgr = CK.make_manager(os.path.join(tmp_dir, "timing"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CK.save(mgr, state)
    t1 = time.perf_counter()
    CK.restore(mgr, state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ckpt = {"bytes": os.path.getsize(os.path.join(mgr.path(state.step), "state.pt")),
            "save_ms": (t1 - t0) * 1e3, "restore_ms": (t2 - t1) * 1e3}
    rep.update(config2_eval=res2, config2_fetch=fetch, config2_checkpoint=ckpt,
               eval_split_per_scene={"config1": per_scene_split(res1),
                                     "config2": per_scene_split(res2)}, card=smi)
    log("  warm eval split per scene, s (eval.main --best, 3 scenes): "
        + json.dumps(rep["eval_split_per_scene"]))
    log(f"  config-2 batch fetched to the host: {fetch['fetched_bytes']} bytes, of which the "
        f"mask bits {fetch['bits_bytes']}; the f32 logits left on the card "
        f"{fetch['logits_bytes']}")
    log(f"  config-2 checkpoint: {ckpt['bytes']} bytes, save {ckpt['save_ms']:.1f} ms, "
        f"restore {ckpt['restore_ms']:.1f} ms")
    log(f"  {smi}")
    return rep


def totals(main_path) -> dict:
    """Sums over one step's main-path records: kernel, plain, library and
    bound ms, and what bounds the step (its bytes over the card's memory rate
    against its products over the peak rate of their type)."""
    t_bytes = sum(r["bytes"] for r in main_path) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["flops"] / PEAK_FLOPS[getattr(torch, r["dtype"])] for r in main_path) * 1e3
    return {
        "ms": sum(r["kernel_ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "bound_ms": sum(r["bound_ms"] for r in main_path),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in main_path),
        "max_abs_err": max(r["max_abs_err"] for r in main_path),
    }


def kernel_entry(name, source, replaces, launches, recs_all, main_path, library, per,
                 config1) -> dict:
    """One kernel of the ``kernels`` line: this slice's main path (config 2,
    bf16) at the top level, config 1's (f32) under ``config1``."""
    top = totals(main_path)
    top["max_abs_err"] = max(r["max_abs_err"] for r in recs_all + main_path + config1)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **top, "library": library, "per": per,
            "config1": totals(config1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card smoke test of sparse_rcnn_tpu_torch.")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out", "chip_smoke"),
                    help="where the detailed records go")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    smi = card_info()
    os.makedirs(args.out_dir, exist_ok=True)
    # checkpoints too large for the out-dir, removed at the end
    with tempfile.TemporaryDirectory(prefix="_chip_smoke_", dir=ROOT) as tmp_dir:
        return run(args, smi, t_start, tmp_dir)


def run(args, smi: str, t_start: float, tmp_dir: str) -> int:
    build()
    recs = phase_kernel()
    bwd_recs = phase_backward_kernels()
    launches, split, main_path = phase_slice(args.out_dir, os.path.join(tmp_dir, "none"))
    dead = next(r for r in recs if (r["conv"], r["dtype"]) == ("all_dead", "float32"))
    enc = next(r for r in main_path if r["conv"] == "enc0.conv1")
    dead_vs_main = {"all_dead_ms": dead["kernel_ms"], "enc0.conv1_ms": enc["kernel_ms"],
                    "ratio": dead["kernel_ms"] / enc["kernel_ms"]}
    log(f"  forward f32 K27 16->16, M 32768: all -1 idx {dead['kernel_ms']:.4f} ms vs the "
        f"main path's enc0.conv1 {enc['kernel_ms']:.4f} ms (ratio {dead_vs_main['ratio']:.3f}; "
        f"dead (tile, tap) pairs there {enc['dead_pair_share']:.3f})")
    golden_flips = phase_golden()
    train = phase_train(args.out_dir)
    golden_train = phase_golden_train()
    c2 = phase_config2(args.out_dir, tmp_dir)
    p9 = phase_eval_checkpoints(args.out_dir, tmp_dir, smi,
                                (c2["sparse_convs"]["eval"], c2["sparse_convs"]["train"]))

    src = "sparse_rcnn_tpu_torch/ops/csrc/sparse_conv.cu"
    records = os.path.relpath(os.path.join(args.out_dir, "kernels.json"), ROOT)
    fwd, dgrad, wgrad = c2["launches_train"]
    paths = {"config1 infer.main (3 scenes)": (launches, 0, 0),
             f"config1 train.main ({TRAIN_STEPS} steps)": train["launches"],
             "config2 infer.main (1 batch)": c2["launches_infer"],
             f"config2 train.main ({C2_TRAIN_STEPS} steps)": c2["launches_train"],
             **p9["launches"]}
    n_eval, n_train = c2["sparse_convs"]["eval"], c2["sparse_convs"]["train"]
    kernels = {"kernels": [
        dict(kernel_entry(
            "sparse_conv_fwd", src, "sparse_rcnn_tpu/ops/pallas_conv.py:76", fwd, recs,
            c2["forward_main_path"], "feats[idx] im2col gather + torch.matmul (two calls)",
            f"one config-2 eval forward ({n_eval} convs, bf16, dense-2, main-path inputs); "
            f"launches: config-2 train.main, {C2_TRAIN_STEPS} steps; config1: one config-1 "
            f"forward (10 convs, f32); per-conv records in {records}", main_path),
            launches_by_path={k: v[0] for k, v in paths.items()}),
        dict(kernel_entry(
            "sparse_conv_dgrad", src, "sparse_rcnn_tpu/ops/sparse_conv.py:536", dgrad,
            [r for r in bwd_recs if r["role"] == "dgrad"], c2["dgrad_main_path"],
            "g[t_idx] im2col gather + torch.matmul with W^T (two calls)",
            f"one config-2 train step ({n_train - 1} dgrads, bf16, dense-3, main-path "
            f"inputs); launches: config-2 train.main, {C2_TRAIN_STEPS} steps; config1: one "
            "config-1 train step (9 dgrads, f32)", train["dgrad_main_path"]),
            launches_by_path={k: v[1] for k, v in paths.items()}),
        dict(kernel_entry(
            "sparse_conv_wgrad", src, "sparse_rcnn_tpu/ops/sparse_conv.py:542", wgrad,
            [r for r in bwd_recs if r["role"] == "wgrad"], c2["wgrad_main_path"],
            "g[t_idx] gather + torch.matmul with feats^T (two calls)",
            f"one config-2 train step ({n_train} wgrads, bf16, dense-3, main-path inputs); "
            f"launches: config-2 train.main, {C2_TRAIN_STEPS} steps; config1: one config-1 "
            "train step (10 wgrads, f32)", train["wgrad_main_path"]),
            launches_by_path={k: v[2] for k, v in paths.items()}),
    ]}
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "convs_random": recs, "convs_main_path": main_path,
              "dead_tile_vs_main_path": dead_vs_main,
              "backward_random": bwd_recs, "slice_ms_per_scene": split,
              "golden_instance_points_differing": golden_flips,
              "train": train, "golden_train": golden_train, "config2": c2,
              "eval_checkpoints": p9}
    with open(os.path.join(args.out_dir, "kernels.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"[phase 10] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"eval_checkpoints": {k: p9[k] for k in (
        "card", "eval_split_per_scene", "config2_fetch", "config2_checkpoint",
        "card_vs_cpu_max_abs_diff")}}))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
