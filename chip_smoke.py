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
8. a ``kernels`` JSON line, then as the last line
   ``{"ok": true, "device": {...}}``.

TF32 is off throughout (cuDNN and matmul) and cuDNN runs deterministic
algorithms, so every f32 comparison holds f32 against f32. Detailed
records go to ``--out-dir`` (by default ``chiprun_out/chip_smoke/``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import copy

import sparse_rcnn_tpu_torch.train.__main__ as train_cli
from benchmarks import profile_torch_slice as PROF
from sparse_rcnn_tpu_torch import infer
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.data.pipeline import TrainStream
from sparse_rcnn_tpu_torch.models.transfer import from_flax, unflatten_variables
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc
from sparse_rcnn_tpu_torch.train import loop as TL

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
CONFIG1 = os.path.join(ROOT, "configs", "config1_tiny_5cm.yaml")
GOLDEN = os.path.join(ROOT, "tests", "e2e", "golden_config1.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_config1_params.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_config1_train.npz")

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


def measure_conv(name, feats, idx, w, kernel=sc.KERNEL) -> dict:
    """The gather-GEMM ``kernel`` (the forward, or the dgrad on g, t_idx and
    Wᵀ) against its plain version on these inputs, with kernel, plain,
    library and bound times. The bound counts the bytes of idx, feats, W
    and out, each once, and the products of this idx's live entries."""
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
        "kernel_ms": time_ms(lambda: kernel(feats, idx, w)),
        "plain_ms": time_ms(lambda: sc.sparse_conv_reference(feats, idx, w), reps=20, inner=1),
        "library_ms": time_ms(lib, reps=20),
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


def phase_slice(out_dir: str) -> tuple:
    cfg = load_config(CONFIG1)
    n_scenes = 3
    log(f"[phase 4] {cfg.name} at full width (widths {list(cfg.model.backbone.widths)}, "
        f"{cfg.data.num_points} points, capacities {list(cfg.scale_capacities())}), "
        f"{n_scenes} val scenes, seeded init train.seed={cfg.train.seed}")

    # the main path, through the entry point a user calls
    reset_counts()
    infer.main(["--config", CONFIG1, "--num-scenes", str(n_scenes),
                "--out-dir", os.path.join(out_dir, "infer"), "--device", DEVICE])
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
    batches = list(infer.scene_batches(cfg, "val", n_scenes))
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


def measure_dgrad(name, g, t_idx, w) -> dict:
    """The dgrad: the gather-GEMM kernel on (g, t_idx, Wᵀ), measured as the
    forward is (``measure_conv``)."""
    rec = measure_conv(name, g, t_idx, w.transpose(1, 2).contiguous(), kernel=sc.DGRAD)
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


def measure_wgrad(name, feats, t_idx, g) -> dict:
    """The wgrad kernel against its plain version on these inputs, checked
    bit-identical across two launches, with kernel, plain, library and
    bound times and the share of (32-row stage, tap) pairs of t_idx with no
    live entry. The bound counts the bytes of t_idx, feats, g and the f32
    out, each once, and the products of t_idx's live entries."""
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
        "kernel_ms": time_ms(lambda: sc.WGRAD(feats, t_idx, g)),
        "plain_ms": time_ms(lambda: sc.sparse_conv_wgrad_reference(feats, t_idx, g), reps=20,
                            inner=1),
        "library_ms": time_ms(lib, reps=20),
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
    train_cli.main(["--config", CONFIG1, "--set", f"train.total_steps={TRAIN_STEPS}",
                    "--set", "train.log_every=1", "--device", DEVICE, "--log-file", log_path])
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


def kernel_entry(name, source, replaces, launches, recs_all, main_path, library, per) -> dict:
    t_bytes = sum(r["bytes"] for r in main_path) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["flops"] for r in main_path) / PEAK_FLOPS[torch.float32] * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs_all + main_path),
        "ms": sum(r["kernel_ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "bound_ms": sum(r["bound_ms"] for r in main_path),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in main_path),
        "library": library, "per": per,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card smoke test of sparse_rcnn_tpu_torch.")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out", "chip_smoke"),
                    help="where the detailed records go")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    smi = card_info()
    os.makedirs(args.out_dir, exist_ok=True)
    build()
    recs = phase_kernel()
    bwd_recs = phase_backward_kernels()
    launches, split, main_path = phase_slice(args.out_dir)
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

    src = "sparse_rcnn_tpu_torch/ops/csrc/sparse_conv.cu"
    records = os.path.relpath(os.path.join(args.out_dir, "kernels.json"), ROOT)
    fwd, dgrad, wgrad = train["launches"]
    kernels = {"kernels": [
        dict(kernel_entry(
            "sparse_conv_fwd", src, "sparse_rcnn_tpu/ops/pallas_conv.py:76", fwd, recs,
            main_path, "feats[idx] im2col gather + torch.matmul (two calls)",
            "one config-1 forward (10 convs, f32, inference main-path inputs); "
            f"launches: train.main, {TRAIN_STEPS} steps; per-conv records in {records}"),
            launches_by_path={"infer.main": launches, "train.main": fwd}),
        kernel_entry(
            "sparse_conv_dgrad", src, "sparse_rcnn_tpu/ops/sparse_conv.py:536", dgrad,
            [r for r in bwd_recs if r["role"] == "dgrad"], train["dgrad_main_path"],
            "g[t_idx] im2col gather + torch.matmul with W^T (two calls)",
            "one config-1 train step (9 dgrads, f32, main-path inputs); launches: "
            f"train.main, {TRAIN_STEPS} steps"),
        kernel_entry(
            "sparse_conv_wgrad", src, "sparse_rcnn_tpu/ops/sparse_conv.py:542", wgrad,
            [r for r in bwd_recs if r["role"] == "wgrad"], train["wgrad_main_path"],
            "g[t_idx] gather + torch.matmul with feats^T (two calls)",
            "one config-1 train step (10 wgrads, f32, main-path inputs); launches: "
            f"train.main, {TRAIN_STEPS} steps"),
    ]}
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "convs_random": recs, "convs_main_path": main_path,
              "dead_tile_vs_main_path": dead_vs_main,
              "backward_random": bwd_recs, "slice_ms_per_scene": split,
              "golden_instance_points_differing": golden_flips,
              "train": train, "golden_train": golden_train}
    with open(os.path.join(args.out_dir, "kernels.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"[phase 8] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
