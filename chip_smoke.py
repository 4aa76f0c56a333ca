#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``sparse_rcnn_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card; exits nonzero without one. Phases, any failure exits
nonzero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA libraries from ``sparse_rcnn_tpu_torch/ops/csrc`` (the
   sparse conv's, the indexing backwards', the optimizer's, the NMS's and
   the norm's, one ``nvcc`` each, together);
3. the forward kernel against its plain version on random inputs at every
   conv shape of a config-1 forward (f32 and bf16), a ragged M, a
   config-2-sized shape and the edge cases of its dead-tile skip and copy
   widths (``EDGE_CONVS``), with kernel, plain, library and bound times and
   the share of (64-row tile, tap) pairs with no live entry; then the
   backward kernels (dgrad and wgrad) the same way, the edge cases for
   both, the wgrad checked bit-identical across two launches and with its
   share of (32-row stage, tap) pairs with no live entry; then the RoI
   crop's and the mask read's backward kernels (``roi_crop_grad``,
   ``mask_read_grad``, ``ops/index_grad.py``) against their plain version,
   CUDA's accumulating ``index_put_`` over every entry, bit-equal and
   bit-identical across two launches, and the mask read's map kernel
   (``mask_read_map``) against the plain stable sort the same way, on edge
   cases (``ROI_GRAD_EDGES``: every corner dead, every live corner into row
   0, M below one block with one box, a box with no live corner, C 16 and
   32, f32 and bf16; ``benchmarks/mask_map_cases.py``: one proposal, a box
   that holds no point, every box so, a proposal all in one cell, a long
   kept run among as many left-out entries on one cell, no ``keep``, runs
   shorter than a warp's pass), with kernel, map, plain, library and bound
   times; then the optimizer's kernels (``global_sumsq_partial`` +
   ``global_sumsq_finish``, ``optim_apply``, ``ops/optim.py``) against their
   plain versions (the fixed-order norm in elementwise ops, the foreach
   chain), bit-equal and bit-identical across two launches, on edge cases
   (``benchmarks/optim_cases.py``: one entry, a chunk's edges, sizes not a
   multiple of 4, tensors at odd offsets, channels-last gradients, the clip
   triggered and not, a zero and a NaN gradient, count 1 and 10^4, SGD, EMA
   on and off, the EMA alone, a list of two launches, config 2's 165
   shapes), with kernel, plain, library and bound times at config 1's and
   config 2's shapes; then the greedy 3D NMS kernel (``nms_3d``,
   ``ops/nms.py``) against the plain loop ``nms_3d_reference`` scene by
   scene, ``keep_idx`` and ``keep_mask`` bit-equal and bit-identical across
   two launches, one launch a batch, on ``benchmarks/nms_cases.py``'s cases
   (select's shapes, N not a multiple of 32 and past the block, ties,
   identical boxes, no valid candidate, fewer than P, IoUs one ulp either
   side of the threshold, the card's order of ``torch.prod``, NaN scores
   and boxes), with kernel, plain, host and bound times at select's shapes;
   then the masked BN + ReLU's kernels (``bn_stats``, ``bn_apply``,
   ``bn_grad``, ``ops/batch_norm.py``) against the plain chain
   (``MaskedBatchNorm.normalize``, ``torch.relu``, their autograd) on
   ``benchmarks/bn_cases.py``'s cases (every width 32-256 in f32 and bf16,
   ragged scenes, a scene of padding alone, the running statistics, a C
   that takes no 16-byte lane, config 2's first scale) and on the norms of
   one config-1 and one config-2 train step: the apply and the input
   gradient bit-equal given the same vectors, the statistics and the
   gradients within that file's tolerances, bit-identical across two runs,
   the step's launches by role, and every norm's kernel, bound and chain
   times (``bn_steps``);
4. the config-1 inference slice on the card: ``infer.main`` on 3 val scenes
   (the forward count must rise by 10 per forward, bn_apply's by 8); tie-breaking of sort
   and argmax on the card; then the same weights and scenes on the CPU,
   where the plain versions run: site tables and rulebooks bit-exact,
   floats to tolerance, proposal masks and classes exact; warm ms per scene
   split into hierarchy, backbone and heads; the forward kernel against its
   plain version, timed, on the inputs the main path's 10 convs gave it;
5. the committed JAX-init weights (``tests/fixtures``) reproduce
   ``tests/e2e/golden_config1.npz`` on the card;
6. the config-1 training slice on the card: ``python -m
   sparse_rcnn_tpu_torch.train``'s ``main`` for 5 steps (per step 10
   forward, 9 dgrad and 10 wgrad launches and one of each indexing backward;
   finite losses); one step's loss
   parts and gradients and the params after 3 steps, card against CPU; a
   step's gradients twice from one state, bit-identical on the card and on
   the CPU; warm ms per train step split into prepare (with GT), forward
   (with losses), backward and optimizer; the backward kernels timed on the
   inputs the main path gave them, the indexing backwards too (bit-equal to
   ``index_put_``), and the reads' forward and backward under
   ``torch.cuda.set_sync_debug_mode("error")`` (the maps make no host sync);
   one whole ``train_step`` under ``set_sync_debug_mode("error")`` after a
   count of its syncs under ``"warn"`` (none), and the two optimizer
   kernels once a step (``global_norm``: 2 launches, partials and finish;
   ``optim_apply``: 1) on every train path, never in an eval;
7. the committed weights reproduce JAX's 3-step train trajectory
   ``tests/fixtures/golden_config1_train.npz`` on the card;
8. config 2 (``configs/config2_scannet_2cm.yaml``, ``data.dataset=synthetic``
   the only override) at full width, bf16: ``infer.main`` on one batch
   (dense tail from scale 2; one launch per sparse conv) and
   ``train.main`` for 3 steps (dense tail from scale 3; forward, dgrad and
   wgrad launches per step, and each indexing backward once a scene; finite
   losses, parameters f32); on
   ``bench.py``'s scenes (262144 points, 12 instances, augmented and
   cropped): one scene's integer tables and dense occupancy bit-exact
   against the CPU, the overflow counters (0) and ``dense_tail_oob``
   against a count of the dropped sites made in numpy from the points,
   every sparse conv of one eval forward and every forward, dgrad and
   wgrad of one train step against its plain version, its two indexing
   backwards (a record a scene) as in phase 6, dense-2 against the same weights
   converted to fully sparse in f32 and bf16 on a batch that drops no
   site, the eval step at batch 2 against each scene alone (packed mask
   bits, proposal scores and class logits ``torch.equal``: the dense tail
   convolves one scene at a time), one train step bit-identical run to run
   and with remat (peak memory of each), the wgrad partials buffer, warm ms
   per scene of the eval step and per train step, and the eval backbone
   and the train step with the dense tail's convs one scene at a time
   against over the whole batch, in turns;
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
   ``eval_checkpoints`` JSON line. Then ``run_eval``'s one-batch lookahead,
   for config 1 and config 2 (dense-2) each: the whole eval step under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host read raises) after
   a count of its syncs under ``"warn"`` (none), the gap from the step's
   return to the completion of an event recorded after it (the device work
   left for the host to overlap) with the host's ms to the return and the
   card's ms; ``run_eval`` against a plain sequential loop written here
   (step, wait, fetch, score: the pass before the lookahead) over the same
   weights and 6 val scenes, in turns: packed mask bits ``torch.equal``,
   mAP, per-scene mAP and scene count equal, both passes' wall, wait,
   fetch and host seconds a scene, and the lookahead pass's peak memory at
   most one eval step's peak plus one batch's inputs, instance ids
   included (no two steps' outputs live at once);
10. the data layer and the pooled backbone at full width: each reader's
   files written into the temporary directory from the port's generator
   (ScanNet ``.npz`` and ``.pth`` scenes of 300000 points, 4 train and 3
   val; S3DIS ``Area_1_*``/``Area_5_*`` rooms of 600000; SemanticKITTI
   ``.bin``/``.label`` sweeps of 120000 in sequences 00 and 08, 100 x 100 x
   6 m); config 2 through the ScanNet reader with ``data.num_workers=4``,
   ``data.prefetch=3`` and ``data.host_voxelize=true``: ``train.main`` for 3
   steps (an eval at step 3), ``eval.main --best`` on the 3 val scenes, the
   host voxelizer's tables of a val batch against the device's voxelize on
   the card (integer tables bit for bit, feats within 1e-5), one f32 train
   step on host- against device-voxelized tables, and the train step fed by
   the Loader against the synchronous single-worker stream and against
   batches already on the card, in turns (wall, device busy, idle share,
   the Loader's wait per batch); configs 3 and 4
   through the S3DIS and KITTI readers: ``infer.main`` on one batch,
   ``train.main`` for 2 steps, warm eval and train step ms and peak memory;
   ``configs/config1_pool_dropout.yaml``: ``infer.main`` on 3 scenes,
   ``train.main`` for 4 steps twice (bit-equal states and losses), the eval
   step card against CPU as in phase 4, every kernel call of one pooled
   forward and train step against its plain version. Launches of every
   path are checked; figures in a ``data_layer`` JSON line with the card;
11. data parallel on config 5's path (``configs/config5_v5e8_dp.yaml``:
   widths 32-160, bf16, dense tail 2 for eval and 3 for train, 262144
   points, host voxelize) through the ScanNet reader on phase 10's files,
   cut to one card, each world started by ``python -m
   torch.distributed.run`` under a timeout (a rank that fails fails the
   script): (a) a world of 1 on NCCL, ``train.main`` for 3 steps with an
   eval and a checkpoint, then a data-parallel step bit-equal
   (``torch.equal``) to ``TL.train_step`` from the same state on the same
   batch, both timed, with the all-reduces and bytes of a step; (b) a world
   of 2 on gloo sharing the card (NCCL refuses two ranks on one GPU),
   global batch 2: an f32 step against ``TL.train_step`` on the global
   batch within ``tests/distributed/test_dp.py``'s tolerance, a bf16 one
   within a stated one, the ranks' states bit-equal, the in-training eval's
   mAP equal to one process's on the global batch of 2 and the packed masks
   of a val batch bit-equal to its, the step timed (two processes on one
   card, not scaling). Records in
   ``dp_*.json`` and ``kernels.json``, figures in a ``data_parallel`` JSON
   line. Alone: ``python3 -c "import chip_smoke as CS; smi =
   CS.card_info(); CS.build(); CS.phase_data_parallel('chiprun_out/dp',
   '_chip_smoke_dp', smi)"``;
12. the tools and the checkpoint form conversion, config 2 at full width:
   ``train.main --profile`` for 2 steps (its trace parses as JSON and names
   the three sparse-conv kernels and the two indexing backwards'; its size
   and top kernels printed),
   ``utils/flops.py::collect_rulebook_stats`` on one batch on the card equal
   to the CPU's, with the useful forward FLOPs; ``tools/size_capacities``
   over phase 10's ScanNet files through the host-voxelizing Loader, its
   report on the card equal to the CPU's; ``tools/preprocess_scannet`` on a
   raw tree written here; phase 9's dense-3 checkpoint converted by
   ``tools/convert_checkpoint`` to fully sparse and to dense-2, each
   restored, its eval against the unconverted one's (dense-2
   ``torch.equal``, fully sparse within ``DENSE_SPARSE_BF16``) and one step
   resumed from it through ``train.main --resume``. Figures in a ``tools``
   JSON line;
13. a ``kernels`` JSON line (config-2 figures at the top level, config 1's
   under ``config1``, config1_pool_dropout's under ``pool_dropout``;
   launches of every path under ``launches_by_path``, phase 11's ranks and
   phase 12's paths too; ``roi_crop_grad``, ``mask_read_map`` and
   ``mask_read_grad`` with their maps' ms and whether every comparison was
   bit-equal; ``global_norm``
   and ``optim_apply`` likewise; ``nms_3d`` with its launches in one
   config-1 train step and eval step, and over phases 4-12 against the
   detector's select calls on the card, one each; ``bn_stats``, ``bn_apply``
   and ``bn_grad`` with config 2's and config 1's train-step figures; the
   norm's launches are held exactly where a path's norms are counted
   (phases 3, 4, 6, 8) and elsewhere by kind: a training path launches all
   three, a forward path bn_apply alone), then as the last line ``{"ok": true,
   "device": {...}}``.

TF32 is off throughout (cuDNN and matmul) and cuDNN runs deterministic
algorithms, so every f32 comparison holds f32 against f32. Detailed
records go to ``--out-dir`` (by default ``chiprun_out/chip_smoke/``), with
config 1's checkpoints; config 2's and 3's checkpoints and phase 10's
datasets go to a temporary ``_chip_smoke_*`` directory in the checkout,
removed at the end.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import sparse_rcnn_tpu_torch.train.__main__ as train_cli
from benchmarks import bn_cases as BC
from benchmarks import eval_step_syncs as SYNCS
from benchmarks import mask_map_cases as MC
from benchmarks import nms_cases as NC
from benchmarks import optim_cases as OC
from benchmarks import profile_torch_slice as PROF
from sparse_rcnn_tpu_torch import eval as eval_cli
from sparse_rcnn_tpu_torch import infer
from sparse_rcnn_tpu_torch.config import load_config
from sparse_rcnn_tpu_torch.data import synthetic
from sparse_rcnn_tpu_torch.data.augment import augment_scene
from sparse_rcnn_tpu_torch import native
from sparse_rcnn_tpu_torch.native import libraries as NL
from sparse_rcnn_tpu_torch.data.pipeline import VOXEL_KEYS, Loader, collate, device_batches
from sparse_rcnn_tpu_torch.data.ply import write_ply
from sparse_rcnn_tpu_torch.models import detector as DET
from sparse_rcnn_tpu_torch.models import heads as PHd
from sparse_rcnn_tpu_torch.models.convert import convert_variables, tree_boundary
from sparse_rcnn_tpu_torch.models.layers import SparseBasicBlock, SparseConv
from sparse_rcnn_tpu_torch.models import unet as U
from sparse_rcnn_tpu_torch.models.transfer import from_flax, unflatten_variables
from sparse_rcnn_tpu_torch.models.unet import scatter_to_grid
from sparse_rcnn_tpu_torch.ops import index_grad as IG
from sparse_rcnn_tpu_torch.ops import nms as PN
from sparse_rcnn_tpu_torch.ops import optim as OPT
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc
from sparse_rcnn_tpu_torch.ops import voxelize as V
from sparse_rcnn_tpu_torch.parallel import context as DPC
from sparse_rcnn_tpu_torch.parallel import data_parallel as DP
from sparse_rcnn_tpu_torch.train import checkpoint as CK
from sparse_rcnn_tpu_torch.train import evaluate as EV
from sparse_rcnn_tpu_torch.train import loop as TL
from sparse_rcnn_tpu_torch.tools import convert_checkpoint as CC
from sparse_rcnn_tpu_torch.tools import preprocess_scannet as PPS
from sparse_rcnn_tpu_torch.tools import size_capacities as SCAP
from sparse_rcnn_tpu_torch.train.evaluate import fetch_eval_outputs, run_eval
from sparse_rcnn_tpu_torch.utils import flops as FL
from sparse_rcnn_tpu_torch.utils.logging import JsonlLogger

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
# phase 9's lookahead check: run_eval against a plain sequential pass over
# LOOKAHEAD_SCENES val scenes made beforehand, in turns (sequential,
# lookahead, lookahead, sequential); the eval step under the sync check,
# and GAP_REPS timed returns of each of two batches
LOOKAHEAD_SCENES = 6
GAP_REPS = 3
# phase 10: the data layer and the pooled backbone. The readers' files hold
# more points than the configs' capacities (ScanNet and S3DIS scenes are
# subsampled); the KITTI sweeps fit. *_SET: extra overrides of each config
# (none on the card).
CONFIG3 = os.path.join(ROOT, "configs", "config3_s3dis.yaml")
CONFIG4 = os.path.join(ROOT, "configs", "config4_semantic_kitti.yaml")
CONFIG_POOL = os.path.join(ROOT, "configs", "config1_pool_dropout.yaml")
SCANNET_POINTS, S3DIS_POINTS, KITTI_POINTS = 300_000, 600_000, 120_000
C2_DATA_SET, C3_SET, C4_SET, POOL_SET = [], [], [], []
C2_LOADER_SET = ["data.num_workers=4", "data.prefetch=3", "data.host_voxelize=True"]
POOL_TRAIN_STEPS = 4
FED_STEPS = 3                   # train steps per fed-stream measurement
# host against device voxel feats: f32 means, multiply by 1/count against
# divide by count (tests/parity/test_native.py's tolerance)
HOST_VOX_FEATS_TOL = 1e-5
# one f32 config-2 step on host- against device-voxelized feats (apart by
# those ulps): loss parts relative, as phase 6 holds the card to the CPU
HOST_STEP_RTOL = 1e-4
# dense-2 against fully sparse in bf16, per scale, of the largest entry: the
# two forms round to bf16 after different sums (dense convs against
# gathered taps) through up to 16 blocks
DENSE_SPARSE_BF16 = 5e-2

# phase 11: data parallel on config 5's path. *_SET: extra overrides (none
# on the card apart from the world-2 workers' cut). f32: losses and
# parameters with BN statistics to tests/distributed/test_dp.py's
# tolerance. lr is 0 at step 1 of config 5's warmup, so the parameters
# hold still and the gradients are compared too, through the first Adam
# moments, of each tensor's largest entry. With the dense tail one scene at
# a time, what is left is the order of f32 sums: a rank's partial sums
# all-reduced against one process's sum over both scenes, in BN statistics
# and the sparse wgrad. Some dense-tail BN gradients are small sums of
# large terms (|g| near 1e-4), so their own relative error is large: 2e-2
# (1.35e-2 measured on an NVIDIA H100 80GB HBM3 at 700 W, whether or not
# the tail's convs run one scene at a time; 3.0e-5 of the largest gradient
# of all). bf16: losses to DENSE_SPARSE_BF16, BN statistics to 1e-3,
# gradients to DENSE_SPARSE_BF16 (1.60e-2 measured on that card with the
# tail one scene at a time; 0.28 before, when cuDNN picked the tail's bf16
# algorithms per batch shape)
CONFIG5 = os.path.join(ROOT, "configs", "config5_v5e8_dp.yaml")
C5_SET = []
C5_WORLD2_SET = ["data.num_workers=4"]
DP_STEPS = 3
DP_TIMED = 6                    # warm steps timed of each form
DP_TIMEOUT_S = 480              # each launcher call
DP_PARAMS_RTOL = 1e-4
DP_TOL = {"float32": {"loss_rtol": 1e-5, "params_atol": 1e-5, "grads_rel": 2e-2},
          "bfloat16": {"loss_rtol": DENSE_SPARSE_BF16, "params_atol": 1e-3,
                       "grads_rel": DENSE_SPARSE_BF16}}

# phase 12: the tools and the checkpoint form conversion on config 2.
# PROFILE_STEPS: train.main --profile's steps; TRACE_KERNELS: the hand
# kernels its trace must name; SIZE_SCENES: size_capacities' scenes (phase
# 10's 4 ScanNet train scenes)
PROFILE_STEPS = 2
TRACE_KERNELS = ("sparse_conv_fwd_kernel", "sparse_conv_wgrad_partial_kernel",
                 "sparse_conv_wgrad_reduce_kernel", "roi_crop_grad_kernel",
                 "mask_read_grad_kernel", "mask_map_keep_kernel", "mask_map_count_kernel",
                 "mask_map_scan_kernel", "mask_map_place_kernel", "global_sumsq_partial_kernel",
                 "global_sumsq_finish_kernel", "optim_apply_kernel")
SIZE_SCENES = 4

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
OPTIM_SPIN_CYCLES = 60_000_000  # about 30 ms: the optimizer's timings (optim_times)
# ``time_ms`` arguments of the kernel, plain and library timings; fewer
# (QUICK_REPS) on config 2's main path, whose convs move 16x the rows
REPS = {"kernel": dict(reps=30, inner=10), "plain": dict(reps=20, inner=1),
        "library": dict(reps=20, inner=10)}
QUICK_REPS = {"kernel": dict(reps=10, inner=5), "plain": dict(reps=5, inner=1),
              "library": dict(reps=5, inner=2)}
# launches of global_norm (partials and finish) and optim_apply in one train
# step: every config's parameter list fits one launch (OPT.MAX_TENSORS)
OPT_PER_STEP = (2, 1)
# the masked BN + ReLU's roles: bn_stats twice a norm's training forward (a
# recomputed one too), bn_apply once a forward, bn_grad twice a norm's
# backward; config 1 has 8 norms (widths [16, 32], one block a scale)
BN_ROLES = ("bn_stats", "bn_apply", "bn_grad")
C1_NORMS = 8
# the roles of NL.LAUNCHES that a path's launches are held to (nms_3d is held
# to the select calls on the card, after phase 12): forward, dgrad (the
# stem's input needs none), wgrad, roi_crop_grad, mask_read_grad and
# mask_read_map (once a scene; config 1 trains on batches of 1), then the
# optimizer's, then the norm's; all but the optimizer's are loss_and_grads'
# alone
ROLES = ("forward", "dgrad", "wgrad", "roi_crop_grad", "mask_read_grad", "mask_read_map",
         "global_norm", "optim_apply", *BN_ROLES)
PER_STEP = dict(zip(ROLES, (10, 9, 10, 1, 1, 1, *OPT_PER_STEP, 2 * C1_NORMS, C1_NORMS,
                            2 * C1_NORMS)))
# card against CPU, one config-1 step, per parameter relative to the
# largest entry of its gradient. Outside the RoI head: with the mask weight
# 0, f32 sums of up to 32768*27 products in other orders through ~20
# layers, 1e-4 (measured worst 1.1e-5); with the full loss the card also
# adds the bf16-read mask-logit gradient in f32 (the mask_read_grad kernel
# sums each cell's entries in f32, in the order of CUDA's index_put_, and
# rounds once to bf16) where the CPU adds it in bf16, 1e-3 (measured worst
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


def time_ms(fn, reps: int = 30, warmup: int = 3, inner: int = 10,
            spin: int = None) -> float:
    """Median over ``reps`` of the mean of ``inner`` back-to-back warm runs
    between two CUDA events. Before each, the card spins for ``spin``
    cycles (by default about a millisecond, ``torch.cuda._sleep``), so that
    the host has queued the runs before the start event fires: a kernel of
    a few microseconds is then timed on the card, not at the rate the host
    launches it, and the events' own cost is spread over ``inner`` runs.
    A call that takes the host longer than the card needs a longer spin."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin or SPIN_CYCLES)
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
    """The package's libraries (``NL.LIBRARIES``), one compiler each, started
    together, then loaded."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(NL.LIBRARIES)) as pool:
        built = list(pool.map(NL.build, NL.LIBRARIES))
    for lib in NL.LIBRARIES:
        NL.load(lib)
    log(f"[phase 2] built {', '.join(os.path.relpath(so, ROOT) for so, _ in built)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for _, messages in built:
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


def measure_conv(name, feats, idx, w, role="forward", reps=None) -> dict:
    """The gather-GEMM kernel in ``role`` (the forward, or the dgrad on g,
    t_idx and Wᵀ) against its plain version on these inputs, with kernel, plain,
    library and bound times (``reps``: the ``time_ms`` arguments of each,
    by default ``REPS``). The bound counts the bytes of idx, feats, W and
    out, each once, and the products of this idx's live entries."""
    reps = reps or REPS
    dtype = feats.dtype
    b, m_in, cin = feats.shape
    k, _, cout = w.shape
    m_out = idx.shape[-1]
    got = sc.conv_kernel(feats, idx, w, role)
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
        "kernel_ms": time_ms(lambda: sc.conv_kernel(feats, idx, w, role), **reps["kernel"]),
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


def val_batches(cfg) -> Loader:
    """The ordered val pass, made in this thread (no worker to close)."""
    return Loader(cfg, "val", train=False, threads=False)


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


def card_vs_cpu(cfg, m_gpu, m_cpu, batches, per_forward: int) -> dict:
    """Each batch through ``run_scene`` on the card (``per_forward`` kernel
    launches) and on the CPU: tables bit-exact, proposal masks, semantic
    predictions and classes exact, floats to tolerance. Returns the largest
    difference of each float output."""
    worst = {}
    for i, batch in enumerate(batches):
        before = NL.LAUNCHES["forward"]
        tab_g, res_g = run_scene(cfg, m_gpu, batch, DEVICE)
        torch.cuda.synchronize()
        if NL.LAUNCHES["forward"] - before != per_forward:
            raise AssertionError(f"scene {i}: {NL.LAUNCHES['forward'] - before} launches, "
                                 f"not {per_forward}")
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
    return worst


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


def capture(fn, *names: str) -> list:
    """Run ``fn`` and return the arguments of every call it makes to
    ``sc.<name>`` (``conv_forward``, ``conv_dgrad`` or ``conv_wgrad``, the
    dispatchers of the sparse conv's autograd Function) or ``IG.<name>``
    (``roi_crop_grad``, ``mask_read_grad``, the indexing backwards', or
    ``mask_read``): a list
    of calls, or with several names one such list for each. The calls still
    launch the kernels."""
    calls = {name: [] for name in names}
    mods = {name: IG if name in ("roi_crop_grad", "mask_read_grad", "mask_read") else sc
            for name in names}
    real = {name: getattr(mods[name], name) for name in names}

    def recording(name):
        def record(*args):
            calls[name].append(args)
            return real[name](*args)
        return record

    for name in names:
        setattr(mods[name], name, recording(name))
    try:
        fn()
    finally:
        for name in names:
            setattr(mods[name], name, real[name])
    return calls[names[0]] if len(names) == 1 else [calls[name] for name in names]


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
    before = dict(NL.LAUNCHES)
    infer.main(["--config", CONFIG1, "--num-scenes", str(n_scenes), "--set",
                f"train.checkpoint_dir={no_ckpt}", "--out-dir", os.path.join(out_dir, "infer"),
                "--device", DEVICE])
    torch.cuda.synchronize()
    launches = launched(before)
    forwards = -(-n_scenes // cfg.data.batch_size)
    want = {**want_launches(10 * forwards), "bn_stats": 0, "bn_apply": C1_NORMS * forwards,
            "bn_grad": 0}
    log(f"  launches in infer.main: {launches} ({forwards} forwards; 10 sparse_conv and "
        f"{C1_NORMS} bn_apply expected per forward, nothing else)")
    if launches != want:
        raise AssertionError(f"infer.main launched {launches}, expected {want}")
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
    batches = list(itertools.islice(val_batches(cfg), n_scenes))
    worst = card_vs_cpu(cfg, m_gpu, m_cpu, batches, 10)
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
    before = NL.LAUNCHES["forward"]
    out = infer.to_host(TL.eval_step(cfg, model, TL.to_device(batch, DEVICE)))
    torch.cuda.synchronize()
    launches = NL.LAUNCHES["forward"] - before
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
    rec = measure_conv(name, g, t_idx, w.transpose(1, 2).contiguous(), role="dgrad",
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
    got = sc.wgrad_kernel(feats, t_idx, g)
    again = sc.wgrad_kernel(feats, t_idx, g)
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
        "kernel_ms": time_ms(lambda: sc.wgrad_kernel(feats, t_idx, g), **reps["kernel"]),
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
# phase 3, the indexing backwards: roi_crop_grad and mask_read_grad against
# their plain version, CUDA's accumulating index_put_, bit for bit


def roi_grad_inputs(m, c, p, d, dtype, case, seed):
    """The crop's backward inputs for p boxes of d³ samples over m rows of
    c channels, on the card: g [S, c], w [8, S] in ``dtype``, idx int32
    [8, S] with about 40 % of the corners dead; ``all_dead`` every corner,
    ``one_row`` every live corner into row 0 (the composite's row-0 run),
    ``box0_dead`` every corner of box 0."""
    s = p * d ** 3
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.randint(0, m, (8, s), generator=gen, device=DEVICE, dtype=torch.int32)
    idx = torch.where(torch.rand((8, s), generator=gen, device=DEVICE) < 0.4, -1, idx)
    if case == "all_dead":
        idx[:] = -1
    elif case == "one_row":
        idx = torch.where(idx >= 0, 0, idx)
    elif case == "box0_dead":
        idx[:, :d ** 3] = -1
    g = torch.randn((s, c), generator=gen, device=DEVICE).to(dtype)
    w = torch.rand((8, s), generator=gen, device=DEVICE).to(dtype)
    return g, w, idx.to(torch.int32).contiguous(), m


def index_grad_record(name, kernel, got, again, want, nbytes, runs, longest, reps) -> dict:
    """A kernel of ``ops/index_grad.py`` against its plain version: bit
    equality, bit identity across two launches, card times of ``runs``
    (kernel, map, plain, library) and the bound, ``nbytes`` over the
    card's memory rate."""
    torch.cuda.synchronize()
    rec = {"conv": name, "kernel": kernel, "dtype": str(got.dtype).replace("torch.", ""),
           "max_abs_err": (got.float() - want.float()).abs().max().item() if got.numel() else 0.0,
           "bit_equal": bool(torch.equal(got, want)),
           "bit_identical": bool(torch.equal(got, again)), "longest_run": longest,
           **{f"{k}_ms": time_ms(fn, **reps["plain" if k in ("plain", "library") else "kernel"])
              for k, fn in runs.items()},
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes,
           "flops": 0}
    rec["ok"] = rec["bit_equal"] and rec["bit_identical"]
    log(f"  {kernel} {name:22s} {rec['dtype']:8s} longest run {longest}: "
        f"kernel_ms={rec['kernel_ms']:.4f} map_ms={rec['map_ms']:.4f} "
        f"plain_ms={rec['plain_ms']:.4f} library_ms(index_put_)={rec['library_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.4f} (bytes) max_abs_err={rec['max_abs_err']:.3e} "
        f"bit_equal={rec['bit_equal']} bit_identical={rec['bit_identical']} "
        f"{'ok' if rec['ok'] else 'MISMATCH'}")
    return rec


def measure_roi_grad(name, g, w, idx, m, reps=None) -> dict:
    """roi_crop_grad on (g [S, C], w [8, S], idx [8, S], m rows). Library:
    the ``index_put_`` of the plain version alone, its values made outside
    the timing. Bound: g, the live corners' w and map entries, the offsets
    and d_feats, each once."""
    rmap = IG.roi_crop_map(idx, m)
    got, again = (IG.roi_crop_grad_kernel(g, w, rmap, m) for _ in range(2))
    want = IG.roi_crop_grad_reference(g, w, idx, m)
    v = (g[None] * w[..., None]) * (idx >= 0)[..., None].to(g.dtype)
    safe = idx.clamp(0, m - 1).to(torch.int64)
    buf = torch.zeros((m, g.shape[1]), dtype=g.dtype, device=g.device)
    live = int(rmap[1][-1])
    esz = g.element_size()
    nbytes = g.numel() * esz + live * (esz + 4) + (m + 1) * 4 + m * g.shape[1] * esz
    rec = index_grad_record(name, "roi_crop_grad", got, again, want, nbytes, {
        "kernel": lambda: IG.roi_crop_grad_kernel(g, w, rmap, m),
        "map": lambda: IG.roi_crop_map(idx, m),
        "plain": lambda: IG.roi_crop_grad_reference(g, w, idx, m),
        "library": lambda: buf.index_put_((safe,), v, accumulate=True)},
        int(rmap[1].diff().max()) if m else 0, reps or REPS)
    rec.update(M=m, C=g.shape[1], S=g.shape[0], live_entries=live)
    return rec


def full_runs(cell, keep, cells) -> dict:
    """The rows of the mask read over every entry, as the parent's map held
    them: the longest, the slots whose longest row holds more than half of
    the points (with each slot's kept points: 0 for a box that holds none),
    the slots that keep no point, and the longest row of kept entries."""
    p, n = cell.shape
    rows = torch.zeros((p, cells), dtype=torch.int64, device=cell.device)
    rows.scatter_add_(1, cell.long(), torch.ones_like(cell, dtype=torch.int64))
    longest = rows.max(1).values.cpu()
    kept = (keep.sum(1) if keep is not None else torch.full((p,), n)).cpu()
    kept_rows = torch.zeros_like(rows)
    if keep is not None:
        kept_rows.scatter_add_(1, cell.long(), keep.to(torch.int64))
    else:
        kept_rows = rows
    return {"longest_full_run": int(longest.max()),
            "slots_over_half": [[i, int(longest[i]), int(kept[i])]
                                for i in range(p) if longest[i] > n // 2],
            "slots_keeping_none": [i for i in range(p) if kept[i] == 0],
            "longest_kept_row": int(kept_rows.max())}


def measure_mask_grad(name, g, cell, keep, cells, reps=None, unit=None) -> list:
    """The mask read's backward on (g bf16 [P, N], cell [P, N] of
    ``cells``, keep bool [P, N] or None): two records, ``mask_read_map``
    (the kernel's map against the plain version's, bit for bit; times of the
    kernel, the plain version, the parent's map of every entry (one stable
    sort and a search) and ``torch.sort`` alone (library); bound: keep read
    once, cell read once in the proposals that keep a point (a proposal
    that keeps none needs no cell), the kept entries' perm and lane and the
    offsets written once) and ``mask_read_grad`` over the kernel's map
    (against ``index_put_`` over every entry; library: that ``index_put_``
    alone; bound: the offsets and the kept entries' lane, perm and g read
    once, the rows written once). ``unit``: the map's block size (by
    default ``IG.map_unit``'s)."""
    reps = reps or REPS
    p, n = cell.shape
    rows = p * cells
    chk = MC.check_mask_case(g, cell, keep, cells, unit)
    rmap = IG.mask_read_map_kernel(cell, cells, keep, unit)
    got, again = (IG.mask_read_grad_kernel(g, rmap, rows) for _ in range(2))
    want = IG.mask_read_grad_reference(g, cell, cells).reshape(-1)
    prow = torch.arange(p, device=g.device)[:, None]
    ix = cell.to(torch.int64)
    buf = torch.zeros((p, cells), dtype=g.dtype, device=g.device)
    full_key = (cell + torch.arange(p, dtype=torch.int32, device=cell.device)[:, None]
                * cells).reshape(-1)
    key = full_key if keep is None else torch.where(keep.reshape(-1), full_key, rows)
    kept = chk["kept"]
    active = p if keep is None else int(keep.any(1).sum())
    runs = full_runs(cell, keep, cells)
    grad = index_grad_record(name, "mask_read_grad", got, again, want,
                             (rows + 1) * 4 + kept * (1 + 4 + 2) + rows * 2, {
        "kernel": lambda: IG.mask_read_grad_kernel(g, rmap, rows),
        "map": lambda: IG.mask_read_map_kernel(cell, cells, keep, unit),
        "plain": lambda: IG.mask_read_grad_reference(g, cell, cells),
        "library": lambda: buf.index_put_((prow, ix), g, accumulate=True)},
        runs["longest_kept_row"], reps)
    grad.update(P=p, N=n, cells=cells, kept=kept, kept_in_lanes=chk["kept_in_lanes"], **runs)
    grad["ok"] = grad["ok"] and chk["bit_equal"] and chk["bit_identical"]
    mrec = {"conv": name, "kernel": "mask_read_map", "dtype": "int32",
            "max_abs_err": 0.0 if chk["map_bit_equal"] else float("inf"),
            "bit_equal": chk["map_bit_equal"], "bit_identical": chk["map_bit_identical"],
            **{f"{k}_ms": time_ms(fn, **reps["plain" if k != "kernel" else "kernel"])
               for k, fn in {
                   "kernel": lambda: IG.mask_read_map_kernel(cell, cells, keep, unit),
                   "plain": lambda: IG.mask_read_map_reference(cell, cells, keep),
                   "parent": lambda: IG.row_map(full_key, rows),
                   "library": lambda: torch.sort(key, stable=True)}.items()},
            "bytes": (p * n if keep is not None else 0) + active * n * 4 + kept * (4 + 1)
            + (rows + 1) * 4, "bound_by": "bytes", "flops": 0,
            "P": p, "N": n, "cells": cells, "kept": kept, "proposals_keeping": active,
            "unit": unit or IG.map_unit(p, n)}
    mrec["bound_ms"] = mrec["bytes"] / HBM_BYTES_PER_S * 1e3
    mrec["ok"] = mrec["bit_equal"] and mrec["bit_identical"]
    log(f"  mask_read_map  {name:22s} kept {kept} of {p * n}: kernel_ms={mrec['kernel_ms']:.4f} "
        f"plain_ms={mrec['plain_ms']:.4f} parent_ms={mrec['parent_ms']:.4f} "
        f"library_ms(torch.sort)={mrec['library_ms']:.4f} bound_ms={mrec['bound_ms']:.4f} "
        f"(bytes) bit_equal={mrec['bit_equal']} bit_identical={mrec['bit_identical']} "
        f"{'ok' if mrec['ok'] else 'MISMATCH'}; full runs: longest "
        f"{runs['longest_full_run']}, slots over half {runs['slots_over_half'][:8]}, "
        f"slots keeping none {len(runs['slots_keeping_none'])}")
    return [mrec, grad]


# (name, M, C, P, D, case) of roi_crop_grad, each in f32 and bf16 (see
# roi_grad_inputs); the mask read's are benchmarks/mask_map_cases.py's
ROI_GRAD_EDGES = [
    ("random_c16", 32768, 16, 32, 7, "random"),
    ("random_c32", 262144, 32, 128, 7, "random"),
    ("all_dead", 32768, 16, 32, 7, "all_dead"),
    ("one_row", 32768, 32, 32, 7, "one_row"),
    ("m_below_block_p1", 5, 16, 1, 7, "random"),
    ("empty_box", 32768, 32, 8, 7, "box0_dead"),
]


def phase_index_grad() -> list:
    log("[phase 3, indexing backwards] roi_crop_grad and mask_read_grad vs their plain "
        "version (CUDA index_put_, accumulate=True, every entry), mask_read_map vs its "
        "plain version (a stable sort): bit-equal and bit-identical across two launches, "
        "on edge cases")
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, *shape, case) in enumerate(ROI_GRAD_EDGES):
            recs.append(measure_roi_grad(name, *roi_grad_inputs(*shape, dtype, case, 600 + i),
                                         reps=QUICK_REPS))
    for i, (name, *shape, case) in enumerate(MC.MASK_MAP_CASES):
        recs += measure_mask_grad(name, *MC.mask_case(*shape, case, DEVICE, 700 + i),
                                  reps=QUICK_REPS, unit=MC.FORCED_UNIT.get(case))
    require_ok(recs, "indexing backwards, edge cases")
    return recs


def mask_calls(reads, mg) -> list:
    """(g, cell, keep, cells) of each captured ``mask_read_grad`` call, its
    keep from the ``mask_read`` call that read the same cells."""
    keep = {cell.data_ptr(): k for _, cell, k in reads}
    return [(g, cell, keep[cell.data_ptr()], cells) for g, cell, _, cells in mg]


def main_path_index_grad(rg, mg, reps=None) -> tuple:
    """Both kernels and the mask read's map against their plain versions on
    the captured calls of one train step (``capture``'s records of
    ``roi_crop_grad``, and of ``mask_read_grad`` as :func:`mask_calls`
    gives them), records a scene; then the reads' forward and backward, the
    maps built, under ``torch.cuda.set_sync_debug_mode("error")``: no host
    sync."""
    roi = [measure_roi_grad(f"scene {i}", g, w, idx, m, reps) for i, (g, w, idx, _, m)
           in enumerate(rg)]
    mask = [r for i, (g, cell, keep, cells) in enumerate(mg)
            for r in measure_mask_grad(f"scene {i}", g, cell, keep, cells, reps)]
    require_ok(roi + mask, "indexing backwards, main-path inputs")
    g, w, idx, _, m = rg[0]
    gm, cell, keep, cells = mg[0]
    feats = torch.randn((m, g.shape[1]), device=DEVICE).to(g.dtype).requires_grad_(True)
    grid = torch.zeros((gm.shape[0], cells), device=DEVICE, dtype=torch.bfloat16,
                       requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        IG.corner_gather(feats, idx, w.float()).backward(g)
        IG.mask_read(grid, cell, keep).backward(gm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  the reads' forward (the maps built) and backward (the kernels) under "
        "set_sync_debug_mode('error'): no host sync")
    return roi, mask


# --------------------------------------------------------------------------
# phase 3, the optimizer: global_sumsq_* and optim_apply


def max_err(got, want) -> float:
    """Largest |got - want| over tensors or lists of them, NaN where both are
    NaN counted as 0 (and where only one is, as inf)."""
    if got is None:
        return 0.0
    if isinstance(got, list):
        return max((max_err(a, b) for a, b in zip(got, want)), default=0.0)
    both = got.isnan() & want.isnan()
    d = (got.double() - want.double()).abs().masked_fill(both, 0.0).nan_to_num(nan=float("inf"))
    return d.max().item() if d.numel() else 0.0


def optim_bytes(numels, kind: str, ema: bool) -> dict:
    """Bytes each once of the norm (g read) and of the apply pass (AdamW: g,
    p, μ, ν read, p, μ, ν written; SGD: g, p, μ and p, μ; the EMA: e read
    and written, p read where no update reads it)."""
    n = sum(numels)
    per = {"adamw": 28, "sgd": 20, "ema": 4}[kind] + (8 if ema else 0)
    return {"norm": 4 * n, "apply": per * n}


def optim_record(name, shapes, kind, grads, count, ema, seed, timed=False) -> dict:
    """The kernels against their plain versions on one case of
    ``OC.OPTIM_CASES``: the norm and every list after one call bit-equal
    (NaN equal to NaN) and bit-identical across two launches; ``timed``,
    kernel, plain, library and bound times too."""
    numels = [int(np.prod(s)) for s in shapes]
    lists = OC.optim_case(DEVICE, shapes, grads, seed, layout=OC.layout(name))
    got, again = (OC.run_optim(lists, kind, count, ema, kernel=True) for _ in range(2))
    want = OC.run_optim(lists, kind, count, ema, kernel=False)
    torch.cuda.synchronize()
    nbytes = optim_bytes(numels, kind, ema)
    rec = {"case": name, "kind": kind, "grads": grads, "count": count, "ema": ema,
           "tensors": len(numels), "entries": sum(numels),
           "launches_per_call": len(OPT.chunk_plan(numels)[1]),
           "norm": None if got[0] is None else float(got[0]),
           "channels_last_grads": sum(OPT.grad_layout(g) != (0, 0) for g in lists["grads"]),
           "bit_equal": all(OC.same_bits(g, w) for g, w in zip(got, want)),
           "bit_identical": all(OC.same_bits(g, a) for g, a in zip(got, again)),
           "max_abs_err": max(max_err(g, w) for g, w in zip(got, want)),
           "bytes": nbytes}
    rec["ok"] = rec["bit_equal"] and rec["bit_identical"]
    if timed:
        rec.update(optim_times(lists, kind, count, ema, nbytes))
    log(f"  optimizer {name:12s} {kind:5s} {len(numels):4d} tensors {sum(numels):9d} entries, "
        f"grads {grads}, count {count}, EMA {ema}: norm {rec['norm']}, max_abs_err "
        f"{rec['max_abs_err']:.3e} bit_equal={rec['bit_equal']} "
        f"bit_identical={rec['bit_identical']} {'ok' if rec['ok'] else 'MISMATCH'}"
        + ("" if not timed else " | " + ", ".join(
            f"{k}={rec[k]:.4f}" for k in rec if k.endswith("_ms"))))
    return rec


def optim_times(lists, kind, count, ema, nbytes) -> dict:
    """Card ms of the norm and the apply pass (kernels, plain versions, the
    parent's norm ``sqrt(Σ sum(t·t))``), of torch's own
    ``get_total_norm(foreach=True)``, ``_fused_adamw_`` and
    ``clip_grad_norm_(foreach=True)`` + ``_fused_adamw_`` on the same lists
    (yardsticks of time only: torch's AdamW places ε and the decay
    elsewhere), and the bounds (bytes each once / the card's rate). The
    lists change from run to run: only the times count."""
    c = {k: [OC.fresh(t) for t in v] for k, v in lists.items()}
    g, p, mu, nu, e = (c[k] for k in ("grads", "params", "mu", "nu", "ema"))
    nu = nu if kind == "adamw" else None
    e = e if ema else None
    step = OPT.Step(kind, lr=3e-3, count=count, clip=10.0, weight_decay=0.05,
                    ema_decay=np.float32(0.9) if ema else None)
    norm = OPT.global_norm_kernel(g)
    gl = [x.contiguous() for x in g]     # torch's fused AdamW wants one layout
    steps = [torch.ones((), device=DEVICE) for _ in p]
    lib = dict(lr=3e-3, beta1=OPT.B1, beta2=OPT.B2, weight_decay=0.05, eps=OPT.EPS,
               amsgrad=False, maximize=False)
    # the wrappers take the host up to a millisecond a call at config 2 and
    # the plain chain some 20: spin long enough that every run is queued
    q = {k: {**v, "spin": OPTIM_SPIN_CYCLES} for k, v in QUICK_REPS.items()}
    out = {
        "norm_host_ms": host_ms(lambda: OPT.global_norm_kernel(g)),
        "apply_host_ms": host_ms(lambda: OPT.optim_apply_kernel(norm, g, p, mu, nu, e, step)),
        "norm_kernel_ms": time_ms(lambda: OPT.global_norm_kernel(g), **q["kernel"]),
        "norm_plain_ms": time_ms(lambda: OPT.global_norm_reference(g), **q["plain"]),
        "norm_parent_ms": time_ms(lambda: torch.sqrt(sum(torch.sum(t * t) for t in g)),
                                  **q["plain"]),
        "norm_library_ms": time_ms(lambda: torch.nn.utils.get_total_norm(g, foreach=True),
                                   **q["plain"]),
        "apply_kernel_ms": time_ms(lambda: OPT.optim_apply_kernel(norm, g, p, mu, nu, e, step),
                                   **q["kernel"]),
        "apply_plain_ms": time_ms(lambda: OPT.optim_apply_reference(norm, g, p, mu, nu, e,
                                                                    step), **q["plain"]),
        "norm_bound_ms": nbytes["norm"] / HBM_BYTES_PER_S * 1e3,
        "apply_bound_ms": nbytes["apply"] / HBM_BYTES_PER_S * 1e3,
    }
    if kind == "adamw":
        out["apply_library_ms"] = time_ms(
            lambda: torch._fused_adamw_(p, gl, mu, nu, [], steps, **lib), **q["plain"])
        out["stage_library_ms"] = time_ms(lambda: (
            torch.nn.utils.clip_grad_norm_(gl, 10.0, foreach=True),
            torch._fused_adamw_(p, gl, mu, nu, [], steps, **lib)), **q["plain"])
    return out


def host_ms(fn, calls: int = 20) -> float:
    """Host ms a call of ``fn`` takes to return (the enqueue, not the card's
    work), over ``calls`` back-to-back calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def phase_optim() -> tuple:
    """Every case of ``OC.OPTIM_CASES``, then config 1's and config 2's
    parameter shapes timed (AdamW, the clip triggered, no EMA, 5-D
    gradients channels-last, as their train steps run). Returns (edge
    records, {config: timed record})."""
    log("[phase 3, optimizer] global_sumsq_partial + global_sumsq_finish and optim_apply vs "
        "their plain versions (the fixed-order norm in elementwise ops, the foreach chain): "
        "bit-equal (NaN equal to NaN) and bit-identical across two launches")
    recs = []
    for i, (name, sizes, kind, grads, count, ema) in enumerate(OC.OPTIM_CASES):
        recs.append(optim_record(name, OC.case_shapes(sizes), kind, grads, count, ema, 800 + i))
    shapes = {}
    for i, config in enumerate(("config1_tiny_5cm", "config2_scannet_2cm")):
        cs = OC.config_shapes(config)
        if len(OPT.chunk_plan([int(np.prod(s)) for s in cs])[1]) != OPT_PER_STEP[1]:
            raise AssertionError(f"{config}'s {len(cs)} tensors take more than one launch")
        shapes[config] = optim_record(config, cs, "adamw", "clip", 1, False, 900 + i,
                                      timed=True)
    bad = [r["case"] for r in recs + list(shapes.values()) if not r["ok"]]
    if bad:
        raise AssertionError(f"optimizer kernels disagree with their plain versions: {bad}")
    return recs, shapes


def nms_record(name: str, seed: int, timed: bool = False) -> dict:
    """The NMS kernel against the plain loop on case ``name`` of
    ``NC.NMS_CASES``: ``keep_idx`` and ``keep_mask`` bit-equal and
    bit-identical across two launches, one launch a call; the "ulp" and
    "prod" cases' pair IoUs as ``box_iou_3d`` gives them on the card;
    ``timed``, kernel, plain, host and bound times too."""
    c = NC.nms_case(name, DEVICE, seed)
    before = NL.LAUNCHES["nms_3d"]
    got, again = NC.run_kernel(c), NC.run_kernel(c)
    want = NC.run_plain(c)
    torch.cuda.synchronize()
    b, n = c["scores"].shape
    rec = {"case": name, "scenes": b, "candidates": n, "outputs": c["p"],
           "threshold": c["threshold"], "kept": int(got[1].sum()),
           "launches_per_call": (NL.LAUNCHES["nms_3d"] - before) / 2,
           "bit_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
           "bit_identical": all(torch.equal(g, a) for g, a in zip(got, again))}
    if "pairs" in c:
        rec["pair_ious"] = NC.pair_ious(c)
        rec["pairs_kept"] = [[i in got[0][0][got[1][0]].tolist() for i in pair]
                             for pair in c["pairs"]]
    rec["ok"] = rec["bit_equal"] and rec["bit_identical"] and rec["launches_per_call"] == 1
    if timed:
        # the plain loop's host takes tens of ms a call: spin long enough to queue it
        q = {k: {**v, "spin": OPTIM_SPIN_CYCLES} for k, v in QUICK_REPS.items()}
        nbytes = b * n * (6 * 4 + 4 + 1) + b * c["p"] * (4 + 1)
        rec.update({
            "kernel_ms": time_ms(lambda: NC.run_kernel(c), **REPS["kernel"]),
            "plain_ms": time_ms(lambda: NC.run_plain(c), **q["plain"]),
            "host_ms": host_ms(lambda: NC.run_kernel(c)),
            "plain_host_ms": host_ms(lambda: NC.run_plain(c), calls=3),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    log(f"  nms {name:10s} {b} x {n} -> {c['p']}: kept {rec['kept']}, bit_equal="
        f"{rec['bit_equal']} bit_identical={rec['bit_identical']} launches/call "
        f"{rec['launches_per_call']} {'ok' if rec['ok'] else 'MISMATCH'}"
        + (f" | pair IoUs {rec['pair_ious']} kept {rec['pairs_kept']}" if "pairs" in c else "")
        + ("" if not timed else " | " + ", ".join(
            f"{k}={rec[k]:.4f}" for k in rec if k.endswith("_ms"))))
    return rec


def phase_nms() -> tuple:
    """Every case of ``NC.NMS_CASES``, then select's shapes timed (config
    2's two scenes of 512 candidates to 128, config 1's one of 128 to 32).
    Returns (records, {config: timed record})."""
    log("[phase 3, NMS] nms_3d vs the plain loop nms_3d_reference scene by scene: keep_idx "
        "and keep_mask bit-equal and bit-identical across two launches, one launch a batch")
    recs = [nms_record(name, 1000 + i) for i, (name, *_) in enumerate(NC.NMS_CASES)]
    timed = {"config2_scannet_2cm": nms_record("select", 1100, timed=True),
             "config1_tiny_5cm": nms_record("config1", 1101, timed=True)}
    ulp = next(r for r in recs if r["case"] == "ulp")
    if ulp["pairs_kept"] != [[True, True], [True, False], [True, False]]:
        raise AssertionError(f"near the threshold the kernel kept {ulp['pairs_kept']}: the "
                             "threshold is not compared as a float32")
    bad = [r["case"] for r in recs + list(timed.values()) if not r["ok"]]
    if bad:
        raise AssertionError(f"the NMS kernel disagrees with the plain loop: {bad}")
    return recs, timed


# --------------------------------------------------------------------------
# phase 3, the norm: bn_stats, bn_apply and bn_grad against the plain chain


def bn_step(config: str, sets: list) -> dict:
    """The norms of one train step of ``config`` (``BC.measure_step``: each
    first forward's kernels held to the chain, each norm timed through the
    kernels, the chain and each role alone) and the step's launches by
    role, held to its norms; the sums."""
    res = BC.measure_step(config, sets, DEVICE, lambda fn: time_ms(
        fn, **{**QUICK_REPS["kernel"], "spin": OPTIM_SPIN_CYCLES}))
    rec = {"launches": res["launches"], **res["total"]}
    want = norm_launches(res["modules"], rec["recomputed"], train_steps=1)
    if rec["launches"] != want:
        raise AssertionError(f"{res['config']}: one train step launched {rec['launches']}, "
                             f"expected {want}")
    log(f"  {res['config']}: {rec['norms']} norms, {rec['calls']} calls ({rec['recomputed']} "
        f"recomputed) a step; launches {rec['launches']}; kernels {rec['kernel_ms']:.3f} ms "
        f"(bn_stats {rec['bn_stats_ms']:.3f}, bn_apply {rec['bn_apply_ms']:.3f}, bn_grad "
        f"{rec['bn_grad_ms']:.3f}), bound {rec['bound_ms']:.3f}, chain {rec['plain_ms']:.3f}; "
        f"vectors and apply bit_equal {rec['vectors_bit_equal']} {rec['apply_bit_equal']}, "
        f"input gradient bit_equal {rec['grad_input_bit_equal']}, bit_identical "
        f"{rec['bit_identical']}, stats gap {rec['stats_gap']:.2e}, gradient gap "
        f"{rec['grad_gap']:.2e}")
    return rec


def phase_batch_norm() -> tuple:
    """Every case of ``BC.BN_CASES``, then config 1's and config 2's norms
    of one train step (``bn_step``). Returns (case records, {config: step
    record})."""
    log("[phase 3, norm] bn_stats, bn_apply and bn_grad vs the plain chain "
        "(MaskedBatchNorm.normalize + torch.relu and their autograd): the vectors, the apply "
        "and the input gradient bit-equal given the same sums, the statistics and gradients "
        "within benchmarks/bn_cases.py's tolerances, bit-identical across two runs")
    recs = []
    for i, case in enumerate(BC.BN_CASES):
        rec = {"case": BC.case_id(case), **BC.compare(BC.make_case(*case, DEVICE, 1200 + i))}
        log(f"  {rec['case']:22s} vectors/apply bit_equal={rec['vectors_bit_equal']}/"
            f"{rec['apply_bit_equal']} input gradient "
            f"bit_equal={rec['grad_input_bit_equal']} bit_identical={rec['bit_identical']} "
            f"stats gap {max(rec['stats_gap_mean'], rec['stats_gap_var']):.2e} gradient gap "
            f"{max(rec['grad_gap'].values()):.2e} {'ok' if rec['ok'] else 'MISMATCH'}")
        recs.append(rec)
    steps = {"config1_tiny_5cm": bn_step(CONFIG1, []), "config2_scannet_2cm": bn_step(CONFIG2,
                                                                                      C2_SET)}
    bad = [r["case"] for r in recs if not r["ok"]] + [k for k, r in steps.items() if not r["ok"]]
    if bad:
        raise AssertionError(f"the norm's kernels disagree with the plain chain: {bad}")
    return recs, steps


def bn_entry(role: str, recs: list, steps: dict, paths: dict) -> dict:
    """One norm role of the ``kernels`` line: config 2's train step at the
    top level, config 1's under ``config1``."""
    def fig(r):
        return {"ms": r[f"{role}_ms"], "launches_per_step": r["launches"][role]}

    def norm(r):
        return {"kernel_ms": r["kernel_ms"], "bound_ms": r["bound_ms"],
                "plain_ms": r["plain_ms"], "stats_gap": r["stats_gap"],
                "grad_gap": r["grad_gap"]}
    every = recs + list(steps.values())
    return {"name": role, "route": "cuda",
            "source": "sparse_rcnn_tpu_torch/ops/csrc/batch_norm.cu",
            "replaces": "no TPU kernel: the port's eager chain "
                        "models/layers.py::MaskedBatchNorm.normalize + torch.relu (JAX: "
                        "sparse_rcnn_tpu/models/layers.py MaskedBatchNorm, plain XLA)",
            **fig(steps["config2_scannet_2cm"]),
            "norm": norm(steps["config2_scannet_2cm"]),
            "bit_equal": all(r["vectors_bit_equal"] and r["apply_bit_equal"]
                             and r["grad_input_bit_equal"] and r["bit_identical"]
                             for r in every),
            "library": None, "bound_by": "bytes",
            "per": "one config-2 train step's norms (bf16, dense-3, main-path inputs; norm: "
                   "every norm's forward and backward, kernels, bytes once at 3.35 TB/s, the "
                   "chain); config1: config 1's (f32)",
            "config1": {**fig(steps["config1_tiny_5cm"]), "norm": norm(steps["config1_tiny_5cm"])},
            "launches_by_path": {k: v[role] for k, v in paths.items()}}


def count_selects() -> list:
    """Wrap the detector's ``select_proposals`` to count its calls on CUDA
    tensors in ``[0]`` of the list returned (each should launch one NMS)."""
    calls = [0]
    select = DET.select_proposals

    def counted(obj_logits, *args, **kw):
        calls[0] += obj_logits.is_cuda
        return select(obj_logits, *args, **kw)
    DET.select_proposals = counted
    return calls


def nms_step_launches() -> dict:
    """NMS launches in one config-1 train step and one eval step on the card
    (one each: the batch's scenes in one launch)."""
    cfg = load_config(CONFIG1)
    batch = next(Loader(cfg, seed=cfg.train.seed, threads=False))

    def model():
        return TL.build_model(cfg, DEVICE, torch.Generator().manual_seed(cfg.train.seed))
    out = {}
    before = NL.LAUNCHES["nms_3d"]
    TL.eval_step(cfg, TL.eval_model(cfg, model()), TL.to_device(batch, DEVICE))
    out["config1 eval step"] = NL.LAUNCHES["nms_3d"] - before
    state = TL.init_state(cfg, model=model())
    before = NL.LAUNCHES["nms_3d"]
    TL.train_step(cfg, state, TL.to_device(batch, DEVICE, TL.TRAIN_KEYS))
    out["config1 train step"] = NL.LAUNCHES["nms_3d"] - before
    torch.cuda.synchronize()
    log(f"  NMS launches: {json.dumps(out)}")
    if out != {"config1 eval step": 1, "config1 train step": 1}:
        raise AssertionError(f"expected one NMS launch a step, got {out}")
    return out


def nms_entry(recs, timed, paths) -> dict:
    """The NMS kernel of the ``kernels`` line: config 2's shape at the top
    level, config 1's under ``config1``."""
    def fig(r):
        return {k: r[k] for k in ("kernel_ms", "plain_ms", "host_ms", "plain_host_ms",
                                  "bound_ms")}
    return {"name": "nms_3d", "route": "cuda", "source": "sparse_rcnn_tpu_torch/ops/csrc/nms.cu",
            "replaces": "the port's greedy loop ops/nms.py::nms_3d_reference (JAX: "
                        "sparse_rcnn_tpu/ops/nms.py::nms_3d, a lax.fori_loop)",
            "launches": paths["config1 train step"], **fig(timed["config2_scannet_2cm"]),
            "bit_equal": all(r["bit_equal"] and r["bit_identical"]
                             for r in recs + list(timed.values())),
            "library": None, "bound_by": "bytes (the work is P barrier-bound iterations)",
            "per": "one select call of config 2 (2 scenes, 512 candidates, 128 outputs); "
                   "plain: nms_3d_reference scene by scene; config1: 1 scene, 128 to 32",
            "config1": fig(timed["config1_tiny_5cm"]), "launches_by_path": paths}


def train_step_syncs(cfg, state, batches) -> dict:
    """One warm ``TL.train_step`` with its host syncs counted by site under
    ``set_sync_debug_mode("warn")`` (none allowed), then one under
    ``"error"`` (any sync raises)."""
    TL.train_step(cfg, state, batches[0])
    with SYNCS.sync_sites() as sites:
        TL.train_step(cfg, state, batches[1])
    if sites:
        raise AssertionError(f"the train step synchronises the host: {dict(sites)}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TL.train_step(cfg, state, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  one train step under set_sync_debug_mode('error') after 0 syncs counted under "
        "'warn': the step, optimizer included, reads nothing back on the host")
    return {"syncs": 0, "error_mode_step": "ok"}


# --------------------------------------------------------------------------
# phase 6: the config-1 training slice on the card, against the CPU


def launched(before: dict) -> dict:
    """The launches of each of ``ROLES`` since ``before``, a copy of
    ``NL.LAUNCHES``."""
    return {r: NL.LAUNCHES[r] - before.get(r, 0) for r in ROLES}


def want_launches(fwd: int, dgrad: int = 0, wgrad: int = 0, scene_steps: int = 0,
                  steps: int = 0) -> dict:
    """The ``launched`` a path of ``steps`` train steps should give, but for
    the norm's roles (:func:`launches_match`): the two indexing backwards
    and the mask read's map launch once per scene per train step, the
    optimizer's kernels ``OPT_PER_STEP`` a step; none of them in an eval."""
    return dict(zip(ROLES, (fwd, dgrad, wgrad, scene_steps, scene_steps, scene_steps,
                            OPT_PER_STEP[0] * steps, OPT_PER_STEP[1] * steps)))


def norm_launches(norms: int, recomputed: int = 0, train_steps: int = 0,
                  eval_forwards: int = 0, eval_norms: int = None) -> dict:
    """The norm's launches of ``train_steps`` train steps of a model with
    ``norms`` norms (``recomputed`` of them again under remat) and of
    ``eval_forwards`` forwards of its eval form (``eval_norms``, by default
    ``norms``)."""
    every = train_steps * (norms + recomputed)
    return {"bn_stats": 2 * every,
            "bn_apply": every + eval_forwards * (norms if eval_norms is None else eval_norms),
            "bn_grad": 2 * train_steps * norms}


def launches_match(got: dict, want: dict) -> bool:
    """``got`` (:func:`launched`) against ``want``: every role ``want``
    names exactly; the norm's roles it does not name by the path's kind: a
    path that trains (wgrad launches) launches all three, bn_stats and
    bn_grad in pairs; one that only runs forwards launches bn_apply alone;
    one with no forward none."""
    if any(got[r] != n for r, n in want.items()):
        return False
    stats, apply, grad = (got[r] for r in BN_ROLES)
    if all(r in want for r in BN_ROLES):
        return True
    if want.get("wgrad"):
        return min(stats, apply, grad) > 0 and stats % 2 == 0 and grad % 2 == 0
    if want.get("forward"):
        return apply > 0 and stats == grad == 0
    return stats == apply == grad == 0


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
    """The dgrad, wgrad, roi_crop_grad and mask_read_grad kernels against
    their plain versions, timed, on the inputs that one config-1 train
    step's backward gives them."""
    dg, wg, rg, mg, reads = capture(lambda: TL.loss_and_grads(cfg, model, batch),
                                    "conv_dgrad", "conv_wgrad", "roi_crop_grad",
                                    "mask_read_grad", "mask_read")
    mg = mask_calls(reads, mg)
    if [len(dg), len(wg), len(rg), len(mg)] != [PER_STEP[r] for r in ROLES[1:5]]:
        raise AssertionError(f"{len(dg)} dgrad, {len(wg)} wgrad, {len(rg)} roi_crop_grad and "
                             f"{len(mg)} mask_read_grad calls in one step")
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
    log("  roi_crop_grad and mask_read_grad vs their plain version on the inputs of the "
        "main path (one config-1 train step)")
    return (d, w_, *main_path_index_grad(rg, mg))


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
    before = dict(NL.LAUNCHES)
    ckpt = os.path.join(out_dir, "ckpt_train")
    shutil.rmtree(ckpt, ignore_errors=True)
    train_cli.main(["--config", CONFIG1, "--set", f"train.total_steps={TRAIN_STEPS}",
                    "--set", "train.log_every=1", "--set", f"train.checkpoint_dir={ckpt}",
                    "--device", DEVICE, "--log-file", log_path])
    torch.cuda.synchronize()
    launches = launched(before)
    want = {r: TRAIN_STEPS * n for r, n in PER_STEP.items()}
    log(f"  launches in train.main over {TRAIN_STEPS} steps: {launches}, "
        f"expected {want}")
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
    stream = Loader(cfg, seed=cfg.train.seed, threads=False)
    batches = [next(stream) for _ in range(3)]
    init = TL.build_model(cfg, "cpu", torch.Generator().manual_seed(cfg.train.seed))
    names = [n for n, _ in init.named_parameters()]
    report = {"launches": launches, "losses": steps}
    for wname, weights in LOSS_WEIGHTS.items():
        cfg_w = load_config(CONFIG1, {"train": {"loss_weights": weights}})
        res = {}
        for dev in (DEVICE, "cpu"):
            model = copy.deepcopy(init).to(dev)
            before = dict(NL.LAUNCHES)
            res[dev] = TL.loss_and_grads(cfg_w, model, TL.to_device(batches[0], dev,
                                                                     TL.TRAIN_KEYS))
            torch.cuda.synchronize()
            delta = launched(before)
            want = {**PER_STEP, "global_norm": 0, "optim_apply": 0}
            if dev == DEVICE and delta != want:
                raise AssertionError(f"one loss_and_grads launched {delta}, expected {want}")
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

    state = TL.init_state(cfg, model=copy.deepcopy(init).to(DEVICE))
    report["train_step_syncs"] = train_step_syncs(cfg, state, [
        TL.to_device(b, DEVICE, TL.TRAIN_KEYS) for b in batches[:2]])
    split = [step_split(cfg, state, TL.to_device(b, DEVICE, TL.TRAIN_KEYS)) for b in batches]
    report["step_ms"] = {k: statistics.mean(s[k] for s in split) for k in split[0]}
    log("  warm ms per train step (host clock, synchronised after each stage, median "
        f"of 5 per batch, mean of {len(split)} batches): "
        + json.dumps({k: round(v, 3) for k, v in report["step_ms"].items()}))
    (report["dgrad_main_path"], report["wgrad_main_path"], report["roi_grad_main_path"],
     report["mask_grad_main_path"]) = main_path_backward(
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


def scene_alone_vs_batch(cfg, model, batch) -> dict:
    """The eval step on ``batch`` and on each of its scenes alone: packed
    mask bits, proposal scores and class logits ``torch.equal`` (the dense
    tail convolves one scene at a time, so no conv sees another shape)."""
    keys = ("point_mask_bits", "proposal_scores", "cls_logits")
    both = TL.eval_step(cfg, model, batch)
    n = batch["points"].shape[0]
    for b in range(n):
        alone = TL.eval_step(cfg, model, {k: v[b:b + 1] for k, v in batch.items()})
        differ = [k for k in keys if not torch.equal(both[k][b:b + 1], alone[k])]
        if differ:
            raise AssertionError(f"config 2, scene {b} alone against in a batch of {n}: "
                                 f"{differ} differ")
    bits = int(both["point_mask_bits"].numel() * 8)
    log(f"  eval step at batch {n} against each scene alone ({cfg.model.backbone.dtype}, "
        f"dense-{cfg.model.backbone.dense_from_scale}): {', '.join(keys)} torch.equal "
        f"({bits} mask bits)")
    return {"scenes": n, "mask_bits": bits, "equal": list(keys)}


def batched_conv(conv, x, dtype):
    """The dense tail's conv over the whole batch in one call (how
    ``models/unet.py::_conv`` ran before it went one scene at a time), kept
    only to time the two against each other."""
    xc = x.to(dtype).permute(0, 4, 1, 2, 3)
    w = conv.weight.to(dtype)
    if isinstance(conv, torch.nn.ConvTranspose3d):
        y = torch.nn.functional.conv_transpose3d(xc, w, stride=conv.stride)
    else:
        y = torch.nn.functional.conv3d(xc, w, stride=conv.stride, padding=conv.padding)
    return y.permute(0, 2, 3, 4, 1)


def dense_tail_cost(cfg, ev, init, eval_batch, train_batch) -> dict:
    """Warm ms of config 2's eval backbone (dense-2) and train step (dense-3)
    with the dense tail's convs one scene at a time (the port's) and over
    the whole batch (``batched_conv``), in turns: batched, per scene, per
    scene, batched; host clock around synchronised work, medians of 5
    (backbone) and 2 (step) runs after one."""
    with torch.no_grad():
        st, _, scales, _, _ = TL.prepare_inputs(cfg, eval_batch)
    state = TL.init_state(cfg, model=copy.deepcopy(init))
    real = U._conv
    res = {"eval_backbone_ms": {"batched": [], "per_scene": []},
           "train_step_ms": {"batched": [], "per_scene": []}}
    for form in ("batched", "per_scene", "per_scene", "batched"):
        U._conv = batched_conv if form == "batched" else real
        try:
            with torch.no_grad():
                res["eval_backbone_ms"][form].append(timed_steps(
                    lambda _: ev.backbone(st.feats, scales), [None], reps=5)["median"])
            res["train_step_ms"][form].append(timed_steps(
                lambda _: TL.train_step(cfg, state, train_batch), [None], reps=2)["median"])
        finally:
            U._conv = real
    log("  dense tail one scene at a time against the whole batch, warm ms (turns batched, "
        "per scene, per scene, batched): " + json.dumps(
            {k: {f: [round(x, 3) for x in v] for f, v in d.items()} for k, d in res.items()}))
    return res


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
    norms = BC.count_norms(init)
    rep = {"sparse_convs": {"eval": n_eval, "train": n_train}, "norms": norms}

    # the main paths, through the entry points a user calls
    before = dict(NL.LAUNCHES)
    infer.main(["--config", CONFIG2, *sets, "--set",
                f"train.checkpoint_dir={os.path.join(tmp_dir, 'none')}",
                "--num-scenes", str(cfg.data.batch_size),
                "--out-dir", os.path.join(out_dir, "infer_config2"), "--device", DEVICE])
    torch.cuda.synchronize()
    rep["launches_infer"] = launched(before)
    want = {**want_launches(n_eval), **norm_launches(norms, eval_forwards=1)}
    log(f"  launches in infer.main, one batch: {rep['launches_infer']}, expected {want}")
    if rep["launches_infer"] != want:
        raise AssertionError(f"config-2 infer.main launched {rep['launches_infer']}")
    log_path = os.path.join(out_dir, "train_log_config2.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    before = dict(NL.LAUNCHES)
    state = train_cli.main(["--config", CONFIG2, *sets, "--set",
                            f"train.total_steps={C2_TRAIN_STEPS}", "--set", "train.log_every=1",
                            "--set", f"train.checkpoint_dir={os.path.join(tmp_dir, 'phase8')}",
                            "--device", DEVICE, "--log-file", log_path])
    torch.cuda.synchronize()
    rep["launches_train"] = launched(before)
    want = {**want_launches(C2_TRAIN_STEPS * n_train, C2_TRAIN_STEPS * (n_train - 1),
                            C2_TRAIN_STEPS * n_train, C2_TRAIN_STEPS * cfg.data.batch_size,
                            steps=C2_TRAIN_STEPS),
            **norm_launches(norms, train_steps=C2_TRAIN_STEPS)}
    log(f"  launches in train.main over {C2_TRAIN_STEPS} steps: {rep['launches_train']}, "
        f"expected {want}")
    if rep["launches_train"] != want:
        raise AssertionError(f"config-2 train.main launched {rep['launches_train']}, "
                             f"expected {want}")
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
    rep["scene_alone_vs_batch"] = scene_alone_vs_batch(cfg, ev, tb[0])
    eval_ms = timed_steps(lambda b: TL.eval_step(cfg, ev, b), tb, reps=4)
    rep["eval_ms_per_scene"] = {k: v / bs if k != "n" else v for k, v in eval_ms.items()}
    log("  eval step, warm ms per scene (host clock, synchronised, 4 runs of each batch "
        "after one): " + json.dumps({k: round(v, 3) for k, v in
                                     rep["eval_ms_per_scene"].items()}))
    del tb, calls

    # train: the kernels on one step's inputs, run to run, remat
    trb = [TL.to_device(b, DEVICE, TL.TRAIN_KEYS) for b in batches]
    fw, dg, wg, rg, mg, reads = capture(
        lambda: TL.loss_and_grads(tcfg, copy.deepcopy(init), trb[0]), "conv_forward",
        "conv_dgrad", "conv_wgrad", "roi_crop_grad", "mask_read_grad", "mask_read")
    mg = mask_calls(reads, mg)
    if [len(fw), len(dg), len(wg), len(rg), len(mg)] != list(
            want_launches(n_train, n_train - 1, n_train, bs).values())[:5]:
        raise AssertionError(f"{len(fw)} forward, {len(dg)} dgrad, {len(wg)} wgrad, {len(rg)} "
                             f"roi_crop_grad and {len(mg)} mask_read_grad calls in one step")
    log(f"  forward, dgrad and wgrad kernels vs plain versions on the inputs of one config-2 "
        f"train step ({len(fw)}, {len(dg)} and {len(wg)} calls, bf16, dense-3; tolerances as "
        "in phase 3)")
    rep["forward_train_main_path"] = [
        measure_conv(f"K{w.shape[0]} {w.shape[1]}->{w.shape[2]}", f, i, w, reps=QUICK_REPS)
        for f, i, w in fw]
    fwd_train = totals(rep["forward_train_main_path"])
    log(f"  the train step's {len(fw)} forward convs: kernel {fwd_train['ms']:.3f} ms, bound "
        f"{fwd_train['bound_ms']:.4f} ({fwd_train['bound_by']}), plain "
        f"{fwd_train['plain_ms']:.2f}, library {fwd_train['library_ms']:.3f}")
    rep["dgrad_main_path"] = [measure_dgrad(f"K{w.shape[0]} {w.shape[1]}->{w.shape[2]}",
                                            g, t, w, reps=QUICK_REPS) for g, t, w in dg]
    rep["wgrad_main_path"] = [measure_wgrad(f"K{t.shape[1]} {f.shape[2]}->{g.shape[2]}",
                                            f, t, g, reps=QUICK_REPS) for f, t, g in wg]
    require_ok(rep["forward_train_main_path"] + rep["dgrad_main_path"]
               + rep["wgrad_main_path"], "config-2 train step, main-path inputs")
    partials = [t.shape[1] * f.shape[0] * sc.wgrad_chunks(f.shape[1])[1] * f.shape[2]
                * g.shape[2] * 4 for f, t, g in wg]
    rep["wgrad_partials_max_bytes"] = max(partials)
    log(f"  wgrad partials buffer: largest {max(partials) / 2**20:.1f} MiB "
        f"(K x B*chunks x Cin x Cout f32), sum over the step {sum(partials) / 2**20:.1f} MiB")
    log("  roi_crop_grad and mask_read_grad vs their plain version on the inputs of one "
        "config-2 train step (a record a scene)")
    rep["roi_grad_main_path"], rep["mask_grad_main_path"] = main_path_index_grad(
        rg, mg, QUICK_REPS)
    del fw, dg, wg, rg, mg, reads

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
    del state
    rep["dense_tail_cost"] = dense_tail_cost(cfg, ev, init, TL.to_device(batches[0], DEVICE),
                                             trb[0])
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
    """``fn(argv)``; returns (its result, its launches of ``ROLES``)."""
    before = dict(NL.LAUNCHES)
    out = fn(argv)
    torch.cuda.synchronize()
    got = launched(before)
    log(f"  {what}: launches {got}")
    return out, got


def expect(got, want, what: str) -> None:
    """``got`` launches against ``want`` (:func:`launches_match`)."""
    if not launches_match(got, want):
        raise AssertionError(f"{what}: {got}, expected {want}")


def sequential_eval(cfg, model, batches, num_scenes: int, bits: list) -> dict:
    """``run_eval``'s pass before the lookahead, written out: each batch's
    eval step, a wait for the card, the fetch, then its scenes scored, one
    batch after the other. Appends each batch's packed mask bits to
    ``bits``; returns mAP, per-scene mAP@0.5 (as ``run_eval`` rounds it),
    scenes and the split as ``run_eval``'s keys."""
    ev = EV.InstanceAPEvaluator(cfg.model.num_classes)
    seen, t_dev, t_fetch, t_host = 0, 0.0, 0.0, 0.0
    t_pass = time.perf_counter()
    for bi, (batch, dev) in enumerate(device_batches(batches, DEVICE, TL.BATCH_KEYS)):
        t0 = time.perf_counter()
        raw = TL.eval_step(cfg, model, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fetch_eval_outputs(raw)
        del raw
        bits.append(out["point_mask_bits"])
        t2 = time.perf_counter()
        for b in range(len(batch["valid"])):
            if bi * cfg.data.batch_size + b >= num_scenes:
                continue
            o, (valid, pinst, psem) = EV._scene_slice(out, batch, b)
            masks, scores, pred_cls, pmask = EV.postprocess_scene(o, 0, cfg.model.num_classes)
            ev.add_scene(masks, scores, pred_cls, pmask, pinst,
                         EV._gt_classes_from_points(pinst, psem, valid), valid)
            seen += 1
        t_dev += t1 - t0
        t_fetch += t2 - t1
        t_host += time.perf_counter() - t2
    res = ev.compute()
    res["per_scene_mAP@0.5"] = [round(float(x), 4) if np.isfinite(x) else None
                                for x in ev.per_scene_map(0.5)]
    res.update(scenes=seen, eval_wall_s=time.perf_counter() - t_pass, eval_dev_s=t_dev,
               eval_fetch_s=t_fetch, eval_host_s=t_host)
    return res


@contextlib.contextmanager
def fetched_bits(bits: list):
    """``run_eval``'s fetches, with each batch's packed mask bits appended
    to ``bits``."""
    real = EV.fetch_eval_outputs

    def spy(out):
        host = real(out)
        bits.append(host["point_mask_bits"])
        return host
    EV.fetch_eval_outputs = spy
    try:
        yield
    finally:
        EV.fetch_eval_outputs = real


def peak_bytes() -> dict:
    """The card's peak memory since the last reset: the bytes the tensors
    asked for, and those allocated (``max_memory_allocated``, in the caching
    allocator's blocks, whose rounding depends on what it holds already)."""
    return {"requested": torch.cuda.memory_stats()["requested_bytes.all.peak"],
            "allocated": torch.cuda.max_memory_allocated()}


def lookahead_check(cfg, model, what: str) -> dict:
    """``run_eval``'s lookahead on the card for one config, ``model`` in its
    eval form: the eval step's syncs (none) and the step under the sync
    check, the gap from its return to its end on the card, and ``run_eval``
    against :func:`sequential_eval` in turns, equal results, each pass's
    split a scene, the lookahead pass's peak memory (the bytes requested)
    within one eval step's peak plus one batch's inputs (as ``run_eval``
    sends them: the instance ids of its overlap counts included)."""
    n = LOOKAHEAD_SCENES
    bs = cfg.data.batch_size
    batches = list(itertools.islice(val_batches(cfg), -(-n // bs)))
    dev = [TL.to_device(b, DEVICE) for b in batches[:2]]
    for b in dev:
        TL.eval_step(cfg, model, b)
    with SYNCS.sync_sites() as sites:
        TL.eval_step(cfg, model, dev[0])
    if sites:
        raise AssertionError(f"{what}: the eval step syncs with the host: {dict(sites)}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        TL.eval_step(cfg, model, dev[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    gaps = [SYNCS.timed_return(lambda: TL.eval_step(cfg, model, b))
            for _ in range(GAP_REPS) for b in dev]
    gap = {k: SYNCS.summary([g[k] for g in gaps]) for k in gaps[0]}
    log(f"  {what}: the eval step makes no host sync (set_sync_debug_mode 'warn': 0; "
        f"'error': none raised); ms, median of {len(gaps)} (min, max): the call to its "
        "return (host_ms), its return to its end on the card (gap_ms), its start to its "
        "end on the card (card_ms): "
        + ", ".join(f"{k} {v['median']:.3f} ({v['min']:.3f}, {v['max']:.3f})"
                    for k, v in gap.items()))
    # one step's peak, its batch already on the card, and one batch's inputs;
    # the inputs as run_eval sends them: with the instance ids its overlap
    # counts read after each step
    ids = [torch.as_tensor(b["point_instance"], device=DEVICE) for b in batches[:2]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = TL.eval_step(cfg, model, dev[0])
    torch.cuda.synchronize()
    step_peak = peak_bytes()
    batch_bytes = sum(t.nbytes for t in dev[0].values()) + ids[0].nbytes
    del out, dev, ids
    passes, bits, peak = [], {}, {"requested": 0, "allocated": 0}
    for form in ("sequential", "lookahead", "lookahead", "sequential"):
        got = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if form == "sequential":
            res = sequential_eval(cfg, model, batches, n, got)
        else:
            with fetched_bits(got):
                res = run_eval(cfg, model, batches, num_scenes=n, per_scene=True)
            torch.cuda.synchronize()
            peak = {k: max(peak[k], v) for k, v in peak_bytes().items()}
        passes.append((form, res))
        bits.setdefault(form, got)
        if not all(torch.equal(torch.from_numpy(a), torch.from_numpy(b))
                   for a, b in zip(got, bits[form], strict=True)):
            raise AssertionError(f"{what}: {form} pass's mask bits differ run to run")
    seq, look = passes[0][1], passes[1][1]
    if not all(torch.equal(torch.from_numpy(a), torch.from_numpy(b))
               for a, b in zip(bits["sequential"], bits["lookahead"], strict=True)):
        raise AssertionError(f"{what}: run_eval's packed mask bits differ from the sequential "
                             "pass's")
    keys = sorted(k for k in seq if k.startswith("mAP"))
    for form, res in passes:
        if ({k: res[k] for k in keys + ["per_scene_mAP@0.5", "scenes"]}
                != {k: seq[k] for k in keys + ["per_scene_mAP@0.5", "scenes"]}):
            raise AssertionError(f"{what}: {form} pass scored {res}, the sequential {seq}")
    if look["scenes"] != n:
        raise AssertionError(f"{what}: run_eval scored {look['scenes']} scenes, not {n}")
    if peak["requested"] > step_peak["requested"] + batch_bytes:
        raise AssertionError(f"{what}: run_eval's peak {peak} B exceeds one eval step's "
                             f"{step_peak} B plus one batch's inputs {batch_bytes} B")
    splits = [(form, per_scene_split(res)) for form, res in passes]
    log(f"  {what}: run_eval (lookahead) = the sequential pass over {n} scenes "
        f"({len(bits['lookahead'])} batches): packed mask bits torch.equal, {keys} "
        f"{[look[k] for k in keys]}, per-scene mAP@0.5 {look['per_scene_mAP@0.5']} equal; "
        f"peak bytes requested {peak['requested']} <= one step's {step_peak['requested']} + "
        f"one batch's inputs {batch_bytes} (allocated, in the allocator's rounded blocks: "
        f"{peak['allocated']}, one step's {step_peak['allocated']})")
    log(f"  {what}: s a scene in turns (wall, dev = wait after scoring, fetch, host): "
        + "; ".join(f"{form} " + ", ".join(f"{k} {v:.4f}" for k, v in sp.items())
                    for form, sp in splits))
    return {"syncs": 0, "return_gap_ms": gap, "peak_bytes": peak,
            "step_peak_bytes": step_peak, "batch_input_bytes": batch_bytes,
            "scenes": n, "mAP": {k: look[k] for k in keys},
            "split_per_scene": [{"pass": form, **sp} for form, sp in splits]}


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
    expect(got, want_launches(4 * PER_STEP["forward"] + PER_STEP["forward"] * evals_fwd,
                              4 * PER_STEP["dgrad"], 4 * PER_STEP["wgrad"],
                              4 * PER_STEP["roi_crop_grad"], steps=4),
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
    # the batches train.main read: its Loader's order, made in this thread
    stream = Loader(cfg, seed=seed, threads=False)
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
    expect(got, want_launches(2 * PER_STEP["forward"] + PER_STEP["forward"] * n,
                              2 * PER_STEP["dgrad"], 2 * PER_STEP["wgrad"],
                              2 * PER_STEP["roi_crop_grad"], steps=2),
           "config1 train.main --resume launches")
    rep["launches"]["config1 train.main --resume (2 steps, 1 eval)"] = got
    lines = jsonl(log_path)
    resumed = [r["step"] for r in lines if r["kind"] == "resume"]
    after = [r["step"] for r in lines if r["kind"] == "train"][-2:]
    if resumed != [4] or after != [5, 6]:
        raise AssertionError(f"resume: {resumed}, steps after it {after}")
    res1, got = run_cli(eval_cli.main, ["--config", CONFIG1, *sets, "--best", "--per-scene",
                                        "--device", DEVICE], "config1 eval.main --best")
    expect(got, want_launches(PER_STEP["forward"] * n), "config1 eval.main launches")
    rep["launches"]["config1 eval.main --best (3 scenes)"] = got
    if res1["scenes"] != n or len(res1["per_scene_mAP@0.5"]) != n:
        raise AssertionError(f"config1 eval.main: {res1}")
    inf_dir = os.path.join(out_dir, "infer_best")
    _, got = run_cli(infer.main, ["--config", CONFIG1, *sets, "--best", "--num-scenes", str(n),
                                  "--out-dir", inf_dir, "--device", DEVICE],
                     "config1 infer.main --best")
    expect(got, want_launches(PER_STEP["forward"] * n), "config1 infer.main launches")
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
        res[dev] = run_eval(cfg, states[dev], val_batches(cfg), per_class=True,
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
    raw = TL.eval_step(cfg, states[DEVICE], TL.to_device(next(val_batches(cfg)), DEVICE))
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
    expect(got, want_launches(2 * n_train + evals_fwd * n_eval, 2 * (n_train - 1), 2 * n_train,
                              2 * cfg2.data.batch_size, steps=2), "config2 train.main launches")
    rep["launches"]["config2 train.main (2 steps, 1 eval)"] = got
    res2, got = run_cli(eval_cli.main, ["--config", CONFIG2, *sets2, "--best",
                                        "--device", DEVICE], "config2 eval.main --best")
    expect(got, want_launches(evals_fwd * n_eval), "config2 eval.main launches")
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
    out = TL.eval_step(cfg2, ev, TL.to_device(next(val_batches(cfg2)), DEVICE))
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

    # g. run_eval's lookahead: the eval step with no host sync, the device
    # work left at its return, the pass against a sequential one
    more = [f"data.val_scenes={LOOKAHEAD_SCENES}"]
    cfg1 = load_config(CONFIG1, infer.parse_overrides(C1_EVAL_SET + more))
    model1 = TL.eval_model(cfg1, CK.restore(best, TL.init_state(
        cfg1, DEVICE, torch.Generator().manual_seed(seed))))
    cfg2 = load_config(CONFIG2, infer.parse_overrides(C2_SET + C2_EVAL_SET + more))
    rep["lookahead"] = {"config1": lookahead_check(cfg1, model1, "config1"),
                        "config2": lookahead_check(cfg2, TL.eval_model(cfg2, state),
                                                   "config2 (dense-2)")}
    log(f"  {smi}")
    return rep


# --------------------------------------------------------------------------
# phase 10: the data layer (readers, Loader, host voxelizer) and the pooled
# backbone


def write_datasets(root: str) -> dict:
    """Each reader's layout under ``root``, from the port's generator:
    ScanNet (``.npz`` and ``.pth`` scenes of ``SCANNET_POINTS``, 4 train and
    3 val), S3DIS (flat ``Area_1_*``/``Area_5_*`` of ``S3DIS_POINTS``) and
    SemanticKITTI (``velodyne/*.bin`` and ``labels/*.label`` of
    ``KITTI_POINTS`` in sequences 00 and 08, stretched to 100 x 100 x 6 m
    as ``bench.py``'s config-4 scenes). Returns the roots."""
    t0 = time.perf_counter()
    roots = {k: os.path.join(root, k) for k in ("scannet", "s3dis", "semantic_kitti")}

    def labelled(seed, n, **kw):
        s = synthetic.generate_scene(seed, num_points=n, **kw)
        v = s["valid"]
        return s["points"][v], s["feats"][v], s["point_semantic"][v], s["point_instance"][v]

    for split, seeds in (("train", range(4)), ("val", range(4, 7))):
        os.makedirs(os.path.join(roots["scannet"], split))
        for i in seeds:
            arrays = labelled(500 + i, SCANNET_POINTS, num_instances=12, num_classes=18,
                              extent=8.0)
            name = os.path.join(roots["scannet"], split, f"scene{i:04d}_00")
            if i % 2:
                torch.save(arrays, name + ".pth")
            else:
                np.savez(name + ".npz", **dict(zip(("points", "feats", "semantic",
                                                    "instance"), arrays)))
    os.makedirs(roots["s3dis"])
    for area, room, seed in ((1, "office_1", 600), (1, "hallway_2", 601), (5, "office_3", 602)):
        arrays = labelled(seed, S3DIS_POINTS, num_instances=16, num_classes=13, extent=14.0)
        np.savez(os.path.join(roots["s3dis"], f"Area_{area}_{room}.npz"),
                 **dict(zip(("points", "feats", "semantic", "instance"), arrays)))
    for seq, seeds in (("00", (700, 701)), ("08", (702,))):
        vdir = os.path.join(roots["semantic_kitti"], "sequences", seq, "velodyne")
        ldir = os.path.join(roots["semantic_kitti"], "sequences", seq, "labels")
        os.makedirs(vdir)
        os.makedirs(ldir)
        for k, seed in enumerate(seeds):
            s = synthetic.stretch_scene(synthetic.generate_scene(
                seed, num_points=KITTI_POINTS, num_instances=12, num_classes=8,
                num_features=1, extent=8.0), [12.5, 12.5, 0.75])
            v = s["valid"]
            remission = np.clip((s["feats"][v, :1] + 1) / 2, 0, 1)
            np.concatenate([s["points"][v], remission], 1).astype(np.float32).tofile(
                os.path.join(vdir, f"{k:06d}.bin"))
            sem = np.maximum(s["point_semantic"][v], 0).astype(np.uint32)
            inst = (s["point_instance"][v] + 1).astype(np.uint32)       # 0: no instance
            ((inst << 16) | sem).tofile(os.path.join(ldir, f"{k:06d}.label"))
    log(f"  wrote the datasets in {time.perf_counter() - t0:.1f} s: ScanNet 4 + 3 scenes of "
        f"{SCANNET_POINTS} points (.npz and .pth), S3DIS 3 rooms of {S3DIS_POINTS}, "
        f"SemanticKITTI 3 sweeps of {KITTI_POINTS} (100 x 100 x 6 m)")
    return roots


def train_losses(path: str, steps: int, what: str) -> list:
    keys = ("rpn_obj", "rpn_box", "roi_cls", "roi_mask", "semantic", "total", "grad_norm")
    got = [r for r in jsonl(path) if r["kind"] == "train"]
    if len(got) != steps or not all(np.isfinite(r[k]) for r in got for k in keys):
        raise AssertionError(f"{what} logged {got}")
    return [{k: r[k] for k in ("step",) + keys} for r in got]


def form_convs(cfg) -> tuple:
    """Sparse convs of one eval forward (the eval form) and of one train
    step's forward (the train form), and the forward launches of one train
    step: with remat the residual blocks' convs run again in the backward."""
    train = TL.build_model(TL.train_cfg(cfg), "cpu")
    again = sum(isinstance(m, SparseConv) for blk in train.backbone.modules()
                if isinstance(blk, SparseBasicBlock) for m in blk.modules())
    n_train = sparse_convs(train)
    return (sparse_convs(TL.build_model(cfg, "cpu")), n_train,
            n_train + again * cfg.model.backbone.remat)


def host_vs_device_tables(cfg, batch) -> dict:
    """The host voxelizer's tables of ``batch`` against the device's voxelize
    of the same points, on the card: coords, nvalid, p2v and overflow bit
    for bit, feats within ``HOST_VOX_FEATS_TOL``; and the device voxelize's
    warm ms a scene."""
    tb = TL.to_device(batch, DEVICE, TL.TRAIN_KEYS)
    run = lambda _: V.voxelize_batch(tb["points"], tb["feats"], tb["valid"],  # noqa: E731
                                     cfg.data.voxel_size, cfg.data.voxel_capacity)
    with torch.no_grad():
        st, p2v, ovf = run(None)
        for name, a, b in (("coords", tb["voxel_coords"], st.coords),
                           ("nvalid", tb["voxel_nvalid"], st.nvalid),
                           ("p2v", tb["p2v"], p2v), ("overflow", tb["voxel_overflow"], ovf)):
            if not torch.equal(a.to(b.dtype), b):
                raise AssertionError(f"host voxelizer {name} differs from the device's")
        err = (tb["voxel_feats"] - st.feats).abs().max().item()
        if not torch.allclose(tb["voxel_feats"], st.feats, rtol=HOST_VOX_FEATS_TOL,
                              atol=HOST_VOX_FEATS_TOL):
            raise AssertionError(f"host voxel feats differ from the device's by {err}")
        dev_ms = timed_steps(run, [None], reps=5)["median"] / len(batch["points"])
    host_ms = []
    for b in range(len(batch["points"])):
        args = (batch["points"][b], batch["feats"][b], batch["valid"][b].astype(np.uint8),
                np.asarray(cfg.data.voxel_size, np.float32), cfg.data.voxel_capacity)
        for r in range(4):
            t0 = time.perf_counter()
            native.voxelize_scene(*args)
            if r:
                host_ms.append((time.perf_counter() - t0) * 1e3)
    rec = {"voxels": st.nvalid.tolist(), "overflow": ovf.tolist(), "feats_max_abs_diff": err,
           "device_voxelize_ms_per_scene": dev_ms,
           "host_voxelize_ms_per_scene_one_thread": statistics.median(host_ms)}
    log(f"  host voxelizer vs the device's voxelize on one val batch: coords, nvalid, p2v, "
        f"overflow bit for bit, feats max |diff| {err:.3e} (tolerance "
        f"{HOST_VOX_FEATS_TOL}); voxels {rec['voxels']}; ms a scene: device "
        f"{dev_ms:.3f} (warm, card), host C++ {rec['host_voxelize_ms_per_scene_one_thread']:.3f}"
        " (one thread, median of 3 per scene)")
    return rec


def fed_steps(cfg, init, stream, steps: int) -> dict:
    """``steps`` train steps, each on the next ``(host, device)`` batch of
    ``stream``, after a warm one: wall per step on the host clock (ending
    in a synchronise), then as many again under ``torch.profiler`` for the
    device's busy time (the union of its kernel and copy intervals). The
    idle share is 1 - busy / unprofiled wall (as ``PERF.md`` §5 reads it;
    the profiler's own cost inflates its window's wall, whose share is
    ``idle_share_profiled_window``)."""
    state = TL.init_state(cfg, model=copy.deepcopy(init))
    TL.train_step(cfg, state, next(stream)[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        TL.train_step(cfg, state, next(stream)[1])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            TL.train_step(cfg, state, next(stream)[1])
        torch.cuda.synchronize()
    pwall = (time.perf_counter() - t0) * 1e3 / steps
    device = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not device:
        raise AssertionError("the profiler recorded no device events")
    busy = PROF.union_us(device) / 1e3 / steps
    return {"wall_ms_per_step": wall, "profiled_wall_ms_per_step": pwall,
            "busy_ms_per_step": busy, "idle_share": 1 - busy / wall,
            "idle_share_profiled_window": 1 - busy / pwall}


def loader_vs_sync(cfg, sync_cfg, init) -> dict:
    """Config 2's train step fed by the threaded, host-voxelizing Loader
    (pinned copies) against the synchronous single-worker stream (device
    voxelize, copies from pageable memory), in turns: sync, Loader,
    resident, Loader, sync. ``resident``: the sync stream's batches copied
    to the card before the steps, so no host work runs between them."""
    runs = {"loader": [], "sync": [], "resident": []}
    for kind in ("sync", "loader", "resident", "loader", "sync"):
        if kind == "resident":
            src = Loader(sync_cfg, seed=cfg.train.seed, threads=False)
            staged = [TL.to_device(next(src), DEVICE, TL.TRAIN_KEYS)
                      for _ in range(1 + 2 * FED_STEPS)]
            rec = fed_steps(sync_cfg, init, ((None, b) for b in staged), FED_STEPS)
            rec["wait_s_per_batch"], rec["batches_out"] = 0.0, len(staged)
            del staged
        elif kind == "loader":
            with Loader(cfg, seed=cfg.train.seed) as loader:
                rec = fed_steps(cfg, init, device_batches(loader, DEVICE, TL.TRAIN_KEYS),
                                FED_STEPS)
                rec["wait_s_per_batch"] = loader.wait_s / loader.batches_out
                rec["batches_out"] = loader.batches_out
        else:
            sync = Loader(sync_cfg, seed=cfg.train.seed, threads=False)
            rec = fed_steps(sync_cfg, init, ((h, TL.to_device(h, DEVICE, TL.TRAIN_KEYS))
                                             for h in sync), FED_STEPS)
            rec["wait_s_per_batch"] = sync.wait_s / sync.batches_out
            rec["batches_out"] = sync.batches_out
        runs[kind].append(rec)
        log(f"  config-2 train step fed by the {kind:6s}: " + json.dumps(
            {k: round(v, 4) if isinstance(v, float) else v for k, v in rec.items()}))
    return runs


def pool_kernels(cfg, model, batch, n_fwd: int) -> dict:
    """The kernels against their plain versions, timed, on the inputs that
    one config1_pool_dropout eval forward and one train step (dropout on)
    give them."""
    calls = capture(lambda: run_scene(cfg, model, batch, DEVICE), "conv_forward")
    if len(calls) != n_fwd:
        raise AssertionError(f"{len(calls)} forward convs in one pooled forward, not {n_fwd}")
    log(f"  kernels vs plain versions on the inputs of the pooled path ({n_fwd} forward "
        "convs of one eval forward, the dgrads and wgrads of one train step; tolerances "
        "as in phase 3)")
    fwd = [measure_conv(f"K{w.shape[0]} {w.shape[1]}->{w.shape[2]}", f, i, w,
                        reps=QUICK_REPS) for f, i, w in calls]
    tb = TL.to_device(batch, DEVICE, TL.TRAIN_KEYS)
    gen = TL.dropout_generators(cfg, 0, DEVICE, range(tb["points"].shape[0]))
    dg, wg = capture(lambda: TL.loss_and_grads(cfg, copy.deepcopy(model), tb, gen),
                     "conv_dgrad", "conv_wgrad")
    if (len(dg), len(wg)) != (n_fwd - 1, n_fwd):
        raise AssertionError(f"{len(dg)} dgrad and {len(wg)} wgrad calls in one pooled step")
    d = [measure_dgrad(f"K{w.shape[0]} {w.shape[1]}->{w.shape[2]}", g, t, w, reps=QUICK_REPS)
         for g, t, w in dg]
    w_ = [measure_wgrad(f"K{t.shape[1]} {f.shape[2]}->{g.shape[2]}", f, t, g, reps=QUICK_REPS)
          for f, t, g in wg]
    require_ok(fwd + d + w_, "pooled path, main-path inputs")
    return {"forward": fwd, "dgrad": d, "wgrad": w_}


def reader_config(name, path, sets, out_dir, tmp_dir, rep) -> dict:
    """``infer.main`` on one batch and ``train.main`` for 2 steps of a
    reader-fed config at full width; then warm ms a scene of the eval step
    and a train step on the reader's batches, and peak memory."""
    ck = os.path.join(tmp_dir, f"ckpt_{name}")
    sets = sets + [f"train.checkpoint_dir={ck}", "train.log_every=1"]
    cfg = load_config(path, infer.parse_overrides(sets))
    n_eval, n_train, n_fwd = form_convs(cfg)
    args = sum((["--set", x] for x in sets), ["--config", path])
    bs = cfg.data.batch_size
    inf_dir = os.path.join(out_dir, f"infer_{name}")
    _, got = run_cli(infer.main, args + ["--num-scenes", str(bs), "--out-dir", inf_dir,
                                         "--device", DEVICE], f"{name} infer.main")
    expect(got, want_launches(n_eval), f"{name} infer.main launches")
    rep["launches"][f"{name} infer.main (1 batch)"] = got
    for i in range(bs):
        with np.load(os.path.join(inf_dir, f"scene{i:04d}.npz")) as f:
            if f["instance"].shape != (f["points"].shape[0],) or not np.isfinite(f["scores"]).all():
                raise AssertionError(f"{name} infer scene{i:04d}.npz malformed")
    log_path = os.path.join(out_dir, f"train_log_{name}.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    torch.cuda.reset_peak_memory_stats()
    state, got = run_cli(train_cli.main, args + ["--set", "train.total_steps=2", "--device",
                                                 DEVICE, "--log-file", log_path],
                         f"{name} train.main, 2 steps")
    expect(got, want_launches(2 * n_fwd, 2 * (n_train - 1), 2 * n_train, 2 * bs, steps=2),
           f"{name} train.main launches")
    rep["launches"][f"{name} train.main (2 steps)"] = got
    out = {"convs": {"eval": n_eval, "train": n_train, "train_forward_launches": n_fwd},
           "losses": train_losses(log_path, 2, f"{name} train.main"),
           "train_peak_bytes": torch.cuda.max_memory_allocated()}
    ev = TL.eval_model(cfg, state)
    val = TL.to_device(next(val_batches(cfg)), DEVICE)
    torch.cuda.reset_peak_memory_stats()
    out["eval_ms_per_scene"] = timed_steps(lambda b: TL.eval_step(cfg, ev, b), [val],
                                           reps=3)["median"] / bs
    out["eval_peak_bytes"] = torch.cuda.max_memory_allocated()
    del ev, val
    trb = TL.to_device(next(Loader(cfg, seed=cfg.train.seed, threads=False)), DEVICE,
                       TL.TRAIN_KEYS)
    out["train_ms_per_step"] = timed_steps(lambda b: TL.train_step(cfg, state, b), [trb],
                                           reps=2)["median"]
    log(f"  {name}: {json.dumps({k: v for k, v in out.items() if k != 'losses'})}; losses "
        + json.dumps([{k: round(v, 4) for k, v in r.items()} for r in out["losses"]]))
    return out


def phase_data_layer(out_dir: str, tmp_dir: str, smi: str, c2_convs) -> dict:
    """``tmp_dir`` takes the datasets and the checkpoints; ``c2_convs``:
    config 2's sparse convs in the eval and the train form (phase 8)."""
    log("[phase 10] the data layer (readers, the threaded Loader with pinned copies, the "
        "C++ host voxelizer) and the pooled backbone, at full width")
    t0 = time.perf_counter()
    native.load()
    log(f"  built {os.path.relpath(str(native.build()), ROOT)} "
        f"({time.perf_counter() - t0:.1f} s with the load)")
    roots = write_datasets(os.path.join(tmp_dir, "data"))
    rep = {"launches": {}, "card": smi}

    # b. config 2 through the ScanNet reader, the threaded host-voxelizing Loader
    ck2 = os.path.join(tmp_dir, "ckpt_config2_scannet")
    sets = C2_DATA_SET + [f"data.data_root={roots['scannet']}"] + C2_LOADER_SET + [
        f"data.val_scenes={EVAL_SCENES}", "train.eval_every=3", "train.checkpoint_every=3",
        f"train.eval_scenes={EVAL_SCENES}", "train.log_every=1", f"train.checkpoint_dir={ck2}"]
    cfg = load_config(CONFIG2, infer.parse_overrides(sets))
    d = cfg.data
    if (d.dataset, d.num_workers, d.prefetch, d.host_voxelize) != ("scannet", 4, 3, True):
        raise AssertionError(f"config 2 data settings {d}")
    n_eval, n_train = c2_convs
    args = sum((["--set", x] for x in sets), ["--config", CONFIG2])
    log_path = os.path.join(out_dir, "train_log_config2_scannet.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    _, got = run_cli(train_cli.main, args + ["--set", "train.total_steps=3", "--device", DEVICE,
                                             "--log-file", log_path],
                     "config2 (ScanNet reader, Loader) train.main, 3 steps")
    evals_fwd = -(-EVAL_SCENES // d.batch_size)
    expect(got, want_launches(3 * n_train + evals_fwd * n_eval, 3 * (n_train - 1), 3 * n_train,
                              3 * d.batch_size, steps=3), "config2 ScanNet train.main launches")
    rep["launches"]["config2 scannet train.main (3 steps, 1 eval)"] = got
    rep["config2_losses"] = train_losses(log_path, 3, "config2 ScanNet train.main")
    loader_line = [r for r in jsonl(log_path) if r["kind"] == "loader"]
    if len(loader_line) != 1 or loader_line[0]["batches_out"] < 3 or \
            loader_line[0]["scenes_voxelized"] < 3 * d.batch_size:
        raise AssertionError(f"config2 ScanNet train.main loader line {loader_line}")
    rep["train_main_loader"] = {k: loader_line[0][k] for k in (
        "wait_s", "batches_out", "voxelize_s", "scenes_voxelized")}
    log("  train.main's Loader: " + json.dumps(rep["train_main_loader"]) + "; losses "
        + json.dumps([{k: round(v, 4) for k, v in r.items()} for r in rep["config2_losses"]]))
    res, got = run_cli(eval_cli.main, args + ["--best", "--device", DEVICE],
                       "config2 (ScanNet reader) eval.main --best")
    expect(got, want_launches(evals_fwd * n_eval), "config2 ScanNet eval.main launches")
    rep["launches"]["config2 scannet eval.main --best (3 scenes)"] = got
    if res["scenes"] != EVAL_SCENES:
        raise AssertionError(f"config2 ScanNet eval.main scored {res['scenes']} scenes")
    rep["config2_eval"] = {k: res[k] for k in res if k.startswith(("mAP", "eval_", "scenes"))}

    with Loader(cfg, "val", train=False) as loader:
        batch = next(loader)
    rep["host_vs_device_tables"] = host_vs_device_tables(cfg, batch)
    rep["host_voxelize_ms_per_scene_in_workers"] = (
        1e3 * rep["train_main_loader"]["voxelize_s"] / rep["train_main_loader"]["scenes_voxelized"])

    # the host-voxelized train step against the device-voxelized one, f32
    f32 = load_config(CONFIG2, infer.parse_overrides(sets + ["model.backbone.dtype=float32"]))
    init = TL.build_model(TL.train_cfg(f32), DEVICE, torch.Generator().manual_seed(f32.train.seed))
    with Loader(f32, seed=f32.train.seed) as loader:
        hb = next(loader)
    metrics = {}
    for form, b in (("host", hb), ("device", {k: v for k, v in hb.items()
                                              if k not in VOXEL_KEYS})):
        state = TL.init_state(f32, model=copy.deepcopy(init))
        _, m = TL.train_step(f32, state, TL.to_device(b, DEVICE, TL.TRAIN_KEYS))
        metrics[form] = {k: float(v) for k, v in m.items()}
        del state
    rel = {k: abs(metrics["host"][k] - metrics["device"][k]) / max(abs(metrics["device"][k]),
                                                                     1e-30)
           for k in metrics["device"]}
    log(f"  one f32 train step, host-voxelized vs device-voxelized batch: largest relative "
        f"difference {max(rel.values()):.3e} ({max(rel, key=rel.get)}; tolerance "
        f"{HOST_STEP_RTOL}); total {metrics['host']['total']!r} vs "
        f"{metrics['device']['total']!r}")
    if max(rel.values()) > HOST_STEP_RTOL:
        raise AssertionError(f"host- and device-voxelized steps differ: {rel}")
    rep["host_vs_device_step_rel"] = rel
    del init

    # the train step fed by the Loader against the synchronous stream
    init = TL.build_model(TL.train_cfg(cfg), DEVICE, torch.Generator().manual_seed(cfg.train.seed))
    sync_cfg = load_config(CONFIG2, infer.parse_overrides(
        sets + ["data.host_voxelize=False", "data.num_workers=1"]))
    rep["loader_vs_sync"] = loader_vs_sync(cfg, sync_cfg, init)
    del init
    torch.cuda.empty_cache()

    # c. config 3 through the S3DIS reader, config 4 through the KITTI reader
    rep["config3"] = reader_config("config3", CONFIG3, C3_SET + [
        f"data.data_root={roots['s3dis']}"], out_dir, tmp_dir, rep)
    torch.cuda.empty_cache()
    rep["config4"] = reader_config("config4", CONFIG4, C4_SET + [
        f"data.data_root={roots['semantic_kitti']}"], out_dir, tmp_dir, rep)
    torch.cuda.empty_cache()

    # d. config1_pool_dropout: infer, train twice (bit-equal), card vs CPU
    cfg = load_config(CONFIG_POOL, infer.parse_overrides(POOL_SET))
    n_fwd = form_convs(cfg)[0]
    pool_sets = POOL_SET + ["train.log_every=1"]
    inf_dir = os.path.join(out_dir, "infer_pool")
    base = sum((["--set", x] for x in pool_sets), ["--config", CONFIG_POOL])
    _, got = run_cli(infer.main, base + ["--set", f"train.checkpoint_dir={tmp_dir}/none",
                                         "--num-scenes", "3", "--out-dir", inf_dir,
                                         "--device", DEVICE], "pool_dropout infer.main")
    forwards = -(-3 // cfg.data.batch_size)
    expect(got, want_launches(forwards * n_fwd), "pool_dropout infer.main launches")
    rep["launches"]["pool_dropout infer.main (3 scenes)"] = got
    states, losses = [], []
    for run in (1, 2):
        log_path = os.path.join(out_dir, f"train_log_pool_{run}.jsonl")
        if os.path.exists(log_path):
            os.remove(log_path)
        torch.cuda.reset_peak_memory_stats()
        st, got = run_cli(train_cli.main, base + [
            "--set", f"train.total_steps={POOL_TRAIN_STEPS}",
            "--set", f"train.checkpoint_dir={os.path.join(tmp_dir, f'ckpt_pool_{run}')}",
            "--device", DEVICE, "--log-file", log_path], f"pool_dropout train.main, run {run}")
        expect(got, want_launches(POOL_TRAIN_STEPS * n_fwd, POOL_TRAIN_STEPS * (n_fwd - 1),
                                  POOL_TRAIN_STEPS * n_fwd,
                                  POOL_TRAIN_STEPS * cfg.data.batch_size,
                                  steps=POOL_TRAIN_STEPS),
               "pool_dropout train.main launches")
        rep["launches"][f"pool_dropout train.main ({POOL_TRAIN_STEPS} steps, run {run})"] = got
        states.append(st)
        losses.append(train_losses(log_path, POOL_TRAIN_STEPS, "pool_dropout train.main"))
    rep["pool_train_peak_bytes"] = torch.cuda.max_memory_allocated()
    n_t = require_equal_states(states[0], states[1], "pool_dropout, two train.main runs")
    if [{k: v for k, v in r.items()} for r in losses[0]] != losses[1]:
        raise AssertionError(f"pool_dropout losses differ run to run: {losses}")
    rep["pool_losses"] = losses[0]
    log(f"  pool_dropout: two train.main runs of {POOL_TRAIN_STEPS} steps bit-equal ({n_t} "
        "tensors, torch.equal; losses equal); losses "
        + json.dumps([{k: round(v, 5) for k, v in r.items()} for r in losses[0]]))
    seed = cfg.train.seed
    m_gpu = TL.build_model(cfg, DEVICE, torch.Generator().manual_seed(seed))
    m_cpu = TL.build_model(cfg, "cpu", torch.Generator().manual_seed(seed))
    batches = list(itertools.islice(val_batches(cfg), 3))
    worst = card_vs_cpu(cfg, m_gpu, m_cpu, batches, n_fwd)
    rep["pool_card_vs_cpu"] = worst
    log(f"  pool_dropout eval step, card vs CPU max abs diff: {json.dumps(worst)} "
        "(tolerances as in phase 4; dropout inert)")
    rep["pool_main_path"] = pool_kernels(cfg, m_gpu, batches[0], n_fwd)
    tb = [TL.to_device(b, DEVICE) for b in batches]
    torch.cuda.reset_peak_memory_stats()
    rep["pool_eval_ms_per_scene"] = timed_steps(lambda b: TL.eval_step(cfg, m_gpu, b), tb,
                                                reps=3)["median"] / cfg.data.batch_size
    rep["pool_eval_peak_bytes"] = torch.cuda.max_memory_allocated()
    with Loader(cfg, seed=seed, threads=False) as loader:
        trb = [TL.to_device(next(loader), DEVICE, TL.TRAIN_KEYS) for _ in range(2)]
    state = TL.init_state(cfg, model=m_gpu)
    torch.cuda.reset_peak_memory_stats()
    rep["pool_train_ms_per_step"] = timed_steps(lambda b: TL.train_step(cfg, state, b), trb,
                                                reps=2)["median"]
    rep["pool_train_step_peak_bytes"] = torch.cuda.max_memory_allocated()
    rep["convs"] = {"pool_dropout": n_fwd, "config3": rep["config3"]["convs"],
                    "config4": rep["config4"]["convs"]}
    summary = {
        "card": smi,
        "loader_wait_s_per_batch": {k: [r["wait_s_per_batch"] for r in v]
                                    for k, v in rep["loader_vs_sync"].items()
                                    if k != "resident"},
        "train_main_loader": rep["train_main_loader"],
        "host_voxelize_ms_per_scene": {
            "cxx_in_workers": rep["host_voxelize_ms_per_scene_in_workers"],
            "cxx_one_thread": rep["host_vs_device_tables"]["host_voxelize_ms_per_scene_one_thread"],
            "device_voxelize_batch": rep["host_vs_device_tables"]["device_voxelize_ms_per_scene"]},
        "config2_train_step": {k: [{m: r[m] for m in ("wall_ms_per_step", "busy_ms_per_step",
                                                      "idle_share", "idle_share_profiled_window")}
                                   for r in v] for k, v in rep["loader_vs_sync"].items()},
        "eval_ms_per_scene": {"config3": rep["config3"]["eval_ms_per_scene"],
                              "config4": rep["config4"]["eval_ms_per_scene"],
                              "pool_dropout": rep["pool_eval_ms_per_scene"]},
        "train_ms_per_step": {"config3": rep["config3"]["train_ms_per_step"],
                              "config4": rep["config4"]["train_ms_per_step"],
                              "pool_dropout": rep["pool_train_ms_per_step"]},
        "peak_bytes": {"config3": [rep["config3"]["eval_peak_bytes"],
                                   rep["config3"]["train_peak_bytes"]],
                       "config4": [rep["config4"]["eval_peak_bytes"],
                                   rep["config4"]["train_peak_bytes"]],
                       "pool_dropout": [rep["pool_eval_peak_bytes"],
                                         rep["pool_train_step_peak_bytes"]]},
    }
    rep["summary"] = summary
    log(f"  {smi}")
    return rep


# --------------------------------------------------------------------------
# phase 11: data parallel (config 5's path), in launcher-started ranks


def scannet_root(tmp_dir: str) -> str:
    """The ScanNet files of phase 10 (written here when phase 11 runs alone)."""
    root = os.path.join(tmp_dir, "data", "scannet")
    if not os.path.isdir(root):
        write_datasets(os.path.join(tmp_dir, "data"))
    return root


def c5_config(tmp_dir: str, world: int, extra=()) -> tuple:
    """Config 5 at full width through the ScanNet reader, cut to ``world``
    ranks on one card: (config, its ``--set`` list)."""
    sets = C5_SET + [f"data.data_root={scannet_root(tmp_dir)}", f"data.batch_size={world}",
                     f"parallel.num_devices={world}", f"data.val_scenes={EVAL_SCENES}",
                     f"train.eval_scenes={EVAL_SCENES}", *extra]
    return load_config(CONFIG5, infer.parse_overrides(sets)), sets


def digests(state) -> dict:
    """A hash of the bytes of every tensor of a train state, by name."""
    import hashlib

    return {k: hashlib.sha1(v.detach().reshape(-1).contiguous().view(torch.uint8).cpu()
                            .numpy().tobytes()).hexdigest()
            for k, v in state_tensors(state).items()}


def dp_step_record(world, cfg, init, batch) -> tuple:
    """One data-parallel step from ``init``: (state, metrics, its launches,
    its all-reduces and their bytes)."""
    state = TL.init_state(cfg, model=copy.deepcopy(init))
    step = DP.make_parallel_train_step(cfg, world)
    torch.cuda.synchronize()
    before = dict(NL.LAUNCHES)
    DPC.STATS.calls = DPC.STATS.bytes = 0
    _, m = step(state, batch)
    torch.cuda.synchronize()
    return state, m, launched(before), (DPC.STATS.calls, DPC.STATS.bytes)


def state_errors(got, want) -> dict:
    """Largest |got - want| beyond rtol 1e-4 · |want| (``assert_allclose``'s
    form, as a number: within the tolerance when at most 1e-5) over the
    parameters and BN statistics; and the largest error of the Adam first
    moments (0.1 × the gradient) relative to each tensor's largest entry,
    with the five worst tensors: [name, error, largest |gradient|], and
    relative to the largest entry of all."""
    ga, wa = state_tensors(got), state_tensors(want)
    model = max(float(((ga[k] - v).abs() - DP_PARAMS_RTOL * v.abs()).max())
                for k, v in wa.items() if k.startswith("model."))
    mu = {k: v for k, v in wa.items() if k.startswith("mu.")}
    rel = {k: float((ga[k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
           for k, v in mu.items()}
    top = max(float(v.abs().max()) for v in mu.values())
    names = [n for n, _ in got.model.named_parameters()]
    worst = sorted(rel, key=rel.get, reverse=True)[:5]
    return {"params_bn_excess_abs": model, "grads_rel_max": rel[worst[0]],
            "grads_rel_to_largest_of_all": max(float((ga[k] - v).abs().max())
                                               for k, v in mu.items()) / top,
            "grads_worst": [[names[int(k[3:])], rel[k], float(wa[k].abs().max()) / 0.1]
                            for k in worst]}


def dp_world1(out_dir: str, tmp_dir: str) -> dict:
    """Rank 0 of a world of 1 on NCCL: ``train.main`` (3 steps, an eval and
    a checkpoint at step 3), then one data-parallel step bit-equal to
    ``TL.train_step`` from the same state on the same batch, and both
    timed."""
    device = torch.device(DEVICE)
    world = DP.init("nccl", device)
    ck = os.path.join(tmp_dir, "ckpt_config5_dp1")
    cfg, sets = c5_config(tmp_dir, 1, ["train.log_every=1", f"train.eval_every={DP_STEPS}",
                                       f"train.checkpoint_every={DP_STEPS}",
                                       f"train.checkpoint_dir={ck}"])
    n_eval, n_train, n_fwd = form_convs(cfg)
    log_path = os.path.join(out_dir, "train_log_config5_dp1.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    args = sum((["--set", x] for x in sets), ["--config", CONFIG5])
    _, got = run_cli(train_cli.main, args + [
        "--set", f"train.total_steps={DP_STEPS}", "--device", DEVICE, "--dist-backend", "nccl",
        "--log-file", log_path], f"config5 world 1 (NCCL) train.main, {DP_STEPS} steps")
    expect(got, want_launches(DP_STEPS * n_fwd + EVAL_SCENES * n_eval, DP_STEPS * (n_train - 1),
                              DP_STEPS * n_train, DP_STEPS * cfg.data.batch_size,
                              steps=DP_STEPS),
           "config5 world-1 train.main launches")
    lines = jsonl(log_path)
    head = lines[0]
    evals = [r for r in lines if r["kind"] == "eval"]
    if (head.get("world_size"), head.get("backend")) != (1, world.backend) or \
            [r["scenes"] for r in evals] != [EVAL_SCENES] or \
            CK.make_manager(ck).all_steps() != [DP_STEPS]:
        raise AssertionError(f"config5 world-1 train.main: {head}, {evals}, "
                             f"{CK.make_manager(ck).all_steps()}")
    rec = {"train_main_launches": got,
           "losses": train_losses(log_path, DP_STEPS, "config5 world-1 train.main"),
           "eval": {k: evals[0][k] for k in evals[0] if k.startswith(("mAP", "scenes"))}}

    init = TL.build_model(TL.train_cfg(cfg), device,
                          torch.Generator().manual_seed(cfg.train.seed))
    with Loader(cfg, seed=cfg.train.seed, threads=False, rank=0, world=1) as loader:
        batches = [TL.to_device(next(loader), device, TL.TRAIN_KEYS) for _ in range(3)]
    a, ma, launches, (calls, nbytes) = dp_step_record(world, cfg, init, batches[0])
    b = TL.init_state(cfg, model=copy.deepcopy(init))
    _, mb = TL.train_step(cfg, b, batches[0])
    n = require_equal_states(a, b, "config5 world-1 DP step against TL.train_step")
    if sorted(ma) != sorted(mb) or not all(torch.equal(ma[k], mb[k]) for k in mb):
        raise AssertionError(f"config5 world-1 DP metrics {ma} against {mb}")
    expect(launches, want_launches(n_fwd, n_train - 1, n_train, cfg.data.batch_size, steps=1),
           "config5 world-1 DP step launches")
    n_params = sum(p.numel() for p in a.model.parameters())
    step = DP.make_parallel_train_step(cfg, world)
    rec.update({
        "step_launches": launches, "bit_equal_tensors": n, "all_reduces_per_step": calls,
        "bytes_all_reduced_per_step": nbytes, "gradient_bytes": 4 * n_params,
        "dp_step_ms": timed_steps(lambda x: step(a, x), batches[1:], DP_TIMED // 2),
        "single_step_ms": timed_steps(lambda x: TL.train_step(cfg, b, x), batches[1:],
                                      DP_TIMED // 2)})
    return rec


def dp_world2(out_dir: str, tmp_dir: str) -> dict:
    """A rank of a world of 2 on one card over gloo, global batch 2 (one
    scene a rank, config 5's share of a chip): an f32 and a bf16 DP step
    against ``TL.train_step`` on the global batch (on rank 0), the ranks'
    states bit-equal; the in-training eval against one process's
    ``run_eval`` and the packed masks of a val batch against
    ``TL.eval_step``'s; the DP step timed."""
    device = torch.device(DEVICE)
    world = DP.init("gloo", device)
    lead = world.rank == 0
    rec = {"rank": world.rank}
    for dtype in ("float32", "bfloat16"):
        cfg, _ = c5_config(tmp_dir, 2, [f"model.backbone.dtype={dtype}"] + C5_WORLD2_SET)
        n_eval, n_train, n_fwd = form_convs(cfg)
        init = TL.build_model(TL.train_cfg(cfg), device,
                              torch.Generator().manual_seed(cfg.train.seed))
        with Loader(cfg, seed=cfg.train.seed, threads=False, rank=world.rank,
                    world=2) as loader:
            share = TL.to_device(next(loader), device, TL.TRAIN_KEYS)
        state, m, launches, (calls, nbytes) = dp_step_record(world, cfg, init, share)
        expect(launches, want_launches(n_fwd, n_train - 1, n_train, 1, steps=1),  # a scene a rank
               f"config5 world-2 {dtype} DP launches")
        ranks = DP.gather_to_rank0(digests(state), world)
        r = {"launches": launches, "all_reduces": calls, "bytes_all_reduced": nbytes,
             "metrics": {k: float(v) for k, v in m.items()}}
        if lead:
            differ = sorted(k for k in ranks[0] if ranks[0][k] != ranks[1][k])
            if differ or sorted(ranks[0]) != sorted(ranks[1]):
                raise AssertionError(f"{dtype}: the ranks' states differ: {differ[:8]}")
            r["ranks_bit_equal_tensors"] = len(ranks[0])
            with Loader(cfg, seed=cfg.train.seed, threads=False) as loader:
                whole = TL.to_device(next(loader), device, TL.TRAIN_KEYS)
            ref = TL.init_state(cfg, model=copy.deepcopy(init))
            _, mr = TL.train_step(cfg, ref, whole)
            del whole
            loss_rel = {k: abs(float(m[k]) - float(mr[k])) / max(abs(float(mr[k])), 1e-30)
                        for k in ("rpn_obj", "rpn_box", "roi_cls", "roi_mask", "semantic",
                                  "total", "grad_norm")}
            err = state_errors(state, ref)
            r.update({"loss_rel": loss_rel, **err})
            tol = DP_TOL[dtype]
            if max(loss_rel.values()) > tol["loss_rtol"] or \
                    err["params_bn_excess_abs"] > tol["params_atol"] or \
                    err["grads_rel_max"] > tol["grads_rel"]:
                raise AssertionError(f"{dtype}: 2 ranks against one process: {r}, "
                                     f"tolerance {tol}")
            del ref
        DP.barrier(world)
        rec[dtype] = r
        if dtype == "float32":
            del state, init
            torch.cuda.empty_cache()
            continue

        # the in-training eval, and the packed masks of one val batch
        before = dict(NL.LAUNCHES)
        res = train_cli.evaluate(cfg, state, JsonlLogger(enabled=False), world)
        torch.cuda.synchronize()
        rec["eval_launches"] = launched(before)
        evals_fwd = -(-EVAL_SCENES // 2)
        expect(rec["eval_launches"], want_launches(evals_fwd * n_eval),
               "config5 world-2 eval launches")
        with Loader(cfg, "val", train=False, rank=world.rank, world=2) as loader:
            vb = TL.to_device(next(loader), device)
        bits = DP.make_parallel_eval_step(cfg, world)(state, vb)["point_mask_bits"].cpu().numpy()
        gathered = DP.gather_to_rank0(bits, world)
        if lead:
            # one process on the global batch: the same computation, bit for
            # bit (the dense tail convolves one scene at a time)
            with Loader(cfg, "val", train=False) as loader:
                whole = TL.to_device(next(loader), device)
            got = np.concatenate(gathered)
            two = TL.eval_step(cfg, state, whole)["point_mask_bits"].cpu().numpy()
            if not np.array_equal(got, two):
                raise AssertionError(
                    f"config5 world-2 packed masks differ from one process's at the global "
                    f"batch in {int(np.unpackbits(got ^ two).sum())} of {got.size * 8} bits")
            single = train_cli.evaluate(cfg, state, JsonlLogger(enabled=False))
            maps = {k: (res[k], single[k]) for k in single if k.startswith(("mAP", "scenes",
                                                                             "semantic"))}
            if any(a != b for a, b in maps.values()):
                raise AssertionError(f"config5 world-2 eval against one process: {maps}")
            rec["eval_vs_one_process"] = maps
            rec["packed_mask_bytes_equal"] = int(got.nbytes)
        DP.barrier(world)
        with Loader(cfg, seed=cfg.train.seed, threads=False, rank=world.rank,
                    world=2) as loader:
            more = [TL.to_device(next(loader), device, TL.TRAIN_KEYS) for _ in range(2)]
            # the other rank's scene of each batch: read and augmented, not voxelized
            rec["loader_ms_per_scene"] = {
                "replayed": 1e3 * loader.replay_s / loader.scenes_replayed,
                "voxelized_own": 1e3 * loader.voxelize_s / loader.scenes_voxelized}
        step = DP.make_parallel_train_step(cfg, world)
        rec["dp_step_ms"] = timed_steps(lambda x: step(state, x), more, DP_TIMED // 2)
        n = sum(p.numel() for p in state.model.parameters())
        widest = max(cfg.model.backbone.widths)
        rec["gloo_all_reduce_ms"] = {
            "gradients": collective_ms(world, torch.zeros(n, device=device), 5),
            "bn_sums": collective_ms(world, torch.zeros(widest + 1, device=device), 50)}
    return rec


def collective_ms(world, t, reps: int) -> float:
    """Median host ms of one all-reduce of ``t`` among the ranks, from a
    synchronised card to a synchronised card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        DPC.all_reduce_(t, world)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dp_worker(mode: str, out_dir: str, tmp_dir: str) -> int:
    """The body of each rank of ``phase_data_parallel``'s launcher calls:
    writes its record to ``dp_<mode>_rank<r>.json`` in ``out_dir``."""
    infer.setup_device(DEVICE, deterministic=True)
    rec = (dp_world1 if mode == "world1" else dp_world2)(out_dir, tmp_dir)
    rank = int(os.environ["RANK"])
    with open(os.path.join(out_dir, f"dp_{mode}_rank{rank}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    torch.distributed.destroy_process_group()
    return 0


def launch_ranks(mode: str, nproc: int, out_dir: str, tmp_dir: str) -> list:
    """``python -m torch.distributed.run --standalone`` with ``nproc`` ranks
    of :func:`dp_worker` in a session of its own, killed whole if it
    outlives ``DP_TIMEOUT_S``; its output goes to ``dp_<mode>.log``. A rank
    that fails fails the phase. Returns the ranks' records."""
    for r in range(nproc):
        stale = os.path.join(out_dir, f"dp_{mode}_rank{r}.json")
        if os.path.exists(stale):
            os.remove(stale)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), os.path.abspath(__file__), "--dp-worker", mode,
           "--out-dir", out_dir, "--tmp-dir", tmp_dir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=DP_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out = proc.communicate()[0] + f"\n(killed after {DP_TIMEOUT_S} s)"
    with open(os.path.join(out_dir, f"dp_{mode}.log"), "w") as f:
        f.write(out)
    if proc.returncode != 0:
        raise AssertionError(f"data-parallel {mode} ranks exited {proc.returncode}:\n"
                             f"{out[-6000:]}")
    log(f"  {mode}: {nproc} rank(s) done in {time.perf_counter() - t0:.1f} s (launcher "
        "start included)")
    recs = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"dp_{mode}_rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def phase_data_parallel(out_dir: str, tmp_dir: str, smi: str) -> dict:
    """Config 5's path (widths 32-160, bf16, dense tail 2 for eval and 3 for
    train, 262144 points, host voxelize, the ScanNet reader) data-parallel,
    cut to one card: (a) a world of 1 on NCCL, (b) a world of 2 on gloo
    sharing the card (NCCL refuses two ranks on one GPU)."""
    log("[phase 11] data parallel: config 5's path, cut to one card: (a) world 1 on NCCL, "
        "global batch 1 (train.main 3 steps, an eval of 3 val scenes, a checkpoint; a DP "
        "step against TL.train_step); (b) world 2 on gloo on the same card, global batch 2, "
        f"one scene a rank, data.num_workers 4 a rank (8 in the config); steps "
        f"{DP_STEPS} (60000), val scenes {EVAL_SCENES}")
    out_dir, tmp_dir = os.path.abspath(out_dir), os.path.abspath(tmp_dir)
    os.makedirs(out_dir, exist_ok=True)
    scannet_root(tmp_dir)
    torch.cuda.empty_cache()
    (w1,) = launch_ranks("world1", 1, out_dir, tmp_dir)
    log(f"  (a) world 1, NCCL: train.main launches {w1['train_main_launches']}; a DP step "
        f"bit-equal to TL.train_step ({w1['bit_equal_tensors']} tensors and every metric, "
        f"torch.equal), {w1['all_reduces_per_step']} all-reduces of "
        f"{w1['bytes_all_reduced_per_step']} B a step (gradients {w1['gradient_bytes']} B); "
        f"ms a step DP {json.dumps(w1['dp_step_ms'])}, single {json.dumps(w1['single_step_ms'])}")
    w2 = launch_ranks("world2", 2, out_dir, tmp_dir)
    lead = w2[0]
    for dtype in ("float32", "bfloat16"):
        r = lead[dtype]
        log(f"  (b) world 2, gloo, {dtype}: ranks bit-equal ({r['ranks_bit_equal_tensors']} "
            f"tensors); against one process on the global batch: losses rel "
            f"{max(r['loss_rel'].values()):.3e}, params and BN beyond rtol "
            f"{r['params_bn_excess_abs']:.3e}, gradients rel {r['grads_rel_max']:.3e} "
            f"of each tensor's largest entry, {r['grads_rel_to_largest_of_all']:.3e} of the "
            "largest of all "
            f"(worst [name, rel, max |g|] {json.dumps(r['grads_worst'][:3])}) "
            f"(tolerance {json.dumps(DP_TOL[dtype])}); launches rank 0 {r['launches']}, "
            f"rank 1 {w2[1][dtype]['launches']}")
    log(f"  (b) eval: mAP equal to one process's at the global batch of 2 "
        f"{json.dumps(lead['eval_vs_one_process'])}; packed masks bit-equal to its "
        f"({lead['packed_mask_bytes_equal']} B); the Loader's "
        f"ms a scene {json.dumps(lead['loader_ms_per_scene'])}; one gloo "
        f"all-reduce, median ms {json.dumps(lead['gloo_all_reduce_ms'])}; 2-rank step ms (two processes sharing one card, not "
        f"scaling): rank 0 {json.dumps(lead['dp_step_ms'])}, rank 1 "
        f"{json.dumps(w2[1]['dp_step_ms'])}")
    launches = {
        f"config5 DP world 1 nccl train.main ({DP_STEPS} steps, 1 eval)": w1["train_main_launches"],
        "config5 DP world 1 nccl, one step": w1["step_launches"],
        **{f"config5 DP world 2 gloo rank {r['rank']}, one {d} step": r[d]["launches"]
           for r in w2 for d in ("float32", "bfloat16")},
        **{f"config5 DP world 2 gloo rank {r['rank']}, eval (3 scenes)": r["eval_launches"]
           for r in w2}}
    for k, v in launches.items():
        if min([v["forward"]] if "eval" in k else v.values()) == 0:
            raise AssertionError(f"{k}: a kernel of the path never launched: {v}")
    summary = {
        "card": smi,
        "world1_nccl": {k: w1[k] for k in ("dp_step_ms", "single_step_ms",
                                           "bytes_all_reduced_per_step", "all_reduces_per_step",
                                           "gradient_bytes", "bit_equal_tensors")},
        "world2_gloo_shared_card": {
            "step_ms_rank0": lead["dp_step_ms"], "step_ms_rank1": w2[1]["dp_step_ms"],
            "all_reduce_ms": lead["gloo_all_reduce_ms"],
            "loader_ms_per_scene": lead["loader_ms_per_scene"],
            "bytes_all_reduced_per_step": lead["bfloat16"]["bytes_all_reduced"],
            **{d: {k: lead[d][k] for k in ("params_bn_excess_abs", "grads_rel_max")}
               | {"loss_rel_max": max(lead[d]["loss_rel"].values()),
                  "grads_rel_to_largest_of_all": lead[d]["grads_rel_to_largest_of_all"]}
               for d in ("float32", "bfloat16")}},
    }
    log(f"  {smi}")
    return {"launches": launches, "world1": w1, "world2": w2, "summary": summary}


# --------------------------------------------------------------------------
# phase 12: the tools (--profile, useful FLOPs, capacity sizing, ScanNet
# preprocessing) and the checkpoint form conversion


def trace_summary(path: str) -> dict:
    """A ``torch.profiler`` Chrome trace: its size, its events, the card's
    kernels by total time, and how often each of ``TRACE_KERNELS`` ran."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            us, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (us + float(e.get("dur", 0.0)), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"bytes": os.path.getsize(path), "events": len(events),
            "kernel_launches": sum(n for _, n in by_name.values()),
            "kernel_ms": sum(us for us, _ in by_name.values()) / 1e3,
            "top_kernels": [[name[:100], round(us / 1e3, 3), n] for name, (us, n) in top],
            "hand_kernels": {k: sum(n for name, (_, n) in by_name.items() if k in name)
                                    for k in TRACE_KERNELS}}


def write_raw_scannet(root: str) -> dict:
    """Two scans in the official ScanNet layout, as
    ``tests/e2e/test_preprocess_drill.py::test_scannet_raw_to_train`` writes
    them (written here with the port's PLY writer): a 3 x 3 m floor slab of
    nyu40 class 2 (outside the benchmark's 18) and two objects, a chair
    (nyu40 5, benchmark class 2) and a table (7, class 4), one segment each,
    both grouped in the aggregation; the scans split into train and val.
    Returns {scene id: split}."""
    rng = np.random.default_rng(0)
    scenes = {"scene0000_00": "train", "scene0001_00": "val"}
    for sid in scenes:
        d = os.path.join(root, "scans", sid)
        os.makedirs(d)
        pts = [np.column_stack([rng.uniform(0, 3.0, 200), rng.uniform(0, 3.0, 200),
                                rng.uniform(0, 0.05, 200)])]
        grp = [np.full(200, -1)]
        for gi, center in enumerate(((1.0, 1.0, 0.4), (2.2, 2.0, 0.5))):
            pts.append(np.asarray(center) + rng.uniform(-0.2, 0.2, (120, 3)))
            grp.append(np.full(120, gi))
        pts, grp = np.concatenate(pts).astype(np.float32), np.concatenate(grp)
        rgb = rng.integers(0, 255, (len(pts), 3)).astype(np.uint8)
        props = {"x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2], "red": rgb[:, 0],
                 "green": rgb[:, 1], "blue": rgb[:, 2]}
        base = os.path.join(d, sid)
        write_ply(base + "_vh_clean_2.ply", props)
        nyu = np.where(grp == 0, 5, np.where(grp == 1, 7, 2)).astype(np.uint16)
        write_ply(base + "_vh_clean_2.labels.ply", {**props, "label": nyu})
        with open(base + "_vh_clean_2.0.010000.segs.json", "w") as f:
            json.dump({"segIndices": np.where(grp < 0, 99, grp + 10).tolist()}, f)
        with open(base + ".aggregation.json", "w") as f:
            json.dump({"segGroups": [{"segments": [10], "label": "chair"},
                                     {"segments": [11], "label": "table"}]}, f)
    os.makedirs(os.path.join(root, "splits"))
    for split in ("train", "val"):
        with open(os.path.join(root, "splits", f"scannetv2_{split}.txt"), "w") as f:
            f.write("\n".join(s for s, sp in scenes.items() if sp == split))
    return scenes


def quiet(fn, argv, path: str):
    """``fn(argv)`` with its standard output sent to ``path``."""
    with open(path, "w") as f, contextlib.redirect_stdout(f):
        return fn(argv)


def mask_iou_miss(a: np.ndarray, b: np.ndarray) -> float:
    """1 - IoU of two packed mask-bit arrays: bits set in one and not the
    other, over bits set in either."""
    either = int(np.unpackbits(a | b).sum())
    return int(np.unpackbits(a ^ b).sum()) / max(either, 1)


def phase_tools(out_dir: str, tmp_dir: str, smi: str, c2: dict) -> dict:
    """Config 2 at full width (phase 8's); ``c2`` is phase 8's record: the
    tools and the conversion of phase 9's dense-3 checkpoint."""
    log("[phase 12] the tools and the checkpoint form conversion, config 2 at full width: "
        f"train.main --profile ({PROFILE_STEPS} steps), collect_rulebook_stats card against "
        f"CPU, size_capacities over phase 10's ScanNet files card against CPU, "
        "preprocess_scannet on a raw tree, phase 9's dense-3 checkpoint converted to none "
        "and to 2")
    t_phase = time.perf_counter()
    n_eval, n_train = c2["sparse_convs"]["eval"], c2["sparse_convs"]["train"]
    cfg = load_config(CONFIG2, infer.parse_overrides(C2_SET))
    rep = {"launches": {}, "card": smi}

    # a. train.main --profile: a trace of the loop that names the kernels
    ckp = os.path.join(tmp_dir, "phase12_profile")
    log_path = os.path.join(out_dir, "train_log_config2_profile.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    sets = sum((["--set", x] for x in C2_SET), [])
    t0 = time.perf_counter()
    _, got = run_cli(train_cli.main, ["--config", CONFIG2, *sets, "--set",
                                      f"train.total_steps={PROFILE_STEPS}", "--set",
                                      "train.log_every=1", "--set",
                                      f"train.checkpoint_dir={ckp}", "--device", DEVICE,
                                      "--profile", "--log-file", log_path],
                     f"config2 train.main --profile, {PROFILE_STEPS} steps")
    wall = time.perf_counter() - t0
    expect(got, want_launches(PROFILE_STEPS * n_train, PROFILE_STEPS * (n_train - 1),
                              PROFILE_STEPS * n_train, PROFILE_STEPS * cfg.data.batch_size,
                              steps=PROFILE_STEPS),
           "config2 train.main --profile launches")
    rep["launches"][f"config2 train.main --profile ({PROFILE_STEPS} steps)"] = got
    train_losses(log_path, PROFILE_STEPS, "config2 train.main --profile")
    traces = [r["trace"] for r in jsonl(log_path) if r["kind"] == "profile"]
    if len(traces) != 1 or os.path.dirname(traces[0]) != os.path.join(ckp, "profile") or \
            not os.path.isfile(traces[0]):
        raise AssertionError(f"train.main --profile: trace lines {traces}")
    summ = trace_summary(traces[0])
    missing = [k for k, n in summ["hand_kernels"].items() if not n]
    if missing:
        raise AssertionError(f"the --profile trace names no {missing}")
    rep["profile"] = {"train_main_s": wall, **summ}
    log(f"  trace {os.path.basename(traces[0])}: {summ['bytes']} bytes, {summ['events']} "
        f"events, {summ['kernel_launches']} kernels of {summ['kernel_ms']:.1f} ms card time "
        f"over {PROFILE_STEPS} steps (train.main {wall:.1f} s with the export); hand "
        f"kernels by name {json.dumps(summ['hand_kernels'])}")
    log("  top kernels of the trace [name, ms, launches]: " + json.dumps(summ["top_kernels"]))
    shutil.rmtree(ckp, ignore_errors=True)

    # b. useful FLOPs: rulebook statistics of one batch, card against CPU
    batch = collate(config2_scenes(cfg, cfg.data.batch_size))
    t0 = time.perf_counter()
    stats = FL.collect_rulebook_stats(cfg, batch, DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stats_cpu = FL.collect_rulebook_stats(cfg, batch, "cpu")
    t2 = time.perf_counter()
    if stats != stats_cpu:
        raise AssertionError(f"collect_rulebook_stats card {stats} against CPU {stats_cpu}")
    flops = FL.useful_forward_flops(cfg, stats)
    eval_ms = c2["eval_ms_per_scene"]["median"] * cfg.data.batch_size
    rep["flops"] = {"stats": stats, "useful_forward_flops_per_batch": flops,
                    "card_s": t1 - t0, "cpu_s": t2 - t1,
                    "eval_step_ms_per_batch": eval_ms,
                    "useful_tflops_per_s_at_eval_step": flops / eval_ms / 1e9}
    log(f"  collect_rulebook_stats (bench scenes, batch {cfg.data.batch_size}): card equal to "
        f"CPU {json.dumps(stats)} ({t1 - t0:.1f} s and {t2 - t1:.1f} s); useful forward "
        f"FLOPs per batch {flops:.6e}, {flops / eval_ms / 1e9:.3f} TFLOP/s over phase 8's "
        f"eval step ({eval_ms:.3f} ms a batch, hierarchy and heads included)")

    # c. size_capacities over phase 10's ScanNet files, card against CPU
    args = ["--config", CONFIG2, "--set", f"data.data_root={scannet_root(tmp_dir)}",
            *sum((["--set", x] for x in C2_DATA_SET + C2_LOADER_SET), []),
            "--scenes", str(SIZE_SCENES)]
    reports = {dev: quiet(SCAP.main, args + ["--device", dev],
                          os.path.join(out_dir, f"size_capacities_{dev}.json"))
               for dev in (DEVICE, "cpu")}
    if reports[DEVICE] != reports["cpu"]:
        raise AssertionError(f"size_capacities card {reports[DEVICE]} against CPU "
                             f"{reports['cpu']}")
    rep["size_capacities"] = reports[DEVICE]
    log(f"  size_capacities, {SIZE_SCENES} augmented ScanNet train scenes through the "
        "host-voxelizing Loader: card report equal to CPU's; per scale [max sites, cap, "
        "suggested]: " + json.dumps([[r["max_sites"], r["cap"], r["suggested"]]
                                     for r in reports[DEVICE]["scales"]])
        + f", span {reports[DEVICE]['max_span_cells']} of grid "
          f"{reports[DEVICE]['grid_extent']}")

    # d. preprocess_scannet on a raw tree, without JAX
    raw, pre = os.path.join(tmp_dir, "scannet_raw"), os.path.join(tmp_dir, "scannet_pre")
    scenes = write_raw_scannet(raw)
    quiet(PPS.main, ["--raw", raw, "--out", pre, "--splits-dir", os.path.join(raw, "splits")],
          os.path.join(out_dir, "preprocess_scannet.log"))
    for sid, split in scenes.items():
        with np.load(os.path.join(pre, split, sid + ".npz")) as z:
            inst, sem = z["instance"], z["semantic"]
            if sorted(z.files) != ["feats", "instance", "points", "semantic"] or \
                    set(np.unique(inst)) != {-1, 0, 1} or set(np.unique(sem)) != {-1, 2, 4} \
                    or any(len(set(sem[inst == i])) != 1 for i in (0, 1)):
                raise AssertionError(f"preprocess_scannet {split}/{sid}: {z.files}, instances "
                                     f"{np.unique(inst)}, classes {np.unique(sem)}")
    log(f"  preprocess_scannet: {len(scenes)} raw scans to {pre}, instances {{-1, 0, 1}}, "
        "classes {-1, 2, 4} (chair, table), one class an instance")

    # e. phase 9's dense-3 checkpoint converted to none and to 2, restored,
    # scored against the unconverted eval, and resumed for a step
    ck2 = os.path.join(tmp_dir, "ckpt_config2")
    base = C2_SET + C2_EVAL_SET + [f"train.checkpoint_dir={ck2}"]
    cfg2 = load_config(CONFIG2, infer.parse_overrides(base))
    src = CK.restore(CK.make_manager(ck2), TL.init_state(cfg2, DEVICE))
    if src is None or src.model.backbone.dense_from_scale != 3:
        raise AssertionError("phase 9's config-2 checkpoint is missing or not dense-3")
    val = TL.to_device(next(val_batches(cfg2)), DEVICE)
    ref = TL.eval_step(cfg2, src, val)
    rep["conversion"] = {}
    for to in ("none", "2"):
        to_s0 = None if to == "none" else int(to)
        out = os.path.join(tmp_dir, f"ckpt_config2_to_{to}")
        _, got = run_cli(CC.main, ["--config", CONFIG2, *sum((["--set", x] for x in base), []),
                                   "--to-dense", to, "--out-dir", out, "--device", DEVICE],
                         f"convert_checkpoint --to-dense {to}")
        expect(got, want_launches(0), "convert_checkpoint launches")
        tsets = base + CC.form_overrides(to_s0) + [f"train.checkpoint_dir={out}"]
        tcfg = load_config(CONFIG2, infer.parse_overrides(tsets))
        conv = CK.restore(CK.make_manager(out), TL.init_state(tcfg, DEVICE))
        if conv is None or (conv.step, conv.model.backbone.dense_from_scale) != (src.step,
                                                                                 to_s0):
            raise AssertionError(f"converted checkpoint {out}: {conv and conv.step}")
        res = TL.eval_step(tcfg, conv, val)
        bits = {k: r["point_mask_bits"].cpu().numpy() for k, r in (("ref", ref), ("got", res))}
        rel = {k: float((res[k].float() - ref[k].float()).abs().max()
                        / ref[k].float().abs().max().clamp(min=1e-30))
               for k in ("proposal_scores", "cls_logits")}
        miss = mask_iou_miss(bits["ref"], bits["got"])
        rec = {"mask_bits_one_minus_iou": miss, **{f"{k}_rel": v for k, v in rel.items()},
               "mask_bits_differing": int(np.unpackbits(bits["ref"] ^ bits["got"]).sum())}
        if to_s0 == cfg2.model.backbone.dense_from_scale:
            # the eval form itself: the computation the unconverted eval runs
            same = all(torch.equal(res[k], ref[k]) for k in ("point_mask_bits",
                                                              "proposal_scores", "cls_logits"))
            if not same:
                raise AssertionError(f"converted to dense-{to}: eval differs from the "
                                     f"unconverted eval {rec}")
        elif miss > DENSE_SPARSE_BF16 or max(rel.values()) > DENSE_SPARSE_BF16:
            raise AssertionError(f"converted to {to}: eval against the unconverted {rec}, "
                                 f"tolerance {DENSE_SPARSE_BF16}")
        n_e, n_t, n_f = form_convs(tcfg)
        log_path = os.path.join(out_dir, f"train_log_config2_to_{to}.jsonl")
        if os.path.exists(log_path):
            os.remove(log_path)
        _, got = run_cli(train_cli.main, ["--config", CONFIG2,
                                          *sum((["--set", x] for x in tsets), []),
                                          "--set", f"train.total_steps={src.step + 1}",
                                          "--resume", "--device", DEVICE,
                                          "--log-file", log_path],
                         f"config2 converted to {to}: train.main --resume, one step")
        expect(got, want_launches(n_f, n_t - 1, n_t, tcfg.data.batch_size, steps=1),
               f"config2 converted to {to} resumed step launches")
        lines = jsonl(log_path)
        if [r["step"] for r in lines if r["kind"] == "resume"] != [src.step]:
            raise AssertionError(f"converted to {to}: resume lines {lines}")
        rec["resumed_step"] = train_losses(log_path, 1, f"config2 converted to {to}")[0]
        rec["launches_resumed_step"] = got
        rep["launches"][f"config2 converted to {to}: train.main --resume (1 step)"] = got
        rep["conversion"][to] = rec
        log(f"  converted to {to} (dense_from_scale {to_s0}): eval against the unconverted "
            f"{json.dumps({k: v for k, v in rec.items() if k not in ('resumed_step', 'launches_resumed_step')})} "
            f"(dense-2 torch.equal, none within {DENSE_SPARSE_BF16}); resumed step "
            f"{src.step + 1} losses " + json.dumps({k: round(v, 5) for k, v in
                                                    rec["resumed_step"].items()}))
        shutil.rmtree(out, ignore_errors=True)
    rep["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 12 took {rep['phase_s']:.1f} s; {smi}")
    return rep


def totals(main_path) -> dict:
    """Sums over one step's main-path records: kernel, plain, library and
    bound ms, and what bounds the step (its bytes over the card's memory rate
    against its products over the peak rate of their type)."""
    t_bytes = sum(r["bytes"] for r in main_path) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["flops"] / PEAK_FLOPS[getattr(torch, r["dtype"])] for r in main_path
                if r["flops"]) * 1e3
    return {
        "ms": sum(r["kernel_ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "bound_ms": sum(r["bound_ms"] for r in main_path),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(r["library_ms"] for r in main_path),
        "max_abs_err": max(r["max_abs_err"] for r in main_path),
    }


def kernel_entry(name, source, replaces, launches, recs_all, main_path, library, per,
                 config1, pool) -> dict:
    """One kernel of the ``kernels`` line: config 2's main path (bf16) at the
    top level, config 1's (f32) under ``config1``, config1_pool_dropout's
    (f32) under ``pool_dropout``."""
    top = totals(main_path)
    top["max_abs_err"] = max(r["max_abs_err"] for r in recs_all + main_path + config1 + pool)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **top, "library": library, "per": per,
            "config1": totals(config1), "pool_dropout": totals(pool)}


def index_entry(name, replaces, launches, recs_all, main_path, config1, paths,
                library="the plain version's own index_put_(accumulate=True)") -> dict:
    """One indexing backward (or the mask read's map) of the ``kernels``
    line, as ``kernel_entry``'s (config 2 at the top level, a record a
    scene; config 1 under ``config1``), with its map's ms (the map kernel:
    the parent's map's ms) and whether every comparison with the plain
    version was bit-equal. Each record list holds this kernel's records."""
    recs_all, main_path, config1 = ([r for r in rs if r["kernel"] == name]
                                    for rs in (recs_all, main_path, config1))
    top = totals(main_path)
    top["max_abs_err"] = max(r["max_abs_err"] for r in recs_all + main_path + config1)

    def maps(rs):
        return {k: sum(r[k] for r in rs) for k in ("map_ms", "parent_ms") if k in rs[0]}
    return {"name": name, "route": "cuda",
            "source": "sparse_rcnn_tpu_torch/ops/csrc/index_grad.cu", "replaces": replaces,
            "launches": launches[name], **top, **maps(main_path),
            "bit_equal": all(r["bit_equal"] and r["bit_identical"]
                             for r in recs_all + main_path + config1),
            "library": library,
            "per": "one config-2 train step (2 scenes), main-path inputs; launches: "
                   f"config-2 train.main, {C2_TRAIN_STEPS} steps; config1: one config-1 train "
                   "step (the crop's rows f32 at config 1, bf16 at config 2; the mask read "
                   "bf16 at both)",
            "config1": {**totals(config1), **maps(config1)},
            "launches_by_path": {k: v[name] for k, v in paths.items()}}


def optim_entry(name, part, replaces, launches, recs, shapes, paths) -> dict:
    """One optimizer kernel of the ``kernels`` line (``part`` "norm" or
    "apply"): config 2's shapes at the top level, config 1's under
    ``config1``; bit-equality over every case."""
    def fig(r):
        return {"ms": r[f"{part}_kernel_ms"], "plain_ms": r[f"{part}_plain_ms"],
                "bound_ms": r[f"{part}_bound_ms"], "bound_by": "bytes",
                "host_ms": r[f"{part}_host_ms"],
                "library_ms": r.get(f"{part}_library_ms"),
                **({"parent_plain_ms": r["norm_parent_ms"]} if part == "norm" else
                   {"stage_library_ms": r["stage_library_ms"]})}
    every = recs + list(shapes.values())
    return {"name": name, "route": "cuda", "source": "sparse_rcnn_tpu_torch/ops/csrc/optim.cu",
            "replaces": replaces, "launches": launches[name],
            **fig(shapes["config2_scannet_2cm"]),
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "bit_equal": all(r["bit_equal"] and r["bit_identical"] for r in every),
            "library": ("torch.nn.utils.get_total_norm(foreach=True)" if part == "norm" else
                        "torch._fused_adamw_ (stage: clip_grad_norm_(foreach=True) + it)"),
            "per": "one optimizer call on config 2's 165 parameter shapes (11,711,957 f32 "
                   "entries; AdamW, clip triggered, no EMA); launches: config-2 train.main, "
                   f"{C2_TRAIN_STEPS} steps; config1: config 1's 48 shapes",
            "config1": fig(shapes["config1_tiny_5cm"]),
            "launches_by_path": {k: v[name] for k, v in paths.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card smoke test of sparse_rcnn_tpu_torch.")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "chiprun_out", "chip_smoke"),
                    help="where the detailed records go")
    ap.add_argument("--dp-worker", choices=("world1", "world2"), default=None,
                    help=argparse.SUPPRESS)      # a rank of phase 11, started by it
    ap.add_argument("--tmp-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.dp_worker:
        return dp_worker(args.dp_worker, args.out_dir, args.tmp_dir)
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
    index_recs = phase_index_grad()
    optim_recs, optim_shapes = phase_optim()
    nms_recs, nms_timed = phase_nms()
    bn_recs, bn_steps = phase_batch_norm()
    selects = count_selects()
    nms_before = NL.LAUNCHES["nms_3d"]
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
    c2_convs = (c2["sparse_convs"]["eval"], c2["sparse_convs"]["train"])
    p9 = phase_eval_checkpoints(args.out_dir, tmp_dir, smi, c2_convs)
    p10 = phase_data_layer(args.out_dir, tmp_dir, smi, c2_convs)
    p11 = phase_data_parallel(args.out_dir, tmp_dir, smi)
    p12 = phase_tools(args.out_dir, tmp_dir, smi, c2)
    steps = nms_step_launches()
    every = [NL.LAUNCHES["nms_3d"] - nms_before, selects[0]]
    log(f"[phase 12] NMS launches over phases 4-12 and the two steps against select calls "
        f"on the card: {every}")
    if every[0] != every[1]:
        raise AssertionError(f"{every[0]} NMS launches for {every[1]} select calls on the card")
    nms_paths = {**steps, "phases 4-12 in this process (select calls on the card)": every[0]}

    src = "sparse_rcnn_tpu_torch/ops/csrc/sparse_conv.cu"
    records = os.path.relpath(os.path.join(args.out_dir, "kernels.json"), ROOT)
    fwd, dgrad, wgrad = (c2["launches_train"][r] for r in ROLES[:3])
    paths = {"config1 infer.main (3 scenes)": launches,
             f"config1 train.main ({TRAIN_STEPS} steps)": train["launches"],
             "config2 infer.main (1 batch)": c2["launches_infer"],
             f"config2 train.main ({C2_TRAIN_STEPS} steps)": c2["launches_train"],
             **p9["launches"], **p10["launches"], **p11["launches"], **p12["launches"]}
    pool = p10["pool_main_path"]
    n_eval, n_train = c2["sparse_convs"]["eval"], c2["sparse_convs"]["train"]
    kernels = {"kernels": [
        dict(kernel_entry(
            "sparse_conv_fwd", src, "sparse_rcnn_tpu/ops/pallas_conv.py:76", fwd, recs,
            c2["forward_main_path"], "feats[idx] im2col gather + torch.matmul (two calls)",
            f"one config-2 eval forward ({n_eval} convs, bf16, dense-2, main-path inputs); "
            f"launches: config-2 train.main, {C2_TRAIN_STEPS} steps; config1: one config-1 "
            f"forward (10 convs, f32); pool_dropout: one pooled forward; train_step: one "
            f"config-2 train step ({n_train} convs, bf16, dense-3); per-conv records in "
            f"{records}", main_path, pool["forward"]),
            launches_by_path={k: v["forward"] for k, v in paths.items()},
            train_step={"launches": len(c2["forward_train_main_path"]),
                        **totals(c2["forward_train_main_path"])}),
        dict(kernel_entry(
            "sparse_conv_dgrad", src, "sparse_rcnn_tpu/ops/sparse_conv.py:536", dgrad,
            [r for r in bwd_recs if r["role"] == "dgrad"], c2["dgrad_main_path"],
            "g[t_idx] im2col gather + torch.matmul with W^T (two calls)",
            f"one config-2 train step ({n_train - 1} dgrads, bf16, dense-3, main-path "
            f"inputs); launches: config-2 train.main, {C2_TRAIN_STEPS} steps; config1: one "
            "config-1 train step (9 dgrads, f32); pool_dropout: one pooled train step",
            train["dgrad_main_path"], pool["dgrad"]),
            launches_by_path={k: v["dgrad"] for k, v in paths.items()}),
        dict(kernel_entry(
            "sparse_conv_wgrad", src, "sparse_rcnn_tpu/ops/sparse_conv.py:542", wgrad,
            [r for r in bwd_recs if r["role"] == "wgrad"], c2["wgrad_main_path"],
            "g[t_idx] gather + torch.matmul with feats^T (two calls)",
            f"one config-2 train step ({n_train} wgrads, bf16, dense-3, main-path inputs); "
            f"launches: config-2 train.main, {C2_TRAIN_STEPS} steps; config1: one config-1 "
            "train step (10 wgrads, f32); pool_dropout: one pooled train step",
            train["wgrad_main_path"], pool["wgrad"]),
            launches_by_path={k: v["wgrad"] for k, v in paths.items()}),
        index_entry("roi_crop_grad", "sparse_rcnn_tpu/ops/roi.py:76", c2["launches_train"],
                    index_recs, c2["roi_grad_main_path"], train["roi_grad_main_path"], paths),
        index_entry("mask_read_grad", "sparse_rcnn_tpu/models/heads.py:99",
                    c2["launches_train"], index_recs, c2["mask_grad_main_path"],
                    train["mask_grad_main_path"], paths),
        index_entry("mask_read_map", "sparse_rcnn_tpu/models/heads.py:99",
                    c2["launches_train"], index_recs, c2["mask_grad_main_path"],
                    train["mask_grad_main_path"], paths,
                    library="torch.sort(stable=True) of the keyed entries alone"),
        optim_entry("global_norm", "norm",
                    "sparse_rcnn_tpu/train/loop.py:81 (optax.clip_by_global_norm's norm), "
                    ":293 (the grad_norm metric's optax.global_norm)",
                    c2["launches_train"], optim_recs, optim_shapes, paths),
        optim_entry("optim_apply", "apply",
                    "sparse_rcnn_tpu/train/loop.py:75-87 (make_optimizer: clip + adamw | sgd), "
                    ":286-289 (update, apply_updates), :298-312 (the EMA)",
                    c2["launches_train"], optim_recs, optim_shapes, paths),
        nms_entry(nms_recs, nms_timed, nms_paths),
        *(bn_entry(role, bn_recs, bn_steps, paths) for role in BN_ROLES),
    ]}
    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "convs_random": recs, "convs_main_path": main_path,
              "dead_tile_vs_main_path": dead_vs_main,
              "backward_random": bwd_recs, "index_grad_edges": index_recs,
              "optim_edges": optim_recs, "optim_shapes": optim_shapes,
              "nms_cases": nms_recs, "nms_timed": nms_timed,
              "bn_cases": bn_recs, "bn_steps": bn_steps,
              "slice_ms_per_scene": split,
              "golden_instance_points_differing": golden_flips,
              "train": train, "golden_train": golden_train, "config2": c2,
              "eval_checkpoints": p9, "data_layer": p10, "data_parallel": p11, "tools": p12}
    with open(os.path.join(args.out_dir, "kernels.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"[phase 13] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"eval_checkpoints": {k: p9[k] for k in (
        "card", "eval_split_per_scene", "config2_fetch", "config2_checkpoint",
        "card_vs_cpu_max_abs_diff", "lookahead")}}))
    print(json.dumps({"data_layer": p10["summary"]}))
    print(json.dumps({"data_parallel": p11["summary"]}))
    print(json.dumps({"tools": {"card": smi, "phase_s": p12["phase_s"],
                                "profile": {k: p12["profile"][k] for k in (
        "bytes", "events", "kernel_launches", "kernel_ms", "hand_kernels")},
        "flops": {k: p12["flops"][k] for k in ("useful_forward_flops_per_batch",
                                                "useful_tflops_per_s_at_eval_step")},
        "conversion": {k: {m: v for m, v in r.items() if m != "resumed_step"}
                       for k, r in p12["conversion"].items()},
        "dense_tail_cost": c2["dense_tail_cost"]}}))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
