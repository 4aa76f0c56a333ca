"""Training and eval steps (port of ``train/loop.py``).

Model construction; the device-side front half (voxelize → rebase →
hierarchy → GT); the eval step; losses; and the training step: forward in
training mode with GT injection, losses, backward (every sparse conv's dgrad
and wgrad on the hand-written kernels), then the optimizer.

The optimizer is optax's chain written out over the port's parameters:
``clip_by_global_norm`` → ``adamw`` (``scale_by_adam`` with eps 1e-8,
eps_root 0, then decoupled weight decay on every parameter, then ``-lr``)
or ``sgd`` with momentum 0.9, inside ``MultiSteps`` when
``train.grad_accum_steps > 1``, with the ``warmup_cosine_decay_schedule``
read at the count before each update, and the optional EMA, all in one
pass after the norm (``ops/optim.py``: on the card the hand-written kernels
of ``ops/csrc/optim.cu``, on the CPU the plain ``torch._foreach_*`` chain
they repeat). Unlike the functional JAX step, :func:`train_step` updates
the parameters, the optimizer state and the BN running statistics in place
and returns the same :class:`TrainState`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.gt import build_scene_gt
from ..data.pipeline import device_keys
from ..models import layers as Lyr
from ..models import losses as L
from ..models.convert import convert_variables
from ..models.detector import SparseRCNN, paint_instance_masks
from ..models.targets import roi_targets, rpn_targets
from ..ops import hierarchy as H
from ..ops import optim as OPT
from ..ops.optim import global_norm
from ..ops.consts import device_tensor
from ..ops import voxelize as V
from ..parallel import context as DPC
from ..sparse import make_sparse_tensor
from ..utils.profiling import span

BATCH_KEYS = ("points", "feats", "valid")
TRAIN_KEYS = BATCH_KEYS + ("point_instance", "point_semantic")


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.model.backbone.dtype == "bfloat16" else torch.float32


def build_model(cfg: Config, device="cuda",
                generator: Optional[torch.Generator] = None) -> SparseRCNN:
    """The detector in eval mode on ``device``.

    With a ``generator`` its weights are the port's own seeded init (drawn
    on the CPU, so one seed gives one set of weights on every device);
    without one they are left unset for :meth:`load_state_dict`.
    """
    with torch.device("meta"):
        model = SparseRCNN(cfg.model, cfg.data.num_features, compute_dtype(cfg))
    model = model.to_empty(device="cpu")
    if generator is not None:
        Lyr.init_params(model, generator)
    return model.to(device).eval()


def to_device(batch: Dict[str, np.ndarray], device,
              keys=BATCH_KEYS) -> Dict[str, torch.Tensor]:
    """The arrays the device path reads (``keys``; :data:`TRAIN_KEYS` adds
    the point labels that GT is built from; any host-voxelized tables), as
    tensors on ``device``."""
    with span("to_device"):
        return {k: torch.as_tensor(batch[k], device=device)
                for k in device_keys(batch, keys)}


def prepare_inputs(cfg: Config, batch: Dict[str, torch.Tensor]):
    """Device-side front half: voxelize → rebase → hierarchy → GT. A batch
    that carries the host voxelizer's tables (``data/pipeline.py::
    VOXEL_KEYS``) skips the voxelize: they are the same tables.

    Returns (SparseTensor, p2v [B, N], scales, gt, aux). ``gt`` is a
    :class:`~..models.targets.SceneGT` when the batch carries the point
    labels (``point_instance``, ``point_semantic``), else None; ``aux``
    holds the overflow counters (tensors on the batch's device), with a
    dense tail also ``dense_tail_oob``: the live sites of its first scale
    that fall outside the grid and are dropped from it.

    Spans: ``prepare_inputs``, with ``voxelize`` (and the rebase),
    ``hierarchy`` and ``gt`` under it.
    """
    with span("prepare_inputs"):
        with span("voxelize"):
            if "voxel_coords" in batch:
                st = make_sparse_tensor(batch["voxel_coords"], batch["voxel_feats"],
                                        batch["voxel_nvalid"], assume_sorted=True)
                p2v, ovf = batch["p2v"], batch["voxel_overflow"]
            else:
                st, p2v, ovf = V.voxelize_batch(
                    batch["points"], batch["feats"], batch["valid"], cfg.data.voxel_size,
                    cfg.data.voxel_capacity)
            # integer per-scene rebase to non-negative coords: exact, and the
            # frame the dense tail and the GT boxes use
            st, base = V.rebase_coords(st, margin=2)
        bb = cfg.model.backbone
        dfs = bb.dense_from_scale
        with span("hierarchy"):
            scales, hovf = H.build_hierarchy(
                st, len(bb.widths), cfg.scale_capacities(), bb.kernel_size, subm_scales=dfs)
            aux = {
                "voxel_overflow": ovf.sum(),
                "hierarchy_overflow": hovf.sum(),
                "voxels_per_scene": st.nvalid.to(torch.float32).mean(),
            }
            if dfs is not None:
                # a site outside the grid at the tail's first scale is outside
                # at every deeper scale too
                sc = scales[dfs]
                ext = device_tensor([e >> dfs for e in bb.grid_extent], torch.int32,
                                    sc.coords.device)
                inside = ((sc.coords >= 0) & (sc.coords < ext)).all(-1)
                aux["dense_tail_oob"] = (sc.row_mask & ~inside).sum()
        gt = None
        if "point_instance" in batch:
            with span("gt"):
                gt = build_scene_gt(
                    batch["points"], batch["valid"], batch["point_instance"],
                    batch["point_semantic"], p2v, cfg.data.voxel_capacity,
                    cfg.data.voxel_size, cfg.model.max_instances, base=base)
                # points whose instance id does not fit max_instances: dropped
                # from the GT boxes, and counted
                aux["gt_instance_overflow"] = (
                    batch["valid"]
                    & (batch["point_instance"] >= cfg.model.max_instances)).sum()
    return st, p2v, scales, gt, aux


def finish(cfg: Config, out: Dict[str, torch.Tensor], scales, p2v) -> Dict[str, torch.Tensor]:
    """The tail of the eval step: masks painted on voxels, then on points."""
    vox_logits, _ = paint_instance_masks(out, scales)
    point_logits = V.devoxelize(vox_logits.transpose(1, 2), p2v, fill_value=-1e9)
    result = {
        "proposal_scores": out["proposal_scores"],
        "proposal_mask": out["proposal_mask"],
        "cls_logits": out["cls_logits"],
        "point_mask_logits": point_logits.transpose(1, 2),   # [B, P, N]
    }
    if cfg.model.use_semantic_head:
        sem_pred = out["semantic_logits"].argmax(-1).to(torch.int32)
        result["point_semantic_pred"] = V.devoxelize(sem_pred, p2v, fill_value=-1)
    return result


def eval_model(cfg: Config, source) -> SparseRCNN:
    """The model that :func:`eval_step` runs: ``source`` (a model or a
    :class:`TrainState`) in the eval form.

    A :class:`TrainState` with ``train.ema > 0`` is scored on its EMA
    parameters, with the model's own BN running statistics, as the JAX
    ``eval_step`` scores ``state.ema_params``: the result is then always a
    separate model, and ``state.model`` is never written. Pass
    ``state.model`` itself to score the raw weights (JAX aliases
    ``ema_params=params`` for that).

    Weights live in the train form (the tail boundary
    ``dense_from_scale_train``); when the eval boundary ``dense_from_scale``
    differs, a model of the eval form gets them converted, exactly
    (:mod:`..models.convert`). A model already in the eval form, and with
    no EMA to apply, comes back as it is."""
    ema = None
    if isinstance(source, TrainState):
        if cfg.train.ema > 0:
            ema = source.ema_params
        model = source.model
    else:
        model = source
    dfs = cfg.model.backbone.dense_from_scale
    if ema is None and model.backbone.dense_from_scale == dfs:
        return model
    state = model.state_dict()
    if ema is not None:
        names = [n for n, _ in model.named_parameters()]
        state.update(zip(names, ema))
    out = build_model(cfg, next(model.parameters()).device)
    out.load_state_dict(convert_variables(state, dfs))
    return out


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """``np.packbits(mask, axis=-1)`` on the tensor's device: bool [..., N] →
    uint8 [..., ceil(N / 8)], the first of each 8 in the most significant
    bit, N padded with False."""
    n = mask.shape[-1]
    mask = torch.nn.functional.pad(mask, (0, -n % 8))
    weights = device_tensor([128, 64, 32, 16, 8, 4, 2, 1], torch.uint8, mask.device)
    return (mask.reshape(*mask.shape[:-1], -1, 8).to(torch.uint8) * weights).sum(
        -1, dtype=torch.uint8)


@torch.no_grad()
def eval_step(cfg: Config, model, batch: Dict[str, torch.Tensor]):
    """Inference forward: the keys of the JAX ``eval_step``. Model outputs,
    the point mask logits [B, P, N], ``point_mask_bits`` (the logits > 0,
    that is sigmoid > 0.5, bit-packed on the device as ``np.packbits``
    does, so an evaluator fetches N / 8 bytes a proposal instead of 4 N),
    ``gt`` (a :class:`~..models.targets.SceneGT` when the batch carries the
    point labels, else None) and the overflow counters. ``model`` is a
    model or a :class:`TrainState`, in either tail form (:func:`eval_model`;
    convert once with it before a loop). Spans: ``eval_step``, with
    ``prepare_inputs``, ``forward``, ``finish`` and ``packbits`` under it."""
    with span("eval_step"):
        model = eval_model(cfg, model)
        st, p2v, scales, gt, aux = prepare_inputs(cfg, batch)
        out = model.eval()(st.feats, scales)
        with span("finish"):
            result = finish(cfg, out, scales, p2v)
        with span("packbits"):
            result["point_mask_bits"] = packbits(result["point_mask_logits"] > 0)
        result["gt"] = gt
        result.update(aux)
        return result


# --------------------------------------------------------------------------
# training


def train_cfg(cfg: Config) -> Config:
    """The config the train step runs with: the per-mode tail boundary
    ``backbone.dense_from_scale_train``, when set, replaces the eval form's
    ``dense_from_scale``. Weights live in this train form; :func:`eval_model`
    converts them to the eval form. Idempotent."""
    bb = cfg.model.backbone
    t = bb.dense_from_scale_train
    if t is None or t == bb.dense_from_scale:
        return cfg
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=dataclasses.replace(bb, dense_from_scale=t)))


def pool_instance_labels(gt, scales, max_level: Optional[int] = None) -> List[torch.Tensor]:
    """Per-scale voxel instance ids: max over each coarse voxel's children,
    for levels [0, max_level]."""
    n = len(scales) - 1 if max_level is None else max_level
    levels = [gt.voxel_instance]
    for s in range(n):
        idx = scales[s].down_idx                       # [B, 8, M_{s+1}]
        prev = levels[-1]                              # [B, M_s]
        safe = idx.clamp(0, prev.shape[1] - 1).to(torch.int64)
        rows = torch.gather(prev[:, None, :].expand(-1, idx.shape[1], -1), 2, safe)
        levels.append(torch.where(idx >= 0, rows, -1).amax(dim=1))
    return levels


def compute_losses(cfg: Config, out, scales, gt, row_mask):
    """(total, parts) of the JAX ``compute_losses``; the RoI targets match
    the crop boxes, as in the JAX package."""
    rpn_scales = cfg.model.rpn.rpn_scales or (cfg.model.rpn.rpn_scale,)
    inst_levels = pool_instance_labels(gt, scales, max_level=max(rpn_scales))
    obj_l = box_l = 0.0
    for i, s in enumerate(rpn_scales):
        rt = rpn_targets(scales[s].coords, out["rpn_mask"][i], gt,
                         cfg.model.rpn.box_norm, 1 << s, voxel_instance=inst_levels[s])
        o, bx = L.rpn_loss(out["rpn_obj"][i], out["rpn_deltas"][i], rt)
        obj_l = obj_l + o / len(rpn_scales)
        box_l = box_l + bx / len(rpn_scales)
    tt = roi_targets(out["crop_boxes"], out["proposal_mask"], scales[0].coords,
                     scales[0].nvalid, gt, cfg.model)
    # the mask loss at the actual voxels, through the inference sampling path;
    # its cotangent is 0 where the loss weights a voxel by 0, so the read's
    # backward adds only the weighted entries
    voxel_mask_logits, _ = paint_instance_masks(out, scales, masked=False,
                                                keep=tt.mask_weight > 0)
    parts = {
        "rpn_obj": obj_l,
        "rpn_box": box_l,
        "roi_cls": L.roi_cls_loss(out["cls_logits"], tt),
        "roi_mask": L.roi_mask_loss(voxel_mask_logits, tt),
    }
    if cfg.model.use_semantic_head:
        parts["semantic"] = L.semantic_loss(out["semantic_logits"], gt.voxel_semantic,
                                            row_mask, cfg.model.num_classes)
    return L.total_loss(parts, cfg.train.loss_weights), parts


def make_schedule(cfg: Config):
    """optax ``warmup_cosine_decay_schedule`` from 0 to ``lr`` and down to
    ``lr · 0.01``, counted in optimizer updates (micro-steps / k), in f32."""
    k = max(1, cfg.train.grad_accum_steps)
    total = max(cfg.train.total_steps // k, 1)
    warmup = min(cfg.train.warmup_steps // k, max(total // 10, 0))
    decay = max(total, warmup + 1) - warmup
    peak, end = cfg.train.lr, cfg.train.lr * 0.01
    alpha = np.float32(0.0 if peak == 0.0 else end / peak)
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup:          # linear_schedule(0 → peak, warmup)
            frac = f32(1) - f32(count) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        c = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(f32(peak) * ((f32(1) - alpha) * cosine + alpha))
    return schedule


@dataclasses.dataclass
class OptState:
    """``count``: inner (applied) updates so far, the schedule's count;
    ``mu``/``nu``: Adam moments (``mu`` is the momentum trace for sgd);
    ``mini_step`` and ``acc_grads``: the ``MultiSteps`` accumulator."""
    count: int
    mu: List[torch.Tensor]
    nu: Optional[List[torch.Tensor]]
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


class Optimizer:
    """optax ``[MultiSteps](chain(clip_by_global_norm, adamw | sgd))`` over
    lists of tensors, in the order of ``model.parameters()``, with the EMA
    in the same pass: :func:`~..ops.optim.global_norm`, then
    :func:`~..ops.optim.optim_apply` (the kernels of ``ops/csrc/optim.cu``
    on the card, the plain chain on the CPU)."""

    def __init__(self, cfg: Config):
        self.schedule = make_schedule(cfg)
        self.sgd = cfg.train.optimizer == "sgd"
        self.clip = cfg.train.grad_clip
        self.weight_decay = cfg.train.weight_decay
        self.k = cfg.train.grad_accum_steps

    def init(self, params: List[torch.Tensor]) -> OptState:
        def zeros():
            return [torch.zeros_like(p) for p in params]
        return OptState(count=0, mu=zeros(), nu=None if self.sgd else zeros(),
                        acc_grads=zeros() if self.k > 1 else None)

    @torch.no_grad()
    def apply(self, state: OptState, params: List[torch.Tensor], grads: List[torch.Tensor],
              ema: Optional[List[torch.Tensor]] = None,
              ema_decay: Optional[np.float32] = None) -> Optional[torch.Tensor]:
        """One optimizer call on ``grads``: updates ``params``, ``state``
        (its moments in place) and, given, the EMA copy ``ema`` with decay
        ``ema_decay`` (1 on a ``MultiSteps`` mini-step, which applies no
        update). Returns the clip's norm ‖g‖ (a 0-d tensor on the
        parameters' device) when an update was applied, else None."""
        if self.k > 1:
            # running mean of the micro-grads; the inner chain runs on the
            # mean every k-th call, and only then advances its state
            acc = state.acc_grads
            diff = torch._foreach_sub(grads, acc)
            torch._foreach_div_(diff, float(state.mini_step + 1))
            torch._foreach_add_(acc, diff)
            emit = state.mini_step == self.k - 1
            state.mini_step = (state.mini_step + 1) % self.k
            if not emit:
                if ema is not None:
                    OPT.optim_apply(None, None, params, None, None, ema,
                                    OPT.Step("ema", ema_decay=np.float32(1)))
                return None
            grads, state.acc_grads = acc, [torch.zeros_like(a) for a in acc]
        norm = global_norm(grads)
        lr = self.schedule(state.count)
        state.count += 1
        OPT.optim_apply(norm, grads, params, state.mu, state.nu, ema, OPT.Step(
            "sgd" if self.sgd else "adamw", lr=lr, count=state.count, clip=self.clip,
            weight_decay=self.weight_decay, ema_decay=ema_decay))
        return norm


@dataclasses.dataclass
class TrainState:
    """The step count, the model (parameters and BN running statistics),
    the optimizer state and, with ``train.ema > 0``, the EMA copy of the
    parameters (in ``model.parameters()`` order)."""
    step: int
    model: SparseRCNN
    opt_state: OptState
    ema_params: Optional[List[torch.Tensor]] = None


def init_state(cfg: Config, device="cuda",
               generator: Optional[torch.Generator] = None,
               model: Optional[SparseRCNN] = None) -> TrainState:
    """A fresh train state: ``model`` as given, else the port's seeded init
    from ``generator``."""
    cfg = train_cfg(cfg)
    if model is None:
        model = build_model(cfg, device, generator)
    params = list(model.parameters())
    ema = [p.detach().clone() for p in params] if cfg.train.ema > 0 else None
    return TrainState(step=0, model=model, opt_state=Optimizer(cfg).init(params),
                      ema_params=ema)


@contextlib.contextmanager
def deterministic_on_cpu(device):
    """Run the block under ``torch.use_deterministic_algorithms(True)`` when
    ``device`` is the CPU, and restore the previous setting after it.

    On the CPU, the backward of the RoI crop's corner gather and of the
    bf16 mask read (``ops/index_grad.py``, plain versions) is an
    ``index_put_`` accumulate that adds repeated rows with parallel
    atomics, so a gradient changes in its last bits from run to run; the
    deterministic mode sorts the indices first. On the card nothing is
    switched: those two backwards run the ``roi_crop_grad`` and
    ``mask_read_grad`` kernels, which add each row's entries in a fixed
    order with no atomics, so no ``index_put_`` runs on these paths; and the
    mode would make cuBLAS refuse to run without a workspace setting the
    caller did not ask for.
    """
    if torch.device(device).type != "cpu":
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)


def dropout_generators(cfg: Config, step: int, device, scenes) -> List[torch.Generator]:
    """The generators of step ``step``'s dropout masks on ``device``, one
    for each global scene index of ``scenes``, seeded by (``train.seed``,
    ``step``, scene): a resumed run draws an unbroken run's masks, with no
    generator state in the checkpoint, and the rank that holds a scene
    draws the masks one process would draw for it. (JAX splits a key
    carried in its state; the masks differ from JAX's, not their law.)"""
    gens = []
    for scene in scenes:
        seed = int(np.random.SeedSequence([cfg.train.seed, step, scene]).generate_state(1)[0])
        gens.append(torch.Generator(device=device).manual_seed(seed))
    return gens


def loss_and_grads(cfg: Config, model: SparseRCNN, batch: Dict[str, torch.Tensor],
                   generators: Optional[List[torch.Generator]] = None):
    """Forward in training mode (BN batch statistics, GT injection, dropout
    masks from ``generators``, one per scene), losses and the gradients of
    every parameter (zeros where none flows), bit-stable from run to run on
    the card and on the CPU (:func:`deterministic_on_cpu`). Returns (total,
    parts, grads, aux); the BN running statistics move."""
    cfg = train_cfg(cfg)
    st, _, scales, gt, aux = prepare_inputs(cfg, batch)
    model.train()
    out = model(st.feats, scales, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid,
                generators=generators)
    with span("losses"):
        total, parts = compute_losses(cfg, out, scales, gt, st.row_mask)
    params = list(model.parameters())
    # the backward's launches come from autograd's device thread while this
    # thread waits in the span
    with span("backward"), deterministic_on_cpu(total.device):
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return total.detach(), {k: v.detach() for k, v in parts.items()}, grads, aux


# how the data-parallel step reduces each metric over the ranks: a sum
# unless named here (``grad_norm`` is of the reduced gradients already)
METRIC_REDUCTION = {"voxels_per_scene": "mean", "grad_norm": "none"}


def reduce_metrics(metrics: Dict[str, torch.Tensor], world: DPC.World) -> None:
    """The metrics of the global batch from each rank's, in place, in one
    collective: the loss parts are the ranks' terms of global masked means
    and add up, the counters add up, ``voxels_per_scene`` is the mean of
    the ranks' equal shares (:data:`METRIC_REDUCTION`)."""
    keys = [k for k in metrics if METRIC_REDUCTION.get(k) != "none"]
    vals = DPC.all_reduce_(torch.stack([metrics[k].to(torch.float64) for k in keys]), world)
    for k, v in zip(keys, vals):
        if METRIC_REDUCTION.get(k) == "mean":
            v = v / world.size
        metrics[k] = v.to(metrics[k].dtype)


def train_step(cfg: Config, state: TrainState, batch: Dict[str, torch.Tensor]):
    """One optimization step, in place. Returns (state, metrics): the loss
    parts, ``total``, ``grad_norm`` (of the raw gradients) and the overflow
    counters, as tensors on the batch's device. With ``backbone.dropout``
    the masks come from :func:`dropout_generators` of ``state.step``.

    Under data parallel (``parallel/data_parallel.py::
    make_parallel_train_step``) it is the global batch's step: the losses
    carry the global denominators, the gradients are summed over the ranks
    in one all-reduce of one flat buffer, every rank then runs the same
    optimizer and EMA update, and the metrics are the global batch's.

    Spans: ``train_step``, with ``prepare_inputs``, ``forward``, ``losses``,
    ``backward`` and ``optimizer`` under it."""
    with span("train_step"):
        cfg = train_cfg(cfg)
        world = DPC.current()
        generators = None
        if cfg.model.backbone.dropout > 0:
            b = batch["points"].shape[0]
            first = 0 if world is None else world.rank * b
            generators = dropout_generators(cfg, state.step, batch["points"].device,
                                            range(first, first + b))
        total, parts, grads, aux = loss_and_grads(cfg, state.model, batch, generators)
        params = list(state.model.parameters())
        metrics = dict(parts)
        metrics.update(aux)
        metrics["total"] = total
        with torch.no_grad():
            if world is not None:
                DPC.all_reduce_flat_(grads, world)
            with span("optimizer"):
                metrics["grad_norm"] = optimizer_step(cfg, state, params, grads)
            if world is not None:
                reduce_metrics(metrics, world)
        state.step += 1
        return state, metrics


@torch.no_grad()
def optimizer_step(cfg: Config, state: TrainState, params: List[torch.Tensor],
                   grads: List[torch.Tensor]) -> torch.Tensor:
    """The optimizer stage of :func:`train_step`, in place: the update and,
    with ``train.ema > 0``, the debiased EMA (the (1+t)/(10+t) ramp capped
    at the decay; with accumulation only on calls that applied an update)
    in the same pass. Returns ``grad_norm``, the norm of the raw gradients:
    the clip's own norm, unless gradients accumulate (the clip then takes
    the norm of their mean)."""
    opt = Optimizer(cfg)
    d = None
    if cfg.train.ema > 0:
        t = np.float32(state.step)
        d = min(np.float32(cfg.train.ema), (np.float32(1) + t) / (np.float32(10) + t))
    raw = global_norm(grads) if opt.k > 1 else None
    norm = opt.apply(state.opt_state, params, grads, state.ema_params, d)
    return norm if raw is None else raw
