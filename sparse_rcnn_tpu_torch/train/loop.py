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
read at the count before each update, and the optional EMA. Unlike the
functional JAX step, :func:`train_step` updates the parameters, the
optimizer state and the BN running statistics in place and returns the
same :class:`TrainState`.
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
from ..models import layers as Lyr
from ..models import losses as L
from ..models.convert import convert_variables
from ..models.detector import SparseRCNN, paint_instance_masks
from ..models.targets import roi_targets, rpn_targets
from ..ops import hierarchy as H
from ..ops import voxelize as V

_BATCH_KEYS = ("points", "feats", "valid")
TRAIN_KEYS = _BATCH_KEYS + ("point_instance", "point_semantic")


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
              keys=_BATCH_KEYS) -> Dict[str, torch.Tensor]:
    """The arrays the device path reads (``keys``; :data:`TRAIN_KEYS` adds
    the point labels that GT is built from), as tensors on ``device``."""
    return {k: torch.as_tensor(batch[k], device=device) for k in keys}


def prepare_inputs(cfg: Config, batch: Dict[str, torch.Tensor]):
    """Device-side front half: voxelize → rebase → hierarchy → GT.

    Returns (SparseTensor, p2v [B, N], scales, gt, aux). ``gt`` is a
    :class:`~..models.targets.SceneGT` when the batch carries the point
    labels (``point_instance``, ``point_semantic``), else None; ``aux``
    holds the overflow counters (tensors on the batch's device), with a
    dense tail also ``dense_tail_oob``: the live sites of its first scale
    that fall outside the grid and are dropped from it.
    """
    st, p2v, ovf = V.voxelize_batch(
        batch["points"], batch["feats"], batch["valid"], cfg.data.voxel_size,
        cfg.data.voxel_capacity)
    # integer per-scene rebase to non-negative coords: exact, and the frame
    # the dense tail and the GT boxes use
    st, base = V.rebase_coords(st, margin=2)
    bb = cfg.model.backbone
    dfs = bb.dense_from_scale
    scales, hovf = H.build_hierarchy(
        st, len(bb.widths), cfg.scale_capacities(), bb.kernel_size, subm_scales=dfs)
    aux = {
        "voxel_overflow": ovf.sum(),
        "hierarchy_overflow": hovf.sum(),
        "voxels_per_scene": st.nvalid.to(torch.float32).mean(),
    }
    if dfs is not None:
        # a site outside the grid at the tail's first scale is outside at
        # every deeper scale too
        sc = scales[dfs]
        ext = torch.tensor([e >> dfs for e in bb.grid_extent], dtype=torch.int32,
                           device=sc.coords.device)
        inside = ((sc.coords >= 0) & (sc.coords < ext)).all(-1)
        aux["dense_tail_oob"] = (sc.row_mask & ~inside).sum()
    gt = None
    if "point_instance" in batch:
        gt = build_scene_gt(
            batch["points"], batch["valid"], batch["point_instance"],
            batch["point_semantic"], p2v, cfg.data.voxel_capacity,
            cfg.data.voxel_size, cfg.model.max_instances, base=base)
        # points whose instance id does not fit max_instances: dropped from
        # the GT boxes, and counted
        aux["gt_instance_overflow"] = (
            batch["valid"] & (batch["point_instance"] >= cfg.model.max_instances)).sum()
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
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=mask.device)
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
    convert once with it before a loop)."""
    model = eval_model(cfg, model)
    st, p2v, scales, gt, aux = prepare_inputs(cfg, batch)
    out = model.eval()(st.feats, scales)
    result = finish(cfg, out, scales, p2v)
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
    # the mask loss at the actual voxels, through the inference sampling path
    voxel_mask_logits, _ = paint_instance_masks(out, scales, masked=False)
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
    lists of tensors, in the order of ``model.parameters()``."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

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
    def apply(self, state: OptState, params: List[torch.Tensor],
              grads: List[torch.Tensor]) -> bool:
        """One optimizer call on ``grads``: updates ``params`` and ``state``
        in place; returns whether an update was applied (always, unless
        this is a ``MultiSteps`` mini-step)."""
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
                return False
            grads, state.acc_grads = acc, [torch.zeros_like(a) for a in acc]
        updates = self._clip(grads)
        lr = self.schedule(state.count)
        state.count += 1
        if self.sgd:
            torch._foreach_mul_(state.mu, 0.9)
            torch._foreach_add_(state.mu, updates)          # trace: g + 0.9 t
            updates = state.mu
        else:
            updates = self._adam(state, updates, params)
        torch._foreach_add_(params, torch._foreach_mul(updates, -lr))
        return True

    def _clip(self, grads):
        """``clip_by_global_norm``: t / ‖g‖ · max_norm when ‖g‖ ≥ max_norm
        (no epsilon, as optax)."""
        g_norm = global_norm(grads)
        keep = g_norm < self.clip
        return [torch.where(keep, g, g / g_norm * self.clip) for g in grads]

    def _adam(self, state: OptState, g, params):
        b1, b2 = self.B1, self.B2
        mu = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(state.mu, b1))
        nu = torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, b2))
        state.mu, state.nu = mu, nu
        t = np.float32(state.count)          # the count after this update
        mu_hat = torch._foreach_div(mu, float(np.float32(1) - np.float32(b1) ** t))
        nu_hat = torch._foreach_div(nu, float(np.float32(1) - np.float32(b2) ** t))
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.EPS)
        updates = torch._foreach_div(mu_hat, nu_hat)
        torch._foreach_add_(updates, torch._foreach_mul(params, self.weight_decay))
        return updates


def global_norm(tensors) -> torch.Tensor:
    """optax ``global_norm``: √(Σ over tensors of Σ x²)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


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

    On the CPU, the backward of an advanced-indexing read (``feats[idx]`` in
    ``ops/roi.py::sample_trilinear``) is an ``index_put_`` accumulate that
    adds repeated rows with parallel atomics, so a gradient changes in its
    last bits from run to run; the deterministic mode sorts the indices
    first. On the card nothing is switched: CUDA's ``index_put_`` already
    sorts, and the mode would make cuBLAS refuse to run without a workspace
    setting the caller did not ask for.
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


def loss_and_grads(cfg: Config, model: SparseRCNN, batch: Dict[str, torch.Tensor]):
    """Forward in training mode (BN batch statistics, GT injection), losses
    and the gradients of every parameter (zeros where none flows), bit-stable
    from run to run on the card and on the CPU (:func:`deterministic_on_cpu`).
    Returns (total, parts, grads, aux); the BN running statistics move."""
    cfg = train_cfg(cfg)
    st, _, scales, gt, aux = prepare_inputs(cfg, batch)
    model.train()
    out = model(st.feats, scales, gt_boxes=gt.boxes, gt_boxes_valid=gt.valid)
    total, parts = compute_losses(cfg, out, scales, gt, st.row_mask)
    params = list(model.parameters())
    with deterministic_on_cpu(total.device):
        grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return total.detach(), {k: v.detach() for k, v in parts.items()}, grads, aux


def train_step(cfg: Config, state: TrainState, batch: Dict[str, torch.Tensor]):
    """One optimization step, in place. Returns (state, metrics): the loss
    parts, ``total``, ``grad_norm`` (of the raw gradients) and the overflow
    counters, as tensors on the batch's device."""
    cfg = train_cfg(cfg)
    total, parts, grads, aux = loss_and_grads(cfg, state.model, batch)
    params = list(state.model.parameters())
    metrics = dict(parts)
    metrics.update(aux)
    metrics["total"] = total
    with torch.no_grad():
        metrics["grad_norm"] = global_norm(grads)
        applied = Optimizer(cfg).apply(state.opt_state, params, grads)
        if cfg.train.ema > 0:
            # debiased EMA: the (1+t)/(10+t) ramp capped at the decay; with
            # accumulation only on calls that applied an update
            t = np.float32(state.step)
            d = min(np.float32(cfg.train.ema), (np.float32(1) + t) / (np.float32(10) + t))
            if cfg.train.grad_accum_steps > 1 and not applied:
                d = np.float32(1)
            torch._foreach_mul_(state.ema_params, float(d))
            torch._foreach_add_(state.ema_params,
                                torch._foreach_mul(params, float(np.float32(1) - d)))
    state.step += 1
    return state, metrics
