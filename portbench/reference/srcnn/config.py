"""Frozen copy of ``sparse_rcnn_tpu_torch/config.py`` at commit 4dd78ef, for the benchmark's
reference (edits: operands through ``precision.q``; the mask read in the
reference's own dtype; no CUDA kernels).

Typed dataclass configs with YAML overrides — the port's own copy.

A field-for-field copy of ``sparse_rcnn_tpu/config.py``, so that the port
reads every ``configs/*.yaml`` unchanged without importing the JAX package
(whose ``__init__`` imports jax). ``tests/test_torch_config.py`` holds the
two copies equal. Capacity and budget fields are fixed tensor shapes in the
port too: a config fully determines every buffer size.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic"            # synthetic | scannet | s3dis | semantic_kitti
    data_root: str = ""
    voxel_size: Tuple[float, float, float] = (0.05, 0.05, 0.05)
    num_points: int = 16384               # point capacity per scene (padded)
    voxel_capacity: int = 8192            # M_cap at stride 1
    num_features: int = 3                 # input feature channels (e.g. RGB)
    batch_size: int = 2
    # augmentation
    augment: bool = True
    rotate_z: bool = True
    flip: bool = True
    scale_range: Tuple[float, float] = (0.9, 1.1)
    jitter_sigma: float = 0.0
    color_jitter: float = 0.05
    elastic_distortion: bool = False
    num_workers: int = 2
    prefetch: int = 2
    # synthetic-only: TRAIN scene-pool size (None = max(64, batch*8)).
    # The 64-scene default overfits detection heads within ~2.5k steps
    # (BASELINE.md quality tables); quality runs should raise this.
    # Train-only on purpose: growing the train pool must not silently move
    # the val/test pools, or quality trajectories stop being comparable
    # across runs (round-3 advisor finding). Scene IDENTITY is pool-size
    # independent (scene i is a pure function of split seed and i), so
    # val_scenes only bounds how many scenes an eval pass can see.
    num_scenes: Optional[int] = None
    # synthetic-only: VAL/TEST scene-pool size (None = max(64, batch*8)).
    # Quality configs pin this to the eval-protocol size (e.g. 32) so the
    # in-training and final evals score the identical scene set.
    val_scenes: Optional[int] = None
    # voxelize in host workers via the C++ core (overlapped with device
    # compute, BASELINE config 5); falls back to device voxelize if the
    # native library is unavailable
    host_voxelize: bool = False
    # Expected maximum scene size in METERS per axis (dataset property —
    # e.g. ScanNet rooms ≤ ~10 x 10 x 3.2 m). Two uses (round-3 verdict:
    # extent must be sized per dataset, not hand-copied):
    #  * backbone.grid_extent omitted → it is DERIVED from these bounds
    #    (see derive_grid_extent: voxel count + augmentation margin,
    #    rounded to the scale divisibility constraint)
    #  * backbone.grid_extent set → validated to cover these bounds at
    #    load time (fail fast instead of silently cropping every scene)
    scene_bounds: Optional[Tuple[float, float, float]] = None
    # Scene-centered crop of augmented TRAIN scenes to scene_bounds
    # (reference-family point_cloud_range): full z-rotation grows xy spans
    # by up to sqrt(2), past what grid_extent/_EXTENT_MARGIN cover — the
    # overhang otherwise falls out of the dense tail cell-wise (counted,
    # dense_tail_oob). Cropping whole points pre-voxelize keeps every
    # scale/mode consistent and shrinks GT with the geometry (data/gt.py).
    # Off by default: flipping it changes the train distribution, so
    # quality protocols must opt in explicitly (see BASELINE.md round-4).
    crop_to_bounds: bool = False


@dataclass(frozen=True)
class BackboneConfig:
    widths: Tuple[int, ...] = (16, 32, 48, 64)   # channels per scale
    blocks_per_scale: int = 1                    # residual blocks per scale
    kernel_size: int = 3
    dtype: str = "float32"                       # compute dtype: float32 | bfloat16
    # rematerialize residual blocks in backward (trade FLOPs for HBM —
    # matters at 2cm/262k-voxel capacities)
    remat: bool = False
    # default per-scale capacity decay: surface-like scenes lose only
    # ~1.4-2x sites per 2x downsample (not 8x), so halving overflows
    capacity_factor: float = 0.75
    # explicit voxel capacity per scale (len == len(widths)); None = the
    # capacity_factor decay above. Gather/sort cost scales with CAP, not
    # nvalid — size these to measured per-scale occupancy when throughput
    # matters (see BASELINE.md round-4 capacity sizing).
    capacities: Optional[Tuple[int, ...]] = None
    # Downsample operator between sparse scales (SURVEY.md C6 variants):
    # "conv" = k2s2 strided sparse conv (default); "maxpool"/"avgpool" =
    # sparse pooling over each coarse site's children (ops/pooling.py)
    # followed by a 1x1 channel projection.
    downsample: str = "conv"
    # feature dropout after each sparse block stack (SURVEY.md C8); 0 = off
    dropout: float = 0.0
    # Dense tail: from this scale on, the backbone runs MASKED DENSE 3D
    # convs on a [E/2^s]^3 grid instead of gather-GEMM sparse convs.
    # Occupancy at stride >= 4 is high enough that dense convs can beat
    # sparse gathers, and those scales then need no rulebooks at all
    # (models/unet.py::DenseTail). Mathematically
    # EQUIVALENT to the submanifold path (empty cells hold zero features;
    # outputs are re-masked to the active set) — tests/parity asserts it.
    # Requires grid_extent. None = fully sparse backbone.
    dense_from_scale: Optional[int] = None
    # stride-1 voxel-grid bounds [0, E) per axis for the dense tail; sites
    # outside are dropped from the dense grid (deterministic drop policy)
    grid_extent: Optional[Tuple[int, int, int]] = None
    # Per-MODE tail boundary: the TRAIN step runs with this dense_from_scale
    # while eval/inference keep `dense_from_scale` (None = same). The tail
    # boundary is an execution-strategy knob, not architecture — weights
    # convert exactly between forms (models/convert.py) — and the fastest
    # boundary can differ by direction. Checkpoints store the TRAIN form;
    # the eval step converts on the fly.
    dense_from_scale_train: Optional[int] = None


@dataclass(frozen=True)
class RPNConfig:
    hidden: int = 64
    num_proposals: int = 64               # P: static proposal budget after NMS
    pre_nms_topk: int = 256
    nms_iou_threshold: float = 0.35
    score_threshold: float = 0.1
    # box regression targets are (center offset, log size), normalized by
    # this many voxels at the RPN scale
    box_norm: float = 8.0
    rpn_scale: int = 0                    # decoder scale the RPN reads (0 = finest)
    # multi-scale RPN: decoder scales to attach heads to (None → (rpn_scale,));
    # proposals are pooled across scales before top-k + NMS
    rpn_scales: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class RoIConfig:
    grid_size: int = 7                    # D: RoI crop is D^3 samples
    expand: float = 1.2                   # box expansion before cropping
    hidden: int = 128
    mask_grid: int = 14                   # mask head output grid per RoI


@dataclass(frozen=True)
class ModelConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    roi: RoIConfig = field(default_factory=RoIConfig)
    num_classes: int = 18                 # ScanNet benchmark instance classes
    max_instances: int = 32               # GT instance capacity per scene
    use_semantic_head: bool = True        # auxiliary per-voxel semantic branch


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    optimizer: str = "adamw"              # adamw | sgd
    grad_clip: float = 10.0
    # EMA decay for an evaluation copy of the params (0 = off). Counters
    # the late-training detection-head drift seen on the hard synthetic
    # benchmark (BASELINE.md quality notes): eval/checkpoint selection
    # then score smoothed weights instead of the last noisy step.
    ema: float = 0.0
    # Accumulate gradients over k micro-batches before each optimizer
    # update (optax.MultiSteps, mean grads): reference-sized effective
    # batches (k x batch_size scenes) on one HBM-bound chip — the fused
    # 2cm train step caps batch_size at 2. total_steps / warmup_steps
    # stay in MICRO-steps (loader iterations); the LR schedule advances
    # once per optimizer update.
    grad_accum_steps: int = 1
    seed: int = 0
    log_every: int = 10
    eval_every: int = 500
    # Scenes per in-training eval (None = the whole val split). The
    # CANONICAL quality protocol evaluates the same fixed held-out set at
    # every eval point AND in the final eval.py pass — quality configs set
    # eval_scenes == val_scenes so no in-training number is ever quoted
    # from a different scene subset than the final one (round-3 verdict:
    # a 16- vs 32-scene split produced an 11-point mAP@0.5 gap).
    eval_scenes: Optional[int] = 16
    checkpoint_every: int = 500
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    loss_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    # (rpn_objectness, rpn_box, roi_cls, roi_mask)


@dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    num_devices: int = 0                  # 0 = all visible devices


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    name: str = "default"

    def scale_capacities(self) -> Tuple[int, ...]:
        caps = self.model.backbone.capacities
        if caps is not None:
            return tuple(caps)
        base = self.data.voxel_capacity
        f = self.model.backbone.capacity_factor
        return tuple(
            max(int(base * f ** s) + 127 & ~127, 128)
            for s in range(len(self.model.backbone.widths))
        )


def _update(dc, overrides: dict):
    """Recursively apply a nested dict of overrides to a (frozen) dataclass."""
    kwargs = {}
    for f in dataclasses.fields(dc):
        if f.name not in overrides:
            continue
        v = overrides[f.name]
        cur = getattr(dc, f.name)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kwargs[f.name] = _update(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    unknown = set(overrides) - {f.name for f in dataclasses.fields(dc)}
    if unknown:
        raise ValueError(f"Unknown config keys for {type(dc).__name__}: {sorted(unknown)}")
    return dataclasses.replace(dc, **kwargs)


# Augmentation headroom multipliers for extent derivation: in-plane z-axis
# rotation can swing a scene's rebased xy bounding box up to sqrt(2)x for a
# square room (the measured dense_tail_oob counters show only corner
# clipping at ~1.28x, so 1.3 covers practice), scale augmentation adds up
# to 1.1x; rotation never grows z, so z only carries the scale margin.
_EXTENT_MARGIN = (1.3, 1.3, 1.1)
_REBASE_CELLS = 4  # rebase_coords margin (integer cells at stride 1)


def derive_grid_extent(cfg: Config) -> Tuple[int, int, int]:
    """Smallest valid dense-tail grid extent covering data.scene_bounds.

    cells = ceil(bounds / voxel * margin) + rebase margin, rounded UP to
    the 2^(num_scales-1) divisibility the tail's down/up convs require.
    """
    bounds = cfg.data.scene_bounds
    if bounds is None:
        raise ValueError("derive_grid_extent needs data.scene_bounds")
    down = 1 << (len(cfg.model.backbone.widths) - 1)
    out = []
    for b, v, m in zip(bounds, cfg.data.voxel_size, _EXTENT_MARGIN):
        cells = int(-(-b * m // v)) + _REBASE_CELLS
        out.append(-(-cells // down) * down)
    return tuple(out)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Build a Config from defaults + optional YAML file + optional dict."""
    cfg = Config()
    if path:
        import yaml

        with open(path) as f:
            cfg = _update(cfg, yaml.safe_load(f) or {})
    if overrides:
        cfg = _update(cfg, overrides)
    bb = cfg.model.backbone
    if (bb.grid_extent is None and cfg.data.scene_bounds is not None
            and (bb.dense_from_scale is not None
                 or bb.dense_from_scale_train is not None)):
        # per-dataset extent sizing: derive from the data bounds instead of
        # hand-copying a grid size between configs
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone=dataclasses.replace(
                bb, grid_extent=derive_grid_extent(cfg))))
    _validate(cfg)
    return cfg


def _validate(cfg: Config) -> None:
    if cfg.train.grad_accum_steps < 1:
        raise ValueError("train.grad_accum_steps must be >= 1")
    roi = cfg.model.roi
    if roi.mask_grid != 2 * roi.grid_size:
        raise ValueError(
            f"roi.mask_grid ({roi.mask_grid}) must equal 2*roi.grid_size "
            f"({2 * roi.grid_size}): the mask head upsamples the RoI crop "
            "exactly once"
        )
    if cfg.model.rpn.rpn_scale >= len(cfg.model.backbone.widths):
        raise ValueError("rpn.rpn_scale out of range for backbone widths")
    caps = cfg.model.backbone.capacities
    if caps is not None:
        ns = len(cfg.model.backbone.widths)
        if len(caps) != ns:
            raise ValueError(
                f"backbone.capacities has {len(caps)} entries for "
                f"{ns} scales")
        if caps[0] != cfg.data.voxel_capacity:
            # scale 0 rows come straight from voxelize at voxel_capacity;
            # a different caps[0] would silently mis-account flops/buffers
            raise ValueError(
                f"backbone.capacities[0]={caps[0]} must equal "
                f"data.voxel_capacity={cfg.data.voxel_capacity}")
        for s, c in enumerate(caps):
            if c < 128 or c % 128:
                raise ValueError(
                    f"backbone.capacities[{s}]={c} must be a positive "
                    "multiple of 128 (sort/gather tiling)")
    if cfg.model.backbone.downsample not in ("conv", "maxpool", "avgpool"):
        raise ValueError(
            f"backbone.downsample must be conv|maxpool|avgpool, "
            f"got {cfg.model.backbone.downsample!r}"
        )
    if not 0.0 <= cfg.model.backbone.dropout < 1.0:
        raise ValueError("backbone.dropout must be in [0, 1)")
    dfs = cfg.model.backbone.dense_from_scale
    dfs_t = cfg.model.backbone.dense_from_scale_train
    for label, v in (("dense_from_scale", dfs),
                     ("dense_from_scale_train", dfs_t)):
        if v is None:
            continue
        ns = len(cfg.model.backbone.widths)
        if not 1 <= v <= ns - 1:
            raise ValueError(f"{label} {v} must be in [1, {ns - 1}]")
        ext = cfg.model.backbone.grid_extent
        if ext is None:
            raise ValueError(f"backbone.{label} requires backbone.grid_extent")
        down = 1 << (ns - 1)
        if any(e % down for e in ext):
            raise ValueError(
                f"grid_extent {ext} must be divisible by 2^(num_scales-1)={down}"
            )
    ext = cfg.model.backbone.grid_extent
    if (ext is not None and cfg.data.scene_bounds is not None
            and (dfs is not None or dfs_t is not None)):
        # explicit extent must cover the declared dataset bounds (fail at
        # load, not by silently cropping every scene on device)
        for i, (e, b, v) in enumerate(
                zip(ext, cfg.data.scene_bounds, cfg.data.voxel_size)):
            if e * v < b:
                raise ValueError(
                    f"grid_extent[{i}]={e} covers {e * v:.2f} m at voxel "
                    f"{v} but data.scene_bounds[{i}]={b} m — undersized "
                    "dense-tail grid (every scene would be cropped)")
        if (cfg.data.augment and cfg.data.rotate_z
                and not cfg.data.crop_to_bounds):
            # rotation grows xy spans by up to (|cos|+|sin|) = sqrt(2), and
            # scale_range by its upper bound — an extent sized to the raw
            # bounds then drops the overhang cell-wise at the dense scales
            # during train (counted in dense_tail_oob)
            import warnings

            s_hi = max(cfg.data.scale_range)
            for i in (0, 1):
                need = cfg.data.scene_bounds[i] * (2.0 ** 0.5) * s_hi
                e, v = ext[i], cfg.data.voxel_size[i]
                if e * v < need:
                    warnings.warn(
                        f"grid_extent[{i}]={e} covers {e * v:.2f} m but "
                        f"z-rotated (+scaled) train scenes can span "
                        f"{need:.2f} m — overhang cells are dropped from "
                        "the dense tail (dense_tail_oob). Set "
                        "data.crop_to_bounds: true or grow grid_extent.",
                        stacklevel=2)
                    break
    if dfs_t is not None and dfs_t != dfs:
        if dfs is None:
            raise ValueError(
                "dense_from_scale_train requires dense_from_scale (the eval "
                "form) to be set too")
        if cfg.model.backbone.downsample != "conv":
            raise ValueError(
                "dense_from_scale_train != dense_from_scale requires "
                "backbone.downsample='conv': pooling downsamples have no "
                "spatial kernels to convert across the tail boundary")
    for s in cfg.model.rpn.rpn_scales or ():
        if s >= len(cfg.model.backbone.widths):
            raise ValueError(f"rpn_scales entry {s} out of range")
    if dfs is not None:
        # pool_instance_labels consumes scales[s].down_idx for every scale
        # below the topmost RPN scale; dense-tail scales carry no rulebooks,
        # so an RPN scale above dense_from_scale would crash at trace time.
        # With a per-mode boundary BOTH forms must satisfy it (each step
        # builds its own hierarchy), so the minimum binds.
        bound = dfs if dfs_t is None else min(dfs, dfs_t)
        top_rpn = max(cfg.model.rpn.rpn_scales or (cfg.model.rpn.rpn_scale,))
        if top_rpn > bound:
            raise ValueError(
                f"max RPN scale ({top_rpn}) must be <= dense_from_scale "
                f"({bound}): scales past the dense tail have no down rulebooks"
            )
    if not 0.0 <= cfg.train.ema < 1.0:
        raise ValueError(f"train.ema ({cfg.train.ema}) must be in [0, 1)")
    for name, v in (("data.num_scenes", cfg.data.num_scenes),
                    ("data.val_scenes", cfg.data.val_scenes),
                    ("train.eval_scenes", cfg.train.eval_scenes)):
        # explicit 0 must error, not silently fall back to the default
        if v is not None and v < 1:
            raise ValueError(f"{name} must be >= 1 when set, got {v}")
