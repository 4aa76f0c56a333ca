"""Useful FLOPs and the sparse-conv kernels' bound, from rulebook counts.

``useful_forward_flops`` is a frozen copy of
``sparse_rcnn_tpu_torch/utils/flops.py::useful_forward_flops`` at commit
4dd78ef (the JAX package's formula, term for term): for every conv
``2 · realized pairs · Cin · Cout``, the dense tail counted as its
submanifold equivalent, the heads at their static shapes. The counts
(``sites``, ``subm_pairs``, ``down_pairs`` per scale, over the batch) come
from the reference's own rulebooks (``reference/stats.py``), never from the
port.

``sparse_convs`` lists the convs the port runs on its sparse-conv kernels
(``ops/csrc/sparse_conv.cu``) and :func:`conv_bound_s` gives each launch's
least time on one H100 SXM: the larger of bytes over 3.35 TB/s, each byte
counted once (input rows read, weights, index entries of the live rows,
output rows written), and live-pair FLOPs over 989 TFLOP/s in bf16 or
67 TFLOP/s in f32 (the bound arithmetic of ``chip_smoke.py``'s kernel
tables, frozen here).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BPS = 3.35e12


def useful_forward_flops(cfg, stats: Dict[str, List[int]]) -> float:
    """Sparse-equivalent forward FLOPs of one batch."""
    mc = cfg.model
    ws = mc.backbone.widths
    ns = len(ws)
    bps = mc.backbone.blocks_per_scale
    sites = stats["sites"]
    sp = stats["subm_pairs"]
    dp = stats["down_pairs"]

    def conv(pairs, cin, cout):
        return 2.0 * pairs * cin * cout

    f = 0.0
    f += conv(sp[0], cfg.data.num_features, ws[0])          # stem
    for s in range(ns):                                      # encoder
        for _ in range(bps):
            f += conv(sp[s], ws[s], ws[s]) * 2               # conv1 + conv2
        if s < ns - 1:
            f += conv(dp[s], ws[s], ws[s + 1])               # down
    for s in range(ns - 2, -1, -1):                          # decoder
        f += conv(dp[s], ws[s + 1], ws[s])                   # up (t(up) = down)
        cin = 2 * ws[s]                                      # skip concat
        f += conv(sp[s], cin, ws[s]) + conv(sp[s], ws[s], ws[s])
        f += conv(sites[s], cin, ws[s])                      # 1-tap proj
        for _ in range(bps - 1):
            f += conv(sp[s], ws[s], ws[s]) * 2
    h = mc.rpn.hidden
    for s in mc.rpn.rpn_scales or (mc.rpn.rpn_scale,):
        f += 2.0 * sites[s] * (ws[s] * h + h * h + h * 7)
    b = cfg.data.batch_size
    p = mc.rpn.num_proposals
    d3 = mc.roi.grid_size ** 3
    rh = mc.roi.hidden
    rois = float(b * p)
    f += 2.0 * rois * d3 * 27 * (ws[0] * rh + rh * rh)       # conv1 + conv2
    f += 2.0 * rois * d3 * 8 * rh * rh                       # 2x2x2 up
    f += 2.0 * rois * (2 * mc.roi.grid_size) ** 3 * rh       # mask 1x1x1
    f += 2.0 * rois * (rh * rh + rh * (mc.num_classes + 1))  # cls MLP
    if mc.use_semantic_head:
        f += 2.0 * sites[0] * (ws[0] * 64 + 64 * (mc.num_classes + 1))
    return float(f)


def train_step_flops(cfg, stats) -> float:
    """A train step: three times the forward (forward, dgrad, wgrad), less
    the stem's dgrad, which the port skips (its input needs no gradient)."""
    stem = 2.0 * stats["subm_pairs"][0] * cfg.data.num_features * cfg.model.backbone.widths[0]
    return 3.0 * useful_forward_flops(cfg, stats) - stem


def sparse_convs(cfg, n_sparse: int, stats) -> List[Tuple[str, int, int, int, int, int, int]]:
    """(name, taps, cin, cout, rows in, rows out, pairs) of every conv of the
    backbone that runs on the sparse-conv kernels when the dense tail starts
    at scale ``n_sparse`` (the number of scales when there is none): the
    stem, the encoder and decoder blocks of the sparse scales, their down
    convs (into the tail's first scale too) and up convs, and the 1-tap
    projections. Every conv is the model's one launch over the batch."""
    bb = cfg.model.backbone
    ws, ns, bps, k = bb.widths, len(bb.widths), bb.blocks_per_scale, bb.kernel_size ** 3
    sites, sp, dp = stats["sites"], stats["subm_pairs"], stats["down_pairs"]
    out = [("stem", k, cfg.data.num_features, ws[0], sites[0], sites[0], sp[0])]
    for s in range(n_sparse):
        for b in range(bps):
            out.append((f"enc{s}_block{b}.conv1", k, ws[s], ws[s], sites[s], sites[s], sp[s]))
            out.append((f"enc{s}_block{b}.conv2", k, ws[s], ws[s], sites[s], sites[s], sp[s]))
        if s < ns - 1:
            out.append((f"down{s}", 8, ws[s], ws[s + 1], sites[s], sites[s + 1], dp[s]))
    dec_top = n_sparse - 1 if n_sparse < ns else ns - 2
    for s in range(dec_top, -1, -1):
        out.append((f"up{s}", 8, ws[s + 1], ws[s], sites[s + 1], sites[s], dp[s]))
        cin = 2 * ws[s]
        for b in range(bps):
            out.append((f"dec{s}_block{b}.conv1", k, cin, ws[s], sites[s], sites[s], sp[s]))
            out.append((f"dec{s}_block{b}.conv2", k, ws[s], ws[s], sites[s], sites[s], sp[s]))
            if cin != ws[s]:
                out.append((f"dec{s}_block{b}.proj", 1, cin, ws[s], sites[s], sites[s],
                            sites[s]))
            cin = ws[s]
    return out


def conv_bound_s(role: str, taps: int, cin: int, cout: int, rows_in: int, rows_out: int,
                 pairs: int, elem: int = 2) -> float:
    """The least time of one launch of ``role``: ``fwd`` (feats, W, idx of
    the output rows → out), ``dgrad`` (g, Wᵀ, idx of the input rows →
    d_feats) or ``wgrad`` (feats, g, idx of the input rows → f32 d_W);
    ``elem`` bytes an activation and weight entry (2 for bf16)."""
    w = taps * cin * cout
    if role == "fwd":
        nbytes = rows_in * cin * elem + w * elem + taps * rows_out * 4 + rows_out * cout * elem
    elif role == "dgrad":
        nbytes = rows_out * cout * elem + w * elem + taps * rows_in * 4 + rows_in * cin * elem
    elif role == "wgrad":
        nbytes = rows_in * cin * elem + rows_out * cout * elem + taps * rows_in * 4 + w * 4
    else:
        raise ValueError(role)
    peak = PEAK_BF16 if elem == 2 else PEAK_F32
    return max(nbytes / HBM_BPS, 2.0 * pairs * cin * cout / peak)


def step_conv_bound_s(cfg, n_sparse: int, stats, train: bool) -> float:
    """Σ bound of one step's sparse-conv launches: the forwards, and in
    training every dgrad but the stem's and every wgrad."""
    elem = 2 if cfg.model.backbone.dtype == "bfloat16" else 4
    total = 0.0
    for name, *shape in sparse_convs(cfg, n_sparse, stats):
        total += conv_bound_s("fwd", *shape, elem=elem)
        if train:
            if name != "stem":
                total += conv_bound_s("dgrad", *shape, elem=elem)
            total += conv_bound_s("wgrad", *shape, elem=elem)
    return total
