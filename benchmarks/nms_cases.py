"""Cases of the greedy 3D NMS kernel (``sparse_rcnn_tpu_torch/ops/nms.py``)
and the helpers that run it against its plain version.

``tests/test_torch_kernel_cuda.py`` holds the kernel to ``nms_3d_reference``
on these cases on the card, bit for bit on ``keep_idx`` and ``keep_mask``,
and ``chip_smoke.py`` phase 3 does the same and times select's shapes.
``tests/test_torch_nms.py`` checks the cases themselves on the CPU. Imports
no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from sparse_rcnn_tpu_torch.ops import nms as PN

THRESHOLD = 0.35            # every config's nms_iou_threshold

# (name, scenes, candidates N, outputs P, kind). "scene": proposals jittered around a
# dozen instances with a few boxes of background, scores sorted as select passes them
# (the last 5 % invalid), select's shape at configs 2-5 and at config 1; "ragged": N not
# a multiple of 32; "wide", "widest": N past the block of 256 threads (4 and 16
# candidates a thread; the widest needs more than 48 KB of shared memory); "unsorted":
# scores in no order, a quarter invalid; "ties": scores rounded to 0.1 and a +inf;
# "identical": groups of identical boxes with tied scores; "invalid": no valid
# candidate; "few": 10 valid candidates for 128 outputs; "ulp": IoUs of exactly the
# threshold as a float and one ulp either side of it; "prod": a pair whose IoU is the
# threshold (given as that IoU) only when the intersection's extents multiply as
# torch.prod multiplies them on the card; "nan_score": a valid NaN score in scene 0 (it
# wins every argmax, so nothing is kept) and an invalid one in scene 1 (ignored);
# "nan_box": a NaN corner among the boxes.
NMS_CASES = [
    ("select", 2, 512, 128, "scene"),
    ("config1", 1, 128, 32, "scene"),
    ("batch3", 3, 256, 64, "scene"),
    ("ragged", 2, 77, 20, "unsorted"),
    ("wide", 2, 1000, 300, "unsorted"),
    ("widest", 1, 4000, 64, "scene"),
    ("unsorted", 2, 512, 128, "unsorted"),
    ("ties", 2, 512, 128, "ties"),
    ("identical", 2, 96, 40, "identical"),
    ("invalid", 2, 512, 128, "invalid"),
    ("few", 2, 512, 128, "few"),
    ("ulp", 1, 12, 12, "ulp"),
    ("prod", 1, 8, 8, "prod"),
    ("nan_score", 2, 64, 16, "nan_score"),
    ("nan_box", 1, 64, 32, "nan_box"),
]


def iou_f32(a: np.ndarray, b: np.ndarray, order=(0, 2, 1)) -> np.float32:
    """IoU of boxes ``a`` and ``b`` (float32 [6]) in float32, one rounding an
    operation, as the kernel and ``box_iou_3d`` on the card compute it; the
    intersection's extents multiplied in ``order`` (the card's by default)."""
    f = np.float32
    e = np.maximum(np.minimum(a[3:], b[3:]) - np.maximum(a[:3], b[:3]), f(0))
    inter = (e[order[0]] * e[order[1]]) * e[order[2]]
    va, vb = ((d[0] * d[1]) * d[2] for d in (np.maximum(x[3:] - x[:3], f(0)) for x in (a, b)))
    return inter / np.maximum((va + vb) - inter, f(1e-9))


def scene_boxes(rng, n: int, span: float = 400.0) -> np.ndarray:
    """[n, 6] float32 proposals: jittered copies of a dozen instance boxes
    of 20-100 voxels across a scene of ``span`` voxels, every tenth a box
    of the background."""
    lo = rng.uniform(0, span - 100, (12, 3))
    inst = np.concatenate([lo, lo + rng.uniform(20, 100, (12, 3))], 1)
    pick = inst[rng.integers(0, 12, n)]
    size = pick[:, 3:] - pick[:, :3]
    center = (pick[:, 3:] + pick[:, :3]) / 2 + rng.normal(0, 0.1, (n, 3)) * size
    size = size * np.exp(rng.normal(0, 0.2, (n, 3)))
    boxes = np.concatenate([center - size / 2, center + size / 2], 1)
    bg = np.arange(n) % 10 == 9
    blo = rng.uniform(0, span - 60, (int(bg.sum()), 3))
    boxes[bg] = np.concatenate([blo, blo + rng.uniform(5, 60, blo.shape)], 1)
    return boxes.astype(np.float32)


def _near_threshold_pairs(thr: float) -> list:
    """Heights (a, z) of boxes [0,0,0,1,1,a] ⊃ [0,0,0,1,1,z] whose IoU in
    float32 is the float32 below ``thr``'s float32, that float32, and the one
    above (a fixed search, the same in every run)."""
    f = np.float32
    t = f(thr)
    targets = (np.nextafter(t, f(0)), t, np.nextafter(t, f(1)))
    rng = np.random.default_rng(1)
    a = rng.uniform(1, 2, 100000).astype(f)
    z = (a.astype(np.float64) * thr * (1 + rng.uniform(-1e-6, 1e-6, a.size))).astype(f)
    iou = z / np.maximum((a + z) - z, f(1e-9))
    return [(a[i], z[i]) for i in (int(np.flatnonzero(iou == w)[0]) for w in targets)]


def _prod_pair() -> tuple:
    """Two boxes whose IoU in float32 is larger with the card's order of the
    intersection's products than with either other order (a fixed search)."""
    rng = np.random.default_rng(2)
    for _ in range(100000):
        a = rng.uniform(0, 3, 3)
        a = np.concatenate([a, a + rng.uniform(1, 3, 3)]).astype(np.float32)
        b = (a + rng.uniform(-0.8, 0.8, 6)).astype(np.float32)
        card = iou_f32(a, b)
        if all(card > iou_f32(a, b, o) for o in ((0, 1, 2), (1, 2, 0))):
            return a, b, float(card)
    raise RuntimeError("no pair found whose IoU depends on the order of the products")


def _spread(pairs: list, n: int, rng) -> np.ndarray:
    """The pairs' boxes 10 units apart along x, then far-off unit boxes to ``n``."""
    out = []
    for k, (a, b) in enumerate(pairs):
        shift = np.float32(10 * k) * np.array([1, 0, 0, 1, 0, 0], np.float32)
        out += [a + shift, b + shift]
    lo = np.float32(1000) + np.arange(n - len(out), dtype=np.float32)[:, None] * 5
    out += list(np.concatenate([lo.repeat(3, 1), lo.repeat(3, 1) + 1], 1))
    return np.stack(out).astype(np.float32)


def nms_case(name: str, device, seed: int = 0) -> dict:
    """Case ``name`` of :data:`NMS_CASES` on ``device``: ``boxes`` f32 [B, N,
    6], ``scores`` f32 [B, N], ``valid`` bool [B, N], ``threshold`` (a
    Python float) and ``p``; ``pairs`` the indices of the "ulp" case's
    pairs."""
    _, b, n, p, kind = next(c for c in NMS_CASES if c[0] == name)
    rng = np.random.default_rng(seed)
    f = np.float32
    boxes = np.stack([scene_boxes(rng, n) for _ in range(b)])
    scores = rng.normal(size=(b, n)).astype(f)
    valid = np.ones((b, n), bool)
    thr, extra = THRESHOLD, {}
    if kind == "scene":
        scores = -np.sort(-scores, axis=1)
        valid[:, int(0.95 * n):] = False
    elif kind in ("unsorted", "nan_box"):
        valid = rng.random((b, n)) >= 0.25
        if kind == "nan_box":
            boxes[0, 5, 3] = np.nan
            boxes[0, 9, 1] = np.nan
    elif kind == "ties":
        scores = np.round(rng.uniform(0, 1, (b, n)), 1).astype(f)
        scores[0, 7] = np.inf
        valid = rng.random((b, n)) >= 0.1
    elif kind == "identical":
        boxes = boxes[:, rng.integers(0, 6, n)]          # six boxes, each many times
        scores = np.round(rng.uniform(0, 1, (b, n)), 1).astype(f)
    elif kind == "invalid":
        valid[:] = False
    elif kind == "few":
        valid[:] = False
        valid[:, rng.choice(n, 10, replace=False)] = True
    elif kind == "ulp":
        one, zero = f(1), f(0)
        pairs = [(np.array([zero, zero, zero, one, one, a], f),
                  np.array([zero, zero, zero, one, one, z], f))
                 for a, z in _near_threshold_pairs(THRESHOLD)]
        boxes = _spread(pairs, n, rng)[None]
        scores = np.linspace(1, 0, n, dtype=f)[None]     # each pair's outer box first
        extra["pairs"] = [(2 * k, 2 * k + 1) for k in range(len(pairs))]
    elif kind == "prod":
        a, bx, thr = _prod_pair()
        boxes = _spread([(a, bx)], n, rng)[None]
        scores = np.linspace(1, 0, n, dtype=f)[None]
        extra["pairs"] = [(0, 1)]
    elif kind == "nan_score":
        scores[0, 11] = np.nan
        scores[1, 3] = np.nan
        valid[1, 3] = False
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in (("boxes", boxes), ("scores", scores), ("valid", valid))}
    return {**t, "threshold": thr, "p": p, **extra}


def run_plain(c: dict) -> tuple:
    """``nms_3d_reference`` scene by scene, stacked: what ``select_proposals``
    ran before the kernel."""
    kept = [PN.nms_3d_reference(bx, s, v, c["threshold"], c["p"])
            for bx, s, v in zip(c["boxes"], c["scores"], c["valid"])]
    return torch.stack([k[0] for k in kept]), torch.stack([k[1] for k in kept])


def run_kernel(c: dict) -> tuple:
    return PN.nms_3d_kernel(c["boxes"], c["scores"], c["valid"], c["threshold"], c["p"])


def pair_ious(c: dict) -> list:
    """``box_iou_3d`` of each pair of ``c["pairs"]`` on the case's device,
    as Python floats (the float32 values)."""
    bx = c["boxes"][0]
    return [float(PN.box_iou_3d(bx[i:i + 1], bx[j:j + 1])[0, 0]) for i, j in c["pairs"]]
