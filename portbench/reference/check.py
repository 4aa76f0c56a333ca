"""The comparisons that decide ``correct``, and the reference runs they read.

Training (:func:`train_reference`, :func:`train_numbers`): the reference
builds the same model in float32 (TF32 off), loads the run's initial
weights, works out the first three batches of the train stream again from
the scene files (``batches.py``) and takes three steps of plain AdamW. The
numbers compared, each against its limit (``limits/<cell>.json``):

- ``batch_diff``: entries of the three batches that differ from the
  program's Loader (exact: limit 0);
- ``loss_gap``: the largest relative gap of a step's total loss;
- ``grad_gap``: by the worst parameter, the gap between the norms of the
  first clipped gradient (the program's worked out from its Adam moment
  after one step, ``mu / (1 - b1)``) over the reference's norm of that
  parameter or of the median parameter, whichever is larger;
- ``change_gap``: the same for the parameters' change over the three
  steps, leaving out the parameters whose reference gradient is under a
  thousandth of the median parameter's (they move by round-off alone).

Served answers (:func:`eval_reference`, :func:`answer_numbers`): the
reference answers a sample of the scenes the program answered. Which
proposals the top-k and NMS keep turns on rounding at seeded weights (the
objectness is nearly flat), so the reference follows the program by
stages: it checks the program's per-site RPN outputs against its own,
selects the proposals again from the program's RPN outputs, and runs its
own RoI crop, heads and painting on those proposals.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from . import precision_mode
from .batches import train_batches
from .srcnn.train import loop as RL

B1 = 0.9
SURE = 0.1      # mask_disagree: the pairs whose reference logit is this far from 0


def leaf_norms(tensors) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.detach().to(torch.float64)))
                     for t in tensors])


@torch.no_grad()
def _to_device(batch, device):
    return {k: torch.as_tensor(batch[k], device=device) for k in RL.TRAIN_KEYS}


def train_reference(cfg, init_state: Dict[str, torch.Tensor], seed: int, device,
                    steps: int = 3, mode: str = "f32", drop_half: bool = False) -> dict:
    """``steps`` reference steps from ``init_state`` over the first batches
    of the train stream of ``seed``. ``mode`` "fp8" is the control;
    ``drop_half`` leaves out the second half of each batch (a fault)."""
    precision_mode(mode)
    cfg32 = RL.as_float32(RL.train_cfg(cfg))
    batches = train_batches(cfg, seed, steps)
    model = RL.build_model(cfg32, device)
    model.load_state_dict({k: v.to(device) for k, v in init_state.items()})
    params = list(model.parameters())
    p0 = [p.detach().clone() for p in params]
    opt = RL.AdamW(cfg32, params)
    losses, grad_norms = [], None
    for t, hb in enumerate(batches):
        if drop_half:
            half = max(1, len(hb["valid"]) // 2)
            run_cfg = _with_batch(cfg32, half)
            hb = {k: v[:half] for k, v in hb.items()}
        else:
            run_cfg = cfg32
        total, _, grads, _ = RL.loss_and_grads(run_cfg, model, _to_device(hb, device))
        clipped, _ = opt.step(params, grads)
        losses.append(float(total))
        if t == 0:
            grad_norms = leaf_norms(clipped)
        del grads, clipped
    change = leaf_norms([p - q for p, q in zip(params, p0)])
    out = {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
           "batches": batches}
    del model, params, p0, opt
    gc.collect()
    torch.cuda.empty_cache() if torch.device(device).type == "cuda" else None
    precision_mode("f32")
    return out


def _with_batch(cfg, b: int):
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=b))


def worst_leaf_gap(prog: np.ndarray, ref: np.ndarray,
                   keep: Optional[np.ndarray] = None) -> float:
    """max over leaves of |prog − ref| / max(ref, median ref)."""
    if keep is None:
        keep = np.ones(len(ref), bool)
    med = float(np.median(ref[keep]))
    den = np.maximum(ref, med)
    gaps = np.abs(prog - ref) / np.where(den > 0, den, 1.0)
    return float(np.max(gaps[keep]))


def moved_leaves(ref_grad_norms: np.ndarray) -> np.ndarray:
    """Leaves whose reference gradient is at least a thousandth of the median's."""
    return ref_grad_norms >= 1e-3 * float(np.median(ref_grad_norms))


def batch_diff(prog_batches: List[dict], ref_batches: List[dict]) -> int:
    """Entries of the program's batches that differ from the reference's."""
    n = 0
    for pb, rb in zip(prog_batches, ref_batches):
        for k in RL.TRAIN_KEYS:
            a, b = np.asarray(pb[k]), np.asarray(rb[k])
            n += a.size if a.shape != b.shape else int(np.sum(a != b))
    return n + abs(len(prog_batches) - len(ref_batches))


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared, from the program's readings (``losses``,
    ``grad_norms``, ``change_norms``, ``batches``) and the reference's."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    keep = moved_leaves(ref["grad_norms"])
    out = {
        "loss_gap": float(np.max(np.abs(lp - lr) / np.abs(lr))),
        "grad_gap": worst_leaf_gap(prog["grad_norms"], ref["grad_norms"]),
        "change_gap": worst_leaf_gap(prog["change_norms"], ref["change_norms"], keep),
    }
    if prog.get("batches") is not None:
        out["batch_diff"] = float(batch_diff(prog["batches"], ref["batches"]))
    return out


# --------------------------------------------------------------------------
# served answers: per-proposal masks, scores and classes; per-point labels


def decode(out: Dict[str, np.ndarray], b: int, num_classes: int) -> dict:
    """Scene ``b`` of eval-step outputs (host arrays) as an answer:
    ``masks`` bool [P, N] (the packed bits unpacked, else the logits above
    0), ``scores`` (the best foreground class probability times the sigmoid
    of the objectness), ``cls``, ``pmask`` and, with the semantic head,
    ``sem``, each point's semantic class: the rule of the port's
    ``train/evaluate.py::postprocess_scene`` at commit 4dd78ef, written
    again in numpy. Besides: ``cls_logits`` and ``obj`` (the proposals'
    objectness logits) as they came, and, where the outputs hold the point
    mask logits, ``inside`` (the points inside each proposal's crop box)."""
    cls_logits = np.asarray(out["cls_logits"][b], np.float64)
    prob = np.exp(cls_logits - cls_logits.max(-1, keepdims=True))
    fg = (prob / prob.sum(-1, keepdims=True))[:, :num_classes]
    obj = np.asarray(out["proposal_scores"][b])
    sig = 1 / (1 + np.exp(-np.clip(obj.astype(np.float64), -30, 30)))
    if "point_mask_bits" in out:
        n = int(out["point_mask_n"])
        masks = np.unpackbits(np.asarray(out["point_mask_bits"][b]), axis=-1)[:, :n] > 0
    else:
        masks = np.asarray(out["point_mask_logits"][b]) > 0
    ans = {"masks": masks, "scores": fg.max(-1) * sig, "cls": fg.argmax(-1),
           "pmask": np.asarray(out["proposal_mask"][b]).astype(bool),
           "cls_logits": cls_logits, "obj": obj}
    if "point_mask_logits" in out:
        ans["mask_logits"] = np.asarray(out["point_mask_logits"][b])
        ans["inside"] = ans["mask_logits"] > -1e8
    if "point_semantic_pred" in out:
        ans["sem"] = np.asarray(out["point_semantic_pred"][b])
    return ans


def rpn_scene(rpn: List[Dict[str, np.ndarray]], b: int) -> List[Dict[str, np.ndarray]]:
    """Scene ``b`` of per-scale RPN outputs, a batch of one."""
    return [{k: v[b:b + 1] for k, v in s.items()} for s in rpn]


def paint(masks: np.ndarray, scores: np.ndarray, pmask: np.ndarray) -> np.ndarray:
    """Per-point instance labels by ``infer.py::scene_result``'s rule:
    valid proposals paint in descending score order, each point keeping the
    rank of the first that claims it (-1: none)."""
    inst = np.full(masks.shape[-1], -1, np.int32)
    for rank, p in enumerate(np.argsort(-scores)):
        if pmask[p]:
            sel = masks[p] & (inst < 0)
            inst[sel] = rank
    return inst


def eval_reference(cfg, init_state: Dict[str, torch.Tensor], batches: List[dict], device,
                   mode: str = "f32", follow: Optional[List[list]] = None) -> List[dict]:
    """The reference's answer (:func:`decode` of its float32 logits, with
    ``rpn``, its per-scale RPN outputs) to each scene of each host batch
    (``points``, ``feats``, ``valid``): the model in the eval form, its
    weights converted from the train form as ``models/convert.py``
    converts them. ``follow`` (per batch, the program's per-scale RPN
    outputs as :class:`~portbench.core.capture.RpnCapture` keeps them):
    the proposals are selected from those instead of its own."""
    from .srcnn.models.convert import convert_variables
    precision_mode(mode)
    cfg32 = RL.as_float32(cfg)
    model = RL.build_model(cfg32, device)
    state = {k: v.to(device) for k, v in init_state.items()}
    bb = cfg.model.backbone
    train_form = bb.dense_from_scale if bb.dense_from_scale_train is None \
        else bb.dense_from_scale_train
    if train_form != bb.dense_from_scale:
        state = convert_variables(state, bb.dense_from_scale)
    model.load_state_dict(state)
    answers = []
    for j, hb in enumerate(batches):
        dev = {k: torch.as_tensor(hb[k], device=device) for k in RL.BATCH_KEYS}
        sel = None
        if follow is not None:
            sel = tuple(torch.cat([torch.as_tensor(s[k], device=device) for s in follow[j]], 1)
                        for k in ("obj", "boxes", "mask"))
        out = RL.eval_step(cfg32, model, dev, select_from=sel)
        host = {k: out[k].cpu().numpy() for k in ("proposal_mask", "cls_logits",
                                                   "proposal_scores", "point_mask_logits",
                                                   "point_semantic_pred") if k in out}
        rpn = [{"obj": o.cpu().numpy(), "boxes": bx.cpu().numpy(), "deltas": d.cpu().numpy(),
                "mask": m.cpu().numpy()} for o, bx, d, m in
               zip(out["rpn_obj"], out["rpn_boxes"], out["rpn_deltas"], out["rpn_mask"])]
        del out, sel
        for b in range(len(hb["valid"])):
            ans = decode(host, b, cfg.model.num_classes)
            ans["rpn"] = rpn_scene(rpn, b)
            answers.append(ans)
    del model, state
    gc.collect()
    precision_mode("f32")
    return answers


def nrmse(p: np.ndarray, r: np.ndarray) -> float:
    """Root mean square of ``p - r`` over the standard deviation of ``r``
    (0 for no entries)."""
    if r.size == 0:
        return 0.0
    p, r = p.astype(np.float64), r.astype(np.float64)
    sd = float(r.std())
    return float(np.sqrt(np.mean((p - r) ** 2)) / (sd if sd > 0 else 1.0))


def rpn_gap(prog: list, ref: list) -> float:
    """The worst, over scales and channels (objectness and each of the six
    box deltas), of :func:`nrmse` at the sites valid on either side (a site
    valid on one side only reads the other's -1e9 objectness)."""
    worst = 0.0
    for p, r in zip(prog, ref):
        v = p["mask"][0].astype(bool) | r["mask"][0].astype(bool)
        chans = [(p["obj"][0][v], r["obj"][0][v])]
        chans += [(p["deltas"][0][v][:, c], r["deltas"][0][v][:, c]) for c in range(6)]
        worst = max([worst] + [nrmse(a, b) for a, b in chans])
    return worst


def answer_numbers(prog: List[dict], ref: List[dict], valid: List[np.ndarray]) -> dict:
    """The numbers compared for served answers, the worst over the sample;
    ``ref`` is the reference following the program's RPN outputs:

    - ``semantic_disagree``: the share of valid points whose semantic class
      differs from the reference's (the backbone and the semantic head,
      point by point);
    - ``rpn_gap``: the program's per-site RPN outputs against the
      reference's own (the backbone and the RPN heads; :func:`rpn_gap`);
    - ``select_diff``: the proposals' objectness and validity entries that
      differ from the reference's selection, by top-k and NMS, from the
      program's RPN outputs (exact);
    - ``cls_gap``: :func:`nrmse` of the valid proposals' class logits
      against the reference's on the same proposals (the RoI crop and the
      class head);
    - ``mask_disagree``: the share of (valid proposal, valid point inside
      its crop box) pairs whose mask bit differs from the reference's on the
      same proposals (the crop, the mask head and the painting), over the
      pairs whose reference logit lies at least ``SURE`` times the pairs'
      root mean square logit from 0: at seeded weights many logits lie so
      near 0 that rounding flips their bit, in bf16 as in fp8;
    - ``label_mismatch``, where the program answered per-point instance
      labels (``inst``): the points whose label differs from :func:`paint`
      of the program's own masks and scores (the host stage: exact)."""
    out = {k: 0.0 for k in ("semantic_disagree", "rpn_gap", "select_diff", "cls_gap",
                            "mask_disagree")}
    for p, r, v in zip(prog, ref, valid):
        out["semantic_disagree"] = max(out["semantic_disagree"],
                                       float(np.mean(p["sem"][v] != r["sem"][v])))
        out["rpn_gap"] = max(out["rpn_gap"], rpn_gap(p["rpn"], r["rpn"]))
        out["select_diff"] += float(np.sum(p["obj"] != r["obj"])
                                    + np.sum(p["pmask"] != r["pmask"]))
        keep = p["pmask"] & r["pmask"]
        out["cls_gap"] = max(out["cls_gap"], nrmse(p["cls_logits"][keep],
                                                   r["cls_logits"][keep]))
        pairs = keep[:, None] & r["inside"] & v[None, :]
        lg = r["mask_logits"][pairs].astype(np.float64)
        if lg.size:
            sure = np.abs(lg) >= SURE * np.sqrt(np.mean(lg ** 2))
            out["mask_disagree"] = max(out["mask_disagree"], float(
                np.mean(p["masks"][pairs][sure] != r["masks"][pairs][sure])))
    if all("inst" in p for p in prog):
        out["label_mismatch"] = float(sum(
            int(np.sum(p["inst"] != paint(p["masks"], p["scores"], p["pmask"])))
            for p in prog))
    return out
