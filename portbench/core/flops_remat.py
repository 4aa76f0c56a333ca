"""The sparse-conv kernels' bound in a train step whose residual blocks are
rematerialised (``model.backbone.remat``).

With remat the port runs every residual block's forward again in the
backward (``sparse_rcnn_tpu_torch/models/layers.py::remat``), so the traced
``sparse_conv_fwd_kernel`` time holds those forwards beside the step's own.
:func:`remat_convs` lists them: the conv1, conv2 and 1-tap projection of
every encoder and decoder block at the sparse scales, as
:func:`.flops.sparse_convs` lists them (the stem, the down and the up convs
are not in a block, and the dense tail's blocks run on cuDNN).
:func:`step_conv_bound_remat_s` is :func:`.flops.step_conv_bound_s` of the
train step plus each recomputed forward's bound, by the same per-conv
arithmetic (:func:`.flops.conv_bound_s`).
"""

from __future__ import annotations

from typing import List, Tuple

from .flops import conv_bound_s, sparse_convs, step_conv_bound_s


def remat_convs(cfg, n_sparse: int, stats) -> List[Tuple[str, int, int, int, int, int, int]]:
    """The convs whose forward a train step runs again in its backward:
    (name, taps, cin, cout, rows in, rows out, pairs) as
    :func:`.flops.sparse_convs` gives them; none without remat."""
    if not cfg.model.backbone.remat:
        return []
    return [c for c in sparse_convs(cfg, n_sparse, stats) if "_block" in c[0]]


def step_conv_bound_remat_s(cfg, n_sparse: int, stats) -> float:
    """Σ bound of one train step's sparse-conv launches, the recompute's
    forwards counted as work done."""
    elem = 2 if cfg.model.backbone.dtype == "bfloat16" else 4
    return (step_conv_bound_s(cfg, n_sparse, stats, train=True)
            + sum(conv_bound_s("fwd", *shape, elem=elem)
                  for _, *shape in remat_convs(cfg, n_sparse, stats)))
