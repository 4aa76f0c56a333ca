"""Weights from the seed, made on the device in one draw.

The rule is a frozen copy of ``sparse_rcnn_tpu_torch/models/layers.py::
init_params`` at commit 4dd78ef: sparse kernels He normal over fan_in =
K·Cin; linear and conv weights normal with variance 1/fan_in (a transposed
conv's fan_in is its first dimension times one filter); biases 0; batch
norm scale 1, bias 0, running mean 0, running variance 1. The draw is one
``torch.randn`` from a generator on the device, cut into the tensors in
the order of ``model.named_modules()``, so one seed gives one set of
weights. The port's model supplies only the names and shapes; the
reference loads the same dictionary.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn


def _rule(mod: nn.Module):
    """(name of the drawn weight or None, its std, entries set to 0,
    entries set to 1) of one module, or None."""
    kind = type(mod).__name__
    if kind == "SparseConv":
        k, cin, _ = mod.kernel.shape
        return "kernel", math.sqrt(2.0 / (k * cin)), ("bias",), ()
    if kind == "MaskedBatchNorm":
        return None, 0.0, ("bias", "mean"), ("scale", "var")
    if isinstance(mod, (nn.Linear, nn.Conv3d, nn.ConvTranspose3d)):
        w = mod.weight
        fan_in = (w.shape[0] * w[0, 0].numel() if isinstance(mod, nn.ConvTranspose3d)
                  else w[0].numel())
        return "weight", math.sqrt(1.0 / fan_in), ("bias",), ()
    return None


def seeded_state_dict(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's state dict (parameters and buffers) drawn from ``seed``."""
    sd = {k: torch.empty_like(v, device=device) for k, v in model.state_dict().items()}
    normals = []
    for name, mod in model.named_modules():
        rule = _rule(mod)
        if rule is None:
            continue
        wname, std, zeros, ones = rule
        pre = f"{name}." if name else ""
        if wname is not None:
            normals.append((pre + wname, std))
        for z in zeros:
            if pre + z in sd:
                sd[pre + z].zero_()
        for o in ones:
            if pre + o in sd:
                sd[pre + o].fill_(1.0)
    total = sum(sd[k].numel() for k, _ in normals)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, 104729]).generate_state(1)[0]))
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    at = 0
    for k, std in normals:
        n = sd[k].numel()
        sd[k].copy_(draw[at:at + n].view_as(sd[k]) * std)
        at += n
    left = [k for k, v in sd.items() if v.is_floating_point()
            and k not in dict(normals) and not _set_by_rule(k, model)]
    if left:
        raise ValueError(f"no init rule for {left}")
    return sd


def _set_by_rule(key: str, model: nn.Module) -> bool:
    mod_name, _, leaf = key.rpartition(".")
    rule = _rule(model.get_submodule(mod_name) if mod_name else model)
    return rule is not None and (leaf in rule[2] or leaf in rule[3])
