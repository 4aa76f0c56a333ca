"""Backbone execution forms: sparse ⇄ dense-tail weights (port of
``models/convert.py``), on the port's state_dict.

``dense_from_scale`` is an execution strategy, not an architecture: the
dense tail computes exactly the submanifold sums, so weights move between
tail boundaries by reshapes and flips. Entries of the scales past the
boundary move in or out of ``dense_tail.`` and conv kernels change layout:

  * submanifold conv  [K³, Cin, Cout]  ⇄  ``Conv3d`` [Cout, Cin, k, k, k],
    spatially flipped (a dense conv correlates; the rulebook enumerates
    the offsets the other way round);
  * k2s2 down conv    [8, Cin, Cout]   ⇄  ``Conv3d`` [Cout, Cin, 2, 2, 2], no flip;
  * k2s2 up conv      [8, Cin, Cout]   ⇄  ``ConvTranspose3d`` [Cin, Cout, 2, 2, 2]:
    the JAX package flips it for flax's ``ConvTranspose``, and torch's
    transposed conv flips it back, so no flip is left;
  * 1×1 projection    [1, Cin, Cout]   ⇄  ``Conv3d`` [Cout, Cin, 1, 1, 1];
  * BN parameters and running statistics: renamed only.

A pooling downsample's 1×1 projection ``down{s}_proj`` has no spatial
kernel, so a scale that has one cannot move into the tail: :func:`to_dense`
refuses it with the JAX converter's error.

Every transform is exact and invertible; ``tests/test_torch_convert.py``
holds it against the JAX converter through ``from_flax``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_TAIL = "dense_tail."
_PREFIXES = ("enc", "dec", "up", "down")


def _scale_of(name: str) -> Optional[int]:
    for p in _PREFIXES:
        if name.startswith(p) and len(name) > len(p) and name[len(p)].isdigit():
            i = len(p)
            while i < len(name) and name[i].isdigit():
                i += 1
            return int(name[len(p):i])
    return None


def _k(n_taps: int) -> int:
    k = round(n_taps ** (1.0 / 3.0))
    if k ** 3 != n_taps:
        raise ValueError(f"{n_taps} taps are not a cube")
    return k


def _to_dense(key: str, w: torch.Tensor) -> tuple:
    """(dense key, dense weight) of the sparse entry ``key`` (backbone
    level, no ``dense_tail.``)."""
    module, leaf = key.split(".")[0], key.rsplit(".", 1)[-1]
    s = _scale_of(module)
    if leaf != "kernel":                                     # BN
        return _TAIL + key, w
    k = _k(w.shape[0])
    d = w.reshape(k, k, k, *w.shape[1:])                     # [k, k, k, Cin, Cout]
    if module == f"down{s}_conv":
        return _TAIL + module + ".weight", d.permute(4, 3, 0, 1, 2)
    if module == f"up{s}_conv":
        return _TAIL + module + ".weight", d.permute(3, 4, 0, 1, 2)
    # a block's conv: "enc2_block0.conv1.conv.kernel" → "enc2_block0.conv1.weight"
    block, conv = key.split(".")[:2]
    if k > 1:
        d = d.flip(0, 1, 2)
    return f"{_TAIL}{block}.{conv}.weight", d.permute(4, 3, 0, 1, 2)


def _to_sparse(key: str, w: torch.Tensor) -> tuple:
    """Inverse of :func:`_to_dense`: (sparse key, sparse kernel)."""
    key = key[len(_TAIL):]
    module, leaf = key.split(".")[0], key.rsplit(".", 1)[-1]
    s = _scale_of(module)
    if leaf != "weight":                                     # BN
        return key, w
    if module == f"up{s}_conv":
        d = w.permute(2, 3, 4, 0, 1)                         # [k, k, k, Cin, Cout]
        return module + ".kernel", d.reshape(-1, *d.shape[3:]).contiguous()
    d = w.permute(2, 3, 4, 1, 0)
    if module == f"down{s}_conv":
        return module + ".kernel", d.reshape(-1, *d.shape[3:]).contiguous()
    if d.shape[0] > 1:
        d = d.flip(0, 1, 2)
    block, conv = key.split(".")[:2]
    return f"{block}.{conv}.conv.kernel", d.reshape(-1, *d.shape[3:]).contiguous()


def tree_boundary(state: Dict[str, torch.Tensor]) -> Optional[int]:
    """The dense-tail start scale of a backbone state_dict (None = fully sparse)."""
    scales = [_scale_of(k[len(_TAIL):]) for k in state if k.startswith(_TAIL)]
    scales = [s for s in scales if s is not None]
    return min(scales) if scales else None


def to_sparse(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A backbone state_dict in dense-tail form → fully sparse form."""
    return dict(_to_sparse(k, v) if k.startswith(_TAIL) else (k, v)
                for k, v in state.items())


def to_dense(state: Dict[str, torch.Tensor], s0: int) -> Dict[str, torch.Tensor]:
    """A fully sparse backbone state_dict → dense tail from scale ``s0``."""
    if tree_boundary(state) is not None:
        raise ValueError("to_dense takes a fully sparse state: call to_sparse first")
    out = {}
    for k, v in state.items():
        module = k.split(".")[0]
        s = _scale_of(module)
        if s is not None and s >= s0:
            if module == f"down{s}_proj":
                raise ValueError(
                    f"pooling downsample (down{s}_proj) has no spatial kernel — "
                    "scales crossing the dense-tail boundary must use "
                    "backbone.downsample='conv' to be convertible")
            k, v = _to_dense(k, v)
        out[k] = v
    return out


def convert_backbone(state: Dict[str, torch.Tensor],
                     to_s0: Optional[int]) -> Dict[str, torch.Tensor]:
    """A backbone state_dict in any form → the ``dense_from_scale=to_s0``
    form (None = fully sparse), through the sparse form."""
    sp = to_sparse(state)
    return sp if to_s0 is None else to_dense(sp, to_s0)


def convert_variables(state: Dict[str, torch.Tensor],
                      to_s0: Optional[int]) -> Dict[str, torch.Tensor]:
    """A detector state_dict with its ``backbone.`` entries converted to the
    ``dense_from_scale=to_s0`` form; every other entry as it is."""
    pre = "backbone."
    bb = {k[len(pre):]: v for k, v in state.items() if k.startswith(pre)}
    out = {k: v for k, v in state.items() if not k.startswith(pre)}
    out.update({pre + k: v for k, v in convert_backbone(bb, to_s0).items()})
    return out
