"""The reference's arithmetic: float32 (``MODE = "f32"``, the reference) or
float32 with every matmul and conv operand rounded to float8 e4m3 under a
per-tensor scale (``MODE = "fp8"``, the control: the next precision below
the configurations' bfloat16).

Written for the benchmark; not a copy of the port.
"""

from __future__ import annotations

import torch

MODE = "f32"
_E4M3_MAX = 448.0


def set_mode(mode: str) -> None:
    global MODE
    if mode not in ("f32", "fp8"):
        raise ValueError(f"precision mode {mode!r}")
    MODE = mode


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    amax = x32.abs().amax()
    scale = torch.where(amax > 0, _E4M3_MAX / amax, torch.ones_like(amax))
    return ((x32 * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale).to(x.dtype)


def q(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the current mode computes with it: itself in f32 mode; in
    fp8 mode rounded to e4m3, with the gradient passed straight through."""
    if MODE == "f32":
        return x
    if not (x.requires_grad and torch.is_grad_enabled()):
        return _round_fp8(x)
    return x + (_round_fp8(x.detach()) - x.detach())
