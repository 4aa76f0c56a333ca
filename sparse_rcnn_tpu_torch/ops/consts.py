"""Small constant tables on a device without a host sync.

``torch.tensor(values, device="cuda")`` copies from pageable host memory,
and torch waits for the whole stream to drain before such a copy returns:
in the middle of a step that is a stall of the host until the card has
caught up. :func:`device_tensor` stages the values in pinned memory and
copies them on the current stream instead, so the host goes on queueing.
"""

from __future__ import annotations

import torch


def device_tensor(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, the same values,
    with no host sync on a CUDA device (a non-blocking copy from pinned
    memory, which the caching host allocator keeps until the copy is done)."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
