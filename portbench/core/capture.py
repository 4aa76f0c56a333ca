"""The RPN heads' per-site outputs of the timed path, for the check.

Forward hooks on the port's RPN heads (the modules ``rpn`` and
``rpn_s<scale>``, called in the order of ``rpn.rpn_scales``) keep each
call's objectness, boxes and deltas and the valid rows it was given. After
each call of the traffic (a request or a batch) :meth:`RpnCapture.end_call`
keeps or drops what that call's heads gave, by reservoir sampling from the
seed, so that after the window the kept calls are a uniform sample of all
of them. The kept outputs stay on the device until the window has closed;
the hooks only hold references, they copy nothing.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class RpnCapture:
    def __init__(self, model, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 273])
        self.kept: List[Tuple[int, list]] = []
        self.active = False
        self._calls = 0
        self._cur: list = []
        self._handles = [m.register_forward_hook(self._hook)
                         for name, m in model.named_modules()
                         if name == "rpn" or (name.startswith("rpn_s") and "." not in name)]
        if not self._handles:
            raise RuntimeError("the model has no RPN head to capture")

    def _hook(self, mod, args, out):
        if self.active:
            obj, boxes, deltas = out
            self._cur.append((obj, boxes, deltas, args[2]))

    def start(self) -> None:
        """Sample the calls from here on (the window's)."""
        self.active = True
        self._calls = 0
        self._cur = []

    def end_call(self) -> None:
        """Keep or drop what the call just made gave."""
        if not self.active:
            return
        i, cur = self._calls, self._cur
        self._calls += 1
        self._cur = []
        if i < self.k:
            self.kept.append((i, cur))
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.kept[j] = (i, cur)

    def close(self) -> Dict[int, list]:
        """Stop; {call index: per scale, dict of host arrays ``obj`` [B, M],
        ``boxes`` [B, M, 6], ``deltas`` [B, M, 6], ``mask`` [B, M]}."""
        self.active = False
        for h in self._handles:
            h.remove()
        def host(t):
            return t.detach().cpu().numpy()
        out = {i: [{"obj": host(o.float()), "boxes": host(b.float()),
                    "deltas": host(d.float()), "mask": host(m)}
                   for o, b, d, m in cur] for i, cur in self.kept}
        self.kept = []
        return out
