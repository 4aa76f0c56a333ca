"""Structured logging of the port (port of ``sparse_rcnn_tpu/utils/logging.py``):
one JSON object per line, with an optional TensorBoard mirror."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional


class JsonlLogger:
    """jsonl to stdout and, with ``path``, appended to a file; optionally
    mirrors numeric fields to TensorBoard as ``{kind}/{field}`` scalars
    (``tb_dir``).

    Each line is ``{"kind": ..., "t": seconds since the logger started,
    **fields}``; a field with ``.item`` (a tensor or numpy scalar) is written
    as a float. TensorBoard is optional: if its writer cannot be imported the
    logger prints one warning line to stderr and goes on with jsonl only.
    The jsonl lines are the contract. A logger made with ``enabled=False``
    (a data-parallel rank other than 0) writes nothing anywhere.
    """

    def __init__(self, path: Optional[str] = None, tb_dir: Optional[str] = None,
                 enabled: bool = True):
        self.enabled = enabled
        if not enabled:
            path = tb_dir = None
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()
        self._tb = None
        self._n = 0
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(json.dumps({"kind": "warn", "msg": f"tensorboard unavailable: "
                                  f"{e!r} - jsonl only"}), file=sys.stderr, flush=True)
            else:
                self._tb = SummaryWriter(log_dir=tb_dir)

    def log(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        rec: Dict[str, Any] = {"kind": kind, "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "item") else v) for k, v in fields.items()})
        line = json.dumps(rec)
        print(line, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._tb is not None:
            self._n += 1
            step = rec.get("step")
            step = int(step) if isinstance(step, (int, float)) else self._n
            for k, v in rec.items():
                if k not in ("kind", "t", "step") and isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{kind}/{k}", float(v), step)
            self._tb.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
