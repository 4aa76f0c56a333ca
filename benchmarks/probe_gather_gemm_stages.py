#!/usr/bin/env python3
"""Where a stage of the gather-GEMM spends its cycles, on the card.

    python3 benchmarks/probe_gather_gemm_stages.py

Writes an instrumented copy of ``sparse_rcnn_tpu_torch/ops/csrc/sparse_conv.cu``
into ``sparse_rcnn_tpu_torch/_build/probe/``: ``clock64()`` counters in
``run_ring`` add up, per block (thread 0), the cycles spent waiting for the
ring (``cp.async.wait_group`` and the barrier), issuing the next stage's
copies, and in the products, and a ``read_prof`` entry point reads them
back. Three builds: as is, without the products (``NOMUL``) and without the
copies (``NOCOPY``). Each is timed (``chip_smoke.time_ms``) on a single
64-row tile, a full K27 16→16 grid, live rows to 60 % of M, and
scale-1-like K27 32→32 grids (36.5 % of rows live, f32 and bf16). Prints one
JSON line: per case and build, µs and the mean cycles per stage of the live
blocks. The instrumentation is text inserted at fixed lines of the source;
if those lines change, the script stops with the line it did not find.
Needs a CUDA card and ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc  # noqa: E402

OUT = os.path.join(ROOT, "sparse_rcnn_tpu_torch", "_build", "probe")
BUILDS = {"as_is": "", "no_products": "#define NOMUL\n", "no_copies": "#define NOCOPY\n"}
MAX_BLOCKS = 8192
# (K, Cin, Cout, M, rows live, dtype)
CASES = {
    "one_tile_k27_16x16": (27, 16, 16, 64, 1.0, torch.float32),
    "full_k27_16x16": (27, 16, 16, 32768, 1.0, torch.float32),
    "tail60_k27_16x16": (27, 16, 16, 32768, 0.6, torch.float32),
    "scale1_k27_32x32": (27, 32, 32, 24576, 0.365, torch.float32),
    "scale1_k27_32x32_bf16": (27, 32, 32, 24576, 0.365, torch.bfloat16),
}


def instrumented_source(defines: str) -> str:
    src = open(sc._SRC).read()

    def insert(after: str, text: str) -> None:
        nonlocal src
        if src.count(after) != 1:
            raise SystemExit(f"probe: did not find exactly once in sparse_conv.cu:\n{after}")
        src = src.replace(after, after + text)

    insert("namespace {\n", "__device__ unsigned long long g_prof[%d][4];\n" % MAX_BLOCKS)
    insert("  int c0 = 0, buf = 0;\n",
           "  unsigned long long t_wait = 0, t_issue = 0, t_mul = 0, t0 = clock64(), t1;\n")
    insert("    __syncthreads();               "
           "// ... everyone's, and stage s - 1 is no longer read\n",
           "    t1 = clock64(); t_wait += t1 - t0; t0 = t1;\n")
    insert("    if (s + kStages - 1 < n_stages) load_next();\n    cp_async_commit();\n",
           "    t1 = clock64(); t_issue += t1 - t0; t0 = t1;\n")
    insert("    buf = buf == kStages - 1 ? 0 : buf + 1;\n",
           "    t1 = clock64(); t_mul += t1 - t0; t0 = t1;\n")
    insert("    buf = buf == kStages - 1 ? 0 : buf + 1;\n"
           "    t1 = clock64(); t_mul += t1 - t0; t0 = t1;\n  }\n",
           "  if (tid == 0 && blockIdx.x < %d) {\n"
           "    g_prof[blockIdx.x][0] = t_wait; g_prof[blockIdx.x][1] = t_issue;\n"
           "    g_prof[blockIdx.x][2] = t_mul; g_prof[blockIdx.x][3] = n_stages;\n  }\n"
           % MAX_BLOCKS)
    for line in ("    if (s + kStages - 1 < n_stages) load_next();",
                 "    if (s < n_stages) load_next();"):
        src = src.replace(line, "#ifndef NOCOPY\n" + line + "\n#endif")
    src = src.replace("    tile.multiply(ring + buf * kStage,",
                      "#ifdef NOMUL\n    if (false)\n#endif\n"
                      "    tile.multiply(ring + buf * kStage,")
    src += ('\nextern "C" int read_prof(void* host) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)));\n}\n")
    return defines + src


def build(name: str):
    path = os.path.join(OUT, f"sparse_conv_{name}.cu")
    with open(path, "w") as f:
        f.write(instrumented_source(BUILDS[name]))
    so, _ = sc.build_kernel(path)
    lib = ctypes.CDLL(str(so))
    lib.read_prof.argtypes = [ctypes.c_void_p]
    return name, lib


class ProbeKernel(sc.SparseConvKernel):
    def __init__(self, lib):
        super().__init__()
        self._fn = lib.sparse_conv_forward
        self._fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        self._fn.restype = ctypes.c_int

    def load(self):
        return self._fn


def main() -> int:
    card = CS.card_info()
    os.makedirs(OUT, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as ex:
        libs = dict(ex.map(build, BUILDS))
    result = {"card": card, "cases": {}}
    for case, (k, cin, cout, m, live, dtype) in CASES.items():
        feats, idx, w = CS.conv_inputs(k, cin, cout, m, m, dtype, seed=0, live_rows=(live,))
        row = {}
        for name, lib in libs.items():
            kernel = ProbeKernel(lib)
            us = CS.time_ms(lambda: kernel(feats, idx, w)) * 1e3
            torch.cuda.synchronize()
            prof = np.zeros((MAX_BLOCKS, 4), np.uint64)
            if lib.read_prof(prof.ctypes.data) != 0:
                raise SystemExit("probe: reading the counters failed")
            p = prof[: min(MAX_BLOCKS, -(-m // CS.TILE_M))].astype(np.float64)
            p = p[p[:, 3] > 0]
            stages = p[:, 3].sum()
            row[name] = {"us": us, **{f"{part}_cycles_per_stage": p[:, i].sum() / stages
                                      for i, part in enumerate(("wait", "issue", "products"))}}
        result["cases"][case] = row
        print(case, json.dumps({b: {key: round(v, 1) for key, v in r.items()}
                                for b, r in row.items()}), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
