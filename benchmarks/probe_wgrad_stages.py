#!/usr/bin/env python3
"""Where a block of the wgrad kernel's first pass spends its time, on the card.

    python3 benchmarks/probe_wgrad_stages.py

Writes an instrumented copy of ``sparse_rcnn_tpu_torch/ops/csrc/sparse_conv.cu``
into ``sparse_rcnn_tpu_torch/_build/probe_wgrad/``. In
``sparse_conv_wgrad_partial_kernel`` thread 0 of each block (warp 0's lane 0)
adds up, per 32-row stage, the cycles (``clock64()``) spent before the wait
(the ballot and the next index read), waiting (``cp.async.wait_group`` and the
block's barrier), issuing the next stage's copies, and in warp 0's products,
and counts warp 0's live rows; it also keeps the block's start and end on the
card's clock (``%globaltimer``, ns) and its SM. A ``read_wprof`` entry point
reads them back. Three builds: as is, without the products (``NOMUL``) and
without the copies (``NOCOPY``; the products then read stale shared memory).
Each is timed (``chip_smoke.time_ms``, both passes) on the 10 wgrad calls of
one config-1 train step (as ``compare_gather_gemm.py`` captures them) and on
two random cases: every t_idx entry -1, and M below one chunk. Prints one JSON
line per case and a last one with all; per case and build: µs, and for the
as-is build the partial pass's span (first block start to last block end),
the spread of block starts, the median and longest block, blocks per SM, and
the mean cycles per stage of each part over the blocks with a live stage. The
instrumentation is text inserted at fixed lines of the source; if those lines
change, the script stops with the line it did not find. Needs a CUDA card and
``nvcc``; imports no JAX.
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
from benchmarks import compare_gather_gemm as CMP  # noqa: E402
from sparse_rcnn_tpu_torch.config import load_config  # noqa: E402
from sparse_rcnn_tpu_torch.ops import sparse_conv as sc  # noqa: E402

OUT = os.path.join(ROOT, "sparse_rcnn_tpu_torch", "_build", "probe_wgrad")
BUILDS = {"as_is": "", "no_products": "#define NOMUL\n", "no_copies": "#define NOCOPY\n"}
MAX_BLOCKS = 16384


def instrumented_source(defines: str) -> str:
    src = open(sc._SRC).read()

    def insert(after: str, text: str, before: bool = False) -> None:
        nonlocal src
        if src.count(after) != 1:
            raise SystemExit(f"probe: did not find exactly once in sparse_conv.cu:\n{after}")
        src = src.replace(after, text + after if before else after + text)

    insert("namespace {\n", "__device__ unsigned long long g_wprof[%d][8];\n" % MAX_BLOCKS)
    insert("  using Tile = WgradTile<kTC, kTN>;\n",
           "  unsigned long long p_g0, p_g1, p_t1, p_t0 = clock64(), p_before = 0, p_wait = 0,"
           " p_issue = 0, p_mul = 0, p_stages = 0, p_live = 0;\n"
           '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(p_g0));\n')
    insert("    cp_async_wait<0>();"
           "                 // this thread's copies of stage j0 have landed\n",
           "    p_t1 = clock64(); p_before += p_t1 - p_t0; p_t0 = p_t1;\n", before=True)
    insert("    const bool any1 = __syncthreads_or(live1 != 0);\n",
           "    p_t1 = clock64(); p_wait += p_t1 - p_t0; p_t0 = p_t1;\n")
    insert("    if (j1 < j_end) load(j1, i1, any1, buf ^ 1);\n",
           "    p_t1 = clock64(); p_issue += p_t1 - p_t0; p_t0 = p_t1;\n")
    insert("    live = live1;\n",
           "    p_t1 = clock64(); p_mul += p_t1 - p_t0; p_t0 = p_t1;\n"
           "    p_live += __popc(live); ++p_stages;\n", before=True)
    insert("  if (!tap) return;\n  float* p = partials",
           "  if (tid == 0) {\n"
           "    const unsigned blk =\n"
           "        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
           "    unsigned sm;\n"
           '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(p_g1));\n'
           '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
           "    if (blk < MAX_BLOCKS) {\n"
           "      unsigned long long* q = g_wprof[blk];\n"
           "      q[0] = p_g0; q[1] = p_g1; q[2] = p_before; q[3] = p_wait; q[4] = p_issue;\n"
           "      q[5] = p_mul; q[6] = p_stages; q[7] = sm | (p_live << 32);\n"
           "    }\n  }\n".replace("MAX_BLOCKS", str(MAX_BLOCKS)), before=True)
    insert("    for (unsigned m = live; m; m &= m - 1) {\n",
           "#ifdef NOMUL\n    if (false)\n#endif\n", before=True)
    insert("  auto load = [&](int j0, int i, bool feats_too, int buf) {\n",
           "#ifdef NOCOPY\n    return;\n#endif\n")
    src += ('\nextern "C" int read_wprof(void* host) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_wprof, sizeof(g_wprof)));\n}\n")
    return defines + src


def build(name: str):
    path = os.path.join(OUT, f"sparse_conv_{name}.cu")
    with open(path, "w") as f:
        f.write(instrumented_source(BUILDS[name]))
    so, _ = sc.build_kernel(path)
    lib = ctypes.CDLL(str(so))
    lib.read_wprof.argtypes = [ctypes.c_void_p]
    lib.read_wprof.restype = ctypes.c_int
    return name, lib


class ProbeWgrad(sc.SparseConvWgradKernel):
    def __init__(self, lib):
        super().__init__()
        self._fn = lib.sparse_conv_wgrad
        self._fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        self._fn.restype = ctypes.c_int

    def load(self):
        return self._fn


def blocks_of(feats, t_idx, g) -> int:
    """Blocks of the first pass (as ``launch_wgrad`` sizes its grid)."""
    b, m_in, cin = feats.shape
    k, cout = t_idx.shape[1], g.shape[2]
    groups = -(-k // 8)
    tc = 4 if cin <= 4 else 16 if cin <= 16 else 32
    tn = 16 if cout <= 16 else 32
    return b * sc.wgrad_chunks(m_in)[1] * groups * -(-cin // tc) * -(-cout // tn)


def block_stats(prof) -> dict:
    """Span, start spread and block lengths (µs), blocks per SM, and the mean
    cycles per stage of each part over the blocks whose warp 0 had a live
    stage (and of the dead blocks' waits)."""
    p = prof.astype(np.float64)
    start, end = p[:, 0], p[:, 1]
    length = (end - start) / 1e3
    live = (prof[:, 7] >> 32) > 0
    stages = p[:, 6]
    per = {f"{f}_cycles_per_stage": p[live, i].sum() / max(stages[live].sum(), 1)
           for i, f in ((2, "before"), (3, "wait"), (4, "issue"), (5, "products"))}
    sms = np.bincount((prof[:, 7] & 0xffffffff).astype(np.int64))
    return {"blocks": len(p), "span_us": (end.max() - start.min()) / 1e3,
            "start_spread_us": (start.max() - start.min()) / 1e3,
            "block_us_median": float(np.median(length)), "block_us_max": float(length.max()),
            "live_block_us_median": float(np.median(length[live])) if live.any() else 0.0,
            "blocks_per_sm_max": int(sms.max()), "sms_used": int((sms > 0).sum()),
            "warp0_live_blocks": int(live.sum()),
            "warp0_live_rows_per_stage":
                float((prof[live, 7] >> 32).sum() / max(stages[live].sum(), 1)),
            "dead_block_wait_cycles_per_stage":
                float(p[~live, 3].sum() / max(stages[~live].sum(), 1)), **per}


def main() -> int:
    card = CS.card_info()
    os.makedirs(OUT, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as ex:
        libs = dict(ex.map(build, BUILDS))
    calls = CMP.main_path_calls(load_config(CS.CONFIG1))["wgrad"]
    cases = {f"main{i}_K{t.shape[1]}_{f.shape[2]}x{g.shape[2]}": (f, t, g)
             for i, (f, t, g) in enumerate(calls)}
    for name, live, m in (("all_dead_k27_16x16", 0.0, 32768), ("m100_k27_16x16", 1.0, 100)):
        f, t, g, _ = CS.bwd_inputs(27, 16, 16, m, m, torch.float32, seed=7, live_rows=(live,))
        cases[name] = (f, t, g)
    result = {"card": card, "cases": {}}
    for case, args in cases.items():
        n_blocks = blocks_of(*args)
        if n_blocks > MAX_BLOCKS:
            raise SystemExit(f"probe: {case} has {n_blocks} blocks, more than {MAX_BLOCKS}")
        row = {"dead_pair_share": CS.dead_pair_share(args[1], args[2].shape[1], CS.WGRAD_STAGE)}
        for name, lib in libs.items():
            kernel = ProbeWgrad(lib)
            row[name] = {"us": CS.time_ms(lambda: kernel(*args)) * 1e3}
            if name == "as_is":
                kernel(*args)
                torch.cuda.synchronize()
                prof = np.zeros((MAX_BLOCKS, 8), np.uint64)
                if lib.read_wprof(prof.ctypes.data) != 0:
                    raise SystemExit("probe: reading the counters failed")
                row[name].update(block_stats(prof[:n_blocks]))
        result["cases"][case] = row
        print(case, json.dumps({b: ({k: round(v, 2) for k, v in r.items()}
                                    if isinstance(r, dict) else round(r, 3))
                                for b, r in row.items()}), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
