"""Edge cases of the mask read's map and backward kernels
(``sparse_rcnn_tpu_torch/ops/index_grad.py``: ``mask_read_map``,
``mask_read_grad``) and the helper that holds them to their plain versions.

``tests/test_torch_kernel_cuda.py`` runs these cases on the card, and
``chip_smoke.py`` phase 3 runs and times them. Imports no JAX.
"""

from __future__ import annotations

import torch

from sparse_rcnn_tpu_torch.models.heads import mask_cells
from sparse_rcnn_tpu_torch.ops import index_grad as IG

# (name, P, G, N, kind): P proposals of random boxes (sides 5-30 voxels) over N
# points in a 100-voxel cube, G³ cells a grid; keep is each box's inside test and the
# cotangent g is 0 outside, as the training loss gives it. "empty_box" moves box 0
# away from every point (all its points outside, on border cells), "all_outside"
# every box; "one_cell" keeps every point of proposal 0, all in cell 0 (a kept run of
# N entries); "long_inside_run" puts 30 % of the points in the corner cell of box 0
# and 30 % past that corner (clamped onto it), so one row mixes a long kept run with
# as many left-out entries; "no_keep" passes no keep (every entry, g nonzero
# everywhere); "tail" runs shorter than a warp; "full_unit" puts every point of
# proposal 0 in cell 0 and keeps every seventh, with blocks of FORCED_UNIT's 32768
# points (a block's count of one cell reaches 32768, the top bit of its packed
# counter). g is bf16 of normal values times
# 2^-U, U uniform in [0, 20): sums of such values change with their grouping, so a
# kernel that grouped a row otherwise than index_put_ would show.
MASK_MAP_CASES = [
    ("random", 32, 14, 32768, "random"),
    ("p1", 1, 14, 32768, "random"),
    ("one_cell", 4, 14, 32768, "one_cell"),
    ("empty_box", 8, 14, 32768, "empty_box"),
    ("all_outside", 4, 14, 32768, "all_outside"),
    ("long_inside_run", 4, 14, 32768, "long_inside_run"),
    ("no_keep", 8, 14, 32768, "no_keep"),
    ("tail", 2, 4, 37, "no_keep"),
    ("full_unit", 2, 14, 65536, "full_unit"),
]
FORCED_UNIT = {"full_unit": 32768}     # points a map block takes, where not map_unit's


def mask_case(p, grid, n, kind, device, seed):
    """(g bf16 [p, n], cell int32 [p, n], keep bool [p, n] or None, cells)
    of one case, made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    lo = rand(p, 3) * 80
    boxes = torch.cat([lo, lo + 5 + 25 * rand(p, 3)], 1)
    pos = rand(n, 3) * 100
    if kind == "empty_box":
        boxes[0] = torch.tensor([500.0, 500, 500, 510, 510, 510], device=device)
    elif kind == "all_outside":
        boxes[:] = torch.tensor([500.0, 500, 500, 510, 510, 510], device=device)
    elif kind == "long_inside_run":
        boxes[0] = torch.tensor([20.0, 20, 20, 34, 34, 34], device=device)
        k = 3 * n // 10
        at = torch.randperm(n, generator=gen, device=device)
        pos[at[:k]] = 20 + rand(k, 3) * 0.99           # in cell 0 of box 0's 14³ grid
        pos[at[k:2 * k]] = 20 - 1 - rand(k, 3) * 10    # past its low corner: clamped onto it
    cell, keep = mask_cells(boxes, pos, grid)
    if kind == "one_cell":
        cell[0] = 0
        keep[0] = True
    elif kind == "full_unit":
        cell[0] = 0
        keep[0] = torch.arange(n, device=device) % 7 == 0
    g = torch.randn((p, n), generator=gen, device=device) * torch.exp2(-20 * rand(p, n))
    if kind == "no_keep":
        keep = None
    else:
        g = torch.where(keep, g, 0.0)
    return g.to(torch.bfloat16), cell.contiguous(), keep, grid ** 3


def bits(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor's bits: +0 and -0 apart."""
    return t.view(torch.int16)


def check_mask_case(g, cell, keep, cells, unit=None) -> dict:
    """The map kernel against the plain map and the backward kernel over it
    against ``index_put_`` over every entry (the plain version), each run
    twice: bit equality and run-to-run identity; the kept entries, the
    longest kept row and the kept entries that join a lane of
    ``index_put_``'s pass (not its tail). ``unit``: the map's block size
    (None: ``IG.map_unit``'s)."""
    p = cell.shape[0]
    rows = p * cells
    got_map, again_map = (IG.mask_read_map_kernel(cell, cells, keep, unit) for _ in range(2))
    want_map = IG.mask_read_map_reference(cell, cells, keep)
    kept = int(want_map[1][-1])

    def head(m):                                     # what is written of a map
        return m[0][:kept], m[1], m[2][:kept]

    map_equal = all(torch.equal(a, b) for a, b in zip(head(got_map), head(want_map)))
    map_same = all(torch.equal(a, b) for a, b in zip(head(got_map), head(again_map)))
    got, again = (IG.mask_read_grad_kernel(g, got_map, rows) for _ in range(2))
    want = IG.mask_read_grad_reference(g, cell, cells).reshape(-1)
    lanes = want_map[2][:kept]
    return {
        "entries": p * cell.shape[1], "kept": kept,
        "longest_kept_row": int(want_map[1].diff().max()) if rows else 0,
        "kept_in_lanes": int((lanes < IG.TAIL).sum()),
        "map_bit_equal": map_equal, "map_bit_identical": map_same,
        "bit_equal": bool(torch.equal(bits(got), bits(want))),
        "bit_identical": bool(torch.equal(bits(got), bits(again))),
        "max_abs_err": (got.float() - want.float()).abs().max().item() if rows else 0.0,
    }
