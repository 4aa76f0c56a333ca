"""Minimal PLY reader and writer, numpy only (port of ``data/ply.py``).

The subset the ScanNet pipeline needs: the vertex element of a
binary-little-endian or ascii file, with scalar float, integer and uchar
properties, including the per-vertex ``label`` of the
``_vh_clean_2.labels.ply`` layout. :func:`write_ply` writes the same subset.
"""

from __future__ import annotations

import io
from typing import Dict, Mapping, Tuple

import numpy as np

_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
# the PLY name of each numpy type, for the writer
_NAMES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
          "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element of a PLY file → dict of property arrays."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype)])
    cur = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur[2].append((parts[-1], ("list", _TYPES[parts[2]], _TYPES[parts[3]])))
            else:
                cur[2].append((parts[-1], _TYPES[parts[1]]))

    body = data[header_end:]
    out: Dict[str, np.ndarray] = {}
    offset = 0
    for name, count, props in elements:
        if name != "vertex":
            # vertex is always first in ScanNet files; stop once read
            if out:
                break
            continue
        if any(isinstance(t, tuple) for _, t in props):
            raise ValueError("list properties unsupported in vertex element")
        if fmt == "ascii":
            text = body.decode("ascii")
            rows = np.loadtxt(io.StringIO(text), max_rows=count, ndmin=2)
            for i, (pname, t) in enumerate(props):
                out[pname] = rows[:, i].astype(t)
        elif fmt == "binary_little_endian":
            dt = np.dtype([(pname, "<" + t) for pname, t in props])
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += dt.itemsize * count
            for pname, _ in props:
                out[pname] = np.ascontiguousarray(arr[pname])
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
        break
    if not out:
        raise ValueError(f"no vertex element found in {path}")
    return out


def write_ply(path: str, props: Mapping[str, np.ndarray], ascii: bool = False) -> None:
    """Write ``props`` (name → [N] array, in order) as the vertex element of
    a PLY file, binary little-endian or ascii. Floats in ascii keep every
    bit (9 and 17 significant digits)."""
    names = list(props)
    cols = [np.asarray(props[k]) for k in names]
    n = len(cols[0])
    types = [c.dtype.str[1:] for c in cols]
    header = ["ply", f"format {'ascii' if ascii else 'binary_little_endian'} 1.0",
              f"element vertex {n}"]
    header += [f"property {_NAMES[t]} {k}" for k, t in zip(names, types)]
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if ascii:
            spec = [{"f4": "%.9g", "f8": "%.17g"}.get(t, "%d") for t in types]
            table = np.empty((n, len(cols)), object)
            for i, c in enumerate(cols):
                table[:, i] = c
            np.savetxt(f, table, fmt=spec, delimiter=" ")
        else:
            arr = np.empty(n, np.dtype([(k, "<" + t) for k, t in zip(names, types)]))
            for k, c in zip(names, cols):
                arr[k] = c
            f.write(arr.tobytes())


def vertices_xyz_rgb(props: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    xyz = np.stack([props["x"], props["y"], props["z"]], 1).astype(np.float32)
    if "red" in props:
        rgb = np.stack([props["red"], props["green"], props["blue"]], 1)
        rgb = rgb.astype(np.float32) / 127.5 - 1.0
    else:
        rgb = np.zeros((len(xyz), 3), np.float32)
    return xyz, rgb
