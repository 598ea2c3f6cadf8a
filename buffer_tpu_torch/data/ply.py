"""Minimal PLY point-cloud reader and writer (counterpart of
``buffer_tpu/data/ply.py``; no Open3D).

Stands in for ``o3d.io.read_point_cloud`` on the fragment files the
reference loads (``ThreeDMatch/dataset.py:91``).  Reads ASCII and binary
little- or big-endian PLY with x/y/z vertex properties (other properties
are parsed and ignored); writes binary little-endian float32 xyz.
"""

from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_points(path: str) -> np.ndarray:
    """Returns [N, 3] float32 xyz."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []          # (name, dtype) for the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError(f"{path}: list property in vertex element")
                props.append((tok[2], _TYPES[tok[1]]))
            elif tok[0] == "end_header":
                break

        names = [p[0] for p in props]
        if not {"x", "y", "z"} <= set(names):
            raise ValueError(f"{path}: vertex element lacks x/y/z")

        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex)
            data = data.reshape(n_vertex, -1)
            ix = [names.index(c) for c in "xyz"]
            return data[:, ix].astype(np.float32)

        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(n, endian + t) for n, t in props])
        data = np.frombuffer(f.read(n_vertex * dtype.itemsize), dtype=dtype,
                             count=n_vertex)
        out = np.stack([data["x"], data["y"], data["z"]], axis=1)
        return out.astype(np.float32)


def write_ply_points(path: str, pts: np.ndarray) -> None:
    """[N, 3] xyz -> binary little-endian float32 PLY."""
    pts = np.asarray(pts, np.float32)
    header = (b"ply\nformat binary_little_endian 1.0\n"
              + b"element vertex %d\n" % len(pts)
              + b"property float x\nproperty float y\nproperty float z\n"
              + b"end_header\n")
    with open(path, "wb") as f:
        f.write(header)
        f.write(pts.astype("<f4").tobytes())
