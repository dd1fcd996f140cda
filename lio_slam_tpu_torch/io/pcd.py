"""PCD file I/O (host-side numpy; a copy of `lio_slam_tpu/io/pcd.py`).

Replaces the reference's `pcl::io::savePCDFileBinary` /
`pcl::io::loadPCDFile` usage in the save-map service
(`mapOptmization.cpp:928-963`): trajectory, transformations, SurfMap,
GlobalMap exports.  Binary and ascii PCD v0.7 with xyz, intensity and
extra float fields.
"""

from __future__ import annotations

import os

import numpy as np

_HEADER = """# .PCD v0.7 - Point Cloud Data file format
VERSION 0.7
FIELDS {fields}
SIZE {sizes}
TYPE {types}
COUNT {counts}
WIDTH {n}
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS {n}
DATA {data}
"""


def save_pcd(path: str, xyz: np.ndarray, intensity: np.ndarray | None = None,
             binary: bool = True,
             extra_fields: dict | None = None) -> None:
    """extra_fields: ordered {name: (N,) array} of additional float32 fields
    appended after intensity — used for the 6-DoF keyframe-pose export
    (PointTypePose x/y/z/intensity/roll/pitch/yaw/time,
    mapOptmization.cpp:928-932 `transformations.pcd`)."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    cols = [xyz]
    names = ["x", "y", "z"]
    if intensity is not None:
        cols.append(np.asarray(intensity, np.float32).reshape(n, 1))
        names.append("intensity")
    for k, v in (extra_fields or {}).items():
        cols.append(np.asarray(v, np.float32).reshape(n, 1))
        names.append(k)
    data = np.concatenate(cols, axis=1) if len(cols) > 1 else xyz
    m = len(names)
    fields = " ".join(names)
    sizes = " ".join(["4"] * m)
    types = " ".join(["F"] * m)
    counts = " ".join(["1"] * m)
    header = _HEADER.format(fields=fields, sizes=sizes, types=types,
                            counts=counts, n=n,
                            data="binary" if binary else "ascii")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data, np.float32).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def load_pcd(path: str):
    """Returns (xyz (N,3) float32, attrs dict of extra field arrays)."""
    with open(path, "rb") as f:
        fields, sizes, types, counts, n, data_mode = [], [], [], [], 0, "ascii"
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("SIZE"):
                sizes = [int(x) for x in line.split()[1:]]
            elif line.startswith("TYPE"):
                types = line.split()[1:]
            elif line.startswith("COUNT"):
                counts = [int(x) for x in line.split()[1:]]
            elif line.startswith("POINTS"):
                n = int(line.split()[1])
            elif line.startswith("DATA"):
                data_mode = line.split()[1]
                break
        np_types = []
        for t, s in zip(types, sizes):
            np_types.append({"F": f"f{s}", "I": f"i{s}", "U": f"u{s}"}[t])
        if any(c != 1 for c in counts):
            raise ValueError("multi-count PCD fields not supported")
        dtype = np.dtype(list(zip(fields, np_types)))
        if data_mode == "binary":
            raw = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        elif data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.rec.fromarrays(
                [raw[:, i].astype(np_types[i]) for i in range(len(fields))],
                names=",".join(fields))
        else:
            raise ValueError(f"unsupported PCD data mode {data_mode!r}")
    xyz = np.stack([raw["x"], raw["y"], raw["z"]], axis=1).astype(np.float32)
    attrs = {k: np.asarray(raw[k]) for k in fields if k not in ("x", "y", "z")}
    return xyz, attrs
