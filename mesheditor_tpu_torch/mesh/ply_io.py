"""PLY triangle-mesh IO (ascii and binary_little_endian), positions + faces."""

from __future__ import annotations

import struct

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "double": "f8", "float32": "f4", "float64": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
}


def load_ply(path) -> tuple[np.ndarray, np.ndarray]:
    """Returns (positions (n,3) float64, triangles (m,3) uint32); fans n-gons."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) or ('list', idx_t, cnt_t, name)])
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line == "end_header":
                break
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[1], parts[2]))
        positions = np.zeros((0, 3))
        tris: list[tuple[int, int, int]] = []
        if fmt == "ascii":
            for name, count, props in elements:
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    names = [p[-1] for p in props]
                    ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
                    positions = np.array(
                        [[float(r[ix]), float(r[iy]), float(r[iz])] for r in rows]
                    )
                elif name == "face":
                    for r in rows:
                        k = int(r[0])
                        idx = [int(v) for v in r[1 : 1 + k]]
                        for j in range(1, k - 1):
                            tris.append((idx[0], idx[j], idx[j + 1]))
        elif fmt == "binary_little_endian":
            for name, count, props in elements:
                if name == "vertex" and all(p[0] != "list" for p in props):
                    dt = np.dtype([(p[1], "<" + _PLY_TYPES[p[0]]) for p in props])
                    data = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    positions = np.stack(
                        [data["x"], data["y"], data["z"]], axis=1
                    ).astype(np.float64)
                elif name == "face":
                    (kind, cnt_t, idx_t, _), = [p for p in props if p[0] == "list"] or [("list", "uchar", "int", "vertex_indices")]
                    cnt_dt = np.dtype("<" + _PLY_TYPES[cnt_t])
                    idx_dt = np.dtype("<" + _PLY_TYPES[idx_t])
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cnt_dt.itemsize), dtype=cnt_dt)[0])
                        idx = np.frombuffer(f.read(idx_dt.itemsize * k), dtype=idx_dt)
                        for j in range(1, k - 1):
                            tris.append((int(idx[0]), int(idx[j]), int(idx[j + 1])))
                else:
                    raise ValueError(f"unsupported PLY element {name}")
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return positions, np.asarray(tris, dtype=np.uint32).reshape(-1, 3)


def save_ply(path, positions: np.ndarray, tris: np.ndarray, binary: bool = True) -> None:
    positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(tris, dtype=np.uint32).reshape(-1, 3)
    header = (
        "ply\n"
        + ("format binary_little_endian 1.0\n" if binary else "format ascii 1.0\n")
        + f"element vertex {positions.shape[0]}\n"
        + "property double x\nproperty double y\nproperty double z\n"
        + f"element face {tris.shape[0]}\n"
        + "property list uchar uint vertex_indices\n"
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(positions.astype("<f8").tobytes())
            for t in tris:
                f.write(struct.pack("<B3I", 3, *t))
        else:
            for p in positions:
                f.write(f"{p[0]} {p[1]} {p[2]}\n".encode())
            for t in tris:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())
