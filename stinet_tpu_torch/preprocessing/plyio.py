"""Minimal self-contained PLY reader/writer (binary little-endian + ascii)
for ScanNet `_vh_clean_2.ply`-style meshes — replaces the reference's
open3d/plyfile dependency for mesh IO. A copy of the JAX package's
`preprocessing/plyio.py`: the two read and write the same bytes."""
import struct
from typing import Dict, Optional

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Returns dict with 'vertices' [N,3] f64, optional 'colors' [N,3] f64
    in [0,1], optional 'normals' [N,3], 'faces' [F,3] i64."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = "ascii"
        elements = []  # (name, count, [(prop_name, dtype) or ('list',...)])
        cur = None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property" and cur is not None:
                if parts[1] == "list":
                    cur[2].append(("__list__", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[2], _TYPES[parts[1]]))

        out: Dict[str, np.ndarray] = {}
        if fmt == "ascii":
            data_lines = f.read().decode("ascii", "replace").split("\n")
            li = 0
            for name, count, props in elements:
                if any(p[0] == "__list__" for p in props):
                    faces = np.empty((count, 3), np.int64)
                    for i in range(count):
                        vals = data_lines[li].split(); li += 1
                        n = int(vals[0])
                        assert n == 3, "only triangle meshes supported"
                        faces[i] = [int(v) for v in vals[1:4]]
                    out[f"__{name}_faces"] = faces
                else:
                    rows = np.empty((count, len(props)), np.float64)
                    for i in range(count):
                        rows[i] = [float(v) for v in data_lines[li].split()]
                        li += 1
                    out[f"__{name}_props"] = rows
                    out[f"__{name}_names"] = np.array(
                        [p[0] for p in props])
        else:
            endian = "<" if "little" in fmt else ">"
            for name, count, props in elements:
                if any(p[0] == "__list__" for p in props):
                    _, cnt_t, idx_t, _pname = props[0]
                    cdt = np.dtype(endian + _TYPES[cnt_t])
                    idt = np.dtype(endian + _TYPES[idx_t])
                    stride = cdt.itemsize + 3 * idt.itemsize
                    raw = f.read(count * stride)
                    buf = np.frombuffer(raw, dtype=np.uint8).reshape(
                        count, stride)
                    faces = buf[:, cdt.itemsize:].copy().view(idt).reshape(
                        count, 3).astype(np.int64)
                    out[f"__{name}_faces"] = faces
                else:
                    dt = np.dtype([(p[0], endian + p[1]) for p in props])
                    rows = np.frombuffer(f.read(count * dt.itemsize),
                                         dtype=dt, count=count)
                    cols = np.stack(
                        [rows[p[0]].astype(np.float64) for p in props],
                        axis=1)
                    out[f"__{name}_props"] = cols
                    out[f"__{name}_names"] = np.array([p[0] for p in props])

    result: Dict[str, np.ndarray] = {}
    vp = out.get("__vertex_props")
    names = list(out.get("__vertex_names", []))
    if vp is not None:
        def col(cname):
            return vp[:, names.index(cname)] if cname in names else None
        result["vertices"] = np.stack(
            [col("x"), col("y"), col("z")], axis=1)
        if "red" in names:
            result["colors"] = np.stack(
                [col("red"), col("green"), col("blue")], axis=1) / 255.0
        if "nx" in names:
            result["normals"] = np.stack(
                [col("nx"), col("ny"), col("nz")], axis=1)
    if "__face_faces" in out:
        result["faces"] = out["__face_faces"]
    return result


def write_ply(path: str, vertices: np.ndarray,
              faces: Optional[np.ndarray] = None,
              colors: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    n = len(vertices)
    props = ["property float x", "property float y", "property float z"]
    if colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {n}"] + props
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        cc = None
        if colors is not None:
            cc = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
        if binary:
            for i in range(n):
                f.write(struct.pack("<fff", *vertices[i]))
                if cc is not None:
                    f.write(struct.pack("BBB", *cc[i]))
            if faces is not None:
                for face in faces:
                    f.write(struct.pack("<Biii", 3, *[int(x) for x in face]))
        else:
            for i in range(n):
                row = f"{vertices[i][0]} {vertices[i][1]} {vertices[i][2]}"
                if cc is not None:
                    row += f" {cc[i][0]} {cc[i][1]} {cc[i][2]}"
                f.write((row + "\n").encode())
            if faces is not None:
                for face in faces:
                    f.write(("3 " + " ".join(str(int(x)) for x in face)
                             + "\n").encode())
