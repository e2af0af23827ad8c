"""Mesh and point-cloud file I/O (counterpart of
isogs_slam_tpu/mesh/meshio.py; numpy only): PLY (binary + ascii, read +
write), OBJ and STL (write), in place of trimesh / plyfile. The files are
byte-equal to the JAX package's, header comments included, so either
package reads the other's meshes.
"""
from __future__ import annotations

import struct

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def write_ply_mesh(path: str, verts: np.ndarray, faces: np.ndarray,
                   vertex_normals: np.ndarray | None = None,
                   vertex_colors: np.ndarray | None = None,
                   binary: bool = True):
    """Triangle mesh -> .ply (binary little-endian by default)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    n, m = verts.shape[0], faces.shape[0]
    props = ["property float x", "property float y", "property float z"]
    cols = [verts]
    if vertex_normals is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(np.asarray(vertex_normals, np.float32))
    if vertex_colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              "comment isogs_slam_tpu mesh",
              f"element vertex {n}", *props,
              f"element face {m}",
              "property list uchar int vertex_indices",
              "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            vdata = np.concatenate(cols, axis=1)
            if vertex_colors is not None:
                rec = np.zeros(n, dtype=[("f", np.float32, vdata.shape[1]),
                                         ("c", np.uint8, 3)])
                rec["f"] = vdata
                rec["c"] = np.clip(np.asarray(vertex_colors), 0,
                                   255).astype(np.uint8)
                f.write(rec.tobytes())
            else:
                f.write(vdata.astype("<f4").tobytes())
            frec = np.zeros(m, dtype=[("k", np.uint8), ("v", "<i4", 3)])
            frec["k"] = 3
            frec["v"] = faces
            f.write(frec.tobytes())
        else:
            for i in range(n):
                row = " ".join(f"{x:.6f}" for x in
                               np.concatenate([c[i] for c in cols]))
                if vertex_colors is not None:
                    cc = np.clip(vertex_colors[i], 0, 255).astype(int)
                    row += " " + " ".join(str(x) for x in cc)
                f.write((row + "\n").encode())
            for i in range(m):
                f.write((f"3 {faces[i,0]} {faces[i,1]} {faces[i,2]}\n")
                        .encode())


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray,
              vertex_normals: np.ndarray | None = None):
    with open(path, "w") as f:
        f.write("# isogs_slam_tpu mesh\n")
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if vertex_normals is not None:
            for vn in np.asarray(vertex_normals):
                f.write(f"vn {vn[0]:.6f} {vn[1]:.6f} {vn[2]:.6f}\n")
            for t in np.asarray(faces) + 1:
                f.write(f"f {t[0]}//{t[0]} {t[1]}//{t[1]} {t[2]}//{t[2]}\n")
        else:
            for t in np.asarray(faces) + 1:
                f.write(f"f {t[0]} {t[1]} {t[2]}\n")


def write_stl(path: str, verts: np.ndarray, faces: np.ndarray):
    """Binary STL."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    nrm = np.cross(b - a, c - a)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = (nrm / np.maximum(ln, 1e-12)).astype(np.float32)
    m = faces.shape[0]
    rec = np.zeros(m, dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)),
                             ("attr", "<u2")])
    rec["n"] = nrm
    rec["v"][:, 0] = a
    rec["v"][:, 1] = b
    rec["v"][:, 2] = c
    with open(path, "wb") as f:
        f.write(b"isogs_slam_tpu".ljust(80, b"\0"))
        f.write(struct.pack("<I", m))
        f.write(rec.tobytes())


def write_ply_points(path: str, props: dict, binary: bool = True):
    """Point-cloud PLY with arbitrary float32 per-vertex properties, in dict
    insertion order (the 3DGS splat format writer of scripts/export_ply.py)."""
    names = list(props.keys())
    cols = [np.asarray(props[n], np.float32).reshape(-1) for n in names]
    n = cols[0].shape[0]
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {n}",
              *[f"property float {nm}" for nm in names],
              "end_header"]
    data = np.stack(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(data.tobytes())
        else:
            for row in data:
                f.write((" ".join(f"{x:.8f}" for x in row) + "\n").encode())


def read_ply(path: str) -> dict:
    """Minimal PLY reader (ascii + binary_little_endian). Returns
    {"vertices": [N,3] f32, "faces": [M,3] i32 or None, "properties":
    {name: array}} — enough for mesh geometry eval and the 3DGS PLY."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n")
    if head_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:head_end].decode("ascii", "replace").splitlines()
    body = data[head_end + len(b"end_header\n"):]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_name, dtype)... or list marker])
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            elements.append([t[1], int(t[2]), []])
        elif t[0] == "property":
            if t[1] == "list":
                elements[-1][2].append((t[4], ("list", _PLY_TYPES[t[2]],
                                               _PLY_TYPES[t[3]])))
            else:
                elements[-1][2].append((t[2], _PLY_TYPES[t[1]]))

    out = {"vertices": None, "faces": None, "properties": {}}
    if fmt == "ascii":
        tokens = body.decode("ascii", "replace").split()
        pos = 0
        for name, count, props in elements:
            if any(isinstance(d, tuple) and d[0] == "list"
                   for _, d in props):
                faces = []
                for _ in range(count):
                    k = int(tokens[pos]); pos += 1
                    faces.append([int(tokens[pos + j]) for j in range(k)])
                    pos += k
                if name == "face" and faces:
                    out["faces"] = np.asarray(
                        [fc[:3] for fc in faces], np.int32)
            else:
                arr = np.asarray(
                    tokens[pos: pos + count * len(props)], np.float64
                ).reshape(count, len(props))
                pos += count * len(props)
                for j, (pname, _) in enumerate(props):
                    out["properties"].setdefault(name, {})[pname] = arr[:, j]
    else:
        off = 0
        for name, count, props in elements:
            if any(isinstance(d, tuple) and d[0] == "list"
                   for _, d in props):
                # assume uniform triangle lists (standard for our writers)
                _, cnt_t, idx_t = props[0][1]
                cdt = np.dtype("<" + cnt_t)
                idt = np.dtype("<" + idx_t)
                k = int(np.frombuffer(body, cdt, 1, off)[0])
                rec = np.dtype([("k", cdt), ("v", idt, k)])
                arr = np.frombuffer(body, rec, count, off)
                off += rec.itemsize * count
                if name == "face":
                    out["faces"] = arr["v"][:, :3].astype(np.int32)
            else:
                rec = np.dtype([(pn, "<" + dt) for pn, dt in props])
                arr = np.frombuffer(body, rec, count, off)
                off += rec.itemsize * count
                for pname, _ in props:
                    out["properties"].setdefault(name, {})[pname] = \
                        arr[pname].astype(np.float64)

    vp = out["properties"].get("vertex", {})
    if all(k in vp for k in ("x", "y", "z")):
        out["vertices"] = np.stack(
            [vp["x"], vp["y"], vp["z"]], axis=-1).astype(np.float32)
    return out
