"""PLY loader (ascii + binary_little_endian), port of scene/plyloader.py
(numpy only, the same arithmetic in the same order).

Parity with the reference PLY path (src/main.cpp:533-587 via tinyply):
reads vertex x/y/z, optional nx/ny/nz and u/v, and triangular faces;
uv gets the same v-flip; all faces get material id 0.
"""
from __future__ import annotations

import struct

import numpy as np

from .mesh import TriangleMesh, fill_missing_normals

_PLY_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


def load_ply(path, default_mat=0):
    with open(path, "rb") as f:
        data = f.read()

    # ---- header ----
    end = data.find(b"end_header\n")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]
    fmt = None
    elements = []  # (name, count, [(prop_name, type) or ('list', count_t, item_t, name)])
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append((parts[2], parts[1]))  # (name, type)

    verts = norms = uvs = None
    faces = []

    if fmt == "ascii":
        tokens = body.split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[0] if p[0] != "list" else p[3]: [] for p in props}
                names = [p[0] for p in props]
                for _ in range(count):
                    for pn in names:
                        cols[pn].append(float(tokens[ti])); ti += 1
                verts = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
                if "nx" in cols:
                    norms = np.stack([cols["nx"], cols["ny"], cols["nz"]], -1).astype(np.float32)
                if "u" in cols:
                    uvs = np.stack([cols["u"], cols["v"]], -1).astype(np.float32)
                elif "s" in cols:
                    uvs = np.stack([cols["s"], cols["t"]], -1).astype(np.float32)
            elif name == "face":
                for _ in range(count):
                    n = int(tokens[ti]); ti += 1
                    idx = [int(tokens[ti + k]) for k in range(n)]; ti += n
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
            else:
                per_row = len(props)
                ti += count * per_row
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dtype = np.dtype([(p[0], "<" + _PLY_TYPES[p[1]][0]) for p in props])
                rows = np.frombuffer(body, dtype, count, off)
                off += dtype.itemsize * count
                verts = np.stack([rows["x"], rows["y"], rows["z"]], -1).astype(np.float32)
                if "nx" in dtype.names:
                    norms = np.stack([rows["nx"], rows["ny"], rows["nz"]], -1).astype(np.float32)
                if "u" in dtype.names:
                    uvs = np.stack([rows["u"], rows["v"]], -1).astype(np.float32)
                elif "s" in dtype.names:
                    uvs = np.stack([rows["s"], rows["t"]], -1).astype(np.float32)
            elif name == "face":
                for _ in range(count):
                    p = props[0]
                    cnt_t, item_t = _PLY_TYPES[p[1]], _PLY_TYPES[p[2]]
                    n = int(np.frombuffer(body, "<" + cnt_t[0], 1, off)[0])
                    off += cnt_t[1]
                    idx = np.frombuffer(body, "<" + item_t[0], n, off)
                    off += item_t[1] * n
                    for k in range(1, n - 1):
                        faces.append((int(idx[0]), int(idx[k]), int(idx[k + 1])))
            else:
                row = sum(_PLY_TYPES[p[1]][1] for p in props if p[0] != "list")
                off += row * count
    else:
        raise ValueError("unsupported PLY format %r" % fmt)

    T = len(faces)
    indices = np.array(faces, np.int32).reshape(T, 3)
    uv = np.zeros((T, 3, 2), np.float32)
    nrm = np.zeros((T, 3, 3), np.float32)
    if uvs is not None:
        u = uvs[indices]                      # [T,3,2]
        uv[:, :, 0] = u[:, :, 0]
        uv[:, :, 1] = 1.0 - u[:, :, 1]        # v-flip, main.cpp:581
    if norms is not None:
        nrm[:] = norms[indices]
    mats = np.full((T,), default_mat, np.int32)
    mesh = TriangleMesh(verts, indices, uv, nrm, mats)
    return fill_missing_normals(mesh)


def write_ply_binary(path, mesh: TriangleMesh):
    """Write vertices(+per-vertex normal/uv averaged from corners) + faces as
    binary_little_endian PLY; exercises the binary read path in tests."""
    V = mesh.num_vertices
    vn = np.zeros((V, 3), np.float64)
    vuv = np.zeros((V, 2), np.float64)
    cnt = np.zeros((V, 1), np.float64)
    for t in range(mesh.num_triangles):
        for c in range(3):
            i = mesh.indices[t, c]
            vn[i] += mesh.normals[t, c]
            vuv[i] += (mesh.uv[t, c, 0], 1.0 - mesh.uv[t, c, 1])
            cnt[i] += 1
    cnt = np.maximum(cnt, 1)
    vn /= cnt
    vuv /= cnt
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % V)
        for p in (b"x", b"y", b"z", b"nx", b"ny", b"nz", b"u", b"v"):
            f.write(b"property float " + p + b"\n")
        f.write(b"element face %d\n" % mesh.num_triangles)
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        rows = np.concatenate([mesh.vertices, vn.astype(np.float32), vuv.astype(np.float32)], -1).astype("<f4")
        f.write(rows.tobytes())
        for t in range(mesh.num_triangles):
            f.write(struct.pack("<B3i", 3, *[int(x) for x in mesh.indices[t]]))
