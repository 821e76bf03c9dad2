"""Wavefront OBJ loader and writer (numpy; the port's copy of
scene/objloader.py).

Behavioral parity with the reference OBJ path (src/main.cpp:482-587):
per-face-corner uv with a v-flip (uv.y = 1 - t), per-corner normals, and
material ids resolved by *material name* through the scene desc's
mat_id_map (src/SceneDesc.cpp:50-70, consumed at src/main.cpp:520).
"""
from __future__ import annotations

import numpy as np

from .mesh import TriangleMesh, fill_missing_normals


def load_obj(path, mat_id_map=None, default_mat=0):
    """Parse an OBJ file into a TriangleMesh.

    mat_id_map: dict material-name -> material id (from SceneDesc). Unknown /
    missing materials map to default_mat (the reference's unordered_map
    operator[] would insert 0 likewise).
    """
    mat_id_map = mat_id_map or {}
    positions, texcoords, normals = [], [], []
    faces = []  # (corner_triples, mat_id)
    cur_mat = default_mat

    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                texcoords.append([float(parts[1]), float(parts[2])])
            elif tag == "vn":
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                cur_mat = mat_id_map.get(name, default_mat)
            elif tag == "f":
                corners = []
                for w in parts[1:]:
                    comps = w.split("/")
                    vi = int(comps[0])
                    ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    corners.append((vi, ti, ni))
                # fan-triangulate n-gons
                for k in range(1, len(corners) - 1):
                    faces.append(((corners[0], corners[k], corners[k + 1]), cur_mat))

    V = np.array(positions, np.float32) if positions else np.zeros((0, 3), np.float32)
    VT = np.array(texcoords, np.float32) if texcoords else np.zeros((0, 2), np.float32)
    VN = np.array(normals, np.float32) if normals else np.zeros((0, 3), np.float32)

    def resolve(idx, count):
        # OBJ is 1-based; negative indexes from the end
        return idx - 1 if idx > 0 else count + idx

    T = len(faces)
    indices = np.zeros((T, 3), np.int32)
    uv = np.zeros((T, 3, 2), np.float32)
    nrm = np.zeros((T, 3, 3), np.float32)
    mats = np.zeros((T,), np.int32)
    for t, (corners, mat) in enumerate(faces):
        mats[t] = mat
        for c, (vi, ti, ni) in enumerate(corners):
            indices[t, c] = resolve(vi, len(positions))
            if ti != 0 and len(texcoords):
                tc = VT[resolve(ti, len(texcoords))]
                uv[t, c] = (tc[0], 1.0 - tc[1])  # v-flip, main.cpp:507-509
            if ni != 0 and len(normals):
                nrm[t, c] = VN[resolve(ni, len(normals))]

    mesh = TriangleMesh(V, indices, uv, nrm, mats)
    return fill_missing_normals(mesh)


def write_obj(path, mesh: TriangleMesh, mat_names=None):
    """Write a TriangleMesh as OBJ (used to persist procedural test scenes so
    the loader path is exercised end-to-end)."""
    mat_names = mat_names or {}
    with open(path, "w") as f:
        f.write("# tpu_pathtracer procedural scene\n")
        for v in mesh.vertices:
            f.write("v %.9g %.9g %.9g\n" % tuple(v))
        # per-corner uv/normals -> flat streams (3 per face)
        for t in range(mesh.num_triangles):
            for c in range(3):
                u, vv = mesh.uv[t, c]
                f.write("vt %.9g %.9g\n" % (u, 1.0 - vv))  # undo v-flip
        for t in range(mesh.num_triangles):
            for c in range(3):
                f.write("vn %.9g %.9g %.9g\n" % tuple(mesh.normals[t, c]))
        cur = None
        for t in range(mesh.num_triangles):
            m = int(mesh.material_ids[t])
            if m != cur:
                f.write("usemtl %s\n" % mat_names.get(m, "mat%d" % m))
                cur = m
            base = 3 * t + 1
            f.write("f %d/%d/%d %d/%d/%d %d/%d/%d\n" % (
                mesh.indices[t, 0] + 1, base, base,
                mesh.indices[t, 1] + 1, base + 1, base + 1,
                mesh.indices[t, 2] + 1, base + 2, base + 2))
