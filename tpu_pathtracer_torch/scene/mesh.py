"""Triangle mesh container (SoA numpy), the analog of reference Scene
(src/Scene.h:33-67): immutable triangle soup with per-corner uv + normal and
per-triangle material id."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TriangleMesh:
    vertices: np.ndarray      # [V,3] f32
    indices: np.ndarray       # [T,3] i32 vertex indices
    uv: np.ndarray            # [T,3,2] f32 per-corner uv
    normals: np.ndarray       # [T,3,3] f32 per-corner shading normals
    material_ids: np.ndarray  # [T] i32

    @property
    def num_triangles(self):
        return int(self.indices.shape[0])

    @property
    def num_vertices(self):
        return int(self.vertices.shape[0])

    def tri_vertices(self):
        """[T,3,3] world-space corner positions."""
        return self.vertices[self.indices]

    def content_hash(self) -> str:
        import hashlib
        h = hashlib.sha256()
        for a in (self.vertices, self.indices, self.uv, self.normals, self.material_ids):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]

    @staticmethod
    def concatenate(meshes):
        voff = 0
        vs, idx, uv, nr, mat = [], [], [], [], []
        for m in meshes:
            vs.append(m.vertices)
            idx.append(m.indices + voff)
            uv.append(m.uv)
            nr.append(m.normals)
            mat.append(m.material_ids)
            voff += m.num_vertices
        return TriangleMesh(
            np.concatenate(vs, 0).astype(np.float32),
            np.concatenate(idx, 0).astype(np.int32),
            np.concatenate(uv, 0).astype(np.float32),
            np.concatenate(nr, 0).astype(np.float32),
            np.concatenate(mat, 0).astype(np.int32),
        )


def compute_face_normals(mesh: TriangleMesh) -> np.ndarray:
    tv = mesh.tri_vertices()
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def fill_missing_normals(mesh: TriangleMesh) -> TriangleMesh:
    """Where per-corner normals are all-zero, substitute the face normal."""
    face_n = compute_face_normals(mesh)
    zero = np.all(mesh.normals == 0.0, axis=-1)  # [T,3]
    normals = mesh.normals.copy()
    normals[zero] = np.broadcast_to(face_n[:, None, :], mesh.normals.shape)[zero]
    return dataclasses.replace(mesh, normals=normals)
