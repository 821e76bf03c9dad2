"""Procedural test assets.

The reference's large binary assets (TestObj.obj, pisa.hdr) are not shipped;
we generate equivalent test scenes procedurally: a ground plane + nested
spheres layout mirroring the TestObj composition (MAT_FRESNEL inner sphere,
MAT_GLASS outer shell, MAT_REFL logo plate, textured MAT_DIFF ground — see
data/sceneDesc.json), a checker texture, and a sun+gradient HDR sky.
"""
from __future__ import annotations

import numpy as np

from .mesh import TriangleMesh, fill_missing_normals


def make_plane(center, size_x, size_z, mat_id, uv_scale=1.0, y=None):
    cx, cy, cz = center
    hx, hz = size_x / 2.0, size_z / 2.0
    v = np.array([
        [cx - hx, cy, cz - hz],
        [cx + hx, cy, cz - hz],
        [cx + hx, cy, cz + hz],
        [cx - hx, cy, cz + hz],
    ], np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    uvc = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    uv = uvc[idx]
    nrm = np.zeros((2, 3, 3), np.float32)
    nrm[:, :, 1] = 1.0
    mats = np.full((2,), mat_id, np.int32)
    return TriangleMesh(v, idx, uv.astype(np.float32), nrm, mats)


def make_uv_sphere(center, radius, mat_id, n_lat=16, n_lon=32):
    cx, cy, cz = center
    verts = []
    for i in range(n_lat + 1):
        theta = np.pi * i / n_lat
        for j in range(n_lon + 1):
            phi = 2 * np.pi * j / n_lon
            verts.append([
                cx + radius * np.sin(theta) * np.cos(phi),
                cy + radius * np.cos(theta),
                cz + radius * np.sin(theta) * np.sin(phi),
            ])
    verts = np.array(verts, np.float32)

    def vid(i, j):
        return i * (n_lon + 1) + j

    idx, uv, nrm = [], [], []
    for i in range(n_lat):
        for j in range(n_lon):
            quad = [vid(i, j), vid(i, j + 1), vid(i + 1, j + 1), vid(i + 1, j)]
            for tri in ([quad[0], quad[1], quad[2]], [quad[0], quad[2], quad[3]]):
                if len(set(tuple(np.round(verts[t], 6)) for t in tri)) < 3:
                    continue  # degenerate at poles
                idx.append(tri)
                uv.append([[verts[t][0] * 0 + (t % (n_lon + 1)) / n_lon,
                            (t // (n_lon + 1)) / n_lat] for t in tri])
                nrm.append([(verts[t] - np.array(center)) / radius for t in tri])
    mesh = TriangleMesh(
        verts, np.array(idx, np.int32), np.array(uv, np.float32),
        np.array(nrm, np.float32), np.full((len(idx),), mat_id, np.int32))
    return mesh


def make_box(center, size, mat_id):
    cx, cy, cz = center
    sx, sy, sz = (size, size, size) if np.isscalar(size) else size
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    corners = np.array([
        [cx - hx, cy - hy, cz - hz], [cx + hx, cy - hy, cz - hz],
        [cx + hx, cy + hy, cz - hz], [cx - hx, cy + hy, cz - hz],
        [cx - hx, cy - hy, cz + hz], [cx + hx, cy - hy, cz + hz],
        [cx + hx, cy + hy, cz + hz], [cx - hx, cy + hy, cz + hz],
    ], np.float32)
    quads = [
        (0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7),
        (1, 5, 6, 2), (3, 2, 6, 7), (4, 5, 1, 0),
    ]
    idx = []
    for q in quads:
        idx.append([q[0], q[2], q[1]])
        idx.append([q[0], q[3], q[2]])
    idx = np.array(idx, np.int32)
    T = len(idx)
    uv = np.zeros((T, 3, 2), np.float32)
    nrm = np.zeros((T, 3, 3), np.float32)
    mesh = TriangleMesh(corners, idx, uv, nrm, np.full((T,), mat_id, np.int32))
    return fill_missing_normals(mesh)


def make_test_scene(mats=("ground", "inner", "outer", "logo")):
    """The standard test composition (mirrors the TestObj layout implied by
    data/sceneDesc.json + renderingResult gallery): textured diffuse ground
    (mat 0), inner sphere (mat 1), outer glass shell sphere (mat 2), and a
    reflective plate (mat 3)."""
    ground = make_plane((0, 0, 0), 20.0, 20.0, 0, uv_scale=8.0)
    inner = make_uv_sphere((0.0, 1.0, 0.0), 0.7, 1, n_lat=24, n_lon=48)
    outer = make_uv_sphere((0.0, 1.0, 0.0), 1.0, 2, n_lat=24, n_lon=48)
    logo = make_box((1.8, 0.3, -1.2), (0.9, 0.6, 0.12), 3)
    return TriangleMesh.concatenate([ground, inner, outer, logo])


def make_checker_texture(size=256, tiles=8):
    """Linear-space checker (the analog of data/Checker.png)."""
    y, x = np.mgrid[0:size, 0:size]
    c = (((x * tiles // size) + (y * tiles // size)) % 2).astype(np.float32)
    col_a = np.array([0.85, 0.85, 0.85], np.float32)
    col_b = np.array([0.18, 0.25, 0.35], np.float32)
    return (c[..., None] * col_a + (1 - c[..., None]) * col_b).astype(np.float32)


def make_sky_envmap(width=512, height=256, sun_dir=(0.35, 0.55, 0.75),
                    sun_intensity=50.0, sun_sharpness=800.0):
    """Gradient sky + gaussian sun disk, in lat-long layout (the analog of
    data/pisa.hdr as an HDR light source)."""
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    v = (np.arange(height) + 0.5) / height * np.pi            # polar
    u = (np.arange(width) + 0.5) / width * 2 * np.pi          # azimuth
    theta, phi = np.meshgrid(v, u, indexing="ij")
    # envLight convention: u from atan2(x, z), v from acos(y)
    d = np.stack([np.sin(theta) * np.sin(phi),
                  np.cos(theta),
                  np.sin(theta) * np.cos(phi)], -1)
    cos_sun = np.clip(np.sum(d * sun, -1), -1, 1)
    horizon = np.clip(d[..., 1], 0, 1) ** 0.5
    sky = (np.array([0.5, 0.7, 1.0]) * horizon[..., None]
           + np.array([0.9, 0.85, 0.8]) * (1 - horizon[..., None]) * 0.6)
    ground = np.array([0.25, 0.22, 0.2]) * np.ones_like(sky)
    base = np.where(d[..., 1:2] >= 0, sky, ground)
    sun_term = sun_intensity * np.exp(sun_sharpness * (cos_sun - 1.0))[..., None]
    return (base + sun_term).astype(np.float32)
