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

def make_uv_sphere_fast(center, radius, mat_id, n_lat=128, n_lon=256):
    """Vectorized UV sphere for reference-asset-scale tessellation
    (make_uv_sphere's per-quad Python loop is fine at 24x48 but takes
    minutes at 128x256+). Same vertex/uv/normal conventions; pole-
    degenerate triangles dropped."""
    cx, cy, cz = center
    i = np.arange(n_lat + 1)
    j = np.arange(n_lon + 1)
    theta = np.pi * i / n_lat
    phi = 2 * np.pi * j / n_lon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sp, cp = np.sin(phi)[None, :], np.cos(phi)[None, :]
    vx = cx + radius * st * cp
    vy = cy + radius * ct * np.ones_like(sp)
    vz = cz + radius * st * sp
    verts = np.stack([vx, vy, vz], -1).reshape(-1, 3).astype(np.float32)

    ii, jj = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    v00 = ii * (n_lon + 1) + jj
    v01 = v00 + 1
    v10 = v00 + (n_lon + 1)
    v11 = v10 + 1
    # quad -> (v00, v01, v11) + (v00, v11, v10); top row's first tri and
    # bottom row's second tri are pole-degenerate
    t1 = np.stack([v00, v01, v11], -1).reshape(-1, 3)
    t2 = np.stack([v00, v11, v10], -1).reshape(-1, 3)
    k1 = (ii > 0).reshape(-1)
    k2 = (ii < n_lat - 1).reshape(-1)
    idx = np.concatenate([t1[k1], t2[k2]]).astype(np.int32)

    # per-vertex uv/normal derived from the vertex grid, then indexed
    uv_grid = np.stack(
        [np.broadcast_to(j[None, :] / n_lon, (n_lat + 1, n_lon + 1)),
         np.broadcast_to(i[:, None] / n_lat, (n_lat + 1, n_lon + 1))],
        -1).reshape(-1, 2).astype(np.float32)
    nrm_flat = ((verts - np.asarray(center, np.float32)) / radius)
    uv = uv_grid[idx]
    nrm = nrm_flat[idx].astype(np.float32)
    mats = np.full((len(idx),), mat_id, np.int32)
    return TriangleMesh(verts, idx, uv, nrm, mats)


def make_plane_grid(center, size_x, size_z, mat_id, nx=64, nz=64,
                    uv_scale=1.0):
    """Subdivided ground plane (nx*nz cells -> 2*nx*nz triangles)."""
    cx, cy, cz = center
    xs = np.linspace(cx - size_x / 2, cx + size_x / 2, nx + 1)
    zs = np.linspace(cz - size_z / 2, cz + size_z / 2, nz + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    verts = np.stack([gx, np.full_like(gx, cy), gz], -1)
    verts = verts.reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
    v00 = ii * (nz + 1) + jj
    v01 = v00 + 1
    v10 = v00 + (nz + 1)
    v11 = v10 + 1
    t1 = np.stack([v00, v11, v10], -1).reshape(-1, 3)
    t2 = np.stack([v00, v01, v11], -1).reshape(-1, 3)
    idx = np.concatenate([t1, t2]).astype(np.int32)
    u = (gx - xs[0]) / size_x * uv_scale
    w = (gz - zs[0]) / size_z * uv_scale
    uv_grid = np.stack([u, w], -1).reshape(-1, 2).astype(np.float32)
    uv = uv_grid[idx]
    nrm = np.zeros((len(idx), 3, 3), np.float32)
    nrm[:, :, 1] = 1.0
    mats = np.full((len(idx),), mat_id, np.int32)
    return TriangleMesh(verts, idx, uv, nrm, mats)


def make_organic_blob(center=(0.0, 1.0, 0.0), radius=0.9, mat_id=1,
                      n_lat=160, n_lon=320, seed=11):
    """Reference-asset-scale IRREGULAR organic mesh (~2*n_lat*n_lon tris):
    the head.ply stand-in for large-scene media/BSSRDF benchmarks
    (reference src/scenes.txt:8-11 renders subsurface on a scanned ~10^5-tri
    mesh). A regular tessellated sphere is the most packet-coherent geometry
    possible — the BEST case for packet-union traversal — so this blob
    breaks the regularity the way a scan does: multi-octave sinusoidal
    displacement along the radius plus per-vertex lattice jitter, then
    smooth vertex normals recomputed by area-weighted face averaging."""
    sph = make_uv_sphere_fast(center, radius, mat_id,
                              n_lat=n_lat, n_lon=n_lon)
    rng = np.random.default_rng(seed)
    v = sph.vertices.astype(np.float64)
    c = np.asarray(center, np.float64)
    r = v - c
    ln = np.linalg.norm(r, axis=-1, keepdims=True)
    rn = r / np.maximum(ln, 1e-12)
    # multi-octave "scan bumps": smooth across the seam (functions of the
    # 3-D position, not the (i,j) lattice)
    disp = (0.16 * np.sin(2.3 * v[:, 0] + 0.7) * np.cos(1.9 * v[:, 1])
            * np.sin(2.6 * v[:, 2] + 1.1)
            + 0.08 * np.sin(5.1 * v[:, 1] + 2.0) * np.cos(4.3 * v[:, 0])
            + 0.035 * np.sin(11.0 * v[:, 2] + 0.3) * np.sin(9.0 * v[:, 0])
            + 0.015 * np.sin(23.0 * v[:, 1]) * np.cos(19.0 * v[:, 2]))
    v = c + rn * (ln + disp[:, None])
    # lattice jitter: scanned meshes have no regular parameterization; a
    # tangential shuffle of ~1/3 edge length breaks the grid coherence.
    # Pole rows (first/last) stay put so seam vertices keep coinciding.
    edge = radius * 2 * np.pi / n_lon
    jit = rng.normal(scale=edge / 3.0, size=v.shape)
    jit -= np.sum(jit * rn, axis=-1, keepdims=True) * rn  # tangential only
    row = np.arange(v.shape[0]) // (n_lon + 1)
    interior = ((row > 0) & (row < n_lat))[:, None]
    # the lon seam (j=0 and j=n_lon are the same physical point) must
    # move identically: copy column 0's jitter onto column n_lon
    jit = jit.reshape(n_lat + 1, n_lon + 1, 3)
    jit[:, n_lon] = jit[:, 0]
    jit = jit.reshape(-1, 3)
    v = np.where(interior, v + jit, v)
    verts = v.astype(np.float32)

    # smooth vertex normals: area-weighted face-normal accumulation
    idx = sph.indices
    fv = verts[idx]                       # (T,3,3)
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, idx[:, k], fn)
    # seam columns share accumulation
    vn2 = vn.reshape(n_lat + 1, n_lon + 1, 3)
    seam = vn2[:, 0] + vn2[:, n_lon]
    vn2[:, 0] = seam
    vn2[:, n_lon] = seam
    vn = vn2.reshape(-1, 3)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    nrm = vn[idx].astype(np.float32)
    return TriangleMesh(verts, idx, sph.uv, nrm, sph.material_ids)


def make_large_scene(n_lat=128, n_lon=256, ground_div=48):
    """Reference-asset-scale variant of make_test_scene: same composition
    (textured ground, inner Fresnel sphere, outer glass shell, plate), but
    tessellated to the reference's actual workload class — TestObj.obj is
    a user-supplied 10^5-triangle mesh loaded per-face at
    the reference's src/main.cpp:482-587. ~2*2*(n_lat*n_lon) sphere tris
    + 2*ground_div^2 ground tris (~136k at the defaults): the packed BVH
    stream is several MB, far past an SM's L1."""
    ground = make_plane_grid((0, 0, 0), 20.0, 20.0, 0, nx=ground_div,
                             nz=ground_div, uv_scale=8.0)
    inner = make_uv_sphere_fast((0.0, 1.0, 0.0), 0.7, 1,
                                n_lat=n_lat, n_lon=n_lon)
    outer = make_uv_sphere_fast((0.0, 1.0, 0.0), 1.0, 2,
                                n_lat=n_lat, n_lon=n_lon)
    logo = make_box((1.8, 0.3, -1.2), (0.9, 0.6, 0.12), 3)
    return TriangleMesh.concatenate([ground, inner, outer, logo])
