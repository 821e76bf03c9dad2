"""The benchmark's scene inputs, made by the benchmark itself: meshes as
plain numpy arrays, the procedural sky and the checker texture.

These are frozen copies of the generators in
`tpu_pathtracer_torch/scene/procedural.py` (commit 6acb8e4): the same
arithmetic in the same order, so a scene here has the same triangles as the
port's demo scene of the same name. Both the program and the reference are
handed the arrays made here; neither makes its own.

A mesh is a dict: vertices [V,3] f32, indices [T,3] i32, uv [T,3,2] f32,
normals [T,3,3] f32 (per-corner shading normals), material_ids [T] i32.
"""
from __future__ import annotations

import numpy as np


def _mesh(vertices, indices, uv, normals, material_ids):
    return {"vertices": np.asarray(vertices, np.float32),
            "indices": np.asarray(indices, np.int32),
            "uv": np.asarray(uv, np.float32),
            "normals": np.asarray(normals, np.float32),
            "material_ids": np.asarray(material_ids, np.int32)}


def concatenate(meshes):
    voff = 0
    parts = {k: [] for k in ("vertices", "indices", "uv", "normals",
                             "material_ids")}
    for m in meshes:
        parts["vertices"].append(m["vertices"])
        parts["indices"].append(m["indices"] + voff)
        parts["uv"].append(m["uv"])
        parts["normals"].append(m["normals"])
        parts["material_ids"].append(m["material_ids"])
        voff += m["vertices"].shape[0]
    return _mesh(*(np.concatenate(parts[k], 0) for k in (
        "vertices", "indices", "uv", "normals", "material_ids")))


def tri_vertices(mesh):
    """[T,3,3] corner positions."""
    return mesh["vertices"][mesh["indices"]]


def _face_normals(mesh):
    tv = tri_vertices(mesh)
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def _fill_missing_normals(mesh):
    face_n = _face_normals(mesh)
    zero = np.all(mesh["normals"] == 0.0, axis=-1)
    normals = mesh["normals"].copy()
    normals[zero] = np.broadcast_to(face_n[:, None, :],
                                    mesh["normals"].shape)[zero]
    return dict(mesh, normals=normals)


def make_box(center, size, mat_id):
    cx, cy, cz = center
    sx, sy, sz = size
    hx, hy, hz = sx / 2, sy / 2, sz / 2
    corners = np.array([
        [cx - hx, cy - hy, cz - hz], [cx + hx, cy - hy, cz - hz],
        [cx + hx, cy + hy, cz - hz], [cx - hx, cy + hy, cz - hz],
        [cx - hx, cy - hy, cz + hz], [cx + hx, cy - hy, cz + hz],
        [cx + hx, cy + hy, cz + hz], [cx - hx, cy + hy, cz + hz],
    ], np.float32)
    quads = [(0, 1, 2, 3), (5, 4, 7, 6), (4, 0, 3, 7),
             (1, 5, 6, 2), (3, 2, 6, 7), (4, 5, 1, 0)]
    idx = []
    for q in quads:
        idx.append([q[0], q[2], q[1]])
        idx.append([q[0], q[3], q[2]])
    idx = np.array(idx, np.int32)
    T = len(idx)
    mesh = _mesh(corners, idx, np.zeros((T, 3, 2), np.float32),
                 np.zeros((T, 3, 3), np.float32),
                 np.full((T,), mat_id, np.int32))
    return _fill_missing_normals(mesh)


def make_uv_sphere_fast(center, radius, mat_id, n_lat=128, n_lon=256):
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
    t1 = np.stack([v00, v01, v11], -1).reshape(-1, 3)
    t2 = np.stack([v00, v11, v10], -1).reshape(-1, 3)
    k1 = (ii > 0).reshape(-1)
    k2 = (ii < n_lat - 1).reshape(-1)
    idx = np.concatenate([t1[k1], t2[k2]]).astype(np.int32)
    uv_grid = np.stack(
        [np.broadcast_to(j[None, :] / n_lon, (n_lat + 1, n_lon + 1)),
         np.broadcast_to(i[:, None] / n_lat, (n_lat + 1, n_lon + 1))],
        -1).reshape(-1, 2).astype(np.float32)
    nrm_flat = ((verts - np.asarray(center, np.float32)) / radius)
    return _mesh(verts, idx, uv_grid[idx], nrm_flat[idx].astype(np.float32),
                 np.full((len(idx),), mat_id, np.int32))


def make_plane_grid(center, size_x, size_z, mat_id, nx=64, nz=64,
                    uv_scale=1.0):
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
    nrm = np.zeros((len(idx), 3, 3), np.float32)
    nrm[:, :, 1] = 1.0
    return _mesh(verts, idx, uv_grid[idx], nrm,
                 np.full((len(idx),), mat_id, np.int32))


def make_organic_blob(center=(0.0, 1.0, 0.0), radius=0.9, mat_id=1,
                      n_lat=160, n_lon=320, seed=11):
    """The ~2*n_lat*n_lon-triangle irregular blob (the scanned head's
    stand-in): a displaced, jittered UV sphere with area-weighted smooth
    vertex normals."""
    sph = make_uv_sphere_fast(center, radius, mat_id, n_lat=n_lat,
                              n_lon=n_lon)
    rng = np.random.default_rng(seed)
    v = sph["vertices"].astype(np.float64)
    c = np.asarray(center, np.float64)
    r = v - c
    ln = np.linalg.norm(r, axis=-1, keepdims=True)
    rn = r / np.maximum(ln, 1e-12)
    disp = (0.16 * np.sin(2.3 * v[:, 0] + 0.7) * np.cos(1.9 * v[:, 1])
            * np.sin(2.6 * v[:, 2] + 1.1)
            + 0.08 * np.sin(5.1 * v[:, 1] + 2.0) * np.cos(4.3 * v[:, 0])
            + 0.035 * np.sin(11.0 * v[:, 2] + 0.3) * np.sin(9.0 * v[:, 0])
            + 0.015 * np.sin(23.0 * v[:, 1]) * np.cos(19.0 * v[:, 2]))
    v = c + rn * (ln + disp[:, None])
    edge = radius * 2 * np.pi / n_lon
    jit = rng.normal(scale=edge / 3.0, size=v.shape)
    jit -= np.sum(jit * rn, axis=-1, keepdims=True) * rn
    row = np.arange(v.shape[0]) // (n_lon + 1)
    interior = ((row > 0) & (row < n_lat))[:, None]
    jit = jit.reshape(n_lat + 1, n_lon + 1, 3)
    jit[:, n_lon] = jit[:, 0]
    jit = jit.reshape(-1, 3)
    v = np.where(interior, v + jit, v)
    verts = v.astype(np.float32)
    idx = sph["indices"]
    fv = verts[idx]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, idx[:, k], fn)
    vn2 = vn.reshape(n_lat + 1, n_lon + 1, 3)
    seam = vn2[:, 0] + vn2[:, n_lon]
    vn2[:, 0] = seam
    vn2[:, n_lon] = seam
    vn = vn2.reshape(-1, 3)
    vn /= np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)
    return _mesh(verts, idx, sph["uv"], vn[idx].astype(np.float32),
                 sph["material_ids"])


def large_scene(n_lat=128, n_lon=256, ground_div=48):
    """TestObj at the reference's mesh scale: textured ground (mat 0),
    inner sphere (mat 1), outer shell (mat 2), plate (mat 3)."""
    return concatenate([
        make_plane_grid((0, 0, 0), 20.0, 20.0, 0, nx=ground_div,
                        nz=ground_div, uv_scale=8.0),
        make_uv_sphere_fast((0.0, 1.0, 0.0), 0.7, 1, n_lat=n_lat,
                            n_lon=n_lon),
        make_uv_sphere_fast((0.0, 1.0, 0.0), 1.0, 2, n_lat=n_lat,
                            n_lon=n_lon),
        make_box((1.8, 0.3, -1.2), (0.9, 0.6, 0.12), 3)])


def large_organic_scene(n_lat=160, n_lon=320, ground_div=32):
    """The organic blob (mat 1) over a textured ground grid (mat 0)."""
    return concatenate([
        make_plane_grid((0, 0, 0), 20.0, 20.0, 0, nx=ground_div,
                        nz=ground_div, uv_scale=8.0),
        make_organic_blob(n_lat=n_lat, n_lon=n_lon, mat_id=1)])


MESHES = {"large_scene": large_scene,
          "large_organic_scene": large_organic_scene}


def make_checker_texture(size=256, tiles=8):
    y, x = np.mgrid[0:size, 0:size]
    c = (((x * tiles // size) + (y * tiles // size)) % 2).astype(np.float32)
    col_a = np.array([0.85, 0.85, 0.85], np.float32)
    col_b = np.array([0.18, 0.25, 0.35], np.float32)
    return (c[..., None] * col_a + (1 - c[..., None]) * col_b).astype(
        np.float32)


def make_sky_envmap(width=512, height=256, sun_dir=(0.35, 0.55, 0.75),
                    sun_intensity=50.0, sun_sharpness=800.0):
    """Gradient sky and a gaussian sun disk, lat-long, [H,W,3] f32."""
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    v = (np.arange(height) + 0.5) / height * np.pi
    u = (np.arange(width) + 0.5) / width * 2 * np.pi
    theta, phi = np.meshgrid(v, u, indexing="ij")
    d = np.stack([np.sin(theta) * np.sin(phi), np.cos(theta),
                  np.sin(theta) * np.cos(phi)], -1)
    cos_sun = np.clip(np.sum(d * sun, -1), -1, 1)
    horizon = np.clip(d[..., 1], 0, 1) ** 0.5
    sky = (np.array([0.5, 0.7, 1.0]) * horizon[..., None]
           + np.array([0.9, 0.85, 0.8]) * (1 - horizon[..., None]) * 0.6)
    ground = np.array([0.25, 0.22, 0.2]) * np.ones_like(sky)
    base = np.where(d[..., 1:2] >= 0, sky, ground)
    sun_term = sun_intensity * np.exp(sun_sharpness
                                      * (cos_sun - 1.0))[..., None]
    return (base + sun_term).astype(np.float32)


def make_inputs(config):
    """(mesh, materials, envmap, texture) of a configuration file's
    `scene` entry."""
    sc = config["scene"]
    mesh = MESHES[sc["mesh"]](**sc.get("mesh_args", {}))
    return (mesh, [dict(m) for m in sc["materials"]], make_sky_envmap(),
            make_checker_texture())
