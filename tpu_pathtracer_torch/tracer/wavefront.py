"""Render settings, traversal dispatch and the per-wave shading stages
(port of tracer/wavefront.py).

Every stage is plain tensor code over lane columns. What changed from the
JAX version: `gather_material` is a row gather (the one-hot matmul was a
TPU choice), and the classic bounce integrator (`make_integrator`) is not
ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.vecmath import PI, normalize, reflect, barycentric
from ..core.rng import RaySampler
from ..scene.config import (
    MAT_EMIT, MAT_GLASS, MAT_REFL, MAT_DIFF_REFL, MAT_FRESNEL, MAT_NULL,
    MAT_SUBSURFACE,
)
from ..scene.texture import (
    sample_texture_quad, sample_envmap_quad, sample_envmap_quad_pdf,
    _uv_from_dir, _corner_pdf, _bilinear_rows,
)
from ..materials.bsdf import (
    lambertian_sample, specular_glass_sample, ggx_reflection_sample,
    rough_glass_sample, microfacet_interface_sample, fresnel_blend_sample,
)
from .envsample import power_heuristic
from .traverse import intersect_scene


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static configuration; the same fields and defaults as the JAX
    package's RenderSettings. Fields that tune the TPU packet kernel's
    schedule (packet_*, anyhit_early_stop, trace_active_prefix) are kept so
    that one settings object describes a render in both packages; the
    port's traversal returns the same result for every value of them."""
    bounce_min: int = 2
    bounce_max: int = 16
    use_envmap: bool = True
    use_texture: bool = True
    has_media: bool = False
    has_bssrdf: bool = False
    use_distant_light: bool = False
    stack_depth: int = 64
    bssrdf_probes: int = 3
    bssrdf_use_soe: bool = True
    # next-event estimation toward the envmap with MIS
    env_importance_sampling: bool = True
    # NEE draws restricted to the top-k brightest texels (<= 0 disables)
    env_nee_topk: int = 16384
    # "regen" = path regeneration (tracer/regen.py); "bounce" = the classic
    # bounce loop, not ported yet
    integrator: str = "regen"
    # pool order: "compact" (ported) or "inplace" (not ported yet)
    regen_order: str = "compact"
    # compact permute: "gather" (ported) or "sort" (not ported yet)
    regen_permute: str = "gather"
    # regen pool width cap in lanes; <= 0 means image-sized
    pool_lanes: int = 1 << 20
    # profiling hook of the JAX bench; not ported ("" = off)
    dup_stage: str = ""
    # how radiance reaches the image: "ring"/"deferred" bank it on the path
    # and add it at the path's death, "wave" adds every wave (regen.py)
    scatter_mode: str = "ring"
    dense_fresh_flush: bool = True
    distant_light_L: tuple = (1.2, 1.2, 1.2)
    distant_light_dir: tuple = (0.0, 1.3, -3.6)
    # "auto"/"packet" = packet_intersect (CUDA kernel for CUDA tensors),
    # "wavefront" = the plain PyTorch step machine
    traversal: str = "auto"
    packet_tile_sub: int = 8
    packet_interleave: int = 8
    packet_step: str = "fused"
    packet_queue_k: int = 128
    trace_active_prefix: bool = True
    anyhit_early_stop: bool = False
    packet_table_mem: str = "auto"
    # one gather for the env-miss and texture fetches (env_tex_merged)
    merge_envtex: bool = True
    packet_step_unroll: int = 1


def trace_rays(scene, settings: RenderSettings, orig, raydir, tmin, tmax,
               anyhit=False, active=None, active_prefix=None):
    """Traversal dispatch. active_prefix (an int) asserts that the active
    set is the exact lane prefix [0, n); `active` must still be passed for
    the plain path."""
    mode = settings.traversal
    if mode == "wavefront":
        return intersect_scene(
            scene["prims"], scene["meta"], scene["num_nodes"], orig, raydir,
            tmin, tmax, anyhit=anyhit, stack_depth=settings.stack_depth,
            active=active, packed=scene["packed"])
    if mode not in ("auto", "packet"):
        raise ValueError("unknown traversal %r (want auto/packet/wavefront)"
                         % (mode,))
    from ..ops.traverse_packet import packet_intersect
    use_prefix = (active_prefix is not None and settings.trace_active_prefix
                  and not isinstance(tmax, torch.Tensor))
    return packet_intersect(
        scene["packed"], orig, raydir, tmin, tmax, anyhit=anyhit,
        stack_depth=settings.stack_depth,
        active=None if use_prefix else active,
        active_prefix=active_prefix if use_prefix else None,
        tile_sub=settings.packet_tile_sub,
        interleave=settings.packet_interleave,
        step_mode=settings.packet_step,
        queue_k=settings.packet_queue_k,
        table_mem=settings.packet_table_mem,
        step_unroll=settings.packet_step_unroll,
        anyhit_early_stop=settings.anyhit_early_stop)


def pack_tri_attributes(tri_pos, tri_uv, tri_nrm, tri_mat,
                        prims=None, num_nodes=0):
    """Pack the per-slot attribute streams into one (Kt,28) f32 array:
    pos[0:9] uv[9:15] nrm[15:24] mat[24] (int32 bits) geo_n[25:28], the
    Woop rows' cross(m1.xyz, m2.xyz) (zero when prims is None)."""
    Kt = tri_pos.shape[0]
    out = np.zeros((Kt, 28), np.float32)
    out[:, 0:9] = tri_pos
    out[:, 9:15] = tri_uv
    out[:, 15:24] = tri_nrm
    out[:, 24] = np.asarray(tri_mat, np.int32).view(np.float32)
    if prims is not None:
        p = np.asarray(prims[num_nodes:num_nodes + Kt], np.float32)
        out[:, 25:28] = np.cross(p[:, 4:7], p[:, 8:11])
    return out


def fetch_attributes(scene, hit_slot, hitpoint):
    """Barycentric-interpolated uv + smooth normal + geometric normal at the
    hit, from one row gather. Returns (hit_uv, smooth_n, mat_id, tri_n);
    tri_n is zero on miss lanes."""
    a = scene["tri_attr"][torch.clamp_min(hit_slot, 0).long()]     # [N,28]
    p0, p1, p2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    u, v, w = barycentric(hitpoint, p0, p1, p2)
    hit_uv = (u[:, None] * a[:, 9:11] + v[:, None] * a[:, 11:13]
              + w[:, None] * a[:, 13:15])
    smooth_n = (u[:, None] * a[:, 15:18] + v[:, None] * a[:, 18:21]
                + w[:, None] * a[:, 21:24])
    mat_id = a[:, 24].contiguous().view(torch.int32)
    tri_n = torch.where((hit_slot >= 0)[:, None], a[:, 25:28], 0.0)
    return hit_uv, smooth_n, mat_id, tri_n


# material table column layout (see materials_to_arrays / pack_mat_table)
_MAT_COLS = {
    "refltype": (0, 1), "objcol": (1, 4), "emit": (4, 7), "alphax": (7, 8),
    "alphay": (8, 9), "kd": (9, 10), "ks": (10, 11), "etaT": (11, 12),
    "useNormal": (12, 13), "useTexture": (13, 14), "F0": (14, 17),
    "tangent": (17, 20), "mfp": (20, 23), "med_sigma_s": (23, 26),
    "med_sigma_a": (26, 29), "med_g": (29, 30), "has_medium": (30, 31),
}
_INT_MAT_COLS = ("refltype", "useNormal", "useTexture", "has_medium")


def pack_mat_table(mat_arrays):
    """Pack material SoA columns into one (M,31) f32 table (numpy)."""
    M = mat_arrays["refltype"].shape[0]
    t = np.zeros((M, 31), np.float32)
    for k, (a, b) in _MAT_COLS.items():
        v = np.asarray(mat_arrays[k], np.float32)
        t[:, a:b] = v.reshape(M, b - a)
    return t


def gather_material(scene, mat_id):
    """Per-lane material parameters: one row gather of the (M,31) table.
    An id outside [0, M) reads a row of zeros, as the JAX package's one-hot
    product gives."""
    table = scene["mat_table"]
    M = table.shape[0]
    padded = torch.cat([table, torch.zeros_like(table[:1])], dim=0)
    ok = (mat_id >= 0) & (mat_id < M)
    rows = padded[torch.where(ok, mat_id, M).long()]
    m = {}
    for k, (a, b) in _MAT_COLS.items():
        v = rows[:, a:b] if b - a > 1 else rows[:, a]
        if k in _INT_MAT_COLS:
            v = v.to(torch.int32)
        m[k] = v
    return m


def env_radiance(scene, settings: RenderSettings, raydir, env_rotation):
    if settings.use_envmap:
        return sample_envmap_quad(scene["envmap_quad"], scene["env_h"],
                                  scene["env_w"], raydir, env_rotation)
    return scene["env_const"].expand(raydir.shape)


def _mis_env_weight(raydir, p_uv, bsdf_pdf):
    """BSDF-side MIS weight of an env hit; bsdf_pdf < 0 means no env NEE at
    the previous vertex (weight 1)."""
    y = raydir[:, 1]
    sin_t = torch.sqrt(torch.clamp_min(1.0 - y * y, 1e-8))
    pdf_e = p_uv / (2.0 * PI * PI * sin_t)
    return torch.where(bsdf_pdf < 0.0, 1.0, power_heuristic(bsdf_pdf, pdf_e))


def env_miss_weighted(scene, settings: RenderSettings, raydir, bsdf_pdf,
                      env_rotation):
    """Environment radiance already weighted by the BSDF-side MIS factor;
    the sampler pdf comes from the same quad-row gather as the radiance."""
    if not settings.use_envmap:
        return scene["env_const"].expand(raydir.shape)
    if not settings.env_importance_sampling:
        return env_radiance(scene, settings, raydir, env_rotation)
    L, p_uv = sample_envmap_quad_pdf(
        scene["envmap_quad"], scene["env_h"], scene["env_w"], raydir,
        env_rotation)
    return _mis_env_weight(raydir, p_uv, bsdf_pdf)[:, None] * L


def texture_radiance(scene, hit_uv):
    return sample_texture_quad(scene["texture_quad"], scene["tex_h"],
                               scene["tex_w"], hit_uv[:, 0], hit_uv[:, 1])


def pack_envtex_quad(env_quad16, tex_quad12):
    """Concatenate the 16-col env quad table and the zero-padded 12-col
    texture quad table into one gather target; texture row r sits at
    env_h*env_w + r (numpy)."""
    e = np.asarray(env_quad16, np.float32)
    t = np.asarray(tex_quad12, np.float32)
    out = np.zeros((e.shape[0] + t.shape[0], 16), np.float32)
    out[:e.shape[0]] = e
    out[e.shape[0]:, :12] = t
    return out


def env_tex_merged(scene, settings: RenderSettings, raydir, bsdf_pdf,
                   env_rotation, miss, hit_uv):
    """MIS-weighted env-miss radiance AND texture radiance from one gather
    of the merged envtex_quad table: a miss lane reads its env row, any
    other lane its texture row. Returns (env_weighted_L [N,3],
    tex_rgb [N,3]), equal to env_miss_weighted / texture_radiance.

    Miss lanes carry non-finite hit_uv (the hit point at t = RAY_MAX);
    their texture row index is kept in range by the remainders and never
    selected."""
    He, We = scene["env_h"], scene["env_w"]
    Ht, Wt = scene["tex_h"], scene["tex_w"]
    u_e, v_e = _uv_from_dir(raydir, env_rotation)
    xe = u_e * We - 0.5
    ye = v_e * He - 0.5
    xe0 = torch.floor(xe)
    ye0 = torch.floor(ye)
    fxe = (xe - xe0)[..., None]
    fye = (ye - ye0)[..., None]
    xe0i = torch.clamp(xe0.to(torch.int32), 0, We - 1)
    ye0i = torch.clamp(ye0.to(torch.int32), 0, He - 1)
    env_row = ye0i * We + xe0i
    u_t = torch.remainder(hit_uv[:, 0], 1.0)
    v_t = torch.remainder(hit_uv[:, 1], 1.0)
    xt = u_t * Wt - 0.5
    yt = v_t * Ht - 0.5
    xt0 = torch.floor(xt)
    yt0 = torch.floor(yt)
    fxt = (xt - xt0)[..., None]
    fyt = (yt - yt0)[..., None]
    xt0i = torch.remainder(xt0.to(torch.int32), Wt)
    yt0i = torch.remainder(yt0.to(torch.int32), Ht)
    tex_row = He * We + yt0i * Wt + xt0i

    q = scene["envtex_quad"][torch.where(miss, env_row, tex_row).long()]
    p_uv = _corner_pdf(q, u_e, v_e, xe0i, ye0i, He, We)
    env_L = _mis_env_weight(raydir, p_uv, bsdf_pdf)[:, None] \
        * _bilinear_rows(q, fxe, fye)
    return env_L, _bilinear_rows(q, fxt, fyt)


def shade(scene, settings, rng, raydir, n, nl, into, mat, objcol):
    """Evaluate every material branch and select by refltype; six RNG draws
    per lane, in the JAX package's order.

    Returns (rng, next_dir, mask_mul [N,3], offset_steps [N], terminate [N],
    bounce_inc [N], aux)."""
    N = raydir.shape[0]
    rng, (u1, u2, u3, u4, u5, u6) = RaySampler.next_n(rng, 6)
    refl_t = mat["refltype"]
    one3 = torch.ones((N, 3), dtype=torch.float32, device=raydir.device)

    # MAT_DIFF
    d_dir = lambertian_sample(u1, u2, nl)
    d_mul = mat["kd"][:, None] * objcol
    # MAT_REFL; a mirror offsets twice (reference quirk kept)
    mirror = mat["alphax"] == 0.0
    mir_dir = normalize(reflect(raydir, n))
    g_dir, g_beta = ggx_reflection_sample(
        u1, u2, raydir, nl, mat["tangent"], mat["F0"],
        mat["alphax"], mat["alphay"])
    r_dir = torch.where(mirror[:, None], mir_dir, g_dir)
    r_mul = torch.where(mirror[:, None],
                        mat["ks"][:, None] * objcol,
                        mat["ks"][:, None] * g_beta * objcol)
    r_off = torch.where(mirror, 2.0, 1.0)
    # MAT_DIFF_REFL
    dr_spec = u5 < mat["ks"] / torch.clamp_min(mat["ks"] + mat["kd"], 1e-7)
    dr_dir = torch.where(dr_spec[:, None], g_dir, d_dir)
    dr_mul = torch.where(dr_spec[:, None], g_beta, objcol)
    # MAT_FRESNEL
    f_dir, f_beta = fresnel_blend_sample(
        u1, u2, u3, raydir, nl, mat["kd"][:, None] * objcol, mat["F0"],
        mat["alphax"])
    # MAT_GLASS
    sg_dir, sg_refl = specular_glass_sample(u1, into, raydir, nl,
                                            mat["etaT"])
    rg_dir, rg_beta, rg_refl = rough_glass_sample(
        u1, u2, into, raydir, nl, mat["etaT"], mat["alphax"])
    smooth = mat["alphax"] == 0.0
    gl_refl = torch.where(smooth, sg_refl, rg_refl)
    gl_dir = torch.where(smooth[:, None], sg_dir, rg_dir)
    eta2 = mat["etaT"] * mat["etaT"]
    rg_mul = rg_beta[:, None] * objcol \
        * torch.where((~rg_refl & ~into)[:, None], eta2[:, None], 1.0)
    gl_mul = torch.where(smooth[:, None], one3, rg_mul)
    gl_off = torch.where(gl_refl, 1.0, -1.0)
    # MAT_SUBSURFACE entry interface
    ss_m, ss_rdir, ss_beta, ss_refl = microfacet_interface_sample(
        u1, u2, into, raydir, nl, mat["etaT"], mat["alphax"])
    ss_refl_mul = ss_beta[:, None] * mat["ks"][:, None] * objcol

    def sel(t):
        return (refl_t == t)[:, None]

    next_dir = d_dir
    next_dir = torch.where(sel(MAT_REFL), r_dir, next_dir)
    next_dir = torch.where(sel(MAT_DIFF_REFL), dr_dir, next_dir)
    next_dir = torch.where(sel(MAT_FRESNEL), f_dir, next_dir)
    next_dir = torch.where(sel(MAT_GLASS), gl_dir, next_dir)
    next_dir = torch.where(sel(MAT_SUBSURFACE), ss_rdir, next_dir)
    next_dir = torch.where(sel(MAT_NULL), raydir, next_dir)

    mask_mul = d_mul
    mask_mul = torch.where(sel(MAT_REFL), r_mul, mask_mul)
    mask_mul = torch.where(sel(MAT_DIFF_REFL), dr_mul, mask_mul)
    mask_mul = torch.where(sel(MAT_FRESNEL), f_beta, mask_mul)
    mask_mul = torch.where(sel(MAT_GLASS), gl_mul, mask_mul)
    mask_mul = torch.where(sel(MAT_SUBSURFACE), ss_refl_mul, mask_mul)
    mask_mul = torch.where(sel(MAT_NULL), one3, mask_mul)

    offset = torch.ones((N,), dtype=torch.float32, device=raydir.device)
    offset = torch.where(refl_t == MAT_REFL, r_off, offset)
    offset = torch.where(refl_t == MAT_DIFF_REFL, 0.0, offset)
    offset = torch.where(refl_t == MAT_FRESNEL, 0.0, offset)
    offset = torch.where(refl_t == MAT_GLASS, gl_off, offset)
    offset = torch.where(refl_t == MAT_SUBSURFACE, 1.0, offset)
    offset = torch.where(refl_t == MAT_NULL, -1.0, offset)

    terminate = refl_t == MAT_EMIT
    is_specular_event = (
        (refl_t == MAT_REFL)
        | ((refl_t == MAT_DIFF_REFL) & dr_spec)
        | (refl_t == MAT_FRESNEL)
        | (refl_t == MAT_GLASS)
        | ((refl_t == MAT_SUBSURFACE) & ss_refl))
    bounce_inc = is_specular_event.to(torch.int32)

    aux = {
        "glass_refract": (refl_t == MAT_GLASS) & ~gl_refl,
        "ss_refract": (refl_t == MAT_SUBSURFACE) & ~ss_refl,
        "ss_normal": ss_m,
        "u": (u1, u2, u3, u4, u5, u6),
    }
    return rng, next_dir, mask_mul, offset, terminate, bounce_inc, aux
