"""Render settings, traversal dispatch and the per-wave shading stages
(port of tracer/wavefront.py).

Every stage is plain tensor code over lane columns, but for the BSDF draw
(`shade`) and the surface fetches (`fetch_attributes`, `env_tex_merged`,
`texture_radiance`), which dispatch to hand-written kernels on a CUDA
device (ops/shade.py, ops/surface_fetch.py). What changed from the JAX
version: `gather_material` is a row gather (the one-hot matmul was a
TPU choice). `make_integrator` is the classic bounce integrator, one
device program as the JAX package's `while_loop` inside the Renderer's
`fori_loop` makes it (tpu_pathtracer/tracer/wavefront.py:575-794,
renderer.py:310-326): a call's frames are fixed-shape steps (frame_start,
bounce_step, frame_end) over all lanes with every count on the device,
captured and replayed through tracer/device_loop.py on a CUDA device.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.vecmath import INV_PI, RAY_MIN, RAY_MAX, normalize, dot
from ..core.rng import RaySampler, wang_hash
from ..scene.config import MAT_DIFF
from ..materials.fresnel import fresnel_dielectric, fresnel_moment_1
from ..scene.texture import sample_envmap_quad, sample_envmap_quad_pdf
from ..ops.shade import shade
from ..ops.surface_fetch import (
    fetch_attributes_plain, fetch_attributes_cuda, env_tex_merged_plain,
    env_tex_merged_cuda, texture_radiance_plain, texture_radiance_cuda,
    mis_env_weight,
)
from ..ops.marks import no_mark, stage_marker
from . import device_loop
from .envsample import power_heuristic, sample_env
from .traverse import intersect_scene
from .medium import medium_interaction
from .bssrdf_shade import bssrdf_scatter


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static configuration; the JAX package's RenderSettings fields and
    defaults, less two (tests/torch_settings.py: JAX_ONLY): the JAX
    bench's stage-duplication hook (the port prices a stage by its stage
    marks, ops/marks.py) and the choice of compaction permute (the port
    has one, ops/permute.py: pool_gather). Passing either is a TypeError,
    as for any unknown field. Fields that tune the TPU packet kernel's
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
    # bounce loop (make_integrator)
    integrator: str = "regen"
    # regen pool order: "compact" moves the survivors to the front every
    # wave; "inplace" respawns dead lanes where they died
    regen_order: str = "compact"
    # regen pool width cap in lanes; <= 0 means image-sized
    pool_lanes: int = 1 << 20
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
    """Traversal dispatch. active_prefix (an int, or a 0-d int32 tensor on
    the rays' device that the traversal reads there) asserts that the
    active set is the exact lane prefix [0, n); `active` must still be
    passed for the plain path."""
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
    hit, from one row of scene["tri_attr"]. Returns (hit_uv, smooth_n,
    mat_id, tri_n); tri_n is zero on miss lanes. CPU tensors take the
    plain version (ops/surface_fetch.py), any other device the kernel
    (csrc/fetch.cu) or an error."""
    if hit_slot.device.type == "cpu":
        return fetch_attributes_plain(scene, hit_slot, hitpoint)
    return fetch_attributes_cuda(scene, hit_slot, hitpoint)


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
    return mis_env_weight(raydir, p_uv, bsdf_pdf)[:, None] * L


def texture_radiance(scene, hit_uv):
    """Texture radiance at hit_uv from one row of scene["texture_quad"]:
    the plain version (ops/surface_fetch.py) for CPU tensors, the kernel
    (csrc/envtex.cu, texture-only) or an error for any other device."""
    if hit_uv.device.type == "cpu":
        return texture_radiance_plain(scene, hit_uv)
    return texture_radiance_cuda(scene, hit_uv)


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
    tex_rgb [N,3]), equal to env_miss_weighted / texture_radiance. CPU
    tensors take the plain version (ops/surface_fetch.py), any other
    device the kernel (csrc/envtex.cu), which takes env_rotation as a 0-d
    f32 tensor on that device, or an error."""
    if raydir.device.type == "cpu":
        return env_tex_merged_plain(scene, settings, raydir, bsdf_pdf,
                                    env_rotation, miss, hit_uv)
    return env_tex_merged_cuda(scene, raydir, bsdf_pdf, env_rotation, miss,
                               hit_uv)


def distant_light(settings: RenderSettings, device):
    """(unit direction, radiance) [3] f32 tensors of the distant light, or
    None when it is off."""
    if not settings.use_distant_light:
        return None
    f32 = dict(dtype=torch.float32, device=device)
    return (normalize(torch.tensor(settings.distant_light_dir, **f32)),
            torch.tensor(settings.distant_light_L, **f32))


# the counters shade_hits adds to on a scene with BSSRDF: the lanes that
# enter the probe loop and those that leave it at an exit
BSSRDF_COUNTERS = ("bssrdf_lanes", "bssrdf_exits")


def shade_hits(scene, settings, rng, orig, raydir, mask, bsdf_pdf, lbn,
               medium_id, surf, hit, tex, radiance, env_rotation, light,
               count_rays=False, mark=no_mark, counters=None):
    """The surface half of a segment, shared by both integrators: material,
    emission, the BSDF draw, the BSSRDF probe loop, env NEE with MIS, the
    distant light, the bounce budget and medium tracking, on the lanes
    `surf` (live lanes whose ray hit a surface).

    hit = fetch_attributes(...) + (hitpoint,) of the segment's trace; tex
    the texture radiance at the hit, or None to fetch it here; radiance
    [N,3] the running sum this segment's terms are added to, in the
    reference's order; light = distant_light(...). Returns (rng, orig,
    raydir, mask, bsdf_pdf, lbn, medium_id, radiance, ended, n_shadow):
    ended marks the surface lanes whose path stops here (an emitter), and
    n_shadow is the count of shadow rays traced (a device scalar) with
    count_rays, else 0. mark(stage) marks the start of each stage
    (ops/marks.py); both integrators pass their with_stats call's marker,
    every other caller none. counters: {name: 0-d int64 device tensor} to
    which a scene with BSSRDF adds the lanes that enter the probe loop
    (`bssrdf_lanes`) and those that leave it at an exit (`bssrdf_exits`),
    or None."""
    hit_uv, smooth_n, mat_id, tri_n, hitpoint = hit
    mark("material")
    mat = gather_material(scene, mat_id)
    use_sn = mat["useNormal"] != 0
    n = normalize(torch.where(use_sn[:, None], smooth_n, tri_n))
    objcol = mat["objcol"]
    if settings.use_texture:
        if tex is None:
            tex = texture_radiance(scene, hit_uv)
        objcol = torch.where((mat["useTexture"] != 0)[:, None], tex, objcol)
    into = dot(n, raydir) < 0.0
    nl = torch.where(into[:, None], n, -n)
    radiance = radiance + torch.where(surf[:, None], mask * mat["emit"], 0.0)

    mark("shade")
    rng, next_dir, mask_mul, offset, term, binc, aux = shade(
        scene, settings, rng, raydir, n, nl, into, mat, objcol,
        mat_id=mat_id)
    new_orig = hitpoint + nl * (offset * RAY_MIN)[:, None]
    if settings.has_bssrdf:
        mark("bssrdf")
        ss_lanes = surf & aux["ss_refract"]
        # the exit replaces the surface draw's origin, direction and
        # throughput on the lanes that found one (use_bs, within ss_lanes)
        (rng, new_orig, next_dir, mask_mul, use_bs, bs_is_mul,
         bs_normal) = bssrdf_scatter(
            scene, settings, rng, hitpoint, aux["ss_normal"], mat, mat_id,
            objcol, ss_lanes, shade_out=(new_orig, next_dir, mask_mul))
        if counters is not None:
            counters["bssrdf_lanes"].add_(ss_lanes.sum())
            counters["bssrdf_exits"].add_(use_bs.sum())
    mask_prev = mask
    mask = torch.where(surf[:, None], mask * mask_mul, mask)
    orig = torch.where(surf[:, None], new_orig, orig)
    raydir = torch.where(surf[:, None], next_dir, raydir)

    n_shadow = 0
    env_nee = settings.use_envmap and settings.env_importance_sampling
    if env_nee:
        mark("sample_env")
        rng, (e1, e2) = RaySampler.next_n(rng, 2)
        d_env, pdf_env, L_env = sample_env(scene, e1, e2, env_rotation)
        cos_e = dot(d_env, nl)
        diff_lane = surf & (mat["refltype"] == MAT_DIFF)
        cand = diff_lane & (cos_e > 0.0) & (pdf_env > 1e-12)
        if count_rays:
            n_shadow = n_shadow + cand.sum()
        mark("shadow_trace")
        _s_slot, s_t = trace_rays(scene, settings, orig, d_env, RAY_MIN,
                                  RAY_MAX, anyhit=True, active=cand)
        lit = cand & (s_t > 1e10)
        f = mat["kd"][:, None] * objcol * INV_PI
        pdf_b = torch.clamp_min(cos_e, 0.0) * INV_PI
        w = power_heuristic(pdf_env, pdf_b)
        scale = cos_e / torch.clamp_min(pdf_env, 1e-12) * w
        radiance = radiance + torch.where(
            lit[:, None], mask_prev * f * scale[:, None] * L_env, 0.0)
        # the pdf of the new direction, recorded on diffuse lanes only
        cos_n = torch.clamp_min(dot(raydir, nl), 0.0)
        bsdf_pdf = torch.where(surf & diff_lane, cos_n * INV_PI,
                               torch.where(surf, -1.0, bsdf_pdf))

    if light is not None:
        if not env_nee:
            mark("shadow_trace")
        ddis, ldis = light
        d_light = ddis.expand(raydir.shape)
        diff_lane = surf & (mat["refltype"] == MAT_DIFF)
        cos_th = dot(d_light, nl)
        cand = diff_lane & (cos_th >= 0.0)
        cand_all = cand
        if settings.has_bssrdf:
            # BSSRDF exit points also sample the distant light
            # (src/renderkernel.cu:815-841)
            cos_b = dot(d_light, normalize(bs_normal))
            cand_b = use_bs & (cos_b >= 0.0)
            cand_all = cand | cand_b
        if count_rays:
            n_shadow = n_shadow + cand_all.sum()
        _s_slot, s_t = trace_rays(scene, settings, orig, d_light.contiguous(),
                                  RAY_MIN, RAY_MAX, anyhit=True,
                                  active=cand_all)
        lit = cand & (s_t > 1e10)
        pdf_s = torch.abs(cos_th) * INV_PI
        w = (pdf_s + 1.0) / (pdf_s * pdf_s + 1.0)
        # mask, not mask_prev: the reference weighs this term with the mask
        # after the surface's multiply (quirk kept)
        radiance = radiance + torch.where(
            lit[:, None], mask * (objcol * INV_PI) * ldis * w[:, None], 0.0)
        if settings.has_bssrdf:
            lit_b = cand_b & (s_t > 1e10)
            eta_t = mat["etaT"]
            surface_f = ((1.0 - fresnel_dielectric(torch.abs(cos_b), 1.0,
                                                   eta_t))
                         / (1.0 - 2.0 * fresnel_moment_1(1.0 / eta_t))) \
                * INV_PI
            pdf_b2 = torch.abs(cos_b) * INV_PI
            w_b = (pdf_b2 + 1.0) / (pdf_b2 * pdf_b2 + 1.0)
            radiance = radiance + torch.where(
                lit_b[:, None],
                mask_prev * bs_is_mul * (surface_f * w_b)[:, None] * ldis,
                0.0)

    lbn = torch.where(surf, torch.clamp_max(lbn + binc, settings.bounce_max),
                      lbn)
    if settings.has_media:
        # entering / leaving a refractive interface with a medium
        refr = surf & aux["glass_refract"]
        medium_id = torch.where(refr & into & (mat["has_medium"] != 0),
                                mat_id, medium_id)
        medium_id = torch.where(refr & ~into, -1, medium_id)
    return (rng, orig, raydir, mask, bsdf_pdf, lbn, medium_id, radiance,
            surf & term, n_shadow)


@dataclasses.dataclass(frozen=True)
class BounceConfig:
    """What a bounce call's steps depend on: the settings, with_stats, and
    N, the lanes of the call's image slice."""
    settings: RenderSettings
    with_stats: bool
    N: int


# the counter of a with_stats bounce call: the lanes live at the start of
# each bounce step, summed over its steps; published with shade_hits'
# BSSRDF_COUNTERS in BounceIntegrator.last_counters
BOUNCE_COUNTERS = ("bounce_live_lanes",)


def _bounce_counters(cfg: BounceConfig):
    """The names of the counters a call of cfg keeps: under with_stats,
    BOUNCE_COUNTERS, and BSSRDF_COUNTERS on a scene with BSSRDF; else
    none."""
    if not cfg.with_stats:
        return ()
    return BOUNCE_COUNTERS \
        + (BSSRDF_COUNTERS if cfg.settings.has_bssrdf else ())


def new_bounce_state(cfg: BounceConfig, device):
    """The tensors the bounce steps read and write in place: the lane
    columns of one frame's paths (rng, orig, dir, mask, the radiance `rad`
    summed so far, active, lbn, medium_id, the deferred env miss's
    miss_dir / miss_mask / miss_bpdf, bsdf_pdf), the device scalars
    (bounce: the index within the frame; bounces: the bounces run; rays;
    frame0, lane0, frame: the frames started; frames_left; the counters of
    a with_stats call, _bounce_counters), the status a bounce ends with
    (int64 [done, active lanes, frames left]), the camera vector and the
    image slice `accum` [N,3]. Filled by reset_bounce() and
    frame_start()."""
    N = cfg.N
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    st = {k: torch.zeros((N, 3), **f32) for k in (
        "orig", "dir", "mask", "rad", "miss_dir", "miss_mask")}
    st.update(rng=torch.zeros((N,), **i64), lane=torch.arange(N, **i64),
              active=torch.zeros((N,), dtype=torch.bool, device=device),
              lbn=torch.zeros((N,), **i32), medium_id=torch.zeros((N,), **i32),
              miss_bpdf=torch.zeros((N,), **f32),
              bsdf_pdf=torch.zeros((N,), **f32),
              rays=torch.zeros((), dtype=torch.float64, device=device),
              status=torch.zeros((3,), **i64),
              cam_vec=torch.zeros((16,), **f32),
              accum=torch.zeros((N, 3), **f32),
              light=distant_light(cfg.settings, device))
    for k in ("bounce", "bounces", "frame0", "lane0", "frame",
              "frames_left") + _bounce_counters(cfg):
        st[k] = torch.zeros((), **i64)
    return st


def reset_bounce(cfg: BounceConfig, st, cam_vec, frame0, lane0, accum,
                 n_frames):
    """Start a call on state st: the counts at 0, the call's inputs copied
    in. Device work only: fills and device copies."""
    for k in ("bounces", "rays", "frame", "status") + _bounce_counters(cfg):
        st[k].zero_()
    st["frame0"].fill_(int(frame0))
    st["lane0"].fill_(int(lane0))
    st["frames_left"].fill_(int(n_frames))
    st["cam_vec"].copy_(cam_vec)
    st["accum"].copy_(accum)


def frame_start(cfg: BounceConfig, scene, st):
    """A frame's camera rays on every lane (RNG seeded by wang_hash(frame0
    + frame) and the global lane, lane -> pixel through the padded
    block-swizzle tables) and every path column reset: one frame of the
    JAX Renderer's fori_loop body before its integrator. Marked
    `respawn` under with_stats."""
    from .renderer import generate_camera_rays
    stage_marker(cfg.with_stats, st["lane"].device)("respawn")
    s = cfg.settings
    lane_ids = st["lane0"] + st["lane"]
    rng = RaySampler.init(wang_hash(st["frame0"] + st["frame"]), lane_ids)
    # pixel_y 0 is the top of the image
    pixel_x = scene["lane_px"][lane_ids].to(torch.float32)
    pixel_y = scene["lane_py"][lane_ids].to(torch.float32)
    rng, orig, raydir = generate_camera_rays(st["cam_vec"], rng, pixel_x,
                                             pixel_y)
    st["rng"].copy_(rng)
    st["orig"].copy_(orig)
    st["dir"].copy_(raydir)
    st["mask"].fill_(1.0)
    for k in ("rad", "miss_dir", "miss_mask", "bounce"):
        st[k].zero_()
    st["active"].fill_(True)
    st["lbn"].fill_(s.bounce_min)
    st["medium_id"].fill_(-1)
    for k in ("miss_bpdf", "bsdf_pdf"):
        st[k].fill_(-1.0)
    st["frames_left"].sub_(1)


def bounce_step(cfg: BounceConfig, scene, st):
    """One bounce over all N lanes under the `active` mask, in place: the
    body of the JAX integrator's while_loop. Every shape is fixed and
    nothing is read on the host, so the same call runs eagerly or
    captured in a CUDA graph. "bounces" grows only when some lane was
    active at the start (the while_loop's trip count). A bounce after
    every lane has stopped, or after bounce_max bounces, changes no bit of
    the frame's radiance, its deferred miss, the path columns or the
    counts: every write is masked by the (empty) active set; only the RNG
    of the lanes moves, and it is seeded anew at the next frame_start.
    Ends by writing the status [done, active lanes, frames left], done
    when no lane is active or the frame has run bounce_max bounces.

    Under with_stats a step, the no-op ones included, marks its stages
    (ops/marks.py) in the order of portbench/metrics/_stages.py's bounce
    contract: ext_trace, medium (has_media only), surface (the deferred
    miss, the attribute fetch), shade_hits' own, and end after the status;
    and it adds the lanes live at its start to `bounce_live_lanes`, the
    probe loop's lanes and exits to shade_hits' BSSRDF_COUNTERS."""
    s = cfg.settings
    mark = stage_marker(cfg.with_stats, st["lane"].device)
    counted = _bounce_counters(cfg)
    mark("ext_trace")
    go = st["active"].any() & (st["bounce"] < s.bounce_max)
    active = st["active"] & go
    if cfg.with_stats:
        n_live = active.sum()
        st["rays"].add_(n_live)
        st["bounce_live_lanes"].add_(n_live)
    rng, orig, raydir, mask, lbn = (st["rng"], st["orig"], st["dir"],
                                    st["mask"], st["lbn"])
    hit_slot, hit_t = trace_rays(scene, s, orig, raydir, RAY_MIN, RAY_MAX,
                                 anyhit=False, active=active)
    surf = active
    if s.has_media:
        mark("medium")
        rng, orig, raydir, mask, sampled_medium = medium_interaction(
            scene, rng, orig, raydir, mask, hit_t, st["medium_id"], active)
        lbn = torch.where(sampled_medium,
                          torch.clamp_max(lbn + 1, s.bounce_max), lbn)
        surf = active & ~sampled_medium
    mark("surface")
    # the environment miss, deferred: record the direction, the throughput
    # and the pdf of the last diffuse draw
    miss = surf & (hit_t > 1e10)
    torch.where(miss[:, None], raydir, st["miss_dir"], out=st["miss_dir"])
    torch.where(miss[:, None], mask, st["miss_mask"], out=st["miss_mask"])
    torch.where(miss, st["bsdf_pdf"], st["miss_bpdf"], out=st["miss_bpdf"])
    live = active & ~miss
    surf = surf & ~miss

    hitpoint = orig + raydir * hit_t[:, None]
    hit = fetch_attributes(scene, hit_slot, hitpoint) + (hitpoint,)
    (rng, orig, raydir, mask, bsdf_pdf, lbn, medium_id, rad, ended,
     n_shadow) = shade_hits(
        scene, s, rng, orig, raydir, mask, st["bsdf_pdf"], lbn,
        st["medium_id"], surf, hit, None, st["rad"], st["cam_vec"][15],
        st["light"], count_rays=cfg.with_stats, mark=mark,
        counters={k: st[k] for k in counted
                  if k in BSSRDF_COUNTERS} or None)
    if cfg.with_stats:
        st["rays"].add_(n_shadow)
    bounce = st["bounce"] + go.to(torch.int64)
    live = live & ~ended & (bounce < lbn)
    for k, v in (("rng", rng), ("orig", orig), ("dir", raydir),
                 ("mask", mask), ("bsdf_pdf", bsdf_pdf), ("lbn", lbn),
                 ("medium_id", medium_id), ("rad", rad), ("active", live),
                 ("bounce", bounce)):
        st[k].copy_(v)
    st["bounces"].add_(go.to(torch.int64))
    more = live.any() & (bounce < s.bounce_max)
    torch.stack([(~more).to(torch.int64), live.sum(), st["frames_left"]],
                out=st["status"])
    mark("end")


def frame_end(cfg: BounceConfig, scene, st):
    """The deferred environment fetch, once for the direction and
    throughput each lane left the scene with, and the frame's radiance
    added to the image slice. Marked `scatter` under with_stats."""
    stage_marker(cfg.with_stats, st["lane"].device)("scatter")
    env = env_miss_weighted(scene, cfg.settings, st["miss_dir"],
                            st["miss_bpdf"], st["cam_vec"][15])
    st["accum"].add_(st["rad"] + st["miss_mask"] * env)
    st["frame"].add_(1)


class BounceIntegrator:
    """The classic bounce integrator (JAX `wavefront.make_integrator` under
    the Renderer's `fori_loop`) as one device program. A call's frames run
    as fixed-shape steps on the lanes of its image slice: frame_start,
    up to bounce_max bounce_steps, frame_end. On a CUDA device the three
    are captured once for a device_loop.capture_key (`graph`, a
    device_loop.StepGraph) and replayed; the CPU, and the card inside
    device_loop.no_graphs(), run them eagerly.

    The host launches at most bounce_max bounces a frame. It ends a frame
    without waiting when it has launched bounce_max, and early only on a
    status device_loop.LAG bounces old that reads done; the LAG - 1
    bounces launched after such a frame's end are no-ops (bounce_step).
    `last_launched` is the bounces the last call launched; the bounces it
    ran are its count, so the over-run is the difference.

    A with_stats call marks its steps' stages (frame_start `respawn`,
    each launched bounce_step its stages up to `end`, frame_end
    `scatter`), captured into its own graphs, and publishes its counters
    in `last_counters`; a call without with_stats does neither."""

    def __init__(self, settings, with_stats=False):
        self.settings = settings
        self.with_stats = bool(with_stats)
        self.graph, self._graph_key = None, None
        self.last_launched = 0
        self._last_counters = {}

    @property
    def last_counters(self):
        """{name: host int}: the counters the last call kept
        (_bounce_counters), read once after it; {} for a call without
        with_stats."""
        return self._last_counters

    def _config(self, N):
        return BounceConfig(self.settings, self.with_stats, int(N))

    def start(self, scene, cam_vec, frame0, lane0, accum, n_frames):
        """(cfg, st): a fresh eager state for a call, before its first
        frame; frame_start / bounce_step / frame_end(cfg, scene, st) step
        it by hand."""
        cfg = self._config(accum.shape[0])
        st = new_bounce_state(cfg, accum.device)
        reset_bounce(cfg, st, cam_vec, frame0, lane0, accum, n_frames)
        return cfg, st

    def __call__(self, scene, cam_vec, frame0, lane0, accum, n_frames):
        acc, bounces, rays = device_loop.run_call(accum.device, self.call(
            scene, cam_vec, frame0, lane0, accum, n_frames))
        if self.with_stats:
            return acc, int(bounces), float(rays)
        return acc, bounces

    def call(self, scene, cam_vec, frame0, lane0, accum, n_frames):
        """One call as a generator for device_loop.run_calls: each next()
        launches one step (the first captures on a new key); it returns
        (accum, bounces, rays), the counts 0-d device tensors (rays 0
        without with_stats)."""
        device = accum.device
        replay = device_loop.graphs_enabled(device)
        cfg = self._config(accum.shape[0])
        if replay:
            key = device_loop.capture_key(cfg.N, device, scene)
            if key != self._graph_key:
                self.graph = None            # its memory goes before the next
                st = new_bounce_state(cfg, device)
                # the warm-ups and the capture run on this call's inputs
                reset_bounce(cfg, st, cam_vec, frame0, lane0, accum, 1)
                self.graph = device_loop.StepGraph(
                    st, _bounce_steps(cfg, scene, st), device, keep=scene)
                self._graph_key = key
            st, steps, ring = (self.graph.st, self.graph.steps(),
                               self.graph.ring)
            reset_bounce(cfg, st, cam_vec, frame0, lane0, accum, n_frames)
        else:
            cfg, st = self.start(scene, cam_vec, frame0, lane0, accum,
                                 n_frames)
            steps = _bounce_steps(cfg, scene, st)
            ring = device_loop.StatusRing(device)
        self.last_launched, self._last_counters = 0, {}
        launched = 0
        if int(n_frames) > 0 and cfg.N > 0:
            ring.reset()
            bounce = steps["bounce"]
            for _ in range(int(n_frames)):
                steps["start"]()
                yield
                launched += yield from device_loop.drive(
                    lambda seen: bounce(), st["status"], ring,
                    limit=self.settings.bounce_max)
                steps["end"]()
                yield
        self.last_launched = launched
        # read once, after the call (only a with_stats call keeps them)
        self._last_counters = {k: int(st[k]) for k in _bounce_counters(cfg)}

        def out(t):
            return t.clone() if replay else t
        return out(st["accum"]), out(st["bounces"]), out(st["rays"])


def _bounce_steps(cfg, scene, st):
    return {name: functools.partial(fn, cfg, scene, st) for name, fn in (
        ("start", frame_start), ("bounce", bounce_step), ("end", frame_end))}


def make_integrator(settings: RenderSettings, with_stats=False):
    """The bounce integrator: a BounceIntegrator, whose call
    integrate(scene, cam_vec, frame0, lane0, accum, n_frames) adds n_frames
    samples per pixel (frames frame0 .. frame0 + n_frames - 1) to the lanes
    [lane0, lane0 + N) of the image slice accum [N,3]. Returns (accum,
    bounces) or, with with_stats, (accum, bounces, rays): the bounces run
    (summed over the frames; a host int with with_stats, else a 0-d
    device tensor) and the rays traced, extension and shadow."""
    return BounceIntegrator(settings, with_stats=with_stats)
