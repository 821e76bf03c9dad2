"""Path-regeneration wavefront integrator (port of tracer/regen.py).

A constant-width pool of P lanes traces path segments wave after wave;
when a path ends, its lane takes the next unspawned camera sample, possibly
of a later frame. The RNG is counter-based per (frame, pixel), so every
sample gets the same random stream, and so the same value, as in the JAX
package, whatever wave it runs in.

Ported: regen_order="compact" with regen_permute="gather". After every
wave the survivors are stable-sorted to the front (key: hit slot major,
direction octant minor, dead lanes last; torch.argsort(stable=True) and one
row gather of the packed pool), so the live lanes are always the exact
prefix [0, alive) and every population count is a host integer. A wave
therefore works on the views [0, n_active) and needs one device-to-host
read, for the number of paths that finished; that read is where CUDA
graphs could later take the loop over.

How radiance reaches the image. The JAX package's 1024-way accumulation
swizzle, ring buffer, rung ladder and dense fresh-death flush all work
around the cost of XLA's scatter on a TPU; they change how radiance
reaches the image, not what it sums to. Here scatter_mode "ring" and
"deferred" bank each path's radiance L on its lane and index_add_ it into
the image when the path dies (after compaction the lanes that died this
wave are the rows [alive, n_active)); "wave" index_add_s every lane's
contribution every wave. The three give the same image up to float
addition order (CUDA index_add_ adds with atomics). `dense_fresh_flush`
is accepted and has no effect. The ring itself waits for an H100
measurement that calls for it.

`stop_after_waves=k` (the probes' hook, JAX `regen.py:205-209,940-946`)
ends the loop after k waves, or earlier when the frame is done, and
returns the pool instead of the image (see `make_regen_integrator`).

Media (`has_media`: the per-lane `medium_id` column, distance sampling
before shading), BSSRDF (`has_bssrdf`: the probe loop of
tracer/bssrdf_shade.py on the lanes that refracted into a subsurface
material) and the distant light (`use_distant_light`: one more any-hit
shadow trace a wave, also from BSSRDF exit points) run in the same wave
body, as in the JAX package.

Not ported yet (each raises): regen_order="inplace", regen_permute="sort",
the dup_stage profiling hook.
"""
from __future__ import annotations

import torch

from ..core.vecmath import RAY_MIN, RAY_MAX, INV_PI, dot, normalize
from ..core.rng import RaySampler, wang_hash, MASK32
from ..scene.config import MAT_DIFF
from ..materials.fresnel import fresnel_dielectric, fresnel_moment_1
from .envsample import sample_env, power_heuristic
from .medium import medium_interaction
from .bssrdf_shade import bssrdf_scatter
from .wavefront import (
    RenderSettings, trace_rays, fetch_attributes, gather_material,
    env_miss_weighted, env_tex_merged, texture_radiance, shade,
)
from .renderer import generate_camera_rays, lane_pixel_xy


def _check_settings(settings: RenderSettings):
    if settings.regen_order == "compact" and settings.bounce_max > 127:
        raise ValueError("regen_order='compact' requires bounce_max <= 127 "
                         "(bounce rides a 7-bit field of the packed "
                         "permute column)")
    if settings.regen_permute not in ("gather", "sort"):
        raise ValueError("unknown regen_permute %r (want gather/sort)"
                         % (settings.regen_permute,))
    if settings.regen_permute == "sort" and settings.regen_order != "compact":
        raise ValueError("regen_permute='sort' requires "
                         "regen_order='compact'")
    if settings.scatter_mode not in ("ring", "deferred", "wave"):
        raise ValueError("unknown scatter_mode %r (want ring/deferred/wave)"
                         % (settings.scatter_mode,))
    todo = [
        (settings.regen_order != "compact",
         "regen_order=%r (ROADMAP A9a)" % (settings.regen_order,)),
        (settings.regen_permute == "sort",
         "regen_permute='sort' (ROADMAP A9a)"),
        (settings.dup_stage != "", "dup_stage profiling"),
    ]
    for missing, what in todo:
        if missing:
            raise NotImplementedError("%s is not ported yet" % what)


def make_regen_integrator(settings: RenderSettings, width, height,
                          with_stats=False, stop_after_waves=0):
    """Returns integrate_frames(scene, cam_vec, frame0, lane0, accum,
    n_frames) -> (accum, waves) or, with with_stats, (accum, waves, rays):
    accum plus n_frames samples per pixel, the number of waves, and the
    number of rays traced (extension + NEE shadow). lane0 is the global
    lane offset of this image slice (0 for a whole image).

    With stop_after_waves=k > 0 the loop ends after k waves (or earlier,
    when every sample is done) and integrate_frames returns the pool as it
    stands after the last wave's compaction and dead-row flush, a dict
    with the JAX key names: orig, dir, mask, L [P,3] f32; bsdf_pdf [P] f32;
    rng, pixel [P] i64 (the port's masked uint32 and pixel index); lbn,
    bounce, medium_id [P] i32 (medium_id: the material whose medium the
    lane is inside, -1 outside any); active [P] bool, which is the prefix
    [0, alive) since the pool is compacted every wave; and the host
    integers waves, next (samples spawned) and alive. L is 0 outside the active prefix, as in
    JAX; the other fields of rows past it are stale."""
    _check_settings(settings)
    stop_after_waves = int(stop_after_waves)
    if stop_after_waves < 0:
        raise ValueError("stop_after_waves must be >= 0, got %d"
                         % stop_after_waves)
    deferred = settings.scatter_mode in ("ring", "deferred")
    use_nee = settings.use_envmap and settings.env_importance_sampling

    def integrate_frames(scene, cam_vec, frame0, lane0, accum, n_frames):
        device = accum.device
        N = accum.shape[0]
        P = N if settings.pool_lanes <= 0 else min(settings.pool_lanes, N)
        tot = N * int(n_frames)
        if tot >= 2 ** 32:
            raise ValueError("at most 2^32 samples per call (the sample id "
                             "is a uint32 in the RNG seed)")
        accum = accum.clone()
        f32 = dict(dtype=torch.float32, device=device)
        orig = torch.zeros((P, 3), **f32)
        raydir = torch.zeros((P, 3), **f32)
        mask = torch.zeros((P, 3), **f32)
        ell = torch.zeros((P, 3), **f32)
        bsdf_pdf = torch.full((P,), -1.0, **f32)
        rng = torch.zeros((P,), dtype=torch.int64, device=device)
        pixel = torch.zeros((P,), dtype=torch.int64, device=device)
        lbn = torch.zeros((P,), dtype=torch.int32, device=device)
        bounce = torch.zeros((P,), dtype=torch.int32, device=device)
        medium_id = torch.full((P,), -1, dtype=torch.int32, device=device)
        rays = torch.zeros((), dtype=torch.float64, device=device)
        if settings.use_distant_light:
            ddis = normalize(torch.tensor(settings.distant_light_dir, **f32))
            ldis = torch.tensor(settings.distant_light_L, **f32)
        nxt, alive, waves = 0, 0, 0

        while ((nxt < tot or alive > 0)
               and not 0 < stop_after_waves <= waves):
            # ---- respawn: the dead suffix [alive, P) takes the next
            # samples of the queue, in order ----
            n_spawn = min(tot - nxt, P - alive)
            if n_spawn > 0:
                s = slice(alive, alive + n_spawn)
                sid = nxt + torch.arange(n_spawn, dtype=torch.int64,
                                         device=device)
                pixel_new = sid % N
                frame_new = int(frame0) + sid // N
                pixel_glob = pixel_new + int(lane0)
                rng_new = RaySampler.init(wang_hash(frame_new), pixel_glob)
                pxi, pyi = lane_pixel_xy(pixel_glob, width, height)
                rng_new, o_new, d_new = generate_camera_rays(
                    cam_vec, rng_new, pxi.to(torch.float32),
                    pyi.to(torch.float32))
                orig[s] = o_new
                raydir[s] = d_new
                mask[s] = 1.0
                ell[s] = 0.0
                bsdf_pdf[s] = -1.0
                rng[s] = rng_new
                pixel[s] = pixel_new
                lbn[s] = settings.bounce_min
                bounce[s] = 0
                medium_id[s] = -1
                nxt += n_spawn
            n_act = alive + n_spawn
            if with_stats:
                rays += n_act

            # ---- one wavefront segment over the live prefix ----
            a = slice(0, n_act)
            o, d, m = orig[a], raydir[a], mask[a]
            pdf_prev = bsdf_pdf[a]
            r = rng[a]
            active = torch.ones((n_act,), dtype=torch.bool, device=device)
            hit_slot, hit_t = trace_rays(scene, settings, o, d, RAY_MIN,
                                         RAY_MAX, anyhit=False,
                                         active=active, active_prefix=n_act)
            lbn_a = lbn[a]
            if settings.has_media:
                r, o, d, m, sampled_medium = medium_interaction(
                    scene, r, o, d, m, hit_t, medium_id[a], active)
                lbn_a = torch.where(
                    sampled_medium,
                    torch.clamp_max(lbn_a + 1, settings.bounce_max), lbn_a)
                miss = ~sampled_medium & (hit_t > 1e10)
            else:
                miss = hit_t > 1e10
            hitpoint = o + d * hit_t[:, None]
            hit_uv, smooth_n, mat_id, tri_n = fetch_attributes(
                scene, hit_slot, hitpoint)
            merged_et = (settings.merge_envtex and settings.use_texture
                         and settings.use_envmap
                         and settings.env_importance_sampling
                         and "envtex_quad" in scene)
            if merged_et:
                env, tex_rgb = env_tex_merged(scene, settings, d, pdf_prev,
                                              cam_vec[15], miss, hit_uv)
            else:
                tex_rgb = None
                env = env_miss_weighted(scene, settings, d, pdf_prev,
                                        cam_vec[15])
            contrib = torch.where(miss[:, None], m * env, 0.0)
            surf = ~miss & ~sampled_medium if settings.has_media else ~miss

            mat = gather_material(scene, mat_id)
            use_sn = mat["useNormal"] != 0
            n = normalize(torch.where(use_sn[:, None], smooth_n, tri_n))
            objcol = mat["objcol"]
            if settings.use_texture:
                tex = tex_rgb if tex_rgb is not None \
                    else texture_radiance(scene, hit_uv)
                objcol = torch.where((mat["useTexture"] != 0)[:, None], tex,
                                     objcol)
            into = dot(n, d) < 0.0
            nl = torch.where(into[:, None], n, -n)
            contrib = contrib + torch.where(surf[:, None], m * mat["emit"],
                                            0.0)

            r, next_dir, mask_mul, offset, term, binc, aux = shade(
                scene, settings, r, d, n, nl, into, mat, objcol)
            new_orig = hitpoint + nl * (offset * RAY_MIN)[:, None]
            if settings.has_bssrdf:
                ss_lanes = surf & aux["ss_refract"]
                (r, bs_orig, bs_dir, bs_mul, bs_ok, bs_is_mul,
                 bs_normal) = bssrdf_scatter(
                    scene, settings, r, hitpoint, aux["ss_normal"], mat,
                    mat_id, objcol, ss_lanes)
                use_bs = ss_lanes & bs_ok
                new_orig = torch.where(use_bs[:, None], bs_orig, new_orig)
                next_dir = torch.where(use_bs[:, None], bs_dir, next_dir)
                mask_mul = torch.where(use_bs[:, None], bs_mul, mask_mul)
            mask_prev = m
            m = torch.where(surf[:, None], m * mask_mul, m)
            o = torch.where(surf[:, None], new_orig, o)
            d = torch.where(surf[:, None], next_dir, d)

            pdf_new = pdf_prev
            if use_nee:
                r, (e1, e2) = RaySampler.next_n(r, 2)
                d_env, pdf_env, L_env = sample_env(scene, e1, e2,
                                                   cam_vec[15])
                cos_e = dot(d_env, nl)
                diff_lane = surf & (mat["refltype"] == MAT_DIFF)
                cand = diff_lane & (cos_e > 0.0) & (pdf_env > 1e-12)
                if with_stats:
                    rays += cand.sum()
                _s_slot, s_t = trace_rays(scene, settings, o, d_env,
                                          RAY_MIN, RAY_MAX, anyhit=True,
                                          active=cand)
                lit = cand & (s_t > 1e10)
                f = mat["kd"][:, None] * objcol * INV_PI
                pdf_b = torch.clamp_min(cos_e, 0.0) * INV_PI
                w = power_heuristic(pdf_env, pdf_b)
                scale = cos_e / torch.clamp_min(pdf_env, 1e-12) * w
                contrib = contrib + torch.where(
                    lit[:, None], mask_prev * f * scale[:, None] * L_env, 0.0)
                cos_n = torch.clamp_min(dot(d, nl), 0.0)
                pdf_new = torch.where(surf & diff_lane, cos_n * INV_PI,
                                      torch.where(surf, -1.0, pdf_prev))

            if settings.use_distant_light:
                d_light = ddis.expand(d.shape)
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
                if with_stats:
                    rays += cand_all.sum()
                _s_slot, s_t = trace_rays(scene, settings, o,
                                          d_light.contiguous(), RAY_MIN,
                                          RAY_MAX, anyhit=True,
                                          active=cand_all)
                lit = cand & (s_t > 1e10)
                pdf_s = torch.abs(cos_th) * INV_PI
                w = (pdf_s + 1.0) / (pdf_s * pdf_s + 1.0)
                # m, not mask_prev: the reference weighs this term with the
                # mask after the surface's multiply (quirk kept)
                contrib = contrib + torch.where(
                    lit[:, None], m * (objcol * INV_PI) * ldis * w[:, None],
                    0.0)
                if settings.has_bssrdf:
                    lit_b = cand_b & (s_t > 1e10)
                    eta_t = mat["etaT"]
                    surface_f = ((1.0 - fresnel_dielectric(
                        torch.abs(cos_b), 1.0, eta_t))
                        / (1.0 - 2.0 * fresnel_moment_1(1.0 / eta_t))) \
                        * INV_PI
                    pdf_b2 = torch.abs(cos_b) * INV_PI
                    w_b = (pdf_b2 + 1.0) / (pdf_b2 * pdf_b2 + 1.0)
                    contrib = contrib + torch.where(
                        lit_b[:, None],
                        mask_prev * bs_is_mul * (surface_f * w_b)[:, None]
                        * ldis, 0.0)

            lb = torch.where(surf, torch.clamp_max(lbn_a + binc,
                                                   settings.bounce_max),
                             lbn_a)
            mid = medium_id[a]
            if settings.has_media:
                refr = surf & aux["glass_refract"]
                mid = torch.where(refr & into & (mat["has_medium"] != 0),
                                  mat_id, mid)
                mid = torch.where(refr & ~into, -1, mid)
            bn = bounce[a] + 1
            finished = (miss | (surf & term) | (bn >= lb)
                        | (bn >= settings.bounce_max))
            if deferred:
                ell_a = ell[a] + contrib
            else:
                accum.index_add_(0, pixel[a], contrib)
                ell_a = ell[a]
            n_fin = int(finished.sum())          # the wave's one host read
            alive = n_act - n_fin
            waves += 1

            # ---- compact: survivors (hit slot major, octant minor) to the
            # front, dead lanes to the tail; one row gather moves the pool
            oct_ = ((d[:, 0] < 0).to(torch.int32)
                    | ((d[:, 1] < 0).to(torch.int32) << 1)
                    | ((d[:, 2] < 0).to(torch.int32) << 2))
            key = torch.where(finished, 2 ** 30,
                              (torch.clamp_min(hit_slot, 0) << 3) | oct_)
            src = torch.argsort(key, stable=True)
            # packed row, int32 bits: orig 0:3 | dir 3:6 | mask 6:9 |
            # bsdf_pdf 9 | L 10:13 | rng 13 | pixel 14 |
            # lbn + bounce<<8 + (medium_id+1)<<16 15
            pmat = torch.cat([
                o.view(torch.int32), d.view(torch.int32), m.view(torch.int32),
                pdf_new[:, None].contiguous().view(torch.int32),
                ell_a.view(torch.int32),
                r.to(torch.int32)[:, None], pixel[a].to(torch.int32)[:, None],
                (lb | (bn << 8) | ((mid + 1) << 16))[:, None]], dim=1)[src]
            orig[a] = pmat[:, 0:3].contiguous().view(torch.float32)
            raydir[a] = pmat[:, 3:6].contiguous().view(torch.float32)
            mask[a] = pmat[:, 6:9].contiguous().view(torch.float32)
            bsdf_pdf[a] = pmat[:, 9].contiguous().view(torch.float32)
            ell[a] = pmat[:, 10:13].contiguous().view(torch.float32)
            rng[a] = pmat[:, 13].to(torch.int64) & MASK32
            pixel[a] = pmat[:, 14].to(torch.int64)
            lbn[a] = pmat[:, 15] & 0xFF
            bounce[a] = (pmat[:, 15] >> 8) & 0xFF
            medium_id[a] = (pmat[:, 15] >> 16) - 1
            if deferred and n_fin:
                # the paths that died this wave are now rows [alive, n_act)
                dead = slice(alive, n_act)
                accum.index_add_(0, pixel[dead], ell[dead])

        if stop_after_waves:
            active = torch.arange(P, device=device) < alive
            return {"orig": orig, "dir": raydir, "mask": mask,
                    "L": torch.where(active[:, None], ell, 0.0),
                    "bsdf_pdf": bsdf_pdf, "rng": rng, "pixel": pixel,
                    "lbn": lbn, "bounce": bounce, "medium_id": medium_id,
                    "active": active,
                    "waves": waves, "next": nxt, "alive": alive}
        if with_stats:
            return accum, waves, float(rays)
        return accum, waves

    return integrate_frames
