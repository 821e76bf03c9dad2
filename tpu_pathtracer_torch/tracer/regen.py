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

Not ported yet (each raises): regen_order="inplace", regen_permute="sort",
media, BSSRDF, the distant light, the dup_stage profiling hook.
"""
from __future__ import annotations

import torch

from ..core.vecmath import RAY_MIN, RAY_MAX, INV_PI, dot, normalize
from ..core.rng import RaySampler, wang_hash, MASK32
from ..scene.config import MAT_DIFF
from .envsample import sample_env, power_heuristic
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
        (settings.has_media, "participating media (ROADMAP A11)"),
        (settings.has_bssrdf, "BSSRDF (ROADMAP A12)"),
        (settings.use_distant_light, "the distant light (ROADMAP A13)"),
        (settings.dup_stage != "", "dup_stage profiling"),
    ]
    for missing, what in todo:
        if missing:
            raise NotImplementedError("%s is not ported yet" % what)


def make_regen_integrator(settings: RenderSettings, width, height,
                          with_stats=False):
    """Returns integrate_frames(scene, cam_vec, frame0, lane0, accum,
    n_frames) -> (accum, waves) or, with with_stats, (accum, waves, rays):
    accum plus n_frames samples per pixel, the number of waves, and the
    number of rays traced (extension + NEE shadow). lane0 is the global
    lane offset of this image slice (0 for a whole image)."""
    _check_settings(settings)
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
        rays = torch.zeros((), dtype=torch.float64, device=device)
        nxt, alive, waves = 0, 0, 0

        while nxt < tot or alive > 0:
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
            surf = ~miss

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

            r, next_dir, mask_mul, offset, term, binc, _aux = shade(
                scene, settings, r, d, n, nl, into, mat, objcol)
            new_orig = hitpoint + nl * (offset * RAY_MIN)[:, None]
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

            lb = torch.where(surf, torch.clamp_max(lbn[a] + binc,
                                                   settings.bounce_max),
                             lbn[a])
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
            # bsdf_pdf 9 | L 10:13 | rng 13 | pixel 14 | lbn + bounce<<8 15
            pmat = torch.cat([
                o.view(torch.int32), d.view(torch.int32), m.view(torch.int32),
                pdf_new[:, None].contiguous().view(torch.int32),
                ell_a.view(torch.int32),
                r.to(torch.int32)[:, None], pixel[a].to(torch.int32)[:, None],
                (lb | (bn << 8))[:, None]], dim=1)[src]
            orig[a] = pmat[:, 0:3].contiguous().view(torch.float32)
            raydir[a] = pmat[:, 3:6].contiguous().view(torch.float32)
            mask[a] = pmat[:, 6:9].contiguous().view(torch.float32)
            bsdf_pdf[a] = pmat[:, 9].contiguous().view(torch.float32)
            ell[a] = pmat[:, 10:13].contiguous().view(torch.float32)
            rng[a] = pmat[:, 13].to(torch.int64) & MASK32
            pixel[a] = pmat[:, 14].to(torch.int64)
            lbn[a] = pmat[:, 15] & 0xFF
            bounce[a] = pmat[:, 15] >> 8
            if deferred and n_fin:
                # the paths that died this wave are now rows [alive, n_act)
                dead = slice(alive, n_act)
                accum.index_add_(0, pixel[dead], ell[dead])

        if with_stats:
            return accum, waves, float(rays)
        return accum, waves

    return integrate_frames
