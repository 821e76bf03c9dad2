"""Path-regeneration wavefront integrator (port of tracer/regen.py).

A constant-width pool of P lanes traces path segments wave after wave;
when a path ends, its lane takes the next unspawned camera sample, possibly
of a later frame. The RNG is counter-based per (frame, pixel), so every
sample gets the same random stream, and so the same value, as in the JAX
package, whatever wave it runs in.

regen_order="compact" (the default): after every wave the survivors are
stable-sorted to the front (key: hit slot major, direction octant minor,
dead lanes last), so the live lanes are always the exact prefix
[0, alive) and every population count is a host integer. A wave therefore
works on the views [0, n_active) and needs one device-to-host read, for
the number of paths that finished; that read is where CUDA graphs could
later take the loop over. regen_permute="gather" moves the pool by one
row gather of its packed columns; "sort" carries the vector state (orig,
dir, mask, L) as per-channel planes [3,P] and moves every plane and
column by the same stable sort order, with the same bits as "gather".

regen_order="inplace": the pool is never compacted. The live set is a
mask, every wave runs over all P lanes (traces take `active=`, no
prefix), and the dead lanes take the next queue samples in lane order.
The host still knows every count (alive, spawned), so the wave keeps its
one host read.

How radiance reaches the image. The JAX package's 1024-way accumulation
swizzle, ring buffer, rung ladder and dense fresh-death flush all work
around the cost of XLA's scatter on a TPU; they change how radiance
reaches the image, not what it sums to. Here scatter_mode "ring" and
"deferred" bank each path's radiance L on its lane and index_add_ it into
the image when the path dies (after compaction the lanes that died this
wave are the rows [alive, n_active)); "wave" index_add_s every lane's
contribution every wave, and so does every inplace render: as in the JAX
package, banking needs the compacted dead tail. The three give the same
image up to float addition order (CUDA index_add_ adds with atomics). `dense_fresh_flush`
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

`dup_stage` (the JAX bench's stage-duplication hook): the stage named
runs twice a wave, the second call perturbed as in the JAX hook, and the
duplicate is added times zero on its bits (wavefront.plus_zero_times), so
the image keeps its bits while the frame pays for the stage twice;
tools/profile_frame.py --dup prices each stage so. The stages are those of
DUP_STAGES; `scatter` duplicates each index_add_ into a scratch image that
is then dropped, and `texture`, `shade`, `sample_env` and `shadow_trace`
are duplicated inside wavefront.shade_hits.
"""
from __future__ import annotations

import torch

from ..core.vecmath import RAY_MIN, RAY_MAX
from ..core.rng import RaySampler, wang_hash, MASK32
from .medium import medium_interaction
from .wavefront import (
    RenderSettings, trace_rays, fetch_attributes, env_miss_weighted,
    env_tex_merged, shade_hits, distant_light, plus_zero_times,
)
from .renderer import generate_camera_rays, lane_pixel_xy


# the JAX regen's dup_stage names (tpu_pathtracer/tracer/regen.py)
DUP_STAGES = ("respawn", "ext_trace", "fetch", "envmiss", "texture", "shade",
              "sample_env", "shadow_trace", "scatter", "permute")


def _check_settings(settings: RenderSettings):
    if settings.regen_order == "compact" and settings.bounce_max > 127:
        raise ValueError("regen_order='compact' requires bounce_max <= 127 "
                         "(bounce rides a 7-bit field of the packed "
                         "permute column)")
    if settings.regen_order not in ("compact", "inplace"):
        raise ValueError("unknown regen_order %r (want compact/inplace)"
                         % (settings.regen_order,))
    if settings.regen_permute not in ("gather", "sort"):
        raise ValueError("unknown regen_permute %r (want gather/sort)"
                         % (settings.regen_permute,))
    if settings.regen_permute == "sort" and settings.regen_order != "compact":
        raise ValueError("regen_permute='sort' requires "
                         "regen_order='compact'")
    if settings.scatter_mode not in ("ring", "deferred", "wave"):
        raise ValueError("unknown scatter_mode %r (want ring/deferred/wave)"
                         % (settings.scatter_mode,))
    if settings.dup_stage not in ("",) + DUP_STAGES:
        raise ValueError("unknown dup_stage %r (want one of %s)"
                         % (settings.dup_stage, ", ".join(DUP_STAGES)))


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
    lane is inside, -1 outside any); active [P] bool, the prefix
    [0, alive) under the compact order and a mask under inplace; and the
    host integers waves, next (samples spawned) and alive. L is 0 outside
    the active set, as in JAX; the other fields of dead rows are stale."""
    _check_settings(settings)
    stop_after_waves = int(stop_after_waves)
    if stop_after_waves < 0:
        raise ValueError("stop_after_waves must be >= 0, got %d"
                         % stop_after_waves)
    inplace = settings.regen_order == "inplace"
    sort_mode = settings.regen_permute == "sort"
    # as in the JAX package, banking radiance on the path needs the
    # compacted dead tail: an inplace render adds every wave
    deferred = (settings.scatter_mode in ("ring", "deferred")
                and not inplace)
    dup = settings.dup_stage

    def _and(active, x):
        return x if active is None else active & x

    def wave(scene, cam_vec, o, d, m, pdf_prev, r, lbn_a, bn_prev, mid,
             active, light):
        """One wavefront segment. active is None when every lane is live
        (the compact prefix, traced as a prefix) or a mask (inplace).
        Returns the new (o, d, m, pdf, rng, lbn, bounce, medium_id), this
        wave's radiance, the finished mask, the hit slots and the count of
        shadow rays traced (a device scalar, 0 without with_stats)."""
        n = o.shape[0]
        live = active if active is not None else torch.ones(
            (n,), dtype=torch.bool, device=o.device)
        prefix = n if active is None else None
        hit_slot, hit_t = trace_rays(
            scene, settings, o, d, RAY_MIN, RAY_MAX, anyhit=False,
            active=live, active_prefix=prefix)
        if dup == "ext_trace":
            _, ht2 = trace_rays(scene, settings, o, d, RAY_MIN * 1.0000001,
                                RAY_MAX, anyhit=False, active=live,
                                active_prefix=prefix)
            hit_t = plus_zero_times(hit_t, ht2)
        if settings.has_media:
            r, o, d, m, sampled_medium = medium_interaction(
                scene, r, o, d, m, hit_t, mid, live)
            lbn_a = torch.where(
                sampled_medium,
                torch.clamp_max(lbn_a + 1, settings.bounce_max), lbn_a)
            miss = _and(active, ~sampled_medium & (hit_t > 1e10))
        else:
            miss = _and(active, hit_t > 1e10)
        hitpoint = o + d * hit_t[:, None]
        hit_uv, smooth_n, mat_id, tri_n = fetch_attributes(
            scene, hit_slot, hitpoint)
        if dup == "fetch":
            hit_uv, smooth_n, mat_id, tri_n = (
                plus_zero_times(x, x2) for x, x2 in zip(
                    (hit_uv, smooth_n, mat_id, tri_n),
                    fetch_attributes(scene, hit_slot, hitpoint + 1e-7)))
        merged_et = (settings.merge_envtex and settings.use_texture
                     and settings.use_envmap
                     and settings.env_importance_sampling
                     and "envtex_quad" in scene)
        if merged_et:
            env, tex_rgb = env_tex_merged(scene, settings, d, pdf_prev,
                                          cam_vec[15], miss, hit_uv)
            if dup in ("envmiss", "texture"):
                # hit_uv perturbed too: it feeds the gather's row index
                e2, t2 = env_tex_merged(scene, settings, d, pdf_prev + 1e-7,
                                        cam_vec[15], miss, hit_uv + 1e-7)
                env = plus_zero_times(env, e2)
                tex_rgb = plus_zero_times(tex_rgb, t2)
        else:
            tex_rgb = None
            env = env_miss_weighted(scene, settings, d, pdf_prev,
                                    cam_vec[15])
            if dup == "envmiss":
                env = plus_zero_times(env, env_miss_weighted(
                    scene, settings, d, pdf_prev + 1e-7, cam_vec[15]))
        contrib = torch.where(miss[:, None], m * env, 0.0)
        surf = ~miss & ~sampled_medium if settings.has_media else ~miss
        surf = _and(active, surf)

        hit = (hit_uv, smooth_n, mat_id, tri_n, hitpoint)
        (r, o, d, m, pdf_new, lb, mid, contrib, ended,
         n_shadow) = shade_hits(
            scene, settings, r, o, d, m, pdf_prev, lbn_a, mid, surf, hit,
            tex_rgb, contrib, cam_vec[15], light, count_rays=with_stats,
            dup_stage=dup)
        if active is None:
            bn = bn_prev + 1
        else:
            bn = torch.where(active, bn_prev + 1, bn_prev)
        finished = _and(active, miss | ended | (bn >= lb)
                        | (bn >= settings.bounce_max))
        return (o, d, m, pdf_new, r, lb, bn, mid, contrib, finished,
                hit_slot, n_shadow)

    def integrate_frames(scene, cam_vec, frame0, lane0, accum, n_frames):
        device = accum.device
        N = accum.shape[0]
        P = N if settings.pool_lanes <= 0 else min(settings.pool_lanes, N)
        tot = N * int(n_frames)
        if tot >= 2 ** 32:
            raise ValueError("at most 2^32 samples per call (the sample id "
                             "is a uint32 in the RNG seed)")
        accum = accum.clone()
        # dup_stage="scatter": each index_add_ is repeated into this scratch
        # image, which is dropped
        scratch = torch.zeros_like(accum) if dup == "scatter" else None

        def add_to_image(idx, val):
            accum.index_add_(0, idx, val)
            if scratch is not None:
                scratch.index_add_(0, idx, val * 1.0000001)
        f32 = dict(dtype=torch.float32, device=device)
        # the vector state: [P,3] rows, or [3,P] planes under "sort"
        vshape = (3, P) if sort_mode else (P, 3)
        orig = torch.zeros(vshape, **f32)
        raydir = torch.zeros(vshape, **f32)
        mask = torch.zeros(vshape, **f32)
        ell = torch.zeros(vshape, **f32)
        bsdf_pdf = torch.full((P,), -1.0, **f32)
        rng = torch.zeros((P,), dtype=torch.int64, device=device)
        pixel = torch.zeros((P,), dtype=torch.int64, device=device)
        lbn = torch.zeros((P,), dtype=torch.int32, device=device)
        bounce = torch.zeros((P,), dtype=torch.int32, device=device)
        medium_id = torch.full((P,), -1, dtype=torch.int32, device=device)
        live = torch.zeros((P,), dtype=torch.bool, device=device)
        rays = torch.zeros((), dtype=torch.float64, device=device)
        light = distant_light(settings, device)
        nxt, alive, waves = 0, 0, 0

        def rows(t, a):
            """Rows a of a vector-state tensor as an [n,3] tensor."""
            return t[:, a].t().contiguous() if sort_mode else t[a]

        def set_rows(t, a, v):
            if sort_mode:
                t[:, a] = v.t()
            else:
                t[a] = v

        while ((nxt < tot or alive > 0)
               and not 0 < stop_after_waves <= waves):
            # ---- respawn: dead lanes take the next samples of the queue,
            # in order: the dead suffix [alive, P) under compact, the dead
            # lanes in lane order under inplace ----
            n_spawn = min(tot - nxt, P - alive)
            if n_spawn > 0:
                if inplace:
                    s = torch.nonzero(~live).squeeze(1)[:n_spawn]
                else:
                    s = slice(alive, alive + n_spawn)
                sid = nxt + torch.arange(n_spawn, dtype=torch.int64,
                                         device=device)
                pixel_new = sid % N
                frame_new = int(frame0) + sid // N
                pixel_glob = pixel_new + int(lane0)
                rng_new = RaySampler.init(wang_hash(frame_new), pixel_glob)
                pxi, pyi = lane_pixel_xy(pixel_glob, width, height)
                px, py = pxi.to(torch.float32), pyi.to(torch.float32)
                rng_new, o_new, d_new = generate_camera_rays(
                    cam_vec, rng_new, px, py)
                if dup == "respawn":
                    r2, o2, d2 = generate_camera_rays(cam_vec, rng_new,
                                                      px + 1e-6, py)
                    o_new = plus_zero_times(
                        o_new, o2 + d2 + r2[:, None].to(torch.float32))
                set_rows(orig, s, o_new)
                set_rows(raydir, s, d_new)
                set_rows(mask, s, torch.ones_like(o_new))
                set_rows(ell, s, torch.zeros_like(o_new))
                bsdf_pdf[s] = -1.0
                rng[s] = rng_new
                pixel[s] = pixel_new
                lbn[s] = settings.bounce_min
                bounce[s] = 0
                medium_id[s] = -1
                live[s] = True
                nxt += n_spawn
            n_act = alive + n_spawn
            if with_stats:
                rays += n_act

            # ---- one wavefront segment: over the live prefix (compact)
            # or over the whole pool under the live mask (inplace) ----
            a = slice(0, P) if inplace else slice(0, n_act)
            (o, d, m, pdf_new, r, lb, bn, mid, contrib, finished, hit_slot,
             n_shadow) = wave(scene, cam_vec, rows(orig, a), rows(raydir, a),
                              rows(mask, a), bsdf_pdf[a], rng[a], lbn[a],
                              bounce[a], medium_id[a],
                              live if inplace else None, light)
            if with_stats:
                rays += n_shadow
            if deferred:
                ell_a = rows(ell, a) + contrib
            else:
                add_to_image(pixel[a], contrib)
                ell_a = rows(ell, a)
            n_fin = int(finished.sum())          # the wave's one host read
            alive = n_act - n_fin
            waves += 1

            if inplace:
                set_rows(orig, a, o)
                set_rows(raydir, a, d)
                set_rows(mask, a, m)
                bsdf_pdf[a], rng[a], lbn[a], bounce[a], medium_id[a] = (
                    pdf_new, r, lb, bn, mid)
                live &= ~finished
                continue

            # ---- compact: survivors (hit slot major, octant minor) to the
            # front, dead lanes to the tail ----
            oct_ = ((d[:, 0] < 0).to(torch.int32)
                    | ((d[:, 1] < 0).to(torch.int32) << 1)
                    | ((d[:, 2] < 0).to(torch.int32) << 2))
            key = torch.where(finished, 2 ** 30,
                              (torch.clamp_min(hit_slot, 0) << 3) | oct_)
            if sort_mode:
                # one stable sort order moves every plane and column
                src = torch.sort(key, stable=True)[1]
                src2 = (torch.sort(key + 1, stable=True)[1]
                        if dup == "permute" else None)

                def move(v):
                    if src2 is None:
                        return v[..., src]
                    return plus_zero_times(v[..., src], v[..., src2])
                for t, v in ((orig, o), (raydir, d), (mask, m),
                             (ell, ell_a)):
                    t[:, a] = move(v.t())
                bsdf_pdf[a] = move(pdf_new)
                rng[a] = move(r)
                pixel[a] = move(pixel[a])
                lbn[a] = move(lb)
                bounce[a] = move(bn)
                medium_id[a] = move(mid)
            else:
                # one row gather moves the packed pool; int32 bits:
                # orig 0:3 | dir 3:6 | mask 6:9 | bsdf_pdf 9 | L 10:13 |
                # rng 13 | pixel 14 | lbn + bounce<<8 + (medium_id+1)<<16 15
                src = torch.argsort(key, stable=True)
                pmat = torch.cat([
                    o.view(torch.int32), d.view(torch.int32),
                    m.view(torch.int32),
                    pdf_new[:, None].contiguous().view(torch.int32),
                    ell_a.view(torch.int32),
                    r.to(torch.int32)[:, None],
                    pixel[a].to(torch.int32)[:, None],
                    (lb | (bn << 8) | ((mid + 1) << 16))[:, None]],
                    dim=1)
                pmat = (plus_zero_times(pmat[src], pmat[src])
                        if dup == "permute" else pmat[src])
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
            live[alive:n_act] = False
            if deferred and n_fin:
                # the paths that died this wave are now rows [alive, n_act)
                dead = slice(alive, n_act)
                add_to_image(pixel[dead], rows(ell, dead))

        if stop_after_waves:
            vec = {k: (t.t() if sort_mode else t) for k, t in
                   (("orig", orig), ("dir", raydir), ("mask", mask),
                    ("L", ell))}
            vec["L"] = torch.where(live[:, None], vec["L"], 0.0)
            return {**vec, "bsdf_pdf": bsdf_pdf, "rng": rng,
                    "pixel": pixel, "lbn": lbn, "bounce": bounce,
                    "medium_id": medium_id, "active": live.clone(),
                    "waves": waves, "next": nxt, "alive": alive}
        if with_stats:
            return accum, waves, float(rays)
        return accum, waves

    return integrate_frames
