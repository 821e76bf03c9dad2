"""BSSRDF subsurface scattering: the probe loop of the wave (port of
tracer/bssrdf_shade.py).

Re-architecture of the reference MAT_SUBSURFACE path
(src/renderkernel.cu:698-844 + src/bssrdf.cuh): after the entry interface
refracts, the reference walks up to 3 probe-ray segments, reservoir-sampling
among surface hits of the same material, then evaluates the dual-beam profile
with 3-axis MIS. Here the probe loop is a statically unrolled 3-iteration
sequence of masked wavefront traversals (matching maxLoopNum=3,
src/renderkernel.cu:727); all per-thread locals become lane columns.

Profile evaluation uses the sum-of-exponentials fast path (USE_SOE,
src/bssrdf.cuh:8,262-276,355-360,402-405), the reference's default. The
tabulated Catmull-Rom path's table is produced by bssrdf/tabulate.py and
validated against it in tests.

On the card with the SoE profile, `bssrdf_scatter` runs the loop's
per-lane work in the kernels of csrc/bssrdf.cu (ops/bssrdf.py) around the
same masked traces; `bssrdf_scatter_plain`, the code below, is the plain
version they give the bits of, and what a CPU tensor and the tabulated
profile run.

Reference quirks kept deliberately:
* the r1-reuse cascade in probe-axis selection (src/bssrdf.cuh:291-297) and
  the subsequent `r1 < 0.5` radius x3 test against the *modified* r1
  (src/bssrdf.cuh:304);
* `probeRayVec` passed to calculateBSSRDF is the last probe hit's vector,
  not necessarily the reservoir-selected one (src/renderkernel.cu:756,803).
"""
from __future__ import annotations

import math

import torch

from ..core.vecmath import (RAY_MIN, FOUR_PI, EIGHT_PI, TWO_PI, dot,
                            normalize, make_basis, length, channel_select)
from ..core.rng import RaySampler
from ..materials.fresnel import fresnel_dielectric, fresnel_moment_1
from ..materials.bsdf import lambertian_sample


def param_soe(A):
    """Searchlight-configuration SoE parameter (src/bssrdf.cuh:262-276)."""
    p = torch.abs(A - 0.8)
    return 1.85 - A + 7.0 * p * p * p


def calculate_bssrdf_soe(ns, normal_next, sigma_t, rho, d, ss, ts):
    """SoE profile + 3-axis/3-channel MIS pdf (calculateBSSRDF,
    src/bssrdf.cuh:319-436, USE_SOE branches). Returns beta [N,3]."""
    radius = length(d)
    d_local = torch.stack([dot(ss, d), dot(ts, d), dot(ns, d)], dim=-1) ** 2
    radius_proj = torch.sqrt(torch.stack([
        d_local[:, 1] + d_local[:, 2],
        d_local[:, 2] + d_local[:, 0],
        d_local[:, 0] + d_local[:, 1]], dim=-1))
    axis_channel_pdf = torch.stack([
        torch.abs(dot(ss, normal_next)) * (0.25 / 3.0),
        torch.abs(dot(ts, normal_next)) * (0.25 / 3.0),
        torch.abs(dot(ns, normal_next)) * (0.5 / 3.0)], dim=-1)

    s = param_soe(rho)
    pdf = torch.zeros_like(radius)
    for axis in range(3):
        rp = radius_proj[:, axis]
        e1 = torch.exp(-s * rp[:, None] * sigma_t)
        e2 = torch.exp(-s * rp[:, None] * sigma_t / 3.0) / 3.0
        axis_pdf = (e1 + e2) / FOUR_PI * rho * s * sigma_t
        axis_pdf = torch.where((rp > 1e-4)[:, None],
                             axis_pdf / torch.clamp_min(rp, 1e-4)[:, None],
                             axis_pdf)
        pdf = pdf + (axis_pdf[:, 0] + axis_pdf[:, 1] + axis_pdf[:, 2]) * axis_channel_pdf[:, axis]

    e1 = torch.exp(-s * radius[:, None] * sigma_t)
    e2 = torch.exp(-s * radius[:, None] * sigma_t / 3.0)
    Sr = (e1 + e2) / EIGHT_PI * rho * s * sigma_t
    Sr = torch.where((radius > 1e-4)[:, None],
                   Sr / torch.clamp_min(radius, 1e-4)[:, None], Sr)
    beta = torch.clamp_max(Sr / torch.clamp_min(pdf, 1e-20)[:, None], 10.0)
    return beta


def calculate_bssrdf_table(scene, ns, normal_next, sigma_t, rho, d, ss, ts):
    """Tabulated profile + 3-axis/3-channel MIS pdf (calculateBSSRDF non-SoE
    branches, src/bssrdf.cuh:361-431). Returns beta [N,3]."""
    from ..bssrdf.sample import eval_profile_table
    t_rho = scene["bssrdf_rho"]
    t_rad = scene["bssrdf_radius"]
    t_prof = scene["bssrdf_profile"]
    t_eff = scene["bssrdf_rho_eff"]

    radius = length(d)
    d_local = torch.stack([dot(ss, d), dot(ts, d), dot(ns, d)], dim=-1) ** 2
    radius_proj = torch.sqrt(torch.stack([
        d_local[:, 1] + d_local[:, 2],
        d_local[:, 2] + d_local[:, 0],
        d_local[:, 0] + d_local[:, 1]], dim=-1))
    axis_channel_pdf = torch.stack([
        torch.abs(dot(ss, normal_next)) * (0.25 / 3.0),
        torch.abs(dot(ts, normal_next)) * (0.25 / 3.0),
        torch.abs(dot(ns, normal_next)) * (0.5 / 3.0)], dim=-1)

    sigma_t2 = sigma_t * sigma_t
    pdf = torch.zeros_like(radius)
    for axis in range(3):
        axis_pdf = torch.zeros_like(radius)
        for ch in range(3):
            r_opt = radius_proj[:, axis] * sigma_t[:, ch]
            sr, re, valid = eval_profile_table(t_rho, t_rad, t_prof, t_eff,
                                               rho[:, ch], r_opt)
            channel_pdf = sr * sigma_t2[:, ch] / torch.clamp_min(re, 1e-12)
            channel_pdf = torch.where(r_opt > 1e-4,
                                    channel_pdf / torch.clamp_min(r_opt, 1e-4),
                                    channel_pdf)
            axis_pdf = axis_pdf + torch.where(valid,
                                            torch.clamp_min(channel_pdf, 0.0), 0.0)
        pdf = pdf + axis_pdf * axis_channel_pdf[:, axis]

    srs = []
    for ch in range(3):
        r_opt = radius * sigma_t[:, ch]
        sr, _, valid = eval_profile_table(t_rho, t_rad, t_prof, t_eff,
                                          rho[:, ch], r_opt)
        sr = torch.where(r_opt > 1e-4, sr / torch.clamp_min(r_opt, 1e-4), sr)
        srs.append(torch.where(valid, torch.clamp_min(sr * sigma_t2[:, ch], 0.0),
                             0.0))
    Sr = torch.stack(srs, dim=-1)
    return torch.clamp_max(Sr / torch.clamp_min(pdf, 1e-20)[:, None], 10.0)


def _sample_probe_ray(r1, r2, r3, normal, hitpoint, sigma_t, rho, vx, vy,
                      scene=None, use_soe=True):
    """sampleBSSRDFprobeRay (src/bssrdf.cuh:278-317); SoE path by default,
    tabulated inverse-CDF path when use_soe=False.
    Returns (orig, dir, ray_length, radius)."""
    ch = torch.clamp((r1 * 3.0).to(torch.int32), 0, 2)
    r1 = r1 * 3.0 - ch.to(torch.float32)

    axis_n = r1 < 0.5
    axis_x = (r1 >= 0.5) & (r1 < 0.75)

    probe_dir = torch.where(axis_n[:, None], normal,
                          torch.where(axis_x[:, None], vx, vy))
    probex = torch.where(axis_n[:, None], vx,
                       torch.where(axis_x[:, None], normal, vx))
    probey = torch.where(axis_n[:, None], vy,
                       torch.where(axis_x[:, None], vy, normal))
    # the reference's in-place r1 updates (quirk kept; see module docstring)
    r1 = torch.where(axis_n, r1 * 2.0,
                   torch.where(axis_x, r1 * (r1 - 0.5) * 4.0,
                             r1 * (r1 - 0.75) * 4.0))

    st_ch = torch.clamp_min(channel_select(sigma_t, ch), 1e-12)
    rho_ch = channel_select(rho, ch)
    if use_soe:
        s = param_soe(rho_ch)
        radius = -torch.log(torch.clamp_min(1.0 - r2 * 0.99, 1e-12)) / st_ch / s
        radius_max = -math.log(0.01) / st_ch / s
        # the radius x3 only exists on the SoE path (src/bssrdf.cuh:304-307)
        x3 = r1 < 0.5
        radius = torch.where(x3, radius * 3.0, radius)
        radius_max = torch.where(x3, radius_max * 3.0, radius_max)
    else:
        from ..bssrdf.sample import sample_bssrdf_radius_table
        radius = sample_bssrdf_radius_table(
            scene["bssrdf_rho"], scene["bssrdf_radius"],
            scene["bssrdf_profile"], scene["bssrdf_cdf"],
            st_ch, rho_ch, r2 * 0.99)
        radius_max = sample_bssrdf_radius_table(
            scene["bssrdf_rho"], scene["bssrdf_radius"],
            scene["bssrdf_profile"], scene["bssrdf_cdf"],
            st_ch, rho_ch, torch.full_like(rho_ch, 0.99))

    phi = TWO_PI * r3
    ray_len = 2.0 * torch.sqrt(torch.clamp_min(
        radius_max * radius_max - radius * radius, 0.0))
    orig = hitpoint + radius[:, None] * (probex * torch.cos(phi)[:, None]
                                         + probey * torch.sin(phi)[:, None]) \
        - (ray_len * 0.5)[:, None] * probe_dir
    return orig, probe_dir, ray_len, radius


def uses_kernels(device, settings):
    """Whether bssrdf_scatter runs the probe loop's kernels
    (ops/bssrdf.py) on tensors of `device`: a CUDA device with the SoE
    profile. The tabulated profile takes the plain version everywhere."""
    return torch.device(device).type == "cuda" and settings.bssrdf_use_soe


def bssrdf_scatter(scene, settings, rng, hitpoint, normal2, mat, mat_id,
                   objcol, lanes, shade_out=None):
    """The probe loop. Returns (rng, new_orig, new_dir, mask_mul, ok,
    is_mul, next_normal): is_mul is mask_mul before the exit Fresnel factor
    and next_normal the unit normal at the exit point, both for the distant
    light's NEE there. 4 RNG draws per probe and 2 after the loop.

    Only `lanes` participate; others get don't-care outputs with ok=False.
    shade_out: the surface draw's (new_orig, next_dir, mask_mul) [N,3];
    given, the returned three are those with the exit's on the ok lanes
    (on the card written into them in place), which makes them defined on
    every lane.

    A CUDA tensor with the SoE profile runs the kernels of ops/bssrdf.py
    around the probe traces, or raises; a CPU tensor, and the tabulated
    profile on any device, run bssrdf_scatter_plain. Both give the same
    bits (uses_kernels)."""
    if not uses_kernels(hitpoint.device, settings):
        out = bssrdf_scatter_plain(scene, settings, rng, hitpoint, normal2,
                                   mat, mat_id, objcol, lanes)
        if shade_out is None:
            return out
        ok = out[4][:, None]
        return (out[0],) + tuple(torch.where(ok, b, s) for b, s in zip(
            out[1:4], shade_out)) + out[4:]
    from .wavefront import trace_rays
    from ..ops.bssrdf import probe_loop

    def trace(orig, raydir, tmax):
        return trace_rays(scene, settings, orig, raydir, RAY_MIN, tmax,
                          anyhit=False, active=lanes)
    return probe_loop(scene, rng, hitpoint, normal2, mat_id, objcol, lanes,
                      settings.bssrdf_probes, settings.use_texture, trace,
                      shade_out)


def bssrdf_scatter_plain(scene, settings, rng, hitpoint, normal2, mat,
                         mat_id, objcol, lanes):
    """bssrdf_scatter in plain torch, on any device. Each probe segment is
    one closest-hit trace under the mask `lanes` with the per-lane tmax
    `probe_len` (on the card: the kernel's mask + per-lane-tmax form)."""
    from .wavefront import fetch_attributes, trace_rays, texture_radiance
    N = hitpoint.shape[0]
    rho = objcol
    sigma_t = 1.0 / torch.clamp_min(mat["mfp"], 1e-12)
    vx, vy = make_basis(normal2)

    MAX_RATIO = 10.0
    MIN_NORMAL_DOT = 0.1

    dev = hitpoint.device
    need_new = torch.ones((N,), dtype=torch.bool, device=dev)
    select_this = torch.zeros((N,), dtype=torch.bool, device=dev)
    hit_count = torch.zeros((N,), dtype=torch.int32, device=dev)
    hit_per_probe = torch.zeros((N,), dtype=torch.int32, device=dev)
    probe_hit_count = torch.zeros((N,), dtype=torch.int32, device=dev)
    probe_orig = hitpoint
    probe_dir = normal2
    probe_len = torch.zeros((N,), dtype=torch.float32, device=dev)
    sampled_radius = torch.ones((N,), dtype=torch.float32, device=dev)
    res_point = hitpoint
    res_normal = normal2
    res_color = objcol
    last_vec = torch.zeros((N, 3), dtype=torch.float32, device=dev)

    use_soe = settings.bssrdf_use_soe
    for _ in range(settings.bssrdf_probes):
        rng, (r1, r2, r3, r4) = RaySampler.next_n(rng, 4)
        # ---- spawn a new probe ray where needed ----
        s_orig, s_dir, s_len, s_rad = _sample_probe_ray(
            r1, r2, r3, normal2, hitpoint, sigma_t, rho, vx, vy,
            scene=scene, use_soe=use_soe)
        commit = need_new & select_this
        probe_hit_count = torch.where(commit, hit_per_probe, probe_hit_count)
        select_this = select_this & ~need_new
        hit_per_probe = torch.where(need_new, 0, hit_per_probe)
        probe_orig = torch.where(need_new[:, None], s_orig, probe_orig)
        probe_dir = torch.where(need_new[:, None], s_dir, probe_dir)
        probe_len = torch.where(need_new, s_len, probe_len)
        sampled_radius = torch.where(need_new, s_rad, sampled_radius)

        # ---- probe traversal (masked) ----
        # tmax clamps to the sampled probe length: hits beyond it are
        # discarded anyway, and short rays prune traversal early (the
        # reference's probe rays carry the same tMax semantics)
        slot, dist = trace_rays(scene, settings, probe_orig, probe_dir,
                                RAY_MIN, probe_len, anyhit=False,
                                active=lanes)
        got_hit = lanes & (slot >= 0)

        hp_any = probe_orig + probe_dir * dist[:, None]
        vec = hp_any - hitpoint
        real_radius = length(vec)
        last_vec = torch.where(got_hit[:, None], vec, last_vec)

        hit_uv, smooth_n, surface_mat, geo_n = fetch_attributes(scene, slot,
                                                                hp_any)
        probe_obj_color = objcol
        if settings.use_texture:
            tex = texture_radiance(scene, hit_uv)
            probe_obj_color = torch.where(
                (mat["useTexture"] != 0)[:, None], tex, probe_obj_color)
        normal_dot = torch.abs(dot(normalize(smooth_n), probe_dir))

        valid = got_hit & (surface_mat == mat_id) \
            & (real_radius / torch.clamp_min(sampled_radius, 1e-12) < MAX_RATIO) \
            & (normal_dot > MIN_NORMAL_DOT)

        new_hit_count = hit_count + valid.to(torch.int32)
        take = valid & ((new_hit_count == 1)
                        | (r4 < 1.0 / torch.clamp_min(new_hit_count, 1)
                           .to(torch.float32)))
        hit_count = new_hit_count
        hit_per_probe = hit_per_probe + valid.to(torch.int32)

        chosen_n = torch.where((mat["useNormal"] != 0)[:, None], smooth_n, geo_n)
        res_point = torch.where(take[:, None], hp_any, res_point)
        res_normal = torch.where(take[:, None], chosen_n, res_normal)
        res_color = torch.where(take[:, None], probe_obj_color, res_color)
        select_this = select_this | take

        # ---- advance to next segment / next probe ----
        # (a miss now includes the beyond-probe-length case, since the
        # trace's tmax is the probe length)
        probe_len = torch.where(got_hit, probe_len - dist, probe_len)
        probe_orig = torch.where(got_hit[:, None],
                               hp_any + RAY_MIN * probe_dir, probe_orig)
        need_new = ~got_hit

    probe_hit_count = torch.where(select_this, hit_per_probe, probe_hit_count)
    ok = lanes & (hit_count > 0)

    mask_mul = (probe_hit_count.to(torch.float32)[:, None]
                * res_color * objcol * 0.8)

    next_normal = normalize(res_normal)
    rng, (u1, u2) = RaySampler.next_n(rng, 2)
    next_dir = lambertian_sample(u1, u2, next_normal)

    if use_soe:
        beta = calculate_bssrdf_soe(normal2, next_normal, sigma_t, rho,
                                    last_vec, vx, vy)
    else:
        beta = calculate_bssrdf_table(scene, normal2, next_normal, sigma_t,
                                      rho, last_vec, vx, vy)
    mask_mul = mask_mul * beta

    # exit Fresnel factor (src/renderkernel.cu:808); the pre-outS product is
    # the reference's importanceSamplingMask (:805), needed by the
    # distant-light NEE at the exit point (:815-841)
    is_mul = mask_mul
    eta_t = mat["etaT"]
    out_s = (1.0 - fresnel_dielectric(dot(next_dir, next_normal), 1.0, eta_t)) \
        / (1.0 - 2.0 * fresnel_moment_1(1.0 / eta_t))
    mask_mul = mask_mul * out_s[:, None]

    new_orig = res_point + RAY_MIN * next_normal
    return rng, new_orig, next_dir, mask_mul, ok, is_mul, next_normal
