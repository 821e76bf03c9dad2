"""BSDF samplers, vectorized and branch-free (port of materials/bsdf.py).

Each sampler takes explicit uniform columns and returns (next_dir,
throughput, flags) tensors; the reference quirks the JAX package keeps
(fresnelBlend's min(0.01, .) clamps, r1 reused for the reflect/refract
decision) are kept here too.
"""
from __future__ import annotations

import torch

from ..core.vecmath import (
    PI, TWO_PI, PI_OVER_2, dot, normalize, reflect, make_basis, cross,
    cosine_sample_hemisphere,
)
from .fresnel import pow5, fresnel_schlick, fresnel_dielectric


def _ggx_sample_normal_iso(u1, u2, alpha2, n):
    """Isotropic GGX microfacet normal about n (src/reflection.cuh:217-220)."""
    cos_t = 1.0 / torch.sqrt(1.0 + alpha2 * u1
                             / torch.clamp_min(1.0 - u1, 1e-7))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u2
    t, b = make_basis(n)
    m = (sin_t * torch.cos(phi))[..., None] * t \
        + (sin_t * torch.sin(phi))[..., None] * b \
        + cos_t[..., None] * n
    return normalize(m)


def _ggx_sample_normal_aniso(u1, u2, alphax, alphay, n, tangent):
    """Anisotropic GGX normal sample (src/reflection.cuh:221-229)."""
    phi = torch.atan(alphay / torch.clamp_min(alphax, 1e-7)
                     * torch.tan(TWO_PI * u1 + PI_OVER_2))
    phi = torch.where(u1 > 0.5, phi + PI, phi)
    sp = torch.sin(phi)
    cp = torch.cos(phi)
    ax2 = alphax * alphax
    ay2 = alphay * alphay
    denom = (cp * cp / torch.clamp_min(ax2, 1e-12)
             + sp * sp / torch.clamp_min(ay2, 1e-12))
    cos_t = 1.0 / torch.sqrt(1.0 + 1.0 / torch.clamp_min(denom, 1e-12)
                             * u2 / torch.clamp_min(1.0 - u2, 1e-7))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    t = normalize(tangent)
    b = cross(n, t)
    m = (sin_t * cp)[..., None] * t + (sin_t * sp)[..., None] * b \
        + cos_t[..., None] * n
    return normalize(m)


def _smith_g(tan_wo, alpha2):
    return 1.0 / (1.0 + (torch.sqrt(1.0 + alpha2 * tan_wo * tan_wo) - 1.0)
                  * 0.5)


def _tan_of(cos_wo):
    return torch.sqrt(torch.clamp_min(1.0 - cos_wo * cos_wo, 0.0)) \
        / torch.clamp_min(cos_wo, 1e-6)


def lambertian_sample(u1, u2, nl):
    """Cosine-weighted; beta = albedo (applied by the caller)."""
    return cosine_sample_hemisphere(u1, u2, nl)


def _dielectric_fresnel(into, cos_i, cos_t, etaT):
    # etaI/etaT swapped by `into`, as the inline block at
    # src/reflection.cuh:110-115
    etaI_ = torch.where(into, 1.0, etaT)
    etaT_ = torch.where(into, etaT, 1.0)
    R1 = etaT_ * cos_i
    R2 = etaI_ * cos_t
    R3 = etaI_ * cos_i
    R4 = etaT_ * cos_t
    rp = (R1 - R2) / torch.clamp_min(R1 + R2, 1e-12)
    rs = (R3 - R4) / torch.clamp_min(R3 + R4, 1e-12)
    return (rp * rp + rs * rs) * 0.5


def specular_glass_sample(u1, into, raydir, nl, etaT):
    """Smooth dielectric: TIR + Fresnel-weighted reflect/refract
    (src/reflection.cuh:87-127). Returns (next_dir, refl_mask)."""
    eta = torch.where(into, 1.0 / etaT, etaT)
    cos_i = torch.abs(dot(nl, raydir))
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta * eta * sin2_i
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    fresnel = _dielectric_fresnel(into, cos_i, cos_t, etaT)
    tir = sin2_t >= 1.0
    refl = tir | (u1 <= fresnel)
    refl_dir = normalize(reflect(raydir, nl))
    refr_dir = normalize(eta[..., None] * raydir
                         + (eta * cos_i - cos_t)[..., None] * nl)
    return torch.where(refl[..., None], refl_dir, refr_dir), refl


def ggx_reflection_sample(u1, u2, raydir, nl, tangent, F0, alphax, alphay):
    """GGX microfacet reflection, iso + aniso (src/reflection.cuh:201-269).
    Returns (next_dir, beta[...,3])."""
    isotropic = alphax == alphay
    alphax2 = alphax * alphax
    alphay2 = alphay * alphay
    m_iso = _ggx_sample_normal_iso(u1, u2, alphax2, nl)
    m_aniso = _ggx_sample_normal_aniso(u1, u2, alphax, alphay, nl, tangent)
    m = torch.where(isotropic[..., None], m_iso, m_aniso)

    next_dir = normalize(reflect(raydir, m))

    cos_wowh = torch.clamp_min(torch.abs(dot(m, next_dir)), 0.01)
    F = fresnel_schlick(F0, cos_wowh)

    cos_wo = torch.abs(dot(next_dir, nl))
    cos_wi = torch.clamp_min(torch.abs(dot(raydir, nl)), 0.01)
    tan_wo = _tan_of(cos_wo)
    g_iso = _smith_g(tan_wo, alphax2)
    b_aniso = cross(nl, normalize(tangent))
    cos2_phi_wo = dot(cross(next_dir, nl), b_aniso) ** 2
    alpha_a = torch.sqrt(cos2_phi_wo * alphax2 + (1.0 - cos2_phi_wo) * alphay2)
    at = alpha_a * tan_wo
    g_aniso = 1.0 / (1.0 + (torch.sqrt(1.0 + at * at) - 1.0) * 0.5)
    G = torch.where(isotropic, g_iso, g_aniso)

    cos_wh = torch.clamp_min(dot(m, nl), 0.01)
    beta = torch.clamp_max(F * (G * cos_wowh / cos_wi / cos_wh)[..., None],
                           1.0)
    return next_dir, beta


def rough_glass_sample(u1, u2, into, raydir, nl, etaT, alpha):
    """GGX rough dielectric (src/reflection.cuh:329-386). Returns
    (next_dir, beta_scalar, refl_mask)."""
    alpha2 = alpha * alpha
    m = _ggx_sample_normal_iso(u1, u2, alpha2, nl)

    eta = torch.where(into, 1.0 / etaT, etaT)
    cos_i = torch.abs(dot(m, raydir))
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    sin2_t = eta * eta * sin2_i
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    fresnel = _dielectric_fresnel(into, cos_i, cos_t, etaT)

    refl = (sin2_t >= 1.0) | (u1 < fresnel)
    refl_dir = normalize(reflect(raydir, m))
    refr_dir = normalize(eta[..., None] * raydir
                         + (eta * cos_i - cos_t)[..., None] * m)
    next_dir = torch.where(refl[..., None], refl_dir, refr_dir)

    cos_wo = torch.abs(dot(next_dir, nl))
    cos_wi = torch.clamp_min(torch.abs(dot(raydir, nl)), 0.01)
    G = _smith_g(_tan_of(cos_wo), alpha2)
    cos_wh = torch.clamp_min(dot(m, nl), 0.01)
    beta = torch.clamp_max(G * cos_i / cos_wi / cos_wh, 1.0)
    return next_dir, beta, refl


def microfacet_interface_sample(u1, u2, into, raydir, nl, etaT, alpha):
    """Entry interface sampler of MAT_SUBSURFACE (src/reflection.cuh:271-327).
    Returns (sampled_normal, next_dir_on_refl, beta_scalar, refl_mask)."""
    alpha2 = alpha * alpha
    rough = alpha > 1e-3
    m = torch.where(rough[..., None],
                    _ggx_sample_normal_iso(u1, u2, alpha2, nl), nl)

    cos_i = torch.abs(dot(m, raydir))
    sin2_i = torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    eta = torch.where(into, 1.0 / etaT, etaT)
    sin2_t = eta * eta * sin2_i
    fresnel = fresnel_dielectric(cos_i, 1.0, etaT)
    refl = (sin2_t >= 1.0) | (u1 < fresnel)

    next_dir = normalize(reflect(raydir, m))

    cos_wo = torch.abs(dot(next_dir, nl))
    cos_wi = torch.clamp_min(torch.abs(dot(raydir, nl)), 0.01)
    G = _smith_g(_tan_of(cos_wo), alpha2)
    cos_wh = torch.clamp_min(dot(m, nl), 0.01)
    beta = torch.where(rough,
                       torch.clamp_max(G * cos_i / cos_wi / cos_wh, 1.0), 1.0)
    return m, next_dir, beta, refl


def fresnel_blend_sample(u1, u2, u3, raydir, nl, Rd, Rs, alpha):
    """Ashikhmin-Shirley Fresnel blend (src/reflection.cuh:388-443), with
    its min(0.01, .) clamps. Returns (next_dir, beta[...,3])."""
    alpha2 = torch.clamp_min(alpha * alpha, 1e-12)
    d_dir = cosine_sample_hemisphere(u1, u2, nl)
    wh_d = d_dir - raydir
    m = _ggx_sample_normal_iso(u1, u2, alpha2, nl)
    s_dir = reflect(raydir, m)

    diffuse = u3 < 0.5
    next_dir = torch.where(diffuse[..., None], d_dir, s_dir)
    wh = torch.where(diffuse[..., None], wh_d, m)
    wh = normalize(wh)
    next_dir = normalize(next_dir)

    wo = normalize(raydir)
    cos_wi = torch.abs(dot(next_dir, nl))
    cos_wo = torch.clamp_max(torch.abs(dot(wo, nl)), 0.01)   # quirk: min
    cos_wh = torch.clamp_max(torch.abs(dot(wh, nl)), 0.01)   # quirk: min

    cos2_wh = cos_wh * cos_wh
    tan2_wh = (1.0 - cos2_wh) / torch.clamp_min(cos2_wh, 1e-12)
    cos4_wh = cos2_wh * cos2_wh
    e = 1.0 + tan2_wh / alpha2
    D = 1.0 / (PI * alpha2 * torch.clamp_min(cos4_wh * e * e, 1e-30))

    dot_wiwh = torch.clamp_max(torch.abs(dot(next_dir, wh)), 0.01)  # quirk
    diff = (28.0 / (23.0 * PI)) * Rd * (1.0 - Rs) \
        * ((1.0 - pow5(1.0 - 0.5 * cos_wi))
           * (1.0 - pow5(1.0 - 0.5 * cos_wo)))[..., None]
    spec = (D / (4.0 * torch.clamp_min(dot_wiwh, 1e-7)
                 * torch.clamp_min(torch.maximum(cos_wi, cos_wo), 1e-7))
            )[..., None] * fresnel_schlick(Rs, dot_wiwh)
    f = spec + diff
    pdf = 0.5 * (cos_wi / PI + D / (4.0 * torch.clamp_min(dot_wiwh, 1e-7)))
    beta = f * (cos_wi / torch.clamp_min(pdf, 1e-20))[..., None]
    return next_dir, beta


def henyey_greenstein_sample(u1, u2, g, raydir):
    """HG phase function direction sample (src/reflection.cuh:131-150)."""
    g_safe = torch.where(torch.abs(g) < 1e-3, 1.0, g)
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
    cos_t = torch.where(torch.abs(g) < 1e-3,
                        1.0 - 2.0 * u1,
                        (1.0 + g * g - sqr * sqr) / (2.0 * g_safe))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u2
    v1, v2 = make_basis(raydir)
    return normalize((sin_t * torch.cos(phi))[..., None] * v1
                     + (sin_t * torch.sin(phi))[..., None] * v2
                     + cos_t[..., None] * raydir)
