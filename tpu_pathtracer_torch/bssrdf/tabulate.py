"""Photon-beam-diffusion BSSRDF table precompute (host, numpy; the port's
own copy of bssrdf/tabulate.py, the same arithmetic in the same order).

Functional parity with the reference's CPU table builder
(ComputeBeamDiffusionBSSRDF, src/bssrdf.cpp:166-194): a 100(rho) x 64(radius)
profile of 2*pi*r*(single-scatter + multi-scatter dipole) responses, the
Catmull-Rom-integrated CDF per rho row, and the effective albedo rhoEff.
The numerics follow the published photon-beam-diffusion model (Habel et al.;
PBRT v3 ch. 11.4): vectorized over the 100-sample depth quadrature instead
of the reference's scalar loops.

Grids match src/bssrdf.cpp exactly:
  radius: 0, 2.5e-3, then *1.2 geometric (64 entries)   (:169-173)
  rho:    (1 - e^{-8i/99}) / (1 - e^{-8})  (100 entries) (:176-178)
The table is uploaded once (analog of initBssrdfTable, src/main.cpp:408-429).
"""
from __future__ import annotations

import dataclasses

import numpy as np

N_BEAM_SAMPLES = 100


def fresnel_moment_1(eta):
    e2, e3, e4, e5 = eta**2, eta**3, eta**4, eta**5
    if eta < 1:
        return (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
                + 2.49277 * e4 - 0.68441 * e5)
    return (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
            - 1.27198 * e4 + 0.12746 * e5)


def fresnel_moment_2(eta):
    e2, e3, e4, e5 = eta**2, eta**3, eta**4, eta**5
    if eta < 1:
        return (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
                + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / eta
    return (-547.033 + 45.3087 * r**3 - 218.725 * r**2 + 458.843 * r
            + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
            + 0.63942 * e5)


def fr_dielectric(cos_i, eta_i, eta_t):
    cos_i = np.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    ei = np.where(entering, eta_i, eta_t)
    et = np.where(entering, eta_t, eta_i)
    cos_i = np.abs(cos_i)
    sin_t = ei / et * np.sqrt(np.maximum(0.0, 1.0 - cos_i**2))
    cos_t = np.sqrt(np.maximum(0.0, 1.0 - sin_t**2))
    rp = (et * cos_i - ei * cos_t) / (et * cos_i + ei * cos_t)
    rs = (ei * cos_i - et * cos_t) / (ei * cos_i + et * cos_t)
    f = 0.5 * (rp**2 + rs**2)
    return np.where(sin_t >= 1.0, 1.0, f)


def phase_hg(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / (denom * np.sqrt(denom))


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r):
    """Multi-scatter dipole term, vectorized over the depth quadrature
    (reference scalar loop at src/bssrdf.cpp:34-79)."""
    n = N_BEAM_SAMPLES
    sigmap_s = sigma_s * (1.0 - g)
    sigmap_t = sigma_a + sigmap_s
    if sigmap_t <= 0:
        return 0.0
    rhop = sigmap_s / sigmap_t
    d_g = (2.0 * sigma_a + sigmap_s) / (3.0 * sigmap_t**2)
    sigma_tr = np.sqrt(sigma_a / d_g)
    fm1 = fresnel_moment_1(eta)
    fm2 = fresnel_moment_2(eta)
    ze = -2.0 * d_g * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)

    i = np.arange(n)
    zr = -np.log(1.0 - (i + 0.5) / n) / sigmap_t
    zv = -zr + 2.0 * ze
    dr = np.sqrt(r * r + zr * zr)
    dv = np.sqrt(r * r + zv * zv)
    inv4pi = 1.0 / (4.0 * np.pi)
    phi_d = inv4pi / d_g * (np.exp(-sigma_tr * dr) / dr
                            - np.exp(-sigma_tr * dv) / dv)
    e_dn = inv4pi * (zr * (1 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / dr**3
                     - zv * (1 + sigma_tr * dv) * np.exp(-sigma_tr * dv) / dv**3)
    e1 = phi_d * c_phi + e_dn * c_e
    kappa = 1.0 - np.exp(-2.0 * sigmap_t * (dr + zr))
    return float(np.sum(kappa * rhop * rhop * e1) / n)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r):
    """Single-scatter term (reference loop at src/bssrdf.cpp:113-139)."""
    n = N_BEAM_SAMPLES
    sigma_t = sigma_a + sigma_s
    if sigma_t <= 0:
        return 0.0
    rho = sigma_s / sigma_t
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = np.arange(n)
    ti = t_crit - np.log(1.0 - (i + 0.5) / n) / sigma_t
    d = np.sqrt(r * r + ti * ti)
    cos_o = ti / d
    ess = (rho * np.exp(-sigma_t * (d + t_crit)) / (d * d)
           * phase_hg(cos_o, g)
           * (1.0 - fr_dielectric(-cos_o, 1.0, eta))
           * np.abs(cos_o))
    return float(np.sum(ess) / n)


def integrate_catmull_rom(x, values):
    """Definite integral of the Catmull-Rom interpolant + running CDF
    (reference src/bssrdf.cpp:141-164). Returns (total, cdf array)."""
    n = len(x)
    cdf = np.zeros(n)
    total = 0.0
    for i in range(n - 1):
        x0, x1 = x[i], x[i + 1]
        f0, f1 = values[i], values[i + 1]
        width = x1 - x0
        if i > 0:
            d0 = width * (f1 - values[i - 1]) / (x1 - x[i - 1])
        else:
            d0 = f1 - f0
        if i + 2 < n:
            d1 = width * (values[i + 2] - f0) / (x[i + 2] - x0)
        else:
            d1 = f1 - f0
        total += ((d0 - d1) / 12.0 + (f0 + f1) * 0.5) * width
        cdf[i + 1] = total
    return total, cdf


@dataclasses.dataclass
class BSSRDFTable:
    rho: np.ndarray           # [n_rho]
    radius: np.ndarray        # [n_radius]
    profile: np.ndarray       # [n_rho, n_radius]
    profile_cdf: np.ndarray   # [n_rho, n_radius]
    rho_eff: np.ndarray       # [n_rho]


def compute_beam_diffusion_table(g=0.0, eta=1.4, n_rho=100, n_radius=64):
    """Defaults (g=0, eta=1.4, 100x64) match initBssrdfTable
    (src/main.cpp:408-415)."""
    radius = np.zeros(n_radius)
    radius[1] = 2.5e-3
    for i in range(2, n_radius):
        radius[i] = radius[i - 1] * 1.2
    i = np.arange(n_rho)
    rho = (1.0 - np.exp(-8.0 * i / (n_rho - 1))) / (1.0 - np.exp(-8.0))

    profile = np.zeros((n_rho, n_radius))
    cdf = np.zeros((n_rho, n_radius))
    rho_eff = np.zeros(n_rho)
    for a, rh in enumerate(rho):
        for b, r in enumerate(radius):
            profile[a, b] = 2.0 * np.pi * r * (
                beam_diffusion_ss(rh, 1.0 - rh, g, eta, r)
                + beam_diffusion_ms(rh, 1.0 - rh, g, eta, r))
        rho_eff[a], cdf[a] = integrate_catmull_rom(radius, profile[a])
    return BSSRDFTable(rho=rho, radius=radius, profile=profile,
                       profile_cdf=cdf, rho_eff=rho_eff)
