"""Fresnel terms (port of materials/fresnel.py; reference
src/reflection.cuh:9-32 and src/bssrdf.cpp:16-32)."""
from __future__ import annotations

import torch


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


def fresnel_schlick(F0, cos_theta):
    """Schlick approximation; F0 may be per-lane scalar or [...,3]."""
    if F0.ndim == cos_theta.ndim:
        return F0 + (1.0 - F0) * pow5(1.0 - cos_theta)
    return F0 + (1.0 - F0) * pow5(1.0 - cos_theta)[..., None]


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel (no TIR handling; the sqrt argument
    is clamped at 0)."""
    eta = eta_i / eta_t
    cos_theta_t = torch.sqrt(torch.clamp_min(
        1.0 - (1.0 - cos_theta_i * cos_theta_i) * eta * eta, 0.0))
    r1 = eta_t * cos_theta_i
    r2 = eta_i * cos_theta_t
    r3 = eta_i * cos_theta_i
    r4 = eta_t * cos_theta_t
    rp = (r1 - r2) / (r1 + r2)
    rs = (r3 - r4) / (r3 + r4)
    return (rp * rp + rs * rs) * 0.5


def fresnel_moment_1(eta):
    """First Fresnel moment polynomial fit (src/bssrdf.cpp:16-22)."""
    eta = torch.as_tensor(eta, dtype=torch.float32)
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1.0, lo, hi)


def fresnel_moment_2(eta):
    """Second Fresnel moment polynomial fit (src/bssrdf.cpp:24-32)."""
    eta = torch.as_tensor(eta, dtype=torch.float32)
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
          + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / torch.where(eta == 0, 1.0, eta)
    r2 = r * r
    r3 = r2 * r
    hi = (-547.033 + 45.3087 * r3 - 218.725 * r2 + 458.843 * r
          + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
          + 0.63942 * e5)
    return torch.where(eta < 1.0, lo, hi)
