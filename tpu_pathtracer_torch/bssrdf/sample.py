"""Tabulated BSSRDF sampling / evaluation on tensors (port of
bssrdf/sample.py).

Parity with the reference device spline machinery (src/bssrdf.cuh): binary
interval search (FindInterval :17), Catmull-Rom weights (:31), inverted-CDF
radius sampling (SampleCatmullRom2D :140, sampleBSSRDFtable :233), and the
tabulated profile/pdf evaluation used by calculateBSSRDF's non-SoE branches
(:361-431). The Newton-bisection inversions are fixed-trip vectorized
loops, with the trip counts of the JAX package.

The SoE fast path (USE_SOE, src/bssrdf.cuh:8) lives in
tracer/bssrdf_shade.py; this module provides the table path.
"""
from __future__ import annotations

import torch

NEWTON_ITERS = 10


def _take(flat, idx):
    """flat[idx] with idx clipped into range."""
    return flat[torch.clamp(idx, 0, flat.shape[0] - 1).long()]


def catmull_rom_weights(nodes, x):
    """nodes: [K]; x: [N]. Returns (offset [N] i32, weights [N,4], valid [N]).
    Mirrors CatmullRomWeights (src/bssrdf.cuh:31-71)."""
    K = nodes.shape[0]
    valid = (x >= nodes[0]) & (x <= nodes[K - 1])
    idx = torch.clamp(
        torch.searchsorted(nodes, x.contiguous(), right=True) - 1, 0, K - 2)
    x0 = nodes[idx]
    x1 = nodes[torch.clamp_max(idx + 1, K - 1)]
    width = torch.clamp_min(x1 - x0, 1e-20)
    t = (x - x0) / width
    t2 = t * t
    t3 = t2 * t

    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2

    # first node weight
    has_prev = idx > 0
    prev = nodes[torch.clamp_min(idx - 1, 0)]
    w0p = (t3 - 2 * t2 + t) * width / torch.clamp_min(x1 - prev, 1e-20)
    w0 = torch.where(has_prev, -w0p, 0.0)
    w2 = w2 + torch.where(has_prev, w0p, 0.0)
    w0e = t3 - 2 * t2 + t
    w1 = w1 - torch.where(has_prev, 0.0, w0e)
    w2 = w2 + torch.where(has_prev, 0.0, w0e)

    # last node weight
    has_next = idx + 2 < K
    nxt = nodes[torch.clamp_max(idx + 2, K - 1)]
    w3p = (t3 - t2) * width / torch.clamp_min(nxt - x0, 1e-20)
    w1 = w1 - torch.where(has_next, w3p, 0.0)
    w3 = torch.where(has_next, w3p, 0.0)
    w3e = t3 - t2
    w1 = w1 - torch.where(has_next, 0.0, w3e)
    w2 = w2 + torch.where(has_next, 0.0, w3e)

    offset = (idx - 1).to(torch.int32)
    weights = torch.stack([w0, w1, w2, w3], dim=-1)
    return offset, weights, valid


def _interp(table_flat, B, offset, weights, col):
    """Interpolate 4 consecutive rows of a flattened [A,B] table at column
    `col` (per lane)."""
    out = torch.zeros(offset.shape, dtype=torch.float32,
                      device=offset.device)
    for i in range(4):
        out = out + weights[:, i] * _take(table_flat, (offset + i) * B + col)
    return out


def sample_catmull_rom_2d(nodes1, nodes2, values, cdf, alpha, u):
    """Importance-sample nodes2 given parameter alpha over nodes1
    (SampleCatmullRom2D, src/bssrdf.cuh:140-231). values/cdf: [A,B].
    Returns (sample [N], fval [N], pdf [N])."""
    A, B = values.shape
    vflat = values.reshape(-1)
    cflat = cdf.reshape(-1)
    offset, w, valid = catmull_rom_weights(nodes1, alpha)
    dev = alpha.device

    def interp(flat, col):
        return _interp(flat, B, offset, w, col)

    maximum = interp(cflat, torch.full(alpha.shape, B - 1, dtype=torch.int32,
                                       device=dev))
    u = u * maximum

    # vectorized binary search over interpolated cdf columns
    lo = torch.zeros(alpha.shape, dtype=torch.int32, device=dev)
    size = torch.full(alpha.shape, B, dtype=torch.int32, device=dev)
    for _ in range(8):  # 2^8 > 64
        half = size >> 1
        mid = lo + half
        pred = interp(cflat, torch.clamp_max(mid, B - 1)) <= u
        lo = torch.where(pred & (half > 0), mid + 1, lo)
        size = torch.where(pred, size - half - 1, half)
    idx = torch.clamp(lo - 1, 0, B - 2)

    f0 = interp(vflat, idx)
    f1 = interp(vflat, torch.clamp_max(idx + 1, B - 1))
    x0 = nodes2[idx.long()]
    x1 = nodes2[torch.clamp_max(idx + 1, B - 1).long()]
    width = torch.clamp_min(x1 - x0, 1e-20)
    u2 = (u - interp(cflat, idx)) / width

    has_prev = idx > 0
    prev = nodes2[torch.clamp_min(idx - 1, 0).long()]
    fm1 = interp(vflat, torch.clamp_min(idx - 1, 0))
    d0 = torch.where(has_prev,
                     width * (f1 - fm1) / torch.clamp_min(x1 - prev, 1e-20),
                     f1 - f0)
    has_next = idx + 2 < B
    nxt = nodes2[torch.clamp_max(idx + 2, B - 1).long()]
    fp2 = interp(vflat, torch.clamp_max(idx + 2, B - 1))
    d1 = torch.where(has_next,
                     width * (fp2 - f0) / torch.clamp_min(nxt - x0, 1e-20),
                     f1 - f0)

    # Newton-bisection inversion of the spline's definite integral
    t = torch.where(f0 != f1,
                    (f0 - torch.sqrt(torch.clamp_min(
                        f0 * f0 + 2.0 * u2 * (f1 - f0), 0.0)))
                    / torch.where(f0 == f1, 1.0, f0 - f1),
                    u2 / torch.clamp_min(f0, 1e-20))
    a = torch.zeros_like(t)
    b = torch.ones_like(t)
    fhat = f0
    for _ in range(NEWTON_ITERS):
        t = torch.where((t > a) & (t < b), t, 0.5 * (a + b))
        Fhat = t * (f0 + t * (0.5 * d0 + t * (
            (1.0 / 3.0) * (-2 * d0 - d1) + f1 - f0
            + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                   + t * (d0 + d1 + 2 * (f0 - f1))))
        below = Fhat - u2 < 0
        a = torch.where(below, t, a)
        b = torch.where(below, b, t)
        t = t - (Fhat - u2) / torch.where(fhat == 0, 1.0, fhat)

    sample = x0 + width * torch.clamp(t, 0.0, 1.0)
    pdf = fhat / torch.clamp_min(maximum, 1e-20)
    sample = torch.where(valid & (maximum > 0), sample, 0.0)
    return sample, fhat, pdf


def sample_bssrdf_radius_table(table_rho, table_radius, profile, cdf,
                               sigma_t, rho, u):
    """sampleBSSRDFtable (src/bssrdf.cuh:233-236): radius in world units."""
    r, _, _ = sample_catmull_rom_2d(table_rho, table_radius, profile, cdf,
                                    rho, u)
    return torch.where(sigma_t > 0, r / torch.clamp_min(sigma_t, 1e-20), 0.0)


def eval_profile_table(table_rho, table_radius, profile, rho_eff,
                       rho, r_optical):
    """Tabulated Sr lookup + rhoEff for the pdf normalization
    (calculateBSSRDF's non-SoE channel loop, src/bssrdf.cuh:361-394).
    Returns (sr [N], rho_eff [N], valid [N])."""
    A, B = profile.shape
    off_a, w_a, valid_a = catmull_rom_weights(table_rho, rho)
    off_b, w_b, valid_b = catmull_rom_weights(table_radius, r_optical)
    flat = profile.reshape(-1)
    sr = torch.zeros(rho.shape, dtype=torch.float32, device=rho.device)
    for i in range(4):
        ra = torch.clamp(off_a + i, 0, A - 1)
        for j in range(4):
            rb = torch.clamp(off_b + j, 0, B - 1)
            sr = sr + w_a[:, i] * w_b[:, j] * flat[(ra * B + rb).long()]
    re = torch.zeros(rho.shape, dtype=torch.float32, device=rho.device)
    for i in range(4):
        re = re + w_a[:, i] * rho_eff[torch.clamp(off_a + i, 0, A - 1).long()]
    valid = valid_a & valid_b
    return torch.where(valid, sr, 0.0), re, valid
