"""The plain reference of a render: each sample (frame, lane) traced as one
path from its camera ray to its end, in plain torch, vectorized over paths.

It follows the published semantics the program implements (the upstream
renderer's kernel, src/renderkernel.cu, as the port's docstrings cite it)
and works out again everything the program's set-up derives: the lane to
pixel swizzle of 32x32 blocks, the acceleration structure (accel.py, its
own tree), the environment's top-k NEE distribution and its alias table,
and the quad lookups (here plain bilinear reads of the images). The BSSRDF
probe loop uses the sum-of-exponentials profile, as the program's default
settings do; its photon-beam-diffusion table is not read on that path, so
the reference does not build it. A material's homogeneous medium (a preset
name or a [sigma_s, sigma_a, g] triple) fills the inside of a glass
surface: a path enters it on a refraction into such a surface and leaves
it on any refraction out, and on every bounce inside it samples a
distance to scatter at before its surface hit (`medium_step`).

A sample's random stream is the per-(frame, pixel) PCG stream of the
upstream renderer: seeded from wang_hash(frame) + lane, four draws for the
camera ray, then on every surface vertex six for the BSDF draw, fourteen
for the BSSRDF probe loop in a scene with a subsurface material (drawn on
every vertex, used on the lanes that refract into one), and two for the
environment NEE. In a scene with media every bounce draws four more first,
after the closest-hit trace, for the medium (drawn inside a medium or not),
and a path that scatters in the medium draws the surface's numbers too,
unused. The same sample gives the same path, whatever wave or
lane the program traces it in.

`dtype` is the precision every float is computed in: float32 for the
reference, bfloat16 for the control (see portbench/control.py). It
imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .accel import TriangleTree

PI = 3.1415926535897932384626433832795
TWO_PI = 2.0 * PI
INV_PI = 1.0 / PI
RAY_MIN = 1e-4
RAY_MAX = 1e20
MASK32 = 0xFFFFFFFF
SQRT_ONE_THIRD = 0.5773502691896257645091487805019574556476

MAT = {"MAT_EMIT": 0, "MAT_DIFF": 1, "MAT_GLASS": 2, "MAT_REFL": 3,
       "MAT_DIFF_REFL": 4, "MAT_FRESNEL": 5, "MAT_NULL": 6,
       "MAT_SUBSURFACE": 7}
# the upstream material record's defaults (src/SceneDesc.h:18-32)
MAT_DEFAULTS = {"refltype": "MAT_DIFF", "objcol": (1.0, 1.0, 1.0),
                "emit": (0.0, 0.0, 0.0), "alphax": 0.0, "alphay": 0.0,
                "kd": 1.0, "ks": 1.0, "etaT": 1.33, "useNormal": True,
                "useTexture": False, "F0": (0.56, 0.57, 0.58),
                "tangent": (0.0, 1.0, -1.0), "mfp": (1.0, 1.0, 1.0)}
# the upstream's medium presets (src/scenes.txt:51-55): sigma_s, sigma_a
# (per unit length, RGB) and the Henyey-Greenstein g
MEDIA = {
    "cloud": ((20.0, 20.0, 20.0), (5.0, 5.0, 5.0), 0.0),
    "tea": ((0.040224 * 5, 0.045264 * 5, 0.051081 * 5),
            (2.4288, 4.5757, 7.2127), 0.5),
    "milk": ((4.5513 * 20, 5.8294 * 20, 7.136 * 20),
             (0.0015333, 0.0046, 0.019933), -0.5),
    "jade": ((45.0, 40.0, 50.0), (10.0, 5.0, 15.0), 0.2),
    "skin": ((0.74 * 1000, 0.88 * 1000, 1.01 * 1000),
             (0.032 * 500, 0.17 * 500, 0.48 * 500), 0.5),
}
SETTINGS = {"bounce_min": 2, "bounce_max": 16, "env_nee_topk": 16384,
            "bssrdf_probes": 3}


# ---- random numbers: PCG over uint32 carried in int64 ----

def wang_hash(x):
    x = torch.as_tensor(x).to(torch.int64) & MASK32
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & MASK32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & MASK32
    return x ^ (x >> 15)


def _pcg_out(state):
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def rng_seed(frame, lane):
    x = (wang_hash(frame) + (lane.to(torch.int64) & MASK32)) & MASK32
    return _pcg_out((x * 747796405 + 2891336453) & MASK32)


class Stream:
    """The per-path uniform stream; draws come out in `dt`."""

    def __init__(self, state, dt):
        self.state, self.dt = state, dt

    def draw(self, n):
        out = []
        for _ in range(n):
            self.state = (self.state * 747796405 + 2891336453) & MASK32
            bits = _pcg_out(self.state) >> 8
            out.append((bits.to(torch.float32) * (1.0 / 16777216.0))
                       .to(self.dt))
        return out

    def sub(self, idx):
        return Stream(self.state[idx], self.dt)

    def put(self, idx, other):
        self.state[idx] = other.state


# ---- vectors ----

def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a):
    return a * torch.reciprocal(torch.sqrt(torch.clamp_min(
        dot(a, a)[..., None], 1e-20)))


def reflect(d, n):
    return d - n * 2.0 * dot(n, d)[..., None]


def make_basis(n):
    ax = torch.abs(n[..., 0:1])
    ay = torch.abs(n[..., 1:2])
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    w = torch.where(ax < SQRT_ONE_THIRD, eye[0],
                    torch.where(ay < SQRT_ONE_THIRD, eye[1], eye[2]))
    u = normalize(cross(n, w))
    return u, cross(n, u)


def cosine_hemisphere(u1, u2, n):
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    sx = torch.where(ox == 0.0, torch.ones_like(ox), ox)
    sy = torch.where(oy == 0.0, torch.ones_like(oy), oy)
    theta = torch.where(use_x, (PI / 4) * (oy / sx),
                        PI / 2 - (PI / 4) * (ox / sy))
    degen = (ox == 0.0) & (oy == 0.0)
    dx = torch.where(degen, torch.zeros_like(r), r * torch.cos(theta))
    dy = torch.where(degen, torch.zeros_like(r), r * torch.sin(theta))
    z = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    u, v = make_basis(n)
    return normalize(dx[..., None] * u + dy[..., None] * v + z[..., None] * n)


def pow5(x):
    x2 = x * x
    return x2 * x2 * x


# ---- Fresnel and microfacet draws (src/reflection.cuh) ----

def fresnel_dielectric(cos_i, eta_i, eta_t):
    eta = eta_i / eta_t
    cos_t = torch.sqrt(torch.clamp_min(
        1.0 - (1.0 - cos_i * cos_i) * eta * eta, 0.0))
    rp = (eta_t * cos_i - eta_i * cos_t) / (eta_t * cos_i + eta_i * cos_t)
    rs = (eta_i * cos_i - eta_t * cos_t) / (eta_i * cos_i + eta_t * cos_t)
    return (rp * rp + rs * rs) * 0.5


def fresnel_moment_1(eta):
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1.0, lo, hi)


def _schlick(F0, c):
    return F0 + (1.0 - F0) * pow5(1.0 - c)[..., None]


def _ggx_normal(u1, u2, alpha2, n):
    cos_t = 1.0 / torch.sqrt(1.0 + alpha2 * u1
                             / torch.clamp_min(1.0 - u1, 1e-7))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u2
    t, b = make_basis(n)
    return normalize((sin_t * torch.cos(phi))[..., None] * t
                     + (sin_t * torch.sin(phi))[..., None] * b
                     + cos_t[..., None] * n)


def _ggx_normal_aniso(u1, u2, ax, ay, n, tangent):
    phi = torch.atan(ay / torch.clamp_min(ax, 1e-7)
                     * torch.tan(TWO_PI * u1 + PI / 2))
    phi = torch.where(u1 > 0.5, phi + PI, phi)
    sp, cp = torch.sin(phi), torch.cos(phi)
    denom = (cp * cp / torch.clamp_min(ax * ax, 1e-12)
             + sp * sp / torch.clamp_min(ay * ay, 1e-12))
    cos_t = 1.0 / torch.sqrt(1.0 + 1.0 / torch.clamp_min(denom, 1e-12)
                             * u2 / torch.clamp_min(1.0 - u2, 1e-7))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    t = normalize(tangent)
    b = cross(n, t)
    return normalize((sin_t * cp)[..., None] * t + (sin_t * sp)[..., None] * b
                     + cos_t[..., None] * n)


def _smith_g(tan_wo, alpha2):
    return 1.0 / (1.0 + (torch.sqrt(1.0 + alpha2 * tan_wo * tan_wo) - 1.0)
                  * 0.5)


def _tan_of(c):
    return torch.sqrt(torch.clamp_min(1.0 - c * c, 0.0)) \
        / torch.clamp_min(c, 1e-6)


def _fresnel_swapped(into, cos_i, cos_t, etaT):
    one = torch.ones_like(etaT)
    ei = torch.where(into, one, etaT)
    et = torch.where(into, etaT, one)
    rp = (et * cos_i - ei * cos_t) / torch.clamp_min(et * cos_i + ei * cos_t,
                                                     1e-12)
    rs = (ei * cos_i - et * cos_t) / torch.clamp_min(ei * cos_i + et * cos_t,
                                                     1e-12)
    return (rp * rp + rs * rs) * 0.5


def _glass_smooth(u1, into, d, nl, etaT):
    eta = torch.where(into, 1.0 / etaT, etaT)
    cos_i = torch.abs(dot(nl, d))
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    refl = (sin2_t >= 1.0) | (u1 <= _fresnel_swapped(into, cos_i, cos_t,
                                                       etaT))
    refr = normalize(eta[..., None] * d + (eta * cos_i - cos_t)[..., None]
                     * nl)
    return torch.where(refl[..., None], normalize(reflect(d, nl)), refr), refl


def _glass_rough(u1, u2, into, d, nl, etaT, alpha):
    alpha2 = alpha * alpha
    m = _ggx_normal(u1, u2, alpha2, nl)
    eta = torch.where(into, 1.0 / etaT, etaT)
    cos_i = torch.abs(dot(m, d))
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    refl = (sin2_t >= 1.0) | (u1 < _fresnel_swapped(into, cos_i, cos_t,
                                                      etaT))
    nd = torch.where(refl[..., None], normalize(reflect(d, m)),
                     normalize(eta[..., None] * d
                               + (eta * cos_i - cos_t)[..., None] * m))
    cos_wo = torch.abs(dot(nd, nl))
    cos_wi = torch.clamp_min(torch.abs(dot(d, nl)), 0.01)
    G = _smith_g(_tan_of(cos_wo), alpha2)
    cos_wh = torch.clamp_min(dot(m, nl), 0.01)
    return nd, torch.clamp_max(G * cos_i / cos_wi / cos_wh, 1.0), refl


def _ggx_reflection(u1, u2, d, nl, tangent, F0, ax, ay):
    iso = ax == ay
    ax2, ay2 = ax * ax, ay * ay
    m = torch.where(iso[..., None], _ggx_normal(u1, u2, ax2, nl),
                    _ggx_normal_aniso(u1, u2, ax, ay, nl, tangent))
    nd = normalize(reflect(d, m))
    cos_wowh = torch.clamp_min(torch.abs(dot(m, nd)), 0.01)
    F = _schlick(F0, cos_wowh)
    cos_wo = torch.abs(dot(nd, nl))
    cos_wi = torch.clamp_min(torch.abs(dot(d, nl)), 0.01)
    tan_wo = _tan_of(cos_wo)
    b_aniso = cross(nl, normalize(tangent))
    c2 = dot(cross(nd, nl), b_aniso) ** 2
    at = torch.sqrt(c2 * ax2 + (1.0 - c2) * ay2) * tan_wo
    G = torch.where(iso, _smith_g(tan_wo, ax2),
                    1.0 / (1.0 + (torch.sqrt(1.0 + at * at) - 1.0) * 0.5))
    cos_wh = torch.clamp_min(dot(m, nl), 0.01)
    return nd, torch.clamp_max(F * (G * cos_wowh / cos_wi / cos_wh)[..., None],
                               1.0)


def _interface(u1, u2, into, d, nl, etaT, alpha):
    alpha2 = alpha * alpha
    rough = alpha > 1e-3
    m = torch.where(rough[..., None], _ggx_normal(u1, u2, alpha2, nl), nl)
    cos_i = torch.abs(dot(m, d))
    eta = torch.where(into, 1.0 / etaT, etaT)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    refl = (sin2_t >= 1.0) | (u1 < fresnel_dielectric(cos_i, 1.0, etaT))
    nd = normalize(reflect(d, m))
    cos_wo = torch.abs(dot(nd, nl))
    cos_wi = torch.clamp_min(torch.abs(dot(d, nl)), 0.01)
    G = _smith_g(_tan_of(cos_wo), alpha2)
    cos_wh = torch.clamp_min(dot(m, nl), 0.01)
    beta = torch.where(rough, torch.clamp_max(G * cos_i / cos_wi / cos_wh,
                                              1.0), torch.ones_like(cos_i))
    return m, nd, beta, refl


def _fresnel_blend(u1, u2, u3, d, nl, Rd, Rs, alpha):
    alpha2 = torch.clamp_min(alpha * alpha, 1e-12)
    d_dir = cosine_hemisphere(u1, u2, nl)
    m = _ggx_normal(u1, u2, alpha2, nl)
    diffuse = u3 < 0.5
    nd = normalize(torch.where(diffuse[..., None], d_dir, reflect(d, m)))
    wh = normalize(torch.where(diffuse[..., None], d_dir - d, m))
    wo = normalize(d)
    cos_wi = torch.abs(dot(nd, nl))
    cos_wo = torch.clamp_max(torch.abs(dot(wo, nl)), 0.01)
    cos_wh = torch.clamp_max(torch.abs(dot(wh, nl)), 0.01)
    cos2 = cos_wh * cos_wh
    tan2 = (1.0 - cos2) / torch.clamp_min(cos2, 1e-12)
    e = 1.0 + tan2 / alpha2
    D = 1.0 / (PI * alpha2 * torch.clamp_min(cos2 * cos2 * e * e, 1e-30))
    dwh = torch.clamp_max(torch.abs(dot(nd, wh)), 0.01)
    diff = (28.0 / (23.0 * PI)) * Rd * (1.0 - Rs) \
        * ((1.0 - pow5(1.0 - 0.5 * cos_wi))
           * (1.0 - pow5(1.0 - 0.5 * cos_wo)))[..., None]
    spec = (D / (4.0 * torch.clamp_min(dwh, 1e-7)
                 * torch.clamp_min(torch.maximum(cos_wi, cos_wo), 1e-7))
            )[..., None] * _schlick(Rs, dwh)
    pdf = 0.5 * (cos_wi / PI + D / (4.0 * torch.clamp_min(dwh, 1e-7)))
    beta = (spec + diff) * (cos_wi / torch.clamp_min(pdf, 1e-20))[..., None]
    return nd, beta


def bsdf_draw(u, d, n, nl, into, m, objcol):
    """The surface draw of src/renderkernel.cu's material switch: (next
    direction, throughput factor [R,3], offset along nl in RAY_MIN,
    terminate, bounce budget increment, refracted into glass, refracted
    into a subsurface material, the subsurface interface normal)."""
    u1, u2, u3, _u4, u5, _u6 = u
    t = m["refltype"]
    one3 = torch.ones_like(d)
    d_dir = cosine_hemisphere(u1, u2, nl)
    d_mul = m["kd"][:, None] * objcol
    mirror = m["alphax"] == 0.0
    g_dir, g_beta = _ggx_reflection(u1, u2, d, nl, m["tangent"], m["F0"],
                                    m["alphax"], m["alphay"])
    r_dir = torch.where(mirror[:, None], normalize(reflect(d, n)), g_dir)
    r_mul = torch.where(mirror[:, None], m["ks"][:, None] * objcol,
                        m["ks"][:, None] * g_beta * objcol)
    dr_spec = u5 < m["ks"] / torch.clamp_min(m["ks"] + m["kd"], 1e-7)
    f_dir, f_beta = _fresnel_blend(u1, u2, u3, d, nl,
                                   m["kd"][:, None] * objcol, m["F0"],
                                   m["alphax"])
    sg_dir, sg_refl = _glass_smooth(u1, into, d, nl, m["etaT"])
    rg_dir, rg_beta, rg_refl = _glass_rough(u1, u2, into, d, nl, m["etaT"],
                                            m["alphax"])
    smooth = m["alphax"] == 0.0
    gl_refl = torch.where(smooth, sg_refl, rg_refl)
    eta2 = m["etaT"] * m["etaT"]
    rg_mul = rg_beta[:, None] * objcol * torch.where(
        (~rg_refl & ~into)[:, None], eta2[:, None], torch.ones_like(objcol))
    ss_m, ss_dir, ss_beta, ss_refl = _interface(u1, u2, into, d, nl,
                                                m["etaT"], m["alphax"])
    cases = {
        MAT["MAT_REFL"]: (r_dir, r_mul, torch.where(mirror, 2.0, 1.0)),
        MAT["MAT_DIFF_REFL"]: (torch.where(dr_spec[:, None], g_dir, d_dir),
                               torch.where(dr_spec[:, None], g_beta, objcol),
                               0.0),
        MAT["MAT_FRESNEL"]: (f_dir, f_beta, 0.0),
        MAT["MAT_GLASS"]: (torch.where(smooth[:, None], sg_dir, rg_dir),
                           torch.where(smooth[:, None], one3, rg_mul),
                           torch.where(gl_refl, 1.0, -1.0)),
        MAT["MAT_SUBSURFACE"]: (ss_dir, ss_beta[:, None] * m["ks"][:, None]
                                * objcol, 1.0),
        MAT["MAT_NULL"]: (d, one3, -1.0),
    }
    nd, mul = d_dir, d_mul
    off = torch.ones_like(u1)
    for k, (cd, cm, co) in cases.items():
        sel = t == k
        nd = torch.where(sel[:, None], cd, nd)
        mul = torch.where(sel[:, None], cm, mul)
        off = torch.where(sel, torch.as_tensor(co, dtype=off.dtype,
                                               device=off.device), off)
    spec = ((t == MAT["MAT_REFL"]) | ((t == MAT["MAT_DIFF_REFL"]) & dr_spec)
            | (t == MAT["MAT_FRESNEL"]) | (t == MAT["MAT_GLASS"])
            | ((t == MAT["MAT_SUBSURFACE"]) & ss_refl))
    return (nd, mul, off, t == MAT["MAT_EMIT"], spec.to(torch.int64),
            (t == MAT["MAT_GLASS"]) & ~gl_refl,
            (t == MAT["MAT_SUBSURFACE"]) & ~ss_refl, ss_m)


# ---- images: bilinear reads ----

def uv_of_dir(d, rotation):
    phi = torch.atan2(d[..., 0], d[..., 2])
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    u = torch.remainder(phi / TWO_PI + rotation, 1.0)
    v = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / PI
    return u, v


def bilinear(img, u, v, wrap):
    """CUDA-convention linear filter of img [H,W,C] at (u, v) in [0,1):
    texel centres at +0.5; the lower-left texel wraps (wrap) or clamps, the
    other three are its right / lower neighbours, wrapping or clamping."""
    H, W = img.shape[0], img.shape[1]
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)
    if wrap:
        xi, yi = torch.remainder(xi, W), torch.remainder(yi, H)
        xj, yj = torch.remainder(xi + 1, W), torch.remainder(yi + 1, H)
    else:
        xi, yi = torch.clamp(xi, 0, W - 1), torch.clamp(yi, 0, H - 1)
        xj, yj = torch.clamp_max(xi + 1, W - 1), torch.clamp_max(yi + 1, H - 1)
    return (img[yi, xi] * (1 - fx) * (1 - fy) + img[yi, xj] * fx * (1 - fy)
            + img[yj, xi] * (1 - fx) * fy + img[yj, xj] * fx * fy)


# ---- the environment's NEE distribution ----

def env_distribution(env, topk):
    """(pdf_uv [H,W] f32, alias rows): the sin-weighted luminance of the
    `topk` brightest texels (numpy's argpartition selects them, ties as it
    breaks them), renormalized, and Vose's alias table over them:
    prob [k] f32, alias [k], texel [k]."""
    env = np.asarray(env, np.float32)
    H, W, _ = env.shape
    lum = (0.2126 * env[..., 0] + 0.7152 * env[..., 1]
           + 0.0722 * env[..., 2]).astype(np.float64)
    theta = (np.arange(H) + 0.5) / H * np.pi
    weighted = (lum * np.sin(theta)[:, None] + 1e-12).reshape(-1)
    n = H * W
    if topk and 0 < topk < n:
        sel = np.sort(np.argpartition(weighted, n - topk)[n - topk:])
    else:
        sel = np.arange(n)
    k = sel.shape[0]
    w = weighted[sel]
    total = w.sum()
    pdf_uv = np.zeros(n)
    pdf_uv[sel] = w * (H * W) / total
    p = (w / total) * k
    prob = np.ones(k)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if p[i] < 1.0]
    large = [i for i in range(k) if p[i] >= 1.0]
    while small and large:
        s = small.pop()
        big = large.pop()
        prob[s] = p[s]
        alias[s] = big
        p[big] = p[big] - (1.0 - p[s])
        (small if p[big] < 1.0 else large).append(big)
    return (pdf_uv.reshape(H, W).astype(np.float32), prob.astype(np.float32),
            alias, sel)


def medium_of(desc):
    """(sigma_s, sigma_a, g) of a material's `medium`: a preset's name
    (MEDIA) or the triple itself; None for no medium."""
    if not desc:
        return None
    if isinstance(desc, str):
        if desc not in MEDIA:
            raise ValueError("no medium preset %r (presets: %s)"
                             % (desc, ", ".join(sorted(MEDIA))))
        return MEDIA[desc]
    ss, sa, g = desc
    return tuple(map(float, ss)), tuple(map(float, sa)), float(g)


class Scene:
    """What the reference reads of a scene, on `device` in `dtype`: the
    mesh's triangles, uv, normals and materials, the materials' media
    (`media`, by material id; `has_media`), the images, and the derived
    tree and NEE distribution."""

    def __init__(self, mesh, materials, envmap, texture, device,
                 dtype=torch.float32, settings=None):
        self.settings = dict(SETTINGS, **(settings or {}))
        f = dict(device=device, dtype=dtype)
        tv = mesh["vertices"][mesh["indices"]]
        self.tree = TriangleTree(tv, device, dtype)
        self.verts = torch.as_tensor(tv, **f)
        self.uv = torch.as_tensor(mesh["uv"], **f)
        self.normals = torch.as_tensor(mesh["normals"], **f)
        self.mat_of = torch.as_tensor(mesh["material_ids"], device=device,
                                      dtype=torch.int64)
        recs = [dict(MAT_DEFAULTS, **m) for m in materials]
        media = [medium_of(r.get("medium")) for r in recs]
        has = [md is not None for md in media]
        self.has_media = any(has)
        media = [md or ((0.0,) * 3, (0.0,) * 3, 0.0) for md in media]
        self.media = {
            "sigma_s": torch.tensor(np.asarray([md[0] for md in media],
                                               np.float32), **f),
            "sigma_a": torch.tensor(np.asarray([md[1] for md in media],
                                               np.float32), **f),
            "g": torch.tensor(np.asarray([md[2] for md in media],
                                         np.float32), **f),
            "has": torch.tensor(has, device=device)}
        self.mats = {}
        for key in MAT_DEFAULTS:
            vals = [r[key] for r in recs]
            if key == "refltype":
                self.mats[key] = torch.tensor([MAT[v] for v in vals],
                                              device=device)
            elif key in ("useNormal", "useTexture"):
                self.mats[key] = torch.tensor([bool(v) for v in vals],
                                              device=device)
            else:
                self.mats[key] = torch.tensor(np.asarray(vals, np.float32),
                                              **f)
        self.has_sss = any(r["refltype"] == "MAT_SUBSURFACE" for r in recs)
        self.env = torch.as_tensor(np.asarray(envmap, np.float32), **f)
        self.tex = None if texture is None else torch.as_tensor(
            np.asarray(texture, np.float32), **f)
        pdf_uv, prob, alias, sel = env_distribution(
            envmap, self.settings["env_nee_topk"])
        self.pdf_uv = torch.as_tensor(pdf_uv, **f)
        self.prob = torch.as_tensor(prob, **f)
        self.alias = torch.as_tensor(alias, device=device)
        self.sel = torch.as_tensor(sel, device=device)
        self.device, self.dtype = device, dtype

    def material(self, mat_id):
        return {k: v[mat_id] for k, v in self.mats.items()}

    def surface(self, tri, p):
        """(uv, smooth normal, geometric normal, material id) at points p
        [R,3] on triangles tri [R] (>= 0): barycentric interpolation of the
        corners' uv and normals."""
        v = self.verts[tri]
        a, b, c = v[:, 0], v[:, 1], v[:, 2]
        v0, v1, v2 = b - a, c - a, p - a
        d00, d01, d11 = dot(v0, v0), dot(v0, v1), dot(v1, v1)
        d20, d21 = dot(v2, v0), dot(v2, v1)
        den = d00 * d11 - d01 * d01
        den = torch.where(torch.abs(den) < 1e-30, torch.full_like(den, 1e-30),
                          den)
        bv = (d11 * d20 - d01 * d21) / den
        bw = (d00 * d21 - d01 * d20) / den
        bu = 1.0 - bv - bw
        bary = torch.stack([bu, bv, bw], dim=1)[..., None]
        uv = (bary * self.uv[tri]).sum(1)
        sn = (bary * self.normals[tri]).sum(1)
        gn = cross(a - c, b - c)
        return uv, sn, gn, self.mat_of[tri]

    def texture(self, uv):
        return bilinear(self.tex, torch.remainder(uv[:, 0], 1.0),
                        torch.remainder(uv[:, 1], 1.0), wrap=True)

    def env_pdf(self, d, rotation):
        H, W = self.pdf_uv.shape
        u, v = uv_of_dir(d, rotation)
        xi = torch.clamp((u * W).to(torch.int64), 0, W - 1)
        yi = torch.clamp((v * H).to(torch.int64), 0, H - 1)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - d[:, 1] * d[:, 1], 1e-8))
        return self.pdf_uv[yi, xi] / (2.0 * PI * PI * sin_t)

    def env_miss(self, d, pdf_prev, rotation):
        """Environment radiance with the BSDF-side MIS weight (weight 1
        where the previous vertex drew no NEE, pdf_prev < 0)."""
        u, v = uv_of_dir(d, rotation)
        L = bilinear(self.env, u, v, wrap=False)
        pe = self.env_pdf(d, rotation)
        w = pdf_prev * pdf_prev / torch.clamp_min(
            pdf_prev * pdf_prev + pe * pe, 1e-20)
        return torch.where(pdf_prev < 0.0, torch.ones_like(w), w)[:, None] * L

    def env_sample(self, e1, e2, rotation):
        H, W = self.pdf_uv.shape
        k = self.prob.shape[0]
        b = torch.clamp((e1 * k).to(torch.int64), 0, k - 1)
        texel = torch.where(e2 >= self.prob[b], self.sel[self.alias[b]],
                            self.sel[b])
        row, col = texel // W, texel % W
        u = (col.to(self.dtype) + 0.5) / W
        v = (row.to(self.dtype) + 0.5) / H
        phi = (u - rotation) * TWO_PI
        theta = v * PI
        st = torch.sin(theta)
        d = torch.stack([st * torch.sin(phi), torch.cos(theta),
                         st * torch.cos(phi)], dim=-1)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - d[:, 1] ** 2, 1e-8))
        pdf = self.pdf_uv[row, col] / (2.0 * PI * PI * sin_t)
        return d, pdf, self.env[row, col]


# ---- the image: lanes, pixels, camera rays ----

def lane_of_pixel(px, py, width, height, block=32):
    """The lane of pixel (px, py): the image walked in rows of 32-pixel
    blocks, the blocks of a row left to right, each block's pixels row by
    row; the blocks at the right and bottom edges are clipped."""
    px = torch.as_tensor(px, dtype=torch.int64)
    py = torch.as_tensor(py, dtype=torch.int64)
    br, bc = py // block, px // block
    bh = torch.clamp_max(height - br * block, block)
    bw = torch.clamp_max(width - bc * block, block)
    return (br * block * width + bc * block * bh + (py - br * block) * bw
            + (px - bc * block))


def camera_rays(cam, stream, px, py):
    """Primary rays with the AA jitter and thin lens of
    src/renderkernel.cu:895-954; cam [R,16] the camera vector of each
    path."""
    jx, jy, r1, r2 = stream.draw(4)

    def unit(v):
        return v / torch.sqrt(dot(v, v))[:, None]
    pos = cam[:, 2:5]
    view = unit(cam[:, 5:8])
    up = unit(cam[:, 8:11])
    h = unit(cross(view, up))
    vert = unit(cross(h, view))
    horizontal = h * torch.tan(cam[:, 11] * 0.5 * (PI / 180.0))[:, None]
    vertical = vert * torch.tan(-cam[:, 12] * 0.5 * (PI / 180.0))[:, None]
    sx = (jx - 0.5 + px) / (cam[:, 0] - 1.0)
    sy = (jy - 0.5 + py) / (cam[:, 1] - 1.0)
    on_plane = (pos + view) + (2.0 * sx - 1.0)[:, None] * horizontal \
        + (2.0 * sy - 1.0)[:, None] * vertical
    on_image = pos + (on_plane - pos) * cam[:, 14:15]
    ang = TWO_PI * r1
    dist = cam[:, 13] * torch.sqrt(r2)
    ap = pos + h * (torch.cos(ang) * dist)[:, None] \
        + vert * (torch.sin(ang) * dist)[:, None]
    ap = torch.where((cam[:, 13] > 1e-5)[:, None], ap, pos)
    return ap, normalize(on_image - ap)


# ---- the BSSRDF probe loop (src/renderkernel.cu:698-844, SoE profile) ----

def _param_soe(A):
    p = torch.abs(A - 0.8)
    return 1.85 - A + 7.0 * p * p * p


def _pick(c, ch):
    return torch.where(ch == 0, c[..., 0],
                       torch.where(ch == 1, c[..., 1], c[..., 2]))


def _soe_beta(ns, nn, sigma_t, rho, dvec, ss, ts):
    radius = torch.sqrt(dot(dvec, dvec))
    dl = torch.stack([dot(ss, dvec), dot(ts, dvec), dot(ns, dvec)], -1) ** 2
    rproj = torch.sqrt(torch.stack([dl[:, 1] + dl[:, 2], dl[:, 2] + dl[:, 0],
                                    dl[:, 0] + dl[:, 1]], -1))
    acp = torch.stack([torch.abs(dot(ss, nn)) * (0.25 / 3.0),
                       torch.abs(dot(ts, nn)) * (0.25 / 3.0),
                       torch.abs(dot(ns, nn)) * (0.5 / 3.0)], -1)
    s = _param_soe(rho)
    pdf = torch.zeros_like(radius)
    for axis in range(3):
        rp = rproj[:, axis]
        ap = (torch.exp(-s * rp[:, None] * sigma_t)
              + torch.exp(-s * rp[:, None] * sigma_t / 3.0) / 3.0) \
            / (4.0 * PI) * rho * s * sigma_t
        ap = torch.where((rp > 1e-4)[:, None],
                         ap / torch.clamp_min(rp, 1e-4)[:, None], ap)
        pdf = pdf + (ap[:, 0] + ap[:, 1] + ap[:, 2]) * acp[:, axis]
    Sr = (torch.exp(-s * radius[:, None] * sigma_t)
          + torch.exp(-s * radius[:, None] * sigma_t / 3.0)) \
        / (8.0 * PI) * rho * s * sigma_t
    Sr = torch.where((radius > 1e-4)[:, None],
                     Sr / torch.clamp_min(radius, 1e-4)[:, None], Sr)
    return torch.clamp_max(Sr / torch.clamp_min(pdf, 1e-20)[:, None], 10.0)


def bssrdf_scatter(scene, stream, hitpoint, normal2, m, mat_id, objcol):
    """Up to `bssrdf_probes` probe segments reservoir-sampling the exit
    point among hits on the same material, then the exit's diffuse draw and
    its throughput. Returns (new orig, new dir, throughput factor, ok)."""
    R = hitpoint.shape[0]
    dev, dt = hitpoint.device, hitpoint.dtype
    rho = objcol
    sigma_t = 1.0 / torch.clamp_min(m["mfp"], 1e-12)
    vx, vy = make_basis(normal2)
    need_new = torch.ones(R, dtype=torch.bool, device=dev)
    select_this = torch.zeros(R, dtype=torch.bool, device=dev)
    hit_count = torch.zeros(R, dtype=torch.int64, device=dev)
    hit_per_probe = torch.zeros_like(hit_count)
    probe_hits = torch.zeros_like(hit_count)
    p_orig, p_dir = hitpoint, normal2
    p_len = torch.zeros(R, dtype=dt, device=dev)
    s_radius = torch.ones(R, dtype=dt, device=dev)
    res_point, res_normal, res_color = hitpoint, normal2, objcol
    last_vec = torch.zeros_like(hitpoint)
    for _ in range(scene.settings["bssrdf_probes"]):
        r1, r2, r3, r4 = stream.draw(4)
        ch = torch.clamp((r1 * 3.0).to(torch.int64), 0, 2)
        r1 = r1 * 3.0 - ch.to(dt)
        axis_n = r1 < 0.5
        axis_x = (r1 >= 0.5) & (r1 < 0.75)
        pdir = torch.where(axis_n[:, None], normal2,
                           torch.where(axis_x[:, None], vx, vy))
        px_ = torch.where(axis_n[:, None], vx,
                          torch.where(axis_x[:, None], normal2, vx))
        py_ = torch.where(axis_n[:, None], vy,
                          torch.where(axis_x[:, None], vy, normal2))
        r1 = torch.where(axis_n, r1 * 2.0,
                         torch.where(axis_x, r1 * (r1 - 0.5) * 4.0,
                                     r1 * (r1 - 0.75) * 4.0))
        st_ch = torch.clamp_min(_pick(sigma_t, ch), 1e-12)
        s = _param_soe(_pick(rho, ch))
        radius = -torch.log(torch.clamp_min(1.0 - r2 * 0.99, 1e-12)) \
            / st_ch / s
        rmax = -math.log(0.01) / st_ch / s
        x3 = r1 < 0.5
        radius = torch.where(x3, radius * 3.0, radius)
        rmax = torch.where(x3, rmax * 3.0, rmax)
        phi = TWO_PI * r3
        ray_len = 2.0 * torch.sqrt(torch.clamp_min(rmax * rmax
                                                   - radius * radius, 0.0))
        s_orig = hitpoint \
            + radius[:, None] * (px_ * torch.cos(phi)[:, None]
                                 + py_ * torch.sin(phi)[:, None]) \
            - (ray_len * 0.5)[:, None] * pdir
        commit = need_new & select_this
        probe_hits = torch.where(commit, hit_per_probe, probe_hits)
        select_this = select_this & ~need_new
        hit_per_probe = torch.where(need_new, 0, hit_per_probe)
        p_orig = torch.where(need_new[:, None], s_orig, p_orig)
        p_dir = torch.where(need_new[:, None], pdir, p_dir)
        p_len = torch.where(need_new, ray_len, p_len)
        s_radius = torch.where(need_new, radius, s_radius)

        tri, dist = scene.tree.trace(p_orig, p_dir, RAY_MIN, p_len)
        got = tri >= 0
        hp = p_orig + p_dir * dist[:, None]
        vec = hp - hitpoint
        real_r = torch.sqrt(dot(vec, vec))
        last_vec = torch.where(got[:, None], vec, last_vec)
        safe = torch.clamp_min(tri, 0)
        uv, sn, gn, smat = scene.surface(safe, hp)
        pcol = objcol
        if scene.tex is not None:
            pcol = torch.where(m["useTexture"][:, None], scene.texture(uv),
                               pcol)
        ndot = torch.abs(dot(normalize(sn), p_dir))
        valid = got & (smat == mat_id) & (
            real_r / torch.clamp_min(s_radius, 1e-12) < 10.0) & (ndot > 0.1)
        new_count = hit_count + valid.to(torch.int64)
        take = valid & ((new_count == 1)
                        | (r4 < 1.0 / torch.clamp_min(new_count, 1).to(dt)))
        hit_count = new_count
        hit_per_probe = hit_per_probe + valid.to(torch.int64)
        chosen = torch.where(m["useNormal"][:, None], sn, gn)
        res_point = torch.where(take[:, None], hp, res_point)
        res_normal = torch.where(take[:, None], chosen, res_normal)
        res_color = torch.where(take[:, None], pcol, res_color)
        select_this = select_this | take
        p_len = torch.where(got, p_len - dist, p_len)
        p_orig = torch.where(got[:, None], hp + RAY_MIN * p_dir, p_orig)
        need_new = ~got
    probe_hits = torch.where(select_this, hit_per_probe, probe_hits)
    ok = hit_count > 0
    mul = probe_hits.to(dt)[:, None] * res_color * objcol * 0.8
    nn = normalize(res_normal)
    u1, u2 = stream.draw(2)
    nd = cosine_hemisphere(u1, u2, nn)
    mul = mul * _soe_beta(normal2, nn, sigma_t, rho, last_vec, vx, vy)
    eta_t = m["etaT"]
    out_s = (1.0 - fresnel_dielectric(dot(nd, nn), 1.0, eta_t)) \
        / (1.0 - 2.0 * fresnel_moment_1(1.0 / eta_t))
    return res_point + RAY_MIN * nn, nd, mul * out_s[:, None], ok


# ---- homogeneous media (src/reflection.cuh:152-197, HomogeneousMedium) ----

def henyey_greenstein(u1, u2, g, d):
    """A direction drawn from the Henyey-Greenstein phase function about
    the propagation direction d:
    p(cos) = (1 - g^2) / (4 pi (1 + g^2 - 2 g cos)^(3/2)), cos the cosine
    to d, so that g > 0 scatters forward and g is the mean cosine. Its CDF
    inverted at u1: cos = (1 + g^2 - ((1 - g^2) / (1 - g + 2 g u1))^2)
    / (2 g), and the isotropic cos = 1 - 2 u1 where |g| < 1e-3; the azimuth
    2 pi u2 in the frame make_basis(d)."""
    iso = torch.abs(g) < 1e-3
    gs = torch.where(iso, torch.ones_like(g), g)
    frac = (1.0 - gs * gs) / (1.0 - gs + 2.0 * gs * u1)
    cos = torch.where(iso, 1.0 - 2.0 * u1,
                      (1.0 + gs * gs - frac * frac) / (2.0 * gs))
    sin = torch.sqrt(torch.clamp_min(1.0 - cos * cos, 0.0))
    phi = TWO_PI * u2
    a, b = make_basis(d)
    return normalize((sin * torch.cos(phi))[:, None] * a
                     + (sin * torch.sin(phi))[:, None] * b
                     + cos[:, None] * d)


def medium_step(scene, u, o, d, mask, t_hit, medium):
    """Each ray inside a medium (medium: the id of the material whose
    medium the path is in, -1 for none) over the segment to its surface
    hit at t_hit (RAY_MAX on a miss), with the draws u = (channel,
    distance, two for the phase function): a distance drawn in one
    channel's sigma_t, picked uniformly; where it is shorter than the hit
    the ray scatters there, else it reaches the surface. The throughput
    takes Tr * sigma_s / pdf or Tr / pdf, Tr the Beer-Lambert
    transmittance over the distance travelled and pdf the mean over the
    channels of sigma_t * Tr (scatter) or Tr (surface), 1 where under 1e-4.
    Returns (o, d, mask, scattered): a scattered ray starts at its scatter
    point in a Henyey-Greenstein direction; rays outside a medium are
    unchanged."""
    u1, u2, u3, u4 = u
    inside = medium >= 0
    at = torch.clamp_min(medium, 0)
    sigma_s, g = scene.media["sigma_s"][at], scene.media["g"][at]
    sigma_t = sigma_s + scene.media["sigma_a"][at]
    ch = torch.clamp((u1 * 3.0).to(torch.int64), 0, 2)
    dist = -torch.log(1.0 - u2) / torch.clamp_min(_pick(sigma_t, ch), 1e-12)
    scat = inside & (dist < t_hit)
    t = torch.clamp_max(torch.where(scat, dist, t_hit), RAY_MAX)
    tr = torch.exp(-sigma_t * t[:, None])
    density = torch.where(scat[:, None], sigma_t * tr, tr)
    pdf = (density[:, 0] + density[:, 1] + density[:, 2]) / 3.0
    pdf = torch.where(pdf < 1e-4, torch.ones_like(pdf), pdf)
    w = torch.where(scat[:, None], tr * sigma_s, tr) / pdf[:, None]
    mask = torch.where(inside[:, None], mask * w, mask)
    o = torch.where(scat[:, None], o + t[:, None] * d, o)
    d = torch.where(scat[:, None], henyey_greenstein(u3, u4, g, d), d)
    return o, d, mask, scat


# ---- paths ----

def trace_paths(scene, cam, width, height, frame, lane):
    """Radiance [R,3] (scene.dtype) of the samples (frame[i], lane[i]) of a
    width x height image under the camera vectors cam: [16], one for every
    sample, or [R,16], one each."""
    dev, dt = scene.device, scene.dtype
    st = scene.settings
    frame = torch.as_tensor(frame, device=dev, dtype=torch.int64)
    lane = torch.as_tensor(lane, device=dev, dtype=torch.int64)
    R = lane.shape[0]
    cam = torch.as_tensor(cam, dtype=torch.float32, device=dev).to(dt)
    cam = cam.expand(R, 16) if cam.dim() == 1 else cam
    rot = cam[:, 15]
    # the pixel of each lane: invert lane_of_pixel over the image
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    inv = torch.empty(width * height, dtype=torch.int64, device=dev)
    inv[lane_of_pixel(xs.reshape(-1), ys.reshape(-1), width, height)] = \
        torch.arange(width * height, device=dev)
    pix = inv[lane]
    px, py = (pix % width).to(dt), (pix // width).to(dt)
    stream = Stream(rng_seed(frame, lane), dt)
    o, d = camera_rays(cam, stream, px, py)
    mask = torch.ones((R, 3), dtype=dt, device=dev)
    L = torch.zeros((R, 3), dtype=dt, device=dev)
    pdf_prev = torch.full((R,), -1.0, dtype=dt, device=dev)
    lbn = torch.full((R,), st["bounce_min"], dtype=torch.int64, device=dev)
    if scene.has_media:
        medium = torch.full((R,), -1, dtype=torch.int64, device=dev)
    idx = torch.arange(R, device=dev)          # the live paths, ascending
    bounce = 0
    while idx.numel() and bounce < st["bounce_max"]:
        bounce += 1
        o_, d_, m_ = o[idx], d[idx], mask[idx]
        tri, t = scene.tree.trace(o_, d_, RAY_MIN, RAY_MAX)
        miss = tri < 0
        scattered = None
        if scene.has_media:
            s = stream.sub(idx)
            o_, d_, m_, scat = medium_step(scene, s.draw(4), o_, d_, m_, t,
                                           medium[idx])
            stream.put(idx, s)
            miss = miss & ~scat
            scattered = _scattered(scene, stream, idx[scat], lbn, bounce)
            o[idx[scat]], d[idx[scat]], mask[idx[scat]] = \
                o_[scat], d_[scat], m_[scat]
        if bool(miss.any()):
            mi = idx[miss]
            L[mi] += m_[miss] * scene.env_miss(d_[miss], pdf_prev[mi], rot[mi])
        hitl = ~miss
        if scattered is not None:
            hitl = hitl & ~scat
        idx, o_, d_, m_, tri, t = (x[hitl] for x in (idx, o_, d_, m_, tri, t))
        if not idx.numel():
            if scattered is None:
                break
            idx = scattered
            continue
        s = stream.sub(idx)
        hp = o_ + d_ * t[:, None]
        uv, sn, gn, mid = scene.surface(tri, hp)
        mat = scene.material(mid)
        n = normalize(torch.where(mat["useNormal"][:, None], sn, gn))
        objcol = mat["objcol"]
        if scene.tex is not None:
            objcol = torch.where(mat["useTexture"][:, None], scene.texture(uv),
                                 objcol)
        into = dot(n, d_) < 0.0
        nl = torch.where(into[:, None], n, -n)
        rad = m_ * mat["emit"]
        (nd, mul, off, term, binc, glass_r, ss_r, ss_n) = bsdf_draw(
            s.draw(6), d_, n, nl, into, mat, objcol)
        no = hp + nl * (off * RAY_MIN)[:, None]
        if scene.has_sss:
            ssl = torch.nonzero(ss_r).reshape(-1)
            sub = s.sub(ssl)
            if ssl.numel():
                b_o, b_d, b_mul, b_ok = bssrdf_scatter(
                    scene, sub, hp[ssl], ss_n[ssl],
                    {k: v[ssl] for k, v in mat.items()}, mid[ssl],
                    objcol[ssl])
                use = torch.zeros_like(ss_r)
                use[ssl] = b_ok
                ok_rows = ssl[b_ok]
                no[ok_rows] = b_o[b_ok]
                nd[ok_rows] = b_d[b_ok]
                mul[ok_rows] = b_mul[b_ok]
            # every surface vertex draws the loop's numbers
            rest = torch.nonzero(~ss_r).reshape(-1)
            other = s.sub(rest)
            other.draw(4 * st["bssrdf_probes"] + 2)
            s.put(ssl, sub)
            s.put(rest, other)
        m_prev = m_
        m_ = m_ * mul
        e1, e2 = s.draw(2)
        d_env, pdf_env, L_env = scene.env_sample(e1, e2, rot[idx])
        cos_e = dot(d_env, nl)
        diff = mat["refltype"] == MAT["MAT_DIFF"]
        cand = diff & (cos_e > 0.0) & (pdf_env > 1e-12)
        if bool(cand.any()):
            ci = torch.nonzero(cand).reshape(-1)
            s_tri, _ = scene.tree.trace(no[ci], d_env[ci], RAY_MIN, RAY_MAX,
                                        anyhit=True)
            lit = torch.zeros_like(cand)
            lit[ci] = s_tri < 0
            f = mat["kd"][:, None] * objcol * INV_PI
            pdf_b = torch.clamp_min(cos_e, 0.0) * INV_PI
            w = pdf_env * pdf_env / torch.clamp_min(
                pdf_env * pdf_env + pdf_b * pdf_b, 1e-20)
            scale = cos_e / torch.clamp_min(pdf_env, 1e-12) * w
            rad = rad + torch.where(lit[:, None],
                                    m_prev * f * scale[:, None] * L_env,
                                    torch.zeros_like(rad))
        cos_n = torch.clamp_min(dot(nd, nl), 0.0)
        pdf_prev[idx] = torch.where(diff, cos_n * INV_PI,
                                    torch.full_like(cos_n, -1.0))
        L[idx] += rad
        lb = torch.clamp_max(lbn[idx] + binc, st["bounce_max"])
        lbn[idx] = lb
        stream.put(idx, s)
        o[idx], d[idx], mask[idx] = no, nd, m_
        if scene.has_media:
            # in on a refraction into a glass surface with a medium, out on
            # any refraction out
            med = medium[idx]
            med = torch.where(glass_r & into & scene.media["has"][mid], mid,
                              med)
            medium[idx] = torch.where(glass_r & ~into, -1, med)
        go = ~term & (bounce < lb)
        idx = idx[go]
        if scattered is not None:
            idx = torch.sort(torch.cat([idx, scattered])).values
    return L


def _scattered(scene, stream, si, lbn, bounce):
    """The paths si that scattered in their medium this bounce: they draw
    the surface's numbers (the BSDF's, the BSSRDF loop's in a scene with a
    subsurface material, the env NEE's) unused, and their bounce budget
    grows by one, to at most bounce_max. Returns those of them that go
    on."""
    st = scene.settings
    sub = stream.sub(si)
    sub.draw(6 + (4 * st["bssrdf_probes"] + 2 if scene.has_sss else 0) + 2)
    stream.put(si, sub)
    lb = torch.clamp_max(lbn[si] + 1, st["bounce_max"])
    lbn[si] = lb
    return si[bounce < lb]
