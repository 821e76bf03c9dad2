"""Vector math over batched [..., 3] tensors (port of core/vecmath.py).

Dot products are written out component by component, in the order
((x + y) + z), so that they add in the same order on every device.
"""
from __future__ import annotations

import torch

PI = 3.1415926535897932384626433832795
TWO_PI = 2.0 * PI
FOUR_PI = 4.0 * PI
EIGHT_PI = 8.0 * PI
INV_PI = 1.0 / PI
INV_4PI = 1.0 / FOUR_PI
PI_OVER_2 = PI / 2.0
PI_OVER_4 = PI / 4.0
SQRT_ONE_THIRD = 0.5773502691896257645091487805019574556476

# Ray epsilons (reference src/renderkernel.cu:45-47)
RAY_MIN = 1e-4
RAY_MAX = 1e20


def dot(a, b):
    """Batched dot product over the last axis, keepdims dropped."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dotk(a, b):
    """Batched dot product, keepdims=True."""
    return dot(a, b)[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a, eps=1e-20):
    return a * torch.reciprocal(torch.sqrt(torch.clamp_min(dotk(a, a), eps)))


def reflect(d, n):
    """Mirror reflect direction d about normal n."""
    return d - n * 2.0 * dotk(n, d)


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def channel_select(c, ch):
    """Per-lane RGB channel pick c[i, ch[i]], kept a select like the
    reference (vecmath.py:60)."""
    return torch.where(ch == 0, c[..., 0],
                       torch.where(ch == 1, c[..., 1], c[..., 2]))


def make_basis(n):
    """Orthonormal basis (u, v) around unit normal n (reference
    `localizeSample`, src/reflection.cuh:34-46)."""
    ax = torch.abs(n[..., 0:1])
    ay = torch.abs(n[..., 1:2])
    eye = torch.eye(3, dtype=n.dtype, device=n.device)
    w = torch.where(ax < SQRT_ONE_THIRD, eye[0],
                    torch.where(ay < SQRT_ONE_THIRD, eye[1], eye[2]))
    u = normalize(cross(n, w))
    v = cross(n, u)
    return u, v


def concentric_sample_disk(u1, u2):
    """PBRT concentric disk mapping (reference src/reflection.cuh:50-67)."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    safe_ox = torch.where(ox == 0.0, 1.0, ox)
    safe_oy = torch.where(oy == 0.0, 1.0, oy)
    theta = torch.where(use_x, PI_OVER_4 * (oy / safe_ox),
                        PI_OVER_2 - PI_OVER_4 * (ox / safe_oy))
    degenerate = (ox == 0.0) & (oy == 0.0)
    dx = torch.where(degenerate, 0.0, r * torch.cos(theta))
    dy = torch.where(degenerate, 0.0, r * torch.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1, u2, n):
    """Cosine-weighted direction about n (reference `lambertianReflection`,
    src/reflection.cuh:75-83)."""
    dx, dy = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    u, v = make_basis(n)
    d = dx[..., None] * u + dy[..., None] * v + z[..., None] * n
    return normalize(d)


def barycentric(p, a, b, c):
    """Barycentric coordinates of p in triangle (a, b, c); returns (u, v, w)
    with p = u*a + v*b + w*c (reference src/mymath.h:17-31)."""
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = dot(v0, v0)
    d01 = dot(v0, v1)
    d11 = dot(v1, v1)
    d20 = dot(v2, v0)
    d21 = dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return u, v, w
