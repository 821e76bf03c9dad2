"""Environment-map importance sampling with MIS (port of tracer/envsample.py).

The distribution is built on the host in numpy with the same alias
builder as the JAX package (`tpu_pathtracer.accel.native_build`), so the
packed alias table is identical bit for bit. Sampling is one row gather
per lane. Integer columns of the packed row are bit patterns stored in
f32 slots: they are reinterpreted with `.view(torch.int32)`, never
converted.
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_pathtracer.accel.native_build import alias_build_native

from ..core.vecmath import PI, TWO_PI
from ..scene.texture import _uv_from_dir


def _alias_table(p):
    """Vose alias table for weights p (mean 1): (prob, alias). The native
    builder when it is available; otherwise the JAX package's reference
    loop, which gives the same table."""
    native = alias_build_native(p)
    if native is not None:
        return native
    k = p.shape[0]
    prob = np.ones(k)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if p[i] < 1.0]
    large = [i for i in range(k) if p[i] >= 1.0]
    p = p.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)
    return prob, alias


def build_env_distribution(env, topk=16384):
    """env: [H,W,3] float. Returns {"env_alias": (k,12) f32 packed rows,
    "env_pdf_uv": (H,W) f32}.

    NEE draws are restricted to the `topk` brightest texels (by
    sin-weighted luminance), with the pdf renormalized over that subset
    and 0 elsewhere; unbiased under MIS. topk <= 0 disables it."""
    env = np.asarray(env, np.float32)
    H, W, _ = env.shape
    lum = (0.2126 * env[..., 0] + 0.7152 * env[..., 1]
           + 0.0722 * env[..., 2]).astype(np.float64)
    theta = (np.arange(H) + 0.5) / H * np.pi
    weighted = (lum * np.sin(theta)[:, None] + 1e-12).reshape(-1)
    n = H * W
    if topk and 0 < topk < n:
        sel = np.argpartition(weighted, n - topk)[n - topk:]
        sel.sort()
    else:
        sel = np.arange(n)
    k = sel.shape[0]
    w_sel = weighted[sel]
    total = w_sel.sum()
    pdf_uv = np.zeros(n)
    pdf_uv[sel] = w_sel * (H * W) / total
    prob, alias = _alias_table((w_sel / total) * k)
    # packed row: [prob, alias(bits), pdf_uv[self], pdf_uv[alias],
    #              rgb_self(3), rgb_alias(3), texel_self(bits),
    #              texel_alias(bits)]
    packed = np.zeros((k, 12), np.float32)
    packed[:, 0] = prob
    packed[:, 1] = alias.astype(np.int32).view(np.float32)
    packed[:, 2] = pdf_uv[sel]
    packed[:, 3] = pdf_uv[sel[alias]]
    rgb = env.reshape(-1, 3)
    packed[:, 4:7] = rgb[sel]
    packed[:, 7:10] = rgb[sel[alias]]
    packed[:, 10] = sel.astype(np.int32).view(np.float32)
    packed[:, 11] = sel[alias].astype(np.int32).view(np.float32)
    return {
        "env_alias": packed,
        "env_pdf_uv": pdf_uv.reshape(H, W).astype(np.float32),
    }


def _dir_from_uv(u, v, rotation):
    """Inverse of the envLight lat-long mapping."""
    phi = (u - rotation) * TWO_PI
    theta = v * PI
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.sin(phi), torch.cos(theta),
                        sin_t * torch.cos(phi)], dim=-1)


def env_pdf_of_dir(scene, raydir, rotation):
    """Solid-angle pdf of the env sampler for directions [N,3]."""
    pdf_uv = scene["env_pdf_uv"]
    H, W = pdf_uv.shape
    y = raydir[:, 1]
    u, v = _uv_from_dir(raydir, rotation)
    xi = torch.clamp((u * W).to(torch.int32), 0, W - 1)
    yi = torch.clamp((v * H).to(torch.int32), 0, H - 1)
    p_uv = pdf_uv.reshape(-1)[(yi * W + xi).long()]
    sin_t = torch.sqrt(torch.clamp_min(1.0 - y * y, 1e-8))
    return p_uv / (2.0 * PI * PI * sin_t)


def sample_env(scene, u1, u2, rotation):
    """Draw directions through the alias table: one row gather per lane.
    Returns (dir [N,3], pdf [N], radiance [N,3])."""
    packed = scene["env_alias"]       # [k, 12]
    H, W = scene["env_pdf_uv"].shape
    k = packed.shape[0]
    bin0 = torch.clamp((u1 * k).to(torch.int32), 0, k - 1)
    row = packed[bin0.long()]
    take_alias = u2 >= row[:, 0]
    texels = row[:, 10:12].contiguous().view(torch.int32)
    texel = torch.where(take_alias, texels[:, 1], texels[:, 0])
    pdf_uv = torch.where(take_alias, row[:, 3], row[:, 2])
    L = torch.where(take_alias[:, None], row[:, 7:10], row[:, 4:7])
    rowi = torch.div(texel, W, rounding_mode="floor")
    coli = torch.remainder(texel, W)
    u = (coli.to(torch.float32) + 0.5) / W
    v = (rowi.to(torch.float32) + 0.5) / H
    d = _dir_from_uv(u, v, rotation)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - d[:, 1] ** 2, 1e-8))
    return d, pdf_uv / (2.0 * PI * PI * sin_t), L


def power_heuristic(pf, pg):
    pf2 = pf * pf
    return pf2 / torch.clamp_min(pf2 + pg * pg, 1e-20)
