"""Texture loading and texture / environment sampling (port of
scene/texture.py).

`load_texture` and `make_quad_texture` run on the host in numpy and give
the same arrays as the JAX package. The samplers index the rows with integer math that keeps
every index in range: `torch.remainder` for wrap (jnp.mod's sign rule,
never fmod) and a clamp otherwise, because an out-of-range index on a CUDA
tensor is a device-side assert where jnp.take would clamp.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.image import srgb_to_linear
from ..core.vecmath import TWO_PI, PI


def load_texture(path) -> np.ndarray:
    """Load an LDR image file -> linear float32 [H,W,3] (sRGB decoded, as
    the reference binds its colour texture). Needs PIL, imported here
    only."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return srgb_to_linear(img).astype(np.float32)


def _bilinear(tex, u, v, wrap_u, wrap_v):
    """tex: [H,W,3] tensor; u, v in normalized coords; CUDA-convention
    linear filter (texel centres at +0.5), four texel gathers."""
    H, W = tex.shape[0], tex.shape[1]
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    x1 = x0 + 1
    y1 = y0 + 1
    if wrap_u:
        x0, x1 = torch.remainder(x0, W), torch.remainder(x1, W)
    else:
        x0, x1 = torch.clamp(x0, 0, W - 1), torch.clamp(x1, 0, W - 1)
    if wrap_v:
        y0, y1 = torch.remainder(y0, H), torch.remainder(y1, H)
    else:
        y0, y1 = torch.clamp(y0, 0, H - 1), torch.clamp(y1, 0, H - 1)
    flat = tex.reshape(-1, tex.shape[-1])
    c00 = flat[(y0 * W + x0).long()]
    c01 = flat[(y0 * W + x1).long()]
    c10 = flat[(y1 * W + x0).long()]
    c11 = flat[(y1 * W + x1).long()]
    return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
            + c10 * (1 - fx) * fy + c11 * fx * fy)


def sample_texture(tex, u, v):
    """Colour texture fetch: wrap/wrap bilinear."""
    return _bilinear(tex, torch.remainder(u, 1.0), torch.remainder(v, 1.0),
                     wrap_u=True, wrap_v=True)


def make_quad_texture(tex, wrap_u, wrap_v):
    """Per texel its 2x2 bilinear footprint [t(y,x), t(y,x+1), t(y+1,x),
    t(y+1,x+1)] with wrap/clamp applied at build time: (H*W, 12) f32."""
    t = np.asarray(tex, np.float32)
    H, W, _ = t.shape
    if wrap_u:
        xn = np.roll(t, -1, axis=1)
    else:
        xn = np.concatenate([t[:, 1:], t[:, -1:]], axis=1)
    if wrap_v:
        yn = np.roll(t, -1, axis=0)
        yxn = np.roll(xn, -1, axis=0)
    else:
        yn = np.concatenate([t[1:], t[-1:]], axis=0)
        yxn = np.concatenate([xn[1:], xn[-1:]], axis=0)
    quad = np.concatenate([t, xn, yn, yxn], axis=-1)  # (H,W,12)
    return quad.reshape(H * W, 12)


def _bilinear_rows(q, fx, fy):
    """Bilinear blend of the four texels of quad rows q [..., >=12]."""
    return (q[..., 0:3] * (1 - fx) * (1 - fy) + q[..., 3:6] * fx * (1 - fy)
            + q[..., 6:9] * (1 - fx) * fy + q[..., 9:12] * fx * fy)


def _bilinear_quad(quad, H, W, u, v, wrap_u, wrap_v):
    """Bilinear sample from a quad texture (single row gather)."""
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int32)
    y0 = y0.to(torch.int32)
    x0 = torch.remainder(x0, W) if wrap_u else torch.clamp(x0, 0, W - 1)
    y0 = torch.remainder(y0, H) if wrap_v else torch.clamp(y0, 0, H - 1)
    q = quad[(y0 * W + x0).long()]
    return _bilinear_rows(q, fx, fy)


def _uv_from_dir(raydir, rotation):
    """envLight lat-long mapping (src/renderkernel.cu:422-437)."""
    x = raydir[..., 0]
    y = raydir[..., 1]
    z = raydir[..., 2]
    longlat_x = torch.atan2(x, z)
    longlat_x = torch.where(longlat_x < 0.0, longlat_x + TWO_PI, longlat_x)
    u = torch.remainder(longlat_x / TWO_PI + rotation, 1.0)
    v = torch.arccos(torch.clamp(y, -1.0, 1.0)) / PI
    return u, v


def _corner_pdf(q, u, v, x0i, y0i, H, W):
    """pdf_uv of texel (floor(u*W), floor(v*H)): one of the four corner
    pdfs in cols 12:16 of the quad row q, selected, not interpolated."""
    sx = torch.clamp((u * W).to(torch.int32) - x0i, 0, 1)
    sy = torch.clamp((v * H).to(torch.int32) - y0i, 0, 1)
    return torch.where(sy == 0, torch.where(sx == 0, q[..., 12], q[..., 13]),
                       torch.where(sx == 0, q[..., 14], q[..., 15]))


def sample_envmap_quad_pdf(quad16, H, W, raydir, rotation):
    """Environment radiance + sampler pdf from ONE row gather: returns
    (L [...,3] bilinear radiance, p_uv [...] the exact pdf_uv of the texel
    under the direction)."""
    u, v = _uv_from_dir(raydir, rotation)
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int32), 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, H - 1)
    q = quad16[(y0i * W + x0i).long()]
    return (_bilinear_rows(q, fx, fy),
            _corner_pdf(q, u, v, x0i, y0i, H, W))


def sample_texture_quad(quad, H, W, u, v):
    """Colour texture fetch via quad rows: wrap/wrap bilinear."""
    return _bilinear_quad(quad, H, W, torch.remainder(u, 1.0),
                          torch.remainder(v, 1.0), wrap_u=True, wrap_v=True)


def sample_envmap_quad(quad, H, W, raydir, rotation):
    """Environment lookup via quad rows (clamp addressing)."""
    u, v = _uv_from_dir(raydir, rotation)
    return _bilinear_quad(quad, H, W, u, v, wrap_u=False, wrap_v=False)


def sample_envmap(env, raydir, rotation):
    """HDR environment lookup (envLight, src/renderkernel.cu:422-437):
    lat-long mapping, clamp addressing, bilinear filter."""
    u, v = _uv_from_dir(raydir, rotation)
    return _bilinear(env, u, v, wrap_u=False, wrap_v=False)
