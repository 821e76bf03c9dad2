"""Inputs of the BSSRDF probe loop (`tpu_pathtracer_torch/tracer/
bssrdf_shade.py: bssrdf_scatter`) as a regen wave hands them over, recorded
from the organic sss composition (`scene.demo.large_organic_scene`): shared
by tests/test_torch_bssrdf_kernel.py, tests/test_torch_cuda.py and
chip_smoke.py phase 15 (which puts this directory on sys.path). It imports
no jax.
"""
import dataclasses

import torch

from tpu_pathtracer_torch.scene import demo
from tpu_pathtracer_torch.scene.config import MAT_SUBSURFACE
from tpu_pathtracer_torch.tracer import bssrdf_shade, device_loop, wavefront
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings

# the names of bssrdf_scatter's arguments after (scene, settings)
ARGS = ("rng", "hitpoint", "normal2", "mat", "mat_id", "objcol", "lanes")


def organic_renderer(device, W, H=None, textured=False, probes=3,
                     n_lat=40, n_lon=80, **settings):
    """A Renderer of the organic sss composition (a blob of n_lat x n_lon
    in subsurface skin over a textured ground), W x H lanes. textured: the
    skin reads the checker texture too (its objcol the texture's)."""
    H = W if H is None else H
    fb, mats, envmap, texture = demo.large_organic_scene(
        cache_dir=None, variant="sss", n_lat=n_lat, n_lon=n_lon)
    if textured:
        mats = [dataclasses.replace(m, useTexture=True)
                if m.refltype == MAT_SUBSURFACE else m for m in mats]
    s = RenderSettings(has_bssrdf=True, bssrdf_probes=probes,
                       use_distant_light=True, **settings)
    return Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                    height=H, settings=s, device=device)


def camera(W, H=None):
    H = W if H is None else H
    return demo.default_camera(W, H).build_render_camera()


def wave_inputs(r, wave=1):
    """{name: tensor} of bssrdf_scatter's arguments in the `wave`-th wave
    (1: the camera rays' hits) of r's first frame, run eagerly, plus
    "shade_out", the surface draw's (new_orig, next_dir, mask_mul); every
    tensor a copy."""
    got = {}
    saved = wavefront.bssrdf_scatter
    seen = [0]

    def record(scene, settings, *args, shade_out=None):
        seen[0] += 1
        if seen[0] == wave:
            for k, v in zip(ARGS, args):
                got[k] = {c: t.clone() for c, t in v.items()} \
                    if k == "mat" else v.clone()
            got["shade_out"] = tuple(t.clone() for t in shade_out)
        return saved(scene, settings, *args, shade_out=shade_out)
    wavefront.bssrdf_scatter = record
    try:
        with device_loop.no_graphs():
            r.render_frames(r.zeros_accum(), camera(r.width, r.height), 1, 1)
    finally:
        wavefront.bssrdf_scatter = saved
    return got


def spread_lanes(inputs, N, offset=0):
    """The inputs of N lanes spread evenly over the wave's pool (lane
    (k * P) // N + offset for k < N: the lane order follows the image's
    swizzle, so a prefix would hold one corner of the image), each a
    contiguous copy."""
    P = inputs["lanes"].shape[0]
    idx = torch.clamp((torch.arange(N) * P) // max(N, 1) + offset, max=P - 1)
    idx = idx.to(inputs["lanes"].device)

    def cut(v):
        return v[idx].contiguous()
    return {k: ({c: cut(t) for c, t in v.items()} if k == "mat"
                else tuple(cut(t) for t in v) if k == "shade_out"
                else cut(v)) for k, v in inputs.items()}


def run(scene, settings, inputs, plain):
    """bssrdf_scatter (plain: bssrdf_scatter_plain and the merge) on a copy
    of inputs; returns its seven outputs."""
    args = [inputs[k] for k in ARGS]
    shade_out = tuple(t.clone() for t in inputs["shade_out"])
    if not plain:
        return bssrdf_shade.bssrdf_scatter(scene, settings, *args,
                                           shade_out=shade_out)
    out = bssrdf_shade.bssrdf_scatter_plain(scene, settings, *args)
    ok = out[4][:, None]
    return (out[0],) + tuple(torch.where(ok, b, s) for b, s in zip(
        out[1:4], shade_out)) + out[4:]


NAMES = ("rng", "new_orig", "next_dir", "mask_mul", "ok", "is_mul",
         "next_normal")


def differing_lanes(got, want, lanes):
    """{output: lanes whose bits differ}: rng, the three merged columns and
    ok on every lane, is_mul and next_normal on `lanes` (elsewhere they
    hold no value); a NaN equals a NaN of the same bits."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        d = g != w
        if d.dim() == 2:
            d = d.any(-1)
        if name in ("is_mul", "next_normal"):
            d = d & lanes
        out[name] = int(d.sum())
    return out
