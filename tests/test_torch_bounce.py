"""The port's classic bounce integrator against the JAX package's, and
against the port's own regen integrator.

Port bounce vs JAX bounce: bench.py's gate statistics (median |diff| <
1e-4, mean within 1%, RMSE < 0.1); both packages draw the same random
numbers for every sample, so the images differ only by float rounding of
transcendentals. Port regen vs port bounce: the tolerances of
tests/test_regen.py:16 (mean |d| < 1e-5, max < 5e-3, means within 1e-4).
The furnace, emissive and null-material cases are those of
tests/test_integrator.py:36-107, with their own physical tolerances.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
from tpu_pathtracer_torch.scene import demo as tdemo, procedural
from tpu_pathtracer_torch.scene.camera import InteractiveCamera
from tpu_pathtracer_torch.scene.config import (
    MatDesc, MAT_DIFF, MAT_REFL, MAT_GLASS, MAT_EMIT, MAT_NULL, MAT_FRESNEL)
from tpu_pathtracer_torch.accel import flatten_mesh_bvh
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))


def _gate(img, want):
    d = np.abs(img - want)
    assert np.all(np.isfinite(img))
    assert float(np.median(d)) < 1e-4, np.median(d)
    assert abs(img.mean() / max(want.mean(), 1e-9) - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


@functools.lru_cache(maxsize=1)
def _default():
    return tdemo.testobj_scene(cache_dir=None)


def test_bounce_matches_jax_bounce_default_scene():
    W = 32
    fb, mats, envmap, texture = _default()
    rc = tdemo.default_camera(W, W).build_render_camera()
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=W,
                   height=W)
    jr2 = JRenderer(fb, mats, envmap=envmap, texture=texture, width=W,
                    height=W, base_scene=jr.scene,
                    settings=dataclasses.replace(jr.settings,
                                                 integrator="bounce"))
    jacc = np.asarray(jr2.render_frames(jr2.zeros_accum(), rc, 1, 2))
    tr = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                  height=W, device="cpu")
    tr.settings = dataclasses.replace(tr.settings, integrator="bounce")
    tacc, bounces, rays = tr.render_frames(tr.zeros_accum(), rc, 1, 2,
                                           with_stats=True)
    _gate(tr.accum_to_buffer(tacc.numpy()), jr.accum_to_buffer(jacc))
    assert 2 <= bounces <= 2 * 16
    assert rays >= W * W * 2


def test_regen_matches_bounce_integrator():
    """tests/test_regen.py:16 in the port: counter-based RNG gives both
    integrators the same sample values."""
    fb = flatten_mesh_bvh(procedural.make_test_scene())
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=True),
            MatDesc(refltype=MAT_FRESNEL, alphax=0.1, alphay=0.1,
                    kd=5.0, ks=1.0),
            MatDesc(refltype=MAT_GLASS),
            MatDesc(refltype=MAT_REFL)]
    env = procedural.make_sky_envmap(128, 64)
    tex = procedural.make_checker_texture(64)
    W = 48
    rc = tdemo.default_camera(W, W).build_render_camera()
    s = RenderSettings(bounce_min=2, bounce_max=16, use_envmap=True,
                       use_texture=True, integrator="bounce")
    out = {}
    for mode in ("bounce", "regen"):
        r = Renderer(fb, mats, envmap=env, texture=tex, width=W, height=W,
                     settings=dataclasses.replace(s, integrator=mode),
                     device="cpu")
        out[mode] = r.render_frames(r.zeros_accum(), rc, 1, 3).numpy()
    d = np.abs(out["bounce"] - out["regen"])
    assert d.mean() < 1e-5
    assert d.max() < 5e-3
    assert out["regen"].mean() == pytest.approx(out["bounce"].mean(),
                                                rel=1e-4)


def _camera(W, pitch=0.0, radius=4.0, center=(0.0, 0.0, 0.0), fovx=60):
    cam = InteractiveCamera()
    cam.center_position = center
    cam.radius = radius
    cam.pitch = pitch
    cam.set_resolution(W, W)
    cam.set_fovx(fovx)
    return cam.build_render_camera()


@functools.lru_cache(maxsize=1)
def _sphere():
    return flatten_mesh_bvh(
        procedural.make_uv_sphere((0, 0.0, 0), 1.0, 0, n_lat=16, n_lon=24))


def _bounce_render(mats, W, spp, env_const, radius=4.0, **kw):
    s = RenderSettings(use_envmap=False, use_texture=False,
                       integrator="bounce", **kw)
    r = Renderer(_sphere(), mats, width=W, height=W, env_const=env_const,
                 settings=s, device="cpu")
    acc = r.render_frames(r.zeros_accum(), _camera(W, radius=radius), 1,
                          spp)
    return acc.numpy() / spp


def test_white_furnace_diffuse():
    """A white lambertian sphere in a unit environment renders to 1."""
    img = _bounce_render([MatDesc(refltype=MAT_DIFF, kd=1.0)], 32, 16,
                         (1.0, 1.0, 1.0), bounce_min=16, bounce_max=16)
    assert abs(img.mean() - 1.0) < 0.015
    assert np.all(np.isfinite(img))


def test_white_furnace_mirror():
    img = _bounce_render([MatDesc(refltype=MAT_REFL, alphax=0.0, ks=1.0)],
                         32, 4, (1.0, 1.0, 1.0), bounce_min=2, bounce_max=16)
    np.testing.assert_allclose(img, 1.0, atol=1e-3)


def test_glass_furnace_near_unity():
    img = _bounce_render([MatDesc(refltype=MAT_GLASS, etaT=1.5)], 32, 8,
                         (1.0, 1.0, 1.0), bounce_min=4, bounce_max=16)
    assert 0.93 < img.mean() < 1.02


def test_emissive_surface():
    W = 32
    img = _bounce_render([MatDesc(refltype=MAT_EMIT, emit=(2.0, 1.0, 0.5))],
                         W, 2, (0.0, 0.0, 0.0), radius=3.0)
    s = RenderSettings(use_envmap=False, use_texture=False)
    buf = Renderer(_sphere(), [MatDesc(refltype=MAT_EMIT)], width=W,
                   height=W, settings=s, device="cpu").accum_to_buffer(img)
    np.testing.assert_allclose(buf[W // 2, W // 2], (2.0, 1.0, 0.5),
                               atol=1e-4)
    assert buf[0, 0].max() < 1e-6


def test_null_material_passthrough():
    img = _bounce_render([MatDesc(refltype=MAT_NULL)], 32, 2,
                         (0.3, 0.5, 0.7), radius=3.0, bounce_min=16,
                         bounce_max=16)
    err = np.abs(img - np.array([0.3, 0.5, 0.7])).max(-1)
    assert (err < 1e-3).mean() > 0.99
    assert abs(img.mean(0)[0] - 0.3) < 2e-3
