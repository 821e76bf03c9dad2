"""The port's regen render path against the JAX package and its goldens.

Images are held to bench.py's gate statistics (bench.py:233-247): median
|diff| < 1e-4, mean within 1%, RMSE < 0.1. Both packages draw the same
random numbers for every sample, so the images differ only by float
rounding of transcendentals and the order of additions.
"""
import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
from tpu_pathtracer.tracer.regen import make_regen_integrator as j_regen
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.scene.config import MatDesc, MAT_DIFF
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.regen import make_regen_integrator
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _gate(img, want):
    d = np.abs(img - want)
    assert np.all(np.isfinite(img))
    assert float(np.median(d)) < 1e-4, np.median(d)
    assert abs(img.mean() / max(want.mean(), 1e-9) - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


@functools.lru_cache(maxsize=1)
def _default():
    return tdemo.testobj_scene(cache_dir=None)


def _renderer(w, settings=None, mats=None):
    fb, m, envmap, texture = _default()
    return Renderer(fb, mats or m, envmap=envmap, texture=texture, width=w,
                    height=w, settings=settings, device="cpu")


def test_regen_matches_jax_regen_default_scene():
    W = 32
    fb, mats, envmap, texture = _default()
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=W,
                   height=W)
    rc = tdemo.default_camera(W, W).build_render_camera()
    fn = jax.jit(j_regen(jr.settings, W, W, with_stats=True),
                 static_argnames=("n_frames",))
    jacc, jwaves, jrays = fn(jr.scene, jnp.asarray(rc.as_array()),
                             jnp.uint32(1), jnp.uint32(0), jr.zeros_accum(),
                             n_frames=2)
    tr = _renderer(W)
    tacc, twaves, trays = tr.render_frames(tr.zeros_accum(), rc, 1, 2,
                                           with_stats=True)
    _gate(tr.accum_to_buffer(tacc), jr.accum_to_buffer(np.asarray(jacc)))
    # the same path segments were traced
    assert abs(trays / float(jrays) - 1.0) < 1e-3
    assert int(twaves) > 0


def test_c1_lambertian_matches_golden():
    mats1 = [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_DIFF, objcol=(0.9, 0.3, 0.25)),
             MatDesc(refltype=MAT_DIFF, objcol=(0.3, 0.9, 0.35)),
             MatDesc(refltype=MAT_DIFF, objcol=(0.3, 0.35, 0.9))]
    s = RenderSettings(bounce_min=2, bounce_max=6, use_envmap=True,
                       use_texture=True)
    r = _renderer(96, settings=s, mats=mats1)
    cam = tdemo.default_camera(96, 96)
    cam.aperture_radius = 0.0
    cam.focal_distance = 4.0
    acc = r.render_frames(r.zeros_accum(), cam.build_render_camera(), 1, 12)
    img = r.accum_to_buffer(acc.numpy() / 12)
    want = np.load(os.path.join(GOLDEN_DIR, "c1_lambertian.npz"))["img"]
    _gate(img, want)


@functools.lru_cache(maxsize=None)
def _render_mode(mode, pool=0, traversal="auto"):
    W = 32
    base = _renderer(W).settings
    s = dataclasses.replace(base, scatter_mode=mode, pool_lanes=pool,
                            traversal=traversal)
    r = _renderer(W, settings=s)
    rc = tdemo.default_camera(W, W).build_render_camera()
    acc, waves, rays = r.render_frames(r.zeros_accum(), rc, 1, 2,
                                       with_stats=True)
    return acc.numpy(), waves, rays


@pytest.mark.parametrize("mode", ["deferred", "wave"])
def test_scatter_modes_give_the_same_image(mode):
    ring = _render_mode("ring")
    other = _render_mode(mode)
    np.testing.assert_allclose(other[0], ring[0], rtol=1e-5, atol=1e-6)
    assert other[1:] == ring[1:]


def test_narrow_pool_gives_the_same_image():
    full = _render_mode("ring", pool=0)
    narrow = _render_mode("ring", pool=256)
    np.testing.assert_allclose(narrow[0], full[0], rtol=1e-5, atol=1e-6)
    assert narrow[2] == full[2]          # same path segments traced
    assert narrow[1] > full[1]           # narrower pool -> more waves


def test_wavefront_traversal_setting_gives_the_same_image():
    a = _render_mode("ring")
    b = _render_mode("ring", traversal="wavefront")
    np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("kw,exc", [
    (dict(bounce_max=128), ValueError),
    (dict(regen_permute="gathr"), ValueError),
    (dict(regen_permute="sort", regen_order="inplace"), ValueError),
    (dict(scatter_mode="rings"), ValueError),
    (dict(regen_order="inplace"), NotImplementedError),
    (dict(regen_permute="sort"), NotImplementedError),
    (dict(use_distant_light=True), NotImplementedError),
    (dict(dup_stage="shade"), NotImplementedError),
])
def test_regen_settings_raise(kw, exc):
    with pytest.raises(exc):
        make_regen_integrator(RenderSettings(**kw), 8, 8)
