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
from torch_settings import JAX_ONLY, port_fields

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
def _render_mode(mode, pool=0, traversal="auto", extra=()):
    W = 32
    base = _renderer(W).settings
    s = dataclasses.replace(base, scatter_mode=mode, pool_lanes=pool,
                            traversal=traversal, **dict(extra))
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
    (dict(scatter_mode="rings"), ValueError),
    (dict(regen_order="in_place"), ValueError),
    # the JAX package's fields that the port leaves out (JAX_ONLY)
    (dict(dup_stage="shade"), TypeError),
    (dict(regen_permute="sort"), TypeError),
])
def test_regen_settings_raise(kw, exc):
    with pytest.raises(exc):
        make_regen_integrator(RenderSettings(**kw), 8, 8)


def test_settings_are_the_jax_fields_less_the_jax_only_ones():
    """The port's RenderSettings fields are the JAX package's, in the same
    order, less exactly JAX_ONLY, and their defaults are equal."""
    from tpu_pathtracer.tracer.wavefront import RenderSettings as JSettings
    jax_names = [f.name for f in dataclasses.fields(JSettings)]
    assert set(JAX_ONLY) <= set(jax_names)
    assert [f.name for f in dataclasses.fields(RenderSettings)] == [
        k for k in jax_names if k not in JAX_ONLY]
    assert dataclasses.asdict(RenderSettings()) == port_fields(JSettings())


@pytest.mark.parametrize("kw", [dict(regen_order="inplace")],
                         ids=["inplace"])
def test_regen_settings_render(kw):
    """The inplace order, which raised before its slice, renders the
    default order's image (same samples, same waves)."""
    a = _render_mode("ring")
    b = _render_mode("ring", extra=tuple(kw.items()))
    np.testing.assert_allclose(b[0], a[0], rtol=1e-5, atol=1e-6)
    assert b[1:] == a[1:]


def _shadow_scene():
    from tpu_pathtracer_torch.scene import procedural
    from tpu_pathtracer_torch.scene.mesh import TriangleMesh
    from tpu_pathtracer_torch.accel import flatten_mesh_bvh
    plane = procedural.make_plane((0, 0, 0), 20, 20, 0)
    sphere = procedural.make_uv_sphere((0, 1.2, 0), 0.8, 1, n_lat=12,
                                       n_lon=16)
    return flatten_mesh_bvh(TriangleMesh.concatenate([plane, sphere]))


def test_distant_light_matches_jax_and_casts_a_shadow():
    """tests/test_features.py:29 in the port: the distant light lights the
    plane, the sphere shadows it, and the image is the JAX package's under
    the gate statistics."""
    W = 48
    fb = _shadow_scene()
    mats = [MatDesc(refltype=MAT_DIFF, objcol=(0.8, 0.8, 0.8)),
            MatDesc(refltype=MAT_DIFF, objcol=(0.2, 0.2, 0.2))]
    kw = dict(bounce_min=2, bounce_max=4, use_envmap=False,
              use_texture=False, use_distant_light=True,
              distant_light_dir=(1.0, 1.0, 0.0),
              distant_light_L=(2.0, 2.0, 2.0))
    rc = tdemo.default_camera(W, W, pitch=1.5, radius=8,
                              center=(0, 0, 0)).build_render_camera()
    from tpu_pathtracer.tracer.wavefront import RenderSettings as JSettings
    jr = JRenderer(fb, mats, width=W, height=W, settings=JSettings(**kw))
    tr = Renderer(fb, mats, width=W, height=W, settings=RenderSettings(**kw),
                  device="cpu")
    spp = 8
    jbuf = jr.accum_to_buffer(np.asarray(
        jr.render_frames(jr.zeros_accum(), rc, 1, spp)) / spp)
    tacc, _, trays = tr.render_frames(tr.zeros_accum(), rc, 1, spp,
                                      with_stats=True)
    tbuf = tr.accum_to_buffer(tacc.numpy() / spp)
    _gate(tbuf, jbuf)
    lit = tbuf[6:10, W - 10:W - 6].mean()
    shadow = tbuf[W // 2 - 2:W // 2 + 2, W // 2 - 9:W // 2 - 6].mean()
    assert lit > 0.05 and lit > shadow * 1.5
    assert trays > W * W * spp            # the light's shadow rays count


def test_bssrdf_exit_distant_light_matches_jax():
    """tests/test_features.py:101 in the port: with a black environment the
    distant light reaches the subsurface sphere only through the NEE at the
    BSSRDF exit points."""
    from tpu_pathtracer_torch.scene import procedural
    from tpu_pathtracer_torch.scene.mesh import TriangleMesh
    from tpu_pathtracer_torch.scene.config import MAT_SUBSURFACE
    from tpu_pathtracer_torch.accel import flatten_mesh_bvh
    from tpu_pathtracer.tracer.wavefront import RenderSettings as JSettings
    W = 32
    sphere = procedural.make_uv_sphere((0, 0.0, 0), 1.0, 1, n_lat=10,
                                       n_lon=14)
    plane = procedural.make_plane((0, -1.0, 0), 20, 20, 0)
    fb = flatten_mesh_bvh(TriangleMesh.concatenate([plane, sphere]))
    mats = [MatDesc(refltype=MAT_DIFF, objcol=(0.6, 0.6, 0.6)),
            MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.8, 0.75, 0.7),
                    alphax=0.3, etaT=1.4, mfp=(0.3, 0.25, 0.2), ks=0.2)]
    kw = dict(bounce_min=3, bounce_max=8, use_envmap=False,
              use_texture=False, has_bssrdf=True, use_distant_light=True,
              distant_light_dir=(0.3, 1.0, 0.4),
              distant_light_L=(3.0, 3.0, 3.0))
    rc = tdemo.default_camera(W, W, pitch=0.3, radius=3.5,
                              center=(0, 0, 0)).build_render_camera()
    jr = JRenderer(fb, mats, width=W, height=W, settings=JSettings(**kw),
                   env_const=(0.0, 0.0, 0.0))
    tr = Renderer(fb, mats, width=W, height=W, settings=RenderSettings(**kw),
                  env_const=(0.0, 0.0, 0.0), device="cpu")
    spp = 8
    jbuf = jr.accum_to_buffer(np.asarray(
        jr.render_frames(jr.zeros_accum(), rc, 1, spp)) / spp)
    tbuf = tr.accum_to_buffer(
        tr.render_frames(tr.zeros_accum(), rc, 1, spp).numpy() / spp)
    _gate(tbuf, jbuf)
    c = slice(W // 2 - 4, W // 2 + 4)
    assert tbuf[c, c].mean() > 0.005
