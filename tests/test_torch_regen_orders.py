"""The port's inplace pool order, held to the default compact order.

inplace == compact to float addition order (tests/test_regen.py:44: max
|d| < 5e-3, mean |d| < 1e-5), with the same waves and traced rays, on
TestObj and on the scenes of tests/test_regen.py:240 (surfaces, a capped
pool, media, subsurface); and the capped-pool, with_stats and scatter-mode
cases of tests/test_regen.py:81-208 under inplace.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_regen import _render_mode, _renderer
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.scene.config import MatDesc, MAT_DIFF
from tpu_pathtracer_torch.tracer.regen import make_regen_integrator
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))


def _scene_case(name):
    """(materials, settings) of a scene of tests/test_regen.py:240 on the
    TestObj stream: "surface", "capped" (a 256-lane pool), "media" (jade
    in the glass), "subsurface"."""
    from tpu_pathtracer_torch.scene.config import (
        MAT_GLASS, MAT_REFL, MAT_SUBSURFACE)
    base = [MatDesc(refltype=MAT_DIFF), MatDesc(refltype=MAT_DIFF),
            MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)]
    if name == "media":
        return [MatDesc(refltype=MAT_DIFF), MatDesc(refltype=MAT_DIFF),
                MatDesc(refltype=MAT_GLASS, medium="jade"),
                MatDesc(refltype=MAT_REFL)], dict(has_media=True)
    if name == "subsurface":
        return [MatDesc(refltype=MAT_DIFF),
                MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.8, 0.75, 0.7),
                        alphax=0.3, etaT=1.4, mfp=(0.3, 0.25, 0.2), ks=0.2),
                MatDesc(refltype=MAT_GLASS),
                MatDesc(refltype=MAT_REFL)], dict(has_bssrdf=True)
    return base, (dict(pool_lanes=256) if name == "capped" else {})


@functools.lru_cache(maxsize=None)
def _render_scene(name, order):
    """(image, waves, rays) of a 32x32, 2-spp with_stats render of a scene
    (TestObj's own for "default", else _scene_case) in a pool order."""
    if name == "default":
        return _render_mode("ring", extra=(() if order == "compact" else
                                           (("regen_order", order),)))
    W = 32
    mats, extra = _scene_case(name)
    s = RenderSettings(use_envmap=True, use_texture=False, regen_order=order,
                       **extra)
    r = _renderer(W, settings=s, mats=mats)
    rc = tdemo.default_camera(W, W).build_render_camera()
    acc, waves, rays = r.render_frames(r.zeros_accum(), rc, 1, 2,
                                       with_stats=True)
    return acc.numpy(), waves, rays


@pytest.mark.parametrize("name", ["default", "surface", "capped", "media",
                                  "subsurface"])
def test_inplace_matches_compact(name):
    """tests/test_regen.py:44 in the port: the pool order changes nothing
    observable: the same image to float addition order, the same waves and
    the same traced rays."""
    a = _render_scene(name, "compact")
    b = _render_scene(name, "inplace")
    d = np.abs(a[0] - b[0])
    assert d.max() < 5e-3 and d.mean() < 1e-5
    assert a[1:] == b[1:]
    assert b[2] >= 32 * 32 * 2


@pytest.mark.parametrize("mode", ["ring", "deferred"])
def test_inplace_adds_every_wave_whatever_the_scatter_mode(mode):
    """Banking radiance needs the compacted dead tail, so an inplace render
    takes scatter_mode "wave" whatever it asks for (as the JAX package
    does): the three modes give the same bits."""
    wave = _render_mode("wave", extra=(("regen_order", "inplace"),))
    other = _render_mode(mode, extra=(("regen_order", "inplace"),))
    np.testing.assert_array_equal(other[0], wave[0])
    assert other[1:] == wave[1:]


def test_inplace_capped_pool_matches_full():
    """tests/test_regen.py:81 under inplace: a 256-lane pool runs more
    waves over the same samples."""
    full = _render_mode("ring", extra=(("regen_order", "inplace"),))
    narrow = _render_mode("ring", pool=256,
                          extra=(("regen_order", "inplace"),))
    d = np.abs(full[0] - narrow[0])
    assert d.max() < 5e-3 and d.mean() < 1e-5
    assert narrow[2] == full[2]
    assert narrow[1] > full[1]


@pytest.mark.parametrize("order,name,kw", [
    ("compact", "default", {}), ("inplace", "default", {}),
    ("compact", "media", {}), ("compact", "subsurface", {}),
    ("compact", "default", dict(use_distant_light=True)),
    ("compact", "default", dict(scatter_mode="wave"))],
    ids=["compact", "inplace", "media", "bssrdf", "distant_light", "wave"])
def test_with_stats_renders_the_same_bits(order, name, kw):
    """tests/test_regen.py:208: counting rays changes no bit of the image
    and no wave, on TestObj in either order, with media, with BSSRDF, with
    the distant light and with the per-wave add."""
    W = 32
    mats = None
    if name == "default":
        s = _renderer(W).settings
    else:
        mats, extra = _scene_case(name)
        s = RenderSettings(use_envmap=True, use_texture=False, **extra)
    s = dataclasses.replace(s, regen_order=order, **kw)
    r = _renderer(W, settings=s, mats=mats)
    rc = tdemo.default_camera(W, W).build_render_camera()
    fn = make_regen_integrator(s, W, W)
    cam_vec = torch.as_tensor(rc.as_array())
    plain = fn(r.scene, cam_vec, 1, 0, r.zeros_accum(), 2)
    stats = make_regen_integrator(s, W, W, with_stats=True)(
        r.scene, cam_vec, 1, 0, r.zeros_accum(), 2)
    assert torch.equal(plain[0], stats[0])
    assert plain[1] == stats[1]
    assert stats[2] >= W * W * 2


def test_inplace_pool_after_waves_is_a_mask():
    """stop_after_waves under inplace: the pool's live set is a mask (not
    a prefix) whose count is `alive`, and L is 0 outside it."""
    W = 32
    s = dataclasses.replace(_renderer(W).settings, regen_order="inplace")
    r = _renderer(W, settings=s)
    rc = tdemo.default_camera(W, W).build_render_camera()
    pool = make_regen_integrator(s, W, W, stop_after_waves=2)(
        r.scene, torch.as_tensor(rc.as_array()), 1, 0, r.zeros_accum(), 1)
    act = pool["active"]
    assert pool["waves"] == 2 and int(act.sum()) == pool["alive"] > 0
    assert not torch.equal(act, torch.arange(W * W) < pool["alive"])
    assert (pool["L"][~act] == 0).all()
