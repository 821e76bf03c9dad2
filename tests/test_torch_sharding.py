"""Lane sharding (parallel/sharding.py) on CPU devices, after
tests/test_parallel.py:23-178.

A mesh names devices, a device more than once when one device runs several
shards; here every shard runs on the CPU. Each shard renders its own lane
range with lane0 = its offset, and the RNG is counted per (frame, global
pixel), so the bounce integrator gives the single-device image bit for
bit. The regen pools add each pixel's paths in another order, so regen is
held to rtol 1e-5, atol 2e-5 as in the JAX tests.
"""
import functools

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.scene import demo as tdemo, procedural
from tpu_pathtracer_torch.scene.config import (
    MatDesc, MAT_DIFF, MAT_GLASS, MAT_REFL, MAT_SUBSURFACE)
from tpu_pathtracer_torch.accel import flatten_mesh_bvh
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
from tpu_pathtracer_torch.parallel import ShardedRenderer, make_mesh

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))

W = 32
SURFACE = [MatDesc(refltype=MAT_DIFF), MatDesc(refltype=MAT_DIFF),
           MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)]
CASES = {
    "bounce": (SURFACE, dict(integrator="bounce")),
    "regen": (SURFACE, {}),
    "media": ([MatDesc(refltype=MAT_DIFF), MatDesc(refltype=MAT_DIFF),
               MatDesc(refltype=MAT_GLASS, medium="jade"),
               MatDesc(refltype=MAT_REFL)], dict(has_media=True)),
    "subsurface": ([MatDesc(refltype=MAT_DIFF),
                    MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.83, 0.79,
                                                             0.75),
                            alphax=0.3, etaT=1.4, mfp=(0.35, 0.3, 0.25),
                            ks=0.2),
                    MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)],
                   dict(has_bssrdf=True)),
    "capped_pool": (SURFACE, dict(pool_lanes=128)),
}


@functools.lru_cache(maxsize=1)
def _scene():
    return (flatten_mesh_bvh(procedural.make_test_scene()),
            procedural.make_sky_envmap(64, 32))


@functools.lru_cache(maxsize=None)
def _renderer(case):
    mats, kw = CASES[case]
    fb, env = _scene()
    return Renderer(fb, mats, envmap=env, width=W, height=W,
                    settings=RenderSettings(use_envmap=True,
                                            use_texture=False, **kw),
                    device="cpu")


@functools.lru_cache(maxsize=None)
def _single(case):
    r = _renderer(case)
    rc = tdemo.default_camera(W, W).build_render_camera()
    return r.render_frames(r.zeros_accum(), rc, 1, 1).numpy()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_shards_match_the_single_device_render(case, n_shards):
    r = _renderer(case)
    rc = tdemo.default_camera(W, W).build_render_camera()
    sr = ShardedRenderer(r, mesh=make_mesh(["cpu"] * n_shards))
    assert sr.n_lanes % n_shards == 0 and sr.n_lanes >= W * W
    acc = sr.render_frames(sr.zeros_accum(), rc, 1, 1)
    assert acc.shape == (sr.n_lanes, 3)
    got = acc.numpy()[:W * W]
    if case == "bounce":
        np.testing.assert_array_equal(got, _single(case))
    else:
        np.testing.assert_allclose(got, _single(case), rtol=1e-5, atol=2e-5)


def test_shards_of_an_uneven_lane_count():
    """3 shards of 1,024 lanes: the lane count is padded to 1,026, and the
    padding lanes leave the image alone."""
    r = _renderer("bounce")
    rc = tdemo.default_camera(W, W).build_render_camera()
    sr = ShardedRenderer(r, mesh=make_mesh(["cpu"] * 3))
    assert sr.n_lanes == 1026 and sr.chunk == 342
    acc, bounces, rays = sr.render_frames(sr.zeros_accum(), rc, 1, 1,
                                          with_stats=True)
    np.testing.assert_array_equal(acc.numpy()[:W * W], _single("bounce"))
    assert bounces > 0 and rays >= sr.n_lanes
    np.testing.assert_array_equal(sr.accum_to_buffer(acc),
                                  r.accum_to_buffer(_single("bounce")))


def test_make_mesh():
    mesh = make_mesh(["cpu", torch.device("cpu")])
    assert mesh == (torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(ValueError):
        make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()


@pytest.mark.parametrize("variant", ["default", "media", "subsurface"])
def test_dryrun_multichip_cycle(variant):
    """__graft_entry__.dryrun_multichip in the port: each workload class
    (surface, media, subsurface) of the demo scene renders one sharded
    frame over 4 devices, finite and not black."""
    fb, mats, envmap, texture = tdemo.testobj_scene(cache_dir=None,
                                                    variant=variant)
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=W, device="cpu")
    sr = ShardedRenderer(r, mesh=make_mesh(["cpu"] * 4))
    rc = tdemo.default_camera(W, W).build_render_camera()
    img = sr.render_frame(sr.zeros_accum(), rc, 1).numpy()
    assert np.all(np.isfinite(img))
    assert img.shape[0] >= W * W
    assert float(img.mean()) > 0.0
