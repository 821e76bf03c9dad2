"""The Renderer's lane chunks and shared base scene (after
tpu_pathtracer/tracer/renderer.py:132-141,188-190,341-370 and
tests/test_integrator.py:132).

A render in k lane chunks gives the whole render: bit for bit for the
bounce integrator (every lane is computed alone), and within rtol 1e-5,
atol 1e-6 for regen, whose pools add each pixel's paths in another order.
"""
import functools

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.scene import demo as tdemo, procedural
from tpu_pathtracer_torch.scene.config import (
    MatDesc, MAT_DIFF, MAT_GLASS, MAT_REFL)
from tpu_pathtracer_torch.accel import flatten_mesh_bvh
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))

MATS = [MatDesc(refltype=MAT_DIFF), MatDesc(refltype=MAT_DIFF),
        MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)]


@functools.lru_cache(maxsize=1)
def _scene():
    return (flatten_mesh_bvh(procedural.make_test_scene()),
            procedural.make_sky_envmap(64, 32))


def _render(integrator, W, H, lane_chunk=None, spp=2, base_scene=None):
    fb, env = _scene()
    r = Renderer(fb, MATS, envmap=env, width=W, height=H,
                 settings=RenderSettings(use_envmap=True, use_texture=False,
                                         integrator=integrator),
                 lane_chunk=lane_chunk, base_scene=base_scene, device="cpu")
    rc = tdemo.default_camera(W, H).build_render_camera()
    return r, r.render_frames(r.zeros_accum(), rc, 1, spp)


@functools.lru_cache(maxsize=None)
def _whole(integrator):
    return _render(integrator, 32, 32)[1].numpy()


@pytest.mark.parametrize("chunk", [256, 320, 1000])
@pytest.mark.parametrize("integrator", ["bounce", "regen"])
def test_chunks_match_the_whole_render(integrator, chunk):
    r, acc = _render(integrator, 32, 32, lane_chunk=chunk)
    assert r.lane_chunk == chunk
    n_pad = r.scene["lane_px"].shape[0] - 32 * 32
    assert n_pad == -(-1024 // chunk) * chunk - 1024 + 8192
    if integrator == "bounce":
        np.testing.assert_array_equal(acc.numpy(), _whole(integrator))
    else:
        np.testing.assert_allclose(acc.numpy(), _whole(integrator),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("integrator", ["bounce", "regen"])
def test_lanes_past_the_image_add_nothing(integrator):
    """A 24x20 image in 256-lane chunks: the last chunk is padded past
    W*H = 480 lanes; the render keeps 480 rows and equals the
    one-chunk render."""
    r, acc = _render(integrator, 24, 20, lane_chunk=256)
    _, whole = _render(integrator, 24, 20)
    assert acc.shape == (480, 3)
    if integrator == "bounce":
        assert torch.equal(acc, whole)
    else:
        np.testing.assert_allclose(acc.numpy(), whole.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert float(acc.mean()) > 0.0


def test_with_stats_sums_over_chunks():
    _, acc = _render("bounce", 32, 32, lane_chunk=256)
    fb, env = _scene()
    r = Renderer(fb, MATS, envmap=env, width=32, height=32,
                 settings=RenderSettings(use_envmap=True, use_texture=False,
                                         integrator="bounce"),
                 lane_chunk=256, device="cpu")
    rc = tdemo.default_camera(32, 32).build_render_camera()
    acc2, bounces, rays = r.render_frames(r.zeros_accum(), rc, 1, 2,
                                          with_stats=True)
    assert torch.equal(acc, acc2)
    assert bounces >= 4 * 2 and rays >= 32 * 32 * 2


@pytest.mark.parametrize("integrator", ["bounce", "regen"])
def test_base_scene_sharing_renders_identically(integrator):
    """tests/test_integrator.py:132 in the port: a renderer on base_scene
    shares the resolution-independent tensors (the same objects, the same
    storage) and renders the image of a freshly built renderer."""
    base, _ = _render(integrator, 64, 64, spp=1)
    fresh, a = _render(integrator, 32, 32)
    shared, b = _render(integrator, 32, 32, base_scene=base.scene)
    for k in ("packed", "tri_attr", "mat_table", "envmap_quad"):
        assert shared.scene[k] is base.scene[k], k
        assert shared.scene[k].data_ptr() == base.scene[k].data_ptr(), k
    assert shared.scene["lane_px"] is not base.scene["lane_px"]
    assert shared.scene["lane_px"].shape == fresh.scene["lane_px"].shape
    assert torch.equal(a, b)
