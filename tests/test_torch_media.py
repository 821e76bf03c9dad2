"""Participating media in the port against the JAX package and the goldens.

`medium_interaction` is compared on the same numpy-seeded lanes: where both
packages take the same branch (`sampled`) the outputs agree to rtol 1e-5
(log/exp/sin/cos differ by ulps between XLA and torch), and the branch
itself may flip on a lane whose sampled distance ties with the hit
distance, so the masks must be equal on >= 0.999 of lanes. Images are held
to the gate statistics of bench.py:233-247 (median |diff| < 1e-4, mean
within 1%, RMSE < 0.1): the same samples, rounding apart.
"""
import functools
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.tracer.medium import medium_interaction as j_medium
from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
from tpu_pathtracer.tracer.wavefront import pack_mat_table as j_pack_mat
from tpu_pathtracer import media as jmedia
from tpu_pathtracer_torch import media as tmedia
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.scene.config import (
    MatDesc, MAT_DIFF, MAT_GLASS, MAT_REFL, materials_to_arrays)
from tpu_pathtracer_torch.tracer.medium import medium_interaction
from tpu_pathtracer_torch.tracer.regen import make_regen_integrator
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import (
    RenderSettings, pack_mat_table)
from torch_settings import port_fields

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
N = 4096


def _gate(img, want):
    d = np.abs(img - want)
    assert np.all(np.isfinite(img))
    assert float(np.median(d)) < 1e-4, np.median(d)
    assert abs(img.mean() / max(want.mean(), 1e-9) - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


def _lanes(seed):
    g = np.random.default_rng(seed)
    mats = [MatDesc(refltype=MAT_DIFF),
            MatDesc(refltype=MAT_GLASS, medium="jade"),
            MatDesc(refltype=MAT_GLASS, medium="tea"),
            MatDesc(refltype=MAT_GLASS, medium="milk"),
            MatDesc(refltype=MAT_GLASS, medium=((2.0, 1.0, 0.5),
                                                (0.1, 0.2, 0.3), 0.0))]
    arrays = materials_to_arrays(mats)
    d = g.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit_t = g.uniform(0.01, 2.0, N)
    hit_t[g.random(N) < 0.1] = 1e20                    # misses
    return arrays, dict(
        rng=g.integers(0, 2 ** 32, N, dtype=np.uint32),
        orig=g.normal(size=(N, 3)).astype(np.float32),
        raydir=d.astype(np.float32),
        mask=g.uniform(0.1, 1.0, (N, 3)).astype(np.float32),
        hit_t=hit_t.astype(np.float32),
        medium_id=g.integers(-1, len(mats), N).astype(np.int32),
        active=g.random(N) < 0.9)


@pytest.mark.parametrize("seed", [0, 1])
def test_medium_interaction_matches_jax(seed):
    arrays, x = _lanes(seed)
    assert np.array_equal(pack_mat_table(arrays), j_pack_mat(arrays))
    table = pack_mat_table(arrays)
    j = j_medium({"mat_table": jnp.asarray(table)},
                 *(jnp.asarray(x[k]) for k in (
                     "rng", "orig", "raydir", "mask", "hit_t", "medium_id",
                     "active")))
    t = medium_interaction(
        {"mat_table": torch.from_numpy(table)},
        torch.from_numpy(x["rng"].astype(np.int64)),
        *(torch.from_numpy(x[k]) for k in (
            "orig", "raydir", "mask", "hit_t", "medium_id", "active")))
    j = [np.asarray(v) for v in j]
    t = [v.numpy() for v in t]
    assert np.array_equal(t[0], j[0].astype(np.int64))     # rng: four draws
    same = t[4] == j[4]
    assert same.mean() >= 0.999
    assert 0.05 < t[4].mean() < 0.95                       # both branches
    for k in (1, 2, 3):
        np.testing.assert_allclose(t[k][same], j[k][same], rtol=1e-5,
                                   atol=1e-6)
    # lanes outside a medium pass through unchanged
    out = ~(x["active"] & (x["medium_id"] >= 0))
    assert not t[4][out].any()
    for k, name in ((1, "orig"), (2, "raydir"), (3, "mask")):
        assert np.array_equal(t[k][out], x[name][out])


def test_media_package_reexports():
    assert tmedia.medium_interaction is medium_interaction
    assert tmedia.MEDIUM_PRESETS == jmedia.MEDIUM_PRESETS
    g = np.random.default_rng(5)
    u1, u2 = (g.random(N).astype(np.float32) for _ in range(2))
    gg = g.uniform(-0.9, 0.9, N).astype(np.float32)
    gg[:64] = 0.0
    d = g.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    j = np.asarray(jmedia.henyey_greenstein_sample(
        *(jnp.asarray(v) for v in (u1, u2, gg, d))))
    t = tmedia.henyey_greenstein_sample(
        *(torch.from_numpy(v) for v in (u1, u2, gg, d))).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=2e-6)


@functools.lru_cache(maxsize=1)
def _testobj():
    return tdemo.testobj_scene(cache_dir=None)


def test_c4_media_matches_golden():
    fb, _, envmap, texture = _testobj()
    mats4 = [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_DIFF),
             MatDesc(refltype=MAT_GLASS, medium="tea"),
             MatDesc(refltype=MAT_REFL)]
    s = RenderSettings(bounce_min=2, bounce_max=10, has_media=True,
                       use_envmap=True, use_texture=True)
    r = Renderer(fb, mats4, envmap=envmap, texture=texture, width=96,
                 height=96, settings=s, device="cpu")
    cam = tdemo.default_camera(96, 96)
    cam.aperture_radius = 0.0
    cam.focal_distance = 4.0
    acc = r.render_frames(r.zeros_accum(), cam.build_render_camera(), 1, 12)
    _gate(r.accum_to_buffer(acc.numpy() / 12),
          np.load(os.path.join(GOLDEN_DIR, "c4_media.npz"))["img"])


@functools.lru_cache(maxsize=1)
def _organic_media():
    return tdemo.large_organic_scene(cache_dir=None, variant="media",
                                     n_lat=40, n_lon=80)


def test_organic_media_matches_jax_render():
    """The c7 composition on a ~6k-triangle blob, 48x48, 4 spp (the
    golden-size scene takes minutes on two CPU threads)."""
    W = 48
    fb, mats, envmap, texture = _organic_media()
    rc = tdemo.default_camera(W, W).build_render_camera()
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=W,
                   height=W)
    tr = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                  height=W, device="cpu")
    # one settings object describes the render in both packages
    assert port_fields(tr.settings) == port_fields(jr.settings)
    assert tr.settings.has_media and tr.settings.packet_tile_sub == 32
    jacc = np.asarray(jr.render_frames(jr.zeros_accum(), rc, 1, 4))
    tacc = tr.render_frames(tr.zeros_accum(), rc, 1, 4).numpy()
    _gate(tr.accum_to_buffer(tacc / 4), jr.accum_to_buffer(jacc / 4))


def test_media_render_darkens_glass_and_pool_carries_medium_id():
    """Jade inside the glass blob attenuates what the clear blob transmits
    (tests/test_features.py:50), and the frozen pool reports which lanes
    are inside it."""
    W = 32
    fb, mats, envmap, texture = _organic_media()
    rc = tdemo.default_camera(W, W).build_render_camera()
    clear = [mats[0], MatDesc(refltype=MAT_GLASS)]
    imgs = []
    for m in (mats, clear):
        r = Renderer(fb, m, envmap=envmap, texture=texture, width=W,
                     height=W, device="cpu")
        acc = r.render_frames(r.zeros_accum(), rc, 1, 4)
        imgs.append(r.accum_to_buffer(acc.numpy() / 4))
    c = slice(W // 2 - 4, W // 2 + 4)
    assert imgs[0][c, c].mean() < 0.9 * imgs[1][c, c].mean()

    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=W, device="cpu")
    fn = make_regen_integrator(r.settings, W, W, stop_after_waves=3)
    pool = fn(r.scene, torch.as_tensor(rc.as_array()), 1, 0,
              r.zeros_accum(), 4)
    mid = pool["medium_id"][:pool["alive"]]
    assert mid.dtype == torch.int32 and pool["medium_id"].shape == (W * W,)
    assert set(mid.unique().tolist()) == {-1, 1}      # outside / in the jade
