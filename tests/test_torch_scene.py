"""Port scene construction against the JAX package: equal bits."""
import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.scene import procedural as jproc
from tpu_pathtracer.scene import demo as jdemo
from tpu_pathtracer.tracer import renderer as jrenderer
from tpu_pathtracer.tracer import envsample as jenv
from tpu_pathtracer.tracer.traverse import pack_stream as jpack
from tpu_pathtracer.scene.texture import make_quad_texture as jquad
from tpu_pathtracer_torch.scene import procedural as tproc
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.scene.texture import make_quad_texture as tquad
from tpu_pathtracer_torch.tracer import renderer as trenderer
from tpu_pathtracer_torch.tracer import envsample as tenv
from tpu_pathtracer_torch.tracer.traverse import pack_stream as tpack
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
from tpu_pathtracer_torch.convert import scene_from_jax

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
CACHE = None   # build in-process: no cache file shared between workers


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str, a.shape, a.tobytes()


@functools.lru_cache(maxsize=None)
def _scene(variant="default"):
    return tdemo.testobj_scene(cache_dir=CACHE, variant=variant)


def test_mesh_content_hash_and_arrays_identical():
    jm = jproc.make_test_scene()
    tm = tproc.make_test_scene()
    assert tm.content_hash() == jm.content_hash()
    for f in ("vertices", "indices", "uv", "normals", "material_ids"):
        assert _bits(getattr(tm, f)) == _bits(getattr(jm, f)), f


def test_procedural_assets_identical():
    assert _bits(tproc.make_sky_envmap()) == _bits(jproc.make_sky_envmap())
    assert _bits(tproc.make_checker_texture()) == \
        _bits(jproc.make_checker_texture())


@pytest.mark.parametrize("variant", ["default", "lambertian", "gold",
                                     "subsurface", "media"])
def test_testobj_variants_identical(variant):
    jfb, jmats, jenvmap, jtex = jdemo.testobj_scene(cache_dir=CACHE,
                                                    variant=variant)
    tfb, tmats, tenvmap, ttex = _scene(variant)
    for f in dataclasses.fields(jfb):
        assert _bits(getattr(tfb, f.name)) == _bits(getattr(jfb, f.name)), \
            f.name
    assert [dataclasses.asdict(m) for m in tmats] == \
        [dataclasses.asdict(m) for m in jmats]
    assert _bits(tenvmap) == _bits(jenvmap)
    assert _bits(ttex) == _bits(jtex)


def test_testobj_unknown_variant_raises():
    with pytest.raises(ValueError):
        tdemo.testobj_scene(cache_dir=CACHE, variant="golden")


def test_camera_identical():
    for w, h in [(64, 64), (1024, 1024), (1920, 1080)]:
        jc = jdemo.default_camera(w, h).build_render_camera()
        tc = tdemo.default_camera(w, h).build_render_camera()
        assert _bits(tc.as_array()) == _bits(jc.as_array())


@pytest.mark.parametrize("wh", [(64, 64), (48, 48), (37, 23), (1920, 1080),
                                (100, 129), (31, 7)])
def test_lane_pixel_xy_bit_exact(wh):
    W, H = wh
    idx = np.arange(W * H, dtype=np.int32)
    jx, jy = jrenderer.lane_pixel_xy(jnp.asarray(idx), W, H)
    tx, ty = trenderer.lane_pixel_xy(torch.from_numpy(idx), W, H)
    assert _bits(tx.numpy()) == _bits(np.asarray(jx))
    assert _bits(ty.numpy()) == _bits(np.asarray(jy))
    px, py = trenderer.lane_tables(W, H)
    assert _bits(px) == _bits(tx.numpy()) and _bits(py) == _bits(ty.numpy())


@pytest.mark.parametrize("topk", [16384, 0, 100])
def test_alias_tables_bit_exact(topk):
    env = jproc.make_sky_envmap(128, 64)
    j = jenv.build_env_distribution(env, topk=topk)
    t = tenv.build_env_distribution(env, topk=topk)
    assert set(j) == set(t)
    for k in j:
        assert _bits(t[k]) == _bits(j[k]), k


def test_packed_streams_and_quads_bit_exact():
    fb = _scene()[0]
    assert _bits(tpack(fb.prims, fb.meta)) == _bits(jpack(fb.prims, fb.meta))
    tex = jproc.make_checker_texture(32, 4)
    for wu, wv in [(True, True), (False, False)]:
        assert _bits(tquad(tex, wu, wv)) == _bits(jquad(tex, wu, wv))


def test_scene_dict_bit_exact_and_scene_from_jax():
    fb, mats, envmap, texture = _scene()
    jr = jrenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                            width=40, height=24)
    tr = trenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                            width=40, height=24, device="cpu")
    assert set(tr.scene) == set(jr.scene)
    conv = scene_from_jax({k: v if isinstance(v, int) else np.asarray(v)
                           for k, v in jr.scene.items()}, "cpu")
    for k, v in jr.scene.items():
        if isinstance(v, int):
            assert tr.scene[k] == v and conv[k] == v, k
            continue
        assert _bits(tr.scene[k].numpy()) == _bits(v), k
        assert _bits(conv[k].numpy()) == _bits(v), k
    assert tr.settings.stack_depth == jr.settings.stack_depth


@pytest.mark.parametrize("what", ["bounce", "media", "subsurface"])
def test_renderer_raises_for_unported_features(what):
    fb, mats, envmap, texture = _scene(
        "default" if what == "bounce" else what)
    settings = RenderSettings(integrator="bounce") if what == "bounce" \
        else None
    with pytest.raises(NotImplementedError):
        trenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                           width=8, height=8, settings=settings,
                           device="cpu")
