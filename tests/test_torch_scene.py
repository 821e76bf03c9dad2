"""Port scene construction against the JAX package: equal bits.

JAX's native SBVH loader (tpu_pathtracer/accel/native_build.py) compiles
in place and remembers a failed load for the whole process. When several
test processes start on a checkout without the built library, one of
them can load a file another is still writing ("file too short"), and
its JAX scenes then come from the Python builder, whose TestObj tree is
not the native one. `jax_native_lib` (used here and in
test_torch_accel.py) makes sure the JAX library is loaded before a JAX
scene is built; the port's own loader holds a file lock instead.
"""
import ctypes
import dataclasses
import functools
import os
import shutil
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.accel import native_build as jnative
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
from torch_settings import port_fields

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
CACHE = None   # build in-process: no cache file shared between workers


def jax_native_lib(settle_s=1.0, timeout_s=120.0):
    """JAX's native SBVH library, loaded. When get_lib() failed (a load
    during another process's compile), wait until the library file has
    stopped changing, check that it loads, and only then clear the
    loader's remembered failure and load again. A library that never
    settles or does not load fails the test, naming the cause."""
    lib = jnative.get_lib()
    if lib is not None:
        return lib
    path, last = jnative._LIB, None
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            st = os.stat(path)
            now = (st.st_ino, st.st_size, st.st_mtime_ns)
        except FileNotFoundError:
            now = None
        if now is not None and now == last:
            break
        if time.monotonic() > deadline:
            raise AssertionError(
                "JAX's native SBVH library %s %s after %.0f s (g++: %s)"
                % (path, "never appeared" if now is None
                   else "kept changing", timeout_s, shutil.which("g++")))
        last = now
        time.sleep(settle_s)
    try:
        ctypes.CDLL(path)
    except OSError as e:
        raise AssertionError("JAX's native SBVH library does not load: %s"
                             % e) from e
    jnative._failed = False
    lib = jnative.get_lib()
    assert lib is not None, "JAX's native loader refused %s" % path
    return lib


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
    jax_native_lib()
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


@pytest.mark.parametrize("what", ["bounce"])
def test_renderer_raises_for_unported_features(what):
    """The bounce integrator is ported: the Renderer takes it. An unknown
    integrator raises at construction."""
    fb, mats, envmap, texture = _scene("default")
    r = trenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                           width=8, height=8,
                           settings=RenderSettings(integrator=what),
                           device="cpu")
    assert r.settings.integrator == what
    with pytest.raises(ValueError):
        trenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                           width=8, height=8,
                           settings=RenderSettings(integrator="bounse"),
                           device="cpu")


@pytest.mark.parametrize("variant", ["media", "subsurface"])
def test_media_and_subsurface_scene_dicts_bit_exact(variant):
    """The Renderer takes media and BSSRDF scenes: the same scene dict as
    the JAX package (with the bssrdf_* tables where it has them), the same
    derived default settings, and scene_from_jax carries every key."""
    fb, mats, envmap, texture = _scene(variant)
    jr = jrenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                            width=24, height=16)
    tr = trenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                            width=24, height=16, device="cpu")
    assert port_fields(tr.settings) == port_fields(jr.settings)
    assert tr.settings.has_media == (variant == "media")
    assert tr.settings.has_bssrdf == (variant == "subsurface")
    assert (tr.settings.packet_tile_sub,
            tr.settings.packet_interleave) == (32, 4)
    assert set(tr.scene) == set(jr.scene)
    assert ("bssrdf_profile" in tr.scene) == (variant == "subsurface")
    conv = scene_from_jax({k: v if isinstance(v, int) else np.asarray(v)
                           for k, v in jr.scene.items()}, "cpu")
    for k, v in jr.scene.items():
        if isinstance(v, int):
            assert tr.scene[k] == v and conv[k] == v, k
            continue
        assert _bits(tr.scene[k].numpy()) == _bits(v), k
        assert _bits(conv[k].numpy()) == _bits(v), k


def test_default_settings_for_a_stream_over_the_smem_budget():
    """Streams over the JAX package's SMEM table budget derive the (16, 4)
    packet shape in both packages (it changes no result in the port)."""
    fb, mats, envmap, texture = tdemo.large_scene(
        cache_dir=CACHE, n_lat=40, n_lon=80, ground_div=12)
    assert fb.prims.shape[0] * 14 * 4 > 700_000
    jr = jrenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                            width=8, height=8)
    tr = trenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                            width=8, height=8, device="cpu")
    assert port_fields(tr.settings) == port_fields(jr.settings)
    assert (tr.settings.packet_tile_sub,
            tr.settings.packet_interleave) == (16, 4)


def test_jax_native_guard_clears_a_failure_only_after_a_compile(
        tmp_path, monkeypatch):
    """A remembered failure stays while the library on disk does not load,
    and is cleared once another process's compile has put a library there
    that loads."""
    from tpu_pathtracer_torch.accel import native_build as tnative
    built = tnative.get_lib()
    assert built is not None, tnative.last_error()
    lib = tmp_path / "libsbvh.so"
    monkeypatch.setattr(jnative, "_LIB", str(lib))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_failed", True)
    lib.write_bytes(b"")               # a compile that never finished
    with pytest.raises(AssertionError, match="does not load"):
        jax_native_lib(settle_s=0.05, timeout_s=5.0)
    assert jnative._failed and jnative._lib is None
    lib.unlink()
    with pytest.raises(AssertionError, match="never appeared"):
        jax_native_lib(settle_s=0.05, timeout_s=0.2)
    assert jnative._failed
    # another process's compile lands while the guard waits
    timer = threading.Timer(0.3, shutil.copy, (tnative._LIB, str(lib)))
    timer.start()
    try:
        got = jax_native_lib(settle_s=0.2, timeout_s=10.0)
    finally:
        timer.join()
    assert got is not None and got is jnative._lib
    assert jnative._failed is False
