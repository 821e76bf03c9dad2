"""The port's viewer (tpu_pathtracer_torch/tools/interactive.py) against
the JAX tool's input handling and camera, the scripted session against
Renderer.render_frames bit for bit, and the device tonemap against the
JAX device path and the host f64 path (at most one uint8 step, at least
99.9% of pixels equal). A converged image is held to the JAX Renderer by
bench.py's gate statistics (median |diff| < 1e-4, mean within 1%, RMSE <
0.1)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import interactive as jtool  # noqa: E402

from tpu_pathtracer.scene import demo as jdemo  # noqa: E402
from tpu_pathtracer.scene.camera import InteractiveCamera as JCamera  # noqa
from tpu_pathtracer.tracer.renderer import Renderer as JRenderer  # noqa
from tpu_pathtracer_torch.core.image import read_ppm  # noqa: E402
from tpu_pathtracer_torch.scene import demo as tdemo  # noqa: E402
from tpu_pathtracer_torch.tools import interactive as viewer  # noqa: E402
from tpu_pathtracer_torch.tracer.renderer import Renderer  # noqa: E402

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))

CAM_FIELDS = ("center_position", "view_direction", "yaw", "pitch", "radius",
              "aperture_radius", "focal_distance", "env_map_rotation",
              "resolution", "fov")


def _gate(img, want):
    d = np.abs(img - want)
    assert np.all(np.isfinite(img))
    assert float(np.median(d)) < 1e-4, np.median(d)
    assert abs(img.mean() / max(want.mean(), 1e-9) - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


def _same_camera(a, b):
    for f in CAM_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f), np.float64),
                                      np.asarray(getattr(b, f), np.float64),
                                      err_msg=f)


# the cases of tests/test_viewer_input.py:14-27
@pytest.mark.parametrize("params,final", [
    ("0;10;5", "M"), ("32;12;6", "M"), ("0;12;6", "m"), ("38;3;4", "M"),
    ("64;1;1", "M"), ("65;1;1", "M"), ("garbage", "M"), ("1;2", "M")])
def test_decode_sgr_mouse_matches_the_jax_tool(params, final):
    assert viewer.decode_sgr_mouse(params, final) == \
        jtool.decode_sgr_mouse(params, final)


def test_half_block_frame_matches_the_jax_tool():
    img = np.random.default_rng(3).integers(0, 256, (6, 5, 3), np.uint8)
    assert viewer.half_block_frame(img) == jtool.half_block_frame(img)


# the gestures of tests/test_viewer_input.py:30-61
@pytest.mark.parametrize("events", [
    [("press", 0, False, 10, 10), ("drag", 0, False, 14, 12),
     ("release", 0, False, 14, 12)],
    [("press", 2, False, 5, 5), ("drag", 2, False, 5, 9),
     ("wheel", 1, False, 5, 9)],
    [("press", 0, True, 20, 20), ("drag", 0, True, 30, 20)],
    [("drag", 0, False, 3, 3), ("drag", 0, False, 3, 3),
     ("wheel", -1, False, 1, 1)],
], ids=["left-drag", "right-drag-wheel", "shift-drag", "drag-no-press"])
def test_mouse_orbit_matches_the_jax_tool(events):
    tcam, jcam = tdemo.default_camera(64, 64), jdemo.default_camera(64, 64)
    tm, jm = viewer.MouseOrbit(), jtool.MouseOrbit()
    for ev in events:
        ev = ("MOUSE",) + ev
        assert tm.apply(ev, tcam) == jm.apply(ev, jcam)
        assert tm.last == jm.last
    _same_camera(tcam, jcam)


# tools/interactive.py:243-294 (the JAX tool's key map, a closure in its
# main): key -> the JAX camera's method calls
JAX_KEYS = {
    "w": lambda c: c.go_forward(0.1), "s": lambda c: c.go_forward(-0.1),
    "a": lambda c: c.strafe(-0.1), "d": lambda c: c.strafe(0.1),
    "r": lambda c: c.change_altitude(0.1),
    "f": lambda c: c.change_altitude(-0.1),
    "g": lambda c: c.change_aperture_diameter(-0.1),
    "h": lambda c: c.change_aperture_diameter(0.1),
    "t": lambda c: c.change_focal_distance(0.1),
    "y": lambda c: c.change_focal_distance(-0.1),
    "LEFT": lambda c: c.change_yaw(0.02),
    "RIGHT": lambda c: c.change_yaw(-0.02),
    "UP": lambda c: c.change_pitch(0.02),
    "DOWN": lambda c: c.change_pitch(-0.02),
    "[": lambda c: c.change_radius(-0.1),
    "]": lambda c: c.change_radius(0.1),
    "n": lambda c: setattr(c, "env_map_rotation",
                           (c.env_map_rotation + 0.01) % 1.0),
    "m": lambda c: setattr(c, "env_map_rotation",
                           (c.env_map_rotation - 0.01) % 1.0),
}


@pytest.mark.parametrize("keys", [list(JAX_KEYS), ["h", "h", "g", "y"],
                                  ["m", "m", "n", "UP"] * 3],
                         ids=["each-once", "lens", "env-pitch"])
def test_key_map_lands_where_the_jax_camera_does(keys, tmp_path):
    tcam, jcam = tdemo.default_camera(64, 64), jdemo.default_camera(64, 64)
    cam = str(tmp_path / "v.cam")
    for k in keys:
        assert viewer.apply_key(tcam, k, cam) is True
        JAX_KEYS[k](jcam)
    _same_camera(tcam, jcam)
    # space resets without moving; an unbound key does nothing
    assert viewer.apply_key(tcam, " ", cam) is True
    assert viewer.apply_key(tcam, "z", cam) is False
    _same_camera(tcam, jcam)
    # ',' saves the camera, '.' loads it back (and resets); the .cam file
    # holds f32, so the JAX camera takes the same round trip
    assert viewer.apply_key(tcam, ",", cam) is False
    viewer.apply_key(tcam, "w", cam)
    assert viewer.apply_key(tcam, ".", cam) is True
    jcam.save_cam(str(tmp_path / "j.cam"))
    jcam.__dict__.update(JCamera.load_cam(str(tmp_path / "j.cam")).__dict__)
    _same_camera(tcam, jcam)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def session_run(tmp_path_factory):
    """A scripted session at 64x64 (a 32x32 preview): a key, a left drag
    and space (previews on the injected clock), then 3 converging steps of
    2 spp, 5 s and 50 s apart, then close."""
    out = tmp_path_factory.mktemp("viewer")
    parts = tdemo.testobj_scene(cache_dir=None)
    fb, mats, envmap, texture = parts
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=64,
                 height=64, device="cpu")
    lo = viewer.preview_renderer(r, parts, 2)
    clock = _Clock()
    icam = tdemo.default_camera(64, 64)
    s = viewer.ViewerSession(r, icam, lo, batch=2,
                             cam_path=str(out / "v.cam"), out_dir=str(out),
                             clock=clock)
    steps = []
    for ev in (["w"], [("MOUSE", "press", 0, False, 10, 10),
                       ("MOUSE", "drag", 0, False, 13, 11)], [" "]):
        img = s.step(ev)
        steps.append((s.kind, s.frame, s.camera, img))
        clock.t += 0.1
    clock.t += 1.0
    for dt in (5.0, 50.0, 0.0):
        img = s.step([])
        steps.append((s.kind, s.frame, s.camera, img))
        clock.t += dt
    assert s.step(["q"]) is None
    s.close()
    return r, lo, s, steps, out


def test_session_images_are_the_renders_of_its_cameras(session_run):
    r, lo, s, steps, _ = session_run
    assert lo is not None and (lo.width, lo.height) == (32, 32)
    assert [k for k, *_ in steps] == ["preview"] * 3 + ["full"] * 3
    assert [f for _, f, *_ in steps] == [0, 0, 0, 2, 4, 6]
    for kind, _, cam, img in steps[:3]:
        want = lo.accum_to_image(lo.render_frames(lo.zeros_accum(), cam, 1,
                                                  1), 1)
        np.testing.assert_array_equal(img, want.repeat(2, 0).repeat(2, 1))
    acc = r.zeros_accum()
    for kind, frame, cam, img in steps[3:]:
        acc = r.render_frames(acc, cam, frame - 1, 2)
        np.testing.assert_array_equal(img, r.accum_to_image(acc, frame))
    assert torch.equal(s.accum, acc)


def test_session_writes_the_three_snapshots(session_run):
    r, _, s, _, out = session_run
    for name in ("output5.ppm", "output50.ppm", "output500.ppm"):
        img = read_ppm(str(out / name))
        assert img.shape == (64, 64, 3) and img.mean() > 0.05, name
    # output500 is the final accumulation through the host tonemap
    np.testing.assert_allclose(
        read_ppm(str(out / "output500.ppm")),
        r.accum_to_image(s.accum.numpy(), s.frame) / 255.0, atol=1e-12)


def test_session_converged_image_matches_jax(session_run):
    r, _, s, steps, _ = session_run
    cam = steps[-1][2]
    fb, mats, envmap, texture = tdemo.testobj_scene(cache_dir=None)
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=64,
                   height=64)
    jacc = np.asarray(jr.render_frames(jr.zeros_accum(), cam, 1, s.frame))
    _gate(r.accum_to_buffer(s.accum) / s.frame,
          jr.accum_to_buffer(jacc) / s.frame)


@pytest.mark.parametrize("frames", [1, 7])
def test_device_tonemap_matches_jax_and_the_host_path(frames):
    W, H = 48, 40
    g = np.random.default_rng(frames)
    acc = (g.random((W * H, 3)) * 1.3 * frames).astype(np.float32)
    acc[:50] = 0.0
    acc[50:60] = 10.0 * frames
    fb, mats, envmap, texture = tdemo.testobj_scene(cache_dir=None)
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=H, device="cpu")
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=W,
                   height=H)
    dev = r.accum_to_image(torch.from_numpy(acc), frames)
    host = r.accum_to_image(acc, frames)
    jdev = jr.accum_to_image(jnp.asarray(acc), frames)
    assert dev.dtype == np.uint8 and dev.shape == (H, W, 3)
    for want in (host, jdev):
        d = np.abs(dev.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1
        assert (d == 0).mean() >= 0.999
    assert np.array_equal(host, jr.accum_to_image(acc, frames))
