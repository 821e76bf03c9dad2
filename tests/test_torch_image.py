"""The viewer's image from the tonemapped lanes (ops/image.py) on the CPU:
the plain un-swizzle and upscale against the host path it replaced (the
numpy scatter through lane_tables, then np.repeat), and
Renderer.accum_to_image of a CPU tensor and of a numpy array against the
arithmetic it had before the un-swizzle moved to the device. The kernel
itself is in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.core.image import tonemap
from tpu_pathtracer_torch.ops import image as image_ops
from tpu_pathtracer_torch.parallel.sharding import ShardedRenderer
from tpu_pathtracer_torch.scene import demo
from tpu_pathtracer_torch.tracer.renderer import Renderer, lane_tables

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
SIZES = [(64, 64), (96, 40)]          # 96x40: clipped blocks at the bottom


def _host_image(u8, width, height, repeat):
    """The host path: uint8 lanes scattered in numpy, then np.repeat."""
    px, py = lane_tables(width, height)
    img = np.zeros((height, width, 3), np.uint8)
    img[py, px] = u8
    return img.repeat(repeat, 0).repeat(repeat, 1)


def _host_tonemap(acc, frames):
    """The device tonemap's three torch ops, as accum_to_image runs them."""
    x = torch.clamp(acc / float(max(frames, 1)), 0.0, 1.0)
    return (torch.pow(x, 1.0 / 2.2) * 255.0 + 0.5).to(torch.uint8).numpy()


def _lanes(width, height, seed):
    g = np.random.default_rng(seed)
    u8 = g.integers(0, 256, (width * height, 3), dtype=np.uint8)
    px, py = (torch.from_numpy(t) for t in lane_tables(width, height))
    return u8, px, py


_RENDERERS = {}


def _renderer(width, height):
    if (width, height) not in _RENDERERS:
        fb, mats, envmap, texture = demo.testobj_scene(cache_dir=None)
        _RENDERERS[width, height] = Renderer(
            fb, mats, envmap=envmap, texture=texture, width=width,
            height=height, device="cpu")
    return _RENDERERS[width, height]


def _accum(n, frames, seed=0):
    g = np.random.default_rng(seed + frames)
    acc = (g.random((n, 3)) * 1.3 * frames).astype(np.float32)
    acc[:50] = 0.0
    acc[50:60] = 10.0 * frames
    return acc


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("repeat", [1, 2, 3])
def test_plain_version_equals_the_host_scatter_and_repeat(size, repeat):
    W, H = size
    u8, px, py = _lanes(W, H, repeat)
    before = dict(image_ops.LAUNCHES)
    for fn in (image_ops.unswizzle_upscale_plain,
               image_ops.unswizzle_upscale):
        got = fn(torch.from_numpy(u8), px, py, W, H, repeat)
        assert got.dtype == torch.uint8
        assert tuple(got.shape) == (H * repeat, W * repeat, 3)
        np.testing.assert_array_equal(got.numpy(),
                                      _host_image(u8, W, H, repeat))
    assert image_ops.LAUNCHES == before


def test_the_kernel_wrapper_refuses_cpu_tensors_and_bad_sizes():
    u8, px, py = _lanes(64, 64, 0)
    rgb = torch.from_numpy(u8)
    for fn in (image_ops.unswizzle_upscale_cuda, image_ops.launch_fn):
        with pytest.raises(ValueError):
            fn(rgb, px, py, 64, 64, 2)
    with pytest.raises(ValueError, match="repeat"):
        _renderer(64, 64).accum_to_image(torch.zeros(64 * 64, 3), 1, 0)
    assert image_ops.io_bytes(960 * 540, 2) == 960 * 540 * 23


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("frames", [1, 6])
def test_accum_to_image_of_a_cpu_tensor_keeps_its_bytes(size, frames):
    W, H = size
    r = _renderer(W, H)
    acc = _accum(W * H, frames)
    want = _host_image(_host_tonemap(torch.from_numpy(acc), frames), W, H, 1)
    for repeat in (1, 2):
        got = r.accum_to_image(torch.from_numpy(acc), frames, repeat=repeat)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(
            got, want.repeat(repeat, 0).repeat(repeat, 1))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("frames", [1, 6])
def test_accum_to_image_of_a_numpy_array_is_the_host_f64_tonemap(size,
                                                                  frames):
    W, H = size
    r = _renderer(W, H)
    acc = _accum(W * H, frames)
    px, py = lane_tables(W, H)
    buf = np.zeros((H, W, 3), np.float32)
    buf[py, px] = acc
    want = tonemap(buf, frames)
    np.testing.assert_array_equal(r.accum_to_image(acc, frames), want)
    np.testing.assert_array_equal(r.accum_to_image(acc, frames, 3),
                                  want.repeat(3, 0).repeat(3, 1))


def test_each_call_returns_an_image_of_its_own():
    r = _renderer(64, 64)
    a = r.accum_to_image(torch.from_numpy(_accum(64 * 64, 1)), 1, 2)
    kept = a.copy()
    b = r.accum_to_image(torch.from_numpy(_accum(64 * 64, 1, seed=5)), 1, 2)
    assert not np.shares_memory(a, b)
    np.testing.assert_array_equal(a, kept)
    assert not np.array_equal(a, b)


def test_sharded_renderer_passes_the_repeat_on():
    r = _renderer(96, 40)
    sr = ShardedRenderer(r, ["cpu"] * 3)
    acc = torch.from_numpy(_accum(sr.n_lanes, 2))
    np.testing.assert_array_equal(sr.accum_to_image(acc, 2, 2),
                                  r.accum_to_image(acc[:96 * 40], 2, 2))
