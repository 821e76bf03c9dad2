"""The viewer's image from the tonemapped lanes: the lane-ordered uint8
pixels un-swizzled into [H*s, W*s, 3], each pixel repeated into its s x s
block (`unswizzle_upscale`). The CUDA kernel csrc/image.cu on the card,
its plain PyTorch version (an index scatter and a repeat) on the CPU.

tracer/renderer.py: Renderer.accum_to_image calls `unswizzle_upscale` on
the tonemapped lanes and copies the result to the host once; the viewer's
preview passes its upscale factor as `repeat`. A CPU tensor goes to the
plain version, any other device to the kernel, which launches once or
raises. Nothing falls back. Both give the same bytes.
"""
from __future__ import annotations

import ctypes

import torch

from .checks import require

# Launches of the kernel, counted where the wrapper launches it and
# nowhere else; set back to 0 by whoever reads them.
LAUNCHES = {"unswizzle_upscale": 0}


def unswizzle_upscale_plain(rgb, lane_px, lane_py, width, height, repeat=1):
    """rgb [n,3] uint8 lanes, lane_px / lane_py [n] int32 their pixels
    (n = width*height) -> [height*repeat, width*repeat, 3] uint8 on rgb's
    device: pixel (py, px) of the lane's colour, repeated in both axes."""
    img = torch.zeros((height, width, 3), dtype=torch.uint8,
                      device=rgb.device)
    img[lane_py.long(), lane_px.long()] = rgb
    if repeat > 1:
        img = img.repeat_interleave(repeat, 0).repeat_interleave(repeat, 1)
    return img


def _kernel():
    from ..utils.cuda_build import load
    fn = load("image").tpt_unswizzle_upscale
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int64] + 3 * [ctypes.c_void_p] + 3 * [
            ctypes.c_int32] + 2 * [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _prepare(rgb, lane_px, lane_py, width, height, repeat):
    """Check the inputs and allocate the image. Returns (args of the C
    entry without the stream, image)."""
    device = rgb.device
    if device.type != "cuda":
        raise ValueError("unswizzle_upscale kernel: tensors are on %s, not "
                         "a CUDA device" % device)
    width, height, repeat = int(width), int(height), int(repeat)
    if width < 0 or height < 0 or repeat < 1:
        raise ValueError("unswizzle_upscale: width %d, height %d, repeat %d"
                         % (width, height, repeat))
    n = width * height
    require(rgb, "rgb", device, torch.uint8, (n, 3))
    require(lane_px, "lane_px", device, torch.int32, (n,))
    require(lane_py, "lane_py", device, torch.int32, (n,))
    out = torch.empty((height * repeat, width * repeat, 3),
                      dtype=torch.uint8, device=device)
    return (n, rgb.data_ptr(), lane_px.data_ptr(), lane_py.data_ptr(),
            width, height, repeat, out.data_ptr()), out


def _call(fn, args, stream):
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError("unswizzle_upscale kernel launch failed: CUDA "
                           "error %d" % err)


def unswizzle_upscale_cuda(rgb, lane_px, lane_py, width, height, repeat=1):
    """csrc/image.cu on CUDA tensors, on the current stream of their
    device. Returns as unswizzle_upscale_plain."""
    args, out = _prepare(rgb, lane_px, lane_py, width, height, repeat)
    fn = _kernel()
    if args[0]:
        with torch.cuda.device(rgb.device):
            _call(fn, args, torch.cuda.current_stream(rgb.device)
                  .cuda_stream)
        LAUNCHES["unswizzle_upscale"] += 1
    return out


def unswizzle_upscale(rgb, lane_px, lane_py, width, height, repeat=1):
    """The plain version for CPU tensors, the kernel for any other."""
    if rgb.device.type == "cpu":
        return unswizzle_upscale_plain(rgb, lane_px, lane_py, width, height,
                                       repeat)
    return unswizzle_upscale_cuda(rgb, lane_px, lane_py, width, height,
                                  repeat)


def launch_fn(rgb, lane_px, lane_py, width, height, repeat=1):
    """The bare launch, for timing the kernel alone: checks the inputs as
    unswizzle_upscale_cuda (CUDA tensors on the current device) and
    allocates the image once, then returns a function of no arguments that
    launches the kernel into it and returns it, raising on a nonzero code.
    Its launches are not counted in LAUNCHES."""
    device = rgb.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError("launch_fn: the inputs must lie on the current CUDA "
                         "device, not %s" % device)
    args, out = _prepare(rgb, lane_px, lane_py, width, height, repeat)
    fn = _kernel()
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        _call(fn, args, stream)
        return out
    return launch


def io_bytes(n, repeat=1):
    """Bytes a call on n lanes must move: each lane's 3 B of colour and 8 B
    of table read once, its 3*repeat**2 B of image written once."""
    return n * (11 + 3 * repeat * repeat)
