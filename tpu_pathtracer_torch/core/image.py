"""Image output/input: tonemapping, PPM/PNG writers, metrics (numpy).

Same quantization as the reference display path: accumulation / frame
count, clamp to [0, 1], gamma 1/2.2, 8-bit quantize (src/Util.h:57).
"""
from __future__ import annotations

import numpy as np


def tonemap(accum, frame_count):
    """accum: float array [H,W,3] of summed radiance; returns uint8 [H,W,3]
    as `int(pow(clamp(x), 1/2.2) * 255 + .5)`."""
    img = np.asarray(accum, dtype=np.float64) / max(int(frame_count), 1)
    img = np.clip(img, 0.0, 1.0)
    img = np.power(img, 1.0 / 2.2)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_ppm(path, accum, frame_count):
    img = tonemap(accum, frame_count)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P3\n%d %d\n%d\n" % (w, h, 255))
        f.write(b"".join(b"%d %d %d " % tuple(px) for px in img.reshape(-1, 3)))


def read_ppm(path):
    with open(path, "rb") as f:
        data = f.read().split()
    if data[0] != b"P3":
        raise ValueError("%s is not a plain (P3) PPM file" % path)
    w, h, maxv = int(data[1]), int(data[2]), int(data[3])
    px = np.array(data[4:4 + w * h * 3], dtype=np.float64).reshape(h, w, 3)
    return px / maxv


def write_png(path, accum, frame_count):
    from PIL import Image   # optional dependency, needed only here
    Image.fromarray(tonemap(accum, frame_count), "RGB").save(path)


def srgb_to_linear(c):
    """sRGB EOTF (the reference binds its colour texture with sRGB=true)."""
    c = np.asarray(c, dtype=np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def rmse(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))
