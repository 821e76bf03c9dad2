"""Radiance .hdr (RGBE) reader/writer (numpy; the port's copy of
scene/hdr.py).

Reads RGBE with new-style RLE scanlines and the old-style run fallback, as
the reference HDR loader does (src/HDRloader.cpp:29); the writer lets tests
and procedural environment maps round-trip through the file format.
"""
from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe):
    """rgbe: uint8 [...,4] -> float32 [...,3]. ldexp(1,e-136) convention:
    v = ldexp(1, e - 128 - 8); rgb = c * v  (matches reference workOnRGBE)."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _float_to_rgbe(rgb):
    """float32 [...,3] -> uint8 [...,4]."""
    rgb = np.asarray(rgb, np.float32)
    maxc = np.max(rgb, axis=-1)
    mant, expo = np.frexp(maxc)
    scale = np.where(maxc > 1e-32, mant * 256.0 / np.where(maxc == 0, 1, maxc), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    vals = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., :3] = vals
    out[..., 3] = np.where(maxc > 1e-32, expo + 128, 0).astype(np.uint8)
    return out


def read_hdr(path):
    """Read a Radiance RGBE file -> float32 [H,W,3]. Supports -Y H +X W
    orientation, RLE and flat scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line; next line is the resolution
    pos = 0
    magic_end = data.find(b"\n")
    if not data[:magic_end].startswith(b"#?"):
        raise ValueError("not a Radiance file: %s" % path)
    pos = magic_end + 1
    while True:
        nl = data.find(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.find(b"\n", pos)
    dims = data[pos:nl].split()
    pos = nl + 1
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError("unsupported orientation %r" % (dims,))
    h, w = int(dims[1]), int(dims[3])

    img = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(h):
        # peek scanline header
        b0, b1, b2, b3 = buf[pos:pos + 4]
        if b0 == 2 and b1 == 2 and ((int(b2) << 8) | int(b3)) == w and w >= 8 and w < 32768:
            pos += 4
            # new-style RLE: 4 separate component streams
            for c in range(4):
                x = 0
                while x < w:
                    count = int(buf[pos]); pos += 1
                    if count > 128:  # run
                        img[y, x:x + count - 128, c] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        img[y, x:x + count, c] = buf[pos:pos + count]
                        pos += count
                        x += count
        else:
            # flat / old-style scanline
            x = 0
            while x < w:
                px = buf[pos:pos + 4]
                if px[0] == 1 and px[1] == 1 and px[2] == 1:
                    # old-style run: repeat previous pixel
                    rep = int(px[3])
                    img[y, x:x + rep] = img[y, x - 1]
                    x += rep
                    pos += 4
                else:
                    img[y, x] = px
                    x += 1
                    pos += 4
    return _rgbe_to_float(img)


def write_hdr(path, rgb):
    """Write float32 [H,W,3] as flat (non-RLE) RGBE."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    rgbe = _float_to_rgbe(rgb)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        f.write(rgbe.tobytes())
