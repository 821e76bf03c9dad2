"""The compaction permute's data movement (`pool_gather`): every pool
column of row i from row src[i] of the segment's outputs. The CUDA kernel
csrc/permute.cu on the card, its plain PyTorch version (a torch.cat of the
16 int32 columns, one row gather of the (P,16) matrix, the split back) on
the CPU.

tracer/regen.py: _compact calls `pool_gather` once a compact wave with the
stable argsort of its key. A CPU tensor goes to the plain version, any
other device to the kernel, which launches once or raises. Nothing falls
back. Both give the same bits: floats move as their 32 bits, rng keeps
its low 32 bits zero-extended, pixel its low 32 bits sign-extended, and
lbn, bounce and medium_id go through the packed word
lb | bn << 8 | (mid + 1) << 16 (so bounce_max <= 127, as
tracer/regen.py: _check_settings requires).

Sources may share memory with destinations (the pool's pixel column
always, its L under scatter_mode "wave", lbn and medium_id where the
segment returns them untouched). The plain version reads every source
into its matrix before it writes; the kernel's wrapper copies each such
source once before the launch, inside the caller's graph capture.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.rng import MASK32
from .checks import require

# Launches of the kernel, counted where the wrapper launches it and
# nowhere else; set back to 0 by whoever reads them.
LAUNCHES = {"pool_gather": 0}
# the pool columns the permute writes, and their dtypes and widths
DST = (("orig", torch.float32, 3), ("dir", torch.float32, 3),
       ("mask", torch.float32, 3), ("L", torch.float32, 3),
       ("bsdf_pdf", torch.float32, 1), ("rng", torch.int64, 1),
       ("pixel", torch.int64, 1), ("lbn", torch.int32, 1),
       ("bounce", torch.int32, 1), ("medium_id", torch.int32, 1))
# the sources, in the order of the arguments after src
SRC = (("o", torch.float32, 3), ("d", torch.float32, 3),
       ("m", torch.float32, 3), ("ell", torch.float32, 3),
       ("pdf", torch.float32, 1), ("rng", torch.int64, 1),
       ("pixel", torch.int64, 1), ("lb", torch.int32, 1),
       ("bn", torch.int32, 1), ("mid", torch.int32, 1))


def pool_gather_plain(st, src, o, d, m, ell, pdf, rng, pixel, lb, bn, mid):
    """Write st's orig, dir, mask, L, bsdf_pdf, rng, pixel, lbn, bounce and
    medium_id at row i from the sources at row src[i], in place."""
    # one row gather moves the packed pool; int32 bits:
    # orig 0:3 | dir 3:6 | mask 6:9 | bsdf_pdf 9 | L 10:13 |
    # rng 13 | pixel 14 | lbn + bounce<<8 + (medium_id+1)<<16 15
    pmat = torch.cat([
        o.view(torch.int32), d.view(torch.int32), m.view(torch.int32),
        pdf[:, None].contiguous().view(torch.int32),
        ell.view(torch.int32), rng.to(torch.int32)[:, None],
        pixel.to(torch.int32)[:, None],
        (lb | (bn << 8) | ((mid + 1) << 16))[:, None]], dim=1)
    moved = pmat[src]
    for k, a, b in (("orig", 0, 3), ("dir", 3, 6), ("mask", 6, 9),
                    ("L", 10, 13)):
        st[k].view(torch.int32).copy_(moved[:, a:b])
    st["bsdf_pdf"].view(torch.int32).copy_(moved[:, 9])
    torch.bitwise_and(moved[:, 13].to(torch.int64), MASK32, out=st["rng"])
    st["pixel"].copy_(moved[:, 14])
    torch.bitwise_and(moved[:, 15], 0xFF, out=st["lbn"])
    torch.bitwise_and(moved[:, 15] >> 8, 0xFF, out=st["bounce"])
    torch.sub(moved[:, 15] >> 16, 1, out=st["medium_id"])


def check(st, src, *sources):
    """Raise unless src is a contiguous int64 [P], each source and each of
    st's columns a contiguous tensor of its dtype and shape (SRC, DST) on
    src's device."""
    if not isinstance(src, torch.Tensor) or src.dim() != 1:
        raise ValueError("src must be a 1-d tensor")
    device, P = src.device, src.shape[0]
    require(src, "src", device, torch.int64, (P,))
    if len(sources) != len(SRC):
        raise TypeError("pool_gather takes %d sources, got %d"
                        % (len(SRC), len(sources)))
    for (name, dtype, w), t in zip(SRC, sources):
        require(t, name, device, dtype, (P, w) if w > 1 else (P,))
    for name, dtype, w in DST:
        require(st[name], name, device, dtype, (P, w) if w > 1 else (P,))


def _span(t):
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def _unaliased(st, sources):
    """The sources, each that shares memory with a pool column replaced by
    a copy of it (decided by address, so a captured graph keeps it)."""
    dst = [_span(st[name]) for name, _, _ in DST if st[name].numel()]
    out = []
    for t in sources:
        lo, hi = _span(t)
        if any(lo < b and a < hi for a, b in dst):
            t = t.clone()
        out.append(t)
    return out


def _kernel():
    from ..utils.cuda_build import load
    fn = load("permute").tpt_pool_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int64] + 22 * [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _prepare(st, src, sources):
    """Check the inputs and copy the aliased sources. Returns the args of
    the C entry without the stream, and the sources it points to (the
    copies among them live only as long as that list)."""
    if src.device.type != "cuda":
        raise ValueError("pool_gather kernel: tensors are on %s, not a CUDA "
                         "device" % src.device)
    check(st, src, *sources)
    sources = _unaliased(st, sources)
    return ((src.shape[0], src.data_ptr())
            + tuple(t.data_ptr() for t in sources)
            + tuple(st[name].data_ptr() for name, _, _ in DST)), sources


def _call(fn, args, stream):
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError("pool_gather kernel launch failed: CUDA error %d"
                           % err)


def pool_gather_cuda(st, src, *sources):
    """csrc/permute.cu on CUDA tensors, on the current stream of their
    device (no host read, so a CUDA graph can capture it): the aliased
    sources copied, then one launch. Writes st as pool_gather_plain."""
    args, _ = _prepare(st, src, sources)
    fn = _kernel()
    if args[0]:
        with torch.cuda.device(src.device):
            _call(fn, args, torch.cuda.current_stream(src.device).cuda_stream)
            LAUNCHES["pool_gather"] += 1


def pool_gather(st, src, o, d, m, ell, pdf, rng, pixel, lb, bn, mid):
    """The plain version for CPU tensors, the kernel for any other; both
    check the inputs first (check)."""
    sources = (o, d, m, ell, pdf, rng, pixel, lb, bn, mid)
    if src.device.type == "cpu":
        check(st, src, *sources)
        pool_gather_plain(st, src, *sources)
    else:
        pool_gather_cuda(st, src, *sources)


def launch_fn(st, src, *sources):
    """The bare launch, for timing the kernel alone: checks the inputs and
    copies the aliased sources once as pool_gather_cuda (CUDA tensors on
    the current device), then returns a function of no arguments that
    launches the kernel, raising on a nonzero code, and returns the
    sources it reads (the copies live as long as the function). Its
    launches are not counted in LAUNCHES."""
    device = src.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError("launch_fn: the inputs must lie on the current CUDA "
                         "device, not %s" % device)
    args, kept = _prepare(st, src, sources)
    fn = _kernel()
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        _call(fn, args, stream)
        return kept
    return launch


def io_bytes(P):
    """Bytes a call on P rows must move: src (8 B) and each source column
    (80 B) read once, each pool column (80 B) written once: 168 B a row."""
    return 168 * P
