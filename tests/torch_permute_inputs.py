"""Inputs of the compaction permute's pool gather
(`tpu_pathtracer_torch/ops/permute.py`) made from a numpy seed: a pool
state, a source order and the segment's outputs, with the edge values of
every column. Shared by tests/test_torch_permute.py, tests/test_torch_cuda.py
and chip_smoke.py phase 14 (which puts this directory on sys.path). It
imports no jax.

alias names which sources share memory with the pool, as in the regen
wave: "fresh" (only pixel, which is always the pool's own column),
"wave" (L too, scatter_mode "wave"), "untouched" (lbn and medium_id too,
a segment that returns them as they were).

order names the source order: "random" (a random permutation of the
rows) or "wave" (the order tracer/regen.py: _compact builds, a stable
argsort of a key of hit slot and octant with many ties, and 2**30 on the
rows that died or lie past the live prefix).
"""
import numpy as np
import torch

from tpu_pathtracer_torch.ops.permute import DST

ALIASES = ("fresh", "wave", "untouched")
ORDERS = ("random", "wave")
# the largest medium id the packed word carries ((mid + 1) << 16 > 0)
MAX_MEDIUM_ID = 32766
_F32_EDGES = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, -1.0, 1e-45,
                       3.4028235e38], np.float32)


def _floats(g, shape):
    """float32 of shape: random bits (every class, NaN payloads too) on a
    quarter of the entries, the edge values on a quarter, plain floats on
    the rest."""
    n = int(np.prod(shape))
    x = g.standard_normal(n).astype(np.float32)
    pick = g.random(n)
    bits = g.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64).astype(np.int32)
    x = np.where(pick < 0.25, bits.view(np.float32), x)
    x = np.where((pick >= 0.25) & (pick < 0.5),
                 _F32_EDGES[g.integers(0, len(_F32_EDGES), n)], x)
    return x.reshape(shape)


def _ints(g, n, lo, hi, edges):
    x = g.integers(lo, hi + 1, n)
    pick = g.random(n) < 0.3
    return np.where(pick, np.asarray(edges)[g.integers(0, len(edges), n)], x)


def _wave_order(g, P):
    """_compact's order on P rows: hit slots from a few (so keys tie),
    octants, and the 2**30 tail on about a third of the rows."""
    slot = torch.from_numpy(g.integers(-1, max(P // 16, 2), P))
    oct_ = torch.from_numpy(g.integers(0, 8, P))
    last = torch.from_numpy(g.random(P) < 0.3)
    key = torch.where(last, 2 ** 30, (torch.clamp_min(slot, 0) << 3) | oct_)
    return torch.argsort(key, stable=True).numpy()


def pool_inputs(P, seed, device, alias="fresh", order="random"):
    """(st, args): st the pool's ten destination columns (filled, so a
    column the permute fails to write shows), args (src, o, d, m, ell,
    pdf, rng, pixel, lb, bn, mid) for pool_gather. src is the rows in
    `order` (ORDERS); rng has its high 32 bits set on some rows;
    lbn and bounce take 0 and 127, medium_id -1 and MAX_MEDIUM_ID; the
    float columns NaN, +-inf and -0.0; bsdf_pdf -1."""
    g = np.random.default_rng(seed)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(
            device)
    f32, i64, i32 = torch.float32, torch.int64, torch.int32
    st = {k: t(_floats(g, (P, 3)), f32) for k in ("orig", "dir", "mask",
                                                   "L")}
    st["bsdf_pdf"] = t(_floats(g, (P,)), f32)
    st["rng"] = t(g.integers(0, 2 ** 32, P), i64)
    pixel = g.integers(0, 2 ** 21, P)
    wide = g.random(P) < 0.1                 # through int32: any bits
    pixel[wide] = g.integers(-2 ** 63, 2 ** 63 - 1, int(wide.sum()),
                             dtype=np.int64)
    st["pixel"] = t(pixel, i64)
    st["lbn"] = t(_ints(g, P, 0, 127, [0, 127]), i32)
    st["bounce"] = t(_ints(g, P, 0, 127, [0, 127]), i32)
    st["medium_id"] = t(_ints(g, P, -1, MAX_MEDIUM_ID,
                              [-1, MAX_MEDIUM_ID]), i32)
    if order == "random":
        src = t(g.permutation(P), i64)
    elif order == "wave":
        src = t(_wave_order(g, P), i64)
    else:
        raise ValueError("unknown order %r" % (order,))
    o, d, m, ell = (t(_floats(g, (P, 3)), f32) for _ in range(4))
    pdf = _floats(g, (P,))
    pdf[g.random(P) < 0.2] = -1.0
    rng = g.integers(-2 ** 63, 2 ** 63 - 1, P, dtype=np.int64)
    rng[g.random(P) < 0.3] &= 0xFFFFFFFF
    lb = t(_ints(g, P, 0, 127, [0, 127]), i32)
    bn = t(_ints(g, P, 0, 127, [0, 127]), i32)
    mid = t(_ints(g, P, -1, MAX_MEDIUM_ID, [-1, MAX_MEDIUM_ID]), i32)
    if alias == "wave":
        ell = st["L"]
    elif alias == "untouched":
        lb, mid = st["lbn"], st["medium_id"]
    elif alias != "fresh":
        raise ValueError("unknown alias %r" % (alias,))
    return st, (src, o, d, m, ell, t(pdf, f32), t(rng, i64), st["pixel"],
                lb, bn, mid)


def clone_case(st, args):
    """A copy of (st's ten pool columns, args) with the same sharing
    between them."""
    st2 = {k: st[k].clone() for k, _, _ in DST}
    ptrs = {st[k].data_ptr(): k for k in st2}
    args2 = tuple(st2[ptrs[a.data_ptr()]] if a.data_ptr() in ptrs
                  else a.clone() for a in args)
    return st2, args2


def bits(t):
    """A tensor's bits as an integer tensor (floats as int32)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t
