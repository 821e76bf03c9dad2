"""The compaction permute's pool gather (`ops/permute.py: pool_gather`) on
the CPU: the plain version against the cat, row gather and split that
tracer/regen.py: _compact did before the gather became one kernel (a
verbatim copy below), bit for bit, on pools with the edge values of every
column, with sources that share memory with the pool, in a random order
and in the order a wave builds; the checks that
the wrapper makes before any launch; and the regen renders that go
through it.

The kernel itself runs only on the card: the `cuda`-marked tests in
tests/test_torch_cuda.py hold it to the plain version bit for bit, and
chip_smoke.py phase 14 at the main path's widths.
"""
import dataclasses
import functools
import os
import re

import pytest
import torch

from tpu_pathtracer_torch.core.rng import MASK32
from tpu_pathtracer_torch.ops import permute
from tpu_pathtracer_torch.scene import demo
from tpu_pathtracer_torch.tracer import device_loop, regen
from tpu_pathtracer_torch.tracer.renderer import Renderer
from torch_permute_inputs import (
    ALIASES, ORDERS, pool_inputs, clone_case, bits)

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
W = 16


def _old_compact_move(st, src, o, d, m, pdf_new, ell, r, lb, bn, mid):
    """tracer/regen.py: _compact's move of the pool before ops/permute.py,
    verbatim from `pmat = torch.cat(` on."""
    pmat = torch.cat([
        o.view(torch.int32), d.view(torch.int32), m.view(torch.int32),
        pdf_new[:, None].contiguous().view(torch.int32),
        ell.view(torch.int32), r.to(torch.int32)[:, None],
        st["pixel"].to(torch.int32)[:, None],
        (lb | (bn << 8) | ((mid + 1) << 16))[:, None]], dim=1)
    pmat = pmat[src]
    for k, a, b in (("orig", 0, 3), ("dir", 3, 6), ("mask", 6, 9),
                    ("L", 10, 13)):
        st[k].view(torch.int32).copy_(pmat[:, a:b])
    st["bsdf_pdf"].view(torch.int32).copy_(pmat[:, 9])
    torch.bitwise_and(pmat[:, 13].to(torch.int64), MASK32, out=st["rng"])
    st["pixel"].copy_(pmat[:, 14])
    torch.bitwise_and(pmat[:, 15], 0xFF, out=st["lbn"])
    torch.bitwise_and(pmat[:, 15] >> 8, 0xFF, out=st["bounce"])
    torch.sub(pmat[:, 15] >> 16, 1, out=st["medium_id"])


def _old(st, src, o, d, m, ell, pdf, rng, pixel, lb, bn, mid):
    """_old_compact_move with pool_gather's arguments (pixel is
    st["pixel"], which the old code read itself)."""
    assert pixel is st["pixel"]
    _old_compact_move(st, src, o, d, m, pdf, ell, rng, lb, bn, mid)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize("P", [1, 7, 1000, 4096])
def test_plain_pool_gather_equals_the_old_compact(P, alias, order):
    """pool_gather on CPU tensors = the old cat, gather and split, every
    column bit for bit (NaN payloads, -0.0, infinities, bsdf_pdf -1, rng
    with its high bits set, lbn / bounce 0 and 127, medium_id -1 and its
    largest value), with the pool's pixel, L or lbn / medium_id as
    sources, on a random order and on a wave's; it launches nothing."""
    st, args = pool_inputs(P, 1000 * P + len(alias), "cpu", alias, order)
    st2, args2 = clone_case(st, args)
    before = dict(permute.LAUNCHES)
    permute.pool_gather(st, *args)
    _old(st2, *args2)
    assert permute.LAUNCHES == before
    for k in st:
        assert torch.equal(bits(st[k]), bits(st2[k])), k
    # the permute moved the rows: row i holds source row src[i]
    src = args[0]
    assert torch.equal(bits(st["orig"]), bits(args2[1])[src])
    assert torch.equal(st["rng"], args2[6][src] & MASK32)


def _fault(case, st, args):
    """Break one input of (st, args) as `case` names; returns them."""
    src, o, d, m, ell, pdf, rng, pixel, lb, bn, mid = args
    st = dict(st)
    if case == "src_int32":
        src = src.int()
    elif case == "src_2d":
        src = src[:, None]
    elif case == "o_shape":
        o = torch.zeros((o.shape[0], 4))
    elif case == "pdf_float64":
        pdf = pdf.double()
    elif case == "rng_int32":
        rng = rng.int()
    elif case == "mid_strided":
        mid = torch.stack([mid, mid], 1)[:, 0]
    elif case == "dst_L_planes":
        st["L"] = st["L"].t().contiguous().t()
    elif case == "dst_bounce_short":
        st["bounce"] = st["bounce"][:-1]
    elif case == "too_few_sources":
        return st, args[:-1]
    return st, (src, o, d, m, ell, pdf, rng, pixel, lb, bn, mid)


@pytest.mark.parametrize("case", [
    "src_int32", "src_2d", "o_shape", "pdf_float64", "rng_int32",
    "mid_strided", "dst_L_planes", "dst_bounce_short", "too_few_sources"])
def test_pool_gather_refuses_a_wrong_dtype_shape_or_layout(case):
    """A wrong dtype, shape or layout of any input raises before anything
    is written or counted."""
    st, args = pool_inputs(64, 5, "cpu")
    want = {k: v.clone() for k, v in st.items()}
    st, args = _fault(case, st, args)
    before = dict(permute.LAUNCHES)
    with pytest.raises((ValueError, TypeError)):
        permute.pool_gather(st, *args)
    assert permute.LAUNCHES == before
    for k in want:
        if st[k].shape == want[k].shape:
            assert torch.equal(bits(st[k].contiguous()), bits(want[k])), k


def test_the_kernel_wrapper_refuses_cpu_tensors_and_counts_the_launches():
    """pool_gather_cuda and launch_fn take only CUDA tensors; the launch
    counts of a captured wave include the pool gather's; the bound is
    168 B a row."""
    st, args = pool_inputs(8, 6, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        permute.pool_gather_cuda(st, *args)
    with pytest.raises(ValueError, match="CUDA"):
        permute.launch_fn(st, *args)
    assert "pool_gather" in device_loop.launch_counts()
    assert permute.io_bytes(1 << 20) == 168 * (1 << 20)


@functools.lru_cache(maxsize=None)
def _renderer(variant):
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=None,
                                                   variant=variant)
    return Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                    height=W, device="cpu")


@pytest.mark.parametrize("variant,kw", [
    ("default", {}), ("media", {}), ("default", {"scatter_mode": "wave"}),
    ("subsurface", {}), ("default", {"use_distant_light": True}),
    ("default", {"pool_lanes": 64})],
    ids=["default", "media", "wave", "bssrdf", "distant_light",
         "capped_pool"])
def test_regen_render_goes_through_pool_gather_with_the_old_bits(
        variant, kw, monkeypatch):
    """A CPU regen render calls pool_gather once a compact wave and gives
    the image of the same render through the old cat, gather and split,
    bit for bit."""
    r = _renderer(variant)
    base = r.settings
    r.settings = dataclasses.replace(base, **kw)
    rc = demo.default_camera(W, W).build_render_camera()
    calls = []
    real = regen.pool_gather

    def counted(*a, **k):
        calls.append(a[1].shape[0])
        return real(*a, **k)
    try:
        monkeypatch.setattr(regen, "pool_gather", counted)
        got = r.render_frames(r.zeros_accum(), rc, 1, 2)
        waves = r.regen_integrator(False).last_waves
        monkeypatch.setattr(regen, "pool_gather", _old)
        want = r.render_frames(r.zeros_accum(), rc, 1, 2)
    finally:
        r.settings = base
    assert torch.equal(got, want)
    assert len(calls) == sum(waves.values()) > 0
    assert sorted(set(calls)) == sorted(waves)


def test_the_c_entry_takes_what_the_wrapper_passes():
    """csrc/permute.cu's C entry takes n, src, the ten sources, the ten
    pool columns and the stream, as the wrapper passes them; its kernel's
    name holds "gather" (the benchmark's gather_copy_ms_per_frame counts
    kernels by that name)."""
    src = open(os.path.join(os.path.dirname(permute.__file__), os.pardir,
                            "csrc", "permute.cu")).read()
    sig = re.search(r'extern "C" int tpt_pool_gather\(([^)]*)\)', src)
    params = [p.strip() for p in sig.group(1).split(",")]
    assert len(params) == 2 + len(permute.SRC) + len(permute.DST) + 1
    assert params[0] == "int64_t n" and params[-1] == "void* stream"
    assert re.search(r"__global__ void __launch_bounds__\(kBlock\)\s+"
                     r"pool_gather_kernel\(", src)
