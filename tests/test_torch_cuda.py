"""The CUDA kernels (traversal, step-counting traversal, row gather and
scatter, the shade kernel, the surface fetches, the viewer's image, the
compaction permute's pool gather, the BSSRDF probe loop's kernels)
against their plain PyTorch versions, on the card, and the render
paths that launch them (media, BSSRDF, bounce, chunks and shards, the regen
orders, the device tonemap and the viewer's session,
the replayed regen and bounce frames against the eager ones, the stage
marks of a replayed with_stats call).

These tests need an NVIDIA GPU and nvcc; they skip elsewhere. The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: hit/miss agrees on >= 0.999 of lanes, the
hit slot too for closest hit, and t within rtol 1e-5 where slots agree.
The counting kernel's slot and t equal the non-counting kernel's bit for
bit and its steps the plain version's on >= 0.999 of lanes; the row
kernels equal their plain versions exactly (pure data movement). The
`_exact` cases hold slot, t and steps to the plain version bit for bit on
every lane. The shade kernel equals its plain version bit for bit in every
output on every lane that is not a miss (a miss lane's NaN normal gives
values no caller reads), and renders with it equal renders with the plain
shade bit for bit under deterministic algorithms. The surface fetch
kernels equal their plain versions bit for bit in every output on every
lane, a NaN equal to a NaN, and so do renders with them. The image
kernel gives the plain host path's bytes (pure data movement), and so
does the pool gather its plain version's, in every column, and renders
with it the plain version's. The BSSRDF probe loop's kernels give
bssrdf_scatter_plain's bits in every output (is_mul and next_normal on the
loop's lanes, where they hold values), and so do renders with them.
"""
import functools

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.scene import demo
from tpu_pathtracer_torch.tracer import traverse as trav
from tpu_pathtracer_torch.ops import traverse_packet as ops
from tpu_pathtracer_torch.ops import dma_rows
from tpu_pathtracer_torch.ops import shade as shade_ops
from tpu_pathtracer_torch.ops import surface_fetch
from tpu_pathtracer_torch.ops import image as image_ops
from tpu_pathtracer_torch.ops import permute as permute_ops
from torch_shade_inputs import mixed_inputs, kernel_args, plain_shade
from torch_fetch_inputs import (
    kernel_inputs, run_plain, differing_lanes, plain_fetch)
import torch_permute_inputs as permute_inputs
import torch_bssrdf_inputs as bssrdf_inputs

torch.set_num_threads(2)
RAY_MIN, RAY_MAX = 1e-4, 1e20
N = 65536
PREFIX = 397                 # splits a warp


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=1)
def _testobj():
    fb = demo.testobj_scene(cache_dir=None)[0]
    return fb, trav.pack_stream(fb.prims, fb.meta)


def _rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    o[:, 1] = g.uniform(0.2, 3, n)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, g


def _form(form, device, g):
    """(kwargs, mask, tmax tensor, tmax argument) of one traversal form."""
    act = torch.from_numpy(g.random(N) < 0.7).to(device)
    tmax = torch.full((N,), RAY_MAX, device=device)
    if form == "prefix":
        kw, mask = dict(active_prefix=PREFIX), torch.arange(
            N, device=device) < PREFIX
    elif form == "mask_lane_tmax":
        tmax = torch.from_numpy(
            g.uniform(0.5, 6.0, N).astype(np.float32)).to(device)
        kw, mask = dict(active=act), act
    else:
        kw, mask = dict(active=act, anyhit=True), act
    return kw, mask, tmax, tmax if form == "mask_lane_tmax" else RAY_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["prefix", "mask_lane_tmax", "anyhit"])
def test_counting_kernel_matches_plain_on_card(device, form):
    fb, packed = _testobj()
    o, d, g = _rays(N, 11)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    kw, mask, tmax, tmax_arg = _form(form, device, g)
    sd = fb.max_depth + 2
    ks, kt = ops.packet_intersect(packed, o, d, RAY_MIN, tmax_arg,
                                  stack_depth=sd, **kw)
    before = dict(ops.LAUNCHES)
    cs, ct, cn = ops.packet_intersect(packed, o, d, RAY_MIN, tmax_arg,
                                      stack_depth=sd, count_steps=True, **kw)
    torch.cuda.synchronize()
    name = "traverse_anyhit_steps" if form == "anyhit" \
        else "traverse_closest_steps"
    assert ops.LAUNCHES[name] == before[name] + 1
    assert torch.equal(cs, ks) and torch.equal(ct, kt)
    _, _, pn = trav.intersect_scene(None, None, None, o, d, RAY_MIN, tmax_arg,
                                    anyhit=form == "anyhit", stack_depth=sd,
                                    active=mask, packed=packed,
                                    count_steps=True)
    assert cn.dtype == torch.int32
    assert (cn == pn).float().mean().item() >= 0.999
    assert (cn[~mask] == 0).all().item()
    assert (cn[mask] > 0).all().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wide", "flat", "batch8", "scatter"])
def test_dma_kernels_match_plain_on_card(device, case):
    P, C = 8192, (0 if case == "flat" else 128)
    g = np.random.default_rng(3)
    tab = torch.from_numpy(g.standard_normal(
        P * 16 if C == 0 else (P, C)).astype(np.float32)).to(device)
    if case == "batch8":
        idx = (g.permutation(P // 8)[:, None] * 8 + np.arange(8)).reshape(-1)
    else:
        idx = g.permutation(P)
    idx = torch.from_numpy(idx.astype(np.int32)).to(device)
    rows = tab.view(P, C or 16)
    before = dict(dma_rows.LAUNCHES)
    if case == "scatter":
        got = dma_rows.make_dma_scatter(P, C, chunk=1024)(tab, idx)
        want = dma_rows.scatter_rows_plain(rows, idx)
        name = "dma_scatter"
    else:
        batch = 8 if case == "batch8" else 1
        got = dma_rows.make_dma_gather(P, C, chunk=1024, batch=batch)(tab, idx)
        want = dma_rows.gather_rows_plain(rows, idx, batch).reshape(tab.shape)
        name = "dma_gather"
    torch.cuda.synchronize()
    assert dma_rows.LAUNCHES[name] == before[name] + 1
    assert got.device == tab.device
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_dma_wrapper_raises_on_card_indices_out_of_range(device):
    tab = torch.zeros((1024, 16), device=device)
    idx = torch.arange(1024, dtype=torch.int32, device=device)
    idx[5] = 1024
    with pytest.raises(IndexError):
        dma_rows.make_dma_gather(1024, 16, chunk=512)(tab, idx)
    with pytest.raises(IndexError):
        dma_rows.make_dma_scatter(1024, 16, chunk=512)(tab, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["prefix", "mask_lane_tmax", "anyhit"])
def test_kernel_matches_plain_on_card(device, form):
    fb, packed = _testobj()
    o, d, g = _rays(N, 7)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    kw, mask, tmax, tmax_arg = _form(form, device, g)
    anyhit = kw.get("anyhit", False)
    sd = fb.max_depth + 2
    before = dict(ops.LAUNCHES)
    ks, kt = ops.packet_intersect(packed, o, d, RAY_MIN, tmax_arg,
                                  stack_depth=sd, **kw)
    torch.cuda.synchronize()
    name = "traverse_anyhit" if anyhit else "traverse_closest"
    assert ops.LAUNCHES[name] == before[name] + 1
    ps, pt = trav.intersect_scene(None, None, None, o, d, RAY_MIN, tmax_arg,
                                  anyhit=anyhit, stack_depth=sd, active=mask,
                                  packed=packed)
    assert ((ks >= 0) == (ps >= 0)).float().mean().item() >= 0.999
    if not anyhit:
        same = ks == ps
        assert same.float().mean().item() >= 0.999
        torch.testing.assert_close(kt[same], pt[same], rtol=1e-5, atol=0.0)
    out = ~mask
    assert (ks[out] == -1).all().item()
    assert torch.equal(kt[out], tmax[out])


def _soup_stream():
    """A random soup of 20,000 triangles through the port's accel: a stream
    of ~32k rows and a tree deeper than the TestObj one."""
    from tpu_pathtracer_torch.accel.flatten import flatten_mesh_bvh
    from tpu_pathtracer_torch.scene.mesh import TriangleMesh
    g = np.random.default_rng(5)
    n = 20000
    c = g.uniform(-3.0, 3.0, (n, 1, 3))
    v = (c + g.normal(scale=0.2, size=(n, 3, 3))).astype(np.float32)
    mesh = TriangleMesh(
        vertices=v.reshape(-1, 3),
        indices=np.arange(3 * n, dtype=np.int32).reshape(n, 3),
        uv=np.zeros((n, 3, 2), np.float32),
        normals=np.zeros((n, 3, 3), np.float32),
        material_ids=np.zeros(n, np.int32))
    fb = flatten_mesh_bvh(mesh)
    return fb, trav.pack_stream(fb.prims, fb.meta)


def _exact(packed, o, d, tmax, sd, anyhit=False, active=None, prefix=None):
    """Kernel (with and without the count) against the plain version, bit
    for bit on every lane: slot, t and steps."""
    n = o.shape[0]
    mask = active
    if prefix is not None:
        mask = torch.arange(n, device=o.device) < prefix
    kw = dict(active=active, active_prefix=prefix, anyhit=anyhit,
              stack_depth=sd)
    ks, kt = ops.packet_intersect(packed, o, d, RAY_MIN, tmax, **kw)
    cs, ct, cn = ops.packet_intersect(packed, o, d, RAY_MIN, tmax,
                                      count_steps=True, **kw)
    ps, pt, pn = trav.intersect_scene(None, None, None, o, d, RAY_MIN, tmax,
                                      anyhit=anyhit, stack_depth=sd,
                                      active=mask, packed=packed,
                                      count_steps=True)
    torch.cuda.synchronize()
    for got in ((ks, kt), (cs, ct)):
        assert torch.equal(got[0], ps) and torch.equal(got[1], pt)
    assert torch.equal(cn, pn)
    return cn


@pytest.mark.cuda
@pytest.mark.parametrize("anyhit", [False, True])
def test_kernel_exact_on_deep_soup_stream(device, anyhit):
    fb, packed = _soup_stream()
    sd = fb.max_depth + 2
    assert sd > 16                          # deeper than TestObj's tree
    o, d, g = _rays(N, 13)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    act = torch.from_numpy(g.random(N) < 0.7).to(device)
    _exact(packed, o, d, RAY_MAX, sd, anyhit=anyhit,
           active=act if anyhit else None)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 397, 4096])
def test_kernel_exact_at_small_and_ragged_sizes(device, n):
    fb, packed = _testobj()
    o, d, g = _rays(max(n, 1), 17)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    o, d = o[:n].contiguous(), d[:n].contiguous()
    sd = fb.max_depth + 2
    if n == 0:
        s, t = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX,
                                    stack_depth=sd)
        assert s.shape == (0,) and t.shape == (0,)
        return
    _exact(packed, o, d, RAY_MAX, sd, prefix=max(n - 3, 0))
    tmax = torch.from_numpy(g.uniform(0.5, 6.0, n).astype(np.float32)) \
        .to(device)
    act = torch.from_numpy(g.random(n) < 0.6).to(device)
    _exact(packed, o, d, tmax, sd, active=act)


@pytest.mark.cuda
def test_kernel_exact_with_dropped_pushes(device):
    """stack_depth=1: every push past the first is dropped, in the kernel
    as in the plain version."""
    fb, packed = _testobj()
    o, d, _ = _rays(N, 19)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    _exact(packed, o, d, RAY_MAX, 1)
    _exact(packed, o, d, RAY_MAX, 1, anyhit=True)


@pytest.mark.cuda
def test_two_launches_give_identical_outputs(device):
    fb, packed = _testobj()
    o, d, g = _rays(N, 23)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    act = torch.from_numpy(g.random(N) < 0.5).to(device)
    sd = fb.max_depth + 2
    a = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX, stack_depth=sd,
                             active=act, anyhit=True, count_steps=True)
    b = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX, stack_depth=sd,
                             active=act, anyhit=True, count_steps=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_measured_warp_steps_equal_the_pool_order_model(device):
    """The counting kernel's warp-steps on the card are the census model
    of warps in lane order: the kernel walks one ray per thread."""
    from tpu_pathtracer_torch.tools import probe_steps
    fb, packed = _testobj()
    o, d, g = _rays(N, 29)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    act = torch.from_numpy(g.random(N) < 0.7).to(device)
    steps = _exact(packed, o, d, RAY_MAX, fb.max_depth + 2, active=act)
    c = probe_steps.census(steps, act)
    assert int(ops.last_warp_steps()) == c["warp_steps"]


@pytest.mark.cuda
def test_refused_launch_is_reported_and_raised(device, monkeypatch):
    """tpt_traverse returns the code of a launch it refuses (here a stack
    deeper than the kernel's, or a table of more rows than fit), and the
    wrapper raises on any nonzero code."""
    fb, packed = _testobj()
    o, d, _ = _rays(64, 31)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    slot = torch.empty(64, dtype=torch.int32, device=device)
    t = torch.empty(64, dtype=torch.float32, device=device)
    def entry(stack_depth, table_rows):
        return ops._lib().tpt_traverse(
            packed.data_ptr(), o.data_ptr(), d.data_ptr(), RAY_MIN, RAY_MAX,
            None, 64, None, None, 64, stack_depth, 0, table_rows,
            slot.data_ptr(),
            t.data_ptr(), None, None,
            torch.cuda.current_stream().cuda_stream)
    err = entry(ops.MAX_STACK_DEPTH + 1, 0)
    assert err != 0
    assert entry(8, ops.TABLE_MAX_ROWS + 1) != 0
    assert entry(8, -1) != 0
    assert entry(fb.max_depth + 2, ops.TABLE_MAX_ROWS) == 0

    class Refusing:
        @staticmethod
        def tpt_traverse(*args):
            return err
    monkeypatch.setattr(ops, "_lib", lambda: Refusing)
    before = dict(ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX, stack_depth=4)
    assert ops.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("count", [False, True])
def test_bare_launch_equals_the_wrapper_and_counts_nothing(device, count):
    """ops.launch_fn (the bare C entry, for timing) gives the wrapper's
    outputs on every lane and leaves the launch counts as they were."""
    fb, packed = _testobj()
    o, d, g = _rays(N, 41)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    act = torch.from_numpy(g.random(N) < 0.5).to(device)
    kw = dict(active=act, anyhit=True, stack_depth=fb.max_depth + 2,
              count_steps=count)
    want = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX, **kw)
    before = dict(ops.LAUNCHES)
    launch = ops.launch_fn(packed, o, d, RAY_MIN, RAY_MAX, **kw)
    for _ in range(2):
        got = launch()
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert ops.LAUNCHES == before


@functools.lru_cache(maxsize=1)
def _large():
    """A ~17k-row stream (over the JAX package's SMEM budget: `split`)."""
    fb = demo.large_scene(cache_dir=None, n_lat=40, n_lon=80,
                          ground_div=12)[0]
    return fb, trav.pack_stream(fb.prims, fb.meta)


@pytest.mark.cuda
@pytest.mark.parametrize("stream,table_mem", [("testobj", "smem"),
                                              ("testobj", "split"),
                                              ("large", "split")])
@pytest.mark.parametrize("form", ["prefix", "mask_lane_tmax", "anyhit"])
def test_table_kernel_matches_plain_and_ldg_exact(device, form, stream,
                                                  table_mem):
    """The shared-memory-table instantiations: slot, t, steps and the
    measured warp-steps equal the plain version's and the __ldg kernel's on
    every lane, with and without the count."""
    fb, packed = _testobj() if stream == "testobj" else _large()
    o, d, g = _rays(N, 31)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    kw, mask, tmax, tmax_arg = _form(form, device, g)
    sd = fb.max_depth + 2
    assert ops.table_plan(packed.shape[0], N, table_mem)[0] == ops.TABLE_ROWS
    before = dict(ops.LAUNCHES)
    tab = ops.packet_intersect(packed, o, d, RAY_MIN, tmax_arg,
                               stack_depth=sd, count_steps=True,
                               table_mem=table_mem, **kw)
    w_tab = int(ops.last_warp_steps())
    tab2 = ops.packet_intersect(packed, o, d, RAY_MIN, tmax_arg,
                                stack_depth=sd, table_mem=table_mem, **kw)
    kind = "anyhit" if form == "anyhit" else "closest"
    assert ops.LAUNCHES["traverse_%s_table_steps" % kind] == \
        before["traverse_%s_table_steps" % kind] + 1
    assert ops.LAUNCHES["traverse_%s_table" % kind] == \
        before["traverse_%s_table" % kind] + 1
    ldg = ops.packet_intersect(packed, o, d, RAY_MIN, tmax_arg,
                               stack_depth=sd, count_steps=True,
                               table_mem="vmem", **kw)
    w_ldg = int(ops.last_warp_steps())
    plain = trav.intersect_scene(None, None, None, o, d, RAY_MIN, tmax_arg,
                                 anyhit=form == "anyhit", stack_depth=sd,
                                 active=mask, packed=packed,
                                 count_steps=True)
    torch.cuda.synchronize()
    for a, b, c in zip(tab, ldg, plain):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(tab2[0], tab[0]) and torch.equal(tab2[1], tab[1])
    assert w_tab == w_ldg > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 397, 4096])
@pytest.mark.parametrize("rows", [1, 8, None, 288])
def test_table_kernel_small_launches_and_table_sizes(device, n, rows):
    """Every lane count around a warp and a block, and every table size
    from one row to all that fit, gives the __ldg kernel's bits."""
    fb, packed = _large()
    o, d, _ = _rays(n, 32)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    sd = fb.max_depth + 2
    want = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX,
                                stack_depth=sd, count_steps=True,
                                table_mem="vmem")
    got = ops.launch_fn(packed, o, d, RAY_MIN, RAY_MAX, stack_depth=sd,
                        count_steps=True, table_mem="split",
                        table_rows=rows)()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_table_kernel_short_stream_and_refused_rows(device):
    """A stream shorter than the plan's table is resident as a whole; more
    rows than fit, or any rows where the plan has no table, raise."""
    packed = _small_stream()
    K = packed.shape[0]
    assert K < ops.TABLE_ROWS
    o, d, _ = _rays(4096, 33)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    assert ops.table_plan(K, 4096, "smem") == (K, ops.BLOCK, K * 64)
    a = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX, stack_depth=8,
                             count_steps=True, table_mem="smem")
    b = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX, stack_depth=8,
                             count_steps=True, table_mem="vmem")
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="table_rows"):
        ops.launch_fn(packed, o, d, RAY_MIN, RAY_MAX, stack_depth=8,
                      table_mem="smem", table_rows=K + 1)
    with pytest.raises(ValueError, match="table_rows"):
        ops.launch_fn(packed, o, d, RAY_MIN, RAY_MAX, stack_depth=8,
                      table_mem="vmem", table_rows=4)


def _small_stream():
    """A 12-triangle box: a stream of a few dozen rows."""
    from tpu_pathtracer_torch.scene import procedural
    from tpu_pathtracer_torch.accel import flatten_mesh_bvh
    fb = flatten_mesh_bvh(procedural.make_box((0.0, 1.0, 0.0), 1.5, 0))
    return trav.pack_stream(fb.prims, fb.meta)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["media", "subsurface"])
def test_media_and_bssrdf_render_on_card(device, variant):
    """The media, BSSRDF and distant-light branches of the wave on the
    card: the image equals the CPU render of the same samples under the
    gate statistics (median |diff| < 1e-4, mean within 1%, RMSE < 0.1),
    with the table resident too, and the BSSRDF probes launch the mask +
    per-lane-tmax form."""
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=None,
                                                   variant=variant)
    W = 48
    rc = demo.default_camera(W, W).build_render_camera()
    imgs = {}
    for dev, tm in (("cpu", "auto"), (device, "auto"), (device, "smem")):
        s = RenderSettings(has_media=variant == "media",
                           has_bssrdf=variant == "subsurface",
                           use_distant_light=True, packet_table_mem=tm)
        r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                     height=W, settings=s, device=dev)
        before = dict(ops.FORM_LAUNCHES)
        acc = r.render_frames(r.zeros_accum(), rc, 1, 4)
        imgs[(str(dev), tm)] = r.accum_to_buffer(acc / 4)
        probes = ops.FORM_LAUNCHES["closest_mask_lane_tmax"] \
            - before["closest_mask_lane_tmax"]
        assert (probes > 0) == (variant == "subsurface" and dev != "cpu")
    want = imgs[("cpu", "auto")]
    for key, img in imgs.items():
        dabs = np.abs(img - want)
        assert np.all(np.isfinite(img)), key
        assert float(np.median(dabs)) < 1e-4, key
        assert abs(img.mean() / want.mean() - 1.0) < 0.01, key
        assert float(np.sqrt((dabs ** 2).mean())) < 0.1, key


def _gate(img, want, key=""):
    dabs = np.abs(img - want)
    assert np.all(np.isfinite(img)), key
    assert float(np.median(dabs)) < 1e-4, key
    assert abs(img.mean() / want.mean() - 1.0) < 0.01, key
    assert float(np.sqrt((dabs ** 2).mean())) < 0.1, key


def _bounce_renderer(dev, W, variant="default", **kw):
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=None,
                                                   variant=variant)
    s = RenderSettings(integrator="bounce",
                       has_media=variant == "media",
                       has_bssrdf=variant == "subsurface")
    return Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                    height=W, settings=s, device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["default", "media", "subsurface"])
def test_bounce_on_card_matches_cpu(device, variant):
    """The bounce integrator on the card: the CPU render of the same
    samples under the gate statistics; closest hit (full-width mask) and
    any hit launch, and the BSSRDF probes launch the per-lane-tmax form."""
    W = 48
    rc = demo.default_camera(W, W).build_render_camera()
    imgs = {}
    for dev in ("cpu", device):
        r = _bounce_renderer(dev, W, variant)
        before = {**ops.LAUNCHES, **ops.FORM_LAUNCHES}
        acc = r.render_frames(r.zeros_accum(), rc, 1, 4)
        imgs[str(dev)] = r.accum_to_buffer(acc / 4)
        after = {**ops.LAUNCHES, **ops.FORM_LAUNCHES}
        if dev != "cpu":
            for k in ("traverse_closest", "traverse_anyhit"):
                assert after[k] > before[k], k
            probes = after["closest_mask_lane_tmax"] \
                - before["closest_mask_lane_tmax"]
            assert (probes > 0) == (variant == "subsurface")
    _gate(imgs[str(device)], imgs["cpu"], variant)


@pytest.mark.cuda
def test_bounce_chunks_and_shards_on_card_match_the_whole(device):
    """Chunked bounce and 2 shards on one card give the whole render bit
    for bit; 2 regen shards give it under the gate statistics."""
    from tpu_pathtracer_torch.parallel import ShardedRenderer, make_mesh
    W = 64
    rc = demo.default_camera(W, W).build_render_camera()
    whole = _bounce_renderer(device, W)
    a = whole.render_frames(whole.zeros_accum(), rc, 1, 2)
    chunked = _bounce_renderer(device, W, lane_chunk=1000)
    assert torch.equal(chunked.render_frames(chunked.zeros_accum(), rc, 1,
                                             2), a)
    sr = ShardedRenderer(whole, mesh=make_mesh([device, device]))
    assert torch.equal(sr.render_frames(sr.zeros_accum(), rc, 1, 2)
                       [:W * W], a)
    import dataclasses
    regen = _bounce_renderer(device, W)
    regen.settings = dataclasses.replace(regen.settings, integrator="regen")
    b = regen.render_frames(regen.zeros_accum(), rc, 1, 2)
    sr = ShardedRenderer(regen, mesh=make_mesh([device, device]))
    c = sr.render_frames(sr.zeros_accum(), rc, 1, 2)[:W * W]
    _gate(regen.accum_to_buffer(c), regen.accum_to_buffer(b), "regen")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(regen_order="inplace")],
                         ids=["inplace"])
def test_regen_orders_on_card(device, kw):
    """inplace gives the compact image under the gate statistics on the
    card."""
    import dataclasses
    W = 64
    rc = demo.default_camera(W, W).build_render_camera()
    r = _bounce_renderer(device, W)
    base = dataclasses.replace(r.settings, integrator="regen")
    r.settings = base
    a = r.render_frames(r.zeros_accum(), rc, 1, 2)
    r.settings = dataclasses.replace(base, **kw)
    b = r.render_frames(r.zeros_accum(), rc, 1, 2)
    _gate(r.accum_to_buffer(b), r.accum_to_buffer(a), "inplace")


def _regen_renderer(dev, W):
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=None)
    return Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                    height=W, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 6])
def test_device_tonemap_on_card_matches_the_host_path(device, frames):
    """Renderer.accum_to_image of a CUDA tensor tonemaps on the card and
    reads back uint8: at most one step from the host f64 path, at least
    99.9% of the pixels equal."""
    W = 64
    r = _regen_renderer(device, W)
    g = np.random.default_rng(frames)
    acc = (g.random((W * W, 3)) * 1.3 * frames).astype(np.float32)
    dev_img = r.accum_to_image(torch.from_numpy(acc).to(device), frames)
    host = r.accum_to_image(acc, frames)
    assert dev_img.dtype == np.uint8 and dev_img.shape == (W, W, 3)
    d = np.abs(dev_img.astype(np.int32) - host.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


@pytest.mark.cuda
def test_viewer_session_on_card(device, tmp_path):
    """A scripted viewer session at 64x64 on the card: the previews and the
    converging steps are Renderer.render_frames of the same cameras (bit
    for bit under the deterministic algorithms) through the plain host
    path's tonemap, un-swizzle and upscale, launching both traversal
    kernels."""
    from tpu_pathtracer_torch.tools import interactive as viewer
    W = 64
    parts = demo.testobj_scene(cache_dir=None)
    r = _regen_renderer(device, W)
    lo = viewer.preview_renderer(r, parts, 2)
    t = [0.0]
    s = viewer.ViewerSession(r, demo.default_camera(W, W), lo, batch=2,
                             cam_path=str(tmp_path / "v.cam"),
                             out_dir=str(tmp_path), clock=lambda: t[0])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        before = dict(ops.LAUNCHES)
        img = s.step(["LEFT"])
        assert s.kind == "preview"
        want = _host_image(
            lo.render_frames(lo.zeros_accum(), s.camera, 1, 1), 1, W // 2,
            W // 2, 2)
        np.testing.assert_array_equal(img, want)
        t[0] = 1.0
        acc = r.zeros_accum()
        for _ in range(2):
            img = s.step([])
            assert s.kind == "full"
            acc = r.render_frames(acc, s.camera, s.frame - 1, 2)
            np.testing.assert_array_equal(
                img, _host_image(acc, s.frame, W, W, 1))
        for k in ("traverse_closest", "traverse_anyhit"):
            assert ops.LAUNCHES[k] > before[k], k
    finally:
        torch.use_deterministic_algorithms(False)
    s.close()
    assert (tmp_path / "output500.ppm").exists()


# ---- the viewer's image on the card (ops/image.py, csrc/image.cu) ----

def _host_image(acc, frames, width, height, repeat):
    """The plain host path of Renderer.accum_to_image: the device tonemap's
    uint8 lanes copied to the host, scattered through lane_tables in
    numpy, then np.repeat."""
    from tpu_pathtracer_torch.tracer.renderer import lane_tables
    x = torch.clamp(acc[:width * height] / float(max(frames, 1)), 0.0, 1.0)
    u8 = (torch.pow(x, 1.0 / 2.2) * 255.0 + 0.5).to(torch.uint8)
    px, py = lane_tables(width, height)
    img = np.zeros((height, width, 3), np.uint8)
    img[py, px] = u8.cpu().numpy()
    return img.repeat(repeat, 0).repeat(repeat, 1)


@functools.lru_cache(maxsize=None)
def _image_renderer(W, H):
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=None)
    return Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                    height=H, device=torch.device("cuda"))


def _image_lanes(W, H, seed):
    """(rgb [n,3] uint8, lane_px, lane_py) on the card."""
    from tpu_pathtracer_torch.tracer.renderer import lane_tables
    g = np.random.default_rng(seed)
    rgb = torch.from_numpy(g.integers(0, 256, (W * H, 3), dtype=np.uint8))
    px, py = lane_tables(W, H)
    return tuple(t.cuda() for t in (rgb, torch.from_numpy(px),
                                    torch.from_numpy(py)))


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 6])
@pytest.mark.parametrize("size,repeat", [
    ((64, 64), 1), ((64, 64), 2), ((64, 64), 3), ((960, 540), 1),
    ((960, 540), 2), ((1920, 1080), 1), ((1920, 1080), 2)])
def test_image_kernel_equals_the_host_path_on_card(device, size, repeat,
                                                   frames):
    """Renderer.accum_to_image of a CUDA accumulation through the kernel:
    the plain host path's bytes, bit for bit, and the plain version's on
    the card; one launch a call."""
    W, H = size
    r = _image_renderer(W, H)
    g = np.random.default_rng(frames * 7 + repeat)
    acc = torch.from_numpy((g.random((W * H, 3)) * 1.3 * frames).astype(
        np.float32)).to(device)
    acc[:50] = 0.0
    acc[50:60] = 10.0 * frames
    before = image_ops.LAUNCHES["unswizzle_upscale"]
    img = r.accum_to_image(acc, frames, repeat=repeat)
    assert image_ops.LAUNCHES["unswizzle_upscale"] == before + 1
    assert img.dtype == np.uint8 and img.shape == (H * repeat, W * repeat,
                                                   3)
    np.testing.assert_array_equal(img, _host_image(acc, frames, W, H,
                                                   repeat))
    rgb, px, py = _image_lanes(W, H, frames + repeat)
    got = image_ops.unswizzle_upscale(rgb, px, py, W, H, repeat)
    assert got.device.type == "cuda"
    assert torch.equal(got, image_ops.unswizzle_upscale_plain(
        rgb, px, py, W, H, repeat))


@pytest.mark.cuda
def test_image_bare_launch_equals_the_wrapper_and_counts_nothing(device):
    rgb, px, py = _image_lanes(96, 40, 3)
    want = image_ops.unswizzle_upscale_cuda(rgb, px, py, 96, 40, 2)
    before = dict(image_ops.LAUNCHES)
    launch = image_ops.launch_fn(rgb, px, py, 96, 40, 2)
    for _ in range(2):
        out = launch()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert image_ops.LAUNCHES == before


@pytest.mark.cuda
def test_image_refused_calls_raise(device, monkeypatch):
    """A wrong dtype or shape, a table on the host: ValueError before any
    launch; sizes the C entry does not take: -1 from it; a nonzero code
    from the C entry: RuntimeError. Nothing is counted."""
    rgb, px, py = _image_lanes(64, 64, 0)
    before = dict(image_ops.LAUNCHES)
    for call, match in (
            (lambda: image_ops.unswizzle_upscale(rgb.int(), px, py, 64, 64),
             "dtype"),
            (lambda: image_ops.unswizzle_upscale(rgb, px.cpu(), py, 64, 64),
             "cpu"),
            (lambda: image_ops.unswizzle_upscale(rgb, px, py, 64, 32),
             "shape"),
            (lambda: image_ops.unswizzle_upscale(rgb, px, py, 64, 64, 0),
             "repeat")):
        with pytest.raises(ValueError, match=match):
            call()
    fn = image_ops._kernel()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((64, 64, 3), dtype=torch.uint8, device=device)
    ptrs = (rgb.data_ptr(), px.data_ptr(), py.data_ptr())
    assert fn(64 * 64, *ptrs, 64, 32, 1, out.data_ptr(), stream) == -1
    assert fn(64 * 64, *ptrs, 64, 64, 0, out.data_ptr(), stream) == -1
    monkeypatch.setattr(image_ops, "_kernel", lambda: (lambda *a: 7))
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        image_ops.unswizzle_upscale(rgb, px, py, 64, 64, 2)
    assert image_ops.LAUNCHES == before


@pytest.mark.cuda
def test_viewer_steps_launch_the_image_kernel_once_and_keep_their_images(
        device, tmp_path):
    """One kernel launch a preview step and one a full step; an image that
    a step returned is unchanged after the next steps (each is its own
    pinned host memory)."""
    from tpu_pathtracer_torch.tools import interactive as viewer
    W = 64
    r = _regen_renderer(device, W)
    lo = viewer.preview_renderer(r, demo.testobj_scene(cache_dir=None), 2)
    t = [0.0]
    s = viewer.ViewerSession(r, demo.default_camera(W, W), lo, batch=2,
                             cam_path=str(tmp_path / "v.cam"),
                             out_dir=str(tmp_path), clock=lambda: t[0])
    kept = []
    for events, kind in ((["LEFT"], "preview"), (["w"], "preview"),
                         ([], "full"), ([], "full")):
        t[0] = 0.0 if kind == "preview" else t[0] + 1.0
        before = image_ops.LAUNCHES["unswizzle_upscale"]
        img = s.step(events)
        assert s.kind == kind
        assert image_ops.LAUNCHES["unswizzle_upscale"] == before + 1
        assert img.shape == (W, W, 3) and img.dtype == np.uint8
        kept.append((img, img.copy()))
    for img, copy in kept:
        np.testing.assert_array_equal(img, copy)
    assert not np.array_equal(kept[0][0], kept[1][0])


@pytest.mark.cuda
def test_viewer_step_copies_its_image_once_into_pinned_memory(device,
                                                              tmp_path):
    """A preview step and a full step each copy one full-size image from
    the device, into pinned memory: no preview-size copy, nothing into
    pageable memory (the device traces' memcpy events)."""
    from tpu_pathtracer_torch.tools import interactive as viewer
    W = 64
    r = _regen_renderer(device, W)
    lo = viewer.preview_renderer(r, demo.testobj_scene(cache_dir=None), 2)
    t = [0.0]
    s = viewer.ViewerSession(r, demo.default_camera(W, W), lo, batch=2,
                             cam_path=str(tmp_path / "v.cam"),
                             out_dir=str(tmp_path), clock=lambda: t[0])
    s.step(["LEFT"])                     # captures the preview's graphs
    t[0] = 1.0
    s.step([])                           # and the full step's
    for events, kind, now in ((["RIGHT"], "preview", 2.0),
                              ([], "full", 3.0)):
        t[0] = now
        copies = _kernel_events(lambda: s.step(events), tmp_path,
                                "gpu_memcpy")
        assert s.kind == kind
        dtoh = [e for e in copies if e["name"].startswith("Memcpy DtoH")]
        sizes = [e["args"].get("bytes") for e in dtoh]
        image = [e for e in dtoh if e["args"].get("bytes") == W * W * 3]
        assert len(image) == 1, (kind, sizes)
        assert "Pinned" in image[0]["name"], image[0]["name"]
        assert W * W * 3 // 4 not in sizes, (kind, sizes)
        assert not any("Pageable" in e["name"] for e in dtoh), \
            [e["name"] for e in dtoh]


# ---- the regen frame as one device program: the device prefix, the
# captured wave and its replays ----

@pytest.mark.cuda
@pytest.mark.parametrize("form", ["closest", "anyhit", "steps", "table"])
def test_device_prefix_launch_equals_int_prefix(device, form):
    """Rows 1, 2, 4 and 6 with the prefix read from device memory: slot, t
    (and steps) equal the int-prefix launch on every lane, through the
    wrapper and the bare launch, at prefixes that split a warp, 0 and N."""
    fb, packed = _testobj()
    o, d, _ = _rays(N, 29)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    kw = dict(stack_depth=fb.max_depth + 2, anyhit=form == "anyhit",
              count_steps=form == "steps",
              table_mem="smem" if form == "table" else "auto")
    for n in (0, PREFIX, N - 5, N):
        pre = torch.tensor(n, dtype=torch.int32, device=device)
        want = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX,
                                    active_prefix=n, **kw)
        got = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX,
                                   active_prefix=pre, **kw)
        bare = ops.launch_fn(packed, o, d, RAY_MIN, RAY_MAX,
                             active_prefix=pre, **kw)()
        torch.cuda.synchronize()
        for a, b, c in zip(want, got, bare):
            assert torch.equal(a, b) and torch.equal(a, c), (form, n)
        assert (want[0][n:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("anyhit", [False, True])
def test_kernel_exact_at_the_deepest_stack(device, anyhit):
    """stack_depth = MAX_DEPTH + 2 = 66, the most a Renderer hands the
    kernel: slot, t and steps equal the plain version on every lane."""
    assert ops.MAX_STACK_DEPTH == 66
    fb, packed = _soup_stream()
    o, d, g = _rays(N, 37)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    act = torch.from_numpy(g.random(N) < 0.7).to(device)
    _exact(packed, o, d, RAY_MAX, 66, anyhit=anyhit,
           active=act if anyhit else None)


def _graph_case(case, device):
    """(renderer, camera) of one graph-vs-eager case at 64x64."""
    import dataclasses
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    W = 64
    variant = {"media": "media", "bssrdf": "subsurface"}.get(case,
                                                            "default")
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=None,
                                                   variant=variant)
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=W, lane_chunk=W * W // 4 if case == "chunks4"
                 else None, device=device)
    kw = {"inplace": dict(regen_order="inplace"),
          "distant_light": dict(use_distant_light=True)}.get(case, {})
    r.settings = dataclasses.replace(r.settings, **kw)
    return r, demo.default_camera(W, W).build_render_camera()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "inplace", "media",
                                  "bssrdf", "distant_light", "chunks4"])
def test_graph_frame_equals_no_graphs_bit_for_bit(device, case):
    """The replayed regen frame equals the eager one
    (device_loop.no_graphs()) bit for bit under torch's deterministic
    algorithms, with the same waves and rays, and launches the same
    kernels as often."""
    from tpu_pathtracer_torch.tracer import device_loop
    r, rc = _graph_case(case, device)

    def render():
        for table in (ops.LAUNCHES, ops.FORM_LAUNCHES):
            for k in table:
                table[k] = 0
        out = r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
        torch.cuda.synchronize()
        return out, {**ops.LAUNCHES, **ops.FORM_LAUNCHES}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with device_loop.no_graphs():
            (want, w_waves, w_rays), w_counts = render()
        render()                                     # captures
        (got, waves, rays), counts = render()
        captured = r.regen_integrator(True).graph
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(got, want), case
    assert (waves, rays) == (w_waves, w_rays)
    assert counts == w_counts and counts["traverse_closest"] > 0
    assert captured is not None, "no wave was captured"


def _kernel_events(fn, tmp_path, cat="kernel"):
    """The device kernels (or the events of another device category,
    `cat`) of fn() under torch.profiler, in start order."""
    import json
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == cat), key=lambda e: e["ts"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "bssrdf", "media"])
def test_replayed_stats_call_carries_the_stage_marks(device, case,
                                                     tmp_path):
    """A replayed with_stats call's trace holds the pt_stage_* kernels
    (csrc/marks.cu) in stage order, one respawn a wave launched (`medium`
    after `ext_trace` in a scene with media only); the replayed call
    without with_stats holds none; stage_device_ms gives every marked
    stage device time."""
    from tpu_pathtracer_torch.ops.marks import MARK_PREFIX as prefix
    from tpu_pathtracer_torch.utils import profiling
    r, rc = _graph_case(case, device)
    for stats in (True, False):                      # captures
        r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=stats)
    traced = _kernel_events(lambda: r.render_frames(
        r.zeros_accum(), rc, 1, 2, with_stats=True), tmp_path)
    launched = sum(r.regen_integrator(True).last_waves.values())
    plain = _kernel_events(lambda: r.render_frames(r.zeros_accum(), rc, 1,
                                                   2), tmp_path)
    marks = [e["name"][len(prefix):] for e in traced
             if e["name"].startswith(prefix)]
    want = ["respawn", "ext_trace"] \
        + (["medium"] if case == "media" else []) \
        + ["surface", "material", "shade"] \
        + (["bssrdf"] if case == "bssrdf" else []) \
        + ["sample_env", "shadow_trace", "permute", "scatter", "end"]
    assert marks == want * launched and launched > 3
    assert not [e for e in plain if e["name"].startswith(prefix)]
    assert any("traverse_kernel" in e["name"] for e in plain)
    got = profiling.stage_device_ms(traced)
    assert sorted(got["stages"]) == sorted(want[:-1])
    assert all(ms > 0 for ms in got["stages"].values()), got["stages"]
    assert len(got["wave_ms"]) == launched and got["marks"] == len(marks)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "bssrdf", "media"])
def test_replayed_bounce_call_carries_the_stage_marks(device, case,
                                                      tmp_path):
    """A replayed with_stats bounce call's trace holds the pt_stage_*
    kernels by the contract of portbench/metrics/_stages.py: frame_start's
    `respawn` and frame_end's `scatter` once a frame, each launched step
    (the no-op steps after a frame's end among them) its stages from
    `ext_trace` to `end`, and marks_whole takes it; the replayed call
    without with_stats holds none. Its counters equal those of the same
    call run eagerly on the card, and its `bounce_live_lanes` that of the
    same frames run eagerly on the CPU to 1e-3: the CPU's transcendentals
    (MKL, SLEEF) differ from the card's by ulps, which can end a path a
    bounce sooner or later (2 of 18,973 lane-steps in the default case on
    an H100)."""
    import dataclasses
    from portbench.metrics import _stages
    from tpu_pathtracer_torch.ops.marks import MARK_PREFIX as prefix
    from tpu_pathtracer_torch.tracer import device_loop
    frames = 2
    counted = {}
    for dev in (torch.device("cpu"), device):
        r, rc = _graph_case(case, dev)
        r.settings = dataclasses.replace(r.settings, integrator="bounce")
        r.render_frames(r.zeros_accum(), rc, 1, frames, with_stats=True)
        counted[dev.type] = dict(r.bounce_integrator(True).last_counters)
    with device_loop.no_graphs():
        r.render_frames(r.zeros_accum(), rc, 1, frames, with_stats=True)
    eager = dict(r.bounce_integrator(True).last_counters)
    r.render_frames(r.zeros_accum(), rc, 1, frames)        # captures
    traced = _kernel_events(lambda: r.render_frames(
        r.zeros_accum(), rc, 1, frames, with_stats=True), tmp_path)
    fn = r.bounce_integrator(True)
    launched, got = fn.last_launched, dict(fn.last_counters)
    plain = _kernel_events(lambda: r.render_frames(r.zeros_accum(), rc, 1,
                                                   frames), tmp_path)
    marks = [e["name"][len(prefix):] for e in traced
             if e["name"].startswith(prefix)]
    step = ["ext_trace"] + (["medium"] if case == "media" else []) \
        + ["surface", "material", "shade"] \
        + (["bssrdf"] if case == "bssrdf" else []) \
        + ["sample_env", "shadow_trace", "end"]
    per_frame = []
    for m in marks:
        if m == "respawn":
            per_frame.append([])
        per_frame[-1].append(m)
    assert len(per_frame) == frames
    for f in per_frame:
        body = f[1:-1]
        assert f[-1] == "scatter" and body
        assert body == step * (len(body) // len(step))
    assert marks.count("end") == launched > frames
    assert _stages.marks_whole(traced, {r.width * r.height: launched},
                               "bounce", frames)
    assert not [e for e in plain if e["name"].startswith(prefix)]
    assert any("traverse_kernel" in e["name"] for e in plain)
    assert got == eager == counted["cuda"] and got["bounce_live_lanes"] > 0
    assert got["bounce_live_lanes"] == pytest.approx(
        counted["cpu"]["bounce_live_lanes"], rel=1e-3)


@pytest.mark.cuda
def test_replayed_medium_counters_equal_the_eager_call(device):
    """The medium counters of a replayed with_stats call (graphs at every
    drain width) equal those of the same call run eagerly, and the two
    images are the same bits."""
    from tpu_pathtracer_torch.tracer import device_loop
    r, rc = _graph_case("media", device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
        replayed = r.render_frames(r.zeros_accum(), rc, 1, 2,
                                   with_stats=True)[0]
        got = dict(r.regen_integrator(True).last_counters)
        with device_loop.no_graphs():
            eager = r.render_frames(r.zeros_accum(), rc, 1, 2,
                                    with_stats=True)[0]
        want = r.regen_integrator(True).last_counters
    finally:
        torch.use_deterministic_algorithms(False)
    assert got == want and 0 < want["medium_scatters"] \
        < want["medium_lanes"]
    assert torch.equal(replayed, eager)


@pytest.mark.cuda
def test_replays_make_no_synchronising_call(device):
    """A render call of captured waves, camera upload included, runs under
    torch.cuda.set_sync_debug_mode("error"): no blocking device read."""
    r, rc = _graph_case("default", device)
    r.render_frames(r.zeros_accum(), rc, 1, 2)           # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acc = r.render_frames(r.zeros_accum(), rc, 1, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(acc).all() and float(acc.mean()) > 0


@pytest.mark.cuda
def test_second_call_reuses_the_graph(device):
    """One capture serves every call of one key: frames, lane offsets and
    accumulations are device inputs; the frozen pool of the probes'
    stop_after_waves replays too and equals the eager one."""
    from tpu_pathtracer_torch.tracer import device_loop
    from tpu_pathtracer_torch.tools.probe_steps import freeze_pool
    from tpu_pathtracer_torch.tracer.renderer import camera_vector
    r, rc = _graph_case("default", device)
    a = r.render_frames(r.zeros_accum(), rc, 1, 1)
    g = r.regen_integrator().graph
    b = r.render_frames(a, rc, 2, 1)
    assert g is not None and r.regen_integrator().graph is g
    assert g.capture_s > 0 and float(b.mean()) > float(a.mean())
    vec = camera_vector(rc, device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with device_loop.no_graphs():
            want = freeze_pool(r, vec, 3, 2)
        got = freeze_pool(r, vec, 3, 2)
    finally:
        torch.use_deterministic_algorithms(False)
    assert got["waves"] == want["waves"] == 3
    for k in ("orig", "dir", "mask", "L", "rng", "pixel", "active"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "media", "bssrdf",
                                  "distant_light", "chunks4"])
def test_bounce_graph_equals_no_graphs_bit_for_bit(device, case):
    """The replayed bounce frames (frame start, bounces, frame end, each a
    captured graph) equal the eager ones bit for bit under torch's
    deterministic algorithms, with the same bounces, rays, bounces
    launched and kernel launches (chip_smoke phase 11a)."""
    import dataclasses
    from tpu_pathtracer_torch.tracer import device_loop
    r, rc = _graph_case(case, device)
    r.settings = dataclasses.replace(r.settings, integrator="bounce")

    def render():
        for table in (ops.LAUNCHES, ops.FORM_LAUNCHES):
            for k in table:
                table[k] = 0
        out = r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
        torch.cuda.synchronize()
        return (out, r.bounce_integrator(True).last_launched,
                {**ops.LAUNCHES, **ops.FORM_LAUNCHES})
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with device_loop.no_graphs():
            (want, w_b, w_rays), w_launched, w_counts = render()
        render()                                     # captures
        (got, b, rays), launched, counts = render()
        captured = r.bounce_integrator(True).graph
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(got, want), case
    assert (b, rays, launched) == (w_b, w_rays, w_launched)
    assert counts == w_counts and counts["traverse_closest"] >= launched > 0
    assert captured is not None and sorted(captured.graphs) == [
        "bounce", "end", "start"]


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["regen", "bounce"])
def test_shards_on_one_card_equal_the_whole_render(device, integrator):
    """Two shards on the one card (they share its captured steps and run
    one after another) equal the whole 1-spp render bit for bit, and a
    sharded call makes no synchronising call (chip_smoke phase 11d)."""
    import dataclasses
    from tpu_pathtracer_torch.parallel import ShardedRenderer, make_mesh
    r, rc = _graph_case("default", device)
    r.settings = dataclasses.replace(r.settings, integrator=integrator)
    whole = r.render_frames(r.zeros_accum(), rc, 1, 1)
    sr = ShardedRenderer(r, mesh=make_mesh([device, device]))
    sr.render_frames(sr.zeros_accum(), rc, 1, 1)        # captures
    zero = sr.zeros_accum()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sr.render_frames(zero, rc, 1, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[:whole.shape[0]], whole), integrator


@pytest.mark.cuda
def test_bounce_replays_make_no_synchronising_call(device):
    """A replayed bounce call runs under set_sync_debug_mode("error")."""
    import dataclasses
    r, rc = _graph_case("default", device)
    r.settings = dataclasses.replace(r.settings, integrator="bounce")
    r.render_frames(r.zeros_accum(), rc, 1, 2)           # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acc = r.render_frames(r.zeros_accum(), rc, 1, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(acc).all() and float(acc.mean()) > 0


# ---- the shade kernel (csrc/shade.cu) ----

def _shade_outputs(out):
    return list(out[:6]) + [out[6][k] for k in ("glass_refract", "ss_refract",
                                                "ss_normal")]


def _assert_shade_equal(got, want, surf):
    """Every output bit for bit on the lanes in surf."""
    names = ("rng", "next_dir", "mask_mul", "offset", "terminate",
             "bounce_inc", "glass_refract", "ss_refract", "ss_normal")
    for name, g, w in zip(names, _shade_outputs(got), _shade_outputs(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        differ = g != w
        if differ.dim() == 2:
            differ = differ.any(-1)
        assert not bool((differ & surf).any()), \
            (name, int((differ & surf).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 31, 4096, 65536])
def test_shade_kernel_matches_plain_on_card(device, n):
    """The kernel = shade_plain on every surface lane, every output, with
    every material branch present and NaN normals on the miss lanes."""
    scene, args, mat_id, surf = mixed_inputs(n, 50 + n, device)
    want = shade_ops.shade_plain(scene, None, *args)
    before = shade_ops.LAUNCHES["shade"]
    got = shade_ops.shade(scene, None, *args, mat_id=mat_id)
    torch.cuda.synchronize()
    assert shade_ops.LAUNCHES["shade"] == before + (1 if n else 0)
    _assert_shade_equal(got, want, surf)


@pytest.mark.cuda
def test_shade_kernel_reads_strided_and_contiguous_columns(device):
    """objcol as mat["objcol"] (a column view, rows 31 floats apart) and as
    a contiguous copy, raydir as a column view of a wider table: the same
    bits."""
    scene, (rng, raydir, n, nl, into, mat, _), mat_id, surf = \
        mixed_inputs(4096, 61, device)
    wide = torch.cat([raydir, torch.zeros_like(raydir)], dim=1)[:, :3]
    assert wide.stride(0) == 6
    a = shade_ops.shade(scene, None, rng, wide, n, nl, into, mat,
                        mat["objcol"], mat_id=mat_id)
    b = shade_ops.shade(scene, None, rng, raydir, n, nl, into, mat,
                        mat["objcol"].contiguous(), mat_id=mat_id)
    torch.cuda.synchronize()
    _assert_shade_equal(a, b, surf)
    _assert_shade_equal(a, shade_ops.shade_plain(
        scene, None, rng, raydir, n, nl, into, mat, mat["objcol"]), surf)


@pytest.mark.cuda
def test_shade_bare_launch_equals_the_wrapper_and_counts_nothing(device):
    scene, args, mat_id, surf = mixed_inputs(4096, 62, device)
    want = shade_ops.shade(scene, None, *args, mat_id=mat_id)
    before = dict(shade_ops.LAUNCHES)
    launch = shade_ops.launch_fn(scene, *kernel_args(args, mat_id))
    for _ in range(2):
        got = launch()
        torch.cuda.synchronize()
        _assert_shade_equal(got, want, torch.ones_like(surf))
    assert shade_ops.LAUNCHES == before


@pytest.mark.cuda
def test_shade_refused_launch_raises(device, monkeypatch):
    """A nonzero code from tpt_shade raises, and nothing is counted."""
    scene, args, mat_id, _ = mixed_inputs(64, 63, device)
    monkeypatch.setattr(shade_ops, "_kernel", lambda: (lambda *a: 7))
    before = dict(shade_ops.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        shade_ops.shade(scene, None, *args, mat_id=mat_id)
    assert shade_ops.LAUNCHES == before


@pytest.mark.cuda
def test_shade_kernel_needs_the_material_ids(device):
    """The kernel reads the material from mat_id and the table: a call
    on the card without mat_id, or with ids of another dtype, raises and
    counts nothing."""
    scene, args, mat_id, _ = mixed_inputs(64, 64, device)
    before = dict(shade_ops.LAUNCHES)
    with pytest.raises(ValueError, match="mat_id"):
        shade_ops.shade(scene, None, *args)
    with pytest.raises(ValueError, match="mat_id"):
        shade_ops.shade(scene, None, *args, mat_id=mat_id.long())
    assert shade_ops.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["regen", "bounce"])
def test_renders_with_the_shade_kernel_equal_the_plain_shade(
        device, integrator, monkeypatch):
    """A replayed render with the kernel (one launch a wave or a bounce)
    equals the eager render with shade_plain bit for bit, under torch's
    deterministic algorithms."""
    import dataclasses
    from tpu_pathtracer_torch.tracer import device_loop, wavefront
    W = 64
    rc = demo.default_camera(W, W).build_render_camera()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        imgs = {}
        for mode in ("kernel", "plain"):
            r = _regen_renderer(device, W)
            r.settings = dataclasses.replace(r.settings,
                                             integrator=integrator)
            if mode == "plain":
                monkeypatch.setattr(wavefront, "shade", plain_shade)
                with device_loop.no_graphs():
                    imgs[mode] = r.render_frames(r.zeros_accum(), rc, 1, 2)
            else:
                r.render_frames(r.zeros_accum(), rc, 1, 2)   # captures
                before = shade_ops.LAUNCHES["shade"]
                imgs[mode] = r.render_frames(r.zeros_accum(), rc, 1, 2)
                assert shade_ops.LAUNCHES["shade"] > before
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(imgs["kernel"], imgs["plain"])


# ---- the surface fetches (csrc/fetch.cu, csrc/envtex.cu) ----

FETCH_NAMES = ("fetch_attributes", "env_tex_merged", "texture_radiance")


@functools.lru_cache(maxsize=None)
def _fetch_scene(which):
    """The Renderer's scene tables (tri_attr, envtex_quad, texture_quad) of
    TestObj or a small large_scene on the card."""
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    parts = demo.testobj_scene(cache_dir=None) if which == "testobj" else \
        demo.large_scene(cache_dir=None, n_lat=40, n_lon=80, ground_div=12)
    fb, mats, envmap, texture = parts
    return Renderer(fb, mats, envmap=envmap, texture=texture, width=8,
                    height=8, device=torch.device("cuda")).scene


def _fetch_cuda(name, scene, *args):
    out = getattr(surface_fetch, name + "_cuda")(scene, *args)
    return out if isinstance(out, tuple) else (out,)


def _assert_fetch_equal(got, want):
    """Every output bit for bit on every lane, a NaN equal to any NaN."""
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        bad = differing_lanes(g, w)
        assert not bool(bad.any()), (k, int(bad.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["testobj", "large"])
@pytest.mark.parametrize("n", [0, 1, 31, 397, 4096])
@pytest.mark.parametrize("name", FETCH_NAMES)
def test_fetch_kernels_match_plain_on_card(device, name, n, table):
    """Each kernel = its plain version bit for bit in every output on every
    lane, with miss lanes (slot -1, non-finite hit points and uv), every
    material id of the table and bsdf_pdf < 0 lanes; one launch a call."""
    scene = _fetch_scene(table)
    args = kernel_inputs(name, scene, n, 70 + n, device)
    want = run_plain(name, scene, *args)
    before = surface_fetch.LAUNCHES[name]
    got = _fetch_cuda(name, scene, *args)
    torch.cuda.synchronize()
    assert surface_fetch.LAUNCHES[name] == before + (1 if n else 0)
    _assert_fetch_equal(got, want)


@pytest.mark.cuda
def test_fetch_kernels_replay_in_a_cuda_graph(device):
    """The three wrappers captured in one CUDA graph (one launch each, the
    rotation read from device memory) and replayed on new inputs copied
    into the captured ones: the plain versions' bits on the new inputs;
    the counts move at the capture only."""
    scene = _fetch_scene("testobj")
    n = 4096
    static = {k: kernel_inputs(k, scene, n, 80, device) for k in FETCH_NAMES}
    for k in FETCH_NAMES:                                  # warm-up
        _fetch_cuda(k, scene, *static[k])
    torch.cuda.synchronize()
    before = dict(surface_fetch.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = {k: _fetch_cuda(k, scene, *static[k]) for k in FETCH_NAMES}
    assert all(surface_fetch.LAUNCHES[k] == before[k] + 1
               for k in FETCH_NAMES)
    for seed in (81, 82):
        for k in FETCH_NAMES:
            for dst, src in zip(static[k], kernel_inputs(k, scene, n, seed,
                                                       device)):
                dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for k in FETCH_NAMES:
            _assert_fetch_equal(outs[k], run_plain(k, scene, *static[k]))
    assert all(surface_fetch.LAUNCHES[k] == before[k] + 1
               for k in FETCH_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FETCH_NAMES)
def test_fetch_bare_launch_equals_the_wrapper_and_counts_nothing(device,
                                                                 name):
    scene = _fetch_scene("testobj")
    args = kernel_inputs(name, scene, 4096, 83, device)
    want = _fetch_cuda(name, scene, *args)
    before = dict(surface_fetch.LAUNCHES)
    launch = surface_fetch.launch_fn(name, scene, *args)
    for _ in range(2):
        got = launch()
        torch.cuda.synchronize()
        _assert_fetch_equal(got if isinstance(got, tuple) else (got,), want)
    assert surface_fetch.LAUNCHES == before


@pytest.mark.cuda
def test_fetch_refused_calls_raise(device, monkeypatch):
    """A wrong dtype, a tensor on another device, a misaligned table, a
    host rotation: ValueError before any launch; a nonzero code from the C
    entry: RuntimeError. Nothing is counted."""
    scene = _fetch_scene("testobj")
    slot, hp = kernel_inputs("fetch_attributes", scene, 64, 84, device)
    raydir, pdf, rot, miss, uv = kernel_inputs("env_tex_merged", scene, 64, 84,
                                             device)
    before = dict(surface_fetch.LAUNCHES)
    tri = scene["tri_attr"]
    shifted = torch.empty(tri.numel() + 4, device=device)[1:1 + tri.numel()]
    shifted = shifted.view(tri.shape).copy_(tri)
    for call, match in (
            (lambda: surface_fetch.fetch_attributes_cuda(scene, slot.long(),
                                                         hp), "dtype"),
            (lambda: surface_fetch.fetch_attributes_cuda(scene, slot,
                                                         hp.cpu()), "cpu"),
            (lambda: surface_fetch.fetch_attributes_cuda(
                dict(scene, tri_attr=shifted), slot, hp), "aligned"),
            (lambda: surface_fetch.env_tex_merged_cuda(
                scene, raydir, pdf, rot.cpu(), miss, uv), "env_rotation"),
            (lambda: surface_fetch.env_tex_merged_cuda(
                scene, raydir, pdf, rot, miss.int(), uv), "dtype"),
            (lambda: surface_fetch.texture_radiance_cuda(
                scene, uv.double()), "dtype")):
        with pytest.raises(ValueError, match=match):
            call()
    monkeypatch.setattr(surface_fetch, "_kernel", lambda name: (
        lambda *a: 7))
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        surface_fetch.texture_radiance_cuda(scene, uv)
    assert surface_fetch.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["regen", "bounce", "bssrdf"])
def test_renders_with_the_fetch_kernels_equal_the_plain_versions(
        device, integrator, monkeypatch):
    """A replayed render with the kernels (one launch each a wave or a
    bounce) equals the eager render with the plain versions bit for bit,
    under torch's deterministic algorithms; "bssrdf" is the regen render
    of the subsurface variant, whose probes fetch inside the probe loop's
    kernels (csrc/bssrdf.cu), so texture_radiance runs in bounce only."""
    import dataclasses
    from tpu_pathtracer_torch.tracer import device_loop, regen, wavefront
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        imgs = {}
        for mode in ("kernel", "plain"):
            r, rc = _graph_case(
                "bssrdf" if integrator == "bssrdf" else "default", device)
            if integrator == "bounce":
                r.settings = dataclasses.replace(r.settings,
                                                 integrator="bounce")
            if mode == "plain":
                for mod in (wavefront, regen):
                    for k in FETCH_NAMES:
                        if hasattr(mod, k):
                            monkeypatch.setattr(mod, k, plain_fetch(k))
                with device_loop.no_graphs():
                    imgs[mode] = r.render_frames(r.zeros_accum(), rc, 1, 2)
                monkeypatch.undo()
            else:
                r.render_frames(r.zeros_accum(), rc, 1, 2)   # captures
                before = dict(surface_fetch.LAUNCHES)
                imgs[mode] = r.render_frames(r.zeros_accum(), rc, 1, 2)
                moved = {k: surface_fetch.LAUNCHES[k] - before[k]
                         for k in FETCH_NAMES}
                assert moved["fetch_attributes"] > 0, moved
                assert (moved["env_tex_merged"] > 0) == \
                    (integrator != "bounce"), moved
                assert (moved["texture_radiance"] > 0) == \
                    (integrator == "bounce"), moved
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(imgs["kernel"], imgs["plain"])


# ---- the compaction permute's pool gather (csrc/permute.cu) ----

def _pool_equal(got, want):
    """Every pool column bit for bit (floats as their int32 bits)."""
    for k in want:
        assert torch.equal(permute_inputs.bits(got[k]),
                           permute_inputs.bits(want[k])), k


@pytest.mark.cuda
@pytest.mark.parametrize("alias", permute_inputs.ALIASES)
@pytest.mark.parametrize("P", [1, 1000, 65536, 518400, 1 << 20])
def test_pool_gather_kernel_matches_plain_on_card(device, P, alias):
    """The kernel = pool_gather_plain in every column, bit for bit, at the
    CLI cells' pool (2^20, 2^16), the preview's (518,400) and ragged
    sizes, with every column's edge values and the sources that share
    memory with the pool (pixel; L; lbn and medium_id); one launch."""
    st, args = permute_inputs.pool_inputs(P, 70 + P % 13, device, alias)
    st2, args2 = permute_inputs.clone_case(st, args)
    before = permute_ops.LAUNCHES["pool_gather"]
    permute_ops.pool_gather(st, *args)
    permute_ops.pool_gather_plain(st2, *args2)
    torch.cuda.synchronize()
    assert permute_ops.LAUNCHES["pool_gather"] == before + 1
    _pool_equal(st, st2)


@pytest.mark.cuda
def test_pool_gather_bare_launch_equals_the_wrapper_and_counts_nothing(
        device):
    """launch_fn launched twice (the pool's pixel and L columns copied once
    before, and kept while the cache is emptied): the wrapper's bits; no
    count."""
    st, args = permute_inputs.pool_inputs(65536 + 3, 72, device, "wave")
    st2, args2 = permute_inputs.clone_case(st, args)
    permute_ops.pool_gather(st2, *args2)
    before = dict(permute_ops.LAUNCHES)
    launch = permute_ops.launch_fn(st, *args)
    torch.cuda.empty_cache()
    for _ in range(2):
        launch()
        torch.cuda.synchronize()
        _pool_equal(st, st2)
    assert permute_ops.LAUNCHES == before


@pytest.mark.cuda
def test_pool_gather_refused_calls_raise(device, monkeypatch):
    """A wrong dtype, a tensor on another device or a strided pool column:
    ValueError before any launch; a nonzero code from the C entry:
    RuntimeError. Nothing is counted or written."""
    st, args = permute_inputs.pool_inputs(256, 73, device)
    want = {k: v.clone() for k, v in st.items()}
    before = dict(permute_ops.LAUNCHES)
    src, rest = args[0], args[1:]
    with pytest.raises(ValueError, match="dtype"):
        permute_ops.pool_gather(st, src.int(), *rest)
    with pytest.raises(ValueError, match="cpu"):
        permute_ops.pool_gather(st, src, rest[0].cpu(), *rest[1:])
    with pytest.raises(ValueError, match="contiguous"):
        permute_ops.pool_gather(dict(st, L=st["L"].t().contiguous().t()),
                                *args)
    monkeypatch.setattr(permute_ops, "_kernel", lambda: (lambda *a: 7))
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        permute_ops.pool_gather(st, *args)
    torch.cuda.synchronize()
    assert permute_ops.LAUNCHES == before
    _pool_equal(st, want)


@pytest.mark.cuda
@pytest.mark.parametrize("alias", permute_inputs.ALIASES)
def test_pool_gather_replays_in_a_cuda_graph(device, alias):
    """The wrapper captured in a CUDA graph (the aliased sources' copies
    and the launch) and replayed on new inputs copied into the captured
    ones: the plain version's bits on the new inputs; counted at the
    capture only."""
    P = 4096
    st, args = permute_inputs.pool_inputs(P, 74, device, alias)
    permute_ops.pool_gather(st, *args)                    # warm-up
    torch.cuda.synchronize()
    before = permute_ops.LAUNCHES["pool_gather"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        permute_ops.pool_gather(st, *args)
    assert permute_ops.LAUNCHES["pool_gather"] == before + 1
    owned = {a.data_ptr() for a in st.values()}
    for seed in (75, 76):
        st_new, args_new = permute_inputs.pool_inputs(P, seed, device, alias)
        for k in st:
            st[k].copy_(st_new[k])
        for a, b in zip(args, args_new):
            if a.data_ptr() not in owned:
                a.copy_(b)
        want, want_args = permute_inputs.clone_case(st, args)
        permute_ops.pool_gather_plain(want, *want_args)
        graph.replay()
        torch.cuda.synchronize()
        _pool_equal(st, want)
    assert permute_ops.LAUNCHES["pool_gather"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["default", "media"])
def test_renders_with_the_pool_gather_kernel_equal_the_plain_version(
        device, case, monkeypatch):
    """A replayed regen render with the kernel (one launch every compact
    wave) equals the eager render with pool_gather_plain bit for bit,
    under torch's deterministic algorithms, on the TestObj demo and its
    media variant."""
    from tpu_pathtracer_torch.tracer import device_loop, regen
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        imgs = {}
        for mode in ("kernel", "plain"):
            r, rc = _graph_case(case, device)
            if mode == "plain":
                monkeypatch.setattr(regen, "pool_gather",
                                    permute_ops.pool_gather_plain)
                with device_loop.no_graphs():
                    imgs[mode] = r.render_frames(r.zeros_accum(), rc, 1, 2)
                monkeypatch.undo()
            else:
                r.render_frames(r.zeros_accum(), rc, 1, 2)   # captures
                before = permute_ops.LAUNCHES["pool_gather"]
                imgs[mode] = r.render_frames(r.zeros_accum(), rc, 1, 2)
                moved = permute_ops.LAUNCHES["pool_gather"] - before
                waves = sum(r.regen_integrator(False).last_waves.values())
                assert moved == waves > 0, (moved, waves)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(imgs["kernel"], imgs["plain"])


# ---- the BSSRDF probe loop's kernels (csrc/bssrdf.cu) ----

BSSRDF_CASES = ([(n, False, 3) for n in (0, 1, 397, 4096, 65536)]
                + [(65536, True, 3), (65536, False, 1), (65536, False, 5)])


@functools.lru_cache(maxsize=None)
def _bssrdf_wave(textured, probes):
    """(scene, settings, inputs) of bssrdf_scatter in the first wave of a
    256x256 organic sss render on the card (65,536 lanes)."""
    r = bssrdf_inputs.organic_renderer("cuda", 256, textured=textured,
                                       probes=probes)
    return r.scene, r.settings, bssrdf_inputs.wave_inputs(r)


def _bssrdf_case(n, textured, probes, offset=0):
    scene, settings, inputs = _bssrdf_wave(textured, probes)
    return scene, settings, bssrdf_inputs.spread_lanes(inputs, n, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("n,textured,probes", BSSRDF_CASES)
def test_bssrdf_kernels_match_plain_on_card(device, n, textured, probes):
    """The kernel path of bssrdf_scatter = bssrdf_scatter_plain on the
    card, every output bit for bit (a NaN equal to a NaN): rng, ok and
    the merged exit (new_orig, next_dir, mask_mul) on every lane, is_mul
    and next_normal on the loop's lanes; organic sss inputs of a wave with
    mixed loop lanes, a textured skin, 1, 3 and 5 probes; 1 + probes
    launches."""
    from tpu_pathtracer_torch.ops import bssrdf as bssrdf_ops
    scene, settings, inputs = _bssrdf_case(n, textured, probes)
    lanes = inputs["lanes"]
    if n >= 4096:
        assert 0 < int(lanes.sum()) < n
    want = bssrdf_inputs.run(scene, settings, inputs, plain=True)
    before = dict(bssrdf_ops.LAUNCHES)
    got = bssrdf_inputs.run(scene, settings, inputs, plain=False)
    torch.cuda.synchronize()
    moved = {k: bssrdf_ops.LAUNCHES[k] - before[k] for k in before}
    assert moved == ({"probe_start": 1, "probe_step": probes - 1,
                      "probe_finish": 1} if n else
                     {k: 0 for k in before}), moved
    differ = bssrdf_inputs.differing_lanes(got, want, lanes)
    assert not any(differ.values()), differ
    if n >= 4096:
        assert 0 < int(want[4].sum()) < int(lanes.sum())


@pytest.mark.cuda
def test_bssrdf_kernels_replay_in_a_cuda_graph(device):
    """bssrdf_scatter's kernel path (the kernels and the probe traces)
    captured in a CUDA graph and replayed on new inputs copied into the
    captured ones: the plain version's bits on the new inputs; the counts
    move at the capture only."""
    from tpu_pathtracer_torch.ops import bssrdf as bssrdf_ops
    scene, settings, first = _bssrdf_case(4096, False, 3)
    second = _bssrdf_case(4096, False, 3, offset=7)[2]
    static = bssrdf_inputs.spread_lanes(first, 4096)

    def call():
        return bssrdf_inputs.run(scene, settings, static, plain=False)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    before = dict(bssrdf_ops.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = call()
    assert bssrdf_ops.LAUNCHES["probe_start"] == before["probe_start"] + 1
    counted = dict(bssrdf_ops.LAUNCHES)
    for src in (first, second):
        for k, v in src.items():
            if k == "mat":
                for c in v:
                    static[k][c].copy_(v[c])
            elif k == "shade_out":
                for a, b in zip(static[k], v):
                    a.copy_(b)
            else:
                static[k].copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        want = bssrdf_inputs.run(scene, settings, src, plain=True)
        differ = bssrdf_inputs.differing_lanes(outs, want, src["lanes"])
        assert not any(differ.values()), differ
    assert bssrdf_ops.LAUNCHES == counted


@pytest.mark.cuda
def test_bssrdf_refused_calls_raise(device, monkeypatch):
    """A nonzero code from the C entry raises RuntimeError and counts
    nothing; probes outside [1, 255], a wrong dtype or a tensor on another
    device raise ValueError before any launch."""
    import dataclasses
    from tpu_pathtracer_torch.ops import bssrdf as bssrdf_ops
    scene, settings, inputs = _bssrdf_case(397, False, 3)
    before = dict(bssrdf_ops.LAUNCHES)
    for bad in (dataclasses.replace(settings, bssrdf_probes=0),
                dataclasses.replace(settings, bssrdf_probes=256)):
        with pytest.raises(ValueError, match="bssrdf_probes"):
            bssrdf_inputs.run(scene, bad, inputs, plain=False)
    wrong = dict(inputs, mat_id=inputs["mat_id"].long())
    with pytest.raises(ValueError, match="mat_id"):
        bssrdf_inputs.run(scene, settings, wrong, plain=False)
    host = dict(inputs, objcol=inputs["objcol"].cpu())
    with pytest.raises(ValueError, match="objcol"):
        bssrdf_inputs.run(scene, settings, host, plain=False)
    monkeypatch.setattr(bssrdf_ops, "_kernel", lambda: (lambda *a: 7))
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        bssrdf_inputs.run(scene, settings, inputs, plain=False)
    assert bssrdf_ops.LAUNCHES == before


@pytest.mark.cuda
def test_bssrdf_bare_launches_count_nothing(device):
    """launch_fn's three launches run on the card, give the wrapper's
    first launch's bits for probe_start, and count nothing."""
    from tpu_pathtracer_torch.ops import bssrdf as bssrdf_ops
    scene, settings, inputs = _bssrdf_case(4096, False, 3)
    args = [inputs[k] for k in ("rng", "hitpoint", "normal2", "mat_id",
                                "objcol", "lanes")]
    slot = torch.full((4096,), -1, dtype=torch.int32, device=device)
    dist = torch.ones((4096,), dtype=torch.float32, device=device)
    want = bssrdf_inputs.run(scene, settings, inputs, plain=True)
    before = dict(bssrdf_ops.LAUNCHES)
    fns = bssrdf_ops.launch_fn(scene, *args, settings.bssrdf_probes,
                               settings.use_texture, slot, dist)
    for name in bssrdf_ops.STAGES:
        out = fns[name]()
        torch.cuda.synchronize()
    assert torch.equal(out[0], want[0])
    assert bssrdf_ops.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["regen", "bounce"])
def test_renders_with_the_bssrdf_kernels_equal_the_plain_path(
        device, integrator, monkeypatch):
    """A replayed render of the subsurface variant with the kernels (1 +
    bssrdf_probes launches a wave or a bounce) equals the eager render with
    bssrdf_scatter_plain bit for bit, under torch's deterministic
    algorithms."""
    import dataclasses
    from tpu_pathtracer_torch.ops import bssrdf as bssrdf_ops
    from tpu_pathtracer_torch.tracer import bssrdf_shade, device_loop
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        imgs = {}
        for mode in ("kernel", "plain"):
            r, rc = _graph_case("bssrdf", device)
            r.settings = dataclasses.replace(r.settings,
                                             integrator=integrator)
            if mode == "plain":
                monkeypatch.setattr(bssrdf_shade, "uses_kernels",
                                    lambda device, settings: False)
                before = dict(bssrdf_ops.LAUNCHES)
                with device_loop.no_graphs():
                    imgs[mode] = r.render_frames(r.zeros_accum(), rc, 1, 2)
                assert bssrdf_ops.LAUNCHES == before
                monkeypatch.undo()
            else:
                r.render_frames(r.zeros_accum(), rc, 1, 2)   # captures
                before = dict(bssrdf_ops.LAUNCHES)
                imgs[mode] = r.render_frames(r.zeros_accum(), rc, 1, 2)
                moved = {k: bssrdf_ops.LAUNCHES[k] - before[k]
                         for k in before}
                steps = moved["probe_start"]
                assert steps > 0 and moved == {
                    "probe_start": steps, "probe_finish": steps,
                    "probe_step": steps * (r.settings.bssrdf_probes - 1)}
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(imgs["kernel"], imgs["plain"])


@pytest.mark.cuda
def test_replayed_bssrdf_counters_equal_the_eager_call(device):
    """The BSSRDF counters of a replayed with_stats call (graphs at every
    drain width) equal those of the same call run eagerly, and the two
    images are the same bits."""
    from tpu_pathtracer_torch.tracer import device_loop
    r, rc = _graph_case("bssrdf", device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
        replayed = r.render_frames(r.zeros_accum(), rc, 1, 2,
                                   with_stats=True)[0]
        got = dict(r.regen_integrator(True).last_counters)
        with device_loop.no_graphs():
            eager = r.render_frames(r.zeros_accum(), rc, 1, 2,
                                    with_stats=True)[0]
        want = r.regen_integrator(True).last_counters
    finally:
        torch.use_deterministic_algorithms(False)
    assert got == want and 0 < want["bssrdf_exits"] < want["bssrdf_lanes"]
    assert torch.equal(replayed, eager)
