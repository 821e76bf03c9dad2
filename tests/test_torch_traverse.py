"""Port traversal (plain version + kernel wrapper) against the JAX package.

Tolerances: hit slots agree on >= 0.999 of lanes (a ray grazing a shared
edge may round to either triangle), t within rtol 1e-5 where slots agree,
plus atol 1e-6: the Woop t is a difference of terms of the scene's scale
(~10), so XLA's contraction of its multiply-adds moves it by an absolute
~1e-6 at most, which is a large relative change only for very short hits.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.scene import procedural as jproc
from tpu_pathtracer.scene.mesh import TriangleMesh
from tpu_pathtracer.accel import flatten_mesh_bvh
from tpu_pathtracer.tracer import traverse as jtrav
from tpu_pathtracer.ops.traverse_packet import packet_intersect as jpacket
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.tracer import traverse as ttrav
from tpu_pathtracer_torch.ops import traverse_packet as tops

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
RAY_MIN, RAY_MAX = 1e-4, 1e20


@functools.lru_cache(maxsize=None)
def _small():
    sphere = jproc.make_uv_sphere((0, 0.5, 0), 1.0, 0, n_lat=10, n_lon=14)
    plane = jproc.make_plane((0, 0, 0), 8, 8, 0)
    mesh = TriangleMesh.concatenate([sphere, plane])
    fb = flatten_mesh_bvh(mesh)
    return mesh, fb, ttrav.pack_stream(fb.prims, fb.meta)


@functools.lru_cache(maxsize=None)
def _testobj():
    fb = tdemo.testobj_scene(cache_dir=None)[0]
    return fb, ttrav.pack_stream(fb.prims, fb.meta)


def _rays(n, seed, lo=-3.0, hi=3.0):
    g = np.random.default_rng(seed)
    o = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[:, 1] = g.uniform(0.2, 3, n)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, g


def _agree(ts, tt, js, jt):
    ts, tt, js, jt = (np.asarray(x) for x in (ts, tt, js, jt))
    same = ts == js
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(tt[same], jt[same], rtol=1e-5, atol=1e-6)


def _forms(n, g):
    act = g.random(n) < 0.7
    tmax = g.uniform(0.5, 6.0, n).astype(np.float32)
    return {
        "closest": dict(),
        "mask": dict(active=act),
        "lane_tmax": dict(active=act, tmax=tmax),
        "anyhit": dict(active=act, anyhit=True),
    }


@pytest.mark.parametrize("form", ["closest", "mask", "lane_tmax", "anyhit"])
def test_plain_traversal_matches_jax_intersect_scene(form):
    fb, packed = _testobj()
    o, d, g = _rays(4096, 1)
    kw = _forms(4096, g)[form]
    tmax = kw.get("tmax", RAY_MAX)
    act = kw.get("active")
    anyhit = kw.get("anyhit", False)
    js, jt = jtrav.intersect_scene(
        jnp.asarray(fb.prims), jnp.asarray(fb.meta), fb.num_nodes,
        jnp.asarray(o), jnp.asarray(d), RAY_MIN, jnp.asarray(tmax),
        anyhit=anyhit, stack_depth=fb.max_depth + 2,
        active=None if act is None else jnp.asarray(act), tile_size=None)
    ts, tt = ttrav.intersect_scene(
        torch.from_numpy(fb.prims), torch.from_numpy(fb.meta), fb.num_nodes,
        torch.from_numpy(o), torch.from_numpy(d), RAY_MIN,
        torch.as_tensor(tmax), anyhit=anyhit, stack_depth=fb.max_depth + 2,
        active=None if act is None else torch.from_numpy(act))
    if anyhit:
        # any accepted hit is right; what callers read is hit or not
        assert ((ts.numpy() >= 0) == (np.asarray(js) >= 0)).mean() >= 0.999
    else:
        _agree(ts, tt, js, jt)
    if act is not None:
        assert (ts.numpy()[~act] == -1).all()
        np.testing.assert_array_equal(
            tt.numpy()[~act],
            np.broadcast_to(np.asarray(tmax, np.float32), (4096,))[~act])


def test_plain_traversal_packed_equals_prims_meta():
    fb, packed = _testobj()
    o, d, _ = _rays(2048, 2)
    a = ttrav.intersect_scene(torch.from_numpy(fb.prims),
                              torch.from_numpy(fb.meta), fb.num_nodes,
                              torch.from_numpy(o), torch.from_numpy(d),
                              RAY_MIN, RAY_MAX)
    b = ttrav.intersect_scene(None, None, None, torch.from_numpy(o),
                              torch.from_numpy(d), RAY_MIN, RAY_MAX,
                              packed=torch.from_numpy(packed))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_plain_traversal_matches_brute_force():
    mesh, fb, packed = _small()
    o, d, _ = _rays(1500, 0)
    s, t = ttrav.intersect_scene(None, None, None, torch.from_numpy(o),
                                 torch.from_numpy(d), RAY_MIN, RAY_MAX,
                                 packed=torch.from_numpy(packed))
    s, t = s.numpy(), t.numpy()
    bs, bt = ttrav.brute_force_intersect(mesh.tri_vertices(), o, d, RAY_MIN,
                                         RAY_MAX)
    ours = np.where(s >= 0, fb.tri_orig[np.maximum(s, 0)], -1)
    assert (ours == bs).mean() >= 0.999
    hit = (ours == bs) & (bs >= 0)
    np.testing.assert_allclose(t[hit], bt[hit], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("form", ["prefix", "mask", "lane_tmax", "anyhit"])
def test_wrapper_matches_jax_packet_kernel_interpret(form):
    mesh, fb, packed = _small()
    n = 1024
    o, d, g = _rays(n, 41)
    act = g.random(n) < 0.7
    tmax_l = g.uniform(1.0, 5.0, n).astype(np.float32)
    sd = fb.max_depth + 2
    jkw, tkw, tmax = {}, {}, RAY_MAX
    if form == "prefix":
        jkw = dict(queue_k=16, active_prefix=jnp.int32(397))
        tkw = dict(queue_k=16, active_prefix=397)
    elif form == "mask":
        jkw, tkw = dict(active=jnp.asarray(act)), dict(
            active=torch.from_numpy(act))
    elif form == "lane_tmax":
        jkw, tkw = dict(active=jnp.asarray(act)), dict(
            active=torch.from_numpy(act))
        tmax = tmax_l
    else:
        jkw = dict(active=jnp.asarray(act), anyhit=True)
        tkw = dict(active=torch.from_numpy(act), anyhit=True)
    js, jt = jpacket(jnp.asarray(packed), jnp.asarray(o), jnp.asarray(d),
                     RAY_MIN, jnp.asarray(tmax), stack_depth=sd,
                     interpret=True, **jkw)
    ts, tt = tops.packet_intersect(torch.from_numpy(packed),
                                   torch.from_numpy(o), torch.from_numpy(d),
                                   RAY_MIN, torch.as_tensor(tmax),
                                   stack_depth=sd, **tkw)
    if form == "anyhit":
        assert ((ts.numpy() >= 0) == (np.asarray(js) >= 0)).mean() >= 0.999
    else:
        _agree(ts, tt, js, jt)
    if form == "prefix":
        assert (ts.numpy()[397:] == -1).all()
        assert (tt.numpy()[397:] == np.float32(RAY_MAX)).all()


def _call(**kw):
    _, fb, packed = _small()
    o, d, _ = _rays(16, 3)
    args = dict(packed=torch.from_numpy(packed), orig=torch.from_numpy(o),
                raydir=torch.from_numpy(d), tmin=RAY_MIN, tmax=RAY_MAX)
    args.update(kw)
    return tops.packet_intersect(**args)


@pytest.mark.parametrize("kw,exc", [
    (dict(active=torch.ones(16, dtype=torch.bool), active_prefix=3),
     ValueError),
    (dict(active_prefix=3, tmax=torch.full((16,), 5.0), queue_k=16,
          interleave=4), ValueError),
    (dict(tmin=torch.full((16,), 1e-4)), ValueError),
    (dict(table_mem="smem_split"), ValueError),
    (dict(table_mem="split", step_mode="branch"), ValueError),
    (dict(queue_k=64, interleave=4, step_mode="branch"), ValueError),
    (dict(step_unroll=0), ValueError),
    (dict(stack_depth=67), ValueError),
])
def test_wrapper_raises(kw, exc):
    with pytest.raises(exc):
        _call(**kw)


@pytest.mark.parametrize("anyhit", [False, True])
def test_prefix_with_lane_tmax_lowers_to_a_mask(anyhit):
    """active_prefix with a per-lane tmax runs wherever the JAX kernel runs
    it (it raises only for queue_k > interleave on closest hit): the
    prefix is lowered to the mask arange(N) < prefix, so the result is the
    mask form's, and JAX's."""
    _, fb, packed = _small()
    o, d, g = _rays(16, 3)
    tmax = g.uniform(0.5, 6.0, 16).astype(np.float32)
    sd = fb.max_depth + 2
    js, jt = jpacket(jnp.asarray(packed), jnp.asarray(o), jnp.asarray(d),
                     RAY_MIN, jnp.asarray(tmax), anyhit=anyhit,
                     stack_depth=sd, active_prefix=3, interpret=True)
    ts, tt = _call(tmax=torch.from_numpy(tmax), active_prefix=3,
                   anyhit=anyhit, stack_depth=sd)
    ms, mt = _call(tmax=torch.from_numpy(tmax), anyhit=anyhit,
                   stack_depth=sd, active=torch.arange(16) < 3)
    assert torch.equal(ts, ms) and torch.equal(tt, mt)
    assert (ts[3:] == -1).all()
    assert torch.equal(tt[3:], torch.from_numpy(tmax[3:]))
    assert ((ts.numpy() >= 0) == (np.asarray(js) >= 0)).all()
    if not anyhit:
        _agree(ts, tt, js, jt)


@pytest.mark.parametrize("anyhit", [False, True])
def test_wrapper_count_steps_returns_steps(anyhit):
    """count_steps=True adds steps [N] i32 (the rows each lane fetched) and
    leaves slot and t as they were; the plain version counts the same."""
    _, fb, packed = _small()
    s, t = _call(anyhit=anyhit)
    cs, ct, n = _call(anyhit=anyhit, count_steps=True)
    assert torch.equal(s, cs) and torch.equal(t, ct)
    assert n.dtype == torch.int32 and n.shape == (16,)
    assert (n >= 1).all() and (n <= packed.shape[0]).all()
    o, d, _ = _rays(16, 3)
    *_, pn = ttrav.intersect_scene(None, None, None, torch.from_numpy(o),
                                   torch.from_numpy(d), RAY_MIN, RAY_MAX,
                                   anyhit=anyhit, packed=torch.from_numpy(
                                       packed), count_steps=True)
    assert torch.equal(n, pn)


def test_wrapper_smem_budget_guard():
    big = np.zeros((20000, 16), np.float32)
    o, d, _ = _rays(4, 5)
    with pytest.raises(ValueError, match="SMEM budget"):
        tops.packet_intersect(torch.from_numpy(big), torch.from_numpy(o),
                              torch.from_numpy(d), RAY_MIN, RAY_MAX,
                              table_mem="smem")


def test_wrapper_schedule_arguments_change_nothing():
    a = _call()
    for kw in (dict(tile_sub=32, interleave=4), dict(queue_k=128),
               dict(step_mode="branch"), dict(table_mem="vmem"),
               dict(step_unroll=3, anyhit_early_stop=False)):
        b = _call(**kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cpu_wrapper_launches_nothing():
    before = dict(tops.LAUNCHES)
    _call()
    _call(anyhit=True)
    assert tops.LAUNCHES == before


def test_plain_traversal_with_dropped_pushes_only_misses():
    """stack_depth=1 drops every push past the first (the kernel's rule,
    which it holds bit for bit; the JAX packet kernel leaves an overflow
    undefined): a lane can only miss triangles, never find a closer hit."""
    fb, packed = _testobj()
    o, d, _ = _rays(4096, 37)
    args = (None, None, None, torch.from_numpy(o), torch.from_numpy(d),
            RAY_MIN, RAY_MAX)
    fs, ft = ttrav.intersect_scene(*args, stack_depth=fb.max_depth + 2,
                                   packed=torch.from_numpy(packed))
    os_, ot = ttrav.intersect_scene(*args, stack_depth=1,
                                    packed=torch.from_numpy(packed))
    assert bool((ot >= ft).all())
    same = os_ == fs
    assert torch.equal(ot[same], ft[same])
    assert bool((~same).any())


def test_cpu_count_steps_measures_no_warp_steps():
    """Warp-steps are measured by the kernel on the card only: a CPU
    count leaves last_warp_steps as it was."""
    before = tops._last_warp_steps
    _call(count_steps=True)
    assert tops._last_warp_steps is before


def test_probe_ray_sets_on_cpu():
    """The probe's camera rays are unit directions in lane order and its
    incoherent origins lie in the scene box."""
    from tpu_pathtracer_torch.tools import probe_steps
    cpu = torch.device("cpu")
    o, d = probe_steps.camera_rays(16, cpu)
    assert o.shape == d.shape == (256, 3)
    torch.testing.assert_close(d.norm(dim=1), torch.ones(256), rtol=1e-5,
                               atol=0.0)
    fb, _ = _testobj()
    o, d = probe_steps.incoherent_rays(512, fb, 3, cpu)
    lo, hi = torch.from_numpy(fb.root_lo), torch.from_numpy(fb.root_hi)
    assert bool(((o >= lo) & (o <= hi)).all())
    torch.testing.assert_close(d.norm(dim=1), torch.ones(512), rtol=1e-5,
                               atol=0.0)


def test_probe_camera_rays_leave_the_pinhole_toward_the_scene():
    """The default camera is a pinhole (aperture 0) orbiting its centre at
    its radius: every camera ray starts at the one eye point, and every
    direction leans toward the centre."""
    from tpu_pathtracer_torch.scene.demo import default_camera
    from tpu_pathtracer_torch.tools import probe_steps
    cam = default_camera(8, 8)
    o, d = probe_steps.camera_rays(8, torch.device("cpu"))
    assert o.dtype == d.dtype == torch.float32
    assert torch.equal(o, o[:1].expand_as(o))
    centre = torch.tensor(cam.center_position, dtype=torch.float32)
    torch.testing.assert_close((o[0] - centre).norm(),
                               torch.tensor(cam.radius), rtol=1e-5, atol=0.0)
    assert bool(((d * (centre - o)).sum(dim=1) > 0).all())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(count_steps=True),
    dict(active=torch.ones(16, dtype=torch.bool), anyhit=True),
])
def test_bare_launch_refuses_cpu_tensors(kw):
    """launch_fn times the kernel alone and exists on the card only: a CPU
    tensor raises instead of reaching the plain version."""
    _, fb, packed = _small()
    o, d, _ = _rays(16, 3)
    with pytest.raises(ValueError, match="current CUDA device"):
        tops.launch_fn(torch.from_numpy(packed), torch.from_numpy(o),
                       torch.from_numpy(d), RAY_MIN, RAY_MAX, **kw)


@pytest.mark.parametrize("kw", [
    dict(active=torch.ones(16, dtype=torch.bool), active_prefix=3),
    dict(stack_depth=0),
    dict(stack_depth=67),
])
def test_bare_launch_checks_arguments(kw):
    """launch_fn applies the wrapper's argument checks before any device
    check."""
    _, fb, packed = _small()
    o, d, _ = _rays(16, 3)
    with pytest.raises(ValueError, match="active|stack_depth"):
        tops.launch_fn(torch.from_numpy(packed), torch.from_numpy(o),
                       torch.from_numpy(d), RAY_MIN, RAY_MAX, **kw)


@pytest.mark.parametrize("anyhit", [False, True])
def test_deepest_stack_matches_jax_interpret(anyhit):
    """stack_depth = MAX_DEPTH + 2 = 66, the most a Renderer hands the
    traversal (the builders cap a tree at 64 levels): the port takes it,
    as the JAX kernel does, with the JAX kernel's result."""
    assert tops.MAX_STACK_DEPTH == 66
    mesh, fb, packed = _small()
    o, d, g = _rays(1024, 43)
    act = g.random(1024) < 0.7
    js, jt = jpacket(jnp.asarray(packed), jnp.asarray(o), jnp.asarray(d),
                     RAY_MIN, RAY_MAX, stack_depth=66, anyhit=anyhit,
                     active=jnp.asarray(act), interpret=True)
    ts, tt = tops.packet_intersect(torch.from_numpy(packed),
                                   torch.from_numpy(o), torch.from_numpy(d),
                                   RAY_MIN, RAY_MAX, stack_depth=66,
                                   anyhit=anyhit,
                                   active=torch.from_numpy(act))
    if anyhit:
        assert ((ts.numpy() >= 0) == (np.asarray(js) >= 0)).mean() >= 0.999
    else:
        _agree(ts, tt, js, jt)
