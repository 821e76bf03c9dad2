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
    (dict(active_prefix=3, tmax=torch.full((16,), 5.0)), ValueError),
    (dict(tmin=torch.full((16,), 1e-4)), ValueError),
    (dict(table_mem="smem_split"), ValueError),
    (dict(table_mem="split", step_mode="branch"), ValueError),
    (dict(queue_k=64, interleave=4, step_mode="branch"), ValueError),
    (dict(step_unroll=0), ValueError),
    (dict(stack_depth=65), ValueError),
    (dict(count_steps=True), NotImplementedError),
])
def test_wrapper_raises(kw, exc):
    with pytest.raises(exc):
        _call(**kw)


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
