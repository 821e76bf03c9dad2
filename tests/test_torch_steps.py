"""The step census (count_steps) and the frozen regen pool
(stop_after_waves) of the port against the JAX package.

count_steps: JAX counts per packet and stores the packet's count on all its
lanes; the port counts per ray. With every lane of a packet carrying the
same ray (tile_sub=1, interleave=1: one 128-lane packet per kernel
instance), closest-hit counts are equal, and any-hit counts of the port are
<= JAX's and equal where the ray misses (a finished TPU packet still pops
its stack one entry per step).

stop_after_waves: pools are compared by lane key (pixel, rng state), since
the compaction order may differ where a lane's float path differs: the
same number of waves and spawned samples, `alive` within 1%, and orig/dir
within rtol 1e-4 (atol 1e-6) on >= 0.99 of the matched lanes.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.ops.traverse_packet import packet_intersect as jpacket
from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
from tpu_pathtracer.tracer.regen import make_regen_integrator as j_regen
from tpu_pathtracer_torch.ops import traverse_packet as tops
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.tools import probe_steps
from tpu_pathtracer_torch.tracer import traverse as ttrav
from tpu_pathtracer_torch.tracer.regen import make_regen_integrator
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
RAY_MIN, RAY_MAX = 1e-4, 1e20
W = 32


@functools.lru_cache(maxsize=1)
def _testobj():
    scene = tdemo.testobj_scene(cache_dir=None)
    fb = scene[0]
    return scene, ttrav.pack_stream(fb.prims, fb.meta)


def _rays(n, seed):
    """Half aimed at the scene's centre from a shell around it (long walks),
    half from random points in random directions."""
    g = np.random.default_rng(seed)
    h = n // 2
    u = g.normal(size=(h, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    u[:, 1] = np.abs(u[:, 1])
    o1 = np.array([0.0, 0.8, 0.0]) + 4.0 * u
    d1 = np.array([0.0, 0.8, 0.0]) + g.normal(scale=0.6, size=(h, 3)) - o1
    o2 = g.uniform(-3.0, 3.0, (n - h, 3))
    o2[:, 1] = g.uniform(0.2, 3.0, n - h)
    d2 = g.normal(size=(n - h, 3))
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, g


@functools.lru_cache(maxsize=None)
def _identical_packets(anyhit):
    """32 rays, each on all 128 lanes of its own packet: (JAX per-packet
    count, JAX hit, port per-ray count, port hit)."""
    (fb, *_), packed = _testobj()
    o, d, _ = _rays(32, 21)
    sd = fb.max_depth + 2
    o128, d128 = np.repeat(o, 128, 0), np.repeat(d, 128, 0)
    js, _, jn = jpacket(jnp.asarray(packed), jnp.asarray(o128),
                        jnp.asarray(d128), RAY_MIN, RAY_MAX, anyhit=anyhit,
                        stack_depth=sd, tile_sub=1, interleave=1,
                        count_steps=True, interpret=True)
    jn = np.asarray(jn).reshape(32, 128)
    js = np.asarray(js).reshape(32, 128)
    assert (jn == jn[:, :1]).all()         # one count per packet
    ts, _, tn = tops.packet_intersect(
        torch.from_numpy(packed), torch.from_numpy(o), torch.from_numpy(d),
        RAY_MIN, RAY_MAX, anyhit=anyhit, stack_depth=sd, count_steps=True)
    return jn[:, 0], js[:, 0] >= 0, tn.numpy(), ts.numpy() >= 0


def test_identical_ray_packets_closest_hit_count_equals_jax():
    jn, jhit, tn, thit = _identical_packets(False)
    np.testing.assert_array_equal(thit, jhit)
    np.testing.assert_array_equal(tn, jn)
    assert jhit.sum() >= 8 and tn.max() >= 20      # the set walks the tree


def test_identical_ray_packets_anyhit_count_is_bounded_by_jax():
    jn, jhit, tn, thit = _identical_packets(True)
    np.testing.assert_array_equal(thit, jhit)
    assert (tn <= jn).all()
    np.testing.assert_array_equal(tn[~thit], jn[~thit])
    assert (tn > 0).all()


def _call(n=2048, seed=5, **kw):
    (fb, *_), packed = _testobj()
    o, d, g = _rays(n, seed)
    args = dict(packed=torch.from_numpy(packed), orig=torch.from_numpy(o),
                raydir=torch.from_numpy(d), tmin=RAY_MIN, tmax=RAY_MAX,
                stack_depth=fb.max_depth + 2)
    args.update(kw)
    return tops.packet_intersect(**args), g


@pytest.mark.parametrize("form", ["prefix", "mask", "anyhit"])
def test_steps_zero_outside_the_active_set(form):
    g = np.random.default_rng(8)
    act = torch.from_numpy(g.random(2048) < 0.6)
    kw = {"prefix": dict(active_prefix=397),
          "mask": dict(active=act),
          "anyhit": dict(active=act, anyhit=True)}[form]
    mask = torch.arange(2048) < 397 if form == "prefix" else act
    (_, _, steps), _ = _call(count_steps=True, **kw)
    assert steps.dtype == torch.int32 and steps.shape == (2048,)
    assert (steps[~mask] == 0).all()
    assert (steps[mask] >= 1).all()        # every active lane reads the root


@pytest.mark.parametrize("form", ["closest", "anyhit", "lane_tmax"])
def test_count_steps_leaves_slot_and_t_unchanged(form):
    g = np.random.default_rng(4)
    kw = {"closest": {}, "anyhit": dict(anyhit=True),
          "lane_tmax": dict(tmax=torch.from_numpy(
              g.uniform(0.5, 6.0, 2048).astype(np.float32)))}[form]
    (s, t), _ = _call(**kw)
    (cs, ct, _), _ = _call(count_steps=True, **kw)
    assert torch.equal(s, cs) and torch.equal(t, ct)


def test_counts_unchanged_by_schedule_arguments():
    (_, _, ref), _ = _call(count_steps=True)
    for kw in (dict(step_unroll=3), dict(tile_sub=32, interleave=4),
               dict(queue_k=128), dict(step_mode="branch"),
               dict(table_mem="vmem"), dict(anyhit_early_stop=False)):
        (_, _, steps), _ = _call(count_steps=True, **kw)
        assert torch.equal(steps, ref), kw


def test_cpu_counting_launches_nothing():
    before = dict(tops.LAUNCHES)
    _call(n=64, count_steps=True)
    _call(n=64, count_steps=True, anyhit=True)
    assert tops.LAUNCHES == before


@functools.lru_cache(maxsize=None)
def _pools(k):
    (fb, mats, envmap, texture), _ = _testobj()
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=W,
                   height=W)
    rc = tdemo.default_camera(W, W).build_render_camera()
    fn = jax.jit(j_regen(jr.settings, W, W, stop_after_waves=k),
                 static_argnames=("n_frames",))
    jp = fn(jr.scene, jnp.asarray(rc.as_array()), jnp.uint32(1),
            jnp.uint32(0), jr.zeros_accum(), n_frames=2)
    jp = {key: np.asarray(v) for key, v in jp.items()
          if key in ("orig", "dir", "active", "pixel", "rng", "waves",
                     "next", "alive")}
    tr = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                  height=W, device="cpu")
    tp = make_regen_integrator(tr.settings, W, W, stop_after_waves=k)(
        tr.scene, torch.as_tensor(rc.as_array()), 1, 0, tr.zeros_accum(), 2)
    return jp, tp


@pytest.mark.parametrize("k", [1, 3])
def test_frozen_pool_matches_jax(k):
    jp, tp = _pools(k)
    assert tp["waves"] == int(jp["waves"]) == k
    assert tp["next"] == int(jp["next"])
    assert abs(tp["alive"] - int(jp["alive"])) <= 0.01 * int(jp["alive"])
    ja = jp["active"]
    ta = tp["active"].numpy()
    assert ja[:int(jp["alive"])].all() and not ja[int(jp["alive"]):].any()
    assert ta.sum() == tp["alive"]
    jkey = {(p, r): i for i, (p, r) in enumerate(
        zip(jp["pixel"][ja].astype(np.int64), jp["rng"][ja].astype(np.int64)))}
    tkey = {(p, r): i for i, (p, r) in enumerate(
        zip(tp["pixel"][ta].numpy(), tp["rng"][ta].numpy()))}
    both = sorted(set(jkey) & set(tkey))
    assert len(both) >= 0.99 * max(len(jkey), len(tkey))
    ji = np.array([jkey[c] for c in both])
    ti = np.array([tkey[c] for c in both])
    close = np.ones(len(both), bool)
    for f in ("orig", "dir"):
        a = jp[f][ja][ji]
        b = tp[f][tp["active"]].numpy()[ti]
        close &= np.isclose(b, a, rtol=1e-4, atol=1e-6).all(axis=1)
    assert close.mean() >= 0.99, close.mean()


def test_frozen_pool_fields():
    _, tp = _pools(3)
    P = W * W
    alive = tp["alive"]
    assert torch.equal(tp["active"], torch.arange(P) < alive)
    for f in ("orig", "dir", "mask", "L"):
        assert tp[f].shape == (P, 3) and tp[f].dtype == torch.float32, f
    for f, dt in (("bsdf_pdf", torch.float32), ("rng", torch.int64),
                  ("pixel", torch.int64), ("lbn", torch.int32),
                  ("bounce", torch.int32)):
        assert tp[f].shape == (P,) and tp[f].dtype == dt, f
    assert (tp["L"][alive:] == 0).all()
    assert (tp["bounce"][:alive] >= 1).all()        # survivors bounced
    assert torch.isfinite(tp["orig"][:alive]).all()


def test_stop_after_waves_past_the_frame_end():
    (fb, mats, envmap, texture), _ = _testobj()
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=8,
                 height=8, device="cpu")
    rc = tdemo.default_camera(8, 8).build_render_camera()
    cv = torch.as_tensor(rc.as_array())
    _, waves = r.render_frames(r.zeros_accum(), rc, 1, 1, with_stats=True)[:2]
    pool = make_regen_integrator(r.settings, 8, 8, stop_after_waves=1000)(
        r.scene, cv, 1, 0, r.zeros_accum(), 1)
    assert pool["waves"] == waves < 1000
    assert pool["alive"] == 0 and not pool["active"].any()
    assert pool["next"] == 64


def test_stop_after_waves_negative_raises():
    with pytest.raises(ValueError):
        make_regen_integrator(RenderSettings(), 8, 8, stop_after_waves=-1)


def test_census_arithmetic():
    steps = torch.zeros(70, dtype=torch.int32)
    steps[:64] = torch.arange(64, dtype=torch.int32) % 4 + 1
    steps[0] = 40
    active = torch.arange(70) < 64
    c = probe_steps.census(steps, active)
    live = int(steps[:64].sum())
    assert c["rays"] == 64 and c["steps_sum"] == live and c["max"] == 40
    # warps in pool order: [0,32) max 40, [32,64) max 4, [64,96) empty
    assert c["warp_steps"] == 44 and c["paid"] == 44 * 32
    # sorted: the 40 and the fifteen 4s and sixteen 3s, then the rest
    assert c["oracle_paid"] == (40 + 3) * 32
    assert c["tax"] == pytest.approx(44 * 32 / live - 1)


def test_probe_steps_cpu_run(capsys):
    assert probe_steps.main(["--device", "cpu", "--size", "16", "--waves",
                             "1,2", "--spp", "1"]) == 0
    out = capsys.readouterr().out
    assert "after 1 waves" in out and "after 2 waves" in out
    assert "not measured" in out


def test_probe_steps_needs_a_card_for_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert probe_steps.main(["--device", "cuda"]) == 1
