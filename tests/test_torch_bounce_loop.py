"""The bounce integrator as one device program (tracer/wavefront.py:
frame_start, bounce_step, frame_end through tracer/device_loop.py), on the
CPU.

- The fixed-shape steps against the JAX package's bounce integrator
  (`make_integrator`, a `while_loop`) on the same seeded rays and RNG
  states: bench.py's gate statistics (median |diff| < 1e-4, mean within
  1%, RMSE < 0.1), as tests/test_torch_bounce.py holds the two packages;
  the transcendentals round differently.
- The same image, bounces and rays as the bounce loop the port ran before
  it became fixed-shape steps (a copy of that loop below, one host read of
  the active count a bounce), bit for bit.
- Bounces run after every lane has stopped are exact no-ops on the
  radiance, the deferred miss, the path columns and the counts.
- A step makes no host read: the steps run with Tensor.item / __int__ /
  __bool__ / __float__ / tolist and torch.nonzero patched to raise (the
  plain traversal, the kernel's stand-in on the CPU, is let through).
- The host never ends a frame on a status that has not landed.
- The Renderer builds its bounce integrator once per key.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.core.rng import RaySampler as JSampler
from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
from tpu_pathtracer.tracer.wavefront import make_integrator as j_integrator
from tpu_pathtracer_torch.core.rng import RaySampler, wang_hash
from tpu_pathtracer_torch.core.vecmath import RAY_MIN, RAY_MAX
from tpu_pathtracer_torch.ops import traverse_packet as tops
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.tracer import device_loop, wavefront
from tpu_pathtracer_torch.tracer.medium import medium_interaction
from tpu_pathtracer_torch.tracer.renderer import (
    Renderer, camera_vector, generate_camera_rays)
from tpu_pathtracer_torch.tracer.wavefront import (
    trace_rays, fetch_attributes, shade_hits, env_miss_weighted,
    distant_light)

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))


def _gate(img, want):
    d = np.abs(img - want)
    assert np.all(np.isfinite(img))
    assert float(np.median(d)) < 1e-4, np.median(d)
    assert abs(img.mean() / max(want.mean(), 1e-9) - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


@functools.lru_cache(maxsize=None)
def _scene(variant):
    return tdemo.testobj_scene(cache_dir=None, variant=variant)


def _renderer(W, variant="default", **kw):
    fb, mats, envmap, texture = _scene(variant)
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=W, device="cpu")
    r.settings = dataclasses.replace(r.settings, integrator="bounce", **kw)
    return r, tdemo.default_camera(W, W).build_render_camera()


# ---- the bounce loop before it became fixed-shape steps ----

def _old_integrate(settings, scene, rng, orig, raydir, env_rotation,
                   stats):
    """The port's bounce loop as it was: one host read a bounce."""
    N = orig.shape[0]
    f32 = dict(dtype=torch.float32)
    mask = torch.ones((N, 3), **f32)
    accum = torch.zeros((N, 3), **f32)
    active = torch.ones((N,), dtype=torch.bool)
    lbn = torch.full((N,), settings.bounce_min, dtype=torch.int32)
    medium_id = torch.full((N,), -1, dtype=torch.int32)
    miss_dir = torch.zeros((N, 3), **f32)
    miss_mask = torch.zeros((N, 3), **f32)
    miss_bpdf = torch.full((N,), -1.0, **f32)
    bsdf_pdf = torch.full((N,), -1.0, **f32)
    rays = torch.zeros((), dtype=torch.float64)
    light = distant_light(settings, "cpu")
    bounce = 0
    while bounce < settings.bounce_max:
        n_active = int(active.sum())
        if n_active == 0:
            break
        rays += n_active
        hit_slot, hit_t = trace_rays(scene, settings, orig, raydir, RAY_MIN,
                                     RAY_MAX, anyhit=False, active=active)
        surf = active
        if settings.has_media:
            rng, orig, raydir, mask, sampled_medium = medium_interaction(
                scene, rng, orig, raydir, mask, hit_t, medium_id, active)
            lbn = torch.where(
                sampled_medium,
                torch.clamp_max(lbn + 1, settings.bounce_max), lbn)
            surf = active & ~sampled_medium
        miss = surf & (hit_t > 1e10)
        miss_dir = torch.where(miss[:, None], raydir, miss_dir)
        miss_mask = torch.where(miss[:, None], mask, miss_mask)
        miss_bpdf = torch.where(miss, bsdf_pdf, miss_bpdf)
        active = active & ~miss
        surf = surf & ~miss
        hitpoint = orig + raydir * hit_t[:, None]
        hit = fetch_attributes(scene, hit_slot, hitpoint) + (hitpoint,)
        (rng, orig, raydir, mask, bsdf_pdf, lbn, medium_id, accum, ended,
         n_shadow) = shade_hits(
            scene, settings, rng, orig, raydir, mask, bsdf_pdf, lbn,
            medium_id, surf, hit, None, accum, env_rotation, light,
            count_rays=True)
        rays += n_shadow
        bounce += 1
        active = active & ~ended & (bounce < lbn)
    stats["bounces"] = stats.get("bounces", 0) + bounce
    stats["rays"] = stats.get("rays", 0) + rays
    env = env_miss_weighted(scene, settings, miss_dir, miss_bpdf,
                            env_rotation)
    return rng, accum + miss_mask * env


def _old_frames(r, rc, frame0, n_frames):
    """The old Renderer frame loop for one whole-image chunk."""
    scene, cam_vec = r.scene, camera_vector(rc, "cpu")
    n = r.width * r.height
    acc = torch.zeros((n, 3))
    stats = {}
    for i in range(n_frames):
        lane_ids = torch.arange(n, dtype=torch.int64)
        rng = RaySampler.init(wang_hash(frame0 + i), lane_ids)
        px = scene["lane_px"][:n].to(torch.float32)
        py = scene["lane_py"][:n].to(torch.float32)
        rng, orig, raydir = generate_camera_rays(cam_vec, rng, px, py)
        rng, rad = _old_integrate(r.settings, scene, rng, orig, raydir,
                                  cam_vec[15], stats)
        acc = acc + rad
    return acc, stats["bounces"], float(stats["rays"])


@pytest.mark.parametrize("variant,kw,chunk", [
    ("default", {}, None),
    ("default", {}, 37),
    ("lambertian", {}, None),
    ("media", {}, None),
    ("subsurface", {}, None),
    ("default", dict(use_distant_light=True, bounce_max=6), None),
], ids=["default", "chunks", "lambertian", "media", "bssrdf",
        "distant_light"])
def test_steps_equal_the_old_loop(variant, kw, chunk):
    W = 12
    r, rc = _renderer(W, variant, **kw)
    want, w_bounces, w_rays = _old_frames(r, rc, 3, 2)
    if chunk:
        r = Renderer(*_scene(variant)[:2], envmap=_scene(variant)[2],
                     texture=_scene(variant)[3], width=W, height=W,
                     settings=r.settings, lane_chunk=chunk,
                     base_scene=r.scene, device="cpu")
    got, bounces, rays = r.render_frames(r.zeros_accum(), rc, 3, 2,
                                         with_stats=True)
    assert torch.equal(got, want)
    n_calls = -(-W * W // chunk) if chunk else 1
    if chunk:
        # every chunk runs its own while_loop: its own bounces, and the
        # padding lanes of the last chunk trace rays too
        assert bounces >= w_bounces and rays >= w_rays
    else:
        assert (bounces, rays) == (w_bounces, w_rays)
    fn = r.bounce_integrator(True)
    assert fn.last_launched >= bounces // n_calls


# ---- against the JAX package's bounce integrator ----

def test_steps_match_the_jax_integrator_on_seeded_rays():
    """The steps of one frame on seeded rays and RNG states against the JAX
    integrator on the same inputs."""
    N = 384
    fb, mats, envmap, texture = _scene("default")
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=16,
                   height=16)
    s = dataclasses.replace(jr.settings, integrator="bounce")
    g = np.random.default_rng(7)
    o = (np.array([0.0, 1.0, 4.0]) + g.normal(scale=0.3, size=(N, 3))
         ).astype(np.float32)
    d = (np.array([0.0, -0.2, -1.0]) + g.normal(scale=0.35, size=(N, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    seeds = g.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    rot = np.float32(0.3)

    jrng = JSampler.init(jnp.uint32(12345), jnp.asarray(seeds))
    fn = jax.jit(lambda rng, oo, dd: j_integrator(s)(jr.scene, rng, oo, dd,
                                                     rot))
    _, want = fn(jrng, jnp.asarray(o), jnp.asarray(d))

    tr = Renderer(fb, mats, envmap=envmap, texture=texture, width=16,
                  height=16, device="cpu")
    tr.settings = dataclasses.replace(tr.settings, integrator="bounce")
    cam = camera_vector(tdemo.default_camera(16, 16).build_render_camera(),
                        "cpu")
    cam[15] = float(rot)
    integ = wavefront.make_integrator(tr.settings, with_stats=True)
    cfg, st = integ.start(tr.scene, cam, 1, 0, torch.zeros((N, 3)), 1)
    wavefront.frame_start(cfg, tr.scene, st)
    st["orig"].copy_(torch.from_numpy(o))
    st["dir"].copy_(torch.from_numpy(d))
    st["rng"].copy_(RaySampler.init(12345, torch.from_numpy(
        seeds.astype(np.int64))))
    for _ in range(tr.settings.bounce_max):
        wavefront.bounce_step(cfg, tr.scene, st)
    wavefront.frame_end(cfg, tr.scene, st)
    assert int(st["bounces"]) > 2
    _gate(st["accum"].numpy(), np.asarray(want))


# ---- bounces past the end ----

def _bits(st):
    return {k: (v.view(torch.int32) if v.dtype == torch.float32 else
                v.view(torch.int64) if v.dtype == torch.float64 else v
                ).clone()
            for k, v in st.items()
            if isinstance(v, torch.Tensor) and k != "rng"}


@pytest.mark.parametrize("variant,kw", [
    ("lambertian", {}), ("media", {}), ("subsurface", {}),
    ("default", dict(use_distant_light=True))],
    ids=["lambertian", "media", "bssrdf", "distant_light"])
def test_bounces_past_the_end_change_nothing(variant, kw):
    r, rc = _renderer(12, variant, **kw)
    fn = r.bounce_integrator(True)
    cfg, st = fn.start(r.scene, camera_vector(rc, "cpu"), 1, 0,
                       r.zeros_accum(), 1)
    wavefront.frame_start(cfg, r.scene, st)
    n = 0
    while not bool(st["status"][0]):
        wavefront.bounce_step(cfg, r.scene, st)
        n += 1
    assert n == int(st["bounces"]) and n <= r.settings.bounce_max
    assert variant != "lambertian" or n < r.settings.bounce_max
    before = _bits(st)
    for _ in range(3):
        wavefront.bounce_step(cfg, r.scene, st)
    after = _bits(st)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    wavefront.frame_end(cfg, r.scene, st)
    # the call's own result, with its over-run bounces, is this image
    acc, bounces, rays = fn(r.scene, camera_vector(rc, "cpu"), 1, 0,
                            r.zeros_accum(), 1)
    assert torch.equal(acc, st["accum"])
    assert bounces == n and rays == float(st["rays"])
    assert fn.last_launched == min(n + device_loop.LAG - 1,
                                   r.settings.bounce_max)


# ---- a step makes no host read ----

_READS = ("item", "__int__", "__bool__", "__float__", "tolist")
_guard = [False]


class HostRead(AssertionError):
    pass


@contextlib.contextmanager
def _guarded(on):
    was = _guard[0]
    _guard[0] = on
    try:
        yield
    finally:
        _guard[0] = was


@pytest.fixture
def no_host_reads(monkeypatch):
    """While _guard is set, the host reads raise HostRead. The three steps
    run guarded, the plain traversal unguarded. Yields {step: calls}."""
    def blocked(name, orig):
        def f(*a, **k):
            if _guard[0]:
                raise HostRead("host read %s inside a step" % name)
            return orig(*a, **k)
        return f
    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name,
                            blocked(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", blocked("nonzero", torch.nonzero))
    monkeypatch.setattr(torch.Tensor, "nonzero",
                        blocked("nonzero", torch.Tensor.nonzero))
    calls = {"frame_start": 0, "bounce_step": 0, "frame_end": 0}

    def guard(name):
        step = getattr(wavefront, name)

        def run(*a, **k):
            calls[name] += 1
            with _guarded(True):
                return step(*a, **k)
        return run
    for name in calls:
        monkeypatch.setattr(wavefront, name, guard(name))
    plain = tops.intersect_scene

    def unguarded_trace(*a, **k):
        with _guarded(False):
            return plain(*a, **k)
    monkeypatch.setattr(tops, "intersect_scene", unguarded_trace)
    yield calls


@pytest.mark.parametrize("variant,kw", [
    ("default", {}), ("lambertian", {}), ("media", {}), ("subsurface", {}),
    ("default", dict(use_distant_light=True, bounce_max=5))],
    ids=["default", "lambertian", "media", "bssrdf", "distant_light"])
def test_steps_make_no_host_read(no_host_reads, variant, kw):
    r, rc = _renderer(10, variant, **kw)
    acc, bounces, rays = r.render_frames(r.zeros_accum(), rc, 1, 2,
                                         with_stats=True)
    fn = r.bounce_integrator(True)
    assert bounces > 0 and rays > 0
    assert no_host_reads == {"frame_start": 2, "frame_end": 2,
                             "bounce_step": fn.last_launched}
    assert bounces <= fn.last_launched <= bounces + 2 * (device_loop.LAG - 1)
    assert torch.isfinite(acc).all() and float(acc.mean()) > 0
    with pytest.raises(HostRead), _guarded(True):
        int(torch.ones(()))


# ---- the host's view of the status ----

class FakeGraph:
    """Replays by running the captured step with the launch counts held,
    as a CUDA graph replays kernels without the wrapper counting them."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        saved = device_loop.launch_counts()
        self.step()
        device_loop.set_launch_counts(saved)


class LateFlag:
    """A pinned host copy of the status whose non-blocking copy lands only
    when the event recorded after it on the status's stream is waited on,
    as on the card; it starts holding an earlier frame's done status."""

    def __init__(self):
        self.value, self.pending = [1, 0, 0], None

    def copy_(self, src, non_blocking=False):
        if non_blocking:
            self.pending = src.clone()
        else:
            self.value, self.pending = src.tolist(), None

    def tolist(self):
        return list(self.value)


class StubEvent:
    def __init__(self, flag, stream):
        self.flag, self.stream, self.recorded = flag, stream, []

    def record(self, stream=None):
        self.recorded.append(stream)

    def synchronize(self):
        assert len(self.recorded) < 1000, "the status never landed"
        if self.recorded[-1] == self.stream and self.flag.pending is not None:
            self.flag.value = self.flag.pending.tolist()
            self.flag.pending = None


@pytest.mark.parametrize("variant", ["lambertian", "default"])
def test_a_frame_never_ends_on_a_stale_status(monkeypatch, variant):
    """A replayed call reads each bounce's status only through the event
    recorded on the status device's stream: with every slot holding a done
    status and every copy landing late, the call runs the eager call's
    bounces and gives its image; it launches LAG - 1 bounces past the end
    of a frame that ends early, none past bounce_max."""
    r, rc = _renderer(12, variant)
    eager = r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
    fn = r.bounce_integrator(True)
    eager_launched = fn.last_launched
    monkeypatch.setattr(device_loop, "graphs_enabled", lambda device: True)
    monkeypatch.setattr(device_loop, "capture",
                        lambda step, device: (FakeGraph(step), {}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream", str(device)))
    r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)  # captures
    assert fn.graph is not None
    ring = fn.graph.ring
    ring.flags = [LateFlag() for _ in ring.flags]
    ring.events = [StubEvent(f, ("stream", "cpu")) for f in ring.flags]
    for _ in range(2):
        got = r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
        assert torch.equal(got[0], eager[0]) and got[1:] == eager[1:]
        assert fn.last_launched == eager_launched
        for f in ring.flags:
            f.value = [1, 0, 0]
    overrun = fn.last_launched - eager[1]
    if variant == "lambertian":
        assert overrun == 2 * (device_loop.LAG - 1)
    assert fn.last_launched <= 2 * r.settings.bounce_max
    assert all(s == ("stream", "cpu") for e in ring.events
               for s in e.recorded)


# ---- the Renderer owns its bounce integrator ----

def test_renderer_builds_its_bounce_integrator_once(monkeypatch):
    built = []
    make = wavefront.make_integrator

    def counting(*a, **k):
        built.append(k.get("with_stats"))
        return make(*a, **k)
    monkeypatch.setattr(wavefront, "make_integrator", counting)
    r, rc = _renderer(8)
    a = r.render_frames(r.zeros_accum(), rc, 1, 1)
    b = r.render_frames(r.zeros_accum(), rc, 1, 1)
    assert built == [False] and torch.equal(a, b)
    r.render_frames(r.zeros_accum(), rc, 1, 1, with_stats=True)
    r.render_frames(r.zeros_accum(), rc, 2, 2, with_stats=True)
    assert built == [False, True]
    fn = r.integrator()
    assert fn is r.bounce_integrator() and fn is not r.regen_integrator()
    base = r.settings
    r.settings = dataclasses.replace(base, bounce_max=4)
    r.render_frames(r.zeros_accum(), rc, 1, 1)
    assert len(built) == 3
    r.settings = base
    assert r.integrator() is fn and len(built) == 3
    assert r.bounce_integrator(n_lanes=32) is not fn
    assert r.bounce_integrator(scene=dict(r.scene)) is fn
