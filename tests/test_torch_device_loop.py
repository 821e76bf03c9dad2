"""The regen frame as one device program (tracer/regen.py), on the CPU.

- The traversal takes its live prefix as a 0-d int32 tensor on the rays'
  device, the counterpart of the JAX kernel's traced int32
  (tpu_pathtracer/ops/traverse_packet.py:778): the same slots, t and step
  counts as the host int, and JAX's result in interpret mode under the
  tolerances of tests/test_torch_traverse.py (slots on >= 0.999 of lanes,
  t within rtol 1e-5, atol 1e-6 where they agree; any hit: hit / miss).
- A wave reads nothing on the host: a render with the host reads patched to
  raise inside `regen.regen_wave` runs to its end (the plain traversal,
  which stands in for the kernel on the CPU and ends its loop by host
  reads, is let through).
- Waves run after the end of a call change no bit of the state.
- The host never ends a call on a status an earlier call left in the ring.
- The Renderer builds its integrator once per key.
- The replay bookkeeping of the launch counts, with a fake graph.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.ops.traverse_packet import packet_intersect as jpacket
from tpu_pathtracer_torch.accel import flatten_mesh_bvh
from tpu_pathtracer_torch.ops import traverse_packet as tops
from tpu_pathtracer_torch.scene import demo as tdemo, procedural
from tpu_pathtracer_torch.scene.mesh import TriangleMesh
from tpu_pathtracer_torch.tracer import device_loop, regen, traverse as ttrav
from tpu_pathtracer_torch.tracer.renderer import Renderer, camera_vector

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
RAY_MIN, RAY_MAX = 1e-4, 1e20
N_RAYS = 512


@functools.lru_cache(maxsize=1)
def _stream():
    sphere = procedural.make_uv_sphere((0, 0.5, 0), 1.0, 0, n_lat=10,
                                       n_lon=14)
    plane = procedural.make_plane((0, 0, 0), 8, 8, 0)
    fb = flatten_mesh_bvh(TriangleMesh.concatenate([sphere, plane]))
    g = np.random.default_rng(11)
    o = g.uniform(-3.0, 3.0, (N_RAYS, 3)).astype(np.float32)
    o[:, 1] = g.uniform(0.2, 3, N_RAYS)
    d = g.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return fb, ttrav.pack_stream(fb.prims, fb.meta), o, d


@functools.lru_cache(maxsize=None)
def _jax_traced(anyhit):
    """JAX's packet_intersect with the prefix a traced int32 argument."""
    fb, packed, o, d = _stream()

    def fn(prefix):
        return jpacket(jnp.asarray(packed), jnp.asarray(o), jnp.asarray(d),
                       RAY_MIN, RAY_MAX, anyhit=anyhit,
                       stack_depth=fb.max_depth + 2, active_prefix=prefix,
                       queue_k=16, interpret=True)
    return jax.jit(fn)


@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("n", [0, 1, 397, N_RAYS])
def test_device_prefix_matches_int_prefix_and_jax(n, anyhit):
    fb, packed, o, d = _stream()
    args = (torch.from_numpy(packed), torch.from_numpy(o),
            torch.from_numpy(d), RAY_MIN, RAY_MAX)
    kw = dict(anyhit=anyhit, stack_depth=fb.max_depth + 2, queue_k=16)
    prefix = torch.tensor(n, dtype=torch.int32)
    dev = tops.packet_intersect(*args, active_prefix=prefix,
                                count_steps=True, **kw)
    host = tops.packet_intersect(*args, active_prefix=n, count_steps=True,
                                 **kw)
    for a, b in zip(dev, host):
        assert torch.equal(a, b)
    ts, tt, steps = dev
    assert (ts[n:] == -1).all() and (steps[n:] == 0).all()
    assert (tt[n:] == np.float32(RAY_MAX)).all()
    js, jt = (np.asarray(x) for x in _jax_traced(anyhit)(jnp.int32(n)))
    ts, tt = ts.numpy(), tt.numpy()
    if anyhit:
        assert ((ts >= 0) == (js >= 0)).mean() >= 0.999
        return
    same = ts == js
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(tt[same], jt[same], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("prefix", [
    torch.tensor(3, dtype=torch.int64), torch.tensor([3], dtype=torch.int32)],
    ids=["int64", "shape1"])
def test_device_prefix_of_another_form_raises(prefix):
    fb, packed, o, d = _stream()
    with pytest.raises(ValueError):
        tops.packet_intersect(torch.from_numpy(packed), torch.from_numpy(o),
                              torch.from_numpy(d), RAY_MIN, RAY_MAX,
                              active_prefix=prefix)


# ---- the wave makes no host read ----

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
    """While _guard is set, Tensor.item / __int__ / __bool__ / __float__ /
    tolist and torch.nonzero raise HostRead. regen_wave runs guarded; the
    plain traversal (the kernel's stand-in on the CPU) runs unguarded.
    Yields the count of guarded waves."""
    def blocked(name, orig):
        def f(*a, **k):
            if _guard[0]:
                raise HostRead("host read %s inside a wave" % name)
            return orig(*a, **k)
        return f
    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name,
                            blocked(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", blocked("nonzero", torch.nonzero))
    monkeypatch.setattr(torch.Tensor, "nonzero",
                        blocked("nonzero", torch.Tensor.nonzero))
    waves = [0]
    wave = regen.regen_wave

    def guarded_wave(*a, **k):
        waves[0] += 1
        with _guarded(True):
            return wave(*a, **k)
    plain = tops.intersect_scene

    def unguarded_trace(*a, **k):
        with _guarded(False):
            return plain(*a, **k)
    monkeypatch.setattr(regen, "regen_wave", guarded_wave)
    monkeypatch.setattr(tops, "intersect_scene", unguarded_trace)
    yield waves


@functools.lru_cache(maxsize=None)
def _scene(variant):
    return tdemo.testobj_scene(cache_dir=None, variant=variant)


def _renderer(W, variant="default", **kw):
    fb, mats, envmap, texture = _scene(variant)
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=W, device="cpu")
    if kw:
        r.settings = dataclasses.replace(r.settings, **kw)
    return r, tdemo.default_camera(W, W).build_render_camera()


@pytest.mark.parametrize("variant,kw", [
    ("default", {}),
    ("default", dict(regen_order="inplace")),
    ("media", {}),
    ("subsurface", {}),
    ("default", dict(use_distant_light=True)),
    ("default", dict(scatter_mode="wave")),
    ("default", dict(merge_envtex=False)),
    ("default", dict(pool_lanes=64)),
], ids=["default", "inplace", "media", "bssrdf", "distant_light", "wave",
        "unmerged_envtex", "capped_pool"])
def test_wave_makes_no_host_read(no_host_reads, variant, kw):
    r, rc = _renderer(12, variant, **kw)
    acc, waves, rays = r.render_frames(r.zeros_accum(), rc, 1, 1,
                                       with_stats=True)
    assert waves > 0 and rays > 0
    assert no_host_reads[0] == waves + device_loop.LAG - 1
    assert torch.isfinite(acc).all() and float(acc.mean()) > 0
    # the guard catches a read
    with pytest.raises(HostRead), _guarded(True):
        int(torch.ones(()))


# ---- waves past the end ----

def _bits(st):
    return {k: (v.view(torch.int32) if v.dtype == torch.float32 else
                v.view(torch.int64) if v.dtype == torch.float64 else v
                ).clone()
            for k, v in st.items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("variant,kw,stop", [
    ("default", {}, 0), ("default", dict(regen_order="inplace"), 0),
    ("default", dict(scatter_mode="wave", pool_lanes=64), 0),
    ("default", {}, 3), ("default", dict(regen_order="inplace"), 3),
    ("media", {}, 0), ("subsurface", {}, 0),
    ("default", dict(use_distant_light=True), 0),
    ("default", dict(merge_envtex=False), 0)],
    ids=["default", "inplace", "wave_narrow", "stop3", "inplace_stop3",
         "media", "bssrdf", "distant_light", "unmerged_envtex"])
def test_waves_past_the_end_change_nothing(variant, kw, stop):
    r, rc = _renderer(12, variant, **kw)
    fn = regen.make_regen_integrator(r.settings, 12, 12, with_stats=True,
                                     stop_after_waves=stop)
    cfg, st = fn.start(r.scene, camera_vector(rc, "cpu"), 1, 0,
                       r.zeros_accum(), 2)
    n = 0
    while not bool(st["status"][0]):
        regen.regen_wave(cfg, r.scene, st)
        n += 1
    assert n == int(st["waves"]) and (stop == 0 or n == stop)
    assert (int(st["alive"]) > 0) == (stop > 0)
    before = _bits(st)
    for _ in range(3):
        regen.regen_wave(cfg, r.scene, st)
    after = _bits(st)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    # the loop's own result is this state's
    out = fn(r.scene, camera_vector(rc, "cpu"), 1, 0, r.zeros_accum(), 2)
    if stop:
        assert out["waves"] == n and torch.equal(out["active"], st["active"])
    else:
        assert torch.equal(out[0], st["accum"]) and out[1] == n


# ---- the Renderer owns its integrators ----

def test_renderer_builds_its_integrator_once(monkeypatch):
    built = []
    make = regen.make_regen_integrator

    def counting(*a, **k):
        built.append(k.get("with_stats"))
        return make(*a, **k)
    monkeypatch.setattr(regen, "make_regen_integrator", counting)
    r, rc = _renderer(8)
    a = r.render_frames(r.zeros_accum(), rc, 1, 1)
    b = r.render_frames(r.zeros_accum(), rc, 1, 1)
    assert len(built) == 1 and torch.equal(a, b)
    r.render_frames(r.zeros_accum(), rc, 1, 1, with_stats=True)
    r.render_frames(r.zeros_accum(), rc, 2, 1, with_stats=True)
    assert built == [False, True]
    base = r.settings
    r.settings = dataclasses.replace(base, scatter_mode="wave")
    r.render_frames(r.zeros_accum(), rc, 1, 1)
    assert len(built) == 3
    r.settings = base
    assert torch.equal(r.render_frames(r.zeros_accum(), rc, 1, 1), a)
    assert len(built) == 3
    assert r.regen_integrator(stop_after_waves=2) is \
        r.regen_integrator(stop_after_waves=2)
    assert len(built) == 4
    # a call of other lanes, another scene or the deterministic mode keys
    # another integrator (and so another captured wave)
    fn = r.regen_integrator()
    assert r.regen_integrator(n_lanes=32) is not fn
    assert r.regen_integrator(scene=dict(r.scene)) is fn
    assert r.regen_integrator(scene={**r.scene, "packed": r.scene[
        "packed"].clone()}) is not fn
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        assert r.regen_integrator() is not fn
    finally:
        torch.use_deterministic_algorithms(False)
    assert r.regen_integrator() is fn


# ---- the replay bookkeeping of the launch counts ----

class FakeGraph:
    """Replays by running the captured step with the launch counts held,
    as a CUDA graph replays kernels without the wrapper counting them."""

    def __init__(self, step):
        self.step = step
        self.replays = 0

    def replay(self):
        saved = device_loop.launch_counts()
        self.step()
        device_loop.set_launch_counts(saved)
        self.replays += 1


def test_replay_adds_the_captured_launches(monkeypatch):
    captures = []

    def fake_capture(step, device):
        before = device_loop.launch_counts()
        step()                  # a capture-time wave is a no-op wave
        after = device_loop.launch_counts()
        device_loop.set_launch_counts(before)
        g = FakeGraph(step)
        captures.append(g)
        return g, {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}
    plain = tops.packet_intersect

    def counted(*a, **k):
        # the plain traversal counts nothing on the CPU: count its calls
        name = "traverse_anyhit" if k.get("anyhit") else "traverse_closest"
        tops.LAUNCHES[name] += 1
        if not k.get("anyhit") and k.get("active") is not None and \
                isinstance(a[4], torch.Tensor) and a[4].dim() == 1:
            tops.FORM_LAUNCHES["closest_mask_lane_tmax"] += 1
        return plain(*a, **k)
    monkeypatch.setattr(tops, "packet_intersect", counted)

    def render(r, rc):
        for table in (tops.LAUNCHES, tops.FORM_LAUNCHES):
            for k in table:
                table[k] = 0
        acc = r.render_frames(r.zeros_accum(), rc, 1, 2)
        return acc, {**tops.LAUNCHES, **tops.FORM_LAUNCHES}
    r, rc = _renderer(12, "subsurface")
    eager, eager_counts = render(r, rc)
    monkeypatch.setattr(device_loop, "graphs_enabled", lambda device: True)
    monkeypatch.setattr(device_loop, "capture", fake_capture)
    for i in range(2):
        acc, counts = render(r, rc)
        assert torch.equal(acc, eager)
        assert counts == eager_counts
        assert counts["traverse_closest"] > 0
        assert counts["closest_mask_lane_tmax"] > 0
    # the second call reused the captures: one a width
    assert len(captures) == len(regen.DRAIN_DIVS) + 1
    fn = r.regen_integrator()
    g = fn.graph
    assert len(captures) == len(g.launches) == len(regen.DRAIN_DIVS) + 1
    for w, launches in g.launches.items():
        assert launches == g.launches[max(g.launches)], w
    per_wave = g.launches[max(g.launches)]["traverse_closest"]
    assert eager_counts["traverse_closest"] == per_wave * sum(
        fn.last_waves.values())


# ---- the host's view of the status ----

class LateFlag:
    """A pinned host copy of the status whose non-blocking copy lands only
    when the event recorded after it on the status's stream is waited on,
    as on the card; it starts holding an earlier call's done status."""

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
    """An event that waits for its flag's copy when it was recorded on
    `stream`, the stream that copies the status, and not otherwise."""

    def __init__(self, flag, stream):
        self.flag, self.stream, self.recorded = flag, stream, []

    def record(self, stream=None):
        self.recorded.append(stream)

    def synchronize(self):
        assert len(self.recorded) < 1000, "the status never landed"
        if self.recorded[-1] == self.stream and self.flag.pending is not None:
            self.flag.value = self.flag.pending.tolist()
            self.flag.pending = None


def test_a_call_never_ends_on_a_stale_status(monkeypatch):
    """A replayed call reads each wave's status only through the event
    recorded on the status device's stream, and never a status an earlier
    call left in the ring: with every slot holding a done status and every
    copy landing late, the call runs its waves and gives the eager image."""
    r, rc = _renderer(12)
    eager = r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
    fn = r.regen_integrator(True)
    eager_waves = dict(fn.last_waves)
    monkeypatch.setattr(device_loop, "graphs_enabled", lambda device: True)
    monkeypatch.setattr(device_loop, "capture",
                        lambda step, device: (FakeGraph(step), {}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: ("stream", str(device)))
    r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)  # captures
    flags = [LateFlag() for _ in fn.graph.ring.flags]
    events = [StubEvent(f, ("stream", "cpu")) for f in flags]
    fn.graph.ring.flags, fn.graph.ring.events = flags, events
    for _ in range(2):
        got = r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
        assert torch.equal(got[0], eager[0]) and got[1:] == eager[1:]
        assert fn.last_waves == eager_waves
        for f in flags:                 # the next call finds done statuses
            f.value = [1, 0, 0]
    assert all(s == ("stream", "cpu") for e in events for s in e.recorded)


# ---- the drain's narrower waves ----

@pytest.mark.parametrize("variant,kw", [
    ("default", {}), ("default", dict(scatter_mode="wave")), ("media", {}),
    ("subsurface", {}), ("default", dict(pool_lanes=100)),
    ("default", dict(use_distant_light=True)),
    ("default", dict(merge_envtex=False))],
    ids=["default", "wave", "media", "bssrdf", "narrow_pool",
         "distant_light", "unmerged_envtex"])
def test_drain_widths_keep_the_bits(monkeypatch, variant, kw):
    """Waves over the first P/4 or P/16 lanes once the queue is spent give
    the full-width waves' image, waves and rays bit for bit."""
    r, rc = _renderer(12, variant, **kw)
    fn = r.regen_integrator(True)
    narrowed = r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
    P = min(r.settings.pool_lanes, 144)
    assert min(fn.last_waves) < P, fn.last_waves      # the drain narrowed
    monkeypatch.setattr(regen, "DRAIN_DIVS", ())
    full = r.render_frames(r.zeros_accum(), rc, 1, 2, with_stats=True)
    assert list(fn.last_waves) == [P]
    assert torch.equal(narrowed[0], full[0])
    assert narrowed[1:] == full[1:]
