"""Path-regeneration wavefront integrator (port of tracer/regen.py).

A constant-width pool of P lanes traces path segments wave after wave;
when a path ends, its lane takes the next unspawned camera sample, possibly
of a later frame. The RNG is counter-based per (frame, pixel), so every
sample gets the same random stream, and so the same value, as in the JAX
package, whatever wave it runs in.

A render call is one device program, as the JAX package's `while_loop`
(tpu_pathtracer/tracer/regen.py:197-212) makes it: every wave
(`regen_wave`: respawn, one wavefront segment, the compaction permute, the
dead-row flush) works on all P lanes with fixed shapes, keeps every count
(samples spawned, paths alive, waves, rays) as a device scalar and reads
nothing on the host. Each wave ends by writing its status (done, paths
alive, samples left in the queue). The machinery is tracer/device_loop.py,
shared with the bounce integrator: on a CUDA device the wave is captured
once as a CUDA graph and replayed; the host learns that the call is done
from an asynchronous copy of the status into pinned memory, checked with
an event, with at most device_loop.LAG = 2 waves in flight, so one wave
past the end is replayed. A wave after the end is an exact no-op: it
spawns nothing, traces an empty prefix and adds zeros. The CPU runs the
same waves eagerly, and so does the card inside
`device_loop.no_graphs()`, the counterpart of `jax.disable_jit()`.

The drain. Once the queue is spent the live count can only fall, so a
status that is two waves old bounds it from above; under the compact
order the live lanes are the prefix [0, alive), and a wave over the first
w rows of every column (views, the same addresses) gives the full-width
wave's bits when alive <= w. The host then runs the narrowest of the
widths P, P/4 and P/16 (DRAIN_DIVS) that holds the stale count, each
width captured once. A full-width wave at P = 1M lanes costs ~14 ms of
device time on an H100, one of 65k lanes ~5.5 ms: the ~1,750 kernels of a
wave are mostly elementwise passes over the pool.

regen_order="compact" (the default): after every wave the survivors are
stable-sorted to the front (key: hit slot major, direction octant minor,
dead lanes and the lanes past the live prefix last), so the live lanes are
always the exact prefix [0, alive). The extension trace takes that prefix
as a 0-d int32 device tensor, which the traversal kernel reads from device
memory; every other stage takes the live mask. One gather moves every
pool column (ops/permute.py: pool_gather, one kernel launch a wave on the
card).

regen_order="inplace": the pool is never compacted. The live set is a
mask, traces take `active=`, and the dead lanes take the next queue
samples in lane order, ranked by a cumulative sum of the dead mask.

How radiance reaches the image. The JAX package's 1024-way accumulation
swizzle, ring buffer, rung ladder and dense fresh-death flush all work
around the cost of XLA's scatter on a TPU; they change how radiance
reaches the image, not what it sums to. Here scatter_mode "ring" and
"deferred" bank each path's radiance L on its lane and index_add_ it into
the image when the path dies (after compaction the lanes that died this
wave are the rows [alive, n_active); the add covers all P rows, with +0.0
on the others, which keeps every bit); "wave" index_add_s every lane's
contribution every wave, and so does every inplace render: as in the JAX
package, banking needs the compacted dead tail. The three give the same
image up to float addition order (CUDA index_add_ adds with atomics). `dense_fresh_flush`
is accepted and has no effect. The ring itself waits for an H100
measurement that calls for it.

`stop_after_waves=k` (the probes' hook, JAX `regen.py:205-209,940-946`)
ends the loop after k waves, or earlier when the frame is done, and
returns the pool instead of the image (see `make_regen_integrator`).

Media (`has_media`: the per-lane `medium_id` column, distance sampling
before shading), BSSRDF (`has_bssrdf`: the probe loop of
tracer/bssrdf_shade.py on the lanes that refracted into a subsurface
material) and the distant light (`use_distant_light`: one more any-hit
shadow trace a wave, also from BSSRDF exit points) run in the same wave
body, as in the JAX package.

Stage marks. A with_stats call (the instrumented one; its key differs
from the plain call's, so it has graphs of its own) marks the start of
each stage of a wave with ops/marks.py: stage_mark, in wave order:
respawn, ext_trace (the closest-hit trace), medium (has_media only: the
distance sampling, the transmittance, the HG direction, the scatter
budget and the miss mask), surface (the attribute fetch, the env /
texture lookup), material, shade, bssrdf (has_bssrdf only), sample_env,
shadow_trace (NEE's and the distant light's any-hit traces and what
follows up to the permute), permute, scatter (the dead-row flush; under
scatter_mode "wave" the per-wave add, before the permute) and end, after
the status. On the card a mark is an empty kernel captured into the
wave's graph, so a replayed call's trace splits its device time by stage
(stage_device_ms); a call without with_stats launches none.

Counters. A with_stats call of a scene with media also counts, in two
int64 device scalars of its state summed over every wave at every drain
width, the live lanes inside a medium at the medium step
(`medium_lanes`) and the lanes that scattered there (`medium_scatters`);
one of a scene with BSSRDF counts the lanes that enter the probe loop
(`bssrdf_lanes`) and those that leave it at an exit (`bssrdf_exits`). The
integrator reads them once after the call into `last_counters` ({} for a
scene with neither or a call without with_stats).
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import torch

from ..core.vecmath import RAY_MIN, RAY_MAX
from ..core.rng import RaySampler, wang_hash
from ..ops.marks import stage_marker
from ..ops.permute import pool_gather
from . import device_loop
from .medium import medium_interaction
from .wavefront import (
    BSSRDF_COUNTERS, RenderSettings, trace_rays, fetch_attributes,
    env_miss_weighted, env_tex_merged, shade_hits, distant_light,
)
from .renderer import generate_camera_rays, lane_pixel_xy


# the drain's narrower widths, P // d for each d (compact order only)
DRAIN_DIVS = (4, 16)
# the counters of a with_stats call on a scene with media, published with
# shade_hits' BSSRDF_COUNTERS in RegenIntegrator.last_counters (see the
# module docstring)
COUNTERS = ("medium_lanes", "medium_scatters")


def _check_settings(settings: RenderSettings):
    if settings.regen_order == "compact" and settings.bounce_max > 127:
        raise ValueError("regen_order='compact' requires bounce_max <= 127 "
                         "(bounce rides a 7-bit field of the permute's "
                         "packed word, ops/permute.py)")
    if settings.regen_order not in ("compact", "inplace"):
        raise ValueError("unknown regen_order %r (want compact/inplace)"
                         % (settings.regen_order,))
    if settings.scatter_mode not in ("ring", "deferred", "wave"):
        raise ValueError("unknown scatter_mode %r (want ring/deferred/wave)"
                         % (settings.scatter_mode,))


@dataclasses.dataclass(frozen=True)
class WaveConfig:
    """What a wave's shapes and code depend on: the settings, the image
    size, the flags of the integrator, and N (lanes of the call's image
    slice) and P (pool lanes)."""
    settings: RenderSettings
    width: int
    height: int
    with_stats: bool
    stop_after_waves: int
    N: int
    P: int

    @property
    def inplace(self):
        return self.settings.regen_order == "inplace"

    @property
    def deferred(self):
        # as in the JAX package, banking radiance on the path needs the
        # compacted dead tail: an inplace render adds every wave
        return (self.settings.scatter_mode in ("ring", "deferred")
                and not self.inplace)


def new_state(cfg: WaveConfig, device):
    """The tensors a wave reads and writes in place: the pool columns, the
    device scalars (next, alive, waves, rays, tot, frame0, lane0, and the
    counters of a with_stats call, _counters), the status a wave
    ends with (int64 [done, alive, samples left]), the camera vector and
    the image slice `accum` [N,3]. Filled by reset()."""
    P, N = cfg.P, cfg.N
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    st = {k: torch.empty((P, 3), **f32) for k in ("orig", "dir", "mask",
                                                   "L")}
    st.update(bsdf_pdf=torch.empty((P,), **f32),
              rng=torch.empty((P,), **i64), pixel=torch.empty((P,), **i64),
              lbn=torch.empty((P,), **i32), bounce=torch.empty((P,), **i32),
              medium_id=torch.empty((P,), **i32),
              active=torch.empty((P,), dtype=torch.bool, device=device),
              lane=torch.arange(P, **i64),
              rays=torch.empty((), dtype=torch.float64, device=device),
              status=torch.empty((3,), **i64),
              cam_vec=torch.empty((16,), **f32),
              accum=torch.empty((N, 3), **f32),
              light=distant_light(cfg.settings, device))
    for k in ("next", "alive", "waves", "tot", "frame0", "lane0") \
            + _counters(cfg):
        st[k] = torch.empty((), **i64)
    return st


def _counters(cfg: WaveConfig):
    """The names of the counters a call of cfg keeps: under with_stats,
    COUNTERS on a scene with media and BSSRDF_COUNTERS on one with
    BSSRDF; else none."""
    if not cfg.with_stats:
        return ()
    return (COUNTERS if cfg.settings.has_media else ()) \
        + (BSSRDF_COUNTERS if cfg.settings.has_bssrdf else ())


def narrow(cfg: WaveConfig, st, w):
    """(cfg, state) of a wave over the first w lanes of the pool: views of
    the first w rows of every column (the same addresses), the scalars,
    the camera and the image shared. Under the compact order, with the
    queue spent and at most w paths alive, a wave on it gives the
    full-width wave's bits."""
    if w == cfg.P:
        return cfg, st
    sub = dict(st)
    for k in ("orig", "dir", "mask", "L", "bsdf_pdf", "rng", "pixel", "lbn",
              "bounce", "medium_id", "active", "lane"):
        sub[k] = st[k][:w]
    return dataclasses.replace(cfg, P=w), sub


def drain_widths(cfg: WaveConfig):
    """The widths a call's waves run at: P, and under the compact order
    the narrower P // d of DRAIN_DIVS (at least 1 lane)."""
    if cfg.inplace:
        return (cfg.P,)
    return tuple(sorted({cfg.P} | {max(cfg.P // d, 1)
                                   for d in DRAIN_DIVS}))


def reset(cfg: WaveConfig, st, cam_vec, frame0, lane0, accum, n_frames):
    """Start a call on state st: an empty pool, the counts at 0, the
    call's inputs copied in (tot = N * n_frames samples). Device work
    only: fills and device copies."""
    for k in ("orig", "dir", "mask", "L", "rng", "pixel", "lbn", "bounce",
              "next", "alive", "waves", "rays") + _counters(cfg):
        st[k].zero_()
    st["bsdf_pdf"].fill_(-1.0)
    st["medium_id"].fill_(-1)
    st["active"].zero_()
    st["status"].zero_()
    st["tot"].fill_(cfg.N * int(n_frames))
    st["frame0"].fill_(int(frame0))
    st["lane0"].fill_(int(lane0))
    st["cam_vec"].copy_(cam_vec)
    if accum is None:
        st["accum"].zero_()
    else:
        st["accum"].copy_(accum)


def _segment(cfg, scene, cam_vec, o, d, m, pdf_prev, r, lbn_a, bn_prev, mid,
             active, prefix, light, st):
    """One wavefront segment over all P lanes: `active` is the live mask;
    `prefix` (compact order) the live prefix as a 0-d int32 device tensor,
    which the extension trace takes; `st` the wave's state, whose counters
    (_counters) it adds to. Returns the new (o, d, m, pdf, rng, lbn, bounce,
    medium_id), this wave's radiance, the finished mask, the hit slots and
    the count of shadow rays traced (a device scalar, 0 without
    with_stats)."""
    settings = cfg.settings
    mark = stage_marker(cfg.with_stats, o.device)
    mark("ext_trace")
    hit_slot, hit_t = trace_rays(
        scene, settings, o, d, RAY_MIN, RAY_MAX, anyhit=False,
        active=active, active_prefix=prefix)
    counted = _counters(cfg)
    if settings.has_media:
        mark("medium")
        if counted:
            st["medium_lanes"].add_((active & (mid >= 0)).sum())
        r, o, d, m, sampled_medium = medium_interaction(
            scene, r, o, d, m, hit_t, mid, active)
        if counted:
            st["medium_scatters"].add_(sampled_medium.sum())
        lbn_a = torch.where(
            sampled_medium,
            torch.clamp_max(lbn_a + 1, settings.bounce_max), lbn_a)
        miss = active & ~sampled_medium & (hit_t > 1e10)
    else:
        miss = active & (hit_t > 1e10)
    mark("surface")
    hitpoint = o + d * hit_t[:, None]
    hit_uv, smooth_n, mat_id, tri_n = fetch_attributes(
        scene, hit_slot, hitpoint)
    merged_et = (settings.merge_envtex and settings.use_texture
                 and settings.use_envmap
                 and settings.env_importance_sampling
                 and "envtex_quad" in scene)
    if merged_et:
        env, tex_rgb = env_tex_merged(scene, settings, d, pdf_prev,
                                      cam_vec[15], miss, hit_uv)
    else:
        tex_rgb = None
        env = env_miss_weighted(scene, settings, d, pdf_prev, cam_vec[15])
    contrib = torch.where(miss[:, None], m * env, 0.0)
    surf = ~miss & ~sampled_medium if settings.has_media else ~miss
    surf = active & surf

    hit = (hit_uv, smooth_n, mat_id, tri_n, hitpoint)
    (r, o, d, m, pdf_new, lb, mid, contrib, ended, n_shadow) = shade_hits(
        scene, settings, r, o, d, m, pdf_prev, lbn_a, mid, surf, hit,
        tex_rgb, contrib, cam_vec[15], light, count_rays=cfg.with_stats,
        mark=mark, counters={k: st[k] for k in counted
                             if k in BSSRDF_COUNTERS} or None)
    bn = torch.where(active, bn_prev + 1, bn_prev)
    finished = active & (miss | ended | (bn >= lb)
                         | (bn >= settings.bounce_max))
    return (o, d, m, pdf_new, r, lb, bn, mid, contrib, finished, hit_slot,
            n_shadow)


def regen_wave(cfg: WaveConfig, scene, st):
    """One wave on the state st, in place: respawn, one wavefront segment,
    the compaction permute and the dead-row flush, over all P lanes.
    Every shape is fixed and nothing is read on the host, so the same call
    runs eagerly or captured in a CUDA graph. Once the call's samples are
    done (or stop_after_waves waves have run) a wave changes no bit of the
    state: it spawns nothing, traces an empty prefix and adds zeros."""
    s = cfg.settings
    P, N = cfg.P, cfg.N
    lane, live = st["lane"], st["active"]
    mark = stage_marker(cfg.with_stats, lane.device)
    mark("respawn")
    nxt, alive, waves, tot = st["next"], st["alive"], st["waves"], st["tot"]
    go = (nxt < tot) | (alive > 0)
    if cfg.stop_after_waves:
        go = go & (waves < cfg.stop_after_waves)

    # ---- respawn: dead lanes take the next samples of the queue, in
    # order: the dead suffix [alive, P) under compact, the dead lanes in
    # lane order under inplace ----
    n_spawn = torch.where(
        go, torch.minimum(torch.clamp_min(tot - nxt, 0), P - alive), 0)
    if cfg.inplace:
        dead = ~live
        rank = torch.cumsum(dead, 0) - dead.to(torch.int64)
        spawn = dead & (rank < n_spawn)
    else:
        rank = lane - alive
        spawn = (rank >= 0) & (rank < n_spawn)
    sid = nxt + rank
    pixel_new = sid % N
    pixel_glob = pixel_new + st["lane0"]
    rng_new = RaySampler.init(wang_hash(st["frame0"] + sid // N), pixel_glob)
    pxi, pyi = lane_pixel_xy(pixel_glob, cfg.width, cfg.height)
    px, py = pxi.to(torch.float32), pyi.to(torch.float32)
    rng_new, o_new, d_new = generate_camera_rays(st["cam_vec"], rng_new, px,
                                                 py)
    sel = spawn[:, None]
    torch.where(sel, o_new, st["orig"], out=st["orig"])
    torch.where(sel, d_new, st["dir"], out=st["dir"])
    st["mask"].masked_fill_(sel, 1.0)
    st["L"].masked_fill_(sel, 0.0)
    st["bsdf_pdf"].masked_fill_(spawn, -1.0)
    torch.where(spawn, rng_new, st["rng"], out=st["rng"])
    torch.where(spawn, pixel_new, st["pixel"], out=st["pixel"])
    st["lbn"].masked_fill_(spawn, s.bounce_min)
    st["bounce"].masked_fill_(spawn, 0)
    st["medium_id"].masked_fill_(spawn, -1)
    torch.logical_or(live, spawn, out=live)
    nxt.add_(n_spawn)
    n_act = torch.where(go, alive + n_spawn, 0)
    act = live & go
    if cfg.with_stats:
        st["rays"].add_(n_act)

    # ---- one wavefront segment over all P lanes: the extension trace
    # over the live prefix (compact) or the live mask (inplace), every
    # other stage under the live mask ----
    (o, d, m, pdf_new, r, lb, bn, mid, contrib, finished, hit_slot,
     n_shadow) = _segment(
        cfg, scene, st["cam_vec"], st["orig"], st["dir"], st["mask"],
        st["bsdf_pdf"], st["rng"], st["lbn"], st["bounce"], st["medium_id"],
        act, None if cfg.inplace else n_act.to(torch.int32), st["light"], st)
    # the segment draws random numbers on every lane: the lanes outside
    # the live set keep their state
    r = torch.where(act, r, st["rng"])
    if cfg.with_stats:
        st["rays"].add_(n_shadow)
    if cfg.deferred:
        ell = st["L"] + contrib
    else:
        mark("scatter")
        st["accum"].index_add_(0, st["pixel"], contrib)
        ell = st["L"]
    alive_new = torch.where(go, n_act - finished.sum(), alive)
    waves.add_(go.to(torch.int64))

    mark("permute")
    if cfg.inplace:
        for k, v in (("orig", o), ("dir", d), ("mask", m),
                     ("bsdf_pdf", pdf_new), ("rng", r), ("lbn", lb),
                     ("bounce", bn), ("medium_id", mid)):
            st[k].copy_(v)
        torch.logical_and(live, ~finished, out=live)
    else:
        _compact(st, o, d, m, pdf_new, ell, r, lb, bn, mid, finished | ~act,
                 hit_slot)
        torch.lt(lane, alive_new, out=live)
        if cfg.deferred:
            mark("scatter")
            # the paths that died this wave are now rows [alive, n_act)
            died = (lane >= alive_new) & (lane < n_act)
            st["accum"].index_add_(
                0, st["pixel"], torch.where(died[:, None], st["L"], 0.0))
    alive.copy_(alive_new)
    more = (nxt < tot) | (alive > 0)
    if cfg.stop_after_waves:
        more = more & (waves < cfg.stop_after_waves)
    torch.stack([(~more).to(torch.int64), alive, tot - nxt],
                out=st["status"])
    mark("end")


def _compact(st, o, d, m, pdf_new, ell, r, lb, bn, mid, last, hit_slot):
    """Survivors (hit slot major, octant minor) to the front; the lanes
    `last` (dead this wave, or outside the live set) after them in lane
    order, so that the rows past the live prefix stay where they are.
    Writes every pool column in place."""
    oct_ = ((d[:, 0] < 0).to(torch.int32)
            | ((d[:, 1] < 0).to(torch.int32) << 1)
            | ((d[:, 2] < 0).to(torch.int32) << 2))
    key = torch.where(last, 2 ** 30,
                      (torch.clamp_min(hit_slot, 0) << 3) | oct_)
    # one gather moves every pool column (ops/permute.py): the kernel on
    # the card, the packed (P,16) cat, row gather and split on the CPU;
    # the kernel takes contiguous columns (.contiguous() returns those as
    # they are)
    src = torch.argsort(key, stable=True)
    pool_gather(st, src, *(t.contiguous() for t in (
        o, d, m, ell, pdf_new, r, st["pixel"], lb, bn, mid)))


class RegenIntegrator:
    """integrate_frames of make_regen_integrator, with the wave its last
    replayed call captured (`graph`, a device_loop.StepGraph of one
    capture_key, a graph a drain width; a call of another key captures
    anew), the waves its last call ran at each width (`last_waves`,
    over-run waves included) and the counters its last call kept
    (`last_counters`, {name: host int}; {} but for a with_stats call on a
    scene with media or BSSRDF)."""

    def __init__(self, settings, width, height, with_stats=False,
                 stop_after_waves=0):
        _check_settings(settings)
        stop_after_waves = int(stop_after_waves)
        if stop_after_waves < 0:
            raise ValueError("stop_after_waves must be >= 0, got %d"
                             % stop_after_waves)
        self.settings = settings
        self.width, self.height = int(width), int(height)
        self.with_stats = bool(with_stats)
        self.stop_after_waves = stop_after_waves
        self.graph, self._graph_key = None, None
        self.last_waves = {}
        self.last_counters = {}

    def _config(self, N, n_frames):
        P = N if self.settings.pool_lanes <= 0 \
            else min(self.settings.pool_lanes, N)
        if N * int(n_frames) >= 2 ** 32:
            raise ValueError("at most 2^32 samples per call (the sample id "
                             "is a uint32 in the RNG seed)")
        return WaveConfig(self.settings, self.width, self.height,
                          self.with_stats, self.stop_after_waves, int(N), P)

    def start(self, scene, cam_vec, frame0, lane0, accum, n_frames):
        """(cfg, st): a fresh eager state for a call, before its first
        wave; regen_wave(cfg, scene, st) steps it by hand."""
        cfg = self._config(accum.shape[0], n_frames)
        st = new_state(cfg, accum.device)
        reset(cfg, st, cam_vec, frame0, lane0, accum, n_frames)
        return cfg, st

    def __call__(self, scene, cam_vec, frame0, lane0, accum, n_frames):
        out = device_loop.run_call(accum.device, self.call(
            scene, cam_vec, frame0, lane0, accum, n_frames))
        if self.stop_after_waves:
            return out
        acc, waves, rays = out
        if self.with_stats:
            return acc, int(waves), float(rays)
        return acc, waves

    def call(self, scene, cam_vec, frame0, lane0, accum, n_frames):
        """One call as a generator for device_loop.run_calls: each next()
        launches one wave (the first captures on a new key); it returns
        (accum, waves, rays) with the counts as 0-d device tensors (rays 0
        without with_stats), or with stop_after_waves the pool."""
        device = accum.device
        replay = device_loop.graphs_enabled(device)
        if replay:
            cfg = self._config(accum.shape[0], n_frames)
            key = device_loop.capture_key(cfg.N, device, scene)
            if key != self._graph_key:
                self.graph = None            # its memory goes before the next
                self.graph = _capture_waves(cfg, scene, device)
                self._graph_key = key
            st, steps, ring = (self.graph.st, self.graph.steps(),
                               self.graph.ring)
            reset(cfg, st, cam_vec, frame0, lane0, accum, n_frames)
        else:
            cfg, st = self.start(scene, cam_vec, frame0, lane0, accum,
                                 n_frames)
            steps = _wave_steps(cfg, scene, st)
            ring = device_loop.StatusRing(device)
        self.last_waves, self.last_counters = {}, {}
        ran = collections.Counter()
        if int(n_frames) > 0 and cfg.N > 0:
            ring.reset()
            yield from device_loop.drive(_wave_launcher(steps, ran),
                                         st["status"], ring)
        self.last_waves = dict(ran)
        # read once, after the call (only a with_stats call keeps them)
        self.last_counters = {k: int(st[k]) for k in _counters(cfg)}
        return self._result(st, copy=replay)

    def _result(self, st, copy):
        """The call's output from its state; copy: clone what the next call
        overwrites (a captured wave's static tensors)."""
        def out(t):
            return t.clone() if copy else t
        if self.stop_after_waves:
            vec = {k: st[k].clone() for k in ("orig", "dir", "mask", "L")}
            live = st["active"].clone()
            vec["L"] = torch.where(live[:, None], vec["L"], 0.0)
            return {**vec, **{k: out(st[k]) for k in (
                "bsdf_pdf", "rng", "pixel", "lbn", "bounce", "medium_id")},
                "active": live, "waves": int(st["waves"]),
                "next": int(st["next"]), "alive": int(st["alive"])}
        return out(st["accum"]), out(st["waves"]), out(st["rays"])


def _wave_steps(cfg, scene, st):
    """{width: run one wave on st at that width} for each drain width (the
    narrower waves work on views of st)."""
    steps = {}
    for w in drain_widths(cfg):
        cfg_w, st_w = narrow(cfg, st, w)
        steps[w] = functools.partial(regen_wave, cfg_w, scene, st_w)
    return steps


def _capture_waves(cfg, scene, device):
    """The StepGraph of a call's wave at each drain width on its own state
    (the narrower waves work on views of it), captured on a finished
    call's state, so the warm-up waves change nothing."""
    st = new_state(cfg, device)
    reset(cfg, st, torch.zeros(16, device=device), 0, 0, None, 0)
    return device_loop.StepGraph(st, _wave_steps(cfg, scene, st), device,
                                 keep=scene)


def _wave_launcher(steps, ran):
    """device_loop.drive's launch for waves: steps {width: run one wave};
    with the queue spent (a status LAG waves old, whose live count can
    only have fallen since) the narrowest width that holds the live count,
    else the full width. Counts the waves run at each width in `ran`."""
    widths = sorted(steps)

    def launch(seen):
        w = widths[-1]
        if seen is not None and seen[2] == 0:
            w = min(x for x in widths if x >= seen[1])
        steps[w]()
        ran[w] += 1
    return launch


def make_regen_integrator(settings: RenderSettings, width, height,
                          with_stats=False, stop_after_waves=0):
    """Returns integrate_frames(scene, cam_vec, frame0, lane0, accum,
    n_frames) -> (accum, waves) or, with with_stats, (accum, waves, rays):
    accum plus n_frames samples per pixel, the number of waves (a host int
    with with_stats, else a 0-d int64 device tensor, which the host need
    not read), and the number of rays traced (extension + NEE shadow).
    lane0 is the global lane offset of this image slice (0 for a whole
    image). integrate_frames is a RegenIntegrator: on a CUDA device it
    captures its wave once for a capture_key (device, lanes, deterministic
    mode, scene tensors) and replays it while the calls keep that key (see
    the module docstring).

    With stop_after_waves=k > 0 the loop ends after k waves (or earlier,
    when every sample is done) and integrate_frames returns the pool as it
    stands after the last wave's compaction and dead-row flush, a dict
    with the JAX key names: orig, dir, mask, L [P,3] f32; bsdf_pdf [P] f32;
    rng, pixel [P] i64 (the port's masked uint32 and pixel index); lbn,
    bounce, medium_id [P] i32 (medium_id: the material whose medium the
    lane is inside, -1 outside any); active [P] bool, the prefix
    [0, alive) under the compact order and a mask under inplace; and the
    host integers waves, next (samples spawned) and alive, read once after
    the loop. L is 0 outside the active set, as in JAX; the other fields
    of dead rows are stale."""
    return RegenIntegrator(settings, width, height, with_stats=with_stats,
                           stop_after_waves=stop_after_waves)
