"""The port's own spans (utils/profiling.py) and stage marks
(ops/marks.py): the stage marks of a regen with_stats call in wave order,
one `respawn` a wave counted in RegenIntegrator.last_waves, `medium` after
`ext_trace` in a scene with media only, none without with_stats, the
image unchanged by them; the medium counters of
RegenIntegrator.last_counters against a count of the same call stepped
by hand; the bounce integrator's marks by portbench's contract (a frame's
`respawn` and `scatter`, each launched step's stages up to `end`) and its
live-lane counter against a count by hand; the viewer step's host spans;
stage_device_ms on a synthetic trace; and the CLI's rate line, which
synchronizes once a report. On the CPU a mark is a zero-length record_function named as the
kernel that marks the stage on the card (the card's marks are in
tests/test_torch_cuda.py)."""
import dataclasses
import functools
import json
import os
import pathlib
import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_pathtracer_torch.scene import demo
from tpu_pathtracer_torch.ops import marks as stage_marks
from tpu_pathtracer_torch.tools import interactive as viewer
from tpu_pathtracer_torch.tracer import regen, wavefront
from tpu_pathtracer_torch.tracer.renderer import (
    Renderer, camera_vector, lane_tables)
from tpu_pathtracer_torch.utils import cuda_build, profiling, timing

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
W = 8
REGEN = ["respawn", "ext_trace", "surface", "material", "shade",
         "sample_env", "shadow_trace", "permute", "scatter", "end"]


@functools.lru_cache(maxsize=None)
def _renderer(variant="default", width=W):
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=None,
                                                   variant=variant)
    return Renderer(fb, mats, envmap=envmap, texture=texture, width=width,
                    height=width, device="cpu")


def _camera(width=W):
    return demo.default_camera(width, width).build_render_camera()


def _profiled(fn, tmp_path):
    """(fn's result, the chrome trace's host events in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    events = [e for e in events if e.get("ph") == "X"]
    return out, sorted(events, key=lambda e: e["ts"])


def _marks(events):
    return [e["name"][len(stage_marks.MARK_PREFIX):] for e in events
            if e["name"].startswith(stage_marks.MARK_PREFIX)]


def _waves(marks):
    """The marks split at each respawn."""
    waves = []
    for m in marks:
        if m == "respawn":
            waves.append([])
        waves[-1].append(m)
    return waves


def test_stage_names_match_the_mark_kernels():
    with open(os.path.join(cuda_build.CSRC, "marks.cu")) as f:
        src = f.read()
    kernels = [line.split("void ")[1].split("(")[0]
               for line in src.splitlines()
               if line.startswith('extern "C" __global__ void')]
    assert kernels == [stage_marks.MARK_PREFIX + s
                       for s in stage_marks.STAGES]


@functools.lru_cache(maxsize=None)
def _profiled_render(variant, settings=(), with_stats=True):
    """(render_frames' result, the marks, the host op names, the waves
    counted) of a 1-frame call under the profiler."""
    r = _renderer(variant)
    base = r.settings
    r.settings = dataclasses.replace(base, **dict(settings))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out, events = _profiled(
                lambda: r.render_frames(r.zeros_accum(), _camera(), 1, 1,
                                        with_stats=with_stats),
                pathlib.Path(tmp))
        counted = r.regen_integrator(with_stats).last_waves
    finally:
        r.settings = base
    return out, _marks(events), {e["name"] for e in events}, counted


@pytest.mark.parametrize("variant,settings,widths", [
    ("default", (), 3), ("subsurface", (), 3),
    ("default", (("scatter_mode", "wave"),), 3), ("media", (), 2),
    ("default", (("regen_order", "inplace"),), 1),
    ("default", (("merge_envtex", False),), 3),
    ("default", (("use_distant_light", True),), 3),
    ("default", (("pool_lanes", 16),), 2),
    ("media", (("scatter_mode", "wave"),), 2)],
    ids=["default", "subsurface", "wave", "media", "inplace",
         "unmerged_envtex", "distant_light", "capped_pool", "media_wave"])
def test_with_stats_call_marks_every_stage_of_every_wave(variant, settings,
                                                         widths):
    (acc, waves, rays), marks, _, counted = _profiled_render(variant,
                                                             settings)
    want = list(REGEN)
    if variant == "subsurface":
        want.insert(want.index("shade") + 1, "bssrdf")
    if variant == "media":
        # the medium step between the closest-hit trace and the surface
        want.insert(want.index("ext_trace") + 1, "medium")
    if dict(settings).get("scatter_mode") == "wave" or \
            dict(settings).get("regen_order") == "inplace":
        # every wave adds its contribution before the permute
        want.remove("scatter")
        want.insert(want.index("permute"), "scatter")
    per_wave = _waves(marks)
    # every wave launched, the one past the end included (device_loop.LAG)
    assert len(per_wave) == sum(counted.values()) == waves + 1 > 3
    # the drain widths ran (the media paths at 8x8 end before the live
    # count reaches the narrowest width's 4 lanes, and a 16-lane pool's
    # paths before its 1 lane; inplace has no drain)
    assert len(counted) == widths
    assert all(w == want for w in per_wave), per_wave[0]


BOUNCE_FRAMES = 2


def _bounce_step_marks(variant):
    """The marks of one bounce step by the contract of
    portbench/metrics/_stages.py."""
    return (["ext_trace"] + (["medium"] if variant == "media" else [])
            + ["surface", "material", "shade"]
            + (["bssrdf"] if variant == "subsurface" else [])
            + ["sample_env", "shadow_trace", "end"])


@functools.lru_cache(maxsize=None)
def _profiled_bounce(variant):
    """{True: (the with_stats bounce call's (accum, bounces, rays), its
    marks' trace events, the steps it launched, its counters), False: (the
    same call without with_stats, (accum, bounces), the stages it passed
    to ops/marks.py: stage_mark, its counters)} of a call of BOUNCE_FRAMES
    frames; the with_stats call under the profiler."""
    r = _renderer(variant)
    base = r.settings
    r.settings = dataclasses.replace(base, integrator="bounce")
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            res, events = _profiled(
                lambda: r.render_frames(r.zeros_accum(), _camera(), 1,
                                        BOUNCE_FRAMES, with_stats=True),
                pathlib.Path(tmp))
        fn = r.bounce_integrator(True)
        out[True] = (res, [e for e in events if e["name"].startswith(
            stage_marks.MARK_PREFIX)], fn.last_launched,
            dict(fn.last_counters))
        fn = r.bounce_integrator(False)
        marked, plain_mark = [], stage_marks.stage_mark
        stage_marks.stage_mark = lambda stage, device: marked.append(stage)
        try:
            res = fn(r.scene, camera_vector(_camera(), "cpu"), 1, 0,
                     r.zeros_accum(), BOUNCE_FRAMES)
        finally:
            stage_marks.stage_mark = plain_mark
        out[False] = (res, marked, fn.last_launched, dict(fn.last_counters))
    finally:
        r.settings = base
    return out


def _hand_bounce_counts(variant):
    """(accum, the live-lane count) of the bounce call of _profiled_bounce
    without with_stats, stepped eagerly by hand (BounceIntegrator.start,
    frame_start, bounce_step, frame_end): st["active"].sum() before each
    step that runs, until the step's status reads done."""
    r = _renderer(variant)
    settings = dataclasses.replace(r.settings, integrator="bounce")
    fn = wavefront.make_integrator(settings)
    cfg, st = fn.start(r.scene, camera_vector(_camera(), "cpu"), 1, 0,
                       r.zeros_accum(), BOUNCE_FRAMES)
    live = 0
    for _ in range(BOUNCE_FRAMES):
        wavefront.frame_start(cfg, r.scene, st)
        while True:
            live += int(st["active"].sum())
            wavefront.bounce_step(cfg, r.scene, st)
            if bool(st["status"][0]):
                break
        wavefront.frame_end(cfg, r.scene, st)
    return st["accum"], live


@pytest.mark.parametrize("variant", ["default", "subsurface", "media"])
def test_bounce_with_stats_marks_every_step(variant):
    """A with_stats bounce call marks frame_start `respawn` and frame_end
    `scatter` once a frame, and each launched step (the no-op steps after
    a frame's end among them) the contract's stages from `ext_trace` to
    `end`; portbench's marks_whole takes the trace (the CPU's marks given
    the card's device category). The marks leave the image and the bounce
    count as the same call without with_stats gives them, and that call
    marks nothing."""
    from portbench.metrics import _stages
    got = _profiled_bounce(variant)
    (acc, bounces, rays), events, launched, _ = got[True]
    (plain, plain_bounces), plain_marks, _, _ = got[False]
    marks = _marks(events)
    step = _bounce_step_marks(variant)
    frames = []
    for m in marks:
        if m == "respawn":
            frames.append([])
        frames[-1].append(m)
    assert len(frames) == BOUNCE_FRAMES
    for f in frames:
        assert f[-1] == "scatter"
        body = f[1:-1]
        assert body == step * (len(body) // len(step)) and body
    assert marks.count("end") == launched >= bounces > 0
    assert marks.count("scatter") == marks.count("respawn") == BOUNCE_FRAMES
    on_card = [dict(e, cat="kernel") for e in events]
    assert _stages.marks_whole(on_card, {W * W: launched}, "bounce",
                               BOUNCE_FRAMES)
    # one mark short: the trace is not whole
    assert not _stages.marks_whole(on_card[:-2] + on_card[-1:],
                                   {W * W: launched}, "bounce",
                                   BOUNCE_FRAMES)
    assert torch.equal(acc, plain) and bounces == int(plain_bounces)
    assert plain_marks == []


@pytest.mark.parametrize("variant", ["default", "subsurface", "media"])
def test_bounce_counters_equal_a_count_by_hand(variant):
    """A with_stats bounce call publishes in last_counters the lanes live
    at the start of each step (`bounce_live_lanes`): the sum of the active
    lanes before each step of the same call stepped by hand; on the
    subsurface scene also the probe loop's `bssrdf_lanes` and
    `bssrdf_exits`, as a regen call does. A call without with_stats
    publishes {}."""
    got = _profiled_bounce(variant)
    acc, _, _, counters = got[True]
    hand_acc, live = _hand_bounce_counts(variant)
    want = {"bounce_live_lanes"} | (set(wavefront.BSSRDF_COUNTERS)
                                    if variant == "subsurface" else set())
    assert set(counters) == want
    assert all(type(v) is int for v in counters.values())
    assert counters["bounce_live_lanes"] == live > 0
    assert torch.equal(acc[0], hand_acc)
    if variant == "subsurface":
        assert 0 < counters["bssrdf_exits"] <= counters["bssrdf_lanes"]
    assert got[False][3] == {}


def test_call_without_stats_marks_nothing():
    acc, marks, names, _ = _profiled_render("default", with_stats=False)
    assert marks == [] and "aten::index_add_" in names


@pytest.mark.parametrize("variant", ["default", "subsurface"])
def test_scenes_without_media_keep_their_marks(variant):
    """The marks of a wave as they were before the `medium` stage: a scene
    without media launches no `medium` mark and every other one as
    before."""
    _, marks, _, _ = _profiled_render(variant)
    before = {"default": ["respawn", "ext_trace", "surface", "material",
                          "shade", "sample_env", "shadow_trace", "permute",
                          "scatter", "end"],
              "subsurface": ["respawn", "ext_trace", "surface", "material",
                             "shade", "bssrdf", "sample_env",
                             "shadow_trace", "permute", "scatter", "end"]}
    assert "medium" not in marks
    assert marks == before[variant] * len(_waves(marks))


@pytest.mark.parametrize("variant,settings", [
    ("default", ()), ("subsurface", ()), ("media", ()),
    ("default", (("scatter_mode", "wave"),)),
    ("default", (("regen_order", "inplace"),)),
    ("default", (("merge_envtex", False),)),
    ("default", (("use_distant_light", True),))],
    ids=["default", "subsurface", "media", "wave", "inplace",
         "unmerged_envtex", "distant_light"])
def test_marks_leave_the_image_bits(variant, settings):
    (marked, _, _), marks, _, _ = _profiled_render(variant, settings)
    r = _renderer(variant)
    base = r.settings
    r.settings = dataclasses.replace(base, **dict(settings))
    try:
        plain = r.render_frames(r.zeros_accum(), _camera(), 1, 1)
    finally:
        r.settings = base
    assert marks
    assert torch.equal(marked, plain)


def _hand_counts(r, cam, n_frames, monkeypatch):
    """(accum, {medium_lanes, medium_scatters}) of a call without
    with_stats stepped by hand at the full width (RegenIntegrator.start,
    regen_wave), counted around each wave's medium_interaction: its live
    lanes inside a medium and the lanes it scattered."""
    counted = {"medium_lanes": 0, "medium_scatters": 0}
    plain = regen.medium_interaction

    def counting(scene, rng, orig, raydir, mask, hit_t, medium_id, active):
        out = plain(scene, rng, orig, raydir, mask, hit_t, medium_id, active)
        counted["medium_lanes"] += int((active & (medium_id >= 0)).sum())
        counted["medium_scatters"] += int(out[-1].sum())
        return out
    monkeypatch.setattr(regen, "medium_interaction", counting)
    fn = regen.make_regen_integrator(r.settings, r.width, r.height)
    cfg, st = fn.start(r.scene, camera_vector(cam, "cpu"), 1, 0,
                       r.zeros_accum(), n_frames)
    while not bool(st["status"][0]):
        regen.regen_wave(cfg, r.scene, st)
    monkeypatch.setattr(regen, "medium_interaction", plain)
    return st["accum"], counted


def test_medium_counters_equal_a_count_by_hand(monkeypatch):
    """A with_stats call on a scene with media publishes, in
    last_counters, the live lanes inside a medium at the medium step and
    the lanes that scattered, summed over every wave at every drain width:
    the count of the same call stepped by hand at the full width."""
    r = _renderer("media", 16)
    cam = _camera(16)
    acc, waves, rays = r.render_frames(r.zeros_accum(), cam, 1, 2,
                                       with_stats=True)
    fn = r.regen_integrator(True)
    assert len(fn.last_waves) >= 2              # a drain width ran
    got = fn.last_counters
    hand_acc, want = _hand_counts(r, cam, 2, monkeypatch)
    assert got == want and all(type(v) is int for v in got.values())
    assert 0 < got["medium_scatters"] < got["medium_lanes"]
    assert torch.equal(acc, hand_acc)
    # a call without with_stats keeps no counter, nor does its integrator
    r.render_frames(r.zeros_accum(), cam, 1, 2)
    assert r.regen_integrator(False).last_counters == {}
    assert r.regen_integrator(True).last_counters == want


@pytest.mark.parametrize("variant", ["default", "subsurface"])
def test_scene_without_media_publishes_no_counter(variant):
    """No medium counter; the subsurface scene publishes the BSSRDF
    counters alone."""
    r = _renderer(variant)
    r.render_frames(r.zeros_accum(), _camera(), 1, 1, with_stats=True)
    fn = r.regen_integrator(True)
    want = set(regen.BSSRDF_COUNTERS) if variant == "subsurface" else set()
    assert set(fn.last_counters) == want
    assert sum(fn.last_waves.values()) > 0


VIEWER_SPANS = ("pt.viewer.preview", "pt.image.unswizzle", "pt.image.copy")


def test_preview_step_holds_one_of_each_viewer_span(tmp_path):
    r = _renderer(width=64)
    lo = viewer.preview_renderer(r, demo.testobj_scene(cache_dir=None), 2)
    s = viewer.ViewerSession(r, demo.default_camera(64, 64), lo,
                             cam_path=str(tmp_path / "v.cam"),
                             out_dir=str(tmp_path), clock=lambda: 100.0)
    img, events = _profiled(
        lambda: s.step([("MOUSE", "press", 0, False, 10, 10),
                        ("MOUSE", "drag", 0, False, 13, 11)]), tmp_path)
    assert s.kind == "preview" and img.shape == (64, 64, 3)
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("pt.")]
    assert sorted(e["name"] for e in spans) == sorted(VIEWER_SPANS)
    by = {e["name"]: e for e in spans}
    # the un-swizzle (with the upscale) runs after the preview, the copy
    # to the host last
    order = sorted(VIEWER_SPANS, key=lambda n: by[n]["ts"])
    assert order == list(VIEWER_SPANS)
    # the plain host path: the tonemap's uint8 lanes scattered through the
    # lane tables in numpy, then np.repeat
    acc = lo.render_frames(lo.zeros_accum(), s.camera, 1, 1)
    u8 = (torch.pow(torch.clamp(acc / 1.0, 0.0, 1.0), 1.0 / 2.2) * 255.0
          + 0.5).to(torch.uint8).numpy()
    px, py = lane_tables(lo.width, lo.height)
    want = np.zeros((lo.height, lo.width, 3), np.uint8)
    want[py, px] = u8
    np.testing.assert_array_equal(img, want.repeat(2, 0).repeat(2, 1))


def test_span_is_the_shared_null_context_without_a_profiler():
    assert profiling.span("pt.a") is profiling.span("pt.b")
    with profiling.span("pt.a") as v:
        assert v is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("pt.a") is not profiling.span("pt.a")
    assert stage_marks.stage_marker(False, torch.device("cpu")) is \
        stage_marks.stage_marker(False, torch.device("cuda")) is \
        stage_marks.no_mark


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": float(ts),
            "dur": float(dur), "args": {}, "tid": 1}


def _stage_trace():
    m = stage_marks.MARK_PREFIX
    return [
        _ev("window", 0, 1000, "user_annotation"),
        _ev("before_first_mark", 5, 5),
        # wave 1
        _ev(m + "respawn", 10, 1), _ev("elementwise", 12, 20),
        _ev(m + "permute", 40, 1), _ev("CatArrayBatchedCopy", 42, 30),
        _ev("vectorized_gather_kernel", 75, 40),
        _ev(m + "end", 120, 1),
        _ev("Memcpy DtoH", 125, 3, "gpu_memcpy"),       # the status copy
        # wave 2 (a drain wave)
        _ev(m + "respawn", 200, 1), _ev("elementwise", 202, 8),
        _ev(m + "scatter", 215, 1), _ev("indexFuncLargeIndex", 217, 10),
        _ev(m + "end", 230, 1),
        _ev("cudaGraphLaunch", 240, 5, "cuda_runtime"),   # host: not counted
        _ev("elementwise", 1500, 50),                     # after the window
    ]


def test_stage_device_ms_on_a_synthetic_trace():
    got = profiling.stage_device_ms(_stage_trace(), "window")
    assert got["stages"] == pytest.approx(
        {"respawn": 0.028, "permute": 0.070, "scatter": 0.010})
    assert got["none_ms"] == pytest.approx(0.008)      # 5 + 3 us
    assert got["marks_ms"] == pytest.approx(0.006) and got["marks"] == 6
    assert got["wave_starts"] == [10.0, 200.0]
    assert got["wave_ms"] == pytest.approx([0.090, 0.018])
    # every device event of the window is in a stage, in none or a mark
    total = sum(got["stages"].values()) + got["none_ms"] + got["marks_ms"]
    assert total == pytest.approx((5 + 20 + 30 + 40 + 3 + 8 + 10 + 6) / 1e3)
    assert profiling.stage_device_ms(_stage_trace()[:2], "window") == {
        "stages": {}, "none_ms": 0.005, "marks_ms": 0.0, "marks": 0,
        "wave_starts": [], "wave_ms": []}


def test_rate_line_synchronizes_once_a_report(monkeypatch):
    synced = []
    monkeypatch.setattr(timing, "synchronize", synced.append)
    meter = timing.RateMeter("cpu", interval=1.0)
    clock = iter([0.2, 0.5, 1.5, 2.0, 3.1, 4.0])
    meter.timer.elapsed = lambda: next(clock)
    lines = []
    for _ in range(4):
        meter.tick(100, out=lines.append, frames=2)
    # ticks at 0.2 and 0.5 s pass without a report; the third reports,
    # read after the synchronize (2.0 s), and so does the fourth
    assert synced == [torch.device("cpu")] * 2
    assert lines == [
        "time 2.0s, frames 6, 333.33 ms/frame, 3.0 FPS, 0.00 Mpaths/s",
        "time 4.0s, frames 8, 500.00 ms/frame, 2.0 FPS, 0.00 Mpaths/s"]
