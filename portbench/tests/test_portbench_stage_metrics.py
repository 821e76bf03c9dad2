"""The readers of the program's own stage marks and viewer spans
(portbench/metrics/_stages.py) on small chrome traces of the shape
torch.profiler writes: a replayed graph's stage marks are kernels named
pt_stage_<stage>, a span is a user_annotation. A trace of a program
without them gives None for every such metric, and so does an empty run."""
import pytest

from pb_helpers import ROOT, bench, toy  # noqa: F401  (bench: a fixture)

W = "portbench_window"
STAGE_METRICS = ["stage_ms." + s for s in (
    "respawn", "ext_trace", "surface", "material", "shade", "bssrdf",
    "sample_env", "shadow_trace", "permute", "scatter")]
SPAN_METRICS = ["preview_span_ms", "readback_copy_ms",
                "readback_unswizzle_ms", "readback_traced_ms"]
READBACK = ["readback_copy_ms", "readback_unswizzle_ms"]


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": float(ts),
            "dur": float(dur), "args": {}, "tid": 1}


def _wave(t, stages, us=10):
    """A wave's marks from time t, each stage followed by one kernel of
    `us` microseconds, then the end mark and a status copy."""
    out = []
    for s in stages:
        out += [_ev("pt_stage_" + s, "kernel", t, 1),
                _ev("elementwise_kernel", "kernel", t + 2, us)]
        t += us + 3
    out += [_ev("pt_stage_end", "kernel", t, 1),
            _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", t + 2, 2)]
    return out, t + 10


def render_trace():
    """Three waves: two at the full width (20 us a stage), one drain wave
    (5 us a stage); no BSSRDF stage."""
    return render_trace_with([])


def _read(name, run):
    from portbench.run import read_metric
    return read_metric(name, run)


def test_stage_readers_give_ms_a_frame():
    run = {"loop": "render", "events": render_trace(), "window": W,
           "frames": 2, "waves": {1024: 2, 256: 1}}
    for name in STAGE_METRICS:
        want = None if name == "stage_ms.bssrdf" else (20 + 20 + 5) / 1e3 / 2
        got = _read(name, run)
        assert got == (pytest.approx(want) if want else None), name
    # the last wave: 9 stages of 5 us
    assert _read("drain_ms_per_call", run) == pytest.approx(0.045)
    assert _read("drain_ms_per_call", dict(run, waves={1024: 3})) == 0.0
    # a counter that disagrees with the marks gives nothing
    assert _read("drain_ms_per_call", dict(run, waves={1024: 5})) is None


def render_trace_with(extra, after="ext_trace"):
    """render_trace's three waves with the stages `extra` marked after the
    stage `after`, each with its kernel."""
    stages = ["respawn", "ext_trace", "surface", "material", "shade",
              "sample_env", "shadow_trace", "permute", "scatter"]
    at = stages.index(after) + 1
    stages[at:at] = extra
    ev, t = [_ev(W, "user_annotation", 0, 10000),
             _ev("cudaGraphLaunch", "cuda_runtime", 1, 5)], 10
    for us in (20, 20, 5):
        w, t = _wave(t, stages, us)
        ev += w
    return ev


def test_a_new_stage_mark_is_read_by_its_name(tmp_path):
    """A stage the program adds, `medium`, marked between `ext_trace` and
    `surface`: the medium's kernels, which a trace without its mark files
    under `ext_trace`, go to `medium`, `ext_trace` loses exactly their
    time, every other reading stays, and a reader file
    stage_ms.medium.py is all it takes to report it."""
    from portbench.metrics import _stages
    from portbench.run import read_metric
    marked = render_trace_with(["medium"])
    bare = [e for e in marked if e["name"] != "pt_stage_medium"]
    run = {"loop": "render", "events": bare, "window": W, "frames": 2,
           "waves": {1024: 2, 256: 1}}
    mrun = dict(run, events=marked)
    assert _stages.stage_ms(run, "medium") is None
    medium = (20 + 20 + 5) / 1e3 / 2
    assert _stages.stage_ms(mrun, "medium") == pytest.approx(medium)
    assert _read("stage_ms.ext_trace", mrun) == pytest.approx(
        _read("stage_ms.ext_trace", run) - medium)
    assert _read("stage_ms.ext_trace", run) == pytest.approx(2 * medium)
    for name in STAGE_METRICS + ["drain_ms_per_call"]:
        if name != "stage_ms.ext_trace":
            assert _read(name, mrun) == _read(name, run), name
    a = _stages.stage_device_ms(bare, W)
    b = _stages.stage_device_ms(marked, W)
    assert b["wave_ms"] == a["wave_ms"] and b["none_ms"] == a["none_ms"]
    assert b["marks"] == a["marks"] + 3
    reader = tmp_path / "portbench" / "metrics" / "stage_ms.medium.py"
    reader.parent.mkdir(parents=True)
    reader.write_text("from portbench.metrics._stages import stage_ms\n\n\n"
                      "def read(run):\n"
                      "    return stage_ms(run, \"medium\")\n")
    assert read_metric("stage_ms.medium", mrun, str(tmp_path)) == \
        pytest.approx(medium)
    assert read_metric("stage_ms.medium", run, str(tmp_path)) is None


def test_stage_device_ms_of_the_benchmark():
    from portbench.metrics import _stages
    got = _stages.stage_device_ms(render_trace(), W)
    assert got["marks"] == 30 and got["marks_ms"] == pytest.approx(0.030)
    assert got["none_ms"] == pytest.approx(0.006)        # the status copies
    assert got["wave_ms"] == pytest.approx([0.18, 0.18, 0.045])
    assert len(got["wave_starts"]) == 3


def test_marks_outside_the_host_window_still_count():
    """The profiler's device timestamps stray from the host's clock, so a
    wave's marks can fall before or after the host's window: the stage
    readers take every device event of the trace, and read the same as
    with the marks inside it."""
    run = {"loop": "render", "events": render_trace(), "window": W,
           "frames": 2, "waves": {1024: 2, 256: 1}}
    strayed = [dict(e, ts=20.0, dur=300.0) if e["name"] == W else e
               for e in run["events"]]
    srun = dict(run, events=strayed)
    for name in STAGE_METRICS + ["drain_ms_per_call"]:
        assert _read(name, srun) == _read(name, run), name
    assert _read("drain_ms_per_call", srun) == pytest.approx(0.045)


def test_marks_whole_tells_a_trace_that_lost_records():
    from portbench.metrics import _stages
    ev = render_trace()
    assert _stages.marks_whole(ev, {1024: 2, 256: 1})
    assert not _stages.marks_whole(ev, {1024: 3, 256: 1})
    # the second wave's records lost, its respawn mark with them
    first_end = next(i for i, e in enumerate(ev)
                     if e["name"] == "pt_stage_end")
    second_end = next(i for i, e in enumerate(ev)
                      if e["name"] == "pt_stage_end" and i > first_end)
    lost = ev[:first_end + 2] + ev[second_end - 3:]
    assert not _stages.marks_whole(lost, {1024: 2, 256: 1})
    # only an end mark lost
    no_end = [e for i, e in enumerate(ev) if i != second_end]
    assert not _stages.marks_whole(no_end, {1024: 2, 256: 1})
    # one mark of a middle stage lost
    one = next(i for i, e in enumerate(ev) if e["name"] == "pt_stage_shade")
    assert not _stages.marks_whole(ev[:one] + ev[one + 1:],
                                   {1024: 2, 256: 1})
    # a trace without marks: nothing a second call could mend
    bare = [e for e in ev if not e["name"].startswith("pt_stage_")]
    assert _stages.marks_whole(bare, {1024: 2, 256: 1})


BOUNCE_STEP = ["ext_trace", "surface", "material", "shade", "sample_env",
               "shadow_trace"]


def bounce_trace(frames=2, steps=3, medium=False):
    """A bounce call's marks as the contract in _stages.py sets them: a
    frame's `respawn` (frame_start, 30 us), `steps` launched bounce steps
    (each stage a 10 us kernel, `medium` after `ext_trace` where asked,
    then `end` and the status copy), the frame's `scatter` (frame_end, the
    late environment fetch, 40 us)."""
    step = list(BOUNCE_STEP)
    if medium:
        step.insert(1, "medium")
    ev, t = [_ev(W, "user_annotation", 0, 10 ** 6),
             _ev("cudaGraphLaunch", "cuda_runtime", 1, 5)], 10
    for _ in range(frames):
        ev += [_ev("pt_stage_respawn", "kernel", t, 1),
               _ev("elementwise_kernel", "kernel", t + 2, 30)]
        t += 40
        for _ in range(steps):
            w, t = _wave(t, step, 10)
            ev += w
        ev += [_ev("pt_stage_scatter", "kernel", t, 1),
               _ev("env_miss_kernel", "kernel", t + 2, 40)]
        t += 50
    return ev


def _drop(ev, name, k=1):
    """ev without the k-th event named name."""
    at = [i for i, e in enumerate(ev) if e["name"] == name][k]
    return ev[:at] + ev[at + 1:]


def test_bounce_trace_by_the_contract_is_whole():
    from portbench.metrics import _stages
    for medium in (False, True):
        ev = bounce_trace(medium=medium)
        assert _stages.marks_whole(ev, {4096: 6}, "bounce", 2)
        # the regen rule does not take it: one respawn a frame, not a step
        assert not _stages.marks_whole(ev, {4096: 6})
    bare = [e for e in bounce_trace() if not e["name"].startswith(
        "pt_stage_")]
    assert _stages.marks_whole(bare, {4096: 6}, "bounce", 2)


@pytest.mark.parametrize("case", [
    "lost end", "lost respawn", "lost scatter", "lost shade", "lost medium",
    "more steps counted", "fewer steps counted", "more frames counted",
    "no steps counted"])
def test_bounce_trace_that_lost_marks_is_not_whole(case):
    from portbench.metrics import _stages
    ev, steps, frames = bounce_trace(medium=True), 6, 2
    if case.startswith("lost "):
        ev = _drop(ev, "pt_stage_" + case[len("lost "):])
    steps += {"more steps counted": 1, "fewer steps counted": -1,
              "no steps counted": -6}.get(case, 0)
    frames += case == "more frames counted"
    assert not _stages.marks_whole(ev, {4096: steps}, "bounce", frames)


def test_stage_readers_on_a_bounce_trace():
    """Each bounce step's work falls to its stage, the frame's late
    environment fetch to `scatter`, and a wave of stage_device_ms is a
    frame."""
    from portbench.metrics import _stages
    run = {"loop": "render", "integrator": "bounce", "frames": 2,
           "events": bounce_trace(), "window": W, "waves": {4096: 6}}
    for s in BOUNCE_STEP:
        assert _read("stage_ms." + s, run) == pytest.approx(0.030), s
    assert _read("stage_ms.respawn", run) == pytest.approx(0.030)
    assert _read("stage_ms.scatter", run) == pytest.approx(0.040)
    assert _read("stage_ms.permute", run) is None
    assert _read("waves_per_frame", run) == pytest.approx(3.0)
    got = _stages.stage_device_ms(run["events"], W)
    assert got["wave_ms"] == pytest.approx([0.25, 0.25])
    assert got["none_ms"] == pytest.approx(0.012)       # the status copies


def _drag_trace(steps=2):
    ev = [_ev(W, "user_annotation", 0, 10 ** 7)]
    t = 100
    for _ in range(steps):
        for name, dur in (("pt.viewer.preview", 25000),
                          ("pt.image.unswizzle", 9000),
                          ("pt.image.copy", 1000)):
            ev.append(_ev(name, "user_annotation", t, dur))
            # the device's view of a record_function, not a host span
            ev.append(_ev(name, "gpu_user_annotation", t, dur))
            t += dur + 10
    return ev


def test_span_readers_give_ms_a_step():
    # the benchmark's own spans (s): three untraced steps with a 0.030 s
    # readback, then the two traced ones with 0.020 and 0.024 s
    render = [(i, i + 0.025) for i in range(5)]
    step = [(i, i + 0.025 + rb) for i, rb in
            enumerate((0.030, 0.030, 0.030, 0.020, 0.024))]
    run = {"loop": "drag", "events": _drag_trace(), "window": W,
           "spans": {"render": render, "step": step}}
    assert _read("preview_span_ms", run) == pytest.approx(25.0)
    assert _read("readback_copy_ms", run) == pytest.approx(1.0)
    assert _read("readback_unswizzle_ms", run) == pytest.approx(9.0)
    # the readback of the two traced steps only, not readback_ms's 26.8
    assert _read("readback_traced_ms", run) == pytest.approx(22.0)
    assert _read("readback_ms", run) == pytest.approx(26.8)
    # more traced steps than the benchmark timed: nothing to compare
    assert _read("readback_traced_ms", dict(run, events=_drag_trace(
        6))) is None
    # the render readers find nothing in a drag run, and back
    assert _read("stage_ms.permute", run) is None
    render = {"loop": "render", "events": render_trace(), "window": W,
              "frames": 2}
    assert _read("readback_copy_ms", render) is None


@pytest.mark.parametrize("name", STAGE_METRICS + SPAN_METRICS
                         + ["drain_ms_per_call"])
def test_a_program_without_marks_or_spans_gives_none(name):
    """The parent of the marks: kernels and host ops, no pt_ event."""
    bare = [e for e in render_trace() + _drag_trace()[1:]
            if not e["name"].startswith(("pt_stage_", "pt."))]
    for loop in ("render", "drag"):
        run = {"loop": loop, "events": bare, "window": W, "frames": 2,
               "waves": {1024: 3}, "spans": {}}
        assert _read(name, run) is None
    assert _read(name, {}) is None


def test_traced_drag_on_the_cpu_reports_the_viewer_spans(bench):
    """A toy traced drag run on the CPU: the program's viewer spans are in
    its trace, so their readers report; on the CPU a stage mark is no
    device event, so the stage readers report nothing there."""
    from portbench.run import run_cell
    res = run_cell(bench, "testobj_large_drag_1080p", 2 ** 31 + 7, 0.5, 1,
                   "cpu", toy(bench, "testobj_large_drag_1080p"))
    m = res["metrics"]
    assert all(m[n]["value"] > 0 and m[n]["unit"] == "ms"
               for n in SPAN_METRICS), sorted(m)
    # the program's spans lie inside the benchmark's readback of the same
    # steps (host clocks; 1 ms for the two clocks' rounding)
    assert sum(m[n]["value"] for n in READBACK) \
        <= m["readback_traced_ms"]["value"] + 1.0
    assert res["correct"]
