"""The per-layer readers' arithmetic on a small chrome trace of the shape
torch.profiler writes (a replayed graph's kernels carry no launching op)."""
import pytest

from pb_helpers import ROOT, bench, toy  # noqa: F401  (bench: a fixture)

W = "portbench_window"


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": float(ts),
            "dur": float(dur), "args": args, "tid": 1}


def trace():
    return [
        _ev(W, "user_annotation", 1000, 1000),
        _ev("cudaGraphLaunch", "cuda_runtime", 1000, 10),
        _ev("void traverse_kernel<false,false,false>", "kernel", 1010, 100),
        _ev("vectorized_gather_kernel", "kernel", 1110, 200),
        _ev("CatArrayBatchedCopy", "kernel", 1310, 50),
        _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1360, 40),
        _ev("cudaStreamSynchronize", "cuda_runtime", 1400, 300),
        # a gap 1400-1700 while the host synchronizes
        _ev("void traverse_kernel<true,false,false>", "kernel", 1700, 100),
        _ev("elementwise_kernel", "kernel", 1800, 100),
        # before the window: not counted
        _ev("void traverse_kernel<false,false,false>", "kernel", 500, 100),
    ]


def read(name, run):
    from portbench.run import read_metric
    return read_metric(name, run)


def test_device_busy_and_idle():
    from portbench.metrics import _trace
    b = _trace.device_busy(trace(), W)
    assert b["window_ms"] == pytest.approx(1.0)
    assert b["busy_ms"] == pytest.approx(0.59)
    run = {"loop": "render", "events": trace(), "window": W, "frames": 2}
    assert read("device_idle_pct.render", run) == pytest.approx(41.0)
    assert read("device_idle_pct.drag", run) is None
    assert read("device_idle_pct.drag", dict(run, loop="drag")) == \
        pytest.approx(41.0)


def test_gather_copy_and_roofline():
    run = {"loop": "render", "events": trace(), "window": W, "frames": 2,
           "rays": 1e6, "stream_rows": 1000, "waves": {1024: 6, 256: 2}}
    # gather 200 + cat 50 + memcpy 40 us over 2 frames
    assert read("gather_copy_ms_per_frame", run) == pytest.approx(0.145)
    # two traversal launches, 200 us: (1e6 * 32 + 2 * 1000 * 64) B
    want = (1e6 * 32 + 2 * 1000 * 64) / 3.35e12 / 200e-6 * 100
    assert read("trace_roofline_pct", run) == pytest.approx(want)
    assert read("waves_per_frame", run) == pytest.approx(4.0)
    assert read("trace_roofline_pct", dict(run, rays=0)) is None


def test_breakdown():
    from portbench.metrics import _trace
    ops = dict(_trace.device_ops_top(trace(), W))
    assert ops["trace: void traverse_kernel<false,false,false>"] == \
        pytest.approx(100e-6)
    assert ops["layout_copies: CatArrayBatchedCopy"] == pytest.approx(50e-6)
    gaps = dict(_trace.idle_gaps_top(trace(), W))
    assert gaps["cudaStreamSynchronize"] == pytest.approx(300e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["after cudaStreamSynchronize"] == pytest.approx(100e-6)
    assert sum(gaps.values()) == pytest.approx(410e-6)


def test_span_readers():
    run = {"loop": "drag", "spans": {"render": [(0.0, 0.03), (1.0, 1.05)],
                                     "step": [(0.0, 0.04), (1.0, 1.07)]}}
    assert read("preview_render_ms", run) == pytest.approx(40.0)
    assert read("readback_ms", run) == pytest.approx(15.0)
    assert read("readback_ms", {"spans": {}}) is None


def test_counters_reach_a_reader(tmp_path):
    """A counter the program publishes reaches a reader file by its name
    (run["counters"]); a missing counter, or a run without counters, gives
    None."""
    from portbench.run import read_metric
    reader = tmp_path / "portbench" / "metrics" / "medium_scatters.py"
    reader.parent.mkdir(parents=True)
    reader.write_text("def read(run):\n"
                      "    return run.get(\"counters\", {}).get("
                      "\"medium.scatters\")\n")
    run = {"loop": "render", "counters": {"medium.scatters": 4096}}
    assert read_metric("medium_scatters", run, str(tmp_path)) == 4096
    assert read_metric("medium_scatters", dict(run, counters={}),
                       str(tmp_path)) is None
    assert read_metric("medium_scatters", {}, str(tmp_path)) is None


class _Integrator:
    pass


class _Renderer:
    """The renderer's cache of integrators, keyed as the port keys it
    (kind, settings, with_stats, ...), most recently used last, each
    integrator with the attributes `built` gives it (last_counters,
    last_waves, last_launched); building one here is a fault."""
    width, height, lane_chunk = 1920, 1080, 1 << 23

    def __init__(self, *built):
        import collections
        self._integrators = collections.OrderedDict()
        for key, attrs in built:
            fn = self._integrators[key] = _Integrator()
            fn.__dict__.update(attrs)

    def regen_integrator(self, *args, **kwargs):
        raise AssertionError("the lookup built an integrator")

    integrator = bounce_integrator = regen_integrator


def test_program_counters_are_flat():
    import torch
    from portbench import program
    assert program.counters(_Renderer()) == {}
    assert program.counters(_Renderer((("regen", None, True), {}))) == {}
    got = program.counters(_Renderer((("regen", None, True), {
        "last_counters": {"medium.scatters": torch.tensor(7),
                          "medium.paths": 3,
                          "medium.tr_mean": torch.tensor(0.5)}})))
    assert got == {"medium.scatters": 7, "medium.paths": 3,
                   "medium.tr_mean": 0.5}
    assert all(type(v) in (int, float) for v in got.values())


def test_program_counters_read_the_last_stats_call():
    """Of the integrators built, the one of the last with_stats call: not
    one without stats used after it, not an older one."""
    from portbench import program
    r = _Renderer((("regen", None, True, 0), {"last_counters": {"old": 1}}),
                  (("bounce", None, True), {"last_counters": {"new": 2}}),
                  (("regen", None, False, 0),
                   {"last_counters": {"plain": 3}}))
    assert program.counters(r) == {"new": 2}
    assert program.counters(_Renderer(
        (("regen", None, False, 0), {"last_counters": {"plain": 3}}))) == {}


def test_traced_waves_read_the_integrator_the_call_ran():
    """The waves of the last with_stats call, from the integrator it ran
    and nothing built: a regen integrator's last_waves; a bounce
    integrator's launched steps as {lanes of a step: last_launched}, the
    lanes W*H up to one lane chunk."""
    from portbench import program
    assert program.traced_waves(_Renderer()) == {}
    regen = (("regen", None, True, 0), {"last_waves": {1 << 20: 6,
                                                       1 << 18: 1}})
    bounce = (("bounce", None, True), {"last_launched": 37,
                                       "last_waves": {9: 9}})
    plain = (("regen", None, False, 0), {"last_waves": {1: 1}})
    assert program.traced_waves(_Renderer(regen, plain)) == {
        1 << 20: 6, 1 << 18: 1}
    assert program.traced_waves(_Renderer(regen, bounce, plain)) == {
        1920 * 1080: 37}
    assert program.traced_waves(_Renderer(bounce, regen)) == {
        1 << 20: 6, 1 << 18: 1}
    assert program.traced_waves(_Renderer(plain)) == {}
    chunked = _Renderer(bounce)
    chunked.lane_chunk = 1 << 20
    assert program.traced_waves(chunked) == {1 << 20: 37}


def test_traced_render_carries_the_counters(bench, monkeypatch, tmp_path):
    """A toy traced render run on the CPU hands the program's counters
    (program.counters of its renderer) to the readers: a per-layer metric
    whose reader returns one reports it, one whose counter is missing is
    left out."""
    import json
    import os
    import shutil
    from portbench import program
    from portbench.run import run_cell
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(ROOT, "portbench", sub),
                        tmp_path / "portbench" / sub)
    for name, key in (("probe_count", "probe"), ("absent_count", "gone")):
        (tmp_path / "portbench" / "metrics" / (name + ".py")).write_text(
            "def read(run):\n"
            "    return run.get(\"counters\", {}).get(%r)\n" % key)
        bench["per_layer"].append({
            "name": name, "unit": "rays", "better": "lower",
            "source": "program_counter", "layer": "regen wave loop",
            "moves": "frame_ms", "workloads": ["testobj_large_1080p"]})
    monkeypatch.setattr(program, "counters", lambda r: {"probe": 12.5})
    ov = toy(bench, "testobj_large_1080p", frames_per_call=1, check_pixels=8)
    ov["config"].update(width=16, height=16)
    res = run_cell(bench, "testobj_large_1080p", 9, 0.01, 1, "cpu", ov,
                   root=str(tmp_path))
    assert res["metrics"]["probe_count"] == {"value": 12.5, "unit": "rays"}
    assert "absent_count" not in res["metrics"]
    assert res["correct"], res["check"]
    json.dumps(res)


def test_traced_render_profiles_anew_while_records_are_lost(
        bench, monkeypatch):
    """A traced call whose trace lost records (_stages.marks_whole false) is
    profiled again, into the same accumulation, at most TRACE_TRIES times;
    the frames of every traced call are compared, so the run stays
    correct."""
    from portbench.drivers import cli_loop
    from portbench.metrics import _stages
    from portbench.run import run_cell
    seen = []

    def whole(events, waves, integrator, frames):
        assert (integrator, frames) == ("regen", 1)
        seen.append(sum(waves.values()))
        return len(seen) == 3
    monkeypatch.setattr(_stages, "marks_whole", whole)
    ov = toy(bench, "testobj_large_1080p", frames_per_call=1, check_pixels=8)
    ov["config"].update(width=16, height=16)
    res = run_cell(bench, "testobj_large_1080p", 9, 0.01, 1, "cpu", ov)
    assert len(seen) == 3 and all(seen)
    assert res["correct"], res["check"]

    seen.clear()
    monkeypatch.setattr(_stages, "marks_whole", lambda *a: seen.append(1))
    res = run_cell(bench, "testobj_large_1080p", 9, 0.01, 1, "cpu", ov)
    assert len(seen) == cli_loop.TRACE_TRIES
    assert res["correct"], res["check"]
