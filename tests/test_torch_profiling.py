"""utils/profiling.py on chrome traces the test writes (kernels under
their launching ops, overlapping kernels, memcpy, negative marginals, a
pool-width against a table-width gather), tools/profile_frame.py run
to its end on the CPU, and its --stages report of a synthetic trace."""
import json
import types

import pytest
import torch

from tpu_pathtracer_torch.ops.marks import MARK_PREFIX
from tpu_pathtracer_torch.tools import profile_frame
from tpu_pathtracer_torch.utils import profiling

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))

POOL = 1 << 20
TRAV = "void traverse_kernel<false, false, false>(float const*, int)"
GATHER = "void at::native::index_elementwise_kernel<128, 4>(int)"
MUL = "void at::native::vectorized_elementwise_kernel<4, mul>(int)"
SORT = "void cub::DeviceRadixSortOnesweepKernel<int>(int)"
ADD = "void at::native::indexFuncLargeIndex<float>(int)"


def _op(ext, name, ts, dur, dims=None):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1,
            "args": {"External id": ext, "Input Dims": dims or []}}


def _dev(ext, name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 7, "args": {"External id": ext}}


def _trace(tmp_path, name, scale=1.0):
    """A window of 1000 us; device work scaled by `scale`."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": profiling.WINDOW,
           "ts": 0.0, "dur": 1000.0, "pid": 1, "tid": 1,
           "args": {"External id": 1}},
          _op(2, "aten::index", 10.0, 5.0, [[POOL, 16], []]),
          _op(3, "aten::index", 20.0, 5.0, [[5803, 28], []]),
          _op(4, "aten::mul", 30.0, 5.0, [[POOL, 3], [POOL, 3]]),
          _op(5, "aten::sort", 40.0, 5.0, [[POOL]]),
          _op(6, "aten::index_add_", 50.0, 5.0, [[POOL, 3], [], [POOL]]),
          _op(7, "aten::copy_", 60.0, 5.0, [[POOL, 3], [POOL, 3]]),
          {"ph": "i", "name": "marker", "ts": 5.0, "pid": 1, "tid": 1},
          _dev(99, TRAV, 100.0, 100.0 * scale),
          _dev(2, GATHER, 150.0, 40.0 * scale),      # overlaps the trace
          _dev(3, GATHER, 300.0, 10.0 * scale),
          _dev(4, MUL, 400.0, 20.0 * scale),
          _dev(5, SORT, 500.0, 30.0 * scale),
          _dev(6, ADD, 600.0, 25.0 * scale),
          _dev(7, "Memcpy DtoD (Device -> Device)", 700.0, 5.0 * scale,
               "gpu_memcpy"),
          _dev(7, "Memset (Device)", 710.0, 1.0 * scale, "gpu_memset"),
          # past the window's end: clipped out of the busy time
          _dev(4, MUL, 1100.0, 50.0)]
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_collect_device_ops_keys_kernels_by_launching_op(tmp_path):
    dur, cnt, meta = profiling.collect_device_ops(
        _trace(tmp_path, "t.json"), pool_rows=POOL)
    pool_key = "aten::index | %s [pool-width]" % GATHER
    table_key = "aten::index | %s [table]" % GATHER
    assert dur[pool_key] == 40.0 and dur[table_key] == 10.0
    assert meta[pool_key] == ("kernel", "aten::index", GATHER, POOL)
    assert meta[table_key][3] == 5803
    assert dur["- | %s" % TRAV] == 100.0          # no op: launched by ctypes
    assert dur["aten::mul | %s" % MUL] == 70.0
    assert cnt["aten::mul | %s" % MUL] == 2
    assert sum(cnt.values()) == 9
    # without pool_rows the gathers share one key
    dur2, _, _ = profiling.collect_device_ops(_trace(tmp_path, "u.json"))
    assert dur2["aten::index | %s" % GATHER] == 50.0


def test_categorize_rolls_ops_into_the_jax_buckets(tmp_path):
    dur, _, meta = profiling.collect_device_ops(_trace(tmp_path, "t.json"),
                                                pool_rows=POOL)
    ops = {k: v / 1e3 for k, v in dur.items()}
    b = profiling.categorize(ops, meta, pool_rows=POOL)
    assert set(b) == set(profiling.CATEGORIES)
    want = {"trace": 0.1, "permute_gather": 0.04, "gathers": 0.01,
            "other": 0.07, "argsort": 0.03, "image_scatter": 0.025,
            "layout_copies": 0.006}
    for k, v in want.items():
        assert b[k] == pytest.approx(v), k
    # without pool_rows every gather is a scene-table gather
    b2 = profiling.categorize(ops, meta)
    assert b2["permute_gather"] == 0.0
    assert b2["gathers"] == pytest.approx(0.05)


def test_marginal_ops_keeps_negative_marginals(tmp_path):
    lo = profiling.collect_device_ops(_trace(tmp_path, "lo.json"), POOL)
    hi = profiling.collect_device_ops(_trace(tmp_path, "hi.json", 3.0),
                                      POOL)
    # a key of the LO run only (another kernel name in the HI program)
    lo[0]["aten::mul | other_kernel"] = 8.0
    lo[2]["aten::mul | other_kernel"] = ("kernel", "aten::mul",
                                         "other_kernel", 0)
    ops, meta = profiling.marginal_ops(lo, hi, 4)
    assert ops["- | %s" % TRAV] == pytest.approx((300 - 100) / 4 / 1e3)
    assert ops["aten::mul | other_kernel"] == pytest.approx(-8 / 4 / 1e3)
    b = profiling.categorize(ops, meta, pool_rows=POOL)
    assert b["other"] == pytest.approx(((60 + 50) - 70 - 8) / 4 / 1e3)
    assert sum(b.values()) == pytest.approx(sum(ops.values()))


def test_device_busy_is_the_union_inside_the_window(tmp_path):
    path = _trace(tmp_path, "t.json")
    b = profiling.device_busy(path, profiling.WINDOW)
    # trace 100-200 and gather 150-190 overlap: 100; then 10 + 20 + 30 +
    # 25 + 5 + 1; the kernel past the window does not count
    assert b["busy_ms"] == pytest.approx(0.191)
    assert b["window_ms"] == pytest.approx(1.0)
    assert b["idle_share"] == pytest.approx(1 - 0.191)
    assert b["events"] == 8
    # without a window: the whole trace, 0 to 1150 us
    whole = profiling.device_busy(path)
    assert whole["busy_ms"] == pytest.approx(0.241)
    assert whole["window_ms"] == pytest.approx(1.15)
    with pytest.raises(ValueError, match="no record_function"):
        profiling.device_busy(path, "other_window")


def test_collect_device_ops_inside_a_window(tmp_path):
    """The ops of one window: the kernel past the window's end is not
    counted there."""
    dur, cnt, _ = profiling.collect_device_ops(
        _trace(tmp_path, "t.json"), POOL, window=profiling.WINDOW)
    assert dur["aten::mul | %s" % MUL] == 20.0
    assert sum(cnt.values()) == 8


def test_collect_host_ops_counts_self_time(tmp_path):
    ev = [_op(1, "aten::index", 0.0, 100.0, [[64, 16], []]),
          _op(2, "aten::empty", 10.0, 20.0),
          _op(3, "aten::copy_", 40.0, 30.0),
          _op(4, "aten::add", 200.0, 7.0)]
    path = tmp_path / "h.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    dur, cnt, meta = profiling.collect_host_ops(str(path), pool_rows=64)
    assert dur["aten::index | aten::index [pool-width]"] == 50.0
    assert dur["aten::empty | aten::empty"] == 20.0
    assert dur["aten::copy_ | aten::copy_"] == 30.0
    assert dur["aten::add | aten::add"] == 7.0
    assert sum(cnt.values()) == 4


def test_settings_overrides():
    assert profile_frame.settings_overrides(
        "pool_lanes=1<<19, scatter_mode='wave',merge_envtex=False") == {
        "pool_lanes": 1 << 19, "scatter_mode": "wave",
        "merge_envtex": False}
    assert profile_frame.settings_overrides("") == {}


def test_profile_frame_runs_on_the_cpu(capsys):
    """--device cpu at 16x16, frames 1 2: the host op table, the rollup
    and no device figure."""
    assert profile_frame.main(["--device", "cpu", "--wh", "16", "--frames",
                               "1", "2", "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert "host ops (cpu): marginal anatomy over 1 frames" in out
    assert "categories (ms/frame): trace" in out
    assert "device busy" not in out


@pytest.mark.parametrize("kernel", [TRAV, MUL])
def test_device_profile_without_a_traversal_kernel_raises(monkeypatch,
                                                          kernel):
    """profile() on a card (the profiler and the device stubbed) passes a
    profile that holds a traverse_kernel event and refuses one that holds
    none, whose trace bucket would read 0 in silence."""
    from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
    meta = {"k": ("kernel", "", kernel, 0)}
    spans = [{"frames": 1}, {"frames": 2}, {"frames": "marginal"}]
    monkeypatch.setattr(profiling, "profile_marginal",
                        lambda run, frames, device, pool_rows:
                        ({"k": 1.0}, meta, spans))
    monkeypatch.setattr(profile_frame, "synchronize", lambda device: None)
    r = types.SimpleNamespace(device=torch.device("cuda"), width=8,
                              height=8, settings=RenderSettings(),
                              render_frames=lambda *a: None,
                              zeros_accum=lambda: None)
    if kernel == TRAV:
        prof = profile_frame.profile(r, None, (1, 2))
        assert prof["rollup"]["trace"] == 1.0
    else:
        with pytest.raises(RuntimeError, match="no traverse_kernel"):
            profile_frame.profile(r, None, (1, 2))


def test_profile_frame_refuses_unknown_stage_and_missing_card():
    """--dup (the stage-duplication pricing) is gone: argparse refuses
    it; without a card the default device refuses."""
    with pytest.raises(SystemExit) as exc:
        profile_frame.main(["--device", "cpu", "--dup", "shade"])
    assert exc.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            profile_frame.main(["--wh", "16"])


def test_profile_frame_stages_refuses_the_cpu():
    """The CPU's stage marks carry no device time: --stages on the CPU
    exits naming the card before it builds anything."""
    with pytest.raises(SystemExit, match="only on a CUDA card"):
        profile_frame.main(["--device", "cpu", "--wh", "8", "--stages"])


def _mark_ev(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": float(ts),
            "dur": float(dur), "pid": 0, "tid": 7, "args": {}}


def test_stage_report_reads_the_marks_of_a_synthetic_trace():
    """--stages' lines from stage_device_ms of a trace of two waves over 2
    frames: each marked stage's device ms a frame in wave order, then the
    time outside any stage, the marks' own and the busy frame."""
    m = MARK_PREFIX
    events = [_mark_ev("warm_up", 0, 4)]
    for t0 in (100, 300):
        events += [_mark_ev(m + "respawn", t0, 1),
                   _mark_ev("elementwise", t0 + 2, 20),
                   _mark_ev(m + "ext_trace", t0 + 30, 1),
                   _mark_ev(TRAV, t0 + 32, 60),
                   _mark_ev(m + "permute", t0 + 100, 1),
                   _mark_ev(GATHER, t0 + 102, 10),
                   _mark_ev(m + "end", t0 + 120, 1)]
    got = profiling.stage_device_ms(events)
    lines = profile_frame.stage_report(got, 2)
    assert lines == [
        "stages (device ms a frame, one with_stats call of 2 frames, "
        "2 waves):",
        "    0.020 ms  respawn",
        "    0.060 ms  ext_trace",
        "    0.010 ms  permute",
        "    0.002 ms  outside any stage",
        "    0.004 ms  the 8 marks' own kernels",
        "    0.096 ms  busy frame (the stages, the rest and the marks)"]
