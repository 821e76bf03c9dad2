"""The per-layer readers' arithmetic on a small chrome trace of the shape
torch.profiler writes (a replayed graph's kernels carry no launching op)."""
import pytest

from pb_helpers import ROOT  # noqa: F401  (puts the checkout on sys.path)

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
