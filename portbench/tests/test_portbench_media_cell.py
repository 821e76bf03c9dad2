"""The participating-media cell `organic_media_1080p` and its readers:
`stage_ms.medium`, `medium_scatters_per_frame` and `medium_roofline_pct`
on small chrome traces of the shape torch.profiler writes and on the
program's counters, each None where its mark, counter or waves are
missing; the medium step's byte count against a count by hand; and the
cell itself from its BENCHMARK.json entry and files, untraced and traced,
at toy size on the CPU."""
import pytest

from pb_helpers import ROOT, bench, toy  # noqa: F401  (bench: a fixture)
from test_portbench_stage_metrics import W, render_trace_with

CELL = "organic_media_1080p"
READERS = ["stage_ms.medium", "medium_scatters_per_frame",
           "medium_roofline_pct"]


def _read(name, run):
    from portbench.run import read_metric
    return read_metric(name, run)


def _run(**kw):
    """A traced render run of three waves (two at 1024 lanes, one at 256),
    the `medium` stage marked after `ext_trace` with a kernel of 20, 20 and
    5 us, and the program's medium counters."""
    run = {"loop": "render", "events": render_trace_with(["medium"]),
           "window": W, "frames": 2, "waves": {1024: 2, 256: 1},
           "counters": {"medium_lanes": 1500, "medium_scatters": 900}}
    run.update(kw)
    return run


def test_medium_bytes_by_hand():
    from portbench.metrics._medium_bytes import (
        MEDIUM_LANE_BYTES, POOL_LANE_BYTES, medium_bound_s, medium_bytes)
    # origin, direction, throughput read and written; hit distance, medium
    # id, lbn read; the int64 RNG state read and written; lbn and the
    # scatter flag written
    assert MEDIUM_LANE_BYTES == 2 * 3 * 3 * 4 + 3 * 4 + 2 * 8 + 4 + 1 == 105
    assert POOL_LANE_BYTES == 1 + 4
    want = 1500 * 105 + (1024 * 2 + 256 * 1) * 5
    assert medium_bytes(1500, {1024: 2, 256: 1}) == want == 169_020
    assert medium_bytes(0, {}) == 0
    assert medium_bound_s(1500, {1024: 2, 256: 1}) == pytest.approx(
        want / 3.35e12)


def test_medium_readers_on_a_synthetic_trace():
    run = _run()
    medium_ms = (20 + 20 + 5) / 1e3
    assert _read("stage_ms.medium", run) == pytest.approx(medium_ms / 2)
    assert _read("medium_scatters_per_frame", run) == pytest.approx(450.0)
    assert _read("medium_roofline_pct", run) == pytest.approx(
        100.0 * 169_020 / 3.35e12 / (medium_ms / 1e3))
    # the closest-hit trace keeps only its own kernels
    assert _read("stage_ms.ext_trace", run) == pytest.approx(medium_ms / 2)


@pytest.mark.parametrize("name", READERS)
def test_medium_readers_give_none_where_their_input_is_missing(name):
    bare = [e for e in render_trace_with(["medium"])
            if e["name"] != "pt_stage_medium"]
    runs = {
        "no mark": _run(events=bare),
        "no counters": _run(counters={}),
        "no waves": _run(waves={}),
        "no frames": _run(frames=0),
        "a drag": _run(loop="drag"),
        "empty": {}}
    needs = {"stage_ms.medium": ("no mark", "no frames", "a drag", "empty"),
             "medium_scatters_per_frame": ("no counters", "no frames",
                                           "a drag", "empty"),
             "medium_roofline_pct": ("no mark", "no counters", "no waves",
                                     "no frames", "a drag", "empty")}
    for what, run in runs.items():
        got = _read(name, run)
        if what in needs[name]:
            assert got is None, what
        else:
            assert got is not None and got > 0, what


def test_media_cell_from_its_entry_and_files(bench):
    """The real entry and files of the cell: its configuration, traffic,
    limits and readers are found by name, and its comparison holds at toy
    size on the CPU (64x64, an 8x16 blob, 2 frames, 32 pixels)."""
    import json
    import os
    from portbench.run import cell_setup, run_cell
    wl, config, traffic = cell_setup(bench, CELL)
    assert wl == {"name": CELL, "config": "organic_media",
                  "traffic": "cli_32", "chips": 1, "why": wl["why"]}
    assert config["scene"]["materials"][1] == {"refltype": "MAT_GLASS",
                                               "medium": "jade"}
    with open(os.path.join(ROOT, "portbench", "limits", CELL + ".json")) \
            as f:
        assert json.load(f) == {"gap_p50": 1e-3, "far_share": 0.1}
    res = run_cell(bench, CELL, 2 ** 31 + 11, 0.1, 0, "cpu",
                   toy(bench, CELL))
    assert res["correct"], res["check"]
    assert set(res["check"]) == {"gap_p50", "far_share"}
    assert res["attempted"] >= 2
    assert set(res["metrics"]) == {"setup_s", "frame_ms"}


def test_traced_media_cell_reports_the_counter(bench):
    """A traced toy run of the cell on the CPU hands the program's medium
    counters to the readers: medium_scatters_per_frame reports; on the
    CPU a stage mark is no device event, so the two trace readers report
    nothing there."""
    from portbench.run import run_cell
    ov = toy(bench, CELL, frames_per_call=1, check_pixels=8)
    ov["config"].update(width=16, height=16)
    res = run_cell(bench, CELL, 2 ** 31 + 13, 0.01, 1, "cpu", ov)
    m = res["metrics"]
    assert m["medium_scatters_per_frame"]["unit"] == "scatters"
    assert m["medium_scatters_per_frame"]["value"] > 0
    assert "stage_ms.medium" not in m and "medium_roofline_pct" not in m
    assert res["correct"], res["check"]
