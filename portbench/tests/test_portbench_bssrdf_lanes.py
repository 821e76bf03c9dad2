"""The reader `bssrdf_lanes_per_frame`: the program's counter
`bssrdf_lanes` of the traced call over its frames, None where the counter
is missing (a program without it, as older checkouts are) or the run is no
render; and a traced toy run of `organic_sss_1080p` on the CPU, whose
program publishes the counter."""
import pytest

from pb_helpers import bench, toy  # noqa: F401  (bench: a fixture)

CELL = "organic_sss_1080p"
NAME = "bssrdf_lanes_per_frame"


def _read(run):
    from portbench.run import read_metric
    return read_metric(NAME, run)


def test_reader_divides_the_counter_by_the_frames():
    run = {"loop": "render", "frames": 4,
           "counters": {"bssrdf_lanes": 1000, "bssrdf_exits": 600}}
    assert _read(run) == pytest.approx(250.0)


@pytest.mark.parametrize("what,run", [
    ("no counter", {"loop": "render", "frames": 4, "counters": {}}),
    ("another counter", {"loop": "render", "frames": 4,
                         "counters": {"medium_lanes": 5}}),
    ("no counters key", {"loop": "render", "frames": 4}),
    ("no frames", {"loop": "render", "frames": 0,
                   "counters": {"bssrdf_lanes": 5}}),
    ("a drag", {"loop": "drag", "frames": 4,
                "counters": {"bssrdf_lanes": 5}}),
    ("empty", {})])
def test_reader_gives_none_without_its_counter(what, run):
    assert _read(run) is None, what


def test_entry_names_the_sss_cell_only(bench):
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert entry == {"name": NAME, "unit": "lanes", "better": "lower",
                     "source": "program_counter",
                     "layer": "regen wave loop", "moves": "frame_ms",
                     "workloads": [CELL]}
    assert bench["per_layer"][-1] is entry


def test_traced_sss_cell_reports_the_counter(bench):
    """A traced toy run of the cell on the CPU hands the program's BSSRDF
    counters to the reader: bssrdf_lanes_per_frame reports."""
    from portbench.run import run_cell
    ov = toy(bench, CELL, frames_per_call=1, check_pixels=8)
    ov["config"].update(width=16, height=16)
    res = run_cell(bench, CELL, 2 ** 31 + 17, 0.01, 1, "cpu", ov)
    m = res["metrics"]
    assert m[NAME]["unit"] == "lanes" and m[NAME]["value"] > 0
    assert res["correct"], res["check"]
