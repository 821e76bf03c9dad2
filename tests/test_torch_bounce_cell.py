"""The port's bounce integrator against the benchmark's plain reference:
`portbench.run.run_cell` on the real `testobj_large_bounce_1080p` entry
(testobj_large under `integrator: bounce`) at toy size on the CPU, 64x64,
an 8x16 sphere over a 4x4 ground, 2-frame calls, 32 compared pixels.
Sound and traced, the run is correct under the cell's limits (`gap_p50`,
`far_share`), only bounce integrators are built, `waves_per_frame` is the
bounce steps the traced call launched over its frames, and
`bounce_live_lane_pct` is the integrator's published live-lane counter
over the lanes times those steps. With frame_end's deferred environment
term left out, untraced, the run fails the same limits."""
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import program  # noqa: E402
from portbench.run import run_cell  # noqa: E402
from tpu_pathtracer_torch.tracer import wavefront  # noqa: E402

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
CELL = "testobj_large_bounce_1080p"
W = 64


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _toy(bench):
    """The cell at toy size: 64x64, an 8x16 sphere over a 4x4 ground grid,
    2-frame calls, 32 compared pixels."""
    from portbench.run import cell_setup
    _, config, _ = cell_setup(bench, CELL)
    scene = dict(config["scene"],
                 mesh_args={"n_lat": 8, "n_lon": 16, "ground_div": 4})
    return {"config": {"width": W, "height": W, "scene": scene},
            "traffic": {"frames_per_call": 2, "check_pixels": 32}}


def _kept(monkeypatch):
    """The list into which every Renderer the run builds goes."""
    built, plain = [], program.build_renderer

    def build(*a, **kw):
        out = plain(*a, **kw)
        built.append(out[0])
        return out
    monkeypatch.setattr(program, "build_renderer", build)
    return built


def _no_late_env(cfg, scene, st):
    """frame_end with the frame's deferred environment miss left out."""
    st["accum"].add_(st["rad"])
    st["frame"].add_(1)


@pytest.mark.parametrize("case", ["sound", "no_late_env"])
def test_bounce_cell_against_the_reference(case, monkeypatch):
    bench = _bench()
    sound = case == "sound"
    built = _kept(monkeypatch)
    if not sound:
        monkeypatch.setattr(wavefront, "frame_end", _no_late_env)
    ov = _toy(bench)
    res = run_cell(bench, CELL, 2 ** 31 + 11, 0.1, int(sound), "cpu", ov)
    assert set(res["check"]) == {"gap_p50", "far_share"}
    assert res["attempted"] >= 2 and res["failed"] == 0
    if not sound:
        # a number over its limit, not a failed run
        assert not res["correct"], res["check"]
        assert any(v > lim for v, lim in res["check"].values()), \
            res["check"]
        return
    assert res["correct"], res["check"]
    (r,) = built
    assert {k[0] for k in r._integrators} == {"bounce"}
    (fn,) = [f for k, f in r._integrators.items() if k[2]]
    m = res["metrics"]
    frames = ov["traffic"]["frames_per_call"]
    assert fn.last_launched > 0
    assert m["waves_per_frame"]["value"] == pytest.approx(
        fn.last_launched / frames)
    live = fn.last_counters["bounce_live_lanes"]
    pct = m["bounce_live_lane_pct"]["value"]
    assert 0 < pct <= 100
    assert pct == pytest.approx(100.0 * live / (W * W * fn.last_launched))
