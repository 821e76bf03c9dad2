"""The port against the benchmark's plain reference on participating
media: `portbench.run.run_cell` on the real `organic_media_1080p` entry
(organic_sss's blob in glass filled with the jade medium) at toy size on
the CPU, 64x64, an 8x16 blob, 2 frames, 32 compared pixels. The sound port
is correct under the cell's limits (`gap_p50`, `far_share`); the port with
the medium left out of the glass fails the same limits. (The port's jade
with its scattering coefficient halved moves 2 of these 32 pixels by over
1%, a `far_share` of 0.0625, under the 0.1 limit: at this size few pixels
see the blob; at the cell's size the fault is caught.)"""
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

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
CELL = "organic_media_1080p"


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _toy(bench):
    """The cell at toy size: 64x64, an 8x16 blob over a 4x4 ground grid,
    2-frame calls, 32 compared pixels."""
    from portbench.run import cell_setup
    _, config, _ = cell_setup(bench, CELL)
    scene = dict(config["scene"],
                 mesh_args={"n_lat": 8, "n_lon": 16, "ground_div": 4})
    return {"config": {"width": 64, "height": 64, "scene": scene},
            "traffic": {"frames_per_call": 2, "check_pixels": 32}}


def _medium_left_out(monkeypatch):
    plain = program.build_renderer

    def build(config, inputs, device, cache_dir):
        mesh, mats, envmap, texture = inputs
        mats = [{k: v for k, v in m.items() if k != "medium"} for m in mats]
        return plain(config, (mesh, mats, envmap, texture), device,
                     cache_dir)
    monkeypatch.setattr(program, "build_renderer", build)


FAULTS = {"sound": None, "medium_left_out": _medium_left_out}


@pytest.mark.parametrize("case", list(FAULTS))
def test_media_cell_against_the_reference(case, monkeypatch):
    bench = _bench()
    if FAULTS[case] is not None:
        FAULTS[case](monkeypatch)
    res = run_cell(bench, CELL, 2 ** 31 + 11, 0.1, 0, "cpu", _toy(bench))
    assert set(res["check"]) == {"gap_p50", "far_share"}
    assert res["attempted"] >= 2
    if case == "sound":
        assert res["correct"], res["check"]
    else:
        assert not res["correct"], res["check"]
        # a number over its limit, not a failed run
        assert res["failed"] == 0
        assert any(v > lim for v, lim in res["check"].values()), \
            res["check"]
