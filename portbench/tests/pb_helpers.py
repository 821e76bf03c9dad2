"""Helpers and fixtures of the benchmark's tests: the checkout on
sys.path, the parsed BENCHMARK.json, toy-size overrides of a cell, the
renderers a run builds, and the
skip of the tests marked `cuda` where there is no card (decided in the
fixture, at run time)."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def toy(bench, cell, **traffic):
    """Overrides that run `cell` at toy size on the CPU: a 64x64 image of a
    few hundred triangles, short calls, few compared pixels."""
    from portbench.run import cell_setup
    _, config, _ = cell_setup(bench, cell)
    scene = dict(config["scene"])
    scene["mesh_args"] = {"n_lat": 8, "n_lon": 16, "ground_div": 4}
    t = {"frames_per_call": 2, "check_pixels": 32, "check_steps": 6,
         "warmup_steps": 2, "trace_steps": 2}
    t.update(traffic)
    return {"config": {"width": 64, "height": 64, "scene": scene},
            "traffic": t}


def keep_renderers(monkeypatch):
    """The list into which every Renderer that program.build_renderer
    builds from here on goes."""
    from portbench import program
    built, build = [], program.build_renderer

    def keep(*a, **kw):
        out = build(*a, **kw)
        built.append(out[0])
        return out
    monkeypatch.setattr(program, "build_renderer", keep)
    return built


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
