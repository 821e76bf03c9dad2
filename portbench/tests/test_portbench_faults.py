"""A run's comparison catches a broken timed path: each run below skips
the harness's look for a card and drives the rest of a run on the CPU at
toy size, with the program's render broken underneath, and `correct` has
to come out false; the same run unbroken comes out true. The control (the
reference in bfloat16 in the program's place) has to fail the limits too.
"""
import pytest
import torch

from pb_helpers import bench, cuda_device, toy  # noqa: F401  (fixtures)

CELLS = ["testobj_large_1080p", "organic_sss_1080p",
         "testobj_large_drag_1080p"]


def unchanged(plain):
    """A call that returns its state unchanged."""
    def render(self, accum, camera, frame, n, with_stats=False):
        plain(self, accum.clone(), camera, frame, n, with_stats)
        return (accum, 0, 0.0) if with_stats else accum
    return render


def half_batch(plain):
    """Half of the call's samples left out: of a call of n > 1 frames,
    half the frames, the rest counted twice (their mean kept); of a
    1-frame call (the viewer's preview), the second half of its lanes."""
    def render(self, accum, camera, frame, n, with_stats=False):
        out = plain(self, torch.zeros_like(accum), camera, frame,
                    max(n // 2, 1), with_stats)
        acc = out[0] if with_stats else out
        if n > 1:
            acc = acc * (n / (n // 2))
        else:
            acc = acc.clone()
            acc[acc.shape[0] // 2:] = 0.0
        acc = accum + acc
        return (acc,) + tuple(out[1:]) if with_stats else acc
    return render


def altered(plain):
    """Every fourth pixel's radiance altered by 5% where it is produced."""
    def render(self, accum, camera, frame, n, with_stats=False):
        out = plain(self, torch.zeros_like(accum), camera, frame, n,
                    with_stats)
        acc = out[0] if with_stats else out
        acc = acc.clone()
        acc[::4] *= 1.05
        acc = accum + acc
        return (acc,) + tuple(out[1:]) if with_stats else acc
    return render


def _run(bench, cell, trace=0):
    from portbench.run import run_cell
    return run_cell(bench, cell, 2 ** 31 + 5, 0.5, trace, "cpu",
                    toy(bench, cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    res = _run(bench, cell)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
def test_broken_render_is_not_correct(bench, cell, fault, monkeypatch):
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    monkeypatch.setattr(Renderer, "render_frames",
                        fault(Renderer.render_frames))
    res = _run(bench, cell)
    assert not res["correct"], (fault.__name__, res["check"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(bench, cell):
    from portbench import check, control
    from portbench.run import cell_setup
    wl, config, traffic = cell_setup(bench, cell, toy(bench, cell))
    numbers = control.control_numbers(wl, config, traffic, 11, 4,
                                      torch.device("cpu"))
    ok, shown = check.judge(numbers, check.limits(cell))
    assert not ok, shown


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(bench, cuda_device):
    from portbench.run import run_cell
    res = run_cell(bench, "testobj_large_drag_1080p", 3, 2.0, 0,
                   cuda_device)
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
