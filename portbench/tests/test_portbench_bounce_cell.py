"""A bounce configuration through the render driver: `testobj_large_1080p`
with `settings: {"integrator": "bounce"}` at toy size on the CPU (64x64,
an 8x16 sphere, a 4x4 ground, 2-frame calls, 32 pixels). Sound, traced:
the run is correct, nothing builds a regen integrator, waves_per_frame is
the bounce steps launched over the frames, and a counter the bounce
integrator publishes reaches the readers. With frame_end's late
environment term left out, untraced: the run fails the limits."""
import pytest
import torch

from pb_helpers import bench, keep_renderers, toy  # noqa: F401  (bench)

CELL = "testobj_large_1080p"
# torch's first MKL-backed sqrt on a fresh CPU pool thread can be
# inaccurate; one call here warms it up before any comparison
torch.sqrt(torch.rand(1 << 12))


def _no_late_env(cfg, scene, st):
    """frame_end with the frame's deferred environment miss left out."""
    st["accum"].add_(st["rad"])
    st["frame"].add_(1)


@pytest.mark.parametrize("case", ["sound", "no_late_env"])
def test_bounce_cell(bench, monkeypatch, case):
    from portbench import run
    from tpu_pathtracer_torch.tracer import wavefront
    built, handed = keep_renderers(monkeypatch), []
    read = run.read_metric

    def seen(name, traced, root=run.ROOT):
        handed.append(traced)
        return read(name, traced, root)
    monkeypatch.setattr(run, "read_metric", seen)
    sound = case == "sound"
    if sound:
        monkeypatch.setattr(wavefront.BounceIntegrator, "last_counters",
                            {"bounce_probe": torch.tensor(41)},
                            raising=False)
    else:
        monkeypatch.setattr(wavefront, "frame_end", _no_late_env)
    ov = toy(bench, CELL)
    ov["config"]["settings"] = {"integrator": "bounce"}
    res = run.run_cell(bench, CELL, 2 ** 31 + 11, 0.1, int(sound), "cpu",
                       ov)
    assert res["failed"] == 0
    assert res["correct"] == sound, res["check"]
    if not sound:
        return
    (r,) = built
    assert [k[0] for k in r._integrators] == ["bounce", "bounce"]
    (fn,) = [f for k, f in r._integrators.items() if k[2]]
    assert fn.last_launched > 0
    frames = ov["traffic"]["frames_per_call"]
    assert res["metrics"]["waves_per_frame"]["value"] == pytest.approx(
        fn.last_launched / frames)
    assert handed and all(t["integrator"] == "bounce" for t in handed)
    assert all(t["waves"] == {64 * 64: fn.last_launched} for t in handed)
    assert all(t["counters"] == {"bounce_probe": 41} for t in handed)
