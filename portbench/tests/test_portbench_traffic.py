"""The traffic generators repeat exactly from a seed, and give every seed
the same work."""

import numpy as np

from pb_helpers import bench  # noqa: F401  (a fixture)


def _setup(bench, cell):
    from portbench.run import cell_setup
    _, config, traffic = cell_setup(bench, cell)
    return config, traffic


def test_cli_loop_plan_repeats(bench):
    from portbench.drivers import cli_loop
    config, traffic = _setup(bench, "testobj_large_1080p")
    big = 2 ** 31 + 12345
    a, b = (cli_loop.plan(traffic, config, big) for _ in range(2))
    c = cli_loop.plan(traffic, config, big + 1)
    assert a["frame0"] == b["frame0"] != c["frame0"]
    assert np.array_equal(a["pixels"], b["pixels"])
    assert not np.array_equal(a["pixels"], c["pixels"])
    assert len(set(a["pixels"].tolist())) == traffic["check_pixels"]
    assert 0 < a["frame0"] < 2 ** 31


def test_drag_plan_repeats(bench):
    from portbench.drivers import viewer_drag
    config, traffic = _setup(bench, "testobj_large_drag_1080p")
    a, b = (viewer_drag.plan(traffic, config, 99) for _ in range(2))
    c = viewer_drag.plan(traffic, config, 100)
    assert np.array_equal(a["moves"], b["moves"])
    assert np.array_equal(a["sx"], b["sx"]) and np.array_equal(a["sy"],
                                                                b["sy"])
    assert vars(a["orbit"]) == vars(b["orbit"])
    assert np.array_equal(viewer_drag.pick_steps(a["rng"], 500, traffic),
                          viewer_drag.pick_steps(b["rng"], 500, traffic))
    # every seed visits the same views: the same work
    def views(d):
        cams = viewer_drag.camera_track(d["orbit"], d["moves"], 16, 960, 540)
        return {tuple(np.round(c, 4).tolist()) for c in cams}
    assert views(a) == views(c)
    assert len(views(a)) == len(traffic["moves"])
    assert all(tuple(m) != (0, 0) for m in a["moves"].tolist())


def test_drag_camera_track_matches_the_viewer(bench):
    """The benchmark's orbit camera after a drag is the port's viewer
    camera after the same mouse reports."""
    from portbench import program
    from portbench.drivers import viewer_drag
    from tpu_pathtracer_torch.tools.interactive import MouseOrbit
    config, traffic = _setup(bench, "testobj_large_drag_1080p")
    d = viewer_drag.plan(traffic, config, 7)
    cams = viewer_drag.camera_track(d["orbit"], d["moves"], 40, 960, 540)
    icam = program.interactive_camera(d["orbit"], 960, 540)
    mouse = MouseOrbit()
    x, y = 500, 300
    mouse.apply(("MOUSE", "press", 0, False, x, y), icam)
    for i in range(40):
        dx, dy = d["moves"][i % len(d["moves"])]
        x, y = x + int(dx), y + int(dy)
        mouse.apply(("MOUSE", "drag", 0, False, x, y), icam)
        assert np.array_equal(icam.build_render_camera().as_array(),
                              cams[i])
