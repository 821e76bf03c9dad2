"""The plain reference against the port's plain CPU path on a tiny image:
the same samples give the same sums."""
import numpy as np
import pytest
import torch

from pb_helpers import bench  # noqa: F401  (a fixture)


@pytest.mark.parametrize("cell", ["testobj_large_1080p", "organic_sss_1080p"])
def test_reference_matches_the_port_on_cpu(bench, cell):
    from portbench import check, program, scenes
    from portbench.camera import Orbit
    from portbench.drivers.cli_loop import reference_sums
    from portbench.run import cell_setup
    _, config, _ = cell_setup(bench, cell)
    config["scene"]["mesh_args"] = {"n_lat": 8, "n_lon": 16,
                                    "ground_div": 4}
    config.update(width=48, height=40)
    inputs = scenes.make_inputs(config)
    r, _ = program.build_renderer(config, inputs, "cpu", None)
    orbit = Orbit(**config["camera"])
    orbit.yaw += 0.1
    acc = r.render_frames(r.zeros_accum(), program.render_camera(
        orbit, 48, 40), 1234, 3)
    lanes = torch.arange(48 * 40)
    want = reference_sums(inputs, config, orbit, lanes, 1234, 1237, "cpu")
    n = check.render_numbers(acc.double().numpy(), want)
    assert n["gap_p50"] < 1e-6 and n["far_share"] <= 0.01, n


def test_lane_of_pixel_is_the_ports_swizzle():
    from portbench.reference.render import lane_of_pixel
    from tpu_pathtracer_torch.tracer.renderer import lane_tables
    for W, H in ((1920, 1080), (960, 540), (70, 45)):
        px, py = lane_tables(W, H)
        lanes = lane_of_pixel(torch.from_numpy(px).long(),
                              torch.from_numpy(py).long(), W, H)
        assert torch.equal(lanes, torch.arange(W * H))


def test_tree_finds_the_closest_hit():
    """The reference's tree against a brute-force search in float64."""
    from portbench import scenes
    from portbench.reference.accel import TriangleTree
    mesh = scenes.large_scene(n_lat=8, n_lon=16, ground_div=4)
    tv = mesh["vertices"][mesh["indices"]]
    tree = TriangleTree(tv, "cpu")
    g = np.random.default_rng(0)
    o = g.uniform(-3, 3, (512, 3)) + np.array([0, 1.5, 0])
    d = g.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri, t = tree.trace(torch.tensor(o, dtype=torch.float32),
                        torch.tensor(d, dtype=torch.float32), 1e-4, 1e20)
    v0, v1, v2 = (tv[None, :, k].astype(np.float64) for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    p = np.cross(d[:, None], e2)
    det = (e1 * p).sum(-1)
    s = o[:, None] - v0
    u = (s * p).sum(-1) / det
    q = np.cross(s, e1)
    w = (d[:, None] * q).sum(-1) / det
    tt = (e2 * q).sum(-1) / det
    ok = (u >= 0) & (w >= 0) & (u + w <= 1) & (tt > 1e-4)
    best = np.where(ok, tt, np.inf).min(1)
    hit = np.isfinite(best)
    assert np.array_equal(hit, tri.numpy() >= 0)
    assert np.allclose(t.numpy()[hit], best[hit], rtol=1e-4)
