"""The plain reference against the port's plain CPU path on a tiny image:
the same samples give the same sums. A scene without media gives the sums
the reference gave before it had media, bit for bit
(data/reference_sums_toy.npz, recorded from that reference)."""
import copy
import os

import numpy as np
import pytest
import torch

from pb_helpers import ROOT, bench  # noqa: F401  (bench: a fixture)

W, H, FRAME0, FRAMES = 48, 40, 1234, 3
# the media configuration: organic_sss's scene with the blob in glass
# filled with the jade medium (the port's `media` demo)
JADE_GLASS = [{"refltype": "MAT_DIFF", "useTexture": True},
              {"refltype": "MAT_GLASS", "medium": "jade"}]
# both: the ground in organic_sss's subsurface material under the jade
# blob, so that a path scattering in the medium draws the BSSRDF loop's
# numbers too
SSS = {"refltype": "MAT_SUBSURFACE", "objcol": [0.85, 0.67, 0.55],
       "alphax": 0.5, "etaT": 1.4, "mfp": [0.25, 0.14, 0.10], "ks": 0.2,
       "F0": [0.04, 0.04, 0.04]}
JADE_OVER_SSS = [SSS, JADE_GLASS[1]]
FIXTURE = os.path.join(ROOT, "portbench", "tests", "data",
                       "reference_sums_toy.npz")


def toy_config(bench, cell, materials=None):
    """The configuration of `cell` at toy size (a few hundred triangles,
    W x H), its materials replaced by `materials` where given."""
    from portbench.run import cell_setup
    _, config, _ = cell_setup(bench, cell)
    config["scene"]["mesh_args"] = {"n_lat": 8, "n_lon": 16,
                                    "ground_div": 4}
    if materials is not None:
        config["scene"]["materials"] = copy.deepcopy(materials)
    config.update(width=W, height=H)
    return config


def _orbit(config):
    from portbench.camera import Orbit
    orbit = Orbit(**config["camera"])
    orbit.yaw += 0.1
    return orbit


def port_sums(config):
    """[W*H,3] float64: the port's accumulation of FRAMES frames on the
    CPU, by lane."""
    from portbench import program, scenes
    inputs = scenes.make_inputs(config)
    r, _ = program.build_renderer(config, inputs, "cpu", None)
    acc = r.render_frames(r.zeros_accum(), program.render_camera(
        _orbit(config), W, H), FRAME0, FRAMES)
    return acc.double().numpy()


def reference_sums(config):
    """The reference's sums of the same samples, by lane."""
    from portbench import scenes
    from portbench.drivers.cli_loop import reference_sums as sums
    return sums(scenes.make_inputs(config), config, _orbit(config),
                torch.arange(W * H), FRAME0, FRAME0 + FRAMES, "cpu")


@pytest.mark.parametrize("cell,materials", [
    pytest.param("testobj_large_1080p", None, id="testobj_large_1080p"),
    pytest.param("organic_sss_1080p", None, id="organic_sss_1080p"),
    pytest.param("organic_sss_1080p", JADE_GLASS, id="organic_media"),
    pytest.param("organic_sss_1080p", JADE_OVER_SSS, id="media_and_sss")])
def test_reference_matches_the_port_on_cpu(bench, cell, materials):
    from portbench import check
    config = toy_config(bench, cell, materials)
    n = check.render_numbers(port_sums(config), reference_sums(config))
    assert n["gap_p50"] < 1e-6 and n["far_share"] <= 0.01, n


def _no_medium(mats):
    mats[1].pop("medium")


def _half_sigma_s(mats):
    from portbench.reference.render import MEDIA
    ss, sa, g = MEDIA[mats[1]["medium"]]
    mats[1]["medium"] = [[s / 2 for s in ss], list(sa), g]


@pytest.mark.parametrize("fault", [_no_medium, _half_sigma_s])
def test_the_comparison_sees_the_medium(bench, fault):
    """The port rendering the media scene with the medium left out (plain
    glass), or with its sigma_s halved, is not correct against the media
    reference under the render cells' limits."""
    from portbench import check
    config = toy_config(bench, "organic_sss_1080p", JADE_GLASS)
    want = reference_sums(config)
    broken = copy.deepcopy(config)
    fault(broken["scene"]["materials"])
    ok, shown = check.judge(check.render_numbers(port_sums(broken), want),
                            check.limits("organic_sss_1080p"))
    assert not ok, (fault.__name__, shown)


@pytest.mark.parametrize("cell", ["testobj_large_1080p", "organic_sss_1080p"])
def test_scenes_without_media_keep_their_sums(bench, cell):
    config = toy_config(bench, cell)
    with np.load(FIXTURE) as want:
        want = want[next(c["config"] for c in bench["workloads"]
                         if c["name"] == cell)]
    got = reference_sums(config)
    assert got.dtype == want.dtype and np.array_equal(got, want), \
        np.abs(got - want).max()


@pytest.mark.parametrize("g", [-0.5, 0.0, 0.2, 0.9])
def test_henyey_greenstein_draws_its_phase_function(g):
    """The drawn cosines to the ray follow p(cos) = (1 - g^2) / (2 (1 + g^2
    - 2 g cos)^(3/2)) on [-1, 1] (the phase function over the azimuth):
    their mean is g, and a histogram matches the density's bins."""
    from portbench.reference.render import henyey_greenstein, normalize
    gen = torch.Generator().manual_seed(5)
    n = 200000
    u1, u2 = torch.rand(n, generator=gen), torch.rand(n, generator=gen)
    d = normalize(torch.randn(n, 3, generator=gen))
    w = henyey_greenstein(u1, u2, torch.full((n,), g), d)
    assert torch.allclose(torch.linalg.norm(w, dim=1), torch.ones(n),
                          atol=1e-5)
    cos = (w * d).sum(1).double().numpy()
    assert abs(cos.mean() - g) < 0.01
    edges = np.linspace(-1, 1, 21)
    if g == 0.0:
        cdf = (edges + 1) / 2
    else:
        cdf = (1 - g * g) / (2 * g) * (
            1 / np.sqrt(1 + g * g - 2 * g * edges) - 1 / (1 + g))
    hist = np.histogram(cos, edges)[0] / n
    assert np.abs(hist - np.diff(cdf)).max() < 0.005


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
