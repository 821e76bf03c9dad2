"""BSSRDF in the port against the JAX package and the goldens.

The table is tabulated with numpy in both packages: exact. The tensor functions
get the same numpy-seeded inputs and agree to rtol 1e-5 (exp, log, sqrt,
sin and cos differ by ulps between XLA and torch); where a value is a
difference of larger terms (a probe origin, a spline weight) the stated
atol covers the cancellation. `bssrdf_scatter` is chaotic where a one-ulp
difference flips which probe hit the reservoir keeps, so it is held by
agreement of `ok` on >= 0.99 of lanes and by the gate statistics of
bench.py:211-247 (median |diff| < 1e-4, mean within 1%, RMSE < 0.1) on
`mask_mul`; images by the same statistics.
"""
import dataclasses
import functools
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer import bssrdf as jbs
from tpu_pathtracer.core.vecmath import make_basis as j_make_basis
from tpu_pathtracer.tracer import bssrdf_shade as jshade
from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
from tpu_pathtracer.tracer.wavefront import gather_material as j_gather
from tpu_pathtracer_torch import bssrdf as tbs
from tpu_pathtracer_torch.convert import scene_from_jax
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.scene.config import (
    MatDesc, MAT_DIFF, MAT_GLASS, MAT_REFL, MAT_SUBSURFACE)
from tpu_pathtracer_torch.tracer import bssrdf_shade as tshade
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import (
    RenderSettings, gather_material)
from torch_settings import port_fields

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
N = 4096
TABLE_KEYS = ("bssrdf_rho", "bssrdf_radius", "bssrdf_profile", "bssrdf_cdf",
              "bssrdf_rho_eff")


def _gate(img, want):
    d = np.abs(img - want)
    assert np.all(np.isfinite(img))
    assert float(np.median(d)) < 1e-4, np.median(d)
    assert abs(img.mean() / max(want.mean(), 1e-9) - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _table():
    """The renderer's table (g=0, eta=1.4, 100x64) as float32 arrays."""
    tbl = tbs.compute_beam_diffusion_table()
    f = np.float32
    return {"bssrdf_rho": tbl.rho.astype(f),
            "bssrdf_radius": tbl.radius.astype(f),
            "bssrdf_profile": tbl.profile.astype(f),
            "bssrdf_cdf": tbl.profile_cdf.astype(f),
            "bssrdf_rho_eff": tbl.rho_eff.astype(f)}


@pytest.mark.parametrize("kw", [dict(n_rho=9, n_radius=12),
                                dict(g=0.3, eta=1.33, n_rho=6, n_radius=10)])
def test_tabulate_exact(kw):
    t = tbs.compute_beam_diffusion_table(**kw)
    j = jbs.compute_beam_diffusion_table(**kw)
    for f in dataclasses.fields(j):
        assert np.array_equal(getattr(t, f.name), getattr(j, f.name)), f.name
    for eta in (0.7, 1.0, 1.4):
        assert tbs.fresnel_moment_1(eta) == jbs.fresnel_moment_1(eta)
        assert tbs.fresnel_moment_2(eta) == jbs.fresnel_moment_2(eta)
    for fn in ("beam_diffusion_ms", "beam_diffusion_ss"):
        assert getattr(tbs, fn)(0.6, 0.4, 0.1, 1.4, 0.05) == \
            getattr(jbs, fn)(0.6, 0.4, 0.1, 1.4, 0.05)
    x = np.linspace(0.0, 2.0, 9) ** 2
    v = np.cos(x)
    tt, tc = tbs.integrate_catmull_rom(x, v)
    jt, jc = jbs.integrate_catmull_rom(x, v)
    assert tt == jt and np.array_equal(tc, jc)


def test_catmull_rom_weights_match_jax():
    g = np.random.default_rng(0)
    for nodes in (_table()["bssrdf_rho"], _table()["bssrdf_radius"]):
        x = g.uniform(-0.1 * nodes[-1], 1.1 * nodes[-1], N).astype(np.float32)
        x[:8] = nodes[[0, 1, 2, -3, -2, -1, 5, 6]]          # on the nodes
        jo, jw, jv = jbs.catmull_rom_weights(*_j(nodes, x))
        to, tw, tv = tbs.catmull_rom_weights(*_t(nodes, x))
        assert np.array_equal(to.numpy(), np.asarray(jo))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        # weights are differences of cubic terms of size ~1
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                                   atol=1e-6)


def test_sample_catmull_rom_2d_and_radius_match_jax():
    g = np.random.default_rng(1)
    tb = _table()
    rho = g.uniform(0.02, 0.98, N).astype(np.float32)
    u = g.random(N).astype(np.float32)
    args = (tb["bssrdf_rho"], tb["bssrdf_radius"], tb["bssrdf_profile"],
            tb["bssrdf_cdf"], rho, u)
    j = [np.asarray(v) for v in jbs.sample_catmull_rom_2d(*_j(*args))]
    t = [v.numpy() for v in tbs.sample_catmull_rom_2d(*_t(*args))]
    for a, b in zip(t, j):
        # the Newton-bisection's last step divides two rounded sums
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert (t[0] > 0).mean() > 0.9
    sigma_t = g.uniform(0.0, 10.0, N).astype(np.float32)
    sigma_t[:16] = 0.0
    args = args[:4] + (sigma_t, rho, u)
    jr = np.asarray(jbs.sample_bssrdf_radius_table(*_j(*args)))
    tr = tbs.sample_bssrdf_radius_table(*_t(*args)).numpy()
    np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-6)
    assert not tr[:16].any()


def test_eval_profile_table_matches_jax():
    g = np.random.default_rng(2)
    tb = _table()
    rho = g.uniform(-0.05, 1.05, N).astype(np.float32)
    r_opt = (g.uniform(0.0, 1.0, N) ** 3 * 300).astype(np.float32)
    args = (tb["bssrdf_rho"], tb["bssrdf_radius"], tb["bssrdf_profile"],
            tb["bssrdf_rho_eff"], rho, r_opt)
    js, jr, jv = [np.asarray(v) for v in jbs.eval_profile_table(*_j(*args))]
    ts, tr, tv = [v.numpy() for v in tbs.eval_profile_table(*_t(*args))]
    assert np.array_equal(tv, jv) and 0.2 < tv.mean() < 0.95
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-7)


def _shade_inputs(seed):
    g = np.random.default_rng(seed)
    ns, nn = _unit(g, N), _unit(g, N)
    sigma_t = g.uniform(1.0, 10.0, (N, 3)).astype(np.float32)
    rho = g.uniform(0.1, 0.95, (N, 3)).astype(np.float32)
    d = (g.normal(size=(N, 3)) * 0.1).astype(np.float32)
    d[:8] = 0.0                                   # the radius <= 1e-4 branch
    ss, ts = (np.asarray(v) for v in j_make_basis(jnp.asarray(ns)))
    return ns, nn, sigma_t, rho, d, ss, ts


def test_param_soe_and_calculate_bssrdf_soe_match_jax():
    A = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    np.testing.assert_allclose(tshade.param_soe(torch.from_numpy(A)).numpy(),
                               np.asarray(jshade.param_soe(jnp.asarray(A))),
                               rtol=1e-6)
    x = _shade_inputs(3)
    j = np.asarray(jshade.calculate_bssrdf_soe(*_j(*x)))
    t = tshade.calculate_bssrdf_soe(*_t(*x)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-7)
    assert (t > 0).all() and t.max() <= 10.0


def test_calculate_bssrdf_table_matches_jax():
    x = _shade_inputs(4)
    tb = _table()
    j = np.asarray(jshade.calculate_bssrdf_table(
        {k: jnp.asarray(v) for k, v in tb.items()}, *_j(*x)))
    t = tshade.calculate_bssrdf_table(
        {k: torch.from_numpy(v) for k, v in tb.items()}, *_t(*x)).numpy()
    assert (j > 0).mean() > 0.5                   # inside the table's range
    # a ratio of two 4x4 spline sums whose terms cancel
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_soe", [True, False])
def test_sample_probe_ray_matches_jax(use_soe):
    g = np.random.default_rng(5)
    ns, _, sigma_t, rho, _, vx, vy = _shade_inputs(6)
    r1, r2, r3 = (g.random(N).astype(np.float32) for _ in range(3))
    hp = g.normal(size=(N, 3)).astype(np.float32)
    tb = _table()
    args = (r1, r2, r3, ns, hp, sigma_t, rho, vx, vy)
    j = jshade._sample_probe_ray(
        *_j(*args), scene={k: jnp.asarray(v) for k, v in tb.items()},
        use_soe=use_soe)
    t = tshade._sample_probe_ray(
        *_t(*args), scene={k: torch.from_numpy(v) for k, v in tb.items()},
        use_soe=use_soe)
    names = ("orig", "dir", "ray_len", "radius")
    for name, a, b in zip(names, t, j):
        # orig = hitpoint + offsets of opposite sign: atol for |hitpoint| ~ 3
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=5e-6, err_msg=name)


@functools.lru_cache(maxsize=1)
def _subsurface():
    return tdemo.testobj_scene(cache_dir=None, variant="subsurface")


@pytest.mark.parametrize("use_soe", [True, False])
def test_bssrdf_scatter_matches_jax_on_testobj_subsurface(use_soe):
    fb, mats, envmap, texture = _subsurface()
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=8,
                   height=8)
    tr = Renderer(fb, mats, envmap=envmap, texture=texture, width=8,
                  height=8, device="cpu")
    for k in TABLE_KEYS:                     # build_scene == the JAX scene
        assert np.array_equal(tr.scene[k].numpy(), np.asarray(jr.scene[k])), k
    conv = scene_from_jax({k: v if isinstance(v, int) else np.asarray(v)
                           for k, v in jr.scene.items()}, "cpu")
    assert set(conv) == set(tr.scene)
    js = dataclasses.replace(jr.settings, bssrdf_use_soe=use_soe)
    ts = dataclasses.replace(tr.settings, bssrdf_use_soe=use_soe)

    # entry points on the inner (subsurface, material 1) sphere
    g = np.random.default_rng(7)
    n0 = _unit(g, N)
    hitpoint = (np.array([0.0, 1.0, 0.0]) + 0.7 * n0).astype(np.float32)
    normal2 = -n0 + 0.2 * _unit(g, N)
    normal2 = (normal2 / np.linalg.norm(normal2, axis=-1, keepdims=True)
               ).astype(np.float32)
    mat_id = np.ones(N, np.int32)
    lanes = g.random(N) < 0.9
    rng = g.integers(0, 2 ** 32, N, dtype=np.uint32)
    jmat = j_gather(jr.scene, jnp.asarray(mat_id))
    tmat = gather_material(conv, torch.from_numpy(mat_id))
    j = jshade.bssrdf_scatter(jr.scene, js, jnp.asarray(rng),
                              jnp.asarray(hitpoint), jnp.asarray(normal2),
                              jmat, jnp.asarray(mat_id), jmat["objcol"],
                              jnp.asarray(lanes))
    t = tshade.bssrdf_scatter(conv, ts,
                              torch.from_numpy(rng.astype(np.int64)),
                              torch.from_numpy(hitpoint),
                              torch.from_numpy(normal2), tmat,
                              torch.from_numpy(mat_id), tmat["objcol"],
                              torch.from_numpy(lanes))
    j = [np.asarray(v) for v in j]
    t = [v.numpy() for v in t]
    assert len(t) == 7
    assert np.array_equal(t[0], j[0].astype(np.int64))   # rng: 4 x 3 + 2
    ok_t, ok_j = t[4], j[4]
    assert (ok_t == ok_j).mean() >= 0.99
    assert ok_t.mean() > 0.3 and not ok_t[~lanes].any()
    both = ok_t & ok_j
    _gate(t[3][both], j[3][both])                        # mask_mul
    _gate(t[5][both], j[5][both])                        # is_mul
    for k in (1, 2, 6):                  # exit origin, direction, normal
        close = np.isclose(t[k][both], j[k][both], rtol=1e-4,
                           atol=1e-5).all(axis=-1)
        assert close.mean() >= 0.99, k


def test_c5_bssrdf_matches_golden():
    fb, _, envmap, texture = _subsurface()
    mats5 = [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.8, 0.75, 0.7),
                     alphax=0.3, etaT=1.4, mfp=(0.3, 0.25, 0.2), ks=0.2),
             MatDesc(refltype=MAT_GLASS),
             MatDesc(refltype=MAT_REFL)]
    s = RenderSettings(bounce_min=3, bounce_max=10, has_bssrdf=True,
                       use_envmap=True, use_texture=True)
    r = Renderer(fb, mats5, envmap=envmap, texture=texture, width=96,
                 height=96, settings=s, device="cpu")
    cam = tdemo.default_camera(96, 96)
    cam.aperture_radius = 0.0
    cam.focal_distance = 4.0
    acc = r.render_frames(r.zeros_accum(), cam.build_render_camera(), 1, 12)
    _gate(r.accum_to_buffer(acc.numpy() / 12),
          np.load(os.path.join(GOLDEN_DIR, "c5_bssrdf.npz"))["img"])


def test_organic_sss_matches_jax_render():
    """The c6 composition on a ~6k-triangle blob, 48x48, 4 spp (the
    golden-size scene takes minutes on two CPU threads)."""
    W = 48
    fb, mats, envmap, texture = tdemo.large_organic_scene(
        cache_dir=None, variant="sss", n_lat=40, n_lon=80)
    rc = tdemo.default_camera(W, W).build_render_camera()
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=W,
                   height=W)
    tr = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                  height=W, device="cpu")
    assert port_fields(tr.settings) == port_fields(jr.settings)
    assert tr.settings.has_bssrdf and tr.settings.packet_tile_sub == 32
    jacc = np.asarray(jr.render_frames(jr.zeros_accum(), rc, 1, 4))
    tacc = tr.render_frames(tr.zeros_accum(), rc, 1, 4).numpy()
    _gate(tr.accum_to_buffer(tacc / 4), jr.accum_to_buffer(jacc / 4))


def test_head_scene_renders():
    W = 24
    fb, mats, envmap, texture = tdemo.head_scene(cache_dir=None)
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W, height=W,
                 device="cpu")
    assert r.settings.has_bssrdf
    rc = tdemo.default_camera(W, W).build_render_camera()
    img = r.accum_to_buffer(
        r.render_frames(r.zeros_accum(), rc, 1, 2).numpy() / 2)
    assert np.all(np.isfinite(img)) and img.mean() > 0.05
