"""Port shading stages and env sampling against the JAX package.

Inputs come from numpy seeds and reach both packages as identical arrays
(the scene through convert.scene_from_jax). Tolerance rtol 1e-5 /
atol 1e-6 covers the ulps by which torch's and XLA's transcendentals
(sin, cos, tan, atan2, acos, sqrt) may differ.

Environment lookups map a direction to texel coordinates through atan2 and
acos and then scale by the map width (512): one ulp of difference in u
moves the bilinear weight by one ulp of u*W (~3e-5), times the difference
between neighbouring texels. For those a few lanes (at most 1%) may leave
the strict tolerance; every lane stays within rtol 1e-3 / atol 1e-5.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.scene import procedural as jproc
from tpu_pathtracer.scene.demo import testobj_scene as j_testobj
from tpu_pathtracer.tracer import renderer as jrenderer
from tpu_pathtracer.tracer import wavefront as jwf
from tpu_pathtracer.tracer import envsample as jenv
from tpu_pathtracer.tracer import traverse as jtrav
from tpu_pathtracer.materials import bsdf as jbsdf
from tpu_pathtracer.materials import fresnel as jfresnel
from tpu_pathtracer_torch.convert import scene_from_jax
from tpu_pathtracer_torch.scene import config as tcfg
from tpu_pathtracer_torch.scene.config import MatDesc
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.tracer import wavefront as twf
from tpu_pathtracer_torch.tracer import envsample as tenv
from tpu_pathtracer_torch.tracer.renderer import Renderer as TRenderer
from tpu_pathtracer_torch.scene import procedural as tproc
from tpu_pathtracer_torch.tracer import traverse as ttrav
from tpu_pathtracer_torch.materials import bsdf as tbsdf
from tpu_pathtracer_torch.materials import fresnel as tfresnel
from torch_settings import port_fields

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
RTOL, ATOL = 1e-5, 1e-6
N = 4096

# every material branch of shade(), isotropic and anisotropic, smooth and
# rough, plus an emitter and a null interface
MATS = [
    MatDesc(refltype=tcfg.MAT_DIFF, useTexture=True),
    MatDesc(refltype=tcfg.MAT_FRESNEL, alphax=0.1, alphay=0.1, kd=5.0),
    MatDesc(refltype=tcfg.MAT_GLASS),
    MatDesc(refltype=tcfg.MAT_REFL),
    MatDesc(refltype=tcfg.MAT_REFL, alphax=0.2, alphay=0.2),
    MatDesc(refltype=tcfg.MAT_REFL, alphax=0.3, alphay=0.1),
    MatDesc(refltype=tcfg.MAT_GLASS, alphax=0.15, etaT=1.5),
    MatDesc(refltype=tcfg.MAT_DIFF_REFL, alphax=0.2, alphay=0.2, kd=0.6,
            ks=0.4),
    MatDesc(refltype=tcfg.MAT_EMIT, emit=(4.0, 3.0, 2.0)),
    MatDesc(refltype=tcfg.MAT_NULL),
    MatDesc(refltype=tcfg.MAT_SUBSURFACE, alphax=0.3, etaT=1.4, ks=0.2),
]


@functools.lru_cache(maxsize=1)
def _scenes():
    fb, mats, envmap, texture = j_testobj(cache_dir=None)
    jr = jrenderer.Renderer(fb, mats, envmap=envmap, texture=texture,
                            width=16, height=16)
    host = {k: v if isinstance(v, int) else np.asarray(v)
            for k, v in jr.scene.items()}
    host["mat_table"] = twf.pack_mat_table(tcfg.materials_to_arrays(MATS))
    jscene = {k: v if isinstance(v, int) else jnp.asarray(v)
              for k, v in host.items()}
    return jscene, scene_from_jax(host, "cpu"), jr.settings


def _close(t, j, texel_lookup=False):
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            _close(t[k], j[k])
        return
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape and t.dtype == j.dtype, (t.dtype, j.dtype)
    if t.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j)
    elif texel_lookup:
        strict = np.isclose(t, j, rtol=RTOL, atol=ATOL).all(axis=-1)
        assert strict.mean() >= 0.99, strict.mean()
        np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-5)
    else:
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def _unit(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_fetch_attributes_matches_jax():
    js, ts, _ = _scenes()
    g = np.random.default_rng(10)
    kt = js["tri_attr"].shape[0]
    slot = g.integers(-1, kt, N).astype(np.int32)
    hp = g.uniform(-3, 3, (N, 3)).astype(np.float32)
    (j_slot, j_hp), (t_slot, t_hp) = _both(slot, hp)
    want = jwf.fetch_attributes(js, j_slot, j_hp)
    got = twf.fetch_attributes(ts, t_slot, t_hp)
    for w, t in zip(want, got):
        _close(t, w)


def test_gather_material_matches_jax():
    js, ts, _ = _scenes()
    g = np.random.default_rng(11)
    mid = g.integers(-1, len(MATS) + 1, N).astype(np.int32)  # out of range too
    (jm,), (tm,) = _both(mid)
    _close(twf.gather_material(ts, tm), jwf.gather_material(js, jm))


@pytest.mark.parametrize("nonfinite_uv", [False, True])
def test_env_tex_merged_matches_jax(nonfinite_uv):
    js, ts, settings = _scenes()
    g = np.random.default_rng(12)
    d = _unit(g, N)
    pdf = np.where(g.random(N) < 0.3, -1.0,
                   g.uniform(0, 2, N)).astype(np.float32)
    miss = g.random(N) < 0.4
    uv = g.uniform(-5, 5, (N, 2)).astype(np.float32)
    if nonfinite_uv:
        # miss lanes carry non-finite hit_uv on the render path
        uv[miss] = np.array([np.nan, np.inf], np.float32)
    (jd, jp, jmi, juv), (td, tp, tmi, tuv) = _both(d, pdf, miss, uv)
    want = jwf.env_tex_merged(js, settings, jd, jp, jnp.float32(0.3), jmi,
                              juv)
    got = twf.env_tex_merged(ts, settings, td, tp, torch.tensor(0.3), tmi,
                             tuv)
    _close(got[0], want[0], texel_lookup=True)
    _close(got[1][torch.from_numpy(~miss)], np.asarray(want[1])[~miss])
    assert torch.isfinite(got[0]).all()


def test_env_miss_and_texture_match_jax():
    js, ts, settings = _scenes()
    g = np.random.default_rng(13)
    d = _unit(g, N)
    pdf = np.where(g.random(N) < 0.3, -1.0,
                   g.uniform(0, 2, N)).astype(np.float32)
    uv = g.uniform(-5, 5, (N, 2)).astype(np.float32)
    (jd, jp, juv), (td, tp, tuv) = _both(d, pdf, uv)
    _close(twf.env_miss_weighted(ts, settings, td, tp, torch.tensor(0.3)),
           jwf.env_miss_weighted(js, settings, jd, jp, jnp.float32(0.3)),
           texel_lookup=True)
    _close(twf.texture_radiance(ts, tuv), jwf.texture_radiance(js, juv))


@pytest.mark.parametrize("variant", ["no_nee", "no_envmap"])
def test_env_miss_without_nee_matches_jax(variant):
    js, ts, settings = _scenes()
    import dataclasses
    if variant == "no_nee":
        st_j = dataclasses.replace(settings, env_importance_sampling=False)
    else:
        st_j = dataclasses.replace(settings, use_envmap=False)
    st_t = twf.RenderSettings(**port_fields(st_j))
    g = np.random.default_rng(16)
    d = _unit(g, N)
    pdf = g.uniform(0, 2, N).astype(np.float32)
    (jd, jp), (td, tp) = _both(d, pdf)
    _close(twf.env_miss_weighted(ts, st_t, td, tp, torch.tensor(0.3)),
           jwf.env_miss_weighted(js, st_j, jd, jp, jnp.float32(0.3)),
           texel_lookup=True)


def test_fresnel_moments_and_hg_phase_match_jax():
    g = np.random.default_rng(17)
    eta = g.uniform(0.5, 2.5, N).astype(np.float32)
    for fn in ("fresnel_moment_1", "fresnel_moment_2"):
        _close(getattr(tfresnel, fn)(torch.from_numpy(eta)),
               getattr(jfresnel, fn)(jnp.asarray(eta)))
    u1 = g.random(N, dtype=np.float32)
    u2 = g.random(N, dtype=np.float32)
    gg = np.where(g.random(N) < 0.2, 0.0, g.uniform(-0.9, 0.9, N)) \
        .astype(np.float32)
    d = _unit(g, N)
    (j1, j2, jg, jd), (t1, t2, tg, td) = _both(u1, u2, gg, d)
    _close(tbsdf.henyey_greenstein_sample(t1, t2, tg, td),
           jbsdf.henyey_greenstein_sample(j1, j2, jg, jd))


def test_woop_geometric_normal_matches_jax():
    js, ts, _ = _scenes()
    g = np.random.default_rng(18)
    kt = js["tri_attr"].shape[0]
    slot = g.integers(-1, kt, N).astype(np.int32)
    want = jtrav.woop_geometric_normal(js["prims"], js["num_nodes"],
                                       jnp.asarray(slot))
    got = ttrav.woop_geometric_normal(ts["prims"], ts["num_nodes"],
                                      torch.from_numpy(slot))
    _close(got, want)
    # the cross product the packed attributes carry in cols 25:28 (numpy)
    hit = slot >= 0
    packed_n = ts["tri_attr"].numpy()[np.maximum(slot, 0), 25:28]
    np.testing.assert_allclose(got.numpy()[hit], packed_n[hit], rtol=RTOL,
                               atol=ATOL)


def test_shade_matches_jax():
    js, ts, settings = _scenes()
    g = np.random.default_rng(14)
    raydir = _unit(g, N)
    n = _unit(g, N)
    into = (raydir * n).sum(-1) < 0
    nl = np.where(into[:, None], n, -n).astype(np.float32)
    mid = g.integers(0, len(MATS), N).astype(np.int32)
    objcol = g.uniform(0, 1, (N, 3)).astype(np.float32)
    state = g.integers(0, 2 ** 32, N, dtype=np.uint64)
    (jd, jn, jnl, jin, jm, jo), (td, tn, tnl, tin, tm, to) = _both(
        raydir, n, nl, into, mid, objcol)
    jmat = jwf.gather_material(js, jm)
    tmat = twf.gather_material(ts, tm)
    want = jwf.shade(js, settings, jnp.asarray(state.astype(np.uint32)),
                     jd, jn, jnl, jin, jmat, jo)
    got = twf.shade(ts, settings, torch.from_numpy(state.astype(np.int64)),
                    td, tn, tnl, tin, tmat, to)
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32),
                                  np.asarray(want[0]))
    for w, t in zip(want[1:6], got[1:6]):
        _close(t, w)
    for k in ("glass_refract", "ss_refract", "ss_normal"):
        _close(got[6][k], want[6][k])


def test_sample_env_matches_jax():
    js, ts, _ = _scenes()
    g = np.random.default_rng(15)
    u1 = g.random(N, dtype=np.float32)
    u2 = g.random(N, dtype=np.float32)
    (j1, j2), (t1, t2) = _both(u1, u2)
    want = jenv.sample_env(js, j1, j2, jnp.float32(0.3))
    got = tenv.sample_env(ts, t1, t2, torch.tensor(0.3))
    for w, t in zip(want, got):
        _close(t, w)
    _close(tenv.env_pdf_of_dir(ts, got[0], torch.tensor(0.3)),
           jenv.env_pdf_of_dir(js, want[0], jnp.float32(0.3)))
    pf, pg = _both(u1, u2)
    _close(tenv.power_heuristic(*pg), jenv.power_heuristic(*pf))


@pytest.mark.parametrize("shape,topk", [((32, 64), 16384), ((128, 256), 16384)])
def test_furnace_with_importance_sampling(shape, topk):
    """A uniform envmap around a white diffuse sphere stays exactly 1 with
    NEE + MIS; with the top-k cap smaller than the envmap (second case)
    NEE covers half the sphere and the BSDF side must cover the rest."""
    env = np.ones(shape + (3,), np.float32)
    from tpu_pathtracer.accel import flatten_mesh_bvh
    fb = flatten_mesh_bvh(tproc.make_uv_sphere((0, 0, 0), 1.0, 0,
                                               n_lat=12, n_lon=16))
    s = twf.RenderSettings(bounce_min=16, bounce_max=16, use_envmap=True,
                           use_texture=False, env_importance_sampling=True,
                           env_nee_topk=topk)
    r = TRenderer(fb, [MatDesc(refltype=tcfg.MAT_DIFF, kd=1.0)],
                  envmap=env, width=48, height=48, settings=s, device="cpu")
    assert r.scene["env_alias"].shape[0] == min(topk, shape[0] * shape[1])
    rc = tdemo.default_camera(48, 48, pitch=0.0, radius=4,
                              center=(0, 0, 0)).build_render_camera()
    img = r.render_frames(r.zeros_accum(), rc, 1, 24).numpy() / 24
    assert np.all(np.isfinite(img))
    assert abs(img.mean() - 1.0) < 0.02
