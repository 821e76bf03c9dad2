"""The surface fetches (`fetch_attributes`, `env_tex_merged`,
`texture_radiance`): their plain versions (ops/surface_fetch.py) against
the JAX package on the CPU, the dispatchers of tracer/wavefront.py, the
byte counts of the bound and what the kernels' sources must agree with.

The kernels themselves (csrc/fetch.cu, csrc/envtex.cu) run only on the
card: the `cuda`-marked tests in tests/test_torch_cuda.py (which imports
no jax) hold them to the plain versions bit for bit, and chip_smoke.py
phase 13 at 1M lanes. Inputs come from numpy seeds
(tests/torch_fetch_inputs.py) and reach both packages as identical
arrays; the scene is the port's TestObj stream, from which the JAX
Renderer builds its tables too. Tolerances are tests/test_torch_shading.py's:
rtol 1e-5 / atol 1e-6 (the ulps by which torch's and XLA's atan2, acos
and sqrt may differ); env texel lookups at least 99% of lanes strict and
all within rtol 1e-3 / atol 1e-5 (one ulp of u moves a bilinear weight
by one ulp of u*W); int outputs exact; NaN where the other has NaN.
"""
import functools
import os
import re
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.tracer import bssrdf_shade as jshade
from tpu_pathtracer.tracer import wavefront as jwf
from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
from tpu_pathtracer_torch.convert import scene_from_jax
from tpu_pathtracer_torch.ops import surface_fetch as sf
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.tracer import device_loop, regen
from tpu_pathtracer_torch.tracer import bssrdf_shade as tshade
from tpu_pathtracer_torch.tracer import wavefront as twf
from tpu_pathtracer_torch.tracer.renderer import Renderer
from torch_fetch_inputs import fetch_inputs, envtex_inputs

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
RTOL, ATOL = 1e-5, 1e-6
N = 4096
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _scenes(variant="default"):
    """(JAX scene, port scene, JAX settings, port settings) of the port's
    TestObj stream (variant of demo.testobj_scene), 8x8."""
    fb, mats, envmap, texture = tdemo.testobj_scene(cache_dir=None,
                                                    variant=variant)
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=8,
                   height=8)
    tr = Renderer(fb, mats, envmap=envmap, texture=texture, width=8,
                  height=8, device="cpu")
    host = {k: v if isinstance(v, int) else np.asarray(v)
            for k, v in jr.scene.items()}
    return jr.scene, scene_from_jax(host, "cpu"), jr.settings, tr.settings


def _close(t, j, texel_lookup=False):
    """tests/test_torch_shading.py's _close, NaN equal to NaN."""
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape and t.dtype == j.dtype, (t.dtype, j.dtype)
    if t.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j)
        return
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    if texel_lookup:
        ok = np.isclose(t, j, rtol=RTOL, atol=ATOL, equal_nan=True)
        assert ok.all(axis=-1).mean() >= 0.99, ok.all(axis=-1).mean()
        np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-5)
    else:
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def _j(*tensors):
    return [jnp.asarray(t.numpy()) for t in tensors]


def test_fetch_attributes_matches_jax_with_misses():
    """slot -1 lanes whose hit point is inf, NaN or the point at t = 1e20
    read row 0 and give tri_n 0, as the JAX function does; every output
    agrees on every lane, every material id present."""
    js, ts, _, _ = _scenes()
    slot, hp = fetch_inputs(ts, N, 20, CPU)
    ids = ts["tri_attr"][:, 24].contiguous().view(torch.int32)
    miss = slot < 0
    assert 0.3 < float(miss.float().mean()) < 0.5
    assert (~torch.isfinite(hp[miss])).any(-1).sum() > 0
    got = twf.fetch_attributes(ts, slot, hp)
    want = jwf.fetch_attributes(js, *_j(slot, hp))
    assert set(got[2][~miss].tolist()) == set(ids.tolist())
    assert not bool(got[3][miss].any())
    # the miss lanes' uv and normals: whatever the far point gives, the
    # same NaNs in both
    for t, j in zip(got, want):
        _close(t[~miss], np.asarray(j)[~miss.numpy()])
        if t.dtype == torch.float32:
            np.testing.assert_array_equal(torch.isnan(t).numpy(),
                                          np.isnan(np.asarray(j)))


def test_env_tex_merged_matches_jax():
    """bsdf_pdf < 0 on ~30% of lanes (weight 1), miss lanes with NaN / inf
    hit_uv, the rotation a 0-d tensor, the lat-long seams and poles: the
    env radiance on every lane and the texture on the hit lanes agree, and
    the texture is NaN in both where the uv is not finite."""
    js, ts, jset, tset = _scenes()
    raydir, pdf, rot, miss, uv = envtex_inputs(ts, N, 21, CPU)
    assert rot.dim() == 0 and bool((pdf < 0).any())
    nonfinite = ~torch.isfinite(uv).all(-1)
    assert bool(nonfinite[miss].any()) and not bool(nonfinite[~miss].any())
    got = twf.env_tex_merged(ts, tset, raydir, pdf, rot, miss, uv)
    jd, jp, jm, juv = _j(raydir, pdf, miss, uv)
    want = jwf.env_tex_merged(js, jset, jd, jp, jnp.float32(0.3), jm, juv)
    _close(got[0], want[0], texel_lookup=True)
    assert bool(torch.isfinite(got[0]).all())
    _close(got[1], want[1])
    assert bool(torch.isnan(got[1][nonfinite]).all())


@pytest.mark.parametrize("n", [0, 1, 397])
def test_texture_radiance_matches_jax(n):
    js, ts, _, _ = _scenes()
    _, _, _, miss, uv = envtex_inputs(ts, max(n, 1), 22, CPU, miss_share=0)
    uv = uv[:n]
    got = twf.texture_radiance(ts, uv)
    assert got.shape == (n, 3)
    _close(got, jwf.texture_radiance(js, *_j(uv)))


def test_bssrdf_probe_path_matches_jax_through_the_dispatchers(
        monkeypatch):
    """bssrdf_scatter's probe loop fetches the attributes and the texture
    of each probe hit through the dispatchers (one call each a probe), on
    the CPU through the plain versions, counting no launch; its results
    agree with the JAX probe loop (tests/test_torch_bssrdf.py's measure)."""
    js, ts, jset, tset = _scenes("subsurface")
    n = 256
    g = np.random.default_rng(23)
    n0 = g.normal(size=(n, 3))
    n0 /= np.linalg.norm(n0, axis=-1, keepdims=True)
    hitpoint = (np.array([0.0, 1.0, 0.0]) + 0.7 * n0).astype(np.float32)
    normal2 = (-n0).astype(np.float32)
    mat_id = np.ones(n, np.int32)
    lanes = g.random(n) < 0.9
    rng = g.integers(0, 2 ** 32, n, dtype=np.uint32)
    calls = {"fetch_attributes": 0, "texture_radiance": 0}

    def counted(name):
        fn = getattr(twf, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    for name in calls:
        monkeypatch.setattr(twf, name, counted(name))
    before = dict(sf.LAUNCHES)
    jmat = jwf.gather_material(js, jnp.asarray(mat_id))
    tmat = twf.gather_material(ts, torch.from_numpy(mat_id))
    j = jshade.bssrdf_scatter(js, jset, jnp.asarray(rng),
                              jnp.asarray(hitpoint), jnp.asarray(normal2),
                              jmat, jnp.asarray(mat_id), jmat["objcol"],
                              jnp.asarray(lanes))
    t = tshade.bssrdf_scatter(ts, tset, torch.from_numpy(rng.astype(
        np.int64)), torch.from_numpy(hitpoint), torch.from_numpy(normal2),
        tmat, torch.from_numpy(mat_id), tmat["objcol"],
        torch.from_numpy(lanes))
    assert calls == {"fetch_attributes": tset.bssrdf_probes,
                     "texture_radiance": tset.bssrdf_probes}
    assert sf.LAUNCHES == before
    j = [np.asarray(v) for v in j]
    t = [v.numpy() for v in t]
    assert np.array_equal(t[0], j[0].astype(np.int64))
    assert (t[4] == j[4]).mean() >= 0.99 and t[4].mean() > 0.3
    both = t[4] & j[4]
    close = np.isclose(t[1][both], j[1][both], rtol=1e-4,
                       atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99


# ---- the dispatchers ----

def _stub_kernel(monkeypatch):
    """_kernel raises Stub: returns the exception class."""
    class Stub(RuntimeError):
        pass

    def entry(name):
        raise Stub(name)
    monkeypatch.setattr(sf, "_kernel", entry)
    return Stub


def _calls(name, *args):
    if name == "env_tex_merged":
        return twf.env_tex_merged(args[0], None, *args[1:])
    return getattr(twf, name)(*args)


def _inputs(name, n=64, device=CPU):
    _, ts, _, _ = _scenes()
    if name == "fetch_attributes":
        return (ts,) + fetch_inputs(ts, n, 24, device)
    raydir, pdf, rot, miss, uv = envtex_inputs(ts, n, 24, device)
    if name == "texture_radiance":
        return ts, uv
    return ts, raydir, pdf, rot, miss, uv


NAMES = ["fetch_attributes", "env_tex_merged", "texture_radiance"]


@pytest.mark.parametrize("name", NAMES)
def test_dispatcher_sends_cpu_tensors_to_the_plain_version(name,
                                                           monkeypatch):
    """On the CPU the dispatcher returns the plain version's bits, never
    reaches the kernel's entry and counts no launch."""
    _stub_kernel(monkeypatch)
    args = _inputs(name)
    before = dict(sf.LAUNCHES)
    got = _calls(name, *args)
    plain = getattr(sf, name + "_plain")
    want = plain(args[0], None, *args[1:]) if name == "env_tex_merged" \
        else plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int32), b.view(torch.int32))
    assert sf.LAUNCHES == before


def _on_card(t):
    """A stand-in for t on a CUDA device: its shape, device cuda:0."""
    return types.SimpleNamespace(device=torch.device("cuda", 0),
                                 shape=t.shape)


@pytest.mark.parametrize("name", NAMES)
def test_dispatcher_sends_a_cuda_device_to_the_kernel(name, monkeypatch):
    """A tensor on a CUDA device goes to the kernel's entry and the entry's
    error reaches the caller; the plain version is never called."""
    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")
    Stub = _stub_kernel(monkeypatch)
    for p in NAMES:
        monkeypatch.setattr(twf, p + "_plain", plain)
    args = list(_inputs(name))
    args[1] = _on_card(args[1])                 # the tensor that decides
    with pytest.raises(Stub, match=name):
        _calls(name, *args)


def test_kernel_paths_refuse_what_the_kernels_cannot_take():
    ts = _inputs("fetch_attributes")[0]
    for name in NAMES:
        args = _inputs(name)
        with pytest.raises(ValueError, match="not a CUDA device"):
            sf._PREPARE[name](*args)
        with pytest.raises(ValueError, match="current CUDA device"):
            sf.launch_fn(name, *args)
    # a table whose base is not 16-byte aligned, of another width or dtype
    wide = torch.zeros(65, 28)
    for bad, match in ((wide.view(-1)[1:1 + 64 * 28].view(64, 28),
                        "16-byte aligned"),
                       (wide[:, :16].contiguous(), "shape"),
                       (wide.double(), "dtype")):
        with pytest.raises(ValueError, match=match):
            sf._table({"tri_attr": bad}, "tri_attr", CPU, 28)
    assert sf._table(ts, "tri_attr", CPU, 28) is ts["tri_attr"]
    with pytest.raises(ValueError, match="8-byte aligned"):
        sf._uv(torch.zeros(9, 2).view(-1)[1:17].view(8, 2), CPU, 8)
    with pytest.raises(ValueError, match="contiguous"):
        sf._uv(torch.zeros(2, 8).t(), CPU, 8)


# ---- what the bound counts ----

def test_rows_read_are_the_rows_the_plain_versions_read():
    """rows_read gives each lane the row its plain version gathers: with a
    table whose row r holds r in every texel, the bilinear blend of a row
    (weights summing to 1) returns r to within rounding, and the fetch's
    mat_id is the row's id column."""
    _, ts, _, _ = _scenes()
    scene = dict(ts)
    for key in ("envtex_quad", "texture_quad"):
        rows, cols = scene[key].shape
        t = torch.zeros(rows, cols)
        t[:, :12] = torch.arange(rows, dtype=torch.float32)[:, None]
        scene[key] = t
    raydir, pdf, rot, miss, uv = envtex_inputs(ts, N, 25, CPU)
    pdf = -torch.ones_like(pdf)                       # MIS weight 1
    env_L, tex = sf.env_tex_merged_plain(scene, None, raydir, pdf, rot, miss,
                                         uv)
    rows = sf.rows_read("env_tex_merged", scene, raydir, pdf, rot, miss, uv)
    assert torch.equal(torch.round(env_L[:, 0]).long(), rows)
    assert torch.equal(torch.round(tex[~miss, 0]).long(), rows[~miss])
    assert bool((rows[miss] < ts["env_h"] * ts["env_w"]).all())
    rows = sf.rows_read("texture_radiance", scene, uv[~miss])
    got = sf.texture_radiance_plain(scene, uv[~miss])
    assert torch.equal(torch.round(got[:, 0]).long(), rows)
    slot, hp = fetch_inputs(ts, N, 25, CPU)
    scene["tri_attr"] = ts["tri_attr"].clone()
    scene["tri_attr"][:, 24] = torch.arange(
        scene["tri_attr"].shape[0], dtype=torch.int32).view(torch.float32)
    mat_id = sf.fetch_attributes_plain(scene, slot, hp)[2]
    assert torch.equal(mat_id.long(), sf.rows_read("fetch_attributes",
                                                   scene, slot, hp))


@pytest.mark.parametrize("name,lane,row", [
    ("fetch_attributes", 4 + 12 + 8 + 12 + 4 + 12, 28 * 4),
    ("env_tex_merged", 12 + 4 + 1 + 8 + 12 + 12, 16 * 4),
    ("texture_radiance", 8 + 12, 12 * 4)])
def test_io_bytes_of_a_hand_counted_call(name, lane, row):
    """Five lanes reading rows 3, 3, 7, 0, 7: five lanes' inputs and
    outputs, three distinct rows, and the rotation's 4 bytes for the
    merged kernel."""
    rows = torch.tensor([3, 3, 7, 0, 7])
    extra = 4 if name == "env_tex_merged" else 0
    assert sf.LANE_BYTES[name] == lane and sf.ROW_BYTES[name] == row
    assert sf.io_bytes(name, rows) == 5 * lane + 3 * row + extra
    assert sf.io_bytes(name, rows[:0]) == extra


# ---- what the sources must agree with ----

def _consts(source):
    """The constants of csrc/<source> as nvcc compiles it, with the csrc
    headers it includes (the table layouts live in csrc/surface.cuh)."""
    from tpu_pathtracer_torch.utils import cuda_build
    src = cuda_build.source_text(source[:-len(".cu")])
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"\bk(\w+) = (\d+)", src)}


def test_kernel_layouts_match_the_tables():
    """csrc/fetch.cu reads the columns pack_tri_attributes writes, and
    csrc/envtex.cu the widths of pack_envtex_quad's and the texture's
    quad rows."""
    c = _consts("fetch.cu")
    assert c["AttrCols"] == sf.ATTR_COLS == 28
    pos, uv, nrm = (np.arange(9, dtype=np.float32).reshape(1, 9),
                    np.full((1, 6), 100, np.float32),
                    np.full((1, 9), 200, np.float32))
    packed = twf.pack_tri_attributes(pos, uv, nrm, [7])
    assert (packed[0, c["ColUv"]:c["ColUv"] + 6] == 100).all()
    assert (packed[0, c["ColNrm"]:c["ColNrm"] + 9] == 200).all()
    assert packed[0, c["ColMat"]:c["ColMat"] + 1].view(np.int32)[0] == 7
    assert c["ColGeoN"] == c["ColMat"] + 1 and c["ColGeoN"] + 3 == 28
    e = _consts("envtex.cu")
    assert (e["EnvCols"], e["TexCols"]) == (sf.ENV_COLS, sf.TEX_COLS)
    assert twf.pack_envtex_quad(np.zeros((2, 16)), np.zeros((3, 12))
                                ).shape == (5, sf.ENV_COLS)


def test_chip_smoke_builds_both_sources():
    """chip_smoke.py phase 2 builds every csrc/*.cu, and the wrappers' C
    entries live in fetch.cu and envtex.cu."""
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert 'f.endswith(".cu")' in src and "cuda_build.KernelLibs(names)" in src
    csrc = os.path.join(REPO, "tpu_pathtracer_torch", "csrc")
    for source, entry, _ in sf._ENTRIES.values():
        text = open(os.path.join(csrc, source + ".cu")).read()
        assert 'extern "C" int %s(' % entry in text, (source, entry)
    assert {s for s, _, _ in sf._ENTRIES.values()} == {"fetch", "envtex"}


# ---- the main path calls each stage once a wave and a bounce ----

def test_device_loop_holds_the_new_counts():
    counts = device_loop.launch_counts()
    assert set(sf.LAUNCHES) <= set(counts)
    saved = dict(counts)
    try:
        device_loop.set_launch_counts({k: 0 for k in counts})
        device_loop.add_launches({"env_tex_merged": 2})
        assert sf.LAUNCHES == {"fetch_attributes": 0, "env_tex_merged": 2,
                               "texture_radiance": 0}
    finally:
        device_loop.set_launch_counts(saved)


@pytest.mark.parametrize("integrator", ["regen", "bounce"])
def test_a_wave_and_a_bounce_call_each_stage_once(integrator, monkeypatch):
    """A default TestObj regen wave calls fetch_attributes and
    env_tex_merged once each and texture_radiance never; a bounce calls
    fetch_attributes and texture_radiance once each (on the card, one
    launch each)."""
    import dataclasses
    fb, mats, envmap, texture = tdemo.testobj_scene(cache_dir=None)
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=16,
                 height=16, device="cpu")
    r.settings = dataclasses.replace(r.settings, integrator=integrator)
    calls = dict.fromkeys(NAMES, 0)

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)
    for mod in (twf, regen):
        for name in NAMES:
            if hasattr(mod, name):
                counted(mod, name)
    cam = tdemo.default_camera(16, 16).build_render_camera()
    _, steps, _ = r.render_frames(r.zeros_accum(), cam, 1, 1,
                                  with_stats=True)
    if integrator == "regen":
        waves = sum(r.regen_integrator(True).last_waves.values())
        assert calls == {"fetch_attributes": waves, "env_tex_merged": waves,
                         "texture_radiance": 0}, (calls, waves)
    else:
        launched = r.bounce_integrator(True).last_launched
        assert launched >= steps > 0
        assert calls == {"fetch_attributes": launched, "env_tex_merged": 0,
                         "texture_radiance": launched}, (calls, launched)
