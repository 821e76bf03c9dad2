"""The surface BSDF draw (`shade`): the wrapper of ops/shade.py on the
CPU, its plain version against the JAX package material by material, and
the dispatch that sends a CUDA tensor to csrc/shade.cu.

The kernel itself runs only on the card: the `cuda`-marked tests in
tests/test_torch_cuda.py (which imports no jax) hold it to the plain
version bit for bit, and chip_smoke.py phase 12 at 1M lanes. Here the
plain version meets JAX's `tracer/wavefront.py: shade` on numpy-seeded
inputs, one material at a time, with the RNG, the flags and the counts
exact and the floats under tests/test_torch_shading.py's `_close`: rtol
1e-5 / atol 1e-6, the ulps by which torch's and XLA's sin, cos, tan, atan
and sqrt may differ. The three vector outputs (next_dir, mask_mul,
ss_normal) take that function's second form, as its texel lookups do: at
least 99% of lanes within rtol 1e-5 / atol 1e-6 and every lane within
rtol 1e-3 / atol 1e-5. A GGX draw reflects the ray about a sampled
microfacet normal, which turns those ulps into a few more: with 512 lanes
of one GGX material, 1 lane's direction leaves the strict bound (2.5e-6
on a component of 0.1; 1.1e-5 relative at most on mask_mul); with the
random mix of test_torch_shading.py, no lane does.
"""
import re
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.tracer import wavefront as jwf
from tpu_pathtracer_torch.ops import shade as tshade
from tpu_pathtracer_torch.scene import config as tcfg
from tpu_pathtracer_torch.scene.config import MatDesc
from tpu_pathtracer_torch.tracer import wavefront as twf
from torch_shade_inputs import mixed_inputs, kernel_args

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
RTOL, ATOL = 1e-5, 1e-6
N = 512

# one case per branch of shade: the eight refltypes, mirror / GGX
# (isotropic, anisotropic) reflection, smooth / rough glass, rough /
# smooth subsurface
CASES = {
    "emit": MatDesc(refltype=tcfg.MAT_EMIT, emit=(4.0, 3.0, 2.0)),
    "diffuse": MatDesc(refltype=tcfg.MAT_DIFF, kd=0.8),
    "glass_smooth": MatDesc(refltype=tcfg.MAT_GLASS),
    "glass_rough": MatDesc(refltype=tcfg.MAT_GLASS, alphax=0.15, etaT=1.5),
    "mirror": MatDesc(refltype=tcfg.MAT_REFL),
    "ggx_iso": MatDesc(refltype=tcfg.MAT_REFL, alphax=0.2, alphay=0.2),
    "ggx_aniso": MatDesc(refltype=tcfg.MAT_REFL, alphax=0.3, alphay=0.1),
    "diff_refl": MatDesc(refltype=tcfg.MAT_DIFF_REFL, alphax=0.2,
                         alphay=0.2, kd=0.6, ks=0.4),
    "fresnel": MatDesc(refltype=tcfg.MAT_FRESNEL, alphax=0.1, alphay=0.1,
                       kd=5.0),
    "null": MatDesc(refltype=tcfg.MAT_NULL),
    "subsurface_rough": MatDesc(refltype=tcfg.MAT_SUBSURFACE, alphax=0.3,
                                etaT=1.4, ks=0.2),
    "subsurface_smooth": MatDesc(refltype=tcfg.MAT_SUBSURFACE, etaT=1.3,
                                 ks=0.5),
}


def _close(t, j, amplified=False):
    """tests/test_torch_shading.py's _close; amplified is its texel_lookup
    form."""
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape and t.dtype == j.dtype, (t.dtype, j.dtype)
    if t.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j)
    elif amplified:
        strict = np.isclose(t, j, rtol=RTOL, atol=ATOL).all(axis=-1)
        assert strict.mean() >= 0.99, strict.mean()
        np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-5)
    else:
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


def _unit(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _inputs(mat, into, seed):
    """Host arrays of one material at N lanes: every lane faces the normal
    (into) or leaves through it (not into)."""
    g = np.random.default_rng(seed)
    raydir = _unit(g, N)
    n = _unit(g, N)
    facing = (raydir * n).sum(-1) < 0
    n = np.where((facing == into)[:, None], n, -n).astype(np.float32)
    into_a = np.full(N, into)
    nl = np.where(into_a[:, None], n, -n).astype(np.float32)
    table = twf.pack_mat_table(tcfg.materials_to_arrays([mat]))
    return dict(raydir=raydir, n=n, nl=nl, into=into_a,
                mat_id=np.zeros(N, np.int32), table=table,
                objcol=g.uniform(0, 1, (N, 3)).astype(np.float32),
                state=g.integers(0, 2 ** 32, N, dtype=np.uint64))


@pytest.mark.parametrize("into", [True, False], ids=["into", "out"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_shade_matches_jax_per_material(case, into):
    a = _inputs(CASES[case], into, 100 + list(CASES).index(case))
    js = {"mat_table": jnp.asarray(a["table"])}
    ts = {"mat_table": torch.from_numpy(a["table"])}
    jmat = jwf.gather_material(js, jnp.asarray(a["mat_id"]))
    tmat = twf.gather_material(ts, torch.from_numpy(a["mat_id"]))
    settings = jwf.RenderSettings()
    want = jwf.shade(js, settings, jnp.asarray(a["state"].astype(np.uint32)),
                     *(jnp.asarray(a[k]) for k in ("raydir", "n", "nl",
                                                   "into")),
                     jmat, jnp.asarray(a["objcol"]))
    got = tshade.shade_plain(
        ts, twf.RenderSettings(),
        torch.from_numpy(a["state"].astype(np.int64)),
        *(torch.from_numpy(a[k]) for k in ("raydir", "n", "nl", "into")),
        tmat, torch.from_numpy(a["objcol"]))
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32),
                                  np.asarray(want[0]))
    for i, (w, t) in enumerate(zip(want[1:6], got[1:6])):
        _close(t, w, amplified=i < 2)             # next_dir, mask_mul
    for k in ("glass_refract", "ss_refract"):
        _close(got[6][k], want[6][k])
    _close(got[6]["ss_normal"], want[6]["ss_normal"], amplified=True)


def _mixed(n=4096, seed=21):
    return mixed_inputs(n, seed, "cpu")


def _same_bits(a, b):
    """Equal bit for bit (the miss lanes' NaNs included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_wrapper_on_cpu_equals_plain_bit_for_bit():
    scene, args, mat_id, _ = _mixed()
    before = dict(tshade.LAUNCHES)
    got = tshade.shade(scene, None, *args, mat_id=mat_id)
    want = tshade.shade_plain(scene, None, *args)
    assert tshade.LAUNCHES == before          # the CPU launches no kernel
    for g, w in zip(got[:6], want[:6]):
        assert _same_bits(g, w)
    assert set(got[6]) == set(want[6])
    for k in ("glass_refract", "ss_refract", "ss_normal"):
        assert _same_bits(got[6][k], want[6][k])
    for g, w in zip(got[6]["u"], want[6]["u"]):
        assert _same_bits(g, w)
    # without mat_id (the CPU does not need it): the same bits
    for g, w in zip(tshade.shade(scene, None, *args)[:6], want[:6]):
        assert _same_bits(g, w)
    # shade_hits calls the wrapper
    assert twf.shade is tshade.shade


def test_mixed_inputs_cover_every_refltype():
    scene, (rng, raydir, n, nl, into, mat, objcol), mat_id, surf = _mixed()
    assert set(mat["refltype"].tolist()) == set(range(8))
    M = scene["mat_table"].shape[0]
    assert bool((mat_id < 0).any()) and bool((mat_id >= M).any())
    assert bool(surf.any()) and not bool(surf.all())
    assert torch.isnan(n[~surf]).all() and torch.isfinite(n[surf]).all()
    assert bool(into.any()) and not bool(into[surf].all())


def _on_card(t):
    """A stand-in for t on a CUDA device: its shape, device cuda:0."""
    return types.SimpleNamespace(device=torch.device("cuda", 0),
                                 shape=t.shape)


def test_dispatch_sends_a_cuda_device_to_the_kernel(monkeypatch):
    """A tensor on a CUDA device goes to the kernel's entry and the
    entry's error reaches the caller; the plain version is never called."""
    def plain(*a, **k):
        raise AssertionError("the plain shade ran for a CUDA tensor")

    class Stub(RuntimeError):
        pass

    def entry():
        raise Stub("kernel entry reached")
    monkeypatch.setattr(tshade, "shade_plain", plain)
    monkeypatch.setattr(tshade, "_kernel", entry)
    scene, (rng, raydir, n, nl, into, mat, objcol), mat_id, _ = _mixed(64)
    with pytest.raises(Stub):
        tshade.shade(scene, None, rng, _on_card(raydir), n, nl, into, mat,
                     objcol, mat_id=mat_id)
    # the CPU still takes the plain version, never the kernel
    monkeypatch.undo()
    monkeypatch.setattr(tshade, "_kernel", entry)
    tshade.shade(scene, None, rng, raydir, n, nl, into, mat, objcol,
                 mat_id=mat_id)


def test_kernel_path_refuses_what_the_kernel_cannot_take():
    scene, args, mat_id, _ = _mixed(64)
    rng, raydir, n, nl, into, mat_id, objcol = kernel_args(args, mat_id)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tshade._prepare(scene, rng, raydir, n, nl, into, mat_id, objcol)
    # on the card the kernel reads the ids, so a call without them stops
    with pytest.raises(ValueError, match="mat_id.*required"):
        tshade._prepare(scene, rng, _on_card(raydir), n, nl, into, None,
                        objcol)
    with pytest.raises(ValueError, match="current CUDA device"):
        tshade.launch_fn(scene, rng, raydir, n, nl, into, mat_id, objcol)
    cpu = torch.device("cpu")
    # a [N,3] input is read in rows: its columns must be adjacent, but an
    # empty one (which a 0-lane launch never reads) may have any strides
    with pytest.raises(ValueError, match="adjacent columns"):
        tshade._row_stride(torch.zeros((3, 64)).t(), "raydir", cpu, 64)
    assert tshade._row_stride(objcol, "objcol", cpu, 64) == objcol.stride(0)
    assert tshade._row_stride(args[5]["objcol"], "objcol", cpu, 64) == 31
    assert tshade._row_stride(torch.empty_strided((0, 3), (1, 1)), "n",
                              cpu, 0) == 1


def test_kernel_reads_the_table_by_the_mat_cols_layout():
    """csrc/shade.cu reads the material table's columns by the offsets of
    tracer/wavefront.py's _MAT_COLS (which pack_mat_table writes and
    gather_material reads) and the refltypes by scene/config.py's
    numbers."""
    from tpu_pathtracer_torch.utils import cuda_build
    # the source as nvcc compiles it: the columns live in csrc/lane_math.cuh
    src = cuda_build.source_text("shade")
    consts = {m.group(1): int(m.group(2))
              for m in re.finditer(r"\bk(\w+) = (\d+)", src)}
    for name, col in (("ColRefltype", "refltype"), ("ColAlphax", "alphax"),
                      ("ColAlphay", "alphay"), ("ColKd", "kd"),
                      ("ColKs", "ks"), ("ColEtaT", "etaT"), ("ColF0", "F0"),
                      ("ColTangent", "tangent"), ("ColObjcol", "objcol"),
                      ("ColUseNormal", "useNormal"),
                      ("ColUseTexture", "useTexture"), ("ColMfp", "mfp")):
        assert consts[name] == twf._MAT_COLS[col][0], name
    assert consts["MatCols"] == tshade.MAT_COLS == max(
        b for _, b in twf._MAT_COLS.values())
    for name in ("EMIT", "GLASS", "REFL", "DIFF_REFL", "FRESNEL", "NULL",
                 "SUBSURFACE"):
        key = "Mat" + "".join(w.capitalize() for w in name.split("_"))
        assert consts[key] == getattr(tcfg, "MAT_" + name), name


# bytes of one lane beside the 79 every lane moves (rng 8, mat_id 4, nl
# 12 in; 55 out), by what its branch reads of raydir (12), n (12), into
# (1) and objcol (12); bounce_inc is the lane's draw (1: specular)
IO_CASES = {
    "emit": (CASES["emit"], 0, 12),
    "diffuse": (CASES["diffuse"], 0, 12),
    "mirror": (CASES["mirror"], 1, 12 + 12 + 12),
    "ggx": (CASES["ggx_iso"], 1, 12 + 12),
    "diff_refl_specular": (CASES["diff_refl"], 1, 12),
    "diff_refl_diffuse": (CASES["diff_refl"], 0, 12),
    "fresnel": (CASES["fresnel"], 1, 12 + 12),
    "glass_smooth": (CASES["glass_smooth"], 1, 12 + 1),
    "glass_rough": (CASES["glass_rough"], 1, 12 + 1 + 12),
    "null": (CASES["null"], 0, 12),
    "subsurface": (CASES["subsurface_rough"], 1, 12 + 1 + 12),
}


@pytest.mark.parametrize("case", list(IO_CASES))
def test_io_bytes_count_what_a_lane_reads(case):
    m, binc, extra = IO_CASES[case]
    table = torch.from_numpy(twf.pack_mat_table(tcfg.materials_to_arrays(
        [m])))
    mat = twf.gather_material({"mat_table": table},
                              torch.zeros(5, dtype=torch.int32))
    binc = torch.full((5,), binc, dtype=torch.int32)
    # 5 lanes, and the 12 columns the kernel reads of the one table row
    assert tshade.io_bytes(mat, binc, 1) == 5 * (79 + extra) + 48
