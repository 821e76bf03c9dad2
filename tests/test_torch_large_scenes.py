"""The port's large demo scenes against the JAX package: equal bits.

The procedural mesh functions, the PLY round trip, `content_hash` and the
flattened BVH stream are numpy and C++ in both packages, so everything is
compared bit for bit, at small tessellations (the full-size scenes are
for the card)."""
import dataclasses

import numpy as np
import pytest
import torch

from tpu_pathtracer.scene import procedural as jproc
from tpu_pathtracer.scene import demo as jdemo
from tpu_pathtracer.scene import plyloader as jply
from tpu_pathtracer_torch.scene import procedural as tproc
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.scene import plyloader as tply
from tpu_pathtracer_torch.tools import probe_steps

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))

MESH_FIELDS = ("vertices", "indices", "uv", "normals", "material_ids")


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str, a.shape, a.tobytes()


def _same_mesh(t, j):
    assert t.content_hash() == j.content_hash()
    for f in MESH_FIELDS:
        assert _bits(getattr(t, f)) == _bits(getattr(j, f)), f


def _same_scene(t, j):
    tfb, tmats, tenv, ttex = t
    jfb, jmats, jenv, jtex = j
    for f in dataclasses.fields(jfb):
        assert _bits(getattr(tfb, f.name)) == _bits(getattr(jfb, f.name)), \
            f.name
    assert [dataclasses.asdict(m) for m in tmats] == \
        [dataclasses.asdict(m) for m in jmats]
    assert _bits(tenv) == _bits(jenv) and _bits(ttex) == _bits(jtex)


@pytest.mark.parametrize("maker,kw", [
    ("make_uv_sphere_fast", dict(center=(0.0, 1.0, 0.0), radius=0.7,
                                 mat_id=1, n_lat=12, n_lon=20)),
    ("make_uv_sphere_fast", dict(center=(0.5, -1.0, 2.0), radius=1.3,
                                 mat_id=2, n_lat=7, n_lon=9)),
    ("make_plane_grid", dict(center=(0, 0, 0), size_x=20.0, size_z=20.0,
                             mat_id=0, nx=5, nz=7, uv_scale=8.0)),
    ("make_plane_grid", dict(center=(1.0, 0.5, -2.0), size_x=3.0,
                             size_z=9.0, mat_id=3, nx=1, nz=4)),
    ("make_organic_blob", dict(n_lat=12, n_lon=20)),
    ("make_organic_blob", dict(center=(0.3, 0.2, 0.1), radius=0.5, mat_id=4,
                               n_lat=9, n_lon=14, seed=3)),
    ("make_large_scene", dict(n_lat=8, n_lon=12, ground_div=4)),
])
def test_procedural_builders_identical(maker, kw):
    _same_mesh(getattr(tproc, maker)(**kw), getattr(jproc, maker)(**kw))


def test_ply_round_trip_identical(tmp_path):
    mesh = tproc.make_organic_blob(n_lat=10, n_lon=16)
    tp, jp = tmp_path / "t.ply", tmp_path / "j.ply"
    tply.write_ply_binary(str(tp), mesh)
    jply.write_ply_binary(str(jp), mesh)
    assert tp.read_bytes() == jp.read_bytes()
    # each loader reads the other's file
    _same_mesh(tply.load_ply(str(jp)), jply.load_ply(str(tp)))
    back = tply.load_ply(str(tp))
    assert _bits(back.vertices) == _bits(mesh.vertices)
    assert _bits(back.indices) == _bits(mesh.indices)


def test_ply_ascii_identical(tmp_path):
    p = tmp_path / "a.ply"
    p.write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
        "property float y\nproperty float z\nproperty float u\n"
        "property float v\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0 0 0\n1 0 0 1 0\n1 1 0 1 1\n0 1 0 0 1\n4 0 1 2 3\n")
    t, j = tply.load_ply(str(p)), jply.load_ply(str(p))
    _same_mesh(t, j)
    assert t.num_triangles == 2


def test_ply_unknown_format_raises(tmp_path):
    p = tmp_path / "b.ply"
    p.write_bytes(b"ply\nformat binary_big_endian 1.0\nelement vertex 0\n"
                  b"end_header\n")
    with pytest.raises(ValueError):
        tply.load_ply(str(p))


def test_head_scene_identical(tmp_path):
    _same_scene(tdemo.head_scene(cache_dir=str(tmp_path / "t")),
                jdemo.head_scene(cache_dir=str(tmp_path / "j")))


@pytest.mark.parametrize("variant", ["sss", "media"])
def test_large_organic_scene_identical(variant, tmp_path):
    kw = dict(variant=variant, n_lat=16, n_lon=28)
    _same_scene(tdemo.large_organic_scene(cache_dir=str(tmp_path / "t"),
                                          **kw),
                jdemo.large_organic_scene(cache_dir=str(tmp_path / "j"),
                                          **kw))


def test_large_organic_scene_unknown_variant_raises(tmp_path):
    with pytest.raises(ValueError):
        tdemo.large_organic_scene(cache_dir=str(tmp_path), variant="skin",
                                  n_lat=6, n_lon=8)


def test_large_scene_identical_and_shares_the_cache(tmp_path):
    kw = dict(n_lat=10, n_lon=16, ground_div=5)
    cache = str(tmp_path / "shared")
    j = jdemo.large_scene(cache_dir=cache, **kw)
    files = sorted(p.name for p in (tmp_path / "shared").iterdir())
    t = tdemo.large_scene(cache_dir=cache, **kw)
    # same cache key: the port loaded the JAX package's file, wrote none
    assert sorted(p.name for p in (tmp_path / "shared").iterdir()) == files
    _same_scene(t, j)
    # BFS order: the node rows come first, the root at row 0
    assert 0 < t[0].num_nodes < t[0].prims.shape[0]


@pytest.mark.parametrize("scene", probe_steps.SCENES)
def test_probe_scene_parts(scene):
    fb, mats, envmap, texture = probe_steps.scene_parts(
        scene, None, **({} if scene == "testobj"
                        else dict(n_lat=8, n_lon=12)))
    assert fb.prims.shape[1] == 12 and len(mats) >= 2
    assert envmap.ndim == 3 and texture.ndim == 3


def test_probe_scene_parts_unknown_raises():
    with pytest.raises(ValueError):
        probe_steps.scene_parts("huge")
