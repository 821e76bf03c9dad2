"""The port's host-side scene I/O against the JAX package's, bit for bit,
on files each test writes to tmp_path (after tests/test_scene_io.py:13-138,
148-165,206, tests/test_scene_pipeline.py:15 and
tests/test_envmap_scale.py:23).

Loaders and writers are numpy in both packages: files, arrays and decoded
images are compared exactly. The tensor samplers (sample_texture,
sample_envmap, sample_env_dir) compute their addresses with the same
float ops; directions go through atan2 / arccos, whose torch and XLA
roundings differ by ulps, so those outputs are held to rtol 1e-5, atol
1e-6 with at most 1% of lanes off (a lane whose u lands on a texel edge
may pick the neighbour). The scene description renders to the JAX image
under bench.py's gate statistics.
"""
import json
import struct

import numpy as np
import jax.numpy as jnp
import torch

from tpu_pathtracer.scene import (
    load_scene_desc as j_load_desc, load_obj as j_load_obj,
    write_obj as j_write_obj, read_hdr as j_read_hdr,
    write_hdr as j_write_hdr, procedural as jproc)
from tpu_pathtracer.scene import texture as jtex
from tpu_pathtracer.tracer import envsample as jenv
from tpu_pathtracer_torch.scene import procedural, demo as tdemo
from tpu_pathtracer_torch.scene import texture as ttex
from tpu_pathtracer_torch.scene.config import (
    load_scene_desc, materials_to_arrays, MAT_FRESNEL, MAT_GLASS)
from tpu_pathtracer_torch.scene.hdr import read_hdr, write_hdr, \
    _float_to_rgbe
from tpu_pathtracer_torch.scene.objloader import load_obj, write_obj
from tpu_pathtracer_torch.tracer import envsample as tenv
from test_scene_io import _rle_encode_scanline

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))


def _mesh_equal(a, b):
    for k in ("vertices", "indices", "uv", "normals", "material_ids"):
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _close_on_most_lanes(got, want, rtol=1e-5, atol=1e-6, share=0.99):
    got, want = np.asarray(got), np.asarray(want)
    ok = np.isclose(got, want, rtol=rtol, atol=atol)
    ok = ok.reshape(ok.shape[0], -1).all(-1)
    assert ok.mean() >= share, ok.mean()


def test_scene_desc_reference_schema(tmp_path):
    js = {"scenefile": "data/TestObj.obj", "HDRmapname": "data/pisa.hdr",
          "textureFile": "data/Checker.png",
          "camFile": "data/newCamSetting.cam", "matCount": 3,
          "matDesc": {
              "InnerMat": {"refltype": "MAT_FRESNEL", "alphax": 0.1,
                           "alphay": 0.1, "objcol": [1.0, 1.0, 1.0],
                           "kd": 5.0, "ks": 1.0},
              "OuterMat": {"refltype": "MAT_GLASS"},
              "BackGroundMat": {"refltype": "MAT_DIFF",
                                "useTexture": True}}}
    p = tmp_path / "sceneDesc.json"
    p.write_text(json.dumps(js))
    desc, jdesc = load_scene_desc(str(p)), j_load_desc(str(p))
    assert desc.mat_id_map == jdesc.mat_id_map
    assert desc.materials[0].refltype == MAT_FRESNEL
    assert desc.materials[1].refltype == MAT_GLASS
    a = materials_to_arrays(desc.materials)
    from tpu_pathtracer.scene import materials_to_arrays as j_arrays
    b = j_arrays(jdesc.materials)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_obj_write_and_load_match_jax(tmp_path):
    mesh = procedural.make_test_scene()
    names = {0: "ground", 1: "inner", 2: "outer", 3: "logo"}
    write_obj(str(tmp_path / "t.obj"), mesh, names)
    j_write_obj(str(tmp_path / "j.obj"), jproc.make_test_scene(), names)
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()
    ids = {v: k for k, v in names.items()}
    back = load_obj(str(tmp_path / "t.obj"), ids)
    _mesh_equal(back, j_load_obj(str(tmp_path / "t.obj"), ids))
    assert back.num_triangles == mesh.num_triangles
    np.testing.assert_array_equal(back.material_ids, mesh.material_ids)


def test_obj_material_name_mapping_and_ngons(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvt 1 0\n"
                 "vt 0 1\nusemtl MatA\nf 1/1 2/2 3/3\nusemtl MatB\n"
                 "f 3 2 1\nusemtl Nope\nf -4 -3 -1 -2\n")
    mesh = load_obj(str(p), {"MatA": 4, "MatB": 7})
    assert mesh.material_ids.tolist() == [4, 7, 0, 0]
    _mesh_equal(mesh, j_load_obj(str(p), {"MatA": 4, "MatB": 7}))


def test_hdr_write_and_read_match_jax(tmp_path):
    env = procedural.make_sky_envmap(64, 32)
    write_hdr(str(tmp_path / "t.hdr"), env)
    j_write_hdr(str(tmp_path / "j.hdr"), env)
    assert (tmp_path / "t.hdr").read_bytes() == \
        (tmp_path / "j.hdr").read_bytes()
    back = read_hdr(str(tmp_path / "t.hdr"))
    assert back.dtype == np.float32 and back.shape == env.shape
    np.testing.assert_array_equal(back, j_read_hdr(str(tmp_path / "t.hdr")))
    rel = np.abs(back - env) / (np.abs(env) + 1e-3)
    assert np.percentile(rel, 99) < 0.02


def test_hdr_rle_decode(tmp_path):
    w, h = 32, 4
    rgbe_val = (128, 64, 32, 129)
    with open(tmp_path / "r.hdr", "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        for _ in range(h):
            f.write(struct.pack("BBBB", 2, 2, 0, w))
            for c in range(4):
                f.write(struct.pack("BB", 128 + w, rgbe_val[c]))
    img = read_hdr(str(tmp_path / "r.hdr"))
    np.testing.assert_array_equal(img, j_read_hdr(str(tmp_path / "r.hdr")))
    scale = np.ldexp(1.0, 129 - 136)
    np.testing.assert_allclose(img[0, 0], np.array([128, 64, 32]) * scale,
                               rtol=1e-6)
    assert np.all(img == img[0, 0])


def test_hdr_old_style_runs(tmp_path):
    w, h = 8, 2
    with open(tmp_path / "o.hdr", "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        for _ in range(h):
            f.write(struct.pack("BBBB", 100, 50, 25, 130))
            f.write(struct.pack("BBBB", 1, 1, 1, 7))
    img = read_hdr(str(tmp_path / "o.hdr"))
    np.testing.assert_array_equal(img, j_read_hdr(str(tmp_path / "o.hdr")))
    assert np.all(img == img[0, 0])


def test_hdr_orientation_matches_jax(tmp_path):
    """tests/test_scene_io.py:206 in the port: RLE scanlines decode in file
    order, and the first file scanline is the zenith row of the envmap
    lookup."""
    H, W = 8, 16
    img = np.tile(np.float32([0.5, 1.0, 2.0]), (H, W, 1))
    img[1, 3] = [4.0, 0.25, 0.25]
    img[6, 12] = [0.25, 4.0, 0.25]
    rgbe = _float_to_rgbe(img)
    path = tmp_path / "marked.hdr"
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (H, W))
        for y in range(H):
            f.write(_rle_encode_scanline(rgbe[y]))
    dec = read_hdr(str(path))
    np.testing.assert_array_equal(dec, img)

    def dir_of(row, col):
        theta, phi = (row + 0.5) / H * np.pi, (col + 0.5) / W * 2 * np.pi
        return [np.sin(theta) * np.sin(phi), np.cos(theta),
                np.sin(theta) * np.cos(phi)]
    dirs = np.float32([dir_of(1, 3), dir_of(6, 12), [0.0, 1.0, 0.0]])
    out = ttex.sample_envmap(torch.from_numpy(dec), torch.from_numpy(dirs),
                             0.0).numpy()
    assert out[0, 0] > 2.0 and out[0, 1] < 1.0
    assert out[1, 1] > 2.0 and out[1, 0] < 1.0
    np.testing.assert_allclose(out[2], [0.5, 1.0, 2.0], atol=1e-5)
    want = np.asarray(jtex.sample_envmap(jnp.asarray(dec),
                                         jnp.asarray(dirs), 0.0))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


def test_load_texture_matches_jax(tmp_path):
    from PIL import Image
    tex = (procedural.make_checker_texture(64) * 255).astype(np.uint8)
    tex[3, 5] = (17, 200, 99)
    Image.fromarray(tex, "RGB").save(str(tmp_path / "c.png"))
    got = ttex.load_texture(str(tmp_path / "c.png"))
    want = jtex.load_texture(str(tmp_path / "c.png"))
    assert got.dtype == np.float32 and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, want)


def test_sample_texture_and_envmap_match_jax():
    g = np.random.default_rng(5)
    tex = g.random((24, 40, 3)).astype(np.float32)
    u = g.uniform(-2.0, 3.0, 4096).astype(np.float32)
    v = g.uniform(-2.0, 3.0, 4096).astype(np.float32)
    got = ttex.sample_texture(torch.from_numpy(tex), torch.from_numpy(u),
                              torch.from_numpy(v)).numpy()
    want = np.asarray(jtex.sample_texture(jnp.asarray(tex), jnp.asarray(u),
                                          jnp.asarray(v)))
    _close_on_most_lanes(got, want)
    d = g.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = ttex.sample_envmap(torch.from_numpy(tex), torch.from_numpy(d),
                             0.3).numpy()
    want = np.asarray(jtex.sample_envmap(jnp.asarray(tex), jnp.asarray(d),
                                         0.3))
    _close_on_most_lanes(got, want)


def test_sample_env_dir_matches_jax():
    env = procedural.make_sky_envmap(128, 64)
    dist = tenv.build_env_distribution(env, topk=1024)
    jdist = jenv.build_env_distribution(env, topk=1024)
    g = np.random.default_rng(9)
    u1, u2 = g.random(4096).astype(np.float32), \
        g.random(4096).astype(np.float32)
    d, pdf = tenv.sample_env_dir({k: torch.from_numpy(np.asarray(v))
                                  for k, v in dist.items()},
                                 torch.from_numpy(u1), torch.from_numpy(u2),
                                 0.25)
    jd, jpdf = jenv.sample_env_dir({k: jnp.asarray(v)
                                    for k, v in jdist.items()},
                                   jnp.asarray(u1), jnp.asarray(u2), 0.25)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-5)


def _write_desc(tmp_path, W):
    from PIL import Image
    mesh = procedural.make_test_scene()
    write_obj(str(tmp_path / "scene.obj"), mesh,
              {0: "BackGroundMat", 1: "InnerMat", 2: "OuterMat",
               3: "LTELogo"})
    write_hdr(str(tmp_path / "sky.hdr"), procedural.make_sky_envmap(64, 32))
    tex = (procedural.make_checker_texture(64) * 255).astype(np.uint8)
    Image.fromarray(tex, "RGB").save(str(tmp_path / "checker.png"))
    tdemo.default_camera(W, W).save_cam(str(tmp_path / "cam.cam"))
    desc = {"scenefile": "scene.obj", "HDRmapname": "sky.hdr",
            "textureFile": "checker.png", "camFile": "cam.cam",
            "matCount": 4, "width": W, "height": W,
            "matDesc": {
                "InnerMat": {"refltype": "MAT_FRESNEL", "alphax": 0.1,
                             "alphay": 0.1, "kd": 5.0, "ks": 1.0},
                "OuterMat": {"refltype": "MAT_GLASS"},
                "LTELogo": {"refltype": "MAT_REFL"},
                "BackGroundMat": {"refltype": "MAT_DIFF",
                                  "useTexture": True}}}
    (tmp_path / "sceneDesc.json").write_text(json.dumps(desc))
    return str(tmp_path / "sceneDesc.json")


def test_scene_desc_renders_the_jax_image(tmp_path):
    """tests/test_scene_pipeline.py:15 in the port: a scene description on
    disk (OBJ, HDR, PNG, .cam) renders through renderer_from_scene_desc
    to the JAX package's image."""
    from tpu_pathtracer.tracer.renderer import \
        renderer_from_scene_desc as j_from_desc
    from tpu_pathtracer_torch.tracer.renderer import (
        renderer_from_scene_desc, scene_parts_from_desc)
    from tpu_pathtracer_torch.scene.camera import InteractiveCamera
    W = 32
    path = _write_desc(tmp_path, W)
    desc = load_scene_desc(path)
    fb, mats, env, tex, settings = scene_parts_from_desc(
        desc, base_dir=str(tmp_path), cache_dir=str(tmp_path / "cache"))
    assert env.shape == (32, 64, 3) and tex.shape == (64, 64, 3)
    assert settings.use_envmap and settings.use_texture
    r = renderer_from_scene_desc(desc, base_dir=str(tmp_path),
                                 cache_dir=str(tmp_path / "cache"),
                                 device="cpu")
    jr = j_from_desc(j_load_desc(path), base_dir=str(tmp_path),
                     cache_dir=str(tmp_path / "cache"))
    rc = InteractiveCamera.load_cam(str(tmp_path / "cam.cam")) \
        .build_render_camera()
    img = r.accum_to_buffer(r.render_frames(r.zeros_accum(), rc, 1, 2)
                            .numpy() / 2)
    want = jr.accum_to_buffer(np.asarray(
        jr.render_frames(jr.zeros_accum(), rc, 1, 2)) / 2)
    d = np.abs(img - want)
    assert float(np.median(d)) < 1e-4
    assert abs(img.mean() / want.mean() - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1
    assert img.mean() > 0.05 and img.std() > 0.05


def test_megapixel_envmap_end_to_end(tmp_path):
    """tests/test_envmap_scale.py:23 in the port: a 2048x1024 HDR through
    write_hdr -> read_hdr -> the alias distribution -> a render with env
    NEE."""
    from tpu_pathtracer_torch.accel import flatten_mesh_bvh
    from tpu_pathtracer_torch.scene.config import MatDesc, MAT_DIFF, \
        MAT_REFL
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    env = procedural.make_sky_envmap(2048, 1024)
    p = str(tmp_path / "sky2k.hdr")
    write_hdr(p, env)
    back = read_hdr(p)
    assert back.shape == env.shape
    rel = np.abs(back - env) / np.maximum(np.abs(env), 1e-3)
    assert np.median(rel) < 0.01 and rel.max() < 0.05
    dist = tenv.build_env_distribution(back, topk=0)
    assert dist["env_alias"].shape[0] == 2048 * 1024
    fb = flatten_mesh_bvh(procedural.make_test_scene())
    mats = [MatDesc(refltype=MAT_DIFF, useTexture=False),
            MatDesc(refltype=MAT_DIFF, objcol=(0.8, 0.4, 0.3)),
            MatDesc(refltype=MAT_REFL),
            MatDesc(refltype=MAT_REFL, alphax=0.2, alphay=0.2)]
    W = 32
    r = Renderer(fb, mats, envmap=back, width=W, height=W, device="cpu")
    rc = tdemo.default_camera(W, W).build_render_camera()
    img = r.render_frames(r.zeros_accum(), rc, 1, 2).numpy()
    assert np.isfinite(img).all()
    assert img.mean() > 0.01
    assert img.max() > img.mean() * 2.0
