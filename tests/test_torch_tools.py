"""The port's gallery, showcase and sweep tools on the CPU: the gallery's
variants are the JAX tool's field by field and one renders the JAX image
under bench.py's gate statistics (median |diff| < 1e-4, mean within 1%,
RMSE < 0.1); the showcase writes and re-reads its HDR sky and renders;
sweep_frame times two override sets."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import gallery as jgallery  # noqa: E402

from tpu_pathtracer.tracer.renderer import Renderer as JRenderer  # noqa
from tpu_pathtracer_torch.core.image import read_ppm  # noqa: E402
from tpu_pathtracer_torch.scene import demo as tdemo  # noqa: E402
from tpu_pathtracer_torch.scene.hdr import read_hdr  # noqa: E402
from tpu_pathtracer_torch.tools import gallery, showcase_1080p  # noqa
from tpu_pathtracer_torch.tools import sweep_frame  # noqa: E402

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))


def _gate(img, want):
    d = np.abs(img - want)
    assert np.all(np.isfinite(img))
    assert float(np.median(d)) < 1e-4, np.median(d)
    assert abs(img.mean() / max(want.mean(), 1e-9) - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


def test_gallery_variants_are_the_jax_tools():
    mine, theirs = gallery.variants(), jgallery.variants()
    assert list(mine) == list(theirs) and len(mine) == 16
    for name in mine:
        assert [dataclasses.asdict(m) for m in mine[name]] == \
            [dataclasses.asdict(m) for m in theirs[name]], name
    st = gallery.variant_settings("medium_jade")
    assert (st.bounce_max, st.has_media) == (64, True)
    assert gallery.variant_settings("mirror") is None


def test_gallery_variant_matches_jax(tmp_path):
    W, spp, name = 16, 2, "ggx_gold"
    parts = gallery.scene_parts(str(tmp_path))
    mats = gallery.variants()[name]
    r, acc = gallery.render_variant(name, mats, W, spp, parts, "cpu")
    fb, envmap, texture = parts
    jr = JRenderer(fb, jgallery.variants()[name], envmap=envmap,
                   texture=texture, width=W, height=W)
    rc = tdemo.default_camera(W, W).build_render_camera()
    jacc = np.asarray(jr.render_frames(jr.zeros_accum(), rc, 1, spp))
    _gate(r.accum_to_buffer(acc) / spp, jr.accum_to_buffer(jacc) / spp)


def test_gallery_cli_writes_ppm(tmp_path):
    out = tmp_path / "g"
    assert gallery.main(["--device", "cpu", "--size", "8", "--spp", "1",
                         "--only", "mirror,null", "--ext", "ppm",
                         "--out-dir", str(out), "--cache-dir",
                         str(tmp_path)]) == 0
    assert sorted(os.listdir(out)) == ["mirror.ppm", "null.ppm"]
    assert read_ppm(str(out / "null.ppm")).shape == (8, 8, 3)


def test_gallery_ladder_writes_each_rung(tmp_path):
    """The BSSRDF row: one accumulation written at each rung."""
    parts = gallery.scene_parts(str(tmp_path))
    rungs = gallery.ladder(8, parts, str(tmp_path), "ppm", "cpu",
                           spps=(1, 3))
    assert [(spp, os.path.basename(path)) for spp, _, path in rungs] == [
        (1, "bssrdf_1spp.ppm"), (3, "bssrdf_3spp.ppm")]
    for _, _, path in rungs:
        img = read_ppm(path)
        assert img.shape == (8, 8, 3) and img.mean() > 0.05


def test_showcase_writes_rereads_the_sky_and_renders(tmp_path):
    out = str(tmp_path / "s.ppm")
    t = showcase_1080p.render_showcase(32, 18, 64, 2, out, str(tmp_path),
                                       "cpu")
    sky = read_hdr(str(tmp_path / "showcase_sky.hdr"))
    assert sky.shape == (32, 64, 3) and np.isfinite(sky).all()
    img = read_ppm(out)
    assert img.shape == (18, 32, 3) and img.mean() > 0.05
    assert t["spp"] == 2 and t["mean"] > 0
    for k in ("env_io_s", "build_s", "first_frame_s", "rest_s"):
        assert t[k] >= 0.0, k


def test_sweep_frame_times_two_sets(capsys):
    assert sweep_frame.main(["--device", "cpu", "--wh", "8", "--frames",
                             "1", "2", "--turns", "2", "",
                             "scatter_mode='wave',pool_lanes=1<<5"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("defaults: ")
    assert lines[1].startswith("scatter_mode='wave',pool_lanes=1<<5: ")
    for line in lines:
        assert line.split("(turns ")[1].count("/") == 1   # two turns each


def test_sweep_restores_the_settings():
    fb, mats, envmap, texture = tdemo.testobj_scene(cache_dir=None)
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=8,
                 height=8, device="cpu")
    base = r.settings
    rc = tdemo.default_camera(8, 8).build_render_camera()
    rec = sweep_frame.sweep(r, rc, ["pool_lanes=16"], (1, 2), 1)
    assert r.settings is base
    assert len(rec["pool_lanes=16"]["runs"]) == 1
    with pytest.raises(TypeError):
        sweep_frame.sweep(r, rc, ["no_such_field=1"], (1, 2), 1)
    assert r.settings is base
