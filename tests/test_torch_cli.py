"""The port's CLI, `python -m tpu_pathtracer_torch.tools.render`, on the
CPU (--device cpu): a demo render to PPM and PNG, checkpoint and resume,
and a checkpoint written by the JAX tool (tools/render.py) resumed in the
port. Small sizes (16x16, a few spp)."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.core.image import read_ppm
from tpu_pathtracer_torch.tools import render as cli

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(tmp_path, *extra, spp=2, out="x.ppm"):
    args = ["--demo", "default", "--size", "16", "--spp", str(spp),
            "--out", str(tmp_path / out), "--device", "cpu",
            "--cache-dir", str(tmp_path / "cache")] + list(extra)
    assert cli.main(args) == 0


def test_demo_render_to_ppm_as_a_module(tmp_path):
    out, ck = tmp_path / "x.ppm", tmp_path / "x.npz"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch.tools.render",
         "--demo", "default", "--size", "16", "--spp", "2", "--out",
         str(out), "--checkpoint", str(ck), "--device", "cpu",
         "--cache-dir", str(tmp_path / "cache")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "wrote %s (2 spp)" % out in proc.stdout
    img = read_ppm(str(out))
    assert img.shape == (16, 16, 3) and img.max() > 0
    wall = json.loads((tmp_path / "x.ppm.wall.json").read_text())
    assert (wall["width"], wall["height"], wall["spp"]) == (16, 16, 2)
    assert wall["device"] == "cpu"
    z = np.load(str(ck))
    assert set(z.files) == {"accum", "frame", "width", "height"}
    assert int(z["frame"]) == 2 and z["accum"].shape == (256, 3)
    assert np.isfinite(z["accum"]).all() and z["accum"].mean() > 0


def test_png_output(tmp_path):
    from PIL import Image
    _run(tmp_path, out="x.png")
    img = np.asarray(Image.open(str(tmp_path / "x.png")))
    assert img.shape == (16, 16, 3) and img.max() > 0


def test_resume_gives_the_uninterrupted_render(tmp_path):
    """2 spp checkpointed, then resumed to 4, equals 4 spp in one run: the
    frames are numbered, so every sample is the same."""
    _run(tmp_path, "--checkpoint", str(tmp_path / "a.npz"), spp=2)
    _run(tmp_path, "--resume", str(tmp_path / "a.npz"), spp=4)
    _run(tmp_path, "--checkpoint", str(tmp_path / "b.npz"), spp=4)
    a, b = np.load(str(tmp_path / "a.npz")), np.load(str(tmp_path / "b.npz"))
    assert int(a["frame"]) == int(b["frame"]) == 4
    np.testing.assert_array_equal(a["accum"], b["accum"])


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint written by the JAX tool's save_checkpoint (same keys)
    resumes in the port; the result is the port's own 4-spp render under
    the gate statistics."""
    spec = importlib.util.spec_from_file_location(
        "jax_render_tool", os.path.join(REPO, "tools", "render.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    from tpu_pathtracer.scene.demo import testobj_scene, default_camera
    from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
    fb, mats, envmap, texture = testobj_scene(
        cache_dir=str(tmp_path / "cache"))
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=16,
                   height=16)
    rc = default_camera(16, 16).build_render_camera()
    jacc = jr.render_frames(jr.zeros_accum(), rc, 1, 2)
    jtool.save_checkpoint(str(tmp_path / "j.npz"), jacc, 2,
                          {"width": 16, "height": 16})
    _run(tmp_path, "--resume", str(tmp_path / "j.npz"), spp=4)
    _run(tmp_path, "--checkpoint", str(tmp_path / "t.npz"), spp=4)
    got, want = np.load(str(tmp_path / "j.npz")), \
        np.load(str(tmp_path / "t.npz"))
    assert int(got["frame"]) == 4
    d = np.abs(got["accum"] / 4 - want["accum"] / 4)
    assert float(np.median(d)) < 1e-4
    assert abs(got["accum"].mean() / want["accum"].mean() - 1) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


@pytest.mark.parametrize("argv,msg", [
    (["--demo", "defualt"], "unknown demo"),
    (["--resume", "{ck}", "--size", "8"], "holds a 16x16 render"),
])
def test_cli_refuses(tmp_path, argv, msg):
    np.savez(str(tmp_path / "c.npz"), accum=np.zeros((256, 3), np.float32),
             frame=1, width=16, height=16)
    argv = [a.format(ck=tmp_path / "c.npz") for a in argv]
    with pytest.raises(SystemExit, match=msg):
        cli.main(argv + ["--device", "cpu", "--out",
                         str(tmp_path / "x.ppm"), "--cache-dir",
                         str(tmp_path / "cache")])
