"""The port imports torch and never jax."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "tpu_pathtracer_torch")


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for m in ("core.rng", "core.vecmath", "core.image", "scene.config",
              "scene.mesh", "scene.camera", "scene.procedural",
              "scene.demo", "scene.texture", "materials.fresnel",
              "materials.bsdf", "tracer.traverse", "tracer.envsample",
              "tracer.wavefront", "tracer.renderer", "tracer.regen",
              "ops.traverse_packet", "utils.cuda_build", "convert"):
        assert "tpu_pathtracer_torch." + m in mods, m


def test_importing_every_port_module_leaves_jax_out():
    code = ("import importlib, sys\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'jaxlib' or k.startswith('jaxlib.'))\n"
            "print('JAXMODS', bad)\n"
            "leaked = [k for k in sys.modules if k.startswith('tpu_pathtracer')\n"
            "          and not k.startswith('tpu_pathtracer_torch')\n"
            "          and not k.startswith('tpu_pathtracer.accel')\n"
            "          and k != 'tpu_pathtracer']\n"
            "print('LEAKED', sorted(leaked))\n" % (_port_modules(),))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "JAXMODS []" in out.stdout, out.stdout
    assert "LEAKED []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", ["tpu_pathtracer_torch", "chip_smoke.py"])
def test_no_jax_import_statement(path):
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(r, f) for r, _d, fs in os.walk(full) for f in fs
        if f.endswith(".py")]
    assert files
    for f in files:
        with open(f) as fh:
            for line in fh:
                s = line.strip()
                assert not (s.startswith("import jax")
                            or s.startswith("from jax")), (f, line)
