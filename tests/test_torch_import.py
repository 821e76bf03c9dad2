"""The port imports torch and never jax, and nothing of the JAX package."""
import os
import re
import subprocess
import sys

import pytest
import torch

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
              "ops.traverse_packet", "ops.dma_rows", "ops.checks",
              "ops.shade", "ops.surface_fetch", "ops.marks", "ops.image",
              "accel", "accel.bvh", "accel.flatten", "accel.cache",
              "accel.native_build", "tools.probe_steps", "tools.probe_dma",
              "utils.cuda_build", "convert", "scene.plyloader", "bssrdf",
              "bssrdf.tabulate", "bssrdf.sample", "media", "tracer.medium",
              "tracer.bssrdf_shade", "parallel", "parallel.sharding",
              "scene.hdr", "scene.objloader", "utils.timing",
              "tools.render", "utils.profiling", "tools.interactive",
              "tools.profile_frame", "tools.probe_viewer",
              "tools.showcase_1080p", "tools.gallery", "tools.sweep_frame",
              "tracer.device_loop"):
        assert "tpu_pathtracer_torch." + m in mods, m


def test_importing_every_port_module_leaves_jax_out():
    code = ("import importlib, sys\n"
            "for m in %r:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'jaxlib' or k.startswith('jaxlib.'))\n"
            "print('JAXMODS', bad)\n"
            "leaked = [k for k in sys.modules if k == 'tpu_pathtracer'\n"
            "          or k.startswith('tpu_pathtracer.')]\n"
            "print('LEAKED', sorted(leaked))\n"
            "print('PIL', 'PIL' in sys.modules)\n" % (_port_modules(),))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "JAXMODS []" in out.stdout, out.stdout
    assert "LEAKED []" in out.stdout, out.stdout
    # PIL is optional: the card's machine has none, and no module (the CLI
    # included) may need it to import
    assert "PIL False" in out.stdout, out.stdout


@pytest.mark.parametrize("path", ["tpu_pathtracer_torch", "chip_smoke.py"])
def test_no_import_of_the_jax_package(path):
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(r, f) for r, _d, fs in os.walk(full) for f in fs
        if f.endswith(".py")]
    pat = re.compile(r"^\s*(from|import)\s+tpu_pathtracer(\.|\s|$)")
    for f in files:
        with open(f) as fh:
            for line in fh:
                assert not pat.match(line), (f, line)


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


@pytest.mark.parametrize("tool,args", [
    ("render", []), ("interactive", []), ("profile_frame", []),
    ("probe_viewer", []), ("showcase_1080p", []), ("gallery", []),
    ("sweep_frame", [""])])
def test_tool_defaults_to_the_card(tool, args, monkeypatch):
    """Every CLI tool of the port runs on --device cuda unless told
    otherwise, and without a card it stops instead of falling back."""
    import importlib
    mod = importlib.import_module("tpu_pathtracer_torch.tools." + tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(args)


def test_chip_smoke_ab_mode_stops_without_the_card(monkeypatch):
    """chip_smoke.py --ab DIR (the A/B timing of a checkout) stops without
    a card instead of falling back to the CPU."""
    import importlib.util
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.measure_ab(root)
