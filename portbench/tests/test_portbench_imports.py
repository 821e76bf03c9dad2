"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their whole top-level name: `tpu_pathtracer_torch` is not `tpu_pathtracer`."""
import ast
import glob
import os
import subprocess
import sys

from pb_helpers import ROOT

PROBE = """
import sys
{imports}
print(",".join(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level_after(imports):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(imports=imports)], cwd=ROOT,
        capture_output=True, text=True, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(out.stdout.strip().split(","))


def test_harness_and_port_load_no_jax():
    mods = _top_level_after(
        "import portbench.run, portbench.control, portbench.program\n"
        "import portbench.drivers.cli_loop, portbench.drivers.viewer_drag\n"
        "import tpu_pathtracer_torch.tracer.renderer\n"
        "import tpu_pathtracer_torch.tools.interactive\n"
        "from portbench.run import read_metric\n"
        "import glob, os\n"
        "for p in glob.glob('portbench/metrics/[!_]*.py'):\n"
        "    read_metric(os.path.basename(p)[:-3], {})\n")
    assert "tpu_pathtracer_torch" in mods and "portbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "tpu_pathtracer"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_after("import portbench.reference.render\n"
                            "import portbench.reference.accel\n")
    assert not mods & {"tpu_pathtracer_torch", "tpu_pathtracer", "jax",
                       "jaxlib", "flax"}


def test_reference_sources_import_only_torch_and_numpy():
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference",
                                       "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("numpy", "torch", "math",
                                           "__future__"), (path, n)


def test_forbidden_modules_by_whole_name(monkeypatch):
    from portbench.run import forbidden_modules
    base = set(forbidden_modules())
    for name in ("tpu_pathtracer_torch_x", "jaxfoo.core", "flax.core"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(forbidden_modules()) - base == {"flax"}
