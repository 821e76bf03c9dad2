"""The port's own accel/ (SBVH build, flattening, cache, alias builder)
against the JAX package's, bit for bit.

Both packages must trace the same stream, so every array is compared
with exact equality. The Python SBVH builder is held on the small random
mesh only: on the 4.4k-triangle TestObj mesh it takes ~30 s per package.
"""
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpu_pathtracer.accel import cache as jcache
from tpu_pathtracer.accel import flatten as jflatten
from tpu_pathtracer.accel import native_build as jnative
from tpu_pathtracer.scene import procedural as jproc
from tpu_pathtracer.scene.mesh import TriangleMesh as JMesh
from tpu_pathtracer_torch.accel import cache as tcache
from tpu_pathtracer_torch.accel import flatten as tflatten
from tpu_pathtracer_torch.accel import native_build as tnative
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.scene import procedural as tproc
from tpu_pathtracer_torch.scene.mesh import TriangleMesh as TMesh
from tpu_pathtracer_torch.tracer import envsample as tenv
from test_torch_scene import jax_native_lib

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))

FIELDS = ("prims", "meta", "tri_pos", "tri_uv", "tri_nrm", "tri_mat",
          "tri_orig", "root_lo", "root_hi")


def _random_arrays(n_tri=160, seed=3):
    g = np.random.default_rng(seed)
    c = g.uniform(-2.0, 2.0, (n_tri, 1, 3))
    v = (c + g.normal(scale=0.3, size=(n_tri, 3, 3))).reshape(-1, 3)
    n = g.normal(size=(n_tri, 3, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return (v.astype(np.float32),
            np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3),
            g.uniform(0, 1, (n_tri, 3, 2)).astype(np.float32),
            n.astype(np.float32),
            g.integers(0, 4, n_tri).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _meshes(name):
    """(JAX mesh, port mesh) built from the same arrays."""
    if name == "testobj":
        return jproc.make_test_scene(), tproc.make_test_scene()
    arrays = _random_arrays()
    return JMesh(*arrays), TMesh(*(a.copy() for a in arrays))


def _same_flat(a, b):
    assert a.num_nodes == b.num_nodes
    assert a.max_depth == b.max_depth
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


@pytest.mark.parametrize("name", ["testobj", "random"])
def test_cache_key_matches_jax(name):
    jm, tm = _meshes(name)
    assert tcache.CACHE_VERSION == jcache.CACHE_VERSION == 5
    assert tm.content_hash() == jm.content_hash()
    assert tcache._cache_key(tm, None, None) == \
        jcache._cache_key(jm, None, None)


@pytest.mark.parametrize("name", ["testobj", "random"])
def test_native_build_matches_jax(name):
    jm, tm = _meshes(name)
    assert tnative.get_lib() is not None, tnative.last_error()
    jax_native_lib()
    _same_flat(tflatten.flatten_mesh_bvh(tm),
               jflatten.flatten_mesh_bvh(jm))


def test_python_build_matches_jax():
    jm, tm = _meshes("random")
    _same_flat(tflatten.flatten_mesh_bvh(tm, use_native=False),
               jflatten.flatten_mesh_bvh(jm, use_native=False))


def test_native_and_python_builders_agree():
    _, tm = _meshes("random")
    _same_flat(tflatten.flatten_mesh_bvh(tm),
               tflatten.flatten_mesh_bvh(tm, use_native=False))


def test_native_library_is_the_ports_own():
    tnative.get_lib()
    port = os.path.dirname(os.path.dirname(os.path.abspath(
        tnative.__file__)))
    assert os.path.commonpath([tnative._LIB, port]) == port
    assert tnative._LIB != jnative._LIB
    for src in tnative._SRCS:
        assert os.path.commonpath([src, port]) == port


def test_cache_files_interchange(tmp_path):
    """A cache file written by either package loads in the other, under
    the same name, with the same arrays."""
    jm, tm = _meshes("random")
    jax_native_lib()
    a = tcache.load_or_build(tm, cache_dir=str(tmp_path / "t"))
    b = jcache.load_or_build(jm, cache_dir=str(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    _same_flat(a, b)
    _same_flat(tcache.load_or_build(tm, cache_dir=str(tmp_path / "j")), b)


@pytest.mark.parametrize("python_loop", [False, True])
def test_alias_tables_match_jax(python_loop, monkeypatch):
    g = np.random.default_rng(9)
    w = g.gamma(0.5, size=5000)
    p = w / w.mean()
    jax_native_lib()
    jp, ja = jnative.alias_build_native(p)
    if python_loop:
        monkeypatch.setattr(tenv, "alias_build_native", lambda p: None)
        tp, ta = tenv._alias_table(p)
    else:
        tp, ta = tnative.alias_build_native(p)
    np.testing.assert_array_equal(np.asarray(tp, np.float32), jp)
    np.testing.assert_array_equal(np.asarray(ta, np.int32), ja)


_RACE = """
import hashlib, sys, time
start = float(sys.argv[1])
from tpu_pathtracer_torch.accel import native_build
from tpu_pathtracer_torch.scene import demo
while time.time() < start:
    pass
lib = native_build.get_lib()
fb = demo.testobj_scene(cache_dir=None)[0]
print(lib is not None, native_build.last_error(),
      hashlib.sha256(fb.prims.tobytes() + fb.meta.tobytes()).hexdigest())
"""


def test_processes_starting_together_all_load_the_native_lib(tmp_path):
    """Several processes start at one instant on a fresh copy of the port
    (no built library): each loads the library (one compiles under the
    file lock, the others wait for it and load the renamed file) and
    builds the TestObj stream this process builds."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(tnative.__file__)))
    dst = tmp_path / "tpu_pathtracer_torch"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    assert not (dst / "accel" / "native" / "_build").exists()
    fb = tdemo.testobj_scene(cache_dir=None)[0]
    want = hashlib.sha256(fb.prims.tobytes() + fb.meta.tobytes()).hexdigest()
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    start = time.time() + 8.0
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, repr(start)],
                              cwd=str(tmp_path), env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ["True", "None", want], (out, err[-2000:])
    built = sorted(os.listdir(dst / "accel" / "native" / "_build"))
    assert built == ["libsbvh.lock", "libsbvh.so"], built
