"""Build the port's CUDA sources with nvcc at first use and load them.

Each `csrc/<name>.cu` is compiled on its own into a shared library with a
plain C interface (`-shared -Xcompiler -fPIC`), loaded through ctypes. The
library of a source goes into `csrc/_build/<name>-<hash>/`, keyed by a hash
of the source and the flags, so an edited source builds anew and an
unchanged one loads at once.
Several sources build in parallel, one nvcc process each.

Flags: `-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false`. No fast
math: the kernels must give the bits of their plain PyTorch versions. A
missing nvcc or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_ROOT = os.path.join(CSRC, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def lib_path(name):
    """Where the library of csrc/<name>.cu is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, "%s-%s" % (name, h.hexdigest()[:16]),
                        "lib%s.so" % name)


class KernelLibs:
    """The built libraries of a set of sources: `libs[name]` is the ctypes
    handle of `csrc/<name>.cu`, `logs[name]` what nvcc printed for it
    (ptxas register and spill counts). Building happens in `__init__`."""

    def __init__(self, names):
        self.names = tuple(names)
        self.paths = {n: lib_path(n) for n in self.names}
        self.logs = {}
        todo = [n for n in self.names if not os.path.exists(self.paths[n])]
        if todo:
            self._build(todo)
        self.libs = {n: ctypes.CDLL(self.paths[n]) for n in self.names}

    def _build(self, names):
        nvcc = find_nvcc()
        procs = {}
        for name in names:
            out_dir = os.path.dirname(self.paths[name])
            os.makedirs(out_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, os.path.join(CSRC, name + ".cu"),
                   "-o", tmp]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            self.logs[name] = out
            if proc.returncode != 0:
                failed.append("%s (exit %d):\n%s" % (name, proc.returncode,
                                                      out))
                os.unlink(tmp)
            else:
                os.replace(tmp, self.paths[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))


_LOADED = {}


def load(name):
    """ctypes handle of csrc/<name>.cu, built at first use in this process."""
    if name not in _LOADED:
        _LOADED[name] = KernelLibs([name]).libs[name]
    return _LOADED[name]
