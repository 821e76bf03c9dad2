"""Inputs of the surface BSDF draw (`tpu_pathtracer_torch/ops/shade.py`)
that take every branch of it, made from a numpy seed: shared by
tests/test_torch_shade_kernel.py, tests/test_torch_cuda.py and
chip_smoke.py phase 12 (which puts this directory on sys.path). It
imports no jax.
"""
import numpy as np
import torch

from tpu_pathtracer_torch.core.vecmath import dot
from tpu_pathtracer_torch.ops.shade import shade_plain
from tpu_pathtracer_torch.scene.config import (
    MatDesc, materials_to_arrays, MAT_DIFF, MAT_EMIT, MAT_GLASS, MAT_REFL,
    MAT_DIFF_REFL, MAT_FRESNEL, MAT_NULL, MAT_SUBSURFACE,
)
from tpu_pathtracer_torch.tracer.wavefront import (
    pack_mat_table, gather_material,
)


def mixed_materials():
    """Materials that take every branch of shade: each refltype, the
    mirror and GGX (isotropic and anisotropic) reflections, smooth and
    rough glass, diffuse+specular, the Fresnel blend (also at an alpha
    whose square the clamp raises), rough and smooth subsurface, a
    textured diffuse and a diffuse with a rough alpha (its ss_normal is a
    GGX draw)."""
    return [
        MatDesc(refltype=MAT_DIFF),
        MatDesc(refltype=MAT_DIFF, useTexture=True),
        MatDesc(refltype=MAT_DIFF, alphax=0.05, alphay=0.05, kd=0.7),
        MatDesc(refltype=MAT_EMIT, emit=(4.0, 3.0, 2.0)),
        MatDesc(refltype=MAT_GLASS),
        MatDesc(refltype=MAT_GLASS, alphax=0.15, etaT=1.5),
        MatDesc(refltype=MAT_REFL),
        MatDesc(refltype=MAT_REFL, alphax=0.2, alphay=0.2),
        MatDesc(refltype=MAT_REFL, alphax=0.3, alphay=0.1),
        MatDesc(refltype=MAT_DIFF_REFL, alphax=0.2, alphay=0.2, kd=0.6,
                ks=0.4),
        MatDesc(refltype=MAT_DIFF_REFL, kd=0.5, ks=0.5),
        MatDesc(refltype=MAT_DIFF_REFL, alphax=0.25, alphay=0.05, kd=0.3,
                ks=0.7),
        MatDesc(refltype=MAT_FRESNEL, alphax=0.1, alphay=0.1, kd=5.0),
        MatDesc(refltype=MAT_FRESNEL, alphax=1e-7, kd=0.5),
        MatDesc(refltype=MAT_NULL),
        MatDesc(refltype=MAT_SUBSURFACE, alphax=0.3, etaT=1.4, ks=0.2),
        MatDesc(refltype=MAT_SUBSURFACE, etaT=1.3, ks=0.5),
    ]


def mixed_inputs(N, seed, device, miss_share=0.05):
    """Inputs of shade at N lanes from a numpy seed: unit ray directions
    and normals, every material of mixed_materials (and a few ids out of
    range, which read the zero row) in random order, a random objcol with
    the texture where the material asks for it, random RNG states; a
    share of lanes are misses whose normals are NaN, as the regen pool's
    miss lanes carry. Returns (scene, (rng, raydir, n, nl, into, mat,
    objcol), mat_id, surf): scene holds only "mat_table"; mat is
    gather_material's columns of mat_id; surf marks the lanes that are not
    misses."""
    g = np.random.default_rng(seed)

    def unit(k):
        v = g.normal(size=(k, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    table = pack_mat_table(materials_to_arrays(mixed_materials()))
    M = table.shape[0]
    raydir, n = unit(N), unit(N)
    miss = g.random(N) < miss_share
    n[miss] = np.nan
    mat_id = g.integers(-1, M + 1, N).astype(np.int32)
    tex = g.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    state = g.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.int64)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in (("raydir", raydir), ("n", n), ("mat_id", mat_id),
                      ("tex", tex), ("rng", state), ("surf", ~miss))}
    scene = {"mat_table": torch.from_numpy(table).to(device)}
    mat = gather_material(scene, t["mat_id"])
    objcol = torch.where((mat["useTexture"] != 0)[:, None], t["tex"],
                         mat["objcol"])
    into = dot(t["n"], t["raydir"]) < 0.0
    nl = torch.where(into[:, None], t["n"], -t["n"])
    return (scene, (t["rng"], t["raydir"], t["n"], nl, into, mat, objcol),
            t["mat_id"], t["surf"])


def kernel_args(args, mat_id):
    """shade's positional inputs after (scene, settings) as the kernel
    takes them (ops/shade.py: shade_cuda, launch_fn): mat replaced by
    mat_id."""
    rng, raydir, n, nl, into, _, objcol = args
    return rng, raydir, n, nl, into, mat_id, objcol


def plain_shade(*args, mat_id=None):
    """ops/shade.py's shade_plain with shade's signature (the mat_id it
    does not need dropped): what a test puts in tracer.wavefront.shade's
    place to render with the plain version on the card."""
    return shade_plain(*args)
