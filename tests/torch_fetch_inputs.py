"""Inputs of the surface fetches (`tpu_pathtracer_torch/ops/
surface_fetch.py`: fetch_attributes, env_tex_merged, texture_radiance),
made from a numpy seed: shared by tests/test_torch_surface_fetch.py,
tests/test_torch_cuda.py and chip_smoke.py phase 13 (which puts this
directory on sys.path). It imports no jax.
"""
import numpy as np
import torch

from tpu_pathtracer_torch.ops import surface_fetch

# directions where the lat-long mapping has its edges: the poles, the
# seam of atan2 (x = -0 and x = +0 behind the viewer), the axes
EDGE_DIRS = np.array([
    [0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
    [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [-0.0, 0.0, -1.0],
    [-1e-8, 0.0, -1.0], [1e-8, 0.0, -1.0], [0.0, 0.0, 0.0]], np.float32)
# uv values at the texture's edges and beyond it, for hit lanes
EDGE_UV = np.array([0.0, -0.0, 1.0, -1.0, 1e-9, -1e-9, 0.5, 2.75, -3.25,
                    1e7, -1e7], np.float32)


def fetch_inputs(scene, N, seed, device, miss_share=0.4):
    """(hit_slot [N] int32, hitpoint [N,3] f32) over scene["tri_attr"]:
    a share of lanes are misses (slot -1) whose hit point is non-finite
    (inf, NaN or the point at t = 1e20, as a miss carries); every other
    lane hits a random row at a random point of its triangle, nudged off
    its plane; the first lanes hit one row of each material id the table
    holds."""
    g = np.random.default_rng(seed)
    attr = scene["tri_attr"].cpu().numpy()
    K = attr.shape[0]
    slot = g.integers(0, K, N).astype(np.int32)
    ids = attr[:, 24].view(np.int32)
    firsts = np.unique(ids, return_index=True)[1][:N]
    slot[:firsts.size] = firsts
    b = g.random((N, 3)).astype(np.float32) + 1e-3
    b /= b.sum(axis=1, keepdims=True)
    p = attr[slot, 0:9].reshape(N, 3, 3)
    hp = (b[:, :, None] * p).sum(axis=1)
    hp += g.normal(0.0, 1e-4, (N, 3)).astype(np.float32)
    miss = g.random(N) < miss_share
    miss[:firsts.size] = False
    slot[miss] = -1
    kinds = g.integers(0, 3, N)
    far = g.uniform(-1.0, 1.0, (N, 3)).astype(np.float32) * 1e20
    hp = np.where((miss & (kinds == 0))[:, None], np.inf, hp)
    hp = np.where((miss & (kinds == 1))[:, None], np.nan, hp)
    hp = np.where((miss & (kinds == 2))[:, None], far, hp)
    return (torch.from_numpy(slot).to(device),
            torch.from_numpy(np.ascontiguousarray(hp, np.float32))
            .to(device))


def envtex_inputs(scene, N, seed, device, miss_share=0.4, rotation=0.3):
    """(raydir, bsdf_pdf, env_rotation, miss, hit_uv) of env_tex_merged at N
    lanes: unit directions (the EDGE_DIRS first), bsdf_pdf < 0 on ~30% of
    lanes and 0 on some, env_rotation a 0-d f32 tensor; miss marks the
    slot -1 lanes of fetch_inputs, and hit_uv is the plain fetch's uv of
    those lanes (non-finite on the misses), with EDGE_UV and far values
    on some hit lanes."""
    g = np.random.default_rng(seed + 1)
    d = g.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    k = min(N, EDGE_DIRS.shape[0])
    d[:k] = EDGE_DIRS[:k]
    pdf = g.uniform(0.0, 2.0, N).astype(np.float32)
    pdf[g.random(N) < 0.3] = -1.0
    pdf[g.random(N) < 0.02] = 0.0
    slot, hp = fetch_inputs(scene, N, seed, device, miss_share)
    hit_uv = surface_fetch.fetch_attributes_plain(scene, slot, hp)[0] \
        .cpu().numpy()
    miss = slot.cpu().numpy() < 0
    edge = ~miss & (g.random(N) < 0.05)
    hit_uv[edge] = g.choice(EDGE_UV, (int(edge.sum()), 2))
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (d, pdf, miss, hit_uv)]
    rot = torch.tensor(rotation, dtype=torch.float32, device=device)
    return t[0], t[1], rot, t[2], t[3]


def kernel_inputs(name, scene, N, seed, device):
    """The inputs of surface fetch `name` after the scene, as its *_cuda
    wrapper and launch_fn take them (env_tex_merged's without settings)."""
    if name == "fetch_attributes":
        return fetch_inputs(scene, N, seed, device)
    raydir, pdf, rot, miss, uv = envtex_inputs(scene, N, seed, device)
    return (uv,) if name == "texture_radiance" else (raydir, pdf, rot, miss,
                                                     uv)


def run_plain(name, scene, *inputs):
    """The plain version of `name` on kernel_inputs' inputs; its outputs as
    a tuple."""
    plain = plain_fetch(name)
    out = plain(scene, None, *inputs) if name == "env_tex_merged" \
        else plain(scene, *inputs)
    return out if isinstance(out, tuple) else (out,)


def differing_lanes(got, want):
    """Lanes where two outputs of one shape and dtype differ in any bit,
    a NaN equal to any NaN (as a bool [N])."""
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    if got.dtype == torch.float32:
        differ = (got.view(torch.int32) != want.view(torch.int32)) \
            & ~(torch.isnan(got) & torch.isnan(want))
    else:
        differ = got != want
    return differ.any(-1) if differ.dim() == 2 else differ


def plain_fetch(name):
    """ops/surface_fetch.py's plain version of the stage `name`, which has
    its dispatcher's signature: what a test or chip_smoke.py puts in the
    place of that name in tracer.wavefront (and tracer.regen, which
    imports it) to render with the plain version on the card."""
    return getattr(surface_fetch, name + "_plain")
