"""The CUDA traversal kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and nvcc; they skip elsewhere. The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: hit/miss agrees on >= 0.999 of lanes, the
hit slot too for closest hit, and t within rtol 1e-5 where slots agree.
"""
import functools

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.scene import demo
from tpu_pathtracer_torch.tracer import traverse as trav
from tpu_pathtracer_torch.ops import traverse_packet as ops

torch.set_num_threads(2)
RAY_MIN, RAY_MAX = 1e-4, 1e20
N = 65536
PREFIX = 397                 # splits a warp


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@functools.lru_cache(maxsize=1)
def _testobj():
    fb = demo.testobj_scene(cache_dir=None)[0]
    return fb, trav.pack_stream(fb.prims, fb.meta)


def _rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    o[:, 1] = g.uniform(0.2, 3, n)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, g


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["prefix", "mask_lane_tmax", "anyhit"])
def test_kernel_matches_plain_on_card(device, form):
    fb, packed = _testobj()
    o, d, g = _rays(N, 7)
    packed, o, d = (torch.from_numpy(x).to(device) for x in (packed, o, d))
    act = torch.from_numpy(g.random(N) < 0.7).to(device)
    tmax = torch.full((N,), RAY_MAX, device=device)
    if form == "prefix":
        kw, mask = dict(active_prefix=PREFIX), torch.arange(
            N, device=device) < PREFIX
    elif form == "mask_lane_tmax":
        tmax = torch.from_numpy(
            g.uniform(0.5, 6.0, N).astype(np.float32)).to(device)
        kw, mask = dict(active=act), act
    else:
        kw, mask = dict(active=act, anyhit=True), act
    anyhit = kw.get("anyhit", False)
    tmax_arg = tmax if form == "mask_lane_tmax" else RAY_MAX
    sd = fb.max_depth + 2
    before = dict(ops.LAUNCHES)
    ks, kt = ops.packet_intersect(packed, o, d, RAY_MIN, tmax_arg,
                                  stack_depth=sd, **kw)
    torch.cuda.synchronize()
    name = "traverse_anyhit" if anyhit else "traverse_closest"
    assert ops.LAUNCHES[name] == before[name] + 1
    ps, pt = trav.intersect_scene(None, None, None, o, d, RAY_MIN, tmax_arg,
                                  anyhit=anyhit, stack_depth=sd, active=mask,
                                  packed=packed)
    assert ((ks >= 0) == (ps >= 0)).float().mean().item() >= 0.999
    if not anyhit:
        same = ks == ps
        assert same.float().mean().item() >= 0.999
        torch.testing.assert_close(kt[same], pt[same], rtol=1e-5, atol=0.0)
    out = ~mask
    assert (ks[out] == -1).all().item()
    assert torch.equal(kt[out], tmax[out])
