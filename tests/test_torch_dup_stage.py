"""RenderSettings.dup_stage in the port's regen wave: every stage doubled
leaves the image's bits as they are, matches the JAX regen run with the
same hook (bench.py's gate statistics: median |diff| < 1e-4, mean within
1%, RMSE < 0.1), is ignored by the bounce integrator, and a typo raises.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
from tpu_pathtracer.tracer.regen import make_regen_integrator as j_regen
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.regen import (
    DUP_STAGES, make_regen_integrator)
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
W = 16


def _gate(img, want):
    d = np.abs(img - want)
    assert np.all(np.isfinite(img))
    assert float(np.median(d)) < 1e-4, np.median(d)
    assert abs(img.mean() / max(want.mean(), 1e-9) - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


@functools.lru_cache(maxsize=1)
def _parts():
    return tdemo.testobj_scene(cache_dir=None)


@functools.lru_cache(maxsize=1)
def _renderer():
    fb, mats, envmap, texture = _parts()
    return Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                    height=W, device="cpu")


def _render(spp=1, **kw):
    r = _renderer()
    base = r.settings
    r.settings = dataclasses.replace(base, **kw)
    try:
        rc = tdemo.default_camera(W, W).build_render_camera()
        return r.render_frames(r.zeros_accum(), rc, 1, spp)
    finally:
        r.settings = base


@functools.lru_cache(maxsize=None)
def _undoubled(extra=()):
    return _render(**dict(extra))


def test_the_ten_jax_stage_names():
    assert DUP_STAGES == ("respawn", "ext_trace", "fetch", "envmiss",
                          "texture", "shade", "sample_env", "shadow_trace",
                          "scatter", "permute")


@pytest.mark.parametrize("stage", DUP_STAGES)
def test_doubled_stage_keeps_the_image_bits(stage):
    assert torch.equal(_render(dup_stage=stage), _undoubled())


@pytest.mark.parametrize("stage,extra", [
    ("envmiss", (("merge_envtex", False),)),
    ("texture", (("merge_envtex", False),)),
    ("permute", (("regen_permute", "sort"),)),
    ("scatter", (("scatter_mode", "wave"),)),
    ("scatter", (("regen_order", "inplace"),)),
], ids=["envmiss-separate", "texture-separate", "permute-sort",
        "scatter-wave", "scatter-inplace"])
def test_doubled_stage_keeps_the_bits_on_the_other_paths(stage, extra):
    """The texture fetched in shade_hits, the env miss without the merged
    gather, the sort permute, the per-wave flush and the inplace order."""
    assert torch.equal(_render(dup_stage=stage, **dict(extra)),
                       _undoubled(extra))


def test_doubled_stage_doubles_the_work():
    """ext_trace and shadow_trace launch each traversal twice: the CPU
    path goes through packet_intersect's plain version, so count calls."""
    from tpu_pathtracer_torch.ops import traverse_packet as tp
    orig, calls = tp.packet_intersect, []

    def counting(*a, **k):
        calls.append(k.get("anyhit", False))
        return orig(*a, **k)
    tp.packet_intersect = counting
    try:
        counts = {}
        for stage in ("", "ext_trace", "shadow_trace"):
            calls.clear()
            _render(dup_stage=stage)
            counts[stage] = (calls.count(False), calls.count(True))
    finally:
        tp.packet_intersect = orig
    closest, anyhit = counts[""]
    assert counts["ext_trace"] == (2 * closest, anyhit)
    assert counts["shadow_trace"] == (closest, 2 * anyhit)


@pytest.mark.parametrize("stage", ["shade", "scatter"])
def test_doubled_stage_matches_jax_with_the_same_hook(stage):
    fb, mats, envmap, texture = _parts()
    jr = JRenderer(fb, mats, envmap=envmap, texture=texture, width=W,
                   height=W)
    rc = tdemo.default_camera(W, W).build_render_camera()
    st = dataclasses.replace(jr.settings, dup_stage=stage)
    fn = jax.jit(j_regen(st, W, W), static_argnames=("n_frames",))
    jacc, _ = fn(jr.scene, jnp.asarray(rc.as_array()), jnp.uint32(1),
                 jnp.uint32(0), jr.zeros_accum(), n_frames=1)
    tacc = _render(dup_stage=stage)
    _gate(_renderer().accum_to_buffer(tacc),
          jr.accum_to_buffer(np.asarray(jacc)))


def test_bounce_ignores_dup_stage():
    a = _render(integrator="bounce")
    b = _render(integrator="bounce", dup_stage="shade")
    assert torch.equal(a, b)


@pytest.mark.parametrize("stage", ["shading", "Shade", "all"])
def test_unknown_stage_raises(stage):
    with pytest.raises(ValueError, match="dup_stage"):
        make_regen_integrator(RenderSettings(dup_stage=stage), 8, 8)
