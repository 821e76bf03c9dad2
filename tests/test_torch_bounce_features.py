"""Media, the distant light and the BSSRDF exit-point light through the
port's bounce integrator, against the JAX package's bounce integrator on
the same scenes (after tests/test_features.py:29-101; the BSSRDF profile
cases are in test_torch_bounce_bssrdf.py).

Images are held to bench.py's gate statistics (median |diff| < 1e-4, mean
within 1%, RMSE < 0.1), and to the physical checks of the JAX tests.
"""
import numpy as np
import torch

from tpu_pathtracer.tracer.renderer import Renderer as JRenderer
from tpu_pathtracer.tracer.wavefront import RenderSettings as JSettings
from tpu_pathtracer_torch.scene import demo as tdemo, procedural
from tpu_pathtracer_torch.scene.mesh import TriangleMesh
from tpu_pathtracer_torch.scene.config import (
    MatDesc, MAT_DIFF, MAT_GLASS, MAT_SUBSURFACE)
from tpu_pathtracer_torch.accel import flatten_mesh_bvh
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))


def _gate(img, want):
    d = np.abs(img - want)
    assert np.all(np.isfinite(img))
    assert float(np.median(d)) < 1e-4, np.median(d)
    assert abs(img.mean() / max(want.mean(), 1e-9) - 1.0) < 0.01
    assert float(np.sqrt((d ** 2).mean())) < 0.1


def _both(fb, mats, W, rc, spp, env_const=(0.0, 0.0, 0.0), **kw):
    """The port's and the JAX package's bounce renders, as [H,W,3]."""
    kw = dict(kw, integrator="bounce", use_envmap=False, use_texture=False)
    jr = JRenderer(fb, mats, width=W, height=W, settings=JSettings(**kw),
                   env_const=env_const)
    jbuf = jr.accum_to_buffer(np.asarray(
        jr.render_frames(jr.zeros_accum(), rc, 1, spp)) / spp)
    tr = Renderer(fb, mats, width=W, height=W, settings=RenderSettings(**kw),
                  env_const=env_const, device="cpu")
    tbuf = tr.accum_to_buffer(
        tr.render_frames(tr.zeros_accum(), rc, 1, spp).numpy() / spp)
    return tbuf, jbuf


def test_distant_light_and_shadow_bounce():
    W = 48
    plane = procedural.make_plane((0, 0, 0), 20, 20, 0)
    sphere = procedural.make_uv_sphere((0, 1.2, 0), 0.8, 1, n_lat=12,
                                       n_lon=16)
    fb = flatten_mesh_bvh(TriangleMesh.concatenate([plane, sphere]))
    mats = [MatDesc(refltype=MAT_DIFF, objcol=(0.8, 0.8, 0.8)),
            MatDesc(refltype=MAT_DIFF, objcol=(0.2, 0.2, 0.2))]
    rc = tdemo.default_camera(W, W, pitch=1.5, radius=8,
                              center=(0, 0, 0)).build_render_camera()
    tbuf, jbuf = _both(fb, mats, W, rc, 8, bounce_min=2, bounce_max=4,
                       use_distant_light=True,
                       distant_light_dir=(1.0, 1.0, 0.0),
                       distant_light_L=(2.0, 2.0, 2.0))
    _gate(tbuf, jbuf)
    lit = tbuf[6:10, W - 10:W - 6].mean()
    shadow = tbuf[W // 2 - 2:W // 2 + 2, W // 2 - 9:W // 2 - 6].mean()
    assert lit > 0.05 and lit > shadow * 1.5


def test_media_attenuates_and_scatters_bounce():
    W = 32
    fb = flatten_mesh_bvh(procedural.make_uv_sphere((0, 0.0, 0), 1.0, 0,
                                                    n_lat=12, n_lon=16))
    rc = tdemo.default_camera(W, W, pitch=0.0, radius=3.5,
                              center=(0, 0, 0)).build_render_camera()
    c = slice(W // 2 - 4, W // 2 + 4)
    clear, _ = _both(fb, [MatDesc(refltype=MAT_GLASS, etaT=1.5)], W, rc, 8,
                     env_const=(1.0, 1.0, 1.0), bounce_min=4, bounce_max=12)
    dense, jdense = _both(fb, [MatDesc(refltype=MAT_GLASS, etaT=1.5,
                                       medium="jade")], W, rc, 8,
                          env_const=(1.0, 1.0, 1.0), bounce_min=4,
                          bounce_max=12, has_media=True)
    _gate(dense, jdense)
    assert dense[c, c].mean() < clear[c, c].mean() * 0.9


def _sss_scene():
    plane = procedural.make_plane((0, -1.0, 0), 20, 20, 0)
    sphere = procedural.make_uv_sphere((0, 0.0, 0), 1.0, 1, n_lat=10,
                                       n_lon=14)
    return flatten_mesh_bvh(TriangleMesh.concatenate([plane, sphere]))


def test_bssrdf_exit_distant_light_bounce():
    W = 32
    mats = [MatDesc(refltype=MAT_DIFF, objcol=(0.6, 0.6, 0.6)),
            MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.8, 0.75, 0.7),
                    alphax=0.3, etaT=1.4, mfp=(0.3, 0.25, 0.2), ks=0.2)]
    rc = tdemo.default_camera(W, W, pitch=0.3, radius=3.5,
                              center=(0, 0, 0)).build_render_camera()
    tbuf, jbuf = _both(_sss_scene(), mats, W, rc, 8, bounce_min=3,
                       bounce_max=8, has_bssrdf=True, use_distant_light=True,
                       distant_light_dir=(0.3, 1.0, 0.4),
                       distant_light_L=(3.0, 3.0, 3.0))
    _gate(tbuf, jbuf)
    c = slice(W // 2 - 4, W // 2 + 4)
    assert tbuf[c, c].mean() > 0.005
