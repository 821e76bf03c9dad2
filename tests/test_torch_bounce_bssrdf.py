"""BSSRDF through the port's bounce integrator, both profile paths (sum of
exponentials and the tabulated photon-beam-diffusion table), against the
JAX package's bounce integrator on the same scene (after
tests/test_features.py:76-98). Images are held to bench.py's gate
statistics (median |diff| < 1e-4, mean within 1%, RMSE < 0.1).
"""
import pytest
import torch

from test_torch_bounce_features import _both, _gate, _sss_scene
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.scene.config import (
    MatDesc, MAT_DIFF, MAT_SUBSURFACE)

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))


@pytest.mark.parametrize("use_soe", [True, False])
def test_bssrdf_bounce_matches_jax(use_soe):
    W = 32
    mats = [MatDesc(refltype=MAT_DIFF, objcol=(0.5, 0.5, 0.5)),
            MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.8, 0.75, 0.7),
                    alphax=0.3, etaT=1.4, mfp=(0.3, 0.25, 0.2), ks=0.2)]
    rc = tdemo.default_camera(W, W, pitch=0.15, radius=3.5,
                              center=(0, 0, 0)).build_render_camera()
    tbuf, jbuf = _both(_sss_scene(), mats, W, rc, 4,
                       env_const=(1.0, 1.0, 1.0), bounce_min=3,
                       bounce_max=10, has_bssrdf=True,
                       bssrdf_use_soe=use_soe)
    _gate(tbuf, jbuf)
    c = slice(W // 2 - 4, W // 2 + 4)
    assert 0.02 < tbuf[c, c].mean() < 3.0
