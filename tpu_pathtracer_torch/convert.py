"""Carry scene state from the JAX package into the port.

`scene_from_jax` takes the JAX `Renderer.scene` dict, each entry an array
(numpy, or anything `np.asarray` reads, such as a JAX array) or a Python
scalar, and returns the port's scene dict on `device`: arrays become
tensors of the same dtype and bits, scalars stay Python scalars. The port's
own `Renderer` builds its scene dict the same way from host arrays, so the
two can be compared entry by entry.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(host_scene, device):
    """Host scene dict (arrays / Python scalars) -> tensors on `device`."""
    out = {}
    for k, v in host_scene.items():
        if isinstance(v, (bool, int, float)):
            out[k] = v
        else:
            a = np.ascontiguousarray(np.asarray(v))
            out[k] = torch.from_numpy(a.copy()).to(device)
    return out


def scene_from_jax(scene, device):
    """The JAX package's Renderer.scene as the port's scene dict."""
    return to_device(scene, device)
