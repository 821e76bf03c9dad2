"""Argument checks that the kernel wrappers share."""
from __future__ import annotations

import torch


def require(t, name, device, dtype, shape):
    """Raise unless t is a contiguous tensor of this device, dtype and
    shape (the kernels take no other)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError("%s must be a tensor" % name)
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (name, t.dtype,
                                                            dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
