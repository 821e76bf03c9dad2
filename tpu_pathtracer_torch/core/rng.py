"""Per-lane PCG sampler, bit-exact with `tpu_pathtracer.core.rng`.

The JAX package carries the state as uint32. PyTorch on the CPU cannot
shift, add, take a remainder or floor-divide uint32 tensors, so the port
carries every 32-bit quantity in an int64 tensor masked with 0xFFFFFFFF
after each step that could carry past bit 31, on every device. Products
stay below 2^63 (a 32-bit value times a constant below 2^30), so the int64
arithmetic followed by the mask equals the uint32 arithmetic exactly.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def as_u32(x, device=None):
    """A uint32 quantity as an int64 tensor in [0, 2^32)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK32


def wang_hash(x):
    """Wang integer hash (reference src/Util.cpp:4-12), bit for bit."""
    x = as_u32(x)
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & MASK32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & MASK32
    x = x ^ (x >> 15)
    return x


def _permute(state):
    """PCG xsh-rr output permutation of a masked state."""
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def pcg_hash(x):
    """One LCG step plus the PCG output permutation."""
    state = (as_u32(x) * 747796405 + 2891336453) & MASK32
    return _permute(state)


def _to_unit_float(bits):
    # the top 24 bits as an exact f32 integer, scaled into [0, 1)
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


class RaySampler:
    """Per-lane uniform sampler over int64-carried uint32 states."""

    @staticmethod
    def init(frame_hash, lane_ids):
        """Seed state; analog of curand_init(hashedframe + threadId)."""
        lane_ids = as_u32(lane_ids)
        return pcg_hash(as_u32(frame_hash, lane_ids.device) + lane_ids)

    @staticmethod
    def next(state):
        new_state = (state * 747796405 + 2891336453) & MASK32
        return new_state, _to_unit_float(_permute(new_state))

    @staticmethod
    def next_n(state, n):
        outs = []
        for _ in range(n):
            state, u = RaySampler.next(state)
            outs.append(u)
        return state, outs
