"""Homogeneous participating media in the wave loop (port of
tracer/medium.py).

A ray inside a medium (tracked per lane by the id of the material it
refracted into) samples a distance each wave, channel-stratified; if the
distance is shorter than the surface hit it scatters by Henyey-Greenstein,
otherwise it transmits to the surface. The numerics follow the reference's
HomogeneousMedium (src/reflection.cuh:152-197): Beer-Lambert
transmittance, density-averaged pdf with the < 1e-4 guard, and sigmaS/pdf
weighting.
"""
from __future__ import annotations

import torch

from ..core.rng import RaySampler
from ..core.vecmath import channel_select
from ..materials.bsdf import henyey_greenstein_sample


def medium_interaction(scene, rng, orig, raydir, mask, hit_t, medium_id,
                       active):
    """Returns (rng, orig, raydir, mask, sampled_medium); four RNG draws per
    lane.

    Lanes not inside a medium pass through unchanged. Lanes that scatter
    get a new origin (the scatter point) and an HG direction; the caller
    ignores their surface hit of this wave. Lanes that transmit keep their
    ray and their mask picks up Tr/pdf."""
    from .wavefront import gather_material
    in_medium = active & (medium_id >= 0)
    rng, (r1, r2, r3, r4) = RaySampler.next_n(rng, 4)

    med = gather_material(scene, torch.clamp_min(medium_id, 0))
    sigma_s = med["med_sigma_s"]
    sigma_a = med["med_sigma_a"]
    g = med["med_g"]
    sigma_t = sigma_s + sigma_a

    # sample a channel (src/reflection.cuh:169)
    ch = torch.clamp((r1 * 3.0).to(torch.int32), 0, 2)
    st_ch = torch.clamp_min(channel_select(sigma_t, ch), 1e-12)

    dist = -torch.log(torch.clamp_min(1.0 - r2, 1e-12)) / st_ch
    sampled = in_medium & (dist < hit_t)
    t = torch.clamp_max(torch.where(sampled, dist, hit_t), 1e20)

    Tr = torch.exp(-sigma_t * t[:, None])
    density = torch.where(sampled[:, None], sigma_t * Tr, Tr)
    pdf = (density[:, 0] + density[:, 1] + density[:, 2]) / 3.0
    pdf = torch.where(pdf < 1e-4, 1.0, pdf)
    weight = torch.where(sampled[:, None], Tr * sigma_s, Tr) / pdf[:, None]
    mask = torch.where(in_medium[:, None], mask * weight, mask)

    scatter_point = orig + t[:, None] * raydir
    hg_dir = henyey_greenstein_sample(r3, r4, g, raydir)
    orig = torch.where(sampled[:, None], scatter_point, orig)
    raydir = torch.where(sampled[:, None], hg_dir, raydir)
    return rng, orig, raydir, mask, sampled
