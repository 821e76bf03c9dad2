"""Tabulated BSSRDF: the photon-beam-diffusion table (host, numpy) and its
sampling / evaluation on tensors (port of bssrdf/)."""
from .tabulate import (
    BSSRDFTable, compute_beam_diffusion_table, beam_diffusion_ms,
    beam_diffusion_ss, integrate_catmull_rom, fresnel_moment_1,
    fresnel_moment_2,
)
from .sample import (
    catmull_rom_weights, sample_catmull_rom_2d, sample_bssrdf_radius_table,
    eval_profile_table,
)
