"""Participating media, public API (port of media/).

Homogeneous medium interaction (distance sampling, Beer-Lambert
transmittance, Henyey-Greenstein phase) with the presets of the reference
recipe file (src/scenes.txt:51-55). The wave-level code lives in
tracer/medium.py; this package re-exports the user-facing pieces.
"""
from ..tracer.medium import medium_interaction
from ..materials.bsdf import henyey_greenstein_sample
from ..scene.config import MEDIUM_PRESETS
