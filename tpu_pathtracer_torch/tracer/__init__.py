"""Traversal, shading stages, env sampling, renderer and the regen
integrator."""
