"""Host-side scene description, meshes, cameras, procedural assets and
texture sampling (re-hosted from the JAX package, which reaches jax
through its scene package)."""
