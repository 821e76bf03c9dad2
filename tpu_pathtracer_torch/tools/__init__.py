"""Measurement tools of the port (ports of the JAX package's tools/probe_*),
each run as `python -m tpu_pathtracer_torch.tools.<name>`."""
