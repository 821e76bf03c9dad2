"""PyTorch / CUDA port of the wavefront path tracer.

The JAX package `tpu_pathtracer` stays the reference; this package mirrors
its module names and computes the same images with plain PyTorch tensor
code, plus hand-written CUDA kernels (under `csrc/`) where the JAX package
had a Pallas kernel. It imports `torch` and never `jax`. The one thing it
takes from the JAX package is `tpu_pathtracer.accel` (SBVH build,
flattening, content-hashed cache, alias builder: numpy + C++), so both
packages traverse the same flattened stream.

Every function takes its device from the tensors it is given; classes that
create tensors take an explicit `device=`. There is no default device and
no CPU fallback for CUDA tensors: a CUDA tensor goes to the CUDA kernel or
the call raises.
"""

__version__ = "0.1.0"
