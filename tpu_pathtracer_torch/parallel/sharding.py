"""Lane sharding: split a render's lanes over devices (port of
parallel/sharding.py).

Every path is independent, so a render shards over the lane axis: shard i
owns the contiguous lanes [i*chunk, (i+1)*chunk) and runs its own regen
pool, or its own bounce loop, with lane0 = i*chunk on its own device. The
RNG is counted per (frame, global pixel), so every sample value is the
single-device render's; no collective runs during a frame.

The JAX package runs the shards as one program under shard_map
(tpu_pathtracer/parallel/sharding.py:96-112). Here every shard is a render
call in flight on its own device (tracer/device_loop.run_calls): the host
starts every shard's call and launches each device's first steps before
it waits on any status, then steps the devices in turn, each on its own
stream and status ring, and a finished shard drops out. The image is
assembled on the first device of the mesh once every shard has ended,
the copies enqueued without blocking. This holds for both integrators.

A mesh may name one device more than once: that is how one card runs
several shards. Shards that name the same device share that device's
captured steps (the Renderer's integrator for the same scene tensors and
width, with lane0 a device input of each call) and so run one after
another on its stream. There is no multi-process (torch.distributed)
layer, as the JAX package has none.
"""
from __future__ import annotations

import torch

from ..tracer.device_loop import run_calls
from ..tracer.renderer import camera_vector


def make_mesh(devices=None):
    """The devices to shard over, as a tuple of torch.device: `devices`
    (names or torch.device, repeats allowed), or by default every CUDA
    device; raises when there is none."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "explicitly (e.g. ['cpu', 'cpu'])")
        devices = ["cuda:%d" % i for i in range(n)]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_mesh: empty device list")
    return mesh


def _scene_on(scene, device):
    """The scene dict with every tensor on `device` (the same objects when
    they lie there already)."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in scene.items()}


class ShardedRenderer:
    """Runs a Renderer's progressive frames sharded over a mesh of devices
    (make_mesh's list; None: every CUDA device).

    The lane count is padded to a multiple of the shard count; zeros_accum
    gives an [n_lanes,3] buffer on the mesh's first device and
    render_frame / render_frames / accum_to_image / accum_to_buffer mirror
    the Renderer's API (rows past width*height are padding)."""

    def __init__(self, renderer, mesh=None):
        self.base = renderer
        self.devices = make_mesh(mesh)
        n_dev = len(self.devices)
        n = renderer.width * renderer.height
        self.n_lanes = -(-n // n_dev) * n_dev
        self.chunk = self.n_lanes // n_dev
        self._scenes = {}
        for d in self.devices:
            if d not in self._scenes:
                self._scenes[d] = _scene_on(renderer.scene, d)

    def zeros_accum(self):
        return torch.zeros((self.n_lanes, 3), dtype=torch.float32,
                           device=self.devices[0])

    def render_frame(self, accum, camera, frame_number: int):
        return self.render_frames(accum, camera, frame_number, 1)

    def render_frames(self, accum, camera, frame_start: int, n_frames: int,
                      with_stats=False):
        """Accumulate n_frames samples (frame numbers frame_start ..
        frame_start + n_frames - 1), every shard in flight at once.
        with_stats=True returns (accum, waves, traced_rays) summed over the
        shards."""
        cam_vecs = {d: camera_vector(camera, d) for d in self._scenes}
        calls = []
        for i, dev in enumerate(self.devices):
            lane0 = i * self.chunk
            sl = accum[lane0:lane0 + self.chunk].to(dev, non_blocking=True)
            calls.append((dev, self.base.chunk_call(
                self._scenes[dev], cam_vecs[dev], frame_start, lane0, sl,
                n_frames, with_stats)))
        outs = run_calls(calls)
        out = torch.cat([acc.to(accum.device, non_blocking=True)
                         for acc, _, _ in outs])
        if not with_stats:
            return out
        return (out, sum(int(w) for _, w, _ in outs),
                sum(float(r) for _, _, r in outs))

    def accum_to_image(self, accum, frame_count, repeat=1):
        return self.base.accum_to_image(accum, frame_count, repeat)

    def accum_to_buffer(self, accum):
        return self.base.accum_to_buffer(accum)
