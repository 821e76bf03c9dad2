"""Lane sharding (parallel/sharding.py) on CPU devices, after
tests/test_parallel.py:23-178.

A mesh names devices, a device more than once when one device runs several
shards; here every shard runs on the CPU. Each shard renders its own lane
range with lane0 = its offset, and the RNG is counted per (frame, global
pixel), so the bounce integrator gives the single-device image bit for
bit. The regen pools add each pixel's paths in another order, so regen is
held to rtol 1e-5, atol 2e-5 as in the JAX tests; with one frame a pixel
gets one addition, and two shards equal the whole render bit for bit.
Calls step in turn (tracer/device_loop.run_calls), which keeps the
shards of different devices in flight together: a case with stub calls
shows the order of its launches and status reads.
"""
import functools

import numpy as np
import pytest
import torch

from tpu_pathtracer_torch.scene import demo as tdemo, procedural
from tpu_pathtracer_torch.scene.config import (
    MatDesc, MAT_DIFF, MAT_GLASS, MAT_REFL, MAT_SUBSURFACE)
from tpu_pathtracer_torch.accel import flatten_mesh_bvh
from tpu_pathtracer_torch.tracer import device_loop
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
from tpu_pathtracer_torch.parallel import ShardedRenderer, make_mesh

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))

W = 32
SURFACE = [MatDesc(refltype=MAT_DIFF), MatDesc(refltype=MAT_DIFF),
           MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)]
CASES = {
    "bounce": (SURFACE, dict(integrator="bounce")),
    "regen": (SURFACE, {}),
    "media": ([MatDesc(refltype=MAT_DIFF), MatDesc(refltype=MAT_DIFF),
               MatDesc(refltype=MAT_GLASS, medium="jade"),
               MatDesc(refltype=MAT_REFL)], dict(has_media=True)),
    "subsurface": ([MatDesc(refltype=MAT_DIFF),
                    MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.83, 0.79,
                                                             0.75),
                            alphax=0.3, etaT=1.4, mfp=(0.35, 0.3, 0.25),
                            ks=0.2),
                    MatDesc(refltype=MAT_GLASS), MatDesc(refltype=MAT_REFL)],
                   dict(has_bssrdf=True)),
    "capped_pool": (SURFACE, dict(pool_lanes=128)),
}


@functools.lru_cache(maxsize=1)
def _scene():
    return (flatten_mesh_bvh(procedural.make_test_scene()),
            procedural.make_sky_envmap(64, 32))


@functools.lru_cache(maxsize=None)
def _renderer(case):
    mats, kw = CASES[case]
    fb, env = _scene()
    return Renderer(fb, mats, envmap=env, width=W, height=W,
                    settings=RenderSettings(use_envmap=True,
                                            use_texture=False, **kw),
                    device="cpu")


@functools.lru_cache(maxsize=None)
def _single(case):
    r = _renderer(case)
    rc = tdemo.default_camera(W, W).build_render_camera()
    return r.render_frames(r.zeros_accum(), rc, 1, 1).numpy()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_shards_match_the_single_device_render(case, n_shards):
    r = _renderer(case)
    rc = tdemo.default_camera(W, W).build_render_camera()
    sr = ShardedRenderer(r, mesh=make_mesh(["cpu"] * n_shards))
    assert sr.n_lanes % n_shards == 0 and sr.n_lanes >= W * W
    acc = sr.render_frames(sr.zeros_accum(), rc, 1, 1)
    assert acc.shape == (sr.n_lanes, 3)
    got = acc.numpy()[:W * W]
    if case == "bounce":
        np.testing.assert_array_equal(got, _single(case))
    else:
        np.testing.assert_allclose(got, _single(case), rtol=1e-5, atol=2e-5)


def test_shards_of_an_uneven_lane_count():
    """3 shards of 1,024 lanes: the lane count is padded to 1,026, and the
    padding lanes leave the image alone."""
    r = _renderer("bounce")
    rc = tdemo.default_camera(W, W).build_render_camera()
    sr = ShardedRenderer(r, mesh=make_mesh(["cpu"] * 3))
    assert sr.n_lanes == 1026 and sr.chunk == 342
    acc, bounces, rays = sr.render_frames(sr.zeros_accum(), rc, 1, 1,
                                          with_stats=True)
    np.testing.assert_array_equal(acc.numpy()[:W * W], _single("bounce"))
    assert bounces > 0 and rays >= sr.n_lanes
    np.testing.assert_array_equal(sr.accum_to_buffer(acc),
                                  r.accum_to_buffer(_single("bounce")))


def test_make_mesh():
    mesh = make_mesh(["cpu", torch.device("cpu")])
    assert mesh == (torch.device("cpu"), torch.device("cpu"))
    with pytest.raises(ValueError):
        make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()


@pytest.mark.parametrize("variant", ["default", "media", "subsurface"])
def test_dryrun_multichip_cycle(variant):
    """__graft_entry__.dryrun_multichip in the port: each workload class
    (surface, media, subsurface) of the demo scene renders one sharded
    frame over 4 devices, finite and not black."""
    fb, mats, envmap, texture = tdemo.testobj_scene(cache_dir=None,
                                                    variant=variant)
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=W, device="cpu")
    sr = ShardedRenderer(r, mesh=make_mesh(["cpu"] * 4))
    rc = tdemo.default_camera(W, W).build_render_camera()
    img = sr.render_frame(sr.zeros_accum(), rc, 1).numpy()
    assert np.all(np.isfinite(img))
    assert img.shape[0] >= W * W
    assert float(img.mean()) > 0.0


@pytest.mark.parametrize("case", ["regen", "bounce"])
def test_two_shards_on_one_device_equal_the_whole_render(case):
    """Shards that name one device run one after another on its captured
    steps; each sample is the whole render's, and with one frame every
    pixel gets one addition, so both integrators match bit for bit."""
    r = _renderer(case)
    rc = tdemo.default_camera(W, W).build_render_camera()
    sr = ShardedRenderer(r, mesh=make_mesh(["cpu", "cpu"]))
    acc, waves, rays = sr.render_frames(sr.zeros_accum(), rc, 1, 1,
                                        with_stats=True)
    np.testing.assert_array_equal(acc.numpy()[:W * W], _single(case))
    want, w_waves, w_rays = r.render_frames(r.zeros_accum(), rc, 1, 1,
                                            with_stats=True)
    assert rays == w_rays and waves >= w_waves > 0


class _StubRing:
    """A status ring whose reads and posts are logged as (kind, shard,
    step); post keeps the status as it stands, read returns it."""

    def __init__(self, shard, log):
        self.shard, self.log, self.slots = shard, log, {}

    def reset(self):
        pass

    def post(self, i, status):
        self.slots[i] = status.tolist()

    def read(self, i):
        self.log.append(("read", self.shard, i))
        return self.slots[i]


def _stub_call(shard, n_steps, log):
    """A call whose k-th step (from 0) writes the status [done after
    n_steps, ...]; returns (shard, steps launched)."""
    status = torch.zeros(3, dtype=torch.int64)
    ring = _StubRing(shard, log)
    count = [0]

    def launch(seen):
        log.append(("launch", shard, count[0]))
        count[0] += 1
        status[0] = int(count[0] >= n_steps)
        status[1] = count[0]
    launched = yield from device_loop.drive(launch, status, ring)
    return shard, launched, count[0]


def test_run_calls_keeps_every_shard_in_flight():
    """run_calls starts every device's call and launches each one's first
    LAG steps before it waits on any status, then steps the devices in
    turn; a finished call drops out and the other runs on."""
    log = []
    calls = [(torch.device("cpu", 0), _stub_call(0, 5, log)),
             (torch.device("cpu", 1), _stub_call(1, 2, log))]
    res = device_loop.run_calls(calls)
    lag = device_loop.LAG
    # each call launches its steps until a status LAG old reads done
    assert res == [(0, 5 + lag - 1, 5 + lag - 1), (1, 2 + lag - 1,
                                                    2 + lag - 1)]
    first_read = log.index(("read", 0, 0))
    for shard in (0, 1):
        for k in range(lag):
            assert log.index(("launch", shard, k)) < first_read
    assert log.index(("launch", 1, 0)) < log.index(("launch", 0, 1))
    # shard 1 dropped out; shard 0 ran on alone
    assert log[-1] == ("read", 0, 5 - 1)
    # calls on one device run one after another, in order
    log2 = []
    same = [(torch.device("cpu"), _stub_call(k, 2, log2)) for k in (0, 1)]
    assert [r[0] for r in device_loop.run_calls(same)] == [0, 1]
    assert max(i for i, e in enumerate(log2) if e[1] == 0) < min(
        i for i, e in enumerate(log2) if e[1] == 1)
