"""The BSSRDF probe loop's dispatch and records on the CPU: CPU tensors and
the tabulated profile never reach the kernels' wrapper (ops/bssrdf.py),
which refuses CPU tensors; the exit merged into the surface draw's outputs;
the with_stats counters `bssrdf_lanes` / `bssrdf_exits` against a count of
the plain path; the wrapper's argument block against csrc/bssrdf.cu's; the
byte count. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import dataclasses
import re

import pytest
import torch

from tpu_pathtracer_torch.ops import bssrdf as bssrdf_ops
from tpu_pathtracer_torch.scene import demo
from tpu_pathtracer_torch.tracer import bssrdf_shade, device_loop, regen
from tpu_pathtracer_torch.tracer import wavefront
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
from tpu_pathtracer_torch.utils import cuda_build
import torch_bssrdf_inputs as bssrdf_inputs

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# warm every pool thread up once at import.
torch.sqrt(torch.rand(1 << 16))

W = 24


@pytest.fixture(scope="module")
def organic():
    """A 24x24 organic sss renderer on the CPU and its first wave's
    bssrdf_scatter inputs."""
    r = bssrdf_inputs.organic_renderer("cpu", W, n_lat=24, n_lon=48)
    return r, bssrdf_inputs.wave_inputs(r)


def _refuse(*args, **kwargs):
    raise AssertionError("the probe loop's kernel wrapper was reached")


def test_cpu_tensors_never_reach_the_wrapper(organic, monkeypatch):
    """A CPU render of the organic sss scene, regen and bounce, and a
    direct call, run bssrdf_scatter_plain: the wrapper is never called."""
    r, inputs = organic
    monkeypatch.setattr(bssrdf_ops, "probe_loop", _refuse)
    monkeypatch.setattr(bssrdf_ops, "_kernel", _refuse)
    assert int(inputs["lanes"].sum()) > 0
    for integrator in ("regen", "bounce"):
        r.settings = dataclasses.replace(r.settings, integrator=integrator)
        acc = r.render_frames(r.zeros_accum(), bssrdf_inputs.camera(W), 1,
                              1)
        assert torch.isfinite(acc).all() and float(acc.mean()) > 0
    r.settings = dataclasses.replace(r.settings, integrator="regen")
    out = bssrdf_inputs.run(r.scene, r.settings, inputs, plain=False)
    assert out[4].any()


def test_wrapper_refuses_cpu_tensors(organic):
    r, inputs = organic
    before = dict(bssrdf_ops.LAUNCHES)
    args = [inputs[k] for k in ("rng", "hitpoint", "normal2", "mat_id",
                                "objcol", "lanes")]
    with pytest.raises(ValueError, match="not a CUDA device"):
        bssrdf_ops._prepare(r.scene, *args, 3, True, None)
    assert bssrdf_ops.LAUNCHES == before


@pytest.mark.parametrize("device,soe,want", [
    ("cpu", True, False), ("cpu", False, False), ("cuda", True, True),
    ("cuda", False, False), ("cuda:1", True, True)])
def test_only_a_cuda_device_with_the_soe_profile_takes_the_kernels(
        device, soe, want):
    """uses_kernels: the tabulated profile takes the plain path on every
    device, as CPU tensors do."""
    s = RenderSettings(has_bssrdf=True, bssrdf_use_soe=soe)
    assert bssrdf_shade.uses_kernels(torch.device(device), s) is want


def test_tabulated_profile_takes_the_plain_path(organic, monkeypatch):
    """bssrdf_use_soe=False runs bssrdf_scatter_plain with its table
    profile: the wrapper is not called, and the result is the plain
    version's."""
    r, inputs = organic
    monkeypatch.setattr(bssrdf_ops, "probe_loop", _refuse)
    s = dataclasses.replace(r.settings, bssrdf_use_soe=False)
    got = bssrdf_inputs.run(r.scene, s, inputs, plain=False)
    want = bssrdf_inputs.run(r.scene, s, inputs, plain=True)
    assert not any(bssrdf_inputs.differing_lanes(got, want,
                                                 inputs["lanes"]).values())


def test_exit_replaces_the_surface_draw_on_ok_lanes_only(organic):
    """With shade_out, the returned origin, direction and throughput are
    the exit's on the ok lanes and the surface draw's on every other lane;
    without it, the exit's own (don't-care off the ok lanes)."""
    r, inputs = organic
    args = [inputs[k] for k in bssrdf_inputs.ARGS]
    own = bssrdf_shade.bssrdf_scatter(r.scene, r.settings, *args)
    merged = bssrdf_inputs.run(r.scene, r.settings, inputs, plain=False)
    ok = own[4]
    assert ok.any() and not ok.all() and not (ok & ~inputs["lanes"]).any()
    for k in (1, 2, 3):
        assert torch.equal(merged[k][ok], own[k][ok])
        assert torch.equal(merged[k][~ok], inputs["shade_out"][k - 1][~ok])
    for k in (0, 4, 5, 6):
        assert torch.equal(merged[k], own[k])


def _plain_counts(r, monkeypatch):
    """{bssrdf_lanes, bssrdf_exits} of r's with_stats call, counted around
    each bssrdf_scatter the call makes (every wave at every drain width):
    the loop's lanes and the ok lanes of the plain path."""
    counted = {"bssrdf_lanes": 0, "bssrdf_exits": 0}
    plain = wavefront.bssrdf_scatter

    def counting(*args, **kwargs):
        out = plain(*args, **kwargs)
        counted["bssrdf_lanes"] += int(args[8].sum())
        counted["bssrdf_exits"] += int(out[4].sum())
        return out
    monkeypatch.setattr(wavefront, "bssrdf_scatter", counting)
    return counted


def test_bssrdf_counters_equal_a_count_of_the_plain_path(organic,
                                                         monkeypatch):
    """A with_stats call of a subsurface scene publishes, in last_counters,
    the lanes that entered the probe loop and those that left it at an exit,
    summed over every wave at every drain width: the count of the plain
    path's calls; the image is the plain call's; the call without
    with_stats publishes nothing."""
    r, _ = organic
    cam = bssrdf_inputs.camera(W)
    plain_acc = r.render_frames(r.zeros_accum(), cam, 1, 2)
    counted = _plain_counts(r, monkeypatch)
    acc, waves, rays = r.render_frames(r.zeros_accum(), cam, 1, 2,
                                       with_stats=True)
    fn = r.regen_integrator(True)
    assert len(fn.last_waves) >= 2                 # a drain width ran
    got = fn.last_counters
    assert set(got) == set(regen.BSSRDF_COUNTERS)
    assert got == counted and all(type(v) is int for v in got.values())
    assert 0 < got["bssrdf_exits"] < got["bssrdf_lanes"]
    assert torch.equal(acc, plain_acc)
    assert r.regen_integrator(False).last_counters == {}


@pytest.mark.parametrize("variant", ["default", "media"])
def test_scenes_without_bssrdf_publish_no_bssrdf_counter(variant):
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=None,
                                                   variant=variant)
    s = RenderSettings(has_media=variant == "media")
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=16,
                 height=16, settings=s, device="cpu")
    r.render_frames(r.zeros_accum(), bssrdf_inputs.camera(16), 1, 1,
                    with_stats=True)
    got = r.regen_integrator(True).last_counters
    assert set(got) == (set(regen.COUNTERS) if variant == "media" else set())


def _struct_fields(src):
    """(type, pointer?, name) of each field of csrc/bssrdf.cu's
    ProbeArgs."""
    body = re.search(r"struct ProbeArgs \{(.*?)\};", src, re.S).group(1)
    return [(m.group(1), bool(m.group(2)), m.group(3)) for m in re.finditer(
        r"^\s*(?:const )?(\w+)(\*?)\s+(\w+);", body, re.M)]


def test_argument_block_matches_the_source():
    """ops/bssrdf.py: ProbeArgs lays its fields out as csrc/bssrdf.cu's
    struct: the same names in the same order, pointers as pointers, 64-bit
    and 32-bit ints as such; the state row's width and the counts' byte
    fields agree with STATE_COLS and MAX_PROBES."""
    import ctypes
    src = cuda_build.source_text("bssrdf")
    fields = _struct_fields(src)
    py = bssrdf_ops.ProbeArgs._fields_
    assert [n for _, _, n in fields] == [n for n, _ in py]
    for (ctype, pointer, name), (_, pytype) in zip(fields, py):
        want = ctypes.c_void_p if pointer else {
            "int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32}[ctype]
        assert pytype is want, name
    assert "constexpr int kStateCols = %d;" % bssrdf_ops.STATE_COLS in src
    assert "kByte = 0xffu" in src and bssrdf_ops.MAX_PROBES == 0xff
    assert 'extern "C" int tpt_bssrdf_probe(' in src


def test_sources_share_the_lane_math_header():
    """csrc/shade.cu and csrc/bssrdf.cu compile one copy of the shared
    helpers (csrc/lane_math.cuh), and a header change moves the library
    path of every source that includes it."""
    for name in ("shade", "bssrdf", "fetch", "envtex"):
        text = cuda_build.source_text(name)
        assert text.count("struct V3 {") == 1, name
        assert '#include "' not in text, name
    assert "fetch_row(" in cuda_build.source_text("bssrdf")
    with open(cuda_build.CSRC + "/shade.cu") as f:
        assert "void make_basis(" not in f.read()


def test_lib_path_follows_the_headers(tmp_path, monkeypatch):
    for f in ("bssrdf.cu", "lane_math.cuh", "surface.cuh", "marks.cu"):
        (tmp_path / f).write_text(open(cuda_build.CSRC + "/" + f).read())
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", str(tmp_path / "_build"))
    before = {n: cuda_build.lib_path(n) for n in ("bssrdf", "marks")}
    with open(tmp_path / "lane_math.cuh", "a") as f:
        f.write("\n// changed\n")
    after = {n: cuda_build.lib_path(n) for n in ("bssrdf", "marks")}
    assert after["bssrdf"] != before["bssrdf"]
    assert after["marks"] == before["marks"]


def test_io_bytes_counts_each_input_and_output_once():
    # 10 lanes, 4 in the loop, 3 probes, 2 exits, 5 attribute rows, 1
    # texture row, 2 materials
    got = bssrdf_ops.io_bytes(10, 4, 2, 3, 5, 1, 2)
    want = 10 * (8 + 1 + 8 + 1) + 4 * (12 * 3 + 4 + 3 * 8 + 3 * 28
                                       + 2 * 12) \
        + 2 * 36 + 5 * 112 + 48 + 2 * 124
    assert got == want
    assert bssrdf_ops.io_bytes(0, 0, 0, 3, 0, 0, 0) == 0


def test_device_loop_holds_the_probe_counts():
    counts = device_loop.launch_counts()
    assert set(bssrdf_ops.LAUNCHES) <= set(counts)
    try:
        device_loop.set_launch_counts({k: 7 for k in counts})
        assert all(v == 7 for v in bssrdf_ops.LAUNCHES.values())
    finally:
        device_loop.set_launch_counts(counts)
