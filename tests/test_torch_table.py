"""The traversal table's residency (`table_mem`) in the port, on the CPU.

Where the kernel reads its rows from is planned by a pure-Python function,
`table_plan`, checked here for every `table_mem`, K and N edge. The JAX
raises hold; on CPU tensors `table_mem` changes nothing (slot, t and steps
are equal bit for bit, and equal to the JAX kernel's result in interpret
mode to the traversal tolerance: slots on >= 0.999 of lanes, t to rtol
1e-5 + atol 1e-6 where they agree); the bare launch refuses a CPU tensor
whatever `table_mem` says. The kernels themselves run in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpu_pathtracer.ops import traverse_packet as jops
from tpu_pathtracer_torch.scene import demo as tdemo
from tpu_pathtracer_torch.tracer import traverse as ttrav
from tpu_pathtracer_torch.tracer.renderer import Renderer
from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
from tpu_pathtracer_torch.ops import traverse_packet as tops
from tpu_pathtracer_torch.tools import probe_steps

torch.set_num_threads(2)
# The first MKL-backed call (torch.sqrt) on a fresh CPU pool thread can
# return a low-accuracy result (~3e-4 relative) for that thread's share;
# one call spanning both threads settles it before any test compares.
torch.sqrt(torch.ones(1 << 16))
RAY_MIN, RAY_MAX = 1e-4, 1e20
TABLE_MEMS = ("auto", "smem", "split", "vmem", "vmem_packed")


@functools.lru_cache(maxsize=1)
def _stream():
    fb = tdemo.large_scene(cache_dir=None, n_lat=10, n_lon=16,
                           ground_div=4)[0]
    return fb, ttrav.pack_stream(fb.prims, fb.meta)


def _rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    o[:, 1] = g.uniform(0.2, 3, n)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, g


@pytest.mark.parametrize("table_mem", ["smem", "split"])
@pytest.mark.parametrize("K,N,S", [
    (5803, 1 << 20, tops.TABLE_ROWS), (177100, 4096, tops.TABLE_ROWS),
    (tops.TABLE_ROWS, 1, tops.TABLE_ROWS),
    (tops.TABLE_ROWS + 1, 397, tops.TABLE_ROWS),
    (tops.TABLE_ROWS - 1, 31, tops.TABLE_ROWS - 1), (1, 1, 1),
    (50, 0, 0), (0, 16, 0),
])
def test_table_plan_table(table_mem, K, N, S):
    assert tops.table_plan(K, N, table_mem) == (S, tops.BLOCK, S * 64)


@pytest.mark.parametrize("table_mem", ["auto", "vmem", "vmem_packed"])
@pytest.mark.parametrize("K,N", [(5803, 1 << 20), (177100, 1 << 20),
                                 (137688, 4096), (1, 1), (50, 0)])
def test_table_plan_ldg(table_mem, K, N):
    assert tops.table_plan(K, N, table_mem) == (0, tops.BLOCK, 0)


def test_table_plan_fits_the_card_and_raises_on_a_typo():
    # 12 blocks an SM, each with its rows and the KB the system keeps,
    # inside the SM's 228 KB; under 48 KB a block, so no opt-in is needed
    assert 12 * (tops.TABLE_MAX_ROWS * tops.ROW_BYTES + 1024) <= 228 * 1024
    assert tops.TABLE_ROWS <= tops.TABLE_MAX_ROWS
    assert tops.TABLE_MAX_ROWS * tops.ROW_BYTES <= 48 * 1024
    with pytest.raises(ValueError, match="unknown table_mem"):
        tops.table_plan(100, 100, "smem_split")


def test_launch_names_cover_every_instantiation():
    names = {"traverse_%s%s%s" % (k, t, c) for k in ("closest", "anyhit")
             for t in ("", "_table") for c in ("", "_steps")}
    assert set(tops.LAUNCHES) == names
    assert set(tops.FORM_LAUNCHES) == {"closest_mask_lane_tmax"}


@pytest.mark.parametrize("kw,match", [
    (dict(table_mem="smem_split"), "unknown table_mem"),
    (dict(table_mem="split", step_mode="branch"), "requires step_mode"),
    (dict(table_mem="vmem_packed", step_mode="branch"),
     "requires step_mode"),
])
def test_table_mem_raises_as_jax(kw, match):
    _, packed = _stream()
    o, d, _ = _rays(16, 0)
    with pytest.raises(ValueError, match=match):
        tops.packet_intersect(torch.from_numpy(packed), torch.from_numpy(o),
                              torch.from_numpy(d), RAY_MIN, RAY_MAX, **kw)
    with pytest.raises(ValueError, match=match):
        jops.packet_intersect(jnp.asarray(packed), jnp.asarray(o),
                              jnp.asarray(d), RAY_MIN, RAY_MAX,
                              interpret=True, **kw)


def test_table_mem_smem_budget_raise_as_jax():
    """The JAX package refuses `smem` for a stream over its SMEM budget;
    the port keeps the raise, so such a stream takes `split`."""
    big = np.zeros((20000, 16), np.float32)
    assert tops.table_fits_smem(12500) and not tops.table_fits_smem(12501)
    assert tops.table_fits_smem(12500) == jops.table_fits_smem(12500)
    assert tops.table_fits_smem(12501) == jops.table_fits_smem(12501)
    o, d, _ = _rays(4, 1)
    for mod, conv in ((tops, torch.from_numpy), (jops, jnp.asarray)):
        with pytest.raises(ValueError, match="SMEM budget"):
            mod.packet_intersect(conv(big), conv(o), conv(d), RAY_MIN,
                                 RAY_MAX, table_mem="smem")


@pytest.mark.parametrize("anyhit", [False, True])
def test_table_mem_changes_no_cpu_result(anyhit):
    fb, packed = _stream()
    n = 512
    o, d, g = _rays(n, 2)
    act = torch.from_numpy(g.random(n) < 0.7)
    tmax = torch.from_numpy(g.uniform(0.5, 8.0, n).astype(np.float32)) \
        if not anyhit else RAY_MAX
    base = None
    before = dict(tops.LAUNCHES)
    for tm in TABLE_MEMS:
        got = tops.packet_intersect(
            torch.from_numpy(packed), torch.from_numpy(o),
            torch.from_numpy(d), RAY_MIN, tmax, anyhit=anyhit,
            stack_depth=fb.max_depth + 2, active=act, count_steps=True,
            table_mem=tm)
        if base is None:
            base = got
        assert all(torch.equal(a, b) for a, b in zip(got, base)), tm
    assert tops.LAUNCHES == before            # the CPU launches no kernel
    # and the JAX kernel, under either residency, gives the same hits
    for tm in ("split", "vmem"):
        js, jt = jops.packet_intersect(
            jnp.asarray(packed), jnp.asarray(o), jnp.asarray(d), RAY_MIN,
            jnp.asarray(tmax) if not anyhit else RAY_MAX, anyhit=anyhit,
            stack_depth=fb.max_depth + 2, active=jnp.asarray(act.numpy()),
            table_mem=tm, interpret=True)
        js, jt = np.asarray(js), np.asarray(jt)
        hit_t = (base[0].numpy() >= 0)
        assert (hit_t == (js >= 0)).mean() >= 0.999
        if not anyhit:
            same = base[0].numpy() == js
            assert same.mean() >= 0.999
            np.testing.assert_allclose(base[1].numpy()[same], jt[same],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("table_mem", TABLE_MEMS)
def test_bare_launch_refuses_cpu_tensors_with_table_mem(table_mem):
    _, packed = _stream()
    o, d, _ = _rays(16, 3)
    with pytest.raises(ValueError, match="current CUDA device"):
        tops.launch_fn(torch.from_numpy(packed), torch.from_numpy(o),
                       torch.from_numpy(d), RAY_MIN, RAY_MAX,
                       table_mem=table_mem)


def test_bare_launch_checks_table_mem_first():
    _, packed = _stream()
    o, d, _ = _rays(16, 3)
    with pytest.raises(ValueError, match="unknown table_mem"):
        tops.launch_fn(torch.from_numpy(packed), torch.from_numpy(o),
                       torch.from_numpy(d), RAY_MIN, RAY_MAX,
                       table_mem="shared")
    with pytest.raises(ValueError, match="SMEM budget"):
        tops.launch_fn(torch.zeros((20000, 16)), torch.from_numpy(o),
                       torch.from_numpy(d), RAY_MIN, RAY_MAX,
                       table_mem="smem")


def test_render_setting_packet_table_mem_changes_no_cpu_image():
    fb, mats, envmap, texture = tdemo.large_scene(
        cache_dir=None, n_lat=10, n_lon=16, ground_div=4)
    W = 16
    rc = tdemo.default_camera(W, W).build_render_camera()
    imgs = []
    for tm in ("auto", "split"):
        s = RenderSettings(packet_table_mem=tm)
        r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                     height=W, settings=s, device="cpu")
        imgs.append(r.render_frames(r.zeros_accum(), rc, 1, 2).numpy())
    assert np.array_equal(imgs[0], imgs[1])


def test_probe_steps_counts_under_every_residency():
    """The census tool takes --scene and --table-mem; on the CPU every
    residency gives the same counts and nothing is timed."""
    r, cam_vec = probe_steps.scene_renderer("large", 16, "cpu", None,
                                            n_lat=8, n_lon=12, ground_div=4)
    one = probe_steps.run(r, cam_vec, [2], 2, timed=False)
    two = probe_steps.run(r, cam_vec, [2], 2, timed=False,
                          table_mems=("vmem", "split"))
    for kind in ("closest", "anyhit"):
        a, b = one[0][kind], two[0][kind]
        assert a["steps_sum"] == b["steps_sum"] > 0
        assert a["tax"] == b["tax"]
        assert b["by_table_mem"] == {"vmem": [], "split": []}
        assert b["measured_paid"] is None and b["trace_ms"] is None
    assert "not measured" in probe_steps.report(two[0])


def test_probe_steps_cli_on_cpu(capsys, tmp_path):
    rc = probe_steps.main(["--device", "cpu", "--size", "16", "--waves", "1",
                           "--spp", "1", "--scene", "organic_sss",
                           "--table-mem", "vmem,split", "--cache-dir",
                           str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and '"scene": "organic_sss"' in out
    assert '"table_mems": ["vmem", "split"]' in out
