"""The BSSRDF probe loop's per-lane work on the card (`probe_loop`): the
kernels of csrc/bssrdf.cu around the loop's masked closest-hit traces.

`tracer/bssrdf_shade.py: bssrdf_scatter` sends a CUDA call with the
sum-of-exponentials profile (`bssrdf_use_soe=True`) here; a CPU tensor, and
the tabulated profile on any device, take its plain PyTorch version,
`bssrdf_scatter_plain`. A wave runs 1 + probes launches: `probe_start`
(every lane's RNG advanced by the loop's draws, the first probe ray and the
state of each loop lane), then after each trace `probe_step` (the pick and
the next probe ray) or, after the last, `probe_finish` (the last pick, the
exit direction, the profile, the exit Fresnel factor), which writes the
exit's origin, direction and throughput in place into the surface draw's
outputs on the lanes that found an exit. The traces stay the traversal
kernel's, under the loop's mask with the probes' lengths as per-lane tmax.
Nothing falls back: a call that cannot build or launch a kernel raises.

The kernels give the plain version's bits on the card (see the note at the
top of csrc/bssrdf.cu); the loop is chaotic, so nothing less would hold.
"""
from __future__ import annotations

import ctypes

import torch

from .checks import require
from .shade import MAT_COLS, _row_stride
from .surface_fetch import ATTR_COLS, TEX_COLS, _table

# Launches of each kernel, counted where the wrapper launches it and
# nowhere else; set back to 0 by whoever reads them.
LAUNCHES = {"probe_start": 0, "probe_step": 0, "probe_finish": 0}
STAGES = ("probe_start", "probe_step", "probe_finish")
# the loop's state row (csrc/bssrdf.cu: kStateCols) and the most probes its
# one-byte counts hold
STATE_COLS = 16
MAX_PROBES = 255


class ProbeArgs(ctypes.Structure):
    """csrc/bssrdf.cu: ProbeArgs, field for field."""
    _fields_ = [(name, ctypes.c_int64 if name in ("n", "s_hp", "s_n",
                                                  "s_obj")
                 else ctypes.c_void_p) for name in (
        "n", "rng_in", "rng_out", "hitpoint", "s_hp", "normal", "s_n",
        "objcol", "s_obj", "mat_id", "lanes", "mat_table", "tri_attr",
        "tex", "slot", "dist", "state", "probe_orig", "probe_dir",
        "probe_len", "new_orig", "next_dir", "mask_mul", "ok", "is_mul",
        "next_normal")] + [(name, ctypes.c_int32) for name in (
            "n_mats", "tex_h", "tex_w", "n_draws")]


def _kernel():
    from ..utils.cuda_build import load
    fn = load("bssrdf").tpt_bssrdf_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _prepare(scene, rng, hitpoint, normal, mat_id, objcol, lanes, probes,
             use_texture, shade_out):
    """Check the inputs, allocate the outputs and the scratch columns.
    Returns (ProbeArgs without slot and dist, outputs (rng, new_orig,
    next_dir, mask_mul, ok, is_mul, next_normal), probe rays (orig, dir,
    len), the scratch state)."""
    device = hitpoint.device
    if device.type != "cuda":
        raise ValueError("bssrdf probe kernels: tensors are on %s, not a "
                         "CUDA device" % device)
    if not 1 <= int(probes) <= MAX_PROBES:
        raise ValueError("bssrdf probe kernels: bssrdf_probes must be in "
                         "[1, %d], got %d" % (MAX_PROBES, probes))
    N = hitpoint.shape[0]
    require(rng, "rng", device, torch.int64, (N,))
    require(mat_id, "mat_id", device, torch.int32, (N,))
    require(lanes, "lanes", device, torch.bool, (N,))
    s_hp = _row_stride(hitpoint, "hitpoint", device, N)
    s_n = _row_stride(normal, "normal", device, N)
    s_obj = _row_stride(objcol, "objcol", device, N)
    mats = scene["mat_table"]
    require(mats, "mat_table", device, torch.float32,
            (mats.shape[0], MAT_COLS))
    tri = _table(scene, "tri_attr", device, ATTR_COLS)
    tex, tex_h, tex_w = None, 0, 0
    if use_texture:
        tex, tex_h, tex_w = (_table(scene, "texture_quad", device, TEX_COLS),
                             scene["tex_h"], scene["tex_w"])
        if tex.shape[0] != tex_h * tex_w:
            raise ValueError("texture_quad has %d rows, not tex_h*tex_w = %d"
                             % (tex.shape[0], tex_h * tex_w))
    f32 = dict(dtype=torch.float32, device=device)
    if shade_out is None:
        shade_out = tuple(torch.zeros((N, 3), **f32) for _ in range(3))
    for name, t in zip(("new_orig", "next_dir", "mask_mul"), shade_out):
        require(t, name, device, torch.float32, (N, 3))
    out = (torch.empty((N,), dtype=torch.int64, device=device),
           *shade_out, torch.empty((N,), dtype=torch.bool, device=device),
           torch.empty((N, 3), **f32), torch.empty((N, 3), **f32))
    rays = (torch.empty((N, 3), **f32), torch.empty((N, 3), **f32),
            torch.empty((N,), **f32))
    state = torch.empty((N, STATE_COLS), **f32)
    a = ProbeArgs(
        n=N, rng_in=rng.data_ptr(), rng_out=out[0].data_ptr(),
        hitpoint=hitpoint.data_ptr(), s_hp=s_hp, normal=normal.data_ptr(),
        s_n=s_n, objcol=objcol.data_ptr(), s_obj=s_obj,
        mat_id=mat_id.data_ptr(), lanes=lanes.data_ptr(),
        mat_table=mats.data_ptr(), tri_attr=tri.data_ptr(),
        tex=tex.data_ptr() if tex is not None else None,
        state=state.data_ptr(), probe_orig=rays[0].data_ptr(),
        probe_dir=rays[1].data_ptr(), probe_len=rays[2].data_ptr(),
        new_orig=out[1].data_ptr(), next_dir=out[2].data_ptr(),
        mask_mul=out[3].data_ptr(), ok=out[4].data_ptr(),
        is_mul=out[5].data_ptr(), next_normal=out[6].data_ptr(),
        n_mats=mats.shape[0], tex_h=tex_h, tex_w=tex_w,
        n_draws=4 * int(probes) + 2)
    return a, out, rays, state


def _hit(a, slot, dist, N, device):
    """Point the arguments at a trace's outputs."""
    require(slot, "slot", device, torch.int32, (N,))
    require(dist, "dist", device, torch.float32, (N,))
    a.slot, a.dist = slot.data_ptr(), dist.data_ptr()


def _launch(fn, stage, a, stream):
    err = fn(stage, ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (STAGES[stage], err))


def probe_loop(scene, rng, hitpoint, normal, mat_id, objcol, lanes, probes,
               use_texture, trace, shade_out=None):
    """The probe loop on CUDA tensors: csrc/bssrdf.cu's kernels on the
    current stream around `probes` calls of trace(orig, dir, tmax) ->
    (slot, t), the masked closest-hit traces of the probe rays (no host
    read, so the loop can be captured in a CUDA graph).

    hitpoint, normal (the interface normal ss_normal) and objcol are [N,3]
    f32 with adjacent columns (any row stride), mat_id [N] int32, lanes
    [N] bool (the loop's lanes), rng [N] int64; scene holds mat_table,
    tri_attr and, with use_texture, texture_quad, tex_h and tex_w.
    shade_out: the surface draw's (new_orig, next_dir, mask_mul), [N,3]
    f32 contiguous, which the exit overwrites in place on the ok lanes
    (zeros when None). Returns (rng, new_orig, next_dir, mask_mul, ok,
    is_mul, next_normal) as tracer/bssrdf_shade.py: bssrdf_scatter does;
    is_mul and next_normal hold values on `lanes` only."""
    fn = _kernel()
    device = hitpoint.device
    # the scratch and each trace's outputs are held until the launches that
    # read them are queued; after that the allocator reuses them in stream
    # order
    a, out, rays, state = _prepare(scene, rng, hitpoint, normal, mat_id,
                                   objcol, lanes, probes, use_texture,
                                   shade_out)
    N = hitpoint.shape[0]
    if N == 0:
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch(fn, 0, a, stream)
        LAUNCHES["probe_start"] += 1
        for k in range(int(probes)):
            slot, dist = trace(*rays)
            _hit(a, slot, dist, N, device)
            last = k == int(probes) - 1
            _launch(fn, 2 if last else 1, a, stream)
            LAUNCHES["probe_finish" if last else "probe_step"] += 1
    return out


def launch_fn(scene, rng, hitpoint, normal, mat_id, objcol, lanes, probes,
              use_texture, slot, dist, shade_out=None):
    """The bare launches, for timing the kernels alone: checks
    probe_loop's arguments (CUDA tensors on the current device) and
    allocates the outputs and scratch once, then returns {stage: a
    function of no arguments that launches that kernel into them and
    returns the outputs as probe_loop does} for STAGES; the steps read the
    trace outputs (slot, dist) given here. A
    step changes the state it reads, so a repeated step follows other
    branches than the loop's; the times, not the outputs, are what it
    gives. Its launches are not counted in LAUNCHES."""
    device = hitpoint.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError("launch_fn: hitpoint must lie on the current CUDA "
                         "device, not %s" % device)
    fn = _kernel()
    prepared = _prepare(scene, rng, hitpoint, normal, mat_id, objcol, lanes,
                        probes, use_texture, shade_out)
    a, out = prepared[:2]
    N = hitpoint.shape[0]
    _hit(a, slot, dist, N, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    # every tensor the arguments point into stays alive with the launches
    held = (prepared, rng, hitpoint, normal, mat_id, objcol, lanes, slot,
            dist)

    def stage_fn(stage):
        def launch():
            if N:
                _launch(fn, stage, held[0][0], stream)
            return out
        return launch
    return {name: stage_fn(k) for k, name in enumerate(STAGES)}


def io_bytes(n_lanes, n_loop, n_ok, probes, tri_rows, tex_rows, n_mats):
    """Bytes a wave's probe loop must move outside its traces, each input
    read once and each output written once, counted from what the lanes
    need: every lane reads rng 8 and the mask 1 and writes rng 8 and ok 1;
    a loop lane reads the hit point, ss_normal and objcol 12 each and
    mat_id 4, each trace's slot and t 4 each, writes each probe ray 28
    (orig 12, dir 12, tmax 4) and is_mul and next_normal 12 each; an ok
    lane writes new_orig, next_dir and mask_mul 12 each. Each attribute row
    a probe hit reads (tri_rows, 112 B), texture row a pick reads
    (tex_rows, 48 B) and material row (n_mats, 124 B) is read once. The
    loop's state row, carried across the traces, is not counted: a loop
    without traces between its steps would keep it in registers."""
    return 18 * n_lanes + (40 + 24 + 36 * probes) * n_loop + 36 * n_ok \
        + 4 * ATTR_COLS * tri_rows + 4 * TEX_COLS * tex_rows \
        + 4 * MAT_COLS * n_mats
