"""The surface fetches of a path segment: the hit-attribute fetch
(`fetch_attributes`) and the env / texture quad lookup (`env_tex_merged`
and its texture-only form `texture_radiance`). CUDA kernels on the card,
their plain PyTorch versions on the CPU.

Each has the signature and returns of the JAX package's function of the
same name in `tracer/wavefront.py`. The plain versions are a row gather
and some tens of elementwise torch kernels over the whole pool (under
`jax.jit` XLA fuses that work). The kernels, csrc/fetch.cu and
csrc/envtex.cu, compute a lane per thread and give the plain versions'
bits on the card: every sum and product is rounded where the plain
version's separate torch kernels round it (see the notes at the top of
the sources). `tracer/wavefront.py` holds the dispatchers: a CPU tensor
goes to the plain version, any other device to the `*_cuda` wrapper
here, which launches its kernel once or raises. Nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.vecmath import PI, barycentric
from ..scene.texture import (
    sample_texture_quad, _uv_from_dir, _corner_pdf, _bilinear_rows,
)
from ..tracer.envsample import power_heuristic
from .checks import require

ATTR_COLS = 28
ENV_COLS = 16
TEX_COLS = 12

# Launches of the kernels, counted where a wrapper launches its kernel and
# nowhere else; set back to 0 by whoever reads them.
LAUNCHES = {"fetch_attributes": 0, "env_tex_merged": 0,
            "texture_radiance": 0}


def fetch_attributes_plain(scene, hit_slot, hitpoint):
    """Barycentric-interpolated uv + smooth normal + geometric normal at the
    hit, from one row gather. Returns (hit_uv, smooth_n, mat_id, tri_n);
    tri_n is zero on miss lanes."""
    a = scene["tri_attr"][torch.clamp_min(hit_slot, 0).long()]     # [N,28]
    p0, p1, p2 = a[:, 0:3], a[:, 3:6], a[:, 6:9]
    u, v, w = barycentric(hitpoint, p0, p1, p2)
    hit_uv = (u[:, None] * a[:, 9:11] + v[:, None] * a[:, 11:13]
              + w[:, None] * a[:, 13:15])
    smooth_n = (u[:, None] * a[:, 15:18] + v[:, None] * a[:, 18:21]
                + w[:, None] * a[:, 21:24])
    mat_id = a[:, 24].contiguous().view(torch.int32)
    tri_n = torch.where((hit_slot >= 0)[:, None], a[:, 25:28], 0.0)
    return hit_uv, smooth_n, mat_id, tri_n


def mis_env_weight(raydir, p_uv, bsdf_pdf):
    """BSDF-side MIS weight of an env hit; bsdf_pdf < 0 means no env NEE at
    the previous vertex (weight 1)."""
    y = raydir[:, 1]
    sin_t = torch.sqrt(torch.clamp_min(1.0 - y * y, 1e-8))
    pdf_e = p_uv / (2.0 * PI * PI * sin_t)
    return torch.where(bsdf_pdf < 0.0, 1.0, power_heuristic(bsdf_pdf, pdf_e))


def texture_radiance_plain(scene, hit_uv):
    return sample_texture_quad(scene["texture_quad"], scene["tex_h"],
                               scene["tex_w"], hit_uv[:, 0], hit_uv[:, 1])


def env_tex_merged_plain(scene, settings, raydir, bsdf_pdf, env_rotation,
                         miss, hit_uv):
    """MIS-weighted env-miss radiance AND texture radiance from one gather
    of the merged envtex_quad table: a miss lane reads its env row, any
    other lane its texture row. Returns (env_weighted_L [N,3],
    tex_rgb [N,3]), equal to env_miss_weighted / texture_radiance.

    Miss lanes carry non-finite hit_uv (the hit point at t = RAY_MAX);
    their texture row index is kept in range by the remainders and never
    selected."""
    He, We = scene["env_h"], scene["env_w"]
    Ht, Wt = scene["tex_h"], scene["tex_w"]
    u_e, v_e = _uv_from_dir(raydir, env_rotation)
    xe = u_e * We - 0.5
    ye = v_e * He - 0.5
    xe0 = torch.floor(xe)
    ye0 = torch.floor(ye)
    fxe = (xe - xe0)[..., None]
    fye = (ye - ye0)[..., None]
    xe0i = torch.clamp(xe0.to(torch.int32), 0, We - 1)
    ye0i = torch.clamp(ye0.to(torch.int32), 0, He - 1)
    env_row = ye0i * We + xe0i
    u_t = torch.remainder(hit_uv[:, 0], 1.0)
    v_t = torch.remainder(hit_uv[:, 1], 1.0)
    xt = u_t * Wt - 0.5
    yt = v_t * Ht - 0.5
    xt0 = torch.floor(xt)
    yt0 = torch.floor(yt)
    fxt = (xt - xt0)[..., None]
    fyt = (yt - yt0)[..., None]
    xt0i = torch.remainder(xt0.to(torch.int32), Wt)
    yt0i = torch.remainder(yt0.to(torch.int32), Ht)
    tex_row = He * We + yt0i * Wt + xt0i

    q = scene["envtex_quad"][torch.where(miss, env_row, tex_row).long()]
    p_uv = _corner_pdf(q, u_e, v_e, xe0i, ye0i, He, We)
    env_L = mis_env_weight(raydir, p_uv, bsdf_pdf)[:, None] \
        * _bilinear_rows(q, fxe, fye)
    return env_L, _bilinear_rows(q, fxt, fyt)


# ---- the kernels ----

_ENTRIES = {
    # name: (source, C entry, argtypes after n_lanes and before the stream)
    "fetch_attributes": ("fetch", "tpt_fetch_attributes", 7 * "p"),
    "env_tex_merged": ("envtex", "tpt_env_tex_merged", 6 * "p" + 4 * "i"
                       + 2 * "p"),
    "texture_radiance": ("envtex", "tpt_texture_radiance", 2 * "p" + 2 * "i"
                         + "p"),
}


def _kernel(name):
    from ..utils.cuda_build import load
    source, entry, sig = _ENTRIES[name]
    fn = getattr(load(source), entry)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
        fn.argtypes = [ctypes.c_int64] + [kinds[c] for c in sig] + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _on_cuda(t, what):
    device = t.device
    if device.type != "cuda":
        raise ValueError("%s kernel: tensors are on %s, not a CUDA device"
                         % (what, device))
    return device


def _table(scene, key, device, cols):
    """scene[key]: a contiguous (rows, cols) f32 table on device whose base
    is 16-byte aligned (the kernels read its rows in 16-byte loads)."""
    t = scene[key]
    require(t, key, device, torch.float32, (t.shape[0], cols))
    if t.data_ptr() % 16:
        raise ValueError("%s is not 16-byte aligned (its rows are read as "
                         "float4)" % key)
    return t


def _uv(hit_uv, device, N):
    require(hit_uv, "hit_uv", device, torch.float32, (N, 2))
    if hit_uv.data_ptr() % 8:
        raise ValueError("hit_uv is not 8-byte aligned (read as float2)")


def _prepare_fetch(scene, hit_slot, hitpoint):
    """Check the inputs and allocate the outputs. Returns (args of the C
    entry without the stream, outputs)."""
    device = _on_cuda(hit_slot, "fetch_attributes")
    N = hit_slot.shape[0]
    require(hit_slot, "hit_slot", device, torch.int32, (N,))
    require(hitpoint, "hitpoint", device, torch.float32, (N, 3))
    table = _table(scene, "tri_attr", device, ATTR_COLS)
    f32 = dict(dtype=torch.float32, device=device)
    out = (torch.empty((N, 2), **f32), torch.empty((N, 3), **f32),
           torch.empty((N,), dtype=torch.int32, device=device),
           torch.empty((N, 3), **f32))
    args = (N, hit_slot.data_ptr(), hitpoint.data_ptr(), table.data_ptr(),
            *(t.data_ptr() for t in out))
    return args, out


def _prepare_env_tex(scene, raydir, bsdf_pdf, env_rotation, miss, hit_uv):
    device = _on_cuda(raydir, "env_tex_merged")
    N = raydir.shape[0]
    require(raydir, "raydir", device, torch.float32, (N, 3))
    require(bsdf_pdf, "bsdf_pdf", device, torch.float32, (N,))
    require(miss, "miss", device, torch.bool, (N,))
    _uv(hit_uv, device, N)
    # a 0-d device tensor (cam_vec[15]), read by the kernel: a host read
    # would break the capture of a CUDA graph
    require(env_rotation, "env_rotation", device, torch.float32, ())
    table = _table(scene, "envtex_quad", device, ENV_COLS)
    He, We = scene["env_h"], scene["env_w"]
    Ht, Wt = scene["tex_h"], scene["tex_w"]
    if table.shape[0] != He * We + Ht * Wt:
        raise ValueError("envtex_quad has %d rows, not env_h*env_w + "
                         "tex_h*tex_w = %d" % (table.shape[0],
                                               He * We + Ht * Wt))
    f32 = dict(dtype=torch.float32, device=device)
    out = (torch.empty((N, 3), **f32), torch.empty((N, 3), **f32))
    args = (N, raydir.data_ptr(), bsdf_pdf.data_ptr(), miss.data_ptr(),
            hit_uv.data_ptr(), env_rotation.data_ptr(), table.data_ptr(),
            He, We, Ht, Wt, *(t.data_ptr() for t in out))
    return args, out


def _prepare_texture(scene, hit_uv):
    device = _on_cuda(hit_uv, "texture_radiance")
    N = hit_uv.shape[0]
    _uv(hit_uv, device, N)
    table = _table(scene, "texture_quad", device, TEX_COLS)
    Ht, Wt = scene["tex_h"], scene["tex_w"]
    if table.shape[0] != Ht * Wt:
        raise ValueError("texture_quad has %d rows, not tex_h*tex_w = %d"
                         % (table.shape[0], Ht * Wt))
    out = torch.empty((N, 3), dtype=torch.float32, device=device)
    return (N, hit_uv.data_ptr(), table.data_ptr(), Ht, Wt,
            out.data_ptr()), out


_PREPARE = {"fetch_attributes": _prepare_fetch,
            "env_tex_merged": _prepare_env_tex,
            "texture_radiance": _prepare_texture}


def _call(fn, name, args, stream):
    """Run the C entry (which launches nothing for 0 lanes); raise on a
    nonzero code."""
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, err))


def _launch(name, device, *inputs):
    """Check, allocate, launch on the current stream of the inputs' device
    (no host read, so the launch can be captured in a CUDA graph), count
    the launch. Returns the outputs."""
    fn = _kernel(name)
    args, out = _PREPARE[name](*inputs)
    if args[0]:
        with torch.cuda.device(device):
            _call(fn, name, args, torch.cuda.current_stream(device)
                  .cuda_stream)
        LAUNCHES[name] += 1
    return out


def fetch_attributes_cuda(scene, hit_slot, hitpoint):
    """csrc/fetch.cu on CUDA tensors. Returns as fetch_attributes_plain."""
    return _launch("fetch_attributes", hit_slot.device, scene, hit_slot,
                   hitpoint)


def env_tex_merged_cuda(scene, raydir, bsdf_pdf, env_rotation, miss,
                        hit_uv):
    """csrc/envtex.cu's merged kernel on CUDA tensors; env_rotation a 0-d
    f32 tensor on their device. Returns as env_tex_merged_plain."""
    return _launch("env_tex_merged", raydir.device, scene, raydir, bsdf_pdf,
                   env_rotation, miss, hit_uv)


def texture_radiance_cuda(scene, hit_uv):
    """csrc/envtex.cu's texture-only kernel on CUDA tensors. Returns as
    texture_radiance_plain."""
    return _launch("texture_radiance", hit_uv.device, scene, hit_uv)


def launch_fn(name, scene, *inputs):
    """The bare launch of kernel `name` (a key of LAUNCHES), for timing the
    kernel alone: checks the inputs of its *_cuda wrapper (CUDA tensors on
    the current device; env_tex_merged's without `settings`) and
    allocates the outputs once, then returns a function of no arguments
    that launches the kernel into them and returns them, raising on a
    nonzero code. Its launches are not counted in LAUNCHES."""
    device = inputs[0].device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError("launch_fn: the inputs must lie on the current CUDA "
                         "device, not %s" % device)
    fn = _kernel(name)
    args, out = _PREPARE[name](scene, *inputs)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch():
        _call(fn, name, args, stream)
        return out
    return launch


# ---- the bytes a call must move ----

# bytes a lane reads and writes beside its table row: fetch_attributes
# hit_slot 4, hitpoint 12 in, hit_uv 8, smooth_n 12, mat_id 4, tri_n 12
# out; env_tex_merged raydir 12, bsdf_pdf 4, miss 1, hit_uv 8 in, env_L
# 12, tex 12 out; texture_radiance hit_uv 8 in, tex 12 out
LANE_BYTES = {"fetch_attributes": 52, "env_tex_merged": 49,
              "texture_radiance": 20}
ROW_BYTES = {"fetch_attributes": 4 * ATTR_COLS,
             "env_tex_merged": 4 * ENV_COLS,
             "texture_radiance": 4 * TEX_COLS}


def rows_read(name, scene, *inputs):
    """The table row each lane of a call of kernel `name` reads (int64
    [N]), from the inputs of its *_cuda wrapper: the plain versions' row
    index arithmetic."""
    if name == "fetch_attributes":
        return torch.clamp_min(inputs[0], 0).long()
    hit_uv = inputs[-1]
    Ht, Wt = scene["tex_h"], scene["tex_w"]
    xt0 = torch.floor(torch.remainder(hit_uv[:, 0], 1.0) * Wt - 0.5)
    yt0 = torch.floor(torch.remainder(hit_uv[:, 1], 1.0) * Ht - 0.5)
    tex_row = torch.remainder(yt0.to(torch.int32), Ht) * Wt \
        + torch.remainder(xt0.to(torch.int32), Wt)
    if name == "texture_radiance":
        return tex_row.long()
    raydir, _, env_rotation, miss, _ = inputs
    He, We = scene["env_h"], scene["env_w"]
    u_e, v_e = _uv_from_dir(raydir, env_rotation)
    xe0i = torch.clamp(torch.floor(u_e * We - 0.5).to(torch.int32), 0,
                       We - 1)
    ye0i = torch.clamp(torch.floor(v_e * He - 0.5).to(torch.int32), 0,
                       He - 1)
    return torch.where(miss, ye0i * We + xe0i, He * We + tex_row).long()


def io_bytes(name, rows):
    """Bytes a call of kernel `name` must move, each input read once and
    each output written once: LANE_BYTES a lane and each table row that
    the lanes read (rows: rows_read's) once; env_tex_merged also reads
    the rotation's 4 bytes. A table this size stays in the L2, so a row
    that several lanes read need not come from device memory again."""
    n_rows = int(torch.unique(rows).numel())
    return LANE_BYTES[name] * rows.numel() + ROW_BYTES[name] * n_rows \
        + (4 if name == "env_tex_merged" else 0)
