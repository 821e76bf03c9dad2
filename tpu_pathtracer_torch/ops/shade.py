"""The surface BSDF draw of a path segment (`shade`): a CUDA kernel on the
card, its plain PyTorch version on the CPU.

`shade` has the signature and returns of the JAX package's
`tracer/wavefront.py: shade`. A CPU tensor goes to `shade_plain`, which
evaluates every material branch for every lane and selects by refltype,
as the JAX function does (under `jax.jit` XLA fuses that work into a few
fusions; in plain torch it is some hundreds of elementwise kernels). Any
other device goes to `shade_cuda`, which launches `csrc/shade.cu` once:
one thread a lane, only the branch the lane's refltype needs. Nothing
falls back: a CUDA call that cannot build or launch the kernel raises.

The kernel reads a lane's material from its id (`mat_id`, the ids that
`mat` was gathered by in `tracer/wavefront.py: gather_material`) and the
scene's (M,31) `mat_table`, which all lanes share, not from the [N,31]
per-lane columns. It gives the plain version's bits on the card: every
sum and product is rounded where the plain version's separate torch
kernels round it (see the note at the top of csrc/shade.cu). It does not
return aux["u"], which nothing reads.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.vecmath import normalize, reflect
from ..core.rng import RaySampler
from ..scene.config import (
    MAT_EMIT, MAT_GLASS, MAT_REFL, MAT_DIFF_REFL, MAT_FRESNEL, MAT_NULL,
    MAT_SUBSURFACE,
)
from ..materials.bsdf import (
    lambertian_sample, specular_glass_sample, ggx_reflection_sample,
    rough_glass_sample, microfacet_interface_sample, fresnel_blend_sample,
)
from .checks import require

MAT_COLS = 31

# Launches of the kernel, counted where the wrapper launches it and
# nowhere else; set back to 0 by whoever reads them.
LAUNCHES = {"shade": 0}


def shade_plain(scene, settings, rng, raydir, n, nl, into, mat, objcol):
    """Evaluate every material branch and select by refltype; six RNG draws
    per lane, in the JAX package's order.

    Returns (rng, next_dir, mask_mul [N,3], offset_steps [N], terminate [N],
    bounce_inc [N], aux)."""
    N = raydir.shape[0]
    rng, (u1, u2, u3, u4, u5, u6) = RaySampler.next_n(rng, 6)
    refl_t = mat["refltype"]
    one3 = torch.ones((N, 3), dtype=torch.float32, device=raydir.device)

    # MAT_DIFF
    d_dir = lambertian_sample(u1, u2, nl)
    d_mul = mat["kd"][:, None] * objcol
    # MAT_REFL; a mirror offsets twice (reference quirk kept)
    mirror = mat["alphax"] == 0.0
    mir_dir = normalize(reflect(raydir, n))
    g_dir, g_beta = ggx_reflection_sample(
        u1, u2, raydir, nl, mat["tangent"], mat["F0"],
        mat["alphax"], mat["alphay"])
    r_dir = torch.where(mirror[:, None], mir_dir, g_dir)
    r_mul = torch.where(mirror[:, None],
                        mat["ks"][:, None] * objcol,
                        mat["ks"][:, None] * g_beta * objcol)
    r_off = torch.where(mirror, 2.0, 1.0)
    # MAT_DIFF_REFL
    dr_spec = u5 < mat["ks"] / torch.clamp_min(mat["ks"] + mat["kd"], 1e-7)
    dr_dir = torch.where(dr_spec[:, None], g_dir, d_dir)
    dr_mul = torch.where(dr_spec[:, None], g_beta, objcol)
    # MAT_FRESNEL
    f_dir, f_beta = fresnel_blend_sample(
        u1, u2, u3, raydir, nl, mat["kd"][:, None] * objcol, mat["F0"],
        mat["alphax"])
    # MAT_GLASS
    sg_dir, sg_refl = specular_glass_sample(u1, into, raydir, nl,
                                            mat["etaT"])
    rg_dir, rg_beta, rg_refl = rough_glass_sample(
        u1, u2, into, raydir, nl, mat["etaT"], mat["alphax"])
    smooth = mat["alphax"] == 0.0
    gl_refl = torch.where(smooth, sg_refl, rg_refl)
    gl_dir = torch.where(smooth[:, None], sg_dir, rg_dir)
    eta2 = mat["etaT"] * mat["etaT"]
    rg_mul = rg_beta[:, None] * objcol \
        * torch.where((~rg_refl & ~into)[:, None], eta2[:, None], 1.0)
    gl_mul = torch.where(smooth[:, None], one3, rg_mul)
    gl_off = torch.where(gl_refl, 1.0, -1.0)
    # MAT_SUBSURFACE entry interface
    ss_m, ss_rdir, ss_beta, ss_refl = microfacet_interface_sample(
        u1, u2, into, raydir, nl, mat["etaT"], mat["alphax"])
    ss_refl_mul = ss_beta[:, None] * mat["ks"][:, None] * objcol

    def sel(t):
        return (refl_t == t)[:, None]

    next_dir = d_dir
    next_dir = torch.where(sel(MAT_REFL), r_dir, next_dir)
    next_dir = torch.where(sel(MAT_DIFF_REFL), dr_dir, next_dir)
    next_dir = torch.where(sel(MAT_FRESNEL), f_dir, next_dir)
    next_dir = torch.where(sel(MAT_GLASS), gl_dir, next_dir)
    next_dir = torch.where(sel(MAT_SUBSURFACE), ss_rdir, next_dir)
    next_dir = torch.where(sel(MAT_NULL), raydir, next_dir)

    mask_mul = d_mul
    mask_mul = torch.where(sel(MAT_REFL), r_mul, mask_mul)
    mask_mul = torch.where(sel(MAT_DIFF_REFL), dr_mul, mask_mul)
    mask_mul = torch.where(sel(MAT_FRESNEL), f_beta, mask_mul)
    mask_mul = torch.where(sel(MAT_GLASS), gl_mul, mask_mul)
    mask_mul = torch.where(sel(MAT_SUBSURFACE), ss_refl_mul, mask_mul)
    mask_mul = torch.where(sel(MAT_NULL), one3, mask_mul)

    offset = torch.ones((N,), dtype=torch.float32, device=raydir.device)
    offset = torch.where(refl_t == MAT_REFL, r_off, offset)
    offset = torch.where(refl_t == MAT_DIFF_REFL, 0.0, offset)
    offset = torch.where(refl_t == MAT_FRESNEL, 0.0, offset)
    offset = torch.where(refl_t == MAT_GLASS, gl_off, offset)
    offset = torch.where(refl_t == MAT_SUBSURFACE, 1.0, offset)
    offset = torch.where(refl_t == MAT_NULL, -1.0, offset)

    terminate = refl_t == MAT_EMIT
    is_specular_event = (
        (refl_t == MAT_REFL)
        | ((refl_t == MAT_DIFF_REFL) & dr_spec)
        | (refl_t == MAT_FRESNEL)
        | (refl_t == MAT_GLASS)
        | ((refl_t == MAT_SUBSURFACE) & ss_refl))
    bounce_inc = is_specular_event.to(torch.int32)

    aux = {
        "glass_refract": (refl_t == MAT_GLASS) & ~gl_refl,
        "ss_refract": (refl_t == MAT_SUBSURFACE) & ~ss_refl,
        "ss_normal": ss_m,
        "u": (u1, u2, u3, u4, u5, u6),
    }
    return rng, next_dir, mask_mul, offset, terminate, bounce_inc, aux


def shade(scene, settings, rng, raydir, n, nl, into, mat, objcol, *,
          mat_id=None):
    """The BSDF draw: `shade_plain` for CPU tensors, the kernel for any
    other device (see the module docstring). The arguments and returns of
    shade_plain, and mat_id: the [N] int32 material ids that `mat` was
    gathered by, which the kernel reads in its place (with
    scene["mat_table"]); the CPU does not need it. On the kernel's path
    aux holds glass_refract, ss_refract and ss_normal."""
    if raydir.device.type == "cpu":
        return shade_plain(scene, settings, rng, raydir, n, nl, into, mat,
                           objcol)
    return shade_cuda(scene, rng, raydir, n, nl, into, mat_id, objcol)


def _kernel():
    from ..utils.cuda_build import load
    fn = load("shade").tpt_shade
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [i64, p, p, i64, p, i64, p, i64, p, p, p,
                       ctypes.c_int32, p, i64, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _row_stride(t, name, device, N):
    """The row stride of a [N,3] f32 input whose three floats of a row
    are adjacent (a column view of a wider table, as mat["objcol"], is
    read in place). An empty input may have any strides: nothing is
    read."""
    if not isinstance(t, torch.Tensor) or t.device != device or \
            t.dtype != torch.float32 or tuple(t.shape) != (N, 3) or \
            (N and t.stride(1) != 1):
        raise ValueError("%s must be a [%d,3] float32 tensor on %s with "
                         "adjacent columns" % (name, N, device))
    return t.stride(0)


def _prepare(scene, rng, raydir, n, nl, into, mat_id, objcol):
    """Check the inputs and allocate the outputs. Returns (args of
    tpt_shade without the stream, outputs)."""
    device = raydir.device
    if device.type != "cuda":
        raise ValueError("shade kernel: tensors are on %s, not a CUDA "
                         "device" % device)
    if mat_id is None:
        raise ValueError("shade kernel: mat_id, the ids the material was "
                         "gathered by, is required on a CUDA device")
    N = raydir.shape[0]
    table = scene["mat_table"]
    require(rng, "rng", device, torch.int64, (N,))
    require(into, "into", device, torch.bool, (N,))
    require(mat_id, "mat_id", device, torch.int32, (N,))
    require(table, "mat_table", device, torch.float32,
            (table.shape[0], MAT_COLS))
    s_dir = _row_stride(raydir, "raydir", device, N)
    s_n = _row_stride(n, "n", device, N)
    s_nl = _row_stride(nl, "nl", device, N)
    s_obj = _row_stride(objcol, "objcol", device, N)
    f32 = dict(dtype=torch.float32, device=device)
    b = dict(dtype=torch.bool, device=device)
    out = (torch.empty((N,), dtype=torch.int64, device=device),
           torch.empty((N, 3), **f32), torch.empty((N, 3), **f32),
           torch.empty((N,), **f32), torch.empty((N,), **b),
           torch.empty((N,), dtype=torch.int32, device=device),
           torch.empty((N,), **b), torch.empty((N,), **b),
           torch.empty((N, 3), **f32))
    args = (N, rng.data_ptr(), raydir.data_ptr(), s_dir, n.data_ptr(), s_n,
            nl.data_ptr(), s_nl, into.data_ptr(), mat_id.data_ptr(),
            table.data_ptr(), table.shape[0], objcol.data_ptr(), s_obj,
            *(t.data_ptr() for t in out))
    return args, out


def _returns(out):
    rng, next_dir, mask_mul, offset, term, binc, glass_r, ss_r, ss_n = out
    return rng, next_dir, mask_mul, offset, term, binc, {
        "glass_refract": glass_r, "ss_refract": ss_r, "ss_normal": ss_n}


def shade_cuda(scene, rng, raydir, n, nl, into, mat_id, objcol):
    """Launch csrc/shade.cu on CUDA tensors (current stream; no host read,
    so the launch can be captured in a CUDA graph). Returns as shade."""
    fn = _kernel()
    args, out = _prepare(scene, rng, raydir, n, nl, into, mat_id, objcol)
    if args[0]:
        with torch.cuda.device(raydir.device):
            stream = torch.cuda.current_stream(raydir.device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError("shade kernel launch failed: CUDA error %d"
                               % err)
        LAUNCHES["shade"] += 1
    return _returns(out)


def launch_fn(scene, rng, raydir, n, nl, into, mat_id, objcol):
    """The bare launch, for timing the kernel alone: checks shade_cuda's
    arguments (CUDA tensors on the current device) and allocates the
    outputs once, then returns a function of no arguments that launches
    the kernel into them and returns them as shade does, raising on a
    nonzero code. Its launches are not counted in LAUNCHES."""
    if raydir.device.type != "cuda" or \
            raydir.device.index != torch.cuda.current_device():
        raise ValueError("launch_fn: raydir must lie on the current CUDA "
                         "device, not %s" % raydir.device)
    fn = _kernel()
    args, out = _prepare(scene, rng, raydir, n, nl, into, mat_id, objcol)
    stream = torch.cuda.current_stream(raydir.device).cuda_stream

    def launch():
        if args[0]:
            err = fn(*args, stream)
            if err != 0:
                raise RuntimeError("shade kernel launch failed: CUDA error "
                                   "%d" % err)
        return _returns(out)
    return launch


def io_bytes(mat, bounce_inc, n_mats):
    """Bytes the function must move, each input read once and each output
    written once, counted lane by lane from what the lane's branch reads
    (it depends on the data). Every lane reads rng 8, mat_id 4 and nl 12
    (ss_normal is drawn about nl on every lane) and writes 55: rng 8,
    next_dir 12, mask_mul 12, offset 4, terminate 1, bounce_inc 4,
    glass_refract 1, ss_refract 1, ss_normal 12. Beside those a lane reads
    raydir 12 unless it takes the diffuse draw (refltypes outside 2..7,
    and diffuse+specular's diffuse half, bounce_inc 0); n 12 on a mirror;
    into 1 on glass and subsurface; objcol 12 unless it is null, smooth
    glass or diffuse+specular's specular half. The table is read once: the
    12 columns the kernel reads of each of its n_mats rows. mat:
    gather_material's columns of the lanes; bounce_inc: the function's
    output on them."""
    t = mat["refltype"]
    alphax = mat["alphax"]
    specular = bounce_inc != 0
    diff_refl = t == MAT_DIFF_REFL
    diffuse_draw = (t < MAT_GLASS) | (t > MAT_SUBSURFACE) \
        | (diff_refl & ~specular)
    no_objcol = (t == MAT_NULL) | ((t == MAT_GLASS) & (alphax == 0.0)) \
        | (diff_refl & specular)
    per_lane = (8 + 4 + 12 + 55) * t.numel() \
        + 12 * int((~diffuse_draw).sum()) \
        + 12 * int(((t == MAT_REFL) & (alphax == 0.0)).sum()) \
        + int(((t == MAT_GLASS) | (t == MAT_SUBSURFACE)).sum()) \
        + 12 * int((~no_objcol).sum())
    return per_lane + 4 * 12 * n_mats
