"""`packet_intersect`: BVH traversal of the packed stream, CUDA kernel on
the card (port of ops/traverse_packet.py).

The JAX function drives a Pallas TPU packet kernel; here a CUDA tensor goes
to the per-thread kernel in `csrc/traverse.cu` (see the note at its top)
and a CPU tensor to the plain PyTorch version, `tracer.traverse.
intersect_scene`. Nothing falls back: a CUDA call that cannot build or
launch the kernel raises.

The signature and the argument checks are the JAX function's. Arguments
that only choose a TPU schedule (tile_sub, interleave, queue_k, step_mode,
step_unroll, table_mem, anyhit_early_stop, interpret) are checked as
there and then change nothing: every schedule returns the same result.
`count_steps` (a per-packet step census) is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from ..tracer.traverse import intersect_scene

_SMEM_TABLE_BUDGET_BYTES = 700_000
MAX_STACK_DEPTH = 64          # kMaxStack in csrc/traverse.cu

# Launches of each kernel instantiation, counted where the wrapper launches
# it and nowhere else; set back to 0 by whoever reads them.
LAUNCHES = {"traverse_closest": 0, "traverse_anyhit": 0}


def table_fits_smem(n_rows):
    """True when a packed stream of n_rows 14-col f32 rows fits the TPU
    kernel's SMEM table budget (kept for the table_mem checks)."""
    return n_rows * 14 * 4 <= _SMEM_TABLE_BUDGET_BYTES


def _is_scalar(x):
    return not isinstance(x, torch.Tensor) or x.dim() == 0


def _check_args(K, tmin, tmax, active, active_prefix, table_mem, step_mode,
                queue_k, interleave, step_unroll, stack_depth, count_steps):
    if active_prefix is not None:
        if active is not None:
            raise ValueError("pass active or active_prefix, not both")
        if not _is_scalar(tmax):
            raise ValueError("active_prefix requires a scalar tmax")
    if not _is_scalar(tmin):
        raise ValueError("packet_intersect requires a scalar tmin "
                         "(no caller needs a per-lane tmin)")
    if table_mem not in ("auto", "smem", "vmem", "split", "vmem_packed"):
        raise ValueError("unknown table_mem %r (want auto/smem/vmem/"
                         "split/vmem_packed)" % (table_mem,))
    if table_mem in ("split", "vmem_packed") and step_mode != "fused":
        raise ValueError("table_mem='%s' requires step_mode='fused'"
                         % table_mem)
    if table_mem == "smem" and not table_fits_smem(K):
        raise ValueError(
            "table_mem='smem': packed table is %d bytes, over the %d-byte "
            "SMEM budget; use table_mem='auto' or 'vmem'"
            % (K * 14 * 4, _SMEM_TABLE_BUDGET_BYTES))
    if queue_k > interleave and step_mode != "fused":
        raise ValueError("queue_k requires step_mode='fused'")
    if step_unroll < 1:
        raise ValueError("step_unroll must be >= 1, got %d" % step_unroll)
    if not 1 <= stack_depth <= MAX_STACK_DEPTH:
        raise ValueError("stack_depth must be in [1, %d], got %d"
                         % (MAX_STACK_DEPTH, stack_depth))
    if count_steps:
        raise NotImplementedError(
            "count_steps is not ported yet (ROADMAP queue B, item 4)")


def packet_intersect(packed, orig, raydir, tmin, tmax, anyhit=False,
                     stack_depth=64, active=None, active_prefix=None,
                     tile_sub=8, interleave=4,
                     table_mem="auto", step_mode="fused", count_steps=False,
                     queue_k=0, anyhit_early_stop=True, step_unroll=1,
                     interpret=False):
    """Traverse rays [N,3] against the packed (K,16) stream.

    tmin is a scalar; tmax a scalar or [N]. The active set is either a
    mask `active` [N] bool or the lane prefix [0, active_prefix) (an int).
    Returns (hit_slot [N] i32, hit_t [N] f32); lanes outside the active
    set return (-1, tmax). With anyhit=True a lane stops at its first
    accepted hit (callers read only whether t < tmax)."""
    _check_args(packed.shape[0], tmin, tmax, active, active_prefix,
                table_mem, step_mode, queue_k, interleave, step_unroll,
                stack_depth, count_steps)
    N = orig.shape[0]
    if active_prefix is not None:
        active_prefix = int(active_prefix)
    if orig.device.type == "cpu":
        if active_prefix is not None:
            active = torch.arange(N) < active_prefix
        return intersect_scene(None, None, None, orig, raydir, tmin, tmax,
                               anyhit=anyhit, stack_depth=stack_depth,
                               active=active, packed=packed)
    if orig.device.type != "cuda":
        raise ValueError("packet_intersect: unsupported device %s"
                         % orig.device)
    return _launch(packed, orig, raydir, float(tmin), tmax, anyhit,
                   stack_depth, active, active_prefix)


def _require(t, name, device, dtype, shape):
    if not isinstance(t, torch.Tensor):
        raise TypeError("%s must be a tensor" % name)
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (name, t.dtype,
                                                            dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _kernel_fn():
    from ..utils.cuda_build import load
    lib = load("traverse")
    fn = lib.tpt_traverse
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_float, ctypes.c_float, p,
                       ctypes.c_int, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(packed, orig, raydir, tmin, tmax, anyhit, stack_depth, active,
            active_prefix):
    device = orig.device
    N = orig.shape[0]
    K = packed.shape[0]
    _require(packed, "packed", device, torch.float32, (K, 16))
    _require(orig, "orig", device, torch.float32, (N, 3))
    _require(raydir, "raydir", device, torch.float32, (N, 3))
    if N >= 2 ** 31 or K * 4 >= 2 ** 31:
        raise ValueError("packet_intersect: N=%d / K=%d exceed int32 "
                         "indexing" % (N, K))
    tmax_lane = None
    tmax_scalar = 0.0
    if _is_scalar(tmax):
        tmax_scalar = float(tmax)
    else:
        tmax_lane = tmax
        _require(tmax_lane, "tmax", device, torch.float32, (N,))
    if active is not None:
        _require(active, "active", device, torch.bool, (N,))
        n_prefix = 0
    else:
        n_prefix = N if active_prefix is None else max(0, min(active_prefix,
                                                              N))
    slot = torch.empty((N,), dtype=torch.int32, device=device)
    t = torch.empty((N,), dtype=torch.float32, device=device)
    if N == 0:
        return slot, t
    fn = _kernel_fn()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(packed.data_ptr(), orig.data_ptr(), raydir.data_ptr(),
                 tmin, tmax_scalar,
                 tmax_lane.data_ptr() if tmax_lane is not None else None,
                 n_prefix,
                 active.data_ptr() if active is not None else None,
                 N, int(stack_depth), int(bool(anyhit)),
                 slot.data_ptr(), t.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("traverse kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES["traverse_anyhit" if anyhit else "traverse_closest"] += 1
    return slot, t
