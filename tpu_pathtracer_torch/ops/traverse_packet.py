"""`packet_intersect`: BVH traversal of the packed stream, CUDA kernel on
the card (port of ops/traverse_packet.py).

The JAX function drives a Pallas TPU packet kernel; here a CUDA tensor goes
to the per-thread kernel in `csrc/traverse.cu` (see the note at its top)
and a CPU tensor to the plain PyTorch version, `tracer.traverse.
intersect_scene`. Nothing falls back: a CUDA call that cannot build or
launch the kernel raises.

The signature and the argument checks are the JAX function's. Arguments
that only choose a TPU schedule (tile_sub, interleave, queue_k, step_mode,
step_unroll, anyhit_early_stop, interpret) are checked as there and then
change nothing: every schedule returns the same result.

`table_mem` chooses where the kernel reads the stream's rows from, as it
does on the TPU (`table_plan` holds the choice): "smem" and "split" launch
the instantiations that keep the first S rows (the BFS top of the tree) in
shared memory, "vmem" and "vmem_packed" the ones that read every row
through `__ldg`, "auto" whichever the measurements favour. Residency does
not show in the result: slot, t and steps are the same bits either way, and
on CPU tensors `table_mem` changes nothing.

The live prefix (`active_prefix`) may be a 0-d int32 tensor on the rays'
device, as the Pallas kernel takes a traced int32 by scalar prefetch: the
kernel reads it from device memory and the host never does, so a launch
captured in a CUDA graph follows the prefix that the kernels before it
computed (tracer/regen.py). A lowering to a mask (a per-lane tmax) builds
`arange(N) < prefix` on the device. An int prefix is passed by value.

`count_steps=True` adds the step census, steps [N] i32, as a third output
on both devices (the JAX function's return, `traverse_packet.py:1005`).
It counts per ray: the rows the lane fetched, i.e. the steps in which its
cursor was not SENTINEL; 0 for lanes outside the active set. JAX counts
per packet and stores the packet's count on all its lanes, inactive ones
included. For a packet whose lanes all carry the same ray the two relate
exactly: equal in closest hit; in any hit the port's count is <= JAX's and
equal where the ray misses, because a thread stops at its first accepted
hit while a finished TPU packet still pops one stack entry per step until
its stack is empty (`tests/test_torch_steps.py` holds both). slot and t do
not change with count_steps.
"""
from __future__ import annotations

import ctypes

import torch

from ..tracer.traverse import intersect_scene
from .checks import require

_SMEM_TABLE_BUDGET_BYTES = 700_000
# kMaxStack in csrc/traverse.cu: the deepest tree the builders make
# (accel/bvh.py MAX_DEPTH = 64) plus the 2 that Renderer adds
MAX_STACK_DEPTH = 66
BLOCK = 128                   # kBlock
TABLE_MAX_ROWS = 288          # kTableMaxRows: 12 blocks x 18 KB an SM
# Rows the plan keeps in shared memory: the top 7 levels of the tree. On an
# H100 every table size was slower than none and smaller tables less so
# (1M camera rays on the 177,100-row stream: +11% with 8 rows, +14% with
# 128, +28% with 288; PERF.md, row 6 of the table of TPU kernels), so the
# plan stays well under what fits.
TABLE_ROWS = 128
ROW_BYTES = 64

# Launches of each kernel instantiation, counted where the wrapper launches
# it and nowhere else; set back to 0 by whoever reads them. The `_table`
# names are the instantiations with the stream's first rows in shared
# memory.
LAUNCHES = {"traverse_closest": 0, "traverse_anyhit": 0,
            "traverse_closest_steps": 0, "traverse_anyhit_steps": 0,
            "traverse_closest_table": 0, "traverse_anyhit_table": 0,
            "traverse_closest_table_steps": 0,
            "traverse_anyhit_table_steps": 0}

# Launches, among those above, of the closest-hit form with a mask and a
# per-lane tmax (the BSSRDF probe trace); it shares its instantiations with
# the other closest-hit forms.
FORM_LAUNCHES = {"closest_mask_lane_tmax": 0}

# The warp-step counter of the last counting launch on the card (a 0-d
# int64 tensor on the device), or None.
_last_warp_steps = None


def last_warp_steps():
    """Sum over warps of the passes (the most steps of any of its lanes) of
    the last `count_steps=True` launch on the card: 32 x it is the
    thread-steps the card paid. A 0-d device tensor (reading it syncs);
    None before any such launch."""
    return _last_warp_steps


def table_fits_smem(n_rows):
    """True when a packed stream of n_rows 14-col f32 rows fits the TPU
    kernel's SMEM table budget (kept for the table_mem checks)."""
    return n_rows * 14 * 4 <= _SMEM_TABLE_BUDGET_BYTES


def table_plan(K, N, table_mem):
    """Where a launch of N lanes on a K-row stream reads its rows from:
    (S, block, smem_bytes). S > 0: the first S rows lie in each block's
    shared memory (the kTable instantiations); S = 0: every row comes
    through `__ldg`. Both run BLOCK threads a block, one ray a thread.

    "smem" and "split" ask for the table: S = min(K, TABLE_ROWS), at any N
    (a block copies its rows whatever share of its lanes is active).
    "vmem" and "vmem_packed" ask for `__ldg`. "auto" takes `__ldg`: on an
    H100 the kTable instantiations were slower on every stream, ray set and
    table size measured (PERF.md, row 6 of the table of TPU kernels).
    N = 0 launches nothing and plans no table."""
    if table_mem not in ("auto", "smem", "vmem", "split", "vmem_packed"):
        raise ValueError("unknown table_mem %r (want auto/smem/vmem/"
                         "split/vmem_packed)" % (table_mem,))
    if table_mem in ("smem", "split") and N > 0 and K > 0:
        S = min(int(K), TABLE_ROWS)
        return S, BLOCK, S * ROW_BYTES
    return 0, BLOCK, 0


def _is_scalar(x):
    return not isinstance(x, torch.Tensor) or x.dim() == 0


def _prefix(active_prefix, device):
    """The prefix as the kernel takes it: an int, or a 0-d int32 tensor on
    the rays' device, which is passed on and never read on the host (the
    JAX kernel's traced int32, read by scalar prefetch)."""
    if isinstance(active_prefix, torch.Tensor):
        require(active_prefix, "active_prefix", device, torch.int32, ())
        return active_prefix
    return int(active_prefix)


def _check_args(K, tmin, tmax, active, active_prefix, table_mem, step_mode,
                queue_k, interleave, step_unroll, stack_depth, anyhit):
    if active_prefix is not None:
        if active is not None:
            raise ValueError("pass active or active_prefix, not both")
        # the JAX kernel takes the prefix form only on its closest-hit
        # queue path, which has no per-lane tmax operand; elsewhere the
        # prefix is lowered to a mask (packet_intersect does the same)
        if not _is_scalar(tmax) and queue_k > interleave and not anyhit:
            raise ValueError("active_prefix with queue_k > interleave "
                             "requires a scalar tmax")
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


def packet_intersect(packed, orig, raydir, tmin, tmax, anyhit=False,
                     stack_depth=64, active=None, active_prefix=None,
                     tile_sub=8, interleave=4,
                     table_mem="auto", step_mode="fused", count_steps=False,
                     queue_k=0, anyhit_early_stop=True, step_unroll=1,
                     interpret=False):
    """Traverse rays [N,3] against the packed (K,16) stream.

    tmin is a scalar; tmax a scalar or [N]. The active set is either a
    mask `active` [N] bool or the lane prefix [0, active_prefix): an int,
    or a 0-d int32 tensor on the rays' device that the kernel reads from
    device memory (no host read; a prefix outside [0, N] acts clamped).
    Returns (hit_slot [N] i32, hit_t [N] f32), plus steps [N] i32 with
    count_steps (see the module docstring); lanes outside the active set
    return (-1, tmax, 0). With anyhit=True a lane stops at its first
    accepted hit (callers read only whether t < tmax)."""
    _check_args(packed.shape[0], tmin, tmax, active, active_prefix,
                table_mem, step_mode, queue_k, interleave, step_unroll,
                stack_depth, anyhit)
    N = orig.shape[0]
    if active_prefix is not None:
        active_prefix = _prefix(active_prefix, orig.device)
        if not _is_scalar(tmax):
            active = torch.arange(N, device=orig.device) < active_prefix
            active_prefix = None
    if orig.device.type == "cpu":
        if active_prefix is not None:
            active = torch.arange(N) < active_prefix
        return intersect_scene(None, None, None, orig, raydir, tmin, tmax,
                               anyhit=anyhit, stack_depth=stack_depth,
                               active=active, packed=packed,
                               count_steps=count_steps)
    if orig.device.type != "cuda":
        raise ValueError("packet_intersect: unsupported device %s"
                         % orig.device)
    return _launch(packed, orig, raydir, float(tmin), tmax, anyhit,
                   stack_depth, active, active_prefix, count_steps,
                   table_mem)


def _lib():
    from ..utils.cuda_build import load
    lib = load("traverse")
    if lib.tpt_traverse.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tpt_traverse.argtypes = [p, p, p, f, f, p, i, p, p, i, i, i, i,
                                     p, p, p, p, p]
        lib.tpt_traverse.restype = i
    return lib


def _prepare(packed, orig, raydir, tmin, tmax, anyhit, stack_depth, active,
             active_prefix, count_steps, table_mem, table_rows=None):
    """Check the CUDA arguments and allocate the outputs. Returns (outputs,
    warp-step counter or None, tpt_traverse's arguments or None when N is
    0, the name of the instantiation in LAUNCHES)."""
    device = orig.device
    N = orig.shape[0]
    K = packed.shape[0]
    require(packed, "packed", device, torch.float32, (K, 16))
    require(orig, "orig", device, torch.float32, (N, 3))
    require(raydir, "raydir", device, torch.float32, (N, 3))
    if N >= 2 ** 31 or K * 4 >= 2 ** 31:
        raise ValueError("packet_intersect: N=%d / K=%d exceed int32 "
                         "indexing" % (N, K))
    tmax_lane = None
    tmax_scalar = 0.0
    if _is_scalar(tmax):
        tmax_scalar = float(tmax)
    else:
        tmax_lane = tmax
        require(tmax_lane, "tmax", device, torch.float32, (N,))
    prefix_dev = None
    if active is not None:
        require(active, "active", device, torch.bool, (N,))
        n_prefix = 0
    elif isinstance(active_prefix, torch.Tensor):
        prefix_dev = _prefix(active_prefix, device)
        n_prefix = 0
    else:
        n_prefix = N if active_prefix is None else max(0, min(active_prefix,
                                                              N))
    slot = torch.empty((N,), dtype=torch.int32, device=device)
    t = torch.empty((N,), dtype=torch.float32, device=device)
    steps = torch.empty((N,), dtype=torch.int32, device=device) \
        if count_steps else None
    out = (slot, t, steps) if count_steps else (slot, t)
    planned = table_plan(K, N, table_mem)[0]
    most = min(K, TABLE_MAX_ROWS) if planned else 0
    if table_rows is None:
        table_rows = planned
    elif not 0 <= table_rows <= most:
        raise ValueError("table_rows must be in [0, %d] for table_mem=%r, "
                         "got %d" % (most, table_mem, table_rows))
    name = ("traverse_anyhit" if anyhit else "traverse_closest") \
        + ("_table" if table_rows else "") + ("_steps" if count_steps else "")
    if N == 0:
        return out, None, None, name
    warp_steps = torch.empty((), dtype=torch.int64, device=device) \
        if count_steps else None
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (packed.data_ptr(), orig.data_ptr(), raydir.data_ptr(),
            tmin, tmax_scalar,
            tmax_lane.data_ptr() if tmax_lane is not None else None,
            n_prefix,
            prefix_dev.data_ptr() if prefix_dev is not None else None,
            active.data_ptr() if active is not None else None,
            N, int(stack_depth), int(bool(anyhit)), table_rows,
            slot.data_ptr(), t.data_ptr(),
            steps.data_ptr() if count_steps else None,
            warp_steps.data_ptr() if count_steps else None, stream)
    return out, warp_steps, args, name


def _launch(packed, orig, raydir, tmin, tmax, anyhit, stack_depth, active,
            active_prefix, count_steps, table_mem):
    global _last_warp_steps
    out, warp_steps, args, name = _prepare(
        packed, orig, raydir, tmin, tmax, anyhit, stack_depth, active,
        active_prefix, count_steps, table_mem)
    if args is None:
        return out
    with torch.cuda.device(orig.device):
        err = _lib().tpt_traverse(*args)
    if err != 0:
        raise RuntimeError("traverse kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES[name] += 1
    if not anyhit and active is not None and not _is_scalar(tmax):
        FORM_LAUNCHES["closest_mask_lane_tmax"] += 1
    if count_steps:
        _last_warp_steps = warp_steps
    return out


def launch_fn(packed, orig, raydir, tmin, tmax, anyhit=False,
              stack_depth=64, active=None, active_prefix=None,
              count_steps=False, table_mem="auto", table_rows=None):
    """The bare launch, for timing the kernel alone: checks the arguments
    (CUDA tensors on the current device) and allocates the outputs once,
    then returns a function of no arguments that launches the kernel
    `table_mem` chooses into them through tpt_traverse and returns them,
    raising on a nonzero code. The wrapper's host work stays out of its
    time, and its launches are not counted in LAUNCHES. `table_rows`, for
    probing, keeps another number of rows in shared memory than
    `table_plan` gives: 0 (the `__ldg` kernel) up to min(K, TABLE_MAX_ROWS)
    where the plan has a table, only 0 where it has none."""
    _check_args(packed.shape[0], tmin, tmax, active, active_prefix,
                table_mem, "fused", 0, 4, 1, stack_depth, anyhit)
    if orig.device.type != "cuda" or \
            orig.device.index != torch.cuda.current_device():
        raise ValueError("launch_fn: orig must lie on the current CUDA "
                         "device, not %s" % orig.device)
    if active_prefix is not None:
        active_prefix = _prefix(active_prefix, orig.device)
        if not _is_scalar(tmax):
            active = torch.arange(orig.shape[0], device=orig.device) \
                < active_prefix
            active_prefix = None
    out, _, args, _ = _prepare(packed, orig, raydir, float(tmin), tmax,
                               anyhit, stack_depth, active, active_prefix,
                               count_steps, table_mem, table_rows)
    fn = _lib().tpt_traverse

    def launch():
        if args is not None:
            err = fn(*args)
            if err != 0:
                raise RuntimeError("traverse kernel launch failed: CUDA "
                                   "error %d" % err)
        return out
    return launch
