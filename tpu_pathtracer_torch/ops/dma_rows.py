"""Row gather and row scatter of an f32 table by int32 indices, CUDA kernel
on the card (port of tools/probe_dma.py: make_dma_gather, make_dma_scatter).

The factories keep the JAX names and what the functions compute. A CUDA
tensor goes to the kernels in `csrc/dma_rows.cu` (see the note at its
top), a CPU tensor to the plain PyTorch versions below. Nothing falls
back: a CUDA call that cannot build or launch the kernel raises.

`chunk` and `window` set the TPU kernel's DMA pipeline (rows per grid step,
DMAs in flight). They are checked as there, with one change: JAX's
`grid = P // chunk` leaves a tail of P % chunk rows unwritten, so
P % chunk != 0 raises here. Beyond the checks they change nothing.
Indices are int32 only, as in JAX, and are checked to lie in range; that
check reads two integers back to the host, one sync per call, which a
probe can afford. `gather_rows_cuda` / `scatter_rows_cuda` are the bare
launches behind the factories' functions, without the range check, for a
caller that has checked its (tab, idx) once and then times the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .checks import require

FLAT_COLS = 16        # C == 0: a flat (P*16,) table of 16-float rows

# Launches of each kernel, counted where the wrapper launches it and
# nowhere else; set back to 0 by whoever reads them.
LAUNCHES = {"dma_gather": 0, "dma_scatter": 0}


def gather_rows_plain(rows, idx, batch=1):
    """Plain version of the gather: out[j] = rows[idx[(j // batch) * batch]
    + j % batch] for rows (P, C) and idx (P,) int32."""
    src = idx.long()
    if batch > 1:
        j = torch.arange(rows.shape[0], device=rows.device)
        src = src[(j // batch) * batch] + j % batch
    return rows[src]


def scatter_rows_plain(rows, idx):
    """Plain version of the scatter: out[idx[j]] = rows[j]; rows that no
    index names are left unset (torch.empty), as in the kernel."""
    out = torch.empty_like(rows)
    out[idx.long()] = rows
    return out


def _check_schedule(P, C, chunk, window, batch):
    if P < 1 or C < 0:
        raise ValueError("need P >= 1 and C >= 0, got P=%d, C=%d" % (P, C))
    if P >= 2 ** 31:
        raise ValueError("P=%d exceeds int32 indexing" % P)
    if chunk < 1 or window < 1 or batch < 1:
        raise ValueError("chunk, window and batch must be >= 1, got %d, %d, "
                         "%d" % (chunk, window, batch))
    if chunk % batch:
        raise ValueError("chunk %% batch must be 0 (chunk=%d, batch=%d)"
                         % (chunk, batch))
    if P % chunk:
        raise ValueError("P %% chunk must be 0 (P=%d, chunk=%d): the TPU "
                         "kernel's grid P // chunk leaves the tail unwritten"
                         % (P, chunk))


def _check_range(idx, step, hi):
    """Every index the function reads (idx[::step]) lies in [0, hi]."""
    mn, mx = torch.stack(torch.aminmax(idx[::step])).tolist()  # host read
    if mn < 0 or mx > hi:
        raise IndexError("index out of range: indices span [%d, %d], "
                         "allowed [0, %d]" % (mn, mx, hi))


def _rows(tab, idx, P, C):
    """Check tab and idx; return tab as (P, cols) rows."""
    device = tab.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % device)
    require(tab, "tab", device, torch.float32,
            (P * FLAT_COLS,) if C == 0 else (P, C))
    require(idx, "idx", device, torch.int32, (P,))
    return tab.view(P, FLAT_COLS if C == 0 else C)


def _kernel(name):
    from ..utils.cuda_build import load
    fn = getattr(load("dma_rows"), name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p, p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                        p] if name == "tpt_gather_rows" else
                       [p, p, p, ctypes.c_int64, ctypes.c_int, p])
        fn.restype = ctypes.c_int
    return fn


def _launch(name, rows, idx, *extra):
    P, cols = rows.shape
    if rows.device.type != "cuda":
        raise ValueError("%s: rows are on %s, not a CUDA device"
                         % (name, rows.device))
    require(rows, "rows", rows.device, torch.float32, (P, cols))
    require(idx, "idx", rows.device, torch.int32, (P,))
    out = torch.empty_like(rows)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = _kernel(name)(rows.data_ptr(), idx.data_ptr(), out.data_ptr(),
                            P, cols, *extra, stream)
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, err))
    return out


def gather_rows_cuda(rows, idx, batch=1):
    """Launch the gather kernel on CUDA rows (P, C) f32 and idx (P,) int32;
    indices are NOT range-checked here."""
    out = _launch("tpt_gather_rows", rows, idx, int(batch))
    LAUNCHES["dma_gather"] += 1
    return out


def scatter_rows_cuda(rows, idx):
    """Launch the scatter kernel on CUDA rows (P, C) f32 and idx (P,)
    int32; indices are NOT range-checked here."""
    out = _launch("tpt_scatter_rows", rows, idx)
    LAUNCHES["dma_scatter"] += 1
    return out


def make_dma_gather(P, C, chunk=2048, window=16, batch=1):
    """Returns gather(tab, idx) -> out with out[j] = tab[idx[j]] for a
    (P, C) f32 table and (P,) int32 indices; C == 0 is the flat form, a
    (P*16,) table of 16-float rows, returned flat. batch=G copies rows
    idx[j*G] + k to out[j*G + k] for k < G (the run-batched form: only
    every G-th index is read, and runs need not hold)."""
    _check_schedule(P, C, chunk, window, batch)

    def gather(tab, idx):
        rows = _rows(tab, idx, P, C)
        _check_range(idx, batch, P - batch)
        if rows.device.type == "cuda":
            out = gather_rows_cuda(rows, idx, batch)
        else:
            out = gather_rows_plain(rows, idx, batch)
        return out.reshape(tab.shape)

    return gather


def make_dma_scatter(P, C, chunk=2048, window=16):
    """Returns scatter(tab, idx) -> out with out[idx[j]] = tab[j] for a
    (P, C) f32 table and (P,) int32 indices: a permutation write. Rows
    that no index names are left unset; duplicate indices are undefined,
    as in JAX."""
    _check_schedule(P, C, chunk, window, 1)
    if C == 0:
        raise ValueError("make_dma_scatter takes a (P, C) table, C >= 1")

    def scatter(tab, idx):
        rows = _rows(tab, idx, P, C)
        _check_range(idx, 1, P - 1)
        if rows.device.type == "cuda":
            return scatter_rows_cuda(rows, idx)
        return scatter_rows_plain(rows, idx)

    return scatter
