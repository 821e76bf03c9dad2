"""Row gather / scatter probe (port of tools/probe_dma.py).

    python -m tpu_pathtracer_torch.tools.probe_dma [--device cuda]
        [--rows 1048576] [--reps 20]

Times the hand-written row gather and scatter (`ops/dma_rows.py`,
`csrc/dma_rows.cu`) on the JAX probe's cases, at P = 1,048,576 rows:

  wide_perm   (P,128) table, random permutation indices
  wide_const  (P,128), every index 0 (one row read over and over)
  wide_sort   (P,128), indices in order (a straight copy)
  run8_batch  (P,128), runs of 8 consecutive rows, batch=8
  wide_scat   (P,128) scatter out[idx[j]] = tab[j] by a permutation
  flat_perm   flat (P*16,) table, random permutation: the regen pool's
              row width (16 f32), so the shape of its compaction permute
  flat_sort   flat, indices in order
  flat_run8b  flat, runs of 8, batch=8

The flat form runs always: on the TPU it was a Mosaic dead end behind
--flat, on the card it is the pool's row. Each case is first held to its
plain version through the factory's function (exact equality: pure data
movement), then its kernel launch (`gather_rows_cuda`/`scatter_rows_cuda`,
without the wrapper's one host read for the range check) is timed with
CUDA events over --reps launches, and printed with ns per index and its
share of the byte bound (`bound_bytes`: each distinct source row read
once, each output row written once, and the indices the function reads,
at 3.35 TB/s). `torch.index_select` at (P,16) is timed as a yardstick;
the port never calls it.

--device cuda (the default) needs a card and fails without one; it never
falls back. --device cpu runs the cases on the plain versions at
P = 16,384 and times nothing.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import dma_rows
from ..utils.timing import cuda_ms

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory

# name, C (0 = flat), indices, batch, op
CASES = (
    ("wide_perm", 128, "perm", 1, "gather"),
    ("wide_const", 128, "const", 1, "gather"),
    ("wide_sort", 128, "sort", 1, "gather"),
    ("run8_batch", 128, "run8", 8, "gather"),
    ("wide_scat", 128, "perm", 1, "scatter"),
    ("flat_perm", 0, "perm", 1, "gather"),
    ("flat_sort", 0, "sort", 1, "gather"),
    ("flat_run8b", 0, "run8", 8, "gather"),
)


def indices(P, kind, seed=0):
    """(P,) int32 indices of one kind, from a numpy seed."""
    g = np.random.default_rng(seed)
    if kind == "perm":
        idx = g.permutation(P)
    elif kind == "sort":
        idx = np.arange(P)
    elif kind == "const":
        idx = np.zeros(P, np.int64)
    elif kind == "run8":
        blk = g.permutation(P // 8)
        idx = (blk[:, None] * 8 + np.arange(8)).reshape(-1)
    else:
        raise ValueError("unknown index kind %r" % (kind,))
    return torch.from_numpy(idx.astype(np.int32))


def table(P, C, device):
    """The probe's table, made on the device: row * 2 + col / 256 for
    (P, C), and arange(P * 16) for the flat form (C == 0)."""
    if C == 0:
        return torch.arange(P * dma_rows.FLAT_COLS, dtype=torch.float32,
                            device=device)
    r = torch.arange(P, dtype=torch.float32, device=device)[:, None]
    c = torch.arange(C, dtype=torch.float32, device=device)[None, :]
    return r * 2.0 + c * (1.0 / 256.0)


def bound_bytes(idx, C, batch):
    """Bytes the function must move on these indices: each distinct source
    row read once, each of the P output rows written once, and the
    P / batch indices it reads (4 bytes each)."""
    P = idx.shape[0]
    cols = C or dma_rows.FLAT_COLS
    starts = idx[::batch].long().cpu()
    src = (starts[:, None] + torch.arange(batch)).reshape(-1)
    n_src = int(torch.unique(src).numel())
    return (n_src + P) * cols * 4 + (P // batch) * 4


def make_fn(P, C, batch, op):
    if op == "scatter":
        return dma_rows.make_dma_scatter(P, C)
    return dma_rows.make_dma_gather(P, C, batch=batch)


def launch_fn(tab, idx, P, C, batch, op):
    """The bare kernel launch of a case whose inputs were checked."""
    rows = tab.view(P, C or dma_rows.FLAT_COLS)
    if op == "scatter":
        return lambda: dma_rows.scatter_rows_cuda(rows, idx)
    return lambda: dma_rows.gather_rows_cuda(rows, idx, batch)


def plain(tab, idx, P, C, batch, op):
    rows = tab.view(P, C or dma_rows.FLAT_COLS)
    if op == "scatter":
        return dma_rows.scatter_rows_plain(rows, idx)
    return dma_rows.gather_rows_plain(rows, idx, batch).reshape(tab.shape)


def run(device, P, reps):
    """Check and (on a card) time each case; returns a list of dicts."""
    timed = torch.device(device).type == "cuda"
    out = []
    tabs = {}
    for name, C, kind, batch, op in CASES:
        if C not in tabs:
            tabs.clear()          # free the 512 MB wide table before the next
            tabs[C] = table(P, C, device)
        tab = tabs[C]
        idx = indices(P, kind).to(device)
        fn = make_fn(P, C, batch, op)
        got = fn(tab, idx)
        want = plain(tab, idx, P, C, batch, op)
        if not torch.equal(got, want):
            raise AssertionError("%s: kernel != plain version" % name)
        rec = {"name": name, "op": op, "rows": P, "cols": C or 16,
               "flat": C == 0, "batch": batch,
               "bound_ms": bound_bytes(idx, C, batch) / HBM_BYTES_PER_S
               * 1e3}
        if timed:
            ms = cuda_ms(launch_fn(tab, idx, P, C, batch, op), reps)
            rec.update(ms=ms, ns_per_idx=ms * 1e6 / P,
                       bound_share=rec["bound_ms"] / ms)
        out.append(rec)
        del got, want
    tabs.clear()
    if timed:
        tab16 = table(P, 0, device).view(P, 16)
        idx = indices(P, "perm").to(device)
        ms = cuda_ms(lambda: torch.index_select(tab16, 0, idx), reps)
        out.append({"name": "index_select_16", "op": "library", "rows": P,
                    "cols": 16, "ms": ms, "ns_per_idx": ms * 1e6 / P,
                    "bound_ms": bound_bytes(idx, 0, 1) / HBM_BYTES_PER_S
                    * 1e3})
    return out


def report(rec):
    if "ms" not in rec:
        return "%-15s equal to the plain version (time not measured: cpu)" \
            % rec["name"]
    share = rec["bound_ms"] / rec["ms"]
    return ("%-15s %8.4f ms  %6.3f ns/idx  bound %.4f ms (%.1f%% of it)"
            % (rec["name"], rec["ms"], rec["ns_per_idx"], rec["bound_ms"],
               100 * share))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=None,
                    help="P (default 1048576 on cuda, 16384 on cpu)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_dma: --device cuda needs a CUDA device "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    P = args.rows or (1 << 20 if args.device == "cuda" else 1 << 14)
    recs = run(args.device, P, args.reps)
    for rec in recs:
        print(report(rec), flush=True)
    dev = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(json.dumps({"device": dev, "rows": P, "cases": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
