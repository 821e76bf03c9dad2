"""The traversal's byte bound: a frozen copy of the bytes half of
`trav_bound_ms` in chip_smoke.py (commit 6acb8e4), read with the counts a
render exposes. A launch reads each traced ray's origin and direction (24
bytes) and writes its slot and distance (8), and reads the (K,16) f32
stream once (64 bytes a row). The program counts the traced rays over a
call (extension and NEE shadow rays, `render_frames(..., with_stats=True)`)
but not the lanes a masked launch skips, nor the BSSRDF probes' rays, so
the bound counts fewer bytes than a launch moves and the share it gives is
a lower bound."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # one H100 SXM, NVIDIA's data sheet, at 700 W
RAY_BYTES = 24 + 8
ROW_BYTES = 64


def traversal_bytes(rays, launches, stream_rows):
    return rays * RAY_BYTES + launches * stream_rows * ROW_BYTES


def traversal_bound_s(rays, launches, stream_rows):
    return traversal_bytes(rays, launches, stream_rows) / HBM_BYTES_PER_S
