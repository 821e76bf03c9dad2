"""The medium step's byte bound, counted from what the step has to move
and not from how the program moves it, so that a later implementation
that touches only the lanes inside a medium is credited for it.

A live lane inside a medium at the medium step (the program's counter
`medium_lanes`) reads and writes its origin, direction and throughput
(3 x 12 B, twice: 72 B), reads its hit distance, medium id and bounce
budget `lbn` (4 + 4 + 4 = 12 B), reads and writes its int64 RNG state
(2 x 8 = 16 B), and writes its budget and its scatter flag (4 + 1 = 5 B):
72 + 12 + 16 + 5 = 105 B. Every pool lane of every wave reads its live
flag and its medium id to learn whether it is inside a medium (1 + 4 =
5 B), over sum(width x waves at that width) lanes. The (M,31) material
table is a few rows that stay in L2, and is not counted."""
from __future__ import annotations

from portbench.metrics._roofline import HBM_BYTES_PER_S

MEDIUM_LANE_BYTES = 72 + 12 + 16 + 5
POOL_LANE_BYTES = 1 + 4


def medium_bytes(medium_lanes, waves):
    """Bytes of the medium step over a call: `medium_lanes` live lanes
    inside a medium, summed over its waves, and `waves` {width: waves run
    at that width}."""
    pool = sum(int(w) * int(n) for w, n in waves.items())
    return medium_lanes * MEDIUM_LANE_BYTES + pool * POOL_LANE_BYTES


def medium_bound_s(medium_lanes, waves):
    return medium_bytes(medium_lanes, waves) / HBM_BYTES_PER_S
