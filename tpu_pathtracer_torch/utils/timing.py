"""Kernel timing on the card."""
from __future__ import annotations

import torch


def cuda_ms(fn, reps):
    """Mean ms per call of fn over `reps` calls, by CUDA events around the
    whole run, after one warm-up call and a synchronize."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
