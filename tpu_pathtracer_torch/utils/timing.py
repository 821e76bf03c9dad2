"""Timing: kernel times on the card (`cuda_ms`), `synchronize` for host
clocks around device work, and wall-clock telemetry for the CLI (`Timer`,
`RateMeter`, as the JAX package's utils/timing.py)."""
from __future__ import annotations

import time

import torch


def synchronize(device):
    """Wait for a CUDA device's queued work; a no-op for the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self.t0


class RateMeter:
    """Counts frames and camera samples and prints 'time, frames, ms/frame,
    FPS, Mpaths/s' at most once per interval (the reference's stats line,
    src/main.cpp:204-209, plus paths per second; bounce and shadow rays are
    not counted here). A report first synchronizes `device`, once a
    report and not once a tick, so its time covers the frames the device
    has finished, not only those the host has queued: ms/frame is the
    device's rate."""

    def __init__(self, device, interval=1.0):
        self.device = torch.device(device)
        self.interval = interval
        self.timer = Timer()
        self.last_report = 0.0
        self.frames = 0
        self.rays = 0

    def tick(self, paths, out=print, frames=1):
        """Count `frames` frames (one call's) and their `paths` camera
        samples; report when an interval has passed."""
        self.frames += int(frames)
        self.rays += int(paths)
        if self.timer.elapsed() - self.last_report < self.interval:
            return
        synchronize(self.device)
        el = self.timer.elapsed()
        out("time %.1fs, frames %d, %.2f ms/frame, %.1f FPS, %.2f Mpaths/s"
            % (el, self.frames, 1000.0 * el / self.frames, self.frames / el,
               self.rays / el / 1e6))
        self.last_report = el
