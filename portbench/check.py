"""The comparison that decides `correct`: the numbers each kind of cell
compares between what the timed path produced and the plain reference
(portbench/reference/), and each number's limit, read from
portbench/limits/<cell>.json ({number: limit}; a number not named there
is printed but not compared). PERF.md gives the readings each limit was
set from."""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def render_numbers(got, want):
    """got, want: [K,3] float64, each sampled pixel's sum over the frames
    of the run. A pixel's gap is the L1 distance of the two sums over the
    L1 norm of the reference's. Returns the gaps' median, 90th percentile
    and largest, and the share of pixels whose gap is over 1%."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    gap = np.abs(got - want).sum(1) / np.maximum(np.abs(want).sum(1), 1e-12)
    gap = np.where(np.isfinite(gap), gap, np.inf)
    return {"gap_p50": float(np.median(gap)),
            "gap_p90": float(np.percentile(gap, 90)),
            "gap_max": float(gap.max()),
            "far_share": float(np.mean(gap > 0.01))}


def image_numbers(got, want):
    """got, want: [..., 3] uint8 pixels of the images the timed path
    returned and of the reference's tonemap. Returns the share of pixels
    with a channel more than one step off, and the largest step."""
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    d = d.reshape(-1, 3).max(1)
    return {"off_share": float(np.mean(d > 1)), "max_step": float(d.max())}


def limits(cell, root=os.path.dirname(HERE)):
    with open(os.path.join(root, "portbench", "limits", cell + ".json")) as f:
        return json.load(f)


def judge(numbers, lims):
    """(correct, {name: [value, limit]}) over the compared numbers; a
    number missing or not finite fails."""
    shown = {}
    ok = bool(lims)
    for name, lim in lims.items():
        v = numbers.get(name)
        shown[name] = [v, lim]
        if v is None or not np.isfinite(v) or v > lim:
            ok = False
    return ok, shown
