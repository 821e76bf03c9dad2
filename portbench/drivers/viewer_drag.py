"""Traffic `viewer_drag`: the terminal viewer's user dragging the camera,
a closed loop of `ViewerSession.step` (tpu_pathtracer_torch/tools/
interactive.py) at the configuration's resolution with a preview at
1/`preview_div` and `batch` samples a converging step. Each step carries
one left-drag mouse report, so every step renders a 1-spp preview, reads
it back as uint8 and repeats its pixels up to the full size. The drag is
the closed cycle `moves` of (dx, dy) terminal cells around the
configuration's camera, entered at a phase drawn from the seed: every seed
visits the same views in the same cyclic order, so every seed has the same
work. The session's camera
file goes to a directory under TMPDIR, removed at the end. The window's
session is one past its timed snapshots (output5.ppm and output50.ppm,
full-size readbacks and disk writes 5 s and 50 s after a session opens,
once each): the drag of a session that has been open a while.

drag_step_ms = the window's time over its steps; drag_p95_ms = the 95th
percentile of the steps' times from the drag report to the full-size
uint8 image in host memory. The seed draws `check_pixels` full-size pixel
positions, read from every step's image, and `check_steps` of the
window's steps whose pixels are compared with the reference's preview
pixel, tonemapped."""
from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import check, program, scenes
from portbench.camera import Orbit
from portbench.reference import render as ref


def _mouse(kind, x, y):
    return ("MOUSE", kind, 0, False, int(x), int(y))


def plan(traffic, config, seed):
    """What the seed draws: the phase k at which the drag enters the cycle
    (the starting camera is the configuration's moved by the cycle's first
    k moves, and the moves run from the k-th on, around), the compared
    full-size pixels (sx, sy), and the generator that later picks the
    compared steps."""
    rng = np.random.default_rng(seed)
    moves = np.asarray(traffic["moves"], np.int64)
    if moves.sum(0).tolist() != [0, 0]:
        raise ValueError("the drag moves must sum to zero (a closed cycle)")
    k = int(rng.integers(len(moves)))
    orbit0 = Orbit(**config["camera"])
    for dx, dy in moves[:k]:
        orbit0.drag(int(dx), int(dy))
    moves = np.roll(moves, -k, axis=0)
    K = int(traffic["check_pixels"])
    sx = rng.integers(0, config["width"], K)
    sy = rng.integers(0, config["height"], K)
    return {"orbit": orbit0, "moves": moves, "sx": sx, "sy": sy, "rng": rng}


def camera_track(orbit0, moves, n, width, height):
    """The preview camera vectors of n drag steps from orbit0."""
    orbit = Orbit(**vars(orbit0))
    cams = []
    for i in range(n):
        dx, dy = moves[i % len(moves)]
        orbit.drag(int(dx), int(dy))
        cams.append(orbit.vector(width, height))
    return cams


def pick_steps(rng, n, traffic):
    return np.sort(rng.choice(n, min(int(traffic["check_steps"]), n),
                              replace=False))


def run(ctx):
    p, cfg = ctx.traffic, ctx.config
    drawn = plan(p, cfg, ctx.seed)
    orbit0, moves, sx, sy = (drawn[k] for k in ("orbit", "moves", "sx",
                                                 "sy"))
    W, H = cfg["width"], cfg["height"]
    div = int(p["preview_div"])

    inputs = scenes.make_inputs(cfg)
    r, parts = program.build_renderer(cfg, inputs, ctx.device, ctx.cache_dir)
    lo = program.preview_renderer(r, parts, div)
    out_dir = tempfile.mkdtemp(prefix="portbench_viewer_")
    try:
        x, y = 500, 300
        warm = program.viewer_session(
            r, program.interactive_camera(orbit0, W, H), lo,
            p["batch"], out_dir)
        for i in range(int(p["warmup_steps"])):
            dx, dy = moves[i % len(moves)]
            warm.step(([_mouse("press", x, y)] if i == 0 else [])
                      + [_mouse("drag", x + dx, y + dy)])
            x, y = x + dx, y + dy
        del warm
        # the window's session, past its timed snapshots: a drag in a
        # session that has been open a while
        sess = program.viewer_session(
            r, program.interactive_camera(orbit0, W, H), lo, p["batch"],
            out_dir, snapshots_written=True)
        spans = {"render": [], "step": []}
        if ctx.trace:
            plain = lo.render_frames

            def timed(*a, **k):
                t = time.perf_counter()
                res = plain(*a, **k)
                ctx.sync()
                spans["render"].append((t, time.perf_counter()))
                return res
            lo.render_frames = timed
        lat, seen = [], []
        x, y = 500, 300

        def step(i):
            nonlocal x, y
            dx, dy = moves[i % len(moves)]
            ev = ([_mouse("press", x, y)] if i == 0 else []) \
                + [_mouse("drag", x + dx, y + dy)]
            x, y = x + dx, y + dy
            t = time.perf_counter()
            img = sess.step(ev)
            te = time.perf_counter()
            lat.append(te - t)
            spans["step"].append((t, te))
            seen.append(img[sy, sx])
            return img

        ctx.window_opens()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < ctx.seconds:
            step(n)
            n += 1
        t1 = time.perf_counter()
        metrics = {"drag_step_ms": (t1 - t0) * 1e3 / n,
                   "drag_p95_ms": float(np.percentile(lat, 95)) * 1e3}
        traced = {}
        if ctx.trace:
            traced = {"loop": "drag", "spans": dict(spans)}

            def more():
                for j in range(int(p["trace_steps"])):
                    step(n + j)
            events, _ = ctx.profile(more)
            traced.update(events=events, window="portbench_window")
        peak = torch.cuda.max_memory_allocated(ctx.device) \
            if ctx.device.type == "cuda" else 0
        del sess, r, lo, parts
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ctx.free_device()

    # ---- the comparison: sampled steps' pixels against the reference ----
    picked = pick_steps(drawn["rng"], len(seen), p)
    cams = camera_track(orbit0, moves, len(seen), W // div, H // div)
    got = np.stack([seen[i] for i in picked])
    t = time.perf_counter()
    want = reference_pixels(inputs, cfg, [cams[i] for i in picked], sx, sy,
                            div, ctx.device)
    return {"metrics": metrics, "attempted": n, "failed": 0,
            "memory_peak_bytes": peak, "traced": traced,
            "numbers": check.image_numbers(got, want),
            "reference_s": time.perf_counter() - t}


def reference_pixels(inputs, cfg, cams, sx, sy, div, device,
                     dtype=torch.float32):
    """[S,K,3] uint8: for each camera vector (the preview's) the reference's
    1-spp preview at the full-size pixels (sx, sy), tonemapped. A preview
    is the first frame of a fresh accumulation (frame 1), its pixel (x, y)
    shown at the full-size pixels (div x + i, div y + j)."""
    mesh, mats, env, tex = inputs
    sc = ref.Scene(mesh, mats, env, tex, device, dtype,
                   settings=cfg.get("settings"))
    w, h = cfg["width"] // div, cfg["height"] // div
    S, K = len(cams), len(sx)
    lanes = ref.lane_of_pixel(torch.as_tensor(sx // div),
                              torch.as_tensor(sy // div), w, h).to(device)
    cam = torch.as_tensor(np.repeat(np.stack(cams), K, axis=0),
                          device=device)
    L = ref.trace_paths(sc, cam, w, h,
                        torch.ones(S * K, dtype=torch.int64, device=device),
                        lanes.repeat(S)).float()
    x = torch.clamp(L, 0.0, 1.0)
    u8 = (torch.pow(x, 1.0 / 2.2) * 255.0 + 0.5).to(torch.uint8)
    return u8.view(S, K, 3).cpu().numpy()
