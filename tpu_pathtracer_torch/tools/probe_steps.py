"""Step census of the mid-frame ray population (port of tools/probe_steps.py).

    python -m tpu_pathtracer_torch.tools.probe_steps [--device cuda]
        [--size 1024] [--waves 1,3] [--spp 4]
        [--scene testobj|large|organic_sss|organic_media]
        [--table-mem auto|smem|split|vmem|vmem_packed[,...]]

For each k in --waves it freezes the regen pool of the chosen scene (the
default TestObj scene, the ~135k-triangle large scene, or the
~105k-triangle organic blob with its subsurface or its jade-medium
material; the first run builds the big scenes' SBVH into the cache) after
k waves (`Renderer.regen_integrator(stop_after_waves=k)`), traces
the pool's rays once with `count_steps=True` under the mask `active`, in
closest hit (the extension trace) and in any hit (the form of the NEE
shadow trace, on the same rays), and prints steps per ray: mean, p50, p95
and max over the active lanes.

It also prints the SIMT analog of the JAX probe's interleave tax. A warp
of 32 threads runs until its slowest lane is done, so over 32-lane warps
in pool order it pays sum(32 * max(steps)) thread-steps for sum(steps)
live ones. The oracle grouping (the same rays sorted by step count, then
grouped in 32s) says what any reordering of the pool could save at most.
On the card the counting kernel also measures what its warps paid (each
warp adds its passes on the card: `ops.traverse_packet.last_warp_steps`),
printed beside the model; both traces (without the count) are timed with
CUDA events and divided by the measured warp-steps. --table-mem names one
or more residencies of the traversal table (`ops.traverse_packet.
table_plan`); with several, every count must be the same under each, and
the traces are timed in turns (a, b, b, a).

camera_rays and incoherent_rays make the 1M-ray sets that chip_smoke.py
times the kernel on.

--device cuda (the default) needs a card and fails without one; it never
falls back. --device cpu runs the plain versions at a small size (64^2 by
default) and times nothing.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

WARP = 32


def census(steps, active):
    """Statistics of one counted trace: steps [P] i32 and active [P] bool
    (tensors or arrays, pool order). Returns a dict of host numbers."""
    s = np.asarray(torch.as_tensor(steps).cpu(), np.int64)
    a = np.asarray(torch.as_tensor(active).cpu(), bool)
    live = s[a]
    n = int(a.sum())
    if n == 0:
        raise ValueError("census of an empty pool")
    # warps in pool order over the whole pool (inactive lanes count 0)
    pad = -s.shape[0] % WARP
    w = np.pad(np.where(a, s, 0), (0, pad)).reshape(-1, WARP).max(axis=1)
    oracle = np.sort(live)[::-1]
    oracle = np.pad(oracle, (0, -n % WARP)).reshape(-1, WARP).max(axis=1)
    live_sum = int(live.sum())
    return {
        "lanes": int(s.shape[0]), "rays": n, "steps_sum": live_sum,
        "mean": float(live.mean()), "p50": float(np.percentile(live, 50)),
        "p95": float(np.percentile(live, 95)), "max": int(live.max()),
        "warp_steps": int(w.sum()), "paid": int(w.sum()) * WARP,
        "oracle_paid": int(oracle.sum()) * WARP,
        "tax": WARP * float(w.sum()) / max(live_sum, 1) - 1.0,
        "oracle_tax": WARP * float(oracle.sum()) / max(live_sum, 1) - 1.0,
    }


SCENES = ("testobj", "large", "organic_sss", "organic_media")


def scene_parts(scene, cache_dir=None, **size):
    """(flat_bvh, materials, envmap, texture) of one of SCENES; `size`
    (n_lat, n_lon, ground_div) shrinks the big scenes."""
    from ..scene import demo
    if scene == "testobj":
        return demo.testobj_scene(cache_dir=cache_dir)
    if scene == "large":
        return demo.large_scene(cache_dir=cache_dir, **size)
    if scene in ("organic_sss", "organic_media"):
        return demo.large_organic_scene(
            cache_dir=cache_dir, variant=scene.split("_")[1], **size)
    raise ValueError("unknown scene %r (want one of %s)" % (scene, SCENES))


def scene_renderer(scene, size, device, cache_dir=None, **scene_size):
    """One of SCENES with default settings at size^2: (renderer, cam_vec)."""
    from ..scene.demo import default_camera
    from ..tracer.renderer import Renderer
    fb, mats, envmap, texture = scene_parts(scene, cache_dir, **scene_size)
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=size,
                 height=size, device=device)
    cam = default_camera(size, size).build_render_camera()
    return r, torch.as_tensor(cam.as_array(), device=r.device)


def camera_rays(n_side, device):
    """Primary rays of the default camera over an n_side^2 image, in the
    renderer's lane order (frame 1), as the first regen wave traces them."""
    from ..core.rng import RaySampler, wang_hash
    from ..scene.demo import default_camera
    from ..tracer.renderer import generate_camera_rays, lane_pixel_xy
    cam = default_camera(n_side, n_side).build_render_camera()
    cam_vec = torch.as_tensor(cam.as_array(), device=device)
    lanes = torch.arange(n_side * n_side, device=device)
    rng = RaySampler.init(wang_hash(1), lanes)
    px, py = lane_pixel_xy(lanes, n_side, n_side)
    _, o, d = generate_camera_rays(cam_vec, rng, px.float(), py.float())
    return o.contiguous(), d.contiguous()


def incoherent_rays(n, fb, seed, device):
    """Origins uniform in the scene box, directions uniform on the sphere."""
    g = np.random.default_rng(seed)
    o = g.uniform(fb.root_lo, fb.root_hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))


def freeze_pool(renderer, cam_vec, waves, spp):
    """The regen pool after `waves` waves of frames 1..spp (the renderer's
    own integrator for stop_after_waves=waves)."""
    fn = renderer.regen_integrator(stop_after_waves=waves)
    return fn(renderer.scene, cam_vec, 1, 0, renderer.zeros_accum(), spp)


def trace_pool(renderer, pool, anyhit=False, count_steps=False,
               table_mem="auto"):
    """Trace the pool's rays under its active mask."""
    from ..core.vecmath import RAY_MIN, RAY_MAX
    from ..ops.traverse_packet import packet_intersect
    return packet_intersect(
        renderer.scene["packed"], pool["orig"], pool["dir"], RAY_MIN,
        RAY_MAX, anyhit=anyhit, stack_depth=renderer.settings.stack_depth,
        active=pool["active"], count_steps=count_steps, table_mem=table_mem)


def run(renderer, cam_vec, waves_list, spp, timed, table_mems=("auto",)):
    """Census for each k in waves_list; returns a list of dicts. On the
    card each kind also gets measured_paid / measured_tax (the warp-steps
    the counting kernel paid) and, with timed, trace_ms and
    ns_per_warp_step; on the CPU they are None (not measured). The counts
    are taken under every residency in table_mems and must be equal
    (slot, t, steps, and on the card the warp-steps); the numbers above
    are those of table_mems[0], and `by_table_mem` holds each residency's
    trace times, taken in turns: the list, then the list reversed."""
    from ..ops.traverse_packet import last_warp_steps
    on_card = renderer.device.type == "cuda"
    out = []
    for k in waves_list:
        pool = freeze_pool(renderer, cam_vec, k, spp)
        rec = {"after_waves": pool["waves"], "alive": pool["alive"]}
        for kind, anyhit in (("closest", False), ("anyhit", True)):
            first = paid = None
            for tm in table_mems:
                got = trace_pool(renderer, pool, anyhit, count_steps=True,
                                 table_mem=tm)
                tm_paid = WARP * int(last_warp_steps()) if on_card else None
                if first is None:
                    first, paid = got, tm_paid
                elif not all(torch.equal(x, y) for x, y in zip(first, got)) \
                        or tm_paid != paid:
                    raise AssertionError(
                        "table_mem=%r changed the %s trace of the pool"
                        % (tm, kind))
            c = census(first[2], pool["active"])
            c["measured_paid"] = paid
            c["measured_tax"] = None if paid is None \
                else paid / max(c["steps_sum"], 1) - 1.0
            c["trace_ms"] = c["ns_per_warp_step"] = None
            c["by_table_mem"] = {tm: [] for tm in table_mems}
            if timed and on_card:
                from ..utils.timing import cuda_ms
                turns = list(table_mems)
                if len(turns) > 1:
                    turns += turns[::-1]
                for tm in turns:
                    c["by_table_mem"][tm].append(cuda_ms(
                        lambda: trace_pool(renderer, pool, anyhit,
                                           table_mem=tm), 20))
                c["trace_ms"] = min(c["by_table_mem"][table_mems[0]])
                c["ns_per_warp_step"] = c["trace_ms"] * 1e6 * WARP \
                    / max(paid, 1)
            rec[kind] = c
        out.append(rec)
        del pool
    return out


def report(rec):
    lines = ["after %d waves: %d live rays" % (rec["after_waves"],
                                               rec["alive"])]
    for kind in ("closest", "anyhit"):
        c = rec[kind]
        lines.append(
            "  %-7s steps/ray mean %.2f p50 %.0f p95 %.0f max %d; warps "
            "pay %.3fM thread-steps for %.3fM live (+%.1f%%), oracle "
            "grouping %.3fM (+%.1f%%)"
            % (kind, c["mean"], c["p50"], c["p95"], c["max"], c["paid"] / 1e6,
               c["steps_sum"] / 1e6, 100 * c["tax"], c["oracle_paid"] / 1e6,
               100 * c["oracle_tax"]))
        if c["measured_paid"] is None:
            lines.append("    measured on the card: not measured (cpu)")
        else:
            lines.append("    measured on the card: %.3fM thread-steps "
                         "(+%.1f%%)" % (c["measured_paid"] / 1e6,
                                        100 * c["measured_tax"]))
        if c["trace_ms"] is None:
            lines.append("    trace time: not measured")
        else:
            lines.append("    trace %.4f ms -> %.3f ns per warp-step"
                         % (c["trace_ms"], c["ns_per_warp_step"]))
            for tm, ms in c["by_table_mem"].items():
                lines.append("    table_mem=%-11s trace %s ms" % (
                    tm, "/".join("%.4f" % t for t in ms)))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", type=int, default=None,
                    help="image side (default 1024 on cuda, 64 on cpu)")
    ap.add_argument("--waves", default="1,3")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--scene", default="testobj", choices=SCENES)
    ap.add_argument("--table-mem", default="auto",
                    help="one or more of auto/smem/split/vmem/vmem_packed, "
                    "comma-separated (smem only where the stream fits the "
                    "JAX package's SMEM budget)")
    ap.add_argument("--cache-dir", default=".bvh_cache_torch",
                    help="BVH cache directory ('' builds in memory)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_steps: --device cuda needs a CUDA device "
              "(torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    size = args.size or (1024 if args.device == "cuda" else 64)
    waves = [int(w) for w in args.waves.split(",")]
    table_mems = tuple(args.table_mem.split(","))
    # the big scenes are cut down on the CPU: full size is for the card
    small = {} if args.device == "cuda" or args.scene == "testobj" \
        else {"n_lat": 24, "n_lon": 48}
    renderer, cam_vec = scene_renderer(args.scene, size, args.device,
                                       args.cache_dir or None, **small)
    recs = run(renderer, cam_vec, waves, args.spp,
               timed=args.device == "cuda", table_mems=table_mems)
    for rec in recs:
        print(report(rec), flush=True)
    dev = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(json.dumps({"device": dev, "scene": args.scene, "size": size,
                      "spp": args.spp, "table_mems": table_mems,
                      "census": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
