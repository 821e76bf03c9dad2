#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and nvcc; it
fails (non-zero exit, no result line) without them, and it never falls
back to the CPU. Phases, each fatal on failure:

1. require a CUDA device; read the card's name and power limit;
2. build every CUDA source under tpu_pathtracer_torch/csrc/ (one nvcc per
   source, in parallel) into the ignored csrc/_build/ directory;
3. hold the traversal kernel (closest hit with a 397-lane prefix, closest
   hit with a mask and per-lane tmax, any hit with a mask) against its
   plain PyTorch version on the card and against a float64 brute-force
   oracle, on camera and incoherent rays of the TestObj stream, and time
   kernel and plain version at 1M rays;
4. render the c1/c2/c3 golden configurations (96x96, 12 spp) on the card
   and hold them to tests/goldens/*.npz under the gate statistics;
5. drive the main path: the default TestObj scene at 1024x1024, default
   RenderSettings (1M-lane regen pool), 4 spp through
   Renderer.render_frames, with the kernels' launch counts set to 0
   just before and read just after;
6. print the kernels line, the card line, and the result line (last).

A `details` line carries every measurement as JSON. The BVH is built by
tpu_pathtracer.accel (numpy + C++), the port's one import from the JAX
package; nothing here imports jax.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RAY_MIN, RAY_MAX = 1e-4, 1e20
AGREE_MIN = 0.999          # hit/miss and triangle agreement, every form
T_RTOL = 1e-5              # t where kernel and plain version agree on slot
PREFIX = 397               # splits a warp
N_CHECK = 65536
N_BRUTE = 4096
N_TIME = 1 << 20


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def camera_rays(torch, n_side, device):
    """Primary rays of the default camera over an n_side^2 image, in the
    renderer's lane order (frame 1), as the first regen wave traces them."""
    from tpu_pathtracer_torch.core.rng import RaySampler, wang_hash
    from tpu_pathtracer_torch.scene.demo import default_camera
    from tpu_pathtracer_torch.tracer.renderer import (
        generate_camera_rays, lane_pixel_xy)
    cam = default_camera(n_side, n_side).build_render_camera()
    cam_vec = torch.as_tensor(cam.as_array(), device=device)
    lanes = torch.arange(n_side * n_side, device=device)
    rng = RaySampler.init(wang_hash(1), lanes)
    px, py = lane_pixel_xy(lanes, n_side, n_side)
    _, o, d = generate_camera_rays(cam_vec, rng, px.float(), py.float())
    return o.contiguous(), d.contiguous()


def incoherent_rays(np, torch, n, fb, seed, device):
    """Origins uniform in the scene box, directions uniform on the sphere."""
    g = np.random.default_rng(seed)
    o = g.uniform(fb.root_lo, fb.root_hi, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))


def brute(np, tri_verts, o, d, tmax):
    """Float64 brute-force closest-hit triangle (or -1) with per-lane tmax,
    in chunks of 256 rays."""
    from tpu_pathtracer_torch.tracer.traverse import brute_force_intersect
    tris = [brute_force_intersect(tri_verts, o[s:s + 256], d[s:s + 256],
                                  RAY_MIN, tmax[s:s + 256, None])[0]
            for s in range(0, o.shape[0], 256)]
    return np.concatenate(tris) if tris else np.zeros((0,), np.int64)


def check_forms(np, torch, ops, trav, fb, packed, mesh, rays, tag, g):
    """Kernel vs plain version (on the card) vs brute force, three forms.
    Returns {form: max |t_kernel - t_plain| over slot-agreeing lanes}."""
    o, d = rays
    n = o.shape[0]
    dev = o.device
    sd = fb.max_depth + 2
    act = torch.from_numpy(g.random(n) < 0.7).to(dev)
    tmax_l = torch.from_numpy(
        g.uniform(0.5, 8.0, n).astype(np.float32)).to(dev)
    forms = {
        "closest_prefix": (dict(active_prefix=PREFIX), False,
                           torch.arange(n, device=dev) < PREFIX,
                           torch.full((n,), RAY_MAX, device=dev)),
        "closest_mask_lane_tmax": (dict(active=act), False, act, tmax_l),
        "anyhit_mask": (dict(active=act, anyhit=True), True, act,
                        torch.full((n,), RAY_MAX, device=dev)),
    }
    tri_orig = torch.from_numpy(fb.tri_orig).to(dev)
    errs = {}
    for name, (kw, anyhit, mask, tmax) in forms.items():
        tmax_arg = tmax if name == "closest_mask_lane_tmax" else RAY_MAX
        ks, kt = ops.packet_intersect(packed, o, d, RAY_MIN, tmax_arg,
                                      stack_depth=sd, **kw)
        ps, pt = trav.intersect_scene(None, None, None, o, d, RAY_MIN,
                                      tmax_arg, anyhit=anyhit,
                                      stack_depth=sd, active=mask,
                                      packed=packed)
        torch.cuda.synchronize()
        hit_agree = ((ks >= 0) == (ps >= 0)).float().mean().item()
        ko = torch.where(ks >= 0, tri_orig[ks.clamp_min(0).long()], -1)
        po = torch.where(ps >= 0, tri_orig[ps.clamp_min(0).long()], -1)
        tri_agree = (ko == po).float().mean().item()
        same = (ks == ps) & (ks >= 0)
        err = (kt[same] - pt[same]).abs().max().item() if same.any() else 0.0
        rel = ((kt[same] - pt[same]).abs() / pt[same].abs()).max().item() \
            if same.any() else 0.0
        # the contract for lanes outside the active set
        out = ~mask
        assert (ks[out] == -1).all().item(), (tag, name, "inactive slot")
        assert torch.equal(kt[out], tmax[out]), (tag, name, "inactive t")
        # float64 brute force on the first N_BRUTE lanes (active ones)
        on = np.nonzero(mask[:N_BRUTE].cpu().numpy())[0]
        bo, bd = o[on].cpu().numpy(), d[on].cpu().numpy()
        btri = brute(np, mesh.tri_vertices(), bo, bd,
                     tmax[on].cpu().numpy().astype(np.float64))
        kb = ko[on].cpu().numpy()
        if anyhit:
            b_agree = float(((kb >= 0) == (btri >= 0)).mean())
        else:
            b_agree = float((kb == btri).mean())
        log("  %-11s %-22s hit %.6f tri %.6f brute %.6f max|dt| %.3g "
            "rel %.3g" % (tag, name, hit_agree, tri_agree, b_agree, err, rel))
        assert hit_agree >= AGREE_MIN, (tag, name, hit_agree)
        if not anyhit:
            assert tri_agree >= AGREE_MIN, (tag, name, tri_agree)
            assert rel <= T_RTOL, (tag, name, rel)
        assert b_agree >= AGREE_MIN, (tag, name, b_agree)
        errs[name] = err
    return errs


def time_ms(torch, fn, reps):
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


def gate(np, img, want, name):
    d = np.abs(img - want)
    med = float(np.median(d))
    ratio = float(img.mean()) / max(float(want.mean()), 1e-9)
    rmse = float(np.sqrt((d ** 2).mean()))
    log("  %-14s median|d| %.3g mean ratio %.6f rmse %.3g"
        % (name, med, ratio, rmse))
    assert np.all(np.isfinite(img)), name
    assert med < 1e-4, (name, med)
    assert abs(ratio - 1.0) < 0.01, (name, ratio)
    assert rmse < 0.1, (name, rmse)
    return {"median_absdiff": med, "mean_ratio": ratio, "rmse": rmse}


def golden_configs():
    """The c1/c2/c3 configurations of tests/test_goldens.py."""
    from tpu_pathtracer_torch.scene.config import (
        MatDesc, MAT_DIFF, MAT_GLASS, MAT_REFL, MAT_FRESNEL)
    from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
    base = dict(use_envmap=True, use_texture=True)
    return {
        "c1_lambertian": (
            [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_DIFF, objcol=(0.9, 0.3, 0.25)),
             MatDesc(refltype=MAT_DIFF, objcol=(0.3, 0.9, 0.35)),
             MatDesc(refltype=MAT_DIFF, objcol=(0.3, 0.35, 0.9))],
            RenderSettings(bounce_min=2, bounce_max=6, **base), 0.0),
        "c2_microfacet": (
            [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_FRESNEL, alphax=0.1, alphay=0.1, kd=5.0,
                     ks=1.0),
             MatDesc(refltype=MAT_REFL, alphax=0.2, alphay=0.2),
             MatDesc(refltype=MAT_REFL)],
            RenderSettings(bounce_min=2, bounce_max=8, **base), 0.0),
        "c3_glass_dof": (
            [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_GLASS, alphax=0.15, etaT=1.5),
             MatDesc(refltype=MAT_GLASS),
             MatDesc(refltype=MAT_REFL)],
            RenderSettings(bounce_min=2, bounce_max=10, **base), 0.05),
    }


def main():
    if not os.path.isdir(os.path.join(HERE, "tpu_pathtracer_torch")):
        print("chip_smoke.py must run from the root of a checkout (no "
              "tpu_pathtracer_torch/ beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    t_start = time.time()
    report = {}

    # ---- 1. the card ----
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card: %s | torch %s cuda %s" % (card, torch.__version__,
                                         torch.version.cuda))

    # ---- 2. build every kernel source ----
    from tpu_pathtracer_torch.utils import cuda_build
    names = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.time()
    libs = cuda_build.KernelLibs(names)
    report["build_s"] = time.time() - t0
    log("built %s in %.1f s: %s" % (
        names, report["build_s"],
        [os.path.relpath(p, HERE) for p in libs.paths.values()]))
    for name, text in libs.logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas %s: %s" % (name, line.strip()))

    from tpu_pathtracer_torch.ops import traverse_packet as ops
    from tpu_pathtracer_torch.tracer import traverse as trav
    from tpu_pathtracer_torch.scene import demo, procedural
    from tpu_pathtracer_torch.tracer.renderer import Renderer

    # ---- 3. kernel vs plain vs brute force; times at 1M rays ----
    cache = os.path.join(HERE, ".bvh_cache_torch")
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=cache)
    mesh = procedural.make_test_scene()
    packed = torch.from_numpy(trav.pack_stream(fb.prims, fb.meta)).to(dev)
    log("TestObj stream: %d rows, %d nodes, depth %d"
        % (packed.shape[0], fb.num_nodes, fb.max_depth))
    g = np.random.default_rng(1234)
    errs = {}
    for tag, rays in (("camera", camera_rays(torch, 256, dev)),
                      ("incoherent", incoherent_rays(np, torch, N_CHECK, fb,
                                                     7, dev))):
        e = check_forms(np, torch, ops, trav, fb, packed, mesh, rays, tag, g)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    sd = fb.max_depth + 2
    timing = {}
    big = {"coherent": camera_rays(torch, 1024, dev),
           "incoherent": incoherent_rays(np, torch, N_TIME, fb, 8, dev)}
    n_half = torch.from_numpy(g.random(N_TIME) < 0.5).to(dev)
    for tag, (o, d) in big.items():
        for kind, anyhit in (("closest", False), ("anyhit", True)):
            kw = dict(active=n_half) if anyhit else dict(active_prefix=N_TIME)
            mask = n_half if anyhit else None

            def kern():
                return ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX,
                                            stack_depth=sd, anyhit=anyhit,
                                            **kw)

            def plain():
                return trav.intersect_scene(None, None, None, o, d, RAY_MIN,
                                            RAY_MAX, anyhit=anyhit,
                                            stack_depth=sd, active=mask,
                                            packed=packed)
            # plain, kernel, kernel, plain
            p1 = time_ms(torch, plain, 1)
            k1 = time_ms(torch, kern, 10)
            k2 = time_ms(torch, kern, 10)
            p2 = time_ms(torch, plain, 1)
            ks, kt = kern()
            ps, pt = plain()
            same = (ks == ps) & (ks >= 0)
            agree = ((ks >= 0) == (ps >= 0)).float().mean().item()
            assert agree >= AGREE_MIN, (tag, kind, agree)
            err = (kt[same] - pt[same]).abs().max().item() if same.any() \
                else 0.0
            errs["%s_%s_1M" % (kind, tag)] = err
            timing["%s_%s" % (kind, tag)] = {
                "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                "rays": N_TIME if not anyhit else int(n_half.sum()),
                "agree": agree, "max_abs_err": err}
            log("  time %-10s %-8s kernel %.3f/%.3f ms  plain %.1f/%.1f ms  "
                "agree %.6f" % (tag, kind, k1, k2, p1, p2, agree))
    report["timing_1M"] = timing

    # ---- 4. goldens on the card ----
    golden = {}
    for name, (gmats, settings, aperture) in golden_configs().items():
        r = Renderer(fb, gmats, envmap=envmap, texture=texture, width=96,
                     height=96, settings=settings, device=dev)
        cam = demo.default_camera(96, 96)
        cam.aperture_radius = aperture
        cam.focal_distance = 4.0
        acc = r.render_frames(r.zeros_accum(), cam.build_render_camera(),
                              1, 12)
        torch.cuda.synchronize()
        img = r.accum_to_buffer(acc / 12)
        want = np.load(os.path.join(HERE, "tests", "goldens",
                                    name + ".npz"))["img"]
        golden[name] = gate(np, img, want, name)
    report["goldens"] = golden

    # ---- 5. the main path at full width ----
    W = H = 1024
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=H, device=dev)
    rc = demo.default_camera(W, H).build_render_camera()
    r.render_frames(r.zeros_accum(), rc, 1, 1)          # warm-up frame
    torch.cuda.synchronize()
    spp = 4
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t_host = time.time()
    start.record()
    acc, waves, rays = r.render_frames(r.zeros_accum(), rc, 1, spp,
                                       with_stats=True)
    stop.record()
    torch.cuda.synchronize()
    t_host = time.time() - t_host
    launches = dict(ops.LAUNCHES)
    ms = start.elapsed_time(stop)
    img = acc.cpu().numpy() / spp
    assert img.shape == (W * H, 3), img.shape
    assert np.all(np.isfinite(img)), "main path: non-finite radiance"
    assert float(img.mean()) > 0.01, "main path: black image"
    for k, v in launches.items():
        assert v > 0, "main path never launched %s" % k
    main = {"width": W, "height": H, "spp": spp,
            "pool_lanes": r.settings.pool_lanes,
            "ms_per_frame": ms / spp, "host_s": t_host, "waves": waves,
            "traced_rays": rays, "mrays_per_s": rays / (ms / 1e3) / 1e6,
            "mean_radiance": float(img.mean()), "launches": launches}
    report["main_path"] = main
    log("main path %dx%d x %d spp: %.1f ms per 1-spp frame, %d waves, "
        "%.0f rays, %.1f Mrays/s, launches %s"
        % (W, H, spp, ms / spp, waves, rays, main["mrays_per_s"], launches))
    assert "jax" not in sys.modules, "the port imported jax"

    # ---- 6. result ----
    src = "tpu_pathtracer_torch/csrc/traverse.cu"
    rep = "tpu_pathtracer/ops/traverse_packet.py:507"
    kernels = []
    for name, kind in (("traverse_closest", "closest"),
                       ("traverse_anyhit", "anyhit")):
        tm = timing["%s_coherent" % kind]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": max(v for k, v in errs.items()
                               if k.startswith(kind)),
            "ms": min(tm["kernel_ms"]), "plain_ms": min(tm["plain_ms"])})
    report["kernels"] = kernels
    report["card"] = card
    report["total_s"] = time.time() - t_start
    log("details " + json.dumps(report))
    log("total %.1f s" % report["total_s"])
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
