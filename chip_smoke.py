#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. `python3 chip_smoke.py --ab DIR [--out
FILE]` instead times the port of the checkout DIR (see measure_ab) and
prints one JSON line: run it for a parent and a tree in one call, in the
order parent, tree, tree, parent. It needs one CUDA device and nvcc; it
fails (non-zero exit, no result line) without them, and it never falls
back to the CPU. Phases, each fatal on failure:

1. require a CUDA device; read the card's name and power limit;
2. build every CUDA source under tpu_pathtracer_torch/csrc/ (one nvcc per
   source, in parallel) into the ignored csrc/_build/ directory;
3. hold the traversal kernel (closest hit with a 397-lane prefix, given
   as an int and as a 0-d int32 device tensor that the kernel reads from
   device memory, any hit with that device prefix, closest hit with a mask
   and per-lane tmax, any hit with a mask) against its plain PyTorch
   version on the card, slot and t bit for bit on every lane, and
   against a float64 brute-force oracle, on camera and incoherent rays of
   the TestObj stream; time the kernel (its bare C
   entry, and through the wrapper) and the plain version (equal on every
   lane again) at 1M rays in five forms (closest hit over the whole
   prefix as an int, and as a 0-d int32 device tensor of 1M and of 1M - 5
   lanes, each equal to the int-prefix launch on every lane; any hit under
   a 50% mask; closest hit under a 70% mask with per-lane tmax) and on
   small launches (4,096 and 65,536 camera rays);
3b. hold the step-counting kernel (count_steps=True) on the same rays and
   forms: its slot and t equal the non-counting kernel's bit for bit, its
   steps the plain version's on every lane, 0 outside the active set;
   count and time it on phase 3's timed sets, whose step sums give the
   traversal bound (section "bounds" below) and whose measured warp-steps
   (ops.traverse_packet.last_warp_steps) give the warps' tax over the live
   steps and ns per warp-step;
3d. hold the shared-memory-table instantiations (table_mem="smem" on the
   TestObj stream, "split" on the ~135k-triangle large_scene stream) to the
   plain version and to the __ldg kernel: slot, t, steps and warp-steps
   bit for bit on every lane, three forms, with and without the count, at
   4,096, 65,536 and 1M lanes;
3c. hold the row gather (wide C=128, flat (P,16), batch 8) and scatter
   kernels to their plain versions at P = 1,048,576, exactly, and time
   kernel, plain version and library call (torch.index_select /
   index_copy_) beside the byte bound;
4. render the c1..c7 golden configurations (96x96, 12 spp; c4 media, c5
   BSSRDF, c6/c7 the ~105k-triangle organic blob with BSSRDF / a jade
   medium) on the card and hold them to tests/goldens/*.npz under the gate
   statistics;
5. drive the main path: the default TestObj scene at 1024x1024, default
   RenderSettings (1M-lane regen pool), 4 spp through
   Renderer.render_frames, with the kernels' launch counts set to 0
   just before and read just after;
5b. drive the step census (tools/probe_steps.py) on the same renderer:
   freeze the pool after 3 waves, count its steps in closest and any hit
   (modelled and measured warp tax), time both traces on the frozen pool
   beside their bound, counts set to 0 before and read after;
5c. drive the row probe (tools/probe_dma.py) at P = 1,048,576 the same way;
5d. time both residencies of the traversal table as bare launches on the
   TestObj stream: 1M coherent rays (closest hit; any hit under a 50%
   mask), 1M incoherent rays and the pool frozen after 3 waves (closest
   and any hit), every output equal to the plain version's and the other
   residency's on every lane, with S, block, shared bytes, registers, ns
   per warp-step and the share of the bound, and a sweep of S;
7. this slice's paths at full width: large_scene (surfaces),
   large_organic_scene("sss") and ("media") at 1024x1024 with default
   settings: a 1-spp warm-up, then 2 timed spp with every launch count set
   to 0 before and read after (ms per 1-spp frame, waves, Mrays/s,
   launches per frame), the same frames again with
   packet_table_mem="split" (the path of the table instantiations), 5d's
   timings on each stream, and on large_scene the step census under both
   residencies (the path of the counting table instantiations);
8. the bounce integrator, lane chunks and shards, the last regen orders
   and the CLI: (8a) bounce on TestObj at 1024x1024 with default settings,
   a 1-spp warm-up and 2 timed spp with launch counts set to 0 before and
   read after, then regen on the same frames, the two images held to the
   gate statistics; (8b) the same on large_organic_scene("sss") at 1 spp,
   where the BSSRDF probes launch row 3 through bounce; (8c) bounce in 4
   lane chunks and in 2 shards on the one card equal the whole frame bit
   for bit, 2 regen shards equal it under the gate statistics; (8d)
   regen_order="inplace" against "compact" under the gate statistics, and
   the frame time of each, at 1024x1024, 2 spp;
   (8e) the CLI, python -m tpu_pathtracer_torch.tools.render, renders the
   demo at 256x256 to a PPM with a checkpoint at 8 spp, then resumes it to
   16 spp;
9. the viewer, the profiler and the last user tools: (9a) a scripted
   session of tools/interactive.py's ViewerSession at a 1920x1080 window
   on an injected clock (every key binding once, a left drag, a wheel step
   and space as 960x540 previews, then 4 converging steps of 4 spp), with
   the launch counts set to 0 before and read after; the image after the
   last reset held to Renderer.render_frames of the same camera and frames
   under the gate statistics, and the device tonemap to the host tonemap
   of the same accumulation within one uint8 step; (9c)
   tools/showcase_1080p.py at 8 spp to a PPM; (9d) tools/gallery.py,
   every variant at 128x128, 4 spp, to PPMs; (9e)
   tools/profile_frame.py's marginal profile (op table, category rollup,
   device busy time, and the idle share of the frame timed without the
   profiler) of TestObj regen, the sss regen and the TestObj bounce
   frames at 1024x1024, frames (1, 3); (9g) the viewer's image kernel
   (csrc/image.cu, one launch a viewer step, counted in 9a) at 960x540
   with a 2x upscale and at 1920x1080 without: the plain version's
   bytes, the bare launch and the plain version timed in turns beside
   the byte bound;
10. the regen frame as one device program (tracer/regen.py: fixed-width
   waves with device-side counts, each captured once as a CUDA graph and
   replayed; phases 4-9 above already run this way): (10a) on TestObj and
   the organic sss and media scenes at 256x256, 2 spp, under torch's
   deterministic algorithms, the replayed frame equals the eager one
   (device_loop.no_graphs()) bit for bit, with the same waves, rays and
   launches; (10b) TestObj at 1024x1024, 2 spp: the replayed frame passes
   the gate statistics against the eager one, and a replayed render call
   runs under torch.cuda.set_sync_debug_mode("error"); (10c) at
   1024x1024, times in turns: TestObj's steady frame (the marginal of
   frames (1, 3)) and a 1-spp render call, replayed and eager, and the sss
   and media steady frames; the waves run at each drain width; (10d) the
   capture time and torch.cuda.max_memory_allocated of a 1024x1024 frame,
   replayed and eager; (10e) the traverse_kernel events that torch.profiler
   sees in one replayed 1-spp call at 1024x1024 number exactly the
   launches the counts give for it (a replay adds its capture's counts;
   the one wave past the end is counted and launched);
11. the bounce integrator as one device program (tracer/wavefront.py's
   frame_start, bounce_step and frame_end, each captured once as a CUDA
   graph through tracer/device_loop.py and replayed; phases 8 and 9e
   already run it so) and sharded frames with every shard in flight:
   (11a) on TestObj and the organic sss and media scenes at 256x256, 2
   spp, under torch's deterministic algorithms, the replayed bounce frame
   equals the eager one (device_loop.no_graphs()) bit for bit, with the
   same bounces run, bounces launched, rays and launches; (11b) TestObj
   bounce at 1024x1024: the gate against regen, the steady frame (the
   marginal of frames (1, 3)) and a 1-spp call replayed and eager in
   turns, the device's busy ms and idle share of phase 9e's profiled
   calls, the bounces launched past a frame's end, the capture time and
   max_memory_allocated of a first call, and a replayed call under
   torch.cuda.set_sync_debug_mode("error"); (11c) the traverse_kernel
   events of one profiled replayed 1-spp bounce call equal its launch
   counts; (11d) 2 shards on the mesh [cuda:0, cuda:0] equal the whole
   1-spp render bit for bit for regen and for bounce, and a sharded call
   runs under sync debug "error";
12. the shade kernel (csrc/shade.cu, the surface BSDF draw, one launch a
   regen wave and a bounce; its launches are counted on every path above,
   and 10e / 11c hold them to the profiled shade_kernel events): (12a) at
   P = 1,048,576 lanes of every material branch, with NaN normals on 5%
   miss lanes, the kernel equals its plain version (ops/shade.py:
   shade_plain) bit for bit in every output on every surface lane; the
   bare launch and the plain version timed in turns beside the byte
   bound; (12b) the TestObj regen and bounce renders at 1024x1024, 2 spp,
   replayed with the kernel and with the plain shade, under torch's
   deterministic algorithms: the gate statistics, and bit for bit;
13. the surface fetch kernels (csrc/fetch.cu: fetch_attributes, one launch
   a regen wave and a bounce; csrc/envtex.cu: env_tex_merged, one launch a
   regen wave, and its texture-only form texture_radiance, one launch a
   bounce; the BSSRDF probes fetch inside csrc/bssrdf.cu (phase 15); their
   launches are counted on every path
   above, and 10e / 11c hold them to the profiled events): (13a) at
   P = 1,048,576 lanes with ~40% miss lanes (slot -1, non-finite hit
   points and uv), every material id and bsdf_pdf < 0 on ~30% of lanes,
   each kernel equals its plain version (ops/surface_fetch.py) in every
   output on every lane, bit for bit (a NaN equal to a NaN; lanes whose
   NaN bits differ are reported); the bare launch and the plain version
   timed in turns beside the byte bound; (13b) the TestObj regen and
   bounce renders at 1024x1024 and the sss regen render at 256x256, 2
   spp, replayed with the kernels and with the plain versions, under
   torch's deterministic algorithms: the gate statistics, and bit for
   bit;
14. the compaction permute's pool gather (csrc/permute.cu, one launch a
   compact regen wave, counted on every path above): (14a) at 1,048,576
   and 518,400 rows (the CLI cells' pool, the 960x540 preview's), with
   NaN, infinities, -0.0, bsdf_pdf -1, rng with its high bits set, lbn
   and bounce 0 and 127, medium_id -1 and 32766, under each aliasing of
   the wave (the pool's pixel; L too; lbn and medium_id too), the kernel
   equals its plain version (ops/permute.py) in
   every column bit for bit; the bare launch, the wrapper as a wave runs
   it (captured), the plain version and the old cat, gather and split
   captured (library_ms), in turns, beside the byte bound (168 B a row);
   (14b) the same times on the
   inputs of a 1920x1080 TestObj frame's third full-width wave (its
   order, not a random one); (14c) TestObj and media regen renders, 2
   spp, replayed with the kernel and with the plain version, under
   torch's deterministic algorithms: bit for bit, one launch a wave;
15. the BSSRDF probe loop's kernels (csrc/bssrdf.cu: probe_start,
   probe_step, probe_finish, 1 + bssrdf_probes launches a wave around the
   probe traces, counted on every path above): (15a) on the inputs of a
   1920x1080 organic sss frame's first wave (2^20 lanes) the kernel path
   of bssrdf_scatter equals its plain version (bssrdf_scatter_plain) in
   every output, bit for bit; (15b) each kernel's bare launch, and the
   kernel and plain paths captured with their probe traces, in turns,
   beside the loop's byte bound (ops/bssrdf.py: io_bytes); (15c) sss regen
   and bounce renders, 2 spp, replayed with the kernels and with the plain
   path, under torch's deterministic algorithms: bit for bit;
6. print the kernels line (rows 1-3 also carry their launches on the
   replayed bounce path, "launches_bounce", rows 1-2 on the viewer path,
   "launches_viewer"; the shade kernel and the surface fetches both, the
   fetches also on the sss regen path, "launches_sss_regen"), the card
   line, and the result line (last).

Phases 4-15 replay captured steps (the default on a CUDA device): each
renderer's first call of a key captures, and the timed calls come after a
warm-up call of the same key.

Bounds. A traversal kernel's bound is the larger of its bytes (active
rays, the table once, mask and outputs) over 3.35 TB/s and its operations over the
card's 67 TFLOP/s FP32 rate: the steps this run's rays took (counted by
3b) times 39, the FP32 arithmetic of a triangle step of csrc/traverse.cu
(a node step has 48; compares not counted), so it is a lower bound. The
row kernels are bound by bytes (tools/probe_dma.py: bound_bytes), and so
is the shade kernel: the bytes this run's lanes need (ops/shade.py:
io_bytes, 79-115 a lane by the lane's branch, and the material table
once) over 3.35 TB/s, against at least SHADE_OPS_PER_LANE FP32 operations
a lane that is not a null interface over 67 TFLOP/s. The surface fetches
too: each lane's inputs and outputs and each table row the lanes read,
once (ops/surface_fetch.py: io_bytes, rows_read), against
FETCH_OPS_PER_LANE FP32 operations a lane.

A `details` line carries every measurement as JSON. The BVH is built by
the port's own accel/ (numpy + C++ built with g++; the line "BVH:" says
which builder ran); nothing here imports jax or the JAX package.
"""
import contextlib
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
P_DMA = 1 << 20
CLI_SIZE = 256             # phase 8e's image
VIEWER_H = 1080            # phase 9's window height (16:9)
SHOWCASE_ENV = 2048        # phase 9c's sky width
GALLERY_SIZE = 128         # phase 9d's images
EXACT_SIZE = 256           # phase 10a's images
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12     # H100 SXM FP32 outside the tensor cores
OPS_PER_STEP = 39          # FP32 arithmetic of a triangle step (node: 48)


def log(*a):
    print(*a, flush=True)


def zero_counts():
    """Set every kernel's launch count to 0 (the traversal's and the shade
    kernel's: tracer/device_loop.launch_counts)."""
    from tpu_pathtracer_torch.tracer import device_loop
    device_loop.set_launch_counts(
        {k: 0 for k in device_loop.launch_counts()})


def read_counts():
    from tpu_pathtracer_torch.tracer import device_loop
    return device_loop.launch_counts()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def brute(np, tri_verts, o, d, tmax):
    """Float64 brute-force closest-hit triangle (or -1) with per-lane tmax,
    in chunks of 256 rays."""
    from tpu_pathtracer_torch.tracer.traverse import brute_force_intersect
    tris = [brute_force_intersect(tri_verts, o[s:s + 256], d[s:s + 256],
                                  RAY_MIN, tmax[s:s + 256, None])[0]
            for s in range(0, o.shape[0], 256)]
    return np.concatenate(tris) if tris else np.zeros((0,), np.int64)


def trav_forms(np, torch, g, n, dev):
    """The checked forms on n lanes: {name: (kwargs, anyhit, mask, tmax
    per lane, tmax argument)}; draws the mask, then the per-lane tmax,
    from g. The device-prefix forms pass the prefix as a 0-d int32 tensor
    on the card, which the kernel reads from device memory."""
    act = torch.from_numpy(g.random(n) < 0.7).to(dev)
    tmax_l = torch.from_numpy(
        g.uniform(0.5, 8.0, n).astype(np.float32)).to(dev)
    full = torch.full((n,), RAY_MAX, device=dev)
    prefix_dev = torch.tensor(PREFIX, dtype=torch.int32, device=dev)
    return {
        "closest_prefix": (dict(active_prefix=PREFIX), False,
                           torch.arange(n, device=dev) < PREFIX, full,
                           RAY_MAX),
        "closest_device_prefix": (dict(active_prefix=prefix_dev), False,
                                  torch.arange(n, device=dev) < PREFIX,
                                  full, RAY_MAX),
        "anyhit_device_prefix": (dict(active_prefix=prefix_dev, anyhit=True),
                                 True, torch.arange(n, device=dev) < PREFIX,
                                 full, RAY_MAX),
        "closest_mask_lane_tmax": (dict(active=act), False, act, tmax_l,
                                   tmax_l),
        "anyhit_mask": (dict(active=act, anyhit=True), True, act, full,
                        RAY_MAX),
    }


TIMED_FORMS = ("closest", "closest_device_prefix",
               "closest_device_prefix_n5", "anyhit", "closest_lane_tmax")
DEVICE_PREFIX_FORMS = {"closest_device_prefix": 0,
                       "closest_device_prefix_n5": 5}


def timed_forms(np, torch, g, n, dev):
    """The timed forms on n lanes: {kind: (kwargs, anyhit, mask or None,
    tmax argument, active rays)}. closest: the whole prefix as a host int;
    closest_device_prefix(_n5): the prefix n (n - 5) as a 0-d int32 device
    tensor that the kernel reads from device memory, as the extension trace
    of the regen wave launches it; anyhit: a 50% mask, as the NEE shadow
    trace; closest_lane_tmax: a 70% mask with per-lane tmax in [0.5, 8)."""
    half = torch.from_numpy(g.random(n) < 0.5).to(dev)
    act = torch.from_numpy(g.random(n) < 0.7).to(dev)
    tmax_l = torch.from_numpy(
        g.uniform(0.5, 8.0, n).astype(np.float32)).to(dev)
    forms = {
        "closest": (dict(active_prefix=n), False, None, RAY_MAX, n),
        "anyhit": (dict(active=half, anyhit=True), True, half, RAY_MAX,
                   int(half.sum())),
        "closest_lane_tmax": (dict(active=act), False, act, tmax_l,
                              int(act.sum())),
    }
    for kind, cut in DEVICE_PREFIX_FORMS.items():
        m = n - cut
        forms[kind] = (
            dict(active_prefix=torch.tensor(m, dtype=torch.int32,
                                            device=dev)),
            False, torch.arange(n, device=dev) < m, RAY_MAX, m)
    return forms


def check_forms(np, torch, ops, trav, fb, packed, mesh, rays, tag, g):
    """Kernel vs plain version (on the card) vs brute force, three forms.
    Returns {form: max |t_kernel - t_plain| over slot-agreeing lanes}."""
    o, d = rays
    n = o.shape[0]
    dev = o.device
    sd = fb.max_depth + 2
    forms = trav_forms(np, torch, g, n, dev)
    tri_orig = torch.from_numpy(fb.tri_orig).to(dev)
    errs = {}
    for name, (kw, anyhit, mask, tmax, tmax_arg) in forms.items():
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
        # bit for bit on every lane, and the contract for lanes outside the
        # active set
        assert torch.equal(ks, ps) and torch.equal(kt, pt), \
            (tag, name, "kernel != plain version")
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


def trav_bound_ms(n_lanes, n_active, n_rows, masked, counted, steps_sum):
    """Least time for a traversal: the bound in ms, what binds it, and the
    bytes and operations bounds. Bytes: orig + dir of the active lanes
    read, slot + t (+ steps) of every lane written, the mask read, the
    (K,16) table read once."""
    per_lane = 8 + (4 if counted else 0) + (1 if masked else 0)
    b = (n_active * 24 + n_lanes * per_lane + n_rows * 64) \
        / HBM_BYTES_PER_S * 1e3
    o = steps_sum * OPS_PER_STEP / FP32_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations"), b, o


def check_steps(np, torch, ops, trav, fb, packed, rays, tag, g):
    """Phase 3b on one ray set: the counting kernel against the
    non-counting kernel (slot, t bit for bit) and the plain counting
    version (steps), three forms. Returns {form: steps agreement}."""
    o, d = rays
    sd = fb.max_depth + 2
    forms = trav_forms(np, torch, g, o.shape[0], o.device)
    agree = {}
    for name, (kw, anyhit, mask, _, tmax) in forms.items():
        ks, kt = ops.packet_intersect(packed, o, d, RAY_MIN, tmax,
                                      stack_depth=sd, **kw)
        cs, ct, cn = ops.packet_intersect(packed, o, d, RAY_MIN, tmax,
                                          stack_depth=sd, count_steps=True,
                                          **kw)
        _, _, pn = trav.intersect_scene(None, None, None, o, d, RAY_MIN,
                                        tmax, anyhit=anyhit, stack_depth=sd,
                                        active=mask, packed=packed,
                                        count_steps=True)
        torch.cuda.synchronize()
        assert torch.equal(cs, ks) and torch.equal(ct, kt), \
            (tag, name, "count_steps changed slot or t")
        assert cn.dtype == torch.int32 and cn.shape == o.shape[:1], \
            (tag, name)
        a = (cn == pn).float().mean().item()
        assert torch.equal(cn, pn), (tag, name, "steps != plain version")
        out = ~mask
        assert (cn[out] == 0).all().item(), (tag, name, "inactive steps")
        log("  %-11s %-22s steps = plain on %.6f of lanes, mean %.2f max %d"
            % (tag, name, a, cn[mask].float().mean().item(),
               int(cn.max())))
        assert a >= AGREE_MIN, (tag, name, a)
        agree[name] = a
    return agree


def same(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_table(np, torch, ops, trav, fb, packed, tag, table_mem, g, dev,
                camera_rays, incoherent_rays):
    """Phase 3d on one stream: the kTable instantiations against the plain
    version and the __ldg kernel, slot, t, steps and warp-steps, three
    forms, at 4,096 (camera), 65,536 (incoherent) and 1M (camera) lanes."""
    sd = fb.max_depth + 2
    for rays in (camera_rays(64, dev), incoherent_rays(N_CHECK, fb, 9, dev),
                 camera_rays(1024, dev)):
        o, d = rays
        n = o.shape[0]
        for name, (kw, anyhit, mask, _, tmax) in trav_forms(
                np, torch, g, n, dev).items():
            def kern(tm, count):
                return ops.packet_intersect(packed, o, d, RAY_MIN, tmax,
                                            stack_depth=sd, count_steps=count,
                                            table_mem=tm, **kw)
            tab = kern(table_mem, True)
            w_tab = int(ops.last_warp_steps())
            ldg = kern("vmem", True)
            w_ldg = int(ops.last_warp_steps())
            tab2 = kern(table_mem, False)
            plain = trav.intersect_scene(None, None, None, o, d, RAY_MIN,
                                         tmax, anyhit=anyhit, stack_depth=sd,
                                         active=mask, packed=packed,
                                         count_steps=True)
            torch.cuda.synchronize()
            assert same(torch, tab, plain), (tag, n, name, "table != plain")
            assert same(torch, tab, ldg), (tag, n, name, "table != __ldg")
            assert same(torch, tab2, tab[:2]), (tag, n, name, "count changed")
            assert w_tab == w_ldg, (tag, n, name, w_tab, w_ldg)
            log("  table %-8s %-8s N %7d %-22s = plain = __ldg on every lane "
                "(slot, t, steps; %d warp-steps)"
                % (tag, table_mem, n, name, w_tab))


def ptxas_registers(text):
    """{(anyhit, count, table): registers} of traverse_kernel's
    instantiations, from nvcc's -Xptxas -v output of csrc/traverse.cu."""
    import re
    regs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"traverse_kernelILb([01])ELb([01])ELb([01])E", line)
        if m and "Compiling" in line:
            cur = tuple(x == "1" for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            regs[cur] = int(m.group(1))
            cur = None
    return regs


def residency_sets(np, torch, g, fb, pool, dev, camera_rays,
                   incoherent_rays):
    """The sets both residencies are timed on: {name: (o, d, kwargs,
    anyhit, mask or None, active rays)}."""
    co, cd = camera_rays(1024, dev)
    io, idr = incoherent_rays(N_TIME, fb, 8, dev)
    half = torch.from_numpy(g.random(N_TIME) < 0.5).to(dev)
    act = pool["active"]
    return {
        "coherent_closest": (co, cd, dict(active_prefix=N_TIME), False, None,
                             N_TIME),
        "coherent_anyhit": (co, cd, dict(active=half, anyhit=True), True,
                            half, int(half.sum())),
        "incoherent_closest": (io, idr, dict(active_prefix=N_TIME), False,
                               None, N_TIME),
        "pool_closest": (pool["orig"], pool["dir"], dict(active=act), False,
                         act, int(act.sum())),
        "pool_anyhit": (pool["orig"], pool["dir"],
                        dict(active=act, anyhit=True), True, act,
                        int(act.sum())),
    }


def time_residency(torch, ops, trav, cuda_ms, packed, sd, sets, table_mem,
                   tag, regs):
    """Phase 5d on one stream: the __ldg kernel and the kTable kernel as
    bare launches in turns (ldg, table, table, ldg) on each set, after
    holding both to the plain version on every lane. Returns {set: dict}."""
    K = packed.shape[0]
    S, block, smem = ops.table_plan(K, N_TIME, table_mem)
    out = {}
    for name, (o, d, kw, anyhit, mask, n_act) in sets.items():
        def bare(tm, count=False, rows=None):
            return ops.launch_fn(packed, o, d, RAY_MIN, RAY_MAX,
                                 stack_depth=sd, count_steps=count,
                                 table_mem=tm, table_rows=rows, **kw)
        got = {}
        for tm in ("vmem", table_mem):
            res = ops.packet_intersect(packed, o, d, RAY_MIN, RAY_MAX,
                                       stack_depth=sd, count_steps=True,
                                       table_mem=tm, **kw)
            got[tm] = (res, int(ops.last_warp_steps()))

        def plain():
            return trav.intersect_scene(None, None, None, o, d, RAY_MIN,
                                        RAY_MAX, anyhit=anyhit,
                                        stack_depth=sd, active=mask,
                                        packed=packed, count_steps=True)
        p_ms = cuda_ms(plain, 1)
        want = plain()
        for tm, (res, _) in got.items():
            assert same(torch, res, want), (tag, name, tm, "!= plain version")
        warp_steps = got["vmem"][1]
        assert got[table_mem][1] == warp_steps, (tag, name, "warp-steps")
        steps_sum = int(want[2].sum().item())
        f_l, f_t = bare("vmem"), bare(table_mem)
        l1 = cuda_ms(f_l, 20)
        t1 = cuda_ms(f_t, 20)
        t2 = cuda_ms(f_t, 20)
        l2 = cuda_ms(f_l, 20)
        assert same(torch, f_t(), f_l()), (tag, name, "bare launches differ")
        tc = cuda_ms(bare(table_mem, count=True), 20)
        n = o.shape[0]
        b, by, _, _ = trav_bound_ms(n, n_act, K, mask is not None, False,
                                    steps_sum)
        bc, byc, _, _ = trav_bound_ms(n, n_act, K, mask is not None, True,
                                      steps_sum)
        row = {"lanes": n, "rays": n_act, "steps_sum": steps_sum,
               "steps_per_ray": steps_sum / max(n_act, 1),
               "warp_steps": warp_steps, "ldg_ms": [l1, l2],
               "table_ms": [t1, t2], "table_count_ms": tc, "plain_ms": p_ms,
               "bound_ms": b, "bound_by": by, "count_bound_ms": bc,
               "count_bound_by": byc,
               "ldg_ns_per_warp_step": min(l1, l2) * 1e6 / warp_steps,
               "table_ns_per_warp_step": min(t1, t2) * 1e6 / warp_steps,
               "ldg_bound_share": b / min(l1, l2),
               "table_bound_share": b / min(t1, t2), "max_abs_err": 0.0}
        if name == "coherent_closest":
            row["sweep_ms"] = {rows: cuda_ms(bare(table_mem, rows=rows), 20)
                               for rows in (8, 32, 288)
                               if rows <= min(K, ops.TABLE_MAX_ROWS)}
        out[name] = row
        log("  residency %-13s %-18s __ldg %.4f/%.4f ms (%.3f ns per "
            "warp-step, %.1f%% of bound)  %s S=%d %.4f/%.4f ms (%.3f ns, "
            "%.1f%%)  table/__ldg %.3f  [%.2f steps per ray, bound %.4f ms "
            "by %s]%s"
            % (tag, name, l1, l2, row["ldg_ns_per_warp_step"],
               100 * row["ldg_bound_share"], table_mem, S, t1, t2,
               row["table_ns_per_warp_step"], 100 * row["table_bound_share"],
               min(t1, t2) / min(l1, l2), row["steps_per_ray"], b, by,
               "  sweep S: " + ", ".join(
                   "%d: %.4f" % kv for kv in row["sweep_ms"].items())
               if "sweep_ms" in row else ""))
    log("  residency %-13s plan: S %d rows, block %d, %d bytes of shared "
        "memory a block; registers table %s, __ldg %s"
        % (tag, S, block, smem,
           sorted(v for k, v in regs.items() if k[2]) or "not built here",
           sorted(v for k, v in regs.items() if not k[2])
           or "not built here"))
    return {"table_mem": table_mem, "S": S, "block": block,
            "smem_bytes": smem, "sets": out}


def timed_frames(np, torch, ops, r, rc, spp, tag):
    """A 1-spp warm-up of the same key (it captures the regen waves), then
    spp timed frames with every launch count set to 0 before and read
    after. Returns the record and the image."""
    r.render_frames(r.zeros_accum(), rc, 1, 1, with_stats=True)
    torch.cuda.synchronize()
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t_host = time.time()
    start.record()
    acc, waves, rays = r.render_frames(r.zeros_accum(), rc, 1, spp,
                                       with_stats=True)
    stop.record()
    torch.cuda.synchronize()
    t_host = time.time() - t_host
    launches = read_counts()
    ms = start.elapsed_time(stop)
    img = acc.cpu().numpy() / spp
    assert img.shape == (r.width * r.height, 3), (tag, img.shape)
    assert np.all(np.isfinite(img)), "%s: non-finite radiance" % tag
    assert float(img.mean()) > 0.01, "%s: black image" % tag
    rec = {"width": r.width, "height": r.height, "spp": spp,
           "integrator": r.settings.integrator,
           "pool_lanes": r.settings.pool_lanes,
           "table_mem": r.settings.packet_table_mem,
           "ms_per_frame": ms / spp, "host_s": t_host, "waves": waves,
           "traced_rays": rays, "mrays_per_s": rays / (ms / 1e3) / 1e6,
           "mean_radiance": float(img.mean()), "launches": launches,
           "launches_per_frame": {k: v / spp for k, v in launches.items()
                                  if v}}
    if r.settings.integrator == "regen":
        rec["waves_by_width"] = r.regen_integrator(True).last_waves
    log("%s %dx%d x %d spp (%s, table_mem=%s): %.1f ms per 1-spp frame, "
        "%d %s, %.0f rays, %.1f Mrays/s, launches per frame %s"
        % (tag, r.width, r.height, spp, r.settings.integrator,
           rec["table_mem"], ms / spp, waves,
           "bounces" if r.settings.integrator == "bounce" else "waves",
           rays, rec["mrays_per_s"], rec["launches_per_frame"]))
    return rec, img


def marginal_ms(torch, r, rc):
    """(steady, one) ms: the steady frame as the marginal of render calls of
    1 and 3 frames ((t3 - t1) / 2, so a call's drain cancels) and the
    1-spp call, host clocks around synchronized calls."""
    def t(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render_frames(r.zeros_accum(), rc, 1, n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    t1, t3 = t(1), t(3)
    return (t3 - t1) / 2, t1


AB_TURNS = 5


def measure_ab(root):
    """`--ab DIR`: the frame times of the port in the checkout DIR on the
    card, for an A/B of two checkouts inside one call (parent, tree, tree,
    parent). It uses only what the port has had since its viewer slice
    (Renderer.render_frames, the demo scenes, tools/probe_viewer.probe,
    tools/profile_frame.profile, ops.traverse_packet.launch_fn), so it
    measures an older checkout as well. Medians of AB_TURNS turns, after a
    warm-up of each renderer (kernel build, BVH load, capture): the TestObj,
    sss and media steady frames and 1-spp calls at 1024x1024 (marginal_ms),
    the viewer's ladder at a 1920x1080 window, the idle share of profiled
    TestObj calls of 1 and 3 frames (busy over each window of one trace)
    beside the marginal readings, the same for the TestObj bounce frames
    (integrator="bounce", in the port since its bounce slice), the capture
    time where the checkout captures, max_memory_allocated, and the bare
    traversal launch on 1M coherent camera rays (closest hit over the whole
    int prefix; any hit under a 50% mask) with ptxas's registers, and,
    where the checkout has the shade kernel (ops/shade.py), its bare launch
    and the plain shade at P_SHADE lanes of every material, and where it
    has the surface fetch kernels (ops/surface_fetch.py), their bare
    launches and plain versions at P_FETCH lanes (phase 13a's inputs).
    Returns the record."""
    import dataclasses
    import statistics
    import numpy as np
    sys.path.insert(0, os.path.abspath(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke --ab: no CUDA device")
    import tpu_pathtracer_torch
    from tpu_pathtracer_torch.utils import cuda_build
    from tpu_pathtracer_torch.utils.timing import cuda_ms
    from tpu_pathtracer_torch.ops import traverse_packet as ops
    from tpu_pathtracer_torch.scene import demo
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    from tpu_pathtracer_torch.tools import probe_viewer, profile_frame
    from tpu_pathtracer_torch.tools.probe_steps import camera_rays
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    W = 1024
    cache = os.path.join(HERE, ".bvh_cache_torch")     # shared by the runs
    rc = demo.default_camera(W, W).build_render_camera()
    rec = {"root": os.path.abspath(root), "card": card_line(),
           "package": os.path.dirname(tpu_pathtracer_torch.__file__)}
    log_text = cuda_build.KernelLibs(["traverse"]).logs.get("traverse", "")
    rec["ptxas_registers"] = {"<%d,%d,%d>" % k: v for k, v in
                              ptxas_registers(log_text).items()}
    t_start = time.time()

    def frames(r):
        marginal_ms(torch, r, rc)                          # warm-up
        got = [marginal_ms(torch, r, rc) for _ in range(AB_TURNS)]
        out = {"steady_runs": [a for a, _ in got],
               "render_1spp_runs": [b for _, b in got]}
        out["steady_ms"] = statistics.median(out["steady_runs"])
        out["render_1spp_ms"] = statistics.median(out["render_1spp_runs"])
        out["capture_s"] = [fn.graph.capture_s for fn in getattr(
            r, "_integrators", {}).values() if getattr(fn, "graph", None)]
        return out

    parts = demo.testobj_scene(cache_dir=cache)
    r = Renderer(parts[0], parts[1], envmap=parts[2], texture=parts[3],
                 width=W, height=W, device=dev)
    rec["testobj"] = frames(r)
    lo, hi, marg = profile_frame.profile(r, rc, (1, 3))["spans"]
    rec["testobj"]["profile"] = {
        "calls": [{k: sp[k] for k in ("frames", "window_ms", "busy_ms",
                                      "idle_share")} for sp in (lo, hi)],
        "marginal": {k: marg[k] for k in ("busy_ms", "window_ms", "frame_ms",
                                          "idle_share", "frame_idle_share")}}
    rb = Renderer(parts[0], parts[1], envmap=parts[2], texture=parts[3],
                  width=W, height=W, base_scene=r.scene, device=dev)
    rb.settings = dataclasses.replace(rb.settings, integrator="bounce")
    rec["testobj_bounce"] = frames(rb)
    lo, hi, _ = profile_frame.profile(rb, rc, (1, 3))["spans"]
    rec["testobj_bounce"]["profile"] = {"calls": [
        {k: sp[k] for k in ("frames", "window_ms", "busy_ms", "idle_share")}
        for sp in (lo, hi)]}
    del rb
    torch.cuda.empty_cache()
    rec["shade_kernel"] = None
    if os.path.exists(os.path.join(rec["package"], "ops", "shade.py")):
        from tpu_pathtracer_torch.ops import shade as shade_ops
        inputs = test_inputs("shade")
        s_scene, s_args, s_id, _ = inputs.mixed_inputs(P_SHADE, 12, dev)
        fn = shade_ops.launch_fn(s_scene, *inputs.kernel_args(s_args, s_id))
        rec["shade_kernel"] = {
            "lanes": P_SHADE,
            "kernel_ms": [cuda_ms(fn, 50), cuda_ms(fn, 50)],
            "plain_ms": [cuda_ms(lambda: shade_ops.shade_plain(
                s_scene, None, *s_args), 5) for _ in range(2)]}
        del s_scene, s_args, s_id, fn
        torch.cuda.empty_cache()
    rec["fetch_kernels"] = None
    if os.path.exists(os.path.join(rec["package"], "ops",
                                   "surface_fetch.py")):
        from tpu_pathtracer_torch.ops import surface_fetch as sf
        inputs = test_inputs("fetch")
        rec["fetch_kernels"] = {"lanes": P_FETCH}
        for name in FETCH_KERNELS:
            args = inputs.kernel_inputs(name, r.scene, P_FETCH, 1, dev)
            fn = sf.launch_fn(name, r.scene, *args)
            rec["fetch_kernels"][name] = {
                "kernel_ms": [cuda_ms(fn, 50), cuda_ms(fn, 50)],
                "plain_ms": [cuda_ms(lambda: inputs.run_plain(
                    name, r.scene, *args), 5) for _ in range(2)]}
            del args, fn
        torch.cuda.empty_cache()
    o, d = camera_rays(W, dev)
    half = torch.from_numpy(
        np.random.default_rng(5).random(o.shape[0]) < 0.5).to(dev)
    rec["kernel"] = {}
    for name, kw in (("closest", dict(active_prefix=o.shape[0])),
                     ("anyhit", dict(active=half, anyhit=True))):
        fn = ops.launch_fn(r.scene["packed"], o, d, RAY_MIN, RAY_MAX,
                           stack_depth=parts[0].max_depth + 2, **kw)
        rec["kernel"][name + "_ms"] = [cuda_ms(fn, 50), cuda_ms(fn, 50)]
    del r, o, d, half
    for variant in ("sss", "media"):
        fb, mats, env, tex = demo.large_organic_scene(cache_dir=cache,
                                                      variant=variant)
        rec[variant] = frames(Renderer(fb, mats, envmap=env, texture=tex,
                                       width=W, height=W, device=dev))
        torch.cuda.empty_cache()
    view = probe_viewer.probe(parts, VIEWER_H, dev, reps=AB_TURNS)
    rec["viewer_1080p"] = {"preview": view["preview"],
                           "full_1spp_ms": view["full_ms"],
                           "batch4_ms_per_frame":
                               view["batch4_ms_per_frame"]}
    rec["max_memory_allocated_gb"] = \
        torch.cuda.max_memory_allocated(dev) / 1e9
    rec["s"] = time.time() - t_start
    return rec


FETCH_KERNELS = {"fetch_attributes": "fetch_attributes_kernel",
                 "env_tex_merged": "env_tex_merged_kernel",
                 "texture_radiance": "texture_radiance_kernel"}


def kernel_events(prof):
    """Device kernel events of a finished torch.profiler session, from its
    chrome trace: {"all", "traverse_kernel", "shade_kernel"} and the
    surface fetches' kernels (FETCH_KERNELS) counts."""
    import tempfile
    from tpu_pathtracer_torch.utils.profiling import load_events
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        names = [e.get("name", "") for e in load_events(path)
                 if e.get("cat") == "kernel"]
    return {"all": len(names),
            **{k: sum(k in n for n in names) for k in (
                "traverse_kernel", "shade_kernel",
                *FETCH_KERNELS.values())}}


def event_ms(torch, fn):
    """(result, ms) of one call of fn, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def run_cli(args, tag):
    """Run the port's CLI in a subprocess from the checkout's root; fatal
    unless it exits 0. Returns (seconds, stdout)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_pathtracer_torch.tools.render"] + args,
        cwd=HERE, capture_output=True, text=True, timeout=300)
    dt = time.time() - t0
    for line in (proc.stdout + proc.stderr).strip().splitlines()[-4:]:
        log("  cli %s | %s" % (tag, line))
    assert proc.returncode == 0, (tag, proc.returncode, proc.stderr[-2000:])
    return dt, proc.stdout


def phase8(np, torch, ops, dev, fb, mats, envmap, texture, sss_parts, rc,
           cache, W):
    """Phase 8 at W x W (rc: the camera at that size): the bounce
    integrator, lane chunks and shards, the last regen orders and the CLI.
    Returns the record."""
    import dataclasses
    import shutil
    import tempfile
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    from tpu_pathtracer_torch.parallel import ShardedRenderer, make_mesh
    from tpu_pathtracer_torch.core.image import read_ppm
    H = W
    rec = {}

    # ---- 8a. bounce on TestObj, full width, against regen ----
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=H, device=dev)
    regen_s = r.settings
    bounce_s = dataclasses.replace(regen_s, integrator="bounce")
    r.settings = bounce_s
    b_rec, b_img = timed_frames(np, torch, ops, r, rc, 2, "8a bounce")
    for k in ("traverse_closest", "traverse_anyhit", "shade",
              "fetch_attributes", "texture_radiance"):
        assert b_rec["launches"][k] > 0, "bounce never launched %s" % k
    r.settings = regen_s
    g_rec, g_img = timed_frames(np, torch, ops, r, rc, 2, "8a regen")
    b_rec["gate_vs_regen"] = gate(np, b_img, g_img, "bounce vs regen")
    b_rec["bounce_over_regen"] = b_rec["ms_per_frame"] / g_rec["ms_per_frame"]
    log("  8a bounce/regen frame time %.3f (%.1f / %.1f ms), %.1f bounces "
        "a frame" % (b_rec["bounce_over_regen"], b_rec["ms_per_frame"],
                     g_rec["ms_per_frame"], b_rec["waves"] / 2))
    rec["testobj"] = {"bounce": b_rec, "regen": g_rec}

    # ---- 8b. bounce on the organic sss scene: row 3 through bounce ----
    fb_s, mats_s, env_s, tex_s = sss_parts
    rs = Renderer(fb_s, mats_s, envmap=env_s, texture=tex_s, width=W,
                  height=H, device=dev)
    sss_regen = rs.settings
    rs.settings = dataclasses.replace(sss_regen, integrator="bounce")
    sb_rec, sb_img = timed_frames(np, torch, ops, rs, rc, 1, "8b sss bounce")
    assert sb_rec["launches"]["closest_mask_lane_tmax"] > 0, \
        "bounce on the sss scene never launched the probe form (row 3)"
    rs.settings = sss_regen
    sg_rec, sg_img = timed_frames(np, torch, ops, rs, rc, 1, "8b sss regen")
    sb_rec["gate_vs_regen"] = gate(np, sb_img, sg_img, "sss bounce/regen")
    sb_rec["bounce_over_regen"] = sb_rec["ms_per_frame"] \
        / sg_rec["ms_per_frame"]
    rec["organic_sss"] = {"bounce": sb_rec, "regen": sg_rec}
    del rs
    torch.cuda.empty_cache()

    # ---- 8c. lane chunks and 2 shards on the one card, 1 spp ----
    r.settings = bounce_s

    def frame(rr):
        return rr.render_frames(rr.zeros_accum(), rc, 1, 1)
    frame(r)                                  # warm-ups: the captures
    whole, t_whole = event_ms(torch, lambda: frame(r))
    chunked = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                       height=H, settings=bounce_s, lane_chunk=W * H // 4,
                       base_scene=r.scene, device=dev)
    assert chunked.scene["packed"] is r.scene["packed"]
    frame(chunked)
    got, t_chunk = event_ms(torch, lambda: frame(chunked))
    assert torch.equal(got, whole), "4 lane chunks != the whole bounce frame"
    sr = ShardedRenderer(r, mesh=make_mesh([dev, dev]))
    frame(sr)
    got, t_shard = event_ms(torch, lambda: frame(sr))
    assert torch.equal(got[:W * H], whole), "2 shards != 1 (bounce)"
    r.settings = regen_s
    frame(r)                                  # warm-ups: the captures
    g_whole, t_g_whole = event_ms(torch, lambda: frame(r))
    sr = ShardedRenderer(r, mesh=make_mesh([dev, dev]))
    frame(sr)
    got, t_g_shard = event_ms(torch, lambda: frame(sr))
    g_gate = gate(np, got[:W * H].cpu().numpy(), g_whole.cpu().numpy(),
                  "2 regen shards")
    rec["chunks_shards"] = {
        "bounce_whole_ms": t_whole, "bounce_4_chunks_ms": t_chunk,
        "bounce_2_shards_ms": t_shard, "regen_whole_ms": t_g_whole,
        "regen_2_shards_ms": t_g_shard, "regen_shards_gate": g_gate,
        "bounce_bit_for_bit": True}
    log("  8c bounce whole %.1f ms, 4 chunks %.1f ms, 2 shards %.1f ms (bit "
        "for bit); regen whole %.1f ms, 2 shards %.1f ms"
        % (t_whole, t_chunk, t_shard, t_g_whole, t_g_shard))
    del whole, got, g_whole, sr, chunked

    # ---- 8d. the last regen orders at full width, 2 spp ----
    def frames2(settings):
        r.settings = settings
        r.render_frames(r.zeros_accum(), rc, 1, 2)       # warm-up, capture
        return event_ms(torch, lambda: r.render_frames(r.zeros_accum(), rc,
                                                       1, 2))
    compact, t_compact = frames2(regen_s)
    inplace, t_inplace = frames2(dataclasses.replace(regen_s,
                                                     regen_order="inplace"))
    in_gate = gate(np, inplace.cpu().numpy() / 2, compact.cpu().numpy() / 2,
                   "inplace/compact")
    rec["orders"] = {"compact_ms_per_frame": t_compact / 2,
                     "inplace_ms_per_frame": t_inplace / 2,
                     "inplace_gate": in_gate}
    log("  8d ms per frame: compact %.1f, inplace %.1f"
        % (t_compact / 2, t_inplace / 2))
    r.settings = regen_s
    del r, compact, inplace
    torch.cuda.empty_cache()

    # ---- 8e. the CLI, to a PPM, checkpointed, then resumed ----
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        out, ck = os.path.join(tmp, "x.ppm"), os.path.join(tmp, "x.npz")
        common = ["--demo", "default", "--size", str(CLI_SIZE), "--out", out,
                  "--cache-dir", cache]
        t_first, _ = run_cli(common + ["--spp", "8", "--checkpoint", ck],
                             "8 spp")
        assert int(np.load(ck)["frame"]) == 8
        t_resume, text = run_cli(common + ["--spp", "16", "--resume", ck],
                                 "resume to 16 spp")
        assert "resumed at frame 8" in text, text
        img = read_ppm(out)
        z = np.load(ck)
        assert img.shape == (CLI_SIZE, CLI_SIZE, 3) \
            and np.isfinite(img).all()
        assert img.max() > 0 and img.mean() > 0.02, "the CLI's image is black"
        assert int(z["frame"]) == 16, int(z["frame"])
        assert np.isfinite(z["accum"]).all() and z["accum"].mean() > 0
        with open(out + ".wall.json") as f:
            wall = json.load(f)
        rec["cli"] = {"first_s": t_first, "resume_s": t_resume,
                      "ppm_mean": float(img.mean()), "frame": int(z["frame"]),
                      "wall": wall}
        log("  8e CLI: 8 spp in %.1f s, resumed to 16 spp in %.1f s, PPM mean "
            "%.1f, checkpoint frame %d" % (t_first, t_resume, img.mean(),
                                           int(z["frame"])))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def viewer_script(keys, env_keys):
    """Phase 9a's steps: [(events, seconds the clock moves after the
    step)]: every binding once, a left drag, a wheel step and space, each
    inside the preview window, then 4 converging steps."""
    from tpu_pathtracer_torch.tools.interactive import MOVING_S
    inside = MOVING_S / 5
    steps = [([k], inside) for k in list(keys) + list(env_keys)
             + [",", "."]]
    steps += [([("MOUSE", "press", 0, False, 40, 20),
                ("MOUSE", "drag", 0, False, 44, 22)], inside),
              ([("MOUSE", "wheel", 1, False, 44, 22)], inside),
              ([" "], 2 * MOVING_S)]
    return steps + [([], 0.5)] * 4


def phase9(np, torch, ops, dev, parts, sss_parts, cache, W):
    """Phase 9: the viewer (9a) at a 1080p window, the showcase (9c), the
    gallery (9d), the profiles (9e) at W x W and the viewer's image kernel
    (9g). parts / sss_parts:
    (flat_bvh, materials, envmap, texture) of TestObj and the sss scene.
    Returns the record."""
    import dataclasses
    import shutil
    import tempfile
    from tpu_pathtracer_torch.core.image import read_ppm
    from tpu_pathtracer_torch.ops import image as image_ops
    from tpu_pathtracer_torch.scene import demo
    from tpu_pathtracer_torch.tracer.renderer import Renderer, lane_tables
    from tpu_pathtracer_torch.utils.timing import cuda_ms
    from tpu_pathtracer_torch.tools import (
        interactive, showcase_1080p, gallery, profile_frame)
    from tpu_pathtracer_torch.tools.render import _save_image
    fb, mats, envmap, texture = parts
    rec = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p9_")
    try:
        # ---- 9a. a scripted viewer session at a 1920x1080 window ----
        VW, VH, batch = VIEWER_H * 16 // 9, VIEWER_H, 4
        r = Renderer(fb, mats, envmap=envmap, texture=texture, width=VW,
                     height=VH, device=dev)
        lo = interactive.preview_renderer(r, parts, 2)
        assert lo is not None and (lo.width, lo.height) == (VW // 2, VH // 2)
        clock = [0.0]
        sess = interactive.ViewerSession(
            r, demo.default_camera(VW, VH), lo, batch=batch,
            cam_path=os.path.join(tmp, "viewer.cam"), out_dir=tmp,
            clock=lambda: clock[0])
        sess.step([])                               # warm-up (full, 4 spp)
        sess.step([" "])                            # and a preview
        torch.cuda.synchronize()
        zero_counts()
        image_launches = image_ops.LAUNCHES["unswizzle_upscale"]
        steps = {"preview": 0, "full": 0}
        for events, dt in viewer_script(interactive.KEYS,
                                        interactive.ENV_KEYS):
            img = sess.step(events)
            steps[sess.kind] += 1
            assert img.shape == (VH, VW, 3) and img.dtype == np.uint8
            clock[0] += dt
        viewer_launches = read_counts()
        viewer_launches["unswizzle_upscale"] = \
            image_ops.LAUNCHES["unswizzle_upscale"] - image_launches
        assert viewer_launches["unswizzle_upscale"] == sum(
            steps.values()), "not one image launch a step"
        assert sess.step(["q"]) is None
        for k in ("traverse_closest", "traverse_anyhit", "shade",
                  "fetch_attributes", "env_tex_merged"):
            assert viewer_launches[k] > 0, "the viewer never launched " + k
        assert sess.kind == "full" and sess.frame == 4 * batch, sess.frame
        assert steps["preview"] == len(interactive.KEYS) + len(
            interactive.ENV_KEYS) + 5, steps
        want = r.render_frames(r.zeros_accum(), sess.camera, 1, sess.frame)
        v_gate = gate(np, r.accum_to_buffer(sess.accum) / sess.frame,
                      r.accum_to_buffer(want) / sess.frame,
                      "viewer vs render")
        dev_img = r.accum_to_image(sess.accum, sess.frame)
        host_img = r.accum_to_image(sess.accum.cpu().numpy(), sess.frame)
        d = np.abs(dev_img.astype(np.int32) - host_img.astype(np.int32))
        assert int(d.max()) <= 1, "device tonemap off by %d" % d.max()
        sess.close()
        assert read_ppm(os.path.join(tmp, "output500.ppm")).shape == \
            (VH, VW, 3)
        rec["viewer"] = {
            "window": [VW, VH], "preview": [lo.width, lo.height],
            "batch": batch, "steps": steps,
            "launches": viewer_launches, "gate_vs_render": v_gate,
            "tonemap_max_step": int(d.max()),
            "tonemap_pixels_differing": int((d.max(axis=2) > 0).sum())}
        log("  9a viewer %dx%d: %d preview steps (%dx%d), %d full steps of "
            "%d spp; launches %s; device tonemap = host within %d step, %d "
            "pixels differ; output500.ppm written"
            % (VW, VH, steps["preview"], lo.width, lo.height, steps["full"],
               batch, {k: v for k, v in viewer_launches.items() if v},
               d.max(), rec["viewer"]["tonemap_pixels_differing"]))
        del sess, lo, r, want
        torch.cuda.empty_cache()

        # ---- 9c. the 1080p showcase, 8 spp, to a PPM ----
        out = os.path.join(tmp, "showcase.ppm")
        sc = showcase_1080p.render_showcase(VW, VH, SHOWCASE_ENV, 8, out,
                                            cache, dev)
        img = read_ppm(out)
        assert img.shape == (VH, VW, 3) and np.isfinite(img).all()
        assert img.mean() > 0.05, "the showcase is black"
        sc["ppm_mean"] = float(img.mean())
        rec["showcase"] = sc
        log("  9c showcase %dx%d: env io %.2f s, renderer build %.2f s, "
            "first frame %.3f s, %d more spp %.2f s (%.1f ms/frame), PPM "
            "mean %.3f" % (VW, VH, sc["env_io_s"], sc["build_s"],
                           sc["first_frame_s"], sc["spp"] - 1, sc["rest_s"],
                           sc["rest_ms_per_frame"], sc["ppm_mean"]))
        torch.cuda.empty_cache()

        # ---- 9d. the gallery, every variant, 128x128, 4 spp ----
        gparts = gallery.scene_parts(cache)
        rec["gallery"] = {}
        for name, gmats in gallery.variants().items():
            t0 = time.perf_counter()
            gr, acc = gallery.render_variant(name, gmats, GALLERY_SIZE, 4,
                                             gparts, dev)
            path = os.path.join(tmp, name + ".ppm")
            _save_image(path, gr, acc, 4)
            gimg = read_ppm(path)
            assert gimg.shape == (GALLERY_SIZE, GALLERY_SIZE, 3)
            assert np.isfinite(gimg).all(), name
            assert np.isfinite(acc.cpu().numpy()).all(), name
            assert gimg.mean() > 0.02, (name, "black")
            rec["gallery"][name] = {"s": time.perf_counter() - t0,
                                    "ppm_mean": float(gimg.mean())}
        log("  9d gallery %dx%d x 4 spp: " % (GALLERY_SIZE, GALLERY_SIZE)
            + ", ".join(
            "%s %.2f s" % (k, v["s"]) for k, v in rec["gallery"].items()))

        # ---- 9e. the marginal profiles ----
        rc = demo.default_camera(W, W).build_render_camera()
        rec["profiles"] = {}
        fb_s, mats_s, env_s, tex_s = sss_parts
        for tag, pparts, integrator, frames in (
                ("testobj_regen", parts, "regen", (1, 3)),
                ("sss_regen", sss_parts, "regen", (1, 3)),
                ("testobj_bounce", parts, "bounce", (1, 3))):
            pr = Renderer(pparts[0], pparts[1], envmap=pparts[2],
                          texture=pparts[3], width=W, height=W, device=dev)
            pr.settings = dataclasses.replace(pr.settings,
                                              integrator=integrator)
            t0 = time.perf_counter()
            prof = profile_frame.profile(pr, rc, frames)
            lines = profile_frame.report(prof, top=10)
            for line in lines:
                log("  9e %s %s" % (tag, line))
            lo_s, hi_s, marg = prof["spans"]
            assert lo_s["events"] > 0 and hi_s["events"] > 0, \
                (tag, "the profile holds no device event")
            ops_top = sorted(prof["ops"].items(), key=lambda kv: -kv[1])
            rec["profiles"][tag] = {
                "frames": list(frames), "rollup": prof["rollup"],
                "spans": prof["spans"],
                "op_sum_ms": sum(prof["ops"].values()),
                "top_ops": [[k, v, prof["meta"][k][1]]
                            for k, v in ops_top[:40]],
                "unlinked_device_ops_ms": sum(
                    v for k, v in prof["ops"].items()
                    if not prof["meta"][k][1]
                    and "traverse_kernel" not in k),
                "s": time.perf_counter() - t0}
            del pr
            torch.cuda.empty_cache()

        # ---- 9g. the viewer's image kernel ----
        # kernel ms: 100 bare launches replayed as one CUDA graph, so the
        # host's launch rate does not set the time of a few-us kernel
        rec["image_kernel"] = {}
        rng = np.random.default_rng(9)
        for (iw, ih), rep in (((VW // 2, VH // 2), 2), ((VW, VH), 1)):
            px, py = (torch.from_numpy(t).to(dev)
                      for t in lane_tables(iw, ih))
            rgb = torch.from_numpy(rng.integers(0, 256, (iw * ih, 3),
                                                dtype=np.uint8)).to(dev)
            want = image_ops.unswizzle_upscale_plain(rgb, px, py, iw, ih,
                                                     rep)
            fn = image_ops.launch_fn(rgb, px, py, iw, ih, rep)
            assert torch.equal(fn(), want), ("image kernel != plain", iw)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                gfn = image_ops.launch_fn(rgb, px, py, iw, ih, rep)
                for _ in range(100):
                    gfn()
            kernel_ms, plain_ms = [], []
            for which in ("plain", "kernel", "kernel", "plain"):
                if which == "kernel":
                    kernel_ms.append(cuda_ms(graph.replay, 10) / 100)
                else:
                    plain_ms.append(cuda_ms(
                        lambda: image_ops.unswizzle_upscale_plain(
                            rgb, px, py, iw, ih, rep), 20))
            assert torch.equal(gfn(), want), ("graph != plain", iw)
            eager_ms = cuda_ms(fn, 200)
            n_bytes = image_ops.io_bytes(iw * ih, rep)
            bound = n_bytes / HBM_BYTES_PER_S * 1e3
            key = "%dx%d_s%d" % (iw, ih, rep)
            rec["image_kernel"][key] = {
                "kernel_ms": kernel_ms, "eager_launch_ms": eager_ms,
                "plain_ms": plain_ms, "bytes": n_bytes, "bound_ms": bound,
                "bound_share": bound / min(kernel_ms)}
            log("  9g image kernel %s: = plain version; kernel %s ms "
                "(eager launches %.4f ms), plain %s ms, bound %.4f ms (%d "
                "B), kernel at %.1f%% of it"
                % (key, ["%.4f" % x for x in kernel_ms], eager_ms,
                   ["%.3f" % x for x in plain_ms], bound, n_bytes,
                   100 * bound / min(kernel_ms)))
            del px, py, rgb, want, fn, gfn, graph
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rec


def phase10(np, torch, ops, dev, scenes, W):
    """Phase 10: the replayed regen frame against the eager one, its
    timings, capture time and memory. scenes: {"testobj", "sss", "media"}
    -> scene parts. Returns the record."""
    from tpu_pathtracer_torch.scene import demo
    from tpu_pathtracer_torch.tracer import device_loop
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    rec = {}

    def renderer(tag, size):
        fb, mats, envmap, texture = scenes[tag]
        return (Renderer(fb, mats, envmap=envmap, texture=texture,
                         width=size, height=size, device=dev),
                demo.default_camera(size, size).build_render_camera())

    def counted(r, rc, spp, stats=True):
        zero_counts()
        out = r.render_frames(r.zeros_accum(), rc, 1, spp,
                              with_stats=stats)
        torch.cuda.synchronize()
        return out, {k: v for k, v in read_counts().items() if v}

    def captures(r, stats=True):
        g = r.regen_integrator(stats).graph
        return [] if g is None else [g.capture_s]

    # ---- 10a. replayed = eager bit for bit, deterministic, 256x256 ----
    rec["bit_for_bit"] = {}
    for tag in ("testobj", "sss", "media"):
        r, rc = renderer(tag, EXACT_SIZE)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with device_loop.no_graphs():
                (want, w_waves, w_rays), w_counts = counted(r, rc, 2)
            t0 = time.perf_counter()
            counted(r, rc, 2)                       # captures
            first_s = time.perf_counter() - t0
            (got, waves, rays), counts = counted(r, rc, 2)
            # the deterministic mode keys its own integrator
            by_width = r.regen_integrator(True).last_waves
            capture_s = captures(r)
        finally:
            torch.use_deterministic_algorithms(False)
        assert torch.equal(got, want), (tag, "replayed != eager")
        assert (waves, rays) == (w_waves, w_rays), (tag, waves, w_waves)
        assert counts == w_counts, (tag, counts, w_counts)
        assert capture_s and \
            sum(by_width.values()) == waves + device_loop.LAG - 1, \
            (tag, by_width, capture_s)
        rec["bit_for_bit"][tag] = {
            "waves": waves, "rays": rays, "launches": counts,
            "waves_by_width": by_width, "first_call_s": first_s,
            "capture_s": capture_s}
        log("  10a %-7s %dx%d x 2 spp: replayed = eager bit for bit "
            "(deterministic), %d waves %s, launches %s, first call %.2f s "
            "(captures %s s)" % (tag, EXACT_SIZE, EXACT_SIZE, waves,
                                 by_width, counts, first_s,
                                 ["%.2f" % c for c in capture_s]))
        del r, want, got
    torch.cuda.empty_cache()

    # ---- 10b. the gate at full width, no synchronising call ----
    r, rc = renderer("testobj", W)
    with device_loop.no_graphs():
        (want, _, _), w_counts = counted(r, rc, 2)
    counted(r, rc, 2)
    (got, _, _), counts = counted(r, rc, 2)
    assert counts == w_counts, (counts, w_counts)
    g_gate = gate(np, got.cpu().numpy() / 2, want.cpu().numpy() / 2,
                  "replayed vs eager 1024")
    r.render_frames(r.zeros_accum(), rc, 1, 2)          # warm the no-stats
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acc = r.render_frames(r.zeros_accum(), rc, 1, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all().item() and acc.mean().item() > 0
    rec["gate_1024"] = g_gate
    rec["sync_debug_error_passed"] = True
    log("  10b TestObj %dx%d x 2 spp: replayed vs eager %s; a replayed call "
        "ran under set_sync_debug_mode('error')" % (W, W, g_gate))
    del want, got, acc

    # ---- 10e. the launch counts against what the device ran ----
    # a replay launches no wrapper: its counts are the capture's, added a
    # replay; the profiler's traverse_kernel and shade_kernel events of
    # one replayed call must number what the counts say for that call
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, p_counts = counted(r, rc, 1)
    ev = kernel_events(prof)
    del prof
    by_width = r.regen_integrator(True).last_waves
    n_counted = sum(v for k, v in p_counts.items() if k in ops.LAUNCHES)
    assert ev["traverse_kernel"] == n_counted > 0, (ev, p_counts)
    assert ev["shade_kernel"] == p_counts.get("shade", 0) > 0, \
        (ev, p_counts)
    waves_run = sum(by_width.values())
    # the surface fetches: one fetch_attributes and one env_tex_merged
    # launch a wave, no texture_radiance (the merged gather gives it)
    fetch_ev = {name: ev[kern] for name, kern in FETCH_KERNELS.items()}
    assert fetch_ev == {name: p_counts.get(name, 0)
                        for name in FETCH_KERNELS} == {
        "fetch_attributes": waves_run, "env_tex_merged": waves_run,
        "texture_radiance": 0}, (fetch_ev, p_counts, by_width)
    rec["profiled_launches"] = {
        "traverse_kernel_events": ev["traverse_kernel"],
        "shade_kernel_events": ev["shade_kernel"],
        "fetch_kernel_events": fetch_ev,
        "kernel_events": ev["all"], "counted": p_counts,
        "waves_by_width": by_width,
        "kernels_per_wave": ev["all"] / waves_run}
    log("  10e a profiled replayed 1-spp call: %d traverse_kernel, %d "
        "shade_kernel and %s fetch events on the device = the launches "
        "counted %s (waves by width %s, the one past the end included); "
        "%d kernels in all, %.0f a wave"
        % (ev["traverse_kernel"], ev["shade_kernel"], fetch_ev, p_counts,
           by_width, ev["all"], ev["all"] / waves_run))

    # ---- 10c. times: replayed and eager in turns ----
    def marginal(rr, rcc):
        return marginal_ms(torch, rr, rcc)
    turns = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph", "graph", "eager"):
        if mode == "eager":
            with device_loop.no_graphs():
                turns[mode].append(marginal(r, rc))
        else:
            turns[mode].append(marginal(r, rc))
    steady = {m: [a for a, _ in v] for m, v in turns.items()}
    one = {m: [b for _, b in v] for m, v in turns.items()}
    rec["testobj_1024"] = {
        "steady_ms": steady, "render_1spp_ms": one,
        "steady_median_ms": {m: float(np.median(v))
                             for m, v in steady.items()},
        "render_1spp_median_ms": {m: float(np.median(v))
                                  for m, v in one.items()}}
    _, w1 = counted(r, rc, 1)
    rec["testobj_1024"]["waves_by_width_1spp"] = \
        r.regen_integrator(True).last_waves
    log("  10c TestObj %dx%d steady frame (marginal of frames (1, 3)): "
        "replayed %s, eager %s ms; 1-spp render call: replayed %s, eager "
        "%s ms; a 1-spp call's waves by width %s"
        % (W, W, ["%.1f" % x for x in steady["graph"]],
           ["%.1f" % x for x in steady["eager"]],
           ["%.1f" % x for x in one["graph"]],
           ["%.1f" % x for x in one["eager"]],
           rec["testobj_1024"]["waves_by_width_1spp"]))
    del r
    torch.cuda.empty_cache()
    for tag in ("sss", "media"):
        rs, rcs = renderer(tag, W)
        marginal(rs, rcs)                                  # captures
        got = [marginal(rs, rcs) for _ in range(3)]
        rec[tag + "_1024"] = {
            "steady_ms": [a for a, _ in got],
            "render_1spp_ms": [b for _, b in got],
            "steady_median_ms": float(np.median([a for a, _ in got]))}
        log("  10c %s %dx%d replayed: steady frame %s ms, 1-spp render "
            "call %s ms" % (tag, W, W, ["%.1f" % a for a, _ in got],
                            ["%.1f" % b for _, b in got]))
        del rs
        torch.cuda.empty_cache()

    # ---- 10d. capture time and peak memory of a 1024x1024 frame ----
    mem = {}
    for mode in ("eager", "graph"):
        r, rc = renderer("testobj", W)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        if mode == "eager":
            with device_loop.no_graphs():
                r.render_frames(r.zeros_accum(), rc, 1, 1)
        else:
            r.render_frames(r.zeros_accum(), rc, 1, 1)
        torch.cuda.synchronize()
        mem[mode] = {"first_call_s": time.perf_counter() - t0,
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                     "peak_over_start_gb": (torch.cuda.max_memory_allocated(
                         dev) - base) / 1e9,
                     "capture_s": captures(r, False)}
        del r
    rec["memory"] = mem
    log("  10d TestObj %dx%d first call: eager %.2f s, peak %.2f GB; "
        "replayed %.2f s (captures %s s, every drain width), peak %.2f GB"
        % (W, W, mem["eager"]["first_call_s"], mem["eager"]["peak_gb"],
           mem["graph"]["first_call_s"],
           ["%.2f" % c for c in mem["graph"]["capture_s"]],
           mem["graph"]["peak_gb"]))
    torch.cuda.empty_cache()
    return rec


def phase11(np, torch, ops, dev, scenes, W, bounce_profile):
    """Phase 11: the bounce integrator as one device program (frame start,
    bounces, frame end, each a captured graph) and sharded frames with
    every shard in flight. scenes: {"testobj", "sss", "media"} -> scene
    parts; bounce_profile: phase 9e's profile of the replayed TestObj
    bounce frames. Returns the record."""
    import dataclasses
    from tpu_pathtracer_torch.scene import demo
    from tpu_pathtracer_torch.tracer import device_loop
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    from tpu_pathtracer_torch.parallel import ShardedRenderer, make_mesh
    rec = {}

    def renderer(tag, size, integrator="bounce"):
        fb, mats, envmap, texture = scenes[tag]
        r = Renderer(fb, mats, envmap=envmap, texture=texture, width=size,
                     height=size, device=dev)
        r.settings = dataclasses.replace(r.settings, integrator=integrator)
        return r, demo.default_camera(size, size).build_render_camera()

    def counted(r, rc, spp, stats=True):
        zero_counts()
        out = r.render_frames(r.zeros_accum(), rc, 1, spp, with_stats=stats)
        torch.cuda.synchronize()
        return out, {k: v for k, v in read_counts().items() if v}

    # ---- 11a. replayed = eager bit for bit, deterministic, 256x256 ----
    rec["bit_for_bit"] = {}
    for tag in ("testobj", "sss", "media"):
        r, rc = renderer(tag, EXACT_SIZE)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with device_loop.no_graphs():
                (want, w_b, w_rays), w_counts = counted(r, rc, 2)
                w_launched = r.bounce_integrator(True).last_launched
            t0 = time.perf_counter()
            counted(r, rc, 2)                       # captures
            first_s = time.perf_counter() - t0
            (got, b, rays), counts = counted(r, rc, 2)
            fn = r.bounce_integrator(True)
            launched, capture_s = fn.last_launched, fn.graph.capture_s
        finally:
            torch.use_deterministic_algorithms(False)
        assert torch.equal(got, want), (tag, "replayed bounce != eager")
        assert (b, rays, launched) == (w_b, w_rays, w_launched), \
            (tag, b, w_b, launched, w_launched)
        assert counts == w_counts, (tag, counts, w_counts)
        assert counts["traverse_closest"] >= launched > 0
        rec["bit_for_bit"][tag] = {
            "bounces": b, "launched": launched, "rays": rays,
            "launches": counts, "first_call_s": first_s,
            "capture_s": capture_s}
        log("  11a %-7s %dx%d x 2 spp bounce: replayed = eager bit for bit "
            "(deterministic), %d bounces run, %d launched, launches %s, "
            "first call %.2f s (captures %.2f s)"
            % (tag, EXACT_SIZE, EXACT_SIZE, b, launched, counts, first_s,
               capture_s))
        del r, want, got
    torch.cuda.empty_cache()

    # ---- 11b. TestObj bounce at full width ----
    r, rc = renderer("testobj", W)
    g, grc = renderer("testobj", W, "regen")
    counted(r, rc, 2)                               # captures
    (b_img, b, rays), b_counts = counted(r, rc, 2)
    launched = r.bounce_integrator(True).last_launched
    counted(g, grc, 2)
    (g_img, _, _), _ = counted(g, grc, 2)
    b_gate = gate(np, b_img.cpu().numpy() / 2, g_img.cpu().numpy() / 2,
                  "replayed bounce vs regen %d" % W)
    del g, g_img, b_img
    marginal_ms(torch, r, rc)                           # the no-stats key
    with device_loop.no_graphs():
        marginal_ms(torch, r, rc)
    turns = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph", "graph", "eager"):
        if mode == "eager":
            with device_loop.no_graphs():
                turns[mode].append(marginal_ms(torch, r, rc))
        else:
            turns[mode].append(marginal_ms(torch, r, rc))
    steady = {m: [a for a, _ in v] for m, v in turns.items()}
    one = {m: [c for _, c in v] for m, v in turns.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acc = r.render_frames(r.zeros_accum(), rc, 1, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(acc).all().item() and acc.mean().item() > 0
    lo, hi, _ = bounce_profile["spans"]
    rec["testobj_1024"] = {
        "gate_vs_regen": b_gate, "bounces_2spp": b, "launched_2spp": launched,
        "overrun_per_frame": (launched - b) / 2, "rays_2spp": rays,
        "launches_2spp": b_counts, "steady_ms": steady,
        "render_1spp_ms": one,
        "steady_median_ms": {m: float(np.median(v))
                             for m, v in steady.items()},
        "render_1spp_median_ms": {m: float(np.median(v))
                                  for m, v in one.items()},
        "profiled_calls": {"%d_frames" % sp["frames"]: {
            k: sp[k] for k in ("window_ms", "busy_ms", "idle_share")}
            for sp in (lo, hi)},
        "sync_debug_error_passed": True}
    log("  11b TestObj bounce %dx%d: vs regen %s; %d bounces run, %d "
        "launched in 2 spp (over-run %.1f a frame); steady frame (marginal "
        "of frames (1, 3)) replayed %s, eager %s ms; 1-spp call replayed "
        "%s, eager %s ms; profiled calls (9e) busy %.1f / %.1f ms, idle "
        "%.1f%% / %.1f%%; a replayed call ran under "
        "set_sync_debug_mode('error')"
        % (W, W, b_gate, b, launched, (launched - b) / 2,
           ["%.1f" % x for x in steady["graph"]],
           ["%.1f" % x for x in steady["eager"]],
           ["%.1f" % x for x in one["graph"]],
           ["%.1f" % x for x in one["eager"]], lo["busy_ms"],
           hi["busy_ms"], 100 * lo["idle_share"], 100 * hi["idle_share"]))
    del acc

    # ---- 11c. the launch counts against what the device ran ----
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, p_counts = counted(r, rc, 1)
    p_launched = r.bounce_integrator(True).last_launched
    ev = kernel_events(prof)
    del prof
    n_counted = sum(v for k, v in p_counts.items() if k in ops.LAUNCHES)
    assert ev["traverse_kernel"] == n_counted > 0, (ev, p_counts)
    assert ev["shade_kernel"] == p_counts.get("shade", 0) == p_launched, \
        (ev, p_counts, p_launched)
    # one fetch_attributes and one texture_radiance launch a bounce; the
    # env miss of frame_end is the plain env_miss_weighted
    fetch_ev = {name: ev[kern] for name, kern in FETCH_KERNELS.items()}
    assert fetch_ev == {name: p_counts.get(name, 0)
                        for name in FETCH_KERNELS} == {
        "fetch_attributes": p_launched, "env_tex_merged": 0,
        "texture_radiance": p_launched}, (fetch_ev, p_counts, p_launched)
    rec["profiled_launches"] = {
        "traverse_kernel_events": ev["traverse_kernel"],
        "shade_kernel_events": ev["shade_kernel"],
        "fetch_kernel_events": fetch_ev,
        "kernel_events": ev["all"], "counted": p_counts,
        "bounces_launched": p_launched,
        "kernels_per_bounce": ev["all"] / p_launched}
    log("  11c a profiled replayed 1-spp bounce call: %d traverse_kernel, "
        "%d shade_kernel and %s fetch events on the device = the launches "
        "counted %s (%d bounces launched); %d kernels in all, %.0f a "
        "bounce" % (ev["traverse_kernel"], ev["shade_kernel"], fetch_ev,
                    p_counts, p_launched, ev["all"], ev["all"] / p_launched))
    del r
    torch.cuda.empty_cache()

    # ---- 11b. capture time and peak memory of a 1024x1024 frame ----
    mem = {}
    for mode in ("eager", "graph"):
        r, rc = renderer("testobj", W)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        if mode == "eager":
            with device_loop.no_graphs():
                r.render_frames(r.zeros_accum(), rc, 1, 1)
        else:
            r.render_frames(r.zeros_accum(), rc, 1, 1)
        torch.cuda.synchronize()
        graph = r.bounce_integrator().graph
        mem[mode] = {"first_call_s": time.perf_counter() - t0,
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                     "peak_over_start_gb": (torch.cuda.max_memory_allocated(
                         dev) - base) / 1e9,
                     "capture_s": graph.capture_s if graph else None}
        del r
    rec["memory"] = mem
    log("  11b TestObj bounce %dx%d first call: eager %.2f s, peak %.2f GB; "
        "replayed %.2f s (captures %.2f s: start, bounce, end), peak %.2f GB"
        % (W, W, mem["eager"]["first_call_s"], mem["eager"]["peak_gb"],
           mem["graph"]["first_call_s"], mem["graph"]["capture_s"],
           mem["graph"]["peak_gb"]))
    torch.cuda.empty_cache()

    # ---- 11d. 2 shards on the one card = the whole render, no sync ----
    rec["shards"] = {}
    for integrator in ("regen", "bounce"):
        r, rc = renderer("testobj", W, integrator)
        whole = r.render_frames(r.zeros_accum(), rc, 1, 1)
        sr = ShardedRenderer(r, mesh=make_mesh([dev, dev]))
        sr.render_frames(sr.zeros_accum(), rc, 1, 1)    # warm-up
        zero = sr.zeros_accum()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = sr.render_frames(zero, rc, 1, 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        assert torch.equal(got[:W * W], whole), \
            "2 shards != the whole %s render" % integrator
        rec["shards"][integrator] = {"ms": dt, "bit_for_bit": True,
                                     "sync_debug_error_passed": True}
        log("  11d %s: 2 shards on the one card = the whole 1-spp frame "
            "bit for bit, %.1f ms, under set_sync_debug_mode('error')"
            % (integrator, dt))
        del r, sr, whole, got
        torch.cuda.empty_cache()
    return rec


P_SHADE = 1 << 20
# FP32 operations of the diffuse draw (the concentric disk, the basis, the
# sum and its normalization, the mask; sinf and cosf counted once each):
# the fewest any branch but the null interface does, so a lower bound of
# a lane's work
SHADE_OPS_PER_LANE = 80
FP32_OPS_PER_S = 67e12     # H100 SXM, FP32 outside the tensor cores


def test_inputs(name):
    """tests/torch_<name>_inputs.py beside this script (no jax): the shade
    kernel's inputs of every material branch ("shade"), the surface
    fetches' ("fetch"), from a numpy seed, the pool gather's ("permute")
    or the BSSRDF probe loop's, recorded from a render ("bssrdf")."""
    import importlib
    d = os.path.join(HERE, "tests")
    if d not in sys.path:
        sys.path.append(d)
    return importlib.import_module("torch_%s_inputs" % name)


def shade_bits_differ(torch, got, want, surf):
    """{output: lanes of surf where the two differ in any bit} and the
    largest absolute difference of the float outputs there."""
    names = ("rng", "next_dir", "mask_mul", "offset", "terminate",
             "bounce_inc", "glass_refract", "ss_refract", "ss_normal")
    pairs = list(zip(got[:6], want[:6])) + [
        (got[6][k], want[6][k]) for k in names[6:]]
    out, err = {}, 0.0
    for name, (g, w) in zip(names, pairs):
        gb, wb = g, w
        if g.dtype == torch.float32:
            gb, wb = g.view(torch.int32), w.view(torch.int32)
            d = (g - w).abs()
            if d.dim() == 2:
                d = d.max(-1).values
            if bool(surf.any()):
                err = max(err, float(d[surf].max()))
        differ = gb != wb
        if differ.dim() == 2:
            differ = differ.any(-1)
        out[name] = int((differ & surf).sum())
    return out, err


def phase12(np, torch, dev, parts, W):
    """Phase 12: the shade kernel (csrc/shade.cu) against its plain version
    at P_SHADE lanes of every material, its times and bound, and the W x W
    TestObj regen and bounce renders with the kernel against the same
    renders with the plain shade. parts: the TestObj scene parts. Returns
    the record."""
    import dataclasses
    from tpu_pathtracer_torch.ops import shade as shade_ops
    from tpu_pathtracer_torch.scene import demo
    from tpu_pathtracer_torch.tracer import wavefront
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    from tpu_pathtracer_torch.utils.timing import cuda_ms
    rec = {}

    # ---- 12a. kernel = plain version, bit for bit, on the surface lanes ----
    inputs = test_inputs("shade")
    scene, args, mat_id, surf = inputs.mixed_inputs(P_SHADE, 12, dev)
    refl = args[5]["refltype"]
    types = {int(t): int((refl == t).sum()) for t in range(8)}
    assert all(types.values()), ("a refltype is missing", types)
    want = shade_ops.shade_plain(scene, None, *args)
    before = shade_ops.LAUNCHES["shade"]
    got = shade_ops.shade(scene, None, *args, mat_id=mat_id)
    torch.cuda.synchronize()
    assert shade_ops.LAUNCHES["shade"] == before + 1
    differ, err = shade_bits_differ(torch, got, want, surf)
    assert not any(differ.values()), ("shade kernel != plain", differ)
    # the bare launch (no wrapper checks or allocations) and the plain
    # version in turns: plain, kernel, kernel, plain
    fn = shade_ops.launch_fn(scene, *inputs.kernel_args(args, mat_id))
    kernel_ms, plain_ms = [], []
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            kernel_ms.append(cuda_ms(fn, 50))
        else:
            plain_ms.append(cuda_ms(
                lambda: shade_ops.shade_plain(scene, None, *args), 5))
    # the bytes this run's lanes need, by their branches (ops/shade.py:
    # io_bytes)
    n_bytes = shade_ops.io_bytes(args[5], got[5], scene["mat_table"].shape[0])
    b_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    b_ops = SHADE_OPS_PER_LANE * (P_SHADE - types[6]) / FP32_OPS_PER_S * 1e3
    bound = max(b_bytes, b_ops)
    rec["kernel"] = {
        "lanes": P_SHADE, "surface_lanes": int(surf.sum()),
        "lanes_by_refltype": types, "differing_lanes": differ,
        "max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bytes": n_bytes, "bytes_per_lane": n_bytes / P_SHADE,
        "bound_ms": bound,
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "bound_bytes_ms": b_bytes, "bound_ops_ms": b_ops,
        "bound_share": bound / min(kernel_ms)}
    log("  12a shade kernel at %d lanes (refltypes %s): = plain version bit "
        "for bit on all %d surface lanes, every output; kernel %s ms, plain "
        "%s ms, bound %.4f ms by bytes (%.1f MB, %.1f B a lane; ops %.4f "
        "ms): kernel at %.1f%% of it"
        % (P_SHADE, types, int(surf.sum()), ["%.4f" % x for x in kernel_ms],
           ["%.2f" % x for x in plain_ms], b_bytes, n_bytes / 1e6,
           n_bytes / P_SHADE, b_ops, 100 * rec["kernel"]["bound_share"]))
    del scene, args, mat_id, surf, want, got, fn
    torch.cuda.empty_cache()

    # ---- 12b. W x W renders: the kernel against the plain shade ----
    fb, mats, envmap, texture = parts
    rc = demo.default_camera(W, W).build_render_camera()
    rec["renders"] = {}
    saved = wavefront.shade
    for integrator in ("regen", "bounce"):
        imgs, run = {}, {}
        for mode in ("kernel", "plain"):
            r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                         height=W, device=dev)
            r.settings = dataclasses.replace(r.settings,
                                             integrator=integrator)
            if mode == "plain":
                wavefront.shade = inputs.plain_shade
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                r.render_frames(r.zeros_accum(), rc, 1, 2)     # captures
                torch.cuda.synchronize()
                zero_counts()
                acc, ms = event_ms(torch, lambda: r.render_frames(
                    r.zeros_accum(), rc, 1, 2))
                counts = read_counts()
            finally:
                torch.use_deterministic_algorithms(False)
                wavefront.shade = saved
            imgs[mode] = acc
            run[mode] = {"ms_per_frame": ms / 2,
                         "shade_launches_per_frame": counts["shade"] / 2}
            del r
        assert run["kernel"]["shade_launches_per_frame"] > 0, integrator
        assert run["plain"]["shade_launches_per_frame"] == 0, integrator
        g = gate(np, imgs["kernel"].cpu().numpy() / 2,
                 imgs["plain"].cpu().numpy() / 2,
                 "%s kernel vs plain shade" % integrator)
        bit_equal = torch.equal(imgs["kernel"], imgs["plain"])
        assert bit_equal, (integrator, "shade kernel moved the image")
        rec["renders"][integrator] = {"gate": g, "bit_equal": bit_equal,
                                      **run}
        log("  12b TestObj %s %dx%d x 2 spp, deterministic: kernel %.1f ms "
            "a frame (%.1f shade launches), plain shade %.1f ms; %s; bit "
            "for bit: %s" % (integrator, W, W,
                             run["kernel"]["ms_per_frame"],
                             run["kernel"]["shade_launches_per_frame"],
                             run["plain"]["ms_per_frame"], g, bit_equal))
        del imgs
        torch.cuda.empty_cache()
    return rec


P_FETCH = 1 << 20
# FP32 operations a lane of each surface fetch does at least (the
# barycentric and the interpolations; the lat-long mapping, the MIS weight
# and the two bilinear blends, atan2f / acosf / sqrtf counted once each;
# one bilinear blend): a lower bound of a lane's work
FETCH_OPS_PER_LANE = {"fetch_attributes": 72, "env_tex_merged": 100,
                      "texture_radiance": 45}
SSS_FETCH_SIZE = 256       # phase 13b's sss images


@contextlib.contextmanager
def swapped_fetches(plain):
    """With plain=True, tracer.wavefront's (and tracer.regen's)
    fetch_attributes, env_tex_merged and texture_radiance are the plain
    versions inside the block (bssrdf_shade imports them from wavefront at
    each call)."""
    from tpu_pathtracer_torch.tracer import regen, wavefront
    saved = [(m, k, getattr(m, k)) for m in (wavefront, regen)
             for k in FETCH_KERNELS if hasattr(m, k)]
    try:
        if plain:
            inputs = test_inputs("fetch")
            for m, k, _ in saved:
                setattr(m, k, inputs.plain_fetch(k))
        yield
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)


def phase13(np, torch, dev, parts, sss_parts, W):
    """Phase 13: the surface fetch kernels (csrc/fetch.cu, csrc/envtex.cu)
    against their plain versions at P_FETCH lanes, their times and bounds,
    and the W x W TestObj regen and bounce renders and the sss regen render
    with the kernels against the same renders with the plain versions.
    parts / sss_parts: the TestObj and sss scene parts. Returns the
    record."""
    import dataclasses
    from tpu_pathtracer_torch.ops import surface_fetch as sf
    from tpu_pathtracer_torch.scene import demo
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    from tpu_pathtracer_torch.utils.timing import cuda_ms
    inputs = test_inputs("fetch")
    rec = {"kernels": {}}

    # ---- 13a. each kernel = its plain version at P_FETCH lanes ----
    fb, mats, envmap, texture = parts
    scene = Renderer(fb, mats, envmap=envmap, texture=texture, width=64,
                     height=64, device=dev).scene
    for name in FETCH_KERNELS:
        args = inputs.kernel_inputs(name, scene, P_FETCH, 1, dev)
        want = inputs.run_plain(name, scene, *args)
        before = sf.LAUNCHES[name]
        got = getattr(sf, name + "_cuda")(scene, *args)
        torch.cuda.synchronize()
        assert sf.LAUNCHES[name] == before + 1, name
        got = got if isinstance(got, tuple) else (got,)
        differ, raw, nan_lanes, err = [], [], [], 0.0
        for g, w in zip(got, want):
            differ.append(int(inputs.differing_lanes(g, w).sum()))
            if g.dtype == torch.float32:
                bits = g.view(torch.int32) != w.view(torch.int32)
                raw.append(int((bits.any(-1) if bits.dim() == 2
                                else bits).sum()))
                nan = torch.isnan(g)
                nan_lanes.append(int((nan.any(-1) if nan.dim() == 2
                                      else nan).sum()))
                ok = torch.isfinite(g) & torch.isfinite(w)
                if bool(ok.any()):
                    err = max(err, float((g - w).abs()[ok].max()))
            else:
                raw.append(differ[-1])
                nan_lanes.append(0)
        assert not any(differ), (name, "kernel != plain", differ)
        # the bare launch and the plain version in turns: plain, kernel,
        # kernel, plain
        fn = sf.launch_fn(name, scene, *args)
        kernel_ms, plain_ms = [], []
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "kernel":
                kernel_ms.append(cuda_ms(fn, 50))
            else:
                plain_ms.append(cuda_ms(
                    lambda: inputs.run_plain(name, scene, *args), 5))
        rows = sf.rows_read(name, scene, *args)
        n_rows = int(torch.unique(rows).numel())
        n_bytes = sf.io_bytes(name, rows)
        b_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        b_ops = FETCH_OPS_PER_LANE[name] * P_FETCH / FP32_OPS_PER_S * 1e3
        bound = max(b_bytes, b_ops)
        row_per_lane = (sf.LANE_BYTES[name] + sf.ROW_BYTES[name]) * P_FETCH
        k = {"lanes": P_FETCH, "differing_lanes": differ,
             "raw_bit_differing_lanes": raw, "nan_lanes": nan_lanes,
             "max_abs_err": err, "kernel_ms": kernel_ms,
             "plain_ms": plain_ms, "bytes": n_bytes,
             "bytes_per_lane": n_bytes / P_FETCH, "rows_read": n_rows,
             "bound_ms": bound,
             "bound_by": "bytes" if b_bytes >= b_ops else "operations",
             "bound_bytes_ms": b_bytes, "bound_ops_ms": b_ops,
             "bound_share": bound / min(kernel_ms),
             "bound_row_per_lane_ms": row_per_lane / HBM_BYTES_PER_S * 1e3}
        if name == "fetch_attributes":
            slot = args[0]
            ids = scene["tri_attr"][:, 24].contiguous().view(torch.int32)
            k["miss_lanes"] = int((slot < 0).sum())
            k["material_ids"] = sorted(set(got[2][slot >= 0].tolist()))
            assert k["material_ids"] == sorted(set(ids.tolist()))
            assert 0 < k["miss_lanes"] < P_FETCH
        elif name == "env_tex_merged":
            miss, uv = args[3], args[4]
            k["miss_lanes"] = int(miss.sum())
            k["nonfinite_uv_lanes"] = int((~torch.isfinite(uv).all(-1)
                                           ).sum())
            k["pdf_negative_lanes"] = int((args[1] < 0).sum())
            assert k["nonfinite_uv_lanes"] > 0 and \
                k["pdf_negative_lanes"] > 0
        rec["kernels"][name] = k
        log("  13a %s kernel at %d lanes: = plain version on every lane, "
            "every output (lanes differing in any bit: %s, NaN lanes %s); "
            "kernel %s ms, plain %s ms, bound %.4f ms by %s (%.1f B a lane, "
            "%d rows read once; a row a lane: %.4f ms): kernel at %.1f%% of "
            "it" % (name, P_FETCH, raw, nan_lanes,
                    ["%.4f" % x for x in kernel_ms],
                    ["%.3f" % x for x in plain_ms], bound, k["bound_by"],
                    n_bytes / P_FETCH, n_rows, k["bound_row_per_lane_ms"],
                    100 * k["bound_share"]))
        del args, want, got, fn, rows
    del scene
    torch.cuda.empty_cache()

    # ---- 13b. renders: the kernels against the plain versions ----
    rec["renders"] = {}
    for tag, rparts, integrator, size in (
            ("testobj_regen", parts, "regen", W),
            ("testobj_bounce", parts, "bounce", W),
            ("sss_regen", sss_parts, "regen", SSS_FETCH_SIZE)):
        rc = demo.default_camera(size, size).build_render_camera()
        imgs, run = {}, {}
        for mode in ("kernel", "plain"):
            r = Renderer(rparts[0], rparts[1], envmap=rparts[2],
                         texture=rparts[3], width=size, height=size,
                         device=dev)
            r.settings = dataclasses.replace(r.settings,
                                             integrator=integrator)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with swapped_fetches(mode == "plain"):
                    r.render_frames(r.zeros_accum(), rc, 1, 2)  # captures
                    torch.cuda.synchronize()
                    zero_counts()
                    acc, ms = event_ms(torch, lambda: r.render_frames(
                        r.zeros_accum(), rc, 1, 2))
                    counts = read_counts()
            finally:
                torch.use_deterministic_algorithms(False)
            imgs[mode] = acc
            run[mode] = {"ms_per_frame": ms / 2, "launches_per_frame": {
                k: counts[k] / 2 for k in FETCH_KERNELS}}
            del r
        want_kernels = {"testobj_regen": ("fetch_attributes",
                                          "env_tex_merged"),
                        "testobj_bounce": ("fetch_attributes",
                                           "texture_radiance"),
                        "sss_regen": ("fetch_attributes",
                                      "env_tex_merged")}[tag]
        for k in FETCH_KERNELS:
            assert (run["kernel"]["launches_per_frame"][k] > 0) == \
                (k in want_kernels), (tag, k, run["kernel"])
            assert run["plain"]["launches_per_frame"][k] == 0, (tag, k)
        g = gate(np, imgs["kernel"].cpu().numpy() / 2,
                 imgs["plain"].cpu().numpy() / 2,
                 "%s kernels vs plain fetches" % tag)
        bit_equal = torch.equal(imgs["kernel"], imgs["plain"])
        assert bit_equal, (tag, "the fetch kernels moved the image")
        rec["renders"][tag] = {"size": size, "gate": g,
                               "bit_equal": bit_equal, **run}
        log("  13b %s %dx%d x 2 spp, deterministic: kernels %.1f ms a frame "
            "(launches a frame %s), plain versions %.1f ms; %s; bit for "
            "bit: %s" % (tag, size, size, run["kernel"]["ms_per_frame"],
                         run["kernel"]["launches_per_frame"],
                         run["plain"]["ms_per_frame"], g, bit_equal))
        del imgs
        torch.cuda.empty_cache()
    return rec


P_PERMUTE = (1 << 20, 518400)    # the CLI cells' pool, the preview's
WAVE_W, WAVE_H = 1920, 1080        # phase 14b's frame


def graph_of(torch, fn):
    """fn captured once as a CUDA graph, after one warm-up call on a side
    stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def time_pool_gather(torch, permute, st, args):
    """The pool gather's times on (st, args), in turns: plain, kernel,
    kernel, plain; the kernel as its bare launch and as a wave runs it
    (the wrapper captured in a graph: the aliased sources' copies and the
    launch), the plain version eager and captured (the old cat, gather
    and split as the wave ran it: library_ms); beside the byte bound."""
    from tpu_pathtracer_torch.utils.timing import cuda_ms
    P = args[0].shape[0]
    bare = permute.launch_fn(st, *args)
    wrapped = graph_of(torch, lambda: permute.pool_gather_cuda(st, *args))
    library = graph_of(torch, lambda: permute.pool_gather_plain(st, *args))
    kernel_ms, wave_ms, plain_ms, library_ms = [], [], [], []
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            kernel_ms.append(cuda_ms(bare, 50))
            wave_ms.append(cuda_ms(wrapped.replay, 50))
        else:
            plain_ms.append(cuda_ms(
                lambda: permute.pool_gather_plain(st, *args), 10))
            library_ms.append(cuda_ms(library.replay, 20))
    bound = permute.io_bytes(P) / HBM_BYTES_PER_S * 1e3
    return {"rows": P, "kernel_ms": kernel_ms, "wave_graph_ms": wave_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bytes": permute.io_bytes(P), "bound_ms": bound,
            "bound_share": bound / min(kernel_ms)}


def pool_gather_times_line(t):
    return ("bare kernel %s ms; as the wave runs it (copies + launch, "
            "graph) %s ms; plain %s ms, old cat/gather/split in a graph %s "
            "ms; bound %.4f ms (168 B a row), kernel at %.1f%% of it"
            % (["%.4f" % x for x in t["kernel_ms"]],
               ["%.4f" % x for x in t["wave_graph_ms"]],
               ["%.3f" % x for x in t["plain_ms"]],
               ["%.4f" % x for x in t["library_ms"]], t["bound_ms"],
               100 * t["bound_share"]))


def phase14(np, torch, dev, scenes, W):
    """Phase 14: the compaction permute's pool gather (csrc/permute.cu)
    against its plain version at P_PERMUTE rows, with the edge values of
    every column and each aliasing of the regen wave, its times beside the
    byte bound there and on the order of a real wave, and W x W TestObj
    and media regen renders with the kernel against the same renders with
    the plain version. scenes: {"testobj",
    "media"} -> scene parts. Returns the record."""
    from tpu_pathtracer_torch.ops import permute
    from tpu_pathtracer_torch.scene import demo
    from tpu_pathtracer_torch.tracer import device_loop, regen
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    inputs = test_inputs("permute")
    rec = {"sizes": {}}

    # ---- 14a. kernel = plain version bit for bit; times ----
    for P in P_PERMUTE:
        row = {"differing_rows": {}}
        for alias in inputs.ALIASES:
            st, args = inputs.pool_inputs(P, 140 + len(alias), dev, alias)
            st2, args2 = inputs.clone_case(st, args)
            before = permute.LAUNCHES["pool_gather"]
            permute.pool_gather(st, *args)
            permute.pool_gather_plain(st2, *args2)
            torch.cuda.synchronize()
            assert permute.LAUNCHES["pool_gather"] == before + 1
            differ = {k: int((inputs.bits(st[k]) != inputs.bits(
                st2[k])).reshape(P, -1).any(1).sum()) for k in st}
            row["differing_rows"][alias] = differ
            assert not any(differ.values()), (P, alias, differ)
            del st, args, st2, args2
        # the main path's case: only the pool's pixel column aliased
        st, args = inputs.pool_inputs(P, 150, dev)
        row.update(time_pool_gather(torch, permute, st, args))
        rec["sizes"][str(P)] = row
        log("  14a pool gather at %d rows: = plain version bit for bit "
            "(3 aliasings); a random order: %s"
            % (P, pool_gather_times_line(row)))
        del st, args
        torch.cuda.empty_cache()

    # ---- 14b. the order of a wave: the inputs of a 1920x1080 TestObj
    # frame's third full-width wave, recorded eagerly ----
    fb, mats, envmap, texture = scenes["testobj"]
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=WAVE_W,
                 height=WAVE_H, device=dev)
    seen = []
    saved = regen.pool_gather

    def record(st, src, *sources):
        seen.append(src.shape[0])
        if len(seen) == 3:
            rec["wave_inputs"] = inputs.clone_case(st, (src,) + sources)
        saved(st, src, *sources)
    regen.pool_gather = record
    try:
        with device_loop.no_graphs():
            r.render_frames(r.zeros_accum(), demo.default_camera(
                WAVE_W, WAVE_H).build_render_camera(), 1, 1)
    finally:
        regen.pool_gather = saved
    st, args = rec.pop("wave_inputs")
    src = args[0]
    P = src.shape[0]
    ahead = int((src[1:] == src[:-1] + 1).sum()) / max(P - 1, 1)
    wave = {"rows": P, "widths_seen": seen[:4],
            "share_of_rows_next_to_their_predecessor": ahead}
    wave.update(time_pool_gather(torch, permute, st, args))
    rec["wave_order"] = wave
    log("  14b pool gather on a %dx%d TestObj wave's order (%d rows, "
        "%.1f%% of rows read the row after their predecessor's): %s"
        % (WAVE_W, WAVE_H, P, 100 * ahead, pool_gather_times_line(wave)))
    del r, st, args, src
    torch.cuda.empty_cache()

    # ---- 14c. renders: the kernel against the plain version ----
    rec["renders"] = {}
    rc = demo.default_camera(W, W).build_render_camera()
    saved = regen.pool_gather
    for tag in ("testobj", "media"):
        fb, mats, envmap, texture = scenes[tag]
        imgs, run = {}, {}
        for mode in ("kernel", "plain"):
            r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                         height=W, device=dev)
            if mode == "plain":
                regen.pool_gather = permute.pool_gather_plain
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                r.render_frames(r.zeros_accum(), rc, 1, 2)     # captures
                torch.cuda.synchronize()
                zero_counts()
                acc, ms = event_ms(torch, lambda: r.render_frames(
                    r.zeros_accum(), rc, 1, 2))
                counts = read_counts()
                waves = sum(r.regen_integrator(False).last_waves.values())
            finally:
                torch.use_deterministic_algorithms(False)
                regen.pool_gather = saved
            imgs[mode] = acc
            run[mode] = {"ms_per_frame": ms / 2, "waves": waves,
                         "launches": counts["pool_gather"]}
            del r
        assert run["kernel"]["launches"] == run["kernel"]["waves"] > 0, run
        assert run["plain"]["launches"] == 0, run
        bit_equal = torch.equal(imgs["kernel"], imgs["plain"])
        assert bit_equal, (tag, "the pool gather kernel moved the image")
        rec["renders"][tag] = {"bit_equal": bit_equal, **run}
        log("  14c %s regen %dx%d x 2 spp, deterministic: kernel %.2f ms a "
            "frame (%d launches in %d waves), plain %.2f ms; bit for bit: %s"
            % (tag, W, W, run["kernel"]["ms_per_frame"],
               run["kernel"]["launches"], run["kernel"]["waves"],
               run["plain"]["ms_per_frame"], bit_equal))
        del imgs
        torch.cuda.empty_cache()
    return rec


SSS_PROBE_SIZE = 256       # phase 15c's sss images


def bssrdf_wave_inputs(torch, sss_parts, dev, W, H):
    """(renderer, inputs) of bssrdf_scatter in the first wave of a W x H
    organic sss frame (tests/torch_bssrdf_inputs.py: wave_inputs)."""
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    fb, mats, envmap, texture = sss_parts
    r = Renderer(fb, mats, envmap=envmap, texture=texture, width=W,
                 height=H, device=dev)
    return r, test_inputs("bssrdf").wave_inputs(r)


def phase15(np, torch, dev, sss_parts):
    """Phase 15: the BSSRDF probe loop's kernels (csrc/bssrdf.cu) on the
    inputs of a WAVE_W x WAVE_H organic sss frame's first wave (2^20
    lanes): the kernel path of bssrdf_scatter against its plain version,
    bit for bit; each kernel's bare launch, the kernel path and the plain
    path (each captured with its probe traces) timed in turns beside the
    byte bound; then SSS_PROBE_SIZE^2 sss regen and bounce renders with
    the kernels against the same renders with the plain path. Returns the
    record."""
    import dataclasses
    from tpu_pathtracer_torch.ops import bssrdf as bssrdf_ops
    from tpu_pathtracer_torch.tracer import bssrdf_shade, wavefront
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    from tpu_pathtracer_torch.utils.timing import cuda_ms
    bi = test_inputs("bssrdf")
    rec = {}

    # ---- 15a. kernel path = plain path on a 1080p wave ----
    r, inputs = bssrdf_wave_inputs(torch, sss_parts, dev, WAVE_W, WAVE_H)
    scene, s = r.scene, r.settings
    lanes = inputs["lanes"]
    N = lanes.shape[0]
    want = bi.run(scene, s, inputs, plain=True)
    slots = []
    saved = wavefront.trace_rays

    def recording(*args, **kwargs):
        out = saved(*args, **kwargs)
        slots.append(out)
        return out
    wavefront.trace_rays = recording
    try:
        got = bi.run(scene, s, inputs, plain=False)
    finally:
        wavefront.trace_rays = saved
    torch.cuda.synchronize()
    differ = bi.differing_lanes(got, want, lanes)
    assert not any(differ.values()), differ
    n_loop, n_ok = int(lanes.sum()), int(want[4].sum())
    hit = torch.cat([sl[lanes & (sl >= 0)] for sl, _ in slots])
    tri_rows = int(torch.unique(hit).numel())
    P = s.bssrdf_probes
    io = bssrdf_ops.io_bytes(N, n_loop, n_ok, P, tri_rows, 0,
                             scene["mat_table"].shape[0])
    rec["wave"] = {"lanes": N, "loop_lanes": n_loop, "ok_lanes": n_ok,
                   "probe_hit_rows": tri_rows, "differing_lanes": differ}
    log("  15a bssrdf kernels on a %dx%d sss wave (%d lanes, %d in the "
        "loop, %d exits): = plain path bit for bit %s"
        % (WAVE_W, WAVE_H, N, n_loop, n_ok, differ))

    # ---- 15b. times: bare launches, both paths captured with traces ----
    args = [inputs[k] for k in ("rng", "hitpoint", "normal2", "mat_id",
                                "objcol", "lanes")]
    fns = bssrdf_ops.launch_fn(scene, *args, P, s.use_texture, *slots[0])
    static = {k: v for k, v in inputs.items()}
    kernel_graph = graph_of(torch, lambda: bi.run(scene, s, static,
                                                  plain=False))
    plain_graph = graph_of(torch, lambda: bi.run(scene, s, static,
                                                 plain=True))
    times = {k: [] for k in bssrdf_ops.STAGES}
    times.update(kernel_path=[], plain_path=[])
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "kernel":
            for k in bssrdf_ops.STAGES:
                times[k].append(cuda_ms(fns[k], 20))
            times["kernel_path"].append(cuda_ms(kernel_graph.replay, 10))
        else:
            times["plain_path"].append(cuda_ms(plain_graph.replay, 5))
    kernels_ms = min(times["probe_start"]) + (P - 1) * min(
        times["probe_step"]) + min(times["probe_finish"])
    bound = io / HBM_BYTES_PER_S * 1e3
    rec["times"] = dict(times, kernels_ms=kernels_ms, bytes=io,
                        bound_ms=bound, bound_share=bound / kernels_ms,
                        traces_ms=min(times["kernel_path"]) - kernels_ms)
    log("  15b a wave's probe loop: probe_start %s, probe_step %s, "
        "probe_finish %s ms (bare); the %d launches %.4f ms against a "
        "%.4f ms byte bound (%d B), %.1f%%; kernel path with its %d "
        "traces %s ms, plain path %s ms (graphs)"
        % (["%.4f" % x for x in times["probe_start"]],
           ["%.4f" % x for x in times["probe_step"]],
           ["%.4f" % x for x in times["probe_finish"]], P + 1, kernels_ms,
           bound, io, 100 * bound / kernels_ms, P,
           ["%.3f" % x for x in times["kernel_path"]],
           ["%.3f" % x for x in times["plain_path"]]))
    del r, inputs, static, got, want, slots, fns, kernel_graph, plain_graph
    torch.cuda.empty_cache()

    # ---- 15c. renders: the kernels against the plain path ----
    rec["renders"] = {}
    size = SSS_PROBE_SIZE
    rc = bi.camera(size)
    saved = bssrdf_shade.uses_kernels
    for integrator in ("regen", "bounce"):
        imgs, run = {}, {}
        for mode in ("kernel", "plain"):
            r = Renderer(sss_parts[0], sss_parts[1], envmap=sss_parts[2],
                         texture=sss_parts[3], width=size, height=size,
                         device=dev)
            r.settings = dataclasses.replace(r.settings,
                                             integrator=integrator)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                if mode == "plain":
                    bssrdf_shade.uses_kernels = lambda device, st: False
                r.render_frames(r.zeros_accum(), rc, 1, 2)      # captures
                torch.cuda.synchronize()
                zero_counts()
                acc, ms = event_ms(torch, lambda: r.render_frames(
                    r.zeros_accum(), rc, 1, 2))
                counts = read_counts()
            finally:
                torch.use_deterministic_algorithms(False)
                bssrdf_shade.uses_kernels = saved
            imgs[mode] = acc
            run[mode] = {"ms_per_frame": ms / 2, "launches": {
                k: counts[k] for k in bssrdf_ops.STAGES}}
            del r
        k_l, p_l = run["kernel"]["launches"], run["plain"]["launches"]
        assert k_l["probe_start"] > 0 and k_l["probe_finish"] == \
            k_l["probe_start"] and k_l["probe_step"] == \
            k_l["probe_start"] * (P - 1), k_l
        assert not any(p_l.values()), p_l
        bit_equal = torch.equal(imgs["kernel"], imgs["plain"])
        assert bit_equal, (integrator, "the bssrdf kernels moved the image")
        rec["renders"][integrator] = {"size": size, "bit_equal": bit_equal,
                                      **run}
        log("  15c sss %s %dx%d x 2 spp, deterministic: kernels %.2f ms a "
            "frame (launches %s), plain path %.2f ms; bit for bit: %s"
            % (integrator, size, size, run["kernel"]["ms_per_frame"], k_l,
               run["plain"]["ms_per_frame"], bit_equal))
        del imgs
        torch.cuda.empty_cache()
    return rec


DMA_CASES = (("gather_wide", 128, "perm", 1, "gather"),
             ("gather_flat", 0, "perm", 1, "gather"),
             ("gather_batch8", 128, "run8", 8, "gather"),
             ("scatter_wide", 128, "perm", 1, "scatter"))


def dma_case(torch, probe_dma, dev, case, C, kind, batch, op):
    """Phase 3c, one case: the row kernel against its plain version at
    P_DMA rows, exactly; kernel, plain and library times beside the byte
    bound. Its 512 MB tables are freed when it returns."""
    from tpu_pathtracer_torch.utils.timing import cuda_ms
    P = P_DMA
    tab = probe_dma.table(P, C, dev)
    idx = probe_dma.indices(P, kind).to(dev)
    rows = tab.view(P, C or 16)
    got = probe_dma.make_fn(P, C, batch, op)(tab, idx)
    want = probe_dma.plain(tab, idx, P, C, batch, op)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (case, "kernel != plain")
    del got, want
    kern = probe_dma.launch_fn(tab, idx, P, C, batch, op)

    def plain():
        return probe_dma.plain(tab, idx, P, C, batch, op)
    lib = None
    if op == "gather" and batch == 1:
        def lib():
            return torch.index_select(rows, 0, idx)
    elif op == "scatter":
        idx64 = idx.long()
        dst = torch.empty_like(rows)

        def lib():
            return dst.index_copy_(0, idx64, rows)
    p1 = cuda_ms(plain, 3)
    k1 = cuda_ms(kern, 20)
    k2 = cuda_ms(kern, 20)
    p2 = cuda_ms(plain, 3)
    lib_ms = cuda_ms(lib, 20) if lib is not None else None
    bound = probe_dma.bound_bytes(idx, C, batch) / HBM_BYTES_PER_S * 1e3
    log("  dma %-13s kernel %.4f/%.4f ms  plain %.4f/%.4f ms  library %s ms"
        "  bound %.4f ms (%.1f%%)"
        % (case, k1, k2, p1, p2,
           "%.4f" % lib_ms if lib_ms is not None else "none", bound,
           100 * bound / min(k1, k2)))
    return {"rows": P, "cols": C or 16, "batch": batch,
            "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
            "library_ms": lib_ms, "bound_ms": bound,
            "bound_share": bound / min(k1, k2), "max_abs_err": 0.0}


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


def golden_configs(organic_sss_mats, organic_media_mats):
    """The c1..c7 configurations of tests/test_goldens.py: {name:
    (stream, materials, settings, aperture)}; stream "testobj" or
    "organic"."""
    from tpu_pathtracer_torch.scene.config import (
        MatDesc, MAT_DIFF, MAT_GLASS, MAT_REFL, MAT_FRESNEL, MAT_SUBSURFACE)
    from tpu_pathtracer_torch.tracer.wavefront import RenderSettings
    base = dict(use_envmap=True, use_texture=True)
    cfg = {
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
        "c4_media": (
            [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_DIFF),
             MatDesc(refltype=MAT_GLASS, medium="tea"),
             MatDesc(refltype=MAT_REFL)],
            RenderSettings(bounce_min=2, bounce_max=10, has_media=True,
                           **base), 0.0),
        "c5_bssrdf": (
            [MatDesc(refltype=MAT_DIFF, useTexture=True),
             MatDesc(refltype=MAT_SUBSURFACE, objcol=(0.8, 0.75, 0.7),
                     alphax=0.3, etaT=1.4, mfp=(0.3, 0.25, 0.2), ks=0.2),
             MatDesc(refltype=MAT_GLASS),
             MatDesc(refltype=MAT_REFL)],
            RenderSettings(bounce_min=3, bounce_max=10, has_bssrdf=True,
                           **base), 0.0),
    }
    out = {k: ("testobj",) + v for k, v in cfg.items()}
    out["c6_organic_sss"] = (
        "organic", organic_sss_mats,
        RenderSettings(bounce_min=3, bounce_max=10, has_bssrdf=True, **base),
        0.0)
    out["c7_organic_media"] = (
        "organic", organic_media_mats,
        RenderSettings(bounce_min=2, bounce_max=10, has_media=True, **base),
        0.0)
    return out


def main():
    if sys.argv[1:2] == ["--ab"]:
        if len(sys.argv) not in (3, 5) or sys.argv[4:] and \
                sys.argv[3] != "--out":
            print("usage: chip_smoke.py --ab DIR [--out FILE]",
                  file=sys.stderr)
            return 2
        line = json.dumps(measure_ab(sys.argv[2]))
        if len(sys.argv) == 5:
            with open(sys.argv[4], "w") as f:
                f.write(line + "\n")
        log(line)
        return 0
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
    regs = ptxas_registers(libs.logs.get("traverse", ""))
    report["traverse_registers"] = {
        "traverse_kernel<anyhit=%d,count=%d,table=%d>" % k: v
        for k, v in regs.items()}

    from tpu_pathtracer_torch.ops import traverse_packet as ops
    from tpu_pathtracer_torch.tracer import traverse as trav
    from tpu_pathtracer_torch.utils.timing import cuda_ms
    from tpu_pathtracer_torch.scene import demo, procedural
    from tpu_pathtracer_torch.tracer.renderer import Renderer
    from tpu_pathtracer_torch.tools.probe_steps import (
        camera_rays, incoherent_rays, freeze_pool)

    # ---- 3. kernel vs plain vs brute force; times at 1M rays ----
    cache = os.path.join(HERE, ".bvh_cache_torch")
    mesh = procedural.make_test_scene()
    from tpu_pathtracer_torch.accel import cache as bvh_cache, native_build
    hit = os.path.exists(os.path.join(cache, "bvh_%s.npz" % bvh_cache
                                      ._cache_key(mesh, None, None)))
    lib = native_build.get_lib()
    if hit:
        builder = "cache hit (no build)"
    elif lib is not None:
        builder = "native C++ SBVH builder (%s, built by g++)" \
            % os.path.relpath(lib._name, HERE)
    else:
        builder = "Python SBVH builder (the g++ build of the native one " \
            "failed)"
    t0 = time.time()
    fb, mats, envmap, texture = demo.testobj_scene(cache_dir=cache)
    report["bvh"] = {"builder": builder, "s": time.time() - t0}
    log("BVH: %s, %.1f s" % (builder, report["bvh"]["s"]))
    packed = torch.from_numpy(trav.pack_stream(fb.prims, fb.meta)).to(dev)
    log("TestObj stream: %d rows, %d nodes, depth %d"
        % (packed.shape[0], fb.num_nodes, fb.max_depth))
    g = np.random.default_rng(1234)
    errs = {}
    for tag, rays in (("camera", camera_rays(256, dev)),
                      ("incoherent", incoherent_rays(N_CHECK, fb, 7, dev))):
        e = check_forms(np, torch, ops, trav, fb, packed, mesh, rays, tag, g)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    sd = fb.max_depth + 2
    K = packed.shape[0]
    timing = {}
    co, cd = camera_rays(1024, dev)
    # (tag, rays, kinds): the 1M sets in three forms, small launches in one
    big = [("coherent", (co, cd), TIMED_FORMS),
           ("incoherent", incoherent_rays(N_TIME, fb, 8, dev), TIMED_FORMS),
           ("small_4096", (co[:4096].contiguous(), cd[:4096].contiguous()),
            ("closest",)),
           ("small_65536", (co[:65536].contiguous(),
                            cd[:65536].contiguous()), ("closest",))]
    forms = {tag: timed_forms(np, torch, g, rays[0].shape[0], dev)
             for tag, rays, _ in big}
    # the bare launch of the kernel (ops.launch_fn: its C entry, no
    # wrapper): its time is the kernel's; the wrapper's checks and
    # allocations add host time
    for tag, (o, d), kinds in big:
        for kind in kinds:
            kw, anyhit, mask, tmax, n_act = forms[tag][kind]

            def kern():
                return ops.packet_intersect(packed, o, d, RAY_MIN, tmax,
                                            stack_depth=sd, **kw)

            def plain():
                return trav.intersect_scene(None, None, None, o, d, RAY_MIN,
                                            tmax, anyhit=anyhit,
                                            stack_depth=sd, active=mask,
                                            packed=packed)
            bare_fn = ops.launch_fn(packed, o, d, RAY_MIN, tmax,
                                    stack_depth=sd, **kw)
            # plain, kernel, kernel, plain; then the bare launch twice
            reps = 10 if o.shape[0] == N_TIME else 50
            p1 = cuda_ms(plain, 1)
            k1 = cuda_ms(kern, reps)
            k2 = cuda_ms(kern, reps)
            p2 = cuda_ms(plain, 1)
            b1 = cuda_ms(bare_fn, 2 * reps)
            b2 = cuda_ms(bare_fn, 2 * reps)
            ks, kt = kern()
            ps, pt = plain()
            assert torch.equal(ks, ps) and torch.equal(kt, pt), \
                (tag, kind, "kernel != plain version")
            if kind in DEVICE_PREFIX_FORMS:
                # the same launch with the prefix a host int
                hs, ht = ops.packet_intersect(
                    packed, o, d, RAY_MIN, tmax, stack_depth=sd,
                    active_prefix=n_act)
                assert torch.equal(ks, hs) and torch.equal(kt, ht), \
                    (tag, kind, "device prefix != int prefix")
                del hs, ht
            timing["%s_%s" % (kind, tag)] = {
                "kernel_ms": [b1, b2], "wrapper_ms": [k1, k2],
                "plain_ms": [p1, p2], "lanes": o.shape[0], "rays": n_act,
                "agree": 1.0, "max_abs_err": 0.0}
            errs["%s_%s" % (kind, tag)] = 0.0
            log("  time %-11s %-17s kernel %.4f/%.4f ms (through the wrapper "
                "%.4f/%.4f)  plain %.1f/%.1f ms  = plain on every lane"
                % (tag, kind, b1, b2, k1, k2, p1, p2))
    report["timing_1M"] = timing

    # ---- 3b. count_steps: counting kernel vs kernel vs plain ----
    steps_agree = {}
    for tag, rays in (("camera", camera_rays(256, dev)),
                      ("incoherent", incoherent_rays(N_CHECK, fb, 7, dev))):
        for k, v in check_steps(np, torch, ops, trav, fb, packed, rays, tag,
                                g).items():
            steps_agree["%s_%s" % (tag, k)] = v
    report["steps_agree"] = steps_agree
    for tag, (o, d), kinds in big:
        for kind in kinds:
            kw, anyhit, mask, tmax, n_act = forms[tag][kind]

            def kern_c():
                return ops.packet_intersect(packed, o, d, RAY_MIN, tmax,
                                            stack_depth=sd, count_steps=True,
                                            **kw)

            def plain_c():
                return trav.intersect_scene(None, None, None, o, d, RAY_MIN,
                                            tmax, anyhit=anyhit,
                                            stack_depth=sd, active=mask,
                                            packed=packed, count_steps=True)
            bare_c = ops.launch_fn(packed, o, d, RAY_MIN, tmax,
                                   stack_depth=sd, count_steps=True, **kw)
            reps = 10 if o.shape[0] == N_TIME else 50
            p1 = cuda_ms(plain_c, 1)
            k1 = cuda_ms(kern_c, reps)
            k2 = cuda_ms(kern_c, reps)
            p2 = cuda_ms(plain_c, 1)
            b1 = cuda_ms(bare_c, 2 * reps)
            b2 = cuda_ms(bare_c, 2 * reps)
            cs, ct, cn = kern_c()
            warp_steps = int(ops.last_warp_steps())
            ps, pt, pn = plain_c()
            ks, kt = ops.packet_intersect(packed, o, d, RAY_MIN, tmax,
                                          stack_depth=sd, **kw)
            assert torch.equal(cs, ks) and torch.equal(ct, kt), (tag, kind)
            assert torch.equal(cn, pn), (tag, kind, "steps != plain")
            if kind in DEVICE_PREFIX_FORMS:
                hs, ht, hn = ops.packet_intersect(
                    packed, o, d, RAY_MIN, tmax, stack_depth=sd,
                    count_steps=True, active_prefix=n_act)
                assert torch.equal(cs, hs) and torch.equal(ct, ht) and \
                    torch.equal(cn, hn), (tag, kind, "device != int prefix")
                del hs, ht, hn
            steps_sum = int(cn.sum().item())
            n_lanes = o.shape[0]
            masked = "active" in kw
            row = timing["%s_%s" % (kind, tag)]
            b, by, b_bytes, b_ops = trav_bound_ms(n_lanes, n_act, K, masked,
                                                  False, steps_sum)
            row.update(steps_sum=steps_sum, steps_per_ray=steps_sum / n_act,
                       bound_ms=b, bound_by=by, bound_bytes_ms=b_bytes,
                       bound_ops_ms=b_ops,
                       bound_share=b / min(row["kernel_ms"]),
                       warp_steps=warp_steps,
                       measured_tax=32 * warp_steps / steps_sum - 1,
                       ns_per_warp_step=min(row["kernel_ms"]) * 1e6
                       / warp_steps)
            bc, byc, _, _ = trav_bound_ms(n_lanes, n_act, K, masked, True,
                                          steps_sum)
            timing["%s_steps_%s" % (kind, tag)] = {
                "kernel_ms": [b1, b2], "wrapper_ms": [k1, k2],
                "plain_ms": [p1, p2], "rays": n_act, "steps_agree": 1.0,
                "max_abs_err": 0.0, "steps_sum": steps_sum, "bound_ms": bc,
                "bound_by": byc, "bound_share": bc / min(b1, b2)}
            log("  steps %-11s %-17s sum %d (%.2f per active ray), warps paid "
                "%+.1f%%, %.3f ns per warp-step; counting kernel %.4f/%.4f "
                "ms (through the wrapper %.4f/%.4f) plain %.1f/%.1f ms, steps "
                "= plain on every lane; bound %.4f ms by %s (bytes %.4f, ops "
                "%.4f): kernel at %.1f%% of it"
                % (tag, kind, steps_sum, row["steps_per_ray"],
                   100 * row["measured_tax"], row["ns_per_warp_step"], b1, b2,
                   k1, k2, p1, p2, b, by, b_bytes, b_ops,
                   100 * row["bound_share"]))
            del cs, ct, cn, ps, pt, pn, ks, kt
    del big, co, cd

    # ---- 3d. the shared-memory-table instantiations, two streams ----
    t0 = time.time()
    big_scenes = {"large": demo.large_scene(cache_dir=cache)}
    t1 = time.time()
    big_scenes["organic_sss"] = demo.large_organic_scene(cache_dir=cache,
                                                         variant="sss")
    big_scenes["organic_media"] = demo.large_organic_scene(cache_dir=cache,
                                                           variant="media")
    report["bvh_big"] = {"large_s": t1 - t0, "organic_s": time.time() - t1}
    for tag, parts in big_scenes.items():
        log("%s stream: %d rows, %d nodes, depth %d (%.1f MB at 64 B a row)"
            % (tag, parts[0].prims.shape[0], parts[0].num_nodes,
               parts[0].max_depth, parts[0].prims.shape[0] * 64 / 1e6))
    log("  built / loaded in %.1f s (large) and %.1f s (organic, both "
        "variants)" % (t1 - t0, time.time() - t1))
    fb_l = big_scenes["large"][0]
    packed_l = torch.from_numpy(trav.pack_stream(fb_l.prims,
                                                 fb_l.meta)).to(dev)
    check_table(np, torch, ops, trav, fb, packed, "testobj", "smem", g, dev,
                camera_rays, incoherent_rays)
    check_table(np, torch, ops, trav, fb_l, packed_l, "large", "split", g,
                dev, camera_rays, incoherent_rays)
    del packed_l

    # ---- 3c. row gather / scatter kernels at 1M rows ----
    from tpu_pathtracer_torch.ops import dma_rows
    from tpu_pathtracer_torch.tools import probe_dma, probe_steps
    report["dma"] = {case: dma_case(torch, probe_dma, dev, case, *rest)
                     for case, *rest in DMA_CASES}
    torch.cuda.empty_cache()

    # ---- 4. goldens on the card ----
    golden = {}
    streams = {"testobj": fb, "organic": big_scenes["organic_sss"][0]}
    for name, (stream, gmats, settings, aperture) in golden_configs(
            big_scenes["organic_sss"][1],
            big_scenes["organic_media"][1]).items():
        r = Renderer(streams[stream], gmats, envmap=envmap, texture=texture,
                     width=96, height=96, settings=settings, device=dev)
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
    spp = 4
    main, _ = timed_frames(np, torch, ops, r, rc, spp, "main path")
    launches = main["launches"]
    for k in ("traverse_closest", "traverse_anyhit", "shade",
              "fetch_attributes", "env_tex_merged", "pool_gather"):
        assert launches[k] > 0, "main path never launched %s" % k
    report["main_path"] = main

    # ---- 5b. the step census on the main path's renderer ----
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.time()
    rc_vec = torch.as_tensor(rc.as_array(), device=dev)
    census = probe_steps.run(r, rc_vec, [3], spp, timed=True)
    torch.cuda.synchronize()
    census_launches = dict(ops.LAUNCHES)
    for rec in census:
        log(probe_steps.report(rec))
    for k in ("traverse_closest_steps", "traverse_anyhit_steps"):
        assert census_launches[k] > 0, "step census never launched %s" % k
    assert census[0]["after_waves"] == 3, census[0]["after_waves"]
    for kind in ("closest", "anyhit"):
        c = census[0][kind]
        b, by, b_bytes, b_ops = trav_bound_ms(c["lanes"], c["rays"], K, True,
                                              False, c["steps_sum"])
        c.update(bound_ms=b, bound_by=by, bound_bytes_ms=b_bytes,
                 bound_ops_ms=b_ops, bound_share=b / c["trace_ms"])
        log("  census %-7s trace %.4f ms, bound %.4f ms by %s (bytes %.4f, "
            "ops %.4f): kernel at %.1f%% of it" % (
                kind, c["trace_ms"], b, by, b_bytes, b_ops,
                100 * c["bound_share"]))
    report["census"] = {"waves": 3, "spp": spp, "records": census,
                        "launches": census_launches, "s": time.time() - t0}

    # ---- 5d. both residencies of the table on the TestObj stream ----
    residency = {}
    pool = freeze_pool(r, rc_vec, 3, spp)
    residency["testobj"] = time_residency(
        torch, ops, trav, cuda_ms, packed, sd,
        residency_sets(np, torch, g, fb, pool, dev, camera_rays,
                       incoherent_rays), "smem", "testobj", regs)
    del r, pool

    # ---- 5c. the row probe ----
    for k in dma_rows.LAUNCHES:
        dma_rows.LAUNCHES[k] = 0
    t0 = time.time()
    probe = probe_dma.run("cuda", P_DMA, reps=5)
    torch.cuda.synchronize()
    dma_launches = dict(dma_rows.LAUNCHES)
    for rec in probe:
        log("  probe_dma " + probe_dma.report(rec))
    for k, v in dma_launches.items():
        assert v > 0, "row probe never launched %s" % k
    report["probe_dma"] = {"cases": probe, "launches": dma_launches,
                           "s": time.time() - t0}
    # ---- 7. this slice's paths at full width ----
    import dataclasses
    frames = {}
    census_table_launches = None
    for tag, (fb_s, mats_s, env_s, tex_s) in big_scenes.items():
        r = Renderer(fb_s, mats_s, envmap=env_s, texture=tex_s, width=W,
                     height=H, device=dev)
        auto_rec, img_a = timed_frames(np, torch, ops, r, rc, 2, tag)
        default_settings = r.settings
        r.settings = dataclasses.replace(default_settings,
                                         packet_table_mem="split")
        split_rec, img_s = timed_frames(np, torch, ops, r, rc, 2, tag)
        r.settings = default_settings
        ratio = float(img_s.mean()) / float(img_a.mean())
        assert abs(ratio - 1.0) < 1e-3, (tag, "table_mem moved the image",
                                         ratio)
        for k in ("traverse_closest", "traverse_anyhit"):
            assert auto_rec["launches"][k] > 0, (tag, k)
            assert split_rec["launches"][k + "_table"] > 0, (tag, k)
            assert split_rec["launches"][k] == 0, (tag, k)
        if "sss" in tag:
            assert auto_rec["launches"]["closest_mask_lane_tmax"] > 0, tag
        frames[tag] = {"auto": auto_rec, "split": split_rec}
        sd_s = r.settings.stack_depth
        if tag != "organic_media":       # the organic stream: timed once
            pool = freeze_pool(r, rc_vec, 3, spp)
            key = "large" if tag == "large" else "organic"
            residency[key] = time_residency(
                torch, ops, trav, cuda_ms, r.scene["packed"], sd_s,
                residency_sets(np, torch, g, fb_s, pool, dev, camera_rays,
                               incoherent_rays), "split", key, regs)
            del pool
        if tag == "large":
            # the census under both residencies: the path of the counting
            # table instantiations
            for k in ops.LAUNCHES:
                ops.LAUNCHES[k] = 0
            census_l = probe_steps.run(r, rc_vec, [3], spp, timed=True,
                                       table_mems=("vmem", "split"))
            torch.cuda.synchronize()
            census_table_launches = dict(ops.LAUNCHES)
            for rec in census_l:
                log(probe_steps.report(rec))
            for k in ("traverse_closest_table_steps",
                      "traverse_anyhit_table_steps"):
                assert census_table_launches[k] > 0, \
                    "the large-scene census never launched %s" % k
            report["census_large"] = {"records": census_l,
                                      "launches": census_table_launches}
        del r
        torch.cuda.empty_cache()
    report["frames"] = frames
    report["residency"] = residency

    # ---- 8. bounce, chunks and shards, the last regen orders, the CLI ----
    t0 = time.time()
    report["phase8"] = phase8(np, torch, ops, dev, fb, mats, envmap, texture,
                              big_scenes["organic_sss"], rc, cache, W)
    report["phase8"]["s"] = time.time() - t0

    # ---- 9. the viewer, the profiler, the last user tools ----
    t0 = time.time()
    report["phase9"] = phase9(np, torch, ops, dev,
                              (fb, mats, envmap, texture),
                              big_scenes["organic_sss"], cache, W)
    report["phase9"]["s"] = time.time() - t0

    # ---- 10. the regen frame as one device program ----
    t0 = time.time()
    report["phase10"] = phase10(np, torch, ops, dev, {
        "testobj": (fb, mats, envmap, texture),
        "sss": big_scenes["organic_sss"],
        "media": big_scenes["organic_media"]}, W)
    # the idle share of whole profiled calls (busy and window from one
    # trace); under graphs the marginal readings (busy over the marginal
    # window, or over the frame timed without the profiler) are no idle
    # share: they difference two windows and can go below 0
    lo, hi, marg = report["phase9"]["profiles"]["testobj_regen"]["spans"]
    report["phase10"]["idle_share_testobj"] = {
        "calls": {"%d_frames" % sp["frames"]: sp["idle_share"]
                  for sp in (lo, hi)},
        "marginal_of_window": marg["idle_share"],
        "marginal_of_unprofiled_frame": marg["frame_idle_share"]}
    report["phase10"]["s"] = time.time() - t0

    # ---- 11. the bounce frame as one device program; shards in flight ----
    t0 = time.time()
    report["phase11"] = phase11(np, torch, ops, dev, {
        "testobj": (fb, mats, envmap, texture),
        "sss": big_scenes["organic_sss"],
        "media": big_scenes["organic_media"]}, W,
        report["phase9"]["profiles"]["testobj_bounce"])
    report["phase11"]["s"] = time.time() - t0

    # ---- 12. the shade kernel ----
    t0 = time.time()
    report["phase12"] = phase12(np, torch, dev, (fb, mats, envmap, texture),
                                W)
    report["phase12"]["s"] = time.time() - t0

    # ---- 13. the surface fetch kernels ----
    t0 = time.time()
    report["phase13"] = phase13(np, torch, dev, (fb, mats, envmap, texture),
                                big_scenes["organic_sss"], W)
    report["phase13"]["s"] = time.time() - t0

    # ---- 14. the compaction permute's pool gather ----
    t0 = time.time()
    report["phase14"] = phase14(np, torch, dev, {
        "testobj": (fb, mats, envmap, texture),
        "media": big_scenes["organic_media"]}, W)
    report["phase14"]["s"] = time.time() - t0

    # ---- 15. the BSSRDF probe loop's kernels ----
    t0 = time.time()
    report["phase15"] = phase15(np, torch, dev, big_scenes["organic_sss"])
    report["phase15"]["s"] = time.time() - t0

    assert "jax" not in sys.modules, "the port imported jax"
    assert not [m for m in sys.modules if m == "tpu_pathtracer"
                or m.startswith("tpu_pathtracer.")], \
        "the port imported the JAX package"

    # ---- 6. result ----
    src = "tpu_pathtracer_torch/csrc/traverse.cu"
    rep = "tpu_pathtracer/ops/traverse_packet.py:507"
    kernels = []
    # row 1 as the regen wave launches it: the prefix (1M) read from device
    # memory; its int-prefix launch beside it
    for name, kind, runs in (
            ("traverse_closest", "closest_device_prefix", launches),
            ("traverse_anyhit", "anyhit", launches),
            ("traverse_closest_steps", "closest_steps", census_launches),
            ("traverse_anyhit_steps", "anyhit_steps", census_launches)):
        tm = timing["%s_coherent" % kind]
        if "steps" in kind:
            err = max(timing["%s_%s" % (kind, t)]["max_abs_err"]
                      for t in ("coherent", "incoherent"))
        else:
            err = max(v for k, v in errs.items() if k.startswith(kind))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": runs[name], "max_abs_err": err,
            "ms": min(tm["kernel_ms"]), "plain_ms": min(tm["plain_ms"]),
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None})
    kernels[0]["ms_int_prefix"] = min(timing["closest_coherent"]["kernel_ms"])
    kernels[2]["ms_device_prefix"] = min(
        timing["closest_device_prefix_steps_coherent"]["kernel_ms"])
    # row 3: the closest-hit form with a mask and a per-lane tmax (the
    # BSSRDF probe trace) shares the closest-hit instantiations; its
    # launches are those of the sss frames
    tm = timing["closest_lane_tmax_coherent"]
    kernels.append({
        "name": "traverse_closest_mask_lane_tmax", "route": "cuda",
        "source": src,
        "replaces": "tpu_pathtracer/ops/traverse_packet.py:998",
        "launches": frames["organic_sss"]["auto"]["launches"][
            "closest_mask_lane_tmax"],
        "max_abs_err": errs["closest_lane_tmax_coherent"],
        "ms": min(tm["kernel_ms"]), "plain_ms": min(tm["plain_ms"]),
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": None})
    # row 6: the shared-memory-table instantiations, timed on the
    # large_scene stream; launched by the split frames and the census
    split_launches = frames["large"]["split"]["launches"]
    rs = residency["large"]["sets"]
    for name, kset, runs, counted in (
            ("traverse_closest_table", "coherent_closest", split_launches,
             False),
            ("traverse_anyhit_table", "coherent_anyhit", split_launches,
             False),
            ("traverse_closest_table_steps", "coherent_closest",
             census_table_launches, True),
            ("traverse_anyhit_table_steps", "coherent_anyhit",
             census_table_launches, True)):
        row = rs[kset]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "tpu_pathtracer/ops/traverse_packet.py:101",
            "launches": runs[name], "max_abs_err": row["max_abs_err"],
            "ms": row["table_count_ms"] if counted else min(row["table_ms"]),
            "plain_ms": row["plain_ms"],
            "bound_ms": row["count_bound_ms" if counted else "bound_ms"],
            "bound_by": row["count_bound_by" if counted else "bound_by"],
            "library_ms": None})
    # rows 1-3 on the replayed bounce path (phase 8a / 8b), counted there
    p8 = report["phase8"]
    bounce_runs = {
        "traverse_closest": p8["testobj"]["bounce"]["launches"][
            "traverse_closest"],
        "traverse_anyhit": p8["testobj"]["bounce"]["launches"][
            "traverse_anyhit"],
        "traverse_closest_mask_lane_tmax": p8["organic_sss"]["bounce"][
            "launches"]["closest_mask_lane_tmax"]}
    for k in kernels:
        if k["name"] in bounce_runs:
            k["launches_bounce"] = bounce_runs[k["name"]]
            assert k["launches_bounce"] > 0, (k["name"], "bounce")
    # rows 1-2 on the viewer path (phase 9a), counted there
    viewer_runs = report["phase9"]["viewer"]["launches"]
    for k in kernels:
        if k["name"] in ("traverse_closest", "traverse_anyhit"):
            k["launches_viewer"] = viewer_runs[k["name"]]
            assert k["launches_viewer"] > 0, (k["name"], "viewer")
    for k in kernels:
        assert k["launches"] > 0, "%s was launched on no path" % k["name"]
    dma_src = "tpu_pathtracer_torch/csrc/dma_rows.cu"
    for name, case, rep in (
            ("dma_gather", "gather_flat", "tools/probe_dma.py:60"),
            ("dma_scatter", "scatter_wide", "tools/probe_dma.py:137")):
        dm = report["dma"][case]
        kernels.append({
            "name": name, "route": "cuda", "source": dma_src,
            "replaces": rep, "launches": dma_launches[name],
            "max_abs_err": dm["max_abs_err"], "ms": min(dm["kernel_ms"]),
            "plain_ms": min(dm["plain_ms"]), "bound_ms": dm["bound_ms"],
            "bound_by": "bytes", "library_ms": dm["library_ms"]})
    # the shade kernel: no TPU kernel behind it (the JAX function is one
    # XLA fusion); launches on the main path (regen), the replayed bounce
    # path (8a) and the viewer (9a)
    sk = report["phase12"]["kernel"]
    kernels.append({
        "name": "shade", "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/shade.cu",
        "replaces": "tpu_pathtracer/tracer/wavefront.py:476",
        "launches": launches["shade"],
        "launches_bounce": p8["testobj"]["bounce"]["launches"]["shade"],
        "launches_viewer": viewer_runs["shade"],
        "max_abs_err": sk["max_abs_err"], "ms": min(sk["kernel_ms"]),
        "plain_ms": min(sk["plain_ms"]), "bound_ms": sk["bound_ms"],
        "bound_by": sk["bound_by"], "library_ms": None})
    assert kernels[-1]["launches_bounce"] > 0 and \
        kernels[-1]["launches_viewer"] > 0, kernels[-1]
    # the surface fetches: no TPU kernel behind them (XLA fusions of the
    # JAX functions); fetch_attributes and env_tex_merged run on the main
    # path (a launch a wave), texture_radiance on the bounce path (a launch
    # a bounce, 8a) and in the BSSRDF probes (the sss frames of phase 7)
    b_launch = p8["testobj"]["bounce"]["launches"]
    sss_launch = frames["organic_sss"]["auto"]["launches"]
    for name, source, rep in (
            ("fetch_attributes", "fetch.cu",
             "tpu_pathtracer/tracer/wavefront.py:294"),
            ("env_tex_merged", "envtex.cu",
             "tpu_pathtracer/tracer/wavefront.py:412"),
            ("texture_radiance", "envtex.cu",
             "tpu_pathtracer/tracer/wavefront.py:388")):
        fk = report["phase13"]["kernels"][name]
        row = {"name": name, "route": "cuda",
               "source": "tpu_pathtracer_torch/csrc/" + source,
               "replaces": rep, "launches": launches[name],
               "launches_bounce": b_launch[name],
               "launches_viewer": viewer_runs[name],
               "launches_sss_regen": sss_launch[name],
               "max_abs_err": fk["max_abs_err"], "ms": min(fk["kernel_ms"]),
               "plain_ms": min(fk["plain_ms"]), "bound_ms": fk["bound_ms"],
               "bound_by": fk["bound_by"], "library_ms": None}
        if name == "texture_radiance":
            # not on the main path (the merged gather gives its texture):
            # its path is the bounce step, driven in 8a with the counts set
            # to 0 before and read after
            assert launches[name] == 0, launches
            row["launches_main_path"] = launches[name]
            row["launches"] = row["launches_bounce"]
        # the BSSRDF probes fetch inside csrc/bssrdf.cu: texture_radiance
        # is off the sss regen path
        assert row["launches"] > 0 and (row["launches_sss_regen"] > 0) == \
            (name != "texture_radiance"), row
        kernels.append(row)
    # the pool gather: no TPU kernel behind it (the JAX permute is XLA's
    # gather); one launch a compact wave on the main path
    pk = report["phase14"]["sizes"][str(P_PERMUTE[0])]
    kernels.append({
        "name": "pool_gather", "route": "cuda",
        "source": "tpu_pathtracer_torch/csrc/permute.cu",
        "replaces": "tpu_pathtracer/tracer/regen.py:_compact",
        "launches": launches["pool_gather"], "max_abs_err": 0.0,
        "ms": min(pk["kernel_ms"]),
        "plain_ms": min(pk["plain_ms"]), "bound_ms": pk["bound_ms"],
        "bound_by": "bytes", "library_ms": min(pk["library_ms"])})
    assert kernels[-1]["launches"] > 0, kernels[-1]
    # the BSSRDF probe loop's kernels: no TPU kernel behind them (XLA fuses
    # the JAX bssrdf_scatter); 1 + bssrdf_probes launches a wave on the sss
    # regen path (phase 7's frames); bound: the whole loop's bytes beside
    # the launches' sum (phase 15b)
    bt = report["phase15"]["times"]
    for name in ("probe_start", "probe_step", "probe_finish"):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tpu_pathtracer_torch/csrc/bssrdf.cu",
            "replaces": "tpu_pathtracer/tracer/bssrdf_shade.py:"
                        "bssrdf_scatter",
            "launches": sss_launch[name], "max_abs_err": 0.0,
            "ms": min(bt[name]), "plain_ms": min(bt["plain_path"]),
            "loop_kernels_ms": bt["kernels_ms"],
            "loop_bound_ms": bt["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
        assert kernels[-1]["launches"] > 0, kernels[-1]
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
