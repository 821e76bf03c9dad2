"""Progressive renderer: camera rays, the chunked frame loop and frame
accumulation (port of tracer/renderer.py).

The accumulation buffer is lane-ordered like the JAX package's: lane i
holds pixel lane_pixel_xy(i), lanes walking 32x32 pixel blocks, so that
neighbouring lanes trace neighbouring pixels. accum_to_buffer un-swizzles
it into an [H,W,3] image.
"""
from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from ..core.rng import RaySampler
from ..core.vecmath import TWO_PI, PI, normalize, dot, cross
from ..scene.config import SceneDesc, materials_to_arrays, MAT_SUBSURFACE
from ..scene.camera import RenderCamera
from ..scene.texture import make_quad_texture
from ..convert import to_device
from ..ops import image as image_ops
from ..utils.profiling import span
from . import device_loop
from .traverse import pack_stream
from .wavefront import (
    RenderSettings, pack_tri_attributes, pack_mat_table, pack_envtex_quad,
)
from .envsample import build_env_distribution


@functools.lru_cache(maxsize=2)
def _bssrdf_table_cached(g=0.0, eta=1.4):
    from ..bssrdf.tabulate import compute_beam_diffusion_table
    return compute_beam_diffusion_table(g=g, eta=eta)


def lane_pixel_xy(pixel_index, width, height, block=32):
    """Closed-form lane -> (px, py) of the 32x32 block swizzle, int32,
    including the clipped blocks at the right and bottom edges."""
    b = int(block)
    W, H = int(width), int(height)
    i = pixel_index.to(torch.int64)
    full_rows = H // b
    rem_h = H - full_rows * b
    full_cols = W // b
    rem_w = W - full_cols * b
    row_lanes = W * b                     # lanes per full-height block row
    blk_row = i // row_lanes
    l2 = i - blk_row * row_lanes
    bh_cur = torch.where(blk_row < full_rows, b, max(rem_h, 1))
    blk_lanes = b * bh_cur
    col_blk = l2 // blk_lanes
    l3 = l2 - col_blk * blk_lanes
    bw_cur = torch.where(col_blk < full_cols, b, max(rem_w, 1))
    px = col_blk * b + l3 % bw_cur
    py = blk_row * b + l3 // bw_cur
    return (torch.clamp(px, 0, W - 1).to(torch.int32),
            torch.clamp(py, 0, H - 1).to(torch.int32))


def _unit(v):
    return v / torch.sqrt(dot(v, v))


def generate_camera_rays(cam_vec, rng, pixel_x, pixel_y):
    """Primary rays: AA jitter + thin-lens DOF (src/renderkernel.cu:895-954).

    cam_vec: [16] f32 (RenderCamera.as_array). pixel_x, pixel_y: [N] f32
    pixel coordinates. Four RNG draws per lane. Returns (rng, orig, dir)."""
    res_x, res_y = cam_vec[0], cam_vec[1]
    cam_pos = cam_vec[2:5]
    view = _unit(cam_vec[5:8])
    up = _unit(cam_vec[8:11])
    fov_x, fov_y = cam_vec[11], cam_vec[12]
    aperture = cam_vec[13]
    focal = cam_vec[14]

    horiz_axis = _unit(cross(view, up))
    vert_axis = _unit(cross(horiz_axis, view))
    middle = cam_pos + view
    horizontal = horiz_axis * torch.tan(fov_x * 0.5 * (PI / 180.0))
    vertical = vert_axis * torch.tan(-fov_y * 0.5 * (PI / 180.0))

    rng, (jx, jy, r1, r2) = RaySampler.next_n(rng, 4)
    sx = (jx - 0.5 + pixel_x) / (res_x - 1.0)
    sy = (jy - 0.5 + pixel_y) / (res_y - 1.0)
    point_on_plane = middle[None, :] \
        + (2.0 * sx - 1.0)[:, None] * horizontal[None, :] \
        + (2.0 * sy - 1.0)[:, None] * vertical[None, :]
    point_on_image = cam_pos[None, :] \
        + (point_on_plane - cam_pos[None, :]) * focal

    angle = TWO_PI * r1
    dist = aperture * torch.sqrt(r2)
    ap_x = torch.cos(angle) * dist
    ap_y = torch.sin(angle) * dist
    aperture_point = cam_pos[None, :] + horiz_axis[None, :] * ap_x[:, None] \
        + vert_axis[None, :] * ap_y[:, None]
    aperture_point = torch.where(aperture > 1e-5, aperture_point,
                                 cam_pos.expand(aperture_point.shape))
    return rng, aperture_point, normalize(point_on_image - aperture_point)


def camera_vector(camera: RenderCamera, device):
    """The camera's [16] f32 vector on `device`; to a CUDA device through
    pinned memory, without blocking the host."""
    v = torch.from_numpy(np.ascontiguousarray(camera.as_array(),
                                              dtype=np.float32))
    if torch.device(device).type == "cuda":
        return v.pin_memory().to(device, non_blocking=True)
    return v.to(device)


def lane_tables(width, height, block=32):
    """(lane_px, lane_py) int32 tables of the block swizzle (host numpy)."""
    bs = block
    W, H = int(width), int(height)
    bw = -(-W // bs)
    lanes = np.arange(bw * -(-H // bs) * bs * bs, dtype=np.int64)
    blk = lanes // (bs * bs)
    within = lanes % (bs * bs)
    px = (blk % bw) * bs + within % bs
    py = (blk // bw) * bs + within // bs
    valid = (px < W) & (py < H)
    return (px[valid][:W * H].astype(np.int32),
            py[valid][:W * H].astype(np.int32))


def build_scene(flat_bvh, mat_arrays, envmap, texture, settings, env_const):
    """The resolution-independent part of the scene dict on the host (numpy
    arrays and Python ints), with the keys and values of the JAX package's
    Renderer.scene; the Renderer adds the lane tables (`lane_*`)."""
    scene = {
        "prims": np.asarray(flat_bvh.prims, np.float32),
        "meta": np.asarray(flat_bvh.meta, np.int32),
        "packed": pack_stream(flat_bvh.prims, flat_bvh.meta),
        "num_nodes": int(flat_bvh.num_nodes),
        "tri_attr": pack_tri_attributes(
            flat_bvh.tri_pos, flat_bvh.tri_uv, flat_bvh.tri_nrm,
            flat_bvh.tri_mat, prims=flat_bvh.prims,
            num_nodes=flat_bvh.num_nodes),
        "tri_mat": np.asarray(flat_bvh.tri_mat, np.int32),
        "mat_table": pack_mat_table(mat_arrays),
        "env_const": np.asarray(env_const, np.float32),
    }
    if settings.has_bssrdf:
        # the photon-beam-diffusion table (g=0, eta=1.4, 100x64) of the
        # reference's initBssrdfTable (src/main.cpp:408-415), read by the
        # tabulated profile path (bssrdf_use_soe=False)
        tbl = _bssrdf_table_cached()
        scene["bssrdf_rho"] = np.asarray(tbl.rho, np.float32)
        scene["bssrdf_radius"] = np.asarray(tbl.radius, np.float32)
        scene["bssrdf_profile"] = np.asarray(tbl.profile, np.float32)
        scene["bssrdf_cdf"] = np.asarray(tbl.profile_cdf, np.float32)
        scene["bssrdf_rho_eff"] = np.asarray(tbl.rho_eff, np.float32)
    if envmap is not None:
        env = np.asarray(envmap, np.float32)
        equad = make_quad_texture(env, wrap_u=False, wrap_v=False)
        scene["env_h"], scene["env_w"] = env.shape[0], env.shape[1]
        if settings.env_importance_sampling:
            dist = build_env_distribution(env, topk=settings.env_nee_topk)
            scene.update(dist)
            # the sampler pdf of the 4 corner texels rides each quad row
            # (cols 12:16) so one gather gives radiance and pdf
            p = dist["env_pdf_uv"].astype(np.float32)
            pxn = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
            pyn = np.concatenate([p[1:], p[-1:]], axis=0)
            pyxn = np.concatenate([pxn[1:], pxn[-1:]], axis=0)
            pq = np.stack([p, pxn, pyn, pyxn], axis=-1).reshape(-1, 4)
            equad = np.concatenate([equad, pq], axis=1)
        scene["envmap_quad"] = equad
    if texture is not None:
        tex = np.asarray(texture, np.float32)
        tquad = make_quad_texture(tex, wrap_u=True, wrap_v=True)
        scene["texture_quad"] = tquad
        scene["tex_h"], scene["tex_w"] = tex.shape[0], tex.shape[1]
        if (envmap is not None and settings.env_importance_sampling
                and settings.use_texture):
            scene["envtex_quad"] = pack_envtex_quad(equad, tquad)
    return scene


class Renderer:
    """Scene tensors on one device plus the frame loop of either integrator.

        r = Renderer(flat_bvh, materials, envmap=..., texture=..., width=W,
                     height=H, device="cuda")
        accum = r.render_frames(r.zeros_accum(), camera, 1, spp)
        img = r.accum_to_image(accum, spp)

    lane_chunk: render the lanes in chunks of at most this many (default:
    the whole image up to 2^23 lanes); the last chunk is padded and its
    padding dropped. base_scene: the `scene` of another Renderer built on
    the same flat_bvh / materials / envmap / texture; its
    resolution-independent tensors are shared (the same objects, no copy)
    and only the lane tables are built anew.

    The Renderer owns its integrators, as the JAX Renderer jits its frame
    function once: `regen_integrator` and `bounce_integrator` build one per
    (settings, flags) and device_loop.capture_key (device, lanes,
    deterministic mode, scene tensors), each with its captured steps
    (tracer/device_loop.py), and keep the MAX_INTEGRATORS most recent.
    `integrator` is the one of settings.integrator."""

    MAX_INTEGRATORS = 16

    def __init__(self, flat_bvh, materials, envmap=None, texture=None,
                 width=512, height=512, settings: RenderSettings = None,
                 lane_chunk=None, env_const=(0.0, 0.0, 0.0), base_scene=None,
                 *, device):
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        mat_arrays = materials_to_arrays(materials)
        has_bssrdf = bool(np.any(mat_arrays["refltype"] == MAT_SUBSURFACE))
        has_media = bool(np.any(mat_arrays["has_medium"] != 0))
        if settings is None:
            settings = RenderSettings(
                use_envmap=envmap is not None,
                use_texture=texture is not None,
                has_media=has_media,
                has_bssrdf=has_bssrdf,
            )
            # The JAX package derives its packet shape here from the
            # workload class (media / BSSRDF scenes, and streams over its
            # SMEM table budget); copied so that one settings object
            # describes a render in both packages. The port's traversal
            # returns the same result for every packet shape.
            from ..ops.traverse_packet import table_fits_smem
            if has_media or has_bssrdf:
                settings = dataclasses.replace(
                    settings, packet_tile_sub=32, packet_interleave=4)
            if not table_fits_smem(flat_bvh.prims.shape[0]):
                settings = dataclasses.replace(
                    settings, packet_tile_sub=16, packet_interleave=4)
        if settings.integrator not in ("regen", "bounce"):
            raise ValueError("unknown integrator %r" % (settings.integrator,))
        # the stack only needs the tree's actual depth
        settings = dataclasses.replace(
            settings, stack_depth=min(settings.stack_depth,
                                      int(flat_bvh.max_depth) + 2))
        self.settings = settings
        if base_scene is not None:
            scene = {k: v for k, v in base_scene.items()
                     if not k.startswith("lane_")}
        else:
            scene = to_device(
                build_scene(flat_bvh, mat_arrays, envmap, texture, settings,
                            env_const), self.device)
        n_pixels = self.width * self.height
        self.lane_chunk = int(lane_chunk or min(n_pixels, 1 << 23))
        self._lane_px, self._lane_py = lane_tables(self.width, self.height)
        # padded to whole chunks plus headroom for ShardedRenderer's
        # rounded-up lane count, as the JAX Renderer pads them
        n_pad = (-(-n_pixels // self.lane_chunk) * self.lane_chunk
                 - n_pixels + 8192)
        for k, v in (("lane_px", self._lane_px), ("lane_py", self._lane_py)):
            scene[k] = torch.from_numpy(np.pad(v, (0, n_pad))).to(
                self.device)
        self.scene = scene
        self._integrators = collections.OrderedDict()

    def _cached(self, key, build):
        fn = self._integrators.get(key)
        if fn is None:
            fn = build()
            self._integrators[key] = fn
            while len(self._integrators) > self.MAX_INTEGRATORS:
                self._integrators.popitem(last=False)
        self._integrators.move_to_end(key)
        return fn

    def _key(self, scene, n_lanes):
        scene = self.scene if scene is None else scene
        if n_lanes is None:
            n_lanes = min(self.width * self.height, self.lane_chunk)
        return device_loop.capture_key(n_lanes, scene["lane_px"].device,
                                       scene)

    def regen_integrator(self, with_stats=False, stop_after_waves=0,
                         scene=None, n_lanes=None):
        """The regen integrate_frames of the current settings for calls on
        `scene` (default: self.scene) of n_lanes lanes (default: a whole
        lane chunk), built at its first use and reused after."""
        from . import regen
        key = ("regen", self.settings, bool(with_stats),
               int(stop_after_waves)) + self._key(scene, n_lanes)
        return self._cached(key, lambda: regen.make_regen_integrator(
            self.settings, self.width, self.height, with_stats=with_stats,
            stop_after_waves=stop_after_waves))

    def bounce_integrator(self, with_stats=False, scene=None, n_lanes=None):
        """The bounce integrator (wavefront.make_integrator) of the current
        settings, built and kept as regen_integrator's."""
        from . import wavefront
        key = ("bounce", self.settings, bool(with_stats)) \
            + self._key(scene, n_lanes)
        return self._cached(key, lambda: wavefront.make_integrator(
            self.settings, with_stats=with_stats))

    def integrator(self, with_stats=False, scene=None, n_lanes=None):
        """The integrator that settings.integrator names."""
        if self.settings.integrator == "regen":
            return self.regen_integrator(with_stats, scene=scene,
                                         n_lanes=n_lanes)
        return self.bounce_integrator(with_stats, scene=scene,
                                      n_lanes=n_lanes)

    def zeros_accum(self):
        return torch.zeros((self.width * self.height, 3), dtype=torch.float32,
                           device=self.device)

    def render_frame(self, accum, camera: RenderCamera, frame_number: int):
        """One progressive sample per pixel; frame_number starts at 1."""
        return self.render_frames(accum, camera, frame_number, 1)

    def chunk_call(self, scene, cam_vec, frame0, lane0, accum_chunk,
                   n_frames, with_stats=False):
        """One call of the current integrator on the lanes [lane0, lane0 +
        n) of `scene`'s device, as a generator for device_loop.run_calls:
        n_frames samples per lane added to accum_chunk [n,3]. It returns
        (accum, waves, rays): regen waves or bounces and the traced rays
        (0 without with_stats), as 0-d device tensors."""
        fn = self.integrator(with_stats, scene=scene,
                             n_lanes=accum_chunk.shape[0])
        return fn.call(scene, cam_vec, int(frame0), int(lane0), accum_chunk,
                       int(n_frames))

    def render_frames(self, accum, camera: RenderCamera, frame_start: int,
                      n_frames: int, with_stats=False):
        """Add n_frames samples per pixel (frames frame_start ..
        frame_start + n_frames - 1) to the lane-ordered accum and return the
        new accum, chunk by chunk of lane_chunk lanes. with_stats=True
        returns (accum, waves, traced_rays): regen waves or bounces."""
        cam_vec = camera_vector(camera, self.device)
        n = accum.shape[0]
        chunk = self.lane_chunk
        if n <= chunk:
            spans, chunk = [(0, n)], n
        else:
            spans = [(l0, min(l0 + chunk, n)) for l0 in range(0, n, chunk)]
        calls = []
        for lane0, lane1 in spans:
            sl = accum[lane0:lane1]
            pad = chunk - (lane1 - lane0)
            if pad:
                sl = torch.cat([sl, sl.new_zeros((pad, 3))])
            calls.append((self.device, self.chunk_call(
                self.scene, cam_vec, frame_start, lane0, sl, n_frames,
                with_stats)))
        outs = device_loop.run_calls(calls)
        parts = [res[:lane1 - lane0] for (res, _, _), (lane0, lane1)
                 in zip(outs, spans)]
        acc = parts[0] if len(parts) == 1 else torch.cat(parts)
        if not with_stats:
            return acc
        return (acc, sum(int(w) for _, w, _ in outs),
                sum(float(r) for _, _, r in outs))

    def accum_to_buffer(self, accum):
        """Un-swizzle the lane-ordered accumulation into an [H,W,3] buffer."""
        if isinstance(accum, torch.Tensor):
            with span("pt.image.copy"):
                accum = accum.detach().cpu().numpy()
        with span("pt.image.unswizzle"):
            a = np.asarray(accum)[:self.width * self.height]
            img = np.zeros((self.height, self.width, 3), np.float32)
            img[self._lane_py, self._lane_px] = a
        return img

    def accum_to_image(self, accum, frame_count, repeat=1):
        """Tonemap the lane-ordered accumulation into [H*repeat, W*repeat,
        3] uint8, each pixel repeated into its repeat x repeat block.

        As in the JAX package, the type decides where: a torch tensor is
        clamped, gamma-corrected and quantised in f32 on its own device,
        un-swizzled and repeated there (ops/image.py: the kernel on the
        card, its plain version on the CPU), and a CUDA device's image
        comes back in one copy into fresh pinned memory; a numpy array
        takes the host f64 core.image.tonemap. The two differ by at most
        one uint8 step (f32 against f64 pow before the rounding). The
        array returned is the caller's own: no later call writes it."""
        from ..core.image import tonemap
        repeat = int(repeat)
        if repeat < 1:
            raise ValueError("repeat must be at least 1, not %d" % repeat)
        if not isinstance(accum, torch.Tensor):
            img = tonemap(self.accum_to_buffer(accum), frame_count)
            return img.repeat(repeat, 0).repeat(repeat, 1) if repeat > 1 \
                else img
        n = self.width * self.height
        with span("pt.image.unswizzle"):
            x = torch.clamp(accum[:n] / float(max(int(frame_count), 1)),
                            0.0, 1.0)
            u8 = (torch.pow(x, 1.0 / 2.2) * 255.0 + 0.5).to(torch.uint8)
            img = image_ops.unswizzle_upscale(
                u8, self.scene["lane_px"][:n].to(u8.device),
                self.scene["lane_py"][:n].to(u8.device), self.width,
                self.height, repeat)
        with span("pt.image.copy"):
            if img.device.type == "cuda":
                host = torch.empty(img.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(img, non_blocking=True)
                torch.cuda.current_stream(img.device).synchronize()
                img = host
            return img.numpy()


def scene_parts_from_desc(desc: SceneDesc, base_dir="", cache_dir=None):
    """Load (flat_bvh, materials, envmap, texture, settings) as the scene
    description says: the pieces renderer_from_scene_desc assembles, for
    callers that pick their own resolution."""
    import os
    from ..scene.objloader import load_obj
    from ..scene.plyloader import load_ply
    from ..scene.hdr import read_hdr
    from ..scene.texture import load_texture
    from ..accel.cache import load_or_build

    path = os.path.join(base_dir, desc.scenefile)
    if path.endswith(".obj"):
        mesh = load_obj(path, desc.mat_id_map)
    elif path.endswith(".ply"):
        mesh = load_ply(path)
    else:
        raise ValueError("unsupported scene file %r" % desc.scenefile)
    fb = load_or_build(mesh, cache_dir=cache_dir)
    envmap = None
    if desc.HDRmapname and desc.use_envmap:
        envmap = read_hdr(os.path.join(base_dir, desc.HDRmapname))
    texture = None
    if desc.textureFile:
        texture = load_texture(os.path.join(base_dir, desc.textureFile))
    settings = RenderSettings(
        bounce_min=desc.bounce_min,
        bounce_max=desc.bounce_max,
        use_envmap=envmap is not None,
        use_texture=texture is not None,
        has_media=any(m.medium is not None for m in desc.materials),
        has_bssrdf=any(m.refltype == MAT_SUBSURFACE for m in desc.materials),
        use_distant_light=desc.use_distant_light,
        distant_light_L=tuple(desc.distant_light_L),
        distant_light_dir=tuple(desc.distant_light_dir),
    )
    return fb, desc.materials, envmap, texture, settings


def renderer_from_scene_desc(desc: SceneDesc, base_dir="", cache_dir=None,
                             *, device):
    """A Renderer on `device` for a scene description: mesh, BVH (built or
    read from cache_dir), HDR environment and texture."""
    fb, mats, envmap, texture, settings = scene_parts_from_desc(
        desc, base_dir=base_dir, cache_dir=cache_dir)
    return Renderer(fb, mats, envmap=envmap, texture=texture,
                    width=desc.width, height=desc.height, settings=settings,
                    device=device)
